from repro_torch.kernels.rerank_score.ops import rerank_score
from repro_torch.kernels.rerank_score.ref import rerank_score_ref

__all__ = ["rerank_score", "rerank_score_ref"]
