from repro_torch.kernels.candidate_scorer.ops import candidate_scorer
from repro_torch.kernels.candidate_scorer.ref import candidate_scorer_ref

__all__ = ["candidate_scorer", "candidate_scorer_ref"]
