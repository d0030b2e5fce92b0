from repro_torch.kernels.din_attention.ops import din_attention
from repro_torch.kernels.din_attention.ref import din_attention_ref

__all__ = ["din_attention", "din_attention_ref"]
