from repro_torch.kernels.mla_decode.ops import mla_decode, rows_read
from repro_torch.kernels.mla_decode.ref import mla_decode_ref

__all__ = ["mla_decode", "mla_decode_ref", "rows_read"]
