from repro_torch.kernels.augru.ops import augru
from repro_torch.kernels.augru.ref import augru_ref

__all__ = ["augru", "augru_ref"]
