from repro_torch.kernels.embedding_bag.ops import (embedding_bag,
                                                   embedding_bag_group)
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_group_ref,
                                                   embedding_bag_ref)

__all__ = ["embedding_bag", "embedding_bag_group", "embedding_bag_group_ref",
           "embedding_bag_ref"]
