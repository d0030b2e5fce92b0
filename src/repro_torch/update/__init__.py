"""Streaming parameter-update subsystem (DESIGN.md §6): versioned delta
ingestion for uninterrupted serving — delta log + watcher, MVCC cube
application, cache coherence. The HBM-head tier (``hbm_head``) and the
durability layer (``snapshot``) are not ported yet (ROADMAP A5)."""
from repro_torch.update.delta import (CheckpointDiffEmitter, DeltaBatch,
                                      DeltaEmitter, DeltaIntegrityError,
                                      DeltaWatcher, GroupDelta, list_deltas,
                                      read_delta, verify_delta, write_delta)
from repro_torch.update.manager import UpdateManager, UpdateStats
from repro_torch.update.policy import (PromoteDemotePolicy, TierPlan,
                                       group_lfu_counts, merged_lfu_counts)

__all__ = [
    "CheckpointDiffEmitter",
    "DeltaBatch", "DeltaEmitter", "DeltaIntegrityError", "DeltaWatcher",
    "GroupDelta", "PromoteDemotePolicy", "TierPlan",
    "UpdateManager", "UpdateStats", "group_lfu_counts",
    "list_deltas", "merged_lfu_counts", "read_delta", "verify_delta",
    "write_delta",
]
