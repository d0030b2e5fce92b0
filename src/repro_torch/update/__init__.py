"""Streaming parameter-update subsystem (DESIGN.md §6): versioned delta
ingestion for uninterrupted serving — delta log + watcher, MVCC cube
application, HBM-head in-place migration, cache coherence — plus the
durability layer (DESIGN.md §9): periodic cube snapshots and the
snapshot+replay restart protocol."""
from repro_torch.update.delta import (CheckpointDiffEmitter, DeltaBatch,
                                DeltaEmitter, DeltaIntegrityError,
                                DeltaWatcher, GroupDelta, list_deltas,
                                read_delta, verify_delta, write_delta)
from repro_torch.update.hbm_head import HBMHead
from repro_torch.update.manager import UpdateManager, UpdateStats
from repro_torch.update.policy import (PromoteDemotePolicy, TierPlan,
                                 group_lfu_counts, merged_lfu_counts)
from repro_torch.update.snapshot import (CubeSnapshotter, SnapshotIntegrityError,
                                   latest_valid_snapshot, list_snapshots,
                                   load_aux_state, load_cube_snapshot,
                                   prune_delta_log, prune_snapshots,
                                   verify_snapshot, write_aux_state,
                                   write_cube_snapshot)

__all__ = [
    "CheckpointDiffEmitter", "CubeSnapshotter",
    "DeltaBatch", "DeltaEmitter", "DeltaIntegrityError", "DeltaWatcher",
    "GroupDelta", "HBMHead", "PromoteDemotePolicy",
    "SnapshotIntegrityError", "TierPlan",
    "UpdateManager", "UpdateStats", "group_lfu_counts",
    "latest_valid_snapshot", "list_deltas", "list_snapshots",
    "load_aux_state", "load_cube_snapshot", "merged_lfu_counts",
    "prune_delta_log", "prune_snapshots", "read_delta", "verify_delta",
    "verify_snapshot", "write_aux_state", "write_cube_snapshot",
    "write_delta",
]
