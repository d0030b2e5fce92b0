"""Multi-host serving mesh (DESIGN.md §11): sharded cube tier behind a
versioned rendezvous router, an in-process ShardHost/ShardClient
transport with hedging + breaker-aware failover, and a replicated
scenario fleet behind a least-loaded balancer."""
from .fleet import FleetBalancer, Replica
from .obs import register_mesh_collectors
from .sharded import MeshCube
from .topology import ShardRouter, ShardTopology, make_topology, mix64
from .transport import (HostDown, MeshUnavailable, RequestCancelled,
                        ShardClient, ShardHost)

__all__ = [
    "MeshCube", "ShardTopology", "ShardRouter", "make_topology", "mix64",
    "ShardHost", "ShardClient", "HostDown", "MeshUnavailable",
    "RequestCancelled", "FleetBalancer", "Replica",
    "register_mesh_collectors",
]
