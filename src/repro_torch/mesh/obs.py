"""Mesh-level metrics: per-shard / per-host / per-replica labeled
families on the existing :class:`~repro.obs.metrics.MetricsRegistry`
collector contract (``fn() -> {label_tuple: value}``)."""
from __future__ import annotations

__all__ = ["register_mesh_collectors"]


def register_mesh_collectors(registry, mesh=None, fleet=None):
    """Register mesh/fleet gauge families. Safe to call with either side
    absent. Families:

      * ``jizhi_mesh_shard_calls`` / ``_rows`` / ``_degraded_rows``
        labeled ``{shard=<s>}`` — data-plane traffic per shard;
      * ``jizhi_mesh_host_alive`` / ``_served`` labeled ``{host=<id>}``;
      * ``jizhi_mesh_client_<stat>`` (hedges, hedge_wins, failovers, …);
      * ``jizhi_mesh_topology_version``;
      * ``jizhi_fleet_replica_routed`` / ``_alive`` labeled
        ``{replica=<name>}``.
    """
    if mesh is not None:
        def shard_family(field):
            def collect():
                return {(("shard", str(s)),): float(st[field])
                        for s, st in enumerate(mesh.shard_stats)}
            return collect
        for fld in ("calls", "rows", "degraded_rows"):
            registry.collector(f"mesh_shard_{fld}", shard_family(fld))
        registry.collector(
            "mesh_host_alive",
            lambda: {(("host", hid),): float(h.alive)
                     for hid, h in mesh.hosts.items()})
        registry.collector(
            "mesh_host_served",
            lambda: {(("host", hid),): float(h.served)
                     for hid, h in mesh.hosts.items()})
        registry.collector(
            "mesh_topology_version",
            lambda: {(): float(mesh.router.topology.version)})
        registry.collector(
            "mesh_version",
            lambda: {(): float(mesh.version)})

        def client_stats():
            return {(("stat", k),): float(v)
                    for k, v in mesh.client.stats.items()}
        registry.collector("mesh_client", client_stats)
    if fleet is not None:
        registry.collector(
            "fleet_replica_routed",
            lambda: {(("replica", r.name),): float(r.routed)
                     for r in fleet.replicas})
        registry.collector(
            "fleet_replica_alive",
            lambda: {(("replica", r.name),): float(r.alive)
                     for r in fleet.replicas})
    return registry
