"""Failure-domain substrate (DESIGN.md §8): deterministic fault injection
for the parameter cube's server fleet plus the circuit-breaker health
model the router consults before paying for a probe.

  * ``FaultPlan`` / ``FaultInjector`` — a seedable, clock-agnostic schedule
    of per-server faults (latency spikes, transient unavailability, hard
    kills with later revival, slow-disk) applied mid-run by polling
    ``poll(now)`` from any clock: wall time in AsyncExecutor drills,
    the virtual clock in SimExecutor benchmarks.
  * ``ServerHealth`` / ``HealthRegistry`` — per-server circuit breaker
    (closed → open → half-open with probe requests). ``ParameterCube``
    consults it before routing so a dead server is skipped without paying
    the failed-probe RPC once the breaker opens.
  * ``crash_point`` / ``arm`` / ``SimulatedCrash`` — whole-process crash
    simulation for recovery drills (DESIGN.md §9): named abort points in
    durable-write paths that a drill arms to produce torn on-disk states.
"""
from repro_torch.faults.crash import (SimulatedCrash, arm, crash_point,
                                disarm_all)
from repro_torch.faults.health import (BREAKER_CLOSED, BREAKER_HALF_OPEN,
                                 BREAKER_OPEN, HealthRegistry, ServerHealth)
from repro_torch.faults.plan import (FaultEvent, FaultInjector, FaultPlan,
                               HostFaultInjector)

__all__ = [
    "FaultEvent", "FaultInjector", "FaultPlan", "HostFaultInjector",
    "ServerHealth", "HealthRegistry",
    "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN",
    "SimulatedCrash", "arm", "crash_point", "disarm_all",
]
