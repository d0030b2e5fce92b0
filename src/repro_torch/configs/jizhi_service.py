"""The paper's own service configs (Table 1 + §8 setup) as framework configs:
model size, feature-group count, and traffic per production service, mapped
onto the simulator's ServiceSpec and the servable ranking models.

The dense DNN of each service is a DIN-family ranker; the sparse part
(Table 1: 210-500 GB) lives in the parameter cube / sharded tables.

This module is also the SCENARIO REGISTRY of the serving surface
(DESIGN.md §7): each entry below is a declarative ScenarioSpec that the
pipeline builder compiles on the shared substrate. Adding a scenario is
one ``register_scenario`` call, not a fork of core/service.py.
"""
from repro_torch.core.service_model import SERVICES, ServiceSpec  # noqa: F401
from repro_torch.serve.scenario import ScenarioSpec, register_scenario

# ------------------------------------------------------ scenario registry
# Priority 0 = the primary objective (never shed by the quota-aware
# fanout); priority 1 scenarios ride out overload spikes (§8.6: CTR keeps
# serving while FR/CMT shed first).
DIN_RERANK = register_scenario(ScenarioSpec(
    name="din-rerank", arch_id="din", pipeline="rerank", priority=0,
    batch_size=16))
# DIEN, MIND and two-tower scenarios register here once their models are
# ported (ROADMAP A4); the multi-scenario default surface waits for them.

# Table 1 statistics (the paper's deployed services)
TABLE_1 = {
    "A": {"model_size_gb": 430, "feature_groups": 379, "traffic_per_s": 4.58e8},
    "B": {"model_size_gb": 500, "feature_groups": 430, "traffic_per_s": 4.21e8},
    "C": {"model_size_gb": 285, "feature_groups": 270, "traffic_per_s": 3.67e7},
    "D": {"model_size_gb": 210, "feature_groups": 106, "traffic_per_s": 7.15e7},
    # Service E (§8.6): three models, 1743 GB total, 968 feature groups
    "E": {"model_size_gb": 1743, "feature_groups": 968, "traffic_per_s": 9.19e7,
          "tenants": ("ctr", "fr", "cmt"), "shared_feature_groups": 0.8},
}

# Paper Table 2 reference values for the reproduction check
TABLE_2 = {
    "A": {"legacy": (30, 1.53e6, 11450), "jizhi": (23, 4.42e6, 3970)},
    "B": {"legacy": (29, 1.63e6, 12750), "jizhi": (24, 4.36e6, 4773)},
    "C": {"legacy": (41, 2.80e6, 2067), "jizhi": (40, 5.21e6, 1110)},
    "D": {"legacy": (22, 3.53e6, 4280), "jizhi": (18, 8.24e6, 1833)},
}


def production_scale_note() -> str:
    return ("Simulated services preserve Table 1's RATIOS (feature groups, "
            "traffic spread, model-size ordering); absolute traffic is "
            "scaled by INSTANCE_SCALE (service_model.py) so a CPU sim of "
            "10^3-10^4 requests maps onto the paper's 10^7-10^8/s fleet.")
