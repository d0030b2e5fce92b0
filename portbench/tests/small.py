"""Small sizes for the CPU tests: every table cut to a few hundred rows,
batches and rings cut; the widths stay published."""

FIELDS = {
    "user_fields": [
        {"name": "user_id", "vocab": 1024, "bag": 1, "combiner": "sum"},
        {"name": "user_profile", "vocab": 256, "bag": 4, "combiner": "sum"}],
    "item_fields": [
        {"name": "item_id", "vocab": 1024, "bag": 1, "combiner": "sum"},
        {"name": "item_cat", "vocab": 256, "bag": 1, "combiner": "sum"}],
}
TRAFFIC = {
    "din.bulk": {"batch": 48, "ring": 2, "warm_calls": 2},
    "dien.bulk": {"batch": 16, "ring": 2, "warm_calls": 2},
}


def overrides(workload: str) -> dict:
    return {"config": dict(FIELDS), "traffic": dict(TRAFFIC[workload])}
