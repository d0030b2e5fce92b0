#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card and print its
result as the last line of standard output:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs
the same window, then a traced sub-window, and reports the per-layer
metrics with the device's busy time and a breakdown. Every run compares
what its timed path produced with the plain reference and prints each
number compared beside its limit, last on standard error. Without a
CUDA device, or with fewer than the cell asks for, it exits non-zero and
prints no result; it never runs on the CPU.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded when the result is printed:
#: JAX and the JAX package (the port's own name only begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def finite(x):
    """Numbers as JSON can hold them: a value that is not finite as a
    string."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark runs on the card only", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    entry = harness.cell_entry(harness.load_bench(), args.workload)
    if torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA "
              f"devices, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    found = loaded_forbidden()
    if found:
        print(f"portbench: {', '.join(found)} loaded in the run's process",
              file=sys.stderr)
        return 3
    print("portbench: float32 products in full precision (TF32 off: "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32})", file=sys.stderr)
    print(json.dumps(finite(out), allow_nan=False), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)        # the benchmark's modules live in a package
    sys.exit(main())
