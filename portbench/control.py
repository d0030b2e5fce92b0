#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process (not run by the benchmark's own runs):

    python3 portbench/control.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13

For each seed it draws the cell's weights and inputs as a run does,
sends the whole ring once through the program's timed path and prints
the numbers that ``check`` compares (the program's readings); for each
control seed it also puts the reference, computed in the precision
below the configured one (TF32 for float32 with TF32 off), in the
program's place and prints the same numbers (the control's readings).
Each line is one JSON object; the last, "summary", has each number's
largest program reading and smallest control reading.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def readings(workload: str, seed: int, device, with_control: bool,
             overrides=None) -> dict:
    """{"program": {...}, "control": {...} or None} for one seed."""
    import torch
    from portbench import harness
    cell = harness.prepare(workload, seed, device, overrides)
    with torch.no_grad():
        cell.loop.run(count=cell.traffic["warm_calls"])
        program = cell.loop.check(cell.loop.outputs())
        control = (cell.loop.check(cell.loop.control()) if with_control
                   else None)
    del cell
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"program": program, "control": control}


def ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, required=True)
    p.add_argument("--control-seeds", type=ints, default=[])
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]
    worst: dict = {"program": {}, "control": {}}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        got = readings(args.workload, seed, "cuda",
                       seed in args.control_seeds)
        print(json.dumps({"seed": seed, **got}), flush=True)
        for k, v in got["program"].items():
            if seed in args.seeds:
                worst["program"][k] = max(worst["program"].get(k, v), v)
        for k, v in (got["control"] or {}).items():
            worst["control"][k] = min(worst["control"].get(k, v), v)
    print(json.dumps({"summary": worst}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.exit(main())
