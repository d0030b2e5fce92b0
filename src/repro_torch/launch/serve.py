"""Serving launcher: the LM decode service with continuous batching and a
hot-load buffer, from the reference's CLI.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
      --arch smollm-135m --requests 6 --reduced

The CLI runs on ``cuda``; :func:`serve_lm` also takes ``device="cpu"``
(the plain versions of the kernels), injected ``params``, and the
reduced / full-width choice that the CLI's ``--reduced`` (always on, as in
the reference) cannot turn off. ``--mode recsys`` is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs import registry
from repro_torch.models import transformer
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.hotload import DoubleBuffer, Generation

N_SLOTS, S_MAX = 4, 64
MAX_STEPS, PROMPT_LEN, MAX_NEW = 32, 8, 8


def serve_recsys(args):
    raise NotImplementedError(
        "--mode recsys (snapshots, live updates, metrics export) is not "
        "ported yet (ROADMAP A5)")


def serve_lm(args, params=None, device=None) -> dict:
    """The reference's LM decode loop: ``args.requests`` prompts of 8
    tokens into a 4-slot ``ContinuousBatcher`` (s_max 64), one prefill of
    the admitted slots, then up to 32 greedy decode steps. ``args.arch``
    names the config, ``args.reduced`` picks its reduced form. Without
    ``params``, weights are drawn from a ``torch.Generator`` seeded 0 on
    the device. Prints the reference's line and returns its figures."""
    dev = default_device(device)
    arch = registry.get(args.arch)
    cfg = arch.reduced(arch.config) if args.reduced else arch.config
    if params is None:
        params = transformer.init(torch.Generator(dev).manual_seed(0), cfg, dev)
    buf = DoubleBuffer(Generation(0, params))
    batcher = ContinuousBatcher(N_SLOTS, S_MAX)

    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, (PROMPT_LEN,), dtype=np.int32)
               for i in range(args.requests)}
    for i, p in prompts.items():
        batcher.submit(i, len(p), max_new=MAX_NEW)

    # one shared cache table for the slot batch, replaced by the prefill's
    cache = transformer.KVCache.zeros(cfg, N_SLOTS, S_MAX, dev)
    toks = torch.as_tensor(np.stack([prompts[s.request_id]
                                     for s in batcher.slots
                                     if s.request_id is not None]),
                           dtype=torch.long, device=dev)
    logits, cache = transformer.prefill(buf.active.payload, toks, cfg,
                                        smax=S_MAX)
    last = logits.argmax(-1)[:, None]

    t0 = time.monotonic()
    steps = tokens = 0
    while batcher.active_mask.any() and steps < MAX_STEPS:
        tokens += int(batcher.active_mask.sum())
        logits, cache = transformer.decode_step(buf.active.payload, cache,
                                                last, cfg)
        last = logits.argmax(-1)[:, None]
        eos = (last[:, 0] % 97 == 0).cpu().numpy()      # toy EOS criterion
        batcher.step_complete(eos)
        steps += 1
    elapsed = time.monotonic() - t0
    out = {"steps": steps, "requests": args.requests, "tokens": tokens,
           "ms_per_step": elapsed / max(1, steps) * 1e3,
           "tokens_per_s": tokens / elapsed if elapsed > 0 else 0.0,
           "utilization": batcher.utilization,
           "completed": len(batcher.completed)}
    print(f"decoded {steps} steps for {args.requests} requests "
          f"({out['ms_per_step']:.1f} ms/step, "
          f"slot utilization {out['utilization']:.2f}, "
          f"completed {out['completed']})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["recsys", "lm"], default="recsys")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--snapshot-dir", default=None,
                    help="recsys: durable cube snapshots here (enables "
                         "periodic snapshot + SIGTERM final snapshot)")
    ap.add_argument("--recover", action="store_true",
                    help="recsys: boot from the newest valid snapshot and "
                         "replay the delta log (cold boot if none)")
    ap.add_argument("--update-dir", default=None,
                    help="recsys: tail this delta log (live updates)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="recsys: serve /metrics (Prometheus) + "
                         "/metrics.json on this localhost port")
    ap.add_argument("--metrics-out", default=None,
                    help="recsys: write metrics.prom + metrics.json into "
                         "this directory at shutdown")
    ap.add_argument("--history-dir", default=None,
                    help="recsys: record windowed registry history here "
                         "(the IRM offline auto-search input)")
    ap.add_argument("--history-interval-s", type=float, default=1.0)
    ap.add_argument("--trace-out", default=None,
                    help="recsys: export tail-sampled request traces as "
                         "Chrome trace-event JSON to this file")
    args = ap.parse_args(argv)
    if args.mode == "recsys":
        serve_recsys(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
