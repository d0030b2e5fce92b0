"""Training launcher on one device: model + data pipeline + checkpoints +
restart from the newest checkpoint, in one program.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --reduced

The reference's launcher, on one card: a restart resumes from the newest
generation in ``--ckpt-dir`` (the parameters; the optimizer state starts
afresh, as there). ``--batch`` and ``--n-micro`` cut the global batch and
its micro-batches (the reference's: 256 sequences in 8 micro-batches, or
8 in 1 at ``--reduced``). A device mesh (``--mesh``, ``--multi-pod``) is
not ported yet (ROADMAP A8) and raises. The CLI runs on ``cuda``;
:func:`train` also takes ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import signal
import threading
import time

import numpy as np
import torch

from repro_torch import default_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 (not ported yet)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config + tiny batch (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_train")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's, 8 if reduced)")
    ap.add_argument("--n-micro", type=int, default=None,
                    help="micro-batches per step (default: 8, 1 if reduced)")
    return ap


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(args, device=None, params=None) -> dict:
    """Train ``args.steps`` steps of ``args.arch`` on ``device`` (``cuda``
    unless given), resuming from the newest checkpoint in
    ``args.ckpt_dir``; ``params`` (in ``transformer.init``'s layout on
    that device) replaces the seeded draw. Returns the run's figures: the
    steps run, their losses and wall seconds (each step synchronized),
    ms/step and tokens/s over the steps after the first, the checkpoint
    seconds, the final params and, on a resume, the restored params."""
    if getattr(args, "mesh", None) or getattr(args, "multi_pod", False):
        raise NotImplementedError(
            "training over a device mesh is not ported yet (ROADMAP A8); "
            "the port trains on one device")
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.checkpoint import AsyncCheckpointer, restore
    from repro_torch.train.train_step import build_train_step

    dev = default_device(device)
    arch = registry.get(args.arch)
    cfg = arch.reduced(arch.config) if args.reduced else arch.config
    shape = next(s for s in arch.shapes if s.name == args.shape)
    batch = args.batch or (8 if args.reduced else shape.dims["global_batch"])
    seq = 64 if args.reduced else shape.dims["seq_len"]
    n_micro = args.n_micro or (1 if args.reduced else 8)

    rng = np.random.default_rng(0)
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
    if params is None:
        params = transformer.init(torch.Generator(dev).manual_seed(0), cfg,
                                  dev)
    opt = opt_lib.for_family("lm", cfg.param_count())
    step_fn, opt_init = build_train_step(
        lambda p, t: transformer.lm_loss(p, t, cfg), opt, n_micro=n_micro)
    opt_state = opt_init(params)
    start_step, restored, restore_s = 0, None, None
    latest = ckpt.latest()
    if latest:
        t0 = time.perf_counter()
        params, start_step = restore(latest, params)
        _sync(dev)
        restore_s = time.perf_counter() - t0
        restored = params
        print(f"resumed from {latest} (step {start_step})", flush=True)
    step = start_step
    old_handler = None
    if threading.current_thread() is threading.main_thread():
        old_handler = signal.getsignal(signal.SIGTERM)
        ckpt.install_sigterm_hook(lambda: params, lambda: step)

    pipe = Prefetcher(lambda s: synthetic.lm_batch(rng, cfg, batch, seq),
                      depth=2)
    losses, step_s, save_s = [], [], []
    try:
        for step in range(start_step, start_step + args.steps):
            tokens = torch.as_tensor(next(pipe)["tokens"], device=dev)
            t0 = time.perf_counter()
            params, opt_state, loss = step_fn(params, opt_state, tokens)
            losses.append(float(loss))          # waits for the step
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
            if step % 10 == 0:
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"({step_s[-1]:.2f}s/step)", flush=True)
            if step and step % args.ckpt_every == 0:
                t0 = time.perf_counter()
                ckpt.save(params, step)
                save_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ckpt.save(params, step + 1, block=True)
        final_save_s = time.perf_counter() - t0
    finally:
        pipe.close()
        ckpt.wait()
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
    print(f"done; latest checkpoint: {ckpt.latest()}", flush=True)
    steady = step_s[1:] or step_s
    return {"start_step": start_step, "end_step": step + 1,
            "losses": losses, "step_s": step_s,
            "ms_per_step": 1e3 * sum(steady) / len(steady),
            "tokens_per_s": batch * seq * len(steady) / sum(steady),
            "batch": batch, "seq": seq, "n_micro": n_micro,
            "save_s": save_s, "final_save_s": final_save_s,
            "restore_s": restore_s, "latest": ckpt.latest(),
            "params": params, "restored": restored}


def main():
    train(parser().parse_args())


if __name__ == "__main__":
    main()
