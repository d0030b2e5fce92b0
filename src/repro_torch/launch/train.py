"""Training launcher: model + data pipeline + checkpoints + restart from
the newest checkpoint, in one program, on one device or on a device mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --reduced
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 6 --mesh 2x2 --batch 8 --n-micro 2

A restart resumes from the newest generation in ``--ckpt-dir`` (the
parameters; the optimizer state starts afresh, as the reference's does).
``--batch`` and ``--n-micro`` cut the global batch and its micro-batches
(the reference's: 256 sequences in 8 micro-batches, or 8 in 1 at
``--reduced``).

``--mesh 2x2`` (axes as the reference's: ("data", "model"), "pod" in
front of a third dim) runs one rank per mesh device
(``launch/mesh.py::run_ranks``; ranks that share a card talk over gloo).
Each rank draws its part of the parameters (``transformer.init(...,
mesh=)``), builds ``param_specs``, ``zero_specs`` and the batch's
``batched_spec`` as the reference's launcher does, trains on its block of
each batch with the ZeRO-2 step (``build_train_step(...,
grad_shardings=)``), saves by gathering (rank 0 writes the one-device
format) and resumes by resharding (``restore(..., shardings=)``), so a
run on one device resumes on a mesh and the reverse. Without ``--mesh``
the port trains on one device: the reference's ``plan_mesh(len(devices),
256)`` needs 16 devices or more for its model axis. ``--multi-pod`` is
parsed and read by nothing, as in the reference. The CLI runs on
``cuda``; :func:`train` also takes ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import io
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
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2 (data x model; 2x2x2 adds pod): one rank "
                         "per mesh device")
    ap.add_argument("--multi-pod", action="store_true",
                    help="parsed and not read (as in the reference)")
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
    that device) replaces the seeded draw on one device. Returns the
    run's figures: the steps run, their losses and wall seconds (each
    step synchronized), ms/step and tokens/s over the steps after the
    first, the checkpoint seconds, the final params and, on a resume, the
    restored params. With ``args.mesh``: rank 0's figures (its params
    gathered whole, on the host) plus ``ranks``, every rank's step
    seconds, ms/step and (on the card) peak memory."""
    dev = default_device(device)
    if getattr(args, "mesh", None):
        from repro_torch.launch.mesh import parse_mesh, run_ranks
        dims, axes = parse_mesh(args.mesh)
        figs = run_ranks(_train_rank, int(np.prod(dims)),
                         (args, str(dev), dims, axes), device=dev)
        out = dict(figs[0])
        for k in ("params", "restored"):        # rank 0's, by value
            if out[k] is not None:
                out[k] = torch.load(io.BytesIO(out[k]))
        out["ranks"] = [{k: f[k] for k in ("step_s", "ms_per_step",
                                          "max_allocated_bytes")}
                        for f in figs]
        return out
    return _train(args, dev, params)


def _train_rank(args, device, dims, axes) -> dict:
    """A rank of a mesh run (:func:`run_ranks`)."""
    from repro_torch import runtime
    from repro_torch.launch.mesh import make_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh(dims, axes)
    with runtime.use_mesh(mesh):
        fig = _train(args, dev, None, mesh)
    fig["max_allocated_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)
    return fig


def _train(args, dev, params=None, mesh=None) -> dict:
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.launch import sharding as shr
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.checkpoint import AsyncCheckpointer, restore
    from repro_torch.train.train_step import build_train_step

    arch = registry.get(args.arch)
    cfg = arch.reduced(arch.config) if args.reduced else arch.config
    shape = next(s for s in arch.shapes if s.name == args.shape)
    batch = args.batch or (8 if args.reduced else shape.dims["global_batch"])
    seq = 64 if args.reduced else shape.dims["seq_len"]
    n_micro = args.n_micro or (1 if args.reduced else 8)

    rng = np.random.default_rng(0)
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
    pspecs = zspecs = bspec = None
    if mesh is not None:
        whole = transformer.init(torch.Generator(), cfg,
                                 device=torch.device("meta"))
        pspecs = shr.param_specs(whole, cfg, mesh)
        zspecs = shr.zero_specs(whole, pspecs, mesh)
        bspec = shr.batched_spec(mesh, (batch, seq))
        if bspec[0] is None or (batch // shr.data_size(mesh)) % n_micro:
            raise ValueError(f"a batch of {batch} in {n_micro} micro-batches "
                             f"does not split over the mesh's data axes")
        del whole
    if params is None:
        params = transformer.init(torch.Generator(dev).manual_seed(0), cfg,
                                  dev, mesh=mesh)
    opt = opt_lib.for_family("lm", cfg.param_count())
    step_fn, opt_init = build_train_step(
        lambda p, t: transformer.lm_loss(p, t, cfg), opt, n_micro=n_micro,
        grad_shardings=zspecs, param_specs=pspecs)
    opt_state = opt_init(params)
    start_step, restored, restore_s = 0, None, None
    latest = ckpt.latest()
    if latest:
        t0 = time.perf_counter()
        params, start_step = restore(latest, params, pspecs)
        _sync(dev)
        restore_s = time.perf_counter() - t0
        restored = params
        print(f"resumed from {latest} (step {start_step})", flush=True)
    step = start_step
    old_handler = None
    if mesh is None and threading.current_thread() is threading.main_thread():
        # (on a mesh an emergency save would need every rank's gather)
        old_handler = signal.getsignal(signal.SIGTERM)
        ckpt.install_sigterm_hook(lambda: params, lambda: step)

    pipe = Prefetcher(lambda s: synthetic.lm_batch(rng, cfg, batch, seq),
                      depth=2)
    losses, step_s, save_s = [], [], []
    try:
        for step in range(start_step, start_step + args.steps):
            tokens = torch.as_tensor(next(pipe)["tokens"], device=dev)
            if mesh is not None:        # the rank's block of the batch
                tokens = shr.local_part(tokens, bspec, mesh)
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
                ckpt.save(params, step, specs=pspecs)
                save_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ckpt.save(params, step + 1, block=True, specs=pspecs)
        final_save_s = time.perf_counter() - t0
    finally:
        pipe.close()
        ckpt.wait()
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
    if mesh is not None:
        # every rank sees the written checkpoint; rank 0 returns the
        # parameters whole, on the host
        import torch.distributed as dist
        dist.barrier(group=mesh.group(mesh.axis_names))
        params = _host(shr.gather_tree(params, pspecs, mesh), mesh)
        restored = (None if restored is None else
                    _host(shr.gather_tree(restored, pspecs, mesh), mesh))
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


def _host(tree, mesh):
    """Rank 0's tree on the host, serialized (a rank's tensors would cross
    to the launcher by a file descriptor that dies with the rank); None
    on the other ranks."""
    from repro_torch.tree import tree_map
    if mesh.rank != 0:
        return None
    buf = io.BytesIO()
    torch.save(tree_map(lambda t: t.cpu(), tree), buf)
    return buf.getvalue()


def main():
    train(parser().parse_args())


if __name__ == "__main__":
    main()
