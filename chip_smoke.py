#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits nonzero:

  1. the card (nvidia-smi name and power limit), torch, capability (9, 0);
  2. the build of the hand-written kernels from ``kernels/csrc`` (nvcc),
     with each kernel's registers, shared memory and spills as ptxas
     reports them (a spill in ``NO_SPILL``'s kernels fails the run);
  3. every kernel against its plain PyTorch version on the card, on the
     reference's own test cells, the edges of each design and the shapes
     of the serving path, with kernel / plain / library times, the
     roofline bound and, for the kernels that launch more than one
     kernel or whose design is new, the device time of each launch;
     embedding_bag both per table and grouped (one launch for all of a
     model call's lookups, against the per-field launches it replaces),
     an empty kernel's launch as the floor under both, the candidate
     scorer on -inf, NaN and signed-zero scores, and din_attention on both
     of its paths (the bulk path at the DNN stage's 65,536 rows timed, held
     to the float64 plain version, its steps counter read; the path
     switch found with the counter), and M1 (``mla_decode``) at short and
     odd lengths and the decode cell's shape (B = 32, S = 32,768), its
     rows counter and the check's power, then its launches in a decode
     step of DeepSeek-V2-Lite cut to 4 layers (one a layer);
  4. DIN, DIEN, MIND and two-tower at their published widths (every table
     cut to 2**16 rows for this phase only): each model's serve_scores and
     its ranking call (score_candidates / retrieve) on the card through
     the kernels, against the same weights on the CPU through the plain
     versions;
  5. the DIN re-rank service (InferenceService on ``cuda``) at published
     widths with user_id / item_id cut to 2**20 rows: two waves of 64
     requests on the AsyncExecutor, every answer checked, and the launch
     count of every kernel checked against the micro-batches and
     re-ranked requests (one grouped embedding_bag launch per model
     call);
  6. the multi-scenario service (MultiScenarioService on ``cuda``: DIN,
     DIEN, MIND, two-tower) at published widths and vocabularies, with
     two-tower's tables capped at 2**21 rows: two waves of 64 requests,
     every scenario's answers checked, and the launch counts checked
     against each scenario's stage stats;
  7. the LM decode service (``launch/serve.py::serve_lm`` on ``cuda``) for
     smollm-135m at its published widths: 6 requests, 4 slots, s_max 64,
     up to 32 decode steps, flash_decode launched once per layer and step;
     then the same weights on the CPU (plain versions) against the card
     over the prefill and 8 teacher-forced decode steps;
  8. the update, durability and scale-out planes of the DIN service of
     phase 5 on ``cuda``: an HBM head table of 65,536 rows on the card fed
     by live deltas (promotions, in-place updates, hits, its rows equal to
     the cube's bit for bit, its gather and scatter timed), periodic
     snapshots and a graceful shutdown's final snapshot; recovery from it
     (no delta replayed, equal cube rows, equal scores) and with two
     versions to replay; the recsys launcher (``serve_recsys``) with every
     telemetry flag, then with ``--recover``; the launch counts of B1-B3
     checked against the stage stats;
  9. training on the card: (a) ``launch/train.py::train`` for smollm-135m
     at its published widths, S=4096, a global batch of 8 in 2
     micro-batches (cut from 256 in 8), 4 steps with a checkpoint every 2
     (cut from 6 and 3 for 13 (f)), then a resume from the newest
     (restored parameters bit for bit), one
     step's device time and idle share by torch.profiler; (b) one LM train
     step card vs CPU at B=2, S=256 (loss, every gradient, the update);
     (c) DIN at published widths (user_id / item_id cut to 2**20) at the
     published rec_train batch of 65,536 through ``build_train_step``, one
     grouped embedding_bag and one din_attention launch a step (checked),
     gradients card vs CPU at B=4,096, a checkpoint diff whose delta holds
     exactly the rows with a non-zero gradient and turns a cube of the old
     table into the new one bit for bit; (d) DIEN, MIND and two-tower
     gradients card vs CPU at phase 4's widths, B=1,024, B4's forward at
     B=65,536 against its plain version, and the backward times of B2, B3
     and B4 at the path's shapes (their plain versions' gradients);
 10. SchNet and the single-card cell tooling: (a) SchNet at its published
     widths (3 interactions, d_hidden 64, n_rbf 300, cutoff 10) on the
     molecule, full_graph_sm and minibatch_lg shapes (the last drawn by
     the neighbour sampler over a 232,965-node graph), the loss and every
     gradient leaf card vs CPU on one seeded weight set, then 5 AdamW
     steps with ms/step, max_memory_allocated and the idle share; (b)
     ``launch/dryrun.py::run_cell`` over SchNet's four shapes (ogb_products
     recorded as not fitting one card, not run), DIN x serve_p99 (B2 and
     B3 at published widths and vocabularies, first held against their
     plain versions on the cell's own inputs) and smollm-135m x long_500k
     (B6 over 24 GB of float32 K/V, its shape held in phase 3), each
     cell's kernels checked launched, then the roofline table of the
     records with H100 data-sheet peaks;
 11. the recsys models on a 2x2 (data, model) device mesh of 4 ranks
     sharing the one card over gloo (``launch/mesh.py``; NCCL refuses two
     ranks on one device, so the times are 4 processes on one card, not a
     multi-GPU figure): (a) DIN at its published widths and vocabularies
     (2^26-row user_id / item_id, 2.45 GB of tables a rank) serve_scores
     at B=512 (one grouped embedding_bag and one din_attention launch a
     rank) and the fused score_candidates at C=64 (rerank_score on every
     rank); (b) DIEN, MIND and two-tower at published widths (tables cut
     to 2^20 rows, two-tower's to 2^21), serve_scores and the ranking
     call; each held within TOL_MODEL against the same seeded weights run
     whole on the card, rankings index for index, launches checked per
     rank; then (c) ``run_cell`` over din x serve_p99, din x
     retrieval_cand and dien x serve_p99 on ``2x2@1xH100`` with each
     rank's ms/step, peak memory, launches and collectives by kind with
     their bytes, against the cell run whole. Every kernel call of a
     rank's counted call in (a), (b) and (c) is replayed on that rank's
     own inputs (its table shard, ownership weights, block of the batch)
     through the wrapper and the plain version, and held to TOL_F32;
 12. the LM on the same 2x2 mesh of 4 ranks sharing the card over gloo,
     at published widths: (a) smollm-135m x long_500k and (b)
     deepseek-v2-lite-16b x long_500k by ``run_cell`` (no cut: B=1, the
     sequence split over (data, model), B6 with its lse on every rank of
     (a), MLA's distributed softmax and the replicated-token MoE in (b));
     (c) deepseek-v2-lite-16b prefill at B=4, S=4096 (cut from
     prefill_32k's B=32, S=32,768: the token-sharded MoE); (d) qwen3-8b
     prefill of 64 tokens then 4 teacher-forced decode steps in a cache
     of 32,768 rows at B=4 (cut from decode_32k's B=128: head TP, B6 in
     bf16 with sequence shards left empty); (e) (b) and (f) (d) in
     float32. (c) and (e) run 2 layers, (d) 4 and (f) 1 (cut since
     phase 13 came). Each is held against the same draws run
     whole by one process first (``--lm-whole``, a process of its own):
     float32 logits and cache rows within TOL_LM ((c)'s rows with the
     recorded routing explaining each row off); (d)'s bf16 logits
     against the float32 run of its weights, at most BF16_ERR_RATIO
     times the bf16 whole run's error; (b)'s reported (a bf16 MoE's near
     ties trade experts; (e) holds its layers); every rank's B6 calls
     replayed against the plain version; each rank's ms per call, peak
     memory, launches and collectives by kind;
 13. training on the same 2x2 mesh, each item against the same draws
     run whole first (``--train-whole``, a process of its own; the LM's
     losses are phase 9's run): (a) smollm-135m at published widths,
     S=4096, 8 sequences (cut from 256), the first step's loss and every
     gradient leaf (gathered) within TOL_LM leaf-scaled, then
     ``launch/train.py --mesh 2x2`` for 2 steps in 2 micro-batches with a
     checkpoint every step (cut from 6 and 3 for the call's time; losses
     within TOL_LM of phase 9's first 2), the mesh's checkpoint restored
     by one device bit for bit, and a resume on the mesh (each rank's
     part restored, the whole bit for bit); (b) DIN at published widths and
     vocabularies, B=4,096, and (c) DIEN, MIND and two-tower at phase 4's
     widths (tables cut to 2^16 rows), B=1,024: loss and dense gradients
     within TOL_MODEL leaf-scaled, each table's rows with a gradient the
     same rows and within TOL_MODEL, B2 / B3 / B4 launched on every rank
     and every rank's calls replayed against their plain versions; (d)
     SchNet at published widths on three shapes, loss and gradients
     within TOL_MODEL, 5 AdamW steps (the parameters within TOL_LM, each
     leaf's update within 1% of its largest), every rank's losses and
     parameters the same bits; (e) ``run_cell`` on the mesh for
     smollm-135m x train_4k (must not fit a rank's share), din x
     train_batch (B2 and one grouped B3 a step on every rank, replayed)
     and SchNet's ogb_products (must not fit), 1 timed step a cell
     (SchNet's other three shapes cut: (d) holds them); (f)
     deepseek-v3-671b's training layout (the reference's ``fsdp_params``
     and ``shard_carry``) at published widths (d_model 7,168, 128 heads,
     MLA, vocab 129,280, dense d_ff 18,432, expert d_ff 2,048, top-8, one
     shared expert, MTP, bf16, remat, Adafactor, ``zero_specs`` at its
     2^20 minimum), cut to 2 layers (1 dense, 1 MoE; from 61) and 16
     routed experts (from 256), ~4.4 B parameters, S=4096 and one
     sequence a data rank (global batch 2, from 256 x 4096), one step in
     the ZeRO-3 layout with the split residual and one in the ZeRO-2
     layout with the whole residual on the same draws, each under the op
     counter: the loss within TOL_LM and every updated parameter within
     TOL_LM leaf-scaled (the largest difference printed), every rank's
     ZeRO-3 blocks of their spec's shape, each rank's peak lower in the
     ZeRO-3 layout, no all_gather after the ZeRO-3 backward, the
     collectives by kind and the ms a step; a job of (a)-(d)'s launch;
 14. the production-mesh dry run, in a process of its own started at the
     call's start (CUDA hidden from it: the meta device needs no card)
     and joined here: (a) ``launch/dryrun.py::dry_run_cell`` counts every
     rank of the 2x2 cells that [11c], [12] and [13e] run live (din x
     serve_p99, din x retrieval_cand, dien x serve_p99, smollm-135m and
     deepseek-v2-lite-16b x long_500k, din x train_batch, and [13f]'s
     ZeRO-3 cell) on the meta device, and each rank's dry count is held
     to its live record:
     collectives by kind (calls, bytes), kernel calls, and flops and
     bytes exactly outside the kernels whose dry cost is a bound (those
     at least the live count, the excess printed), with the dry peak
     against ``max_memory_allocated`` as a ratio; (b) ``python -m
     repro_torch.launch.dryrun --production`` and ``--production
     --multi-pod`` for din x serve_p99, schnet x molecule and
     smollm-135m x decode_32k, each record ok, its argument bytes those
     of ``arg_bytes_per_device``, with its GB a device, fit, flops,
     collective traffic by kind and the roofline's modelled dominant
     term;
 15. the kernel table as one JSON line (launches from phase 6, and from
     phase 7 for flash_decode and 3 for mla_decode; ``backward_ms`` from
     phase 9;
     ``mesh_launches`` from phase 11 (a) and (b), and for flash_decode
     from phase 12 (a), (d) and (f), over all ranks;
     ``mesh_train_launches`` from phase 13 (b), (c) and (e); ``lse_ms``,
     B6 with ``return_lse``, from phase 3), the card line, and the
     result.

Needs a CUDA device; exits nonzero without one, and without the
repository's ``src/repro_torch`` beside this script.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

TOL_F32 = 2e-5                    # tests/test_kernels.py, test_rerank_fused.py
TOL_EDGE = 3e-5                   # tests/test_kernel_edge_parity.py; augru
TOL_BF16 = 2e-2                   # tests/test_kernels.py (bf16)
# model phase: the card's kernels and the CPU's plain versions sum in
# different orders (warp reductions, decomposed first layer, CPU BLAS
# blocking); the reference's own parity tolerance covers that
TOL_MODEL = 2e-5
# LM phase: 30 layers of float32 sums in different orders on card and CPU;
# the reference's own LM tolerance (tests/test_models.py, decode vs prefill)
TOL_LM = 2e-3

MAIN_VOCAB_LOG2 = 26              # published DIN user_id / item_id rows
DIN_SERVICE_VOCAB_LOG2 = 20       # phase 5's user_id / item_id rows
TOWERS_VOCAB_LOG2 = 21            # phase 6's cap on two-tower's tables
N_REQUESTS = 64                   # requests per wave of the service phases

KERNEL_META = {
    "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:35"),
    "din_attention": ("src/repro_torch/kernels/csrc/din_attention.cu",
                      "src/repro/kernels/din_attention/kernel.py:42"),
    "rerank_score": ("src/repro_torch/kernels/csrc/rerank_score.cu",
                     "src/repro/kernels/rerank_score/kernel.py:82"),
    "augru": ("src/repro_torch/kernels/csrc/augru.cu",
              "src/repro/kernels/augru/kernel.py:48"),
    "candidate_scorer": ("src/repro_torch/kernels/csrc/candidate_scorer.cu",
                         "src/repro/kernels/candidate_scorer/kernel.py:42"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:67"),
    "mla_decode": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                   "none: the JAX package's MLA decode is plain jnp"),
}


#: kernels whose design holds its operands in registers: ptxas must report
#: no spill for them
NO_SPILL = ("augru_recurrence",)


def ptxas_usage(log: str) -> list:
    """(kernel name, resource usage) per entry function of ``nvcc -Xptxas
    -v``'s output: registers, static shared memory, stack and spills."""
    import re
    out = []
    for block in log.split("Compiling entry function")[1:]:
        name = re.match(r"\s*'(\w+)'", block).group(1)
        # _ZN<len><anonymous namespace><len><name>... or _Z<len><name>...
        m = re.match(r"_ZN(\d+)", name)
        rest = name[m.end() + int(m.group(1)):] if m else name[2:]
        n = re.match(r"(\d+)", rest)
        if n:
            name = rest[n.end():n.end() + int(n.group(1))]

        def num(pattern):
            found = re.search(pattern, block)
            return int(found.group(1)) if found else 0
        out.append((name, dict(registers=num(r"Used (\d+) registers"),
                               smem=num(r"(\d+) bytes smem"),
                               stack=num(r"(\d+) bytes stack frame"),
                               spill_stores=num(r"(\d+) bytes spill stores"),
                               spill_loads=num(r"(\d+) bytes spill loads"))))
    return out


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _event_ms(run, n):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, iters=20, replays=10):
    """Mean device time per call of ``fn``: ``iters`` calls captured into
    one CUDA graph, the graph replayed ``replays`` times between CUDA
    events. Replays issue no Python, so the host cannot stall the device."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()
    ms = _event_ms(run, replays * iters)
    del graph
    return ms


def launch_split(fn, iters=20) -> dict:
    """Device time per call of each kernel that ``fn`` launches, by kernel
    name, from torch.profiler's ``key_averages`` over ``iters`` eager
    calls (the split of a wrapper that launches more than one kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    split = {}
    for _attempt in range(3):       # a profiling pass may come back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            # "void (anonymous namespace)::name<...>(args)" -> "name"
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split()[-1].split("::")[-1]
            split[name] = (split.get(name, 0.0)
                           + e.self_device_time_total / 1e3 / iters)
        if split:
            break
    return split


def timings(kernel_fn, plain_fn, library_fn=None) -> dict:
    """Device times (graph replay) of the kernel, its plain version and
    the library call."""
    return dict(ms=device_ms(kernel_fn), plain_ms=device_ms(plain_fn),
                library_ms=None if library_fn is None else device_ms(library_fn))


def bound_ms(cost, dtype="float32"):
    """The least time for the work ``cost`` = (flops, bytes), a kernel's
    ``cost(...)``: bytes over the memory rate, or operations over the peak
    rate of their type, whichever is larger (the H100 data-sheet peaks of
    ``repro_torch.launch.roofline``)."""
    from repro_torch.launch import roofline
    flops, nbytes = cost
    t, by = roofline.bound_s(flops, nbytes, roofline.peak_flops(dtype))
    return t * 1e3, by


def verdict(got, want, tol, scale_tol=None):
    """(max-abs-diff, share of the allowance used, within it) of ``got``
    against ``want``: assert_allclose(rtol=atol=tol) semantics, and with
    ``scale_tol`` also max|got - want| <= scale_tol * max|want|, which
    holds outputs far below tol in magnitude (long softmax averages) to
    their own scale."""
    import torch
    got, want = got.float(), want.float()
    if not got.numel():
        return 0.0, 0.0, True
    diff = (got - want).abs()
    err = float(diff.max())
    # share of the allowance used: |got - want| / (tol + tol * |want|) <= 1
    used = float((diff / (tol + tol * want.abs())).max())
    ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
    scale = float(want.abs().max())
    if scale_tol is not None and scale > 0:     # (an all-zero want: no scale)
        used = max(used, err / (scale_tol * scale))
        ok = ok and used <= 1.0
    return err, used, ok


def compare(name, got, want, tol, scale_tol=None):
    """max-abs-diff of kernel vs plain, held to assert_allclose(rtol=atol=
    tol) semantics (and to ``scale_tol`` of max|want|, see ``verdict``)."""
    import torch
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    err, used, ok = verdict(got, want, tol, scale_tol)
    rule = "rtol=atol" + ("" if scale_tol is None
                          else f", and {scale_tol:g} x max|want|")
    print(f"  {name}: max_abs_err={err:.3e} tol={tol:g} ({rule}) "
          f"allowance used {used:.3f} {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


# ------------------------------------------------------------------ phase 3

def kernel_checks(results: dict):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.rerank_score import rerank_score, rerank_score_ref
    from repro_torch.kernels.rerank_score import ops as rerank_ops

    rng = np.random.default_rng(0)
    dev = "cuda"

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    # ---- B3 embedding_bag
    print("[3] embedding_bag vs plain", flush=True)
    for V, D, B, K in [(64, 8, 8, 3), (128, 64, 16, 5), (1000, 128, 8, 10),
                       (32, 256, 24, 1)]:
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            for comb in ("sum", "mean"):
                table = t(rng.normal(size=(V, D)), dtype)
                ids = t(rng.integers(0, V, (B, K)), torch.int64)
                w = t(rng.random((B, K)) > 0.2)
                compare(f"V={V} D={D} B={B} K={K} {str(dtype)[6:]} {comb}",
                        embedding_bag(table, ids, w, comb),
                        embedding_bag_ref(table, ids, w, comb), tol)
    for B, K in [(1, 1), (1, 5), (8, 1)]:
        for comb in ("sum", "mean"):
            table = t(rng.normal(size=(32, 8)))
            ids = t(rng.integers(0, 32, (B, K)), torch.int64)
            w = t(rng.random((B, K)))
            compare(f"edge B={B} K={K} {comb}", embedding_bag(table, ids, w, comb),
                    embedding_bag_ref(table, ids, w, comb), TOL_EDGE)
    for comb in ("sum", "mean"):
        table = t(rng.normal(size=(16, 4)))
        ids = t(rng.integers(0, 16, (3, 4)), torch.int64)
        w = torch.zeros((3, 4), device=dev)
        got = embedding_bag(table, ids, w, comb)
        compare(f"edge all-zero weights {comb}", got,
                embedding_bag_ref(table, ids, w, comb), TOL_EDGE)
        check(float(got.abs().max()) <= 1e-6, "all-zero bag is not zero")
    # PR 11's main-path cell, the per-bag launch: the history lookup of a
    # 16-request micro-batch (16 x 100 single-id bags) into the item_id
    # table
    V, D, n = 1 << MAIN_VOCAB_LOG2, 18, 16 * 100
    table = torch.randn((V, D), device=dev).mul_(0.01)
    from repro_torch.data.synthetic import zipf_ids
    ids = t(zipf_ids(rng, n, V).reshape(n, 1), torch.int64)
    err = compare(f"per-bag launch V=2^{MAIN_VOCAB_LOG2} D=18 B={n} K=1",
                  embedding_bag(table, ids), embedding_bag_ref(table, ids),
                  TOL_F32)
    bms, by = bound_ms(bag_ops.cost([(table, ids, None)]))
    results["embedding_bag@per-bag"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        shape=f"V=2^{MAIN_VOCAB_LOG2} D=18 B={n} K=1, one table a launch",
        **timings(lambda: embedding_bag(table, ids),
                  lambda: embedding_bag_ref(table, ids),
                  lambda: F.embedding_bag(ids, table, mode="sum")))
    del table
    torch.cuda.empty_cache()
    embedding_bag_group_checks(results, rng, t)

    din_attention_checks(results, rng, t)

    # ---- B1 rerank_score
    print("[3] rerank_score vs plain", flush=True)

    def towers(D, d_u, d_i, H1, H2, M1, M2, model_init):
        # the reference's test cells scale weights by 0.2; the full-DIN
        # cells use the model's own init (1/sqrt(fan-in)), which keeps
        # the 100-step unnormalised pooling at the magnitudes it serves
        def mk(*s):
            scale = 1.0 / math.sqrt(s[0]) if model_init else 0.2
            return t(rng.normal(size=s) * scale)
        return ([{"w": mk(4 * D, H1), "b": mk(H1)}, {"w": mk(H1, H2), "b": mk(H2)},
                 {"w": mk(H2, 1), "b": mk(1)}],
                [{"w": mk(2 * D + d_u + d_i, M1), "b": mk(M1)},
                 {"w": mk(M1, M2), "b": mk(M2)}, {"w": mk(M2, 1), "b": mk(1)}])

    def rr_case(C, T, D, d_u, d_i, dims, mask, tol, label, model_init=False):
        hist = t(rng.normal(size=(T, D)))
        tgt = t(rng.normal(size=(C, D)))
        uo = t(rng.normal(size=(d_u,)))
        io = t(rng.normal(size=(C, d_i)))
        attn, mlp = towers(D, d_u, d_i, *dims, model_init)
        flat = [p[k] for p in attn + mlp for k in ("w", "b")]
        m = t(mask)
        err = None if tol is None else compare(
            label, rerank_score(hist, m, tgt, uo, io, attn, mlp),
            rerank_score_ref(hist, m, tgt, uo, io, *flat), tol)
        return (hist, m, tgt, uo, io, attn, mlp, flat), err

    small = (16, 16, 32, 32)
    for C, T in [(64, 7), (300, 12), (257, 33), (128, 1), (130, 16)]:
        rr_case(C, T, 8, 16, 8, small, rng.random(T) > 0.3, TOL_F32,
                f"edge C={C} T={T}")
    rr_case(64, 24, 8, 16, 8, small, np.zeros(24), TOL_F32,
            "edge fully masked history")
    # the design's edges: one step, more chunks than a cluster's 8 blocks
    # (each block then loops over its chunks), one candidate, odd C
    for C, T in [(7, 1), (1, 40), (63, 257), (33, 300), (129, 100)]:
        rr_case(C, T, 8, 16, 8, small, rng.random(T) > 0.3, TOL_F32,
                f"design edge C={C} T={T}")
    full = (80, 40, 200, 80)
    for C, T in [(1, 100), (63, 300), (16, 100), (32, 100), (64, 100)]:
        case, err = rr_case(C, T, 18, 36, 18, full, rng.random(T) > 0.2,
                            TOL_F32, f"full DIN C={C} T={T}", model_init=True)
    hist, m, tgt, uo, io, attn, mlp, flat = case
    got = rerank_score(hist, m, tgt, uo, io, attn, mlp).double()
    plain = rerank_score_ref(hist, m, tgt, uo, io, *flat).double()
    want64 = rerank_score_ref(*(x.double() for x in (hist, m, tgt, uo, io,
                                                     *flat)))
    print(f"  full DIN C=64 T=100: kernel vs f64 plain "
          f"{float((got - want64).abs().max()):.3e}, f32 plain vs f64 plain "
          f"{float((plain - want64).abs().max()):.3e}, max |score| "
          f"{float(want64.abs().max()):.3e}; launches (profiler, ms per "
          f"call): {launch_split(lambda: rerank_score(hist, m, tgt, uo, io, attn, mlp))}",
          flush=True)
    bms, by = bound_ms(rerank_ops.cost(hist, m, tgt, uo, io, *flat))
    results["rerank_score"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        shape="C=64 T=100 D=18 d_u=36 d_i=18 attn 80-40 mlp 200-80",
        **timings(lambda: rerank_score(hist, m, tgt, uo, io, attn, mlp),
                  lambda: rerank_score_ref(hist, m, tgt, uo, io, *flat)))
    # the reference tests' 0.2-scaled weights at full DIN widths: a
    # reading beside a float64 plain version on the card, not a gate (the
    # model-init cells above are B1's gate)
    for C in (16, 64):
        (hist, m, tgt, uo, io, attn, mlp, flat), _ = rr_case(
            C, 100, 18, 36, 18, full, rng.random(100) > 0.2, None,
            f"full DIN C={C} T=100, weights x0.2")
        f64 = [x.double() for x in (hist, m, tgt, uo, io, *flat)]
        want64 = rerank_score_ref(*f64)
        got = rerank_score(hist, m, tgt, uo, io, attn, mlp).double()
        plain = rerank_score_ref(hist, m, tgt, uo, io, *flat).double()
        scale = float(want64.abs().max())
        print(f"  full DIN C={C} x0.2: kernel vs f32 plain "
              f"{float((got - plain).abs().max()):.3e} (within rtol=atol="
              f"{TOL_F32:g}: {bool(torch.allclose(got, plain, TOL_F32, TOL_F32))}"
              f"), kernel vs f64 plain {float((got - want64).abs().max()):.3e}"
              f", f32 plain vs f64 plain "
              f"{float((plain - want64).abs().max()):.3e}, max |score| "
              f"{scale:.3e}", flush=True)

    augru_checks(results, rng, t)
    candidate_scorer_checks(results, rng, t)
    flash_decode_checks(results, rng, t)
    mla_decode_checks(results)
    for name, r in results.items():
        if name == "launch_floor":
            continue
        print(f"[3] {name} @ {r['shape']}: device time per call (CUDA graph "
              f"replay): kernel {r['ms']} ms, plain {r['plain_ms']} ms, "
              f"library {r['library_ms']} ms, bound {r['bound_ms']} ms "
              f"({r['bound_by']})", flush=True)


def din_attention_checks(results: dict, rng, t):
    """B2 against its plain version (2e-5; the reference's edge cells
    3e-5) on both of its paths. The cluster path (B x chunks within what
    the card holds as clusters): the reference's cells, T just past a
    chunk (16) and a cluster's span (128), T = 1, non-zero biases, an
    all-zero-mask row, and B=16 T=100 timed. The bulk path: the DNN
    stage's shape (B = 65,536, T = 100, D = 18, 80-40, prefix masks of
    lengths 1-100) timed by graph replay, with the steps counter held to
    the count of non-empty chunks and read over the valid steps; masks
    with holes and with whole 16-step chunks masked between valid ones;
    all-zero rows (zero exactly); B on each side of the path switch,
    found with the counter, and at it; T = 1, 37 and 129; widths 37-11
    with non-zero biases."""
    import numpy as np
    import torch
    from repro_torch.kernels.din_attention import din_attention, din_attention_ref
    from repro_torch.kernels.din_attention import ops as din_ops

    print("[3] din_attention vs plain", flush=True)

    def din_args(B, T, D, H1, H2, mask, bias=False):
        hist = t(rng.normal(size=(B, T, D)))
        tgt = t(rng.normal(size=(B, D)))
        w1 = t(rng.normal(size=(4 * D, H1)) * 0.2)
        w2 = t(rng.normal(size=(H1, H2)) * 0.2)
        w3 = t(rng.normal(size=(H2, 1)) * 0.2)
        b1, b2, b3 = (t(rng.normal(size=(n,)) * 0.1 if bias else np.zeros(n))
                      for n in (H1, H2, 1))
        return (hist, t(mask), tgt, w1, b1, w2, b2, w3, b3)

    def din_case(B, T, D, H1, H2, mask, tol, label, bias=False):
        args = din_args(B, T, D, H1, H2, mask, bias)
        err = compare(label, din_attention(*args), din_attention_ref(*args), tol)
        return args, err

    def bulk_case(label, args):
        """A bulk-path case, held to the float64 plain version at
        rtol=atol=TOL_F32: over thousands of rows at these weights two
        float32 computations part by up to the whole allowance (on an H100
        at B = 65,536: the float32 plain version from the float64 one 0.97
        of it, the cluster path run at that batch from the float32 one
        1.21), so the float64 version is the oracle; the float32 plain
        version's distances are printed beside it."""
        got = din_attention(*args)
        want64 = din_attention_ref(*(a.double() for a in args))
        err = compare(f"{label}, vs f64 plain", got, want64, TOL_F32)
        plain = din_attention_ref(*args)
        print(f"    f32 plain vs f64 plain: allowance used "
              f"{verdict(plain, want64, TOL_F32)[1]:.3f}; kernel vs f32 "
              f"plain: {verdict(got, plain, TOL_F32)[1]:.3f}", flush=True)
        del want64, plain
        return got, err

    for B, T, D, H1, H2 in [(8, 8, 8, 8, 4), (16, 100, 18, 80, 40),
                            (12, 33, 16, 32, 8)]:
        args, err = din_case(B, T, D, H1, H2, rng.random((B, T)) > 0.2,
                             TOL_F32, f"B={B} T={T} D={D} H1={H1} H2={H2}")
        if (B, T, D, H1, H2) == (16, 100, 18, 80, 40):
            full_args, full_err = args, err
    for B, T in [(1, 1), (1, 9), (5, 1)]:
        din_case(B, T, 8, 16, 8, np.ones((B, T)), TOL_EDGE, f"edge B={B} T={T}")
    din_case(2, 6, 8, 16, 8, np.zeros((2, 6)), TOL_EDGE, "edge zero mask")
    # the cluster path's edges: T just past a chunk (16 steps) and past a
    # cluster's span (8 chunks: each block then loops over its chunks),
    # T = 1, and a row whose mask is all zero inside a batch of non-zero
    # rows
    CHUNK = din_ops.CHUNK
    span = CHUNK * din_ops.MAX_CLUSTER
    for B, T in [(16, CHUNK + 1), (16, 2 * CHUNK + 1), (4, span),
                 (4, span + 1), (3, 2 * span + 5), (16, 1)]:
        din_case(B, T, 18, 80, 40, rng.random((B, T)) > 0.2, TOL_F32,
                 f"cluster edge B={B} T={T} D=18 H1=80 H2=40")
    for H1, H2 in [(80, 40), (37, 11)]:          # non-zero biases, padding
        din_case(16, 100, 18, H1, H2, rng.random((16, 100)) > 0.2, TOL_F32,
                 f"cluster edge B=16 T=100 H1={H1} H2={H2}, non-zero biases",
                 bias=True)
    zero_row = rng.random((16, 100)) > 0.2
    zero_row[5] = False
    din_case(16, 100, 18, 80, 40, zero_row, TOL_F32,
             "cluster edge B=16 T=100, row 5's mask all zero")
    bms, by = bound_ms(din_ops.cost(*full_args))
    results["din_attention"] = dict(
        max_abs_err=full_err, bound_ms=bms, bound_by=by,
        shape="B=16 T=100 D=18 H1=80 H2=40",
        **timings(lambda: din_attention(*full_args),
                  lambda: din_attention_ref(*full_args)))

    def nonempty_steps(mask):
        """CHUNK x the chunks of ``mask`` that hold a non-zero."""
        B, T = mask.shape
        n = -(-T // CHUNK)
        padded = np.zeros((B, n * CHUNK), bool)
        padded[:, :T] = mask != 0
        return int(padded.reshape(B, n, CHUNK).any(-1).sum()) * CHUNK

    def prefix(B, T, lo=1):
        return np.arange(T)[None] < rng.integers(lo, T + 1, (B, 1))

    # the bulk path at the DNN stage's shape, as din.bulk hands it
    B, T = 65536, 100
    mask = prefix(B, T)
    args = din_args(B, T, 18, 80, 40, mask)
    _, err = bulk_case(f"bulk B={B} T={T} D=18 H1=80 H2=40, prefix masks "
                       f"1-{T}", args)
    steps, valid = din_ops.computed_steps(*args), int(mask.sum())
    check(steps == nonempty_steps(mask),
          f"bulk steps counter {steps}, expected {nonempty_steps(mask)}")
    ms = device_ms(lambda: din_attention(*args), iters=10, replays=5)
    bms, by = bound_ms(din_ops.cost(*args))
    print(f"  bulk B={B} T={T}: {ms:.5f} ms a call (graph replay), bound "
          f"{bms:.5f} ms ({by}), {100 * bms / ms:.2f}% of it; steps "
          f"computed {steps} over valid {valid}: {steps / valid:.4f} a "
          f"valid step", flush=True)
    check(steps / valid <= 1.2, "bulk path computes over 1.2 steps a valid "
          "step at the DNN stage's mix")
    results["din_attention@bulk"] = dict(
        max_abs_err=err, ms=ms, plain_ms=None, library_ms=None, bound_ms=bms,
        bound_by=by, steps_per_valid=steps / valid,
        shape=f"B={B} T={T} D=18 H1=80 H2=40, prefix masks 1-{T}")
    del args
    torch.cuda.empty_cache()
    s16 = din_ops.computed_steps(*full_args)
    print(f"  cluster B=16 T=100: steps computed {s16} over valid "
          f"{int((full_args[1] != 0).sum())}", flush=True)
    check(s16 == 16 * -(-100 // CHUNK) * CHUNK,
          "the cluster path computes every chunk")

    # masks the bulk path skips inside: holes, and whole chunks masked
    # between valid ones; rows whose mask is all zero
    B, T = 4096, 100
    holes = rng.random((B, T)) > 0.3
    gaps = rng.random((B, T)) > 0.2
    for c in (1, 3, 4):
        gaps[:, c * CHUNK:(c + 1) * CHUNK] = False
    gaps[::7, :2 * CHUNK] = False
    for label, mask in (("holes", holes), ("whole chunks masked", gaps)):
        args = din_args(B, T, 18, 80, 40, mask)
        bulk_case(f"bulk B={B} T={T}, {label}", args)
        check(din_ops.computed_steps(*args) == nonempty_steps(mask),
              f"bulk steps counter, {label}")
    zero = prefix(B, T)
    rows = [0, 5, 17, 2048, B - 1]
    zero[rows] = False
    zero[100:164] = False                 # a run of zero rows
    got, _ = bulk_case(f"bulk B={B} T={T}, all-zero rows",
                       din_args(B, T, 18, 80, 40, zero))
    check(float(got[rows].abs().max()) == 0.0
          and float(got[100:164].abs().max()) == 0.0,
          "an all-zero-mask row's output is not zero")

    # the path switch: the smallest B the bulk path takes, found with the
    # counter on masks whose first chunk is empty (the cluster path
    # computes it, the bulk path skips it); then B on each side and at it
    T = 100
    one = np.ones((1, T), bool)
    one[:, :CHUNK] = False

    def bulk(B):
        a = din_args(B, T, 18, 80, 40, np.repeat(one, B, 0))
        return din_ops.computed_steps(*a) < B * -(-T // CHUNK) * CHUNK

    lo, hi = 1, 4096
    check(not bulk(lo) and bulk(hi), "the path switch lies outside 1-4096")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if bulk(mid) else (mid, hi)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  path switch at T={T} D=18: B <= {lo} cluster, B >= {hi} bulk "
          f"({sms} SMs; {lo} x {-(-T // CHUNK)} chunks <= the card's "
          f"resident cluster blocks)", flush=True)
    for B in (lo - 1, lo):
        din_case(B, T, 18, 80, 40, prefix(B, T), TOL_F32,
                 f"switch B={B} T={T} (cluster)")
    for B in (hi, hi + 1):
        bulk_case(f"switch B={B} T={T} (bulk)",
                  din_args(B, T, 18, 80, 40, prefix(B, T)))

    # the bulk path's edges: B = 256 (a block a row), T = 1, 37 (a
    # partial last chunk), 129 (past 8 chunks); widths 37-11 with non-zero
    # biases (padded units)
    bulk_case("bulk edge B=256 T=100 D=18 H1=80 H2=40",
              din_args(256, 100, 18, 80, 40, rng.random((256, 100)) > 0.2))
    for T in (1, 37, 129):
        bulk_case(f"bulk edge B=4096 T={T} D=18 H1=80 H2=40",
                  din_args(4096, T, 18, 80, 40, prefix(4096, T)))
    bulk_case("bulk edge B=4096 T=100 H1=37 H2=11, non-zero biases",
              din_args(4096, 100, 18, 37, 11, prefix(4096, 100), bias=True))


def embedding_bag_group_checks(results: dict, rng, t):
    """The grouped B3 launch against its plain version (2e-5 f32, 2e-2
    bf16) on the lookups of the path's model calls, each in f32 and bf16
    with sum and mean: a DIN/DIEN ranker micro-batch (B=16, T=100: the
    history into the 2^26-row item_id table, the target, user_id,
    user_profile (K=4), item_cat; 5 groups, 1 launch where PR 15 made 5), a
    re-rank at C=64 (history, user fields, the candidates' item_cat) and a
    two-tower user call (D=256: user_id, user_hist K=50, user_geo,
    user_ctx K=8); then a group of zero bags, 8 groups, all-zero weights.
    Times the micro-batch's grouped launch against the per-field plan it
    replaces (5 launches of the per-bag kernel, unchanged since PR 11, and
    the concatenation), the plain version, F.embedding_bag over the groups
    and an empty kernel's launch in the same graph replay."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.data.synthetic import zipf_ids
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_group,
                                                   embedding_bag_group_ref)

    print("[3] embedding_bag_group vs plain", flush=True)
    big = 1 << MAIN_VOCAB_LOG2
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, V, D) -> f32 table; bf16 copies made per cell
    tables = {}

    def table(name, V, D):
        if (name, V, D) not in tables:
            tables[name, V, D] = torch.randn((V, D), device="cuda").mul_(0.01)
        return tables[name, V, D]

    def ids(V, B, K):
        return t(zipf_ids(rng, B * K, V).astype(np.int64).reshape(B, K),
                 torch.int64)

    def weights(B, K):
        return t(rng.random((B, K)) * (rng.random((B, K)) > 0.2))

    def din_batch(B=16, T=100):
        return ([("item_id", big, 18, ids(big, B * T, 1), None),
                 ("item_id", big, 18, ids(big, B, 1), None),
                 ("user_id", big, 18, ids(big, B, 1), None),
                 ("user_profile", 1 << 20, 18, ids(1 << 20, B, 4),
                  weights(B, 4)),
                 ("item_cat", 1 << 20, 18, ids(1 << 20, B, 1), None)],
                (1, 4))

    def rerank(C=64, T=100):
        return ([("item_id", big, 18, ids(big, T, 1), None),
                 ("user_id", big, 18, ids(big, 1, 1), None),
                 ("user_profile", 1 << 20, 18, ids(1 << 20, 1, 4), None),
                 ("item_cat", 1 << 20, 18, ids(1 << 20, C, 1), None)],
                (1, 2, 1))

    def towers_user():
        V = 1 << TOWERS_VOCAB_LOG2
        return ([("user_id", V, 256, ids(V, 1, 1), None),
                 ("user_hist", V, 256, ids(V, 1, 50), None),
                 ("user_geo", 1 << 20, 256, ids(1 << 20, 1, 1), None),
                 ("user_ctx", V, 256, ids(V, 1, 8), weights(1, 8))],
                (4,))

    def lookups(spec, dtype, comb):
        """comb: one combiner for every group, or one per group"""
        groups, blocks = spec
        combs = [comb] * len(groups) if isinstance(comb, str) else comb
        return ([(table(name, V, D).to(dtype), i, w, c)
                 for (name, V, D, i, w), c in zip(groups, combs)], blocks)

    def case(label, spec, dtype, comb):
        look, blocks = lookups(spec, dtype, comb)
        before = K.launch_counts()["embedding_bag"]
        got = embedding_bag_group(look, blocks)
        check(K.launch_counts()["embedding_bag"] == before + 1,
              f"{label}: not one launch")
        want = embedding_bag_group_ref(look, blocks)
        err = 0.0
        for j, (g, w) in enumerate(zip(got, want)):
            err = max(err, compare(f"{label} block {j} {tuple(g.shape)}", g, w,
                                   TOL_BF16 if dtype == bf16 else TOL_F32))
        return look, blocks, err

    # each call's combiners on the path: sum everywhere but two-tower's
    # user_hist (mean)
    path = {}
    for label, make, on_path in (
            ("DIN micro-batch B=16 T=100", din_batch, "sum"),
            ("re-rank C=64 T=100", rerank, "sum"),
            ("two-tower user call D=256", towers_user,
             ("sum", "mean", "sum", "sum"))):
        spec = make()
        for dtype in (f32, bf16):
            for comb in dict.fromkeys(("sum", "mean", on_path)):
                look, blocks, err = case(
                    f"{label} {str(dtype)[6:]} "
                    f"{comb if isinstance(comb, str) else '/'.join(comb)}",
                    spec, dtype, comb)
                if dtype == f32 and comb == on_path:
                    path[label] = (look, blocks, err)
    # edges: a group of zero bags between others, 8 groups (the most a
    # launch takes) of mixed K and combiners, all-zero weights under mean
    for dtype in (f32, bf16):
        groups = [("e0", 1000, 18, ids(1000, 5, 3), None),
                  ("e1", 1000, 18, ids(1000, 0, 2), None),
                  ("e2", 1000, 18, ids(1000, 7, 1), weights(7, 1))]
        case(f"zero-bag group {str(dtype)[6:]}", (groups, (1, 1, 1)), dtype,
             "mean")
        groups = [(f"g{j}", 500 + j, 18, ids(500 + j, 9, 1 + j),
                   weights(9, 1 + j) if j % 2 else None) for j in range(8)]
        case(f"8 groups K=1..8 {str(dtype)[6:]}", (groups, (3, 5)), dtype,
             "mean")
        case(f"8 groups K=1..8 {str(dtype)[6:]} sum", (groups, None), dtype,
             "sum")
        zero = [("z0", 64, 18, ids(64, 4, 3),
                 torch.zeros((4, 3), device="cuda"))]
        _, _, err = case(f"all-zero weights {str(dtype)[6:]}", (zero, None),
                         dtype, "mean")
        check(err <= 1e-6, "an all-zero bag is not zero")

    floor = K.kernel("launch_floor", torch.device("cuda"))

    def empty():
        floor(torch.cuda.current_stream().cuda_stream)
    results["launch_floor"] = dict(ms=device_ms(empty))
    print(f"[3] launch floor (an empty kernel, CUDA graph replay): "
          f"{results['launch_floor']['ms']} ms", flush=True)
    for label, key in (("DIN micro-batch B=16 T=100", "embedding_bag"),
                       ("re-rank C=64 T=100", "embedding_bag@rerank"),
                       ("two-tower user call D=256", "embedding_bag@towers")):
        look, blocks, err = path[label]
        bms, by = bound_ms(bag_ops.cost(look))

        def per_field():
            outs = [embedding_bag(*g) for g in look]
            res, at = [], 0
            for n in blocks:
                res.append(outs[at] if n == 1
                           else torch.cat(outs[at:at + n], -1))
                at += n
            return res

        def library():
            return [F.embedding_bag(i, table_, mode=comb) for table_, i, _w,
                    comb in look]
        results[key] = dict(
            max_abs_err=err, bound_ms=bms, bound_by=by,
            shape=f"{label}, {len(look)} groups in one launch",
            per_field_ms=device_ms(per_field),
            **timings(lambda: embedding_bag_group(look, blocks),
                      lambda: embedding_bag_group_ref(look, blocks), library))
        print(f"  {label}: grouped launch {results[key]['ms']} ms, the "
              f"per-field plan ({len(look)} launches + concatenation) "
              f"{results[key]['per_field_ms']} ms, plain "
              f"{results[key]['plain_ms']} ms, F.embedding_bag over the "
              f"groups {results[key]['library_ms']} ms, bound {bms} ms "
              f"({by})", flush=True)
    tables.clear()
    torch.cuda.empty_cache()


def augru_checks(results: dict, rng, t):
    """B4 against its plain version: the reference's sweep and edge cells
    (3e-5), the zero-attention property, the design's edges (H = 1, H off
    the 4 x 28 split of U's rows, the largest H it holds, B = 1, B = 128,
    T = 1), and DIEN's path shapes (B=16 for a micro-batch, B=64 for a
    re-ranked request; T=100, Din=H=108), there beside a float64 plain
    version and split by kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.augru import augru, augru_ref
    from repro_torch.kernels.augru import ops as augru_ops

    print("[3] augru vs plain", flush=True)

    def case(B, T, Din, H, att, label, w_scale=0.3, u_scale=0.3, b_scale=0.1,
             x=None):
        args = (t(rng.normal(size=(B, T, Din)) if x is None else x), t(att),
                t(rng.normal(size=(Din, 3 * H)) * w_scale),
                t(rng.normal(size=(H, 3 * H)) * u_scale),
                t(rng.normal(size=(3 * H,)) * b_scale))
        out = augru(*args)
        return args, out, compare(label, out, augru_ref(*args), TOL_EDGE)

    for B, T, Din, H in [(8, 8, 8, 8), (16, 100, 18, 108), (4, 25, 12, 20)]:
        case(B, T, Din, H, rng.random((B, T)), f"B={B} T={T} Din={Din} H={H}")
    for B, T in [(1, 1), (1, 7), (4, 1)]:
        case(B, T, 6, 10, rng.random((B, T)), f"edge B={B} T={T}")
    _, out, _ = case(4, 12, 8, 8, np.zeros((4, 12)), "zero attention",
                     w_scale=1.0, u_scale=1.0, b_scale=0.0)
    check(float(out.abs().max()) <= 1e-7, "zero attention moved the state")
    from repro_torch.kernels.augru.ops import MAX_H
    for B, T, Din, H in [(3, 9, 5, 1), (4, 17, 10, 10), (2, 33, 20, 20),
                         (3, 40, 107, 107), (2, 20, 36, MAX_H), (1, 100, 108, 108),
                         (128, 30, 108, 108), (5, 1, 108, 108)]:
        case(B, T, Din, H, rng.random((B, T)),
             f"design edge B={B} T={T} Din={Din} H={H}")
    # the path: GRU states in (-1, 1), softmax attention over a history
    # with a padded tail, the model's 1/sqrt(fan-in) weights
    path = {}
    for B in (16, 64):
        T, H = 100, 108
        att = np.exp(rng.normal(size=(B, T)))
        att[:, 80:] = 0.0
        att /= att.sum(-1, keepdims=True)
        path[B] = case(B, T, H, H, att, f"DIEN path B={B} T={T} Din=H={H}",
                       w_scale=1 / np.sqrt(H), u_scale=1 / np.sqrt(H),
                       b_scale=0.0, x=np.tanh(rng.normal(size=(B, T, H))))
    for B in (16, 64):
        args, out, err = path[B]
        T, H = 100, 108
        plain = augru_ref(*args).double()
        want64 = augru_ref(*(a.double() for a in args))
        print(f"  DIEN path B={B}: kernel vs f64 plain "
              f"{float((out.double() - want64).abs().max()):.3e}, f32 plain "
              f"vs f64 plain {float((plain - want64).abs().max()):.3e}, max "
              f"|h| {float(want64.abs().max()):.3e}; launches (profiler, ms "
              f"per call): {launch_split(lambda: augru(*args))}", flush=True)
        bms, by = bound_ms(augru_ops.cost(*args))
        r = dict(max_abs_err=err, bound_ms=bms, bound_by=by,
                 shape=f"B={B} T=100 Din=H=108",
                 **timings(lambda: augru(*args), lambda: augru_ref(*args)))
        # the re-rank (B=C=64) is the path's most frequent launch
        results["augru" if B == 64 else "augru@B=16"] = r
        torch.cuda.empty_cache()


def candidate_scorer_checks(results: dict, rng, t):
    """B5 against its plain version: the reference's sweep cells in f32
    (2e-5 and equal index sets) and bf16 (2e-2), its edge cells, the full
    ranking k = C from one to four blocks, exact ties (lowest index first,
    within a block and across blocks, where distinct rows of the groups
    are ranked), the two-tower service shape (C=64, D=256, k=C; f32 and
    bf16), the recall shape (C=10^6, D=256, k=8), and C=1024 and 4096 at
    k=8 between them."""
    import numpy as np
    import torch
    from repro_torch.kernels.candidate_scorer import (candidate_scorer,
                                                      candidate_scorer_ref)
    from repro_torch.kernels.candidate_scorer import ops as scorer_ops

    print("[3] candidate_scorer vs plain", flush=True)

    def case(cands, q, k, label, dtype=torch.float32):
        c, qq = t(cands, dtype), t(q, dtype)
        v, i = candidate_scorer(c, qq, k)
        rv, ri = candidate_scorer_ref(c, qq, k)
        bf16 = dtype == torch.bfloat16
        err = compare(label, v, rv, TOL_BF16 if bf16 else TOL_F32)
        check(bool((v[:-1] >= v[1:]).all()), f"{label}: not best first")
        if not bf16:                   # bf16 near-ties may permute indices
            check(set(i.tolist()) == set(ri.tolist()),
                  f"{label}: index sets differ")
        return c, qq, err

    for C, D, k in [(4096, 64, 8), (1000, 16, 4), (300, 256, 8)]:
        for dtype in (torch.float32, torch.bfloat16):
            case(rng.normal(size=(C, D)), rng.normal(size=(D,)), k,
                 f"C={C} D={D} k={k} {str(dtype)[6:]}", dtype)
    for C, k in [(64, 1), (17, 4), (128, 128)]:
        case(rng.normal(size=(C, 16)), rng.normal(size=(16,)), k,
             f"edge C={C} k={k}")
    # the full ranking (k = C) across block sizes and block counts
    for C in (1, 17, 64, 1000, 1024, 1025, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            case(rng.normal(size=(C, 32)), rng.normal(size=(32,)), C,
                 f"k=C={C} D=32 {str(dtype)[6:]}", dtype)
    # exact ties: repeated rows score bit-for-bit alike; the kernel's
    # order is score descending, then index ascending, against the plain
    # version's scores (the groups lie far apart)
    for C, k, groups in ((64, 64, 16), (64, 10, 16), (1000, 1000, 40),
                         (1000, 37, 40), (1024, 100, 7)):
        base = rng.normal(size=(groups, 64))
        rows = base[rng.integers(0, groups, C)]
        c, qq = t(rows), t(rng.normal(size=(64,)))
        v, i = candidate_scorer(c, qq, k)
        plain = (c @ qq).cpu().numpy()
        want = np.lexsort((np.arange(C), -plain))[:k]
        compare(f"ties C={C} k={k} ({groups} distinct rows)", v,
                torch.as_tensor(plain[want]).to(v.device), TOL_F32)
        check(i.cpu().numpy().tolist() == want.tolist(),
              f"ties C={C} k={k}: indices differ from score-then-index "
              f"order")
    # exact ties across blocks (C > BLOCK_C): the values are held to the
    # plain version's, the indices to distinct rows of the right groups in
    # the right order, and among equal kernel scores to lower index first
    # (the merge keeps lax.top_k's order); cuBLAS's scores may differ from
    # the kernel's in the last bit, so the order is read off the kernel's
    for C, k, groups in ((2048, 64, 7), (4096, 200, 40)):
        base = rng.normal(size=(groups, 64))
        group = rng.integers(0, groups, C)
        c, qq = t(base[group]), t(rng.normal(size=(64,)))
        v, i = candidate_scorer(c, qq, k)
        plain = (c @ qq).cpu().numpy()
        want = np.lexsort((np.arange(C), -plain))[:k]
        label = f"ties across blocks C={C} k={k} ({groups} distinct rows)"
        compare(label, v, torch.as_tensor(plain[want]).to(v.device), TOL_F32)
        got, vals = i.cpu().numpy(), v.cpu().numpy()
        check(len(set(got.tolist())) == k
              and (group[got] == group[want]).all(),
              f"{label}: the indices are not distinct rows of the groups "
              f"ranked")
        tied = vals[1:] == vals[:-1]
        check(bool(tied.any()) and bool((got[1:][tied] > got[:-1][tied]).all()),
              f"{label}: equal kernel scores not in lower-index-first order")

    # non-finite and signed-zero scores: the query is the first unit
    # vector and each row's other entries +0, so a row's score is its
    # first entry exactly, in any summation order (a -0 entry scores +0,
    # a NaN of either sign the card's NaN); every row is ranked, -inf and
    # NaN included, in the floats' total order, lower index first among
    # equal scores, index for index with the plain version, never -1
    special = np.array([-np.inf, np.inf, np.nan, -np.nan, 0.0, -0.0, 1.0,
                        -1.0, 2.0], np.float32)
    for C, k, fill in ((64, 8, "mixed"), (64, 64, "mixed"),
                       (64, 8, "-inf"), (64, 64, "-inf"), (64, 8, "nan"),
                       (3000, 8, "mixed"), (3000, 8, "-inf"),
                       (3000, 64, "mixed"), (1025, 1025, "mixed")):
        first = (special[rng.integers(0, special.size, C)] if fill == "mixed"
                 else np.full(C, -np.inf if fill == "-inf" else np.nan,
                              np.float32))
        if fill != "mixed":                # a few finite rows among them
            first[rng.integers(0, C, 3)] = rng.normal(size=3)
        rows = np.zeros((C, 32), np.float32)
        rows[:, 0] = first
        q = np.zeros(32, np.float32)
        q[0] = 1.0
        c, qq = t(rows), t(q)
        v, i = candidate_scorer(c, qq, k)
        rv, ri = candidate_scorer_ref(c, qq, k)
        label = f"non-finite scores C={C} k={k} ({fill})"
        same_v = bool(((v == rv) | (torch.isnan(v) & torch.isnan(rv))).all())
        print(f"  {label}: indices equal {bool(torch.equal(i, ri))}, values "
              f"equal {same_v}, -1 among them {bool((i < 0).any())}",
              flush=True)
        check(bool((i >= 0).all()), f"{label}: index -1 returned")
        check(torch.equal(i, ri), f"{label}: indices differ from the plain "
              f"version's")
        check(same_v, f"{label}: values differ from the plain version's")

    def unit(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    case(unit(rng.normal(size=(64, 256))), unit(rng.normal(size=(256,))),
         64, "service C=64 D=256 k=64 bfloat16", torch.bfloat16)
    # the path shapes, and between them C of one and four blocks (no
    # path runs those; their times are a reading of the block plan)
    for C, k, key, where in ((64, 64, "candidate_scorer", "service"),
                             (1_000_000, 8, "candidate_scorer@C=1e6",
                              "recall"),
                             (1024, 8, "candidate_scorer@C=1024", "mid-range"),
                             (4096, 8, "candidate_scorer@C=4096", "mid-range")):
        D = 256
        c, qq, err = case(unit(rng.normal(size=(C, D))),
                          unit(rng.normal(size=(D,))), k,
                          f"{where} C={C} D={D} k={k}")
        bms, by = bound_ms(scorer_ops.cost(c, qq, k))
        results[key] = dict(
            max_abs_err=err, bound_ms=bms, bound_by=by,
            shape=f"C={C} D={D} k={k}",
            **timings(lambda: candidate_scorer(c, qq, k),
                      lambda: candidate_scorer_ref(c, qq, k),
                      lambda: torch.topk(torch.mv(c, qq), k)))
        del c
        torch.cuda.empty_cache()


def flash_decode_checks(results: dict, rng, t):
    """B6 against its plain version: the reference's sweep cells (2e-5
    f32, 2e-2 bf16) and edge cells (3e-5), then the path shapes: the LM
    service's (smollm-135m: B=4, S=64, H=3, G=3, D=64, f32, L=9 and 40),
    decode_32k at smollm's geometry (B=128, S=32768, L=32763, f32),
    long_500k at qwen3-8b's (B=1, S=524288, H=8, G=4, D=128, bf16,
    L=524283) and at smollm's (B=1, S=524288, L=524288, f32: phase
    10b's cell), starcoder2-7b's (B=8, S=4096, H=4, G=9, D=128, bf16,
    L=4001), and one rank's shard of [12] (a) (B=1, S=L=131,072, H=3,
    G=3, D=64, f32); beside them G=9 in f32, a bf16 serve-like shape at
    qwen3-8b's geometry, every bf16 head dim, and lengths at the plan's
    split boundaries. The library call is ``scaled_dot_product_attention`` on
    the valid prefix with ``enable_gqa``. Each path shape also runs with
    ``return_lse`` (the output and the lse against the plain version's,
    and its time beside the default call's) and at cache_len 0 (a mesh's
    empty sequence shard: out 0 and lse -1e30)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    from repro_torch.kernels.flash_decode import ops as decode_ops
    from repro_torch.kernels.flash_decode.ops import device_slots, split_plan

    print("[3] flash_decode vs plain", flush=True)
    f32, bf16 = torch.float32, torch.bfloat16

    def run(q, k, v, L, label, tol):
        """kernel vs plain; bf16 cells are also held to tol x max|want|
        (long averages put a bf16 output far below the absolute 2e-2)"""
        length = torch.tensor(L, dtype=torch.int32, device=q.device)
        got = flash_decode(q, k, v, length)
        want = flash_decode_ref(q, k, v, length)
        return length, want, compare(label, got, want, tol,
                                     tol if q.dtype == bf16 else None)

    for B, S, H, G, D, L in [(2, 128, 4, 3, 16, 100), (1, 256, 2, 1, 64, 256),
                             (4, 64, 8, 4, 32, 1)]:
        for dtype in (f32, bf16):
            q, k, v = (t(rng.normal(size=s), dtype)
                       for s in ((B, H, G, D), (B, S, H, D), (B, S, H, D)))
            run(q, k, v, L, f"B={B} S={S} H={H} G={G} D={D} L={L} "
                f"{str(dtype)[6:]}", TOL_BF16 if dtype == bf16 else TOL_F32)
    for B, S, L in [(1, 64, 1), (1, 32, 32), (3, 64, 1)]:
        q, k, v = (t(rng.normal(size=s))
                   for s in ((B, 2, 2, 16), (B, S, 2, 16), (B, S, 2, 16)))
        run(q, k, v, L, f"edge B={B} S={S} L={L}", TOL_EDGE)
    # G=9 at D=128 in float32 (starcoder2-7b's group off the tensor
    # cores), the bf16 serve-like shape at qwen3-8b's geometry, every head
    # dim and group of the bf16 path
    for B, S, H, G, D, L, dtype in [(2, 512, 4, 9, 128, 500, f32),
                                    (4, 64, 8, 4, 128, 40, bf16),
                                    (2, 300, 2, 9, 16, 257, bf16),
                                    (2, 300, 2, 16, 32, 299, bf16),
                                    (2, 200, 3, 3, 64, 131, bf16)]:
        q, k, v = (t(rng.normal(size=s), dtype)
                   for s in ((B, H, G, D), (B, S, H, D), (B, S, H, D)))
        run(q, k, v, L, f"B={B} S={S} H={H} G={G} D={D} L={L} "
            f"{str(dtype)[6:]}", TOL_BF16 if dtype == bf16 else TOL_F32)
    # lengths that end on, just before and just past a split boundary of
    # the plan this card gives the shape
    for B, S, H, G, D, dtype in [(1, 4096, 8, 4, 128, bf16),
                                 (2, 4096, 3, 3, 64, f32)]:
        slots = device_slots(torch.device("cuda"), dtype, G, D)
        chunk, n_split = split_plan(B, H, S, slots)
        check(n_split > 2, f"S={S}: the plan has {n_split} splits")
        q, k, v = (t(rng.normal(size=s), dtype)
                   for s in ((B, H, G, D), (B, S, H, D), (B, S, H, D)))
        for L in (chunk - 1, chunk, chunk + 1, 2 * chunk - 1, 2 * chunk,
                  2 * chunk + 1):
            run(q, k, v, L, f"split boundary B={B} S={S} H={H} G={G} D={D} "
                f"L={L} (chunk {chunk}, {n_split} splits, {slots} slots) "
                f"{str(dtype)[6:]}", TOL_BF16 if dtype == bf16 else TOL_F32)

    gen = torch.Generator("cuda").manual_seed(0)
    paths = [("flash_decode", "LM service (smollm-135m)", 4, 64, 3, 3, 64, 40,
              f32),
             ("flash_decode@L=9", "LM service (smollm-135m)", 4, 64, 3, 3, 64,
              9, f32),
             ("flash_decode@decode_32k", "decode_32k, smollm-135m geometry",
              128, 32768, 3, 3, 64, 32763, f32),
             ("flash_decode@long_500k", "long_500k, qwen3-8b geometry", 1,
              524288, 8, 4, 128, 524283, bf16),
             # [10b]'s smollm-135m x long_500k cell: the step writes row
             # S - 1, then reads all S rows
             ("flash_decode@long_500k_smollm",
              "long_500k, smollm-135m geometry ([10b]'s cell)", 1, 524288, 3,
              3, 64, 524288, f32),
             # [12] (a)'s call on each rank: its 131,072 rows of the cache,
             # all of them valid
             ("flash_decode@long_500k_smollm_rank",
              "long_500k, smollm-135m geometry, one rank of [12] (a)", 1,
              131072, 3, 3, 64, 131072, f32),
             ("flash_decode@starcoder2", "starcoder2-7b geometry", 8, 4096, 4,
              9, 128, 4001, bf16)]
    for key, where, B, S, H, G, D, L, dtype in paths:
        shape = (f"{where}: B={B} S={S} H={H} G={G} D={D} L={L} "
                 f"{str(dtype)[6:]}")
        q, k, v = (torch.randn(s, generator=gen, device="cuda", dtype=dtype)
                   for s in ((B, H, G, D), (B, S, H, D), (B, S, H, D)))
        slots = device_slots(q.device, dtype, G, D)
        chunk, n_split = split_plan(B, H, S, slots)
        shape += f" ({n_split} splits of {chunk} rows, {slots} slots)"
        length, want, err = run(q, k, v, L, shape,
                                TOL_BF16 if dtype == bf16 else TOL_F32)
        if dtype == bf16 and n_split > 1:
            _check_power(q, k, v, L, chunk, n_split, want, shape)

        def library():
            # (B, H*G, 1, D) queries against the valid prefix viewed as
            # (B, H, L, D); query head h*G+g reads kv head h
            return F.scaled_dot_product_attention(
                q.reshape(B, H * G, 1, D), k[:, :L].transpose(1, 2),
                v[:, :L].transpose(1, 2), enable_gqa=True)

        lib_err = float((library().reshape(B, H, G, D).float()
                         - flash_decode_ref(q, k, v, length).float())
                        .abs().max())
        print(f"  {shape}: library call vs plain max_abs_err={lib_err:.3e}",
              flush=True)
        # the mesh's call: the output and each row's log-sum-exp, and a
        # shard that holds no valid row (cache_len = 0): 0 and -1e30
        out, lse = flash_decode(q, k, v, length, return_lse=True)
        want_o, want_lse = flash_decode_ref(q, k, v, length, return_lse=True)
        compare(f"{shape}: return_lse out", out, want_o,
                TOL_BF16 if dtype == bf16 else TOL_F32,
                TOL_BF16 if dtype == bf16 else None)
        compare(f"{shape}: return_lse lse", lse, want_lse, TOL_F32)
        empty = torch.zeros((), dtype=torch.int32, device="cuda")
        for label, fn in (("kernel", flash_decode),
                          ("plain version", flash_decode_ref)):
            out, lse = fn(q, k, v, empty, return_lse=True)
            torch.cuda.synchronize()
            check(not out.float().any() and bool((lse == -1e30).all()),
                  f"{shape}: cache_len 0 gives the {label} out != 0 or "
                  f"lse != -1e30")
        print(f"  {shape}: cache_len 0: out 0, lse -1e30 (kernel and plain "
              f"version)", flush=True)
        bms, by = bound_ms(decode_ops.cost(q, k, v, L), str(dtype)[6:])
        results[key] = dict(
            max_abs_err=err, bound_ms=bms, bound_by=by, shape=shape,
            lse_ms=device_ms(lambda: flash_decode(q, k, v, length,
                                                  return_lse=True)),
            **timings(lambda: flash_decode(q, k, v, length),
                      lambda: flash_decode_ref(q, k, v, length), library))
        print(f"  {shape}: device ms per call {results[key]['ms']:.5f}, with "
              f"return_lse {results[key]['lse_ms']:.5f}, bound {bms:.5f} "
              f"({by})", flush=True)
        del q, k, v, out, lse, want_o, want_lse
        torch.cuda.empty_cache()


def mla_decode_checks(results: dict):
    """M1 (``kernels/mla_decode``; no Pallas original) against its plain
    float32 version, each case held to TOL_BF16 and TOL_BF16 x max|want|
    (the kernel rounds p and its output to bf16, the plain version
    neither): short and odd lengths (a row of length 0, 1, a tile's 63,
    64 and 65, rows shorter than a block's share, odd B and S, a row
    longer than 65,536) and the decode cell's shape (B = 32, S = 32,768,
    lengths 16,384 + 480 k, k < 32), with the rows counter at every valid
    row once. At the cell's shape the check's power (one block's share of
    a row's rows left out, and an all-zero output, must both fail), the
    launch split, and kernel / plain / bound times. Then one decode step
    of DeepSeek-V2-Lite at its published widths cut to 4 layers, on
    per-row lengths, with M1's launches counted from 0 (one a layer, B6
    none) and its logits against the same step through the plain
    absorbed path on the card, reported; then the same 4 layers with
    dense FFNs, whose bf16 logits through M1 are held to at most
    BF16_ERR_RATIO times the plain path's RMS error against float32."""
    import dataclasses
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs.lm_archs import DEEPSEEK_V2_LITE
    from repro_torch.kernels.mla_decode import (mla_decode, mla_decode_ref,
                                                rows_read)
    from repro_torch.kernels.mla_decode import ops as mla_ops
    from repro_torch.models import attention, moe, transformer

    print("[3] mla_decode vs plain", flush=True)
    gen = torch.Generator("cuda").manual_seed(3)
    scale = 0.1147

    def inputs(B, S, lens):
        def draw(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        return (draw(B, mla_ops.HEADS, mla_ops.LATENT),
                draw(B, mla_ops.HEADS, mla_ops.ROPE),
                draw(B, S, mla_ops.LATENT), draw(B, S, mla_ops.ROPE),
                torch.tensor(lens, dtype=torch.int32, device="cuda"), scale)

    def case(B, S, lens, label):
        args = inputs(B, S, lens)
        got, want = mla_decode(*args), mla_decode_ref(*args)
        err = compare(f"{label}: B={B} S={S}", got, want, TOL_BF16, TOL_BF16)
        for b, n in enumerate(lens):
            if n == 0:
                check(not got[b].float().any(), f"{label}: a row of length 0 "
                      f"gives non-zero output")
        rows = rows_read(*args)
        check(rows == sum(min(max(n, 0), S) for n in lens),
              f"{label}: the kernel read {rows} rows of {sum(lens)} valid")
        return args, want, err

    for B, S, lens, label in [
            (4, 256, [1, 63, 64, 65], "tile edges"),
            (4, 256, [0, 1, 200, 256], "a row of length 0, a full row"),
            (1, 64, [1], "one row of one"),
            (5, 300, [300, 0, 0, 17, 129], "odd B and S"),
            (40, 512, list(range(1, 513, 13))[:40], "rows under a block's "
                                                    "share"),
            (2, 70000, [69999, 1], "a row past 65,536")]:
        case(B, S, lens, label)
        torch.cuda.empty_cache()
    lens = [16384 + 480 * k for k in range(32)]
    shape = ("decode cell: B=32 S=32768, lengths 16,384-31,264 (762,304 "
             "rows), bf16, 16 heads, 512 + 64")
    args, want, err = case(32, 32768, lens, shape)
    share = sum(lens) // mla_ops.blocks(torch.device("cuda"))
    cut = args[4].clone()
    cut[0] -= share
    bad_args = args[:4] + (cut, scale)
    for label, bad in ((f"one block's share ({share} rows) of row 0 left out",
                        mla_decode_ref(*bad_args)),
                       ("all-zero output", torch.zeros_like(want))):
        e, used, ok = verdict(bad, want, TOL_BF16, TOL_BF16)
        print(f"  {shape}: check power, {label}: max_abs_err={e:.3e}, "
              f"allowance used {used:.3f}, {'passes' if ok else 'rejected'}",
              flush=True)
        check(not ok, f"{shape}: the check passes an output with {label}")
    split = launch_split(lambda: mla_decode(*args))
    print(f"  {shape}: launches (profiler, ms per call): {split}", flush=True)
    bms, by = bound_ms(mla_ops.cost(32, sum(lens)), "bfloat16")
    r = dict(max_abs_err=err, bound_ms=bms, bound_by=by, shape=shape,
             **timings(lambda: mla_decode(*args),
                       lambda: mla_decode_ref(*args)))
    print(f"  {shape}: device ms per call {r['ms']:.5f}, plain "
          f"{r['plain_ms']:.5f}, bound {bms:.5f} ({by}): "
          f"{100 * bms / r['ms']:.1f}% of the bound", flush=True)
    del args, want, bad_args
    torch.cuda.empty_cache()

    length = torch.tensor([0, 63, 64, 200], dtype=torch.int32,
                          device="cuda")
    toks = torch.tensor([[5], [17], [1000], [99999]], device="cuda")

    def step(cfg, params, kernel: bool):
        """(logits as float32 numpy, each MoE layer's expert ids, launches)
        of one decode step of ``cfg`` at ``length``, through M1 or the
        plain absorbed path, on a cache drawn alike for every call."""
        dt = getattr(torch, cfg.param_dtype)
        cache = transformer.KVCache.zeros(cfg, 4, 256, "cuda")
        cache.a.copy_(torch.randn(cache.a.shape, device="cuda",
                                  generator=torch.Generator(
                                      "cuda").manual_seed(4)).to(torch.bfloat16))
        cache.b.copy_(torch.randn(cache.b.shape, device="cuda",
                                  generator=torch.Generator(
                                      "cuda").manual_seed(5)).to(torch.bfloat16))
        check(cache.a.dtype == dt, f"cache {cache.a.dtype}, expected {dt}")
        takes = attention.mla_kernel_takes
        if not kernel:
            attention.mla_kernel_takes = lambda *a: False
        try:
            K.reset_launches()              # counts from here are the step's
            with moe.recording() as routed:
                logits, _ = transformer.decode_step(
                    params, cache._replace(length=length), toks, cfg)
            counts = K.launch_counts()
        finally:
            attention.mla_kernel_takes = takes
        return (logits.float().cpu().numpy(), [x.ids for x in routed],
                counts)

    def weights(cfg):
        return transformer.init(torch.Generator("cuda").manual_seed(0), cfg,
                                "cuda")

    # the published layers: M1 once a layer. Their bf16 logits are reported,
    # not held: a bf16 near-tie in a router sends a token to another expert
    # under the two paths, and one bf16 ulp of noise on the attention's
    # output moves these logits by 3-4x TOL_BF16 (they are bf16 themselves,
    # ~0.03 apart at 4)
    cfg = dataclasses.replace(DEEPSEEK_V2_LITE, n_layers=4)
    params = weights(cfg)
    got, got_ids, counts = step(cfg, params, kernel=True)
    print(f"  decode step, DeepSeek-V2-Lite widths, {cfg.n_layers} layers, "
          f"B=4 at lengths {length.tolist()}: launches {counts}", flush=True)
    check(counts["mla_decode"] == cfg.n_layers and counts["flash_decode"] == 0,
          f"mla_decode launches {counts['mla_decode']}, expected one a layer "
          f"({cfg.n_layers}), flash_decode none")
    plain, plain_ids, _ = step(cfg, params, kernel=False)
    alike = [bool((torch.stack([a.sort(-1).values == b.sort(-1).values
                                for a, b in zip(got_ids, plain_ids)])
                   .all(-1).all(0))[t]) for t in range(len(toks))]
    print(f"  decode step logits vs the plain absorbed path: max_abs_diff "
          f"{float(abs(got - plain).max()):.3e} (max|want| "
          f"{float(abs(plain).max()):.3e}), rows routed alike in all "
          f"{len(got_ids)} MoE layers {alike} (a bf16 MoE: reported, not "
          f"held)", flush=True)
    del params
    # the same 4 layers with dense FFNs (no router to part the paths): the
    # kernel's step and the plain path's, both in bf16, against the plain
    # path in float32 on the same bf16 weights and cache; M1's RMS error at
    # most BF16_ERR_RATIO times the plain path's (it rounds in other
    # places, not more often)
    dense = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_dense_layers=cfg.n_layers))
    params = weights(dense)
    got, _, counts = step(dense, params, kernel=True)
    check(counts["mla_decode"] == cfg.n_layers,
          f"mla_decode launches {counts['mla_decode']} in the dense cut")
    plain, _, _ = step(dense, params, kernel=False)
    f32 = dataclasses.replace(dense, param_dtype="float32")
    from repro_torch.tree import tree_map
    want, _, _ = step(f32, tree_map(lambda t: t.float(), params),
                      kernel=False)
    e_kernel, e_plain = _rel_err(got, want), _rel_err(plain, want)
    ok = e_kernel <= BF16_ERR_RATIO * e_plain
    print(f"  decode step logits, {cfg.n_layers} dense layers, RMS error "
          f"against float32: M1 {e_kernel:.4e}, the plain absorbed path "
          f"{e_plain:.4e}, ratio {e_kernel / e_plain:.3f} (at most "
          f"{BF16_ERR_RATIO:g}) {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"decode step: M1's bf16 error {e_kernel:.4e} against float32 "
          f"is more than {BF16_ERR_RATIO:g} x the plain path's {e_plain:.4e}")
    del params
    r["launches"] = counts["mla_decode"]
    results["mla_decode"] = r
    torch.cuda.empty_cache()


def _check_power(q, k, v, L, chunk, n_split, want, shape):
    """The bf16 check's power at a path shape: the plain version with the
    keys of one split left out (what a kernel that lost a split's
    partials would give), and an all-zero output, must both fail the
    check the kernel passed."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode_ref
    s = n_split // 2
    a, b = s * chunk, min((s + 1) * chunk, L)
    rest = torch.tensor(L - (b - a), dtype=torch.int32, device=q.device)
    dropped = flash_decode_ref(q, torch.cat((k[:, :a], k[:, b:L]), 1),
                               torch.cat((v[:, :a], v[:, b:L]), 1), rest)
    for label, bad in ((f"split {s} of {n_split} (rows {a}-{b}) left out",
                        dropped), ("all-zero output", torch.zeros_like(want))):
        err, used, ok = verdict(bad, want, TOL_BF16, TOL_BF16)
        alone = verdict(bad, want, TOL_BF16)[2]
        print(f"  {shape}: check power, {label}: max_abs_err={err:.3e}, "
              f"allowance used {used:.3f}, {'passes' if ok else 'rejected'} "
              f"(rtol=atol alone: {'passes' if alone else 'rejected'})",
              flush=True)
        check(not ok, f"{shape}: the check passes an output with {label}")
    del dropped


# ------------------------------------------------------------------ phase 4

def _to(tree, dev):
    """A tree of dicts / lists of tensors (or numpy ids) on ``dev``; ids as
    int64."""
    import torch
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    t = torch.as_tensor(tree)
    return (t if t.is_floating_point() else t.long()).to(dev)


def _vocab(cfg, rows):
    """``cfg`` with every table cut to at most ``rows`` rows."""
    import dataclasses

    def cut(f):
        return dataclasses.replace(f, vocab=min(f.vocab, rows))
    return dataclasses.replace(cfg, user_fields=tuple(map(cut, cfg.user_fields)),
                               item_fields=tuple(map(cut, cfg.item_fields)))


def model_check():
    """Each recsys model at its published widths (every table cut to 2^16
    rows for this phase only): the card through the kernels against the
    same weights on the CPU through the plain versions."""
    import numpy as np
    import torch
    from repro_torch.configs.other_archs import DIEN, DIN, MIND, TWO_TOWER
    from repro_torch.data import synthetic
    from repro_torch.models.recsys import dien, din, mind, towers
    from repro_torch.serve.bucketing import (ShapeBucketer, compact_history,
                                             step_buckets)

    rng = np.random.default_rng(0)
    C = 64
    models = (
        (din, DIN, "D=18, T=100, attn 80-40, mlp 200-80", "score_candidates"),
        (dien, DIEN, "D=18, T=100, GRU/AUGRU 108, mlp 200-80",
         "score_candidates"),
        (mind, MIND, "D=64, K=4, 3 routing iterations, T=50, mlp 256-64",
         "retrieve"),
        (towers, TWO_TOWER, "D=256, towers 1024-512-256", "retrieve"))
    for mod, published, widths, rank_fn in models:
        cfg = _vocab(published, 1 << 16)
        name = cfg.name
        print(f"[4] {name} at published widths ({widths}), vocab 2^16: card "
              f"(kernels) vs CPU (plain versions), tol {TOL_MODEL:g}",
              flush=True)
        params_cpu = mod.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
        params_gpu = _to(params_cpu, "cuda")
        raw = synthetic.recsys_batch(rng, cfg, 16)
        compare(f"{name} serve_scores B=16",
                mod.serve_scores(params_gpu, _to(raw, "cuda"), cfg).cpu(),
                mod.serve_scores(params_cpu, _to(raw, "cpu"), cfg), TOL_MODEL)

        user = {"fields": {f.name: rng.integers(0, f.vocab, (1,) if f.bag == 1
                                                else (1, f.bag))
                           for f in cfg.user_fields}}
        if cfg.seq_len:
            hist = np.full(cfg.seq_len, -1, np.int64)
            n = cfg.seq_len * 4 // 5
            hist[:n] = rng.integers(0, cfg.item_fields[0].vocab, n)
            user["hist"] = compact_history(
                hist, ShapeBucketer(step_buckets(cfg.seq_len)))[None]
        cand = {f.name: rng.integers(0, f.vocab, (C,) if f.bag == 1
                                     else (C, f.bag))
                for f in cfg.item_fields}
        # distinct candidates, so the ranking is strict
        cand["item_id"] = rng.permutation(cfg.item_fields[0].vocab)[:C]

        def dense(params, dev, **kw):
            u = _to(user, dev)
            if cfg.model == "two_tower":        # the bare user-fields dict
                u = u["fields"]
            v, i = getattr(mod, rank_fn)(params, u, _to(cand, dev), cfg,
                                         top_k=C, **kw)
            out = torch.empty(C)
            out[i.cpu()] = v.cpu().float()
            return out

        got = dense(params_gpu, "cuda")
        compare(f"{name} {rank_fn} C={C} card vs CPU", got,
                dense(params_cpu, "cpu"), TOL_MODEL)
        if mod is din:
            compare("din score_candidates fused vs broadcast (jnp) path, "
                    "both on card", got, dense(params_gpu, "cuda", path="jnp"),
                    TOL_MODEL)
        del params_gpu
        torch.cuda.empty_cache()


# ---------------------------------------------------------- phases 5 and 6

def _span(rep):
    """The served span of a wave: first request in to last answer out (the
    executor's makespan adds its 0.2 s drain poll)."""
    return (max(ev.done_at for ev in rep.results)
            - min(ev.born_at for ev in rep.results))


def _stat(rep, stage, attr):
    """A stage's stat in a report (0 when the stage saw no event)."""
    st = rep.stage_stats.get(stage)
    return 0 if st is None else getattr(st, attr)


def _stage_line(rep):
    return ", ".join(f"{name} {st.busy_s:.6f}"
                     for name, st in rep.stage_stats.items())


def _launch_expectation(reports) -> dict:
    """B1-B3 launches the DIN path's rerank stage stats imply: one grouped
    embedding_bag and one din_attention per micro-batch, one grouped
    embedding_bag and one rerank_score per re-ranked request."""
    batches = sum(r.stage_stats["rerank"].batches for r in reports)
    reranked = sum(r.stage_stats["rerank"].events for r in reports)
    return dict(embedding_bag=batches + reranked, din_attention=batches,
                rerank_score=reranked)


def service_run() -> dict:
    """Phase 5: the DIN re-rank InferenceService at published widths,
    user_id / item_id cut to 2^20 rows (DIN runs at its full 2^26 rows in
    phase 6). Returns this phase's launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs.other_archs import DIN
    from repro_torch.core.executors import AsyncExecutor
    from repro_torch.core.service import InferenceService, ServiceConfig

    cfg = _vocab(DIN, 1 << DIN_SERVICE_VOCAB_LOG2)
    vocab = {f.name: f.vocab for f in cfg.user_fields + cfg.item_fields}
    print(f"[5] service: DIN at published widths, tables {vocab} (user_id/"
          f"item_id cut from 2^26 to 2^{DIN_SERVICE_VOCAB_LOG2})", flush=True)
    t0 = time.perf_counter()
    svc = InferenceService(ServiceConfig(arch_id="din", batch_size=16),
                           device="cuda", model_cfg=cfg)
    torch.cuda.synchronize()
    print(f"[5] service build: {time.perf_counter() - t0} s", flush=True)
    check(svc.device.type == "cuda", "service did not land on the card")

    waves = []
    K.reset_launches()                      # counts from here are the path's
    for wave in range(2):
        reqs = svc.make_requests(N_REQUESTS, seed=wave)
        waves.append(AsyncExecutor(svc.plan).run(reqs))
    counts = K.launch_counts()

    for wave, rep in enumerate(waves):
        check(rep.errors == 0, f"wave {wave}: {rep.errors} stage errors")
        check(rep.completed == N_REQUESTS and len(rep.results) == N_REQUESTS,
              f"wave {wave}: {rep.completed}/{N_REQUESTS} answered")
        for ev in rep.results:
            _check_rerank_answer(ev.meta.get("response"))
        st = rep.stage_stats["rerank"]
        print(f"[5] wave {wave} ({'cold' if wave == 0 else 'warm'}): "
              f"p50 {rep.latency_percentile(0.5) * 1e3} ms, p99 "
              f"{rep.latency_percentile(0.99) * 1e3} ms, served span "
              f"{_span(rep)} s, rerank micro-batches {st.batches}, "
              f"re-ranked {st.events}; stage busy s: {_stage_line(rep)}",
              flush=True)
    expected = dict.fromkeys(K.LAUNCHES, 0)
    expected.update(_launch_expectation(waves))
    print(f"[5] launches {counts}, expected {expected} (per micro-batch 1 "
          f"grouped embedding_bag + 1 din_attention; per re-ranked request "
          f"1 grouped embedding_bag + 1 rerank_score)", flush=True)
    check(all(counts[k] > 0 for k in ("embedding_bag", "din_attention",
                                      "rerank_score")),
          "a kernel of the DIN path was never launched")
    check(counts == expected, "launch counts differ from the path's calls")
    del svc, waves
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _check_rerank_answer(r):
    check(r is not None and not r.timed_out, "request not answered")
    check(r.score is not None and math.isfinite(r.score)
          and 0.0 <= r.score <= 1.0, f"bad score {r.score}")
    if not r.from_cache:
        check(bool(r.topk), f"request {r.req_id}: no topk")
        check(all(math.isfinite(s) and 0.0 <= s <= 1.0 for _i, s in r.topk),
              "bad topk score")


def _check_retrieval_answer(r):
    """A non-empty top-k whose raw scores (the answer carries their
    sigmoid) are dot products of l2-normalised vectors: in [-1, 1]."""
    check(r is not None and not r.timed_out, "request not answered")
    check(bool(r.topk), f"request {r.req_id}: no topk")
    for _i, s in r.topk:
        check(math.isfinite(s) and 0.0 < s < 1.0, f"bad topk score {s}")
        raw = math.log(s / (1.0 - s))
        check(-1.0 - 1e-5 <= raw <= 1.0 + 1e-5,
              f"retrieval score {raw} outside [-1, 1]")


#: launches per micro-batch (serve_scores) and per ranked request
#: (score_candidates / retrieve) of each scenario's model
PER_BATCH = {"din-rerank": {"embedding_bag": 1, "din_attention": 1},
             "dien-rerank": {"embedding_bag": 1, "augru": 1},
             "mind-retrieval": {}, "towers-retrieval": {}}
PER_REQUEST = {"din-rerank": {"embedding_bag": 1, "rerank_score": 1},
               "dien-rerank": {"embedding_bag": 1, "augru": 1},
               "mind-retrieval": {"embedding_bag": 1},
               "towers-retrieval": {"embedding_bag": 1,
                                    "candidate_scorer": 1}}
RECSYS_KERNELS = ("embedding_bag", "din_attention", "rerank_score", "augru",
                  "candidate_scorer")


def multi_service_run() -> dict:
    """Phase 6: MultiScenarioService with DIN, DIEN, MIND and two-tower on
    the card at published widths; DIN, DIEN and MIND at their published
    2^26-row vocabularies, two-tower's tables capped at 2^21 rows. Returns
    this phase's launch counts (the kernel table's)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs.other_archs import DIEN, DIN, MIND, TWO_TOWER
    from repro_torch.core.executors import AsyncExecutor
    from repro_torch.core.service import (MultiScenarioService,
                                          MultiServiceConfig)

    names = ("din-rerank", "dien-rerank", "mind-retrieval", "towers-retrieval")
    towers_cfg = _vocab(TWO_TOWER, 1 << TOWERS_VOCAB_LOG2)
    cut = {f.name: f"2^{int(math.log2(f.vocab))} -> 2^{TOWERS_VOCAB_LOG2}"
           for f in TWO_TOWER.user_fields + TWO_TOWER.item_fields
           if f.vocab > 1 << TOWERS_VOCAB_LOG2}
    model_cfgs = dict(zip(names, (DIN, DIEN, MIND, towers_cfg)))
    gib = {n: sum(f.vocab for f in c.user_fields + c.item_fields)
           * c.embed_dim * 4 / 2**30 for n, c in model_cfgs.items()}
    print(f"[6] multi-scenario service {names} at published widths; tables "
          f"GiB {gib}; two-tower tables capped at 2^{TOWERS_VOCAB_LOG2} rows "
          f"(published rows x 256 x 4 B is ~500 GiB): {cut}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = MultiScenarioService(MultiServiceConfig(scenarios=names),
                               device="cuda", model_cfgs=model_cfgs)
    torch.cuda.synchronize()
    print(f"[6] service build (tables on the card, host cube, pruning-DNN "
          f"fit): {time.perf_counter() - t0} s; cube groups "
          f"{sorted(svc.substrate.groups)}", flush=True)
    check(svc.device.type == "cuda", "service did not land on the card")

    waves = []
    K.reset_launches()                      # counts from here are the path's
    for wave in range(2):
        reqs = svc.make_requests(N_REQUESTS, seed=wave)
        waves.append(AsyncExecutor(svc.plan).run(reqs))
    counts = K.launch_counts()

    expected = dict.fromkeys(K.LAUNCHES, 0)
    for wave, rep in enumerate(waves):
        # the gate withholds priority-1 clones once the quota falls below
        # min_quota; the check below fails if it drops any
        shed_clones = sum(len(ev.meta.get("tenants_shed", ()))
                          for ev in rep.results)
        print(f"[6] wave {wave} ({'cold' if wave == 0 else 'warm'}): "
              f"served span {_span(rep)} s, clones shed by the fanout's "
              f"quota gate: {shed_clones}", flush=True)
        check(rep.errors == 0, f"wave {wave}: {rep.errors} stage errors")
        by = svc.by_scenario(rep)
        for name in names:
            evs = by.get(name, [])
            check(len(evs) == N_REQUESTS and len({ev.req_id for ev in evs})
                  == N_REQUESTS,
                  f"wave {wave}: {name} answered {len(evs)}/{N_REQUESTS}")
            retrieval = name.endswith("retrieval")
            for ev in evs:
                r = ev.meta.get("response")
                (_check_retrieval_answer if retrieval
                 else _check_rerank_answer)(r)
            term = svc.terminals[name]
            batches = _stat(rep, term, "batches")
            ranked = _stat(rep, term, "events")
            for k, n in PER_BATCH[name].items():
                expected[k] += n * batches
            for k, n in PER_REQUEST[name].items():
                expected[k] += n * ranked
            lat = np.asarray([ev.done_at - ev.born_at for ev in evs])
            busy = {st: _stat(rep, st, "busy_s")
                    for st in svc.plan.stages if st.startswith(name + ".")}
            launches = {k: n * batches for k, n in PER_BATCH[name].items()}
            for k, n in PER_REQUEST[name].items():
                launches[k] = launches.get(k, 0) + n * ranked
            print(f"[6] wave {wave} {name}: p50 "
                  f"{np.percentile(lat, 50) * 1e3} ms, p99 "
                  f"{np.percentile(lat, 99) * 1e3} ms (n={lat.size}); "
                  f"{term} batches {batches}, ranked {ranked}; launches "
                  f"{launches}; stage busy s "
                  + ", ".join(f"{k.split('.', 1)[1]} {v:.6f}"
                              for k, v in busy.items()), flush=True)
    print(f"[6] launches {counts}, expected from the stage stats {expected}",
          flush=True)
    check(all(counts[k] > 0 for k in RECSYS_KERNELS),
          "a kernel of the path was never launched")
    check(counts == expected, "launch counts differ from the path's calls")
    print(f"[6] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30} GiB", flush=True)
    del svc, waves
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def lm_service_run() -> int:
    """Phase 7: the LM decode service (serve_lm) for smollm-135m at its
    published widths on the card, weights from a seeded generator there;
    then the same weights on the CPU against the card over the prefill and
    8 teacher-forced decode steps. Returns flash_decode's launch count of
    the service run."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs.lm_archs import SMOLLM_135M as cfg
    from repro_torch.launch.serve import PROMPT_LEN, S_MAX, serve_lm
    from repro_torch.models import transformer

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[7] LM decode service: {cfg.name} at published widths "
          f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv} kv heads, d_head {cfg.d_head}, ff {cfg.d_ff} GLU, "
          f"vocab {cfg.vocab}, {cfg.param_dtype})", flush=True)
    t0 = time.perf_counter()
    params = transformer.init(torch.Generator("cuda").manual_seed(0), cfg,
                              "cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[7] {n_params} parameters drawn on the card in "
          f"{time.perf_counter() - t0} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    weights = sum(x.numel() * x.element_size() for x in _leaves(params))
    print(f"[7] allocated before serving "
          f"{torch.cuda.memory_allocated() / 2**30} GiB (weights "
          f"{weights / 2**30} GiB)", flush=True)

    K.reset_launches()                      # counts from here are the path's
    fig = serve_lm(argparse.Namespace(arch=cfg.name, requests=6,
                                      reduced=False),
                   params=params, device="cuda")
    counts = K.launch_counts()
    print(f"[7] decoded steps {fig['steps']}, {fig['ms_per_step']} ms/step, "
          f"{fig['tokens']} tokens at {fig['tokens_per_s']} tokens/s, slot "
          f"utilization {fig['utilization']}, completed {fig['completed']}/6;"
          f" launches {counts} (expected flash_decode {cfg.n_layers} x "
          f"{fig['steps']}); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30} GiB", flush=True)
    check(fig["completed"] == 6, "not every request completed")
    check(counts["flash_decode"] == cfg.n_layers * fig["steps"] > 0,
          "flash_decode launches differ from layers x decode steps")
    check(all(counts[k] == 0 for k in RECSYS_KERNELS),
          "the LM path launched a recsys kernel")

    print(f"[7] card vs CPU, same weights: prefill + 8 teacher-forced decode "
          f"steps, tol {TOL_LM:g}", flush=True)
    params_cpu = _to(params, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab,
                                             (4, PROMPT_LEN + 8))
    tg, tc = torch.as_tensor(toks, device="cuda"), torch.as_tensor(toks)

    def greedy(lg, lc, label):
        """Token ids equal wherever the CPU's top-2 margin exceeds the
        tolerance."""
        top2 = lc.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > TOL_LM
        same = lg.cpu().argmax(-1) == lc.argmax(-1)
        check(bool(same[sure].all()), f"{label}: greedy ids differ")
        return int(sure.sum())

    lg, cg = transformer.prefill(params, tg[:, :PROMPT_LEN], cfg, smax=S_MAX)
    lc, cc = transformer.prefill(params_cpu, tc[:, :PROMPT_LEN], cfg,
                                 smax=S_MAX)
    compare("prefill logits", lg.cpu(), lc, TOL_LM)
    sure = greedy(lg, lc, "prefill")
    for step in range(8):
        at = slice(PROMPT_LEN + step, PROMPT_LEN + step + 1)
        lg, cg = transformer.decode_step(params, cg, tg[:, at], cfg)
        lc, cc = transformer.decode_step(params_cpu, cc, tc[:, at], cfg)
        compare(f"decode step {step} logits", lg.cpu(), lc, TOL_LM)
        sure += greedy(lg, lc, f"decode step {step}")
    compare("cache K", cg.a.cpu(), cc.a, TOL_LM)
    compare("cache V", cg.b.cpu(), cc.b, TOL_LM)
    check(int(cg.length) == int(cc.length) == PROMPT_LEN + 8,
          "cache lengths differ")
    print(f"[7] greedy ids equal at {sure} of {4 * 9} positions with a "
          f"top-2 margin above {TOL_LM:g}", flush=True)
    # the device's share of a served step: one decode step replayed from a
    # CUDA graph (no host in the loop) against the host-driven loop above
    step_ms = device_ms(lambda: transformer.decode_step(
        params, cg, tg[:, -1:], cfg), iters=5, replays=4)
    print(f"[7] decode step B=4 at length {PROMPT_LEN + 8}: device time "
          f"{step_ms} ms (CUDA graph replay) against {fig['ms_per_step']} "
          f"ms/step host-driven: device idle share "
          f"{1 - step_ms / fig['ms_per_step']}", flush=True)
    prof = _profile_step(
        lambda: transformer.decode_step(params, cg, tg[:, -1:], cfg))
    print(f"[7] profiler, one eager decode step: {prof['launches']} kernel "
          f"launch calls, {prof['device_events']} device events, busy "
          f"{prof['device_busy_s'] * 1e3} ms; largest: " + "; ".join(
              f"{n[:70]} x{c} {s * 1e3} ms" for n, c, s in prof["top"]),
          flush=True)
    del params, params_cpu, cg, cc
    gc.collect()
    torch.cuda.empty_cache()
    return counts["flash_decode"]


def _profile_step(step, warm=False) -> dict:
    """One call of ``step`` (after a warm-up call if ``warm``) under
    torch.profiler: its wall (s), the device's busy time (s: the device
    events' durations summed, read from the raw trace, as building
    ``key_averages`` over an LM train step's ~84,000 kernels took 15.5 s)
    and idle share, its device events and kernel launch calls, and the six
    largest device operations as (name, count, s). A pass that comes back
    without device events (it happens on a short step) is repeated, up to
    three calls; a step with no device time fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        step()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name, launches = {}, 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                n, ns = by_name.get(e.name(), (0, 0))
                by_name[e.name()] = (n + 1, ns + e.duration_ns())
            elif e.name().startswith(("cudaLaunch", "cuLaunch")):
                launches += 1
        if by_name:
            break
    busy = sum(ns for _, ns in by_name.values()) / 1e9
    check(busy > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "device_events": sum(n for n, _ in by_name.values()),
            "launches": launches,
            "top": [(name, n, ns / 1e9) for name, (n, ns) in top]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ------------------------------------------------------------------ phase 8

HEAD_SLOTS = 65536                # phase 8's HBM head, in cube rows


def _wave(svc, seed, n=N_REQUESTS):
    """One wave of ``n`` requests on the AsyncExecutor, every answer
    checked. Returns (report, the requests in order)."""
    from repro_torch.core.executors import AsyncExecutor
    reqs = svc.make_requests(n, seed=seed)
    rep = AsyncExecutor(svc.plan).run(reqs)
    check(rep.errors == 0, f"{rep.errors} stage errors")
    check(rep.completed == n and len(rep.results) == n,
          f"{rep.completed}/{n} answered")
    for ev in rep.results:
        _check_rerank_answer(ev.meta.get("response"))
    return rep, reqs


def _wave_line(label, rep):
    print(f"[8] {label}: p50 {rep.latency_percentile(0.5) * 1e3} ms, p99 "
          f"{rep.latency_percentile(0.99) * 1e3} ms", flush=True)


def _touched(rep) -> dict:
    """Cube group -> the hashed ids the wave's requests fetched (group 0
    item_id, group 1 item_cat)."""
    import numpy as np
    return {g: np.unique([int(ev.payload["hashed"][f]) for ev in rep.results])
            for g, f in ((0, "item_id"), (1, "item_cat"))}


def _emit(emitter, keys: dict, rng, n=32):
    """One delta version: new rows for up to ``n`` of each group's keys."""
    import numpy as np
    from repro_torch.update import GroupDelta
    groups = []
    for g, ids in keys.items():
        if not ids.size:
            continue
        ids = rng.choice(ids, min(n, ids.size), replace=False)
        groups.append(GroupDelta(group=g, ids=ids, rows=rng.standard_normal(
            (ids.size, 4)).astype(np.float32)))
    return emitter.emit(groups).version


def _scores(rep, reqs) -> list:
    by = {ev.req_id: ev.meta["response"].score for ev in rep.results}
    return [by[ev.req_id] for ev in reqs]


def _cube_rows(svc, keys: dict) -> dict:
    return {g: svc.cube.lookup_ex(g, ids) for g, ids in keys.items()}


def durability_run() -> dict:
    """Phase 8: the update, durability and scale-out planes of the DIN
    service on the card, at phase 5's widths. (a) an HBM head of
    ``HEAD_SLOTS`` rows on the card, live deltas applied by the watcher
    (promotions, in-place updates), periodic snapshots, a graceful
    shutdown's final snapshot; (b) recovery from it with no delta suffix,
    then with two versions to replay; (c) the recsys launcher with every
    telemetry flag, then with --recover. Returns this phase's launches."""
    import signal

    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs.other_archs import DIN
    from repro_torch.core.service import InferenceService, ServiceConfig
    from repro_torch.launch.serve import serve_recsys
    from repro_torch.sparse.hashing import signature_np
    from repro_torch.update import DeltaEmitter

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = _vocab(DIN, 1 << DIN_SERVICE_VOCAB_LOG2)
    root = tempfile.mkdtemp(prefix="durability_")
    upd, snaps = os.path.join(root, "log"), os.path.join(root, "snaps")
    os.makedirs(upd)
    knobs = dict(arch_id="din", batch_size=16, head_slots=HEAD_SLOTS,
                 live_updates=True, update_dir=upd, snapshot_dir=snaps,
                 snapshot_every_deltas=2)
    print(f"[8] durability: DIN as in [5], HBM head {HEAD_SLOTS} rows, "
          f"live deltas, snapshots every 2 versions", flush=True)
    t0 = time.perf_counter()
    svc = InferenceService(ServiceConfig(**knobs), device="cuda",
                           model_cfg=cfg)
    torch.cuda.synchronize()
    print(f"[8] service build: {time.perf_counter() - t0} s", flush=True)
    head = svc.updates.head
    check(head.table.device.type == "cuda", "the head is not on the card")
    carry = dict(model_cfg=cfg, params=svc.buffer.active.payload,
                 pruning_dnn=svc.shedder.dnn)
    reports = []
    K.reset_launches()                      # counts from here are the path's

    # (a) head, updates, snapshots
    rep0, _ = _wave(svc, seed=0)
    reports.append(rep0)
    _wave_line("wave 0 (cold)", rep0)
    keys = _touched(rep0)
    em, rng = DeltaEmitter(upd), np.random.default_rng(0)
    for _ in range(2):
        _emit(em, keys, rng)
    check(svc.update_watcher.check_once(), "the watcher applied nothing")
    st = head.stats
    print(f"[8] after v0-v1: head promotions {st.promotions}, scatters "
          f"{st.scatters}, resident {head.resident_count}", flush=True)
    check(st.promotions > 0 and st.scatters > 0, "the head promoted nothing")
    resident = {g: ids[head.resident(g, ids)] for g, ids in keys.items()}
    check(sum(r.size for r in resident.values()) == head.resident_count,
          "a resident row is none of the wave's keys")
    check(resident[0].size > 0, "no item_id row is resident")
    _emit(em, resident, rng)                # v2: in place, on the card
    check(svc.update_watcher.check_once(), "the watcher applied nothing")
    check(head.stats.inplace_updates > 0
          and svc.updates.stats.head_rows_updated > 0,
          "no in-place update of a resident row")
    hits0 = head.stats.hits
    rep1, _ = _wave(svc, seed=1)
    reports.append(rep1)
    _wave_line("wave 1 (warm)", rep1)
    st = head.stats
    print(f"[8] head: promotions {st.promotions}, hits {st.hits} "
          f"({st.hits - hits0} in wave 1), misses {st.misses}, scatters "
          f"{st.scatters}, in-place updates {st.inplace_updates}, resident "
          f"{head.resident_count} of {head.n_slots}, table "
          f"{head.table.numel() * head.table.element_size()} bytes "
          f"{tuple(head.table.shape)} {head.table.dtype} on "
          f"{head.table.device}", flush=True)
    check(st.hits > hits0, "no head hit in the second wave")
    n_res = 0
    for g, ids in keys.items():             # the head holds the cube's rows
        found = head.resident(g, ids)
        slots, _ = head._resolve(signature_np(g, ids[found]))
        got = head.table[torch.as_tensor(slots, dtype=torch.long,
                                         device="cuda")].cpu().numpy()
        want = svc.cube.lookup(g, ids[found])
        check(np.array_equal(got, want),
              f"group {g}: a head row differs from the cube's")
        n_res += int(found.sum())
    check(n_res == head.resident_count, "a resident row went unchecked")
    print(f"[8] head rows equal the cube's bit for bit: {n_res} rows",
          flush=True)

    # the head's device work, by CUDA events: the gather of a lookup and
    # the scatter of update_rows, at a wave's resident rows
    slots, _ = head._resolve(signature_np(0, resident[0]))
    idx = torch.as_tensor(slots, dtype=torch.long, device="cuda")
    rows = torch.randn(idx.numel(), head.dim, device="cuda")
    scratch = head.table.clone()
    gather_ms = device_ms(lambda: head.table.index_select(0, idx))
    scatter_ms = device_ms(lambda: scratch.index_copy_(0, idx, rows))
    del scratch
    t0 = time.perf_counter()
    head.lookup(0, resident[0])
    lookup_host_ms = (time.perf_counter() - t0) * 1e3
    cube_rows = svc.cube.lookup(0, resident[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head.update_rows(0, resident[0], cube_rows)   # the same values again
    torch.cuda.synchronize()
    update_host_ms = (time.perf_counter() - t0) * 1e3
    print(f"[8] head lookup of {idx.numel()} rows: device "
          f"{gather_ms} ms (index_select, CUDA graph replay), {lookup_host_ms}"
          f" ms host wall incl. membership and the copy out; update_rows "
          f"scatter: device {scatter_ms} ms (index_copy_), {update_host_ms} "
          f"ms host wall", flush=True)

    probe, probe_reqs = _wave(svc, seed=7, n=16)
    reports.append(probe)
    before = _scores(probe, probe_reqs)
    snap = svc.snapshotter
    check(snap.snapshots_taken >= 1, "no periodic snapshot was taken")
    periodic_s = snap.last_snapshot_s
    t0 = time.perf_counter()
    final = svc.shutdown()
    shutdown_s = time.perf_counter() - t0
    check(final is not None, "shutdown wrote no final snapshot")
    print(f"[8] snapshots: {snap.snapshots_taken} taken, last_snapshot_s "
          f"{snap.last_snapshot_s} (periodic {periodic_s}); graceful "
          f"shutdown {shutdown_s} s -> {os.path.basename(final)}", flush=True)
    cube_before = _cube_rows(svc, keys)
    version = svc.updates.stats.last_version
    del svc, head
    gc.collect()

    # (b) recovery: no suffix, then two versions to replay
    t0 = time.perf_counter()
    rec = InferenceService(ServiceConfig(recover=True, **knobs),
                           device="cuda", **carry)
    recover_s = time.perf_counter() - t0
    sub = rec.substrate
    check(not sub.recovering and rec.updates.stats.deltas_applied == 0
          and rec.updates.stats.last_version == version
          and sub.recovery_target == version,
          "the recovery from the final snapshot replayed or lags")
    for g, (rows, tiers) in _cube_rows(rec, keys).items():
        check(np.array_equal(rows, cube_before[g][0])
              and np.array_equal(tiers, cube_before[g][1]),
              f"group {g}: recovered cube rows differ")
    again = _wave(rec, seed=7, n=16)
    reports.append(again[0])
    after = _scores(*again)
    err = max(abs(a - b) for a, b in zip(before, after))
    check(all(abs(a - b) <= TOL_F32 + TOL_F32 * abs(b)
              for a, b in zip(after, before)),
          f"recovered scores differ by {err}")
    print(f"[8] recovery from {os.path.basename(final)}: {recover_s} s, 0 "
          f"deltas replayed, cube rows of {sum(k.size for k in keys.values())}"
          f" touched ids equal; 16 probe scores equal within {TOL_F32:g} "
          f"(max diff {err})", flush=True)
    rec.stop_updates()
    del rec
    gc.collect()
    for _ in range(2):
        head_version = _emit(em, keys, rng)
    t0 = time.perf_counter()
    rec = InferenceService(ServiceConfig(recover=True, **dict(
        knobs, live_updates=False)), device="cuda", **carry)
    recover2_s = time.perf_counter() - t0
    sub, ust = rec.substrate, rec.updates.stats
    check(sub.recovery_target == head_version and not sub.recovering
          and ust.deltas_applied == 2 and ust.last_version == head_version,
          f"replay: target {sub.recovery_target}, recovering "
          f"{sub.recovering}, applied {ust.deltas_applied}")
    rep, _ = _wave(rec, seed=8, n=16)
    reports.append(rep)
    print(f"[8] recovery with 2 versions to replay: {recover2_s} s, "
          f"last_replay_s {sub.last_replay_s}, at v{ust.last_version} (the "
          f"log head)", flush=True)
    del rec, sub
    gc.collect()

    # (c) the launcher, with every telemetry flag, then --recover
    lroot = os.path.join(root, "launch")
    args = argparse.Namespace(
        arch="din", requests=N_REQUESTS, snapshot_dir=f"{lroot}/snaps",
        recover=False, update_dir=f"{lroot}/log", metrics_port=0,
        metrics_out=f"{lroot}/metrics", history_dir=f"{lroot}/history",
        history_interval_s=0.05, trace_out=f"{lroot}/trace.json")
    os.makedirs(args.update_dir)
    lem = DeltaEmitter(args.update_dir)
    for _ in range(2):
        _emit(lem, keys, rng)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        t0 = time.perf_counter()
        fig = serve_recsys(args, device="cuda", **carry)
        launch_s = time.perf_counter() - t0
        args.recover = True
        t0 = time.perf_counter()
        fig2 = serve_recsys(args, device="cuda", **carry)
        relaunch_s = time.perf_counter() - t0
    finally:
        signal.signal(signal.SIGTERM, prev)
    for f in (fig, fig2):
        check(f["served"] == N_REQUESTS, f"launcher served {f['served']}")
        for ev in f["report"].results:
            _check_rerank_answer(ev.meta.get("response"))
        reports.append(f["report"])
        check(f["history_windows"] >= 1 and f["traces"] >= 1,
              "no history window or trace recorded")
    check(fig["final_snapshot"] is not None,
          "the launcher wrote no final snapshot")
    with open(f"{args.metrics_out}/metrics.json") as fh:
        names = set(json.load(fh))
    with open(f"{args.metrics_out}/metrics.prom") as fh:
        prom = fh.read()
    for want in ("request_latency_s", "snapshot"):
        check(any(want in n for n in names) and want in prom,
              f"the metrics files hold no {want}")
    rsub = fig2["service"].substrate
    rst = fig2["service"].updates.stats
    check(rst.deltas_applied == 0 and not rsub.recovering
          and rst.last_version == int(os.path.basename(
              fig["final_snapshot"]).split("_")[1]),
          "the relaunch did not boot from the final snapshot")
    print(f"[8] launcher: served {fig['served']} in {launch_s} s (p50 "
          f"{fig['report'].latency_percentile(0.5) * 1e3} ms, p99 "
          f"{fig['p99_ms']} ms, query-cache hit "
          f"{fig['query_cache_hit_ratio']}), {fig['history_windows']} "
          f"history windows, {fig['traces']} traces, {len(names)} metrics, "
          f"final snapshot {os.path.basename(fig['final_snapshot'])}; "
          f"--recover: served {fig2['served']} in {relaunch_s} s (p50 "
          f"{fig2['report'].latency_percentile(0.5) * 1e3} ms, p99 "
          f"{fig2['p99_ms']} ms) from v{rst.last_version}, 0 replayed",
          flush=True)
    counts = K.launch_counts()
    expected = dict.fromkeys(K.LAUNCHES, 0)
    expected.update(_launch_expectation(reports))
    print(f"[8] launches {counts}, expected from the stage stats {expected}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30}"
          f" GiB", flush=True)
    check(all(counts[k] > 0 for k in ("embedding_bag", "din_attention",
                                      "rerank_score")),
          "a kernel of the DIN path was never launched")
    check(counts == expected, "launch counts differ from the path's calls")
    del fig, fig2, carry
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------------ phase 9

LM_TRAIN_BATCH, LM_TRAIN_MICRO = 8, 2     # cut from train_4k's 256 in 8
LM_TRAIN_SEQ = 4096                       # train_4k's sequence length
#: (cut from 6 steps and a checkpoint every 3 for [13f]'s time)
LM_TRAIN_STEPS, LM_CKPT_EVERY, LM_RESUME_STEPS = 4, 2, 1
REC_TRAIN_BATCH = 65536                   # configs/base.py: rec_train
REC_GRAD_BATCH = 4096                     # DIN card vs CPU gradients
REC_MODEL_BATCH = 1024                    # DIEN / MIND / two-tower gradients


_T9 = []


def say9(msg: str):
    """A line of phase 9, with the seconds since the phase began."""
    if not _T9:
        _T9.append(time.perf_counter())
    print(f"{msg} [{time.perf_counter() - _T9[0]:.1f} s into [9]]",
          flush=True)


def compare_tree(label, got, want, tol):
    """Leaf by leaf (JAX's order, paths as names), each held to
    rtol=atol=tol with the absolute part scaled by max(1, max|want|) of
    the leaf (gradients whose size a small norm sets; ``compare`` after a
    division by that scale). Returns the largest max-abs-diff."""
    from repro_torch import tree as tree_lib
    worst = 0.0
    for (path, g), (_, w) in zip(tree_lib.flatten_with_paths(got),
                                 tree_lib.flatten_with_paths(want)):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        s = max(1.0, float(w.abs().max())) if w.numel() else 1.0
        err = compare(f"{label} {tree_lib.path_name(path)}", g / s, w / s, tol)
        worst = max(worst, err * s)
    return worst


def _event_time(fn, n=3):
    """Mean wall of ``n`` eager calls between CUDA events, after one
    warm-up call (for calls too large or host-driven to replay from a
    graph: the backward passes and the plain AUGRU at the training batch)."""
    fn()
    return _event_ms(lambda: [fn() for _ in range(n)], n)


def _say_profile(label, prof):
    """Phase 9's line of a train step under torch.profiler."""
    say9(f"{label} one step under torch.profiler: wall {prof['wall_s']} s, "
         f"device busy {prof['device_busy_s']} s ({prof['device_events']} "
         f"device events), idle share {prof['idle_share']}; largest: "
         + "; ".join(f"{n[:70]} x{c} {s} s" for n, c, s in prof["top"]))


def lm_train_run():
    """Phase 9 (a) and (b): ``launch/train.py::train`` for smollm-135m at
    its published widths on the card, a checkpoint every LM_CKPT_EVERY
    steps, then a second ``train`` resuming from the newest; then one
    train step of the same carried weights card against CPU at B=2,
    S=256."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch import tree as tree_lib
    from repro_torch.configs.lm_archs import SMOLLM_135M as cfg
    from repro_torch.launch.train import parser, train
    from repro_torch.models import transformer
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import build_train_step, value_and_grad

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpt_dir = tempfile.mkdtemp(prefix="lm_train_")
    argv = ["--arch", cfg.name, "--ckpt-dir", ckpt_dir, "--ckpt-every",
            str(LM_CKPT_EVERY), "--batch", str(LM_TRAIN_BATCH), "--n-micro",
            str(LM_TRAIN_MICRO)]
    say9(f"[9a] train {cfg.name} at published widths ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads, vocab "
          f"{cfg.vocab}, {cfg.param_dtype}, remat {cfg.remat}): train_4k's "
          f"S={LM_TRAIN_SEQ}, global batch {LM_TRAIN_BATCH} in {LM_TRAIN_MICRO} "
          f"micro-batches (cut from 256 in 8), {LM_TRAIN_STEPS} steps, a "
          f"checkpoint every {LM_CKPT_EVERY}")
    K.reset_launches()                      # counts from here are the path's
    fig = train(parser().parse_args(argv + ["--steps", str(LM_TRAIN_STEPS)]),
                device="cuda")
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    say9(f"[9a] steps {fig['start_step']}..{fig['end_step'] - 1}: losses "
          f"{fig['losses']}; step wall s {fig['step_s']}; "
          f"{fig['ms_per_step']} ms/step and {fig['tokens_per_s']} tokens/s "
          f"over steps 2..{LM_TRAIN_STEPS}; checkpoint snapshot s "
          f"{fig['save_s']}, final save (blocking) {fig['final_save_s']} s; "
          f"max_memory_allocated {peak} GiB; launches {counts}")
    check(all(math.isfinite(x) for x in fig["losses"]), "non-finite LM loss")
    losses = list(fig["losses"])
    check(fig["end_step"] == LM_TRAIN_STEPS and
          fig["latest"].endswith(f"gen_{LM_TRAIN_STEPS}"),
          f"unexpected newest checkpoint {fig['latest']}")
    check(all(v == 0 for v in counts.values()),
          "the LM training path launched a kernel (lm_loss goes through "
          "chunked_attention, as the reference)")
    again = train(parser().parse_args(argv + ["--steps",
                                              str(LM_RESUME_STEPS)]),
                  device="cuda")
    check(again["start_step"] == LM_TRAIN_STEPS and
          again["end_step"] == LM_TRAIN_STEPS + LM_RESUME_STEPS,
          f"resume ran steps {again['start_step']}..{again['end_step']}")
    same = all(torch.equal(a, b) and a.dtype == b.dtype for a, b in
               zip(tree_lib.leaves(again["restored"]),
                   tree_lib.leaves(fig["params"])))
    check(same, "restored parameters differ from the saved ones")
    say9(f"[9a] resumed from {os.path.basename(fig['latest'])}: restore "
          f"{again['restore_s']} s, parameters equal bit for bit; steps "
          f"{again['start_step']}..{again['end_step'] - 1} losses "
          f"{again['losses']}")

    # one step's device time and the device's idle share within it
    step_fn, opt_init = build_train_step(
        lambda p, t: transformer.lm_loss(p, t, cfg),
        optimizer.for_family("lm", cfg.param_count()), n_micro=LM_TRAIN_MICRO)
    params = again["params"]
    state = opt_init(params)
    tokens = torch.randint(0, cfg.vocab, (LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                           device="cuda")
    # train() warmed every kernel
    _say_profile("[9a]", _profile_step(
        lambda: step_fn(params, state, tokens)))
    del params, state, fig, again, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # (b) one train step, card against CPU, the same carried weights
    say9(f"[9b] one train step card vs CPU at B=2, S=256, same weights, "
          f"tol {TOL_LM:g}")
    p_gpu = transformer.init(torch.Generator("cuda").manual_seed(1), cfg,
                             "cuda")
    p_cpu = _to(p_gpu, "cpu")
    tok = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab,
                                                            (2, 256)))
    init, update = optimizer.for_family("lm", cfg.param_count())
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda q, t: transformer.lm_loss(q, t, cfg), p, tok.to(dev))
        new, _ = update(grads, init(p), p)
        out[dev] = (loss, grads, new, time.perf_counter() - t0)
    lg, gg, ng, tg = out["cuda"]
    lc, g_cpu, nc, tc = out["cpu"]
    compare("[9b] loss", lg.cpu().reshape(1), lc.reshape(1), TOL_LM)
    g_err = compare_tree("[9b] grad", gg, g_cpu, TOL_LM)
    p_err = compare_tree("[9b] updated", ng, nc, TOL_LM)
    say9(f"[9b] loss card {float(lg)} CPU {float(lc)}; largest grad diff "
          f"{g_err}, updated-param diff {p_err}; step wall card {tg} s, CPU "
          f"{tc} s")
    del p_gpu, p_cpu, out, gg, g_cpu, ng, nc
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _rec_batch(cfg, n, seed, dev):
    import numpy as np
    from repro_torch.data import synthetic
    return _to(synthetic.recsys_batch(np.random.default_rng(seed), cfg, n),
               dev)


def rec_train_run() -> dict:
    """Phase 9 (c) and (d): DIN training at published widths (user_id /
    item_id cut to 2^20) at the published rec_train batch through
    ``build_train_step``, its launches counted, its gradients against the
    CPU, a checkpoint diff into a delta and a cube; then DIEN, MIND and
    two-tower gradients card vs CPU at phase 4's widths, B4 forward at the
    training batch, and the backward times of B2, B3 and B4 at the path's
    shapes. Returns {kernel: backward ms}."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs.other_archs import DIEN, DIN, MIND, TWO_TOWER
    from repro_torch.core.cube import ParameterCube
    from repro_torch.kernels.augru import augru, augru_ref
    from repro_torch.kernels.din_attention import din_attention
    from repro_torch.kernels.din_attention.ref import din_attention_ref
    from repro_torch.models.recsys import dien, din, mind, towers
    from repro_torch.train import checkpoint, optimizer
    from repro_torch.train.train_step import build_train_step, value_and_grad
    from repro_torch.update.delta import CheckpointDiffEmitter

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = _vocab(DIN, 1 << DIN_SERVICE_VOCAB_LOG2)
    vocab = {f.name: f.vocab for f in cfg.user_fields + cfg.item_fields}
    say9(f"[9c] DIN training at published widths (D=18, T=100, attn 80-40, "
          f"mlp 200-80), tables {vocab} (user_id/item_id cut from 2^26 to "
          f"2^{DIN_SERVICE_VOCAB_LOG2}), rec_train batch {REC_TRAIN_BATCH}, "
          f"for_family('recsys'): rowwise Adagrad tables + AdamW dense")
    params = din.init(torch.Generator("cuda").manual_seed(0), cfg, "cuda")
    loss_fn = (lambda p, b: din.loss_fn(p, b, cfg))
    opt_init, opt_update = optimizer.for_family("recsys")
    step_fn, _ = build_train_step(loss_fn, (opt_init, opt_update))
    state = opt_init(params)
    start = params
    step_s, losses = [], []
    for step in range(3):
        batch = _rec_batch(cfg, REC_TRAIN_BATCH, 10 + step, "cuda")
        torch.cuda.synchronize()
        K.reset_launches()                  # counts from here are the path's
        t0 = time.perf_counter()
        params, state, loss = step_fn(params, state, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        counts = K.launch_counts()
        check(counts == dict(dict.fromkeys(K.LAUNCHES, 0), embedding_bag=1,
                             din_attention=1),
              f"DIN train step {step} launched {counts}, expected one "
              f"grouped embedding_bag and one din_attention")
    _say_profile("[9c]", _profile_step(
        lambda: step_fn(params, state, batch), warm=True))
    say9(f"[9c] 3 steps at B={REC_TRAIN_BATCH}: losses {losses}, wall s "
          f"{step_s} ({REC_TRAIN_BATCH / (sum(step_s[1:]) / 2)} examples/s "
          f"over steps 2-3); per step 1 grouped embedding_bag + 1 "
          f"din_attention launched (checked); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30} GiB")
    check(all(math.isfinite(x) for x in losses), "non-finite DIN loss")
    back = {"embedding_bag": _bag_backward_ms(cfg, params, batch)}

    say9(f"[9c] DIN gradients card vs CPU at B={REC_GRAD_BATCH}, same "
          f"weights, tol {TOL_MODEL:g} (absolute part x max(1, max|leaf|))")
    small = _rec_batch(cfg, REC_GRAD_BATCH, 20, "cpu")
    p_cpu = _to(start, "cpu")
    lg, gg = value_and_grad(loss_fn, start, _to(small, "cuda"))
    lc, gcpu = value_and_grad(loss_fn, p_cpu, small)
    compare("[9c] DIN loss", lg.cpu().reshape(1), lc.reshape(1), TOL_MODEL)
    compare_tree("[9c] DIN grad", gg, gcpu, TOL_MODEL)
    del p_cpu, gg, gcpu

    # a checkpoint before and after one step, their diff as a delta
    root = tempfile.mkdtemp(prefix="rec_train_")
    before, after = os.path.join(root, "before"), os.path.join(root, "after")
    t0 = time.perf_counter()
    checkpoint.save(before, params, step=3)
    save_s = time.perf_counter() - t0
    _, grads = value_and_grad(loss_fn, params, batch)
    new, state = opt_update(grads, state, params)
    checkpoint.save(after, new, step=4)
    groups = {"tables/item_id": 0, "tables/user_id": 1,
              "tables/user_profile": 2, "tables/item_cat": 3}
    t0 = time.perf_counter()
    deltas = CheckpointDiffEmitter(os.path.join(root, "log"), groups).diff(
        before, after)
    diff_s = time.perf_counter() - t0
    by_group = {d.group: d for d in deltas}
    for name, gid in groups.items():
        field = name.split("/")[1]
        want = torch.nonzero(grads["tables"][field].abs().sum(1)).flatten()
        d = by_group.get(gid)
        got = np.empty(0, np.int64) if d is None else d.ids
        check(np.array_equal(got, want.cpu().numpy()),
              f"{name}: delta ids ({len(got)}) differ from the rows with a "
              f"non-zero gradient ({len(want)})")
        say9(f"[9c] {name}: {len(got)} rows in the delta = rows with a "
              f"non-zero gradient")
    cube = ParameterCube(tmpdir=tempfile.mkdtemp(prefix="cube_", dir=root))
    old = params["tables"]["item_id"].cpu().numpy()
    cube.load_table(0, old)
    d = by_group[0]
    cube.apply_batch([(0, d.ids, d.rows, d.delete_ids)])
    rows = cube.lookup(0, np.arange(old.shape[0]))
    check(np.array_equal(rows.view(np.uint32),
                         new["tables"]["item_id"].cpu().numpy().view(np.uint32)),
          "the cube given the delta differs from the new table")
    say9(f"[9c] checkpoint save {save_s} s (before), diff {diff_s} s; a "
          f"ParameterCube loaded with the old item_id table "
          f"({old.shape[0]} rows) and given the delta equals the new "
          f"table bit for bit")
    shutil.rmtree(root, ignore_errors=True)
    del params, state, new, grads, start, batch, cube
    gc.collect()
    torch.cuda.empty_cache()

    # (d) DIEN, MIND, two-tower: one gradient each, card vs CPU
    launches_per_call = {"dien": dict(embedding_bag=1, augru=1),
                         "mind": dict(embedding_bag=1),
                         "two_tower": dict(embedding_bag=2)}
    for mod, published in ((dien, DIEN), (mind, MIND), (towers, TWO_TOWER)):
        mcfg = _vocab(published, 1 << 16)
        p_cpu = mod.init(torch.Generator().manual_seed(0), mcfg, device="cpu")
        p_gpu = _to(p_cpu, "cuda")
        b_cpu = _rec_batch(mcfg, REC_MODEL_BATCH, 30, "cpu")
        fn = (lambda p, b, mod=mod, mcfg=mcfg: mod.loss_fn(p, b, mcfg))
        K.reset_launches()
        lg, gg = value_and_grad(fn, p_gpu, _to(b_cpu, "cuda"))
        counts = K.launch_counts()
        lc, gcpu = value_and_grad(fn, p_cpu, b_cpu)
        check(counts == dict(dict.fromkeys(K.LAUNCHES, 0),
                             **launches_per_call[mcfg.model]),
              f"{mcfg.name} gradient launched {counts}")
        say9(f"[9d] {mcfg.name} at phase 4's widths (vocab 2^16), B="
              f"{REC_MODEL_BATCH}: gradient card vs CPU, launches {counts}")
        compare(f"[9d] {mcfg.name} loss", lg.cpu().reshape(1), lc.reshape(1),
                TOL_MODEL)
        compare_tree(f"[9d] {mcfg.name} grad", gg, gcpu, TOL_MODEL)
        del p_cpu, p_gpu, gg, gcpu
    gc.collect()
    torch.cuda.empty_cache()

    # B4 forward at the training batch; the backward passes at the path's
    # shapes (the plain versions' gradients, recomputed)
    # inputs drawn on the card (7e8 host draws at B=65,536 took ~20 s)
    gen = torch.Generator("cuda").manual_seed(5)

    def t(*shape, scale=1.0, grad=False):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return x.requires_grad_(grad)

    def u01(*shape):
        return torch.rand(shape, generator=gen, device="cuda")
    B, T, H = REC_TRAIN_BATCH, 100, 108
    x, att = t(B, T, H, scale=0.5), u01(B, T)
    w, u, b = t(H, 3 * H, scale=0.1), t(H, 3 * H, scale=0.1), t(3 * H,
                                                                scale=0.1)
    with torch.no_grad():
        got = augru(x, att, w, u, b)
        want = augru_ref(x, att, w, u, b)
    compare(f"[9d] augru forward B={B} T={T} H={H} vs plain", got, want,
            TOL_EDGE)
    with torch.no_grad():
        fwd = device_ms(lambda: augru(x, att, w, u, b), iters=2, replays=2)
        plain = _event_time(lambda: augru_ref(x, att, w, u, b), n=2)
    say9(f"[9d] augru forward B={B}: kernel {fwd} ms (graph replay), plain "
          f"{plain} ms (eager)")
    del x, att, got, want
    gc.collect()
    torch.cuda.empty_cache()

    Bd = REC_MODEL_BATCH
    args = (t(Bd, T, H, scale=0.5, grad=True), u01(Bd, T),
            t(H, 3 * H, scale=0.1, grad=True), t(H, 3 * H, scale=0.1,
                                                   grad=True),
            t(3 * H, scale=0.1, grad=True))
    back["augru"] = _backward_ms("augru", augru, args, (0, 2, 3, 4),
                                 f"B={Bd} T={T} Din=H={H} (DIEN's gradient "
                                 f"in [9d])")
    D, H1, H2 = 18, 80, 40
    dargs = (t(B, T, D, scale=0.1, grad=True),
             (u01(B, T) > 0.2).float(),
             t(B, D, scale=0.1, grad=True), t(4 * D, H1, scale=0.1, grad=True),
             t(H1, scale=0.1, grad=True), t(H1, H2, scale=0.1, grad=True),
             t(H2, scale=0.1, grad=True), t(H2, 1, scale=0.1, grad=True),
             t(1, scale=0.1, grad=True))
    with torch.no_grad():
        fwd = device_ms(lambda: din_attention(*dargs), iters=2, replays=2)
        compare(f"[9c] din_attention forward B={B} vs plain",
                din_attention(*dargs), din_attention_ref(*dargs), TOL_F32)
    say9(f"[9c] din_attention forward B={B} T={T}: kernel {fwd} ms (graph "
          f"replay)")
    back["din_attention"] = _backward_ms(
        "din_attention", din_attention, dargs, (0, 2, 3, 4, 5, 6, 7, 8),
        f"B={B} T={T} D={D} MLP 72-80-40-1 (DIN's rec_train step)")
    del dargs
    gc.collect()
    torch.cuda.empty_cache()
    return back


def _bag_backward_ms(cfg, params, batch):
    """B3's backward at the DIN training step's lookups: its 5 groups over
    the trained tables at the step's batch, timed as ``_backward_ms``."""
    import torch
    from repro_torch.kernels.embedding_bag import embedding_bag_group
    from repro_torch.models.recsys import common
    tables = {k: v.detach().requires_grad_() for k, v in
              params["tables"].items()}
    item_side = tuple(f for f in cfg.item_fields if f.name != "item_id")
    lookups = [common.hist_lookup(tables, batch["user"]["hist"]),
               (tables["item_id"], batch["item"]["item_id"][:, None], None,
                "sum"),
               *[(tables[f.name], ids if ids.dim() == 2 else ids[:, None],
                  None, f.combiner) for f, ids in
                 ((f, batch["user"]["fields"][f.name])
                  for f in cfg.user_fields)],
               *[(tables[f.name], batch["item"][f.name][:, None], None,
                  f.combiner) for f in item_side]]
    B, T = batch["user"]["hist"].shape
    return _backward_ms(
        "embedding_bag",
        lambda *flat: torch.cat([o.reshape(-1) for o in embedding_bag_group(
            [flat[4 * i:4 * i + 4] for i in range(len(lookups))],
            blocks=(1, len(lookups) - 1))]),
        [x for g in lookups for x in g], None,
        f"DIN's 5 groups at B={B} ({B * T:,} history bags), V up to "
        f"2^{DIN_SERVICE_VOCAB_LOG2}, D=18")


def _backward_ms(name, fn, args, wrt, shape):
    """Device time (CUDA events, eager) of the backward of ``fn(*args)``
    w.r.t. ``args[i]`` for i in ``wrt`` (None: every float tensor that
    requires grad), and the forward's: the backward recomputes the plain
    version and takes its gradient."""
    import torch
    args = list(args)
    if wrt is None:
        wrt = [i for i, a in enumerate(args)
               if isinstance(a, torch.Tensor) and a.requires_grad]
    inputs = [args[i] for i in wrt]
    out = fn(*args)
    check(out.grad_fn is not None, f"{name}: no autograd node on the card")
    g = torch.randn_like(out)
    ms = _event_time(lambda: torch.autograd.grad(out, inputs, g,
                                                 retain_graph=True), n=3)
    say9(f"[9] {name} backward at {shape}: {ms} ms (CUDA events, eager)")
    return ms


# ----------------------------------------------------------------- phase 10

SCHNET_SHAPES = ("molecule", "full_graph_sm", "minibatch_lg")
SCHNET_STEPS = 5                           # AdamW steps per shape in (a)
#: the cell sweep of (b): (arch, shape, expected to fit one card), with
#: the kernels each cell's path must launch
SWEEP = (("schnet", "molecule", True, ()),
         ("schnet", "full_graph_sm", True, ()),
         ("schnet", "minibatch_lg", True, ()),
         ("schnet", "ogb_products", False, ()),
         ("din", "serve_p99", True, ("embedding_bag", "din_attention")),
         ("smollm-135m", "long_500k", True, ("flash_decode",)))
_T10 = []


def say10(msg: str):
    """A line of phase 10, with the seconds since the phase began."""
    if not _T10:
        _T10.append(time.perf_counter())
    print(f"{msg} [{time.perf_counter() - _T10[0]:.1f} s into [10]]",
          flush=True)


def gnn_run():
    """Phase 10 (a): SchNet at its published widths on molecule,
    full_graph_sm and minibatch_lg (the sampler over a 232,965-node CSR
    graph): one seeded reference-layout weight set and input on the card
    and on the CPU, the loss and every gradient leaf card vs CPU, then
    SCHNET_STEPS AdamW steps of the cell's train step on the card."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.launch import specs
    from repro_torch.models import schnet
    from repro_torch.tree import tree_map
    from repro_torch.train.train_step import value_and_grad

    cfg = registry.get("schnet").config
    for shape in SCHNET_SHAPES:
        cell = specs.build_cell("schnet", shape, device="cuda")
        t0 = time.perf_counter()
        params, opt_state, batch = cell.materialize(
            "cuda", torch.Generator(device="cuda").manual_seed(10))
        torch.cuda.synchronize()
        inputs = batch["inputs"]
        N = next(v for k, v in inputs.items()
                 if k in ("atom_z", "node_feat")).shape[0]
        E = inputs["edges"].shape[0]
        n_graphs = batch["targets"].shape[0]
        say10(f"[10a] schnet x {shape}: N={N} E={E} (sentinel edges "
              f"{int((inputs['edges'][:, 0] == N).sum())}), {n_graphs} "
              f"graph(s), inputs drawn in {time.perf_counter() - t0:.2f} s")

        def loss_fn(p, b):
            return schnet.loss_fn(p, b["inputs"], b["targets"], cfg,
                                  n_graphs=n_graphs)
        K.reset_launches()
        loss, grads = value_and_grad(loss_fn, params, batch)
        check(all(v == 0 for v in K.launch_counts().values()),
              "SchNet launched a hand-written kernel (its path has none)")
        t1 = time.perf_counter()
        cpu = tree_map(lambda t: t.cpu(), (params, batch))
        loss_h, grads_h = value_and_grad(loss_fn, *cpu)
        cpu_s = time.perf_counter() - t1
        worst = compare_tree(f"[10a] {shape} card vs CPU",
                             {"loss": loss, "grads": grads},
                             {"loss": loss_h, "grads": grads_h}, TOL_MODEL)
        say10(f"[10a] {shape}: loss {float(loss)} (CPU {float(loss_h)}), "
              f"largest diff over the loss and every gradient leaf "
              f"{worst:.3e}; the CPU's value_and_grad {cpu_s:.2f} s")
        del cpu, grads_h, grads

        state, losses = [params, opt_state], []

        def step():
            state[0], state[1], l = cell.fn(state[0], state[1], batch)
            losses.append(l)
        torch.cuda.reset_peak_memory_stats()
        # one warm-up step, then SCHNET_STEPS - 1 between CUDA events
        ms = _event_time(step, SCHNET_STEPS - 1)
        prof = _profile_step(step)
        losses = [float(x) for x in losses]
        check(all(math.isfinite(x) for x in losses), f"{shape}: non-finite loss")
        say10(f"[10a] {shape}: {SCHNET_STEPS} AdamW steps, {ms} ms/step "
              f"(CUDA events, steps 2..{SCHNET_STEPS}), losses {losses} "
              f"(the last the profiled step's); "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30} GiB; one step "
              f"under torch.profiler: wall {prof['wall_s']} s, device busy "
              f"{prof['device_busy_s']} s in {prof['device_events']} device "
              f"events, idle share {prof['idle_share']}; largest: "
              + "; ".join(f"{n[:90]} x{c} {t} s"
                          for n, c, t in prof["top"][:4]))
        del state, params, opt_state, batch, inputs
        gc.collect()
        torch.cuda.empty_cache()


def din_cell_kernel_checks():
    """Phase 10 (b), before ``din x serve_p99`` runs: the cell's two
    kernels against their plain versions (TOL_F32) on the cell's own
    inputs, drawn as ``run_cell`` draws them (seed 0): the grouped
    embedding_bag over ``din.logits_fn``'s lookups (B=512, T=100, the
    published 2^26-row item_id and user_id tables), then din_attention
    (B=512, T=100, D=18, attention MLP 80-40) on the history and target
    those lookups give."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import registry
    from repro_torch.kernels.din_attention import (din_attention,
                                                   din_attention_ref)
    from repro_torch.kernels.embedding_bag import (embedding_bag_group,
                                                   embedding_bag_group_ref)
    from repro_torch.launch import specs
    from repro_torch.models.recsys.common import (field_lookups, hist_lookup,
                                                  masked_hist)

    cfg = registry.get("din").config
    D = cfg.embed_dim
    cell = specs.build_cell("din", "serve_p99", device="cuda")
    params, batch = cell.materialize(
        "cuda", torch.Generator(device="cuda").manual_seed(0))
    tables = params["tables"]
    item_side = tuple(f for f in cfg.item_fields if f.name != "item_id")
    hist_ids = batch["user"]["hist"]
    look = [hist_lookup(tables, hist_ids),
            (tables["item_id"], batch["item"]["item_id"], None, "sum"),
            *field_lookups(tables, cfg.user_fields, batch["user"]["fields"]),
            *field_lookups(tables, item_side, batch["item"])]
    groups = [(table, ids if ids.dim() == 2 else ids[:, None], w, comb)
              for table, ids, w, comb in look]
    blocks = (1, 1 + len(cfg.user_fields) + len(item_side))
    B, T = hist_ids.shape
    say10(f"[10b] din x serve_p99: its kernels vs plain on the cell's "
          f"inputs (B={B}, T={T}, tables "
          + ", ".join(f"{f.name} {f.vocab}" for f in cfg.user_fields
                      + cfg.item_fields) + ")")
    before = K.launch_counts()["embedding_bag"]
    got = embedding_bag_group(groups, blocks)
    check(K.launch_counts()["embedding_bag"] == before + 1,
          "din x serve_p99: the grouped lookup is not one launch")
    want = embedding_bag_group_ref(groups, blocks)
    for j, (g, w) in enumerate(zip(got, want)):
        compare(f"[10b] din x serve_p99 embedding_bag_group block {j} "
                f"{tuple(g.shape)}", g, w, TOL_F32)
    hist, mask = masked_hist(want[0], hist_ids, D)
    target = want[1][:, :D].contiguous()
    flat = [p[k] for p in params["attn_mlp"] for k in ("w", "b")]
    args = (hist.contiguous(), mask.contiguous(), target, *flat)
    compare(f"[10b] din x serve_p99 din_attention B={B} T={T} D={D}",
            din_attention(*args), din_attention_ref(*args), TOL_F32)
    del params, batch, tables, look, groups, got, want, args
    gc.collect()
    torch.cuda.empty_cache()


def cell_sweep() -> dict:
    """Phase 10 (b): ``launch/dryrun.py::run_cell`` over SWEEP on the card,
    the launch counts set to 0 before each cell and read after it, then
    the roofline table of the records (H100 data-sheet peaks). The
    kernels of ``din x serve_p99`` are first held against their plain
    versions on that cell's inputs (``din_cell_kernel_checks``);
    flash_decode at ``smollm-135m x long_500k``'s shape is held in phase
    3. Returns the launches of the hand-written kernels over the sweep."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.launch import dryrun, roofline

    rows, launches = [], {}
    for arch, shape, fits, kernels in SWEEP:
        if (arch, shape) == ("din", "serve_p99"):
            din_cell_kernel_checks()
        K.reset_launches()
        rec = dryrun.run_cell(arch, shape, device="cuda")
        counts = K.launch_counts()
        mem = rec.get("memory", {})
        say10(f"[10b] {arch} x {shape}: ok {rec['ok']}, fits_h100 "
              f"{mem.get('fits_h100')} (estimate {mem.get('estimate_bytes')} "
              f"bytes against {mem.get('device_bytes')}), step_ms "
              f"{rec.get('step_ms')}, launches per step "
              f"{rec.get('launches_per_step')}, max_memory_allocated "
              f"{mem.get('max_allocated_bytes')} bytes, counted flops "
              f"{rec.get('ops', {}).get('flops_per_device')} bytes "
              f"{rec.get('ops', {}).get('bytes_per_device')}, kernels "
              f"{rec.get('ops', {}).get('kernels')}; "
              f"{rec.get('error', '')}")
        check(mem.get("fits_h100") is fits,
              f"{arch} x {shape}: fits_h100 {mem.get('fits_h100')}, "
              f"expected {fits}")
        check(rec["ok"] is fits, f"{arch} x {shape}: ok {rec['ok']}: "
              f"{rec.get('error')}\n{rec.get('traceback', '')}")
        for name in kernels:
            check(counts[name] > 0, f"{arch} x {shape}: {name} never launched")
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        rows.append(roofline.analyze_row(rec))
        gc.collect()
        torch.cuda.empty_cache()
    print("[10b] roofline on one card (H100 data-sheet peaks: HBM "
          f"{roofline.HBM_BYTES_PER_S:g} B/s, fp32 "
          f"{roofline.FP32_FLOPS_PER_S:g} FLOP/s, bf16 "
          f"{roofline.BF16_FLOPS_PER_S:g} FLOP/s):", flush=True)
    print(roofline.markdown_table(rows), flush=True)
    return launches


# ----------------------------------------------------------------- phase 11

#: the mesh of phase 11: 4 ranks, all on the one card, over gloo
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
MESH_BATCH = 512                           # serve_p99's batch
MESH_C = 64                                # candidates of a ranking call
MESH_VOCAB_LOG2 = 20                       # (b)'s cut of DIEN / MIND tables
#: (c): the cells run on the mesh, with the kernels each rank must launch
MESH_SWEEP = (("din", "serve_p99", ("embedding_bag", "din_attention")),
              ("din", "retrieval_cand", ("embedding_bag", "din_attention")),
              ("dien", "serve_p99", ("embedding_bag", "augru")))
#: launches per rank of each model call of (a) and (b)
MESH_LAUNCHES = {
    ("din", "serve_scores"): {"embedding_bag": 1, "din_attention": 1},
    ("din", "score_candidates"): {"embedding_bag": 1, "rerank_score": 1},
    ("dien", "serve_scores"): {"embedding_bag": 1, "augru": 1},
    ("dien", "score_candidates"): {"embedding_bag": 1, "augru": 1},
    ("mind", "serve_scores"): {"embedding_bag": 1},
    ("mind", "retrieve"): {"embedding_bag": 1},
    ("two-tower-retrieval", "serve_scores"): {"embedding_bag": 2},
    ("two-tower-retrieval", "retrieve"): {"embedding_bag": 1,
                                          "candidate_scorer": 1},
}
_T11 = []


def say11(msg: str):
    """A line of phase 11, with the seconds since the phase began."""
    if not _T11:
        _T11.append(time.perf_counter())
    print(f"{msg} [{time.perf_counter() - _T11[0]:.1f} s into [11]]",
          flush=True)


def _ranking_inputs(rng, cfg, C):
    """One user (a compacted history) and C candidates with distinct
    item ids (a strict ranking), as phase 4 draws them."""
    import numpy as np
    from repro_torch.serve.bucketing import (ShapeBucketer, compact_history,
                                             step_buckets)
    user = {"fields": {f.name: rng.integers(0, f.vocab, (1,) if f.bag == 1
                                            else (1, f.bag))
                       for f in cfg.user_fields}}
    if cfg.seq_len:
        hist = np.full(cfg.seq_len, -1, np.int64)
        n = cfg.seq_len * 4 // 5
        hist[:n] = rng.integers(0, cfg.item_fields[0].vocab, n)
        user["hist"] = compact_history(
            hist, ShapeBucketer(step_buckets(cfg.seq_len)))[None]
    cand = {f.name: rng.integers(0, f.vocab, (C,) if f.bag == 1
                                 else (C, f.bag))
            for f in cfg.item_fields}
    cand["item_id"] = rng.permutation(cfg.item_fields[0].vocab)[:C]
    return user, cand


def _rank_line(r) -> str:
    coll = "; ".join(f"{k} x{n} {b} B" for (k, _g), (n, b)
                     in sorted(r["collectives"].items()))
    return (f"launches {r['launches']}, {r.get('ms', float('nan')):.4f} ms a "
            f"call (CUDA events), collectives: {coll}")


def mesh_kernel_checks(label: str, ranks_checks: list, phase: str = "[11]",
                       bf16_outputs: tuple = (), per_call: bool = True) -> set:
    """Hold each rank's replayed kernel calls (``Job.check_kernels``: the
    wrapper's outputs and the plain version's on the rank's own inputs)
    to TOL_F32, integer outputs (top-k indices) equal; the outputs named
    in ``bf16_outputs`` ((kernel, output index): a bf16 kernel's output,
    shipped as float32) to TOL_BF16 and TOL_BF16 x max|want|, as phase 3
    holds bf16 B6. Without ``per_call`` one line per rank, kernel and
    output gives the count of calls and the worst. Returns the kernels
    checked."""
    import torch
    names = set()
    for r, checks in enumerate(ranks_checks):
        worst: dict = {}
        for c in checks:
            names.add(c["kernel"])
            shapes = ", ".join("x".join(map(str, sh)) or "()"
                               for sh in c["shapes"][:4])
            for j, (got, want) in enumerate(zip(c["got"], c["want"])):
                name = (f"{phase} {label} rank {r} {c['kernel']} out {j} "
                        f"({shapes}{', ...' if len(c['shapes']) > 4 else ''})")
                got, want = torch.as_tensor(got), torch.as_tensor(want)
                tols = ((TOL_BF16, TOL_BF16) if (c["kernel"], j) in bf16_outputs
                        else (TOL_F32, None))
                if not per_call and got.is_floating_point():
                    check(got.shape == want.shape and bool(
                        torch.isfinite(got).all()), f"{name}: shape or "
                        f"non-finite output")
                    err, used, ok = verdict(got, want, *tols)
                    check(ok, f"{name}: kernel disagrees with its plain "
                          f"version by {err}")
                    n, e, u = worst.get((c["kernel"], j), (0, 0.0, 0.0))
                    worst[(c["kernel"], j)] = (n + 1, max(e, err), max(u, used))
                elif got.is_floating_point():
                    compare(name, got, want, *tols)
                else:
                    check(torch.equal(got, want), f"{name}: differs from the "
                          f"plain version")
        for (kernel, j), (n, err, used) in sorted(worst.items()):
            tol = TOL_BF16 if (kernel, j) in bf16_outputs else TOL_F32
            print(f"  {phase} {label} rank {r} {kernel} out {j}: {n} calls "
                  f"replayed, max_abs_err={err:.3e} tol={tol:g}, allowance "
                  f"used {used:.3f} ok", flush=True)
    return names


def mesh_models_run(card: str) -> dict:
    """Phase 11 (a) and (b): DIN at its published widths and vocabularies
    (2^26-row user_id / item_id: 9.8 GB of tables, 2.45 GB a rank) and
    DIEN, MIND and two-tower at published widths (tables cut to 2^20
    rows, two-tower's to 2^21) on a 2x2 mesh of 4 ranks sharing the one
    card over gloo, one launch: each rank draws its rows of the tables
    from the seeded chunks (``tables_init``), then serve_scores at B=512
    (the rank's half of the batch) and the ranking call (C=64, whole on
    every rank; DIN's fused score_candidates, B1 on every rank over all
    C). Each result is held within TOL_MODEL against the same seeded
    weights and inputs run whole on the card by this process, rankings
    index for index, every rank's launches are checked, and every kernel
    call of each rank is held to its plain version on the rank's own
    inputs (``mesh_kernel_checks``). Returns the launches summed over
    ranks."""
    import numpy as np
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs.other_archs import DIEN, DIN, MIND, TWO_TOWER
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import (Job, ModelDraw, abstract_mesh,
                                         run_jobs)
    from repro_torch.launch.sharding import P, batched_spec

    rng = np.random.default_rng(11)
    am = abstract_mesh(MESH_SHAPE, MESH_AXES)
    models = (("din", DIN, "score_candidates", {"path": "fused"}),
              ("dien", _vocab(DIEN, 1 << MESH_VOCAB_LOG2), "score_candidates",
               {}),
              ("mind", _vocab(MIND, 1 << MESH_VOCAB_LOG2), "retrieve", {}),
              ("two-tower-retrieval", _vocab(TWO_TOWER, 1 << TOWERS_VOCAB_LOG2),
               "retrieve", {}))
    mods = {"din": "din", "dien": "dien", "mind": "mind",
            "two-tower-retrieval": "towers"}
    jobs = [Job("repro_torch.launch.mesh:collective_support")]
    cases = []
    for name, cfg, rank_fn, kw in models:
        module = f"repro_torch.models.recsys.{mods[name]}"
        draw = ModelDraw(module, cfg, seed=11)
        batch = synthetic.recsys_batch(rng, cfg, MESH_BATCH)
        batch.pop("label")
        bspec = tree_lib.tree_map(lambda a: batched_spec(am, a.shape), batch)
        user, cand = _ranking_inputs(rng, cfg, MESH_C)
        u = user["fields"] if cfg.model == "two_tower" else user
        jobs.append(Job(f"{module}:serve_scores", draw, None, (batch, cfg),
                        (bspec, None), out_specs=P("data"), repeat=5,
                        check_kernels=True))
        jobs.append(Job(f"{module}:{rank_fn}", draw, None, (u, cand, cfg),
                        (None, None, None), {"top_k": MESH_C, **kw},
                        repeat=5, check_kernels=True))
        cases.append((name, cfg, draw, rank_fn, kw, batch, u, cand))
    tables = {name: sum(f.vocab for f in cfg.user_fields + cfg.item_fields)
              * cfg.embed_dim * 4 for name, cfg, *_ in cases}
    say11(f"[11a/b] 4 ranks sharing one card over gloo, a {MESH_SHAPE} "
          f"(data, model) mesh ({card}); tables "
          + ", ".join(f"{k} {v / 1e9:.2f} GB ({v / 4e9:.2f} GB a rank)"
                      for k, v in tables.items()))
    t0 = time.perf_counter()
    ranks = run_jobs(jobs, MESH_SHAPE, MESH_AXES, device="cuda", timeout=900)
    support = ranks[0][0]["out"]
    say11(f"[11] the ranks' launch: {time.perf_counter() - t0:.1f} s; "
          f"{support['backend']} on {support['device']} accepts: "
          + ", ".join(f"{k} {v}" for k, v in support["kinds"].items()))
    # the collective helpers hand every kind to the backend directly
    check(all(v == "ok" for v in support["kinds"].values()),
          f"{support['backend']} refuses a collective on CUDA tensors: "
          f"{support['kinds']}")
    launches: dict = {}
    for j, (name, cfg, draw, rank_fn, kw, batch, u, cand) in enumerate(cases):
        mod = importlib.import_module(draw.module)
        params = draw.draw("cuda")
        with torch.no_grad():
            want_s = mod.serve_scores(params, _to(batch, "cuda"), cfg)
            v, i = getattr(mod, rank_fn)(params, _to(u, "cuda"),
                                         _to(cand, "cuda"), cfg,
                                         top_k=MESH_C, **kw)
        for call, k, want in (("serve_scores", 1 + 2 * j, want_s),
                              (rank_fn, 2 + 2 * j, (v, i))):
            checked = mesh_kernel_checks(
                f"{name} {call}", [rank[k]["kernel_checks"] for rank in ranks])
            expect = MESH_LAUNCHES[(name, call)]
            check(checked == set(expect), f"{name} {call}: kernels checked "
                  f"{sorted(checked)}, launched {sorted(expect)}")
            for r, rank in enumerate(ranks):
                row = rank[k]
                if call == "serve_scores":
                    compare(f"[11] {name} {call} B={MESH_BATCH} rank {r} vs "
                            f"whole", torch.as_tensor(row["out"]),
                            want.cpu(), TOL_MODEL)
                else:
                    compare(f"[11] {name} {call} C={MESH_C} rank {r} vs "
                            f"whole", torch.as_tensor(row["out"][0]),
                            want[0].cpu(), TOL_MODEL)
                    check(row["out"][1].tolist() == want[1].cpu().tolist(),
                          f"{name} {call} rank {r}: ranking differs from the "
                          f"whole run's")
                expect = MESH_LAUNCHES[(name, call)]
                check(row["launches"] == expect,
                      f"{name} {call} rank {r}: launches {row['launches']}, "
                      f"expected {expect}")
                for kname, n in row["launches"].items():
                    launches[kname] = launches.get(kname, 0) + n
                say11(f"[11] {name} {call} rank {r}: {_rank_line(row)}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def mesh_cell_sweep(card: str):
    """Phase 11 (c): ``launch/dryrun.py::run_cell`` over MESH_SWEEP on
    the 2x2 mesh of 4 ranks sharing the card over gloo (records
    ``<arch>__<shape>__2x2@1xH100.json``): the per-rank fit check, every
    kernel call of each rank's counted step held to its plain version on
    the rank's own inputs (``check_kernels``), ms per step, each rank's
    peak memory, launches and collectives by kind with their bytes; then
    the same cell run whole on the card by this process (seed 0), the
    max-abs-diff of the outputs and, for a ranking, its indices equal."""
    import numpy as np
    import torch
    from repro_torch.launch import dryrun, specs

    for arch, shape, kernels in MESH_SWEEP:
        rec = dryrun.run_cell(arch, shape, device="cuda", mesh=MESH_SHAPE,
                              check_kernels=True)
        LIVE_RECORDS[(arch, shape)] = rec
        mem = rec.get("memory", {})
        say11(f"[11c] {arch} x {shape} on {rec['mesh']}@1xH100 (4 ranks "
              f"sharing one card over {rec['backend']}; {card}): ok "
              f"{rec['ok']}, fits a rank's share {mem.get('fits_per_rank')} "
              f"(estimate {mem.get('estimate_bytes_per_rank')} bytes against "
              f"{mem.get('device_bytes_per_rank')}), step_ms {rec.get('step_ms')} "
              f"(the slowest rank); {rec.get('error', '')}")
        check(rec["ok"], f"{arch} x {shape} on the mesh: {rec.get('error')}\n"
              f"{rec.get('traceback', '')}")
        checked = mesh_kernel_checks(f"{arch} x {shape}", rec["kernel_checks"])
        check(set(kernels) <= checked, f"{arch} x {shape}: kernels checked "
              f"{sorted(checked)}, expected {sorted(kernels)}")
        for r in rec["ranks"]:
            coll = "; ".join(
                f"{k} x{row['calls']:g} {row['bytes']:g} B (traffic "
                f"{row['traffic_bytes']:g} B)"
                for k, row in sorted(r["collectives_per_step"].items()))
            say11(f"[11c]   rank {r['rank']}: {r['step_ms']} ms/step, peak "
                  f"{r['max_allocated_bytes'] / 2**30:.3f} GiB, launches per "
                  f"step {r['launches_per_step']}, per step: {coll}")
            for name in kernels:
                check(r["launches_per_step"].get(name, 0) > 0,
                      f"{arch} x {shape} rank {r['rank']}: {name} never "
                      f"launched")
        cell = specs.build_cell(arch, shape, device="cuda")
        args = cell.materialize("cuda", torch.Generator(device="cuda")
                                .manual_seed(0))
        with torch.no_grad():
            want = cell.fn(*args)
        got = rec["output"]
        if isinstance(want, tuple):
            err = float(np.abs(got[0] - want[0].cpu().numpy()).max())
            same = float((got[1] == want[1].cpu().numpy()).mean())
            say11(f"[11c] {arch} x {shape}: top-{len(got[1])} values vs the "
                  f"whole run max_abs_diff {err:.3e}, {same:.3f} of the "
                  f"indices equal")
            # merge_topk keeps lax.top_k's order over global indices
            check(same == 1.0, f"{arch} x {shape}: the mesh's ranking "
                  f"differs from the whole run's ({same:.3f} of the indices "
                  f"equal)")
        else:
            err = float(np.abs(got - want.cpu().numpy()).max())
            say11(f"[11c] {arch} x {shape}: output vs the whole run "
                  f"max_abs_diff {err:.3e}")
        check(err <= TOL_MODEL, f"{arch} x {shape}: the mesh run differs "
              f"from the whole run by {err}")
        del cell, args, want
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 12

#: (a), (b): the LM's batch-1 long-context decode cells run on the mesh
#: by ``run_cell`` at published widths and shapes, each with the kernels
#: every rank must launch and its dtype's hold (TOL_LM for float32; a
#: bf16 MoE's routing turns rounding into other experts, so (b) is held
#: by (e))
LM_MESH_CELLS = (("smollm-135m", "long_500k", ("flash_decode",)),
                 ("deepseek-v2-lite-16b", "long_500k", ()))
#: (c)-(f): serving runs on the mesh (``transformer.teacher_forced``: a
#: prefill, then teacher-forced decode steps), at published widths:
#: (key, arch, layers, dtype (None: the published ones), B, cache rows,
#: prompt tokens, decode steps, what the run holds). The cuts: (c)
#: prefill_32k's B=32, S=32,768 to 4, 4,096 and 27 layers to 6 in float32
#: (bf16 routing flips make a bf16 MoE run incomparable, see (b)); (d)
#: decode_32k's B=128 to 4; (e) long_500k's 27 layers to 6 in float32;
#: (f) (d) at 4 layers in float32
#: (depths cut when phase 13 came, to keep the call's time: (c) and (e)
#: 6 → 2 layers (one dense, one MoE), (d) 36 → 4, (f) 4 → 1)
LM_CALLS = (
    ("c", "deepseek-v2-lite-16b", 2, "float32", 4, 4096, 4096, 0,
     "prefill B=4 S=4096, the token-sharded MoE"),
    ("e", "deepseek-v2-lite-16b", 2, "float32", 1, 524288, 9, 3,
     "prefill 9 + 3 decode steps in a 524,288-row cache, B=1"),
    ("d", "qwen3-8b", 4, None, 4, 32768, 64, 4,
     "prefill 64 + 4 decode steps, B=4, bf16 B6 with G=4"),
    ("f", "qwen3-8b", 1, "float32", 4, 32768, 64, 4,
     "prefill 64 + 4 decode steps, B=4, f32 B6 with G=4"))
LM_SEED = 12
#: the items whose MoE routing is recorded (:func:`routed_teacher_forced`)
ROUTED = ("c",)
#: (c): a token's top-k may move between the runs only where its k-th and
#: (k+1)-th router probabilities lie within GAP_TIE in the whole run, and
#: a layer's cache may hold at most ROWS_OFF rows off; an H100 run read
#: gaps up to 1.5e-6 (the median token's 2.3e-3) and 2 and 4 rows off
#: (PERF.md §6)
GAP_TIE = 1e-5
ROWS_OFF = 16
#: a bf16 run on the mesh against the float32 run of its weights: at most
#: this times the bf16 whole run's RMS error (an H100 run read 1.04 for
#: (d); PERF.md §6)
BF16_ERR_RATIO = 1.5
_T12 = []


def say12(msg: str):
    """A line of phase 12, with the seconds since the phase began."""
    if not _T12:
        _T12.append(time.perf_counter())
    print(f"{msg} [{time.perf_counter() - _T12[0]:.1f} s into [12]]",
          flush=True)


def _lm_calls():
    """[(key, cfg, tokens, smax, prompt, label)] of LM_CALLS, the tokens
    drawn from LM_SEED."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import registry
    rng = np.random.default_rng(LM_SEED)
    out = []
    for key, arch, layers, dtype, B, smax, n, steps, what in LM_CALLS:
        cfg = registry.get(arch).config
        cut = {k: v for k, v in (("n_layers", layers), ("param_dtype", dtype))
               if v is not None}
        cfg = dataclasses.replace(cfg, **cut)
        toks = rng.integers(0, cfg.vocab, (B, n + steps))
        label = (f"({key}) {arch} {what}" + (f" ({cfg.n_layers} layers, "
                                             f"{cfg.param_dtype})" if cut
                                             else ""))
        out.append((key, cfg, toks, smax, n, label))
    return out


def routed_teacher_forced(params, tokens, cfg, smax, n_prompt, **kw):
    """``transformer.teacher_forced`` of a prefill (no decode steps) with
    each MoE layer's routing kept: → (logits, cache, idx (MoE layers, B,
    T, top_k) the experts each token chose, sorted; gap (MoE layers, B,
    T) its k-th router probability less its (k+1)-th, float32). The record
    adds one softmax and top-k of the router's logits a layer, in the
    timed calls too."""
    import torch
    from repro_torch.models import moe, transformer
    route, seen = moe._route, []

    def spy(x, w, k, *rest):
        gate, idx, aux = route(x, w, k, *rest)
        top = torch.softmax(x.float() @ w, -1).topk(k + 1, -1).values
        seen.append((idx.sort(-1).values, top[:, k - 1] - top[:, k]))
        return gate, idx, aux
    moe._route = spy
    try:
        logits, cache = transformer.teacher_forced(params, tokens, cfg, smax,
                                                   n_prompt, **kw)
    finally:
        moe._route = route
    B, T = tokens.shape
    return (logits, cache,
            torch.stack([i for i, _ in seen]).reshape(len(seen), B, T, -1),
            torch.stack([g for _, g in seen]).reshape(len(seen), B, T))


def lm_whole_run(out_path: str) -> int:
    """Phase 12's whole runs, in a process of their own (``chip_smoke.py
    --lm-whole OUT``, started by :func:`lm_mesh_run` before the mesh
    runs, so that its ~48 GB are gone when the ranks draw): each item on
    the card by this one process, no mesh, from the draws the ranks take
    their parts of; saves the logits, the cache rows (c)-(f) wrote, the
    routing of ROUTED's items, the logits of a bf16 item's weights run in
    float32 (the reference its bf16 runs, whole and on the mesh, are
    measured against) and each item's ms per call (CUDA events) to
    ``out_path``."""
    import dataclasses

    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch.launch import specs
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    def f32(t):
        return t.float().cpu().numpy()

    out = {}
    with torch.no_grad():
        for arch, shape, _ in LM_MESH_CELLS:
            cell = specs.build_cell(arch, shape, device="cuda")
            args = cell.materialize("cuda", torch.Generator(device="cuda")
                                    .manual_seed(0))
            out[f"{arch}/logits"] = f32(cell.fn(*args)[0])
            out[f"{arch}/ms"] = _event_ms(
                lambda: [cell.fn(*args) for _ in range(3)], 3)
            del cell, args
            gc.collect()
            torch.cuda.empty_cache()
        for key, cfg, toks, smax, n, _label in _lm_calls():
            params = transformer.init(
                torch.Generator(device="cuda").manual_seed(LM_SEED), cfg,
                "cuda")
            t = torch.as_tensor(toks, device="cuda")

            def run():
                return transformer.teacher_forced(params, t, cfg, smax, n)
            if key in ROUTED:
                logits, cache, idx, gap = routed_teacher_forced(
                    params, t, cfg, smax, n)
                out[f"{key}/idx"], out[f"{key}/gap"] = (idx.cpu().numpy(),
                                                        f32(gap))
                del idx, gap
            else:
                logits, cache = run()
            out[f"{key}/logits"] = f32(logits)
            out[f"{key}/cache_a"], out[f"{key}/cache_b"] = (f32(cache.a),
                                                            f32(cache.b))
            del logits, cache
            out[f"{key}/ms"] = _event_ms(run, 1)
            if cfg.param_dtype == "bfloat16":
                # the float32 reference of the same bf16 weights, in a
                # cache of the rows the run writes
                params = tree_map(lambda p: p.float(), params)
                ref, _ = transformer.teacher_forced(
                    params, t, dataclasses.replace(cfg,
                                                   param_dtype="float32"),
                    toks.shape[1], n)
                out[f"{key}/ref32"] = f32(ref)
                del ref
            del params
            gc.collect()
            torch.cuda.empty_cache()
    np.savez(out_path, **out)
    return 0


def _held(label, got, want, tol=TOL_LM) -> float:
    """The mesh's output against the whole run's, within ``tol``
    (rtol=atol)."""
    import torch
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    err, used, ok = verdict(got, want, tol)
    say12(f"[12] {label}: max_abs_diff vs the whole run {err:.3e} "
          f"(rtol=atol={tol:g}; allowance used {used:.3f}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the mesh run differs from the whole run by {err}")
    return err


def _kept(idx, C):
    """The experts each token's pairs reach, by the dispatch's rule (pairs
    in token order, sorted stably by expert, the first C of each kept):
    idx (T, k) → (T, k) bool."""
    import numpy as np
    T, k = idx.shape
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    e = flat[order]
    starts = np.searchsorted(e, e, side="left")
    keep = np.empty(flat.shape, bool)
    keep[order] = np.arange(flat.size) - starts < C
    return keep.reshape(T, k)


def _held_routed_rows(label, ranks_out, want, cfg):
    """(c): a MoE prefill's cache rows, (layers, B, T, ...), against the
    whole run's within TOL_LM, with the routing that explains each row
    that is off. A token "moves" at a MoE layer where the experts that
    take its pairs differ between the runs: its top-k changed, or a drop
    did (a capacity slot taken or freed by another token that moved).
    Held: the layers before any routed expert all rows; each token's first
    move a near tie (its top-k changed with the whole run's k-th and
    (k+1)-th router probabilities within GAP_TIE) or a drop moved by
    another token in the same layer; every row off a token that moved in
    an earlier layer; at most ROWS_OFF rows off a layer."""
    import numpy as np
    from repro_torch.models.moe import _capacity
    n_dense = cfg.moe.n_dense_layers
    for r, (logits, cache, idx, gap) in enumerate(ranks_out):
        idx, w_idx = np.asarray(idx), want["idx"]
        check(np.array_equal(np.asarray(gap).shape, want["gap"].shape),
              f"{label} rank {r}: routing of shape {np.shape(gap)}")
        L_moe, B, T, k = idx.shape
        C = _capacity(B * T, cfg.moe)
        moved = np.zeros((L_moe, B * T), bool)
        flips = np.zeros((L_moe, B * T), bool)
        first = []
        for m in range(L_moe):
            a, b = idx[m].reshape(-1, k), w_idx[m].reshape(-1, k)
            flip = flips[m] = (a != b).any(-1)
            # the experts a token's pairs reach (its top-k masked by its
            # drops), as sorted sets
            reach_a = np.sort(np.where(_kept(a, C), a, -1), -1)
            reach_b = np.sort(np.where(_kept(b, C), b, -1), -1)
            moved[m] = (reach_a != reach_b).any(-1) | flip
            new = moved[m] & ~moved[:m].any(0)
            g = want["gap"][m].reshape(-1)
            for tok in np.flatnonzero(new):
                first.append((m + n_dense, int(tok), bool(flip[tok]),
                              float(g[tok])))
        ties = [f for f in first if f[2]]
        say12(f"[12] {label} rank {r}: tokens whose experts moved, by MoE "
              f"layer: {[int(x) for x in moved.sum(-1)]}; first moves "
              f"(layer, token, top-k changed, the whole run's gap): "
              f"{[(l, t, f, f'{g:.3e}') for l, t, f, g in first[:24]]}"
              f"{' ...' if len(first) > 24 else ''}; the whole run's median "
              f"gap {float(np.median(want['gap'])):.3e}")
        check(all(g <= GAP_TIE for _, _, _, g in ties),
              f"{label} rank {r}: a token's top-k moved with its k-th and "
              f"(k+1)-th router probabilities "
              f"{max((g for *_, g in ties), default=0):.3e} apart (> "
              f"{GAP_TIE:g}): not a rounding tie")
        for m in range(L_moe):   # a drop moves only beside a changed top-k
            check(flips[m].any() or not any(
                l == m + n_dense and not f for l, _, f, _ in first),
                f"{label} rank {r}: drops moved at layer {m + n_dense} with "
                f"no top-k changed")
        for name in ("a", "b"):
            got = np.asarray(getattr(cache, name))
            ref = want[f"cache_{name}"]
            check(got.shape == ref.shape and np.isfinite(got).all(),
                  f"{label} rank {r} cache.{name}: shape {got.shape} vs "
                  f"{ref.shape} or non-finite")
            rows = lambda x: x.reshape(x.shape[0], -1,
                                       int(np.prod(x.shape[3:])))
            off = ~(np.abs(rows(got) - rows(ref))
                    <= TOL_LM * (1 + np.abs(rows(ref)))).all(-1)  # (L, B*T)
            n_off = [int(x) for x in off.sum(-1)]
            unexplained = [
                (l, int(tok)) for l in range(off.shape[0])
                for tok in np.flatnonzero(off[l])
                if not moved[:max(l - n_dense, 0)].any(0)[tok]]
            say12(f"[12] {label} rank {r} cache.{name}: rows off (beyond "
                  f"rtol=atol={TOL_LM:g}) by layer {n_off} of "
                  f"{off.shape[1]}; rows off of no moved token "
                  f"{unexplained[:8]}")
            check(not unexplained and max(n_off) <= ROWS_OFF,
                  f"{label} rank {r} cache.{name}: rows off {n_off} (at "
                  f"most {ROWS_OFF} a layer), of no moved token "
                  f"{unexplained[:8]}")
        _held(f"{label} rank {r} logits", logits, want["logits"])


def _rel_err(got, want) -> float:
    """The RMS of got - want over the RMS of want."""
    import numpy as np
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def _bf16_run(label, ranks_logits, want, ref32=None):
    """A bf16 run on the mesh: the ranks' gathered logits finite, of the
    whole run's shape and equal to the first's bit for bit (one result,
    held by every rank). Where ``ref32`` (the same bf16 weights run whole
    in float32) is given, the mesh's error against it is held to
    BF16_ERR_RATIO times the bf16 whole run's (RMS errors): the mesh
    rounds in other places than the whole run (the TP partial sums, the
    shards' partials), not more often. Else (a bf16 MoE, whose nearly tied
    6th and 7th experts trade places under rounding, PERF.md §6) the
    max-abs-diff and the share of rows whose argmax agrees are reported,
    not held."""
    import numpy as np
    first = np.asarray(ranks_logits[0])
    for r, got in enumerate(ranks_logits):
        got = np.asarray(got)
        check(got.shape == want.shape and np.isfinite(got).all(),
              f"{label} rank {r}: logits {got.shape}, finite "
              f"{np.isfinite(got).all()}")
        check(np.array_equal(got, first), f"{label} rank {r}: logits differ "
              f"from rank 0's")
    agree = float((first.argmax(-1) == want.argmax(-1)).mean())
    who = (f"the {len(ranks_logits)} ranks' logits equal"
           if len(ranks_logits) > 1 else "rank 0's logits")
    line = (f"[12] {label}: {who}; vs the bf16 whole run max_abs_diff "
            f"{float(np.abs(first - want).max()):.3e} (max|want| "
            f"{float(np.abs(want).max()):.3e}), argmax agrees on {agree:.3f} "
            f"of the rows")
    if ref32 is None:
        say12(line + " (a bf16 MoE: reported, not held)")
        return
    e_mesh, e_whole = _rel_err(first, ref32), _rel_err(want, ref32)
    ok = e_mesh <= BF16_ERR_RATIO * e_whole
    say12(line + f"; RMS error against the float32 run of the same "
          f"weights: mesh {e_mesh:.4e}, whole {e_whole:.4e}, ratio "
          f"{e_mesh / e_whole:.3f} (at most {BF16_ERR_RATIO:g}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the bf16 mesh run's error {e_mesh:.4e} against "
          f"float32 is more than {BF16_ERR_RATIO:g} x the whole run's "
          f"{e_whole:.4e}")


def _rank_lines(label, rows, key="ms"):
    """Each rank's ms per call (CUDA events), peak GiB, launches and
    collectives by kind, and the slowest rank's ms."""
    for r, row in enumerate(rows):
        coll = "; ".join(f"{k} x{v['calls']:g} {v['bytes']:g} B"
                         for k, v in sorted(row["collectives"].items()))
        say12(f"[12] {label} rank {r}: {row[key]:.2f} ms a call, peak "
              f"{row['peak'] / 2**30:.2f} GiB, launches {row['launches']}, "
              f"collectives {coll}")
    say12(f"[12] {label}: rank 0 {rows[0][key]:.2f} ms, slowest rank "
          f"{max(r[key] for r in rows):.2f} ms a call (4 ranks sharing one "
          f"card over gloo: function, not a multi-GPU speed)")


def lm_mesh_run(card: str) -> int:
    """Phase 12: the LM on the 2x2 (data, model) mesh of 4 ranks sharing
    the one card over gloo, at published widths: (a) smollm-135m x
    long_500k and (b) deepseek-v2-lite-16b x long_500k by ``run_cell``,
    no cut; then (c)-(f) of LM_CALLS in one launch. Each is held against
    the same draws run whole by one process (:func:`lm_whole_run`, first,
    in its own process): float32 logits and cache rows within TOL_LM
    ((c)'s rows with the routing that explains those off,
    :func:`_held_routed_rows`), bf16 runs by :func:`_bf16_run` ((d)
    against the float32 run of its weights); every rank's B6 calls replayed
    against the plain version; B6 launched on every rank of (a), (d) and
    (f). Returns B6's launches over all ranks."""
    import numpy as np
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch.mesh import Job, ModelDraw, run_jobs
    from repro_torch.launch.sharding import P
    from repro_torch.models.transformer import KVCache

    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        path = os.path.join(tmp, "whole.npz")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--lm-whole", path], capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0, "the whole runs failed:\n"
              + (proc.stdout + proc.stderr)[-4000:])
        whole = dict(np.load(path))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say12(f"[12] whole runs on one card by one process ({card}): "
          f"{time.perf_counter() - t0:.1f} s; ms a call: "
          + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in whole.items()
                      if k.endswith("/ms")))

    b6 = 0
    for arch, shape, kernels in LM_MESH_CELLS:
        rec = dryrun.run_cell(arch, shape, device="cuda", mesh=MESH_SHAPE,
                              check_kernels=True)
        LIVE_RECORDS[(arch, shape)] = rec
        mem = rec.get("memory", {})
        say12(f"[12] {arch} x {shape} on {rec['mesh']}@1xH100 (4 ranks "
              f"sharing one card over {rec['backend']}; {card}): ok "
              f"{rec['ok']}, fits a rank's share {mem.get('fits_per_rank')} "
              f"(estimate {mem.get('estimate_bytes_per_rank')} bytes), "
              f"{rec.get('t_total_s')} s; {rec.get('error', '')}")
        check(rec["ok"], f"{arch} x {shape} on the mesh: {rec.get('error')}\n"
              f"{rec.get('traceback', '')}")
        checked = mesh_kernel_checks(f"{arch} x {shape}", rec["kernel_checks"],
                                     "[12]", per_call=False)
        check(checked == set(kernels), f"{arch} x {shape}: kernels checked "
              f"{sorted(checked)}, expected {sorted(kernels)}")
        rows = [{"ms": r["step_ms"], "peak": r["max_allocated_bytes"],
                 "launches": r["launches_per_step"],
                 "collectives": r["collectives_per_step"]}
                for r in rec["ranks"]]
        _rank_lines(f"{arch} x {shape}", rows)
        for r in rec["ranks"]:
            for name in kernels:
                n = r["launches_per_step"].get(name, 0)
                check(n > 0, f"{arch} x {shape} rank {r['rank']}: {name} "
                      f"never launched")
                b6 += n
        if rec["meta"]["param_dtype"] == "float32":
            _held(f"{arch} x {shape} logits", rec["output"][0],
                  whole[f"{arch}/logits"])
        else:       # run_cell returns rank 0's; (e) holds the layers
            _bf16_run(f"{arch} x {shape}", [rec["output"][0]],
                      whole[f"{arch}/logits"])

    mod = "repro_torch.models.transformer"
    calls = _lm_calls()
    jobs, draws = [], {}
    for key, cfg, toks, smax, n, _label in calls:
        split = toks.shape[0] % MESH_SHAPE[0] == 0
        # one draw for the calls of one config (a rank keeps it between
        # consecutive jobs)
        draw = draws.setdefault(cfg, ModelDraw(mod, cfg, LM_SEED))
        out_specs = ((P(None, "data", None), KVCache(
            P(None, "data"), P(None, "data"), P())) if split else None)
        if key in ROUTED:
            out_specs += (P(None, "data", None, None), P(None, "data", None))
        jobs.append(Job(
            "chip_smoke:routed_teacher_forced" if key in ROUTED
            else f"{mod}:teacher_forced", draw, None,
            (toks, cfg, smax, n),
            ((P("data", None) if split else None), None, None, None),
            {} if split else {"batch_axes": ()}, out_specs=out_specs,
            repeat=1, check_kernels=True))
    t0 = time.perf_counter()
    ranks = run_jobs(jobs, MESH_SHAPE, MESH_AXES, device="cuda", timeout=900)
    say12(f"[12c-f] the ranks' launch: {time.perf_counter() - t0:.1f} s")
    for j, (key, cfg, toks, smax, n, label) in enumerate(calls):
        rows = [{"ms": rank[j]["ms"], "peak": rank[j]["max_allocated_bytes"],
                 "launches": rank[j]["launches"],
                 "collectives": op_analysis.collectives_by_kind(
                     rank[j]["collectives"])} for rank in ranks]
        _rank_lines(label, rows)
        if key in ROUTED:
            _held_routed_rows(label, [rank[j]["out"] for rank in ranks],
                              {k: whole[f"{key}/{k}"] for k in (
                                  "logits", "cache_a", "cache_b", "idx",
                                  "gap")}, cfg)
        elif cfg.param_dtype == "float32":
            for r, rank in enumerate(ranks):
                logits, cache = rank[j]["out"]
                _held(f"{label} rank {r} logits", logits,
                      whole[f"{key}/logits"])
                for name in ("a", "b"):
                    _held(f"{label} rank {r} cache.{name}, the rows written",
                          getattr(cache, name), whole[f"{key}/cache_{name}"])
        else:
            _bf16_run(label, [rank[j]["out"][0] for rank in ranks],
                      whole[f"{key}/logits"], whole[f"{key}/ref32"])
        steps = toks.shape[1] - n
        gqa = cfg.mla is None
        checked = mesh_kernel_checks(
            label, [rank[j]["kernel_checks"] for rank in ranks], "[12]",
            bf16_outputs=(("flash_decode", 0),) if cfg.param_dtype ==
            "bfloat16" else (), per_call=False)
        check(checked == ({"flash_decode"} if gqa and steps else set()),
              f"{label}: kernels checked {checked}")
        for r, rank in enumerate(ranks):
            got = rank[j]["launches"].get("flash_decode", 0)
            want = cfg.n_layers * steps if gqa else 0
            check(got == want, f"{label} rank {r}: {got} B6 launches, "
                  f"expected {want}")
            b6 += got
    return b6


# ----------------------------------------------------------------- phase 13

#: phase 13's recsys gradient checks: (model, module, the config's cut,
#: batch): DIN at published widths and vocabularies, the others at phase
#: 4's widths with tables cut to 2^16 rows
REC13_VOCAB_LOG2 = 16
REC13_SEED = 13
SCHNET13_SEED = 13
#: (a)'s launcher on the mesh: steps and checkpoint interval (cut from
#: phase 9's 6 and 3 to keep the call's time: a mesh step takes ~16 s)
LM_MESH13_STEPS, LM_MESH13_EVERY = 2, 1
#: (e)'s timed steps a cell (after one warm-up step)
CELL13_STEPS = 1
#: (e): the cells run on the mesh, with the kernels each rank must launch
#: (SchNet's molecule, full_graph_sm and minibatch_lg cut: (d) holds them
#: on the mesh)
CELL13 = (("smollm-135m", "train_4k", ()),
          ("din", "train_batch", ("embedding_bag", "din_attention")),
          ("schnet", "ogb_products", ()))
#: (b)/(c): each model's kernel launches per rank in one loss and gradient
REC13_LAUNCHES = {"din": {"embedding_bag": 1, "din_attention": 1},
                  "dien": {"embedding_bag": 1, "augru": 1},
                  "mind": {"embedding_bag": 1},
                  "two-tower-retrieval": {"embedding_bag": 2}}
_T13 = []


def say13(msg: str):
    """A line of phase 13, with the seconds since the phase began."""
    if not _T13:
        _T13.append(time.perf_counter())
    print(f"{msg} [{time.perf_counter() - _T13[0]:.1f} s into [13]]",
          flush=True)


def _rec13_cases():
    """(name, module, cfg, batch): phase 13's recsys gradient cases."""
    from repro_torch.configs.other_archs import DIEN, DIN, MIND, TWO_TOWER
    cut = 1 << REC13_VOCAB_LOG2
    return (("din", "din", DIN, REC_GRAD_BATCH),
            ("dien", "dien", _vocab(DIEN, cut), REC_MODEL_BATCH),
            ("mind", "mind", _vocab(MIND, cut), REC_MODEL_BATCH),
            ("two-tower-retrieval", "towers", _vocab(TWO_TOWER, cut),
             REC_MODEL_BATCH))


def _rec13_batch(cfg, n):
    import numpy as np
    from repro_torch.data import synthetic
    return synthetic.recsys_batch(np.random.default_rng(REC13_SEED), cfg, n)


def _lm13_first_batch():
    """The first batch of ``launch/train.py``'s pipeline (seed 0) at phase
    9's cut: the batch of the whole run's first step."""
    import numpy as np
    from repro_torch.configs.lm_archs import SMOLLM_135M as cfg
    from repro_torch.data import synthetic
    return synthetic.lm_batch(np.random.default_rng(0), cfg, LM_TRAIN_BATCH,
                              LM_TRAIN_SEQ)["tokens"]


def _table_rows(grads: dict, start: dict) -> dict:
    """{table: (global row ids, rows)} of the rows of each table gradient
    that are not all zero (``start``: each table's first global row)."""
    import torch
    out = {}
    for name, g in grads.items():
        nz = torch.nonzero(g.abs().amax(-1) > 0)[:, 0]
        out[name] = ((nz + start.get(name, 0)).cpu().numpy(),
                     g[nz].float().cpu().numpy())
    return out


def rec_grads13(params, batch, cfg, module, pspecs):
    """A rank of phase 13 (b)/(c): the recsys ``loss_fn``'s loss and
    gradient on the rank's rows and batch block, summed by the rule for
    gradients (``reduce_grads``): the dense leaves, whole on every rank,
    and each split table's rows with a gradient, by global row id (every
    rank its own)."""
    from repro_torch import runtime
    from repro_torch.train.train_step import reduce_grads, value_and_grad
    mod = importlib.import_module(module)
    loss, g = value_and_grad(lambda p, b: mod.loss_fn(p, b, cfg), params,
                             batch)
    g = reduce_grads(g, params, pspecs)
    mesh = runtime.current_mesh()
    tables = params["tables"]
    start = {k: t.start for k, t in tables.items()
             if isinstance(t, runtime.RowShard)}
    # a table held whole has its whole gradient on every rank: rank 0's
    rows = _table_rows({k: (v.local if isinstance(v, runtime.RowShard)
                            else v if mesh.rank == 0 else v[:0])
                        for k, v in g["tables"].items()}, start)
    dense = {k: v for k, v in g.items() if k != "tables"}
    return {"loss": float(loss), "rows": rows, "dense": dense}


def lm_grads13(params, tokens, cfg, pspecs):
    """A rank of phase 13 (a): smollm-135m's loss and gradient on the
    rank's parts and batch block, summed by the rule for gradients
    (``reduce_grads``) and gathered whole (rank 0 keeps it)."""
    from repro_torch import runtime
    from repro_torch.launch import sharding
    from repro_torch.models import transformer
    from repro_torch.train.train_step import reduce_grads, value_and_grad
    mesh = runtime.current_mesh()
    loss, g = value_and_grad(lambda p, t: transformer.lm_loss(p, t, cfg),
                             params, tokens)
    g = sharding.gather_tree(reduce_grads(g, params, pspecs), pspecs, mesh)
    return {"loss": float(loss), "grads": g if mesh.rank == 0 else None}


def schnet_steps13(params, batch, cfg, n_graphs, pspecs):
    """A rank of phase 13 (d): SchNet's loss and gradient with the edges
    split over the mesh, then SCHNET_STEPS AdamW steps on the same batch
    (the graph is no batch split: ``batch_axes=()``). Every rank returns
    its own replicated parameters, which must be the same bits on every
    rank."""
    from repro_torch.models import schnet
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import build_train_step, value_and_grad

    def loss_fn(p, b):
        return schnet.batch_loss(p, b, cfg, n_graphs=n_graphs)
    loss, grads = value_and_grad(loss_fn, params, batch)
    step, init = build_train_step(loss_fn, optimizer.adamw(),
                                  param_specs=pspecs, batch_axes=())
    state, losses = init(params), []
    for _ in range(SCHNET_STEPS):
        params, state, l = step(params, state, batch)
        losses.append(float(l))
    return {"loss": float(loss), "grads": grads, "losses": losses,
            "params": params}


def train_whole_run(out_dir: str) -> int:
    """Phase 13's whole runs, by a process of its own before the ranks
    take the card (``python3 chip_smoke.py --train-whole DIR``): on one
    card, smollm-135m's first-step loss and gradient at phase 9's cut;
    each recsys model's loss and gradient (dense leaves, and the table
    rows with a gradient) on the seeded draw the ranks make; SchNet's loss
    and gradient on each shape's seeded draw, then SCHNET_STEPS AdamW
    steps. Writes DIR/*.npz."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    import numpy as np
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.configs.lm_archs import SMOLLM_135M
    from repro_torch.launch import specs
    from repro_torch.models import schnet, transformer
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import build_train_step, value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def leaves(tree):
        return {str(i): t.detach().float().cpu().numpy()
                for i, t in enumerate(tree_lib.leaves(tree))}
    cfg = SMOLLM_135M
    p = transformer.init(torch.Generator(dev).manual_seed(0), cfg, dev)
    loss, g = value_and_grad(lambda q, t: transformer.lm_loss(q, t, cfg), p,
                             torch.as_tensor(_lm13_first_batch(), device=dev))
    np.savez(os.path.join(out_dir, "lm.npz"), loss=float(loss), **leaves(g))
    del p, g
    torch.cuda.empty_cache()
    times = {"lm": time.perf_counter() - t0}

    for name, module, rcfg, n in _rec13_cases():
        t1 = time.perf_counter()
        mod = importlib.import_module(f"repro_torch.models.recsys.{module}")
        p = mod.init(torch.Generator(dev).manual_seed(REC13_SEED), rcfg, dev)
        loss, g = value_and_grad(lambda q, b: mod.loss_fn(q, b, rcfg), p,
                                 _to(_rec13_batch(rcfg, n), dev))
        rows = _table_rows(g["tables"], {})
        out = {"loss": float(loss)}
        for k, (ids, vals) in rows.items():
            out[f"rows/{k}/ids"], out[f"rows/{k}/vals"] = ids, vals
        for path, t in tree_lib.flatten_with_paths(
                {k: v for k, v in g.items() if k != "tables"}):
            out["dense/" + tree_lib.path_name(path)] = \
                t.float().cpu().numpy()
        np.savez(os.path.join(out_dir, f"{name}.npz"), **out)
        del p, g
        torch.cuda.empty_cache()
        times[name] = time.perf_counter() - t1

    for shape in SCHNET_SHAPES:
        t1 = time.perf_counter()
        cell = specs.build_cell("schnet", shape, device=dev)
        p, _, batch = cell.materialize(
            dev, torch.Generator(dev).manual_seed(SCHNET13_SEED))
        n_graphs = batch["targets"].shape[0]
        gcfg = registry.get("schnet").config

        def loss_fn(q, b):
            return schnet.batch_loss(q, b, gcfg, n_graphs=n_graphs)
        loss, g = value_and_grad(loss_fn, p, batch)
        step, init = build_train_step(loss_fn, optimizer.adamw())
        new, state = p, init(p)
        for _ in range(SCHNET_STEPS):
            new, state, _l = step(new, state, batch)
        out = {"loss": float(loss)}
        for pre, tree in (("grad", g), ("param0", p), ("param", new)):
            out.update({f"{pre}/{k}": v for k, v in leaves(tree).items()})
        for k, v in batch["inputs"].items():
            out[f"in/{k}"] = v.cpu().numpy()
        out["targets"] = batch["targets"].cpu().numpy()
        np.savez(os.path.join(out_dir, f"schnet_{shape}.npz"), **out)
        del p, g, new, state, batch
        torch.cuda.empty_cache()
        times[f"schnet_{shape}"] = time.perf_counter() - t1
    print(json.dumps({"seconds": times}), flush=True)
    return 0


def _numbered(d: dict, pre: str) -> list:
    n = sum(1 for k in d if k.startswith(pre + "/"))
    return [d[f"{pre}/{i}"] for i in range(n)]


def _held13(label, got, want, tol) -> float:
    """Leaf by leaf (lists in JAX's order), each at rtol=atol=tol with the
    absolute part scaled by max(1, max|want|) of the leaf (the rule of
    ``tests/test_torch_train.py``); prints the worst leaf."""
    import torch
    check(len(got) == len(want), f"{label}: {len(got)} leaves vs "
          f"{len(want)}")
    worst, worst_used = 0.0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = torch.as_tensor(g).float(), torch.as_tensor(w).float()
        check(g.shape == w.shape, f"{label} leaf {i}: shape {tuple(g.shape)} "
              f"vs {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{label} leaf {i}: non-finite")
        s = max(1.0, float(w.abs().max())) if w.numel() else 1.0
        err, used, ok = verdict(g / s, w / s, tol)
        check(ok, f"{label} leaf {i}: differs from the whole run by "
              f"{err * s} (tol {tol:g} x {s:g})")
        worst, worst_used = max(worst, err * s), max(worst_used, used)
    say13(f"[13] {label}: {len(got)} leaves, max_abs_diff vs the whole run "
          f"{worst:.3e} (rtol=atol={tol:g}, leaf-scaled; allowance used "
          f"{worst_used:.3f}) ok")
    return worst


def _update_held13(label, got, old, want, grads, frac=1e-2) -> float:
    """The update ``got - old`` against the whole run's ``want - old``,
    leaf by leaf, on the elements whose whole-run gradient is at least
    1e-3 of the leaf's largest (AdamW moves them by about lr a step,
    whatever their size): within ``frac`` of the leaf's largest update,
    so that a step skipped, or applied on part of a leaf, fails."""
    import torch
    worst = 0.0
    for i, (g, o, w, gr) in enumerate(zip(got, old, want, grads)):
        g, o, w, gr = (torch.as_tensor(t).float() for t in (g, o, w, gr))
        if not float(gr.abs().max()) > 0:
            continue
        big = gr.abs() >= 1e-3 * float(gr.abs().max())
        du, dw = (g - o)[big], (w - o)[big]
        room = frac * float(dw.abs().max())
        err = float((du - dw).abs().max())
        check(room > 0 and err <= room, f"{label} leaf {i}: update off by "
              f"{err} (room {room})")
        worst = max(worst, err / room)
    say13(f"[13] {label}: every leaf's update within {frac:g} of its "
          f"largest (allowance used {worst:.3f}) ok")
    return worst


def _coll_line(rows: dict) -> str:
    """Collectives by kind (forward, ``/bwd``, ``/recompute``) with calls
    and output bytes."""
    from repro_torch.launch import op_analysis
    by = op_analysis.collectives_by_kind(rows)
    return "; ".join(f"{k} x{v['calls']} {v['bytes']} B"
                     for k, v in sorted(by.items()))


def train_mesh_run(card: str, lm_losses) -> dict:
    """Phase 13: training on the 2x2 (data, model) mesh of 4 gloo ranks
    sharing the one card. Whole runs first, by a process of their own
    (:func:`train_whole_run`; the LM's losses are phase 9's run of the
    same draws). One launch: (a) smollm-135m's first-step loss and every
    gradient leaf at published widths, S=4096, 8 sequences; (b) DIN at
    published widths and vocabularies, B=4,096; (c) DIEN, MIND and
    two-tower at phase 4's widths (tables 2^16), B=1,024; (d) SchNet at
    published widths on three shapes, loss, gradients and 5 ZeRO-free
    AdamW steps, every rank's losses and parameters the same bits. Then
    ``launch/train.py --mesh 2x2`` for smollm-135m (LM_MESH13_STEPS
    steps, a checkpoint every LM_MESH13_EVERY, then a resume on the
    mesh) and (e) ``run_cell`` on the mesh; (f) deepseek-v3's training
    layout, ZeRO-3 against ZeRO-2 (:func:`ds13f_rank`), the last job of
    (a)-(d)'s launch. Returns the kernels' launches over (b), (c) and
    (e)'s DIN cell, all ranks."""
    import argparse
    import numpy as np
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.configs.lm_archs import SMOLLM_135M
    from repro_torch.launch import dryrun, sharding
    from repro_torch.launch.mesh import Job, ModelDraw, abstract_mesh, run_jobs
    from repro_torch.launch.sharding import P
    from repro_torch.launch.train import train
    from repro_torch.models import schnet, transformer
    from repro_torch.train import checkpoint

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--train-whole", tmp], capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0, "the whole runs failed:\n"
              + (proc.stdout + proc.stderr)[-4000:])
        whole = {f[:-4]: dict(np.load(os.path.join(tmp, f)))
                 for f in os.listdir(tmp) if f.endswith(".npz")}
        say13(f"[13] whole runs on one card by one process ({card}): "
              f"{time.perf_counter() - t0:.1f} s; "
              + proc.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    am = abstract_mesh(MESH_SHAPE, MESH_AXES)
    cfg = SMOLLM_135M
    meta = transformer.init(torch.Generator(), cfg,
                            device=torch.device("meta"))
    pspecs = sharding.lm_param_specs(meta, cfg, am)
    jobs = {"lm": Job(
        "chip_smoke:lm_grads13",
        ModelDraw("repro_torch.models.transformer", cfg, 0), None,
        (_lm13_first_batch(),), (P("data", None),),
        {"cfg": cfg, "pspecs": pspecs})}
    for name, module, rcfg, n in _rec13_cases():
        path = f"repro_torch.models.recsys.{module}"
        rmeta = importlib.import_module(path).init(
            torch.Generator(), rcfg, device=torch.device("meta"))
        batch = _rec13_batch(rcfg, n)
        bspec = tree_lib.tree_map(
            lambda a: sharding.batched_spec(am, np.shape(a)), batch)
        jobs[name] = Job("chip_smoke:rec_grads13",
                         ModelDraw(path, rcfg, REC13_SEED), None,
                         (batch,), (bspec,),
                         {"cfg": rcfg, "module": path,
                          "pspecs": sharding.recsys_param_specs(rmeta, rcfg,
                                                                am)},
                         check_kernels=True)
    gcfg = registry.get("schnet").config
    for shape in SCHNET_SHAPES:
        w = whole[f"schnet_{shape}"]
        tmpl = schnet.init(torch.Generator(), gcfg,
                           w["in/node_feat"].shape[1] if "in/node_feat" in w
                           else None, device=torch.device("meta"))
        params = tree_lib.unflatten(tmpl, _numbered(w, "param0"))
        batch = {"inputs": {k[3:]: v for k, v in w.items()
                            if k.startswith("in/")}, "targets": w["targets"]}
        gspecs = sharding.gnn_param_specs(tmpl, gcfg, am)
        jobs[f"schnet/{shape}"] = Job(
            "chip_smoke:schnet_steps13", params, gspecs, (batch,), (None,),
            {"cfg": gcfg, "n_graphs": len(w["targets"]), "pspecs": gspecs})
    # (f) deepseek-v3's training layout, last: it takes the most memory
    jobs["ds13f"] = Job("chip_smoke:ds13f_rank")
    t0 = time.perf_counter()
    ranks = run_jobs(list(jobs.values()), MESH_SHAPE, MESH_AXES,
                     device="cuda", timeout=900)
    out = {k: [r[i] for r in ranks] for i, k in enumerate(jobs)}
    say13(f"[13a-d,f] the ranks' launch: {time.perf_counter() - t0:.1f} s")

    # (a) the LM's first step
    lm = out["lm"]
    r0 = lm[0]["out"]
    for r, rank in enumerate(lm):
        compare(f"[13a] rank {r} step-1 loss",
                torch.tensor([rank["out"]["loss"]]),
                torch.tensor([float(whole["lm"]["loss"])]), TOL_LM)
    _held13(f"{cfg.name} step-1 gradient (gathered)",
            tree_lib.leaves(r0["grads"]),
            [whole["lm"][str(i)] for i in range(len(tree_lib.leaves(
                r0["grads"])))], TOL_LM)
    say13(f"[13a] one loss and gradient on the mesh, rank collectives "
          f"(forward, backward /bwd, remat /recompute; the gradient's "
          f"gather included): {_coll_line(lm[0]['collectives'])}")

    # (b), (c): recsys gradients; B2 / B3 / B4 on every rank, replayed
    launches: dict = {}
    for name, module, rcfg, n in _rec13_cases():
        ranks_ = out[name]
        w = whole[name]
        for r, rank in enumerate(ranks_):
            compare(f"[13] {name} rank {r} loss",
                    torch.tensor([rank["out"]["loss"]]),
                    torch.tensor([float(w["loss"])]), TOL_MODEL)
            check(rank["launches"] == REC13_LAUNCHES[name],
                  f"{name} rank {r}: launches {rank['launches']}, expected "
                  f"{REC13_LAUNCHES[name]}")
            for k, v in rank["launches"].items():
                launches[k] = launches.get(k, 0) + v
        dense = ranks_[0]["out"]["dense"]
        # the replicated dense leaves' gradient: the same bits on every rank
        for r, rank in enumerate(ranks_[1:], 1):
            check(rank["out"]["loss"] == ranks_[0]["out"]["loss"] and all(
                np.array_equal(a, b) for a, b in zip(
                    tree_lib.leaves(rank["out"]["dense"]),
                    tree_lib.leaves(dense))),
                f"{name} rank {r}: loss or dense gradient differs from "
                f"rank 0's")
        names = ["dense/" + tree_lib.path_name(p)
                 for p, _ in tree_lib.flatten_with_paths(dense)]
        _held13(f"{name} B={n} dense gradient", tree_lib.leaves(dense),
                [w[k] for k in names], TOL_MODEL)
        # the table rows: each row's gradient is summed on its owner
        worst = 0.0
        for table in sorted({k.split("/")[1] for k in w
                             if k.startswith("rows/")}):
            ids = np.concatenate([rk["out"]["rows"][table][0]
                                  for rk in ranks_])
            vals = np.concatenate([rk["out"]["rows"][table][1]
                                   for rk in ranks_])
            order = np.argsort(ids, kind="stable")
            want_ids = w[f"rows/{table}/ids"]
            check(np.array_equal(ids[order], want_ids),
                  f"{name} {table}: rows with a gradient differ "
                  f"({len(ids)} vs {len(want_ids)})")
            diff = float(np.abs(vals[order] - w[f"rows/{table}/vals"]).max(
                initial=0.0))
            worst = max(worst, diff)
        say13(f"[13] {name}: the 4 ranks' loss and dense gradient bit for "
              f"bit the same")
        say13(f"[13] {name} table rows with a gradient: max_abs_diff vs the "
              f"whole run {worst:.3e} ({'bit for bit' if worst == 0 else 'not bit for bit'})")
        check(worst <= TOL_MODEL, f"{name}: table-row gradient off by {worst}")
        mesh_kernel_checks(name, [rk["kernel_checks"] for rk in ranks_],
                           "[13]", per_call=False)
        _rank_lines13(name, ranks_)

    # (d) SchNet
    for shape in SCHNET_SHAPES:
        w = whole[f"schnet_{shape}"]
        ranks_ = [rk["out"] for rk in out[f"schnet/{shape}"]]
        got = ranks_[0]
        # every rank computes the same loss and holds the same replicated
        # parameters, bit for bit, after every step
        for r, rank in enumerate(ranks_[1:], 1):
            check([rank["loss"]] + rank["losses"]
                  == [got["loss"]] + got["losses"],
                  f"schnet {shape} rank {r}: losses {rank['losses']} vs "
                  f"rank 0's {got['losses']}")
            check(all(np.array_equal(a, b) for a, b in zip(
                tree_lib.leaves(rank["params"]),
                tree_lib.leaves(got["params"]))),
                f"schnet {shape} rank {r}: parameters after "
                f"{SCHNET_STEPS} steps differ from rank 0's")
        say13(f"[13d] schnet {shape}: the 4 ranks' losses "
              f"{[got['loss']] + got['losses']} and parameters after "
              f"{SCHNET_STEPS} AdamW steps bit for bit the same")
        # the loss leaf-scaled, as phase 10 holds SchNet's loss card vs
        # CPU: at minibatch_lg it is ~3e8, a square of per-graph sums of
        # ~1e5 atoms in float32, whose order differs from the run whole's
        # (2.2e-5 of it, the same on every rank, on the H100)
        _held13(f"schnet {shape} loss", [torch.tensor([got["loss"]])],
                [torch.tensor([float(w["loss"])])], TOL_MODEL)
        say13(f"[13d] schnet {shape} loss {got['loss']!r} vs the whole run's "
              f"{float(w['loss'])!r}: off by "
              f"{abs(got['loss'] - float(w['loss'])) / abs(float(w['loss'])):.3e}"
              f" of it")
        _held13(f"schnet {shape} gradient", tree_lib.leaves(got["grads"]),
                _numbered(w, "grad"), TOL_MODEL)
        _held13(f"schnet {shape} params after {SCHNET_STEPS} AdamW steps",
                tree_lib.leaves(got["params"]), _numbered(w, "param"),
                TOL_LM)
        _update_held13(f"schnet {shape} update over {SCHNET_STEPS} steps",
                       tree_lib.leaves(got["params"]), _numbered(w, "param0"),
                       _numbered(w, "param"), _numbered(w, "grad"))
        _rank_lines13(f"schnet {shape}", out[f"schnet/{shape}"])
    _ds13f_held(out["ds13f"], card)
    del out, ranks, whole

    # (a) the launcher on the mesh, then a resume
    ckpt_dir = tempfile.mkdtemp(prefix="lm_train_mesh_")
    try:
        def args(steps, mesh="2x2"):
            return argparse.Namespace(
                arch=cfg.name, shape="train_4k", steps=steps, mesh=mesh,
                multi_pod=False, reduced=False, ckpt_dir=ckpt_dir,
                ckpt_every=LM_MESH13_EVERY, batch=LM_TRAIN_BATCH,
                n_micro=LM_TRAIN_MICRO)
        t0 = time.perf_counter()
        fig = train(args(LM_MESH13_STEPS), device="cuda")
        say13(f"[13a] launch/train.py --mesh 2x2: {LM_MESH13_STEPS} steps, a "
              f"checkpoint every {LM_MESH13_EVERY}, in "
              f"{time.perf_counter() - t0:.1f} s; losses {fig['losses']}")
        compare("[13a] the mesh run's losses vs phase 9's whole run",
                torch.tensor(fig["losses"]),
                torch.tensor(lm_losses[:LM_MESH13_STEPS]), TOL_LM)
        for r, rk in enumerate(fig["ranks"]):
            say13(f"[13a] rank {r}: {rk['ms_per_step']:.1f} ms/step over "
                  f"steps 2..{LM_MESH13_STEPS} (each {rk['step_s']} s), peak "
                  f"{rk['max_allocated_bytes'] / 2**30:.2f} GiB")
        say13(f"[13a] slowest rank {max(r['ms_per_step'] for r in fig['ranks']):.1f} "
              f"ms/step (4 ranks sharing one card over gloo; phase 9's "
              f"whole run is the one-card figure)")
        # the mesh's checkpoint restored by one device
        saved, _ = checkpoint.restore(fig["latest"], fig["params"])
        same = all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(saved), tree_lib.leaves(fig["params"])))
        check(same, "the mesh's checkpoint restored by one device differs "
              "from the mesh's params")
        del saved
        # the resume on the mesh: each rank restores its part
        # (``restore(..., shardings=)``) and trains on
        t0 = time.perf_counter()
        again = train(args(LM_RESUME_STEPS), device="cuda")
        check(again["start_step"] == LM_MESH13_STEPS,
              f"resume started at {again['start_step']}")
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            tree_lib.leaves(again["restored"]), tree_lib.leaves(fig["params"])))
        check(same, "the parameters the mesh resumed from differ from the "
              "mesh's parameters")
        say13(f"[13a] resume on the mesh in {time.perf_counter() - t0:.1f} s: "
              f"restore {again['restore_s']} s, the checkpoint restored bit "
              f"for bit; resumed loss {again['losses']}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the training cells on the mesh
    for arch, shape, kernels in CELL13:
        rec = dryrun.run_cell(arch, shape, device="cuda", mesh=MESH_SHAPE,
                              check_kernels=bool(kernels),
                              steps=CELL13_STEPS, warmup=1)
        LIVE_RECORDS[(arch, shape)] = rec
        mem = rec.get("memory", {})
        say13(f"[13e] {arch} x {shape} on {rec['mesh']}@1xH100 ({card}): ok "
              f"{rec['ok']}, fits a rank's share {mem.get('fits_per_rank')} "
              f"(estimate {mem.get('estimate_bytes_per_rank')} bytes), "
              f"{rec.get('t_total_s')} s; {rec.get('error', '')}")
        if not mem.get("fits_per_rank"):
            check(arch == "smollm-135m" or shape == "ogb_products",
                  f"{arch} x {shape} does not fit a rank's share")
            continue
        check(rec["ok"], f"{arch} x {shape} on the mesh: {rec.get('error')}\n"
              f"{rec.get('traceback', '')}")
        check(bool(np.isfinite(rec["output"][0])), f"{arch} x {shape}: loss")
        if kernels:
            checked = mesh_kernel_checks(f"{arch} x {shape}",
                                         rec["kernel_checks"], "[13]",
                                         per_call=False)
            check(checked == set(kernels), f"{arch} x {shape}: kernels "
                  f"checked {sorted(checked)}")
        for r in rec["ranks"]:
            for name in kernels:
                n = r["launches_per_step"].get(name, 0)
                check(n == 1, f"{arch} x {shape} rank {r['rank']}: {name} "
                      f"launched {n} times a step, expected 1")
                launches[name] = launches.get(name, 0) + n
            coll = "; ".join(f"{k} x{v['calls']} {v['bytes']} B"
                             for k, v in sorted(
                                 r["collectives_per_step"].items()))
            say13(f"[13e] {arch} x {shape} rank {r['rank']}: "
                  f"{r['step_ms']:.2f} ms a step, peak "
                  f"{r['max_allocated_bytes'] / 2**30:.2f} GiB, loss "
                  f"{float(rec['output'][0]):.6f}, collectives {coll}")
    return launches


#: (f): deepseek-v3-671b at published widths, cut to DS13F_LAYERS layers
#: (DS13F_DENSE dense, then MoE; from 61) and DS13F_EXPERTS routed experts
#: (from 256), S=DS13F_SEQ, one sequence a data rank, one step
DS13F_LAYERS, DS13F_DENSE, DS13F_EXPERTS = 2, 1, 16
DS13F_SEQ, DS13F_BATCH, DS13F_SEED = 4096, 2, 24
#: (f)'s cell: its key in LIVE_RECORDS and its dry record's name
DS13F = ("deepseek-v3-671b", "train_13f")


def ds13f_cell(zero3: bool, mesh, device="cuda"):
    """(f)'s training cell on ``mesh``: the reference's layout (the
    ZeRO-3 parameters by ``zero_specs`` at its published 2^20 minimum,
    the residual split over ``model``, remat on, Adafactor) or, with
    ``zero3`` False, the ZeRO-2 layout with the whole residual
    (``fsdp_params`` and ``shard_carry`` off)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.lm_archs import DEEPSEEK_V3
    from repro_torch.launch import specs
    cfg = dataclasses.replace(
        DEEPSEEK_V3, n_layers=DS13F_LAYERS, moe=dataclasses.replace(
            DEEPSEEK_V3.moe, n_routed=DS13F_EXPERTS,
            n_dense_layers=DS13F_DENSE))
    if not zero3:
        cfg = dataclasses.replace(cfg, fsdp_params=False, shard_carry=False)
    shape = ShapeSpec(DS13F[1], "train", {"seq_len": DS13F_SEQ,
                                          "global_batch": DS13F_BATCH})
    return specs.build_lm_cell(registry.ArchDef(DS13F[0], "lm", cfg, (),
                                                None), shape, device,
                               mesh=mesh)


def _nodes13f(tree) -> list:
    """Each leaf's innermost node in JAX's order: its DataShard, else the
    leaf."""
    from repro_torch import runtime
    if isinstance(tree, runtime.DataShard):
        return [tree]
    if isinstance(tree, runtime.RowShard):
        return _nodes13f(tree.local)
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _nodes13f(tree[k])]
    return [tree]


def ds13f_rank(params=None):
    """A rank of (f): the step in the reference's layout, then in the
    ZeRO-2 layout with the whole residual, on the same draws, each under
    the op counter (the ZeRO-3 step's count is the live record [14a]
    holds the dry count to): each step's loss, ms (CUDA events),
    peak (``max_memory_allocated`` from its drawn arguments on) and
    collectives, all of them and those after its loss and gradient;
    every ZeRO-3 block's shape
    against its spec's; and every updated parameter of the ZeRO-3 step
    against the ZeRO-2 step's at TOL_LM, leaf-scaled, leaf by leaf over
    the whole leaf (each rank holds its block of the ZeRO-2 rank's part;
    the largest |want|, the worst difference and the elements off are
    reduced over every rank)."""
    import torch
    from repro_torch import runtime
    from repro_torch import tree as tree_lib
    from repro_torch.launch import op_analysis, sharding
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.runtime import CollectiveCounts
    from repro_torch.train import train_step
    mesh = runtime.current_mesh()
    am = abstract_mesh(mesh.dims, mesh.axis_names)
    dev = torch.device("cuda", torch.cuda.current_device())
    # cuBLAS and the collectives' first use, before either step is timed
    w = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
    runtime.all_reduce((w @ w).float(), mesh.axis_names)
    torch.cuda.synchronize()
    out, kept = {}, None
    marks, grad = [], train_step.value_and_grad

    def marked(*a, **kw):
        got = grad(*a, **kw)
        marks.append(mesh.counts.snapshot())
        return got
    train_step.value_and_grad = marked
    try:
        for zero3 in (True, False):
            cell = ds13f_cell(zero3, am)
            gc.collect()
            torch.cuda.empty_cache()
            args = cell.materialize(dev, torch.Generator(device=dev)
                                    .manual_seed(DS13F_SEED), mesh=mesh)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            run = {"arg_bytes": torch.cuda.memory_allocated(dev)}
            before, marks[:] = mesh.counts.snapshot(), []
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (new_p, new_s, loss), ops = op_analysis.count_ops(
                lambda: cell.fn(*args))
            end.record()
            torch.cuda.synchronize()
            run["ms"] = start.elapsed_time(end)
            run["peak"] = torch.cuda.max_memory_allocated(dev)
            after = mesh.counts.snapshot()
            run["collectives"] = CollectiveCounts.since(after, before)
            run["post"] = CollectiveCounts.since(after, marks[0])
            run["loss"] = float(loss)
            del args
            if zero3:
                out["ops"] = ops
                specs_ = []
                tree_lib.tree_map(lambda _l, s: specs_.append(s),
                                  cell.args[0], cell.in_specs[0])
                blocks = []
                for whole, spec, node in zip(tree_lib.leaves(cell.args[0]),
                                             specs_, _nodes13f(new_p)):
                    want = tuple(sharding.local_part(whole, spec, mesh).shape)
                    z3 = isinstance(spec, sharding.Gathered)
                    blocks.append(z3 == isinstance(node, runtime.DataShard)
                                  and tuple(tree_lib.leaves(node)[0].shape)
                                  == want)
                run["blocks_ok"], run["n_zero3"] = all(blocks), sum(
                    isinstance(s, sharding.Gathered) for s in specs_)
                kept = ([t.cpu() for t in tree_lib.leaves(new_p)], specs_)
                del new_p, new_s
            else:
                worst, off, n, same, rows = 0.0, 0, 0, 0, []
                names = [tree_lib.path_name(p_) for p_, _ in
                         tree_lib.flatten_with_paths(cell.args[0])]
                for name, got, spec, want in zip(names, kept[0], kept[1],
                                                 tree_lib.leaves(new_p)):
                    if isinstance(spec, sharding.Gathered):
                        d = spec.data_dim
                        s0, per = runtime.block(want.shape[d], "data")
                        want = want.narrow(d, s0, per)
                    got, want = got.to(dev).float(), want.float()
                    top = runtime.all_reduce(want.abs().amax().reshape(1),
                                             mesh.axis_names, op="max")
                    scale = max(1.0, float(top))
                    diff = (got - want).abs()
                    bad = (diff > TOL_LM * scale + TOL_LM * want.abs()).sum()
                    stats = torch.stack([diff.amax(), bad.float()])
                    top = float(runtime.all_reduce(
                        stats[:1].clone(), mesh.axis_names, op="max")) / scale
                    k = int(runtime.all_reduce(stats[1:].clone(),
                                               mesh.axis_names))
                    worst, off, n = max(worst, top), off + k, n + 1
                    same += top == 0
                    rows.append((top, k, name))
                out.update(worst=worst, off=off, leaves=n, same=same,
                           worst_leaves=sorted(rows)[-3:])
                del new_p, new_s, kept
            out["zero3" if zero3 else "zero2"] = run
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        train_step.value_and_grad = grad
    return out


def _ds13f_held(rows: list, card: str):
    """(f)'s checks and lines from its ranks' rows; the live record [14a]
    holds the dry count to."""
    import torch
    z3_peaks = []
    for r, row in enumerate(rows):
        got = row["out"]
        z3, z2 = got["zero3"], got["zero2"]
        compare(f"[13f] rank {r} loss, ZeRO-3 and split carry vs ZeRO-2 and "
                f"whole carry", torch.tensor([z3["loss"]]),
                torch.tensor([z2["loss"]]), TOL_LM)
        check(got["off"] == 0, f"[13f] rank {r}: {got['off']} updated "
              f"parameter elements off TOL_LM (worst leaf-scaled "
              f"{got['worst']:.3e}; the worst leaves (difference, elements "
              f"off, name) {got['worst_leaves']})")
        check(z3["blocks_ok"], f"[13f] rank {r}: a ZeRO-3 block's shape or "
              f"node differs from its spec's")
        check(z3["peak"] < z2["peak"], f"[13f] rank {r}: ZeRO-3 peak "
              f"{z3['peak']} not below ZeRO-2's {z2['peak']}")
        post3 = {k for (k, _g) in z3["post"]}
        post2 = {k for (k, _g) in z2["post"]}
        check("all_gather" not in post3 and "all_gather" in post2,
              f"[13f] rank {r}: after the backward ZeRO-3 ran {post3}, "
              f"ZeRO-2 {post2}")
        say13(f"[13f] rank {r} ({card}): loss {z3['loss']!r} (ZeRO-3, split carry) vs "
              f"{z2['loss']!r} (ZeRO-2, whole carry); {got['leaves']} updated "
              f"leaves ({got['same']} bit for bit), largest leaf-scaled "
              f"difference {got['worst']:.3e} "
              f"(TOL_LM {TOL_LM:g}); {z3['n_zero3']} ZeRO-3 leaves, every "
              f"block its spec's shape")
        for name, run in (("ZeRO-3", z3), ("ZeRO-2", z2)):
            say13(f"[13f] rank {r} {name}: {run['ms']:.1f} ms a step (its "
                  f"first, under the op counter), peak "
                  f"{run['peak'] / 2**30:.2f} GiB "
                  f"({run['arg_bytes'] / 2**30:.2f} GiB allocated after the "
                  f"draw), "
                  f"collectives {_coll_line(run['collectives'])}; after the "
                  f"loss and gradient: {_coll_line(run['post'])}")
        z3_peaks.append(z3["peak"])
    LIVE_RECORDS[DS13F] = {"ranks": [
        {"rank": r, "ops": row["out"]["ops"], "max_allocated_bytes": peak}
        for r, (row, peak) in enumerate(zip(rows, z3_peaks))]}


def _rank_lines13(label, ranks_):
    for r, rank in enumerate(ranks_):
        say13(f"[13] {label} rank {r}: launches {rank['launches']}, "
              f"collectives {_coll_line(rank['collectives'])}")


# ----------------------------------------------------------------- phase 14

#: (a): the 2x2 cells that [11c], [12] and [13e] run live on the card,
#: counted again for all 4 ranks on the meta device (``dry_run_cell``)
#: and held rank by rank to the live records
DRY_MESH_CELLS = (("din", "serve_p99"), ("din", "retrieval_cand"),
                  ("dien", "serve_p99"), ("smollm-135m", "long_500k"),
                  ("deepseek-v2-lite-16b", "long_500k"),
                  ("din", "train_batch"))
#: (b): one cell a family by the CLI's ``--production`` and
#: ``--production --multi-pod``
DRY_PRODUCTION = (("din", "serve_p99"), ("schnet", "molecule"),
                  ("smollm-135m", "decode_32k"))
#: the live records of DRY_MESH_CELLS, kept by the phases that run them
LIVE_RECORDS: dict = {}
#: seconds [14] waits for its process at the end of the call
DRY_JOIN_S = 300


def dry_run(out_dir: str) -> int:
    """Phase 14's meta-device work, in a process of its own that the call
    starts first (CUDA hidden from it: it touches no card): (a)
    ``dry_run_cell`` of every DRY_MESH_CELLS cell on the 2x2 mesh for
    all 4 ranks, at published widths, and [13f]'s cell
    (:func:`ds13f_dry`); (b) ``python -m
    repro_torch.launch.dryrun --production [--multi-pod]`` for every
    DRY_PRODUCTION cell. Records and ``times.json`` under ``out_dir``."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    sys.path.insert(0, src)
    os.nice(10)                   # the phases on the card come first
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    times = {}
    t0 = time.perf_counter()
    for arch, shape in DRY_MESH_CELLS:
        dryrun.dry_run_cell(arch, shape, out_dir=out_dir, mesh=MESH_SHAPE,
                            ranks=range(4))
    ds13f_dry(out_dir)
    times["a"] = time.perf_counter() - t0
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    for arch, shape in DRY_PRODUCTION:
        for extra in ([], ["--multi-pod"]):
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--production", "--out", out_dir,
                 *extra], capture_output=True, text=True, env=env,
                timeout=600)
            times[f"{arch}/{shape}{'/multi-pod' if extra else ''}"] = \
                proc.returncode
    times["b"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "times.json"), "w") as f:
        json.dump(times, f)
    return 0


def ds13f_dry(out_dir: str):
    """[13f]'s ZeRO-3 cell counted for each rank of the 2x2 mesh on the
    meta device (``dryrun.dry_count``), written as ``dry_run_cell``
    writes a record."""
    import traceback
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh, dry_mesh
    rec = {"arch": DS13F[0], "shape": DS13F[1], "ok": False, "ranks": []}
    try:
        cell = ds13f_cell(True, abstract_mesh(MESH_SHAPE, MESH_AXES), "meta")
        for r in range(math.prod(MESH_SHAPE)):
            row = dryrun.dry_count(cell, dry_mesh(MESH_SHAPE, MESH_AXES, r))
            rec["ranks"].append({**row, "rank": r})
        rec["bounded_kernel_counts"] = {
            k: v for r in rec["ranks"] for k, v in r["bounded_kernels"].items()}
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — recorded; [14a] fails on it
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    with open(os.path.join(out_dir, f"{DS13F[0]}__{DS13F[1]}__2x2@meta.json"),
              "w") as f:
        json.dump(rec, f, default=str)


def start_dry(out_dir: str):
    """:func:`dry_run` in a process of its own (``--dry``), its output to
    a file in ``out_dir``."""
    log = open(os.path.join(out_dir, "dry.log"), "w")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dry", out_dir],
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def stop_dry(proc):
    """Kill the dry process and the CLI runs it started (its session)."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _split_bounded(summary: dict, bounded) -> tuple:
    """(flops, bytes) of a count outside the kernels in ``bounded``, and
    those kernels' {name: (flops, bytes)}."""
    kern = {k: (v["flops"], v["bytes"]) for k, v in
            summary["kernels"].items() if k in bounded}
    return (summary["flops_per_device"] - sum(f for f, _ in kern.values()),
            summary["bytes_per_device"] - sum(b for _, b in kern.values()),
            kern)


def dry_check(proc, out_dir: str, card: str):
    """Phase 14: join the dry process, then (a) hold every rank's dry count
    of each DRY_MESH_CELLS cell to its live record: collectives by kind
    (calls, bytes), kernel launches, flops and bytes exactly outside the
    kernels whose dry cost is a bound (``bounded_kernel_counts``), those
    at least the live count (the excess printed); the dry peak against
    ``max_memory_allocated`` as a ratio; (b) every production record ok,
    its argument bytes those of ``arg_bytes_per_device``, with its GB a
    device, fit, flops and collective traffic by kind."""
    from repro_torch.launch import roofline
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=DRY_JOIN_S)
    except subprocess.TimeoutExpired:
        stop_dry(proc)
        rc = None
    log = open(os.path.join(out_dir, "dry.log")).read()
    check(rc == 0, f"the dry process exited {rc}:\n{log[-4000:]}")
    times = json.load(open(os.path.join(out_dir, "times.json")))
    print(f"[14] dry process (meta device, no card) joined after "
          f"{time.perf_counter() - t0:.1f} s of waiting; (a) took "
          f"{times['a']:.1f} s, (b) {times['b']:.1f} s", flush=True)

    def load(arch, shape, mesh):
        with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh}@meta.json")
                  ) as f:
            return json.load(f)

    for arch, shape in DRY_MESH_CELLS + (DS13F,):
        dry = load(arch, shape, "2x2")
        check(dry["ok"], f"[14a] {arch} x {shape} dry: {dry.get('error')}\n"
              f"{dry.get('traceback', '')}")
        live = LIVE_RECORDS[(arch, shape)]
        bounded = set(dry["bounded_kernel_counts"])
        for lr, dr in zip(live["ranks"], dry["ranks"]):
            r, ops = lr["rank"], lr["ops"]
            coll = {k: (v["calls"], v["bytes"])
                    for k, v in dr["collectives_by_kind"].items()}
            want = {k: (v["calls"], v["bytes"])
                    for k, v in ops["collectives_by_kind"].items()}
            check(coll == want, f"[14a] {arch} x {shape} rank {r}: dry "
                  f"collectives {coll}, live {want}")
            got = {k: v["launches"] for k, v in dr["kernels"].items()}
            want = {k: v["launches"] for k, v in ops["kernels"].items()}
            check(got == want, f"[14a] {arch} x {shape} rank {r}: dry "
                  f"kernel calls {got}, live launches {want}")
            df, db, dk = _split_bounded(dr, bounded)
            lf, lb, lk = _split_bounded(ops, bounded)
            check(df == lf and db == lb, f"[14a] {arch} x {shape} rank {r}: "
                  f"outside the bounded kernels dry flops {df} bytes {db}, "
                  f"live {lf} and {lb}")
            excess = {}
            for k, (f, b) in dk.items():
                check(f >= lk[k][0] and b >= lk[k][1],
                      f"[14a] {arch} x {shape} rank {r}: {k}'s bound "
                      f"{(f, b)} below the live count {lk[k]}")
                excess[k] = (f - lk[k][0], b - lk[k][1])
            print(f"[14a] {arch} x {shape} rank {r}: dry = live ({card}): "
                  f"{df:.6g} flops and {db:.6g} bytes outside the bounded "
                  f"kernels, collectives (calls, bytes) {coll}, kernel calls "
                  f"{got}; bounds' excess (flops, bytes) {excess}; dry peak "
                  f"{dr['peak_bytes_per_device'] / 2**30:.3f} GiB / "
                  f"max_memory_allocated "
                  f"{lr['max_allocated_bytes'] / 2**30:.3f} GiB = "
                  f"{dr['peak_bytes_per_device'] / lr['max_allocated_bytes']:.3f}"
                  f"; dry count {dr['t_count_s']} s", flush=True)
    for arch, shape in DRY_PRODUCTION:
        for mesh in ("16x16", "2x16x16"):
            rec = load(arch, shape, mesh)
            check(rec["ok"], f"[14b] {arch} x {shape} on {mesh}: "
                  f"{rec.get('error')}\n{rec.get('traceback', '')}")
            mem = rec["memory"]
            check(mem["argument_bytes_per_device"] ==
                  rec["arg_bytes_per_device"],
                  f"[14b] {arch} x {shape} on {mesh}: argument bytes "
                  f"{mem['argument_bytes_per_device']} vs "
                  f"arg_bytes_per_device {rec['arg_bytes_per_device']}")
            row = roofline.analyze_row(rec)
            coll = ", ".join(f"{k} {v['traffic_bytes']:.6g} B"
                             for k, v in sorted(
                                 rec["ops"]["collectives_by_kind"].items()))
            print(f"[14b] {arch} x {shape} on {mesh} (counted on the meta "
                  f"device, not timed): ranks {[x['rank'] for x in rec['ranks']]}, "
                  f"{mem['peak_bytes_per_device'] / 1e9:.4g} GB a device, "
                  f"fits_h100 {mem['fits_h100']}, "
                  f"{rec['ops']['flops_per_device']:.6g} flops, collective "
                  f"traffic {coll or 'none'}; modelled dominant "
                  f"{row['dominant']}, modelled_frac "
                  f"{row['modelled_frac']:.3f}; {rec['t_count_s']} s",
                  flush=True)


# --------------------------------------------------------------------- main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("FAIL: src/repro_torch not found beside chip_smoke.py", flush=True)
        return 1
    sys.path.insert(0, src)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    print(f"[1] {card}", flush=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"capability {cap}", flush=True)
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0)")
    # [14]'s meta-device work needs no card: it runs beside the rest
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dry_")
    dry = start_dry(dry_dir)
    try:
        return _main(card, dry, dry_dir)
    finally:
        stop_dry(dry)
        shutil.rmtree(dry_dir, ignore_errors=True)


def _main(card: str, dry, dry_dir: str) -> int:
    import torch
    from repro_torch import kernels as K
    t0 = time.perf_counter()
    lib = K.build()
    K.library()
    print(f"[2] built {lib.name} from {len(K.sources())} sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    usage = ptxas_usage((lib.parent / "build.log").read_text())
    for name, u in usage:
        print(f"[2] ptxas {name}: {u['registers']} registers, {u['smem']} "
              f"bytes static smem, {u['stack']} bytes stack, spill stores "
              f"{u['spill_stores']} / loads {u['spill_loads']} bytes",
              flush=True)
    # the redesigned B4 recurrence keeps U in registers: a spill would put
    # it in local memory
    for name, u in usage:
        if name in NO_SPILL:
            check(u["spill_stores"] == u["spill_loads"] == 0,
                  f"{name} spills {u['spill_stores']} bytes")
    check(set(NO_SPILL) <= {name for name, _ in usage},
          f"ptxas printed no usage for {NO_SPILL}")

    # the cube's memory-mapped blocks go to a directory removed on exit
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    tempfile.tempdir = tmp
    t_run = time.perf_counter()
    try:
        results: dict = {}
        kernel_checks(results)
        print(f"[3] done at {time.perf_counter() - t_run:.1f} s", flush=True)
        model_check()
        print(f"[4] done at {time.perf_counter() - t_run:.1f} s", flush=True)
        service_run()
        print(f"[5] done at {time.perf_counter() - t_run:.1f} s", flush=True)
        counts = multi_service_run()
        print(f"[6] done at {time.perf_counter() - t_run:.1f} s", flush=True)
        counts["flash_decode"] = lm_service_run()
        counts["mla_decode"] = results["mla_decode"]["launches"]
        print(f"[7] done at {time.perf_counter() - t_run:.1f} s", flush=True)
        durability_run()
        print(f"[8] done at {time.perf_counter() - t_run:.1f} s", flush=True)
        lm_losses = lm_train_run()
        backward = rec_train_run()
        print(f"[9] done at {time.perf_counter() - t_run:.1f} s", flush=True)
        gnn_run()
        sweep = cell_sweep()
        print(f"[10] done at {time.perf_counter() - t_run:.1f} s; kernel "
              f"launches over the cell sweep {sweep}", flush=True)
        mesh_launches = mesh_models_run(card)
        mesh_cell_sweep(card)
        print(f"[11] done at {time.perf_counter() - t_run:.1f} s; kernel "
              f"launches over (a) and (b), all ranks: {mesh_launches}",
              flush=True)
        lm_b6 = lm_mesh_run(card)
        mesh_launches["flash_decode"] = lm_b6
        print(f"[12] done at {time.perf_counter() - t_run:.1f} s; B6 "
              f"launches over (a), (d) and (f), all ranks: {lm_b6}",
              flush=True)
        train_launches = train_mesh_run(card, lm_losses)
        print(f"[13] done at {time.perf_counter() - t_run:.1f} s; kernel "
              f"launches over (b), (c) and (e), all ranks: "
              f"{train_launches}", flush=True)
        dry_check(dry, dry_dir, card)
        print(f"[14] done at {time.perf_counter() - t_run:.1f} s", flush=True)
    finally:
        tempfile.tempdir = None
        shutil.rmtree(tmp, ignore_errors=True)

    table = []
    for name, (source, replaces) in KERNEL_META.items():
        r = results[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": counts[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"],
                      "backward_ms": backward.get(name),
                      "mesh_launches": mesh_launches.get(name, 0),
                      "mesh_train_launches": train_launches.get(name, 0),
                      **({"lse_ms": r["lse_ms"]} if "lse_ms" in r else {})})
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lm-whole"]:      # phase 12's whole runs
        sys.exit(lm_whole_run(sys.argv[2]))
    if sys.argv[1:2] == ["--train-whole"]:   # phase 13's whole runs
        sys.exit(train_whole_run(sys.argv[2]))
    if sys.argv[1:2] == ["--dry"]:           # phase 14's meta-device work
        sys.exit(dry_run(sys.argv[2]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
