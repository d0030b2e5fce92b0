#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--vocab-log2 26]

Phases, each printing its lines; any failure exits nonzero:

  1. the card (nvidia-smi name and power limit), torch, capability (9, 0);
  2. the build of the hand-written kernels from ``kernels/csrc`` (nvcc);
  3. every kernel against its plain PyTorch version on the card, on the
     reference's own test cells and at the full-DIN shapes of the serving
     path, with kernel / plain / library times and the roofline bound;
  4. the DIN model at the published widths (vocab cut to 2**16 for this
     phase only): serve_scores and score_candidates on the card through
     the kernels, against the same weights on the CPU through the plain
     versions;
  5. the DIN re-rank service at the published widths
     (InferenceService on ``cuda``; ``--vocab-log2`` cuts the user_id and
     item_id tables of this phase only): two waves of 64 requests on the
     AsyncExecutor, every answer checked, and the launch count of every
     kernel checked against the micro-batches and re-ranked requests;
  6. the kernel table as one JSON line, the card line, and the result.

Needs a CUDA device; exits nonzero without one, and without the
repository's ``src/repro_torch`` beside this script.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet) for the roofline bound:
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores

TOL_F32 = 2e-5                    # tests/test_kernels.py, test_rerank_fused.py
TOL_EDGE = 3e-5                   # tests/test_kernel_edge_parity.py
TOL_BF16 = 2e-2                   # tests/test_kernels.py (bf16)
# model phase: the card's kernels and the CPU's plain versions sum in
# different orders (warp reductions, decomposed first layer, CPU BLAS
# blocking); the reference's own parity tolerance covers that
TOL_MODEL = 2e-5

MAIN_VOCAB_LOG2 = 26              # published user_id / item_id rows (2**26)
N_REQUESTS = 64                   # requests per wave of the service phase

KERNEL_META = {
    "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:35"),
    "din_attention": ("src/repro_torch/kernels/csrc/din_attention.cu",
                      "src/repro/kernels/din_attention/kernel.py:42"),
    "rerank_score": ("src/repro_torch/kernels/csrc/rerank_score.cu",
                     "src/repro/kernels/rerank_score/kernel.py:82"),
}


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


def timings(kernel_fn, plain_fn, library_fn=None) -> dict:
    """Device times (graph replay) of the kernel, its plain version and
    the library call."""
    return dict(ms=device_ms(kernel_fn), plain_ms=device_ms(plain_fn),
                library_ms=None if library_fn is None else device_ms(library_fn))


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, tol):
    """max-abs-diff of kernel vs plain, held to assert_allclose(rtol=atol=
    tol) semantics."""
    import torch
    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max()) if got.numel() else 0.0
    # share of the allowance used: |got - want| / (tol + tol * |want|) <= 1
    used = float((diff / (tol + tol * want.abs())).max()) if got.numel() else 0.0
    ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
    print(f"  {name}: max_abs_err={err:.3e} tol={tol:g} (rtol=atol) "
          f"allowance used {used:.3f} {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


# ------------------------------------------------------------------ phase 3

def kernel_checks(results: dict):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.din_attention import din_attention, din_attention_ref
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
    from repro_torch.kernels.rerank_score import rerank_score, rerank_score_ref

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
    # the serving path's dominant call: the history lookup of a 16-request
    # micro-batch (16 x 100 single-id bags) into the item_id table
    V, D, n = 1 << MAIN_VOCAB_LOG2, 18, 16 * 100
    table = torch.randn((V, D), device=dev).mul_(0.01)
    from repro_torch.data.synthetic import zipf_ids
    ids = t(zipf_ids(rng, n, V).reshape(n, 1), torch.int64)
    err = compare(f"main path V=2^{MAIN_VOCAB_LOG2} D=18 B={n} K=1",
                  embedding_bag(table, ids), embedding_bag_ref(table, ids),
                  TOL_F32)
    uniq = int(torch.unique(ids).numel())
    nbytes = n * 8 + uniq * D * 4 + n * D * 4
    bms, by = bound_ms(nbytes, 2 * n * D)
    results["embedding_bag"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        shape=f"V=2^{MAIN_VOCAB_LOG2} D=18 B={n} K=1",
        **timings(lambda: embedding_bag(table, ids),
                  lambda: embedding_bag_ref(table, ids),
                  lambda: F.embedding_bag(ids, table, mode="sum")))
    del table
    torch.cuda.empty_cache()

    # ---- B2 din_attention
    print("[3] din_attention vs plain", flush=True)

    def din_case(B, T, D, H1, H2, mask, tol, label):
        hist = t(rng.normal(size=(B, T, D)))
        tgt = t(rng.normal(size=(B, D)))
        w1 = t(rng.normal(size=(4 * D, H1)) * 0.2)
        w2 = t(rng.normal(size=(H1, H2)) * 0.2)
        w3 = t(rng.normal(size=(H2, 1)) * 0.2)
        b1, b2, b3 = (torch.zeros(H1, device=dev), torch.zeros(H2, device=dev),
                      torch.zeros(1, device=dev))
        args = (hist, t(mask), tgt, w1, b1, w2, b2, w3, b3)
        err = compare(label, din_attention(*args), din_attention_ref(*args), tol)
        return args, err

    for B, T, D, H1, H2 in [(8, 8, 8, 8, 4), (16, 100, 18, 80, 40),
                            (12, 33, 16, 32, 8)]:
        args, err = din_case(B, T, D, H1, H2, rng.random((B, T)) > 0.2,
                             TOL_F32, f"B={B} T={T} D={D} H1={H1} H2={H2}")
        if (B, T, D, H1, H2) == (16, 100, 18, 80, 40):
            full_args, full_err = args, err
    for B, T in [(1, 1), (1, 9), (5, 1)]:
        din_case(B, T, 8, 16, 8, np.ones((B, T)), TOL_EDGE, f"edge B={B} T={T}")
    din_case(2, 6, 8, 16, 8, np.zeros((2, 6)), TOL_EDGE, "edge zero mask")
    B, T, D, H1, H2 = 16, 100, 18, 80, 40
    active = int((full_args[1] != 0).sum())
    nbytes = 4 * (B * T * D + B * T + B * D + 4 * D * H1 + H1 + H1 * H2
                  + 2 * H2 + 1 + B * D)
    flops = (B * 2 * D * H1 + active * (4 * D * H1 + D + 2 * H1 * H2
                                        + 2 * H2 + 2 * D))
    bms, by = bound_ms(nbytes, flops)
    results["din_attention"] = dict(
        max_abs_err=full_err, bound_ms=bms, bound_by=by,
        shape="B=16 T=100 D=18 H1=80 H2=40",
        **timings(lambda: din_attention(*full_args),
                  lambda: din_attention_ref(*full_args)))

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
        err = compare(label, rerank_score(hist, m, tgt, uo, io, attn, mlp),
                      rerank_score_ref(hist, m, tgt, uo, io, *flat), tol)
        return (hist, m, tgt, uo, io, attn, mlp, flat), err

    small = (16, 16, 32, 32)
    for C, T in [(64, 7), (300, 12), (257, 33), (128, 1), (130, 16)]:
        rr_case(C, T, 8, 16, 8, small, rng.random(T) > 0.3, TOL_F32,
                f"edge C={C} T={T}")
    rr_case(64, 24, 8, 16, 8, small, np.zeros(24), TOL_F32,
            "edge fully masked history")
    full = (80, 40, 200, 80)
    for C in (16, 32, 64):
        case, err = rr_case(C, 100, 18, 36, 18, full, rng.random(100) > 0.2,
                            TOL_F32, f"full DIN C={C} T=100", model_init=True)
    hist, m, tgt, uo, io, attn, mlp, flat = case
    C, T, D, d_u, d_i, (H1, H2, M1, M2) = 64, 100, 18, 36, 18, full
    K1 = 2 * D + d_u + d_i
    active = int((m != 0).sum())
    nbytes = 4 * (T * D + T + C * D + d_u + C * d_i + sum(x.numel() for x in flat)
                  + C)
    flops = (2 * T * D * H1 + C * 2 * D * H1
             + C * active * (2 * D * H1 + D + 2 * H1 * H2 + 2 * H2 + 2 * D)
             + C * 2 * (K1 * M1 + M1 * M2 + M2))
    bms, by = bound_ms(nbytes, flops)
    results["rerank_score"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        shape="C=64 T=100 D=18 d_u=36 d_i=18 attn 80-40 mlp 200-80",
        **timings(lambda: rerank_score(hist, m, tgt, uo, io, attn, mlp),
                  lambda: rerank_score_ref(hist, m, tgt, uo, io, *flat)))
    for name, r in results.items():
        print(f"[3] {name} @ {r['shape']}: device time per call (CUDA graph "
              f"replay): kernel {r['ms']} ms, plain {r['plain_ms']} ms, "
              f"library {r['library_ms']} ms, bound {r['bound_ms']} ms "
              f"({r['bound_by']})", flush=True)


# ------------------------------------------------------------------ phase 4

def model_check():
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.other_archs import DIN
    from repro_torch.data import synthetic
    from repro_torch.models.recsys import din
    from repro_torch.serve.bucketing import (ShapeBucketer, compact_history,
                                             step_buckets)

    cfg = dataclasses.replace(
        DIN, user_fields=tuple(dataclasses.replace(f, vocab=1 << 16)
                               for f in DIN.user_fields),
        item_fields=tuple(dataclasses.replace(f, vocab=1 << 16)
                          for f in DIN.item_fields))
    print("[4] DIN at published widths (D=18, T=100, attn 80-40, mlp "
          "200-80), vocab 2^16: card (kernels) vs CPU (plain versions), "
          f"tol {TOL_MODEL:g}", flush=True)
    params_cpu = din.init(torch.Generator().manual_seed(0), cfg, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    params_gpu = to(params_cpu, "cuda")
    rng = np.random.default_rng(0)
    raw = synthetic.recsys_batch(rng, cfg, 16)

    def batch_on(dev, x=raw):                    # ids as int64 tensors
        if isinstance(x, dict):
            return {k: batch_on(dev, v) for k, v in x.items()}
        t = torch.as_tensor(x)
        return (t if t.is_floating_point() else t.long()).to(dev)

    b_cpu, b_gpu = batch_on("cpu"), batch_on("cuda")
    s_gpu = din.serve_scores(params_gpu, b_gpu, cfg).cpu()
    s_cpu = din.serve_scores(params_cpu, b_cpu, cfg)
    compare("serve_scores B=16", s_gpu, s_cpu, TOL_MODEL)

    C = 64
    hist = np.full(cfg.seq_len, -1, np.int64)
    hist[:80] = rng.integers(0, cfg.item_fields[0].vocab, 80)
    hist = compact_history(hist, ShapeBucketer(step_buckets(cfg.seq_len)))
    fields = {f.name: rng.integers(0, f.vocab, (1,) if f.bag == 1 else (1, f.bag))
              for f in cfg.user_fields}
    cand = {"item_id": rng.integers(0, cfg.item_fields[0].vocab, C),
            "item_cat": rng.integers(0, cfg.item_fields[1].vocab, C)}

    def dense(params, dev, path):
        user = {"hist": torch.as_tensor(hist)[None].to(dev),
                "fields": {k: torch.as_tensor(v).to(dev) for k, v in fields.items()}}
        cids = {k: torch.as_tensor(v).to(dev) for k, v in cand.items()}
        v, i = din.score_candidates(params, user, cids, cfg, top_k=C, path=path)
        out = torch.empty(C)
        out[i.cpu()] = v.cpu()
        return out

    fused_gpu = dense(params_gpu, "cuda", "fused")
    compare("score_candidates fused C=64 card vs CPU", fused_gpu,
            dense(params_cpu, "cpu", "fused"), TOL_MODEL)
    compare("score_candidates fused vs broadcast (jnp) path, both on card",
            fused_gpu, dense(params_gpu, "cuda", "jnp"), TOL_MODEL)
    del params_gpu
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 5

def service_run(vocab_log2: int) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs.other_archs import DIN
    from repro_torch.core.executors import AsyncExecutor
    from repro_torch.core.service import InferenceService, ServiceConfig

    def cut(f):
        big = f.name in ("user_id", "item_id") and f.vocab > (1 << vocab_log2)
        return dataclasses.replace(f, vocab=1 << vocab_log2) if big else f

    cfg = dataclasses.replace(DIN, user_fields=tuple(map(cut, DIN.user_fields)),
                              item_fields=tuple(map(cut, DIN.item_fields)))
    vocab = {f.name: f.vocab for f in cfg.user_fields + cfg.item_fields}
    print(f"[5] service: DIN at published widths, tables {vocab}"
          + ("" if vocab_log2 >= MAIN_VOCAB_LOG2 else
             f" (user_id/item_id vocab cut from 2^{MAIN_VOCAB_LOG2} to "
             f"2^{vocab_log2})"),
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = InferenceService(ServiceConfig(arch_id="din", batch_size=16),
                           device="cuda", model_cfg=cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"[5] service build (cube load + model init + pruning-DNN fit): "
          f"{build_s} s", flush=True)
    check(svc.device.type == "cuda", "service did not land on the card")

    waves = []
    K.reset_launches()                      # counts from here are the path's
    for wave in range(2):
        reqs = svc.make_requests(N_REQUESTS, seed=wave)
        waves.append(AsyncExecutor(svc.plan).run(reqs))
    counts = K.launch_counts()

    lat, batches, reranked, cached = [], 0, 0, 0
    for wave, rep in enumerate(waves):
        check(rep.errors == 0, f"wave {wave}: {rep.errors} stage errors")
        check(rep.completed == N_REQUESTS and len(rep.results) == N_REQUESTS,
              f"wave {wave}: {rep.completed}/{N_REQUESTS} answered")
        for ev in rep.results:
            r = ev.meta.get("response")
            check(r is not None and not r.timed_out, "request not answered")
            check(r.score is not None and math.isfinite(r.score)
                  and 0.0 <= r.score <= 1.0, f"bad score {r.score}")
            if r.from_cache:
                cached += 1
            else:
                check(bool(r.topk), f"request {r.req_id}: no topk")
                check(all(math.isfinite(s) and 0.0 <= s <= 1.0
                          for _i, s in r.topk), "bad topk score")
        st = rep.stage_stats["rerank"]
        batches += st.batches
        reranked += st.events
        lat.extend(rep.latencies)
        # the executor's makespan ends with its 0.2 s drain poll; the
        # served span runs from the first request in to the last answer out
        span = (max(ev.done_at for ev in rep.results)
                - min(ev.born_at for ev in rep.results))
        # wave 0 is the cold start: the host cube folds its lazily built
        # signature index at the first probe of each table
        print(f"[5] wave {wave} ({'cold' if wave == 0 else 'warm'}): "
              f"{rep.completed} answered (n={len(rep.latencies)} latencies), "
              f"p50 {rep.latency_percentile(0.5) * 1e3} ms, p99 "
              f"{rep.latency_percentile(0.99) * 1e3} ms, served span {span} s "
              f"= {rep.completed / span} req/s (makespan {rep.makespan_s} s), "
              f"rerank micro-batches {st.batches}, re-ranked {st.events}",
              flush=True)
        print(f"[5] wave {wave} stage busy s: " + ", ".join(
            f"{name} {s.busy_s:.6f}" for name, s in rep.stage_stats.items()),
            flush=True)
    expected = {"embedding_bag": 5 * batches + 4 * reranked,
                "din_attention": batches, "rerank_score": reranked}
    print(f"[5] launches {counts}, expected {expected} (per micro-batch 5 "
          f"embedding_bag + 1 din_attention; per re-ranked request 4 "
          f"embedding_bag + 1 rerank_score); {cached} answers from the "
          f"query cache", flush=True)
    check(all(counts[k] > 0 for k in counts), "a kernel was never launched")
    check(counts == expected, "launch counts differ from the path's calls")
    lat = np.sort(np.asarray(lat))
    print(f"[5] both waves: p50 {np.percentile(lat, 50) * 1e3} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3} ms (n={lat.size}), "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30} GiB", flush=True)
    return counts


# --------------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vocab-log2", type=int, default=MAIN_VOCAB_LOG2,
                    help="log2 of the user_id/item_id vocab in the service "
                         "phase only (published: 26)")
    args = ap.parse_args()

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

    from repro_torch import kernels as K
    t0 = time.perf_counter()
    lib = K.build()
    K.library()
    print(f"[2] built {lib.name} from {len(K.sources())} sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2] {line.strip()}", flush=True)

    # the cube's memory-mapped blocks go to a directory removed on exit
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    tempfile.tempdir = tmp
    try:
        results: dict = {}
        kernel_checks(results)
        model_check()
        counts = service_run(args.vocab_log2)
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
                      "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
