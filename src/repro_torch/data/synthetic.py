"""Synthetic data generators: web-scale traffic shapes without the web.

Zipf-distributed ids reproduce the paper's heavy-tailed access pattern
(Fig. 5a: 80% of lookups hit 1% of keys), which the cube-cache experiments
depend on. All generators are numpy + seeded (host-side data pipeline).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig, ShapeSpec


def zipf_ids(rng: np.random.Generator, n: int, vocab: int, a: float = 1.05) -> np.ndarray:
    """Zipf over [0, vocab) — heavy-tailed like production feature access."""
    z = rng.zipf(a, size=n).astype(np.int64)
    return ((z - 1) % vocab).astype(np.int32)


def lm_batch(rng: np.random.Generator, cfg: LMConfig, batch: int, seq: int) -> dict:
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)}


def recsys_ids(rng, fields, batch: int, zipf_a: float = 1.05) -> dict:
    out = {}
    for f in fields:
        shape = (batch,) if f.bag == 1 else (batch, f.bag)
        out[f.name] = zipf_ids(rng, int(np.prod(shape)), f.vocab, zipf_a).reshape(shape)
    return out


def recsys_batch(rng: np.random.Generator, cfg: RecsysConfig, batch: int) -> dict:
    b: dict = {"user": {"fields": recsys_ids(rng, cfg.user_fields, batch)},
               "item": recsys_ids(rng, cfg.item_fields, batch),
               "label": rng.binomial(1, 0.3, batch).astype(np.float32)}
    if cfg.seq_len:
        hist = zipf_ids(rng, batch * cfg.seq_len,
                        cfg.item_fields[0].vocab).reshape(batch, cfg.seq_len)
        lengths = rng.integers(1, cfg.seq_len + 1, batch)
        mask = np.arange(cfg.seq_len)[None, :] < lengths[:, None]
        b["user"]["hist"] = np.where(mask, hist, -1).astype(np.int32)
    return b


def _arrival_streams(rng: np.random.Generator):
    """Derive the three independent sub-streams the NHPP sampler uses:
    candidate gaps, burst-window starts, accept draws. Splitting them is
    what makes the vectorized and per-event implementations bit-identical:
    batched draws from one Generator equal the same draws made one at a
    time, and with separate streams the interleaving ORDER between
    candidates/bursts/accepts stops mattering — including the overshoot
    candidates a chunked sampler draws and discards."""
    seeds = rng.integers(0, np.iinfo(np.int64).max, size=3)
    return (np.random.default_rng(int(seeds[0])),
            np.random.default_rng(int(seeds[1])),
            np.random.default_rng(int(seeds[2])))


def diurnal_burst_arrivals(rng: np.random.Generator, n_events: int,
                           base_qps: float, peak_mult: float = 3.0,
                           day_s: float = 86400.0, start_frac: float = 0.5,
                           burst_rate_per_s: float = 0.0,
                           burst_mult: float = 3.0,
                           burst_dur_s: float = 0.5) -> np.ndarray:
    """Time-varying arrival process for closed-loop serving benchmarks
    (paper Fig. 2a: diurnal traffic; §6.2: bursts exceeding capacity).

    A non-homogeneous Poisson process sampled by Lewis thinning:

      * diurnal ramp — cosine day curve between ``base_qps`` (trough) and
        ``base_qps * peak_mult`` (peak); ``day_s`` compresses a day into the
        simulated horizon (e.g. day_s=60 sweeps a full diurnal cycle per
        simulated minute), ``start_frac`` picks where in the day t=0 falls
        (0.5 = mid-ramp);
      * Poisson bursts — burst windows open at rate ``burst_rate_per_s``,
        multiply the instantaneous rate by ``burst_mult`` for
        ``burst_dur_s`` seconds (flash-crowd spikes).

    Vectorized chunked thinning — candidate times, burst membership, and
    accept draws all evaluate as arrays, so the 100×-scale mesh bench can
    generate millions of arrivals in seconds. Bit-identical to the
    per-event reference (:func:`diurnal_burst_arrivals_loop`) at a fixed
    seed: both derive the same three sub-streams and consume each
    identically per candidate/burst/accept.

    Returns sorted arrival times (seconds, t=0 origin), seeded and
    deterministic per ``rng``.
    """
    arr_rng, burst_rng, acc_rng = _arrival_streams(rng)
    lam_max = base_qps * max(1.0, peak_mult) * (
        max(1.0, burst_mult) if burst_rate_per_s > 0 else 1.0)
    # accept probability averages lam_mean/lam_max — size chunks so the
    # expected number of rounds is ~1-2 even for burst-heavy configs
    mean_accept = max(1e-3, 0.5 * (1.0 + peak_mult) * base_qps / lam_max)
    out: list[np.ndarray] = []
    got = 0
    t0 = 0.0
    b_starts = np.empty(0)       # burst-window starts drawn so far
    b_cursor = 0.0               # sum of burst gaps drawn so far
    two_pi = 2.0 * np.pi
    while got < n_events:
        need = n_events - got
        chunk = max(1024, int(need / mean_accept * 1.1) + 16)
        gaps = arr_rng.exponential(1.0 / lam_max, size=chunk)
        # cumsum seeded with t0 reproduces the loop's ((t0+g1)+g2)+...
        # association exactly — `t0 + cumsum(gaps)` would round differently
        ts = np.cumsum(np.concatenate(([t0], gaps)))[1:]
        t0 = float(ts[-1])
        phase = np.cos((start_frac + ts / day_s) * two_pi)
        lam = base_qps * (1.0 + (peak_mult - 1.0) * 0.5 * (1.0 + phase))
        if burst_rate_per_s > 0:
            while b_cursor <= t0:    # extend burst starts past the chunk
                gaps = burst_rng.exponential(1.0 / burst_rate_per_s,
                                             size=max(chunk // 16, 64))
                ext = b_cursor + np.cumsum(gaps)
                b_starts = np.concatenate([b_starts, ext])
                b_cursor = float(ext[-1])
            # constant burst_dur_s ⇒ window ends increase with starts, so
            # the loop's running-max burst_end reduces to "the latest
            # start ≤ t still covers t"
            idx = np.searchsorted(b_starts, ts, side="right") - 1
            in_burst = (idx >= 0) & (ts < b_starts[np.maximum(idx, 0)]
                                     + burst_dur_s)
            lam = np.where(in_burst, lam * burst_mult, lam)
        accept = acc_rng.random(chunk) < lam / lam_max
        sel = ts[accept]
        out.append(sel[:need])
        got += min(len(sel), need)
    return np.concatenate(out)[:n_events]


def diurnal_burst_arrivals_loop(rng: np.random.Generator, n_events: int,
                                base_qps: float, peak_mult: float = 3.0,
                                day_s: float = 86400.0,
                                start_frac: float = 0.5,
                                burst_rate_per_s: float = 0.0,
                                burst_mult: float = 3.0,
                                burst_dur_s: float = 0.5) -> np.ndarray:
    """Per-event reference implementation of
    :func:`diurnal_burst_arrivals` (the original Lewis-thinning loop,
    restructured onto the same three derived sub-streams). Kept as the
    parity oracle: the vectorized sampler must match it bit-for-bit."""
    arr_rng, burst_rng, acc_rng = _arrival_streams(rng)
    lam_max = base_qps * max(1.0, peak_mult) * (
        max(1.0, burst_mult) if burst_rate_per_s > 0 else 1.0)
    times = np.empty(n_events)
    t = 0.0
    next_burst = (burst_rng.exponential(1.0 / burst_rate_per_s)
                  if burst_rate_per_s > 0 else np.inf)
    burst_end = -np.inf
    k = 0
    while k < n_events:
        t += arr_rng.exponential(1.0 / lam_max)
        while t >= next_burst:
            burst_end = max(burst_end, next_burst + burst_dur_s)
            next_burst += burst_rng.exponential(1.0 / burst_rate_per_s)
        phase = np.cos((start_frac + t / day_s) * 2.0 * np.pi)
        lam = base_qps * (1.0 + (peak_mult - 1.0) * 0.5 * (1.0 + phase))
        if t < burst_end:
            lam *= burst_mult
        if acc_rng.random() < lam / lam_max:
            times[k] = t
            k += 1
    return times


def random_graph(rng: np.random.Generator, n_nodes: int, n_edges: int,
                 d_feat: int | None = None) -> dict:
    """Random directed graph as (E,2) [src,dst] with synthetic edge lengths."""
    edges = rng.integers(0, n_nodes, (n_edges, 2), dtype=np.int32)
    g: dict = {"edges": edges,
               "edge_dist": rng.uniform(0.5, 9.5, n_edges).astype(np.float32)}
    if d_feat is not None:
        g["node_feat"] = rng.normal(0, 1, (n_nodes, d_feat)).astype(np.float32)
    return g


def molecule_batch(rng: np.random.Generator, cfg: GNNConfig, batch: int,
                   n_atoms: int, n_edges: int) -> dict:
    """Batched small molecules flattened into one disjoint graph."""
    N, E = batch * n_atoms, batch * n_edges
    atom_z = rng.integers(1, cfg.n_atom_types, N).astype(np.int32)
    pos = rng.normal(0, 2.0, (N, 3)).astype(np.float32)
    # intra-molecule random edges (offsets keep graphs disjoint)
    src = rng.integers(0, n_atoms, (batch, n_edges))
    dst = rng.integers(0, n_atoms, (batch, n_edges))
    off = (np.arange(batch) * n_atoms)[:, None]
    edges = np.stack([(src + off).reshape(-1), (dst + off).reshape(-1)],
                     axis=1).astype(np.int32)
    graph_ids = np.repeat(np.arange(batch), n_atoms).astype(np.int32)
    return {"atom_z": atom_z, "positions": pos, "edges": edges,
            "graph_ids": graph_ids, "n_graphs": batch,
            "targets": rng.normal(0, 1, batch).astype(np.float32)}
