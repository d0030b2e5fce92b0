"""Serving launcher: the recsys JiZHI service (the examples/quickstart
path, with snapshots, live updates and telemetry), or the LM decode service
with continuous batching and a hot-load buffer, from the reference's CLI.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode recsys \
      --requests 96
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
      --arch smollm-135m --requests 6 --reduced

The CLI runs on ``cuda``. :func:`serve_recsys` and :func:`serve_lm` also
take ``device="cpu"`` (the plain versions of the kernels) and injected
weights; :func:`serve_lm` also the reduced / full-width choice that the
CLI's ``--reduced`` (always on, as in the reference) cannot turn off.

Telemetry (recsys mode): ``--metrics-port`` serves the registry live at
``/metrics`` (Prometheus text exposition) and ``/metrics.json``;
``--metrics-out DIR`` writes both files at shutdown; ``--history-dir``
runs a ``StatsRecorder`` sampling the registry into the windowed history
log the IRM's offline auto-search reads; ``--trace-out FILE`` exports the
run's tail-sampled traces as Chrome trace-event JSON (Perfetto-viewable).
"""
from __future__ import annotations

import argparse
import os
import threading
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


def start_metrics_server(registry, port: int):
    """Serve /metrics (Prometheus) + /metrics.json from a daemon thread.
    Returns the http.server instance (``.shutdown()`` to stop). Stdlib
    only — no new dependencies."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            if self.path.startswith("/metrics.json"):
                body = registry.to_json().encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                body = registry.to_prometheus().encode()
                ctype = "text/plain; version=0.0.4"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):       # quiet: metrics scrapes are noise
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="metrics-http").start()
    return srv


def write_metrics_files(registry, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metrics.prom"), "w") as f:
        f.write(registry.to_prometheus())
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        f.write(registry.to_json())


def serve_recsys(args, device=None, model_cfg=None, params=None,
                 pruning_dnn=None) -> dict:
    """The reference's recsys serve loop: one ``InferenceService`` (DIN
    unless ``args.arch`` names another recsys arch) with the CLI's
    snapshot, recovery, live-update and telemetry flags, serving
    ``args.requests`` requests. ``model_cfg`` / ``params`` /
    ``pruning_dnn`` are handed to the service (injected weights); without
    them it builds the reduced config and draws its own, as the reference
    does. Prints the reference's lines and returns its figures, with the
    service and the run's report beside them."""
    from repro_torch import obs
    from repro_torch.core.service import InferenceService, ServiceConfig
    cfg = ServiceConfig(
        arch_id=args.arch if args.arch != "smollm-135m" else "din",
        # crash safety (DESIGN.md §9): --snapshot-dir enables periodic
        # durable snapshots + SIGTERM final-snapshot; --recover boots from
        # the newest valid snapshot and replays the delta log
        snapshot_dir=args.snapshot_dir, recover=args.recover,
        live_updates=bool(args.update_dir), update_dir=args.update_dir)
    svc = InferenceService(cfg, device=device, model_cfg=model_cfg,
                           params=params, pruning_dnn=pruning_dnn)
    registry = obs.get_registry()
    obs.bridge.register_service(svc, name="recsys", registry=registry)
    if svc.snapshotter is not None:
        obs.bridge.register_snapshotter(svc.snapshotter, registry=registry)
    metrics_srv = (start_metrics_server(registry, args.metrics_port)
                   if args.metrics_port else None)
    recorder = None
    if args.history_dir:
        recorder = obs.StatsRecorder(
            args.history_dir, registry,
            interval_s=args.history_interval_s).start()
    tracer = obs.Tracer() if args.trace_out else None
    if svc.snapshotter is not None:
        svc.install_shutdown_hook()
    if svc.update_watcher is not None:
        svc.start_updates()
    if args.recover and svc.substrate.recovering:
        print(f"recovering: serving degraded until delta replay reaches "
              f"v{svc.substrate.recovery_target}")
    rep = svc.run(n_requests=args.requests, tracer=tracer)
    registry.histogram("request_latency_s",
                       "end-to-end request latency").observe_many(
        rep.latencies)
    out = {"served": len(rep.results), "avg_ms": rep.avg_latency * 1e3,
           "p99_ms": rep.latency_percentile(0.99) * 1e3,
           "query_cache_hit_ratio": svc.query_cache.stats.hit_ratio,
           "history_windows": None, "traces": None, "final_snapshot": None,
           "service": svc, "report": rep}
    print(f"served {out['served']} requests; "
          f"avg {out['avg_ms']:.2f} ms, p99 {out['p99_ms']:.2f} ms; "
          f"query-cache hit {100 * out['query_cache_hit_ratio']:.1f}%")
    if recorder is not None:
        recorder.stop()
        out["history_windows"] = recorder.windows_published
        print(f"history: {recorder.windows_published} window(s) in "
              f"{args.history_dir}")
    if tracer is not None:
        tracer.buffer.export_chrome(args.trace_out)
        out["traces"] = len(tracer.buffer.traces())
        print(f"traces: {out['traces']} retained -> {args.trace_out}")
    if args.metrics_out:
        write_metrics_files(registry, args.metrics_out)
        print(f"metrics: {args.metrics_out}/metrics.prom + metrics.json")
    if metrics_srv is not None:
        metrics_srv.shutdown()
    if svc.snapshotter is not None:
        path = svc.shutdown()
        out["final_snapshot"] = path
        if path:
            print(f"final snapshot: {path}")
    return out


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
