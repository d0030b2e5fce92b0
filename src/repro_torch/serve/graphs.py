"""The decode step as one CUDA graph.

An eager decode step launches thousands of small kernels (~5,500 for
DeepSeek-V2-Lite's 27 layers), and the host's enqueue, not the device,
then sets the step (``PERF.md`` §5). :class:`DecodeGraph` captures one
call of ``transformer.decode_step`` over static input buffers (the new
tokens and the cache's lengths) and replays it: a call copies the step's
tokens and lengths in and launches the graph, with no host work per
kernel. The cache's arrays are written in place by each replay, as by
the eager step.

:func:`decoder` gives a step function of either kind under one call
signature, so a serving loop picks graph or eager with one flag. A graph
holds the addresses of the parameters and the cache it was captured on:
new weights or a new cache take a new capture. Inside a replay no layer
span opens (``obs.layer``); a profiler sees its kernels, not its layers.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models import moe, transformer


def _call(params, cache, tokens, cfg, routes: bool):
    """(logits, the MoE layers' ``moe.Routed`` or []) of one eager step."""
    with (moe.recording() if routes else contextlib.nullcontext([])) as got:
        logits, _ = transformer.decode_step(params, cache, tokens, cfg)
    return logits, got


class DecodeGraph:
    """``decode_step(params, cache, tokens, cfg)`` captured as one CUDA
    graph. The warm-up calls (cuBLAS's and the kernels' one-time set-up,
    on a side stream) and the capture run on ``tokens`` and
    ``cache.length``: the cache rows they write are those that a first
    call with the same tokens and lengths writes again.

    Calling it with (tokens (B, 1), lengths like ``cache.length``)
    replays the graph and returns (logits (B, V) float32, routes): the
    same tensors every call, holding the last replay's values; ``routes``
    is the MoE layers' ``moe.Routed`` where ``record_routes``, else []."""

    def __init__(self, params, cache, tokens, cfg, *,
                 record_routes: bool = False, warmup: int = 2):
        self.tokens = tokens.clone()
        self.length = cache.length.clone()
        static = cache._replace(length=self.length)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                _call(params, static, self.tokens, cfg, record_routes)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self.out = _call(params, static, self.tokens, cfg, record_routes)
        torch.cuda.synchronize()

    def __call__(self, tokens, lengths):
        self.tokens.copy_(tokens)
        self.length.copy_(lengths)
        self.graph.replay()
        return self.out


def decoder(params, cache, tokens, cfg, *, graph: bool,
            record_routes: bool = False):
    """A step function (tokens (B, 1), lengths like ``cache.length``) →
    (logits (B, V) float32, routes) over ``cache``'s arrays: a
    :class:`DecodeGraph` captured on ``tokens`` and ``cache.length`` (the
    first call's) where ``graph``, else the eager ``decode_step``."""
    if graph:
        return DecodeGraph(params, cache, tokens, cfg,
                           record_routes=record_routes)

    def step(tokens, lengths):
        return _call(params, cache._replace(length=lengths), tokens, cfg,
                     record_routes)
    return step
