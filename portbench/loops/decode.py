"""Decoding from long prompt caches: a batch of sessions, one new token
each a step, through the program's ``transformer.decode_step``.

Each of the ``slots`` sessions decodes from its prompt's latent cache,
drawn from the seed in set-up (no timed prefill). Prompt lengths are a
fixed multiset, ``prompt_base + prompt_step * k`` for k < slots, and
answer lengths another (``answers``, equally many of each), both put to
the slots in an order of the seed's; each slot starts at a phase of the
seed's within its answer. When a slot's answer ends it restarts from its
prompt's cached prefix (the same document asked again, a prefix-cache
hit) and its answer rows are overwritten. The cache holds
``cache_rows`` rows a slot. The rows' lengths at step n depend only on n
mod ``ring`` (a multiple of every answer length), so a ring of ``ring``
slots holds each step's input ids (uniform over the vocabulary, teacher
forced) and lengths on the device; every seed does the same work.

A step is the program's decode entry, ``serve.graphs.decoder``: on the
card ``decode_step`` captured in set-up as one CUDA graph and replayed
(the program's ``serve_lm --decode-graph``), elsewhere ``decode_step``
called eagerly; traced windows replay the same graph. ``in_flight``
steps are in flight, as in the bulk loop: after a step is enqueued (its
greedy ids' copy to pinned host memory included), the host waits for the
oldest once that many are pending. A step's latency runs from its
enqueue to the host seeing its ids. The last step's float32 logits and
the experts its tokens took stay on the device for the check, which
recomputes each slot's answer so far with the plain reference.

A replayed graph opens no layer span, so the span metrics read
:meth:`Loop.span_ms`: the same step launched eagerly, kernel by kernel,
under the profiler."""
from __future__ import annotations

import math
import sys
import time
from collections import deque

import numpy as np
import torch

from portbench import gen, program
from portbench.loops.common import event, host_buffer, sync, until

#: eager steps :meth:`Loop.span_ms` traces
SPAN_STEPS = 3
#: the float8 format the control computes in, below the configured bf16
LOW = torch.float8_e4m3fn


def lm_config(cfg: dict):
    """The program's ``LMConfig`` for a DeepSeek-V2 configuration file
    (the published config.json keys): dropless serving
    (``capacity_factor=None``), its gates and its rope scaling."""
    program.module(cfg)
    from repro_torch.configs.base import (LMConfig, MLAConfig, MoEConfig,
                                          RopeScaling)
    fixed = {"attention_bias": False, "moe_layer_freq": 1, "n_group": 1,
             "topk_group": 1, "topk_method": "greedy",
             "scoring_func": "softmax", "routed_scaling_factor": 1,
             "hidden_act": "silu", "tie_word_embeddings": False}
    for k, v in fixed.items():
        if cfg[k] != v:
            raise ValueError(f"{k} = {cfg[k]!r}: the program takes {v!r}")
    rs = cfg.get("rope_scaling")
    scaling = None
    if rs:
        if rs.get("type") != "yarn":
            raise ValueError(f"rope_scaling {rs.get('type')!r}: the program "
                             f"takes yarn")
        scaling = RopeScaling(**{k: v for k, v in rs.items()})
    return LMConfig(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv=cfg["num_key_value_heads"], d_head=cfg["v_head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), rope_scaling=scaling,
        mla=MLAConfig(kv_lora=cfg["kv_lora_rank"], q_lora=cfg["q_lora_rank"],
                      d_nope=cfg["qk_nope_head_dim"],
                      d_rope=cfg["qk_rope_head_dim"],
                      v_dim=cfg["v_head_dim"]),
        moe=MoEConfig(n_routed=cfg["n_routed_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff_expert=cfg["moe_intermediate_size"],
                      n_shared=cfg["n_shared_experts"],
                      n_dense_layers=cfg["first_k_dense_replace"],
                      dense_d_ff=cfg["intermediate_size"],
                      capacity_factor=None,
                      norm_topk_prob=cfg["norm_topk_prob"]),
        norm="rmsnorm", act="silu", glu=True, norm_eps=cfg["rms_norm_eps"],
        param_dtype=cfg["dtype"], remat=False)


def plan(g: torch.Generator, traffic: dict) -> dict:
    """Each slot's prompt length, answer length and phase (numpy)."""
    B, answers = traffic["slots"], traffic["answers"]
    if B % len(answers):
        raise ValueError(f"{B} slots do not take {len(answers)} answer "
                         f"lengths equally often")
    for a in answers:
        if traffic["ring"] % a:
            raise ValueError(f"a ring of {traffic['ring']} is no multiple "
                             f"of the answer length {a}")
    prompts = (traffic["prompt_base"] + traffic["prompt_step"]
               * np.arange(B))[gen.permutation(g, B)]
    ans = np.repeat(np.asarray(answers), B // len(answers))[
        gen.permutation(g, B)]
    phase = torch.randint(0, traffic["ring"], (B,), generator=g,
                          device=g.device).cpu().numpy() % ans
    if int((prompts + ans).max()) > traffic["cache_rows"]:
        raise ValueError("a prompt and its answer pass the cache's rows")
    return {"prompt": prompts.astype(np.int64), "answer": ans.astype(np.int64),
            "phase": phase.astype(np.int64)}


class Loop:
    name = "decode"

    def __init__(self, cell):
        self.cell = cell
        cfg, t, dev = cell.cfg, cell.traffic, cell.device
        self.prog = program.module(cfg)
        self.lm = lm_config(cfg)
        self.B, self.n_ring = t["slots"], t["ring"]
        self.in_flight = t["in_flight"]
        self.plan = plan(cell.gen, t)
        self.cache_seed = gen.seeds(int(torch.randint(
            0, 2**62, (1,), generator=cell.gen, device=dev)), 1)[0]
        L, S = cfg["num_hidden_layers"], t["cache_rows"]
        kv, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
        dt = cell.ref.dtype(cfg)
        a = torch.zeros((L, self.B, S, kv), dtype=dt, device=dev)
        b = torch.zeros((L, self.B, S, rope), dtype=dt, device=dev)
        for layer in range(L):
            for s in range(self.B):
                P = int(self.plan["prompt"][s])
                rows = cell.ref.prompt_rows(self.cache_seed, layer, s, P,
                                            cfg, dev)
                a[layer, s, :P] = rows[:, :kv]
                b[layer, s, :P] = rows[:, kv:]
                del rows
        self.cache = self.prog.KVCache(
            a=a, b=b, length=torch.zeros((self.B,), dtype=torch.int32,
                                         device=dev))
        tokens = torch.randint(0, cfg["vocab_size"], (self.n_ring, self.B, 1),
                               generator=cell.gen, device=dev)
        steps = np.arange(self.n_ring)[:, None]
        lengths = torch.as_tensor(
            self.plan["prompt"] + (steps + self.plan["phase"])
            % self.plan["answer"], dtype=torch.int32, device=dev)
        self.tokens = tokens
        self.ring = [{"tokens": tokens[n], "lengths": lengths[n]}
                     for n in range(self.n_ring)]
        self.host = host_buffer((self.in_flight, self.B), torch.int64, dev)
        self.events = [event(dev) for _ in range(self.in_flight)]
        self.step = 0
        self.last = None
        self._spans = None
        # captured on ring slot 0's inputs: the graph's warm-up steps write
        # only rows that step 0 writes again
        from repro_torch.serve import graphs
        first = self.cache._replace(length=self.ring[0]["lengths"])
        self.decode = graphs.decoder(cell.weights, first,
                                     self.ring[0]["tokens"], self.lm,
                                     graph=dev.type == "cuda",
                                     record_routes=True)
        self.eager = graphs.decoder(cell.weights, first,
                                    self.ring[0]["tokens"], self.lm,
                                    graph=False)

    def _enqueue(self, n: int):
        r = self.ring[n % self.n_ring]
        logits, routes = self.decode(r["tokens"], r["lengths"])
        self.host[n % self.in_flight].copy_(logits.argmax(-1),
                                            non_blocking=True)
        self.last = (n, logits, routes)

    def run(self, seconds=None, count=None) -> dict:
        """Dispatch steps for ``seconds`` (or ``count`` steps) and wait for
        every step enqueued: {"seconds", "items" (tokens decoded), "calls",
        "slots" (steps done a ring slot), "latencies" (s)}. Steps go on
        from where the last run stopped."""
        slots = np.zeros(self.n_ring, dtype=np.int64)
        lat: list[float] = []
        pending: deque = deque()
        go = until(seconds, count)
        calls = 0
        t0 = time.perf_counter()
        while go(calls):
            n = self.step
            t_enq = time.perf_counter()
            self._enqueue(n)
            ev = self.events[n % self.in_flight]
            ev.record()
            pending.append((t_enq, ev, n % self.n_ring))
            self.step += 1
            calls += 1
            while len(pending) >= self.in_flight:
                self._finish(pending.popleft(), lat, slots)
        while pending:
            self._finish(pending.popleft(), lat, slots)
        return {"seconds": time.perf_counter() - t0,
                "items": calls * self.B, "calls": calls, "slots": slots,
                "latencies": lat}

    @staticmethod
    def _finish(entry, lat, slots):
        t_enq, ev, slot = entry
        ev.synchronize()
        lat.append(time.perf_counter() - t_enq)
        slots[slot] += 1

    def outputs(self) -> dict:
        """The last step: its index, float32 logits (B, V) on the device,
        the experts each token took in each MoE layer and the pairs the
        MoE dropped in all."""
        n, logits, routes = self.last
        return {"step": n, "logits": logits,
                "routes": [r.ids for r in routes],
                "dropped": sum(r.dropped() for r in routes)}

    def _answers(self, n: int):
        """Each slot's tokens fed since its last restart, up to step n, or
        None where a slot has not restarted since the first step."""
        pos = (n + self.plan["phase"]) % self.plan["answer"]
        if int((n - pos).min()) < 0:
            return None
        return [self.tokens[torch.as_tensor(
            np.arange(n - pos[s], n + 1) % self.n_ring), s, 0]
            for s in range(self.B)]

    def reference(self, n: int, routes, low=None):
        """The reference's logits and router probabilities after step n,
        the prompts' latents drawn again from the seed; ``low``: the
        dtype it computes in instead (``reference.decode_logits``)."""
        cfg, dev, ref = self.cell.cfg, self.cell.device, self.cell.ref
        answers = self._answers(n)
        if answers is None:
            return None

        def prefix(s):
            P = int(self.plan["prompt"][s])
            return P, lambda layer: ref.prompt_rows(self.cache_seed, layer, s,
                                                    P, cfg, dev)
        return ref.decode_logits(self.cell.weights, cfg,
                                 [prefix(s) for s in range(self.B)],
                                 answers, routes, low)

    def control(self) -> dict:
        """The reference computed in float8_e4m3fn, below the configured
        bf16, in the program's place: every weight, the residual between
        layers and every cached latent rounded through it, each last
        token taking the experts of its own router."""
        out = self.outputs()
        got = self.reference(out["step"], None, LOW)
        if got is not None:
            logits, probs = got
            k = self.cell.cfg["num_experts_per_tok"]
            out["logits"] = logits
            out["routes"] = [torch.topk(p, k, -1).indices for p in probs]
        return out

    def check(self, outputs: dict) -> dict:
        """logit_gap: the widest |logit - reference| of the last step over
        every slot, in units of that slot's reference logits' standard
        deviation; route_slack: the most a chosen expert's reference
        router probability falls below the reference's own k-th largest,
        over the last step's tokens and MoE layers; dropped_pairs: routed
        pairs the program dropped. Infinite where a slot has not restarted
        since the first step (its cache holds rows no step wrote)."""
        got = self.reference(outputs["step"], outputs["routes"])
        if got is None:
            print("portbench: a slot has not restarted since the first step; "
                  "warm up for more steps", file=sys.stderr)
            return {"logit_gap": math.inf, "route_slack": math.inf,
                    "dropped_pairs": float(outputs["dropped"])}
        want, probs = got
        have = outputs["logits"].to(want.device).double()
        gap = ((have - want.double()).abs().amax(-1)
               / want.double().std(-1)).max()
        slack = 0.0
        k = self.cell.cfg["num_experts_per_tok"]
        for j, ids in enumerate(outputs["routes"]):
            p = probs[j].double()
            kth = torch.topk(p, k, -1).values[:, -1:]
            chosen = p.gather(1, ids.to(p.device).long())
            slack = max(slack, float((kth - chosen).clamp_min(0).max()))
        sync(self.cell.device)
        g = float(gap)
        return {"logit_gap": g if math.isfinite(g) else math.inf,
                "route_slack": slack,
                "dropped_pairs": float(outputs["dropped"])}

    def rows_read(self):
        """Cache rows the program's MLA kernel loads a valid row, from one
        launch with its counter on at the first ring slot's lengths (one
        step's first layer), or None where the program has no such
        kernel or counter."""
        if self.cell.device.type != "cuda":
            return None
        try:
            from repro_torch.kernels.mla_decode import ops
            from repro_torch.models.attention import mla_scale
        except ImportError:
            return None
        lens = self.ring[0]["lengths"] + 1
        g = torch.Generator(device=self.cell.device).manual_seed(0)
        m = self.lm.mla
        q_c = torch.randn((self.B, self.lm.n_heads, m.kv_lora), generator=g,
                          device=self.cell.device).to(torch.bfloat16)
        q_r = torch.randn((self.B, self.lm.n_heads, m.d_rope), generator=g,
                          device=self.cell.device).to(torch.bfloat16)
        rows = ops.rows_read(q_c, q_r, self.cache.a[0], self.cache.b[0],
                             lens, mla_scale(self.lm))
        return rows / int(lens.sum())

    def span_ms(self) -> dict | None:
        """Device ms a step of the work launched inside each of the
        program's layer spans, by span name, from ``SPAN_STEPS`` eager
        calls of the window's last step under the profiler (the kernels
        the graph replays, launched one by one so that each lands in the
        span that launched it; a replay opens no span). The calls write
        the cache rows that step wrote, again. Read once; None off the
        card, before a step or without spans."""
        if (self._spans is None and self.cell.device.type == "cuda"
                and self.last is not None):
            from portbench import spans, tracing
            spans.install()
            loop, r = self, self.ring[self.last[0] % self.n_ring]

            class Eager:
                @staticmethod
                def run(seconds=None):
                    with torch.no_grad():
                        for _ in range(SPAN_STEPS):
                            loop.eager(r["tokens"], r["lengths"])
                    sync(loop.cell.device)
                    return {"slots": None, "items": 0, "calls": SPAN_STEPS}
            got = tracing.profile(Eager, 0.0)
            self._spans = {
                name: 1e3 * v["device_s"] / SPAN_STEPS
                for name, v in ((got or {}).get("spans") or {}).items()}
        return self._spans or None
