"""The decode cell (``deepseek-v2-lite.decode``) on the CPU at small sizes:
the loop's plan and ring, a sound run correct against the plain
reference, broken timed paths and a slot that never restarted not
correct, the float8 control several times wider than the program, a
planted wrong expert caught by route_slack, and the new metric readers
and counts on a run made by hand."""
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.costs import deepseek_v2, mla_decode
from portbench.loops import decode
from portbench.tests import small_decode
from portbench.tests.small_decode import CELL

SEED = 2**31 + 77


def small(dtype="float32") -> dict:
    return small_decode.overrides(dtype)


def test_the_plan_and_the_ring_follow_the_traffic():
    """Each prompt length and answer length of the multisets once a slot,
    phases within the answers, and step n's lengths those of step n mod
    ring: a slot restarts at its prompt when its answer ends."""
    cell = harness.prepare(CELL, SEED, "cpu", small())
    t, loop = cell.traffic, cell.loop
    p = loop.plan
    assert sorted(p["prompt"]) == [20 + 3 * k for k in range(4)]
    assert sorted(p["answer"]) == [2, 2, 4, 4]
    assert ((0 <= p["phase"]) & (p["phase"] < p["answer"])).all()
    for n in range(2 * t["ring"]):
        lens = loop.ring[n % t["ring"]]["lengths"].numpy()
        np.testing.assert_array_equal(
            lens, p["prompt"] + (n + p["phase"]) % p["answer"])
    assert loop.cache.a.shape == (3, 4, 40, 32)
    # prompt rows drawn, the rest zero
    for s, P in enumerate(p["prompt"]):
        assert bool((loop.cache.a[:, s, :P] != 0).any())
        assert bool((loop.cache.a[:, s, P:] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_sound_run_is_correct(dtype):
    out = harness.run_cell(CELL, SEED, 0.3, False, "cpu", time.perf_counter(),
                           small(dtype))
    assert out["correct"], out["checks"]
    assert out["checks"]["dropped_pairs"]["value"] == 0
    assert out["checks"]["route_slack"]["value"] == 0
    assert out["attempted"] % 4 == 0 and out["attempted"] >= 4
    assert {"pairs_per_s", "batch_p95_ms", "setup_s"} <= set(out["metrics"])


def one_logit_moved(step):
    def wrapped(*a, **k):
        logits, cache = step(*a, **k)
        logits = logits.clone()
        logits[1, 7] += 3 * float(logits[1].std())
        return logits, cache
    return wrapped


def lengths_made_one(step):
    """Every row at the batch's first length (one shared position)."""
    def wrapped(params, cache, *a, **k):
        return step(params, cache._replace(
            length=cache.length[:1].expand_as(cache.length).contiguous()),
            *a, **k)
    return wrapped


def first_row_for_all(step):
    def wrapped(*a, **k):
        logits, cache = step(*a, **k)
        return logits[:1].expand_as(logits).contiguous(), cache
    return wrapped


@pytest.mark.parametrize("fault", [one_logit_moved, lengths_made_one,
                                   first_row_for_all],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "decode_step",
                        fault(transformer.decode_step))
    out = harness.run_cell(CELL, SEED, 0.2, False, "cpu", time.perf_counter(),
                           small())
    assert not out["correct"], out["checks"]


def test_a_slot_that_never_restarted_is_not_correct():
    """After one step a slot that began inside its answer holds answer rows
    no step wrote: the check reads infinite, it does not pass."""
    cell = harness.prepare(CELL, SEED, "cpu", small())
    assert (cell.loop.plan["phase"] > 0).any()
    cell.loop.run(count=1)
    got = cell.loop.check(cell.loop.outputs())
    assert got["logit_gap"] == math.inf
    assert not harness.within(harness.compared(got, cell.limits))


def test_the_control_reads_wider_than_the_program():
    """The reference computed in float8_e4m3fn (weights, residual and
    latents rounded through it, its own experts), in the program's place,
    parts from the reference more than three times wider than the bf16
    program does, and the cell's limits refuse it (set at the published
    sizes from readings on the card)."""
    cell = harness.prepare(CELL, SEED, "cpu", small("bfloat16"))
    with torch.no_grad():
        cell.loop.run(count=cell.traffic["warm_calls"])
        program = cell.loop.check(cell.loop.outputs())
        control = cell.loop.check(cell.loop.control())
    assert control["logit_gap"] > 3 * program["logit_gap"] > 0
    assert harness.within(harness.compared(program, cell.limits))
    assert not harness.within(harness.compared(control, cell.limits))


def a_wrong_expert(routes, n_experts: int, seed: int = 0):
    """Each token's last expert swapped for one of the experts it did not
    choose, at random (the slightest routing fault: one pair a token)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for ids in routes:
        ids = ids.clone()
        for t in range(ids.shape[0]):
            rest = [e for e in range(n_experts) if e not in ids[t].tolist()]
            ids[t, -1] = rest[int(torch.randint(len(rest), (1,),
                                                generator=g))]
        out.append(ids)
    return out


def test_a_wrong_expert_is_caught_by_route_slack():
    """The program's outputs with one expert of each last token swapped
    for another: the reference follows the routes it is given, so
    logit_gap cannot see the fault, and route_slack must."""
    cell = harness.prepare(CELL, SEED, "cpu", small("bfloat16"))
    with torch.no_grad():
        cell.loop.run(count=cell.traffic["warm_calls"])
        out = cell.loop.outputs()
        sound = cell.loop.check(out)
        out["routes"] = a_wrong_expert(out["routes"],
                                       cell.cfg["n_routed_experts"])
        faulty = cell.loop.check(out)
    assert sound["route_slack"] <= cell.limits["route_slack"]
    assert faulty["route_slack"] > cell.limits["route_slack"]
    assert not harness.within(harness.compared(faulty, cell.limits))


def test_the_counts_at_the_published_sizes():
    """A token's linear work is 4.9 GFLOP (2,451M multiply-adds: 27 MLA
    layers of 13.76M, the dense FFN's 67.2M, 26 MoE layers' router, 6
    routed and 2 shared experts, the head's 209.7M); attention 34,816
    FLOP a valid row a layer over length + 1 rows."""
    cfg = harness.load_json(harness.find("configs", "deepseek-v2-lite",
                                         ".json"))
    macs, _ = deepseek_v2.linear_macs(cfg)
    assert macs == 27 * 13_762_560 + 67_239_936 + 26 * (
        131_072 + 6 * 8_650_752 + 17_301_504) + 209_715_200
    lens = torch.tensor([100, 0, 5], dtype=torch.int32)
    f, b = mla_decode.decode(cfg, {"lengths": lens}, None)
    assert f == 27 * 108 * 34_816
    assert b == 27 * 2 * (108 * 576 + 3 * 16 * 1088)
    f2, _ = deepseek_v2.decode(cfg, {"lengths": lens}, None)
    assert f2 == 3 * 2 * macs + f


def test_the_new_readers_on_a_run_made_by_hand():
    """mla_decode_roofline: the traced steps' bound over the device time of
    the kernels named mla_decode_* (the larger of flops at the bf16 peak
    and bytes at HBM's rate); mfu.decode: the window's flops at the bf16
    peak; the span readers from the loop's eager step, the idle share of
    the traced window (``idle.bulk``'s reader); rows read a valid row from
    the loop's counter."""
    cfg = harness.load_json(harness.find("configs", "deepseek-v2-lite",
                                         ".json"))
    lens = torch.full((32,), 24_000, dtype=torch.int32)
    ring = [{"lengths": lens}, {"lengths": lens + 1000}]
    loop = SimpleNamespace(name="decode", ring=ring, rows_read=lambda: 1.0,
                           span_ms=lambda: {"model.moe": 13.0,
                                            "model.attention": 9.0})
    peak = harness.load_json(harness.HERE / "peaks.json")[
        "NVIDIA H100 80GB HBM3"]
    trace = {"slots": np.array([6, 4]), "calls": 10, "busy_s": 0.9,
             "window_s": 1.0, "mla_decode_s": 0.05}
    run = harness.Run(cfg=cfg, traffic={}, loop=loop, weights=None,
                      window={"seconds": 2.0, "slots": np.array([30, 20]),
                              "items": 50 * 32, "latencies": [0.1]},
                      trace=trace, setup_s=1.0, counts={}, peak=peak)

    def reader(name):
        return harness.load_module(harness.find("metrics", name, ".py")).read

    def bound(slot):
        f, b = mla_decode.decode(cfg, ring[slot], None)
        return max(f / peak["bf16_flops_per_s"], b / peak["hbm_bytes_per_s"])
    assert reader("mla_decode_roofline")(run) == pytest.approx(
        100 * (6 * bound(0) + 4 * bound(1)) / 0.05)
    flops = sum(n * deepseek_v2.decode(cfg, ring[s], None)[0]
                for s, n in enumerate((30, 20)))
    assert reader("mfu.decode")(run) == pytest.approx(
        100 * flops / 2.0 / peak["bf16_flops_per_s"])
    assert reader("moe_ms.decode")(run) == pytest.approx(13.0)
    assert reader("attn_ms.decode")(run) == pytest.approx(9.0)
    assert reader("idle.bulk")(run) == pytest.approx(10.0)
    assert reader("mla_rows_read.decode")(run) == 1.0
    untraced = harness.Run(**{**vars(run), "trace": None, "counts": {}})
    for name in ("mla_decode_roofline", "moe_ms.decode", "attn_ms.decode",
                 "idle.bulk", "mla_rows_read.decode"):
        assert reader(name)(untraced) is None
    off_card = harness.Run(**{**vars(run), "peak": None, "counts": {}})
    assert reader("mfu.decode")(off_card) is None


def test_a_cpu_run_reads_no_rows_counter():
    cell = harness.prepare(CELL, SEED, "cpu", small())
    assert cell.loop.rows_read() is None


def test_a_cpu_run_reads_no_span_times():
    cell = harness.prepare(CELL, SEED, "cpu", small())
    cell.loop.run(count=1)
    assert cell.loop.span_ms() is None


def test_the_mla_kernels_are_read_by_name_in_the_window():
    """The roofline's time: the kernels of namespace mla_decode (B6's
    names) inside the window; B6's own, a copy and one outside the window
    are not counted; no window, no reading."""
    mod = harness.load_module(harness.find("metrics", "mla_decode_roofline",
                                           ".py"))
    from portbench import tracing
    events = [
        {"cat": "user_annotation", "name": tracing.WINDOW, "ts": 100,
         "dur": 1000},
        {"cat": "kernel",
         "name": "mla_decode::flash_decode_split_tc(bf16 const*)",
         "ts": 150, "dur": 300},
        {"cat": "kernel", "name": "void mla_decode::flash_decode_combine()",
         "ts": 500, "dur": 20},
        {"cat": "kernel", "ts": 600, "dur": 50,
         "name": "void (anonymous namespace)::flash_decode_split_tc<1>()"},
        {"cat": "kernel", "name": "mla_decode::flash_decode_split_tc_x()",
         "ts": 650, "dur": 7},
        {"cat": "gpu_memcpy", "name": "mla_decode::flash_decode_combine",
         "ts": 700, "dur": 9},
        {"cat": "kernel", "name": "mla_decode::flash_decode_split_tc()",
         "ts": 1200, "dur": 300}]
    assert mod.kernel_s(events) == pytest.approx(320e-6)
    assert mod.kernel_s(events[1:]) is None
    wrapped = tracing.reduce
    mod.install()                               # once: no second wrapper
    assert tracing.reduce is wrapped


def test_the_configuration_keeps_the_published_values():
    cfg = harness.load_json(harness.find("configs", "deepseek-v2-lite",
                                         ".json"))
    lm = decode.lm_config(cfg)
    assert lm.moe.capacity_factor is None and not lm.moe.norm_topk_prob
    assert lm.rope_scaling.factor == 40 and lm.mla.kv_lora == 512
    assert cfg["reduced"] == [] and cfg["max_position_embeddings"] == 163840
    with pytest.raises(ValueError, match="routed_scaling_factor"):
        decode.lm_config({**cfg, "routed_scaling_factor": 2.5})
