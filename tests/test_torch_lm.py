"""The port's LM serving path against the reference, with the reference's
weights carried across through numpy: norms, RoPE and the FFN; prefill
attention (chunked, causal and not, the q_blocks split, q_offset);
single-token decode attention; MoE routing and dispatch; ``prefill`` and
``decode_step`` of all five LM architectures at their reduced configs
(logits and caches within 2e-5, the reference's kernel tolerance, and a
step at a full cache); decode ≡ prefill on the port alone (2e-3, as
tests/test_models.py); ``serve_lm`` on the CPU against the reference's
printed figures; and the bfloat16 carry of ``convert``."""
import argparse
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.configs.lm_archs import QWEN3_8B, reduced_lm
from repro.launch import serve as jax_serve
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch import runtime
from repro_torch.convert import kv_cache_from_numpy, params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import attention, layers, moe, transformer

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_LM = dict(rtol=2e-3, atol=2e-3)          # tests/test_models.py
LM_ARCHS = ["qwen3-8b", "smollm-135m", "starcoder2-7b",
            "deepseek-v2-lite-16b", "deepseek-v3-671b"]
# the reference's serving calls, compiled once per config (eager dispatch
# of the MoE path's many small ops costs more than the compile)
ref_prefill = jax.jit(jax_tf.prefill, static_argnums=(2, 3))
ref_decode_step = jax.jit(jax_tf.decode_step, static_argnums=(3,))


def _reduced(arch_id):
    a = registry.get(arch_id)
    return a.reduced(a.config)


def _pair(a):
    """Same numpy float32 values as a JAX array and a CPU tensor."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 4, 8)])
def test_norms_match_reference(shape, rng):
    xj, xt = _pair(rng.normal(size=shape) * 3 + 1)
    sj, st = _pair(rng.normal(size=shape[-1:]))
    bj, bt = _pair(rng.normal(size=shape[-1:]))
    _close(layers.rmsnorm(xt, st, 1e-6), jax_layers.rmsnorm(xj, sj, 1e-6))
    _close(layers.layernorm(xt, st, bt, 1e-5),
           jax_layers.layernorm(xj, sj, bj, 1e-5))
    for kind in ("rmsnorm", "layernorm"):
        p = {"scale": st, "bias": bt}
        _close(layers.norm_apply(xt, p, kind, 1e-5),
               jax_layers.norm_apply(xj, {"scale": sj, "bias": bj}, kind, 1e-5))
        assert sorted(layers.norm_init(4, kind, "float32", "cpu")) == \
            sorted(jax_layers.norm_init(4, kind, jnp.float32))


def test_bf16_norm_computes_in_float32_and_casts_back(rng):
    x = rng.normal(size=(4, 32)).astype(np.float32)
    s = rng.normal(size=(32,)).astype(np.float32)
    got = layers.rmsnorm(torch.as_tensor(x).bfloat16(),
                         torch.as_tensor(s).bfloat16())
    want = jax_layers.rmsnorm(jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(s).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), dict(rtol=2e-2, atol=2e-2))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta, rng):
    B, S, H, D = 2, 7, 3, 16
    xj, xt = _pair(rng.normal(size=(B, S, H, D)))
    pos = rng.integers(0, 500, (B, S))
    got = layers.apply_rope(xt, torch.as_tensor(pos), theta)
    want = jax_layers.apply_rope(xj, jnp.asarray(pos), theta)
    _close(got, want)
    _close(layers.rope_freqs(D, theta), jax_layers.rope_freqs(D, theta))
    # grouped q rotates per (Hkv * G) head
    qj, qt = _pair(rng.normal(size=(B, S, 2, 3, D)))
    _close(attention.apply_rope_grouped(qt, torch.as_tensor(pos), theta),
           jax_attn.apply_rope_grouped(qj, jnp.asarray(pos), theta))


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", False)])
def test_mlp_matches_reference(act, glu, rng):
    ref = jax_layers.mlp_init(jax.random.PRNGKey(0), 16, 40, 12, glu,
                              jnp.float32)
    port = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    xj, xt = _pair(rng.normal(size=(5, 16)))
    _close(layers.mlp_apply(port, xt, act, glu),
           jax_layers.mlp_apply(ref, xj, act, glu))
    drawn = layers.mlp_init(torch.Generator().manual_seed(0), 16, 40, 12, glu,
                            "float32", "cpu")
    assert {k: tuple(v.shape) for k, v in drawn.items()} == \
        {k: v.shape for k, v in ref.items()}


# -------------------------------------------------------- prefill attention

@pytest.mark.parametrize("Sq,Sk,chunk,causal,q_offset,q_blocks", [
    (16, 16, 4, True, 0, 4),       # the q_blocks causal split
    (16, 16, 5, True, 0, 4),       # Sq // q_blocks < chunk: one scan
    (12, 12, 5, False, 0, 4),      # not causal, a ragged last chunk
    (6, 20, 8, True, 14, 4),       # chunked prefill: q starts at 14
    (9, 9, 32, True, 0, 1),        # one chunk larger than the sequence
])
def test_chunked_attention_matches_reference(Sq, Sk, chunk, causal, q_offset,
                                             q_blocks, rng):
    B, H, G, D, Dv = 2, 2, 3, 8, 6
    qj, qt = _pair(rng.normal(size=(B, Sq, H, G, D)))
    kj, kt = _pair(rng.normal(size=(B, Sk, H, D)))
    vj, vt = _pair(rng.normal(size=(B, Sk, H, Dv)))
    kw = dict(causal=causal, chunk=chunk, q_offset=q_offset, q_blocks=q_blocks)
    got = attention.chunked_attention(qt, kt, vt, **kw)
    assert got.shape == (B, Sq, H, G, Dv)
    _close(got, jax_attn.chunked_attention(qj, kj, vj, **kw))
    kw["scale"] = 0.3
    _close(attention.chunked_attention(qt, kt, vt, **kw),
           jax_attn.chunked_attention(qj, kj, vj, **kw))


@pytest.mark.parametrize("L", [1, 13, 24])
def test_decode_attention_matches_reference(L, rng):
    B, S, H, G, D = 2, 24, 2, 3, 16
    qj, qt = _pair(rng.normal(size=(B, 1, H, G, D)))
    kj, kt = _pair(rng.normal(size=(B, S, H, D)))
    vj, vt = _pair(rng.normal(size=(B, S, H, D)))
    want = jax_attn.decode_attention(qj, kj, vj, jnp.asarray(L))
    _close(attention.decode_attention(qt, kt, vt, L), want)
    _close(attention.decode_attention(qt, kt, vt,
                                      torch.tensor(L, dtype=torch.int32)), want)


def test_cache_write_clamps_like_dynamic_update_slice():
    cache = torch.zeros((1, 5))
    attention._write_cache(cache, torch.ones((1, 2)), torch.tensor(4))
    assert cache.tolist() == [[0, 0, 0, 1, 1]]
    want = jax.lax.dynamic_update_slice_in_dim(jnp.zeros((1, 5)),
                                               jnp.ones((1, 2)), 4, 1)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want))


# --------------------------------------------------------------------- MoE

@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_moe_matches_reference(capacity_factor, rng):
    """The single-device dispatch, with and without capacity drops (0.5
    drops pairs, which then hit the zero sentinel row)."""
    cfg = dataclasses.replace(_reduced("deepseek-v2-lite-16b").moe,
                              capacity_factor=capacity_factor)
    ref = jax_moe.moe_expert_init(jax.random.PRNGKey(3), 32, cfg, jnp.float32)
    port = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    xj, xt = _pair(rng.normal(size=(3, 11, 32)))
    got, aux = moe.moe_apply(port, xt, cfg, "silu")
    want, want_aux = jax_moe.moe_apply(ref, xj, cfg, "silu")
    _close(got, want)
    _close(aux, want_aux)
    # under an installed mesh whose model axis is 1 the experts do not
    # split: the single-device path, as the reference's ``ep`` test says
    with runtime.use_mesh(abstract_mesh((2, 1), ("data", "model"))):
        got_mesh, aux_mesh = moe.moe_apply(port, xt, cfg, "silu")
    torch.testing.assert_close(got_mesh, got, rtol=0, atol=0)
    torch.testing.assert_close(aux_mesh, aux, rtol=0, atol=0)


# ------------------------------------------------------ prefill + decode

@pytest.fixture(scope="module", params=LM_ARCHS)
def lm(request):
    """(cfg, reference params, port params) for one reduced LM arch."""
    cfg = _reduced(request.param)
    ref = jax_tf.init(jax.random.PRNGKey(0), cfg)
    return cfg, ref, params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")


def _close_cache(got, want, tol=TOL):
    _close(got.a, want.a, tol)
    _close(got.b, want.b, tol)
    assert int(got.length) == int(want.length)
    assert got.length.dtype == torch.int32 and got.length.dim() == 0


def test_prefill_and_decode_match_reference(lm, rng):
    """Prefill 9 tokens into a 16-slot cache, then three teacher-forced
    decode steps: logits and both cache stacks within 2e-5."""
    cfg, ref, port = lm
    toks = rng.integers(0, cfg.vocab, (2, 12))
    lj, cj = ref_prefill(ref, jnp.asarray(toks[:, :9], jnp.int32), cfg, 16)
    lt, ct = transformer.prefill(port, torch.as_tensor(toks[:, :9]), cfg,
                                 smax=16)
    assert lt.dtype == torch.float32 and lt.shape == (2, cfg.vocab)
    _close(lt, lj)
    _close_cache(ct, cj)
    for s in range(9, 12):
        lj, cj = ref_decode_step(ref, cj, jnp.asarray(toks[:, s:s + 1],
                                                      jnp.int32), cfg)
        lt, ct = transformer.decode_step(port, ct, torch.as_tensor(
            toks[:, s:s + 1]), cfg)
        _close(lt, lj)
        _close_cache(ct, cj)
    assert int(ct.length) == 12


def test_decode_at_a_full_cache_clamps_like_reference(lm, rng):
    """A step at a full cache: the write lands at the last slot (the
    reference's dynamic_update_slice clamps its start) and every slot is
    attended. The reference's cache is carried across with
    kv_cache_from_numpy."""
    cfg, ref, port = lm
    toks = rng.integers(0, cfg.vocab, (2, 9))
    _, cj = ref_prefill(ref, jnp.asarray(toks[:, :8], jnp.int32), cfg, 8)
    ct = kv_cache_from_numpy(jax.tree.map(np.asarray, cj), "cpu")
    _close_cache(ct, cj, dict(rtol=0, atol=0))
    lj, cj = ref_decode_step(ref, cj, jnp.asarray(toks[:, 8:], jnp.int32),
                             cfg)
    lt, ct = transformer.decode_step(port, ct, torch.as_tensor(toks[:, 8:]),
                                     cfg)
    _close(lt, lj)
    _close_cache(ct, cj)
    assert int(ct.length) == 9


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_decode_matches_prefill_on_the_port(arch_id, rng):
    """Decoding token t after prefilling t-1 equals prefilling t, on the
    port alone (tests/test_models.py's property, same tolerance)."""
    cfg = _reduced(arch_id)
    params = transformer.init(torch.Generator().manual_seed(1), cfg, "cpu")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 12)))
    full, _ = transformer.prefill(params, toks, cfg, smax=16)
    _, cache = transformer.prefill(params, toks[:, :-1], cfg, smax=16)
    step, cache = transformer.decode_step(params, cache, toks[:, -1:], cfg)
    np.testing.assert_allclose(step.numpy(), full.numpy(), **TOL_LM)
    assert int(cache.length) == 12


def test_port_init_matches_reference_layout(lm):
    cfg, ref, _port = lm
    drawn = transformer.init(torch.Generator().manual_seed(0), cfg, "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)

    def tree_shapes(t):
        return ({k: tree_shapes(v) for k, v in t.items()}
                if isinstance(t, dict) else tuple(t.shape))
    assert tree_shapes(drawn) == shapes
    cache = transformer.KVCache.zeros(cfg, 3, 16, "cpu")
    want = jax_tf.KVCache.shapes(cfg, 3, 16)
    assert tuple(cache.a.shape) == want.a.shape
    assert tuple(cache.b.shape) == want.b.shape
    assert cache.length.dtype == torch.int32 and int(cache.length) == 0


# ------------------------------------------------------------------ serve

def test_serve_lm_matches_reference_figures():
    """The port's serve_lm at reduced smollm, with the reference's
    PRNGKey(0) weights injected, decodes the same number of steps with the
    same slot utilization and completions as the reference's line."""
    args = argparse.Namespace(arch="smollm-135m", requests=6, reduced=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_serve.serve_lm(args)
    m = re.search(r"decoded (\d+) steps for 6 requests \(.* ms/step, slot "
                  r"utilization ([\d.]+), completed (\d+)\)", out.getvalue())
    assert m, out.getvalue()
    ref = jax_tf.init(jax.random.PRNGKey(0), _reduced("smollm-135m"))
    fig = serve.serve_lm(args, params=params_from_numpy(
        jax.tree.map(np.asarray, ref), "cpu"), device="cpu")
    assert (fig["steps"], f"{fig['utilization']:.2f}", fig["completed"]) == \
        (int(m.group(1)), m.group(2), int(m.group(3)))
    assert fig["tokens"] > 0


# ----------------------------------------------------------------- convert

def test_convert_carries_bf16_params_bit_for_bit():
    """Reduced qwen3-8b with bfloat16 parameters: every leaf arrives as
    torch.bfloat16 with the reference's bits."""
    cfg = dataclasses.replace(reduced_lm(QWEN3_8B), param_dtype="bfloat16")
    ref = jax.tree.map(np.asarray, jax_tf.init(jax.random.PRNGKey(0), cfg))
    port = params_from_numpy(ref, "cpu")
    pairs = zip(jax.tree.leaves(ref), jax.tree.leaves(port))
    n = 0
    for want, got in pairs:
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
            n += 1
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    assert n > 10
    # and the port computes with them: bf16 logits near the reference's
    toks = np.arange(8).reshape(1, 8)
    lj, _ = jax_tf.prefill(jax.tree.map(jnp.asarray, ref),
                           jnp.asarray(toks, jnp.int32), cfg, smax=8)
    lt, _ = transformer.prefill(port, torch.as_tensor(toks), cfg, smax=8)
    _close(lt, lj, dict(rtol=5e-2, atol=5e-2))
