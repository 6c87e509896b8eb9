"""Each kernel module of the port against the JAX function it replaces,
called directly (its Pallas kernel runs in interpret mode on the CPU). On
CPU tensors the port's wrappers run the kernels' plain versions, which are
what the CUDA kernels are held against on the card.

Tolerances:
- matmul: f32 accumulation of exact bf16 x {int8, bf16} products in
  another order, plus a rare one-ulp bf16 rounding difference of the normed
  activation (rsqrt differs in the last bit): 1e-4 relative to max |y|.
- attention with f32 caches: f32 everywhere, summation order only: 1e-5.
- attention with bf16 caches: rows are rounded to bf16 identically (both
  round to nearest even), so the insert is bit-exact; the sink rotation's
  f32 products may round differently by an ulp before the bf16 cast (one
  bf16 ulp, 2^-8 relative), and the prefill's p is rounded to bf16 before
  P.V: 2e-2 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xalm_tpu.models.params import QWeight as JaxQWeight
from xalm_tpu.ops.pallas_attention import (
    fused_decode_attention,
    fused_prefill_attention,
    rope_cos_sin_plus1 as jax_cos_sin_plus1,
)
from xalm_tpu.ops.pallas_matmul import pallas_qmatmul, pallas_qmatmul_stacked
from xalm_tpu.runtime.cache import ring_indices as jax_ring_indices
from xalm_tpu_torch.ops import attention as ops_attn
from xalm_tpu_torch.ops.qmatmul import qmatmul

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

L, D, N = 2, 96, 128


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# the TPU kernel takes the norm prologue only below 256 rows
@pytest.mark.parametrize(
    "m,norm,scaled",
    [(1, False, False), (1, False, True), (1, True, False), (1, True, True),
     (256, False, False), (256, False, True)],
)
def test_qmatmul_i8_matches_pallas(m, norm, scaled):
    rng = np.random.default_rng(m + 2 * norm + 4 * scaled)
    x = (rng.normal(size=(m, N)) * 0.7).astype(np.float32)
    w = rng.integers(-127, 128, size=(L, D, N)).astype(np.int8)
    scale = (rng.random((L, D)) * 0.02 + 0.001).astype(np.float32)
    nw = (rng.random((L, N)) + 0.5).astype(np.float32)
    for layer in range(L):
        kw = {}
        pkw = {}
        if norm:
            kw.update(norm_w=jnp.asarray(nw), norm_eps=1e-5)
            pkw.update(norm_w=torch.from_numpy(nw), norm_eps=1e-5)
        if scaled:
            kw["scale"] = jnp.asarray(scale)
            pkw["scale"] = torch.from_numpy(scale)
        else:
            kw["q8_scale"] = 0.01
            pkw["q8_scale"] = 0.01
        want = np.asarray(pallas_qmatmul_stacked(jnp.asarray(x), jnp.asarray(w), jnp.int32(layer), **kw))
        got = qmatmul(torch.from_numpy(x), torch.from_numpy(w), layer, **pkw).numpy()
        assert got.shape == (m, D)
        assert _rel(got, want) < 1e-4, (layer, _rel(got, want))


@pytest.mark.parametrize("m", [1, 16])
def test_qmatmul_bf16_head_matches_pallas(m):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(m, N)).astype(np.float32)
    w = torch.from_numpy((rng.normal(size=(D, N)) * 0.05).astype(np.float32)).to(torch.bfloat16)
    wj = jnp.asarray(w.view(torch.int16).numpy()).view(jnp.bfloat16)
    want = np.asarray(pallas_qmatmul(jnp.asarray(x), JaxQWeight(wj)))
    got = qmatmul(torch.from_numpy(x), w[None], 0).numpy()
    assert _rel(got, want) < 1e-4


def test_rope_cos_sin_plus1_matches():
    freqs = (10000.0 ** (-np.arange(0, 16, 2, dtype=np.float32) / 16)).astype(np.float32)
    c, s = ops_attn.rope_cos_sin_plus1(freqs)
    cj, sj = jax_cos_sin_plus1(freqs)
    np.testing.assert_array_equal(c, cj[0])
    np.testing.assert_array_equal(s, sj[0])


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _to_np32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_through_wraps(dtype):
    """Ring insert + sink rotation + flash-decode over 3 wraps of a 20-slot
    window in a 32-row physical plane: row 0 live, row 1 inactive (its
    sentinel write lands in a padding row). Output and the full cache
    planes, padding rows included, are compared at every step."""
    win, s_phys, l, b, kh, g, hd = 20, 32, 2, 2, 2, 2, 16
    h = kh * g
    rng = np.random.default_rng(5)
    ck = torch.from_numpy(rng.normal(size=(l, b, kh, s_phys, hd)).astype(np.float32)).to(dtype)
    cv = torch.from_numpy(rng.normal(size=(l, b, kh, s_phys, hd)).astype(np.float32)).to(dtype)
    ckj, cvj = _to_jax(ck), _to_jax(cv)
    freqs = (10000.0 ** (-np.arange(0, hd, 2, dtype=np.float32) / hd)).astype(np.float32)
    cexp, sexp = ops_attn.rope_cos_sin_plus1(freqs)
    cexp_t, sexp_t = torch.from_numpy(cexp), torch.from_numpy(sexp)
    jfn = jax.jit(fused_decode_attention)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for p in range(3 * win + 2):
        layer = p % l
        pos = np.array([p, 0], np.int32)
        _, kv_pos, kv_len = (np.asarray(a) for a in jax_ring_indices(jnp.asarray(pos), win))
        kv_pos = np.where([True, False], kv_pos, win).astype(np.int32)  # row 1: sentinel
        rotate = np.array([p >= win, False], np.int32)
        q = rng.normal(size=(b, h, hd)).astype(np.float32)
        kn = rng.normal(size=(b, kh, hd)).astype(np.float32)
        vn = rng.normal(size=(b, kh, hd)).astype(np.float32)
        out_j, ckj, cvj = jfn(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), ckj, cvj, jnp.int32(layer),
            jnp.asarray(kv_pos), jnp.asarray(kv_len), jnp.asarray(rotate),
            jnp.asarray(cexp[None]), jnp.asarray(sexp[None]),
        )
        out = ops_attn.fused_decode_attention(
            torch.from_numpy(q), ck, cv, layer, torch.from_numpy(kn), torch.from_numpy(vn),
            torch.from_numpy(kv_pos.copy()), torch.from_numpy(kv_len.copy()),
            torch.from_numpy(rotate), cexp_t, sexp_t)
        assert out.shape == (b, h * hd)
        assert _rel(out.numpy(), np.asarray(out_j)) < tol, f"pos {p}"
        for got, want in ((ck, ckj), (cv, cvj)):
            err = np.abs(got.to(torch.float32).numpy() - _to_np32(want)).max()
            assert err <= tol * 4, f"pos {p}: cache plane err {err}"


def test_decode_attention_kv_len_zero_gives_zero():
    ck = torch.randn(1, 2, 2, 32, 16)
    q = torch.randn(2, 4, 16)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    z, one = torch.zeros(2, 2, 16), torch.ones(16)
    # the write dropped (kv_pos at the sentinel S = 32) and no rotation: the attention alone
    out = ops_attn.fused_decode_attention(q, ck, ck.clone(), 0, z, z, i32(32, 32), i32(0, 5),
                                          i32(0, 0), one, one)
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos0", [0, 24])
def test_prefill_attention_matches(dtype, pos0):
    """Causal flash prefill of a T=32 chunk at pos 0 and at pos 24 over a
    64-row cache that already holds the chunk (and random history)."""
    l, b, kh, g, hd, s, t = 2, 1, 2, 2, 16, 64, 32
    rng = np.random.default_rng(pos0)
    ck = torch.from_numpy(rng.normal(size=(l, b, kh, s, hd)).astype(np.float32)).to(dtype)
    cv = torch.from_numpy(rng.normal(size=(l, b, kh, s, hd)).astype(np.float32)).to(dtype)
    q = rng.normal(size=(b, t, kh * g, hd)).astype(np.float32)
    pos = np.array([pos0], np.int32)
    want = np.asarray(fused_prefill_attention(
        jnp.asarray(q), _to_jax(ck), _to_jax(cv), jnp.int32(1), jnp.asarray(pos)))
    got = ops_attn.flash_prefill(torch.from_numpy(q), ck, cv, 1, torch.from_numpy(pos)).numpy()
    assert got.shape == (b, t, kh * g * hd)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _rel(got, want) < tol


def test_prefill_plain_is_causal_attention():
    """The plain version is plain causal softmax attention (f32 oracle)."""
    rng = np.random.default_rng(3)
    b, t, kh, g, hd, s = 1, 8, 1, 2, 16, 32
    ck = torch.from_numpy(rng.normal(size=(1, b, kh, s, hd)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=(1, b, kh, s, hd)).astype(np.float32))
    q = rng.normal(size=(b, t, kh * g, hd)).astype(np.float32)
    got = ops_attn.flash_prefill_plain(torch.from_numpy(q), ck, cv, 0,
                                       torch.tensor([3], dtype=torch.int32)).numpy()
    for i in range(t):
        for hh in range(g):
            sc = ck[0, 0, 0, : 3 + i + 1].numpy() @ q[0, i, hh] / math.sqrt(hd)
            w = np.exp(sc - sc.max())
            w /= w.sum()
            want = w @ cv[0, 0, 0, : 3 + i + 1].numpy()
            np.testing.assert_allclose(got[0, i, hh * hd:(hh + 1) * hd], want, rtol=1e-5, atol=1e-5)
