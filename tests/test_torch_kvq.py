"""The port's int8 KV cache (int8 codes with per-row f32 scales, ``-t i8``)
against the JAX package on the CPU, through ring wraps with sink
re-rotation:

(a) ``kv_update_q_plain`` + ``flash_decode_q_plain`` (what the kernels
    ``kv_update_q`` and ``flash_decode_q`` run on CPU tensors) against
    ``fused_decode_attention_q`` (its Pallas kernels in interpret mode), at
    head_dim 16 and 128, B = 3: a mid-ring row, a wrapped row whose sinks
    rotate, and a row at the kv_pos == S sentinel;
(b) ``fused_decode_step_plain(k_scale=...)`` against the JAX
    ``fused_decode_step(k_scale=...)`` in interpret mode on the tiny i8
    model, B in {1, 3}, with and without the embed and i8-head folds;
(c) the engines, ``Engine(kv_dtype=torch.int8)`` against
    ``JaxEngine(kv_dtype=jnp.int8)``, on the megakernel path, the per-layer
    path (``fused_step`` set on both) and ``"xla"``;
(d) ``active_bytes`` and the cache geometry.

Tolerances, and why:

- codes: both sides quantise with absmax/127 by IEEE division and round
  half to even, so codes agree exactly wherever their f32 inputs do. The
  inputs can differ in the last ulp (the JAX kernels rotate with rolls,
  ``apply_rope`` with a reshape; sums run in other orders), which moves a
  code on a rounding tie by one count: codes at most one count apart on
  under 2 % of the values, and scales within rtol 2e-3, the bars of
  ``tests/test_quantized_kv.py::test_i8_kv_fused_pallas_matches_xla``;
- (a) attention outputs within 1e-5 of each output row's max: with a 32-row
  window both sides take one block of keys (JAX's block is the whole
  window, the port's chunk 128 rows), so p * v_scale is rounded to bf16 at
  the same max, and only f32 sums of exact products differ in order;
- (b) x and logits within 2e-2 of each step's max, and every dequantised
  cache row within 2e-2 of its max: an f32 ulp can flip the bf16 rounding
  of an activation before an i8 matmul (the reasons of
  ``tests/test_torch_fused.py``), which moves a later K row by more than a
  code count;
- (c) logits within rtol/atol 3e-2 and the same argmax at every step, the
  bars of ``test_i8_kv_fused_pallas_matches_xla``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu.models.llama import rope_freqs as jax_rope_freqs
from xalm_tpu.models.params import QWeight as JaxQWeight
from xalm_tpu.models.params import recode_wcls_i8 as jax_recode_wcls_i8
from xalm_tpu.ops.fused_decode import fused_decode_step as jax_fused_decode_step
from xalm_tpu.ops.pallas_attention import _quant_rows_f32 as jax_quant_rows
from xalm_tpu.ops.pallas_attention import fused_decode_attention_q as jax_attention_q
from xalm_tpu.ops.pallas_attention import rope_cos_sin_plus1 as jax_cos_sin_plus1
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.models.config import KV_SINKS, ModelConfig
from xalm_tpu_torch.models.params import from_jax_params
from xalm_tpu_torch.ops import attention as A
from xalm_tpu_torch.ops import fused_decode as fd
from xalm_tpu_torch.runtime.cache import KVCache
from xalm_tpu_torch.runtime.engine import Engine

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

WINDOW = 16
S_PHYS = 32  # the window padded to 32 rows
STEPS = WINDOW + 2 * (WINDOW - KV_SINKS) + 4  # from pos 0 past three ring wraps
CODE_SHARE = 0.02  # codes one count apart on fewer than this share of values
SCALE_RTOL = 2e-3
OUT_TOL = 1e-5  # (a): of each output row's max
STEP_TOL = 2e-2  # (b): of each step's max (x, logits) or each cache row's max
ENGINE_TOL = dict(rtol=3e-2, atol=3e-2)  # (c)


def _ring(pos: np.ndarray):
    """(kv_pos, kv_len, rotate) of the StreamingLLM window at positions pos."""
    wrapped = pos >= WINDOW
    sink = np.where(wrapped, KV_SINKS, 0)
    kv_pos = sink + (pos - sink) % (WINDOW - sink)
    return (kv_pos.astype(np.int32), np.minimum(pos + 1, WINDOW).astype(np.int32),
            wrapped.astype(np.int32))


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_codes(got, want):
    d = np.abs(_np(got).astype(np.int32) - _np(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < CODE_SHARE, (d.max(), (d > 0).mean())


def _assert_scales(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=SCALE_RTOL, atol=1e-7)


def _row_rel(got, want) -> float:
    """max over rows (last axis) of max |got - want| / max |want|."""
    got, want = _np(got).astype(np.float32), _np(want).astype(np.float32)
    err = np.abs(got - want).max(axis=-1)
    return float((err / np.maximum(np.abs(want).max(axis=-1), 1e-30)).max())


def test_quant_rows_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(6, 128)).astype(np.float32) * np.array([1, 1e-3, 1e3, 0, 1, 1],
                                                                    np.float32)[:, None]
    vals[4, :4] = [127.0, 63.5, -0.5, 1.5]  # ties at the row's own scale of 1
    vals[4, 4:] = 0.25
    codes, scale = A.quant_rows(torch.from_numpy(vals))
    want_c, want_s = jax_quant_rows(jnp.asarray(vals))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_s)[:, 0])
    assert codes.dtype == torch.int8 and scale[3] == 1.0 and not codes[3].any()
    assert codes[4, :4].tolist() == [127, 64, 0, 2]  # half to even


@pytest.mark.parametrize("hd,h,kh", [(16, 4, 2), (128, 8, 2)])
def test_kernel_functions_match_jax_through_wraps(hd, h, kh):
    """(a) B = 3 from random codes and scales: row 0 starts mid-ring, row 1
    already wrapped (its sinks rotate every step), row 2 sits at the
    kv_pos == S sentinel (its writes land in a padding row, never read)."""
    rng = np.random.default_rng(hd)
    L, B = 2, 3
    shape = (L, B, kh, S_PHYS, hd)
    ck = rng.integers(-127, 128, size=shape).astype(np.int8)
    cv = rng.integers(-127, 128, size=shape).astype(np.int8)
    ks = (rng.random(shape[:-1]) * 0.02).astype(np.float32)
    vs = (rng.random(shape[:-1]) * 0.02).astype(np.float32)
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c1, s1 = jax_cos_sin_plus1(freqs)
    step = jax.jit(jax_attention_q)
    jc = tuple(map(jnp.asarray, (ck, cv, ks, vs)))
    tc = tuple(torch.from_numpy(a.copy()) for a in (ck, cv, ks, vs))
    start = np.array([5, WINDOW + 3, 0])
    for st in range(STEPS):
        pos = (start + st).astype(np.int32)
        kv_pos, kv_len, rot = _ring(pos)
        kv_pos[2], kv_len[2], rot[2] = WINDOW, WINDOW, 0
        q = rng.normal(size=(B, h, hd)).astype(np.float32)
        kn, vn = (rng.normal(size=(B, kh, hd)).astype(np.float32) for _ in range(2))
        layer = st % L
        out, *jc = step(*map(jnp.asarray, (q, kn, vn)), *jc, layer,
                        *map(jnp.asarray, (kv_pos, kv_len, rot, c1, s1)))
        t = torch.from_numpy
        A.kv_update_q(*tc, layer, t(kn), t(vn), t(kv_pos), t(rot), t(c1[0]), t(s1[0]))
        got = A.flash_decode_q(t(q), *tc, layer, t(kv_len))
        assert got.shape == (B, h * hd) and torch.isfinite(got).all()
        assert _row_rel(got.reshape(B * h, hd), np.asarray(out).reshape(B * h, hd)) <= OUT_TOL, st
    assert pos[0] >= WINDOW + 2 * (WINDOW - KV_SINKS)  # three wraps
    for g, w in zip(tc[:2], jc[:2]):
        _assert_codes(g, w)
    for g, w in zip(tc[2:], jc[2:]):
        _assert_scales(g, w)
    # the sentinel row: its attended slots unchanged
    np.testing.assert_array_equal(tc[0][:, 2, :, :WINDOW].numpy(), ck[:, 2, :, :WINDOW])
    np.testing.assert_array_equal(tc[2][:, 2, :, :WINDOW].numpy(), ks[:, 2, :, :WINDOW])


def test_kv_update_q_writes_nothing_past_the_plane_and_rotates_only_k():
    rng = np.random.default_rng(1)
    shape = (1, 2, 2, S_PHYS, 16)
    ck, cv = (torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.random(shape[:-1]).astype(np.float32)) for _ in range(2))
    before = [t.clone() for t in (ck, cv, ks, vs)]
    c1, s1 = (torch.from_numpy(a) for a in A.rope_cos_sin_plus1(np.full(8, 0.3, np.float32)))
    new = torch.from_numpy(rng.normal(size=(2, 2, 16)).astype(np.float32))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    A.kv_update_q(ck, cv, ks, vs, 0, new, new, i32(S_PHYS, 9), i32(0, 1), c1, s1)
    for t, b in zip((ck, cv, ks, vs), before):
        assert torch.equal(t[:, 0], b[:, 0])  # row 0: dropped, no rotation
    assert torch.equal(cv[:, 1, :, :KV_SINKS], before[1][:, 1, :, :KV_SINKS])  # V sinks stay
    assert not torch.equal(ck[:, 1, :, :KV_SINKS], before[0][:, 1, :, :KV_SINKS])
    codes, scale = A.quant_rows(new[1])
    assert torch.equal(ck[0, 1, :, 9], codes) and torch.equal(ks[0, 1, :, 9], scale)
    z = torch.zeros((1, 1, 1, S_PHYS, 128), dtype=torch.int8)
    zs = torch.zeros(z.shape[:-1])
    out = A.flash_decode_q(torch.ones((1, 2, 128)), z, z.clone(), zs, zs.clone(), 0, i32(0))
    assert torch.equal(out, torch.zeros((1, 256)))  # kv_len 0 gives 0


@pytest.fixture(scope="module")
def tiny_i8(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny_i8.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    return out


@pytest.fixture(scope="module")
def jax_base(tiny_i8):
    return JaxEngine.from_xalm(tiny_i8, context=WINDOW, matmul_impl="pallas",
                               kv_dtype=jnp.int8, progress=False)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})


@pytest.mark.parametrize("b,folds", [(1, False), (1, True), (3, False), (3, True)])
def test_fused_decode_step_q_matches_jax(jax_base, b, folds):
    """(b) From zeroed planes through three wraps; at B = 3 rows start at 0,
    5 and 9 and row 1 sits at the sentinel. ``folds``: the i8 head, and at
    B = 1 also the embed fold (a bf16 table)."""
    jcfg = jax_base.cfg
    cfg = _port_cfg(jcfg)
    jparams = jax_base.params
    embed = folds and b == 1
    if embed:
        jparams = dataclasses.replace(
            jparams, embed=JaxQWeight(jparams.embed.values.astype(jnp.bfloat16)))
    if folds:
        jparams = jax_recode_wcls_i8(jparams)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    freqs = jax_rope_freqs(jcfg)
    c1, s1 = jax_cos_sin_plus1(freqs)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, S_PHYS, cfg.head_dim)
    jplanes = (jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
               jnp.zeros(shape[:-1], jnp.float32), jnp.zeros(shape[:-1], jnp.float32))
    ck, cv = torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8)
    ks, vs = torch.zeros(shape[:-1]), torch.zeros(shape[:-1])
    head = dict(wcls=jparams.wcls, out_norm=jparams.out_norm) if folds else {}

    @jax.jit
    def jax_step(x0, planes, kv_pos, kv_len, rot, cexp, sexp, token, pos):
        extra = dict(head)
        if embed:
            extra.update(embed=jparams.embed, token=token, pos=pos, freqs=jnp.asarray(freqs))
        jk, jv, jks, jvs = planes
        return jax_fused_decode_step(jparams, jcfg, x0, jk, jv, kv_pos, kv_len, rot, cexp, sexp,
                                     jnp.asarray(c1), jnp.asarray(s1), k_scale=jks, v_scale=jvs,
                                     **extra)

    emb = np.asarray(jnp.asarray(jparams.embed.values, jnp.float32))
    if jparams.embed.scale is not None:
        emb = emb * np.asarray(jparams.embed.scale)[:, None]
    rng = np.random.default_rng(11)
    start = np.array([0, 5, 9][:b])
    for st in range(STEPS):
        pos = (start + st).astype(np.int32)
        kv_pos, kv_len, rot = _ring(pos)
        if b == 3:
            kv_pos[1], rot[1] = WINDOW, 0
        tok = rng.integers(3, cfg.vocab_size, size=b).astype(np.int32)
        x0 = emb[tok].astype(np.float32)
        ang = pos[:, None].astype(np.float32) * freqs[None]
        cexp = np.repeat(np.cos(ang), 2, axis=-1).astype(np.float32)
        sexp = np.repeat(np.sin(ang), 2, axis=-1).astype(np.float32)
        want = jax_step(jnp.asarray(x0), jplanes,
                        *map(jnp.asarray, (kv_pos, kv_len, rot, cexp, sexp, tok, pos)))
        kw = dict(wcls=params.wcls, out_norm=params.out_norm) if folds else {}
        if embed:
            kw.update(embed=params.embed, token=torch.from_numpy(tok),
                      pos=torch.from_numpy(pos), freqs=torch.from_numpy(freqs))
        got = fd.fused_decode_step(params, cfg, torch.from_numpy(x0), ck, cv,
                                   *map(torch.from_numpy, (kv_pos, kv_len, rot, cexp, sexp, c1,
                                                           s1)), k_scale=ks, v_scale=vs, **kw)
        assert len(got) == len(want)
        assert all(g is t for g, t in zip(got[-4:], (ck, cv, ks, vs)))  # in place
        jplanes = tuple(want[-4:])
        outs = [("x", got[0], want[0])] + ([("logits", got[1], want[1])] if folds else [])
        for name, g, w in outs:
            assert g.shape == w.shape and torch.isfinite(g).all()
            assert _row_rel(g.reshape(1, -1), np.asarray(w).reshape(1, -1)) <= STEP_TOL, (st, name)
        if folds:
            np.testing.assert_array_equal(got[2].numpy(), np.argmax(got[1].numpy(), axis=-1))
    assert pos[0] >= WINDOW + 2 * (WINDOW - KV_SINKS)
    jk, jv, jks, jvs = (np.asarray(a) for a in jplanes)
    live = slice(0, WINDOW)
    for c, sc, jc_, jsc in ((ck, ks, jk, jks), (cv, vs, jv, jvs)):
        deq = c.float().numpy() * sc.numpy()[..., None]
        jdeq = jc_.astype(np.float32) * jsc[..., None]
        assert _row_rel(deq[:, :, :, live], jdeq[:, :, :, live]) <= STEP_TOL
        _assert_codes(c[:, :, :, live], jc_[:, :, :, live])


@pytest.mark.parametrize("path", ["megakernel", "perlayer", "xla"])
def test_engines_match_jax(tiny_i8, path):
    """(c) A padded prefill chunk of 10 tokens, then teacher-forced decode
    through 2 * window + 8 positions, logits and argmax at every step, the
    codes and scales at the end."""
    kw = {"megakernel": dict(fused_step=True), "perlayer": dict(fused_step=False),
          "xla": {}}[path]
    impl = "xla" if path == "xla" else "pallas"
    ref = JaxEngine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=jnp.int8, matmul_impl=impl,
                              compute_dtype=jnp.float32, progress=False, **kw)
    port = Engine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=torch.int8, device="cpu",
                            compute_dtype=torch.float32,
                            matmul_impl="xla" if path == "xla" else "kernel", **kw)
    assert ref.decode_path(1) == port.decode_path(1) == path
    rng = np.random.default_rng(4)
    prompt = rng.integers(3, 350, size=10).tolist()
    lr, cr, pr = ref.prefill(prompt, ref.new_cache(1), logits_mode="last")
    lp, cp, pp = port.prefill(prompt, port.new_cache(1), logits_mode="last")
    assert pr == pp and cp.quantized
    np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **ENGINE_TOL)
    for i, tok in enumerate(rng.integers(3, 350, size=2 * WINDOW + 8).tolist()):
        pos = np.array([pp + i], np.int32)
        lr, cr = ref.decode(np.array([tok]), pos, cr)
        lp, cp = port.decode(np.array([tok]), pos, cp)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **ENGINE_TOL, err_msg=f"pos {pos}")
        assert int(lp.argmax()) == int(np.argmax(np.asarray(lr))), f"pos {pos}"
    live = slice(0, WINDOW)
    _assert_codes(cp.k[:, :, :, live], np.asarray(cr.k)[:, :, :, live])
    _assert_codes(cp.v[:, :, :, live], np.asarray(cr.v)[:, :, :, live])
    _assert_scales(cp.k_scale[..., live], np.asarray(cr.k_scale)[..., live])
    _assert_scales(cp.v_scale[..., live], np.asarray(cr.v_scale)[..., live])


def test_generate_and_perplexity_match_jax(tiny_i8):
    ref = JaxEngine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=jnp.int8, matmul_impl="pallas",
                              compute_dtype=jnp.float32, progress=False, fused_step=True)
    port = Engine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=torch.int8, device="cpu",
                            compute_dtype=torch.float32)
    assert ref.decode_path(1) == port.decode_path(1) == "megakernel"
    prompt = [1, 259, 260, 10, 20, 300, 5]
    want, _ = ref.generate(prompt, 3 * WINDOW, stop_on_eos=False)
    got, stats = port.generate(prompt, 3 * WINDOW, stop_on_eos=False)
    assert got == want and stats.active_bytes > 0
    toks = np.random.default_rng(2).integers(3, 350, size=3 * WINDOW + 5).tolist()
    p_ref, _, n_ref = ref.perplexity(toks)
    p_port, _, n_port = port.perplexity(toks)
    assert n_port == n_ref and abs(p_port - p_ref) / p_ref < 1e-2


def test_active_bytes_and_cache_bytes_match_jax(tiny_i8):
    """(d)"""
    ref = JaxEngine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=jnp.int8, progress=False)
    port = Engine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=torch.int8, device="cpu")
    for pos in (0, 5, WINDOW, 100):
        assert port.active_bytes(pos) == ref.active_bytes(pos)
    for b in (1, 3):
        assert port.new_cache(b).nbytes() == ref.new_cache(b).nbytes()
    f16 = Engine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=torch.float16, device="cpu")
    assert port.active_bytes(100) < f16.active_bytes(100)


def test_decode_path_and_gates_for_int8(tiny_i8):
    kw = dict(context=WINDOW, device="cpu", kv_dtype=torch.int8)
    assert Engine.from_xalm(tiny_i8, **kw).decode_path(8) == "megakernel"
    assert Engine.from_xalm(tiny_i8, **kw).decode_path(9) == "perlayer"
    assert Engine.from_xalm(tiny_i8, fused_step=False, **kw).decode_path(1) == "perlayer"
    eng = Engine.from_xalm(tiny_i8, **kw)
    cfg, params = eng.cfg, eng.params
    cache = KVCache.init(cfg, 1, torch.int8, "cpu")
    assert fd.fused_step_supported(cfg, params, cache.k, 1, 1, k_scale=cache.k_scale)
    assert not fd.fused_step_supported(cfg, params, cache.k, 1, 1)  # int8 without scales
    assert not fd.fused_step_supported(cfg, params, cache.k.to(torch.bfloat16), 1, 1,
                                       k_scale=cache.k_scale)  # scales with a float cache
    assert fd.fused_step_supported(cfg, params, cache.k, 1, 1, k_scale=cache.k_scale,
                                   a8=True)  # the a8 body over an int8 cache
