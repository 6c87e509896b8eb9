"""Packed-q4 weights and int8 activations (W8A8) in the port, against the
JAX package on the CPU: the q4 weight format (recode, unpack, dequant, the
``--type q4`` container), the activation codes, kernel 1's q4 and a8
branches (their plain versions against ``pallas_qmatmul_stacked`` in
interpret mode), the megakernel's a8 and q4 bodies (``fused_decode_step_plain``
against the JAX ``fused_decode_step`` in interpret mode), the engines on
both decode paths with ``a8_decode``/``a8_prefill``, and the harness's
``--q4`` (q4 experts: ``tests/test_torch_moe_q4.py``).

q4 needs K/2 to be a multiple of the group, so the model is the 256-wide
tiny Llama of ``tests/test_q4.py::test_q4_from_xalm_load_time_recode``, its
vocabulary widened to 512 so that the JAX megakernel takes the i8-head fold.

Tolerances, each with its reason:

- the recode, the x codes and the W8A8 product are bit-equal;
- the q4 product within 1e-5 of each output row's max: its group dots are
  exact on both sides, but XLA on the CPU may fuse a group's scale multiply
  and the running sum into one FMA, which the port (and its kernel) round
  separately;
- the megakernel, each step started from the JAX step's cache (the runs
  would otherwise drift apart: one bf16 K value rounded the other way
  changes a later attn row by 1e-7, which can move an int8 code of it by
  one count, a step of 1/127 of the row's max): 90 % of the steps within
  1e-5 of their max |ref| (x, logits), every step within 5e-2 and every
  cache row within 2e-2 of its max. Both sides quantise the same f32 rows,
  but the sums run in another order (and the JAX kernel, compiled, takes
  x's scale as amax times the f32 reciprocal of 127 where the port
  divides, the reference wrapper's eager formula), so a rare code lands one
  count apart: on this model that moved one q4 step of 22 by 2.6e-2, while
  every other step stayed within 4e-7;
- engine logits within 3e-2 of max |logits| (the W8A8 prefill quantises
  every row of the chunk, so the rare code a count apart falls on some
  row: 1.1e-2 measured), greedy tokens and the harness's text identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu.harness import main as jax_harness
from xalm_tpu.io import XalmFile as JaxXalmFile
from xalm_tpu.models.config import ModelConfig as JaxConfig
from xalm_tpu.models.llama import rope_freqs as jax_rope_freqs
from xalm_tpu.models.params import QWeight as JaxQWeight
from xalm_tpu.models.params import load_params as jax_load_params
from xalm_tpu.models.params import recode_params_q4 as jax_recode_params_q4
from xalm_tpu.models.params import recode_qweight_q4 as jax_recode_qweight_q4
from xalm_tpu.models.params import recode_wcls_i8 as jax_recode_wcls_i8
from xalm_tpu.models.params import unpack_q4 as jax_unpack_q4
from xalm_tpu.ops.fused_decode import fused_decode_step as jax_fused_decode_step
from xalm_tpu.ops.pallas_attention import rope_cos_sin_plus1 as jax_cos_sin_plus1
from xalm_tpu.ops.pallas_matmul import pallas_qmatmul_stacked
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu.utils.synthetic import MISTRAL_7B as JAX_MISTRAL_7B
from xalm_tpu.utils.synthetic import synthetic_params as jax_synthetic_params
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.io import XalmFile
from xalm_tpu_torch.models import llama
from xalm_tpu_torch.models.config import KV_SINKS, ModelConfig
from xalm_tpu_torch.models.params import (
    QWeight,
    from_jax_params,
    load_params,
    recode_params_q4,
    recode_qweight_q4,
    unpack_q4,
)
from xalm_tpu_torch.ops import fused_decode as fd
from xalm_tpu_torch.ops.attention import quant_rows
from xalm_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain
from xalm_tpu_torch.runtime.engine import Engine

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

WIDE = {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 64, "vocab_size": 512}
WINDOW = 32
Q4_TOL = 1e-5  # of each output row's max
STEP_TOL = 5e-2  # of each step's max |ref| (x, logits)
ROW_TOL = 2e-2  # of each cache row's max
CLOSE_TOL, CLOSE_SHARE = 1e-5, 0.9  # most megakernel steps
ENGINE_TOL = 3e-2  # of max |logits|


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _row_rel(got, want) -> float:
    """max over rows (last axis) of max |got - want| / max |want|."""
    got, want = _np(got).astype(np.float32), _np(want).astype(np.float32)
    err = np.abs(got - want).max(axis=-1)
    return float((err / np.maximum(np.abs(want).max(axis=-1), 1e-30)).max())


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float32), _np(want).astype(np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return make_tiny_model(str(tmp_path_factory.mktemp("hf") / "wide"), config_overrides=WIDE)


@pytest.fixture(scope="module")
def wide_i8(hf_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("x") / "wide_i8.xalm")
    assert cvt.main(["--input", hf_dir, "--output", out, "--type", "i8"]) == 0
    return out


# ------------------------------------------------------------- weight format


def _weights(kind: str, shape, rng):
    """(JAX QWeight, port QWeight) of one kind: i8 with row scales, q8, bf16."""
    if kind == "bf16":
        v = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        return (JaxQWeight(jnp.asarray(v).astype(jnp.bfloat16)),
                QWeight(torch.from_numpy(v).to(torch.bfloat16)))
    v = rng.integers(-128, 128, size=shape).astype(np.int8)
    s = rng.uniform(1e-3, 5e-2, size=shape[:-1]).astype(np.float32) if kind == "i8" else None
    return (JaxQWeight(jnp.asarray(v), None if s is None else jnp.asarray(s)),
            QWeight(torch.from_numpy(v.copy()), None if s is None else torch.from_numpy(s.copy())))


@pytest.mark.parametrize("kind", ["i8", "q8", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 512), (2, 3, 64, 512)], ids=["layers", "experts"])
def test_recode_is_bit_equal_to_jax(kind, shape):
    """Codes and scales bit-equal at groups 128 and 256, for stacked layers
    and for (L, E, ...) expert stacks; unpack and dequant equal too."""
    jw, tw = _weights(kind, shape, np.random.default_rng(len(shape)))
    for group in (128, 256):
        want = jax_recode_qweight_q4(jw, group)
        got = recode_qweight_q4(tw, group)
        assert got.q4group == want.q4group == group
        np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
        np.testing.assert_array_equal(unpack_q4(got.values).numpy(),
                                      np.asarray(jax_unpack_q4(want.values)))
        np.testing.assert_array_equal(got.dequant(torch.float32).numpy(),
                                      np.asarray(want.astype_dequant(jnp.float32)))
        assert recode_qweight_q4(got, group) is got  # already packed


def test_recode_params_q4_matches_jax_and_validates_groups():
    jcfg = dataclasses.replace(JAX_MISTRAL_7B, dim=256, hidden_dim=512, head_dim=64,
                               rotary_dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                               vocab_size=512, max_seq_len=64)
    jp = jax_synthetic_params(jcfg, weight_dtype=jnp.int8)
    want = jax_recode_params_q4(jp, group=128)
    got = recode_params_q4(from_jax_params(jax.tree.map(np.asarray, jp), device="cpu"), group=128)
    for name in ("wqkv", "wo", "w13", "w2"):
        g, w = getattr(got.layers, name), getattr(want.layers, name)
        assert g.q4group == w.q4group == 128
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    assert got.wcls.q4group == 0 and got.embed.q4group == 0  # head and embed stay
    with pytest.raises(ValueError):
        recode_qweight_q4(QWeight(torch.zeros((4, 512))), 512)  # does not divide K/2
    with pytest.raises(ValueError):
        recode_qweight_q4(QWeight(torch.zeros((4, 512))), 64)  # not a multiple of 128


def test_q4_container_loads_as_the_jax_loader(hf_dir, tmp_path):
    """A container the JAX converter wrote with ``--type q4``: packed
    (q8-typed) body tensors with .scale4 partners, loaded by the port equal
    to the JAX ``load_params``."""
    out = str(tmp_path / "wide_q4.xalm")
    assert cvt.main(["--input", hf_dir, "--output", out, "--type", "q4",
                     "--q4-group", "128"]) == 0
    jf = JaxXalmFile(out)
    jcfg = JaxConfig.from_metadata(jf.config)
    want = jax_load_params(jf, jcfg, device_put=False)
    jf.close()
    with XalmFile(out) as xf:
        got = load_params(xf, ModelConfig.from_metadata(xf.config), device="cpu")
    for name in ("wqkv", "wo", "w13", "w2"):
        g, w = getattr(got.layers, name), getattr(want.layers, name)
        assert g.q4group == w.q4group == 128
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    np.testing.assert_array_equal(got.layers.attn_norm.numpy(), np.asarray(want.layers.attn_norm))


# ------------------------------------------------------------ activations


def test_activation_codes_bit_equal_to_the_jax_wrapper():
    """``quant_rows`` against the wrapper's own lines (pallas_matmul.py
    :229-233), run as the wrapper runs them: ties at .5 go to even."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 512)).astype(np.float32) * np.array(
        [1, 1e-3, 1e3, 0, 1, 7], np.float32)[:, None]
    x[4, :5] = [127.0, 2.5, -3.5, 0.5, -0.5]  # row scale exactly 1: ties
    x[4, 5:] = 0.25
    amax = jnp.max(jnp.abs(jnp.asarray(x)), axis=-1, keepdims=True)
    sx = jnp.where(amax > 0, amax / 127.0, 1.0)
    want = jnp.clip(jnp.round(jnp.asarray(x) / sx), -127, 127).astype(jnp.int8)
    codes, scale = quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(sx)[:, 0])
    assert codes[4, :5].tolist() == [127, 2, -4, 0, 0]


@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("m", [1, 3])
def test_q4_matmul_matches_jax(group, m):
    rng = np.random.default_rng(group + m)
    jw, tw = _weights("i8", (3, 96, 512), rng)
    jq, tq = jax_recode_qweight_q4(jw, group), recode_qweight_q4(tw, group)
    x = rng.standard_normal((m, 512)).astype(np.float32) * 3
    for layer in (0, 2):
        want = pallas_qmatmul_stacked(jnp.asarray(x), jq.values, jnp.int32(layer), scale=jq.scale,
                                      q4_group=group)
        got = qmatmul(torch.from_numpy(x), tq.values, layer, scale=tq.scale, q4_group=group)
        assert got.shape == (m, 96)
        assert _row_rel(got, want) <= Q4_TOL


@pytest.mark.parametrize("kind", ["i8", "q8"])
@pytest.mark.parametrize("m", [256, 512])
def test_a8_matmul_is_bit_equal_to_jax(kind, m):
    rng = np.random.default_rng(m)
    jw, tw = _weights(kind, (2, 128, 256), rng)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    kw = dict(scale=jw.scale) if kind == "i8" else dict(q8_scale=0.01)
    want = pallas_qmatmul_stacked(jnp.asarray(x), jw.values, jnp.int32(1), a8=True, **kw)
    tkw = dict(scale=tw.scale) if kind == "i8" else dict(q8_scale=0.01)
    got = qmatmul(torch.from_numpy(x), tw.values, 1, a8=True, **tkw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantised_branches_refuse_what_the_reference_refuses():
    tw = recode_qweight_q4(_weights("i8", (1, 64, 256), np.random.default_rng(1))[1], 128)
    x = torch.ones((256, 256))
    with pytest.raises(ValueError, match="decode shapes"):
        qmatmul_plain(x, tw.values, 0, scale=tw.scale, q4_group=128)  # m = 256
    with pytest.raises(ValueError, match="separate"):
        qmatmul_plain(x[:1], tw.values, 0, scale=tw.scale, q4_group=128, a8=True)
    with pytest.raises(ValueError, match="no norm"):
        qmatmul_plain(x[:1], tw.values, 0, scale=tw.scale, q4_group=128,
                      norm_w=torch.ones((1, 256)), norm_eps=1e-5)
    with pytest.raises(ValueError, match="int8"):
        qmatmul_plain(x, torch.ones((1, 64, 256), dtype=torch.bfloat16), 0, a8=True)


# --------------------------------------------------------------- megakernel


@pytest.fixture(scope="module")
def wide_jax(wide_i8):
    return JaxEngine.from_xalm(wide_i8, context=WINDOW, matmul_impl="pallas",
                               kv_dtype=jnp.float32, progress=False)


def _ring(pos: np.ndarray):
    wrapped = pos >= WINDOW
    sink = np.where(wrapped, KV_SINKS, 0)
    kv_pos = sink + (pos - sink) % (WINDOW - sink)
    return (kv_pos.astype(np.int32), np.minimum(pos + 1, WINDOW).astype(np.int32),
            wrapped.astype(np.int32))


MK_CASES = [
    pytest.param(body, b, cache, id=f"{body}-B{b}-{cache}")
    for body in ("a8", "q4") for b in (1, 3) for cache in ("bf16", "int8")
]


@pytest.mark.parametrize("body,b,cache", MK_CASES)
def test_megakernel_bodies_match_jax(wide_jax, body, b, cache):
    """The a8 and q4 bodies through a ring wrap: B = 1 with the i8-head fold
    (the head runs the a8 body too), B = 3 with row 1 at the kv_pos == S
    sentinel; bf16 and int8 caches. Each port step starts from the JAX
    step's cache (see the module docstring)."""
    jcfg = wide_jax.cfg
    cfg = _port_cfg(jcfg)
    jparams = wide_jax.params
    if body == "q4":
        jparams = jax_recode_params_q4(jparams, group=128)
    head = b == 1
    if head:
        jparams = jax_recode_wcls_i8(jparams)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    assert fd.fused_step_supported(cfg, params, torch.empty((1, b, 1, 64, 64)), b, 1, a8=True)
    assert (body == "a8") == fd.fused_step_supported(cfg, params, torch.empty((1, b, 1, 64, 64)),
                                                     b, 1, a8=False)
    freqs = jax_rope_freqs(jcfg)
    c1, s1 = jax_cos_sin_plus1(freqs)
    s_phys = 64  # the window padded
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s_phys, cfg.head_dim)
    quant = cache == "int8"
    if quant:
        jck, jcv = jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8)
        jks, jvs = jnp.ones(shape[:-1], jnp.float32), jnp.ones(shape[:-1], jnp.float32)
        ck, cv = torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8)
        ks, vs = torch.ones(shape[:-1]), torch.ones(shape[:-1])
    else:
        jck, jcv = jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16)
        ck, cv = torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(shape, dtype=torch.bfloat16)
        jks = jvs = ks = vs = None
    folds = dict(wcls=jparams.wcls, out_norm=jparams.out_norm) if head else {}

    @jax.jit
    def jax_step(x0, ck_, cv_, ks_, vs_, kv_pos, kv_len, rot, cexp, sexp):
        kw = dict(folds, a8=True)
        if quant:
            kw.update(k_scale=ks_, v_scale=vs_)
        return jax_fused_decode_step(jparams, jcfg, x0, ck_, cv_, kv_pos, kv_len, rot, cexp,
                                     sexp, jnp.asarray(c1), jnp.asarray(s1), **kw)

    emb = _np(jparams.embed.values).astype(np.float32)
    if jparams.embed.scale is not None:
        emb = emb * _np(jparams.embed.scale)[:, None]
    rng = np.random.default_rng(b)
    start = np.array([0, 9, 20][:b])
    steps = WINDOW + 6  # the first wrap, its sink rotation included
    rels = []
    for st in range(steps):
        pos = (start + st).astype(np.int32)
        kv_pos, kv_len, rot = _ring(pos)
        if b == 3:  # row 1 is an inactive slot: its writes drop, its sinks stay
            kv_pos[1], rot[1] = WINDOW, 0
        tok = rng.integers(3, cfg.vocab_size, size=b)
        x0 = emb[tok]
        ang = pos[:, None].astype(np.float32) * freqs[None]
        cexp = np.repeat(np.cos(ang), 2, axis=-1).astype(np.float32)
        sexp = np.repeat(np.sin(ang), 2, axis=-1).astype(np.float32)
        jck0, jcv0, jks0, jvs0 = jck, jcv, jks, jvs
        want = jax_step(jnp.asarray(x0), jck, jcv, jks, jvs,
                        *map(jnp.asarray, (kv_pos, kv_len, rot, cexp, sexp)))
        kw = dict(wcls=params.wcls, out_norm=params.out_norm) if head else {}
        for t, j in zip((ck, cv, ks, vs), (jck0, jcv0, jks0, jvs0)):
            if t is not None:
                t.copy_(torch.from_numpy(np.array(_np(j))))
        if quant:
            kw.update(k_scale=ks, v_scale=vs)
        got = fd.fused_decode_step(params, cfg, torch.from_numpy(x0), ck, cv,
                                   *map(torch.from_numpy, (kv_pos, kv_len, rot, cexp, sexp, c1,
                                                           s1)), a8=True, **kw)
        if quant:
            jck, jcv, jks, jvs = want[-4:]
        else:
            jck, jcv = want[-2:]
        pairs = [(got[0], want[0])] + ([(got[1], want[1])] if head else [])
        for g, w in pairs:
            assert torch.isfinite(g).all()
            r = _rel(g, w)
            rels.append(r)
            assert r <= STEP_TOL, f"step {st}: {r}"
        if head:
            logits = _np(want[1])
            top2 = np.sort(logits, axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 2 * STEP_TOL * np.abs(logits).max()
            np.testing.assert_array_equal(got[2].numpy()[clear], np.asarray(want[2])[:, 0][clear])
        if quant:
            deq = lambda c, s: _np(c).astype(np.float32) * _np(s)[..., None]  # noqa: E731
            assert _row_rel(deq(ck, ks), deq(jck, jks)) <= ROW_TOL
            assert _row_rel(deq(cv, vs), deq(jcv, jvs)) <= ROW_TOL
        else:
            assert _row_rel(ck, jck) <= ROW_TOL and _row_rel(cv, jcv) <= ROW_TOL
    assert np.mean(np.asarray(rels) <= CLOSE_TOL) >= CLOSE_SHARE, sorted(rels)[-5:]


# ------------------------------------------------------------------ engines


@pytest.fixture(scope="module")
def q4_engines(wide_i8):
    """The JAX and port engines of the load-time recode (``q4_group=128``),
    megakernel and per-layer decode, i8 head, f32 cache."""
    kw = dict(context=WINDOW, kv_dtype=jnp.float32, wcls_i8=True, q4_group=128, progress=False)
    tkw = dict(context=WINDOW, kv_dtype=torch.float32, wcls_i8=True, q4_group=128, device="cpu")
    return {
        path: (JaxEngine.from_xalm(wide_i8, matmul_impl="pallas", fused_step=fs, **kw),
               Engine.from_xalm(wide_i8, fused_step=fs, **tkw))
        for path, fs in (("megakernel", "auto"), ("perlayer", False))
    }


def test_from_xalm_q4_implies_a8_and_matches_jax_accounting(q4_engines):
    for path, (ref, port) in q4_engines.items():
        assert port.params.layers.wqkv.q4group == 128 and port.a8_decode and not port.a8_prefill
        assert ref.decode_path(1) == port.decode_path(1) == path
        for pos in (0, 7, WINDOW, 100):
            assert port.active_bytes(pos) == ref.active_bytes(pos)
    ref, port = q4_engines["megakernel"]
    no_a8 = Engine(port.cfg, port.params, None, kv_dtype=torch.float32)
    j_no_a8 = JaxEngine(ref.cfg, ref.params, None, matmul_impl="pallas", kv_dtype=jnp.float32)
    assert no_a8.decode_path(1) == j_no_a8.decode_path(1) == "xla"  # q4 dequantizes


@pytest.mark.parametrize("path", ["megakernel", "perlayer"])
def test_q4_engines_match_jax(q4_engines, path):
    """Greedy tokens equal and the decode logits close, prefill chunks
    dequantizing (no a8_prefill) and decode on the q4 body."""
    ref, port = q4_engines[path]
    prompt = np.random.default_rng(9).integers(3, 300, size=6).tolist()
    want, _ = ref.generate(prompt, WINDOW, stop_on_eos=False)
    got, _ = port.generate(prompt, WINDOW, stop_on_eos=False)
    assert got == want
    lr, cr, pos = ref.prefill(prompt, ref.new_cache(1))
    lp, cp, _ = port.prefill(prompt, port.new_cache(1))
    assert _rel(lp, lr) <= ENGINE_TOL
    for i, tok in enumerate(want[:8]):
        p = np.array([pos + i], np.int32)
        lr, cr = ref.decode(np.array([tok]), p, cr)
        lp, cp = port.decode(np.array([tok]), p, cp)
        assert _rel(lp, lr) <= ENGINE_TOL


def test_a8_prefill_logits_match_jax(wide_i8):
    """i8 body with ``a8_prefill``: a 250-token prompt is one 256-row chunk,
    whose matmuls take the W8A8 branch; and ``a8_decode`` on the megakernel."""
    ref = JaxEngine.from_xalm(wide_i8, matmul_impl="pallas", kv_dtype=jnp.float32,
                              a8_prefill=True, a8_decode=True, progress=False)
    port = Engine.from_xalm(wide_i8, kv_dtype=torch.float32, a8_prefill=True, a8_decode=True,
                            device="cpu")
    assert ref.decode_path(1) == port.decode_path(1) == "megakernel"
    calls = []
    real = llama.qmm.qmatmul

    def spy(*a, **kw):
        calls.append(kw.get("a8", False))
        return real(*a, **kw)

    prompt = np.random.default_rng(4).integers(3, 300, size=250).tolist()
    lr, cr, pos = ref.prefill(prompt, ref.new_cache(1))
    llama.qmm.qmatmul = spy
    try:
        lp, cp, _ = port.prefill(prompt, port.new_cache(1))
    finally:
        llama.qmm.qmatmul = real
    assert sum(calls) == 4 * port.cfg.n_layers  # wqkv, wo, w13, w2 of every layer
    assert _rel(lp, lr) <= ENGINE_TOL
    lr, _ = ref.decode(np.array([7]), np.array([pos], np.int32), cr)
    lp, _ = port.decode(np.array([7]), np.array([pos], np.int32), cp)
    assert _rel(lp, lr) <= ENGINE_TOL


def _generated_text(out: str) -> list[str]:
    return out.split("Generation stats")[0].split("Encoding stats")[-1].splitlines()[1:]


def _lines(out: str, keys: tuple[str, ...]) -> list[str]:
    return [ln.strip() for ln in out.splitlines() if ln.strip().startswith(keys)]


def test_harness_q4_identical_to_jax(wide_i8, capsys):
    """``--q4 128``: the completion text, the active-bytes line and the
    perplexity equal the JAX harness's, the decode path printed."""
    base = [wide_i8, "-T", str(WINDOW), "--q4", "128", "--wcls-i8"]
    args = base + ["-m", "c", "-i", "hello world the quick", "-n", "12"]
    assert jax_harness.main(args + ["--matmul", "pallas", "-t", "f32"]) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "-t", "f32"]) == 0
    got = capsys.readouterr().out
    assert "decode path: megakernel" in got
    assert _generated_text(got) == _generated_text(want)
    keys = ("active bytes",)
    assert _lines(got, keys) == _lines(want, keys)
    args = base + ["-m", "perplexity", "-i", "the quick brown fox is here and there again"]
    assert jax_harness.main(args + ["--matmul", "pallas", "-t", "f32"]) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "-t", "f32"]) == 0
    got = capsys.readouterr().out
    ppl = lambda out: float(_lines(out, ("perplexity:",))[0].split()[1])  # noqa: E731
    assert abs(ppl(got) - ppl(want)) / ppl(want) < 1e-3
