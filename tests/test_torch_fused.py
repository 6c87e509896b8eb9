"""The whole-step decode megakernel of the port (``ops/fused_decode.py``; on
the CPU its plain version) against the JAX package's ``fused_decode_step``
(its Pallas kernel in interpret mode), on the tiny i8 model with weights
carried across by ``from_jax_params`` and step inputs made with numpy from
a seed, through three wraps of a 16-slot window: B = 1 and B = 3 with one
row at the kv_pos == S sentinel; with and without the embed fold and the
i8-head fold; f32 and bf16 caches. Then the engines, the i8 head recode,
the gates, the wrapper's call count and the rope constants.

Tolerances. Both sides cast each normed activation, attn and act to bf16
before an i8 matmul, multiply exact products and sum them in f32, in a
different order. Most steps therefore agree to f32 rounding (about 1e-7 of
max |x|), and most cache values exactly (bf16) or to 1e-7 (f32). But an f32
ulp of difference can flip the bf16 rounding of one activation, which moves
it by 2^-8 of itself; on the tiny model such a flip moved the logits by up
to 2.7e-3 of max |logits| and a later K row by 1.02e-2 of its max (55 bf16
ulps of one small element), and a flipped row stays in the cache until the
ring overwrites it. So:

- every step's x and logits within 2e-2 of that step's max |ref|, and every
  cache row (hd values) within 2e-2 of its own max |ref|: above one flip,
  far below what a wrong row, position, rotation or mask gives (O(1));
- 95 % of the cache values within 1e-5 (f32 caches, rtol and atol) or one
  bf16 ulp (bf16 caches), and with f32 caches the median step within 2e-4
  of max |logits| and 1e-5 of max |x| (the tolerances of
  ``tests/test_fused_decode.py`` between the JAX package's own two decode
  paths): flips are rare. A bf16 cache has no median bound: one K value
  rounded the other way in a sink row (never overwritten) moved every later
  step's x by about 5e-4 of its max;
- the greedy token equal to the JAX token wherever the JAX top-2 margin is
  above twice the logits tolerance, and always the argmax of its own logits.
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
from xalm_tpu.ops.pallas_attention import rope_cos_sin_plus1 as jax_cos_sin_plus1
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.models import llama
from xalm_tpu_torch.models.config import KV_SINKS, ModelConfig
from xalm_tpu_torch.models.params import QWeight, from_jax_params, recode_wcls_i8
from xalm_tpu_torch.ops import attention as A
from xalm_tpu_torch.ops import fused_decode as fd
from xalm_tpu_torch.runtime.engine import Engine

WINDOW = 16
STEPS = WINDOW + 2 * (WINDOW - KV_SINKS) + 4  # from pos 0 past three ring wraps
TOL = 2e-2  # of each step's max |ref| (x, logits) or each cache row's max |ref|
MEDIAN_TOL = {"logits": 2e-4, "x": 1e-5}  # f32 caches
BULK = 0.95  # share of cache values within 1e-5 (f32) or one bf16 ulp


@pytest.fixture(scope="module")
def tiny_i8(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny_i8.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    return out


@pytest.fixture(scope="module")
def jax_base(tiny_i8):
    return JaxEngine.from_xalm(tiny_i8, context=WINDOW, matmul_impl="pallas",
                               kv_dtype=jnp.float32, progress=False)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})


def _variant(jparams, embed: bool, head: bool):
    """(JAX params, port params): a bf16 embed table for the embed fold, an
    i8 head (the JAX recode) for the head fold."""
    if embed:
        jparams = dataclasses.replace(
            jparams, embed=JaxQWeight(jparams.embed.values.astype(jnp.bfloat16)))
    if head:
        jparams = jax_recode_wcls_i8(jparams)
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams))


def _ring(pos: np.ndarray):
    """(kv_pos, kv_len, rotate) of the StreamingLLM window at positions pos."""
    wrapped = pos >= WINDOW
    sink = np.where(wrapped, KV_SINKS, 0)
    kv_pos = sink + (pos - sink) % (WINDOW - sink)
    return (kv_pos.astype(np.int32), np.minimum(pos + 1, WINDOW).astype(np.int32),
            wrapped.astype(np.int32))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _row_rel(got, want) -> float:
    """max over cache rows (hd values) of max |got - want| / max |want|."""
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want).max(axis=-1)
    ref = np.abs(want).max(axis=-1)
    return float((err / np.maximum(ref, 1e-30)).max())


def _bulk_share(got, want, dt: str) -> float:
    """Share of cache values within 1e-5 (f32, rtol and atol) or one bf16
    ulp of the reference (bf16)."""
    got, want = _f32(got), _f32(want)
    d = np.abs(got - want)
    if dt == "f32":
        ok = d <= 1e-5 + 1e-5 * np.abs(want)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
        ok = d <= ulp
    return float(ok.mean())


CASES = [
    pytest.param(b, embed, head, dt, id=f"B{b}-{'embed' if embed else 'x0'}-"
                 f"{'head' if head else 'nohead'}-{dt}")
    for b, embed in ((1, False), (1, True), (3, False))
    for head in (False, True)
    for dt in ("f32", "bf16")
]


@pytest.mark.parametrize("b,embed,head,dt", CASES)
def test_fused_decode_step_matches_jax(jax_base, b, embed, head, dt):
    jcfg = jax_base.cfg
    cfg = _port_cfg(jcfg)
    jparams, params = _variant(jax_base.params, embed, head)
    freqs = jax_rope_freqs(jcfg)
    c1, s1 = jax_cos_sin_plus1(freqs)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    shape = (cfg.n_layers, b, cfg.n_kv_heads, 32, cfg.head_dim)  # the window padded to 32 rows
    jck, jcv = jnp.zeros(shape, jdt), jnp.zeros(shape, jdt)
    ck, cv = torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt)
    folds = dict(wcls=jparams.wcls, out_norm=jparams.out_norm) if head else {}

    @jax.jit
    def jax_step(x0, ck_, cv_, kv_pos, kv_len, rot, cexp, sexp, token, pos):
        extra = dict(folds)
        if embed:
            extra.update(embed=jparams.embed, token=token, pos=pos, freqs=jnp.asarray(freqs))
        return jax_fused_decode_step(jparams, jcfg, x0, ck_, cv_, kv_pos, kv_len, rot, cexp,
                                     sexp, jnp.asarray(c1), jnp.asarray(s1), **extra)

    emb = _f32(jparams.embed.values)
    if jparams.embed.scale is not None:
        emb = emb * _f32(jparams.embed.scale)[:, None]
    rng = np.random.default_rng(7)
    start = np.array([0, 5, 9][:b])
    worst = {"x": 0.0, "logits": 0.0}
    steps = {"x": [], "logits": []}
    for st in range(STEPS):
        pos = (start + st).astype(np.int32)
        kv_pos, kv_len, rot = _ring(pos)
        if b == 3:  # row 1 is an inactive slot: its writes drop, its sinks stay
            kv_pos[1], rot[1] = WINDOW, 0
        tok = rng.integers(3, cfg.vocab_size, size=b).astype(np.int32)
        x0 = emb[tok].astype(np.float32)
        ang = pos[:, None].astype(np.float32) * freqs[None]
        cexp = np.repeat(np.cos(ang), 2, axis=-1).astype(np.float32)
        sexp = np.repeat(np.sin(ang), 2, axis=-1).astype(np.float32)
        want = jax_step(*map(jnp.asarray, (x0,)), jck, jcv,
                        *map(jnp.asarray, (kv_pos, kv_len, rot, cexp, sexp, tok, pos)))
        kw = dict(wcls=params.wcls, out_norm=params.out_norm) if head else {}
        if embed:
            kw.update(embed=params.embed, token=torch.from_numpy(tok),
                      pos=torch.from_numpy(pos), freqs=torch.from_numpy(freqs))
        got = fd.fused_decode_step(params, cfg, torch.from_numpy(x0), ck, cv,
                                   *map(torch.from_numpy, (kv_pos, kv_len, rot, cexp, sexp, c1,
                                                           s1)), **kw)
        assert got[-2] is ck and got[-1] is cv  # the caches are updated in place
        jck, jcv = want[-2], want[-1]
        outs = [("x", got[0], want[0])] + ([("logits", got[1], want[1])] if head else [])
        for name, g, w in outs:
            assert g.shape == w.shape and torch.isfinite(g).all()
            r = _rel(g, w)
            steps[name].append(r)
            worst[name] = max(worst[name], r)
            assert r <= TOL, f"step {st} {name}: {r}"
        if head:
            logits = _f32(want[1])
            top2 = np.sort(logits, axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 2 * TOL * np.abs(logits).max()
            tok_j = np.asarray(want[2])[:, 0]
            assert got[2].dtype == torch.int32 and got[2].shape == (b,)
            np.testing.assert_array_equal(got[2].numpy()[clear], tok_j[clear])
            np.testing.assert_array_equal(got[2].numpy(), np.argmax(got[1].numpy(), axis=-1))
    assert pos[0] >= WINDOW + 2 * (WINDOW - KV_SINKS)  # three wraps
    for got_c, want_c in ((ck, jck), (cv, jcv)):
        assert _row_rel(got_c, want_c) <= TOL
        assert _bulk_share(got_c, want_c, dt) >= BULK
    for name, rs in steps.items():
        if rs and dt == "f32":
            assert float(np.median(rs)) <= MEDIAN_TOL[name], (name, worst, np.median(rs))


def test_fused_decode_sentinel_row_writes_nothing(jax_base):
    """A row at kv_pos == S (max_seq_len) with rotate 0 leaves every slot it
    attends as it was: the write lands in the first padding row of the
    32-row plane, which is never attended (as in the JAX kernel)."""
    cfg = _port_cfg(jax_base.cfg)
    _, params = _variant(jax_base.params, False, False)
    rng = np.random.default_rng(3)
    shape = (cfg.n_layers, 2, cfg.n_kv_heads, 32, cfg.head_dim)
    ck = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    before_k, before_v = ck.clone(), cv.clone()
    c1, s1 = A.rope_cos_sin_plus1(llama.rope_freqs(cfg))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    x0 = torch.from_numpy(rng.normal(size=(2, cfg.dim)).astype(np.float32))
    trig = torch.ones((2, cfg.head_dim)), torch.zeros((2, cfg.head_dim))
    fd.fused_decode_step(params, cfg, x0, ck, cv, i32(WINDOW, 20), i32(WINDOW, WINDOW),
                         i32(0, 1), *trig, torch.from_numpy(c1), torch.from_numpy(s1))
    live = slice(0, WINDOW)
    assert torch.equal(ck[:, 0, :, live], before_k[:, 0, :, live])
    assert torch.equal(cv[:, 0, :, live], before_v[:, 0, :, live])
    assert not torch.equal(ck[:, 1, :, 20], before_k[:, 1, :, 20])  # row 1 wrote slot 20
    assert not torch.equal(ck[:, 1, :, :KV_SINKS], before_k[:, 1, :, :KV_SINKS])  # and rotated


@pytest.fixture(scope="module")
def engines(tiny_i8):
    ref = JaxEngine.from_xalm(tiny_i8, context=WINDOW, matmul_impl="pallas",
                              kv_dtype=jnp.float32, compute_dtype=jnp.float32, progress=False)
    port = Engine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, device="cpu")
    return ref, port


def test_engines_take_the_megakernel_path_and_agree(engines):
    ref, port = engines
    assert ref.decode_path(1) == port.decode_path(1) == "megakernel"
    prompt = [1, 259, 260, 10, 20, 300, 5]
    want, _ = ref.generate(prompt, 3 * WINDOW, stop_on_eos=False)
    got, _ = port.generate(prompt, 3 * WINDOW, stop_on_eos=False)
    assert got == want


def test_engines_with_the_i8_head_agree(tiny_i8):
    ref = JaxEngine.from_xalm(tiny_i8, context=WINDOW, matmul_impl="pallas",
                              kv_dtype=jnp.float32, compute_dtype=jnp.float32, progress=False,
                              wcls_i8=True)
    port = Engine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, device="cpu", wcls_i8=True)
    assert port.params.wcls.values.dtype == torch.int8
    assert fd.wcls_fold_supported(port.cfg, port.params)
    assert ref.decode_path(1) == port.decode_path(1) == "megakernel"
    prompt = [1, 259, 260, 10, 20, 300, 5]
    want, _ = ref.generate(prompt, 3 * WINDOW, stop_on_eos=False)
    got, _ = port.generate(prompt, 3 * WINDOW, stop_on_eos=False)
    assert got == want


def test_decode_path_follows_the_gates(tiny_i8):
    kw = dict(context=WINDOW, device="cpu", compute_dtype=torch.float32)
    assert Engine.from_xalm(tiny_i8, kv_dtype=torch.bfloat16, **kw).decode_path(8) == "megakernel"
    eng = Engine.from_xalm(tiny_i8, kv_dtype=torch.float32, **kw)
    assert eng.decode_path(9) == "perlayer"  # more rows than the kernel's accumulators
    assert Engine.from_xalm(tiny_i8, kv_dtype=torch.float16, **kw).decode_path(1) == "perlayer"
    assert Engine.from_xalm(tiny_i8, kv_dtype=torch.float32, fused_step=False,
                            **kw).decode_path(1) == "perlayer"
    assert Engine.from_xalm(tiny_i8, kv_dtype=torch.float32, matmul_impl="plain",
                            **kw).decode_path(1) == "plain"


def test_gates_refuse_what_the_kernel_does_not_take(jax_base):
    cfg = _port_cfg(jax_base.cfg)
    _, params = _variant(jax_base.params, False, False)
    ck = torch.empty((cfg.n_layers, 1, cfg.n_kv_heads, 32, cfg.head_dim), device="meta")
    assert fd.fused_step_supported(cfg, params, ck, 1, 1)
    assert fd.fused_step_supported(cfg, params, ck.to(torch.bfloat16), 8, 1)
    assert not fd.fused_step_supported(cfg, params, ck, 1, 2)  # a prefill chunk
    assert not fd.fused_step_supported(cfg, params, ck, 9, 1)
    assert not fd.fused_step_supported(cfg, params, ck.to(torch.float16), 1, 1)
    ks = ck[..., 0]
    assert fd.fused_step_supported(cfg, params, ck.to(torch.int8), 1, 1, k_scale=ks)
    assert not fd.fused_step_supported(cfg, params, ck.to(torch.int8), 1, 1)  # no scales
    assert not fd.fused_step_supported(cfg, params, ck, 1, 1, k_scale=ks)  # scales, a float cache
    assert not fd.fused_step_supported(cfg, params, ck, 1, 1, a8=True)
    q8 = dataclasses.replace(params.layers, wo=QWeight(params.layers.wo.values, None))
    assert not fd.fused_step_supported(cfg, dataclasses.replace(params, layers=q8), ck, 1, 1)
    assert not fd.embed_fold_supported(cfg, params)  # an i8 table
    assert not fd.wcls_fold_supported(cfg, params)  # a 16-bit head
    with pytest.raises(ValueError, match="batch"):
        z = torch.zeros((cfg.n_layers, 9, cfg.n_kv_heads, 32, cfg.head_dim))
        fd.fused_decode_step(params, cfg, torch.zeros((9, cfg.dim)), z, z.clone(),
                             *[torch.zeros(9, dtype=torch.int32)] * 3,
                             torch.ones((9, cfg.head_dim)), torch.zeros((9, cfg.head_dim)),
                             torch.ones(cfg.head_dim), torch.zeros(cfg.head_dim))
    z = torch.zeros((cfg.n_layers, 1, cfg.n_kv_heads, 32, cfg.head_dim))

    def step(ck, **kw):
        return fd.fused_decode_step(params, cfg, torch.zeros((1, cfg.dim)), ck, ck.clone(),
                                    *[torch.zeros(1, dtype=torch.int32)] * 3,
                                    torch.ones((1, cfg.head_dim)), torch.zeros((1, cfg.head_dim)),
                                    torch.ones(cfg.head_dim), torch.zeros(cfg.head_dim), **kw)

    with pytest.raises(ValueError, match="belong to an int8 KV cache"):
        step(z, k_scale=z[..., 0], v_scale=z[..., 0].clone())
    with pytest.raises(ValueError, match="int8 KV"):
        step(z.to(torch.int8))  # an int8 cache without its scales
    with pytest.raises(ValueError, match="W8A8"):
        step(z, a8=True)


def test_recode_wcls_i8_is_bit_equal_to_jax(jax_base):
    want = jax_recode_wcls_i8(jax_base.params)
    params = from_jax_params(jax.tree.map(np.asarray, jax_base.params))
    assert params.wcls.values.dtype != torch.int8
    got = recode_wcls_i8(params)
    assert got.wcls.values.dtype == torch.int8
    np.testing.assert_array_equal(got.wcls.values.numpy(), np.asarray(want.wcls.values))
    np.testing.assert_array_equal(got.wcls.scale.numpy(), np.asarray(want.wcls.scale))
    assert recode_wcls_i8(got) is got  # an i8 head is left alone
    tied = dataclasses.replace(params, wcls=params.embed)
    untied = recode_wcls_i8(tied)
    assert untied.wcls is not untied.embed and untied.embed is params.embed


def test_recode_wcls_i8_rounds_half_to_even_and_keeps_zero_rows():
    w = torch.tensor([[127.0, 0.5, 1.5, -2.5], [0.0, 0.0, 0.0, 0.0]], dtype=torch.float32)
    p = dataclasses.replace(_tiny_params(), wcls=QWeight(w, None))
    got = recode_wcls_i8(p).wcls
    assert got.values.tolist() == [[127, 0, 2, -2], [0, 0, 0, 0]]
    assert got.scale.tolist() == [1.0, 1.0]


def _tiny_params():
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = ModelConfig(dim=32, hidden_dim=64, head_dim=8, n_layers=1, n_heads=4, n_kv_heads=2,
                      vocab_size=2, max_seq_len=16, rope_theta=1e4, rotary_dim=8, act="silu")
    return synthetic_params(cfg, device="cpu", seed=0)


def test_kernel_impl_makes_one_megakernel_call_per_decode_step(monkeypatch, tiny_i8):
    """impl="kernel": each decode step is one fused_decode_step call, and
    the per-layer attention wrappers are not called at all."""
    calls = {"fused_decode_step": 0, "kv_update": 0, "flash_decode": 0}
    real = fd.fused_decode_step

    def counted(*args, **kw):
        calls["fused_decode_step"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(fd, "fused_decode_step", counted)
    for name in ("kv_update", "flash_decode"):
        monkeypatch.setattr(A, name, lambda *a, _n=name, **k: calls.__setitem__(_n, calls[_n] + 1))
    port = Engine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, device="cpu", wcls_i8=True)
    out, stats = port.generate([1, 259, 260, 10], 2 * WINDOW, stop_on_eos=False)
    assert len(out) == 2 * WINDOW
    assert calls == {"fused_decode_step": 2 * WINDOW - 1, "kv_update": 0, "flash_decode": 0}
    assert port.step(np.array([[5]]), np.array([40], np.int32), port.new_cache(1),
                     logits_mode="token")[0].shape == (1,)


def test_rope_constants_are_kept_on_the_device_and_unchanged():
    cfg = ModelConfig(dim=64, hidden_dim=128, head_dim=16, n_layers=1, n_heads=4, n_kv_heads=2,
                      vocab_size=8, max_seq_len=16, rope_theta=1e4, rotary_dim=12, act="silu")
    dev = torch.device("cpu")
    freqs, c1, s1 = llama.rope_constants(cfg, dev)
    again = llama.rope_constants(cfg, dev)
    assert all(a is b for a, b in zip(again, (freqs, c1, s1)))  # built once
    np.testing.assert_array_equal(freqs.numpy(), jax_rope_freqs(cfg))
    jc, js = jax_cos_sin_plus1(jax_rope_freqs(cfg))
    np.testing.assert_array_equal(c1.numpy(), jc[0])
    np.testing.assert_array_equal(s1.numpy(), js[0])
