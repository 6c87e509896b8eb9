"""The f32 and f16 KV caches (``-t f32``, ``-t f16``) and kernel 1's fp8
branch in the port, against the JAX package on the CPU:

(a) ``fused_decode_attention`` and ``flash_prefill`` (on CPU tensors their plain
    versions, which the CUDA kernels are held to on the card) over an f32
    cache against ``fused_decode_attention`` / ``fused_prefill_attention``
    in interpret mode, at GQA group 7 and head_dim 96 and 256 (the group
    and head dims of ``tests/test_torch_ops.py`` are 2 and 16);
(b) ``fused_decode_step`` over an f32 cache against the JAX
    ``fused_decode_step`` over an f32 cache, for the i8, a8 and q4 bodies,
    through a ring wrap;
(c) the engines with an f32 and with an f16 cache against the JAX engines,
    on both decode paths, and the harness's ``-t f32`` / ``-t f16``;
(d) the routing by cache dtype: an f16 cache never reaches the attention
    kernels' wrappers or the megakernel (the JAX ``supported_cache_dtype``
    excludes it, and its forward runs the dense attention), an f32 cache
    always does;
(e) ``qmatmul`` with e4m3 and e5m2 weights (its plain version on the CPU)
    against ``pallas_qmatmul_stacked_full`` in interpret mode.

Tolerances, and why:

- (a) 1e-5 of each output's max: f32 values everywhere, nothing rounded to
  bf16, so only the order of the f32 sums differs (the JAX prefill tiles
  512 keys, the port's plain version 64);
- (b) as ``tests/test_torch_q4.py``'s megakernel bodies, each port step
  started from the JAX step's cache: every step's x and logits within 5e-2
  of their max, 90 % of the steps within 1e-5, every cache row within 2e-2
  of its max. The sums run in another order, and an f32 ulp can flip the
  bf16 rounding of an activation (i8 body) or move an int8 code by one
  count (a8, q4) before a matmul;
- (c) logits within 2e-2 of max |logits| at every step, the same argmax
  and greedy tokens, and the harness's text identical: the bf16 or int8
  rounding of an activation is the only place the two can part, as in
  ``tests/test_torch_fused.py``; the harness's perplexity within 1e-4 of
  the JAX one's (it prints four decimals; the f32 sums of the log
  probabilities run in another order: 4e-7 apart on this model);
- (e) 1e-5 of max |y|: every fp8 code widens to bf16 exactly on both sides
  and x rounds to bf16 identically, so the exact products differ only in
  the order of their f32 sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu.harness import main as jax_harness
from xalm_tpu.models.llama import rope_freqs as jax_rope_freqs
from xalm_tpu.models.params import recode_params_q4 as jax_recode_params_q4
from xalm_tpu.models.params import recode_wcls_i8 as jax_recode_wcls_i8
from xalm_tpu.ops.fused_decode import fused_decode_step as jax_fused_decode_step
from xalm_tpu.ops.pallas_attention import fused_decode_attention, fused_prefill_attention
from xalm_tpu.ops.pallas_attention import rope_cos_sin_plus1 as jax_cos_sin_plus1
from xalm_tpu.ops.pallas_matmul import pallas_qmatmul_stacked_full
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.models import llama
from xalm_tpu_torch.models.config import KV_SINKS, ModelConfig
from xalm_tpu_torch.models.params import from_jax_params
from xalm_tpu_torch.ops import attention as A
from xalm_tpu_torch.ops import fused_decode as fd
from xalm_tpu_torch.ops.qmatmul import qmatmul
from xalm_tpu_torch.runtime.engine import Engine

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

F32_TOL = 1e-5  # (a), (e)
STEP_TOL, ROW_TOL = 5e-2, 2e-2  # (b)
CLOSE_TOL, CLOSE_SHARE = 1e-5, 0.9  # (b)
ENGINE_TOL = 2e-2  # (c)
PPL_TOL = 1e-4  # (c), relative
WINDOW = 32
WIDE = {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 64, "vocab_size": 512}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _row_rel(got, want) -> float:
    """max over rows (last axis) of max |got - want| / max |want|."""
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max(axis=-1)
    return float((err / np.maximum(np.abs(want).max(axis=-1), 1e-30)).max())


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})


# ------------------------------------------------- (a) the attention kernels


SHAPES = [pytest.param(g, hd, id=f"g{g}-hd{hd}") for g, hd in ((7, 96), (7, 256))]


@pytest.mark.parametrize("g,hd", SHAPES)
def test_decode_attention_f32_matches_jax(g, hd):
    """Ring insert + sink rotation + flash-decode over an f32 cache through
    a wrap of a 20-slot window in a 32-row plane: row 0 live, row 1 at the
    kv_pos == S sentinel. The output and both planes at every step."""
    win, s_phys, l, b, kh = 20, 32, 2, 2, 1
    h = kh * g
    rng = np.random.default_rng(hd + g)
    ck = torch.from_numpy(rng.normal(size=(l, b, kh, s_phys, hd)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=(l, b, kh, s_phys, hd)).astype(np.float32))
    ckj, cvj = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    freqs = (10000.0 ** (-np.arange(0, hd, 2, dtype=np.float32) / hd)).astype(np.float32)
    cexp, sexp = A.rope_cos_sin_plus1(freqs)
    jfn = jax.jit(fused_decode_attention)
    for p in range(win - 2, win + 4):
        layer = p % l
        wrapped = p >= win
        sink = KV_SINKS if wrapped else 0
        kv_pos = np.array([sink + (p - sink) % (win - sink), win], np.int32)
        kv_len = np.array([min(p + 1, win), 1], np.int32)
        rotate = np.array([wrapped, False], np.int32)
        q = rng.normal(size=(b, h, hd)).astype(np.float32)
        kn = rng.normal(size=(b, kh, hd)).astype(np.float32)
        vn = rng.normal(size=(b, kh, hd)).astype(np.float32)
        want, ckj, cvj = jfn(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), ckj, cvj,
                             jnp.int32(layer), jnp.asarray(kv_pos), jnp.asarray(kv_len),
                             jnp.asarray(rotate), jnp.asarray(cexp[None]),
                             jnp.asarray(sexp[None]))
        got = A.fused_decode_attention(torch.from_numpy(q), ck, cv, layer, torch.from_numpy(kn),
                                       torch.from_numpy(vn), torch.from_numpy(kv_pos),
                                       torch.from_numpy(kv_len), torch.from_numpy(rotate),
                                       torch.from_numpy(cexp), torch.from_numpy(sexp))
        assert got.shape == (b, h * hd)
        assert _rel(got, want) <= F32_TOL, f"pos {p}"
        assert _rel(ck, ckj) <= F32_TOL and _rel(cv, cvj) <= F32_TOL, f"pos {p}"


@pytest.mark.parametrize("g,hd", SHAPES)
@pytest.mark.parametrize("pos0", [0, 40])
def test_prefill_attention_f32_matches_jax(g, hd, pos0):
    """Causal flash prefill of a 16-row chunk at pos 0 and 40 over a 64-row
    f32 cache that already holds it: every row of q rounds nowhere."""
    l, b, kh, s, t = 2, 1, 1, 64, 16
    rng = np.random.default_rng(pos0 + hd)
    ck = rng.normal(size=(l, b, kh, s, hd)).astype(np.float32)
    cv = rng.normal(size=(l, b, kh, s, hd)).astype(np.float32)
    q = rng.normal(size=(b, t, kh * g, hd)).astype(np.float32)
    pos = np.array([pos0], np.int32)
    want = fused_prefill_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                   jnp.int32(1), jnp.asarray(pos))
    got = A.flash_prefill(*map(torch.from_numpy, (q, ck, cv)), 1, torch.from_numpy(pos))
    assert got.shape == (b, t, kh * g * hd)
    assert _rel(got, want) <= F32_TOL


# ------------------------------------------------------- (b) the megakernel


@pytest.fixture(scope="module")
def wide_i8(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "wide"), config_overrides=WIDE)
    out = str(tmp_path_factory.mktemp("x") / "wide_i8.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    return out


@pytest.fixture(scope="module")
def wide_jax(wide_i8):
    return JaxEngine.from_xalm(wide_i8, context=WINDOW, matmul_impl="pallas",
                               kv_dtype=jnp.float32, progress=False)


@pytest.mark.parametrize("body", ["i8", "a8", "q4"])
def test_megakernel_f32_cache_matches_jax(wide_jax, body):
    """B = 1 with the i8-head fold through the first wrap of the window,
    its sink rotation included, over an f32 cache (the 256-wide tiny model:
    q4 needs K/2 to be a multiple of its group). Each port step starts from
    the JAX step's cache."""
    jcfg = wide_jax.cfg
    cfg = _port_cfg(jcfg)
    jparams = wide_jax.params
    if body == "q4":
        jparams = jax_recode_params_q4(jparams, group=128)
    jparams = jax_recode_wcls_i8(jparams)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    a8 = body != "i8"
    freqs = jax_rope_freqs(jcfg)
    c1, s1 = jax_cos_sin_plus1(freqs)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, 64, cfg.head_dim)  # the window padded
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    assert fd.fused_step_supported(cfg, params, ck, 1, 1, a8=a8)
    jck, jcv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)

    @jax.jit
    def jax_step(x0, ck_, cv_, kv_pos, kv_len, rot, cexp, sexp):
        return jax_fused_decode_step(jparams, jcfg, x0, ck_, cv_, kv_pos, kv_len, rot, cexp,
                                     sexp, jnp.asarray(c1), jnp.asarray(s1), wcls=jparams.wcls,
                                     out_norm=jparams.out_norm, a8=a8)

    emb = _np(jparams.embed.values)
    if jparams.embed.scale is not None:
        emb = emb * _np(jparams.embed.scale)[:, None]
    rng = np.random.default_rng(3)
    rels = []
    for p in range(WINDOW + 4):
        wrapped = p >= WINDOW
        sink = KV_SINKS if wrapped else 0
        kv_pos = np.array([sink + (p - sink) % (WINDOW - sink)], np.int32)
        kv_len = np.array([min(p + 1, WINDOW)], np.int32)
        rot = np.array([wrapped], np.int32)
        x0 = emb[rng.integers(3, cfg.vocab_size, size=1)].astype(np.float32)
        ang = np.array([[p]], np.float32) * freqs[None]
        cexp = np.repeat(np.cos(ang), 2, axis=-1).astype(np.float32)
        sexp = np.repeat(np.sin(ang), 2, axis=-1).astype(np.float32)
        ck.copy_(torch.from_numpy(np.array(jck)))
        cv.copy_(torch.from_numpy(np.array(jcv)))
        want = jax_step(jnp.asarray(x0), jck, jcv,
                        *map(jnp.asarray, (kv_pos, kv_len, rot, cexp, sexp)))
        got = fd.fused_decode_step(params, cfg, torch.from_numpy(x0), ck, cv,
                                   *map(torch.from_numpy, (kv_pos, kv_len, rot, cexp, sexp, c1,
                                                           s1)),
                                   wcls=params.wcls, out_norm=params.out_norm, a8=a8)
        jck, jcv = want[-2:]
        for g, w in ((got[0], want[0]), (got[1], want[1])):
            assert torch.isfinite(g).all()
            rels.append(_rel(g, w))
            assert rels[-1] <= STEP_TOL, f"pos {p}: {rels[-1]}"
        logits = _np(want[1])
        top2 = np.sort(logits, axis=-1)[:, -2:]
        if top2[0, 1] - top2[0, 0] > 2 * STEP_TOL * np.abs(logits).max():
            assert int(got[2][0]) == int(np.asarray(want[2])[0, 0])
        assert _row_rel(ck, jck) <= ROW_TOL and _row_rel(cv, jcv) <= ROW_TOL
    assert np.mean(np.asarray(rels) <= CLOSE_TOL) >= CLOSE_SHARE, sorted(rels)[-5:]


# -------------------------------------------------- (c) engines and harness


@pytest.fixture(scope="module")
def tiny_i8(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny_i8.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    return out


CACHES = {"f32": (jnp.float32, torch.float32), "f16": (jnp.float16, torch.float16)}


@pytest.mark.parametrize("path", ["megakernel", "perlayer"])
@pytest.mark.parametrize("kv", ["f32", "f16"])
def test_engines_match_jax(tiny_i8, kv, path):
    """A padded 10-token prefill chunk, then teacher-forced decode through
    two wraps of the window: logits and argmax at every step, and the
    greedy tokens. The f16 cache takes the per-layer path whatever
    ``fused_step`` asks (no megakernel takes it, in either package)."""
    jdt, tdt = CACHES[kv]
    fs = "auto" if path == "megakernel" else False
    ref = JaxEngine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=jdt, matmul_impl="pallas",
                              compute_dtype=jnp.float32, fused_step=fs, progress=False)
    port = Engine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=tdt, compute_dtype=torch.float32,
                            fused_step=fs, device="cpu")
    want_path = "perlayer" if kv == "f16" else path
    assert ref.decode_path(1) == port.decode_path(1) == want_path
    rng = np.random.default_rng(4)
    prompt = rng.integers(3, 350, size=10).tolist()
    lr, cr, pr = ref.prefill(prompt, ref.new_cache(1))
    lp, cp, pp = port.prefill(prompt, port.new_cache(1))
    assert pr == pp and cp.k.dtype == tdt
    assert _rel(lp, lr) <= ENGINE_TOL
    for i, tok in enumerate(rng.integers(3, 350, size=2 * WINDOW).tolist()):
        pos = np.array([pp + i], np.int32)
        lr, cr = ref.decode(np.array([tok]), pos, cr)
        lp, cp = port.decode(np.array([tok]), pos, cp)
        assert _rel(lp, lr) <= ENGINE_TOL, f"pos {pos}"
        assert int(lp.argmax()) == int(np.argmax(np.asarray(lr))), f"pos {pos}"
    want, _ = ref.generate(prompt, 2 * WINDOW, stop_on_eos=False)
    got, _ = port.generate(prompt, 2 * WINDOW, stop_on_eos=False)
    assert got == want


@pytest.mark.parametrize("kv", ["f32", "f16"])
def test_active_and_cache_bytes_match_jax(tiny_i8, kv):
    """An f32 cache counts 4 bytes an element, f16 2, as the JAX engine."""
    jdt, tdt = CACHES[kv]
    ref = JaxEngine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=jdt, progress=False)
    port = Engine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=tdt, device="cpu")
    for pos in (0, 5, WINDOW, 100):
        assert port.active_bytes(pos) == ref.active_bytes(pos)
    assert port.new_cache(1).nbytes() == ref.new_cache(1).nbytes()


def _generated_text(out: str) -> list[str]:
    return out.split("Generation stats")[0].split("Encoding stats")[-1].splitlines()[1:]


@pytest.mark.parametrize("kv", ["f32", "f16"])
def test_harness_identical_to_jax(tiny_i8, capsys, kv):
    """``-t f32`` and ``-t f16``: the completion text (through a wrap of the
    window) equals the JAX harness's, and the perplexity is within PPL_TOL."""
    base = [tiny_i8, "-T", str(WINDOW), "-t", kv]
    args = base + ["-m", "c", "-i", "hello world the quick", "-n", str(WINDOW + 8)]
    assert jax_harness.main(args + ["--matmul", "pallas", "--compute", "f32"]) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "--compute", "f32"]) == 0
    got = capsys.readouterr().out
    assert _generated_text(got) == _generated_text(want)
    args = base + ["-m", "perplexity", "-i", "the quick brown fox is here and there again"]
    assert jax_harness.main(args + ["--matmul", "pallas", "--compute", "f32"]) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "--compute", "f32"]) == 0
    got = capsys.readouterr().out
    ppl = lambda out: float(next(ln for ln in out.splitlines()  # noqa: E731
                                 if ln.startswith("perplexity:")).split()[1])
    assert abs(ppl(got) - ppl(want)) / ppl(want) < PPL_TOL


# ------------------------------------------------------------ (d) routing


@pytest.mark.parametrize("kv", ["f32", "f16"])
def test_cache_dtype_fixes_the_attention_route(tiny_i8, monkeypatch, kv):
    """An f32 cache runs every prefill chunk through ``flash_prefill`` and
    every per-layer decode step through ``fused_decode_attention`` (kernels
    2 and 3 in one launch, one per layer; no separate ``kv_update``), and
    decode on ``fused_decode_step`` where
    ``fused_step`` allows; an f16 cache calls none of them, and the dense
    attention runs instead, on both decode paths. Decided by the dtype, not
    by a kernel that failed."""
    calls = dict.fromkeys(("kv_update", "fused_decode_attention", "flash_prefill",
                           "fused_decode_step", "dense"), 0)

    def spy(mod, name, key):
        real = getattr(mod, name)

        def counted(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)

    for name in ("kv_update", "fused_decode_attention", "flash_prefill"):
        spy(A, name, name)
    spy(fd, "fused_decode_step", "fused_decode_step")
    spy(llama, "attention", "dense")
    tdt = CACHES[kv][1]
    for fs in ("auto", False):
        port = Engine.from_xalm(tiny_i8, context=WINDOW, kv_dtype=tdt, fused_step=fs,
                                device="cpu")
        layers = port.cfg.n_layers
        for k in calls:
            calls[k] = 0
        port.generate([1, 259, 260, 10, 20], 6, stop_on_eos=False)  # one chunk, 5 steps
        if kv == "f16":
            want = dict(kv_update=0, fused_decode_attention=0, flash_prefill=0,
                        fused_decode_step=0, dense=6 * layers)
        elif fs == "auto":
            want = dict(kv_update=0, fused_decode_attention=0, flash_prefill=layers,
                        fused_decode_step=5, dense=0)
        else:
            want = dict(kv_update=0, fused_decode_attention=5 * layers, flash_prefill=layers,
                        fused_decode_step=0, dense=0)
        assert calls == want, (fs, calls)


# ---------------------------------------------------------- (e) fp8 weights


@pytest.mark.parametrize("m", [1, 4, 260])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_qmatmul_fp8_matches_jax(fmt, m):
    """Stacked fp8 weights (no scale) of every layer, at decode (the GEMV
    on the card) and prefill rows (the tiled GEMM)."""
    tdt, mdt = {"e4m3": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
                "e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2)}[fmt]
    rng = np.random.default_rng(m)
    l, d, n = 2, 256, 384
    w = (rng.normal(size=(l, d, n)) * 0.1).astype(mdt)
    x = (rng.normal(size=(m, n)) * 0.5).astype(np.float32)
    values = torch.from_numpy(w.view(np.uint8).copy()).view(tdt)
    for layer in range(l):
        want = pallas_qmatmul_stacked_full(jnp.asarray(x), jnp.asarray(w), None,
                                           jnp.int32(layer))
        got = qmatmul(torch.from_numpy(x), values, layer)
        assert got.shape == (m, d)
        assert _rel(got, want) <= F32_TOL, f"layer {layer}"
