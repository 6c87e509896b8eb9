"""Every weight format of the JAX package in the port, against the JAX
package on the CPU: f32 weights on kernel 1's f32 branch, the f16 and fp8
load modes (``load_params(f16_mode=, fp8_mode=)``, ``recode_fp8_rows``),
fp8 in the container reader and writer, the megakernel's cache gate, and
``synthetic_params``' weight formats.

Tolerances, each with its reason:

- bit-equal: fp8 codes widened to f32 (all 256 of each format), the fp8
  recode (the same IEEE f32 division and round half to even), and every
  loaded tensor under every mode;
- f32 weights in ``qmatmul_plain``: equal to the f32 product itself (x is
  not rounded to bf16);
- engine logits at f32 compute within 1e-4 (rtol and atol) where every
  matmul multiplies f32 values (f32 weights, f16 or fp8 weights kept, the
  bar of ``tests/test_mixtral.py``: only the summation order differs);
  within 2e-3 where the body loads as i8 and the head stays f16 (kernel 1
  rounds x to bf16 on both sides, and an f32 ulp upstream can flip one
  such rounding: the bar of ``tests/test_torch_engine.py``); within 1e-2
  where every weight, the head too, loads as bf16 (the bar of that file's
  bf16 head: each flip moves an input of the head by 2^-8 of it; 9.0e-3
  measured on f16 -> bf16); greedy tokens identical.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu.harness import main as jax_harness
from xalm_tpu.io import XalmFile as JaxXalmFile
from xalm_tpu.models.config import ModelConfig as JaxConfig
from xalm_tpu.models.params import load_params as jax_load_params
from xalm_tpu.models.params import recode_fp8_rows as jax_recode_fp8_rows
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu.tokenizer import Tokenizer as JaxTokenizer
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.io import XalmFile, write_xalm
from xalm_tpu_torch.models import llama
from xalm_tpu_torch.models.config import MISTRAL_7B, MIXTRAL_8X7B, ModelConfig
from xalm_tpu_torch.models.params import load_params, recode_fp8_rows
from xalm_tpu_torch.ops import fused_decode as fd
from xalm_tpu_torch.ops import qmatmul as qmm
from xalm_tpu_torch.runtime.engine import Engine
from xalm_tpu_torch.utils.synthetic import synthetic_params

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

FP8 = {"f8_e4m3": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
       "f8_e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2)}
F32_TOL = dict(rtol=1e-4, atol=1e-4)
I8_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
WINDOW = 32


_RAW = {"bfloat16": np.int16, "float8_e4m3fn": np.uint8, "float8_e5m2": np.uint8}


def _bits(a) -> np.ndarray:
    """The raw bits of a port tensor or a JAX array (bf16 and fp8 viewed as
    integers), for bit-equal comparisons."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return (a.view(torch.uint8) if a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2)
                else a).numpy()
    a = np.asarray(a)
    return a.view(_RAW[a.dtype.name]) if a.dtype.name in _RAW else a


# ---- fp8 values and the recode


@pytest.mark.parametrize("fmt", list(FP8))
def test_fp8_codes_widen_as_ml_dtypes(fmt):
    """torch's fp8 -> f32 cast against ml_dtypes' (the JAX package's) for
    every one of the 256 codes: the same f32 bits where finite, NaN and inf
    at the same codes."""
    tdt, mdt = FP8[fmt]
    codes = np.arange(256, dtype=np.uint8)
    got = torch.from_numpy(codes).view(tdt).to(torch.float32).numpy()
    want = codes.view(mdt).astype(np.float32)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(want)], want[~np.isnan(want)])
    np.testing.assert_array_equal(got[finite].view(np.uint32), want[finite].view(np.uint32))


@pytest.mark.parametrize("fmt", list(FP8))
def test_recode_fp8_rows_bit_equal_to_jax(fmt):
    tdt, mdt = FP8[fmt]
    rng = np.random.default_rng(len(fmt))
    f = (rng.standard_normal((3, 5, 96)) * rng.choice([1e-3, 1.0, 30.0], size=(3, 5, 1)))
    f[0, 0] = 0.0  # an all-zero row: scale 1
    f[1, 1, :4] = [127.0, 63.5, -0.5, 1.5]  # code ties at .5 once the row's scale is 1
    vals = f.astype(np.float32).astype(mdt)
    want_q, want_s = jax_recode_fp8_rows(vals)
    got_q, got_s = recode_fp8_rows(vals.view(np.uint8), tdt)
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s.view(np.uint32), want_s.view(np.uint32))
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32 and got_s.shape == (3, 5)
    bad = vals.copy()
    bad[2, 3, 7] = np.float32(np.nan).astype(mdt)  # e4m3fn has NaN but no inf; e5m2 both
    for v in (bad,) + ((np.full((2, 4), np.inf, np.float32).astype(mdt),) if fmt == "f8_e5m2"
                       else ()):
        with pytest.raises(ValueError, match="non-finite"):
            jax_recode_fp8_rows(v)
        with pytest.raises(ValueError, match="non-finite"):
            recode_fp8_rows(v.view(np.uint8), tdt)


def test_fp8_container_round_trip_with_jax(tmp_path):
    """The port writes fp8 tensors given as torch fp8 (raw bytes, types
    f8_e4m3 / f8_e5m2) and reads them back; the JAX reader sees the same
    values."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal((6, 32)).astype(np.float32)
    tensors = {name: torch.from_numpy(f).to(tdt) for name, (tdt, _) in FP8.items()}
    path = str(tmp_path / "fp8.xalm")
    write_xalm(path, "MistralForCausalLM", {"dim": "32"}, tensors)
    with XalmFile(path) as xf:
        for name, (tdt, mdt) in FP8.items():
            assert xf.tensors[name].dtype.name == name
            got = xf.load_torch(name).view(torch.uint8)
            assert torch.equal(got, tensors[name].view(torch.uint8))
    jf = JaxXalmFile(path)
    for name, (tdt, mdt) in FP8.items():
        np.testing.assert_array_equal(np.asarray(jf.load(name)).view(np.uint8),
                                      tensors[name].view(torch.uint8).numpy())
    jf.close()


# ---- containers of every format


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    d = tmp_path_factory.mktemp("x")
    out = {}
    for t in ("f32", "f16", "f8_e4m3", "f8_e5m2"):
        out[t] = str(d / f"tiny_{t}.xalm")
        assert cvt.main(["--input", hf, "--output", out[t], "--type", t]) == 0
    return out


def _leaves(p):
    lp = p.layers
    out = [("attn_norm", lp.attn_norm), ("mlp_norm", lp.mlp_norm), ("out_norm", p.out_norm)]
    for name, w in [("embed", p.embed), ("wqkv", lp.wqkv), ("wo", lp.wo), ("w13", lp.w13),
                    ("w2", lp.w2), ("wcls", p.wcls)]:
        out += [(name, w.values), (name + ".scale", w.scale)]
    return out


# (container, load modes, what the body loads as, logits tolerance)
MODES = {
    "f16-keep": ("f16", dict(f16_mode="keep"), torch.float16, F32_TOL),
    "f16-bf16": ("f16", dict(f16_mode="bf16"), torch.bfloat16, BF16_TOL),
    "f16-f32": ("f16", dict(f16_mode="f32"), torch.float32, F32_TOL),
    "e4m3-keep": ("f8_e4m3", dict(fp8_mode="keep"), torch.float8_e4m3fn, F32_TOL),
    "e4m3-recode": ("f8_e4m3", dict(fp8_mode="recode"), torch.int8, I8_TOL),
    "e5m2-keep": ("f8_e5m2", dict(fp8_mode="keep"), torch.float8_e5m2, F32_TOL),
    "e5m2-recode": ("f8_e5m2", dict(fp8_mode="recode"), torch.int8, I8_TOL),
    "f32": ("f32", {}, torch.float32, F32_TOL),
}


def _jax_params(path, modes):
    jf = JaxXalmFile(path)
    cfg = JaxConfig.from_metadata(jf.config, WINDOW)
    params = jax_load_params(jf, cfg, **modes)
    tok = JaxTokenizer.from_xalm(jf)
    jf.close()
    return cfg, params, tok


@pytest.mark.parametrize("case", list(MODES))
def test_load_params_modes_bit_equal_to_jax(containers, case):
    tname, modes, body, _ = MODES[case]
    with XalmFile(containers[tname]) as xf:
        port = load_params(xf, ModelConfig.from_metadata(xf.config), device="cpu", **modes)
    _, ref, _ = _jax_params(containers[tname], modes)
    assert port.layers.wqkv.values.dtype == body
    assert (port.layers.wqkv.scale is not None) == (body == torch.int8)
    for (name, got), (_, want) in zip(_leaves(port), _leaves(ref)):
        if want is None:
            assert got is None, name
            continue
        assert tuple(got.shape) == tuple(want.shape), name
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"{case} {name}")


def test_load_modes_default_by_device_and_validate(containers):
    """"auto": as stored on the CPU; on the card bf16 for f16 and i8 rows for
    fp8 (what the JAX loader does on its accelerator), shown by asking for
    the modes "auto" picks there; unknown modes are refused."""
    with XalmFile(containers["f8_e4m3"]) as xf:
        cfg = ModelConfig.from_metadata(xf.config)
        kept = load_params(xf, cfg, device="cpu")
        assert kept.layers.w13.values.dtype == torch.float8_e4m3fn
        assert kept.embed.values.dtype == torch.float16  # the converter's 16-bit boost
        with pytest.raises(ValueError, match="fp8_mode"):
            load_params(xf, cfg, device="cpu", fp8_mode="nope")
        with pytest.raises(ValueError, match="f16_mode"):
            load_params(xf, cfg, device="cpu", f16_mode="f8")
    import inspect

    for fn in (load_params, Engine.from_xalm):
        sig = inspect.signature(fn).parameters
        assert sig["f16_mode"].default == sig["fp8_mode"].default == "auto", fn


@pytest.fixture
def count_kernel1(monkeypatch):
    """Kernel 1's calls on the kernel path by weight dtype."""
    calls: dict = {}
    real = llama.qmm.qmatmul

    def spy(x, values, *a, **kw):
        calls[values.dtype] = calls.get(values.dtype, 0) + 1
        return real(x, values, *a, **kw)

    monkeypatch.setattr(llama.qmm, "qmatmul", spy)
    return calls


@pytest.mark.parametrize("case", list(MODES))
def test_engine_logits_match_jax_for_each_mode(containers, case, count_kernel1):
    """The port's kernel path against the JAX "pallas" path on the same
    load mode, per layer (the megakernel takes no float body): prefill
    logits, 4 decode steps, greedy tokens. Weights the kernel takes (bf16,
    i8, f32) go through kernel 1, f16 and fp8 kept go to the plain product
    (the JAX ``_pallas_ok`` sends them to XLA)."""
    tname, modes, body, tol = MODES[case]
    jcfg, jparams, jtok = _jax_params(containers[tname], modes)
    kw = dict(matmul_impl="pallas", kv_dtype=jnp.float32, compute_dtype=jnp.float32,
              fused_step=False)
    ref = JaxEngine(jcfg, jparams, jtok, **kw)
    port = Engine.from_xalm(containers[tname], context=WINDOW, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, fused_step=False, device="cpu", **modes)
    assert port.decode_path(1) == "perlayer"
    prompt = np.random.default_rng(5).integers(3, 350, size=11).tolist()
    lr, cr, pos = ref.prefill(prompt, ref.new_cache(1), logits_mode="all")
    lp, cp, _ = port.prefill(prompt, port.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(lp, np.asarray(lr), **tol)
    for i, tok in enumerate(np.random.default_rng(6).integers(3, 350, size=4)):
        p = np.array([pos + i], np.int32)
        lr, cr = ref.decode(np.array([tok]), p, cr)
        lp, cp = port.decode(np.array([tok]), p, cp)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **tol, err_msg=f"step {i}")
    body_calls = count_kernel1.get(body, 0)
    if qmm.supported_weight_dtype(body):
        assert body_calls >= 4 * port.cfg.n_layers * 5  # wqkv, wo, w13, w2 each step and chunk
    else:
        assert body_calls == 0
    want, _ = ref.generate(prompt, 8, stop_on_eos=False)
    got, _ = port.generate(prompt, 8, stop_on_eos=False)
    assert got == want


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_f32_container_matches_jax_on_both_impls(containers, impl):
    """An f32 container on the port's kernel path (kernel 1's f32 branch;
    its plain version on the CPU) and on its plain path, against the JAX
    "pallas" path: prefill logits of every position within 1e-4."""
    jcfg, jparams, jtok = _jax_params(containers["f32"], {})
    ref = JaxEngine(jcfg, jparams, jtok, matmul_impl="pallas", kv_dtype=jnp.float32,
                    compute_dtype=jnp.float32, fused_step=False)
    port = Engine.from_xalm(containers["f32"], context=WINDOW, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, fused_step=False, matmul_impl=impl,
                            device="cpu")
    prompt = np.random.default_rng(7).integers(3, 350, size=13).tolist()
    lr, _, _ = ref.prefill(prompt, ref.new_cache(1), logits_mode="all")
    lp, _, _ = port.prefill(prompt, port.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(lp, np.asarray(lr), **F32_TOL)


def test_f32_weights_keep_f32_in_kernel_1s_plain_version():
    """f32 weights: x is not rounded to bf16 (the TPU kernel computes in
    f32), with and without the norm prologue; bf16 weights round it."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 40, 256)).astype(np.float32))
    nw = torch.from_numpy((rng.random((2, 256)) + 0.5).astype(np.float32))
    got = qmm.qmatmul(x, w, 1)
    assert torch.equal(got, torch.matmul(x, w[1].T))
    assert not torch.equal(got, torch.matmul(x.to(torch.bfloat16).float(), w[1].T))
    xn = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-5) * nw[1]
    assert torch.equal(qmm.qmatmul(x, w, 1, norm_w=nw, norm_eps=1e-5), torch.matmul(xn, w[1].T))
    wb = w.to(torch.bfloat16)
    assert torch.equal(qmm.qmatmul(x, wb, 1),
                       torch.matmul(x.to(torch.bfloat16).float(), wb[1].float().T))


@pytest.mark.parametrize("tname", ["f8_e4m3", "f16"])
def test_harness_identical_to_jax(containers, capsys, tname):
    """The harness loads fp8 and f16 containers as they are on the CPU (no
    ``--matmul plain``): the completion text equals the JAX harness's."""
    args = [containers[tname], "-m", "c", "-i", "hello world the quick", "-n", "20",
            "-T", str(WINDOW), "-t", "f32"]
    assert jax_harness.main(args + ["--matmul", "pallas"]) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "--compute", "f32"]) == 0
    got = capsys.readouterr().out
    text = lambda out: out.split("Generation stats")[0].split("Encoding stats")[-1]  # noqa: E731
    assert text(got).splitlines()[1:] == text(want).splitlines()[1:]


# ---- the megakernel's cache gate


@pytest.mark.parametrize("quantized", [False, True])
def test_megakernel_cache_gate(quantized):
    """The caches the megakernel takes, the same on the card and the CPU
    (``csrc/fused_decode_f32.cu`` holds the f32 cache's instantiations):
    bf16 or f32, or with scale planes (``quantized``) int8; never f16, as
    the JAX gate."""
    float_ok = {torch.bfloat16: True, torch.float32: True, torch.float16: False,
                torch.int8: False}
    for dtype, ok in float_ok.items():
        want = dtype == torch.int8 if quantized else ok
        assert fd.cache_supported(dtype, quantized) == want, dtype


def test_fused_step_takes_an_f32_cache_on_the_cpu():
    cfg = dataclasses.replace(MISTRAL_7B, dim=256, hidden_dim=512, n_layers=1, n_heads=2,
                              n_kv_heads=1, vocab_size=64, max_seq_len=32)
    params = synthetic_params(cfg, device="cpu", seed=0)
    ck = torch.zeros((1, 1, 1, 32, 128), dtype=torch.float32)
    assert fd.fused_step_supported(cfg, params, ck, 1, 1)
    assert Engine(cfg, params, kv_dtype=torch.float32).decode_path(1) == "megakernel"


# ---- synthetic weights in every format


def test_synthetic_params_formats():
    """``weight_dtype`` and ``embed_dtype`` (the JAX function's arguments),
    and q4 drawn packed (no i8 stack first) with group scales that vary."""
    cfg = dataclasses.replace(MIXTRAL_8X7B, dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                              n_kv_heads=2, head_dim=64, rotary_dim=64, vocab_size=100,
                              max_seq_len=32, n_experts=4)
    p = synthetic_params(cfg, device="cpu", seed=0, weight_dtype=torch.float32,
                         embed_dtype=torch.float32)
    lw = p.layers
    assert all(w.values.dtype == torch.float32 and w.scale is None
               for w in (lw.wqkv, lw.wo, lw.w13e, lw.w2e, p.embed, p.wcls))
    p = synthetic_params(cfg, device="cpu", seed=0, q4_group=128)
    lw = p.layers
    assert lw.w13e.values.shape == (2, 4, 1024, 128) and lw.w13e.scale.shape == (2, 4, 1024, 2)
    assert lw.w2e.q4group == lw.wqkv.q4group == 128 and lw.w2e.values.dtype == torch.int8
    s = lw.w2e.scale
    assert 0.74 * 0.02 / 7 < float(s.min()) and float(s.max()) < 1.26 * 0.02 / 7
    assert float(s.std()) > 0  # a kernel that reads the wrong group's scale moves the output
    assert p.embed.values.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="q4 group"):
        synthetic_params(cfg, device="cpu", q4_group=192)


def test_synthetic_q4_mixtral_decodes_on_the_gathered_route(monkeypatch):
    """A random q4 Mixtral (drawn packed) generates on the gathered q4 route
    under ``a8_decode``: one q4 expert launch per matmul (2 a layer and
    token), none without ``a8_decode`` (the dense-masked experts)."""
    cfg = dataclasses.replace(MIXTRAL_8X7B, dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                              n_kv_heads=2, head_dim=64, rotary_dim=64, vocab_size=100,
                              max_seq_len=32, n_experts=4)
    params = synthetic_params(cfg, device="cpu", seed=1, q4_group=128)
    calls = []
    plain = qmm.qmatmul_multi_plain
    monkeypatch.setattr(qmm, "qmatmul_multi_plain",
                        lambda *a, **kw: calls.append(kw.get("q4_group")) or plain(*a, **kw))
    for a8, want in ((True, [128] * 2 * 2 * 5), (False, [])):
        calls.clear()
        eng = Engine(cfg, params, kv_dtype=torch.float32, a8_decode=a8)
        out, _ = eng.generate([1, 5, 9], 6, stop_on_eos=False)
        assert len(out) == 6 and calls == want
        assert eng.decode_path(1) == ("perlayer" if a8 else "xla")
