"""Llama-3.x, Qwen2.5 and Qwen3 in the port: rope scaling, the Qwen2 qkv
bias and the Qwen3 per-head q/k RMS norms, on the per-layer path and as
folds of the whole-step megakernel, and the attention kernels' plain
versions at every GQA group up to 8 and at head_dim 96 and 256, each
against the JAX package (its Pallas kernels in interpret mode) or HF, on
tiny containers made by
``tests/make_tiny_model.py`` with the override dicts of
``tests/test_qwen2.py``, ``test_qwen3.py`` and ``test_rope_scaling.py``,
converted by the JAX converter, plus one tiny Qwen2 geometry with GQA group
7 (14 heads, 2 KV heads, dim 96: widths at which the JAX megakernel takes
a group of 7).

Tolerances, and why:

- ``rope_freqs``, ``bqkv``, ``q_norm``, ``k_norm`` and every other weight:
  bit-equal (the same numpy operations; loading only copies, stacks and
  interleaves stored values);
- prefill logits of an f32 container against HF: rtol and atol 1e-4, the
  bars of the JAX package's own family tests;
- the engines on i8 containers against the JAX engines, through two ring
  wraps of a 16-slot window: logits within rtol and atol 3e-2 and the same
  argmax at every step, the bars of ``tests/test_torch_kvq.py`` (both sides
  cast activations to bf16 before the i8 matmuls, an f32 ulp can flip one
  such rounding, and the q/k norm's rsqrt and the rope's trig differ in the
  last bit);
- the megakernel's plain version against the JAX ``fused_decode_step``:
  the step and cache-row bars of ``tests/test_torch_fused.py`` and
  ``tests/test_torch_kvq.py`` (2e-2 of each step's or row's max), for the
  reasons given there;
- the attention plain versions: 1e-5 of each output row's max with f32
  caches (summation order only), 2e-2 with bf16 caches
  (``tests/test_torch_ops.py``), 1e-3 with int8 codes (``chip_smoke.py``'s
  bar for kernel 7: a score that moves by an f32 ulp can flip one bf16
  rounding of p * v_scale, 2^-8 of one term; at groups 5 and 6 such a flip
  moved a row by 8.5e-5 of its max).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from tests.test_qwen2 import QWEN2_OVERRIDES
from tests.test_qwen3 import QWEN3_OVERRIDES
from tests.test_rope_scaling import LLAMA3_OVERRIDES
from xalm_tpu.convert import convert as cvt
from xalm_tpu.harness import main as jax_harness
from xalm_tpu.io import XalmFile as JaxXalmFile
from xalm_tpu.models.config import ModelConfig as JaxConfig
from xalm_tpu.models.llama import rope_freqs as jax_rope_freqs
from xalm_tpu.models.params import QWeight as JaxQWeight
from xalm_tpu.models.params import load_params as jax_load_params
from xalm_tpu.models.params import recode_wcls_i8 as jax_recode_wcls_i8
from xalm_tpu.ops.fused_decode import fused_decode_step as jax_fused_decode_step
from xalm_tpu.ops.pallas_attention import fused_decode_attention as jax_attention
from xalm_tpu.ops.pallas_attention import fused_decode_attention_q as jax_attention_q
from xalm_tpu.ops.pallas_attention import fused_prefill_attention as jax_prefill
from xalm_tpu.ops.pallas_attention import rope_cos_sin_plus1 as jax_cos_sin_plus1
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.io import XalmFile
from xalm_tpu_torch.models import llama
from xalm_tpu_torch.models.config import (
    GEMMA2_9B,
    GEMMA_7B,
    KV_SINKS,
    LLAMA3_1_8B,
    MISTRAL_7B,
    PHI3_MINI_4K,
    QWEN2_5_7B,
    QWEN3_8B,
    ModelConfig,
)
from xalm_tpu_torch.models.params import (
    from_jax_params,
    load_params,
    recode_params_q4,
    recode_wcls_i8,
)
from xalm_tpu_torch.ops import attention as A
from xalm_tpu_torch.ops import fused_decode as fd
from xalm_tpu_torch.runtime.engine import Engine
from xalm_tpu_torch.utils.synthetic import synthetic_params

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

FAMILIES = {
    "qwen2": QWEN2_OVERRIDES,
    "qwen3": QWEN3_OVERRIDES,
    "llama3": LLAMA3_OVERRIDES,
    "qwen2g7": dict(QWEN2_OVERRIDES, hidden_size=96, intermediate_size=384,
                    num_attention_heads=14, num_key_value_heads=2),
}
TOKENS = [1, 259, 260, 10, 20, 300, 5, 77, 261, 262, 263, 264, 8, 9, 1, 2, 33]
WINDOW = 16
S_PHYS = 32  # the window padded to 32 rows
STEPS = WINDOW + 2 * (WINDOW - KV_SINKS) + 4  # from pos 0 past three ring wraps
HF_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE_TOL = dict(rtol=3e-2, atol=3e-2)
STEP_TOL = 2e-2
EXACT_TOL = 1e-5
BF16_TOL = 2e-2
INT8_TOL = 1e-3


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """family -> {"hf": HF dir, "f32": container, "i8": container}."""
    out = {}
    for fam, overrides in FAMILIES.items():
        hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / fam), config_overrides=overrides)
        out[fam] = {"hf": hf}
        for t in ("f32", "i8"):
            out[fam][t] = str(tmp_path_factory.mktemp("x") / f"{fam}_{t}.xalm")
            assert cvt.main(["--input", hf, "--output", out[fam][t], "--type", t]) == 0
    return out


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})


def _jax_cfg(cfg: ModelConfig) -> JaxConfig:
    return JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)})


def _np(t) -> np.ndarray:
    """A port tensor or JAX leaf as numpy, bf16 as its raw bits."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _leaves(p):
    """(name, values) of a port or JAX ModelParams, the family planes included."""
    lp = p.layers
    out = [(n, getattr(lp, n)) for n in ("attn_norm", "mlp_norm", "bqkv", "q_norm", "k_norm",
                                         "wgate")]
    out.append(("out_norm", p.out_norm))
    for name, w in [("embed", p.embed), ("wqkv", lp.wqkv), ("wo", lp.wo), ("w13", lp.w13),
                    ("w2", lp.w2), ("wcls", p.wcls)]:
        out += [(name, None if w is None else w.values), (name + ".scale", w and w.scale)]
    return out


def _assert_leaves_equal(port, ref, what: str) -> None:
    for (name, got), (_, want) in zip(_leaves(port), _leaves(ref)):
        if want is None:
            assert got is None, (what, name)
            continue
        assert got is not None, (what, name)
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=f"{what} {name}")


def _jax_load(path):
    jf = JaxXalmFile(path)
    try:
        return jax_load_params(jf, JaxConfig.from_metadata(jf.config))
    finally:
        jf.close()


def _port_load(path):
    with XalmFile(path) as xf:
        return load_params(xf, ModelConfig.from_metadata(xf.config), device="cpu")


# ------------------------------------------------------------------ config and weights


@pytest.mark.parametrize("case", ["none", "linear", "llama3-tiny", "llama3.1-8b"])
def test_rope_freqs_bit_equal_to_jax(case):
    tiny = ModelConfig(dim=64, hidden_dim=128, head_dim=64, n_layers=1, n_heads=1, n_kv_heads=1,
                       vocab_size=384, max_seq_len=2048, rope_theta=5e5, rotary_dim=48)
    cfg = {
        "none": MISTRAL_7B,
        "linear": dataclasses.replace(MISTRAL_7B, rope_scaling="linear", rope_factor=4.0),
        "llama3-tiny": dataclasses.replace(tiny, rope_scaling="llama3", rope_factor=8.0,
                                           rope_original_max_pos=512),
        "llama3.1-8b": LLAMA3_1_8B,
    }[case]
    got, want = llama.rope_freqs(cfg), jax_rope_freqs(_jax_cfg(cfg))
    assert got.dtype == np.float32 and got.shape == (cfg.head_dim // 2,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if case != "none":  # the scaling moved the frequencies
        assert not np.array_equal(got, jax_rope_freqs(_jax_cfg(
            dataclasses.replace(cfg, rope_scaling="none"))))


def test_presets_are_the_published_geometries():
    """The presets against their HF config.json values, and the JAX
    package's config takes each of them (``tests/test_torch_gemma.py`` runs
    the Gemma and Phi-3 ones through the JAX converter too)."""
    q2, q3, l3 = QWEN2_5_7B, QWEN3_8B, LLAMA3_1_8B
    assert (q2.dim, q2.hidden_dim, q2.n_layers, q2.n_heads, q2.n_kv_heads, q2.vocab_size) == (
        3584, 18944, 28, 28, 4, 152064)
    assert (q3.dim, q3.hidden_dim, q3.n_layers, q3.n_heads, q3.n_kv_heads, q3.vocab_size) == (
        4096, 12288, 36, 32, 8, 151936)
    assert (l3.dim, l3.hidden_dim, l3.n_layers, l3.n_heads, l3.n_kv_heads, l3.vocab_size) == (
        4096, 14336, 32, 32, 8, 128256)
    assert q2.group_size == 7 and q3.qk_norm and not q2.qk_norm
    assert (q2.rope_theta, q2.norm_eps, l3.rope_theta, l3.norm_eps) == (1e6, 1e-6, 5e5, 1e-5)
    assert (l3.rope_scaling, l3.rope_factor, l3.rope_low_freq_factor, l3.rope_high_freq_factor,
            l3.rope_original_max_pos) == ("llama3", 8.0, 1.0, 4.0, 8192)
    for cfg in (q2, q3, l3):
        assert cfg.head_dim == 128 and cfg.max_seq_len == 4096 and cfg.act == "silu"
        assert not cfg.tie_word_embeddings
        _jax_cfg(cfg)
    g2, g7, p3 = GEMMA2_9B, GEMMA_7B, PHI3_MINI_4K
    assert (g2.dim, g2.hidden_dim, g2.n_layers, g2.n_heads, g2.n_kv_heads, g2.head_dim,
            g2.vocab_size) == (3584, 14336, 42, 16, 8, 256, 256000)
    assert (g7.dim, g7.hidden_dim, g7.n_layers, g7.n_heads, g7.n_kv_heads, g7.head_dim,
            g7.vocab_size) == (3072, 24576, 28, 16, 16, 256, 256000)
    assert (p3.dim, p3.hidden_dim, p3.n_layers, p3.n_heads, p3.n_kv_heads, p3.head_dim,
            p3.vocab_size) == (3072, 8192, 32, 32, 32, 96, 32064)
    assert (g2.attn_softcap, g2.logit_softcap, g2.post_norms) == (50.0, 30.0, True)
    assert g2.q_dim == 4096 != g2.dim and g7.q_dim == 4096 != g7.dim and g7.group_size == 1
    for cfg, dim in ((g2, 3584), (g7, 3072)):
        assert cfg.act == "gelu" and cfg.tie_word_embeddings and cfg.embed_scale == dim ** 0.5
        assert (cfg.rope_theta, cfg.norm_eps) == (1e4, 1e-6)
    assert not (g7.post_norms or g7.attn_softcap or g7.logit_softcap)
    assert p3.act == "silu" and not p3.tie_word_embeddings and p3.embed_scale == 1.0
    assert (p3.rope_theta, p3.norm_eps) == (1e4, 1e-5)
    for cfg in (g2, g7, p3):
        assert cfg.max_seq_len == 4096 and cfg.rotary_dim == cfg.head_dim
        _jax_cfg(cfg)


@pytest.mark.parametrize("tname", ["f32", "i8"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_load_params_bit_equal_to_jax(models, fam, tname):
    port, ref = _port_load(models[fam][tname]), _jax_load(models[fam][tname])
    _assert_leaves_equal(port, ref, f"{fam} {tname}")
    lp = port.layers
    assert (lp.bqkv is not None) == fam.startswith("qwen2")
    assert (lp.q_norm is not None) == (lp.k_norm is not None) == (fam == "qwen3")
    if lp.bqkv is not None:
        assert lp.bqkv.dtype == torch.float32 and lp.bqkv.shape == lp.wqkv.values.shape[:2]


@pytest.mark.parametrize("fam", ["qwen2", "qwen3", "qwen2g7"])
def test_from_jax_params_carries_the_family_planes(models, fam):
    tree = jax.tree.map(np.asarray, _jax_load(models[fam]["i8"]))
    port = from_jax_params(tree, device="cpu")
    _assert_leaves_equal(port, tree, fam)
    p = recode_wcls_i8(port)  # the head recode passes the planes through
    for name in ("bqkv", "q_norm", "k_norm"):
        assert getattr(p.layers, name) is getattr(port.layers, name)


@pytest.mark.parametrize("fam", ["mistral", "mixtral", "qwen2", "qwen3"])
def test_bf16_checkpoint_loads_as_jax(fam, tmp_path):
    """A bf16 HF checkpoint: the converter keeps its norms, q/k norms,
    biases and MoE router in bf16, which the port reads as the JAX loader
    does (the f32 of each stored bf16 value; the port's loader took the raw
    16-bit patterns of bf16 norms and routers for their values before,
    16254.0 for 0.99)."""
    import safetensors.torch

    from tests.test_mixtral import MIXTRAL_OVERRIDES

    hf = str(tmp_path / "hf")
    overrides = dict(FAMILIES, mixtral=MIXTRAL_OVERRIDES).get(fam, {})
    make_tiny_model(hf, config_overrides=dict(overrides, torch_dtype="bfloat16"))
    st = f"{hf}/model.safetensors"
    safetensors.torch.save_file(
        {k: v.to(torch.bfloat16) for k, v in safetensors.torch.load_file(st).items()}, st)
    out = str(tmp_path / "bf16_i8.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    with XalmFile(out) as xf:
        assert xf.tensors["l.0.attn.norm.weight"].dtype.name == "bf16"
    port, ref = _port_load(out), _jax_load(out)
    _assert_leaves_equal(port, ref, fam)
    assert float(port.layers.attn_norm.abs().max()) < 10.0  # the values, not their bit patterns


# ------------------------------------------------------------------ the whole path


def _hf_model(hf):
    import transformers

    model = transformers.AutoModelForCausalLM.from_pretrained(hf, torch_dtype=torch.float32)
    model.eval()
    return model


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_prefill_logits_and_greedy_tokens_match_hf(models, fam):
    """The port's engine on the f32 container (its kernel path, whose
    wrappers run the plain versions on the CPU; f32 cache and compute)."""
    eng = Engine.from_xalm(models[fam]["f32"], kv_dtype=torch.float32,
                           compute_dtype=torch.float32, device="cpu")
    model = _hf_model(models[fam]["hf"])
    with torch.no_grad():
        want = model(torch.tensor([TOKENS])).logits[0].numpy()
        hf_tokens = model.generate(torch.tensor([TOKENS[:6]]), max_new_tokens=12,
                                   do_sample=False)[0][6:].tolist()
    got, _, _ = eng.prefill(TOKENS, eng.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(got, want, **HF_TOL)
    out, _ = eng.generate(TOKENS[:6], 12, stop_on_eos=False)
    assert out == hf_tokens


ENGINE_CASES = [(fam, path, "f32") for fam in FAMILIES for path in ("megakernel", "perlayer")] + [
    ("qwen2g7", "perlayer", "int8"), ("qwen3", "perlayer", "int8"), ("qwen2", "megakernel", "int8")]


@pytest.mark.parametrize("fam,path,kv", ENGINE_CASES)
def test_engine_matches_jax_through_wraps(models, fam, path, kv):
    """i8 container, a 10-token prompt chunk, then teacher-forced decode
    through two ring wraps, on the JAX engine's Pallas path (kernels in
    interpret mode) and the port's kernel path, the decode path pinned on
    both; then 20 greedy tokens."""
    fused = dict(fused_step=path == "megakernel")
    jkv, tkv = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[kv]
    ref = JaxEngine.from_xalm(models[fam]["i8"], context=WINDOW, matmul_impl="pallas",
                              kv_dtype=jkv, compute_dtype=jnp.float32, progress=False, **fused)
    port = Engine.from_xalm(models[fam]["i8"], context=WINDOW, kv_dtype=tkv,
                            compute_dtype=torch.float32, device="cpu", **fused)
    assert ref.decode_path(1) == port.decode_path(1) == path
    rng = np.random.default_rng(len(fam))
    prompt = rng.integers(3, 350, size=10).tolist()
    lr, cr, _ = ref.prefill(prompt, ref.new_cache(1), logits_mode="last")
    lp, cp, pos = port.prefill(prompt, port.new_cache(1), logits_mode="last")
    np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **ENGINE_TOL)
    for tok in rng.integers(3, 350, size=2 * WINDOW + 4).tolist():
        step = (np.array([tok]), np.array([pos], np.int32))
        lr, cr = ref.decode(*step, cr)
        lp, cp = port.decode(*step, cp)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **ENGINE_TOL, err_msg=f"pos {pos}")
        assert int(lp.argmax()) == int(np.asarray(lr).argmax()), pos
        pos += 1
    assert pos >= WINDOW + (WINDOW - KV_SINKS)  # two wraps
    want, _ = ref.generate(TOKENS[:6], 20, stop_on_eos=False)
    got, _ = port.generate(TOKENS[:6], 20, stop_on_eos=False)
    assert got == want


@pytest.mark.parametrize("fam", ["qwen2", "qwen3", "llama3"])
def test_decode_path_and_active_bytes(models, fam):
    """The megakernel takes the bias and the q/k norms (``decode_path``);
    ``active_bytes`` is the JAX engine's plus the f32 bias and q/k-norm
    planes a decode step reads, which the JAX count leaves out."""
    port = Engine.from_xalm(models[fam]["i8"], kv_dtype=torch.float32, device="cpu")
    ref = JaxEngine.from_xalm(models[fam]["i8"], matmul_impl="pallas", kv_dtype=jnp.float32,
                              progress=False)
    assert port.decode_path(1) == "megakernel"
    assert Engine.from_xalm(models[fam]["i8"], kv_dtype=torch.float32, device="cpu",
                            fused_step=False).decode_path(1) == "perlayer"
    lp = port.params.layers
    planes = 4 * sum(t.numel() for t in (lp.bqkv, lp.q_norm, lp.k_norm) if t is not None)
    assert planes > 0 or fam == "llama3"
    for pos in (0, 7, 100):
        assert port.active_bytes(pos) == ref.active_bytes(pos) + planes


def _generated_text(out: str) -> list[str]:
    return out.split("Generation stats")[0].split("Encoding stats")[-1].splitlines()[1:]


def test_harness_completion_and_perplexity_match_jax(models, capsys):
    """The harnesses on the tiny Qwen2 i8 container: the same completion
    text through two ring wraps (the reference path of both), the same
    perplexity, and the port's kernel path decoding on the megakernel."""
    path = models["qwen2"]["i8"]
    args = [path, "-m", "c", "-i", "hello world the quick", "-n", "40", "-T", str(WINDOW),
            "--matmul", "xla"]
    assert jax_harness.main(args) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "-t", "f16", "--compute", "f32"]) == 0
    got = capsys.readouterr().out
    assert _generated_text(got) == _generated_text(want)
    ppl_args = [path, "-m", "perplexity", "-i", "the quick brown fox jumps over the lazy dog"]
    assert jax_harness.main(ppl_args + ["--matmul", "xla"]) == 0
    want = capsys.readouterr().out
    assert port_harness.main(ppl_args + ["-d", "cpu", "--matmul", "xla", "-t", "f16",
                                         "--compute", "f32"]) == 0
    got = capsys.readouterr().out
    ppl = [float(o.split("perplexity:")[1].split()[0]) for o in (got, want)]
    assert abs(ppl[0] - ppl[1]) <= 1e-3 * ppl[1], ppl
    assert port_harness.main([path, "-d", "cpu", "-t", "bf16", "-i", "hello", "-n", "8"]) == 0
    assert "decode path: megakernel" in capsys.readouterr().out


# ------------------------------------------------------------------ the megakernel's folds


def _ring(pos: np.ndarray):
    """(kv_pos, kv_len, rotate) of the StreamingLLM window at positions pos."""
    wrapped = pos >= WINDOW
    sink = np.where(wrapped, KV_SINKS, 0)
    kv_pos = sink + (pos - sink) % (WINDOW - sink)
    return (kv_pos.astype(np.int32), np.minimum(pos + 1, WINDOW).astype(np.int32),
            wrapped.astype(np.int32))


def _row_rel(got, want) -> float:
    """max over rows (last axis) of max |got - want| / max |want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got - want).max(axis=-1)
    return float((err / np.maximum(np.abs(want).max(axis=-1), 1e-30)).max())


MEGA_CASES = [("qwen2", "bf16", 1), ("qwen2", "int8", 3), ("qwen3", "bf16", 3),
              ("qwen3", "int8", 1), ("qwen2g7", "bf16", 1), ("qwen2g7", "int8", 3),
              ("llama3", "bf16", 1)]


@pytest.mark.parametrize("fam,cache,b", MEGA_CASES)
def test_fused_decode_step_folds_match_jax(models, fam, cache, b):
    """``fused_decode_step`` on CPU tensors (its plain version) with the
    qkv bias (Qwen2) or the q/k norms (Qwen3), and with llama3-scaled rope,
    against the JAX ``fused_decode_step`` in interpret mode, from zeroed
    planes through three wraps of the window; at B = 1 with the embed fold
    (the rope trig from the scaled freqs) and the i8-head fold, at B = 3
    row 1 at the kv_pos == S sentinel."""
    jeng = JaxEngine.from_xalm(models[fam]["i8"], context=WINDOW, matmul_impl="pallas",
                               progress=False)
    jcfg, cfg = jeng.cfg, _port_cfg(jeng.cfg)
    folds = b == 1
    jparams = jeng.params
    if folds:
        jparams = jax_recode_wcls_i8(dataclasses.replace(
            jparams, embed=JaxQWeight(jparams.embed.values.astype(jnp.bfloat16))))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    assert (params.layers.bqkv is not None) == fam.startswith("qwen2")
    assert (params.layers.q_norm is not None) == (fam == "qwen3")
    freqs = jax_rope_freqs(jcfg)
    np.testing.assert_array_equal(freqs, llama.rope_freqs(cfg))
    c1, s1 = jax_cos_sin_plus1(freqs)
    quant = cache == "int8"
    shape = (cfg.n_layers, b, cfg.n_kv_heads, S_PHYS, cfg.head_dim)
    if quant:
        jplanes = (jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
                   jnp.zeros(shape[:-1], jnp.float32), jnp.zeros(shape[:-1], jnp.float32))
        planes = (torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8),
                  torch.zeros(shape[:-1]), torch.zeros(shape[:-1]))
    else:
        jplanes = (jnp.zeros(shape, jnp.bfloat16),) * 2
        planes = (torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(shape, dtype=torch.bfloat16))
    head = dict(wcls=jparams.wcls, out_norm=jparams.out_norm) if folds else {}

    @jax.jit
    def jax_step(x0, jp, kv_pos, kv_len, rot, cexp, sexp, token, pos):
        extra = dict(head)
        if folds:
            extra.update(embed=jparams.embed, token=token, pos=pos, freqs=jnp.asarray(freqs))
        if quant:
            extra.update(k_scale=jp[2], v_scale=jp[3])
        return jax_fused_decode_step(jparams, jcfg, x0, jp[0], jp[1], kv_pos, kv_len, rot, cexp,
                                     sexp, jnp.asarray(c1), jnp.asarray(s1), **extra)

    emb = np.asarray(jnp.asarray(jparams.embed.values, jnp.float32))
    if jparams.embed.scale is not None:
        emb = emb * np.asarray(jparams.embed.scale)[:, None]
    rng = np.random.default_rng(b + 7 * len(fam))
    start = np.array([0, 5, 9][:b])
    nplanes = len(planes)
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
        if folds:
            kw.update(embed=params.embed, token=torch.from_numpy(tok), pos=torch.from_numpy(pos),
                      freqs=torch.from_numpy(freqs))
        if quant:
            kw.update(k_scale=planes[2], v_scale=planes[3])
        got = fd.fused_decode_step(params, cfg, torch.from_numpy(x0), planes[0], planes[1],
                                   *map(torch.from_numpy, (kv_pos, kv_len, rot, cexp, sexp, c1,
                                                           s1)), **kw)
        assert all(g is t for g, t in zip(got[-nplanes:], planes))  # in place
        jplanes = tuple(want[-nplanes:])
        outs = [("x", got[0], want[0])] + ([("logits", got[1], want[1])] if folds else [])
        for name, g, w in outs:
            assert g.shape == w.shape and torch.isfinite(g).all()
            assert _row_rel(g.reshape(1, -1), np.asarray(w).reshape(1, -1)) <= STEP_TOL, (st, name)
        if folds:
            np.testing.assert_array_equal(got[2].numpy(), np.argmax(got[1].numpy(), axis=-1))
    assert pos[0] >= WINDOW + 2 * (WINDOW - KV_SINKS)  # three wraps
    live = slice(0, WINDOW)
    if quant:
        for c, sc, jc, jsc in ((planes[0], planes[2], jplanes[0], jplanes[2]),
                               (planes[1], planes[3], jplanes[1], jplanes[3])):
            deq = c.float() * sc[..., None]
            jdeq = np.asarray(jc).astype(np.float32) * np.asarray(jsc)[..., None]
            assert _row_rel(deq[:, :, :, live], jdeq[:, :, :, live]) <= STEP_TOL
    else:
        for c, jc in zip(planes, jplanes):
            assert _row_rel(c[:, :, :, live], jc[:, :, :, live]) <= STEP_TOL


def test_megakernel_gate_and_checks_take_the_folds():
    """The gate takes a body with the bias and the q/k norms; the plain
    version refuses planes of the wrong shape, and q_norm without k_norm."""
    cfg = dataclasses.replace(QWEN3_8B, dim=64, hidden_dim=128, n_layers=2, n_heads=4,
                              n_kv_heads=2, head_dim=16, rotary_dim=16, vocab_size=64,
                              max_seq_len=32)
    params = synthetic_params(cfg, device="cpu", qkv_bias=True)
    lp = params.layers
    assert lp.bqkv.shape == (2, lp.wqkv.values.shape[1]) and lp.q_norm.shape == (2, 16)
    q4 = recode_params_q4(synthetic_params(dataclasses.replace(
        cfg, dim=256, hidden_dim=256, n_heads=16), device="cpu", qkv_bias=True), 128)
    assert q4.layers.wqkv.q4group == 128 and q4.layers.bqkv is not None
    assert q4.layers.q_norm is not None and q4.layers.k_norm is not None
    ck = torch.zeros((2, 1, 2, 32, 16), dtype=torch.bfloat16)
    assert fd.fused_step_supported(cfg, params, ck, 1, 1)
    c1, s1 = A.rope_cos_sin_plus1(llama.rope_freqs(cfg))
    args = (cfg, torch.zeros((1, 64)), ck, ck.clone(), torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            torch.ones((1, 16)), torch.zeros((1, 16)), torch.from_numpy(c1), torch.from_numpy(s1))
    fd.fused_decode_step_plain(params, *args)
    for bad, msg in ((dict(bqkv=lp.bqkv[:, :-1]), "bqkv"), (dict(k_norm=None), "come together"),
                     (dict(q_norm=lp.q_norm[:, :8], k_norm=lp.k_norm[:, :8]), "q_norm")):
        wrong = dataclasses.replace(params, layers=dataclasses.replace(lp, **bad))
        with pytest.raises(ValueError, match=msg):
            fd.fused_decode_step_plain(wrong, *args)


def test_synthetic_family_planes_move_the_logits_and_both_paths_agree():
    """synthetic_params draws the bias and the q/k norms at scales that move
    the logits well past rounding, and the megakernel's plain version and
    the per-layer path agree on them (within the engine bars above)."""
    cfg = dataclasses.replace(QWEN3_8B, dim=128, hidden_dim=256, n_layers=2, n_heads=8,
                              n_kv_heads=2, head_dim=16, rotary_dim=16, vocab_size=96,
                              max_seq_len=32)
    base = synthetic_params(cfg, device="cpu", seed=3, qkv_bias=True)
    no_folds = dataclasses.replace(base, layers=dataclasses.replace(
        base.layers, bqkv=None, q_norm=None, k_norm=None))
    prompt = list(range(3, 23))
    logits = {}
    for name, p, kw in (("mega", base, {}), ("perlayer", base, dict(fused_step=False)),
                        ("no folds", no_folds, {})):
        eng = Engine(cfg, p, kv_dtype=torch.bfloat16, compute_dtype=torch.float32, **kw)
        _, cache, pos = eng.prefill(prompt, eng.new_cache(1))
        logits[name], _ = eng.decode(np.array([5]), np.array([pos], np.int32), cache)
    ref = logits["perlayer"]
    scale = float(ref.abs().max())
    assert float((logits["mega"] - ref).abs().max()) <= ENGINE_TOL["atol"] * scale
    assert float((logits["no folds"] - ref).abs().max()) > 0.1 * scale


# ------------------------------------------------------------------ attention at any GQA group


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _dequant(planes):
    """(K, V) rows of a float cache, or of an int8 cache's codes times scales."""
    if len(planes) == 2:
        return planes
    return tuple(_to_torch(c).float() * _to_torch(sc)[..., None]
                 for c, sc in ((planes[0], planes[2]), (planes[1], planes[3])))


# (GQA group, head_dim): the groups that are not a power of two, and head_dim
# 96 (Phi-3, group 1) and 256 (Gemma-2, group 2)
ATTENTION_SHAPES = [(3, 16), (5, 16), (6, 16), (7, 16), (1, 96), (2, 256)]


@pytest.mark.parametrize("g,hd", ATTENTION_SHAPES,
                         ids=[str(g) if hd == 16 else f"hd{hd}-g{g}" for g, hd in ATTENTION_SHAPES])
def test_attention_plain_versions_match_jax_at_group(g, hd):
    """``flash_decode_plain`` (after ``kv_update_plain``), ``flash_prefill_plain``
    and ``flash_decode_q_plain`` (after ``kv_update_q_plain``) at GQA group
    g and head_dim hd against ``fused_decode_attention``,
    ``fused_prefill_attention`` and ``fused_decode_attention_q`` in
    interpret mode: decode from random planes (f32 and bf16, and int8 codes
    with scales) over 2.5 ring wraps of a 16-slot window at B = 2 (row 1
    wrapped from the start), prefill of a 32-row chunk at pos 0 and 24 over
    a 64-row cache."""
    kh, L, B = 2, 2, 2
    h = kh * g
    rng = np.random.default_rng(g if hd == 16 else hd)
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c1, s1 = jax_cos_sin_plus1(freqs)
    tc1, ts1 = (torch.from_numpy(np.asarray(a, np.float32).reshape(hd)) for a in (c1, s1))
    jc1, js1 = (jnp.asarray(np.asarray(a, np.float32).reshape(1, hd)) for a in (c1, s1))
    shape = (L, B, kh, S_PHYS, hd)
    t = torch.from_numpy
    for dt in ("f32", "bf16", "int8"):
        if dt == "int8":
            arrs = [rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2)]
            arrs += [(rng.random(shape[:-1]) * 0.02).astype(np.float32) for _ in range(2)]
            jc = tuple(map(jnp.array, arrs))
            tc = tuple(t(a.copy()) for a in arrs)
        else:
            arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
            tdt, jdt = {"f32": (torch.float32, jnp.float32),
                        "bf16": (torch.bfloat16, jnp.bfloat16)}[dt]
            # copies on both sides: the JAX kernels update their (donated)
            # planes in place, and a zero-copy view would share them
            tc = tuple(t(a.copy()).to(tdt) for a in arrs)
            jc = tuple(jnp.array(a).astype(jdt) for a in arrs)
        step = jax.jit(jax_attention_q if dt == "int8" else jax_attention)
        start = np.array([3, WINDOW + 1])
        tol = {"f32": EXACT_TOL, "bf16": BF16_TOL, "int8": INT8_TOL}[dt]
        for st in range(2 * WINDOW + 8):
            pos = (start + st).astype(np.int32)
            kv_pos, kv_len, rot = _ring(pos)
            q = rng.normal(size=(B, h, hd)).astype(np.float32)
            kn, vn = (rng.normal(size=(B, kh, hd)).astype(np.float32) for _ in range(2))
            layer = st % L
            out, *jc = step(*map(jnp.asarray, (q, kn, vn)), *jc, layer,
                            *map(jnp.asarray, (kv_pos, kv_len, rot)), jc1, js1)
            upd = A.kv_update_q if dt == "int8" else A.kv_update
            upd(*tc, layer, t(kn), t(vn), t(kv_pos), t(rot), tc1, ts1)
            # the inserted rows and rotated sinks, then the attention over
            # the JAX planes (an f32 ulp upstream can move a code by one)
            for c, jplane in zip(_dequant(tc), _dequant(jc)):
                assert _row_rel(c, jplane) <= max(tol, STEP_TOL if dt == "int8" else 0), (dt, st)
            for c, jplane in zip(tc, jc):
                c.copy_(_to_torch(jplane))
            if dt == "int8":
                got = A.flash_decode_q(t(q), *tc, layer, t(kv_len))
            else:  # the write dropped (kv_pos at the sentinel) and no rotation: the attention
                z, none = t(np.zeros_like(kn)), t(np.zeros_like(rot))
                got = A.fused_decode_attention(t(q), *tc, layer, z, z,
                                               t(np.full_like(kv_pos, S_PHYS)), t(kv_len), none,
                                               tc1, ts1)
            assert got.shape == (B, h * hd)
            assert _row_rel(got.reshape(B * h, hd), np.asarray(out).reshape(B * h, hd)) <= tol, (
                dt, st)
    for dt, tdt, jdt in (("f32", torch.float32, jnp.float32),
                         ("bf16", torch.bfloat16, jnp.bfloat16)):
        ck, cv = (rng.normal(size=(L, 1, kh, 64, hd)).astype(np.float32) for _ in range(2))
        for pos0 in (0, 24):
            q = rng.normal(size=(1, 32, h, hd)).astype(np.float32)
            pos = np.array([pos0], np.int32)
            want = jax_prefill(jnp.asarray(q), jnp.asarray(ck).astype(jdt),
                               jnp.asarray(cv).astype(jdt), jnp.int32(1), jnp.asarray(pos))
            got = A.flash_prefill(t(q), t(ck).to(tdt), t(cv).to(tdt), 1, t(pos))
            assert got.shape == (1, 32, h * hd)
            tol = BF16_TOL if dt == "bf16" else EXACT_TOL
            assert _row_rel(got.reshape(-1, hd), np.asarray(want).reshape(-1, hd)) <= tol, (
                dt, pos0)
