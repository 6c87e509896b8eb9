"""Gemma, Gemma-2 and Phi-3 in the port: Gemma's gelu and embed scale,
Gemma-2's post-norms and attention and logit softcaps, Phi-3's head_dim,
on the per-layer path and as folds of the whole-step megakernel, each
against the JAX package (its Pallas kernels in interpret mode) or HF (the
attention plain versions at head_dim 96 and 256 are in
``tests/test_torch_families.py``), on tiny containers made by
``tests/make_tiny_model.py`` with the override dicts of
``tests/test_gemma.py``, ``test_gemma2.py`` and ``test_phi3.py``, converted
by the JAX converter. Beside them:

- ``gemma2qd``: Gemma-2 with head_dim 24, so q_dim 96 != dim 64, as in
  every published Gemma-2 (9B: 4096 against 3584);
- ``gemma2cap``: ``gemma2qd`` with softcaps that bite. The tiny model's
  uncapped scores reach 1.68 and its logits 7.3 at most (measured on the
  tiny containers with a 40-token prompt), far below Gemma-2's caps of 50
  and 30, where tanh(s / c) * c is s to 1e-4; caps of 1.0 and 3.0 take
  the largest score to 0.93 and the largest logit to 2.9.

Faults of the reference these tests record (ROADMAP section 3):

- the JAX megakernel asserts q_dim == dim with post-norms, while its gate
  takes the model (``test_jax_megakernel_asserts_where_q_dim_differs``);
  the port's megakernel is held to the JAX per-layer path there;
- the JAX forward sends bf16 and f32-cache prefill chunks to its fused
  prefill, which applies no attention softcap
  (``test_biting_softcap_prefill_matches_hf_and_jax_dense``); the port
  follows HF and the JAX dense path.

Tolerances, and why: those of ``tests/test_torch_families.py`` (its
docstring): bit-equal weights; 1e-4 against HF on f32 containers (2e-2
with a bf16 cache, its rounding); 3e-2 and the same argmax for the engines
on i8 containers against the JAX engines; 2e-2 of each step's or row's max
for the megakernel's plain version against the JAX ``fused_decode_step``,
and against the JAX per-layer path (each test says why); 1e-5 for the
flash-decode plain version's softcap against the dense attention over f32
rows, 2e-2 over int8 rows (the bf16 rounding of q and p * v_scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from tests.test_gemma import GEMMA_OVERRIDES
from tests.test_gemma2 import GEMMA2_OVERRIDES
from tests.test_phi3 import PHI3_OVERRIDES
from tests.test_torch_families import (
    BF16_TOL,
    ENGINE_TOL,
    EXACT_TOL,
    HF_TOL,
    S_PHYS,
    STEP_TOL,
    STEPS,
    TOKENS,
    WINDOW,
    _jax_cfg,
    _jax_load,
    _np,
    _port_cfg,
    _port_load,
    _ring,
    _row_rel,
)
from xalm_tpu.convert import convert as cvt
from xalm_tpu.harness import main as jax_harness
from xalm_tpu.models.params import QWeight as JaxQWeight
from xalm_tpu.models.params import recode_wcls_i8 as jax_recode_wcls_i8
from xalm_tpu.ops.fused_decode import fused_decode_step as jax_fused_decode_step
from xalm_tpu.ops.fused_decode import fused_step_supported as jax_fused_step_supported
from xalm_tpu.ops.pallas_attention import rope_cos_sin_plus1 as jax_cos_sin_plus1
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.models import llama
from xalm_tpu_torch.models.config import GEMMA2_9B, KV_SINKS, ModelConfig
from xalm_tpu_torch.models.params import from_jax_params, recode_wcls_i8
from xalm_tpu_torch.ops import attention as A
from xalm_tpu_torch.ops import fused_decode as fd
from xalm_tpu_torch.runtime.engine import Engine
from xalm_tpu_torch.utils.synthetic import (
    biting_softcaps,
    logit_std,
    score_std,
    synthetic_params,
)

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

ATTN_CAP, LOGIT_CAP = 1.0, 3.0  # caps that bite on the tiny model (see the docstring)
FAMILIES = {
    "gemma": GEMMA_OVERRIDES,
    "gemma2": GEMMA2_OVERRIDES,
    "gemma2qd": dict(GEMMA2_OVERRIDES, head_dim=24),
    "gemma2cap": dict(GEMMA2_OVERRIDES, head_dim=24, attn_logit_softcapping=ATTN_CAP,
                      final_logit_softcapping=LOGIT_CAP),
    "phi3": PHI3_OVERRIDES,
}
POST = ("post_attn_norm", "post_mlp_norm")


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


def _leaves(p):
    """(name, values) of a port or JAX ModelParams, the post-norms included."""
    lp = p.layers
    out = [(n, getattr(lp, n)) for n in ("attn_norm", "mlp_norm", *POST)]
    out.append(("out_norm", p.out_norm))
    for name, w in [("embed", p.embed), ("wqkv", lp.wqkv), ("wo", lp.wo), ("w13", lp.w13),
                    ("w2", lp.w2), ("wcls", p.wcls)]:
        out += [(name, w.values), (name + ".scale", w.scale)]
    return out


def _assert_leaves_equal(port, ref, what: str) -> None:
    for (name, got), (_, want) in zip(_leaves(port), _leaves(ref)):
        if want is None:
            assert got is None, (what, name)
            continue
        assert got is not None, (what, name)
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=f"{what} {name}")


def _hf_model(hf):
    import transformers

    model = transformers.AutoModelForCausalLM.from_pretrained(
        hf, torch_dtype=torch.float32, attn_implementation="eager")  # HF caps in eager only
    model.eval()
    return model


# ------------------------------------------------------------------ config and weights


def test_presets_take_the_converters_reading_of_the_published_configs():
    """The three presets equal what the JAX converter makes of the published
    config.json values (the Gemma-2 window at its 4096 sliding window, the
    embed scale as sqrt(hidden_size), gelu_pytorch_tanh as gelu), read by
    the port's ``ModelConfig.from_metadata``."""
    from xalm_tpu_torch.models.config import GEMMA_7B, PHI3_MINI_4K

    common = dict(bos_token_id=2, eos_token_id=1, rope_theta=10000.0)
    published = {
        "GEMMA2_9B": (GEMMA2_9B, dict(
            common, architectures=["Gemma2ForCausalLM"], hidden_size=3584,
            intermediate_size=14336, num_hidden_layers=42, num_attention_heads=16,
            num_key_value_heads=8, head_dim=256, vocab_size=256000, max_position_embeddings=8192,
            sliding_window=4096, rms_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh",
            hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
            query_pre_attn_scalar=256, attn_logit_softcapping=50.0,
            final_logit_softcapping=30.0)),
        "GEMMA_7B": (GEMMA_7B, dict(
            common, architectures=["GemmaForCausalLM"], hidden_size=3072,
            intermediate_size=24576, num_hidden_layers=28, num_attention_heads=16,
            num_key_value_heads=16, head_dim=256, vocab_size=256000, max_position_embeddings=8192,
            rms_norm_eps=1e-6, hidden_act="gelu", hidden_activation="gelu_pytorch_tanh",
            tie_word_embeddings=True)),
        "PHI3_MINI_4K": (PHI3_MINI_4K, dict(
            common, architectures=["Phi3ForCausalLM"], hidden_size=3072,
            intermediate_size=8192, num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=32, vocab_size=32064, max_position_embeddings=4096,
            sliding_window=2047, rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False)),
    }
    for name, (preset, hf_config) in published.items():
        _, meta = cvt.normalize_config(hf_config)
        assert ModelConfig.from_metadata(meta) == preset, name
        _jax_cfg(preset)


@pytest.mark.parametrize("tname", ["f32", "i8"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_load_params_bit_equal_to_jax(models, fam, tname):
    port, ref = _port_load(models[fam][tname]), _jax_load(models[fam][tname])
    _assert_leaves_equal(port, ref, f"{fam} {tname}")
    lp = port.layers
    assert (lp.post_attn_norm is not None) == (lp.post_mlp_norm is not None) == (
        fam.startswith("gemma2"))
    if lp.post_attn_norm is not None:
        assert lp.post_attn_norm.dtype == torch.float32
        assert lp.post_attn_norm.shape == lp.attn_norm.shape


@pytest.mark.parametrize("fam", ["gemma2", "gemma2qd"])
def test_from_jax_params_carries_the_post_norms(models, fam):
    tree = jax.tree.map(np.asarray, _jax_load(models[fam]["i8"]))
    port = from_jax_params(tree, device="cpu")
    _assert_leaves_equal(port, tree, fam)
    p = recode_wcls_i8(port)  # the head recode passes the planes through
    for name in POST:
        assert getattr(p.layers, name) is getattr(port.layers, name)


@pytest.mark.parametrize("fam", ["gemma", "gemma2", "phi3"])
def test_bf16_checkpoint_loads_as_jax(fam, tmp_path):
    """A bf16 HF checkpoint: the converter keeps its 1-D tensors (the four
    Gemma-2 norms with their +1 folded in) in bf16, which the port widens
    as the JAX loader does."""
    import safetensors.torch

    hf = str(tmp_path / "hf")
    make_tiny_model(hf, config_overrides=dict(FAMILIES[fam], torch_dtype="bfloat16"))
    st = f"{hf}/model.safetensors"
    safetensors.torch.save_file(
        {k: v.to(torch.bfloat16) for k, v in safetensors.torch.load_file(st).items()}, st)
    out = str(tmp_path / "bf16_i8.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    port, ref = _port_load(out), _jax_load(out)
    _assert_leaves_equal(port, ref, fam)
    assert float(port.layers.attn_norm.abs().max()) < 10.0  # the values, not their bit patterns


# ------------------------------------------------------------------ the whole path


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_prefill_logits_and_greedy_tokens_match_hf(models, fam):
    """The port's engine on the f32 container (its kernel path, whose
    wrappers run the plain versions on the CPU; f32 cache and compute)
    against HF eager: every logit of a 17-token prefill and 12 greedy
    tokens (gemma2cap: the caps bite)."""
    eng = Engine.from_xalm(models[fam]["f32"], kv_dtype=torch.float32,
                           compute_dtype=torch.float32, device="cpu")
    model = _hf_model(models[fam]["hf"])
    with torch.no_grad():
        want = model(torch.tensor([TOKENS])).logits[0].numpy()
        hf_tokens = model.generate(torch.tensor([TOKENS[:6]]), max_new_tokens=12,
                                   do_sample=False)[0][6:].tolist()
    got, _, _ = eng.prefill(TOKENS, eng.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(got, want, **HF_TOL)
    if fam == "gemma2cap":
        assert np.abs(got).max() <= LOGIT_CAP
    out, _ = eng.generate(TOKENS[:6], 12, stop_on_eos=False)
    assert out == hf_tokens


@pytest.mark.parametrize("kv", ["f32", "bf16"])
def test_biting_softcap_prefill_matches_hf_and_jax_dense(models, kv):
    """Gemma-2 with an attention cap that bites: the port's prefill (its
    kernel path, which sends capped attention to the dense attention) gives
    HF's logits and the JAX XLA path's, with an f32 and with a bf16 cache.
    The JAX Pallas path sends the same chunk to its fused prefill, which
    applies no attention softcap: its logits miss HF's by far more than the
    tolerance (a fault of the reference, recorded here). Decoding the same
    tokens one at a time, the JAX Pallas path gates its fused attention off
    at t = 1 and agrees again."""
    path = models["gemma2cap"]["f32"]
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[kv]
    tol = HF_TOL if kv == "f32" else dict(rtol=2e-2, atol=2e-2)
    with torch.no_grad():
        hf = _hf_model(models["gemma2cap"]["hf"])(torch.tensor([TOKENS])).logits[0].numpy()
    port = Engine.from_xalm(path, kv_dtype=tdt, compute_dtype=torch.float32, device="cpu")
    got, _, _ = port.prefill(TOKENS, port.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(got, hf, **tol)
    logits = {}
    for impl in ("xla", "pallas"):
        ref = JaxEngine.from_xalm(path, matmul_impl=impl, kv_dtype=jdt, compute_dtype=jnp.float32,
                                  fused_step=False, progress=False)
        logits[impl], _, _ = ref.prefill(TOKENS, ref.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(got, logits["xla"], **tol)
    miss = float(np.abs(np.asarray(logits["pallas"]) - hf).max())
    assert miss > 10 * tol["atol"], miss  # the JAX fused prefill skips the cap
    cache, steps = ref.new_cache(1), []
    for i, tok in enumerate(TOKENS):
        lg, cache = ref.decode(np.array([tok]), np.array([i]), cache)
        steps.append(np.asarray(lg)[0])
    np.testing.assert_allclose(np.stack(steps), hf, **tol)


ENGINE_CASES = [(fam, path, "f32") for fam in ("gemma", "gemma2", "phi3")
                for path in ("megakernel", "perlayer")] + [
    ("gemma2", "perlayer", "int8"), ("gemma", "megakernel", "int8"), ("phi3", "perlayer", "int8"),
    ("gemma2", "megakernel", "int8")]


@pytest.mark.parametrize("fam,path,kv", ENGINE_CASES)
def test_engine_matches_jax_through_wraps(models, fam, path, kv):
    """i8 container, a 10-token prompt chunk, then teacher-forced decode
    through two ring wraps, on the JAX engine's Pallas path (kernels in
    interpret mode) and the port's kernel path, the decode path pinned on
    both; then 20 greedy tokens. (Gemma-2's published caps: the JAX
    prefill's missing cap moves no logit past 1e-4 on this model.)"""
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


def test_jax_megakernel_asserts_where_q_dim_differs(models):
    """A fault of the reference: with post-norms the JAX megakernel asserts
    q_dim == dim (``xalm_tpu/ops/fused_decode.py`` ``has_pn``), while its
    gate takes the model; the port's megakernel takes it (the next test)."""
    jeng = JaxEngine.from_xalm(models["gemma2qd"]["i8"], context=WINDOW, matmul_impl="pallas",
                               kv_dtype=jnp.bfloat16, progress=False)
    cfg, p = jeng.cfg, jeng.params
    assert cfg.q_dim != cfg.dim
    cache = jeng.new_cache(1)
    assert jax_fused_step_supported(cfg, p, cache.k, 1, 1)
    c1, s1 = jax_cos_sin_plus1(llama.rope_freqs(_port_cfg(cfg)))
    i = jnp.zeros((1,), jnp.int32)
    hd = jnp.zeros((1, cfg.head_dim), jnp.float32)
    with pytest.raises(AssertionError):
        jax_fused_decode_step(p, cfg, jnp.zeros((1, cfg.dim)), cache.k, cache.v, i, i + 1, i,
                              hd + 1, hd, jnp.asarray(c1), jnp.asarray(s1))
    port = Engine.from_xalm(models["gemma2qd"]["i8"], context=WINDOW, kv_dtype=torch.float32,
                            device="cpu")
    assert port.decode_path(1) == "megakernel"


@pytest.mark.parametrize("fam", ["gemma2qd", "gemma2cap"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_megakernel_matches_jax_perlayer_where_q_dim_differs(models, fam, kv):
    """Where the JAX megakernel asserts (q_dim != dim with post-norms), the
    port's megakernel (its plain version on the CPU) against the JAX
    per-layer path: one token at a time from an empty cache through two ring
    wraps (every step at t = 1, where the JAX path applies the attention
    cap), the published caps and caps that bite. The two compute attention
    differently (the megakernel rounds q and, over int8 codes, p * v_scale
    to bf16; the JAX per-layer path runs the dense f32 attention), so each
    step is held to STEP_TOL of its max, and the argmax where the top-2
    margin is above twice that."""
    jkv, tkv = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[kv]
    ref = JaxEngine.from_xalm(models[fam]["i8"], context=WINDOW, matmul_impl="pallas",
                              kv_dtype=jkv, compute_dtype=jnp.float32, progress=False,
                              fused_step=False)
    port = Engine.from_xalm(models[fam]["i8"], context=WINDOW, kv_dtype=tkv,
                            compute_dtype=torch.float32, device="cpu")
    assert port.decode_path(1) == "megakernel" and ref.decode_path(1) == "perlayer"
    rng = np.random.default_rng(len(fam) + len(kv))
    cr, cp = ref.new_cache(1), port.new_cache(1)
    for pos, tok in enumerate(rng.integers(3, 350, size=WINDOW + 2 * (WINDOW - KV_SINKS) + 2)):
        step = (np.array([tok]), np.array([pos], np.int32))
        lr, cr = ref.decode(*step, cr)
        lp, cp = port.decode(*step, cp)
        want = np.asarray(lr, np.float32)[0]
        assert _row_rel(lp.reshape(1, -1), want[None]) <= STEP_TOL, pos
        top2 = np.sort(want)[-2:]
        if top2[1] - top2[0] > 2 * STEP_TOL * np.abs(want).max():
            assert int(lp.argmax()) == int(want.argmax()), pos


@pytest.mark.parametrize("fam", ["gemma2", "gemma", "phi3"])
def test_decode_path_and_active_bytes(models, fam):
    """Each family decodes on the megakernel on the CPU (its plain version
    takes any head_dim; on the card head_dim 96 goes per layer, see
    test_head_dim_gate); ``active_bytes`` is the JAX engine's plus the f32
    post-norm planes a decode step reads, which the JAX count leaves out."""
    port = Engine.from_xalm(models[fam]["i8"], kv_dtype=torch.float32, device="cpu")
    ref = JaxEngine.from_xalm(models[fam]["i8"], matmul_impl="pallas", kv_dtype=jnp.float32,
                              progress=False)
    assert port.decode_path(1) == "megakernel"
    lp = port.params.layers
    planes = 4 * sum(getattr(lp, n).numel() for n in POST if getattr(lp, n) is not None)
    assert (planes > 0) == (fam == "gemma2")
    for pos in (0, 7, 100):
        assert port.active_bytes(pos) == ref.active_bytes(pos) + planes


@pytest.mark.parametrize("hd,on_card,want", [(96, True, False), (128, True, True),
                                             (256, True, True), (64, True, False),
                                             (96, False, True), (16, False, True)])
def test_head_dim_gate(hd, on_card, want):
    """The megakernel's head_dim rule (``fused_step_supported`` applies it
    where the weights lie): on the card the kernel's 128 and 256, so that
    Phi-3-mini (96) decodes on the per-layer kernels, as the JAX gate sends
    head_dim % 128 != 0 per layer on the TPU (before, the port's gate took
    head_dim 96 on the card and its wrapper raised at the first decode
    step); on the CPU, where the plain version runs, any even head_dim."""
    assert fd.head_dim_supported(hd, on_card) == want


def _generated_text(out: str) -> list[str]:
    return out.split("Generation stats")[0].split("Encoding stats")[-1].splitlines()[1:]


@pytest.mark.parametrize("fam", ["gemma2", "gemma", "phi3"])
def test_harness_matches_jax(models, fam, capsys):
    """The harnesses on each i8 container: the same completion text through
    two ring wraps on the reference path of both; the port's kernel path
    with -t bf16 and -t i8 completes, on the megakernel."""
    path = models[fam]["i8"]
    args = [path, "-m", "c", "-i", "hello world the quick", "-n", "40", "-T", str(WINDOW),
            "--matmul", "xla"]
    assert jax_harness.main(args) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "-t", "f16", "--compute", "f32"]) == 0
    got = capsys.readouterr().out
    assert _generated_text(got) == _generated_text(want)
    for t in ("bf16", "i8"):
        assert port_harness.main([path, "-d", "cpu", "-t", t, "-i", "hello", "-n", "8"]) == 0
        assert "decode path: megakernel" in capsys.readouterr().out


# ------------------------------------------------------------------ the megakernel's folds


MEGA_CASES = [("gemma2", "bf16", 1), ("gemma2", "int8", 3), ("gemma", "bf16", 3),
              ("gemma", "int8", 1)]


@pytest.mark.parametrize("fam,cache,b", MEGA_CASES)
def test_fused_decode_step_folds_match_jax(models, fam, cache, b):
    """``fused_decode_step`` on CPU tensors (its plain version) with Gemma's
    gelu and embed scale, and Gemma-2's post-norms and both softcaps at
    ATTN_CAP and LOGIT_CAP (q_dim == dim: the JAX kernel asserts otherwise),
    against the JAX ``fused_decode_step`` in interpret mode, from zeroed
    planes through three wraps of the window; at B = 1 with the embed fold
    (where the kernel applies the embed scale) and the i8-head fold (the
    logit cap), at B = 3 row 1 at the kv_pos == S sentinel."""
    jeng = JaxEngine.from_xalm(models[fam]["i8"], context=WINDOW, matmul_impl="pallas",
                               progress=False)
    jcfg = jeng.cfg
    if fam == "gemma2":
        jcfg = dataclasses.replace(jcfg, attn_softcap=ATTN_CAP, logit_softcap=LOGIT_CAP)
    cfg = _port_cfg(jcfg)
    folds = b == 1
    jparams = jeng.params
    if folds:
        jparams = jax_recode_wcls_i8(dataclasses.replace(
            jparams, embed=JaxQWeight(jparams.embed.values.astype(jnp.bfloat16))))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    assert (params.layers.post_attn_norm is not None) == (fam == "gemma2")
    freqs = llama.rope_freqs(cfg)
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
        x0 = (emb[tok] * np.float32(cfg.embed_scale)).astype(np.float32)  # the forward's scaling
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
            if cfg.logit_softcap:
                assert float(got[1].abs().max()) <= cfg.logit_softcap
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


def test_megakernel_checks_take_the_post_norms():
    """The gate takes a body with post-norms; the plain version refuses
    post-norm planes of the wrong shape, and one without the other."""
    cfg = biting_softcaps(dataclasses.replace(
        GEMMA2_9B, dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32,
        rotary_dim=32, vocab_size=64, max_seq_len=32))
    params = synthetic_params(cfg, device="cpu")
    lp = params.layers
    assert lp.post_attn_norm.shape == lp.post_mlp_norm.shape == (2, 64)
    assert float(lp.post_attn_norm.min()) >= 0.5 and float(lp.post_attn_norm.max()) < 1.5
    ck = torch.zeros((2, 1, 2, 32, 32), dtype=torch.bfloat16)
    assert fd.fused_step_supported(cfg, params, ck, 1, 1)
    c1, s1 = A.rope_cos_sin_plus1(llama.rope_freqs(cfg))
    args = (cfg, torch.zeros((1, 64)), ck, ck.clone(), torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            torch.ones((1, 32)), torch.zeros((1, 32)), torch.from_numpy(c1), torch.from_numpy(s1))
    fd.fused_decode_step_plain(params, *args)
    for bad, msg in ((dict(post_mlp_norm=None), "come together"),
                     (dict(post_attn_norm=lp.post_attn_norm[:, :8],
                           post_mlp_norm=lp.post_mlp_norm[:, :8]), "post_attn_norm")):
        wrong = dataclasses.replace(params, layers=dataclasses.replace(lp, **bad))
        with pytest.raises(ValueError, match=msg):
            fd.fused_decode_step_plain(wrong, *args)


def test_biting_softcaps_bite_and_the_folds_move_the_logits():
    """On synthetic weights at a reduced Gemma-2 geometry: the uncapped
    scores and logits have about the std ``score_std`` and ``logit_std``
    say, and the caps of ``biting_softcaps`` take the largest of them down
    by over 20 %. Then, on louder q/k and gate rows, every fold (post-norms,
    either cap, gelu, the embed scale) moves the logits past the engine bar,
    while the megakernel's plain version and the per-layer path agree."""
    base = dataclasses.replace(GEMMA2_9B, dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                               n_kv_heads=2, head_dim=64, rotary_dim=64, vocab_size=2048,
                               max_seq_len=64)
    cfg = biting_softcaps(base)
    assert cfg.attn_softcap == pytest.approx(2 * score_std(256))
    assert cfg.logit_softcap == pytest.approx(2 * logit_std(256))
    params = synthetic_params(cfg, device="cpu", seed=3)
    seen = {}
    orig = llama.softcap

    def spy(v, cap):
        if cap:
            seen.setdefault(cap, []).append(v[torch.isfinite(v)])
        return orig(v, cap)

    prompt = list(range(3, 43))
    llama.softcap = spy
    try:
        eng = Engine(cfg, params, kv_dtype=torch.float32, compute_dtype=torch.float32,
                     fused_step=False)
        eng.prefill(prompt, eng.new_cache(1), logits_mode="all")
    finally:
        llama.softcap = orig
    scores = torch.cat([s.flatten() for s in seen[cfg.attn_softcap]])
    scores = scores[scores != 0]  # the slots past kv_len score 0 before the mask
    logits = torch.cat([s.flatten() for s in seen[cfg.logit_softcap]])
    assert 0.5 < float(scores.std()) / score_std(256) < 2.0
    assert 0.5 < float(logits.std()) / logit_std(256) < 2.0
    for v, cap in ((scores, cfg.attn_softcap), (logits, cfg.logit_softcap)):
        top = float(v.abs().max())
        assert float(orig(torch.tensor(top), cap)) < 0.8 * top

    # louder q/k and gate rows (std 1.9 and 0.75 rather than 0.19): the
    # scores' std 3.5 against the cap, so that capped and uncapped attention
    # differ, and gates where gelu and SiLU differ (at small gates both are
    # near g / 2 + c g^2, and the post-norm takes out the scale); and an FFN
    # output ten times the others, so that its activation shows in the logits
    params.layers.wqkv.scale.mul_(10.0)
    params.layers.w13.scale.mul_(4.0)
    params.layers.post_mlp_norm.mul_(10.0)
    out = {}
    nocap = dataclasses.replace(cfg, logit_softcap=0.0)  # the other folds' logits uncompressed
    variants = {
        "mega": (cfg, params, {}), "perlayer": (cfg, params, dict(fused_step=False)),
        "no logit cap": (nocap, params, {}),
        "no post-norms": (nocap, dataclasses.replace(params, layers=dataclasses.replace(
            params.layers, post_attn_norm=None, post_mlp_norm=None)), {}),
        "no attn cap": (dataclasses.replace(nocap, attn_softcap=0.0), params, {}),
        "silu": (dataclasses.replace(nocap, act="silu"), params, {}),
        "no embed scale": (dataclasses.replace(nocap, embed_scale=1.0), params, {}),
    }
    for name, (c, p, kw) in variants.items():
        eng = Engine(c, p, kv_dtype=torch.bfloat16, compute_dtype=torch.float32, **kw)
        _, cache, pos = eng.prefill(prompt, eng.new_cache(1))
        out[name], _ = eng.decode(np.array([5]), np.array([pos], np.int32), cache)
    ref = out["perlayer"]
    scale = float(ref.abs().max())
    assert float((out["mega"] - ref).abs().max()) <= ENGINE_TOL["atol"] * scale
    moves = {name: float((out[name] - out["no logit cap"]).abs().max())
             / float(out["no logit cap"].abs().max())
             for name in ("mega", "no post-norms", "no attn cap", "silu", "no embed scale")}
    for name, rel in moves.items():
        assert rel > 0.1, (name, moves)


# ------------------------------------------------------------------ the plain versions' softcap


def test_plain_decode_attention_softcap_matches_the_dense_attention():
    """The softcap of the flash-decode plain versions (the megakernel's
    fold): ``flash_decode_plain`` and ``flash_decode_q_plain`` with a cap
    give the dense attention of the forward with that cap over the same
    rows (f32 cache: 1e-5; int8: 2e-2, since the int8 version rounds q and
    p * v_scale to bf16 as its kernel does, and the dense attention does
    not), and the cap moves them."""
    rng = np.random.default_rng(5)
    b, kh, g, s, hd = 2, 2, 2, 48, 32
    q = torch.from_numpy(rng.normal(size=(b, kh * g, hd)).astype(np.float32)) * 3
    ck, cv = (torch.from_numpy(rng.normal(size=(1, b, kh, s, hd)).astype(np.float32))
              for _ in range(2))
    kv_len = torch.tensor([40, 17], dtype=torch.int32)
    dense = llama.attention(q[:, None], ck[0], cv[0], kv_len[:, None], attn_softcap=0.5)[:, 0]
    got = A.flash_decode_plain(q, ck, cv, 0, kv_len, attn_softcap=0.5)
    assert _row_rel(got.reshape(-1, hd), dense.reshape(-1, hd)) <= EXACT_TOL
    assert _row_rel(A.flash_decode_plain(q, ck, cv, 0, kv_len).reshape(-1, hd),
                    dense.reshape(-1, hd)) > 0.05
    codes, scales = zip(*(A.quant_rows(c) for c in (ck, cv)))
    deq = [c.float() * sc[..., None] for c, sc in zip(codes, scales)]
    dense_q = llama.attention(q[:, None], deq[0][0], deq[1][0], kv_len[:, None],
                              attn_softcap=0.5)[:, 0]
    got_q = A.flash_decode_q_plain(q, codes[0], codes[1], scales[0], scales[1], 0, kv_len,
                                   attn_softcap=0.5)
    assert _row_rel(got_q.reshape(-1, hd), dense_q.reshape(-1, hd)) <= BF16_TOL



@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_act_fn_matches_jax(act):
    """The one GLU activation of the port (``ops.attention.act_fn``: the
    forward, the MoE FFN and the megakernel's plain version) against the
    JAX forward's: ``jax.nn.silu``, or ``jax.nn.gelu(approximate=True)``
    for Gemma, in f32 to 1e-6 of the largest value, over gates in [-8, 8)."""
    x = np.random.default_rng(11).uniform(-8.0, 8.0, size=(4, 512)).astype(np.float32)
    want = np.asarray(jax.nn.silu(x) if act == "silu" else jax.nn.gelu(x, approximate=True))
    got = A.act_fn(act, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    other = A.act_fn("gelu" if act == "silu" else "silu", torch.from_numpy(x)).numpy()
    assert np.abs(other - want).max() > 1e-2
