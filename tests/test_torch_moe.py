"""The port's Mixtral sparse-MoE path against the JAX package on the CPU, on
a tiny Mixtral (4 experts, 2 active; ``tests/test_mixtral.py``'s overrides)
converted by the JAX converter:

(a) ``load_params`` of the router and expert stacks (and scales) bit-equal
    to the JAX loader, and ``from_jax_params`` carrying them across;
(b) ``qmatmul_multi_plain`` (what ``qmatmul_multi`` runs on CPU tensors)
    against ``pallas_qmatmul_stacked_multi`` in interpret mode;
(c) prefill logits (the dense-masked experts) against the JAX engine;
(d) gathered decode (``impl="kernel"``) against the JAX "pallas" path, and
    greedy tokens from ``generate``;
(e) the port against HF ``transformers``;
(f) B = 2 decode (dense-masked) and an int8-cache decode against JAX;
(g) ``active_bytes`` and ``decode_path``;
(h) the harness's completion text against the JAX harness.

Tolerances, and why:

- (b) f32 weights 1e-5 of max |ref| (f32 products summed in another
  order); int8 and bf16 weights 1e-4 (exact products of bf16-rounded x,
  summed in f32 in another order), as for kernel 1 in test_torch_ops.py;
- f32 container: logits within 1e-4 (prefill, HF) and 2e-4 (decode), the
  bars of tests/test_mixtral.py: f32 everywhere, only summation order and
  the last bit of transcendental functions differ;
- i8 container: 2e-3, the bar of tests/test_torch_engine.py: x is rounded
  to bf16 before each i8 matmul on both sides, and an f32 ulp upstream can
  flip one such rounding;
- int8 cache: 3e-2 and the same argmax, the bars of tests/test_torch_kvq.py;
- the port's gathered decode against its own dense-masked path on int8
  experts: 2e-2. At f32 compute the dense path multiplies unrounded x,
  while the gather rounds x to bf16 first, as the TPU kernel does (2^-8
  relative per activation; 6e-3 of logits measured on the tiny model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from tests.test_mixtral import MIXTRAL_OVERRIDES, TOKENS
from xalm_tpu.convert import convert as cvt
from xalm_tpu.harness import main as jax_harness
from xalm_tpu.io import XalmFile as JaxXalmFile
from xalm_tpu.models.config import ModelConfig as JaxConfig
from xalm_tpu.models.params import load_params as jax_load_params
from xalm_tpu.ops.pallas_matmul import pallas_qmatmul_stacked_multi
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.io import XalmFile
from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.models.params import from_jax_params, load_params
from xalm_tpu_torch.ops import qmatmul as qmm
from xalm_tpu_torch.runtime.engine import Engine

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

TYPES = ["f32", "f16", "i8", "q8"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)
I8_TOL = dict(rtol=2e-3, atol=2e-3)
DENSE_I8_TOL = dict(rtol=2e-2, atol=2e-2)
WINDOW = 16


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny_mixtral"),
                         config_overrides=MIXTRAL_OVERRIDES)
    d = tmp_path_factory.mktemp("x")
    out = {"hf": hf}
    for t in TYPES:
        out[t] = str(d / f"tiny_mx_{t}.xalm")
        assert cvt.main(["--input", hf, "--output", out[t], "--type", t]) == 0
    return out


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _moe_leaves(p):
    lp = p.layers
    return [("wgate", lp.wgate), ("w13e", lp.w13e.values), ("w13e.scale", lp.w13e.scale),
            ("w2e", lp.w2e.values), ("w2e.scale", lp.w2e.scale)]


def _jax_params(path):
    jf = JaxXalmFile(path)
    ref = jax_load_params(jf, JaxConfig.from_metadata(jf.config))
    jf.close()
    return ref


def _check_equal(port, ref, tname):
    assert port.layers.w13 is None and port.layers.w2 is None
    for (name, got), (_, want) in zip(_moe_leaves(port), _moe_leaves(ref)):
        if want is None:
            assert got is None, name
            continue
        want = _np(want)
        assert tuple(got.shape) == want.shape, name
        assert _np(got).dtype.itemsize == want.dtype.itemsize, name
        np.testing.assert_array_equal(_np(got), want, err_msg=f"{tname} {name}")


# ---- (a) weights


@pytest.mark.parametrize("tname", TYPES)
def test_load_params_moe_bit_equal_to_jax(containers, tname):
    with XalmFile(containers[tname]) as xf:
        cfg = ModelConfig.from_metadata(xf.config)
        port = load_params(xf, cfg, device="cpu")
    assert cfg.n_experts == 4 and cfg.n_experts_active == 2
    assert port.layers.wgate.dtype == torch.float32
    assert tuple(port.layers.w13e.values.shape) == (2, 4, 256, 64)
    assert tuple(port.layers.w2e.values.shape) == (2, 4, 64, 128)
    _check_equal(port, _jax_params(containers[tname]), tname)
    assert port.nbytes() == _jax_params(containers[tname]).nbytes()


@pytest.mark.parametrize("tname", ["f32", "i8"])
def test_from_jax_params_carries_the_experts(containers, tname):
    tree = jax.tree.map(np.asarray, _jax_params(containers[tname]))
    _check_equal(from_jax_params(tree, device="cpu"), tree, tname)


def test_int8_router_is_refused(containers, tmp_path):
    """The router decides which experts run: an int8 code of it is refused."""
    from xalm_tpu_torch.io import write_xalm

    with XalmFile(containers["f32"]) as xf:
        tensors = {n: xf.load_torch(n) for n in xf.tensors}
        meta, arch = dict(xf.config), xf.arch
    for name in [n for n in tensors if n.endswith(".moe.gate.weight")]:
        w = tensors[name]
        tensors[name + ".scale"] = w.abs().amax(dim=1) / 127
        tensors[name] = torch.round(w / tensors[name + ".scale"][:, None]).to(torch.int8)
    path = str(tmp_path / "i8_router.xalm")
    write_xalm(path, arch, meta, tensors)
    with XalmFile(path) as xf, pytest.raises(ValueError, match="router"):
        load_params(xf, ModelConfig.from_metadata(xf.config), device="cpu")


# ---- (b) the gathered expert matmul

LE, D, N = 8, 256, 128  # 2 layers x 4 experts


@pytest.mark.parametrize("wdt", ["i8", "q8", "bf16", "f32"])
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("shared_x", [True, False])
def test_qmatmul_multi_matches_pallas(wdt, m, shared_x):
    rng = np.random.default_rng(m + 2 * shared_x + 4 * ["i8", "q8", "bf16", "f32"].index(wdt))
    idxs = np.array([1 * 4 + 3, 1 * 4 + 0], np.int32)  # the last layer's experts 3 and 0
    k = len(idxs)
    x = (rng.normal(size=(m if shared_x else k * m, N)) * 0.7).astype(np.float32)
    scale = None
    if wdt in ("i8", "q8"):
        w = rng.integers(-127, 128, size=(LE, D, N)).astype(np.int8)
        if wdt == "i8":
            scale = (rng.random((LE, D)) * 0.02 + 0.001).astype(np.float32)
        wj, wt = jnp.asarray(w), torch.from_numpy(w)
    elif wdt == "bf16":
        wt = torch.from_numpy((rng.normal(size=(LE, D, N)) * 0.05).astype(np.float32)).to(
            torch.bfloat16)
        wj = jnp.asarray(wt.view(torch.int16).numpy()).view(jnp.bfloat16)
    else:
        w = (rng.normal(size=(LE, D, N)) * 0.05).astype(np.float32)
        wj, wt = jnp.asarray(w), torch.from_numpy(w)
    want = np.asarray(pallas_qmatmul_stacked_multi(
        jnp.asarray(x), wj, None if scale is None else jnp.asarray(scale), jnp.asarray(idxs),
        shared_x=shared_x))
    got = qmm.qmatmul_multi(torch.from_numpy(x), wt,
                            None if scale is None else torch.from_numpy(scale),
                            torch.from_numpy(idxs), shared_x=shared_x).numpy()
    assert got.shape == want.shape == (k * m, D)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel < (1e-5 if wdt == "f32" else 1e-4), rel


def test_qmatmul_multi_refuses_shapes_outside_the_tpu_limits():
    w = torch.zeros((4, 16, 32), dtype=torch.int8)
    idxs = torch.tensor([0, 1], dtype=torch.int32)
    for x, shared in ((torch.zeros((256, 32)), True), (torch.zeros((3, 32)), False)):
        with pytest.raises(ValueError):
            qmm.qmatmul_multi(x, w, None, idxs, shared_x=shared)


@pytest.mark.parametrize("dtype,gathers", [(torch.int8, True), (torch.bfloat16, True),
                                           (torch.float32, True), (torch.float16, False)])
def test_gathered_gate_on_cpu_tensors(dtype, gathers):
    """The JAX gate's dtypes on the CPU (int8, bf16, f32; f16 runs the
    dense-masked experts), on both per-layer paths; "xla" never gathers."""
    from xalm_tpu_torch.models.llama import gathered_ok
    from xalm_tpu_torch.models.params import QWeight

    qw = QWeight(torch.zeros((2, 4, 16, 8), dtype=dtype), None)
    assert gathered_ok(qw, "kernel") == gathered_ok(qw, "plain") == gathers
    assert not gathered_ok(qw, "xla")


# ---- engines


def _pair(path, *, jax_impl="pallas", port_impl="kernel", kv=("f32", "f32"), context=0):
    jkv = {"f32": jnp.float32, "i8": jnp.int8}[kv[0]]
    tkv = {"f32": torch.float32, "i8": torch.int8}[kv[1]]
    ref = JaxEngine.from_xalm(path, context=context, matmul_impl=jax_impl, kv_dtype=jkv,
                              compute_dtype=jnp.float32, progress=False)
    port = Engine.from_xalm(path, context=context, matmul_impl=port_impl, kv_dtype=tkv,
                            compute_dtype=torch.float32, device="cpu")
    return ref, port


@pytest.fixture
def count_multi(monkeypatch):
    calls = {"n": 0}
    plain = qmm.qmatmul_multi_plain

    def counted(*args, **kw):
        calls["n"] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(qmm, "qmatmul_multi_plain", counted)
    return calls


# ---- (c) prefill (dense-masked experts)


@pytest.mark.parametrize("tname", ["f32", "i8"])
def test_prefill_logits_match_jax(containers, tname, count_multi):
    ref, port = _pair(containers[tname])
    lr, _, _ = ref.prefill(TOKENS, ref.new_cache(1), logits_mode="all")
    lp, _, _ = port.prefill(TOKENS, port.new_cache(1), logits_mode="all")
    assert lp.shape == (len(TOKENS), 384)
    np.testing.assert_allclose(lp, np.asarray(lr), **(F32_TOL if tname == "f32" else I8_TOL))
    assert count_multi["n"] == 0  # a prefill chunk never gathers


# ---- (d) gathered decode


@pytest.mark.parametrize("tname", ["f32", "i8"])
def test_gathered_decode_matches_jax(containers, tname, count_multi):
    """10 decode steps from an empty cache: the port's gathered experts
    (``qmatmul_multi`` -> its plain version on the CPU) against the JAX
    gathered path (``pallas_qmatmul_stacked_multi``, interpret mode), and
    against the port's own dense-masked "xla" path; then greedy tokens."""
    ref, port = _pair(containers[tname])
    dense = Engine.from_xalm(containers[tname], matmul_impl="xla", kv_dtype=torch.float32,
                             compute_dtype=torch.float32, device="cpu")
    tol = dict(rtol=2e-4, atol=2e-4) if tname == "f32" else I8_TOL
    dense_tol = tol if tname == "f32" else DENSE_I8_TOL
    toks = np.random.default_rng(31).integers(3, 350, size=10)
    cr, cp, cd = ref.new_cache(1), port.new_cache(1), dense.new_cache(1)
    for i, t in enumerate(toks):
        pos = np.array([i], np.int32)
        lr, cr = ref.decode(np.array([t]), pos, cr)
        lp, cp = port.decode(np.array([t]), pos, cp)
        ld, cd = dense.decode(np.array([t]), pos, cd)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **tol, err_msg=f"step {i}")
        np.testing.assert_allclose(ld.numpy(), lp.numpy(), **dense_tol, err_msg=f"dense, step {i}")
    assert count_multi["n"] == 2 * 2 * len(toks)  # w13 and w2, per layer, per step
    prompt = np.random.default_rng(32).integers(3, 350, size=6).tolist()
    want, _ = ref.generate(prompt, 8, stop_on_eos=False)
    got, _ = port.generate(prompt, 8, stop_on_eos=False)
    assert got == want


def test_gathered_decode_through_ring_wraps(containers):
    """Teacher-forced decode through three wraps of a 16-slot window, the
    sinks rotating: the gathered path against JAX at every step."""
    ref, port = _pair(containers["i8"], context=WINDOW)
    rng = np.random.default_rng(5)
    prompt = rng.integers(3, 350, size=10).tolist()
    lr, cr, _ = ref.prefill(prompt, ref.new_cache(1))
    lp, cp, _ = port.prefill(prompt, port.new_cache(1))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **I8_TOL)
    for i, tok in enumerate(rng.integers(3, 350, size=3 * (WINDOW - 2) + 3).tolist()):
        pos = np.array([len(prompt) + i], np.int32)
        lr, cr = ref.decode(np.array([tok]), pos, cr)
        lp, cp = port.decode(np.array([tok]), pos, cp)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **I8_TOL, err_msg=f"pos {pos[0]}")


# ---- (e) HF transformers


def test_logits_match_hf(containers):
    import transformers

    model = transformers.AutoModelForCausalLM.from_pretrained(containers["hf"],
                                                              torch_dtype=torch.float32)
    model.eval()
    with torch.no_grad():
        want = model(torch.tensor([TOKENS])).logits[0].numpy()
    port = Engine.from_xalm(containers["f32"], kv_dtype=torch.float32,
                            compute_dtype=torch.float32, device="cpu")
    got, _, _ = port.prefill(TOKENS, port.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(got, want, **F32_TOL)
    # token by token through the gathered decode, against the same logits
    cache = port.new_cache(1)
    for i, tok in enumerate(TOKENS):
        lg, cache = port.decode(np.array([tok]), np.array([i], np.int32), cache)
        np.testing.assert_allclose(lg.numpy()[0], want[i], rtol=2e-4, atol=2e-4)


# ---- (f) B = 2 (dense-masked decode) and the int8 cache


def test_batch2_decode_matches_jax(containers, count_multi):
    ref, port = _pair(containers["f32"])
    cr, cp = ref.new_cache(2), port.new_cache(2)
    rng = np.random.default_rng(7)
    for i in range(8):
        toks = rng.integers(3, 350, size=2)
        pos = np.array([i, i + 3], np.int32)  # the rows stand at different positions
        lr, cr = ref.decode(toks, pos, cr)
        lp, cp = port.decode(toks, pos, cp)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), rtol=2e-4, atol=2e-4)
    assert count_multi["n"] == 0  # B = 2 runs the dense-masked experts


def test_int8_cache_decode_matches_jax(containers):
    ref, port = _pair(containers["f32"], kv=("i8", "i8"), context=WINDOW)
    assert port.decode_path(1) == "perlayer"
    rng = np.random.default_rng(8)
    prompt = rng.integers(3, 350, size=9).tolist()
    lr, cr, _ = ref.prefill(prompt, ref.new_cache(1))
    lp, cp, _ = port.prefill(prompt, port.new_cache(1))
    for i, tok in enumerate(rng.integers(3, 350, size=2 * WINDOW).tolist()):
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), rtol=3e-2, atol=3e-2)
        assert int(lp.argmax()) == int(np.asarray(lr).argmax())
        pos = np.array([len(prompt) + i], np.int32)
        lr, cr = ref.decode(np.array([tok]), pos, cr)
        lp, cp = port.decode(np.array([tok]), pos, cp)


# ---- (g) accounting


@pytest.mark.parametrize("tname", ["f32", "i8"])
@pytest.mark.parametrize("impls", [("pallas", "kernel"), ("xla", "xla")])
def test_active_bytes_match_jax(containers, tname, impls):
    ref, port = _pair(containers[tname], jax_impl=impls[0], port_impl=impls[1])
    for pos in (0, 7, 100):
        assert port.active_bytes(pos) == ref.active_bytes(pos)
    if impls[1] == "kernel":
        assert port.decode_path(1) == ref.decode_path(1) == "perlayer"
        lw = port.params.layers
        experts = lw.w13e.nbytes() + lw.w2e.nbytes()
        _, dense = _pair(containers[tname], jax_impl="xla", port_impl="xla")
        assert dense.active_bytes(0) - port.active_bytes(0) == experts - experts * 2 // 4


def test_synthetic_moe_params_run(count_multi):
    """synthetic_params draws the MoE stacks; the engine decodes them on the
    gathered path."""
    import dataclasses

    from xalm_tpu_torch.models.config import MIXTRAL_8X7B
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MIXTRAL_8X7B, dim=64, hidden_dim=128, n_layers=2, n_heads=4,
                              n_kv_heads=2, head_dim=16, rotary_dim=16, vocab_size=100,
                              max_seq_len=64)
    p = synthetic_params(cfg, device="cpu", seed=0)
    lw = p.layers
    assert lw.w13 is None and lw.wgate.shape == (2, 8, 64)
    assert lw.w13e.values.dtype == torch.int8 and lw.w13e.values.shape == (2, 8, 256, 64)
    assert lw.w2e.scale.shape == (2, 8, 64)
    eng = Engine(cfg, p)
    out, stats = eng.generate([1, 5, 9], 5, stop_on_eos=False)
    assert len(out) == 5 and eng.decode_path(1) == "perlayer"
    assert count_multi["n"] == 2 * 2 * 4  # 4 decode steps after the prefill's token


# ---- (h) the harness


def _generated_text(out: str) -> list[str]:
    return out.split("Generation stats")[0].split("Encoding stats")[-1].splitlines()[1:]


@pytest.mark.parametrize("impls", [("pallas", "kernel"), ("xla", "xla")])
def test_harness_completion_identical_to_jax(containers, capsys, impls):
    args = [containers["i8"], "-m", "c", "-i", "hello world the quick", "-n", "40",
            "-T", str(WINDOW)]
    assert jax_harness.main(args + ["--matmul", impls[0]]) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "-t", "f16", "--compute", "f32",
                                     "--matmul", impls[1]]) == 0
    got = capsys.readouterr().out
    path = "perlayer" if impls[1] == "kernel" else "xla"
    assert f"decode path: {path}" in got and "tok/s" in got
    assert _generated_text(got) == _generated_text(want)
    assert _generated_text(got)[0].startswith("hello world the quick")
    active = [ln for ln in got.splitlines() if ln.startswith("active bytes")]
    assert active == [ln for ln in want.splitlines() if ln.startswith("active bytes")]


def _value(out: str, key: str) -> float:
    line = next(ln for ln in out.splitlines() if ln.strip().startswith(key))
    return float(line.split(key)[1].split()[0])


def test_harness_perplexity_and_passkey_match_jax(containers, capsys):
    """Perplexity (through two ring wraps of a 16-slot window) within 1e-3
    relative of the JAX harness; passkey: the same prompt, passkey, answer
    and verdict."""
    text = "the quick brown fox jumps over the lazy dog and the pass key is here " * 3
    args = [containers["i8"], "-m", "perplexity", "-i", text, "-T", str(WINDOW)]
    assert jax_harness.main(args + ["--matmul", "pallas", "-t", "f32"]) == 0
    want = _value(capsys.readouterr().out, "perplexity:")
    assert port_harness.main(args + ["-d", "cpu", "-t", "f32", "--compute", "f32"]) == 0
    got = _value(capsys.readouterr().out, "perplexity:")
    assert abs(got - want) / want < 1e-3
    args = [containers["i8"], "-m", "passkey", "-n", "12", "-T", "64", "--seed", "5", "-t", "f32"]
    rc_want = jax_harness.main(args + ["--matmul", "pallas"])
    want = capsys.readouterr().out
    rc_got = port_harness.main(args + ["-d", "cpu", "--compute", "f32"])
    got = capsys.readouterr().out
    keys = ("prompt:", "passkey:", "passkey position:", "model answer:", "retrieval:")
    lines = [[ln.split("(")[0] for ln in o.splitlines() if ln.strip().startswith(keys)]
             for o in (got, want)]
    assert rc_got == rc_want and lines[0] == lines[1] and len(lines[0]) == 5
    assert "decode path: perlayer" in got


# ---- the q8 experts: the reference's two paths disagree


def test_q8_experts_scale_on_both_paths(containers):
    """q8 experts (int8 without row scales) take the fixed 1/100 scale on
    the JAX gathered path (pallas_qmatmul_stacked_multi) but not on its
    dense-masked path (llama.py ``_expert_mat`` drops it), so the JAX
    package's two paths disagree on a q8 Mixtral. The port applies 1/100 on
    both: its dense and gathered decode agree with each other and with the
    JAX gathered path."""
    ref, port = _pair(containers["q8"])
    ref_dense, dense = _pair(containers["q8"], jax_impl="xla", port_impl="xla")
    caches = [e.new_cache(1) for e in (ref, port, ref_dense, dense)]
    gap = 0.0
    for i, tok in enumerate(TOKENS[:6]):
        pos = np.array([i], np.int32)
        outs = []
        for j, e in enumerate((ref, port, ref_dense, dense)):
            lg, caches[j] = e.decode(np.array([tok]), pos, caches[j])
            outs.append(np.asarray(lg))
        np.testing.assert_allclose(outs[1], outs[0], **I8_TOL)
        np.testing.assert_allclose(outs[3], outs[1], **DENSE_I8_TOL)
        gap = max(gap, float(np.abs(outs[2] - outs[0]).max()))
    assert gap > 1.0  # the JAX dense path, unscaled, is off (by 2.3-3.5 on logits of max 2.5)
