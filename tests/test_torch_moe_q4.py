"""Packed-q4 experts (Mixtral q4) in the port, against the JAX package on
the CPU:

(a) ``qmatmul_multi_plain(q4_group=)`` (what ``qmatmul_multi`` runs on CPU
    tensors) against ``pallas_qmatmul_stacked_multi(q4_group=)`` in
    interpret mode, x shared by the experts and one row group per expert,
    groups 128 and 256; x's codes bit-equal to the wrapper's own lines;
(b) the engines on a tiny Mixtral 256 wide (4 experts, 2 active): an i8
    container recoded at load (``from_xalm(q4_group=128)``, q4 experts and
    attention) on the gathered route (``a8_decode``, which the recode
    implies) and on the dense-masked one (without it), and a JAX-converted
    ``--type q4`` container (q4 attention, i8 experts): prefill and decode
    logits, greedy tokens, ``active_bytes`` and ``decode_path``;
(c) the harness's ``--q4 128`` against the JAX harness.

q4 needs K/2 to be a multiple of the group, hence 256 wide where
``tests/test_torch_moe.py``'s Mixtral is 64 (as ``tests/test_q4.py``'s q4
MoE tests widen theirs).

Tolerances, each with its reason:

- (a) the codes bit-equal; the outputs within 1e-5 of each output row's
  max, the bar of ``tests/test_torch_q4.py::test_q4_matmul_matches_jax``:
  the group dots are exact on both sides, but XLA on the CPU may fuse a
  group's scale multiply and the running sum into one FMA, which the port
  rounds separately;
- (b) gathered: logits within 3e-2 of max |logits| (``test_torch_q4.py``'s
  engine bar: both sides quantise the same f32 rows, but the sums upstream
  run in another order, so a rare code lands one count apart); dense-masked
  (f32 compute, q4 dequantised in f32 on both sides, exact products summed
  in another order): 1e-4 of max |logits|; the ``--type q4`` container's
  gathered i8 experts 2e-3 (``tests/test_torch_moe.py``'s i8 bar: x is
  rounded to bf16 before each gathered i8 matmul on both sides, and an f32
  ulp upstream can flip one such rounding); greedy tokens identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from tests.test_mixtral import MIXTRAL_OVERRIDES
from xalm_tpu.convert import convert as cvt
from xalm_tpu.harness import main as jax_harness
from xalm_tpu.ops.pallas_matmul import pallas_qmatmul_stacked_multi
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.ops import qmatmul as qmm
from xalm_tpu_torch.ops.attention import quant_rows
from xalm_tpu_torch.runtime.engine import Engine

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

WIDE_MOE = dict(MIXTRAL_OVERRIDES, hidden_size=256, intermediate_size=512, num_attention_heads=4,
                num_key_value_heads=2, head_dim=64, vocab_size=512)
WINDOW = 32
Q4_TOL = 1e-5  # of each output row's max
GATHER_TOL = 3e-2  # of max |logits|
DENSE_TOL = 1e-4  # of max |logits|
I8_TOL = 2e-3  # of max |logits|


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _row_rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max(axis=-1)
    return float((err / np.maximum(np.abs(want).max(axis=-1), 1e-30)).max())


# ---- (a) the gathered q4 expert matmul


@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("shared_x", [True, False])
@pytest.mark.parametrize("m", [1, 3])
def test_qmatmul_multi_q4_matches_pallas(group, shared_x, m):
    rng = np.random.default_rng(group + 2 * m + shared_x)
    le, d, n = 8, 96, 1024  # 2 layers x 4 experts
    packed = rng.integers(-128, 128, size=(le, d, n // 2)).astype(np.int8)
    scale = (rng.random((le, d, n // group)) * 0.01 + 0.001).astype(np.float32)
    idxs = np.array([1 * 4 + 3, 1 * 4 + 0], np.int32)  # the last layer's experts 3 and 0
    k = len(idxs)
    x = (rng.normal(size=(m if shared_x else k * m, n)) * 2).astype(np.float32)
    x[0, :3] = [127.0, 63.5, -0.5]  # a row whose scale is exactly 1: ties at .5
    want = np.asarray(pallas_qmatmul_stacked_multi(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale), jnp.asarray(idxs),
        q4_group=group, shared_x=shared_x))
    got = qmm.qmatmul_multi(torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(scale),
                            torch.from_numpy(idxs), shared_x=shared_x, q4_group=group).numpy()
    assert got.shape == want.shape == (k * m, d)
    assert _row_rel(got, want) <= Q4_TOL
    # x's codes: the wrapper's lines (pallas_matmul.py :350-355), each row on its own
    amax = jnp.max(jnp.abs(jnp.asarray(x)), axis=-1, keepdims=True)
    sx = jnp.where(amax > 0, amax / 127.0, 1.0)
    codes = jnp.clip(jnp.round(jnp.asarray(x) / sx), -127, 127).astype(jnp.int8)
    xq, s = quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sx)[:, 0])


def test_qmatmul_multi_q4_refuses_what_the_reference_refuses():
    packed = torch.zeros((4, 16, 128), dtype=torch.int8)
    scale = torch.ones((4, 16, 2))
    idxs = torch.tensor([0, 1], dtype=torch.int32)
    x = torch.ones((1, 256))
    with pytest.raises(ValueError, match="q4 group"):
        qmm.qmatmul_multi_plain(x, packed, scale, idxs, q4_group=64)
    with pytest.raises(ValueError, match="group scales"):
        qmm.qmatmul_multi_plain(x, packed, scale[..., :1], idxs, q4_group=128)
    with pytest.raises(ValueError, match="int8 values"):
        qmm.qmatmul_multi_plain(x, packed.float(), scale, idxs, q4_group=128)
    with pytest.raises(ValueError, match="decode shapes"):
        qmm.qmatmul_multi_plain(torch.ones((256, 256)), packed, scale, idxs, q4_group=128)


# ---- (b) the engines


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "wide_mixtral"),
                         config_overrides=WIDE_MOE)
    d = tmp_path_factory.mktemp("x")
    out = {}
    for t in ("i8", "q4"):
        out[t] = str(d / f"wide_mx_{t}.xalm")
        assert cvt.main(["--input", hf, "--output", out[t], "--type", t]) == 0
    return out


@pytest.fixture
def count_multi(monkeypatch):
    """Calls of qmatmul_multi's plain version by expert format (q4 or not)."""
    calls = {"q4": 0, "other": 0}
    plain = qmm.qmatmul_multi_plain

    def counted(*args, **kw):
        calls["q4" if kw.get("q4_group") else "other"] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(qmm, "qmatmul_multi_plain", counted)
    return calls


def _engines(path, q4_group=0, a8_decode=None):
    """(JAX "pallas" engine, port kernel-path engine) on the CPU, f32 cache
    and compute; ``a8_decode`` False rebuilds both on the loaded params
    without it (``from_xalm(q4_group=)`` turns it on)."""
    ref = JaxEngine.from_xalm(path, context=WINDOW, matmul_impl="pallas", kv_dtype=jnp.float32,
                              compute_dtype=jnp.float32, q4_group=q4_group, progress=False)
    port = Engine.from_xalm(path, context=WINDOW, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, q4_group=q4_group, device="cpu")
    if a8_decode is False:
        ref = JaxEngine(ref.cfg, ref.params, ref.tokenizer, matmul_impl="pallas",
                        kv_dtype=jnp.float32, compute_dtype=jnp.float32)
        port = Engine(port.cfg, port.params, port.tokenizer, kv_dtype=torch.float32,
                      compute_dtype=torch.float32)
    return ref, port


# (container, q4_group at load, a8_decode, decode path, gathered expert calls
# per decode step (w13 and w2 of 2 layers): q4, other; tolerance)
ENGINE_CASES = {
    "recoded-gathered": ("i8", 128, None, "perlayer", (4, 0), GATHER_TOL),
    "recoded-dense": ("i8", 128, False, "xla", (0, 0), DENSE_TOL),
    "q4-container": ("q4", 0, None, "xla", (0, 4), I8_TOL),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_q4_mixtral_engines_match_jax(containers, count_multi, case):
    """Prefill logits (every chunk dense-masked), 8 decode steps and the
    greedy tokens against the JAX engine, the experts on the route the JAX
    gate gives them (``xalm_tpu/models/llama.py:846-854``)."""
    tname, group, a8, path, per_step, tol = ENGINE_CASES[case]
    ref, port = _engines(containers[tname], group, a8)
    lw = port.params.layers
    assert (lw.w13e.q4group, lw.w2e.q4group) == ((group, group) if group else (0, 0))
    assert lw.wqkv.q4group == (group or 128)  # --type q4 keeps the experts i8
    assert port.decode_path(1) == ref.decode_path(1) == path
    for pos in (0, 7, WINDOW, 100):
        assert port.active_bytes(pos) == ref.active_bytes(pos)
    prompt = np.random.default_rng(3).integers(3, 500, size=9).tolist()
    lr, cr, pos = ref.prefill(prompt, ref.new_cache(1), logits_mode="all")
    lp, cp, _ = port.prefill(prompt, port.new_cache(1), logits_mode="all")
    assert _rel(lp, lr) <= tol
    assert count_multi["q4"] == count_multi["other"] == 0  # a prefill chunk never gathers
    toks = np.random.default_rng(4).integers(3, 500, size=8)
    for i, tok in enumerate(toks):
        p = np.array([pos + i], np.int32)
        lr, cr = ref.decode(np.array([tok]), p, cr)
        lp, cp = port.decode(np.array([tok]), p, cp)
        assert _rel(lp.numpy(), lr) <= tol, f"step {i}"
    assert (count_multi["q4"], count_multi["other"]) == tuple(c * len(toks) for c in per_step)
    want, _ = ref.generate(prompt, 12, stop_on_eos=False)
    got, _ = port.generate(prompt, 12, stop_on_eos=False)
    assert got == want


def test_gathered_and_dense_q4_experts_agree(containers):
    """On the same q4 params the port's two routes differ only by the int8
    activations of the gathered one (``tests/test_q4.py``'s own check): each
    matmul's input rows rounded to 1/254 of their max, through 2 layers,
    moved the logits by 2.4e-2 of their max here; the bound is 5e-2."""
    _, gathered = _engines(containers["i8"], 128)
    dense = Engine(gathered.cfg, gathered.params, kv_dtype=torch.float32,
                   compute_dtype=torch.float32, a8_decode=True, matmul_impl="xla")
    assert dense.decode_path(1) == "xla"
    cg, cd = gathered.new_cache(1), dense.new_cache(1)
    for i, tok in enumerate(np.random.default_rng(11).integers(3, 500, size=6)):
        lg, cg = gathered.decode(np.array([tok]), np.array([i], np.int32), cg)
        ld, cd = dense.decode(np.array([tok]), np.array([i], np.int32), cd)
        assert _rel(lg.numpy(), ld.numpy()) <= 5e-2
        assert int(lg.argmax()) == int(ld.argmax())


# ---- (c) the harness


def _generated_text(out: str) -> list[str]:
    return out.split("Generation stats")[0].split("Encoding stats")[-1].splitlines()[1:]


def test_harness_q4_mixtral_identical_to_jax(containers, capsys):
    """``--q4 128`` on the i8 Mixtral: the completion text and the
    active-bytes line equal the JAX harness's, on the gathered q4 route."""
    args = [containers["i8"], "-m", "c", "-i", "hello world the quick", "-n", "16",
            "-T", str(WINDOW), "--q4", "128", "-t", "f32"]
    assert jax_harness.main(args + ["--matmul", "pallas"]) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "--compute", "f32"]) == 0
    got = capsys.readouterr().out
    assert "decode path: perlayer" in got
    assert _generated_text(got) == _generated_text(want)
    active = [ln for ln in got.splitlines() if ln.startswith("active bytes")]
    assert active and active == [ln for ln in want.splitlines() if ln.startswith("active bytes")]
