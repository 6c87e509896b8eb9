"""The whole slice: the port's Engine on the CPU against the JAX Engine on
the same i8 container, on the JAX package's per-layer Pallas path
(``matmul_impl="pallas", fused_step=False``; kernels in interpret mode),
f32 cache and f32 compute, through 3 ring wraps of a 16-slot window.

Tolerance on logits: 2e-3 (rtol and atol). Both sides cast activations to
bf16 in the i8 matmuls and multiply exact products in f32; what differs is
the f32 summation order and the last bit of transcendental functions (cos,
sin, exp, rsqrt), which a 2-layer model carries to ~1e-5; greedy tokens
must be identical and perplexity within 1e-3 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu.harness import main as jax_harness
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.runtime.engine import Engine, auto_kv_dtype

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

WINDOW = 16
TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def tiny_i8(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny_i8.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    return out


@pytest.fixture(scope="module")
def engines(tiny_i8):
    ref = JaxEngine.from_xalm(
        tiny_i8, context=WINDOW, matmul_impl="pallas", fused_step=False,
        kv_dtype=jnp.float32, compute_dtype=jnp.float32, progress=False,
    )
    port = Engine.from_xalm(
        tiny_i8, context=WINDOW, matmul_impl="kernel", fused_step=False,
        kv_dtype=torch.float32, compute_dtype=torch.float32, device="cpu",
    )
    return ref, port


def test_decode_path(engines):
    ref, port = engines
    assert ref.decode_path(1) == port.decode_path(1) == "perlayer"


def test_logits_and_cache_match_through_three_wraps(engines):
    """A padded (masked) prefill chunk, then teacher-forced decode from pos 10
    to pos 54: the ring wraps at 16, 30 and 44 and the sinks rotate."""
    ref, port = engines
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, 350, size=10).tolist()
    lr, cr, pr = ref.prefill(prompt, ref.new_cache(1), logits_mode="last")
    lp, cp, pp = port.prefill(prompt, port.new_cache(1), logits_mode="last")
    assert pr == pp == len(prompt)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **TOL)
    for i, tok in enumerate(rng.integers(3, 350, size=3 * (WINDOW - 2) + 3).tolist()):
        pos = np.array([len(prompt) + i], np.int32)
        lr, cr = ref.decode(np.array([tok]), pos, cr)
        lp, cp = port.decode(np.array([tok]), pos, cp)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **TOL, err_msg=f"pos {pos[0]}")
    assert pos[0] >= WINDOW + 2 * (WINDOW - 2)  # three wraps
    # cache planes, padding rows included (ring layout + rotated sinks)
    np.testing.assert_allclose(cp.k.numpy(), np.asarray(cr.k), **TOL)
    np.testing.assert_allclose(cp.v.numpy(), np.asarray(cr.v), **TOL)


def test_prefill_all_logits_match(engines):
    ref, port = engines
    toks = np.random.default_rng(1).integers(3, 350, size=WINDOW - 3).tolist()
    lr, _, _ = ref.prefill(toks, ref.new_cache(1), logits_mode="all")
    lp, _, _ = port.prefill(toks, port.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(lp, np.asarray(lr), **TOL)


def test_generate_tokens_identical(engines):
    ref, port = engines
    prompt = [1, 259, 260, 10, 20, 300, 5]
    want, _ = ref.generate(prompt, 3 * WINDOW, stop_on_eos=False)
    got, stats = port.generate(prompt, 3 * WINDOW, stop_on_eos=False)
    assert got == want
    assert stats.generated_tokens == len(want) and stats.active_bytes > 0


def test_perplexity_matches(engines):
    ref, port = engines
    toks = np.random.default_rng(2).integers(3, 350, size=3 * WINDOW + 5).tolist()
    p_ref, e_ref, n_ref = ref.perplexity(toks)
    p_port, e_port, n_port = port.perplexity(toks)
    assert n_port == n_ref == len(toks) - 1
    assert abs(p_port - p_ref) / p_ref < 1e-3
    assert abs(e_port - e_ref) / e_ref < 1e-2


def test_active_bytes_match(engines):
    ref, port = engines
    for pos in (0, 5, WINDOW, 100):
        assert port.active_bytes(pos) == ref.active_bytes(pos)


def _generated_text(out: str) -> list[str]:
    return out.split("Generation stats")[0].split("Encoding stats")[-1].splitlines()[1:]


def test_harness_completion_identical_to_jax(tiny_i8, capsys):
    args = [tiny_i8, "-m", "c", "-i", "hello world the quick", "-n", "40", "-T", str(WINDOW)]
    assert jax_harness.main(args + ["--matmul", "xla"]) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "-t", "f16", "--compute", "f32",
                                     "--matmul", "xla"]) == 0
    got = capsys.readouterr().out
    assert "decode path: xla" in got and "tok/s" in got
    assert _generated_text(got) == _generated_text(want)
    assert _generated_text(got)[0].startswith("hello world the quick")


def test_harness_perplexity_and_refusals(tiny_i8, capsys):
    assert port_harness.main([tiny_i8, "-d", "cpu", "-m", "perplexity",
                              "-i", "the quick brown fox is here"]) == 0
    assert "perplexity:" in capsys.readouterr().out
    for extra in (["--dp", "2"], ["--tp", "2"]):
        with pytest.raises(SystemExit):
            port_harness.main([tiny_i8, "-d", "cpu", "-i", "x"] + extra)


def test_harness_spec_prints_the_greedy_text(tiny_i8, capsys):
    """--spec 4 (n-gram drafts) and --spec 4 --draft (the same model as the
    draft) print the greedy run's text, and the speculation line."""
    args = [tiny_i8, "-d", "cpu", "-i", "hello world hello world hello", "-n", "24",
            "-T", str(WINDOW)]
    assert port_harness.main(args) == 0
    want = _generated_text(capsys.readouterr().out)
    for extra in (["--spec", "4"], ["--spec", "4", "--draft", tiny_i8]):
        assert port_harness.main(args + extra) == 0
        out = capsys.readouterr().out
        assert _generated_text(out) == want
        assert "speculation:" in out and "drafts accepted" in out


def test_harness_session_run_twice_continues_the_text(tiny_i8, tmp_path, capsys):
    """--session PATH: the first run saves the cache and the history, the
    second resumes them and continues the text: the saved history is the
    engine's own run of the first prompt, the second prompt and the
    continuation from the first run's session."""
    from xalm_tpu_torch.runtime.session import load_session

    path = str(tmp_path / "s.xbk")
    args = [tiny_i8, "-d", "cpu", "-n", "10", "-T", str(WINDOW), "--session", path]
    assert port_harness.main(args + ["-i", "hello world"]) == 0
    assert "saved session to" in capsys.readouterr().out
    assert port_harness.main(args + ["-i", " again"]) == 0
    second = capsys.readouterr().out
    assert "resumed session" in second and "saved session to" in second

    eng = Engine.from_xalm(tiny_i8, context=WINDOW, device="cpu")
    tok = eng.tokenizer
    once, again = tok.encode("hello world"), tok.encode(" again", bos=False)
    out1, _, sess1 = eng.generate(once, 10, return_session=True)
    out2, _ = eng.generate(again, 10, resume=sess1)
    assert load_session(path, eng.cfg, device="cpu").tokens[0] == once + out1 + again + out2
    assert tok.decode(out2) in second


def test_harness_takes_top_k_and_top_p_greedily(tiny_i8, capsys):
    """--top-k and --top-p filter sampling only: with the default
    temperature 0 the run is greedy, the same text as without them (the JAX
    harness's rule, engine.py's top_k acting only when temperature > 0)."""
    args = [tiny_i8, "-d", "cpu", "-i", "hello world", "-n", "12", "-T", str(WINDOW)]
    assert port_harness.main(args) == 0
    want = _generated_text(capsys.readouterr().out)
    assert port_harness.main(args + ["--top-k", "40", "--top-p", "0.9"]) == 0
    assert _generated_text(capsys.readouterr().out) == want


def test_harness_matmul_pallas_is_the_kernel_path(tiny_i8, capsys):
    """--matmul pallas, the JAX harness's name for its kernel path, runs the
    port's kernel path: the same text and decode path as --matmul kernel."""
    args = [tiny_i8, "-d", "cpu", "-i", "the quick brown", "-n", "12", "-T", str(WINDOW)]
    outs = []
    for impl in ("pallas", "kernel"):
        assert port_harness.main(args + ["--matmul", impl]) == 0
        out = capsys.readouterr().out
        assert "decode path: perlayer" in out
        outs.append(_generated_text(out))
    assert outs[0] == outs[1]


REFUSED = {"tp": (["--tp", "2"], "--tp"),
           "coordinator": (["--coordinator", "localhost:1234"], "--coordinator"),
           "num-processes": (["--num-processes", "2"], "--num-processes"),
           "process-id": (["--process-id", "1"], "--process-id")}


@pytest.mark.parametrize("case", REFUSED)
def test_harness_refuses_flags_that_change_the_output(tiny_i8, case):
    """A JAX-harness flag of a later slice that would change the output is
    refused by name before the model loads."""
    extra, name = REFUSED[case]
    with pytest.raises(SystemExit, match=name):
        port_harness.main([tiny_i8, "-d", "cpu", "-i", "x"] + extra)


@pytest.mark.parametrize("device,want", [("cuda", torch.bfloat16), ("cpu", torch.float16)])
def test_harness_default_cache_dtype(device, want):
    """-t defaults to auto, which the engine resolves to a bf16 cache on the
    card (the kernels' type; the JAX harness's f16 would take the dense
    attention there) and f16 on the CPU."""
    args = port_harness._build_parser().parse_args(["m.xalm", "-d", device])
    assert args.kv_dtype == "auto"
    assert auto_kv_dtype(device) == want


def _lines(out: str, keys: tuple[str, ...]) -> list[str]:
    return [ln for ln in out.splitlines() if ln.strip().startswith(keys)]


def test_harness_i8_cache_completion_identical_to_jax(tiny_i8, capsys):
    """-t i8 (int8 codes with per-row scales) on the reference path of both
    harnesses: the same text through two ring wraps of the window."""
    args = [tiny_i8, "-m", "c", "-i", "hello world the quick", "-n", "40", "-T", str(WINDOW),
            "-t", "i8", "--matmul", "xla"]
    assert jax_harness.main(args) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "--compute", "f32"]) == 0
    got = capsys.readouterr().out
    assert "decode path: xla" in got
    assert _generated_text(got) == _generated_text(want)
    assert _lines(got, ("active bytes",)) == _lines(want, ("active bytes",))
    assert port_harness.main([tiny_i8, "-d", "cpu", "-t", "i8", "-i", "hello", "-n", "20"]) == 0
    assert "decode path: megakernel" in capsys.readouterr().out


@pytest.mark.parametrize("kv", ["f32", "i8"])
def test_harness_passkey_identical_to_jax(tiny_i8, capsys, kv):
    """-m passkey with -l and --seed: the same prompt, passkey, position,
    answer and verdict as the JAX harness, the ring wrapping many times
    (a 30-line prompt through a 64-slot window)."""
    args = [tiny_i8, "-m", "passkey", "-n", "30", "-T", "64", "--seed", "5", "-t", kv,
            "--matmul", "xla"]
    for extra in ([], ["-l", "3"]):
        rc_want = jax_harness.main(args + extra)
        want = capsys.readouterr().out
        rc_got = port_harness.main(args + extra + ["-d", "cpu", "--compute", "f32"])
        got = capsys.readouterr().out
        keys = ("prompt:", "passkey:", "passkey position:", "context window:", "model answer:",
                "retrieval:")
        assert rc_got == rc_want
        assert [ln.split("(")[0] for ln in _lines(got, keys)] == \
            [ln.split("(")[0] for ln in _lines(want, keys)]
        assert len(_lines(got, keys)) == 6 and int(_lines(got, ("prompt:",))[0].split()[1]) > 64
    assert "passkey position: 3/30" in got


def test_port_written_bf16_head_container_matches_jax(tmp_path):
    """A container the port writes (i8 body, bf16 embed and head, head_dim
    128): the port reads it, and its greedy tokens and logits match the JAX
    engine's per-layer Pallas path, bf16 head kernel included, through the
    ring wrap of a 48-slot window."""
    from tests.test_torch_cuda import write_port_container

    path = write_port_container(str(tmp_path / "port.xalm"))
    ref = JaxEngine.from_xalm(
        path, matmul_impl="pallas", fused_step=False, kv_dtype=jnp.float32,
        compute_dtype=jnp.float32, progress=False,
    )
    port = Engine.from_xalm(path, kv_dtype=torch.float32, compute_dtype=torch.float32,
                            device="cpu")
    assert port.params.wcls.values.dtype == torch.bfloat16
    prompt = port.tokenizer.encode("hello world")
    assert prompt == ref.tokenizer.encode("hello world")
    want, _ = ref.generate(prompt, 60, stop_on_eos=False)
    got, _ = port.generate(prompt, 60, stop_on_eos=False)
    assert got == want
    # the bf16 head rounds its normed input to bf16 on both sides: an f32
    # ulp of difference upstream flips some of those roundings (2^-8
    # relative each), so the logits agree to bf16 level, 1e-2
    lr, _, _ = ref.prefill(prompt, ref.new_cache(1), logits_mode="all")
    lp, _, _ = port.prefill(prompt, port.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(lp, np.asarray(lr), rtol=1e-2, atol=1e-2)


def test_port_harness_on_port_container(tmp_path, capsys):
    from tests.test_torch_cuda import write_port_container

    path = write_port_container(str(tmp_path / "port.xalm"))
    assert port_harness.main([path, "-d", "cpu", "-t", "bf16", "-i", "hello", "-n", "60"]) == 0
    out = capsys.readouterr().out
    assert "decode path: megakernel" in out and "60 tokens" in out


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_kernel_impl_routes_every_step_through_the_kernel_wrappers(monkeypatch, kv_dtype):
    """With matmul_impl="kernel" and a bf16 or f32 cache every prefill
    chunk goes through the flash-prefill wrapper, whatever its length (here
    a 199-row chunk at a 200-slot window), and, on the per-layer path
    (fused_step=False), every decode step through kv_update and
    flash-decode; the dense attention runs for "xla" only. An f16 cache,
    which no attention kernel takes (the JAX forward's
    ``supported_cache_dtype``), takes the dense attention on every chunk and
    step and never reaches the wrappers."""
    import dataclasses

    from xalm_tpu_torch.models import llama
    from xalm_tpu_torch.models.config import MISTRAL_7B
    from xalm_tpu_torch.ops import attention as A
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, dim=64, hidden_dim=128, n_layers=2, n_heads=4,
                              n_kv_heads=2, head_dim=16, rotary_dim=16, vocab_size=100,
                              max_seq_len=200)
    params = synthetic_params(cfg, device="cpu", seed=0)
    prompt = np.random.default_rng(3).integers(3, 100, size=199).tolist()
    calls = {"flash_prefill": 0, "kv_update": 0, "flash_decode": 0, "dense": 0}
    for name in ("flash_prefill", "kv_update", "flash_decode"):
        plain = getattr(A, name + "_plain")

        def counted(*args, _name=name, _plain=plain):
            calls[_name] += 1
            return _plain(*args)

        monkeypatch.setattr(A, name + "_plain", counted)
    f16 = kv_dtype == torch.float16
    attention = llama.attention

    def dense(*args, **kw):
        if not f16:
            raise AssertionError("the kernel path ran the dense attention")
        calls["dense"] += 1
        return attention(*args, **kw)

    monkeypatch.setattr(llama, "attention", dense)
    port = Engine(cfg, params, kv_dtype=kv_dtype, matmul_impl="kernel", fused_step=False)
    logits, cache, pos = port.prefill(prompt, port.new_cache(1))
    wrappers = lambda n: 0 if f16 else n  # noqa: E731
    assert pos == 199 and calls == {"flash_prefill": wrappers(2), "kv_update": 0,
                                    "flash_decode": 0, "dense": 2 - wrappers(2)}
    assert torch.isfinite(logits).all()
    for p in (199, 200, 201):  # the last two rotate the sinks of a wrapped ring
        logits, cache = port.decode(np.array([7]), np.array([p], np.int32), cache)
        assert torch.isfinite(logits).all()
    assert calls == {"flash_prefill": wrappers(2), "kv_update": wrappers(6),
                     "flash_decode": wrappers(6), "dense": 8 - wrappers(8)}
