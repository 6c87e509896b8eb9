"""Multi-step decode without a host round trip per token: the port's
``Engine.decode_scan``, ``generate(segment=)``, scanned ``perplexity`` and
``cache.step_inputs`` against the JAX package on the CPU, where the port's
scans run their steps eagerly (the kernels' plain versions), tiny models
(``tests/make_tiny_model.py``; a dense one and a 4-expert Mixtral), a
16-slot window and at least one ring wrap.

Tolerances: the tokens of a greedy scan must be identical; the cache
planes of the active row within 2e-3 of the plane's max |JAX| for an f32
cache (the bar of tests/test_torch_engine.py: f32 sums in another order,
an f32 ulp upstream flipping one bf16 rounding of an activation before an
i8 matmul), 4e-3 for f16 (one f16 rounding flipped, 2^-10 relative) and
3e-2 dequantised for int8 (the bar of tests/test_torch_kvq.py: a code one
count apart, 1/127 of its row); the inactive row's window rows are
compared exactly with their state before the scan (its dropped write lands
in the sentinel row S of the physical padding, which nothing attends). Perplexity within 1e-3 (ppl) and
1e-2 (stderr), the bars of ``test_perplexity_matches``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from tests.test_mixtral import MIXTRAL_OVERRIDES
from xalm_tpu.convert import convert as cvt
from xalm_tpu.runtime.cache import ring_indices as jax_ring_indices
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.runtime import engine as port_engine
from xalm_tpu_torch.runtime.cache import step_inputs
from xalm_tpu_torch.runtime.engine import Engine

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

WINDOW = 16
STEPS = 2 * WINDOW + 8  # from pos 10: wraps at 16 and 30, the sinks re-rotating
CACHES = {"f32": (jnp.float32, torch.float32, 2e-3), "f16": (jnp.float16, torch.float16, 4e-3),
          "i8": (jnp.int8, torch.int8, 3e-2)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    out = {}
    for name, over in (("dense", None), ("moe", MIXTRAL_OVERRIDES)):
        hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / name), config_overrides=over)
        out[name] = str(tmp_path_factory.mktemp("x") / f"{name}_i8.xalm")
        assert cvt.main(["--input", hf, "--output", out[name], "--type", "i8"]) == 0
    return out


def _pair(path, cache: str, jax_kw: dict, port_kw: dict):
    """The JAX and the port engine, built once a module per arguments (the
    JAX engine's jitted functions compile once)."""
    return _engines(path, cache, tuple(sorted(jax_kw.items())), tuple(sorted(port_kw.items())))


@functools.lru_cache(maxsize=None)
def _engines(path, cache, jax_kw, port_kw):
    jdt, tdt, _ = CACHES[cache]
    ref = JaxEngine.from_xalm(path, context=WINDOW, kv_dtype=jdt, compute_dtype=jnp.float32,
                              progress=False, **dict(jax_kw))
    port = Engine.from_xalm(path, context=WINDOW, kv_dtype=tdt, compute_dtype=torch.float32,
                            device="cpu", **dict(port_kw))
    return ref, port


def _planes(cache) -> list[np.ndarray]:
    """The cache's values as f32 (an int8 cache dequantised)."""
    if getattr(cache, "k_scale", None) is None:
        return [np.asarray(cache.k, np.float32), np.asarray(cache.v, np.float32)]
    return [np.asarray(c, np.float32) * np.asarray(s, np.float32)[..., None]
            for c, s in ((cache.k, cache.k_scale), (cache.v, cache.v_scale))]


def _scan_case(ref, port, batch: int, tol: float):
    """Prefill a 10-token chunk into each row, then decode_scan STEPS
    steps; at B = 2 row 1 is inactive (``valid`` False)."""
    rng = np.random.default_rng(7)
    prompt = rng.integers(3, 350, size=(batch, 10))
    zeros = np.zeros(batch, np.int32)
    _, cr = ref.step(prompt.astype(np.int32), zeros, ref.new_cache(batch), None,
                     logits_mode="none")
    _, cp = port.step(prompt, zeros, port.new_cache(batch), None, logits_mode="none")
    valid = None if batch == 1 else np.array([True, False])
    first = rng.integers(3, 350, size=batch).astype(np.int32)
    pos = np.full(batch, 10, np.int32)
    # the inactive row's window rows [0, S); its write goes to the sentinel
    # row S of the physical padding, which nothing attends (KVCache.plane_shape)
    rows = (slice(None), slice(1, None), slice(None), slice(0, WINDOW))
    before = [t[rows].clone() for t in cp.planes()]
    want, cr = ref.decode_scan(first, pos, cr, STEPS, valid=valid)
    got, cp = port.decode_scan(first, pos, cp, STEPS, valid=valid)
    assert got.dtype == torch.int32 and tuple(got.shape) == (batch, STEPS)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want)[0])
    for g, w in zip(_planes(cp), _planes(cr)):
        live = (slice(None), 0, slice(None), slice(0, WINDOW))
        assert np.abs(g[live] - w[live]).max() <= tol * np.abs(w[live]).max()
    if batch == 2:  # the inactive row neither wrote nor rotated its sinks
        assert all(torch.equal(b, a[rows]) for b, a in zip(before, cp.planes()))


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("model", ["dense", "moe"])
def test_decode_scan_matches_jax_reference_path(models, model, cache, batch):
    """Both packages' reference path ("xla"): every cache, dense and MoE,
    B = 1 and B = 2 with an inactive row, through two ring wraps."""
    ref, port = _pair(models[model], cache, dict(matmul_impl="xla"), dict(matmul_impl="xla"))
    _scan_case(ref, port, batch, CACHES[cache][2])


KERNEL_CASES = [("dense", "f32", 2, True), ("dense", "i8", 2, True), ("dense", "f32", 2, False),
                ("dense", "i8", 1, False), ("moe", "f32", 1, False)]


@pytest.mark.parametrize("model,cache,batch,fused", KERNEL_CASES)
def test_decode_scan_matches_jax_kernel_path(models, model, cache, batch, fused):
    """The port's kernel path (plain versions on the CPU) against the JAX
    "pallas" path (interpret mode): the megakernel step (``fused``) and the
    per-layer step, the MoE one gathering its experts at B = 1."""
    fs = dict(fused_step=fused)
    ref, port = _pair(models[model], cache, dict(matmul_impl="pallas", **fs), fs)
    assert ref.decode_path(batch) == port.decode_path(batch) == (
        "megakernel" if fused else "perlayer")
    _scan_case(ref, port, batch, CACHES[cache][2])


@pytest.mark.parametrize("segment", [1, 4, 16])
@pytest.mark.parametrize("model", ["dense", "moe"])
def test_generate_segments_match_jax(models, model, segment):
    """generate at segment 1, 4 and 16 gives JAX's tokens, through wraps."""
    ref, port = _pair(models[model], "f32", dict(matmul_impl="xla"), dict(matmul_impl="xla"))
    prompt = [1, 259, 260, 10, 20, 300, 5]
    want, _ = ref.generate(prompt, 3 * WINDOW, stop_on_eos=False, segment=segment)
    got, stats = port.generate(prompt, 3 * WINDOW, stop_on_eos=False, segment=segment)
    assert got == want and len(got) == 3 * WINDOW
    assert stats.generated_tokens == len(got) and stats.active_bytes > 0


@pytest.mark.parametrize("segment", [1, 4, 16])
def test_generate_stops_on_eos_inside_a_segment(models, segment, monkeypatch):
    """With the greedy run's 6th token taken as EOS, both engines stop
    there, at every segment: the scan's tokens past it are dropped."""
    ref, port = _pair(models["dense"], "f32", dict(matmul_impl="xla"), dict(matmul_impl="xla"))
    prompt = [1, 259, 260, 10, 20, 300, 5]
    free, _ = port.generate(prompt, 40, stop_on_eos=False, segment=segment)
    eos = free[5]
    stop = free.index(eos) + 1
    for eng in (ref, port):
        monkeypatch.setattr(eng.tokenizer, "eos_id", eos)
    want, _ = ref.generate(prompt, 40, segment=segment)
    got, stats = port.generate(prompt, 40, segment=segment)
    assert got == want == free[:stop]
    assert stats.generated_tokens == stop


def test_generate_replays_on_the_engine_cache(models):
    """A second generate reuses the engine's zeroed cache and its scan:
    the same tokens, no new scan built."""
    port = Engine.from_xalm(models["dense"], context=WINDOW, device="cpu")
    first, _ = port.generate([1, 259, 260], 20, stop_on_eos=False, segment=4)
    scans = dict(port._graphs)
    again, _ = port.generate([1, 259, 260], 20, stop_on_eos=False, segment=4)
    assert again == first and port._graphs.keys() == scans.keys()
    assert all(port._graphs[k] is scans[k] for k in scans)


@pytest.mark.parametrize("cache", ["f32", "i8"])
def test_scanned_perplexity_matches_jax(models, cache):
    """3 windows + 5 tokens: the tail after the window in _ppl_scan
    segments, against JAX's scanned perplexity."""
    jax_kw = dict(matmul_impl="pallas", fused_step=False)
    ref, port = _pair(models["dense"], cache, jax_kw, dict(fused_step=False))
    toks = np.random.default_rng(2).integers(3, 350, size=3 * WINDOW + 5).tolist()
    p_ref, e_ref, n_ref = ref.perplexity(toks)
    p_port, e_port, n_port = port.perplexity(toks)
    assert n_port == n_ref == len(toks) - 1
    assert abs(p_port - p_ref) / p_ref < 1e-3
    assert abs(e_port - e_ref) / e_ref < 1e-2


def test_ppl_scan_equals_per_token_logprobs(models):
    """The scanned log-probs equal those of eager steps, bit for bit."""
    port = Engine.from_xalm(models["dense"], context=WINDOW, device="cpu")
    toks = np.random.default_rng(5).integers(3, 350, size=30).astype(np.int32)
    c1 = port.new_cache(1)
    _, c1, pos = port.prefill(toks[:WINDOW].tolist(), c1)
    c2 = port.new_cache(1)
    _, c2, _ = port.prefill(toks[:WINDOW].tolist(), c2)
    lps, _ = port._ppl_scan(toks[None, pos:-1], toks[None, pos + 1:], np.array([pos]), c1)
    for i in range(len(toks) - 1 - pos):
        logits, c2 = port.decode(toks[pos + i:pos + i + 1], np.array([pos + i], np.int32), c2)
        want = torch.log_softmax(logits.float(), -1)[0, toks[pos + i + 1]]
        assert torch.equal(lps[0, i], want), i


@pytest.mark.parametrize("valid", [True, False])
@pytest.mark.parametrize("window", [16, 48])
def test_step_inputs_equal_ring_indices(window, valid):
    """For every pos in [0, 3S): kv_pos and kv_len of the JAX
    ``ring_indices``, kv_pos at the sentinel S for an invalid row, rotate
    where the ring has wrapped and the row is valid."""
    pos = np.arange(3 * window, dtype=np.int32)
    _, jpos, jlen = (np.asarray(a) for a in jax_ring_indices(jnp.asarray(pos), window))
    v = torch.full((pos.size,), valid)
    kv_pos, kv_len, rotate = step_inputs(torch.from_numpy(pos), window, v)
    assert kv_pos.dtype == kv_len.dtype == rotate.dtype == torch.int32
    np.testing.assert_array_equal(kv_pos.numpy(), jpos if valid else np.full_like(pos, window))
    np.testing.assert_array_equal(kv_len.numpy(), jlen)
    np.testing.assert_array_equal(rotate.numpy(), ((pos >= window) & valid).astype(np.int32))
    if valid:  # no mask: the same as an all-valid one
        assert all(torch.equal(a, b) for a, b in zip(step_inputs(torch.from_numpy(pos), window),
                                                     (kv_pos, kv_len, rotate)))


def _schedule(eng, n: int, torch_side: bool, monkeypatch) -> list[tuple[int, int]]:
    """The (pos, width) chunks ``prefill`` runs for an n-token prompt, with
    the forward stubbed out (zeros of the right shape); the JAX engine's
    scanned leading chunks count one (pos, 512) entry each."""
    calls = []
    vocab = eng.cfg.vocab_size

    def step(tokens, pos, cache, valid=None, logits_mode="last"):
        t = np.asarray(tokens).shape[1]
        calls.append((int(np.asarray(pos)[0]), t))
        shape = {"last": (1, vocab), "all": (1, t, vocab)}.get(logits_mode)
        if shape is None:
            return None, cache
        return (torch.zeros(shape) if torch_side else jnp.zeros(shape)), cache

    def chunks(params, toks, pos0, cache):
        c, _, ch = toks.shape
        calls.extend((int(pos0[0]) + i * ch, ch) for i in range(c))
        return cache

    monkeypatch.setattr(eng, "step", step)
    if not torch_side:
        monkeypatch.setattr(eng, "_prefill_chunks", chunks)
    eng.prefill(list(range(3, 3 + n)), None)
    return calls


@pytest.mark.parametrize("n", [5, 512, 513, 1100, 1600, 2100, 3000])
def test_prefill_chunk_schedule_is_jax(models, n, monkeypatch):
    """The port's prefill chunks are the JAX engine's, its scanned leading
    full chunks (``_prefill_chunks``) included, at a 2048-token window."""
    ref = JaxEngine.from_xalm(models["dense"], context=2048, progress=False)
    port = Engine.from_xalm(models["dense"], context=2048, device="cpu")
    assert _schedule(port, n, True, monkeypatch) == _schedule(ref, n, False, monkeypatch)


def test_scan_graphs_are_bounded(models):
    """decode_scan over more caches than the engine keeps captures for
    drops the least recently used one."""
    port = Engine.from_xalm(models["dense"], context=WINDOW, device="cpu")
    caches = [port.new_cache(1) for _ in range(port_engine._MAX_GRAPHS + 2)]
    for c in caches:
        port.decode_scan(np.array([5]), np.array([0]), c, 2)
    assert len(port._graphs) == port_engine._MAX_GRAPHS
    kept = {k[0] for k in port._graphs}
    assert tuple(t.data_ptr() for t in caches[-1].planes()) in kept
    assert tuple(t.data_ptr() for t in caches[0].planes()) not in kept
