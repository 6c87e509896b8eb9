"""Speculative decoding: the port's ``runtime/spec.py`` against the JAX
package's on the CPU (tiny i8 model, ``tests/make_tiny_model.py``; f32
compute, an f16 and an int8 cache), where every verify chunk runs eagerly
(the kernels' plain versions).

``generate_spec`` must give the JAX ``generate_spec``'s tokens exactly, the
same acceptance counters, and the port's own ``generate``'s tokens, with
n-gram drafts, oracle drafts (the greedy stream, monkeypatched in as
``tests/test_spec.py`` does) and a draft engine, before the wrap (the
model's 256-slot window) and wrapped (a 16-slot window: verify-then-commit).

The wrapped verify chunk and ``spec_commit`` run on the JAX cache's own
values. Tolerances: the argmax identical; the verify chunk's rows within
4e-3 of the plane's max |JAX| for an f16 cache (one f16 rounding flipped by
f32 sums in another order, 2^-10 relative) and dequantised within 3e-2 for
int8 (a code one count apart, 1/127 of its row: the bars of
tests/test_torch_decode_scan.py); the commit's scattered rows bit-equal
(the same stored rows written), the rotated sinks within one rounding of
the cache's type (f16: 2^-10 of the plane's max; int8 dequantised: 1/127)
after cos and sin that may differ in their last bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu.runtime import spec as jax_spec
from xalm_tpu.runtime.cache import KVCache as JaxKVCache
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.runtime import spec
from xalm_tpu_torch.runtime.cache import KVCache
from xalm_tpu_torch.runtime.engine import Engine

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

CACHES = {"f16": (jnp.float16, torch.float16, 4e-3), "i8": (jnp.int8, torch.int8, 3e-2)}
PROMPT = [1, 259, 260, 10, 20, 30]
N = 40  # tokens: at a 16-slot window most of them are generated wrapped
K = 4


@pytest.fixture(scope="module")
def tiny_i8(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny_i8.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    return out


@functools.lru_cache(maxsize=None)
def _engines(path: str, cache: str, window: int, impl: str = "xla"):
    """The JAX engine (its CPU default, the "xla" path) and the port's on
    ``impl``: "xla" runs the same arithmetic as the JAX engine, "kernel"
    the kernels' routing (on the CPU their plain versions, which round
    activations to bf16 before an i8 matmul as the kernels do)."""
    jdt, tdt, _ = CACHES[cache]
    ref = JaxEngine.from_xalm(path, context=window, kv_dtype=jdt, compute_dtype=jnp.float32,
                              progress=False)
    port = Engine.from_xalm(path, context=window, kv_dtype=tdt, compute_dtype=torch.float32,
                            matmul_impl=impl, device="cpu")
    return ref, port


def test_ngram_propose_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        ids = rng.integers(0, int(rng.integers(2, 8)), size=int(rng.integers(0, 40))).tolist()
        k, max_n = int(rng.integers(1, 9)), int(rng.integers(1, 5))
        assert spec.ngram_propose(ids, k, max_n=max_n) == jax_spec.ngram_propose(ids, k,
                                                                                 max_n=max_n)


def _drafts(drafter, ref, port, monkeypatch):
    """The (JAX, port) keyword arguments of a drafter; "oracle" patches the
    greedy stream in as both packages' n-gram proposer."""
    if drafter == "ngram":
        return {}, {}
    if drafter == "draft_engine":
        return (dict(draft_engine=JaxEngine(ref.cfg, ref.params, ref.tokenizer,
                                            kv_dtype=ref.kv_dtype, compute_dtype=jnp.float32)),
                dict(draft_engine=Engine(port.cfg, port.params, port.tokenizer,
                                         kv_dtype=port.kv_dtype, compute_dtype=torch.float32,
                                         matmul_impl=port.matmul_impl)))
    want, _ = port.generate(PROMPT, N, stop_on_eos=False, segment=1)

    def oracle(ids, kk, **kw):
        done = len(ids) - len(PROMPT)  # emitted so far, the pending token included
        return want[done:done + kk]

    monkeypatch.setattr(jax_spec, "ngram_propose", oracle)
    monkeypatch.setattr(spec, "ngram_propose", oracle)
    return {}, {}


@pytest.mark.parametrize("drafter", ["ngram", "oracle", "draft_engine"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("cache", sorted(CACHES))
def test_generate_spec_matches_jax_and_generate(tiny_i8, cache, window, drafter, monkeypatch):
    ref, port = _engines(tiny_i8, cache, window)
    jkw, pkw = _drafts(drafter, ref, port, monkeypatch)
    want, wstats = jax_spec.generate_spec(ref, PROMPT, N, k=K, stop_on_eos=False, **jkw)
    got, stats = spec.generate_spec(port, PROMPT, N, k=K, stop_on_eos=False, **pkw)
    plain, _ = port.generate(PROMPT, N, stop_on_eos=False, segment=1)
    assert got == want == plain
    assert (stats.spec_proposed, stats.spec_accepted) == (wstats.spec_proposed,
                                                           wstats.spec_accepted)
    assert stats.generated_tokens == N and stats.active_bytes == wstats.active_bytes
    if drafter == "oracle":  # the true continuation: accepted before and after the wrap
        assert stats.spec_accepted >= 16


@pytest.mark.parametrize("drafter", ["ngram", "oracle", "draft_engine"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("cache", sorted(CACHES))
def test_generate_spec_on_the_kernel_route_equals_generate(tiny_i8, cache, window, drafter,
                                                           monkeypatch):
    """The port's kernel route (the card's, its plain versions here): the
    spec run's tokens are its own ``generate``'s."""
    ref, port = _engines(tiny_i8, cache, window, "kernel")
    _, pkw = _drafts(drafter, ref, port, monkeypatch)
    got, stats = spec.generate_spec(port, PROMPT, N, k=K, stop_on_eos=False, **pkw)
    plain, _ = port.generate(PROMPT, N, stop_on_eos=False, segment=1)
    assert got == plain and stats.spec_proposed > 0


def test_generate_spec_stops_at_eos_like_generate(tiny_i8):
    """With EOS on, the spec run stops where ``generate`` does."""
    _, port = _engines(tiny_i8, "f16", 0)
    want, _ = port.generate(PROMPT, N, segment=1)
    got, _ = spec.generate_spec(port, PROMPT, N)
    assert got == want


def _wrapped_state(ref, port):
    """A JAX cache wrapped by decoding past the 16-slot window, the same
    values in a port cache, the pending token and its position."""
    cache = ref.new_cache(1)
    logits, cache, pos = ref.prefill(PROMPT, cache, logits_mode="last")
    token = int(np.asarray(jnp.argmax(logits[0], -1)))
    while pos < ref.cfg.max_seq_len + 5:
        logits, cache = ref.decode(np.array([token], np.int32), np.array([pos], np.int32), cache)
        token = int(np.asarray(jnp.argmax(logits[0], -1)))
        pos += 1
    planes = [torch.from_numpy(np.array(p)) for p in (cache.k, cache.v, cache.k_scale,
                                                       cache.v_scale) if p is not None]
    return cache, KVCache(*planes), token, pos


def _dequant(rows):
    if len(rows) == 2:
        return [np.asarray(r, np.float32) for r in rows]
    return [np.asarray(c, np.float32) * np.asarray(s, np.float32)[..., None]
            for c, s in ((rows[0], rows[2]), (rows[1], rows[3]))]


@pytest.mark.parametrize("cache", sorted(CACHES))
def test_wrapped_verify_writes_nothing_and_matches_jax(tiny_i8, cache):
    ref, port = _engines(tiny_i8, cache, 16)
    jcache, pcache, token, pos = _wrapped_state(ref, port)
    chunk = [token, 5, 6, 7, 8]
    before = [p.clone() for p in pcache.planes()]
    greedy, rows = port.verify(chunk, pos, pcache, wrapped=True)
    assert all(torch.equal(a, b) for a, b in zip(before, pcache.planes()))
    jgreedy, jrows = jax_spec._verify_wrapped_fn(ref)(
        ref.params, jnp.asarray([chunk], jnp.int32), np.array([pos], np.int32), jcache)
    assert greedy == np.asarray(jgreedy).tolist()
    tol = CACHES[cache][2]
    for got, want in zip(_dequant([r.numpy() for r in rows]), _dequant(jrows)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("cache", sorted(CACHES))
def test_spec_commit_matches_jax(tiny_i8, cache):
    ref, port = _engines(tiny_i8, cache, 16)
    jcache, pcache, token, pos = _wrapped_state(ref, port)
    chunk = [token, 5, 6, 7, 8]
    _, jrows = jax_spec._verify_wrapped_fn(ref)(
        ref.params, jnp.asarray([chunk], jnp.int32), np.array([pos], np.int32), jcache)
    from xalm_tpu.runtime.cache import ring_indices

    _, kvp, _ = ring_indices((pos + np.arange(K + 1))[None], ref.cfg.max_seq_len)
    kvp = np.asarray(kvp)
    rows = tuple(torch.from_numpy(np.array(r)) for r in jrows)
    for a in (0, 2, K):
        fresh = JaxKVCache(*(None if p is None else jnp.array(np.array(p))
                             for p in (jcache.k, jcache.v, jcache.k_scale, jcache.v_scale)))
        want = jax_spec.spec_commit(ref, fresh, jrows, kvp, a)
        got = spec.spec_commit(port, pcache.clone(), rows, kvp, a)
        wk, wv = np.asarray(want.k), np.asarray(want.v)
        gk, gv = got.k.numpy(), got.v.numpy()
        assert np.array_equal(gv, wv)  # V rows: the same stored rows scattered
        assert np.array_equal(gk[:, :, :, 2:], wk[:, :, :, 2:])
        if cache == "i8":
            assert np.array_equal(got.v_scale.numpy(), np.asarray(want.v_scale))
            assert np.array_equal(got.k_scale.numpy()[..., 2:], np.asarray(want.k_scale)[..., 2:])
            gs = gk[:, :, :, :2] * got.k_scale.numpy()[..., :2, None]
            ws = wk[:, :, :, :2].astype(np.float32) * np.asarray(want.k_scale)[..., :2, None]
            assert np.abs(gs - ws).max() <= np.abs(ws).max() / 127
        else:
            gs, ws = gk[:, :, :, :2].astype(np.float32), wk[:, :, :, :2].astype(np.float32)
            assert np.abs(gs - ws).max() <= np.abs(ws).max() * 2.0 ** -10
        # the rows past the accepted ones keep the live ring rows
        rest = kvp[0, a + 1:]
        assert np.array_equal(gv[:, 0, :, rest], pcache.v.numpy()[:, 0, :, rest])


def test_blind_verify_writes_the_chunk_rows_like_prefill(tiny_i8):
    """The pre-wrap verify chunk writes its k + 1 rows as a prefill chunk of
    the same tokens does, bit for bit (the device-indexed chunk write)."""
    _, port = _engines(tiny_i8, "f16", 0)
    a, b = port.new_cache(1), port.new_cache(1)
    _, a, pos = port.prefill(PROMPT, a, logits_mode="none")
    _, b, _ = port.prefill(PROMPT, b, logits_mode="none")
    chunk = [7, 8, 9, 10, 11]
    greedy, rows = port.verify(chunk, pos, a, wrapped=False)
    logits, b = port.step(np.array([chunk]), np.array([pos], np.int32), b, logits_mode="all")
    assert rows is None
    assert greedy == torch.argmax(logits[0], dim=-1).tolist()
    assert all(torch.equal(x, y) for x, y in zip(a.planes(), b.planes()))


def test_draft_engine_must_be_another_engine(tiny_i8):
    _, port = _engines(tiny_i8, "f16", 0)
    with pytest.raises(ValueError, match="another Engine"):
        spec.generate_spec(port, PROMPT, 4, draft_engine=port)
