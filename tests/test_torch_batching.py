"""The port's continuous batcher (``xalm_tpu_torch/serve/batching.py``)
against the JAX ``xalm_tpu/serve/batching.py`` on the CPU, tiny models
(``tests/make_tiny_model.py``), and the JAX file's own cases
(tests/test_batching.py) on the port.

Both batchers take the same request lists at segments 1 and 4, with an
f32 and an int8 cache: every request's tokens must be equal, its
log-probs and top-5 log-probs within 1e-4 with the f32 cache (f32 sums in
another order through a few layers), its top-5 ids equal but where two
alternatives lie within that tolerance of each other (a near-tie the same
rounding can swap), and ``prefix_hits``, ``prefix_tokens_saved`` and
``decode_steps`` equal. With the int8 cache the port's decode step runs
kernel 7's plain version, which rounds q and p * v_scale to bf16 as the
kernel's tensor-core dots take them, where the JAX engine on the CPU
attends the dequantised rows in f32 (its "xla" route): log-probs within
8e-3 there. The port on its own "xla" route (``matmul_impl="xla"``, the
same int8 cache and batcher) computes as JAX does and is held to 1e-4:
the bf16 rounding, and nothing of the batcher, makes the int8 bar wider. The mixes: greedy alone; greedy, seeded sampled
and logprobs requests together; a shared prefix of 20 tokens (copied) and
one of 12 (below ``_PREFIX_MIN``, prefilled); a 40-token prompt through a
16-slot window beside a short one; a stop token; a cancel mid-flight.
"""

import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu.serve.batching import ContinuousBatcher as JaxBatcher
from xalm_tpu.serve.batching import Request as JaxRequest
from xalm_tpu_torch.runtime.cache import KVCache, copy_lane
from xalm_tpu_torch.runtime.engine import Engine
from xalm_tpu_torch.serve.batching import ContinuousBatcher, Request

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

# (JAX cache, port cache, the port's matmul_impl)
CACHES = {"f32": (jnp.float32, torch.float32, "auto"), "i8": (jnp.int8, torch.int8, "auto"),
          "i8_xla": (jnp.int8, torch.int8, "xla")}
LP_TOL = {"f32": 1e-4, "i8": 8e-3, "i8_xla": 1e-4}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "f32"]) == 0
    return out


@functools.lru_cache(maxsize=None)
def _engines(path: str, kv: str, context: int):
    jkv, tkv, impl = CACHES[kv]
    return (JaxEngine.from_xalm(path, context=context, kv_dtype=jkv, progress=False),
            Engine.from_xalm(path, context=context, kv_dtype=tkv, matmul_impl=impl, device="cpu"))


@pytest.fixture(scope="module")
def engine(tiny):
    """The port engine at the JAX file's settings (the CPU's f16 cache)."""
    return Engine.from_xalm(tiny, device="cpu")


class _StopAt:
    """A tokenizer whose stop token is ``stop`` (the batcher asks only
    ``is_stop``)."""

    def __init__(self, stop: int):
        self.stop = stop

    def is_stop(self, token: int) -> bool:
        return token == self.stop


def _prompts(seed: int, lens) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 350, size=n).tolist() for n in lens]


def _mix(name: str) -> tuple[list[dict], dict]:
    """(request specs, options) of a mix."""
    greedy = dict(stop_on_eos=False)
    opts = dict(max_batch=3, prefill_budget=16, context=0)
    if name == "greedy":
        ps = _prompts(0, (4, 9, 6, 13, 30))
        return [dict(prompt_ids=p, max_new_tokens=n, **greedy)
                for p, n in zip(ps, (6, 3, 8, 5, 7))], opts
    if name == "mixed":
        ps = _prompts(1, (5, 11, 7, 20, 3))
        return [dict(prompt_ids=ps[0], max_new_tokens=7, **greedy),
                dict(prompt_ids=ps[1], max_new_tokens=9, temperature=0.9, seed=7, **greedy),
                dict(prompt_ids=ps[2], max_new_tokens=6, logprobs=3, **greedy),
                dict(prompt_ids=ps[3], max_new_tokens=8, temperature=1.2, top_p=0.9,
                     logprobs=2, seed=3, **greedy),
                dict(prompt_ids=ps[4], max_new_tokens=5, temperature=0.7, **greedy)], opts
    if name == "prefix":
        long_sys, short_sys = _prompts(2, (20, 12))
        tails = _prompts(3, (3, 4, 5, 2))
        return [dict(prompt_ids=long_sys + tails[0], max_new_tokens=6, **greedy),
                dict(prompt_ids=long_sys + tails[1], max_new_tokens=5, logprobs=1, **greedy),
                dict(prompt_ids=short_sys + tails[2], max_new_tokens=4, **greedy),
                dict(prompt_ids=short_sys + tails[3], max_new_tokens=6, temperature=0.8,
                     seed=1, **greedy)], dict(opts, max_batch=4)
    if name == "long":
        short, long = _prompts(4, (5, 40))
        return [dict(prompt_ids=short, max_new_tokens=10, **greedy),
                dict(prompt_ids=long, max_new_tokens=6, **greedy),
                dict(prompt_ids=long[:20], max_new_tokens=12, temperature=0.9, seed=2,
                     logprobs=2, **greedy)], dict(opts, max_batch=2, prefill_budget=8, context=16)
    if name == "stop":
        ps = _prompts(5, (6, 8, 10))
        return [dict(prompt_ids=p, max_new_tokens=12, stop_on_eos=True, logprobs=1 if i else 0)
                for i, p in enumerate(ps)], opts
    if name == "cancel":
        ps = _prompts(6, (6, 9, 7, 5))
        return [dict(prompt_ids=p, max_new_tokens=24, **greedy) for p in ps], opts
    raise KeyError(name)


def _drive(batcher, reqs, mix: str, engines) -> None:
    """Submit and run ``reqs`` as the mix has it (the same schedule for both
    packages)."""
    first = {"long": 2, "prefix": 1}.get(mix, len(reqs))
    for r in reqs[:first]:
        batcher.submit(r)
    if first < len(reqs):
        for _ in range(2):
            batcher.step()
        for r in reqs[first:]:
            batcher.submit(r)
    if mix == "cancel":
        for _ in range(2):
            batcher.step()
        assert batcher.cancel(reqs[1].id) and batcher.cancel(reqs[3].id)
        assert not batcher.cancel(999)
    batcher.run()


def _same_alternatives(got, want, tol: float) -> None:
    """Top alternatives [(id, log-prob)] best first: the log-probs rank by
    rank within ``tol``, and the ids equal, but where the port's id at a
    rank is JAX's near-tie: JAX lists it with a log-prob within ``tol``, or
    (a swap across the list's cut) neither lists the other's id there."""
    assert len(got) == len(want)
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=0, atol=tol)
    jax_lp, port_lp = dict(want), dict(got)
    for (t, v), (wt, _) in zip(got, want):
        if t != wt:
            assert (abs(jax_lp[t] - v) <= tol if t in jax_lp else wt not in port_lp), (got, want)


def _stop_token(jeng, spec) -> int:
    """The third token of the JAX engine's greedy run of a request: the
    "stop" mix's stop token."""
    out, _ = jeng.generate(spec["prompt_ids"], 3, stop_on_eos=False)
    return out[2]


@pytest.mark.parametrize("kv", sorted(CACHES))
@pytest.mark.parametrize("segment", [1, 4])
@pytest.mark.parametrize("mix", ["greedy", "mixed", "prefix", "long", "stop", "cancel"])
def test_batcher_matches_jax(tiny, mix, segment, kv):
    specs, opts = _mix(mix)
    jeng, teng = _engines(tiny, kv, opts.pop("context"))
    saved = jeng.tokenizer, teng.tokenizer
    if mix == "stop":
        stop = _stop_token(jeng, specs[1])
        jeng.tokenizer, teng.tokenizer = _StopAt(stop), _StopAt(stop)
    try:
        runs = []
        for batcher_cls, req_cls, eng in ((JaxBatcher, JaxRequest, jeng),
                                          (ContinuousBatcher, Request, teng)):
            b = batcher_cls(eng, segment=segment, **opts)
            reqs = [req_cls(**s) for s in specs]
            _drive(b, reqs, mix, (jeng, teng))
            runs.append((b, reqs))
    finally:
        jeng.tokenizer, teng.tokenizer = saved
    (jb, jreqs), (tb, treqs) = runs
    for i, (want, got) in enumerate(zip(jreqs, treqs)):
        assert got.out_tokens == want.out_tokens, f"request {i}"
        assert got.done and len(got.out_logprobs) == len(want.out_logprobs)
        tol = LP_TOL[kv]
        np.testing.assert_allclose(got.out_logprobs, want.out_logprobs, rtol=0, atol=tol)
        for ga, wa in zip(got.out_top_logprobs, want.out_top_logprobs):
            _same_alternatives(ga, wa, tol)
    for counter in ("prefix_hits", "prefix_tokens_saved", "decode_steps", "decoded_tokens"):
        assert getattr(tb, counter) == getattr(jb, counter), counter
    assert [r.id for r in tb.completed] == [r.id for r in jb.completed]
    if mix == "prefix":
        assert tb.prefix_hits == 1 and tb.prefix_tokens_saved == 20
    if mix == "stop":
        assert treqs[1].out_tokens[-1] == stop and len(treqs[1].out_tokens) <= 3
    if mix == "cancel":
        assert 0 < len(treqs[1].out_tokens) < 24 and treqs[3].done


# ---------------------------------------------------- the JAX file's cases


def _solo(engine, prompt, n):
    out, _ = engine.generate(prompt, n, stop_on_eos=False)
    return out


def test_batched_equals_solo(engine):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 350, size=n).tolist() for n in (4, 9, 6, 13)]
    n_new = [6, 3, 8, 5]
    solo = [_solo(engine, p, n) for p, n in zip(prompts, n_new)]
    batcher = ContinuousBatcher(engine, max_batch=3)  # fewer slots than requests
    for p, n in zip(prompts, n_new):
        batcher.submit(Request(prompt_ids=p, max_new_tokens=n, stop_on_eos=False))
    done = batcher.run()
    assert len(done) == 4
    by_id = {r.id: r for r in done}
    for i in range(4):
        assert by_id[i].out_tokens == solo[i], f"request {i}"
    assert batcher.decoded_tokens > 0
    assert all(r.finished_s >= r.submitted_s for r in done)


def test_eos_stops_early(engine):
    batcher = ContinuousBatcher(engine, max_batch=2)
    r = Request(prompt_ids=[1, 259, 260], max_new_tokens=50, stop_on_eos=True)
    batcher.submit(r)
    done = batcher.run()
    assert done[0].done
    assert 1 <= len(done[0].out_tokens) <= 50


def test_streaming_callback(engine):
    got = []
    r = Request(prompt_ids=[1, 259], max_new_tokens=4, stop_on_eos=False, on_token=got.append)
    b = ContinuousBatcher(engine, max_batch=1)
    b.submit(r)
    b.run()
    assert got == r.out_tokens and len(got) == 4


def test_segmented_batcher_equals_solo(engine):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 350, size=n).tolist() for n in (5, 11, 7)]
    n_new = [7, 4, 9]
    solo = [_solo(engine, p, n) for p, n in zip(prompts, n_new)]
    b = ContinuousBatcher(engine, max_batch=2, segment=4)
    for p, n in zip(prompts, n_new):
        b.submit(Request(prompt_ids=p, max_new_tokens=n, stop_on_eos=False))
    by_id = {r.id: r for r in b.run()}
    for i, want in enumerate(solo):
        assert by_id[i].out_tokens == want, f"request {i}"


def test_incremental_prefill_interleaves_decode(engine):
    """A long prompt admitted mid-flight does not stall a decoding slot:
    with a small prefill budget the active request goes on generating
    between the long prompt's chunks, and both give their solo tokens."""
    rng = np.random.default_rng(5)
    short = rng.integers(3, 350, size=5).tolist()
    long = rng.integers(3, 350, size=40).tolist()
    solo_short, solo_long = _solo(engine, short, 12), _solo(engine, long, 6)
    batcher = ContinuousBatcher(engine, max_batch=2, segment=1, prefill_budget=8)
    r_short = Request(prompt_ids=short, max_new_tokens=12, stop_on_eos=False)
    r_long = Request(prompt_ids=long, max_new_tokens=6, stop_on_eos=False)
    batcher.submit(r_short)
    for _ in range(3):
        batcher.step()
    before = len(r_short.out_tokens)
    batcher.submit(r_long)
    for _ in range(4):
        batcher.step()
        if r_short.done:
            break
    assert len(r_short.out_tokens) > before, "active decode stalled behind the admitting prompt"
    batcher.run()
    assert r_short.out_tokens == solo_short
    assert r_long.out_tokens == solo_long
    stats = batcher.latency_stats()
    assert stats["completed"] == 2
    for k in ("queue_wait_p50_s", "ttft_p95_s", "tok_latency_p50_s"):
        assert stats[k] >= 0.0


def test_packed_prefill_advances_all_admitting_slots(engine):
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 350, size=20).tolist() for _ in range(3)]
    solos = [_solo(engine, p, 4) for p in prompts]
    b = ContinuousBatcher(engine, max_batch=4, segment=1, prefill_budget=8)
    reqs = [Request(prompt_ids=p, max_new_tokens=4, stop_on_eos=False) for p in prompts]
    for r in reqs:
        b.submit(r)
    b.step()
    assert [int(b._prefill_pos[i]) for i in range(3)] == [8, 8, 8]  # all three, one tick
    b.run()
    for r, want in zip(reqs, solos):
        assert r.out_tokens == want


def test_latency_stats_ordering(engine):
    rng = np.random.default_rng(6)
    batcher = ContinuousBatcher(engine, max_batch=2)
    reqs = [Request(prompt_ids=rng.integers(3, 350, size=6).tolist(), max_new_tokens=4,
                    stop_on_eos=False) for _ in range(4)]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    for r in reqs:
        assert r.submitted_s <= r.admitted_s <= r.first_token_s <= r.finished_s
    stats = batcher.tick_stats()
    assert stats["ticks"] >= 4 and "device_ms" not in stats  # no device time on the CPU
    assert set(stats["host_ms"]) == {"prefill", "probe", "decode", "own"}
    assert all(v >= 0.0 for k, v in stats["host_ms"].items() if k != "own")


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU: records the host
    clock, finished once recorded."""

    def record(self):
        self.t = time.perf_counter()

    def query(self) -> bool:
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def test_span_events_fold_every_tick(engine, monkeypatch):
    """With device times on, each tick's span events are folded into the
    totals at its end: over many ticks the batcher keeps no more than one
    tick's events, and ``tick_stats`` gives each span's device ms."""
    from xalm_tpu_torch.serve import batching

    monkeypatch.setattr(batching, "_event", _FakeEvent)
    b = ContinuousBatcher(engine, max_batch=2, device_times=True)
    b._timed = True  # the CPU engine records the stand-in events
    rng = np.random.default_rng(13)
    for n in (5, 9, 7):
        b.submit(Request(prompt_ids=rng.integers(3, 350, size=n).tolist(), max_new_tokens=12,
                         stop_on_eos=False, logprobs=1))
    while b.step():
        assert len(b._events) == 0
    assert b.ticks >= 20
    stats = b.tick_stats()
    assert set(stats["device_ms"]) == {"prefill", "probe", "decode"}
    assert all(v > 0.0 for v in stats["device_ms"].values())


def test_segmented_scan_masks_prefilling_slots(tiny):
    """With segment > 1 a prompt at or past the window (context 16, a
    40-token prompt) admitted mid-flight must not let the scan's masked
    rows wrap the ring and corrupt a neighbour: both requests give their
    solo tokens."""
    engine = Engine.from_xalm(tiny, context=16, device="cpu")
    rng = np.random.default_rng(12)
    short = rng.integers(3, 350, size=5).tolist()
    long = rng.integers(3, 350, size=40).tolist()
    solo_short, solo_long = _solo(engine, short, 10), _solo(engine, long, 6)
    batcher = ContinuousBatcher(engine, max_batch=2, segment=4, prefill_budget=8)
    r_short = Request(prompt_ids=short, max_new_tokens=10, stop_on_eos=False)
    r_long = Request(prompt_ids=long, max_new_tokens=6, stop_on_eos=False)
    batcher.submit(r_short)
    for _ in range(2):
        batcher.step()
    batcher.submit(r_long)
    batcher.run()
    assert r_short.out_tokens == solo_short
    assert r_long.out_tokens == solo_long


def test_sampled_request_deterministic_under_cobatching(engine):
    """A sampled request's tokens depend on its seed alone, not on what it
    is batched with (its own key), at segments 1 and 4."""
    prompt = [1, 259, 260, 10]

    def run(extra: int, segment: int):
        b = ContinuousBatcher(engine, max_batch=4, segment=segment)
        b.submit(Request(prompt_ids=prompt, max_new_tokens=10, stop_on_eos=False,
                         temperature=0.9, seed=7))
        for j in range(extra):
            b.submit(Request(prompt_ids=[1, 300 + j], max_new_tokens=6, stop_on_eos=False))
        return next(r for r in b.run() if r.temperature > 0).out_tokens

    assert run(0, 1) == run(3, 1) == run(3, 4)


def test_greedy_rows_unchanged_next_to_sampled(engine):
    b = ContinuousBatcher(engine, max_batch=4)
    g = Request(prompt_ids=[1, 259, 260], max_new_tokens=8, stop_on_eos=False)
    b.submit(g)
    b.submit(Request(prompt_ids=[1, 300, 301], max_new_tokens=8, stop_on_eos=False,
                     temperature=1.1, seed=3))
    b.run()
    want, _ = engine.generate([1, 259, 260], 8, stop_on_eos=False, segment=1)
    assert g.out_tokens == want


def test_logprobs_collection(engine):
    """Greedy with logprobs: the chosen token is the first alternative, the
    log-probs are <= 0 and the alternatives best first."""
    b = ContinuousBatcher(engine, max_batch=2)
    r = Request(prompt_ids=[1, 259, 260, 10], max_new_tokens=6, stop_on_eos=False, logprobs=3)
    b.submit(r)
    b.run()
    assert len(r.out_logprobs) == len(r.out_tokens) == 6
    assert all(len(a) == 3 for a in r.out_top_logprobs)
    for t, alts in zip(r.out_tokens, r.out_top_logprobs):
        assert alts[0][0] == t
    assert all(lp <= 0 for lp in r.out_logprobs)
    for alts in r.out_top_logprobs:
        vals = [lp for _, lp in alts]
        assert vals == sorted(vals, reverse=True)


def test_logprobs_match_prefill_all(engine):
    """The first log-prob equals log_softmax of the prefill's logits at the
    prompt's last position, within 2e-4 (the JAX file's bar)."""
    prompt = [1, 300, 301, 5]
    b = ContinuousBatcher(engine, max_batch=1)
    r = Request(prompt_ids=prompt, max_new_tokens=3, stop_on_eos=False, logprobs=1)
    b.submit(r)
    b.run()
    logits, _, _ = engine.prefill(prompt, engine.new_cache(1), logits_mode="last")
    logp = torch.log_softmax(logits[0].float(), -1).numpy()
    assert abs(r.out_logprobs[0] - float(logp[r.out_tokens[0]])) < 2e-4


def test_prefix_caching_reuses_shared_prompt(engine):
    sys_prompt = [1] + list(range(259, 299))  # 41 shared tokens
    a_ids, b_ids = sys_prompt + [300, 301], sys_prompt + [310, 311, 312]
    want_a, _ = engine.generate(a_ids, 8, stop_on_eos=False, segment=1)
    want_b, _ = engine.generate(b_ids, 8, stop_on_eos=False, segment=1)
    b = ContinuousBatcher(engine, max_batch=2, prefill_budget=16)
    ra = Request(prompt_ids=a_ids, max_new_tokens=8, stop_on_eos=False)
    rb = Request(prompt_ids=b_ids, max_new_tokens=8, stop_on_eos=False)
    b.submit(ra)
    b.step()  # admit A, its first prefill chunk
    b.submit(rb)
    b.run()
    assert ra.out_tokens == want_a
    assert rb.out_tokens == want_b
    assert b.prefix_hits == 1
    assert b.prefix_tokens_saved >= 16


def test_prefix_caching_below_threshold_skipped(engine):
    b = ContinuousBatcher(engine, max_batch=2)
    b.submit(Request(prompt_ids=[1, 259, 260], max_new_tokens=4, stop_on_eos=False))
    b.step()
    b.submit(Request(prompt_ids=[1, 259, 261], max_new_tokens=4, stop_on_eos=False))
    b.run()
    assert b.prefix_hits == 0


def test_warmup_changes_no_state(engine):
    """``warmup`` runs every serving step fully masked: the cache planes,
    the slots' state and the keys stay as they were, and a run after it
    gives the solo tokens."""
    b = ContinuousBatcher(engine, max_batch=3, segment=2)
    b.cache.k.normal_(generator=torch.Generator().manual_seed(0))
    before = [t.clone() for t in b.cache.planes()]
    assert b.warmup() >= 0.0
    s = engine.cfg.max_seq_len
    for got, want in zip(b.cache.planes(), before):
        assert torch.equal(got[..., :s, :], want[..., :s, :])
    assert not b._pos.any() and not b._keys.any() and b.active == b.pending == 0
    r = Request(prompt_ids=[1, 259, 260, 10], max_new_tokens=5, stop_on_eos=False)
    b.cache.zero_()
    b.submit(r)
    b.run()
    assert r.out_tokens == _solo(engine, [1, 259, 260, 10], 5)


@pytest.mark.parametrize("kv", ["f16", "i8"])
def test_copy_lane_in_place_other_lanes_bit_equal(kv):
    """``copy_lane`` copies every plane's lane (an int8 cache's scales
    too) in place: the planes keep their addresses, the copied lane equals
    its source and every other lane is bit-equal to before."""
    from xalm_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(dim=64, hidden_dim=128, head_dim=16, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=100, max_seq_len=40, rope_theta=1e4, rotary_dim=16)
    dt = torch.int8 if kv == "i8" else torch.float16
    cache = KVCache.init(cfg, 4, dt, "cpu")
    g = torch.Generator().manual_seed(1)
    for t in cache.planes():
        t.copy_((torch.randn(t.shape, generator=g) * 50).to(t.dtype))
    before = [t.clone() for t in cache.planes()]
    ptrs = [t.data_ptr() for t in cache.planes()]
    assert copy_lane(cache, 2, 0) is cache
    assert [t.data_ptr() for t in cache.planes()] == ptrs
    assert len(before) == (4 if kv == "i8" else 2)
    for got, old in zip(cache.planes(), before):
        assert torch.equal(got[:, 2], old[:, 0])
        for lane in (0, 1, 3):
            assert torch.equal(got[:, lane], old[:, lane])
