"""The port's samplers (``xalm_tpu_torch/sampler.py``) against the JAX
``xalm_tpu.sampler`` on the CPU, and sampled decode through the engine and
the harness.

Both packages draw from threefry keys, the port's own (``prng.py``) equal
to JAX's bit for bit, so tokens are compared across them: ``sample`` and
``sample_rows`` give JAX's tokens on the same logits and keys, and sampled
``generate``, ``_sample_scan`` and ``_sample_scan_rows`` JAX's tokens on the
same tiny model and seed (their Gumbel draws agree to an ulp or two, see
tests/test_torch_prng.py, far inside the gaps between the perturbed
logits that decide a draw here). Also compared: the filtered logits
``sample`` draws from (temperature, then top-k, then the sort-free nucleus
filter ``_nucleus_keep``, keep-all case included): the same mask, and
log-softmax within 1e-5 (f32 exp and sums in another order); the log-probs
and top-5 of ``sample_rows`` within 1e-5, the top-5 ids equal; and the
draws against the filtered softmax by a chi-square test of 20000 draws
over a 64-token vocab at p > 1e-3 (a correct sampler fails it one time in
a thousand; the key is fixed, so the test is deterministic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu import sampler as jax_sampler
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu.sampler import _nucleus_keep as jax_nucleus_keep
from xalm_tpu_torch import prng
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.runtime.engine import Engine
from xalm_tpu_torch.sampler import (
    filtered_logits,
    sample,
    sample_argmax,
    sample_rows,
    split_rows,
)

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

WINDOW = 16


def _jax_filtered(logits: np.ndarray, temperature: float, top_k: int, top_p: float):
    """The filtered logits of the JAX ``sample`` (its body up to the draw)."""
    lg = jnp.asarray(logits, jnp.float32) / temperature
    if top_k and top_k > 0:
        kth = jax.lax.top_k(lg, top_k)[0][..., -1:]
        lg = jnp.where(lg < kth, -jnp.inf, lg)
    if top_p < 1.0:
        lg = jnp.where(jax_nucleus_keep(lg, jnp.asarray(top_p)), lg, -jnp.inf)
    return np.asarray(lg)


def _logits(seed: int, rows: int, vocab: int, scale: float) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((rows, vocab)) * scale).astype(np.float32)


@pytest.mark.parametrize("top_p", [1.0, 0.95, 0.6, 0.05])
@pytest.mark.parametrize("top_k", [0, 1, 7, 300])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 1.7])
def test_filter_matches_jax(temperature, top_k, top_p):
    """A 1000-token vocab (wider than the nucleus filter's 256 candidates),
    three rows of logits of scale 3."""
    lg = _logits(3, 3, 1000, 3.0)
    want = _jax_filtered(lg, temperature, top_k, top_p)
    got = filtered_logits(torch.from_numpy(lg), temperature=temperature, top_k=top_k,
                          top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    lsm = lambda a: np.asarray(jax.nn.log_softmax(jnp.asarray(a), axis=-1))  # noqa: E731
    keep = np.isfinite(want)
    np.testing.assert_allclose(torch.log_softmax(torch.from_numpy(got), -1).numpy()[keep],
                               lsm(want)[keep], rtol=0, atol=1e-5)


@pytest.mark.parametrize("top_p", [0.9, 0.5])
def test_nucleus_keeps_all_where_the_top_k_mass_falls_short(top_p):
    """A near-uniform 2000-token distribution: the top 256 hold about an
    eighth of the mass, so the filter keeps every token, as JAX's does."""
    lg = _logits(4, 2, 2000, 0.01)
    got = filtered_logits(torch.from_numpy(lg), temperature=1.0, top_p=top_p)
    assert torch.isfinite(got).all()
    assert np.isfinite(_jax_filtered(lg, 1.0, 0, top_p)).all()


def test_temperature_zero_is_argmax():
    lg = torch.from_numpy(_logits(5, 4, 64, 2.0))
    key = prng.PRNGKey(0)
    assert torch.equal(sample(lg, key, temperature=0.0, top_k=5, top_p=0.5), sample_argmax(lg))
    assert sample(lg, key, temperature=0.0).dtype == torch.int32


DRAW_CASES = [(1.0, 0, 1.0), (0.7, 10, 1.0), (1.3, 0, 0.8), (1.0, 20, 0.6)]


@pytest.mark.parametrize("temperature,top_k,top_p", DRAW_CASES)
def test_draws_follow_the_filtered_softmax(temperature, top_k, top_p):
    """20000 draws over a 64-token vocab (one distribution, one draw a row):
    the counts against the filtered softmax, chi-square p > 1e-3; no draw of
    a filtered-out token."""
    n, vocab = 20000, 64
    row = _logits(6, 1, vocab, 1.5)
    probs = torch.softmax(filtered_logits(torch.from_numpy(row), temperature=temperature,
                                          top_k=top_k, top_p=top_p), -1)[0].double().numpy()
    draws = sample(torch.from_numpy(np.repeat(row, n, axis=0)), prng.PRNGKey(123),
                   temperature=temperature, top_k=top_k, top_p=top_p)
    counts = np.bincount(draws.numpy(), minlength=vocab)
    live = probs > 0
    assert counts[~live].sum() == 0
    assert stats.chisquare(counts[live], probs[live] / probs[live].sum() * n).pvalue > 1e-3


def test_same_seed_same_draws():
    lg = torch.from_numpy(_logits(7, 8, 64, 1.0))

    def draw(seed):
        return sample(lg, prng.PRNGKey(seed), temperature=1.0, top_k=30, top_p=0.9)

    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(1), draw(2))


@pytest.mark.parametrize("temperature,top_k,top_p", DRAW_CASES + [(0.3, 0, 0.95)])
def test_sample_matches_jax(temperature, top_k, top_p):
    """One key over a (4, 1000) batch (one Gumbel draw of the whole shape,
    as ``jax.random.categorical`` takes it): JAX's tokens, for 20 keys."""
    lg = _logits(8, 4, 1000, 2.0)
    for seed in range(20):
        want = np.asarray(jax_sampler.sample(jnp.asarray(lg), jax.random.PRNGKey(seed),
                                             temperature=temperature, top_k=top_k, top_p=top_p))
        got = sample(torch.from_numpy(lg), prng.PRNGKey(seed), temperature=temperature,
                     top_k=top_k, top_p=top_p)
        np.testing.assert_array_equal(got.numpy(), want)


ROW_MIXES = {
    "greedy": ([0.0] * 4, [1.0] * 4),
    "sampled": ([0.8, 1.0, 1.3, 0.5], [0.95, 1.0, 0.6, 0.9]),
    "mixed": ([0.0, 0.9, 0.0, 1.2], [1.0, 0.95, 0.5, 1.0]),
}


@pytest.mark.parametrize("lp", [False, True])
@pytest.mark.parametrize("mix", sorted(ROW_MIXES))
def test_sample_rows_matches_jax(mix, lp):
    """Four rows of 1000-token logits, each under its own key, temperature
    and top-p, for 10 key sets: JAX's tokens; with log-probs the chosen
    token's log-prob and the raw top-5 within 1e-5, the top-5 ids equal."""
    temps, tps = (np.asarray(v, np.float32) for v in ROW_MIXES[mix])
    lg = _logits(9, 4, 1000, 2.5)
    for base in range(10):
        keys = np.stack([np.asarray(jax.random.PRNGKey(base * 4 + r)) for r in range(4)])
        want = jax_sampler.sample_rows(jnp.asarray(lg), jnp.asarray(keys), jnp.asarray(temps),
                                       jnp.asarray(tps), return_logprobs=lp)
        got = sample_rows(torch.from_numpy(lg), prng.from_numpy(keys), torch.from_numpy(temps),
                          torch.from_numpy(tps), return_logprobs=lp)
        if not lp:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            continue
        (tok, lpv, topv, topi), (wtok, wlp, wtopv, wtopi) = got, want
        np.testing.assert_array_equal(tok.numpy(), np.asarray(wtok))
        np.testing.assert_allclose(lpv.numpy(), np.asarray(wlp), rtol=0, atol=1e-5)
        np.testing.assert_allclose(topv.numpy(), np.asarray(wtopv), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(topi.numpy(), np.asarray(wtopi))
        assert tok.dtype == topi.dtype == torch.int32


def test_sample_rows_greedy_rows_take_the_first_maximum():
    """A temperature-0 row takes the lowest index among tied maxima, as
    the JAX ``ti[:, 0]`` does."""
    lg = np.zeros((2, 300), np.float32)
    lg[:, [7, 40, 41]] = 5.0
    keys = np.stack([np.asarray(jax.random.PRNGKey(r)) for r in range(2)])
    zero, one = np.zeros(2, np.float32), np.ones(2, np.float32)
    got = sample_rows(torch.from_numpy(lg), prng.from_numpy(keys), torch.from_numpy(zero),
                      torch.from_numpy(one))
    want = jax_sampler.sample_rows(jnp.asarray(lg), jnp.asarray(keys), jnp.asarray(zero),
                                   jnp.asarray(one))
    assert got.tolist() == np.asarray(want).tolist() == [7, 7]


def test_split_rows_matches_jax():
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (0, 3, 2**31 - 1, 77)])
    want = jax_sampler.split_rows(jnp.asarray(keys))
    got = split_rows(prng.from_numpy(keys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(prng.to_numpy(g), np.asarray(w))


@pytest.fixture(scope="module")
def tiny_i8(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny_i8.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    return out


@pytest.mark.parametrize("segment", [1, 4])
def test_sampled_generate_reproduces_under_its_seed(tiny_i8, segment):
    """Sampled generate through two ring wraps: the same (seed, segment)
    gives the same tokens, another seed others, and temperature 0 the greedy
    ones."""
    eng = Engine.from_xalm(tiny_i8, context=WINDOW, device="cpu")
    prompt = [1, 259, 260, 10, 20, 300, 5]
    kw = dict(stop_on_eos=False, segment=segment, temperature=0.9, top_k=40, top_p=0.95)
    a, stats = eng.generate(prompt, 3 * WINDOW, seed=11, **kw)
    assert len(a) == stats.generated_tokens == 3 * WINDOW
    assert eng.generate(prompt, 3 * WINDOW, seed=11, **kw)[0] == a
    assert eng.generate(prompt, 3 * WINDOW, seed=12, **kw)[0] != a
    greedy, _ = eng.generate(prompt, 3 * WINDOW, stop_on_eos=False, segment=segment)
    assert eng.generate(prompt, 3 * WINDOW, seed=11, **dict(kw, temperature=0.0))[0] == greedy


def test_sample_scan_matches_per_step_sampling(tiny_i8):
    """``_sample_scan`` from the same key gives the JAX ``_sample_scan``'s
    tokens through two ring wraps, and on the CPU its steps are the eager
    steps: the same tokens as splitting the key and sampling each step's
    logits in turn."""
    eng = Engine.from_xalm(tiny_i8, context=WINDOW, device="cpu")
    jeng = JaxEngine.from_xalm(tiny_i8, context=WINDOW, progress=False)
    prompt = [1, 259, 260, 10]
    _, c1, pos = eng.prefill(prompt, eng.new_cache(1))
    _, c2, _ = eng.prefill(prompt, eng.new_cache(1))
    _, jc, _ = jeng.prefill(prompt, jeng.new_cache(1))
    sp = dict(temperature=0.8, top_k=50, top_p=0.9)
    key = jax.random.PRNGKey(5)
    want, _ = jeng._sample_scan(jeng.params, np.array([7], np.int32), np.array([pos], np.int32),
                                jc, key, n_steps=2 * WINDOW, valid=None, **sp)
    got, _ = eng._sample_scan(np.array([7]), np.array([pos]), c1, np.asarray(key), 2 * WINDOW,
                              **sp)
    assert got[0].tolist() == np.asarray(want)[0].tolist()
    k, tok = prng.from_numpy(np.asarray(key)), 7
    for i in range(2 * WINDOW):
        logits, c2 = eng.decode(np.array([tok]), np.array([pos + i], np.int32), c2)
        k, sub = prng.split(k)
        tok = int(sample(logits, sub, **sp)[0])
        assert int(got[0, i]) == tok, i


@pytest.mark.parametrize("segment", [1, 4])
def test_sampled_generate_matches_jax(tiny_i8, segment):
    """Sampled ``generate`` under a seed: the JAX ``generate``'s tokens at
    the same segment, through two ring wraps (the key split once for the
    first token, once a segment, once a step)."""
    eng = Engine.from_xalm(tiny_i8, context=WINDOW, device="cpu")
    jeng = JaxEngine.from_xalm(tiny_i8, context=WINDOW, progress=False)
    prompt = [1, 259, 260, 10, 20, 300, 5]
    for seed, sp in ((11, dict(temperature=0.9, top_k=40, top_p=0.95)),
                     (3, dict(temperature=1.5, top_k=0, top_p=1.0))):
        kw = dict(stop_on_eos=False, segment=segment, seed=seed, **sp)
        want, _ = jeng.generate(prompt, 3 * WINDOW, **kw)
        got, _ = eng.generate(prompt, 3 * WINDOW, **kw)
        assert got == want


def _generated_text(out: str) -> list[str]:
    return out.split("Generation stats")[0].split("Encoding stats")[-1].splitlines()[1:]


def test_harness_sampled_completion_reproduces_under_seed(tiny_i8, capsys):
    """The harness takes the JAX harness's --temperature, --top-k, --top-p
    and --seed: a sampled completion, the same text again under the same
    seed, and not the greedy text."""
    args = [tiny_i8, "-d", "cpu", "-i", "hello world", "-n", "24", "-T", str(WINDOW)]
    sampled = ["--temperature", "1.5", "--top-k", "200", "--top-p", "0.98"]
    texts = []
    for extra in (sampled + ["--seed", "3"], sampled + ["--seed", "3"], []):
        assert port_harness.main(args + extra) == 0
        out = capsys.readouterr().out
        assert "tok/s" in out
        texts.append(_generated_text(out))
    assert texts[0] == texts[1]
    assert texts[0] != texts[2]


@pytest.fixture(scope="module")
def tiny_f32(tmp_path_factory):
    """An f32 container: no int8 weight route, whose bf16-rounded
    activations would move the log-probs by ~5e-3 against JAX's f32 ones."""
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny_f32.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "f32"]) == 0
    return out


@pytest.mark.parametrize("want_lp", [False, True])
def test_sample_scan_rows_matches_jax(tiny_f32, want_lp):
    """``Engine.sample_scan_rows`` over 4 rows at other positions (one masked;
    greedy, sampled and nucleus rows) through a ring wrap, f32 weights and
    cache: the
    JAX scan's tokens and final keys (a masked row keeps its key); with
    log-probs the chosen tokens' log-probs and the top-5 within 1e-4 (f32
    sums in another order; tests/test_torch_batching.py's bar), the top-5
    ids equal."""
    eng = Engine.from_xalm(tiny_f32, context=WINDOW, kv_dtype=torch.float32, device="cpu")
    jeng = JaxEngine.from_xalm(tiny_f32, context=WINDOW, kv_dtype=jnp.float32, progress=False)
    prompts = [[1, 259, 260, 10], [1, 300, 5, 6, 7, 8, 9], [1, 22], [1, 40, 41, 42, 43, 44]]
    cache, jcache = eng.new_cache(4), jeng.new_cache(4)
    for row, ids in enumerate(prompts):
        _, c1, _ = eng.prefill(ids, eng.new_cache(1))
        for a, b in zip(cache.planes(), c1.planes()):
            a[:, row].copy_(b[:, 0])
        _, jc1, _ = jeng.prefill(ids, jeng.new_cache(1))
        jcache = jax.tree.map(lambda a, b, r=row: a.at[:, r].set(b[:, 0]), jcache, jc1)
    tok = np.array([5, 6, 7, 8], np.int32)
    pos = np.array([len(p) for p in prompts], np.int32)
    valid = np.array([True, True, False, True])
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (1, 2, 3, 4)])
    temps = np.array([0.0, 0.8, 1.0, 1.3], np.float32)
    tps = np.array([1.0, 0.95, 0.9, 0.5], np.float32)
    n = WINDOW + 4
    want = jeng._sample_scan_rows(jeng.params, tok, pos, jcache, jnp.asarray(keys),
                                   jnp.asarray(temps), jnp.asarray(tps), n_steps=n,
                                   valid=jnp.asarray(valid), want_lp=want_lp)
    got = eng.sample_scan_rows(tok, pos, cache, keys, temps, tps, n, valid=valid,
                               want_lp=want_lp)
    np.testing.assert_array_equal(got[0].numpy()[valid], np.asarray(want[0])[valid])
    np.testing.assert_array_equal(prng.to_numpy(got[-1]), np.asarray(want[-2]))
    np.testing.assert_array_equal(prng.to_numpy(got[-1])[2], keys[2])
    if want_lp:
        for g, w in zip(got[1:3], want[1:3]):
            np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got[3].numpy()[valid], np.asarray(want[3])[valid])
