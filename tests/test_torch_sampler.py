"""The port's stochastic sampler (``xalm_tpu_torch/sampler.py``) against the
JAX ``xalm_tpu.sampler.sample`` on the CPU, and sampled decode through the
engine and the harness.

The two packages draw from different generators (torch's against JAX's
threefry), so the tokens are not compared across them. What is compared:
the filtered logits ``sample`` draws from (temperature, then top-k, then
the sort-free nucleus filter ``_nucleus_keep``, keep-all case included):
the same mask, and log-softmax within 1e-5 (f32 exp and sums in another
order); and the draws against the filtered softmax by a chi-square test of
20000 draws over a 64-token vocab at p > 1e-3 (a correct sampler fails it
one time in a thousand; the seed is fixed, so the test is deterministic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu.sampler import _nucleus_keep as jax_nucleus_keep
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.runtime.engine import Engine
from xalm_tpu_torch.sampler import filtered_logits, sample, sample_argmax

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
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(sample(lg, gen, temperature=0.0, top_k=5, top_p=0.5), sample_argmax(lg))
    assert sample(lg, gen, temperature=0.0).dtype == torch.int32


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
    gen = torch.Generator().manual_seed(123)
    draws = sample(torch.from_numpy(np.repeat(row, n, axis=0)), gen, temperature=temperature,
                   top_k=top_k, top_p=top_p)
    counts = np.bincount(draws.numpy(), minlength=vocab)
    live = probs > 0
    assert counts[~live].sum() == 0
    assert stats.chisquare(counts[live], probs[live] / probs[live].sum() * n).pvalue > 1e-3


def test_same_seed_same_draws():
    lg = torch.from_numpy(_logits(7, 8, 64, 1.0))

    def draw(seed):
        return sample(lg, torch.Generator().manual_seed(seed), temperature=1.0, top_k=30,
                      top_p=0.9)

    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(1), draw(2))


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
    """On the CPU the scan's steps are the eager steps: the same draws from
    the same seed as sampling each step's logits in turn."""
    eng = Engine.from_xalm(tiny_i8, context=WINDOW, device="cpu")
    _, c1, pos = eng.prefill([1, 259, 260, 10], eng.new_cache(1))
    _, c2, _ = eng.prefill([1, 259, 260, 10], eng.new_cache(1))
    sp = dict(temperature=0.8, top_k=50, top_p=0.9)
    got, _ = eng._sample_scan(np.array([7]), np.array([pos]), c1, 2 * WINDOW, seed=5, **sp)
    gen = torch.Generator().manual_seed(5)
    tok = 7
    for i in range(2 * WINDOW):
        logits, c2 = eng.decode(np.array([tok]), np.array([pos + i], np.int32), c2)
        tok = int(sample(logits, gen, **sp)[0])
        assert int(got[0, i]) == tok, i


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
