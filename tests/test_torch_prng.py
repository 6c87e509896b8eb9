"""The port's threefry keys and draws (``xalm_tpu_torch/prng.py``) against
``jax.random`` on the CPU.

Keys, splits, 32-bit draws and uniforms must be bit-equal. Gumbel draws,
-log(-log(u)) of bit-equal uniforms, go through two logs, and the two
libraries' f32 logs differ by one ulp on about one value in seven (the
inner -log(u) of both stays within 1 ulp): a Gumbel value must lie within 2
ulp of itself plus 2 ulp of 1.0 of JAX's (an ulp of the inner log's
argument moves the outer log by about 2^-23 whatever its size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from xalm_tpu_torch import prng

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

SEEDS = [0, 1, 7, 42, 123456, 2**31 - 1, 2**31, 2**32 - 1, 2**40 + 3, -1, -5]
SIZES = [1, 2, 5, 320, 1000, 32000]


def test_jax_threefry_is_partitionable():
    """The port implements the partitionable threefry (its splits and draws
    differ from the original's); a JAX that changes the default fails here
    by name."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_bit_equal(seed):
    np.testing.assert_array_equal(prng.to_numpy(prng.PRNGKey(seed)),
                                  np.asarray(jax.random.PRNGKey(seed)))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), num=st.integers(1, 9))
def test_split_bit_equal(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    np.testing.assert_array_equal(prng.to_numpy(prng.split(prng.PRNGKey(seed), num)), want)


@settings(max_examples=40, deadline=None)
@given(k1=st.integers(0, 2**32 - 1), k2=st.integers(0, 2**32 - 1),
       size=st.sampled_from(SIZES))
def test_random_bits_bit_equal(k1, k2, size):
    """Any key, not only a seed's: the (V,) 32-bit draws of a key a sampler
    step draws from."""
    key = np.array([k1, k2], np.uint32)
    want = np.asarray(jax.random.bits(jnp.asarray(key), (size,), jnp.uint32))
    np.testing.assert_array_equal(prng.to_numpy(prng.random_bits(prng.from_numpy(key), (size,))),
                                  want)


@pytest.mark.parametrize("shape", [(3, 7), (2, 2, 5), (1, 320)])
def test_random_bits_of_a_shape_count_its_flat_index(shape):
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(prng.to_numpy(prng.random_bits(prng.PRNGKey(9), shape)), want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_uniform_bit_equal(seed, size):
    """On [0, 1) and on the Gumbel draw's [tiny, 1), where the affine map is
    exact, bit-equal; on [-2, 3.5) within one ulp of the map's largest term,
    5.5 (XLA fuses the multiply-add, which torch rounds twice)."""
    key = jax.random.PRNGKey(seed)
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
        want = np.asarray(jax.random.uniform(key, (size,), minval=lo, maxval=hi))
        got = prng.uniform(prng.PRNGKey(seed), (size,), lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    want = np.asarray(jax.random.uniform(key, (size,), minval=-2.0, maxval=3.5))
    got = prng.uniform(prng.PRNGKey(seed), (size,), -2.0, 3.5).numpy()
    assert np.all(np.abs(got - want) <= np.spacing(np.float32(5.5)))


@pytest.mark.parametrize("seed", [0, 1, 7, 123456])
def test_gumbel_within_two_ulp(seed):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (32000,)))
    got = prng.gumbel(prng.PRNGKey(seed), (32000,)).numpy()
    tol = 2 * np.spacing(np.abs(want)) + 2 * np.float32(2.0**-23)
    assert np.all(np.abs(got - want) <= tol)
    assert np.mean(got == want) > 0.5


def test_batched_keys_follow_vmap():
    """A (B, 2) batch of keys: each row's split and draws are the JAX ones
    of that key (``jax.vmap``), as the per-row sampler takes them."""
    keys = jnp.stack([jax.random.PRNGKey(s) for s in (0, 5, 99, 2**31 - 1)])
    tk = prng.from_numpy(np.asarray(keys))
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 2))(keys))
    np.testing.assert_array_equal(prng.to_numpy(prng.split(tk, 2)), want)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (50,), jnp.uint32))(keys))
    np.testing.assert_array_equal(prng.to_numpy(prng.random_bits(tk, (50,))), want)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (50,)))(keys))
    np.testing.assert_array_equal(prng.uniform(tk, (50,)).numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("seed,data", [(0, 0), (11, 1), (5, 3), (2**31 + 7, 2**32 - 1),
                                       (42, 2**32 + 5), (9, -1)])
def test_fold_in_bit_equal(seed, data):
    """``fold_in`` of a seed's key, ``data`` taken mod 2^32 as JAX's uint32
    conversion takes it (the dp index a sharded sampled scan folds in)."""
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.fold_in(key, np.uint32(data % 2**32)))
    got = prng.to_numpy(prng.fold_in(prng.from_numpy(np.asarray(key)), data))
    np.testing.assert_array_equal(got, want)


@settings(max_examples=30, deadline=None)
@given(k1=st.integers(0, 2**32 - 1), k2=st.integers(0, 2**32 - 1),
       data=st.integers(0, 2**32 - 1))
def test_fold_in_any_key_bit_equal(k1, k2, data):
    key = np.array([k1, k2], np.uint32)
    want = np.asarray(jax.random.fold_in(jnp.asarray(key), np.uint32(data)))
    np.testing.assert_array_equal(prng.to_numpy(prng.fold_in(prng.from_numpy(key), data)), want)


def test_fold_in_batched_keys_follow_vmap():
    """A (B, 2) batch of keys and a (B,) tensor of data: each row's fold
    is the JAX one of that key and datum."""
    keys = jnp.stack([jax.random.PRNGKey(s) for s in (0, 5, 99, 2**31 - 1)])
    data = np.array([0, 1, 2, 3], np.uint32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(keys, data))
    got = prng.fold_in(prng.from_numpy(np.asarray(keys)), torch.tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(prng.to_numpy(got), want)


def test_split_chain_bit_equal():
    """Twenty splits in a row, carrying the first half, as a scan's steps
    do: the keys stay the JAX ones."""
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    for _ in range(20):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        np.testing.assert_array_equal(prng.to_numpy(tsub), np.asarray(jsub))
    np.testing.assert_array_equal(prng.to_numpy(tk), np.asarray(jk))


def test_keys_are_int64_words():
    key = prng.PRNGKey(2**32 - 1)
    assert key.dtype == torch.int64 and key.shape == (2,)
    assert int(key.max()) == 2**32 - 1
    bits = prng.random_bits(key, (1000,))
    assert int(bits.min()) >= 0 and int(bits.max()) < 2**32
