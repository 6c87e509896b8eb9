"""Port ring/sink indexing and cache geometry against the JAX package
(integer arithmetic: exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xalm_tpu.models.config import ModelConfig as JaxConfig
from xalm_tpu.runtime.cache import KVCache as JaxKVCache
from xalm_tpu.runtime.cache import ring_indices as jax_ring_indices
from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.runtime.cache import KVCache, ring_indices


@pytest.mark.parametrize("window", [16, 20, 256])
def test_ring_indices_match_across_wraps(window):
    pos = np.arange(0, 5 * window + 7, dtype=np.int32)
    got = ring_indices(torch.from_numpy(pos), window)
    want = jax_ring_indices(jnp.asarray(pos), window)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # batched positions wrap independently
    pb = np.array([[0, window - 1], [window, 3 * window + 1]], np.int32)
    for g, w in zip(ring_indices(torch.from_numpy(pb), window),
                    jax_ring_indices(jnp.asarray(pb), window)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window", [16, 20, 4096])
def test_plane_shape_padding(window):
    kw = dict(dim=64, hidden_dim=128, head_dim=16, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=32, max_seq_len=window, rope_theta=1e4, rotary_dim=16)
    shape = KVCache.plane_shape(ModelConfig(**kw), 3)
    assert shape == JaxKVCache.plane_shape(JaxConfig(**kw), 3)
    assert shape[3] % 32 == 0 and shape[3] >= window
    c = KVCache.init(ModelConfig(**kw), 3, torch.bfloat16)
    assert c.k.shape == shape and c.k.dtype == torch.bfloat16 and c.batch == 3
    assert not c.quantized and c.k_scale is None
    q = KVCache.init(ModelConfig(**kw), 1, torch.int8)
    want = JaxKVCache.init(JaxConfig(**kw), 1, jnp.int8)
    for got, ref in ((q.k, want.k), (q.v, want.v), (q.k_scale, want.k_scale),
                     (q.v_scale, want.v_scale)):
        assert got.shape == ref.shape and str(got.dtype).split(".")[-1] == str(ref.dtype)
        assert not got.any()  # zeroed: an unwritten row dequantises to 0
    assert q.quantized and q.nbytes() == want.nbytes()


def test_i8_kv_cache_shapes():
    """The counterpart of tests/test_quantized_kv.py::test_i8_kv_cache_shapes:
    int8 codes plus (L, B, KH, S) f32 scale planes, about half the bytes of
    an f16 cache (hd 16 here; at hd 128 the ratio is ~0.52)."""
    cfg = ModelConfig(dim=64, hidden_dim=128, head_dim=16, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=32, max_seq_len=256, rope_theta=1e4, rotary_dim=16)
    cache = KVCache.init(cfg, 1, torch.int8)
    assert cache.quantized and cache.k.dtype == torch.int8
    assert cache.k_scale.shape == cache.k.shape[:-1] and cache.k_scale.dtype == torch.float32
    assert cache.nbytes() < KVCache.init(cfg, 1, torch.float16).nbytes() * 0.75
    big = dict(vars(cfg), head_dim=128, rotary_dim=128, dim=512, hidden_dim=1024)
    ratio = KVCache.init(ModelConfig(**big), 1, torch.int8).nbytes() / KVCache.init(
        ModelConfig(**big), 1, torch.bfloat16).nbytes()
    assert abs(ratio - (0.5 + 2 / 128)) < 1e-9
