"""Threefry-2x32 keys and draws: the port's counterpart of ``jax.random``'s
legacy uint32 keys under ``jax_threefry_partitionable = True`` (the default
of the JAX the package is held against), bit for bit:

- ``PRNGKey(seed)``: the key ``[seed >> 32, seed & 0xffffffff]`` of a
  32-bit seed, ``[0, seed mod 2^32]`` (``jax.random.PRNGKey`` truncates a
  Python int to 32 bits);
- ``split(key, n)``: the hash of the counters (0, i), i < n, as the
  fold-like ``_threefry_split_foldlike`` takes them;
- ``fold_in(key, data)``: the hash of the counter (0, data), the JAX
  ``threefry_2x32(key, threefry_seed(uint32(data)))``;
- ``random_bits(key, shape)``: 32-bit draws, the hash of the 64-bit
  counter of each element's flat index, its two words xor-ed;
- ``uniform`` and ``gumbel``: ``jax.random``'s ``_uniform`` (23 random
  mantissa bits under the exponent of 1.0, minus 1) and ``_gumbel``'s
  "low" mode, -log(-log(u)) of a uniform on [tiny, 1).

A key is an int64 tensor whose last axis holds the two uint32 words (the
values 0 .. 2^32 - 1; torch has no full uint32 arithmetic), so a (B, 2)
tensor holds one key a row and every function takes a batch of keys and
broadcasts over it. Everything is elementwise integer arithmetic on the
keys' device, with no host read and no Python loop over rows, so a CUDA
graph captures it (``runtime/graphs.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform", "gumbel", "from_numpy", "to_numpy"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny
_ONE_BITS = 0x3F800000  # 1.0f


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words (k1, k2), all int64 tensors of uint32 values that
    broadcast together (``jax._src.prng._threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & _M32
    x2 = (x2 + k2) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (jax.random's name)
    """The (2,) key of ``jax.random.PRNGKey(seed)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of the 64-bit counters 0 .. n - 1."""
    c = torch.arange(n, dtype=torch.int64, device=device)
    return c >> 32, c & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """Keys (..., 2) -> (..., num, 2): ``jax.random.split(key, num)`` of
    each key (``jax.vmap`` of it over a batch)."""
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Keys (..., 2) -> (..., 2): ``jax.random.fold_in(key, data)`` of each
    key, ``data`` an int (taken mod 2^32, as JAX's uint32 conversion) or an
    int tensor that broadcasts with the keys' lead."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit draws of ``shape`` under each key: keys (..., 2) -> (...,
    *shape) int64 of uint32 values, the JAX ``random_bits`` of each key."""
    shape = tuple(shape)
    hi, lo = _counters(math.prod(shape), key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms on [minval, maxval) of ``shape`` under each key (the JAX
    ``_uniform`` at float32): keys (..., 2) -> (..., *shape). Bit-equal on
    [0, 1) and [tiny, 1), where the affine map is exact; elsewhere within
    an ulp (XLA may fuse its multiply-add)."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference rounded to f32 on the host, as JAX's
    # f32 constants are (no host-to-device copy: a graph captures this)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * span + lo, lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gumbel f32 draws of ``shape`` under each key (the JAX
    ``_gumbel``, mode "low"): -log(-log(u)), u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def from_numpy(keys) -> torch.Tensor:
    """uint32 keys (a numpy array or a JAX key array's values) -> int64."""
    return torch.from_numpy(np.asarray(keys, dtype=np.uint32).astype(np.int64))


def to_numpy(keys: torch.Tensor):
    """int64 keys -> a uint32 numpy array (the JAX legacy key layout)."""
    return keys.detach().cpu().numpy().astype(np.uint32)
