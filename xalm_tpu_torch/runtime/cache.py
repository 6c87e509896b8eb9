"""Device-resident KV cache with StreamingLLM sink + ring indexing
(counterpart of ``xalm_tpu/runtime/cache.py``).

- ``KV_SINKS=2`` attention-sink tokens stay pinned in slots [0, 2) once
  ``pos >= max_seq_len``.
- The other slots form a ring: ``kv_pos = kv_sink + (pos - kv_sink) %
  (max_seq_len - kv_sink)``; attention spans ``kv_len = min(pos + 1,
  max_seq_len)`` slots.

Layout (L, B, KH, S_phys, hd), head-major: each kv head's history is one
contiguous (S_phys, hd) stripe. An int8 cache stores each row as int8 codes
plus a per-row f32 scale (absmax/127, the `i8` weight scheme: row = codes *
scale) in (L, B, KH, S_phys) planes; the planes start at 0, so an unwritten
row dequantises to 0. Unlike the JAX cache, which is immutable and donated,
the port updates these tensors in place.
"""

from __future__ import annotations

import dataclasses

import torch

from xalm_tpu_torch.models.config import KV_SINKS, ModelConfig

__all__ = ["KVCache", "ring_indices", "KV_SINKS"]


def ring_indices(pos: torch.Tensor, max_seq_len: int):
    """(kv_sink, kv_pos, kv_len) int32 tensors for per-sequence positions."""
    pos = pos.to(torch.int32)
    wrapped = pos >= max_seq_len
    kv_sink = torch.where(wrapped, KV_SINKS, 0).to(torch.int32)
    ring = max_seq_len - kv_sink
    kv_pos = kv_sink + torch.remainder(pos - kv_sink, ring)
    kv_len = torch.clamp(pos + 1, max=max_seq_len)
    return kv_sink, kv_pos.to(torch.int32), kv_len.to(torch.int32)


@dataclasses.dataclass
class KVCache:
    """Float KV cache (f16/bf16/f32) or int8 codes with per-row scales."""

    k: torch.Tensor  # (L, B, n_kv_heads, S_phys, head_dim)
    v: torch.Tensor
    k_scale: torch.Tensor | None = None  # (L, B, n_kv_heads, S_phys) f32, int8 caches only
    v_scale: torch.Tensor | None = None

    @staticmethod
    def plane_shape(cfg: ModelConfig, batch: int) -> tuple[int, ...]:
        """(L, B, K, S_phys, hd): the physical window is padded to a
        multiple of 32 rows; rows >= max_seq_len are never attended, and
        the kv_pos == max_seq_len dropped-write sentinel lands in one."""
        s_pad = (cfg.max_seq_len + 31) // 32 * 32
        return (cfg.n_layers, batch, cfg.n_kv_heads, s_pad, cfg.head_dim)

    @classmethod
    def init(cls, cfg: ModelConfig, batch: int, dtype=torch.float16, device="cpu") -> "KVCache":
        shape = cls.plane_shape(cfg, batch)
        zeros = lambda sh, dt: torch.zeros(sh, dtype=dt, device=device)  # noqa: E731
        if dtype == torch.int8:
            return cls(k=zeros(shape, dtype), v=zeros(shape, dtype),
                       k_scale=zeros(shape[:-1], torch.float32),
                       v_scale=zeros(shape[:-1], torch.float32))
        return cls(k=zeros(shape, dtype), v=zeros(shape, dtype))

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    def nbytes(self) -> int:
        planes = (self.k, self.v) + ((self.k_scale, self.v_scale) if self.quantized else ())
        return sum(t.nelement() * t.element_size() for t in planes)
