"""Attention kernels over the stacked StreamingLLM cache (CUDA source
``csrc/attention.cu``, whose note says what bounds each on the H100 and how
its design answers that):

- bf16 or f32 cache: ``fused_decode_attention`` (the JAX function of that
  name: ``_update_kernel``'s ring update and ``_attn_kernel``'s
  flash-decode in one launch of kernel 3's cluster kernel; with kv_pos at
  the sentinel S and rotate 0 the attention alone), ``kv_update`` (the update alone, a
  launch of its own, for Gemma-2's capped path, which attends densely after
  it) and ``flash_prefill`` (``_prefill_kernel``; both caches,
  ``supported_cache_dtype``); the cache type is a template parameter of
  each, and an f32 cache's launches count under ``kv_update_f32``,
  ``flash_decode_f32`` and ``flash_prefill_f32``. f32 rounds nothing to
  bf16, as the TPU kernel's ``compute_dtype`` is f32 for an f32 cache:
  flash-prefill's two products run on the tensor cores in split TF32
  (three TF32 products a step, each within about 2^-18 of the f32
  product; its own tiles; against f64 as accurate as the plain version,
  which keeps f32 with TF32 off: ``csrc/hopper.cuh``);
- int8 cache with per-row f32 scales: ``fused_decode_attention_q`` (the
  JAX function of that name: ``_insert_q_kernel``, ``_sink_q_kernel`` and
  ``_attn_q_kernel`` in one launch of kernel 7's cluster kernel, which
  inserts the quantised row, re-rotates the sinks and attends),
  ``flash_decode_q`` (the same launch without the update) and
  ``kv_update_q`` (the insert and the rotation alone, a launch of their
  own, for the one caller that attends densely after them: Gemma-2's
  attention cap). ``quant_rows`` is the port's copy of ``_quant_rows_f32``.

Each wrapper launches its kernel for CUDA tensors and runs its ``*_plain``
version, the same function in plain PyTorch, for CPU tensors. Their shape
limits live in the CUDA source, which refuses other shapes: flash-decode,
its int8 form and flash-prefill take head_dim 96, 128 and 256 (Phi-3;
Llama, Mistral and Qwen; Gemma and Gemma-2) and GQA groups 1..8, the ring
updates any head_dim up to 1024 (a multiple of 32 for the int8 one). The
cache (L, B, KH, S_phys, hd) and the scale planes (L, B, KH, S_phys) are
updated in place.

None of the kernels applies Gemma-2's attention softcap (nor do the TPU
kernels): the forward sends capped attention to its dense path.
``flash_decode_plain`` and ``flash_decode_q_plain`` take ``attn_softcap``
for the plain version of the megakernel, which folds the cap in
(``softcap`` is the cap itself).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from xalm_tpu_torch.models.config import KV_SINKS
from xalm_tpu_torch.ops import build

__all__ = [
    "rope_cos_sin_plus1",
    "kv_update",
    "kv_update_plain",
    "flash_decode_plain",
    "fused_decode_attention",
    "fused_decode_attention_plain",
    "decode_row_owner",
    "flash_prefill",
    "flash_prefill_plain",
    "quant_rows",
    "kv_update_q",
    "kv_update_q_plain",
    "flash_decode_q",
    "flash_decode_q_plain",
    "fused_decode_attention_q",
    "fused_decode_attention_q_plain",
    "decode_q_plan",
    "decode_q_chunks",
    "softcap",
    "act_fn",
]

# keys per tile of the plain prefill's online softmax: the bf16 kernel's
# PF_KT at every head_dim, so that p is rounded to bf16 at the same running
# max on both sides
_PREFILL_KEYS = 64
# key rows per chunk of the plain int8 flash-decode: the kernel's FQ_CHUNK,
# so that p * v_scale is rounded to bf16 at the same chunk max on both sides
_DECODE_KEYS = 128


def rope_cos_sin_plus1(freqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Lane-expanded cos/sin of a +1-position rotation: entry i carries
    cos/sin(freq_{i//2}); freq 0 (the unrotated tail) yields identity.
    (hd,) f32 each."""
    return (
        np.repeat(np.cos(freqs), 2).astype(np.float32),
        np.repeat(np.sin(freqs), 2).astype(np.float32),
    )


def _rope_lane(v: torch.Tensor, cexp: torch.Tensor, sexp: torch.Tensor) -> torch.Tensor:
    """out = v*cexp + swap(v)*sexp with swap[2j] = -v[2j+1], swap[2j+1] = v[2j]."""
    pairs = v.reshape(*v.shape[:-1], -1, 2)
    sw = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(v.shape)
    return v * cexp + sw * sexp


def _need(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


FLOAT_CACHES = (torch.bfloat16, torch.float32)  # the float caches kernels 2-4 take


def _check_cache(what: str, cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int,
                 dtypes=FLOAT_CACHES) -> int:
    """Check the (L, B, KH, S, hd) cache planes; returns 1 for an f32
    cache, 0 otherwise (the kernels' cache-type argument)."""
    _need(cache_k.is_cuda and cache_v.is_cuda, what, "caches must be on the card")
    _need(cache_k.dtype in dtypes and cache_v.dtype == cache_k.dtype, what,
          f"cache dtype {cache_k.dtype} (the kernel takes {' or '.join(map(str, dtypes))})")
    _need(cache_k.shape == cache_v.shape and cache_k.dim() == 5, what, "caches (L, B, KH, S, hd)")
    _need(cache_k.is_contiguous() and cache_v.is_contiguous(), what, "caches must be contiguous")
    _need(0 <= layer < cache_k.shape[0], what, f"layer {layer} out of range")
    return int(cache_k.dtype == torch.float32)


def _count(name: str, f32: int) -> None:
    build.LAUNCHES[name + ("_f32" if f32 else "")] += 1


def _check_scales(what: str, cache_k: torch.Tensor, k_scale, v_scale) -> None:
    for t in (k_scale, v_scale):
        _need(t is not None and t.dtype == torch.float32 and t.shape == cache_k.shape[:-1]
              and t.is_contiguous() and t.device == cache_k.device, what,
              "an int8 cache needs contiguous (L, B, KH, S) f32 scale planes on its device")


def _layer_ptr(cache: torch.Tensor, layer: int) -> int:
    return cache.data_ptr() + layer * cache.stride(0) * cache.element_size()


def _vec_i32(what: str, t: torch.Tensor, b: int, device) -> None:
    _need(t.dtype == torch.int32 and t.shape == (b,) and t.is_contiguous() and t.device == device,
          what, "index vectors must be contiguous (B,) int32 on the cache's device")


# ------------------------------------------------------------------ kernel 2


def kv_update_plain(cache_k, cache_v, layer, k_new, v_new, kv_pos, rotate, cexp, sexp) -> None:
    """Insert the (B, KH, hd) rows at kv_pos (dropped when kv_pos >= S_phys),
    then rotate the KV_SINKS sink keys of rows with ``rotate`` set by one
    position. In place."""
    ck, cv = cache_k[layer], cache_v[layer]  # (B, KH, S, hd) views
    b, s = ck.shape[0], ck.shape[2]
    bi = torch.arange(b, device=ck.device)
    idx = torch.clamp(kv_pos.long(), max=s - 1)
    keep = (kv_pos < s)[:, None, None]
    ck[bi, :, idx] = torch.where(keep, k_new.to(ck.dtype), ck[bi, :, idx])
    cv[bi, :, idx] = torch.where(keep, v_new.to(cv.dtype), cv[bi, :, idx])
    sinks = ck[:, :, :KV_SINKS]
    rotated = _rope_lane(sinks.to(torch.float32), cexp, sexp).to(ck.dtype)
    ck[:, :, :KV_SINKS] = torch.where((rotate != 0)[:, None, None, None], rotated, sinks)


def kv_update(cache_k, cache_v, layer: int, k_new, v_new, kv_pos, rotate, cexp, sexp) -> None:
    """Kernel 2 wrapper: in-place ring insert + sink rotation of one layer.
    k_new/v_new (B, KH, hd) f32; kv_pos/rotate (B,) int32; cexp/sexp (hd,)."""
    if not cache_k.is_cuda:
        return kv_update_plain(cache_k, cache_v, layer, k_new, v_new, kv_pos, rotate, cexp, sexp)
    what = "kv_update"
    f32 = _check_cache(what, cache_k, cache_v, layer)
    _, b, kh, s, hd = cache_k.shape
    for t in (k_new, v_new):
        _need(t.dtype == torch.float32 and t.shape == (b, kh, hd) and t.is_contiguous()
              and t.device == cache_k.device, what, "new rows must be contiguous (B, KH, hd) f32")
    for t in (cexp, sexp):
        _need(t.dtype == torch.float32 and t.shape == (hd,) and t.device == cache_k.device,
              what, "cexp/sexp must be (hd,) f32")
    _vec_i32(what, kv_pos, b, cache_k.device)
    _vec_i32(what, rotate, b, cache_k.device)
    lib = build.load_library("attention")
    err = lib.xq_kv_update(
        _layer_ptr(cache_k, layer), _layer_ptr(cache_v, layer), k_new.data_ptr(),
        v_new.data_ptr(), kv_pos.data_ptr(), rotate.data_ptr(), cexp.data_ptr(),
        sexp.data_ptr(), b, kh, s, hd, f32, torch.cuda.current_stream(cache_k.device).cuda_stream,
    )
    build.check(err, what)
    _count("kv_update", f32)


# ------------------------------------------------------------------ kernel 3


def softcap(v: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2's softcap, tanh(v / cap) * cap (cap 0: v as it is), in the
    kernels' form: v times the f32 reciprocal of cap (the JAX forward's
    dense path divides, one f32 rounding from it)."""
    return torch.tanh(v * (1.0 / cap)) * cap if cap else v


def act_fn(act: str, gate: torch.Tensor) -> torch.Tensor:
    """The GLU's activation ``ModelConfig.act``: SiLU, or gelu's tanh
    approximation (Gemma), as the megakernel's FFN epilogue computes it."""
    return F.gelu(gate, approximate="tanh") if act == "gelu" else F.silu(gate)


def flash_decode_plain(q, cache_k, cache_v, layer, kv_len, attn_softcap: float = 0.0):
    """GQA attention of q (B, H, hd) over the first kv_len slots of the
    layer's cache, f32 dots, the scores capped by ``attn_softcap`` (0: none);
    kv_len == 0 rows give 0. -> (B, H*hd) f32."""
    kl = cache_k[layer].to(torch.float32)  # (B, KH, S, hd)
    vl = cache_v[layer].to(torch.float32)
    b, kh, s, hd = kl.shape
    h = q.shape[1]
    qg = q.to(torch.float32).reshape(b, kh, h // kh, hd) * (1.0 / math.sqrt(hd))
    scores = softcap(torch.matmul(qg, kl.transpose(-1, -2)), attn_softcap)  # (B, KH, G, S)
    live = torch.arange(s, device=q.device)[None, :] < kv_len[:, None]  # (B, S)
    live = live[:, None, None, :]
    scores = torch.where(live, scores, -math.inf)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(live, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vl) / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(b, h * hd)


# Kernel 3's launch (csrc/attention.cu fc_splits, fc_nr): P blocks a (batch,
# kv head), one cluster, about one block an SM over the grid and at most
# DECODE_MAX_SPLITS; each stage of its ring holds DECODE_WARPS * NR key rows,
# NR the rows a warp scores at once (NR * G, G rounded up to a power of two,
# at most 32; a stage's K rows within DECODE_PLANE bytes)
DECODE_MAX_SPLITS, DECODE_WARPS, DECODE_PLANE, DECODE_STAGES = 16, 8, 16384, 3


def decode_plan(b: int, kh: int, g: int, hd: int, f32: bool, sms: int) -> tuple[int, int, int]:
    """Kernel 3's launch for B = b, KH = kh, GQA group g and head_dim hd over
    a bf16 cache (an f32 one with ``f32``) on a card of ``sms`` SMs: (blocks
    a (batch, kv head), which form one cluster; key rows a stage; stages).
    The launcher's own plan, which reads the device's SM count, is
    ``xq_flash_decode_plan``; the card's tests hold the two equal."""
    splits = max(1, min(DECODE_MAX_SPLITS, sms // max(1, b * kh)))
    gp = 1 << (g - 1).bit_length()
    fit = DECODE_PLANE // (DECODE_WARPS * hd * (4 if f32 else 2))
    nr = min(1 << (min(fit, 8).bit_length() - 1), 32 // gp)
    return splits, DECODE_WARPS * nr, DECODE_STAGES


def decode_rows(kv_len: int, s: int, splits: int) -> list[tuple[int, int]]:
    """The key rows [r0, r1) of each of kernel 3's ``splits`` blocks of one
    (batch, kv head) at kv_len n (clamped to [0, s]), as each block computes
    them on the card: block p takes [p n // P, (p + 1) n // P), so every
    block has a row once n >= P."""
    n = min(max(kv_len, 0), s)
    return [(p * n // splits, (p + 1) * n // splits) for p in range(splits)]


def decode_row_owner(row: int, kv_len: int, s: int, splits: int) -> int:
    """The block of kernel 3's ``splits`` that writes cache row ``row`` of
    one (batch, kv head) in the launch that also updates the ring
    (``fused_decode_attention``), as each block's producer warp decides it
    on the card: the block whose rows (``decode_rows``) hold it, and for a
    row at or past n = kv_len clamped to [0, s], which no block reads, the
    last block. So the block that writes a row is the only one that reads
    it."""
    for p, (r0, r1) in enumerate(decode_rows(kv_len, s, splits)):
        if r0 <= row < r1:
            return p
    return splits - 1


def _check_decode(what: str, q, cache_k, cache_v, layer: int, kv_len) -> int:
    f32 = _check_cache(what, cache_k, cache_v, layer)
    _, b, kh, s, hd = cache_k.shape
    _need(q.dtype == torch.float32 and q.shape == (b, q.shape[1], hd) and q.is_contiguous(),
          what, "q must be contiguous (B, H, hd) f32")
    _vec_i32(what, kv_len, b, q.device)
    return f32


def fused_decode_attention_plain(q, cache_k, cache_v, layer, k_new, v_new, kv_pos, kv_len,
                                 rotate, cexp, sexp) -> torch.Tensor:
    """``kv_update_plain`` (the insert and the sink rotation, in place), then
    ``flash_decode_plain`` over the updated layer. -> (B, H*hd)."""
    kv_update_plain(cache_k, cache_v, layer, k_new, v_new, kv_pos, rotate, cexp, sexp)
    return flash_decode_plain(q, cache_k, cache_v, layer, kv_len)


def fused_decode_attention(q, cache_k, cache_v, layer: int, k_new, v_new, kv_pos, kv_len,
                           rotate, cexp, sexp) -> torch.Tensor:
    """Kernels 2 and 3 in one launch (the JAX ``fused_decode_attention``
    over a bf16 or f32 cache): the (B, KH, hd) f32 rows k_new/v_new stored
    into the layer at kv_pos (dropped at kv_pos >= S_phys), the sink keys
    re-rotated where ``rotate`` is set (cexp/sexp (hd,)), then q (B, H, hd)
    attends over the first kv_len rows -> (B, H*hd). Each row written is
    written by the one block that reads it (``decode_row_owner``). The cache
    is updated in place; counted under ``flash_decode`` (``_f32``)."""
    if not q.is_cuda:
        return fused_decode_attention_plain(q, cache_k, cache_v, layer, k_new, v_new, kv_pos,
                                            kv_len, rotate, cexp, sexp)
    what = "fused_decode_attention"
    f32 = _check_decode(what, q, cache_k, cache_v, layer, kv_len)
    _, b, kh, s, hd = cache_k.shape
    h = q.shape[1]
    for t in (k_new, v_new):
        _need(t.dtype == torch.float32 and t.shape == (b, kh, hd) and t.is_contiguous()
              and t.device == cache_k.device, what, "new rows must be contiguous (B, KH, hd) f32")
    for t in (cexp, sexp):
        _need(t.dtype == torch.float32 and t.shape == (hd,) and t.is_contiguous()
              and t.device == cache_k.device, what, "cexp/sexp must be contiguous (hd,) f32")
    _vec_i32(what, kv_pos, b, cache_k.device)
    _vec_i32(what, rotate, b, cache_k.device)
    lib = build.load_library("attention")
    out = torch.empty((b, h * hd), dtype=torch.float32, device=q.device)
    err = lib.xq_fused_decode_attention(
        q.data_ptr(), _layer_ptr(cache_k, layer), _layer_ptr(cache_v, layer), k_new.data_ptr(),
        v_new.data_ptr(), kv_pos.data_ptr(), rotate.data_ptr(), cexp.data_ptr(), sexp.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), b, h, kh, s, hd, 1.0 / math.sqrt(hd), f32,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, what)
    _count("flash_decode", f32)
    return out


# ------------------------------------------------------------------ kernel 4


def flash_prefill_plain(q, cache_k, cache_v, layer, pos) -> torch.Tensor:
    """Causal attention of a T-row chunk q (B, T, H, hd) (already written to
    the cache at [pos, pos+T)): query i sees slots < pos + i + 1. bf16 caches
    take bf16 dots with an f32 online softmax over 64-key tiles, as the
    kernel runs it, p cast to bf16 at the running max before P.V; f32 (and
    f16) caches take f32 math throughout, nothing rounded (the f32 kernel
    tiles 32 keys at head_dim 256: only the order of its sums differs).
    -> (B, T, H*hd) f32."""
    kl, vl = cache_k[layer], cache_v[layer]  # (B, KH, S, hd)
    b, kh, s, hd = kl.shape
    _, t, h, _ = q.shape
    g = h // kh
    cd = torch.bfloat16 if kl.dtype == torch.bfloat16 else torch.float32
    f32 = torch.float32
    qg = q.reshape(b, t, kh, g, hd).permute(0, 2, 1, 3, 4).reshape(b, kh, t * g, hd)
    qg = qg.to(cd).to(f32)
    qpos = pos[:, None].to(torch.int64) + torch.arange(t, device=q.device).repeat_interleave(g)
    m = torch.full((b, kh, t * g, 1), -math.inf, dtype=f32, device=q.device)
    l = torch.zeros((b, kh, t * g, 1), dtype=f32, device=q.device)
    acc = torch.zeros((b, kh, t * g, hd), dtype=f32, device=q.device)
    kend = min(int(pos.max()) + t, s)
    for k0 in range(0, kend, _PREFILL_KEYS):
        k1 = min(k0 + _PREFILL_KEYS, s)
        sc = torch.matmul(qg, kl[:, :, k0:k1].to(cd).to(f32).transpose(-1, -2)) * (
            1.0 / math.sqrt(hd))
        live = (torch.arange(k0, k1, device=q.device)[None, None, :]
                <= qpos[:, :, None])[:, None]  # (B, 1, T*G, keys)
        sc = torch.where(live, sc, -math.inf)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.where(m_new == -math.inf, 1.0, torch.exp(m - m_new))
        p = torch.where(live, torch.exp(sc - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(cd).to(f32), vl[:, :, k0:k1].to(cd).to(f32))
        m = m_new
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(b, kh, t, g, hd).permute(0, 2, 1, 3, 4).reshape(b, t, h * hd)


# The flash prefill's blocks, as csrc/attention.cu launches them: over a
# bf16 cache two consumer warpgroups of 64 query rows, each 64 // G whole
# positions; over an f32 cache one block of 128 query rows (64 at head_dim
# 256, where f32 tiles fill shared memory), 16 a warp; the head dims it is
# built for, and the GQA groups
PREFILL_WG_ROWS = 64
PREFILL_F32_ROWS = {96: 128, 128: 128, 256: 64}
HEAD_DIMS = (96, 128, 256)
MAX_GROUP = 8


def prefill_check(t: int, g: int, hd: int) -> None:
    """Raises ValueError for a shape the flash prefill does not take (hd
    outside 96, 128, 256; g outside 1..8; t < 1), before any launch."""
    _need(hd in HEAD_DIMS, "flash_prefill", f"head_dim {hd} (the kernel is built for "
          f"{', '.join(map(str, HEAD_DIMS))})")
    _need(1 <= g <= MAX_GROUP, "flash_prefill", f"GQA group {g} (1..{MAX_GROUP})")
    _need(t >= 1, "flash_prefill", f"a chunk of {t} rows")


def prefill_plan(t: int, g: int, hd: int, f32: bool = False) -> tuple[int, list[int]]:
    """The flash prefill's blocks for a t-row chunk at GQA group g over a
    bf16 cache (an f32 one with ``f32``): (query positions a block, the
    blocks' first positions in launch order). A block holds 2 * (64 // g)
    whole positions (f32: PREFILL_F32_ROWS[hd] // g; rows position * g +
    head, and for a g that does not divide the rows the last ones stay
    empty), and the blocks start last tile first, the tiles with the most
    visible keys before the causal tail. The launcher's own plan is
    ``xq_flash_prefill_plan``; the card's tests hold the two equal. Raises
    as ``prefill_check``."""
    prefill_check(t, g, hd)
    tq = PREFILL_F32_ROWS[hd] // g if f32 else 2 * (PREFILL_WG_ROWS // g)
    return tq, list(range(0, t, tq))[::-1]


def flash_prefill(q, cache_k, cache_v, layer: int, pos) -> torch.Tensor:
    """Kernel 4 wrapper: q (B, T, H, hd) f32 rotated, pos (B,) int32 ->
    (B, T, H*hd) f32. The chunk must not wrap the ring."""
    if not q.is_cuda:
        return flash_prefill_plain(q, cache_k, cache_v, layer, pos)
    what = "flash_prefill"
    f32 = _check_cache(what, cache_k, cache_v, layer)
    _, b, kh, s, hd = cache_k.shape
    _, t, h, _ = q.shape
    _need(q.dtype == torch.float32 and q.shape == (b, t, h, hd) and q.is_contiguous(), what,
          "q must be contiguous (B, T, H, hd) f32")
    _need(h % kh == 0, what, f"{h} query heads over {kh} kv heads")
    _vec_i32(what, pos, b, q.device)
    prefill_check(t, h // kh, hd)
    out = torch.empty((b, t, h * hd), dtype=torch.float32, device=q.device)
    lib = build.load_library("attention")
    err = lib.xq_flash_prefill(
        q.data_ptr(), _layer_ptr(cache_k, layer), _layer_ptr(cache_v, layer), pos.data_ptr(),
        out.data_ptr(), b, t, h, kh, s, hd, 1.0 / math.sqrt(hd), f32,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, what)
    _count("flash_prefill", f32)
    return out


# ------------------------------------------------------- int8 cache: kernels 5-7


def quant_rows(vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 rows -> (int8 codes, f32 per-row scale) over the last axis: scale
    absmax/127 (1 for an all-zero row), codes round(v / scale) half to even,
    clipped to +-127 (``_quant_rows_f32``; the scale without its last axis)."""
    amax = vals.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient the kernels compute
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0), torch.ones_like(amax))
    codes = torch.clamp(torch.round(vals / scale), -127, 127).to(torch.int8)
    return codes, scale[..., 0]


def kv_update_q_plain(cache_k, cache_v, k_scale, v_scale, layer, k_new, v_new, kv_pos, rotate,
                      cexp, sexp) -> None:
    """Quantise the (B, KH, hd) f32 rows and insert codes and scales at
    kv_pos (dropped when kv_pos >= S_phys); then, for rows with ``rotate``
    set, dequantise the KV_SINKS sink keys with their scales, rotate them
    by one position and requantise them (codes and scales). V sinks stay.
    In place."""
    ck, cv = cache_k[layer], cache_v[layer]  # (B, KH, S, hd) views
    ks, vs = k_scale[layer], v_scale[layer]  # (B, KH, S)
    b, s = ck.shape[0], ck.shape[2]
    bi = torch.arange(b, device=ck.device)
    idx = torch.clamp(kv_pos.long(), max=s - 1)
    keep = (kv_pos < s)[:, None]
    for c, sc, new in ((ck, ks, k_new), (cv, vs, v_new)):
        codes, scale = quant_rows(new.to(torch.float32))
        c[bi, :, idx] = torch.where(keep[..., None], codes, c[bi, :, idx])
        sc[bi, :, idx] = torch.where(keep, scale, sc[bi, :, idx])
    sinks = ck[:, :, :KV_SINKS].to(torch.float32) * ks[:, :, :KV_SINKS, None]
    codes, scale = quant_rows(_rope_lane(sinks, cexp, sexp))
    live = (rotate != 0)[:, None, None]
    ck[:, :, :KV_SINKS] = torch.where(live[..., None], codes, ck[:, :, :KV_SINKS])
    ks[:, :, :KV_SINKS] = torch.where(live, scale, ks[:, :, :KV_SINKS])


def kv_update_q(cache_k, cache_v, k_scale, v_scale, layer: int, k_new, v_new, kv_pos, rotate,
                cexp, sexp) -> None:
    """Kernels 5 + 6 wrapper, one launch: in-place quantised ring insert and
    sink re-rotation of one layer. int8 caches (L, B, KH, S, hd), f32 scale
    planes (L, B, KH, S); k_new/v_new (B, KH, hd) f32; kv_pos/rotate (B,)
    int32; cexp/sexp (hd,)."""
    if not cache_k.is_cuda:
        return kv_update_q_plain(cache_k, cache_v, k_scale, v_scale, layer, k_new, v_new, kv_pos,
                                 rotate, cexp, sexp)
    what = "kv_update_q"
    _check_cache(what, cache_k, cache_v, layer, (torch.int8,))
    _check_scales(what, cache_k, k_scale, v_scale)
    _, b, kh, s, hd = cache_k.shape
    for t in (k_new, v_new):
        _need(t.dtype == torch.float32 and t.shape == (b, kh, hd) and t.is_contiguous()
              and t.device == cache_k.device, what, "new rows must be contiguous (B, KH, hd) f32")
    for t in (cexp, sexp):
        _need(t.dtype == torch.float32 and t.shape == (hd,) and t.device == cache_k.device,
              what, "cexp/sexp must be (hd,) f32")
    _vec_i32(what, kv_pos, b, cache_k.device)
    _vec_i32(what, rotate, b, cache_k.device)
    lib = build.load_library("attention")
    err = lib.xq_kv_update_q(
        _layer_ptr(cache_k, layer), _layer_ptr(cache_v, layer), _layer_ptr(k_scale, layer),
        _layer_ptr(v_scale, layer), k_new.data_ptr(), v_new.data_ptr(), kv_pos.data_ptr(),
        rotate.data_ptr(), cexp.data_ptr(), sexp.data_ptr(), b, kh, s, hd,
        torch.cuda.current_stream(cache_k.device).cuda_stream,
    )
    build.check(err, what)
    build.LAUNCHES["kv_update_q"] += 1


def flash_decode_q_plain(q, cache_k, cache_v, k_scale, v_scale, layer, kv_len,
                         attn_softcap: float = 0.0) -> torch.Tensor:
    """GQA attention of q (B, H, hd) over the first kv_len int8 rows of the
    layer, with the row scales factored out of both dots: scores =
    (bf16(q) . codes_k) * (k_scale * 1/sqrt(hd)), capped by ``attn_softcap``
    (0: none); per 128-row chunk, as the
    kernel splits the rows, p = exp(scores - chunk max), l = sum p, acc =
    bf16(p * v_scale) . codes_v; the chunks combine as flash partials.
    kv_len == 0 rows give 0. -> (B, H*hd) f32."""
    f32 = torch.float32
    kl = cache_k[layer].to(f32)  # (B, KH, S, hd) codes, exact in f32
    vl = cache_v[layer].to(f32)
    b, kh, s, hd = kl.shape
    h = q.shape[1]
    g = h // kh
    qg = q.to(torch.bfloat16).to(f32).reshape(b, kh, g, hd)
    kscale = k_scale[layer] * (1.0 / math.sqrt(hd))  # (B, KH, S)
    scores = softcap(torch.matmul(qg, kl.transpose(-1, -2)) * kscale[:, :, None], attn_softcap)
    live = (torch.arange(s, device=q.device)[None, :] < kv_len[:, None])[:, None, None]
    n = -(-s // _DECODE_KEYS)
    pad = n * _DECODE_KEYS - s

    def chunks(t, fill):  # (..., S) -> (..., n, _DECODE_KEYS)
        return F.pad(t, (0, pad), value=fill).reshape(*t.shape[:-1], n, _DECODE_KEYS)

    livec = chunks(live, False)
    sc = chunks(torch.where(live, scores, -math.inf), -math.inf)
    m = sc.amax(dim=-1, keepdim=True)  # (B, KH, G, n, 1); -inf for a chunk past kv_len
    p = torch.where(livec, torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * chunks(v_scale[layer], 0.0)[:, :, None]).to(torch.bfloat16).to(f32)
    vc = F.pad(vl, (0, 0, 0, pad)).reshape(b, kh, 1, n, _DECODE_KEYS, hd)
    acc = torch.matmul(pv.unsqueeze(-2), vc).squeeze(-2)  # (B, KH, G, n, hd)
    # combine the chunks: weights exp(m_c - max_c m), dead chunks weigh 0
    mx = m.amax(dim=-2, keepdim=True)
    w = torch.where(torch.isfinite(m), torch.exp(m - torch.where(torch.isfinite(mx), mx, 0.0)), 0.0)
    l = (w * l).sum(dim=-2)  # (B, KH, G, 1)
    acc = (w * acc).sum(dim=-2)  # (B, KH, G, hd)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(b, h * hd)


def fused_decode_attention_q_plain(q, cache_k, cache_v, k_scale, v_scale, layer, k_new, v_new,
                                   kv_pos, kv_len, rotate, cexp, sexp) -> torch.Tensor:
    """``kv_update_q_plain`` (the insert and the sink re-rotation, in place),
    then ``flash_decode_q_plain`` over the updated layer. -> (B, H*hd)."""
    kv_update_q_plain(cache_k, cache_v, k_scale, v_scale, layer, k_new, v_new, kv_pos, rotate,
                      cexp, sexp)
    return flash_decode_q_plain(q, cache_k, cache_v, k_scale, v_scale, layer, kv_len)


# Kernel 7's launch (csrc/attention.cu fq_splits, fq_slots): P blocks a
# (batch, kv head), one cluster, kernel 3's count capped at the window's
# 128-row chunks; a ring of 4 slots of a chunk's K or V plane (3 at head_dim
# 256)
DECODE_Q_SLOTS = {96: 4, 128: 4, 256: 3}


def decode_q_plan(b: int, kh: int, g: int, hd: int, s: int, sms: int) -> tuple[int, int, int]:
    """Kernel 7's launch for B = b, KH = kh, GQA group g, head_dim hd and an
    s-row window on a card of ``sms`` SMs: (blocks a (batch, kv head), which
    form one cluster; key rows a chunk; ring slots). The launcher's own
    plan, which reads the device's SM count, is ``xq_flash_decode_q_plan``;
    the card's tests hold the two equal."""
    splits = min(decode_plan(b, kh, g, hd, False, sms)[0], -(-s // _DECODE_KEYS))
    return max(1, splits), _DECODE_KEYS, DECODE_Q_SLOTS[hd]


def decode_q_chunks(kv_len: int, s: int, splits: int) -> list[tuple[int, int]]:
    """The 128-row chunks [c0, c1) of each of kernel 7's ``splits`` blocks
    of one (batch, kv head) at kv_len n (clamped to [0, s]), as each block
    computes them on the card: of C = ceil(n / 128) chunks, block p takes
    [p C // P, (p + 1) C // P)."""
    n = min(max(kv_len, 0), s)
    c = -(-n // _DECODE_KEYS)
    return [(p * c // splits, (p + 1) * c // splits) for p in range(splits)]


def _decode_q(what: str, q, cache_k, cache_v, k_scale, v_scale, layer: int, kv_len,
              update=None) -> torch.Tensor:
    """Kernel 7's launch (``xq_flash_decode_q``) on CUDA tensors, with
    ``update`` = (k_new, v_new, kv_pos, rotate, cexp, sexp) kernels 5-6's
    insert and sink re-rotation in the same launch."""
    _check_cache(what, cache_k, cache_v, layer, (torch.int8,))
    _check_scales(what, cache_k, k_scale, v_scale)
    _, b, kh, s, hd = cache_k.shape
    h = q.shape[1]
    _need(q.dtype == torch.float32 and q.shape == (b, h, hd) and q.is_contiguous(), what,
          "q must be contiguous (B, H, hd) f32")
    _vec_i32(what, kv_len, b, q.device)
    ptrs = [None] * 6
    if update is not None:
        k_new, v_new, kv_pos, rotate, cexp, sexp = update
        for t in (k_new, v_new):
            _need(t.dtype == torch.float32 and t.shape == (b, kh, hd) and t.is_contiguous()
                  and t.device == cache_k.device, what,
                  "new rows must be contiguous (B, KH, hd) f32")
        for t in (cexp, sexp):
            _need(t.dtype == torch.float32 and t.shape == (hd,) and t.is_contiguous()
                  and t.device == cache_k.device, what, "cexp/sexp must be contiguous (hd,) f32")
        _vec_i32(what, kv_pos, b, cache_k.device)
        _vec_i32(what, rotate, b, cache_k.device)
        ptrs = [t.data_ptr() for t in update]
    lib = build.load_library("attention")
    out = torch.empty((b, h * hd), dtype=torch.float32, device=q.device)
    err = lib.xq_flash_decode_q(
        q.data_ptr(), _layer_ptr(cache_k, layer), _layer_ptr(cache_v, layer),
        _layer_ptr(k_scale, layer), _layer_ptr(v_scale, layer), *ptrs, kv_len.data_ptr(),
        out.data_ptr(), b, h, kh, s, hd, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, what)
    build.LAUNCHES["flash_decode_q"] += 1
    return out


def flash_decode_q(q, cache_k, cache_v, k_scale, v_scale, layer: int, kv_len) -> torch.Tensor:
    """Kernel 7 wrapper: q (B, H, hd) f32 rotated (not pre-scaled), int8
    caches with their f32 scale planes, kv_len (B,) int32 -> (B, H*hd).
    One launch (``decode_q_plan``); kv_len stays on the card."""
    if not q.is_cuda:
        return flash_decode_q_plain(q, cache_k, cache_v, k_scale, v_scale, layer, kv_len)
    return _decode_q("flash_decode_q", q, cache_k, cache_v, k_scale, v_scale, layer, kv_len)


def fused_decode_attention_q(q, cache_k, cache_v, k_scale, v_scale, layer: int, k_new, v_new,
                             kv_pos, kv_len, rotate, cexp, sexp) -> torch.Tensor:
    """Kernels 5-7 in one launch (the JAX ``fused_decode_attention_q``): the
    (B, KH, hd) f32 rows k_new/v_new quantised into the layer at kv_pos
    (dropped at kv_pos >= S_phys), the sinks re-rotated where ``rotate`` is
    set (cexp/sexp (hd,)), then q (B, H, hd) attends over the first kv_len
    rows -> (B, H*hd). The cache and scale planes are updated in place;
    counted under ``flash_decode_q``."""
    if not q.is_cuda:
        return fused_decode_attention_q_plain(q, cache_k, cache_v, k_scale, v_scale, layer,
                                              k_new, v_new, kv_pos, kv_len, rotate, cexp, sexp)
    return _decode_q("flash_decode_q", q, cache_k, cache_v, k_scale, v_scale, layer, kv_len,
                     (k_new, v_new, kv_pos, rotate, cexp, sexp))
