"""Attention kernels over the stacked StreamingLLM cache (CUDA source
``csrc/attention.cu``, whose note says what bounds each on the H100 and how
its design answers that):

- bf16 cache: ``kv_update`` (decode ring update), ``flash_decode`` and
  ``flash_prefill`` (replace ``xalm_tpu/ops/pallas_attention.py``'s
  ``_update_kernel``, ``_attn_kernel`` and ``_prefill_kernel``);
- int8 cache with per-row f32 scales: ``kv_update_q`` (quantised ring
  insert and sink re-rotation, one launch for ``_insert_q_kernel`` and
  ``_sink_q_kernel``) and ``flash_decode_q`` (``_attn_q_kernel``).
  ``quant_rows`` is the port's copy of ``_quant_rows_f32``.

Each wrapper launches its kernel for CUDA tensors and runs its ``*_plain``
version, the same function in plain PyTorch, for CPU tensors. Their shape
limits (head_dim 128, the GQA groups) live in the CUDA source, which
refuses other shapes. The cache (L, B, KH, S_phys, hd) and the scale planes
(L, B, KH, S_phys) are updated in place.
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
    "flash_decode",
    "flash_decode_plain",
    "flash_prefill",
    "flash_prefill_plain",
    "quant_rows",
    "kv_update_q",
    "kv_update_q_plain",
    "flash_decode_q",
    "flash_decode_q_plain",
]

# keys per tile of the plain prefill's online softmax: the kernel's PF_KT,
# so that p is rounded to bf16 at the same running max on both sides
_PREFILL_KEYS = 64
# key rows per chunk of the plain int8 flash-decode: the kernel's FD_CHUNK,
# so that p * v_scale is rounded to bf16 at the same chunk max on both sides
_DECODE_KEYS = 128
# flash-decode workspaces by (device, f32 elements), reused call after call
# on the one stream the port launches on
_WORKSPACE: dict[tuple, torch.Tensor] = {}


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


def _check_cache(what: str, cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int,
                 dtype=torch.bfloat16) -> None:
    _need(cache_k.is_cuda and cache_v.is_cuda, what, "caches must be on the card")
    _need(cache_k.dtype == dtype and cache_v.dtype == dtype, what,
          f"cache dtype {cache_k.dtype} (the kernel takes {dtype})")
    _need(cache_k.shape == cache_v.shape and cache_k.dim() == 5, what, "caches (L, B, KH, S, hd)")
    _need(cache_k.is_contiguous() and cache_v.is_contiguous(), what, "caches must be contiguous")
    _need(0 <= layer < cache_k.shape[0], what, f"layer {layer} out of range")


def _check_scales(what: str, cache_k: torch.Tensor, k_scale, v_scale) -> None:
    for t in (k_scale, v_scale):
        _need(t is not None and t.dtype == torch.float32 and t.shape == cache_k.shape[:-1]
              and t.is_contiguous() and t.device == cache_k.device, what,
              "an int8 cache needs contiguous (L, B, KH, S) f32 scale planes on its device")


def _layer_ptr(cache: torch.Tensor, layer: int) -> int:
    return cache.data_ptr() + layer * cache[0].numel() * cache.element_size()


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
    _check_cache(what, cache_k, cache_v, layer)
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
        sexp.data_ptr(), b, kh, s, hd, torch.cuda.current_stream(cache_k.device).cuda_stream,
    )
    build.check(err, what)
    build.LAUNCHES["kv_update"] += 1


# ------------------------------------------------------------------ kernel 3


def _workspace(lib, device, b: int, h: int, s: int) -> torch.Tensor:
    """The flash-decode chunk partials (both cache types), one per size."""
    n_work = lib.xq_flash_decode_workspace(b, h, s)
    work = _WORKSPACE.get((device, n_work))
    if work is None:
        work = _WORKSPACE[(device, n_work)] = torch.empty((n_work,), dtype=torch.float32,
                                                          device=device)
    return work


def flash_decode_plain(q, cache_k, cache_v, layer, kv_len) -> torch.Tensor:
    """GQA attention of q (B, H, hd) over the first kv_len slots of the
    layer's cache, f32 dots; kv_len == 0 rows give 0. -> (B, H*hd) f32."""
    kl = cache_k[layer].to(torch.float32)  # (B, KH, S, hd)
    vl = cache_v[layer].to(torch.float32)
    b, kh, s, hd = kl.shape
    h = q.shape[1]
    qg = q.to(torch.float32).reshape(b, kh, h // kh, hd) * (1.0 / math.sqrt(hd))
    scores = torch.matmul(qg, kl.transpose(-1, -2))  # (B, KH, G, S)
    live = torch.arange(s, device=q.device)[None, :] < kv_len[:, None]  # (B, S)
    live = live[:, None, None, :]
    scores = torch.where(live, scores, -math.inf)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(live, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vl) / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(b, h * hd)


def flash_decode(q, cache_k, cache_v, layer: int, kv_len) -> torch.Tensor:
    """Kernel 3 wrapper: q (B, H, hd) f32, kv_len (B,) int32 -> (B, H*hd)."""
    if not q.is_cuda:
        return flash_decode_plain(q, cache_k, cache_v, layer, kv_len)
    what = "flash_decode"
    _check_cache(what, cache_k, cache_v, layer)
    _, b, kh, s, hd = cache_k.shape
    h = q.shape[1]
    _need(q.dtype == torch.float32 and q.shape == (b, h, hd) and q.is_contiguous(), what,
          "q must be contiguous (B, H, hd) f32")
    _vec_i32(what, kv_len, b, q.device)
    lib = build.load_library("attention")
    work = _workspace(lib, q.device, b, h, s)
    out = torch.empty((b, h * hd), dtype=torch.float32, device=q.device)
    err = lib.xq_flash_decode(
        q.data_ptr(), _layer_ptr(cache_k, layer), _layer_ptr(cache_v, layer), kv_len.data_ptr(),
        work.data_ptr(), out.data_ptr(), b, h, kh, s, hd, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, what)
    build.LAUNCHES["flash_decode"] += 1
    return out


# ------------------------------------------------------------------ kernel 4


def flash_prefill_plain(q, cache_k, cache_v, layer, pos) -> torch.Tensor:
    """Causal attention of a T-row chunk q (B, T, H, hd) (already written to
    the cache at [pos, pos+T)): query i sees slots < pos + i + 1. bf16 caches
    take bf16 dots with an f32 online softmax over 64-key tiles, as the
    kernel runs it, p cast to bf16 at the running max before P.V; f32 and
    f16 caches take f32 math. -> (B, T, H*hd) f32."""
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


def flash_prefill(q, cache_k, cache_v, layer: int, pos) -> torch.Tensor:
    """Kernel 4 wrapper: q (B, T, H, hd) f32 rotated, pos (B,) int32 ->
    (B, T, H*hd) f32. The chunk must not wrap the ring."""
    if not q.is_cuda:
        return flash_prefill_plain(q, cache_k, cache_v, layer, pos)
    what = "flash_prefill"
    _check_cache(what, cache_k, cache_v, layer)
    _, b, kh, s, hd = cache_k.shape
    _, t, h, _ = q.shape
    _need(q.dtype == torch.float32 and q.shape == (b, t, h, hd) and q.is_contiguous(), what,
          "q must be contiguous (B, T, H, hd) f32")
    _vec_i32(what, pos, b, q.device)
    out = torch.empty((b, t, h * hd), dtype=torch.float32, device=q.device)
    lib = build.load_library("attention")
    err = lib.xq_flash_prefill(
        q.data_ptr(), _layer_ptr(cache_k, layer), _layer_ptr(cache_v, layer), pos.data_ptr(),
        out.data_ptr(), b, t, h, kh, s, hd, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, what)
    build.LAUNCHES["flash_prefill"] += 1
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
    _check_cache(what, cache_k, cache_v, layer, torch.int8)
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


def flash_decode_q_plain(q, cache_k, cache_v, k_scale, v_scale, layer, kv_len) -> torch.Tensor:
    """GQA attention of q (B, H, hd) over the first kv_len int8 rows of the
    layer, with the row scales factored out of both dots: scores =
    (bf16(q) . codes_k) * (k_scale * 1/sqrt(hd)); per 128-row chunk, as the
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
    scores = torch.matmul(qg, kl.transpose(-1, -2)) * kscale[:, :, None]  # (B, KH, G, S)
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


def flash_decode_q(q, cache_k, cache_v, k_scale, v_scale, layer: int, kv_len) -> torch.Tensor:
    """Kernel 7 wrapper: q (B, H, hd) f32 rotated (not pre-scaled), int8
    caches with their f32 scale planes, kv_len (B,) int32 -> (B, H*hd)."""
    if not q.is_cuda:
        return flash_decode_q_plain(q, cache_k, cache_v, k_scale, v_scale, layer, kv_len)
    what = "flash_decode_q"
    _check_cache(what, cache_k, cache_v, layer, torch.int8)
    _check_scales(what, cache_k, k_scale, v_scale)
    _, b, kh, s, hd = cache_k.shape
    h = q.shape[1]
    _need(q.dtype == torch.float32 and q.shape == (b, h, hd) and q.is_contiguous(), what,
          "q must be contiguous (B, H, hd) f32")
    _vec_i32(what, kv_len, b, q.device)
    lib = build.load_library("attention")
    work = _workspace(lib, q.device, b, h, s)
    out = torch.empty((b, h * hd), dtype=torch.float32, device=q.device)
    err = lib.xq_flash_decode_q(
        q.data_ptr(), _layer_ptr(cache_k, layer), _layer_ptr(cache_v, layer),
        _layer_ptr(k_scale, layer), _layer_ptr(v_scale, layer), kv_len.data_ptr(),
        work.data_ptr(), out.data_ptr(), b, h, kh, s, hd, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, what)
    build.LAUNCHES["flash_decode_q"] += 1
    return out
