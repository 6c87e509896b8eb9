"""Kernel 9: the whole-step decode megakernel (replaces
``xalm_tpu/ops/fused_decode.py::_kernel`` through ``fused_decode_step``; CUDA
source ``csrc/fused_decode.cu``, whose note says what bounds it on the H100
and how its design answers that).

One call runs every layer of a t = 1 decode step over B <= 8 rows: rmsnorm
and the i8 wqkv matmul, rope, the ring insert and sink rotation, flash
attention over the cache, wo, rmsnorm, w13 with SiLU * up, w2, both
residual adds. Optional folds, as in the JAX function:

- embed: the kernel gathers the bf16 embed row of ``token`` and computes
  the rope trig at ``pos`` itself (``x0``/``cexp_p``/``sexp_p`` unused);
- head: the final norm, the i8 classifier ``wcls`` and a first-occurrence
  greedy argmax (returns ``(x, logits, token, ck, cv)``).

It takes the i8 body with per-row scales and a float cache, or an int8
cache with its per-row f32 scale planes (``k_scale``/``v_scale``, the
JAX kernel's ``quant`` branch: the K and V rows quantised on insert, the
sinks dequantised, rotated and requantised, the scales factored out of the
attention dots). W8A8 (``a8``) and packed-q4 bodies and the family folds
belong to later slices and are refused. ``fused_decode_step`` launches the
kernel for CUDA caches (bf16, or int8 with scales) and raises on anything
it does not take; for CPU caches it runs ``fused_decode_step_plain``, the
same function in plain PyTorch. Both update the caches (and scale planes)
in place and return them.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from xalm_tpu_torch.models.params import ffn_chunk, split_qkv_rows, split_w13_rows
from xalm_tpu_torch.ops import attention as attn_ops
from xalm_tpu_torch.ops import build
from xalm_tpu_torch.ops.qmatmul import qmatmul_plain

__all__ = [
    "MAX_B",
    "fused_step_supported",
    "embed_fold_supported",
    "wcls_fold_supported",
    "fused_decode_step",
    "fused_decode_step_plain",
]

MAX_B = 8  # rows per step: the kernel keeps B accumulators per weight row pair
# workspaces by (device, bytes), reused call after call on the one stream
# the port launches on; zeroed once (the grid barrier's word starts at 0)
_WORKSPACE: dict[tuple, torch.Tensor] = {}


def _is_i8_rows(qw) -> bool:
    return qw.values.dtype == torch.int8 and qw.scale is not None


def fused_step_supported(cfg, params, cache_k, batch: int, t: int, k_scale=None,
                         a8: bool = False) -> bool:
    """Does a (batch, t) step take the megakernel path? t = 1, 1 <= batch
    <= MAX_B, a dense i8 body with per-row scales, and a bf16 or f32 cache,
    or an int8 cache with its scale planes (``k_scale``). W8A8 and packed
    q4 are later slices."""
    if t != 1 or not 1 <= batch <= MAX_B or a8:
        return False
    if k_scale is not None:
        if cache_k.dtype != torch.int8:
            return False
    elif cache_k.dtype not in (torch.bfloat16, torch.float32):
        return False
    lp = params.layers
    if getattr(lp, "w13", None) is None:  # MoE FFN
        return False
    return all(_is_i8_rows(qw) and not getattr(qw, "q4group", 0)
               for qw in (lp.wqkv, lp.wo, lp.w13, lp.w2))


def embed_fold_supported(cfg, params) -> bool:
    """Can the step gather the embed row itself? A plain bf16 table."""
    e = params.embed
    return e.values.dtype == torch.bfloat16 and e.scale is None and e.values.shape[1] == cfg.dim


def wcls_fold_supported(cfg, params) -> bool:
    """Can the step run the head too? An i8 per-row-scaled (V, dim) head
    (``Engine(wcls_i8=True)`` or an i8 container head)."""
    w = params.wcls
    return _is_i8_rows(w) and w.values.dim() == 2 and w.values.shape[1] == cfg.dim


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_decode_step: {msg}")


def _check(params, cfg, x0, cache_k, cache_v, wcls, out_norm, embed, token, pos, freqs,
           k_scale, v_scale, a8) -> None:
    _need(not a8, "W8A8 decode is a later slice")
    lp = params.layers
    for name in ("wqkv", "wo", "w13", "w2"):
        qw = getattr(lp, name)
        _need(_is_i8_rows(qw) and not getattr(qw, "q4group", 0),
              f"{name} must be int8 with per-row scales (no q4)")
    _need(cache_k.shape == cache_v.shape and cache_k.dim() == 5, "caches (L, B, KH, S, hd)")
    if k_scale is not None or v_scale is not None:
        _need(cache_k.dtype == cache_v.dtype == torch.int8,
              f"scale planes with a {cache_k.dtype} cache (they belong to an int8 KV cache)")
        for t in (k_scale, v_scale):
            _need(t is not None and t.dtype == torch.float32 and t.shape == cache_k.shape[:-1],
                  "an int8 KV cache needs (L, B, KH, S) f32 k_scale and v_scale")
    else:
        _need(cache_k.dtype == cache_v.dtype and cache_k.dtype in (torch.bfloat16, torch.float32),
              f"cache dtype {cache_k.dtype} (a bf16 or f32 cache, or int8 KV with its scales)")
    b = cache_k.shape[1]
    _need(1 <= b <= MAX_B, f"batch {b} (1..{MAX_B})")
    if wcls is not None:
        _need(out_norm is not None and _is_i8_rows(wcls) and wcls.values.shape[1] == cfg.dim,
              "the head fold needs an i8 per-row-scaled (V, dim) wcls and out_norm")
    if embed is not None:
        _need(token is not None and pos is not None and freqs is not None,
              "the embed fold needs token, pos and freqs")
        _need(embed.values.dtype == torch.bfloat16 and embed.scale is None,
              "the embed fold needs a plain bf16 table")
    else:
        _need(x0 is not None, "x0 is required without the embed fold")


def fused_decode_step_plain(params, cfg, x0, cache_k, cache_v, kv_pos, kv_len, rotate,
                            cexp_p, sexp_p, cexp1, sexp1, wcls=None, out_norm=None, embed=None,
                            token=None, pos=None, freqs=None, k_scale=None, v_scale=None,
                            a8: bool = False):
    """Plain version, built from the port's plain pieces with the kernel's
    numerics: rmsnorm outputs, attn and act are cast to bf16 before their
    i8 matmuls (exact products, f32 sums, scale after). A float cache: q is
    f32 and pre-scaled by 1/sqrt(hd) (inside ``flash_decode_plain``); the K
    and V rows are rounded to the cache type; scores and p are f32 over the
    f32-converted cache rows; the sink rows are rotated from the cache-typed
    window and rounded. An int8 cache (``k_scale``/``v_scale``): the rows
    go through ``kv_update_q_plain`` and the attention through
    ``flash_decode_q_plain``. The argmax takes the first maximum. In place
    on the caches; returns (x, ck, cv) or (x, logits, token (B,) int32, ck,
    cv), with (..., ks, vs) after them for an int8 cache."""
    _check(params, cfg, x0, cache_k, cache_v, wcls, out_norm, embed, token, pos, freqs,
           k_scale, v_scale, a8)
    dev = cache_k.device
    lp = params.layers
    L, b, kh, _, hd = cache_k.shape
    g = cfg.n_heads // cfg.n_kv_heads
    f32 = torch.float32
    i32 = lambda t: torch.as_tensor(t).to(device=dev, dtype=torch.int32).reshape(b)  # noqa: E731
    kv_pos, kv_len, rotate = i32(kv_pos), i32(kv_len), i32(rotate)
    if embed is not None:
        x = embed.values[i32(token).long()].to(f32)
        fr = torch.as_tensor(freqs).to(device=dev, dtype=f32).reshape(1, -1)
        ang = i32(pos).to(f32)[:, None] * fr
        cexp = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)
        sexp = torch.repeat_interleave(torch.sin(ang), 2, dim=-1)
    else:
        x, cexp, sexp = (torch.as_tensor(t).to(device=dev, dtype=f32).reshape(b, -1)
                         for t in (x0, cexp_p, sexp_p))
    c1, s1 = (torch.as_tensor(t).to(device=dev, dtype=f32).reshape(hd) for t in (cexp1, sexp1))
    clip = cfg.qkv_clip if math.isfinite(cfg.qkv_clip) else None
    c13 = ffn_chunk(cfg.hidden_dim)
    eps = cfg.norm_eps

    def rope(v):  # (B, heads, hd): v*cexp + swap(v)*sexp
        return attn_ops._rope_lane(v, cexp[:, None], sexp[:, None])

    for layer in range(L):
        qkv = qmatmul_plain(x, lp.wqkv.values, layer, norm_w=lp.attn_norm, norm_eps=eps,
                            scale=lp.wqkv.scale)
        q, k, v = split_qkv_rows(qkv, kh, g, hd)
        if clip is not None:
            q, k, v = (torch.clamp(z, -clip, clip) for z in (q, k, v))
        q = rope(q.reshape(b, kh * g, hd))
        k = rope(k.reshape(b, kh, hd))
        if k_scale is not None:
            attn_ops.kv_update_q_plain(cache_k, cache_v, k_scale, v_scale, layer, k,
                                       v.reshape(b, kh, hd), kv_pos, rotate, c1, s1)
            attn = attn_ops.flash_decode_q_plain(q, cache_k, cache_v, k_scale, v_scale, layer,
                                                 kv_len)
        else:
            attn_ops.kv_update_plain(cache_k, cache_v, layer, k, v.reshape(b, kh, hd), kv_pos,
                                     rotate, c1, s1)
            attn = attn_ops.flash_decode_plain(q, cache_k, cache_v, layer, kv_len)
        x = x + qmatmul_plain(attn, lp.wo.values, layer, scale=lp.wo.scale)
        gate, up = split_w13_rows(
            qmatmul_plain(x, lp.w13.values, layer, norm_w=lp.mlp_norm, norm_eps=eps,
                          scale=lp.w13.scale), c13)
        x = x + qmatmul_plain(F.silu(gate) * up, lp.w2.values, layer, scale=lp.w2.scale)
    caches = (cache_k, cache_v) + ((k_scale, v_scale) if k_scale is not None else ())
    if wcls is None:
        return (x, *caches)
    logits = qmatmul_plain(x, wcls.values[None], 0, norm_w=out_norm.reshape(1, -1),
                           norm_eps=eps, scale=wcls.scale[None])
    return (x, logits, torch.argmax(logits, dim=-1).to(torch.int32), *caches)


def _workspace(lib, device, b, cfg, s) -> torch.Tensor:
    nbytes = lib.xq_fused_decode_workspace(b, cfg.dim, cfg.n_kv_heads,
                                           cfg.n_heads // cfg.n_kv_heads, s, cfg.hidden_dim)
    work = _WORKSPACE.get((device, nbytes))
    if work is None:
        work = _WORKSPACE[(device, nbytes)] = torch.zeros((nbytes,), dtype=torch.uint8,
                                                          device=device)
    return work


def _dev_f32(t, dev, n: int, what: str) -> torch.Tensor:
    t = torch.as_tensor(t)
    if t.numel() != n:
        raise ValueError(f"fused_decode_step: {what} must hold {n} values")
    return t.to(device=dev, dtype=torch.float32).reshape(n).contiguous()


def fused_decode_step(params, cfg, x0, cache_k, cache_v, kv_pos, kv_len, rotate, cexp_p,
                      sexp_p, cexp1, sexp1, wcls=None, out_norm=None, embed=None, token=None,
                      pos=None, freqs=None, k_scale=None, v_scale=None, a8: bool = False):
    """One decode step of the whole layer stack. Arguments and returns are
    those of the JAX ``fused_decode_step``, except ``token``, which comes
    back (B,) int32. x0 (B, N) f32; caches (L, B, KH, S, hd), updated in
    place, and for an int8 cache its (L, B, KH, S) f32 scale planes
    ``k_scale``/``v_scale``, updated in place and returned after the caches;
    kv_pos/kv_len/rotate (B,) int (kv_pos == S drops the write);
    cexp_p/sexp_p (B, hd); cexp1/sexp1 (hd,) or (1, hd). The small step
    inputs may lie on the CPU: they reach the card as one int32 tensor."""
    if not cache_k.is_cuda:
        return fused_decode_step_plain(
            params, cfg, x0, cache_k, cache_v, kv_pos, kv_len, rotate, cexp_p, sexp_p, cexp1,
            sexp1, wcls=wcls, out_norm=out_norm, embed=embed, token=token, pos=pos, freqs=freqs,
            k_scale=k_scale, v_scale=v_scale, a8=a8)
    _check(params, cfg, x0, cache_k, cache_v, wcls, out_norm, embed, token, pos, freqs,
           k_scale, v_scale, a8)
    dev = cache_k.device
    lp = params.layers
    L, b, kh, s, hd = cache_k.shape
    quant = k_scale is not None
    _need(cache_k.dtype in (torch.bfloat16, torch.int8),
          f"cache dtype {cache_k.dtype} (the kernel takes bf16, or int8 with scales)")
    planes = (cache_k, cache_v) + ((k_scale, v_scale) if quant else ())
    _need(all(t.is_contiguous() and t.device == dev for t in planes),
          "caches and scale planes must be contiguous on one card")
    tensors = [lp.attn_norm, lp.mlp_norm]
    for qw in (lp.wqkv, lp.wo, lp.w13, lp.w2):
        tensors += [qw.values, qw.scale]
    if wcls is not None:
        tensors += [wcls.values, wcls.scale, out_norm]
    if embed is not None:
        tensors.append(embed.values)
    for t in tensors:
        _need(t.device == dev and t.is_contiguous(), "weights must be contiguous on the card")
    for t in (lp.attn_norm, lp.mlp_norm, lp.wqkv.scale, lp.wo.scale, lp.w13.scale,
              lp.w2.scale) + ((wcls.scale, out_norm) if wcls is not None else ()):
        _need(t.dtype == torch.float32, "norms and scales must be f32")

    def ints(t):
        return torch.as_tensor(t).to(dtype=torch.int32, device="cpu").reshape(-1)

    zeros = torch.zeros((b,), dtype=torch.int32)
    fold_e = embed is not None
    parts = [ints(kv_pos), ints(kv_len), ints(rotate),
             ints(token) if fold_e else zeros, ints(pos) if fold_e else zeros]
    _need(all(p.numel() == b for p in parts), f"step inputs must hold B={b} values each")
    meta = torch.cat(parts).to(dev, non_blocking=True)  # one small copy to the card

    if fold_e:
        x0_p = cexp_p_p = sexp_p_p = None
        fr = _dev_f32(freqs, dev, hd // 2, "freqs")
    else:
        x0_c = _dev_f32(x0, dev, b * cfg.dim, "x0")
        ce = _dev_f32(cexp_p, dev, b * hd, "cexp_p")
        se = _dev_f32(sexp_p, dev, b * hd, "sexp_p")
        x0_p, cexp_p_p, sexp_p_p, fr = x0_c.data_ptr(), ce.data_ptr(), se.data_ptr(), None
    c1 = _dev_f32(cexp1, dev, hd, "cexp1")
    s1 = _dev_f32(sexp1, dev, hd, "sexp1")

    lib = build.load_library("fused_decode")
    work = _workspace(lib, dev, b, cfg, s)
    xout = torch.empty((b, cfg.dim), dtype=torch.float32, device=dev)
    v = wcls.values.shape[0] if wcls is not None else 0
    logits = torch.empty((b, v), dtype=torch.float32, device=dev) if v else None
    tok = torch.empty((b,), dtype=torch.int32, device=dev) if v else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    ptrs = [
        meta.data_ptr(), x0_p, cexp_p_p, sexp_p_p, c1.data_ptr(), s1.data_ptr(), ptr(fr),
        ptr(embed.values) if fold_e else None, lp.attn_norm.data_ptr(), lp.mlp_norm.data_ptr(),
        lp.wqkv.values.data_ptr(), lp.wqkv.scale.data_ptr(), lp.wo.values.data_ptr(),
        lp.wo.scale.data_ptr(), lp.w13.values.data_ptr(), lp.w13.scale.data_ptr(),
        lp.w2.values.data_ptr(), lp.w2.scale.data_ptr(),
        ptr(out_norm) if v else None, ptr(wcls.values) if v else None,
        ptr(wcls.scale) if v else None, cache_k.data_ptr(), cache_v.data_ptr(),
        xout.data_ptr(), ptr(logits), ptr(tok), work.data_ptr(), ptr(k_scale), ptr(v_scale),
    ]
    dims = [L, b, cfg.dim, kh, cfg.n_heads // kh, hd, cfg.hidden_dim, s, v,
            ffn_chunk(cfg.hidden_dim), 2 if quant else 1]  # the cache kind: 1 bf16, 2 int8
    clip = float(cfg.qkv_clip) if math.isfinite(cfg.qkv_clip) else math.inf
    err = lib.xq_fused_decode(
        ctypes.cast((ctypes.c_void_p * len(ptrs))(*ptrs), ctypes.c_void_p),
        ctypes.cast((ctypes.c_int * len(dims))(*dims), ctypes.c_void_p),
        float(cfg.norm_eps), clip, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "fused_decode_step")
    build.LAUNCHES["fused_decode"] += 1
    caches = (cache_k, cache_v) + ((k_scale, v_scale) if quant else ())
    if v:
        return (xout, logits, tok, *caches)
    return (xout, *caches)
