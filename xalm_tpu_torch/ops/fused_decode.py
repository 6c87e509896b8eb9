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

It takes the i8 body with per-row scales and a bf16 or f32 cache (the f32
rows and rotated sinks stored unrounded; ``csrc/fused_decode_f32.cu``, a
library of its own, launches counted under ``fused_decode_f32`` beside the
body's), or an int8 cache with its per-row f32 scale planes
(``k_scale``/``v_scale``, the JAX kernel's ``quant`` branch: the K and V
rows quantised on insert, the sinks dequantised, rotated and requantised,
the scales factored out of the attention dots). An f16 cache is none of
them, as in the JAX gate. Its weight phases run one of three bodies:

- the i8 body with bf16 activations (the default);
- ``a8=True`` (W8A8 decode, the JAX kernel's ``_a8dot``): each phase's f32
  input row (the normed x, attn, act, and the normed x of an i8 head) is
  quantised per row to int8 codes (``quant_rows``), the dots are s8 x s8,
  then times the row scale and x's scale;
- a packed-q4 body (``q4group`` on the four weights, which implies ``a8``;
  the JAX kernel's ``_q4dot``): the same codes against the packed rows, one
  exact dot per group times its (row, group) scale, summed in group order,
  times x's scale. The group scales stay in the container's (L, D, K/g)
  layout.

The family folds ride along, read from ``params.layers`` and ``cfg`` as
the JAX kernel reads them:

- Qwen2's qkv bias (``bqkv``, added to each qkv row after its scale, before
  the clip);
- Qwen3's per-head q/k RMS norms (``q_norm``/``k_norm``, over the hd lanes
  of each query head and of the K head, after the clip and before rope,
  with ``cfg.norm_eps``; V is not normed);
- Gemma's embed scale (``cfg.embed_scale``: the embed fold's rows times it;
  an ``x0`` comes scaled already) and gelu (``cfg.act == "gelu"``: the
  tanh approximation in place of SiLU);
- Gemma-2's attention softcap (``cfg.attn_softcap``: each score after the
  1/sqrt(hd) scale becomes tanh(s / c) * c), logit softcap
  (``cfg.logit_softcap``: each logit of the head fold, before the argmax)
  and post-norms (``post_attn_norm``/``post_mlp_norm``: the wo and w2
  outputs RMS-normed before their residual adds).

The kernel takes head_dim 128 and 256; ``fused_step_supported`` sends
other head dims (Phi-3's 96) on the card to the per-layer kernels, as the
JAX gate refuses ``head_dim % 128`` on the TPU. Unlike the JAX kernel, which
asserts q_dim == dim with post-norms (every published Gemma-2 has q_dim !=
dim), the kernel takes any q_dim. ``fused_decode_step`` launches the kernel
for CUDA caches (bf16, f32, or int8 with scales) and raises on anything it
does not take; for CPU caches it runs ``fused_decode_step_plain``, the same
function in plain PyTorch (any even head_dim). Both update the caches (and
scale planes) in place and return them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from xalm_tpu_torch.models.params import QWeight, ffn_chunk, split_qkv_rows, split_w13_rows
from xalm_tpu_torch.ops import attention as attn_ops
from xalm_tpu_torch.ops import build
from xalm_tpu_torch.ops.qmatmul import qmatmul_plain

__all__ = [
    "MAX_B",
    "fused_step_supported",
    "cache_supported",
    "head_dim_supported",
    "embed_fold_supported",
    "wcls_fold_supported",
    "fused_decode_step",
    "fused_decode_step_plain",
]

MAX_B = 8  # rows per step: the kernel keeps B accumulators per weight row pair
HEAD_DIMS = (128, 256)  # the head dims the kernel takes
# workspaces by (device, bytes), reused call after call on the one stream
# the port launches on; zeroed once (the grid barrier's word starts at 0)
_WORKSPACE: dict[tuple, torch.Tensor] = {}


def _is_i8_rows(qw) -> bool:
    return qw.values.dtype == torch.int8 and qw.scale is not None


def _q4_body(lp) -> int:
    """The body's q4 group, 0 for an int8 body; -1 where the four weights
    do not share one."""
    groups = {qw.q4group for qw in (lp.wqkv, lp.wo, lp.w13, lp.w2)}
    return groups.pop() if len(groups) == 1 else -1


def head_dim_supported(head_dim: int, on_card: bool) -> bool:
    """On the card the kernel's head dims (128, 256); on the CPU, where the
    plain version runs, any even head_dim (the JAX gate likewise refuses
    ``head_dim % 128`` only on the TPU)."""
    return head_dim in HEAD_DIMS if on_card else head_dim % 2 == 0


def cache_supported(dtype: torch.dtype, quantized: bool) -> bool:
    """The caches the megakernel takes, on the card as on the CPU (where the
    plain version runs): an int8 cache with its scale planes (``quantized``),
    or a bf16 or f32 one, the JAX gate's three; never f16."""
    if quantized:
        return dtype == torch.int8
    return dtype in attn_ops.FLOAT_CACHES


def fused_step_supported(cfg, params, cache_k, batch: int, t: int, k_scale=None,
                         a8: bool = False) -> bool:
    """Does a (batch, t) step take the megakernel path? t = 1, 1 <= batch
    <= MAX_B, a dense int8 body with per-row scales (or packed q4 with group
    scales; every family fold folds in), a head_dim the kernel takes where
    the weights lie (``head_dim_supported``), and a cache it takes there
    (``cache_supported``; ``k_scale`` marks an int8 cache's scale planes).
    A q4 body needs ``a8``, one group size on all four weights and a group
    that is a multiple of 128: the JAX gate's rules. Its 48 MB scale budget is a rule of the TPU's
    VMEM and is not carried over; the kernel's own limits are in csrc/ (the
    wrapper raises past them)."""
    if t != 1 or not 1 <= batch <= MAX_B:
        return False
    lp = params.layers
    on_card = lp.wqkv.values.is_cuda
    if not cache_supported(cache_k.dtype, k_scale is not None):
        return False
    if getattr(lp, "w13", None) is None:  # MoE FFN
        return False
    if not all(_is_i8_rows(qw) for qw in (lp.wqkv, lp.wo, lp.w13, lp.w2)):
        return False
    if not head_dim_supported(cfg.head_dim, on_card):
        return False
    q4 = _q4_body(lp)
    return q4 == 0 or (q4 > 0 and a8 and q4 % 128 == 0)


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
    lp = params.layers
    for name in ("wqkv", "wo", "w13", "w2"):
        _need(_is_i8_rows(getattr(lp, name)),
              f"{name} must be int8 with per-row (or q4 group) scales")
    q4 = _q4_body(lp)
    _need(q4 >= 0, "a q4 body needs one group size on wqkv, wo, w13 and w2")
    _need(not q4 or a8, "the q4 body needs int8 activations (a8)")
    L, dq = lp.wqkv.values.shape[:2]
    _need(lp.bqkv is None or tuple(lp.bqkv.shape) == (L, dq), f"bqkv must be (L, {dq})")
    _need((lp.q_norm is None) == (lp.k_norm is None), "q_norm and k_norm come together")
    for t in (lp.q_norm, lp.k_norm):
        _need(t is None or tuple(t.shape) == (L, cfg.head_dim),
              f"q_norm and k_norm must be (L, {cfg.head_dim})")
    _need((lp.post_attn_norm is None) == (lp.post_mlp_norm is None),
          "post_attn_norm and post_mlp_norm come together")
    for t in (lp.post_attn_norm, lp.post_mlp_norm):
        _need(t is None or tuple(t.shape) == (L, cfg.dim),
              f"post_attn_norm and post_mlp_norm must be (L, {cfg.dim})")
    _need(cache_k.shape == cache_v.shape and cache_k.dim() == 5, "caches (L, B, KH, S, hd)")
    if k_scale is not None or v_scale is not None:
        _need(cache_k.dtype == cache_v.dtype == torch.int8,
              f"scale planes with a {cache_k.dtype} cache (they belong to an int8 KV cache)")
        for t in (k_scale, v_scale):
            _need(t is not None and t.dtype == torch.float32 and t.shape == cache_k.shape[:-1],
                  "an int8 KV cache needs (L, B, KH, S) f32 k_scale and v_scale")
    else:
        _need(cache_k.dtype == cache_v.dtype and cache_k.dtype in attn_ops.FLOAT_CACHES,
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
    i8 matmuls (exact products, f32 sums, scale after); the qkv bias after
    the scale, the q/k norms in f32 after the clip; with ``a8`` or a
    q4 body they are quantised per row instead, through ``qmatmul_plain``'s
    a8 and q4 branches (the i8 head too). The embed fold's rows times
    ``cfg.embed_scale``; gelu(tanh) or SiLU; the attention softcap on the
    scaled scores, the post-norms on the f32 wo and w2 outputs, the logit
    softcap on the f32 logits before the argmax. A float cache: q is
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
        x = embed.values[i32(token).long()].to(f32) * cfg.embed_scale
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

    def mm(xin, qw, layer, norm_w=None):
        """One weight phase: bf16 activations, or under a8 / q4 the f32 row
        (normed first) quantised per row."""
        if not (a8 or qw.q4group):
            return qmatmul_plain(xin, qw.values, layer, norm_w=norm_w,
                                 norm_eps=eps if norm_w is not None else None, scale=qw.scale)
        if norm_w is not None:
            ms = torch.mean(xin * xin, dim=-1, keepdim=True)
            xin = xin * torch.rsqrt(ms + eps) * norm_w[layer]
        return qmatmul_plain(xin, qw.values, layer, scale=qw.scale, q4_group=qw.q4group,
                             a8=not qw.q4group)

    def hnorm(v, w):  # the RMS norm over the last axis: Qwen3's per head, Gemma-2's post-norms
        return v * torch.rsqrt(torch.mean(v * v, dim=-1, keepdim=True) + eps) * w

    def post(proj, norms, layer):  # Gemma-2's post-norm of a projection (none: as it is)
        return proj if norms is None else hnorm(proj, norms[layer])

    cap = float(cfg.attn_softcap)

    for layer in range(L):
        qkv = mm(x, lp.wqkv, layer, lp.attn_norm)
        if lp.bqkv is not None:
            qkv = qkv + lp.bqkv[layer]
        q, k, v = split_qkv_rows(qkv, kh, g, hd)
        if clip is not None:
            q, k, v = (torch.clamp(z, -clip, clip) for z in (q, k, v))
        q, k = q.reshape(b, kh * g, hd), k.reshape(b, kh, hd)
        if lp.q_norm is not None:
            q, k = hnorm(q, lp.q_norm[layer]), hnorm(k, lp.k_norm[layer])
        q, k = rope(q), rope(k)
        if k_scale is not None:
            attn_ops.kv_update_q_plain(cache_k, cache_v, k_scale, v_scale, layer, k,
                                       v.reshape(b, kh, hd), kv_pos, rotate, c1, s1)
            attn = attn_ops.flash_decode_q_plain(q, cache_k, cache_v, k_scale, v_scale, layer,
                                                 kv_len, attn_softcap=cap)
        else:
            attn_ops.kv_update_plain(cache_k, cache_v, layer, k, v.reshape(b, kh, hd), kv_pos,
                                     rotate, c1, s1)
            attn = attn_ops.flash_decode_plain(q, cache_k, cache_v, layer, kv_len,
                                               attn_softcap=cap)
        x = x + post(mm(attn, lp.wo, layer), lp.post_attn_norm, layer)
        gate, up = split_w13_rows(mm(x, lp.w13, layer, lp.mlp_norm), c13)
        x = x + post(mm(attn_ops.act_fn(cfg.act, gate) * up, lp.w2, layer), lp.post_mlp_norm, layer)
    caches = (cache_k, cache_v) + ((k_scale, v_scale) if k_scale is not None else ())
    if wcls is None:
        return (x, *caches)
    logits = mm(x, QWeight(wcls.values[None], wcls.scale[None]), 0, out_norm.reshape(1, -1))
    logits = attn_ops.softcap(logits, float(cfg.logit_softcap))
    return (x, logits, torch.argmax(logits, dim=-1).to(torch.int32), *caches)


# The kernel's deal of a GEMV phase's rows (csrc/fused_decode.cu: walk_pairs,
# pair_rows, the staged columns of gemv_phase, prefetch_pairs), mirrored so
# that the CPU tests can hold the L2 prefetch to the rows each block streams
MK_WARPS, MK_SMEM = 8, 64 * 1024


def pair_rows(p: int, c13: int) -> tuple[int, int]:
    """The output rows of pair p: (2p, 2p + 1), or for the chunk-interleaved
    w13 (c13 > 0) the gate row of chunk p // c13 and its up row c13 later."""
    if c13 > 0:
        c, i = divmod(p, c13)
        return c * 2 * c13 + i, c * 2 * c13 + i + c13
    return 2 * p, 2 * p + 1


def phase_chunk(body: str, k: int, b: int, group: int = 0) -> tuple[int, int]:
    """(columns a walk step spans, columns of the walk) of a GEMV phase of
    contraction k at batch b: the bf16 body stages b rows of bf16, a8 of
    int8 codes, q4 the packed half rows (beside the high groups' terms);
    the walk stages everything at once where the chunk covers it."""
    if body == "q4":
        hterm = MK_WARPS * 2 * MAX_B * (k // 2 // group) * 4
        return (MK_SMEM - hterm) // (2 * b) // group * group, k // 2
    per = MK_SMEM // 2 if body == "bf16" else MK_SMEM  # bf16 activations or int8 codes
    return per // b // 512 * 512, k


def walk_pairs(d: int, k: int, chunk: int, c13: int, block: int, grid: int) -> list[int]:
    """The pairs a block's warps take in a phase of d rows, in the order of
    walk_pairs (its sweeps, each the block's MK_WARPS warps): strided by the
    grid where the chunk covers the k columns, else group by group."""
    npairs = d // 2 if c13 > 0 else (d + 1) // 2
    if chunk >= k:
        return [p for p0 in range(block * MK_WARPS, npairs, grid * MK_WARPS)
                for p in range(p0, min(p0 + MK_WARPS, npairs))]
    ngroups = -(-npairs // MK_WARPS)
    return [g * MK_WARPS + w for g in range(block, ngroups, grid) for w in range(MK_WARPS)
            if g * MK_WARPS + w < npairs]


def prefetch_rows(d: int, c13: int, block: int) -> list[int]:
    """The weight rows a block brings into L2 ahead of a phase of d rows
    (prefetch_pairs, made by the q4 body alone): both rows of each of its
    warps' first pairs (a pair's second row only where it lies below d)."""
    npairs = d // 2 if c13 > 0 else (d + 1) // 2
    rows = []
    for p in range(block * MK_WARPS, min(block * MK_WARPS + MK_WARPS, npairs)):
        rows += [r for r in pair_rows(p, c13) if r < d]
    return rows


def _workspace(lib, device, b, cfg, s) -> torch.Tensor:
    nbytes = lib.xq_fused_decode_workspace(b, cfg.dim, cfg.n_kv_heads,
                                           cfg.n_heads // cfg.n_kv_heads, s, cfg.hidden_dim,
                                           cfg.head_dim)
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
    inputs may lie on the CPU: they reach the card as one int32 tensor. Where
    all of them (and x0, the trig, freqs) lie on the card the call reads
    nothing from the host and copies nothing up: a CUDA graph captures it
    (``runtime/graphs.py``)."""
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
    _need(hd in HEAD_DIMS, f"head_dim {hd} (the kernel takes {HEAD_DIMS})")
    f32 = cache_k.dtype == torch.float32
    planes = (cache_k, cache_v) + ((k_scale, v_scale) if quant else ())
    _need(all(t.is_contiguous() and t.device == dev for t in planes),
          "caches and scale planes must be contiguous on one card")
    folds = (lp.bqkv, lp.q_norm, lp.k_norm, lp.post_attn_norm, lp.post_mlp_norm)  # None where off
    tensors = [lp.attn_norm, lp.mlp_norm] + [t for t in folds if t is not None]
    for qw in (lp.wqkv, lp.wo, lp.w13, lp.w2):
        tensors += [qw.values, qw.scale]
    if wcls is not None:
        tensors += [wcls.values, wcls.scale, out_norm]
    if embed is not None:
        tensors.append(embed.values)
    for t in tensors:
        _need(t.device == dev and t.is_contiguous(), "weights must be contiguous on the card")
    for t in (lp.attn_norm, lp.mlp_norm, lp.wqkv.scale, lp.wo.scale, lp.w13.scale,
              lp.w2.scale) + ((wcls.scale, out_norm) if wcls is not None else ()) + tuple(
                  t for t in folds if t is not None):
        _need(t.dtype == torch.float32, "norms, scales, the qkv bias and post-norms must be f32")

    fold_e = embed is not None
    parts = [torch.as_tensor(t) for t in (kv_pos, kv_len, rotate) + ((token, pos) if fold_e
                                                                     else ())]
    _need(all(p.numel() == b for p in parts), f"step inputs must hold B={b} values each")
    on_card = all(p.device == dev for p in parts)
    home = dev if on_card else torch.device("cpu")
    parts += [torch.zeros((b,), dtype=torch.int32, device=home)] * (5 - len(parts))
    # (kv_pos, kv_len, rotate, token, pos) as one int32 tensor: assembled on
    # the card where the inputs lie there (no host copy, so the launch can be
    # captured in a CUDA graph), else on the host and copied up at once
    meta = torch.cat([p.to(device=home, dtype=torch.int32).reshape(b) for p in parts]).to(dev)

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

    lib = build.load_library("fused_decode_f32" if f32 else "fused_decode")
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
        *(ptr(t) for t in folds),
    ]
    q4 = lp.wqkv.q4group
    body = 2 if q4 else 1 if a8 else 0  # bf16 activations, a8, q4
    dims = [L, b, cfg.dim, kh, cfg.n_heads // kh, hd, cfg.hidden_dim, s, v,
            ffn_chunk(cfg.hidden_dim), 2 if quant else 3 if f32 else 1,  # 1 bf16, 2 int8, 3 f32
            body, q4, int(cfg.act == "gelu")]
    clip = float(cfg.qkv_clip) if math.isfinite(cfg.qkv_clip) else math.inf
    err = lib.xq_fused_decode(
        ctypes.cast((ctypes.c_void_p * len(ptrs))(*ptrs), ctypes.c_void_p),
        ctypes.cast((ctypes.c_int * len(dims))(*dims), ctypes.c_void_p),
        float(cfg.norm_eps), clip, 1.0 / math.sqrt(hd), float(cfg.embed_scale),
        float(cfg.attn_softcap), float(cfg.logit_softcap),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "fused_decode_step")
    build.LAUNCHES[("fused_decode", "fused_decode_a8", "fused_decode_q4")[body]] += 1
    if f32:
        build.LAUNCHES["fused_decode_f32"] += 1
    if lp.bqkv is not None:
        build.LAUNCHES["fused_decode_bias"] += 1
    if lp.q_norm is not None:
        build.LAUNCHES["fused_decode_qk_norm"] += 1
    if cfg.act == "gelu" or cfg.embed_scale != 1.0:  # Gemma's folds
        build.LAUNCHES["fused_decode_gemma"] += 1
    if lp.post_attn_norm is not None or cfg.attn_softcap or cfg.logit_softcap:  # Gemma-2's
        build.LAUNCHES["fused_decode_gemma2"] += 1
    caches = (cache_k, cache_v) + ((k_scale, v_scale) if quant else ())
    if v:
        return (xout, logits, tok, *caches)
    return (xout, *caches)
