"""Dense Llama/Mistral forward pass (counterpart of
``xalm_tpu/models/llama.py::forward`` and its helpers).

Behavioural contract, as in the JAX package:

- f32 residual stream, max-subtracted softmax, cache rounding on write.
- Interleaved-pair RoPE with a ``rotary_dim`` cutoff.
- GQA: query head h attends kv head h // (n_heads / n_kv_heads).
- StreamingLLM sink + ring cache: writes at ``kv_pos``, attends over
  ``kv_len`` slots, re-rotates the pinned sink keys by +1 position per
  wrapped decode step.
- GLU FFN: w2(silu(w1 x) * w3 x) through the fused, chunk-interleaved w13.

Chunk contract: calls with T > 1 must not wrap the ring; once wrapped the
engine feeds one token at a time (T = 1).

``impl`` picks the implementation of the per-layer work:

- ``"kernel"``: the port's kernels (ops/qmatmul.py, ops/attention.py) on the
  JAX "pallas" path's routing, for every decode step and prefill chunk; on
  the card a cache or shape the kernels do not take raises. For CPU tensors
  the wrappers run their plain versions, so this path also runs (and is
  tested) on the CPU.
- ``"plain"``: the same routing calling the kernels' plain versions
  directly, on any device (the yardstick the kernels are held against).
- ``"xla"``: the JAX package's reference path (plain matmul in
  ``compute_dtype``, scatter writes, dense masked attention).

An int8 KV cache (``cache.quantized``: int8 codes and per-row f32 scale
planes) is routed as the JAX forward routes it: a per-layer t = 1 step
through ``kv_update_q`` and ``flash_decode_q`` (kernels 5-7); a t > 1 chunk,
and every step of ``"xla"``, quantises and scatters its rows, rotates the
sinks at t = 1, dequantises the layer and runs the dense attention (the
reference computes that attention outside any Pallas kernel; the matmuls
still go through kernel 1).

A t = 1 step over B <= 8 rows with an i8 body and a float or int8 cache
runs the whole-step megakernel (ops/fused_decode.py) instead, as the JAX
forward does
(``fused_step``: "auto" takes it wherever it is supported, False never):
``impl="kernel"`` launches it, ``impl="plain"`` runs its plain version. It
gathers the embed row itself at B = 1 with a bf16 table, and runs the head
too when the head is i8 (``Engine(wcls_i8=True)``); otherwise the head
stays on kernel 1.

Unlike the JAX function the cache is updated in place; the per-layer path
runs its layers as a Python loop. MoE, q4, a8, tp/pp, speculative
verify and the family extras (bias, qk-norm, post-norms, softcaps, gelu,
embed scale) are later slices and raise NotImplementedError.
"""

from __future__ import annotations

import functools
import math
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F

from xalm_tpu_torch.models.config import KV_SINKS, ModelConfig
from xalm_tpu_torch.models.params import (
    ModelParams,
    Q8_FIXED_SCALE,
    QWeight,
    _check_dense,
    ffn_chunk,
    split_qkv_rows,
    split_w13_rows,
)
from xalm_tpu_torch.ops import attention as attn_ops
from xalm_tpu_torch.ops import fused_decode as fd
from xalm_tpu_torch.ops import qmatmul as qmm
from xalm_tpu_torch.ops.linear import qmatmul as plain_linear
from xalm_tpu_torch.runtime.cache import KVCache, ring_indices

__all__ = ["forward", "rope_freqs", "apply_rope", "rmsnorm", "embed_lookup", "attention"]

LogitsMode = Literal["none", "last", "all", "token"]
IMPLS = ("kernel", "plain", "xla")


def rope_freqs(cfg: ModelConfig) -> np.ndarray:
    """Per-pair angular frequency; pairs with j >= rotary_dim get 0."""
    if cfg.rope_scaling != "none":
        raise NotImplementedError("rope scaling: later slice")
    j = np.arange(0, cfg.head_dim, 2, dtype=np.float32)
    return np.where(
        j < cfg.rotary_dim, cfg.rope_theta ** (-(j / max(cfg.rotary_dim, 1))), 0.0
    ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def rope_constants(cfg: ModelConfig, device: torch.device):
    """(freqs (hd/2,), cexp1 (hd,), sexp1 (hd,)) f32 on ``device``: the
    rope frequencies and the +1-position sink rotation tables, built once
    per (config, device) and kept there."""
    freqs = rope_freqs(cfg)
    c1, s1 = attn_ops.rope_cos_sin_plus1(freqs)
    with torch.inference_mode(False):  # plain tensors, usable in and out of inference mode
        return tuple(torch.from_numpy(a).to(device) for a in (freqs, c1, s1))


def rope_tables(positions: torch.Tensor, freqs: torch.Tensor):
    """Lane-expanded (cos, sin) of the angles: (B, T, 1, hd) each."""
    ang = positions[:, :, None].to(torch.float32) * freqs  # (B, T, hd/2)
    cexp = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)[:, :, None]
    sexp = torch.repeat_interleave(torch.sin(ang), 2, dim=-1)[:, :, None]
    return cexp, sexp


def rotate(x: torch.Tensor, cexp: torch.Tensor, sexp: torch.Tensor) -> torch.Tensor:
    """out = x*cexp + swap(x)*sexp, swap[2j] = -x[2j+1], swap[2j+1] = x[2j]."""
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    swapped = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)
    return x * cexp + swapped * sexp


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation: x (B, T, H, hd) f32, positions (B, T)."""
    return rotate(x, *rope_tables(positions, freqs))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * w.to(torch.float32)


def embed_lookup(embed: QWeight, tokens: torch.Tensor) -> torch.Tensor:
    """Gather + dequantize embedding rows -> (B, T, dim) f32."""
    rows = embed.values[tokens].to(torch.float32)
    if embed.values.dtype == torch.int8:
        if embed.scale is not None:
            rows = rows * embed.scale[tokens][..., None]
        else:
            rows = rows * Q8_FIXED_SCALE
    return rows


def attention(q, k, v, kv_len, compute_dtype=torch.float32) -> torch.Tensor:
    """Dense masked GQA attention (the reference path). q (B, T, H, hd) f32
    rotated; k, v (B, KH, S, hd); kv_len (B, T). Returns (B, T, H*hd)."""
    b, t, hq, hd = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = hq // kh
    qg = q.reshape(b, t, kh, g, hd) * (1.0 / math.sqrt(hd))
    scores = torch.einsum(
        "btkgh,bksh->bkgts",
        qg.to(compute_dtype).to(torch.float32),
        k.to(compute_dtype).to(torch.float32),
    )
    mask = torch.arange(s, device=q.device)[None, None, None, None, :] < kv_len[:, None, None, :, None]
    scores = torch.where(mask, scores, -math.inf)
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bkgts,bksh->btkgh",
        att.to(compute_dtype).to(torch.float32),
        v.to(compute_dtype).to(torch.float32),
    )
    return out.reshape(b, t, hq * hd)


def _write_rows(cache: torch.Tensor, layer: int, kv_pos: torch.Tensor, rows: torch.Tensor) -> None:
    """Scatter (B, T, KH, hd) rows into the (L, B, KH, S, hd) cache, or
    (B, T, KH) row scales into an (L, B, KH, S) scale plane, at layer and
    kv_pos (B, T); rows at kv_pos >= S_phys are dropped. In place."""
    b, t = rows.shape[:2]
    s = cache.shape[3]
    cl = cache[layer]
    bi = torch.arange(b, device=rows.device)[:, None].expand(b, t)
    idx = torch.clamp(kv_pos.long(), max=s - 1)
    keep = (kv_pos < s).reshape(b, t, *[1] * (rows.dim() - 2))
    cl[bi, :, idx] = torch.where(keep, rows.to(cache.dtype), cl[bi, :, idx])


def _write_chunk(cache, layer: int, starts: list[int], rows, valid) -> None:
    """Contiguous T > 1 chunk write (no wrap by the chunk contract) at
    ``starts[b] = min(pos[b], max_seq_len - T)``; rows with ``valid ==
    False`` keep the cache contents. In place."""
    b, t, kh, hd = rows.shape
    win = rows.to(cache.dtype).permute(0, 2, 1, 3)  # (B, KH, T, hd)
    for bi, start in enumerate(starts):
        cur = cache[layer, bi, :, start : start + t]
        new = win[bi]
        if valid is not None:
            new = torch.where(valid[bi][None, :, None], new, cur)
        cache[layer, bi, :, start : start + t] = new


def _rotate_sinks(cache_k, layer: int, active: torch.Tensor, freqs, k_scale=None) -> None:
    """Rotate the pinned sink keys by +1 position for wrapped rows (T = 1).
    An int8 cache dequantises the sinks with their scales, rotates them and
    requantises them with fresh scales. In place."""
    sinks = cache_k[layer, :, :, :KV_SINKS]  # (B, KH, KV_SINKS, hd)
    vals = sinks.to(torch.float32)
    if k_scale is not None:
        vals = vals * k_scale[layer, :, :, :KV_SINKS, None]
    ones = torch.ones((sinks.shape[0], KV_SINKS), dtype=torch.int32, device=sinks.device)
    rotated = apply_rope(vals.transpose(1, 2), ones, freqs).transpose(1, 2)
    live = active[:, None, None, None]
    if k_scale is not None:
        codes, scale = attn_ops.quant_rows(rotated)
        cache_k[layer, :, :, :KV_SINKS] = torch.where(live, codes, sinks)
        k_scale[layer, :, :, :KV_SINKS] = torch.where(live[..., 0], scale,
                                                      k_scale[layer, :, :, :KV_SINKS])
        return
    cache_k[layer, :, :, :KV_SINKS] = torch.where(live, rotated.to(cache_k.dtype), sinks)


def forward(
    params: ModelParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, T) int
    pos: torch.Tensor,  # (B,) int32 — absolute position of tokens[:, 0]
    cache: KVCache,
    valid: torch.Tensor | None = None,  # (B, T) bool; False = padding
    *,
    logits_mode: LogitsMode = "last",
    compute_dtype=torch.float32,
    impl: str = "kernel",
    fused_step: bool | str = "auto",
):
    """One step over a (B, T) token block. Returns (logits, cache) with the
    cache updated in place. logits: (B, vocab) for "last", (B, T, vocab)
    for "all", None for "none", the greedy token ids (B,) for "token".
    tokens, pos and valid may lie on the host; they move to the weights'
    device where a path needs them there."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    _check_dense(cfg)
    dev = params.embed.values.device
    b, t = tokens.shape
    s = cfg.max_seq_len
    g = cfg.n_heads // cfg.n_kv_heads
    hd = cfg.head_dim
    freqs, cexp1, sexp1 = rope_constants(cfg, dev)
    per_layer = impl != "xla"
    mm_fn = qmm.qmatmul if impl == "kernel" else qmm.qmatmul_plain

    def mm(xx: torch.Tensor, qw: QWeight, layer: int | None = None, norm_sw=None):
        """Stacked-weight matmul, routed as the JAX package's pallas path:
        int8/bf16 weights go through kernel 1 (norm prologue and scale
        epilogue fused below 256 rows), other dtypes through ops.linear
        except on the card's kernel path, where the kernel refuses them."""
        lead = xx.shape[:-1]
        xm = xx.reshape(-1, xx.shape[-1])
        m = xm.shape[0]
        kernel_route = qmm.supported_weight_dtype(qw.values.dtype) or (
            impl == "kernel" and xm.is_cuda)
        if per_layer and kernel_route:
            if layer is None:  # the head: an unstacked (D, N) weight
                values, lyr = qw.values[None], 0
                scale = None if qw.scale is None else qw.scale[None]
            else:
                values, scale, lyr = qw.values, qw.scale, layer
            fuse_norm = norm_sw is not None and m < 256
            if norm_sw is not None and not fuse_norm:
                xm = rmsnorm(xm, norm_sw[lyr], cfg.norm_eps)
            is_i8 = qw.values.dtype == torch.int8
            y = mm_fn(
                xm.contiguous(), values, lyr,
                norm_w=norm_sw if fuse_norm else None,
                norm_eps=cfg.norm_eps if fuse_norm else None,
                scale=scale if is_i8 else None,
                q8_scale=Q8_FIXED_SCALE if (is_i8 and scale is None) else None,
            )
            return y.reshape(*lead, -1)
        if norm_sw is not None:
            xm = rmsnorm(xm, norm_sw[layer], cfg.norm_eps)
        if layer is not None:
            qw = QWeight(qw.values[layer], None if qw.scale is None else qw.scale[layer])
        return plain_linear(xm, qw, compute_dtype=compute_dtype).reshape(*lead, -1)

    def head(x: torch.Tensor):
        if logits_mode == "none":
            return None
        if logits_mode in ("last", "token"):
            x = x[:, -1:]
        logits = mm(rmsnorm(x, params.out_norm, cfg.norm_eps), params.wcls)
        if logits_mode in ("last", "token"):
            logits = logits[:, 0]
        if logits_mode == "token":
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return logits

    if fused_step == "auto":
        fused_step = True  # the megakernel wherever it is supported
    if fused_step and t == 1 and per_layer and fd.fused_step_supported(
            cfg, params, cache.k, b, t, k_scale=cache.k_scale):
        return _megakernel_step(params, cfg, tokens, pos, cache, valid, logits_mode, impl, head)

    tokens = tokens.to(dev)
    pos_h = pos.to("cpu", torch.int32)
    pos = pos.to(device=dev, dtype=torch.int32)
    if valid is not None:
        valid = valid.to(dev)
    positions = pos[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    _, kv_pos, kv_len = ring_indices(positions, s)
    if valid is not None:
        kv_pos = torch.where(valid, kv_pos, s)  # sentinel: dropped write

    x = embed_lookup(params.embed, tokens)  # (B, T, dim) f32
    lp = params.layers
    kv_update = attn_ops.kv_update if impl == "kernel" else attn_ops.kv_update_plain
    flash_decode = attn_ops.flash_decode if impl == "kernel" else attn_ops.flash_decode_plain
    flash_prefill = attn_ops.flash_prefill if impl == "kernel" else attn_ops.flash_prefill_plain
    kv_update_q = attn_ops.kv_update_q if impl == "kernel" else attn_ops.kv_update_q_plain
    flash_decode_q = attn_ops.flash_decode_q if impl == "kernel" else attn_ops.flash_decode_q_plain

    clip = cfg.qkv_clip if math.isfinite(cfg.qkv_clip) else None
    ck, cv, ks, vs = cache.k, cache.v, cache.k_scale, cache.v_scale
    quant = cache.quantized
    if t > 1:
        starts = [min(p, s - t) for p in pos_h.tolist()]
    else:
        active = positions[:, 0] >= s
        if valid is not None:
            active = active & valid[:, 0]
        rot_flag = active.to(torch.int32)
        kv_pos0 = kv_pos[:, 0].contiguous()
        kv_len0 = kv_len[:, 0].contiguous()

    rope = rope_tables(positions, freqs)  # shared by every layer
    for layer in range(cfg.n_layers):
        qkv = mm(x, lp.wqkv, layer, norm_sw=lp.attn_norm)
        q, k, v = split_qkv_rows(qkv, -1, g, hd)
        if clip is not None:
            q, k, v = (torch.clamp(z, -clip, clip) for z in (q, k, v))
        q = rotate(q.reshape(b, t, -1, hd), *rope)
        k = rotate(k.reshape(b, t, -1, hd), *rope)
        v = v.reshape(b, t, -1, hd)

        if per_layer and t == 1 and quant:
            # int8 decode: quantised ring write + sink re-rotation, then
            # flash-decode over the codes
            kv_update_q(ck, cv, ks, vs, layer, k[:, 0].contiguous(), v[:, 0].contiguous(),
                        kv_pos0, rot_flag, cexp1, sexp1)
            attn_out = flash_decode_q(q[:, 0].contiguous(), ck, cv, ks, vs, layer, kv_len0)[:, None]
        elif per_layer and t == 1:
            # decode: in-place ring write + sink rotation, then flash-decode
            kv_update(ck, cv, layer, k[:, 0].contiguous(), v[:, 0].contiguous(),
                      kv_pos0, rot_flag, cexp1, sexp1)
            attn_out = flash_decode(q[:, 0].contiguous(), ck, cv, layer, kv_len0)[:, None]
        elif quant:
            # int8 prefill chunk, and "xla": quantised scatter writes, the
            # sinks re-rotated at t = 1, the dequantised layer into the
            # dense attention (the reference's own routing, llama.py:784-808)
            for c, sc, rows in ((ck, ks, k), (cv, vs, v)):
                codes, scale = attn_ops.quant_rows(rows)
                _write_rows(c, layer, kv_pos, codes)
                _write_rows(sc, layer, kv_pos, scale)
            if t == 1:
                _rotate_sinks(ck, layer, active, freqs, ks)
            kl = ck[layer].to(torch.float32) * ks[layer][..., None]
            vl = cv[layer].to(torch.float32) * vs[layer][..., None]
            attn_out = attention(q, kl, vl, kv_len, compute_dtype)
            del kl, vl
        elif per_layer:
            # chunked prefill: contiguous in-place writes + causal flash
            _write_chunk(ck, layer, starts, k, valid)
            _write_chunk(cv, layer, starts, v, valid)
            attn_out = flash_prefill(q.contiguous(), ck, cv, layer, pos)
        else:  # "xla": scatter writes + dense masked attention
            _write_rows(ck, layer, kv_pos, k)
            _write_rows(cv, layer, kv_pos, v)
            if t == 1:
                _rotate_sinks(ck, layer, active, freqs)
            attn_out = attention(q, ck[layer], cv[layer], kv_len, compute_dtype)
        x = x + mm(attn_out, lp.wo, layer)

        gate, up = split_w13_rows(mm(x, lp.w13, layer, norm_sw=lp.mlp_norm),
                                  ffn_chunk(cfg.hidden_dim))
        x = x + mm(F.silu(gate) * up, lp.w2, layer)

    return head(x), cache


def _megakernel_step(params, cfg, tokens, pos, cache, valid, logits_mode, impl, head):
    """A t = 1 step through the whole-step megakernel (the JAX forward's
    fused_decode_step branch). The step's inputs (kv_pos, kv_len, rotate,
    token, pos) are computed on the host and reach the card as one small
    tensor; no per-layer host work is left."""
    step = fd.fused_decode_step if impl == "kernel" else fd.fused_decode_step_plain
    dev = params.embed.values.device
    b, s = tokens.shape[0], cfg.max_seq_len
    freqs, cexp1, sexp1 = rope_constants(cfg, dev)
    pos_h = pos.to("cpu", torch.int32).reshape(b)
    _, kv_pos, kv_len = ring_indices(pos_h, s)
    active = pos_h >= s
    if valid is not None:
        valid_h = valid[:, 0].to("cpu")
        kv_pos = torch.where(valid_h, kv_pos, s).to(torch.int32)  # sentinel: dropped write
        active = active & valid_h  # inactive rows do not rotate their sinks
    rotate_flag = active.to(torch.int32)
    if b == 1 and fd.embed_fold_supported(cfg, params):
        # the kernel gathers the embed row and computes the rope trig itself
        x0 = cexp_p = sexp_p = None
        fold_e = dict(embed=params.embed, token=tokens[:, 0], pos=pos_h, freqs=freqs)
    else:
        x0 = embed_lookup(params.embed, tokens[:, 0].to(dev))
        cexp_p, sexp_p = (z[:, 0, 0] for z in rope_tables(
            pos_h[:, None], rope_constants(cfg, torch.device("cpu"))[0]))
        fold_e = {}
    args = (params, cfg, x0, cache.k, cache.v, kv_pos, kv_len, rotate_flag, cexp_p, sexp_p,
            cexp1, sexp1)
    if cache.quantized:
        fold_e.update(k_scale=cache.k_scale, v_scale=cache.v_scale)
    if logits_mode != "none" and fd.wcls_fold_supported(cfg, params):
        # final norm + i8 head + greedy argmax in the same launch
        _, logits, token = step(*args, wcls=params.wcls, out_norm=params.out_norm, **fold_e)[:3]
        if logits_mode == "token":
            return token, cache
        return (logits if logits_mode == "last" else logits[:, None]), cache
    x = step(*args, **fold_e)[0]
    return head(x[:, None]), cache
