"""Llama/Mistral/Mixtral forward pass (counterpart of
``xalm_tpu/models/llama.py::forward`` and its helpers).

Behavioural contract, as in the JAX package:

- f32 residual stream, max-subtracted softmax, cache rounding on write.
- Interleaved-pair RoPE with a ``rotary_dim`` cutoff.
- GQA: query head h attends kv head h // (n_heads / n_kv_heads).
- StreamingLLM sink + ring cache: writes at ``kv_pos``, attends over
  ``kv_len`` slots, re-rotates the pinned sink keys by +1 position per
  wrapped decode step.
- GLU FFN: w2(act(w1 x) * w3 x) through the fused, chunk-interleaved w13,
  act SiLU, or the tanh-approximate gelu (``cfg.act == "gelu"``, Gemma).
- Sparse-MoE FFN (Mixtral, ``moe_ffn``): f32 router softmax, top-k of the
  probabilities, renormalised. A t = 1 step at B = 1 on the per-layer
  paths runs the gathered decode, which streams only the k chosen experts
  (``qmatmul_multi``, the indices never leave the device): int8, bf16 and
  f32 experts, and packed-q4 experts under ``a8_decode`` (their dots are
  s8 x s8); every other step (prefill chunks, B > 1, ``"xla"``, q4 experts
  without ``a8_decode``, f16 or fp8 experts) runs the dense-masked experts,
  q4 ones dequantised in ``compute_dtype`` one expert at a time.

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

The cache's dtype fixes the attention's route before any launch, as the
JAX forward's ``_fused_cache_ok`` gate does (``supported_cache_dtype``): a
bf16 or f32 cache takes kernels 2-4 on the per-layer paths (an f32 cache
their f32 instantiations; a t = 1 step kernels 2 and 3 in one launch,
``fused_decode_attention``, and under Gemma-2's attention cap ``kv_update``,
then the dense attention); an f16 cache, which no attention kernel of
either package takes, scatters its rows, rotates the sinks at t = 1 and
runs the dense attention on every path (``xalm_tpu/models/llama.py``
``:783-808``), its matmuls still on kernel 1. This is the reference's
routing by dtype, not a fallback from a kernel that failed.

An int8 KV cache (``cache.quantized``: int8 codes and per-row f32 scale
planes) is routed as the JAX forward routes it: a per-layer t = 1 step
through ``fused_decode_attention_q`` (kernels 5-7, one launch a layer;
under Gemma-2's attention cap ``kv_update_q``, then the dense attention); a
t > 1 chunk,
and every step of ``"xla"``, quantises and scatters its rows, rotates the
sinks at t = 1, dequantises the layer and runs the dense attention (the
reference computes that attention outside any Pallas kernel; the matmuls
still go through kernel 1).

A t = 1 step over B <= 8 rows with an i8 body and a bf16, f32 or int8
cache runs the whole-step megakernel (ops/fused_decode.py) instead, as the
JAX forward does
(``fused_step``: "auto" takes it wherever it is supported, False never):
``impl="kernel"`` launches it, ``impl="plain"`` runs its plain version. It
gathers the embed row itself at B = 1 with a bf16 table, and runs the head
too when the head is i8 (``Engine(wcls_i8=True)``); otherwise the head
stays on kernel 1.

Weights route as the JAX ``mm`` does (``xalm_tpu/models/llama.py:570-669``):
int8, bf16 and f32 weights take kernel 1 on the per-layer paths, f16 and
fp8 weights (kept so by ``load_params``) the plain product of ops.linear on
every device, as the reference sends them to XLA. A q4 weight below 256 rows takes
kernel 1's q4 branch when the call's opt-in is on (``a8_decode`` for t = 1
rows, ``a8_prefill`` for t > 1 chunks); every other q4 call dequantizes
the layer and runs one plain product (the reference computes that outside
any Pallas kernel); int8 weights at 256 rows and more take the W8A8
branch under ``a8_prefill``; the megakernel runs its a8 body under
``a8_decode`` (and its q4 body for a q4 model, which needs it).

Unlike the JAX function the cache is updated in place; the per-layer path
runs its layers as a Python loop. The family extras, on every path (the
megakernel folds each of them in):

- the Qwen2 qkv bias (added after the qkv matmul, outside the kernels) and
  the Qwen3 per-head q/k RMS norms (after the clip, before rope);
- linear and llama3 rope scaling (``rope_freqs``);
- Gemma's embed scale (x times ``cfg.embed_scale`` after the lookup) and
  gelu;
- Gemma-2's post-norms (the wo and w2 outputs RMS-normed before each
  residual add), its logit softcap (tanh(l / c) * c wherever logits leave
  the model) and its attention softcap. No kernel of the per-layer path
  applies the attention cap (nor did the TPU kernels), so with the cap set
  every step and chunk runs the dense attention over the layer, after the
  ring insert (kernel 2, or 5 and 6, at t = 1; the chunk write at t > 1).
  The JAX forward gates its fused decode attention on the cap the same
  way, but sends bf16-cache prefill chunks to its cap-free fused prefill;
  the port follows HF and the JAX dense path there (ROADMAP section 3).

``spec_verify=True`` runs a speculative verify chunk over a wrapped ring
(``_spec_verify_attention``: the attention in plain PyTorch, as the JAX
package computes it outside any Pallas kernel; the matmuls still on kernel
1), which writes nothing to the cache.

Parallelism (``xalm_tpu_torch/parallel/``): with ``tp`` (a mesh axis,
``parallel.mesh.Axis``) the params and cache are this rank's megatron
shards (``parallel/shardings.py``): wqkv and w13 whole kv heads and chunk
pairs of rows, wo and w2 a block of their contraction, whose partial sums
are all-reduced over tp before Gemma-2's post-norms and the residual add,
as the JAX forward psums them (``:810-812``, ``:939-941``); MoE sums this
rank's experts (``moe_ffn``); the head's vocab rows are sharded, so logits
come back vocab-local and ``"token"`` takes ``sharded_argmax``. With
``pp`` the stacked layers and the cache are this stage's L/pp (its local
layer index on the same kernels): each stage runs its layers in turn and
broadcasts its residual to the others, after the last every rank holds
the final residual and computes the (whole) head, as the JAX ring's
closing psum gives every device (``:947-983``); tp composes within a
stage. The megakernel stays off whenever either is given (``:466-470``).
"""

from __future__ import annotations

import functools
import math
from typing import Literal

import numpy as np
import torch

from xalm_tpu_torch.models.config import KV_SINKS, ModelConfig
from xalm_tpu_torch.models.params import (
    ModelParams,
    Q8_FIXED_SCALE,
    QWeight,
    ffn_chunk,
    split_qkv_rows,
    split_w13_rows,
)
from xalm_tpu_torch.ops import attention as attn_ops
from xalm_tpu_torch.ops.attention import act_fn, softcap
from xalm_tpu_torch.ops import fused_decode as fd
from xalm_tpu_torch.ops import qmatmul as qmm
from xalm_tpu_torch.ops.linear import qmatmul as plain_linear
from xalm_tpu_torch.parallel.mesh import sharded_argmax
from xalm_tpu_torch.runtime.cache import KVCache, ring_indices, step_inputs

__all__ = [
    "forward", "rope_freqs", "apply_rope", "rmsnorm", "embed_lookup", "attention", "moe_route",
    "moe_ffn", "act_fn",
]

LogitsMode = Literal["none", "last", "all", "token"]
IMPLS = ("kernel", "plain", "xla")


def rope_freqs(cfg: ModelConfig) -> np.ndarray:
    """Per-pair angular frequency; pairs with j >= rotary_dim get 0.
    ``cfg.rope_scaling``: "linear" divides every frequency by
    ``rope_factor``; "llama3" (HF ``_compute_llama3_parameters``) keeps the
    high-frequency pairs, divides the low-frequency ones by the factor and
    interpolates the band between the ``high/low_freq_factor`` wavelength
    cutoffs. numpy in the JAX package's operation order, so the two agree
    bit for bit."""
    j = np.arange(0, cfg.head_dim, 2, dtype=np.float32)
    freqs = np.where(
        j < cfg.rotary_dim, cfg.rope_theta ** (-(j / max(cfg.rotary_dim, 1))), 0.0
    ).astype(np.float32)
    if cfg.rope_scaling == "linear":
        freqs = freqs / np.float32(cfg.rope_factor)
    elif cfg.rope_scaling == "llama3":
        orig = np.float32(cfg.rope_original_max_pos)
        factor = np.float32(cfg.rope_factor)
        with np.errstate(divide="ignore"):
            wavelen = np.where(freqs > 0, 2.0 * np.pi / freqs, np.inf)
        low_wl = orig / np.float32(cfg.rope_low_freq_factor)
        high_wl = orig / np.float32(cfg.rope_high_freq_factor)
        smooth = (orig / wavelen - cfg.rope_low_freq_factor) / max(
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor, 1e-9)
        interp = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = np.where(
            wavelen > low_wl, freqs / factor, np.where(wavelen < high_wl, freqs, interp))
    return freqs.astype(np.float32)


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


def attention(q, k, v, kv_len, compute_dtype=torch.float32, attn_softcap: float = 0.0):
    """Dense masked GQA attention (the reference path). q (B, T, H, hd) f32
    rotated; k, v (B, KH, S, hd); kv_len (B, T); the scores capped by
    ``attn_softcap`` before the mask (0: none). Returns (B, T, H*hd)."""
    b, t, hq, hd = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = hq // kh
    qg = q.reshape(b, t, kh, g, hd) * (1.0 / math.sqrt(hd))
    scores = torch.einsum(
        "btkgh,bksh->bkgts",
        qg.to(compute_dtype).to(torch.float32),
        k.to(compute_dtype).to(torch.float32),
    )
    scores = softcap(scores, attn_softcap)
    mask = torch.arange(s, device=q.device)[None, None, None, None, :] < kv_len[:, None, None, :, None]
    scores = torch.where(mask, scores, -math.inf)
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bkgts,bksh->btkgh",
        att.to(compute_dtype).to(torch.float32),
        v.to(compute_dtype).to(torch.float32),
    )
    return out.reshape(b, t, hq * hd)


def moe_route(xn: torch.Tensor, wgate: torch.Tensor, k: int):
    """Router of one layer: xn (B, T, dim) normed, wgate (E, dim) f32 ->
    (topv (B, T, k) renormalised, topi (B, T, k)), both sorted by descending
    probability. The logits are an f32 product (TF32 stays off on the card:
    a TF32 router would pick other experts)."""
    probs = torch.softmax(torch.einsum("btd,ed->bte", xn, wgate.to(torch.float32)), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    return topv / torch.sum(topv, dim=-1, keepdim=True), topi


def gathered_ok(qw: QWeight, impl: str, a8_decode: bool = False) -> bool:
    """Does a B = 1 decode step on the per-layer paths gather its experts?
    The JAX gate (``xalm_tpu/models/llama.py:846-854``): the kernel's dtypes
    (int8, bf16, f32), or packed q4 under ``a8_decode`` (its dots are
    s8 x s8); f16 and fp8 experts run dense-masked."""
    if impl == "xla":
        return False
    if qw.q4group:
        return a8_decode
    return qmm.supported_weight_dtype(qw.values.dtype)


def moe_ffn(x: torch.Tensor, lp, layer: int, cfg: ModelConfig, impl: str,
            compute_dtype, a8_decode: bool = False, tp=None) -> torch.Tensor:
    """Mixtral's sparse-MoE FFN of one layer (``xalm_tpu/models/llama.py``
    ``:818-931``): x (B, T, dim) f32 -> the FFN's output (B, T, dim) f32.
    Under tensor parallelism (``tp``, the stacks sharded on E) the router
    runs over every expert and this rank sums its own E/tp experts' share
    only, dense-masked (the reference gathers only without tp): the
    caller's all-reduce adds the shares up."""
    b, t, _ = x.shape
    xn = rmsnorm(x, lp.mlp_norm[layer], cfg.norm_eps)
    topv, topi = moe_route(xn, lp.wgate[layer], cfg.n_experts_active)
    chunk = ffn_chunk(cfg.hidden_dim)
    e_loc = lp.w13e.values.shape[1]  # the experts this rank holds
    if tp is None and t == 1 and b == 1 and gathered_ok(lp.w13e, impl, a8_decode):
        # gathered decode: the (L, E, ...) stacks viewed flat (L*E, ...),
        # the k experts at layer*E + expert, one launch per matmul
        multi = qmm.qmatmul_multi if impl == "kernel" else qmm.qmatmul_multi_plain
        idxs = (layer * e_loc + topi[0, 0]).to(torch.int32)

        def flat(qw: QWeight):
            v = qw.values.reshape(-1, *qw.values.shape[2:])
            s = None if qw.scale is None else qw.scale.reshape(-1, *qw.scale.shape[2:])
            return dict(values=v, scale=s, q4_group=qw.q4group)

        gate, up = split_w13_rows(multi(xn.reshape(1, -1), idxs=idxs, **flat(lp.w13e)), chunk)
        dn_e = multi((act_fn(cfg.act, gate) * up).contiguous(), idxs=idxs, shared_x=False,
                     **flat(lp.w2e))
        return torch.sum(topv[0, 0, :, None] * dn_e, dim=0).reshape(1, 1, -1)
    # dense-masked: every expert, weighted by its renormalised probability
    # (0 for the unchosen); inputs rounded to compute_dtype, f32 products
    # and sums (the reference's preferred_element_type=f32), one expert's
    # f32 weight copy at a time (q4: dequantised in compute_dtype first,
    # the reference's ``_expert_mat``)
    def expert(qw: QWeight, e: int) -> QWeight:
        return QWeight(qw.values[layer, e], None if qw.scale is None else qw.scale[layer, e],
                       qw.q4group)

    wts = torch.zeros((b, t, cfg.n_experts), dtype=torch.float32, device=x.device)
    wts.scatter_(-1, topi, topv)
    e0 = 0 if tp is None else tp.index * e_loc
    down = torch.zeros_like(x)
    for e in range(e_loc):
        a13 = plain_linear(xn, expert(lp.w13e, e), compute_dtype=compute_dtype)
        gate, up = split_w13_rows(a13, chunk)
        dn = plain_linear(act_fn(cfg.act, gate) * up, expert(lp.w2e, e), compute_dtype=compute_dtype)
        down = down + dn * wts[..., e0 + e:e0 + e + 1]
    return down


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


def _write_chunk(cache, layer: int, slots: torch.Tensor, rows, valid) -> None:
    """Contiguous T > 1 chunk write (no wrap by the chunk contract) into
    ``slots[b] = min(pos[b], max_seq_len - T) + arange(T)``, (B, T) int64 on
    the cache's device (no host read: a CUDA graph can capture the write);
    rows with ``valid == False`` keep the cache contents. In place."""
    b = rows.shape[0]
    win = rows.to(cache.dtype).permute(0, 2, 1, 3)  # (B, KH, T, hd)
    for bi in range(b):
        plane = cache[layer, bi]  # (KH, S, hd)
        new = win[bi]
        if valid is not None:
            new = torch.where(valid[bi][None, :, None], new, plane.index_select(1, slots[bi]))
        plane.index_copy_(1, slots[bi], new)


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


def _spec_verify_attention(q, k, v, ck, cv, ks, vs, layer: int, kv_pos, cfg: ModelConfig,
                           freqs, compute_dtype):
    """Attention of a speculative verify chunk over a WRAPPED ring
    (``xalm_tpu/models/llama.py::_spec_verify_attention``; runtime/spec.py):
    nothing is written to the cache. Query i attends the sinks rotated
    +(i + 1) from their pre-chunk state (rounded through the cache's type,
    an int8 cache's requantised), the ring without the slots the chunk's
    rows j <= i would overwrite (and without the sinks and the padding
    past the window), and the chunk's own rows j <= i in stored form. That
    is the per-step ring's attention, computed without its writes.

    q (B, T, H, hd) f32 rotated, k and v (B, T, KH, hd) f32 rotated,
    kv_pos (B, T) the rows' ring slots -> (attn_out (B, T, H*hd) f32,
    rows): the chunk's rows in stored form, (k, v) in the cache's type, and
    for an int8 cache (k codes, v codes, k scales, v scales), for
    ``spec_commit`` to write the accepted ones."""
    b, t, hq, hd = q.shape
    f32 = torch.float32
    kl, vl = ck[layer], cv[layer]  # (B, KH, S, hd)
    if ks is not None:
        kq, ksc = attn_ops.quant_rows(k)
        vq, vsc = attn_ops.quant_rows(v)
        rows = (kq, vq, ksc, vsc)
        kl = kl.to(f32) * ks[layer][..., None]
        vl = vl.to(f32) * vs[layer][..., None]
        kd = kq.to(f32) * ksc[..., None]  # the rows as a write-then-read would give them
        vd = vq.to(f32) * vsc[..., None]
    else:
        rows = (k.to(ck.dtype), v.to(cv.dtype))
        kd, vd = rows[0].to(f32), rows[1].to(f32)
        kl, vl = kl.to(f32), vl.to(f32)
    kh, s = kl.shape[1], kl.shape[2]
    g = hq // kh

    def cd(z):  # matmul inputs rounded to compute_dtype, products and sums in f32
        return z.to(compute_dtype).to(f32)

    qc = cd(q.reshape(b, t, kh, g, hd) * (1.0 / math.sqrt(hd)))
    sc_ring = torch.einsum("btkgh,bksh->bkgts", qc, cd(kl))
    slot = torch.arange(s, dtype=torch.int32, device=q.device)
    # slot kv_pos[:, j] is dead for the queries i >= j
    evicted = torch.cumsum((slot[None, None, :] == kv_pos[:, :, None]).to(torch.int32), dim=1) > 0
    dead = evicted | ((slot < KV_SINKS) | (slot >= cfg.max_seq_len))[None, None, :]
    sc_ring = torch.where(dead[:, None, None], -math.inf, sc_ring)  # (B, KH, G, T, S)
    sc_draft = torch.einsum("btkgh,bjkh->bkgtj", qc, cd(kd))
    causal = torch.arange(t, device=q.device)[:, None] >= torch.arange(t, device=q.device)[None, :]
    sc_draft = torch.where(causal, sc_draft, -math.inf)
    base = kl[:, :, :KV_SINKS].reshape(b, 1, kh * KV_SINKS, hd).expand(b, t, kh * KV_SINKS, hd)
    steps = torch.arange(1, t + 1, dtype=torch.int32, device=q.device)[None, :].expand(b, t)
    rot = apply_rope(base, steps, freqs).reshape(b, t, kh, KV_SINKS, hd)
    if ks is not None:
        rq, rsc = attn_ops.quant_rows(rot.reshape(b, t * kh, KV_SINKS, hd))
        rot = (rq.to(f32) * rsc[..., None]).reshape(b, t, kh, KV_SINKS, hd)
    else:
        rot = rot.to(ck.dtype).to(f32)
    sc_sink = torch.einsum("btkgh,btksh->bkgts", qc, cd(rot))
    scores = torch.cat([sc_sink, sc_ring, sc_draft], dim=-1)
    if cfg.attn_softcap:  # finite scores only: tanh(-inf) would bring back masked slots
        scores = torch.where(torch.isfinite(scores), softcap(scores, cfg.attn_softcap), scores)
    att = cd(torch.softmax(scores, dim=-1))
    a_sink, a_ring, a_draft = att[..., :KV_SINKS], att[..., KV_SINKS:KV_SINKS + s], \
        att[..., KV_SINKS + s:]
    out = (torch.einsum("bkgts,bksh->btkgh", a_sink, cd(vl[:, :, :KV_SINKS]))
           + torch.einsum("bkgts,bksh->btkgh", a_ring, cd(vl))
           + torch.einsum("bkgtj,bjkh->btkgh", a_draft, cd(vd)))
    return out.reshape(b, t, hq * hd), rows


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
    a8_prefill: bool = False,
    a8_decode: bool = False,
    spec_verify: bool = False,
    tp=None,
    pp=None,
):
    """One step over a (B, T) token block. Returns (logits, cache) with the
    cache updated in place. logits: (B, vocab) for "last", (B, T, vocab)
    for "all", None for "none", the greedy token ids (B,) for "token".
    tokens, pos and valid may lie on the host; they move to the weights'
    device where a path needs them there. ``a8_prefill``/``a8_decode``
    opt t > 1 chunks / t = 1 steps into the int8-activation routes.

    ``spec_verify``: a speculative verify chunk over a wrapped ring (t > 1,
    logits "all"): the attention of ``_spec_verify_attention``, which writes
    nothing to the cache, and the return is (logits, cache, rows), rows the
    chunk's rows in stored form stacked over the layers: (k, v) (L, B, T,
    KH, hd) in the cache's type, and for an int8 cache their (L, B, T, KH)
    scales after them."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if spec_verify and (tokens.shape[1] < 2 or logits_mode != "all"):
        raise ValueError("spec_verify takes a chunk of t > 1 tokens and logits_mode 'all'")
    if spec_verify and (tp is not None or pp is not None):
        raise ValueError("spec verify is single-device")
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
        int8/bf16/f32 weights go through kernel 1 (norm prologue and scale
        epilogue fused below 256 rows; W8A8 at 256 rows and more under
        ``a8_prefill``), q4 through kernel 1's q4 branch below 256 rows under
        the call's a8 opt-in and the dequantized layer otherwise, f16 and
        fp8 through ops.linear."""
        lead = xx.shape[:-1]
        xm = xx.reshape(-1, xx.shape[-1])
        m = xm.shape[0]
        decode_rows = xx.dim() != 3 or xx.shape[1] == 1
        if (per_layer and qw.q4group and layer is not None and m < 256
                and (a8_decode if decode_rows else a8_prefill)):
            if norm_sw is not None:
                xm = rmsnorm(xm, norm_sw[layer], cfg.norm_eps)
            y = mm_fn(xm.contiguous(), qw.values, layer, scale=qw.scale, q4_group=qw.q4group)
            return y.reshape(*lead, -1)
        # q4 here dequantizes the layer (the reference's XLA product)
        kernel_route = not qw.q4group and qmm.supported_weight_dtype(qw.values.dtype)
        if per_layer and kernel_route and layer is not None and m >= 256 and a8_prefill \
                and qw.values.dtype == torch.int8:
            # W8A8 prefill: int8 x per row times the int8 weights
            if norm_sw is not None:
                xm = rmsnorm(xm, norm_sw[layer], cfg.norm_eps)
            y = mm_fn(xm.contiguous(), qw.values, layer, scale=qw.scale,
                      q8_scale=Q8_FIXED_SCALE if qw.scale is None else None, a8=True)
            return y.reshape(*lead, -1)
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
            qw = QWeight(qw.values[layer], None if qw.scale is None else qw.scale[layer],
                         qw.q4group)
        return plain_linear(xm, qw, compute_dtype=compute_dtype).reshape(*lead, -1)

    def head(x: torch.Tensor):
        if logits_mode == "none":
            return None
        if logits_mode in ("last", "token"):
            x = x[:, -1:]
        logits = softcap(mm(rmsnorm(x, params.out_norm, cfg.norm_eps), params.wcls),
                         cfg.logit_softcap)
        if logits_mode in ("last", "token"):
            logits = logits[:, 0]
        if logits_mode == "token":
            if vocab is not None:
                return sharded_argmax(logits, vocab)
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return logits

    vocab = tp if pp is None else None  # the axis the head's vocab rows are split over
    if fused_step == "auto":
        fused_step = True  # the megakernel wherever it is supported
    if fused_step and t == 1 and per_layer and tp is None and pp is None and fd.fused_step_supported(
            cfg, params, cache.k, b, t, k_scale=cache.k_scale, a8=a8_decode):
        return _megakernel_step(params, cfg, tokens, pos, cache, valid, logits_mode, impl, head,
                                a8_decode)

    tokens = tokens.to(dev)
    pos = pos.to(device=dev, dtype=torch.int32)
    if valid is not None:
        valid = valid.to(dev)
    positions = pos[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    if t > 1:
        _, kv_pos, kv_len = ring_indices(positions, s)
        if valid is not None:
            kv_pos = torch.where(valid, kv_pos, s)  # sentinel: dropped write
        # the chunk's window, on the device; a valid row's chunk never
        # crosses the window's end, so only a masked row (a serving slot
        # decoding or free beside a packed prefill, pos up to past the
        # window) is clamped, its writes kept out and its attention bounded
        win0 = torch.clamp(pos, max=s - t)
        slots = win0.long()[:, None] + torch.arange(t, device=dev)
    else:
        # kv_pos at the sentinel for an invalid row, which neither writes
        # nor rotates its sinks
        kv_pos0, kv_len0, rot_flag = step_inputs(pos, s, None if valid is None else valid[:, 0])
        kv_pos, kv_len, active = kv_pos0[:, None], kv_len0[:, None], rot_flag.to(torch.bool)

    x = embed_lookup(params.embed, tokens)  # (B, T, dim) f32
    if cfg.embed_scale != 1.0:  # Gemma's residual normalizer, sqrt(dim)
        x = x * cfg.embed_scale
    lp = params.layers
    kv_update = attn_ops.kv_update if impl == "kernel" else attn_ops.kv_update_plain
    fused_decode = (attn_ops.fused_decode_attention if impl == "kernel"
                    else attn_ops.fused_decode_attention_plain)
    flash_prefill = attn_ops.flash_prefill if impl == "kernel" else attn_ops.flash_prefill_plain
    kv_update_q = attn_ops.kv_update_q if impl == "kernel" else attn_ops.kv_update_q_plain
    fused_decode_q = (attn_ops.fused_decode_attention_q if impl == "kernel"
                      else attn_ops.fused_decode_attention_q_plain)

    clip = cfg.qkv_clip if math.isfinite(cfg.qkv_clip) else None
    cap = cfg.attn_softcap  # set: the dense attention, never a cap-free kernel
    ck, cv, ks, vs = cache.k, cache.v, cache.k_scale, cache.v_scale
    quant = cache.quantized
    # kernels 2-4 take a bf16 or f32 cache; an f16 one goes the "xla" way
    float_kernels = per_layer and ck.dtype in attn_ops.FLOAT_CACHES

    def dense(layer: int, q: torch.Tensor):
        """The dense attention over the layer's cache rows (an int8 cache
        dequantised), the cap applied."""
        kl, vl = ck[layer], cv[layer]
        if quant:
            kl = kl.to(torch.float32) * ks[layer][..., None]
            vl = vl.to(torch.float32) * vs[layer][..., None]
        return attention(q, kl, vl, kv_len, compute_dtype, cap)

    rope = rope_tables(positions, freqs)  # shared by every layer
    layer_rows = []  # spec_verify: each layer's chunk rows in stored form

    def block(x: torch.Tensor, layer: int) -> torch.Tensor:
        """Layer ``layer`` of the local stack on the residual x."""
        qkv = mm(x, lp.wqkv, layer, norm_sw=lp.attn_norm)
        if lp.bqkv is not None:  # Qwen2 qkv bias, in wqkv's fused row order
            qkv = qkv + lp.bqkv[layer]
        q, k, v = split_qkv_rows(qkv, -1, g, hd)
        if clip is not None:
            q, k, v = (torch.clamp(z, -clip, clip) for z in (q, k, v))
        q, k, v = (z.reshape(b, t, -1, hd) for z in (q, k, v))
        if lp.q_norm is not None:  # Qwen3 per-head q/k RMS norms, before rope
            q = rmsnorm(q, lp.q_norm[layer], cfg.norm_eps)
            k = rmsnorm(k, lp.k_norm[layer], cfg.norm_eps)
        q = rotate(q, *rope)
        k = rotate(k, *rope)

        if spec_verify:
            attn_out, rows = _spec_verify_attention(q, k, v, ck, cv, ks, vs, layer, kv_pos, cfg,
                                                    freqs, compute_dtype)
            layer_rows.append(rows)
        elif per_layer and t == 1 and quant:
            # int8 decode: quantised ring write + sink re-rotation and the
            # flash-decode over the codes in one launch; under the cap the
            # write alone, then the dense attention
            kn, vn = k[:, 0].contiguous(), v[:, 0].contiguous()
            if cap:
                kv_update_q(ck, cv, ks, vs, layer, kn, vn, kv_pos0, rot_flag, cexp1, sexp1)
                attn_out = dense(layer, q)
            else:
                attn_out = fused_decode_q(q[:, 0].contiguous(), ck, cv, ks, vs, layer, kn, vn,
                                          kv_pos0, kv_len0, rot_flag, cexp1, sexp1)[:, None]
        elif float_kernels and t == 1:
            # decode: the in-place ring write + sink rotation and the
            # flash-decode in one launch; under the cap the write alone,
            # then the dense attention
            kn, vn = k[:, 0].contiguous(), v[:, 0].contiguous()
            if cap:
                kv_update(ck, cv, layer, kn, vn, kv_pos0, rot_flag, cexp1, sexp1)
                attn_out = dense(layer, q)
            else:
                attn_out = fused_decode(q[:, 0].contiguous(), ck, cv, layer, kn, vn, kv_pos0,
                                        kv_len0, rot_flag, cexp1, sexp1)[:, None]
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
            attn_out = dense(layer, q)
        elif float_kernels:
            # chunked prefill: contiguous in-place writes + causal flash
            _write_chunk(ck, layer, slots, k, valid)
            _write_chunk(cv, layer, slots, v, valid)
            attn_out = dense(layer, q) if cap else flash_prefill(q.contiguous(), ck, cv, layer, win0)
        else:  # "xla", and an f16 cache: scatter writes + dense masked attention
            _write_rows(ck, layer, kv_pos, k)
            _write_rows(cv, layer, kv_pos, v)
            if t == 1:
                _rotate_sinks(ck, layer, active, freqs)
            attn_out = dense(layer, q)
        proj = mm(attn_out, lp.wo, layer)
        if tp is not None:  # row-parallel wo: partial sums over the sharded heads
            proj = tp.all_reduce(proj)
        if lp.post_attn_norm is not None:  # Gemma-2 post-attention norm
            proj = rmsnorm(proj, lp.post_attn_norm[layer], cfg.norm_eps)
        x = x + proj

        if lp.w13e is not None:
            down = moe_ffn(x, lp, layer, cfg, impl, compute_dtype, a8_decode, tp)
        else:
            gate, up = split_w13_rows(mm(x, lp.w13, layer, norm_sw=lp.mlp_norm),
                                      ffn_chunk(cfg.hidden_dim))
            down = mm(act_fn(cfg.act, gate) * up, lp.w2, layer)
        if tp is not None:
            # row-parallel w2 (or this rank's experts): partial sums over tp
            down = tp.all_reduce(down)
        if lp.post_mlp_norm is not None:  # Gemma-2 post-feedforward norm
            down = rmsnorm(down, lp.post_mlp_norm[layer], cfg.norm_eps)
        return x + down

    n_local = lp.wqkv.values.shape[0]  # this stage's layers (all of them without pp)
    if pp is None:
        for layer in range(n_local):
            x = block(x, layer)
    else:
        # the stages in turn: the active one runs its layers, then hands its
        # residual to every other rank (the JAX ring plus its closing psum)
        x = x.contiguous()
        for stage in range(pp.size):
            if stage == pp.index:
                for layer in range(n_local):
                    x = block(x, layer)
                x = x.contiguous()
            pp.broadcast(x, stage)

    if spec_verify:
        return head(x), cache, tuple(torch.stack(p) for p in zip(*layer_rows))
    return head(x), cache


def _megakernel_step(params, cfg, tokens, pos, cache, valid, logits_mode, impl, head, a8):
    """A t = 1 step through the whole-step megakernel (the JAX forward's
    fused_decode_step branch). The step's inputs (kv_pos, kv_len, rotate,
    and without the embed fold the embed rows and the rope trig) are
    computed on the card from ``pos``, ``valid`` and ``tokens`` there, with
    no host read, so that a CUDA graph can capture the step."""
    step = fd.fused_decode_step if impl == "kernel" else fd.fused_decode_step_plain
    dev = params.embed.values.device
    b, s = tokens.shape[0], cfg.max_seq_len
    freqs, cexp1, sexp1 = rope_constants(cfg, dev)
    token = tokens[:, 0].to(dev)
    pos = pos.to(device=dev, dtype=torch.int32).reshape(b)
    kv_pos, kv_len, rotate_flag = step_inputs(
        pos, s, None if valid is None else valid[:, 0].to(dev))
    if b == 1 and fd.embed_fold_supported(cfg, params):
        # the kernel gathers the embed row and computes the rope trig itself
        x0 = cexp_p = sexp_p = None
        fold_e = dict(embed=params.embed, token=token, pos=pos, freqs=freqs)
    else:
        x0 = embed_lookup(params.embed, token) * cfg.embed_scale
        cexp_p, sexp_p = (z[:, 0, 0] for z in rope_tables(pos[:, None], freqs))
        fold_e = {}
    args = (params, cfg, x0, cache.k, cache.v, kv_pos, kv_len, rotate_flag, cexp_p, sexp_p,
            cexp1, sexp1)
    if cache.quantized:
        fold_e.update(k_scale=cache.k_scale, v_scale=cache.v_scale)
    if a8:
        fold_e["a8"] = True
    if logits_mode != "none" and fd.wcls_fold_supported(cfg, params):
        # final norm + i8 head + greedy argmax in the same launch
        _, logits, token = step(*args, wcls=params.wcls, out_norm=params.out_norm, **fold_e)[:3]
        if logits_mode == "token":
            return token, cache
        return (logits if logits_mode == "last" else logits[:, None]), cache
    x = step(*args, **fold_e)[0]
    return head(x[:, None]), cache
