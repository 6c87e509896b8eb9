"""Synthetic (random) model parameters at real shapes (counterpart of
``xalm_tpu/utils/synthetic.py``).

Decode time does not depend on the weight values, so benchmarks and the
chip smoke run random weights at the shapes of its configurations.
Everything is drawn directly on ``device`` from a seeded
``torch.Generator``, in the fused layouts at the fused shapes (random
weights need no interleave pass): the body in ``weight_dtype`` (int8 with
per-row ``scale_mag/127`` scales, or a float dtype at ``randn *
scale_mag``), embed and head in ``embed_dtype`` (bf16 by default), f32 unit
norms; for MoE a ``randn * 0.3`` f32 router and expert stacks in
``weight_dtype``. int8 codes are drawn straight into an int8 tensor
(Mixtral's (L, E, 2h, d) stack is 30.1 GB; a wider transient would not fit
beside it). ``q4_group`` > 0 draws the body packed (as the JAX function
does, "no recode peak"): random bytes, two uniform nibbles each, and group
scales ``scale_mag/7`` times uniform [0.75, 1.25), so that a kernel reading
the wrong group's scale moves the output. Mixtral's packed body is 24.6 GB;
drawn as i8 and recoded it would peak near 71 GB of the card's 80.

Family extras, drawn so that they move the logits visibly: ``qkv_bias``
(Qwen2) draws a (L, DQ) f32 bias at the scale of the qkv outputs (a normed
x of unit rms times a row of codes uniform in [-128, 128) at 0.02/127 each
gives a std of about 0.02 * sqrt(dim / 3)); ``cfg.qk_norm`` (Qwen3) draws
(L, head_dim) q/k norm weights uniform in [0.5, 1.5); ``cfg.post_norms``
(Gemma-2) draws (L, dim) post-attention and post-feedforward norm weights
uniform in [0.5, 1.5). Gelu and the embed scale (Gemma) need no weights.

A published softcap hardly bites on random weights: Gemma-2's 50 on
scores of std 0.5-0.7, its 30 on logits of max 14. ``biting_softcaps``
gives a config whose caps move the scores and logits of these weights by
far more than rounding (see its docstring).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.models.params import LayerParams, ModelParams, QWeight

__all__ = ["synthetic_params", "biting_softcaps", "score_std", "logit_std"]


def score_std(dim: int) -> float:
    """The std of the attention scores of these weights, by construction:
    codes uniform in [-128, 128) have a std of 73.9, so a weight of scale
    0.02/127 one of 0.0116, and q and k of a unit-rms x one of 0.0116
    sqrt(dim) each (0.7 at dim 3584); their dot over head_dim lanes, scaled
    by 1/sqrt(head_dim), the square of that (0.49; against a cache of unit
    normals 0.7)."""
    return (0.02 / 127 * 73.9) ** 2 * dim


def logit_std(dim: int) -> float:
    """The std of the logits: bf16 head rows of std 0.05 against a unit-rms
    x, 0.05 sqrt(dim) (3.0 at dim 3584; the max over 256000 rows about 14)."""
    return 0.05 * math.sqrt(dim)


def _qweight(gen, shape, dtype, device, scale_mag=0.02, q4_group=0) -> QWeight:
    if q4_group:
        k = shape[-1]
        if k % (2 * q4_group) or q4_group % 128:
            raise ValueError(f"q4 group {q4_group} must be a 128-multiple dividing K/2={k // 2}")
        q = torch.randint(-128, 128, (*shape[:-1], k // 2), dtype=torch.int8, device=device,
                          generator=gen)
        scale = torch.rand((*shape[:-1], k // q4_group), generator=gen, device=device)
        return QWeight(q, scale.mul_(0.5).add_(0.75).mul_(scale_mag / 7.0), q4_group)
    if dtype == torch.int8:
        q = torch.randint(-128, 128, shape, dtype=torch.int8, device=device, generator=gen)
        scale = torch.full(shape[:-1], scale_mag / 127.0, dtype=torch.float32, device=device)
        return QWeight(q, scale)
    w = torch.randn(shape, dtype=dtype, device=device, generator=gen)
    return QWeight(w.mul_(scale_mag), None)


def synthetic_params(cfg: ModelConfig, device="cuda", seed: int = 42,
                     q4_group: int = 0, qkv_bias: bool = False,
                     weight_dtype: torch.dtype = torch.int8,
                     embed_dtype: torch.dtype = torch.bfloat16) -> ModelParams:
    """Random ModelParams at cfg's shapes on ``device`` (dense, or MoE when
    ``cfg.n_experts``): the body in ``weight_dtype``, or packed q4 when
    ``q4_group`` > 0; embed and head in ``embed_dtype``; a Qwen2 qkv bias
    with ``qkv_bias``, Qwen3 q/k norms with ``cfg.qk_norm``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, d, h, q, kv, v = (
        cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim, cfg.vocab_size,
    )
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=device)  # noqa: E731

    def body(*shape) -> QWeight:
        return _qweight(gen, shape, weight_dtype, device, q4_group=q4_group)

    layers = LayerParams(
        attn_norm=ones(L, d),
        wqkv=body(L, q + 2 * kv, d),
        wo=body(L, d, q),
        mlp_norm=ones(L, d),
    )
    if cfg.n_experts:
        e = cfg.n_experts
        layers.wgate = torch.randn((L, e, d), generator=gen, device=device).mul_(0.3)
        layers.w13e = body(L, e, 2 * h, d)
        layers.w2e = body(L, e, d, h)
    else:
        layers.w13 = body(L, 2 * h, d)
        layers.w2 = body(L, d, h)
    if qkv_bias:
        layers.bqkv = torch.randn((L, q + 2 * kv), generator=gen, device=device).mul_(
            0.02 * math.sqrt(d / 3))
    if cfg.qk_norm:
        layers.q_norm, layers.k_norm = (
            torch.rand((L, cfg.head_dim), generator=gen, device=device).add_(0.5)
            for _ in range(2))
    if cfg.post_norms:
        layers.post_attn_norm, layers.post_mlp_norm = (
            torch.rand((L, d), generator=gen, device=device).add_(0.5) for _ in range(2))
    embed = _qweight(gen, (v, d), embed_dtype, device, scale_mag=0.05)
    wcls = embed if cfg.tie_word_embeddings else _qweight(gen, (v, d), embed_dtype, device, 0.05)
    return ModelParams(embed=embed, layers=layers, out_norm=ones(d), wcls=wcls)


def biting_softcaps(cfg: ModelConfig) -> ModelConfig:
    """cfg with softcaps that bite on ``synthetic_params``'s weights, where
    it has them: the attention cap at 2 x the scores' std (``score_std``;
    against a cache of unit normals about 1.4 x), so that the largest scores
    of a 4096-slot window (3-4 std) lose 20-60 % of their value, and the
    logit cap at 2 x the logits' std (``logit_std``), so that the top logits
    (4-5 std over a large vocabulary) lose over half of theirs. Both keep
    scores and logits apart: tanh is strictly monotone."""
    return dataclasses.replace(
        cfg, attn_softcap=2.0 * score_std(cfg.dim) if cfg.attn_softcap else 0.0,
        logit_softcap=2.0 * logit_std(cfg.dim) if cfg.logit_softcap else 0.0)
