"""Partition specs for megatron-style tensor parallelism plus data
parallelism (counterpart of ``xalm_tpu/parallel/shardings.py``), and the
slicing of this rank's shard out of the port's full weights and cache.

A spec is a tuple with one entry a dimension: a mesh axis name (the
dimension is split evenly over that axis, block r on index r) or None
(whole on every rank). The port's weights are (..., D, N) with D the
output rows, so in a stacked (L, D, N) weight:

- column-parallel is D (dim 1): wqkv, w13, and the vocab rows of the
  head. Fused wqkv is grouped by kv head and w13 interleaved by
  ``ffn_chunk``-row gate/up chunk pairs, so a block of rows is whole kv
  heads (with their query heads) and whole chunk pairs: the megatron
  column layout. The i8 row scales (L, D) and the Qwen2 bias shard with
  the rows.
- row-parallel is N (dim 2): wo and w2, whose products are partial sums
  that ``forward`` all-reduces over tp. Their row scales are whole.
- the expert stacks (L, E, ...) shard on E (expert parallelism); the
  router, the embedding, the norms are whole on every rank.
- the KV cache (L, B, KH, S, hd) and an int8 cache's (L, B, KH, S) scale
  planes: B over dp, KH over tp.
"""

from __future__ import annotations

import dataclasses

import torch

from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.models.params import LayerParams, ModelParams, QWeight, ffn_chunk
from xalm_tpu_torch.parallel.mesh import AXIS_DP, AXIS_TP
from xalm_tpu_torch.parallel.multihost import _block
from xalm_tpu_torch.runtime.cache import KVCache

__all__ = ["param_pspecs", "cache_pspecs", "shard_params", "shard_cache", "validate_tp",
           "shard_tree"]


def validate_tp(cfg: ModelConfig, tp: int) -> None:
    if cfg.n_kv_heads % tp != 0:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads} so GQA decode "
            f"stays chip-local"
        )
    if cfg.hidden_dim % tp != 0 or cfg.vocab_size % tp != 0:
        raise ValueError(f"tp={tp} must divide hidden_dim and vocab_size")
    if cfg.n_experts and cfg.n_experts % tp != 0:
        raise ValueError(f"tp={tp} must divide n_experts={cfg.n_experts}")
    chunks = cfg.hidden_dim // ffn_chunk(cfg.hidden_dim)
    if chunks % tp != 0:
        raise ValueError(
            f"tp={tp} must divide the fused gate/up chunk count {chunks} "
            f"(hidden_dim {cfg.hidden_dim} / chunk {ffn_chunk(cfg.hidden_dim)})"
        )


def param_pspecs(cfg: ModelConfig) -> ModelParams:
    """A ModelParams-shaped tree of specs (stacked layer dim first)."""
    col = QWeight(values=(None, AXIS_TP, None), scale=(None, AXIS_TP))
    row = QWeight(values=(None, None, AXIS_TP), scale=(None, None))
    layers = LayerParams(
        attn_norm=(None, None),
        wqkv=col,
        wo=row,
        mlp_norm=(None, None),
        w13=col,
        w2=row,
        bqkv=(None, AXIS_TP),
        wgate=(None, None, None),
        w13e=QWeight((None, AXIS_TP, None, None), (None, AXIS_TP, None)),
        w2e=QWeight((None, AXIS_TP, None, None), (None, AXIS_TP, None)),
        post_attn_norm=(None, None),
        post_mlp_norm=(None, None),
        q_norm=(None, None),
        k_norm=(None, None),
    )
    return ModelParams(
        embed=QWeight((None, None), (None,)),
        layers=layers,
        out_norm=(None,),
        wcls=QWeight((AXIS_TP, None), (AXIS_TP,)),  # vocab-sharded
    )


def cache_pspecs(cfg: ModelConfig, quantized: bool = False) -> KVCache:
    spec = (None, AXIS_DP, AXIS_TP, None, None)
    sspec = (None, AXIS_DP, AXIS_TP, None) if quantized else None
    return KVCache(k=spec, v=spec, k_scale=sspec, v_scale=sspec)


def _take(t: torch.Tensor | None, spec, mesh, device) -> torch.Tensor | None:
    """This rank's block of ``t`` under ``spec``: a copy of its own on
    ``device`` (never a view that would keep the full tensor alive), or
    ``t`` itself where the block is all of it and already on ``device``."""
    if t is None:
        return None
    block = t[_block(mesh, spec, t.shape)]
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if block.shape == t.shape and t.device == device:
        return t  # the whole tensor, where it already lies (a world of one, dp)
    return torch.empty(block.shape, dtype=block.dtype, device=device).copy_(block)


def shard_tree(params: ModelParams, specs: ModelParams, mesh, device) -> ModelParams:
    """Every tensor of ``params`` cut to this rank's block under the
    matching spec of ``specs``."""
    def qw(w: QWeight | None, spec: QWeight) -> QWeight | None:
        if w is None:
            return None
        if w.q4group:
            raise ValueError("packed q4 weights are single-device (the sharded engines stream "
                             "i8)")
        return QWeight(_take(w.values, spec.values, mesh, device),
                       _take(w.scale, spec.scale, mesh, device))

    def field(x, spec):
        return qw(x, spec) if isinstance(spec, QWeight) else _take(x, spec, mesh, device)

    lp, ls = params.layers, specs.layers
    layers = LayerParams(**{f.name: field(getattr(lp, f.name), getattr(ls, f.name))
                            for f in dataclasses.fields(LayerParams)})
    return ModelParams(embed=qw(params.embed, specs.embed), layers=layers,
                       out_norm=_take(params.out_norm, specs.out_norm, mesh, device),
                       wcls=qw(params.wcls, specs.wcls))


def shard_params(params: ModelParams, cfg: ModelConfig, mesh, device=None) -> ModelParams:
    """This rank's megatron shard of the full ``params`` on ``device``
    (default: the mesh's)."""
    validate_tp(cfg, mesh.shape.get(AXIS_TP, 1))
    return shard_tree(params, param_pspecs(cfg), mesh, mesh.device if device is None else device)


def shard_cache(cache: KVCache, cfg: ModelConfig, mesh, device=None) -> KVCache:
    """This rank's block of a full cache: batch rows over dp, kv heads over tp."""
    specs = cache_pspecs(cfg, cache.quantized)
    dev = mesh.device if device is None else device
    return KVCache(*(_take(t, s, mesh, dev) for t, s in zip(
        (cache.k, cache.v, cache.k_scale, cache.v_scale),
        (specs.k, specs.v, specs.k_scale, specs.v_scale))))
