"""Tensor/data-parallel engine: the Engine over a (dp, tp) mesh of ranks
(counterpart of ``xalm_tpu/parallel/sharded_engine.py``).

Each rank is one process holding its megatron shard of the weights
(``parallel/shardings.py``) and its block of the cache (its dp rows, its
tp kv heads), and runs ``forward`` with its tp axis: the port's kernels
on the local shapes, the two row-parallel all-reduces inside each layer,
a vocab-sharded head whose greedy token comes from ``sharded_argmax``. dp
splits the batch with no collective on the decode path; a batch that is no
multiple of dp is padded with ``valid=False`` rows, which neither write
the cache nor rotate sinks.

Every rank returns the global result, as the JAX caller sees it through
``np.asarray``: logits (B, V) where asked, tokens (B, n). So the harness
and the batcher run the same code on one device or many.

Decode scans replay CUDA graphs on NCCL with the collectives captured; a
gloo collective cannot be captured, so on gloo the steps run eagerly
(``Engine.capture_steps``), a choice by backend that ``decode_path`` names.
Sampled decode gathers the logits over tp and every rank of a tp group
draws the same token from the same key; each dp group folds its index
into the key (``prng.fold_in``, the JAX ``fold_in(key, axis_index(dp))``),
so equal prompts on two dp rows draw apart. The engine has no per-row
sampled scan (``sample_scan_rows`` is None), and so the batcher refuses
sampled and log-prob requests, as the JAX batcher does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from xalm_tpu_torch import prng
from xalm_tpu_torch.io import XalmFile
from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.models.llama import gathered_ok
from xalm_tpu_torch.models.params import ModelParams, load_params
from xalm_tpu_torch.parallel.mesh import (  # noqa: F401  (re-exported)
    AXIS_DP,
    AXIS_TP,
    Mesh,
    sharded_argmax,
    sharded_token_logprobs,
)
from xalm_tpu_torch.parallel.shardings import shard_params, validate_tp
from xalm_tpu_torch.runtime.cache import KVCache
from xalm_tpu_torch.runtime.engine import Engine, weight_bytes_per_token
from xalm_tpu_torch.tokenizer import Tokenizer

__all__ = ["ShardedEngine", "sharded_argmax", "sharded_token_logprobs"]


def _pad_rows(x, bp: int, fill=0) -> torch.Tensor:
    """x (b, ...) padded to bp rows with ``fill`` (a tensor stays on its device)."""
    x = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
    b = x.shape[0]
    if b == bp:
        return x
    pad = torch.full((bp - b,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def backend_of(mesh: Mesh) -> str | None:
    """The backend of the mesh's process groups (None for a layout-only mesh)."""
    group = mesh.axis("mesh").group
    return None if group is None else dist.get_backend(group)


def load_full(path: str, context: int, device, f16_mode: str = "auto", fp8_mode: str = "auto"):
    """(cfg, params on the host, tokenizer, chat template) of a container,
    its f16 and fp8 weights converted as ``load_params`` converts them for
    ``device``: the sharded engines cut their shards from the host copy,
    never from a full copy on the card."""
    on_card = torch.device(device).type == "cuda"
    if f16_mode == "auto":
        f16_mode = "bf16" if on_card else "keep"
    if fp8_mode == "auto":
        fp8_mode = "recode" if on_card else "keep"
    with XalmFile(path) as xf:
        cfg = ModelConfig.from_metadata(xf.config, context)
        params = load_params(xf, cfg, device="cpu", f16_mode=f16_mode, fp8_mode=fp8_mode)
        tokenizer = Tokenizer.from_xalm(xf) if "tokenizer.tokens" in xf else None
        chat_template = xf.config.get("chat_template")
    return cfg, params, tokenizer, chat_template


class ShardedEngine(Engine):
    """Engine whose steps run this rank's shards over a (dp, tp) mesh."""

    sample_scan_rows = None  # no per-row sampled scan: the batcher refuses those requests

    def __init__(
        self,
        cfg: ModelConfig,
        params: ModelParams,
        tokenizer: Tokenizer | None,
        mesh: Mesh,
        *,
        kv_dtype="auto",
        compute_dtype="auto",
        matmul_impl: str = "auto",
        a8_prefill: bool = False,
    ):
        """``params``: the FULL weights (on the host or a device); this
        rank keeps its shard of them on ``mesh.device``."""
        validate_tp(cfg, mesh.shape[AXIS_TP])
        if not mesh.member:
            raise ValueError("this rank holds no place in the mesh")
        self.mesh = mesh
        impl = "kernel" if matmul_impl == "auto" else matmul_impl
        moe = params.layers.w13e is not None
        # the whole model's bytes a token, as the JAX engine counts its global arrays
        full_bytes = weight_bytes_per_token(cfg, params, False if moe and mesh.shape[AXIS_TP] > 1
                                            else moe and gathered_ok(params.layers.w13e, impl))
        super().__init__(cfg, shard_params(params, cfg, mesh), tokenizer, kv_dtype=kv_dtype,
                         compute_dtype=compute_dtype, matmul_impl=matmul_impl,
                         a8_prefill=a8_prefill, fused_step=False)
        self._per_token_weight_bytes = full_bytes
        self._tp, self._dp = mesh.axis(AXIS_TP), mesh.axis(AXIS_DP)
        self.vocab_axis = self._tp
        self.backend = backend_of(mesh)
        self.capture_steps = self.backend != "gloo"

    @classmethod
    def from_xalm(cls, path: str, mesh: Mesh, *, context: int = 0, fp8_mode: str = "auto",
                  device=None, **kw) -> "ShardedEngine":
        """Load a container on the host and keep this rank's shard on
        ``device`` (default: the mesh's, the card unless the world runs on
        the CPU)."""
        if device is not None:
            mesh.device = torch.device(device)
        cfg, params, tokenizer, chat_template = load_full(path, context, mesh.device,
                                                          fp8_mode=fp8_mode)
        eng = cls(cfg, params, tokenizer, mesh, **kw)
        eng.chat_template = chat_template
        return eng

    def decode_path(self, batch: int = 1) -> str:
        """The megakernel is single-device (the forward gates it on tp):
        every sharded decode step runs the per-layer kernels."""
        path = f"perlayer (dp={self._dp.size} tp={self._tp.size})"
        if self.device.type == "cuda" and not self.capture_steps:
            path += ", eager steps: gloo collectives cannot be captured"
        return path

    def _forward_kw(self) -> dict:
        return dict(super()._forward_kw(), tp=self._tp)

    # ------------------------------------------------------ batch padding

    def _padded(self, cache: KVCache) -> int:
        return cache.batch * self._dp.size

    def _mine(self, x, bp: int, fill=0):
        """This rank's dp rows of x padded to bp rows."""
        x = _pad_rows(x, bp, fill)
        bl = bp // self._dp.size
        return x[self._dp.index * bl:(self._dp.index + 1) * bl]

    def new_cache(self, batch: int = 1) -> KVCache:
        """This rank's block of a cache of ``batch`` rows padded to a
        multiple of dp: its rows, its kv heads."""
        dp, tp = self._dp.size, self._tp.size
        bp = -(-batch // dp) * dp
        shape = list(KVCache.plane_shape(self.cfg, bp))
        shape[1] //= dp
        shape[2] //= tp
        return KVCache.zeros(tuple(shape), self.kv_dtype, self.device)

    def copy_lane(self, cache: KVCache, dst: int, src: int) -> KVCache:
        """Copy global lane ``src`` onto lane ``dst`` (the serving prefix
        cache): in place where one dp rank holds both, else broadcast over
        dp from the holder of ``src``."""
        bl = cache.batch
        hold_src, hold_dst = src // bl, dst // bl
        for plane in cache.planes():
            if hold_src == hold_dst:
                if self._dp.index == hold_src:
                    plane[:, dst % bl].copy_(plane[:, src % bl])
                continue
            buf = plane[:, src % bl].contiguous() if self._dp.index == hold_src else \
                torch.empty_like(plane[:, 0])
            self._dp.broadcast(buf, hold_src)
            if self._dp.index == hold_dst:
                plane[:, dst % bl].copy_(buf)
        return cache

    # ------------------------------------------------------------- steps

    def step(self, tokens, pos, cache: KVCache, valid=None, logits_mode="last"):
        tokens = np.asarray(tokens)
        b, bp = tokens.shape[0], self._padded(cache)
        if valid is None and b != bp:
            valid = np.ones(tokens.shape, bool)
        mine = self._mine(tokens, bp)
        pos = self._mine(np.asarray(pos, np.int32), bp)
        if valid is not None:
            valid = self._mine(np.asarray(valid, bool), bp, False)
        out, cache = super().step(mine, pos, cache, valid, logits_mode)
        if out is None:
            return None, cache
        with torch.inference_mode():
            if logits_mode != "token":
                out = self._tp.gather(out, -1)
            return self._dp.gather(out, 0)[:b], cache

    def _scan_key(self, key: torch.Tensor) -> torch.Tensor:
        return prng.fold_in(key, self._dp.index)

    def _load(self, st, tokens, pos, valid=None) -> None:
        bp = st.token.shape[0] * self._dp.size
        Engine._load(st, self._mine(tokens, bp), self._mine(pos, bp),
                     None if valid is None else self._mine(valid, bp, False))

    def _run(self, st, graph, n_steps: int, top5: bool = False):
        return self._dp.gather(Engine._run(st, graph, n_steps), 0)

    def decode_scan(self, tokens, pos, cache: KVCache, n_steps: int, valid=None):
        b = len(tokens)
        if valid is None and b != self._padded(cache):
            valid = np.ones((b,), bool)
        toks, cache = super().decode_scan(tokens, pos, cache, n_steps, valid)
        return toks[:b], cache

    def _sample_scan(self, tokens, pos, cache: KVCache, key, n_steps: int, *,
                     temperature: float, top_k: int = 0, top_p: float = 1.0, valid=None):
        b = len(tokens)
        if valid is None and b != self._padded(cache):
            valid = np.ones((b,), bool)
        toks, cache = super()._sample_scan(tokens, pos, cache, key, n_steps,
                                           temperature=temperature, top_k=top_k, top_p=top_p,
                                           valid=valid)
        return toks[:b], cache

    def _ppl_scan(self, toks, tgts, pos, cache: KVCache):
        toks, tgts = (np.asarray(a, np.int32) for a in (toks, tgts))
        b, k, bp = toks.shape[0], toks.shape[1], self._padded(cache)
        with torch.inference_mode():
            st, graph = self._scan(cache, "ppl")
            st.toks[:, :k].copy_(self._mine(toks, bp))
            st.tgts[:, :k].copy_(self._mine(tgts, bp))
            self._load(st, toks[:, 0], np.asarray(pos, np.int32))
            return self._run(st, graph, k)[:b], cache

    def generate(self, prompt_ids, max_new_tokens, *, resume=None, return_session=False,
                 **kw):
        if resume is not None or return_session:
            raise NotImplementedError("sessions are single-device: save and resume them with "
                                      "Engine")
        return super().generate(prompt_ids, max_new_tokens, **kw)
