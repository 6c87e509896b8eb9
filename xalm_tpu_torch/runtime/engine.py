"""Inference engine (counterpart of ``xalm_tpu/runtime/engine.py::Engine``):
load a .xalm model, chunked prefill, greedy decode, perplexity, and the
active-bytes model behind the GB/s figure.

Chunk contract (see models/llama.py): T > 1 calls never wrap the KV ring;
the engine switches to T = 1 stepping once pos reaches the window. Prompt
chunks are padded to ``_CHUNK_BUCKETS`` with a ``valid`` mask, as in the
JAX engine, so both run the same shapes.

Decode is one forward call per token (the JAX engine's ``segment=1``); a
decode step runs the whole-step megakernel where ``fused_step`` allows and
its gate passes (``decode_path``), else the per-layer kernels (always for
MoE, whose B = 1 steps gather the chosen experts). ``a8_decode`` runs the
megakernel's int8-activation body (and the q4 GEMV per layer),
``a8_prefill`` the W8A8 GEMM on prefill chunks; ``from_xalm(q4_group=g)``
packs the body to q4 at load and implies ``a8_decode``. Stochastic
sampling, sessions and speculation are later slices.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import numpy as np
import torch

from xalm_tpu_torch.io import XalmFile
from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.models.llama import IMPLS, forward, gathered_ok
from xalm_tpu_torch.models.params import (
    ModelParams,
    load_params,
    recode_params_q4,
    recode_wcls_i8,
)
from xalm_tpu_torch.ops.fused_decode import fused_step_supported
from xalm_tpu_torch.runtime.cache import KVCache
from xalm_tpu_torch.sampler import sample_argmax, token_logprobs
from xalm_tpu_torch.tokenizer import Tokenizer

__all__ = ["Engine", "GenerationStats", "auto_kv_dtype"]

_CHUNK_BUCKETS = (16, 32, 64, 128, 256, 512)
# the caches of the JAX harness's -t: bf16 and f32 on kernels 2-4 (and the
# megakernel), int8 on kernels 5-7, f16 on the dense attention (the forward
# routes each by its dtype, as the reference does)
KV_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.int8)


def _bucket(n: int) -> int:
    for b in _CHUNK_BUCKETS:
        if n <= b:
            return b
    return _CHUNK_BUCKETS[-1]


@dataclasses.dataclass
class GenerationStats:
    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    active_bytes: int = 0  # cumulative bytes touched during decode

    @property
    def tok_per_s(self) -> float:
        return self.generated_tokens / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def bandwidth_gb_s(self) -> float:
        return self.active_bytes / self.decode_s / 1e9 if self.decode_s > 0 else 0.0


def auto_kv_dtype(device) -> torch.dtype:
    """The cache dtype of ``kv_dtype="auto"`` (the harness's default ``-t``)
    on ``device``: bf16 on the card, the attention kernels' and the
    megakernel's type; f16 on the CPU, the JAX package's default (the JAX
    harness's on every device: on the card f16 would take the dense
    attention on every chunk and step)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float16


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: ModelParams,
        tokenizer: Tokenizer | None = None,
        *,
        kv_dtype="auto",
        compute_dtype="auto",
        matmul_impl: str = "auto",
        a8_prefill: bool = False,
        a8_decode: bool = False,
        fused_step: bool | str = "auto",
        wcls_i8: bool = False,
    ):
        if wcls_i8:  # the i8 head: half the head's bytes, and the megakernel runs it
            params = recode_wcls_i8(params)
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = params.embed.values.device
        on_card = self.device.type == "cuda"
        # bf16 cache and matmul inputs on the card (the kernels' types);
        # the CPU keeps the JAX package's off-TPU defaults (f16 KV, f32)
        self.kv_dtype = auto_kv_dtype(self.device) if kv_dtype == "auto" else kv_dtype
        self.compute_dtype = (
            (torch.bfloat16 if on_card else torch.float32) if compute_dtype == "auto" else compute_dtype
        )
        self.matmul_impl = "kernel" if matmul_impl == "auto" else matmul_impl
        self.a8_prefill = a8_prefill
        self.a8_decode = a8_decode
        self.fused_step = fused_step
        if self.matmul_impl not in IMPLS:
            raise ValueError(f"matmul_impl {matmul_impl!r}: one of auto, {', '.join(IMPLS)}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv dtype {self.kv_dtype}: one of {', '.join(map(str, KV_DTYPES))}")

    # ------------------------------------------------------------------ load

    @classmethod
    def from_xalm(
        cls,
        path: str,
        *,
        context: int = 0,
        kv_dtype="auto",
        compute_dtype="auto",
        matmul_impl: str = "auto",
        a8_prefill: bool = False,
        a8_decode: bool = False,
        q4_group: int = 0,
        fused_step: bool | str = "auto",
        wcls_i8: bool = False,
        f16_mode: str = "auto",
        fp8_mode: str = "auto",
        device="cuda",
    ) -> "Engine":
        """Load a container. ``f16_mode`` and ``fp8_mode`` are
        ``load_params``'s (on the card f16 weights load as bf16 and fp8
        weights as i8 rows by default). ``q4_group`` > 0 re-codes the four
        body weights to packed q4 on ``device`` once loaded (one layer's f32
        temporary at a time) and implies ``a8_decode``: the q4 dots take
        int8 activations."""
        with XalmFile(path) as xf:
            cfg = ModelConfig.from_metadata(xf.config, context)
            params = load_params(xf, cfg, device=device, f16_mode=f16_mode, fp8_mode=fp8_mode)
            tokenizer = Tokenizer.from_xalm(xf) if "tokenizer.tokens" in xf else None
        if q4_group:
            params = recode_params_q4(params, group=q4_group)
            a8_decode = True
        return cls(
            cfg, params, tokenizer,
            kv_dtype=kv_dtype, compute_dtype=compute_dtype, matmul_impl=matmul_impl,
            a8_prefill=a8_prefill, a8_decode=a8_decode, fused_step=fused_step, wcls_i8=wcls_i8,
        )

    # ----------------------------------------------------------------- steps

    def new_cache(self, batch: int = 1) -> KVCache:
        return KVCache.init(self.cfg, batch, self.kv_dtype, self.device)

    def decode_path(self, batch: int = 1) -> str:
        """Which implementation a (batch, T=1) decode step runs, from the
        forward's own gates: 'megakernel' (the whole-step kernel), 'perlayer'
        (the per-layer kernels, and on the card for a head_dim the
        megakernel does not take, Phi-3's 96; on the CPU both run their
        plain versions),
        'xla' for a q4 body that dequantizes (no ``a8_decode``, or batch >=
        256), or the impl name for 'plain' and 'xla'."""
        if self.matmul_impl != "kernel":
            return self.matmul_impl
        shape = KVCache.plane_shape(self.cfg, batch)
        cache_k = torch.empty(shape, dtype=self.kv_dtype, device="meta")
        k_scale = torch.empty(shape[:-1], device="meta") if self.kv_dtype == torch.int8 else None
        if self.fused_step and fused_step_supported(self.cfg, self.params, cache_k, batch, 1,
                                                    k_scale=k_scale, a8=self.a8_decode):
            return "megakernel"
        if self.params.layers.wqkv.q4group and (batch >= 256 or not self.a8_decode):
            return "xla"
        return "perlayer"

    def step(self, tokens, pos, cache: KVCache, valid=None, logits_mode="last"):
        """Forward on a (B, T) block at positions pos (B,). Returns
        (logits, cache); the cache is updated in place. The inputs stay on
        the host: the forward moves what a path needs to the card."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        pos = torch.as_tensor(np.asarray(pos), dtype=torch.int32)
        if valid is not None:
            valid = torch.as_tensor(np.asarray(valid), dtype=torch.bool)
        with torch.inference_mode():
            return forward(
                self.params, self.cfg, tokens, pos, cache, valid,
                logits_mode=logits_mode, compute_dtype=self.compute_dtype,
                impl=self.matmul_impl, fused_step=self.fused_step,
                a8_prefill=self.a8_prefill, a8_decode=self.a8_decode,
            )

    def decode(self, tokens, pos, cache: KVCache):
        """One decode step: tokens (B,), pos (B,) -> logits (B, vocab)."""
        return self.step(np.asarray(tokens)[:, None], pos, cache, logits_mode="last")

    def prefill(self, token_ids: list[int], cache: KVCache, logits_mode="last", start_pos: int = 0):
        """Feed one prompt (batch 1) through chunked prefill. Returns
        (last-token logits (1, vocab) | per-token logits (n, vocab) numpy for
        "all", cache, pos). Bucketed chunk shapes with masked padding; T=1
        stepping once the ring would wrap."""
        s = self.cfg.max_seq_len
        n = start_pos + len(token_ids)
        pos = start_pos
        logits = None
        all_logits = []
        while pos < n:
            remaining = n - pos
            if pos + 1 > s - 1 and remaining > 1:
                t = 1  # ring about to wrap: per-token stepping from here on
            else:
                t = min(remaining, _CHUNK_BUCKETS[-1], max(s - pos, 1))
            bucket = _bucket(t) if t > 1 else 1
            if t > 1 and pos + bucket > s:
                bucket = t  # never let a padded bucket cross the ring boundary
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :t] = token_ids[pos - start_pos : pos - start_pos + t]
            valid = np.zeros((1, bucket), bool)
            valid[0, :t] = True
            is_last = pos + t >= n
            if logits_mode == "all":
                mode = "all"
            elif is_last and logits_mode == "last":
                mode = "last" if t == bucket else "all"
            else:
                mode = "none"
            out, cache = self.step(
                padded, np.array([pos], np.int32), cache,
                valid if t != bucket else None, logits_mode=mode,
            )
            if logits_mode == "all":
                all_logits.append(out[0, :t].float().cpu().numpy())
            elif is_last and logits_mode == "last":
                logits = out if mode == "last" else out[:, t - 1]
            pos += t
        if logits_mode == "all":
            return np.concatenate(all_logits, axis=0), cache, pos
        return logits, cache, pos

    # ------------------------------------------------------------- workloads

    def generate(
        self,
        prompt_ids: list[int],
        max_new_tokens: int,
        *,
        on_token=None,
        stop_on_eos: bool = True,
        temperature: float = 0.0,
    ):
        """Greedy completion. Returns (generated ids, GenerationStats); the
        time of each phase ends in a device synchronise."""
        if temperature > 0.0:
            raise NotImplementedError(
                "stochastic sampling is not wired into this engine; use temperature=0 (greedy)"
            )
        stats = GenerationStats(prompt_tokens=len(prompt_ids))
        cache = self.new_cache(1)
        t0 = time.perf_counter()
        logits, cache, pos = self.prefill(prompt_ids, cache, logits_mode="last")
        token = int(sample_argmax(logits)[0])  # copies to the host: a sync
        stats.prefill_s = time.perf_counter() - t0

        out: list[int] = []

        def emit(t) -> bool:
            out.append(t)
            if on_token is not None:
                on_token(t)
            return stop_on_eos and self.tokenizer is not None and self.tokenizer.is_stop(t)

        t0 = time.perf_counter()
        stopped = emit(token)
        while not stopped and len(out) < max_new_tokens:
            logits, cache = self.decode(np.array([token]), np.array([pos], np.int32), cache)
            token = int(sample_argmax(logits)[0])
            stats.active_bytes += self.active_bytes(pos)
            stopped = emit(token)
            pos += 1
        stats.decode_s = time.perf_counter() - t0
        stats.generated_tokens = len(out)
        return out, stats

    def perplexity(self, token_ids: list[int]) -> tuple[float, float, int]:
        """(ppl, stderr, n) over a prompt: forward every token, accumulate
        log p of the next."""
        n = len(token_ids)
        if n < 2:
            raise ValueError("perplexity needs at least 2 tokens")
        cache = self.new_cache(1)
        s = self.cfg.max_seq_len
        head = min(n, s)
        logits_all, cache, pos = self.prefill(token_ids[:head], cache, logits_mode="all")
        targets = np.asarray(token_ids[1 : min(head + 1, n)], np.int64)
        lps = token_logprobs(
            torch.from_numpy(logits_all[: len(targets)]), torch.from_numpy(targets)
        ).numpy().astype(np.float64)
        sum_lp = float(lps.sum())
        sum_lp2 = float((lps**2).sum())
        count = len(lps)
        # wrapped tail (ring + sinks active): teacher-forced T=1 steps
        while pos < n - 1:
            logits, cache = self.decode(np.array([token_ids[pos]]), np.array([pos], np.int32), cache)
            tgt = torch.tensor([token_ids[pos + 1]], device=logits.device)
            lp = float(token_logprobs(logits, tgt)[0])
            sum_lp += lp
            sum_lp2 += lp * lp
            count += 1
            pos += 1
        ppl = math.exp(-sum_lp / count)
        err = ppl * math.sqrt(max(sum_lp2 - sum_lp * sum_lp / count, 0.0) / count / count)
        return ppl, err, count

    # ----------------------------------------------------------- accounting

    @functools.cached_property
    def _per_token_weight_bytes(self) -> int:
        """Weight bytes a decode step reads: q4 weights count their packed
        bytes and group scales; the norms and the family planes (qkv bias,
        q/k norms, post-norms) their f32 bytes. MoE: the k/E share of the expert stacks where
        B = 1 decode gathers the chosen experts (the per-layer paths, a dtype
        the gather takes; q4 experts under ``a8_decode``, the JAX rule), all
        E otherwise, and the router."""
        cfg, p = self.cfg, self.params
        lw = p.layers
        total = sum(w.nbytes() for w in (lw.wqkv, lw.wo, lw.w13, lw.w2) if w is not None)
        if lw.w13e is not None:
            experts = lw.w13e.nbytes() + lw.w2e.nbytes()
            if gathered_ok(lw.w13e, self.matmul_impl, self.a8_decode):
                experts = experts * cfg.n_experts_active // max(cfg.n_experts, 1)
            total += experts + 4 * lw.wgate.nelement()
        total += 4 * (lw.attn_norm.nelement() + lw.mlp_norm.nelement() + p.out_norm.nelement())
        total += 4 * sum(t.nelement() for t in (lw.bqkv, lw.q_norm, lw.k_norm, lw.post_attn_norm,
                                                lw.post_mlp_norm) if t is not None)
        total += p.embed.nbytes() // cfg.vocab_size  # one embedding row read
        total += p.wcls.nbytes()
        return int(total)

    def active_bytes(self, pos: int) -> int:
        """Bytes touched per decoded token at position pos: all live weight
        bytes + the cache rows up to kv_len + the new rows written, and for
        an int8 cache the f32 row scales read and written beside them."""
        cfg = self.cfg
        kv_len = min(pos + 1, cfg.max_seq_len)
        kv_elt = torch.empty((), dtype=self.kv_dtype).element_size()
        kv_read = 2 * cfg.n_layers * kv_len * cfg.kv_dim * kv_elt
        kv_write = 2 * cfg.n_layers * cfg.kv_dim * kv_elt
        total = self._per_token_weight_bytes + kv_read + kv_write
        if self.kv_dtype == torch.int8:
            total += 2 * cfg.n_layers * cfg.n_kv_heads * (kv_len + 1) * 4
        return total
