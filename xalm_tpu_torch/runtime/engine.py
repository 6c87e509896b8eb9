"""Inference engine (counterpart of ``xalm_tpu/runtime/engine.py::Engine``):
load a .xalm model, chunked prefill, greedy and sampled decode, scanned
decode, perplexity, and the active-bytes model behind the GB/s figure.

Chunk contract (see models/llama.py): T > 1 calls never wrap the KV ring;
the engine switches to T = 1 stepping once pos reaches the window. Prompt
chunks are padded to ``_CHUNK_BUCKETS`` with a ``valid`` mask, as in the
JAX engine, so both run the same shapes, on the JAX chunk schedule. The
JAX engine scans the leading full chunks in one dispatch
(``_prefill_chunks``); here they go out back to back with no host read
between them, which is what that dispatch is for, so no graph is needed.

A decode step runs the whole-step megakernel where ``fused_step`` allows
and its gate passes (``decode_path``), else the per-layer kernels (always
for MoE, whose B = 1 steps gather the chosen experts). ``a8_decode`` runs
the megakernel's int8-activation body (and the q4 GEMV per layer),
``a8_prefill`` the W8A8 GEMM on prefill chunks; ``from_xalm(q4_group=g)``
packs the body to q4 at load and implies ``a8_decode``.

Multi-step decode (``decode_scan``, ``_sample_scan``, ``sample_scan_rows``,
``_ppl_scan`` and ``generate(segment=)``) runs as CUDA-graph replays on the card
(``runtime/graphs.py``): the token stays on the card from one step to the
next and the host reads a segment's tokens once at its end. ``generate``'s
default segment is 16 on the card and 1 on the CPU (the JAX rule, the card
in the TPU's place); a segment of 1 steps eagerly and reads each token. On
the CPU the scans run the same steps eagerly. Graphs are bound to cache
planes: the engine keeps one cache per batch size for ``generate``,
``perplexity`` and ``spec.generate_spec`` (``fresh_cache``) and zeroes it
for each call, and a cache passed to ``decode_scan`` or ``verify`` gets its
own capture (``_MAX_GRAPHS`` kept). Sampling draws from threefry keys
(``prng.py``), the JAX keys bit for bit, split as the JAX scans split them,
so a seed gives the JAX engine's tokens.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from collections import OrderedDict

import numpy as np
import torch

from xalm_tpu_torch import prng
from xalm_tpu_torch.io import XalmFile
from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.models.llama import IMPLS, forward, gathered_ok
from xalm_tpu_torch.obs.console import ProgressBar
from xalm_tpu_torch.models.params import (
    ModelParams,
    load_params,
    load_units,
    recode_params_q4,
    recode_wcls_i8,
)
from xalm_tpu_torch.ops.fused_decode import fused_step_supported
from xalm_tpu_torch.parallel.mesh import sharded_token_logprobs
from xalm_tpu_torch.runtime.cache import KVCache, copy_lane
from xalm_tpu_torch.runtime.graphs import SEGMENT_MAX, ScanState, StepGraph
from xalm_tpu_torch.sampler import sample, sample_argmax, sample_rows, split_rows, token_logprobs
from xalm_tpu_torch.tokenizer import Tokenizer

__all__ = ["Engine", "GenerationStats", "auto_kv_dtype", "weight_bytes_per_token"]

_CHUNK_BUCKETS = (16, 32, 64, 128, 256, 512)
# the caches of the JAX harness's -t: bf16 and f32 on kernels 2-4 (and the
# megakernel), int8 on kernels 5-7, f16 on the dense attention (the forward
# routes each by its dtype, as the reference does)
KV_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.int8)
_MAX_GRAPHS = 8  # captured scan steps an engine keeps (the least recently used goes)


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
    spec_proposed: int = 0  # draft tokens offered to verify (runtime/spec.py)
    spec_accepted: int = 0  # draft tokens accepted

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


def weight_bytes_per_token(cfg: ModelConfig, p: ModelParams, gathered: bool) -> int:
    """Weight bytes a decode step reads: q4 weights count their packed
    bytes and group scales; the norms and the family planes (qkv bias,
    q/k norms, post-norms) their f32 bytes. MoE: the k/E share of the
    expert stacks where B = 1 decode gathers the chosen experts
    (``gathered``: the per-layer paths, a dtype the gather takes; q4
    experts under ``a8_decode``, the JAX rule), all E otherwise, and the
    router."""
    lw = p.layers
    total = sum(w.nbytes() for w in (lw.wqkv, lw.wo, lw.w13, lw.w2) if w is not None)
    if lw.w13e is not None:
        experts = lw.w13e.nbytes() + lw.w2e.nbytes()
        if gathered:
            experts = experts * cfg.n_experts_active // max(cfg.n_experts, 1)
        total += experts + 4 * lw.wgate.nelement()
    total += 4 * (lw.attn_norm.nelement() + lw.mlp_norm.nelement() + p.out_norm.nelement())
    total += 4 * sum(t.nelement() for t in (lw.bqkv, lw.q_norm, lw.k_norm, lw.post_attn_norm,
                                            lw.post_mlp_norm) if t is not None)
    total += p.embed.nbytes() // cfg.vocab_size  # one embedding row read
    total += p.wcls.nbytes()
    return int(total)


class Engine:
    chat_template = None  # the container's jinja chat template, if it has one
    chunk_buckets = _CHUNK_BUCKETS  # the widths a prefill chunk is padded to
    vocab_axis = None  # the mesh axis the head's vocab rows are split over (ShardedEngine)
    capture_steps = True  # scans replay CUDA graphs on the card (False: eager steps)

    @staticmethod
    def chunk_bucket(n: int) -> int:
        """The width an n-token prefill chunk is padded to: the least of
        ``chunk_buckets`` that holds it (the widest for a longer one)."""
        return _bucket(n)

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
        self._caches: dict[int, KVCache] = {}  # generate's and perplexity's, by batch size
        # (cache planes, step kind) -> (ScanState, StepGraph), least recently used first
        self._graphs: OrderedDict[tuple, tuple[ScanState, StepGraph]] = OrderedDict()

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
        progress: bool = True,
    ) -> "Engine":
        """Load a container. ``f16_mode`` and ``fp8_mode`` are
        ``load_params``'s (on the card f16 weights load as bf16 and fp8
        weights as i8 rows by default). ``q4_group`` > 0 re-codes the four
        body weights to packed q4 on ``device`` once loaded (one layer's f32
        temporary at a time) and implies ``a8_decode``: the q4 dots take
        int8 activations.

        As the JAX ``from_xalm`` does, the file is first pulled through the
        page cache in parallel (``XalmFile.prefault``) and the layer stacks
        are copied by the native thread pool (``XalmFile.read_stack``);
        without the native library they are copied one after another and
        nothing is prefaulted. ``progress`` shows a loading bar on stderr with a
        wall/user/sys summary at the end."""
        with XalmFile(path) as xf:
            cfg = ModelConfig.from_metadata(xf.config, context)
            xf.prefault()
            if progress:
                with ProgressBar("loading weights", total=load_units(cfg)) as bar:
                    params = load_params(xf, cfg, device=device, f16_mode=f16_mode,
                                         fp8_mode=fp8_mode, progress=bar.advance)
            else:
                params = load_params(xf, cfg, device=device, f16_mode=f16_mode,
                                     fp8_mode=fp8_mode)
            tokenizer = Tokenizer.from_xalm(xf) if "tokenizer.tokens" in xf else None
            chat_template = xf.config.get("chat_template")
        if q4_group:
            params = recode_params_q4(params, group=q4_group)
            a8_decode = True
        eng = cls(
            cfg, params, tokenizer,
            kv_dtype=kv_dtype, compute_dtype=compute_dtype, matmul_impl=matmul_impl,
            a8_prefill=a8_prefill, a8_decode=a8_decode, fused_step=fused_step, wcls_i8=wcls_i8,
        )
        eng.chat_template = chat_template
        return eng

    # ----------------------------------------------------------------- steps

    def new_cache(self, batch: int = 1) -> KVCache:
        return KVCache.init(self.cfg, batch, self.kv_dtype, self.device)

    def copy_lane(self, cache: KVCache, dst: int, src: int) -> KVCache:
        """Copy batch lane ``src`` onto lane ``dst`` of ``cache`` in place
        (``runtime.cache.copy_lane``; the serving prefix cache)."""
        return copy_lane(cache, dst, src)

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

    def _forward_kw(self) -> dict:
        return dict(compute_dtype=self.compute_dtype, impl=self.matmul_impl,
                    fused_step=self.fused_step, a8_prefill=self.a8_prefill,
                    a8_decode=self.a8_decode)

    def step(self, tokens, pos, cache: KVCache, valid=None, logits_mode="last"):
        """Forward on a (B, T) block at positions pos (B,). Returns
        (logits, cache); the cache is updated in place. The inputs stay on
        the host: the forward moves what a path needs to the card."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        pos = torch.as_tensor(np.asarray(pos), dtype=torch.int32)
        if valid is not None:
            valid = torch.as_tensor(np.asarray(valid), dtype=torch.bool)
        with torch.inference_mode():
            return forward(self.params, self.cfg, tokens, pos, cache, valid,
                           logits_mode=logits_mode, **self._forward_kw())

    # ----------------------------------------------------------------- scans

    def fresh_cache(self, batch: int) -> KVCache:
        """The engine's own cache of ``batch`` rows, zeroed (the state
        ``new_cache`` gives): the planes its captured steps are bound to,
        which ``generate``, ``perplexity`` and ``spec.generate_spec`` decode
        into, so their graphs are kept across calls."""
        cache = self._caches.get(batch)
        if cache is None:
            cache = self._caches[batch] = self.new_cache(batch)
        else:
            cache.zero_()
        return cache

    def _graph(self, cache: KVCache, kind: tuple, make):
        """The (state, StepGraph) of a ``kind`` of step over ``cache``:
        ``make()`` builds it at first use, and it is kept for these planes
        (the least recently used of more than ``_MAX_GRAPHS`` goes)."""
        key = (tuple(t.data_ptr() for t in cache.planes()), tuple(cache.k.shape), cache.k.dtype,
               kind)
        graph = self._graphs.pop(key, None)
        if graph is None:
            while len(self._graphs) >= _MAX_GRAPHS:
                self._graphs.popitem(last=False)
            graph = make()
        self._graphs[key] = graph
        return graph

    def _scan(self, cache: KVCache, kind: str, valid: bool = False, sampling=None,
              want_lp: bool = False):
        """The (ScanState, StepGraph) of a ``kind`` step ("greedy", "sample"
        with ``sampling`` = (temperature, top_k, top_p), "rows" (the per-row
        sampler, with log-probs and top-5 under ``want_lp``) or "ppl") over
        ``cache``, built at first use and kept for these planes."""
        def make():
            with torch.inference_mode(False):  # plain tensors: written in and out of inference mode
                st = ScanState.empty(cache.batch, self.device, logprobs=kind == "ppl",
                                     valid=valid, teacher=kind == "ppl", keys=kind == "sample",
                                     rows=kind == "rows", top5=want_lp)
            step = _scan_step(self.params, self.cfg, cache, st, kind, sampling, want_lp,
                              self._forward_kw(), self.vocab_axis)
            return st, StepGraph(step, self.device, capture=self.capture_steps)

        return self._graph(cache, (kind, valid, sampling, want_lp), make)

    def _verifier(self, cache: KVCache, k: int, wrapped: bool):
        """The (VerifyState, StepGraph) of a k-draft verify chunk over
        ``cache``, blind-write or wrapped, built at first use and kept for
        these planes."""
        def make():
            dev, cfg = self.device, self.cfg
            with torch.inference_mode(False):  # plain tensors: written in and out of inference mode
                rows = None
                if wrapped:
                    shape = (cfg.n_layers, cache.batch, k + 1, cfg.n_kv_heads, cfg.head_dim)
                    rows = (torch.zeros(shape, dtype=cache.k.dtype, device=dev),
                            torch.zeros(shape, dtype=cache.v.dtype, device=dev))
                    if cache.quantized:
                        rows += tuple(torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
                                      for _ in range(2))
                st = VerifyState(toks=torch.zeros((1, k + 1), dtype=torch.int64, device=dev),
                                 pos=torch.zeros((1,), dtype=torch.int32, device=dev),
                                 greedy=torch.zeros((k + 1,), dtype=torch.int32, device=dev),
                                 rows=rows)
            kw = self._forward_kw()

            def step() -> None:
                if st.rows is None:
                    logits, _ = forward(self.params, cfg, st.toks, st.pos, cache,
                                        logits_mode="all", **kw)
                else:
                    logits, _, rows = forward(self.params, cfg, st.toks, st.pos, cache,
                                              logits_mode="all", spec_verify=True, **kw)
                    for dst, src in zip(st.rows, rows):
                        dst.copy_(src)
                st.greedy.copy_(torch.argmax(logits[0], dim=-1))

            return st, StepGraph(step, dev)

        return self._graph(cache, ("verify", k, wrapped), make)

    def verify(self, chunk: list[int], pos: int, cache: KVCache, wrapped: bool = False):
        """One speculative verify chunk (runtime/spec.py): the pending token
        then the drafts, at ``pos`` -> (the argmax after each chunk token, a
        list of k + 1 ints; the chunk's stored rows, wrapped, else None).
        The blind-write chunk writes its rows into ``cache``; the wrapped
        one (``forward(spec_verify=True)``) writes nothing. On the card one
        graph replay a chunk, captured at the first call for these planes
        and this k; a failed capture raises."""
        with torch.inference_mode():
            st, graph = self._verifier(cache, len(chunk) - 1, wrapped)
            st.toks.copy_(torch.tensor([chunk], dtype=torch.int64))
            st.pos.fill_(pos)
            graph.run(1)
            return st.greedy.tolist(), st.rows  # the chunk's one host read

    def _scan_key(self, key: torch.Tensor) -> torch.Tensor:
        """The key a sampled scan starts from (ShardedEngine folds in its dp
        index)."""
        return key

    @staticmethod
    def _load(st: ScanState, tokens, pos, valid=None) -> None:
        """A scan's start: the first tokens and positions (and valid rows),
        from the host or the card."""
        st.token.copy_(torch.as_tensor(tokens).reshape(-1))
        st.pos.copy_(torch.as_tensor(pos).reshape(-1))
        if valid is not None:
            st.valid.copy_(torch.as_tensor(valid).reshape(-1))

    @staticmethod
    def _run(st: ScanState, graph: StepGraph, n_steps: int, top5: bool = False):
        """n_steps of a scan from its current state -> its outputs (B,
        n_steps) on the device, no host read (the buffers are copied out
        every SEGMENT_MAX steps); with ``top5`` the tuple of the outputs,
        the log-probs (B, n_steps) and the top-5 values and ids (B,
        n_steps, 5)."""
        bufs = (st.out, st.lp, st.topv, st.topi) if top5 else (st.out,)
        parts = [[] for _ in bufs]
        for done in range(0, n_steps, SEGMENT_MAX):
            m = min(SEGMENT_MAX, n_steps - done)
            st.slot.zero_()
            graph.run(m)
            for part, buf in zip(parts, bufs):
                part.append(buf[:, :m].clone())
        outs = tuple(torch.cat(part, dim=1) if part else buf[:, :0].clone()
                     for part, buf in zip(parts, bufs))
        return outs if top5 else outs[0]

    def decode_scan(self, tokens, pos, cache: KVCache, n_steps: int, valid=None):
        """Greedy-decode n_steps from tokens (B,) at pos (B,) -> (generated
        (B, n_steps) int32 on the engine's device, cache). ``valid``: (B,)
        bool; False rows neither write the cache nor rotate sinks. On the
        card the steps replay a CUDA graph (captured at the first call on
        these planes) and nothing is read back; a failed capture raises."""
        with torch.inference_mode():
            st, graph = self._scan(cache, "greedy", valid=valid is not None)
            self._load(st, tokens, pos, valid)
            return self._run(st, graph, n_steps), cache

    def _sample_scan(self, tokens, pos, cache: KVCache, key, n_steps: int, *,
                     temperature: float, top_k: int = 0, top_p: float = 1.0, valid=None):
        """n_steps of sampled decode from the (2,) threefry ``key`` (the JAX
        ``_sample_scan``): each step splits the key into (carry, draw) and
        samples the step's logits (``sampler.sample``) under the draw. ->
        (tokens (B, n_steps) int32 on the device, cache)."""
        with torch.inference_mode():
            st, graph = self._scan(cache, "sample", valid=valid is not None,
                                   sampling=(float(temperature), int(top_k), float(top_p)))
            st.keys[0].copy_(self._scan_key(_as_keys(key)))
            self._load(st, tokens, pos, valid)
            return self._run(st, graph, n_steps), cache

    def sample_scan_rows(self, tokens, pos, cache: KVCache, keys, temps, top_ps, n_steps: int,
                         valid=None, want_lp: bool = False):
        """n_steps of per-row sampled decode for a serving batch (the JAX
        ``_sample_scan_rows``): row b draws under its own threefry key
        ``keys[b]`` (B, 2), at temperature ``temps[b]`` (0: greedy) and top-p
        ``top_ps[b]``; each step splits every key (``sampler.split_rows``),
        draws from the first half (``sampler.sample_rows``) and carries the
        second, only where ``valid`` (B,) holds, so that a masked slot keeps
        the key its seed gave it. One graph a (cache, want_lp). -> (tokens
        (B, n), then with ``want_lp`` the chosen tokens' log-probs (B, n) and
        the raw top-5 log-probs and ids (B, n, 5), then the keys (B, 2)), all
        on the device. The keys returned are the state's own buffer, which
        the next call on this graph advances in place; pass it back as
        ``keys`` (no copy then)."""
        with torch.inference_mode():
            st, graph = self._scan(cache, "rows", valid=valid is not None, want_lp=want_lp)
            for buf, src in ((st.keys, _as_keys(keys)), (st.temps, temps), (st.top_ps, top_ps)):
                if src is not buf:
                    buf.copy_(torch.as_tensor(src).reshape(buf.shape))
            self._load(st, tokens, pos, valid)
            outs = self._run(st, graph, n_steps, top5=want_lp)
            return (outs if want_lp else (outs,)) + (st.keys,)

    def _ppl_scan(self, toks, tgts, pos, cache: KVCache):
        """Teacher-forced log-prob scan: feed toks[:, i] at pos + i and take
        log p(tgts[:, i]); toks, tgts (B, K), K <= SEGMENT_MAX -> (log-probs
        (B, K) f32 on the device, cache)."""
        toks, tgts = (torch.as_tensor(np.asarray(a), dtype=torch.int32) for a in (toks, tgts))
        k = toks.shape[1]
        if k > SEGMENT_MAX:
            raise ValueError(f"_ppl_scan: {k} steps; at most {SEGMENT_MAX}")
        with torch.inference_mode():
            st, graph = self._scan(cache, "ppl")
            st.toks[:, :k].copy_(toks)
            st.tgts[:, :k].copy_(tgts)
            self._load(st, toks[:, 0], pos)
            return self._run(st, graph, k), cache

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
        segment: int | None = None,
        resume=None,
        return_session: bool = False,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int | None = None,
    ):
        """Completion: greedy, or with ``temperature > 0`` sampled
        (``sampler.sample``: temperature, top-k, top-p) under the threefry key
        of ``seed`` (None: 0), split as the JAX ``generate`` splits it (one
        split for the first token, one for each segment's scan, one in each
        of its steps), so that the tokens are the JAX engine's for a given
        (seed, segment). Decode goes in segments of
        ``segment`` steps (default 16 on the card, 1 on the CPU): a segment
        of more than one step replays the captured step and reads its
        tokens once at the end; EOS is checked between segments and the
        tokens past it, or past ``max_new_tokens``, are dropped (greedy
        output does not depend on the segment). Returns (generated ids,
        GenerationStats); the time of each phase ends in a host read.

        ``resume``: a ``runtime.session.Session`` to continue: its planes
        are copied into the engine's own cache (the planes the captured
        steps are bound to; dtype and shape must match), and its pending
        last token is fed again ahead of ``prompt_ids``. With
        ``return_session=True`` returns (ids, stats, Session), the
        Session's cache a copy (the next call zeroes the engine's own)."""
        if segment is None:
            segment = 16 if self.device.type == "cuda" else 1
        if segment < 1:
            raise ValueError(f"segment {segment}: at least 1")
        stats = GenerationStats(prompt_tokens=len(prompt_ids))
        cache = self.fresh_cache(1)
        start, history, new_tokens = 0, [], list(prompt_ids)
        if resume is not None:
            cache.copy_(resume.cache)
            start = int(np.asarray(resume.pos)[0])
            history = list(resume.tokens[0])
            # the pending token's rows were never written: feed it again
            prompt_ids = [history[-1]] + new_tokens
        sampling = (float(temperature), int(top_k), float(top_p)) if temperature > 0.0 else None
        # a sampled decode always scans, as the JAX engine's does (its steps split the key)
        scan = self._scan(cache, "sample" if sampling else "greedy", sampling=sampling) \
            if segment > 1 or sampling else None
        key = prng.PRNGKey(0 if seed is None else seed, self.device) if sampling else None

        t0 = time.perf_counter()
        logits, cache, pos = self.prefill(prompt_ids, cache, logits_mode="last", start_pos=start)
        with torch.inference_mode():
            if sampling:
                key, sub = prng.split(key)
                first = sample(logits, sub, temperature=temperature, top_k=top_k, top_p=top_p)
            else:
                first = sample_argmax(logits)
        token = int(first[0])  # copies to the host: a sync
        stats.prefill_s = time.perf_counter() - t0

        out: list[int] = []

        def emit(t) -> bool:
            out.append(t)
            if on_token is not None:
                on_token(t)
            return stop_on_eos and self.tokenizer is not None and self.tokenizer.is_stop(t)

        t0 = time.perf_counter()
        stopped = emit(token)
        if scan is not None and not stopped and len(out) < max_new_tokens:
            st, graph = scan
            with torch.inference_mode():
                # the token stays on the card
                self._load(st, first, torch.full((1,), pos, dtype=torch.int32))
        while not stopped and len(out) < max_new_tokens:
            n = min(segment, max_new_tokens - len(out))
            if (return_session and stop_on_eos and self.tokenizer is not None
                    and pos + n > self.cfg.max_seq_len):
                # a segment's steps past EOS write rows; after the wrap they
                # would overwrite live ring rows of the saved window, so
                # near and past the wrap a session steps one token at a time
                n = 1
            if scan is not None:
                with torch.inference_mode():
                    if sampling:
                        key, sub = prng.split(key)
                        st.keys[0].copy_(self._scan_key(sub))
                    seg = self._run(st, graph, n)[0].tolist()  # the segment's one host read
            else:
                logits, cache = self.decode(np.array([token]), np.array([pos], np.int32), cache)
                with torch.inference_mode():
                    seg = [int(sample_argmax(logits)[0])]
            for i, t in enumerate(seg):
                stats.active_bytes += self.active_bytes(pos + i)
                if emit(t):
                    stopped = True
                    break
            pos += len(seg)
            token = seg[-1]
        stats.decode_s = time.perf_counter() - t0
        stats.generated_tokens = len(out)
        if return_session:
            from xalm_tpu_torch.runtime.session import Session

            # the pending token (emitted, its rows not written); the rows
            # past it in the ring are masked by kv_len on resume
            pend = start + len(prompt_ids) + len(out) - 1
            return out, stats, Session(cache=cache.clone(), pos=np.array([pend], np.int32),
                                       tokens=[history + new_tokens + out])
        return out, stats

    def perplexity(self, token_ids: list[int]) -> tuple[float, float, int]:
        """(ppl, stderr, n) over a prompt: forward every token, accumulate
        log p of the next. The window's tokens in "all"-logits prefill
        chunks; the wrapped tail (ring and sinks active) teacher-forced in
        ``_ppl_scan`` segments of the JAX buckets (at most 512 steps, the
        last padded by repeating the final token; the padded log-probs are
        never counted and their cache rows lie past every counted query)."""
        n = len(token_ids)
        if n < 2:
            raise ValueError("perplexity needs at least 2 tokens")
        cache = self.fresh_cache(1)
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
        while pos < n - 1:
            k = min(n - 1 - pos, _CHUNK_BUCKETS[-1])
            bucket = _bucket(k)
            toks = np.full((1, bucket), token_ids[n - 1], np.int32)
            tgts = np.full((1, bucket), token_ids[n - 1], np.int32)
            toks[0, :k] = token_ids[pos : pos + k]
            tgts[0, :k] = token_ids[pos + 1 : pos + 1 + k]
            lps_seg, cache = self._ppl_scan(toks, tgts, np.array([pos], np.int32), cache)
            lps_seg = lps_seg[0, :k].cpu().numpy().astype(np.float64)  # the segment's one read
            sum_lp += float(lps_seg.sum())
            sum_lp2 += float((lps_seg**2).sum())
            count += k
            pos += k
        ppl = math.exp(-sum_lp / count)
        err = ppl * math.sqrt(max(sum_lp2 - sum_lp * sum_lp / count, 0.0) / count / count)
        return ppl, err, count

    # ----------------------------------------------------------- accounting

    @functools.cached_property
    def _per_token_weight_bytes(self) -> int:
        return weight_bytes_per_token(self.cfg, self.params,
                                      gathered_ok(self.params.layers.w13e, self.matmul_impl,
                                                  self.a8_decode)
                                      if self.params.layers.w13e is not None else False)

    def active_bytes(self, pos: int, tokens: int = 1) -> int:
        """Bytes touched per decoded token at position pos: all live weight
        bytes + the cache rows up to kv_len + the new rows written, and for
        an int8 cache the f32 row scales read and written beside them. A
        chunk of ``tokens`` (a speculative verify chunk at pos) streams the
        weights once and counts the cache traffic once a token."""
        cfg = self.cfg
        kv_len = min(pos + 1, cfg.max_seq_len)
        kv_elt = torch.empty((), dtype=self.kv_dtype).element_size()
        kv_read = 2 * cfg.n_layers * kv_len * cfg.kv_dim * kv_elt
        kv_write = 2 * cfg.n_layers * cfg.kv_dim * kv_elt
        kv = kv_read + kv_write
        if self.kv_dtype == torch.int8:
            kv += 2 * cfg.n_layers * cfg.n_kv_heads * (kv_len + 1) * 4
        return self._per_token_weight_bytes + tokens * kv


@dataclasses.dataclass
class VerifyState:
    """The static buffers of a verify chunk's graph (``Engine.verify``)."""

    toks: torch.Tensor  # (1, k + 1) int64: the pending token and the k drafts
    pos: torch.Tensor  # (1,) int32: the pending token's position
    greedy: torch.Tensor  # (k + 1,) int32: the argmax after each chunk token
    rows: tuple | None  # wrapped: the chunk's rows in stored form (forward's spec_verify)


def _as_keys(keys) -> torch.Tensor:
    """int64 threefry keys from a tensor, or from uint32 values (numpy)."""
    return keys if torch.is_tensor(keys) else prng.from_numpy(keys)


def _scan_step(params, cfg, cache: KVCache, st: ScanState, kind: str, sampling, want_lp: bool,
               forward_kw: dict, vocab=None):
    """The step a scan replays (``runtime/graphs.py``), over static buffers
    only: the forward of st.token (or, for "ppl", the teacher's token at
    the slot) at st.pos, then the advance: "greedy" emits and feeds back
    the argmax (``logits_mode="token"``: the megakernel's own where it runs
    the head), "sample" the draw of ``sampler.sample`` under the second
    half of a split of st.keys[0] (the first carried), "rows" the draws of
    ``sampler.sample_rows`` under the first halves of st.keys' row splits
    (the second carried where st.valid holds), and with ``want_lp`` their
    log-probs and top-5, "ppl" emits log p(st.tgts at the slot). With the
    head's vocab rows split over the mesh axis ``vocab`` (ShardedEngine),
    "greedy" takes the forward's sharded argmax, "sample" gathers the
    logits over the axis first (every rank of it then draws the same token
    from the same key) and "ppl" takes ``sharded_token_logprobs``."""
    valid = None if st.valid is None else st.valid[:, None]
    temperature, top_k, top_p = sampling or (0.0, 0, 1.0)

    def step() -> None:
        tok_in = st.toks.index_select(1, st.slot) if kind == "ppl" else st.token[:, None]
        out, _ = forward(params, cfg, tok_in, st.pos, cache, valid,
                         logits_mode="token" if kind == "greedy" else "last", **forward_kw)
        if kind == "greedy":
            st.emit(out, out)
        elif kind == "sample":
            carry, sub = prng.split(st.keys[0])
            st.keys[0].copy_(carry)
            if vocab is not None:
                out = vocab.gather(out, -1)
            tok = sample(out, sub, temperature=temperature, top_k=top_k, top_p=top_p)
            st.emit(tok, tok)
        elif kind == "rows":
            subs, carry = split_rows(st.keys)
            if st.valid is not None:
                carry = torch.where(st.valid[:, None], carry, st.keys)
            st.keys.copy_(carry)
            if want_lp:
                tok, lp, topv, topi = sample_rows(out, subs, st.temps, st.top_ps,
                                                  return_logprobs=True)
                st.emit(tok, tok, lp, topv, topi)
            else:
                tok = sample_rows(out, subs, st.temps, st.top_ps)
                st.emit(tok, tok)
        else:
            tgt = st.tgts.index_select(1, st.slot)[:, 0]
            if vocab is not None:
                st.emit(sharded_token_logprobs(out, tgt, vocab), tok_in[:, 0])
            else:
                st.emit(token_logprobs(out, tgt), tok_in[:, 0])

    return step
