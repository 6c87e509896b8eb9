"""Speculative decoding (counterpart of ``xalm_tpu/runtime/spec.py``):
n-gram (prompt-lookup) or draft-model proposals, verified k + 1 tokens at a
time.

A batch-1 decode step streams every weight for one token. A verify chunk
of k drafted tokens after the pending one streams them once for up to
k + 1 emitted tokens (kernel 1 at M = k + 1 rows, the GEMV's decode shapes
up to 8), and the emitted tokens stay greedy-exact: each accepted token
equals the chunk's own argmax after an all-greedy prefix, so the output is
greedy decoding under the chunk forward's numerics. Drafts come from the
longest earlier match of the context's last 3..1 tokens
(``ngram_propose``), or from a ``draft_engine`` (a smaller model on the
same vocabulary) by greedy ``decode_scan`` steps, its own cache kept in
step with the accepted stream.

Two regimes of the ring window, as in the JAX package:

- before the wrap (``pos + k + 1 <= max_seq_len``) the chunk writes all
  its k + 1 rows (the blind write); the rejected rows lie past kv_len and
  are written again by later steps before anything attends them;
- wrapped (``pos >= max_seq_len``) a blind write would overwrite live
  rows, so the chunk runs ``forward(spec_verify=True)``, which attends
  with the slots it would evict masked and writes nothing, and
  ``spec_commit`` then writes the accepted rows and rotates the sinks by
  the emitted count;
- a chunk that would straddle the edge falls back to plain steps.

On the card each verify chunk, blind-write and wrapped, is one CUDA-graph
replay (``Engine.verify``, a ``runtime/graphs.py`` ``StepGraph``), captured
once per (engine, k, regime, cache planes) over static buffers: the
chunk's tokens and position in, the (k + 1,) int32 argmax out (and the
wrapped chunk's rows). Its one host read is that argmax, which the JAX
package reads too. A failed capture raises; nothing falls back to eager
chunks on the card. The commit runs eagerly (a few launches over all
layers at once). On the CPU every chunk runs eagerly. ``generate_spec``
decodes into the engine's own cache (``Engine.fresh_cache``), so its
graphs and ``generate``'s are kept across calls.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from xalm_tpu_torch.models.config import KV_SINKS
from xalm_tpu_torch.models.llama import apply_rope, rope_constants
from xalm_tpu_torch.ops.attention import quant_rows
from xalm_tpu_torch.runtime.cache import KVCache, ring_indices
from xalm_tpu_torch.runtime.engine import Engine, GenerationStats
from xalm_tpu_torch.sampler import sample_argmax

__all__ = ["ngram_propose", "generate_spec", "spec_commit"]


def ngram_propose(ids, k: int, *, max_n: int = 3, min_n: int = 1) -> list[int]:
    """Up to ``k`` continuation tokens for ``ids`` by suffix lookup: the
    longest suffix n-gram first (``n = max_n .. min_n``); on a hit, the
    tokens that followed its MOST RECENT earlier occurrence. [] when nothing
    matches or no continuation token exists."""
    a = np.asarray(ids, np.int64)
    m = a.size
    for n in range(min(max_n, m - 1), min_n - 1, -1):
        pat = a[m - n:]
        span = m - n  # start positions of windows that end before the suffix
        if span <= 0:
            continue
        hit = a[:span] == pat[0]
        for j in range(1, n):
            hit &= a[j:span + j] == pat[j]
        idx = np.flatnonzero(hit)
        if idx.size == 0:
            continue
        i = int(idx[-1])
        cont = a[i + n:i + n + k]
        if cont.size:
            return cont.astype(np.int64).tolist()
    return []


def spec_commit(engine: Engine, cache: KVCache, rows, kvp, a: int) -> KVCache:
    """Apply a wrapped verify chunk's accepted prefix, in place: the rows of
    chunk tokens j <= a (``rows`` as ``forward(spec_verify=True)`` gives
    them) into their ring slots ``kvp`` (B, T), the rejected slots keeping
    their live rows, then every layer's sink keys rotated by the a + 1
    emitted positions in one rotation, rounded through the cache's type
    (an int8 cache's requantised), as the per-step writes would leave
    them."""
    n = a + 1
    dev = cache.k.device
    slots = torch.tensor(np.asarray(kvp)[:, :n], dtype=torch.int64, device=dev)
    with torch.inference_mode():
        # plane (L, B, KH, S[, hd]); new (L, B, T, KH[, hd])
        for plane, new in zip(cache.planes(), rows):
            for bi in range(cache.batch):
                src = new[:, bi, :n].transpose(1, 2).to(plane.dtype)
                plane[:, bi].index_copy_(2, slots[bi], src)
        # the scatter never touches the sinks (wrapped slots >= KV_SINKS)
        sinks = cache.k[:, :, :, :KV_SINKS].to(torch.float32)  # (L, B, KH, KV_SINKS, hd)
        if cache.quantized:
            sinks = sinks * cache.k_scale[:, :, :, :KV_SINKS, None]
        layers, b, kh, _, hd = sinks.shape
        flat = sinks.permute(1, 0, 2, 3, 4).reshape(b, 1, layers * kh * KV_SINKS, hd)
        at = torch.full((b, 1), n, dtype=torch.int32, device=dev)
        rot = apply_rope(flat, at, rope_constants(engine.cfg, dev)[0])
        rot = rot.reshape(b, layers, kh, KV_SINKS, hd).permute(1, 0, 2, 3, 4)
        if cache.quantized:
            codes, scale = quant_rows(rot)
            cache.k[:, :, :, :KV_SINKS] = codes
            cache.k_scale[:, :, :, :KV_SINKS] = scale
        else:
            cache.k[:, :, :, :KV_SINKS] = rot.to(cache.k.dtype)
    return cache


def generate_spec(
    engine: Engine,
    prompt_ids: list[int],
    max_new_tokens: int,
    *,
    k: int = 7,
    max_n: int = 3,
    on_token=None,
    stop_on_eos: bool = True,
    segment: int | None = None,
    draft_engine: Engine | None = None,
):
    """Greedy completion with speculative decoding: ``Engine.generate``'s
    contract (returns (tokens, stats)), the stats' ``spec_proposed`` and
    ``spec_accepted`` counting the drafts offered and accepted. ``k``:
    drafts a verify chunk (one graph a k: keep it fixed). Drafts from n-gram
    lookup, or from ``draft_engine`` (another engine, on the same
    vocabulary): k greedy steps of its own scan, its cache brought up to
    the accepted stream before each proposal (its rejected rows shape later
    proposals only, never the output). Where no draft matches, or a chunk
    would straddle the window's edge, the plain path decodes ``segment``
    steps (default 16 on the card, 1 on the CPU: a ``decode_scan`` of
    graph replays, or one eager step)."""
    if segment is None:
        segment = 16 if engine.device.type == "cuda" else 1
    if draft_engine is engine:
        raise ValueError("draft_engine must be another Engine (each keeps its own cache)")
    for e in (engine, draft_engine):
        if getattr(e, "mesh", None) is not None:
            # the JAX forward asserts a verify chunk has no tp or pp axis
            raise NotImplementedError(f"speculative decoding is single-device: "
                                      f"{type(e).__name__} is sharded")
    stats = GenerationStats(prompt_tokens=len(prompt_ids))
    cache = engine.fresh_cache(1)
    t0 = time.perf_counter()
    logits, cache, pos = engine.prefill(prompt_ids, cache, logits_mode="last")
    with torch.inference_mode():
        token = int(sample_argmax(logits)[0])
    stats.prefill_s = time.perf_counter() - t0
    s = engine.cfg.max_seq_len

    d_cache = d_pos = None
    if draft_engine is not None:
        d_cache = draft_engine.fresh_cache(1)
        _, d_cache, d_pos = draft_engine.prefill(prompt_ids, d_cache, logits_mode="none")

    out: list[int] = []
    t0 = time.perf_counter()

    def emit(t) -> bool:
        out.append(t)
        if on_token is not None:
            on_token(t)
        return stop_on_eos and engine.tokenizer is not None and engine.tokenizer.is_stop(t)

    def propose() -> list[int]:
        nonlocal d_cache, d_pos
        seq = prompt_ids + out
        if draft_engine is None:
            return ngram_propose(seq, k, max_n=max_n)
        if d_pos < pos:  # tokens emitted while the draft was idle: feed them
            _, d_cache, d_pos = draft_engine.prefill(seq[d_pos:pos], d_cache, logits_mode="none",
                                                     start_pos=d_pos)
        dt, d_cache = draft_engine.decode_scan(np.array([token], np.int32),
                                               np.array([d_pos], np.int32), d_cache, k)
        d_pos += k  # the scan wrote positions d_pos .. d_pos + k - 1
        return dt[0].tolist()

    stopped = emit(token)
    while not stopped and len(out) < max_new_tokens:
        can_blind = pos + k + 1 <= s  # the chunk ends before the window's edge
        can_commit = pos >= s and k + 1 <= s - KV_SINKS  # wrapped
        draft = propose() if can_blind or can_commit else []
        if draft:
            # padded to k drafts (one graph); a padding token is verified
            # like any draft, so a lucky match is still right
            drafts = (draft + [0] * k)[:k]
            greedy, rows = engine.verify([token] + drafts, pos, cache, not can_blind)
            a = 0
            while a < k and drafts[a] == greedy[a]:
                a += 1
            if not can_blind:
                positions = pos + torch.arange(k + 1, dtype=torch.int64)
                _, kvp, _ = ring_indices(positions[None], s)
                spec_commit(engine, cache, rows, kvp.numpy(), a)
            stats.spec_proposed += len(draft)
            stats.spec_accepted += min(a, len(draft))
            new_toks = drafts[:a] + [greedy[a]]
            stats.active_bytes += engine.active_bytes(pos, a + 1)
            for t in new_toks:
                if len(out) >= max_new_tokens:
                    break
                if emit(t):
                    stopped = True
                    break
            pos += a + 1
            token = new_toks[-1] if not stopped else token
        else:
            if segment > 1:
                seg, cache = engine.decode_scan(np.array([token], np.int32),
                                                np.array([pos], np.int32), cache, segment)
                seg = seg[0].tolist()  # the segment's one host read
            else:
                logits, cache = engine.decode(np.array([token]), np.array([pos], np.int32), cache)
                with torch.inference_mode():
                    seg = [int(sample_argmax(logits)[0])]
            for i, t in enumerate(seg):
                stats.active_bytes += engine.active_bytes(pos + i)
                if len(out) >= max_new_tokens:
                    break
                if emit(t):
                    stopped = True
                    break
            pos += len(seg)
            token = seg[-1]
    stats.decode_s = time.perf_counter() - t0
    stats.generated_tokens = len(out)
    return out, stats
