#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``xalm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --megakernel-ms [--root DIR] [--models NAME ...]
    python3 chip_smoke.py --kernel-ms [--root DIR]
    python3 chip_smoke.py --decode-wall --root DIR
    python3 chip_smoke.py --tools

Builds the port's CUDA kernels from ``xalm_tpu_torch/csrc/`` and drives the
port, never the JAX package, through these phases, each printing JSON lines,
on Mistral-7B and (phases 3-5 again) on Mixtral-8x7B and the family models.
Mixtral-8x7B's phase 6, whose per-layer path needs no megakernel, runs
first, while the megakernel's two sources build:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: one ``nvcc`` per source, all at once (``build.start_all``); a
   build line when kernel 1's and the attention kernels' are done, and one
   when the megakernel's are, after phase 6;
3. parity: every kernel against its plain PyTorch version at Mistral-7B
   shapes, with its time, the plain version's time, a library call's time
   where one PyTorch call computes the same function, and its bound (the
   larger of bytes over 3.35 TB/s and operations over the peak rate):
   kernel 1 at M = 1 and at a verify chunk's M = 8 (wqkv with the norm,
   w13, w2), and its tiled GEMM (``gemm_bf16w_kernel``: M = 512
   w13, w2 and wqkv with the norm prologue, M = 16 w13, i8, and M = 512
   w13 on bf16 weights beside ``F.linear``), the
   bf16-cache kernels (the ``flash_decode`` rows a decode step's ring
   update and attention in one launch, ``fused_decode_attention``, the
   planes bit-equal to the plain composition's), the int8-cache kernels
   (``phase_parity_int8``), the
   whole-step megakernel at full width and 32 layers in three bf16-cache
   and four int8-cache cases, and the cost of one of its grid barriers;
   then the int8-activation branches on the body recoded to packed q4 on
   the card (group 512): the q4 GEMV (wqkv, wo, w13, w2 at M = 1 and 4,
   groups 512 and 128) and the W8A8 GEMM (w13 and w2 at M = 512 and 256,
   i8 and q8), both bit-equal, and the megakernel's a8 and q4 bodies (B = 1
   and 4, bf16 and int8 caches, the i8 head under a8) at 32 layers and
   layer by layer, where most rows must agree to f32 rounding and the a8
   body's control, the bf16 body, must fail that rule; then the f32
   cache's kernels (``phase_parity_f32_cache``: kernels 2-4 at Mistral's
   shapes, at group 7 and at head_dim 256 and 96, the prefill in split
   TF32 on the tensor cores; the megakernel's i8, a8 and q4 bodies) and
   kernel 1's and 8's fp8 branch (``phase_parity_fp8``:
   e4m3 and e5m2, w13 at M = 1 and 512);
4. main path: ``Engine.generate`` at full Mistral-7B width (32 layers,
   random i8 weights from a seed): a 512-token prompt and 64 greedy tokens,
   every kernel's launch counter set to 0 just before and read just after,
   with a bf16, an int8 and an f32 cache, each on the default decode path
   (the megakernel) and with ``fused_step=False`` (the per-layer kernels),
   and with an f16 cache per layer (its default: the dense attention, the
   matmuls on kernel 1), each run with a profile of its decode steps; then
   three more runs, bf16 cache: the q4 body on the megakernel and with
   ``fused_step=False`` (the q4 GEMV), and the i8 body with ``a8_decode``
   and ``a8_prefill`` (the W8A8 GEMM on the prompt chunk, the megakernel's
   a8 body); and a 2048-token prompt on the megakernel path, bf16 cache
   (four chunks, the last three through kernel 4 past a prefix:
   ``phase_long_prompt``, its prefill tok/s and flash_prefill device ms);
   every prefill profile reports the tiled GEMM's device ms and records,
   and a record of the kernel it replaced fails the run; ``generate``
   decodes in segments of 16 steps replayed from a CUDA graph (the
   engine's default on the card), and the per-token counts and profiles
   are of eager ``decode`` steps; then ``phase_scan``: the megakernel and
   the per-layer kernels with a bf16 and an int8 cache and the q4 body per
   layer under ``a8_decode``, each generating 64 tokens at segment 1
   (eager steps, a host read a token) and at segment 16 (graph replays, a
   read a segment), identical tokens and launch counts, a ``scan`` line
   each (wall ms a token at both segments, device busy ms and idle share of
   a profiled segment, capture seconds, replays, the card's name and power
   limit), and the scanned perplexity's log-probs bit-equal to per-token
   steps on the megakernel; then ``phase_spec``: speculative decoding
   (``generate_spec``, k = 7: verify chunks of 8 tokens replayed from CUDA
   graphs) on a copy model (``copy_params``) whose n-gram drafts are its
   continuation, over a bf16 and an int8 cache, with a 2-layer copy as the
   draft engine, and wrapped at a 256-slot window (verify, then commit);
   its tokens equal to ``generate``'s (segment 16) and the recurrence, a
   ``spec`` line each (tok/s of both, the acceptance, one verify chunk's
   device ms against one plain step's, the capture seconds, the launches
   of both runs, from 0), and the same prompt on random weights (drafts
   mostly rejected); and ``phase_session``: a 64-token generation cut
   after 24, saved, loaded and resumed, equal to the uninterrupted run,
   with a bf16 and an int8 cache (save and load seconds of the whole
   window's planes, 537 and 277 MB); and ``phase_serve``: the continuous
   batcher (8 slots, segment 8: each decode segment graph replays of the
   masked greedy scan or the per-row sampled one) over the copy model, 12
   requests (greedy, seeded sampled, logprobs, four on one 64-token
   prefix) each greedy one equal to its solo ``generate``, at least 3
   prefix hits, one segment of each scan bit-equal to its eager steps, a
   seeded request at temperature 50 the same alone and beside seven
   others (a ``serve_check`` line); ``serve()``'s HTTP server over it, four
   concurrent completions, two streamed, each text the engine's greedy
   one (``serve_http``: time to the first piece); ``tools/serve_bench.py``'s
   traffic on random weights, 24 requests with a bf16 cache and 8 with an
   int8 one, launches counted from 0 (``serve``: generated and processed
   tok/s, TTFT, per-token latency and queue wait p50 and p95, warmup s,
   prefix hits, decode steps, a tick's host ms by span and device ms); and
   the greedy step at B = 1, 4 and 8 (``serve_step``: device ms a step of
   the masked scan's replays against ``active_bytes`` at B rows over 3.35
   TB/s, and the B = 8 step with masked rows, one wrapped, against its
   plain version, logits and cache rows); phase 3 also holds kernel 1's
   tiled GEMM at a packed prefill call's M = 2048 and kernel 4 over a
   packed call's 8 rows at their own positions, masked rows clamped;
5. wrap: the same widths at 2 layers and a 256-slot window, 600 decode
   steps through three ring wraps, the kernels against their plain
   versions on the card, on both decode paths (the megakernel with the i8
   head), with a bf16, an int8 and an f32 cache, and per layer with an f16
   cache: teacher-forced logits of
   random weights within 1e-2 of max |logits|, and identical free-running
   greedy tokens of a model whose next token attention decides (see
   ``phase_wrap``; ``generate``'s segments of 16 replayed steps, through
   the wraps); the q4 body and the a8 runs (``a8_prefill`` and
   ``a8_decode``) on both decode paths with a bf16 cache, each step held
   to what the int8 activations change in it, and a control without them
   that must fail that rule;
6. Mixtral-8x7B (``MIXTRAL_8X7B``, 8 experts, 2 active, random i8 weights
   at 32 layers, 47 GB): phase 3 for ``qmatmul_multi`` (the gathered top-k
   expert matmul) against its plain version on the flat 256-expert stacks,
   an index past 2^31 bytes included (``phase_parity_multi``); phase 4 on
   the decode path MoE takes, the per-layer kernels with the gathered
   experts (``phase_main_moe``); phase 5 at 2 layers with a bf16 and an
   int8 cache, the routing teacher-forced like the tokens and every flip
   recorded (``phase_wrap_moe``), and the router's gain measured on the
   plain version alone (``phase_router_witness``); ``phase_scan`` of its
   per-layer path right after phase 4;
7. the families (``phase_families``), one model at a time, random i8
   weights at full width and depth: Qwen2.5-7B (qkv bias, GQA group 7),
   Qwen3-8B (q/k norms), Llama-3.1-8B (llama3 rope), Gemma-2-9B (post-norms,
   attention and logit softcaps, gelu, embed scale, head_dim 256, 42
   layers), Gemma-7B (gelu and embed scale, head_dim 256, q_dim != dim) and
   Phi-3-mini-4k (head_dim 96, per layer): phase 3 for the megakernel's
   fold of each (Gemma-7B's with an f32 cache too) and for the attention
   kernels at group 7 and head_dim 256 and 96, phase 4 on the decode paths each model takes (on its first
   FAMILY_MAIN_LAYERS layers), phase 5 at 2 layers with the fold in both
   models;
8. the weight formats (``phase_formats``): Mixtral-8x7B with packed-q4
   experts at group 128 (drawn packed, 24.6 GB, 32 layers): phase 3 for
   ``qmatmul_multi_q4`` bit-equal (w13 and w2, groups 128 and 512, an index
   past 2^31 bytes), phase 4 with ``a8_decode`` (per decode token 64
   qmatmul_multi_q4, 64 qmatmul_q4, 1 qmatmul; the active bytes held to the
   shapes'), phase 5 at 2 layers and a 128-slot window with tokens and
   routing teacher-forced under the q4 body's int8-activation rule; Mistral-7B with an f32 body
   and head (28.5 GB, 32 layers): phase 3 for kernel 1's f32 branch
   (``qmatmul_f32``: the f32 GEMV, and at M = 512 the split-TF32 GEMM;
   within 1e-5 of each row's max) and phase 4 per layer;
   a 2-layer f32 Mixtral: phase 3 for kernel 8's f32 branch and a phase-4
   run; phase 5 for the f32 body; and f16 and f8_e4m3 containers at Mistral
   width (2 layers, written by the port's writer into build/) loaded by
   ``Engine.from_xalm`` on the card: bf16 per layer and the i8 megakernel,
   held against the plain path;
9. the host tools (``phase_tools``) at Mistral-7B-Instruct-v0.2's widths,
   2 layers: an HF directory written here (``config.json``, ``models/
   xalm-mini``'s ``tokenizer.json``, one bf16 ``model.safetensors`` by this
   script's own writer) converted to i8 by the port's converter; the
   container loaded twice by ``Engine.from_xalm`` on the card, with serial
   copies and with the native pool's copies and prefault, every parameter
   bit-equal; the harness's completion with ``--profile`` (a 512-token
   prompt, 64 tokens; its spans and usage table required); the native trie
   against the Python trie on a passkey prompt; and
   ``harness.bench_kernels``' ``-b -b2 -k all`` with the kernel libraries'
   cache statistics. The native library must load;
10. the kernels' summary line, then the result line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

With ``--tools`` it runs phases 1 and 9 alone (about three minutes, most
of them the kernels' builds). With ``--megakernel-ms`` it runs none of these phases: it builds only the
megakernel's source and times the megakernel alone, in phase 3's first
case (B = 1, kv_len 520, the embed fold, a bf16 cache), on each model
preset named (default Mistral-7B and Qwen3-8B) and each weight body
(``megakernel_ms``); with ``--root`` it also runs one step of both trees
on the same inputs, at B = 1 and 8, with the i8 head fold, over a bf16 and
an int8 cache, and requires x, the logits, the tokens and every cache
plane bit for bit (``_megakernel_bit_equal``). With ``--kernel-ms`` it runs none of them
either: it builds only kernel 1's and the attention kernels' sources and
times the tiled GEMM of int8 and bf16 weights (w13 and w2 of Mistral-7B at
M = 512 and 256, w13 at M = 16; ``F.linear`` on bf16 weights beside it:
``_gemm_turns``), the W8A8 GEMM and the split-TF32 f32 GEMM (w13 and w2 of
Mistral-7B at M = 512 and 256, i8 and f32 weights), the flash prefill over a bf16 and an
f32 cache (T = 512 at positions 0 and 1024, at the shapes of Mistral-7B,
Qwen2.5-7B, Gemma-7B and Phi-3-mini), a decode step's ring update and
flash-decode in one launch (a bf16 and an f32 cache, kv_len 777 and 4064,
the same shapes; an older tree's two launches in turn) and the M = 1 GEMV (Mistral-7B's
f32 matmuls and head, the bf16 head, i8 wqkv and w2) through their C entry
points, beside one PyTorch call (timed in the same turns: its spread is
printed; its device time from torch.profiler beside) and the bound
(``kernel_ms``), cycling enough layers that each sweep of a case's operands
is twice the card's L2, and the GEMV's bulk-copy ring alone by copy size
(``_bulk_copy_rates``). In both modes
``--root`` names another checkout whose libraries are built too (from its
own sources into its own build directory) and timed in turns with this
one's in the same process (other, this, this, other), through this
checkout's wrappers and plain versions, so its C entry points must take
the same arguments: unpack it with ``git archive`` into a directory that
``.gitignore`` lists. Each mode prints the card's name and power limit,
ptxas's registers, shared memory and spills of the timed kernels, and one
JSON line of times. With ``--decode-wall --root DIR`` it runs Mistral-7B's
per-layer decode over a bf16 cache (``fused_step=False``) at full width
and depth in one process a turn, this checkout's and DIR's package each
in its own (other, this, this, other: ``decode_wall``), and prints each
turn's decode ms a token and the host's time of a layer's attention step
(this checkout's one ``fused_decode_attention`` call, an older one's
``kv_update`` and ``flash_decode``), and the seconds of a 512- and a
2048-token prefill (host clock and CUDA events).

Any failed phase raises and the script exits non-zero without the result
line. There is no CPU fallback: without a CUDA device it exits 2 at once.
Float32 products in the plain versions run in full f32 (TF32 off for both
matmul and cuDNN).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_BF16 = 989e12  # dense tensor-core FLOP/s
PEAK_F32 = 67e12  # f32 outside the tensor cores
PEAK_TF32 = 494.7e12  # dense tensor-core TF32 FLOP/s: split TF32 takes three products a step
PEAK_S8 = 1979e12  # dense tensor-core int8 OP/s
SEED = 1234
DEVICE = "cuda"  # where the phases run; main() goes on only when CUDA is there


T0 = time.perf_counter()  # the script's start: every phase record carries its time since


def emit(obj) -> None:
    """One JSON line; a phase record carries the seconds since the start."""
    if "phase" in obj:
        obj = dict(obj, t=round(time.perf_counter() - T0, 1))
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Cases:
    """Parity and timing records of phase 3. Each case is checked row by
    row: the largest |kernel - plain| of a row (a query head's output, an
    output row of a matmul) against ``tol`` times that row's max |plain|,
    so that a row of small values is held to its own scale. ``tol`` 0
    asks for bit-equal results."""

    def __init__(self):
        self.rows: list[dict] = []

    def add(self, kernel: str, case: str, got, want, row: int, tol: float, kernel_fn, plain_fn,
            library_fn, nbytes: float, flops: float, peak: float, extra=None,
            extra_ok: bool = True) -> dict:
        import torch

        got = got.float().reshape(-1, row)
        want = want.float().reshape(-1, row)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{kernel} {case}: non-finite output")
        err_rows = (got - want).abs().amax(dim=1)
        ref_rows = want.abs().amax(dim=1)
        rel = float((err_rows / ref_rows.clamp_min(1e-30)).max())
        err = float(err_rows.max())
        ok = (err == 0.0 if tol == 0.0 else rel <= tol) and extra_ok
        b_ms, b_by = bound(nbytes, flops, peak)
        library_ms, library_error = None, None
        if library_fn is not None:
            try:  # a yardstick only: a library call this torch build lacks is reported
                library_ms = time_ms(library_fn)
            except (RuntimeError, NotImplementedError) as e:
                library_error = str(e).splitlines()[0][:200]
        rec = {
            "phase": "parity", "kernel": kernel, "case": case,
            "max_abs_err": err, "max_abs_ref": float(ref_rows.max()), "max_row_rel_err": rel,
            "tol_row_rel": tol, "ok": ok,
            "kernel_ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn, iters=5),
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_us": b_ms * 1e3,
        }
        if library_error is not None:
            rec["library_error"] = library_error
        rec.update(extra or {})
        emit(rec)
        self.rows.append(rec)
        if not ok:
            raise AssertionError(f"{kernel} {case}: row error {rel} (abs {err}) > tol {tol}, "
                                 f"or a further check failed: {extra}")
        return rec


def _smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    ok = smi.returncode == 0 and smi.stdout.strip()
    return smi.stdout.strip().splitlines()[0] if ok else "not measured"


def phase_device() -> str:
    import torch

    line = _smi_line()
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": line, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name


def phase_build(names: tuple) -> None:
    """Start every source's nvcc at once (``build.start_all``; a no-op for
    those already started) and wait for the libraries ``names``: the
    others go on building while the phases that need none of them run.
    Emits the seconds waited here, each source's build seconds and ptxas's
    report, and by name that of the packed-q4 stream's kernels."""
    from xalm_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.start_all()
    secs = {name: build.wait(name)[1] for name in names}
    logs = {}
    for name in names:
        log = build.BUILD_DIR / f"{name}.log"
        if log.exists():  # ptxas register / shared-memory / spill report
            logs[name] = [ln.strip() for ln in log.read_text().splitlines()
                          if "registers" in ln or "spill" in ln]
    row = {"phase": "build", "seconds": time.perf_counter() - t0, "per_source": secs,
           "ptxas": logs}
    if "qmatmul" in names:
        row["ptxas_q4_stream"] = _ptxas_report(build.BUILD_DIR / "qmatmul.log", Q4_STREAM_FRAGS)
    emit(row)


# the packed-q4 stream's kernels (kernels 1-q4 and 8-q4)
Q4_STREAM_FRAGS = ("gemv_q4_stream_kernel", "multi_q4_stream_kernel")


# phase 3's further cases of kernel 1's tiled GEMM (the kernels line's
# also_cases of the qmatmul row)
TILED_CASES = ("M=512 w2 i8, row scale", "M=512 wqkv i8, norm prologue + row scale",
               "M=16 w13 i8, row scale", "M=512 w13 bf16")
# phase 3's cases of kernel 1 and 4 at a speculative verify chunk's rows
# (k + 1 = 8, ``phase_spec``): further also_cases of the qmatmul and
# flash_prefill rows
SPEC_CASES = ("M=8 wqkv i8, norm prologue + row scale", "M=8 w13 i8, row scale",
              "M=8 w2 i8, row scale")
SPEC_PREFILL_CASE = "T=8 pos=1024"
# phase 3's cases of kernels 1 and 4 at a serving batch's packed prefill
# call (``phase_serve``: SERVE_BATCH rows of a SERVE_CHUNK-token chunk):
# further also_cases of the qmatmul and flash_prefill rows
SERVE_CHUNK = 256
SERVE_TILED_CASES = ("M=2048 wqkv i8, norm prologue + row scale", "M=2048 w13 i8, row scale")
SERVE_PREFILL_CASE = "B=8 T=256 packed: rows at their own positions, masked rows clamped"

# ---- phase_parallel: the sharded engines (xalm_tpu_torch/parallel/). The
# card host has one GPU, so (a) runs a world of one in this process over
# NCCL and (b) two worker processes sharing the one card over gloo: they
# check that the sharded path is right at full width, and their times are
# those of two ranks on one card, never a scaling figure.
SHARED_CARD = "two ranks sharing one H100, not a scaling figure"
PARALLEL_PROMPT = 512  # the teacher-forced prefill of phase (b)
PARALLEL_STEPS = 64  # its teacher-forced decode steps
PARALLEL_TIMED_STEPS = 16  # the timed decode_scan's steps a configuration
PARALLEL_COPY_TOKENS = 32  # the copy model's greedy tokens a configuration
PARALLEL_NCCL_TOKENS = 64  # generate's tokens at segment 16 in phase (a)
PARALLEL_LABEL = " (tp=2 shard)"
# phase (b)'s configurations: (name, mesh, options of the sharded engine and
# of the single-device per-layer engine it is held to, layers: None for
# all 32; the int8 cache's runs, beside the tp, pp and dp checks at full
# depth, at 8 so that the script keeps its time limit)
PARALLEL_RUNS = (("tp=2", dict(tp=2), {}, None),
                 ("pp=2", dict(pp=2), {}, None),
                 ("dp=2", dict(dp=2, tp=1), {}, None),
                 ("tp=2 int8 cache, 8 layers", dict(tp=2), dict(kv_dtype="int8"), 8))
# the configurations that run the single-device engine's arithmetic and
# are held bit-equal to it: pp=2 to its B = 2 run (each stage runs the same
# kernels on the same rows; the residual's hand-over adds zeros), dp=2 to
# its rows run alone (each dp rank runs one row at B = 1)
PARALLEL_EXACT = {"pp=2": "batch", "dp=2": "alone"}
# the limit of a tp run's teacher-forced logits against the single-device
# engine's B = 2 run: WRAP_TOL, or PARALLEL_FLOOR_RATIO times that engine's
# own spread (its B = 2 run against its rows run alone: the same arithmetic
# in another order), whichever is larger. tp sums wo's and w2's products in
# two halves, another order again; on Mistral-7B's random weights at 32
# layers an order alone moves a step's logits by 1.0e-2 of their max
PARALLEL_FLOOR_RATIO = 1.5
# W8A8 prefill under tp=2: each shard quantises its own slice of a row of
# wo's and w2's input, another quantisation than one device's. As the JAX
# test_sharded_a8_prefill holds the sharded a8 engine to the sharded engine
# without it, this run is held to PARALLEL_A8[4]'s run: every step's change
# within WRAP_TOL or PARALLEL_FLOOR_RATIO times the single-device engine's
# largest a8 change (its a8 run against its run without), whichever is larger
PARALLEL_A8 = ("tp=2 int8 cache, a8 prefill, 8 layers", dict(tp=2),
               dict(kv_dtype="int8", a8_prefill=True), 8, "tp=2 int8 cache, 8 layers")
PARALLEL_KERNELS = ("qmatmul", "qmatmul_a8", "flash_decode", "flash_prefill", "flash_decode_q")
# kernel 1's cases at Mistral-7B's tp=2 shard shapes (phase_parallel_parity)
PARALLEL_MM_CASES = tuple(c + PARALLEL_LABEL for c in (
    "M=1 wqkv i8 3072 rows, norm prologue + row scale",
    "M=1 w13 i8 14336 rows, norm prologue + row scale", "M=1 wo i8 over 2048, row scale",
    "M=1 w2 i8 over 7168, row scale", "M=512 w13 i8, row scale", "M=1 head bf16 16000 rows"))
# kernel 1's W8A8 GEMM at the same shards and the M of a 512-token prefill
# chunk (the tp=2 a8 prefill of phase (b) launches it on each)
PARALLEL_A8_CASES = tuple(c + PARALLEL_LABEL for c in (
    "M=512 wqkv i8 3072 rows", "M=512 w13 i8 14336 rows", "M=512 wo i8 over 2048",
    "M=512 w2 i8 over 7168"))



def phase_parity(params, cfg, cases: Cases) -> None:
    import torch

    from xalm_tpu_torch.models.params import QWeight

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    lp = params.layers
    L = cfg.n_layers
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=torch.float32)  # noqa: E731
    norm_w = torch.rand((L, cfg.dim), generator=gen, device=dev) + 0.5

    # ---- kernel 1: layers cycle so every launch streams its weights cold.
    # Tolerance 1e-4 of each output row's max: both sides sum the same
    # exact f32 products of bf16 values, in a different order. With the
    # norm prologue 1e-3: the rms is also summed in another order, which
    # can flip the bf16 rounding of a normed activation (one flip moved a
    # row by 4e-4 of its max at N=1024 in tests/test_torch_cuda.py).
    mm_case = functools.partial(_mm_case, cases, cfg, randn, norm_w)

    mm_case("M=1 wqkv i8, norm prologue + row scale", 1, lp.wqkv, True)
    mm_case("M=1 w13 i8, norm prologue + row scale", 1, lp.w13, True)
    mm_case("M=1 wo i8, row scale", 1, lp.wo, False)
    mm_case("M=1 w2 i8, row scale", 1, lp.w2, False)
    for case, w, norm in zip(SPEC_CASES, (lp.wqkv, lp.w13, lp.w2), (True, False, False)):
        mm_case(case, SPEC_K + 1, w, norm)  # a speculative verify chunk's rows
    mm_case("M=512 w13 i8, row scale", 512, lp.w13, False)
    for case, w, norm in zip(SERVE_TILED_CASES, (lp.wqkv, lp.w13), (True, False)):
        mm_case(case, SERVE_BATCH * SERVE_CHUNK, w, norm)  # a packed prefill call's rows
    mm_case("M=1 head bf16", 1, params.wcls, False, head=True)
    # the tiled GEMM (gemm_bf16w_kernel) at the prefill chunk's other
    # matmuls and at the smallest chunk; bf16 weights on two layers of random
    # bf16 w13 drawn on the card (235 MB each), F.linear as the library call
    mm_case(TILED_CASES[0], 512, lp.w2, False)
    mm_case(TILED_CASES[1], 512, lp.wqkv, True)
    mm_case(TILED_CASES[2], 16, lp.w13, False)
    w13b = (randn(2, *lp.w13.values.shape[1:]) * 0.02).to(torch.bfloat16)
    mm_case(TILED_CASES[3], 512, QWeight(w13b), False)
    del w13b
    torch.cuda.empty_cache()

    # ---- kernels 2-4 on random bf16 cache planes at the main path's shape
    shape = (L, 1, cfg.n_kv_heads, cfg.max_seq_len, cfg.head_dim)
    ck = randn(*shape).to(torch.bfloat16)
    cv = randn(*shape).to(torch.bfloat16)
    cexp, sexp = _sink_trig(cfg)
    update_cases(cfg, cases, gen, ck, cv, cexp, sexp)
    attention_cases(cfg, cases, gen, ck, cv)
    del ck, cv
    torch.cuda.empty_cache()
    packed_prefill_case(cfg, cases, gen)
    phase_parity_int8(cfg, cases, gen, cexp, sexp)


def _mm_case(cases: Cases, cfg, randn, norm_w, case, m, qw, use_norm, head=False) -> None:
    """Kernel 1 (``qmatmul``) against its plain version on ``m`` random
    rows and the stacked weight ``qw`` (layers cycled so every launch
    streams its weights cold; ``head``: an unstacked head), the library
    call beside it where one computes the same function (see
    phase_parity's tolerances)."""
    import torch
    import torch.nn.functional as F

    from xalm_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain

    n = qw.values.shape[-1]
    d = qw.values.shape[-2]
    x = randn(m, n)
    values = qw.values[None] if head else qw.values
    scale = None if qw.scale is None else (qw.scale[None] if head else qw.scale)
    kw = dict(scale=scale)
    if use_norm:
        kw.update(norm_w=norm_w, norm_eps=cfg.norm_eps)
    layers = itertools.cycle(range(values.shape[0]))
    got = qmatmul(x, values, 3 % values.shape[0], **kw)
    want = qmatmul_plain(x, values, 3 % values.shape[0], **kw)
    xb = x.to(torch.bfloat16)
    lib = None
    if head:
        lib = lambda: F.linear(xb, qw.values)  # noqa: E731
    elif values.dtype == torch.bfloat16:
        lib_layers = itertools.cycle(range(values.shape[0]))
        lib = lambda: F.linear(xb, values[next(lib_layers)])  # noqa: E731
    elif not use_norm:
        # bf16 activations x int8 weights with a per-row scale: the
        # int8 weight-only matmul (its scales in the activations' dtype)
        sc16 = scale.to(torch.bfloat16)
        lib_layers = itertools.cycle(range(values.shape[0]))

        def lib():
            i = next(lib_layers)
            return torch._weight_int8pack_mm(xb, values[i], sc16[i])
    elt = values.element_size()
    nbytes = d * n * elt + m * n * 4 + m * d * 4 + (d * 4 if scale is not None else 0) + (
        n * 4 if use_norm else 0)
    cases.add("qmatmul", case, got, want, d, 1e-3 if use_norm else 1e-4,
              lambda: qmatmul(x, values, next(layers), **kw),
              lambda: qmatmul_plain(x, values, next(layers), **kw),
              lib, nbytes, 2.0 * m * n * d, PEAK_BF16)


def _sink_trig(cfg):
    """(cexp, sexp) of cfg's +1-position sink rotation, on the card."""
    import torch

    from xalm_tpu_torch.models.llama import rope_freqs
    from xalm_tpu_torch.ops import attention as A

    return tuple(torch.from_numpy(a).to(DEVICE) for a in A.rope_cos_sin_plus1(rope_freqs(cfg)))


def update_cases(cfg, cases: Cases, gen, ck, cv, cexp, sexp, tag: str = "",
                 label: str = "") -> None:
    """Kernel 2 (``kv_update``, named ``kv_update<tag>``) against its plain
    version on the bf16 or f32 planes ``ck``/``cv`` at cfg's shapes,
    bit-equal (the kernel rounds each product and the sum as the plain
    version's separate f32 operations do): an insert at a wrapped row with
    the sink rotation, and the sentinel row without it (``label`` ends the
    case names)."""
    import torch

    from xalm_tpu_torch.ops import attention as A

    dev = torch.device(DEVICE)
    L, kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    for case, kvp, rot in (("insert at a wrapped row + sink rotation", 1000, 1),
                           ("sentinel row (dropped) without rotation", cfg.max_seq_len, 0)):
        kn, vn = (torch.randn((1, kh, hd), generator=gen, device=dev) for _ in range(2))
        k1, v1, k2, v2 = ck[5 % L].clone(), cv[5 % L].clone(), ck[5 % L].clone(), cv[5 % L].clone()
        args = (kn, vn, i32(kvp), i32(rot), cexp, sexp)
        A.kv_update(k1[None], v1[None], 0, *args)
        A.kv_update_plain(k2[None], v2[None], 0, *args)
        got = torch.cat([k1.flatten(), v1.flatten()])
        want = torch.cat([k2.flatten(), v2.flatten()])
        layers = itertools.cycle(range(L))
        elt = ck.element_size()
        nbytes = 2 * kh * hd * 4 + 2 * kh * hd * elt + (2 * 2 * kh * elt * hd * rot)
        cases.add("kv_update" + tag, case + label, got, want, hd, 0.0,
                  lambda: A.kv_update(ck, cv, next(layers), *args),
                  lambda: A.kv_update_plain(ck, cv, next(layers), *args),
                  None, nbytes, 0.0, PEAK_F32)


def attention_cases(cfg, cases: Cases, gen, ck, cv, tag: str = "", label: str = "") -> None:
    """Kernels 2-3 and 4 (``fused_decode_attention``, recorded as
    ``flash_decode``, and ``flash_prefill``; with ``tag`` their records are
    named ``flash_decode<tag>``, ``flash_prefill<tag>``, and ``label`` ends
    their case names) against their plain versions on the bf16 or f32
    planes ``ck``/``cv`` at cfg's shapes. The decode step (kernel 2's update
    in kernel 3's launch) against the plain composition
    (``fused_decode_attention_plain``: ``kv_update_plain``, then
    ``flash_decode_plain``) at kv_len 0 (the sentinel, nothing live), 1,
    777 and the window, B = 1, the new row inserted at kv_len - 1 (at the
    window, a wrapped row at 1000 with the sinks re-rotated): the planes
    bit-equal, the output within 1e-5 of each row's max (f32 dots and
    softmax on both sides, in another order); SDPA (``enable_gqa``, q in the
    cache's type) timed beside it over the same rows, the attention alone.
    flash_prefill of a 512-row chunk at positions 0 and 1024, beside SDPA
    (without ``tag`` over a bf16 cache also a verify chunk's 8 rows at
    1024, ``SPEC_PREFILL_CASE``).
    Layers cycle so every launch streams cold, SDPA's too. An f32 cache
    holds flash_prefill to 1e-5 (``F32_CACHE_TOL``) and bounds it by its
    three TF32 products a step at PEAK_TF32 (split TF32: nothing rounded to
    bf16), the f32 FMA bound beside."""
    import torch
    import torch.nn.functional as F

    from xalm_tpu_torch.ops import attention as A

    dev = torch.device(DEVICE)
    L, kh, hd, h, S = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, cfg.max_seq_len
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=torch.float32)  # noqa: E731
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    f32 = ck.dtype == torch.float32
    elt = ck.element_size()
    cexp, sexp = _sink_trig(cfg)
    for kvl in (0, 1, 777, S):
        q, kn, vn = randn(1, h, hd), randn(1, kh, hd), randn(1, kh, hd)
        wrapped = kvl == S
        kvp = S if kvl == 0 else 1000 if wrapped else kvl - 1  # kv_len 0: the sentinel
        upd = (kn, vn, i32(kvp), i32(kvl), i32(int(wrapped)), cexp, sexp)
        k1, v1 = ck[7 % L][None].clone(), cv[7 % L][None].clone()
        k2, v2 = k1.clone(), v1.clone()
        got = A.fused_decode_attention(q, k1, v1, 0, *upd)
        want = A.fused_decode_attention_plain(q, k2, v2, 0, *upd)
        planes_equal = bool(torch.equal(k1, k2) and torch.equal(v1, v2))
        del k1, v1, k2, v2
        if kvl == 0 and not bool((got == 0).all()):
            raise AssertionError("fused_decode_attention: kv_len == 0 must give 0")
        layers = itertools.cycle(range(L))
        lib_layers = itertools.cycle(range(L))
        sdpa_ms = None
        if kvl > 0:
            qb = q.to(ck.dtype)[:, :, None]  # (B, H, 1, hd)
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qb, *(c[next(lib_layers), :, :, :kvl] for c in (ck, cv)), enable_gqa=True))
        # read: the live K and V rows, q and the new rows; written: the
        # output, the new rows and, wrapped, the two sink keys (read too)
        nbytes = (2 * kvl * kh * hd * elt + h * hd * 4 + h * hd * 4
                  + (2 * kh * hd * (4 + elt) if kvl else 0) + (4 * kh * hd * elt if wrapped else 0))
        cases.add("flash_decode" + tag, f"B=1 kv_len={kvl}{label}", got, want, hd, 1e-5,
                  lambda: A.fused_decode_attention(q, ck, cv, next(layers), *upd),
                  lambda: A.fused_decode_attention_plain(q, ck, cv, next(layers), *upd),
                  None, nbytes, 4.0 * h * kvl * hd, PEAK_F32,
                  extra={"library_null": NO_LIBRARY_FUSED, "sdpa_attention_ms": sdpa_ms,
                         "planes_equal": planes_equal},
                  extra_ok=planes_equal)

    chunks = [(512, 0), (512, 1024)] + ([(SPEC_K + 1, 1024)] if not tag and not f32 else [])
    for t, p0 in chunks:
        q = randn(1, t, h, hd)
        pos = i32(p0)
        got = A.flash_prefill(q, ck, cv, 9 % L, pos)
        want = A.flash_prefill_plain(q, ck, cv, 9 % L, pos)
        layers = itertools.cycle(range(L))
        lib_layers = itertools.cycle(range(L))
        qb = q.to(ck.dtype).transpose(1, 2)  # (B, H, T, hd)
        kend = p0 + t
        mask = (torch.arange(kend, device=dev)[None, :]
                <= (p0 + torch.arange(t, device=dev))[:, None])

        def lib(kend=kend, qb=qb, mask=mask, lib_layers=lib_layers):
            i = next(lib_layers)
            return F.scaled_dot_product_attention(
                qb, ck[i, :, :, :kend], cv[i, :, :, :kend], attn_mask=mask, enable_gqa=True)
        visible = sum(p0 + i + 1 for i in range(t))
        # bf16: the plain version copies the kernel's 64-key tiling, so p is
        # rounded to bf16 at the same running max. The f32 sums of the
        # exact bf16 products differ in order; a score that moves by an f32
        # ulp can flip one bf16 rounding of p, by 2^-8 of a p that may
        # dominate its row: 2^-8 of the row's max
        nbytes, flops = 2 * kend * kh * hd * elt + 2 * t * h * hd * 4, 4.0 * visible * h * hd
        cases.add("flash_prefill" + tag, f"T={t} pos={p0}{label}", got, want, hd,
                  F32_CACHE_TOL if f32 else 2.0 ** -8,
                  lambda: A.flash_prefill(q, ck, cv, next(layers), pos),
                  lambda: A.flash_prefill_plain(q, ck, cv, next(layers), pos),
                  lib, nbytes, 3 * flops if f32 else flops, PEAK_TF32 if f32 else PEAK_BF16,
                  extra={"bound_fma_ms": bound(nbytes, flops, PEAK_F32)[0]} if f32 else None)


def packed_prefill_case(cfg, cases: Cases, gen) -> None:
    """Kernel 4 as a serving batch's packed prefill call gives it
    (``ContinuousBatcher._prefill_call``): SERVE_BATCH rows of a
    SERVE_CHUNK-token chunk over random bf16 planes of 4 layers at cfg's
    widths, five admitting rows at their own positions (0 up to S - T) and
    three masked ones (a decoding slot within T of the window's end, one
    past the window, a free slot at 0), each row at the window start the
    forward passes (``models/llama.py``: pos clamped to S - T). Against its
    plain version at the bf16 chunk's tolerance (``attention_cases``), every
    row; SDPA with each row's causal mask beside it."""
    import torch
    import torch.nn.functional as F

    from xalm_tpu_torch.ops import attention as A
    from xalm_tpu_torch.runtime.cache import KVCache

    dev = torch.device(DEVICE)
    kh, hd, h, S = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, cfg.max_seq_len
    b, t, layers = SERVE_BATCH, SERVE_CHUNK, 4
    shape = (layers,) + KVCache.plane_shape(cfg, b)[1:]
    ck, cv = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    slot_pos = [0, 300, 1024, 2900, S - t, S - t + 100, S + 700, 0]  # rows 5-7 masked
    pos = torch.clamp(torch.tensor(slot_pos, dtype=torch.int32, device=dev), max=S - t)
    q = torch.randn((b, t, h, hd), generator=gen, device=dev)
    got = A.flash_prefill(q, ck, cv, 1, pos)
    want = A.flash_prefill_plain(q, ck, cv, 1, pos)
    starts = pos.tolist()
    kmax = max(starts) + t
    mask = (torch.arange(kmax, device=dev)[None, None, :]
            <= (pos[:, None, None] + torch.arange(t, device=dev)[None, :, None]))[:, None]
    qb = q.to(torch.bfloat16).transpose(1, 2)
    lib_layers, run_layers, plain_layers = (itertools.cycle(range(layers)) for _ in range(3))

    def lib():
        i = next(lib_layers)
        return F.scaled_dot_product_attention(qb, ck[i, :, :, :kmax], cv[i, :, :, :kmax],
                                              attn_mask=mask, enable_gqa=True)
    nbytes = sum(2 * (p0 + t) * kh * hd * 2 for p0 in starts) + 2 * b * t * h * hd * 4
    flops = 4.0 * h * hd * sum(t * p0 + t * (t + 1) // 2 for p0 in starts)
    cases.add("flash_prefill", SERVE_PREFILL_CASE, got, want, hd, 2.0 ** -8,
              lambda: A.flash_prefill(q, ck, cv, next(run_layers), pos),
              lambda: A.flash_prefill_plain(q, ck, cv, next(plain_layers), pos),
              lib, nbytes, flops, PEAK_BF16,
              extra={"slot_positions": slot_pos, "window_starts": starts, "masked_rows": [5, 6, 7]})
    del ck, cv
    torch.cuda.empty_cache()


# why no library call stands beside the q4 GEMV
NO_LIBRARY_Q4 = ("no one PyTorch call multiplies int8 activation codes by packed signed 4-bit "
                 "weights with per-group scales (torch._weight_int4pack_mm takes bf16 "
                 "activations, unsigned codes with zero points and its own tile layout)")


def phase_parity_quant(params, q4p, cfg, cases: Cases) -> None:
    """Kernel 1's int8-activation branches against their plain versions at
    Mistral-7B shapes, bit-equal (tolerance 0): both sides quantise x by IEEE
    division and round half to even, every dot is an exact integer (int32 in
    the kernels, f64 in the plain versions), and the f32 scale products and
    group sums are rounded one by one in the same order.

    q4 GEMV: wqkv, wo, w13, w2 at M = 1 and 4, group 512 (the q4 body
    ``q4p``) and 128 (each weight recoded on its own). W8A8 GEMM: w13 and w2
    at M = 512 and 256, i8 and q8 (the same codes without the row scale, at
    1/100), beside ``torch._int_mm`` and the two scale multiplies (the
    library's time; it is not used by the port). Layers cycle so every
    launch streams its weights cold."""
    import torch

    from xalm_tpu_torch.models.params import recode_qweight_q4
    from xalm_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=torch.float32)  # noqa: E731
    for group in (512, 128):
        for name in ("wqkv", "wo", "w13", "w2"):
            qw = getattr(q4p.layers, name)
            if qw.q4group != group:
                qw = recode_qweight_q4(getattr(params.layers, name), group)
            d, nb = qw.values.shape[-2:]
            n, ng = 2 * nb, qw.scale.shape[-1]
            kw = dict(scale=qw.scale, q4_group=group)
            for m in (1, 4):
                x = randn(m, n) * 3
                got = qmatmul(x, qw.values, 3 % cfg.n_layers, **kw)
                want = qmatmul_plain(x, qw.values, 3 % cfg.n_layers, **kw)
                layers = itertools.cycle(range(cfg.n_layers))
                cases.add("qmatmul_q4", f"M={m} {name} q4 g{group}", got, want, d, 0.0,
                          lambda: qmatmul(x, qw.values, next(layers), **kw),
                          lambda: qmatmul_plain(x, qw.values, next(layers), **kw),
                          None, d * nb + 4 * d * ng + 4 * m * (n + d), 2.0 * m * n * d, PEAK_S8,
                          extra={"library_null": NO_LIBRARY_Q4})
            del qw
            torch.cuda.empty_cache()
    for name in ("w13", "w2"):
        qw = getattr(params.layers, name)
        for kind in ("i8", "q8"):
            for m in (512, 256):
                _a8_case(cases, cfg, randn, f"M={m} {name} {kind}", m, qw, kind)
        del qw


def _a8_case(cases: Cases, cfg, randn, case, m, qw, kind) -> None:
    """Kernel 1's W8A8 GEMM (``qmatmul(a8=True)``) against its plain
    version on ``m`` random rows and the stacked int8 weight ``qw``, with
    its row scale (``kind`` "i8") or the fixed q8 scale ("q8"), bit-equal
    (phase_parity_quant's reasons), beside ``torch._int_mm`` and the two
    scale multiplies. Layers cycle so every launch streams its weights
    cold."""
    import torch

    from xalm_tpu_torch.models.params import Q8_FIXED_SCALE
    from xalm_tpu_torch.ops.attention import quant_rows
    from xalm_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain

    d, n = qw.values.shape[-2:]
    kw = dict(scale=qw.scale) if kind == "i8" else dict(q8_scale=Q8_FIXED_SCALE)
    x = randn(m, n)
    got = qmatmul(x, qw.values, 5 % cfg.n_layers, a8=True, **kw)
    want = qmatmul_plain(x, qw.values, 5 % cfg.n_layers, a8=True, **kw)
    xq, sx = quant_rows(x)
    layers = itertools.cycle(range(cfg.n_layers))
    lib_layers = itertools.cycle(range(cfg.n_layers))

    def lib():
        i = next(lib_layers)
        y = torch._int_mm(xq, qw.values[i].t()).float()
        y = y * qw.scale[i] if kind == "i8" else y * Q8_FIXED_SCALE
        return y * sx[:, None]
    cases.add("qmatmul_a8", case, got, want, d, 0.0,
              lambda: qmatmul(x, qw.values, next(layers), a8=True, **kw),
              lambda: qmatmul_plain(x, qw.values, next(layers), a8=True, **kw),
              lib, d * n + 4 * m * (n + d) + (4 * d if kind == "i8" else 0),
              2.0 * m * n * d, PEAK_S8)


# why no library call stands beside the int8-cache kernels
NO_LIBRARY_INT8 = "no one PyTorch call attends over (or writes) int8 codes with per-row scales"


def phase_parity_int8(cfg, cases: Cases, gen, cexp, sexp, tag: str = "") -> None:
    """Kernels 5-7 on random int8 planes (codes in [-127, 127], scales in
    [0, 0.02)) at the main path's shape (with ``tag``, the records are
    named ``kv_update_q<tag>`` and ``flash_decode_q<tag>``).

    kv_update_q (the insert and sink rotation alone, Gemma-2's capped
    path): codes and scales bit-equal to the plain version (absmax is
    order-free; scale and codes by IEEE division, rounded half to even on
    both sides), in three cases: a mid-ring insert, a wrapped insert with
    sink rotation, B = 3 with a row at the kv_pos == S sentinel.

    flash_decode_q, the launch that inserts, re-rotates and attends
    (``decode_q_cases``): the planes bit-equal to the plain composition's,
    the output within 1e-3 of each row's max. The plain version copies the
    kernel's 128-row chunks, so p * v_scale is rounded to bf16 at the same
    chunk max; the scores are f32 sums of exact products in another order
    (on the tensor cores, whose sums round toward zero), and a score that
    moves by a few f32 ulps can flip one bf16 rounding of p *
    v_scale, by 2^-8 of a term that holds a few hundredths of its row's
    softmax weight at most with these inputs: under 1e-3."""
    import torch

    from xalm_tpu_torch.ops import attention as A

    dev = torch.device(DEVICE)
    L, kh, hd, h, S = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, cfg.max_seq_len
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731

    def planes(b):
        shape = (L, b, kh, S, hd)
        codes = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 for _ in range(2)]
        return codes + scales

    for case, kv_pos, rot in (("mid-ring insert", (519,), (0,)),
                              ("wrapped insert + sink rotation", (1000,), (1,)),
                              ("B=3, row 1 at the kv_pos == S sentinel, row 2 rotating",
                               (300, S, 2000), (0, 0, 1))):
        b = len(kv_pos)
        full = planes(b)
        kn = torch.randn((b, kh, hd), generator=gen, device=dev)
        vn = torch.randn((b, kh, hd), generator=gen, device=dev)
        args = (kn, vn, i32(*kv_pos), i32(*rot), cexp, sexp)
        one = [t[5 % L][None] for t in full]
        p1, p2 = [t.clone() for t in one], [t.clone() for t in one]
        A.kv_update_q(*p1, 0, *args)
        A.kv_update_q_plain(*p2, 0, *args)
        # the code rows by head_dim, the scale planes held bit-equal beside them
        got = torch.cat([t.float().flatten() for t in p1[:2]])
        want = torch.cat([t.float().flatten() for t in p2[:2]])
        scales_equal = all(torch.equal(x, y) for x, y in zip(p1[2:], p2[2:]))
        layers = itertools.cycle(range(L))
        written = sum(kp < S for kp in kv_pos)
        nbytes = 2 * b * kh * hd * 4 + written * 2 * kh * (hd + 4) + 2 * sum(rot) * kh * 2 * (hd + 4)
        cases.add("kv_update_q" + tag, case, got, want, hd, 0.0,
                  lambda: A.kv_update_q(*full, next(layers), *args),
                  lambda: A.kv_update_q_plain(*full, next(layers), *args),
                  None, nbytes, 0.0, PEAK_F32,
                  extra={"library_note": NO_LIBRARY_INT8, "scales_equal": scales_equal},
                  extra_ok=scales_equal)
        del full, one, p1, p2

    decode_q_cases(cfg, cases, planes(1), gen, cexp, sexp, tag)


def decode_q_cases(cfg, cases: Cases, full, gen, cexp, sexp, tag: str = "",
                   label: str = "") -> None:
    """Kernels 5-7 in one launch (``fused_decode_attention_q``, recorded as
    ``flash_decode_q<tag>``) against the plain composition
    (``fused_decode_attention_q_plain``: ``kv_update_q_plain``, then
    ``flash_decode_q_plain``) on the int8 planes ``full`` (codes and
    scales) at kv_len 1, 520, 777 and the window, B = 1, the new row
    inserted at kv_len - 1 (at the window, a wrapped row at 1000 with the
    sinks re-rotated): the code and scale planes bit-equal, the output to
    1e-3 (see phase_parity_int8). ``label`` ends the case names."""
    import torch

    from xalm_tpu_torch.ops import attention as A

    dev = torch.device(DEVICE)
    L, kh, hd, h, S = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, cfg.max_seq_len
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    for kvl in (1, 520, 777, S):
        q = torch.randn((1, h, hd), generator=gen, device=dev)
        kn = torch.randn((1, kh, hd), generator=gen, device=dev)
        vn = torch.randn((1, kh, hd), generator=gen, device=dev)
        wrapped = kvl == S
        args = (kn, vn, i32(1000 if wrapped else kvl - 1), i32(kvl), i32(int(wrapped)), cexp,
                sexp)
        one = [t[7 % L][None] for t in full]
        p1, p2 = [t.clone() for t in one], [t.clone() for t in one]
        got = A.fused_decode_attention_q(q, *p1, 0, *args)
        want = A.fused_decode_attention_q_plain(q, *p2, 0, *args)
        planes_equal = all(torch.equal(x, y) for x, y in zip(p1, p2))
        layers = itertools.cycle(range(L))
        rot = 2 * kh * (hd + 4) if wrapped else 0  # the re-rotated sink keys written
        nbytes = (2 * kvl * kh * (hd + 4) + 2 * h * hd * 4 + 2 * kh * hd * 4
                  + 2 * kh * (hd + 4) + rot)
        cases.add("flash_decode_q" + tag, f"B=1 kv_len={kvl}{label}", got, want, hd, 1e-3,
                  lambda: A.fused_decode_attention_q(q, *full, next(layers), *args),
                  lambda: A.fused_decode_attention_q_plain(q, *full, next(layers), *args),
                  None, nbytes, 4.0 * h * kvl * hd, PEAK_F32,
                  extra={"library_note": NO_LIBRARY_INT8, "planes_equal": planes_equal},
                  extra_ok=planes_equal)
        del one, p1, p2
    del full
    torch.cuda.empty_cache()


# megakernel parity (phase 3), each output row against its own max |plain|.
# Kernel and plain version sum the same exact products in another order, so
# an f32 ulp of difference can flip the bf16 rounding of one activation
# (2^-8 of it) before a matmul. One flipped normed activation moves the
# next x by far more than f32 rounding, and 32 layers carry such flips on,
# so the plain version is just as far from itself when only the order of
# its sums changes. Each case measures that floor: the plain version on the
# model with its residual dimension permuted (on the H100, 1.0-1.5e-2 of
# max |x| at 32 layers, the kernel 1.2-1.8e-2). x, the logits and each
# cache row (hd values) within FUSED_TOL of their max; x also within
# FUSED_FLOOR_RATIO times its floor (or 1e-3); 95 % of the cache values
# within one bf16 ulp; the token equal wherever the plain top-2 margin is
# above twice FUSED_TOL of max |logits|, and always the argmax of the
# kernel's logits.
FUSED_TOL = 5e-2
FUSED_FLOOR_RATIO = 4.0
FUSED_ULP_SHARE = 0.95


def _rows_rel(got, want, row: int) -> list[float]:
    """Each row's max |got - want| over its max |want|."""
    got, want = got.float().reshape(-1, row), want.float().reshape(-1, row)
    err = (got - want).abs().amax(dim=1)
    return (err / want.abs().amax(dim=1).clamp_min(1e-30)).tolist()


def _row_rel(got, want, row: int) -> float:
    return max(_rows_rel(got, want, row))


def _ulp_share(got, want) -> float:
    """Share of the values of a bf16 tensor within one bf16 ulp of want."""
    import torch

    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((g - w).abs() <= ulp).float().mean())


def _model_dim_permuted(p, perm):
    """The same model with its residual dimension permuted by ``perm``: each
    matmul over the model dimension, and each rms, sums its terms in another
    order; x comes out permuted. (embed, norms and post-norms, wqkv, w13, the
    router, the experts' w13 and the head by column; wo, w2 and the experts'
    w2 by output row.)"""
    from xalm_tpu_torch.models.params import QWeight

    def cols(w):
        return None if w is None else QWeight(w.values[..., perm].contiguous(), w.scale)

    def rows(w):
        return None if w is None else QWeight(w.values[..., perm, :].contiguous(),
                                              w.scale[..., perm].contiguous())

    lp = p.layers
    dims = lambda t: None if t is None else t[:, perm].contiguous()  # noqa: E731
    layers = dataclasses.replace(
        lp, attn_norm=lp.attn_norm[:, perm], mlp_norm=lp.mlp_norm[:, perm], wqkv=cols(lp.wqkv),
        w13=cols(lp.w13), wo=rows(lp.wo), w2=rows(lp.w2), w13e=cols(lp.w13e), w2e=rows(lp.w2e),
        wgate=None if lp.wgate is None else lp.wgate[..., perm].contiguous(),
        post_attn_norm=dims(lp.post_attn_norm), post_mlp_norm=dims(lp.post_mlp_norm))
    return dataclasses.replace(p, embed=cols(p.embed), layers=layers, out_norm=p.out_norm[perm],
                               wcls=cols(p.wcls))


def _layer_window(p, first: int, n: int):
    """The model cut to its layers [first, first + n) (views of the stacked
    weights)."""
    from xalm_tpu_torch.models.params import QWeight

    lp, sl = p.layers, slice(first, first + n)
    cut = lambda w: QWeight(w.values[sl], w.scale[sl], w.q4group)  # noqa: E731
    opt = lambda t: None if t is None else t[sl]  # noqa: E731
    layers = dataclasses.replace(lp, attn_norm=lp.attn_norm[sl], mlp_norm=lp.mlp_norm[sl],
                                 wqkv=cut(lp.wqkv), wo=cut(lp.wo), w13=cut(lp.w13), w2=cut(lp.w2),
                                 bqkv=opt(lp.bqkv), q_norm=opt(lp.q_norm), k_norm=opt(lp.k_norm),
                                 post_attn_norm=opt(lp.post_attn_norm),
                                 post_mlp_norm=opt(lp.post_mlp_norm))
    return dataclasses.replace(p, layers=layers)


# The int8-activation bodies layer by layer (see phase_fused_parity): a row
# (of x, or of the logits) is exact when it is within EXACT_TOL of its max,
# f32 rounding with every activation code as the plain version's. At least
# EXACT_SHARE of a body's rows must be exact, and every row within FUSED_TOL.
EXACT_TOL = 1e-5
EXACT_SHARE = 0.75


def _code_share(got, want) -> float:
    """Share of the codes of an int8 plane within one count of want."""
    return float(((got.int() - want.int()).abs() <= 1).float().mean())


def _dequant(codes, scales):
    return codes.float() * scales[..., None]


def _exact_share(rels) -> float:
    return sum(r <= EXACT_TOL for r in rels) / len(rels)


def _layer_rule(body: str, layer_rows: dict, kernel: str) -> dict:
    """The layer-by-layer rule of an int8-activation body over the rows of
    all its cases (see phase_fused_parity), and the control's."""
    def rule(rels):
        return {"rows": len(rels), "exact_share": _exact_share(rels), "max_row_rel": max(rels),
                "ok": _exact_share(rels) >= EXACT_SHARE and max(rels) <= FUSED_TOL}

    row = {"phase": "megakernel_layers", "kernel": kernel, "body": body, "exact_tol": EXACT_TOL,
           "min_exact_share": EXACT_SHARE, "tol_row_rel": FUSED_TOL, **rule(layer_rows["kernel"])}
    if layer_rows["control"]:
        row["control"] = {"what": "the kernel's bf16-activation body against the a8 plain version",
                          **rule(layer_rows["control"])}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"megakernel {body} body, layer by layer: {row}")
    if row.get("control", {}).get("ok"):
        raise AssertionError(f"megakernel {body} body: the layer rule passes the control too: {row}")
    return row


def quant_body_cases(S: int) -> tuple:
    """The a8 and q4 bodies' cases at window S: B = 1 and 4, bf16 and int8
    caches, the i8 head: (int8 cache, case, positions, embed fold, head fold,
    sentinel row)."""
    return (
        (False, "B=1 kv_len=520, embed fold", [519], True, False, None),
        (False, "B=1 wrapped (sink rotation), embed + i8-head folds", [S + 700], True, True, None),
        (False, "B=4, row 2 at the kv_pos == S sentinel", [519, 1200, 300, S + 5], False, False, 2),
        (True, "int8 KV, B=1 kv_len=520, embed fold", [519], True, False, None),
        (True, "int8 KV, B=4 kv_len 520/4000/wrapped, row 3 at the sentinel",
         [519, 3999, S + 700, 300], False, False, 3),
    )


# the bf16 body's cases of phase_fused_parity: (int8 cache, case, positions,
# embed fold, head fold, sentinel row)
BF16_BODY_CASES = (
    (False, "B=1 kv_len=520, embed fold", [519], True, False, None),
    (False, "B=1 wrapped (sink rotation), embed + i8-head folds", [4096 + 700], True, True, None),
    (False, "B=4, row 2 at the kv_pos == S sentinel", [519, 1200, 300, 4096 + 5], False, False, 2),
    (True, "int8 KV, B=1 kv_len=520, embed fold", [519], True, False, None),
    (True, "int8 KV, B=1 kv_len=4000, embed + i8-head folds", [3999], True, True, None),
    (True, "int8 KV, B=4 kv_len=520, row 3 at the sentinel", [519] * 4, False, False, 3),
    (True, "int8 KV, B=4 kv_len 520/4000/wrapped, row 3 at the sentinel",
     [519, 3999, 4096 + 700, 300], False, False, 3))


def phase_fused_parity(params, cfg, cases: Cases, body: str = "", kernel: str = "",
                       only: tuple = (), cache=None, label: str = "") -> dict | None:
    """The megakernel against its plain version at full width and 32 layers
    (random planes). bf16 cache, three cases: (a) B=1 at kv_len 520 with the
    embed fold; (b) B=1 at a wrapped position (sink rotation) with the embed
    and i8-head folds; (c) B=4 with one row at the kv_pos == S sentinel.
    int8 cache (codes and scales as in phase_parity_int8), four cases: B=1
    at kv_len 520 (embed fold) and 4000 (embed and i8-head folds); B=4 at
    kv_len 520 with a sentinel row; B=4 at kv_len 520, 4000, a wrapped row
    (sink rotation) and a sentinel row. The int8 cases hold the dequantised
    cache rows to FUSED_TOL and FUSED_ULP_SHARE of the codes to one count
    (the limits of the bf16 rows and values). Then the cost of one grid
    barrier on the kernel's grid.

    ``body`` "a8" or "q4" (``params`` then an i8 or a q4 body): the a8 or q4
    body in the five ``quant_body_cases``, the i8 head under a8 too. Both
    sides quantise the same f32 rows and every dot is an exact integer, so
    until an activation lands one int8 code apart they agree to f32
    rounding; then the random layers carry the difference on and grow it
    (on an H100 at full width, B = 1 and 4: one code apart moves its row by
    4e-3 to 1e-2, and at 32 layers the rows are 2e-2 to 0.18 apart). A
    permuted model keeps the integer dots as they were (and a q4 model
    cannot be permuted freely: two codes share a byte), so the 32-layer
    floor here is the plain version against itself with its input rows
    moved by 1e-6 of themselves, and x, the cache rows and the logits are
    held to FUSED_FLOOR_RATIO times it (the cache rows and logits at least
    to FUSED_TOL): that says no more than that the 32-layer output is the
    plain version's up to the model's own sensitivity. The tight check is
    layer by layer: each case runs again on each of the L layers alone and
    on the first two together (the kernel's layer stride), same inputs,
    and of all the rows of x (and of the logits) that a body's cases give
    there at least EXACT_SHARE must be within EXACT_TOL of their max, every
    one within FUSED_TOL. A body that quantised other rows than the
    reference's in any phase (the bf16 copy, say) would land codes apart
    in nearly every row. The a8 body's control shows the rule tells them
    apart: the kernel's bf16-activation body (``a8=False``) on the same
    windows, against the a8 plain version, must fail it. (q4 has no
    bf16-activation body in either package; it quantises through the same
    code as a8.)

    ``kernel`` names the records (the family folds: ``fused_decode_bias``,
    ``fused_decode_qk_norm``, ``fused_decode_gemma``, ``fused_decode_gemma2``,
    whose cases then carry the body in their name), ``only`` keeps the cases
    of those indices; the grid barrier is
    timed with the bf16 body's default run alone. ``cache`` torch.float32
    puts the float cases on f32 planes (the f32 instantiations, named
    ``fused_decode_f32``; the rows and sinks stored unrounded, the cache
    rows held as the bf16 rows are), ``label`` ends the case names. The
    positions are those of a 4096-slot window (every configuration's)."""
    import torch

    from xalm_tpu_torch.models.llama import rope_constants, rope_tables
    from xalm_tpu_torch.models.params import recode_wcls_i8
    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    L, S, N = cfg.n_layers, cfg.max_seq_len, cfg.dim
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    freqs, c1, s1 = rope_constants(cfg, dev)
    freqs_h = rope_constants(cfg, torch.device("cpu"))[0]
    head_params = recode_wcls_i8(params)
    lp = params.layers
    w_elems = sum(w.values.numel() for w in (lp.wqkv, lp.wo, lp.w13, lp.w2))
    w_bytes = w_elems + 4 * sum(w.scale.numel() for w in (lp.wqkv, lp.wo, lp.w13, lp.w2)) + 8 * L * N
    w_bytes += 4 * sum(t.numel() for t in (lp.bqkv, lp.q_norm, lp.k_norm, lp.post_attn_norm,
                                           lp.post_mlp_norm) if t is not None)
    if body == "q4":
        w_elems *= 2  # two codes a byte: the multiply-adds
    barrier = not (body or kernel or only)
    kernel = kernel or "fused_decode" + (f"_{body}" if body else "")
    body_kw = dict(a8=True) if body else {}
    layer_rows = {"kernel": [], "control": []}  # the layer-by-layer rows of every case
    if S != 4096:
        raise AssertionError(f"phase_fused_parity: the cases are set for a 4096-slot window, not {S}")
    all_cases = quant_body_cases(S) if body else BF16_BODY_CASES

    for quant, case, pos_list, embed, head, sentinel in (
            [all_cases[i] for i in only] if only else all_cases):
        b = len(pos_list)
        p = head_params if head else params
        pos = torch.tensor(pos_list, dtype=torch.int32)
        _, kv_pos, kv_len = ring_indices(pos, S)
        rot = (pos >= S).to(torch.int32)
        if sentinel is not None:
            kv_pos[sentinel], rot[sentinel] = S, 0
        shape = KVCache.plane_shape(cfg, b)
        if quant:
            ck, cv = (torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                      for _ in range(2))
            ks, vs = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 for _ in range(2))
        else:
            ck = torch.randn(shape, generator=gen, device=dev).to(cache or torch.bfloat16)
            cv = torch.randn(shape, generator=gen, device=dev).to(cache or torch.bfloat16)
            ks = vs = None
        tok = torch.randint(3, cfg.vocab_size, (b,), generator=gen, device=dev).cpu()
        kw = dict(wcls=p.wcls, out_norm=p.out_norm) if head else {}
        kw.update(body_kw)
        if embed:
            kw.update(embed=p.embed, token=tok, pos=pos, freqs=freqs)
            x0 = ce = se = None
        else:
            x0 = p.embed.values[tok.to(dev)].float() * cfg.embed_scale  # the forward's x0
            ce, se = (z[:, 0, 0] for z in rope_tables(pos[:, None], freqs_h))

        def args(k, v, x0=x0, ce=ce, se=se, p=p, kv_pos=kv_pos, kv_len=kv_len, rot=rot):
            return (p, cfg, x0, k, v, kv_pos, kv_len, rot, ce, se, c1, s1)

        def scales(kw, ks=ks, vs=vs):
            """kw with fresh copies of the scale planes (int8 cache)"""
            return dict(kw, k_scale=ks.clone(), v_scale=vs.clone()) if quant else kw

        k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        kw1, kw2 = scales(kw), scales(kw)
        got = fd.fused_decode_step(*args(k1, v1), **kw1)
        want = fd.fused_decode_step_plain(*args(k2, v2), **kw2)
        k3 = v3 = kw3 = floor = None
        if not body:
            # the floor: the plain version against itself on the permuted model
            perm = torch.randperm(N, generator=gen, device=dev)
            q = _model_dim_permuted(p, perm)
            q_kw = dict(kw, **(dict(wcls=q.wcls, out_norm=q.out_norm) if head else {}),
                        **(dict(embed=q.embed) if embed else {}))
            k3, v3 = ck.clone(), cv.clone()
            kw3 = scales(q_kw)
            floor = list(fd.fused_decode_step_plain(
                q, cfg, None if x0 is None else x0[:, perm], *args(k3, v3)[3:], **kw3))
            floor[0] = floor[0][:, torch.argsort(perm)]
            del q, q_kw
        else:
            # the floor of a quantised body: the plain version against itself
            # with its input rows moved by 1e-6 of themselves
            xin = x0 if x0 is not None else p.embed.values[tok.to(dev)].float() * cfg.embed_scale
            ce_f, se_f = (ce, se) if x0 is not None else (
                z[:, 0, 0].to(dev) for z in rope_tables(pos[:, None], freqs_h))
            xin = xin * (1 + 1e-6 * torch.randn(xin.shape, generator=gen, device=dev))
            k3, v3 = ck.clone(), cv.clone()
            kw3 = scales({k: v for k, v in kw.items() if k not in ("embed", "token", "pos", "freqs")})
            floor = list(fd.fused_decode_step_plain(p, cfg, xin, k3, v3, kv_pos, kv_len, rot, ce_f,
                                                    se_f, c1, s1, **kw3))
        torch.cuda.synchronize()
        x_rel = _row_rel(got[0], want[0], N)
        x_floor = _row_rel(floor[0], want[0], N)
        extra = {"batch": b, "positions": pos_list, "kv_len": kv_len.tolist(),
                 "x_floor_row_rel": x_floor}
        if quant:  # the dequantised rows, and the codes within one count
            rows = {n: _dequant(c, sc) for n, c, sc in (
                ("k1", k1, kw1["k_scale"]), ("v1", v1, kw1["v_scale"]),
                ("k2", k2, kw2["k_scale"]), ("v2", v2, kw2["v_scale"]))}
            extra.update({
                "cache_k_row_rel": _row_rel(rows["k1"], rows["k2"], hd),
                "cache_v_row_rel": _row_rel(rows["v1"], rows["v2"], hd),
                "cache_ulp_share": min(_code_share(k1, k2), _code_share(v1, v2)),
                "code_equal_share": min(float((k1 == k2).float().mean()),
                                        float((v1 == v2).float().mean()))})
            k3d, v3d = _dequant(k3, kw3["k_scale"]), _dequant(v3, kw3["v_scale"])
            extra.update({"cache_k_floor_row_rel": _row_rel(k3d, rows["k2"], hd),
                          "cache_v_floor_row_rel": _row_rel(v3d, rows["v2"], hd),
                          "code_floor_share": min(_code_share(k3, k2), _code_share(v3, v2))})
            del rows, k3d, v3d
        else:
            extra.update({
                "cache_k_row_rel": _row_rel(k1, k2, hd), "cache_v_row_rel": _row_rel(v1, v2, hd),
                "cache_ulp_share": min(_ulp_share(k1, k2), _ulp_share(v1, v2)),
                "cache_k_floor_row_rel": _row_rel(k3, k2, hd),
                "cache_v_floor_row_rel": _row_rel(v3, v2, hd)})
        if body:  # layer by layer: the kernel, its plain version, the control
            wins = [(first, 1) for first in range(L)] + [(0, 2)]
            runs = [("kernel", fd.fused_decode_step, kw), ("plain", fd.fused_decode_step_plain, kw)]
            if body == "a8":
                runs.append(("control", fd.fused_decode_step, dict(kw, a8=False)))
            case_rows = {"kernel": [], "control": []}
            for first, n in wins:
                pw, cfgw, sl = _layer_window(p, first, n), dataclasses.replace(cfg, n_layers=n), \
                    slice(first, first + n)
                out = {}
                for name, fn, kwr in runs:
                    if quant:
                        kwr = dict(kwr, k_scale=ks[sl].clone(), v_scale=vs[sl].clone())
                    out[name] = fn(pw, cfgw, x0, ck[sl].clone(), cv[sl].clone(), kv_pos, kv_len,
                                   rot, ce, se, c1, s1, **kwr)
                for name in case_rows:
                    if name in out:
                        case_rows[name] += _rows_rel(out[name][0], out["plain"][0], N)
                        if head:
                            case_rows[name] += _rows_rel(out[name][1], out["plain"][1],
                                                         p.wcls.values.shape[0])
                del pw, out
            for name, r in case_rows.items():
                layer_rows[name] += r
            extra["layers_rows"] = len(case_rows["kernel"])
            extra["layers_exact_share"] = _exact_share(case_rows["kernel"])
            extra["layers_max_row_rel"] = max(case_rows["kernel"])
        if sentinel is not None:  # the dropped row: every attended slot as it was
            extra["sentinel_row_unchanged"] = bool(
                torch.equal(k1[:, sentinel, :, :S], ck[:, sentinel, :, :S])
                and torch.equal(v1[:, sentinel, :, :S], cv[:, sentinel, :, :S])
                and (not quant or torch.equal(kw1["k_scale"][:, sentinel, :, :S],
                                              ks[:, sentinel, :, :S])))
        # a quantised body's cache rows and logits: their own floors too
        lim = lambda floor_rel: max(FUSED_TOL, FUSED_FLOOR_RATIO * floor_rel) if body \
            else FUSED_TOL  # noqa: E731
        ok = (x_rel <= max(FUSED_FLOOR_RATIO * x_floor, 1e-3)  # 1e-3: a floor of no flip at all
              and extra["cache_k_row_rel"] <= lim(extra["cache_k_floor_row_rel"])
              and extra["cache_v_row_rel"] <= lim(extra["cache_v_floor_row_rel"])
              and extra["cache_ulp_share"] >= FUSED_ULP_SHARE and extra.get("sentinel_row_unchanged", True))
        row_bytes = hd + 4 if quant else ck.element_size() * hd  # int8 codes + scale, or float
        nbytes = w_bytes + b * N * (2 if embed else 4) + b * N * 4
        nbytes += 2 * L * kh * row_bytes * (int(kv_len.sum()) + b)  # cache rows read, rows written
        nbytes += 2 * L * kh * 2 * row_bytes * int(rot.sum())  # K sinks read and written
        flops = 2.0 * b * w_elems + 4.0 * L * cfg.n_heads * hd * int(kv_len.sum())
        if head:
            v_ = p.wcls.values.shape[0]
            nbytes += v_ * N + v_ * 4 + N * 4 + b * v_ * 4 + b * 4
            flops += 2.0 * b * v_ * N
            extra["logits_row_rel"] = _row_rel(got[1], want[1], v_)
            extra["logits_floor_row_rel"] = _row_rel(floor[1], want[1], v_)
            top2 = want[1].topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * FUSED_TOL * want[1].abs().amax(dim=-1)
            extra["token_equal"] = bool(torch.equal(got[2][clear], want[2][clear]))
            extra["token_is_argmax"] = bool(torch.equal(got[2], got[1].argmax(dim=-1).to(torch.int32)))
            ok = ok and extra["logits_row_rel"] <= lim(extra["logits_floor_row_rel"]) \
                and extra["token_equal"] and extra["token_is_argmax"]
        cases.add(kernel, (f"{body} " if body else "") + case + label, got[0], want[0], N,
                  max(FUSED_FLOOR_RATIO * x_floor, 1e-3) if body else FUSED_TOL,
                  lambda a=args(ck, cv), kw=scales(kw): fd.fused_decode_step(*a, **kw),
                  lambda a=args(ck, cv), kw=scales(kw): fd.fused_decode_step_plain(*a, **kw),
                  None, nbytes, flops, PEAK_BF16, extra=extra, extra_ok=ok)
        del ck, cv, ks, vs, k1, v1, k2, v2, k3, v3, kw1, kw2, kw3, got, want, floor
        torch.cuda.empty_cache()
    if body:
        _layer_rule(body, layer_rows, kernel)
    if not barrier:
        return None

    lib = build.load_library("fused_decode")
    bar = torch.zeros((256,), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    iters = 4000
    build.check(lib.xq_grid_barrier_bench(bar.data_ptr(), 10, stream), "grid barrier")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    build.check(lib.xq_grid_barrier_bench(bar.data_ptr(), iters, stream), "grid barrier")
    end.record()
    end.synchronize()
    row = {"phase": "megakernel", "grid_blocks": lib.xq_fused_decode_grid(),
           "sms": torch.cuda.get_device_properties(dev).multi_processor_count,
           "barrier_us": start.elapsed_time(end) / iters * 1e3,
           "barriers_per_step": 1 + 7 * L, "barriers_per_step_head_fold": 2 + 7 * L}
    emit(row)
    return row


def _main_run(eng, cfg, prompt, label: str) -> dict:
    """One main-path run: warm up, then ``Engine.generate`` of a 512-token
    prompt and 64 greedy tokens with every launch counter set to 0 just
    before and read just after; the launches of one 512-token prefill chunk
    and of one decode step; the profile of the decode steps."""
    import numpy as np
    import torch

    from xalm_tpu_torch.ops import build

    eng.generate(prompt[:32], 2, stop_on_eos=False)  # warm-up (allocator, first launches)
    torch.cuda.synchronize()

    build.reset_launches()
    out, stats = eng.generate(prompt, 64, stop_on_eos=False)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if len(out) != 64:
        raise AssertionError(f"{label}: generated {len(out)} tokens, expected 64")

    # launches per 512-token prefill chunk and per decode token
    build.reset_launches()
    cache = eng.new_cache(1)
    logits, cache, pos = eng.prefill(prompt, cache)
    per_chunk = dict(build.LAUNCHES)
    build.reset_launches()
    logits2, _ = eng.decode(np.array([out[-1]]), np.array([pos], np.int32), cache)
    per_token = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    for lg in (logits, logits2):
        if lg.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all():
            raise AssertionError(f"{label}: main path logits are not finite (1, vocab)")
    prof = phase_profile(eng, prompt, out[-1], label)
    weights_gb = eng.active_bytes(len(prompt)) / 1e9
    row = {
        "phase": "main_path", "run": label, "layers": cfg.n_layers, "dim": cfg.dim,
        "hidden": cfg.hidden_dim, "vocab": cfg.vocab_size, "window": cfg.max_seq_len,
        "kv_dtype": str(eng.kv_dtype).split(".")[-1], "cache_bytes": cache.nbytes(),
        "prompt_tokens": len(prompt), "generated_tokens": stats.generated_tokens,
        "decode_path": eng.decode_path(1),
        "prefill_s": stats.prefill_s, "prefill_tok_s": len(prompt) / stats.prefill_s,
        "decode_s": stats.decode_s, "decode_tok_s": stats.tok_per_s,
        "decode_ms_per_token": stats.decode_s / stats.generated_tokens * 1e3,
        "decode_gb_s": stats.bandwidth_gb_s,
        "hbm_share": stats.bandwidth_gb_s * 1e9 / HBM_BYTES_PER_S,
        "active_gb_per_token": weights_gb,
        "bound_ms_per_token": weights_gb * 1e9 / HBM_BYTES_PER_S * 1e3,
        "launches": launches, "launches_per_512_chunk": per_chunk,
        "launches_per_decode_token": per_token,
        "decode_device_busy_ms_per_token": (
            prof["decode"]["device_busy_ms"] / prof["decode"]["steps"]
            if isinstance(prof["decode"]["device_busy_ms"], float) else "not measured"),
        "decode_device_idle_share": prof["decode"]["device_idle_share"],
        "decode_device_ms_per_token_by_kernel": (
            {g: ms / prof["decode"]["steps"] for g, ms in prof["decode"]["device_ms"].items() if ms}
            if isinstance(prof["decode"]["device_busy_ms"], float) else "not measured"),
        "prefill_gemm_device_ms": prof["prefill_512"]["gemm_device_ms"],
        "prefill_gemm_records": prof["prefill_512"]["gemm_records"],
        "prefill_device_ms": prof["prefill_512"]["device_busy_ms"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tokens_head": out[:8],
    }
    emit(row)
    return row


def phase_main(params, cfg) -> dict:
    """The main path seven times: with a bf16, an int8 (``kv_dtype=torch.int8``,
    per-row scales) and an f32 cache, each on the default decode path (the
    megakernel: one fused_decode launch per decode token, counted under
    fused_decode_f32 too with the f32 cache) and with ``fused_step=False``
    (the per-layer kernels: per token 129 qmatmul launches, and per layer
    one flash_decode launch (or its ``_f32`` instantiation, or with the
    int8 cache flash_decode_q) that inserts, re-rotates and attends (no
    kv_update, kv_update_f32 or kv_update_q); per 512-token prefill chunk a
    flash_prefill or flash_prefill_f32 launch a layer, none with the int8
    cache, whose chunks take the dense attention); and with an f16 cache on
    its default path, per layer (no megakernel and no attention kernel
    takes f16, in either package: the dense attention, the matmuls on
    kernel 1). Returns the launches of the runs, summed."""
    import numpy as np
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(SEED).integers(3, cfg.vocab_size, size=512).tolist()
    L = cfg.n_layers
    launches = dict.fromkeys(build.LAUNCHES, 0)
    attention = ("kv_update", "flash_decode", "kv_update_q", "flash_decode_q", "kv_update_f32",
                 "flash_decode_f32")
    prefill = ("flash_prefill", "flash_prefill_f32")
    runs = []
    for kv, tag, fk, pk in ((torch.bfloat16, "", "", "flash_prefill"),
                            (torch.int8, "int8 ", "_q", None),
                            (torch.float32, "f32 ", "_f32", "flash_prefill_f32")):
        mega = {"fused_decode": 1, **dict.fromkeys(attention, 0)}
        if kv == torch.float32:
            mega["fused_decode_f32"] = 1
        runs.append((kv, tag, "megakernel", {}, mega, pk))
        # per layer: the insert rides in flash_decode's (or flash_decode_q's) launch
        per = {"qmatmul": 4 * L + 1, **dict.fromkeys(attention, 0), "flash_decode" + fk: L,
               "fused_decode": 0, "fused_decode_f32": 0}
        runs.append((kv, tag, "perlayer", dict(fused_step=False), per, pk))
    runs.append((torch.float16, "f16 ", "perlayer", {},
                 {"qmatmul": 4 * L + 1, **dict.fromkeys(attention, 0), "fused_decode": 0}, None))
    for kv, tag, path, kw, want, chunk_kernel in runs:
        eng = Engine(cfg, params, kv_dtype=kv, **kw)  # kernels; megakernel decode by default
        if eng.decode_path(1) != path:
            raise AssertionError(f"decode path {eng.decode_path(1)!r}, expected {path!r}")
        row = _main_run(eng, cfg, prompt, tag + path)
        per_token, per_chunk = row["launches_per_decode_token"], row["launches_per_512_chunk"]
        want_chunk = {k: L if k == chunk_kernel else 0 for k in prefill}
        if (any(per_token[k] != n for k, n in want.items())
                or any(per_chunk[k] != n for k, n in want_chunk.items())
                or (path == "megakernel" and row["launches"]["fused_decode"] != 63)
                or per_chunk["qmatmul"] != 4 * L + 1 or row["prefill_gemm_records"] == 0):
            raise AssertionError(f"{tag}{path} run: {row['launches']}, per token {per_token}, "
                                 f"per chunk {per_chunk}: expected per token {want}, per chunk "
                                 f"{want_chunk}")
        launches = {k: launches[k] + row["launches"][k] for k in launches}
        del eng
        torch.cuda.empty_cache()
    return {"launches": launches}


def phase_main_quant(params, q4p, cfg) -> dict:
    """The main path three more times, bf16 cache: the q4 body (group 512,
    recoded on the card from the i8 body, ``a8_decode``) on the megakernel
    (one fused_decode_q4 launch per decode token) and with
    ``fused_step=False`` (per token 4L qmatmul_q4 launches, the bf16 head on
    qmatmul, and the per-layer attention); the i8 body with ``a8_decode``
    and ``a8_prefill`` (one fused_decode_a8 launch per decode token, and 4L
    qmatmul_a8 launches per 512-token prefill chunk). A q4 prefill chunk of
    512 rows dequantizes each layer and runs one product, as the reference
    does. Returns the launches of the runs, summed."""
    import numpy as np
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(SEED).integers(3, cfg.vocab_size, size=512).tolist()
    L = cfg.n_layers
    launches = dict.fromkeys(build.LAUNCHES, 0)
    for label, p, kw, path, per_token, per_chunk, counter in (
            ("q4 megakernel", q4p, dict(a8_decode=True), "megakernel",
             {"fused_decode_q4": 1, "qmatmul": 1, "fused_decode": 0}, {}, ("fused_decode_q4", 63)),
            ("q4 perlayer", q4p, dict(a8_decode=True, fused_step=False), "perlayer",
             {"qmatmul_q4": 4 * L, "qmatmul": 1, "kv_update": 0, "flash_decode": L,
              "fused_decode_q4": 0}, {}, ("qmatmul_q4", 63 * 4 * L)),
            ("a8 megakernel", params, dict(a8_decode=True, a8_prefill=True), "megakernel",
             {"fused_decode_a8": 1, "qmatmul": 1, "fused_decode": 0}, {"qmatmul_a8": 4 * L},
             ("fused_decode_a8", 63))):
        eng = Engine(cfg, p, kv_dtype=torch.bfloat16, **kw)
        if eng.decode_path(1) != path:
            raise AssertionError(f"{label}: decode path {eng.decode_path(1)!r}, expected {path!r}")
        row = _main_run(eng, cfg, prompt, label)
        got_t, got_c = row["launches_per_decode_token"], row["launches_per_512_chunk"]
        if (any(got_t[k] != n for k, n in per_token.items())
                or any(got_c[k] != n for k, n in per_chunk.items())
                or row["launches"][counter[0]] != counter[1]):
            raise AssertionError(f"{label} run: {row['launches']}, per token {got_t}, per chunk "
                                 f"{got_c}: expected per token {per_token}, per chunk {per_chunk}, "
                                 f"{counter}")
        launches = {k: launches[k] + row["launches"][k] for k in launches}
        del eng
        torch.cuda.empty_cache()
    return {"launches": launches}


LONG_PROMPT = 2048  # four 512-row chunks: three run kernel 4 past a prefix


def phase_long_prompt(params, cfg) -> dict:
    """The main path once more, bf16 cache, megakernel decode, with a
    2048-token prompt: ``Engine.generate`` of it and 16 greedy tokens, the
    launch counters set to 0 just before and read just after (per chunk a
    flash_prefill launch a layer: 4L), the prefill's tok/s, and a profile of
    one such prefill (device ms by kernel: flash_prefill's share grows with
    the chunk's position). Returns the run's launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(SEED + 2).integers(3, cfg.vocab_size, size=LONG_PROMPT).tolist()
    eng = Engine(cfg, params, kv_dtype=torch.bfloat16)
    if eng.decode_path(1) != "megakernel":
        raise AssertionError(f"long prompt: decode path {eng.decode_path(1)!r}")
    eng.generate(prompt[:600], 2, stop_on_eos=False)  # warm-up: a chunk past a prefix too
    torch.cuda.synchronize()
    build.reset_launches()
    out, stats = eng.generate(prompt, 16, stop_on_eos=False)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    chunks = LONG_PROMPT // 512
    if len(out) != 16 or launches["flash_prefill"] != chunks * cfg.n_layers:
        raise AssertionError(f"long prompt: {len(out)} tokens, launches {launches}")
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        cache = eng.new_cache(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PRIMES):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            logits, cache, pos = eng.prefill(prompt, cache)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev, top, records, (gemm_ms, gemm_n) = _device_times(prof)
        if records["flash_prefill_kernel"] == chunks * cfg.n_layers:
            break
    if pos != LONG_PROMPT or not torch.isfinite(logits).all():
        raise AssertionError(f"long prompt: prefill to {pos}, logits finite "
                             f"{bool(torch.isfinite(logits).all())}")
    complete = records["flash_prefill_kernel"] == chunks * cfg.n_layers
    row = {"phase": "main_path", "run": f"long prompt {LONG_PROMPT}, bf16 cache, megakernel",
           "prompt_tokens": LONG_PROMPT, "generated_tokens": stats.generated_tokens,
           "prefill_s": stats.prefill_s, "prefill_tok_s": LONG_PROMPT / stats.prefill_s,
           "decode_ms_per_token": stats.decode_s / stats.generated_tokens * 1e3,
           "launches": launches, "profile_prefill_wall_ms": wall_ms,
           "profile_attempts": attempt, "records_complete": complete,
           "prefill_device_ms": dev if complete else "not measured",
           "flash_prefill_device_ms": dev["flash_prefill"] if complete else "not measured",
           "gemm_device_ms": gemm_ms if complete else "not measured", "gemm_records": gemm_n,
           "top": top, "tokens_head": out[:8]}
    emit(row)
    del eng
    torch.cuda.empty_cache()
    return {"launches": launches}


SCAN_TOKENS = 64  # tokens a generate of phase_scan, after a 512-token prompt
SCAN_SEGMENT = 16  # generate's default segment on the card
SCAN_PPL_STEPS = 64  # teacher-forced steps of the scanned-perplexity check


def _scan_profile(eng, prompt) -> dict:
    """``_profiled`` over one segment of SCAN_SEGMENT graph replays after a
    512-token prefill (the engine's greedy scan, its graph captured
    already)."""
    import torch

    from xalm_tpu_torch.sampler import sample_argmax

    logits, cache, pos = eng.prefill(prompt, eng.fresh_cache(1))
    st, graph = eng._scan(cache, "greedy")
    with torch.inference_mode():
        st.token.copy_(sample_argmax(logits))
        st.pos.fill_(pos)

    def segment():
        with torch.inference_mode():
            eng._run(st, graph, SCAN_SEGMENT)

    return _profiled(segment, SCAN_SEGMENT)


GRAPH_DEPTH_TURNS = 4  # segments a turn of _graph_depth


def _graph_depth(eng, prompt) -> dict:
    """The graph's depth: a segment of SCAN_SEGMENT steps as that many
    replays of the engine's one-step graph (the design kept) against one
    replay of a graph captured over SCAN_SEGMENT steps of the same step
    function and buffers, in turns (one, deep, deep, one), each turn
    GRAPH_DEPTH_TURNS segments from the state the last left (the window
    grows by a few hundred rows over the four turns), host clock around a
    synchronised turn: ms a token of each, and the tokens of both designs
    from one common state held equal."""
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.sampler import sample_argmax

    logits, cache, pos = eng.prefill(prompt, eng.fresh_cache(1))
    st, one = eng._scan(cache, "greedy")
    with torch.inference_mode():
        st.token.copy_(sample_argmax(logits))
        st.pos.fill_(pos)
        one.run(1)  # the one-step graph, captured if it was not
        deep = torch.cuda.CUDAGraph()
        before = dict(build.LAUNCHES)
        with torch.cuda.graph(deep):
            for _ in range(SCAN_SEGMENT):
                one._step()
        build.take_launches(before)
    torch.cuda.synchronize()

    def turn(kind: str) -> float:
        t0 = time.perf_counter()
        for _ in range(GRAPH_DEPTH_TURNS):
            st.slot.zero_()
            if kind == "deep":
                deep.replay()
            else:
                for _ in range(SCAN_SEGMENT):
                    one.graph.replay()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (GRAPH_DEPTH_TURNS * SCAN_SEGMENT)

    times = {"one_step": [], "deep": []}
    for kind in ("one_step", "deep", "deep", "one_step"):
        times[kind].append(turn("deep" if kind == "deep" else "one"))
    # both designs from one state: the same tokens
    snap = [t.clone() for t in cache.planes()] + [st.token.clone(), st.pos.clone()]
    outs = []
    for kind in ("one", "deep"):
        for t, v in zip(cache.planes() + (st.token, st.pos), snap):
            t.copy_(v)
        st.slot.zero_()
        if kind == "deep":
            deep.replay()
        else:
            for _ in range(SCAN_SEGMENT):
                one.graph.replay()
        outs.append(st.out[:, :SCAN_SEGMENT].clone())
    torch.cuda.synchronize()
    equal = bool(torch.equal(outs[0], outs[1]))
    if not equal:
        raise AssertionError(f"graph depth: the {SCAN_SEGMENT}-step graph's tokens differ")
    del deep
    return {"segment": SCAN_SEGMENT, "turns": GRAPH_DEPTH_TURNS, "tokens_equal": equal,
            "one_step_graph_ms_per_token": times["one_step"],
            f"graph_of_{SCAN_SEGMENT}_steps_ms_per_token": times["deep"]}


def _scan_ppl_bit_equal(eng, prompt) -> dict:
    """Scanned perplexity against per-token steps on one path: after the
    same 512-token prefill into two caches, SCAN_PPL_STEPS teacher-forced
    steps as one ``_ppl_scan`` segment (graph replays) and as eager
    ``decode`` calls, each step's log p(target) taken from its logits: the
    log-probs bit for bit."""
    import numpy as np
    import torch

    from xalm_tpu_torch.sampler import token_logprobs

    cfg = eng.cfg
    seq = np.random.default_rng(SEED + 5).integers(3, cfg.vocab_size,
                                                   size=SCAN_PPL_STEPS + 1).astype(np.int32)
    _, ca, pos = eng.prefill(prompt, eng.new_cache(1))
    _, cb, _ = eng.prefill(prompt, eng.new_cache(1))
    lps, _ = eng._ppl_scan(seq[None, :-1], seq[None, 1:], np.array([pos], np.int32), ca)
    want = []
    for i in range(SCAN_PPL_STEPS):
        logits, cb = eng.decode(seq[i:i + 1], np.array([pos + i], np.int32), cb)
        with torch.inference_mode():
            want.append(token_logprobs(logits, torch.tensor([int(seq[i + 1])],
                                                            device=logits.device)))
    want = torch.cat(want)
    diff = (lps[0] - want).abs()
    row = {"phase": "scan_perplexity", "steps": SCAN_PPL_STEPS, "decode_path": eng.decode_path(1),
           "bit_equal": bool(torch.equal(lps[0], want)), "max_abs_diff": float(diff.max()),
           "mean_logprob": float(want.mean())}
    emit(row)
    if not row["bit_equal"]:
        raise AssertionError(f"scanned perplexity: log-probs differ from per-token ones: {row}")
    return row


def phase_scan(cfg, model: str, runs, ppl_run: str | None = None,
               depth_runs: tuple = ()) -> list[dict]:
    """Decode without a host round trip per token (``runtime/graphs.py``):
    for each run (label, params, Engine options, decode path), at full
    width and depth, ``Engine.generate`` of a 512-token prompt and
    SCAN_TOKENS greedy tokens at segment 1 (eager steps, a host read a
    token) and at segment SCAN_SEGMENT (CUDA-graph replays, a read a
    segment), each after a warm-up generate of its own (the segment run's
    warm-up step and capture); the tokens must be identical and the launch
    counts of the two runs equal (a replay counts what the eager step
    launches). One ``scan`` line a run: wall ms a token at both segments,
    device busy ms a token and idle share of a profiled segment, the
    capture's seconds, the replays, the launches a replay makes, and the
    card's name and power limit. ``ppl_run`` names the run whose scanned
    perplexity is held bit for bit to per-token steps
    (``_scan_ppl_bit_equal``), ``depth_runs`` those whose one-step graph is
    timed against a graph of a whole segment (``_graph_depth``)."""
    import numpy as np
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(SEED).integers(3, cfg.vocab_size, size=512).tolist()
    smi = _smi_line()
    rows = []
    for label, params, kw, path in runs:
        eng = Engine(cfg, params, **kw)
        if eng.decode_path(1) != path:
            raise AssertionError(f"scan {label}: decode path {eng.decode_path(1)!r}, "
                                 f"expected {path!r}")
        for seg in (1, SCAN_SEGMENT):
            eng.generate(prompt[:32], 2, stop_on_eos=False, segment=seg)
        torch.cuda.synchronize()
        _, graph = eng._scan(eng.fresh_cache(1), "greedy")
        if graph.graph is None:
            raise AssertionError(f"scan {label}: no graph captured by the warm-up")
        runs_by_seg = {}
        for seg in (1, SCAN_SEGMENT):
            build.reset_launches()
            replays = graph.replays
            out, stats = eng.generate(prompt, SCAN_TOKENS, stop_on_eos=False, segment=seg)
            torch.cuda.synchronize()
            runs_by_seg[seg] = {"tokens": out,
                                "ms": stats.decode_s / stats.generated_tokens * 1e3,
                                "launches": {k: n for k, n in build.LAUNCHES.items() if n},
                                "replays": graph.replays - replays}
        one, seg_run = runs_by_seg[1], runs_by_seg[SCAN_SEGMENT]
        prof = _scan_profile(eng, prompt)
        busy = prof["device_busy_ms"]
        row = {"phase": "scan", "run": label, "model": model, "layers": cfg.n_layers,
               "decode_path": path, "kv_dtype": str(eng.kv_dtype).split(".")[-1],
               "generated_tokens": SCAN_TOKENS, "segment": SCAN_SEGMENT,
               "wall_ms_per_token_segment_1": one["ms"],
               f"wall_ms_per_token_segment_{SCAN_SEGMENT}": seg_run["ms"],
               "device_busy_ms_per_token": (busy / prof["steps"] if isinstance(busy, float)
                                            else busy),
               "device_idle_share": prof["device_idle_share"],
               "profile_wall_ms_per_token": prof["wall_ms"] / prof["steps"],
               "device_ms_by_kernel": prof["device_ms"], "profile_attempts": prof["attempts"],
               "capture_s": graph.capture_s, "graph_replays": seg_run["replays"],
               "launches_per_replay": graph.launches,
               "tokens_identical": one["tokens"] == seg_run["tokens"],
               "launches_equal": one["launches"] == seg_run["launches"],
               "tokens_head": seg_run["tokens"][:8], "card": smi}
        emit(row)
        if not row["tokens_identical"]:
            raise AssertionError(f"scan {label}: segment {SCAN_SEGMENT} tokens differ from "
                                 f"segment 1: {seg_run['tokens']} vs {one['tokens']}")
        if not row["launches_equal"] or seg_run["replays"] != SCAN_TOKENS - 1:
            raise AssertionError(f"scan {label}: launches {seg_run['launches']} against segment "
                                 f"1's {one['launches']}, {seg_run['replays']} replays")
        if label in depth_runs:
            depth = _graph_depth(eng, prompt)
            emit({"phase": "scan_graph_depth", "run": label, **depth, "card": smi})
        if label == ppl_run:
            row["perplexity"] = _scan_ppl_bit_equal(eng, prompt)
        rows.append(row)
        del eng, graph
        torch.cuda.empty_cache()
    return rows


SPEC_K = 7  # drafts a verify chunk (the JAX harness suggests 7): M = 8 rows
SPEC_TOKENS = 96  # tokens a spec run generates
SPEC_REC = 128  # the copy prompt's recurrence before its first two tokens again
SPEC_WRAP_WINDOW = 256  # the wrapped run's window (phase_wrap's)
SPEC_WRAP_TOKENS = 320  # from a 130-token prompt: 194 of them past the wrap at 256
REPLAY_ITERS = 20


def copy_prompt(perm_inv, seed: int, rec: int = SPEC_REC) -> list[int]:
    """The copy model's recurrence (``copy_params``) from two random tokens,
    ``rec`` tokens long, then its first two tokens again: the continuation
    is the recurrence once more, which appears earlier in the context, so
    n-gram drafts find it."""
    import numpy as np

    a, b = (int(t) for t in np.random.default_rng(seed).integers(3, len(perm_inv), size=2))
    seq = [a, b]
    while len(seq) < rec:
        seq.append(perm_inv[seq[-2]])
    return seq + [a, b]


def recurrence(prompt, perm_inv, n: int) -> list[int]:
    """The n tokens the copy model must give after ``prompt``."""
    seq = list(prompt)
    for _ in range(n):
        seq.append(perm_inv[seq[-2]])
    return seq[len(prompt):]


def _replay_ms(graph, iters: int = REPLAY_ITERS) -> float:
    """Device ms of one replay of a captured StepGraph: CUDA events over
    ``iters`` replays after one more."""
    import torch

    graph.graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _spec_run(label: str, eng, prompt, n: int, want, draft=None, wrapped: bool = False) -> dict:
    """One spec run (``phase_spec``): ``Engine.generate`` (segment 16, graph
    replays) and ``generate_spec`` (k = SPEC_K) of ``n`` tokens, each run
    once to capture its graphs and then timed, every launch counter set to
    0 just before each timed run and read just after. ``want``: the copy
    model's recurrence, which both runs must give (None for random
    weights: their tokens are recorded, not required). Then one verify
    chunk's device ms (CUDA events over graph replays) against one plain
    step's, the verify graph's capture seconds, and, wrapped, the eager
    commit's ms."""
    import numpy as np
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime import spec
    from xalm_tpu_torch.runtime.cache import ring_indices

    def timed(fn):
        fn()  # the graphs' warm-up and capture
        torch.cuda.synchronize()
        build.reset_launches()
        out, stats = fn()
        torch.cuda.synchronize()
        return out, stats, {k: v for k, v in build.LAUNCHES.items() if v}

    plain, pstats, plain_launches = timed(
        lambda: eng.generate(prompt, n, stop_on_eos=False, segment=SCAN_SEGMENT))
    out, sstats, spec_launches = timed(
        lambda: spec.generate_spec(eng, prompt, n, k=SPEC_K, stop_on_eos=False,
                                   segment=SCAN_SEGMENT, draft_engine=draft))
    cache = eng.fresh_cache(1)  # the planes generate's and generate_spec's graphs are bound to
    _, scan_graph = eng._scan(cache, "greedy")
    verify = {}
    for kind in ("blind", "wrapped") if wrapped else ("blind",):
        st, graph = eng._verifier(cache, SPEC_K, kind == "wrapped")
        if graph.graph is None:
            raise AssertionError(f"spec {label}: no {kind} verify chunk was captured")
        verify[kind] = {"device_ms": _replay_ms(graph), "capture_s": graph.capture_s,
                        "launches_per_replay": graph.launches}
    row = {"phase": "spec", "run": label, "layers": eng.cfg.n_layers,
           "window": eng.cfg.max_seq_len, "kv_dtype": str(eng.kv_dtype).split(".")[-1],
           "decode_path": eng.decode_path(1), "k": SPEC_K, "prompt_tokens": len(prompt),
           "generated_tokens": len(out), "draft": "n-gram" if draft is None else
           f"draft engine, {draft.cfg.n_layers} layers",
           "spec_tok_s": sstats.tok_per_s, "generate_tok_s": pstats.tok_per_s,
           "speedup": sstats.tok_per_s / pstats.tok_per_s,
           "spec_proposed": sstats.spec_proposed, "spec_accepted": sstats.spec_accepted,
           "acceptance": sstats.spec_accepted / max(sstats.spec_proposed, 1),
           "verify_chunk_device_ms": verify["blind"]["device_ms"],
           "plain_step_device_ms": _replay_ms(scan_graph),
           "verify_capture_s": verify["blind"]["capture_s"],
           "verify_launches_per_chunk": verify["blind"]["launches_per_replay"],
           "plain_launches": plain_launches, "spec_launches": spec_launches,
           "tokens_equal_generate": out == plain,
           "equal_prefix": next((i for i, (a, b) in enumerate(zip(out, plain)) if a != b),
                                min(len(out), len(plain))),
           "card": _smi_line()}
    if wrapped:
        row.update(wrapped_verify_device_ms=verify["wrapped"]["device_ms"],
                   wrapped_verify_capture_s=verify["wrapped"]["capture_s"])
        st, _ = eng._verifier(cache, SPEC_K, True)
        pos = eng.cfg.max_seq_len + 40
        _, kvp, _ = ring_indices(pos + torch.arange(SPEC_K + 1)[None], eng.cfg.max_seq_len)
        kvp = kvp.numpy()
        spec.spec_commit(eng, cache, st.rows, kvp, SPEC_K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPLAY_ITERS):
            spec.spec_commit(eng, cache, st.rows, kvp, SPEC_K)
        torch.cuda.synchronize()
        row["commit_ms"] = (time.perf_counter() - t0) * 1e3 / REPLAY_ITERS
    if want is not None:
        row["tokens_equal_recurrence"] = out == want
    emit(row)
    if want is not None and not (out == plain == want):
        raise AssertionError(f"spec {label}: tokens differ from generate's or the recurrence: "
                             f"{row}")
    if len(out) != n or not np.all(np.isfinite([row["spec_tok_s"], row["generate_tok_s"]])):
        raise AssertionError(f"spec {label}: {len(out)} tokens, expected {n}")
    for kernel in ("qmatmul",) + (("flash_prefill",) if eng.kv_dtype == torch.bfloat16 else ()):
        if not spec_launches.get(kernel):
            raise AssertionError(f"spec {label}: {kernel} never launched by generate_spec")
    return row


def phase_spec(params, cfg) -> list[dict]:
    """Speculative decoding (``runtime/spec.py``) at full width and depth:
    the copy model (``copy_params``, whose greedy tokens follow its
    recurrence by a 200-nat margin, so every run's tokens must equal plain
    ``generate``'s exactly) on the prompt of ``copy_prompt``, where the
    n-gram drafts are the continuation: n-gram drafts over a bf16 cache
    (the megakernel between chunks) and an int8 cache; the copy model's
    first 2 layers as ``draft_engine``; the wrapped regime (verify, then
    commit) at a 256-slot window, drafted by the 2-layer copy (past the
    prompt's recurrence no n-gram matches); and ``params`` (random weights)
    on the same prompt, whose drafts are mostly rejected, the worst case
    (their tokens recorded beside generate's, not required: the verify
    chunk's arithmetic is not the megakernel's). A ``spec`` line a run
    (``_spec_run``)."""
    import torch

    from xalm_tpu_torch.runtime.engine import Engine

    copy, perm_inv = copy_params(cfg, SEED + 3)
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    draft_params, _ = copy_params(cfg2, SEED + 3)  # the same codes and permutation
    prompt = copy_prompt(perm_inv, SEED + 4)
    want = recurrence(prompt, perm_inv, SPEC_TOKENS)
    cfg_wrap = dataclasses.replace(cfg, max_seq_len=SPEC_WRAP_WINDOW)
    runs = [("copy bf16", lambda: Engine(cfg, copy), want, False, False),
            ("copy int8", lambda: Engine(cfg, copy, kv_dtype=torch.int8), want, False, False),
            ("copy bf16, 2-layer draft engine", lambda: Engine(cfg, copy), want, True, False),
            ("copy bf16 wrapped, 256 slots, 2-layer draft engine", lambda: Engine(cfg_wrap, copy),
             recurrence(prompt, perm_inv, SPEC_WRAP_TOKENS), True, True),
            ("random bf16", lambda: Engine(cfg, params), None, False, False)]
    rows = []
    for label, make, target, drafted, wrapped in runs:
        n = len(target) if target is not None else SPEC_TOKENS
        eng = make()
        draft = Engine(cfg2, draft_params) if drafted else None
        rows.append(_spec_run(label, eng, prompt, n, target, draft, wrapped))
        del eng, draft
        torch.cuda.empty_cache()
    del copy, draft_params
    torch.cuda.empty_cache()
    return rows


SESSION_TOKENS, SESSION_CUT = 64, 24


def phase_session(cfg) -> list[dict]:
    """Sessions (``runtime/session.py``) at full width and depth, window
    4096: the copy model's ``SESSION_TOKENS``-token generation (segment 16)
    cut after ``SESSION_CUT`` tokens (``return_session``), the session saved
    (``save_session``: no content hashes; the bf16 one also with them,
    through ``write_blocks``) into
    build/, loaded back onto the card and resumed, with a bf16 and an int8
    cache: the resumed tokens must equal the uninterrupted run's and the
    recurrence, and the resumed run's launches (counted from 0) must hold
    the megakernel. A ``session`` line each: save and load seconds (the
    load reads a file just written: the page cache is warm), the file's MB."""
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.io.blockstore import write_blocks
    from xalm_tpu_torch.runtime.session import load_session, save_session, session_blocks

    copy, perm_inv = copy_params(cfg, SEED + 3)
    prompt = copy_prompt(perm_inv, SEED + 5)
    want = recurrence(prompt, perm_inv, SESSION_TOKENS)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for kv in (torch.bfloat16, torch.int8):
        eng = Engine(cfg, copy, kv_dtype=kv)
        full, _ = eng.generate(prompt, SESSION_TOKENS, stop_on_eos=False)
        first, _, sess = eng.generate(prompt, SESSION_CUT, stop_on_eos=False,
                                      return_session=True)
        path = os.path.join(out_dir, f"session_{str(kv).split('.')[-1]}.xbk")
        t0 = time.perf_counter()
        save_session(path, cfg, sess)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_session(path, cfg, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        build.reset_launches()
        rest, _ = eng.generate([], SESSION_TOKENS - SESSION_CUT, stop_on_eos=False, resume=loaded)
        torch.cuda.synchronize()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        row = {"phase": "session", "kv_dtype": str(kv).split(".")[-1], "layers": cfg.n_layers,
               "window": cfg.max_seq_len, "cache_mb": sess.cache.nbytes() / 1e6,
               "file_mb": os.path.getsize(path) / 1e6, "save_s": save_s, "load_s": load_s,
               "cut_after": SESSION_CUT, "tokens": SESSION_TOKENS, "resumed_launches": launches,
               "resumed_equal_uninterrupted": first + rest == full,
               "uninterrupted_equal_recurrence": full == want, "card": _smi_line()}
        if kv == torch.bfloat16:  # what content hashes would cost (io/xxh3.py, on the host)
            t0 = time.perf_counter()
            write_blocks(path, *session_blocks(cfg, sess))
            row["save_with_hashes_s"] = time.perf_counter() - t0
        os.remove(path)
        emit(row)
        if not (row["resumed_equal_uninterrupted"] and row["uninterrupted_equal_recurrence"]):
            raise AssertionError(f"session ({kv}): the resumed run differs: {first + rest} vs "
                                 f"{full} (recurrence {want})")
        if not launches.get("fused_decode"):
            raise AssertionError(f"session ({kv}): the resumed run launched no megakernel")
        rows.append(row)
        del eng, sess, loaded
        torch.cuda.empty_cache()
    del copy
    torch.cuda.empty_cache()
    return rows


SERVE_BATCH, SERVE_SEGMENT = 8, 8  # the batcher's slots and decode steps a tick
SERVE_PREFIX = 64  # the shared prompt prefix
SERVE_GEN = 48  # tokens a correctness request generates (its prefix holder: 96)
SERVE_HOT = 50.0  # the copy model's temperature where its draws are random
# tools/serve_bench.py's traffic at its defaults, with a sampled and a
# logprobs share of a quarter and a 64-token shared prefix
SERVE_LOAD = dict(requests=24, prompt=128, gen=96, sampled=0.25, logprobs=0.25)
SERVE_STEP_BATCHES = (1, 4, 8)
SERVE_STEP_POS = 256  # the batched step's positions
SERVE_HTTP_TOKENS = 32


def _serve_tokenizer(vocab: int):
    """A tokenizer of ``vocab`` entries for the serving phase's models:
    <unk>, <s>, </s>, the 256 byte tokens, then the words " w0", " w1", ..."""
    import numpy as np

    from xalm_tpu_torch.tokenizer import Tokenizer

    words = [b"<unk>", b"<s>", b"</s>"] + [b"<0x%02X>" % i for i in range(256)]
    words += [b" w%d" % i for i in range(vocab - len(words))]
    return Tokenizer(np.frombuffer(b"\x00".join(words) + b"\x00", np.uint8), "1", "2")


def serve_traffic(vocab: int, requests: int, prompt: int, gen: int, sampled: float,
                  logprobs: float, shared_prefix: int = SERVE_PREFIX, seed: int = 0) -> list:
    """``tools/serve_bench.py``'s requests, drawn in its order from its seed:
    a shared prefix, then prompts uniform in [prompt / 2, 2 * prompt), each
    ``gen`` new tokens without EOS stops, a ``sampled`` share at temperature
    0.8 and top-p 0.95 (seed = the request's index) and a ``logprobs``
    share collecting 3."""
    import numpy as np

    from xalm_tpu_torch.serve.batching import Request

    rng = np.random.default_rng(seed)
    shared = rng.integers(3, vocab - 2, size=shared_prefix).tolist()
    reqs = []
    for i in range(requests):
        plen = int(rng.integers(prompt // 2, prompt * 2))
        ids = shared + rng.integers(3, vocab - 2, size=plen).tolist()
        hot = rng.random() < sampled
        reqs.append(Request(prompt_ids=ids, max_new_tokens=gen, stop_on_eos=False,
                            temperature=0.8 if hot else 0.0, top_p=0.95 if hot else 1.0, seed=i,
                            logprobs=3 if rng.random() < logprobs else 0))
    return reqs


def _serve_segment_check(b) -> dict:
    """From a batcher's state (some slots decoding, the others masked): one
    segment of the greedy masked scan's replays and one of the per-row
    sampled scan's (log-probs on) against the same steps run eagerly
    (``Engine.step`` and the samplers) on a copy of the cache: the tokens,
    log-probs, top-5 and keys bit for bit, and the window's rows of every
    plane (row S of the padding takes the masked rows' dropped writes).
    Both write the same rows, so the batcher goes on from either."""
    import numpy as np
    import torch

    from xalm_tpu_torch import prng
    from xalm_tpu_torch.sampler import sample_rows, split_rows

    eng, dev, n = b.engine, b.engine.device, b.segment
    state = b.slot_state()
    mask = state["decoding"]
    window = eng.cfg.max_seq_len
    out = {"rows_decoding": int(mask.sum())}
    for kind in ("greedy", "sampled"):
        ref = b.cache.clone()
        tok, pos = state["token"], state["pos"]
        keys = prng.from_numpy(state["keys"]).to(dev)
        temps, tps = (torch.from_numpy(state[k]).to(dev) for k in ("temps", "top_ps"))
        wkeys, wtok, wlp = keys.clone(), [], []
        with torch.inference_mode():
            for _ in range(n):
                o, _ = eng.step(tok[:, None], pos, ref, mask[:, None],
                                logits_mode="token" if kind == "greedy" else "last")
                if kind == "sampled":
                    subs, carry = split_rows(wkeys)
                    wkeys = torch.where(torch.from_numpy(mask).to(dev)[:, None], carry, wkeys)
                    o, lp, tv, ti = sample_rows(o, subs, temps, tps, return_logprobs=True)
                    wlp.append((lp, tv, ti))
                tok = o.cpu().numpy().astype(np.int32)
                wtok.append(tok)
                pos = pos + 1
        if kind == "greedy":
            got, _ = eng.decode_scan(state["token"], state["pos"], b.cache, n, valid=mask)
            same = True
        else:
            got, lps, tv, ti, gkeys = eng.sample_scan_rows(
                state["token"], state["pos"], b.cache, keys, temps, tps, n, valid=mask,
                want_lp=True)
            same = torch.equal(gkeys, wkeys) and all(
                torch.equal(lps[:, j], a) and torch.equal(tv[:, j], c) and torch.equal(ti[:, j], d)
                for j, (a, c, d) in enumerate(wlp))
        same = same and np.array_equal(got.cpu().numpy()[mask], np.stack(wtok, 1)[mask])
        planes = all((a[..., :window, :] if a.dim() == 5 else a[..., :window]).equal(
            c[..., :window, :] if c.dim() == 5 else c[..., :window])
            for a, c in zip(b.cache.planes(), ref.planes()))
        out[f"{kind}_replays_equal_eager"] = bool(same and planes)
        del ref
    return out


def _serve_correctness(cfg, copy, tok) -> tuple:
    """The copy model (``copy_params``: its greedy tokens exact) behind a
    batcher of SERVE_BATCH slots at segment SERVE_SEGMENT: 12 requests of
    40-300 prompt tokens (greedy, seeded at temperature 0.8 and top-p 0.95,
    and greedy collecting 3 log-probs), four of them on one 64-token prefix
    (its holder admitted first and decoding 96 tokens, the other three
    admitted as slots free up, so they copy its lane), each greedy request
    equal to its solo ``generate``; the graph-against-eager check of one
    segment of each scan mid-run (``_serve_segment_check``); and a seeded
    request at temperature SERVE_HOT (where the copy model's draws are
    random) alone and beside seven others with prompts of the same chunk
    bucket: the same tokens. Returns (engine, row)."""
    import numpy as np
    import torch

    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.serve.batching import ContinuousBatcher, Request

    eng = Engine(cfg, copy, tok)
    if eng.decode_path(SERVE_BATCH) != "megakernel":
        raise AssertionError(f"serve: decode path {eng.decode_path(SERVE_BATCH)!r} at B = 8")
    b = ContinuousBatcher(eng, max_batch=SERVE_BATCH, segment=SERVE_SEGMENT)
    warm_s = b.warmup()
    rng = np.random.default_rng(SEED + 22)
    vocab = cfg.vocab_size
    shared = rng.integers(3, vocab, size=SERVE_PREFIX).tolist()
    reqs = []
    for i in range(12):
        plen = int(rng.integers(40, 301))
        head = shared if i in (0, 8, 9, 10) else []
        ids = head + rng.integers(3, vocab, size=max(plen - len(head), 2)).tolist()
        kind = i % 3
        reqs.append(Request(prompt_ids=ids, max_new_tokens=96 if i == 0 else SERVE_GEN,
                            stop_on_eos=False, temperature=0.8 if kind == 1 else 0.0,
                            top_p=0.95 if kind == 1 else 1.0, seed=1000 + i,
                            logprobs=3 if kind == 2 else 0))
    for r in reqs[:8]:
        b.submit(r)
    b.step()
    for r in reqs[8:]:
        b.submit(r)
    check = None
    while b.step():
        if check is None and len(b.decoding_slots()) >= 4:
            check = _serve_segment_check(b)
    torch.cuda.synchronize()
    greedy = [r for r in reqs if r.temperature == 0]
    solo_equal = [r.out_tokens == eng.generate(r.prompt_ids, r.max_new_tokens,
                                               stop_on_eos=False)[0] for r in greedy]
    lp_ok = all(len(r.out_logprobs) == len(r.out_tokens) and
                all(alts[0][0] == t for t, alts in zip(r.out_tokens, r.out_top_logprobs))
                for r in reqs if r.logprobs)

    def hot(others: int) -> list[int]:
        prompts = np.random.default_rng(SEED + 23).integers(3, vocab, size=(8, 200)).tolist()
        first = Request(prompt_ids=prompts[0], max_new_tokens=SERVE_GEN, stop_on_eos=False,
                        temperature=SERVE_HOT, seed=77)
        b.submit(first)
        for p in prompts[1:1 + others]:
            b.submit(Request(prompt_ids=p[:150], max_new_tokens=SERVE_GEN, stop_on_eos=False))
        b.run()
        return first.out_tokens

    alone, cobatched = hot(0), hot(7)
    row = {"phase": "serve_check", "model": "Mistral-7B copy", "layers": cfg.n_layers,
           "max_batch": SERVE_BATCH, "segment": SERVE_SEGMENT, "warmup_s": warm_s,
           "requests": len(reqs), "greedy_equal_solo": f"{sum(solo_equal)}/{len(solo_equal)}",
           "logprobs_ok": lp_ok, "prefix_hits": b.prefix_hits,
           "prefix_tokens_saved": b.prefix_tokens_saved,
           "sampled_alone_equal_cobatched": alone == cobatched,
           "sampled_distinct_tokens": len(set(alone)), **(check or {}), "card": _smi_line()}
    emit(row)
    bad = [k for k, v in row.items() if v is False]
    if (bad or not all(solo_equal) or b.prefix_hits < 3 or check is None
            or len(set(alone)) < SERVE_GEN // 2):
        raise AssertionError(f"serve: correctness failed: {row}")
    del b
    torch.cuda.empty_cache()
    return eng, row


def _serve_load(cfg, params, kv, label: str, requests: int) -> dict:
    """``serve_traffic`` (``SERVE_LOAD``, ``requests`` of them) through a
    batcher of SERVE_BATCH slots at segment SERVE_SEGMENT on random weights,
    after ``warmup``; every launch counter set to 0 just before the run and
    read just after. A ``serve`` line: generated and processed tok/s (host
    clock, the run ended by a synchronise), the latencies' p50 and p95
    (``latency_stats``), warmup seconds, prefix hits, decode steps, the
    tick's mean host ms by span and device ms (``tick_stats``)."""
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.serve.batching import ContinuousBatcher

    eng = Engine(cfg, params, kv_dtype=kv)
    b = ContinuousBatcher(eng, max_batch=SERVE_BATCH, segment=SERVE_SEGMENT, device_times=True)
    warm_s = b.warmup()
    reqs = serve_traffic(cfg.vocab_size, **dict(SERVE_LOAD, requests=requests))
    torch.cuda.synchronize()
    build.reset_launches()
    for r in reqs:
        b.submit(r)
    t0 = time.perf_counter()
    b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    gen = sum(len(r.out_tokens) for r in reqs)
    prompt = sum(len(r.prompt_ids) for r in reqs)
    row = {"phase": "serve", "run": label, "layers": cfg.n_layers,
           "kv_dtype": str(kv).split(".")[-1], "decode_path": eng.decode_path(SERVE_BATCH),
           "max_batch": SERVE_BATCH, "segment": SERVE_SEGMENT, "requests": requests,
           "prompt_tokens": prompt, "generated_tokens": gen, "wall_s": wall,
           "generated_tok_s": gen / wall, "processed_tok_s": (prompt + gen) / wall,
           **b.latency_stats(), "warmup_s": warm_s, "prefix_hits": b.prefix_hits,
           "prefix_tokens_saved": b.prefix_tokens_saved, "decode_steps": b.decode_steps,
           "tick": b.tick_stats(), "launches": {k: v for k, v in launches.items() if v},
           "card": _smi_line()}
    emit(row)
    want = ("qmatmul", "fused_decode") + (("flash_prefill",) if kv == torch.bfloat16 else ())
    if gen != requests * SERVE_LOAD["gen"] or any(not launches.get(k) for k in want):
        raise AssertionError(f"serve {label}: {gen} tokens, launches {launches}")
    del b, eng
    torch.cuda.empty_cache()
    return launches


# the B = 8 step's parity case: each slot's position, and which slots are
# masked (a prefilling slot, a free one at 0): rows at their own lengths,
# one wrapped (its sinks re-rotated), one at the window's last slot
SERVE_PARITY_POS = (519, 1200, 300, 4096 + 5, 40, 2000, 4095, 0)
SERVE_PARITY_VALID = (True, True, False, True, True, False, True, False)


def _serve_step_parity(cfg, eng, plain) -> dict:
    """The B = 8 step as a serving batch gives it (``Engine.step``, one
    token a slot at SERVE_PARITY_POS, the SERVE_PARITY_VALID mask: masked
    rows write the kv_pos == S sentinel) on the megakernel and on its plain
    version (``matmul_impl="plain"``), the same random bf16 planes: every
    row's logits (the finishing probe reads masked rows' logits too) and
    the window's cache rows within phase 3's FUSED_TOL of each row's max and
    their values within a bf16 ulp at FUSED_ULP_SHARE (phase 3's rules; the
    share over the written rows alone is recorded beside), the argmax equal
    where the top two lie apart, and the masked rows' window unchanged. Raises on a mismatch; returns the record's fields and the
    plain step's ms (events over 3 steps)."""
    import numpy as np
    import torch

    from xalm_tpu_torch.runtime.cache import ring_indices

    b, S, hd = len(SERVE_PARITY_POS), cfg.max_seq_len, cfg.head_dim
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 25)
    cache = eng.new_cache(b)
    for t in cache.planes():
        t.copy_(torch.randn(t.shape, generator=gen, device=DEVICE, dtype=t.dtype))
    toks = np.random.default_rng(SEED + 25).integers(3, cfg.vocab_size, size=(b, 1)).astype(np.int32)
    pos = np.array(SERVE_PARITY_POS, np.int32)
    valid = np.array(SERVE_PARITY_VALID)[:, None]
    kern, ref = cache.clone(), cache.clone()
    got, _ = eng.step(toks, pos, kern, valid, logits_mode="last")
    want, _ = plain.step(toks, pos, ref, valid, logits_mode="last")
    plain_ms = time_ms(lambda: plain.step(toks, pos, cache.clone(), valid, logits_mode="last"),
                       iters=3, warmup=1)
    torch.cuda.synchronize()
    v = want.shape[-1]
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * FUSED_TOL * want.abs().amax(dim=-1)
    _, kv_pos, _ = ring_indices(torch.from_numpy(pos), S)
    rows = [(i, int(kv_pos[i])) for i in range(b) if SERVE_PARITY_VALID[i]]
    written = [torch.stack([c[:, i, :, r] for i, r in rows]) for c in (kern.k, kern.v, ref.k, ref.v)]
    masked = [i for i in range(b) if not SERVE_PARITY_VALID[i]]
    out = {"positions": list(SERVE_PARITY_POS), "valid": list(SERVE_PARITY_VALID),
           "logits_row_rel": _row_rel(got, want, v),
           "cache_k_row_rel": _row_rel(kern.k[..., :S, :], ref.k[..., :S, :], hd),
           "cache_v_row_rel": _row_rel(kern.v[..., :S, :], ref.v[..., :S, :], hd),
           "cache_ulp_share": min(_ulp_share(kern.k[..., :S, :], ref.k[..., :S, :]),
                                  _ulp_share(kern.v[..., :S, :], ref.v[..., :S, :])),
           "written_ulp_share": min(_ulp_share(written[0], written[2]),
                                    _ulp_share(written[1], written[3])),
           "token_equal": bool(torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear])),
           "masked_rows_unchanged": all(
               torch.equal(a[:, i, :, :S], c[:, i, :, :S])
               for a, c in ((kern.k, cache.k), (kern.v, cache.v)) for i in masked),
           "tol_row_rel": FUSED_TOL}
    ok = (bool(torch.isfinite(got).all()) and out["logits_row_rel"] <= FUSED_TOL
          and out["cache_k_row_rel"] <= FUSED_TOL and out["cache_v_row_rel"] <= FUSED_TOL
          and out["cache_ulp_share"] >= FUSED_ULP_SHARE and out["token_equal"]
          and out["masked_rows_unchanged"])
    out["ok"] = ok
    del cache, kern, ref, written
    if not ok:
        raise AssertionError(f"serve step: the B = 8 megakernel disagrees with its plain version: "
                             f"{out}")
    return {"b8_parity": out, "plain_ms_b8": plain_ms}


def _serve_steps(cfg, params) -> dict:
    """The greedy decode step at B = 1, 4 and 8 (the megakernel, every row
    valid, positions SERVE_STEP_POS): device ms a step of the masked scan
    (CUDA events over a warm ``decode_scan`` of 20 replays, its state's
    loads included), against the bound of ``Engine.active_bytes`` at B
    rows over 3.35 TB/s (the weights once, each row's cache rows), and the
    launches a step; then the B = 8 step against its plain version
    (``_serve_step_parity``)."""
    import numpy as np
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine

    eng = Engine(cfg, params)
    row = {"phase": "serve_step", "layers": cfg.n_layers, "decode_path": {}, "device_ms": {},
           "bound_ms": {}, "launches_per_step": {}}
    n = REPLAY_ITERS
    for bsz in SERVE_STEP_BATCHES:
        cache = eng.new_cache(bsz)
        toks = np.arange(3, 3 + bsz, dtype=np.int32)
        pos = np.full(bsz, SERVE_STEP_POS, np.int32)
        valid = np.ones(bsz, bool)
        eng.decode_scan(toks, pos, cache, 2, valid=valid)  # the capture
        torch.cuda.synchronize()
        build.reset_launches()
        ms = time_ms(lambda: eng.decode_scan(toks, pos, cache, n, valid=valid), iters=1,
                     warmup=0) / n
        row["launches_per_step"][bsz] = {k: c / n for k, c in build.LAUNCHES.items() if c}
        row["decode_path"][bsz] = eng.decode_path(bsz)
        row["device_ms"][bsz] = ms
        row["bound_ms"][bsz] = eng.active_bytes(SERVE_STEP_POS, tokens=bsz) / HBM_BYTES_PER_S * 1e3
        del cache
    torch.cuda.empty_cache()
    row.update(_serve_step_parity(cfg, eng, Engine(cfg, params, matmul_impl="plain")))
    row["card"] = _smi_line()
    emit(row)
    del eng
    torch.cuda.empty_cache()
    return row


def _serve_http(eng) -> dict:
    """``serve()`` over the copy-model engine on 127.0.0.1, port 0: four
    concurrent ``/v1/completions`` requests, two of them streamed, each
    text equal to the engine's greedy continuation (``generate``, computed
    before the server starts, whose scheduler thread then owns the engine);
    time to the first streamed piece and to each whole answer (host clock).
    Shuts the server down."""
    import threading
    import urllib.request

    import numpy as np

    from xalm_tpu_torch.serve.server import serve

    tok = eng.tokenizer
    rng = np.random.default_rng(SEED + 24)
    prompts = [tok.decode(rng.integers(259, eng.cfg.vocab_size, size=n).tolist())
               for n in (60, 90, 120, 75)]
    wants = []
    for p in prompts:
        out, _ = eng.generate(tok.encode(p), SERVE_HTTP_TOKENS)
        wants.append(tok.decode(out[:-1] if out and tok.is_stop(out[-1]) else out))
    xs, httpd = serve(eng, "127.0.0.1", 0, max_batch=SERVE_BATCH, model_name="copy")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/v1/completions"
    got, ttft, total, errors = {}, {}, {}, []

    def go(i: int) -> None:
        stream = i % 2 == 1
        body = json.dumps({"prompt": prompts[i], "max_tokens": SERVE_HTTP_TOKENS,
                           "stream": stream}).encode()
        req = urllib.request.Request(base, data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                if not stream:
                    got[i] = json.loads(r.read())["choices"][0]["text"]
                    ttft[i] = total[i] = time.perf_counter() - t0
                    return
                text = ""
                for line in r:
                    line = line.decode().strip()
                    if not line.startswith("data: ") or line == "data: [DONE]":
                        continue
                    piece = json.loads(line[6:])["choices"][0].get("text", "")
                    if piece and i not in ttft:
                        ttft[i] = time.perf_counter() - t0
                    text += piece
                got[i] = text
                total[i] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001  (recorded and raised below)
            errors.append(repr(e))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    httpd.shutdown()
    httpd.server_close()
    xs.shutdown()
    equal = [got.get(i) == w for i, w in enumerate(wants)]
    row = {"phase": "serve_http", "requests": len(prompts), "streamed": len(prompts) // 2,
           "max_tokens": SERVE_HTTP_TOKENS, "texts_equal_generate": f"{sum(equal)}/{len(equal)}",
           "ttft_s": {("stream" if i % 2 else "json") + str(i): ttft.get(i) for i in range(4)},
           "total_s": {("stream" if i % 2 else "json") + str(i): total.get(i) for i in range(4)},
           "errors": errors, "card": _smi_line()}
    emit(row)
    if errors or not all(equal):
        raise AssertionError(f"serve http: {row}")
    return row


def phase_serve(params, cfg) -> dict:
    """Serving (``serve/batching.py``, ``serve/server.py``) at full Mistral-7B
    width and depth, i8 body, bf16 cache, SERVE_BATCH slots, segment
    SERVE_SEGMENT: the copy model's correctness run (``_serve_correctness``),
    the load of ``tools/serve_bench.py``'s traffic on random weights with a
    bf16 cache (24 requests) and an int8 one (8) (``_serve_load``), the
    batched step at B = 1, 4, 8 (``_serve_steps``) and the HTTP server over
    the copy model (``_serve_http``). Returns the launches of the load runs,
    every counter set to 0 just before each and read just after."""
    import torch

    copy, _ = copy_params(cfg, SEED + 21)
    eng, _ = _serve_correctness(cfg, copy, _serve_tokenizer(cfg.vocab_size))
    _serve_http(eng)
    del eng, copy
    torch.cuda.empty_cache()
    launches = _serve_load(cfg, params, torch.bfloat16, "bf16 megakernel", SERVE_LOAD["requests"])
    more = _serve_load(cfg, params, torch.int8, "int8 megakernel", 8)
    _serve_steps(cfg, params)
    return {k: launches.get(k, 0) + more.get(k, 0) for k in set(launches) | set(more)}


# kernel-name fragments of the port's CUDA kernels, by wrapper (no fragment
# names a part of another kernel's name)
_PROFILE_GROUPS = {
    "qmatmul": ("gemv_stream_kernel", "gemv_kernel", "gemm_bf16w_kernel", "prep_x_kernel",
                "gemm_tf32x3_kernel", "prep_x_tf32_kernel"),
    "qmatmul_q4": ("gemv_q4_stream_kernel",),
    "qmatmul_a8": ("gemm_a8_kernel",),
    "quant_x": ("quant_x_kernel",),  # x's codes for qmatmul_a8
    "qmatmul_multi": ("multi_stream_kernel", "qmatmul_multi_kernel"),
    "qmatmul_multi_q4": ("multi_q4_stream_kernel",),
    "kv_update": ("kv_update_kernel",),
    "flash_decode": ("flash_decode_cluster_kernel",),
    "flash_prefill": ("flash_prefill_kernel", "flash_prefill_tf32x3_kernel"),
    "fused_decode": ("fused_decode_kernel",),
    "kv_update_q": ("kv_update_q_kernel",),
    "flash_decode_q": ("flash_decode_q_cluster_kernel",),
}


# kernel-name fragments that a profile window must hold once for each launch
# of these wrappers (build.LAUNCHES): the witnesses that it kept every kernel
# record. A profile session can lose the first kernel records it sees (on
# the H100 the first megakernel record of back-to-back sessions, 3 or 4 of
# 8 late in a long run of this script); a session that first runs
# PROFILE_PRIMES tiny spin kernels (left out of every sum) and idles
# PROFILE_PAD_S kept all of them. A window that still falls short runs again.
# A key is one fragment or a tuple of them, a record of any counting.
_WITNESSES = {
    "fused_decode_kernel": ("fused_decode", "fused_decode_a8", "fused_decode_q4"),
    "flash_decode_cluster_kernel": ("flash_decode", "flash_decode_f32"),
    "flash_decode_q_cluster_kernel": ("flash_decode_q",),
    "flash_prefill_kernel": ("flash_prefill",),
    "flash_prefill_tf32x3_kernel": ("flash_prefill_f32",),
    "kv_update_kernel": ("kv_update", "kv_update_f32"),
    "kv_update_q_kernel": ("kv_update_q",),
    # kernel 8's int8 experts run either (the stream where one launch holds x's rows)
    ("multi_stream_kernel", "qmatmul_multi_kernel"): ("qmatmul_multi", "qmatmul_multi_f32",
                                                      "qmatmul_multi_fp8"),
    "multi_q4_stream_kernel": ("qmatmul_multi_q4",),
}
PROFILE_ATTEMPTS = 3
PROFILE_PAD_S = 0.05
PROFILE_PRIMES = 32
# the tiled GEMM of int8, fp8 and bf16 weights, and the kernel it replaced
# (which no profile may hold)
GEMM_FRAG, OLD_GEMM_FRAG = "gemm_bf16w_kernel", "::gemm_kernel<"
# the q4 GEMV and gathered q4 experts that the packed-q4 stream replaced
# (which no profile may hold either)
OLD_Q4_FRAGS = ("gemv_q4_kernel", "qmatmul_multi_q4_kernel")


def _device_times(prof) -> tuple[dict, list, dict, tuple[float, int]]:
    """Device time (ms) by kernel group, the ten largest device entries as
    (name, ms, count), the record count of each witness fragment, and the
    tiled GEMM's device ms and records, from a torch.profiler run (one pass
    over its entries: each pass costs seconds on a long trace). Only the
    kernels' own entries count: a PyTorch operator's entry carries the
    device time of the kernels it launched, which those kernels' entries
    carry too. Raises on a record of a kernel that the tiled GEMM or the
    packed-q4 stream replaced."""
    from torch.autograd import DeviceType

    groups = _PROFILE_GROUPS
    out = {k: 0.0 for k in groups}
    out["other"] = 0.0
    top = []
    records = dict.fromkeys(_WITNESSES, 0)
    gemm_ms, gemm_n = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        if "spin_kernel" in evt.key:  # the session's priming kernels
            continue
        if OLD_GEMM_FRAG in evt.key or any(f in evt.key for f in OLD_Q4_FRAGS):
            raise AssertionError(f"a profile holds {evt.key[:80]!r}: a replaced kernel ran")
        if GEMM_FRAG in evt.key:
            gemm_ms += _device_us(evt) / 1e3
            gemm_n += evt.count
        for frags in records:
            if any(f in evt.key for f in ((frags,) if isinstance(frags, str) else frags)):
                records[frags] += evt.count
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if not us:
            continue
        group = next((g for g, frags in groups.items()
                      if any(f in evt.key for f in frags)), "other")
        out[group] += us / 1e3
        top.append((evt.key[:80], us / 1e3, evt.count))
    return out, sorted(top, key=lambda r: -r[1])[:10], records, (gemm_ms, gemm_n)


def _profiled(window, steps: int, setup=None) -> dict:
    """torch.profiler over ``window()``: device time by kernel group, wall
    time, and the device's idle share. Each session is primed first (see
    ``_WITNESSES``); a window whose witness records fall short of the
    launches the counters saw in it is run again (``setup()`` before each
    run), up to PROFILE_ATTEMPTS times; if none is complete, its busy time
    and idle share are "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xalm_tpu_torch.ops import build

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        build.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PRIMES):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev, top, records, (gemm_ms, gemm_n) = _device_times(prof)
        launched = {f: sum(build.LAUNCHES[w] for w in ws) for f, ws in _WITNESSES.items()}
        if records == launched:
            break
    busy = sum(dev.values())
    measured = records == launched and busy > 0
    return {
        "steps": max(steps, 1), "wall_ms": wall_ms, "device_ms": dev, "top": top,
        "gemm_device_ms": gemm_ms if measured else "not measured", "gemm_records": gemm_n,
        "attempts": attempt, "records_complete": records == launched,
        "device_busy_ms": busy if measured else "not measured",
        "device_idle_share": (1.0 - busy / wall_ms) if measured else "not measured",
    }


def phase_profile(eng, prompt, token, label: str) -> dict:
    """``_profiled`` over one 512-token prefill and over 8 eager decode
    steps after it."""
    import numpy as np

    state = {}

    def fresh():
        state["cache"] = eng.new_cache(1)

    def prefill():
        _, state["cache"], state["pos"] = eng.prefill(prompt, state["cache"])

    def decode():
        for i in range(8):
            _, state["cache"] = eng.decode(np.array([token]), np.array([state["pos"] + i],
                                                                        np.int32), state["cache"])
        state["pos"] += 8

    rows = {"prefill_512": _profiled(prefill, 0, setup=fresh), "decode": _profiled(decode, 8)}
    emit({"phase": "profile", "run": label, **rows})
    return rows


WRAP_TOL = 1e-2  # teacher-forced |logits kernel - plain| / max |logits plain|


# the int8-activation bodies' step rules (see phase_wrap), over a run's
# decode steps that the int8 activations change (by more than EXACT_TOL):
# from the plain run's cache, at least QUANT_STEP_SHARE within their own
# quant effect and NEAR_STEP_SHARE within a quarter of it (or EXACT_TOL);
# on the kernel's own cache, OWN_STEP_SHARE within their own quant effect,
# and every cache row but the sinks' within OWN_CACHE_TOL of its max
QUANT_STEP_SHARE = 0.98
NEAR_STEP_SHARE = 0.5
OWN_STEP_SHARE = 0.75
OWN_CACHE_TOL = 0.1


def _step_rule(counts: dict, n: int, resync: bool) -> bool:
    if resync:
        return (counts["steps_within_quant"] >= QUANT_STEP_SHARE * n
                and counts["steps_near"] >= NEAR_STEP_SHARE * n)
    return counts["steps_within_quant"] >= OWN_STEP_SHARE * n


def _quant_stats(errs, errs0, errsc, steps: int, resync: bool) -> dict:
    """The step rule's counts of a run with int8 activations (see
    ``_teacher_forced``): errs, errs0 and errsc are the kernel's, the quant
    effect's and the control's logit errors of the prefill and each step."""
    qs = [i for i in range(1, steps + 1) if errs0[i] > EXACT_TOL]

    def within(es):
        c = {"steps_within_quant": sum(es[i] <= max(EXACT_TOL, errs0[i]) for i in qs),
             "steps_near": sum(es[i] <= max(EXACT_TOL, errs0[i] / 4) for i in qs),
             "steps_exact": sum(es[i] <= EXACT_TOL for i in qs)}
        return dict(c, step_rule_ok=bool(qs) and _step_rule(c, len(qs), resync))

    return dict(resync=resync, quant_steps=len(qs), max_rel_logit_quant_effect=max(errs0),
                prefill_rel_logit_err=errs[0], prefill_quant_effect=errs0[0],
                max_rel_logit_err_unquantised=max(
                    [errs[i] for i in range(1, steps + 1) if errs0[i] <= EXACT_TOL], default=0.0),
                **within(errs), control={"max_rel_logit_err": max(errsc), **within(errsc)})


def _teacher_forced(ek, ep, prompt, steps: int, ep0=None, ec=None, resync: bool = False) -> dict:
    """Prefill, then ``steps`` decode steps of the kernel engine ``ek`` and
    the plain engine ``ep``, both fed the kernel engine's greedy token:
    the largest logit difference of any step over that step's max
    |logits|, and the steps whose argmax differs (reported; they are
    bounded by the logit limit, which allows a flip only where the top-2
    margin is under twice the limit).

    ``ep0`` and ``ec`` (the int8-activation bodies, see ``phase_wrap``):
    the plain engine of the same weights without int8 activations, and the
    control, the kernel engine without them. Each of their steps starts
    from ``ep``'s cache, and so does each of ``ek``'s with ``resync``
    (else ``ek`` keeps its own, and its cache rows are compared with
    ``ep``'s after every step). Each step's logit difference of ``ep0``
    from ``ep`` (what the int8 activations change in that step, its quant
    effect) is recorded beside the kernel's and the control's. Over the
    decode steps with a quant effect above EXACT_TOL (``quant_steps``), for
    each of the two: the steps within their quant effect or EXACT_TOL
    (``steps_within_quant``), within a quarter of it or EXACT_TOL
    (``steps_near``), within EXACT_TOL, and whether that passes
    ``_step_rule``; the largest difference of the other decode steps
    (``max_rel_logit_err_unquantised``) and of the prefill."""
    import numpy as np
    import torch

    def rel(a, ref):
        return float((a - ref).abs().max()) / float(ref.abs().max())

    lk, ck, pos = ek.prefill(prompt, ek.new_cache(1))
    lp, cp, _ = ep.prefill(prompt, ep.new_cache(1))
    quant = ep0 is not None
    if quant:
        l0, c0, _ = ep0.prefill(prompt, ep0.new_cache(1))
        lc, cc, _ = ec.prefill(prompt, ec.new_cache(1))
    worst, flips, over = 0.0, 0, 0
    errs, errs0, errsc = [], [], []
    cache_worst = torch.zeros((2,), device=cp.k.device)
    for i in range(steps + 1):
        errs.append(rel(lk, lp))
        worst = max(worst, errs[-1])
        over += errs[-1] > WRAP_TOL
        if quant:
            errs0.append(rel(l0, lp))
            errsc.append(rel(lc, lp))
        tk = int(lk.argmax())
        flips += tk != int(lp.argmax())
        if i == steps:
            break
        step = (np.array([tk]), np.array([pos], np.int32))
        if quant:
            for name in ("k", "v", "k_scale", "v_scale"):
                for c in (ck, c0, cc) if resync else (c0, cc):
                    if getattr(c, name) is not None:
                        getattr(c, name).copy_(getattr(cp, name))
            l0, c0 = ep0.decode(*step, c0)
            lc, cc = ec.decode(*step, cc)
        lk, ck = ek.decode(*step, ck)
        lp, cp = ep.decode(*step, cp)
        if quant and not resync:
            cache_worst = torch.maximum(cache_worst, _cache_row_err(ck, cp))
        pos += 1
    out = {"steps": steps, "final_pos": pos, "max_rel_logit_err": worst, "argmax_flips": flips,
           "steps_over_tol": over}
    if quant:
        out.update(_quant_stats(errs, errs0, errsc, steps, resync))
        if not resync:
            out["max_rel_cache_row_err"], out["max_rel_sink_row_err"] = (
                float(cache_worst[1]), float(cache_worst[0]))
    return out


def _ring_wraps(final_pos: int, window: int) -> int:
    """Ring wraps passed by the time a run reaches final_pos: the ring
    first fills at the window, then every window - KV_SINKS positions."""
    from xalm_tpu_torch.models.config import KV_SINKS

    return 0 if final_pos <= window else 1 + (final_pos - window - 1) // (window - KV_SINKS)


def _copy_free_running(ek, ep, prompt, steps: int, perm_inv) -> dict:
    """Free-running greedy tokens of the copy model (``copy_params``) on the
    kernel engine ``ek`` and the plain engine ``ep``, against the recurrence
    token[i + 1] = perm_inv[token[i - 1]]."""
    expected = list(prompt)
    for _ in range(steps + 1):
        expected.append(perm_inv[expected[-2]])
    expected = expected[len(prompt):]
    got_k, _ = ek.generate(prompt, steps + 1, stop_on_eos=False)
    got_p, _ = ep.generate(prompt, steps + 1, stop_on_eos=False)
    return {"steps": steps, "final_pos": len(prompt) + steps,
            "kernel_equal_recurrence": sum(a == b for a, b in zip(got_k, expected)),
            "plain_equal_recurrence": sum(a == b for a, b in zip(got_p, expected)),
            "kernel_equal_plain": sum(a == b for a, b in zip(got_k, got_p)),
            "distinct_tokens": len(set(got_k)), "tokens_head": got_k[:8],
            "identical": got_k == got_p == expected}


def copy_params(cfg, seed: int, qkv_bias: bool = False):
    """Weights of a model whose greedy output is decided by attention: the
    token after position i is ``perm_inv[token at i - 1]``, read through
    the cache. Returns (params, perm_inv).

    Layer 0 holds one working head (q head 0 on kv head 0); every other
    weight is zero. The embedding of token t is [code_t | 1 ... 1 | 0 ...]
    (code_t: hd random signs), so after the norm its second hd lanes are a
    constant xc. From those lanes q = a R(-1) c and k = a c, with c
    nonzero in the six fastest rope pairs: under the interleaved-pair rope
    the score of key j for query i is a^2 sum_p |c_p|^2 cos((j - i + 1)
    theta_p), peaked at j = i - 1 by 200 nats over any other key of a
    256-slot window (at least 0.26 of the peak lower for offsets up to
    260). v is code_t, wo writes it to the third hd lanes, and the head's
    row t holds code_perm[t] there, so the logit of t is code_perm[t] .
    code_prev: 128 for the right token, about 50 at most for the others.

    The family folds keep that recurrence. ``qkv_bias``: a bias on the q
    lanes past the six pairs (k is 0 there, so no score moves) and a small
    one on v (std 0.05: it adds the same row to every attention output,
    about 0.6 to a logit, against a margin of about 78). ``cfg.qk_norm``:
    the q and k norm weights are the rms of the constant q and k rows, so
    the norms hand the rows back as they were. ``cfg.embed_scale``: the
    embed rows are stored divided by it, so the scaled rows are the ones
    above (to bf16 rounding). Gelu: the FFN weights are zero, and gelu(0) =
    0. ``cfg.post_norms``: the post-attention norm weights are the rms of
    the one head's wo output (hd lanes of +-1 among dim), so the norm hands
    it back, and the FFN's output stays 0. The softcaps: the attention cap
    must leave the 200-nat peak standing, which a cap of 400 does (185
    against at most 142 for any other key), and no cap that bites on random
    weights does (at cap 50 the peak and the next key are 0.6 nats apart);
    the logit cap is monotone, but one that saturates in f32 ties the top
    logits: at Gemma-2's widths the right token's logit is about 550 and
    the next at most about 170, which a cap of 100 takes to 99.997 and 94.
    ``phase_wrap`` runs the copy model with those caps."""
    import numpy as np
    import torch

    from xalm_tpu_torch.models.llama import rope_freqs
    from xalm_tpu_torch.models.params import LayerParams, ModelParams, QWeight

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L, d, vocab, hd = cfg.n_layers, cfg.dim, cfg.vocab_size, cfg.head_dim
    g, kh = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads
    code = torch.randint(0, 2, (vocab, hd), generator=gen, device=dev).float() * 2 - 1
    perm = torch.randperm(vocab, generator=gen, device=dev)
    perm_inv = torch.empty_like(perm)
    perm_inv[perm] = torch.arange(vocab, device=dev)

    embed = torch.zeros((vocab, d), dtype=torch.float32, device=dev)
    embed[:, :hd] = code
    embed[:, hd:2 * hd] = 1.0
    embed = (embed / cfg.embed_scale).to(torch.bfloat16)
    wcls = torch.zeros((vocab, d), dtype=torch.bfloat16, device=dev)
    wcls[:, 2 * hd:3 * hd] = code[perm]

    xc = 1.0 / math.sqrt(2 * hd / d + cfg.norm_eps)  # the normed constant lanes
    theta = rope_freqs(cfg).astype(np.float64)
    w = 0.8 ** np.arange(6)
    amp = math.sqrt(200.0 * math.sqrt(hd) / w.sum())  # peak score 200 after 1/sqrt(hd)
    c = np.zeros(hd)
    q0 = np.zeros(hd)
    c[0:12:2] = amp * np.sqrt(w)
    q0[0:12:2] = amp * np.sqrt(w) * np.cos(theta[:6])  # R(-theta) applied to (c_p, 0)
    q0[1:12:2] = -amp * np.sqrt(w) * np.sin(theta[:6])

    wqkv = torch.zeros((kh * (g + 2) * hd, d), dtype=torch.float64)
    wo = torch.zeros((d, cfg.q_dim), dtype=torch.float64)
    lanes = torch.arange(hd)
    wqkv[lanes, hd + lanes] = torch.from_numpy(q0 / xc)  # q head 0
    wqkv[g * hd + lanes, hd + lanes] = torch.from_numpy(c / xc)  # k of kv head 0
    wqkv[(g + 1) * hd + lanes, lanes] = 1.0 / xc  # v of kv head 0: code_t
    wo[2 * hd + lanes, lanes] = 1.0
    bias = torch.zeros((wqkv.shape[0],), dtype=torch.float64)
    if qkv_bias:
        bg = torch.Generator().manual_seed(seed)
        bias[12:hd] = 0.5 * torch.randn(hd - 12, generator=bg, dtype=torch.float64)
        bias[(g + 1) * hd:(g + 2) * hd] = 0.05 * torch.randn(hd, generator=bg, dtype=torch.float64)

    def i8(layer0: torch.Tensor) -> QWeight:
        """Stack (L, D, N) with layer0 first and zero layers after; one
        nonzero per row, so the per-row absmax code is exact."""
        scale = layer0.abs().amax(dim=1) / 127.0
        scale = torch.where(scale > 0, scale, torch.full_like(scale, 1.0 / 127.0))
        q = torch.zeros((L, *layer0.shape), dtype=torch.int8, device=dev)
        q[0] = torch.round(layer0 / scale[:, None]).to(torch.int8).to(dev)
        s = torch.full((L, layer0.shape[0]), 1.0 / 127.0, dtype=torch.float32, device=dev)
        s[0] = scale.to(torch.float32).to(dev)
        return QWeight(q, s)

    def zeros(rows, cols) -> QWeight:
        return QWeight(torch.zeros((L, rows, cols), dtype=torch.int8, device=dev),
                       torch.ones((L, rows), dtype=torch.float32, device=dev))

    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)  # noqa: E731
    layers = LayerParams(attn_norm=ones(L, d), wqkv=i8(wqkv), wo=i8(wo), mlp_norm=ones(L, d),
                         w13=zeros(2 * cfg.hidden_dim, d), w2=zeros(d, cfg.hidden_dim))
    if qkv_bias:
        layers.bqkv = torch.zeros((L, bias.numel()), dtype=torch.float32, device=dev)
        layers.bqkv[0] = bias.to(torch.float32)
    if cfg.qk_norm:  # the rms of the rows the norms see: q (with its bias) and k
        qrow = torch.from_numpy(q0) + bias[:hd]
        rms = lambda r: math.sqrt(float((r * r).mean()) + cfg.norm_eps)  # noqa: E731
        layers.q_norm = ones(L, hd) * rms(qrow)
        layers.k_norm = ones(L, hd) * rms(torch.from_numpy(c))
    if cfg.post_norms:  # the rms of the wo output: hd lanes of +-1 among d
        layers.post_attn_norm = ones(L, d) * math.sqrt(hd / d + cfg.norm_eps)
        layers.post_mlp_norm = ones(L, d)
    params = ModelParams(embed=QWeight(embed, None), layers=layers, out_norm=ones(d),
                         wcls=QWeight(wcls, None))
    return params, perm_inv.tolist()


# phase_wrap's runs: (body, cache, engine options, each kernel step from the
# plain run's cache): the i8 body on both caches; the q4 body (group 512)
# and the i8 body with int8 activations (a8_prefill: the 200-token prompt
# is one 256-row W8A8 chunk) on the bf16 cache, the latter also on the
# kernel's own cache; the i8 body on an f32 cache (both decode paths) and
# an f16 cache (per layer: no megakernel takes it)
WRAP_BODIES = [("i8", "bfloat16", {}, False), ("i8", "int8", {}, False),
               ("q4", "bfloat16", dict(a8_decode=True), True),
               ("a8", "bfloat16", dict(a8_decode=True, a8_prefill=True), True),
               ("a8", "bfloat16", dict(a8_decode=True, a8_prefill=True), False),
               ("i8", "float32", {}, False), ("i8", "float16", {}, False)]


# the copy model's softcaps where the model has them (see copy_params)
COPY_ATTN_SOFTCAP, COPY_LOGIT_SOFTCAP = 400.0, 100.0


def phase_wrap(cfg, bodies=WRAP_BODIES, qkv_bias: bool = False, model: str = "") -> list[dict]:
    """The kernels against their plain versions through three ring wraps,
    at the main path's widths with 2 layers and a 256-slot window (a
    200-token prompt, 600 decode steps), with a bf16 and with an int8 cache,
    on each decode path: the per-layer kernels (``fused_step=False`` on both
    engines) and the megakernel with the i8 head (``wcls_i8=True`` on both:
    the plain engine runs the megakernel's plain version):

    (a) random weights, teacher-forced: the logits of every step within
        WRAP_TOL of that step's max |logits|;
    (b) the copy model (``copy_params``), free-running greedy: the kernel
        run's and the plain run's 601 tokens are identical, and both equal
        the recurrence token[i + 1] = perm_inv[token[i - 1]], which holds
        only if each step's attention finds the previous token's row in
        the ring. Its head rows are +-1, so the i8 recode is exact; with an
        int8 cache its V rows (+-1) quantise exactly and its K rows to 1/254
        of their max, which moves a 200-nat score peak by about a nat.

    The q4 body and the a8 runs quantise every phase's input rows to int8
    codes. An activation one code apart moves its row by up to 1/127 of the
    row's max, and the kernels and plain versions sum attention and the rms
    in other orders, so now and then a code lands one count apart and a
    step's logits move past WRAP_TOL (on an H100, q4 per-layer path: 4.3e-2
    of max |logits| at worst, 39 of 601 steps past WRAP_TOL even with every
    kernel step started from the plain run's cache). Their (a) runs beside
    the kernel engine the plain engine of the same weights without int8
    activations and the control, the kernel engine without them (for q4,
    which has no such kernel, the dequantised route), both from the plain
    run's cache at every step (``_teacher_forced``). A step's quant effect
    is how far the int8 activations move that step's plain logits; the
    decode steps where it is above EXACT_TOL are the run's quant steps (none
    on the a8 per-layer path: the reference quantises i8 decode rows only
    in the megakernel, so there only the prompt chunk takes the W8A8 GEMM).
    The step rule (``_step_rule``) over the quant steps, with every kernel
    step from the plain run's cache: QUANT_STEP_SHARE of them within their
    own quant effect and NEAR_STEP_SHARE within a quarter of it (a code or
    two apart move a step far less than all of them rounded); on the
    kernel's own cache (the a8 runs again, as the i8 runs are held),
    OWN_STEP_SHARE within their own quant effect, and every cache row but
    the sinks' within OWN_CACHE_TOL of its max after every step. From the
    plain run's cache the control, which sits at the quant effect itself,
    must fail the rule, or the run cannot tell the bodies apart. On its
    own cache the kernel's steps move by about the quant effect too (rows
    written with a code apart stay in the ring; on an H100 none of the 601
    steps within a quarter of it), so that run holds the kernel's ring
    inserts, and the codes are held from the plain run's cache. Every step
    within WRAP_TOL or the run's largest quant effect, and the other
    decode steps within WRAP_TOL. (b) runs each side on its own cache, as for the i8 body.

    The f32 and f16 caches run the i8 body, held as the bf16 cache: f32 on
    both paths (kernels 2-4's and the megakernel's f32 instantiations), f16
    per layer alone (no megakernel takes it; its attention is the dense
    one, on both engines, the matmuls kernel 1 against its plain version).

    The f32 body (``F32_WRAP_BODY``: f32 weights, embed and head, kernel 1's
    f32 branch) runs the per-layer path alone (the megakernel needs an i8
    body) and is held as the i8 body is; its copy model is ``copy_params``'
    dequantised to f32.

    ``bodies`` picks the runs of WRAP_BODIES; ``qkv_bias`` (and
    ``cfg.qk_norm``, gelu, the embed scale, post-norms and softcaps of
    ``cfg``) put the family folds in both models (``copy_params`` keeps its
    recurrence with them, the softcaps at COPY_ATTN_SOFTCAP and
    COPY_LOGIT_SOFTCAP);
    ``model`` names the rows.
    """
    import numpy as np
    import torch

    from xalm_tpu_torch.models.params import recode_params_q4
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg2 = dataclasses.replace(cfg, n_layers=2, max_seq_len=256)
    cfg_copy = dataclasses.replace(
        cfg2, attn_softcap=COPY_ATTN_SOFTCAP if cfg.attn_softcap else 0.0,
        logit_softcap=COPY_LOGIT_SOFTCAP if cfg.logit_softcap else 0.0)
    steps = 600
    prompt = np.random.default_rng(SEED + 1).integers(3, cfg.vocab_size, size=200).tolist()
    rows = []
    paths = (("perlayer", dict(fused_step=False)), ("megakernel", dict(wcls_i8=True)))
    for (body, kv_name, bkw, resync), (path, kw) in itertools.product(bodies, paths):
        if (body == "f32" or kv_name == "float16") and path == "megakernel":
            continue
        kv = getattr(torch, kv_name)

        def engines(params, c=cfg2, kw=dict(kw, **bkw), kv=kv):
            return (Engine(c, params, kv_dtype=kv, matmul_impl="kernel", **kw),
                    Engine(c, params, kv_dtype=kv, matmul_impl="plain", **kw))

        q4 = 512 if body == "q4" else 0
        f32 = dict(weight_dtype=torch.float32, embed_dtype=torch.float32) if body == "f32" else {}
        params = synthetic_params(cfg2, device=DEVICE, seed=SEED + 1, q4_group=q4,
                                  qkv_bias=qkv_bias, **f32)
        ek, ep = engines(params)
        if ek.decode_path(1) != path:
            raise AssertionError(f"wrap phase: decode path {ek.decode_path(1)!r}, expected {path!r}")
        ep0 = ec = None
        if body not in ("i8", "f32"):  # the same weights without int8 activations, the control
            ep0 = Engine(cfg2, params, kv_dtype=kv, matmul_impl="plain", **kw)
            ec = Engine(cfg2, params, kv_dtype=kv, matmul_impl="kernel", **kw)
        forced = _teacher_forced(ek, ep, prompt, steps, ep0, ec, resync)
        del params, ek, ep, ep0, ec

        params, perm_inv = copy_params(cfg_copy, SEED + 2, qkv_bias)
        if q4:  # one nonzero per row: its group's absmax, code 7
            params = recode_params_q4(params, q4)
        if f32:
            params = _dequant_params(params, torch.float32)
        copy = _copy_free_running(*engines(params, cfg_copy), prompt, steps, perm_inv)
        row = {"phase": "wrap", "model": model or "Mistral-7B", "body": body, "decode_path": path,
               "kv_dtype": str(kv).split(".")[-1],
               "layers": 2, "window": 256,
               "prompt_tokens": len(prompt), "ring_wraps": _ring_wraps(copy["final_pos"], 256),
               "tol_rel": WRAP_TOL, "random_teacher_forced": forced, "copy_free_running": copy,
               "tokens_identical": copy["identical"],
               "softcaps": {"random": [cfg2.attn_softcap, cfg2.logit_softcap],
                            "copy": [cfg_copy.attn_softcap, cfg_copy.logit_softcap]}}
        emit(row)
        if row["ring_wraps"] < 3:
            raise AssertionError(f"wrap phase: {row['ring_wraps']} ring wraps, expected 3")
        if body in ("i8", "f32"):
            forced_ok = forced["max_rel_logit_err"] <= WRAP_TOL
        else:
            forced_ok = (forced["max_rel_logit_err"] <= max(WRAP_TOL,
                                                            forced["max_rel_logit_quant_effect"])
                         and forced["max_rel_logit_err_unquantised"] <= WRAP_TOL
                         and forced.get("max_rel_cache_row_err", 0.0) <= OWN_CACHE_TOL
                         and (forced["step_rule_ok"] or not forced["quant_steps"]))
            if forced["resync"] and forced["control"]["step_rule_ok"]:
                raise AssertionError(f"wrap phase ({body}, {path}): the step rule passes the "
                                     f"control too: {forced}")
        if not forced_ok:
            raise AssertionError(f"wrap phase ({body}, {path}, {kv}, teacher-forced): {forced}")
        if not row["tokens_identical"]:
            raise AssertionError(f"wrap phase ({body}, {path}, {kv}, copy model): greedy tokens differ: "
                                 f"{copy}")
        rows.append(row)
        del params
        torch.cuda.empty_cache()
    return rows


# why no library call stands beside qmatmul_multi
NO_LIBRARY_MULTI = ("no one PyTorch call gathers experts by an index on the device and "
                    "applies their row scales")
MULTI_W13_CASE = "w13 i8 + row scale, shared x, m=1, k=2"
MULTI_W2_CASE = "w2 i8 + row scale, per-expert x, m=1, k=2"


def phase_parity_multi(params, cfg, cases: Cases) -> None:
    """qmatmul_multi against its plain version (phase 3) at Mixtral-8x7B
    shapes, on the drawn 32-layer expert stacks viewed flat as the forward
    views them: w13 (256, 28672, 4096) and w2 (256, 4096, 14336) int8 with
    row scales. Each output row within 1e-4 of its max |plain|: both sides
    sum the same exact f32 products of bf16 x and int8 or bf16 weights in
    another order. Cases: w13 with x shared by the k = 2 experts, w2 with a
    row group per expert, an index of 255 (its weights 29.9 GB into the w13
    stack, 15.0 GB into w2), m = 4 with shared x, and q8 (no scale) and bf16
    expert weights at a small depth. The timed launches cycle over the 32
    layers' experts, so each streams its weights cold."""
    import torch

    from xalm_tpu_torch.ops.qmatmul import qmatmul_multi, qmatmul_multi_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    lp = params.layers
    L, E, d, h = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.hidden_dim
    w13v, w13s = lp.w13e.values.reshape(L * E, 2 * h, d), lp.w13e.scale.reshape(L * E, 2 * h)
    w2v, w2s = lp.w2e.values.reshape(L * E, d, h), lp.w2e.scale.reshape(L * E, d)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    per_layer = [i32(layer * E + 3, layer * E + 6) for layer in range(L)]

    def case(name, x, values, scale, idx_sets, shared):
        idxs = idx_sets[0]
        got = qmatmul_multi(x, values, scale, idxs, shared_x=shared)
        want = qmatmul_multi_plain(x, values, scale, idxs, shared_x=shared)
        k = idxs.numel()
        m = x.shape[0] // (1 if shared else k)
        dd, n = values.shape[1:]
        nbytes = k * dd * n * values.element_size() + (k * dd * 4 if scale is not None else 0)
        nbytes += x.numel() * 4 + k * m * dd * 4
        it = itertools.cycle(idx_sets)
        cases.add("qmatmul_multi", name, got, want, dd, 1e-4,
                  lambda: qmatmul_multi(x, values, scale, next(it), shared_x=shared),
                  lambda: qmatmul_multi_plain(x, values, scale, next(it), shared_x=shared),
                  None, nbytes, 2.0 * k * m * n * dd, PEAK_BF16,
                  extra={"library_note": NO_LIBRARY_MULTI, "idxs": idxs.tolist(), "m": m,
                         "weight_offset_bytes": int(idxs.max()) * dd * n * values.element_size()})

    x1 = torch.randn((1, d), generator=gen, device=dev)
    x2 = torch.randn((2, h), generator=gen, device=dev)
    case(MULTI_W13_CASE, x1, w13v, w13s, per_layer, True)
    case(MULTI_W2_CASE, x2, w2v, w2s, per_layer, False)
    case("w13 i8, idxs [255, 3]: weights past 2^31 bytes", x1, w13v, w13s, [i32(255, 3)], True)
    case("w2 i8, idxs [255, 128]: weights past 2^31 bytes", x2, w2v, w2s, [i32(255, 128)], False)
    case("w13 i8 + row scale, shared x, m=4, k=2",
         torch.randn((4, d), generator=gen, device=dev), w13v, w13s, per_layer, True)
    small = [i32(15, 2), i32(9, 12)]
    case("w13 q8 (no scale), 16 experts, m=1, k=2", x1, w13v[:16], None, small, True)
    wb = torch.randn((4, 2 * h, d), generator=gen, device=dev).mul_(0.02).to(torch.bfloat16)
    case("w13 bf16, 4 experts, m=1, k=2", x1, wb, None, [i32(3, 1), i32(0, 2)], True)
    del wb
    torch.cuda.empty_cache()


def phase_main_moe(params, cfg) -> dict:
    """The Mixtral main path: ``Engine.generate`` of a 512-token prompt and
    64 greedy tokens with a bf16 cache, on the default decode path, which
    for MoE is the per-layer kernels (the megakernel refuses MoE): per
    decode token 65 qmatmul launches (wqkv and wo per layer, the head), 64
    qmatmul_multi (the chosen experts' w13 and w2 per layer), and one
    flash_decode launch per layer that inserts, re-rotates and attends. Prefill chunks run the dense-masked experts
    (plain f32 products, as the reference's XLA einsums) and kernel 1 for
    wqkv and wo. Returns the run's launches."""
    import numpy as np
    import torch

    from xalm_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(SEED).integers(3, cfg.vocab_size, size=512).tolist()
    L = cfg.n_layers
    eng = Engine(cfg, params, kv_dtype=torch.bfloat16)
    if eng.decode_path(1) != "perlayer":
        raise AssertionError(f"Mixtral decode path {eng.decode_path(1)!r}, expected 'perlayer'")
    row = _main_run(eng, cfg, prompt, "mixtral bf16 perlayer")
    want = {"qmatmul": 2 * L + 1, "qmatmul_multi": 2 * L, "kv_update": 0, "flash_decode": L,
            "fused_decode": 0, "kv_update_q": 0, "flash_decode_q": 0, "flash_prefill": 0}
    per_token = row["launches_per_decode_token"]
    if any(per_token[k] != n for k, n in want.items()) or (
            row["launches"]["qmatmul_multi"] != 63 * 2 * L):
        raise AssertionError(f"Mixtral run: {row['launches']}, per token {per_token}: "
                             f"expected per token {want}")
    del eng
    torch.cuda.empty_cache()
    return {"launches": row["launches"]}


# A routing flip: the kernel run and the plain run choose different experts
# for a token at a layer. bf16-level differences in x can swap two experts
# whose router log-probabilities are nearly tied; one swap moves that
# token's FFN output far more than WRAP_TOL, and every later token through
# the K/V rows it writes. So the MoE wrap phase teacher-forces the routing
# as it teacher-forces the tokens: where the plain run's chosen set differs
# from the kernel run's, the plain run takes the kernel run's experts (each
# with the plain run's own renormalised probability), and such a flip fails
# the phase unless the plain run's gap between its k-th and (k+1)-th
# log-probabilities is under ROUTE_MARGIN (nats; the recorded largest change
# of that gap between the runs shows how far below it they stay). Nothing is
# then left out: the logits of every step, the prefill's included, are held
# to WRAP_TOL, and every cache row but the sinks', after every step, to
# CACHE_TOL of its max |plain| (dequantised for an int8 cache; one int8
# count is 1/127). The sink rows are reported beside them, not held: the
# reference re-rotates them in place by one position per wrapped step and
# rounds them to the cache type each time, so two runs whose sinks differ
# by a rounding walk apart by a fresh rounding per step (0.32 of a row's
# max after 600 steps on the H100, while the logits stayed within 8e-3);
# the logits, which attend over them every step, hold them.
ROUTE_MARGIN = 0.05
CACHE_TOL = 2e-2
# The wrap phase's router is drawn at HF Mixtral's initializer range (std
# 0.02: router logits of std 1.3 at dim 4096), not at synthetic_params'
# 0.3 (logits of std 19), whose gain carries the runs' bf16-level
# differences into the experts' mix weights: phase_router_witness measures
# that on the plain version alone.
WRAP_ROUTER_STD = 0.02
SYNTHETIC_ROUTER_STD = 0.3  # synthetic_params' router
WITNESS_STEPS = 200


def _cache_row_err(got, want):
    """(sink rows, other rows): max over the rows of a cache (a layer's KV
    head at a slot) of |got - want| over max |want|, on the device; an int8
    cache dequantised."""
    import torch

    from xalm_tpu_torch.models.config import KV_SINKS

    worst = torch.zeros((2,), device=want.k.device)
    for name in ("k", "v"):
        g, w = getattr(got, name).float(), getattr(want, name).float()
        if want.quantized:
            g = g * getattr(got, name + "_scale")[..., None]
            w = w * getattr(want, name + "_scale")[..., None]
        err = (g - w).abs().amax(dim=-1) / w.abs().amax(dim=-1).clamp_min(1e-30)  # (L, B, KH, S)
        worst = torch.maximum(worst, torch.stack([err[..., :KV_SINKS].max(),
                                                  err[..., KV_SINKS:].max()]))
    return worst


def _teacher_forced_moe(ek, ep, prompt, steps: int, ep0=None, ec=None) -> dict:
    """``_teacher_forced`` for MoE engines, with the routing teacher-forced
    too (see ROUTE_MARGIN) through ``llama.moe_route``: ``ek`` leads, and
    its chosen experts and router log-probabilities are recorded layer by
    layer; ``ep`` follows and takes ``ek``'s experts wherever its own set
    differs. Returns the logit errors of the prefill and of every step, the
    largest cache-row error after any step, and the flips, each as (step,
    layer, token, the plain run's gap), step -1 being the prefill.

    ``ep0`` and ``ec`` (int8 activations, the q4 experts): the plain engine
    without them and the control, as in ``_teacher_forced`` with
    ``resync``: they follow ``ek``'s routing too, and each step of ``ek``,
    ``ep0`` and ``ec`` starts from ``ep``'s cache; the quant effect and the
    step rule come out as there (``_quant_stats``), and no cache row is
    compared (every kernel step starts from the plain run's rows)."""
    import numpy as np
    import torch

    from xalm_tpu_torch.models import llama

    route = llama.moe_route
    lead, recs, state = [], [], {"mode": "lead", "at": 0}

    def routed(xn, wgate, kk):
        topv, topi = route(xn, wgate, kk)
        rlog = torch.einsum("btd,ed->bte", xn, wgate.to(torch.float32))
        logp = torch.log_softmax(rlog, dim=-1)
        if state["mode"] == "lead":
            lead.append((topi, logp))
            return topv, topi
        ti, logp_lead = lead[state["at"]]
        state["at"] += 1
        differ = (ti.sort(dim=-1).values != topi.sort(dim=-1).values).any(dim=-1)  # (B, T)
        if state["mode"] == "record":
            order = logp.argsort(dim=-1, descending=True)[..., kk - 1:kk + 1]
            g, g_lead = logp.gather(-1, order), logp_lead.gather(-1, order)
            gap = g[..., 0] - g[..., 1]
            recs.append((differ[0], gap[0], (g_lead[..., 0] - g_lead[..., 1] - gap).abs().max()))
        forced = torch.softmax(rlog, dim=-1).gather(-1, ti)
        forced = forced / torch.sum(forced, dim=-1, keepdim=True)
        pick = differ[..., None]
        return torch.where(pick, forced, topv), torch.where(pick, ti, topi)

    def both(fk, fp, *more):
        """Run the lead, then ``fp`` recording, then ``more`` forced alone."""
        lead.clear()
        recs.clear()
        state["mode"] = "lead"
        rk = fk()
        outs = []
        for mode, f in [("record", fp)] + [("force", f) for f in more]:
            state.update(mode=mode, at=0)
            outs.append(f())
            if state["at"] != len(lead):
                raise AssertionError(f"MoE wrap: {len(lead)} router calls led, {state['at']} "
                                     "followed")
        # (layers, T) flip masks and plain gaps, the largest gap change
        return (rk, outs[0], (torch.stack([r[0] for r in recs]), torch.stack([r[1] for r in recs]),
                              torch.stack([r[2] for r in recs]).max()), outs[1:])

    def rel(a, ref):
        return float((a - ref).abs().max()) / float(ref.abs().max())

    quant = ep0 is not None
    llama.moe_route = routed
    errs, flipped_errs, flips, all_errs, errs0, errsc = [], [], [], [], [], []
    flipped_steps, min_gap, max_dgap, cache_err = 0, math.inf, 0.0, None
    try:
        extra = [lambda e=e: e.prefill(prompt, e.new_cache(1)) for e in (ep0, ec) if quant]
        (lk, ck, pos), (lp, cp, _), rec, more = both(
            lambda: ek.prefill(prompt, ek.new_cache(1)),
            lambda: ep.prefill(prompt, ep.new_cache(1)), *extra)
        if quant:
            (l0, c0, _), (lc, cc, _) = more
        for step in range(-1, steps):  # -1: the prefill
            if step >= 0:
                tk = int(lk.argmax())
                args = (np.array([tk]), np.array([pos], np.int32))
                if quant:  # every step but the plain run's from the plain run's cache
                    for c in (ck, c0, cc):
                        for name in ("k", "v", "k_scale", "v_scale"):
                            if getattr(c, name) is not None:
                                getattr(c, name).copy_(getattr(cp, name))
                extra = [lambda: ep0.decode(*args, c0), lambda: ec.decode(*args, cc)][:2 * quant]
                (lk, ck), (lp, cp), rec, more = both(
                    lambda: ek.decode(*args, ck), lambda: ep.decode(*args, cp), *extra)
                if quant:
                    (l0, c0), (lc, cc) = more
                pos += 1
            differ, gaps, dgap = rec
            err = rel(lk, lp)
            all_errs.append(err)
            if quant:
                errs0.append(rel(l0, lp))
                errsc.append(rel(lc, lp))
            if step < 0:
                prefill_err = err
                flipped_prefill = int(differ.any(dim=0).sum())
            if not quant:
                row = _cache_row_err(ck, cp)
                cache_err = row if cache_err is None else torch.maximum(cache_err, row)
            min_gap = min(min_gap, float(gaps.min()))
            max_dgap = max(max_dgap, float(dgap))
            hits = torch.nonzero(differ).tolist()
            (flipped_errs if hits else errs).append(err)
            flipped_steps += bool(hits) and step >= 0
            flips += [(step, layer, tok, float(gaps[layer, tok])) for layer, tok in hits]
    finally:
        llama.moe_route = route
    out = {"steps": steps, "final_pos": pos, "prefill_rel_logit_err": prefill_err,
           "max_rel_logit_err": max(errs + flipped_errs),
           "max_rel_logit_err_unflipped": max(errs, default=None),
           "max_rel_logit_err_flipped": max(flipped_errs, default=None),
           "routing_decisions": (len(prompt) + steps) * ek.cfg.n_layers,
           "flips": len(flips), "flipped_prefill_tokens": flipped_prefill,
           "flipped_steps": int(flipped_steps), "flips_head": flips[:12],
           "flips_beyond_margin": [f for f in flips if f[3] > ROUTE_MARGIN],
           "min_plain_gap": min_gap, "max_gap_change": max_dgap, "route_margin": ROUTE_MARGIN}
    if quant:
        out.update(_quant_stats(all_errs, errs0, errsc, steps, resync=True))
    else:
        out.update(max_rel_cache_row_err=float(cache_err[1]),
                   max_rel_sink_row_err=float(cache_err[0]))
    return out


def moe_copy_params(cfg, seed: int):
    """``copy_params`` with Mixtral's FFN: a random router and random i8
    experts whose row scales (1e-3/127) keep the FFN's output near 1e-4, so
    attention still decides the next token by about 80 logits whichever
    experts a step picks."""
    import torch

    from xalm_tpu_torch.models.params import QWeight

    params, perm_inv = copy_params(cfg, seed)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    L, E, d, h = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.hidden_dim

    def experts(rows, cols):
        q = torch.randint(-128, 128, (L, E, rows, cols), dtype=torch.int8, device=dev, generator=gen)
        return QWeight(q, torch.full((L, E, rows), 1e-3 / 127, device=dev))

    layers = dataclasses.replace(
        params.layers, w13=None, w2=None,
        wgate=torch.randn((L, E, d), generator=gen, device=dev).mul_(0.3),
        w13e=experts(2 * h, d), w2e=experts(d, h))
    return dataclasses.replace(params, layers=layers), perm_inv


def _moe_wrap_setup(cfg):
    """Phase 5's 2-layer, 256-slot Mixtral configuration and 200-token prompt."""
    import numpy as np

    cfg2 = dataclasses.replace(cfg, n_layers=2, max_seq_len=256)
    return cfg2, np.random.default_rng(SEED + 3).integers(3, cfg.vocab_size, size=200).tolist()


def phase_wrap_moe(cfg) -> list[dict]:
    """Phase 5 for Mixtral: full width, 2 layers, a 256-slot window, a
    200-token prompt and 600 decode steps through three ring wraps, the
    per-layer kernels (the path MoE decode takes) against the plain
    versions (``matmul_impl="plain"``: ``qmatmul_multi_plain`` for the
    gathered experts), with a bf16 and with an int8 cache: (a) random
    weights (the router at WRAP_ROUTER_STD), tokens and routing
    teacher-forced (``_teacher_forced_moe``);
    (b) the copy model with MoE (``moe_copy_params``), free-running greedy:
    identical tokens on both paths, equal to the copy recurrence."""
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg2, prompt = _moe_wrap_setup(cfg)
    steps = 600
    rows = []

    def engines(params, kv):
        return (Engine(cfg2, params, kv_dtype=kv, matmul_impl="kernel"),
                Engine(cfg2, params, kv_dtype=kv, matmul_impl="plain"))

    for kv in (torch.bfloat16, torch.int8):
        params = synthetic_params(cfg2, device=DEVICE, seed=SEED + 3)
        params.layers.wgate.mul_(WRAP_ROUTER_STD / SYNTHETIC_ROUTER_STD)
        ek, ep = engines(params, kv)
        if ek.decode_path(1) != "perlayer":
            raise AssertionError(f"MoE wrap phase: decode path {ek.decode_path(1)!r}")
        build.reset_launches()
        forced = _teacher_forced_moe(ek, ep, prompt, steps)
        forced["qmatmul_multi_launches"] = build.LAUNCHES["qmatmul_multi"]
        del params, ek, ep

        params, perm_inv = moe_copy_params(cfg2, SEED + 4)
        copy = _copy_free_running(*engines(params, kv), prompt, steps, perm_inv)
        row = {"phase": "wrap_moe", "model": "Mixtral-8x7B", "decode_path": "perlayer",
               "kv_dtype": str(kv).split(".")[-1], "layers": 2, "window": 256,
               "router_std": WRAP_ROUTER_STD, "prompt_tokens": len(prompt),
               "ring_wraps": _ring_wraps(copy["final_pos"], 256), "tol_rel": WRAP_TOL,
               "cache_tol_rel": CACHE_TOL, "random_teacher_forced": forced,
               "copy_free_running": copy, "tokens_identical": copy["identical"]}
        emit(row)
        if row["ring_wraps"] < 3:
            raise AssertionError(f"MoE wrap phase: {row['ring_wraps']} ring wraps, expected 3")
        if (forced["flips_beyond_margin"] or forced["max_rel_logit_err"] > WRAP_TOL
                or forced["max_rel_cache_row_err"] > CACHE_TOL):
            raise AssertionError(f"MoE wrap phase ({kv}, teacher-forced): {forced}")
        if forced["qmatmul_multi_launches"] != steps * 2 * 2:
            raise AssertionError(f"MoE wrap phase: {forced['qmatmul_multi_launches']} qmatmul_multi "
                                 f"launches, expected {steps * 4}")
        if not row["tokens_identical"]:
            raise AssertionError(f"MoE wrap phase ({kv}, copy model): greedy tokens differ: {copy}")
        rows.append(row)
        del params
        torch.cuda.empty_cache()
    return rows


def phase_router_witness(cfg) -> list[dict]:
    """Why phase 5 draws the router at WRAP_ROUTER_STD. At synthetic_params'
    router std and at WRAP_ROUTER_STD, phase 5's model (bf16 cache) for
    WITNESS_STEPS teacher-forced steps, tokens and routing
    (``_teacher_forced_moe``): (a) the kernels against the plain versions;
    (b) the floor: the plain version against itself on the model with its
    residual dimension permuted (``_model_dim_permuted``: only the order of
    its sums changes). If the router's gain, not the kernels, sets (a), (b)
    reads the same. Holds (a)'s logit error to FUSED_FLOOR_RATIO times (b)'s
    (or 1e-3) at each std."""
    import torch

    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg2, prompt = _moe_wrap_setup(cfg)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 5)
    perm = torch.randperm(cfg.dim, generator=gen, device=DEVICE)
    keys = ("max_rel_logit_err", "prefill_rel_logit_err", "max_rel_cache_row_err",
            "max_rel_sink_row_err", "flips",
            "flipped_steps", "flipped_prefill_tokens", "min_plain_gap", "max_gap_change")
    rows = []
    for std in (SYNTHETIC_ROUTER_STD, WRAP_ROUTER_STD):
        params = synthetic_params(cfg2, device=DEVICE, seed=SEED + 3)
        params.layers.wgate.mul_(std / SYNTHETIC_ROUTER_STD)
        plain = Engine(cfg2, params, kv_dtype=torch.bfloat16, matmul_impl="plain")
        kern = _teacher_forced_moe(Engine(cfg2, params, kv_dtype=torch.bfloat16,
                                          matmul_impl="kernel"), plain, prompt, WITNESS_STEPS)
        permuted = Engine(cfg2, _model_dim_permuted(params, perm), kv_dtype=torch.bfloat16,
                          matmul_impl="plain")
        floor = _teacher_forced_moe(permuted, plain, prompt, WITNESS_STEPS)
        row = {"phase": "router_witness", "model": "Mixtral-8x7B", "router_std": std,
               "layers": 2, "steps": WITNESS_STEPS, "kv_dtype": "bfloat16",
               "kernel_vs_plain": {k: kern[k] for k in keys},
               "plain_permuted_vs_plain": {k: floor[k] for k in keys},
               "floor_ratio": FUSED_FLOOR_RATIO}
        emit(row)
        limit = max(FUSED_FLOOR_RATIO * floor["max_rel_logit_err"], 1e-3)
        if kern["max_rel_logit_err"] > limit:
            raise AssertionError(f"router witness (std {std}): kernels {kern['max_rel_logit_err']} "
                                 f"> {FUSED_FLOOR_RATIO} x the plain floor "
                                 f"{floor['max_rel_logit_err']}")
        rows.append(row)
        del params, plain, permuted
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- families
# Phase 4 of the family models runs their first FAMILY_MAIN_LAYERS layers at
# full width (their phase 3 runs at full depth): cut from full depth when the
# weight formats' phases were added, to keep the script well inside its time
# limit (their per-layer runs are host-bound, so their time goes with depth)
FAMILY_MAIN_LAYERS = 8
# Llama-3.1-8B, Qwen2.5-7B, Qwen3-8B, Gemma-2-9B, Gemma-7B and Phi-3-mini
# (models/config.py), random i8 weights at full width and depth, the
# softcaps at ``biting_softcaps``' values (a published cap hardly moves
# random scores and logits): (name, config name, Qwen2 qkv bias, q4 group
# of the q4 megakernel case (0: none), phase-4 runs). Qwen2.5's and
# Gemma-2's q4 cases take group 128: their dim 3584 holds no whole 1024-code
# pair of 512-groups per row half.
FAMILIES = (
    ("Qwen2.5-7B", "QWEN2_5_7B", True, 128, ("megakernel", "perlayer", "int8 perlayer")),
    ("Qwen3-8B", "QWEN3_8B", False, 512, ("megakernel", "perlayer")),
    ("Llama-3.1-8B", "LLAMA3_1_8B", False, 0, ("megakernel",)),
    ("Gemma-2-9B", "GEMMA2_9B", False, 128, ("megakernel", "perlayer", "int8 perlayer")),
    ("Gemma-7B", "GEMMA_7B", False, 0, ("megakernel", "perlayer", "int8 perlayer")),
    ("Phi-3-mini-4k", "PHI3_MINI_4K", False, 0, ("perlayer", "int8 perlayer")),
)
# phase_fused_parity's cases of the int8-activation bodies with a fold: a8
# B=1 wrapped with the embed and i8-head folds, q4 int8 KV at B=4
FOLD_A8_CASE, FOLD_Q4_CASE = 1, 4
# Gemma-7B's megakernel cases (gelu and the embed scale): B=1 with the embed
# fold, bf16 and int8 caches; and its f32-cache case, labelled
GEMMA_CASES = (0, 3)
GEMMA_F32_LABEL = " (Gemma-7B, hd 256, the Gemma folds)"
# the rows of the kernels line at another (GQA group, head_dim): tag (see
# _shape_tag) -> (the model whose phase-4 runs count their launches and
# whose shapes phase_parity_shape measures, the wrappers its main path
# launches). Gemma-2-9B's attention softcap keeps kernels 3, 4 and 7 off its
# main path: they are checked at its shapes but have no row. Without the cap
# the insert rides in flash_decode's (an int8 cache: flash_decode_q's)
# launch, so kv_update and kv_update_q run on Gemma-2's main path alone
# (OFF_MAIN_PATH).
ATTENTION_KERNELS = ("kv_update", "flash_decode", "flash_prefill", "kv_update_q", "flash_decode_q")
_UNCAPPED = tuple(k for k in ATTENTION_KERNELS if k != "kv_update_q")
SHAPE_ROWS = {"_g7": ("Qwen2.5-7B", ("flash_decode", "flash_prefill", "flash_decode_q")),
              "_hd256g2": ("Gemma-2-9B", ("kv_update", "kv_update_q")),
              "_hd256": ("Gemma-7B", _UNCAPPED),
              "_hd96": ("Phi-3-mini-4k", _UNCAPPED)}


def _shape_tag(cfg) -> str:
    """The suffix of a family model's attention rows: "" at Mistral's
    head_dim 128 and a group the phase-3 rows cover, "_g<G>" at another
    group, "_hd<hd>" at another head_dim with group 1 and "_hd<hd>g<G>"
    with another group: each a template instantiation of its own."""
    g, hd = cfg.group_size, cfg.head_dim
    if hd == 128:
        return "_g7" if g == 7 else ""
    return f"_hd{hd}" + (f"g{g}" if g != 1 else "")


def _fold(cfg, bias: bool) -> str:
    """The megakernel fold a family model exercises ("" for none)."""
    if bias:
        return "bias"
    if cfg.qk_norm:
        return "qk_norm"
    if cfg.post_norms:
        return "gemma2"
    return "gemma" if cfg.act == "gelu" else ""


def phase_parity_shape(cfg, cases: Cases, tag: str) -> None:
    """The attention kernels at a GQA group or head_dim of a family model
    against their plain versions on random planes at its shapes, the cases
    and tolerances of phase 3 (``attention_cases``, ``decode_q_cases``),
    recorded as ``<kernel><tag>`` (``_shape_tag``): kernels 3, 4 and 7 at
    group 7 (Qwen2.5-7B, tag ``_g7``), and kernels 2-7 at head_dim 256 with
    group 2 (Gemma-2-9B, ``_hd256g2``) and group 1 (Gemma-7B, ``_hd256``)
    and at 96 (Phi-3-mini, ``_hd96``): the ring inserts (``update_cases``,
    ``phase_parity_int8``) too."""
    import torch

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, cfg.max_seq_len, cfg.head_dim)
    ck, cv = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    inserts = tag.startswith("_hd")
    cexp, sexp = _sink_trig(cfg)
    if inserts:
        update_cases(cfg, cases, gen, ck, cv, cexp, sexp, tag)
    attention_cases(cfg, cases, gen, ck, cv, tag)
    del ck, cv
    torch.cuda.empty_cache()
    if inserts:
        phase_parity_int8(cfg, cases, gen, cexp, sexp, tag)
        return
    planes = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
              for _ in range(2)]
    planes += [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 for _ in range(2)]
    decode_q_cases(cfg, cases, planes, gen, cexp, sexp, tag)


def phase_main_family(params, cfg, name: str, runs, bias: bool) -> dict:
    """The main path of one family model (``_main_run``: a 512-token prompt
    and 64 greedy tokens): on the megakernel (per decode token one
    fused_decode launch, which counts under the model's fold too, and the
    bf16 head on qmatmul) and per layer (4L + 1 qmatmul, and per layer one
    flash_decode launch, or with an int8 cache one flash_decode_q launch,
    that inserts, re-rotates and attends; a bf16-cache prefill chunk
    runs flash_prefill per layer). With Gemma-2's attention softcap the
    per-layer attention and the prefill chunk take the dense attention (no
    flash_decode, flash_decode_q or flash_prefill launch), after the ring
    inserts (kv_update, or kv_update_q with an int8 cache). A head_dim the
    megakernel does not take (Phi-3's 96) decodes per layer on the default
    engine. Returns the runs' launches, summed."""
    import numpy as np
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(SEED).integers(3, cfg.vocab_size, size=512).tolist()
    L = cfg.n_layers
    fold = _fold(cfg, bias)
    folds = {f"fused_decode_{f}": int(f == fold or (f == "gemma" and fold == "gemma2"))
             for f in ("bias", "qk_norm", "gemma", "gemma2")}
    cap = bool(cfg.attn_softcap)
    launches = dict.fromkeys(build.LAUNCHES, 0)
    for run in runs:
        path = run.split()[-1]
        kv = torch.int8 if run.startswith("int8") else torch.bfloat16
        per_layer = ("kv_update_q", "flash_decode_q") if kv == torch.int8 else (
            "kv_update", "flash_decode")
        if path == "megakernel":
            kw, want = {}, {"fused_decode": 1, "qmatmul": 1, **folds}
        else:
            # the default engine where the gate sends the model per layer
            kw = {} if cfg.head_dim not in fd.HEAD_DIMS else dict(fused_step=False)
            inserts = L if cap else 0  # without the cap: in flash_decode(_q)'s launch
            want = {"qmatmul": 4 * L + 1, per_layer[0]: inserts, per_layer[1]: 0 if cap else L,
                    "fused_decode": 0, **dict.fromkeys(folds, 0)}
        eng = Engine(cfg, params, kv_dtype=kv, **kw)
        if eng.decode_path(1) != path:
            raise AssertionError(f"{name} {run}: decode path {eng.decode_path(1)!r}")
        row = _main_run(eng, cfg, prompt, f"{name} {run}")
        per_token, per_chunk = row["launches_per_decode_token"], row["launches_per_512_chunk"]
        chunk_ok = per_chunk["flash_prefill"] == (L if kv == torch.bfloat16 and not cap else 0)
        if any(per_token[k] != n for k, n in want.items()) or not chunk_ok:
            raise AssertionError(f"{name} {run}: {row['launches']}, per token {per_token}, per "
                                 f"chunk {per_chunk}: expected per token {want}")
        launches = {k: launches[k] + row["launches"][k] for k in launches}
        del eng
        torch.cuda.empty_cache()
    return launches


def phase_families(cases: Cases) -> dict:
    """Phases 3-5 for the models of FAMILIES, one model on the card at a
    time. Phase 3: the megakernel with the model's fold (Qwen2.5 the qkv
    bias at GQA group 7, Qwen3 the q/k norms, Gemma-2 its post-norms and
    both softcaps with Gemma's gelu and embed scale at head_dim 256) in the
    seven cases of the bf16 body (bf16 and int8 caches, B = 1 and 4, the
    embed and i8-head folds) at full depth, each beside its own floor, and
    one a8 and one q4 case held layer by layer (``phase_fused_parity``);
    Gemma-7B (gelu and the embed scale, group 1, q_dim 4096 != dim 3072) in
    two cases; the attention kernels at each model's (group, head_dim)
    that Mistral's rows do not cover (``phase_parity_shape``). Phase 4: the
    runs of FAMILIES (``phase_main_family``) on the model's first
    FAMILY_MAIN_LAYERS layers (full width). Phase 5: the i8 body with a bf16 cache on both
    decode paths with the fold in both models, Qwen2.5, Qwen3 and Gemma-2
    (``phase_wrap``). Llama-3.1's rope scaling changes no kernel, only the
    frequencies they are given: its main path checks it end to end.
    Returns the launches of the phase-4 runs, by model."""
    import torch

    from xalm_tpu_torch.models import config as configs
    from xalm_tpu_torch.models.params import recode_params_q4
    from xalm_tpu_torch.utils.synthetic import biting_softcaps, synthetic_params

    launches = {}
    for name, cfg_name, bias, q4_group, runs in FAMILIES:
        cfg = biting_softcaps(getattr(configs, cfg_name))
        t0 = time.perf_counter()
        params = synthetic_params(cfg, device=DEVICE, seed=SEED, qkv_bias=bias)
        torch.cuda.synchronize()
        emit({"phase": "weights", "model": name, "seconds": time.perf_counter() - t0,
              "gb": params.nbytes() / 1e9,
              "softcaps": [cfg.attn_softcap, cfg.logit_softcap]})
        fold = _fold(cfg, bias)
        tag = _shape_tag(cfg)
        with torch.inference_mode():
            if fold:
                kernel = f"fused_decode_{fold}"
                phase_fused_parity(params, cfg, cases, kernel=kernel,
                                   only=GEMMA_CASES if fold == "gemma" else ())
            if fold == "gemma":  # the f32 cache's instantiation with the Gemma folds, hd 256
                phase_fused_parity(params, cfg, cases, kernel="fused_decode_f32", only=(0,),
                                   cache=torch.float32, label=GEMMA_F32_LABEL)
            if q4_group:
                phase_fused_parity(params, cfg, cases, "a8", kernel=kernel, only=(FOLD_A8_CASE,))
                q4p = recode_params_q4(params, q4_group)
                phase_fused_parity(q4p, cfg, cases, "q4", kernel=kernel, only=(FOLD_Q4_CASE,))
                del q4p
                torch.cuda.empty_cache()
            if tag:
                phase_parity_shape(cfg, cases, tag)
        cfg4 = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, FAMILY_MAIN_LAYERS))
        launches[name] = phase_main_family(_layer_window(params, 0, cfg4.n_layers), cfg4, name,
                                           runs, bias)
        del params
        torch.cuda.empty_cache()
        if fold in ("bias", "qk_norm", "gemma2"):
            with torch.inference_mode():
                phase_wrap(cfg, bodies=WRAP_BODIES[:1], qkv_bias=bias, model=name)
    return launches


# ---------------------------------------------------------- weight formats
# Every weight format of the JAX package on the card: Mixtral-8x7B with
# packed-q4 experts (kernel 8's q4 branch), Mistral-7B with f32 weights and
# a 2-layer f32 Mixtral (the f32 branches of kernels 1 and 8), and f16 and
# fp8 containers through the load modes (f16 -> bf16, fp8 -> i8 rows).

NO_LIBRARY_MULTI_Q4 = ("no one PyTorch call gathers experts by an index on the device, nor "
                       "multiplies int8 activation codes by packed 4-bit weights with per-group "
                       "scales (see qmatmul_q4's note)")
NO_LIBRARY_MULTI_F32 = "no one PyTorch call gathers experts by an index on the device"
NO_LIBRARY_NORM = "no one PyTorch call applies the rmsnorm prologue and the product"
MULTI_Q4_W13_CASE = "w13 q4 g128, shared x, m=1, k=2"
MULTI_Q4_W2_CASE = "w2 q4 g128, per-expert x, m=1, k=2"
F32_W13_CASE = "M=1 w13 f32, norm prologue"
F32_M512_CASE = "M=512 w13 f32"
MULTI_F32_W13_CASE = "w13 f32, shared x, m=1, k=2 (2-layer stack)"
MULTI_F32_W2_CASE = "w2 f32, per-expert x, m=1, k=2 (2-layer stack)"
# f32 kernels against their plain versions: each output row within F32_TOL
# of its max |plain|. The GEMV multiplies in f32 FMA; the tiled GEMM (M > 8
# or x too wide for the GEMV) in split TF32 on the tensor cores, three TF32
# products a step (each within about 2^-18 of the f32 product; against f64
# as accurate as the f32 plain version: --kernel-ms), all summed in
# another order, with the norm prologue the rms too. TF32 is off for the
# plain versions and the library calls (F.linear), as main() sets it
F32_TOL = 1e-5
F32_WRAP_BODY = ("f32", "bfloat16", {}, False)
Q4_EXPERT_GROUP = 128  # Mixtral's q4 group: the JAX converter's default (--q4-group)
Q4_WRAP_WINDOW, Q4_WRAP_PROMPT, Q4_WRAP_STEPS = 128, 100, 300  # three wraps, as 256/200/600


def _dequant_params(params, dtype):
    """The same model with every weight dequantised to ``dtype`` (no scales):
    the copy models of the f32 wrap phase."""
    from xalm_tpu_torch.models.params import QWeight

    def dq(w):
        return None if w is None else QWeight(w.dequant(dtype).contiguous(), None)

    lp = params.layers
    layers = dataclasses.replace(lp, wqkv=dq(lp.wqkv), wo=dq(lp.wo), w13=dq(lp.w13), w2=dq(lp.w2),
                                 w13e=dq(lp.w13e), w2e=dq(lp.w2e))
    embed = dq(params.embed)
    wcls = embed if params.wcls is params.embed else dq(params.wcls)
    return dataclasses.replace(params, embed=embed, layers=layers, wcls=wcls)


def phase_parity_multi_q4(params, cfg, cases: Cases) -> None:
    """qmatmul_multi_q4 against its plain version at Mixtral-8x7B widths,
    bit-equal (tolerance 0: x's codes by IEEE division and round half to
    even, exact group dots, the f32 scale products and group sums rounded
    one by one in the same order), on the drawn packed 32-layer stacks
    viewed flat: w13 (256, 28672, 2048) and w2 (256, 4096, 7168) at group
    128, x shared by the k = 2 experts (w13) or a row per expert (w2), an
    index of 255 (its codes 15.0 GB into w13, 7.5 GB into w2), m = 4; and
    16 experts drawn at group 512 at both widths. The timed launches cycle
    over the 32 layers' experts, so each streams its weights cold."""
    import torch

    from xalm_tpu_torch.ops.qmatmul import qmatmul_multi, qmatmul_multi_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    lp = params.layers
    L, E, d, h, g = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.hidden_dim, lp.w13e.q4group
    flat = lambda qw: (qw.values.reshape(L * E, *qw.values.shape[2:]),  # noqa: E731
                       qw.scale.reshape(L * E, *qw.scale.shape[2:]))
    (w13v, w13s), (w2v, w2s) = flat(lp.w13e), flat(lp.w2e)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    per_layer = [i32(layer * E + 3, layer * E + 6) for layer in range(L)]

    def case(name, x, values, scale, group, idx_sets, shared):
        idxs = idx_sets[0]
        kw = dict(shared_x=shared, q4_group=group)
        got = qmatmul_multi(x, values, scale, idxs, **kw)
        want = qmatmul_multi_plain(x, values, scale, idxs, **kw)
        k = idxs.numel()
        m = x.shape[0] // (1 if shared else k)
        dd, nb = values.shape[1:]
        n = 2 * nb
        nbytes = k * (dd * nb + dd * (n // group) * 4) + x.numel() * 4 + k * m * dd * 4
        it = itertools.cycle(idx_sets)
        cases.add("qmatmul_multi_q4", name, got, want, dd, 0.0,
                  lambda: qmatmul_multi(x, values, scale, next(it), **kw),
                  lambda: qmatmul_multi_plain(x, values, scale, next(it), **kw),
                  None, nbytes, 2.0 * k * m * n * dd, PEAK_S8,
                  extra={"library_null": NO_LIBRARY_MULTI_Q4, "idxs": idxs.tolist(), "m": m,
                         "group": group, "weight_offset_bytes": int(idxs.max()) * dd * nb})

    x1 = torch.randn((1, d), generator=gen, device=dev) * 3
    x2 = torch.randn((2, h), generator=gen, device=dev) * 3
    case(MULTI_Q4_W13_CASE, x1, w13v, w13s, g, per_layer, True)
    case(MULTI_Q4_W2_CASE, x2, w2v, w2s, g, per_layer, False)
    case("w13 q4 g128, idxs [255, 3]: codes past 2^31 bytes", x1, w13v, w13s, g, [i32(255, 3)],
         True)
    case("w2 q4 g128, idxs [255, 128]: codes past 2^31 bytes", x2, w2v, w2s, g, [i32(255, 128)],
         False)
    case("w13 q4 g128, shared x, m=4, k=2", torch.randn((4, d), generator=gen, device=dev) * 3,
         w13v, w13s, g, per_layer, True)
    small = [i32(15, 2), i32(9, 12)]
    for name, rows, cols, x, shared in (("w13", 2 * h, d, x1, True), ("w2", d, h, x2, False)):
        v = torch.randint(-128, 128, (16, rows, cols // 2), dtype=torch.int8, device=dev,
                          generator=gen)
        sc = (torch.rand((16, rows, cols // 512), generator=gen, device=dev) * 0.5 + 0.75) * 3e-3
        case(f"{name} q4 g512, 16 experts, {'shared' if shared else 'per-expert'} x, m=1, k=2",
             x, v, sc, 512, small, shared)
        del v, sc
    torch.cuda.empty_cache()


def q4_moe_active_bytes(cfg, group: int, pos: int) -> int:
    """Bytes a B = 1 decode token at ``pos`` of a q4 Mixtral (q4 attention
    and experts, bf16 embed row and head, bf16 cache) reads and writes, from
    the shapes alone: the gathered k of E experts' packed rows and group
    scales, wqkv and wo, the router and norms in f32, the embed row, the
    head, and the cache rows read (kv_len = pos + 1 within the window) and
    written."""
    def q4(rows, cols):
        return rows * cols // 2 + rows * (cols // group) * 4

    L, d, h, v = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size
    k, e = cfg.n_experts_active, cfg.n_experts
    per_layer = (q4(cfg.q_dim + 2 * cfg.kv_dim, d) + q4(d, cfg.q_dim)
                 + k * (q4(2 * h, d) + q4(d, h)) + 4 * (e * d + 2 * d))
    cache = 2 * L * cfg.kv_dim * 2 * (min(pos + 1, cfg.max_seq_len) + 1)
    return L * per_layer + 2 * d + 4 * d + 2 * v * d + cache


def phase_main_moe_q4(params, cfg) -> dict:
    """The Mixtral q4 main path: ``Engine.generate`` of a 512-token prompt
    and 64 greedy tokens, bf16 cache, ``a8_decode`` (as
    ``from_xalm(q4_group=)`` implies): per decode token 64 qmatmul_multi_q4
    launches (the chosen experts' w13 and w2 per layer), 64 qmatmul_q4 (wqkv
    and wo), 1 qmatmul (the bf16 head), and one flash_decode launch per
    layer that inserts, re-rotates and attends. A 512-row prefill chunk dequantises wqkv and wo (q4 at 256 rows
    and more) and runs the dense-masked experts, each dequantised in bf16
    one at a time, as the reference's ``_expert_mat``. The active bytes of
    a token are held equal to ``q4_moe_active_bytes``."""
    import numpy as np
    import torch

    from xalm_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(SEED).integers(3, cfg.vocab_size, size=512).tolist()
    L = cfg.n_layers
    eng = Engine(cfg, params, kv_dtype=torch.bfloat16, a8_decode=True)
    if eng.decode_path(1) != "perlayer":
        raise AssertionError(f"Mixtral q4 decode path {eng.decode_path(1)!r}, expected 'perlayer'")
    want_bytes = q4_moe_active_bytes(cfg, params.layers.w13e.q4group, len(prompt))
    if eng.active_bytes(len(prompt)) != want_bytes:
        raise AssertionError(f"Mixtral q4 active bytes {eng.active_bytes(len(prompt))}, from the "
                             f"shapes {want_bytes}")
    row = _main_run(eng, cfg, prompt, "mixtral q4 g128 perlayer")
    want = {"qmatmul_multi_q4": 2 * L, "qmatmul_q4": 2 * L, "qmatmul": 1, "kv_update": 0,
            "flash_decode": L, "qmatmul_multi": 0, "fused_decode": 0, "fused_decode_q4": 0}
    per_token, per_chunk = row["launches_per_decode_token"], row["launches_per_512_chunk"]
    if (any(per_token[k] != n for k, n in want.items())
            or per_chunk["qmatmul_q4"] or per_chunk["qmatmul_multi_q4"]
            or row["launches"]["qmatmul_multi_q4"] != 63 * 2 * L):
        raise AssertionError(f"Mixtral q4 run: {row['launches']}, per token {per_token}, per "
                             f"chunk {per_chunk}: expected per token {want}")
    del eng
    torch.cuda.empty_cache()
    return {"launches": row["launches"], "active_gb": want_bytes / 1e9}


def phase_wrap_moe_q4(cfg) -> dict:
    """Phase 5 for the q4 Mixtral: full width, 2 layers, a Q4_WRAP_WINDOW-slot
    window, a Q4_WRAP_PROMPT-token prompt and Q4_WRAP_STEPS decode steps
    through three ring wraps (half the i8 Mixtral's: four engines step here,
    and the plain q4 experts unpack whole experts each step), bf16
    cache, ``a8_decode``, the per-layer kernels against the plain versions
    with tokens and routing teacher-forced (``_teacher_forced_moe``), every
    kernel step from the plain run's cache, held by the int8-activation
    rule of the q4 body in ``phase_wrap``: beside them the plain engine
    without int8 activations (its dense-masked experts and dequantised
    attention, the quant effect) and the control (the kernel engine without
    them), both following the lead's routing; then the copy model with q4
    experts (``moe_copy_params`` recoded at group 128), free-running."""
    import torch

    from xalm_tpu_torch.models.params import recode_params_q4
    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg2 = dataclasses.replace(cfg, n_layers=2, max_seq_len=Q4_WRAP_WINDOW)
    prompt = _moe_wrap_setup(cfg)[1][:Q4_WRAP_PROMPT]
    steps = Q4_WRAP_STEPS

    def engines(params, c=cfg2):
        return (Engine(c, params, kv_dtype=torch.bfloat16, matmul_impl="kernel", a8_decode=True),
                Engine(c, params, kv_dtype=torch.bfloat16, matmul_impl="plain", a8_decode=True))

    params = synthetic_params(cfg2, device=DEVICE, seed=SEED + 3, q4_group=Q4_EXPERT_GROUP)
    params.layers.wgate.mul_(WRAP_ROUTER_STD / SYNTHETIC_ROUTER_STD)
    ek, ep = engines(params)
    if ek.decode_path(1) != "perlayer":
        raise AssertionError(f"MoE q4 wrap phase: decode path {ek.decode_path(1)!r}")
    ep0 = Engine(cfg2, params, kv_dtype=torch.bfloat16, matmul_impl="plain")
    ec = Engine(cfg2, params, kv_dtype=torch.bfloat16, matmul_impl="kernel")
    build.reset_launches()
    forced = _teacher_forced_moe(ek, ep, prompt, steps, ep0, ec)
    forced["qmatmul_multi_q4_launches"] = build.LAUNCHES["qmatmul_multi_q4"]
    del params, ek, ep, ep0, ec
    torch.cuda.empty_cache()
    params, perm_inv = moe_copy_params(cfg2, SEED + 4)
    params = recode_params_q4(params, Q4_EXPERT_GROUP)
    copy = _copy_free_running(*engines(params), prompt, steps, perm_inv)
    row = {"phase": "wrap_moe", "model": "Mixtral-8x7B", "body": f"q4 g{Q4_EXPERT_GROUP}",
           "decode_path": "perlayer", "kv_dtype": "bfloat16", "layers": 2,
           "window": Q4_WRAP_WINDOW, "router_std": WRAP_ROUTER_STD, "prompt_tokens": len(prompt),
           "ring_wraps": _ring_wraps(copy["final_pos"], Q4_WRAP_WINDOW), "tol_rel": WRAP_TOL,
           "random_teacher_forced": forced, "copy_free_running": copy,
           "tokens_identical": copy["identical"]}
    emit(row)
    if row["ring_wraps"] < 3:
        raise AssertionError(f"MoE q4 wrap phase: {row['ring_wraps']} ring wraps, expected 3")
    forced_ok = (not forced["flips_beyond_margin"]
                 and forced["max_rel_logit_err"] <= max(WRAP_TOL,
                                                        forced["max_rel_logit_quant_effect"])
                 and forced["max_rel_logit_err_unquantised"] <= WRAP_TOL
                 and (forced["step_rule_ok"] or not forced["quant_steps"]))
    if forced["control"]["step_rule_ok"]:
        raise AssertionError(f"MoE q4 wrap phase: the step rule passes the control too: {forced}")
    if not forced_ok or forced["qmatmul_multi_q4_launches"] != steps * 2 * 2:
        raise AssertionError(f"MoE q4 wrap phase (teacher-forced): {forced}")
    if not row["tokens_identical"]:
        raise AssertionError(f"MoE q4 wrap phase (copy model): greedy tokens differ: {copy}")
    del params
    torch.cuda.empty_cache()
    return row


def phase_parity_f32(params, cfg, cases: Cases) -> None:
    """Kernel 1's f32 branch against its plain version at Mistral-7B
    widths, on the drawn f32 body (within F32_TOL of each output row's
    max): M = 1 wqkv and w13 with the norm prologue, wo, w2 and the f32 head
    (the GEMV, x staged as f32: 57 KB at w2's 14336 columns), M = 512 w13
    (the split-TF32 GEMM, bounded by its three TF32 products at PEAK_TF32,
    the f32 FMA bound beside). Library: ``F.linear`` in f32, TF32 off.
    Layers cycle so every launch streams its weights cold."""
    import torch
    import torch.nn.functional as F

    from xalm_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    lp = params.layers
    norm_w = torch.rand((cfg.n_layers, cfg.dim), generator=gen, device=dev) + 0.5

    def case(name, m, qw, use_norm, head=False):
        d, n = qw.values.shape[-2:]
        values = qw.values[None] if head else qw.values
        x = torch.randn((m, n), generator=gen, device=dev)
        kw = dict(norm_w=norm_w, norm_eps=cfg.norm_eps) if use_norm else {}
        got = qmatmul(x, values, 3 % values.shape[0], **kw)
        want = qmatmul_plain(x, values, 3 % values.shape[0], **kw)
        layers = itertools.cycle(range(values.shape[0]))
        lib_layers = itertools.cycle(range(values.shape[0]))
        lib = None if use_norm else (lambda: F.linear(x, values[next(lib_layers)]))
        nbytes = d * n * 4 + m * n * 4 + m * d * 4 + (n * 4 if use_norm else 0)
        flops, extra = 2.0 * m * n * d, {"library_null": NO_LIBRARY_NORM} if use_norm else {}
        tiled = m > 8  # the split-TF32 GEMM: three TF32 products a step
        if tiled:
            extra["bound_fma_ms"] = bound(nbytes, flops, PEAK_F32)[0]
        cases.add("qmatmul_f32", name, got, want, d, F32_TOL,
                  lambda: qmatmul(x, values, next(layers), **kw),
                  lambda: qmatmul_plain(x, values, next(layers), **kw),
                  lib, nbytes, 3 * flops if tiled else flops, PEAK_TF32 if tiled else PEAK_F32,
                  extra=extra or None)

    case("M=1 wqkv f32, norm prologue", 1, lp.wqkv, True)
    case(F32_W13_CASE, 1, lp.w13, True)
    case("M=1 wo f32", 1, lp.wo, False)
    case("M=1 w2 f32", 1, lp.w2, False)
    case("M=1 head f32", 1, params.wcls, False, head=True)
    case(F32_M512_CASE, 512, lp.w13, False)
    torch.cuda.empty_cache()


def phase_parity_multi_f32(params, cfg, cases: Cases) -> None:
    """Kernel 8's f32 branch against its plain version at Mixtral-8x7B
    widths on a 2-layer f32 stack (an f32 Mixtral at 32 layers is 187 GB),
    within F32_TOL of each output row's max: w13 with x shared, w2 with a
    row per expert."""
    import torch

    from xalm_tpu_torch.ops.qmatmul import qmatmul_multi, qmatmul_multi_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    lp = params.layers
    L, E, d, h = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.hidden_dim
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    per_layer = [i32(layer * E + 3, layer * E + 6) for layer in range(L)]
    for name, qw, x, shared in ((MULTI_F32_W13_CASE, lp.w13e, torch.randn((1, d), generator=gen,
                                                                          device=dev), True),
                                (MULTI_F32_W2_CASE, lp.w2e, torch.randn((2, h), generator=gen,
                                                                        device=dev), False)):
        values = qw.values.reshape(L * E, *qw.values.shape[2:])
        dd, n = values.shape[1:]
        m = x.shape[0] // (1 if shared else 2)
        got = qmatmul_multi(x, values, None, per_layer[0], shared_x=shared)
        want = qmatmul_multi_plain(x, values, None, per_layer[0], shared_x=shared)
        it = itertools.cycle(per_layer)
        cases.add("qmatmul_multi_f32", name, got, want, dd, F32_TOL,
                  lambda: qmatmul_multi(x, values, None, next(it), shared_x=shared),
                  lambda: qmatmul_multi_plain(x, values, None, next(it), shared_x=shared),
                  None, 2 * dd * n * 4 + x.numel() * 4 + 2 * m * dd * 4, 2.0 * 2 * m * n * dd,
                  PEAK_F32, extra={"library_null": NO_LIBRARY_MULTI_F32})


def phase_main_f32(params, cfg, label: str, want: dict) -> dict:
    """A main-path run of an f32 model (bf16 cache, the per-layer path: the
    megakernel needs an i8 body): ``want`` gives the launches per decode
    token. Returns the run's launches."""
    import numpy as np
    import torch

    from xalm_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(SEED).integers(3, cfg.vocab_size, size=512).tolist()
    eng = Engine(cfg, params, kv_dtype=torch.bfloat16)
    if eng.decode_path(1) != "perlayer":
        raise AssertionError(f"{label}: decode path {eng.decode_path(1)!r}, expected 'perlayer'")
    row = _main_run(eng, cfg, prompt, label)
    per_token = row["launches_per_decode_token"]
    if any(per_token[k] != n for k, n in want.items()):
        raise AssertionError(f"{label} run: {row['launches']}, per token {per_token}: expected "
                             f"per token {want}")
    del eng
    torch.cuda.empty_cache()
    return {"launches": row["launches"]}


def write_format_container(path: str, cfg, kind: str, seed: int) -> None:
    """A container of cfg's widths written by the port's writer: the body in
    ``kind`` (f16, or f8_e4m3 given as torch fp8), embed and head in f16 (the
    JAX converter's 16-bit boost of an fp8 body), f32 norms; random weights
    of std 0.02 drawn on the card from ``seed``."""
    import torch

    from xalm_tpu_torch.io import write_xalm

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    d, h, q, kv = cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim
    tdt = torch.float16 if kind == "f16" else torch.float8_e4m3fn

    def w(rows, cols, dt=tdt):
        return (torch.randn((rows, cols), generator=gen, device=DEVICE) * 0.02).to(dt).cpu()

    ones = torch.ones((d,), dtype=torch.float32)
    tensors = {}
    for i in range(cfg.n_layers):
        tensors.update({f"l.{i}.attn.norm.weight": ones, f"l.{i}.attn.q.weight": w(q, d),
                        f"l.{i}.attn.k.weight": w(kv, d), f"l.{i}.attn.v.weight": w(kv, d),
                        f"l.{i}.attn.down.weight": w(d, q), f"l.{i}.mlp.norm.weight": ones,
                        f"l.{i}.mlp.gate.weight": w(h, d), f"l.{i}.mlp.up.weight": w(h, d),
                        f"l.{i}.mlp.down.weight": w(d, h)})
    tensors.update({"embed.weight": w(cfg.vocab_size, d, torch.float16),
                    "output.weight": w(cfg.vocab_size, d, torch.float16),
                    "output.norm.weight": ones})
    config = {k: str(getattr(cfg, k)) for k in ("dim", "hidden_dim", "head_dim", "n_layers",
                                                "n_heads", "n_kv_heads", "vocab_size",
                                                "max_seq_len", "rope_theta", "rotary_dim",
                                                "norm_eps")}
    config["act_type"] = cfg.act
    write_xalm(path, "MistralForCausalLM", config, tensors)


def phase_load_modes(cfg) -> dict:
    """f16 and f8_e4m3 containers at Mistral-7B width, 2 layers (written by
    ``write_format_container`` into build/), loaded with
    ``Engine.from_xalm(device="cuda")`` and its "auto" modes: the f16 body
    and f16 head load as bf16 and decode per layer on kernel 1's bf16
    branch (4L + 1 qmatmul launches a token); the fp8 body loads as i8 rows
    and decodes on the i8 megakernel (one fused_decode launch a token), its
    f16 head as bf16 on kernel 1. Each: ``Engine.generate`` of a 512-token
    prompt and 64 tokens (the launches counted), then prefill and 64
    decode steps teacher-forced against ``matmul_impl="plain"`` on the same
    loaded params, every step's logits within WRAP_TOL of their max.
    Returns the launches of the generate runs, summed."""
    import numpy as np
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    L = cfg2.n_layers
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "formats")
    os.makedirs(out_dir, exist_ok=True)
    prompt = np.random.default_rng(SEED + 6).integers(3, cfg.vocab_size, size=512).tolist()
    launches = dict.fromkeys(build.LAUNCHES, 0)
    for kind, body, path, want in (
            ("f16", torch.bfloat16, "perlayer", {"qmatmul": 4 * L + 1, "fused_decode": 0}),
            ("f8_e4m3", torch.int8, "megakernel", {"fused_decode": 1, "qmatmul": 1})):
        file = os.path.join(out_dir, f"mistral_2l_{kind}.xalm")
        t0 = time.perf_counter()
        write_format_container(file, cfg2, kind, SEED + 11)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        ek = Engine.from_xalm(file, device=DEVICE)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        os.remove(file)
        lw = ek.params.layers
        name = lambda qw: str(qw.values.dtype).split(".")[-1]  # noqa: E731
        loaded = {n: name(getattr(lw, n)) for n in ("wqkv", "wo", "w13", "w2")}
        loaded.update(embed=name(ek.params.embed), head=name(ek.params.wcls))
        if (any(getattr(lw, n).values.dtype != body for n in ("wqkv", "wo", "w13", "w2"))
                or ek.params.wcls.values.dtype != torch.bfloat16 or ek.decode_path(1) != path):
            raise AssertionError(f"{kind} container: loaded {loaded}, decode path "
                                 f"{ek.decode_path(1)!r}; expected {body} body, bf16 head, {path}")
        build.reset_launches()
        out, _ = ek.generate(prompt, 64, stop_on_eos=False)
        torch.cuda.synchronize()
        run = dict(build.LAUNCHES)
        build.reset_launches()
        lk, ck, pos = ek.prefill(prompt, ek.new_cache(1))
        build.reset_launches()
        lk, ck = ek.decode(np.array([out[-1]]), np.array([pos], np.int32), ck)
        per_token = dict(build.LAUNCHES)
        if len(out) != 64 or any(per_token[k] != n for k, n in want.items()):
            raise AssertionError(f"{kind} container run: {run}, per token {per_token}: expected "
                                 f"per token {want}")
        ep = Engine(ek.cfg, ek.params, matmul_impl="plain")
        forced = _teacher_forced(ek, ep, prompt, 64)
        row = {"phase": "load_mode", "model": "Mistral-7B", "layers": L, "container": kind,
               "loaded": loaded, "decode_path": path, "write_s": t_write, "load_s": t_load,
               "launches": run, "launches_per_decode_token": per_token, "tol_rel": WRAP_TOL,
               "teacher_forced_vs_plain": forced}
        emit(row)
        if forced["max_rel_logit_err"] > WRAP_TOL:
            raise AssertionError(f"{kind} container: kernel against plain {forced}")
        launches = {k: launches[k] + run[k] for k in launches}
        del ek, ep
        torch.cuda.empty_cache()
    return {"launches": launches}


TOOLS_LAYERS = 2
TOOLS_PROMPT = 512  # tokens of the --profile completion's prompt
TOOLS_GEN = 64
TOOLS_PASSKEY_JUNK = 2000  # junk lines of the tokenizer's passkey prompt


def _write_safetensors(path: str, tensors: dict) -> None:
    """The safetensors layout (8-byte header length, JSON header, raw
    bytes) of bf16 torch tensors, written here without a library."""
    import torch

    header, at = {}, 0
    for k, t in tensors.items():
        header[k] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [at, at + t.nbytes]}
        at += t.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.int16).numpy().tobytes())


def _tools_hf_dir(root: str, cfg) -> str:
    """An HF directory of Mistral-7B-Instruct-v0.2's widths at TOOLS_LAYERS
    layers: its config.json, models/xalm-mini's tokenizer.json, and random
    bf16 weights of std 0.02 (norms near 1) drawn on the card from SEED."""
    import shutil

    import torch

    d = os.path.join(root, "build", "tools", "mistral_2l_hf")
    os.makedirs(d, exist_ok=True)
    config = {"architectures": ["MistralForCausalLM"], "model_type": "mistral",
              "hidden_size": cfg.dim, "intermediate_size": cfg.hidden_dim,
              "num_hidden_layers": TOOLS_LAYERS, "num_attention_heads": cfg.n_heads,
              "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
              "vocab_size": cfg.vocab_size, "max_position_embeddings": 32768,
              "rope_theta": 1e6, "rms_norm_eps": 1e-5, "hidden_act": "silu",
              "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
              "torch_dtype": "bfloat16"}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    shutil.copy(os.path.join(root, "models", "xalm-mini", "tokenizer.json"), d)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 21)
    dm, h, q, kv = cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=DEVICE) * 0.02).bfloat16().cpu()

    def norm():
        return (1 + 0.1 * torch.randn((dm,), generator=gen, device=DEVICE)).bfloat16().cpu()

    t = {"model.embed_tokens.weight": w(cfg.vocab_size, dm), "model.norm.weight": norm(),
         "lm_head.weight": w(cfg.vocab_size, dm)}
    for i in range(TOOLS_LAYERS):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": norm(), p + "self_attn.q_proj.weight": w(q, dm),
                  p + "self_attn.k_proj.weight": w(kv, dm),
                  p + "self_attn.v_proj.weight": w(kv, dm),
                  p + "self_attn.o_proj.weight": w(dm, q),
                  p + "post_attention_layernorm.weight": norm(),
                  p + "mlp.gate_proj.weight": w(h, dm), p + "mlp.up_proj.weight": w(h, dm),
                  p + "mlp.down_proj.weight": w(dm, h)})
    _write_safetensors(os.path.join(d, "model.safetensors"), t)
    return d


@contextlib.contextmanager
def _native_off(off: bool):
    """With ``off``, the native library unavailable to the port (as on a
    host without g++): the loader copies serially and prefaults nothing,
    the tokenizer takes the Python trie."""
    from xalm_tpu_torch import native

    saved = native._LIB, native._TRIED
    if off:
        native._LIB, native._TRIED = None, True
    try:
        yield
    finally:
        native._LIB, native._TRIED = saved


def _transfer_ms(params) -> dict[str, float]:
    """Each tensor of a host parameter tree copied onto the card, one
    ``.to`` at a time (synchronized): its name -> ms."""
    import torch

    per = {}

    def walk(x, name):
        if isinstance(x, torch.Tensor):
            t0 = time.perf_counter()
            x.to(DEVICE)
            torch.cuda.synchronize()
            per[name] = (time.perf_counter() - t0) * 1e3
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{name}.{f.name}")
    walk(params, "params")
    return per


def _resident_share(path: str) -> float:
    """The share of a file's pages in the page cache (``mincore`` over a
    private map of it, which reads nothing)."""
    import ctypes
    import mmap

    import numpy as np

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    try:
        n = (len(mm) + mmap.PAGESIZE - 1) // mmap.PAGESIZE
        vec = (ctypes.c_ubyte * n)()
        buf = ctypes.c_char.from_buffer(mm)
        rc = libc.mincore(ctypes.addressof(buf), len(mm), vec)
        del buf
    finally:
        mm.close()
    if rc != 0:
        raise OSError(ctypes.get_errno(), f"mincore on {path}")
    return float((np.frombuffer(vec, np.uint8) & 1).mean())


def _fs_type(path: str) -> str:
    """The type of the file system that holds ``path`` (/proc/self/mounts,
    the longest mount point above it)."""
    real, best = os.path.realpath(path), ("", "unknown")
    with open("/proc/self/mounts") as f:
        for line in f:
            fields = line.split()
            if len(fields) < 3:
                continue
            point = fields[1].encode().decode("unicode_escape")
            if (real == point or real.startswith(point.rstrip("/") + "/")) and (
                    len(point) > len(best[0])):
                best = (point, fields[2])
    return best[1]


def _evict(path: str) -> float:
    """Drop one file's pages from the page cache (``fsync``, then
    ``POSIX_FADV_DONTNEED`` on that file alone) and return the share of
    its pages still resident."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return _resident_share(path)


def _params_bit_equal(a, b) -> list[str]:
    """Names of the parameter tensors that differ between two ModelParams
    (dtype, shape or a bit)."""
    import torch

    bad = []
    # each element viewed as an integer of its size: -0.0 differs from 0.0,
    # and a NaN equals the same NaN
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

    def walk(x, y, name):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            same = (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.view(bits[x.element_size()]),
                                    y.view(bits[y.element_size()])))
            if not same:
                bad.append(name)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), getattr(y, f.name), f"{name}.{f.name}")
        elif x != y:
            bad.append(name)
    walk(a, b, "params")
    return bad


def phase_tools(cfg) -> dict:
    """The host tools on the card's machine (module docstring, item 9):
    converter, loader (serial against native), ``--profile`` harness, native
    tokenizer and ``bench_kernels``. Raises where a step fails."""
    import io

    import torch

    from xalm_tpu_torch import native
    from xalm_tpu_torch.convert import convert as cvt
    from xalm_tpu_torch.harness import bench_kernels
    from xalm_tpu_torch.harness import main as harness
    from xalm_tpu_torch.io import XalmFile
    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.tokenizer import Tokenizer

    t_phase = time.perf_counter()
    if native.load() is None:
        raise AssertionError("the native library did not build or load (native/*.cpp, g++)")
    root = os.path.dirname(os.path.abspath(__file__))
    row = {"phase": "tools", "model": "Mistral-7B-Instruct-v0.2 widths", "layers": TOOLS_LAYERS,
           "card": _smi_line(), "native_library": str(native.library_path())}
    t0 = time.perf_counter()
    hf = _tools_hf_dir(root, cfg)
    row["hf_write_s"] = time.perf_counter() - t0
    out = os.path.join(root, "build", "tools", "mistral_2l_i8.xalm")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cvt.main(["--input", hf, "--output", out, "--type", "i8"])
    row["convert_i8_s"] = time.perf_counter() - t0
    row["container_gb"] = os.path.getsize(out) / 1e9
    if rc != 0:
        raise AssertionError(f"converter exited {rc}")

    # the file was just written, so every read here is warm (page cache).
    # Serial turns make the native library unavailable (_native_off), as on
    # a host without g++. Each turn loads onto the card (Engine.from_xalm),
    # then in two parts: load_params onto the host alone (prefault, stacks,
    # fusing and casts) and that host tree's transfer onto the card, tensor
    # by tensor, twice (the second from pages the first already read).
    from xalm_tpu_torch.models.config import ModelConfig
    from xalm_tpu_torch.models.params import load_params

    turns = ("serial", "native", "native", "serial", "serial", "native", "native", "serial")
    keys = ("load", "host_load", "transfer", "transfer_again")
    loads = {f"{k}_{m}_s": [] for k in keys for m in ("serial", "native")}
    params = {}
    for mode in turns:
        with _native_off(mode == "serial"):
            t0 = time.perf_counter()
            eng = Engine.from_xalm(out, device=DEVICE, progress=False)
            torch.cuda.synchronize()
            loads[f"load_{mode}_s"].append(time.perf_counter() - t0)
            params.setdefault(mode, eng.params)
            del eng
            t0 = time.perf_counter()
            with XalmFile(out) as xf:
                xf.prefault()
                host = load_params(xf, ModelConfig.from_metadata(xf.config), device="cpu")
            loads[f"host_load_{mode}_s"].append(time.perf_counter() - t0)
        for key in ("transfer", "transfer_again"):
            per = _transfer_ms(host)
            loads[f"{key}_{mode}_s"].append(sum(per.values()) / 1e3)
            row.setdefault(f"{key}_{mode}_by_tensor_ms", per)
        del host
    bad = _params_bit_equal(params["serial"], params["native"])
    row.update(loads, load_params_bit_equal=not bad)
    del params
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"read_stack parameters differ from the serial load's: {bad[:5]}")
    for mode in ("serial", "native"):  # the largest weight's stack alone
        with _native_off(mode == "serial"), XalmFile(out) as xf:
            names = [f"l.{i}.mlp.gate.weight" for i in range(TOOLS_LAYERS)]
            t0 = time.perf_counter()
            xf.prefault()
            row[f"prefault_{mode}_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            stack = xf.read_stack(names)
            row[f"read_stack_{mode}_gb_s"] = stack.nbytes / (time.perf_counter() - t0) / 1e9
            del stack
    # cold loads onto the card: the container's pages evicted from the page
    # cache (this file only: fsync, then POSIX_FADV_DONTNEED) before each
    # load, timed only where the eviction holds (under 5 % of the file's
    # pages resident; a memory-backed file system keeps them all)
    row["container_fs"] = _fs_type(out)
    row["evicted_resident_share"] = _evict(out)
    if row["evicted_resident_share"] < 0.05:
        for mode in ("serial", "native", "native", "serial"):
            share = _evict(out)
            with _native_off(mode == "serial"):
                t0 = time.perf_counter()
                eng = Engine.from_xalm(out, device=DEVICE, progress=False)
                torch.cuda.synchronize()
                row.setdefault(f"cold_load_{mode}_s", []).append(time.perf_counter() - t0)
                row.setdefault(f"cold_resident_share_{mode}", []).append(share)
                del eng
        torch.cuda.empty_cache()

    with XalmFile(out) as xf:
        tok = Tokenizer.from_xalm(xf)
    if tok._native is None:
        raise AssertionError("the tokenizer did not take the native trie")
    words = ("the quick brown fox jumps over the lazy dog while a model reads its prompt "
             "one token after another ").split()
    text, n = "", 0
    while n < TOOLS_PROMPT:
        text += " ".join(words) + " "
        n = len(tok.encode(text))
    text = tok.decode(tok.encode(text)[:TOOLS_PROMPT])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = harness.main([out, "-d", DEVICE, "-m", "c", "-i", text, "-n", str(TOOLS_GEN),
                           "--profile"])
    row["profile_run_s"] = time.perf_counter() - t0
    got = buf.getvalue()
    report = got[got.index("profiler report"):] if "profiler report" in got else ""
    spans = {}
    for line in report.splitlines():
        cells = [c.strip() for c in line.strip("|").split("|")]
        if len(cells) == 4 and cells[0] in ("model load", "completion"):
            spans[cells[0]] = {"calls": int(cells[1]), "total_ms": float(cells[2])}
    enc = [ln for ln in got.splitlines() if ln.startswith("Encoding stats")]
    row.update(profile_spans=spans, profile_encoding=enc[0] if enc else None,
               profile_usage_table="process usage" in got,
               profile_decode_path=[ln.strip() for ln in got.splitlines()
                                    if "decode path:" in ln])
    if rc != 0 or set(spans) != {"model load", "completion"} or "process usage" not in got:
        raise AssertionError(f"--profile run: rc {rc}, spans {spans}; output tail {got[-2000:]}")

    from xalm_tpu_torch.harness.main import build_passkey_prompt

    prompt = build_passkey_prompt(TOOLS_PASSKEY_JUNK, TOOLS_PASSKEY_JUNK // 2, 12345)
    t0 = time.perf_counter()
    ids_native = tok.encode(prompt)
    row["encode_native_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids_python = tok.encode_python(prompt.encode("utf-8"))
    row["encode_python_s"] = time.perf_counter() - t0
    row.update(encode_chars=len(prompt), encode_tokens=len(ids_native),
               encode_ids_equal=ids_native == ids_python)
    if ids_native != ids_python:
        raise AssertionError("the native trie's ids differ from the Python trie's")

    with torch.inference_mode():
        bench = bench_kernels.run(bandwidth=True, bandwidth2=True, kernel="all")
    row["bench_kernels"] = [{k: r[k] for k in ("case", "ms", "gb_s", "share", "layers")}
                            for r in bench]
    row["build_cache_stats"] = build.cache_stats()
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    os.remove(out)
    return row


def phase_formats(cases: Cases) -> dict:
    """The weight formats' phases 3-5, one model at a time: Mixtral-8x7B q4
    (drawn packed at group 128, 24.6 GB), Mistral-7B f32 (28.5 GB), a
    2-layer f32 Mixtral, the f32 wrap, and the load modes. Returns the
    main-path launches of each run by name."""
    import torch

    from xalm_tpu_torch.models.config import MISTRAL_7B, MIXTRAL_8X7B
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    runs = {}
    cfg = MIXTRAL_8X7B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = synthetic_params(cfg, device=DEVICE, seed=SEED, q4_group=Q4_EXPERT_GROUP)
    torch.cuda.synchronize()
    emit({"phase": "weights", "model": f"Mixtral-8x7B q4 g{Q4_EXPERT_GROUP}", "seconds":
          time.perf_counter() - t0, "gb": params.nbytes() / 1e9,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    with torch.inference_mode():
        phase_parity_multi_q4(params, cfg, cases)
    runs["mixtral_q4"] = phase_main_moe_q4(params, cfg)
    del params
    torch.cuda.empty_cache()
    with torch.inference_mode():
        phase_wrap_moe_q4(cfg)

    cfg = MISTRAL_7B
    t0 = time.perf_counter()
    params = synthetic_params(cfg, device=DEVICE, seed=SEED, weight_dtype=torch.float32,
                              embed_dtype=torch.float32)
    torch.cuda.synchronize()
    emit({"phase": "weights", "model": "Mistral-7B f32", "seconds": time.perf_counter() - t0,
          "gb": params.nbytes() / 1e9})
    with torch.inference_mode():
        phase_parity_f32(params, cfg, cases)
    L = cfg.n_layers
    runs["mistral_f32"] = phase_main_f32(params, cfg, "mistral f32 perlayer", {
        "qmatmul_f32": 4 * L + 1, "qmatmul": 0, "kv_update": 0, "flash_decode": L,
        "fused_decode": 0})
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=2)
    params = synthetic_params(cfg, device=DEVICE, seed=SEED, weight_dtype=torch.float32)
    with torch.inference_mode():
        phase_parity_multi_f32(params, cfg, cases)
    runs["mixtral_f32_2l"] = phase_main_f32(params, cfg, "mixtral f32 2 layers perlayer", {
        "qmatmul_multi_f32": 4, "qmatmul_f32": 4, "qmatmul": 1, "qmatmul_multi": 0})
    del params
    torch.cuda.empty_cache()
    with torch.inference_mode():
        phase_wrap(MISTRAL_7B, bodies=[F32_WRAP_BODY])
    runs["load_modes"] = phase_load_modes(MISTRAL_7B)
    return {name: r["launches"] for name, r in runs.items()}


# ------------------------------------------------ f32 cache, fp8 weights
# Kernels 2-4 and the megakernel over an f32 cache (their f32
# instantiations), and kernel 1's and kernel 8's fp8 branch.

# f32 flash-prefill: f32 values throughout, both products in split TF32
# (each within about 2^-18 of the f32 product), sums in another order
F32_CACHE_TOL = 1e-5
# the shapes of kernels 2-4's f32 rows beside Mistral-7B's (config name,
# case label); their planes hold the model's first 8 layers
F32_CACHE_SHAPES = (("QWEN2_5_7B", " (Qwen2.5-7B shapes, G=7)"),
                    ("GEMMA_7B", " (Gemma-7B shapes, hd 256)"),
                    ("PHI3_MINI_4K", " (Phi-3-mini shapes, hd 96)"))
FP8_TOL = 1e-4  # as the bf16 weights: exact products summed in another order
NO_LIBRARY_FP8 = ("no one PyTorch call widens fp8 weights to bf16 inside a product with bf16 "
                  "activations (torch._scaled_mm takes fp8 activations with scales)")
NO_LIBRARY_UPDATE = "no one PyTorch call inserts a row and rotates the sinks"
# why no library call stands beside the decode step's update and attention
# (SDPA's time over the same rows, the attention alone, stands beside it)
NO_LIBRARY_FUSED = ("no one PyTorch call inserts a row, rotates the sinks and attends; "
                    "sdpa_attention_ms times SDPA over the same rows, the attention alone")


def phase_parity_f32_cache(params, q4p, cfg, cases: Cases) -> None:
    """The f32-cache kernels against their plain versions on random f32
    planes: kernels 2-4 (``kv_update_f32``, ``flash_decode_f32``,
    ``flash_prefill_f32``: the cases and tolerances of ``update_cases`` and
    ``attention_cases``, flash-prefill within F32_CACHE_TOL) at Mistral-7B's
    shapes (G = 4) and at those of F32_CACHE_SHAPES (G = 7, head_dim 256
    and 96; the ring insert at the head dims only); then the megakernel
    (``fused_decode_f32``) at full width and 32 layers: the i8 body in
    phase 3's first two bf16-body cases, the a8 and q4 (group 512) bodies in
    their first case, held as ``phase_fused_parity`` holds the bf16 cache."""
    import torch

    from xalm_tpu_torch.models import config as configs

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    shapes = [(cfg, "")] + [(dataclasses.replace(getattr(configs, name), n_layers=8), label)
                            for name, label in F32_CACHE_SHAPES]
    for c, label in shapes:
        shape = (c.n_layers, 1, c.n_kv_heads, c.max_seq_len, c.head_dim)
        ck, cv = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
        if c.head_dim != 128 or not label:
            cexp, sexp = _sink_trig(c)
            update_cases(c, cases, gen, ck, cv, cexp, sexp, "_f32", label)
        attention_cases(c, cases, gen, ck, cv, "_f32", label)
        del ck, cv
        torch.cuda.empty_cache()
    f32 = dict(kernel="fused_decode_f32", cache=torch.float32)
    phase_fused_parity(params, cfg, cases, only=(0, 1), **f32)
    phase_fused_parity(params, cfg, cases, "a8", only=(0,), **f32)
    phase_fused_parity(q4p, cfg, cases, "q4", only=(0,), **f32)


def phase_parity_fp8(cfg, cases: Cases) -> None:
    """Kernel 1's fp8 branch (``qmatmul_fp8``) against its plain version at
    Mistral-7B's w13 widths (Mixtral-8x7B's too), on a 4-layer stack drawn
    on the card (unit normals times 0.05, rounded to e4m3 or e5m2: normal
    and subnormal codes), within FP8_TOL of each row's max: M = 1 (the GEMV,
    16 codes a 16-byte load) and 512 (the tiled GEMM); and kernel 8's
    (``qmatmul_multi_fp8``), the same stack as four experts, x shared,
    m = 1, k = 2. The forward sends fp8 weights to neither (the JAX
    ``_pallas_ok``): these launches are phase 3's only."""
    import torch

    from xalm_tpu_torch.ops.qmatmul import qmatmul, qmatmul_multi, qmatmul_multi_plain, qmatmul_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    d, n = 2 * cfg.hidden_dim, cfg.dim
    for fmt, dt in (("e4m3", torch.float8_e4m3fn), ("e5m2", torch.float8_e5m2)):
        w = (torch.randn((4, d, n), generator=gen, device=dev) * 0.05).to(dt)
        for m in (1, 512):
            x = torch.randn((m, n), generator=gen, device=dev)
            got, want = qmatmul(x, w, 1), qmatmul_plain(x, w, 1)
            layers = itertools.cycle(range(4))
            cases.add("qmatmul_fp8", f"M={m} w13 {fmt}", got, want, d, FP8_TOL,
                      lambda: qmatmul(x, w, next(layers)),
                      lambda: qmatmul_plain(x, w, next(layers)),
                      None, d * n + 4 * m * (n + d), 2.0 * m * n * d, PEAK_BF16,
                      extra={"library_null": NO_LIBRARY_FP8})
        x = torch.randn((1, n), generator=gen, device=dev)
        idx = [torch.tensor(v, dtype=torch.int32, device=dev) for v in ((1, 3), (0, 2))]
        got, want = qmatmul_multi(x, w, None, idx[0]), qmatmul_multi_plain(x, w, None, idx[0])
        it = itertools.cycle(idx)
        cases.add("qmatmul_multi_fp8", f"w13 {fmt}, shared x, m=1, k=2 (4-expert stack)", got,
                  want, d, FP8_TOL, lambda: qmatmul_multi(x, w, None, next(it)),
                  lambda: qmatmul_multi_plain(x, w, None, next(it)),
                  None, 2 * d * n + 4 * n + 2 * 4 * d, 2.0 * 2 * n * d, PEAK_BF16,
                  extra={"library_null": NO_LIBRARY_MULTI_F32})
        del w
        torch.cuda.empty_cache()


SUMMARY = {
    # kernel: (route, source, replaces, representative parity case)
    "qmatmul": ("cuda", "xalm_tpu_torch/csrc/qmatmul.cu", "xalm_tpu/ops/pallas_matmul.py:98",
                "M=1 w2 i8, row scale"),
    "kv_update": ("cuda", "xalm_tpu_torch/csrc/attention.cu", "xalm_tpu/ops/pallas_attention.py:501",
                  "insert at a wrapped row + sink rotation"),
    "flash_decode": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                     "xalm_tpu/ops/pallas_attention.py:273", "B=1 kv_len=777"),
    "flash_prefill": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                      "xalm_tpu/ops/pallas_attention.py:555", "T=512 pos=0"),
    "fused_decode": ("cuda", "xalm_tpu_torch/csrc/fused_decode.cu",
                     "xalm_tpu/ops/fused_decode.py:106", "B=1 kv_len=520, embed fold"),
    # one launch does the insert (_insert_q_kernel) and the sink rotation
    # (_sink_q_kernel, pallas_attention.py:141)
    "kv_update_q": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                    "xalm_tpu/ops/pallas_attention.py:104", "wrapped insert + sink rotation"),
    "flash_decode_q": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                       "xalm_tpu/ops/pallas_attention.py:205", "B=1 kv_len=777"),
    "qmatmul_multi": ("cuda", "xalm_tpu_torch/csrc/qmatmul.cu",
                      "xalm_tpu/ops/pallas_matmul.py:323", MULTI_W13_CASE),
    # the same TPU kernel's packed-q4 and W8A8 branches
    "qmatmul_q4": ("cuda", "xalm_tpu_torch/csrc/qmatmul.cu", "xalm_tpu/ops/pallas_matmul.py:116",
                   "M=1 w13 q4 g512"),
    "qmatmul_a8": ("cuda", "xalm_tpu_torch/csrc/qmatmul.cu", "xalm_tpu/ops/pallas_matmul.py:161",
                   "M=512 w13 i8"),
    # the megakernel's a8 body (_a8dot) and q4 body (_q4dot)
    "fused_decode_a8": ("cuda", "xalm_tpu_torch/csrc/fused_decode.cu",
                        "xalm_tpu/ops/fused_decode.py:377", "a8 B=1 kv_len=520, embed fold"),
    "fused_decode_q4": ("cuda", "xalm_tpu_torch/csrc/fused_decode.cu",
                        "xalm_tpu/ops/fused_decode.py:391", "q4 B=1 kv_len=520, embed fold"),
    # the megakernel's family folds: the Qwen2 qkv bias (Qwen2.5-7B widths)
    # and the Qwen3 q/k norms (Qwen3-8B widths)
    "fused_decode_bias": ("cuda", "xalm_tpu_torch/csrc/fused_decode.cu",
                          "xalm_tpu/ops/fused_decode.py:497", "B=1 kv_len=520, embed fold"),
    "fused_decode_qk_norm": ("cuda", "xalm_tpu_torch/csrc/fused_decode.cu",
                             "xalm_tpu/ops/fused_decode.py:518", "B=1 kv_len=520, embed fold"),
    # kernels 3, 4 and 7 at GQA group 7 (Qwen2.5-7B shapes)
    "flash_decode_g7": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                        "xalm_tpu/ops/pallas_attention.py:273", "B=1 kv_len=777"),
    "flash_prefill_g7": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                         "xalm_tpu/ops/pallas_attention.py:555", "T=512 pos=0"),
    "flash_decode_q_g7": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                          "xalm_tpu/ops/pallas_attention.py:205", "B=1 kv_len=777"),
    # the megakernel's Gemma folds: gelu and the embed scale (Gemma-7B
    # widths), and with them Gemma-2's post-norms and softcaps (Gemma-2-9B)
    "fused_decode_gemma": ("cuda", "xalm_tpu_torch/csrc/fused_decode.cu",
                           "xalm_tpu/ops/fused_decode.py:943", "B=1 kv_len=520, embed fold"),
    "fused_decode_gemma2": ("cuda", "xalm_tpu_torch/csrc/fused_decode.cu",
                            "xalm_tpu/ops/fused_decode.py:789", "B=1 kv_len=520, embed fold"),
    # the weight formats: kernel 8's q4 branch (Mixtral-8x7B q4), the f32
    # branches of kernels 1 (Mistral-7B f32) and 8 (a 2-layer f32 Mixtral)
    "qmatmul_multi_q4": ("cuda", "xalm_tpu_torch/csrc/qmatmul.cu",
                         "xalm_tpu/ops/pallas_matmul.py:350", MULTI_Q4_W13_CASE),
    "qmatmul_f32": ("cuda", "xalm_tpu_torch/csrc/qmatmul.cu", "xalm_tpu/ops/pallas_matmul.py:151",
                    F32_W13_CASE),
    "qmatmul_multi_f32": ("cuda", "xalm_tpu_torch/csrc/qmatmul.cu",
                          "xalm_tpu/ops/pallas_matmul.py:348", MULTI_F32_W13_CASE),
    # the f32 cache: kernels 2-4 and the megakernel (Mistral-7B's shapes)
    "kv_update_f32": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                      "xalm_tpu/ops/pallas_attention.py:501",
                      "insert at a wrapped row + sink rotation"),
    "flash_decode_f32": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                         "xalm_tpu/ops/pallas_attention.py:273", "B=1 kv_len=777"),
    "flash_prefill_f32": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                          "xalm_tpu/ops/pallas_attention.py:555", "T=512 pos=0"),
    "fused_decode_f32": ("cuda", "xalm_tpu_torch/csrc/fused_decode_f32.cu",
                         "xalm_tpu/ops/fused_decode.py:106", "B=1 kv_len=520, embed fold"),
    # the fp8 branch of kernel 1 (_f8_to_bf16) and, through its GEMV core, kernel 8
    "qmatmul_fp8": ("cuda", "xalm_tpu_torch/csrc/qmatmul.cu", "xalm_tpu/ops/pallas_matmul.py:149",
                    "M=1 w13 e4m3"),
    "qmatmul_multi_fp8": ("cuda", "xalm_tpu_torch/csrc/qmatmul.cu",
                          "xalm_tpu/ops/pallas_matmul.py:149",
                          "w13 e4m3, shared x, m=1, k=2 (4-expert stack)"),
}
# counters that no main path launches: the forward sends fp8 weights to the
# plain product, as the JAX _pallas_ok does; these kernels run in phase 3
OFF_MAIN_PATH = {k: "fp8 weights take the plain product on every path (the JAX _pallas_ok); "
                    "the kernel is reached through qmatmul / qmatmul_multi, phase 3"
                 for k in ("qmatmul_fp8", "qmatmul_multi_fp8")}
# kernels 2-7 at head_dim 256 (Gemma-7B shapes, group 1) and 96 (Phi-3-mini),
# and the ring insert at Gemma-2-9B's (group 2; its only attention kernel)
SUMMARY.update({k + tag: SUMMARY[k] for tag in ("_hd256", "_hd96") for k in ATTENTION_KERNELS})
SUMMARY["kv_update_hd256g2"] = SUMMARY["kv_update"]
SUMMARY["kv_update_q_hd256g2"] = SUMMARY["kv_update_q"]
# the ring inserts at the shapes of models without the attention cap:
# checked in phase 3, launched by no main path
OFF_MAIN_PATH.update(dict.fromkeys(
    ("kv_update_q_hd256", "kv_update_q_hd96"),
    "without Gemma-2's attention cap the int8 per-layer step inserts in flash_decode_q's launch "
    "(kernels 5-7 in one); kv_update_q runs on Gemma-2-9B's capped path (kv_update_q_hd256g2)"))
OFF_MAIN_PATH.update(dict.fromkeys(
    ("kv_update_hd256", "kv_update_hd96", "kv_update_f32"),
    "without Gemma-2's attention cap the float per-layer step inserts in flash_decode's launch "
    "(kernels 2-3 in one: fused_decode_attention); kv_update runs on Gemma-2-9B's capped path "
    "(kv_update_hd256g2)"))
# further rows of the kernels line: another TPU kernel a launch replaces,
# and the megakernel's int8-KV branch (the fused_decode launches count both)
ALSO_REPLACES = {"kv_update_q": "xalm_tpu/ops/pallas_attention.py:141",
                 "flash_decode_q": "xalm_tpu/ops/pallas_attention.py:104 and :141 (kernels 5-6, "
                                   "in the same launch: fused_decode_attention_q)"}
ALSO_REPLACES.update(dict.fromkeys(
    ("flash_decode", "flash_decode_g7", "flash_decode_hd256", "flash_decode_hd96",
     "flash_decode_f32"),
    "xalm_tpu/ops/pallas_attention.py:501 (kernel 2, in the same launch: fused_decode_attention)"))
INT8_CASE = dict.fromkeys(("fused_decode", "fused_decode_bias", "fused_decode_qk_norm",
                           "fused_decode_gemma", "fused_decode_gemma2"),
                          "int8 KV, B=1 kv_len=520, embed fold")
# a further case of the kernels line: the down projection of the experts
ALSO_CASE = {"qmatmul": ("M=512 w13 i8, row scale",) + TILED_CASES + SPEC_CASES
             + SERVE_TILED_CASES + PARALLEL_MM_CASES,
             "flash_prefill": (SPEC_PREFILL_CASE, SERVE_PREFILL_CASE, "T=512 pos=0" + PARALLEL_LABEL),
             "flash_decode": "B=1 kv_len=777" + PARALLEL_LABEL,
             "flash_decode_q": "B=1 kv_len=777" + PARALLEL_LABEL,
             "qmatmul_a8": PARALLEL_A8_CASES,
             "qmatmul_multi": MULTI_W2_CASE, "qmatmul_multi_q4": MULTI_Q4_W2_CASE,
             "qmatmul_f32": F32_M512_CASE, "qmatmul_multi_f32": MULTI_F32_W2_CASE,
             "flash_prefill_f32": ("T=512 pos=1024", "T=512 pos=0" + F32_CACHE_SHAPES[1][1]),
             "flash_decode_f32": tuple("B=1 kv_len=777" + lb for _, lb in F32_CACHE_SHAPES),
             "fused_decode_f32": ("a8 B=1 kv_len=520, embed fold",
                                  "q4 B=1 kv_len=520, embed fold",
                                  "B=1 kv_len=520, embed fold" + GEMMA_F32_LABEL),
             "qmatmul_fp8": ("M=512 w13 e4m3", "M=1 w13 e5m2", "M=512 w13 e5m2")}


def kernels_line(cases: Cases, launches: dict) -> list[dict]:
    """The kernels line: for each row of SUMMARY, its representative parity
    case's times and bound, the largest error of all its cases, and its
    launches on the main paths."""
    kernels = []
    for kname, (route, src, replaces, rep) in SUMMARY.items():
        rows = [r for r in cases.rows if r["kernel"] == kname]
        r = next(r for r in rows if r["case"] == rep)
        entry = {
            "name": kname, "route": route, "source": src, "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "case": rep,
        }
        if kname in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[kname]
        if r["library_ms"] is None and "library_null" in r:
            entry["library_null"] = r["library_null"]
        if kname in OFF_MAIN_PATH:
            entry["off_main_path"] = OFF_MAIN_PATH[kname]
        also = ALSO_CASE.get(kname, ())
        for case in (also,) if isinstance(also, str) else also:
            q = next(x for x in rows if x["case"] == case)
            entry.setdefault("also_cases", []).append({
                "case": q["case"], "ms": q["kernel_ms"], "plain_ms": q["plain_ms"],
                "bound_ms": q["bound_ms"], "bound_by": q["bound_by"],
                "library_ms": q["library_ms"]})
        if kname in INT8_CASE:
            q = next(x for x in rows if x["case"] == INT8_CASE[kname])
            entry["int8_kv"] = {"case": q["case"], "ms": q["kernel_ms"], "plain_ms": q["plain_ms"],
                                "bound_ms": q["bound_ms"], "bound_by": q["bound_by"]}
        kernels.append(entry)
    return kernels


def _device_profile(fn, iters: int):
    """torch.profiler's record of ``iters`` calls of fn, the session primed
    as in ``phase_profile`` (spin kernels, then a pause)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PRIMES):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def kernel_device_ms(fn, frag: str, iters: int = 20) -> float | str:
    """The device time of one launch of the kernels whose name holds
    ``frag``, over ``iters`` calls of fn under torch.profiler
    (``_device_profile``); "not measured" unless the profile holds a record
    of every launch."""
    from torch.autograd import DeviceType

    us, n = 0.0, 0
    for evt in _device_profile(fn, iters).key_averages():
        if evt.device_type == DeviceType.CUDA and frag in evt.key:
            us += _device_us(evt)
            n += evt.count
    return us / 1e3 / n if n == iters and us > 0 else "not measured"


def call_device_ms(fn, iters: int = 20) -> float | str:
    """The device time of one call of fn, every kernel (and copy or fill) it
    launches, over ``iters`` calls under torch.profiler (the primes' spin
    kernels left out); "not measured" unless the profile holds any."""
    from torch.autograd import DeviceType

    us = sum(_device_us(evt) for evt in _device_profile(fn, iters).key_averages()
             if evt.device_type == DeviceType.CUDA and "spin_kernel" not in evt.key)
    return us / 1e3 / iters if us > 0 else "not measured"


# _megakernel_bit_equal's positions: row b of a step of B rows sits at
# MK_BIT_EQUAL_POS[b] (B = 8: both ends of the window, a wrapped row with
# its sink rotation, and one at the kv_pos == S sentinel)
MK_BIT_EQUAL_POS = (519, 3, 100, 4095, 777, 1, 2047, 4200)
MK_BIT_EQUAL_BATCHES = (1, 8)


def _megakernel_bit_equal(trees, p, cfg, body, a8, freqs, c1, s1) -> dict:
    """One step of both trees' megakernels on the same inputs, with the
    embed and i8 head folds, at B = 1 and 8 (MK_BIT_EQUAL_POS), over a bf16
    cache and an int8 cache (codes and row scales) of random rows from the
    seed: x, the logits, the tokens and every cache plane (the rows written
    at kv_pos, the scales) bit for bit. Raises, naming the body and batch,
    on the first difference; returns what was compared."""
    import torch

    from xalm_tpu_torch.models.params import recode_wcls_i8
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices

    dev = torch.device(DEVICE)
    ph = recode_wcls_i8(p)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    compared = {}
    for b in MK_BIT_EQUAL_BATCHES:
        pos = torch.tensor(MK_BIT_EQUAL_POS[:b], dtype=torch.int32)
        _, kv_pos, kv_len = ring_indices(pos, cfg.max_seq_len)
        rot = (pos >= cfg.max_seq_len).to(torch.int32)
        if b > 1:
            kv_pos[1], rot[1] = cfg.max_seq_len, 0  # the dropped-write sentinel
        fold = dict(embed=ph.embed, token=torch.arange(7, 7 + b), pos=pos, freqs=freqs)
        shape = KVCache.plane_shape(cfg, b)
        for cache in ("bf16", "int8"):
            if cache == "bf16":
                planes = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                          for _ in range(2)]
            else:
                planes = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                                        dtype=torch.int8) for _ in range(2)]
                planes += [torch.rand(shape[:-1], generator=gen, device=dev) * 1e-2 + 1e-3
                           for _ in range(2)]
            outs = {}
            for tag in ("other", "this"):
                mine = [t.clone() for t in planes]
                scales = dict(k_scale=mine[2], v_scale=mine[3]) if cache == "int8" else {}
                with _launching(trees[tag]):
                    got = fd.fused_decode_step(ph, cfg, None, mine[0], mine[1], kv_pos, kv_len,
                                               rot, None, None, c1, s1, a8=a8, wcls=ph.wcls,
                                               out_norm=ph.out_norm, **scales, **fold)
                torch.cuda.synchronize()
                outs[tag] = list(got[:3]) + mine
                del mine, got
            names = ["x", "logits", "token", "ck", "cv"] + (["k_scale", "v_scale"]
                                                            if cache == "int8" else [])
            for name, x, y in zip(names, outs["other"], outs["this"]):
                if not torch.equal(x, y):
                    diff = float((x.float() - y.float()).abs().max())
                    raise AssertionError(f"megakernel {body}, B={b}, {cache} cache: {name} "
                                         f"differs from the other tree's (max |diff| {diff})")
            compared[f"B={b} {cache}"] = names
            del planes, outs
            torch.cuda.empty_cache()
    del ph
    torch.cuda.empty_cache()
    return compared


def megakernel_ms(models, other_root: str | None) -> None:
    """The megakernel alone in phase 3's first case, for each model preset
    named and each weight body (the i8 body, a8 on it, and q4 at group 512,
    or 128 where 512 does not divide the widths), in turns with
    ``other_root``'s library where given (``_in_turns``: CUDA events around
    the wrapper's calls, host gaps included, and the kernel's own device
    time), and the wrapper's host time a call behind a spin kernel; with
    ``other_root`` both trees' outputs of one step held bit for bit
    (``_megakernel_bit_equal``). Random i8 weights from the seed, a bf16
    cache of unit normals (the ``--megakernel-ms`` mode)."""
    import functools

    import torch

    from xalm_tpu_torch.models import config as configs
    from xalm_tpu_torch.models.llama import rope_constants
    from xalm_tpu_torch.models.params import recode_params_q4
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    trees, _ = _trees(other_root, ("fused_decode",), ("fused_decode_kernel",))
    dev = torch.device(DEVICE)
    out = {}
    for name in models:
        cfg = getattr(configs, name)
        params = synthetic_params(cfg, device=dev, seed=SEED)
        widths = (cfg.dim, cfg.hidden_dim, cfg.n_heads * cfg.head_dim)
        group = 512 if all(k % 1024 == 0 for k in widths) else 128
        freqs, c1, s1 = rope_constants(cfg, dev)
        pos = torch.tensor([519], dtype=torch.int32)
        _, kv_pos, kv_len = ring_indices(pos, cfg.max_seq_len)
        rot = torch.zeros(1, dtype=torch.int32)
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        ck, cv = (torch.randn(KVCache.plane_shape(cfg, 1), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        fold = dict(embed=params.embed, token=torch.tensor([7]), pos=pos, freqs=freqs)
        out[name] = {}
        for body in ("i8", "a8", f"q4 g{group}"):
            p = recode_params_q4(params, group) if body.startswith("q4") else params

            def step(tag, p=p, a8=body != "i8"):
                with _launching(trees[tag]):
                    fd.fused_decode_step(p, cfg, None, ck, cv, kv_pos, kv_len, rot, None, None,
                                         c1, s1, a8=a8, **fold)

            calls = {tag: functools.partial(step, tag) for tag in trees}
            with torch.inference_mode():
                row = _in_turns(calls, ("fused_decode_kernel",))
                if "other" in trees:
                    row["bit_equal"] = _megakernel_bit_equal(trees, p, cfg, body, body != "i8",
                                                             freqs, c1, s1)
                for tag, fn in calls.items():
                    # the wrapper's host time a call, the card kept busy ahead of it
                    torch.cuda._sleep(int(2e8))
                    t0 = time.perf_counter()
                    for _ in range(20):
                        fn()
                    row[f"{tag}_host_ms"] = (time.perf_counter() - t0) / 20 * 1e3
                    torch.cuda.synchronize()
            out[name][body] = row
            del p, step, calls
        del params, ck, cv
        torch.cuda.empty_cache()
    emit({"phase": "megakernel_ms", "roots": _roots(trees),
          "case": "B=1 kv_len=520, embed fold", "ms": out})


# --kernel-ms: the TMA-fed kernels at the main path's shapes beside one
# PyTorch call each, by event and device time.
# W8A8 and the f32 GEMM: (name, K, D) of Mistral-7B's w13 and w2 at M = 512
# and 256 (i8; f32 weights)
KERNEL_MS_A8 = (("w13", 4096, 28672), ("w2", 14336, 4096))
KERNEL_MS_A8_ROWS = (512, 256)
# flash prefill (bf16 and f32 caches) and flash-decode (bf16 cache): the
# model whose (group, head_dim) each case takes; the prefill T = 512
KERNEL_MS_PREFILL = (("Mistral-7B", "MISTRAL_7B"), ("Qwen2.5-7B", "QWEN2_5_7B"),
                     ("Gemma-7B", "GEMMA_7B"), ("Phi-3-mini", "PHI3_MINI_4K"))
KERNEL_MS_POS = (0, 1024)
# flash-decode (bf16 and f32 caches): phase 3's kv_len, and one near the
# 4096-row window
KERNEL_MS_DECODE_KV = (777, 4064)
KERNEL_MS_MIN_LAYERS = 4  # layers cycled per call at the least (see _cold_layers)
# the kernels' names, this tree's and earlier trees': a fragment that names
# the other tree's kernel reads "not measured"
KERNEL_MS_FRAGS = ("gemm_bf16w_kernel", "gemm_kernel", "prep_x_kernel", "gemm_a8_kernel",
                   "flash_prefill_kernel", "gemm_tf32x3_kernel",
                   "flash_prefill_tf32x3_kernel", "sgemm_kernel", "flash_prefill_f32_kernel",
                   "flash_decode_cluster_kernel", "flash_decode_split_kernel",
                   "flash_decode_combine_kernel", "gemv_stream_kernel", "gemv_kernel",
                   "gemv_q4_kernel", "qmatmul_multi_kernel", "qmatmul_multi_q4_kernel",
                   "gemv_q4_stream_kernel", "multi_q4_stream_kernel",
                   "flash_decode_q_cluster_kernel", "flash_decode_q_split_kernel",
                   "kv_update_q_kernel", "kv_update_kernel", "multi_stream_kernel")
KERNEL_MS_DECODE_FRAGS = ("flash_decode_cluster_kernel", "kv_update_kernel",
                          "flash_decode_split_kernel", "flash_decode_combine_kernel")
# kernel 7 with kernels 5-6: this tree's one launch, and the three of the
# trees before it
KERNEL_MS_DECODE_Q_FRAGS = ("flash_decode_q_cluster_kernel", "kv_update_q_kernel",
                            "flash_decode_q_split_kernel", "flash_decode_combine_kernel")
KERNEL_MS_GEMV_FRAGS = ("gemv_stream_kernel", "gemv_kernel")
# the tiled GEMM of int8 and bf16 weights: this tree's, the one it replaced
# (gemm_kernel, which other checkouts may hold), and x's preparation in both
KERNEL_MS_GEMM_FRAGS = (GEMM_FRAG, OLD_GEMM_FRAG, "prep_x_kernel")
# its cases: Mistral-7B's w13 and w2 at M = 512 and 256 (KERNEL_MS_A8), and
# w13 at the smallest prefill chunk
KERNEL_MS_GEMM_SMALL = (("w13", 4096, 28672, 16),)


def _gemv_cases(cfg) -> tuple:
    """Kernel 1's M = 1 cases of --kernel-ms at cfg's widths: (name, N, D,
    weights, norm prologue). f32 weights (the f32-weight model's matmuls and
    head), the bf16 head, and i8 with row scales (wqkv with the prologue,
    w2)."""
    qkv = cfg.q_dim + 2 * cfg.kv_dim
    return (("wqkv f32", cfg.dim, qkv, "f32", True),
            ("w13 f32", cfg.dim, 2 * cfg.hidden_dim, "f32", True),
            ("wo f32", cfg.q_dim, cfg.dim, "f32", False),
            ("w2 f32", cfg.hidden_dim, cfg.dim, "f32", False),
            ("head f32", cfg.dim, cfg.vocab_size, "f32", False),
            ("head bf16", cfg.dim, cfg.vocab_size, "bf16", False),
            ("wqkv i8", cfg.dim, qkv, "i8", True),
            ("w2 i8", cfg.hidden_dim, cfg.dim, "i8", False))


def _build_module(root: str, tag: str):
    """``xalm_tpu_torch/ops/build.py`` of the checkout at ``root`` as a
    module of its own (its sources, its build directory)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"xq_build_{tag}", os.path.join(root, "xalm_tpu_torch", "ops", "build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas_report(log_path, frags) -> dict:
    """ptxas's lines (registers, shared memory, spills, warnings) for each
    entry function of a build log whose name holds one of ``frags``."""
    out, name = {}, None
    if not os.path.exists(log_path):
        return out
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                name = name if any(k in name for k in frags) else None
            elif name and ("Used" in line or "spill" in line or "warning" in line):
                out.setdefault(name, []).append(line.strip())
    return out


def _trees(other_root: str | None, names, frags):
    """This checkout's ``ops/build.py`` and, with ``other_root``, the other
    checkout's (``_build_module``) as {"this": ..., "other": ...}; the
    libraries ``names`` of both built in parallel and loaded, and the build
    emitted with ptxas's report of the entry functions matching ``frags``.
    Returns (trees, {tag: {name: library}})."""
    from xalm_tpu_torch.ops import build

    trees = {"this": build}
    if other_root is not None:
        trees["other"] = _build_module(other_root, "other")
    t0 = time.perf_counter()
    started = [(b, name, b._start(name)) for b in trees.values() for name in names]
    for b, name, (out, pending) in started:
        b._finish(name, out, pending)
    libs = {tag: {name: b.load_library(name) for name in names} for tag, b in trees.items()}
    ptxas = {tag: {name: _ptxas_report(b.BUILD_DIR / f"{name}.log", frags) for name in names}
             for tag, b in trees.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas,
          "roots": _roots(trees)})
    return trees, libs


def _roots(trees) -> dict:
    return {tag: str(b.CSRC.parent) for tag, b in trees.items()}


@contextlib.contextmanager
def _launching(tree):
    """This checkout's wrappers launching ``tree``'s libraries
    (``build.load_library`` swapped for the tree's own)."""
    from xalm_tpu_torch.ops import build

    saved, build.load_library = build.load_library, tree.load_library
    try:
        yield
    finally:
        build.load_library = saved


def _in_turns(calls: dict, frags: tuple, library=None) -> dict:
    """Each of ``calls`` ({"this": fn, "other": fn} or {"this": fn}) timed
    by ``time_ms`` in turns (other, this, this, other; this, this alone),
    ``library`` (one PyTorch call of the same function) before each turn,
    each call's device time of the kernels whose names hold ``frags``
    (``kernel_device_ms``; a fragment that names one tree's kernel reads
    "not measured" in the other), and the device time of a whole call of
    each and of the library (``call_device_ms``): event times include the
    host's gaps between launches, device times do not."""
    order = ("other", "this", "this", "other") if "other" in calls else ("this", "this")
    runs = {tag: [] for tag in calls}
    lib_runs = []
    for tag in order:
        if library is not None:
            lib_runs.append(time_ms(library))
        runs[tag].append(time_ms(calls[tag]))
    row = {tag + "_ms": sum(r) / len(r) for tag, r in runs.items()}
    row["runs_ms"] = runs
    if library is not None:
        row["library_ms"] = sum(lib_runs) / len(lib_runs)
        row["library_runs_ms"] = lib_runs
    for tag, fn in calls.items():
        for frag in frags:
            row[f"{tag}_device_ms_{frag}"] = kernel_device_ms(fn, frag)
        row[f"{tag}_device_ms"] = call_device_ms(fn)
    if library is not None:
        row["library_device_ms"] = call_device_ms(library)
    return row


def _cold_layers(bytes_per_call: int) -> int:
    """Layers to cycle so that one sweep of a case's operands is twice the
    card's L2: each call then reads its operands from device memory."""
    import torch

    l2 = getattr(torch.cuda.get_device_properties(DEVICE), "L2_cache_size", 50 << 20)
    return max(KERNEL_MS_MIN_LAYERS, -(-2 * l2 // bytes_per_call))


def kernel_ms(other_root: str | None) -> None:
    """Kernel 1's W8A8 GEMM and f32 GEMM (``xq_qmatmul_a8``, ``xq_qmatmul``
    with f32 weights), its tiled GEMM of int8 and bf16 weights
    (``_gemm_turns``), kernel 4 over a bf16 and an f32 cache
    (``xq_flash_prefill``), a decode step's kernels 2-3 over both caches
    (``xq_fused_decode_attention``, older trees ``xq_kv_update`` and
    ``xq_flash_decode``; kv_len KERNEL_MS_DECODE_KV: ``_decode_turns``),
    kernel 7 with kernels
    5-6 over an int8 cache (a decode step's insert and attention, the same
    kv_len: ``_decode_q_turns``) and kernel 1's M = 1
    GEMV (``_gemv_turns``) of this checkout and, with ``--root``, of the
    other one, through their C entry points (their signatures are the same
    in both), each case timed in turns with one PyTorch call of the same
    function (``torch._int_mm`` and the two scale multiplies; ``F.linear``
    in f32, TF32 off; SDPA) by ``_in_turns``, over calls that cycle
    ``_cold_layers`` layers; the device times of the kernels, of a whole
    call and of the library call from torch.profiler; each output held to
    this checkout's plain version (W8A8 bit-equal; f32 GEMM, f32 prefill and
    flash-decode 1e-5 of each row's max; bf16 prefill 2^-8), a miss raising,
    and for the f32 kernels each tree's and the plain version's row error
    against f64 (``f64_row_rel_err``); the bound (split TF32 at PEAK_TF32
    for the f32 kernels, the f32 FMA bound beside). Random data from the
    seed."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from xalm_tpu_torch.models import config as configs
    from xalm_tpu_torch.ops import attention as A
    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.ops.attention import quant_rows
    from xalm_tpu_torch.ops.qmatmul import qmatmul_plain

    trees, libs = _trees(other_root, ("qmatmul", "attention"), KERNEL_MS_FRAGS)
    dev = torch.device(DEVICE)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)

    def held(kernel, row, ok):
        emit({"phase": "kernel_ms_case", "kernel": kernel, **row})
        if not ok:
            raise AssertionError(f"{kernel} {row['case']}: not within its tolerance of the plain "
                                 f"version ({row.get('max_row_rel_err', row.get('bit_equal'))})")

    a8_rows = []
    for name, k, d in KERNEL_MS_A8:
        L = _cold_layers(d * k)
        w = torch.randint(-127, 128, (L, d, k), generator=gen, device=dev, dtype=torch.int8)
        scale = torch.rand((L, d), generator=gen, device=dev) * 1e-3
        for m in KERNEL_MS_A8_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev)
            xq = torch.empty((m, k), dtype=torch.int8, device=dev)
            sx = torch.empty((m,), dtype=torch.float32, device=dev)
            ys = {tag: torch.empty((m, d), device=dev) for tag in trees}
            layer = {tag: itertools.cycle(range(L)) for tag in trees}

            def call(tag, i=None):
                i = next(layer[tag]) if i is None else i
                err = libs[tag]["qmatmul"].xq_qmatmul_a8(
                    x.data_ptr(), w.data_ptr() + i * d * k, scale.data_ptr() + i * d * 4,
                    ctypes.c_float(0.0), xq.data_ptr(), sx.data_ptr(), ys[tag].data_ptr(), m, k, d,
                    stream())
                build.check(err, f"{tag} xq_qmatmul_a8")
            want = qmatmul_plain(x, w, 1, scale=scale, a8=True)
            exact = {}
            for tag in trees:
                call(tag, 1)
                torch.cuda.synchronize()
                exact[tag] = bool(torch.equal(ys[tag], want))
            xl, sxl = quant_rows(x)
            lib_layer = itertools.cycle(range(L))

            def lib(xl=xl, sxl=sxl):
                i = next(lib_layer)
                return (torch._int_mm(xl, w[i].t()).float() * scale[i]) * sxl[:, None]
            b_ms, b_by = bound(d * k + 4 * m * (k + d) + 4 * d, 2.0 * m * k * d, PEAK_S8)
            row = {"case": f"M={m} {name} i8", "layers": L, "bit_equal": exact,
                   "bound_ms": b_ms, "bound_by": b_by}
            row.update(_in_turns({tag: (lambda tag=tag: call(tag)) for tag in trees},
                                 ("gemm_a8_kernel", "quant_x_kernel"), lib))
            a8_rows.append(row)
            held("qmatmul_a8", row, exact["this"])
        del w, scale
        torch.cuda.empty_cache()

    f32_rows = []
    for name, k, d in KERNEL_MS_A8:
        L = _cold_layers(d * k * 4)
        w = torch.randn((L, d, k), generator=gen, device=dev) * 0.02
        for m in KERNEL_MS_A8_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev)
            xbs = {tag: torch.empty((libs[tag]["qmatmul"].xq_qmatmul_scratch(m, k, 2),),
                                    dtype=torch.uint8, device=dev) for tag in trees}
            ys = {tag: torch.empty((m, d), device=dev) for tag in trees}
            layer = {tag: itertools.cycle(range(L)) for tag in trees}

            def call(tag, i=None):
                i = next(layer[tag]) if i is None else i
                err = libs[tag]["qmatmul"].xq_qmatmul(
                    x.data_ptr(), None, ctypes.c_float(0.0), w.data_ptr() + i * d * k * 4, 2, None,
                    ctypes.c_float(0.0), ys[tag].data_ptr(), xbs[tag].data_ptr(), m, k, d,
                    stream())
                build.check(err, f"{tag} xq_qmatmul f32")
            want = qmatmul_plain(x, w, 1)
            want64 = torch.matmul(x.double(), w[1].double().T)
            rel, rel64 = {}, {"plain": _row_rel(want, want64, d)}
            for tag in trees:
                call(tag, 1)
                torch.cuda.synchronize()
                rel[tag] = _row_rel(ys[tag], want, d)
                rel64[tag] = _row_rel(ys[tag], want64, d)
            lib_layer = itertools.cycle(range(L))

            def lib(x=x):
                return F.linear(x, w[next(lib_layer)])
            nbytes, flops = 4 * (d * k + m * k + m * d), 2.0 * m * k * d
            b_ms, b_by = bound(nbytes, 3 * flops, PEAK_TF32)
            row = {"case": f"M={m} {name} f32", "layers": L, "max_row_rel_err": rel,
                   "f64_row_rel_err": rel64, "bound_ms": b_ms, "bound_by": b_by,
                   "bound_fma_ms": bound(nbytes, flops, PEAK_F32)[0]}
            row.update(_in_turns({tag: (lambda tag=tag: call(tag)) for tag in trees},
                                 ("gemm_tf32x3_kernel", "sgemm_kernel", "prep_x"), lib))
            f32_rows.append(row)
            held("qmatmul_f32", row, rel["this"] <= F32_TOL)
        del w
        torch.cuda.empty_cache()

    pf_rows = {"bf16": [], "f32": []}
    dec_rows = {"bf16": [], "f32": []}
    dec_q_rows = []
    t = 512
    for label, preset in KERNEL_MS_PREFILL:
        cfg = getattr(configs, preset)
        kh, h, hd, s = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim, cfg.max_seq_len
        for cache, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            elt = dt.itemsize
            L = _cold_layers(2 * t * kh * hd * elt)  # the K and V rows of the first case (pos 0)
            ck, cv = (torch.empty((L, 1, kh, s, hd), dtype=dt, device=dev) for _ in range(2))
            for plane in (ck, cv):
                for i in range(L):
                    plane[i].normal_(generator=gen)
            f32 = int(cache == "f32")
            for p0 in KERNEL_MS_POS:
                q = torch.randn((1, t, h, hd), generator=gen, device=dev)
                pos = torch.tensor([p0], dtype=torch.int32, device=dev)
                outs = {tag: torch.empty((1, t, h * hd), device=dev) for tag in trees}
                layer = {tag: itertools.cycle(range(L)) for tag in trees}

                def call(tag, i=None):
                    i = next(layer[tag]) if i is None else i
                    err = libs[tag]["attention"].xq_flash_prefill(
                        q.data_ptr(), A._layer_ptr(ck, i), A._layer_ptr(cv, i), pos.data_ptr(),
                        outs[tag].data_ptr(), 1, t, h, kh, s, hd,
                        ctypes.c_float(1.0 / math.sqrt(hd)), f32, stream())
                    build.check(err, f"{tag} xq_flash_prefill")
                want = A.flash_prefill_plain(q, ck, cv, 1, pos)
                want64 = _attention_f64(q, ck, cv, 1, pos) if f32 else None
                rel, rel64 = {}, {"plain": _row_rel(want, want64, hd)} if f32 else {}
                for tag in trees:
                    call(tag, 1)
                    torch.cuda.synchronize()
                    rel[tag] = _row_rel(outs[tag], want, hd)
                    if f32:
                        rel64[tag] = _row_rel(outs[tag], want64, hd)
                qb = q.to(dt).transpose(1, 2)
                kend = p0 + t
                mask = (torch.arange(kend, device=dev)[None, :]
                        <= (p0 + torch.arange(t, device=dev))[:, None])
                lib_layer = itertools.cycle(range(L))

                def lib(kend=kend, qb=qb, mask=mask):
                    i = next(lib_layer)
                    return F.scaled_dot_product_attention(
                        qb, ck[i, :, :, :kend], cv[i, :, :, :kend], attn_mask=mask,
                        enable_gqa=True)
                visible = sum(p0 + i + 1 for i in range(t))
                nbytes, flops = 2 * kend * kh * hd * elt + 2 * t * h * hd * 4, 4.0 * visible * h * hd
                b_ms, b_by = bound(nbytes, 3 * flops if f32 else flops,
                                   PEAK_TF32 if f32 else PEAK_BF16)
                row = {"case": f"{label} G={h // kh} hd={hd} T={t} pos={p0} {cache}", "layers": L,
                       "max_row_rel_err": rel, "bound_ms": b_ms, "bound_by": b_by}
                if f32:
                    row["bound_fma_ms"] = bound(nbytes, flops, PEAK_F32)[0]
                    row["f64_row_rel_err"] = rel64
                frags = (("flash_prefill_tf32x3_kernel", "flash_prefill_f32_kernel") if f32
                         else ("flash_prefill_kernel",))
                row.update(_in_turns({tag: (lambda tag=tag: call(tag)) for tag in trees}, frags,
                                     lib))
                pf_rows[cache].append(row)
                held("flash_prefill" + ("_f32" if f32 else ""), row,
                     rel["this"] <= (F32_CACHE_TOL if f32 else 2.0 ** -8))
            for kvl in KERNEL_MS_DECODE_KV:  # kernels 2-3 over the same planes
                dec_rows[cache].append(
                    _decode_turns(trees, libs, label, cfg, ck, cv, L, gen, held, kvl))
            del ck, cv
            torch.cuda.empty_cache()
        for kvl in KERNEL_MS_DECODE_KV:  # kernel 7 with kernels 5-6 over int8 planes
            dec_q_rows.append(_decode_q_turns(trees, libs, label, cfg, gen, held, kvl))
    gemv_rows = _gemv_turns(trees, libs, gen, held)
    gemm_rows = _gemm_turns(trees, libs, gen, held)
    core_rows = _core_turns(trees, gen, held)
    _bulk_copy_rates(libs["this"]["qmatmul"])
    emit({"phase": "kernel_ms", "roots": _roots(trees), "qmatmul_gemm": gemm_rows,
          "qmatmul_a8": a8_rows,
          "qmatmul_f32": f32_rows, "flash_prefill": pf_rows["bf16"],
          "flash_prefill_f32": pf_rows["f32"], "flash_decode": dec_rows["bf16"],
          "flash_decode_f32": dec_rows["f32"], "flash_decode_q": dec_q_rows,
          "qmatmul_gemv": gemv_rows,
          "gemv_cores": core_rows})


def _attention_f64(q, ck, cv, layer: int, pos):
    """The causal attention of a chunk q (B, T, H, hd) over the cache's
    layer, the chunk at [pos, pos + T), in f64 with a dense softmax: the
    f32 kernels' and plain versions' yardstick of accuracy. -> (B, T, H *
    hd) f64."""
    import torch

    kl, vl = ck[layer].double(), cv[layer].double()  # (B, KH, S, hd)
    b, kh, _, hd = kl.shape
    _, t, h, _ = q.shape
    kend = int(pos.max()) + t
    qg = q.double().reshape(b, t, kh, h // kh, hd).permute(0, 2, 3, 1, 4)  # (B, KH, G, T, hd)
    sc = torch.matmul(qg, kl[:, :, None, :kend].transpose(-1, -2)) / math.sqrt(hd)
    qpos = pos[:, None].long() + torch.arange(t, device=q.device)  # (B, T)
    live = torch.arange(kend, device=q.device)[None, None, :] <= qpos[:, :, None]
    p = torch.softmax(sc.masked_fill(~live[:, None, None], -math.inf), dim=-1)
    o = torch.matmul(p, vl[:, :, None, :kend])  # (B, KH, G, T, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h * hd)


def _decode_turns(trees, libs, label, cfg, ck, cv, L, gen, held, kvl: int) -> dict:
    """A decode step over the bf16 or f32 planes of ``kernel_ms`` (cycling
    their L layers) at kv_len ``kvl``, B = 1: the insert of the new K and V
    rows at kv_len - 1 and the attention, in this tree one launch
    (``xq_fused_decode_attention``: kernel 2 in kernel 3's launch), in older
    trees (those without it) ``xq_kv_update`` and then ``xq_flash_decode``,
    each tree through its own library, in turns with SDPA over the same
    rows (``enable_gqa``, q in the cache's type; the attention alone) as
    ``_in_turns`` times them, the device times beside the event times. Each
    tree's step on copies of one layer is held to the plain composition
    (``fused_decode_attention_plain``): the planes bit-equal and the output
    within 1e-5 of each row's max (a miss in this tree raises). Bound: the K
    and V rows up to kv_len, q, the new rows and the output once each, and
    the inserted rows written."""
    import ctypes

    import numpy as np
    import torch
    import torch.nn.functional as F

    from xalm_tpu_torch.ops import attention as A
    from xalm_tpu_torch.ops import build

    dev = torch.device(DEVICE)
    kh, h, hd, s = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim, cfg.max_seq_len
    f32 = int(ck.dtype == torch.float32)
    q = torch.randn((1, h, hd), generator=gen, device=dev)
    kn = torch.randn((1, kh, hd), generator=gen, device=dev)
    vn = torch.randn((1, kh, hd), generator=gen, device=dev)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731
    kv_pos, kv_len, rot = i32(kvl - 1), i32(kvl), i32(0)
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    cexp, sexp = (torch.from_numpy(a).to(dev) for a in A.rope_cos_sin_plus1(freqs))
    fused = {tag: "xq_fused_decode_attention" in trees[tag].SIGNATURES["attention"]
             for tag in trees}
    outs = {tag: torch.empty((1, h * hd), device=dev) for tag in trees}
    layer = {tag: itertools.cycle(range(L)) for tag in trees}
    stream = torch.cuda.current_stream(dev).cuda_stream
    sm = ctypes.c_float(1.0 / math.sqrt(hd))

    def call(tag, k_, v_, i=None):
        i = next(layer[tag]) if i is None else i
        lib = libs[tag]["attention"]
        pk, pv = A._layer_ptr(k_, i), A._layer_ptr(v_, i)
        rows = (kn.data_ptr(), vn.data_ptr(), kv_pos.data_ptr(), rot.data_ptr(),
                cexp.data_ptr(), sexp.data_ptr())
        if fused[tag]:
            err = lib.xq_fused_decode_attention(q.data_ptr(), pk, pv, *rows, kv_len.data_ptr(),
                                                outs[tag].data_ptr(), 1, h, kh, s, hd, sm, f32,
                                                stream)
        else:
            err = lib.xq_kv_update(pk, pv, *rows, 1, kh, s, hd, f32, stream)
            build.check(err, f"{tag} xq_kv_update")
            err = lib.xq_flash_decode(q.data_ptr(), pk, pv, kv_len.data_ptr(),
                                      outs[tag].data_ptr(), 1, h, kh, s, hd, sm, f32, stream)
        build.check(err, f"{tag} decode step")
    ref = [ck[1:2].clone(), cv[1:2].clone()]
    want = A.fused_decode_attention_plain(q, *ref, 0, kn, vn, kv_pos, kv_len, rot, cexp, sexp)
    rel, equal = {}, {}
    for tag in trees:
        got = [ck[1:2].clone(), cv[1:2].clone()]
        call(tag, *got, 0)
        torch.cuda.synchronize()
        rel[tag] = _row_rel(outs[tag], want, hd)
        equal[tag] = all(torch.equal(x, y) for x, y in zip(got, ref))
    qb = q.to(ck.dtype)[:, :, None]
    lib_layer = itertools.cycle(range(L))

    def lib():
        i = next(lib_layer)
        return F.scaled_dot_product_attention(qb, ck[i, :, :, :kvl], cv[i, :, :, :kvl],
                                              enable_gqa=True)
    elt = ck.element_size()
    b_ms, b_by = bound(2 * kvl * kh * hd * elt + 2 * h * hd * 4 + 2 * kh * hd * (4 + elt),
                       4.0 * h * kvl * hd, PEAK_F32)
    cache = "f32" if f32 else "bf16"
    row = {"case": f"{label} G={h // kh} hd={hd} kv_len={kvl} {cache}, insert at {kvl - 1}",
           "layers": L, "max_row_rel_err": rel, "planes_bit_equal": equal, "bound_ms": b_ms,
           "bound_by": b_by, "library_note": "SDPA over the same rows: the attention alone"}
    row.update(_in_turns({tag: (lambda tag=tag: call(tag, ck, cv)) for tag in trees},
                         KERNEL_MS_DECODE_FRAGS, lib))
    held("flash_decode_f32" if f32 else "flash_decode", row, rel["this"] <= 1e-5 and equal["this"])
    return row


def _decode_q_turns(trees, libs, label, cfg, gen, held, kvl: int) -> dict:
    """Kernel 7 with kernels 5-6 at kv_len ``kvl``, B = 1, over random int8
    planes (codes and scales) cycling ``_cold_layers`` layers: a decode
    step's insert of the new K and V rows at kv_len - 1 and its attention,
    in this tree one launch (``xq_flash_decode_q`` with the new rows), in
    older trees (those with ``xq_flash_decode_workspace``) ``xq_kv_update_q``
    and then ``xq_flash_decode_q``
    (its split and combine kernels, with its workspace), each tree through
    its own library, timed in turns by ``_in_turns`` (no library call:
    NO_LIBRARY_INT8). Each tree's step on copies of one layer is held to
    the plain composition (``fused_decode_attention_q_plain``): the planes
    bit-equal and the output within 1e-3 of each row's max (a miss in this
    tree raises). Bound: the code and scale rows up to kv_len, q, the new
    rows and the output once each, and the inserted row written."""
    import ctypes

    import numpy as np
    import torch

    from xalm_tpu_torch.ops import attention as A
    from xalm_tpu_torch.ops import build

    dev = torch.device(DEVICE)
    kh, h, hd, s = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim, cfg.max_seq_len
    L = _cold_layers(2 * kvl * kh * (hd + 4))
    shape = (L, 1, kh, s, hd)
    planes = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
              for _ in range(2)]
    planes += [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 for _ in range(2)]
    q = torch.randn((1, h, hd), generator=gen, device=dev)
    kn = torch.randn((1, kh, hd), generator=gen, device=dev)
    vn = torch.randn((1, kh, hd), generator=gen, device=dev)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731
    kv_pos, kv_len, rot = i32(kvl - 1), i32(kvl), i32(0)
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    cexp, sexp = (torch.from_numpy(a).to(dev) for a in A.rope_cos_sin_plus1(freqs))
    outs = {tag: torch.empty((1, h * hd), device=dev) for tag in trees}
    layer = {tag: itertools.cycle(range(L)) for tag in trees}
    stream = torch.cuda.current_stream(dev).cuda_stream
    sm = ctypes.c_float(1.0 / math.sqrt(hd))
    fused = {tag: "xq_flash_decode_workspace" not in trees[tag].SIGNATURES["attention"]
             for tag in trees}
    work = {tag: torch.empty((libs[tag]["attention"].xq_flash_decode_workspace(1, h, s, hd),),
                             device=dev) for tag in trees if not fused[tag]}

    def call(tag, ps, i=None):
        i = next(layer[tag]) if i is None else i
        lib = libs[tag]["attention"]
        ptr = [A._layer_ptr(t, i) for t in ps]
        rows = (kn.data_ptr(), vn.data_ptr(), kv_pos.data_ptr(), rot.data_ptr(),
                cexp.data_ptr(), sexp.data_ptr())
        if fused[tag]:
            err = lib.xq_flash_decode_q(q.data_ptr(), *ptr, *rows, kv_len.data_ptr(),
                                        outs[tag].data_ptr(), 1, h, kh, s, hd, sm, stream)
        else:
            err = lib.xq_kv_update_q(*ptr, *rows, 1, kh, s, hd, stream)
            build.check(err, f"{tag} xq_kv_update_q")
            err = lib.xq_flash_decode_q(q.data_ptr(), *ptr, kv_len.data_ptr(),
                                        work[tag].data_ptr(), outs[tag].data_ptr(), 1, h, kh, s,
                                        hd, sm, stream)
        build.check(err, f"{tag} xq_flash_decode_q")
    one = [t[1:2] for t in planes]
    ref = [t.clone() for t in one]
    want = A.fused_decode_attention_q_plain(q, *ref, 0, kn, vn, kv_pos, kv_len, rot, cexp, sexp)
    rel, equal = {}, {}
    for tag in trees:
        got = [t.clone() for t in one]
        call(tag, got, 0)
        torch.cuda.synchronize()
        rel[tag] = _row_rel(outs[tag], want, hd)
        equal[tag] = all(torch.equal(x, y) for x, y in zip(got, ref))
    b_ms, b_by = bound(2 * kvl * kh * (hd + 4) + 2 * h * hd * 4 + 2 * kh * hd * 4
                       + 2 * kh * (hd + 4), 4.0 * h * kvl * hd, PEAK_F32)
    row = {"case": f"{label} G={h // kh} hd={hd} kv_len={kvl} int8, insert at {kvl - 1}",
           "layers": L, "max_row_rel_err": rel, "planes_bit_equal": equal, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "library_note": NO_LIBRARY_INT8}
    row.update(_in_turns({tag: (lambda tag=tag: call(tag, planes)) for tag in trees},
                         KERNEL_MS_DECODE_Q_FRAGS))
    held("flash_decode_q", row, rel["this"] <= 1e-3 and equal["this"])
    del planes
    torch.cuda.empty_cache()
    return row


def _gemv_turns(trees, libs, gen, held) -> list[dict]:
    """Kernel 1's M = 1 GEMV through ``xq_qmatmul`` at Mistral-7B's widths
    (``_gemv_cases``), layers cycled past twice the L2, in turns with the
    other tree's and one PyTorch call (``F.linear`` in f32 with TF32 off,
    or in bf16; ``torch._weight_int8pack_mm`` for i8 with row scales; none
    with the norm prologue), device times beside the event times; each held
    to this tree's plain version (f32 weights F32_TOL; bf16 and i8 1e-4,
    1e-3 with the norm prologue). Bound: the weights, x, the output, the
    row scales and the norm weights, once each."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from xalm_tpu_torch.models.config import MISTRAL_7B
    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.ops.qmatmul import qmatmul_plain

    dev = torch.device(DEVICE)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kinds = {"i8": (0, torch.int8), "bf16": (1, torch.bfloat16), "f32": (2, torch.float32)}
    eps = MISTRAL_7B.norm_eps
    rows = []
    for name, n, d, wt, use_norm in _gemv_cases(MISTRAL_7B):
        kind, dt = kinds[wt]
        elt = dt.itemsize
        L = _cold_layers(d * n * elt)
        if wt == "i8":
            w = torch.randint(-127, 128, (L, d, n), generator=gen, device=dev, dtype=torch.int8)
            scale = torch.rand((L, d), generator=gen, device=dev) * 1e-3
        else:
            w = (torch.randn((L, d, n), generator=gen, device=dev) * 0.02).to(dt)
            scale = None
        norm_w = torch.rand((L, n), generator=gen, device=dev) + 0.5 if use_norm else None
        x = torch.randn((1, n), generator=gen, device=dev)
        ys = {tag: torch.empty((1, d), device=dev) for tag in trees}
        layer = {tag: itertools.cycle(range(L)) for tag in trees}

        def call(tag, i=None, w=w, scale=scale, norm_w=norm_w, x=x, n=n, d=d):
            i = next(layer[tag]) if i is None else i
            err = libs[tag]["qmatmul"].xq_qmatmul(
                x.data_ptr(), None if norm_w is None else norm_w.data_ptr() + i * n * 4,
                ctypes.c_float(eps), w.data_ptr() + i * d * n * w.element_size(), kind,
                None if scale is None else scale.data_ptr() + i * d * 4, ctypes.c_float(0.0),
                ys[tag].data_ptr(), None, 1, n, d, stream)
            build.check(err, f"{tag} xq_qmatmul")
        kw = {} if scale is None else dict(scale=scale)
        if use_norm:
            kw.update(norm_w=norm_w, norm_eps=eps)
        want = qmatmul_plain(x, w, 1, **kw)
        rel = {}
        for tag in trees:
            call(tag, 1)
            torch.cuda.synchronize()
            rel[tag] = _row_rel(ys[tag], want, d)
        lib_layer = itertools.cycle(range(L))
        lib = None
        if wt == "i8" and not use_norm:
            xb, sc16 = x.to(torch.bfloat16), scale.to(torch.bfloat16)

            def lib(xb=xb, sc16=sc16, w=w):
                i = next(lib_layer)
                return torch._weight_int8pack_mm(xb, w[i], sc16[i])
        elif not use_norm:
            xl = x.to(dt)

            def lib(xl=xl, w=w):
                return F.linear(xl, w[next(lib_layer)])
        nbytes = (d * n * elt + n * 4 + d * 4 + (d * 4 if scale is not None else 0)
                  + (n * 4 if use_norm else 0))
        b_ms, b_by = bound(nbytes, 2.0 * n * d, PEAK_F32 if wt == "f32" else PEAK_BF16)
        row = {"case": f"M=1 {name}" + (", norm prologue" if use_norm else ""), "layers": L,
               "max_row_rel_err": rel, "bound_ms": b_ms, "bound_by": b_by}
        if lib is None:
            row["library_null"] = NO_LIBRARY_NORM
        row.update(_in_turns({tag: (lambda tag=tag: call(tag)) for tag in trees},
                             KERNEL_MS_GEMV_FRAGS, lib))
        rows.append(row)
        tol = F32_TOL if wt == "f32" else 1e-3 if use_norm else 1e-4
        held("qmatmul_f32" if wt == "f32" else "qmatmul", row, rel["this"] <= tol)
        del w, scale, norm_w, lib, call
        torch.cuda.empty_cache()
    return rows


# --kernel-ms's cases of the kernels on gemv.cuh's warp cores other than
# the megakernel: (name, model, weights, N, D, k experts or 0, rows of x (an
# expert's), q4 group, x shared by the experts). Kernel 8's int8 experts at
# m 1-8 and its bf16 ones: the cases that split them between the
# per-expert stream (int8 where one launch holds x's m rows: w13 up to 8,
# w2 up to 3) and qmatmul_multi_kernel (the rest).
KERNEL_MS_CORES = (("M=1 w2 e4m3", "MISTRAL_7B", "e4m3", "hidden", "dim", 0, 1, 0, True),
                   ("M=1 w13 q4 g512", "MISTRAL_7B", "q4", "dim", "h2", 0, 1, 512, True),
                   ("M=1 w2 q4 g512", "MISTRAL_7B", "q4", "hidden", "dim", 0, 1, 512, True),
                   ("M=1 wqkv q4 g128", "MIXTRAL_8X7B", "q4", "dim", "qkv", 0, 1, 128, True),
                   ("multi w13 i8, m=1 k=2", "MIXTRAL_8X7B", "i8", "dim", "h2", 2, 1, 0, True),
                   ("multi w2 i8, per-expert x, m=1 k=2", "MIXTRAL_8X7B", "i8", "hidden", "dim",
                    2, 1, 0, False),
                   ("multi w13 i8, m=4 k=2", "MIXTRAL_8X7B", "i8", "dim", "h2", 2, 4, 0, True),
                   ("multi w13 i8, m=8 k=2", "MIXTRAL_8X7B", "i8", "dim", "h2", 2, 8, 0, True),
                   ("multi w2 i8, per-expert x, m=3 k=2", "MIXTRAL_8X7B", "i8", "hidden", "dim",
                    2, 3, 0, False),
                   ("multi w2 i8, per-expert x, m=4 k=2", "MIXTRAL_8X7B", "i8", "hidden", "dim",
                    2, 4, 0, False),
                   ("multi w2 i8, per-expert x, m=8 k=2", "MIXTRAL_8X7B", "i8", "hidden", "dim",
                    2, 8, 0, False),
                   ("multi w13 bf16, m=1 k=2", "MIXTRAL_8X7B", "bf16", "dim", "h2", 2, 1, 0,
                    True),
                   ("multi w2 bf16, per-expert x, m=1 k=2", "MIXTRAL_8X7B", "bf16", "hidden",
                    "dim", 2, 1, 0, False),
                   ("multi w13 bf16, m=8 k=2", "MIXTRAL_8X7B", "bf16", "dim", "h2", 2, 8, 0,
                    True),
                   ("multi w2 bf16, per-expert x, m=4 k=2", "MIXTRAL_8X7B", "bf16", "hidden",
                    "dim", 2, 4, 0, False),
                   ("multi w13 q4 g128, m=1 k=2", "MIXTRAL_8X7B", "q4", "dim", "h2", 2, 1, 128,
                    True),
                   ("multi w2 q4 g128, per-expert x, m=1 k=2", "MIXTRAL_8X7B", "q4", "hidden",
                    "dim", 2, 1, 128, False))
# this tree's kernels and the ones they replaced (which the other tree may
# hold, with its quant_x_kernel launch before the q4 ones)
KERNEL_MS_CORE_FRAGS = ("gemv_kernel", "qmatmul_multi_kernel", "multi_stream_kernel",
                        "gemv_q4_stream_kernel",
                        "multi_q4_stream_kernel", "gemv_q4_kernel", "qmatmul_multi_q4_kernel",
                        "quant_x_kernel")


def _core_turns(trees, gen, held) -> list[dict]:
    """The other kernels on gemv.cuh's cores (``KERNEL_MS_CORES``): the fp8
    GEMV (``gemv_kernel``), the q4 GEMV (``gemv_q4_stream_kernel``; earlier
    trees: ``quant_x_kernel`` and ``gemv_q4_kernel``) and kernel 8's
    gathered experts over int8, bf16 and packed q4 (``multi_stream_kernel``
    and ``qmatmul_multi_kernel``, ``multi_q4_stream_kernel``; earlier:
    ``qmatmul_multi_kernel``, ``qmatmul_multi_q4_kernel``),
    through this checkout's wrappers launching each tree's library
    (``_launching``), in turns, layers or experts cycled past twice the L2;
    each held to this checkout's plain version (fp8 and i8 1e-4 of each
    row's max, bf16 1e-4 too, q4 bit for bit). No one PyTorch call computes these functions
    (library null). Bound: the weights and scales, x and the output, once
    each."""
    import torch

    from xalm_tpu_torch.models import config as configs
    from xalm_tpu_torch.ops.qmatmul import (qmatmul, qmatmul_multi, qmatmul_multi_plain,
                                            qmatmul_plain)

    dev = torch.device(DEVICE)
    rows = []
    for name, model, wt, nk, dk, k, m, group, shared in KERNEL_MS_CORES:
        cfg = getattr(configs, model)
        widths = {"dim": cfg.dim, "hidden": cfg.hidden_dim, "h2": 2 * cfg.hidden_dim,
                  "qkv": cfg.q_dim + 2 * cfg.kv_dim}
        n, d = widths[nk], widths[dk]
        wn = {"q4": n // 2, "bf16": 2 * n}.get(wt, n)  # bytes of a weight row
        sbytes = d * (n // group if group else 1) * 4 if wt in ("i8", "q4") else 0
        L = _cold_layers(max(k, 1) * (d * wn + sbytes))
        le = L * max(k, 1)
        if wt in ("e4m3", "bf16"):
            w = (torch.randn((le, d, n), generator=gen, device=dev) * 0.5).to(
                torch.float8_e4m3fn if wt == "e4m3" else torch.bfloat16)
            scale = None
        else:
            w = torch.randint(-128 if wt == "q4" else -127, 128, (le, d, wn), generator=gen,
                              device=dev, dtype=torch.int8)
            scale = torch.rand((le, d, n // group) if group else (le, d), generator=gen,
                               device=dev) * 1e-2
        xrows = m if shared or not k else k * m
        x = torch.randn((xrows, n), generator=gen, device=dev)
        kw = dict(q4_group=group) if group else {}
        if k:
            kw["shared_x"] = shared
            idxs = [torch.arange(i * k, i * k + k, dtype=torch.int32, device=dev)
                    for i in range(L)]
            want = qmatmul_multi_plain(x, w, scale, idxs[1], **kw)

            def fn(i, w=w, scale=scale, x=x, kw=kw, idxs=idxs):
                return qmatmul_multi(x, w, scale, idxs[i], **kw)
        else:
            want = qmatmul_plain(x, w, 1, scale=scale, **kw)

            def fn(i, w=w, scale=scale, x=x, kw=kw):
                return qmatmul(x, w, i, scale=scale, **kw)
        layer = {tag: itertools.cycle(range(L)) for tag in trees}
        rel = {}
        for tag, tree in trees.items():
            with _launching(tree):
                got = fn(1)
            torch.cuda.synchronize()
            rel[tag] = _row_rel(got, want, d)

        def call(tag, fn=fn):
            with _launching(trees[tag]):
                fn(next(layer[tag]))
        nbytes = max(k, 1) * (d * wn + sbytes + m * d * 4) + xrows * n * 4
        b_ms, b_by = bound(nbytes, 2.0 * n * d * max(k, 1) * m, PEAK_BF16)
        row = {"case": name, "layers": L, "max_row_rel_err": rel, "bound_ms": b_ms,
               "bound_by": b_by, "library_null": "no one PyTorch call computes it"}
        row.update(_in_turns({tag: (lambda tag=tag: call(tag)) for tag in trees},
                             KERNEL_MS_CORE_FRAGS))
        rows.append(row)
        kernel = ("qmatmul_multi" if k else "qmatmul") + {"e4m3": "_fp8", "q4": "_q4"}.get(wt, "")
        held(kernel, row, rel["this"] <= (0.0 if wt == "q4" else 1e-4))
        del w, scale, fn, call
        torch.cuda.empty_cache()
    return rows


def _gemm_turns(trees, libs, gen, held) -> list[dict]:
    """Kernel 1's tiled GEMM through ``xq_qmatmul`` (int8 weights with row
    scales and bf16 weights: this tree's ``gemm_bf16w_kernel``, the other
    tree's: the kernel it replaced, ``gemm_kernel``), Mistral-7B's w13 and w2 at M = 512 and
    256 and w13 at M = 16, layers cycled past twice the L2, in turns with the
    other tree's and with ``F.linear`` on bf16 weights of the same shape (for
    int8 weights a reference point: no PyTorch call multiplies int8 weights
    with row scales by bf16 x on the tensor cores), device times beside the
    event times; each held to this tree's plain version at 1e-4 of each
    row's max. Bound: the weights, x, the output and the scales once each,
    or 2 M N D operations at 989 TFLOP/s, whichever is longer."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.ops.qmatmul import GEMM_BK, gemm_plan, qmatmul_plain

    dev = torch.device(DEVICE)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(wt, name, k, d, m) for wt in ("i8", "bf16")
             for name, k, d in KERNEL_MS_A8 for m in KERNEL_MS_A8_ROWS]
    cases += [(wt, name, k, d, m) for wt in ("i8", "bf16")
              for name, k, d, m in KERNEL_MS_GEMM_SMALL]
    rows = []
    for wt, name, k, d, m in cases:
        kind, dt = (0, torch.int8) if wt == "i8" else (1, torch.bfloat16)
        L = _cold_layers(d * k * dt.itemsize)
        if wt == "i8":
            w = torch.randint(-127, 128, (L, d, k), generator=gen, device=dev, dtype=torch.int8)
            scale = torch.rand((L, d), generator=gen, device=dev) * 1e-3
            wlib = w.to(torch.bfloat16)  # the library's bf16 weights of the same shape
        else:
            w = (torch.randn((L, d, k), generator=gen, device=dev) * 0.02).to(dt)
            scale, wlib = None, w
        x = torch.randn((m, k), generator=gen, device=dev)
        xbs = {tag: torch.empty((libs[tag]["qmatmul"].xq_qmatmul_scratch(m, k, kind),),
                                dtype=torch.uint8, device=dev) for tag in trees}
        ys = {tag: torch.empty((m, d), device=dev) for tag in trees}
        layer = {tag: itertools.cycle(range(L)) for tag in trees}

        def call(tag, i=None, w=w, scale=scale, x=x, k=k, d=d, m=m, kind=kind):
            i = next(layer[tag]) if i is None else i
            err = libs[tag]["qmatmul"].xq_qmatmul(
                x.data_ptr(), None, ctypes.c_float(0.0),
                w.data_ptr() + i * d * k * w.element_size(), kind,
                None if scale is None else scale.data_ptr() + i * d * 4, ctypes.c_float(0.0),
                ys[tag].data_ptr(), xbs[tag].data_ptr(), m, k, d, stream)
            build.check(err, f"{tag} xq_qmatmul tiled")
        want = qmatmul_plain(x, w, 1, **({} if scale is None else dict(scale=scale)))
        rel = {}
        for tag in trees:
            call(tag, 1)
            torch.cuda.synchronize()
            rel[tag] = _row_rel(ys[tag], want, d)
        xl = x.to(torch.bfloat16)
        lib_layer = itertools.cycle(range(L))

        def lib(xl=xl, wlib=wlib):
            return F.linear(xl, wlib[next(lib_layer)])
        nbytes = d * k * dt.itemsize + 4 * m * (k + d) + (4 * d if scale is not None else 0)
        b_ms, b_by = bound(nbytes, 2.0 * m * k * d, PEAK_BF16)
        row = {"case": f"M={m} {name} {wt}", "layers": L, "max_row_rel_err": rel,
               "plan": gemm_plan(m, k, d, dt, sms), "bound_ms": b_ms, "bound_by": b_by,
               "library": ("F.linear on bf16 weights of the same shape: a reference point"
                           if wt == "i8" else "F.linear")}
        row.update(_in_turns({tag: (lambda tag=tag: call(tag)) for tag in trees},
                             KERNEL_MS_GEMM_FRAGS, lib))
        # the rate at which a block's stages land: the bytes every tile's
        # stages bring (128 bytes of each weight row, x's chunks over the same
        # columns) over the blocks and the kernel's device time (gemm_plan
        # weighs a tile by its bytes at this rate)
        nt, wrows, mtiles, bands, _, _, blocks = row["plan"]
        wb = dt.itemsize
        staged = bands * mtiles * -(-k * wb // GEMM_BK) * (wrows * GEMM_BK
                                                           + GEMM_BK // 64 // wb * nt * 128)
        dms = row.get(f"this_device_ms_{GEMM_FRAG}")
        row["stage_gb_s_per_sm"] = (staged / blocks / dms / 1e6 if isinstance(dms, float)
                                    else "not measured")
        rows.append(row)
        held("qmatmul", row, rel["this"] <= 1e-4)
        del w, scale, wlib, lib, call
        torch.cuda.empty_cache()
    return rows


# the streamed GEMV's ring alone (xq_bulk_stream_bench): bytes a bulk copy,
# six stages, one block an SM, 256 MB a call over four buffers
BULK_COPY_SIZES = (1024, 4096, 16384)


def _bulk_copy_rates(lib) -> None:
    """The bytes a second that one block an SM moves through the streamed
    GEMV's ring of six stages, one bulk copy a stage, by copy size (CUDA
    events over 20 calls, four 256 MB buffers cycled so each call reads
    from device memory): the reason its stages are 16 KB copies."""
    import torch

    from xalm_tpu_torch.ops import build

    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bufs = [torch.zeros(256 << 20, dtype=torch.uint8, device=dev) for _ in range(4)]
    sink = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = {}
    for size in BULK_COPY_SIZES:
        nbytes = (256 << 20) // (sms * size) * sms * size
        turn = itertools.cycle(bufs)

        def call(size=size, nbytes=nbytes):
            err = lib.xq_bulk_stream_bench(next(turn).data_ptr(), nbytes, size, 6, sms,
                                           sink.data_ptr(), stream)
            build.check(err, "xq_bulk_stream_bench")
        ms = time_ms(call)
        rates[str(size)] = {"ms": ms, "gb_s": nbytes / ms / 1e6}
    emit({"phase": "bulk_copy", "blocks": sms, "stages": 6, "by_copy_bytes": rates})
    del bufs


DECODE_WALL_TOKENS = 64  # tokens a generate, after a 512-token prompt
DECODE_WALL_RUNS = 3     # generates a turn
DECODE_WALL_CALLS = 400  # attention steps timed on the host a turn
PREFILL_WALL_TOKENS = (512, 2048)  # prompts a turn prefills
PREFILL_WALL_RUNS = 5  # prefills of each a turn, after one more


def _decode_wall_turn() -> dict:
    """One turn of ``decode_wall``, in a process whose ``xalm_tpu_torch`` is
    the checkout's under test: Mistral-7B (random i8 weights from SEED, 32
    layers) on the per-layer path with a bf16 cache, DECODE_WALL_RUNS
    generates of DECODE_WALL_TOKENS tokens after a warm-up, each one's
    decode ms a token; then a layer's attention step alone at kv_len 513,
    B = 1, DECODE_WALL_CALLS times (the checkout's ``fused_decode_attention``,
    or where it has none ``kv_update`` then ``flash_decode``): the host's
    microseconds a call while the card keeps up, and the event ms a call;
    then ``Engine.prefill`` of each PREFILL_WALL_TOKENS prompt into one
    cache, PREFILL_WALL_RUNS times after a warm-up: the seconds of each on
    the host's clock around a synchronised call, and CUDA events around
    it (the device's span from the first launch to the last)."""
    import numpy as np
    import torch

    from xalm_tpu_torch.models.config import MISTRAL_7B as cfg
    from xalm_tpu_torch.ops import attention as A
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    params = synthetic_params(cfg, device=DEVICE, seed=SEED)
    eng = Engine(cfg, params, kv_dtype=torch.bfloat16, fused_step=False)
    prompt = np.random.default_rng(SEED).integers(3, cfg.vocab_size, size=512).tolist()
    eng.generate(prompt[:32], 2, stop_on_eos=False)
    torch.cuda.synchronize()
    ms = []
    for _ in range(DECODE_WALL_RUNS):
        out, stats = eng.generate(prompt, DECODE_WALL_TOKENS, stop_on_eos=False)
        if len(out) != DECODE_WALL_TOKENS:
            raise AssertionError(f"generated {len(out)} tokens")
        ms.append(stats.decode_s / stats.generated_tokens * 1e3)
    dev = torch.device(DEVICE)
    kh, h, hd, s = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim, cfg.max_seq_len
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ck, cv = (torch.randn((1, 1, kh, s, hd), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn((1, h, hd), generator=gen, device=dev)
    kn, vn = (torch.randn((1, kh, hd), generator=gen, device=dev) for _ in range(2))
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731
    kv_pos, kv_len, rot = i32(512), i32(513), i32(0)
    c, sn = (torch.ones(hd, device=dev) for _ in range(2))
    if hasattr(A, "fused_decode_attention"):
        def step():
            A.fused_decode_attention(q, ck, cv, 0, kn, vn, kv_pos, kv_len, rot, c, sn)
    else:
        def step():
            A.kv_update(ck, cv, 0, kn, vn, kv_pos, rot, c, sn)
            A.flash_decode(q, ck, cv, 0, kv_len)
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_WALL_CALLS):
        step()
    host_us = (time.perf_counter() - t0) / DECODE_WALL_CALLS * 1e6
    torch.cuda.synchronize()
    row = {"decode_ms_per_token": ms, "attention_step_host_us": host_us,
           "attention_step_event_ms": time_ms(step, iters=DECODE_WALL_CALLS // 4),
           "fused": hasattr(A, "fused_decode_attention")}
    cache = eng.new_cache(1)
    long = np.random.default_rng(SEED + 1).integers(3, cfg.vocab_size,
                                                    size=max(PREFILL_WALL_TOKENS)).tolist()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for n in PREFILL_WALL_TOKENS:
        eng.prefill(long[:n], cache)
        torch.cuda.synchronize()
        walls, events = [], []
        for _ in range(PREFILL_WALL_RUNS):
            t0 = time.perf_counter()
            start.record()
            logits, _, pos = eng.prefill(long[:n], cache)
            end.record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            events.append(start.elapsed_time(end) / 1e3)
            if pos != n or not torch.isfinite(logits).all():
                raise AssertionError(f"prefill of {n} tokens: pos {pos}, or logits not finite")
        row[f"prefill_{n}_s"] = walls
        row[f"prefill_{n}_event_s"] = events
    return row


def decode_wall(other_root: str) -> None:
    """Mistral-7B's per-layer decode and prefill over a bf16 cache, this
    checkout's package against ``other_root``'s in one call on one host:
    both trees' kernel 1 and attention libraries built first (``_trees``), then one
    process a turn (``--decode-wall-turn``, which imports the named
    checkout's package), in turns other, this, this, other; each turn's
    ``_decode_wall_turn`` and the means of each tree."""
    _trees(other_root, ("qmatmul", "attention"), ("flash_decode",))
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        root = other_root if tag == "other" else here
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--decode-wall-turn",
                              root], capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"{tag} turn failed: {res.stderr[-2000:]}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        runs[tag].append(row)
        emit({"phase": "decode_wall_turn", "tree": tag, "root": root, **row})
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    emit({"phase": "decode_wall", "model": "Mistral-7B", "path": "perlayer", "kv_dtype": "bfloat16",
          **{f"{tag}_decode_ms_per_token": mean([m for r in rs for m in r["decode_ms_per_token"]])
             for tag, rs in runs.items()},
          **{f"{tag}_attention_step_host_us": mean([r["attention_step_host_us"] for r in rs])
             for tag, rs in runs.items()},
          **{f"{tag}_attention_step_event_ms": mean([r["attention_step_event_ms"] for r in rs])
             for tag, rs in runs.items()},
          **{f"{tag}_{key}": mean([m for r in rs for m in r[key]]) for tag, rs in runs.items()
             for n in PREFILL_WALL_TOKENS for key in (f"prefill_{n}_s", f"prefill_{n}_event_s")}})


def phase_parallel_parity(params, cfg, cases: Cases) -> None:
    """Kernels 1, 3-4 and 7 at the shapes a tp=2 rank gives them
    (``parallel/shardings.py``, rank 0's shard): wqkv's 3072 rows (4 kv
    heads with their queries), w13's 14336, wo contracting over 2048, w2
    over 7168, the head's 16000 vocab rows, the W8A8 GEMM on those four
    shards at a prefill chunk's 512 rows (bit-equal, PARALLEL_A8_CASES),
    and the attention over 4 kv heads a rank, each against its plain
    version as phase 3 holds it (case names end in PARALLEL_LABEL)."""
    import torch

    from xalm_tpu_torch.parallel.mesh import Mesh
    from xalm_tpu_torch.parallel.shardings import shard_params

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)
    shard = shard_params(params, cfg, Mesh.layout({"dp": 1, "tp": 2}, 0), device=dev)
    lp = shard.layers
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=torch.float32)  # noqa: E731
    norm_w = torch.rand((cfg.n_layers, cfg.dim), generator=gen, device=dev) + 0.5
    mm = functools.partial(_mm_case, cases, cfg, randn, norm_w)
    shapes = (lp.wqkv.values.shape[1], lp.w13.values.shape[1], lp.wo.values.shape[2],
              lp.w2.values.shape[2], shard.wcls.values.shape[0])
    if shapes != (3072, 14336, 2048, 7168, 16000):  # the case names' shapes
        raise AssertionError(f"tp=2 shard shapes {shapes}")
    for case, m, w, norm in zip(PARALLEL_MM_CASES, (1, 1, 1, 1, 512),
                                (lp.wqkv, lp.w13, lp.wo, lp.w2, lp.w13),
                                (True, True, False, False, False)):
        mm(case, m, w, norm)
    mm(PARALLEL_MM_CASES[-1], 1, shard.wcls, False, head=True)
    for case, w in zip(PARALLEL_A8_CASES, (lp.wqkv, lp.w13, lp.wo, lp.w2)):
        _a8_case(cases, cfg, randn, case, 512, w, "i8")
    lab = PARALLEL_LABEL
    del shard, lp
    torch.cuda.empty_cache()
    kh = cfg.n_kv_heads // 2
    cfg2 = dataclasses.replace(cfg, n_kv_heads=kh, n_heads=cfg.n_heads // 2)
    shape = (cfg.n_layers, 1, kh, cfg.max_seq_len, cfg.head_dim)
    ck, cv = (randn(*shape).to(torch.bfloat16) for _ in range(2))
    attention_cases(cfg2, cases, gen, ck, cv, label=lab)
    del ck, cv
    codes = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 for _ in range(2)]
    cexp, sexp = _sink_trig(cfg)
    decode_q_cases(cfg2, cases, codes + scales, gen, cexp, sexp, label=lab)
    torch.cuda.empty_cache()


def phase_parallel_nccl(params, cfg, store: str) -> dict:
    """(a) A world of one in this process over NCCL: ``ShardedEngine`` at
    tp = 1 over Mistral-7B i8 at full width and depth (the same weights,
    shared) against ``Engine(fused_step=False)``: a 512-token prefill's
    logits and ``generate``'s tokens at segment 16, whose steps are CUDA
    graph replays with the NCCL collectives captured, bit for bit (a sum
    over one rank is exact)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.parallel.mesh import make_mesh
    from xalm_tpu_torch.parallel.multihost import init_distributed
    from xalm_tpu_torch.parallel.sharded_engine import ShardedEngine
    from xalm_tpu_torch.runtime.engine import Engine

    init_distributed(f"file://{store}/nccl_store", 1, 0, device="cuda:0")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"phase_parallel (a): backend {dist.get_backend()}, not nccl")
        prompt = np.random.default_rng(SEED + 22).integers(3, cfg.vocab_size,
                                                            size=PARALLEL_PROMPT).tolist()
        ref = Engine(cfg, params, fused_step=False)
        sh = ShardedEngine(cfg, params, None, make_mesh(dp=1, tp=1))
        lr = ref.prefill(prompt, ref.new_cache(1))[0]
        ls = sh.prefill(prompt, sh.new_cache(1))[0]
        logits_equal = bool(torch.equal(lr, ls))
        runs = {}
        for name, eng in (("engine", ref), ("sharded", sh)):
            eng.generate(prompt, 2, stop_on_eos=False)  # the capture
            before = dict(build.LAUNCHES)
            toks, st = eng.generate(prompt, PARALLEL_NCCL_TOKENS, stop_on_eos=False)
            runs[name] = (toks, st.decode_s / max(st.generated_tokens, 1) * 1e3,
                          build.take_launches(before))
            build.add_launches(runs[name][2])
        graphs = [g for _, g in sh._graphs.values()]
        captured = bool(graphs) and all(g.graph is not None and g.replays > 0 for g in graphs)
        rec = {"phase": "parallel_nccl", "world": 1, "backend": dist.get_backend(),
               "decode_path": sh.decode_path(1), "logits_bit_equal": logits_equal,
               "tokens_equal": runs["engine"][0] == runs["sharded"][0],
               "graph_replays_captured": captured,
               "ms_per_token_segment16": {k: v[1] for k, v in runs.items()},
               "launches": runs["sharded"][2]}
        emit(rec)
        if not (logits_equal and rec["tokens_equal"] and captured):
            raise AssertionError(f"phase_parallel (a): the NCCL world of one differs: {rec}")
        del ref, sh
        torch.cuda.empty_cache()
        return rec["launches"]
    finally:
        dist.destroy_process_group()


def _forced(eng, prompts, teacher):
    """A teacher-forced run: the (B, T) prompts in one step, then each of
    ``teacher``'s (B, n) columns a step -> (n + 1, B, V) f32 logits on the
    host."""
    import numpy as np
    import torch

    b, t = prompts.shape
    cache = eng.new_cache(b)
    logits, cache = eng.step(prompts, np.zeros(b, np.int32), cache, logits_mode="last")
    out = [logits.float().cpu()]
    for i in range(teacher.shape[1]):
        logits, cache = eng.step(teacher[:, i:i + 1], np.full(b, t + i, np.int32), cache,
                                 logits_mode="last")
        out.append(logits.float().cpu())
    return torch.stack(out), cache


def _parallel_worker(store: str, rank: int) -> int:
    """(b)'s rank ``rank`` of a world of two on the one card over gloo with
    CUDA tensors (``--parallel-worker``). Rank 0 keeps the reference runs of
    the single-device per-layer engine; both run each configuration of
    PARALLEL_RUNS and PARALLEL_A8, then the copy model's greedy tokens,
    then Mixtral-8x7B at 2 layers with tp=2, and write their results and
    launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from xalm_tpu_torch.models.config import MISTRAL_7B, MIXTRAL_8X7B
    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.parallel import aot
    from xalm_tpu_torch.parallel.mesh import make_mesh
    from xalm_tpu_torch.parallel.multihost import init_distributed
    from xalm_tpu_torch.parallel.pipeline import PipelinedEngine, make_pp_mesh
    from xalm_tpu_torch.parallel.sharded_engine import ShardedEngine
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    on_card = DEVICE == "cuda"
    init_distributed(f"file://{store}/gloo_store", 2, rank, backend="gloo",
                     device="cuda:0" if on_card else DEVICE, timeout_s=600)

    def sync():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    dt = {"int8": torch.int8}
    rng = np.random.default_rng(SEED + 23)
    out = {"rank": rank, "runs": [], "launches": {}}

    def build_engine(cfg, params, mesh_kw, kw):
        kw = {k: dt.get(v, v) for k, v in kw.items()}
        mesh = make_pp_mesh(mesh_kw["pp"]) if "pp" in mesh_kw else make_mesh(**mesh_kw)
        kv = kw.pop("kv_dtype", "auto")
        if "pp" in mesh_kw:
            return PipelinedEngine(cfg, params, None, mesh, kv_dtype=kv)
        return ShardedEngine(cfg, params, None, mesh, kv_dtype=kv, **kw)

    def counted(fn):
        before = dict(build.LAUNCHES)
        result = fn()
        made = build.take_launches(before)
        build.add_launches(made)
        for k, n in made.items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        return result

    def rel(a, r):
        """Each step's max |a - r| over its max |r|."""
        return ((a - r).abs().amax(dim=(1, 2)) / r.abs().amax(dim=(1, 2))).tolist()

    def check(name, cfg, params, mesh_kw, kw, judge):
        """The forced run, judged on rank 0 (``judge(got)``: the fields of
        its comparison), the per-step collectives and the wall ms a token of
        a timed decode_scan. Returns the forced run's logits."""
        eng = build_engine(cfg, params, mesh_kw, kw)
        sync()
        got, cache = counted(lambda: _forced(eng, prompts, teacher))
        b = prompts.shape[0]
        pos = np.full(b, prompts.shape[1] + teacher.shape[1], np.int32)
        tok = got[-1].argmax(-1).numpy().astype(np.int32)
        stats = aot.collective_stats(eng.step, tok[:, None], pos, cache, logits_mode="token")
        sync()
        t0 = time.perf_counter()
        counted(lambda: eng.decode_scan(tok, pos + 1, cache, PARALLEL_TIMED_STEPS)[0].cpu())
        ms = (time.perf_counter() - t0) / PARALLEL_TIMED_STEPS * 1e3
        rec = {"config": name, "decode_path": eng.decode_path(b), "batch": b,
               "collectives_per_step": stats, "ms_per_token": ms}
        if judge is not None:
            rec.update(judge(got))
        out["runs"].append(rec)
        del eng, cache
        sync()
        return got

    def against_engine(ref2, ref1, exact=None):
        """Every step bit-equal to ``ref2``, the single-device engine's
        B = 2 run (``exact`` "batch"), or to ``ref1``, its rows run alone
        ("alone"); else within WRAP_TOL of ``ref2``, or PARALLEL_FLOOR_RATIO
        times the engine's own spread (``ref2`` against ``ref1``), whichever
        is larger. A step that is not finite is over any limit."""
        def judge(got):
            errs, floor, alone = rel(got, ref2), rel(ref2, ref1), rel(got, ref1)
            rec = dict(max_rel_logit_err=max(errs), engine_floor=max(floor),
                       max_rel_logit_err_vs_rows_alone=max(alone))
            if exact is not None:
                ref = ref2 if exact == "batch" else ref1
                unequal = (got != ref).flatten(1).any(dim=1)
                return dict(rec, held_bit_equal_to=exact, limit=0.0,
                            steps_over_limit=int(unequal.sum()))
            limit = max(WRAP_TOL, PARALLEL_FLOOR_RATIO * max(floor))
            return dict(rec, limit=limit, steps_over_wrap_tol=sum(not e <= WRAP_TOL for e in errs),
                        steps_over_limit=sum(not e <= limit for e in errs))
        return judge

    def against_sharded(base, single_a8, single_base):
        """PARALLEL_A8's rule: the sharded a8 run's change from the sharded
        ``base`` run, every step within WRAP_TOL or PARALLEL_FLOOR_RATIO
        times the single-device engine's largest a8 change."""
        def judge(got):
            effect, single = rel(got, base), rel(single_a8, single_base)
            limit = max(WRAP_TOL, PARALLEL_FLOOR_RATIO * max(single))
            return dict(max_a8_effect=max(effect), max_single_device_a8_effect=max(single),
                        limit=limit, steps_over_limit=sum(not e <= limit for e in effect),
                        max_rel_logit_err=max(rel(got, single_a8)))
        return judge

    cfg = MISTRAL_7B
    prompts = rng.integers(3, cfg.vocab_size, size=(2, PARALLEL_PROMPT)).astype(np.int32)
    teacher = rng.integers(3, cfg.vocab_size, size=(2, PARALLEL_STEPS)).astype(np.int32)
    full = synthetic_params(cfg, device=DEVICE, seed=SEED)

    def reference(cfg, params, kw, alone=True):
        """The single-device per-layer engine's forced run at B = 2, and
        (``alone``) with each row run alone (B = 1)."""
        eng = Engine(cfg, params, fused_step=False, **{k: dt.get(v, v) for k, v in kw.items()})
        both = _forced(eng, prompts, teacher)[0]
        rows = None if not alone else torch.cat(
            [_forced(eng, prompts[i:i + 1], teacher[i:i + 1])[0]
             for i in range(prompts.shape[0])], dim=1)
        del eng
        sync()
        return both, rows

    def depth(layers):
        """(cfg, params) at ``layers`` layers (None: all; views of ``full``)."""
        if layers is None:
            return cfg, full
        return dataclasses.replace(cfg, n_layers=layers), _layer_window(full, 0, layers)

    got, single, refs = {}, {}, {}
    for name, mesh_kw, kw, layers in PARALLEL_RUNS:
        judge = None
        if rank == 0:  # configurations with the same options share one reference
            key = (layers,) + tuple(sorted(kw.items()))
            if key not in refs:
                refs[key] = reference(*depth(layers), kw)
            single[name] = refs[key]
            judge = against_engine(*single[name], PARALLEL_EXACT.get(name))
        dist.barrier()
        got[name] = check(name, *depth(layers), mesh_kw, kw, judge)
    name, mesh_kw, kw, layers, base = PARALLEL_A8
    judge = None
    if rank == 0:
        judge = against_sharded(got[base], reference(*depth(layers), kw, alone=False)[0],
                                single[base][0])
    dist.barrier()
    check(name, *depth(layers), mesh_kw, kw, judge)
    del full, got, single, refs
    sync()

    copy, perm_inv = copy_params(cfg, SEED + 3)
    cprompt = copy_prompt(perm_inv, SEED + 4)
    want = recurrence(cprompt, perm_inv, PARALLEL_COPY_TOKENS)
    copy_ok = {}
    for name, mesh_kw, kw, _ in PARALLEL_RUNS[:3]:
        eng = build_engine(cfg, copy, mesh_kw, kw)
        toks = counted(lambda: eng.generate(cprompt, PARALLEL_COPY_TOKENS,
                                            stop_on_eos=False)[0])
        copy_ok[name] = toks == want
        del eng
        sync()
    out["copy_tokens_equal"] = copy_ok
    del copy
    sync()

    mcfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=2)
    mfull = synthetic_params(mcfg, device=DEVICE, seed=SEED)
    judge = against_engine(*reference(mcfg, mfull, {})) if rank == 0 else None
    dist.barrier()
    check("Mixtral-8x7B 2 layers, tp=2", mcfg, mfull, dict(tp=2), {}, judge)
    del mfull, judge
    sync()
    Path(store, f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def phase_parallel_world(store: str) -> dict:
    """(b) Two worker processes (``--parallel-worker``) on the one card
    over gloo: each configuration's teacher-forced logits (a 512-token
    prefill, 64 decode steps, B = 2) against the single-device per-layer
    engine's: pp=2 and dp=2 bit-equal (PARALLEL_EXACT), the tp runs every
    step within PARALLEL_FLOOR_RATIO's limit, PARALLEL_A8's run against the
    sharded run without int8 activations; the copy model's greedy
    tokens equal, and the kernels of PARALLEL_KERNELS each launched; a
    ``parallel`` line a configuration (SHARED_CARD). Returns both ranks'
    launches."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"),
                               "--parallel-worker", store, str(r)]) for r in range(2)]
    t0 = time.perf_counter()
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError(f"phase_parallel (b): a worker failed (exit codes {rcs})")
    ranks = [json.loads(Path(store, f"rank{r}.json").read_text()) for r in range(2)]
    launches = {}
    for r in ranks:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    bad = []
    for rec in ranks[0]["runs"]:
        emit(dict(phase="parallel", world=2, backend="gloo", note=SHARED_CARD,
                  copy_tokens_equal=ranks[0]["copy_tokens_equal"].get(rec["config"]), **rec))
        if rec["steps_over_limit"]:
            bad.append(rec["config"])
    bad += [k for k, ok in ranks[0]["copy_tokens_equal"].items() if not ok]
    missing = [k for k in PARALLEL_KERNELS if launches.get(k, 0) == 0]
    emit({"phase": "parallel_world", "seconds": time.perf_counter() - t0, "launches": launches,
          "kernels_never_launched": missing})
    if bad or missing:
        raise AssertionError(f"phase_parallel (b): {bad} over the limit or unequal, kernels "
                             f"never launched: {missing}")
    return launches


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke of the PyTorch/CUDA port.")
    ap.add_argument("--megakernel-ms", action="store_true",
                    help="only time the megakernel (see the module's note)")
    ap.add_argument("--kernel-ms", action="store_true",
                    help="only time the TMA-fed GEMMs, the flash prefill and flash-decode "
                         "(see the module's note)")
    ap.add_argument("--decode-wall", action="store_true",
                    help="with --root: only time Mistral-7B's per-layer decode of both "
                         "checkouts (see the module's note)")
    ap.add_argument("--tools", action="store_true",
                    help="only the host tools' phase (phase_tools; see the module's note)")
    ap.add_argument("--decode-wall-turn", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--parallel-worker", nargs=2, metavar=("STORE", "RANK"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--root", help="with --megakernel-ms, --kernel-ms or --decode-wall: another "
                                   "checkout whose kernels are timed in turns with this one's")
    ap.add_argument("--models", nargs="+", default=["MISTRAL_7B", "QWEN3_8B"],
                    help="with --megakernel-ms: model presets")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("error: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device (this smoke runs on the GPU only)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.root) if args.root else None
    for r in filter(None, (here, other)):
        if not os.path.isdir(os.path.join(r, "xalm_tpu_torch")):
            print(f"error: {r} is not a checkout of the repository (xalm_tpu_torch/ missing)",
                  file=sys.stderr)
            return 2
    if args.decode_wall_turn:  # one turn of --decode-wall, over that checkout's package
        sys.path.insert(0, os.path.abspath(args.decode_wall_turn))
        with torch.inference_mode():
            print(json.dumps(_decode_wall_turn()))
        return 0
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.parallel_worker:  # a rank of phase_parallel's world of two
        return _parallel_worker(args.parallel_worker[0], int(args.parallel_worker[1]))
    if args.decode_wall:
        if other is None:
            print("error: --decode-wall needs --root", file=sys.stderr)
            return 2
        phase_device()
        decode_wall(other)
        return 0
    if args.tools:
        from xalm_tpu_torch.models.config import MISTRAL_7B

        from xalm_tpu_torch.ops import build

        name = phase_device()
        build.start_all()  # the kernels build while the converter runs
        phase_tools(MISTRAL_7B)
        emit({"phase": "done", "seconds": time.perf_counter() - T0})
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.megakernel_ms or args.kernel_ms:
        phase_device()
        with torch.inference_mode():
            if args.megakernel_ms:
                megakernel_ms(args.models, other)
            else:
                kernel_ms(other)
        return 0

    from xalm_tpu_torch.models.config import MISTRAL_7B, MIXTRAL_8X7B
    from xalm_tpu_torch.models.params import recode_params_q4
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    name = phase_device()
    # every source's nvcc starts here; Mixtral-8x7B's phases (the per-layer
    # kernels: kernel 1, 8 and the attention kernels) run while the
    # megakernel's two sources go on building
    phase_build(("qmatmul", "attention"))
    cases = Cases()
    cfg = MIXTRAL_8X7B
    t0 = time.perf_counter()
    params = synthetic_params(cfg, device=DEVICE, seed=SEED)
    torch.cuda.synchronize()
    emit({"phase": "weights", "model": "Mixtral-8x7B", "seconds": time.perf_counter() - t0,
          "gb": params.nbytes() / 1e9})
    with torch.inference_mode():
        phase_parity_multi(params, cfg, cases)
    moe_row = phase_main_moe(params, cfg)
    phase_scan(cfg, "Mixtral-8x7B", [("mixtral bf16 perlayer", params, {}, "perlayer")])
    del params
    torch.cuda.empty_cache()
    with torch.inference_mode():
        phase_wrap_moe(cfg)
        phase_router_witness(cfg)
    phase_build(("fused_decode", "fused_decode_f32"))

    cfg = MISTRAL_7B
    t0 = time.perf_counter()
    params = synthetic_params(cfg, device=DEVICE, seed=SEED)
    torch.cuda.synchronize()
    emit({"phase": "weights", "seconds": time.perf_counter() - t0,
          "gb": params.nbytes() / 1e9})
    t0 = time.perf_counter()
    q4p = recode_params_q4(params, 512)  # the q4 body, packed on the card
    torch.cuda.synchronize()
    emit({"phase": "weights", "model": "Mistral-7B q4 g512", "recode_seconds":
          time.perf_counter() - t0, "gb": q4p.nbytes() / 1e9})
    with torch.inference_mode():
        phase_parity(params, cfg, cases)
        phase_fused_parity(params, cfg, cases)
        phase_parity_quant(params, q4p, cfg, cases)
        phase_fused_parity(params, cfg, cases, "a8")
        phase_fused_parity(q4p, cfg, cases, "q4")
        phase_parity_f32_cache(params, q4p, cfg, cases)
        phase_parity_fp8(cfg, cases)
    main_row = phase_main(params, cfg)
    quant_row = phase_main_quant(params, q4p, cfg)
    long_row = phase_long_prompt(params, cfg)
    i8 = dict(kv_dtype=torch.int8)
    phase_scan(cfg, "Mistral-7B", [
        ("bf16 megakernel", params, {}, "megakernel"),
        ("int8 megakernel", params, i8, "megakernel"),
        ("bf16 perlayer", params, dict(fused_step=False), "perlayer"),
        ("int8 perlayer", params, dict(i8, fused_step=False), "perlayer"),
        ("q4 g512 perlayer a8", q4p, dict(a8_decode=True, fused_step=False), "perlayer"),
    ], ppl_run="bf16 megakernel", depth_runs=("bf16 megakernel", "bf16 perlayer"))
    phase_spec(params, cfg)
    phase_session(cfg)
    serve_launches = phase_serve(params, cfg)
    with torch.inference_mode():
        phase_parallel_parity(params, cfg, cases)
    store = os.path.join(here, "build", "parallel")
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store)
    par_launches = phase_parallel_nccl(params, cfg, store)
    main_row["launches"] = {k: main_row["launches"][k] + quant_row["launches"][k]
                            + long_row["launches"][k] + serve_launches.get(k, 0)
                            for k in main_row["launches"]}
    del params, q4p
    torch.cuda.empty_cache()
    for k, n in phase_parallel_world(store).items():
        par_launches[k] = par_launches.get(k, 0) + n
    with torch.inference_mode():
        phase_wrap(cfg)
    fam_launches = phase_families(cases)
    fmt_launches = phase_formats(cases)
    phase_tools(MISTRAL_7B)
    launches = {k: main_row["launches"][k] + moe_row["launches"][k]
                + sum(run[k] for run in fam_launches.values())
                + sum(run[k] for run in fmt_launches.values()) + par_launches.get(k, 0)
                for k in main_row["launches"]}
    for tag, (model, wrappers) in SHAPE_ROWS.items():
        for w in wrappers:
            launches[w + tag] = fam_launches[model][w]
    for k in OFF_MAIN_PATH:
        launches.setdefault(k, 0)
    missing = [k for k, n in launches.items() if n == 0 and k not in OFF_MAIN_PATH]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: {missing}")

    emit({"kernels": kernels_line(cases, launches)})
    emit({"phase": "done", "seconds": time.perf_counter() - T0})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
