"""Decode steps replayed as CUDA graphs: the port's counterpart of the JAX
engine's ``jax.jit`` + ``lax.scan`` plumbing (``xalm_tpu/runtime/
engine.py:145-341``: ``_decode_scan``, ``_sample_scan``, ``_ppl_scan``).

A ``StepGraph`` holds one t = 1 step and its advance, written against
static device buffers (``ScanState``): the step reads the token, positions
and ``valid`` rows from them, runs the forward, and then advances them in
place on the card: pos += 1, the next token from the step's greedy argmax,
the sampler's draw or the teacher's token list, and the step's output (the
token, or the target's log-prob) into slot ``slot`` of an output buffer,
the slot a device counter. On the card the first call runs one step
eagerly on a side stream (the warm-up: libraries built and loaded, the
kernels' attributes and occupancy set, the wrappers' caches filled), then
captures one step into a ``torch.cuda.CUDAGraph``; every later step is a
``replay()``. A segment of n steps costs the host n replays and no read:
the caller reads the output buffer once at its end. The capture's launch
counts are taken back out of ``ops.build.LAUNCHES`` and each replay adds
them (``build.add_launches``). A failed capture raises: nothing falls back
to eager steps on the card. On the CPU the same step runs eagerly, step
after step (the kernels' plain versions), which is what the tests run.

A graph is bound to the addresses it was captured on: the cache planes,
the buffers and the weights. A step of a sharded engine may hold
collectives (``parallel/mesh.py``): on NCCL they are captured with the
step, and the capture's counts in ``parallel.mesh.COLLECTIVES`` are
taken back out and added at each replay, as the launches are. A gloo
collective cannot be captured, so an engine on gloo builds its steps with
``capture=False`` and they run eagerly on the card too: a choice by
backend, made where the engine is built, never a fallback from a failed
capture. Its capture uses ``capture_error_mode=
"thread_local"``, so that another thread's CUDA calls during it (an HTTP
handler's, say) neither fail it nor are refused, and runs with Python's
cyclic garbage collector off: a collection there that frees an unreachable
engine's graphs (an engine and its steps' closures form a cycle) would
destroy a CUDA graph mid-capture, which invalidates the capture.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

import torch

from xalm_tpu_torch.ops import build
from xalm_tpu_torch.parallel import mesh as comm

__all__ = ["SEGMENT_MAX", "ScanState", "StepGraph"]

# steps a segment's output buffer holds: the JAX perplexity's largest
# bucket (512); a longer run reads the buffer every SEGMENT_MAX steps
SEGMENT_MAX = 512


@dataclasses.dataclass
class ScanState:
    """The static device buffers a step reads and advances. ``out`` holds
    (B, SEGMENT_MAX) int32 tokens or f32 log-probs; ``toks``/``tgts`` the
    teacher's tokens and targets of a perplexity segment. A sampled step's
    state: ``keys`` (B, 2) int64 threefry keys (row 0 the one key of
    ``sample``), and for the per-row sampler ``temps`` and ``top_ps`` (B,)
    f32, and with log-probs ``lp`` (B, SEGMENT_MAX) f32 and the top-5
    ``topv`` f32 and ``topi`` int32 (B, SEGMENT_MAX, 5)."""

    token: torch.Tensor  # (B,) int32
    pos: torch.Tensor  # (B,) int32
    slot: torch.Tensor  # (1,) int64: the output slot of the next step
    out: torch.Tensor  # (B, SEGMENT_MAX)
    valid: torch.Tensor | None = None  # (B,) bool
    toks: torch.Tensor | None = None  # (B, SEGMENT_MAX) int32
    tgts: torch.Tensor | None = None
    keys: torch.Tensor | None = None  # (B, 2) int64
    temps: torch.Tensor | None = None  # (B,) f32
    top_ps: torch.Tensor | None = None  # (B,) f32
    lp: torch.Tensor | None = None  # (B, SEGMENT_MAX) f32
    topv: torch.Tensor | None = None  # (B, SEGMENT_MAX, 5) f32
    topi: torch.Tensor | None = None  # (B, SEGMENT_MAX, 5) int32

    @classmethod
    def empty(cls, batch: int, device, *, logprobs: bool = False, valid: bool = False,
              teacher: bool = False, keys: bool = False, rows: bool = False,
              top5: bool = False) -> "ScanState":
        """``keys``: the key buffer; ``rows``: also the per-row temperature
        and top-p; ``top5``: the log-prob and top-5 outputs."""
        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        def f32(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        out = f32(batch, SEGMENT_MAX) if logprobs else i32(batch, SEGMENT_MAX)
        return cls(token=i32(batch), pos=i32(batch),
                   slot=torch.zeros((1,), dtype=torch.int64, device=device), out=out,
                   valid=torch.ones((batch,), dtype=torch.bool, device=device) if valid else None,
                   toks=i32(batch, SEGMENT_MAX) if teacher else None,
                   tgts=i32(batch, SEGMENT_MAX) if teacher else None,
                   keys=torch.zeros((batch, 2), dtype=torch.int64, device=device)
                   if keys or rows else None,
                   temps=f32(batch) if rows else None,
                   top_ps=torch.ones((batch,), dtype=torch.float32, device=device)
                   if rows else None,
                   lp=f32(batch, SEGMENT_MAX) if top5 else None,
                   topv=f32(batch, SEGMENT_MAX, 5) if top5 else None,
                   topi=i32(batch, SEGMENT_MAX, 5) if top5 else None)

    def emit(self, value: torch.Tensor, token: torch.Tensor, lp=None, topv=None,
             topi=None) -> None:
        """The advance at the end of a step: ``value`` (B,) into the output
        slot (and ``lp`` (B,), ``topv``/``topi`` (B, 5) into theirs), the
        next input ``token`` (B,), pos + 1, slot + 1."""
        self.out.index_copy_(1, self.slot, value.to(self.out.dtype)[:, None])
        if lp is not None:
            self.lp.index_copy_(1, self.slot, lp.to(self.lp.dtype)[:, None])
            self.topv.index_copy_(1, self.slot, topv.to(self.topv.dtype)[:, None])
            self.topi.index_copy_(1, self.slot, topi.to(self.topi.dtype)[:, None])
        self.token.copy_(token)
        self.pos.add_(1)
        self.slot.add_(1).remainder_(SEGMENT_MAX)


class StepGraph:
    """One step (``step``: a function of no argument that reads and
    advances the static buffers) run n times a call; on the card replayed
    from a CUDA graph captured at the first call (module docstring), or
    with ``capture=False`` run eagerly there as on the CPU."""

    def __init__(self, step: Callable[[], None], device, capture: bool = True):
        self._step = step
        self.device = torch.device(device)
        self.capture = capture
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}  # launches one replay makes
        self.collectives: dict = {}  # collectives one replay makes
        self.capture_s = 0.0  # host seconds of the warm-up step and the capture
        self.replays = 0

    def _capture(self) -> None:
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._step()  # one real step: the warm-up
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = dict(build.LAUNCHES)
        before_c = comm._snapshot()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._step()
        finally:
            if collecting:
                gc.enable()
            captured = build.take_launches(before)
            self.collectives = comm.take_collectives(before_c)
        self.graph, self.launches = graph, captured
        self.capture_s = time.perf_counter() - t0

    def run(self, n: int) -> None:
        """n steps, enqueued on the current stream; no host read."""
        if n <= 0:
            return
        if self.device.type != "cuda" or not self.capture:
            for _ in range(n):
                self._step()
            return
        if self.graph is None:
            self._capture()  # its warm-up is the first of the n steps
            n -= 1
        for _ in range(n):
            self.graph.replay()
        build.add_launches(self.launches, n)
        comm.add_collectives(self.collectives, n)
        self.replays += n
