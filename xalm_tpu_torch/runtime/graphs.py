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
the buffers, the weights and, for a sampled step, its generator (whose
graph-safe state PyTorch advances at each replay, so each replay draws
fresh numbers).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from xalm_tpu_torch.ops import build

__all__ = ["SEGMENT_MAX", "ScanState", "StepGraph"]

# steps a segment's output buffer holds: the JAX perplexity's largest
# bucket (512); a longer run reads the buffer every SEGMENT_MAX steps
SEGMENT_MAX = 512


@dataclasses.dataclass
class ScanState:
    """The static device buffers a step reads and advances. ``out`` holds
    (B, SEGMENT_MAX) int32 tokens or f32 log-probs; ``toks``/``tgts`` the
    teacher's tokens and targets of a perplexity segment."""

    token: torch.Tensor  # (B,) int32
    pos: torch.Tensor  # (B,) int32
    slot: torch.Tensor  # (1,) int64: the output slot of the next step
    out: torch.Tensor  # (B, SEGMENT_MAX)
    valid: torch.Tensor | None = None  # (B,) bool
    toks: torch.Tensor | None = None  # (B, SEGMENT_MAX) int32
    tgts: torch.Tensor | None = None

    @classmethod
    def empty(cls, batch: int, device, *, logprobs: bool = False, valid: bool = False,
              teacher: bool = False) -> "ScanState":
        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        out = (torch.zeros((batch, SEGMENT_MAX), dtype=torch.float32, device=device) if logprobs
               else i32(batch, SEGMENT_MAX))
        return cls(token=i32(batch), pos=i32(batch),
                   slot=torch.zeros((1,), dtype=torch.int64, device=device), out=out,
                   valid=torch.ones((batch,), dtype=torch.bool, device=device) if valid else None,
                   toks=i32(batch, SEGMENT_MAX) if teacher else None,
                   tgts=i32(batch, SEGMENT_MAX) if teacher else None)

    def emit(self, value: torch.Tensor, token: torch.Tensor) -> None:
        """The advance at the end of a step: ``value`` (B,) into the output
        slot, the next input ``token`` (B,), pos + 1, slot + 1."""
        self.out.index_copy_(1, self.slot, value.to(self.out.dtype)[:, None])
        self.token.copy_(token)
        self.pos.add_(1)
        self.slot.add_(1).remainder_(SEGMENT_MAX)


class StepGraph:
    """One step (``step``: a function of no argument that reads and
    advances the static buffers) run n times a call; on the card replayed
    from a CUDA graph captured at the first call (module docstring).
    ``generator``: the CUDA generator a sampled step draws from, registered
    with the graph."""

    def __init__(self, step: Callable[[], None], device, generator=None):
        self._step = step
        self.device = torch.device(device)
        self.generator = generator
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}  # launches one replay makes
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
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = dict(build.LAUNCHES)
        try:
            with torch.cuda.graph(graph):
                self._step()
        finally:
            captured = build.take_launches(before)
        self.graph, self.launches = graph, captured
        self.capture_s = time.perf_counter() - t0

    def run(self, n: int) -> None:
        """n steps, enqueued on the current stream; no host read."""
        if n <= 0:
            return
        if self.device.type != "cuda":
            for _ in range(n):
                self._step()
            return
        if self.graph is None:
            self._capture()  # its warm-up is the first of the n steps
            n -= 1
        for _ in range(n):
            self.graph.replay()
        build.add_launches(self.launches, n)
        self.replays += n
