"""Ahead-of-time builds and collective counts (counterpart of
``xalm_tpu/parallel/aot.py``).

The JAX module compiles a sharded step for a named TPU topology with no
chip attached, and counts the collectives in the optimised executable.
The port's kernels are plain CUDA libraries compiled by ``nvcc`` for
``sm_90a``, which needs the toolkit and no card: ``build_kernels`` builds
every one of them ahead of time (into ``build/xalm_tpu_torch/``, where
the first ``load_library`` finds them). The port's collectives are
Python calls (``parallel/mesh.Axis``), so ``collective_stats`` counts
them as a step issues them, from ``mesh.COLLECTIVES``, replays of a
captured step included.

    python -m xalm_tpu_torch.parallel.aot     # build every kernel library

``topology_mesh``, ``abstract_engine`` and ``compile_step`` are TPU
compiler entry points with no CUDA meaning; they are not ported.
"""

from __future__ import annotations

import json
import sys

from xalm_tpu_torch.parallel import mesh as comm

__all__ = ["build_kernels", "collective_stats"]


def build_kernels() -> dict:
    """Build every kernel library (all ``nvcc`` runs at once) and return
    {source: {"path", "seconds"}} (0 seconds where it was built already).
    Raises where ``nvcc`` is missing or refuses a source."""
    from xalm_tpu_torch.ops import build

    build.start_all()
    out = {}
    for name in build.KERNELS:
        path, seconds = build.wait(name)
        out[name] = {"path": str(path), "seconds": seconds}
    return out


def collective_stats(step, *args, **kw) -> dict:
    """Run ``step(*args, **kw)`` once and return the collectives it issued
    over groups of more than one rank: {"all_reduce": {"calls", "bytes"},
    "broadcast": {...}}."""
    before = comm._snapshot()
    step(*args, **kw)
    after = comm._snapshot()
    return {k: {f: after[k][f] - before[k][f] for f in ("calls", "bytes")} for k in after}


if __name__ == "__main__":
    print(json.dumps(build_kernels(), indent=1))
    sys.exit(0)
