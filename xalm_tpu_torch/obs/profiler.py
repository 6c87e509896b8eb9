"""Name-keyed aggregate wall-time profiler (the port's own copy of
``xalm_tpu/obs/profiler.py``).

``with profile(name):`` adds the block's host wall time and one call to
the entry ``name`` of a process-wide table; ``report()`` formats the table
(scopes by total time), ``reset()`` clears it, ``get(name)`` reads one
entry.

Times are the host's clock, not the card's. The harness's spans (``model
load``, and one per mode: ``completion``, ``perplexity``, ``passkey``) each
end where the host waits for the card (a synchronize after the load; the
mode's read of its last tokens or log-probs), so each span's time includes
the device time of the work launched inside it. A span that ended before
its work did would measure the enqueue. This module has no device-time
column (CUDA events).
"""

from __future__ import annotations

import contextlib
import threading
import time

from xalm_tpu_torch.obs.table import Table

__all__ = ["profile", "report", "reset", "get"]

_lock = threading.Lock()
_entries: dict[str, list[float]] = {}  # name -> [total_seconds, calls]


@contextlib.contextmanager
def profile(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            e = _entries.setdefault(name, [0.0, 0])
            e[0] += dt
            e[1] += 1


def get(name: str) -> tuple[float, int]:
    with _lock:
        e = _entries.get(name, [0.0, 0])
        return e[0], int(e[1])


def reset() -> None:
    with _lock:
        _entries.clear()


def report() -> str:
    tbl = Table(["scope", "calls", "total ms", "avg us"])
    with _lock:
        for name, (total, calls) in sorted(_entries.items(), key=lambda kv: -kv[1][0]):
            tbl.add(name, calls, f"{total * 1e3:.2f}", f"{total / max(calls, 1) * 1e6:.1f}")
    return tbl.format(title="profiler report")
