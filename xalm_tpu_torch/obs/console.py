"""ANSI console helpers, a threaded progress bar and process resource usage
(the port's own copy of ``xalm_tpu/obs/console.py``).

- color printing and a fatal ``error``;
- threaded ``ProgressBar`` repainting every 100 ms on a terminal, reporting
  wall/user/sys time on completion (``Engine.from_xalm``'s loading bar);
- ``SystemUsage``: getrusage and monotonic-clock deltas — user/sys/wall ms,
  page faults, swaps, block I/O, context switches, max RSS — with a table
  renderer, and the ``scoped_usage`` context manager.
"""

from __future__ import annotations

import contextlib
import os
import resource
import sys
import threading
import time
from dataclasses import dataclass

from xalm_tpu_torch.obs.table import Table

__all__ = ["info", "warn", "error", "ProgressBar", "SystemUsage", "scoped_usage"]

_RESET = "\x1b[0m"
_COLORS = {"red": "\x1b[31m", "green": "\x1b[32m", "yellow": "\x1b[33m", "cyan": "\x1b[36m", "dim": "\x1b[2m"}


def _tty(stream) -> bool:
    return hasattr(stream, "isatty") and stream.isatty() and os.environ.get("NO_COLOR") is None


def _paint(msg: str, color: str, stream) -> str:
    if _tty(stream) and color in _COLORS:
        return f"{_COLORS[color]}{msg}{_RESET}"
    return msg


def info(msg: str, color: str = "") -> None:
    print(_paint(msg, color, sys.stdout), flush=True)


def warn(msg: str) -> None:
    print(_paint(msg, "yellow", sys.stderr), file=sys.stderr, flush=True)


def error(msg: str, code: int = 1) -> None:
    """Print in red and exit (reference console::error exits, console.h:8-84)."""
    print(_paint(f"error: {msg}", "red", sys.stderr), file=sys.stderr, flush=True)
    raise SystemExit(code)


# ---------------------------------------------------------------------------
# resource usage
# ---------------------------------------------------------------------------


@dataclass
class SystemUsage:
    """Delta of getrusage(RUSAGE_SELF) + wall clock between two points."""

    wall_ms: float = 0.0
    user_ms: float = 0.0
    sys_ms: float = 0.0
    minor_faults: int = 0
    major_faults: int = 0
    swaps: int = 0
    block_in: int = 0
    block_out: int = 0
    vol_ctx_switches: int = 0
    invol_ctx_switches: int = 0
    max_rss_kb: int = 0

    @staticmethod
    def _now() -> tuple[float, resource.struct_rusage]:
        return time.monotonic(), resource.getrusage(resource.RUSAGE_SELF)

    @classmethod
    def measure(cls, t0: float, r0: resource.struct_rusage) -> "SystemUsage":
        t1, r1 = cls._now()
        return cls(
            wall_ms=(t1 - t0) * 1e3,
            user_ms=(r1.ru_utime - r0.ru_utime) * 1e3,
            sys_ms=(r1.ru_stime - r0.ru_stime) * 1e3,
            minor_faults=r1.ru_minflt - r0.ru_minflt,
            major_faults=r1.ru_majflt - r0.ru_majflt,
            swaps=r1.ru_nswap - r0.ru_nswap,
            block_in=r1.ru_inblock - r0.ru_inblock,
            block_out=r1.ru_oublock - r0.ru_oublock,
            vol_ctx_switches=r1.ru_nvcsw - r0.ru_nvcsw,
            invol_ctx_switches=r1.ru_nivcsw - r0.ru_nivcsw,
            max_rss_kb=r1.ru_maxrss,
        )

    def format(self, title: str = "system usage") -> str:
        tbl = Table(["metric", "value"])
        rows = [
            ("wall time", f"{self.wall_ms:.1f} ms"),
            ("user time", f"{self.user_ms:.1f} ms"),
            ("sys time", f"{self.sys_ms:.1f} ms"),
            ("page faults (minor)", f"{self.minor_faults:,}"),
            ("page faults (major)", f"{self.major_faults:,}"),
            ("swaps", f"{self.swaps:,}"),
            ("block reads", f"{self.block_in:,}"),
            ("block writes", f"{self.block_out:,}"),
            ("ctx switches (vol)", f"{self.vol_ctx_switches:,}"),
            ("ctx switches (invol)", f"{self.invol_ctx_switches:,}"),
            ("max rss", f"{self.max_rss_kb:,} kB"),
        ]
        for k, v in rows:
            tbl.add(k, v)
        return tbl.format(title=title)

    def summary(self) -> str:
        return f"wall {self.wall_ms:.0f} ms | user {self.user_ms:.0f} ms | sys {self.sys_ms:.0f} ms"


@contextlib.contextmanager
def scoped_usage(label: str = "", report: bool = True):
    """RAII-style stage timer (reference profiler.h:167-178). Yields a dict
    whose 'usage' key holds the SystemUsage after the block exits."""
    t0, r0 = SystemUsage._now()
    out: dict = {}
    try:
        yield out
    finally:
        u = SystemUsage.measure(t0, r0)
        out["usage"] = u
        if report:
            prefix = f"{label}: " if label else ""
            print(_paint(f"{prefix}{u.summary()}", "dim", sys.stderr), file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# progress bar
# ---------------------------------------------------------------------------


class ProgressBar:
    """Threaded progress bar: repaints every `interval` seconds on stderr,
    prints a wall/user/sys summary when done (reference console.h:86-238).

    Usage::

        with ProgressBar("loading", total=n_layers) as bar:
            for _ in range(n_layers):
                ...
                bar.advance()
    """

    WIDTH = 32

    def __init__(self, label: str, total: int, interval: float = 0.1, stream=None):
        self.label = label
        self.total = max(total, 1)
        self.interval = interval
        self.stream = stream if stream is not None else sys.stderr
        self._done = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = 0.0
        self._r0: resource.struct_rusage | None = None

    def advance(self, n: int = 1) -> None:
        with self._lock:
            self._done += n

    def set(self, done: int) -> None:
        with self._lock:
            self._done = done

    def _render(self) -> str:
        with self._lock:
            done = self._done
        frac = min(done / self.total, 1.0)
        filled = int(frac * self.WIDTH)
        bar = "█" * filled + "░" * (self.WIDTH - filled)
        return f"\r{self.label} [{bar}] {done}/{self.total}"

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            if _tty(self.stream):
                self.stream.write(self._render())
                self.stream.flush()

    def __enter__(self) -> "ProgressBar":
        self._t0, self._r0 = SystemUsage._now()
        self._thread = threading.Thread(target=self._run, daemon=True, name="xalm-progress")
        self._thread.start()
        return self

    def __exit__(self, exc_type, *_) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        usage = SystemUsage.measure(self._t0, self._r0)
        if _tty(self.stream):
            self.stream.write(self._render() + "\n")
        if exc_type is None:
            self.stream.write(f"{self.label}: done ({usage.summary()})\n")
            self.stream.flush()
