"""Streaming histogram with a unicode sparkline (the port's own copy of
``xalm_tpu/obs/stats.py``).

Weight-distribution inspection for quantization work: per-row histograms in
tensor dumps, per-tensor cells in container listings, and scale suggestions
for quantization ranges. Adds accumulate into an oversampled internal grid
(``bins * _OVERSAMPLE`` cells) anchored to the running [min, max]; a
range-extending batch re-bins the existing cells into the new anchor by
cell-center assignment, so memory is O(bins) however much data is added,
with bin-placement error bounded by 1/_OVERSAMPLE of a bin.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Histogram"]

_BLOCKS = " ▁▂▃▄▅▆▇█"
_OVERSAMPLE = 64


class Histogram:
    def __init__(self, data=None, bins: int = 10):
        self.bins = bins
        self._cells = np.zeros(bins * _OVERSAMPLE, np.int64)
        self.min = np.inf
        self.max = -np.inf
        self.sum = 0.0
        self.n = 0
        if data is not None:
            self.add(data)

    def _grid(self, lo: float, hi: float) -> tuple[float, float]:
        if hi <= lo:
            hi = lo + 1e-12
        return lo, hi

    def add(self, data) -> "Histogram":
        arr = np.asarray(data, np.float64).ravel()
        if arr.size == 0:
            return self
        new_min = min(self.min, float(arr.min()))
        new_max = max(self.max, float(arr.max()))
        if self.n and (new_min < self.min or new_max > self.max):
            # re-anchor: move each existing cell's mass to the new cell
            # containing its center
            old_lo, old_hi = self._grid(self.min, self.max)
            lo, hi = self._grid(new_min, new_max)
            m = self._cells.size
            centers = old_lo + (np.arange(m) + 0.5) * (old_hi - old_lo) / m
            idx = np.clip(((centers - lo) / (hi - lo) * m).astype(int), 0, m - 1)
            self._cells = np.bincount(idx, weights=self._cells, minlength=m).astype(np.int64)
        self.min, self.max = new_min, new_max
        lo, hi = self._grid(self.min, self.max)
        m = self._cells.size
        idx = np.clip(((arr - lo) / (hi - lo) * m).astype(int), 0, m - 1)
        self._cells += np.bincount(idx, minlength=m)
        self.sum += float(arr.sum())
        self.n += arr.size
        return self

    @property
    def counts(self) -> np.ndarray:
        return self._cells.reshape(self.bins, _OVERSAMPLE).sum(axis=1)

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def sparkline(self) -> str:
        """Unicode block-char histogram (reference stats.h:38-53)."""
        counts = self.counts
        peak = counts.max() if counts.size else 0
        if peak == 0:
            return " " * self.bins
        return "".join(_BLOCKS[int(c / peak * (len(_BLOCKS) - 1))] for c in counts)

    def suggest_scale(self, target_max: float = 1.0) -> tuple[float, float]:
        """(offset, scale) mapping the data range onto [-target_max, target_max]
        — the quantization-range helper (reference stats.h)."""
        if self.n == 0:
            return 0.0, 1.0
        offset = (self.max + self.min) / 2
        half = max(self.max - offset, offset - self.min, 1e-12)
        return offset, target_max / half

    def format(self) -> str:
        return (
            f"[{self.sparkline()}] min={self.min:+.4g} max={self.max:+.4g} "
            f"mean={self.mean:+.4g} n={self.n}"
        )
