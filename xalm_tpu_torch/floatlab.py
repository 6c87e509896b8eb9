"""Configurable mini-float laboratory (numpy; the port's own copy of
``xalm_tpu/floatlab.py``).

A parameterized float format — exponent/mantissa split, bias, denormal
support, optional NaN codes, and a pluggable mantissa mapping (linear / log
/ piecewise) — with vectorized encode/decode and a ``describe()`` dump of
every representable encoding.

An offline analysis tool for designing weight formats (the converter's
``--analyze`` mode and the packing codecs use it); nothing here runs on the
card, whose kernels take hardware dtypes only (bf16, fp8, int8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

__all__ = [
    "FloatSpec",
    "MAPPINGS",
    "F4_E2M1",
    "F6_E2M3",
    "F6_E3M2",
    "F8_E2M5",
    "F8_E3M4",
    "F8_E4M3",
    "F8_E5M2",
]


# Mantissa mappings: fraction-in-[0,1) -> multiplier-in-[1,2) and inverse.
# (reference types.h:635-675 exposes linear/log/piecewise mantissa curves.)
def _lin_fwd(f: np.ndarray) -> np.ndarray:
    return 1.0 + f


def _lin_inv(m: np.ndarray) -> np.ndarray:
    return m - 1.0


def _log_fwd(f: np.ndarray) -> np.ndarray:
    return np.exp2(f)


def _log_inv(m: np.ndarray) -> np.ndarray:
    return np.log2(m)


def _piecewise_fwd(f: np.ndarray) -> np.ndarray:
    # denser codes near 1.0: quadratic ease-in over the first half, then linear
    return np.where(f < 0.5, 1.0 + f * f, 1.25 + (f - 0.5) * 1.5)


def _piecewise_inv(m: np.ndarray) -> np.ndarray:
    x = m - 1.0
    return np.where(x < 0.25, np.sqrt(np.maximum(x, 0.0)), 0.5 + (x - 0.25) / 1.5)


MAPPINGS: dict[str, tuple[Callable, Callable]] = {
    "linear": (_lin_fwd, _lin_inv),
    "log": (_log_fwd, _log_inv),
    "piecewise": (_piecewise_fwd, _piecewise_inv),
}


@dataclass(frozen=True)
class FloatSpec:
    """A 1+E+M-bit signed mini-float format."""

    exp_bits: int
    man_bits: int
    bias: int | None = None  # default: 2^(E-1) - 1
    denormals: bool = True
    has_nan: bool = False  # reserve the top code (all-ones exp, max mantissa)
    mapping: str = "linear"
    name: str = field(default="")

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def _bias(self) -> int:
        return self.bias if self.bias is not None else (1 << (self.exp_bits - 1)) - 1

    @property
    def n_codes(self) -> int:
        return 1 << self.bits

    def _fwd_inv(self):
        return MAPPINGS[self.mapping]

    def max_value(self) -> float:
        e_max = (1 << self.exp_bits) - 1
        m_max = (1 << self.man_bits) - 1
        if self.has_nan:
            m_max -= 1  # top code is NaN
        fwd, _ = self._fwd_inv()
        frac = m_max / (1 << self.man_bits)
        return float(fwd(np.array(frac)) * 2.0 ** (e_max - self._bias))

    # -- decode ------------------------------------------------------------

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """uint codes -> float32 values."""
        c = np.asarray(codes, dtype=np.uint32)
        sign = np.where((c >> (self.exp_bits + self.man_bits)) & 1, -1.0, 1.0)
        e = ((c >> self.man_bits) & ((1 << self.exp_bits) - 1)).astype(np.int32)
        m = (c & ((1 << self.man_bits) - 1)).astype(np.float64)
        fwd, _ = self._fwd_inv()
        frac = m / (1 << self.man_bits)
        normal = fwd(frac) * np.exp2(e - self._bias)
        if self.denormals:
            sub = frac * np.exp2(1 - self._bias)
            val = np.where(e == 0, sub, normal)
        else:
            val = normal
        out = (sign * val).astype(np.float32)
        if self.has_nan:
            top = (1 << (self.exp_bits + self.man_bits)) - 1  # all-ones exp+man
            out = np.where((c & top) == top, np.float32(np.nan), out)
        return out

    # -- encode ------------------------------------------------------------

    def encode(self, x: np.ndarray) -> np.ndarray:
        """float values -> nearest uint codes (round to nearest by value)."""
        xf = np.asarray(x, dtype=np.float32)
        # decode every non-negative code once; binary-search by value
        half = self.n_codes // 2
        pos_codes = np.arange(half, dtype=np.uint32)
        pos_vals = self.decode(pos_codes)
        finite = np.isfinite(pos_vals)
        order = np.argsort(pos_vals[finite], kind="stable")
        grid_codes = pos_codes[finite][order]
        grid_vals = pos_vals[finite][order]
        mag = np.abs(xf)
        idx = np.searchsorted(grid_vals, mag).clip(1, grid_vals.size - 1)
        lo, hi = grid_vals[idx - 1], grid_vals[idx]
        pick = np.where(mag - lo <= hi - mag, idx - 1, idx)
        # values below the smallest grid point snap to it
        pick = np.where(mag <= grid_vals[0], 0, pick)
        code = grid_codes[pick]
        sign = (xf < 0).astype(np.uint32) << (self.exp_bits + self.man_bits)
        out = (code | sign).astype(np.uint32)
        # non-finite inputs: emit the reserved NaN code when the format has
        # one (searchsorted on NaN otherwise lands on the largest finite
        # code), else raise — there is no honest encoding for them
        bad = ~np.isfinite(xf)
        if bad.any():
            if not self.has_nan:
                raise ValueError(
                    f"{self.name or 'format'} has no NaN/Inf encoding for "
                    f"non-finite inputs"
                )
            nan_code = np.uint32((1 << (self.exp_bits + self.man_bits)) - 1)
            out = np.where(bad, nan_code, out)
        return out

    def roundtrip(self, x: np.ndarray) -> np.ndarray:
        return self.decode(self.encode(x))

    # -- inspection ----------------------------------------------------------

    def describe(self) -> str:
        """Dump every encoding: code, sign/exp/man fields, decoded value
        (reference types.h `describe()`)."""
        lines = [
            f"{self.name or 'float'}: 1s.{self.exp_bits}e.{self.man_bits}m "
            f"bias={self._bias} denormals={self.denormals} nan={self.has_nan} "
            f"mapping={self.mapping} max={self.max_value():g}"
        ]
        for c in range(self.n_codes):
            s = (c >> (self.exp_bits + self.man_bits)) & 1
            e = (c >> self.man_bits) & ((1 << self.exp_bits) - 1)
            m = c & ((1 << self.man_bits) - 1)
            v = float(self.decode(np.array([c]))[0])
            lines.append(
                f"  {c:0{self.bits}b}  s={s} e={e:0{self.exp_bits}b} "
                f"m={m:0{self.man_bits}b}  -> {v:g}"
            )
        return "\n".join(lines)


F4_E2M1 = FloatSpec(2, 1, name="f4_e2m1")
F6_E2M3 = FloatSpec(2, 3, name="f6_e2m3")
F6_E3M2 = FloatSpec(3, 2, name="f6_e3m2")
F8_E4M3 = FloatSpec(4, 3, has_nan=True, name="f8_e4m3")
F8_E5M2 = FloatSpec(5, 2, has_nan=True, name="f8_e5m2")
# the reference's software f8_t instantiates all four E+M==7 splits
# (reference src/types.h:317-320); e2m5/e3m4 have no hardware dtype — they
# exist only as analysis formats, saturating like the reference (no NaN code)
F8_E2M5 = FloatSpec(2, 5, name="f8_e2m5")
F8_E3M4 = FloatSpec(3, 4, name="f8_e3m4")
