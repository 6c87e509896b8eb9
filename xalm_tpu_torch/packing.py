"""Sub-byte weight packers (host-side numpy; the port's own copy of
``xalm_tpu/packing.py``).

- ``pack_bits`` / ``unpack_bits``: tight MSB-first bitstream packing for any
  width in 2..16 bits.
- ``qi8``: affine [-1, 1] <-> u8.
- ``qi4`` / ``qi3``: clamp-to-[-1, 1] 4- and 3-bit affine grids packed tight.
- ``f4_e2m1`` / ``f6_e3m2``: packed mini-floats through ``floatlab`` (code 0
  decodes to 0.0).

Packed tensors are interchange artifacts: the converter round-trips them to
measure quantization error (``--analyze``) or to store their values; the
card's kernels take hardware dtypes only.
"""

from __future__ import annotations

import numpy as np

from xalm_tpu_torch import floatlab

__all__ = [
    "pack_bits",
    "unpack_bits",
    "packed_size",
    "quantize_qi8",
    "dequantize_qi8",
    "quantize_qi4",
    "dequantize_qi4",
    "quantize_qi3",
    "dequantize_qi3",
    "quantize_f4_e2m1",
    "dequantize_f4_e2m1",
    "quantize_f6_e3m2",
    "dequantize_f6_e3m2",
]


# ---------------------------------------------------------------------------
# generic MSB-first bitstream packing
# ---------------------------------------------------------------------------


def packed_size(count: int, bits: int) -> int:
    return (count * bits + 7) // 8


def pack_bits(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack unsigned ints into a tight MSB-first bitstream (uint8)."""
    if not 2 <= bits <= 16:
        raise ValueError("bits must be in 2..16")
    v = np.asarray(values).reshape(-1)
    if v.dtype.kind not in "ui":
        raise ValueError(f"values must be unsigned ints, got {v.dtype}")
    if v.min(initial=0) < 0 or v.max(initial=0) >= (1 << bits):
        raise ValueError(f"values out of range for {bits}-bit packing")
    v16 = v.astype(np.uint16)
    # each value -> its `bits` bits, MSB first
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint16)
    bitmat = ((v16[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    return np.packbits(bitmat.reshape(-1), bitorder="big")


def unpack_bits(raw: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Inverse of pack_bits; returns `count` uint16 values."""
    b = np.unpackbits(np.asarray(raw, dtype=np.uint8), bitorder="big")
    b = b[: count * bits].reshape(count, bits).astype(np.uint16)
    weights = (1 << np.arange(bits - 1, -1, -1, dtype=np.uint16))[None, :]
    return (b * weights).sum(axis=1, dtype=np.uint16)


# ---------------------------------------------------------------------------
# affine [-1, 1] grids
# ---------------------------------------------------------------------------


def _affine_quant(x: np.ndarray, levels_half: float) -> np.ndarray:
    c = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    return np.round((c + 1.0) * levels_half).astype(np.uint16)


def quantize_qi8(x: np.ndarray) -> np.ndarray:
    return np.clip(_affine_quant(x, 127.5), 0, 255).astype(np.uint8)


def dequantize_qi8(q: np.ndarray) -> np.ndarray:
    return (np.asarray(q, np.float32) / 127.5) - 1.0


def quantize_qi4(x: np.ndarray) -> np.ndarray:
    return pack_bits(np.clip(_affine_quant(x, 7.5), 0, 15), 4)


def dequantize_qi4(raw: np.ndarray, count: int) -> np.ndarray:
    return (unpack_bits(raw, 4, count).astype(np.float32) / 7.5) - 1.0


def quantize_qi3(x: np.ndarray) -> np.ndarray:
    return pack_bits(np.clip(_affine_quant(x, 3.5), 0, 7), 3)


def dequantize_qi3(raw: np.ndarray, count: int) -> np.ndarray:
    return (unpack_bits(raw, 3, count).astype(np.float32) / 3.5) - 1.0


# ---------------------------------------------------------------------------
# packed mini-floats
# ---------------------------------------------------------------------------


def quantize_f4_e2m1(x: np.ndarray) -> np.ndarray:
    return pack_bits(floatlab.F4_E2M1.encode(x).astype(np.uint16), 4)


def dequantize_f4_e2m1(raw: np.ndarray, count: int) -> np.ndarray:
    return floatlab.F4_E2M1.decode(unpack_bits(raw, 4, count))


def quantize_f6_e3m2(x: np.ndarray) -> np.ndarray:
    return pack_bits(floatlab.F6_E3M2.encode(x).astype(np.uint16), 6)


def dequantize_f6_e3m2(raw: np.ndarray, count: int) -> np.ndarray:
    return floatlab.F6_E3M2.decode(unpack_bits(raw, 6, count))
