"""GGML/GGUF block-quantization codecs (numpy, vectorized; the port's own
copy of ``xalm_tpu/gguf.py``, bit-equal to it codec by codec).

Quantize + dequantize for BF16 / Q4_0 / Q4_1 / Q5_0 / Q5_1 / Q8_0 / TQ1_0 /
TQ2_0; dequantize for the K-quants (Q2_K..Q6_K), the table-lookup IQ4
formats (IQ4_NL / IQ4_XS) and the codebook IQ formats (IQ1_S/M, IQ2_XXS/XS/S,
IQ3_XXS/S), whose constant lattice codebooks are carried as data in
``xalm_tpu_torch/data/iq_grids.npz``; the ksigns table is algorithmic
(7-bit index + parity bit) and is generated, not stored. Every entry of the
size registry decodes.

These codecs exist for checkpoint interchange: the converter ingests or
emits GGUF-packed tensors, round-tripping them through f32. Nothing here
runs on the card. The bit layouts follow the public GGML format
(ggml-quants.c / gguf-py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

QK = 32  # small-block width (Q4_0 family)
QK_K = 256  # super-block width (K-quants, ternary, IQ)


# ---------------------------------------------------------------------------
# size registry: name -> (elements per block, bytes per block)
# (reference quants.py:44-77)
# ---------------------------------------------------------------------------

GGUF_SIZES: dict[str, tuple[int, int]] = {
    "f32": (1, 4),
    "f16": (1, 2),
    "bf16": (1, 2),
    "f64": (1, 8),
    "i8": (1, 1),
    "i16": (1, 2),
    "i32": (1, 4),
    "i64": (1, 8),
    "q4_0": (QK, 2 + QK // 2),
    "q4_1": (QK, 2 + 2 + QK // 2),
    "q5_0": (QK, 2 + 4 + QK // 2),
    "q5_1": (QK, 2 + 2 + 4 + QK // 2),
    "q8_0": (QK, 2 + QK),
    "q8_1": (QK, 4 + 4 + QK),
    "q2_k": (QK_K, 2 + 2 + QK_K // 16 + QK_K // 4),
    "q3_k": (QK_K, 2 + QK_K // 4 + QK_K // 8 + 12),
    "q4_k": (QK_K, 2 + 2 + 12 + QK_K // 2),
    "q5_k": (QK_K, 2 + 2 + 12 + QK_K // 8 + QK_K // 2),
    "q6_k": (QK_K, 2 + QK_K // 2 + QK_K // 4 + QK_K // 16),
    "q8_k": (QK_K, 4 + QK_K + QK_K // 8),
    "tq1_0": (QK_K, 2 + 4 * 13),
    "tq2_0": (QK_K, 2 + QK_K // 4),
    "iq4_nl": (QK, 2 + QK // 2),
    "iq4_xs": (QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
    # codebook formats (decode via the constant grids in data/iq_grids.npz)
    "iq1_s": (QK_K, 2 + QK_K // 8 + QK_K // 16),
    "iq1_m": (QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
    "iq2_xxs": (QK_K, 2 + QK_K // 4),
    "iq2_xs": (QK_K, 2 + QK_K // 4 + QK_K // 32),
    "iq2_s": (QK_K, 2 + QK_K // 4 + QK_K // 16),
    "iq3_xxs": (QK_K, 2 + QK_K // 4 + QK_K // 8),
    "iq3_s": (QK_K, 2 + QK_K // 4 + QK_K // 8 + QK_K // 32 + 4),
}

# IQ4 non-linear 4-bit code table (public GGML kvalues_iq4nl).
IQ4_TABLE = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.int8,
)


# ---------------------------------------------------------------------------
# bit-twiddling helpers
# ---------------------------------------------------------------------------


def _round_away(x: np.ndarray) -> np.ndarray:
    """Round half away from zero (ggml rounding for int grids)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def _f16_bytes(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).view(np.uint8)


def _read_f16(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view(np.float16).astype(np.float32)


def _safe_recip(d: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))


def _split(b: np.ndarray, *widths: int) -> list[np.ndarray]:
    """Split the trailing byte axis at cumulative widths; remainder last."""
    out, at = [], 0
    for w in widths:
        out.append(b[:, at : at + w])
        at += w
    out.append(b[:, at:])
    return out


def _lo_hi_nibbles(qs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return qs & np.uint8(0x0F), qs >> np.uint8(4)


def _pack_nibbles(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (lo & np.uint8(0x0F)) | (hi << np.uint8(4))


def _bits_le(b: np.ndarray, n: int) -> np.ndarray:
    """Expand a little-endian byte field (nb, n//8) into (nb, n) 0/1 uint8."""
    return np.unpackbits(b, axis=-1, bitorder="little")[:, :n]


def _blocks(x: np.ndarray, block: int) -> np.ndarray:
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if flat.size % block != 0:
        raise ValueError(f"size {flat.size} not a multiple of block {block}")
    return flat.reshape(-1, block)


# ---------------------------------------------------------------------------
# scalar / trivial codecs
# ---------------------------------------------------------------------------


def _bf16_quant(blocks: np.ndarray) -> np.ndarray:
    # round-to-nearest-even with NaN quieting (reference types.h:322-335 /
    # quants.py bf16 path)
    u = blocks.reshape(-1).view(np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    quiet = (u & np.uint32(0xFFFF0000)) | np.uint32(0x00400000)
    rounded = ((u.astype(np.uint64) + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    out = np.where(nan, (quiet >> 16).astype(np.uint16), rounded)
    return out.view(np.uint8).reshape(blocks.shape[0], -1)


def _bf16_dequant(b: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(b).view(np.uint16).astype(np.uint32) << 16
    return u.view(np.float32).reshape(b.shape[0], -1)


# ---------------------------------------------------------------------------
# Q4/Q5/Q8 small-block codecs (32-element blocks)
# ---------------------------------------------------------------------------


def _absmax_anchor(blocks: np.ndarray) -> np.ndarray:
    """Signed value with the largest magnitude in each row (keeps its sign,
    which is why d can be negative — matches ggml)."""
    idx = np.abs(blocks).argmax(axis=-1, keepdims=True)
    return np.take_along_axis(blocks, idx, axis=-1)


def _q4_0_quant(blocks: np.ndarray) -> np.ndarray:
    d = _absmax_anchor(blocks) / -8.0
    q = np.trunc(blocks.astype(np.float64) * _safe_recip(d).astype(np.float64) + 8.5)
    q = np.clip(q, 0, 15).astype(np.uint8)
    qs = _pack_nibbles(q[:, :16], q[:, 16:])
    return np.concatenate([_f16_bytes(d), qs], axis=-1)


def _q4_0_dequant(b: np.ndarray) -> np.ndarray:
    d, qs, _ = _split(b, 2, 16)
    lo, hi = _lo_hi_nibbles(qs)
    q = np.concatenate([lo, hi], axis=-1).astype(np.int8) - np.int8(8)
    return _read_f16(d) * q.astype(np.float32)


def _q4_1_quant(blocks: np.ndarray) -> np.ndarray:
    mn = blocks.min(axis=-1, keepdims=True)
    d = (blocks.max(axis=-1, keepdims=True) - mn) / 15.0
    q = np.trunc((blocks - mn) * _safe_recip(d) + 0.5)
    q = np.clip(q, 0, 15).astype(np.uint8)
    qs = _pack_nibbles(q[:, :16], q[:, 16:])
    return np.concatenate([_f16_bytes(d), _f16_bytes(mn), qs], axis=-1)


def _q4_1_dequant(b: np.ndarray) -> np.ndarray:
    d, m, qs, _ = _split(b, 2, 2, 16)
    lo, hi = _lo_hi_nibbles(qs)
    q = np.concatenate([lo, hi], axis=-1).astype(np.float32)
    return _read_f16(d) * q + _read_f16(m)


def _q5_pack(q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """5-bit codes -> (low-nibble bytes, 32-bit high-bit field)."""
    qs = _pack_nibbles(q[:, :16], q[:, 16:])
    qh = np.packbits(q >> np.uint8(4), axis=-1, bitorder="little")
    return qs, qh


def _q5_unpack(qs: np.ndarray, qh: np.ndarray) -> np.ndarray:
    lo, hi = _lo_hi_nibbles(qs)
    low5 = np.concatenate([lo, hi], axis=-1)
    high = _bits_le(qh, 32)
    return low5 | (high << np.uint8(4))


def _q5_0_quant(blocks: np.ndarray) -> np.ndarray:
    d = _absmax_anchor(blocks) / -16.0
    q = np.trunc(blocks.astype(np.float64) * _safe_recip(d).astype(np.float64) + 16.5)
    q = np.clip(q, 0, 31).astype(np.uint8)
    qs, qh = _q5_pack(q)
    return np.concatenate([_f16_bytes(d), qh, qs], axis=-1)


def _q5_0_dequant(b: np.ndarray) -> np.ndarray:
    d, qh, qs, _ = _split(b, 2, 4, 16)
    q = _q5_unpack(qs, qh).astype(np.int8) - np.int8(16)
    return _read_f16(d) * q.astype(np.float32)


def _q5_1_quant(blocks: np.ndarray) -> np.ndarray:
    mn = blocks.min(axis=-1, keepdims=True)
    d = (blocks.max(axis=-1, keepdims=True) - mn) / 31.0
    q = np.trunc((blocks - mn) * _safe_recip(d) + 0.5)
    q = np.clip(q, 0, 31).astype(np.uint8)
    qs, qh = _q5_pack(q)
    return np.concatenate([_f16_bytes(d), _f16_bytes(mn), qh, qs], axis=-1)


def _q5_1_dequant(b: np.ndarray) -> np.ndarray:
    d, m, qh, qs, _ = _split(b, 2, 2, 4, 16)
    q = _q5_unpack(qs, qh).astype(np.float32)
    return _read_f16(d) * q + _read_f16(m)


def _q8_0_quant(blocks: np.ndarray) -> np.ndarray:
    d = np.abs(blocks).max(axis=-1, keepdims=True) / 127.0
    q = _round_away(blocks * _safe_recip(d)).astype(np.int8)
    return np.concatenate([_f16_bytes(d), q.view(np.uint8)], axis=-1)


def _q8_0_dequant(b: np.ndarray) -> np.ndarray:
    d, qs, _ = _split(b, 2, 32)
    return _read_f16(d) * qs.view(np.int8).astype(np.float32)


# ---------------------------------------------------------------------------
# ternary codecs (TQ1_0 / TQ2_0, 256-element super-blocks)
# ---------------------------------------------------------------------------
# TQ1_0 packs base-3 digits five-per-byte (x 256/243 fixed-point), layout
# [qs0:32B -> elems 0..159][qs1:16B -> 160..239][qh:4B -> 240..255][d:f16].


def _ternary_digits(x: np.ndarray, d: np.ndarray) -> np.ndarray:
    q = _round_away(x * _safe_recip(d))
    return (q.astype(np.int8) + np.int8(1)).astype(np.uint8)  # {0,1,2}


def _tq1_pack_group(t: np.ndarray, lanes: int, depth: int) -> np.ndarray:
    """Pack (nb, depth*lanes) trits into (nb, lanes) bytes, digit p of byte j
    being trit[p*lanes + j] (most-significant first)."""
    nb = t.shape[0]
    w = (3 ** np.arange(depth - 1, -1, -1, dtype=np.uint16)).reshape(1, depth, 1)
    acc = (t.reshape(nb, depth, lanes).astype(np.uint16) * w).sum(axis=1)
    return ((acc * 256 + 242) // 243).astype(np.uint8)


def _tq1_unpack_group(b: np.ndarray, lanes: int, depth: int) -> np.ndarray:
    nb = b.shape[0]
    # multiply mod 256 shifts the wanted base-3 digit to the top (ggml trick)
    mul = (3 ** np.arange(depth, dtype=np.uint16)).astype(np.uint8).reshape(1, depth, 1)
    shifted = b.reshape(nb, 1, lanes) * mul  # uint8 wraparound intended
    digit = ((shifted.astype(np.uint16) * 3) >> 8).astype(np.int8) - np.int8(1)
    return digit.reshape(nb, depth * lanes)


def _tq1_0_quant(blocks: np.ndarray) -> np.ndarray:
    d = np.abs(blocks).max(axis=-1, keepdims=True)
    t = _ternary_digits(blocks, d)
    qs0 = _tq1_pack_group(t[:, :160], 32, 5)
    qs1 = _tq1_pack_group(t[:, 160:240], 16, 5)
    # the trailing 16 elements pack 4 digits deep (weights 81..3, ggml layout)
    nb = t.shape[0]
    w = (3 ** np.arange(4, 0, -1, dtype=np.uint16)).reshape(1, 4, 1)
    acc = (t[:, 240:].reshape(nb, 4, 4).astype(np.uint16) * w).sum(axis=1)
    qh = ((acc * 256 + 242) // 243).astype(np.uint8)
    return np.concatenate([qs0, qs1, qh, _f16_bytes(d)], axis=-1)


def _tq1_0_dequant(b: np.ndarray) -> np.ndarray:
    qs, qh, d, _ = _split(b, 48, 4, 2)
    e0 = _tq1_unpack_group(qs[:, :32], 32, 5)
    e1 = _tq1_unpack_group(qs[:, 32:], 16, 5)
    e2 = _tq1_unpack_group(qh, 4, 4)
    q = np.concatenate([e0, e1, e2], axis=-1).astype(np.float32)
    return _read_f16(d) * q


def _tq2_0_quant(blocks: np.ndarray) -> np.ndarray:
    d = np.abs(blocks).max(axis=-1, keepdims=True)
    t = _ternary_digits(blocks, d)
    nb = t.shape[0]
    g = t.reshape(nb, 2, 4, 32) << np.array([0, 2, 4, 6], np.uint8).reshape(1, 1, 4, 1)
    qs = np.bitwise_or.reduce(g, axis=2).reshape(nb, 64)
    return np.concatenate([qs, _f16_bytes(d)], axis=-1)


def _tq2_0_dequant(b: np.ndarray) -> np.ndarray:
    qs, d, _ = _split(b, 64, 2)
    nb = b.shape[0]
    g = qs.reshape(nb, 2, 1, 32) >> np.array([0, 2, 4, 6], np.uint8).reshape(1, 1, 4, 1)
    q = (g & np.uint8(3)).reshape(nb, QK_K).astype(np.int8) - np.int8(1)
    return _read_f16(d) * q.astype(np.float32)


# ---------------------------------------------------------------------------
# K-quants (dequantize only, like the reference)
# ---------------------------------------------------------------------------


def _q2_k_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    scales, qs, d, dmin, _ = _split(b, 16, 64, 2, 2)
    dl = (_read_f16(d) * (scales & np.uint8(0x0F)).astype(np.float32)).reshape(nb, 16, 1)
    ml = (_read_f16(dmin) * (scales >> np.uint8(4)).astype(np.float32)).reshape(nb, 16, 1)
    g = qs.reshape(nb, 2, 1, 32) >> np.array([0, 2, 4, 6], np.uint8).reshape(1, 1, 4, 1)
    q = (g & np.uint8(3)).reshape(nb, 16, 16).astype(np.float32)
    return (dl * q - ml).reshape(nb, QK_K)


def _q3_k_scales(scales: np.ndarray) -> np.ndarray:
    """Unpack 16 6-bit signed scales from the 12-byte K-scale field."""
    nb = scales.shape[0]
    lo = (scales[:, None, :8] >> np.array([0, 4], np.uint8).reshape(1, 2, 1)).reshape(nb, 16)
    hi = (scales[:, None, 8:] >> np.array([0, 2, 4, 6], np.uint8).reshape(1, 4, 1)).reshape(nb, 16)
    s = (lo & np.uint8(0x0F)) | ((hi & np.uint8(0x03)) << np.uint8(4))
    return s.astype(np.int8) - np.int8(32)


def _q3_k_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    hmask, qs, scales, d, _ = _split(b, 32, 64, 12, 2)
    dl = (_read_f16(d) * _q3_k_scales(scales).astype(np.float32)).reshape(nb, 16, 1)
    ql = qs.reshape(nb, 2, 1, 32) >> np.array([0, 2, 4, 6], np.uint8).reshape(1, 1, 4, 1)
    ql = (ql & np.uint8(3)).reshape(nb, 16, 16)
    qh = hmask.reshape(nb, 1, 1, 32) >> np.arange(8, dtype=np.uint8).reshape(1, 1, 8, 1)
    qh = ((qh & np.uint8(1)) ^ np.uint8(1)).reshape(nb, 16, 16)  # offset 0 when bit set
    q = (ql.astype(np.int8) - (qh << np.uint8(2)).astype(np.int8)).astype(np.float32)
    return (dl * q).reshape(nb, QK_K)


def _k_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack 8 (scale, min) 6-bit pairs from the 12-byte Q4_K/Q5_K field."""
    nb = scales.shape[0]
    a, m, x = scales[:, 0:4], scales[:, 4:8], scales[:, 8:12]
    sc = np.concatenate([a & 0x3F, (x & 0x0F) | ((a >> 2) & 0x30)], axis=-1)
    mn = np.concatenate([m & 0x3F, (x >> 4) | ((m >> 2) & 0x30)], axis=-1)
    return sc.reshape(nb, 8), mn.reshape(nb, 8)


def _q4_k_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    d, dmin, scales, qs, _ = _split(b, 2, 2, 12, 128)
    sc, mn = _k_scale_min(scales)
    dl = (_read_f16(d) * sc.astype(np.float32)).reshape(nb, 8, 1)
    ml = (_read_f16(dmin) * mn.astype(np.float32)).reshape(nb, 8, 1)
    g = qs.reshape(nb, 4, 1, 32) >> np.array([0, 4], np.uint8).reshape(1, 1, 2, 1)
    q = (g & np.uint8(0x0F)).reshape(nb, 8, 32).astype(np.float32)
    return (dl * q - ml).reshape(nb, QK_K)


def _q5_k_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    d, dmin, scales, qh, qs, _ = _split(b, 2, 2, 12, 32, 128)
    sc, mn = _k_scale_min(scales)
    dl = (_read_f16(d) * sc.astype(np.float32)).reshape(nb, 8, 1)
    ml = (_read_f16(dmin) * mn.astype(np.float32)).reshape(nb, 8, 1)
    lo = qs.reshape(nb, 4, 1, 32) >> np.array([0, 4], np.uint8).reshape(1, 1, 2, 1)
    lo = (lo & np.uint8(0x0F)).reshape(nb, 8, 32)
    hi = qh.reshape(nb, 1, 1, 32) >> np.arange(8, dtype=np.uint8).reshape(1, 1, 8, 1)
    hi = (hi & np.uint8(1)).reshape(nb, 8, 32)
    q = (lo | (hi << np.uint8(4))).astype(np.float32)
    return (dl * q - ml).reshape(nb, QK_K)


def _q6_k_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    ql, qh, scales, d, _ = _split(b, 128, 64, 16, 2)
    dl = (_read_f16(d) * scales.view(np.int8).astype(np.float32)).reshape(nb, 16, 1)
    lo = ql.reshape(nb, 2, 1, 64) >> np.array([0, 4], np.uint8).reshape(1, 1, 2, 1)
    lo = (lo & np.uint8(0x0F)).reshape(nb, 8, 32)
    hi = qh.reshape(nb, 2, 1, 32) >> np.array([0, 2, 4, 6], np.uint8).reshape(1, 1, 4, 1)
    hi = (hi & np.uint8(3)).reshape(nb, 8, 32)
    q = ((lo | (hi << np.uint8(4))).astype(np.int8) - np.int8(32)).astype(np.float32)
    return (dl * q.reshape(nb, 16, 16)).reshape(nb, QK_K)


# ---------------------------------------------------------------------------
# IQ4 table-lookup codecs (dequantize only)
# ---------------------------------------------------------------------------


def _iq4_lookup(codes: np.ndarray) -> np.ndarray:
    return IQ4_TABLE[codes.reshape(-1)].reshape(codes.shape).astype(np.float32)


def _iq4_nl_dequant(b: np.ndarray) -> np.ndarray:
    d, qs, _ = _split(b, 2, 16)
    lo, hi = _lo_hi_nibbles(qs)
    q = _iq4_lookup(np.concatenate([lo, hi], axis=-1))
    return _read_f16(d) * q


def _iq4_xs_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    d, sh, sl, qs, _ = _split(b, 2, 2, 4, 128)
    lo = (sl[:, :, None] >> np.array([0, 4], np.uint8).reshape(1, 1, 2)).reshape(nb, 8)
    hi = (np.ascontiguousarray(sh).view(np.uint16) >> (2 * np.arange(8, dtype=np.uint16)).reshape(1, 8)).astype(np.uint8)
    sc = (((lo & np.uint8(0x0F)) | ((hi & np.uint8(3)) << np.uint8(4))).astype(np.int8) - np.int8(32)).astype(np.float32)
    dl = (_read_f16(d) * sc).reshape(nb, 8, 1)
    g = qs.reshape(nb, 8, 1, 16) >> np.array([0, 4], np.uint8).reshape(1, 1, 2, 1)
    q = _iq4_lookup((g & np.uint8(0x0F)).reshape(nb, 8, 32))
    return (dl * q).reshape(nb, QK_K)


# ---------------------------------------------------------------------------
# IQ codebook codecs (dequantize only). Elements come in 8-wide (IQ1/IQ2) or
# 4-wide (IQ3) codebook rows; a 7-bit ksigns index flips signs per element
# for the XXS/XS variants, raw sign bitfields for the S variants.
# (reference quants.py:719-1281; grids extracted by tools/extract_iq_grids.py)
# ---------------------------------------------------------------------------

_IQ_GRIDS: dict[str, np.ndarray] | None = None


def _iq_grid(name: str) -> np.ndarray:
    global _IQ_GRIDS
    if _IQ_GRIDS is None:
        from pathlib import Path

        path = Path(__file__).parent / "data" / "iq_grids.npz"
        with np.load(path) as z:
            _IQ_GRIDS = {k: z[k].astype(np.float32) for k in z.files}
    return _IQ_GRIDS[name]


def _ksign_table() -> np.ndarray:
    """(128, 8) f32 sign factors: entry i, bit j. Bits 0-6 are the index
    itself; bit 7 is the parity of bits 0-6 (so every byte has even weight)."""
    i = np.arange(128, dtype=np.uint8)
    bits = np.unpackbits(i[:, None], axis=1, bitorder="little")[:, :8]
    bits[:, 7] = bits[:, :7].sum(axis=1) % 2
    return np.where(bits == 1, np.float32(-1), np.float32(1))


_KSIGNS = _ksign_table()


def _sign_bits(bytes_: np.ndarray) -> np.ndarray:
    """Raw sign bitfield -> (..., 8) f32 factors (bit set = negative)."""
    bits = np.unpackbits(bytes_.reshape(-1, 1), axis=1, bitorder="little")
    return np.where(bits == 1, np.float32(-1), np.float32(1)).reshape(
        *bytes_.shape, 8
    )


def _nibbles(b: np.ndarray) -> np.ndarray:
    """(nb, n) bytes -> (nb, 2n) low-then-high nibbles per byte, interleaved."""
    nb = b.shape[0]
    return np.stack([b & np.uint8(0x0F), b >> np.uint8(4)], axis=-1).reshape(nb, -1)


def _iq2_xxs_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    d, qs = _split(b, 2)
    d = _read_f16(d)  # (nb, 1)
    w = np.ascontiguousarray(qs).view(np.uint32).reshape(nb, -1, 2)
    idx = np.ascontiguousarray(w[..., 0]).view(np.uint8).reshape(nb, -1, 4)
    grid = _iq_grid("iq2_xxs")[idx.reshape(-1)].reshape(nb, -1, 4, 8)
    sidx = (w[..., 1][..., None] >> np.array([0, 7, 14, 21], np.uint32)) & np.uint32(0x7F)
    signs = _KSIGNS[sidx.reshape(-1)].reshape(nb, -1, 4, 8)
    db = d * (0.5 + (w[..., 1] >> 28).astype(np.float32)) * 0.25  # (nb, 8)
    return (db[..., None, None] * grid * signs).reshape(nb, QK_K)


def _iq2_xs_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    d, qs, scales = _split(b, 2, 2 * QK_K // 8)
    d = _read_f16(d)
    q16 = np.ascontiguousarray(qs).view(np.uint16)  # (nb, 32)
    grid = _iq_grid("iq2_xs")[(q16 & np.uint16(511)).reshape(-1)].reshape(nb, -1, 8)
    signs = _KSIGNS[(q16 >> 9).reshape(-1)].reshape(nb, -1, 8)
    sc = _nibbles(scales).astype(np.float32)  # (nb, 16), one per 2 words
    db = (d * (0.5 + sc) * 0.25).repeat(2, axis=1)  # (nb, 32)
    return (db[..., None] * grid * signs).reshape(nb, QK_K)


def _iq2_s_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    d, qs, sbytes, qh, scales = _split(b, 2, QK_K // 8, QK_K // 8, QK_K // 32)
    d = _read_f16(d)
    hi = (qh[..., None] >> np.array([0, 2, 4, 6], np.uint8)) & np.uint8(3)
    idx = qs.astype(np.uint16) | (hi.reshape(nb, -1).astype(np.uint16) << 8)
    grid = _iq_grid("iq2_s")[idx.reshape(-1)].reshape(nb, -1, 8)
    signs = _sign_bits(sbytes)  # (nb, 32, 8)
    sc = _nibbles(scales).astype(np.float32)
    db = (d * (0.5 + sc) * 0.25).repeat(2, axis=1)
    return (db[..., None] * grid * signs).reshape(nb, QK_K)


def _iq3_xxs_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    d, qs, sw = _split(b, 2, QK_K // 4)
    d = _read_f16(d)
    w = np.ascontiguousarray(sw).view(np.uint32)  # (nb, 8): signs + scale
    grid = _iq_grid("iq3_xxs")[qs.reshape(-1)].reshape(nb, -1, 32)  # 8 qs/word
    sidx = (w[..., None] >> np.array([0, 7, 14, 21], np.uint32)) & np.uint32(0x7F)
    signs = _KSIGNS[sidx.reshape(-1)].reshape(nb, -1, 32)
    db = d * (0.5 + (w >> 28).astype(np.float32)) * 0.5  # (nb, 8)
    return (db[..., None] * grid * signs).reshape(nb, QK_K)


def _iq3_s_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    d, qs, qh, sbytes, scales = _split(b, 2, QK_K // 4, QK_K // 32, QK_K // 8)
    d = _read_f16(d)
    hi = (qh[..., None] >> np.arange(8, dtype=np.uint8)) & np.uint8(1)
    idx = qs.astype(np.uint16) | (hi.reshape(nb, -1).astype(np.uint16) << 8)
    grid = _iq_grid("iq3_s")[idx.reshape(-1)].reshape(nb, -1, 4)
    signs = _sign_bits(sbytes).reshape(nb, -1, 4)  # 256 sign bits
    sc = _nibbles(scales).astype(np.float32)  # (nb, 8), one per 32 elems
    db = (d * (1.0 + 2.0 * sc)).repeat(8, axis=1)  # one per qs byte
    return (db[..., None] * grid * signs).reshape(nb, QK_K)


def _iq1_s_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    d, qs, qh = _split(b, 2, QK_K // 8)
    d = _read_f16(d)
    h16 = np.ascontiguousarray(qh).view(np.uint16)  # (nb, 8), one per 4 qs
    hi = (h16[..., None] >> np.array([0, 3, 6, 9], np.uint16)) & np.uint16(7)
    idx = qs.reshape(nb, -1, 4).astype(np.uint16) | (hi << 8)
    grid = _iq_grid("iq1")[idx.reshape(-1)].reshape(nb, -1, 4, 8)
    dl = d * (2.0 * ((h16 >> 12) & np.uint16(7)).astype(np.float32) + 1.0)
    delta = np.where((h16 & np.uint16(0x8000)) == 0, np.float32(0.125), np.float32(-0.125))
    return (dl[..., None, None] * (grid + delta[..., None, None])).reshape(nb, QK_K)


def _iq1_m_dequant(b: np.ndarray) -> np.ndarray:
    nb = b.shape[0]
    qs, qh, scales = _split(b, QK_K // 8, QK_K // 16)
    s16 = np.ascontiguousarray(scales).view(np.uint16)  # (nb, 4)
    # the f16 super-scale is sliced across the top nibbles of the four words
    dbits = (s16 & np.uint16(0xF000)) >> np.array([12, 8, 4, 0], np.uint16)
    d = (
        np.bitwise_or.reduce(dbits, axis=-1)
        .astype(np.uint16)
        .view(np.float16)
        .astype(np.float32)
        .reshape(nb, 1)
    )
    sc = ((s16[..., None] >> np.array([0, 3, 6, 9], np.uint16)) & np.uint16(7)).reshape(nb, -1)
    dl = (d * (2.0 * sc.astype(np.float32) + 1.0)).repeat(2, axis=1)  # per qs byte
    nib = _nibbles(qh)  # (nb, 32), one per qs byte
    idx = qs.astype(np.uint16) | ((nib & np.uint8(7)).astype(np.uint16) << 8)
    grid = _iq_grid("iq1")[idx.reshape(-1)].reshape(nb, -1, 8)
    delta = np.where((nib & np.uint8(8)) == 0, np.float32(0.125), np.float32(-0.125))
    return (dl[..., None] * (grid + delta[..., None])).reshape(nb, QK_K)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Codec:
    name: str
    block: int
    nbytes: int
    quant: Callable[[np.ndarray], np.ndarray] | None
    dequant: Callable[[np.ndarray], np.ndarray] | None


def _codec_table() -> dict[str, Codec]:
    defs: dict[str, tuple] = {
        "bf16": (_bf16_quant, _bf16_dequant),
        "q4_0": (_q4_0_quant, _q4_0_dequant),
        "q4_1": (_q4_1_quant, _q4_1_dequant),
        "q5_0": (_q5_0_quant, _q5_0_dequant),
        "q5_1": (_q5_1_quant, _q5_1_dequant),
        "q8_0": (_q8_0_quant, _q8_0_dequant),
        "tq1_0": (_tq1_0_quant, _tq1_0_dequant),
        "tq2_0": (_tq2_0_quant, _tq2_0_dequant),
        "q2_k": (None, _q2_k_dequant),
        "q3_k": (None, _q3_k_dequant),
        "q4_k": (None, _q4_k_dequant),
        "q5_k": (None, _q5_k_dequant),
        "q6_k": (None, _q6_k_dequant),
        "iq4_nl": (None, _iq4_nl_dequant),
        "iq4_xs": (None, _iq4_xs_dequant),
        "iq1_s": (None, _iq1_s_dequant),
        "iq1_m": (None, _iq1_m_dequant),
        "iq2_xxs": (None, _iq2_xxs_dequant),
        "iq2_xs": (None, _iq2_xs_dequant),
        "iq2_s": (None, _iq2_s_dequant),
        "iq3_xxs": (None, _iq3_xxs_dequant),
        "iq3_s": (None, _iq3_s_dequant),
    }
    table = {}
    for name, (q, dq) in defs.items():
        block, nbytes = GGUF_SIZES[name]
        table[name] = Codec(name, block, nbytes, q, dq)
    return table


CODECS = _codec_table()


def quant_byte_size(n_elems: int, name: str) -> int:
    block, nbytes = GGUF_SIZES[name]
    if n_elems % block:
        raise ValueError(f"{n_elems} elements not a multiple of {name} block {block}")
    return n_elems // block * nbytes


def quantize(x: np.ndarray, name: str) -> np.ndarray:
    """Quantize a float array into packed GGUF block bytes (uint8, flat)."""
    name = name.lower()
    if name == "f32":
        return np.ascontiguousarray(x, np.float32).view(np.uint8).reshape(-1)
    if name == "f16":
        return np.ascontiguousarray(x, np.float16).view(np.uint8).reshape(-1)
    c = CODECS.get(name)
    if c is None or c.quant is None:
        raise NotImplementedError(f"no GGUF quantizer for '{name}'")
    return c.quant(_blocks(x, c.block)).reshape(-1)


def dequantize(raw: np.ndarray, name: str, shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Decode packed GGUF block bytes back to float32."""
    name = name.lower()
    raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    if name == "f32":
        out = raw.view(np.float32)
    elif name == "f16":
        out = raw.view(np.float16).astype(np.float32)
    else:
        c = CODECS.get(name)
        if c is None or c.dequant is None:
            raise NotImplementedError(f"no GGUF dequantizer for '{name}'")
        if raw.size % c.nbytes:
            raise ValueError(f"byte length {raw.size} not a multiple of {name} block bytes {c.nbytes}")
        out = c.dequant(raw.reshape(-1, c.nbytes)).reshape(-1)
    return out.reshape(shape) if shape is not None else out
