"""XXH3-64 (seed 0, the default secret): the hash the xalm containers store
for their keys and blobs, kept here so the port needs no ``xxhash``.

Inputs of 0-240 bytes (every key) run the reference's short paths on
Python integers. Longer inputs run the long path: the input's 1024-byte
blocks (16 stripes of 64 bytes each) accumulate independently of the
accumulator, so each block's eight lane sums are computed at once with
numpy over a slab of blocks; only the per-block scramble is sequential,
one step of eight lanes a block (about 3 s a GB on one CPU core).
"""

from __future__ import annotations

import numpy as np

__all__ = ["xxh3_64"]

_M64 = (1 << 64) - 1
_P32_1, _P32_2, _P32_3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
_P64_1, _P64_2, _P64_3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P64_4, _P64_5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_PMX1, _PMX2 = 0x165667919E3779F9, 0x9FB21C651E98DF25

_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
_STRIPE = 64
_STRIPES_PER_BLOCK = (len(_SECRET) - _STRIPE) // 8  # 16
_BLOCK = _STRIPE * _STRIPES_PER_BLOCK  # 1024 bytes
_SLAB_BLOCKS = 8192  # blocks whose lane sums numpy computes in one pass (8 MiB)


def _r64(b, i: int) -> int:
    return int.from_bytes(b[i:i + 8], "little")


def _r32(b, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _mul_fold(a: int, b: int) -> int:
    p = a * b
    return (p & _M64) ^ (p >> 64)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX1) & _M64
    return h ^ (h >> 32)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _rrmxmx(h: int, n: int) -> int:
    h ^= _rotl(h, 49) ^ _rotl(h, 24)
    h = (h * _PMX2) & _M64
    h ^= (h >> 35) + n
    h = (h * _PMX2) & _M64
    return h ^ (h >> 28)


def _mix16(b, i: int, s: int) -> int:
    return _mul_fold(_r64(b, i) ^ _r64(_SECRET, s), _r64(b, i + 8) ^ _r64(_SECRET, s + 8))


def _short(b: bytes) -> int:
    n = len(b)
    if n == 0:
        return _xxh64_avalanche(_r64(_SECRET, 56) ^ _r64(_SECRET, 64))
    if n <= 3:
        combined = (b[0] << 16) | (b[n >> 1] << 24) | b[n - 1] | (n << 8)
        return _xxh64_avalanche(combined ^ (_r32(_SECRET, 0) ^ _r32(_SECRET, 4)))
    if n <= 8:
        x = (_r32(b, n - 4) + (_r32(b, 0) << 32)) & _M64
        return _rrmxmx(x ^ (_r64(_SECRET, 8) ^ _r64(_SECRET, 16)), n)
    if n <= 16:
        lo = _r64(b, 0) ^ (_r64(_SECRET, 24) ^ _r64(_SECRET, 32))
        hi = _r64(b, n - 8) ^ (_r64(_SECRET, 40) ^ _r64(_SECRET, 48))
        swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
        return _avalanche((n + swapped + hi + _mul_fold(lo, hi)) & _M64)
    acc = n * _P64_1
    if n <= 128:
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(b, 48, 96) + _mix16(b, n - 64, 112)
                acc += _mix16(b, 32, 64) + _mix16(b, n - 48, 80)
            acc += _mix16(b, 16, 32) + _mix16(b, n - 32, 48)
        acc += _mix16(b, 0, 0) + _mix16(b, n - 16, 16)
        return _avalanche(acc & _M64)
    for i in range(8):
        acc += _mix16(b, 16 * i, 16 * i)
    acc = _avalanche(acc & _M64)
    for i in range(8, n // 16):
        acc += _mix16(b, 16 * i, 16 * (i - 8) + 3)
    acc += _mix16(b, n - 16, 136 - 17)
    return _avalanche(acc & _M64)


def _secret_words(offset: int, count: int) -> np.ndarray:
    return np.frombuffer(_SECRET[offset:offset + 8 * count], dtype="<u8").astype(np.uint64)


# the key words of stripe s, lane i: secret[8 s + 8 i]
_KEYS = np.stack([_secret_words(8 * s, 8) for s in range(_STRIPES_PER_BLOCK)])  # (16, 8)
_LO32 = np.uint64(0xFFFFFFFF)
_SH32, _SH47 = np.uint64(32), np.uint64(47)
_SWAP = np.array([1, 0, 3, 2, 5, 4, 7, 6])  # lane i's data value feeds lane i ^ 1


def _lane_sums(words: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """words (..., S, 8) uint64 of S stripes, keys (S, 8) -> each lane's
    accumulate over the stripes (..., 8), mod 2^64."""
    dk = words ^ keys
    prod = (dk & _LO32) * (dk >> _SH32)
    with np.errstate(over="ignore"):
        return prod.sum(axis=-2, dtype=np.uint64) + words[..., _SWAP].sum(axis=-2, dtype=np.uint64)


def _long(buf: np.ndarray) -> int:
    n = buf.size
    acc = np.array([_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1],
                   dtype=np.uint64)
    scramble_key = _secret_words(len(_SECRET) - _STRIPE, 8)
    p32_1 = np.uint64(_P32_1)
    nb = (n - 1) // _BLOCK
    with np.errstate(over="ignore"):
        for b0 in range(0, nb, _SLAB_BLOCKS):
            b1 = min(nb, b0 + _SLAB_BLOCKS)
            words = buf[b0 * _BLOCK:b1 * _BLOCK].view("<u8").reshape(b1 - b0, _STRIPES_PER_BLOCK, 8)
            for c in _lane_sums(words, _KEYS):
                acc += c
                acc ^= acc >> _SH47
                acc ^= scramble_key
                acc *= p32_1
        stripes = ((n - 1) - _BLOCK * nb) // _STRIPE
        if stripes:
            tail = buf[nb * _BLOCK:nb * _BLOCK + stripes * _STRIPE].view("<u8").reshape(stripes, 8)
            acc += _lane_sums(tail, _KEYS[:stripes])
        last = np.frombuffer(buf[n - _STRIPE:].tobytes(), dtype="<u8").reshape(1, 8)
        acc += _lane_sums(last, _secret_words(len(_SECRET) - _STRIPE - 7, 8)[None])
    lanes = [int(a) for a in acc]
    out = n * _P64_1
    for i in range(4):
        out += _mul_fold(lanes[2 * i] ^ _r64(_SECRET, 11 + 16 * i),
                         lanes[2 * i + 1] ^ _r64(_SECRET, 11 + 16 * i + 8))
    return _avalanche(out & _M64)


def xxh3_64(data) -> int:
    """XXH3-64 of ``data`` (bytes, or any buffer such as a contiguous numpy
    array), seed 0: equal to ``xxhash.xxh3_64(data).intdigest()``."""
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    if buf.size <= 240:
        return _short(buf.tobytes())
    return _long(buf)
