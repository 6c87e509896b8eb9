"""xalm v2 block store (counterpart of ``xalm_tpu/io/blockstore.py``): a
hash-keyed, 32-byte-aligned, lazily loaded blob container, the format of
session files (runtime/session.py).

Wire format (little-endian), the same bytes as the JAX writer's:

    [magic  b"XBK2"] [u32 version = 2]
    [u64 index_size] [index JSON, NUL-padded so the blobs start 32-aligned]
    blobs, each 32-byte aligned

    index JSON: {"blocks": [{"key": str, "khash": int, "dtype": str,
                             "shape": [int...], "offset": int, "size": int,
                             "hash": int}],
                 "meta": {<user metadata>}}

``offset`` is relative to the end of the padded index; ``khash`` and
``hash`` are XXH3-64 of the key and of the blob (io/xxh3.py, the port's own;
``hash`` 0 means not computed, which both readers accept). ``dtype`` is
``np.dtype(...).str``. A bf16 tensor is stored as its 16-bit patterns under
``"<V2"``, the string the JAX writer gives ml_dtypes' bfloat16; numpy reads
that back as a 2-byte void, which ``to_torch`` maps back to bf16 (f16 is
``"<f2"``, so the two never meet). Neither ``xxhash`` nor ``ml_dtypes`` is
needed.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct

import numpy as np
import torch

from xalm_tpu_torch.io.xxh3 import xxh3_64

__all__ = ["BF16_DTYPE_STR", "BlockInfo", "BlockStore", "to_torch", "write_blocks"]

_MAGIC = b"XBK2"
_VERSION = 2
_ALIGN = 32
BF16_DTYPE_STR = "<V2"  # np.dtype(ml_dtypes.bfloat16).str


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _khash(key: str) -> int:
    return xxh3_64(key.encode("utf-8"))


@dataclasses.dataclass(frozen=True)
class BlockInfo:
    key: str
    khash: int
    dtype: np.dtype
    shape: tuple[int, ...]
    offset: int  # absolute file offset
    size: int
    hash: int


def _host_array(arr) -> tuple[np.ndarray, str]:
    """A block's contiguous host array and its dtype string: torch tensors
    are copied to the host, bf16 as its 16-bit patterns under "<V2"."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16_DTYPE_STR
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    return arr, np.dtype(arr.dtype).str


def write_blocks(path: str | os.PathLike, blocks: dict, meta: dict | None = None,
                 compute_hashes: bool = True) -> None:
    """Write a block store; insertion order is the on-disk order. Values are
    numpy arrays or torch tensors (on any device)."""
    entries, arrays = [], []
    offset = 0
    for key, arr in blocks.items():
        host, dstr = _host_array(arr)
        offset = _align(offset)
        entries.append({
            "key": key,
            "khash": _khash(key),
            "dtype": dstr,
            "shape": [int(s) for s in host.shape],
            "offset": offset,
            "size": host.nbytes,
            "hash": xxh3_64(host.reshape(-1)) if compute_hashes else 0,
        })
        arrays.append(host)
        offset += host.nbytes

    index = json.dumps({"blocks": entries, "meta": meta or {}}).encode("utf-8")
    index_size = _align(len(index) + 16) - 16
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", _VERSION))
        f.write(struct.pack("<Q", index_size))
        f.write(index)
        f.write(b"\x00" * (index_size - len(index)))
        data_start = 16 + index_size
        pos = data_start
        for host, e in zip(arrays, entries):
            target = data_start + e["offset"]
            if target > pos:
                f.write(b"\x00" * (target - pos))
                pos = target
            f.write(memoryview(host.reshape(-1)).cast("B"))
            pos += host.nbytes


class BlockStore:
    """Read side: the index read eagerly (every key hash checked), the blobs
    mmap'd and read lazily."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            head = f.read(16)
            if len(head) != 16 or head[:4] != _MAGIC:
                raise ValueError(f"{self.path}: not an xalm v2 block store")
            version = struct.unpack("<I", head[4:8])[0]
            if version != _VERSION:
                raise ValueError(f"{self.path}: unsupported version {version}")
            index_size = struct.unpack("<Q", head[8:16])[0]
            raw = f.read(index_size)
            if len(raw) != index_size:
                raise ValueError(f"{self.path}: truncated index")
        index = json.loads(raw.split(b"\x00", 1)[0].decode("utf-8"))
        self.meta: dict = index.get("meta", {})

        data_start = 16 + index_size
        file_size = os.path.getsize(self.path)
        self.blocks: dict[str, BlockInfo] = {}
        self._by_hash: dict[int, BlockInfo] = {}
        for e in index["blocks"]:
            info = BlockInfo(
                key=e["key"], khash=int(e["khash"]), dtype=np.dtype(e["dtype"]),
                shape=tuple(int(s) for s in e["shape"]), offset=data_start + int(e["offset"]),
                size=int(e["size"]), hash=int(e["hash"]),
            )
            if info.offset % _ALIGN or info.offset + info.size > file_size:
                raise ValueError(f"{self.path}: block {info.key} out of bounds/misaligned")
            if info.khash != _khash(info.key):
                raise ValueError(f"{self.path}: block {info.key} key-hash mismatch")
            self.blocks[info.key] = info
            self._by_hash[info.khash] = info

        self._file = open(self.path, "rb")
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._view = np.frombuffer(self._mmap, dtype=np.uint8)

    def __contains__(self, key: str) -> bool:
        return key in self.blocks

    def keys(self):
        return self.blocks.keys()

    def get(self, key: str | int) -> np.ndarray:
        """Zero-copy view of a block by key (or key hash)."""
        info = self._by_hash[key] if isinstance(key, int) else self.blocks[key]
        raw = self._view[info.offset: info.offset + info.size]
        return raw.view(info.dtype).reshape(info.shape)

    def verify(self, key: str) -> bool:
        """The block's content hash checked (True when none was stored)."""
        info = self.blocks[key]
        if info.hash == 0:
            return True
        return xxh3_64(self._view[info.offset: info.offset + info.size]) == info.hash

    def close(self) -> None:
        if getattr(self, "_mmap", None) is not None:
            self._view = None
            try:
                self._mmap.close()
            except BufferError:  # a view handed out by get() still holds the map
                pass
            self._file.close()
            self._mmap = None

    def __enter__(self) -> "BlockStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def to_torch(arr: np.ndarray) -> torch.Tensor:
    """A host tensor (a copy) of a block: a 2-byte void block (bf16 as the
    JAX writer and ``write_blocks`` store it) comes back as bf16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))
