"""Reader/writer for the ``.xalm`` frozen-weight container (counterpart of
``xalm_tpu/io/container.py``; same wire format).

- ``uint64`` little-endian prefix H = header size = absolute offset of the
  data blob.
- UTF-8 JSON header ``{"xalm": {"version": 1}, "<Arch>": {"config": {...},
  "tensors": {name: {type, shape, offset, size, hash}}}}``, NUL-padded to a
  4096-aligned data start; tensor blobs are 32-byte aligned.

The file is mmapped once and tensors come out as zero-copy numpy views of
their raw storage (``uint16`` for bf16, ``uint8`` for fp8, see
``xalm_tpu_torch.dtypes``); ``load_torch`` wraps a copy as a torch tensor of
the logical dtype.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct

import numpy as np
import torch

from xalm_tpu_torch import dtypes as xdt
from xalm_tpu_torch.io.xxh3 import xxh3_64

__all__ = ["TensorInfo", "XalmFile", "write_xalm", "SUPPORTED_ARCHS"]

SUPPORTED_ARCHS = (
    "LlamaForCausalLM",
    "MistralForCausalLM",
    "GemmaForCausalLM",
    "Qwen2ForCausalLM",
    "MixtralForCausalLM",
    "Phi3ForCausalLM",
    "Gemma2ForCausalLM",
    "Qwen3ForCausalLM",
)

_ALIGN_TENSOR = 32
_ALIGN_DATA = 4096


def _align(offset: int, alignment: int) -> int:
    return (offset + alignment - 1) // alignment * alignment


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    name: str
    dtype: xdt.XDType
    shape: tuple[int, ...]
    offset: int  # absolute file offset
    size: int  # bytes
    hash: int | None = None


class XalmFile:
    """An open, mmapped .xalm container."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            prefix = f.read(8)
            if len(prefix) != 8:
                raise ValueError(f"{self.path}: truncated header")
            header_size = struct.unpack("<Q", prefix)[0]
            file_size = os.fstat(f.fileno()).st_size
            if header_size <= 8 or header_size > file_size:
                raise ValueError(
                    f"{self.path}: bad header size {header_size} for file size {file_size}"
                )
            raw = f.read(header_size - 8)
        header = json.loads(raw.split(b"\x00", 1)[0].decode("utf-8"))
        if header.get("xalm", {}).get("version") != 1:
            raise ValueError(f"{self.path}: xalm version mismatch: {header.get('xalm')}")

        self.arch: str | None = None
        self.config: dict = {}
        self.tensors: dict[str, TensorInfo] = {}
        for key, val in header.items():
            if key == "xalm":
                continue
            if key not in SUPPORTED_ARCHS:
                raise ValueError(f"{self.path}: unsupported model architecture: {key}")
            self.arch = key
            self.config = dict(val["config"])
            for name, meta in val["tensors"].items():
                shape = tuple(int(s) for s in meta["shape"])
                if len(shape) > 4:
                    raise ValueError(f"{name}: shape exceeds 4 dimensions")
                offset = int(meta["offset"])
                size = int(meta["size"])
                if offset < 0 or size < 0 or header_size + offset + size > file_size:
                    raise ValueError(f"{name}: offset/size out of range")
                dtype = xdt.parse(meta["type"])
                if dtype.nbytes(shape) != size:
                    raise ValueError(
                        f"{name}: size {size} != dtype/shape implied {dtype.nbytes(shape)}"
                    )
                self.tensors[name] = TensorInfo(
                    name, dtype, shape, header_size + offset, size, meta.get("hash")
                )
        if self.arch is None:
            raise ValueError(f"{self.path}: no architecture section in header")

        self._file = open(self.path, "rb")
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._view = np.frombuffer(self._mmap, dtype=np.uint8)

    def close(self) -> None:
        if getattr(self, "_mmap", None) is not None:
            self._view = None
            try:
                self._mmap.close()
            except BufferError:
                pass  # zero-copy views still alive; unmapped with the last one
            self._file.close()
            self._mmap = None

    def __enter__(self) -> "XalmFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def load(self, name: str) -> np.ndarray:
        """Zero-copy numpy view of a tensor's raw storage (read-only)."""
        info = self.tensors[name]
        raw = self._view[info.offset : info.offset + info.size]
        return raw.view(info.dtype.np_dtype).reshape(info.shape)

    def load_torch(self, name: str) -> torch.Tensor:
        """A host torch tensor (a copy) of the tensor's logical dtype."""
        info = self.tensors[name]
        return torch.from_numpy(np.array(self.load(name))).view(info.dtype.torch_dtype)

    def verify(self, name: str) -> bool:
        """Check the stored xxh3_64 content hash (io/xxh3.py)."""
        info = self.tensors[name]
        if info.hash is None:
            return True
        return xxh3_64(self._view[info.offset : info.offset + info.size]) == info.hash


_RAW_TYPES = {torch.bfloat16: (torch.int16, "bf16"), torch.float8_e4m3fn: (torch.uint8, "f8_e4m3"),
              torch.float8_e5m2: (torch.uint8, "f8_e5m2")}


def _blob_and_type(name: str, arr, tensors: dict) -> tuple[bytes, str]:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype in _RAW_TYPES:
            raw, tname = _RAW_TYPES[t.dtype]
            return t.view(raw).numpy().tobytes(), tname
        arr = t.numpy()
    dt = np.dtype(arr.dtype)
    names = {np.dtype(np.float32): "f32", np.dtype(np.float16): "f16",
             np.dtype(np.uint8): "u8"}
    if dt == np.dtype(np.int8):
        tname = "i8" if xdt.scale_name(name) in tensors else "q8"
    elif dt in names:
        tname = names[dt]
    else:
        raise ValueError(f"{name}: dtype {dt} has no xalm container type")
    return np.ascontiguousarray(arr).tobytes(), tname


def write_xalm(
    path: str | os.PathLike,
    arch: str,
    config: dict[str, str],
    tensors: dict,
    compute_hashes: bool = False,
) -> None:
    """Write a .xalm container. ``tensors`` maps names to numpy arrays or
    torch tensors (bf16 and fp8 only as torch); insertion order is the on-disk
    order. int8 tensors are `i8` when a ``<name>.scale`` sibling exists,
    else `q8`. Content hashes (xxh3_64) are off by default."""
    if arch not in SUPPORTED_ARCHS:
        raise ValueError(f"unsupported arch {arch}")
    meta_tensors: dict[str, dict] = {}
    blobs: list[bytes] = []
    offset = 0
    for name, arr in tensors.items():
        blob, tname = _blob_and_type(name, arr, tensors)
        offset = _align(offset, _ALIGN_TENSOR)
        entry = {
            "type": tname,
            "shape": [int(s) for s in arr.shape],
            "offset": offset,
            "size": len(blob),
        }
        if compute_hashes:
            entry["hash"] = xxh3_64(blob)
        meta_tensors[name] = entry
        blobs.append(blob)
        offset += len(blob)

    header = {"xalm": {"version": 1}, arch: {"config": config, "tensors": meta_tensors}}
    payload = json.dumps(header).encode("utf-8")
    data_start = _align(8 + len(payload) + 128, _ALIGN_DATA)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", data_start))
        f.write(payload)
        f.write(b"\x00" * (data_start - 8 - len(payload)))
        pos = data_start
        for blob, entry in zip(blobs, meta_tensors.values()):
            target = data_start + entry["offset"]
            if target > pos:
                f.write(b"\x00" * (target - pos))
                pos = target
            f.write(blob)
            pos += len(blob)
