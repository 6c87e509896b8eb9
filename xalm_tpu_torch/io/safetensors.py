"""The safetensors format, read without the ``safetensors`` package: an
8-byte little-endian header length N, then N bytes of a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...,
"__metadata__": {...}}`` (offsets from the end of the header), then the
raw little-endian tensor bytes.

``read_safetensors`` maps the file copy-on-write and returns torch tensors
that are views of the map (bf16 and fp8 as torch's own dtypes: no
``ml_dtypes``).
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import numpy as np
import torch

__all__ = ["read_safetensors", "DTYPES"]

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, in the header's order, as a
    torch tensor viewing the file's copy-on-write map."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (n,) = struct.unpack("<Q", mm[:8])
    if n > len(mm) - 8:
        raise ValueError(f"{path}: header of {n} bytes overruns the file")
    header = json.loads(bytes(mm[8 : 8 + n]))
    base = 8 + n
    out: dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = DTYPES.get(meta["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name}: unsupported dtype {meta['dtype']}")
        begin, end = meta["data_offsets"]
        shape = [int(s) for s in meta["shape"]]
        count = int(np.prod(shape)) if shape else 1
        if end - begin != count * dt.itemsize or base + end > len(mm):
            raise ValueError(f"{path}: tensor {name}: bad data offsets {begin, end}")
        t = torch.frombuffer(mm, dtype=dt, count=count, offset=base + begin) if count else \
            torch.empty((0,), dtype=dt)
        out[name] = t.reshape(shape)
    return out
