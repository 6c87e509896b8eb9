"""Container dtype registry (counterpart of ``xalm_tpu/dtypes.py``).

The JAX package maps container type names to ``ml_dtypes`` numpy dtypes.
This port does not use ``ml_dtypes``: bf16 and fp8 are read as raw
``uint16``/``uint8`` storage and reinterpreted as torch tensors with
``.view(torch.bfloat16)`` / ``.view(torch.float8_e4m3fn)``. Container types:

==========  ================  ===============  ================================
name        numpy storage     torch dtype      notes
==========  ================  ===============  ================================
f32         float32           float32
f16         float16           float16
bf16        uint16 (raw)      bfloat16         raw bits, viewed as bf16
q8          int8              int8             fixed scale 1/100
u8          uint8             uint8            raw bytes (tokenizer.tokens)
i8          int8              int8             per-row f32 ``<name>.scale``
f8_e4m3     uint8 (raw)       float8_e4m3fn    raw bits, viewed as fp8
f8_e5m2     uint8 (raw)       float8_e5m2      raw bits, viewed as fp8
==========  ================  ===============  ================================
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["XDType", "parse", "REGISTRY", "SCALE_SUFFIX", "scale_name", "is_scale_name"]

SCALE_SUFFIX = ".scale"


@dataclasses.dataclass(frozen=True)
class XDType:
    """A container dtype: name, raw numpy storage dtype, torch dtype and
    quantization tag."""

    name: str
    np_dtype: np.dtype
    torch_dtype: torch.dtype
    fixed_scale: float | None = None
    scaled: bool = False

    @property
    def bits(self) -> int:
        return self.np_dtype.itemsize * 8

    def nbytes(self, shape: tuple[int, ...]) -> int:
        n = 1
        for s in shape:
            n *= int(s)
        return n * self.np_dtype.itemsize


REGISTRY: dict[str, XDType] = {
    t.name: t
    for t in (
        XDType("f32", np.dtype(np.float32), torch.float32),
        XDType("f16", np.dtype(np.float16), torch.float16),
        XDType("bf16", np.dtype(np.uint16), torch.bfloat16),
        XDType("q8", np.dtype(np.int8), torch.int8, fixed_scale=1.0 / 100.0),
        XDType("u8", np.dtype(np.uint8), torch.uint8),
        XDType("i8", np.dtype(np.int8), torch.int8, scaled=True),
        XDType("f8_e4m3", np.dtype(np.uint8), torch.float8_e4m3fn),
        XDType("f8_e5m2", np.dtype(np.uint8), torch.float8_e5m2),
    )
}


def parse(name: str) -> XDType:
    """Look up a container type string."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown xalm dtype {name!r}; supported: {sorted(REGISTRY)}"
        ) from None


def scale_name(tensor_name: str) -> str:
    """Name of the per-row scale tensor accompanying an `i8` tensor."""
    return tensor_name + SCALE_SUFFIX


def is_scale_name(tensor_name: str) -> bool:
    return tensor_name.endswith(SCALE_SUFFIX)
