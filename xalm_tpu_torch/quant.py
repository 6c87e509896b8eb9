"""Weight-only quantization schemes (host-side numpy; the port's own copy of
``xalm_tpu/quant.py``, bit-equal to it).

Converter-side quantize/dequantize for every container dtype, plus the
error-analysis metrics of the converter's ``--analyze`` mode. Dequantizing
at run time is the kernels' work (``csrc/``); nothing here runs on the card.

Schemes:

- ``f32/f16/bf16``: plain casts. bf16 goes through torch's cast (round to
  nearest even, as ``ml_dtypes``) and comes out as a torch bf16 tensor, the
  form the port's ``write_xalm`` takes.
- ``f8_e4m3 / f8_e5m2``: per-tensor saturating cast (clip to the format's
  max, then torch's round-to-nearest-even cast), no scale factor; a torch
  fp8 tensor.
- ``q8``: fixed-scale int8 (value = q/100); read/write compatibility only.
- ``i8``: symmetric int8 with a per-output-row f32 scale (max|row| / 127),
  stored as a sibling ``<name>.scale`` tensor.
- Simulated interchange formats (``qi8/qi4/qi3/f4_e2m1/f6_e3m2`` from
  ``packing``, and the GGUF block formats ``q4_0/q4_1/q5_0/q5_1/q8_0/
  tq1_0/tq2_0`` from ``gguf``): ``quantize`` round-trips the values through
  the packed representation and stores the dequantized result as f16,
  reporting the true packed byte size.

``dequantize`` takes values as ``quantize`` made them (torch tensors for
bf16 and fp8) or as ``XalmFile.load`` gives them (the raw ``uint16`` /
``uint8`` storage of bf16 and fp8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from xalm_tpu_torch import gguf, packing

__all__ = [
    "quantize", "dequantize", "QuantResult", "analyze", "analyze_scales",
    "ANALYZE_COLUMNS", "SIMULATED_TYPES", "quantize_q4_rows", "dequantize_q4_rows", "as_f32",
]

_F8_MAX = {
    "f8_e4m3": 448.0,  # float8_e4m3fn
    "f8_e5m2": 57344.0,
}
_F8 = {"f8_e4m3": torch.float8_e4m3fn, "f8_e5m2": torch.float8_e5m2}
_RAW = {"bf16": torch.bfloat16, **_F8}


def as_f32(x) -> np.ndarray:
    """float32 numpy values of a numpy array or a torch tensor of any float
    dtype (bf16 and fp8 widen exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


@dataclasses.dataclass
class QuantResult:
    values: np.ndarray | torch.Tensor  # storage dtype (torch for bf16 and fp8)
    scale: np.ndarray | None = None  # per-row f32 scales for `i8`, else None
    packed_nbytes: int | None = None  # true wire size for simulated formats

    @property
    def nbytes(self) -> int:
        if self.packed_nbytes is not None:
            return self.packed_nbytes
        n = self.values.nbytes
        if self.scale is not None:
            n += self.scale.nbytes
        return n


def quantize_q4_rows(t: np.ndarray, group: int) -> tuple[np.ndarray, np.ndarray]:
    """Runtime-streamable packed 4-bit: (..., D, K) float -> (packed
    (..., D, K/2) int8, scale (..., D, K/group) f32).

    Symmetric absmax/7 per (row, group); split-half byte layout (low
    nibble = k, high nibble = k + K/2), the layout the q4 kernels read
    (``models/params.py``'s packed q4). Unlike the ``qi4`` bitstream
    (interchange only), this layout runs."""
    f = as_f32(t)
    k = f.shape[-1]
    if group % 128 or k % (2 * group):
        raise ValueError(f"q4 group {group} must be a 128-multiple dividing K/2={k // 2}")
    g = k // group
    fg = f.reshape(*f.shape[:-1], g, group)
    amax = np.abs(fg).max(axis=-1)
    sc = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(fg / sc[..., None]), -8, 7).astype(np.int32)
    q = q.reshape(f.shape)
    lo, hi = q[..., : k // 2], q[..., k // 2 :]
    packed = (((hi & 0xF) << 4) | (lo & 0xF)).astype(np.uint8).view(np.int8)
    return packed, sc


def dequantize_q4_rows(packed: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Inverse of quantize_q4_rows (host-side; the kernels unpack on the card)."""
    w = packed.astype(np.int32)
    hi = w >> 4  # arithmetic: top nibble sign-extends
    lo = (w << 28) >> 28
    codes = np.concatenate([lo, hi], axis=-1).astype(np.float32)
    k = codes.shape[-1]
    g = scale.shape[-1]
    cg = codes.reshape(*codes.shape[:-1], g, k // g)
    return (cg * scale[..., None]).reshape(codes.shape)


# packed bits per element for the simulated sub-byte interchange formats
_PACKED_BITS = {"qi8": 8, "qi4": 4, "qi3": 3, "f4_e2m1": 4, "f6_e3m2": 6}
_GGUF_SIM = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "tq1_0", "tq2_0")
SIMULATED_TYPES = tuple(_PACKED_BITS) + _GGUF_SIM


def _simulate(xf: np.ndarray, type_name: str) -> QuantResult:
    """Round-trip through the packed representation; store f16, true size."""
    flat = xf.reshape(-1)
    if type_name in _GGUF_SIM:
        block = gguf.GGUF_SIZES[type_name][0]
        pad = (-flat.size) % block
        padded = np.pad(flat, (0, pad)) if pad else flat
        raw = gguf.quantize(padded, type_name)
        back = gguf.dequantize(raw, type_name)[: flat.size]
        nbytes = gguf.quant_byte_size(padded.size, type_name)
    elif type_name == "qi8":
        raw = packing.quantize_qi8(flat)
        back, nbytes = packing.dequantize_qi8(raw), raw.nbytes
    elif type_name == "qi4":
        raw = packing.quantize_qi4(flat)
        back, nbytes = packing.dequantize_qi4(raw, flat.size), raw.nbytes
    elif type_name == "qi3":
        raw = packing.quantize_qi3(flat)
        back, nbytes = packing.dequantize_qi3(raw, flat.size), raw.nbytes
    elif type_name == "f4_e2m1":
        raw = packing.quantize_f4_e2m1(flat)
        back, nbytes = packing.dequantize_f4_e2m1(raw, flat.size), raw.nbytes
    elif type_name == "f6_e3m2":
        raw = packing.quantize_f6_e3m2(flat)
        back, nbytes = packing.dequantize_f6_e3m2(raw, flat.size), raw.nbytes
    else:  # pragma: no cover
        raise ValueError(type_name)
    return QuantResult(back.reshape(xf.shape).astype(np.float16), packed_nbytes=nbytes)


def quantize(x: np.ndarray, type_name: str) -> QuantResult:
    """Quantize a float array to the given container dtype."""
    xf = as_f32(x)
    x = xf
    if type_name == "f32":
        return QuantResult(xf)
    if type_name == "f16":
        return QuantResult(xf.astype(np.float16))
    if type_name == "bf16":
        return QuantResult(torch.from_numpy(np.ascontiguousarray(xf)).to(torch.bfloat16))
    if type_name in ("f8_e4m3", "f8_e5m2"):
        clipped = np.clip(xf, -_F8_MAX[type_name], _F8_MAX[type_name])
        return QuantResult(torch.from_numpy(np.ascontiguousarray(clipped)).to(_F8[type_name]))
    if type_name == "q8":
        q = np.clip(np.round(xf * 100.0), -127, 127).astype(np.int8)
        return QuantResult(q)
    if type_name == "i8":
        if x.ndim < 2:
            raise ValueError("i8 requires >=2-D weights (per-output-row scales)")
        row = xf.reshape(x.shape[0], -1)
        amax = np.abs(row).max(axis=1)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(row / scale[:, None]), -127, 127).astype(np.int8)
        return QuantResult(q.reshape(x.shape), scale)
    if type_name in SIMULATED_TYPES:
        return _simulate(xf, type_name)
    raise ValueError(f"unsupported quantization target {type_name!r}")


def dequantize(q: QuantResult | np.ndarray, type_name: str, scale: np.ndarray | None = None) -> np.ndarray:
    """Dequantize back to float32."""
    if isinstance(q, QuantResult):
        values, scale = q.values, q.scale
    else:
        values = q
    if type_name in ("bf16", "f8_e4m3", "f8_e5m2") and isinstance(values, np.ndarray) \
            and values.dtype.kind == "u":
        # a container's raw storage: reinterpret the bits as the type
        return as_f32(torch.from_numpy(np.array(values)).view(_RAW[type_name]))
    if type_name in ("f32", "f16", "bf16", "f8_e4m3", "f8_e5m2", "u8") or type_name in SIMULATED_TYPES:
        # simulated formats store the round-tripped values as f16
        return as_f32(values)
    values = np.asarray(values)
    if type_name == "q8":
        return values.astype(np.float32) / 100.0
    if type_name == "i8":
        if scale is None:
            raise ValueError("i8 dequantize needs per-row scales")
        flat = values.reshape(values.shape[0], -1).astype(np.float32)
        return (flat * scale[:, None].astype(np.float32)).reshape(values.shape)
    raise ValueError(f"unsupported dequantization source {type_name!r}")


ANALYZE_COLUMNS = ["type", "scale", "mse", "norm_err", "cosine", "snr_db", "exact_%", "bytes"]

_FLOAT_TYPES = ("f32", "f16", "bf16")


def analyze_scales(x: np.ndarray, type_name: str) -> list:
    """Scale operating points to sweep for a tensor x dtype, mirroring the
    reference's analyze mode (reference convert.py:776-798): float formats
    have no scale degree of freedom; quantized formats sweep the
    range-derived per-column scale, 1, 8, 16, and 4/value-range."""
    if type_name in _FLOAT_TYPES:
        return [1.0]
    xf = np.asarray(x, dtype=np.float32)
    v_range = float(xf.max() - xf.min())
    scales: list = ["range", 1.0, 8.0, 16.0]
    if v_range > 0:
        scales.append(4.0 / v_range)
    return scales


def analyze(x: np.ndarray, type_name: str, scale=1.0) -> dict:
    """Round-trip quantization error metrics (reference convert.py:776-811).

    ``scale`` pre-multiplies the tensor before quantization (and divides the
    result back out): a cheap probe of where the format's representable range
    sits relative to the data. ``"range"`` uses the reference's per-column
    16/(max-min) mapping."""
    xf = np.asarray(x, dtype=np.float32)
    if isinstance(scale, str):  # "range"
        span = xf.max(axis=0) - xf.min(axis=0)
        s = np.where(span > 0, 16.0 / np.where(span > 0, span, 1.0), 1.0)
        label = "range"
    else:
        s = float(scale)
        label = f"{scale:g}"
    q = quantize(xf * s, type_name)
    back = dequantize(q, type_name) / s
    err = xf - back
    mse = float(np.mean(err**2))
    denom = float(np.mean(xf**2))
    norm_err = float(np.sqrt(mse / denom)) if denom > 0 else 0.0
    dot = float(np.sum(xf * back))
    nx = float(np.linalg.norm(xf))
    nb = float(np.linalg.norm(back))
    cosine = dot / (nx * nb) if nx > 0 and nb > 0 else 1.0
    snr_db = 10.0 * np.log10(denom / mse) if mse > 0 else float("inf")
    exact = float(np.mean(err == 0.0)) * 100.0
    return {
        "type": type_name,
        "scale": label,
        "mse": mse,
        "norm_err": norm_err,
        "cosine": cosine,
        "snr_db": snr_db,
        "exact_%": exact,
        "bytes": q.nbytes,
    }
