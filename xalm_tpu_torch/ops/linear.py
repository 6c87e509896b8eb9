"""Plain quantized matmul, y = dequant(W) @ x (counterpart of the "xla"
path of ``xalm_tpu/ops/linear.py``).

Because `i8`/`q8` scales are per output row, ``(x @ W^T) * scale`` is exact:
the dot runs on the raw storage values cast to ``compute_dtype`` with f32
accumulation, and no scaled weight copy exists. This is the path for
weight dtypes the hand-written kernel does not take (f16, fp8: the
reference sends them to XLA), for ``matmul_impl="xla"``, and for packed q4
outside the kernel's shapes: q4
dequantizes the layer in ``compute_dtype`` (codes times group scales, as
the JAX package's ``astype_dequant``) and runs one product over it.
"""

from __future__ import annotations

import torch

from xalm_tpu_torch.models.params import Q8_FIXED_SCALE, QWeight

__all__ = ["qmatmul"]


def qmatmul(
    x: torch.Tensor, w: QWeight, *, compute_dtype=torch.float32
) -> torch.Tensor:
    """``x`` (..., N) activations; ``w`` logical (D, N). Returns (..., D) f32."""
    v = w.values
    if x.shape[-1] != v.shape[-1] * (2 if w.q4group else 1):
        raise ValueError(f"qmatmul: x {tuple(x.shape)} incompatible with w {tuple(v.shape)}")
    # inputs rounded to compute_dtype, f32 accumulation: products of two
    # bf16/f16 values are exact in f32, so upcasting after the cast is the same
    f32 = torch.float32
    if w.q4group:
        return torch.matmul(x.to(compute_dtype).to(f32), w.dequant(compute_dtype).to(f32).T)
    y = torch.matmul(x.to(compute_dtype).to(f32), v.to(compute_dtype).to(f32).T)
    if v.dtype == torch.int8:
        y = y * (w.scale if w.scale is not None else Q8_FIXED_SCALE)
    return y
