"""Kernel 1: the stacked dequant matmul (replaces
``xalm_tpu/ops/pallas_matmul.py::_kernel`` through ``pallas_qmatmul_stacked``
and ``pallas_qmatmul``; CUDA source ``csrc/qmatmul.cu``).

    y[M, D] = epi * cd(rmsnorm?(x)) @ W[layer]^T        (f32 accumulation)

with W int8 (`i8` per-row scale epilogue, or `q8` x 1/100), bf16, f32 or
fp8 (``float8_e4m3fn``/``float8_e5m2``, no scale: the TPU kernel's
``_f8_to_bf16`` branch, each code widened to bf16 exactly); cd, the compute
dtype, is bf16, or f32 for f32 weights (no bf16 rounding, as the TPU
kernel's ``compute_dtype``). On the H100 the decode shapes (M <= 8) are
bound by the weight bytes and run as a GEMV (f32 FMA for f32 weights; for
bf16 and f32 weights one block an SM, each warp streaming its rows by bulk
copies, as ``gemv_plan`` says);
larger M runs a tiled GEMM on the tensor cores: bf16 ``wgmma`` fed by a TMA
ring for int8/fp8/bf16 (the weights the A operand, widened to bf16 in
registers, the token rows its N: tiled as ``gemm_plan`` says; N a multiple
of 32), and for f32 weights split TF32, three TF32 products a step (each within about
2^-18 of the f32 product; against f64 no less accurate than the plain
version, which keeps f32 with TF32 off: ``csrc/hopper.cuh``;
``f32_gemm_check`` gates its shapes). See the source's note. f16 weights
are no kernel dtype, as on the TPU, and fp8 is none of the forward's: the
JAX forward's ``_pallas_ok`` routes neither to the kernel. The loader turns them into bf16 or i8 on the card
(``load_params``' ``f16_mode``/``fp8_mode``), a weight kept f16 or fp8 takes
``ops.linear``'s plain product, and the fp8 branch is reached through
``qmatmul`` itself, as the JAX one is through ``pallas_qmatmul``.

Two more branches of the same TPU kernel quantise x to int8 per row
(absmax/127, round half to even, clip; ``quant_rows``) and multiply the
output by x's row scale last:

- ``a8=True`` (W8A8, the prefill branch under ``a8_prefill``): int8 x times
  int8 W, exact int32 sums, then the weight's row scale or the q8 1/100,
  then x's scale (``xq_qmatmul_a8``: an s8 wgmma GEMM fed by a TMA ring,
  tiled as ``a8_plan`` says; N a multiple of 64);
- ``q4_group=g`` (packed q4, m < 256): per group of g codes an exact int32
  dot, times that (row, group)'s f32 scale, summed in f32 in group order,
  then x's scale (``xq_qmatmul_q4``, a GEMV over the packed rows).

Row 8 of the TPU kernels, the same kernel through
``pallas_qmatmul_stacked_multi``, is ``qmatmul_multi``: the gathered top-k
expert matmul of Mixtral's decode step, over the (L*E, D, N) flattened
expert stack at the k indices ``layer*E + expert`` that lie on the device;
int8, bf16, f32 and fp8 experts (the GEMV core is kernel 1's; the forward
gathers no fp8 expert), and with ``q4_group=g`` packed-q4 experts
((L*E, D, N/2) values, (L*E, D, N/g) group scales; ``xq_qmatmul_multi_q4``):
x quantised per row (the m shared rows once, their scales for every
expert; else each of the k*m rows), then the q4 branch's group sums.

``qmatmul`` and ``qmatmul_multi`` launch their kernels for CUDA tensors and
run ``qmatmul_plain`` / ``qmatmul_multi_plain`` (the same functions in
plain PyTorch) for CPU tensors.
"""

from __future__ import annotations

import torch

from xalm_tpu_torch.models.params import Q8_FIXED_SCALE, unpack_q4
from xalm_tpu_torch.ops import build
from xalm_tpu_torch.ops.attention import quant_rows

__all__ = [
    "qmatmul",
    "qmatmul_multi",
    "qmatmul_multi_plain",
    "qmatmul_plain",
    "supported_weight_dtype",
]


def supported_weight_dtype(dtype: torch.dtype) -> bool:
    """Weight dtypes the forward routes to the kernel (the JAX package's
    ``supported_weight_dtype``: int8, bf16, f32); f16 and fp8 weights use
    ops.linear there, though ``qmatmul`` takes fp8 too."""
    return dtype in _W_KIND


_W_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}  # the CUDA side's w_kind
_FP8_KIND = {torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}  # fp8 weights, no scale


def _kernel_kind(dtype: torch.dtype, what: str) -> int:
    """The CUDA side's w_kind of a weight dtype ``qmatmul``/``qmatmul_multi`` take."""
    kind = _W_KIND.get(dtype, _FP8_KIND.get(dtype))
    _need(kind is not None, f"{what}: weight dtype {dtype} (int8, bf16, f32 or fp8)")
    return kind


def _counter(name: str, dtype: torch.dtype) -> str:
    """The launch counter of a kernel-1 or kernel-8 launch by weight dtype."""
    return name + ("_f32" if dtype == torch.float32 else "_fp8" if dtype in _FP8_KIND else "")


# The W8A8 GEMM's tiling (csrc/qmatmul.cu's a8_plan): x rows a block and the
# contraction granule it takes
A8_TILE_M, A8_K_GRANULE = 128, 64


def a8_check(m: int, k: int, d: int) -> None:
    """Raises ValueError for a shape the W8A8 GEMM does not take (k not a
    positive multiple of 64, m or d below 1), before any launch."""
    _need(m >= 1 and d >= 1, f"W8A8 of {m} rows of x by {d} weight rows")
    _need(k >= A8_K_GRANULE and k % A8_K_GRANULE == 0,
          f"W8A8 takes a contraction width that is a multiple of {A8_K_GRANULE}, not {k}")


def a8_plan(m: int, k: int, d: int, sms: int) -> tuple[int, int, int]:
    """The W8A8 GEMM's blocks for x (m, k) times weights (d, k) on a card of
    ``sms`` SMs: (weight rows a block, blocks along m, blocks along d).
    128 x 256 output tiles where they still give every SM a block (w13's
    28672 rows), else 128 x 128 (w2's and wo's 4096 would give 256 rows of
    x only 32 blocks of 128 x 256). The launcher's own choice, which reads
    the device's SM count, is ``xq_qmatmul_a8_plan``; the card's tests hold
    the two equal. Raises as ``a8_check``."""
    a8_check(m, k, d)
    mt = -(-m // A8_TILE_M)
    bn = 256 if mt * -(-d // 256) >= sms else 128
    return bn, mt, -(-d // bn)


# The tiled GEMM of int8, fp8 and bf16 weights (csrc/qmatmul.cu gw_plan):
# weight rows a tile, bytes of each weight row a stage, the token tiles (the
# wgmma's N), the most stages, a block's shared memory, the K splits' turn
# counters and the contraction granule
GEMM_ROWS, GEMM_BK, GEMM_NTS = 128, 128, (16, 32, 64, 128)
GEMM_MAX_STAGES, GEMM_SMEM, GEMM_COUNTERS, GEMM_K_GRANULE = 8, 227 * 1024, 1024, 32


def gemm_smem(nt: int, wbytes: int, stages: int) -> int:
    """Bytes of the tiled GEMM's dynamic shared memory: the ring (a stage
    holds 128 bytes of each of the tile's 128 weight rows and x's tile over
    the same columns, nt rows of 64 bf16 a chunk), its barriers and release
    counts, and the slack that aligns it to 1024."""
    chunks = GEMM_BK // 64 // wbytes
    return (stages * (chunks * nt * 128 + GEMM_ROWS * GEMM_BK) + GEMM_MAX_STAGES * (8 + 4)
            + 1024)


def gemm_plan(m: int, k: int, d: int, dtype: torch.dtype,
              sms: int) -> tuple[int, int, int, int, int, int, int]:
    """The tiled GEMM's launch for x (m, k) times (d, k) weights of
    ``dtype`` (int8, bf16 or fp8) on a card of ``sms`` SMs: (token rows a
    tile, weight rows a tile, tiles along m, tiles along d, k splits,
    stages, blocks). A stage is 128 bytes of each weight row (128 one-byte
    or 64 bf16 weights). The token tile, the wgmma's N of 16 to 128 and at
    most m rounded up to a power of two past 16, with the fewest waves of
    tiles over the SMs times the bytes a tile streams a column (128
    weights, nt bf16 of x: a stage lands at about 34 GB/s an SM on an H100,
    ``chip_smoke.py --kernel-ms``'s ``stage_gb_s_per_sm``), the wider on a tie (Mistral's w13 at m = 512
    and 256: 128; w2 and wo at 512: 128, their 32 bands giving 128 tiles,
    at 256: 64); k split in two, four ... while the tiles leave SMs
    idle and each split keeps 4 stages (w2 at m = 16: four splits, 128
    tiles; the splits of a tile add into y in their order, so the sums are
    the same from run to run); the stages shared memory holds, at most 8; a
    persistent block an SM, fewer where the tiles are. The launcher's own
    plan, which reads the device's SM count, is ``xq_gemm_plan``; the
    card's tests hold the two equal. Raises ValueError for k off the 32
    granule (``gemm_check``)."""
    gemm_check(m, k, d)
    wbytes = 2 if dtype == torch.bfloat16 else 1
    bands, kt = -(-d // GEMM_ROWS), -(-k * wbytes // GEMM_BK)
    cap = 16
    while cap < m and cap < GEMM_NTS[-1]:
        cap *= 2
    nt, best = GEMM_NTS[0], None
    for cand in GEMM_NTS:
        if cand > cap:
            break
        cost = -(-bands * -(-m // cand) // sms) * (GEMM_ROWS * wbytes + 2 * cand)
        if best is None or cost <= best:
            nt, best = cand, cost
    mtiles = -(-m // nt)
    ks = 1
    while (bands * mtiles * ks * 2 <= sms and kt % (2 * ks) == 0 and kt // (2 * ks) >= 4
           and bands * mtiles <= GEMM_COUNTERS):
        ks *= 2
    stages = (GEMM_SMEM - gemm_smem(nt, wbytes, 0)) // (gemm_smem(nt, wbytes, 1)
                                                         - gemm_smem(nt, wbytes, 0))
    return (nt, GEMM_ROWS, mtiles, bands, ks, min(stages, GEMM_MAX_STAGES),
            min(bands * mtiles * ks, sms))


def gemm_check(m: int, k: int, d: int) -> None:
    """Raises ValueError for a shape the tiled GEMM of int8, fp8 and bf16
    weights does not take (k not a positive multiple of 32, m or d below
    1), before any launch."""
    _need(m >= 1 and d >= 1, f"tiled GEMM of {m} rows of x by {d} weight rows")
    _need(k >= GEMM_K_GRANULE and k % GEMM_K_GRANULE == 0,
          f"the tiled GEMM takes a contraction width that is a multiple of {GEMM_K_GRANULE}, "
          f"not {k}")


def gemm_scratch_columns(k: int) -> list[int]:
    """The column of x that each column of the tiled GEMM's bf16 scratch
    holds (``prep_x_kernel``): k rounded up to 64, each 64-column chunk
    permuted so that the A fragment a quad lane t holds for k16 step s of
    a stage (fragment columns 2t, 2t + 1, 2t + 8, 2t + 9) is the weights
    16t + 4s .. 16t + 4s + 3 of its row, one contiguous load; -1 past k
    (a zero)."""
    cols = []
    for c0 in range(0, -(-k // 64) * 64, 64):
        for u in range(64):
            s, kk = u // 16, u % 16
            n = c0 + 16 * ((kk % 8) // 2) + 4 * s + kk % 2 + 2 * (kk // 8)
            cols.append(n if n < k else -1)
    return cols


# The f32 GEMM's contraction granule: its tensor maps take rows of a
# multiple of 16 bytes
F32_K_GRANULE = 4


def f32_gemm_check(m: int, k: int, d: int) -> None:
    """Raises ValueError for a shape the split-TF32 f32 GEMM (kernel 1's
    tiled route for f32 weights) does not take (k not a positive multiple
    of 4, m or d below 1), before any launch."""
    _need(m >= 1 and d >= 1, f"f32 GEMM of {m} rows of x by {d} weight rows")
    _need(k >= F32_K_GRANULE and k % F32_K_GRANULE == 0,
          f"the f32 GEMM takes a contraction width that is a multiple of {F32_K_GRANULE}, "
          f"not {k}")


# The streamed GEMV (csrc/qmatmul.cu gs_plan, gs_shape): the weight dtypes
# it takes, the rows of x and the bytes of x in shared memory its route
# takes (``use_gemv``), and each warp's ring: GEMV_WARP_SLOTS stages of
# GEMV_SLOT bytes, or of what a block's shared memory holds beside x in
# whole KB
GEMV_DTYPES = (torch.bfloat16, torch.float32)
GEMV_MAX_M, GEMV_MAX_X_BYTES, GEMV_WARPS = 8, 160 * 1024, 8
GEMV_SLOT, GEMV_WARP_SLOTS = 8192, 2
GEMV_SMEM, GEMV_RESERVE = 227 * 1024, 1024


def gemv_plan(m: int, n: int, d: int, dtype: torch.dtype,
              sms: int) -> tuple[int, int, int, int] | None:
    """The streamed GEMV's launch for x (m, n) times (d, n) weights of
    ``dtype`` on a card of ``sms`` SMs: (blocks, bytes a stage, rows a
    stage, segments a row); None where ``qmatmul`` takes another route (m
    above 8, x past 160 KB in shared memory, a dtype the GEMV does not
    stream, n off the 16 granule). One block an SM, the d rows dealt
    evenly (31 or 32 each of Mistral's 4096 on an H100's 132 SMs) and a
    contiguous run of them to each of its eight warps; a stage is one bulk
    copy of whole rows (as many as fit) or of one of a longer row's equal
    segments. The launcher's own plan, which reads the device's SM count,
    is ``xq_gemv_plan``; the card's tests hold the two equal."""
    xbytes = m * n * (4 if dtype == torch.float32 else 2)
    if (dtype not in GEMV_DTYPES or not 1 <= m <= GEMV_MAX_M or d < 1 or n < 16 or n % 16
            or xbytes > GEMV_MAX_X_BYTES):
        return None
    fit = (GEMV_SMEM - GEMV_RESERVE - xbytes) // (GEMV_WARPS * GEMV_WARP_SLOTS) // 1024
    slot = min(fit * 1024, GEMV_SLOT)
    rowb = n * dtype.itemsize
    rps, nseg = slot // rowb, 1
    if rps == 0:
        rps, nseg = 1, -(-rowb // slot)
    return min(d, sms), slot, rps, nseg


def _check_quant_x(values, norm_w, q4_group: int, a8: bool, m: int) -> None:
    """The TPU wrapper's rules for the branches that quantise x (``:216-222``)."""
    _need(values.dtype == torch.int8 and norm_w is None,
          "a8 and q4 need int8 weights and no norm prologue")
    if q4_group:
        _need(not a8, "q4 and a8 are separate branches")
        _need(m < 256, f"q4 takes decode shapes only (m={m} < 256)")


def _a8_plain(x, values, layer, scale, q8_scale) -> torch.Tensor:
    """W8A8: s8 x s8 products summed exactly (in f64, where every partial of
    a row is an integer below 2^31), then as the kernel's int32 sum to f32,
    times the row scale or the q8 scale, times x's row scale."""
    xq, sx = quant_rows(x)
    y = torch.matmul(xq.to(torch.float64), values[layer].to(torch.float64).T).to(torch.float32)
    if scale is not None:
        y = y * scale[layer]
    elif q8_scale is not None:
        y = y * q8_scale
    return y * sx[:, None]


def _q4_rows(xq, sx, packed, scale, group: int) -> torch.Tensor:
    """Packed q4 of one weight matrix: x's codes xq (m, N) with row scales
    sx (m,), packed (D, N/2), scale (D, N/group). One exact integer dot per
    group of ``group`` codes (f64 again), each to f32 times its (row, group)
    scale, summed in f32 in group order (the low nibbles' groups, then the
    high ones'), then times x's row scale."""
    m, n = xq.shape
    codes = unpack_q4(packed)  # (D, N)
    ng = n // group
    dots = torch.einsum("mgk,dgk->gmd", xq.reshape(m, ng, group).to(torch.float64),
                        codes.reshape(-1, ng, group).to(torch.float64)).to(torch.float32)
    acc = dots[0] * scale[:, 0]
    for g in range(1, ng):
        acc = acc + dots[g] * scale[:, g]
    return acc * sx[:, None]


def _q4_plain(x, values, layer, scale, group: int) -> torch.Tensor:
    """Packed q4: x quantised per row, then ``_q4_rows`` on the layer."""
    xq, sx = quant_rows(x)
    return _q4_rows(xq, sx, values[layer], scale[layer], group)


def qmatmul_plain(
    x: torch.Tensor,
    values: torch.Tensor,
    layer: int,
    *,
    norm_w: torch.Tensor | None = None,
    norm_eps: float | None = None,
    scale: torch.Tensor | None = None,
    q8_scale: float | None = None,
    q4_group: int = 0,
    a8: bool = False,
) -> torch.Tensor:
    """Plain version: x (M, N) f32, values (L, D, N) (q4: (L, D, N/2) with
    (L, D, N/g) group scales) -> (M, D) f32. x is cast to bf16 after the
    optional norm, and the products are exact in f32 and summed in f32; f32
    weights keep x in f32 (no bf16 rounding, as on the TPU) and multiply in
    f32. ``a8`` and ``q4_group`` quantise x per row instead (see the module
    docstring). fp8 weights widen to bf16 exactly, as in the kernel."""
    x = x.to(torch.float32)
    if a8 or q4_group:
        _check_quant_x(values, norm_w, q4_group, a8, x.shape[0])
        if q4_group:
            return _q4_plain(x, values, layer, scale, q4_group)
        return _a8_plain(x, values, layer, scale, q8_scale)
    if norm_w is not None:
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        x = x * torch.rsqrt(ms + norm_eps) * norm_w[layer].to(torch.float32)
    w = values[layer]
    if values.dtype != torch.float32:
        x = x.to(torch.bfloat16)
        w = w.to(torch.bfloat16)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32).T)
    if scale is not None:
        y = y * scale[layer]
    elif q8_scale is not None:
        y = y * q8_scale
    return y


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"qmatmul: {msg}")


def qmatmul(
    x: torch.Tensor,
    values: torch.Tensor,
    layer: int,
    *,
    norm_w: torch.Tensor | None = None,
    norm_eps: float | None = None,
    scale: torch.Tensor | None = None,
    q8_scale: float | None = None,
    q4_group: int = 0,
    a8: bool = False,
) -> torch.Tensor:
    """y[M, D] = [scale *] values[layer] @ cd(rmsnorm?(x))^T, fused; with
    ``a8`` or ``q4_group`` the int8-activation branches (module docstring)."""
    if not x.is_cuda:
        return qmatmul_plain(
            x, values, layer, norm_w=norm_w, norm_eps=norm_eps, scale=scale, q8_scale=q8_scale,
            q4_group=q4_group, a8=a8,
        )
    if a8 or q4_group:
        return _qmatmul_quant_x(x, values, layer, scale, q8_scale, q4_group, a8, norm_w)
    m, n = x.shape
    l, d, n2 = values.shape
    kind = _kernel_kind(values.dtype, "qmatmul")
    _need(x.dtype == torch.float32 and x.is_contiguous(), "x must be contiguous f32")
    _need(values.is_cuda and values.is_contiguous(), "weights must be contiguous on the card")
    _need(n == n2, f"x {tuple(x.shape)} vs weights {tuple(values.shape)}")
    _need(0 <= layer < l, f"layer {layer} out of range")
    if scale is not None:
        _need(values.dtype == torch.int8, "a row scale needs int8 weights")
        _need(scale.dtype == torch.float32 and scale.shape == (l, d) and scale.is_contiguous()
              and scale.is_cuda, "scale must be contiguous (L, D) f32")
    if norm_w is not None:
        _need(norm_w.dtype == torch.float32 and norm_w.shape == (l, n) and norm_w.is_contiguous()
              and norm_w.is_cuda, "norm_w must be contiguous (L, N) f32")
    lib = build.load_library("qmatmul")
    y = torch.empty((m, d), dtype=torch.float32, device=x.device)
    w_ptr = values.data_ptr() + layer * d * n * values.element_size()
    s_ptr = None if scale is None else scale.data_ptr() + layer * d * 4
    nw_ptr = None if norm_w is None else norm_w.data_ptr() + layer * n * 4
    eps = float(norm_eps) if norm_w is not None else 0.0
    qs = float(q8_scale) if (scale is None and q8_scale is not None) else 0.0
    scratch = lib.xq_qmatmul_scratch(m, n, kind)  # bytes of the tiled route's cd(rmsnorm?(x))
    if scratch:
        (f32_gemm_check if values.dtype == torch.float32 else gemm_check)(m, n, d)
    xb = torch.empty((scratch,), dtype=torch.uint8, device=x.device) if scratch else None
    err = lib.xq_qmatmul(x.data_ptr(), nw_ptr, eps, w_ptr, kind, s_ptr, qs, y.data_ptr(),
                         None if xb is None else xb.data_ptr(), m, n, d,
                         torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "qmatmul")
    build.LAUNCHES[_counter("qmatmul", values.dtype)] += 1
    return y


def _qmatmul_quant_x(x, values, layer, scale, q8_scale, q4_group, a8, norm_w) -> torch.Tensor:
    """The a8 and q4 launches: the kernel quantises x per row into ``xq``
    and ``sx`` (scratch the wrapper allocates), then runs the GEMM or GEMV."""
    m, n = x.shape
    l, d, nw = values.shape
    _check_quant_x(values, norm_w, q4_group, a8, m)
    _need(x.dtype == torch.float32 and x.is_contiguous(), "x must be contiguous f32")
    _need(values.is_cuda and values.is_contiguous(), "weights must be contiguous on the card")
    _need(0 <= layer < l, f"layer {layer} out of range")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.load_library("qmatmul")
    y = torch.empty((m, d), dtype=torch.float32, device=x.device)
    xq = torch.empty((m, n), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    w_ptr = values.data_ptr() + layer * d * nw
    if q4_group:
        ng = n // q4_group
        _need(n == 2 * nw and ng * q4_group == n,
              f"x {tuple(x.shape)} vs packed weights {tuple(values.shape)}, group {q4_group}")
        _need(scale is not None and scale.dtype == torch.float32 and scale.shape == (l, d, ng)
              and scale.is_contiguous() and scale.is_cuda,
              "q4 needs contiguous (L, D, N/group) f32 group scales")
        err = lib.xq_qmatmul_q4(x.data_ptr(), w_ptr, scale.data_ptr() + layer * d * ng * 4,
                                xq.data_ptr(), sx.data_ptr(), y.data_ptr(), m, n, d, q4_group,
                                stream)
        build.check(err, "qmatmul q4")
        build.LAUNCHES["qmatmul_q4"] += 1
        return y
    _need(n == nw, f"x {tuple(x.shape)} vs weights {tuple(values.shape)}")
    a8_check(m, n, d)
    if scale is not None:
        _need(scale.dtype == torch.float32 and scale.shape == (l, d) and scale.is_contiguous()
              and scale.is_cuda, "scale must be contiguous (L, D) f32")
    qs = float(q8_scale) if (scale is None and q8_scale is not None) else 0.0
    err = lib.xq_qmatmul_a8(x.data_ptr(), w_ptr, None if scale is None else
                            scale.data_ptr() + layer * d * 4, qs, xq.data_ptr(), sx.data_ptr(),
                            y.data_ptr(), m, n, d, stream)
    build.check(err, "qmatmul a8")
    build.LAUNCHES["qmatmul_a8"] += 1
    return y


def _multi_rows(x: torch.Tensor, k: int, shared_x: bool) -> int:
    """m, the activation rows per expert; the TPU wrapper's limits."""
    m = x.shape[0] // (1 if shared_x else k)
    _need(m >= 1 and m * (1 if shared_x else k) == x.shape[0],
          f"x {tuple(x.shape)} is not {'m' if shared_x else 'k*m'} rows for k={k}")
    _need(m < 256 and k * m <= 512, f"m={m}, k={k}: decode shapes only (m < 256, k*m <= 512)")
    return m


def _multi_q4_plain(x, values, scale, idx, m: int, group: int) -> torch.Tensor:
    """The q4 experts: x's rows quantised as given (the m shared rows, or
    the k*m), each expert's rows through ``_q4_rows`` -> (k, m, D)."""
    xq, sx = quant_rows(x.to(torch.float32))
    n = x.shape[1]
    xq, sx = xq.reshape(-1, m, n), sx.reshape(-1, m)  # (1 or k, m, ...)
    w, s = values[idx], scale[idx]  # (k, D, N/2), (k, D, N/g): gathers on the device
    return torch.stack([_q4_rows(xq[e % xq.shape[0]], sx[e % sx.shape[0]], w[e], s[e], group)
                        for e in range(idx.shape[0])])


def qmatmul_multi_plain(
    x: torch.Tensor,
    values: torch.Tensor,
    scale: torch.Tensor | None,
    idxs: torch.Tensor,
    *,
    shared_x: bool = True,
    q4_group: int = 0,
) -> torch.Tensor:
    """Plain version: x (m, N) shared by the k experts, or (k*m, N) with one
    m-row group per expert; values (LE, D, N); idxs (k,) -> (k*m, D) f32.
    x is cast to bf16 for int8/bf16 weights (f32 weights keep f32, as on the
    TPU); the products are exact in f32 and summed in f32; then the row scale
    of each expert, or the q8 1/100 for int8 without one. ``q4_group`` takes
    packed values (LE, D, N/2) and group scales (LE, D, N/g) (module
    docstring)."""
    k = idxs.shape[0]
    m = _multi_rows(x, k, shared_x)
    n = x.shape[1]
    idx = idxs.to(torch.long)
    if q4_group:
        _check_multi_q4(values, scale, n, q4_group)
        return _multi_q4_plain(x, values, scale, idx, m, q4_group).reshape(k * m, -1)
    w = values[idx]  # (k, D, N): a gather on the device, the indices stay there
    xe = x.to(torch.float32).reshape(-1, m, n).expand(k, m, n)
    if values.dtype != torch.float32:
        xe = xe.to(torch.bfloat16)
        w = w.to(torch.bfloat16)
    y = torch.matmul(xe.to(torch.float32), w.to(torch.float32).transpose(1, 2))  # (k, m, D)
    if scale is not None:
        y = y * scale[idx][:, None, :]
    elif values.dtype == torch.int8:
        y = y * Q8_FIXED_SCALE
    return y.reshape(k * m, -1)


def _check_multi_q4(values, scale, n: int, group: int) -> None:
    """The TPU wrapper's rules for q4 experts (``:344-347``) and the group's."""
    le, d, nh = values.shape
    _need(values.dtype == torch.int8 and 2 * nh == n,
          f"q4 experts: int8 values (LE, D, N/2) for x of {n} columns, not {tuple(values.shape)}")
    _need(group % 128 == 0 and n % (2 * group) == 0,
          f"q4 group {group}: a multiple of 128 dividing N/2 = {n // 2}")
    _need(scale is not None and scale.dtype == torch.float32
          and tuple(scale.shape) == (le, d, n // group),
          f"q4 experts need (LE, D, N/{group}) f32 group scales")


def qmatmul_multi(
    x: torch.Tensor,
    values: torch.Tensor,
    scale: torch.Tensor | None,
    idxs: torch.Tensor,
    *,
    shared_x: bool = True,
    q4_group: int = 0,
) -> torch.Tensor:
    """y[e*m + r] = [scale[idx_e] *] values[idx_e] @ cd(x_e[r]) for the k
    experts idx_e = idxs[e], in one launch; with ``q4_group`` the packed-q4
    experts. See ``qmatmul_multi_plain``."""
    if not x.is_cuda:
        return qmatmul_multi_plain(x, values, scale, idxs, shared_x=shared_x, q4_group=q4_group)
    le, d, nw = values.shape
    n = x.shape[1]
    _need(x.dtype == torch.float32 and x.is_contiguous() and x.dim() == 2,
          "x must be contiguous 2-D f32")
    _need(values.is_cuda and values.is_contiguous(), "weights must be contiguous on the card")
    _need(idxs.dtype == torch.int32 and idxs.is_cuda and idxs.dim() == 1 and idxs.is_contiguous(),
          "idxs must be a contiguous (k,) int32 tensor on the card")
    k = idxs.shape[0]
    m = _multi_rows(x, k, shared_x)
    lib = build.load_library("qmatmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    y = torch.empty((k * m, d), dtype=torch.float32, device=x.device)
    if q4_group:
        _check_multi_q4(values, scale, n, q4_group)
        _need(scale.is_cuda and scale.is_contiguous(),
              "group scales must be contiguous on the card")
        rows = m if shared_x else k * m
        xq = torch.empty((rows, n), dtype=torch.int8, device=x.device)
        sx = torch.empty((rows,), dtype=torch.float32, device=x.device)
        err = lib.xq_qmatmul_multi_q4(x.data_ptr(), values.data_ptr(), scale.data_ptr(),
                                      idxs.data_ptr(), xq.data_ptr(), sx.data_ptr(), y.data_ptr(),
                                      k, m, int(shared_x), n, d, le, q4_group, stream)
        build.check(err, "qmatmul_multi q4")
        build.LAUNCHES["qmatmul_multi_q4"] += 1
        return y
    kind = _kernel_kind(values.dtype, "qmatmul_multi")
    _need(n == nw, f"x {tuple(x.shape)} vs weights {tuple(values.shape)}")
    if scale is not None:
        _need(values.dtype == torch.int8, "a row scale needs int8 weights")
        _need(scale.dtype == torch.float32 and scale.shape == (le, d) and scale.is_contiguous()
              and scale.is_cuda, "scale must be contiguous (LE, D) f32")
    qs = Q8_FIXED_SCALE if (scale is None and values.dtype == torch.int8) else 0.0
    err = lib.xq_qmatmul_multi(x.data_ptr(), values.data_ptr(), kind,
                               None if scale is None else scale.data_ptr(), qs, idxs.data_ptr(),
                               y.data_ptr(), k, m, int(shared_x), n, d, le, stream)
    build.check(err, "qmatmul_multi")
    build.LAUNCHES[_counter("qmatmul_multi", values.dtype)] += 1
    return y
