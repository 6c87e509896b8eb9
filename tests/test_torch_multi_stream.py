"""Kernel 8's int8 and q8 experts on the per-expert stream
(``csrc/qmatmul.cu`` ``multi_stream_kernel``) on the CPU, where the kernel
does not run: the Python twin of its launch (``ops.qmatmul.multi_plan``,
``multi_stages``) and its plain version against the JAX package.

- The plan: at every shape the wrapper takes at Mixtral-8x7B's widths (w13:
  N 4096, D 28672; w2: N 14336, D 4096) and at the test widths of the
  port's tests, every m in 1..255 and every k with k * m <= 512 (k in 1, 2,
  3, 8, 64, 512): for int8 experts at m <= 8 whose rows of x fit beside the
  smallest rings, one launch of all m rows within an H100's 227 KB of
  shared memory, the stages dealing every row of D to exactly one (block,
  warp) and every byte of a row to exactly one stage, each a bulk copy of
  a multiple of 16 bytes from a 16-byte aligned offset that fits its slot;
  for the rest (m > 8, x too wide, bf16 experts) no plan, so the wrapper
  launches ``qmatmul_multi_kernel``. At Mixtral's widths and k = 2 the plan
  is the one the kernel's note describes.
- The plain version (``qmatmul_multi_plain``, which the card's tests hold
  the kernel to at 1e-4 of each output row's max) against
  ``pallas_qmatmul_stacked_multi`` in interpret mode at m = 9 and 17, past
  the stream's one launch of at most 8 rows: within 1e-4 of the output's
  max (bf16 x times exact weights summed in f32 on both sides, in another
  order), the tolerance of tests/test_torch_moe.py.

The card's tests (tests/test_torch_cuda.py) hold ``multi_plan`` to the
launcher's ``xq_qmatmul_multi_plan`` and the kernel to the plain version.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xalm_tpu.ops.pallas_matmul import pallas_qmatmul_stacked_multi
from xalm_tpu_torch.models.config import MIXTRAL_8X7B
from xalm_tpu_torch.ops import qmatmul as qmm

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

H100_SMS = 132  # an H100 SXM's SMs
H100_SMEM = 227 * 1024  # shared memory a block may use on it
STATIC_SMEM = 1024  # of it, the kernel's barriers and what the compiler adds
TOL = 1e-4
# (N, D) of the shapes: Mixtral's w13 and w2, and the port's tests' widths
SHAPES = {"mixtral_w13": (MIXTRAL_8X7B.dim, 2 * MIXTRAL_8X7B.hidden_dim),
          "mixtral_w2": (MIXTRAL_8X7B.hidden_dim, MIXTRAL_8X7B.dim),
          "cuda_1040": (1040, 1000), "cuda_14336": (14336, 136), "moe_128": (128, 256),
          "tiny_w13": (512, 2048), "tiny_w2": (1024, 512)}
DTYPES = {"i8": torch.int8, "bf16": torch.bfloat16}
EXPERTS = (1, 2, 3, 8, 64, 512)


@functools.cache
def _covers(plan, n: int, d: int, dtype) -> bool:
    """Every row of D to exactly one (block, warp) and every byte of a row
    to exactly one stage, each copy 16-byte granular and within its slot."""
    _, warps, bpe, slot, _, _, _, _ = plan
    rowb = n * dtype.itemsize
    seen = np.zeros(d, np.int32)
    for block in range(bpe):
        for warp in range(warps):
            pieces = {}
            for r0, off, nr, nbytes in qmm.multi_stages(plan, n, d, dtype, block, warp):
                assert nbytes % 16 == 0 and off % 16 == 0 and 0 < nbytes <= slot, (r0, off, nbytes)
                assert nbytes == nr * rowb or (nr == 1 and off + nbytes <= rowb)
                for r in range(r0, r0 + nr):
                    pieces.setdefault(r, []).append((off, off + (nbytes if nr == 1 else rowb)))
            for r, spans in pieces.items():
                spans.sort()
                assert spans[0][0] == 0 and spans[-1][1] == rowb
                assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), spans
                seen[r] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_multi_plan_fits_and_covers_every_row_once(shape, dt):
    n, d = SHAPES[shape]
    dtype = DTYPES[dt]
    for k in EXPERTS:
        for m in range(1, 256):
            if k * m > 512:
                break
            plan = qmm.multi_plan(m, n, d, dtype, k, H100_SMS)
            if dtype != torch.int8 or m > qmm.MULTI_MAX_M:
                assert plan is None, (m, k)
                continue
            if plan is None:  # not even 8 warps' rings of 2 KB stages fit beside x's m rows
                assert m * n * qmm.MULTI_X_BYTES + 8 * qmm.MULTI_SLOTS * 2048 > qmm.Q4_SMEM
                continue
            mb, warps, bpe, slot, rps, nseg, segb, smem = plan
            assert mb == m and warps in (8, 16)
            assert smem == warps * qmm.MULTI_SLOTS * slot + mb * n * 4
            assert smem + STATIC_SMEM <= H100_SMEM, (m, k, smem)
            assert 1 <= bpe <= max(H100_SMS // k, 1) and bpe <= -(-d // warps)
            assert (nseg == 1 and slot == rps * n * dtype.itemsize) or (
                rps == 1 and slot == segb and segb % 128 == 0)
            assert _covers(plan, n, d, dtype), (m, k)


def test_multi_plan_at_mixtral_widths():
    """The plans the kernel's note gives at k = 2 and one row of x: 16
    warps, 66 blocks an expert; one 4 KB int8 row a stage at w13 (two would
    not fit beside x), w2's 14 KB rows in three segments of 4864 bytes (two
    of 7 KB would not fit beside its 57 KB of x). The stream takes w13 at m
    1..8 and w2 at m 1..3 (x's 57 KB a row fills shared memory at 4)."""
    for (n, d), want in (
            (SHAPES["mixtral_w13"], (1, 16, 66, 4096, 1, 1, 4096, 147456)),
            (SHAPES["mixtral_w2"], (1, 16, 66, 4864, 1, 3, 4864, 212992)),
    ):
        assert qmm.multi_plan(1, n, d, torch.int8, 2, H100_SMS) == want, n
    for (n, d), most in ((SHAPES["mixtral_w13"], 8), (SHAPES["mixtral_w2"], 3)):
        taken = [m for m in range(1, 17) if qmm.multi_plan(m, n, d, torch.int8, 2, H100_SMS)]
        assert taken == list(range(1, most + 1)), (n, taken)


def test_multi_plan_refuses_what_the_stream_does_not_take():
    assert qmm.multi_plan(1, 120, 64, torch.int8, 2, H100_SMS) is None  # N % 16
    assert qmm.multi_plan(1, 4096, 64, torch.float32, 2, H100_SMS) is None  # f32: not streamed
    assert qmm.multi_plan(1, 4096, 64, torch.bfloat16, 2, H100_SMS) is None  # bf16: lost, not streamed
    assert qmm.multi_plan(9, 4096, 64, torch.int8, 2, H100_SMS) is None  # m past one launch
    assert qmm.multi_plan(0, 4096, 64, torch.int8, 2, H100_SMS) is None


def _stack(rng, wdt: str, le: int, d: int, n: int):
    """The (LE, D, N) expert stack as JAX and the port take it, and its row
    scales (i8) or none (q8: the fixed 1/100; bf16)."""
    if wdt == "bf16":
        wt = torch.from_numpy((rng.normal(size=(le, d, n)) * 0.05).astype(np.float32)).to(
            torch.bfloat16)
        return jnp.asarray(wt.view(torch.int16).numpy()).view(jnp.bfloat16), wt, None
    w = rng.integers(-127, 128, size=(le, d, n)).astype(np.int8)
    scale = (rng.random((le, d)) * 0.02 + 0.001).astype(np.float32) if wdt == "i8" else None
    return jnp.asarray(w), torch.from_numpy(w), scale


@pytest.mark.parametrize("wdt", ["i8", "q8", "bf16"])
@pytest.mark.parametrize("m", [9, 17])
@pytest.mark.parametrize("shared_x", [True, False])
def test_multi_plain_matches_pallas_across_launches(wdt, m, shared_x):
    """``qmatmul_multi`` on CPU tensors (its plain version) against the JAX
    gathered matmul at m = 9 and 17, past the stream's one launch of at
    most 8 rows (no ``multi_plan``: on the card ``qmatmul_multi_kernel``
    takes them, 8 rows at a time in one launch): the plain version gives the
    JAX rows within 1e-4 of the output's max."""
    le, d, n, k = 8, 256, 128, 2
    plan = qmm.multi_plan(m, n, d, torch.int8 if wdt != "bf16" else torch.bfloat16, k,
                          H100_SMS)
    assert plan is None
    rng = np.random.default_rng(m + 2 * shared_x + 4 * ["i8", "q8", "bf16"].index(wdt))
    idxs = np.array([7, 2], np.int32)
    x = (rng.normal(size=(m if shared_x else k * m, n)) * 0.7).astype(np.float32)
    wj, wt, scale = _stack(rng, wdt, le, d, n)
    want = np.asarray(pallas_qmatmul_stacked_multi(
        jnp.asarray(x), wj, None if scale is None else jnp.asarray(scale), jnp.asarray(idxs),
        shared_x=shared_x))
    got = qmm.qmatmul_multi(torch.from_numpy(x), wt,
                            None if scale is None else torch.from_numpy(scale),
                            torch.from_numpy(idxs), shared_x=shared_x).numpy()
    assert got.shape == want.shape == (k * m, d)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel < TOL, rel
