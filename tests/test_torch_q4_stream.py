"""The packed-q4 stream (kernel 1's q4 GEMV and kernel 8's q4 experts,
``csrc/qmatmul.cu`` ``gemv_q4_stream_kernel`` / ``multi_q4_stream_kernel``
on ``csrc/gemv.cuh``'s ``xq_q4_piece``) on the CPU, where the kernels do
not run: the Python twins of their launch (``ops.qmatmul.q4_plan``,
``q4_stages``) and an emulation of their arithmetic.

- The plan: at every q4 shape of the repository's configurations (each
  group with N % 2g == 0, M 1 to 8, the GEMV and k experts up to 512 with
  k * m <= 512), a block's shared memory stays within an H100's 227 KB; the
  stages deal every (expert, row) to exactly one block and warp, and every
  packed byte of a row to exactly one stage; every bulk copy is a multiple
  of 16 bytes between 16-byte aligned addresses, the scale copies (24-byte
  scale rows at N = 3072, g = 512) widened by at most 12 bytes at each end.
- The arithmetic: an emulation of the kernel's lane layout (16-byte words a
  lane, __dp4a of 16x the nibbles, sums over 8-lane segments of 128 bytes,
  the segments' dots in chunk order into groups, each group's low term added
  in group order and the high terms after the last low one, every f32
  operation rounded on its own) is bit-equal to the plain version
  (``_q4_rows``), and within 1e-5 of each output row's max of the JAX q4
  branch of ``pallas_qmatmul_stacked`` and ``pallas_qmatmul_stacked_multi``
  in interpret mode, at small widths: the group dots are exact on both
  sides, but XLA on the CPU fuses a group's scale multiply and the running
  sum into one FMA, which the kernel and the plain version round apart (a
  few rows an ulp or two apart: tests/test_torch_q4.py's Q4_TOL).
- The kernel's x codes without a division an element (``q4_code``) equal
  the IEEE quotients', each FMA emulated in exact rationals.

The card's tests (tests/test_torch_cuda.py) hold ``q4_plan`` to the
launcher's ``xq_qmatmul_q4_plan`` and the kernels to the plain versions.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xalm_tpu.ops.pallas_matmul import pallas_qmatmul_stacked, pallas_qmatmul_stacked_multi
from xalm_tpu_torch.models import config as C
from xalm_tpu_torch.ops.attention import quant_rows
from xalm_tpu_torch.ops.qmatmul import (
    Q4_SMEM,
    _q4_rows,
    q4_plan,
    qmatmul_multi_plain,
    q4_scale_cap,
    q4_stages,
)

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

FAMILIES = {name: getattr(C, name) for name in C.__all__ if name.isupper() and name != "KV_SINKS"}
H100_SMS = 132  # an H100 SXM's SMs
H100_SMEM = 227 * 1024  # shared memory a block may use on it
GROUPS = (128, 256, 384, 512, 1024)
JAX_TOL = 1e-5  # of each output row's max (see the module's note)
EXPERTS = (1, 2, 8, 64, 512)  # the GEMV, and k experts of one row of x each up to k * m = 512


def _q4_shapes(cfg) -> dict[str, tuple[int, int]]:
    """(N, D) of each body matmul the forward sends to the q4 branch."""
    return {"wqkv": (cfg.dim, cfg.q_dim + 2 * cfg.kv_dim), "wo": (cfg.q_dim, cfg.dim),
            "w13": (cfg.dim, 2 * cfg.hidden_dim), "w2": (cfg.hidden_dim, cfg.dim)}


@pytest.mark.parametrize("family", FAMILIES)
def test_q4_plan_fits_shared_memory_at_every_shape(family):
    for name, (n, d) in _q4_shapes(FAMILIES[family]).items():
        for group in GROUPS:
            if n % (2 * group):
                assert q4_plan(1, n, d, group, 1, H100_SMS) is None
                continue
            for k in EXPERTS:
                for m in range(1, 9):
                    if k * m > 512:
                        continue
                    plan = q4_plan(m, n, d, group, k, H100_SMS)
                    assert plan is not None, (name, group, k, m)
                    mb, warps, bpe, slot, rps, nseg, segb, smem = plan
                    assert 1 <= mb <= m and smem <= Q4_SMEM and Q4_SMEM + 1024 <= H100_SMEM
                    assert slot % 16 == 0 and segb % group == 0 and rps >= 1
                    assert warps in (8, 16) and 1 <= bpe <= max(H100_SMS // k, 1), (name, k, m)
                    # a stage holds its packed bytes and its widened scale copy
                    wcap = segb if nseg > 1 else rps * (n // 2)
                    assert wcap + q4_scale_cap(rps, n // group) == slot
                    assert wcap <= 8192 and (nseg - 1) * segb < n // 2 <= nseg * segb
                    # 8 rows of x a launch but where x's codes do not fit (Gemma-7B's
                    # w2 at 24576 columns)
                    assert mb == m or n * m > 150 * 1024, (name, group, k, m)


@pytest.mark.parametrize("n,d,group,k,m", [
    (4096, 28672, 128, 2, 1),     # Mixtral's w13, two experts
    (14336, 4096, 128, 2, 1),     # Mixtral's w2
    (4096, 28672, 512, 1, 1),     # Mistral's w13 at g512
    (3072, 12288, 512, 1, 4),     # Gemma-7B's wqkv: 24-byte scale rows
    (3072, 1000, 512, 3, 1),      # 24-byte scale rows, ragged rows a warp
    (24576, 3072, 128, 1, 8),     # Gemma-7B's w2: segmented rows, 6 rows of x a launch
    (18944, 3584, 128, 1, 8),     # Qwen2.5-7B's w2
    (1536, 1000, 256, 1, 3),
    (2304, 100, 384, 16, 1),      # a group of three chunks; fewer rows than warps a block
])
def test_q4_stages_cover_every_row_once_with_aligned_copies(n, d, group, k, m):
    plan = q4_plan(m, n, d, group, k, H100_SMS)
    mb, warps, bpe, slot, rps, nseg, segb, _ = plan
    kh, ng = n // 2, n // group
    for s_base in (0, 4, 8, 12):  # the scale tensor's address mod 16 (an f32 view)
        for e in range(k):
            w_addr = 256 + e * d * kh  # the packed stack is 16-byte aligned (the wrapper's rule)
            s_addr = 1024 + s_base + e * d * ng * 4
            seen = np.zeros((d, kh), np.int32)
            for block in range(bpe):
                for warp in range(warps):
                    for r0, off, nr, (wsrc, wbytes), (ssrc, sbytes) in q4_stages(
                            plan, n, d, group, block, warp, w_addr=w_addr, s_addr=s_addr):
                        assert wsrc % 16 == 0 and wbytes % 16 == 0 and wbytes > 0
                        assert ssrc % 16 == 0 and sbytes % 16 == 0
                        assert wsrc == w_addr + r0 * kh + off and off % group == 0
                        assert wbytes == (nr * kh if nseg == 1 else min(segb, kh - off))
                        assert wbytes <= (segb if nseg > 1 else rps * kh)
                        # the scale copy holds the stage's scale rows, widened by at
                        # most 12 bytes at each end, within the slot's room for it
                        first, last = s_addr + r0 * ng * 4, s_addr + (r0 + nr) * ng * 4
                        assert first - 12 <= ssrc <= first and last <= ssrc + sbytes <= last + 12
                        assert sbytes <= q4_scale_cap(rps, ng) == slot - (
                            segb if nseg > 1 else rps * kh)
                        for r in range(r0, r0 + nr):
                            seen[r, off:off + (wbytes if nseg > 1 else kh)] += 1
            assert (seen == 1).all(), (e, s_base)


@pytest.mark.parametrize("n,d,group,k", [(4096, 4096, 192, 1), (4096, 4096, 64, 1),
                                         (4000, 64, 128, 1), (4096, 0, 128, 1),
                                         (4096, 64, 128, 0)])
def test_q4_plan_refuses_what_the_kernel_does_not_take(n, d, group, k):
    assert q4_plan(1, n, d, group, k, H100_SMS) is None


def _lane_dots(w16: np.ndarray, xc: np.ndarray) -> np.ndarray:
    """One piece of packed bytes as the warp reads it: (d, rb) int64 16x
    codes against (m, rb) x codes -> (m, d, rb / 128) chunk dots. Lane l of
    step s takes bytes 512 s + 16 l .. + 15 (zeros past the piece: the
    lanes past the row's end), four __dp4a of four bytes; each 8-lane
    segment (a 128-byte chunk) is summed."""
    d, rb = w16.shape
    m = xc.shape[0]
    steps = -(-rb // 512)
    pad = steps * 512 - rb
    wl = np.pad(w16, ((0, 0), (0, pad))).reshape(d, steps, 32, 4, 4)
    xl = np.pad(xc, ((0, 0), (0, pad))).reshape(m, steps, 32, 4, 4)
    dp4a = np.einsum("dslcb,mslcb->mdslc", wl, xl)  # each __dp4a's four products
    lanes = dp4a.sum(-1)  # a lane's four __dp4a, in turn
    segs = lanes.reshape(m, d, steps, 4, 8).sum(-1)  # __reduce_add_sync over 8 lanes
    return segs.reshape(m, d, steps * 4)[:, :, :rb // 128]


def _stream_emulation(xq: torch.Tensor, sx: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor, group: int, segb: int) -> np.ndarray:
    """The kernel's arithmetic for x's codes xq (m, N) with row scales sx,
    packed (D, N/2), scale (D, N/group), a row's pieces of ``segb`` packed
    bytes (its stages): the chunk dots of each piece in order, cpg = g/128
    of them a group (16x the dot: >> 4, exact), each group's terms
    f32(dot) * scale, the low ones added from -0 in group order, then the
    high ones, then times x's row scale. Every f32 operation rounds on its
    own (numpy float32)."""
    m, n = xq.shape
    d, kh = packed.shape
    wb = packed.numpy().view(np.uint8).astype(np.int64)
    lo16 = ((wb << 4) & 0xF0).astype(np.uint8).view(np.int8).astype(np.int64)
    hi16 = (wb & 0xF0).astype(np.uint8).view(np.int8).astype(np.int64)
    x = xq.numpy().astype(np.int64)
    lo_chunks, hi_chunks = [], []
    for off in range(0, kh, segb):
        rb = min(segb, kh - off)
        lo_chunks.append(_lane_dots(lo16[:, off:off + rb], x[:, off:off + rb]))
        hi_chunks.append(_lane_dots(hi16[:, off:off + rb], x[:, kh + off:kh + off + rb]))
    npg, cpg = kh // group, group // 128
    gl = np.concatenate(lo_chunks, -1).reshape(m, d, npg, cpg).sum(-1) >> 4
    gh = np.concatenate(hi_chunks, -1).reshape(m, d, npg, cpg).sum(-1) >> 4
    s = scale.numpy()
    acc = np.full((m, d), -0.0, np.float32)
    for q in range(npg):
        acc = acc + gl[:, :, q].astype(np.float32) * s[:, q]
    for q in range(npg):
        acc = acc + gh[:, :, q].astype(np.float32) * s[:, npg + q]
    return acc * sx.numpy()[:, None]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _row_rel(got, want) -> float:
    """max over rows of max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max(axis=-1)
    return float((err / np.maximum(np.abs(want).max(axis=-1), 1e-30)).max())


def _q4_stack(rng, le: int, d: int, n: int, group: int):
    packed = rng.integers(-128, 128, size=(le, d, n // 2)).astype(np.int8)
    scale = (rng.random((le, d, n // group)) * 0.01 + 0.001).astype(np.float32)
    return packed, scale


@pytest.mark.parametrize("group,n,segb", [(128, 1024, 512), (128, 1792, 1792), (256, 1536, 768),
                                          (384, 2304, 768), (512, 3072, 1536)])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_stream_emulation_matches_plain_and_jax(group, n, segb, m):
    rng = np.random.default_rng(group + n + m)
    packed, scale = _q4_stack(rng, 2, 40, n, group)
    x = (rng.standard_normal((m, n)) * 3).astype(np.float32)
    x[0, :3] = [127.0, 63.5, -0.5]  # a row whose scale is exactly 1: ties at .5
    xq, sx = quant_rows(torch.from_numpy(x))
    got = _stream_emulation(xq, sx, torch.from_numpy(packed[1]), torch.from_numpy(scale[1]),
                            group, segb)
    plain = _q4_rows(xq, sx, torch.from_numpy(packed[1]), torch.from_numpy(scale[1]), group)
    np.testing.assert_array_equal(_bits(got), _bits(plain.numpy()))
    want = pallas_qmatmul_stacked(jnp.asarray(x), jnp.asarray(packed), jnp.int32(1),
                                  scale=jnp.asarray(scale), q4_group=group)
    assert _row_rel(got, want) <= JAX_TOL


@pytest.mark.parametrize("shared_x", [True, False])
@pytest.mark.parametrize("group,n", [(128, 2048), (512, 3072)])
def test_stream_emulation_of_gathered_experts_matches_plain_and_jax(shared_x, group, n):
    rng = np.random.default_rng(group + shared_x)
    le, d, m = 6, 24, 2
    packed, scale = _q4_stack(rng, le, d, n, group)
    idxs = np.array([5, 0, 3], np.int32)
    k = len(idxs)
    x = (rng.standard_normal((m if shared_x else k * m, n)) * 2).astype(np.float32)
    xq, sx = quant_rows(torch.from_numpy(x))
    rows = []
    for e, i in enumerate(idxs):
        r = slice(0, m) if shared_x else slice(e * m, (e + 1) * m)
        rows.append(_stream_emulation(xq[r], sx[r], torch.from_numpy(packed[i]),
                                      torch.from_numpy(scale[i]), group, n // 2))
    got = np.concatenate(rows)
    plain = qmatmul_multi_plain(torch.from_numpy(x), torch.from_numpy(packed),
                                torch.from_numpy(scale), torch.from_numpy(idxs),
                                shared_x=shared_x, q4_group=group)
    np.testing.assert_array_equal(_bits(got), _bits(plain.numpy()))
    want = pallas_qmatmul_stacked_multi(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale),
                                        jnp.asarray(idxs), q4_group=group, shared_x=shared_x)
    assert _row_rel(got, want) <= JAX_TOL


def _rn32(q: Fraction) -> np.float32:
    """The f32 nearest to the rational q, ties to the even mantissa."""
    f = np.float32(float(q))
    near = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(near, key=lambda c: (abs(Fraction(float(c)) - q),
                                    int(np.array(c, np.float32).view(np.int32)) & 1))


def _fma(a, b, c) -> np.float32:
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_division_free_codes_equal_the_ieee_quotients():
    """The stream's x codes (``q4_code``: r = 1/s once a row, then v r and
    two FMA corrections, the last Markstein's) equal xq_code's rint of the
    IEEE quotient v / s, clipped to +-127, for rows whose absmax lies in
    [2^-60, 2^100] (the kernel divides the others' elements): random values
    and values within a few ulps of the ties k + 1/2, each FMA rounded once
    (exact rationals)."""
    rng = np.random.default_rng(7)
    one = np.float32(1.0)
    for trial in range(3000):
        amax = np.float32(2.0 ** rng.uniform(-60, 100))
        s = np.float32(amax / np.float32(127.0))
        if trial % 2:
            v = np.float32((int(rng.integers(-127, 127)) + 0.5) * float(s))
            v = np.float32(v + np.float32(int(rng.integers(-3, 4))) * np.spacing(v))
            v = np.float32(np.clip(v, -amax, amax))
        else:
            v = np.float32(rng.uniform(-1.0, 1.0) * float(amax))
        r = np.float32(one / s)
        q0 = np.float32(v * r)
        q1 = _fma(_fma(-q0, s, v), r, q0)
        q = _fma(_fma(-q1, s, v), r, q1)
        want = np.float32(v / s)
        assert q == want, (trial, v, s)
        assert np.clip(np.rint(q), -127, 127) == np.clip(np.rint(want), -127, 127)
