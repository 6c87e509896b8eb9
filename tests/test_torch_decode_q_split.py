"""Kernel 7 with kernels 5-6 (``csrc/attention.cu``
``flash_decode_q_cluster_kernel``: one launch inserts the quantised K and V
rows, re-rotates the sinks and attends over the int8 cache, the live
128-row chunks of each (batch, kv head) split over a cluster of P blocks
and combined in distributed shared memory). The kernel runs only on the
card (the wrapper takes the plain version on CPU tensors), so this file
emulates it in plain torch and holds it to the JAX package's
``fused_decode_attention_q`` in interpret mode, as
``tests/test_torch_kvq.py`` runs it:

- the plan's mirror: ``decode_q_chunks`` gives each block whole chunks
  [floor(p C / P), floor((p + 1) C / P)), C = ceil(n / 128), each live
  chunk to exactly one block; for every row in [0, S) and every kv_len in
  [0, S] exactly one block's own test (as the kernel's producer warp makes
  it) claims the row as its writer, and that block is the only one that
  reads it; the sentinel row S has no writer;
- the arithmetic: the update is ``kv_update_q_plain`` (the kernel's insert
  and rotation are bit-equal to it, which the card's tests hold); then
  each block's chunks in order, each chunk scored with bf16 q against the
  codes times k_scale / sqrt(hd), its own max, p = exp(s - chunk max),
  bf16(p * v_scale) times beta = exp(chunk max - running max), the old
  terms times alpha = exp(old max - running max); then the P partials
  combined at their common max, rank by rank; kv_len 0 gives 0.

Cases: windows of 256 and 512 rows; B = 3 per kv_len case, a row at the
case's kv_len inserting at kv_len - 1, a wrapped row (kv_len = S) whose
sinks rotate, and a row at the kv_pos == S sentinel; kv_len 1, 127, 128,
129 and 511 (clamped to the window); G in {1, 4, 7} at head_dim 96 and
128 (both windows), and G = 2 at 256 (the 512-row window); 1, 3 and 4 blocks a (batch, kv head).

Tolerances, and why:

- cache planes: codes at most one count apart on under 2 % of the values,
  scales within rtol 2e-3: the bars of ``tests/test_torch_kvq.py``;
- attention: JAX rounds p * v_scale to bf16 at the running max of a block
  of up to 512 rows (``pallas_attention.py:252-263``), here the whole
  window; the kernel rounds it at each 128-row chunk's max and scales it
  by beta after. Each rounding is within bf16's unit roundoff 2^-8 of the
  exact term t_r = exp(s_r - max) v_scale_r, so the two terms differ by at
  most 2^-7 t_r, and an output differs by at most 2^-7 sum_r t_r |v_rd| /
  sum_r exp(s_r - max) (computed here in f64 from the planes), plus 1e-5
  of that sum and of the row's max for f32 sums taken in other orders
  (``OUT_TOL`` of ``tests/test_torch_kvq.py``).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xalm_tpu.ops.pallas_attention import fused_decode_attention_q as jax_attention_q
from xalm_tpu_torch.models.config import KV_SINKS
from xalm_tpu_torch.ops import attention as A

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

CHUNK = 128
KH = 2
WINDOWS = (256, 512)
KV_CASES = (1, 127, 128, 129, 511)
# (window, G, head_dim)
SHAPES = [(s, g, hd) for s in WINDOWS for hd in (96, 128) for g in (1, 4, 7)] + [(512, 2, 256)]
SPLITS = (1, 3, 4)
ROUND = 2.0 ** -7  # two bf16 roundings of the same term
F32_TOL = 1e-5
CODE_SHARE = 0.02
SCALE_RTOL = 2e-3


def _rows(s: int):
    """(kv_pos, kv_len, rotate) of the batch: three rows per kv_len case."""
    kv_pos, kv_len, rot = [], [], []
    for kvl in KV_CASES:
        n = min(kvl, s)
        kv_pos += [n - 1, s // 2 + 3, s]
        kv_len += [n, s, n]
        rot += [0, 1, 0]
    return (np.array(kv_pos, np.int32), np.array(kv_len, np.int32), np.array(rot, np.int32))


@functools.cache
def _case(s: int, g: int, hd: int):
    """Random int8 planes and rows for one shape, the port's planes after
    ``kv_update_q_plain`` and JAX's ``fused_decode_attention_q`` (its
    planes and output): -> (q, port planes, JAX planes, JAX out (B, H, hd))."""
    kv_pos, kv_len, rot = _rows(s)
    b, h = len(kv_pos), KH * g
    rng = np.random.default_rng(1000 * g + hd + s)
    shape = (1, b, KH, s, hd)
    ck, cv = (rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2))
    ks, vs = ((rng.random(shape[:-1]) * 0.02).astype(np.float32) for _ in range(2))
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kn, vn = (rng.normal(size=(b, KH, hd)).astype(np.float32) for _ in range(2))
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c1, s1 = A.rope_cos_sin_plus1(freqs)
    out, *jp = jax.jit(jax_attention_q)(
        *map(jnp.asarray, (q, kn, vn, ck, cv, ks, vs)), 0,
        *map(jnp.asarray, (kv_pos, kv_len, rot, c1[None], s1[None])))
    tp = [torch.from_numpy(a.copy()) for a in (ck, cv, ks, vs)]
    t = torch.from_numpy
    A.kv_update_q_plain(*tp, 0, t(kn), t(vn), t(kv_pos), t(rot), t(c1), t(s1))
    jp = [np.asarray(a) for a in jp]
    return q, tp, jp, np.asarray(out).reshape(b, h, hd)


def _merge(parts):
    """(max, sum, acc) partials combined at their common max, rank by rank."""
    mx = functools.reduce(torch.maximum, [m for m, _, _ in parts])
    l, acc = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for m, pl, pa in parts:
        f = torch.where(m == -math.inf, 0.0, torch.exp(m - mx))
        l = l + f * pl
        acc = acc + f[:, None] * pa
    return mx, l, acc


def kernel7(q, kc, vc, ks, vs, n: int, splits: int) -> torch.Tensor:
    """Kernel 7's attention on one (batch, kv head): q (G, hd) f32, codes
    kc, vc (S, hd) int8, scales ks, vs (S,) f32 -> (G, hd)."""
    f32, bf16 = torch.float32, torch.bfloat16
    g, hd = q.shape
    qb = q.to(bf16).to(f32)
    sm = torch.tensor(1.0 / math.sqrt(hd), dtype=f32)
    parts = []
    for c0, c1 in A.decode_q_chunks(n, kc.shape[0], splits):
        m, l, acc = torch.full((g,), -math.inf), torch.zeros(g), torch.zeros(g, hd)
        for c in range(c0, c1):
            r0, r1 = c * CHUNK, min((c + 1) * CHUNK, n)
            s = (qb @ kc[r0:r1].to(f32).T) * (ks[r0:r1] * sm)  # (G, rows)
            mc = s.amax(dim=1)
            mn = torch.maximum(m, mc)
            alpha, beta = torch.exp(m - mn), torch.exp(mc - mn)
            p = torch.exp(s - mc[:, None])
            pv = beta[:, None] * (p * vs[r0:r1]).to(bf16).to(f32)
            l = l * alpha + beta * p.sum(dim=1)
            acc = acc * alpha[:, None] + pv @ vc[r0:r1].to(f32)
            m = mn
        parts.append((m, l, acc))
    _, l, acc = _merge(parts)
    return torch.where(l[:, None] > 0, acc / torch.where(l > 0, l, 1.0)[:, None], 0.0)


def _term_bound(q, kc, vc, ks, vs, n: int) -> np.ndarray:
    """sum_r t_r |v_rd| / sum_r exp(s_r - max), t_r = exp(s_r - max)
    v_scale_r, over the live rows, in f64 -> (G, hd)."""
    g, hd = q.shape
    if n == 0:
        return np.zeros((g, hd))
    qb = q.to(torch.bfloat16).double()
    s = (qb @ kc[:n].double().T) * (ks[:n].double() / math.sqrt(hd))
    e = torch.exp(s - s.amax(dim=1, keepdim=True))
    return ((e * vs[:n].double()) @ vc[:n].double().abs() / e.sum(dim=1, keepdim=True)).numpy()


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("kvl", KV_CASES)
@pytest.mark.parametrize("s,g,hd", SHAPES)
def test_fused_decode_q_matches_jax(s, g, hd, kvl, splits):
    q, tp, jp, want = _case(s, g, hd)
    kv_pos, kv_len, _ = _rows(s)
    first = 3 * KV_CASES.index(kvl)
    for row in range(first, first + 3):
        n = int(kv_len[row])
        for j in range(KH):
            planes = [t[0, row, j] for t in tp]
            qj = torch.from_numpy(q[row, j * g:(j + 1) * g])
            got = kernel7(qj, *planes, n, splits).numpy()
            ref = want[row, j * g:(j + 1) * g]
            assert np.isfinite(got).all()
            bound = _term_bound(qj, *planes, n)
            allowed = (ROUND + F32_TOL) * bound + F32_TOL * np.abs(ref).max(axis=1, keepdims=True)
            assert (np.abs(got - ref) <= allowed).all(), (row, j, np.abs(got - ref).max())
            if n == 0:
                assert not got.any()


@pytest.mark.parametrize("s,g,hd", SHAPES)
def test_fused_decode_q_planes_match_jax(s, g, hd):
    """The port's planes after the update against JAX's."""
    _, tp, jp, _ = _case(s, g, hd)
    for got, want in zip(tp[:2], jp[:2]):
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < CODE_SHARE, (d.max(), (d > 0).mean())
    for got, want in zip(tp[2:], jp[2:]):
        np.testing.assert_allclose(got.numpy(), want, rtol=SCALE_RTOL, atol=1e-7)
    kv_pos, _, rot = _rows(s)
    assert rot.any() and (kv_pos == s).any() and (kv_pos >= KV_SINKS)[rot == 1].all()


def _claims(p: int, splits: int, row: int, kv_len: int, s: int) -> bool:
    """Block p's own test, as the kernel's producer warp makes it, that it
    writes row ``row`` (kv_pos, or 0 for the sinks)."""
    if not 0 <= row < s:
        return False
    n = min(max(kv_len, 0), s)
    c = -(-n // CHUNK)
    c0, c1 = p * c // splits, (p + 1) * c // splits
    if c == 0:
        return p == 0
    return c0 <= min(row // CHUNK, c - 1) < c1


@pytest.mark.parametrize("splits", (1, 2, 3, 4, 5, 8, 16))
@pytest.mark.parametrize("s", WINDOWS)
def test_decode_q_chunks_and_writer_cover_each_row_once(s, splits):
    """Every live chunk to exactly one block, in rank order; every row of
    the window written by exactly one block for every kv_len, which is the
    only block reading it when it is live; the sentinel row written by
    none."""
    for kv_len in range(0, s + 1):
        n = min(kv_len, s)
        chunks = A.decode_q_chunks(kv_len, s, splits)
        assert len(chunks) == splits and chunks[0][0] == 0
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(chunks, chunks[1:]))
        assert chunks[-1][1] == -(-n // CHUNK)
        for row in range(0, s, 7 if kv_len % 5 else 1):
            owners = [p for p in range(splits) if _claims(p, splits, row, kv_len, s)]
            assert len(owners) == 1, (kv_len, row, owners)
            readers = [p for p, (c0, c1) in enumerate(chunks)
                       if c0 * CHUNK <= row < min(c1 * CHUNK, n)]
            assert row >= n or readers == owners, (kv_len, row, readers, owners)
        assert not any(_claims(p, splits, s, kv_len, s) for p in range(splits))


def test_decode_q_plan_caps_the_split_at_the_windows_chunks():
    """``decode_q_plan``: kernel 3's split count (the SMs over B x KH, 1 to
    16), at most the window's 128-row chunks; 128-row chunks; 4 ring slots,
    3 at head_dim 256."""
    for b, kh, s, want in ((1, 8, 4096, 16), (1, 8, 256, 2), (1, 8, 512, 4), (1, 4, 4096, 16),
                           (1, 16, 4096, 8), (1, 32, 4096, 4), (8, 8, 4096, 2),
                           (64, 8, 4096, 1), (1, 8, 32, 1)):
        assert A.decode_q_plan(b, kh, 4, 128, s, 132)[0] == want, (b, kh, s)
    for hd, slots in ((96, 4), (128, 4), (256, 3)):
        assert A.decode_q_plan(1, 8, 1, hd, 4096, 132)[1:] == (CHUNK, slots)
