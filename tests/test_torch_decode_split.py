"""Kernel 3's split arithmetic (``csrc/attention.cu``
``flash_decode_cluster_kernel``: one launch, the live rows of each (batch,
kv head) split over a cluster of P blocks and combined in distributed
shared memory). The kernel runs only on the card (the wrapper takes the
plain version on CPU tensors), so this file emulates it in plain torch and
holds it to the JAX package's ``fused_decode_attention`` in interpret mode,
as ``tests/test_torch_cache_dtypes.py`` runs it, over a bf16 and an f32
cache:

- the row ranges: block p of P takes [floor(p n / P), floor((p + 1) n /
  P)), n = kv_len clamped to the window; held to ``ops.attention``'s mirror
  ``decode_rows``, each live row covered once, none past kv_len, every
  block a row once kv_len >= P;
- each block: its rows in stages of ``decode_plan``'s key rows, eight warps
  taking NR rows of each stage, every warp an online softmax of its own
  (max, sum, acc) per head in f32; the warps' partials merged at the
  block's max;
- the combine in the kernel's order: the P partials at their common max,
  rank by rank; kv_len 0 gives 0.

The JAX call gets ``kv_pos = S`` (the dropped write) and ``rotate = 0``, so
it leaves the cache as it is and only attends; one call a shape serves every
split count and kv_len (the rows of its batch). Tolerance: 1e-5 of each
output row's max, the kernel's own on the card (``chip_smoke.py``
``_decode_turns``): f32 dots of f32 q with the cache rows on both sides,
nothing rounded to bf16, only the order of the f32 sums differs.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xalm_tpu.ops.pallas_attention import fused_decode_attention
from xalm_tpu_torch.ops import attention as A

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

TOL = 1e-5
S = 800  # the window: a multiple of 32 that no stage divides
KH = 2
SPLITS = (1, 5, 16)
GROUPS = (1, 4, 7)
HEAD_DIMS = (96, 128, 256)
CACHES = ("bf16", "f32")
WARPS = 8
KV_CASES = ("0", "1", "P-1", "P", "P+1", "777", "S")


def _kv_len(case: str, p: int) -> int:
    return {"0": 0, "1": 1, "P-1": p - 1, "P": p, "P+1": p + 1, "777": 777, "S": S}[case]


# every kv_len of every case: the rows of one JAX batch
KV_ROWS = sorted({_kv_len(c, p) for c in KV_CASES for p in SPLITS})


def split_rows(n: int, splits: int) -> list[tuple[int, int]]:
    """The rows of each block as the kernel computes them from kv_len."""
    n = min(max(n, 0), S)
    bounds = [p * n // splits for p in range(splits + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def kernel3(q, k, v, n: int, splits: int, stage_rows: int) -> torch.Tensor:
    """Kernel 3 on one (batch, kv head): q (G, hd), k and v (S, hd) f32 ->
    (G, hd)."""
    g, hd = q.shape
    nr = stage_rows // WARPS
    qs = q * torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    neg = torch.full((g,), -math.inf)
    parts = []
    for r0, r1 in split_rows(n, splits):
        parts_w = [(neg, torch.zeros(g), torch.zeros(g, hd)) for _ in range(WARPS)]
        for st in range(r0, r1, stage_rows):
            rows = min(stage_rows, r1 - st)
            for w in range(WARPS):
                a, gv = st + w * nr, min(nr, rows - w * nr)
                if gv <= 0:
                    continue
                m, l, acc = parts_w[w]
                s = qs @ k[a:a + gv].T  # (G, gv)
                m_new = torch.maximum(m, s.amax(dim=1))
                alpha = torch.where(m_new == -math.inf, 1.0, torch.exp(m - m_new))
                p = torch.exp(s - m_new[:, None])
                parts_w[w] = (m_new, l * alpha + p.sum(dim=1),
                              acc * alpha[:, None] + p @ v[a:a + gv])
        parts.append(_merge(parts_w))
    m, l, acc = _merge(parts)
    return torch.where(l[:, None] > 0, acc / torch.where(l > 0, l, 1.0)[:, None], 0.0)


def _merge(parts):
    """(max, sum, acc) partials merged at their common max, in order."""
    mx = functools.reduce(torch.maximum, [m for m, _, _ in parts])
    l, acc = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for m, pl, pa in parts:
        f = torch.where(m == -math.inf, 0.0, torch.exp(m - mx))
        l = l + f * pl
        acc = acc + f[:, None] * pa
    return mx, l, acc


@functools.cache
def _case(g: int, hd: int, cache: str):
    """Random q and a one-layer cache for one shape, as numpy f32 (the cache
    rounded to bf16 where it is bf16), and the JAX attention over every
    kv_len of KV_ROWS, one batch row each -> (q, k, v, out (B, H * hd))."""
    b, h = len(KV_ROWS), KH * g
    rng = np.random.default_rng(100 * g + hd + (cache == "f32"))
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    k, v = (rng.normal(size=(1, b, KH, S, hd)).astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if cache == "f32" else jnp.bfloat16
    if cache == "bf16":
        k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (k, v))
    zeros = np.zeros((b, KH, hd), np.float32)
    out, _, _ = jax.jit(fused_decode_attention)(
        jnp.asarray(q), jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(k, jdt),
        jnp.asarray(v, jdt), jnp.int32(0), jnp.full((b,), S, jnp.int32),
        jnp.asarray(KV_ROWS, jnp.int32), jnp.zeros((b,), jnp.int32),
        jnp.ones((1, hd), jnp.float32), jnp.zeros((1, hd), jnp.float32))
    return q, k, v, np.asarray(out)


@pytest.mark.parametrize("kv", KV_CASES)
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("cache", CACHES)
def test_split_decode_matches_jax(cache, g, hd, splits, kv):
    n = _kv_len(kv, splits)
    q, k, v, want = _case(g, hd, cache)
    row = KV_ROWS.index(n)
    stage_rows = A.decode_plan(1, KH, g, hd, cache == "f32", KH * splits)[1]
    for j in range(KH):
        got = kernel3(torch.from_numpy(q[row, j * g:(j + 1) * g]),
                      torch.from_numpy(k[0, row, j]), torch.from_numpy(v[0, row, j]), n,
                      splits, stage_rows)
        ref = want[row, j * g * hd:(j + 1) * g * hd].reshape(g, hd)
        assert np.isfinite(got.numpy()).all()
        err = np.abs(got.numpy() - ref).max(axis=1)
        scale = np.maximum(np.abs(ref).max(axis=1), 1e-30)
        assert (err / scale).max() <= TOL, (j, err / scale)
        if n == 0:
            assert not got.any() and not ref.any()


@pytest.mark.parametrize("splits", SPLITS + (2, 3, 8))
def test_split_rows_cover_the_live_rows_once(splits):
    """The emulation's row ranges equal the mirror's (``decode_rows``),
    cover rows [0, kv_len) once in rank order, put no row past kv_len, and
    give every block a row once kv_len >= P."""
    for n in sorted(set(range(0, 40)) | {splits - 1, splits, splits + 1, 777, S - 1, S, S + 9}):
        rows = split_rows(n, splits)
        assert rows == A.decode_rows(n, S, splits), n
        live = min(max(n, 0), S)
        covered = [r for r0, r1 in rows for r in range(r0, r1)]
        assert covered == list(range(live)), n
        assert all(r1 <= live for _, r1 in rows)
        if live >= splits:
            assert all(r1 > r0 for r0, r1 in rows), n


def test_decode_plan_takes_the_split_of_its_grid():
    """``decode_plan``'s split count is the one the emulation was given: the
    SMs over B x KH, 1 to 16; the stage rows keep a stage's K rows within 16
    KB, a multiple of the eight warps."""
    for b, kh, sms, want in ((1, KH, KH * 5, 5), (1, KH, KH * 16, 16), (1, 8, 132, 16),
                             (1, 16, 132, 8), (1, 32, 132, 4), (2, 8, 132, 8), (8, 8, 132, 2),
                             (64, 8, 132, 1)):
        assert A.decode_plan(b, kh, 4, 128, False, sms)[0] == want, (b, kh, sms)
    for g in range(1, 9):
        for hd in HEAD_DIMS:
            for f32 in (False, True):
                _, rows, stages = A.decode_plan(1, 8, g, hd, f32, 132)
                assert rows % WARPS == 0 and rows * hd * (4 if f32 else 2) <= 16384
                assert stages == 3
