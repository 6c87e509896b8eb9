"""The tiling of kernel 1's tiled GEMM of int8, fp8 and bf16 weights and
the megakernel's L2 prefetch, in the Python that mirrors their CUDA
launchers (the kernels run only on the card; there
tests/test_torch_cuda.py holds ``gemm_plan`` to the launcher's own
``xq_gemm_plan``):

- ``ops.qmatmul.gemm_plan`` at every prefill bucket (M 16 to 512) and the
  forward (K, D) of Mistral-7B, Qwen2.5-7B, Gemma-2-9B and Phi-3-mini: the
  tiles cover M and D exactly once, the token tile is a wgmma N (8 to 256
  in steps of 8), the ring fits a block's 227 KB of shared memory, the K
  splits divide the contraction's stages, and the persistent blocks take
  every tile once;
- the permuted x scratch (``gemm_scratch_columns``) feeds the A fragments
  the kernel loads: an emulation of the kernel's arithmetic (each stage's
  16-byte weight loads, the fragments of four k16 steps, the products with
  the x tile as wgmma's B) in float64 equals the JAX package's
  ``pallas_qmatmul_stacked`` (interpret mode) within f32 rounding;
- the megakernel's prefetch mirror (``ops.fused_decode.prefetch_rows``):
  over every GEMV phase of those models at B = 1 and 8, each body, and the
  grids an H100 gives (264 blocks, two an SM, and 132), the rows a block
  brings into L2 are a prefix of the rows ``walk_pairs`` deals it, and the
  deal covers every pair exactly once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xalm_tpu.ops.pallas_matmul import pallas_qmatmul_stacked
from xalm_tpu_torch.models import config as C
from xalm_tpu_torch.models.params import ffn_chunk
from xalm_tpu_torch.ops import fused_decode as fd
from xalm_tpu_torch.ops.qmatmul import gemm_plan, gemm_scratch_columns, gemm_smem

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

MODELS = {name: getattr(C, name) for name in ("MISTRAL_7B", "QWEN2_5_7B", "GEMMA2_9B",
                                              "PHI3_MINI_4K")}
BUCKETS = (16, 32, 64, 128, 256, 512)  # the engine's prefill chunks
H100_SMS = 132
WEIGHT_DTYPES = (torch.int8, torch.bfloat16, torch.float8_e4m3fn)


def _forward_shapes(cfg) -> dict[str, tuple[int, int]]:
    """(K, D) of each body matmul the forward sends to kernel 1."""
    return {"wqkv": (cfg.dim, cfg.q_dim + 2 * cfg.kv_dim), "wo": (cfg.q_dim, cfg.dim),
            "w13": (cfg.dim, 2 * cfg.hidden_dim), "w2": (cfg.hidden_dim, cfg.dim)}


@pytest.mark.parametrize("dt", WEIGHT_DTYPES, ids=["i8", "bf16", "e4m3"])
@pytest.mark.parametrize("model", MODELS)
def test_gemm_plan_at_every_bucket(model, dt):
    for name, (k, d) in _forward_shapes(MODELS[model]).items():
        for m in BUCKETS:
            nt, rows, mt, bands, ks, stages, grid = gemm_plan(m, k, d, dt, H100_SMS)
            where = (name, m)
            assert 8 <= nt <= 256 and nt % 8 == 0 and rows == 128, where
            assert mt * nt >= m > (mt - 1) * nt, where  # every token row once
            assert bands * rows >= d > (bands - 1) * rows, where  # every weight row once
            kt = -(-k * dt.itemsize // 128)  # stages of 128 bytes of a weight row
            assert kt % ks == 0 and (ks == 1 or bands * mt * ks <= H100_SMS), where
            assert 2 <= stages <= 8, where
            assert gemm_smem(nt, dt.itemsize, stages) <= 227 * 1024, where
            tiles = bands * mt * ks
            assert grid == min(tiles, H100_SMS), where
            walked = sorted(t for b in range(grid) for t in range(b, tiles, grid))
            assert walked == list(range(tiles)), where  # the persistent blocks: each tile once


@pytest.mark.parametrize("m,k,d,dt,want", [
    (512, 4096, 28672, torch.int8, (128, 128, 4, 224, 1, 4, 132)),   # Mistral w13: 896 tiles
    (512, 4096, 28672, torch.bfloat16, (128, 128, 4, 224, 1, 7, 132)),
    (512, 14336, 4096, torch.int8, (128, 128, 4, 32, 1, 4, 128)),    # w2: 128 tiles
    (256, 4096, 28672, torch.int8, (128, 128, 2, 224, 1, 4, 132)),   # 4 waves of 128, not 7 of 64
    (256, 14336, 4096, torch.int8, (64, 128, 4, 32, 1, 7, 128)),     # w2: one wave of 64 either way
    (16, 4096, 28672, torch.int8, (16, 128, 1, 224, 1, 8, 132)),     # n16: each weight row once
    (16, 14336, 4096, torch.int8, (16, 128, 1, 32, 4, 8, 128)),      # w2: four K splits
    (8, 14336, 4096, torch.bfloat16, (16, 128, 1, 32, 4, 8, 128)),   # x too wide for the GEMV
    (513, 1056, 1000, torch.float8_e5m2, (64, 128, 9, 8, 1, 7, 72)),  # ragged M, D and K
    (512, 3072, 9216, torch.int8, (128, 128, 4, 72, 1, 4, 132)),     # Phi-3's wqkv: a tie, the wider
])
def test_gemm_plan_cases(m, k, d, dt, want):
    assert gemm_plan(m, k, d, dt, H100_SMS) == want


@pytest.mark.parametrize("m,k,d", [(16, 48, 64), (16, 4112, 4096), (0, 4096, 64), (16, 4096, 0)])
def test_gemm_plan_refuses_what_the_kernel_does_not_take(m, k, d):
    with pytest.raises(ValueError, match="tiled GEMM"):
        gemm_plan(m, k, d, torch.int8, H100_SMS)


def _emulated_gemm(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """y = x . w^T as the tiled GEMM computes it, in float64: x (M, K) in
    the scratch's permuted columns (zeros past K), each stage's weight tile
    (128 rows of 64 columns, zeros past K and D), each lane's A fragments
    from its 16 contiguous weights of rows r and r + 8 (columns 16t ..
    16t + 15), k16 step s using weights 4s .. 4s + 3 of them as fragment
    columns (2t, 2t + 1, 2t + 8, 2t + 9), times wgmma's B: row n, column kk
    of the step is x's scratch at column 16s + kk of the stage."""
    m, k = x.shape
    d = w.shape[0]
    cols = np.asarray(gemm_scratch_columns(k))
    xs = np.where(cols >= 0, x[:, np.maximum(cols, 0)], 0.0)  # (M, np)
    kp = xs.shape[1]
    wp = np.zeros((-(-d // 128) * 128, kp))
    wp[:d, :k] = w
    y = np.zeros((m, wp.shape[0]))
    for c0 in range(0, kp, 64):
        for band in range(0, wp.shape[0], 128):
            tile = wp[band:band + 128, c0:c0 + 64]
            for s in range(4):
                a = np.zeros((128, 16))  # the warpgroups' A fragments of step s
                for r in range(128):  # each row's four weights of step s, from lane t's 16
                    for t in range(4):
                        four = tile[r, 16 * t + 4 * s:16 * t + 4 * s + 4]
                        a[r, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = four
                b = xs[:, c0 + 16 * s:c0 + 16 * s + 16]  # (M, 16): B's N rows
                y[:, band:band + 128] += b @ a.T
    return y[:, :d]


@pytest.mark.parametrize("k", [64, 96, 32 * 33])
def test_scratch_columns_feed_the_fragments(k):
    rng = np.random.default_rng(k)
    m, d = 5, 200
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.integers(-127, 128, size=(1, d, k)).astype(np.int8)
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()  # the scratch holds bf16(x)
    got = _emulated_gemm(xb, w[0].astype(np.float64))
    np.testing.assert_allclose(got, xb @ w[0].T.astype(np.float64), rtol=0, atol=1e-9)
    want = np.asarray(pallas_qmatmul_stacked(jnp.asarray(x), jnp.asarray(w), jnp.int32(0),
                                             q8_scale=0.01))
    ref = np.abs(want).max(axis=1, keepdims=True)
    assert float((np.abs(got * 0.01 - want) / ref).max()) < 1e-5


def _phases(cfg) -> dict[str, tuple[int, int, int]]:
    """(D, K, c13) of each GEMV phase of the megakernel, and its head."""
    return {"wqkv": (cfg.q_dim + 2 * cfg.kv_dim, cfg.dim, 0), "wo": (cfg.dim, cfg.q_dim, 0),
            "w13": (2 * cfg.hidden_dim, cfg.dim, ffn_chunk(cfg.hidden_dim)),
            "w2": (cfg.dim, cfg.hidden_dim, 0), "head": (cfg.vocab_size, cfg.dim, 0)}


@pytest.mark.parametrize("grid", [264, 132])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("model", MODELS)
def test_prefetch_rows_are_the_start_of_the_deal(model, b, grid):
    cfg = MODELS[model]
    for name, (d, k, c13) in _phases(cfg).items():
        bodies = ("bf16", "a8") if name == "head" else ("bf16", "a8", "q4")
        for body in bodies:
            group = 128
            chunk, width = fd.phase_chunk(body, k, b, group)
            npairs = d // 2 if c13 else (d + 1) // 2
            dealt = []
            for block in range(grid):
                pairs = fd.walk_pairs(d, width, chunk, c13, block, grid)
                dealt += pairs
                rows = [r for p in pairs for r in fd.pair_rows(p, c13) if r < d]
                pf = fd.prefetch_rows(d, c13, block)
                assert rows[:len(pf)] == pf, (name, body, block)
                assert len(pf) == len(set(pf)) and all(0 <= r < d for r in pf)
            assert sorted(dealt) == list(range(npairs)), (name, body)  # every pair once
