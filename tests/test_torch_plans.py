"""The tiling and the shape gates of the port's two TMA + wgmma kernels, in
the Python that mirrors their launchers (the kernels themselves run only
on the card, and there tests/test_torch_cuda.py holds these plans to the
launchers' own, ``xq_qmatmul_a8_plan`` and ``xq_flash_prefill_plan``):

- the W8A8 GEMM (``ops.qmatmul.a8_plan``): every (M, K, D) the forward
  sends it (M 256 or 512: the prefill chunks of 256 rows and more under
  ``a8_prefill``; wqkv, wo, w13 and w2 of each supported family) is taken,
  the tiles cover the output, the 128 x 256 tile only where it still gives
  every SM a block (here an H100 SXM's 132); K off the 64 granule raises
  ValueError before any launch;
- the flash prefill over a bf16 and an f32 cache
  (``ops.attention.prefill_plan``): at each family's GQA group and
  head_dim and every chunk bucket, the blocks cover the chunk's positions
  once, hold whole positions in at most 128 rows (64 over an f32 cache at
  head_dim 256), and launch the last (longest) query tiles first;
- the split-TF32 f32 GEMM's gate (``ops.qmatmul.f32_gemm_check``): every
  forward (K, D) is taken, K off the 4 granule raises;
- flash-decode's launch (``ops.attention.decode_plan``): at each family's
  kv heads, GQA group and head_dim, B 1 to 8 and both caches, one block an
  SM or fewer (a cluster of 1 to 16 blocks a (batch, kv head)), a stage's
  key rows a multiple of the eight warps within 16 KB;
- the streamed GEMV (``ops.qmatmul.gemv_plan``): every forward (N, D) and
  the head at M = 1 to 8 for bf16 and f32 weights, one block an SM
  (fewer only where D is), each warp's two stages of 4 to 8 KB beside x in
  a block's shared memory, a stage whole rows or a segment of one; M
  above 8, x past 160 KB, int8 and fp8 take other routes.
"""

import pytest

from xalm_tpu_torch.models import config as C
import torch

from xalm_tpu_torch.ops.attention import decode_plan, prefill_plan
from xalm_tpu_torch.ops.qmatmul import a8_plan, f32_gemm_check, gemv_plan

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

FAMILIES = {name: getattr(C, name) for name in C.__all__ if name.isupper() and name != "KV_SINKS"}
CHUNKS = (16, 32, 64, 128, 256, 512)  # the engine's prefill buckets
H100_SMS = 132  # an H100 SXM's SMs


def _forward_shapes(cfg) -> dict[str, tuple[int, int]]:
    """(K, D) of each body matmul the forward sends to kernel 1."""
    return {"wqkv": (cfg.dim, cfg.q_dim + 2 * cfg.kv_dim), "wo": (cfg.q_dim, cfg.dim),
            "w13": (cfg.dim, 2 * cfg.hidden_dim), "w2": (cfg.hidden_dim, cfg.dim)}


@pytest.mark.parametrize("family", FAMILIES)
def test_a8_plan_takes_every_forward_shape(family):
    cfg = FAMILIES[family]
    for name, (k, d) in _forward_shapes(cfg).items():
        for m in (256, 512):
            bn, mt, dt = a8_plan(m, k, d, H100_SMS)
            assert bn in (128, 256) and mt * 128 >= m > (mt - 1) * 128, (name, m)
            assert dt * bn >= d > (dt - 1) * bn, (name, m)
            # the wide tile only where it still fills the card
            assert (bn == 256) == (mt * -(-d // 256) >= H100_SMS), (name, m)


@pytest.mark.parametrize("m,k,d,want", [
    (512, 14336, 4096, (128, 4, 32)),    # Mistral w2: 128 blocks, not 64 of 128 x 256
    (512, 4096, 28672, (256, 4, 112)),   # Mistral w13
    (256, 14336, 4096, (128, 2, 32)),
    (256, 4096, 28672, (256, 2, 112)),
    (1, 4096, 4608, (128, 1, 36)),       # one row of x, Qwen2.5's wqkv rows
    (300, 4160, 1001, (128, 3, 8)),      # ragged M, D and a half last stage of K
])
def test_a8_plan_tiles(m, k, d, want):
    assert a8_plan(m, k, d, H100_SMS) == want


@pytest.mark.parametrize("m,k,d", [(256, 80, 64), (512, 4128, 4096), (256, 32, 64),
                                   (256, 0, 64), (0, 4096, 64), (256, 4096, 0)])
def test_a8_plan_refuses_what_the_kernel_does_not_take(m, k, d):
    with pytest.raises(ValueError, match="W8A8"):
        a8_plan(m, k, d, H100_SMS)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_plan_at_every_family(family, f32):
    cfg = FAMILIES[family]
    g, hd = cfg.group_size, cfg.head_dim
    rows = (64 if hd == 256 else 128) if f32 else 128  # a block's query rows
    for t in CHUNKS + (1, 333):
        tq, order = prefill_plan(t, g, hd, f32=f32)
        assert tq == (rows // g if f32 else 2 * (64 // g)) and tq * g <= rows  # whole positions
        assert order == sorted(order, reverse=True)  # the longest tiles first
        covered = [p for q0 in order for p in range(q0, min(q0 + tq, t))]
        assert sorted(covered) == list(range(t))  # every position once


@pytest.mark.parametrize("family", FAMILIES)
def test_f32_gemm_takes_every_forward_shape(family):
    for name, (k, d) in _forward_shapes(FAMILIES[family]).items():
        for m in (9, 256, 512):
            f32_gemm_check(m, k, d)


@pytest.mark.parametrize("m,k,d", [(100, 1026, 64), (100, 2, 64), (0, 4096, 64), (9, 4096, 0)])
def test_f32_gemm_refuses_what_the_kernel_does_not_take(m, k, d):
    with pytest.raises(ValueError, match="f32 GEMM"):
        f32_gemm_check(m, k, d)


@pytest.mark.parametrize("t,g,hd", [(512, 4, 64), (512, 4, 160), (512, 9, 128), (512, 0, 128),
                                    (0, 4, 128)])
def test_prefill_plan_refuses_what_the_kernel_does_not_take(t, g, hd):
    with pytest.raises(ValueError, match="flash_prefill"):
        prefill_plan(t, g, hd)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_decode_plan_at_every_family(family, f32):
    cfg = FAMILIES[family]
    g, hd, kh = cfg.group_size, cfg.head_dim, cfg.n_kv_heads
    for b in (1, 2, 4, 8):
        splits, rows, stages = decode_plan(b, kh, g, hd, f32, H100_SMS)
        assert 1 <= splits <= 16 and (splits == 1 or splits * b * kh <= H100_SMS), b
        assert splits == 16 or splits == 1 or (splits + 1) * b * kh > H100_SMS, b  # the card full
        assert rows % 8 == 0 and rows * hd * (4 if f32 else 2) <= 16384 and stages == 3
    assert decode_plan(1, 8, 4, 128, False, H100_SMS)[0] == 16  # Mistral: 128 blocks


@pytest.mark.parametrize("family", FAMILIES)
def test_gemv_plan_takes_every_decode_matmul(family):
    cfg = FAMILIES[family]
    shapes = {name: (k, d) for name, (k, d) in _forward_shapes(cfg).items()}
    shapes["head"] = (cfg.dim, cfg.vocab_size)
    for name, (n, d) in shapes.items():
        for dt in (torch.bfloat16, torch.float32):
            xbytes = 4 if dt == torch.float32 else 2
            for m in range(1, 9):
                plan = gemv_plan(m, n, d, dt, H100_SMS)
                if m * n * xbytes > 160 * 1024:
                    assert plan is None, (name, m, dt)
                    continue
                blocks, slot, rps, nseg = plan
                assert blocks == min(d, H100_SMS), (name, m, dt)
                assert 4096 <= slot <= 8192 and slot % 1024 == 0, (name, m, dt)
                assert 16 * slot + m * n * xbytes <= 227 * 1024 - 1024  # 8 warps x 2 stages
                rowb = n * dt.itemsize  # a stage: whole rows, or a segment of one
                assert (1 <= rps * rowb <= slot and nseg == 1) or (
                    rps == 1 and rowb > slot and -(-rowb // nseg) <= slot), (name, m, dt)
            assert gemv_plan(1, n, d, dt, H100_SMS) is not None, (name, dt)  # M = 1 always
        for dt in (torch.int8, torch.float8_e4m3fn):  # the warp-a-row-pair GEMV
            assert gemv_plan(1, n, d, dt, H100_SMS) is None


@pytest.mark.parametrize("m,n,d,dt,want", [
    (1, 14336, 4096, torch.float32, (132, 8192, 1, 7)),  # Mistral w2 f32: a row in 7 segments
    (2, 14336, 4096, torch.float32, (132, 7168, 1, 8)),  # 112 KB of x: 7 KB stages
    (1, 4096, 32000, torch.bfloat16, (132, 8192, 1, 1)),  # the bf16 head: a row a stage
    (1, 2048, 4096, torch.bfloat16, (132, 8192, 2, 1)),   # 4 KB rows: two a stage
    (1, 4096, 6144, torch.int8, None),           # int8: the warp-a-row-pair GEMV
    (1, 81920, 64, torch.bfloat16, (64, 4096, 1, 40)),    # 160 KB of x: 4 KB stages
    (9, 4096, 4096, torch.bfloat16, None),       # M above 8: the tiled GEMM
    (4, 14336, 4096, torch.float32, None),       # x past 160 KB
    (1, 24, 64, torch.bfloat16, None),           # N off the 16 granule
])
def test_gemv_plan_cases(m, n, d, dt, want):
    assert gemv_plan(m, n, d, dt, H100_SMS) == want
