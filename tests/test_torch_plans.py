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
- the flash prefill over a bf16 cache (``ops.attention.prefill_plan``):
  at each family's GQA group and head_dim and every chunk bucket, the
  blocks cover the chunk's positions once, hold whole positions in at most
  128 rows, and launch the last (longest) query tiles first.
"""

import pytest

from xalm_tpu_torch.models import config as C
from xalm_tpu_torch.ops.attention import prefill_plan
from xalm_tpu_torch.ops.qmatmul import a8_plan

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


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_plan_at_every_family(family):
    cfg = FAMILIES[family]
    g, hd = cfg.group_size, cfg.head_dim
    for t in CHUNKS + (1, 333):
        tq, order = prefill_plan(t, g, hd)
        assert tq == 2 * (64 // g) and tq * g <= 128  # whole positions, two warpgroups' rows
        assert order == sorted(order, reverse=True)  # the longest tiles first
        covered = [p for q0 in order for p in range(q0, min(q0 + tq, t))]
        assert sorted(covered) == list(range(t))  # every position once


@pytest.mark.parametrize("t,g,hd", [(512, 4, 64), (512, 4, 160), (512, 9, 128), (512, 0, 128),
                                    (0, 4, 128)])
def test_prefill_plan_refuses_what_the_kernel_does_not_take(t, g, hd):
    with pytest.raises(ValueError, match="flash_prefill"):
        prefill_plan(t, g, hd)
