"""Split TF32 (CUTLASS's "3xTF32"), the arithmetic of the port's two f32
tensor-core kernels on the card: kernel 1's tiled GEMM for f32 weights
(``csrc/qmatmul.cu`` ``gemm_tf32x3_kernel``) and kernel 4 over an f32 cache
(``csrc/attention.cu`` ``flash_prefill_tf32x3_kernel``). Neither runs here
(the CPU has no tensor cores, and the wrappers take the plain versions on
CPU tensors), so this file emulates their products in plain torch and holds
them to the JAX package's f32 functions, ``pallas_qmatmul_stacked`` with
f32 weights and ``fused_prefill_attention`` over an f32 cache, each in
interpret mode as the JAX tests run them on the CPU.

A tensor core reads an f32 operand as TF32: sign, exponent and the top 10
mantissa bits. The emulation writes each operand x = big + small, big = x
as read ("trunc": the low 13 bits dropped, which the card does to a raw
operand and the kernels rely on; "rna": rounded to nearest, ties away, as
``cvt.rna.tf32.f32`` would round it) and small = (x - big) as read,
and sums small_a big_b + big_a small_b + big_a big_b in f32, smallest
first. Each product of TF32 parts is exact in f32.

Tolerance: 1e-5 of each output row's max |JAX|, the kernels' own on the
card (``chip_smoke.py``'s ``F32_TOL`` and ``F32_CACHE_TOL``): the dropped
small_a small_b and the reading of small cost at most about 2^-18 of |a b|
a product (less with "rna"), and errors of either sign cancel in the sums.
One TF32 product (up to 2^-9 of |a b|) misses it: the reason for three.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xalm_tpu.ops.pallas_attention import fused_prefill_attention
from xalm_tpu.ops.pallas_matmul import pallas_qmatmul_stacked

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

MODES = ("trunc", "rna")
TOL = 1e-5


def tf32(x: torch.Tensor, mode: str) -> torch.Tensor:
    """f32 values as a tensor core reads them as TF32."""
    bits = x.contiguous().view(torch.int32)
    if mode == "rna":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def mm_split(a: torch.Tensor, b: torch.Tensor, mode: str, passes: int = 3) -> torch.Tensor:
    """a (..., M, K) times b (..., D, K)^T in split TF32 (``passes`` 3), or
    as one TF32 product (``passes`` 1)."""
    ab, bb = tf32(a, mode), tf32(b, mode)
    big = torch.matmul(ab, bb.transpose(-1, -2))
    if passes == 1:
        return big
    sa, sb = tf32(a - ab, mode), tf32(b - bb, mode)
    return (torch.matmul(sa, bb.transpose(-1, -2)) + torch.matmul(ab, sb.transpose(-1, -2))) + big


def _row_rel(got, want, row: int) -> float:
    got = torch.as_tensor(np.array(got)).reshape(-1, row).double()
    want = torch.as_tensor(np.array(want)).reshape(-1, row).double()
    err = (got - want).abs().amax(dim=1)
    return float((err / want.abs().amax(dim=1).clamp_min(1e-30)).max())


def test_tf32_reading_keeps_ten_mantissa_bits():
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -11 + 2 ** -20, -(1 + 2 ** -11)])
    assert tf32(x, "trunc").tolist() == [1 + 2 ** -10, 1.0, 1.0, -1.0]
    assert tf32(x, "rna").tolist() == [1 + 2 ** -10, 1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -10)]
    for mode in MODES:
        big = tf32(x, mode)
        assert torch.equal(tf32(big, mode), big)  # a part is read exactly


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [4096, 14336])
def test_split_gemm_matches_jax_f32_matmul(mode, n):
    """Mistral-7B's contraction widths (wqkv/w13: 4096, w2: 14336), 300
    output rows, 16 rows of x: the three products within 1e-5 of each row's
    max of the JAX f32 matmul; one TF32 product misses it."""
    rng = np.random.default_rng(n + len(mode))
    x = rng.normal(size=(16, n)).astype(np.float32)
    w = (rng.normal(size=(2, 300, n)) * 0.02).astype(np.float32)
    want = np.asarray(pallas_qmatmul_stacked(jnp.asarray(x), jnp.asarray(w), jnp.int32(1)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w[1])
    assert _row_rel(mm_split(xt, wt, mode), want, 300) <= TOL
    assert _row_rel(mm_split(xt, wt, mode, passes=1), want, 300) > TOL


def split_prefill(q, ck, cv, layer: int, pos, kt: int, mode: str, passes: int = 3):
    """The f32-cache flash prefill as the kernel computes it: ``kt``-key
    tiles up to the causal limit, S = Q K^T and P . V each in split TF32,
    the online softmax in f32 between them. q (B, T, H, hd), the cache
    (L, B, KH, S, hd) -> (B, T, H * hd)."""
    kl, vl = ck[layer], cv[layer]
    b, kh, s, hd = kl.shape
    _, t, h, _ = q.shape
    g = h // kh
    qg = q.reshape(b, t, kh, g, hd).permute(0, 2, 1, 3, 4).reshape(b, kh, t * g, hd)
    qpos = pos[:, None].long() + torch.arange(t).repeat_interleave(g)
    m = torch.full((b, kh, t * g, 1), -math.inf)
    l = torch.zeros((b, kh, t * g, 1))
    acc = torch.zeros((b, kh, t * g, hd))
    for k0 in range(0, min(int(pos.max()) + t, s), kt):
        k1 = min(k0 + kt, s)
        sc = mm_split(qg, kl[:, :, k0:k1], mode, passes) * (1.0 / math.sqrt(hd))
        live = (torch.arange(k0, k1)[None, None, :] <= qpos[:, :, None])[:, None]
        sc = torch.where(live, sc, -math.inf)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.where(m_new == -math.inf, 1.0, torch.exp(m - m_new))
        p = torch.where(live, torch.exp(sc - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + mm_split(p, vl[:, :, k0:k1].transpose(-1, -2), mode, passes)
        m = m_new
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(b, kh, t, g, hd).permute(0, 2, 1, 3, 4).reshape(b, t, h * hd)


# (GQA group, head_dim, the kernel's key tile): Mistral-7B's group and head
# dim, Gemma-7B's head dim (32-key tiles), Phi-3's
PREFILL_SHAPES = [(4, 128, 64), (1, 256, 32), (1, 96, 64)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("g,hd,kt", PREFILL_SHAPES, ids=[f"g{g}-hd{hd}" for g, hd, _ in PREFILL_SHAPES])
def test_split_prefill_matches_jax_f32_prefill(mode, g, hd, kt):
    """A 64-row chunk at positions 0 and 150 over a 256-row f32 cache: the
    split products within 1e-5 of each row's max of the JAX f32 prefill;
    one TF32 product per dot misses it."""
    l, b, kh, s, t = 2, 2, 2, 256, 64
    rng = np.random.default_rng(hd + g)
    ck = rng.normal(size=(l, b, kh, s, hd)).astype(np.float32)
    cv = rng.normal(size=(l, b, kh, s, hd)).astype(np.float32)
    q = rng.normal(size=(b, t, kh * g, hd)).astype(np.float32)
    pos = np.array([0, 150], np.int32)
    want = np.asarray(fused_prefill_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                              jnp.int32(1), jnp.asarray(pos)))
    args = (*map(torch.from_numpy, (q, ck, cv)), 1, torch.from_numpy(pos), kt, mode)
    assert _row_rel(split_prefill(*args), want, hd) <= TOL
    assert _row_rel(split_prefill(*args, passes=1), want, hd) > TOL
