"""Kernel 2 in kernel 3's launch (``csrc/attention.cu``
``flash_decode_cluster_kernel`` with the new rows: the port's
``fused_decode_attention`` over a bf16 or an f32 cache) on the CPU, where
the kernel does not run:

- the owner rule: of kernel 3's P blocks of one (batch, kv head), block p
  reads rows [floor(p n / P), floor((p + 1) n / P)) (``decode_rows``), and
  each row the update writes (the new K and V rows at kv_pos, the sink keys
  where rotate is set) is written by the block whose range holds it, the
  last block for a row at or past n, which no block reads. Emulating each
  block's own test as its producer warp makes it, every row in [0, S) of
  every kv_len in [0, S] has exactly one writer, ``decode_row_owner``
  names it, and that block is the only one that reads the row; the writes
  go before the copy of the first stage of ``decode_plan``'s rows that
  holds one, and that stage holds the row. Cases: P 1, 3, 5 and 16
  (kv_len 0, 1, below 2P, where the two sinks lie in two blocks, and up to
  the window), the kv_pos == S sentinel (no writer), and B = 2 with one
  row's write dropped.
- the arithmetic: ``fused_decode_attention`` on CPU tensors (its plain
  version, ``kv_update_plain`` then ``flash_decode_plain``, which the
  card's tests hold the kernel to: planes bit-equal, output within 1e-5 of
  each row's max) against the JAX ``fused_decode_attention`` in interpret
  mode, bf16 and f32 caches, G 1, 2, 4 and 7 at head_dim 96, 128 and 256,
  a 256-row window, B = 3: a wrapped row inserting mid-ring with its sinks
  rotating, a row inserting at kv_len - 1, and a row at the sentinel. The
  planes: a bf16 cache bit-equal; an f32 cache bit-equal but for the
  rotated sink keys, within 2 ulps of |v cexp| + |swap(v) sexp| (XLA on
  the CPU fuses the rotation's multiply and add into one FMA, which the
  kernel and the plain version round apart, and the sum may cancel:
  tests/test_torch_q4_stream.py met the same fusion). The
  output within 1e-5 of each row's max: f32 dots and softmax on both sides
  in another order (tests/test_torch_decode_split.py's tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xalm_tpu.ops.pallas_attention import fused_decode_attention as jax_fused
from xalm_tpu_torch.models.config import KV_SINKS
from xalm_tpu_torch.ops import attention as A

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

H100_SMS = 132
SPLITS = (1, 3, 5, 16)
S = 800  # the owner rule's window (a multiple of 32 that no stage divides)
TOL = 1e-5
F32_ULPS = 2
KH = 2
WINDOW = 256  # the JAX comparison's window
SHAPES = [(g, hd) for hd in (96, 128, 256) for g in (1, 2, 4, 7)]
CACHES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _writers(row: int, kv_len: int, splits: int) -> list[int]:
    """The blocks whose own test (the producer warp's, on the card) claims
    row ``row`` at kv_len: r < n ? r0 <= r < r1 : p == P - 1."""
    n = min(max(kv_len, 0), S)
    out = []
    for p, (r0, r1) in enumerate(A.decode_rows(kv_len, S, splits)):
        if (r0 <= row < r1) if row < n else p == splits - 1:
            out.append(p)
    return out


def _kv_lens(splits: int) -> list[int]:
    return sorted({0, 1, 2, splits - 1, splits, splits + 1, 2 * splits - 1, 2 * splits, 777, S}
                  - {-1})


@pytest.mark.parametrize("splits", SPLITS)
def test_each_written_row_has_one_owner_that_reads_it(splits):
    for kv_len in _kv_lens(splits):
        rows = A.decode_rows(kv_len, S, splits)
        readers = np.zeros(S, np.int32)
        for r0, r1 in rows:
            readers[r0:r1] += 1
        n = min(kv_len, S)
        assert (readers[:n] == 1).all() and (readers[n:] == 0).all()
        for row in range(S):
            who = _writers(row, kv_len, splits)
            assert who == [A.decode_row_owner(row, kv_len, S, splits)], (kv_len, row, who)
            r0, r1 = rows[who[0]]
            if row < n:  # the writer is the one block that reads the row
                assert r0 <= row < r1
            else:  # nobody reads it; the last block writes it after its copies
                assert who[0] == splits - 1


@pytest.mark.parametrize("splits", SPLITS)
def test_sinks_below_two_blocks_rotate_in_their_owners(splits):
    """At n < 2P the sinks may lie in two blocks' ranges: each sink row is
    rotated by its own owner (the rotation of a row reads that row alone),
    and each is written before the copy of the stage of its owner that holds
    it (``decode_plan``'s key rows a stage)."""
    _, stage_rows, _ = A.decode_plan(1, 8, 4, 128, False, H100_SMS)
    for kv_len in range(0, 2 * splits + 1):
        rows = A.decode_rows(kv_len, S, splits)
        for r in range(KV_SINKS):
            p = A.decode_row_owner(r, kv_len, S, splits)
            r0, r1 = rows[p]
            if r < min(kv_len, S):
                at = (r - r0) // stage_rows  # the stage before whose copy the write goes
                assert r0 + at * stage_rows <= r < min(r1, r0 + (at + 1) * stage_rows)
            else:
                assert p == splits - 1


def test_sentinel_and_a_dropped_write_in_a_batch():
    """kv_pos == S, the sentinel of a dropped write, has no writer (the
    producer warp's test is kv_pos < S); with B = 2, one row writing and one
    dropped, only the live row's owner writes, in its own stripe."""
    for splits in SPLITS:
        writes = []
        for b, (kv_pos, kv_len) in enumerate(((300, 301), (S, 120))):
            for p in range(splits):
                live = 0 <= kv_pos < S and p in _writers(kv_pos, kv_len, splits)
                if live:
                    writes.append((b, p))
        assert writes == [(0, A.decode_row_owner(300, 301, S, splits))]


def _bf16_to_jax(t: torch.Tensor):
    return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)


@functools.cache
def _jax_case(cache: str, g: int, hd: int):
    """Random planes and rows; JAX's ``fused_decode_attention`` in interpret
    mode -> (inputs as numpy, JAX out (B, H * hd), JAX planes as f32)."""
    rng = np.random.default_rng(100 * g + hd + (cache == "f32"))
    b, h = 3, KH * g
    kv_pos = np.array([WINDOW // 2 + 3, 99, WINDOW], np.int32)
    kv_len = np.array([WINDOW, 100, 50], np.int32)
    rot = np.array([1, 0, 0], np.int32)
    ck, cv = (rng.normal(size=(1, b, KH, WINDOW, hd)).astype(np.float32) for _ in range(2))
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kn, vn = (rng.normal(size=(b, KH, hd)).astype(np.float32) for _ in range(2))
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c1, s1 = A.rope_cos_sin_plus1(freqs)
    dt = CACHES[cache]
    tk, tv = (torch.from_numpy(a).to(dt) for a in (ck, cv))
    to_jax = _bf16_to_jax if dt == torch.bfloat16 else (lambda t: jnp.asarray(t.numpy()))
    out, jk, jv = jax.jit(jax_fused)(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), to_jax(tk), to_jax(tv), 0,
        *map(jnp.asarray, (kv_pos, kv_len, rot, c1[None], s1[None])))
    planes = [np.asarray(a.astype(jnp.float32)) for a in (jk, jv)]
    return (q, kn, vn, kv_pos, kv_len, rot, c1, s1, tk, tv), np.asarray(out), planes


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("g,hd", SHAPES, ids=[f"hd{hd}-g{g}" for g, hd in SHAPES])
def test_fused_decode_attention_plain_matches_jax(cache, g, hd):
    (q, kn, vn, kv_pos, kv_len, rot, c1, s1, tk, tv), want, (jk, jv) = _jax_case(cache, g, hd)
    ck, cv = tk.clone(), tv.clone()
    t = torch.from_numpy
    got = A.fused_decode_attention(t(q), ck, cv, 0, t(kn), t(vn), t(kv_pos), t(kv_len), t(rot),
                                   t(c1), t(s1))
    b, h = q.shape[:2]
    assert got.shape == (b, h * hd)
    gk, gv = ck.float().numpy(), cv.float().numpy()
    assert np.array_equal(gv, jv)
    if cache == "bf16":
        assert np.array_equal(gk, jk)
    else:  # the rotated sinks of row 0 within F32_ULPS ulps of their terms, the rest bit-equal
        sinks = np.zeros(gk.shape, bool)
        sinks[0, 0, :, :KV_SINKS] = True
        assert np.array_equal(gk[~sinks], jk[~sinks])
        v = tk[0, 0, :, :KV_SINKS].numpy()  # (KH, KV_SINKS, hd): the sinks before the rotation
        sw = np.stack([-v[..., 1::2], v[..., 0::2]], axis=-1).reshape(v.shape)
        terms = np.abs(v * c1) + np.abs(sw * s1)  # an FMA moves the sum by a rounding of these
        ulp = np.spacing(terms.astype(np.float32)).reshape(-1)
        assert (np.abs(gk[sinks] - jk[sinks]) <= F32_ULPS * ulp).all()
    assert not np.array_equal(gk, tk.float().numpy())  # the update wrote
    g_rows, w_rows = got.numpy().reshape(-1, hd), want.reshape(-1, hd)
    rel = np.abs(g_rows - w_rows).max(axis=1) / np.abs(w_rows).max(axis=1)
    assert rel.max() < TOL, rel.max()
