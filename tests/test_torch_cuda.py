"""The port's CUDA kernels against their plain PyTorch versions on the card
(moderate shapes, head_dim 128; 96 and 256 in the tests of the last
section). Every test here needs an NVIDIA GPU and
nvcc and skips without them; run them on the GPU machine with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports jax, which that machine
does not need to have.)

Tolerances are those of ``chip_smoke.py``, each against the max |ref| of
its own output row (a matmul output row, a query head's output):
qmatmul and qmatmul_multi 1e-4 and the flash-decode 1e-5 (the same exact f32 products summed in
another order); qmatmul with the norm prologue 1e-3 (the rms summed in
another order can flip the bf16 rounding of a normed activation; one such
flip moved a row by 4e-4 of its max at N=1024); kv_update bit-equal (each product and the sum rounded as
the plain version's separate f32 operations), and so are the planes of
fused_decode_attention (kv_update's arithmetic in the flash-decode's launch),
whose output is held to the flash-decode's 1e-5; flash_prefill 2^-8 (the
plain version copies the kernel's 64-key tiling, so p is rounded to bf16
at the same running max, but a score that moves by an f32 ulp can flip one
bf16 rounding of p, by 2^-8 of a p that may dominate its row). The
megakernel (fused_decode) against its plain version through ring wraps:
each step's x and logits within 2e-2 of the step's max, each cache row
within 2e-2 of its max and 95 % of the cache values within one bf16 ulp
(an f32 ulp of difference can flip the bf16 rounding of an activation
before a matmul, and the flip stays in the cache: the reasons of
tests/test_torch_fused.py).

The int8 cache: kv_update_q bit-equal to its plain version (absmax is
order-free, and the scale and codes are computed by IEEE division and
rounded half to even on both sides); flash_decode_q within 1e-3 of each
row's max (the plain version copies the kernel's 128-row chunks, so p *
v_scale is rounded to bf16 at the same chunk max, but a score that moves by
a few f32 ulps, its exact products summed in another order on the tensor
cores, can flip one such rounding, by 2^-8 of a term that holds a few
hundredths of its row's weight at most here); the megakernel's int8 branch
within 2e-2 as above, and 95 % of the codes within one count.

The int8-activation branches: qmatmul's q4 GEMV and W8A8 GEMM bit-equal to
their plain versions (both quantise x by IEEE division and round half to
even, every dot is an exact integer, and the f32 scale products and group
sums are rounded one by one in the same order). The megakernel's a8 and q4
bodies, each step started from the plain version's caches (a free run
drifts: an ulp in an attn row can move its int8 code by one count, 1/127 of
the row's max), within 5e-2 of each step's max and within 1e-5 on 90 % of
the steps (the rms and attention sums run in another order, so a rare
code lands one count apart).
"""

import dataclasses

import numpy as np
import pytest
import torch

from xalm_tpu_torch.io import write_xalm
from xalm_tpu_torch.models.config import MISTRAL_7B
from xalm_tpu_torch.ops import attention as A
from xalm_tpu_torch.ops import build
from xalm_tpu_torch.ops.qmatmul import (
    qmatmul,
    qmatmul_multi,
    qmatmul_multi_plain,
    qmatmul_plain,
)

# one intra-op thread per process, as tests/torch_threads.py sets it for the
# other port tests; set here directly, since the GPU machine runs this file
# alone (--noconftest), where another installed ``tests`` package can shadow
# this directory
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# A small i8 Mistral-style container written by the port alone (no JAX, no
# converter), head_dim 128 so the kernels take it: i8 body with per-row
# scales, bf16 embed and head, a byte-fallback tokenizer.
CONFIG = dict(dim=256, hidden_dim=512, head_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=320, max_seq_len=48, rope_theta=1e4, rotary_dim=128)


def _i8(rng, tensors, name, rows, cols, kind="i8"):
    """A random weight in the container type ``kind``: i8 with per-row
    scales, or f16 / f8_e4m3 (torch fp8: the writer stores its raw bytes)."""
    w = rng.normal(size=(rows, cols)).astype(np.float32) * 0.05
    if kind == "f16":
        tensors[name] = w.astype(np.float16)
        return
    if kind == "f8_e4m3":
        tensors[name] = torch.from_numpy(w * 8).to(torch.float8_e4m3fn)
        return
    scale = np.abs(w).max(axis=1) / 127.0
    tensors[name] = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    tensors[name + ".scale"] = scale.astype(np.float32)


def write_port_container(path: str, seed: int = 0, kind: str = "i8") -> str:
    c = CONFIG
    rng = np.random.default_rng(seed)
    words = [b"<unk>", b"<s>", b"</s>"] + [b"<0x%02X>" % i for i in range(256)]
    words += [b" hello", b" world", b"he", b"llo"]
    words += [b"w%d" % i for i in range(c["vocab_size"] - len(words))]
    tensors = {"tokenizer.tokens": np.frombuffer(b"\x00".join(words) + b"\x00", np.uint8)}
    d, h, hd = c["dim"], c["hidden_dim"], c["head_dim"]
    for i in range(c["n_layers"]):
        tensors[f"l.{i}.attn.norm.weight"] = (rng.random(d) + 0.5).astype(np.float32)
        _i8(rng, tensors, f"l.{i}.attn.q.weight", c["n_heads"] * hd, d, kind)
        _i8(rng, tensors, f"l.{i}.attn.k.weight", c["n_kv_heads"] * hd, d, kind)
        _i8(rng, tensors, f"l.{i}.attn.v.weight", c["n_kv_heads"] * hd, d, kind)
        _i8(rng, tensors, f"l.{i}.attn.down.weight", d, c["n_heads"] * hd, kind)
        tensors[f"l.{i}.mlp.norm.weight"] = (rng.random(d) + 0.5).astype(np.float32)
        _i8(rng, tensors, f"l.{i}.mlp.gate.weight", h, d, kind)
        _i8(rng, tensors, f"l.{i}.mlp.up.weight", h, d, kind)
        _i8(rng, tensors, f"l.{i}.mlp.down.weight", d, h, kind)
    for name in ("embed.weight", "output.weight"):
        tensors[name] = torch.from_numpy(rng.normal(size=(c["vocab_size"], d)).astype(np.float32)
                                         * 0.1).to(torch.bfloat16)
    tensors["output.norm.weight"] = (rng.random(d) + 0.5).astype(np.float32)
    config = {k: str(v) for k, v in c.items()}
    config.update(act_type="silu", norm_eps="1e-05", bos_token_id="1", eos_token_id="2")
    write_xalm(path, "MistralForCausalLM", config, tensors)
    return path


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _row_rel(got, want, row: int) -> float:
    """max over rows of max |got - want| / max |want| of that row."""
    got, want = got.float().reshape(-1, row), want.float().reshape(-1, row)
    err = (got - want).abs().amax(dim=1)
    return float((err / want.abs().amax(dim=1).clamp_min(1e-30)).max())


def _attend(q, ck, cv, layer: int, kv_len) -> torch.Tensor:
    """Kernel 3 alone: ``fused_decode_attention`` with the write dropped
    (kv_pos at the sentinel S) and no sink rotation, planes untouched."""
    _, b, kh, s, hd = ck.shape
    z = torch.zeros((b, kh, hd), device=q.device)
    sentinel = torch.full((b,), s, dtype=torch.int32, device=q.device)
    none = torch.zeros((b,), dtype=torch.int32, device=q.device)
    one = torch.ones(hd, device=q.device)
    return A.fused_decode_attention(q, ck, cv, layer, z, z, sentinel, kv_len, none, one, one)


@pytest.mark.parametrize("n", [24576, 81920])
def test_qmatmul_gemv_at_wide_contractions(dev, n):
    """The M = 1 GEMV with the contraction width of Gemma-7B's w2 (24576:
    the bf16 copy of x is exactly 48 KB of dynamic shared memory, which with
    the kernel's static bytes needs the opt-in; it was refused before) and
    the widest the GEMV takes (160 KB), with and without the norm prologue,
    at the tolerances of the test below."""
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((1, n), device=dev, generator=gen)
    w = torch.randint(-128, 128, (2, 64, n), dtype=torch.int8, device=dev, generator=gen)
    scale = torch.rand((2, 64), device=dev, generator=gen) * 1e-3
    norm_w = torch.rand((2, n), device=dev, generator=gen) + 0.5
    for kw, tol in ((dict(scale=scale), 1e-4),
                    (dict(scale=scale, norm_w=norm_w, norm_eps=1e-6), 1e-3)):
        got = qmatmul(x, w, 1, **kw)
        assert _row_rel(got, qmatmul_plain(x, w, 1, **kw), 64) <= tol


@pytest.mark.parametrize("m", [1, 3, 8, 16, 100])
@pytest.mark.parametrize("wdt", [torch.int8, torch.bfloat16])
def test_qmatmul_matches_plain(dev, m, wdt):
    g = torch.Generator(device=dev).manual_seed(m)
    l, d, n = 3, 1000, 1024
    if wdt == torch.int8:
        w = torch.randint(-128, 128, (l, d, n), dtype=torch.int8, device=dev, generator=g)
        kw = dict(scale=torch.rand((l, d), device=dev, generator=g) * 0.01)
    else:
        w = torch.randn((l, d, n), device=dev, generator=g).to(wdt)
        kw = {}
    x = torch.randn((m, n), device=dev, generator=g)
    nw = torch.rand((l, n), device=dev, generator=g) + 0.5
    for norm in (False, True):
        extra = dict(norm_w=nw, norm_eps=1e-5) if norm else {}
        got = qmatmul(x, w, 2, **kw, **extra)
        assert _row_rel(got, qmatmul_plain(x, w, 2, **kw, **extra), d) < (1e-3 if norm else 1e-4)


def test_attention_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    l, b, kh, s, hd, h = 2, 2, 4, 544, 128, 16
    ck = torch.randn((l, b, kh, s, hd), device=dev, generator=g).to(torch.bfloat16)
    cv = torch.randn((l, b, kh, s, hd), device=dev, generator=g).to(torch.bfloat16)
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c, sn = (torch.from_numpy(a).to(dev) for a in A.rope_cos_sin_plus1(freqs))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    kn = torch.randn((b, kh, hd), device=dev, generator=g)
    vn = torch.randn((b, kh, hd), device=dev, generator=g)
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    args = (kn, vn, i32(300, s), i32(1, 0), c, sn)
    A.kv_update(k1, v1, 1, *args)
    A.kv_update_plain(k2, v2, 1, *args)
    assert torch.equal(v1, v2) and torch.equal(k1, k2)
    q = torch.randn((b, h, hd), device=dev, generator=g)
    for kvl in ((0, 5), (129, 544), (1, 300)):
        got = _attend(q, k1, v1, 1, i32(*kvl))
        want = A.flash_decode_plain(q, k1, v1, 1, i32(*kvl))
        assert torch.isfinite(got).all()
        assert _row_rel(got, want, hd) < 1e-5
    for t in (64, 40):  # 40: a partial last query tile
        qp = torch.randn((b, t, h, hd), device=dev, generator=g)
        got = A.flash_prefill(qp, k1, v1, 0, i32(0, 100))
        assert _row_rel(got, A.flash_prefill_plain(qp, k1, v1, 0, i32(0, 100)), hd) <= 2.0 ** -8


def _int8_planes(dev, g, l, b, kh, s, hd):
    ck = torch.randint(-127, 128, (l, b, kh, s, hd), dtype=torch.int8, device=dev, generator=g)
    cv = torch.randint(-127, 128, (l, b, kh, s, hd), dtype=torch.int8, device=dev, generator=g)
    ks = torch.rand((l, b, kh, s), device=dev, generator=g) * 0.02
    vs = torch.rand((l, b, kh, s), device=dev, generator=g) * 0.02
    return ck, cv, ks, vs


def test_int8_attention_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    l, b, kh, s, hd, h = 2, 3, 4, 544, 128, 16
    planes = _int8_planes(dev, g, l, b, kh, s, hd)
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c, sn = (torch.from_numpy(a).to(dev) for a in A.rope_cos_sin_plus1(freqs))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    kn = torch.randn((b, kh, hd), device=dev, generator=g)
    vn = torch.randn((b, kh, hd), device=dev, generator=g)
    kn[2, 1] = 0.0  # an all-zero row: scale 1, codes 0
    # a mid-ring insert, a wrapped insert with sink rotation, the sentinel
    for kv_pos, rot in (((300, 77, s), (0, 1, 0)), ((5, s + 3, 40), (1, 0, 1))):
        p1 = [t.clone() for t in planes]
        p2 = [t.clone() for t in planes]
        args = (kn, vn, i32(*kv_pos), i32(*rot), c, sn)
        A.kv_update_q(*p1, 1, *args)
        A.kv_update_q_plain(*p2, 1, *args)
        assert all(torch.equal(x, y) for x, y in zip(p1, p2)), kv_pos
    assert build.LAUNCHES["kv_update_q"] >= 2
    q = torch.randn((b, h, hd), device=dev, generator=g)
    for kvl in ((0, 5, 1), (129, 544, 520), (1, 300, 128)):
        got = A.flash_decode_q(q, *p1, 1, i32(*kvl))
        want = A.flash_decode_q_plain(q, *p1, 1, i32(*kvl))
        assert torch.isfinite(got).all()
        assert _row_rel(got, want, hd) < 1e-3, kvl
        if kvl[0] == 0:
            assert not got[0].any()
    with pytest.raises(ValueError, match="scale"):
        A.flash_decode_q(q, *p1[:2], p1[2][0], p1[3], 1, i32(1, 1, 1))


def test_engine_int8_kernels_match_plain_through_wraps(dev):
    """The int8 cache on both decode paths, kernels against plain versions,
    teacher-forced through three wraps of a 64-slot window: each step's
    logits within 2e-2 of their max; every decode step launches the
    megakernel, or once per layer the launch that inserts, re-rotates the
    sinks and attends (counted under flash_decode_q; no kv_update_q)."""
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, dim=512, hidden_dim=1024, n_layers=2,
                              vocab_size=512, max_seq_len=64)
    params = synthetic_params(cfg, device=dev, seed=4)
    prompt = list(range(3, 40))
    for kw, path in ((dict(fused_step=False), "perlayer"), ({}, "megakernel")):
        ek = Engine(cfg, params, kv_dtype=torch.int8, matmul_impl="kernel", **kw)
        ep = Engine(cfg, params, kv_dtype=torch.int8, matmul_impl="plain", **kw)
        assert ek.decode_path(1) == path
        lk, ck, pos = ek.prefill(prompt, ek.new_cache(1))
        lp, cp, _ = ep.prefill(prompt, ep.new_cache(1))
        build.reset_launches()
        for _ in range(3 * 64):
            tok = np.array([int(lk.argmax())])
            lk, ck = ek.decode(tok, np.array([pos], np.int32), ck)
            lp, cp = ep.decode(tok, np.array([pos], np.int32), cp)
            assert float((lk - lp).abs().max()) <= 2e-2 * float(lp.abs().max()), (path, pos)
            pos += 1
        if path == "megakernel":
            assert build.LAUNCHES["fused_decode"] == 3 * 64
        else:  # one launch a layer inserts, re-rotates and attends
            assert build.LAUNCHES["flash_decode_q"] == 3 * 64 * 2
            assert build.LAUNCHES["kv_update_q"] == 0
        assert build.LAUNCHES["kv_update"] == build.LAUNCHES["flash_decode"] == 0


def test_engine_kernels_match_plain_through_wraps(dev):
    """Both decode paths against the plain engine through three wraps: the
    per-layer kernels give the same greedy tokens; the megakernel (its
    bf16 roundings flip where the per-layer path's do not) is held
    teacher-forced, each step's logits within 2e-2 of their max."""
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, dim=512, hidden_dim=1024, n_layers=2,
                              vocab_size=512, max_seq_len=64)
    params = synthetic_params(cfg, device=dev, seed=3)
    total = dict.fromkeys(build.LAUNCHES, 0)
    prompt = list(range(3, 40))
    ek = Engine(cfg, params, kv_dtype=torch.bfloat16, matmul_impl="kernel", fused_step=False)
    ep = Engine(cfg, params, kv_dtype=torch.bfloat16, matmul_impl="plain", fused_step=False)
    build.reset_launches()
    got, _ = ek.generate(prompt, 3 * 64, stop_on_eos=False)
    total = {k: total[k] + n for k, n in build.LAUNCHES.items()}
    want, _ = ep.generate(prompt, 3 * 64, stop_on_eos=False)
    assert got == want

    ek = Engine(cfg, params, kv_dtype=torch.bfloat16, matmul_impl="kernel")
    ep = Engine(cfg, params, kv_dtype=torch.bfloat16, matmul_impl="plain")
    assert ek.decode_path(1) == "megakernel"
    build.reset_launches()
    lk, ck, pos = ek.prefill(prompt, ek.new_cache(1))
    lp, cp, _ = ep.prefill(prompt, ep.new_cache(1))
    for _ in range(3 * 64):
        tok = np.array([int(lk.argmax())])
        lk, ck = ek.decode(tok, np.array([pos], np.int32), ck)
        lp, cp = ep.decode(tok, np.array([pos], np.int32), cp)
        assert float((lk - lp).abs().max()) <= 2e-2 * float(lp.abs().max()), pos
        pos += 1
    assert build.LAUNCHES["fused_decode"] == 3 * 64
    total = {k: total[k] + n for k, n in build.LAUNCHES.items()}
    # the per-layer step updates the ring in flash_decode's launch: no kv_update
    bf16_kernels = ("qmatmul", "flash_decode", "flash_prefill", "fused_decode")
    assert all(total[k] > 0 for k in bf16_kernels) and total["kv_update"] == 0, total


def _expert_stack(dev, g, wdt, le, d, n):
    if wdt == "bf16":
        return torch.randn((le, d, n), device=dev, generator=g).to(torch.bfloat16), None
    w = torch.randint(-128, 128, (le, d, n), dtype=torch.int8, device=dev, generator=g)
    return w, (torch.rand((le, d), device=dev, generator=g) * 0.01 if wdt == "i8" else None)


@pytest.mark.parametrize("wdt", ["i8", "q8", "bf16"])
@pytest.mark.parametrize("m,shared,n", [(1, True, 1040), (1, False, 1040), (4, True, 1040),
                                        (3, False, 1040), (20, True, 1040), (8, False, 14336)])
def test_qmatmul_multi_matches_plain(dev, wdt, m, shared, n):
    """The gathered expert matmul against its plain version, 1e-4 of each
    output row's max: N = 1040 ends mid lane stride, m = 20 takes three row
    groups, N = 14336 at m = 8 five column chunks of x."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    le, d = 12, 1000 if n < 4096 else 136
    w, scale = _expert_stack(dev, g, wdt, le, d, n)
    idxs = torch.tensor([11, 2, 7], dtype=torch.int32, device=dev)
    x = torch.randn((m if shared else 3 * m, n), device=dev, generator=g)
    build.reset_launches()
    got = qmatmul_multi(x, w, scale, idxs, shared_x=shared)
    assert build.LAUNCHES["qmatmul_multi"] == 1
    want = qmatmul_multi_plain(x, w, scale, idxs, shared_x=shared)
    assert got.shape == want.shape == (3 * m, d)
    assert torch.isfinite(got).all()
    assert _row_rel(got, want, d) < 1e-4


def test_qmatmul_multi_64bit_offsets(dev):
    """An expert index whose weights start at 2^31 bytes into the stack, and
    an index outside the stack (NaN rows, never a stray read)."""
    le, d, n = 9, 1024, 262144  # 256 MiB per expert, 2.25 GiB in all
    if torch.cuda.mem_get_info(dev)[0] < 6 * 2**30:
        pytest.skip("needs 6 GiB of free device memory")
    g = torch.Generator(device=dev).manual_seed(9)
    w, scale = _expert_stack(dev, g, "i8", le, d, n)
    x = torch.randn((1, n), device=dev, generator=g)
    idxs = torch.tensor([8, 0], dtype=torch.int32, device=dev)
    got = qmatmul_multi(x, w, scale, idxs)
    assert _row_rel(got, qmatmul_multi_plain(x, w, scale, idxs), d) < 1e-4
    bad = qmatmul_multi(x, w, scale, torch.tensor([le, 1], dtype=torch.int32, device=dev))
    one = torch.tensor([1], dtype=torch.int32, device=dev)
    assert torch.isnan(bad[0]).all()
    assert _row_rel(bad[1:], qmatmul_multi_plain(x, w, scale, one), d) < 1e-4


def test_qmatmul_multi_refuses_what_it_does_not_take(dev):
    w = torch.zeros((4, 64, 128), dtype=torch.float32, device=dev)
    x = torch.zeros((1, 128), device=dev)
    idxs = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="weight dtype"):  # f16: no kernel dtype, as on the TPU
        qmatmul_multi(x, w.half(), None, idxs)
    w8 = w.to(torch.int8)
    for bad in (idxs.long(), idxs.cpu()):
        with pytest.raises(ValueError):
            qmatmul_multi(x, w8, None, bad)
    with pytest.raises(ValueError):  # N % 16 != 0: refused in the CUDA source
        qmatmul_multi(torch.zeros((1, 120), device=dev), torch.zeros((4, 64, 120), dtype=torch.int8,
                                                                      device=dev), None, idxs)


def _small_mixtral(dev, seed):
    from xalm_tpu_torch.models.config import MIXTRAL_8X7B
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MIXTRAL_8X7B, dim=512, hidden_dim=1024, n_layers=2,
                              vocab_size=512, max_seq_len=64)
    return cfg, synthetic_params(cfg, device=dev, seed=seed)


def test_engine_moe_float_experts_on_the_kernel_path(dev):
    """f32 experts on the card: a kernel-path decode step gathers them
    through qmatmul_multi's f32 branch (refused before); f16 experts run
    dense-masked on both paths, as the JAX gate sends them (the kernel takes
    no f16). Logits within 2e-2 of the plain path's max, the bar of
    ``test_engine_moe_kernels_match_plain_through_wraps``: the experts agree
    to f32 rounding, but the i8 attention rounds its inputs to bf16 and the
    cache is bf16, so an f32 ulp upstream can flip a rounding (1.4e-3 on an
    H100)."""
    from xalm_tpu_torch.models.llama import gathered_ok
    from xalm_tpu_torch.models.params import QWeight
    from xalm_tpu_torch.runtime.engine import Engine

    cfg, params = _small_mixtral(dev, 6)
    lw = params.layers
    prompt = list(range(3, 12))
    tok = np.array([5])
    for dt, gathered in ((torch.float32, True), (torch.float16, False)):
        def dequant(qw):
            return QWeight((qw.values.float() * qw.scale[..., None]).to(dt), None)

        p = dataclasses.replace(params, layers=dataclasses.replace(lw, w13e=dequant(lw.w13e),
                                                                    w2e=dequant(lw.w2e)))
        assert gathered_ok(p.layers.w13e, "kernel") == gathered
        assert gathered_ok(p.layers.w13e, "plain") == gathered
        logits = []
        for impl in ("kernel", "plain"):
            eng = Engine(cfg, p, matmul_impl=impl)
            _, c, pos = eng.prefill(prompt, eng.new_cache(1))  # a prefill chunk: dense-masked
            build.reset_launches()
            lg, _ = eng.decode(tok, np.array([pos], np.int32), c)
            assert torch.isfinite(lg).all()
            launches = build.LAUNCHES["qmatmul_multi_f32"] + build.LAUNCHES["qmatmul_multi"]
            assert launches == (2 * cfg.n_layers if impl == "kernel" and gathered else 0), impl
            logits.append(lg)
        assert float((logits[0] - logits[1]).abs().max()) <= 2e-2 * float(logits[1].abs().max())


def test_engine_moe_kernels_match_plain_through_wraps(dev):
    """A small Mixtral (8 experts, 2 active) on the per-layer path, kernels
    against plain versions, teacher-forced through three wraps of a 64-slot
    window with a bf16 and an int8 cache: each step's logits within 2e-2 of
    their max, one qmatmul_multi launch per matmul (2 per layer and token)."""
    from xalm_tpu_torch.runtime.engine import Engine

    cfg, params = _small_mixtral(dev, 5)
    prompt = list(range(3, 40))
    for kv in (torch.bfloat16, torch.int8):
        ek = Engine(cfg, params, kv_dtype=kv, matmul_impl="kernel")
        ep = Engine(cfg, params, kv_dtype=kv, matmul_impl="plain")
        assert ek.decode_path(1) == "perlayer"
        lk, ck, pos = ek.prefill(prompt, ek.new_cache(1))
        lp, cp, _ = ep.prefill(prompt, ep.new_cache(1))
        build.reset_launches()
        for _ in range(3 * 64):
            tok = np.array([int(lk.argmax())])
            lk, ck = ek.decode(tok, np.array([pos], np.int32), ck)
            lp, cp = ep.decode(tok, np.array([pos], np.int32), cp)
            assert float((lk - lp).abs().max()) <= 2e-2 * float(lp.abs().max()), (kv, pos)
            pos += 1
        assert build.LAUNCHES["qmatmul_multi"] == 3 * 64 * 2 * 2
        assert build.LAUNCHES["qmatmul"] == 3 * 64 * (2 * 2 + 1)
        assert build.LAUNCHES["fused_decode"] == 0


FUSED_CFG = dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=320,
                 max_seq_len=48)


def _ulp_share(got, want) -> float:
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((g - w).abs() <= ulp).float().mean())


def _code_share(got, want) -> float:
    return float(((got.int() - want.int()).abs() <= 1).float().mean())


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("folds", [False, True])
def test_fused_decode_int8_matches_plain_through_wraps(dev, b, folds):
    """The megakernel's int8-KV branch against its plain version, as below:
    zeroed int8 planes, from position 0 through three wraps of a 48-slot
    window, row 1 at the sentinel when B = 3."""
    from xalm_tpu_torch.models.llama import rope_constants, rope_tables
    from xalm_tpu_torch.models.params import recode_wcls_i8
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    params = synthetic_params(cfg, device=dev, seed=10 + b)
    if folds:
        params = recode_wcls_i8(params)
    s = cfg.max_seq_len
    freqs, c1, s1 = rope_constants(cfg, dev)
    kern = KVCache.init(cfg, b, torch.int8, dev)
    plain = KVCache.init(cfg, b, torch.int8, dev)
    rng = np.random.default_rng(b)
    start = np.array([0, 7, 20][:b])
    build.reset_launches()
    steps = s + 2 * (s - 2) + 4
    for st in range(steps):
        pos = torch.from_numpy((start + st).astype(np.int32))
        _, kv_pos, kv_len = ring_indices(pos, s)
        rot = (pos >= s).to(torch.int32)
        if b == 3:
            kv_pos[1], rot[1] = s, 0
        tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=b))
        kw = {}
        if folds:
            kw = dict(wcls=params.wcls, out_norm=params.out_norm)
            if b == 1:
                kw.update(embed=params.embed, token=tok, pos=pos, freqs=freqs)
        x0 = ce = se = None
        if "embed" not in kw:
            x0 = params.embed.values[tok.to(dev)].float()
            ce, se = (z[:, 0, 0] for z in rope_tables(pos[:, None], freqs.cpu()))
        got = fd.fused_decode_step(params, cfg, x0, kern.k, kern.v, kv_pos, kv_len, rot, ce, se,
                                   c1, s1, k_scale=kern.k_scale, v_scale=kern.v_scale, **kw)
        want = fd.fused_decode_step_plain(params, cfg, x0, plain.k, plain.v, kv_pos, kv_len, rot,
                                          ce, se, c1, s1, k_scale=plain.k_scale,
                                          v_scale=plain.v_scale, **kw)
        torch.cuda.synchronize()
        assert len(got) == len(want) == (7 if folds else 5)
        assert _row_rel(got[0], want[0], cfg.dim) <= 2e-2, st
        if folds:
            assert _row_rel(got[1], want[1], cfg.vocab_size) <= 2e-2, st
            assert torch.equal(got[2], got[1].argmax(dim=-1).to(torch.int32))
    assert build.LAUNCHES["fused_decode"] == steps
    for c, sc, pc, psc in ((kern.k, kern.k_scale, plain.k, plain.k_scale),
                           (kern.v, kern.v_scale, plain.v, plain.v_scale)):
        live = slice(0, s)
        deq, pdeq = (x[:, :, :, live].float() * y[..., live, None] for x, y in ((c, sc), (pc, psc)))
        assert _row_rel(deq, pdeq, cfg.head_dim) <= 2e-2
        assert _code_share(c, pc) >= 0.95


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("folds", [False, True])
def test_fused_decode_matches_plain_through_wraps(dev, b, folds):
    """The megakernel against its plain version, each with its own bf16
    caches, from position 0 through three wraps of a 48-slot window; rows
    start at different positions and, at B = 3, row 1 sits at the kv_pos ==
    S sentinel. ``folds``: the embed fold and the i8-head fold."""
    from xalm_tpu_torch.models.llama import rope_constants, rope_tables
    from xalm_tpu_torch.models.params import recode_wcls_i8
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    params = synthetic_params(cfg, device=dev, seed=b)
    if folds:
        params = recode_wcls_i8(params)
    s = cfg.max_seq_len
    freqs, c1, s1 = rope_constants(cfg, dev)
    shape = KVCache.plane_shape(cfg, b)
    ck, cv = torch.zeros(shape, dtype=torch.bfloat16, device=dev), torch.zeros(
        shape, dtype=torch.bfloat16, device=dev)
    pk, pv = ck.clone(), cv.clone()
    rng = np.random.default_rng(b)
    start = np.array([0, 7, 20][:b])
    build.reset_launches()
    steps = s + 2 * (s - 2) + 4
    for st in range(steps):
        pos = torch.from_numpy((start + st).astype(np.int32))
        _, kv_pos, kv_len = ring_indices(pos, s)
        rot = (pos >= s).to(torch.int32)
        if b == 3:
            kv_pos[1], rot[1] = s, 0
        tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=b))
        kw = {}
        if folds:
            kw = dict(wcls=params.wcls, out_norm=params.out_norm, embed=params.embed, token=tok,
                      pos=pos, freqs=freqs)
            x0 = ce = se = None
        else:
            x0 = params.embed.values[tok.to(dev)].float()
            ce, se = (z[:, 0, 0] for z in rope_tables(pos[:, None], freqs.cpu()))
        got = fd.fused_decode_step(params, cfg, x0, ck, cv, kv_pos, kv_len, rot, ce, se, c1, s1,
                                   **kw)
        want = fd.fused_decode_step_plain(params, cfg, x0, pk, pv, kv_pos, kv_len, rot, ce, se,
                                          c1, s1, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got[0]).all()
        assert _row_rel(got[0], want[0], cfg.dim) <= 2e-2, st
        if folds:
            assert _row_rel(got[1], want[1], cfg.vocab_size) <= 2e-2, st
            assert torch.equal(got[2], got[1].argmax(dim=-1).to(torch.int32))
            top2 = want[1].topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 4e-2 * want[1].abs().amax(dim=-1)
            assert torch.equal(got[2][clear], want[2][clear]), st
    assert build.LAUNCHES["fused_decode"] == steps
    for got_c, want_c in ((ck, pk), (cv, pv)):
        assert _row_rel(got_c, want_c, cfg.head_dim) <= 2e-2
        assert _ulp_share(got_c, want_c) >= 0.95


def test_fused_decode_refuses_what_it_does_not_take(dev):
    from types import SimpleNamespace

    from xalm_tpu_torch.models.llama import rope_constants
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    params = synthetic_params(cfg, device=dev, seed=0)
    _, c1, s1 = rope_constants(cfg, dev)

    def call(b=1, dtype=torch.bfloat16, p=params, **kw):
        shape = (cfg.n_layers, b, cfg.n_kv_heads, 64, cfg.head_dim)
        z = torch.zeros(shape, dtype=dtype, device=dev)
        i = torch.zeros((b,), dtype=torch.int32)
        trig = torch.ones((b, cfg.head_dim), device=dev), torch.zeros((b, cfg.head_dim), device=dev)
        return fd.fused_decode_step(p, cfg, torch.zeros((b, cfg.dim), device=dev), z, z.clone(),
                                    i, i + 1, i, *trig, c1, s1, **kw)

    call()  # the shapes the refusals below change
    with pytest.raises(ValueError, match="int8 KV"):
        call(dtype=torch.int8)  # an int8 cache without its scale planes
    with pytest.raises(ValueError, match="batch"):
        call(b=9)
    call(dtype=torch.float32)  # the f32 cache's instantiations
    with pytest.raises(ValueError, match="bf16 or f32"):
        call(dtype=torch.float16)  # no megakernel takes f16, as in the JAX gate
    lp = params.layers
    q4 = SimpleNamespace(values=lp.w2.values, scale=lp.w2.scale, q4group=128)
    with pytest.raises(ValueError, match="q4"):
        call(p=dataclasses.replace(params, layers=dataclasses.replace(lp, w2=q4)))


def test_engine_on_the_card_takes_the_megakernel(dev):
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    eng = Engine(cfg, synthetic_params(cfg, device=dev, seed=1), kv_dtype=torch.bfloat16)
    assert eng.decode_path(1) == "megakernel" and eng.decode_path(9) == "perlayer"
    build.reset_launches()
    out, _ = eng.generate([3, 4, 5, 6], 20, stop_on_eos=False)
    assert len(out) == 20
    assert build.LAUNCHES["fused_decode"] == 19
    assert build.LAUNCHES["kv_update"] == build.LAUNCHES["flash_decode"] == 0


def _forced_close(ek, ep, prompt, steps: int, tol: float = 2e-2) -> None:
    """Prefill, then ``steps`` decode steps of the kernel engine ``ek`` and
    the plain engine ``ep``, both fed the plain engine's greedy token: each
    step's logits within ``tol`` of the plain max |logits|. (Tokens of
    random weights are no check: an activation rounded to bf16 the other
    way can swap a close top-2.)"""
    lk, ck, pos = ek.prefill(prompt, ek.new_cache(1))
    lp, cp, _ = ep.prefill(prompt, ep.new_cache(1))
    for _ in range(steps):
        assert float((lk - lp).abs().max()) <= tol * float(lp.abs().max()), pos
        tok = np.array([int(lp.argmax())])
        lk, ck = ek.decode(tok, np.array([pos], np.int32), ck)
        lp, cp = ep.decode(tok, np.array([pos], np.int32), cp)
        pos += 1
    assert float((lk - lp).abs().max()) <= tol * float(lp.abs().max()), pos


@pytest.mark.parametrize("kv_dtype", [torch.float16, torch.float32])
def test_kernel_engine_takes_f32_and_f16_caches(dev, kv_dtype):
    """Every cache of the JAX harness's -t runs on the card: f32 on the
    megakernel's f32 instantiation
    and kernels 2-4's, f16 per layer on kernel 1 and the dense attention,
    no attention kernel launched. Teacher-forced through a ring wrap, each
    step's logits within 2e-2 of the plain path's max (``_forced_close``)."""
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, dim=256, hidden_dim=512, n_layers=1,
                              vocab_size=64, max_seq_len=32)
    params = synthetic_params(cfg, device=dev, seed=0)
    f32 = kv_dtype == torch.float32
    for fs in ("auto", False):
        eng = Engine(cfg, params, kv_dtype=kv_dtype, fused_step=fs)
        assert eng.decode_path(1) == ("megakernel" if f32 and fs else "perlayer")
        build.reset_launches()
        _forced_close(eng, Engine(cfg, params, kv_dtype=kv_dtype, fused_step=fs,
                                  matmul_impl="plain"), [3, 4, 5, 6], 39)  # through a wrap
        attention = ("kv_update_f32", "flash_decode_f32", "flash_prefill_f32", "kv_update",
                     "flash_decode", "flash_prefill")
        if not f32:
            assert all(build.LAUNCHES[k] == 0 for k in attention + ("fused_decode_f32",))
        elif fs:
            assert build.LAUNCHES["fused_decode_f32"] == build.LAUNCHES["fused_decode"] == 39
            assert build.LAUNCHES["flash_prefill_f32"] == cfg.n_layers
        else:
            # the ring update rides in flash_decode_f32's launch
            assert build.LAUNCHES["flash_decode_f32"] == 39
            assert build.LAUNCHES["kv_update_f32"] == 0
            assert build.LAUNCHES["kv_update"] == build.LAUNCHES["flash_decode"] == 0
        assert build.LAUNCHES["qmatmul"] > 0


def test_kernel_engine_takes_f32_and_f16_heads(dev):
    """An f32 head runs kernel 1's f32 branch on the card (it was refused
    before); an f16 head, no kernel dtype, the plain product (the JAX
    ``_pallas_ok`` sends it to XLA). Prefill logits within 1e-3 of the plain
    path's max |logits|: the body's i8 matmuls round their inputs to bf16 on
    both paths, and a sum in another order can flip one such rounding."""
    from xalm_tpu_torch.models.params import QWeight
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, dim=256, hidden_dim=512, n_layers=1,
                              vocab_size=64, max_seq_len=32)
    params = synthetic_params(cfg, device=dev, seed=0)
    for dt in (torch.float32, torch.float16):
        p = dataclasses.replace(params, wcls=QWeight(params.wcls.values.to(dt), None))
        ek, ep = Engine(cfg, p, fused_step=False), Engine(cfg, p, matmul_impl="plain")
        build.reset_launches()
        lk, _, _ = ek.prefill([3, 4, 5], ek.new_cache(1))
        assert build.LAUNCHES["qmatmul"] == 4 * cfg.n_layers  # the i8 body
        assert build.LAUNCHES["qmatmul_f32"] == (1 if dt == torch.float32 else 0), dt
        lp, _, _ = ep.prefill([3, 4, 5], ep.new_cache(1))
        assert float((lk - lp).abs().max()) <= 1e-3 * float(lp.abs().max()), dt


def test_harness_on_the_card(dev, tmp_path, capsys):
    from xalm_tpu_torch.harness import main as harness

    path = write_port_container(str(tmp_path / "port.xalm"))
    build.reset_launches()
    assert harness.main([path, "-d", "cuda", "-i", "hello world", "-n", "80"]) == 0
    out = capsys.readouterr().out
    assert "decode path: megakernel" in out and "80 tokens" in out
    assert all(build.LAUNCHES[k] > 0 for k in ("qmatmul", "flash_prefill", "fused_decode")), \
        build.LAUNCHES
    assert harness.main([path, "-d", "cuda", "-m", "perplexity", "-i", "hello world " * 30]) == 0
    assert "perplexity:" in capsys.readouterr().out
    build.reset_launches()
    assert harness.main([path, "-d", "cuda", "-t", "i8", "-i", "hello world", "-n", "80"]) == 0
    out = capsys.readouterr().out
    assert "decode path: megakernel" in out and "80 tokens" in out
    assert build.LAUNCHES["fused_decode"] == 79 and build.LAUNCHES["flash_prefill"] == 0
    assert harness.main([path, "-d", "cuda", "-t", "i8", "-m", "passkey", "-n", "20",
                         "--seed", "1"]) in (0, 1)
    assert "retrieval:" in capsys.readouterr().out


# (group, M, N, D) of the q4 GEMV: 24-byte scale rows (N 1536 at g256, 3072
# at g512), M past 8 (launches of 8 rows), Gemma-7B's w2 (N 24576: 8 rows of
# x do not fit beside the ring, launches of 6), Qwen2.5-7B's w2 at M = 8, and
# a group of three 128-byte chunks (g384)
Q4_GEMV_CASES = ([(g, m, 1536, 1000) for g in (128, 256) for m in (1, 3, 8, 13, 100)]
                 + [(g, m, 24576, 3072) for g in (128, 512) for m in (1, 8)]
                 + [(512, 1, 3072, 1000), (512, 4, 3072, 12288), (128, 8, 18944, 3584),
                    (384, 2, 2304, 1000)])


@pytest.mark.parametrize("group,m,n,d", Q4_GEMV_CASES)
def test_qmatmul_q4_bit_equal_to_plain(dev, group, m, n, d):
    from xalm_tpu_torch.models.params import QWeight, recode_qweight_q4

    g = torch.Generator(device=dev).manual_seed(m + group)
    l = 3
    w = torch.randint(-128, 128, (l, d, n), dtype=torch.int8, device=dev, generator=g)
    qw = recode_qweight_q4(QWeight(w, torch.rand((l, d), device=dev, generator=g) * 0.01), group)
    x = torch.randn((m, n), device=dev, generator=g) * 3
    build.reset_launches()
    got = qmatmul(x, qw.values, 2, scale=qw.scale, q4_group=group)
    assert build.LAUNCHES["qmatmul_q4"] == 1
    assert torch.equal(got, qmatmul_plain(x, qw.values, 2, scale=qw.scale, q4_group=group))


@pytest.mark.parametrize("kind", ["i8", "q8"])
@pytest.mark.parametrize("m", [1, 100, 256, 512])
def test_qmatmul_a8_bit_equal_to_plain(dev, kind, m):
    g = torch.Generator(device=dev).manual_seed(m)
    l, d, n = 2, 1000, 1536
    w = torch.randint(-128, 128, (l, d, n), dtype=torch.int8, device=dev, generator=g)
    kw = dict(scale=torch.rand((l, d), device=dev, generator=g) * 0.01) if kind == "i8" else \
        dict(q8_scale=0.01)
    x = torch.randn((m, n), device=dev, generator=g)
    build.reset_launches()
    got = qmatmul(x, w, 1, a8=True, **kw)
    assert build.LAUNCHES["qmatmul_a8"] == 1
    assert torch.equal(got, qmatmul_plain(x, w, 1, a8=True, **kw))


def test_qmatmul_quantised_branches_refuse_what_they_do_not_take(dev):
    from xalm_tpu_torch.models.params import QWeight, recode_qweight_q4

    w = torch.zeros((1, 64, 512), dtype=torch.int8, device=dev)
    qw = recode_qweight_q4(QWeight(w, torch.ones((1, 64), device=dev)), 128)
    with pytest.raises(ValueError, match="decode shapes"):
        qmatmul(torch.ones((256, 512), device=dev), qw.values, 0, scale=qw.scale, q4_group=128)
    with pytest.raises(ValueError, match="group scales"):
        qmatmul(torch.ones((1, 512), device=dev), qw.values, 0, scale=None, q4_group=128)
    build.reset_launches()
    for n in (80, 4128):  # N not a multiple of 64: refused before any launch
        with pytest.raises(ValueError, match="multiple of 64"):
            qmatmul(torch.ones((256, n), device=dev), torch.zeros((1, 8, n), dtype=torch.int8,
                                                                  device=dev), 0, a8=True)
    assert build.LAUNCHES["qmatmul_a8"] == 0


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("body", ["a8", "q4"])
def test_fused_decode_a8_q4_match_plain(dev, body, b, cache):
    """The megakernel's a8 and q4 bodies (q4 at group 128) against the plain
    version through a ring wrap, B = 1 with the embed and i8-head folds, B = 3
    with row 1 at the sentinel; each step from the plain version's caches."""
    from xalm_tpu_torch.models.llama import rope_constants, rope_tables
    from xalm_tpu_torch.models.params import recode_wcls_i8
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    from xalm_tpu_torch.models.params import recode_params_q4

    cfg = dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    params = synthetic_params(cfg, device=dev, seed=20 + b)
    g = torch.Generator(device=dev).manual_seed(b)
    for qw in (params.layers.wqkv, params.layers.wo, params.layers.w13, params.layers.w2):
        qw.scale.mul_(0.5 + torch.rand(qw.scale.shape, generator=g, device=dev))  # rows apart
    if body == "q4":
        params = recode_params_q4(params, 128)
    folds = b == 1
    if folds:
        params = recode_wcls_i8(params)
    s = cfg.max_seq_len
    freqs, c1, s1 = rope_constants(cfg, dev)
    dt = torch.int8 if cache == "int8" else torch.bfloat16
    kern, plain = KVCache.init(cfg, b, dt, dev), KVCache.init(cfg, b, dt, dev)
    planes = ("k", "v", "k_scale", "v_scale") if cache == "int8" else ("k", "v")
    rng = np.random.default_rng(b)
    start = np.array([0, 7, 20][:b])
    build.reset_launches()
    steps = s + 6
    rels = []
    for st in range(steps):
        for name in planes:
            getattr(kern, name).copy_(getattr(plain, name))
        pos = torch.from_numpy((start + st).astype(np.int32))
        _, kv_pos, kv_len = ring_indices(pos, s)
        rot = (pos >= s).to(torch.int32)
        if b == 3:
            kv_pos[1], rot[1] = s, 0
        tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=b))
        kw = dict(a8=True)
        x0 = ce = se = None
        if folds:
            kw.update(wcls=params.wcls, out_norm=params.out_norm, embed=params.embed, token=tok,
                      pos=pos, freqs=freqs)
        else:
            x0 = params.embed.values[tok.to(dev)].float()
            ce, se = (z[:, 0, 0] for z in rope_tables(pos[:, None], freqs.cpu()))
        qkw = dict(k_scale=kern.k_scale, v_scale=kern.v_scale) if cache == "int8" else {}
        pkw = dict(k_scale=plain.k_scale, v_scale=plain.v_scale) if cache == "int8" else {}
        got = fd.fused_decode_step(params, cfg, x0, kern.k, kern.v, kv_pos, kv_len, rot, ce, se,
                                   c1, s1, **qkw, **kw)
        want = fd.fused_decode_step_plain(params, cfg, x0, plain.k, plain.v, kv_pos, kv_len, rot,
                                          ce, se, c1, s1, **pkw, **kw)
        torch.cuda.synchronize()
        outs = [(got[0], want[0], cfg.dim)] + ([(got[1], want[1], cfg.vocab_size)] if folds else [])
        for gv, wv, row in outs:
            assert torch.isfinite(gv).all()
            rels.append(_row_rel(gv, wv, row))
            assert rels[-1] <= 5e-2, (st, rels[-1])
        if folds:
            assert torch.equal(got[2], got[1].argmax(dim=-1).to(torch.int32))
    assert build.LAUNCHES[f"fused_decode_{body}"] == steps and build.LAUNCHES["fused_decode"] == 0
    assert np.mean(np.asarray(rels) <= 1e-5) >= 0.9, sorted(rels)[-5:]


def test_engine_q4_and_a8_on_the_card(dev, tmp_path):
    """``from_xalm(q4_group=128)`` on the card: the megakernel's q4 body,
    with ``fused_step=False`` the q4 GEMV; i8 with ``a8_prefill`` and
    ``a8_decode``: the W8A8 GEMM on a 256-row chunk and the megakernel's a8
    body. Each engine against its plain-version engine: the first 3
    free-running greedy tokens of ``generate`` equal, or those before the
    first step whose plain top-2 margin is under 0.05 (on this random model
    the a8 run's second step has a margin of 0.009, and the kernel's token
    there is another); then, teacher-forced on the plain engine's tokens for
    8 steps, every step's logits within 3e-2 of the step's max |logits|
    (read on an H100: at most 1.56e-2 for both q4 runs, 1.45e-2 for a8), and
    the same greedy token at every step whose plain margin is 0.05 or more
    (below the bar's 2 x 3e-2 of the max: not implied by the logits' bar).
    The plain engine's free run is its teacher-forced run."""
    import numpy as np

    from xalm_tpu_torch.runtime.engine import Engine

    path = write_port_container(str(tmp_path / "port.xalm"))
    prompt = list(range(3, 203))  # one 256-row chunk in a 512-slot window
    runs = [("megakernel", dict(q4_group=128), "fused_decode_q4"),
            ("perlayer", dict(q4_group=128, fused_step=False), "qmatmul_q4"),
            ("megakernel", dict(a8_prefill=True, a8_decode=True), "fused_decode_a8")]
    tie = 0.05
    for path_name, kw, counter in runs:
        kw["context"] = 512
        eng = Engine.from_xalm(path, **kw)
        assert eng.decode_path(1) == path_name
        build.reset_launches()
        out, _ = eng.generate(prompt, 8, stop_on_eos=False)
        assert len(out) == 8 and build.LAUNCHES[counter] > 0, (kw, build.LAUNCHES)
        if kw.get("a8_prefill"):
            assert build.LAUNCHES["qmatmul_a8"] == 4 * eng.cfg.n_layers
        ref = Engine.from_xalm(path, matmul_impl="plain", **kw)
        want, _ = ref.generate(prompt, 8, stop_on_eos=False)
        lk, ck, pk = eng.prefill(prompt, eng.new_cache(1))
        lp, cp, pp = ref.prefill(prompt, ref.new_cache(1))
        assert pk == pp == len(prompt)
        margins, plain_toks = [], []
        for step in range(8):
            assert torch.isfinite(lk).all()
            rel = float((lk - lp).abs().max() / lp.abs().max())
            assert rel <= 3e-2, (kw, step, rel)
            top2 = torch.topk(lp[0].float(), 2).values
            margins.append(float(top2[0] - top2[1]))
            if margins[-1] >= tie:
                assert int(lk[0].argmax()) == int(lp[0].argmax()), (kw, step, margins[-1])
            plain_toks.append(int(lp[0].argmax()))
            tok = np.array(plain_toks[-1:])
            lk, ck = eng.decode(tok, np.array([pk + step], np.int32), ck)
            lp, cp = ref.decode(tok, np.array([pp + step], np.int32), cp)
        assert want == plain_toks  # the plain engine's free run: the margins are its own
        n = next((i for i, m in enumerate(margins[:3]) if m < tie), 3)
        assert out[:n] == want[:n], (kw, margins[:3])


# ---------------------------------------------------------------- families, any GQA group


# (GQA group, head_dim): the groups that are not a power of two at 128, and
# head_dim 96 (Phi-3) and 256 (Gemma, Gemma-2), up to G = 8 at 256, which
# fills the flash-decodes' static shared memory
ATTENTION_SHAPES = [(3, 128), (5, 128), (6, 128), (7, 128), (1, 96), (3, 96), (1, 256), (2, 256),
                    (8, 256)]


@pytest.mark.parametrize("g,hd", ATTENTION_SHAPES,
                         ids=[str(g) if hd == 128 else f"hd{hd}-g{g}" for g, hd in ATTENTION_SHAPES])
def test_attention_kernels_at_group_match_plain(dev, g, hd):
    """Kernels 2-4 (bf16 cache) and 5-7 (int8 cache) at a GQA group that is
    not a power of two (Qwen2.5-7B has 7, Qwen2.5-14B 5; the flash-prefill
    tile holds 64 / g whole positions) and at head_dim 96 and 256; the
    tolerances of the tests above: the ring inserts bit-equal (and both in
    their fused launches), flash_decode 1e-5, flash_prefill 2^-8,
    flash_decode_q 1e-3 of each row's max."""
    gen = torch.Generator(device=dev).manual_seed(g if hd == 128 else hd + g)
    l, b, kh, s = 2, 2, 2, 544
    h = kh * g
    ck = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(torch.bfloat16)
    cv = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(torch.bfloat16)
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c, sn = (torch.from_numpy(a).to(dev) for a in A.rope_cos_sin_plus1(freqs))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    kn = torch.randn((b, kh, hd), device=dev, generator=gen)
    vn = torch.randn((b, kh, hd), device=dev, generator=gen)
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    build.reset_launches()
    A.kv_update(k1, v1, 1, kn, vn, i32(300, s), i32(1, 0), c, sn)
    A.kv_update_plain(k2, v2, 1, kn, vn, i32(300, s), i32(1, 0), c, sn)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    q = torch.randn((b, h, hd), device=dev, generator=gen)
    for kvl in ((0, 5), (129, 544), (1, 300)):
        got = _attend(q, k1, v1, 1, i32(*kvl))
        assert got.shape == (b, h * hd) and torch.isfinite(got).all()
        assert _row_rel(got, A.flash_decode_plain(q, k1, v1, 1, i32(*kvl)), hd) < 1e-5, kvl
    # the same update and attention in one launch
    f1, g1, f2, g2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    fused = (kn, vn, i32(300, s), i32(301, 544), i32(1, 0), c, sn)
    got = A.fused_decode_attention(q, f1, g1, 1, *fused)
    want = A.fused_decode_attention_plain(q, f2, g2, 1, *fused)
    assert torch.equal(f1, f2) and torch.equal(g1, g2)
    assert _row_rel(got, want, hd) < 1e-5
    for t, pos in ((64, (0, 100)), (40, (3, 0)), (512, (0, 0))):  # 40: a partial last tile
        qp = torch.randn((b, t, h, hd), device=dev, generator=gen)
        got = A.flash_prefill(qp, k1, v1, 0, i32(*pos))
        want = A.flash_prefill_plain(qp, k1, v1, 0, i32(*pos))
        assert torch.isfinite(got).all() and _row_rel(got, want, hd) <= 2.0 ** -8, (t, pos)
    planes = _int8_planes(dev, gen, l, b, kh, s, hd)
    p1, p2 = [t.clone() for t in planes], [t.clone() for t in planes]
    A.kv_update_q(*p1, 1, kn, vn, i32(77, s + 3), i32(0, 1), c, sn)
    A.kv_update_q_plain(*p2, 1, kn, vn, i32(77, s + 3), i32(0, 1), c, sn)
    assert all(torch.equal(x, y) for x, y in zip(p1, p2))
    for kvl in ((0, 5), (129, 544), (520, 300)):
        got = A.flash_decode_q(q, *p1, 1, i32(*kvl))
        assert _row_rel(got, A.flash_decode_q_plain(q, *p1, 1, i32(*kvl)), hd) < 1e-3, kvl
    # the same update and attention in one launch
    p1, p2 = [t.clone() for t in planes], [t.clone() for t in planes]
    fused = (kn, vn, i32(77, s + 3), i32(130, 544), i32(0, 1), c, sn)
    got = A.fused_decode_attention_q(q, *p1, 1, *fused)
    want = A.fused_decode_attention_q_plain(q, *p2, 1, *fused)
    assert all(torch.equal(x, y) for x, y in zip(p1, p2))
    assert _row_rel(got, want, hd) < 1e-3
    assert build.LAUNCHES["kv_update"] == build.LAUNCHES["kv_update_q"] == 1
    assert build.LAUNCHES["flash_decode"] == 4 and build.LAUNCHES["flash_prefill"] == 3
    assert build.LAUNCHES["flash_decode_q"] == 4


FOLD_CASES = [("bias", "bf16", "bf16", 1), ("bias", "bf16", "int8", 3), ("qk_norm", "bf16", "bf16", 3),
              ("qk_norm", "bf16", "int8", 1), ("bias", "a8", "bf16", 1), ("qk_norm", "a8", "int8", 3),
              ("bias", "q4", "int8", 1), ("qk_norm", "q4", "bf16", 3)]


@pytest.mark.parametrize("fold,body,cache,b", FOLD_CASES)
def test_fused_decode_family_folds_match_plain(dev, fold, body, cache, b):
    """The megakernel with the Qwen2 qkv bias or the Qwen3 q/k norms at GQA
    group 7 (14 heads, 2 KV heads), each body and cache, against its plain
    version through a ring wrap of a 48-slot window, each step from the
    plain version's caches; B = 1 with the embed and i8-head folds, B = 3
    with row 1 at the sentinel. Every step within 2e-2 of its max (the bf16
    body's bar above) and, for a8 and q4, 90 % of them within 1e-5 (the
    bar of test_fused_decode_a8_q4_match_plain)."""
    from xalm_tpu_torch.models.llama import rope_constants, rope_tables
    from xalm_tpu_torch.models.params import recode_params_q4, recode_wcls_i8
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **dict(FUSED_CFG, n_heads=14, n_kv_heads=2),
                              qk_norm=fold == "qk_norm", norm_eps=1e-6)
    params = synthetic_params(cfg, device=dev, seed=30 + b, qkv_bias=fold == "bias")
    assert (params.layers.bqkv is not None) == (fold == "bias")
    if body == "q4":
        params = recode_params_q4(params, 128)
    folds = b == 1
    if folds:
        params = recode_wcls_i8(params)
    s = cfg.max_seq_len
    freqs, c1, s1 = rope_constants(cfg, dev)
    dt = torch.int8 if cache == "int8" else torch.bfloat16
    kern, plain = KVCache.init(cfg, b, dt, dev), KVCache.init(cfg, b, dt, dev)
    planes = ("k", "v", "k_scale", "v_scale") if cache == "int8" else ("k", "v")
    rng = np.random.default_rng(b)
    start = np.array([0, 7, 20][:b])
    build.reset_launches()
    steps = s + 6
    rels = []
    for st in range(steps):
        for name in planes:
            getattr(kern, name).copy_(getattr(plain, name))
        pos = torch.from_numpy((start + st).astype(np.int32))
        _, kv_pos, kv_len = ring_indices(pos, s)
        rot = (pos >= s).to(torch.int32)
        if b == 3:
            kv_pos[1], rot[1] = s, 0
        tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=b))
        kw = dict(a8=body != "bf16")
        x0 = ce = se = None
        if folds:
            kw.update(wcls=params.wcls, out_norm=params.out_norm, embed=params.embed, token=tok,
                      pos=pos, freqs=freqs)
        else:
            x0 = params.embed.values[tok.to(dev)].float()
            ce, se = (z[:, 0, 0] for z in rope_tables(pos[:, None], freqs.cpu()))
        qkw = dict(k_scale=kern.k_scale, v_scale=kern.v_scale) if cache == "int8" else {}
        pkw = dict(k_scale=plain.k_scale, v_scale=plain.v_scale) if cache == "int8" else {}
        got = fd.fused_decode_step(params, cfg, x0, kern.k, kern.v, kv_pos, kv_len, rot, ce, se,
                                   c1, s1, **qkw, **kw)
        want = fd.fused_decode_step_plain(params, cfg, x0, plain.k, plain.v, kv_pos, kv_len, rot,
                                          ce, se, c1, s1, **pkw, **kw)
        torch.cuda.synchronize()
        outs = [(got[0], want[0], cfg.dim)] + ([(got[1], want[1], cfg.vocab_size)] if folds else [])
        for gv, wv, row in outs:
            assert torch.isfinite(gv).all()
            rels.append(_row_rel(gv, wv, row))
            assert rels[-1] <= 2e-2, (st, rels[-1])
        if folds:
            assert torch.equal(got[2], got[1].argmax(dim=-1).to(torch.int32))
    counter = {"bf16": "fused_decode", "a8": "fused_decode_a8", "q4": "fused_decode_q4"}[body]
    other = "fused_decode_qk_norm" if fold == "bias" else "fused_decode_bias"
    assert build.LAUNCHES[counter] == steps and build.LAUNCHES[f"fused_decode_{fold}"] == steps
    assert build.LAUNCHES[other] == 0
    if body != "bf16":
        assert np.mean(np.asarray(rels) <= 1e-5) >= 0.9, sorted(rels)[-5:]


def test_fused_decode_folds_move_the_output(dev):
    """The folds are applied in the kernel: dropping the bias (or the q/k
    norms) from the weights moves the kernel's x far past the 2e-2 bar."""
    from xalm_tpu_torch.models.llama import rope_constants
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **dict(FUSED_CFG, n_heads=14, n_kv_heads=2),
                              qk_norm=True)
    params = synthetic_params(cfg, device=dev, seed=5, qkv_bias=True)
    _, c1, s1 = rope_constants(cfg, dev)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    x0 = params.embed.values[torch.tensor([7], device=dev)].float()
    trig = torch.ones((1, 128)), torch.zeros((1, 128))
    outs = {}
    for name, drop in (("both", {}), ("no bias", dict(bqkv=None)),
                       ("no qk", dict(q_norm=None, k_norm=None))):
        p = dataclasses.replace(params, layers=dataclasses.replace(params.layers, **drop))
        cache = KVCache.init(cfg, 1, torch.bfloat16, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        cache.k.normal_(generator=gen)
        cache.v.normal_(generator=gen)
        outs[name] = fd.fused_decode_step(p, cfg, x0, cache.k, cache.v, i32(20), i32(21), i32(0),
                                          *trig, c1, s1)[0]
    for name in ("no bias", "no qk"):
        assert _row_rel(outs[name], outs["both"], cfg.dim) > 0.1, name


def test_engine_families_on_the_card(dev):
    """Qwen-shaped (GQA group 7) engines on the card, the bias and the q/k
    norms on: the megakernel and the per-layer kernels (flash-prefill at
    group 7, flash-decode and its int8 form) give the greedy tokens of the
    plain-version engine on the first steps, and each path's kernels ran."""
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **dict(FUSED_CFG, n_heads=14, n_kv_heads=2,
                                                 max_seq_len=256), qk_norm=True)
    params = synthetic_params(cfg, device=dev, seed=9, qkv_bias=True)
    prompt = list(range(3, 203))
    for kw, want_launch in ((dict(), "fused_decode_bias"),
                            (dict(fused_step=False), "flash_decode"),
                            (dict(fused_step=False, kv_dtype=torch.int8), "flash_decode_q")):
        eng = Engine(cfg, params, **kw)
        build.reset_launches()
        out, _ = eng.generate(prompt, 8, stop_on_eos=False)
        assert build.LAUNCHES[want_launch] > 0, (kw, build.LAUNCHES)
        if "kv_dtype" not in kw:
            assert build.LAUNCHES["flash_prefill"] == cfg.n_layers
        want, _ = Engine(cfg, params, matmul_impl="plain", **kw).generate(prompt, 8,
                                                                          stop_on_eos=False)
        assert out[:3] == want[:3], kw


# ---------------------------------------------------------------- Gemma, Gemma-2, Phi-3


def test_attention_kernels_refuse_other_head_dims(dev):
    """A head_dim the attention kernels are not built for raises on the card."""
    for hd in (64, 160):
        ck = torch.zeros((1, 1, 1, 64, hd), dtype=torch.bfloat16, device=dev)
        q = torch.zeros((1, 1, hd), device=dev)
        with pytest.raises(ValueError, match="fused_decode_attention"):
            _attend(q, ck, ck.clone(), 0, torch.ones(1, dtype=torch.int32, device=dev))
        with pytest.raises(ValueError, match="flash_prefill"):
            A.flash_prefill(q[:, None], ck, ck.clone(), 0,
                            torch.zeros(1, dtype=torch.int32, device=dev))


# Gemma-2-shaped (post-norms and both caps, q_dim 1024 != dim 256, GQA group
# 2) and Gemma-shaped (gelu and the embed scale, q_dim 512 != dim 384, group
# 1) models at head_dim 256, each with softcaps that bite on its weights; and
# Gemma-2 at head_dim 128 (as Gemma-2-27B), where the kernel has an
# instantiation without the Gemma folds' code beside the one with it
GEMMA_CFGS = {
    "gemma2": dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=256,
                   rotary_dim=256, vocab_size=320, max_seq_len=48, act="gelu",
                   embed_scale=16.0, attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
                   norm_eps=1e-6, tie_word_embeddings=True),
    "gemma2_hd128": dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                         head_dim=128, rotary_dim=128, vocab_size=320, max_seq_len=48,
                         act="gelu", embed_scale=16.0, attn_softcap=50.0, logit_softcap=30.0,
                         post_norms=True, norm_eps=1e-6, tie_word_embeddings=True),
    "gemma": dict(dim=384, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2, head_dim=256,
                  rotary_dim=256, vocab_size=320, max_seq_len=48, act="gelu",
                  embed_scale=384.0 ** 0.5, norm_eps=1e-6, tie_word_embeddings=True),
}


def _gemma_cfg(fam: str):
    from xalm_tpu_torch.utils.synthetic import biting_softcaps

    return biting_softcaps(dataclasses.replace(MISTRAL_7B, **GEMMA_CFGS[fam]))


GEMMA_FOLD_CASES = [("gemma2", "bf16", "bf16", 1), ("gemma2", "bf16", "int8", 3),
                    ("gemma2", "a8", "bf16", 3), ("gemma2", "q4", "int8", 1),
                    ("gemma", "bf16", "bf16", 3), ("gemma", "bf16", "int8", 1),
                    ("gemma", "a8", "int8", 1), ("gemma2_hd128", "bf16", "bf16", 1),
                    ("gemma2_hd128", "bf16", "int8", 3), ("gemma2_hd128", "q4", "bf16", 1)]


@pytest.mark.parametrize("fam,body,cache,b", GEMMA_FOLD_CASES)
def test_fused_decode_gemma_folds_match_plain(dev, fam, body, cache, b):
    """The megakernel at head_dim 256 (and 128) with Gemma-2's post-norms and
    softcaps or Gemma's gelu and embed scale, each body and cache, against its plain
    version through a ring wrap of a 48-slot window, each step from the
    plain version's caches (B = 1 with the embed and i8-head folds, B = 3
    with row 1 at the sentinel), with the bars of
    test_fused_decode_family_folds_match_plain."""
    from xalm_tpu_torch.models.llama import rope_constants, rope_tables
    from xalm_tpu_torch.models.params import recode_params_q4, recode_wcls_i8
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = _gemma_cfg(fam)
    params = synthetic_params(cfg, device=dev, seed=40 + b)
    assert (params.layers.post_attn_norm is not None) == fam.startswith("gemma2")
    if body == "q4":
        params = recode_params_q4(params, 128)
    folds = b == 1
    if folds:
        params = recode_wcls_i8(params)
    s = cfg.max_seq_len
    freqs, c1, s1 = rope_constants(cfg, dev)
    dt = torch.int8 if cache == "int8" else torch.bfloat16
    kern, plain = KVCache.init(cfg, b, dt, dev), KVCache.init(cfg, b, dt, dev)
    planes = ("k", "v", "k_scale", "v_scale") if cache == "int8" else ("k", "v")
    rng = np.random.default_rng(b)
    start = np.array([0, 7, 20][:b])
    build.reset_launches()
    steps = s + 6
    rels = []
    for st in range(steps):
        for name in planes:
            getattr(kern, name).copy_(getattr(plain, name))
        pos = torch.from_numpy((start + st).astype(np.int32))
        _, kv_pos, kv_len = ring_indices(pos, s)
        rot = (pos >= s).to(torch.int32)
        if b == 3:
            kv_pos[1], rot[1] = s, 0
        tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=b))
        kw = dict(a8=body != "bf16")
        x0 = ce = se = None
        if folds:
            kw.update(wcls=params.wcls, out_norm=params.out_norm, embed=params.embed, token=tok,
                      pos=pos, freqs=freqs)
        else:
            x0 = params.embed.values[tok.to(dev)].float() * cfg.embed_scale
            ce, se = (z[:, 0, 0] for z in rope_tables(pos[:, None], freqs.cpu()))
        qkw = dict(k_scale=kern.k_scale, v_scale=kern.v_scale) if cache == "int8" else {}
        pkw = dict(k_scale=plain.k_scale, v_scale=plain.v_scale) if cache == "int8" else {}
        got = fd.fused_decode_step(params, cfg, x0, kern.k, kern.v, kv_pos, kv_len, rot, ce, se,
                                   c1, s1, **qkw, **kw)
        want = fd.fused_decode_step_plain(params, cfg, x0, plain.k, plain.v, kv_pos, kv_len, rot,
                                          ce, se, c1, s1, **pkw, **kw)
        torch.cuda.synchronize()
        outs = [(got[0], want[0], cfg.dim)] + ([(got[1], want[1], cfg.vocab_size)] if folds else [])
        for gv, wv, row in outs:
            assert torch.isfinite(gv).all()
            rels.append(_row_rel(gv, wv, row))
            assert rels[-1] <= 2e-2, (st, rels[-1])
        if folds:
            assert torch.equal(got[2], got[1].argmax(dim=-1).to(torch.int32))
            if cfg.logit_softcap:
                assert float(got[1].abs().max()) <= cfg.logit_softcap
    counter = {"bf16": "fused_decode", "a8": "fused_decode_a8", "q4": "fused_decode_q4"}[body]
    assert build.LAUNCHES[counter] == build.LAUNCHES["fused_decode_gemma"] == steps
    assert build.LAUNCHES["fused_decode_gemma2"] == (steps if fam.startswith("gemma2") else 0)
    if body != "bf16":
        assert np.mean(np.asarray(rels) <= 1e-5) >= 0.9, sorted(rels)[-5:]


@pytest.mark.parametrize("fam", ["gemma2", "gemma2_hd128"])
def test_fused_decode_gemma_folds_move_the_output(dev, fam):
    """Each of the five folds is applied in the kernel, at head_dim 256 and
    128 (where one fold alone takes the kernel with the Gemma folds' code):
    dropping the post-norms, either softcap, gelu (for SiLU) or the embed
    scale moves the kernel's x (the logit cap: its logits) far past the 2e-2
    bar."""
    from xalm_tpu_torch.models.llama import rope_constants
    from xalm_tpu_torch.models.params import recode_wcls_i8
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = _gemma_cfg(fam)
    params = recode_wcls_i8(synthetic_params(cfg, device=dev, seed=6))
    # louder q and gate rows (std 0.9 and 0.75 rather than 0.19): scores of
    # std 0.9 against the cache's unit normals, so that capped and uncapped
    # attention differ, and gates where gelu and SiLU differ (at small gates
    # both are near g / 2 + c g^2, and the post-norm takes out the scale);
    # and an FFN output ten times the others, so that its activation shows
    params.layers.wqkv.scale.mul_(5.0)
    params.layers.w13.scale.mul_(4.0)
    params.layers.post_mlp_norm.mul_(10.0)
    freqs, c1, s1 = rope_constants(cfg, dev)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    outs = {}
    no_pn = dataclasses.replace(params, layers=dataclasses.replace(
        params.layers, post_attn_norm=None, post_mlp_norm=None))
    for name, c, p in (("all", cfg, params), ("no post-norms", cfg, no_pn),
                       ("no attn cap", dataclasses.replace(cfg, attn_softcap=0.0), params),
                       ("no logit cap", dataclasses.replace(cfg, logit_softcap=0.0), params),
                       ("silu", dataclasses.replace(cfg, act="silu"), params),
                       ("no embed scale", dataclasses.replace(cfg, embed_scale=1.0), params)):
        cache = KVCache.init(c, 1, torch.bfloat16, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        cache.k.normal_(generator=gen)
        cache.v.normal_(generator=gen)
        outs[name] = fd.fused_decode_step(
            p, c, None, cache.k, cache.v, i32(20), i32(21), i32(0), None, None, c1, s1,
            wcls=p.wcls, out_norm=p.out_norm, embed=p.embed, token=i32(7), pos=i32(20),
            freqs=freqs)
    for name in ("no post-norms", "no attn cap", "silu", "no embed scale"):
        assert _row_rel(outs[name][0], outs["all"][0], cfg.dim) > 0.1, name
    assert torch.equal(outs["no logit cap"][0], outs["all"][0])
    assert _row_rel(outs["no logit cap"][1], outs["all"][1], cfg.vocab_size) > 0.1


def test_phi3_head_dim_decodes_per_layer_on_the_card(dev):
    """head_dim 96 (Phi-3): the megakernel's gate refuses it on the card and
    the engine decodes per layer through kernels 2-4 at hd 96, with the
    greedy tokens of the plain-version engine; the megakernel wrapper itself
    raises on it. (Before, the gate let it through and the wrapper raised
    at the first decode step.)"""
    from xalm_tpu_torch.models.llama import rope_constants
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, dim=384, hidden_dim=512, n_layers=2, n_heads=4,
                              n_kv_heads=4, head_dim=96, rotary_dim=96, vocab_size=320,
                              max_seq_len=256)
    params = synthetic_params(cfg, device=dev, seed=12)
    eng = Engine(cfg, params)
    assert eng.decode_path(1) == "perlayer"
    assert not fd.fused_step_supported(cfg, params, eng.new_cache(1).k, 1, 1)
    prompt = list(range(3, 203))
    build.reset_launches()
    out, _ = eng.generate(prompt, 8, stop_on_eos=False)
    assert build.LAUNCHES["fused_decode"] == 0
    assert build.LAUNCHES["flash_prefill"] == cfg.n_layers
    # the ring update rides in flash_decode's launch
    assert build.LAUNCHES["flash_decode"] == 7 * cfg.n_layers and build.LAUNCHES["kv_update"] == 0
    want, _ = Engine(cfg, params, matmul_impl="plain").generate(prompt, 8, stop_on_eos=False)
    assert out[:3] == want[:3]
    cache = eng.new_cache(1)
    _, c1, s1 = rope_constants(cfg, dev)
    i = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim 96"):
        fd.fused_decode_step(params, cfg, torch.zeros((1, cfg.dim), device=dev), cache.k, cache.v,
                             i, i + 1, i, torch.ones((1, 96)), torch.zeros((1, 96)), c1, s1)


@pytest.mark.parametrize("fam", ["gemma2", "gemma"])
def test_engine_gemma_families_on_the_card(dev, fam):
    """Gemma-2 and Gemma-shaped engines on the card: the megakernel with the
    folds, and per layer (Gemma-2: the ring inserts by kernel 2 or 5, the
    capped attention dense, never flash-decode or flash-prefill; Gemma: the
    kernels at hd 256) give the greedy tokens of the plain-version engine
    on the first steps."""
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(_gemma_cfg(fam), max_seq_len=256)
    params = synthetic_params(cfg, device=dev, seed=14)
    prompt = list(range(3, 203))
    cap = fam == "gemma2"
    for kw in (dict(), dict(fused_step=False), dict(fused_step=False, kv_dtype=torch.int8)):
        eng = Engine(cfg, params, **kw)
        build.reset_launches()
        out, _ = eng.generate(prompt, 8, stop_on_eos=False)
        if not kw:
            assert build.LAUNCHES["fused_decode_gemma"] == 7
            assert build.LAUNCHES["fused_decode_gemma2"] == (7 if cap else 0)
        else:
            quant = "kv_dtype" in kw
            upd, dec = ("kv_update_q", "flash_decode_q") if quant else ("kv_update", "flash_decode")
            # one launch inserts and attends; kv_update(_q) runs only under the cap
            ins = 0 if not cap else 7 * cfg.n_layers
            assert build.LAUNCHES[upd] == ins, (kw, build.LAUNCHES)
            assert build.LAUNCHES[dec] == (0 if cap else 7 * cfg.n_layers), (kw, build.LAUNCHES)
            assert build.LAUNCHES["fused_decode"] == 0
        if "kv_dtype" not in kw:
            assert build.LAUNCHES["flash_prefill"] == (0 if cap else cfg.n_layers)
        want, _ = Engine(cfg, params, matmul_impl="plain", **kw).generate(prompt, 8,
                                                                          stop_on_eos=False)
        assert out[:3] == want[:3], kw


# ---- every weight format: q4 experts, f32 weights, the f16 and fp8 load modes


def _q4_stack(dev, g, le, d, n, group):
    """Random packed-q4 experts (LE, D, N/2) with (LE, D, N/group) scales."""
    w = torch.randint(-128, 128, (le, d, n // 2), dtype=torch.int8, device=dev, generator=g)
    return w, (torch.rand((le, d, n // group), device=dev, generator=g) * 0.01 + 1e-3)


def _multi_idxs(dev, k: int, le: int) -> torch.Tensor:
    """k expert indices into a stack of le (three: 11, 2, 7)."""
    idx = [11, 2, 7] if k == 3 else [(5 * i + 11) % le for i in range(k)]
    return torch.tensor(idx, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("group", [128, 512])
@pytest.mark.parametrize("m,shared,n,k", [(1, True, 4096, 3), (1, False, 14336, 3),
                                          (3, True, 2048, 3), (10, False, 2048, 3),
                                          (20, True, 1024, 3), (1, True, 24576, 2),
                                          (8, False, 24576, 2), (1, True, 3072, 3),
                                          (8, False, 18944, 2), (1, False, 2048, 16)])
def test_qmatmul_multi_q4_bit_equal_to_plain(dev, group, m, shared, n, k):
    """The gathered q4 expert matmul against its plain version, bit-equal:
    Mixtral's w13 (x shared, 4096 wide) and w2 (one row per expert, 14336
    wide) shapes, m past 8 (row groups), Gemma-7B's w2 width (24576: 8 rows
    of x a launch do not fit), 24-byte scale rows (3072 at g512), Qwen2.5's
    w2 width at m = 8, and 16 experts of one row each."""
    if n % (2 * group):
        pytest.skip("the group does not divide N/2")
    g = torch.Generator(device=dev).manual_seed(m + n + group)
    le, d = 12, 1000
    w, scale = _q4_stack(dev, g, le, d, n, group)
    idxs = _multi_idxs(dev, k, le)
    x = torch.randn((m if shared else k * m, n), device=dev, generator=g) * 3
    build.reset_launches()
    got = qmatmul_multi(x, w, scale, idxs, shared_x=shared, q4_group=group)
    assert build.LAUNCHES["qmatmul_multi_q4"] == 1 and build.LAUNCHES["qmatmul_multi"] == 0
    want = qmatmul_multi_plain(x, w, scale, idxs, shared_x=shared, q4_group=group)
    assert got.shape == want.shape == (k * m, d)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,shared", [(1, True), (8, False), (3, True)])
def test_qmatmul_multi_q4_index_outside_the_stack_gives_nan_rows(dev, m, shared):
    """An expert index past the stack (or negative) makes that expert's rows
    NaN and leaves the others' bit-equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(m)
    le, d, n, group = 4, 700, 3072, 512
    w, scale = _q4_stack(dev, g, le, d, n, group)
    x = torch.randn((m if shared else 3 * m, n), device=dev, generator=g)
    idxs = torch.tensor([le, 2, -1], dtype=torch.int32, device=dev)
    got = qmatmul_multi(x, w, scale, idxs, shared_x=shared, q4_group=group)
    assert torch.isnan(got[:m]).all() and torch.isnan(got[2 * m:]).all()
    two = torch.tensor([2], dtype=torch.int32, device=dev)
    xe = x if shared else x[m:2 * m]
    assert torch.equal(got[m:2 * m],
                       qmatmul_multi_plain(xe, w, scale, two, shared_x=True, q4_group=group))


def test_qmatmul_multi_q4_64bit_offsets(dev):
    """An expert whose packed rows start past 2^31 bytes into the stack, and
    an index outside the stack (NaN rows, never a stray read)."""
    le, d, n, group = 18, 16384, 16384, 128  # 128 MiB of codes an expert, 2.25 GiB in all
    if torch.cuda.mem_get_info(dev)[0] < 6 * 2**30:
        pytest.skip("needs 6 GiB of free device memory")
    g = torch.Generator(device=dev).manual_seed(10)
    w, scale = _q4_stack(dev, g, le, d, n, group)
    assert 17 * d * n // 2 >= 2**31
    x = torch.randn((1, n), device=dev, generator=g)
    idxs = torch.tensor([17, 0], dtype=torch.int32, device=dev)
    got = qmatmul_multi(x, w, scale, idxs, q4_group=group)
    assert torch.equal(got, qmatmul_multi_plain(x, w, scale, idxs, q4_group=group))
    bad = qmatmul_multi(x, w, scale, torch.tensor([le, 1], dtype=torch.int32, device=dev),
                        q4_group=group)
    one = torch.tensor([1], dtype=torch.int32, device=dev)
    assert torch.isnan(bad[0]).all()
    assert torch.equal(bad[1:], qmatmul_multi_plain(x, w, scale, one, q4_group=group))


# (M, N, D): the GEMV (M <= 8 where x fits its shared memory) and the
# tiled GEMM (M = 4 at N = 14336, where it does not; M from 9, the least the
# forward sends it, to 512), D tails of the 128-row weight tile, N a
# multiple of 4 but not of the 32-deep stage
F32_MM_SHAPES = [(1, 1024, 1000), (4, 1024, 1000), (8, 4096, 1000), (1, 14336, 1000),
                 (4, 14336, 1000), (100, 1024, 1000), (512, 2048, 1000), (9, 4096, 1000),
                 (100, 1028, 1001), (512, 4096, 4096), (512, 2052, 130), (200, 14336, 257)]


@pytest.mark.parametrize("m,n,d", F32_MM_SHAPES)
def test_qmatmul_f32_matches_plain(dev, m, n, d):
    """Kernel 1's f32 branch against its plain version (f32 products, no
    bf16 rounding, TF32 off), within 1e-5 of each output row's max. M = 1 at
    N = 14336 stages 57 KB of x (past the 48 KB opt-in) for the f32 GEMV;
    M = 4 at 14336 and M >= 9 take the tiled GEMM, three TF32 products a
    step on the tensor cores (split TF32: within about 2^-18 of each f32
    product, against the 1e-5 of the row's max that f32 sums in another
    order are held to), at ragged M (zero-filled rows past M), D that no
    weight tile divides and N that ends in part of a stage (zeros past
    N)."""
    g = torch.Generator(device=dev).manual_seed(m + n + d)
    l = 2
    w = torch.randn((l, d, n), device=dev, generator=g) * 0.02
    x = torch.randn((m, n), device=dev, generator=g)
    nw = torch.rand((l, n), device=dev, generator=g) + 0.5
    for extra in ({}, dict(norm_w=nw, norm_eps=1e-5)):
        build.reset_launches()
        got = qmatmul(x, w, 1, **extra)
        assert build.LAUNCHES["qmatmul_f32"] == 1 and build.LAUNCHES["qmatmul"] == 0
        assert torch.isfinite(got).all()
        assert _row_rel(got, qmatmul_plain(x, w, 1, **extra), d) <= 1e-5, extra.keys()


@pytest.mark.parametrize("m,shared,n", [(1, True, 4096), (1, False, 14336), (4, True, 1040)])
def test_qmatmul_multi_f32_matches_plain(dev, m, shared, n):
    """Kernel 8's f32 branch (x staged as f32) within 1e-5 of each output
    row's max."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    w = torch.randn((12, 500, n), device=dev, generator=g) * 0.02
    idxs = torch.tensor([11, 2, 7], dtype=torch.int32, device=dev)
    x = torch.randn((m if shared else 3 * m, n), device=dev, generator=g)
    build.reset_launches()
    got = qmatmul_multi(x, w, None, idxs, shared_x=shared)
    assert build.LAUNCHES["qmatmul_multi_f32"] == 1 and build.LAUNCHES["qmatmul_multi"] == 0
    assert _row_rel(got, qmatmul_multi_plain(x, w, None, idxs, shared_x=shared), 500) <= 1e-5


def test_engine_moe_q4_on_the_card(dev):
    """A small Mixtral with packed-q4 experts (drawn packed), kernels against
    plain versions, each kernel step from the plain run's cache: under
    ``a8_decode`` one qmatmul_multi_q4 launch per matmul (2 a layer and
    token) and every step's logits within 5e-2 of their max (int8
    activations: a code a count apart moves a step,
    ``test_fused_decode_a8_q4_match_plain``'s bar); without it the
    dense-masked experts and no gathered launch."""
    from xalm_tpu_torch.models.config import MIXTRAL_8X7B
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MIXTRAL_8X7B, dim=512, hidden_dim=1024, n_layers=2,
                              vocab_size=512, max_seq_len=64)
    params = synthetic_params(cfg, device=dev, seed=7, q4_group=128)
    prompt = list(range(3, 40))
    ek = Engine(cfg, params, matmul_impl="kernel", a8_decode=True)
    ep = Engine(cfg, params, matmul_impl="plain", a8_decode=True)
    assert ek.decode_path(1) == "perlayer"
    lp, cp, pos = ep.prefill(prompt, ep.new_cache(1))
    ck = ek.new_cache(1)
    build.reset_launches()
    for _ in range(16):
        tok = np.array([int(lp.argmax())])
        ck.k.copy_(cp.k)
        ck.v.copy_(cp.v)
        lk, ck = ek.decode(tok, np.array([pos], np.int32), ck)
        lp, cp = ep.decode(tok, np.array([pos], np.int32), cp)
        assert torch.isfinite(lk).all()
        assert float((lk - lp).abs().max()) <= 5e-2 * float(lp.abs().max()), pos
        pos += 1
    assert build.LAUNCHES["qmatmul_multi_q4"] == 16 * 2 * 2
    assert build.LAUNCHES["qmatmul_q4"] == 16 * 2 * 2  # wqkv and wo
    e0 = Engine(cfg, params, matmul_impl="kernel")
    assert e0.decode_path(1) == "xla"
    build.reset_launches()
    lg, _ = e0.decode(np.array([5]), np.array([0], np.int32), e0.new_cache(1))
    assert torch.isfinite(lg).all() and build.LAUNCHES["qmatmul_multi_q4"] == 0


def test_engine_f32_body_on_the_card(dev):
    """An f32 body and head (``synthetic_params(weight_dtype=, embed_dtype=)``)
    on kernel 1's f32 branch, per layer (the megakernel needs an i8 body),
    against the plain path through a ring wrap, teacher-forced: each step's
    logits within 2e-2 of their max, the bar of
    ``test_engine_kernels_match_plain_through_wraps`` (the matmuls agree to
    f32 rounding, but the cache is bf16: a K or V value an f32 ulp apart can
    round the other way and stays in the ring)."""
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    params = synthetic_params(cfg, device=dev, seed=8, weight_dtype=torch.float32,
                              embed_dtype=torch.float32)
    ek, ep = Engine(cfg, params), Engine(cfg, params, matmul_impl="plain")
    assert ek.decode_path(1) == "perlayer"
    prompt = list(range(3, 30))
    build.reset_launches()
    lk, ck, pos = ek.prefill(prompt, ek.new_cache(1))
    assert build.LAUNCHES["qmatmul_f32"] == 4 * cfg.n_layers + 1
    assert build.LAUNCHES["qmatmul"] == 0
    lp, cp, _ = ep.prefill(prompt, ep.new_cache(1))
    for _ in range(cfg.max_seq_len):
        assert float((lk - lp).abs().max()) <= 2e-2 * float(lp.abs().max()), pos
        tok = np.array([int(lp.argmax())])
        lk, ck = ek.decode(tok, np.array([pos], np.int32), ck)
        lp, cp = ep.decode(tok, np.array([pos], np.int32), cp)
        pos += 1


@pytest.mark.parametrize("kind", ["f16", "f8_e4m3"])
def test_engine_f16_and_fp8_containers_on_the_card(dev, tmp_path, kind):
    """Containers the port writes in f16 and f8_e4m3, loaded with
    ``Engine.from_xalm`` on the card ("auto" modes): the f16 body loads as
    bf16 and runs kernel 1's bf16 branch per layer, the fp8 body as i8 rows
    and runs the i8 megakernel. Prefill logits against the plain path on the
    same loaded params within 2e-2 of their max (the bar of
    ``test_engine_kernels_match_plain_through_wraps``: an activation rounded
    to bf16 the other way moves by 2^-8)."""
    from xalm_tpu_torch.runtime.engine import Engine

    path = write_port_container(str(tmp_path / f"{kind}.xalm"), seed=3, kind=kind)
    ek = Engine.from_xalm(path, device="cuda")
    body = ek.params.layers.w13
    if kind == "f16":
        assert body.values.dtype == torch.bfloat16 and body.scale is None
        assert ek.params.wcls.values.dtype == torch.bfloat16
        assert ek.decode_path(1) == "perlayer"
    else:
        assert body.values.dtype == torch.int8 and body.scale is not None
        assert ek.decode_path(1) == "megakernel"
    ep = Engine(ek.cfg, ek.params, ek.tokenizer, matmul_impl="plain")
    build.reset_launches()
    out, _ = ek.generate([3, 4, 5, 6], 12, stop_on_eos=False)
    if kind == "f16":
        assert build.LAUNCHES["qmatmul"] > 0 and build.LAUNCHES["fused_decode"] == 0
    else:
        assert build.LAUNCHES["fused_decode"] == 11
    assert len(out) == 12
    lk, _, _ = ek.prefill([3, 4, 5, 6, 7], ek.new_cache(1))
    lp, _, _ = ep.prefill([3, 4, 5, 6, 7], ep.new_cache(1))
    assert float((lk - lp).abs().max()) <= 2e-2 * float(lp.abs().max())


def test_f32_cache_decodes_on_the_megakernel(dev):
    """An f32 cache with an i8 body on the card: the megakernel's gate takes
    it (``csrc/fused_decode_f32.cu``), ``forward(fused_step="auto")`` launches
    it, counted under ``fused_decode_f32`` beside the body's counter, and
    the engine decodes on it through a ring wrap within 2e-2 of the plain
    path's logits (``_forced_close``); the K and V rows land unrounded."""
    from xalm_tpu_torch.models.llama import forward
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    params = synthetic_params(cfg, device=dev, seed=2)
    cache = KVCache.init(cfg, 1, torch.float32, dev)
    assert fd.fused_step_supported(cfg, params, cache.k, 1, 1)
    build.reset_launches()
    logits, _ = forward(params, cfg, torch.tensor([[5]]), torch.tensor([3], dtype=torch.int32),
                        cache, fused_step="auto")
    assert build.LAUNCHES["fused_decode"] == build.LAUNCHES["fused_decode_f32"] == 1
    assert torch.isfinite(logits).all()
    row = cache.k[:, 0, :, 3]
    assert bool((row != 0).any()) and not torch.equal(row, row.to(torch.bfloat16).float())
    ek = Engine(cfg, params, kv_dtype=torch.float32)
    ep = Engine(cfg, params, kv_dtype=torch.float32, matmul_impl="plain")
    assert ek.decode_path(1) == "megakernel"
    build.reset_launches()
    _forced_close(ek, ep, [3, 4, 5, 6], 2 * cfg.max_seq_len)
    assert build.LAUNCHES["fused_decode_f32"] == 2 * cfg.max_seq_len


# ---- the f32 and f16 caches; fp8 weights

F32_ATTENTION_SHAPES = [(4, 128), (7, 128), (8, 128), (1, 256), (2, 256), (1, 96), (3, 96)]


@pytest.mark.parametrize("g,hd", F32_ATTENTION_SHAPES,
                         ids=[f"hd{hd}-g{g}" for g, hd in F32_ATTENTION_SHAPES])
def test_attention_kernels_f32_match_plain(dev, g, hd):
    """Kernels 2-4 over an f32 cache (their f32 instantiations) against the
    plain versions: the ring insert and sink rotation bit-equal (each
    product and the sum rounded as the plain version's f32 operations, the
    rows stored unrounded); flash-decode and flash-prefill within 1e-5 of
    each row's max (f32 values throughout, the sums in another order; the
    prefill's two products in split TF32 on the tensor cores, three TF32
    products a step, against the plain version's f32 matmul with TF32 off;
    its key tiles 32 rows at hd 256 where the plain version's are 64): the
    prefill at pos 0, at positions whose keys reach the end of the window
    (the last key tile reads zeros past S) and at T that no block's rows
    divide. Counted under the ``_f32`` counters only."""
    gen = torch.Generator(device=dev).manual_seed(hd + g)
    l, b, kh, s = 2, 2, 2, 544
    h = kh * g
    ck = torch.randn((l, b, kh, s, hd), device=dev, generator=gen)
    cv = torch.randn((l, b, kh, s, hd), device=dev, generator=gen)
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c, sn = (torch.from_numpy(a).to(dev) for a in A.rope_cos_sin_plus1(freqs))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    kn = torch.randn((b, kh, hd), device=dev, generator=gen)
    vn = torch.randn((b, kh, hd), device=dev, generator=gen)
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    build.reset_launches()
    A.kv_update(k1, v1, 1, kn, vn, i32(300, s), i32(1, 0), c, sn)
    A.kv_update_plain(k2, v2, 1, kn, vn, i32(300, s), i32(1, 0), c, sn)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert torch.equal(k1[1, 0, :, 300], kn[0])  # stored as it is
    q = torch.randn((b, h, hd), device=dev, generator=gen)
    for kvl in ((0, 5), (129, 544), (1, 300)):
        got = _attend(q, k1, v1, 1, i32(*kvl))
        assert got.shape == (b, h * hd) and torch.isfinite(got).all()
        assert _row_rel(got, A.flash_decode_plain(q, k1, v1, 1, i32(*kvl)), hd) < 1e-5, kvl
    cases = ((64, (0, 100)), (40, (3, 0)), (512, (0, 0)), (333, (s - 333, 0)), (77, (5, s - 77)))
    for t, pos in cases:  # 40, 333, 77: a partial last block of rows
        qp = torch.randn((b, t, h, hd), device=dev, generator=gen)
        got = A.flash_prefill(qp, k1, v1, 0, i32(*pos))
        want = A.flash_prefill_plain(qp, k1, v1, 0, i32(*pos))
        assert torch.isfinite(got).all() and _row_rel(got, want, hd) <= 1e-5, (t, pos)
    assert build.LAUNCHES["kv_update_f32"] == 1 and build.LAUNCHES["flash_decode_f32"] == 3
    assert build.LAUNCHES["flash_prefill_f32"] == len(cases)
    assert build.LAUNCHES["kv_update"] == build.LAUNCHES["flash_decode"] == 0
    assert build.LAUNCHES["flash_prefill"] == 0


F32_MK_CASES = [("mistral", "bf16", 1), ("mistral", "bf16", 3), ("mistral", "a8", 1),
                ("mistral", "q4", 3), ("gemma2", "bf16", 1), ("gemma2_hd128", "a8", 3),
                ("gemma2", "q4", 1), ("gemma", "a8", 1)]


@pytest.mark.parametrize("fam,body,b", F32_MK_CASES)
def test_fused_decode_f32_cache_matches_plain(dev, fam, body, b):
    """The megakernel's f32-cache instantiations (every body; head_dim 128
    with and without the Gemma folds' code, 256 with it) against the plain
    version through a ring wrap of a 48-slot window, each step from the
    plain version's cache (B = 1 with the embed and i8-head folds, B = 3
    with row 1 at the sentinel): each step's x and logits within 2e-2 of
    their max (5e-2 for a8 and q4: an int8 code a count apart), and for a8
    and q4 90 % of the steps within 1e-5, the bars of the bf16- and
    int8-cache tests above; every cache row within 2e-2 of its max."""
    from xalm_tpu_torch.models.llama import rope_constants, rope_tables
    from xalm_tpu_torch.models.params import recode_params_q4, recode_wcls_i8
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = (dataclasses.replace(MISTRAL_7B, **FUSED_CFG) if fam == "mistral"
           else _gemma_cfg(fam))
    params = synthetic_params(cfg, device=dev, seed=60 + b)
    if body == "q4":
        params = recode_params_q4(params, 128)
    folds = b == 1
    if folds:
        params = recode_wcls_i8(params)
    s = cfg.max_seq_len
    freqs, c1, s1 = rope_constants(cfg, dev)
    kern, plain = KVCache.init(cfg, b, torch.float32, dev), KVCache.init(cfg, b, torch.float32, dev)
    rng = np.random.default_rng(b)
    start = np.array([0, 7, 20][:b])
    build.reset_launches()
    steps = s + 6
    rels = []
    tol = 2e-2 if body == "bf16" else 5e-2
    for st in range(steps):
        kern.k.copy_(plain.k)
        kern.v.copy_(plain.v)
        pos = torch.from_numpy((start + st).astype(np.int32))
        _, kv_pos, kv_len = ring_indices(pos, s)
        rot = (pos >= s).to(torch.int32)
        if b == 3:
            kv_pos[1], rot[1] = s, 0
        tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=b))
        kw = dict(a8=body != "bf16")
        x0 = ce = se = None
        if folds:
            kw.update(wcls=params.wcls, out_norm=params.out_norm, embed=params.embed, token=tok,
                      pos=pos, freqs=freqs)
        else:
            x0 = params.embed.values[tok.to(dev)].float() * cfg.embed_scale
            ce, se = (z[:, 0, 0] for z in rope_tables(pos[:, None], freqs.cpu()))
        got = fd.fused_decode_step(params, cfg, x0, kern.k, kern.v, kv_pos, kv_len, rot, ce, se,
                                   c1, s1, **kw)
        want = fd.fused_decode_step_plain(params, cfg, x0, plain.k, plain.v, kv_pos, kv_len, rot,
                                          ce, se, c1, s1, **kw)
        torch.cuda.synchronize()
        outs = [(got[0], want[0], cfg.dim)] + ([(got[1], want[1], cfg.vocab_size)] if folds else [])
        for gv, wv, row in outs:
            assert torch.isfinite(gv).all()
            rels.append(_row_rel(gv, wv, row))
            assert rels[-1] <= tol, (st, rels[-1])
        if folds:
            assert torch.equal(got[2], got[1].argmax(dim=-1).to(torch.int32))
        for gc, wc in ((kern.k, plain.k), (kern.v, plain.v)):
            assert _row_rel(gc, wc, cfg.head_dim) <= 2e-2, st
    counter = {"bf16": "fused_decode", "a8": "fused_decode_a8", "q4": "fused_decode_q4"}[body]
    assert build.LAUNCHES[counter] == build.LAUNCHES["fused_decode_f32"] == steps
    if body != "bf16":
        assert np.mean(np.asarray(rels) <= 1e-5) >= 0.9, sorted(rels)[-5:]


FP8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


@pytest.mark.parametrize("m", [1, 4, 8, 100])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_qmatmul_fp8_matches_plain(dev, fmt, m):
    """Kernel 1's fp8 branch (the GEMV at M <= 8, the tiled GEMM above) with
    and without the norm prologue, at the tolerances of the bf16 weights:
    every code widens exactly on both sides, so the exact products differ
    only in the order of their f32 sums (1e-4 of each row's max; 1e-3 with
    the prologue, whose rms order can flip an activation's bf16 rounding).
    Every finite code of the format is in the weights."""
    g = torch.Generator(device=dev).manual_seed(m)
    l, d, n = 2, 1000, 1024
    codes = torch.randint(0, 256, (l, d, n), dtype=torch.uint8, device=dev, generator=g)
    codes[0, 0, :256] = torch.arange(256, dtype=torch.uint8, device=dev)
    w = codes.view(FP8[fmt])
    finite = torch.isfinite(w.float())
    codes.masked_fill_(~finite, 0)  # no NaN or Inf code (weights are finite)
    x = torch.randn((m, n), device=dev, generator=g)
    nw = torch.rand((l, n), device=dev, generator=g) + 0.5
    build.reset_launches()
    for layer in range(l):
        for extra, tol in (({}, 1e-4), (dict(norm_w=nw, norm_eps=1e-5), 1e-3)):
            got = qmatmul(x, w, layer, **extra)
            want = qmatmul_plain(x, w, layer, **extra)
            assert torch.isfinite(got).all() and _row_rel(got, want, d) <= tol, (layer, extra)
    assert build.LAUNCHES["qmatmul_fp8"] == 2 * l and build.LAUNCHES["qmatmul"] == 0


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_qmatmul_multi_fp8_matches_plain(dev, fmt):
    """Kernel 8 shares kernel 1's GEMV core, so it takes fp8 experts too
    (no forward gathers them: the JAX gate sends fp8 experts dense): x
    shared and per expert, 1e-4 of each row's max."""
    g = torch.Generator(device=dev).manual_seed(5)
    le, d, n = 6, 520, 1040
    codes = torch.randint(0, 256, (le, d, n), dtype=torch.uint8, device=dev, generator=g)
    w = codes.view(FP8[fmt])
    codes.masked_fill_(~torch.isfinite(w.float()), 0)
    idxs = torch.tensor([4, 1], dtype=torch.int32, device=dev)
    build.reset_launches()
    for x, shared in ((torch.randn((1, n), device=dev, generator=g), True),
                      (torch.randn((2, n), device=dev, generator=g), False)):
        got = qmatmul_multi(x, w, None, idxs, shared_x=shared)
        want = qmatmul_multi_plain(x, w, None, idxs, shared_x=shared)
        assert _row_rel(got, want, d) <= 1e-4
    assert build.LAUNCHES["qmatmul_multi_fp8"] == 2


# ------------------------------------------------ the TMA + wgmma redesigns (W8A8, flash prefill)

# (K, D): Qwen2.5-7B's wqkv (4608 rows: no multiple of 256) at K 4096,
# Mistral's w2 (K 14336) and w13 (28672 rows: the 128 x 256 tiles at M >
# 256), and an odd D with a K that ends in half a 128-byte stage
A8_SHAPES = [(4096, 4608), (14336, 4096), (4096, 28672), (4160, 1001)]


@pytest.mark.parametrize("kind", ["i8", "q8"])
@pytest.mark.parametrize("m", [1, 64, 257, 300, 512])
@pytest.mark.parametrize("k,d", A8_SHAPES, ids=[f"k{k}-d{d}" for k, d in A8_SHAPES])
def test_qmatmul_a8_tiles_bit_equal_to_plain(dev, kind, m, k, d):
    """The W8A8 GEMM bit-equal to its plain version at ragged M (zero-filled
    rows past M), D that no tile divides, both tile widths (``a8_plan``) and
    a K that is a multiple of 64 but not of the 128-byte stage; one launch a
    call."""
    from xalm_tpu_torch.ops.qmatmul import a8_plan

    plan = a8_plan(m, k, d, torch.cuda.get_device_properties(dev).multi_processor_count)
    g = torch.Generator(device=dev).manual_seed(m + k + d)
    w = torch.randint(-127, 128, (2, d, k), dtype=torch.int8, device=dev, generator=g)
    kw = dict(scale=torch.rand((2, d), device=dev, generator=g) * 0.01) if kind == "i8" else \
        dict(q8_scale=0.01)
    x = torch.randn((m, k), device=dev, generator=g) * 2
    build.reset_launches()
    got = qmatmul(x, w, 1, a8=True, **kw)
    assert build.LAUNCHES["qmatmul_a8"] == 1, plan
    assert torch.equal(got, qmatmul_plain(x, w, 1, a8=True, **kw)), plan


PLAN_FAMILIES = ("MISTRAL_7B", "MIXTRAL_8X7B", "QWEN2_5_7B", "QWEN3_8B", "LLAMA3_1_8B", "GEMMA2_9B",
                 "GEMMA_7B", "PHI3_MINI_4K")


@pytest.mark.parametrize("family", PLAN_FAMILIES)
def test_launch_plans_match_the_launchers(dev, family):
    """``ops.qmatmul.a8_plan`` (at the device's SM count) and
    ``ops.attention.prefill_plan`` (over a bf16 and an f32 cache), which
    tests/test_torch_plans.py checks on the CPU at every family's shapes,
    equal to what the launchers of ``xq_qmatmul_a8`` and
    ``xq_flash_prefill`` launch, as their query entries report it: every
    forward (M, K, D) at M 1, 256, 300 and 512, every prefill chunk bucket
    and a ragged one; both refuse K off the 64 granule and a GQA group
    above 8."""
    import ctypes

    from xalm_tpu_torch.models import config as C
    from xalm_tpu_torch.ops.qmatmul import a8_plan

    cfg = getattr(C, family)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qlib, alib = build.load_library("qmatmul"), build.load_library("attention")
    shapes = [(cfg.dim, cfg.q_dim + 2 * cfg.kv_dim), (cfg.q_dim, cfg.dim),
              (cfg.dim, 2 * cfg.hidden_dim), (cfg.hidden_dim, cfg.dim)]
    for k, d in shapes + [(4160, 1001)]:
        for m in (1, 256, 300, 512):
            got = (ctypes.c_int * 3)()
            assert qlib.xq_qmatmul_a8_plan(m, k, d, got) == 0, (m, k, d)
            assert tuple(got) == a8_plan(m, k, d, sms), (m, k, d)
    assert qlib.xq_qmatmul_a8_plan(256, 4128, 4096, (ctypes.c_int * 3)()) != 0
    h, kh = cfg.n_heads, cfg.n_kv_heads
    for t in (1, 16, 32, 64, 128, 256, 333, 512):
        for f32 in (0, 1):
            tq, q0s = ctypes.c_int(), (ctypes.c_int * 512)()
            assert alib.xq_flash_prefill_plan(t, h, kh, cfg.head_dim, f32, ctypes.byref(tq), q0s,
                                              512) == 0
            want_tq, want_order = A.prefill_plan(t, h // kh, cfg.head_dim, f32=bool(f32))
            assert tq.value == want_tq and list(q0s[:len(want_order)]) == want_order, (t, f32)
    assert alib.xq_flash_prefill_plan(512, 9, 1, 128, 0, ctypes.byref(tq), q0s, 512) != 0
    # the tiled GEMM of int8, bf16 and fp8 weights (ops.qmatmul.gemm_plan), at every prefill
    # bucket, a ragged M and M 1 to 8 (where x is too wide for the GEMV)
    from xalm_tpu_torch.ops.qmatmul import gemm_plan

    for k, d in shapes + [(4128, 1001), (32 * 33, 1000)]:
        for kind, dt in ((0, torch.int8), (1, torch.bfloat16), (3, torch.float8_e4m3fn)):
            for m in (1, 8, 9, 16, 32, 64, 128, 256, 300, 512, 513, 2048):
                got = (ctypes.c_int * 7)()
                assert qlib.xq_gemm_plan(m, k, d, kind, got) == 0, (m, k, d, kind)
                assert tuple(got) == gemm_plan(m, k, d, dt, sms), (m, k, d, kind)
    assert qlib.xq_gemm_plan(16, 4112, 4096, 0, (ctypes.c_int * 7)()) != 0
    assert qlib.xq_gemm_plan(16, 4096, 4096, 2, (ctypes.c_int * 7)()) != 0  # f32: split TF32


@pytest.mark.parametrize("hd", [96, 128, 256])
@pytest.mark.parametrize("g", range(1, 9))
def test_flash_prefill_matches_plain_at_every_group(dev, g, hd):
    """The flash prefill within 2^-8 of each row's max of its plain version
    for every GQA group and head_dim: B = 2 with another position in each
    row (0 and 100, 1024 and the last chunk that fits the window, S - T),
    T = 512 and a T that no query tile divides; one launch a call."""
    gen = torch.Generator(device=dev).manual_seed(10 * g + hd)
    l, b, kh, s = 2, 2, 2, 2048
    h = kh * g
    ck = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(torch.bfloat16)
    cv = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(torch.bfloat16)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    build.reset_launches()
    cases = ((512, (0, 100)), (512, (1024, s - 512)), (333, (s - 333, 7)))
    for t, pos in cases:
        q = torch.randn((b, t, h, hd), device=dev, generator=gen)
        got = A.flash_prefill(q, ck, cv, 1, i32(*pos))
        want = A.flash_prefill_plain(q, ck, cv, 1, i32(*pos))
        assert got.shape == (b, t, h * hd) and torch.isfinite(got).all()
        assert _row_rel(got, want, hd) <= 2.0 ** -8, (t, pos)
    assert build.LAUNCHES["flash_prefill"] == len(cases)


# ------------------------------------------------ split TF32 (the f32 GEMM, the f32-cache prefill)


def _tf32_read(x: np.ndarray, mode: str) -> np.ndarray:
    """f32 values as a tensor core would read them as TF32: the low 13
    mantissa bits dropped ("trunc") or rounded to nearest, ties away
    ("rna")."""
    u = x.astype(np.float32).view(np.uint32)
    if mode == "rna":
        u = u + np.uint32(0x1000)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def test_tensor_cores_read_tf32_by_truncation(dev):
    """One tf32 wgmma (both operands from shared memory, as the f32 GEMM
    issues it) and one tf32 mma.sync (registers, as the f32-cache prefill
    issues it) on chosen raw f32 bit patterns: each reads an operand's low
    13 mantissa bits as zero (truncation toward zero), so a raw f32 value,
    in registers or in a landed tile, is its own big part and only
    ``x - trunc(x)`` is computed (``hopper.cuh``'s ``xq_tf32_split``). The
    patterns tell truncation from rounding: the
    expected values under the two readings differ, and the products and
    sums are exact in f32 under either."""
    j = np.arange(64)
    a = np.zeros((64, 8), np.float32)
    a[:, 0] = 1 + j * 2.0 ** -16  # low bits 0..63 x 2^-16: below TF32's 2^-10
    a[:, 1] = 1
    a[:, 2] = -(1 + (63 - j) * 2.0 ** -16)  # negative: toward zero, not down
    a[:, 4] = 1 + (5 * j % 64) * 2.0 ** -16
    n = np.arange(128)
    b = np.zeros((128, 8), np.float32)
    b[:, 0] = 1
    b[:, 1] = 1 + (9 * n % 64) * 2.0 ** -16
    b[:, 2] = 1
    b[:, 4] = 1 + ((3 * n + 1) % 64) * 2.0 ** -16

    def expect(mode):
        return (_tf32_read(a, mode).astype(np.float64) @ _tf32_read(b, mode).astype(np.float64).T
                ).astype(np.float32)

    assert not np.array_equal(expect("trunc"), expect("rna"))
    lib = build.load_library("qmatmul")
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    d = torch.empty((64, 128), device=dev)
    dm = torch.empty((16, 8), device=dev)
    build.check(lib.xq_tf32_probe(at.data_ptr(), bt.data_ptr(), d.data_ptr(), dm.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream), "xq_tf32_probe")
    torch.cuda.synchronize()
    got, got_m = d.cpu().numpy(), dm.cpu().numpy()
    readings = {mode: (np.array_equal(got, expect(mode)), np.array_equal(got_m, expect(mode)[:16, :8]))
                for mode in ("trunc", "rna")}
    assert readings["trunc"] == (True, True), readings


def test_qmatmul_f32_refuses_unaligned_contraction(dev):
    """N off the 4 granule (the GEMM's tensor maps, ``f32_gemm_check``) is
    refused before any launch: ValueError, no count."""
    w = torch.randn((1, 64, 1026), device=dev)
    build.reset_launches()
    for m in (1, 100):
        with pytest.raises(ValueError):
            qmatmul(torch.randn((m, 1026), device=dev), w, 0)
    assert build.LAUNCHES["qmatmul_f32"] == 0


# ------------------------------- kernel 3 in one launch; the streamed M <= 8 GEMV

# (GQA group, head_dim): every shape of the attention tests above, f32 cache and bf16
DECODE_SHAPES = sorted(set(ATTENTION_SHAPES) | set(F32_ATTENTION_SHAPES), key=lambda s: s[::-1])


def _decode_kv_cases(splits: int, s: int) -> list[int]:
    """kv_len at the edges of kernel 3's split: none, one row, one block
    short of a row each, a row each, one over, phase 3's 777 and the whole
    window."""
    return [0, 1, splits - 1, splits, splits + 1, min(777, s), s]


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("g,hd", DECODE_SHAPES, ids=[f"hd{hd}-g{g}" for g, hd in DECODE_SHAPES])
def test_flash_decode_at_the_split_edges(dev, g, hd, f32):
    """Kernel 3 (one launch, the live rows split over a cluster of P blocks
    on the card) against its plain version within 1e-5 of each row's max,
    at the kv_len edges of the split (``_decode_kv_cases``: 0, 1, P - 1, P,
    P + 1, 777, S), B = 2 with another kv_len in each row, at two grids: B
    x KH = 4 (P = 16 on an H100) and 24 (P = 5); S = 800, a multiple of 32
    that no stage divides. One launch a call, counted under its cache's
    counter."""
    gen = torch.Generator(device=dev).manual_seed(7 * g + hd + f32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dt = torch.float32 if f32 else torch.bfloat16
    l, b, s = 2, 2, 800
    calls = 0
    build.reset_launches()
    for kh in (2, 12):
        h = kh * g
        ck = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(dt)
        cv = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(dt)
        splits = A.decode_plan(b, kh, g, hd, f32, sms)[0]
        kvs = _decode_kv_cases(splits, s)
        for kvl in zip(kvs, kvs[::-1]):
            q = torch.randn((b, h, hd), device=dev, generator=gen)
            kv_len = torch.tensor(kvl, dtype=torch.int32, device=dev)
            got = _attend(q, ck, cv, 1, kv_len)
            want = A.flash_decode_plain(q, ck, cv, 1, kv_len)
            calls += 1
            assert got.shape == (b, h * hd) and torch.isfinite(got).all(), kvl
            assert _row_rel(got, want, hd) < 1e-5, (kh, splits, kvl)
            if 0 in kvl:
                assert not got[kvl.index(0)].any(), kvl  # kv_len 0 gives 0
    counter = "flash_decode_f32" if f32 else "flash_decode"
    assert build.LAUNCHES[counter] == calls
    assert build.LAUNCHES["flash_decode" if f32 else "flash_decode_f32"] == 0


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_flash_decode_replays_in_a_cuda_graph(dev, f32):
    """One attention call (``fused_decode_attention`` with the write
    dropped: ``_attend``) captured in a CUDA graph and replayed three
    times, q and kv_len rewritten in place before each replay (the kernel
    reads kv_len on the card): each replay equals the eager call on the
    same inputs, bit for bit. Nothing of one launch (no workspace, no
    counter) is left for the next."""
    gen = torch.Generator(device=dev).manual_seed(5 + f32)
    dt = torch.float32 if f32 else torch.bfloat16
    l, b, kh, s, hd, g = 2, 2, 8, 4096, 128, 4
    h = kh * g
    ck = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(dt)
    cv = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(dt)
    q = torch.randn((b, h, hd), device=dev, generator=gen)
    kv_len = torch.tensor([777, 4064], dtype=torch.int32, device=dev)
    _attend(q, ck, cv, 1, kv_len)  # the launcher's one-time set-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _attend(q, ck, cv, 1, kv_len)
    for kvl in ((777, 4064), (1, 0), (4096, 16)):
        q.copy_(torch.randn((b, h, hd), device=dev, generator=gen))
        kv_len.copy_(torch.tensor(kvl, dtype=torch.int32, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        want = _attend(q, ck, cv, 1, kv_len)
        assert torch.equal(out, want), kvl
        assert _row_rel(out, A.flash_decode_plain(q, ck, cv, 1, kv_len), hd) < 1e-5, kvl


# --------------------- kernel 7 with kernels 5-6: one cluster launch over the int8 cache

# chip_smoke.py phase_parity_int8's three cases, each (kv_pos, kv_len, rotate)
# a row: a mid-ring insert, a wrapped insert with sink rotation, B = 3 with
# a row at the kv_pos == S sentinel and a rotating one
FUSED_Q_S = 2080  # a multiple of 32 that 128 does not divide: a short last chunk
FUSED_Q_CASES = (((519,), (520,), (0,)), ((1000,), (FUSED_Q_S,), (1,)),
                 ((300, FUSED_Q_S, 2000), (301, 777, FUSED_Q_S), (0, 0, 1)))
FUSED_Q_SHAPES = [(g, hd) for hd in (128, 96, 256) for g in range(1, 9)]


@pytest.mark.parametrize("g,hd", FUSED_Q_SHAPES, ids=[f"hd{hd}-g{g}" for g, hd in FUSED_Q_SHAPES])
def test_fused_decode_attention_q_matches_plain(dev, g, hd):
    """Kernels 5-7 in one launch (``fused_decode_attention_q``) against the
    plain composition (``kv_update_q_plain``, then ``flash_decode_q_plain``)
    on phase_parity_int8's three cases and at kv_len 0: the code and scale
    planes bit-equal (absmax is order-free, scale and codes by IEEE
    division), the output within 1e-3 of each row's max (the reason in the
    module's docstring), kv_len 0 giving 0; ``flash_decode_q`` (the same
    launch, no update) leaves the planes as they are. Two grids: KH 2 (P =
    16 on an H100, most blocks without a chunk at kv_len 520) and KH 12."""
    gen = torch.Generator(device=dev).manual_seed(31 * g + hd)
    l, s = 2, FUSED_Q_S
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c, sn = (torch.from_numpy(a).to(dev) for a in A.rope_cos_sin_plus1(freqs))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    build.reset_launches()
    calls = 0
    for kh in (2, 12):
        for kv_pos, kv_len, rot in FUSED_Q_CASES + (((5,), (0,), (1,)),):
            b = len(kv_pos)
            planes = _int8_planes(dev, gen, l, b, kh, s, hd)
            p1, p2 = [t.clone() for t in planes], [t.clone() for t in planes]
            q = torch.randn((b, kh * g, hd), device=dev, generator=gen)
            kn = torch.randn((b, kh, hd), device=dev, generator=gen)
            vn = torch.randn((b, kh, hd), device=dev, generator=gen)
            args = (kn, vn, i32(*kv_pos), i32(*kv_len), i32(*rot), c, sn)
            got = A.fused_decode_attention_q(q, *p1, 1, *args)
            want = A.fused_decode_attention_q_plain(q, *p2, 1, *args)
            calls += 1
            assert all(torch.equal(x, y) for x, y in zip(p1, p2)), (kh, kv_pos)
            assert got.shape == (b, kh * g * hd) and torch.isfinite(got).all()
            assert _row_rel(got, want, hd) < 1e-3, (kh, kv_pos)
            for i, n in enumerate(kv_len):
                if n == 0:
                    assert not got[i].any()
            again = A.flash_decode_q(q, *p1, 1, i32(*kv_len))
            calls += 1
            assert all(torch.equal(x, y) for x, y in zip(p1, p2))
            assert _row_rel(again, want, hd) < 1e-3
    assert build.LAUNCHES["flash_decode_q"] == calls
    assert build.LAUNCHES["kv_update_q"] == 0


def test_fused_decode_attention_q_replays_in_a_cuda_graph(dev):
    """One fused int8 step captured in a CUDA graph and replayed, q, the
    new rows, kv_pos, kv_len and rotate rewritten in place before each
    replay (the kernel reads them on the card): each replay equals an eager
    launch on the same inputs and planes, bit for bit, planes and output
    (Mistral-7B's shapes, 4096-row window)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    l, b, kh, s, hd, g = 2, 2, 8, 4096, 128, 4
    h = kh * g
    planes = _int8_planes(dev, gen, l, b, kh, s, hd)
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c, sn = (torch.from_numpy(a).to(dev) for a in A.rope_cos_sin_plus1(freqs))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    q = torch.randn((b, h, hd), device=dev, generator=gen)
    kn = torch.randn((b, kh, hd), device=dev, generator=gen)
    vn = torch.randn((b, kh, hd), device=dev, generator=gen)
    kv_pos, kv_len, rot = i32(776, 1000), i32(777, 4064), i32(0, 1)
    args = (kn, vn, kv_pos, kv_len, rot, c, sn)
    A.fused_decode_attention_q(q, *planes, 1, *args)  # the launcher's set-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.fused_decode_attention_q(q, *planes, 1, *args)
    for pos, kvl, r in (((776, 1000), (777, 4064), (0, 1)), ((0, s), (1, 0), (0, 0)),
                        ((4000, 2), (4096, 3), (1, 0))):
        for t in (q, kn, vn):
            t.copy_(torch.randn(t.shape, device=dev, generator=gen))
        for t, v in ((kv_pos, pos), (kv_len, kvl), (rot, r)):
            t.copy_(i32(*v))
        eager = [t.clone() for t in planes]
        graph.replay()
        torch.cuda.synchronize()
        want = A.fused_decode_attention_q(q, *eager, 1, *args)
        assert torch.equal(out, want), pos
        assert all(torch.equal(x, y) for x, y in zip(planes, eager)), pos


@pytest.mark.parametrize("family", PLAN_FAMILIES)
def test_decode_q_plan_matches_the_launcher(dev, family):
    """``ops.attention.decode_q_plan`` (at the device's SM count), which
    tests/test_torch_decode_q_split.py checks on the CPU, equal to what
    ``xq_flash_decode_q_plan`` reports (the launcher also asks the card
    that one cluster of that size fits) at B 1, 2, 4 and 8 and windows of
    256 and 4096 rows; both refuse a group outside 1..8 and a window that
    is not a multiple of 4."""
    import ctypes

    from xalm_tpu_torch.models import config as C

    cfg = getattr(C, family)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    alib = build.load_library("attention")
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for b in (1, 2, 4, 8):
        for s in (256, 4096):
            got = (ctypes.c_int * 3)()
            assert alib.xq_flash_decode_q_plan(b, h, kh, s, hd, got) == 0, (b, s)
            assert tuple(got) == A.decode_q_plan(b, kh, h // kh, hd, s, sms), (b, s)
    assert alib.xq_flash_decode_q_plan(1, 9, 1, 4096, 128, (ctypes.c_int * 3)()) != 0
    assert alib.xq_flash_decode_q_plan(1, h, kh, 4098, hd, (ctypes.c_int * 3)()) != 0


def _gemv_cases() -> list:
    """(M, N, dtype) of the streamed GEMV at M 1..8 and N 16, 14336, 24576
    and 81920, wherever qmatmul takes it (x within 160 KB of shared memory:
    ``gemv_plan``)."""
    from xalm_tpu_torch.ops.qmatmul import gemv_plan

    return [(m, n, dt) for dt in (torch.float32, torch.bfloat16) for n in (16, 14336, 24576, 81920)
            for m in range(1, 9) if gemv_plan(m, n, 1000, dt, 132) is not None]


@pytest.mark.parametrize("m,n,wdt", _gemv_cases(),
                         ids=[f"{str(dt)[6:]}-n{n}-m{m}" for m, n, dt in _gemv_cases()])
def test_qmatmul_streamed_gemv_matches_plain(dev, m, n, wdt):
    """Kernel 1's M <= 8 GEMV for f32 and bf16 weights (one block an SM, the
    weights through a ring of bulk copies: several rows a stage at N = 16,
    segments of a row at the wider N) against its plain version, D = 1000
    (rows dealt 7 or 8 a block, a last stage not full), with and without the
    norm prologue: f32 within 1e-5 of each row's max, bf16 1e-4
    (1e-3 with the prologue: the rms summed in another order can flip the
    bf16 rounding of an activation)."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    l, d = 2, 1000
    w = (torch.randn((l, d, n), device=dev, generator=g) * 0.02).to(wdt)
    x = torch.randn((m, n), device=dev, generator=g)
    nw = torch.rand((l, n), device=dev, generator=g) + 0.5
    f32 = wdt == torch.float32
    for extra in ({}, dict(norm_w=nw, norm_eps=1e-5)):
        build.reset_launches()
        got = qmatmul(x, w, 1, **extra)
        assert build.LAUNCHES["qmatmul_f32" if f32 else "qmatmul"] == 1
        assert torch.isfinite(got).all()
        tol = 1e-5 if f32 else 1e-3 if extra else 1e-4
        assert _row_rel(got, qmatmul_plain(x, w, 1, **extra), d) <= tol, extra.keys()


@pytest.mark.parametrize("family", PLAN_FAMILIES)
def test_decode_and_gemv_plans_match_the_launchers(dev, family):
    """``ops.attention.decode_plan`` and ``ops.qmatmul.gemv_plan`` (at the
    device's SM count), which tests/test_torch_plans.py checks on the CPU,
    equal to what ``xq_flash_decode_plan`` and ``xq_gemv_plan`` report: the
    decode at B 1, 2, 4 and 8 over both caches (the launcher also asks the
    card that one cluster of that size fits), the GEMV at every forward
    (N, D) and the head, M 1 to 8, for bf16 and f32 weights; both refuse
    what their kernels do not take."""
    import ctypes

    from xalm_tpu_torch.models import config as C
    from xalm_tpu_torch.ops.qmatmul import gemv_plan

    cfg = getattr(C, family)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qlib, alib = build.load_library("qmatmul"), build.load_library("attention")
    h, kh = cfg.n_heads, cfg.n_kv_heads
    for b in (1, 2, 4, 8):
        for f32 in (0, 1):
            got = (ctypes.c_int * 3)()
            assert alib.xq_flash_decode_plan(b, h, kh, cfg.head_dim, f32, got) == 0, (b, f32)
            assert tuple(got) == A.decode_plan(b, kh, h // kh, cfg.head_dim, bool(f32), sms)
    assert alib.xq_flash_decode_plan(1, 9, 1, 128, 0, (ctypes.c_int * 3)()) != 0
    shapes = [(cfg.dim, cfg.q_dim + 2 * cfg.kv_dim), (cfg.q_dim, cfg.dim),
              (cfg.dim, 2 * cfg.hidden_dim), (cfg.hidden_dim, cfg.dim), (cfg.dim, cfg.vocab_size)]
    for n, d in shapes:
        for kind, dt in ((1, torch.bfloat16), (2, torch.float32)):
            for m in range(1, 9):
                want = gemv_plan(m, n, d, dt, sms)
                got = (ctypes.c_int * 4)()
                err = qlib.xq_gemv_plan(m, n, d, kind, got)
                assert (err == 0) == (want is not None), (m, n, d, dt)
                if want is not None:
                    assert tuple(got) == want, (m, n, d, dt)
    for kind in (0, 3, 4):  # int8, fp8: the warp-a-row-pair GEMV
        assert qlib.xq_gemv_plan(1, 4096, 4096, kind, (ctypes.c_int * 4)()) != 0


@pytest.mark.parametrize("family", PLAN_FAMILIES)
def test_q4_stream_plan_matches_the_launcher(dev, family):
    """``ops.qmatmul.q4_plan`` (at the device's SM count), which
    tests/test_torch_q4_stream.py checks on the CPU, equal to what
    ``xq_qmatmul_q4_plan`` reports at every q4 (N, D) of the family's
    forward, each group that divides N/2, M 1 to 8 and 13, the GEMV and 2
    and 8 experts; both refuse a group off the 128 granule."""
    import ctypes

    from xalm_tpu_torch.models import config as C
    from xalm_tpu_torch.ops.qmatmul import q4_plan

    cfg = getattr(C, family)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qlib = build.load_library("qmatmul")
    shapes = [(cfg.dim, cfg.q_dim + 2 * cfg.kv_dim), (cfg.q_dim, cfg.dim),
              (cfg.dim, 2 * cfg.hidden_dim), (cfg.hidden_dim, cfg.dim)]
    for n, d in shapes:
        for group in (128, 256, 512, 1024):
            if n % (2 * group):
                continue
            for k in (1, 2, 8):
                for m in (*range(1, 9), 13):
                    want = q4_plan(m, n, d, group, k, sms)
                    got = (ctypes.c_int * 8)()
                    assert qlib.xq_qmatmul_q4_plan(m, n, d, group, k, got) == 0, (m, n, d, group)
                    assert tuple(got) == want, (m, n, d, group, k)
    assert qlib.xq_qmatmul_q4_plan(1, 4096, 4096, 192, 1, (ctypes.c_int * 8)()) != 0
    assert q4_plan(1, 4096, 4096, 192, 1, sms) is None


# ------------------------ the tiled GEMM of int8, fp8 and bf16 weights; the megakernel at B = 8

GEMM_KINDS = ("i8", "q8", "bf16", "e4m3", "e5m2")


def _gemm_weights(dev, gen, kind: str, l: int, d: int, n: int):
    """(values, kwargs) of a random (l, d, n) weight stack of ``kind`` for
    qmatmul: int8 with row scales (i8) or q8's fixed scale, bf16, or fp8
    codes (finite, within e4m3's and e5m2's ranges)."""
    if kind in ("i8", "q8"):
        w = torch.randint(-128, 128, (l, d, n), dtype=torch.int8, device=dev, generator=gen)
        if kind == "q8":
            return w, dict(q8_scale=0.01)
        return w, dict(scale=torch.rand((l, d), device=dev, generator=gen) * 0.01)
    w = torch.randn((l, d, n), device=dev, generator=gen)
    if kind == "bf16":
        return w.to(torch.bfloat16), {}
    fmt = torch.float8_e4m3fn if kind == "e4m3" else torch.float8_e5m2
    return (w * 8).to(fmt), {}


@pytest.mark.parametrize("kind", GEMM_KINDS)
@pytest.mark.parametrize("m", [9, 16, 100, 512, 513])
def test_qmatmul_tiled_gemm_matches_plain(dev, m, kind):
    """Kernel 1's tiled GEMM (``gemm_bf16w_kernel``: a TMA ring, the weights
    widened to bf16 in registers as the wgmma's A operand) against its plain
    version: D = 1000 (not a multiple of the 128-row weight tile), N = 32 x
    33 (a last stage of half its depth), every weight kind, with and
    without the norm prologue: 1e-4 of each row's max, 1e-3 with the
    prologue; one launch a call, under the kind's counter."""
    from xalm_tpu_torch.ops.qmatmul import gemm_plan

    gen = torch.Generator(device=dev).manual_seed(m + len(kind))
    l, d, n = 2, 1000, 32 * 33
    w, kw = _gemm_weights(dev, gen, kind, l, d, n)
    x = torch.randn((m, n), device=dev, generator=gen)
    nw = torch.rand((l, n), device=dev, generator=gen) + 0.5
    counter = "qmatmul_fp8" if kind.startswith("e") else "qmatmul"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for extra in ({}, dict(norm_w=nw, norm_eps=1e-5)):
        build.reset_launches()
        got = qmatmul(x, w, 1, **kw, **extra)
        assert build.LAUNCHES[counter] == 1
        assert torch.isfinite(got).all()
        want = qmatmul_plain(x, w, 1, **kw, **extra)
        rel = _row_rel(got, want, d)
        assert rel <= (1e-3 if extra else 1e-4), (extra.keys(), rel, gemm_plan(m, n, d, w.dtype,
                                                                                  sms))


@pytest.mark.parametrize("kind", ["i8", "bf16"])
@pytest.mark.parametrize("m,n,d", [(16, 14336, 4096), (8, 14336, 1000), (512, 14336, 512)])
def test_qmatmul_tiled_gemm_wide_contractions(dev, m, n, d, kind):
    """The tiled GEMM where the plan splits the contraction (w2's width at
    M = 16 and at M = 8, where x is too wide for the GEMV: the splits add
    into y) and at M = 512 over one long chain of stages (each stage's
    products summed into a fresh chain, added to the tile's sums in IEEE
    f32: the tensor cores' sums would lose toward zero over 224 stages):
    1e-4 of each row's max."""
    gen = torch.Generator(device=dev).manual_seed(m + n)
    w, kw = _gemm_weights(dev, gen, kind, 2, d, n)
    x = torch.randn((m, n), device=dev, generator=gen)
    got = qmatmul(x, w, 1, **kw)
    assert _row_rel(got, qmatmul_plain(x, w, 1, **kw), d) <= 1e-4


def test_qmatmul_tiled_gemm_replays_in_a_cuda_graph(dev):
    """One prefill chunk's four GEMMs (wqkv with the norm prologue, wo, w13
    with the norm prologue, w2; i8 with row scales, Mistral-7B's shapes cut
    to 1024 wide and 2 layers) captured in a CUDA graph and replayed with x
    rewritten in place: each replay equals the eager calls bit for bit (the
    K splits' zeroing is in the graph) and its plain versions within their
    tolerances."""
    gen = torch.Generator(device=dev).manual_seed(3)
    dim, qkv, hidden, m = 1024, 1536, 3584, 64
    shapes = {"wqkv": (qkv, dim, True), "wo": (dim, dim, False), "w13": (2 * hidden, dim, True),
              "w2": (dim, hidden, False)}
    ws = {k: _gemm_weights(dev, gen, "i8", 2, d, n) for k, (d, n, _) in shapes.items()}
    nw = torch.rand((2, dim), device=dev, generator=gen) + 0.5
    xs = {k: torch.randn((m, n), device=dev, generator=gen) for k, (_, n, _) in shapes.items()}

    def chunk():
        return {k: qmatmul(xs[k], ws[k][0], 1, **ws[k][1],
                           **(dict(norm_w=nw, norm_eps=1e-5) if shapes[k][2] else {}))
                for k in shapes}
    chunk()  # the launchers' one-time set-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = chunk()
    for _ in range(3):
        for k in xs:
            xs[k].copy_(torch.randn(xs[k].shape, device=dev, generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        eager = chunk()
        for k, (d, _, norm) in shapes.items():
            assert torch.equal(outs[k], eager[k]), k
            want = qmatmul_plain(xs[k], ws[k][0], 1, **ws[k][1],
                                 **(dict(norm_w=nw, norm_eps=1e-5) if norm else {}))
            assert _row_rel(outs[k], want, d) <= (1e-3 if norm else 1e-4), k


def test_qmatmul_tiled_gemm_refuses_unaligned_contraction(dev):
    """N off the 32 granule raises ValueError before any launch."""
    w = torch.zeros((1, 64, 48), dtype=torch.int8, device=dev)
    build.reset_launches()
    with pytest.raises(ValueError, match="tiled GEMM"):
        qmatmul(torch.zeros((16, 48), device=dev), w, 0, q8_scale=0.01)
    assert build.LAUNCHES["qmatmul"] == 0


B8_CASES = [("mistral", "i8"), ("mistral", "a8"), ("mistral", "q4"), ("gemma2", "bf16")]


@pytest.mark.parametrize("fam,body", B8_CASES)
def test_fused_decode_bodies_at_batch_8_match_plain(dev, fam, body):
    """The megakernel at its widest batch, B = 8 (each GEMV phase's 8
    activation rows staged in column chunks where they do not fit; its
    weight words loaded ahead and its first rows prefetched into L2), the
    i8, a8 and q4 (group 128) bodies and Gemma-2's folds, with the i8-head
    fold and a bf16 cache, against the plain version through a ring wrap of
    a 48-slot window, each step from the plain version's caches, rows at 8
    positions and row 1 at the sentinel: each row of x and of the logits
    within 2e-2 of its max (a8 and q4: 5e-2, and 90 % of the rows within
    1e-5: each row's int8 codes can land a count apart where the rms runs
    in another order, and a step holds 16 rows)."""
    from xalm_tpu_torch.models.llama import rope_constants, rope_tables
    from xalm_tpu_torch.models.params import recode_params_q4, recode_wcls_i8
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    b = 8
    cfg = _gemma_cfg(fam) if fam != "mistral" else dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    params = synthetic_params(cfg, device=dev, seed=60 + len(body))
    if body == "q4":
        params = recode_params_q4(params, 128)
    params = recode_wcls_i8(params)
    s = cfg.max_seq_len
    freqs, c1, s1 = rope_constants(cfg, dev)
    kern, plain = (KVCache.init(cfg, b, torch.bfloat16, dev) for _ in range(2))
    rng = np.random.default_rng(b)
    start = np.array([0, 7, 20, 3, 11, 30, 1, 40])
    build.reset_launches()
    steps = s + 6
    rels, step_rels = [], []  # each row's error; each step's worst row's
    quant = body in ("a8", "q4")
    for st in range(steps):
        kern.k.copy_(plain.k)
        kern.v.copy_(plain.v)
        pos = torch.from_numpy((start + st).astype(np.int32))
        _, kv_pos, kv_len = ring_indices(pos, s)
        rot = (pos >= s).to(torch.int32)
        kv_pos[1], rot[1] = s, 0
        tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=b))
        x0 = params.embed.values[tok.to(dev)].float() * cfg.embed_scale
        ce, se = (z[:, 0, 0] for z in rope_tables(pos[:, None], freqs.cpu()))
        kw = dict(a8=quant, wcls=params.wcls, out_norm=params.out_norm)
        got = fd.fused_decode_step(params, cfg, x0, kern.k, kern.v, kv_pos, kv_len, rot, ce, se,
                                   c1, s1, **kw)
        want = fd.fused_decode_step_plain(params, cfg, x0, plain.k, plain.v, kv_pos, kv_len, rot,
                                          ce, se, c1, s1, **kw)
        torch.cuda.synchronize()
        for gv, wv in ((got[0], want[0]), (got[1], want[1])):
            assert torch.isfinite(gv).all()
            row_rels = ((gv - wv).abs().amax(dim=1) / wv.abs().amax(dim=1)).tolist()
            rels += row_rels
            step_rels.append(max(row_rels))
            assert max(row_rels) <= (5e-2 if quant else 2e-2), (st, max(row_rels))
        assert torch.equal(got[2], got[1].argmax(dim=-1).to(torch.int32))
    counter = {"i8": "fused_decode", "bf16": "fused_decode", "a8": "fused_decode_a8",
               "q4": "fused_decode_q4"}[body]
    assert build.LAUNCHES[counter] == steps
    assert build.LAUNCHES["fused_decode_gemma2"] == (steps if fam == "gemma2" else 0)
    print(f"B=8 {fam} {body}: share within 1e-5 by row {np.mean(np.asarray(rels) <= 1e-5):.4f}, "
          f"by step (its worst row) {np.mean(np.asarray(step_rels) <= 1e-5):.4f}")
    if quant:
        assert np.mean(np.asarray(rels) <= 1e-5) >= 0.9, sorted(rels)[-5:]


# ----------- kernel 8's int8, q8 and bf16 experts on the per-expert stream

MIXTRAL_MULTI = ((4096, 28672, True), (14336, 4096, False))  # w13 (x shared), w2 (x per expert)


@pytest.mark.parametrize("wdt", ["i8", "q8", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 9])
@pytest.mark.parametrize("n,d,shared", MIXTRAL_MULTI, ids=["w13", "w2"])
def test_qmatmul_multi_stream_at_mixtral_widths(dev, wdt, m, n, d, shared):
    """Kernel 8 at Mixtral-8x7B's widths, k = 2 experts of a 256-expert
    stack (32 layers of 8), one of them index 255, the last: 1e-4 of each
    output row's max (the same exact products in f32, summed in another
    order), one qmatmul_multi launch. int8 and q8 experts run the
    per-expert stream where one launch holds x's m rows (w13 m 1 and 4, w2
    m 1; w2's x of 57 KB a row fills shared memory at 3 rows), the rest
    (m = 9, w2's m = 4, bf16 experts) ``qmatmul_multi_kernel``."""
    from xalm_tpu_torch.ops.qmatmul import multi_plan

    gen = torch.Generator(device=dev).manual_seed(m + n + len(wdt))
    le = 256
    if wdt == "bf16":  # a (le, d, n) bf16 stack of Mixtral's w13 is 60 GB: stride by layer
        le = 4
    w, scale = _expert_stack(dev, gen, wdt, le, d, n)
    idxs = torch.tensor([le - 1, 3], dtype=torch.int32, device=dev)
    x = torch.randn((m if shared else 2 * m, n), device=dev, generator=gen)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = multi_plan(m, n, d, w.dtype, 2, sms)
    streamed = wdt != "bf16" and m <= (8 if shared else 3)
    assert (plan is not None) == streamed and (plan is None or plan[0] == m)
    build.reset_launches()
    got = qmatmul_multi(x, w, scale, idxs, shared_x=shared)
    assert build.LAUNCHES["qmatmul_multi"] == 1
    want = qmatmul_multi_plain(x, w, scale, idxs, shared_x=shared)
    assert got.shape == want.shape == (2 * m, d) and torch.isfinite(got).all()
    assert _row_rel(got, want, d) < 1e-4
    del w, scale
    torch.cuda.empty_cache()


@pytest.mark.parametrize("m,shared", [(1, True), (9, False), (3, True)])
def test_qmatmul_multi_stream_index_outside_the_stack_gives_nan_rows(dev, m, shared):
    """An expert index past the stack's end gives NaN rows for that expert
    and the others' rows as the plain version gives them."""
    gen = torch.Generator(device=dev).manual_seed(40 + m)
    le, d, n = 6, 1000, 1040
    w, scale = _expert_stack(dev, gen, "i8", le, d, n)
    x = torch.randn((m if shared else 2 * m, n), device=dev, generator=gen)
    got = qmatmul_multi(x, w, scale, torch.tensor([le, 2], dtype=torch.int32, device=dev),
                        shared_x=shared)
    assert torch.isnan(got[:m]).all()
    xo = x if shared else x[m:]
    want = qmatmul_multi_plain(xo, w, scale, torch.tensor([2], dtype=torch.int32, device=dev),
                               shared_x=True)
    assert _row_rel(got[m:], want, d) < 1e-4


@pytest.mark.parametrize("family", PLAN_FAMILIES)
def test_multi_stream_plan_matches_the_launcher(dev, family):
    """``ops.qmatmul.multi_plan`` (at the device's SM count), which
    tests/test_torch_multi_stream.py checks on the CPU, equal to what
    ``xq_qmatmul_multi_plan`` reports at the family's w13 and w2 widths,
    int8, m 1 to 9, 17 and 255 with k 1, 2 and 8 where k * m <= 512: the
    same plan, or both refuse (m past 8 or x's rows too wide; the wrapper
    then launches ``qmatmul_multi_kernel``); both refuse N off the 16
    granule, bf16 and f32 weights."""
    import ctypes

    from xalm_tpu_torch.models import config as C
    from xalm_tpu_torch.ops.qmatmul import multi_plan

    cfg = getattr(C, family)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = build.load_library("qmatmul")
    for n, d in ((cfg.dim, 2 * cfg.hidden_dim), (cfg.hidden_dim, cfg.dim)):
        for k in (1, 2, 8):
            for m in list(range(1, 10)) + [17, 255]:
                if k * m > 512:
                    continue
                got = (ctypes.c_int * 8)()
                want = multi_plan(m, n, d, torch.int8, k, sms)
                err = lib.xq_qmatmul_multi_plan(m, n, d, 0, k, got)
                assert (err == 0) == (want is not None), (m, n, k)
                assert want is None or tuple(got) == want, (m, n, d, k)
    assert lib.xq_qmatmul_multi_plan(1, 120, 64, 0, 2, (ctypes.c_int * 8)()) != 0
    assert lib.xq_qmatmul_multi_plan(1, 4096, 64, 1, 2, (ctypes.c_int * 8)()) != 0
    assert lib.xq_qmatmul_multi_plan(1, 4096, 64, 2, 2, (ctypes.c_int * 8)()) != 0


# ---------------- kernel 2 in kernel 3's launch: fused_decode_attention

# (kv_pos, kv_len, rotate) of each case, a row each: an insert at kv_len - 1,
# a wrapped insert with sink rotation, kv_len below twice the blocks (the
# sinks in two blocks' ranges, each re-rotated by its owner), kv_len 0 and
# 1, and B = 2 with the row at the kv_pos == S sentinel
FUSED_S = 4096
FUSED_CASES = (((776,), (777,), (0,)), ((1000,), (FUSED_S,), (1,)), ((9,), (10,), (1,)),
               ((1,), (2,), (1,)), ((5,), (0,), (1,)), ((0,), (1,), (0,)),
               ((4000, FUSED_S), (4064, 300), (1, 1)))
FUSED_SHAPES = [(g, hd) for hd in (128, 96, 256) for g in range(1, 9)]


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("g,hd", FUSED_SHAPES, ids=[f"hd{hd}-g{g}" for g, hd in FUSED_SHAPES])
def test_fused_decode_attention_matches_plain(dev, g, hd, f32):
    """Kernels 2 and 3 in one launch (``fused_decode_attention``) against
    the plain composition (``kv_update_plain``, then ``flash_decode_plain``)
    in ``FUSED_CASES`` at KH 8 (16 blocks a (batch, kv head) on an H100) and
    KH 2: the cache planes bit-equal (each row stored or rotated with
    kv_update_kernel's arithmetic by the block that reads it), the output
    within 1e-5 of each row's max (kernel 3's tolerance), kv_len 0 giving
    0; counted under flash_decode (``_f32``), with no kv_update launch."""
    gen = torch.Generator(device=dev).manual_seed(7 * g + hd + f32)
    dt = torch.float32 if f32 else torch.bfloat16
    l, s = 2, FUSED_S
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c, sn = (torch.from_numpy(a).to(dev) for a in A.rope_cos_sin_plus1(freqs))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    build.reset_launches()
    calls = 0
    for kh in (8, 2):
        for kv_pos, kv_len, rot in FUSED_CASES:
            b = len(kv_pos)
            ck = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(dt)
            cv = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(dt)
            k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
            q = torch.randn((b, kh * g, hd), device=dev, generator=gen)
            kn = torch.randn((b, kh, hd), device=dev, generator=gen)
            vn = torch.randn((b, kh, hd), device=dev, generator=gen)
            args = (kn, vn, i32(*kv_pos), i32(*kv_len), i32(*rot), c, sn)
            got = A.fused_decode_attention(q, k1, v1, 1, *args)
            want = A.fused_decode_attention_plain(q, k2, v2, 1, *args)
            calls += 1
            assert torch.equal(k1, k2) and torch.equal(v1, v2), (kh, kv_pos, kv_len)
            assert got.shape == (b, kh * g * hd) and torch.isfinite(got).all()
            assert _row_rel(got, want, hd) < 1e-5, (kh, kv_pos, kv_len)
            for i, n in enumerate(kv_len):
                if n == 0:
                    assert not got[i].any()
            del ck, cv, k1, v1, k2, v2
    counter = "flash_decode_f32" if f32 else "flash_decode"
    assert build.LAUNCHES[counter] == calls
    assert build.LAUNCHES["kv_update"] == build.LAUNCHES["kv_update_f32"] == 0


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_fused_decode_attention_replays_in_a_cuda_graph(dev, f32):
    """One fused float-cache step captured in a CUDA graph and replayed, q,
    the new rows, kv_pos, kv_len and rotate rewritten in place before each
    replay (the kernel reads them on the card): each replay equals an eager
    launch on the same inputs and planes, bit for bit, planes and output
    (Mistral-7B's shapes, 4096-row window)."""
    gen = torch.Generator(device=dev).manual_seed(19 + f32)
    dt = torch.float32 if f32 else torch.bfloat16
    l, b, kh, s, hd, g = 2, 2, 8, 4096, 128, 4
    h = kh * g
    ck = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(dt)
    cv = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(dt)
    freqs = (1e4 ** (-np.arange(0, hd, 2) / hd)).astype(np.float32)
    c, sn = (torch.from_numpy(a).to(dev) for a in A.rope_cos_sin_plus1(freqs))
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    q = torch.randn((b, h, hd), device=dev, generator=gen)
    kn = torch.randn((b, kh, hd), device=dev, generator=gen)
    vn = torch.randn((b, kh, hd), device=dev, generator=gen)
    kv_pos, kv_len, rot = i32(776, 1000), i32(777, 4064), i32(0, 1)
    args = (kn, vn, kv_pos, kv_len, rot, c, sn)
    A.fused_decode_attention(q, ck, cv, 1, *args)  # the launcher's set-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.fused_decode_attention(q, ck, cv, 1, *args)
    for pos, kvl, r in (((776, 1000), (777, 4064), (0, 1)), ((0, s), (1, 0), (0, 0)),
                        ((4000, 2), (4096, 3), (1, 1))):
        for t in (q, kn, vn):
            t.copy_(torch.randn(t.shape, device=dev, generator=gen))
        for t, v in ((kv_pos, pos), (kv_len, kvl), (rot, r)):
            t.copy_(i32(*v))
        ek, ev = ck.clone(), cv.clone()
        graph.replay()
        torch.cuda.synchronize()
        want = A.fused_decode_attention(q, ek, ev, 1, *args)
        assert torch.equal(out, want), pos
        assert torch.equal(ck, ek) and torch.equal(cv, ev), pos


# ---------------------------------------------------------------- decode as CUDA-graph replays


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_megakernel_step_replays_in_a_cuda_graph(dev, cache):
    """The whole-step megakernel (i8 body, embed and i8-head folds: one
    cooperative launch) captured in a CUDA graph over step inputs on the
    card, pos and the token rewritten in place before each replay: x, the
    logits, the token and every cache plane bit-equal to an eager launch on
    the same inputs and planes, through a ring wrap of the 48-slot window."""
    from xalm_tpu_torch.models.llama import rope_constants
    from xalm_tpu_torch.models.params import recode_wcls_i8
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, step_inputs
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    params = recode_wcls_i8(synthetic_params(cfg, device=dev, seed=21))
    s = cfg.max_seq_len
    freqs, c1, s1 = rope_constants(cfg, dev)
    kv = KVCache.init(cfg, 1, torch.int8 if cache == "int8" else torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    for t in kv.planes():  # a filled window: random rows (codes) and scales
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, device=dev, generator=gen))
        else:
            t.copy_(torch.rand(t.shape, device=dev, generator=gen).to(t.dtype) * 0.1)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    tok = torch.zeros((1,), dtype=torch.int32, device=dev)

    def step(planes):
        kv_pos, kv_len, rot = step_inputs(pos, s)
        scales = dict(k_scale=planes[2], v_scale=planes[3]) if len(planes) == 4 else {}
        return fd.fused_decode_step(params, cfg, None, planes[0], planes[1], kv_pos, kv_len, rot,
                                    None, None, c1, s1, wcls=params.wcls, out_norm=params.out_norm,
                                    embed=params.embed, token=tok, pos=pos, freqs=freqs,
                                    **scales)[:3]

    step(kv.planes())  # the launcher's set-up (occupancy, attributes), outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(kv.planes())
    for p, t in ((5, 7), (47, 300), (48, 11), (120, 2), (1000, 99)):
        pos.fill_(p)
        tok.fill_(t)
        eager = [x.clone() for x in kv.planes()]
        graph.replay()
        torch.cuda.synchronize()
        want = step(eager)
        assert all(torch.equal(a, b) for a, b in zip(out, want)), p
        assert all(torch.equal(a, b) for a, b in zip(kv.planes(), eager)), p


def _scan_engines(dev, path: str):
    """A small engine of each decode path: the megakernel (i8 head fold),
    per layer over a bf16 and an int8 cache, and Mixtral's gathered experts."""
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    if path == "moe":
        cfg, params = _small_mixtral(dev, 8)
        return Engine(cfg, params)
    cfg = dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    params = synthetic_params(cfg, device=dev, seed=22)
    kw = {"megakernel": dict(wcls_i8=True), "perlayer": dict(fused_step=False),
          "perlayer_int8": dict(fused_step=False, kv_dtype=torch.int8)}[path]
    return Engine(cfg, params, **kw)


SCAN_PATHS = ["megakernel", "perlayer", "perlayer_int8", "moe"]


@pytest.mark.parametrize("path", SCAN_PATHS)
def test_decode_scan_replays_equal_per_step_decode(dev, path):
    """decode_scan (one warm-up step, a capture, replays) gives the tokens
    of per-step decode from the same prefill, through a ring wrap; its
    launch counts are the per-step ones times the steps; the second segment,
    its inputs on the card, runs under torch's sync debug mode "error";
    the window's cache rows end bit-equal."""
    eng = _scan_engines(dev, path)
    want_path = "perlayer" if path.startswith("perlayer") or path == "moe" else path
    assert eng.decode_path(1) == want_path
    window = eng.cfg.max_seq_len
    steps = window + 8
    prompt = list(range(3, 13))
    _, ca, pos = eng.prefill(prompt, eng.new_cache(1))
    _, cb, _ = eng.prefill(prompt, eng.new_cache(1))
    tok = 5
    want = []
    build.reset_launches()
    for i in range(steps):
        logits, cb = eng.decode(np.array([tok]), np.array([pos + i], np.int32), cb)
        tok = int(logits.argmax())
        want.append(tok)
    per_step = {k: n for k, n in build.LAUNCHES.items() if n}
    build.reset_launches()
    half = steps // 2
    got, ca = eng.decode_scan(np.array([5]), np.array([pos]), ca, half)
    torch.cuda.synchronize()
    toks = torch.tensor([got[0, -1].item()], dtype=torch.int32, device=dev)
    at = torch.tensor([pos + half], dtype=torch.int32, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        rest, ca = eng.decode_scan(toks, at, ca, steps - half)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.cat([got, rest], dim=1)[0].tolist() == want
    assert {k: n for k, n in build.LAUNCHES.items() if n} == per_step
    # the window's rows; the padded prefill chunk's dropped writes all land
    # in the sentinel row S of the physical padding (duplicate indices of
    # one scatter: either may win), which nothing attends
    assert all(torch.equal(a[..., :window, :], b[..., :window, :]) if a.dim() == 5
               else torch.equal(a[..., :window], b[..., :window])
               for a, b in zip(ca.planes(), cb.planes()))


def test_decode_scan_raises_when_the_capture_fails(dev, monkeypatch):
    """No eager fallback on the card: a capture that fails raises out of
    decode_scan and generate(segment > 1), and no graph is kept."""
    from xalm_tpu_torch.runtime import graphs

    eng = _scan_engines(dev, "perlayer")

    def refuse(*args, **kw):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(graphs.torch.cuda, "graph", refuse)
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.decode_scan(np.array([5]), np.array([0]), eng.new_cache(1), 4)
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.generate([3, 4, 5], 8, stop_on_eos=False, segment=4)
    assert all(g.graph is None for _, g in eng._graphs.values())


def test_capture_runs_with_the_garbage_collector_off(dev, monkeypatch):
    """A StepGraph's capture runs with Python's cyclic collector off (a
    collection that frees an unreachable engine's graphs mid-capture
    invalidates the capture) and turns it back on after, also when the
    capture raises."""
    import gc

    from xalm_tpu_torch.runtime import graphs

    x = torch.zeros(4, device=dev)
    seen = []

    def step():
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))
        x.add_(1)

    assert gc.isenabled()
    graphs.StepGraph(step, dev).run(3)
    assert (True, False) in seen and (False, True) in seen
    assert all(not on for capturing, on in seen if capturing)
    assert gc.isenabled() and float(x[0]) == 3.0

    def refuse(*args, **kw):
        assert not gc.isenabled()
        raise RuntimeError("capture refused")

    monkeypatch.setattr(graphs.torch.cuda, "graph", refuse)
    with pytest.raises(RuntimeError, match="capture refused"):
        graphs.StepGraph(step, dev).run(2)
    assert gc.isenabled()


@pytest.mark.parametrize("path", SCAN_PATHS)
def test_generate_segments_and_sampling_on_the_card(dev, path):
    """generate at segment 16 (graph replays) gives the tokens of segment 1
    (eager steps) through a ring wrap, a second call replays without a new
    capture, sampled generate reproduces under its seed (the graph-safe
    generator draws anew at each replay), and the scanned perplexity's
    log-probs equal the per-token ones bit for bit."""
    eng = _scan_engines(dev, path)
    n = eng.cfg.max_seq_len + 10
    prompt = list(range(3, 12))
    greedy, _ = eng.generate(prompt, n, stop_on_eos=False, segment=1)
    seg, _ = eng.generate(prompt, n, stop_on_eos=False, segment=16)
    assert seg == greedy
    graph = next(g for _, g in eng._graphs.values())
    assert graph.graph is not None and graph.replays == n - 2
    assert eng.generate(prompt, n, stop_on_eos=False)[0] == greedy  # default segment: 16
    assert graph.replays == 2 * (n - 1) - 1
    kw = dict(stop_on_eos=False, temperature=0.9, top_k=50, top_p=0.95)
    a, _ = eng.generate(prompt, n, seed=3, **kw)
    assert eng.generate(prompt, n, seed=3, **kw)[0] == a
    assert len(set(a)) > 3  # fresh draws at every replay
    toks = np.random.default_rng(1).integers(3, eng.cfg.vocab_size, size=n).astype(np.int32)
    w = eng.cfg.max_seq_len
    _, c1, pos = eng.prefill(toks[:w].tolist(), eng.new_cache(1))
    _, c2, _ = eng.prefill(toks[:w].tolist(), eng.new_cache(1))
    lps, _ = eng._ppl_scan(toks[None, pos:-1], toks[None, pos + 1:], np.array([pos]), c1)
    for i in range(n - 1 - pos):
        logits, c2 = eng.decode(toks[pos + i:pos + i + 1], np.array([pos + i], np.int32), c2)
        want = torch.log_softmax(logits.float(), -1)[0, int(toks[pos + i + 1])]
        assert torch.equal(lps[0, i], want), i


SPEC_PATHS = ["megakernel", "perlayer", "perlayer_int8"]


@pytest.mark.parametrize("path", SPEC_PATHS)
def test_verify_chunk_replays_equal_the_eager_chunk(dev, path):
    """The pre-wrap verify chunk (``Engine.verify``): its first call (the
    warm-up step and the capture) and a replay give the argmax and the cache
    rows of the eager chunk forward bit for bit, and the replay counts the
    eager chunk's launches. The window's rows are compared: the padded int8
    prefill's dropped writes race in the sentinel row S of the physical
    padding (ROADMAP section 3), which nothing attends."""
    eng = _scan_engines(dev, path)
    prompt = list(range(3, 13))
    _, ca, pos = eng.prefill(prompt, eng.new_cache(1))
    _, cb, _ = eng.prefill(prompt, eng.new_cache(1))
    for i, chunk in enumerate(([5, 6, 7, 8, 9], [11, 3, 4, 20, 21])):
        at = pos + 5 * i
        build.reset_launches()
        got, rows = eng.verify(chunk, at, ca, wrapped=False)
        replayed = {k: n for k, n in build.LAUNCHES.items() if n}
        build.reset_launches()
        logits, cb = eng.step(np.array([chunk]), np.array([at], np.int32), cb, logits_mode="all")
        eager = {k: n for k, n in build.LAUNCHES.items() if n}
        assert rows is None and got == logits[0].argmax(-1).tolist()
        window = eng.cfg.max_seq_len
        assert all(torch.equal(a[:, :, :, :window], b[:, :, :, :window])
                   for a, b in zip(ca.planes(), cb.planes()))
        assert replayed == eager and replayed.get("qmatmul")
    _, graph = eng._verifier(ca, 4, False)
    assert graph.graph is not None and graph.replays == 1


@pytest.mark.parametrize("path", SPEC_PATHS)
def test_wrapped_verify_replays_write_nothing(dev, path):
    """The wrapped verify chunk (``forward(spec_verify=True)``) captured and
    replayed leaves every cache plane bit for bit as it was, and gives the
    eager forward's argmax and rows."""
    from xalm_tpu_torch.models.llama import forward

    eng = _scan_engines(dev, path)
    _, cache, pos = eng.prefill(list(range(3, 13)), eng.new_cache(1))
    steps = eng.cfg.max_seq_len + 7 - pos
    toks, cache = eng.decode_scan(np.array([5]), np.array([pos]), cache, steps)
    pos += steps
    tok = int(toks[0, -1])
    before = [p.clone() for p in cache.planes()]
    for i, chunk in enumerate(([tok, 6, 7, 8, 9], [tok, 3, 4, 20, 21])):
        got, rows = eng.verify(chunk, pos + i, cache, wrapped=True)
        assert all(torch.equal(a, b) for a, b in zip(before, cache.planes()))
        with torch.inference_mode():
            logits, _, want = forward(eng.params, eng.cfg, torch.tensor([chunk], device=dev),
                                      torch.tensor([pos + i], dtype=torch.int32, device=dev),
                                      cache, logits_mode="all", spec_verify=True,
                                      **eng._forward_kw())
        assert got == logits[0].argmax(-1).tolist()
        assert all(torch.equal(a, b) for a, b in zip(rows, want))
    _, graph = eng._verifier(cache, 4, True)
    assert graph.graph is not None and graph.replays == 1


@pytest.mark.parametrize("path", SPEC_PATHS)
def test_generate_spec_equals_generate_on_a_copy_model(dev, path):
    """generate_spec on the card (verify chunks as graph replays, the
    commit after the wrap of a 64-slot window) gives generate's tokens and
    the copy model's recurrence (``chip_smoke.copy_params``: its greedy
    token wins by a 200-nat margin, so the verify chunk's arithmetic and
    the decode step's agree on it), with n-gram drafts and with a draft
    engine; both verify regimes are captured."""
    import chip_smoke
    from xalm_tpu_torch.runtime import spec
    from xalm_tpu_torch.runtime.engine import Engine

    cfg = dataclasses.replace(MISTRAL_7B, dim=512, hidden_dim=1024, n_layers=2, n_heads=4,
                              n_kv_heads=2, vocab_size=512, max_seq_len=64)
    params, perm_inv = chip_smoke.copy_params(cfg, 5)
    kw = {"megakernel": dict(wcls_i8=True), "perlayer": dict(fused_step=False),
          "perlayer_int8": dict(fused_step=False, kv_dtype=torch.int8)}[path]
    eng = Engine(cfg, params, **kw)
    prompt = chip_smoke.copy_prompt(perm_inv, 6, rec=40)
    n = 80  # from 42 prompt tokens: past the wrap at 64
    want = chip_smoke.recurrence(prompt, perm_inv, n)
    plain, _ = eng.generate(prompt, n, stop_on_eos=False)
    drafted, dstats = spec.generate_spec(eng, prompt, n, k=7, stop_on_eos=False,
                                         draft_engine=Engine(cfg, params, **kw))
    ngram, nstats = spec.generate_spec(eng, prompt, n, k=7, stop_on_eos=False)
    assert plain == want and drafted == want and ngram == want
    assert dstats.spec_accepted > n // 2 and nstats.spec_accepted > 0
    cache = eng.fresh_cache(1)  # generate_spec's planes, where its graphs are kept
    for wrapped in (False, True):
        assert eng._verifier(cache, 7, wrapped)[1].graph is not None


# ------------------------------------------------ serving: the continuous batcher


@pytest.mark.parametrize("f32", [False, True])
def test_flash_prefill_rows_at_other_positions_and_masked_rows(dev, f32):
    """A packed serving prefill call: rows at their own positions (0, 300
    and the last chunk that fits the window) beside masked rows whose pos
    lies within T of the window's end or past it. Called with those
    positions as they are, the valid rows match the plain version (2^-8 of
    each row's max over a bf16 cache, 1e-5 over an f32 one) and the masked
    rows stay finite; the kernel reads nothing past the plane (its tensor
    map fills keys past S with zeros, which a query past the window then
    attends, so a masked row's output differs from the plain version's).
    The forward hands kernel 4 the chunk's clamped window start instead
    (``min(pos, S - T)``, the start its writes use): then every row matches
    the plain version and the valid rows are bit-equal to the unclamped
    call's."""
    gen = torch.Generator(device=dev).manual_seed(31 + f32)
    l, b, kh, g, hd, s, t = 2, 5, 2, 4, 128, 1024, 64
    dt = torch.float32 if f32 else torch.bfloat16
    ck = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(dt)
    cv = torch.randn((l, b, kh, s, hd), device=dev, generator=gen).to(dt)
    q = torch.randn((b, t, kh * g, hd), device=dev, generator=gen)
    pos = torch.tensor([0, 300, s - t, s - 20, s + 700], dtype=torch.int32, device=dev)
    tol = 1e-5 if f32 else 2.0 ** -8
    raw = A.flash_prefill(q, ck, cv, 1, pos)
    want = A.flash_prefill_plain(q, ck, cv, 1, pos)
    assert torch.isfinite(raw).all()
    assert _row_rel(raw[:3], want[:3], hd) <= tol
    win0 = torch.clamp(pos, max=s - t)
    clamped = A.flash_prefill(q, ck, cv, 1, win0)
    assert _row_rel(clamped, A.flash_prefill_plain(q, ck, cv, 1, win0), hd) <= tol
    assert torch.equal(clamped[:3], raw[:3])


def _serving_engine(dev, path: str):
    """A small engine (FUSED_CFG, window 48) on a decode path, with a
    tokenizer-free model: the megakernel, or per layer over a bf16 or an
    int8 cache."""
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, **FUSED_CFG)
    params = synthetic_params(cfg, device=dev, seed=23)
    kw = {"megakernel": {}, "perlayer": dict(fused_step=False),
          "perlayer_int8": dict(fused_step=False, kv_dtype=torch.int8)}[path]
    return Engine(cfg, params, **kw)


def _window_equal(c1, c2, window: int) -> bool:
    """The window's rows of every plane bit-equal (row S of the physical
    padding takes the masked rows' dropped writes, ROADMAP section 3)."""
    return all(torch.equal(a[..., :window, :], b[..., :window, :]) if a.dim() == 5
               else torch.equal(a[..., :window], b[..., :window])
               for a, b in zip(c1.planes(), c2.planes()))


def _decoding_batcher(eng, segment: int = 4):
    """A batcher of 4 slots with three requests decoding (prompts of 5, 17
    and 30 tokens: positions apart) and one slot free."""
    from xalm_tpu_torch.serve.batching import ContinuousBatcher, Request

    b = ContinuousBatcher(eng, max_batch=4, segment=segment, prefill_budget=16)
    b.warmup()
    rng = np.random.default_rng(4)
    reqs = [Request(prompt_ids=rng.integers(3, 300, size=n).tolist(), max_new_tokens=40,
                    stop_on_eos=False, temperature=tmp, seed=i, logprobs=lp)
            for i, (n, tmp, lp) in enumerate(((5, 0.0, 0), (17, 0.9, 2), (30, 0.0, 3)))]
    for r in reqs:
        b.submit(r)
    while len(b.decoding_slots()) < 3:
        b.step()
    return b, reqs


@pytest.mark.parametrize("path", ["megakernel", "perlayer", "perlayer_int8"])
def test_batcher_segments_replay_their_eager_steps(dev, path):
    """From a batcher's state (three slots decoding at other positions, one
    free): a segment of the greedy masked scan's replays and of the per-row
    sampled scan's (log-probs on) give the tokens, log-probs, top-5 and
    keys of the same steps run eagerly (``Engine.step`` and the samplers),
    bit for bit, and the same window rows; then the run gives each greedy
    request its solo ``generate`` tokens."""
    from xalm_tpu_torch import prng
    from xalm_tpu_torch.sampler import sample_rows, split_rows

    eng = _serving_engine(dev, path)
    b, reqs = _decoding_batcher(eng)
    window = eng.cfg.max_seq_len
    n = b.segment
    for kind in ("greedy", "rows"):
        state = b.slot_state()
        mask = state["decoding"]
        ref = b.cache.clone()
        tok, pos = state["token"], state["pos"]
        keys = prng.from_numpy(state["keys"]).to(dev)
        temps, tps = (torch.from_numpy(state[k]).to(dev) for k in ("temps", "top_ps"))
        want_tok, want_lp, want_keys = [], [], keys.clone()
        for _ in range(n):
            out, _ = eng.step(tok[:, None], pos, ref, mask[:, None],
                              logits_mode="token" if kind == "greedy" else "last")
            if kind == "rows":
                subs, carry = split_rows(want_keys)
                want_keys = torch.where(torch.from_numpy(mask).to(dev)[:, None], carry, want_keys)
                nxt, lp, topv, topi = sample_rows(out, subs, temps, tps, return_logprobs=True)
                want_lp.append((lp, topv, topi))
                out = nxt
            tok = out.cpu().numpy().astype(np.int32)
            want_tok.append(tok)
            pos = pos + 1
        if kind == "greedy":
            got, _ = eng.decode_scan(state["token"], state["pos"], b.cache, n, valid=mask)
            got_keys = None
        else:
            got, lps, topv, topi, got_keys = eng.sample_scan_rows(
                state["token"], state["pos"], b.cache, keys, temps, tps, n, valid=mask,
                want_lp=True)
            assert torch.equal(got_keys, want_keys)
            for j, (lp, tv, ti) in enumerate(want_lp):
                assert torch.equal(lps[:, j], lp) and torch.equal(topv[:, j], tv)
                assert torch.equal(topi[:, j], ti)
        assert np.array_equal(got.cpu().numpy()[mask], np.stack(want_tok, 1)[mask]), kind
        assert _window_equal(b.cache, ref, window), kind
        b.cache.copy_(ref)  # both paths wrote the same rows: go on from either
    b.run()
    for r in reqs:
        if r.temperature == 0:
            assert r.out_tokens == eng.generate(r.prompt_ids, 40, stop_on_eos=False)[0]


def test_copy_lane_keeps_the_captured_graphs(dev):
    """``copy_lane`` writes the batcher's planes in place: after it the
    graphs captured at warmup replay on the copied rows (no new capture):
    the copied lane decodes the tokens of its source."""
    from xalm_tpu_torch.runtime.cache import copy_lane

    eng = _serving_engine(dev, "megakernel")
    b, _ = _decoding_batcher(eng)
    graphs = {k: g.graph for k, (_, g) in eng._graphs.items()}
    assert graphs and all(g is not None for g in graphs.values())
    ptrs = [t.data_ptr() for t in b.cache.planes()]
    src = 2
    copy_lane(b.cache, 3, src)
    assert [t.data_ptr() for t in b.cache.planes()] == ptrs
    state = b.slot_state()
    tok, pos = state["token"], state["pos"]
    tok[3], pos[3] = tok[src], pos[src]
    mask = np.array([False, False, True, True])
    got, _ = eng.decode_scan(tok, pos, b.cache, 8, valid=mask)
    got = got.cpu().numpy()
    assert np.array_equal(got[3], got[src])
    assert {k: g.graph for k, (_, g) in eng._graphs.items()} == graphs


@pytest.mark.parametrize("path", ["megakernel", "perlayer"])
def test_sample_scan_rows_replays_equal_its_eager_steps(dev, path):
    """``sample_scan_rows`` on the card (a warm-up step, a capture, then
    replays) against the same scan run eagerly (a second engine over the
    same weights whose StepGraph runs on a CPU device tag: the step
    function itself, no graph): tokens, log-probs, top-5 and keys bit for
    bit, over 2 segments of 8 and rows at 4 positions, one masked."""
    from xalm_tpu_torch import prng

    eng = _serving_engine(dev, path)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, 300, size=n).tolist() for n in (4, 9, 21, 13)]
    caches = [eng.new_cache(4), eng.new_cache(4)]
    for row, ids in enumerate(prompts):
        _, c1, _ = eng.prefill(ids, eng.new_cache(1))
        for c in caches:
            for a, b1 in zip(c.planes(), c1.planes()):
                a[:, row].copy_(b1[:, 0])
    tok = np.array([5, 6, 7, 8], np.int32)
    pos = np.array([len(p) for p in prompts], np.int32)
    valid = np.array([True, True, False, True])
    keys = torch.stack([prng.PRNGKey(s, dev) for s in (1, 2, 3, 4)])
    temps = torch.tensor([0.0, 0.8, 1.0, 1.3], device=dev)
    tps = torch.tensor([1.0, 0.95, 0.9, 0.5], device=dev)
    outs = []
    for c, eager in ((caches[0], False), (caches[1], True)):
        st, graph = eng._scan(c, "rows", valid=True, want_lp=True)
        if eager:
            graph.device = torch.device("cpu")  # run() then calls the step eagerly
        segs, k, t_, p_ = [], keys, tok, pos
        for _ in range(2):
            o = eng.sample_scan_rows(t_, p_, c, k, temps, tps, 8, valid=valid, want_lp=True)
            segs.append([x.clone() for x in o[:-1]])
            k, t_, p_ = o[-1].clone(), o[0][:, -1].cpu().numpy(), p_ + 8
        outs.append((segs, k))
        assert (graph.graph is None) == eager
    (ga, ka), (ea, kb) = outs
    assert torch.equal(ka, kb)
    for sa, sb in zip(ga, ea):
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))
    assert _window_equal(caches[0], caches[1], eng.cfg.max_seq_len)


def test_bench_kernels_readings_within_the_card(dev):
    """``harness/bench_kernels.py``'s probes at their full shapes: every
    reading positive and at most 105 % of 3.35 TB/s (``_reading`` raises
    above), and the kernel libraries' cache statistics."""
    from xalm_tpu_torch.harness import bench_kernels

    with torch.inference_mode():
        rows = bench_kernels.run(bandwidth=True, bandwidth2=True, kernel="mha")
    assert [r["case"].split(" (")[0] for r in rows] == ["-b HBM read", "-b2 HBM copy", "-k mha"]
    for r in rows:
        assert 0 < r["gb_s"] <= bench_kernels.MAX_SHARE * bench_kernels.HBM_GB_S, r
    stats = build.cache_stats()
    assert set(stats) == {"hits", "misses"} and stats["hits"] + stats["misses"] >= 2


def test_bench_kernels_cli(dev, capsys):
    from xalm_tpu_torch.harness import bench_kernels

    assert bench_kernels.main(["-k", "ffn"]) == 0
    out = capsys.readouterr().out
    assert "-k ffn" in out and "GB/s" in out and "kernel libraries: {'hits'" in out
