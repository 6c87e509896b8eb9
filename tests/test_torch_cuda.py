"""The port's CUDA kernels against their plain PyTorch versions on the card
(moderate shapes, head_dim 128). Every test here needs an NVIDIA GPU and
nvcc and skips without them; run them on the GPU machine with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports jax, which that machine
does not need to have.)

Tolerances are those of ``chip_smoke.py``, each against the max |ref| of
its own output row (a matmul output row, a query head's output):
qmatmul 1e-4 and flash_decode 1e-5 (the same exact f32 products summed in
another order); qmatmul with the norm prologue 1e-3 (the rms summed in
another order can flip the bf16 rounding of a normed activation; one such
flip moved a row by 4e-4 of its max at N=1024); kv_update bit-equal (each product and the sum rounded as
the plain version's separate f32 operations); flash_prefill 2^-8 (the
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
an f32 ulp can flip one such rounding, by 2^-8 of a term that holds a few
hundredths of its row's weight at most here); the megakernel's int8 branch
within 2e-2 as above, and 95 % of the codes within one count.
"""

import dataclasses

import numpy as np
import pytest
import torch

from xalm_tpu_torch.io import write_xalm
from xalm_tpu_torch.models.config import MISTRAL_7B
from xalm_tpu_torch.ops import attention as A
from xalm_tpu_torch.ops import build
from xalm_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain

pytestmark = pytest.mark.cuda

# A small i8 Mistral-style container written by the port alone (no JAX, no
# converter), head_dim 128 so the kernels take it: i8 body with per-row
# scales, bf16 embed and head, a byte-fallback tokenizer.
CONFIG = dict(dim=256, hidden_dim=512, head_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=320, max_seq_len=48, rope_theta=1e4, rotary_dim=128)


def _i8(rng, tensors, name, rows, cols):
    w = rng.normal(size=(rows, cols)).astype(np.float32) * 0.05
    scale = np.abs(w).max(axis=1) / 127.0
    tensors[name] = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    tensors[name + ".scale"] = scale.astype(np.float32)


def write_port_container(path: str, seed: int = 0) -> str:
    c = CONFIG
    rng = np.random.default_rng(seed)
    words = [b"<unk>", b"<s>", b"</s>"] + [b"<0x%02X>" % i for i in range(256)]
    words += [b" hello", b" world", b"he", b"llo"]
    words += [b"w%d" % i for i in range(c["vocab_size"] - len(words))]
    tensors = {"tokenizer.tokens": np.frombuffer(b"\x00".join(words) + b"\x00", np.uint8)}
    d, h, hd = c["dim"], c["hidden_dim"], c["head_dim"]
    for i in range(c["n_layers"]):
        tensors[f"l.{i}.attn.norm.weight"] = (rng.random(d) + 0.5).astype(np.float32)
        _i8(rng, tensors, f"l.{i}.attn.q.weight", c["n_heads"] * hd, d)
        _i8(rng, tensors, f"l.{i}.attn.k.weight", c["n_kv_heads"] * hd, d)
        _i8(rng, tensors, f"l.{i}.attn.v.weight", c["n_kv_heads"] * hd, d)
        _i8(rng, tensors, f"l.{i}.attn.down.weight", d, c["n_heads"] * hd)
        tensors[f"l.{i}.mlp.norm.weight"] = (rng.random(d) + 0.5).astype(np.float32)
        _i8(rng, tensors, f"l.{i}.mlp.gate.weight", h, d)
        _i8(rng, tensors, f"l.{i}.mlp.up.weight", h, d)
        _i8(rng, tensors, f"l.{i}.mlp.down.weight", d, h)
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
        got = A.flash_decode(q, k1, v1, 1, i32(*kvl))
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
    megakernel, or kv_update_q and flash_decode_q once per layer."""
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
        else:
            assert build.LAUNCHES["kv_update_q"] == build.LAUNCHES["flash_decode_q"] == 3 * 64 * 2
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
    bf16_kernels = ("qmatmul", "kv_update", "flash_decode", "flash_prefill", "fused_decode")
    assert all(total[k] > 0 for k in bf16_kernels), total


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
    with pytest.raises(ValueError, match="bf16"):
        call(dtype=torch.float32)
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


@pytest.mark.parametrize("kv_dtype", [torch.float16, torch.float32])
def test_kernel_engine_refuses_a_cache_the_kernels_do_not_take(dev, kv_dtype):
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, dim=256, hidden_dim=512, n_layers=1,
                              vocab_size=64, max_seq_len=32)
    params = synthetic_params(cfg, device=dev, seed=0)
    with pytest.raises(ValueError, match="bf16 cache"):
        Engine(cfg, params, kv_dtype=kv_dtype)
    assert Engine(cfg, params, kv_dtype=kv_dtype, matmul_impl="plain").decode_path(1) == "plain"


def test_kernel_engine_refuses_weights_the_kernel_does_not_take(dev):
    from xalm_tpu_torch.models.params import QWeight
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg = dataclasses.replace(MISTRAL_7B, dim=256, hidden_dim=512, n_layers=1,
                              vocab_size=64, max_seq_len=32)
    params = synthetic_params(cfg, device=dev, seed=0)
    params.wcls = QWeight(params.wcls.values.float(), None)  # an f32 head
    with pytest.raises(ValueError, match="weight dtype"):
        Engine(cfg, params).generate([3, 4, 5], 2, stop_on_eos=False)
    assert len(Engine(cfg, params, matmul_impl="plain").generate([3, 4, 5], 2,
                                                                  stop_on_eos=False)[0]) == 2


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
