#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``xalm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``xalm_tpu_torch/csrc/`` and drives the
port, never the JAX package, through six phases, each printing one JSON line:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: one ``nvcc`` per source, all at once, and the build time;
3. parity: every kernel against its plain PyTorch version at Mistral-7B
   shapes, with its time, the plain version's time, a library call's time
   where one PyTorch call computes the same function, and its bound (the
   larger of bytes over 3.35 TB/s and operations over the peak rate): the
   bf16-cache kernels, the int8-cache kernels (``phase_parity_int8``), the
   whole-step megakernel at full width and 32 layers in three bf16-cache
   and four int8-cache cases, and the cost of one of its grid barriers;
4. main path: ``Engine.generate`` at full Mistral-7B width (32 layers,
   random i8 weights from a seed): a 512-token prompt and 64 greedy tokens,
   every kernel's launch counter set to 0 just before and read just after,
   with a bf16 and with an int8 cache, each on the default decode path (the
   megakernel) and with ``fused_step=False`` (the per-layer kernels), each
   run with a profile of its decode steps;
5. wrap: the same widths at 2 layers and a 256-slot window, 600 decode
   steps through three ring wraps, the kernels against their plain
   versions on the card, on both decode paths (the megakernel with the i8
   head), with a bf16 and with an int8 cache: teacher-forced logits of
   random weights within 1e-2 of max |logits|, and identical free-running
   greedy tokens of a model whose next token attention decides (see
   ``phase_wrap``);
6. the kernels' summary line, then the result line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Any failed phase raises and the script exits non-zero without the result
line. There is no CPU fallback: without a CUDA device it exits 2 at once.
Float32 products in the plain versions run in full f32 (TF32 off for both
matmul and cuDNN).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_BF16 = 989e12  # dense tensor-core FLOP/s
PEAK_F32 = 67e12  # f32 outside the tensor cores
SEED = 1234
DEVICE = "cuda"  # where the phases run; main() goes on only when CUDA is there


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Cases:
    """Parity and timing records of phase 3. Each case is checked row by
    row: the largest |kernel - plain| of a row (a query head's output, an
    output row of a matmul) against ``tol`` times that row's max |plain|,
    so that a row of small values is held to its own scale. ``tol`` 0
    asks for bit-equal results."""

    def __init__(self):
        self.rows: list[dict] = []

    def add(self, kernel: str, case: str, got, want, row: int, tol: float, kernel_fn, plain_fn,
            library_fn, nbytes: float, flops: float, peak: float, extra=None,
            extra_ok: bool = True) -> dict:
        import torch

        got = got.float().reshape(-1, row)
        want = want.float().reshape(-1, row)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{kernel} {case}: non-finite output")
        err_rows = (got - want).abs().amax(dim=1)
        ref_rows = want.abs().amax(dim=1)
        rel = float((err_rows / ref_rows.clamp_min(1e-30)).max())
        err = float(err_rows.max())
        ok = (err == 0.0 if tol == 0.0 else rel <= tol) and extra_ok
        b_ms, b_by = bound(nbytes, flops, peak)
        library_ms, library_error = None, None
        if library_fn is not None:
            try:  # a yardstick only: a library call this torch build lacks is reported
                library_ms = time_ms(library_fn)
            except (RuntimeError, NotImplementedError) as e:
                library_error = str(e).splitlines()[0][:200]
        rec = {
            "phase": "parity", "kernel": kernel, "case": case,
            "max_abs_err": err, "max_abs_ref": float(ref_rows.max()), "max_row_rel_err": rel,
            "tol_row_rel": tol, "ok": ok,
            "kernel_ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn, iters=5),
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_us": b_ms * 1e3,
        }
        if library_error is not None:
            rec["library_error"] = library_error
        rec.update(extra or {})
        emit(rec)
        self.rows.append(rec)
        if not ok:
            raise AssertionError(f"{kernel} {case}: row error {rel} (abs {err}) > tol {tol}, "
                                 f"or a further check failed: {extra}")
        return rec


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not measured"
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": line, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name


def phase_build() -> None:
    from xalm_tpu_torch.ops import build

    t0 = time.perf_counter()
    secs = build.build_all()
    logs = {}
    for name in build.KERNELS:
        log = build.BUILD_DIR / f"{name}.log"
        if log.exists():  # ptxas register / shared-memory / spill report
            logs[name] = [ln.strip() for ln in log.read_text().splitlines()
                          if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": secs,
          "ptxas": logs})


def phase_parity(params, cfg, cases: Cases) -> None:
    import torch
    import torch.nn.functional as F

    from xalm_tpu_torch.ops import attention as A
    from xalm_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    lp = params.layers
    L = cfg.n_layers
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=torch.float32)  # noqa: E731
    norm_w = torch.rand((L, cfg.dim), generator=gen, device=dev) + 0.5

    # ---- kernel 1: layers cycle so every launch streams its weights cold.
    # Tolerance 1e-4 of each output row's max: both sides sum the same
    # exact f32 products of bf16 values, in a different order. With the
    # norm prologue 1e-3: the rms is also summed in another order, which
    # can flip the bf16 rounding of a normed activation (one flip moved a
    # row by 4e-4 of its max at N=1024 in tests/test_torch_cuda.py).
    def mm_case(case, m, qw, use_norm, head=False):
        n = qw.values.shape[-1]
        d = qw.values.shape[-2]
        x = randn(m, n)
        values = qw.values[None] if head else qw.values
        scale = None if qw.scale is None else (qw.scale[None] if head else qw.scale)
        kw = dict(scale=scale)
        if use_norm:
            kw.update(norm_w=norm_w, norm_eps=cfg.norm_eps)
        layers = itertools.cycle(range(values.shape[0]))
        got = qmatmul(x, values, 3 % values.shape[0], **kw)
        want = qmatmul_plain(x, values, 3 % values.shape[0], **kw)
        xb = x.to(torch.bfloat16)
        lib = None
        if head:
            lib = lambda: F.linear(xb, qw.values)  # noqa: E731
        elif not use_norm:
            # bf16 activations x int8 weights with a per-row scale: the
            # int8 weight-only matmul (its scales in the activations' dtype)
            sc16 = scale.to(torch.bfloat16)
            lib_layers = itertools.cycle(range(values.shape[0]))

            def lib():
                i = next(lib_layers)
                return torch._weight_int8pack_mm(xb, values[i], sc16[i])
        elt = values.element_size()
        nbytes = d * n * elt + m * n * 4 + m * d * 4 + (d * 4 if scale is not None else 0) + (
            n * 4 if use_norm else 0)
        cases.add("qmatmul", case, got, want, d, 1e-3 if use_norm else 1e-4,
                  lambda: qmatmul(x, values, next(layers), **kw),
                  lambda: qmatmul_plain(x, values, next(layers), **kw),
                  lib, nbytes, 2.0 * m * n * d, PEAK_BF16)

    mm_case("M=1 wqkv i8, norm prologue + row scale", 1, lp.wqkv, True)
    mm_case("M=1 w13 i8, norm prologue + row scale", 1, lp.w13, True)
    mm_case("M=1 wo i8, row scale", 1, lp.wo, False)
    mm_case("M=1 w2 i8, row scale", 1, lp.w2, False)
    mm_case("M=512 w13 i8, row scale", 512, lp.w13, False)
    mm_case("M=1 head bf16", 1, params.wcls, False, head=True)

    # ---- kernels 2-4 on random bf16 cache planes at the main path's shape
    shape = (L, 1, cfg.n_kv_heads, cfg.max_seq_len, cfg.head_dim)
    ck = randn(*shape).to(torch.bfloat16)
    cv = randn(*shape).to(torch.bfloat16)
    kh, hd, h = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    from xalm_tpu_torch.models.llama import rope_freqs

    cexp_np, sexp_np = A.rope_cos_sin_plus1(rope_freqs(cfg))
    cexp = torch.from_numpy(cexp_np).to(dev)
    sexp = torch.from_numpy(sexp_np).to(dev)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731

    for case, kvp, rot in (("insert at a wrapped row + sink rotation", 1000, 1),
                           ("sentinel row (dropped) without rotation", cfg.max_seq_len, 0)):
        kn, vn = randn(1, kh, hd), randn(1, kh, hd)
        k1, v1, k2, v2 = ck[5 % L].clone(), cv[5 % L].clone(), ck[5 % L].clone(), cv[5 % L].clone()
        args = (kn, vn, i32(kvp), i32(rot), cexp, sexp)
        A.kv_update(k1[None], v1[None], 0, *args)
        A.kv_update_plain(k2[None], v2[None], 0, *args)
        got = torch.cat([k1.flatten(), v1.flatten()])
        want = torch.cat([k2.flatten(), v2.flatten()])
        layers = itertools.cycle(range(L))
        nbytes = 2 * kh * hd * 4 + 2 * kh * hd * 2 + (2 * 2 * kh * 2 * hd * rot)
        # bit-equal: the kernel rounds each product and the sum as the
        # plain version's separate f32 operations do
        cases.add("kv_update", case, got, want, hd, 0.0,
                  lambda: A.kv_update(ck, cv, next(layers), *args),
                  lambda: A.kv_update_plain(ck, cv, next(layers), *args),
                  None, nbytes, 0.0, PEAK_F32)

    for kvl in (0, 1, 777, cfg.max_seq_len):
        q = randn(1, h, hd)
        kv_len = i32(kvl)
        got = A.flash_decode(q, ck, cv, 7 % L, kv_len)
        want = A.flash_decode_plain(q, ck, cv, 7 % L, kv_len)
        if kvl == 0 and not bool((got == 0).all()):
            raise AssertionError("flash_decode: kv_len == 0 must give 0")
        layers = itertools.cycle(range(L))
        lib = None
        if kvl > 0:
            qb = q.to(torch.bfloat16)[:, :, None]  # (B, H, 1, hd)

            def lib(kvl=kvl, qb=qb):
                return F.scaled_dot_product_attention(
                    qb, ck[7 % L, :, :, :kvl], cv[7 % L, :, :, :kvl], enable_gqa=True)
        # f32 dots and softmax on both sides, in a different order
        cases.add("flash_decode", f"B=1 kv_len={kvl}", got, want, hd, 1e-5,
                  lambda: A.flash_decode(q, ck, cv, next(layers), kv_len),
                  lambda: A.flash_decode_plain(q, ck, cv, next(layers), kv_len),
                  lib, 2 * kvl * kh * hd * 2 + 2 * h * hd * 4, 4.0 * h * kvl * hd, PEAK_F32)

    t = 512
    for p0 in (0, 1024):
        q = randn(1, t, h, hd)
        pos = i32(p0)
        got = A.flash_prefill(q, ck, cv, 9 % L, pos)
        want = A.flash_prefill_plain(q, ck, cv, 9 % L, pos)
        layers = itertools.cycle(range(L))
        qb = q.to(torch.bfloat16).transpose(1, 2)  # (B, H, T, hd)
        kend = p0 + t
        mask = (torch.arange(kend, device=dev)[None, :]
                <= (p0 + torch.arange(t, device=dev))[:, None])

        def lib(kend=kend, qb=qb, mask=mask):
            return F.scaled_dot_product_attention(
                qb, ck[9 % L, :, :, :kend], cv[9 % L, :, :, :kend], attn_mask=mask, enable_gqa=True)
        visible = sum(p0 + i + 1 for i in range(t))
        # the plain version copies the kernel's 64-key tiling, so p is
        # rounded to bf16 at the same running max. The f32 sums of the
        # exact bf16 products differ in order; a score that moves by an f32
        # ulp can flip one bf16 rounding of p, by 2^-8 of a p that may
        # dominate its row: 2^-8 of the row's max
        cases.add("flash_prefill", f"T={t} pos={p0}", got, want, hd, 2.0 ** -8,
                  lambda: A.flash_prefill(q, ck, cv, next(layers), pos),
                  lambda: A.flash_prefill_plain(q, ck, cv, next(layers), pos),
                  lib, 2 * kend * kh * hd * 2 + 2 * t * h * hd * 4,
                  4.0 * visible * h * hd, PEAK_BF16)
    del ck, cv
    torch.cuda.empty_cache()
    phase_parity_int8(cfg, cases, gen, cexp, sexp)


# why no library call stands beside the int8-cache kernels
NO_LIBRARY_INT8 = "no one PyTorch call attends over (or writes) int8 codes with per-row scales"


def phase_parity_int8(cfg, cases: Cases, gen, cexp, sexp) -> None:
    """Kernels 5-7 on random int8 planes (codes in [-127, 127], scales in
    [0, 0.02)) at the main path's shape.

    kv_update_q: codes and scales bit-equal to the plain version (absmax is
    order-free; scale and codes by IEEE division, rounded half to even on
    both sides), in three cases: a mid-ring insert, a wrapped insert with
    sink rotation, B = 3 with a row at the kv_pos == S sentinel.

    flash_decode_q: 1e-3 of each output row's max. The plain version copies
    the kernel's 128-row chunks, so p * v_scale is rounded to bf16 at the
    same chunk max; the scores are f32 sums of exact products in another
    order, and a score that moves by an f32 ulp can flip one bf16 rounding
    of p * v_scale, by 2^-8 of a term that holds a few hundredths of its
    row's softmax weight at most with these inputs: under 1e-3."""
    import torch

    from xalm_tpu_torch.ops import attention as A

    dev = torch.device(DEVICE)
    L, kh, hd, h, S = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, cfg.max_seq_len
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731

    def planes(b):
        shape = (L, b, kh, S, hd)
        codes = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 for _ in range(2)]
        return codes + scales

    for case, kv_pos, rot in (("mid-ring insert", (519,), (0,)),
                              ("wrapped insert + sink rotation", (1000,), (1,)),
                              ("B=3, row 1 at the kv_pos == S sentinel, row 2 rotating",
                               (300, S, 2000), (0, 0, 1))):
        b = len(kv_pos)
        full = planes(b)
        kn = torch.randn((b, kh, hd), generator=gen, device=dev)
        vn = torch.randn((b, kh, hd), generator=gen, device=dev)
        args = (kn, vn, i32(*kv_pos), i32(*rot), cexp, sexp)
        one = [t[5 % L][None] for t in full]
        p1, p2 = [t.clone() for t in one], [t.clone() for t in one]
        A.kv_update_q(*p1, 0, *args)
        A.kv_update_q_plain(*p2, 0, *args)
        got = torch.cat([t.float().flatten() for t in p1])
        want = torch.cat([t.float().flatten() for t in p2])
        layers = itertools.cycle(range(L))
        written = sum(kp < S for kp in kv_pos)
        nbytes = 2 * b * kh * hd * 4 + written * 2 * kh * (hd + 4) + 2 * sum(rot) * kh * 2 * (hd + 4)
        cases.add("kv_update_q", case, got, want, hd, 0.0,
                  lambda: A.kv_update_q(*full, next(layers), *args),
                  lambda: A.kv_update_q_plain(*full, next(layers), *args),
                  None, nbytes, 0.0, PEAK_F32, extra={"library_note": NO_LIBRARY_INT8})
        del full, one, p1, p2

    full = planes(1)
    for kvl in (1, 520, 777, S):
        q = torch.randn((1, h, hd), generator=gen, device=dev)
        kv_len = i32(kvl)
        got = A.flash_decode_q(q, *full, 7 % L, kv_len)
        want = A.flash_decode_q_plain(q, *full, 7 % L, kv_len)
        layers = itertools.cycle(range(L))
        cases.add("flash_decode_q", f"B=1 kv_len={kvl}", got, want, hd, 1e-3,
                  lambda: A.flash_decode_q(q, *full, next(layers), kv_len),
                  lambda: A.flash_decode_q_plain(q, *full, next(layers), kv_len),
                  None, 2 * kvl * kh * (hd + 4) + 2 * h * hd * 4, 4.0 * h * kvl * hd, PEAK_F32,
                  extra={"library_note": NO_LIBRARY_INT8})
    del full
    torch.cuda.empty_cache()


# megakernel parity (phase 3), each output row against its own max |plain|.
# Kernel and plain version sum the same exact products in another order, so
# an f32 ulp of difference can flip the bf16 rounding of one activation
# (2^-8 of it) before a matmul. One flipped normed activation moves the
# next x by far more than f32 rounding, and 32 layers carry such flips on,
# so the plain version is just as far from itself when only the order of
# its sums changes. Each case measures that floor: the plain version on the
# model with its residual dimension permuted (on the H100, 1.0-1.5e-2 of
# max |x| at 32 layers, the kernel 1.2-1.8e-2). x, the logits and each
# cache row (hd values) within FUSED_TOL of their max; x also within
# FUSED_FLOOR_RATIO times its floor (or 1e-3); 95 % of the cache values
# within one bf16 ulp; the token equal wherever the plain top-2 margin is
# above twice FUSED_TOL of max |logits|, and always the argmax of the
# kernel's logits.
FUSED_TOL = 5e-2
FUSED_FLOOR_RATIO = 4.0
FUSED_ULP_SHARE = 0.95


def _row_rel(got, want, row: int) -> float:
    got, want = got.float().reshape(-1, row), want.float().reshape(-1, row)
    err = (got - want).abs().amax(dim=1)
    return float((err / want.abs().amax(dim=1).clamp_min(1e-30)).max())


def _ulp_share(got, want) -> float:
    """Share of the values of a bf16 tensor within one bf16 ulp of want."""
    import torch

    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((g - w).abs() <= ulp).float().mean())


def _model_dim_permuted(p, perm):
    """The same model with its residual dimension permuted by ``perm``: each
    matmul over the model dimension, and each rms, sums its terms in another
    order; x comes out permuted. (embed, norms, wqkv, w13 and the head by
    column; wo and w2 by output row.)"""
    from xalm_tpu_torch.models.params import QWeight

    def cols(w):
        return QWeight(w.values[..., perm].contiguous(), w.scale)

    def rows(w):
        return QWeight(w.values[:, perm].contiguous(), w.scale[:, perm].contiguous())

    lp = p.layers
    layers = dataclasses.replace(lp, attn_norm=lp.attn_norm[:, perm], mlp_norm=lp.mlp_norm[:, perm],
                                 wqkv=cols(lp.wqkv), w13=cols(lp.w13), wo=rows(lp.wo), w2=rows(lp.w2))
    return dataclasses.replace(p, embed=cols(p.embed), layers=layers, out_norm=p.out_norm[perm],
                               wcls=cols(p.wcls))


def _code_share(got, want) -> float:
    """Share of the codes of an int8 plane within one count of want."""
    return float(((got.int() - want.int()).abs() <= 1).float().mean())


def _dequant(codes, scales):
    return codes.float() * scales[..., None]


def phase_fused_parity(params, cfg, cases: Cases) -> dict:
    """The megakernel against its plain version at full width and 32 layers
    (random planes). bf16 cache, three cases: (a) B=1 at kv_len 520 with the
    embed fold; (b) B=1 at a wrapped position (sink rotation) with the embed
    and i8-head folds; (c) B=4 with one row at the kv_pos == S sentinel.
    int8 cache (codes and scales as in phase_parity_int8), four cases: B=1
    at kv_len 520 (embed fold) and 4000 (embed and i8-head folds); B=4 at
    kv_len 520 with a sentinel row; B=4 at kv_len 520, 4000, a wrapped row
    (sink rotation) and a sentinel row. The int8 cases hold the dequantised
    cache rows to FUSED_TOL and FUSED_ULP_SHARE of the codes to one count
    (the limits of the bf16 rows and values). Then the cost of one grid
    barrier on the kernel's grid."""
    import torch

    from xalm_tpu_torch.models.llama import rope_constants, rope_tables
    from xalm_tpu_torch.models.params import recode_wcls_i8
    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.ops import fused_decode as fd
    from xalm_tpu_torch.runtime.cache import KVCache, ring_indices

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    L, S, N = cfg.n_layers, cfg.max_seq_len, cfg.dim
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    freqs, c1, s1 = rope_constants(cfg, dev)
    freqs_h = rope_constants(cfg, torch.device("cpu"))[0]
    head_params = recode_wcls_i8(params)
    lp = params.layers
    w_elems = sum(w.values.numel() for w in (lp.wqkv, lp.wo, lp.w13, lp.w2))
    w_bytes = w_elems + 4 * sum(w.scale.numel() for w in (lp.wqkv, lp.wo, lp.w13, lp.w2)) + 8 * L * N

    for quant, case, pos_list, embed, head, sentinel in (
            (False, "B=1 kv_len=520, embed fold", [519], True, False, None),
            (False, "B=1 wrapped (sink rotation), embed + i8-head folds", [S + 700], True, True,
             None),
            (False, "B=4, row 2 at the kv_pos == S sentinel", [519, 1200, 300, S + 5], False,
             False, 2),
            (True, "int8 KV, B=1 kv_len=520, embed fold", [519], True, False, None),
            (True, "int8 KV, B=1 kv_len=4000, embed + i8-head folds", [3999], True, True, None),
            (True, "int8 KV, B=4 kv_len=520, row 3 at the sentinel", [519] * 4, False, False, 3),
            (True, "int8 KV, B=4 kv_len 520/4000/wrapped, row 3 at the sentinel",
             [519, 3999, S + 700, 300], False, False, 3)):
        b = len(pos_list)
        p = head_params if head else params
        pos = torch.tensor(pos_list, dtype=torch.int32)
        _, kv_pos, kv_len = ring_indices(pos, S)
        rot = (pos >= S).to(torch.int32)
        if sentinel is not None:
            kv_pos[sentinel], rot[sentinel] = S, 0
        shape = KVCache.plane_shape(cfg, b)
        if quant:
            ck, cv = (torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                      for _ in range(2))
            ks, vs = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 for _ in range(2))
        else:
            ck = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            cv = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            ks = vs = None
        tok = torch.randint(3, cfg.vocab_size, (b,), generator=gen, device=dev).cpu()
        kw = dict(wcls=p.wcls, out_norm=p.out_norm) if head else {}
        if embed:
            kw.update(embed=p.embed, token=tok, pos=pos, freqs=freqs)
            x0 = ce = se = None
        else:
            x0 = p.embed.values[tok.to(dev)].float()
            ce, se = (z[:, 0, 0] for z in rope_tables(pos[:, None], freqs_h))

        def args(k, v, x0=x0, ce=ce, se=se, p=p, kv_pos=kv_pos, kv_len=kv_len, rot=rot):
            return (p, cfg, x0, k, v, kv_pos, kv_len, rot, ce, se, c1, s1)

        def scales(kw, ks=ks, vs=vs):
            """kw with fresh copies of the scale planes (int8 cache)"""
            return dict(kw, k_scale=ks.clone(), v_scale=vs.clone()) if quant else kw

        k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        kw1, kw2 = scales(kw), scales(kw)
        got = fd.fused_decode_step(*args(k1, v1), **kw1)
        want = fd.fused_decode_step_plain(*args(k2, v2), **kw2)
        # the floor: the plain version against itself on the permuted model
        perm = torch.randperm(N, generator=gen, device=dev)
        q = _model_dim_permuted(p, perm)
        q_kw = dict(kw, **(dict(wcls=q.wcls, out_norm=q.out_norm) if head else {}),
                    **(dict(embed=q.embed) if embed else {}))
        k3, v3 = ck.clone(), cv.clone()
        kw3 = scales(q_kw)
        floor = list(fd.fused_decode_step_plain(
            q, cfg, None if x0 is None else x0[:, perm], *args(k3, v3)[3:], **kw3))
        floor[0] = floor[0][:, torch.argsort(perm)]
        del q, q_kw
        torch.cuda.synchronize()
        x_rel, x_floor = _row_rel(got[0], want[0], N), _row_rel(floor[0], want[0], N)
        extra = {"batch": b, "positions": pos_list, "kv_len": kv_len.tolist(),
                 "x_floor_row_rel": x_floor}
        if quant:  # the dequantised rows, and the codes within one count
            rows = {n: _dequant(c, sc) for n, c, sc in (
                ("k1", k1, kw1["k_scale"]), ("v1", v1, kw1["v_scale"]),
                ("k2", k2, kw2["k_scale"]), ("v2", v2, kw2["v_scale"]),
                ("k3", k3, kw3["k_scale"]), ("v3", v3, kw3["v_scale"]))}
            extra.update({
                "cache_k_row_rel": _row_rel(rows["k1"], rows["k2"], hd),
                "cache_v_row_rel": _row_rel(rows["v1"], rows["v2"], hd),
                "cache_k_floor_row_rel": _row_rel(rows["k3"], rows["k2"], hd),
                "cache_v_floor_row_rel": _row_rel(rows["v3"], rows["v2"], hd),
                "cache_ulp_share": min(_code_share(k1, k2), _code_share(v1, v2)),
                "code_equal_share": min(float((k1 == k2).float().mean()),
                                        float((v1 == v2).float().mean())),
                "code_floor_share": min(_code_share(k3, k2), _code_share(v3, v2))})
            del rows
        else:
            extra.update({
                "cache_k_row_rel": _row_rel(k1, k2, hd), "cache_v_row_rel": _row_rel(v1, v2, hd),
                "cache_k_floor_row_rel": _row_rel(k3, k2, hd),
                "cache_v_floor_row_rel": _row_rel(v3, v2, hd),
                "cache_ulp_share": min(_ulp_share(k1, k2), _ulp_share(v1, v2))})
        if sentinel is not None:  # the dropped row: every attended slot as it was
            extra["sentinel_row_unchanged"] = bool(
                torch.equal(k1[:, sentinel, :, :S], ck[:, sentinel, :, :S])
                and torch.equal(v1[:, sentinel, :, :S], cv[:, sentinel, :, :S])
                and (not quant or torch.equal(kw1["k_scale"][:, sentinel, :, :S],
                                              ks[:, sentinel, :, :S])))
        ok = (x_rel <= max(FUSED_FLOOR_RATIO * x_floor, 1e-3)  # 1e-3: a floor of no flip at all
              and extra["cache_k_row_rel"] <= FUSED_TOL and extra["cache_v_row_rel"] <= FUSED_TOL
              and extra["cache_ulp_share"] >= FUSED_ULP_SHARE and extra.get("sentinel_row_unchanged", True))
        row_bytes = hd + 4 if quant else 2 * hd  # int8 codes + scale, or bf16
        nbytes = w_bytes + b * N * (2 if embed else 4) + b * N * 4
        nbytes += 2 * L * kh * row_bytes * (int(kv_len.sum()) + b)  # cache rows read, rows written
        nbytes += 2 * L * kh * 2 * row_bytes * int(rot.sum())  # K sinks read and written
        flops = 2.0 * b * w_elems + 4.0 * L * cfg.n_heads * hd * int(kv_len.sum())
        if head:
            v_ = p.wcls.values.shape[0]
            nbytes += v_ * N + v_ * 4 + N * 4 + b * v_ * 4 + b * 4
            flops += 2.0 * b * v_ * N
            extra["logits_row_rel"] = _row_rel(got[1], want[1], v_)
            extra["logits_floor_row_rel"] = _row_rel(floor[1], want[1], v_)
            top2 = want[1].topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * FUSED_TOL * want[1].abs().amax(dim=-1)
            extra["token_equal"] = bool(torch.equal(got[2][clear], want[2][clear]))
            extra["token_is_argmax"] = bool(torch.equal(got[2], got[1].argmax(dim=-1).to(torch.int32)))
            ok = ok and extra["logits_row_rel"] <= FUSED_TOL and extra["token_equal"] \
                and extra["token_is_argmax"]
        cases.add("fused_decode", case, got[0], want[0], N, FUSED_TOL,
                  lambda a=args(ck, cv), kw=scales(kw): fd.fused_decode_step(*a, **kw),
                  lambda a=args(ck, cv), kw=scales(kw): fd.fused_decode_step_plain(*a, **kw),
                  None, nbytes, flops, PEAK_BF16, extra=extra, extra_ok=ok)
        del ck, cv, ks, vs, k1, v1, k2, v2, k3, v3, kw1, kw2, kw3, got, want, floor
        torch.cuda.empty_cache()

    lib = build.load_library("fused_decode")
    bar = torch.zeros((256,), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    iters = 4000
    build.check(lib.xq_grid_barrier_bench(bar.data_ptr(), 10, stream), "grid barrier")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    build.check(lib.xq_grid_barrier_bench(bar.data_ptr(), iters, stream), "grid barrier")
    end.record()
    end.synchronize()
    row = {"phase": "megakernel", "grid_blocks": lib.xq_fused_decode_grid(),
           "sms": torch.cuda.get_device_properties(dev).multi_processor_count,
           "barrier_us": start.elapsed_time(end) / iters * 1e3,
           "barriers_per_step": 1 + 7 * L, "barriers_per_step_head_fold": 2 + 7 * L}
    emit(row)
    return row


def _main_run(eng, cfg, prompt, label: str) -> dict:
    """One main-path run: warm up, then ``Engine.generate`` of a 512-token
    prompt and 64 greedy tokens with every launch counter set to 0 just
    before and read just after; the launches of one 512-token prefill chunk
    and of one decode step; the profile of the decode steps."""
    import numpy as np
    import torch

    from xalm_tpu_torch.ops import build

    eng.generate(prompt[:32], 2, stop_on_eos=False)  # warm-up (allocator, first launches)
    torch.cuda.synchronize()

    build.reset_launches()
    out, stats = eng.generate(prompt, 64, stop_on_eos=False)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if len(out) != 64:
        raise AssertionError(f"{label}: generated {len(out)} tokens, expected 64")

    # launches per 512-token prefill chunk and per decode token
    build.reset_launches()
    cache = eng.new_cache(1)
    logits, cache, pos = eng.prefill(prompt, cache)
    per_chunk = dict(build.LAUNCHES)
    build.reset_launches()
    logits2, _ = eng.decode(np.array([out[-1]]), np.array([pos], np.int32), cache)
    per_token = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    for lg in (logits, logits2):
        if lg.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all():
            raise AssertionError(f"{label}: main path logits are not finite (1, vocab)")
    prof = phase_profile(eng, prompt, out[-1], label)
    weights_gb = eng.active_bytes(len(prompt)) / 1e9
    row = {
        "phase": "main_path", "run": label, "layers": cfg.n_layers, "dim": cfg.dim,
        "hidden": cfg.hidden_dim, "vocab": cfg.vocab_size, "window": cfg.max_seq_len,
        "kv_dtype": str(eng.kv_dtype).split(".")[-1], "cache_bytes": cache.nbytes(),
        "prompt_tokens": len(prompt), "generated_tokens": stats.generated_tokens,
        "decode_path": eng.decode_path(1),
        "prefill_s": stats.prefill_s, "prefill_tok_s": len(prompt) / stats.prefill_s,
        "decode_s": stats.decode_s, "decode_tok_s": stats.tok_per_s,
        "decode_ms_per_token": stats.decode_s / stats.generated_tokens * 1e3,
        "decode_gb_s": stats.bandwidth_gb_s,
        "hbm_share": stats.bandwidth_gb_s * 1e9 / HBM_BYTES_PER_S,
        "active_gb_per_token": weights_gb,
        "bound_ms_per_token": weights_gb * 1e9 / HBM_BYTES_PER_S * 1e3,
        "launches": launches, "launches_per_512_chunk": per_chunk,
        "launches_per_decode_token": per_token,
        "decode_device_busy_ms_per_token": prof["decode"]["device_busy_ms"] / prof["decode"]["steps"],
        "decode_device_idle_share": prof["decode"]["device_idle_share"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tokens_head": out[:8],
    }
    emit(row)
    return row


def phase_main(params, cfg) -> dict:
    """The main path four times: with a bf16 cache and with an int8 cache
    (``kv_dtype=torch.int8``, per-row scales), each on the default decode
    path (the megakernel: one fused_decode launch per decode token) and with
    ``fused_step=False`` (the per-layer kernels: per token 129 qmatmul
    launches, and per layer kv_update and flash_decode, or kv_update_q and
    flash_decode_q). Every kernel of the port must launch in one of the
    runs. Returns the launches of the runs, summed."""
    import numpy as np
    import torch

    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(SEED).integers(3, cfg.vocab_size, size=512).tolist()
    L = cfg.n_layers
    launches = dict.fromkeys(build.LAUNCHES, 0)
    for kv, tag in ((torch.bfloat16, ""), (torch.int8, "int8 ")):
        per_layer = ("kv_update_q", "flash_decode_q") if kv == torch.int8 else (
            "kv_update", "flash_decode")
        for path, kw, want in (
                ("megakernel", {}, {"fused_decode": 1}),
                ("perlayer", dict(fused_step=False), {"qmatmul": 4 * L + 1, per_layer[0]: L,
                                                      per_layer[1]: L, "fused_decode": 0})):
            eng = Engine(cfg, params, kv_dtype=kv, **kw)  # kernels; megakernel decode by default
            if eng.decode_path(1) != path:
                raise AssertionError(f"decode path {eng.decode_path(1)!r}, expected {path!r}")
            row = _main_run(eng, cfg, prompt, tag + path)
            per_token = row["launches_per_decode_token"]
            if any(per_token[k] != n for k, n in want.items()) or (
                    path == "megakernel" and row["launches"]["fused_decode"] != 63):
                raise AssertionError(f"{tag}{path} run: {row['launches']}, per token {per_token}: "
                                     f"expected per token {want}")
            launches = {k: launches[k] + row["launches"][k] for k in launches}
            del eng
            torch.cuda.empty_cache()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return {"launches": launches}


# kernel-name fragments of the port's CUDA kernels, by wrapper (the chunk
# combine kernel, shared by both flash-decodes, goes to the one the run uses)
_PROFILE_GROUPS = {
    "qmatmul": ("gemv_kernel", "gemm_kernel", "prep_x_kernel"),
    "kv_update": ("kv_update_kernel",),
    "flash_decode": ("flash_decode_split_kernel", "flash_decode_combine_kernel"),
    "flash_prefill": ("flash_prefill_kernel",),
    "fused_decode": ("fused_decode_kernel",),
    "kv_update_q": ("kv_update_q_kernel",),
    "flash_decode_q": ("flash_decode_q_split_kernel",),
}


def _device_times(prof, int8: bool) -> tuple[dict, list]:
    """Device time (ms) by kernel group, and the ten largest device entries
    as (name, ms, count), from a torch.profiler run. Only the kernels' own
    entries count: a PyTorch operator's entry carries the device time of the
    kernels it launched, which those kernels' entries carry too."""
    from torch.autograd import DeviceType

    groups = dict(_PROFILE_GROUPS)
    if int8:
        groups["flash_decode"] = ("flash_decode_split_kernel",)
        groups["flash_decode_q"] += ("flash_decode_combine_kernel",)
    out = {k: 0.0 for k in groups}
    out["other"] = 0.0
    top = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if not us:
            continue
        group = next((g for g, frags in groups.items()
                      if any(f in evt.key for f in frags)), "other")
        out[group] += us / 1e3
        top.append((evt.key[:80], us / 1e3, evt.count))
    return out, sorted(top, key=lambda r: -r[1])[:10]


def phase_profile(eng, prompt, token, label: str) -> dict:
    """torch.profiler over one 512-token prefill and 8 decode steps: device
    time by kernel, wall time, and the device's idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rows = {}
    cache = eng.new_cache(1)
    for name, steps in (("prefill_512", 0), ("decode", 8)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if steps == 0:
                _, cache, pos = eng.prefill(prompt, cache)
            for i in range(steps):
                _, cache = eng.decode(np.array([token]), np.array([pos + i], np.int32), cache)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev, top = _device_times(prof, eng.kv_dtype == torch.int8)
        busy = sum(dev.values())
        rows[name] = {
            "steps": max(steps, 1), "wall_ms": wall_ms, "device_ms": dev, "top": top,
            "device_busy_ms": busy,
            "device_idle_share": (1.0 - busy / wall_ms) if busy > 0 else "not measured",
        }
    emit({"phase": "profile", "run": label, **rows})
    return rows


WRAP_TOL = 1e-2  # teacher-forced |logits kernel - plain| / max |logits plain|


def _teacher_forced(ek, ep, prompt, steps: int) -> dict:
    """Prefill, then ``steps`` decode steps of the kernel engine ``ek`` and
    the plain engine ``ep``, both fed the kernel engine's greedy token:
    the largest logit difference of any step over that step's max
    |logits|, and the steps whose argmax differs (reported; they are
    bounded by the logit limit, which allows a flip only where the top-2
    margin is under twice the limit)."""
    import numpy as np

    lk, ck, pos = ek.prefill(prompt, ek.new_cache(1))
    lp, cp, _ = ep.prefill(prompt, ep.new_cache(1))
    worst, flips = 0.0, 0
    for i in range(steps + 1):
        worst = max(worst, float((lk - lp).abs().max()) / float(lp.abs().max()))
        tk = int(lk.argmax())
        flips += tk != int(lp.argmax())
        if i == steps:
            break
        lk, ck = ek.decode(np.array([tk]), np.array([pos], np.int32), ck)
        lp, cp = ep.decode(np.array([tk]), np.array([pos], np.int32), cp)
        pos += 1
    return {"steps": steps, "final_pos": pos, "max_rel_logit_err": worst, "argmax_flips": flips}


def _ring_wraps(final_pos: int, window: int) -> int:
    """Ring wraps passed by the time a run reaches final_pos: the ring
    first fills at the window, then every window - KV_SINKS positions."""
    from xalm_tpu_torch.models.config import KV_SINKS

    return 0 if final_pos <= window else 1 + (final_pos - window - 1) // (window - KV_SINKS)


def copy_params(cfg, seed: int):
    """Weights of a model whose greedy output is decided by attention: the
    token after position i is ``perm_inv[token at i - 1]``, read through
    the cache. Returns (params, perm_inv).

    Layer 0 holds one working head (q head 0 on kv head 0); every other
    weight is zero. The embedding of token t is [code_t | 1 ... 1 | 0 ...]
    (code_t: hd random signs), so after the norm its second hd lanes are a
    constant xc. From those lanes q = a R(-1) c and k = a c, with c
    nonzero in the six fastest rope pairs: under the interleaved-pair rope
    the score of key j for query i is a^2 sum_p |c_p|^2 cos((j - i + 1)
    theta_p), peaked at j = i - 1 by 200 nats over any other key of a
    256-slot window (at least 0.26 of the peak lower for offsets up to
    260). v is code_t, wo writes it to the third hd lanes, and the head's
    row t holds code_perm[t] there, so the logit of t is code_perm[t] .
    code_prev: 128 for the right token, about 50 at most for the others."""
    import numpy as np
    import torch

    from xalm_tpu_torch.models.llama import rope_freqs
    from xalm_tpu_torch.models.params import LayerParams, ModelParams, QWeight

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L, d, vocab, hd = cfg.n_layers, cfg.dim, cfg.vocab_size, cfg.head_dim
    g, kh = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads
    code = torch.randint(0, 2, (vocab, hd), generator=gen, device=dev).float() * 2 - 1
    perm = torch.randperm(vocab, generator=gen, device=dev)
    perm_inv = torch.empty_like(perm)
    perm_inv[perm] = torch.arange(vocab, device=dev)

    embed = torch.zeros((vocab, d), dtype=torch.bfloat16, device=dev)
    embed[:, :hd] = code
    embed[:, hd:2 * hd] = 1.0
    wcls = torch.zeros_like(embed)
    wcls[:, 2 * hd:3 * hd] = code[perm]

    xc = 1.0 / math.sqrt(2 * hd / d + cfg.norm_eps)  # the normed constant lanes
    theta = rope_freqs(cfg).astype(np.float64)
    w = 0.8 ** np.arange(6)
    amp = math.sqrt(200.0 * math.sqrt(hd) / w.sum())  # peak score 200 after 1/sqrt(hd)
    c = np.zeros(hd)
    q0 = np.zeros(hd)
    c[0:12:2] = amp * np.sqrt(w)
    q0[0:12:2] = amp * np.sqrt(w) * np.cos(theta[:6])  # R(-theta) applied to (c_p, 0)
    q0[1:12:2] = -amp * np.sqrt(w) * np.sin(theta[:6])

    wqkv = torch.zeros((kh * (g + 2) * hd, d), dtype=torch.float64)
    wo = torch.zeros((d, cfg.q_dim), dtype=torch.float64)
    lanes = torch.arange(hd)
    wqkv[lanes, hd + lanes] = torch.from_numpy(q0 / xc)  # q head 0
    wqkv[g * hd + lanes, hd + lanes] = torch.from_numpy(c / xc)  # k of kv head 0
    wqkv[(g + 1) * hd + lanes, lanes] = 1.0 / xc  # v of kv head 0: code_t
    wo[2 * hd + lanes, lanes] = 1.0

    def i8(layer0: torch.Tensor) -> QWeight:
        """Stack (L, D, N) with layer0 first and zero layers after; one
        nonzero per row, so the per-row absmax code is exact."""
        scale = layer0.abs().amax(dim=1) / 127.0
        scale = torch.where(scale > 0, scale, torch.full_like(scale, 1.0 / 127.0))
        q = torch.zeros((L, *layer0.shape), dtype=torch.int8, device=dev)
        q[0] = torch.round(layer0 / scale[:, None]).to(torch.int8).to(dev)
        s = torch.full((L, layer0.shape[0]), 1.0 / 127.0, dtype=torch.float32, device=dev)
        s[0] = scale.to(torch.float32).to(dev)
        return QWeight(q, s)

    def zeros(rows, cols) -> QWeight:
        return QWeight(torch.zeros((L, rows, cols), dtype=torch.int8, device=dev),
                       torch.ones((L, rows), dtype=torch.float32, device=dev))

    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)  # noqa: E731
    layers = LayerParams(attn_norm=ones(L, d), wqkv=i8(wqkv), wo=i8(wo), mlp_norm=ones(L, d),
                         w13=zeros(2 * cfg.hidden_dim, d), w2=zeros(d, cfg.hidden_dim))
    params = ModelParams(embed=QWeight(embed, None), layers=layers, out_norm=ones(d),
                         wcls=QWeight(wcls, None))
    return params, perm_inv.tolist()


def phase_wrap(cfg) -> list[dict]:
    """The kernels against their plain versions through three ring wraps,
    at the main path's widths with 2 layers and a 256-slot window (a
    200-token prompt, 600 decode steps), with a bf16 and with an int8 cache,
    on each decode path: the per-layer kernels (``fused_step=False`` on both
    engines) and the megakernel with the i8 head (``wcls_i8=True`` on both:
    the plain engine runs the megakernel's plain version):

    (a) random weights, teacher-forced: the logits of every step within
        WRAP_TOL of that step's max |logits|;
    (b) the copy model (``copy_params``), free-running greedy: the kernel
        run's and the plain run's 601 tokens are identical, and both equal
        the recurrence token[i + 1] = perm_inv[token[i - 1]], which holds
        only if each step's attention finds the previous token's row in
        the ring. Its head rows are +-1, so the i8 recode is exact; with an
        int8 cache its V rows (+-1) quantise exactly and its K rows to 1/254
        of their max, which moves a 200-nat score peak by about a nat."""
    import numpy as np
    import torch

    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    cfg2 = dataclasses.replace(cfg, n_layers=2, max_seq_len=256)
    steps = 600
    prompt = np.random.default_rng(SEED + 1).integers(3, cfg.vocab_size, size=200).tolist()
    rows = []
    paths = (("perlayer", dict(fused_step=False)), ("megakernel", dict(wcls_i8=True)))
    for kv, (path, kw) in itertools.product((torch.bfloat16, torch.int8), paths):
        def engines(params, kw=kw, kv=kv):
            return (Engine(cfg2, params, kv_dtype=kv, matmul_impl="kernel", **kw),
                    Engine(cfg2, params, kv_dtype=kv, matmul_impl="plain", **kw))

        params = synthetic_params(cfg2, device=DEVICE, seed=SEED + 1)
        ek, ep = engines(params)
        if ek.decode_path(1) != path:
            raise AssertionError(f"wrap phase: decode path {ek.decode_path(1)!r}, expected {path!r}")
        forced = _teacher_forced(ek, ep, prompt, steps)
        del params, ek, ep

        params, perm_inv = copy_params(cfg2, SEED + 2)
        expected = list(prompt)
        for _ in range(steps + 1):
            expected.append(perm_inv[expected[-2]])
        expected = expected[len(prompt):]
        ek, ep = engines(params)
        got_k, _ = ek.generate(prompt, steps + 1, stop_on_eos=False)
        got_p, _ = ep.generate(prompt, steps + 1, stop_on_eos=False)
        final_pos = len(prompt) + steps
        copy = {"steps": steps, "final_pos": final_pos,
                "kernel_equal_recurrence": sum(a == b for a, b in zip(got_k, expected)),
                "plain_equal_recurrence": sum(a == b for a, b in zip(got_p, expected)),
                "kernel_equal_plain": sum(a == b for a, b in zip(got_k, got_p)),
                "distinct_tokens": len(set(got_k)), "tokens_head": got_k[:8]}
        row = {"phase": "wrap", "decode_path": path, "kv_dtype": str(kv).split(".")[-1],
               "layers": 2, "window": 256,
               "prompt_tokens": len(prompt), "ring_wraps": _ring_wraps(final_pos, 256),
               "tol_rel": WRAP_TOL, "random_teacher_forced": forced, "copy_free_running": copy,
               "tokens_identical": got_k == got_p == expected}
        emit(row)
        if row["ring_wraps"] < 3:
            raise AssertionError(f"wrap phase: {row['ring_wraps']} ring wraps, expected 3")
        if forced["max_rel_logit_err"] > WRAP_TOL:
            raise AssertionError(f"wrap phase ({path}, {kv}, teacher-forced): {forced}")
        if not row["tokens_identical"]:
            raise AssertionError(f"wrap phase ({path}, {kv}, copy model): greedy tokens differ: "
                                 f"{copy}")
        rows.append(row)
        del params, ek, ep
        torch.cuda.empty_cache()
    return rows


SUMMARY = {
    # kernel: (route, source, replaces, representative parity case)
    "qmatmul": ("cuda", "xalm_tpu_torch/csrc/qmatmul.cu", "xalm_tpu/ops/pallas_matmul.py:98",
                "M=1 w2 i8, row scale"),
    "kv_update": ("cuda", "xalm_tpu_torch/csrc/attention.cu", "xalm_tpu/ops/pallas_attention.py:501",
                  "insert at a wrapped row + sink rotation"),
    "flash_decode": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                     "xalm_tpu/ops/pallas_attention.py:273", "B=1 kv_len=777"),
    "flash_prefill": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                      "xalm_tpu/ops/pallas_attention.py:555", "T=512 pos=0"),
    "fused_decode": ("cuda", "xalm_tpu_torch/csrc/fused_decode.cu",
                     "xalm_tpu/ops/fused_decode.py:106", "B=1 kv_len=520, embed fold"),
    # one launch does the insert (_insert_q_kernel) and the sink rotation
    # (_sink_q_kernel, pallas_attention.py:141)
    "kv_update_q": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                    "xalm_tpu/ops/pallas_attention.py:104", "wrapped insert + sink rotation"),
    "flash_decode_q": ("cuda", "xalm_tpu_torch/csrc/attention.cu",
                       "xalm_tpu/ops/pallas_attention.py:205", "B=1 kv_len=777"),
}
# further rows of the kernels line: another TPU kernel a launch replaces,
# and the megakernel's int8-KV branch (the fused_decode launches count both)
ALSO_REPLACES = {"kv_update_q": "xalm_tpu/ops/pallas_attention.py:141"}
INT8_CASE = {"fused_decode": "int8 KV, B=1 kv_len=520, embed fold"}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("error: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device (this smoke runs on the GPU only)", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "xalm_tpu_torch")):
        print("error: run from a checkout of the repository (xalm_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from xalm_tpu_torch.models.config import MISTRAL_7B
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    cfg = MISTRAL_7B
    t0 = time.perf_counter()
    params = synthetic_params(cfg, device=DEVICE, seed=SEED)
    torch.cuda.synchronize()
    emit({"phase": "weights", "seconds": time.perf_counter() - t0,
          "gb": params.nbytes() / 1e9})
    cases = Cases()
    with torch.inference_mode():
        phase_parity(params, cfg, cases)
        phase_fused_parity(params, cfg, cases)
    main_row = phase_main(params, cfg)
    del params
    torch.cuda.empty_cache()
    with torch.inference_mode():
        phase_wrap(cfg)

    kernels = []
    for kname, (route, src, replaces, rep) in SUMMARY.items():
        rows = [r for r in cases.rows if r["kernel"] == kname]
        r = next(r for r in rows if r["case"] == rep)
        entry = {
            "name": kname, "route": route, "source": src, "replaces": replaces,
            "launches": main_row["launches"][kname],
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "case": rep,
        }
        if kname in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[kname]
        if kname in INT8_CASE:
            q = next(x for x in rows if x["case"] == INT8_CASE[kname])
            entry["int8_kv"] = {"case": q["case"], "ms": q["kernel_ms"], "plain_ms": q["plain_ms"],
                                "bound_ms": q["bound_ms"], "bound_by": q["bound_by"]}
        kernels.append(entry)
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
