"""Build the CUDA kernels in ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -lineinfo --split-compile=0
         -o build/xalm_tpu_torch/<name>-<hash>.so

into ``build/xalm_tpu_torch/`` beside the package's checkout; the file name
carries a hash of the sources and flags (every file of ``csrc/``: a source
may include another, as ``fused_decode_f32.cu`` builds ``fused_decode.cu``
again for the f32 cache), so an edited kernel rebuilds and an unchanged one
loads the library already there. The sources have a plain C interface (no
PyTorch headers), which keeps a build to seconds. ``start_all`` starts one
``nvcc`` per source, all at once, and returns; ``wait`` (or the first
``load_library`` of a source) waits for that source's alone, so a caller can
use the libraries that are done while the megakernel's still build.

Every exported launch function takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches, or
``cudaErrorInvalidValue`` for a shape outside the kernel's limits, which
live in the CUDA source alone. Size queries (``*_scratch``,
``*_workspace``) return element or byte counts, as their comments say.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one where
it launches its kernel on the card, and nowhere else. A CUDA graph's
capture takes its counts back out (``take_launches``: nothing ran) and each
replay adds them (``add_launches``), so a replayed step counts as the eager
one does. A launch of kernel 1
or 8 counts under its branch: ``qmatmul`` and ``qmatmul_multi`` for int8
and bf16 weights, ``_f32``, ``_fp8``, ``_q4`` and ``_a8`` for the others.
Kernels 2-4 count an f32 cache's launches under ``_f32``. The launch that
updates the ring and attends over a float cache (kernels 2-3,
``fused_decode_attention``) counts under ``flash_decode`` (``_f32``), and
the one that inserts, re-rotates and attends over an int8 cache (kernels
5-7, ``fused_decode_attention_q``) under ``flash_decode_q``. A megakernel
launch counts under its body (``fused_decode``, ``_a8``, ``_q4``), under
``fused_decode_f32`` too with an f32 cache, and, when a family fold is on,
under that fold (``fused_decode_bias``, ``fused_decode_qk_norm``;
``fused_decode_gemma`` for gelu and the embed scale, ``fused_decode_gemma2``
for the softcaps and post-norms).
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNELS", "LAUNCHES", "start_all", "wait", "load_library", "reset_launches",
           "take_launches", "add_launches", "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xalm_tpu_torch"
# --split-compile=0 runs the optimizer's passes on every core: it halves the
# megakernel's build (140 to 70 s on the H100 machine's 8 cores, three
# sources at once)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo", "--split-compile=0",
]
# source file -> kernel wrappers it backs
KERNELS = {
    "qmatmul": ("qmatmul", "qmatmul_multi", "qmatmul_q4", "qmatmul_a8", "qmatmul_multi_q4",
                "qmatmul_f32", "qmatmul_multi_f32", "qmatmul_fp8", "qmatmul_multi_fp8"),
    "attention": ("kv_update", "flash_decode", "flash_prefill", "kv_update_q", "flash_decode_q",
                  "kv_update_f32", "flash_decode_f32", "flash_prefill_f32"),
    "fused_decode": ("fused_decode", "fused_decode_a8", "fused_decode_q4", "fused_decode_bias",
                     "fused_decode_qk_norm", "fused_decode_gemma", "fused_decode_gemma2"),
    "fused_decode_f32": ("fused_decode_f32",),
}
LAUNCHES: dict[str, int] = {k: 0 for ks in KERNELS.values() for k in ks}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def take_launches(before: dict[str, int]) -> dict[str, int]:
    """The launches counted since ``before`` (a copy of ``LAUNCHES``), taken
    back out of ``LAUNCHES``: a CUDA graph's capture runs the wrappers, which
    count, but launches nothing. The graph records them and adds them at
    each replay (``add_launches``)."""
    made = {k: n - before.get(k, 0) for k, n in LAUNCHES.items()}
    LAUNCHES.update(before)
    return {k: n for k, n in made.items() if n}


def add_launches(counts: dict[str, int], times: int = 1) -> None:
    """Count ``times`` replays of a graph that recorded ``counts``."""
    for k, n in counts.items():
        LAUNCHES[k] += n * times


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library exists. Returns
    (output path, Popen or None)."""
    out = _lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, pending) -> None:
    if pending is None:
        return
    proc, tmp = pending
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


# builds start_all started that nobody has waited for yet: source ->
# (library path, (Popen, temporary path), start time)
_PENDING: dict[str, tuple] = {}


@atexit.register
def _stop_pending() -> None:
    """Ends the builds still running when the interpreter exits (a caller
    that raised before waiting leaves no nvcc behind)."""
    while _PENDING:
        _, (proc, tmp), _ = _PENDING.popitem()[1]
        proc.kill()
        proc.communicate()
        tmp.unlink(missing_ok=True)


def start_all() -> None:
    """Start nvcc for every kernel source whose library is neither built nor
    being built, all at once; returns without waiting."""
    for name in KERNELS:
        if name not in _PENDING:
            out, pending = _start(name)
            if pending is not None:
                _PENDING[name] = (out, pending, time.perf_counter())


def wait(name: str) -> tuple[Path, float]:
    """The library path of csrc/<name>.cu once built (by the build
    start_all started, or by one started now), and the seconds since that
    build started (0.0 where the library was already built)."""
    if name in _PENDING:
        out, pending, t0 = _PENDING.pop(name)
    else:
        t0 = time.perf_counter()
        out, pending = _start(name)
    _finish(name, out, pending)
    return out, (time.perf_counter() - t0 if pending is not None else 0.0)


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed (or its
    build by start_all waited for). Each exported function's
    restype/argtypes come from ``SIGNATURES``."""
    out, _ = wait(name)
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


_INVALID_VALUE = 1  # cudaErrorInvalidValue: the C side refuses a shape


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err == _INVALID_VALUE:
        raise ValueError(f"{what}: a shape or argument the kernel does not take "
                         "(its limits are checked in csrc/)")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# exported function -> (restype, argtypes); a c_int result is a cudaError_t
SIGNATURES = {
    "qmatmul": {
        # M, N, w_kind -> bytes of scratch (0: the GEMV route needs none)
        "xq_qmatmul_scratch": (_L, [_I, _I, _I]),
        # x, norm_w, eps, w, w_kind (0 int8, 1 bf16, 2 f32, 3 e4m3, 4 e5m2), scale, qscale, y,
        # xb, M, N, D, stream
        "xq_qmatmul": (_I, [_P, _P, _F, _P, _I, _P, _F, _P, _P, _I, _I, _I, _P]),
        # x, w, w_kind, scale, qscale, idxs, y, k, m, shared_x, N, D, LE, stream
        "xq_qmatmul_multi": (_I, [_P, _P, _I, _P, _F, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
        # m, N, D, w_kind (0 int8), k, plan (8 int32: x's rows, warps a block, blocks an
        # expert, bytes a stage, rows a stage, segments a row, bytes a segment, shared
        # memory) of kernel 8's per-expert stream
        "xq_qmatmul_multi_plan": (_I, [_I, _I, _I, _I, _I, _P]),
        # x, w (packed), scale (LE, D, N/group), idxs, xq, sx, y, k, m, shared_x, N, D, LE,
        # group, stream
        "xq_qmatmul_multi_q4": (_I, [_P] * 7 + [_I] * 7 + [_P]),
        # x, w (packed), scale (D, N/group), xq, sx, y, M, N, D, group, stream (xq and sx
        # scratch: the q4 stream leaves them unwritten)
        "xq_qmatmul_q4": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        # M, N, D, group, k, plan (7 int32: x's rows a launch, blocks an expert, bytes a stage,
        # rows a stage, segments a row, bytes a segment, shared memory) of the q4 stream
        "xq_qmatmul_q4_plan": (_I, [_I, _I, _I, _I, _I, _P]),
        # x, w, scale, qscale, xq, sx, y, M, N, D, stream
        "xq_qmatmul_a8": (_I, [_P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _P]),
        # M, N, D, plan (3 int32: weight rows a block, blocks along M, along D)
        "xq_qmatmul_a8_plan": (_I, [_I, _I, _I, _P]),
        # M, N, D, w_kind, plan (4 int32: blocks, stages, rows a stage, segments a row) of the
        # streamed GEMV
        "xq_gemv_plan": (_I, [_I, _I, _I, _I, _P]),
        # M, N, D, w_kind, plan (7 int32: token rows a tile, weight rows a tile, tiles along M,
        # tiles along D, K splits, stages, blocks) of the tiled GEMM of int8, bf16 and fp8
        "xq_gemm_plan": (_I, [_I, _I, _I, _I, _P]),
        # a (64, 8), b (128, 8) f32 bit patterns, d (64, 128) by tf32 wgmma, dm (16, 8) by
        # tf32 mma.sync, stream
        "xq_tf32_probe": (_I, [_P, _P, _P, _P, _P]),
        # src, bytes, copy bytes, stages, blocks, sink (1 f32), stream: the streamed GEMV's
        # ring alone
        "xq_bulk_stream_bench": (_I, [_P, _L, _I, _I, _I, _P, _P]),
    },
    "attention": {
        # ck, cv, knew, vnew, kv_pos, rotate, cexp, sexp, B, KH, S, hd, f32 (a float
        # cache: 0 bf16, 1 f32; the flash kernels' too), stream
        "xq_kv_update": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        # q, ck, cv, knew, vnew, kv_pos, rotate, cexp, sexp, kv_len, out, B, H, KH, S, hd,
        # sm_scale, f32, stream: kernel 2's update in kernel 3's launch
        "xq_fused_decode_attention": (_I, [_P] * 11 + [_I] * 5 + [_F, _I, _P]),
        # B, H, KH, hd, f32, plan (3 int32: blocks a (batch, kv head) = the cluster, key rows a
        # stage, stages)
        "xq_flash_decode_plan": (_I, [_I, _I, _I, _I, _I, _P]),
        # q, ck, cv, pos, out, B, T, H, KH, S, hd, sm_scale, f32, stream
        "xq_flash_prefill": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
        # T, H, KH, hd, f32, tq (1 int32), q0s (cap int32: block y's first position), cap
        "xq_flash_prefill_plan": (_I, [_I, _I, _I, _I, _I, _P, _P, _I]),
        # ck, cv, ks, vs, knew, vnew, kv_pos, rotate, cexp, sexp, B, KH, S, hd, stream
        "xq_kv_update_q": (_I, [_P] * 10 + [_I, _I, _I, _I, _P]),
        # q, ck, cv, ks, vs, knew (null: no insert), vnew, kv_pos, rotate, cexp, sexp, kv_len,
        # out, B, H, KH, S, hd, sm_scale, stream
        "xq_flash_decode_q": (_I, [_P] * 13 + [_I, _I, _I, _I, _I, _F, _P]),
        # B, H, KH, S, hd, plan (3 int32: blocks a (batch, kv head) = the cluster, key rows a
        # chunk, ring slots)
        "xq_flash_decode_q_plan": (_I, [_I, _I, _I, _I, _I, _P]),
    },
    "fused_decode": {
        # B, N, KH, G, S, H, hd -> bytes of the megakernel's workspace
        "xq_fused_decode_workspace": (_L, [_I] * 7),
        # blocks in the cooperative grid on the current device (0: none fit)
        "xq_fused_decode_grid": (_I, []),
        # pointer array, int array (see csrc/fused_decode.cu), eps, clip, sm_scale,
        # embed_scale, attn_softcap, logit_softcap, stream
        "xq_fused_decode": (_I, [_P, _P] + [_F] * 6 + [_P]),
        # workspace, iterations, stream: grid barriers alone
        "xq_grid_barrier_bench": (_I, [_P, _I, _P]),
    },
}
# the f32-cache instantiations: the same entry point and workspace
SIGNATURES["fused_decode_f32"] = {k: SIGNATURES["fused_decode"][k]
                                  for k in ("xq_fused_decode_workspace", "xq_fused_decode")}
