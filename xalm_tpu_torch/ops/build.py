"""Build the CUDA kernels in ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/xalm_tpu_torch/<name>-<hash>.so

into ``build/xalm_tpu_torch/`` beside the package's checkout; the file name
carries a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one loads the library already there. The sources have a
plain C interface (no PyTorch headers), which keeps a build to seconds.
``build_all`` starts one ``nvcc`` per source, all at once.

Every exported launch function takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches, or
``cudaErrorInvalidValue`` for a shape outside the kernel's limits, which
live in the CUDA source alone. Size queries (``*_scratch``,
``*_workspace``) return element counts.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one where
it launches its kernel on the card, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNELS", "LAUNCHES", "build_all", "load_library", "reset_launches", "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xalm_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]
# source file -> kernel wrappers it backs
KERNELS = {
    "qmatmul": ("qmatmul",),
    "attention": ("kv_update", "flash_decode", "flash_prefill", "kv_update_q", "flash_decode_q"),
    "fused_decode": ("fused_decode",),
}
LAUNCHES: dict[str, int] = {k: 0 for ks in KERNELS.values() for k in ks}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
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


def build_all() -> dict[str, float]:
    """Build every kernel source in parallel; returns seconds per source
    (0.0 where the library was already built)."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in KERNELS}
    secs = {}
    for name, (out, pending) in started.items():
        _finish(name, out, pending)
        secs[name] = time.perf_counter() - t0 if pending is not None else 0.0
    return secs


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed. Each
    exported function's restype/argtypes come from ``SIGNATURES``."""
    out, pending = _start(name)
    _finish(name, out, pending)
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
        # M, N -> bf16 elements of scratch (0: the GEMV route needs none)
        "xq_qmatmul_scratch": (_L, [_I, _I]),
        # x, norm_w, eps, w, w_is_bf16, scale, qscale, y, xb, M, N, D, stream
        "xq_qmatmul": (_I, [_P, _P, _F, _P, _I, _P, _F, _P, _P, _I, _I, _I, _P]),
    },
    "attention": {
        # ck, cv, knew, vnew, kv_pos, rotate, cexp, sexp, B, KH, S, hd, stream
        "xq_kv_update": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        # B, H, S -> f32 elements of the flash-decode workspace
        "xq_flash_decode_workspace": (_L, [_I, _I, _I]),
        # q, ck, cv, kv_len, work, out, B, H, KH, S, hd, sm_scale, stream
        "xq_flash_decode": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
        # q, ck, cv, pos, out, B, T, H, KH, S, hd, sm_scale, stream
        "xq_flash_prefill": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
        # ck, cv, ks, vs, knew, vnew, kv_pos, rotate, cexp, sexp, B, KH, S, hd, stream
        "xq_kv_update_q": (_I, [_P] * 10 + [_I, _I, _I, _I, _P]),
        # q, ck, cv, ks, vs, kv_len, work, out, B, H, KH, S, hd, sm_scale, stream
        "xq_flash_decode_q": (_I, [_P] * 8 + [_I, _I, _I, _I, _I, _F, _P]),
    },
    "fused_decode": {
        # B, N, KH, G, S, H -> bytes of the megakernel's workspace
        "xq_fused_decode_workspace": (_L, [_I, _I, _I, _I, _I, _I]),
        # blocks in the cooperative grid on the current device (0: none fit)
        "xq_fused_decode_grid": (_I, []),
        # pointer array, int array (see csrc/fused_decode.cu), eps, clip, sm_scale, stream
        "xq_fused_decode": (_I, [_P, _P, _F, _F, _F, _P]),
        # workspace, iterations, stream: grid barriers alone
        "xq_grid_barrier_bench": (_I, [_P, _I, _P]),
    },
}
