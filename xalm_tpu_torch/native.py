"""ctypes binding and build of the native (C++) host components (the port's
counterpart of ``xalm_tpu/native.py``), from the repository's
``native/*.cpp`` and ``native/*.hpp``:

- ``NativeTrie``: the trie tokenizer's encode (``native/tokenizer.cpp``),
  the same ids as the Python trie of ``tokenizer.py``;
- ``NativeMap``: a read-only mmap of a container with a thread-pool copy
  engine (``native/loader.cpp``, ``native/task_pool.hpp``): ``copy_batch``
  copies many tensor blobs into numpy arrays at once, large blobs split in
  8 MiB jobs, and ``prefault`` touches every page in parallel.

The library builds on first use with

    g++ -O2 -std=c++17 -shared -fPIC -pthread native/*.cpp -o <tmp>

into ``build/xalm_tpu_torch/`` beside the package's checkout, as
``ops/build.py`` builds the CUDA kernels: the file name carries a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the library already there. Each build writes a temporary file of its
own and ``os.replace``-s it into place, so two processes building at once
both end with a whole library; nothing is written under ``native/``.

``load()`` returns None where the library cannot be built or loaded (no
``g++``, no ``native/``); every consumer then takes its Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "library_path", "NativeTrie", "NativeMap"]

SRC_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "xalm_tpu_torch"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _sources() -> tuple[list[Path], list[Path]]:
    return sorted(SRC_DIR.glob("*.cpp")), sorted(SRC_DIR.glob("*.hpp"))


def library_path() -> Path | None:
    """Where the library of the present sources lives (built or not), or
    None without sources."""
    srcs, hdrs = _sources()
    if not srcs:
        return None
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"xalm_native-{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    out = library_path()
    if out is None or out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *GXX_FLAGS, *map(str, _sources()[0]), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=240)
        os.replace(tmp, out)
    except (subprocess.SubprocessError, OSError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL | None:
    """The native library, built on first use; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        P, I32, U64, SZ = ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint64, ctypes.c_size_t
        for fn, restype, argtypes in (
            ("xalm_tokenizer_create", P, [ctypes.c_char_p, SZ, I32, I32]),
            ("xalm_tokenizer_destroy", None, [P]),
            ("xalm_tokenizer_encode", SZ,
             [P, ctypes.c_char_p, SZ, ctypes.POINTER(I32), SZ, I32]),
            ("xalm_tokenizer_byte_fallback_start", I32, [P]),
            ("xalm_tokenizer_eot_id", I32, [P]),
            ("xalm_tokenizer_vocab_size", SZ, [P]),
            ("xalm_map", P, [ctypes.c_char_p]),
            ("xalm_map_size", U64, [P]),
            ("xalm_unmap", None, [P]),
            ("xalm_copy_batch", I32,
             [P, ctypes.POINTER(U64), ctypes.POINTER(U64), ctypes.POINTER(P), I32, I32]),
            ("xalm_prefault", U64, [P, I32]),
        ):
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIB = lib
        return _LIB


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(os.cpu_count() or 1, 16)


class NativeTrie:
    """A native tokenizer trie over a ``tokenizer.tokens`` blob; encode only
    (decoding stays in ``tokenizer.py``)."""

    def __init__(self, blob: bytes, bos_id: int, eos_id: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.xalm_tokenizer_create(blob, len(blob), bos_id, eos_id)
        if not self._handle:
            raise RuntimeError("native tokenizer creation failed")

    def encode(self, data: bytes, bos: bool) -> list[int]:
        cap = len(data) + 1
        out = (ctypes.c_int32 * cap)()
        n = self._lib.xalm_tokenizer_encode(self._handle, data, len(data), out, cap,
                                            1 if bos else 0)
        return list(out[:n])

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.xalm_tokenizer_destroy(self._handle)
            self._handle = None


class NativeMap:
    """A native read-only mmap of a file with a thread-pool copy engine."""

    def __init__(self, path: str | os.PathLike):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.xalm_map(os.fsencode(path))
        if not self._handle:
            raise RuntimeError(f"xalm_map failed for {path}")
        self.size = int(lib.xalm_map_size(self._handle))

    def copy_batch(self, offsets, sizes, dests, n_threads: int = 0) -> None:
        """Copy the blobs at (offset, size) of the file into the numpy arrays
        ``dests``, in parallel. Each dest must be C-contiguous, writable and
        at least its size in bytes."""
        n = len(offsets)
        if not n == len(sizes) == len(dests):
            raise ValueError("offsets/sizes/dests length mismatch")
        ptrs = (ctypes.c_void_p * n)()
        for i, d in enumerate(dests):
            if not (d.flags.c_contiguous and d.flags.writeable):
                raise ValueError(f"dest {i} must be C-contiguous and writable")
            if d.nbytes < sizes[i]:
                raise ValueError(f"dest {i} too small: {d.nbytes} < {sizes[i]}")
            ptrs[i] = d.ctypes.data
        rc = self._lib.xalm_copy_batch(self._handle, (ctypes.c_uint64 * n)(*offsets),
                                       (ctypes.c_uint64 * n)(*sizes), ptrs, n,
                                       _threads(n_threads))
        if rc != 0:
            raise ValueError("xalm_copy_batch: offset/size out of bounds")

    def prefault(self, n_threads: int = 0) -> int:
        """Touch every page of the file in parallel; returns a checksum of
        the touched bytes."""
        return int(self._lib.xalm_prefault(self._handle, _threads(n_threads)))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.xalm_unmap(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
