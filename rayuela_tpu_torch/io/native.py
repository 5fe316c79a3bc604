"""ctypes binding + on-demand build for the native xvecs reader (a copy
of `rayuela_tpu/io/native.py`).

The shared library builds lazily with the reference's recipe
(`deps/build.jl:17-49`: g++ -O3 -shared -fPIC -fopenmp) from
``native/xvecs_native.cpp`` into ``rayuela_tpu_torch/_build/`` (listed
in ``.gitignore``), never beside its source; the file name carries the
hash of the source and flags, so an edited source builds anew. The
reader runs on the host: if the toolchain or the build is unavailable,
callers read with the numpy path of `rayuela_tpu_torch.io.xvecs`, and
only ``native="always"`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "xvecs_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False

_ERRORS = {
    -1: OSError, -2: OSError, -3: ValueError, -4: ValueError,
    -5: ValueError,
}
_MSG = {
    -1: "open/stat failed", -2: "mmap failed",
    -3: "file size not a multiple of the row size",
    -4: "requested range out of bounds",
    -5: "inconsistent dimension headers",
}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"libxvecs_native_{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """Compile into a temporary name and rename, so that processes that
    build at once never load a half-written library."""
    lib = library_path()
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native library, or None."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = library_path()
        if not path.exists():
            path = _build()
        if path is None:
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _failed = True
            return None
        lib.xvecs_probe.restype = ctypes.c_int
        lib.xvecs_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.xvecs_read.restype = ctypes.c_int
        lib.xvecs_read.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        lib.xvecs_write.restype = ctypes.c_int
        lib.xvecs_write.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _check(code: int, path: str) -> None:
    if code != 0:
        raise _ERRORS.get(code, OSError)(
            f"{path}: {_MSG.get(code, f'native error {code}')}")


def probe(path: str, value_size: int) -> tuple[int, int]:
    """(dim, n) of an xvecs file via the native prober."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native xvecs library unavailable")
    dim = ctypes.c_int64()
    n = ctypes.c_int64()
    _check(lib.xvecs_probe(path.encode(), value_size,
                           ctypes.byref(dim), ctypes.byref(n)), path)
    return int(dim.value), int(n.value)


def read(path: str, value_dtype, value_size: int, start: int = 0,
         count: int | None = None) -> np.ndarray:
    """Parallel mmap read → (count, dim) array (native path)."""
    lib = get_lib()
    dim, n = probe(path, value_size)
    if count is None:
        count = n - start
    if start < 0 or count < 0 or start + count > n:
        raise ValueError(f"range [{start}, {start + count}) outside "
                         f"file with n={n}")
    out = np.empty((count, dim), dtype=value_dtype)
    _check(lib.xvecs_read(path.encode(), value_size, start, count,
                          out.ctypes.data_as(ctypes.c_void_p)), path)
    return out


def write(path: str, X: np.ndarray, value_dtype) -> None:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native xvecs library unavailable")
    X = np.ascontiguousarray(X, dtype=value_dtype)
    n, dim = X.shape
    _check(lib.xvecs_write(path.encode(), X.dtype.itemsize, n, dim,
                           X.ctypes.data_as(ctypes.c_void_p)), path)
