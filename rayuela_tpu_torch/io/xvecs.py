"""TEXMEX ``.fvecs`` / ``.ivecs`` / ``.bvecs`` readers and writers (a
copy of `rayuela_tpu/io/xvecs.py`: the same files, the same errors).

Capability parity with reference `src/xvecs_read.jl` (``fvecs_read``
:63-106, ``ivecs_read`` :109-152, ``bvecs_read`` :14-60) and
`src/xvecs_write.jl` (:10-25). Format: each vector is stored as a
little-endian int32 dimension header followed by d values (f32 / i32 /
u8 per flavor).

Row-major numpy convention here: readers return ``(n, d)`` arrays
(the reference returns ``d x n`` columns). Range reads (``a:b``,
1-based inclusive in the reference; here 0-based ``start/count``) are
supported via seek, so slices of SIFT1B-scale files never touch the
rest of the file. Pure numpy on the host: the device never sees I/O.
"""

from __future__ import annotations

import os

import numpy as np


def _xvecs_read(path: str, value_dtype, value_size: int,
                start: int = 0, count: int | None = None,
                native: str = "auto") -> np.ndarray:
    """``native``: "auto" uses the C++ mmap+OpenMP reader
    (`rayuela_tpu_torch.io.native`) for files over ~16 MB when the
    library is available; "never" forces the numpy path; "always"
    requires it."""
    if native != "never":
        from rayuela_tpu_torch.io import native as nat
        big = os.path.exists(path) and os.path.getsize(path) > 16 << 20
        if nat.available() and (native == "always" or big):
            return nat.read(path, value_dtype, value_size, start, count)
        if native == "always":
            raise RuntimeError("native xvecs library unavailable")
    with open(path, "rb") as f:
        d = int(np.fromfile(f, dtype="<i4", count=1)[0])
        row_bytes = 4 + d * value_size
        fsize = os.fstat(f.fileno()).st_size
        n = fsize // row_bytes
        if fsize % row_bytes:
            raise ValueError(f"{path}: size {fsize} not a multiple of "
                             f"row size {row_bytes} (d={d})")
        if count is None:
            count = n - start
        if start < 0 or start + count > n:
            raise ValueError(f"range [{start}, {start + count}) outside "
                             f"file with n={n}")
        f.seek(start * row_bytes)
        raw = np.fromfile(f, dtype=np.uint8, count=count * row_bytes)
    raw = raw.reshape(count, row_bytes)
    dims = raw[:, :4].copy().view("<i4").reshape(-1)
    if not np.all(dims == d):
        raise ValueError(f"{path}: inconsistent dimension headers")
    return raw[:, 4:].copy().view(value_dtype).reshape(count, d)


def fvecs_read(path: str, start: int = 0,
               count: int | None = None,
               native: str = "auto") -> np.ndarray:
    """Read float32 vectors → (n, d) f32. Reference `src/xvecs_read.jl:63-106`."""
    return _xvecs_read(path, "<f4", 4, start, count, native)


def ivecs_read(path: str, start: int = 0,
               count: int | None = None,
               native: str = "auto") -> np.ndarray:
    """Read int32 vectors → (n, d) i32. Reference `src/xvecs_read.jl:109-152`."""
    return _xvecs_read(path, "<i4", 4, start, count, native)


def bvecs_read(path: str, start: int = 0,
               count: int | None = None,
               native: str = "auto") -> np.ndarray:
    """Read uint8 vectors → (n, d) u8. Reference `src/xvecs_read.jl:14-60`."""
    return _xvecs_read(path, np.uint8, 1, start, count, native)


def _xvecs_write(path: str, X: np.ndarray, value_dtype) -> None:
    X = np.ascontiguousarray(X, dtype=value_dtype)
    n, d = X.shape
    header = np.full((n, 1), d, dtype="<i4")
    rows = np.concatenate([header.view(np.uint8).reshape(n, 4),
                           X.view(np.uint8).reshape(n, -1)], axis=1)
    rows.tofile(path)


def fvecs_write(path: str, X: np.ndarray) -> None:
    """Write float32 vectors. Reference `src/xvecs_write.jl:10-16`."""
    _xvecs_write(path, X, "<f4")


def ivecs_write(path: str, X: np.ndarray) -> None:
    """Write int32 vectors. Reference `src/xvecs_write.jl:19-25`."""
    _xvecs_write(path, X, "<i4")


def bvecs_write(path: str, X: np.ndarray) -> None:
    """Write uint8 vectors (not in the reference; completes the format)."""
    _xvecs_write(path, X, np.uint8)
