"""Build and load the package's CUDA kernels.

The sources under ``rayuela_tpu_torch/csrc/`` compile with ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, and link into
one shared library with a plain C interface, loaded with `ctypes`. The
build runs at first use, into ``rayuela_tpu_torch/_build/`` (listed in
``.gitignore``), and again whenever a source's hash changes:
the library's file name carries the hash of the sources and flags.
Nothing is imported or built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / f for f in (
    "codes_scan.cu", "decoded_scan.cu", "lut_scan.cu", "topk_tail.cu",
    "icm.cu", "viterbi.cu", "fusion_probe.cu"))
HEADERS = (_PKG / "csrc" / "scan_common.cuh",)   # included by the scans
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: argument types, the trailing pointer is the stream
# (but for the layout and attribute queries, which fill the int array it
# points to)
_SIGNATURES = {
    "rq_codes_decode_candidates": [_P] * 6 + [_I] * 12 + [_P],
    "rq_cand_merge": [_P] * 3 + [_I] * 4 + [_P],
    "rq_codes_decode_topk": [_P] * 6 + [_I] * 13 + [_P],
    "rq_codes_topk_layout": [_I] * 4 + [_P],
    "rq_codes_decode_onepass": [_P] * 7 + [_I] * 14 + [_P],
    "rq_codes_onepass_layout": [_I] * 5 + [_P],
    "rq_codes_candidates_layout": [_I] * 4 + [_P],
    "rq_scan_candidates": [_P] * 6 + [_I] * 8 + [_P],
    "rq_scan_candidates_layout": [_I] * 2 + [_P],
    "rq_scan_onepass": [_P] * 5 + [_I] * 9 + [_P],
    "rq_scan_onepass_layout": [_I] * 3 + [_P],
    "rq_codes_lut_candidates": [_P] * 4 + [_I] * 10 + [_P],
    "rq_scan_f32_candidates": [_P] * 5 + [_I] * 7 + [_P],
    "rq_scan_verify_counts": [_P] * 6 + [_I] * 6 + [_P],
    "rq_exact_layout": [_I] * 2 + [_P],
    "rq_codes_lut_f32_candidates": [_P] * 4 + [_I] * 9 + [_P],
    "rq_codes_lut_verify_counts": [_P] * 5 + [_I] * 8 + [_P],
    "rq_lut_layout": [_I] * 3 + [_P],
    "rq_lut_exact_layout": [_I] * 3 + [_P],
    "rq_pair_merge": [_P] * 4 + [_I] * 3 + [_P],
    "rq_tail_merge": [_P] * 3 + [_I] * 4 + [_P],
    "rq_tail_layout": [_I] * 3 + [_P],
    "rq_icm_sweeps": [_P] * 8 + [_I] * 5 + [_P],
    "rq_icm_ils": [_P] * 8 + [_I] * 9 + [_P],
    "rq_icm_layout": [_I] * 2 + [_P],
    "rq_viterbi_encode": [_P] * 6 + [_I] * 4 + [_P],
    "rq_fusion_chain": [_P] * 3 + [_I] * 4 + [_P],
    "rq_fusion_attrs": [_I] * 2 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def build() -> tuple[Path, str]:
    """Compile the kernels unless a library for the current sources
    exists. Returns ``(library path, nvcc's output)``; the output is
    empty when nothing was compiled. A failed build raises with nvcc's
    standard error."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"librayuela_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in SOURCES]
    nvcc = _nvcc()
    procs = []
    try:
        procs += [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o",
                                    str(obj), str(src)],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
                  for src, obj in zip(SOURCES, objs)]
        log = ""
        for src, p in zip(SOURCES, procs):
            stdout, stderr = p.communicate()
            log += stderr + stdout
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} (exit "
                                   f"{p.returncode}):\n{stderr}")
        proc = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for p in procs:          # after a failure, stop the others
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rq_error_string.argtypes = [ctypes.c_int]
            lib.rq_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def query(name: str, *args: int, size: int,
          device: torch.device) -> tuple[int, ...]:
    """Call C query ``name`` (a layout or attribute query, which fills
    ``size`` ints) on ``device`` → those ints; a nonzero CUDA error code
    raises."""
    lib = library()
    out = (ctypes.c_int * size)()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, ctypes.addressof(out))
    if err:
        msg = lib.rq_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
    return tuple(out)


def launch(name: str, *args, device: torch.device) -> None:
    """Call C entry point ``name`` on the current stream of ``device``.
    Tensors pass as their data pointers (the caller keeps them alive);
    a nonzero CUDA error code raises."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
                for a in args]
        err = getattr(lib, name)(*conv, stream)
    if err:
        msg = lib.rq_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
