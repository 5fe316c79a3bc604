"""Composite Quantization (CQ) interop (counterpart of
`rayuela_tpu/models/cq.py`, numpy-only host I/O, kept as a copy so that
the port imports nothing of the JAX package).

Like the reference (`src/CQ.jl`), the package never trains CQ itself:
it drives the external CQ C++ binary (Zhang et al., ICML'14) through a
key=value config file, reads back its binary codebook and code files,
and serves them with the CQ-flavoured ADC scan
(`rayuela_tpu_torch.search.linscan.linscan_cq`):

* ``CQParameters``: the parameter struct with the reference's defaults
  (`src/CQ.jl:38-81`);
* ``dump_cq_parameters``: the config file the binary reads
  (`src/CQ.jl:85-95`, bools and ints written as integers);
* ``read_cq_fvecs`` / ``read_cq_bvecs`` and their inverses: the
  binary's (count, dim, payload) files (`src/CQ.jl:6-34`);
* ``load_cq_model``: its outputs as numpy codebooks ``(m, h, d)`` f32
  and 0-based codes ``(n, m)`` int32;
* ``run_cq``: write the config and run the binary, gated on it
  existing (``$CQ_BINARY``; `demos/demo_cq.jl:130-136`).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess

import numpy as np


@dataclasses.dataclass
class CQParameters:
    """Reference `src/CQ.jl:38-81` (defaults preserved, paths relative)."""
    PQ: bool = False
    NCQ: bool = False
    CQ: bool = True
    Search: bool = True
    points_count: int = 100_000
    dictionaries_count: int = 8
    words_count: int = 256
    space_dimension: int = 128
    points_file: str = "data/sift/sift_learn.fvecs"
    output_file_prefix: str = "cq_out/"
    max_iter: int = 30
    distortion_tol: float = 0.0001
    read_partition: int = 0
    partition_file: str = ""
    kmeans_method: int = 101     # 101 = closure cluster, else Lloyd
    num_sep: int = 20
    initial_from_outside: int = 0
    dictionary_file: str = ""
    binary_codes_file: str = ""
    mu: float = 0.0004
    queries_count: int = 10_000
    groundtruth_length: int = 100
    result_length: int = 1000
    queries_file: str = "data/sift/sift_query.fvecs"
    groundtruth_file: str = "data/sift/sift_groundtruth.ivecs"
    trained_dictionary_file: str = "cq_out/D"
    trained_binary_codes_file: str = "cq_out/B"
    output_retrieved_results_file: str = "cq_out/recall"


def dump_cq_parameters(p: CQParameters, path: str) -> None:
    """key=value config (bools/ints as integers — `src/CQ.jl:85-95`)."""
    with open(path, "w") as f:
        for field in dataclasses.fields(p):
            v = getattr(p, field.name)
            if isinstance(v, bool) or isinstance(v, int):
                f.write(f"{field.name}={int(v)}\n")
            else:
                f.write(f"{field.name}={v}\n")


def read_cq_fvecs(path: str) -> np.ndarray:
    """CQ float file (int32 count, int32 dim, f32 column-major payload)
    → (count, dim) f32. Reference `src/CQ.jl:5-18`."""
    with open(path, "rb") as f:
        count = int(np.fromfile(f, "<i4", 1)[0])
        dim = int(np.fromfile(f, "<i4", 1)[0])
        data = np.fromfile(f, "<f4", count * dim)
    return data.reshape(count, dim)


def read_cq_bvecs(path: str) -> np.ndarray:
    """CQ int file → (count, dim) i32. Reference `src/CQ.jl:21-34`."""
    with open(path, "rb") as f:
        count = int(np.fromfile(f, "<i4", 1)[0])
        dim = int(np.fromfile(f, "<i4", 1)[0])
        data = np.fromfile(f, "<i4", count * dim)
    return data.reshape(count, dim)


def write_cq_fvecs(path: str, X: np.ndarray) -> None:
    """Inverse of `read_cq_fvecs` (not in the reference; lets tests and
    pipelines fabricate CQ-format files)."""
    X = np.ascontiguousarray(X, "<f4")
    with open(path, "wb") as f:
        np.asarray(X.shape, "<i4").tofile(f)
        X.tofile(f)


def write_cq_bvecs(path: str, B: np.ndarray) -> None:
    B = np.ascontiguousarray(B, "<i4")
    with open(path, "wb") as f:
        np.asarray(B.shape, "<i4").tofile(f)
        B.tofile(f)


def load_cq_model(dictionary_file: str, codes_file: str, m: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Load the binary's outputs into framework convention:
    codebooks (m, h, d) f32 and 0-based codes (n, m) i32."""
    D = read_cq_fvecs(dictionary_file)          # (m*h, d)
    mh, d = D.shape
    h = mh // m
    B = read_cq_bvecs(codes_file)               # (n, m), entry in [i*h,(i+1)*h)
    B = B.astype(np.int32) - np.arange(m, dtype=np.int32)[None, :] * h
    if B.min() < 0 or B.max() >= h:
        # some CQ builds emit per-codebook-local codes already
        B = read_cq_bvecs(codes_file).astype(np.int32)
    return D.reshape(m, h, d), B


def run_cq(params: CQParameters, workdir: str = "cq_out",
           binary: str | None = None) -> str:
    """Write the config and invoke the external CQ binary
    (`demos/demo_cq.jl:130-136`). Returns the config path. Raises
    FileNotFoundError if no binary is available (env ``CQ_BINARY``)."""
    binary = binary or os.environ.get("CQ_BINARY")
    if not binary or not os.path.exists(binary):
        raise FileNotFoundError(
            "CQ binary not found — set $CQ_BINARY to the Composite "
            "Quantization executable (this wrapper, like the "
            "reference, does not train CQ natively)")
    os.makedirs(workdir, exist_ok=True)
    cfg = os.path.join(workdir, "config.txt")
    dump_cq_parameters(params, cfg)
    subprocess.run([binary, cfg], check=True)
    return cfg
