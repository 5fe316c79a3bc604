"""Dataset catalog — name → (train / base / query / ground-truth)
(counterpart of `rayuela_tpu/experiments/datasets.py`).

SIFT1M, SIFT1B/10M/100M, GIST1M, Deep1M/Deep1B, Convnet1M, MNIST and
LabelMe22K load from TEXMEX fvecs/bvecs or HDF5 files under a data root
(env ``RAYUELA_DATA``, default ``~/Research/datasets``), with the JAX
package's catalog, key spellings and layout fixes; the ``synthetic``
family draws with numpy from a seed, exactly as the JAX package does, so
both packages see the same vectors for the same seed, and a
``RAYUELA_SYNTH_CACHE`` file written by either loads in the other.
Returned ground truth is always 0-based. `exact_ground_truth` runs its
f32 candidate scan in torch on the card unless the caller asks for the
CPU; h5py is imported only by the HDF5 loader.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from rayuela_tpu_torch.io.xvecs import bvecs_read, fvecs_read, ivecs_read
from rayuela_tpu_torch.utils import exact_f32


def data_root() -> str:
    return os.environ.get(
        "RAYUELA_DATA", os.path.expanduser("~/Research/datasets"))


class Dataset(NamedTuple):
    name: str
    Xt: np.ndarray       # (ntrain, d) f32 — training vectors
    Xb: np.ndarray       # (nbase, d)  f32 — base set
    Xq: np.ndarray       # (nquery, d) f32 — queries
    gt: np.ndarray       # (nquery,) int32 — 0-based true-NN ids into Xb


# name → file layout. ``nbase`` caps the base-set size where a slice of
# a bigger file defines the dataset (SIFT10M/100M are the first 10M/100M
# of the SIFT1B base with their own ground-truth files, reference
# `src/read_datasets.jl:154-185`).
_TEXMEX = {
    "sift1m": dict(train="sift/sift_learn.fvecs",
                   base="sift/sift_base.fvecs",
                   query="sift/sift_query.fvecs",
                   gt="sift/sift_groundtruth.ivecs", fmt="fvecs"),
    "gist1m": dict(train="gist/gist_learn.fvecs",
                   base="gist/gist_base.fvecs",
                   query="gist/gist_query.fvecs",
                   gt="gist/gist_groundtruth.ivecs", fmt="fvecs"),
    # `src/read_datasets.jl:10-33`: the Babenko deep1M fvecs release
    "deep1m-babenko": dict(train="deep_babenko/deep1M_learn.fvecs",
                           base="deep_babenko/deep1M_base.fvecs",
                           query="deep_babenko/deep1M_queries.fvecs",
                           gt="deep_babenko/deep1M_groundtruth.ivecs",
                           fmt="fvecs"),
    "sift1b": dict(train="sift1b/bigann_learn.bvecs",
                   base="sift1b/bigann_base.bvecs",
                   query="sift1b/bigann_query.bvecs",
                   gt="sift1b/gnd/idx_1000M.ivecs", fmt="bvecs"),
    "sift10m": dict(train="sift1b/bigann_learn.bvecs",
                    base="sift1b/bigann_base.bvecs",
                    query="sift1b/bigann_query.bvecs",
                    gt="sift1b/gnd/idx_10M.ivecs", fmt="bvecs",
                    nbase=10_000_000),
    "sift100m": dict(train="sift1b/bigann_learn.bvecs",
                     base="sift1b/bigann_base.bvecs",
                     query="sift1b/bigann_query.bvecs",
                     gt="sift1b/gnd/idx_100M.ivecs", fmt="bvecs",
                     nbase=100_000_000),
    "deep1b": dict(train="deep1b/learn.fvecs", base="deep1b/base.fvecs",
                   query="deep1b/query.fvecs",
                   gt="deep1b/groundtruth.ivecs", fmt="fvecs"),
}

# HDF5-packaged sets (reference keeps these as .h5/.mat,
# `src/read_datasets.jl:86-125,187-224`)
_HDF5 = {
    "mnist": "mnist/mnist.h5",
    "labelme22k": "labelme/labelme.h5",
    "convnet1m": "convnet1m/convnet1m.h5",
    "deep1m": "deep/deep1m.h5",
}

# Accepted key spellings per role, tried in order: the reference's own
# files ("train"/"test"/"gt"), its Convnet .mat keys, and
# ann-benchmarks-style files ("train"/"test"/"neighbors"). A missing
# base key falls back to the train set (the reference's MNIST/LabelMe
# are query/base protocols where base == train).
_H5_KEYS = {
    "train": ("train", "learn", "Xt", "feats_m_128_train"),
    "base": ("base", "dataset", "Xb", "feats_m_128_base",
             "train", "learn", "feats_m_128_train"),
    "query": ("query", "test", "queries", "Xq", "feats_m_128_test"),
    "gt": ("groundtruth", "gt", "neighbors", "idx"),
}


def _load_texmex(name: str, ntrain: int, nbase: int, nquery: int
                 ) -> Dataset:
    e = _TEXMEX[name]
    root = data_root()
    rd = fvecs_read if e["fmt"] == "fvecs" else bvecs_read
    Xt = rd(os.path.join(root, e["train"]), 0, ntrain).astype(np.float32)
    Xb = rd(os.path.join(root, e["base"]), 0, nbase).astype(np.float32)
    Xq = rd(os.path.join(root, e["query"]), 0, nquery).astype(np.float32)
    gt = ivecs_read(os.path.join(root, e["gt"]), 0, nquery)[:, 0]
    return Dataset(name, Xt, Xb, Xq, gt.astype(np.int32))


def _h5_pick(f, role: str):
    for k in _H5_KEYS[role]:
        if k in f:
            return np.asarray(f[k])
    return None


def _load_hdf5(name: str, ntrain: int, nbase: int, nquery: int,
               path: str | None = None) -> Dataset:
    """Tolerant HDF5 ingestion: accepts the key spellings in
    ``_H5_KEYS``, either (n, d) or Julia-written (d, n) layouts, gt as
    a vector or a (nq, knn) id matrix, and 1-based (Julia) gt ids
    (detected by an id == nbase, out of range for 0-based)."""
    import h5py
    if path is None:
        path = os.path.join(data_root(), _HDF5[name])
    with h5py.File(path, "r") as f:
        Xt, Xb, Xq = (_h5_pick(f, r) for r in ("train", "base", "query"))
        gt = _h5_pick(f, "gt")
    for role, arr in (("train", Xt), ("base", Xb), ("query", Xq),
                      ("gt", gt)):
        if arr is None:
            raise KeyError(
                f"{path}: no {role} key (tried {_H5_KEYS[role]})")

    # files written row-major as (d, n) have the shared feature axis
    # FIRST on every array: detect and transpose
    if (Xt.shape[0] == Xb.shape[0] == Xq.shape[0]
            and not (Xt.shape[1] == Xb.shape[1] == Xq.shape[1])):
        Xt, Xb, Xq = Xt.T, Xb.T, Xq.T
    Xt = np.asarray(Xt[:ntrain], np.float32)
    Xb = np.asarray(Xb[:nbase], np.float32)
    Xq = np.asarray(Xq[:nquery], np.float32)

    gt = np.asarray(gt)
    if gt.ndim == 2:
        # (nq, knn) id matrix (or its transpose): keep the true-NN col
        if gt.shape[0] != Xq.shape[0] and gt.shape[1] == Xq.shape[0]:
            gt = gt.T
        gt = gt[:, 0]
    gt = gt[:nquery].astype(np.int64)
    if gt.max(initial=0) >= Xb.shape[0]:    # 1-based (Julia) ids
        gt = gt - 1
    if gt.min(initial=0) < 0 or gt.max(initial=0) >= Xb.shape[0]:
        raise ValueError(f"{path}: ground-truth ids out of range "
                         f"[0, {Xb.shape[0]}) after normalization")
    return Dataset(name, Xt, Xb, Xq, gt.astype(np.int32))


def make_synthetic(d: int = 128, ntrain: int = 10_000,
                   nbase: int = 100_000, nquery: int = 1_000,
                   ncenters: int = 64, noise: float = 0.3,
                   seed: int = 0, name: str = "synthetic",
                   corr: bool = False, device=None) -> Dataset:
    """Clustered Gaussian data with exact brute-force ground truth, its
    candidate scan on ``device`` (the card unless the caller asks for
    the CPU). With ``RAYUELA_SYNTH_CACHE`` set, the dataset is kept in
    that directory under the JAX package's file name and read back from
    there."""
    cache_dir = os.environ.get("RAYUELA_SYNTH_CACHE")
    if cache_dir:
        tag = (f"{name}_d{d}_t{ntrain}_b{nbase}_q{nquery}_c{ncenters}"
               f"_n{noise}_s{seed}_corr{int(corr)}.npz")
        path = os.path.join(cache_dir, tag)
        if os.path.exists(path):
            z = np.load(path)
            return Dataset(name, z["Xt"], z["Xb"], z["Xq"], z["gt"])
        ds = _make_synthetic(d, ntrain, nbase, nquery, ncenters, noise,
                             seed, name, corr, device)
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(path + ".tmp.npz", Xt=ds.Xt, Xb=ds.Xb, Xq=ds.Xq,
                 gt=ds.gt)
        os.replace(path + ".tmp.npz", path)
        return ds
    return _make_synthetic(d, ntrain, nbase, nquery, ncenters, noise,
                           seed, name, corr, device)


def _make_synthetic(d: int, ntrain: int, nbase: int, nquery: int,
                    ncenters: int, noise: float, seed: int, name: str,
                    corr: bool, device=None) -> Dataset:
    """Queries are perturbed base vectors, so recall curves mean
    something at small scale. ``corr=True`` draws clusters and noise in
    a latent space with a decaying spectrum and rotates it by a random
    orthogonal matrix: anisotropic, correlated data like real
    descriptors, where the method ordering of the LSQ++ paper holds."""
    rng = np.random.default_rng(seed)
    if corr:
        # energy concentrated in ~d/4 effective dims, like real data
        spec = np.exp(-4.0 * np.arange(d) / d).astype(np.float32)
        spec *= np.sqrt(d / (spec ** 2).sum())   # keep E|x|^2 = d
        R, _ = np.linalg.qr(rng.standard_normal((d, d)))
        R = R.astype(np.float32)
    else:
        spec, R = np.ones(d, np.float32), np.eye(d, dtype=np.float32)
    centers = (rng.standard_normal((ncenters, d)).astype(np.float32)
               * spec)

    def draw(n):
        a = rng.integers(0, ncenters, n)
        z = (centers[a] + noise * spec
             * rng.standard_normal((n, d)).astype(np.float32))
        return (z @ R).astype(np.float32)

    Xt, Xb = draw(ntrain), draw(nbase)
    Xq = (Xb[rng.integers(0, nbase, nquery)]
          + 0.5 * noise * rng.standard_normal((nquery, d))
          ).astype(np.float32)
    return Dataset(name, Xt, Xb, Xq, exact_ground_truth(Xq, Xb,
                                                        device=device))


def exact_ground_truth(Xq: np.ndarray, Xb: np.ndarray, ncand: int = 32,
                       device=None) -> np.ndarray:
    """True-NN id per query. Two passes: an f32 scan on ``device`` (the
    card unless the caller asks for the CPU; TF32 off) collects
    ``ncand`` candidates per query, then float64 on the host picks the
    winner among them. A margin check sends every query whose f64 winner
    does not beat the f32 boundary by more than the f32 error bound to a
    float64 scan of the whole base."""
    exact_f32()
    nquery, d = Xq.shape
    n = Xb.shape[0]
    ncand = min(ncand, n)
    Xbd = torch.as_tensor(Xb, dtype=torch.float32, device=device or "cuda")
    b2 = (Xbd * Xbd).sum(1)
    Xb64 = None
    gt = np.empty(nquery, np.int64)
    chunk = max(1, min(4096, (1 << 28) // max(n, 1) or 1))
    for s in range(0, nquery, chunk):
        q = torch.as_tensor(Xq[s:s + chunk], dtype=torch.float32,
                            device=Xbd.device)
        sc = b2[None, :] - 2.0 * (q @ Xbd.T)
        top = torch.topk(sc, ncand, dim=1, largest=False)
        d32, idx = top.values.cpu().numpy(), top.indices.cpu().numpy()
        cand = Xb[idx].astype(np.float64)                 # (cq, ncand, d)
        qd = Xq[s:s + chunk].astype(np.float64)
        d64 = ((cand - qd[:, None, :]) ** 2).sum(-1)
        best = np.argmin(d64, axis=1)
        gt[s:s + chunk] = idx[np.arange(idx.shape[0]), best]
        if ncand < n:
            # d32 is |b|^2 - 2qb (no |q|^2 term); put d64 on that scale
            q2 = (qd ** 2).sum(-1)
            err = 1e-4 * np.maximum(1.0, np.abs(d32[:, -1]))
            unsafe = np.nonzero(
                d64[np.arange(len(best)), best] - q2
                > d32[:, -1] - err)[0]
            for u in unsafe:
                if Xb64 is None:
                    Xb64 = Xbd.double()
                qrow = torch.as_tensor(Xq[s + u], dtype=torch.float64,
                                       device=Xbd.device)
                gt[s + u] = int(((Xb64 - qrow) ** 2).sum(1).argmin())
    return gt.astype(np.int32)


def read_dataset(name: str, ntrain: int = 100_000,
                 nbase: int | None = None, nquery: int = 10_000,
                 device=None, **synth_kw) -> Dataset:
    """Load a catalog dataset (reference `src/read_datasets.jl:4-244`).

    ``synthetic`` / ``synthetic-small`` need no files (their ground
    truth computed on ``device``: the card unless the caller asks for
    the CPU); TEXMEX/HDF5 names read from ``$RAYUELA_DATA`` on the host.
    ``nbase=None`` takes the dataset's defining size where one exists
    (SIFT10M → 10M base vectors from the SIFT1B file; its ground truth is
    only valid at that size) and 1M otherwise."""
    name = name.lower()
    if name.startswith("synthetic"):
        if "corr" in name:
            synth_kw.setdefault("corr", True)
        if name.endswith("-small"):
            synth_kw.setdefault("d", 32)
            return make_synthetic(ntrain=2_000, nbase=20_000, nquery=200,
                                  name=name, device=device, **synth_kw)
        return make_synthetic(ntrain=ntrain, nbase=nbase or 1_000_000,
                              nquery=nquery, name=name, device=device,
                              **synth_kw)
    if name in _TEXMEX:
        if nbase is None:
            nbase = _TEXMEX[name].get("nbase", 1_000_000)
        return _load_texmex(name, ntrain, nbase, nquery)
    if name in _HDF5:
        return _load_hdf5(name, ntrain, nbase or 1_000_000, nquery)
    raise ValueError(f"unknown dataset {name!r}; known: "
                     f"{sorted(_TEXMEX) + sorted(_HDF5)} + synthetic*")
