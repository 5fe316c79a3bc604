"""Synthetic datasets with exact ground truth (counterpart of the
`synthetic` family in `rayuela_tpu/experiments/datasets.py`).

`make_synthetic` draws with numpy from a seed, exactly as the JAX
package does, so both packages see the same vectors for the same seed.
`exact_ground_truth` runs its f32 candidate scan in torch on ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rayuela_tpu_torch.utils import exact_f32


class Dataset(NamedTuple):
    name: str
    Xt: np.ndarray       # (ntrain, d) f32 — training vectors
    Xb: np.ndarray       # (nbase, d)  f32 — base set
    Xq: np.ndarray       # (nquery, d) f32 — queries
    gt: np.ndarray       # (nquery,) int32 — 0-based true-NN ids into Xb


def make_synthetic(d: int = 128, ntrain: int = 10_000,
                   nbase: int = 100_000, nquery: int = 1_000,
                   ncenters: int = 64, noise: float = 0.3,
                   seed: int = 0, name: str = "synthetic",
                   corr: bool = False, device="cpu") -> Dataset:
    """Clustered Gaussian data with exact brute-force ground truth.

    Queries are perturbed base vectors, so recall curves mean something
    at small scale. ``corr=True`` draws clusters and noise in a latent
    space with a decaying spectrum and rotates it by a random orthogonal
    matrix: anisotropic, correlated data like real descriptors, where
    the method ordering of the LSQ++ paper holds."""
    return _make_synthetic(d, ntrain, nbase, nquery, ncenters, noise,
                           seed, name, corr, device)


def _make_synthetic(d: int, ntrain: int, nbase: int, nquery: int,
                    ncenters: int, noise: float, seed: int, name: str,
                    corr: bool, device="cpu") -> Dataset:
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
                       device="cpu") -> np.ndarray:
    """True-NN id per query. Two passes: an f32 scan on ``device`` (TF32
    off) collects ``ncand`` candidates per query, then float64 on the
    host picks the winner among them. A margin check sends every query
    whose f64 winner does not beat the f32 boundary by more than the
    f32 error bound to a float64 scan of the whole base."""
    exact_f32()
    nquery, d = Xq.shape
    n = Xb.shape[0]
    ncand = min(ncand, n)
    Xbd = torch.as_tensor(Xb, dtype=torch.float32, device=device)
    b2 = (Xbd * Xbd).sum(1)
    Xb64 = None
    gt = np.empty(nquery, np.int64)
    chunk = max(1, min(4096, (1 << 28) // max(n, 1) or 1))
    for s in range(0, nquery, chunk):
        q = torch.as_tensor(Xq[s:s + chunk], dtype=torch.float32,
                            device=device)
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
                                       device=device)
                gt[s + u] = int(((Xb64 - qrow) ** 2).sum(1).argmin())
    return gt.astype(np.int32)
