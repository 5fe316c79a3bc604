"""Least-squares codebook update for fixed codes (counterpart of
`rayuela_tpu/ops/codebook_update.py`): ``min_C |X - U C|^2`` with ``U
(n, m*h)`` the one-hot indicator of the codes, through its normal
equations

    G = U^T U   (mh, mh)   co-occurrence counts
    F = U^T X   (mh, d)    per-entry data sums

G is counted exactly in integers; F is the deterministic one-hot segment
sum of `utils.segment_sum`. Solves run in full f32 (TF32 off) with the
JAX package's relative ridge ``rho * mean(diag G)``.
"""

from __future__ import annotations

import numpy as np
import torch

from rayuela_tpu_torch.utils import exact_f32, segment_sum, splitarray

# rows per co-occurrence count block: bounds the (chunk, m, m) pair ids
_STATS_CHUNK = 1 << 14


def codebook_stats(X: torch.Tensor, B: torch.Tensor, h: int = 256,
                   chunk: int = _STATS_CHUNK
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normal-equation statistics ``(G (mh, mh) f32, F (mh, d) f32)``."""
    n, m = B.shape
    mh = m * h
    idx = B.long() + torch.arange(m, device=B.device)[None, :] * h
    counts = torch.zeros(mh * mh, dtype=torch.int64, device=B.device)
    for s in range(0, n, chunk):
        ic = idx[s:s + chunk]
        pairs = ic[:, :, None] * mh + ic[:, None, :]
        counts += torch.bincount(pairs.reshape(-1), minlength=mh * mh)
    G = counts.reshape(mh, mh).to(torch.float32)
    return G, segment_sum(X, idx, mh)


def _ridge(G: torch.Tensor, rho: float) -> torch.Tensor:
    """``rho * max(mean(diag G), 1)``: the ridge scales with the counts,
    which grow with n (an absolute 1e-4 vanishes beside diag ~n/h)."""
    return rho * torch.clamp(torch.diagonal(G).mean(), min=1.0)


def _solve_direct(G: torch.Tensor, F: torch.Tensor, h: int,
                  rho: float) -> torch.Tensor:
    """Ridge solve of the normal equations → ``C (m, h, d)``. G is
    near-singular by construction (each codebook's one-hot columns sum
    to the same all-ones vector), hence the relative ridge and full f32
    (the TPU's single-pass bf16 solve blew up without both)."""
    exact_f32()
    mh, d = F.shape
    A = G + _ridge(G, rho) * torch.eye(mh, dtype=G.dtype, device=G.device)
    return torch.linalg.solve(A, F).reshape(mh // h, h, d)


def _solve_cg(G: torch.Tensor, F: torch.Tensor, h: int, rho: float,
              maxiter: int, tol: float = 1e-5) -> torch.Tensor:
    """Conjugate gradient on the ridged normal equations, all d
    right-hand sides as one system with Frobenius inner products, as the
    JAX package's ``jax.scipy.sparse.linalg.cg`` on the (mh, d) matrix
    runs it: from zero, until ``|r|^2 <= tol^2 |F|^2`` or ``maxiter``
    steps. The matvecs run in exact f32, as `_solve_direct`'s solve."""
    exact_f32()
    mh, d = F.shape
    A = G + _ridge(G, rho) * torch.eye(mh, dtype=G.dtype, device=G.device)
    x = torch.zeros_like(F)
    r = F.clone()
    p = r.clone()
    gamma = (r * r).sum()
    atol2 = tol * tol * (F * F).sum()
    for _ in range(maxiter):
        if not bool(gamma > atol2):
            break
        Ap = A @ p
        alpha = gamma / (p * Ap).sum()
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = (r * r).sum()
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
    return x.reshape(mh // h, h, d)


def update_codebooks(X: torch.Tensor, B: torch.Tensor, h: int = 256,
                     method: str = "fastbin", rho: float = 1e-4
                     ) -> torch.Tensor:
    """Full-dimensional codebook update → ``C (m, h, d)``. ``fastbin``
    and ``fast`` are the direct ridge solve (the same math); ``naive``
    the ridge-free minimum-norm least squares (the pseudo-inverse, whose
    cut-off is ``jnp.linalg.lstsq``'s: eps times the larger dimension,
    relative to the largest singular value; the card's ``lstsq`` has no
    driver for a rank-deficient G); ``lsqr``/``lsmr`` conjugate
    gradient on the ridged normal equations (`_solve_cg`, 200 steps)."""
    if method not in ("fastbin", "fast", "naive", "lsqr", "lsmr"):
        raise ValueError(f"unknown codebook update method {method!r}")
    G, F = codebook_stats(X, B, h)
    if method == "naive":
        exact_f32()
        mh, d = F.shape
        return (torch.linalg.pinv(G) @ F).reshape(mh // h, h, d)
    if method in ("lsqr", "lsmr"):
        return _solve_cg(G, F, h, rho, maxiter=200)
    return _solve_direct(G, F, h, rho)


def chain_dims(d: int, m: int) -> list[tuple[int, int]]:
    """Chain supports: d dims in m-1 balanced ranges; codebook i spans
    ranges i-1 and i. Returns each range's ``(start, size)``."""
    return splitarray(d, m - 1)


def _chain_solve(G: torch.Tensor, F: torch.Tensor, *, h: int, d: int,
                 m: int, rho: float) -> torch.Tensor:
    """Dims of range i touch only codebooks i and i+1, so each range
    solves the (2h, 2h) block of G for that pair: one batched solve over
    the m-1 blocks → ``C (m, h, d)`` zero outside each codebook's
    ranges. The ridged blocks are symmetric positive definite, so the
    batched solve is a Cholesky one (batched LU through some CPU MKL
    builds fails with SLASWP parameter errors on several threads)."""
    exact_f32()
    sub = chain_dims(d, m)
    ds_max = max(s for _, s in sub)
    eye = _ridge(G, rho) * torch.eye(2 * h, dtype=G.dtype, device=G.device)
    Gs = torch.stack([G[i * h:(i + 2) * h, i * h:(i + 2) * h] + eye
                      for i in range(m - 1)])
    Fs = torch.stack([torch.nn.functional.pad(
        F[i * h:(i + 2) * h, st:st + sz], (0, ds_max - sz))
        for i, (st, sz) in enumerate(sub)])
    sols = torch.cholesky_solve(Fs, torch.linalg.cholesky(Gs))
    C = torch.zeros(m, h, d, dtype=F.dtype, device=F.device)
    for i, (st, sz) in enumerate(sub):
        C[i, :, st:st + sz] = sols[i, :h, :sz]
        C[i + 1, :, st:st + sz] = sols[i, h:, :sz]
    return C


def update_codebooks_chain(X: torch.Tensor, B: torch.Tensor, h: int = 256,
                           rho: float = 1e-4) -> torch.Tensor:
    """Chain codebook update → ``C (m, h, d)`` with zero support outside
    each codebook's dim ranges."""
    G, F = codebook_stats(X, B, h)
    return _chain_solve(G, F, h=h, d=X.shape[1], m=B.shape[1], rho=rho)


def get_cbdims_chain(d: int, m: int) -> np.ndarray:
    """Chain supports as a ``(d, m)`` boolean map: dimension i belongs
    to codebook j (the d dims in m-1 balanced ranges; codebook j spans
    ranges j-1 and j)."""
    dim2C = np.zeros((d, m), dtype=bool)
    for i, (st, sz) in enumerate(chain_dims(d, m)):
        dim2C[st:st + sz, i] = True
        dim2C[st:st + sz, i + 1] = True
    return dim2C


def update_codebooks_generic(X: torch.Tensor, B: torch.Tensor, h: int,
                             dim2C, rho: float = 1e-4) -> torch.Tensor:
    """Structured codebook update for arbitrary dimension supports →
    ``C (m, h, d)``, zero outside each codebook's dims. ``dim2C`` is a
    ``(d, m)`` boolean map (dimension i ← codebook j) or a callable
    ``f(d, m)`` like `get_cbdims_chain`. The dims that share a support
    signature (the set of codebooks covering them) form one ridge solve
    with those dims as its right-hand sides."""
    d, m = X.shape[1], B.shape[1]
    if callable(dim2C):
        dim2C = dim2C(d, m)
    dim2C = np.asarray(dim2C, dtype=bool)
    if dim2C.shape != (d, m):
        raise ValueError(f"dim2C shape {dim2C.shape} != (d={d}, m={m})")
    exact_f32()
    G, F = codebook_stats(X, B, h)
    groups: dict[tuple[int, ...], list[int]] = {}
    for i in range(d):
        key = tuple(np.nonzero(dim2C[i])[0].tolist())
        if key:
            groups.setdefault(key, []).append(i)
    C = torch.zeros(m, h, d, dtype=F.dtype, device=F.device)
    ridge = _ridge(G, rho)
    for cbs, dims in groups.items():
        cols = torch.as_tensor(np.concatenate(
            [np.arange(c * h, (c + 1) * h) for c in cbs]), device=G.device)
        dl = torch.as_tensor(dims, device=G.device)
        A = G[cols][:, cols] + ridge * torch.eye(
            len(cols), dtype=G.dtype, device=G.device)
        # Cholesky, as `_chain_solve`: on chain supports each group is
        # one of its blocks, solved by the same factorization
        sol = torch.cholesky_solve(F[cols][:, dl], torch.linalg.cholesky(A))
        for j, c in enumerate(cbs):
            C[c][:, dl] = sol[j * h:(j + 1) * h]
    return C
