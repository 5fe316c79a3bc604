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


def update_codebooks(X: torch.Tensor, B: torch.Tensor, h: int = 256,
                     method: str = "fastbin", rho: float = 1e-4
                     ) -> torch.Tensor:
    """Full-dimensional codebook update → ``C (m, h, d)``. ``fastbin``
    and ``fast`` are the direct ridge solve (the same math);
    ``naive`` and ``lsqr``/``lsmr`` are not ported."""
    if method in ("naive", "lsqr", "lsmr"):
        raise NotImplementedError(
            f"codebook update {method!r} is not ported yet (ROADMAP "
            "A10); use 'fastbin'")
    if method not in ("fastbin", "fast"):
        raise ValueError(f"unknown codebook update method {method!r}")
    G, F = codebook_stats(X, B, h)
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


def update_codebooks_generic(*args, **kwargs):
    """Structured update for arbitrary dimension supports: not ported."""
    raise NotImplementedError("the generic structured codebook update is "
                              "not ported yet (ROADMAP A10)")
