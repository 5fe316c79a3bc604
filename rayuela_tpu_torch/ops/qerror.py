"""Reconstruction and quantization error (counterpart of
`rayuela_tpu/ops/qerror.py`)."""

from __future__ import annotations

import torch

from rayuela_tpu_torch.utils import (Ranks, exact_f32, gather_rows, row_mean,
                                     splitarray)


def reconstruct(C: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Additive decode ``x_hat[v] = sum_i C[i, B[v, i]]`` → (n, d),
    summed in codebook order."""
    acc = torch.zeros(B.shape[0], C.shape[2], dtype=C.dtype,
                      device=C.device)
    for i in range(C.shape[0]):
        acc = acc + gather_rows(C[i], B[:, i])
    return acc


def reconstruct_pq(C: torch.Tensor, B: torch.Tensor,
                   d: int | None = None) -> torch.Tensor:
    """Concatenative decode of per-subspace codebooks ``C (m, h, ds)``
    → (n, d). With ``d`` given and ``d % m != 0`` the subspaces are the
    balanced ranges of `splitarray` and each codebook's zero padding is
    dropped."""
    m, _, ds = C.shape
    subs = [gather_rows(C[j], B[:, j]) for j in range(m)]
    if d is None or d == m * ds:
        return torch.cat(subs, dim=1)
    return torch.cat([subs[j][:, :sz]
                      for j, (_, sz) in enumerate(splitarray(d, m))], dim=1)


def veccost(X: torch.Tensor, C: torch.Tensor, B: torch.Tensor, *,
            pq: bool = False) -> torch.Tensor:
    """Per-vector squared reconstruction error (n,)."""
    Xr = reconstruct_pq(C, B, X.shape[1]) if pq else reconstruct(C, B)
    e = X - Xr
    return (e * e).sum(-1)


def veccost_chunked(X: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
                    chunk: int = 16384) -> torch.Tensor:
    """`veccost` of an additive model with n streamed in chunks, so the
    decode transient stays bounded for base-sized n."""
    return torch.cat([veccost(X[s:s + chunk], C, B[s:s + chunk])
                      for s in range(0, X.shape[0], chunk)])


def qerror(X: torch.Tensor, C: torch.Tensor, B: torch.Tensor, *,
           pq: bool = False, ranks: Ranks | None = None) -> torch.Tensor:
    """Mean squared reconstruction error — the training objective (over
    the rows of all ``ranks`` where ``X`` is one rank's)."""
    return row_mean(ranks, veccost(X, C, B, pq=pq))


def qerror_pq(X: torch.Tensor, C: torch.Tensor, B: torch.Tensor
              ) -> torch.Tensor:
    """PQ objective (concatenative decode)."""
    return qerror(X, C, B, pq=True)


def qerror_opq(X: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
               R: torch.Tensor) -> torch.Tensor:
    """OPQ objective: the rotated data ``X R`` against the PQ decode."""
    exact_f32()
    return qerror(X @ R, C, B, pq=True)


def get_unaries(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """MRF unary terms ``(n, m, h)``: ``|c|^2 - 2 c.x`` per codebook
    entry, in full f32."""
    exact_f32()
    c2 = (C * C).sum(-1)
    return c2[None] - 2.0 * torch.einsum("nd,mhd->nmh", X, C)


def get_binaries(C: torch.Tensor) -> torch.Tensor:
    """All-pairs MRF binary terms ``(m, m, h, h)``,
    ``binaries[i, j] = 2 C_i C_j^T`` (diagonal unused)."""
    exact_f32()
    return 2.0 * torch.einsum("ihd,jgd->ijhg", C, C)
