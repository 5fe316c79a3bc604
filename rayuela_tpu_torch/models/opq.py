"""Optimized product quantization (counterpart of
`rayuela_tpu/models/opq.py`): a d x d rotation R learned jointly with
per-subspace codebooks. Per iteration: the objective; R = U V^T from the
SVD of ``X^T X_hat``; one Lloyd step per subspace on the re-rotated data
(centres from the OLD assignments, an empty cluster keeps its centre,
then re-assign). Full f32 throughout (TF32 off)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayuela_tpu_torch.models.pq import PQModel, _split_subspaces, quantize_pq
from rayuela_tpu_torch.ops.kmeans import assign
from rayuela_tpu_torch.ops.qerror import reconstruct_pq
from rayuela_tpu_torch.utils import (Ranks, exact_f32, row_mean, rows_at,
                                     segment_sum, summed)


class OPQModel(NamedTuple):
    codebooks: torch.Tensor  # (m, h, ceil(d/m)) f32
    R: torch.Tensor          # (d, d) f32 orthonormal rotation


def _subspace_lloyd(C: torch.Tensor, Xs: torch.Tensor, B: torch.Tensor,
                    ranks: Ranks | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd step in one subspace: centres from the old assignments
    ``B (n,)`` (empties keep theirs), then the new assignments."""
    h = C.shape[0]
    counts = summed(ranks, torch.bincount(B.long(), minlength=h).to(Xs.dtype))
    sums = summed(ranks, segment_sum(Xs, B, h))
    C = torch.where((counts > 0)[:, None],
                    sums / counts.clamp_min(1.0)[:, None], C)
    return C, assign(Xs, C)[0]


def _objective(X, R, C, B, ranks=None):
    Xr = X @ R
    return row_mean(ranks, ((Xr - reconstruct_pq(C, B, X.shape[1])) ** 2
                            ).sum(-1))


def train_opq(gen: torch.Generator, X: torch.Tensor, m: int, h: int = 256,
              niter: int = 25, init: str = "natural",
              ranks: Ranks | None = None
              ) -> tuple[OPQModel, torch.Tensor, torch.Tensor]:
    """Train OPQ → ``(model, codes (n, m) int32, obj (niter+1,))``.
    ``init``: "natural" (R = I) or "random" (a random orthonormal R).
    Codebooks start from h distinct random training vectors.

    With ``ranks`` (`utils.Ranks`), ``X`` is this rank's rows of a
    data-parallel run and ``gen`` is seeded the same on every rank: the
    h init rows are drawn over all n rows and assembled from their
    owners (`utils.rows_at`), ``X^T X_hat``, the Lloyd steps' counts and
    sums and the objective are summed over the ranks, and the SVD runs
    on identical bits on every rank; the codes are this rank's."""
    exact_f32()
    n, d = X.shape
    if ranks is not None:
        n = ranks.n
    if init == "natural":
        R = torch.eye(d, dtype=X.dtype, device=X.device)
    elif init == "random":
        R = torch.linalg.svd(torch.randn(d, d, generator=gen,
                                         device=gen.device).to(X))[0]
    else:
        raise ValueError(f"unknown init {init!r}")
    perm = torch.randperm(n, generator=gen, device=gen.device)[:h]
    XR = X @ R
    Xs = _split_subspaces(XR, m)
    C = _split_subspaces(rows_at(ranks, XR, perm.to(X.device)), m)
    B = [assign(x, c)[0] for x, c in zip(Xs, C)]
    obj = torch.zeros(niter + 1, dtype=X.dtype, device=X.device)
    for it in range(niter):
        Bm = torch.stack(B, dim=1)
        Xhat = reconstruct_pq(torch.stack(C), Bm, d)
        obj[it] = row_mean(ranks, ((X @ R - Xhat) ** 2).sum(-1))
        U, _, Vt = torch.linalg.svd(summed(ranks, X.T @ Xhat),
                                    full_matrices=False)
        R = U @ Vt
        Xs = _split_subspaces(X @ R, m)
        for j in range(m):
            C[j], B[j] = _subspace_lloyd(C[j], Xs[j], B[j], ranks)
    C, B = torch.stack(C), torch.stack(B, dim=1).to(torch.int32)
    obj[niter] = _objective(X, R, C, B, ranks)
    return OPQModel(C, R), B, obj


def quantize_opq(model: OPQModel, X: torch.Tensor) -> torch.Tensor:
    """Encode: rotate, then per-subspace nearest centre → (n, m) int32."""
    exact_f32()
    return quantize_pq(PQModel(model.codebooks), X @ model.R)
