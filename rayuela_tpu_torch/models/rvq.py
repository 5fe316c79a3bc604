"""Residual vector quantization (counterpart of
`rayuela_tpu/models/rvq.py`): m full-dimensional codebooks, each a
k-means on the residual the earlier stages leave; greedy encoding."""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayuela_tpu_torch.ops.kmeans import assign, kmeans
from rayuela_tpu_torch.ops.qerror import qerror
from rayuela_tpu_torch.utils import Ranks, gather_rows


class RVQModel(NamedTuple):
    codebooks: torch.Tensor  # (m, h, d) f32


def train_rvq(gen: torch.Generator, X: torch.Tensor, m: int,
              h: int = 256, niter: int = 25, ranks: Ranks | None = None
              ) -> tuple[RVQModel, torch.Tensor, torch.Tensor]:
    """Train RVQ → ``(model, codes (n, m) int32, train_error)``. With
    ``ranks`` (`utils.Ranks`), ``X`` is this rank's rows of a
    data-parallel run: each stage's k-means spans all the ranks'
    residuals, the codes are this rank's."""
    Xr = X
    Cs, Bs = [], []
    for _ in range(m):
        res = kmeans(gen, Xr, h, iters=niter, ranks=ranks)
        Xr = Xr - gather_rows(res.centers, res.assignments)
        Cs.append(res.centers)
        Bs.append(res.assignments)
    C = torch.stack(Cs)
    B = torch.stack(Bs, dim=1).to(torch.int32)
    return RVQModel(C), B, qerror(X, C, B, ranks=ranks)


def quantize_rvq(model: RVQModel | torch.Tensor, X: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy sequential encoding → ``(codes (n, m) int32, residual)``.
    Takes an `RVQModel` or a raw ``(m, h, d)`` codebook stack."""
    C = model.codebooks if isinstance(model, RVQModel) else model
    Xr = X
    Bs = []
    for Ci in C:
        a, _ = assign(Xr, Ci)
        Xr = Xr - gather_rows(Ci, a)
        Bs.append(a)
    return torch.stack(Bs, dim=1).to(torch.int32), Xr
