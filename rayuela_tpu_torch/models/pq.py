"""Product quantization (counterpart of `rayuela_tpu/models/pq.py`):
m contiguous subspaces, an independent h-center k-means in each,
per-subspace nearest-center encoding."""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayuela_tpu_torch.ops.kmeans import assign, kmeans
from rayuela_tpu_torch.ops.qerror import qerror
from rayuela_tpu_torch.utils import Ranks, cdiv, splitarray


class PQModel(NamedTuple):
    codebooks: torch.Tensor  # (m, h, ceil(d/m)) f32


def _split_subspaces(X: torch.Tensor, m: int) -> list[torch.Tensor]:
    """(n, d) → m contiguous (n, ceil(d/m)) subspaces; when d % m != 0
    the shorter ones are zero-padded (zero dims add nothing to distances
    and stay zero under center means)."""
    ds = cdiv(X.shape[1], m)
    return [torch.nn.functional.pad(X[:, st:st + sz], (0, ds - sz))
            for st, sz in splitarray(X.shape[1], m)]


def train_pq(gen: torch.Generator, X: torch.Tensor, m: int,
             h: int = 256, iters: int = 25, ranks: Ranks | None = None
             ) -> tuple[PQModel, torch.Tensor, torch.Tensor]:
    """Train PQ → ``(model, codes (n, m) int32, train_error)``. With
    ``ranks`` (`utils.Ranks`), ``X`` is this rank's rows of a
    data-parallel run: the m subspaces' k-means span all the ranks' rows
    and run at once, one collective a step for all m (`kmeans.kmeans`);
    the codes are this rank's."""
    subs = _split_subspaces(X, m)
    if ranks is None:
        res = [kmeans(gen, Xs, h, iters=iters) for Xs in subs]
        C = torch.stack([r.centers for r in res])
        B = torch.stack([r.assignments for r in res], dim=1)
    else:
        res = kmeans(gen, torch.stack(subs), h, iters=iters, ranks=ranks)
        C, B = res.centers, res.assignments.T
    B = B.to(torch.int32)
    return PQModel(C), B, qerror(X, C, B, pq=True, ranks=ranks)


def quantize_pq(model: PQModel, X: torch.Tensor) -> torch.Tensor:
    """Per-subspace nearest-center assignment → (n, m) int32."""
    C = model.codebooks
    subs = _split_subspaces(X, C.shape[0])
    return torch.stack([assign(Xs, C[j])[0] for j, Xs in enumerate(subs)],
                       dim=1)
