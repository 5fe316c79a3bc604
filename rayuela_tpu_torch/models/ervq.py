"""Enhanced RVQ / stacked quantizers (counterpart of
`rayuela_tpu/models/ervq.py`): fine-tune an RVQ model. Per codebook j,
the target is the data with every other codebook's decode taken out;
C[j] becomes the per-entry means of that target (empty entries
repicked), then the codes of stages j..m are re-encoded greedily.

The pass over j is a plain loop: the JAX package's masked scan existed
to compile one body for every j."""

from __future__ import annotations

import torch

from rayuela_tpu_torch.models.rvq import RVQModel, quantize_rvq, train_rvq
from rayuela_tpu_torch.ops.kmeans import assign, update_centers
from rayuela_tpu_torch.ops.qerror import qerror, reconstruct
from rayuela_tpu_torch.utils import Ranks, exact_f32, gather_rows


def _masked_reencode(C: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                     j: int) -> torch.Tensor:
    """Greedy sequential re-encode in which stages < j keep their codes
    → ``(n, m)`` int32. The residual is taken stage by stage, as in the
    JAX package, so the sums round the same way."""
    Xr, cols = X, []
    for i in range(C.shape[0]):
        a = B[:, i] if i < j else assign(Xr, C[i])[0]
        Xr = Xr - gather_rows(C[i], a)
        cols.append(a)
    return torch.stack(cols, dim=1).to(torch.int32)


def train_ervq(X: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               niter: int = 25, ranks: Ranks | None = None
               ) -> tuple[RVQModel, torch.Tensor, torch.Tensor]:
    """Fine-tune RVQ codes ``B (n, m)`` and codebooks ``C (m, h, d)``
    (typically `train_rvq`'s) → ``(model, codes, error)``. With
    ``ranks`` (`utils.Ranks`), ``X`` and ``B`` are this rank's rows of a
    data-parallel run: the targets and the re-encode are per row, the
    entry means and the repick span all the ranks' rows
    (`kmeans.update_centers`), and so does the error."""
    exact_f32()
    h = C.shape[1]
    C, B = C.clone(), B.to(torch.int32)
    for _ in range(niter):
        for j in range(C.shape[0]):
            bj = B[:, j]
            # the target of codebook j: the data less every OTHER
            # codebook's decode
            Xd = X - reconstruct(C, B) + gather_rows(C[j], bj)
            C[j] = update_centers(Xd, bj, h, C[j], ranks=ranks)
            B = _masked_reencode(C, B, X, j)
    return RVQModel(C), B, qerror(X, C, B, ranks=ranks)


def train_ervq_from_scratch(gen: torch.Generator, X: torch.Tensor, m: int,
                            h: int = 256, niter: int = 25,
                            ranks: Ranks | None = None
                            ) -> tuple[RVQModel, torch.Tensor, torch.Tensor]:
    """RVQ init (``gen`` seeds its k-means) + ERVQ fine-tuning."""
    model, B, _ = train_rvq(gen, X, m, h, niter, ranks=ranks)
    return train_ervq(X, B, model.codebooks, niter, ranks=ranks)


def quantize_ervq(model: RVQModel | torch.Tensor, X: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode with an ERVQ model: RVQ's greedy sequential encoder (ERVQ
    changes how the codebooks are trained, not how vectors encode)."""
    return quantize_rvq(model, X)
