"""Norms codebook for additive-model search (counterpart of
`rayuela_tpu/search/norms.py`): one extra code byte per vector holds a
quantized ``|x_hat|^2`` so the scan adds the norm term from a table."""

from __future__ import annotations

import torch

from rayuela_tpu_torch.ops.kmeans import kmeans
from rayuela_tpu_torch.ops.qerror import reconstruct
from rayuela_tpu_torch.utils import Ranks


def get_norms_codebook(gen: torch.Generator, C: torch.Tensor,
                       B: torch.Tensor, h: int = 256,
                       ranks: Ranks | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """k-means the decode norms → ``(norms_codes (n,), norms_cbook (h,))``.
    With ``ranks`` (`utils.Ranks`), ``B`` is this rank's rows of a
    data-parallel run: the k-means spans all the ranks' norms, the codes
    are this rank's."""
    Xhat = reconstruct(C, B)
    dbnorms = (Xhat * Xhat).sum(-1, keepdim=True)
    res = kmeans(gen, dbnorms, h, iters=25, ranks=ranks)
    return res.assignments, res.centers.reshape(-1)


def quantize_norms(C: torch.Tensor, B: torch.Tensor,
                   norms_cbook: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-scalar assignment of each decode's squared norm →
    ``(norm_codes (n,) int32, exact_norms (n,) f32)``."""
    Xhat = reconstruct(C, B)
    norms = (Xhat * Xhat).sum(-1)
    d2 = (norms[:, None] - norms_cbook[None, :]) ** 2
    return d2.argmin(-1).to(torch.int32), norms
