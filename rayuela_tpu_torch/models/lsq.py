"""LSQ, local search quantization (counterpart of
`rayuela_tpu/models/lsq.py`): the fastbin least-squares codebook update
alternating with ILS/ICM encoding (kernel K11 on the card). Starts from
ChainQ's (or OPQ's) codes and rotation; after the first codebook update
the rotation is folded into the codebooks, ``C0 = R0 . C0``, and
training runs in the original space."""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayuela_tpu_torch.ops.codebook_update import update_codebooks
from rayuela_tpu_torch.ops.icm import encoding_icm
from rayuela_tpu_torch.ops.qerror import qerror
from rayuela_tpu_torch.utils import exact_f32


class LSQModel(NamedTuple):
    codebooks: torch.Tensor  # (m, h, d) f32, original (unrotated) space


def train_lsq(gen: torch.Generator, X: torch.Tensor, B0: torch.Tensor,
              R0: torch.Tensor, h: int = 256, niter: int = 25,
              ilsiter: int = 8, icmiter: int = 4, npert: int = 4,
              randord: bool = True
              ) -> tuple[LSQModel, torch.Tensor, torch.Tensor]:
    """Train LSQ → ``(model, codes (n, m) int32, obj (niter+1,))``.
    ``gen`` lies on X's device."""
    exact_f32()
    ils = dict(ilsiter=ilsiter, icmiter=icmiter, npert=npert,
               randord=randord)
    C = update_codebooks(X @ R0, B0, h)
    C = torch.einsum("de,mhe->mhd", R0, C)
    B = encoding_icm(gen, X, C, B0, **ils)
    obj = torch.zeros(niter + 1, dtype=X.dtype, device=X.device)
    for it in range(niter):
        obj[it] = qerror(X, C, B)
        C = update_codebooks(X, B, h)
        B = encoding_icm(gen, X, C, B, **ils)
    obj[niter] = qerror(X, C, B)
    return LSQModel(C), B, obj


def quantize_lsq(gen: torch.Generator, model: LSQModel, X: torch.Tensor,
                 B0: torch.Tensor, ilsiter: int = 32, icmiter: int = 4,
                 npert: int = 4, randord: bool = True) -> torch.Tensor:
    """Base-set encoding: ILS/ICM from an init, with the reference's 4x
    ILS budget for base vectors."""
    return encoding_icm(gen, X, model.codebooks, B0, ilsiter=ilsiter,
                        icmiter=icmiter, npert=npert, randord=randord)
