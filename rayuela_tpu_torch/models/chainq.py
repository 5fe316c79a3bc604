"""ChainQ, chain-restricted tree quantization with Viterbi encoding
(counterpart of `rayuela_tpu/models/chainq.py`): full-dimensional
codebooks whose supports overlap in a chain, trained by alternating a
rotation update (SVD of ``X^T X_hat``), the chain codebook update and
exact Viterbi re-encoding (kernel K13 on the card). No random draws:
from the same init codes and rotation it is deterministic."""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayuela_tpu_torch.models.opq import OPQModel
from rayuela_tpu_torch.ops.codebook_update import update_codebooks_chain
from rayuela_tpu_torch.ops.qerror import qerror, reconstruct
from rayuela_tpu_torch.ops.viterbi import viterbi_encode
from rayuela_tpu_torch.utils import exact_f32


class ChainQModel(NamedTuple):
    codebooks: torch.Tensor  # (m, h, d) f32, chain-supported
    R: torch.Tensor          # (d, d) f32 rotation


def train_chainq(X: torch.Tensor, B0: torch.Tensor, R0: torch.Tensor,
                 h: int = 256, niter: int = 25
                 ) -> tuple[ChainQModel, torch.Tensor, torch.Tensor]:
    """Train ChainQ from init codes and rotation (usually OPQ's) →
    ``(model, codes (n, m) int32, obj (niter+1,))``. Per iteration: the
    objective, R from the SVD of ``X^T X_hat``, the chain codebook
    update on the rotated data, Viterbi re-encode."""
    exact_f32()
    RX = X @ R0
    C = update_codebooks_chain(RX, B0, h)
    B = viterbi_encode(RX, C)
    R = R0
    obj = torch.zeros(niter + 1, dtype=X.dtype, device=X.device)
    for it in range(niter):
        obj[it] = qerror(X @ R, C, B)
        U, _, Vt = torch.linalg.svd(X.T @ reconstruct(C, B),
                                    full_matrices=False)
        R = U @ Vt
        RX = X @ R
        C = update_codebooks_chain(RX, B, h)
        B = viterbi_encode(RX, C)
    obj[niter] = qerror(X @ R, C, B)
    return ChainQModel(C, R), B, obj


def train_chainq_from_opq(X: torch.Tensor, opq: OPQModel,
                          B_opq: torch.Tensor, h: int = 256,
                          niter: int = 25):
    """The pipeline stage OPQ → ChainQ."""
    return train_chainq(X, B_opq, opq.R, h=h, niter=niter)


def quantize_chainq(model: ChainQModel, X: torch.Tensor) -> torch.Tensor:
    """Encode: rotate, then exact Viterbi → (n, m) int32."""
    exact_f32()
    return viterbi_encode(X @ model.R, model.codebooks)
