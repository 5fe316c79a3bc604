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
from rayuela_tpu_torch.ops.codebook_update import _chain_solve, codebook_stats
from rayuela_tpu_torch.ops.qerror import reconstruct, veccost
from rayuela_tpu_torch.ops.viterbi import viterbi_encode
from rayuela_tpu_torch.utils import Ranks, exact_f32, summed


class ChainQModel(NamedTuple):
    codebooks: torch.Tensor  # (m, h, d) f32, chain-supported
    R: torch.Tensor          # (d, d) f32 rotation


def train_chainq(X: torch.Tensor, B0: torch.Tensor, R0: torch.Tensor,
                 h: int = 256, niter: int = 25, *, chunk: int = 2048,
                 impl: str = "auto", ranks: Ranks | None = None
                 ) -> tuple[ChainQModel, torch.Tensor, torch.Tensor]:
    """Train ChainQ from init codes and rotation (usually OPQ's) →
    ``(model, codes (n, m) int32, obj (niter+1,))``. Per iteration: the
    objective, R from the SVD of ``X^T X_hat``, the chain codebook
    update on the rotated data, Viterbi re-encode (``chunk``, ``impl``).

    With ``ranks`` (`utils.Ranks`), ``X`` and ``B0`` are this rank's rows
    of a data-parallel run: the normal-equation statistics, ``X^T X_hat``
    and the squared error are sums over the rows, summed over the ranks
    (`parallel.train_chainq_sharded`)."""
    exact_f32()
    n = X.shape[0] if ranks is None else ranks.n
    d, m = X.shape[1], B0.shape[1]

    def solve(RX, B):
        G, F = codebook_stats(RX, B, h)
        return _chain_solve(summed(ranks, G), summed(ranks, F), h=h, d=d,
                            m=m, rho=1e-4)

    def error(RX, C, B):
        return summed(ranks, veccost(RX, C, B).sum()) / n

    RX = X @ R0
    C = solve(RX, B0)
    B = viterbi_encode(RX, C, chunk=chunk, impl=impl)
    R = R0
    obj = torch.zeros(niter + 1, dtype=X.dtype, device=X.device)
    for it in range(niter):
        obj[it] = error(RX, C, B)
        U, _, Vt = torch.linalg.svd(summed(ranks, X.T @ reconstruct(C, B)),
                                    full_matrices=False)
        R = U @ Vt
        RX = X @ R
        C = solve(RX, B)
        B = viterbi_encode(RX, C, chunk=chunk, impl=impl)
    obj[niter] = error(RX, C, B)
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
