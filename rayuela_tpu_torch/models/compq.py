"""Competitive quantization (counterpart of `rayuela_tpu/models/compq.py`):
width-H beam-search encoding over the residual chain, and a batched
codebook update from the beam codes: the reference's SGD rule with its
step capped per entry, or the exact least-squares solve.

The beam's distances are plain f32 matrix products (TF32 off) and its
selection `torch.topk`, on all vectors of a chunk at once. The SGD
step's per-entry sums ``onehot(B_i)^T X_r`` go through
`utils.segment_sum`, never a float atomic, so training on the card is
reproducible."""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayuela_tpu_torch.ops.codebook_update import _solve_direct, codebook_stats
from rayuela_tpu_torch.ops.qerror import qerror
from rayuela_tpu_torch.utils import (Ranks, exact_f32, segment_sum, sqdist,
                                     summed)

# vectors a beam chunk: its (chunk, H, h) f32 candidate block is 16 KB a
# vector at H = 16, h = 256, 256 MB a chunk, enough work to fill the card
CHUNK = 16384


class CompQModel(NamedTuple):
    codebooks: torch.Tensor  # (m, h, d) f32


def _beam_chunk(Xc: torch.Tensor, C: torch.Tensor, H: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Width-H beam search for one chunk → ``(codes (nc, m) int32,
    final residual (nc, d))`` of the best beam. Each stage keeps the H
    cheapest of the (beam, entry) extensions, ascending."""
    m, h, d = C.shape
    nc = Xc.shape[0]
    _, idx = torch.topk(sqdist(Xc, C[0]), H, dim=1, largest=False,
                        sorted=True)                       # (nc, H)
    res = Xc[:, None, :] - C[0][idx]                       # (nc, H, d)
    codes = torch.zeros(nc, H, m, dtype=torch.int64, device=Xc.device)
    codes[:, :, 0] = idx
    for i in range(1, m):
        # |res_b - c|^2 for every (beam b, entry c)
        cand = sqdist(res.reshape(nc * H, d), C[i]).reshape(nc, H * h)
        _, loc = torch.topk(cand, H, dim=1, largest=False, sorted=True)
        b_sel, c_sel = loc // h, loc % h                   # (nc, H)
        res = res.gather(1, b_sel[:, :, None].expand(nc, H, d)) - C[i][c_sel]
        codes = codes.gather(1, b_sel[:, :, None].expand(nc, H, m))
        codes[:, :, i] = c_sel
    return codes[:, 0].to(torch.int32), res[:, 0]


def quantize_compq(model: CompQModel | torch.Tensor, X: torch.Tensor,
                   H: int = 16, chunk: int = CHUNK
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search encoding → ``(codes (n, m) int32, final residuals
    (n, d))``, ``chunk`` vectors at a time."""
    C = model.codebooks if isinstance(model, CompQModel) else model
    exact_f32()
    # one chunk of no rows where X has none (a rank's empty share)
    out = [_beam_chunk(X[s:s + chunk], C, H)
           for s in range(0, max(X.shape[0], 1), chunk)]
    return (torch.cat([b for b, _ in out]), torch.cat([r for _, r in out]))


def _layer_lrs(m: int, lr_total: float, device=None) -> torch.Tensor:
    """Per-layer rates ``∝ 1/(log2(i)+1)``, normalized to sum
    ``lr_total``."""
    raw = 1.0 / (torch.log2(torch.arange(1, m + 1, dtype=torch.float32,
                                         device=device)) + 1.0)
    return raw / raw.sum() * lr_total


def train_compq(X: torch.Tensor, C0: torch.Tensor, B0: torch.Tensor,
                niter: int = 10, H: int = 16, lr_total: float = 0.01,
                chunk: int = CHUNK, update: str = "sgd",
                ranks: Ranks | None = None
                ) -> tuple[CompQModel, torch.Tensor, torch.Tensor]:
    """Train CompQ from an init (typically RVQ) → ``(model, codes,
    obj (niter+1,))``, ``obj[it]`` the error before iteration ``it``.

    Each iteration re-encodes by the beam, then updates the codebooks:
    ``update="sgd"`` takes one batched step per codebook, ``C_i +=
    step * onehot(B_i)^T X_r / cnt`` at the final residuals ``X_r``,
    with ``step = 1 - (1 - 2 lr_i)^cnt``: the decay toward the residual
    mean that the reference's online rule reaches over ``cnt`` visits of
    an entry. Uncapped, the batched step ``2 lr_i cnt`` grows with n / h
    and training diverges at n = 1e5. ``update="lsq"`` solves the
    least-squares codebooks for the beam codes exactly (fastbin).

    With ``ranks`` (`utils.Ranks`), ``X`` and ``B0`` are this rank's rows
    of a data-parallel run: the beam is per row, the step's sums and
    counts, the normal-equation statistics and the objective are summed
    over the ranks, and the solves run on identical bits on every
    rank."""
    if update not in ("sgd", "lsq"):
        raise ValueError(f"update {update!r}: 'sgd' or 'lsq'")
    m, h, _ = C0.shape
    C, B = C0.clone(), B0.to(torch.int32)
    lrs = _layer_lrs(m, lr_total, X.device)
    obj = torch.zeros(niter + 1, dtype=torch.float32, device=X.device)
    for it in range(niter):
        obj[it] = qerror(X, C, B, ranks=ranks)
        B, Xr = quantize_compq(C, X, H=H, chunk=chunk)
        if update == "lsq":
            G, F = codebook_stats(X, B, h)
            C = _solve_direct(summed(ranks, G), summed(ranks, F), h, 1e-4)
            continue
        C = C.clone()
        for i in range(m):
            bi = B[:, i].long()
            grad = summed(ranks, segment_sum(Xr, bi, h))   # (h, d)
            cnt = summed(ranks, torch.bincount(bi, minlength=h).to(
                torch.float32))
            cnt = cnt.clamp_min(1.0)[:, None]
            step = 1.0 - (1.0 - 2.0 * lrs[i]) ** cnt       # in (0, 1)
            C[i] = C[i] + step * grad / cnt
    obj[niter] = qerror(X, C, B, ranks=ranks)
    return CompQModel(C), B, obj
