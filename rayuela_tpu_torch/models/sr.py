"""LSQ++, the stochastic relaxations SR-C and SR-D on top of LSQ
(counterpart of `rayuela_tpu/models/sr.py`). SR-C adds annealed Gaussian
noise to the rotated data before each codebook update; SR-D adds it to
the updated codebooks before each encoding. Training runs in the
rotated frame and the rotation is folded into the codebooks at the end,
so search needs no separate R."""

from __future__ import annotations

import torch

from rayuela_tpu_torch.models.lsq import LSQModel
from rayuela_tpu_torch.ops.codebook_update import update_codebooks
from rayuela_tpu_torch.ops.icm import encoding_icm
from rayuela_tpu_torch.ops.qerror import qerror
from rayuela_tpu_torch.utils import exact_f32


def apply_schedule(stdev, it: int, niter: int, schedule: int = 1,
                   p: float = 0.5):
    """Annealing schedules: 1: ``(1 - it/niter)^p``; 2:
    ``1/(1 + it)^p``; 3: ``p^(it/2)``, times ``stdev``. Schedule 1 is
    exactly 0 at (and past) the last iteration, where a pow through
    exp(p log x) would give NaN."""
    if schedule == 1:
        base = max(1.0 - it / niter, 0.0)
        return stdev * (base ** p if base > 0 else 0.0)
    if schedule == 2:
        return stdev / (1.0 + it) ** p
    if schedule == 3:
        return stdev * p ** (it / 2.0)
    raise ValueError(f"unknown schedule {schedule}")


def sr_d_perturb(gen: torch.Generator, C: torch.Tensor, it: int,
                 niter: int, schedule: int = 1, p: float = 0.5
                 ) -> torch.Tensor:
    """SR-D: per-dimension annealed Gaussian noise on the codebooks; the
    base std is the (population) per-dim std of all m*h codewords over
    m."""
    m, h, d = C.shape
    std = torch.std(C.reshape(m * h, d), dim=0, correction=0) / m
    std = apply_schedule(std, it, niter, schedule, p)
    return C + torch.randn(C.shape, generator=gen, device=gen.device) * std


def sr_c_perturb(gen: torch.Generator, X: torch.Tensor, it: int,
                 niter: int, schedule: int = 1, p: float = 0.5
                 ) -> torch.Tensor:
    """SR-C: per-dimension annealed Gaussian noise on the data."""
    std = torch.std(X, dim=0, correction=0)
    std = apply_schedule(std, it, niter, schedule, p)
    return X + torch.randn(X.shape, generator=gen, device=gen.device) * std


def train_sr(gen: torch.Generator, X: torch.Tensor, B0: torch.Tensor,
             R0: torch.Tensor, h: int = 256, niter: int = 25,
             ilsiter: int = 8, icmiter: int = 4, npert: int = 4,
             randord: bool = True, method: str = "SR_D",
             schedule: int = 1, p: float = 0.5
             ) -> tuple[LSQModel, torch.Tensor, torch.Tensor]:
    """Train LSQ++ (SR-C or SR-D) from init codes and rotation (usually
    ChainQ's) → ``(model, codes (n, m) int32, obj (niter+1,))``, the
    rotation folded into the final codebooks. ``gen`` lies on X's
    device."""
    if method not in ("SR_C", "SR_D"):
        raise ValueError(f"unknown SR method {method!r}")
    exact_f32()
    ils = dict(ilsiter=ilsiter, icmiter=icmiter, npert=npert,
               randord=randord)
    RX = X @ R0

    def sr_step(B, it):
        """Codebook update with the method's noise injection."""
        if method == "SR_C":
            return update_codebooks(
                sr_c_perturb(gen, RX, it, niter, schedule, p), B, h)
        return sr_d_perturb(gen, update_codebooks(RX, B, h), it, niter,
                            schedule, p)

    C = sr_step(B0, 0 if method == "SR_C" else 1)
    B = encoding_icm(gen, RX, C, B0, **ils)
    obj = torch.zeros(niter + 1, dtype=X.dtype, device=X.device)
    for it in range(niter):
        obj[it] = qerror(RX, C, B)
        C = sr_step(B, it + 1)
        B = encoding_icm(gen, RX, C, B, **ils)
    obj[niter] = qerror(RX, C, B)
    return LSQModel(torch.einsum("de,mhe->mhd", R0, C)), B, obj
