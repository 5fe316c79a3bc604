"""Sharded LSQ / LSQ++ training (counterpart of
`rayuela_tpu/parallel/lsq_sharded.py`).

* **The codebook update**: each ``data`` rank counts its rows'
  normal-equation statistics (G, F), one all-reduce makes them global,
  and every rank solves the same (mh, mh) system replicated.
* **The encoding**: ILS/ICM is independent per vector; each rank encodes
  its rows with the shared codebooks (K11 on the card).

Every rank's codebooks are bit-identical after every step: the
all-reduce hands every rank the same bits of (G, F) (and of SR-C's
moments), every rank runs the same solve on them, and the replicated
random draws (SR-D's codebook noise) come from a generator seeded the
same on every rank (`utils.fold_in` of the caller's generator and the
step). The draws that differ by rank (SR-C's data noise, ICM's
perturbations) come from a generator seeded with the rank as well, the
JAX package's ``fold_in(key, shard)``.
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.models.lsq import LSQModel
from rayuela_tpu_torch.models.sr import apply_schedule, sr_d_perturb
from rayuela_tpu_torch.ops.codebook_update import _solve_direct, codebook_stats
from rayuela_tpu_torch.ops.icm import encoding_icm
from rayuela_tpu_torch.ops.qerror import reconstruct
from rayuela_tpu_torch.parallel.mesh import (Mesh, _all_reduce, _like,
                                             _rows, _same_rows, replicate)
from rayuela_tpu_torch.utils import exact_f32, fold_in

_METHODS = ("LSQ", "SR_C", "SR_D")


def _solve(mesh: Mesh, X, B, h: int, chunk: int = 1 << 14):
    G, F = codebook_stats(X, B, h, chunk=chunk)
    return _solve_direct(_all_reduce(mesh, G), _all_reduce(mesh, F), h,
                         1e-4)


def replicated_solve_matches(X: torch.Tensor, B: torch.Tensor, h: int,
                             chunk: int = 1 << 14) -> torch.Tensor:
    """The single-device codebook solve of ``X`` and its codes ``B`` →
    ``C (m, h, d)``: the statistics and the ridge solve a mesh's ranks
    all-reduce and run (`_solve`), on one device, for the equivalence
    tests of the sharded training."""
    exact_f32()
    G, F = codebook_stats(X, B, h, chunk=chunk)
    return _solve_direct(G, F, h, 1e-4)


def _sq_error(mesh: Mesh, X, C, B, n: int) -> torch.Tensor:
    res = X - reconstruct(C, B)
    return _all_reduce(mesh, (res * res).sum()) / n


def _rank_gen(mesh: Mesh, gen: torch.Generator, offset: int = 0):
    """The rank's stream of ``gen``: seeded with its ``data`` coordinate
    (plus ``offset``), on the mesh's device."""
    return fold_in(gen, offset + mesh.coords["data"], mesh.device)


def make_sr_train_step(mesh: Mesh, *, h: int, niter: int, ilsiter: int = 8,
                       icmiter: int = 4, npert: int = 4,
                       randord: bool = True, method: str = "SR_D",
                       schedule: int = 1, p: float = 0.5, chunk: int = 8192,
                       stats_chunk: int = 16384):
    """One SR / LSQ iteration over ``mesh`` → ``step(X, B, C, it, gen) ->
    (C', B', obj)``: ``X`` and ``B`` row-sharded (``B'`` comes back in
    ``X``'s form), ``C`` replicated, ``gen`` a generator seeded the same
    on every rank. The codebooks are solved from the all-reduced
    statistics, SR-D perturbs them with ``fold_in(gen, 0)`` (the same
    draws on every rank), ICM encodes each rank's rows with ``fold_in(gen,
    1 + rank)``, and ``obj`` is the squared error after the encode over
    the n rows. ``method="LSQ"`` adds no noise (SR-C's noise goes on the
    data before the statistics, as the caller's)."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")

    def step(X, B, C, it, gen):
        exact_f32()
        rows = _rows(mesh, X, torch.float32)
        brows = _rows(mesh, B, torch.int32)
        _same_rows(rows, brows)
        C = _solve(mesh, rows.local, brows.local, h, stats_chunk)
        if method == "SR_D":
            C = sr_d_perturb(fold_in(gen, 0, mesh.device), C, int(it), niter,
                             schedule, p)
        Bl = encoding_icm(_rank_gen(mesh, gen, 1), rows.local, C,
                          brows.local, ilsiter=ilsiter, icmiter=icmiter,
                          npert=npert, randord=randord, chunk=chunk)
        obj = _sq_error(mesh, rows.local, C, Bl, rows.n)
        return C, _like(mesh, X, Bl, rows), obj

    return step


def sharded_encoding_icm(mesh: Mesh, gen: torch.Generator, X, C, B0, *,
                         ilsiter: int = 8, icmiter: int = 4, npert: int = 4,
                         randord: bool = True, chunk: int = 8192):
    """Data-parallel ILS/ICM encode → codes ``(n, m) int32``: ``X`` and
    ``B0`` row-sharded (the codes come back in ``X``'s form), ``C``
    replicated; each rank perturbs with its own stream of ``gen``
    (`utils.fold_in` with its ``data`` coordinate)."""
    rows = _rows(mesh, X, torch.float32)
    brows = _rows(mesh, B0, torch.int32)
    _same_rows(rows, brows)
    B = encoding_icm(_rank_gen(mesh, gen), rows.local,
                     replicate(mesh, C).float(), brows.local,
                     ilsiter=ilsiter, icmiter=icmiter, npert=npert,
                     randord=randord, chunk=chunk)
    return _like(mesh, X, B, rows)


def train_lsq_family_sharded(mesh: Mesh, gen: torch.Generator, X, B0, R0,
                             *, h: int = 256, niter: int = 25,
                             ilsiter: int = 8, icmiter: int = 4,
                             npert: int = 4, randord: bool = True,
                             method: str = "LSQ", schedule: int = 1,
                             p: float = 0.5, chunk: int = 8192):
    """LSQ / SR-C / SR-D training over a mesh, the ``mesh=`` path of
    `api.train`: the contract of `models.lsq.train_lsq` /
    `models.sr.train_sr`, ``(LSQModel, codes (n, m), obj (niter+1,))``
    with the rotation folded into the codebooks. ``X``, ``B0``
    row-sharded (the codes come back in ``X``'s form), ``R0``
    replicated, ``gen`` seeded the same on every rank.

    As in the JAX package's sharded trainer, it runs in the rotated frame
    throughout with one final fold-back (R is orthonormal: the same
    optimization), step s draws from ``fold_in(gen, s)`` (init: 0 for the
    codebook step, 1 for the encode; iteration it: 2 it + 2, 2 it + 3),
    SR-C's per-dimension std comes from the all-reduced first and second
    moments of the n rows, and the draws that differ by rank are seeded
    with it."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    exact_f32()
    rows = _rows(mesh, X, torch.float32)
    brows = _rows(mesh, B0, torch.int32)
    _same_rows(rows, brows)
    n = rows.n
    R0 = replicate(mesh, R0).float()
    RX = rows.local @ R0
    ils = dict(ilsiter=ilsiter, icmiter=icmiter, npert=npert,
               randord=randord, chunk=chunk)

    def sr_step(g, B, it):
        if method == "SR_C":
            s1 = _all_reduce(mesh, RX.sum(0)) / n
            s2 = _all_reduce(mesh, (RX * RX).sum(0)) / n
            std = apply_schedule(torch.sqrt(torch.clamp(s2 - s1 * s1, min=0)),
                                 it, niter, schedule, p)
            noise = torch.randn(RX.shape, generator=_rank_gen(mesh, g),
                                device=RX.device)
            return _solve(mesh, RX + noise * std, B, h)
        C = _solve(mesh, RX, B, h)
        if method == "SR_D":
            C = sr_d_perturb(fold_in(g, 0, mesh.device), C, it, niter,
                             schedule, p)
        return C

    def encode(g, C, B):
        return encoding_icm(_rank_gen(mesh, g), RX, C, B, **ils)

    C = sr_step(fold_in(gen, 0), brows.local, 0 if method == "SR_C" else 1)
    B = encode(fold_in(gen, 1), C, brows.local)
    obj = torch.zeros(niter + 1, dtype=torch.float32, device=mesh.device)
    for it in range(niter):
        obj[it] = _sq_error(mesh, RX, C, B, n)
        C = sr_step(fold_in(gen, 2 * it + 2), B, it + 1)
        B = encode(fold_in(gen, 2 * it + 3), C, B)
    obj[niter] = _sq_error(mesh, RX, C, B, n)
    C = torch.einsum("de,mhe->mhd", R0, C)
    return LSQModel(C), _like(mesh, X, B, rows), obj
