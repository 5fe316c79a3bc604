"""Data-parallel training of PQ, OPQ, RVQ, ERVQ, CompQ, k-means and the
norms codebook (counterpart of the JAX package's GSPMD route: ``Xt``
sharded over ``data`` and the compiler's collectives for the training
statistics, `rayuela_tpu/api.py:80-85` and
`rayuela_tpu/experiments/drivers.py:389-399`).

Each function takes the meshless trainer's arguments with ``X`` (and
initial codes) row-sharded: the global array on every rank or a
`RowShard`. Each rank runs the meshless trainer on its rows with the
mesh's ``data`` ranks (`utils.Ranks`): the counts, sums, objectives and
the d x d rotation statistic are all-reduced, the k-means seeding and
the empty-cluster repick draw over all the ranks' rows, and every
solve, SVD and centre update runs on bits identical on every rank. So
every rank holds the same codebooks (and R); they differ from the
meshless ones by the order of the sums, and the k-means seeding by its
draws (`ops.kmeans.kmeanspp_spread`). ``gen`` must be seeded the same on
every rank. The codes come back in ``X``'s form (`mesh._like`).
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.models.compq import CHUNK, train_compq
from rayuela_tpu_torch.models.ervq import train_ervq, train_ervq_from_scratch
from rayuela_tpu_torch.models.opq import train_opq
from rayuela_tpu_torch.models.pq import train_pq
from rayuela_tpu_torch.models.rvq import train_rvq
from rayuela_tpu_torch.ops.kmeans import KMeansResult, kmeans
from rayuela_tpu_torch.parallel.mesh import (Mesh, _like, _ranks, _rows,
                                             _same_rows, replicate)
from rayuela_tpu_torch.search.norms import get_norms_codebook


def kmeans_sharded(mesh: Mesh, gen: torch.Generator, X, k: int,
                   iters: int = 25) -> KMeansResult:
    """`ops.kmeans.kmeans` over the rows of all ``data`` ranks; the
    assignments come back in ``X``'s form."""
    rows = _rows(mesh, X, torch.float32)
    res = kmeans(gen, rows.local, k, iters=iters,
                 ranks=_ranks(mesh, rows))
    return res._replace(assignments=_like(mesh, X, res.assignments, rows))


def train_pq_sharded(mesh: Mesh, gen: torch.Generator, X, m: int,
                     h: int = 256, iters: int = 25):
    """`models.pq.train_pq` over a mesh → ``(model, codes, train_error)``."""
    rows = _rows(mesh, X, torch.float32)
    model, B, err = train_pq(gen, rows.local, m, h, iters,
                             ranks=_ranks(mesh, rows))
    return model, _like(mesh, X, B, rows), err


def train_opq_sharded(mesh: Mesh, gen: torch.Generator, X, m: int,
                      h: int = 256, niter: int = 25, init: str = "natural"):
    """`models.opq.train_opq` over a mesh → ``(model, codes, obj)``: the
    OPQ stage of ChainQ and the LSQ family under ``mesh=``."""
    rows = _rows(mesh, X, torch.float32)
    model, B, obj = train_opq(gen, rows.local, m, h, niter, init,
                              ranks=_ranks(mesh, rows))
    return model, _like(mesh, X, B, rows), obj


def train_rvq_sharded(mesh: Mesh, gen: torch.Generator, X, m: int,
                      h: int = 256, niter: int = 25):
    """`models.rvq.train_rvq` over a mesh → ``(model, codes,
    train_error)``."""
    rows = _rows(mesh, X, torch.float32)
    model, B, err = train_rvq(gen, rows.local, m, h, niter,
                              ranks=_ranks(mesh, rows))
    return model, _like(mesh, X, B, rows), err


def train_ervq_sharded(mesh: Mesh, X, B, C, niter: int = 25):
    """`models.ervq.train_ervq` over a mesh → ``(model, codes, error)``:
    ``X`` and ``B`` row-sharded, ``C`` replicated."""
    rows = _rows(mesh, X, torch.float32)
    brows = _rows(mesh, B, torch.int32)
    _same_rows(rows, brows)
    model, Bl, err = train_ervq(rows.local, brows.local,
                                replicate(mesh, C).float(), niter,
                                ranks=_ranks(mesh, rows))
    return model, _like(mesh, X, Bl, rows), err


def train_ervq_from_scratch_sharded(mesh: Mesh, gen: torch.Generator, X,
                                    m: int, h: int = 256, niter: int = 25):
    """`models.ervq.train_ervq_from_scratch` over a mesh: RVQ, then the
    fine-tuning, both on the rank's rows → ``(model, codes, error)``."""
    rows = _rows(mesh, X, torch.float32)
    model, B, err = train_ervq_from_scratch(gen, rows.local, m, h, niter,
                                            ranks=_ranks(mesh, rows))
    return model, _like(mesh, X, B, rows), err


def train_compq_sharded(mesh: Mesh, X, C0, B0, niter: int = 10,
                        H: int = 16, lr_total: float = 0.01,
                        chunk: int = CHUNK, update: str = "sgd"):
    """`models.compq.train_compq` over a mesh → ``(model, codes, obj)``:
    ``X`` and ``B0`` row-sharded, ``C0`` replicated."""
    rows = _rows(mesh, X, torch.float32)
    brows = _rows(mesh, B0, torch.int32)
    _same_rows(rows, brows)
    model, B, obj = train_compq(rows.local, replicate(mesh, C0).float(),
                                brows.local, niter, H, lr_total, chunk,
                                update, ranks=_ranks(mesh, rows))
    return model, _like(mesh, X, B, rows), obj


def norms_codebook_sharded(mesh: Mesh, gen: torch.Generator, C, B,
                           h: int = 256):
    """`search.norms.get_norms_codebook` over a mesh → ``(norms_codes,
    norms_cbook (h,))``: the 1-D k-means of the decode norms of the rows
    of all ranks, ``B`` row-sharded (the norms codes come back in its
    form), ``C`` replicated."""
    brows = _rows(mesh, B, torch.int32)
    codes, cbook = get_norms_codebook(gen, replicate(mesh, C).float(),
                                      brows.local, h,
                                      ranks=_ranks(mesh, brows))
    return _like(mesh, B, codes, brows), cbook
