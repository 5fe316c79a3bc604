"""Sharded ChainQ: data-parallel Viterbi and all-reduced chain statistics
(counterpart of `rayuela_tpu/parallel/chainq_sharded.py`).

* **Viterbi encoding** is independent per vector: each ``data`` rank
  encodes its rows with the replicated codebooks (K13 on the card).
* **The chain codebook update**: the (mh, mh) / (mh, d) statistics are
  sums over n, so each rank counts its rows' (G, F), one all-reduce
  makes them global, and the batched (2h, 2h) block solves run
  replicated.
* **The rotation update**: the d x d cross-covariance ``X^T X_hat`` is
  a sum over n too: a local matmul, an all-reduce, a replicated SVD.

Every rank's codebooks and rotation are bit-identical after each step:
the all-reduce hands every rank the same bits of (G, F) and of the
cross-covariance, and every rank runs the same solve and SVD on them.
The objective is the all-reduced squared error over the n rows.
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.models.chainq import train_chainq
from rayuela_tpu_torch.ops.viterbi import viterbi_encode
from rayuela_tpu_torch.parallel.mesh import (Mesh, _like, _ranks, _rows,
                                             _same_rows, replicate)


def sharded_viterbi_encode(mesh: Mesh, X, C, *, chunk: int = 2048,
                           impl: str = "auto"):
    """Data-parallel exact Viterbi encode → codes ``(n, m) int32``:
    ``X`` row-sharded (a global array or a `RowShard`, and the codes come
    back in the same form), ``C`` replicated."""
    rows = _rows(mesh, X, torch.float32)
    B = viterbi_encode(rows.local, replicate(mesh, C).float(), chunk=chunk,
                       impl=impl)
    return _like(mesh, X, B, rows)


def train_chainq_sharded(mesh: Mesh, X, B0, R0, *, h: int = 256,
                         niter: int = 25, chunk: int = 2048,
                         impl: str = "auto"):
    """`models.chainq.train_chainq` over a mesh, the same loop and return
    contract ``(model, codes (n, m), obj (niter+1,))``: ``X`` and ``B0``
    row-sharded (the codes come back in ``X``'s form), ``R0``
    replicated. Each rank runs the loop on its rows, its statistics
    all-reduced over ``data`` (``ranks``), so the result differs from the
    single-device trainer's only by the order in which the all-reduce
    sums."""
    rows = _rows(mesh, X, torch.float32)
    brows = _rows(mesh, B0, torch.int32)
    _same_rows(rows, brows)
    model, B, obj = train_chainq(rows.local, brows.local,
                                 replicate(mesh, R0).float(), h=h,
                                 niter=niter, chunk=chunk, impl=impl,
                                 ranks=_ranks(mesh, rows))
    return model, _like(mesh, X, B, rows), obj
