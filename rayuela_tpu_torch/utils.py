"""Small shared helpers (counterpart of `rayuela_tpu/utils.py`).

Data model, as in the JAX package: ``X (n, d)`` f32 rows are vectors,
``C (m, h, d)`` f32 codebooks (``(m, h, ds)`` per-subspace for PQ),
``B (n, m)`` int32 0-based codes. Lookups are plain gathers here: the
one-hot matmul form existed only for the TPU's matrix unit.
"""

from __future__ import annotations

import torch


def exact_f32() -> None:
    """Turn TF32 off for f32 matmuls and convolutions on the card. TF32
    keeps ~10 mantissa bits; every plain reference and every training
    statistic in this package needs full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def splitarray(n: int, nparts: int) -> list[tuple[int, int]]:
    """Split ``range(n)`` into ``nparts`` balanced ``(start, size)``
    chunks (the earlier chunks take the remainder)."""
    base, rem = divmod(n, nparts)
    out, start = [], 0
    for i in range(nparts):
        size = base + (1 if i < rem else 0)
        out.append((start, size))
        start += size
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``table[idx]``: ``table (h, d)``, ``idx (n,)`` →
    ``(n, d)``."""
    return table.index_select(0, idx.long())


def segment_sum(X: torch.Tensor, idx: torch.Tensor, nseg: int,
                chunk: int = 1 << 14) -> torch.Tensor:
    """Deterministic segment sum ``out[idx[v]] += X[v]`` → ``(nseg, d)``.

    ``idx`` is ``(n,)`` or ``(n, j)``: a row adds to every segment it
    names, and one row's segments must be distinct (the ``U^T X`` of a
    one-hot indicator with j ones per row). Each chunk of rows is one
    full-f32 matmul of the exact 0/1 indicator, and the chunk sums add
    in a fixed order, so the result is the same on every run. Float
    ``index_add_``/``scatter_add_`` would sum through atomics, in an
    order that changes from run to run on the card."""
    exact_f32()
    idx = idx.long().reshape(idx.shape[0], -1)
    out = torch.zeros(nseg, X.shape[1], dtype=X.dtype, device=X.device)
    for s in range(0, X.shape[0], chunk):
        ic = idx[s:s + chunk]
        U = torch.zeros(ic.shape[0], nseg, dtype=X.dtype, device=X.device)
        U.scatter_(1, ic, 1.0)
        out += U.T @ X[s:s + chunk]
    return out


def sqdist(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ``(n, k)`` between the rows of
    ``X (n, d)`` and ``C (k, d)``, as ``|x|^2 - 2 x.c + |c|^2``."""
    exact_f32()
    x2 = (X * X).sum(-1, keepdim=True)
    c2 = (C * C).sum(-1)
    return x2 - 2.0 * (X @ C.T) + c2[None, :]
