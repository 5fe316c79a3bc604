"""Small shared helpers (counterpart of `rayuela_tpu/utils.py`).

Data model, as in the JAX package: ``X (n, d)`` f32 rows are vectors,
``C (m, h, d)`` f32 codebooks (``(m, h, ds)`` per-subspace for PQ),
``B (n, m)`` int32 0-based codes. Lookups are plain gathers here: the
one-hot matmul form existed only for the TPU's matrix unit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


def exact_f32() -> None:
    """Turn TF32 off for f32 matmuls and convolutions on the card. TF32
    keeps ~10 mantissa bits; every plain reference and every training
    statistic in this package needs full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def as_tensor(X, device=None, dtype=torch.float32) -> torch.Tensor:
    """``X`` as a tensor of ``dtype`` on ``device``. With ``device=None``
    a tensor stays where its caller put it, and anything else (a numpy
    array, a list) goes to the card: entry points run on the card unless
    the caller asks for the CPU, and where there is no card the
    transfer raises."""
    if device is None:
        device = X.device if isinstance(X, torch.Tensor) else "cuda"
    return torch.as_tensor(X, dtype=dtype, device=device)


def sortable_key(s: torch.Tensor) -> torch.Tensor:
    """f32 → int32 whose signed order is the float order: the lower 31
    bits of negatives are flipped. Monotone, so truncating low bits
    (floor in key space) stays monotone."""
    bits = s.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def topk_straddle(s: torch.Tensor, k: int):
    """`torch.topk` of the ``k`` smallest per row of ``s (nq, w)`` →
    ``(values (nq, k) ascending, columns (nq, k), straddle (nq,) bool)``.
    ``straddle`` marks the rows whose k-th score also occurs outside the
    selection (the (k+1)-th smallest equals the k-th): there, and only
    there, `torch.topk`'s choice of the columns that hold the k-th score
    is arbitrary. No pass over ``s`` beyond the `topk`, no host sync."""
    w = s.shape[1]
    top = torch.topk(s, min(k + 1, w), dim=1, largest=False, sorted=True)
    v, cols = top.values[:, :k], top.indices[:, :k]
    if w > k and k:
        return v, cols, top.values[:, k] == v[:, k - 1]
    return v, cols, torch.zeros(s.shape[0], dtype=torch.bool,
                                device=s.device)


def lowest_at_tau(s: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
                  ids: torch.Tensor | None = None) -> torch.Tensor:
    """Repair straddling rows: ``idx (nr, k)`` with the members of each
    row's last group of equal scores (those at ``tau = v[:, -1]``)
    replaced by the lowest ids among all columns of ``s (nr, w)`` that
    hold tau. Column j carries ``ids[:, j]``, or j when ``ids`` is
    None."""
    k = v.shape[1]
    tau = v[:, -1:]
    need = (v == tau).sum(1)
    cols = (torch.arange(s.shape[1], device=s.device)[None, :]
            if ids is None else ids.long())
    cand = torch.where(s == tau, cols, 1 << 31)
    low = torch.topk(cand, int(need.max()), dim=1, largest=False,
                     sorted=True).values
    j = torch.arange(k, device=s.device)[None, :] - (k - need[:, None])
    return torch.where(j >= 0, low.gather(1, j.clamp(min=0)), idx)


def order_by_score_then_id(v: torch.Tensor, idx: torch.Tensor
                           ) -> torch.Tensor:
    """``idx (nq, k)`` reordered so that ids ascend within each group of
    equal scores of the ascending ``v (nq, k)``: one k-wide sort of
    (score, id) keys."""
    # + 0.0: -0.0 and 0.0 are one score
    key = (sortable_key(v + 0.0).long() << 32) | (idx.long() & 0xFFFFFFFF)
    return key.sort(dim=1).values & 0xFFFFFFFF


def _any(*conds: torch.Tensor) -> list[bool]:
    """The truth of several 0-d conditions in one host sync."""
    return torch.stack([c.any() for c in conds]).tolist()


def _has_ties(v: torch.Tensor) -> torch.Tensor:
    return v[:, 1:] == v[:, :-1]


def _resolve_ids(s, ids, v, cols, straddle, any_straddle: bool,
                 any_tie: bool) -> torch.Tensor:
    """The ids of `topk_straddle`'s selection under the lowest-id rule:
    straddling rows repaired, winners ordered by (score, id) where any
    two tie."""
    idx = cols if ids is None else ids.gather(1, cols).long()
    if any_straddle:
        rows = torch.nonzero(straddle).flatten()
        idx[rows] = lowest_at_tau(s[rows], v[rows], idx[rows],
                                  None if ids is None else ids[rows])
    return order_by_score_then_id(v, idx) if any_tie else idx


def topk_lowest_id(s: torch.Tensor, k: int, ids: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of ``s (nq, w)`` f32 →
    ``(values (nq, k) ascending, ids (nq, k) int64)``, where among equal
    scores the lowest id wins, also in the group that straddles position
    k. Column j carries ``ids[:, j]`` (``ids (nq, w)``, distinct within a
    row, in [0, 2**31)), or j itself when ``ids`` is None.

    `torch.topk` settles the values; its choice among equal scores is
    arbitrary and moves with the thread count. Only the rows whose k-th
    score also occurs outside the selection (`topk_straddle`) are looked
    at again, for the lowest ids that hold that score, and where two
    winners tie the k winners are ordered by (score, id), a k-wide
    sort. One host sync."""
    v, cols, straddle = topk_straddle(s, k)
    if not k or not s.shape[0]:
        return v, cols if ids is None else ids.gather(1, cols).long()
    return v, _resolve_ids(s, ids, v, cols, straddle,
                           *_any(straddle, _has_ties(v)))


def tiled_topk(nq: int, n: int, tile: int, k: int, score_tile,
               qblock: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``score_tile(q0, q1, start, stop) -> (q1 - q0,
    stop - start)`` f32 over base tiles of ``tile`` rows and query
    blocks of ``qblock`` → ``(values (nq, k) ascending, ids (nq, k)
    int32)``, among equal scores the lowest id: the global top-k is
    contained in the union of the per-tile top-k.

    A tile's `torch.topk` picks arbitrarily among the rows that hold its
    k-th score when more of them exist than it returns. That matters
    only where the tile's k-th score is the global one, which on a base
    of several tiles takes exact ties: such tiles are scored once more
    and give the lowest ids at that score (`lowest_at_tau`). The tile
    loop itself is the plain `topk` per tile, with no further pass over
    the scores, and a query block costs one host sync."""
    out_v, out_i = [], []
    tiles = [(st, min(st + tile, n)) for st in range(0, n, tile)]
    # tiles that hold more rows than the k they return
    full = [stop - st > k for st, stop in tiles]
    for q0 in range(0, max(nq, 1), qblock):
        q1 = min(q0 + qblock, nq)
        if len(tiles) == 1:
            v, i = topk_lowest_id(score_tile(q0, q1, 0, n), k)
            out_v.append(v)
            out_i.append(i.to(torch.int32))
            continue
        vals, ids = [], []
        for st, stop in tiles:
            top = torch.topk(score_tile(q0, q1, st, stop), min(k, stop - st),
                             dim=1, largest=False, sorted=True)
            vals.append(top.values)
            ids.append(top.indices + st)
        cv, ci = torch.cat(vals, dim=1), torch.cat(ids, dim=1)
        v, cols, straddle = topk_straddle(cv, k)
        taus = torch.stack([t[:, -1] for t in vals], 1)
        suspect = (taus == v[:, -1:]) & torch.tensor(full, device=cv.device)
        any_straddle, any_tie, any_suspect = _any(straddle, _has_ties(v),
                                                  suspect)
        if any_suspect:
            for t in torch.nonzero(suspect.any(0)).flatten().tolist():
                rows = torch.nonzero(suspect[:, t]).flatten()
                st, stop = tiles[t]
                ids[t][rows] = st + lowest_at_tau(
                    score_tile(q0, q1, st, stop)[rows], vals[t][rows],
                    ids[t][rows] - st)
            ci = torch.cat(ids, dim=1)
            v, cols, straddle = topk_straddle(cv, k)
            any_straddle, any_tie = _any(straddle, _has_ties(v))
        out_v.append(v)
        out_i.append(_resolve_ids(cv, ci, v, cols, straddle, any_straddle,
                                  any_tie).to(torch.int32))
    return torch.cat(out_v), torch.cat(out_i)


class Ranks(NamedTuple):
    """The ranks of a data-parallel run over which the rows of a
    trainer's ``X`` are spread (`parallel` builds it from a mesh):
    ``reduce`` sums a tensor over them (every rank gets the same bits),
    ``gather`` lists every rank's tensor of one shape in rank order,
    this rank is ``rank`` in that order and holds the global rows
    ``start, start + 1, ...`` of ``n`` in all. A trainer given none
    holds all the rows."""
    reduce: Callable[[torch.Tensor], torch.Tensor]
    gather: Callable[[torch.Tensor], list]
    rank: int
    start: int
    n: int


def summed(ranks: Ranks | None, t: torch.Tensor) -> torch.Tensor:
    """``t``, a sum over this rank's rows, summed over the ranks."""
    return t if ranks is None else ranks.reduce(t)


def row_mean(ranks: Ranks | None, v: torch.Tensor) -> torch.Tensor:
    """The mean of the per-row values ``v (..., rows)`` over all the
    rows."""
    return v.mean() if ranks is None else ranks.reduce(v.sum(-1)) / ranks.n


def rows_at(ranks: Ranks | None, X: torch.Tensor, idx: torch.Tensor
            ) -> torch.Tensor:
    """The rows ``idx`` (global row ids) of the spread ``X`` on every
    rank: each owner fills its rows of a zero tensor, and one sum over
    the ranks assembles them."""
    if ranks is None:
        return X.index_select(0, idx)
    loc = idx.to(X.device) - ranks.start
    mine = (loc >= 0) & (loc < X.shape[0])
    out = X.new_zeros(idx.shape[0], X.shape[1])
    if X.shape[0]:
        out = torch.where(mine[:, None], X.index_select(
            0, loc.clamp(0, X.shape[0] - 1)), out)
    return ranks.reduce(out)


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return cdiv(x, m) * m


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


def one_hot(idx: torch.Tensor, num: int, dtype=torch.float32
            ) -> torch.Tensor:
    """One-hot encode ``idx`` with trailing dimension ``num``; an index
    outside ``[0, num)`` (a pad code of -1) gives an all-zero row, as
    ``jax.nn.one_hot`` does."""
    return (idx.long()[..., None]
            == torch.arange(num, device=idx.device)).to(dtype)


def sparsify_codes(B: torch.Tensor, h: int, dtype=torch.float32
                   ) -> torch.Tensor:
    """Codes ``B (n, m)`` → the ``(n, m*h)`` 0/1 indicator ``U`` of the
    normal equations (dense)."""
    n, m = B.shape
    return one_hot(B, h, dtype).reshape(n, m * h)


def K2vec(K: torch.Tensor, m: int, h: int) -> torch.Tensor:
    """Stacked least-squares solution ``(m*h, d)`` → codebooks
    ``(m, h, d)``."""
    return K.reshape(m, h, -1)


def fold_in(gen: torch.Generator, data: int, device=None
            ) -> torch.Generator:
    """A new generator on ``device`` (``gen``'s by default), seeded from
    ``gen``'s seed and ``data`` (the role of ``jax.random.fold_in``);
    ``gen`` is untouched, so equal seeds give equal streams on every
    process."""
    seed = np.random.SeedSequence([gen.initial_seed(), data]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=gen.device if device is None
                           else device).manual_seed(int(seed))


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
    idx = idx.long()
    idx = idx[:, None] if idx.dim() == 1 else idx
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
