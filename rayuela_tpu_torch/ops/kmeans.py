"""k-means with kmeans++ seeding and cost-ranked empty-cluster repick
(counterpart of `rayuela_tpu/ops/kmeans.py`).

Randomness comes from a `torch.Generator`, so seeds do not reproduce the
JAX package's threefry draws: parity with it is statistical (the tests
compare quantization error, not centers). TF32 is off throughout.

Data-parallel (``ranks``, a `utils.Ranks`: each rank holds some of the
rows, as the JAX package's sharded k-means does under its compiler):
the counts, sums and objective are summed over the ranks; an empty
cluster takes the costliest points of the whole set, ranked by (cost
descending, global row) from every rank's own costliest (`costliest`);
the seeding draws each pick over all ranks (`spread_pick`). Every
solve then runs on bits identical on every rank, so every rank holds the
same centres; they differ from the single-device ones by the order of
the sums, and the seeding by its draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayuela_tpu_torch.utils import (Ranks, exact_f32, row_mean, segment_sum,
                                     sqdist, topk_lowest_id)

# rows per distance block in `assign`: bounds the (chunk, k) transient
_ASSIGN_CHUNK = 1 << 16


class KMeansResult(NamedTuple):
    centers: torch.Tensor      # (k, d) f32
    assignments: torch.Tensor  # (n,) int32
    objective: torch.Tensor    # () f32 — mean squared distance to center


def assign(X: torch.Tensor, centers: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-center assignment → ``(assignments (n,) int32,
    mind2 (n,) f32)``; for b sets at once with ``X (b, n, d)`` and
    ``centers (b, k, d)``, ``(b, n)`` each."""
    if X.dim() == 3:
        if not X.shape[0]:
            return (torch.zeros(X.shape[:2], dtype=torch.int32,
                                device=X.device), X.new_zeros(X.shape[:2]))
        a, m = zip(*(assign(x, c) for x, c in zip(X, centers)))
        return torch.stack(a), torch.stack(m)
    if not X.shape[0]:
        return (torch.zeros(0, dtype=torch.int32, device=X.device),
                X.new_zeros(0))
    a, m = [], []
    for s in range(0, X.shape[0], _ASSIGN_CHUNK):
        D = sqdist(X[s:s + _ASSIGN_CHUNK], centers)
        mv, mi = D.min(dim=1)
        a.append(mi.to(torch.int32))
        m.append(mv)
    return torch.cat(a), torch.cat(m)


def kmeanspp_init(gen: torch.Generator, X: torch.Tensor,
                  k: int) -> torch.Tensor:
    """kmeans++ seeding: k sequential picks, each drawn with probability
    proportional to the squared distance to the nearest chosen center
    (clamped at 1e-30 so all-duplicate data degrades to uniform)."""
    n, d = X.shape
    centers = torch.empty(k, d, dtype=X.dtype, device=X.device)
    idx = torch.randint(n, (1,), generator=gen, device=X.device)
    c = X.index_select(0, idx)
    centers[0:1] = c
    mind2 = ((X - c) ** 2).sum(-1)
    for i in range(1, k):
        idx = torch.multinomial(mind2.clamp_min(1e-30), 1, generator=gen)
        c = X.index_select(0, idx)
        centers[i:i + 1] = c
        mind2 = torch.minimum(mind2, ((X - c) ** 2).sum(-1))
    return centers


def spread_pick(v: torch.Tensor, X: torch.Tensor, w: torch.Tensor,
                ranks: Ranks) -> torch.Tensor:
    """One row of all the ranks' rows for each of b sets, row i drawn
    with probability ``w_i / sum(w)``: ``X (b, nl, d)`` and ``w (b, nl)``
    this rank's rows and weights, ``v (b, 2)`` f64 in (0, 1], the same on
    every rank → ``(b, d)`` f64. By ``v[:, 1]`` each rank picks a
    candidate among its rows in proportion to ``w`` (the first whose
    cumulative sum, f64, reaches ``v`` times the total); one all-gather of
    every rank's (sum, candidate) then lets every rank take the
    candidate of the rank that ``v[:, 0]`` picks in the same way over the
    sums. So rank r is picked with probability ``sum_r / sum`` and its
    row j with ``w_j / sum_r``: one collective for the b sets, no host
    sync. A rank without rows sums 0 and is never picked, nor a row of
    weight 0."""
    b, nl, d = X.shape
    if nl:
        cum = w.cumsum(1, dtype=torch.float64)
        j = torch.searchsorted(cum, v[:, 1:] * cum[:, -1:])
        mine = torch.cat([cum[:, -1:], X.gather(
            1, j[..., None].expand(b, 1, d))[:, 0]], 1)
    else:
        mine = torch.zeros(b, d + 1, dtype=torch.float64, device=X.device)
    every = torch.stack(ranks.gather(mine))                # (P, b, d + 1)
    sums = every[..., 0].T.cumsum(1)                       # (b, P)
    owner = torch.searchsorted(sums, v[:, :1] * sums[:, -1:])
    return every.gather(0, owner.T[..., None].expand(1, b, d + 1))[0, :, 1:]


def kmeanspp_spread(gen: torch.Generator, X: torch.Tensor, k: int,
                    ranks: Ranks) -> torch.Tensor:
    """`kmeanspp_init` over the rows of all ``ranks``, for b sets at once
    (``X (b, nl, d)`` this rank's rows → ``(b, k, d)``, ``gen`` seeded
    the same on every rank): each set's first centre is a row drawn
    uniformly over all n (assembled from its owner), each later one
    `spread_pick` with the weights ``mind2`` (clamped as
    `kmeanspp_init` clamps them), the uniforms of all the picks drawn at
    once. Every rank consumes ``gen`` alike; the draws differ from
    `kmeanspp_init`'s `torch.multinomial`."""
    b, nl, d = X.shape
    dev = X.device
    centers = X.new_empty(b, k, d)
    loc = torch.randint(ranks.n, (b,), generator=gen,
                        device=gen.device).to(dev) - ranks.start
    v = 1.0 - torch.rand(max(k - 1, 0), b, 2, generator=gen,
                         device=gen.device, dtype=torch.float64).to(dev)
    c = X.new_zeros(b, d)
    if nl:
        c = torch.where(((loc >= 0) & (loc < nl))[:, None],
                        X[torch.arange(b, device=dev), loc.clamp(0, nl - 1)],
                        c)
    centers[:, 0] = ranks.reduce(c)
    mind2 = X.new_full((b, nl), float("inf"))
    for i in range(1, k):
        c = centers[:, i - 1]
        torch.minimum(mind2, ((X - c[:, None]) ** 2).sum(-1).clamp_min_(
            1e-30), out=mind2)
        centers[:, i] = spread_pick(v[i - 1], X, mind2, ranks)
    return centers


def costliest(ranks: Ranks, costs: torch.Tensor, X: torch.Tensor,
              h: int) -> torch.Tensor:
    """The ``min(h, n)`` costliest rows of the whole set, for each of b
    sets at once: ``costs (b, nl)`` and ``X (b, nl, d)`` this rank's
    rows → ``(b, min(h, n), d)`` ordered by (cost descending, global
    row). Each rank takes its own costliest h in that order
    (`utils.topk_lowest_id`), padded with cost -inf; one all-gather of
    (row, cost) in rank order, whose ranks hold ascending global rows,
    and a stable sort by cost give the global order on every rank."""
    b, nl, d = X.shape
    kl = min(h, nl)
    v, idx = topk_lowest_id(-costs, kl)
    rows = X.gather(1, idx[..., None].expand(b, kl, d))
    mine = torch.cat([rows, -v[..., None]], 2)
    mine = torch.cat([mine, X.new_zeros(b, h - kl, d + 1)], 1)
    mine[:, kl:, d] = -float("inf")
    both = torch.cat(ranks.gather(mine), 1)
    order = torch.sort(both[..., d], dim=1, descending=True,
                       stable=True).indices[:, :min(h, ranks.n)]
    return both[..., :d].gather(1, order[..., None].expand(-1, -1, d))


def _update_spread(X: torch.Tensor, a: torch.Tensor, k: int,
                   old: torch.Tensor, costs: torch.Tensor | None,
                   repick: bool, ranks: Ranks) -> torch.Tensor:
    """`update_centers` of b sets at once over the rows of all ``ranks``
    (``X (b, nl, d)``, ``a (b, nl)``, ``old (b, k, d)``): the counts and
    sums summed over the ranks in one all-reduce, the repick's candidates
    from `costliest`."""
    b, nl, d = X.shape
    al = a.long()
    both = X.new_zeros(b, k, d + 1)            # the sums, then the counts
    for j in range(b):
        both[j, :, :d] = segment_sum(X[j], al[j], k)
        both[j, :, d] = torch.bincount(al[j], minlength=k)
    both = ranks.reduce(both)
    sums, counts = both[..., :d], both[..., d]
    new = torch.where((counts > 0)[..., None],
                      sums / counts.clamp_min(1.0)[..., None], old)
    if not repick:
        return new
    if costs is None:
        costs = ((X - new.gather(1, al[..., None].expand(b, nl, d))) ** 2
                 ).sum(-1)
    cand = costliest(ranks, costs, X, k)
    empty = counts == 0
    rank = (torch.cumsum(empty.long(), 1) - 1).clamp(0, cand.shape[1] - 1)
    return torch.where(empty[..., None],
                       cand.gather(1, rank[..., None].expand(b, k, d)), new)


def update_centers(X: torch.Tensor, a: torch.Tensor, k: int,
                   old_centers: torch.Tensor,
                   costs: torch.Tensor | None = None,
                   repick: bool = True,
                   ranks: Ranks | None = None) -> torch.Tensor:
    """Per-cluster means; empty clusters keep their old center or, with
    ``repick``, take the currently most costly points (each empty
    cluster a distinct one, ranked by cost). With ``ranks``, over the
    rows of all the ranks (`_update_spread`; ``X (b, nl, d)`` updates b
    sets at once)."""
    if ranks is not None:
        if X.dim() == 3:
            return _update_spread(X, a, k, old_centers, costs, repick, ranks)
        return _update_spread(X[None], a[None], k, old_centers[None],
                              None if costs is None else costs[None],
                              repick, ranks)[0]
    al = a.long()
    counts = torch.bincount(al, minlength=k).to(X.dtype)
    sums = segment_sum(X, al, k)
    new = torch.where((counts > 0)[:, None],
                      sums / counts.clamp_min(1.0)[:, None], old_centers)
    if not repick:
        return new
    if costs is None:
        costs = ((X - new.index_select(0, al)) ** 2).sum(-1)
    top_idx = torch.topk(costs, min(k, X.shape[0])).indices
    cand = X.index_select(0, top_idx)
    empty = counts == 0
    rank = (torch.cumsum(empty.long(), 0) - 1).clamp(0, cand.shape[0] - 1)
    return torch.where(empty[:, None], cand.index_select(0, rank), new)


def kmeans(gen: torch.Generator, X: torch.Tensor, k: int,
           iters: int = 25, init: str = "kmeanspp",
           ranks: Ranks | None = None) -> KMeansResult:
    """``init`` seeding (``"kmeanspp"``, or ``"random"``: k distinct rows
    drawn uniformly), then ``iters`` Lloyd iterations, then a final
    assignment against the last centers. With ``ranks``, ``X`` is this
    rank's rows (the assignments are theirs), ``gen`` is seeded the same
    on every rank, and ``X (b, nl, d)`` runs b k-means at once, their
    collectives shared (the result's fields then lead with b); it seeds
    by kmeans++ only."""
    exact_f32()
    if init not in ("kmeanspp", "random"):
        raise ValueError(f"unknown init {init!r}")
    if init == "random":
        if ranks is not None:
            raise ValueError("init='random' seeds from one device's rows: "
                             "with ranks, kmeans++ only")
        idx = torch.randperm(X.shape[0], generator=gen, device=X.device)[:k]
        centers = X.index_select(0, idx)
    elif ranks is None:
        centers = kmeanspp_init(gen, X, k)
    elif X.dim() == 3:
        centers = kmeanspp_spread(gen, X, k, ranks)
    else:
        centers = kmeanspp_spread(gen, X[None], k, ranks)[0]
    for _ in range(iters):
        a, mind2 = assign(X, centers)
        centers = update_centers(X, a, k, centers, costs=mind2, ranks=ranks)
    a, mind2 = assign(X, centers)
    return KMeansResult(centers, a, row_mean(ranks, mind2))
