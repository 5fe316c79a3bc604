"""k-means with kmeans++ seeding and cost-ranked empty-cluster repick
(counterpart of `rayuela_tpu/ops/kmeans.py`).

Randomness comes from a `torch.Generator`, so seeds do not reproduce the
JAX package's threefry draws: parity with it is statistical (the tests
compare quantization error, not centers). TF32 is off throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayuela_tpu_torch.utils import exact_f32, segment_sum, sqdist

# rows per distance block in `assign`: bounds the (chunk, k) transient
_ASSIGN_CHUNK = 1 << 16


class KMeansResult(NamedTuple):
    centers: torch.Tensor      # (k, d) f32
    assignments: torch.Tensor  # (n,) int32
    objective: torch.Tensor    # () f32 — mean squared distance to center


def assign(X: torch.Tensor, centers: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-center assignment → ``(assignments (n,) int32,
    mind2 (n,) f32)``."""
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


def update_centers(X: torch.Tensor, a: torch.Tensor, k: int,
                   old_centers: torch.Tensor,
                   costs: torch.Tensor | None = None,
                   repick: bool = True) -> torch.Tensor:
    """Per-cluster means; empty clusters keep their old center or, with
    ``repick``, take the currently most costly points (each empty
    cluster a distinct one, ranked by cost)."""
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
           iters: int = 25) -> KMeansResult:
    """kmeans++ seeding, then ``iters`` Lloyd iterations, then a final
    assignment against the last centers."""
    exact_f32()
    centers = kmeanspp_init(gen, X, k)
    for _ in range(iters):
        a, mind2 = assign(X, centers)
        centers = update_centers(X, a, k, centers, costs=mind2)
    a, mind2 = assign(X, centers)
    return KMeansResult(centers, a, mind2.mean())
