"""Asymmetric-distance (ADC) linear scan and recall evaluation
(counterpart of `rayuela_tpu/search/linscan.py`).

The scan scores a query against the *reconstruction* of each code:

    |q|^2 - 2 q.x_hat + |x_hat|^2                      (PQ / OPQ)
    |q|^2 - 2 sum_i q.C_i[B_i] + dbnorm                (LSQ, norms byte)
    sum_i |q - C_i[B_i]|^2                             (CQ)

Two backends serve the `linscan_*` front-ends: ``"kernel"``, the decoded
index and its scan kernels (`rayuela_tpu_torch.search.scan`), and
``"torch"``, the tiled decompress-and-matmul scan `scan_topk` below,
plain PyTorch with an exact top-k.
"""

from __future__ import annotations

import numpy as np
import torch

from rayuela_tpu_torch.ops.qerror import reconstruct, reconstruct_pq
from rayuela_tpu_torch.utils import as_tensor, exact_f32, tiled_topk

# query block of the tiled scans: bounds the (block, tile) score matrix
_QBLOCK = 2048


def scan_topk(Q: torch.Tensor, C: torch.Tensor, B: torch.Tensor, *, k: int,
              pq: bool = False, norm_term: torch.Tensor | None = None,
              tile: int = 1 << 16, include_q2: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiled decompress-and-matmul ADC scan with exact top-k →
    ``(dists (nq, k) f32 ascending, ids (nq, k) int32)``.

    ``Q (nq, d)`` (already rotated for OPQ), ``C (m, h, d)`` or
    ``(m, h, ds)`` codebooks, ``B (n, m)`` codes; ``pq`` picks the
    concatenative decode; ``norm_term (n,)`` replaces ``|x_hat|^2``;
    ``include_q2`` adds the per-query constant so the values are true
    squared distances (it does not change the ranking)."""
    exact_f32()
    n = B.shape[0]
    k = min(k, n)             # never return padded (inf, fake-id) entries
    q2 = (Q * Q).sum(-1, keepdim=True)

    def score_tile(q0, q1, st, stop):
        Bt = B[st:stop]
        Xh = reconstruct_pq(C, Bt, Q.shape[1]) if pq else reconstruct(C, Bt)
        x2 = (Xh * Xh).sum(-1) if norm_term is None \
            else norm_term[st:stop].to(torch.float32)
        s = -2.0 * (Q[q0:q1] @ Xh.T) + x2[None, :]
        return q2[q0:q1] + s if include_q2 else s

    return tiled_topk(Q.shape[0], n, tile, k, score_tile, _QBLOCK)


def exact_rescan(Q: torch.Tensor, Xd: torch.Tensor, x2: torch.Tensor,
                 k: int, tile: int = 1 << 15
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over an already-decoded base ``Xd (n, d)`` (any float
    dtype; widened to f32 per tile) with norm terms ``x2 (n,)`` → ``(dists
    with +|q|^2, ids)``: the fallback for the queries a kernel scan's
    certificate flags."""
    exact_f32()
    n = Xd.shape[0]
    q2 = (Q * Q).sum(-1, keepdim=True)

    def score_tile(q0, q1, st, stop):
        return (q2[q0:q1] - 2.0 * (Q[q0:q1] @ Xd[st:stop].float().T)
                + x2[None, st:stop])

    return tiled_topk(Q.shape[0], n, tile, min(k, n), score_tile, _QBLOCK)


def _route(Q, C, B, *, k: int, pq: bool, norm_term=None,
           backend: str = "auto", **kw):
    """Pick the scan backend: the kernel scan over a decoded index for a
    batch on the card that can fill it, the tiled plain scan otherwise.
    An explicit ``backend`` is obeyed. ``pack=False`` (in ``kw``) asks
    the kernel backend for the exact-float scan over an f32 index; the
    tiled plain scan is exact in f32 as it is."""
    from rayuela_tpu_torch.search import scan
    pack = kw.pop("pack", None)
    if backend == "auto":
        big = Q.shape[0] >= 32 and B.shape[0] >= 1 << 14
        backend = ("kernel" if Q.device.type == "cuda" and big
                   and k <= scan._MAX_K else "torch")
    if backend == "kernel":
        f32 = pack is not None and not pack
        idx = scan.build_index(C, B, pq=pq, d=Q.shape[1],
                               norm_term=norm_term,
                               dtype=torch.float32 if f32 else None)
        return scan.search(idx, Q, min(k, B.shape[0]), pack=pack, **kw)
    if backend != "torch":
        raise ValueError(f"backend {backend!r}: 'auto', 'kernel' or 'torch'")
    return scan_topk(Q, C, B, k=k, pq=pq, norm_term=norm_term, **kw)


def _operands(C, Q, B, *more, device=None):
    """The front-ends' inputs as tensors on one device: ``device``, else
    the first tensor argument's, else the card. Codes become int32, the
    rest float32."""
    if device is None:
        device = next((a.device for a in (C, Q, B) + more
                       if isinstance(a, torch.Tensor)), "cuda")
    return [as_tensor(C, device), as_tensor(Q, device),
            as_tensor(B, device, torch.int32)] + [
        None if a is None else as_tensor(a, device) for a in more]


# ---------------------------------------------------------------------------
# Reference-parity front-ends (names and argument order of the JAX package)
# ---------------------------------------------------------------------------

def linscan_pq(C, Q, B, k: int = 1000, device=None, **kw):
    """PQ ADC scan."""
    C, Q, B = _operands(C, Q, B, device=device)
    return _route(Q, C, B, k=k, pq=True, **kw)


def linscan_opq(C, Q, B, R, k: int = 1000, device=None, **kw):
    """OPQ scan: rotate the queries, then the PQ scan."""
    C, Q, B, R = _operands(C, Q, B, R, device=device)
    exact_f32()
    return _route(Q @ R, C, B, k=k, pq=True, **kw)


def linscan_lsq(C, Q, B, norms_cbook, norms_codes, R=None, k: int = 1000,
                device=None, **kw):
    """Full-dimensional additive scan with a quantized-norms byte: the
    norm term of a row is the norms codebook's entry for its extra
    code."""
    C, Q, B, ncb, R = _operands(C, Q, B, norms_cbook, R, device=device)
    nco = as_tensor(norms_codes, C.device, torch.int64).reshape(-1)
    if R is not None:
        exact_f32()
        Q = Q @ R
    return _route(Q, C, B, k=k, pq=False, norm_term=ncb.reshape(-1)[nco],
                  **kw)


def linscan_cq(C, Q, B, k: int = 1000, device=None, **kw):
    """CQ-style scan: the sum over codebooks of ``|q - c_i|^2`` (no norms
    byte). It differs from the true distance by the per-codebook norms:
    the norm term is ``sum_i |C_i[B_i]|^2`` and ``|q|^2`` appears m
    times."""
    C, Q, B = _operands(C, Q, B, device=device)
    m = C.shape[0]
    c2 = (C * C).sum(-1)                                   # (m, h)
    codenorms = torch.gather(c2, 1, B.long().T).sum(0)     # (n,)
    d, i = _route(Q, C, B, k=k, pq=False, norm_term=codenorms, **kw)
    # _route's scores include one |q|^2; CQ's convention has m of them
    return d + (m - 1) * (Q * Q).sum(-1, keepdim=True), i


# ---------------------------------------------------------------------------
# Recall evaluation
# ---------------------------------------------------------------------------

def eval_recall(ids, gt, *, ks=(1, 2, 5, 10, 20, 50, 100, 200, 500,
                                1000, 2000, 5000, 10000),
                verbose: bool = True) -> np.ndarray:
    """Recall@N curve: the fraction of queries whose true nearest
    neighbour is among the first N returned ids, for N = 1..k."""
    ids = torch.as_tensor(ids)
    gt = torch.as_tensor(gt, device=ids.device).reshape(-1)
    hits = (ids == gt[:, None]).to(torch.float32)
    curve = torch.cummax(hits, dim=1).values.mean(0).cpu().numpy()
    if verbose:
        for N in ks:
            if N <= curve.shape[0]:
                print(f"recall@{N} = {curve[N - 1]:.4f}")
    return curve
