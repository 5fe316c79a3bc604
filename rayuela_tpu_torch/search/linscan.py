"""Recall evaluation (counterpart of `rayuela_tpu/search/linscan.py`'s
`eval_recall`)."""

from __future__ import annotations

import numpy as np
import torch


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
