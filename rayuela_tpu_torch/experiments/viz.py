"""Recall-curve aggregation and plotting (a copy of
`rayuela_tpu/experiments/viz.py`).

Equivalent of reference `demos/viz.jl` (``load_recalls`` :9-23,
``print_recalls`` :39-44, ``make_plots`` :47-126): load per-trial
recall curves from the HDF5 stores, aggregate mean ± std across trials,
print r@N tables and draw log-x recall@N plots per dataset. matplotlib
is imported inside `make_plots`.
"""

from __future__ import annotations

import os

import numpy as np

from rayuela_tpu_torch.experiments.store import list_trials, load_results

DEFAULT_NS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000)


def load_recalls(results_dir: str, dataset: str, method: str
                 ) -> np.ndarray:
    """(ntrials, knn) recall curves for one (dataset, method)."""
    path = os.path.join(results_dir, f"{dataset}_{method}.h5")
    trials = list_trials(path)
    if not trials:
        raise FileNotFoundError(f"no trials in {path}")
    return np.stack([load_results(path, t)["recall"] for t in trials])


def print_recalls(recalls: np.ndarray, ns=DEFAULT_NS,
                  label: str = "") -> None:
    """Mean ± std r@N table (reference `demos/viz.jl:39-44`)."""
    mean, std = recalls.mean(0), recalls.std(0)
    for N in ns:
        if N <= recalls.shape[1]:
            print(f"{label} recall@{N:<5d} = {mean[N - 1]:.4f} "
                  f"± {std[N - 1]:.4f}")


def make_plots(results_dir: str, dataset: str, methods,
               out_path: str | None = None, ns_max: int = 1000):
    """Log-x recall@N curves, one line per method, mean over trials with
    a ± std band (reference `demos/viz.jl:47-126`)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4.5))
    for method in methods:
        try:
            r = load_recalls(results_dir, dataset, method)
        except FileNotFoundError:
            continue
        n = np.arange(1, min(ns_max, r.shape[1]) + 1)
        mean, std = r[:, :len(n)].mean(0), r[:, :len(n)].std(0)
        ax.plot(n, mean, label=method)
        if r.shape[0] > 1:
            ax.fill_between(n, mean - std, mean + std, alpha=0.2)
    ax.set_xscale("log")
    ax.set_xlabel("N")
    ax.set_ylabel("recall@N")
    ax.set_title(dataset)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    if out_path is None:
        out_path = os.path.join(results_dir, f"{dataset}_recall.png")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
