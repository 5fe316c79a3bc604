"""Hyperparameter search for LSQ/LSQ++ — the reference's SMAC layer
(counterpart of `rayuela_tpu/experiments/hpo.py`: the search space, the
optimizers and the incumbents are numpy copies of it, and give its
trajectories for the same seed; `default_objective` runs the port's
drivers).

Capability parity with `smac/configure.py` (:79-98 search space, :31-68
objective) and `smac/test_lsq.jl`: optimize
``{ilsiter ∈ [1,16], npert ∈ [0,m-1], randord ∈ {0,1}, method ∈
{LSQ, SR_C, SR_D}, schedule ∈ {1,2,3}, p ∈ [0.1, 1.0]}`` minimizing
``1 - recall@1``, with ``icmiter = 32 // ilsiter`` so every
configuration does equal ICM work (`smac/configure.py:46`).

The reference shells out to the SMAC3 Python package through pyjulia;
here the optimizer is self-contained with two strategies:

* ``random`` — random search plus top-quartile jitter refinement.
* ``smac`` (default) — sequential model-based optimization in the
  spirit of SMAC (`smac/configure.py:100-110` builds a SMAC object
  over the same space): a Gaussian-process surrogate over the encoded
  config space, expected-improvement acquisition maximized over a
  random candidate pool seeded with jittered incumbents. Pure numpy,
  no external dependency, identical protocol surface.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LSQConfig:
    ilsiter: int = 8
    npert: int = 4
    randord: bool = True
    method: str = "SR_D"      # LSQ | SR_C | SR_D
    schedule: int = 1
    p: float = 0.5
    # Explicit ICM sweeps per ILS round; None derives the reference's
    # equal-work coupling icmiter = 32 // ilsiter
    # (`smac/configure.py:46`). The recorded incumbents pass it
    # explicitly (it is positional in `smac/test_lsq.jl:95-96`).
    icmiter: int | None = None

    def __post_init__(self):
        if self.icmiter is None:
            object.__setattr__(self, "icmiter",
                               max(1, 32 // self.ilsiter))


def sample_config(rng: np.random.Generator, m: int) -> LSQConfig:
    """Draw from the reference search space (`smac/configure.py:79-98`):
    ilsiter U[1,16], npert U[0,m-1], randord {true,false}, SR_method
    {LSQ, SR_C, SR_D}, schedule {1,2,3}, p U[0.1,1]."""
    method = rng.choice(["LSQ", "SR_C", "SR_D"])
    return LSQConfig(
        ilsiter=int(rng.integers(1, 17)),
        npert=int(rng.integers(0, m)),
        randord=bool(rng.integers(0, 2)),
        method=str(method),
        schedule=int(rng.integers(1, 4)),
        p=float(rng.uniform(0.1, 1.0)),
    )


# the text of a CUDA error after which the context is lost: every later
# launch in the process fails, so scoring it would score every later
# configuration too
_STICKY = ("illegal memory access", "illegal address",
           "unspecified launch failure")


def _sticky(e: BaseException) -> bool:
    msg = str(e)
    return (isinstance(e, RuntimeError)
            and not isinstance(e, torch.cuda.OutOfMemoryError)
            and (msg.startswith("CUDA error")
                 or any(t in msg for t in _STICKY)))


def default_objective(ds, m: int, h: int, niter: int, seed: int = 0,
                      knn: int = 100, device=None
                      ) -> Callable[[LSQConfig], float]:
    """1 - recall@1 of a full train→encode→search run of the config —
    the quantity SMAC minimizes (`smac/configure.py:31-68`) — on
    ``device`` (the card unless the caller asks for the CPU).

    A configuration that fails scores the worst loss, 1.0 (SMAC's
    convention for crashed configurations), and the campaign goes on:
    one that runs out of device memory frees the allocator's cache
    first. A CUDA error that loses the context (an illegal address, an
    unspecified launch failure, any error whose text starts "CUDA
    error") propagates at once, never scored: every later configuration
    would fail and score 1.0 with it."""
    from rayuela_tpu_torch.experiments import drivers

    dev = torch.device(device or "cuda")
    dsd = drivers._on_device(ds, dev)

    def objective(cfg: LSQConfig) -> float:
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(niter=niter, knn=knn, verbose=False,
                  ilsiter=cfg.ilsiter, icmiter=cfg.icmiter,
                  npert=cfg.npert, randord=cfg.randord)
        try:
            if cfg.method == "LSQ":
                out = drivers.experiment_lsq(gen, dsd, m, h, **kw)
            else:
                out = drivers.experiment_sr(gen, dsd, m, h,
                                            method=cfg.method,
                                            schedule=cfg.schedule, p=cfg.p,
                                            **kw)
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            print(f"[hpo] config ran out of device memory "
                  f"({str(e)[:160]}); loss=1.0")
            return 1.0
        except Exception as e:  # noqa: BLE001 - the campaign goes on
            if _sticky(e):
                raise
            print(f"[hpo] config crashed ({type(e).__name__}: "
                  f"{str(e)[:160]}); loss=1.0")
            return 1.0
        return float(1.0 - out["recall"][0])

    return objective


_METHODS = ("LSQ", "SR_C", "SR_D")


def _config_features(cfg: LSQConfig, m: int) -> np.ndarray:
    """Encode a config as a point in [0,1]^9 for the surrogate:
    scaled ilsiter/npert/p, randord bit, one-hot method, one-hot-ish
    schedule (only meaningful for SR methods)."""
    f = np.zeros(9, dtype=np.float64)
    f[0] = (cfg.ilsiter - 1) / 15.0
    f[1] = cfg.npert / max(1, m - 1)
    f[2] = float(cfg.randord)
    f[3 + _METHODS.index(cfg.method)] = 1.0
    is_sr = cfg.method != "LSQ"
    f[6] = (cfg.schedule - 1) / 2.0 if is_sr else 0.0
    f[7] = cfg.p if is_sr else 0.0
    f[8] = (cfg.icmiter - 1) / 31.0
    return f


def _jitter(rng: np.random.Generator, base: LSQConfig,
            m: int) -> LSQConfig:
    return dataclasses.replace(
        base,
        ilsiter=int(np.clip(base.ilsiter + rng.integers(-2, 3), 1, 16)),
        npert=int(np.clip(base.npert + rng.integers(-1, 2), 0, m - 1)),
        p=float(np.clip(base.p + rng.normal(0, 0.1), 0.1, 1.0)),
        schedule=int(np.clip(base.schedule + rng.integers(-1, 2), 1, 3)),
        icmiter=None,
    )


class GPSurrogate:
    """Tiny Gaussian-process regressor (RBF kernel, fixed lengthscale,
    observation noise) — the surrogate model SMAC fits over evaluated
    configurations. Exact posterior via Cholesky; fine for the <100
    evaluations an MCQ HPO run can afford."""

    def __init__(self, lengthscale: float = 0.35, noise: float = 1e-3,
                 signal: float = 1.0):
        self.ls, self.noise, self.signal = lengthscale, noise, signal
        self._X = self._a = self._L = None
        self._mu = 0.0

    def _kern(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return self.signal * np.exp(-0.5 * d2 / self.ls**2)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GPSurrogate":
        self._X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        self._mu = float(y.mean())
        K = self._kern(self._X, self._X)
        K[np.diag_indices_from(K)] += self.noise
        self._L = np.linalg.cholesky(K)
        self._a = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, y - self._mu))
        return self

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        Ks = self._kern(np.asarray(X, np.float64), self._X)
        mean = self._mu + Ks @ self._a
        v = np.linalg.solve(self._L, Ks.T)
        var = np.maximum(self.signal - (v**2).sum(0), 1e-12)
        return mean, np.sqrt(var)


def _expected_improvement(mean: np.ndarray, std: np.ndarray,
                          best: float) -> np.ndarray:
    """EI for minimization, standard-normal closed form."""
    z = (best - mean) / std
    pdf = np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2)))
    return (best - mean) * cdf + std * pdf


def optimize_smac(objective: Callable[[LSQConfig], float], m: int,
                  budget: int = 20, seed: int = 0, n_init: int | None = None,
                  n_candidates: int = 256, verbose: bool = True,
                  ) -> tuple[LSQConfig, float, list]:
    """Sequential model-based optimization: random init design, then
    GP surrogate + expected-improvement over a candidate pool (random
    draws plus jitters of the current top quartile — SMAC's
    local-and-random candidate generation).

    Returns ``(best_config, best_loss, history)``."""
    rng = np.random.default_rng(seed)
    n_init = max(3, budget // 3) if n_init is None else n_init
    history: list[tuple[LSQConfig, float]] = []
    seen: set = set()

    def evaluate(cfg: LSQConfig, tag: str) -> None:
        loss = objective(cfg)
        history.append((cfg, loss))
        seen.add(cfg)
        if verbose:
            print(f"[hpo {len(history)}/{budget}] loss={loss:.4f} "
                  f"{cfg} ({tag})")

    while len(history) < min(n_init, budget):
        cfg = sample_config(rng, m)
        if cfg in seen:
            continue
        evaluate(cfg, "init")

    while len(history) < budget:
        X = np.stack([_config_features(c, m) for c, _ in history])
        y = np.array([l for _, l in history])
        gp = GPSurrogate().fit(X, y)
        ranked = sorted(history, key=lambda t: t[1])
        elites = [c for c, _ in ranked[: max(1, len(ranked) // 4)]]
        pool = [sample_config(rng, m) for _ in range(n_candidates // 2)]
        pool += [_jitter(rng, elites[i % len(elites)], m)
                 for i in range(n_candidates // 2)]
        pool = [c for c in pool if c not in seen] or [sample_config(rng, m)]
        mean, std = gp.predict(
            np.stack([_config_features(c, m) for c in pool]))
        ei = _expected_improvement(mean, std, float(y.min()))
        evaluate(pool[int(ei.argmax())], "ei")

    best_cfg, best_loss = min(history, key=lambda t: t[1])
    return best_cfg, best_loss, history


def optimize(objective: Callable[[LSQConfig], float], m: int,
             budget: int = 20, seed: int = 0, refine_frac: float = 0.25,
             verbose: bool = True, strategy: str = "smac",
             ) -> tuple[LSQConfig, float, list]:
    """Optimize the LSQ/SR config space. ``strategy='smac'`` (default)
    runs the GP-surrogate optimizer (`optimize_smac`); ``'random'``
    runs random search + top-quartile refinement.

    Returns ``(best_config, best_loss, history)`` where history is a
    list of (config, loss) in evaluation order."""
    if strategy == "smac":
        return optimize_smac(objective, m, budget=budget, seed=seed,
                             verbose=verbose)
    rng = np.random.default_rng(seed)
    n_explore = max(1, math.ceil(budget * (1 - refine_frac)))
    history: list[tuple[LSQConfig, float]] = []

    for i in range(n_explore):
        cfg = sample_config(rng, m)
        loss = objective(cfg)
        history.append((cfg, loss))
        if verbose:
            print(f"[hpo {i + 1}/{budget}] loss={loss:.4f} {cfg}")

    # refinement: jitter the best configs' continuous/int params
    history.sort(key=lambda t: t[1])
    seeds = [c for c, _ in history[: max(1, len(history) // 4)]]
    for i in range(budget - n_explore):
        base = seeds[i % len(seeds)]
        cfg = dataclasses.replace(
            base,
            ilsiter=int(np.clip(base.ilsiter + rng.integers(-2, 3), 1, 16)),
            npert=int(np.clip(base.npert + rng.integers(-1, 2), 0, m - 1)),
            p=float(np.clip(base.p + rng.normal(0, 0.1), 0.1, 1.0)),
        )
        loss = objective(cfg)
        history.append((cfg, loss))
        if verbose:
            print(f"[hpo {n_explore + i + 1}/{budget}] "
                  f"loss={loss:.4f} {cfg} (refine)")

    best_cfg, best_loss = min(history, key=lambda t: t[1])
    return best_cfg, best_loss, history


# Tuned incumbents the reference recorded after its SMAC runs — the
# call rows at `smac/test_lsq.jl:208-226`, transcribed verbatim against
# the positional signature `run_demos_*(dataset, m, h, niter,
# sr_method, ilsiter, icmiter, randord, npert, schedule, p)`
# (`smac/test_lsq.jl:90-101,149-160`). Keyed by (dataset, m). Note the
# reference left some rows commented out with "No change here" (the
# SMAC run did not beat the default) — those carry the defaults.
INCUMBENTS = {
    # Query/base datasets (`smac/test_lsq.jl:208-213`)
    ("labelme", 8): LSQConfig(method="SR_D", ilsiter=9, icmiter=3,
                              randord=True, npert=1, schedule=1,
                              p=0.43098784299895454),
    ("labelme", 16): LSQConfig(method="SR_D", ilsiter=8, icmiter=4,
                               randord=True, npert=4, schedule=1,
                               p=0.5),
    ("mnist", 8): LSQConfig(method="SR_D", ilsiter=9, icmiter=3,
                            randord=False, npert=5, schedule=1,
                            p=0.18979255389609623),
    ("mnist", 16): LSQConfig(method="SR_D", ilsiter=8, icmiter=4,
                             randord=False, npert=4, schedule=1,
                             p=0.8282107865533627),
    # Train/query/base datasets (`smac/test_lsq.jl:218-226`)
    ("sift1m", 8): LSQConfig(method="SR_D", ilsiter=8, icmiter=4,
                             randord=True, npert=4, schedule=1,
                             p=0.6458745069743886),
    ("sift1m", 16): LSQConfig(method="SR_D", ilsiter=7, icmiter=4,
                              randord=True, npert=2, schedule=1,
                              p=0.18722222602931293),
    ("deep1m", 8): LSQConfig(method="SR_D", ilsiter=8, icmiter=4,
                             randord=True, npert=4, schedule=1, p=0.5),
    ("deep1m", 16): LSQConfig(method="SR_C", ilsiter=15, icmiter=2,
                              randord=True, npert=2, schedule=1,
                              p=0.9534092523209057),
    ("convnet1m", 8): LSQConfig(method="SR_C", ilsiter=8, icmiter=4,
                                randord=True, npert=4, schedule=1,
                                p=0.7134116312190524),
    ("convnet1m", 16): LSQConfig(method="SR_C", ilsiter=10, icmiter=3,
                                 randord=False, npert=5, schedule=1,
                                 p=0.937363908221641),
}

_INCUMBENT_ALIASES = {"labelme22k": "labelme", "deep1m-babenko": "deep1m"}


def incumbent(dataset: str, m: int = 8) -> LSQConfig:
    """Look up the reference-recorded incumbent for a dataset (name
    normalized; catalog aliases like ``labelme22k`` map to the
    reference's spelling). Falls back to the SMAC default config
    (`smac/configure.py:83-91` default_values) for unknown datasets."""
    name = dataset.lower()
    name = _INCUMBENT_ALIASES.get(name, name)
    return INCUMBENTS.get((name, m), LSQConfig())
