"""The port's HPO layer against `rayuela_tpu.experiments.hpo`: the search
space, both optimizers and the GP surrogate are numpy copies and give the
JAX package's trajectories exactly; the incumbents are the same; and
`default_objective`'s failure filter is the card's: an out-of-memory
configuration scores 1.0 and the campaign goes on, a CUDA error that
loses the context propagates, any other failure scores 1.0, and
icmiter = 32 (a TPU placement limit in the JAX package) is evaluated."""

import dataclasses

import numpy as np
import pytest
import torch

import rayuela_tpu.experiments.hpo as jhpo
import rayuela_tpu_torch.experiments.drivers as tdrv
import rayuela_tpu_torch.experiments.hpo as thpo
from rayuela_tpu_torch.experiments.datasets import make_synthetic

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(41)


def _planted(c) -> float:
    return (abs(c.ilsiter - 12) / 16 + abs(c.p - 0.3)
            + 0.2 * (c.method != "SR_D") + 0.01 * c.npert
            + 0.03 * c.schedule + 0.05 * (not c.randord))


def _plain(history):
    return [(dataclasses.asdict(c), loss) for c, loss in history]


def test_sample_config_draws_the_jax_configs():
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for m in (4, 7, 16):
        for _ in range(50):
            assert (dataclasses.asdict(thpo.sample_config(a, m))
                    == dataclasses.asdict(jhpo.sample_config(b, m)))


@pytest.mark.parametrize("strategy,seed", [("smac", 0), ("smac", 3),
                                           ("random", 1)])
def test_optimize_gives_the_jax_trajectory(strategy, seed):
    got = thpo.optimize(_planted, m=7, budget=12, seed=seed, verbose=False,
                        strategy=strategy)
    ref = jhpo.optimize(_planted, m=7, budget=12, seed=seed, verbose=False,
                        strategy=strategy)
    assert _plain(got[2]) == _plain(ref[2])
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(ref[0])
    assert got[1] == ref[1]


def test_optimize_smac_gives_the_jax_trajectory():
    got = thpo.optimize_smac(_planted, m=5, budget=10, seed=2, n_init=4,
                             n_candidates=64, verbose=False)
    ref = jhpo.optimize_smac(_planted, m=5, budget=10, seed=2, n_init=4,
                             n_candidates=64, verbose=False)
    assert _plain(got[2]) == _plain(ref[2])


def test_gp_surrogate_predicts_as_jax(rng):
    X = rng.uniform(size=(30, 9))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    Xs = rng.uniform(size=(64, 9))
    for kw in ({}, dict(noise=1e-6), dict(lengthscale=0.2, signal=2.0)):
        mt, st = thpo.GPSurrogate(**kw).fit(X, y).predict(Xs)
        mj, sj = jhpo.GPSurrogate(**kw).fit(X, y).predict(Xs)
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(st, sj, rtol=0, atol=1e-12)
    ei_t = thpo._expected_improvement(mt, st, 0.3)
    np.testing.assert_allclose(ei_t, jhpo._expected_improvement(mj, sj, 0.3),
                               rtol=0, atol=1e-12)


def test_incumbents_are_the_jax_ones():
    assert ({k: dataclasses.asdict(v) for k, v in thpo.INCUMBENTS.items()}
            == {k: dataclasses.asdict(v) for k, v in jhpo.INCUMBENTS.items()})
    for name, m in (("LabelMe22K", 8), ("deep1m-babenko", 16),
                    ("SIFT1M", 16), ("unknown", 8)):
        assert (dataclasses.asdict(thpo.incumbent(name, m))
                == dataclasses.asdict(jhpo.incumbent(name, m)))
    assert thpo.LSQConfig(ilsiter=1).icmiter == 32


@pytest.fixture
def tiny():
    return make_synthetic(d=8, ntrain=200, nbase=300, nquery=10,
                          ncenters=4, seed=0, name="t", device="cpu")


def _patch(monkeypatch, behave):
    calls = []

    def fake(gen, ds, m, h, **kw):
        calls.append(kw)
        return behave(len(calls), kw)

    monkeypatch.setattr(tdrv, "experiment_sr", fake)
    monkeypatch.setattr(tdrv, "experiment_lsq", fake)
    return calls


def test_out_of_memory_scores_one_and_the_campaign_goes_on(monkeypatch,
                                                           tiny):
    freed = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: freed.append(1))

    def behave(n, kw):
        if n == 2:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        return {"recall": np.array([0.25 * n])}

    calls = _patch(monkeypatch, behave)
    obj = thpo.default_objective(tiny, 4, 16, 2, device="cpu")
    _, loss, hist = thpo.optimize(obj, m=4, budget=3, seed=0, verbose=False)
    assert [h[1] for h in hist] == [0.75, 1.0, 0.25]
    assert len(calls) == 3 and freed == [1]
    assert loss == 0.25


@pytest.mark.parametrize("err", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure"),
    torch.AcceleratorError("CUDA error: misaligned address"),
    RuntimeError("kernel launch: an illegal memory access was "
                 "encountered"),
])
def test_a_sticky_cuda_error_propagates(monkeypatch, tiny, err):
    def behave(n, kw):
        raise err

    _patch(monkeypatch, behave)
    obj = thpo.default_objective(tiny, 4, 16, 2, device="cpu")
    with pytest.raises(type(err), match="illegal|launch failure|CUDA"):
        thpo.optimize(obj, m=4, budget=3, seed=0, verbose=False)


@pytest.mark.parametrize("err", [ValueError("shape mismatch"),
                                 RuntimeError("linalg.cholesky: not "
                                              "positive-definite"),
                                 FloatingPointError("nan")])
def test_other_failures_score_one(monkeypatch, tiny, err):
    def behave(n, kw):
        if n == 1:
            raise err
        return {"recall": np.array([0.5])}

    calls = _patch(monkeypatch, behave)
    obj = thpo.default_objective(tiny, 4, 16, 2, device="cpu")
    _, _, hist = thpo.optimize(obj, m=4, budget=2, seed=0, verbose=False)
    assert [h[1] for h in hist] == [1.0, 0.5] and len(calls) == 2


def test_icmiter_32_is_evaluated(monkeypatch, tiny):
    calls = _patch(monkeypatch, lambda n, kw: {"recall": np.array([0.9])})
    obj = thpo.default_objective(tiny, 4, 16, 2, device="cpu")
    cfg = thpo.LSQConfig(ilsiter=1, method="SR_C")
    assert cfg.icmiter == 32
    assert abs(obj(cfg) - 0.1) < 1e-9
    assert calls[0]["icmiter"] == 32 and calls[0]["ilsiter"] == 1
    assert obj(dataclasses.replace(cfg, method="LSQ")) == pytest.approx(0.1)


def test_default_objective_runs_the_port_on_the_cpu():
    ds = make_synthetic(d=16, ntrain=600, nbase=800, nquery=30,
                        ncenters=8, seed=1, name="h", device="cpu")
    obj = thpo.default_objective(ds, 4, 16, 2, knn=20, device="cpu")
    losses = [obj(thpo.LSQConfig(ilsiter=2, npert=1, method=meth))
              for meth in ("LSQ", "SR_C", "SR_D")]
    assert all(0.0 <= v < 1.0 for v in losses), losses
    # one seed: the same configuration scores the same
    assert obj(thpo.LSQConfig(ilsiter=2, npert=1, method="LSQ")) == losses[0]
