"""The LSQ++ train-and-encode path of `rayuela_tpu_torch` against
`rayuela_tpu` on the CPU: OPQ, LSQ, SR-C and SR-D, the annealing
schedules, the facade's sr_d pipeline, and OPQ, ChainQ and SR-D models
carried across from the JAX facade.

OPQ and the LSQ family draw random numbers (threefry in JAX,
`torch.Generator` here), so they are held to the JAX package's final
objective within 5% on the same data; the schedules and the serving of a
carried model are deterministic and must agree exactly (the tie rule of
`tests/torch_parity.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayuela_tpu.api as japi
from rayuela_tpu.experiments.datasets import make_synthetic
from rayuela_tpu.models import lsq as jlsq
from rayuela_tpu.models import opq as jopq
from rayuela_tpu.models import sr as jsr
from rayuela_tpu.ops.qerror import qerror as j_qerror
from rayuela_tpu.search.linscan import eval_recall as j_eval_recall
import rayuela_tpu_torch.api as tapi
from rayuela_tpu_torch import convert
from rayuela_tpu_torch.models import lsq as tlsq
from rayuela_tpu_torch.models import opq as topq
from rayuela_tpu_torch.models import sr as tsr
from rayuela_tpu_torch.ops.qerror import qerror
from rayuela_tpu_torch.search.linscan import eval_recall
from tests.torch_parity import assert_tie_rule

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _within(a, b, frac=0.05):
    a, b = float(a), float(b)
    assert abs(a - b) <= frac * b, (a, b)


@pytest.fixture(scope="module")
def corr():
    return make_synthetic(d=16, ntrain=2000, nbase=3000, nquery=1000,
                          corr=True, seed=5)


@pytest.fixture(scope="module")
def serve_data():
    # n in (6144, 8192]: both packages' scan plans pad the base to 8192
    # rows, so their packed keys truncate the scores at the same bit
    return make_synthetic(d=16, ntrain=1000, nbase=8000, nquery=48,
                          corr=True, seed=6)


@pytest.mark.parametrize("init", ["natural", "random"])
def test_opq_objective_and_rotation(rng, init):
    X = rng.standard_normal((2000, 16)).astype(np.float32)
    _, _, jobj = jopq.train_opq(jax.random.PRNGKey(0), jnp.asarray(X), 4,
                                16, niter=3, init=init)
    model, B, obj = topq.train_opq(torch.Generator().manual_seed(0), _t(X),
                                   4, 16, niter=3, init=init)
    _within(obj[-1], np.asarray(jobj)[-1])
    R = model.R.numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(16), atol=1e-4)
    assert torch.equal(topq.quantize_opq(model, _t(X)), B)


def test_subspace_lloyd_keeps_empty_centres():
    C = torch.tensor([[0.0], [5.0], [9.0]])
    Xs = torch.tensor([[1.0], [4.5], [8.0]])
    B = torch.tensor([0, 0, 2], dtype=torch.int32)
    C2, a = topq._subspace_lloyd(C, Xs, B)
    assert C2.flatten().tolist() == [2.75, 5.0, 8.0]
    assert a.tolist() == [0, 1, 2]


@pytest.mark.parametrize("method", ["LSQ", "SR_C", "SR_D"])
def test_lsq_family_objective_matches_jax(rng, method):
    n, d, m, h = 2000, 16, 4, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    B0 = rng.integers(0, h, (n, m)).astype(np.int32)
    R0 = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    kw = dict(h=h, niter=3, ilsiter=4, icmiter=2, npert=2)
    gen = torch.Generator().manual_seed(0)
    if method == "LSQ":
        _, _, jobj = jlsq.train_lsq(jax.random.PRNGKey(0), jnp.asarray(X),
                                    jnp.asarray(B0), jnp.asarray(R0), **kw)
        model, B, obj = tlsq.train_lsq(gen, _t(X), _t(B0), _t(R0), **kw)
        Xs = _t(X)
    else:
        _, _, jobj = jsr.train_sr(jax.random.PRNGKey(0), jnp.asarray(X),
                                  jnp.asarray(B0), jnp.asarray(R0),
                                  method=method, **kw)
        model, B, obj = tsr.train_sr(gen, _t(X), _t(B0), _t(R0),
                                     method=method, **kw)
        Xs = _t(X)  # R0 is folded into the codebooks
    _within(obj[-1], np.asarray(jobj)[-1])
    assert float(obj[-1]) < float(obj[0])
    # the returned codebooks live in the original space
    np.testing.assert_allclose(float(qerror(Xs, model.codebooks, B)),
                               float(obj[-1]), rtol=1e-4)


@pytest.mark.parametrize("schedule", [1, 2, 3])
def test_apply_schedule_matches_jax(schedule):
    for p in (0.5, 1.0):
        for it in range(0, 11):
            j = float(jsr.apply_schedule(jnp.float32(2.0), it, 10,
                                         schedule, p))
            t = float(tsr.apply_schedule(torch.tensor(2.0), it, 10,
                                         schedule, p))
            assert np.isfinite(t)
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    if schedule == 1:               # the pow(0) guard at the last iteration
        assert float(tsr.apply_schedule(torch.tensor(2.0), 10, 10)) == 0.0


def test_facade_sr_d_pipeline_matches_jax(corr):
    ds = corr
    jm = japi.train(ds.Xt, method="sr_d", m=4, h=16, niter=3,
                    key=jax.random.PRNGKey(0))
    ej = float(j_qerror(jnp.asarray(ds.Xt), jm.codebooks, jm.train_codes))
    _, ji = japi.search(japi.index_base(jm, ds.Xb, mode="codes"), ds.Xq,
                        k=10)
    rj = j_eval_recall(ji, ds.gt, verbose=False)[9]
    tm = tapi.train(ds.Xt, method="sr_d", m=4, h=16, niter=3, seed=0)
    assert tm.R is None and tm.codebooks.shape == (4, 16, 16)
    et = float(qerror(_t(ds.Xt), tm.codebooks, tm.train_codes))
    _within(et, ej)
    tidx = tapi.index_base(tm, ds.Xb, mode="codes")
    assert tidx.scan_index.mprime == 5          # 4 codes + the norms byte
    td, ti = tapi.search(tidx, ds.Xq, k=10)
    assert torch.isfinite(td).all()
    rt = eval_recall(ti, ds.gt, verbose=False)[9]
    assert abs(rt - rj) <= 0.05, (rt, rj)


@pytest.mark.parametrize("method", ["opq", "chainq", "sr_d"])
def test_jax_models_serve_identically_from_the_port(serve_data, rng,
                                                    method):
    """A JAX-trained model and its JAX-encoded base, carried across with
    `convert`, return the JAX package's top-k. Codebooks and queries are
    rounded to a 1/16 grid and R is replaced by a random signed
    permutation, so that every rotated query, table entry and score is
    exact in f32 in both packages; the query rotation still decides the
    result."""
    ds = serve_data
    d = ds.Xt.shape[1]
    jm = japi.train(ds.Xt, method=method, m=4, h=16, niter=2,
                    key=jax.random.PRNGKey(1))
    C = np.round(np.asarray(jm.codebooks) * 16) / 16
    R = None
    if jm.R is not None:
        R = np.zeros((d, d), np.float32)
        R[np.arange(d), rng.permutation(d)] = rng.choice([-1.0, 1.0], d)
    jm = japi.MCQModel(method, jnp.asarray(C),
                       R=None if R is None else jnp.asarray(R), h=16,
                       train_codes=jm.train_codes)
    jidx = japi.index_base(jm, ds.Xb, mode="codes")
    Q = np.round(ds.Xq * 16) / 16
    jd, ji = japi.search(jidx, Q, k=20)
    tm = convert.model_from_arrays(method, C, R=R, h=16,
                                   train_codes=np.asarray(jm.train_codes))
    nc = None if jidx.norms_codebook is None \
        else np.asarray(jidx.norms_codebook)
    nco = None if jidx.norm_codes is None else np.asarray(jidx.norm_codes)
    tidx = convert.index_from_arrays(tm, np.asarray(jidx.codes), nc, nco,
                                     d=d)
    td, ti = tapi.search(tidx, Q, k=20)
    assert_tie_rule(jd, ji, td, ti)
