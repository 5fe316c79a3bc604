"""ERVQ, CompQ and the CQ interop of `rayuela_tpu_torch` against
`rayuela_tpu`.

From one numpy init (X, B, C) the trainers are deterministic: ERVQ's
error must match the JAX package's within 1e-5 relative with >= 99% of
codes equal, and CompQ's objective within 1e-4 relative at every
iteration. The beam encoder is deterministic too: on Gaussian data (no
ties among the costs) it must give the JAX codes, and its final
residual energies within 1e-5 relative. Through the facades, where the
seeds differ, ERVQ and CompQ recall lies within the JAX facade's seed
spread. The CQ files are byte formats: what one package writes, the
other reads back equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayuela_tpu.api as japi
from rayuela_tpu.experiments.datasets import make_synthetic
from rayuela_tpu.models import compq as jcompq
from rayuela_tpu.models import cq as jcq
from rayuela_tpu.models import ervq as jervq
from rayuela_tpu.models import rvq as jrvq
from rayuela_tpu.search.linscan import eval_recall as j_eval_recall
from rayuela_tpu.search.linscan import linscan_cq as j_linscan_cq
import rayuela_tpu_torch.api as tapi
from rayuela_tpu_torch.models import compq as tcompq
from rayuela_tpu_torch.models import cq as tcq
from rayuela_tpu_torch.models import ervq as tervq
from rayuela_tpu_torch.models import rvq as trvq
from rayuela_tpu_torch.ops.qerror import qerror, reconstruct
from rayuela_tpu_torch.search.linscan import eval_recall, linscan_cq

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    these tests' data depend on what ran before them in the process)."""
    return np.random.default_rng(0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _clustered(rng, n, d, ncenters=24):
    cent = rng.standard_normal((ncenters, d)).astype(np.float32) * 2
    return (cent[rng.integers(0, ncenters, n)]
            + 0.5 * rng.standard_normal((n, d))).astype(np.float32)


def _rvq_init(rng, n=2000, d=16, m=3, h=16):
    """Data and a JAX-trained RVQ init ``(X, B, C)`` as numpy arrays."""
    X = _clustered(rng, n, d)
    model, B, _ = jrvq.train_rvq(jax.random.PRNGKey(0), jnp.asarray(X), m,
                                 h, niter=4)
    return X, np.asarray(B), np.asarray(model.codebooks)


# --------------------------------------------------------------------- ERVQ

def test_train_ervq_matches_jax(rng):
    X, B, C = _rvq_init(rng)
    jm, jB, je = jervq.train_ervq(jnp.asarray(X), jnp.asarray(B),
                                  jnp.asarray(C), niter=3)
    tm, tB, te = tervq.train_ervq(_t(X), _t(B), _t(C), niter=3)
    assert tB.dtype == torch.int32 and tB.shape == B.shape
    assert abs(float(te) - float(je)) <= 1e-5 * float(je)
    assert (tB.numpy() == np.asarray(jB)).mean() >= 0.99
    # fine-tuning lowers the error of the RVQ init
    assert float(te) < float(qerror(_t(X), _t(C), _t(B)))
    # the error returned is the model's on its codes
    assert abs(float(te) - float(qerror(_t(X), tm.codebooks, tB))) <= 1e-6


@pytest.mark.parametrize("j", [0, 1, 2])
def test_masked_reencode_matches_jax(rng, j):
    """Stages before j keep their codes, the rest re-encode greedily."""
    X, B, C = _rvq_init(rng, n=600)
    C = C + 0.1 * rng.standard_normal(C.shape).astype(np.float32)
    jB = jervq._masked_reencode(jnp.asarray(C), jnp.asarray(B),
                                jnp.asarray(X), j)
    tB = tervq._masked_reencode(_t(C), _t(B), _t(X), j)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    np.testing.assert_array_equal(tB.numpy()[:, :j], B[:, :j])


def test_quantize_ervq_is_rvq(rng):
    X, _, C = _rvq_init(rng, n=500)
    tB, tR = tervq.quantize_ervq(_t(C), _t(X))
    rB, rR = trvq.quantize_rvq(_t(C), _t(X))
    assert torch.equal(tB, rB) and torch.equal(tR, rR)
    jB, _ = jervq.quantize_ervq(jnp.asarray(C), jnp.asarray(X))
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))


def test_train_ervq_from_scratch_matches_jax_error(rng):
    """Different seeds (threefry against Philox): the mean error over
    training seeds 0-3 agrees within 5%. One seed's error moves by ~12%
    from seed to seed here (k-means++ at h = 16), in both packages."""
    X = _clustered(rng, 2000, 16)
    je = [float(jervq.train_ervq_from_scratch(
        jax.random.PRNGKey(s), jnp.asarray(X), 3, 16, niter=4)[2])
        for s in range(4)]
    te = []
    for s in range(4):
        gen = torch.Generator().manual_seed(s)
        _, B, e = tervq.train_ervq_from_scratch(gen, _t(X), 3, 16, niter=4)
        te.append(float(e))
    assert B.shape == (2000, 3) and B.dtype == torch.int32
    assert abs(np.mean(te) - np.mean(je)) <= 0.05 * np.mean(je), (te, je)


# -------------------------------------------------------------------- CompQ

@pytest.mark.parametrize("H", [2, 4, 16])
def test_quantize_compq_matches_jax(rng, H):
    n, d, m, h = 500, 16, 4, 32
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = (rng.standard_normal((m, h, d)) * 0.5).astype(np.float32)
    jB, jR = jcompq.quantize_compq(jnp.asarray(C), jnp.asarray(X), H=H,
                                   chunk=128)
    tB, tR = tcompq.quantize_compq(_t(C), _t(X), H=H, chunk=128)
    assert tB.dtype == torch.int32 and tB.shape == (n, m)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    je = (np.asarray(jR, np.float64) ** 2).sum(1)
    te = (tR.numpy().astype(np.float64) ** 2).sum(1)
    np.testing.assert_allclose(te, je, rtol=1e-5)
    # the residual is the one the codes leave
    np.testing.assert_allclose(tR.numpy(),
                               X - reconstruct(_t(C), tB).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_compq_chunks_do_not_change_the_codes(rng):
    X = rng.standard_normal((300, 12)).astype(np.float32)
    C = (rng.standard_normal((3, 16, 12)) * 0.5).astype(np.float32)
    a, _ = tcompq.quantize_compq(_t(C), _t(X), H=4, chunk=64)
    b, _ = tcompq.quantize_compq(_t(C), _t(X), H=4)
    assert torch.equal(a, b)


def test_compq_width_one_is_rvq(rng):
    """H = 1 is the greedy sequential RVQ encode, exactly."""
    X = rng.standard_normal((200, 10)).astype(np.float32)
    C = rng.standard_normal((3, 8, 10)).astype(np.float32)
    B1, R1 = tcompq.quantize_compq(_t(C), _t(X), H=1)
    Bg, Rg = trvq.quantize_rvq(_t(C), _t(X))
    assert torch.equal(B1, Bg) and torch.equal(R1, Rg)


def test_compq_wider_beam_is_no_worse(rng):
    X = rng.standard_normal((300, 12)).astype(np.float32)
    C = (rng.standard_normal((4, 16, 12)) * 0.4).astype(np.float32)
    errs = [float(qerror(_t(X), _t(C),
                         tcompq.quantize_compq(_t(C), _t(X), H=H)[0]))
            for H in (1, 2, 8, 16)]
    assert all(b <= a + 1e-5 for a, b in zip(errs, errs[1:])), errs


def test_layer_lrs_match_jax():
    for m in (1, 4, 7, 16):
        np.testing.assert_allclose(tcompq._layer_lrs(m, 0.01).numpy(),
                                   np.asarray(jcompq._layer_lrs(m, 0.01)),
                                   rtol=1e-6)
    assert abs(float(tcompq._layer_lrs(7, 0.03).sum()) - 0.03) < 1e-7


@pytest.mark.parametrize("update", ["sgd", "lsq"])
def test_train_compq_matches_jax(rng, update):
    X, B, C = _rvq_init(rng)
    _, jB, jo = jcompq.train_compq(jnp.asarray(X), jnp.asarray(C),
                                   jnp.asarray(B), niter=4, H=4, chunk=512,
                                   update=update)
    tm, tB, to = tcompq.train_compq(_t(X), _t(C), _t(B), niter=4, H=4,
                                    chunk=512, update=update)
    assert to.shape == (5,) and tB.dtype == torch.int32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4)
    assert (tB.numpy() == np.asarray(jB)).mean() >= 0.99
    assert float(to[-1]) < float(to[0])
    assert abs(float(to[-1]) - float(qerror(_t(X), tm.codebooks, tB))) <= 1e-6


def test_train_compq_rejects_an_unknown_update(rng):
    X, B, C = _rvq_init(rng, n=200)
    with pytest.raises(ValueError, match="'sgd' or 'lsq'"):
        tcompq.train_compq(_t(X), _t(C), _t(B), niter=1, update="adam")


def test_compq_sgd_stable_at_large_count(rng):
    """The batched step stays capped where each entry is visited many
    times (n / h = 500): uncapped, ``2 lr cnt`` passes 1 and training
    diverges; capped, the objective does not rise."""
    n, d, m, h = 8000, 8, 3, 16
    cent = rng.standard_normal((32, d)).astype(np.float32) * 2
    X = _t(cent[rng.integers(0, 32, n)]
           + rng.standard_normal((n, d)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    rvq, B0, _ = trvq.train_rvq(gen, X, m, h, niter=3)
    _, _, obj = tcompq.train_compq(X, rvq.codebooks, B0, niter=6, H=4)
    obj = obj.numpy()
    assert obj[-1] <= obj[0], obj
    assert (np.diff(obj) <= 1e-3).all(), obj


def test_compq_sums_are_reproducible(rng):
    """Two runs from one init give bitwise-equal codebooks (the per-entry
    sums are `segment_sum`'s fixed-order matmuls)."""
    X, B, C = _rvq_init(rng, n=1000)
    a = tcompq.train_compq(_t(X), _t(C), _t(B), niter=2, H=4)[0]
    b = tcompq.train_compq(_t(X), _t(C), _t(B), niter=2, H=4)[0]
    assert torch.equal(a.codebooks, b.codebooks)


# ------------------------------------------------------------------ facade

@pytest.fixture(scope="module")
def small_corr():
    return make_synthetic(d=32, ntrain=4000, nbase=20_000, nquery=1000,
                          corr=True, seed=3)


def _recalls(ids, gt, ev):
    r = ev(ids, gt, verbose=False)
    return float(r[0]), float(r[9])


@pytest.mark.parametrize("method", ["ervq", "compq"])
def test_facade_recall_within_jax_seed_spread(small_corr, method):
    """The port's train → index_base(codes) → search lands within three
    standard deviations of the JAX facade's mean recall@1 and @10 over
    training seeds 0-2, the deviation the larger of the seeds' and the
    sampling one of 1000 queries."""
    ds = small_corr
    kw = dict(method=method, m=4, h=32, niter=5)
    jr = []
    for s in range(3):
        jm = japi.train(ds.Xt, key=jax.random.PRNGKey(s), **kw)
        _, ji = japi.search(japi.index_base(jm, ds.Xb, mode="codes"), ds.Xq,
                            k=10)
        jr.append(_recalls(ji, ds.gt, j_eval_recall))
    tm = tapi.train(ds.Xt, seed=0, device="cpu", **kw)
    assert tm.method == method and tm.train_codes.shape == (4000, 4)
    tidx = tapi.index_base(tm, ds.Xb, mode="codes")
    td, ti = tapi.search(tidx, ds.Xq, k=10)
    assert td.shape == ti.shape == (1000, 10) and torch.isfinite(td).all()
    tr = _recalls(ti, ds.gt, eval_recall)
    jr = np.array(jr)
    for col in range(2):
        mu = jr[:, col].mean()
        sd = max(jr[:, col].std(ddof=1),
                 np.sqrt(mu * (1 - mu) / ds.Xq.shape[0]))
        assert abs(tr[col] - mu) <= 3 * sd, (method, col, tr, jr)


def test_facade_encodes_ervq_greedily_and_compq_by_beam(small_corr):
    """`encode` takes RVQ's greedy encoder for ERVQ and the beam (``kw``
    to `quantize_compq`) for CompQ, as the JAX facade does."""
    ds = small_corr
    C = _t(np.asarray(jrvq.train_rvq(jax.random.PRNGKey(0),
                                     jnp.asarray(ds.Xt[:1000]), 3, 16,
                                     niter=2)[0].codebooks))
    X = _t(ds.Xb[:500])
    B = tapi.encode(tapi.MCQModel("ervq", C, h=16), X)
    assert torch.equal(B, trvq.quantize_rvq(C, X)[0])
    for H in (1, 8):
        B = tapi.encode(tapi.MCQModel("compq", C, h=16), X, H=H)
        jB = japi.encode(japi.MCQModel("compq", jnp.asarray(C.numpy()),
                                       h=16), ds.Xb[:500], H=H)
        np.testing.assert_array_equal(B.numpy(), np.asarray(jB))


# ----------------------------------------------------------------------- CQ

def test_cq_parameter_dump_equals_jax(tmp_path):
    for p in ({}, dict(dictionaries_count=4, mu=0.001, PQ=True,
                       points_file="x.fvecs")):
        tcq.dump_cq_parameters(tcq.CQParameters(**p), tmp_path / "t.txt")
        jcq.dump_cq_parameters(jcq.CQParameters(**p), tmp_path / "j.txt")
        t = (tmp_path / "t.txt").read_bytes()
        assert t == (tmp_path / "j.txt").read_bytes()
    lines = dict(line.split("=", 1) for line in t.decode().splitlines())
    assert lines["PQ"] == "1" and lines["CQ"] == "1"
    assert lines["dictionaries_count"] == "4" and lines["mu"] == "0.001"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cq_files_cross_read(tmp_path, rng, writer):
    """Files one package writes, the other reads back equal, and both
    write the same bytes."""
    w, r = (jcq, tcq) if writer == "jax" else (tcq, jcq)
    D = rng.standard_normal((12, 8)).astype(np.float32)
    B = rng.integers(0, 256, (30, 4)).astype(np.int32)
    w.write_cq_fvecs(str(tmp_path / "D"), D)
    w.write_cq_bvecs(str(tmp_path / "B"), B)
    np.testing.assert_array_equal(r.read_cq_fvecs(str(tmp_path / "D")), D)
    np.testing.assert_array_equal(r.read_cq_bvecs(str(tmp_path / "B")), B)
    r.write_cq_fvecs(str(tmp_path / "D2"), D)
    assert (tmp_path / "D2").read_bytes() == (tmp_path / "D").read_bytes()


@pytest.mark.parametrize("local", [False, True])
def test_load_cq_model_serves_like_jax(tmp_path, rng, local):
    """The binary's outputs (codes global, entry in [i h, (i+1) h), or
    local to each codebook) load as the JAX package loads them, and
    `linscan_cq` serves them with the JAX package's result (integer
    data: every score exact)."""
    m, h, d, n = 3, 8, 6, 400
    D = rng.integers(-3, 4, (m * h, d)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    Bf = B if local else B + np.arange(m, dtype=np.int32)[None, :] * h
    tcq.write_cq_fvecs(str(tmp_path / "D"), D)
    tcq.write_cq_bvecs(str(tmp_path / "B"), Bf)
    C, Bl = tcq.load_cq_model(str(tmp_path / "D"), str(tmp_path / "B"), m)
    jC, jB = jcq.load_cq_model(str(tmp_path / "D"), str(tmp_path / "B"), m)
    assert isinstance(C, np.ndarray) and C.shape == (m, h, d)
    np.testing.assert_array_equal(C, jC)
    np.testing.assert_array_equal(Bl, jB)
    np.testing.assert_array_equal(Bl, B)
    Q = rng.integers(-3, 4, (16, d)).astype(np.float32)
    td, ti = linscan_cq(C, Q, Bl, k=10, device="cpu")
    jd, ji = j_linscan_cq(jnp.asarray(jC), jnp.asarray(Q), jnp.asarray(jB),
                          k=10)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_run_cq_needs_the_binary(tmp_path, monkeypatch):
    monkeypatch.delenv("CQ_BINARY", raising=False)
    with pytest.raises(FileNotFoundError, match="CQ_BINARY"):
        tcq.run_cq(tcq.CQParameters(), workdir=str(tmp_path))


def test_run_cq_runs_the_binary_on_its_config(tmp_path, monkeypatch):
    """With ``$CQ_BINARY`` set, `run_cq` writes the config and runs the
    binary on it (a stand-in script that copies its argument)."""
    exe = tmp_path / "cq"
    exe.write_text('#!/bin/sh\ncp "$1" "$1.seen"\n')
    exe.chmod(0o755)
    monkeypatch.setenv("CQ_BINARY", str(exe))
    cfg = tcq.run_cq(tcq.CQParameters(max_iter=3),
                     workdir=str(tmp_path / "out"))
    assert cfg == os.path.join(str(tmp_path / "out"), "config.txt")
    seen = open(cfg + ".seen").read()
    assert "max_iter=3\n" in seen and seen == open(cfg).read()
