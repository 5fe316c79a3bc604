"""The served slice of `rayuela_tpu_torch` end to end on the CPU:
train → index_base(mode="codes") → search → eval_recall, held against
the JAX package's facade."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayuela_tpu.api as japi
from rayuela_tpu.experiments.datasets import make_synthetic
from rayuela_tpu.search.linscan import eval_recall as j_eval_recall
import rayuela_tpu_torch.api as tapi
from rayuela_tpu_torch import convert
from rayuela_tpu_torch.ops import icm as ticm
from rayuela_tpu_torch.ops import viterbi as tvit
from rayuela_tpu_torch.search import scan as tsp
from rayuela_tpu_torch.search import scan_codes as tsc
from rayuela_tpu_torch.search.linscan import eval_recall
from tests.torch_parity import assert_tie_rule

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_corr():
    return make_synthetic(d=32, ntrain=4000, nbase=20_000, nquery=1000,
                          corr=True, seed=3)


def test_jax_trained_rvq_serves_identically_from_the_port(small_corr):
    """A JAX-trained RVQ model and index, carried across with `convert`,
    return the JAX package's top-k from the port (tie rule). The
    codebooks and queries are rounded to a 1/16 grid so that every
    decoded value, dot product and |q|^2 is exact in f32 in both
    packages; the norms table enters each score with one rounding,
    identical in both."""
    ds = small_corr
    jm = japi.train(ds.Xt, method="rvq", m=3, h=16, niter=5,
                    key=jax.random.PRNGKey(0))
    Cr = np.round(np.asarray(jm.codebooks) * 16) / 16
    jm = japi.MCQModel("rvq", jnp.asarray(Cr), h=16,
                       train_codes=jm.train_codes)
    jidx = japi.index_base(jm, ds.Xb, mode="codes")
    Q = np.round(ds.Xq[:64] * 16) / 16
    jd, ji = japi.search(jidx, Q, k=20)

    tm = convert.model_from_arrays("rvq", np.asarray(jm.codebooks), h=16,
                                   train_codes=np.asarray(jm.train_codes))
    tidx = convert.index_from_arrays(
        tm, np.asarray(jidx.codes), np.asarray(jidx.norms_codebook),
        np.asarray(jidx.norm_codes), d=ds.Xb.shape[1])
    np.testing.assert_array_equal(tidx.scan_index.packed.numpy(),
                                  np.asarray(jidx.scan_index.packed))
    td, ti = tapi.search(tidx, Q, k=20)
    assert_tie_rule(jd, ji, td, ti)
    # the port's own base encode of the same model gives the same codes
    own = tapi.index_base(tm, ds.Xb, mode="codes")
    np.testing.assert_array_equal(own.codes.numpy(), np.asarray(jidx.codes))


def test_port_pipeline_recall_matches_jax(small_corr):
    """The port's own train → index → search → eval_recall lands within
    0.03 of the JAX package's recall@10 on the same data (the seeds
    differ: parity is statistical). At 6 x 64 codes recall@10 is ~0.98,
    where 1000 queries put the sampling spread well under 0.03."""
    ds = small_corr
    jm = japi.train(ds.Xt, method="rvq", m=6, h=64, niter=8,
                    key=jax.random.PRNGKey(0))
    _, ji = japi.search(japi.index_base(jm, ds.Xb, mode="codes"), ds.Xq,
                        k=10)
    rj = j_eval_recall(ji, ds.gt, verbose=False)[9]
    tm = tapi.train(ds.Xt, method="rvq", m=6, h=64, niter=8, seed=0)
    tidx = tapi.index_base(tm, ds.Xb, mode="codes")
    td, ti = tapi.search(tidx, ds.Xq, k=10)
    assert td.shape == ti.shape == (ds.Xq.shape[0], 10)
    assert torch.isfinite(td).all()
    rt = eval_recall(ti, ds.gt, verbose=False)[9]
    assert abs(rt - rj) <= 0.03, (rt, rj)
    assert rt > 0.9


def test_pq_pipeline_runs_and_recalls(small_corr):
    ds = small_corr
    tm = tapi.train(ds.Xt, method="pq", m=4, h=32, niter=8, seed=1)
    tidx = tapi.index_base(tm, ds.Xb, mode="codes")
    assert tidx.norms_codebook is None and tidx.scan_index.mprime == 4
    _, ti = tapi.search(tidx, ds.Xq, k=100)
    assert eval_recall(ti, ds.gt, verbose=False)[99] > 0.5


def test_cpu_takes_plain_paths_with_no_launch(small_corr):
    ds = small_corr
    wrappers = (tsc.codes_decode_candidates, tsc.cand_merge,
                tsc.codes_decode_topk, tsp.tail_merge, ticm.icm_sweeps,
                tvit.viterbi_encode)
    before = [w.launches for w in wrappers]
    tm = tapi.train(ds.Xt[:1000], method="rvq", m=2, h=16, niter=2)
    tidx = tapi.index_base(tm, ds.Xb[:5000], mode="codes")
    tapi.search(tidx, ds.Xq[:8], k=600)          # the one-pass plan too
    tapi.search(tidx, ds.Xq[:8], k=5000)
    tm = tapi.train(ds.Xt[:1000], method="sr_d", m=2, h=16, niter=1)
    tapi.index_base(tm, ds.Xb[:1000], mode="codes", ilsiter=2)
    assert [w.launches for w in wrappers] == before == [0] * 6


def test_unported_facade_routes_raise(small_corr):
    ds = small_corr
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tapi.train(ds.Xt, method="ervq")
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tapi.train(ds.Xt, method="compq")
    with pytest.raises(ValueError, match="unknown method"):
        tapi.train(ds.Xt, method="nope")
    tm = tapi.train(ds.Xt[:500], method="pq", m=2, h=8, niter=1)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tapi.index_base(tm, ds.Xb[:500], mode="decoded")
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tapi.index_base(tm, ds.Xb[:500])         # the JAX default, decoded
    tidx = tapi.index_base(tm, ds.Xb[:500], mode="codes")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tapi.search(tidx, ds.Xq[:2], mesh=object())


def test_port_never_imports_jax(tmp_path):
    """Importing every module of `rayuela_tpu_torch` and a whole CPU
    search leave jax out of sys.modules (run in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys, numpy as np\n"
        "import rayuela_tpu_torch, rayuela_tpu_torch.api as rq\n"
        "for mod in pkgutil.walk_packages(rayuela_tpu_torch.__path__, "
        "'rayuela_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "from rayuela_tpu_torch.experiments.datasets import "
        "make_synthetic\n"
        "from rayuela_tpu_torch.search.linscan import eval_recall\n"
        "ds = make_synthetic(d=16, ntrain=500, nbase=3000, nquery=20)\n"
        "m = rq.train(ds.Xt, method='rvq', m=2, h=8, niter=2)\n"
        "d, i = rq.search(rq.index_base(m, ds.Xb, mode='codes'), ds.Xq, k=10)\n"
        "eval_recall(i, ds.gt, verbose=False)\n"
        "print('jax' in sys.modules, "
        "any(k.startswith('rayuela_tpu.') or k == 'rayuela_tpu' "
        "for k in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["False", "False"]
