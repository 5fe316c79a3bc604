"""The port's experiment layer against `rayuela_tpu.experiments`: the
results store writes the JAX package's bytes and reads across packages,
the recall tables and plots agree, the protocol runners reproduce the JAX
package's recall rows on a tiny synthetic protocol within the trials'
spread (torch's generators draw other k-means seeds and ILS perturbations
than JAX's), and query=base, resume, the incumbent configuration, the
high-recall ladder, the CLI and ``mesh=`` behave as in the JAX package.
Everything runs on the CPU (``device="cpu"``)."""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import rayuela_tpu.experiments.drivers as jdrv
import rayuela_tpu.experiments.store as jst
import rayuela_tpu.experiments.viz as jviz
import rayuela_tpu_torch.experiments.drivers as tdrv
import rayuela_tpu_torch.experiments.store as tst
import rayuela_tpu_torch.experiments.viz as tviz
from rayuela_tpu.experiments.datasets import make_synthetic
from rayuela_tpu.experiments.hpo import INCUMBENTS

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny protocol of `tests/test_experiments.py`
TINY = dict(m=4, h=16, niter=3, ntrials=3, knn=100, verbose=False,
            ilsiter=2, icmiter=2, npert=1, chunk=1024)


@pytest.fixture
def rng():
    return np.random.default_rng(31)


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Both packages' runners over every method, 3 trials each, on the
    same dataset: ``{package: (results, results_dir)}``."""
    ds = make_synthetic(d=16, ntrain=1200, nbase=4000, nquery=60,
                        ncenters=16, seed=1, name="tiny")
    jdir = str(tmp_path_factory.mktemp("jax"))
    tdir = str(tmp_path_factory.mktemp("port"))
    return {"jax": (jdrv.run_train_query_base(ds, results_dir=jdir, **TINY),
                    jdir),
            "port": (tdrv.run_train_query_base(ds, results_dir=tdir,
                                               device="cpu", **TINY), tdir)}


def _arrays(rng, m=3, h=16, d=8, n=50):
    return dict(C=rng.standard_normal((m, h, d)).astype(np.float32),
                B=rng.integers(0, h, (n, m)).astype(np.int32),
                R=np.linalg.qr(rng.standard_normal((d, d)))[0],
                B_base=rng.integers(0, h, (2 * n, m)).astype(np.int32),
                recall=np.sort(rng.random(100)).astype(np.float32),
                norms_codebook=rng.random(256).astype(np.float32),
                norms_codes=rng.integers(0, 256, 2 * n).astype(np.int32))


def test_store_files_are_byte_identical_and_read_across(tmp_path, rng):
    arrays = _arrays(rng)
    paths = {}
    for tag, st in (("jax", jst), ("port", tst)):
        paths[tag] = str(tmp_path / f"{tag}.h5")
        st.save_results(paths[tag], 0, train_error=1.5, **arrays)
        st.save_results(paths[tag], 3, C=arrays["C"], B=arrays["B"],
                        train_error=2.5, opq_error=[3.0, 2.0])
        st.save_results(paths[tag], 0, train_error=9.0, **arrays)
    assert open(paths["jax"], "rb").read() == open(paths["port"],
                                                   "rb").read()
    for writer, reader in (("jax", tst), ("port", jst)):
        assert reader.list_trials(paths[writer]) == [0, 3]
        for trial in (0, 3):
            got = reader.load_results(paths[writer], trial)
            ref = (jst if reader is tst else tst).load_results(
                paths[writer], trial)
            assert sorted(got) == sorted(ref)
            for k in got:
                assert got[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(got[k], ref[k])
    out = tst.load_results(paths["jax"], 0)
    assert out["train_error"] == np.float32(9.0)
    np.testing.assert_array_equal(out["B"], arrays["B"])
    assert tst.list_trials(str(tmp_path / "none.h5")) == []


def test_store_keeps_the_uint8_codes_contract(tmp_path, rng):
    arrays = _arrays(rng)
    arrays["B"] = arrays["B"] + 300
    for st in (jst, tst):
        with pytest.raises(ValueError, match="uint8"):
            st.save_results(str(tmp_path / "x.h5"), 0, train_error=0.0,
                            **arrays)
    with pytest.raises(ValueError, match="already"):
        tst.save_results(str(tmp_path / "y.h5"), 0, C=arrays["C"],
                         B=arrays["B_base"], train_error=0.0)
        tst.save_results(str(tmp_path / "y.h5"), 0, C=arrays["C"],
                         B=arrays["B_base"], train_error=0.0,
                         overwrite=False)


def test_recall_tables_and_plots_agree(tmp_path, rng, capsys):
    for trial in range(3):
        a = _arrays(rng)
        for method in ("pq", "sr_d"):
            tst.save_results(str(tmp_path / f"ds_{method}.h5"), trial,
                             train_error=1.0, **a)
    for method in ("pq", "sr_d"):
        got = tviz.load_recalls(str(tmp_path), "ds", method)
        np.testing.assert_array_equal(
            got, jviz.load_recalls(str(tmp_path), "ds", method))
        assert got.shape == (3, 100)
        tviz.print_recalls(got, label=method)
        port_out = capsys.readouterr().out
        jviz.print_recalls(got, label=method)
        assert port_out == capsys.readouterr().out and port_out
    with pytest.raises(FileNotFoundError):
        tviz.load_recalls(str(tmp_path), "ds", "lsq")
    png = tviz.make_plots(str(tmp_path), "ds", ["pq", "sr_d", "lsq"])
    assert png == str(tmp_path / "ds_recall.png")
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("method", tdrv.ALL_METHODS)
def test_tiny_protocol_reproduces_the_jax_rows(tiny_runs, method):
    """Each method's mean recall@1 over 3 trials lies within 3 x the JAX
    trials' std + 0.02 of the JAX mean; every curve is monotone and each
    package's store holds the other's curves."""
    r1 = {}
    for tag, (res, _) in tiny_runs.items():
        outs = res[method]
        assert len(outs) == 3
        for o in outs:
            assert (np.diff(o["recall"]) >= 0).all()
            assert o["recall"][-1] > 0.5, (tag, o["recall"][-1])
        r1[tag] = np.array([o["recall"][0] for o in outs])
    tol = 3 * r1["jax"].std(ddof=1) + 0.02
    assert abs(r1["port"].mean() - r1["jax"].mean()) <= tol, (r1, tol)
    for tag, (res, d) in tiny_runs.items():
        viz = jviz if tag == "port" else tviz
        got = viz.load_recalls(d, "tiny", method)
        np.testing.assert_array_equal(
            got, np.stack([o["recall"] for o in res[method]]))


def test_tiny_protocol_stages_report_their_seconds(tiny_runs):
    res, _ = tiny_runs["port"]
    for method, outs in res.items():
        s = outs[0]["seconds"]
        assert set(s) == {"train", "encode", "search"}, method
        assert all(v >= 0 for v in s.values())
        assert outs[0]["B_base"].shape == (4000, 4 if method in
                                           ("pq", "opq") else 3)


def test_query_base_recomputes_the_ground_truth_as_jax(monkeypatch,
                                                       tmp_path):
    """``run_query_base`` searches the training set, with the ground
    truth recomputed against it: the dataset its runner receives is the
    JAX package's."""
    ds = make_synthetic(d=16, ntrain=1500, nbase=1500, nquery=50,
                        ncenters=12, seed=2, name="qb")
    seen = {}
    for tag, mod in (("jax", jdrv), ("port", tdrv)):
        monkeypatch.setattr(mod, "run_train_query_base",
                            lambda d, tag=tag, **kw: seen.update({tag: d}))
    jdrv.run_query_base(ds, results_dir=str(tmp_path))
    tdrv.run_query_base(ds, results_dir=str(tmp_path), device="cpu")
    assert not np.array_equal(seen["port"].gt, ds.gt)
    for f in ("Xt", "Xb", "Xq", "gt"):
        np.testing.assert_array_equal(getattr(seen["port"], f),
                                      getattr(seen["jax"], f))
    assert seen["port"].Xb is seen["port"].Xt
    # base == train already: the dataset's own ground truth stays
    same = ds._replace(Xb=ds.Xt, gt=seen["jax"].gt)
    assert tdrv._query_base(same, "cpu").gt is same.gt


def test_query_base_protocol_reproduces_the_jax_rows(tmp_path):
    """3 trials of the query=base protocol through both runners: the
    searched base is the training set, and each method's mean recall@1
    and @50 lie within 3 x the JAX trials' std + 0.02 of the JAX mean."""
    ds = make_synthetic(d=16, ntrain=1500, nbase=1500, nquery=50,
                        ncenters=12, seed=2, name="qb")
    kw = dict(m=4, h=16, niter=2, ntrials=3, knn=50, methods=("pq", "rvq"),
              verbose=False)
    res = {"jax": jdrv.run_query_base(ds, results_dir=str(tmp_path / "j"),
                                      **kw),
           "port": tdrv.run_query_base(ds, results_dir=str(tmp_path / "t"),
                                       device="cpu", **kw)}
    for method in kw["methods"]:
        for outs in (res["jax"][method], res["port"][method]):
            assert all(o["B_base"].shape[0] == ds.Xt.shape[0]
                       for o in outs)
        for at in (0, 49):
            j, t = (np.array([o["recall"][at] for o in res[p][method]])
                    for p in ("jax", "port"))
            assert abs(t.mean() - j.mean()) <= 3 * j.std(ddof=1) + 0.02, (
                method, at, j, t)


def test_resume_skips_stored_trials_and_reloads_the_chain(tmp_path,
                                                          monkeypatch):
    """A resumed run skips the stored (method, trial) pairs, reloads
    ChainQ's (B, R) from the store to seed SR-D, and draws what a fresh
    run draws."""
    ds = make_synthetic(d=16, ntrain=600, nbase=1200, nquery=30,
                        ncenters=8, seed=4, name="rz")
    kw = dict(m=4, h=16, niter=2, ntrials=1, knn=20, verbose=False,
              device="cpu", ilsiter=2, icmiter=1)
    fresh = tdrv.run_train_query_base(
        ds, methods=("pq", "chainq", "sr_d"),
        results_dir=str(tmp_path / "fresh"), **kw)
    part = str(tmp_path / "part")
    first = tdrv.run_train_query_base(ds, methods=("pq", "chainq"),
                                      results_dir=part, **kw)
    seen = {}
    orig = tdrv.experiment_sr

    def spy(*a, **k):
        seen["chain_init"] = k["chain_init"]
        return orig(*a, **k)

    monkeypatch.setattr(tdrv, "experiment_sr", spy)
    again = tdrv.run_train_query_base(ds, methods=("pq", "chainq", "sr_d"),
                                      results_dir=part, resume=True, **kw)
    assert again["pq"][0]["resumed"] and again["chainq"][0]["resumed"]
    assert "resumed" not in again["sr_d"][0]
    np.testing.assert_array_equal(again["pq"][0]["recall"],
                                  first["pq"][0]["recall"])
    B, R = seen["chain_init"]
    np.testing.assert_array_equal(B.numpy(),
                                  first["chainq"][0]["B"].numpy())
    np.testing.assert_array_equal(R.numpy(),
                                  first["chainq"][0]["R"].numpy())
    np.testing.assert_array_equal(again["sr_d"][0]["recall"],
                                  fresh["sr_d"][0]["recall"])


def test_protocol_consumes_the_incumbent(tmp_path, monkeypatch):
    """``config="incumbent"`` resolves the reference's SMAC incumbent for
    (dataset, m) and feeds it to the LSQ family, explicit keywords
    winning (`tests/test_experiments.py:86-117`)."""
    ds = make_synthetic(d=16, ntrain=400, nbase=800, nquery=30,
                        ncenters=8, seed=3, name="labelme22k")
    captured = {}
    orig = tdrv.experiment_sr

    def spy(*a, **kw):
        captured.update(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(tdrv, "experiment_sr", spy)
    res = tdrv.run_train_query_base(
        ds, m=8, h=16, niter=2, ntrials=1, knn=20, methods=("sr_d",),
        results_dir=str(tmp_path), verbose=False, config="incumbent",
        chunk=512, ilsiter=2, device="cpu")
    inc = INCUMBENTS[("labelme", 8)]
    assert captured["ilsiter"] == 2
    assert captured["icmiter"] == inc.icmiter == 3
    assert captured["npert"] == inc.npert == 1
    assert captured["randord"] is inc.randord
    assert captured["p"] == inc.p and captured["schedule"] == inc.schedule
    assert res["sr_d"][0]["recall"][-1] > 0
    with pytest.raises(ValueError, match="LSQConfig"):
        tdrv.run_train_query_base(ds, methods=("sr_d",), config="bogus",
                                  results_dir=str(tmp_path), device="cpu")


def test_high_recall_ladder_is_monotone():
    ds = make_synthetic(d=16, ntrain=1500, nbase=1500, nquery=50,
                        ncenters=12, seed=2, name="qb")
    gen = torch.Generator().manual_seed(0)
    out = tdrv.high_recall_experiment(gen, ds, m=3, h=16, niter=2,
                                      ilsiters=(1, 4, 16), knn=50,
                                      verbose=False, ilsiter=2, icmiter=1,
                                      npert=1, chunk=512)
    assert set(out) == {1, 4, 16}
    for ils in out:
        assert (np.diff(out[ils]) >= 0).all()
    assert out[16][49] >= out[4][49] - 0.05
    assert out[4][49] >= out[1][49] - 0.05
    assert gen.initial_seed() == 0


def test_generators_are_keys():
    """`fold_in` derives a stage's generator from a key's seed alone:
    the key's state is never drawn from, one (key, stage) gives one
    stream, two stages two."""
    key = torch.Generator().manual_seed(5)
    a = torch.rand(4, generator=tdrv.fold_in(key, 7))
    torch.rand(3, generator=key)                   # advance the key
    b = torch.rand(4, generator=tdrv.fold_in(key, 7))
    c = torch.rand(4, generator=tdrv.fold_in(key, 11))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_the_store_less_trial_imports_no_h5py():
    """The runner's per-trial function without a results directory (the
    card's machine has no h5py) stores nothing and imports no h5py."""
    code = (
        "import sys\n"
        "from rayuela_tpu_torch.experiments import drivers\n"
        "from rayuela_tpu_torch.experiments.datasets import make_synthetic\n"
        "ds = make_synthetic(d=16, ntrain=400, nbase=800, nquery=20, "
        "ncenters=8, device='cpu')\n"
        "out = drivers._run_trial(ds, 0, None, m=4, h=16, niter=2, knn=20,"
        " methods=('pq', 'chainq', 'sr_d'), verbose=False, device='cpu',"
        " ilsiter=2, icmiter=1)\n"
        "print(sorted(out), 'h5py' in sys.modules,"
        " 'matplotlib' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["False", "False"]
    assert "'sr_d'" in out.stdout


def test_cli_runs_on_the_cpu(tmp_path):
    """``python -m rayuela_tpu_torch.cli --device cpu`` on
    synthetic-small: the summary prints and the plot is written."""
    res = tmp_path / "res"
    out = subprocess.run(
        [sys.executable, "-m", "rayuela_tpu_torch.cli", "--device", "cpu",
         "--dataset", "synthetic-small", "--m", "4", "--h", "16",
         "--niter", "2", "--knn", "50", "--methods", "pq", "rvq", "sr_d",
         "--results-dir", str(res)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr
    assert "=== recall summary ===" in out.stdout
    for method in ("pq", "rvq", "sr_d"):
        assert f"{method} recall@1 " in out.stdout
        assert (res / f"synthetic-small_{method}.h5").exists()
    png = res / "synthetic-small_recall.png"
    assert png.exists() and f"plot written to {png}" in out.stdout
    with h5py.File(res / "synthetic-small_pq.h5", "r") as f:
        assert f["0/B"].dtype == np.uint8


@pytest.mark.parametrize("call", ["runner", "chainq", "lsq", "sr"])
def test_mesh_raises_naming_item_5(tmp_path, call):
    """``mesh=`` is ported (it raised before): on a one-rank mesh the
    sharded ChainQ gives the meshless codes, the sharded LSQ family
    trains and encodes the base, and the runner takes the mesh's device
    and writes its store from the mesh's origin."""
    from rayuela_tpu_torch.parallel import make_mesh
    ds = make_synthetic(d=8, ntrain=100, nbase=200, nquery=5, ncenters=4,
                        seed=0, name="m")
    gen = torch.Generator().manual_seed(0)
    mesh = make_mesh(device="cpu")
    kw = dict(m=3, h=4, niter=2, knn=10, verbose=False)
    ils = dict(ilsiter=2, icmiter=1, npert=1)
    if call == "runner":
        out = tdrv.run_train_query_base(
            ds, mesh=mesh, results_dir=str(tmp_path),
            methods=("chainq", "sr_d"), verbose=False, m=3, h=4, niter=2,
            knn=10, **ils)
        assert set(out) == {"chainq", "sr_d"}
        assert (tmp_path / "m_sr_d.h5").exists()
        return
    fn = {"chainq": tdrv.experiment_chainq, "lsq": tdrv.experiment_lsq,
          "sr": tdrv.experiment_sr}[call]
    extra = {} if call == "chainq" else ils
    got = fn(gen, ds, mesh=mesh, **kw, **extra)
    ref = fn(gen, ds, **kw, **extra)
    assert got["B_base"].shape == ref["B_base"].shape == (200, 3)
    assert np.isfinite(got["train_error"])
    if call == "chainq":
        assert torch.equal(got["B"], ref["B"])
        assert torch.equal(got["B_base"], ref["B_base"])
    else:
        assert got["train_error"] <= 1.2 * ref["train_error"]

