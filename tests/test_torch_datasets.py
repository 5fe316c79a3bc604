"""The port's dataset catalog against `rayuela_tpu.experiments.datasets`:
each case of `tests/test_datasets.py` runs through both `read_dataset`s
(or HDF5 loaders) on files the test writes and gives identical arrays,
ground truth and exceptions; the synthetic family gives identical vectors
and ground truth, and a ``RAYUELA_SYNTH_CACHE`` file written by either
package loads in the other. The port computes ground truth on the card
unless asked for the CPU."""

import os

import h5py
import numpy as np
import pytest
import torch

import rayuela_tpu.experiments.datasets as jds
import rayuela_tpu_torch.api as tapi
import rayuela_tpu_torch.experiments.datasets as tds
from rayuela_tpu.io.xvecs import bvecs_write, fvecs_write, ivecs_write

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def _same(a, b):
    assert a.name == b.name
    for f in ("Xt", "Xb", "Xq", "gt"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _outcome(fn, *a, **k):
    try:
        return fn(*a, **k)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e), str(e)


def _h5(tmp_path, arrays):
    path = str(tmp_path / "fixture.h5")
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f[k] = v
    return path


def _hdf5_cases(rng):
    d, nt, nq = 8, 60, 7
    Xt = rng.standard_normal((50, 8)).astype(np.float32)
    Xb = rng.standard_normal((70, 8)).astype(np.float32)
    Xq = rng.standard_normal((9, 8)).astype(np.float32)
    jt = rng.standard_normal((d, nt)).astype(np.float32)
    jq = rng.standard_normal((d, nq)).astype(np.float32)
    at = rng.standard_normal((40, 6)).astype(np.float32)
    aq = rng.standard_normal((5, 6)).astype(np.float32)
    small = rng.standard_normal((10, 4)).astype(np.float32)
    return {
        "standard": ({"train": Xt, "base": Xb, "query": Xq,
                      "groundtruth": rng.integers(0, 70, 9)}, (50, 70, 9)),
        "julia_1_based": ({"train": jt, "test": jq, "gt": np.concatenate(
            [[nt], rng.integers(1, nt + 1, nq - 1)])}, (nt, nt, nq)),
        "ann_benchmarks": ({"train": at, "test": aq,
                            "neighbors": rng.integers(0, 40, (5, 10))},
                           (40, 40, 5)),
        "missing_key": ({"train": rng.standard_normal((4, 3))}, (4, 4, 2)),
        "out_of_range_gt": ({"train": small, "base": small,
                             "query": small[:2], "gt": np.array([3, 25])},
                            (10, 10, 2)),
    }


@pytest.mark.parametrize("case", ["standard", "julia_1_based",
                                  "ann_benchmarks", "missing_key",
                                  "out_of_range_gt"])
def test_hdf5_layouts_load_identically(tmp_path, rng, case):
    arrays, sizes = _hdf5_cases(rng)[case]
    path = _h5(tmp_path, arrays)
    got = _outcome(tds._load_hdf5, "fix", *sizes, path=path)
    ref = _outcome(jds._load_hdf5, "fix", *sizes, path=path)
    if isinstance(ref, tuple) and not hasattr(ref, "Xt"):
        assert got == ref
        return
    _same(got, ref)
    assert got.gt.min() >= 0 and got.gt.max() < got.Xb.shape[0]


def test_hdf5_catalog_names_read_from_the_data_root(tmp_path, rng,
                                                    monkeypatch):
    """``read_dataset("mnist")`` reads `$RAYUELA_DATA/mnist/mnist.h5` in
    both packages (base == train, (d, n) layout, 1-based gt)."""
    d, nt, nq = 8, 60, 7
    os.makedirs(tmp_path / "mnist")
    with h5py.File(tmp_path / "mnist" / "mnist.h5", "w") as f:
        f["train"] = rng.standard_normal((d, nt)).astype(np.float32)
        f["test"] = rng.standard_normal((d, nq)).astype(np.float32)
        f["gt"] = rng.integers(1, nt + 1, nq)
    monkeypatch.setenv("RAYUELA_DATA", str(tmp_path))
    _same(tds.read_dataset("MNIST", ntrain=nt, nquery=nq),
          jds.read_dataset("MNIST", ntrain=nt, nquery=nq))


def _texmex(root, rng, fmt):
    """The fixture files of `tests/test_datasets.py`: learn/base/query
    xvecs and a (nq, knn) ground-truth ivecs."""
    d, ntrain, nbase, nquery, knn = 16, 300, 800, 40, 10
    sub = {"fvecs": "sift", "bvecs": "sift1b"}[fmt]
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "sift1b", "gnd"), exist_ok=True)
    if fmt == "fvecs":
        def draw(n):
            return rng.standard_normal((n, d)).astype(np.float32)
        write, names = fvecs_write, jds._TEXMEX["sift1m"]
    else:
        def draw(n):
            return rng.integers(0, 256, (n, d)).astype(np.uint8)
        write, names = bvecs_write, jds._TEXMEX["sift10m"]
    Xt, Xb = draw(ntrain), draw(nbase)
    Xq = Xb[rng.integers(0, nbase, nquery)].astype(np.float32)
    Xq = Xq + 0.05 * rng.standard_normal((nquery, d)).astype(np.float32)
    if fmt == "bvecs":
        Xq = np.clip(np.round(Xq), 0, 255).astype(np.uint8)
    d2 = ((Xq.astype(np.float64)[:, None]
           - Xb.astype(np.float64)[None]) ** 2).sum(-1)
    for role, X in (("train", Xt), ("base", Xb), ("query", Xq)):
        write(os.path.join(root, names[role]), X)
    ivecs_write(os.path.join(root, names["gt"]),
                np.argsort(d2, axis=1)[:, :knn].astype(np.int32))
    return Xb


@pytest.mark.parametrize("fmt,name,sizes", [
    ("fvecs", "sift1m", dict(ntrain=300, nbase=800, nquery=40)),
    ("fvecs", "sift1m", dict(ntrain=100, nbase=500, nquery=10)),
    ("bvecs", "sift10m", dict(ntrain=300, nbase=800, nquery=40)),
])
def test_texmex_files_load_identically(tmp_path, rng, monkeypatch, fmt,
                                       name, sizes):
    _texmex(str(tmp_path), rng, fmt)
    monkeypatch.setenv("RAYUELA_DATA", str(tmp_path))
    got = tds.read_dataset(name, **sizes)
    _same(got, jds.read_dataset(name, **sizes))
    assert got.Xb.dtype == np.float32 and got.gt.dtype == np.int32


def test_sift10m_takes_its_defining_base_size(tmp_path, rng, monkeypatch):
    """``nbase=None`` asks sift10m for its 10M base rows: both packages
    read the same range and fail the same way on an 800-row file."""
    _texmex(str(tmp_path), rng, "bvecs")
    monkeypatch.setenv("RAYUELA_DATA", str(tmp_path))
    assert tds._TEXMEX == jds._TEXMEX and tds._HDF5 == jds._HDF5
    assert tds._H5_KEYS == jds._H5_KEYS
    got = _outcome(tds.read_dataset, "sift10m", ntrain=300, nquery=40)
    ref = _outcome(jds.read_dataset, "sift10m", ntrain=300, nquery=40)
    assert got == ref and got[0] is ValueError and "10000000" in got[1]


def test_unknown_and_missing_datasets_raise_alike(tmp_path, monkeypatch):
    monkeypatch.setenv("RAYUELA_DATA", str(tmp_path))
    for name in ("not-a-dataset", "gist1m", "labelme22k"):
        got = _outcome(tds.read_dataset, name, ntrain=10, nquery=5)
        ref = _outcome(jds.read_dataset, name, ntrain=10, nquery=5)
        assert got[0] is ref[0], (name, got, ref)


@pytest.mark.parametrize("name,kw", [
    ("synthetic-small", {}),
    ("synthetic-corr-small", dict(nquery=50, ncenters=8)),
    ("synthetic", dict(ntrain=100, nbase=500, nquery=10, d=16)),
])
def test_synthetic_family_is_identical(name, kw):
    _same(tds.read_dataset(name, device="cpu", **kw),
          jds.read_dataset(name, **kw))


def test_exact_ground_truth_equals_jax_on_near_duplicates():
    """The two-pass ground truth (f32 candidates on the device, f64
    refinement on the host, the margin rescan) gives the JAX package's
    ids where f32 cannot separate the rows."""
    rng = np.random.default_rng(3)
    n, d, nq = 5000, 24, 300
    Xb = rng.standard_normal((n, d)).astype(np.float32)
    Xb[1000:1200] = Xb[:200] + 1e-6
    Xq = np.concatenate([
        rng.standard_normal((nq - 100, d)).astype(np.float32),
        Xb[:100] + 1e-3 * rng.standard_normal((100, d)).astype(
            np.float32)])
    got = tds.exact_ground_truth(Xq, Xb, ncand=8, device="cpu")
    np.testing.assert_array_equal(got, jds.exact_ground_truth(Xq, Xb,
                                                              ncand=8))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_synthetic_cache_is_shared(tmp_path, monkeypatch, writer):
    """A cache file that one package writes is the file the other
    reads: one file for both, and its arrays come back."""
    monkeypatch.setenv("RAYUELA_SYNTH_CACHE", str(tmp_path))
    kw = dict(ntrain=50, nbase=400, nquery=8, d=8)
    first, second = ((jds.read_dataset, tds.read_dataset)
                     if writer == "jax" else
                     (tds.read_dataset, jds.read_dataset))
    a = first("synthetic", **({} if writer == "jax" else
                               dict(device="cpu")), **kw)
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    stamp = files[0].stat().st_mtime_ns
    b = second("synthetic", **(dict(device="cpu") if writer == "jax"
                               else {}), **kw)
    assert list(tmp_path.iterdir()) == files
    assert files[0].stat().st_mtime_ns == stamp
    _same(a, b)


def test_defaults_run_on_the_card():
    """``device=None`` is the card, as in the facade: with no card a
    default `exact_ground_truth` (and `make_synthetic`) raises where
    the facade's default call raises; with one, it equals the CPU's."""
    rng = np.random.default_rng(5)
    Xb = rng.standard_normal((300, 8)).astype(np.float32)
    Xq = rng.standard_normal((12, 8)).astype(np.float32)
    if torch.cuda.is_available():
        np.testing.assert_array_equal(
            tds.exact_ground_truth(Xq, Xb),
            tds.exact_ground_truth(Xq, Xb, device="cpu"))
        return
    facade = _outcome(tapi.train, Xb, method="pq", m=2, h=4, niter=1)
    assert isinstance(facade, tuple) and issubclass(facade[0], Exception)
    assert _outcome(tds.exact_ground_truth, Xq, Xb)[0] is facade[0]
    assert _outcome(tds.make_synthetic, d=8, ntrain=20, nbase=50,
                    nquery=4)[0] is facade[0]
