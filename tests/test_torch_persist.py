"""Persistence of `rayuela_tpu_torch.api` against `rayuela_tpu.api`: the
HDF5 layout is shared, so an index or a model that either package saves
loads in the other.

The models' codebooks and the queries are rounded to a 1/16 grid, so
that every decoded value, dot product and |q|^2 is exact in f32 in both
packages. The code-resident searches then agree under the packed keys'
tie rule (`torch_parity.assert_tie_rule`): the norms table enters each
score with one rounding, the same in both. A decoded index's norms
codebook is rounded to the grid too, so that its exact-float searches
(the JAX facade's exact rescan on the CPU, the port's ``pack=False``)
agree exactly. The layout
override (a decoded save loaded code-resident) draws a new norms
codebook, so it is held by recall."""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayuela_tpu.api as japi
from rayuela_tpu.experiments.datasets import make_synthetic
from rayuela_tpu.search import scan_pallas as jsp
from rayuela_tpu.search.linscan import eval_recall as j_eval_recall
import rayuela_tpu_torch.api as tapi
from rayuela_tpu_torch import convert
from rayuela_tpu_torch.search.linscan import eval_recall
from tests.torch_parity import assert_tie_rule

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("pq", "rvq", "ervq", "compq", "sr_d")
M, H, K = 4, 16, 20


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    these tests' data depend on what ran before them in the process)."""
    return np.random.default_rng(0)


def _grid(a):
    return None if a is None else np.round(np.asarray(a) * 16) / 16


@pytest.fixture(scope="module")
def data():
    # a base of more than one scan tile: at fewer rows the JAX package's
    # plan takes a smaller tile than the port's, and packs fewer id bits
    ds = make_synthetic(d=32, ntrain=1000, nbase=20_000, nquery=32,
                        corr=True, seed=5)
    return ds.Xt, ds.Xb, _grid(ds.Xq).astype(np.float32)


_JAX_MODELS, _PORT_MODELS = {}, {}


def _jax_model(method, Xt):
    """A JAX-trained model with its codebooks on the grid."""
    if method not in _JAX_MODELS:
        jm = japi.train(Xt, method=method, m=M, h=H, niter=2,
                        key=jax.random.PRNGKey(0))
        _JAX_MODELS[method] = japi.MCQModel(
            method, jnp.asarray(_grid(jm.codebooks)), h=H,
            train_codes=jm.train_codes)
    return _JAX_MODELS[method]


def _port_model(method, Xt):
    """A port-trained model (on the CPU) with its codebooks on the grid."""
    if method not in _PORT_MODELS:
        tm = tapi.train(Xt, method=method, m=M, h=H, niter=2, seed=0,
                        device="cpu")
        _PORT_MODELS[method] = tapi.MCQModel(
            method, torch.as_tensor(_grid(tm.codebooks.numpy())), h=H,
            train_codes=tm.train_codes)
    return _PORT_MODELS[method]


def _same_top_k(jidx, tidx, Q):
    """The two packages' searches of one saved index agree: code-resident
    under the tie rule; decoded exactly through the exact-float scans,
    and the packed scans (the JAX kernel in interpret mode, one explicit
    plan in both) under the tie rule."""
    jd, ji = japi.search(jidx, Q, k=K)
    if jidx.mode == "codes":
        td, ti = tapi.search(tidx, Q, k=K)
        assert_tie_rule(jd, ji, td, ti)
        return
    td, ti = tapi.search(tidx, Q, k=K, pack=False)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    plan = dict(r=14, tile=1024, keep=2)
    jd, ji = jsp.search(jidx.scan_index, jnp.asarray(Q), K, interpret=True,
                        pack=True, bq=8, **plan)
    td, ti = tapi.search(tidx, Q, k=K, **plan)
    assert_tie_rule(jd, ji, td, ti)


def _same_saved(jidx, tidx):
    np.testing.assert_array_equal(tidx.codes.numpy(), np.asarray(jidx.codes))
    for a, b in ((tidx.norms_codebook, jidx.norms_codebook),
                 (tidx.norm_codes, jidx.norm_codes)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tidx.mode == jidx.mode and tidx.model.method == jidx.model.method
    jd = (jidx.scan_index.d if jidx.mode == "codes"
          else jidx.scan_index.Xd.shape[1])
    assert tidx.scan_index.d == jd


@pytest.mark.parametrize("mode", ["codes", "decoded"])
@pytest.mark.parametrize("method", METHODS)
def test_jax_saved_index_loads_in_the_port(data, tmp_path, method, mode):
    """A JAX save loads in the port with the JAX-loaded index's top-k,
    and the port writes it back byte for byte."""
    Xt, Xb, Q = data
    jm = _jax_model(method, Xt)
    jidx = japi.index_base(jm, Xb, mode=mode)
    if mode == "decoded":
        jidx.norms_codebook = _grid(jidx.norms_codebook)
    path, back = tmp_path / "j.h5", tmp_path / "t.h5"
    japi.save_index(str(path), jidx)
    jl = japi.load_index(str(path))
    tl = tapi.load_index(str(path), device="cpu")
    assert tl.codes.device.type == "cpu" and tl.mode == mode
    _same_saved(jl, tl)
    _same_top_k(jl, tl, Q)
    tapi.save_index(str(back), tl)
    assert back.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("mode", ["codes", "decoded"])
@pytest.mark.parametrize("method", METHODS)
def test_port_saved_index_loads_in_jax(data, tmp_path, method, mode):
    """A port save (its own training and base encode) loads in the JAX
    package with the port-loaded index's top-k; the reloaded index
    searches as the live one does."""
    Xt, Xb, Q = data
    tm = _port_model(method, Xt)
    saved = tapi.saved_index(tapi.index_base(tm, Xb, mode=mode))
    if mode == "decoded":
        saved["norms_codebook"] = _grid(saved["norms_codebook"])
    live = tapi.index_from_saved(saved, device="cpu")
    path = tmp_path / "t.h5"
    tapi.save_index(str(path), live)
    jl = japi.load_index(str(path))
    tl = tapi.load_index(str(path), device="cpu")
    _same_saved(jl, tl)
    _same_top_k(jl, tl, Q)
    for a, b in zip(tapi.search(live, Q, k=K), tapi.search(tl, Q, k=K)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["codes", "decoded"])
def test_arrays_round_trip_searches_identically(data, mode):
    """`saved_index` → `index_from_saved`, the path the card takes
    without h5py: the rebuilt index's search equals the live one's."""
    Xt, Xb, Q = data
    for method in ("ervq", "compq"):
        live = tapi.index_base(_port_model(method, Xt), Xb, mode=mode)
        saved = tapi.saved_index(live)
        assert saved["codes"].dtype == np.uint8
        assert saved["norm_codes"].dtype == np.uint8
        assert saved["@mode"] == mode and saved["@d"] == 32
        again = tapi.index_from_saved(saved, device="cpu")
        assert torch.equal(again.codes, live.codes)
        for a, b in zip(tapi.search(live, Q, k=K), tapi.search(again, Q,
                                                                 k=K)):
            assert torch.equal(a, b)


def test_layout_override_by_recall(tmp_path):
    """A decoded save loaded code-resident gets a norms codebook of h
    entries drawn anew (a generator seeded 3): its recall stays within
    0.02 of the live code-resident index's, in the port and in the JAX
    package alike."""
    ds = make_synthetic(d=32, ntrain=4000, nbase=20_000, nquery=1000,
                        corr=True, seed=7)
    tm = tapi.train(ds.Xt, method="rvq", m=6, h=64, niter=4, device="cpu")
    dec = tapi.index_base(tm, ds.Xb)
    assert dec.norms_codebook.numel() == 256
    path = tmp_path / "dec.h5"
    tapi.save_index(str(path), dec)
    over = tapi.load_index(str(path), mode="codes", device="cpu")
    assert over.mode == "codes" and over.norms_codebook.numel() == 64
    assert torch.equal(over.codes, dec.codes)
    live = tapi.index_base(tm, ds.Xb, mode="codes")
    r = [eval_recall(tapi.search(i, ds.Xq, k=10)[1], ds.gt,
                     verbose=False)[[0, 9]] for i in (live, over)]
    jover = japi.load_index(str(path), mode="codes")
    rj = j_eval_recall(japi.search(jover, ds.Xq, k=10)[1], ds.gt,
                       verbose=False)[[0, 9]]
    assert np.abs(r[1] - r[0]).max() <= 0.02, r
    assert np.abs(rj - r[1]).max() <= 0.02, (rj, r)
    assert r[1][1] > 0.9


@pytest.mark.parametrize("mode", ["codes", "decoded"])
def test_written_d_is_the_true_width(tmp_path, rng, mode):
    """At d = 30 the port's decoded base is padded to 32 columns; the
    file says 30, and the JAX package loads and searches it."""
    Xt = rng.standard_normal((600, 30)).astype(np.float32)
    Xb = rng.standard_normal((10_000, 30)).astype(np.float32)
    Q = _grid(Xb[:16] + 0.1 * rng.standard_normal((16, 30))).astype(
        np.float32)
    tm = tapi.train(Xt, method="rvq", m=3, h=H, niter=2, device="cpu")
    tm.codebooks = torch.as_tensor(_grid(tm.codebooks.numpy()))
    idx = tapi.index_base(tm, Xb, mode=mode)
    if mode == "decoded":
        assert idx.scan_index.Xd.shape[1] == 32
    if mode == "decoded":
        saved = tapi.saved_index(idx)
        saved["norms_codebook"] = _grid(saved["norms_codebook"])
        idx = tapi.index_from_saved(saved, device="cpu")
    path = tmp_path / "d30.h5"
    tapi.save_index(str(path), idx)
    with h5py.File(path, "r") as f:
        assert int(f.attrs["d"]) == 30 and f.attrs["mode"] == mode
    jl = japi.load_index(str(path))
    tl = tapi.load_index(str(path), device="cpu")
    assert tl.scan_index.d == 30
    if mode == "decoded":
        assert jl.scan_index.Xd.shape[1] == 30
    _same_top_k(jl, tl, Q)


def test_codes_beyond_256_entries_are_int32(tmp_path, rng):
    """At h = 512 the training and base codes are stored int32 (uint8
    up to 256 entries), the norms codes uint8, in both packages."""
    Xt = rng.standard_normal((2000, 16)).astype(np.float32)
    tm = tapi.train(Xt, method="rvq", m=2, h=512, niter=2, device="cpu")
    assert int(tm.train_codes.max()) > 255
    idx = tapi.index_base(tm, Xt[:1500], mode="decoded")
    tpath, jpath = tmp_path / "t.h5", tmp_path / "j.h5"
    tapi.save_index(str(tpath), idx)
    with h5py.File(tpath, "r") as f:
        assert f["model/train_codes"].dtype == np.int32
        assert f["codes"].dtype == np.int32
        assert f["norm_codes"].dtype == np.uint8
    jl = japi.load_index(str(tpath))
    np.testing.assert_array_equal(np.asarray(jl.codes), idx.codes.numpy())
    np.testing.assert_array_equal(np.asarray(jl.model.train_codes),
                                  tm.train_codes.numpy())
    japi.save_index(str(jpath), jl)
    assert jpath.read_bytes() == tpath.read_bytes()
    tl = tapi.load_index(str(jpath), device="cpu")
    assert torch.equal(tl.codes, idx.codes)
    assert torch.equal(tl.model.train_codes, tm.train_codes)


@pytest.mark.parametrize("method,h,rot", [("pq", 16, False),
                                          ("opq", 16, True),
                                          ("chainq", 512, True),
                                          ("compq", 16, False)])
def test_model_files_cross_load(tmp_path, rng, method, h, rot):
    """`save_model` / `load_model` in both directions: the same bytes,
    the same arrays (the rotation of OPQ and ChainQ included)."""
    d = 8
    C = rng.standard_normal((3, h, d)).astype(np.float32)
    R = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    R = R if rot else None
    B = rng.integers(0, h, (50, 3)).astype(np.int32)
    tm = convert.model_from_arrays(method, C, R=R, h=h, train_codes=B,
                                   device="cpu")
    jm = japi.MCQModel(method, jnp.asarray(C),
                       R=None if R is None else jnp.asarray(R), h=h,
                       train_codes=jnp.asarray(B))
    tpath, jpath = tmp_path / "t.h5", tmp_path / "j.h5"
    tapi.save_model(str(tpath), tm)
    japi.save_model(str(jpath), jm)
    assert tpath.read_bytes() == jpath.read_bytes()
    tl = tapi.load_model(str(jpath), device="cpu")
    jl = japi.load_model(str(tpath))
    assert tl.method == jl.method == method and tl.h == jl.h == h
    for a, b in ((tl.codebooks, C), (tl.R, R), (tl.train_codes, B),
                 (jl.codebooks, C), (jl.R, R), (jl.train_codes, B)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(np.asarray(a), b)
    assert tl.codebooks.dtype == torch.float32
    assert tl.train_codes.dtype == torch.int32


def test_loads_go_to_the_card_by_default(tmp_path, rng):
    """Like the rest of the facade, `load_model` / `load_index` put what
    they read on the card unless the caller names a device: where there
    is none they raise."""
    C = rng.standard_normal((2, 8, 4)).astype(np.float32)
    tm = convert.model_from_arrays("pq", C, h=8, device="cpu")
    idx = tapi.index_base(tm, rng.standard_normal((100, 8)).astype(
        np.float32), mode="codes")
    tapi.save_index(str(tmp_path / "i.h5"), idx)
    calls = (lambda: tapi.load_model(str(tmp_path / "i.h5")),
             lambda: tapi.load_index(str(tmp_path / "i.h5")).model)
    for call in calls:
        if torch.cuda.is_available():
            assert call().codebooks.device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_facade_imports_without_h5py(tmp_path):
    """Where h5py is absent (the card's machine) the facade imports, the
    arrays round trip works, and only the HDF5 calls raise ImportError
    (a fresh interpreter with h5py blocked)."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import numpy as np, torch\n"
        "import rayuela_tpu_torch.api as rq\n"
        "from rayuela_tpu_torch import convert\n"
        "C = np.random.default_rng(0).standard_normal((2, 8, 4))\n"
        "m = convert.model_from_arrays('pq', C, h=8, device='cpu')\n"
        "X = np.random.default_rng(1).standard_normal((64, 8))\n"
        "idx = rq.index_base(m, X.astype(np.float32), mode='codes')\n"
        "again = rq.index_from_saved(rq.saved_index(idx), device='cpu')\n"
        "assert torch.equal(again.codes, idx.codes)\n"
        "for call in (lambda: rq.save_index('i.h5', idx),\n"
        "             lambda: rq.save_model('m.h5', m),\n"
        "             lambda: rq.load_index('i.h5', device='cpu'),\n"
        "             lambda: rq.load_model('m.h5', device='cpu')):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError:\n"
        "        print('ImportError')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ImportError"] * 4
    assert not list(tmp_path.iterdir())
