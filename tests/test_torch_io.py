"""`rayuela_tpu_torch.io` against `rayuela_tpu.io`: the xvecs files either
package writes are byte-identical and read back equal in the other, range
reads and errors match, and the port's native reader, built by ``g++``
into ``rayuela_tpu_torch/_build/``, equals its numpy path without writing
anything beside its source."""

import os

import numpy as np
import pytest

from rayuela_tpu.io import native as jnative
from rayuela_tpu.io import xvecs as jx
from rayuela_tpu_torch.io import native as tnative
from rayuela_tpu_torch.io import xvecs as tx

FLAVORS = {
    "fvecs": (lambda rng, n, d: rng.standard_normal((n, d)).astype(
        np.float32), "<f4", 4),
    "ivecs": (lambda rng, n, d: rng.integers(-2**31, 2**31 - 1, (n, d),
                                             dtype=np.int32), "<i4", 4),
    "bvecs": (lambda rng, n, d: rng.integers(0, 256, (n, d)).astype(
        np.uint8), np.uint8, 1),
}
PORT_IO = os.path.join(os.path.dirname(tnative.__file__))


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _fns(pkg, flavor):
    return getattr(pkg, f"{flavor}_read"), getattr(pkg, f"{flavor}_write")


def _io_tree():
    return sorted(os.path.relpath(os.path.join(r, f), PORT_IO)
                  for r, _, fs in os.walk(PORT_IO) for f in fs
                  if "__pycache__" not in r)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_files_are_byte_identical_and_read_across(tmp_path, rng, flavor):
    draw, _, _ = FLAVORS[flavor]
    X = draw(rng, 57, 13)
    (jr, jw), (tr, tw) = _fns(jx, flavor), _fns(tx, flavor)
    jw(str(tmp_path / "j"), X)
    tw(str(tmp_path / "t"), X)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    for native in ("never", "auto"):
        got_t = tr(str(tmp_path / "j"), native=native)
        got_j = jr(str(tmp_path / "t"), native="never")
        assert got_t.dtype == got_j.dtype
        np.testing.assert_array_equal(got_t, X)
        np.testing.assert_array_equal(got_j, X)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_range_reads_match(tmp_path, rng, flavor):
    draw, _, _ = FLAVORS[flavor]
    X = draw(rng, 40, 7)
    path = str(tmp_path / "x")
    tx._xvecs_write(path, X, X.dtype)
    (jr, _), (tr, _) = _fns(jx, flavor), _fns(tx, flavor)
    for start, count in ((0, 40), (5, 11), (39, 1), (12, None), (40, 0)):
        np.testing.assert_array_equal(
            tr(path, start, count, native="never"),
            jr(path, start, count, native="never"))


def _error(fn, *a, **k):
    try:
        fn(*a, **k)
    except Exception as e:  # noqa: BLE001 - the type is compared
        return type(e), str(e)
    return None


def test_errors_match(tmp_path, rng):
    X = rng.standard_normal((20, 8)).astype(np.float32)
    path = str(tmp_path / "x.fvecs")
    jx.fvecs_write(path, X)
    raw = bytearray(open(path, "rb").read())
    bad = bytearray(raw)
    bad[5 * (4 + 32)] = 99                     # a dimension header
    open(tmp_path / "bad.fvecs", "wb").write(bytes(bad))
    open(tmp_path / "trunc.fvecs", "wb").write(bytes(raw[:50]))
    cases = [(path, dict(start=10, count=100)),
             (path, dict(start=-1, count=2)),
             (str(tmp_path / "bad.fvecs"), {}),
             (str(tmp_path / "trunc.fvecs"), {})]
    for p, kw in cases:
        e_t = _error(tx.fvecs_read, p, native="never", **kw)
        e_j = _error(jx.fvecs_read, p, native="never", **kw)
        assert e_t is not None and e_t == e_j, (p, kw, e_t, e_j)


def test_native_builds_into_build_dir_and_equals_numpy(tmp_path, rng):
    before = _io_tree()
    assert tnative.available(), "g++ could not build the native reader"
    lib = tnative.library_path()
    assert lib.parent == tnative.BUILD_DIR and lib.exists()
    assert lib.parent.name == "_build"
    assert _io_tree() == before == ["__init__.py", "native.py",
                                    os.path.join("native",
                                                 "xvecs_native.cpp"),
                                    "xvecs.py"]
    for flavor, (draw, dt, size) in FLAVORS.items():
        X = draw(rng, 300, 24)
        path = str(tmp_path / f"x.{flavor}")
        _fns(tx, flavor)[1](path, X)
        for start, count in ((0, None), (100, 37), (299, 1)):
            ref = _fns(tx, flavor)[0](path, start, count, native="never")
            got = _fns(tx, flavor)[0](path, start, count, native="always")
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
        assert tnative.probe(path, size) == (24, 300)
        tnative.write(str(tmp_path / "w"), X, dt)
        assert ((tmp_path / "w").read_bytes()
                == open(path, "rb").read())


def test_native_errors_match_the_jax_native_reader(tmp_path, rng):
    if not jnative.available():
        pytest.skip("the JAX package's native reader does not build here")
    X = rng.standard_normal((20, 8)).astype(np.float32)
    path = str(tmp_path / "x.fvecs")
    jx.fvecs_write(path, X)
    raw = bytearray(open(path, "rb").read())
    raw[5 * (4 + 32)] = 99
    open(tmp_path / "bad.fvecs", "wb").write(bytes(raw))
    open(tmp_path / "trunc.fvecs", "wb").write(bytes(raw[:50]))
    for p, kw in ((path, dict(start=10, count=100)),
                  (str(tmp_path / "bad.fvecs"), {}),
                  (str(tmp_path / "trunc.fvecs"), {})):
        e_t = _error(tnative.read, p, "<f4", 4, **kw)
        e_j = _error(jnative.read, p, "<f4", 4, **kw)
        assert e_t is not None and e_t == e_j, (p, e_t, e_j)


def test_auto_routes_big_files_to_native(tmp_path, rng, monkeypatch):
    """``native="auto"`` takes the native reader past 16 MB, and
    ``"always"`` raises where the library is unavailable."""
    X = rng.standard_normal((40, 8)).astype(np.float32)
    path = str(tmp_path / "x.fvecs")
    tx.fvecs_write(path, X)
    calls = []
    real = tnative.read
    monkeypatch.setattr(tnative, "read",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    monkeypatch.setattr(os.path, "getsize", lambda p: 17 << 20)
    np.testing.assert_array_equal(tx.fvecs_read(path), X)
    assert len(calls) == 1
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(RuntimeError, match="unavailable"):
        tx.fvecs_read(path, native="always")
    np.testing.assert_array_equal(tx.fvecs_read(path), X)


def test_failed_build_reads_with_numpy(tmp_path, rng, monkeypatch):
    """Without a compiler the library is unavailable: reads take the
    numpy path, and the build leaves no file behind."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_failed", False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tmp_path / "_build" / "lib.so")
    monkeypatch.setenv("PATH", str(tmp_path))      # no g++ on it
    assert not tnative.available()
    assert not any((tmp_path / "_build").iterdir())
    X = rng.standard_normal((10, 4)).astype(np.float32)
    tx.fvecs_write(str(tmp_path / "x.fvecs"), X)
    np.testing.assert_array_equal(tx.fvecs_read(str(tmp_path / "x.fvecs")),
                                  X)
