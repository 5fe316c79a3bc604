"""Encoders and trainers of `rayuela_tpu_torch` against `rayuela_tpu`.

With the same codebooks the encoders are deterministic and must give the
same codes. Training draws its seeds from different generators (threefry
in JAX, `torch.Generator` here), so it is held to the JAX package's
quantization error on the same data, within 5%."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.models import pq as jpq
from rayuela_tpu.models import rvq as jrvq
from rayuela_tpu.ops import kmeans as jkm
from rayuela_tpu.search import norms as jnorms
from rayuela_tpu_torch.models import pq as tpq
from rayuela_tpu_torch.models import rvq as trvq
from rayuela_tpu_torch.ops import kmeans as tkm
from rayuela_tpu_torch.search import norms as tnorms

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """A generator of each test's own. The suite's shared one is
    advanced by every test that draws from it, which would make the data
    of the tests that run later in the same process depend on these."""
    return np.random.default_rng(0)


def _clustered(rng, n, d, ncenters=24):
    centers = rng.standard_normal((ncenters, d)).astype(np.float32) * 2
    a = rng.integers(0, ncenters, n)
    return (centers[a] + 0.5 * rng.standard_normal((n, d))
            ).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_quantize_rvq_pq_norms_same_codes(rng):
    n, d, m, h = 3000, 16, 3, 16
    X = _clustered(rng, n, d)
    C = rng.standard_normal((m, h, d)).astype(np.float32)
    jB, _ = jrvq.quantize_rvq(jnp.asarray(C), jnp.asarray(X))
    tB, _ = trvq.quantize_rvq(_t(C), _t(X))
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))

    Cp = rng.standard_normal((4, h, d // 4)).astype(np.float32)
    jBp = jpq.quantize_pq(jpq.PQModel(jnp.asarray(Cp)), jnp.asarray(X))
    tBp = tpq.quantize_pq(tpq.PQModel(_t(Cp)), _t(X))
    np.testing.assert_array_equal(tBp.numpy(), np.asarray(jBp))

    ncb = np.sort(rng.random(16).astype(np.float32) * 40)
    jc, jn = jnorms.quantize_norms(jnp.asarray(C), jB, jnp.asarray(ncb))
    tc, tn = tnorms.quantize_norms(_t(C), tB, _t(ncb))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _within(err_t, err_j, frac=0.05):
    err_t, err_j = float(err_t), float(err_j)
    assert abs(err_t - err_j) <= frac * err_j, (err_t, err_j)


# Training parity uses unclustered Gaussian data: its quantization error
# barely depends on the seeding, so the 5% bound measures the algorithm
# and not one seed's local minimum.

def test_kmeans_objective_matches_jax(rng):
    X = rng.standard_normal((3000, 8)).astype(np.float32)
    rj = jkm.kmeans(jax.random.PRNGKey(0), jnp.asarray(X), 32, iters=10)
    rt = tkm.kmeans(torch.Generator().manual_seed(0), _t(X), 32, iters=10)
    _within(rt.objective, rj.objective)
    assert rt.centers.shape == (32, 8)
    assert rt.assignments.dtype == torch.int32


def test_train_rvq_and_pq_qerror_match_jax(rng):
    X = rng.standard_normal((3000, 16)).astype(np.float32)
    _, _, ej = jrvq.train_rvq(jax.random.PRNGKey(0), jnp.asarray(X), 3,
                              16, niter=8)
    model, B, et = trvq.train_rvq(torch.Generator().manual_seed(0), _t(X),
                                  3, 16, niter=8)
    _within(et, ej)
    assert B.shape == (3000, 3) and model.codebooks.shape == (3, 16, 16)
    _, _, ej = jpq.train_pq(jax.random.PRNGKey(0), jnp.asarray(X), 4, 16,
                            iters=8)
    model, B, et = tpq.train_pq(torch.Generator().manual_seed(0), _t(X), 4,
                                16, iters=8)
    _within(et, ej)
    assert B.shape == (3000, 4) and model.codebooks.shape == (4, 16, 4)


def _add_at(X, idx, k):
    """float64 reference of ``out[idx[v]] += X[v]`` and the sum of the
    magnitudes in each segment (the scale of a float sum's rounding)."""
    ref = np.zeros((k, X.shape[1]))
    mag = np.zeros((k, X.shape[1]))
    np.add.at(ref, idx, X.astype(np.float64))
    np.add.at(mag, idx, np.abs(X).astype(np.float64))
    return ref, mag


def test_segment_sum_and_update_centers_match_float64(rng):
    """The deterministic segment sum, alone, with several segments per
    row (the `codebook_stats` form) and inside `update_centers`, equals
    a float64 `numpy.add.at` within 1e-6 relative to each segment's sum
    of magnitudes."""
    from rayuela_tpu_torch.utils import segment_sum
    n, d, k = 3000, 8, 32
    X = rng.standard_normal((n, d)).astype(np.float32)
    a = rng.integers(0, k, n)
    a[:5] = 7                                   # leave segment 31 empty
    a[a == 31] = 30
    ref, mag = _add_at(X, a, k)
    got = segment_sum(_t(X), _t(a), k, chunk=1000).numpy()
    assert (np.abs(got - ref) <= 1e-6 * mag).all()
    assert (got[31] == 0).all()
    B = np.stack([a, rng.integers(0, k, n)], 1)
    got2 = segment_sum(_t(X), _t(B + np.array([0, k])), 2 * k).numpy()
    ref2, mag2 = _add_at(X, B[:, 1], k)
    assert (np.abs(got2[:k] - ref) <= 1e-6 * mag).all()
    assert (np.abs(got2[k:] - ref2) <= 1e-6 * mag2).all()
    old = rng.standard_normal((k, d)).astype(np.float32)
    cnt = np.bincount(a, minlength=k)
    mean = ref / np.maximum(cnt, 1)[:, None]
    cen = tkm.update_centers(_t(X), _t(a.astype(np.int32)), k, _t(old),
                             repick=False).numpy()
    filled = cnt > 0
    assert (np.abs(cen[filled] - mean[filled])
            <= 1e-6 * (mag / np.maximum(cnt, 1)[:, None])[filled]).all()
    np.testing.assert_array_equal(cen[~filled], old[~filled])


def test_port_has_no_float_atomic_sums():
    """No module of the port sums floats through `index_add_`,
    `scatter_add_` or an accumulating `index_put_`: on the card those
    sum in an order that changes from run to run."""
    import pathlib
    import re
    root = pathlib.Path(tkm.__file__).resolve().parents[1]
    pat = re.compile(r"\b(index_add|scatter_add|scatter_reduce)_?\s*\(|"
                     r"accumulate\s*=\s*True")
    hits = [f"{p.relative_to(root)}:{i}" for p in sorted(root.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert len(list(root.rglob("*.py"))) > 10
    assert not hits, hits
