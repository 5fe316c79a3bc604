"""Encoders and trainers of `rayuela_tpu_torch` against `rayuela_tpu`.

With the same codebooks the encoders are deterministic and must give the
same codes. Training draws its seeds from different generators (threefry
in JAX, `torch.Generator` here), so it is held to the JAX package's
quantization error on the same data, within 5%."""

import jax
import jax.numpy as jnp
import numpy as np
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
