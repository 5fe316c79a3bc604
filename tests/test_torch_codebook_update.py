"""The codebook updates and small helpers of `rayuela_tpu_torch` that
came last (the ridge-free and iterative solves, the generic structured
update, `qerror_pq` / `qerror_opq`, the one-hot helpers) against their
`rayuela_tpu` counterparts on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu import utils as jutils
from rayuela_tpu.ops import codebook_update as jcu
from rayuela_tpu.ops import qerror as jqe
from rayuela_tpu_torch import utils as tutils
from rayuela_tpu_torch.ops import codebook_update as tcu
from rayuela_tpu_torch.ops import qerror as tqe


@pytest.fixture
def rng():
    return np.random.default_rng(20)


def _data(rng, n=600, d=12, m=3, h=8):
    X = rng.standard_normal((n, d)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    return X, B


def test_naive_is_the_minimum_norm_least_squares(rng):
    X, B = _data(rng)
    got = tcu.update_codebooks(torch.from_numpy(X), torch.from_numpy(B), 8,
                               method="naive").numpy()
    ref = np.asarray(jcu.update_codebooks(jnp.asarray(X), jnp.asarray(B), 8,
                                          method="naive"))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("method", ["lsqr", "lsmr"])
def test_cg_solvers_match_jax(rng, method):
    X, B = _data(rng)
    got = tcu.update_codebooks(torch.from_numpy(X), torch.from_numpy(B), 8,
                               method=method).numpy()
    ref = np.asarray(jcu.update_codebooks(jnp.asarray(X), jnp.asarray(B), 8,
                                          method=method))
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5)
    direct = tcu.update_codebooks(torch.from_numpy(X), torch.from_numpy(B),
                                  8).numpy()
    np.testing.assert_allclose(got, direct, rtol=1e-2, atol=1e-3)


def test_unknown_method_raises(rng):
    X, B = _data(rng)
    with pytest.raises(ValueError):
        tcu.update_codebooks(torch.from_numpy(X), torch.from_numpy(B), 8,
                             method="qr")


@pytest.mark.parametrize("d,m", [(12, 3), (13, 4), (16, 2)])
def test_get_cbdims_chain_is_identical(d, m):
    np.testing.assert_array_equal(tcu.get_cbdims_chain(d, m),
                                  jcu.get_cbdims_chain(d, m))


def test_generic_on_chain_supports_is_the_chain_update(rng):
    X, B = _data(rng, n=800, d=13, m=4)
    Xt, Bt = torch.from_numpy(X), torch.from_numpy(B)
    got = tcu.update_codebooks_generic(Xt, Bt, 8, tcu.get_cbdims_chain)
    chain = tcu.update_codebooks_chain(Xt, Bt, 8)
    np.testing.assert_allclose(got.numpy(), chain.numpy(), rtol=1e-5,
                               atol=1e-5)
    ref = np.asarray(jcu.update_codebooks_generic(
        jnp.asarray(X), jnp.asarray(B), 8, jcu.get_cbdims_chain))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-4)


def test_generic_on_random_supports_matches_jax(rng):
    X, B = _data(rng, n=700, d=10, m=3)
    dim2C = rng.random((10, 3)) < 0.6
    dim2C[0] = False                        # a dim no codebook covers
    got = tcu.update_codebooks_generic(torch.from_numpy(X),
                                       torch.from_numpy(B), 8, dim2C)
    ref = np.asarray(jcu.update_codebooks_generic(
        jnp.asarray(X), jnp.asarray(B), 8, dim2C))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-4)
    assert not got[:, :, 0].any()
    for i in range(10):
        for j in np.nonzero(~dim2C[i])[0]:
            assert not got[j, :, i].any()
    with pytest.raises(ValueError):
        tcu.update_codebooks_generic(torch.from_numpy(X),
                                     torch.from_numpy(B), 8, dim2C[:5])


def test_small_helpers_are_identical(rng):
    assert [tutils.round_up(x, 8) for x in (0, 1, 8, 9, 127)] \
        == [jutils.round_up(x, 8) for x in (0, 1, 8, 9, 127)]
    idx = rng.integers(-1, 6, (7, 3)).astype(np.int32)    # -1: a pad code
    np.testing.assert_array_equal(
        tutils.one_hot(torch.from_numpy(idx), 6).numpy(),
        np.asarray(jutils.one_hot(jnp.asarray(idx), 6)))
    np.testing.assert_array_equal(
        tutils.sparsify_codes(torch.from_numpy(idx), 6).numpy(),
        np.asarray(jutils.sparsify_codes(jnp.asarray(idx), 6)))
    K = rng.standard_normal((3 * 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tutils.K2vec(torch.from_numpy(K), 3, 6).numpy(),
        np.asarray(jutils.K2vec(jnp.asarray(K), 3, 6)))


def test_qerror_pq_and_opq_match_jax(rng):
    n, d, m, h = 500, 14, 4, 8
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = rng.standard_normal((m, h, 4)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    R = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    got = float(tqe.qerror_pq(*map(torch.from_numpy, (X, C, B))))
    ref = float(jqe.qerror_pq(*map(jnp.asarray, (X, C, B))))
    assert got == pytest.approx(ref, rel=1e-6)
    got = float(tqe.qerror_opq(*map(torch.from_numpy, (X, C, B, R))))
    ref = float(jqe.qerror_opq(*map(jnp.asarray, (X, C, B, R))))
    assert got == pytest.approx(ref, rel=1e-6)
