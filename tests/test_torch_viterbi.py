"""Viterbi encoding, the MRF terms and the codebook update of
`rayuela_tpu_torch` against `rayuela_tpu` on the CPU.

Viterbi is exact: on small-integer data every cost is exact in f32 and
the codes must equal both JAX implementations' (the Pallas kernel in
interpret mode and the XLA path). On Gaussian data the unaries are
summed in another order, so near-ties may flip: chain energies agree
within 1e-5 relative (plus 1e-4 absolute for energies near zero) and at
least 99% of the codes are equal. The codebook statistics are exact
counts (G) and f32 sums (F, 1e-5 relative); the solves are held by the
quantization error of the codebooks they give (1e-4 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.models import chainq as jcq
from rayuela_tpu.ops import codebook_update as jcu
from rayuela_tpu.ops import qerror as jqe
from rayuela_tpu.ops import viterbi as jvit
from rayuela_tpu.ops.viterbi_pallas import viterbi_encode_pallas
from rayuela_tpu_torch.models import chainq as tcq
from rayuela_tpu_torch.ops import codebook_update as tcu
from rayuela_tpu_torch.ops import qerror as tqe
from rayuela_tpu_torch.ops import viterbi as tvit

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _case(rng, kind, n, d, m, h):
    if kind == "int":
        X = rng.integers(-2, 3, (n, d)).astype(np.float32)
        C = rng.integers(-1, 2, (m, h, d)).astype(np.float32)
    else:
        X = rng.standard_normal((n, d)).astype(np.float32)
        C = rng.standard_normal((m, h, d)).astype(np.float32)
    return X, C


def _energy(X, C, B):
    return tvit.chain_energy(_t(X), _t(C), _t(B)).numpy()


@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_viterbi_matches_pallas_and_xla(rng, kind):
    X, C = _case(rng, kind, n=700, d=16, m=4, h=16)
    tB = tvit.viterbi_encode(_t(X), _t(C), chunk=256).numpy()
    for jB in (viterbi_encode_pallas(jnp.asarray(X), jnp.asarray(C),
                                     bc=256, interpret=True),
               jvit._viterbi_encode_xla(jnp.asarray(X), jnp.asarray(C),
                                        chunk=256)):
        jB = np.asarray(jB)
        if kind == "int":
            np.testing.assert_array_equal(tB, jB)
        else:
            et, ej = _energy(X, C, tB), _energy(X, C, jB)
            assert (np.abs(et - ej) <= 1e-5 * np.abs(ej) + 1e-4).all()
            assert (tB == jB).mean() >= 0.99


def test_viterbi_single_codebook_is_nearest_centre(rng):
    X, C = _case(rng, "gauss", n=300, d=8, m=1, h=16)
    B = tvit.viterbi_encode(_t(X), _t(C)).numpy()
    ref = np.argmin(((X[:, None, :] - C[0][None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(B[:, 0], ref)


def test_mrf_terms_match_jax(rng):
    X, C = _case(rng, "gauss", n=64, d=8, m=3, h=8)
    B = rng.integers(0, 8, (64, 3)).astype(np.int32)
    pairs = [(tqe.get_unaries(_t(X), _t(C)), jqe.get_unaries(X, C)),
             (tqe.get_binaries(_t(C)), jqe.get_binaries(C)),
             (tvit.chain_binaries(_t(C)), jvit.chain_binaries(C)),
             (tvit.chain_unaries(_t(X), _t(C)), jvit.chain_unaries(X, C)),
             (tqe.veccost_chunked(_t(X), _t(C), _t(B), chunk=16),
              jqe.veccost_chunked(jnp.asarray(X), jnp.asarray(C),
                                  jnp.asarray(B), chunk=16))]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_codebook_stats_and_solves_match_jax(rng):
    n, d, m, h = 2000, 12, 4, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    jG, jF = jcu.codebook_stats(jnp.asarray(X), jnp.asarray(B), h,
                                chunk=512)
    tG, tF = tcu.codebook_stats(_t(X), _t(B), h, chunk=512)
    np.testing.assert_array_equal(tG.numpy(), np.asarray(jG))
    np.testing.assert_allclose(tF.numpy(), np.asarray(jF), rtol=1e-5,
                               atol=1e-5 * np.abs(X).sum(0).max())
    for j, t in ((jcu._solve_direct(jG, jF, h, 1e-4),
                  tcu._solve_direct(tG, tF, h, 1e-4)),
                 (jcu._chain_solve(jG, jF, h=h, d=d, m=m, rho=1e-4),
                  tcu._chain_solve(tG, tF, h=h, d=d, m=m, rho=1e-4))):
        ej = float(jqe.qerror(X, j, B))
        et = float(tqe.qerror(_t(X), t, _t(B)))
        assert abs(et - ej) <= 1e-4 * ej, (et, ej)
    chain = tcu.update_codebooks_chain(_t(X), _t(B), h)
    st, sz = tcu.chain_dims(d, m)[1]
    assert bool((chain[3][:, st:st + sz] == 0).all())


@pytest.mark.parametrize("method", ["naive", "lsqr", "lsmr"])
def test_unported_updates_raise(rng, method):
    X = _t(rng.standard_normal((50, 4)).astype(np.float32))
    B = _t(rng.integers(0, 4, (50, 2)).astype(np.int32))
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tcu.update_codebooks(X, B, 4, method=method)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tcu.update_codebooks_generic(X, B, 4, None)


def test_train_chainq_follows_jax_from_the_same_init(rng):
    """ChainQ draws no random numbers: from the same codes and rotation
    both packages walk the same objective curve."""
    n, d, m, h = 1500, 12, 4, 16
    X = rng.standard_normal((n, d)).astype(np.float32)
    B0 = rng.integers(0, h, (n, m)).astype(np.int32)
    R0 = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    jm, jB, jobj = jcq.train_chainq(jnp.asarray(X), jnp.asarray(B0),
                                    jnp.asarray(R0), h=h, niter=3,
                                    chunk=512)
    tm, tB, tobj = tcq.train_chainq(_t(X), _t(B0), _t(R0), h=h, niter=3)
    np.testing.assert_allclose(tobj.numpy(), np.asarray(jobj), rtol=1e-3)
    assert (tB.numpy() == np.asarray(jB)).mean() >= 0.99
    R = tm.R.numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(d), atol=1e-4)
    Bq = tcq.quantize_chainq(tm, _t(X))
    assert torch.equal(Bq, tB)
