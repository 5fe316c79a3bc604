"""ICM sweeps and ILS encoding of `rayuela_tpu_torch` against
`rayuela_tpu` on the CPU.

The sweeps are deterministic. On small-integer data every value is exact
in bf16 and in f32, so the plain sweep must give the TPU kernel's
(Pallas, interpret mode) and the XLA sweep's codes and energies exactly.
On Gaussian data bf16 rounding flips rare near-ties: at least 98% of the
codes agree, the JAX package's own bound between its two sweeps. ILS
draws from different generators in the two packages, so it is held to
the JAX encoder's mean cost within 5%."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.ops import icm as jicm
from rayuela_tpu.ops.icm_pallas import icm_sweeps_pallas
from rayuela_tpu.ops.qerror import get_binaries as j_get_binaries
from rayuela_tpu.ops.qerror import get_unaries as j_get_unaries
from rayuela_tpu.ops.qerror import veccost as j_veccost
from rayuela_tpu_torch.ops import icm as ticm
from rayuela_tpu_torch.ops.qerror import veccost

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _case(rng, kind, n=300, d=8, m=4, h=8):
    if kind == "int":
        X = rng.integers(-1, 2, (n, d)).astype(np.float32)
        C = rng.integers(-1, 2, (m, h, d)).astype(np.float32)
    else:
        X = rng.standard_normal((n, d)).astype(np.float32)
        C = (rng.standard_normal((m, h, d)) * 0.4).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    return X, C, B


def _xla_sweeps(X, C, B, order, icmiter):
    """The JAX package's XLA sweep with f32 tables (its CPU route)."""
    m, h = C.shape[:2]
    u = jnp.transpose(j_get_unaries(X, C), (1, 0, 2))
    Bin = j_get_binaries(C) * (1.0 - jnp.eye(m))[:, :, None, None]
    T = jnp.transpose(Bin, (1, 0, 2, 3)).reshape(m, m * h, h)
    return jicm._icm_sweeps(u, T.astype(jnp.float32), jnp.asarray(B),
                            jnp.asarray(order), icmiter)


@pytest.mark.parametrize("icmiter", [0, 1, 3])
def test_bf16_sweep_equals_the_tpu_kernel_on_integer_data(rng, icmiter):
    X, C, B = _case(rng, "int")
    order = np.array([2, 0, 3, 1], np.int32)
    jb, je = icm_sweeps_pallas(jnp.asarray(X), jnp.asarray(C),
                               jnp.asarray(B), jnp.asarray(order), icmiter,
                               chunk=64, interpret=True)
    tb, te = ticm.icm_sweeps_plain(_t(X), _t(C), _t(B), order, icmiter,
                                   op_dtype=torch.bfloat16)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # E + |x|^2 is the reconstruction cost of the output codes
    np.testing.assert_allclose(
        te.numpy() + (X ** 2).sum(1),
        veccost(_t(X), _t(C), tb).numpy(), atol=1e-4)


def test_bf16_sweep_agrees_with_the_tpu_kernel_on_gaussian_data(rng):
    X, C, B = _case(rng, "gauss", n=520, d=16)
    order = np.arange(4, dtype=np.int32)
    jb, je = icm_sweeps_pallas(jnp.asarray(X), jnp.asarray(C),
                               jnp.asarray(B), jnp.asarray(order), 2,
                               chunk=64, interpret=True)
    tb, te = ticm.icm_sweeps_plain(_t(X), _t(C), _t(B), order, 2,
                                   op_dtype=torch.bfloat16)
    assert (tb.numpy() == np.asarray(jb)).mean() >= 0.98
    assert tb.shape == (520, 4) and te.dtype == torch.float32
    assert np.isfinite(te.numpy()).all()


@pytest.mark.parametrize("order", [[0, 1, 2, 3], [3, 1, 0, 2]])
def test_f32_sweep_equals_the_xla_sweep_on_integer_data(rng, order):
    X, C, B = _case(rng, "int")
    order = np.asarray(order, np.int32)
    jb = _xla_sweeps(jnp.asarray(X), jnp.asarray(C), B, order, 2)
    tb, te = ticm.icm_sweeps_plain(_t(X), _t(C), _t(B), order, 2,
                                   op_dtype=torch.float32)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(
        te.numpy() + (X ** 2).sum(1),
        veccost(_t(X), _t(C), tb).numpy(), atol=1e-4)
    # the CPU wrapper is the f32 plain version
    wb, we = ticm.icm_sweeps(_t(X), _t(C), _t(B), order, 2)
    assert torch.equal(wb, tb) and torch.equal(we, te)


def test_perturb_redraws_npert_positions():
    gen = torch.Generator().manual_seed(0)
    B = torch.zeros(2000, 6, dtype=torch.int32)
    out = ticm._perturb(gen, B, 1, 1 << 20)
    changed = (out != B).sum(1)
    assert changed.max() == 1 and changed.float().mean() > 0.99
    out = ticm._perturb(gen, B, 3, 1 << 20)
    assert ((out != B).sum(1) <= 3).all()
    assert out.dtype == torch.int32


def test_ils_never_raises_a_cost_and_matches_jax(rng):
    X, C, B0 = _case(rng, "gauss", n=400, d=16)
    kw = dict(ilsiter=4, icmiter=2, npert=1, randord=True)
    jB = jicm.encoding_icm(jax.random.PRNGKey(0), jnp.asarray(X),
                           jnp.asarray(C), jnp.asarray(B0), **kw)
    gen = torch.Generator().manual_seed(0)
    tB = ticm.encoding_icm(gen, _t(X), _t(C), _t(B0), **kw)
    c0 = veccost(_t(X), _t(C), _t(B0))
    c1 = veccost(_t(X), _t(C), tB)
    assert bool((c1 <= c0 + 1e-3).all())
    assert float(c1.mean()) < 0.7 * float(c0.mean())
    cj = float(np.asarray(j_veccost(jnp.asarray(X), jnp.asarray(C),
                                    jB)).mean())
    assert abs(float(c1.mean()) - cj) <= 0.05 * cj, (float(c1.mean()), cj)
    # checkpoints continue one run: the costs never rise across them
    snaps = ticm.encoding_icm_checkpoints(
        torch.Generator().manual_seed(1), _t(X), _t(C), _t(B0),
        ilsiters=(1, 3), icmiter=2, npert=1)
    costs = [veccost(_t(X), _t(C), b) for b in snaps]
    assert bool((costs[1] <= costs[0] + 1e-3).all())


def test_whole_ils_kernel_and_bad_impls_raise(rng):
    X, C, B0 = _case(rng, "gauss", n=10)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="ROADMAP B10"):
        ticm.encoding_icm(gen, _t(X), _t(C), _t(B0), impl="pallas-ils")
    with pytest.raises(ValueError, match="impl"):
        ticm.encoding_icm(gen, _t(X), _t(C), _t(B0), impl="xla-ish")
    with pytest.raises(ValueError, match="float32"):
        ticm.icm_sweeps(_t(X).double(), _t(C), _t(B0), [0, 1, 2, 3], 1)
