"""The whole-ILS encode of `rayuela_tpu_torch` (K12's plain version,
`encoding_ils_plain`) against the JAX package's one-launch kernel
(`encoding_ils_pallas`, interpret mode) on the CPU.

Both draw the perturbation from the same counter hash of (seed, global
vector id, round, draw), so with the same node orders and seed they walk
the same path: on small-integer data, where every value is exact in
bf16 and f32, codes and energies must be identical. The hash itself is
held to the TPU kernel's uint32 arithmetic on edge values; the energy
never rises round over round; and the facade's ``impl="pallas-ils"``
lands within 5% of the relaunch path's mean cost, the JAX package's own
bound between its ILS backends."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.ops import icm as jicm
from rayuela_tpu.ops.icm_pallas import encoding_ils_pallas
from rayuela_tpu.ops.qerror import veccost as j_veccost
from rayuela_tpu_torch.ops import icm as ticm
from rayuela_tpu_torch.ops.qerror import veccost

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """A generator of each test's own. The suite's shared one is
    advanced by every test that draws from it, which would make the data
    of the tests that run later in the same process depend on these."""
    return np.random.default_rng(0)


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


def _jax_hash32(x):
    """The TPU kernel's hash (`icm_pallas.py:167-170`), on uint32."""
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 2])
@pytest.mark.parametrize("schedule", ["random", "identity"])
def test_plain_ils_equals_the_tpu_kernel_on_integer_data(rng, seed,
                                                         schedule):
    """n = 300 is not a multiple of either chunk (128 vectors): the
    global vector id, not the chunk's, seeds each vector's draws."""
    m, ilsiter = 4, 3
    X, C, B = _case(rng, "int")
    if schedule == "random":
        orders = np.stack([rng.permutation(m) for _ in range(ilsiter)])
    else:
        orders = np.tile(np.arange(m), (ilsiter, 1))
    orders = orders.astype(np.int32)
    kw = dict(ilsiter=ilsiter, icmiter=2, npert=2)
    jb, je = encoding_ils_pallas(jnp.asarray(X), jnp.asarray(C),
                                 jnp.asarray(B), jnp.asarray(orders),
                                 jnp.asarray([[seed]], jnp.int32), chunk=128,
                                 interpret=True, **kw)
    tb, te = ticm.encoding_ils_plain(_t(X), _t(C), _t(B), orders, seed,
                                     op_dtype=torch.bfloat16, chunk=128,
                                     **kw)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert (tb.numpy() != B).any()
    # the CPU wrapper is the f32 plain version: the same on this data
    wb, we = ticm.encoding_ils(_t(X), _t(C), _t(B), _t(orders), seed, **kw)
    assert torch.equal(wb, tb) and torch.equal(we, te)


def test_zero_rounds_return_the_start_codes_and_their_energy(rng):
    X, C, B = _case(rng, "gauss")
    m = C.shape[0]
    kw = dict(ilsiter=0, icmiter=2, npert=1)
    b, e = ticm.encoding_ils_plain(_t(X), _t(C), _t(B),
                                   np.zeros((0, m), np.int32), 7, **kw)
    assert torch.equal(b, _t(B))
    _, e0 = ticm.icm_sweeps_plain(_t(X), _t(C), _t(B), list(range(m)), 0,
                                  op_dtype=torch.bfloat16)
    assert torch.equal(e, e0)
    jb, je = encoding_ils_pallas(jnp.asarray(X), jnp.asarray(C),
                                 jnp.asarray(B), jnp.zeros((1, m), jnp.int32),
                                 jnp.asarray([[7]], jnp.int32), chunk=128,
                                 interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(jb), B)
    np.testing.assert_allclose(np.asarray(je), e.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_energy_never_rises_round_over_round(rng):
    """Round r's draws depend on (seed, vector, r) alone, so ilsiter=r
    is the state after r rounds: the best energy never rises, and after
    four rounds it has fallen for most vectors."""
    X, C, B = _case(rng, "gauss", n=200)
    orders = np.stack([rng.permutation(4) for _ in range(4)]).astype(
        np.int32)
    energies = [ticm.encoding_ils_plain(_t(X), _t(C), _t(B), orders, 11,
                                        ilsiter=r, icmiter=1, npert=1)[1]
                for r in range(5)]
    for a, b in zip(energies, energies[1:]):
        assert bool((b <= a).all())
    assert float((energies[-1] < energies[0]).float().mean()) > 0.9


def test_the_hash_equals_the_tpu_kernels_on_uint32_edge_values(rng):
    vals = np.array([0, 1, 2 ** 16, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
                    + rng.integers(0, 2 ** 32, 64).tolist(), np.int64)
    got = ticm._hash32(torch.as_tensor(vals)).numpy()
    ref = np.asarray(_jax_hash32(jnp.asarray(vals.astype(np.uint32))))
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    for c in (0x9E3779B9, 0x7FEB352D, 0x846CA68B, 0xFFFFFFFF):
        prod = (vals.astype(np.uint32) * np.uint32(c)).astype(np.int64)
        np.testing.assert_array_equal(
            ticm._mul32(torch.as_tensor(vals), c).numpy(), prod)
    # the counter of the last draw of a high round and id wraps mod 2**32
    gid = torch.as_tensor([0, 2 ** 31 - 1], dtype=torch.int64)
    B = torch.zeros(2, 5, dtype=torch.int64)
    out = ticm._hash_perturb(B, gid, 2 ** 32 - 1, 1000, 3, 256)
    assert int(out.max()) < 256 and int(out.min()) >= 0


def test_pallas_ils_matches_the_relaunch_paths_quality(rng):
    """The one-launch path, the relaunch path and the JAX XLA encoder
    explore different random streams and land at the same mean cost;
    checkpoints through the one-launch path never raise a cost."""
    X, C, B0 = _case(rng, "gauss", n=400, d=16)
    kw = dict(ilsiter=4, icmiter=2, npert=1, randord=True)
    costs = []
    for impl in ("pallas-ils", "auto"):
        B = ticm.encoding_icm(torch.Generator().manual_seed(0), _t(X), _t(C),
                              _t(B0), impl=impl, **kw)
        costs.append(float(veccost(_t(X), _t(C), B).mean()))
    jB = jicm.encoding_icm(jax.random.PRNGKey(0), jnp.asarray(X),
                           jnp.asarray(C), jnp.asarray(B0), impl="xla", **kw)
    ref = float(np.asarray(j_veccost(jnp.asarray(X), jnp.asarray(C),
                                     jB)).mean())
    for c in costs:
        assert abs(c - ref) <= 0.05 * ref, (costs, ref)
    snaps = ticm.encoding_icm_checkpoints(
        torch.Generator().manual_seed(1), _t(X), _t(C), _t(B0),
        ilsiters=(1, 3), icmiter=2, npert=1, impl="pallas-ils")
    c0 = veccost(_t(X), _t(C), _t(B0))
    c1, c2 = (veccost(_t(X), _t(C), b) for b in snaps)
    assert bool((c1 <= c0 + 1e-3).all()) and bool((c2 <= c1 + 1e-3).all())
