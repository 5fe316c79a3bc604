"""The keywords the port's API took last (tests/test_torch_surface.py
holds the keyword surface as a whole) against the JAX package on the
CPU: `ops.kmeans.kmeans(init="random")`,
`parallel.lsq_sharded.replicated_solve_matches` and
`search_codes(lut_dtype=)`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.ops import kmeans as jkm
from rayuela_tpu.parallel import lsq_sharded as jls
from rayuela_tpu_torch.ops import kmeans as tkm
from rayuela_tpu_torch.parallel import lsq_sharded as tls
from rayuela_tpu_torch.search import scan_codes as tsc

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """A generator of each test's own."""
    return np.random.default_rng(0)


def _blobs(rng, n=3000, d=8, centres=40):
    """Clustered data: the seeding decides which local minimum Lloyd
    reaches, so the objective spreads over seeds."""
    C = rng.standard_normal((centres, d)).astype(np.float32) * 4.0
    a = rng.integers(0, centres, n)
    return (C[a] + rng.standard_normal((n, d)).astype(np.float32) * 0.5)


def test_kmeans_random_init_within_the_jax_seed_spread(rng):
    """`kmeans(init="random")` (k distinct rows drawn uniformly, then
    Lloyd): the port's mean objective over 6 seeds lies within the JAX
    package's seed range widened by its standard deviation, and both
    seed worse on average than kmeans++ does on this clustered data."""
    X = _blobs(rng)
    k, iters, seeds = 32, 10, range(6)
    jo = np.array([float(jkm.kmeans(jax.random.PRNGKey(s), jnp.asarray(X),
                                    k, iters=iters, init="random").objective)
                   for s in seeds])
    to = np.array([float(tkm.kmeans(torch.Generator().manual_seed(s),
                                    torch.from_numpy(X), k, iters=iters,
                                    init="random").objective)
                   for s in seeds])
    sd = jo.std(ddof=1)
    assert jo.min() - sd <= to.mean() <= jo.max() + sd, (to, jo)
    res = tkm.kmeans(torch.Generator().manual_seed(0), torch.from_numpy(X),
                     k, iters=0, init="random")
    # iters=0: the centres are k distinct rows of X
    rows = {tuple(r) for r in X.tolist()}
    got = [tuple(c) for c in res.centers.tolist()]
    assert len(set(got)) == k and set(got) <= rows
    pp = np.array([float(tkm.kmeans(torch.Generator().manual_seed(s),
                                    torch.from_numpy(X), k,
                                    iters=iters).objective) for s in seeds])
    assert pp.mean() <= to.mean()
    with pytest.raises(ValueError, match="unknown init"):
        tkm.kmeans(torch.Generator().manual_seed(0), torch.from_numpy(X), k,
                   init="forgy")


@pytest.mark.parametrize("m,h,d", [(4, 16, 16), (2, 32, 8)])
def test_replicated_solve_matches_jax(rng, m, h, d):
    """The single-device codebook solve equals the JAX package's to 1e-5:
    the reconstructions of the codes (absolute, on data of unit scale)
    and the quantization error (relative). The codebooks themselves
    agree only up to the system's null space (each codebook's one-hot
    columns sum to the same all-ones vector: a shift of one codebook
    that another takes back, fixed only by the small ridge, moves with
    the f32 factorization's rounding), here within 1e-3. The sharded
    solve of a world of one (`_solve`) equals it bit for bit."""
    from rayuela_tpu_torch.ops.qerror import reconstruct
    from rayuela_tpu_torch.parallel.mesh import make_mesh
    n = 4000
    X = rng.standard_normal((n, d)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    ref = torch.from_numpy(np.array(jls.replicated_solve_matches(
        jnp.asarray(X), jnp.asarray(B), h)))
    Xt, Bt = torch.from_numpy(X), torch.from_numpy(B)
    got = tls.replicated_solve_matches(Xt, Bt, h)
    assert got.shape == (m, h, d)
    rg, rr = reconstruct(got, Bt), reconstruct(ref, Bt)
    np.testing.assert_allclose(rg.numpy(), rr.numpy(), rtol=1e-5, atol=1e-5)
    eg, er = float(((Xt - rg) ** 2).sum()), float(((Xt - rr) ** 2).sum())
    assert abs(eg - er) <= 1e-5 * er
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-3)
    one = tls._solve(make_mesh(device="cpu"), Xt, Bt, h)
    assert torch.equal(one, got)


def test_search_codes_lut_dtype_is_the_operand_dtype(rng):
    """`search_codes(lut_dtype=)` (the JAX package's name) sets the
    operand dtype as ``op_dtype`` does, in LUT and decode mode; the two
    must agree where both are given."""
    n, d, m, h, nq, k = 9000, 16, 4, 16, 5, 10
    C = torch.from_numpy(rng.standard_normal((m, h, d)).astype(np.float32))
    B = torch.from_numpy(rng.integers(0, h, (n, m)).astype(np.int32))
    ncb = torch.from_numpy((rng.random(h) * 40).astype(np.float32))
    nco = torch.from_numpy(rng.integers(0, h, n).astype(np.int32))
    idx = tsc.build_codes_index(C, B, norms_cbook=ncb, norms_codes=nco)
    Q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    for mode in ("lut", "decode"):
        for dt in (torch.bfloat16, torch.float32):
            a = tsc.search_codes(idx, Q, k, mode=mode, lut_dtype=dt)
            b = tsc.search_codes(idx, Q, k, mode=mode, op_dtype=dt)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            c = tsc.search_codes(idx, Q, k, mode=mode, op_dtype=dt,
                                 lut_dtype=dt)
            assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    with pytest.raises(ValueError, match="lut_dtype"):
        tsc.search_codes(idx, Q, k, mode="lut", op_dtype=torch.float32,
                         lut_dtype=torch.bfloat16)
