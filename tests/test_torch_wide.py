"""The wide configurations of `rayuela_tpu_torch` against the JAX package
on the CPU (the port's plain versions; the JAX kernels in interpret
mode): rows wider than one d-block of the card's scan kernels (d = 300
and MNIST's 784), codes of 16 bytes with f32 tables (the 128-bit
configuration, where the card's LUT kernels take 8 queries a CTA), an
additive model carried over without its training codes, and the fusion
probe's plain version against the TPU probe's kernel.

On small-integer data every score is exact in both packages: packed
results compare under the tie rule (tests/torch_parity.py), exact-float
ones by score and as sets within equal scores. On Gaussian data the two
sum in different orders: at least 99% of the ids agree and every score
is within one truncation step (+ the atol stated)."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import rayuela_tpu.api as japi
from rayuela_tpu.experiments.datasets import make_synthetic
from rayuela_tpu.search import scan_codes_pallas as jsc
from rayuela_tpu.search import scan_pallas as jsp
import rayuela_tpu_torch.api as tapi
from rayuela_tpu_torch import convert
from rayuela_tpu_torch.demos import fusion_probe as tfp
from rayuela_tpu_torch.search import scan as tsp
from rayuela_tpu_torch.search import scan_codes as tsc
from tests.torch_parity import (assert_close_topk, assert_tie_rule,
                                int_dataset)

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
M, H = 4, 16


@pytest.fixture
def rng():
    """A generator of each test's own. The suite's shared one is
    advanced by every test that draws from it, which would make the data
    of the tests that run later in the same process depend on these."""
    return np.random.default_rng(0)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _queries(rng, kind, nq, d):
    if kind == "int":
        return rng.integers(-3, 4, (nq, d)).astype(np.float32)
    return rng.standard_normal((nq, d)).astype(np.float32)


def _codes_case(rng, d, n, pq, m=M, h=H):
    """Integer codebooks and codes (the norms byte for the additive
    layout) → both packages' code indexes."""
    C, B = int_dataset(rng, d=d, n=n, m=m, h=h, pq=pq)
    jn, tn = {}, {}
    if not pq:
        ncb = rng.integers(0, 200, h).astype(np.float32)
        nco = rng.integers(0, h, n).astype(np.int32)
        jn = dict(norms_cbook=jnp.asarray(ncb), norms_codes=jnp.asarray(nco))
        tn = dict(norms_cbook=_t(ncb), norms_codes=_t(nco))
    jidx = jsc.build_codes_index(jnp.asarray(C), jnp.asarray(B), pq=pq, d=d,
                                 **jn)
    tidx = tsc.build_codes_index(_t(C), _t(B), pq=pq, d=d, **tn)
    return jidx, tidx


# ---------------------------------------------------------------------------
# Rows wider than one d-block: d = 300, 784
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [300, 784])
@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_wide_decoded_scan_matches_jax(rng, d, kind):
    """K8's plain version + K2 + K3 (`scan_topk_packed`) over a decoded
    base of width d == JAX `pallas_scan_topk(pack=True)`, which pads d to
    a multiple of 128; the port pads to a multiple of 8."""
    n, nq, k, tile = 5000, 8, 30, 2048
    if kind == "int":
        Xd = rng.integers(-3, 4, (n, d)).astype(np.float32)
    else:
        Xd = rng.standard_normal((n, d)).astype(np.float32)
    x2 = (Xd * Xd).sum(-1)
    Q = _queries(rng, kind, nq, d)
    js, ji, jf = jsp.pallas_scan_topk(
        jnp.asarray(Q), jnp.asarray(Xd), jnp.asarray(x2), k=k, r=14, bq=8,
        tile=tile, keep=2, interpret=True, pack=True, tail=False)
    idx = tsp.LinscanIndex(_t(Xd), _t(x2))
    assert idx.Xd.shape[1] == -(-d // 8) * 8
    ts, ti, tf = tsp.scan_topk_packed(_t(Q), idx.Xd, idx.x2, k=k, r=14,
                                      tile=tile, keep=2)
    ts = ts + (_t(Q) ** 2).sum(-1, keepdim=True)
    if kind == "int":
        assert_tie_rule(js, ji, ts, ti)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    else:
        # terms reach ~d: f32 sums of d of them round at ~d * 2**-23 * d**.5
        assert_close_topk(js, ji, ts, ti, tsp._pack_idbits(6144),
                          atol=2e-3)


@pytest.mark.parametrize("d,pq", [(300, True), (784, False)])
def test_wide_decode_mode_search_matches_jax(rng, d, pq):
    """`search_codes` in decode mode (K1 → K2 → K3 and the rescue, plain
    versions) == JAX `search_codes` (interpret) at dp = 384 and 896:
    the PQ layout and the additive one with the norms byte."""
    n, nq, k = 5000, 6, 25
    jidx, tidx = _codes_case(rng, d, n, pq)
    Q = _queries(rng, "int", nq, d)
    jd, ji = jsc.search_codes(jidx, jnp.asarray(Q), k, interpret=True,
                              lut_dtype=jnp.float32)
    td, ti = tsc.search_codes(tidx, _t(Q), k)
    Cf, _ = tidx.decode_operands(d, torch.float32)
    assert Cf.shape[1] == -(-d // 128) * 128
    assert_tie_rule(jd, ji, td, ti)


@pytest.mark.parametrize("d,pq", [(300, False), (784, True)])
def test_wide_onepass_search_matches_jax(rng, d, pq):
    """`search_codes(twopass=False)` (K14's plain version) == the JAX
    one-pass search at the same plan, and == the port's two-pass
    search."""
    n, nq, k = 5000, 6, 25
    jidx, tidx = _codes_case(rng, d, n, pq)
    Q = _queries(rng, "int", nq, d)
    r, keep, tile = tsc._onepass_config(k, tidx.mprime)
    jd, ji = jsc.search_codes(jidx, jnp.asarray(Q), k, interpret=True,
                              lut_dtype=jnp.float32, twopass=False, r=r,
                              keep=keep, tile=tile, bq=8)
    one = tsc.search_codes(tidx, _t(Q), k, twopass=False)
    assert_tie_rule(jd, ji, one[0], one[1])
    two = tsc.search_codes(tidx, _t(Q), k, tile=tile, twopass=True)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


@pytest.mark.parametrize("d", [300, 784])
def test_wide_pack_false_search_matches_jax(rng, d):
    """`search(pack=False)` (K9, the pair merge, K10: plain versions) ==
    JAX `search(pack=False, interpret=True)` on the same f32 index, and
    == `exact_rescan` by position."""
    from rayuela_tpu_torch.search.linscan import exact_rescan
    n, nq, k = 4000, 6, 40
    C, B = int_dataset(rng, d=d, n=n, m=3, h=H, pq=False)
    nt = rng.integers(0, 300, n).astype(np.float32)
    Q = _queries(rng, "int", nq, d)
    jidx = jsp.build_index(jnp.asarray(C), jnp.asarray(B), d=d,
                           norm_term=jnp.asarray(nt))
    tidx = convert.decoded_index_from_arrays(
        np.asarray(jidx.Xd), np.asarray(jidx.x2), device="cpu")
    jd, ji = jsp.search(jidx, jnp.asarray(Q), k, pack=False, interpret=True,
                        bq=8)
    td, ti = tsp.search(tidx, _t(Q), k, pack=False)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jd, ji = np.asarray(jd), np.asarray(ji)
    for q in range(nq):
        inner = jd[q] != jd[q, -1]
        assert sorted(ji[q, inner]) == sorted(ti.numpy()[q, inner]), q
    Qp = torch.nn.functional.pad(_t(Q), (0, tidx.Xd.shape[1] - d))
    ed, ei = exact_rescan(Qp, tidx.Xd, tidx.x2, k)
    assert torch.equal(ti, ei) and torch.equal(td, ed)


# ---------------------------------------------------------------------------
# 128-bit codes, f32 tables: m' = 16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pq", [True, False])
@pytest.mark.parametrize("pack", [True, False])
def test_lut_search_at_128_bits_with_f32_tables_matches_jax(rng, pq, pack):
    """`search_codes(mode="lut")` with f32 tables at m' = 16 (PQ-16, and
    15 codebooks + the norms byte: the JAX package's 128-bit
    configurations), packed (K5) and exact-float (K6, K7) == JAX
    `search_codes(mode="lut", interpret=True)`."""
    n, d, nq, k = 5000, 32, 6, 30
    m = 16 if pq else 15
    jidx, tidx = _codes_case(rng, d, n, pq, m=m, h=32)
    assert tidx.mprime == 16
    Q = _queries(rng, "int", nq, d)
    # packed keys: one plan in both packages, so that both flag the same
    # queries (a flagged query's scores come back untruncated)
    plan = dict(r=14, keep=2, tile=1024) if pack else {}
    jd, ji = jsc.search_codes(jidx, jnp.asarray(Q), k, mode="lut",
                              pack=pack, interpret=True, bq=8,
                              lut_dtype=jnp.float32, **plan)
    td, ti = tsc.search_codes(tidx, _t(Q), k, mode="lut", pack=pack,
                              op_dtype=torch.float32, **plan)
    if pack:
        assert_tie_rule(jd, ji, td, ti)
        return
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    T = tsc.build_luts(tidx.C, _t(Q), pq=pq, d=d,
                       norms_cbook=tidx.norms_cbook)
    os_, oi = tsc.lut_scan(T, tsc.unpack_codes(tidx.packed, 16), k)
    assert torch.equal(ti, oi)


# ---------------------------------------------------------------------------
# An additive model carried over without its training codes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sr_d_without_codes():
    """A JAX SR-D model whose codebooks sit on a 1/16 grid (every decoded
    value and dot product exact in f32 in both packages), without
    training codes, and the data it serves."""
    ds = make_synthetic(d=32, ntrain=2000, nbase=5000, nquery=64,
                        corr=True, seed=3)
    jm = japi.train(ds.Xt, method="sr_d", m=3, h=16, niter=2,
                    key=jax.random.PRNGKey(0))
    C = np.round(np.asarray(jm.codebooks) * 16) / 16
    return ds, C, japi.MCQModel("sr_d", jnp.asarray(C), h=16)


# one unperturbed ILS round in a fixed node order: the encode is the same
# function in both packages (the default draws from their generators)
_DETERMINISTIC = dict(ilsiter=1, npert=0, randord=False)


def test_model_without_train_codes_serves_the_decoded_index(
        sr_d_without_codes):
    """`index_base` of an SR-D model with no training codes (as
    `convert.model_from_arrays` carries it by default) builds the
    decoded index with the exact |x_hat|^2 and no norms byte, as the JAX
    facade does, and both facades return the same top-k."""
    ds, C, jm = sr_d_without_codes
    jidx = japi.index_base(jm, ds.Xb, **_DETERMINISTIC)
    tm = convert.model_from_arrays("sr_d", C, h=16, device="cpu")
    assert tm.train_codes is None
    tidx = tapi.index_base(tm, ds.Xb, **_DETERMINISTIC)
    assert tidx.norms_codebook is None and tidx.norm_codes is None
    np.testing.assert_array_equal(tidx.codes.numpy(), np.asarray(jidx.codes))
    Xd = tidx.scan_index.Xd
    torch.testing.assert_close(tidx.scan_index.x2, (Xd * Xd).sum(-1),
                               rtol=1e-6, atol=1e-5)
    Q = np.round(ds.Xq * 16) / 16
    jd, ji = japi.search(jidx, Q, k=20)
    td, ti = tapi.search(tidx, Q, k=20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-3)


def test_model_without_train_codes_refuses_the_codes_index(
        sr_d_without_codes):
    """`mode="codes"` needs the norms byte: both facades raise, from
    `build_codes_index`, on the same condition."""
    ds, C, jm = sr_d_without_codes
    Xb = ds.Xb[:1000]
    with pytest.raises(ValueError, match="quantized-norms byte"):
        japi.index_base(jm, Xb, mode="codes", **_DETERMINISTIC)
    tm = convert.model_from_arrays("sr_d", C, h=16, device="cpu")
    with pytest.raises(ValueError, match="quantized-norms byte"):
        tapi.index_base(tm, Xb, mode="codes", **_DETERMINISTIC)


# ---------------------------------------------------------------------------
# The fusion probe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mosaic_probe():
    """The TPU probe's module, loaded from its file; its import sets a
    compilation cache directory, which is put back."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "bench_mosaic_fusion", REPO / "demos" / "bench_mosaic_fusion.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return mod


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("k", tfp.KS)
def test_fusion_probe_plain_version_matches_the_tpu_probe(mosaic_probe,
                                                          monkeypatch, k,
                                                          split):
    """`fusion_chain` on the CPU (its plain version) against the TPU
    probe's `_kernel_chain` in interpret mode, at 2 of its 128 blocks of
    8192 rows. The plain version rounds the product and the sum (as the
    card's kernel does, with __fmul_rn / __fadd_rn): it equals a numpy
    chain rounded twice. XLA on the CPU contracts y * a + b into one
    fused multiply-add: the TPU probe's kernel equals a numpy chain
    rounded once per op, and the two lie within k f32 steps of each
    other."""
    bmf = mosaic_probe
    monkeypatch.setattr(bmf, "NTILES", 2)
    X = np.random.default_rng(k).standard_normal(
        (2 * bmf.ROWS, bmf.BQ), dtype=np.float32)
    call = pl.pallas_call(
        functools.partial(bmf._kernel_chain, k=k, split=split),
        grid=(2,),
        in_specs=[pl.BlockSpec((bmf.ROWS, bmf.BQ), lambda t: (t, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, bmf.BQ), lambda t: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, bmf.BQ), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, bmf.BQ), jnp.float32)],
        interpret=True)
    jout = np.asarray(call(jnp.asarray(X)))
    tout = tfp.fusion_chain(torch.as_tensor(X), k, split=split).numpy()
    a, b = np.float32(tfp.MUL), np.float32(tfp.ADD)
    twice, once = X.copy(), X.copy()
    for _ in range(k):
        twice = (twice * a).astype(np.float32) + b
        once = (once.astype(np.float64) * np.float64(a)
                + np.float64(b)).astype(np.float32)
    np.testing.assert_array_equal(tout, twice.reshape(-1, 8, bmf.BQ).min(0))
    np.testing.assert_array_equal(jout, once.reshape(-1, 8, bmf.BQ).min(0))
    # an f32 step of the chain's largest values (|y| < 8) per op
    np.testing.assert_allclose(tout, jout, rtol=0, atol=k * 2.0 ** -20)


def test_fusion_probe_main_runs_its_plain_version_on_the_cpu():
    """`python -m rayuela_tpu_torch.demos.fusion_probe --device cpu`: the
    plain version for every k, no device number (no kernel times, no
    slope, no registers)."""
    res = tfp.main(["--device", "cpu", "--rows", "4096", "--reps", "1"])
    assert set(res["plain_ms"]) == set(tfp.KS)
    assert res["ms"] == {} and res["regs"] == {} and "slope_split" not in res


def test_scan_tail_probe_main_runs_on_the_cpu():
    """`python -m rayuela_tpu_torch.demos.profile_scan_tail --device cpu`:
    every step of both k, K8's plain version held against itself on the
    subset (ids equal, scores within one step), no kernel launched."""
    from rayuela_tpu_torch.demos import profile_scan_tail as pst
    res = pst.main(["--device", "cpu", "--n", "20000", "--nq", "16",
                    "--reps", "1"])
    for k in (1000, 100):
        assert {"search", "scan_topk_packed", "K8", "K2+K3+flags", "topk",
                "sort"} <= set(res[k])
        assert res[k]["ids_equal"] == 1.0 and res[k]["within_step"]
    assert res["launches"] == 0
