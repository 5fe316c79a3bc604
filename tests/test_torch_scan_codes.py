"""Code-resident scan of `rayuela_tpu_torch` against
`rayuela_tpu.search.scan_codes_pallas` on the CPU: the port's plain
versions of kernels K1, K2 and K4 against the JAX scan functions run in
interpret mode.

On small-integer data every score is exact in both packages, so results
compare under the tie rule (tests/torch_parity.py). On Gaussian data the
two sum in different orders: at least 99% of the ids agree and every
score is within one truncation step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.search import scan_codes_pallas as jsc
from rayuela_tpu_torch.search import scan as tsp
from rayuela_tpu_torch.search import scan_codes as tsc
from tests.torch_parity import (assert_close_topk, assert_tie_rule,
                                gauss_dataset, int_dataset)

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """A generator of each test's own. The suite's shared one is
    advanced by every test that draws from it, which would make the data
    of the tests that run later in the same process depend on these."""
    return np.random.default_rng(0)


D, M, H = 32, 4, 16


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _norms(rng, n, integer: bool):
    ncb = (rng.integers(0, 60, 12) if integer
           else rng.random(12) * 40).astype(np.float32)
    return ncb, rng.integers(0, 12, n).astype(np.int32)


def _operands(C, B, pq, ncb, nco, jdtype, tdtype):
    """Packed codes and decode operands from both packages (checked
    equal), returned per package."""
    jn = None if ncb is None else jnp.asarray(ncb)
    tn = None if ncb is None else _t(ncb)
    jpk = jsc.pack_codes(jnp.asarray(B),
                         None if nco is None else jnp.asarray(nco))
    tpk = tsc.pack_codes(_t(B), None if nco is None else _t(nco))
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    jCf, jnrm = jsc.build_decode_operands(jnp.asarray(C), pq=pq, d=D,
                                          norms_cbook=jn, op_dtype=jdtype)
    tCf, tnrm = tsc.build_decode_operands(_t(C), pq=pq, d=D,
                                          norms_cbook=tn, op_dtype=tdtype)
    np.testing.assert_array_equal(tCf.float().numpy(),
                                  np.asarray(jCf.astype(jnp.float32)))
    np.testing.assert_array_equal(tnrm.float().numpy(),
                                  np.asarray(jnrm.astype(jnp.float32)))
    return (jCf, jnrm, jpk), (tCf, tnrm, tpk)


def _data(rng, kind, pq, n):
    mk = int_dataset if kind == "int" else gauss_dataset
    C, B = mk(rng, d=D, n=n, m=M, h=H, pq=pq)
    ncb = nco = None
    if not pq:
        ncb, nco = _norms(rng, n, kind == "int")
    return C, B, ncb, nco


def _queries(rng, nq, kind):
    if kind == "int":
        return rng.integers(-3, 4, (nq, D)).astype(np.float32)
    return rng.standard_normal((nq, D)).astype(np.float32)


def test_pack_unpack_bit_identical(rng):
    for m in (3, 4, 7, 9, 16, 17):
        B = rng.integers(0, 256, (37, m)).astype(np.int32)
        P = tsc.pack_codes(_t(B))
        np.testing.assert_array_equal(P.numpy(),
                                      np.asarray(jsc.pack_codes(B)))
        np.testing.assert_array_equal(tsc.unpack_codes(P, m).numpy(), B)
    B = rng.integers(0, 256, (20, 7)).astype(np.int32)
    nc = rng.integers(0, 256, 20).astype(np.int32)
    P = tsc.pack_codes(_t(B), _t(nc))
    np.testing.assert_array_equal(P.numpy(),
                                  np.asarray(jsc.pack_codes(B, nc)))
    U = tsc.unpack_codes(P, 8).numpy()
    np.testing.assert_array_equal(U[:, :7], B)
    np.testing.assert_array_equal(U[:, 7], nc)


@pytest.mark.parametrize("pq", [True, False])
def test_luts_and_decode_operands_match(rng, pq):
    # uneven PQ split (7 per subspace); values scaled so that the
    # tables stay below 4 and f32 rounding (either summation order) is
    # under the 1e-6 tolerance
    d = 28 if pq else 24
    ds = d // M if pq else d
    C = 0.25 * rng.standard_normal((M, H, ds)).astype(np.float32)
    Q = 0.25 * rng.standard_normal((5, d)).astype(np.float32)
    ncb = None if pq else (rng.random(10) * 20).astype(np.float32)
    Tj = jsc.build_luts(jnp.asarray(C), jnp.asarray(Q), pq=pq, d=d,
                        norms_cbook=None if pq else jnp.asarray(ncb))
    Tt = tsc.build_luts(_t(C), _t(Q), pq=pq, d=d,
                        norms_cbook=None if pq else _t(ncb))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-6,
                               rtol=0)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        jC, jn = jsc.build_decode_operands(
            jnp.asarray(C), pq=pq, d=d, op_dtype=jd,
            norms_cbook=None if pq else jnp.asarray(ncb))
        tC, tn = tsc.build_decode_operands(
            _t(C), pq=pq, d=d, op_dtype=td,
            norms_cbook=None if pq else _t(ncb))
        assert tC.dtype == td and tC.shape == jC.shape
        np.testing.assert_allclose(tC.float().numpy(),
                                   np.asarray(jC.astype(jnp.float32)),
                                   atol=1e-6)
        np.testing.assert_allclose(tn.float().numpy(),
                                   np.asarray(jn.astype(jnp.float32)),
                                   atol=1e-6)


@pytest.mark.parametrize("kind,pq,dtype", [
    ("int", True, "f32"), ("int", False, "f32"), ("gauss", True, "f32"),
    ("gauss", False, "f32"), ("gauss", True, "bf16")])
def test_two_pass_scan_matches_jax(rng, kind, pq, dtype):
    """K1 + K2 + K3 (`scan_codes_decode_topk_2p`) == JAX
    `pallas_scan_codes_decode_topk_2p`, n ragged against the tile."""
    n, nq, k = 20_000, 16, 40
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    C, B, ncb, nco = _data(rng, kind, pq, n)
    Q = _queries(rng, nq, kind)
    (jCf, jnrm, jpk), (tCf, tnrm, tpk) = _operands(C, B, pq, ncb, nco,
                                                   jdt, tdt)
    js, ji, jf = jsc.pallas_scan_codes_decode_topk_2p(
        jnp.asarray(Q), jCf, jnrm, jpk, k=k, pq=pq, r=16, bq=16,
        tile=8192, keep=2, keep2=0, rows2=16, interpret=True,
        op_dtype=jdt)
    ts, ti, tf = tsc.scan_codes_decode_topk_2p(
        _t(Q), tCf, tnrm, tpk, k=k, pq=pq, r=16, tile=8192, keep=2)
    if kind == "int":
        assert_tie_rule(js, ji, ts, ti)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    else:
        # score terms (|x|^2, 2 q.x) reach ~40: f32 sums of 32 of them
        # round at ~40 * 2**-23 * sqrt(32) < 3e-5
        idbits = tsp._pack_idbits(24576)
        assert_close_topk(js, ji, ts, ti, idbits, atol=1e-4)


@pytest.mark.parametrize("pq", [True, False])
def test_one_pass_rescue_scan_matches_jax(rng, pq):
    """K4 + K3 (`scan_codes_decode_topk`, keep=0, r=48, tile=2048) ==
    JAX `pallas_scan_codes_decode_topk` at the rescue configuration."""
    n, nq, k = 20_000, 8, 60
    C, B, ncb, nco = _data(rng, "int", pq, n)
    Q = _queries(rng, nq, "int")
    (jCf, jnrm, jpk), (tCf, tnrm, tpk) = _operands(
        C, B, pq, ncb, nco, jnp.float32, torch.float32)
    js, ji, jf = jsc.pallas_scan_codes_decode_topk(
        jnp.asarray(Q), jCf, jnrm, jpk, k=k, pq=pq, r=48, bq=8,
        tile=2048, keep=0, interpret=True, op_dtype=jnp.float32)
    ts, ti, tf = tsc.scan_codes_decode_topk(_t(Q), tCf, tnrm, tpk, k=k,
                                            pq=pq, r=48, tile=2048)
    assert_tie_rule(js, ji, ts, ti)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_flagged_queries_rescue_matches_jax_fused(rng):
    """A lane overflowed with near-ties of one query
    (tests/test_scan_codes.py:166): the two-pass scan flags it, the
    rescue repairs it, and the result equals JAX `_scan_segment_fused`,
    which repairs it in-graph."""
    n, k = 2048, 32
    C, B = int_dataset(rng, d=D, n=n, m=M, h=H, pq=True)
    best = rng.integers(0, H, M).astype(np.int32)
    for t in range(16):
        B[t * 128] = best                     # lane-0 pileup for q0
    from rayuela_tpu_torch.ops.qerror import reconstruct_pq
    Q = reconstruct_pq(_t(C), _t(B), D).numpy()[0:1]
    Q = np.concatenate([Q, _queries(rng, 3, "int")])
    (jCf, jnrm, jpk), (tCf, tnrm, tpk) = _operands(
        C, B, True, None, None, jnp.float32, torch.float32)
    _, _, fl = tsc.scan_codes_decode_topk_2p(_t(Q), tCf, tnrm, tpk, k=k,
                                             pq=True, r=16, keep=2)
    assert fl[0]
    jq, ji, jfl, jhard = jsc._scan_segment_fused(
        jnp.asarray(Q), jCf, jnrm, jpk, k=k, pq=True, r=16, bq=16,
        tile=8192, keep=2, rows2=16, twopass=True, qsuper=1, stage=0,
        op_dtype=jnp.float32, vmem_mb=None, interpret=True)
    assert not np.asarray(jfl).any() and not np.asarray(jhard).any()
    idx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=D)
    tq, ti = tsc.search_codes(idx, _t(Q), k)
    assert_tie_rule(jq, ji, tq, ti)


@pytest.mark.parametrize("pq,n,k", [(True, 20_000, 25),
                                    (False, 20_000, 25),
                                    (True, 5_000, 5_050)])
def test_search_codes_matches_jax(rng, pq, n, k):
    """`search_codes` == JAX `search_codes` (interpret, f32 tables): n
    ragged against every tile, additive with the norms byte, and k > n
    (clamped to n: every row once, the one-pass plan)."""
    nq = 6
    C, B, ncb, nco = _data(rng, "int", pq, n)
    Q = _queries(rng, nq, "int")
    jidx = jsc.build_codes_index(
        jnp.asarray(C), jnp.asarray(B), pq=pq, d=D,
        norms_cbook=None if pq else jnp.asarray(ncb),
        norms_codes=None if pq else jnp.asarray(nco))
    tidx = tsc.build_codes_index(
        _t(C), _t(B), pq=pq, d=D, norms_cbook=None if pq else _t(ncb),
        norms_codes=None if pq else _t(nco))
    jd, ji = jsc.search_codes(jidx, jnp.asarray(Q), k, interpret=True,
                              lut_dtype=jnp.float32)
    td, ti = tsc.search_codes(tidx, _t(Q), k)
    assert td.shape == (nq, min(k, n))
    assert_tie_rule(jd, ji, td, ti)


def test_lut_oracles_match_jax(rng):
    C, B = gauss_dataset(rng, d=8, n=1000, m=2, h=8, pq=True)
    Q = rng.standard_normal((5, 8)).astype(np.float32)
    T = jsc.build_luts(jnp.asarray(C), jnp.asarray(Q), pq=True, d=8)
    js, _ = jsc.xla_lut_scan(T, jnp.asarray(B), 700)
    ts, _ = tsc.lut_scan(_t(T), _t(B), 700)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    idx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=8)
    s2, i2 = tsc._lut_scan_tiled(idx, _t(Q), 700, 8, torch.float32,
                                 qblock=2, seg=300)
    np.testing.assert_allclose(s2.numpy(), ts.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert all(len(set(r.tolist())) == 700 for r in i2)


def test_unported_routes_raise(rng):
    """The JAX package's routing arguments are all ported: ``qsuper``
    alone keeps the two-pass scan, ``stage`` (and ``twopass=False``)
    take the one-pass scan, and on integer data all serve the default
    search's result (at its tile, so that the keys keep the same score
    bits); a bad combination and a bad mode raise."""
    C, B = int_dataset(rng, d=D, n=300, m=M, h=H, pq=True)
    idx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=D)
    Q = _t(_queries(rng, 2, "int"))
    rd, ri = tsc.search_codes(idx, Q, 5)
    for kw in (dict(qsuper=2), dict(stage=1, tile=8192),
               dict(twopass=False, qsuper=2, tile=8192)):
        d, i = tsc.search_codes(idx, Q, 5, **kw)
        assert torch.equal(d, rd) and torch.equal(i, ri)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsc.search_codes(idx, Q, 5, stage=1, qsuper=2)
    with pytest.raises(ValueError, match="'decode' or 'lut'"):
        tsc.search_codes(idx, Q, 5, mode="tables")
    # the streamed search is ported: it serves the same result
    sd, si = tsc.search_codes_streamed(_t(C), tsc.pack_codes(_t(B)).numpy(),
                                       Q, 5, pq=True, shard_n=128)
    rd, ri = tsc.search_codes(idx, Q, 5)
    assert torch.equal(sd, rd) and sd.shape == (2, 5)
    with pytest.raises(ValueError, match="norms"):
        tsc.build_codes_index(_t(C), _t(B), pq=False)
