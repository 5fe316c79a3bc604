"""Decoded-index scan of `rayuela_tpu_torch` against
`rayuela_tpu.search.scan_pallas` and `rayuela_tpu.search.linscan` on the
CPU: the port's plain version of kernel K8 against the JAX scan run in
interpret mode (``pack=True``, ``tail=False``), and the front ends
around it.

On small-integer data every score is exact in both packages, so results
compare under the tie rule (tests/torch_parity.py) and the flags are
equal. On Gaussian data the two sum in different orders: at least 99% of
the ids agree and every score is within one truncation step (+ the atol
stated per test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.search import linscan as jls
from rayuela_tpu.search import scan_pallas as jsp
from rayuela_tpu_torch import convert
from rayuela_tpu_torch.search import linscan as tls
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


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _base(rng, kind, n, d):
    if kind == "int":
        Xd = rng.integers(-3, 4, (n, d)).astype(np.float32)
    else:
        Xd = rng.standard_normal((n, d)).astype(np.float32)
    return Xd, (Xd * Xd).sum(-1)


def _queries(rng, kind, nq, d):
    if kind == "int":
        return rng.integers(-3, 4, (nq, d)).astype(np.float32)
    return rng.standard_normal((nq, d)).astype(np.float32)


def _assert_same_ids(jd, ji, td, ti, rtol=1e-4, atol=1e-4):
    """Exact scans agree: dists within the tolerance, ids equal except
    where a dist ties with a neighbour's (duplicate base rows)."""
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = np.asarray(td), np.asarray(ti)
    np.testing.assert_allclose(td, jd, rtol=rtol, atol=atol)
    gap = np.abs(np.diff(jd, axis=1)) <= atol + rtol * np.abs(jd[:, 1:])
    tied = np.zeros(jd.shape, bool)
    tied[:, 1:] |= gap
    tied[:, :-1] |= gap
    tied[:, -1] = True               # a tie may straddle position k
    assert ((ji == ti) | tied).all()
    assert (ji == ti).mean() > 0.9


def _jax_scan(Q, Xd, x2, **kw):
    return jsp.pallas_scan_topk(jnp.asarray(Q), jnp.asarray(Xd),
                                jnp.asarray(x2), interpret=True, pack=True,
                                tail=False, **kw)


def _compare(kind, jres, tres, Q, idbits, atol):
    """JAX returns scores with +|q|^2, the port without."""
    (js, ji, jf), (ts, ti, tf) = jres, tres
    ts = ts + (_t(Q) * _t(Q)).sum(-1, keepdim=True)
    if kind == "int":
        assert_tie_rule(js, ji, ts, ti)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    else:
        assert_close_topk(js, ji, ts, ti, idbits, atol=atol)


@pytest.mark.parametrize("pq,norms", [(True, False), (False, False),
                                      (False, True)])
def test_decode_base_matches_jax(rng, pq, norms):
    """`decode_base` == the JAX one to 1e-6 (the two sum the codebook
    rows in the same order; only the |x|^2 reductions differ), in f32
    and rounded to bf16; `build_index` picks f32 on the CPU."""
    d, n, m, h = 28, 3000, 4, 16
    C, B = gauss_dataset(rng, d=d, n=n, m=m, h=h, pq=pq)
    C = 0.25 * C
    nt = rng.random(n).astype(np.float32) if norms else None
    kw = dict(pq=pq, d=d)
    jX, jx2 = jsp.decode_base(jnp.asarray(C), jnp.asarray(B),
                              norm_term=None if nt is None
                              else jnp.asarray(nt), **kw)
    tX, tx2 = tsp.decode_base(_t(C), _t(B), norm_term=None if nt is None
                              else _t(nt), chunk=1000, **kw)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tx2.numpy(), np.asarray(jx2), atol=1e-6,
                               rtol=1e-6)
    jXb, _ = jsp.decode_base(jnp.asarray(C), jnp.asarray(B),
                             dtype=jnp.bfloat16, **kw)
    tXb, _ = tsp.decode_base(_t(C), _t(B), dtype=torch.bfloat16, **kw)
    assert tXb.dtype == torch.bfloat16
    # a value within 1e-6 of a rounding boundary may round the other way
    diff = np.abs(tXb.float().numpy()
                  - np.asarray(jXb.astype(jnp.float32)))
    assert (diff > 0).mean() < 1e-3 and diff.max() <= 2.0 ** -7
    idx = tsp.build_index(_t(C), _t(B), **kw)
    assert idx.Xd.dtype == torch.float32 and idx.x2.dtype == torch.float32
    assert idx.Xd.shape == (n, 32) and (idx.n, idx.d) == (n, d)
    assert not idx.Xd[:, d:].any()
    e = tsp.decode_base(_t(C), _t(B[:0]), **kw)
    assert e[0].shape == (0, d) and e[1].shape == (0,)


@pytest.mark.parametrize("pq,norms", [(True, False), (False, False),
                                      (False, True)])
def test_scan_topk_and_exact_rescan_match_jax(rng, pq, norms):
    """The tiled plain scan and the exact rescan == the JAX ones: ids
    equal (but for exact ties between duplicate rows), dists within 1e-4
    relative (f32 sums in another order), over several tiles with a
    ragged last one, and k > n clamps."""
    d, n, m, h, nq, k = 24, 3100, 4, 32, 16, 30
    C, B = gauss_dataset(rng, d=d, n=n, m=m, h=h, pq=pq)
    Q = _queries(rng, "gauss", nq, d)
    nt = (rng.random(n) * 20).astype(np.float32) if norms else None
    jnt = None if nt is None else jnp.asarray(nt)
    tnt = None if nt is None else _t(nt)
    jd, ji = jls.scan_topk(jnp.asarray(Q), jnp.asarray(C), jnp.asarray(B),
                           k=k, pq=pq, norm_term=jnt, tile=1024)
    td, ti = tls.scan_topk(_t(Q), _t(C), _t(B), k=k, pq=pq, norm_term=tnt,
                           tile=1024)
    _assert_same_ids(jd, ji, td, ti)
    assert ti.dtype == torch.int32
    td0, _ = tls.scan_topk(_t(Q), _t(C), _t(B), k=k, pq=pq, norm_term=tnt,
                           include_q2=False)
    np.testing.assert_allclose(
        (td0 + (_t(Q) ** 2).sum(-1, keepdim=True)).numpy(), td.numpy(),
        rtol=1e-5, atol=1e-4)
    jX, jx2 = jsp.decode_base(jnp.asarray(C), jnp.asarray(B), pq=pq, d=d,
                              norm_term=jnt)
    jd, ji = jls.exact_rescan(jnp.asarray(Q), jX, jx2, k, tile=1024)
    td, ti = tls.exact_rescan(_t(Q), _t(jX), _t(jx2), k, tile=1024)
    _assert_same_ids(jd, ji, td, ti)
    td, ti = tls.exact_rescan(_t(Q), _t(jX)[:50], _t(jx2)[:50], 99)
    assert td.shape == ti.shape == (nq, 50)
    assert all(sorted(r.tolist()) == list(range(50)) for r in ti)


# (keep, premin, r): r + keep (or r + rows_eff at keep=0) is a power of
# two, as the JAX merge network needs
_CONFIGS = [(0, 0, 48), (2, 0, 14), (4, 0, 28), (2, 1, 14), (2, 2, 14)]


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("keep,premin,r", _CONFIGS)
def test_scan_topk_packed_matches_jax(rng, kind, keep, premin, r):
    """K8's plain version + K2 + K3 (`scan_topk_packed`) == JAX
    `pallas_scan_topk(pack=True)`, n ragged against the tile, d not a
    multiple of 8."""
    n, d, nq, k, tile = 5000, 28, 16, 40, 2048
    Xd, x2 = _base(rng, kind, n, d)
    Q = _queries(rng, kind, nq, d)
    jres = _jax_scan(Q, Xd, x2, k=k, r=r, bq=8, tile=tile, keep=keep,
                     premin=premin)
    tres = tsp.scan_topk_packed(_t(Q), _t(Xd), _t(x2), k=k, r=r, tile=tile,
                                keep=keep, premin=premin)
    # |score| terms reach ~60: f32 sums of 28 of them round below 1e-4
    _compare(kind, jres, tres, Q, tsp._pack_idbits(6144), atol=1e-4)
    if kind == "int" and premin == 2:
        assert np.asarray(jres[2]).any()     # the lossy pre-min does flag


@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_one_kernel_stands_for_the_staged_jax_body(rng, kind):
    """The JAX staged body (``stage=8``: the running buffer merges once
    per 8 tiles) gives what the port's one candidates → merge pipeline
    gives for the same ``(tile, keep, premin, r)``."""
    n, d, nq, k = 20_000, 24, 16, 30
    Xd, x2 = _base(rng, kind, n, d)
    Q = _queries(rng, kind, nq, d)
    for premin in (0, 1):
        jres = _jax_scan(Q, Xd, x2, k=k, r=16, bq=8, tile=1024, keep=2,
                         stage=8, premin=premin)
        tres = tsp.scan_topk_packed(_t(Q), _t(Xd), _t(x2), k=k, r=16,
                                    tile=1024, keep=2, premin=premin)
        _compare(kind, jres, tres, Q, tsp._pack_idbits(20_480), atol=1e-4)


def test_per_tile_overflow_and_premin_loss_are_flagged(rng):
    """More than ``keep`` of a query's top-k in one (lane, tile), and
    two of them in one pre-min window (tests/test_scan_pallas.py:270 and
    :336): both packages flag the query."""
    nq, n, d = 3, 8192, 16
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    Xd = rng.standard_normal((n, d)).astype(np.float32) + 100.0
    for t in range(4):
        Xd[t * 128 + 64] = Q[0] + 1e-3 * rng.standard_normal(d)
    x2 = (Xd * Xd).sum(-1)
    kw = dict(k=8, r=14, tile=1024, keep=2)
    jf = _jax_scan(Q, Xd, x2, bq=4, **kw)[2]
    tf = tsp.scan_topk_packed(_t(Q), _t(Xd), _t(x2), **kw)[2]
    assert bool(tf[0]) and bool(np.asarray(jf)[0])
    Xd = rng.standard_normal((4096, d)).astype(np.float32) + 50.0
    Xd[5], Xd[133] = Q[0] + 1e-3, Q[0] - 1e-3      # lane 5, rows 0 and 1
    x2 = (Xd * Xd).sum(-1)
    jf = _jax_scan(Q[:2], Xd, x2, bq=2, premin=1, **kw)[2]
    tf = tsp.scan_topk_packed(_t(Q[:2]), _t(Xd), _t(x2), premin=1, **kw)[2]
    assert bool(tf[0]) and bool(np.asarray(jf)[0])
    tf = tsp.scan_topk_packed(_t(Q[:2]), _t(Xd), _t(x2), premin=0, **kw)[2]
    assert not bool(tf[0])


def test_scan_topk_packed_argument_checks(rng):
    Xd, x2 = _base(rng, "gauss", 600, 8)
    Q, X, x = _t(_queries(rng, "gauss", 2, 8)), _t(Xd), _t(x2)
    with pytest.raises(ValueError, match="r\\*128"):
        tsp.scan_topk_packed(Q, X, x, k=5000, r=16)
    with pytest.raises(ValueError, match="power of two"):
        tsp.scan_topk_packed(Q, X, x, k=5, r=16, tile=384)
    with pytest.raises(ValueError, match="power of two"):
        tsp.scan_topk_packed(Q, X, x, k=5, r=16, tile=1024, keep=3)
    with pytest.raises(ValueError, match="premin=3"):
        tsp.scan_topk_packed(Q, X, x, k=5, r=16, tile=1024, keep=2, premin=3)
    with pytest.raises(ValueError, match="segment"):
        tsp.scan_topk_packed(Q, torch.zeros(tsp._SEG_DECODED + 1, 0), x,
                             k=5, r=16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tsp.scan_candidates(Q.double(), X.double(), x, tile=1024, keep=2,
                            premin=0, idbits=3)
    with pytest.raises(ValueError, match="keep=9"):
        tsp.scan_candidates(Q, X, x, tile=1024, keep=9, premin=0, idbits=3)


@pytest.mark.parametrize("k,plan", [(300, (16, 2, 8192)),
                                    (700, (32, 4, 8192)),
                                    (2500, (48, 4, 8192)),
                                    (3500, (96, 4, 2048))])
def test_search_plan_classes_are_exact(rng, k, plan):
    """Every class of the plan (`_scan_config`), the deepest buffer and
    its smaller tile included, serves the exact top-k: `search` against
    `exact_rescan`. The kernels' scores are truncated to the key's step
    (2**-16 of a raw score of at most ~100 here: atol 2e-3) and the
    rescan's are not, which can swap neighbours around position k."""
    assert tsp._scan_config(k) == plan
    n, d, nq = 9000, 24, 6
    Xd, x2 = _base(rng, "gauss", n, d)
    Q = _queries(rng, "gauss", nq, d)
    idx = tsp.LinscanIndex(_t(Xd), _t(x2))
    dv, di = tsp.search(idx, _t(Q), k)
    ref = tls.exact_rescan(_t(Q), _t(Xd), _t(x2), k)
    assert_close_topk(ref[0], ref[1], dv, di, tsp._pack_idbits(
        -(-n // plan[2]) * plan[2]), atol=2e-3)


def test_search_clamps_k_and_leaves_the_kernel_plan_beyond_its_depth(rng):
    """k > n clamps to n (every row once); beyond the deepest buffer the
    search is the exact rescan alone, as in the JAX package."""
    d, m, h, n = 16, 4, 16, 400
    C, B = gauss_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    Q = _queries(rng, "gauss", 3, d)
    idx = tsp.build_index(_t(C), _t(B), pq=True, d=d)
    dv, di = tsp.search(idx, _t(Q), n + 99)
    assert dv.shape == di.shape == (3, n)
    assert all(sorted(r.tolist()) == list(range(n)) for r in di)
    assert torch.isfinite(dv).all()
    jidx = jsp.build_index(jnp.asarray(C), jnp.asarray(B), pq=True, d=d)
    jd, _ = jsp.search(jidx, jnp.asarray(Q), n + 99, interpret=True)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jd), rtol=1e-3,
                               atol=1e-3)
    n = tsp._MAX_K + 500
    Xd, x2 = _base(rng, "gauss", n, 8)
    big = tsp.LinscanIndex(_t(Xd), _t(x2))
    before = tsp.scan_candidates.launches
    dv, di = tsp.search(big, _t(_queries(rng, "gauss", 2, 8)), n)
    assert dv.shape == (2, n) and bool((dv[:, 1:] >= dv[:, :-1]).all())
    assert tsp.scan_candidates.launches == before


def test_segmented_decoded_search(rng, monkeypatch):
    """A base beyond the row-id range (here: a shrunk `_SEG_DECODED`)
    runs per segment with an exact merge: the result agrees with the
    one-call search to one truncation step (the segments' keys keep more
    score bits)."""
    n, d, nq, k = 10_000, 24, 12, 20
    Xd, x2 = _base(rng, "gauss", n, d)
    Q = _queries(rng, "gauss", nq, d)
    idx = tsp.LinscanIndex(_t(Xd), _t(x2))
    d0, i0 = tsp.search(idx, _t(Q), k, tile=1024)
    monkeypatch.setattr(tsp, "_SEG_DECODED", 4096)
    d1, i1 = tsp.search(idx, _t(Q), k, tile=1024)
    assert_close_topk(d0, i0, d1, i1, tsp._pack_idbits(10_240), atol=1e-4)
    ref = tls.exact_rescan(_t(Q), _t(Xd), _t(x2), k)
    assert_close_topk(ref[0], ref[1], d1, i1, tsp._pack_idbits(4096),
                      atol=1e-4)


@pytest.mark.parametrize("mode", ["decoded", "decode", "lut"])
def test_query_batch_runs_in_chunks_with_the_same_result(rng, monkeypatch,
                                                         mode):
    """A batch whose candidate array would pass the cap is searched in
    chunks: 300 queries in 3 chunks equal the one-shot result, in the
    decoded scan and in both modes of the codes scan."""
    n, d, nq, k = 5000, 24, 300, 12
    C, B = gauss_dataset(rng, d=d, n=n, m=3, h=16, pq=True)
    Q = _t(_queries(rng, "gauss", nq, d))
    if mode == "decoded":
        idx = tsp.build_index(_t(C), _t(B), pq=True, d=d)
        run = lambda: tsp.search(idx, Q, k)
    else:
        idx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=d)
        run = lambda: tsc.search_codes(idx, Q, k, mode=mode)
    one = run()
    per_query = 1 * 2 * 128 * 4           # one tile, keep=2, int32
    assert tsp._query_chunks(nq, per_query) == [(0, nq)]
    monkeypatch.setattr(tsp, "_CAND_CAP", 100 * per_query)
    assert tsp._query_chunks(nq, per_query) == [(0, 100), (100, 200),
                                                (200, 300)]
    calls = []
    real = tsp.cand_merge
    monkeypatch.setattr(tsp, "cand_merge", lambda *a, **kw: calls.append(1)
                        or real(*a, **kw))
    monkeypatch.setattr(tsc, "cand_merge", tsp.cand_merge)
    chunked = run()
    assert len(calls) == 3
    assert torch.equal(one[0], chunked[0]) and torch.equal(one[1],
                                                           chunked[1])


def _front_end(name, rng, n=3000, d=24, m=4, h=32, nq=16):
    """Arguments of one `linscan_*` front end, as numpy arrays."""
    pq = name in ("pq", "opq")
    C, B = gauss_dataset(rng, d=d, n=n, m=m, h=h, pq=pq)
    Q = _queries(rng, "gauss", nq, d)
    R = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    if name == "pq":
        return (C, Q, B), {}
    if name == "opq":
        return (C, Q, B, R), {}
    if name == "cq":
        return (C, Q, B), {}
    ncb = (rng.random(16) * 30).astype(np.float32)
    nco = rng.integers(0, 16, n).astype(np.int32)
    return (C, Q, B, ncb, nco), {"R": R}


@pytest.mark.parametrize("backend", ["auto", "kernel"])
@pytest.mark.parametrize("name", ["pq", "opq", "lsq", "cq"])
def test_linscan_front_ends_match_jax(rng, name, backend):
    """`linscan_pq/opq/lsq/cq` == the JAX front ends (their tiled XLA
    scan): through the tiled plain scan (what ``auto`` picks for CPU
    tensors) the ids are equal and the dists within 1e-4 relative;
    through the decoded index and the plain version of K8 the scores are
    truncated keys, so at least 99% of ids agree and the dists are within
    one truncation step."""
    args, kw = _front_end(name, rng)
    k = 25
    jd, ji = getattr(jls, f"linscan_{name}")(
        *[jnp.asarray(a) for a in args], k=k,
        **{n_: jnp.asarray(v) for n_, v in kw.items()})
    before = tsp.scan_candidates.launches
    td, ti = getattr(tls, f"linscan_{name}")(
        *[_t(a) for a in args], k=k, backend=backend,
        **{n_: _t(v) for n_, v in kw.items()})
    assert td.shape == ti.shape == (16, k) and ti.dtype == torch.int32
    assert tsp.scan_candidates.launches == before
    if backend == "auto":
        _assert_same_ids(jd, ji, td, ti, atol=1e-3)
    else:
        assert_close_topk(jd, ji, td, ti, tsp._pack_idbits(8192),
                          atol=1e-3)


def test_route_obeys_an_explicit_backend_and_takes_numpy_on_request(rng):
    (C, Q, B), _ = _front_end("pq", rng)
    with pytest.raises(ValueError, match="backend 'pallas'"):
        tls.linscan_pq(_t(C), _t(Q), _t(B), k=5, backend="pallas")
    # numpy inputs go where the caller says; tensors stay where they are
    d1, i1 = tls.linscan_pq(C, Q, B, k=5, device="cpu")
    d2, i2 = tls.linscan_pq(_t(C), _t(Q), _t(B), k=5)
    assert torch.equal(i1, i2) and d1.device.type == "cpu"


def test_decoded_index_carried_across_serves_identically(rng):
    """A JAX `LinscanIndex`'s arrays, carried across with
    `convert.decoded_index_from_arrays`, give the JAX packed scan's
    top-k from the port's `search` (tie rule, integer data), with flagged
    queries repaired by the exact rescan in both."""
    n, d, m, h, nq, k = 6000, 24, 3, 16, 32, 20
    C, B = int_dataset(rng, d=d, n=n, m=m, h=h, pq=False)
    Q = _queries(rng, "int", nq, d)
    nt = rng.integers(0, 200, n).astype(np.float32)
    jidx = jsp.build_index(jnp.asarray(C), jnp.asarray(B), d=d,
                           norm_term=jnp.asarray(nt))
    tidx = convert.decoded_index_from_arrays(
        np.asarray(jidx.Xd), np.asarray(jidx.x2), device="cpu")
    own = tsp.build_index(_t(C), _t(B), d=d, norm_term=_t(nt))
    assert torch.equal(own.Xd, tidx.Xd) and torch.equal(own.x2, tidx.x2)
    kw = dict(r=14, tile=1024, keep=2)
    js, ji, jf = _jax_scan(Q, jidx.Xd, jidx.x2, k=k, bq=8, **kw)
    ts, ti, tf = tsp.scan_topk_packed(_t(Q), tidx.Xd, tidx.x2, k=k, **kw)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    jd, ji = jsp.search(jidx, jnp.asarray(Q), k, interpret=True, pack=True,
                        bq=8, **kw)
    td, ti = tsp.search(tidx, _t(Q), k, **kw)
    ok = ~np.asarray(jf)                 # unflagged: truncated keys, ties
    assert_tie_rule(np.asarray(jd)[ok], np.asarray(ji)[ok],
                    td.numpy()[ok], ti.numpy()[ok])
    # flagged: the exact rescan's untruncated scores, equal in both
    np.testing.assert_array_equal(td.numpy()[~ok], np.asarray(jd)[~ok])
