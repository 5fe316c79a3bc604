"""The exact-float (``pack=False``) scans of `rayuela_tpu_torch` against
`rayuela_tpu` on the CPU: the plain versions of kernels K9/K10 (decoded
base) and K6/K7 (LUT scan) against the JAX kernels run in interpret
mode, the searches around them, and the tie order of the exact scans.

Tolerances. On small-integer data every score is exact in both
packages: scores compare exactly, flags are equal. On Gaussian data the
two sum in different orders: scores within 1e-5 relative + 5e-5 (a
distance near zero is the f32 sum of terms that reach ~30, |q|^2 and the
norm term among them, and rounds at their size). The JAX f32 kernels
order equal scores arbitrarily and the port takes the lowest id, so
against JAX ids compare as sets within groups of equal score
(`_assert_f32_tie_rule`); against the port's own exact scans, and for
the exact scans against JAX (whose `lax.top_k` also takes the lowest
id), everything compares by position.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.search import linscan as jls
from rayuela_tpu.search import scan_codes_pallas as jsc
from rayuela_tpu.search import scan_pallas as jsp
from rayuela_tpu_torch import api as tapi
from rayuela_tpu_torch import convert
from rayuela_tpu_torch.search import linscan as tls
from rayuela_tpu_torch.search import scan as tsp
from rayuela_tpu_torch.search import scan_codes as tsc
from rayuela_tpu_torch.utils import topk_lowest_id
from tests.torch_parity import gauss_dataset, int_dataset

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    the data depend on the tests that ran before)."""
    return np.random.default_rng(0)


@pytest.fixture(params=[1, 4])
def threads(request):
    """`torch.topk`'s choice among equal scores moves with the thread
    count; the exact scans must not."""
    before = torch.get_num_threads()
    torch.set_num_threads(request.param)
    yield request.param
    torch.set_num_threads(before)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _base(rng, kind, n, d):
    if kind == "int":
        Xd = rng.integers(-2, 3, (n, d)).astype(np.float32)
    else:
        Xd = rng.standard_normal((n, d)).astype(np.float32)
    return Xd, (Xd * Xd).sum(-1)


def _queries(rng, kind, nq, d):
    if kind == "int":
        return rng.integers(-2, 3, (nq, d)).astype(np.float32)
    return rng.standard_normal((nq, d)).astype(np.float32)


def _assert_f32_tie_rule(va, ia, vb, ib, exact):
    """Two top-k results of the same f32 scores: the scores agree
    (exactly, or to 1e-5 relative + 5e-5), and the ids agree as sets
    within every group of equal score but the one that may straddle
    position k; no id twice."""
    va, vb = np.asarray(va), np.asarray(vb)
    ia, ib = np.asarray(ia), np.asarray(ib)
    assert va.shape == vb.shape == ia.shape == ib.shape
    if exact:
        np.testing.assert_array_equal(va, vb)
    else:
        np.testing.assert_allclose(va, vb, rtol=1e-5, atol=5e-5)
    for q in range(va.shape[0]):
        assert len(set(ib[q].tolist())) == ib.shape[1]
        if exact:
            inner = va[q] != va[q, -1]
            assert sorted(ia[q, inner]) == sorted(ib[q, inner]), q
    if not exact:
        assert (ia == ib).mean() > 0.99


# ---------------------------------------------------------------------------
# The tie order of the exact scans
# ---------------------------------------------------------------------------

def test_topk_lowest_id_on_ties(threads):
    """Few distinct scores over many columns: ascending scores, the
    lowest ids within equal scores, also in the group that straddles
    position k; with explicit ids the ids decide, not the columns."""
    g = torch.Generator().manual_seed(0)
    s = torch.randint(0, 4, (37, 5000), generator=g).float()
    for k in (1, 7, 1500, 5000):
        v, i = topk_lowest_id(s, k)
        key = s.long() * 5000 + torch.arange(5000)
        ref = key.sort(1).values[:, :k]
        assert torch.equal(i, ref % 5000) and torch.equal(v.long(),
                                                          ref // 5000)
    ids = torch.stack([torch.randperm(5000, generator=g) for _ in range(37)])
    v, i = topk_lowest_id(s, 900, ids)
    ref = (s.long() * 5000 + ids).sort(1).values[:, :900]
    assert torch.equal(i, ref % 5000) and torch.equal(v.long(), ref // 5000)


def test_exact_scans_order_ties_like_jax_by_position(rng, threads):
    """Integer data with many exact ties: `exact_rescan`, `scan_topk` and
    `lut_scan` give the JAX functions' dists and ids at every position
    (ascending score, then the lowest id), whatever the thread count,
    over several tiles with a ragged last one."""
    d, n, m, h, nq, k = 8, 5000, 2, 4, 9, 300
    C, B = int_dataset(rng, d=d, n=n, m=m, h=h, pq=False)
    C = np.sign(C)
    Q = np.sign(_queries(rng, "int", nq, d))
    Xd = (C[0][B[:, 0]] + C[1][B[:, 1]]).astype(np.float32)
    x2 = (Xd * Xd).sum(-1)
    # at most h**m = 16 distinct rows: every score ties hundreds of times
    jd, ji = jls.exact_rescan(jnp.asarray(Q), jnp.asarray(Xd),
                              jnp.asarray(x2), k, tile=1024)
    td, ti = tls.exact_rescan(_t(Q), _t(Xd), _t(x2), k, tile=1024)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jd, ji = jls.scan_topk(jnp.asarray(Q), jnp.asarray(C), jnp.asarray(B),
                           k=k, tile=1024)
    td, ti = tls.scan_topk(_t(Q), _t(C), _t(B), k=k, tile=1024)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    T = jsc.build_luts(jnp.asarray(C), jnp.asarray(Q))
    js, ji = jsc.xla_lut_scan(T, jnp.asarray(B), k)
    ts, ti = tsc.lut_scan(_t(T), _t(B), k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_tiled_oracle_and_segment_merges_keep_the_lowest_id(rng, threads,
                                                            monkeypatch):
    """`_lut_scan_tiled` (segments of 1500 rows, query blocks of 4) and
    the segmented searches merge by (score, id): the tiled oracle equals
    the one-call `lut_scan` by position on tie-heavy integer data, and
    `merge_topk` keeps the lower id among equal scores of two lists."""
    d, n, m, h, nq, k = 8, 5000, 2, 4, 9, 300
    C, B = int_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    Q = _t(np.sign(_queries(rng, "int", nq, d)))
    idx = tsc.build_codes_index(_t(np.sign(C)), _t(B), pq=True, d=d)
    s0, i0 = tsc.lut_scan(tsc.build_luts(idx.C, Q, pq=True, d=d), _t(B), k)
    s1, i1 = tsc._lut_scan_tiled(idx, Q, k, d, torch.float32, qblock=4,
                                 seg=1500)
    assert torch.equal(s0, s1) and torch.equal(i0, i1)
    a = (torch.tensor([[1., 2., 2.]]), torch.tensor([[9, 4, 7]],
                                                    dtype=torch.int32))
    b = (torch.tensor([[2., 2., 3.]]), torch.tensor([[3, 5, 1]],
                                                    dtype=torch.int32))
    v, i = tsp.merge_topk(a, b, 4)
    assert v.tolist() == [[1., 2., 2., 2.]] and i.tolist() == [[9, 3, 4, 5]]


# ---------------------------------------------------------------------------
# K9 / K10: the decoded base
# ---------------------------------------------------------------------------

def _jax_scan(Q, Xd, x2, **kw):
    return jsp.pallas_scan_topk(jnp.asarray(Q), jnp.asarray(Xd),
                                jnp.asarray(x2), interpret=True, pack=False,
                                bq=8, **kw)


# r + tile/128 is a power of two, as the JAX merge network needs
_F32_CONFIGS = [(16, 2048), (48, 2048), (32, 4096)]


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("r,tile", _F32_CONFIGS)
def test_scan_topk_f32_matches_jax(rng, kind, r, tile):
    """`scan_topk_f32` (K9's and K10's plain versions, keep=0: the JAX
    form) == JAX `pallas_scan_topk(pack=False)`: n ragged against the
    tile, d not a multiple of 8, nq not a multiple of the query block."""
    n, d, nq, k = 5000, 28, 13, 40
    Xd, x2 = _base(rng, kind, n, d)
    Q = _queries(rng, kind, nq, d)
    jd, ji, jf = _jax_scan(Q, Xd, x2, k=k, r=r, tile=tile)
    ts, ti, tf = tsp.scan_topk_f32(_t(Q), _t(Xd), _t(x2), k=k, r=r,
                                   tile=tile, keep=0)
    td = ts + (_t(Q) ** 2).sum(-1, keepdim=True)   # JAX adds |q|^2
    _assert_f32_tie_rule(jd, ji, td, ti, exact=kind == "int")
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert ti.dtype == torch.int32 and not tf.any()
    # unflagged: the exact top-k by (score, id), position by position
    ed, ei = tls.exact_rescan(_t(Q), _t(Xd), _t(x2), k)
    if kind == "int":
        assert torch.equal(ei, ti) and torch.equal(ed, td)


@pytest.mark.parametrize("keep", [0, 2])
def test_lane_overflow_is_flagged_as_in_jax(rng, keep):
    """More than r of a query's top-k in one lane (rows planted at gids
    = 5 mod 128): both packages flag that query and no other; `search`
    repairs it to the exact scan's result."""
    n, d, nq, k, r = 6000, 16, 5, 40, 16
    Xd = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    for j in range(20):      # well apart: no near-ties for f32 rounding
        Xd[5 + 128 * 2 * j] = Q[0] + 0.05 * rng.standard_normal(d)
    x2 = (Xd * Xd).sum(-1)
    jf = np.asarray(_jax_scan(Q, Xd, x2, k=k, r=r, tile=2048)[2])
    tf = tsp.scan_topk_f32(_t(Q), _t(Xd), _t(x2), k=k, r=r, tile=2048,
                           keep=keep)[2].numpy()
    assert jf.tolist() == [True] + [False] * (nq - 1)
    np.testing.assert_array_equal(tf, jf)
    idx = tsp.LinscanIndex(_t(Xd), _t(x2))
    sd, si = tsp.search(idx, _t(Q), k, pack=False, r=r, tile=2048, keep=keep)
    ed, ei = tls.exact_rescan(_t(Q), idx.Xd, idx.x2, k)
    assert torch.equal(si, ei)
    np.testing.assert_allclose(sd.numpy(), ed.numpy(), rtol=1e-5, atol=1e-5)


def test_per_tile_overflow_is_flagged_with_keep(rng):
    """Three of a query's top-k in one (lane, tile): no lane holds more
    than r, so the JAX form (keep=0) does not flag; with keep=2 the
    tile's cut loses one, and row 1 of the counts (the largest per-tile
    count) flags it."""
    n, d, nq, k = 6000, 16, 4, 10
    Xd = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    for j in range(3):
        Xd[7 + 128 * j] = Q[1] + 0.05 * rng.standard_normal(d)
    x2 = (Xd * Xd).sum(-1)
    kw = dict(k=k, r=16, tile=2048)
    assert not np.asarray(_jax_scan(Q, Xd, x2, **kw)[2]).any()
    assert not tsp.scan_topk_f32(_t(Q), _t(Xd), _t(x2), keep=0, **kw)[2].any()
    tf = tsp.scan_topk_f32(_t(Q), _t(Xd), _t(x2), keep=2, **kw)[2]
    assert tf.tolist() == [False, True, False, False]


def test_ties_at_the_kth_score_do_not_flag(rng):
    """Forty copies of one row, the best match of query 0, at
    consecutive gids, and k inside that group: nothing is strictly
    before the boundary in more than r rows of a lane, so neither
    package flags, and the port returns the group's lowest ids."""
    n, d, nq, k = 5000, 16, 3, 25
    Xd, _ = _base(rng, "int", n, d)
    Q = _queries(rng, "int", nq, d)
    Xd[1000:1040] = Q[0]
    x2 = (Xd * Xd).sum(-1)
    jd, ji, jf = _jax_scan(Q, Xd, x2, k=k, r=16, tile=2048)
    ts, ti, tf = tsp.scan_topk_f32(_t(Q), _t(Xd), _t(x2), k=k, r=16,
                                   tile=2048, keep=0)
    assert not np.asarray(jf).any() and not tf.any()
    np.testing.assert_array_equal(
        (ts + (_t(Q) ** 2).sum(-1, keepdim=True)).numpy(), np.asarray(jd))
    assert ti[0].tolist() == list(range(1000, 1000 + k))
    assert set(np.asarray(ji)[0].tolist()) <= set(range(1000, 1040))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_counts_against_numpy(rng, dtype):
    """K10's plain version: the (2, 128, nq) counts equal a numpy count
    of the rows before each query's boundary pair in the order (score,
    gid), per lane over all rows and the largest per tile; a boundary of
    -inf counts nothing. Integer data: exact in f32 and bf16."""
    n, d, nq, tile = 3000, 24, 7, 1024
    Xd, x2 = _base(rng, "int", n, d)
    Q = _queries(rng, "int", nq, d)
    Qm = tsp._query_operand(_t(Q), d, dtype)
    S = (Xd @ (-2.0 * Q).T + x2[:, None]).astype(np.float32)    # (n, nq)
    taus = np.sort(S, axis=0)[150].astype(np.float32)
    taui = rng.integers(0, n, nq).astype(np.int32)
    taus[3] = -np.inf
    cnt = tsp.verify_counts(Qm, _t(Xd).to(dtype), _t(x2), _t(taus), _t(taui),
                            tile=tile).numpy()
    gid = np.arange(n)[:, None]
    below = (S < taus) | ((S == taus) & (gid < taui))
    npad = -(-n // tile) * tile
    bp = np.zeros((npad, nq), bool)
    bp[:n] = below
    per_tile = bp.reshape(npad // tile, tile // 128, 128, nq).sum(1)
    np.testing.assert_array_equal(cnt[0], per_tile.sum(0))
    np.testing.assert_array_equal(cnt[1], per_tile.max(0))
    assert cnt.shape == (2, 128, nq) and cnt.dtype == np.int32
    assert cnt[0].sum() > 0 and not cnt[:, :, 3].any()


@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_f32_candidates_then_merge_is_the_one_pass_buffer(rng, kind):
    """K9's two passes on the card, in their plain versions: with keep =
    tile/128 (no cut) `scan_f32_candidates` → `pair_merge` gives the
    one-pass buffers of the JAX form exactly; with keep=2 every pair it
    keeps is one of the tile's two smallest of its lane. Empty slots
    carry (+inf, NOID)."""
    n, d, nq, tile, r = 3000, 24, 5, 1024, 16
    Xd, x2 = _base(rng, kind, n, d)
    Qm = tsp._query_operand(_t(_queries(rng, kind, nq, d)), d, torch.float32)
    args = (Qm, _t(Xd), _t(x2))
    ov, oi = tsp.scan_f32_topk(*args, r=r, tile=tile, keep=0)
    cv, ci = tsp.scan_f32_candidates(*args, tile=tile, keep=8)
    assert cv.shape == ci.shape == (3 * 8, 128, nq)
    mv, mi = tsp.pair_merge(cv, ci, r)
    assert torch.equal(mv, ov) and torch.equal(mi, oi)
    assert bool((oi[torch.isinf(ov)] == tsp.NOID).all())
    assert bool(((oi % 128 == torch.arange(128)[None, :, None])
                 | torch.isinf(ov)).all())
    assert bool((ov[1:] >= ov[:-1]).all())
    c2v, c2i = tsp.scan_f32_candidates(*args, tile=tile, keep=2)
    for t in range(3):
        assert torch.equal(c2v[2 * t:2 * t + 2], cv[8 * t:8 * t + 2])
        assert torch.equal(c2i[2 * t:2 * t + 2], ci[8 * t:8 * t + 2])
    # fewer candidates than r: the buffer pads with empty slots
    pv, pi = tsp.pair_merge(c2v, c2i, r)
    assert bool(torch.isinf(pv[6:]).all()) and bool((pi[6:] == tsp.NOID)
                                                    .all())


def test_scan_topk_f32_argument_checks(rng):
    Xd, x2 = _base(rng, "gauss", 600, 8)
    Q, X, x = _t(_queries(rng, "gauss", 2, 8)), _t(Xd), _t(x2)
    with pytest.raises(ValueError, match="r\\*128"):
        tsp.scan_topk_f32(Q, X, x, k=5000, r=16)
    with pytest.raises(ValueError, match="power of two"):
        tsp.scan_topk_f32(Q, X, x, k=5, r=16, tile=384)
    with pytest.raises(ValueError, match="power of two"):
        tsp.scan_topk_f32(Q, X, x, k=5, r=16, tile=1024, keep=3)
    with pytest.raises(ValueError, match="<= 256"):
        tsp.scan_topk_f32(Q, X, x, k=5, r=16, tile=1 << 16)
    Qm = tsp._query_operand(Q, 8, torch.float32)
    with pytest.raises(ValueError, match="keep=0"):
        tsp.scan_f32_candidates(Qm, X, x, tile=1024, keep=0)
    with pytest.raises(ValueError, match="taus"):
        tsp.verify_counts(Qm, X, x, torch.zeros(3), torch.zeros(
            2, dtype=torch.int32), tile=1024)
    with pytest.raises(ValueError, match="candv"):
        tsp.pair_merge(torch.zeros(2, 128, 2), torch.zeros(2, 128, 2), 16)


# ---------------------------------------------------------------------------
# K6 / K7: the LUT scan
# ---------------------------------------------------------------------------

def _lut_case(rng, kind, pq, norms, n=5000, d=24, m=4, h=32):
    mk = int_dataset if kind == "int" else gauss_dataset
    C, B = mk(rng, d=d, n=n, m=m, h=h, pq=pq)
    ncb = nco = None
    if norms:
        ncb = (rng.integers(0, 60, h) if kind == "int"
               else rng.random(h) * 30).astype(np.float32)
        nco = rng.integers(0, h, n).astype(np.int32)
    return C, B, ncb, nco


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("pq,norms", [(True, False), (False, True),
                                      (False, False)])
def test_scan_codes_topk_f32_matches_jax(rng, kind, pq, norms):
    """`scan_codes_topk(pack=False)` (K6's and K7's plain versions,
    keep=0) == JAX `pallas_scan_codes_topk(pack=False)` with f32 tables:
    the PQ layout, the additive layout with the norms byte (m' = 5) and
    without it, n ragged against the tile. And it equals the LUT oracle
    position by position: the same f32 sums in the same order."""
    n, d, nq, k, r, tile = 5000, 24, 11, 40, 16, 2048
    C, B, ncb, nco = _lut_case(rng, kind, pq, norms, n=n, d=d)
    Q = _queries(rng, kind, nq, d)
    T = np.asarray(jsc.build_luts(
        jnp.asarray(C), jnp.asarray(Q), pq=pq, d=d,
        norms_cbook=None if ncb is None else jnp.asarray(ncb)))
    jpk = jsc.pack_codes(jnp.asarray(B),
                         None if nco is None else jnp.asarray(nco))
    tpk = tsc.pack_codes(_t(B), None if nco is None else _t(nco))
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    js, ji, jf = jsc.pallas_scan_codes_topk(
        jnp.asarray(T), jpk, k=k, r=r, bq=8, tile=tile, interpret=True,
        lut_dtype=jnp.float32, pack=False)
    ts, ti, tf = tsc.scan_codes_topk(_t(T), tpk, k=k, r=r, tile=tile, keep=0,
                                     lut_dtype=torch.float32, pack=False)
    _assert_f32_tie_rule(js, ji, ts, ti, exact=kind == "int")
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert not tf.any()
    Bn = B if nco is None else np.concatenate([B, nco[:, None]], 1)
    os_, oi = tsc.lut_scan(_t(T), _t(Bn), k)
    assert torch.equal(oi, ti) and torch.equal(os_, ts)


def test_lut_lane_overflow_is_flagged_and_repaired(rng):
    """Twenty rows with the best code of query 0 in one lane: K7's
    counts flag the query in both packages (r = 16), the LUT oracle
    repairs it, and the search equals the oracle by position."""
    n, d, m, h, nq, k = 6000, 24, 4, 32, 4, 40
    C, B = int_dataset(rng, d=d, n=n, m=m, h=h, pq=True)
    best = rng.integers(0, h, m).astype(np.int32)
    for j in range(20):
        B[9 + 256 * j] = best
    from rayuela_tpu_torch.ops.qerror import reconstruct_pq
    Q = np.concatenate([reconstruct_pq(_t(C), _t(B[9:10]), d).numpy(),
                        _queries(rng, "int", nq - 1, d)])
    T = jsc.build_luts(jnp.asarray(C), jnp.asarray(Q), pq=True, d=d)
    jpk = jsc.pack_codes(jnp.asarray(B))
    jf = jsc.pallas_scan_codes_topk(T, jpk, k=k, r=16, bq=4, tile=2048,
                                    interpret=True, lut_dtype=jnp.float32,
                                    pack=False)[2]
    idx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=d)
    for keep in (0, 2):
        tf = tsc.scan_codes_topk(_t(np.asarray(T)), idx.packed, k=k, r=16,
                                 tile=2048, keep=keep,
                                 lut_dtype=torch.float32, pack=False)[2]
        assert bool(tf[0]) and bool(np.asarray(jf)[0])
        if not keep:
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    sd, si = tsc.search_codes(idx, _t(Q), k, mode="lut", pack=False)
    os_, oi = tsc.lut_scan(_t(np.asarray(T)), _t(B), k)
    assert torch.equal(si, oi)
    assert torch.equal(sd, os_ + (_t(Q) ** 2).sum(-1, keepdim=True))


def test_codes_verify_counts_against_the_oracle_scores(rng):
    """K7's plain version: the counts equal a numpy count on the LUT
    oracle's score matrix (additive layout with the norms byte)."""
    n, d, nq, tile = 3000, 24, 6, 1024
    C, B, ncb, nco = _lut_case(rng, "int", False, True, n=n, d=d)
    Q = _t(_queries(rng, "int", nq, d))
    T = tsc.build_luts(_t(C), Q, norms_cbook=_t(ncb))
    Bn = np.concatenate([B, nco[:, None]], 1)
    S = tsc.lut_scan(T, _t(Bn), n)
    full = torch.empty(nq, n).scatter_(1, S[1].long(), S[0]).T.numpy()
    taus = np.sort(full, axis=0)[100].astype(np.float32)
    taui = rng.integers(0, n, nq).astype(np.int32)
    cnt = tsc.codes_verify_counts(T.contiguous(), tsc.pack_codes(
        _t(B), _t(nco)), _t(taus), _t(taui), tile=tile).numpy()
    below = (full < taus) | ((full == taus)
                             & (np.arange(n)[:, None] < taui))
    bp = np.zeros((3072, nq), bool)
    bp[:n] = below
    per_tile = bp.reshape(3, 8, 128, nq).sum(1)
    np.testing.assert_array_equal(cnt[0], per_tile.sum(0))
    np.testing.assert_array_equal(cnt[1], per_tile.max(0))


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,k", [("int", 40), ("gauss", 40),
                                    ("gauss", 700)])
def test_search_pack_false_matches_jax_and_the_exact_scan(rng, kind, k):
    """`search(index, Q, k, pack=False)` == JAX `search(pack=False,
    interpret=True)` on the same f32 index (carried across with
    `convert.decoded_index_from_arrays`), in both k classes of the f32
    plan, and == `exact_rescan` position by position."""
    n, d, m, h, nq = 6000, 24, 3, 16, 9
    mk = int_dataset if kind == "int" else gauss_dataset
    C, B = mk(rng, d=d, n=n, m=m, h=h, pq=False)
    Q = _queries(rng, kind, nq, d)
    nt = (rng.integers(0, 200, n) if kind == "int"
          else rng.random(n) * 20).astype(np.float32)
    jidx = jsp.build_index(jnp.asarray(C), jnp.asarray(B), d=d,
                           norm_term=jnp.asarray(nt))
    assert jidx.Xd.dtype == jnp.float32
    tidx = convert.decoded_index_from_arrays(
        np.asarray(jidx.Xd), np.asarray(jidx.x2), device="cpu")
    assert tidx.Xd.dtype == torch.float32
    np.testing.assert_array_equal(tidx.Xd.numpy(), np.asarray(jidx.Xd))
    assert tsp._f32_config(k, "cpu")[:3] == (16 if k <= 512 else 48, 0, 2048)
    jd, ji = jsp.search(jidx, jnp.asarray(Q), k, pack=False, interpret=True,
                        bq=8)
    td, ti = tsp.search(tidx, _t(Q), k, pack=False)
    _assert_f32_tie_rule(jd, ji, td, ti, exact=kind == "int")
    ed, ei = tls.exact_rescan(_t(Q), tidx.Xd, tidx.x2, k)
    if kind == "int":
        assert torch.equal(ti, ei) and torch.equal(td, ed)
    else:
        # the scan adds x2 to the dot and then |q|^2, the rescan starts
        # from |q|^2: f32 rounding, 1e-5 relative
        np.testing.assert_allclose(td.numpy(), ed.numpy(), rtol=1e-5,
                                   atol=5e-5)
        assert (ti == ei).float().mean() > 0.999
    # pack unset or True: the packed scan, as before
    p0, p1 = tsp.search(tidx, _t(Q), k), tsp.search(tidx, _t(Q), k, pack=True)
    assert torch.equal(p0[0], p1[0]) and torch.equal(p0[1], p1[1])


@pytest.mark.parametrize("kind,pq", [("int", True), ("int", False),
                                     ("gauss", False)])
def test_search_codes_lut_pack_false_matches_jax_and_the_oracle(rng, kind,
                                                                pq):
    """`search_codes(mode="lut", pack=False)` == the JAX one (interpret,
    f32 tables) and == the LUT oracle by position; in decode mode
    ``pack`` is accepted and changes nothing."""
    n, d, nq, k = 5000, 24, 7, 30
    C, B, ncb, nco = _lut_case(rng, kind, pq, not pq, n=n, d=d)
    Q = _queries(rng, kind, nq, d)
    jn = {} if pq else dict(norms_cbook=jnp.asarray(ncb),
                            norms_codes=jnp.asarray(nco))
    tn = {} if pq else dict(norms_cbook=_t(ncb), norms_codes=_t(nco))
    jidx = jsc.build_codes_index(jnp.asarray(C), jnp.asarray(B), pq=pq, d=d,
                                 **jn)
    tidx = tsc.build_codes_index(_t(C), _t(B), pq=pq, d=d, **tn)
    jd, ji = jsc.search_codes(jidx, jnp.asarray(Q), k, mode="lut",
                              pack=False, interpret=True, bq=8,
                              lut_dtype=jnp.float32)
    td, ti = tsc.search_codes(tidx, _t(Q), k, mode="lut", pack=False)
    _assert_f32_tie_rule(jd, ji, td, ti, exact=kind == "int")
    T = tsc.build_luts(tidx.C, _t(Q), pq=pq, d=d, norms_cbook=tidx.norms_cbook)
    os_, oi = tsc.lut_scan(T, tsc.unpack_codes(tidx.packed, tidx.mprime), k)
    assert torch.equal(ti, oi)
    assert torch.equal(td, os_ + (_t(Q) ** 2).sum(-1, keepdim=True))
    a = tsc.search_codes(tidx, _t(Q), k, mode="decode", pack=False)
    b = tsc.search_codes(tidx, _t(Q), k, mode="decode")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_search_pack_false_beyond_the_plan_and_on_small_bases(rng):
    """Beyond the f32 plan's deepest buffer (r = 48 on the CPU) the
    search is the exact scan alone; k > n clamps; an explicit r too
    shallow for k raises as in the JAX package."""
    n, d = 7000, 8
    Xd, x2 = _base(rng, "gauss", n, d)
    idx = tsp.LinscanIndex(_t(Xd), _t(x2))
    Q = _t(_queries(rng, "gauss", 2, d))
    dv, di = tsp.search(idx, Q, 48 * 128 + 1, pack=False)
    ed, ei = tls.exact_rescan(Q, idx.Xd, idx.x2, 48 * 128 + 1)
    assert torch.equal(di, ei) and torch.equal(dv, ed)
    dv, di = tsp.search(idx, Q, n + 5, pack=False)
    assert dv.shape == (2, n) and sorted(di[0].tolist()) == list(range(n))
    with pytest.raises(ValueError, match="r\\*128"):
        tsp.search(idx, Q, 3000, pack=False, r=16)
    cidx = tsc.build_codes_index(_t(np.ones((2, 4, 4), np.float32)),
                                 _t(rng.integers(0, 4, (300, 2))), pq=True,
                                 d=8)
    s, i = tsc.search_codes(cidx, Q, 400, mode="lut", pack=False)
    assert s.shape == (2, 300) and sorted(i[1].tolist()) == list(range(300))
    assert tsc._codes_config(7000, "lut", 9000, "cpu")[0] == "lut"
    assert tsc._codes_config(100, "lut", 9000, "cpu") == ("f32", 16, 0, 2048)


def test_facade_and_linscan_reach_the_f32_path(rng, monkeypatch):
    """`api.search(index, Q, k, pack=False)` on the decoded and on the
    codes index (``mode="lut"``) and `linscan_lsq(..., pack=False,
    backend="kernel")` run the exact-float scans (counted through their
    entry points) and equal the exact scans by position; the facade's
    result equals the JAX `exact_rescan` on the same decoded base."""
    n, d, m, h, nq, k = 4000, 24, 3, 16, 8, 20
    C, B = int_dataset(rng, d=d, n=n, m=m, h=h, pq=False)
    Q = _queries(rng, "int", nq, d)
    ncb = rng.integers(0, 60, h).astype(np.float32)
    nco = rng.integers(0, h, n).astype(np.int32)
    calls = []
    for mod, name in ((tsp, "scan_topk_f32"), (tsc, "codes_lut_topk_f32")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    model = convert.model_from_arrays("lsq", C, h=h, device="cpu")
    Xd, x2 = tsp.decode_base(model.codebooks, _t(B), norm_term=_t(ncb)[
        _t(nco).long()])
    dec = tapi.MCQIndex(model, _t(B), tsp.LinscanIndex(Xd, x2), _t(ncb),
                        _t(nco), mode="decoded")
    cod = convert.index_from_arrays(model, B, ncb, nco, d=d)
    dd, di = tapi.search(dec, Q, k, pack=False)
    assert calls == ["scan_topk_f32"]
    ed, ei = tls.exact_rescan(_t(Q), Xd, x2, k)
    assert torch.equal(di, ei) and torch.equal(dd, ed)
    jd, ji = jls.exact_rescan(jnp.asarray(Q), jnp.asarray(Xd.numpy()),
                              jnp.asarray(x2.numpy()), k)
    np.testing.assert_array_equal(di.numpy(), np.asarray(ji))
    cd, ci = tapi.search(cod, Q, k, mode="lut", pack=False)
    assert calls == ["scan_topk_f32", "codes_lut_topk_f32"]
    # the same rows and norm terms: the two indexes agree by position
    assert torch.equal(ci, di) and torch.equal(cd, dd)
    ld, li = tls.linscan_lsq(C, Q, B, ncb, nco, k=k, pack=False,
                             backend="kernel", device="cpu")
    assert calls[-1] == "scan_topk_f32" and len(calls) == 3
    assert torch.equal(li, di) and torch.equal(ld, dd)
    # the tiled plain scan is exact f32 already: pack is accepted there
    pd, pi = tls.linscan_lsq(C, Q, B, ncb, nco, k=k, pack=False,
                             backend="torch", device="cpu")
    assert torch.equal(pi, di) and len(calls) == 3


def test_decoded_index_conversion_keeps_f32(rng):
    """An f32 JAX `LinscanIndex` arrives bit for bit (no round trip
    through bfloat16), zero-padded to the kernel's width; a bf16 one is
    widened to float32 and keeps its values exactly."""
    Xd = rng.standard_normal((300, 12)).astype(np.float32)
    x2 = (Xd * Xd).sum(-1)
    idx = convert.decoded_index_from_arrays(Xd, x2, device="cpu")
    assert idx.Xd.dtype == torch.float32 and idx.Xd.shape == (300, 16)
    np.testing.assert_array_equal(idx.Xd[:, :12].numpy(), Xd)
    np.testing.assert_array_equal(idx.x2.numpy(), x2)
    jb = jnp.asarray(Xd).astype(jnp.bfloat16)
    b = convert.decoded_index_from_arrays(np.asarray(jb), x2, device="cpu")
    assert b.Xd.dtype == torch.float32
    np.testing.assert_array_equal(
        b.Xd[:, :12].numpy(), np.asarray(jb.astype(jnp.float32)))
