"""The one-pass decode scan with a per-tile cut of `rayuela_tpu_torch`
(K14's plain version, `codes_decode_onepass_plain`, under
`scan_codes_decode_topk(keep > 0)`) against the JAX package's
`pallas_scan_codes_decode_topk` in interpret mode on the CPU, through its
three bodies: the per-tile merge, the query super-block (``qsuper``) and
the staged merge (``stage``), which compute one function.

On small-integer data every score is exact in both packages: results,
flags included, compare under the tie rule (tests/torch_parity.py). On
Gaussian data the two sum in different orders: at least 99% of the ids
agree and every score is within one truncation step. `search_codes`
routes as the JAX package does, keeps its plan and its validation
errors, and its one-pass result equals the two-pass one."""

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


def _index(rng, kind, pq, n, jdtype=jnp.float32, tdtype=torch.float32):
    """Codes, norms and decode operands of both packages."""
    mk = int_dataset if kind == "int" else gauss_dataset
    C, B = mk(rng, d=D, n=n, m=M, h=H, pq=pq)
    ncb = nco = None
    if not pq:
        ncb = (rng.integers(0, 60, 12) if kind == "int"
               else rng.random(12) * 40).astype(np.float32)
        nco = rng.integers(0, 12, n).astype(np.int32)
    jpk = jsc.pack_codes(jnp.asarray(B),
                         None if nco is None else jnp.asarray(nco))
    tpk = tsc.pack_codes(_t(B), None if nco is None else _t(nco))
    jCf, jnrm = jsc.build_decode_operands(
        jnp.asarray(C), pq=pq, d=D, op_dtype=jdtype,
        norms_cbook=None if ncb is None else jnp.asarray(ncb))
    tCf, tnrm = tsc.build_decode_operands(
        _t(C), pq=pq, d=D, op_dtype=tdtype,
        norms_cbook=None if ncb is None else _t(ncb))
    return (C, B, ncb, nco), (jCf, jnrm, jpk), (tCf, tnrm, tpk)


def _queries(rng, nq, kind):
    if kind == "int":
        return rng.integers(-3, 4, (nq, D)).astype(np.float32)
    return rng.standard_normal((nq, D)).astype(np.float32)


@pytest.mark.parametrize("pq", [True, False])
@pytest.mark.parametrize("r,keep,tile,qsuper,stage", [
    (14, 2, 2048, 1, 0), (12, 4, 2048, 1, 0), (28, 4, 1024, 1, 0),
    (14, 2, 2048, 2, 0), (12, 4, 2048, 2, 0),
    (16, 2, 2048, 1, 8), (32, 4, 2048, 1, 8)])
def test_onepass_cut_matches_jax_on_integer_data(rng, pq, r, keep, tile,
                                                 qsuper, stage):
    """Every body of the JAX one-pass kernel at keep > 0 (per-tile merge,
    query super-block, staged merge) gives the port's result, flags
    included; n ragged against the tile."""
    n, nq, k = 20_000, 9, 40
    _, (jCf, jnrm, jpk), (tCf, tnrm, tpk) = _index(rng, "int", pq, n)
    Q = _queries(rng, nq, "int")
    js, ji, jf = jsc.pallas_scan_codes_decode_topk(
        jnp.asarray(Q), jCf, jnrm, jpk, k=k, pq=pq, r=r, bq=8, tile=tile,
        keep=keep, qsuper=qsuper, stage=stage, interpret=True,
        op_dtype=jnp.float32)
    ts, ti, tf = tsc.scan_codes_decode_topk(
        _t(Q), tCf, tnrm, tpk, k=k, pq=pq, r=r, tile=tile, keep=keep,
        qsuper=qsuper, stage=stage)
    assert_tie_rule(js, ji, ts, ti)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("pq", [True, False])
def test_onepass_cut_matches_jax_on_gaussian_data(rng, pq):
    n, nq, k = 20_000, 9, 40
    _, (jCf, jnrm, jpk), (tCf, tnrm, tpk) = _index(
        rng, "gauss", pq, n, jnp.bfloat16, torch.bfloat16)
    Q = _queries(rng, nq, "gauss")
    js, ji, _ = jsc.pallas_scan_codes_decode_topk(
        jnp.asarray(Q), jCf, jnrm, jpk, k=k, pq=pq, r=14, bq=8, tile=2048,
        keep=2, interpret=True, op_dtype=jnp.bfloat16)
    ts, ti, _ = tsc.scan_codes_decode_topk(_t(Q), tCf, tnrm, tpk, k=k, pq=pq,
                                           r=14, tile=2048, keep=2)
    # score terms (|x|^2, 2 q.x) reach ~40: f32 sums of 32 of them round
    # at ~40 * 2**-23 * sqrt(32) < 3e-5
    assert_close_topk(js, ji, ts, ti, tsp._pack_idbits(20_480), atol=1e-4)


@pytest.mark.parametrize("tile", [1024, 8192])
def test_a_ragged_last_tile_keeps_its_pad_rows_out(rng, tile):
    """n = 5,001: the last tile is mostly rows past n, scored +inf.
    Their keys never reach a lane's buffer ahead of real rows (every
    lane has at least ``keep`` real rows per tile here), and the buffer
    equals the JAX kernel's."""
    n, nq, r, keep = 5_001, 7, 12, 4
    _, (jCf, jnrm, jpk), (tCf, tnrm, tpk) = _index(rng, "int", False, n)
    Q = _queries(rng, nq, "int")
    idbits = tsp._pack_idbits(-(-n // tile) * tile)
    Qm = tsc._query_operand(_t(Q), tCf.shape[1], torch.float32)
    out = tsc.codes_decode_onepass(Qm, tCf, tnrm, tpk, tile=tile, r=r,
                                   keep=keep, idbits=idbits, has_norms=True)
    pad = int(tsp._sortable_key(torch.tensor(float("inf")))) & -(1 << idbits)
    kept = out[:r]
    assert not bool(((kept >= pad) & (kept != tsp.IMAX)).any())
    js, ji, jf = jsc.pallas_scan_codes_decode_topk(
        jnp.asarray(Q), jCf, jnrm, jpk, k=40, pq=False, r=r, bq=8,
        tile=tile, keep=keep, interpret=True, op_dtype=jnp.float32)
    ts, ti, tf = tsp._finish(out, nq, r, 40, idbits)
    assert_tie_rule(js, ji, ts, ti)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("pq,n", [(True, 20_001), (False, 20_001),
                                  (True, 8_000)])
def test_search_codes_onepass_equals_the_two_pass_search(rng, pq, n):
    """`search_codes(twopass=False)` (the one-pass plan, tile 2048) and
    with ``stage=1`` serve the two-pass search's result on a ragged base
    (the plans' tiles give the keys the same id bits here), and the JAX
    package's one-pass search at the same plan."""
    (C, B, ncb, nco), _, _ = _index(rng, "int", pq, n)
    Q = _queries(rng, 6, "int")
    kw = dict(pq=pq, d=D, norms_cbook=None if pq else _t(ncb),
              norms_codes=None if pq else _t(nco))
    tidx = tsc.build_codes_index(_t(C), _t(B), **kw)
    k = 30
    two = tsc.search_codes(tidx, _t(Q), k)
    for opts in (dict(twopass=False), dict(stage=1)):
        one = tsc.search_codes(tidx, _t(Q), k, **opts)
        assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    jidx = jsc.build_codes_index(
        jnp.asarray(C), jnp.asarray(B), pq=pq, d=D,
        norms_cbook=None if pq else jnp.asarray(ncb),
        norms_codes=None if pq else jnp.asarray(nco))
    r, keep, tile = tsc._onepass_config(k, tidx.mprime)
    jd, ji = jsc.search_codes(jidx, jnp.asarray(Q), k, interpret=True,
                              lut_dtype=jnp.float32, twopass=False, r=r,
                              keep=keep, tile=tile, bq=8)
    assert_tie_rule(jd, ji, two[0], two[1])


@pytest.mark.parametrize("k", [1, 100, 512, 513, 1000, 3000])
@pytest.mark.parametrize("mprime", [8, 11, 12, 17])
def test_onepass_plan_is_the_jax_packages(k, mprime):
    r, bq, tile, keep, stage, qsuper = jsc._codes_auto_config(
        k, 10_000, True, "decode", mprime)
    assert tsc._onepass_config(k, mprime) == (r, keep, tile)
    assert stage == 0


def test_the_jax_validation_errors_are_raised(rng):
    """tests/test_scan_codes.py:311-324, on the port."""
    (C, B, _, _), _, _ = _index(rng, "int", True, 4096)
    idx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=D)
    Q = _t(_queries(rng, 4, "int"))
    kw = dict(mode="decode", bq=4, tile=1024)
    with pytest.raises(ValueError, match="staged merge requires"):
        tsc.search_codes(idx, Q, 8, r=16, keep=0, stage=8, **kw)
    with pytest.raises(ValueError, match="r\\+keep\\*stage"):
        tsc.search_codes(idx, Q, 8, r=14, keep=2, stage=8, **kw)
    with pytest.raises(ValueError, match="keep\\*stage"):
        tsc.search_codes(idx, Q, 8, r=26, keep=2, stage=3, **kw)
    with pytest.raises(ValueError, match="r\\*128"):
        tsc.search_codes(idx, Q, 5000, twopass=False)


@pytest.mark.parametrize("nqb,ntiles,splits", [
    (313, 123, 5),     # nq = 1e4, tile 8192 at n = 1e6: 1.2 waves unsplit
    (313, 489, 5),     # the same at tile 2048
    (264, 123, 1),     # one whole wave of query blocks
    (3125, 123, 1),    # nq = 1e5: the waves are nearly full unsplit
    (1, 123, 123),     # one query block: a CTA per tile
    (32, 8, 8)])
def test_onepass_splits_fill_the_waves(nqb, ntiles, splits):
    """K14's row-range splits on a card of 264 CTA slots (132 SMs x 2,
    clusters of one CTA): the fewest splits whose waves of tile ranges
    cost within 2% of the least, and never more than `_ONEPASS_CTAS`
    CTAs in all unless the query blocks alone are more."""
    slots = 264
    tp = tsc._onepass_tiles_per(nqb, ntiles, slots)
    assert -(-ntiles // tp) == splits

    def cost(t):
        return -(-nqb * -(-ntiles // t) // slots) * t
    cap = max(nqb, tsc._ONEPASS_CTAS) // nqb
    allowed = {-(-ntiles // s) for s in range(1, min(cap, ntiles) + 1)}
    assert cost(tp) <= 1.02 * min(cost(t) for t in allowed)
    assert all(cost(t) > 1.02 * min(map(cost, allowed))
               for t in allowed if t > tp)


@pytest.mark.parametrize("nq", [1, 300, 2048, 10_000])
@pytest.mark.parametrize("ntiles", [123, 489])
@pytest.mark.parametrize("qb,lanes,held,waves", [
    (32, 128, 30, 8),    # the bf16 body's layout on an H100
    (128, 16, 15, 16)])  # the f32 body's
def test_onepass_split_cap_counts_ctas(nq, ntiles, qb, lanes, held, waves):
    """K14's splits give its grid at most `_ONEPASS_CTAS` CTAs (each
    holds its own scratch) unless its query blocks alone are more: on
    the layouts an H100 reports, 8 waves of the bf16 body's 30 cluster
    slots of 8 CTAs and 16 waves of the f32 body's 15."""
    layout = (qb, 28 * 4096, 2, 128, 79_744, 8, held, 2, lanes)
    assert tsc._ONEPASS_CTAS == waves * held * 8
    nqb, tp = tsc._onepass_grid(nq, ntiles, layout)
    per_split = nqb * (128 // lanes)
    assert per_split * -(-ntiles // tp) <= max(per_split, tsc._ONEPASS_CTAS)


@pytest.mark.parametrize("nq,qb,cluster,blocks", [
    (1, 32, 4, 4),          # one query: a whole cluster of blocks
    (33, 32, 4, 4),
    (100, 32, 4, 4),
    (128, 32, 4, 4),        # exactly one cluster
    (129, 32, 4, 8),
    (10_000, 32, 4, 316),   # 313 blocks padded to 79 clusters
    (10_000, 32, 8, 320),   # clusters of 8 (the bf16 body's)
    (10_000, 32, 1, 313),   # clusters of one CTA
    (10_000, 128, 8, 80),   # the f32 body's: 10 clusters of 1024 queries
    (1, 128, 8, 8),
    (1024, 128, 8, 8),      # exactly one f32 cluster
    (1100, 128, 8, 16),
    (0, 32, 4, 0)])
def test_query_blocks_pad_to_whole_clusters(nq, qb, cluster, blocks):
    """K1's and K14's grids hold whole clusters of query blocks: the
    blocks of ``nq`` queries rounded up to a multiple of the cluster."""
    got = tsc._query_blocks(nq, qb, cluster)
    assert got == blocks
    assert got % cluster == 0 and got * qb >= nq
    assert (got - cluster) * qb < nq or nq == 0


@pytest.mark.parametrize("nq,ntiles,qb,cluster,held,lanes,splits", [
    (10_000, 123, 32, 4, 66, 128, 5),   # 79 clusters on 66 slots: 1.2 waves
    (10_000, 489, 32, 4, 66, 128, 5),   # the same at tile 2048
    (8448, 123, 32, 4, 66, 128, 1),     # 66 clusters: one whole wave
    (100, 123, 32, 4, 66, 128, 62),     # one cluster: a wave of 2-tile splits
    (10_000, 123, 32, 8, 33, 128, 4),   # 40 clusters of 8 on 33 slots (bf16)
    (10_000, 123, 32, 1, 264, 128, 5),  # clusters of one CTA, 264 slots
    (1, 8, 32, 4, 60, 128, 8),
    # the f32 body: 128 queries x 16 lanes a CTA, 8 lane blocks a
    # cluster of query blocks, one CTA an SM (16 clusters of 8 at once)
    (10_000, 123, 128, 8, 16, 16, 1),   # 10 x 8 clusters: five whole waves
    (10_000, 489, 128, 8, 16, 16, 1),
    (2048, 123, 128, 8, 16, 16, 1),     # 16 clusters: one whole wave
    (256, 123, 128, 8, 16, 16, 2),      # 8 clusters: two splits fill a wave
    (1, 8, 128, 8, 15, 16, 8),          # 8 clusters on 15 slots: a tile each
    # the layouts an NVIDIA H100 80GB HBM3 reports: bf16 30 slots, f32 15
    (10_000, 123, 32, 8, 30, 128, 3),
    (10_000, 489, 32, 8, 30, 128, 3),
    (2048, 123, 32, 8, 30, 128, 18),
    (10_000, 123, 128, 8, 15, 16, 3),   # 80 clusters: 16 whole waves
    (10_000, 489, 128, 8, 15, 16, 3)])
def test_onepass_grid_splits_over_cluster_slots(nq, ntiles, qb, cluster,
                                                held, lanes, splits):
    """K14's grid from its layout: the query blocks padded to whole
    clusters, and the rows split by `_onepass_tiles_per` with the
    clusters as its units (a cluster of CTAs walks one tile range; a
    cluster of query blocks has one a lane block, 128 / lanes) over the
    clusters the card holds at once."""
    layout = (qb, 28 * 4096, 2, 128, 79_744, cluster, held, 2, lanes)
    nqb, tp = tsc._onepass_grid(nq, ntiles, layout)
    assert nqb == tsc._query_blocks(nq, qb, cluster)
    assert tp == tsc._onepass_tiles_per(nqb // cluster * (128 // lanes),
                                        ntiles, held, cluster)
    assert -(-ntiles // tp) == splits


@pytest.mark.parametrize("nq,layout,dp,n", [
    (1, (32, 8, 2), 128, 1_000_000),         # the rescue's single query
    (8, (32, 8, 2), 128, 1_000_000),
    (128, (32, 8, 2), 128, 1_000_000),       # a quarter wave unsplit
    (1259, (32, 8, 2), 1024, 500_000),       # GIST's rescue: 2.4 waves
    (10_000, (32, 8, 2), 128, 1_000_000),    # 19 waves: never split
    (5, (16, 16, 1), 2432, 20_000),          # one CTA an SM, few rows
    (40, (16, 16, 2), 1024, 100_000)])       # f32 rows at GIST's width
def test_keep0_splits_trade_waves_against_the_merge(nq, layout, dp, n):
    """K4's and K8's (keep=0) row split from a layout as their entry
    reports it (queries per CTA, lanes per CTA, CTAs per SM) on a card of
    132 SMs: a CTA per query block and lane group, a split a whole number
    of the CTA's steps (32 / lanes row ids), and the fewest
    splits whose waves of steps plus K2's merge of the splits cost within
    2% of the least, with at most 4 waves of CTAs unless the query blocks
    alone are more."""
    sms, tile, r = 132, 2048, 48
    qb, ln, per_sm = layout
    lay = layout + (min(dp, 128) if dp > 256 else dp, 0)
    nrows, rows_per = tsp._onepass_rows(n, nq, tile, r, lay, dp, sms)
    nr = 32 // ln
    assert nrows == -(-n // tile) * tile // 128
    assert rows_per % nr == 0
    ctas, slots, nsteps = -(-nq // qb) * (128 // ln), sms * per_sm, \
        -(-nrows // nr)
    step = tsp._STEP_US * -(-dp // 128)
    merge = r * tsp._MERGE_US * -(-128 * nq // (sms * tsp._MERGE_THREADS))

    def cost(per):
        s = -(-nsteps // per)
        return -(-ctas * s // slots) * per * step + (s > 1) * s * merge
    cap = max(1, min(nsteps, 4 * slots // ctas + (4 * slots % ctas > 0)))
    allowed = {-(-nsteps // s) for s in range(1, cap + 1)}
    per = rows_per // nr
    assert per in allowed
    least = min(map(cost, allowed))
    assert cost(per) <= 1.02 * least
    assert all(cost(p) > 1.02 * least for p in allowed if p > per)
    if ctas >= 4 * slots:
        assert rows_per >= nrows
