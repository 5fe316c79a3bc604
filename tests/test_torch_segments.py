"""The segmented searches of `rayuela_tpu_torch` against the JAX
package's own, on the CPU.

A base beyond the packed row-id range (2**16 row ids x 128 lanes) runs
in segments with an exact merge. Here both packages' segment constants
are shrunk in the test process (`scan_codes._DECODE_SEG`,
`scan._SEG_DECODED`, and `scan_codes_pallas._DECODE_SEG`,
`scan_pallas._SEG_DECODED` in the JAX package), so that a few thousand
rows make three segments with a ragged tail. The JAX package runs its
Pallas kernels in interpret mode with f32 tables, the port its plain
versions.

Tolerances. Where both packages' plans give a segment the same id bits,
integer data compare under the tie rule (tests/torch_parity.py:
truncated scores equal, row ids equal by position, ids equal as sets
within groups of equal key). Where they do not (the port's two-pass
tile is 8192 rows, the JAX package's interpret-mode plans 1024 or 2048,
so a segment of fewer rows gets other id bits), the data are integers
whose raw scores are non-negative and below 2**13: cutting such a score
to 16 or more bits loses nothing (a negative score's key rounds down a
step), so the tie rule holds again. On Gaussian data the packages sum
in different orders: every score lies within one truncation step of the
coarsest segment (2**(idbits - 23) of the raw score, + 1e-4) and at
least 99% of ids agree as sets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.search import scan_codes_pallas as jsc
from rayuela_tpu.search import scan_pallas as jsp
from rayuela_tpu_torch.ops.qerror import reconstruct_pq
from rayuela_tpu_torch.search import scan as tsp
from rayuela_tpu_torch.search import scan_codes as tsc
from tests.torch_parity import (assert_close_topk, assert_tie_rule,
                                gauss_dataset, int_dataset)

torch.set_num_threads(2)

D, M, H = 32, 4, 16
SEG = 4096          # the shrunk segment: 32 row ids a lane


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    the data depend on the tests that ran before)."""
    return np.random.default_rng(0)


@pytest.fixture
def seg(monkeypatch):
    """Both packages' codes segments shrunk to ``SEG`` rows; returns a
    function that shrinks them to another size."""
    def shrink(rows):
        monkeypatch.setattr(jsc, "_DECODE_SEG", rows)
        monkeypatch.setattr(tsc, "_DECODE_SEG", rows)
    shrink(SEG)
    return shrink


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _data(rng, kind, pq, n, d=D):
    """``kind``: "int" (codebook entries in [-3, 3]), "pos" (in [0, 3]:
    with `_queries`' "pos" queries in [-3, 0] every raw score -2 q.x +
    |x|^2 is a non-negative integer) or "gauss"."""
    if kind == "gauss":
        C, B = gauss_dataset(rng, d=d, n=n, m=M, h=H, pq=pq)
    else:
        C, B = int_dataset(rng, d=d, n=n, m=M, h=H, pq=pq)
        if kind == "pos":
            C = np.abs(C)
    ncb = nco = None
    if not pq:
        ncb = (rng.random(12) * 40 if kind == "gauss"
               else rng.integers(0, 60, 12)).astype(np.float32)
        nco = rng.integers(0, 12, n).astype(np.int32)
    return C, B, ncb, nco


def _queries(rng, nq, kind, d=D):
    if kind == "gauss":
        return rng.standard_normal((nq, d)).astype(np.float32)
    if kind == "pos":
        return -rng.integers(0, 4, (nq, d)).astype(np.float32)
    return rng.integers(-3, 4, (nq, d)).astype(np.float32)


def _indexes(C, B, pq, ncb, nco, d=D):
    jidx = jsc.build_codes_index(
        jnp.asarray(C), jnp.asarray(B), pq=pq, d=d,
        norms_cbook=None if pq else jnp.asarray(ncb),
        norms_codes=None if pq else jnp.asarray(nco))
    tidx = tsc.build_codes_index(
        _t(C), _t(B), pq=pq, d=d, norms_cbook=None if pq else _t(ncb),
        norms_codes=None if pq else _t(nco))
    return jidx, tidx


def _jax_search(jidx, Q, k, mode, **kw):
    """JAX `search_codes` in interpret mode with f32 tables; LUT mode
    asks for its packed scan (interpret mode's default is the
    exact-float one)."""
    if mode == "lut":
        kw = dict(kw, pack=True)
    return jsc.search_codes(jidx, jnp.asarray(Q), k, interpret=True,
                            lut_dtype=jnp.float32, mode=mode, **kw)


def _assert_merged_tie_rule(jd, ji, td, ti):
    """Lists merged across segments: the dists equal by position, the ids
    equal as sets within every group of equal dist but the one that may
    straddle position k. After a segment's rescue the JAX package merges
    its list again behind the others', so among equal dists from
    different segments its order is not by id; the port's is
    (`_assert_sorted_unique`)."""
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = td.numpy(), ti.numpy()
    np.testing.assert_array_equal(jd, td)
    for q in range(jd.shape[0]):
        inner = jd[q] != jd[q, -1]
        assert sorted(ji[q, inner]) == sorted(ti[q, inner]), q


def _assert_sorted_unique(d, i, n):
    """Ids in [0, n), distinct in each row, sorted by (dist, id)."""
    d, i = d.numpy(), i.numpy().astype(np.int64)
    assert ((i >= 0) & (i < n)).all()
    assert all(len(set(r.tolist())) == i.shape[1] for r in i)
    step = np.diff(d, axis=1)
    assert (step >= 0).all()
    assert (np.diff(i, axis=1)[step == 0] > 0).all()


@pytest.mark.parametrize("pq", [True, False])
@pytest.mark.parametrize("mode", ["decode", "lut"])
def test_segmented_search_matches_jax(rng, seg, mode, pq):
    """Three segments, the last ragged (2 x 4096 + 1500 rows), in decode
    and LUT mode, PQ and additive with the norms byte: the tie rule
    against the JAX package's segmented search; the port keeps one
    sub-index a segment, the last one ragged."""
    n, nq, k = 2 * SEG + 1500, 6, 25
    C, B, ncb, nco = _data(rng, "pos", pq, n)
    Q = _queries(rng, nq, "pos")
    jidx, tidx = _indexes(C, B, pq, ncb, nco)
    jd, ji = _jax_search(jidx, Q, k, mode)
    td, ti = tsc.search_codes(tidx, _t(Q), k, mode=mode)
    assert sorted(tidx._segments) == [0, SEG, 2 * SEG]
    assert tidx._segments[2 * SEG].n == 1500
    assert_tie_rule(jd, ji, td, ti)
    _assert_sorted_unique(td, ti, n)


@pytest.mark.parametrize("mode", ["decode", "lut"])
def test_segmented_search_on_gaussian_data_within_a_step(rng, seg, mode):
    """Gaussian PQ data over 2 x 8192 + 3000 rows: the full segments have
    6 id bits in both packages' plans, the ragged one 6 in the port's
    (tile 8192) and 5 or fewer in the JAX package's; one step of the
    coarsest segment apart, >= 99% of ids shared."""
    seg(8192)
    n, nq, k = 2 * 8192 + 3000, 6, 25
    C, B, ncb, nco = _data(rng, "gauss", True, n)
    Q = _queries(rng, nq, "gauss")
    jidx, tidx = _indexes(C, B, True, ncb, nco)
    jd, ji = _jax_search(jidx, Q, k, mode)
    td, ti = tsc.search_codes(tidx, _t(Q), k, mode=mode)
    q2 = (Q * Q).sum(-1, keepdims=True)
    assert_close_topk(np.asarray(jd) - q2, ji, td.numpy() - q2, ti,
                      tsp._pack_idbits(8192), atol=1e-4)


@pytest.mark.parametrize("mode", ["decode", "lut"])
def test_k_beyond_the_last_segments_rows(rng, seg, mode):
    """k = 100 over 2 x 4096 + 60 rows: the ragged segment serves its 60
    rows (``min(k, rows)``), and the merged list equals the JAX
    package's under the tie rule."""
    n, nq, k = 2 * SEG + 60, 5, 100
    C, B, ncb, nco = _data(rng, "pos", False, n)
    Q = _queries(rng, nq, "pos")
    jidx, tidx = _indexes(C, B, False, ncb, nco)
    jd, ji = _jax_search(jidx, Q, k, mode)
    td, ti = tsc.search_codes(tidx, _t(Q), k, mode=mode)
    assert td.shape == (nq, k) and tidx._segments[2 * SEG].n == 60
    assert_tie_rule(jd, ji, td, ti)
    _assert_sorted_unique(td, ti, n)


@pytest.mark.parametrize("mode", ["decode", "lut"])
def test_planted_rows_at_the_segment_boundaries(rng, seg, mode):
    """Rows on both sides of each segment boundary and the last row are
    the queries' own PQ decodes: each comes back at the head of its
    query's list, its distance within one truncation step of 0, in both
    packages, whose lists agree (`_assert_merged_tie_rule`). Segments of
    8192 rows and a ragged one of 7500 have 6 id bits in both packages'
    plans (LUT mode at one explicit plan, tile 1024), so the negative raw
    scores cut alike. A wrong segment offset or a dropped
    ragged tail moves or loses a planted row."""
    seg(8192)
    n, k = 2 * 8192 + 7500, 20
    C, B, _, _ = _data(rng, "int", True, n)
    planted = [8191, 8192, 2 * 8192 - 1, 2 * 8192, n - 1]
    Q = np.concatenate([
        reconstruct_pq(_t(C), _t(B[planted]), D).numpy(),
        _queries(rng, 2, "int")])
    jidx, tidx = _indexes(C, B, True, None, None)
    # LUT mode serves a flagged (query, segment) from the LUT oracle,
    # uncut: one plan in both packages flags the same pairs
    kw = dict(r=14, keep=2, tile=1024) if mode == "lut" else {}
    jd, ji = _jax_search(jidx, Q, k, mode, **kw)
    td, ti = tsc.search_codes(tidx, _t(Q), k, mode=mode, **kw)
    _assert_merged_tie_rule(jd, ji, td, ti)
    _assert_sorted_unique(td, ti, n)
    step = 2.0 ** (tsp._pack_idbits(8192) - 23)
    q2 = (Q * Q).sum(-1)
    for j, p in enumerate(planted):
        row = ti[j].tolist()
        assert p in row, (j, p)
        assert float(td[j, row.index(p)]) == float(td[j, 0])
        # |q|^2 + the raw score -|q|^2 cut down by at most a step
        assert abs(float(td[j, 0])) <= step * q2[j], (j, float(td[j, 0]))


def _flag_case(rng, segments):
    """The JAX tests' overflow: 16 copies of one code in lane 0 of each
    listed segment of 4 x 8192 rows (d = 16), the first query that
    code's decode. A 16-row lane overflows a buffer of 8 and a per-tile
    keep of 2, so the (query, segment) pair is flagged."""
    d, n = 16, 4 * 8192
    C, B = int_dataset(rng, d=d, n=n, m=M, h=H, pq=True)
    best = rng.integers(0, H, M).astype(np.int32)
    for s in segments:
        for t in range(16):
            B[s * 8192 + t * 128] = best
    Q = np.concatenate([reconstruct_pq(_t(C), _t(best[None]), d).numpy(),
                        _queries(rng, 3, "int", d)])
    return C, B, Q, d


@pytest.mark.parametrize("route", ["plan", "explicit"])
@pytest.mark.parametrize("segments", [(0,), (0, 2)])
def test_flagged_segments_are_repaired(rng, seg, monkeypatch, segments,
                                       route):
    """A flag in one segment and flags in two (the JAX tests
    `test_segmented_overflow_is_flagged_and_repaired` and
    `test_segmented_multiflag_exact_kernel_rescue`, at segments of 8192
    rows, where both packages' plans give 6 id bits): each flagged
    segment's rescue re-runs its own rows through K4 (the LUT oracle,
    stubbed to fail, is never needed), the merged lists hold the 16
    copies, equal the brute-force distances (rtol 1e-4, atol 1e-3, the
    JAX tests' tolerance: the keys cut negative scores by up to a step of
    2**-17) and the JAX package's result (`_assert_merged_tie_rule`).
    ``plan``:
    each package's default plan; ``explicit``: the one-pass scan at
    r = 8, tile 1024, keep 0."""
    seg(8192)
    C, B, Q, d = _flag_case(rng, segments)
    kw = {} if route == "plan" else dict(r=8, tile=1024, keep=0)
    k = 32
    jidx = jsc.build_codes_index(jnp.asarray(C), jnp.asarray(B), pq=True,
                                 d=d)
    jd, ji = jsc.search_codes(jidx, jnp.asarray(Q), k, interpret=True,
                              lut_dtype=jnp.float32, **kw)
    tidx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=d)
    rescued, real = [], tsc._rescue

    def spy(Qx, Cf, nrm, index, s, i, flagged, *a, **kwa):
        rescued.append((index.packed.data_ptr(),
                        torch.nonzero(flagged).flatten().tolist()))
        return real(Qx, Cf, nrm, index, s, i, flagged, *a, **kwa)

    def boom(*a, **kwa):
        raise AssertionError("the LUT oracle served a flagged query")

    monkeypatch.setattr(tsc, "_rescue", spy)
    monkeypatch.setattr(tsc, "_lut_scan_tiled", boom)
    td, ti = tsc.search_codes(tidx, _t(Q), k, **kw)
    starts = {tidx._segments[s * 8192].packed.data_ptr(): s
              for s in range(4)}
    assert {starts[p] for p, qs in rescued if 0 in qs} == set(segments)
    Xd = reconstruct_pq(_t(C), _t(B), d).numpy()
    D2 = ((Q[:, None, :] - Xd[None]) ** 2).sum(-1)
    np.testing.assert_allclose(td.numpy(), np.sort(D2, 1)[:, :k],
                               rtol=1e-4, atol=1e-3)
    copies = {s * 8192 + t * 128 for s in segments for t in range(16)}
    assert copies <= set(ti[0].tolist())
    _assert_merged_tie_rule(jd, ji, td, ti)
    _assert_sorted_unique(td, ti, 4 * 8192)


@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_segmented_decoded_search_matches_jax(rng, monkeypatch, kind):
    """The decoded index over three segments (2 x 4096 + 1808 rows, both
    packages' `_SEG_DECODED` shrunk to 4096) at r = 14, tile 1024,
    keep 2: JAX `scan_pallas.search` (interpret, packed keys) under the
    tie rule on integer rows (a flagged query's exact rescan orders as
    the keys do when the truncation loses nothing), one truncation step
    of a segment (5 id bits) on Gaussian rows."""
    monkeypatch.setattr(jsp, "_SEG_DECODED", SEG)
    monkeypatch.setattr(tsp, "_SEG_DECODED", SEG)
    n, d, nq, k = 2 * SEG + 1808, 24, 9, 20
    if kind == "int":
        Xd = rng.integers(-3, 4, (n, d)).astype(np.float32)
    else:
        Xd = rng.standard_normal((n, d)).astype(np.float32)
    x2 = (Xd * Xd).sum(-1)
    Q = _queries(rng, nq, kind, d)
    kw = dict(r=14, tile=1024, keep=2)
    jd, ji = jsp.search(jsp.LinscanIndex(jnp.asarray(Xd), jnp.asarray(x2)),
                        jnp.asarray(Q), k, interpret=True, pack=True, bq=8,
                        **kw)
    tidx = tsp.LinscanIndex(_t(Xd), _t(x2))
    parts = []
    real = tsp.scan_topk_packed
    monkeypatch.setattr(tsp, "scan_topk_packed", lambda Qx, X, *a, **kwa:
                        parts.append(X.shape[0]) or real(Qx, X, *a, **kwa))
    td, ti = tsp.search(tidx, _t(Q), k, **kw)
    assert parts == [SEG, SEG, 1808]
    if kind == "int":
        assert_tie_rule(jd, ji, td, ti)
    else:
        q2 = (Q * Q).sum(-1, keepdims=True)
        assert_close_topk(np.asarray(jd) - q2, ji, td.numpy() - q2, ti,
                          tsp._pack_idbits(SEG), atol=1e-4)
    _assert_sorted_unique(td, ti, n)


@pytest.mark.parametrize("mode", ["decode", "lut"])
def test_streamed_shards_span_segments(rng, seg, monkeypatch, mode):
    """`search_codes_streamed` with shards of 5000 rows over segments of
    2048 (each shard 2 full segments and a ragged 904, the last shard
    1000 rows), additive codes with the norms byte in a numpy array:
    the JAX package's streamed search under the tie rule, and the port's
    resident search, whose segments start elsewhere, by position (the
    scores are non-negative integers, which no segment's key cuts). A
    swapped shard leaves no sub-index over the previous buffer."""
    seg(2048)
    n, k, nq = 11_000, 25, 6
    C, B, ncb, nco = _data(rng, "pos", False, n)
    Q = _queries(rng, nq, "pos")
    packed = tsc.pack_codes(_t(B), _t(nco)).numpy()
    jd, ji = jsc.search_codes_streamed(
        jnp.asarray(C), packed, jnp.asarray(Q), k, d=D,
        norms_cbook=jnp.asarray(ncb), mprime=M + 1, shard_n=5000,
        interpret=True, lut_dtype=jnp.float32, mode=mode,
        **({"pack": True} if mode == "lut" else {}))
    kw = dict(d=D, norms_cbook=_t(ncb), mprime=M + 1)
    swaps, real = [], tsc.CodesIndex.swap_packed

    def spy(self, pk):
        real(self, pk)
        swaps.append(dict(self._segments))

    monkeypatch.setattr(tsc.CodesIndex, "swap_packed", spy)
    td, ti = tsc.search_codes_streamed(_t(C), packed, _t(Q), k,
                                       shard_n=5000, mode=mode, **kw)
    assert swaps == [{}, {}]
    assert_tie_rule(jd, ji, td, ti)
    idx = tsc.CodesIndex(_t(packed), M + 1, _t(C), pq=False, d=D,
                         norms_cbook=kw["norms_cbook"])
    rd, ri = tsc.search_codes(idx, _t(Q), k, mode=mode)
    assert sorted(idx._segments) == list(range(0, n, 2048))
    assert torch.equal(td, rd) and torch.equal(ti, ri)
    _assert_sorted_unique(td, ti, n)


@pytest.mark.parametrize("d", [24, 21])
def test_decoded_index_holds_the_base_once(rng, d):
    """`decode_base` fills one buffer chunk by chunk, and `LinscanIndex`
    keeps the caller's rows where their width is already a multiple of 8
    (a zero-width `pad` copies the whole base): at d = 24 the index's
    rows are the decode's own buffer; at d = 21 they are padded to 24
    with zeros. Either way the rows equal the one-shot decode."""
    n, m = 1000, 3
    C, B = gauss_dataset(rng, d=d, n=n, m=m, h=H, pq=False)
    Xd, x2 = tsp.decode_base(_t(C), _t(B), chunk=300)
    ref = sum(_t(C)[j][_t(B)[:, j].long()] for j in range(m))
    assert Xd.shape == (n, d)
    torch.testing.assert_close(Xd, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(x2, (ref * ref).sum(-1), rtol=1e-5,
                               atol=1e-5)
    idx = tsp.LinscanIndex(Xd, x2)
    assert idx.Xd.shape == (n, -(-d // 8) * 8) and idx.d == d
    assert (idx.Xd.data_ptr() == Xd.data_ptr()) == (d % 8 == 0)
    assert torch.equal(idx.Xd[:, :d], Xd)
    assert not idx.Xd[:, d:].any()
    Cp, Bp = gauss_dataset(rng, d=d, n=n, m=m, h=H, pq=True)
    Xp, _ = tsp.decode_base(_t(Cp), _t(Bp), pq=True, chunk=300)
    assert torch.equal(Xp, reconstruct_pq(_t(Cp), _t(Bp)))
