"""The decoded scan's key modes of `rayuela_tpu_torch` against
`rayuela_tpu.search.scan_pallas` on the CPU: ``qbias``, ``score16`` and
the pre-min with its in-scan kernel rescue, through the port's plain
versions of K8 (+ K2 + K3) against the JAX scan in interpret mode, and
through both packages' ``search``.

On small-integer data every score is exact in both packages, so the
results compare under the tie rule (tests/torch_parity.py) and the flags
are equal. On Gaussian data the two sum in other orders: at least 99% of
the ids agree and every score is within one truncation step (a bf16 step
under score16) plus 1e-4. Under qbias the port's |q|^2 may differ from
the JAX package's in its last bit, so its scores are held within one
truncation step on integer data too."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.search import scan_pallas as jsp
from rayuela_tpu_torch.search import scan as tsp
from tests.torch_parity import assert_close_topk, assert_tie_rule

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    these tests' data depend on what ran before them)."""
    return np.random.default_rng(0)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _data(rng, kind, n, nq, d):
    if kind == "int":
        Xd = rng.integers(-3, 4, (n, d)).astype(np.float32)
        Q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    else:
        Xd = rng.standard_normal((n, d)).astype(np.float32)
        Q = rng.standard_normal((nq, d)).astype(np.float32)
    return Xd, (Xd * Xd).sum(-1), Q


def _jax_scan(Q, Xd, x2, **kw):
    return jsp.pallas_scan_topk(jnp.asarray(Q), jnp.asarray(Xd),
                                jnp.asarray(x2), interpret=True, pack=True,
                                tail=False, **kw)


def _port_dists(tres, Q, qbias):
    """The port's scan returns its scores without +|q|^2 but under
    qbias, as the JAX package's does before it adds |q|^2."""
    s, i, f = tres
    if not qbias:
        s = s + (_t(Q) ** 2).sum(-1, keepdim=True)
    return s, i, f


def _compare(kind, jres, tres, idbits, *, qbias=False, score16=False):
    (js, ji, jf), (ts, ti, tf) = jres, tres
    if score16:
        idbits = 16            # a bf16 step is 2**-7 of the value at most
    if kind == "int" and not qbias:
        assert_tie_rule(js, ji, ts, ti)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    elif kind == "int":
        assert_close_topk(js, ji, ts, ti, idbits, atol=0.0, min_overlap=1.0)
    else:
        assert_close_topk(js, ji, ts, ti, idbits, atol=1e-4)


@pytest.mark.parametrize("idbits", [4, 9, 15])
def test_key_helpers_equal_jax(rng, idbits):
    """`_row_key16`, `_row_key(nonneg=True)` and `_decode_packed_vals`
    equal the JAX helpers bit for bit: scores of both signs and of many
    magnitudes, zeros, values that round to the next bf16 exponent,
    +inf."""
    rows, nq = 8, 5
    s = (rng.standard_normal((rows * 128, nq))
         * 10.0 ** rng.integers(-6, 6, (rows * 128, nq))).astype(np.float32)
    s[:3, 0] = [0.0, -0.0, np.inf]
    s[3, :] = np.float32(1.0 - 2.0 ** -10)
    t = 3
    # the JAX kernel hands its helper the score block already in bf16
    j16 = jsp._row_key16(jnp.asarray(s).astype(jnp.bfloat16), t, rows=rows,
                         bq=nq, idbits=idbits)
    p16 = tsp._row_key16(_t(s), t, rows=rows, idbits=idbits)
    np.testing.assert_array_equal(p16.numpy(), np.asarray(j16))
    nn = np.abs(s)
    jnn = jsp._row_key(jnp.asarray(nn), t, rows=rows, bq=nq, idbits=idbits,
                       nonneg=True)
    pnn = tsp._row_key(_t(nn), t, rows=rows, idbits=idbits, nonneg=True)
    np.testing.assert_array_equal(pnn.numpy(), np.asarray(jnn))
    for keys, sc16 in ((j16, True), (jnn, False)):
        jv = jsp._decode_packed_vals(keys, idbits, sc16)
        pv = tsp._decode_packed_vals(_t(keys), idbits, sc16)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


_MODES = [dict(qbias=True), dict(score16=True), dict(premin=1),
          dict(premin=2), dict(premin=1, qbias=True),
          dict(premin=1, score16=True)]


def _mode_id(m):
    return "-".join(f"{k}{int(v)}" for k, v in m.items())


@pytest.mark.parametrize("mode", _MODES, ids=_mode_id)
@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("n,d,tile,keep,r", [(3000, 16, 1024, 2, 14),
                                             (20_000, 64, 2048, 4, 28)])
def test_scan_modes_match_jax(rng, mode, kind, n, d, tile, keep, r):
    """K8's plain version in each key mode + K2 + K3
    (`scan_topk_packed`) == JAX ``pallas_scan_topk(pack=True, qbias= /
    score16= / premin=)``: ids by position (within groups of equal keys
    from different lanes), the scores and the flags."""
    nq, k = 12, 30
    Xd, x2, Q = _data(rng, kind, n, nq, d)
    jres = _jax_scan(Q, Xd, x2, k=k, r=r, bq=4, tile=tile, keep=keep,
                     **mode)
    tres = tsp.scan_topk_packed(_t(Q), _t(Xd), _t(x2), k=k, r=r, tile=tile,
                                keep=keep, **mode)
    qbias = mode.get("qbias", False)
    _compare(kind, jres, _port_dists(tres, Q, qbias),
             tsp._pack_idbits(-(-n // tile) * tile), qbias=qbias,
             score16=mode.get("score16", False))


def test_qbias_clamps_near_zero_distances(rng):
    """Under qbias a distance that f32 rounding takes below zero becomes
    +0.0 (Gaussian queries equal to base rows: no score of the port is
    negative or -0.0, and both packages agree within a step); exact
    zeros rank by row id (integer data, three copies of a query: rows
    11, 2000, 3001 first, at 0.0, in both packages)."""
    n, d, nq = 5000, 16, 3
    kw = dict(k=5, r=14, tile=1024, keep=2, qbias=True)
    Xd = rng.standard_normal((n, d)).astype(np.float32) * 7.0
    Q = Xd[[11, 300, 4000]].copy()
    x2 = (Xd * Xd).sum(-1)
    js, ji, _ = _jax_scan(Q, Xd, x2, bq=4, **kw)
    ts, ti, _ = tsp.scan_topk_packed(_t(Q), _t(Xd), _t(x2), **kw)
    assert (ts >= 0).all() and not torch.signbit(ts).any()
    assert ti[:, 0].tolist() == [11, 300, 4000]
    assert_close_topk(js, ji, ts, ti, tsp._pack_idbits(n), atol=1e-3,
                      min_overlap=1.0)
    Xd = rng.integers(-3, 4, (n, d)).astype(np.float32)
    Q = Xd[[11, 300, 4000]].copy()
    Xd[2000], Xd[3001] = Q[0], Q[0]              # three copies of Q[0]
    x2 = (Xd * Xd).sum(-1)
    js, ji, _ = _jax_scan(Q, Xd, x2, bq=4, **kw)
    ts, ti, _ = tsp.scan_topk_packed(_t(Q), _t(Xd), _t(x2), **kw)
    assert ti[0, :3].tolist() == [11, 2000, 3001] == np.asarray(ji)[0, :3]\
        .tolist()
    assert (ts[0, :3] == 0.0).all() and (np.asarray(js)[0, :3] == 0.0).all()
    assert_tie_rule(js, ji, ts, ti)


def _planted(rng, n, nq, d, per):
    """Integer data with ``per`` queries whose two nearest rows share a
    pre-min window of 2 (lane 7, consecutive row ids of one tile): the
    window minimum drops one of them and the certificate flags them."""
    Xd = rng.integers(-3, 4, (n, d)).astype(np.float32) + 3.0
    Q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    for q in range(per):
        Xd[q * 1024 + 7] = Q[q]
        Xd[q * 1024 + 135] = Q[q]
        Xd[q * 1024 + 135, 0] += 1.0
    return Xd, (Xd * Xd).sum(-1), Q


@pytest.mark.parametrize("mode", [{}, dict(score16=True), dict(qbias=True)],
                         ids=["plain", "score16", "qbias"])
def test_premin_rescue_matches_jax(rng, mode):
    """The pre-min scan with its kernel rescue (`_premin_rescue`, 16 slots)
    == JAX ``_scan_premin_inline(nr=16)``: 20 planted same-window
    collisions flag 20 queries, the first 16 by index re-run at premin =
    0 and their flags clear, the 4 past the slots keep the lossy result
    and their flags; scores, ids and flags as the JAX package's."""
    n, d, nq, k = 24_576, 16, 24, 10
    Xd, x2, Q = _planted(rng, n, nq, d, per=20)
    kw = dict(k=k, r=14, tile=1024, keep=2, premin=1, **mode)
    lossy = tsp.scan_topk_packed(_t(Q), _t(Xd), _t(x2), **kw)[2]
    assert int(lossy.sum()) >= 20
    jres = jsp._scan_premin_inline(jnp.asarray(Q), jnp.asarray(Xd),
                                   jnp.asarray(x2), bq=8, stage=0, nr=16,
                                   interpret=True, **kw)
    tres = tsp._premin_rescue(
        lambda Qs, p: tsp.scan_topk_packed(Qs, _t(Xd), _t(x2),
                                           **dict(kw, premin=p)),
        _t(Q), 1, 16)
    qbias = mode.get("qbias", False)
    tres = _port_dists(tres, Q, qbias)
    np.testing.assert_array_equal(tres[2].numpy(), np.asarray(jres[2]))
    rest = np.nonzero(lossy.numpy())[0][16:]
    assert tres[2].numpy()[rest].all() and int(tres[2].sum()) == len(rest)
    _compare("int", jres, tres, tsp._pack_idbits(n), qbias=qbias,
             score16=mode.get("score16", False))


@pytest.mark.parametrize("mode", [dict(premin=1), dict(premin=2),
                                  dict(score16=True), dict(qbias=True),
                                  dict(premin=1, score16=True)],
                         ids=_mode_id)
def test_search_modes_match_jax(rng, mode, monkeypatch):
    """`scan.search` with each mode == the JAX ``search(interpret=True)``
    on integer data with planted pre-min collisions: the rescue's slots
    (16, both packages' constant shrunk) and `exact_rescan` behind them
    make every result the exact top-k of the mode's scores; the pre-min
    searches give the premin = 0 search's ids (and its scores, but for
    the queries `exact_rescan` served, which carry the untruncated
    ones)."""
    monkeypatch.setattr(jsp, "_PREMIN_NR", 16)
    monkeypatch.setattr(tsp, "_PREMIN_NR", 16)
    n, d, nq, k = 20_000, 16, 24, 10
    Xd, x2, Q = _planted(rng, n, nq, d, per=19)
    kw = dict(r=14, tile=1024, keep=2, **mode)
    jidx = jsp.LinscanIndex(jnp.asarray(Xd), jnp.asarray(x2))
    jd, ji = jsp.search(jidx, jnp.asarray(Q), k, interpret=True, pack=True,
                        bq=8, **kw)
    tidx = tsp.LinscanIndex(_t(Xd), _t(x2))
    td, ti = tsp.search(tidx, _t(Q), k, **kw)
    qbias = mode.get("qbias", False)
    if qbias:
        assert_close_topk(jd, ji, td, ti, tsp._pack_idbits(n), atol=0.0,
                          min_overlap=1.0)
    else:
        assert_tie_rule(jd, ji, td, ti)
    if mode.get("premin"):
        base = dict(mode, premin=0)
        d0, i0 = tsp.search(tidx, _t(Q), k, r=14, tile=1024, keep=2,
                            **{m: v for m, v in base.items()
                               if m not in ("r", "tile", "keep")})
        # the queries past the slots went to `exact_rescan`: their
        # distances are the untruncated ones, a step of the score (|s| up
        # to ~100 here) from the truncated
        assert torch.equal(ti, i0)
        assert_close_topk(d0, i0, td, ti, tsp._pack_idbits(n), atol=5e-3,
                          min_overlap=1.0)


def test_search_resolves_modes_as_jax(rng):
    """The front end's rules (JAX ``search``): qbias and score16 only with
    the packed scan, score16 drops under qbias, pack=False refuses an
    explicit premin, and ``bq`` / ``vmem_mb`` / ``interpret`` change
    nothing."""
    n, d, nq, k = 6000, 16, 8, 10
    Xd, x2, Q = _data(rng, "int", n, nq, d)
    tidx = tsp.LinscanIndex(_t(Xd), _t(x2))
    jidx = jsp.LinscanIndex(jnp.asarray(Xd), jnp.asarray(x2))

    def same(a, b):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    same(tsp.search(tidx, _t(Q), k, bq=7, vmem_mb=3, interpret=True),
         tsp.search(tidx, _t(Q), k))
    same(tsp.search(tidx, _t(Q), k, pack=False, qbias=True, score16=True),
         tsp.search(tidx, _t(Q), k, pack=False))
    both = tsp.search(tidx, _t(Q), k, qbias=True, score16=True)
    same(both, tsp.search(tidx, _t(Q), k, qbias=True))
    jb = jsp.search(jidx, jnp.asarray(Q), k, interpret=True, pack=True,
                    qbias=True, score16=True)
    assert_close_topk(jb[0], jb[1], both[0], both[1], tsp._pack_idbits(n),
                      atol=0.0, min_overlap=1.0)
    with pytest.raises(ValueError, match="premin"):
        tsp.search(tidx, _t(Q), k, pack=False, premin=1)
    with pytest.raises(ValueError, match="premin"):
        jsp.search(jidx, jnp.asarray(Q), k, interpret=True, pack=False,
                   premin=1)


def test_score16_drops_past_15_id_bits(rng):
    """score16 needs the padded base's row ids within 15 bits: past that
    (n > 2**22) `search` drops it silently, as the JAX package's does,
    and returns the default mode's result, while the scan refuses it."""
    n, d, nq, k = (1 << 22) + 1, 8, 2, 5
    Xd = rng.integers(-3, 4, (n, d)).astype(np.float32)
    Q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    Xt = torch.from_numpy(Xd)
    tidx = tsp.LinscanIndex(Xt, (Xt * Xt).sum(-1))
    got = tsp.search(tidx, _t(Q), k, score16=True)
    ref = tsp.search(tidx, _t(Q), k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="idbits <= 15"):
        tsp.scan_topk_packed(_t(Q), tidx.Xd, tidx.x2, k=k, r=16, tile=8192,
                             keep=2, score16=True)


def test_validation_errors_match_jax(rng):
    """The JAX validation (tests/test_scan_pallas.py:373, :749-761): a
    pre-min that leaves fewer than ``keep`` rows a tile, score16 with
    qbias; both packages raise."""
    Xd, x2, Q = _data(rng, "gauss", 9000, 4, 32)
    with pytest.raises(ValueError, match="premin"):
        _jax_scan(Q, Xd, x2, k=8, r=14, bq=4, tile=1024, keep=2, premin=3)
    with pytest.raises(ValueError, match="premin"):
        tsp.scan_topk_packed(_t(Q), _t(Xd), _t(x2), k=8, r=14, tile=1024,
                             keep=2, premin=3)
    with pytest.raises(ValueError, match="exclusive"):
        _jax_scan(Q, Xd, x2, k=4, r=14, bq=4, tile=1024, keep=2, qbias=True,
                  score16=True)
    with pytest.raises(ValueError, match="exclusive"):
        tsp.scan_topk_packed(_t(Q), _t(Xd), _t(x2), k=4, r=14, tile=1024,
                             keep=2, qbias=True, score16=True)
    with pytest.raises(ValueError, match="exclusive"):
        tsp.scan_candidates(_t(-2 * Q), _t(Xd), _t(x2), tile=1024, keep=2,
                            premin=0, idbits=7, q2=(_t(Q) ** 2).sum(-1),
                            score16=True)


def test_segmented_search_warns_and_keeps_qbias(rng, monkeypatch):
    """Beyond the packed row-id range (`_SEG_DECODED`, shrunk in both
    packages): an explicit premin or score16 warns with the JAX text and
    is dropped, qbias runs in every segment; the results equal the JAX
    segmented search's."""
    monkeypatch.setattr(jsp, "_SEG_DECODED", 4096)
    monkeypatch.setattr(tsp, "_SEG_DECODED", 4096)
    n, d, nq, k = 11_000, 16, 6, 12
    Xd, x2, Q = _data(rng, "int", n, nq, d)
    Xd = Xd + 2.0                       # non-negative scores per segment
    x2 = (Xd * Xd).sum(-1)
    tidx = tsp.LinscanIndex(_t(Xd), _t(x2))
    jidx = jsp.LinscanIndex(jnp.asarray(Xd), jnp.asarray(x2))
    kw = dict(r=14, tile=1024, keep=2)
    for mode in (dict(premin=1), dict(score16=True),
                 dict(premin=1, score16=True)):
        with pytest.warns(UserWarning, match="cannot run on the segmented "
                          "path and will be ignored") as tw:
            td, ti = tsp.search(tidx, _t(Q), k, **kw, **mode)
        with pytest.warns(UserWarning) as jw:
            jd, ji = jsp.search(jidx, jnp.asarray(Q), k, interpret=True,
                                pack=True, bq=8, **kw, **mode)
        assert str(tw[0].message) == str(jw[0].message)
        assert_tie_rule(jd, ji, td, ti)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        td, ti = tsp.search(tidx, _t(Q), k, qbias=True, **kw)
    jd, ji = jsp.search(jidx, jnp.asarray(Q), k, interpret=True, pack=True,
                        bq=8, qbias=True, **kw)
    assert_close_topk(jd, ji, td, ti, tsp._pack_idbits(4096), atol=0.0,
                      min_overlap=1.0)
