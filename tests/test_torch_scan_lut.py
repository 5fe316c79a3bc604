"""LUT-mode code scan of `rayuela_tpu_torch` against
`rayuela_tpu.search.scan_codes_pallas` on the CPU: the port's plain
version of kernel K5 against the JAX `pallas_scan_codes_topk` run in
interpret mode (``pack=True``, ``tail=False``), and `search_codes(
mode="lut")` around it.

Both packages sum a row's table entries in f32 in codebook order, the
norms table last, so from one table stack the results are equal under
the tie rule (tests/torch_parity.py) and the flags are equal, on integer
and on Gaussian data, with f32 and with bf16 tables. Through
`search_codes` each package builds its own tables, whose f32 sums differ
in order: integer data compares under the tie rule, Gaussian data to one
truncation step."""

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


def _data(rng, kind, pq, n, m=M):
    mk = int_dataset if kind == "int" else gauss_dataset
    C, B = mk(rng, d=D, n=n, m=m, h=H, pq=pq)
    ncb = nco = None
    if not pq:
        ncb = (rng.integers(0, 60, 12) if kind == "int"
               else rng.random(12) * 40).astype(np.float32)
        nco = rng.integers(0, 12, n).astype(np.int32)
    return C, B, ncb, nco


def _queries(rng, nq, kind):
    if kind == "int":
        return rng.integers(-3, 4, (nq, D)).astype(np.float32)
    return rng.standard_normal((nq, D)).astype(np.float32)


def _indexes(C, B, pq, ncb, nco):
    jidx = jsc.build_codes_index(
        jnp.asarray(C), jnp.asarray(B), pq=pq, d=D,
        norms_cbook=None if pq else jnp.asarray(ncb),
        norms_codes=None if pq else jnp.asarray(nco))
    tidx = tsc.build_codes_index(
        _t(C), _t(B), pq=pq, d=D, norms_cbook=None if pq else _t(ncb),
        norms_codes=None if pq else _t(nco))
    return jidx, tidx


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,pq,m", [("int", True, 4), ("int", False, 4),
                                       ("gauss", True, 4),
                                       ("gauss", False, 7),
                                       ("gauss", False, 28)])
@pytest.mark.parametrize("keep,r", [(2, 14), (4, 28)])
def test_lut_scan_matches_jax(rng, kind, pq, m, keep, r, dtype):
    """K5's plain version + K2 + K3 (`scan_codes_topk`) == JAX
    `pallas_scan_codes_topk(pack=True)` on the same tables: equal scores
    and flags, ids under the tie rule; n ragged against the tile, m' = 5,
    8 and 29 (one, two and eight code words)."""
    n, nq, k = 5000, 16, 40
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    C, B, ncb, nco = _data(rng, kind, pq, n, m)
    Q = _queries(rng, nq, kind)
    jidx, tidx = _indexes(C, B, pq, ncb, nco)
    np.testing.assert_array_equal(tidx.packed.numpy(),
                                  np.asarray(jidx.packed))
    T = jsc.build_luts(jnp.asarray(C), jnp.asarray(Q), pq=pq, d=D,
                       norms_cbook=None if pq else jnp.asarray(ncb))
    js, ji, jf = jsc.pallas_scan_codes_topk(
        T, jidx.packed, k=k, r=r, bq=8, tile=1024, interpret=True,
        lut_dtype=jdt, pack=True, keep=keep, tail=False)
    ts, ti, tf = tsc.scan_codes_topk(_t(T), tidx.packed, k=k, r=r,
                                     tile=1024, keep=keep, lut_dtype=tdt)
    assert_tie_rule(js, ji, ts, ti)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_lut_scan_equals_the_lut_oracle_unless_flagged(rng):
    """`scan_codes_topk` against the plain gather-accumulate oracle
    `lut_scan`: unflagged queries carry the oracle's top-k, truncated."""
    n, nq, k = 5000, 12, 30
    C, B, ncb, nco = _data(rng, "gauss", False, n)
    T = tsc.build_luts(_t(C), _t(_queries(rng, nq, "gauss")),
                       norms_cbook=_t(ncb))
    packed = tsc.pack_codes(_t(B), _t(nco))
    s, i, fl = tsc.scan_codes_topk(T, packed, k=k, r=16, tile=1024, keep=2,
                                   lut_dtype=torch.float32)
    Bn = torch.cat([_t(B), _t(nco)[:, None]], 1)
    s0, i0 = tsc.lut_scan(T, Bn, k)
    ok = ~fl
    assert int(ok.sum()) >= nq - 2
    assert_close_topk(s0[ok], i0[ok], s[ok], i[ok],
                      tsp._pack_idbits(5120), atol=1e-4)


def test_lut_candidates_argument_checks(rng):
    C, B, ncb, nco = _data(rng, "int", False, 600)
    T = tsc.build_luts(_t(C), _t(_queries(rng, 2, "int")),
                       norms_cbook=_t(ncb))
    packed = tsc.pack_codes(_t(B), _t(nco))
    kw = dict(tile=1024, keep=2, idbits=3)
    with pytest.raises(ValueError, match="ceil"):
        tsc.codes_lut_candidates(T, packed[:, :1].contiguous(), **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tsc.codes_lut_candidates(T.double(), packed, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tsc.codes_lut_candidates(T.permute(0, 2, 1).contiguous()
                                 .permute(0, 2, 1), packed, **kw)
    with pytest.raises(ValueError, match="keep=16"):
        tsc.codes_lut_candidates(T, packed, tile=1024, keep=16, idbits=3)
    with pytest.raises(ValueError, match="power of two"):
        tsc.codes_lut_candidates(T, packed, tile=384, keep=2, idbits=3)
    with pytest.raises(ValueError, match="r\\*128"):
        tsc.scan_codes_topk(T, packed, k=3000, r=16)
    with pytest.raises(ValueError, match="no one-pass"):
        tsc.scan_codes_topk(T, packed, k=5, r=16, keep=0)
    cand, disc = tsc.codes_lut_candidates(T, packed, **kw)
    assert cand.shape == (2, 128, 2) and disc.shape == (1, 128, 2)
    assert cand.dtype == disc.dtype == torch.int32


def test_codes_config_lut_plan():
    """Both modes of the codes scan take the decoded scan's classes,
    each a variant the kernels are compiled for, and leave the kernels
    beyond them."""
    for k in (1, 100, 512, 513, 1000, 2048, 2049, 3072, 3073, tsp._MAX_K):
        kind, r, keep, tile = tsc._codes_config(k)
        assert kind == "2p" and (r, keep, tile) == tsp._scan_config(k)
        assert r in tsp._RS and keep in tsp._KEEPS and k <= r * 128
        assert keep <= tile // 128
    assert tsc._codes_config(tsp._MAX_K + 1)[0] == "lut"
    assert tsp._MAX_K <= tsp._RS[-1] * 128
    # tiles that keep fewer than k candidates: no two-pass scan
    assert tsc._codes_config(5000, "decode", 5000) == ("1p", 48, 0, 2048)
    assert tsc._codes_config(5000, "lut", 5000)[0] == "lut"
    assert tsc._codes_config(7000, "decode", 7000)[0] == "lut"
    assert tsc._codes_config(5000, "decode", 20_000)[0] == "2p"


def _assert_same_up_to_ties(da, ia, db, ib):
    """Exact integer scores, some queries served by an oracle whose
    top-k orders equal scores arbitrarily: the dists are equal, and the
    ids equal as sets within every group of equal dist but the one that
    may straddle position k."""
    da, db = np.asarray(da), np.asarray(db)
    ia, ib = np.asarray(ia), np.asarray(ib)
    np.testing.assert_array_equal(da, db)
    for q in range(da.shape[0]):
        inner = da[q] != da[q, -1]
        assert sorted(ia[q, inner]) == sorted(ib[q, inner]), q
        assert len(set(ib[q].tolist())) == ib.shape[1]


@pytest.mark.parametrize("kind,pq,n,k", [
    ("int", True, 20_000, 25), ("int", False, 20_000, 25),
    ("int", True, 5_000, 5_050), ("gauss", False, 20_000, 600),
    ("gauss", True, 9_000, 3_500)])
def test_search_codes_lut_mode_matches_jax(rng, kind, pq, n, k):
    """`search_codes(mode="lut")` == JAX `search_codes(mode="lut")`
    (interpret, packed keys, f32 tables): n ragged against every tile,
    additive with the norms byte, the r = 32 class, and a k beyond the
    kernel plan (the LUT oracle). k > n clamps to every row once; the
    JAX LUT plan has no buffer that deep, so its oracle `xla_lut_scan`
    is the reference there."""
    nq = 6
    C, B, ncb, nco = _data(rng, kind, pq, n)
    Q = _queries(rng, nq, kind)
    jidx, tidx = _indexes(C, B, pq, ncb, nco)
    q2 = (Q * Q).sum(-1, keepdims=True)
    if k > n:
        T = jsc.build_luts(jnp.asarray(C), jnp.asarray(Q), pq=pq, d=D)
        jd, ji = jsc.xla_lut_scan(T, jnp.asarray(B), k)
        jd = np.asarray(jd) + q2
    else:
        jd, ji = jsc.search_codes(jidx, jnp.asarray(Q), k, interpret=True,
                                  pack=True, lut_dtype=jnp.float32,
                                  mode="lut")
    td, ti = tsc.search_codes(tidx, _t(Q), k, mode="lut")
    assert td.shape == (nq, min(k, n)) and ti.dtype == torch.int32
    if kind == "int":
        # flagged queries take each package's oracle, whose top-k orders
        # equal scores in its own way
        _assert_same_up_to_ties(jd, ji, td, ti)
    else:
        # one truncation step is relative to the raw score (without
        # +|q|^2). Table entries reach ~40: f32 sums of 32 products
        # round at ~40 * 2**-23 * sqrt(32) < 3e-5 per entry, 5 entries
        # per score
        assert_close_topk(np.asarray(jd) - q2, ji, td.numpy() - q2, ti,
                          tsp._pack_idbits(24576), atol=2e-4)


def test_lut_mode_repairs_a_flagged_query(rng):
    """A lane overflowed with exact ties of one query: K5's certificate
    flags it, and the LUT oracle repairs it; the result equals decode
    mode's (whose rescue is K4) to one truncation step of the raw score
    (the oracle's scores are not truncated, K4's are), with at least 90%
    of the ids shared: integer scores tie, and a tie that straddles
    position k may keep other members."""
    n, k = 2048, 32
    C, B = int_dataset(rng, d=D, n=n, m=M, h=H, pq=True)
    best = rng.integers(0, H, M).astype(np.int32)
    for t in range(16):
        B[t * 128] = best                     # lane-0 pileup for q0
    from rayuela_tpu_torch.ops.qerror import reconstruct_pq
    Q = reconstruct_pq(_t(C), _t(B), D).numpy()[0:1]
    Q = _t(np.concatenate([Q, _queries(rng, 3, "int")]))
    idx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=D)
    T = tsc.build_luts(idx.C, Q, pq=True, d=D)
    fl = tsc.scan_codes_topk(T, idx.packed, k=k, r=16, keep=2,
                             lut_dtype=torch.float32)[2]
    assert bool(fl[0])
    dl, il = tsc.search_codes(idx, Q, k, mode="lut")
    dd, id_ = tsc.search_codes(idx, Q, k)
    assert set(range(0, 2048, 128)) <= set(il[0].tolist())
    assert set(range(0, 2048, 128)) <= set(id_[0].tolist())
    q2 = (Q * Q).sum(-1, keepdim=True)
    assert_close_topk(dd - q2, id_, dl - q2, il, tsp._pack_idbits(2048),
                      atol=1e-6, min_overlap=0.9)


@pytest.mark.parametrize("mode", ["decode", "lut"])
def test_segmented_codes_search(rng, monkeypatch, mode):
    """A base beyond the packed row-id range (here: a shrunk
    `_DECODE_SEG`) runs per segment with an exact merge, in both modes:
    the same distances as the one-call search on integer data (ids may
    permute among ties, which the segment merge orders by segment)."""
    n, nq, k = 20_000, 6, 25
    C, B, ncb, nco = _data(rng, "int", False, n)
    Q = _t(_queries(rng, nq, "int"))
    _, idx = _indexes(C, B, False, ncb, nco)
    d0, i0 = tsc.search_codes(idx, Q, k, mode=mode)
    monkeypatch.setattr(tsc, "_DECODE_SEG", 8192)
    d1, i1 = tsc.search_codes(idx, Q, k, mode=mode)
    assert sorted(idx._segments) == [0, 8192, 16384]
    assert idx._segments[16384].n == n - 16384
    # the segments' keys keep more score bits than the one-call keys
    step = 2.0 ** (tsp._pack_idbits(24576) - 23)
    raw = d0 - (Q * Q).sum(-1, keepdim=True)
    assert bool(((d1 - d0).abs() <= step * raw.abs() + 1e-6).all())
    assert all(len(set(r.tolist())) == k for r in i1)
    # every returned id scores its reported distance (LUT oracle)
    s_all, i_all = tsc.lut_scan(
        tsc.build_luts(idx.C, Q, norms_cbook=idx.norms_cbook),
        tsc.unpack_codes(idx.packed, idx.mprime), n)
    by_id = torch.empty_like(s_all).scatter_(1, i_all.long(), s_all)
    own = by_id.gather(1, i1.long())
    raw1 = d1 - (Q * Q).sum(-1, keepdim=True)
    assert bool(((own - raw1).abs() <= step * own.abs() + 1e-6).all())
    # and nothing better was left out
    assert bool((own.amax(1) <= s_all[:, k - 1] + step * s_all[:, k - 1]
                 .abs()).all())
