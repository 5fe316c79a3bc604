"""The deep top-k band of the port's plans against the JAX package on the
CPU: the packed searches at 8192 < k <= 12288 (r = 128, keep 4, tile
`scan._DEEP_TILE`: K8 / K1 / K5 → K2 at r = 128 → K3 at cap = 16384) and
the exact-float searches up to k = 6144 (the JAX f32 plan on the CPU; the
card's plan, r = 96 with the pair merge at r = 96, through the plain
versions), their routing beside the JAX package's cut, and the plain
versions of K2, K3 and the pair merge at those shapes against a sort.

The packed searches hold their ids to the JAX package's exact scan (and,
on a base small enough for interpret mode, to its `search`) under the
packed-key contract (one truncation step, tests/torch_parity.py); the
exact-float searches return the JAX exact scan's ids by position on
integer data, where every score is exact and ties order by id in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.search import linscan as jls
from rayuela_tpu.search import scan_codes_pallas as jsc
from rayuela_tpu.search import scan_pallas as jsp
from rayuela_tpu_torch.search import linscan as tls
from rayuela_tpu_torch.search import scan as tsp
from rayuela_tpu_torch.search import scan_codes as tsc
from tests.torch_parity import assert_close_topk

torch.set_num_threads(2)

LANES = tsp.LANES
# base rows, dimensions and queries of the searches: the deep band needs
# n well above k, so that few lane-tiles overflow the per-tile keep and
# the kernel plan, not the rescue, answers most queries
N, D, NQ = 400_000, 16, 4
K_DEEP, K_F32 = 9000, 4000


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    later tests' data depend on these)."""
    return np.random.default_rng(0)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("k", [8193, 10240, 12288, 12289])
def test_deep_band_routes_to_kernels_up_to_the_jax_cut(k):
    """8192 < k <= 12288 takes the kernel plan (r = 128, keep 4, the deep
    tile) in the decoded and both codes scans, k > 12288 the exact scans:
    the JAX package's cut (`scan_pallas.search`, `scan_codes_pallas.
    search_codes`: exact beyond 96 * 128), where its kernel plan is still
    r = 96 (`_auto_config`)."""
    assert tsp._MAX_K == 96 * jsp.LANES
    assert jsp._auto_config(tsp._MAX_K, 128, True)[0] * LANES >= tsp._MAX_K
    if k > tsp._MAX_K:
        assert tsc._codes_config(k)[0] == "lut"
        assert tsc._codes_config(k, "lut")[0] == "lut"
        return
    plan = tsp._scan_config(k)
    assert plan == (128, 4, tsp._DEEP_TILE)
    assert plan[0] in tsp._RS and plan[1] in tsp._KEEPS
    assert tsc._codes_config(k) == ("2p", *plan)
    assert tsc._codes_config(k, "lut", N) == ("2p", *plan)
    assert tsc._codes_config(k, "decode", N) == ("2p", *plan)
    rpad = 1 << (plan[0] - 1).bit_length()
    cap = min(1 << (k - 1).bit_length(), rpad * LANES)
    assert cap == 16384 and tsp._tail_layout(plan[0], cap)[0] == 1


@pytest.mark.parametrize("k", [3072, 3073, 4096, 6144, 6145])
def test_exact_float_plans_reach_the_jax_f32_plan(k):
    """The exact-float scans serve k up to 48 * 128 = 6144 by kernel on
    the card and on the CPU, the JAX f32 plan's reach (r = 48, tile 2048,
    keep 0: `scan_pallas._auto_config(pack=False)`); the card takes the
    packed plan's class, r = 96 with the pair merge at r = 96, beyond
    k = 3072."""
    jr = jsp._auto_config(k, 128, False)[0]
    card, cpu = tsp._f32_config(k, "cuda"), tsp._f32_config(k, "cpu")
    assert card[3] == cpu[3] == jr * LANES == 6144
    assert cpu[:3] == (jr, 0, 2048)
    served = k <= 6144
    for f32_on in ("cuda", "cpu"):
        kind = tsc._codes_config(k, "lut", N, f32_on)[0]
        assert kind == ("f32" if served else "lut")
    if served:
        assert card[:3] == ((48, 4, 8192) if k <= 3072 else (96, 4, 2048))
        assert card[0] in tsp._F32_RS and card[0] * LANES >= k


def test_plain_k2_at_r128_is_a_sort(rng):
    """`cand_merge_plain` at r = 128 over the deep plan's candidates (977
    tiles' runs of 4 at n = 1e6 cut to a few hundred): the 128 smallest
    keys of each (lane, query), ascending, then the least of the next key
    and every discard."""
    r, keep, ntiles, nq = 128, 4, 150, 3
    keys = rng.integers(-(1 << 30), 1 << 30, (ntiles, keep + 1, LANES, nq))
    keys = np.sort(keys, axis=1)
    cand = keys[:, :keep].reshape(ntiles * keep, LANES, nq).astype(np.int32)
    disc = keys[:, keep].astype(np.int32)
    out = tsp.cand_merge_plain(_t(cand), _t(disc), r).numpy()
    srt = np.sort(cand, axis=0)
    np.testing.assert_array_equal(out[:r], srt[:r])
    np.testing.assert_array_equal(out[r], np.minimum(srt[r], disc.min(0)))
    # the kernel wrapper takes the plain version on CPU tensors
    np.testing.assert_array_equal(
        tsp.cand_merge(_t(cand), _t(disc), r, cut=True).numpy(), out)


@pytest.mark.parametrize("r", [96, 128])
def test_plain_k3_at_cap16384_is_a_sort(rng, r):
    """`tail_merge_plain` at cap = 16384, the deep band's cap: every slot
    of every lane (r = 96 pads each lane's list with INT32_MAX to 128),
    in (key, lane) order, ties between lanes included."""
    nq, cap = 2, 16384
    keys = np.sort(rng.integers(-5000, 5000, (r, LANES, nq)), axis=0)
    keys = (keys * 1000).astype(np.int32)
    keys[r // 2:, 5] = tsp.IMAX
    got_k, got_l = tsp.tail_merge(_t(keys), cap)
    full = np.full((128, LANES, nq), tsp.IMAX, np.int64)
    full[:r] = keys
    comp = full * LANES + np.arange(LANES)[None, :, None]
    srt = np.sort(comp.reshape(128 * LANES, nq), axis=0).T
    np.testing.assert_array_equal(got_k.numpy(), srt >> 7)
    np.testing.assert_array_equal(got_l.numpy(), srt & (LANES - 1))


def test_plain_pair_merge_at_r96_is_a_sort(rng):
    """`pair_merge_plain` at r = 96: the 96 smallest (score, gid) pairs of
    each (lane, query), ascending, equal scores by gid, +inf candidates
    never taken (their slots stay (+inf, NOID))."""
    r, ncand, nq = 96, 300, 3
    v = rng.integers(0, 60, (ncand, LANES, nq)).astype(np.float32)
    v[rng.random(v.shape) < 0.1] = np.inf
    v[:, 7] = np.inf
    gid = np.broadcast_to(np.arange(ncand * LANES).reshape(ncand, LANES, 1),
                          v.shape).astype(np.int32)
    ov, oi = tsp.pair_merge(_t(v), _t(gid), r)
    order = np.lexsort((gid, v), axis=0)[:r]
    sv = np.take_along_axis(v, order, 0)
    si = np.take_along_axis(gid, order, 0)
    si = np.where(np.isinf(sv), tsp.NOID, si)
    np.testing.assert_array_equal(ov.numpy(), sv)
    np.testing.assert_array_equal(oi.numpy(), si)


def _idbits(n, tile):
    return tsp._pack_idbits(-(-n // tile) * tile)


def _assert_packed_contract(Q, jres, tres, atol=1e-4, min_overlap=0.99,
                            n=N):
    """The packed-key contract at the deep plan: the keys truncate the
    raw score (without +|q|^2) to one step of 2**(idbits - 23) of its
    magnitude, so both results are compared without |q|^2."""
    q2 = (Q.astype(np.float64) ** 2).sum(-1, keepdims=True)
    (jd, ji), (td, ti) = jres, tres
    assert_close_topk(np.asarray(jd) - q2, ji, td.numpy() - q2, ti,
                      _idbits(n, tsp._DEEP_TILE), atol=atol,
                      min_overlap=min_overlap)


def test_decoded_search_in_the_deep_band_matches_jax(rng):
    """`search` at k = 9000 over a decoded index (n = 4e5): the deep plan
    (K8 → K2 at r = 128 → K3 at cap = 16384, `exact_rescan` for flagged
    queries) answers most queries, and every query's top-k is the JAX
    package's exact scan's within one truncation step."""
    Xd = rng.standard_normal((N, D)).astype(np.float32)
    x2 = (Xd * Xd).sum(-1)
    Q = rng.standard_normal((NQ, D)).astype(np.float32)
    idx = tsp.LinscanIndex(_t(Xd), _t(x2))
    n2, n3 = tsp.cand_merge.launches, tsp.tail_merge.launches
    _, _, fl = tsp.search_flagged(idx.Xd, idx.x2, _t(Q), K_DEEP)
    assert int(fl.sum()) < NQ
    dv, di = tsp.search(idx, _t(Q), K_DEEP)
    jd, ji = jls.exact_rescan(jnp.asarray(Q), jnp.asarray(Xd),
                              jnp.asarray(x2), K_DEEP)
    _assert_packed_contract(Q, (jd, ji), (dv, di), min_overlap=0.999)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (tsp.cand_merge.launches, tsp.tail_merge.launches) == (n2, n3)


def test_decoded_search_in_the_deep_band_matches_jax_search(rng):
    """`search` at k = 9000 against the JAX package's `search` (its
    kernel plan at k = 9000, r = 96, in interpret mode) on a base of
    20,000 rows: both packed searches, both certified, within one
    truncation step of each other (equal id bits at this n)."""
    n = 20_000
    Xd = rng.standard_normal((n, D)).astype(np.float32)
    x2 = (Xd * Xd).sum(-1)
    Q = rng.standard_normal((NQ, D)).astype(np.float32)
    idx = tsp.LinscanIndex(_t(Xd), _t(x2))
    assert tsp._scan_config(K_DEEP)[0] == 128
    dv, di = tsp.search(idx, _t(Q), K_DEEP)
    jidx = jsp.LinscanIndex(jnp.asarray(Xd), jnp.asarray(x2))
    jd, ji = jsp.search(jidx, jnp.asarray(Q), K_DEEP, interpret=True,
                        pack=True)
    assert _idbits(n, jsp._auto_config(K_DEEP, NQ, True)[2]) == \
        _idbits(n, tsp._DEEP_TILE)
    _assert_packed_contract(Q, (jd, ji), (dv, di), n=n)


@pytest.mark.parametrize("mode", ["decode", "lut"])
def test_codes_search_in_the_deep_band_matches_jax(rng, mode):
    """`search_codes` at k = 9000 over a PQ-4 codes index (n = 4e5), in
    decode mode (K1 → K2 → K3) and LUT mode (K5 → K2 → K3), flagged
    queries through the LUT oracle: within one truncation step of the JAX
    package's exact scan over its own decode of the same codes."""
    m, h = 4, 256
    C = rng.standard_normal((m, h, D // m)).astype(np.float32)
    B = rng.integers(0, h, (N, m)).astype(np.int32)
    Q = rng.standard_normal((NQ, D)).astype(np.float32)
    cidx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=D)
    assert tsc._codes_config(K_DEEP, mode, N)[0] == "2p"
    dv, di = tsc.search_codes(cidx, _t(Q), K_DEEP, mode=mode)
    jidx = jsp.build_index(jnp.asarray(C), jnp.asarray(B), pq=True, d=D)
    jd, ji = jls.exact_rescan(jnp.asarray(Q), jidx.Xd, jidx.x2, K_DEEP)
    _assert_packed_contract(Q, (jd, ji), (dv, di))
    assert jsc._DECODE_SEG >= N       # one segment in both packages


def _int_index(rng):
    Xd = rng.integers(-3, 4, (N, D)).astype(np.float32)
    Q = rng.integers(-3, 4, (NQ, D)).astype(np.float32)
    return Xd, (Xd * Xd).sum(-1), Q


@pytest.mark.parametrize("plan", ["cpu", "card"])
def test_exact_float_search_at_k4000_matches_jax(rng, plan):
    """`search(pack=False)` at k = 4000 over an f32 index of integer rows:
    the CPU's plan (the JAX f32 plan, r = 48, keep 0) and the card's
    (r = 96, keep 4, tile 2048: K9's per-tile cut → the pair merge at
    r = 96 → K10) through the plain versions, each the JAX package's
    exact scan by position, ties by id."""
    Xd, x2, Q = _int_index(rng)
    idx = tsp.LinscanIndex(_t(Xd), _t(x2))
    kw = {} if plan == "cpu" else dict(zip(
        ("r", "keep", "tile"), tsp._f32_config(K_F32, "cuda")[:3]))
    assert plan == "cpu" or kw == dict(r=96, keep=4, tile=2048)
    _, _, fl = tsp.search_flagged(idx.Xd, idx.x2, _t(Q), K_F32, pack=False,
                                  **kw)
    assert int(fl.sum()) < NQ
    dv, di = tsp.search(idx, _t(Q), K_F32, pack=False, **kw)
    jd, ji = jls.exact_rescan(jnp.asarray(Q), jnp.asarray(Xd),
                              jnp.asarray(x2), K_F32)
    np.testing.assert_array_equal(di.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(dv.numpy(), np.asarray(jd))
    ed, ei = tls.exact_rescan(_t(Q), idx.Xd, idx.x2, K_F32)
    assert torch.equal(di, ei) and torch.equal(dv, ed)


def test_exact_float_lut_search_at_k4000_matches_jax(rng):
    """`search_codes(mode="lut", pack=False)` at k = 4000 with f32 tables
    over integer PQ-4 codebooks (every table sum exact): the CPU plan and
    the card's (K6 → the pair merge at r = 96 → K7) through the plain
    versions, each the JAX package's exact scan by position."""
    m, h = 4, 64
    C = rng.integers(-3, 4, (m, h, D // m)).astype(np.float32)
    B = rng.integers(0, h, (N, m)).astype(np.int32)
    Q = rng.integers(-3, 4, (NQ, D)).astype(np.float32)
    cidx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=D)
    jidx = jsp.build_index(jnp.asarray(C), jnp.asarray(B), pq=True, d=D)
    jd, ji = jls.exact_rescan(jnp.asarray(Q), jidx.Xd, jidx.x2, K_F32)
    for kw in ({}, dict(r=96, keep=4, tile=2048)):
        dv, di = tsc.search_codes(cidx, _t(Q), K_F32, mode="lut",
                                  pack=False, **kw)
        np.testing.assert_array_equal(di.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(dv.numpy(), np.asarray(jd))
