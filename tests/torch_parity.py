"""Comparison helpers for the parity tests of `rayuela_tpu_torch`
against `rayuela_tpu` (imported by the tests/test_torch_*.py files)."""

import numpy as np

LANES = 128


def assert_tie_rule(vals_a, ids_a, vals_b, ids_b):
    """Two top-k results of the same packed-key scan agree.

    The JAX package orders equal packed keys from different lanes (same
    truncated score, same per-lane row id) arbitrarily; the port orders
    them by lane. So per query: the truncated scores match exactly, the
    row ids ``gid >> 7`` match by position (equal keys), the gids match
    as sets within each group of equal key, and for the group that
    straddles position k only the member count (implied) is held."""
    va, vb = np.asarray(vals_a), np.asarray(vals_b)
    ia, ib = np.asarray(ids_a).astype(np.int64), np.asarray(ids_b)
    ib = ib.astype(np.int64)
    assert va.shape == vb.shape == ia.shape == ib.shape
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(ia >> 7, ib >> 7)
    k = va.shape[1]
    for q in range(va.shape[0]):
        grp = np.concatenate(
            [[0], np.cumsum((va[q, 1:] != va[q, :-1])
                            | ((ia[q, 1:] >> 7) != (ia[q, :-1] >> 7)))])
        last = grp[k - 1]
        for g in np.unique(grp[grp != last]):
            sel = grp == g
            assert sorted(ia[q, sel]) == sorted(ib[q, sel]), (q, g)
        assert len(set(ia[q].tolist())) == k
        assert len(set(ib[q].tolist())) == k


def assert_close_topk(vals_a, ids_a, vals_b, ids_b, idbits: int,
                      atol: float, min_overlap: float = 0.99):
    """Top-k results whose scores were summed in different orders: at
    least ``min_overlap`` of the ids agree as sets, and every score is
    within one truncation step (relative ``2**(idbits - 23)``) plus
    ``atol`` of the other result's score at the same position. ``atol``
    bounds the f32 rounding of the sums themselves, which matters where
    a score is near zero while its terms are not."""
    va, vb = np.asarray(vals_a), np.asarray(vals_b)
    ia, ib = np.asarray(ids_a), np.asarray(ids_b)
    assert va.shape == vb.shape == ia.shape == ib.shape
    step = 2.0 ** (idbits - 23)
    tol = step * np.maximum(np.abs(va), np.abs(vb)) + atol
    assert (np.abs(va - vb) <= tol).all(), np.abs(va - vb).max()
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ia, ib))
    assert hits >= min_overlap * ia.size, hits / ia.size


def int_dataset(rng, *, d, n, m, h, pq):
    """Small-integer codebooks and codes: every decoded value, dot
    product and norm is exact in f32, in both packages."""
    ds = -(-d // m) if pq else d
    C = rng.integers(-3, 4, (m, h, ds)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    return C, B


def gauss_dataset(rng, *, d, n, m, h, pq):
    ds = -(-d // m) if pq else d
    C = rng.standard_normal((m, h, ds)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    return C, B
