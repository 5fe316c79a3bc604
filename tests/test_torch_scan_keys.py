"""Packed selection keys and the cross-lane merge of `rayuela_tpu_torch`
against `rayuela_tpu.search.scan_pallas` (CPU: the port's plain
versions, the JAX package's interpret-mode kernel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.search import scan_pallas as jsp
from rayuela_tpu_torch.search import scan as tsp
from tests.torch_parity import assert_tie_rule

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """A generator of each test's own. The suite's shared one is
    advanced by every test that draws from it, which would make the data
    of the tests that run later in the same process depend on these."""
    return np.random.default_rng(0)


IMAX = np.iinfo(np.int32).max


def _special_scores(rng):
    s = rng.standard_normal(4000).astype(np.float32) * 100
    extra = np.array([0.0, -0.0, np.inf, -1e-30, 1e-30, -1.0, 1.0,
                      3.4e38, -3.4e38], np.float32)
    return np.concatenate([s, extra])


def test_keys_bit_identical(rng):
    s = _special_scores(rng)
    kj = np.asarray(jsp._sortable_key(jnp.asarray(s)))
    kt = tsp._sortable_key(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(kt, kj)
    assert kt[np.where(np.signbit(s) & (s == 0))[0][0]] < \
        kt[np.where(~np.signbit(s) & (s == 0))[0][0]]       # -0.0 < +0.0
    back = tsp._unsortable_key(torch.from_numpy(kt)).numpy()
    np.testing.assert_array_equal(back.view(np.int32), s.view(np.int32))
    for idbits in (4, 8, 13, 16):
        vj = np.asarray(jsp._decode_packed_vals(jnp.asarray(kj), idbits,
                                                False))
        vt = tsp._decode_packed_vals(torch.from_numpy(kt), idbits).numpy()
        np.testing.assert_array_equal(vt, vj)


@pytest.mark.parametrize("npad", [128, 256, 2048, 8192, 20480, 1 << 20,
                                  (1 << 23), (1 << 23) + 128])
def test_pack_idbits_matches(npad):
    assert tsp._pack_idbits(npad) == jsp._pack_idbits(True, npad)


def test_row_key_bit_identical(rng):
    rows, nq, idbits, t = 16, 5, 11, 3
    s = rng.standard_normal((rows * 128, nq)).astype(np.float32)
    s[::97] = np.inf
    s[5, :] = -0.0
    kj = np.asarray(jsp._row_key(jnp.asarray(s), t, rows=rows, bq=nq,
                                 idbits=idbits))
    kt = tsp._row_key(torch.from_numpy(s), t, rows=rows,
                      idbits=idbits).numpy()
    np.testing.assert_array_equal(kt, kj)


def _sorted_lane_keys(rng, r, nqp):
    """Kernel-invariant inputs of tests/test_scan_pallas.py:512:
    per-lane ascending, unique keys, some never-filled buffer tails."""
    keys = np.empty((r, 128, nqp), np.int32)
    for q in range(nqp):
        vals = rng.choice(1 << 22, size=r * 128, replace=False)
        vals = (vals.astype(np.int64) << 9) - (1 << 30)
        keys[:, :, q] = np.sort(vals.astype(np.int32).reshape(r, 128),
                                axis=0)
    keys[r // 2:, 3, 0] = IMAX
    keys[r // 2:, 77, 4] = IMAX
    return np.sort(keys, axis=0)


# the interpret-mode tail kernel costs seconds per call on the CPU, so
# it runs on the three smallest configurations; the XLA selection on all
_INTERPRET = {(5, 17, 9), (3, 384, 8), (2, 100, 7)}
_jit_candidates = jax.jit(jsp._packed_candidates, static_argnums=(1, 2, 3, 4))


@pytest.mark.parametrize("r,k,idbits", [
    (1, 1, 4), (2, 100, 7), (14, 100, 13), (28, 1000, 13), (28, 1, 13),
    (6, 500, 10), (5, 17, 9), (3, 384, 8), (16, 2048, 13)])
def test_packed_candidates_match_jax(rng, r, k, idbits):
    nq, nqp = 9, 128
    keys = _sorted_lane_keys(rng, r, nqp)
    got = tsp._packed_candidates(torch.from_numpy(keys), nq, r, k, idbits)
    got = [g.numpy() for g in got]
    refs = [_jit_candidates(jnp.asarray(keys), nq, r, k, idbits)]
    if (r, k, idbits) in _INTERPRET:
        refs.append(jsp._tail_candidates_pallas(
            jnp.asarray(keys), nq, r, k, idbits, interpret=True))
    for ref in refs:
        ref = [np.asarray(x) for x in ref]
        np.testing.assert_array_equal(got[2], ref[2])          # tau
        fin = np.isfinite(ref[0]) & np.isfinite(got[0])
        # keys are unique except the injected INT32_MAX tails
        np.testing.assert_array_equal(got[0][fin], ref[0][fin])
        np.testing.assert_array_equal(got[1][fin], ref[1][fin])
        assert (np.isfinite(got[0]) == np.isfinite(ref[0])).all()


def test_packed_candidates_cross_lane_ties(rng):
    """Equal packed keys in several lanes (tests/test_scan_pallas.py:549):
    no duplicate ids, no tied id lost, and the same result as the JAX
    interpret-mode tail kernel under the tie rule."""
    r, k, idbits = 6, 64, 8
    nq, nqp = 4, 128
    keys = np.empty((r, 128, nqp), np.int32)
    for q in range(nqp):
        vals = rng.choice(1 << 20, size=r * 128, replace=False)
        vals = (vals.astype(np.int64) << 9) - (1 << 28)
        keys[:, :, q] = np.sort(vals.astype(np.int32).reshape(r, 128),
                                axis=0)
    slot = np.arange(r, dtype=np.int32)[:, None, None]
    keys = (keys & np.int32(-1 << idbits)) | slot
    tie_key = np.int32(-(1 << 29) & (-1 << idbits))
    tie_lanes = [5, 77, 12, 100, 31, 64]
    for ln in tie_lanes:
        keys[0, ln, :] = tie_key
    vals, ids, _ = tsp._packed_candidates(torch.from_numpy(keys), nq, r, k,
                                          idbits)
    for q in range(nq):
        got = ids[q].tolist()
        assert len(set(got)) == k
        assert set(tie_lanes) <= set(got)
    # the port orders the tie group by gid
    assert ids[0, :len(tie_lanes)].tolist() == sorted(tie_lanes)
    jv, ji, _ = jsp._tail_candidates_pallas(jnp.asarray(keys), nq, r, k,
                                            idbits, interpret=True)
    assert_tie_rule(jv, ji, vals, ids)


def test_tail_merge_plain_orders_by_key_then_lane(rng):
    r, nq, cap = 5, 3, 64
    keys = np.sort(rng.integers(-50, 50, (r, 128, nq)).astype(np.int32),
                   axis=0)
    k, ln = tsp.tail_merge(torch.from_numpy(keys), cap)
    flat = keys.reshape(r * 128, nq).T.astype(np.int64)
    lane = np.tile(np.arange(128), r)
    comp = np.sort(flat * 128 + lane[None], axis=1)[:, :cap]
    np.testing.assert_array_equal(k.numpy(), comp >> 7)
    np.testing.assert_array_equal(ln.numpy(), comp & 127)
    with pytest.raises(ValueError):
        tsp.tail_merge(torch.from_numpy(keys), 48)          # not pow2
