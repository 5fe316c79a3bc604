"""The cross-lane merge at the deep plan classes against
`rayuela_tpu.search.scan_pallas._packed_candidates` (CPU: the port's plain
version, the JAX package's jitted XLA selection), and the host-side
layouts of the card's K3 and K9/K10 (`scan._tail_layout`,
`scan._exact_layout`, `scan._exact_grid`) for every plan class."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.search import scan_pallas as jsp
from rayuela_tpu_torch.search import scan as tsp

torch.set_num_threads(2)

IMAX = np.iinfo(np.int32).max
SMEM_CAP = 232448          # dynamic shared memory of one H100 CTA


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    later tests' data depend on these)."""
    return np.random.default_rng(0)


def _sorted_lane_keys(rng, r, nqp):
    """Per-lane ascending, unique keys with some lanes' tails never
    filled (INT32_MAX), as a scan's key buffer holds them."""
    keys = np.empty((r, 128, nqp), np.int32)
    for q in range(nqp):
        vals = rng.choice(1 << 22, size=r * 128, replace=False)
        vals = (vals.astype(np.int64) << 9) - (1 << 30)
        keys[:, :, q] = vals.astype(np.int32).reshape(r, 128)
    keys[r // 2:, 3, 0] = IMAX
    keys[r // 3:, 77, 4] = IMAX
    return np.sort(keys, axis=0)


_jit_candidates = jax.jit(jsp._packed_candidates, static_argnums=(1, 2, 3, 4))


@pytest.mark.parametrize("r,k,idbits", [(32, 1000, 13), (48, 1000, 11),
                                        (96, 4096, 11)])
def test_deep_packed_candidates_match_jax(rng, r, k, idbits):
    """The classes `test_torch_scan_keys` leaves out: the k = 1000 plan
    (r = 32), the rescue's buffer (r = 48) and the deepest plan (r = 96,
    k = 4096, where a lane's list is 128 slots, 32 of them padding)."""
    nq, nqp = 9, 128
    keys = _sorted_lane_keys(rng, r, nqp)
    got = [g.numpy() for g in tsp._packed_candidates(torch.from_numpy(keys),
                                                     nq, r, k, idbits)]
    ref = [np.asarray(x) for x in _jit_candidates(jnp.asarray(keys), nq, r,
                                                  k, idbits)]
    np.testing.assert_array_equal(got[2], ref[2])                # tau
    fin = np.isfinite(ref[0]) & np.isfinite(got[0])
    np.testing.assert_array_equal(got[0][fin], ref[0][fin])
    np.testing.assert_array_equal(got[1][fin], ref[1][fin])
    assert (np.isfinite(got[0]) == np.isfinite(ref[0])).all()


def _plan_tails():
    """The (r, cap) pairs K3 meets: every packed plan class
    (`_scan_config`) at the k that open and close it, the rescue's r = 48
    at the same k, and the deepest cap."""
    out = set()
    for k in (1, 100, 512, 513, 1000, 2048, 2049, 3072, 3073, 4096, 8192,
              8193, 12288):
        rs = (tsp._scan_config(k)[0], 48)
        for r in rs:
            rpad = 1 << max(0, (r - 1).bit_length())
            out.add((r, min(1 << max(0, (k - 1).bit_length()),
                            rpad * tsp.LANES)))
    return sorted(out)


@pytest.mark.parametrize("r,cap", _plan_tails())
def test_tail_layout_fits_every_plan_class(r, cap):
    """K3's layout at each class: cap / 1024 warps a query (at least one),
    at most 4 queries and 256 threads a CTA, or one query's 16 warps at
    cap = 16384, as many queries as fit; a CTA's regions fit its shared
    memory, a query's region holds its staged lists or its sort (8 bytes
    a survivor) and its offsets, and is 16 bytes past a multiple of 128
    (the queries of a load meet distinct banks); the grid covers any
    query count."""
    qb, threads, lr, qbytes, smem = tsp._tail_layout(r, cap)
    wq = max(1, cap // 1024)
    most = max(256, 32 * wq)
    assert qb in (1, 2, 4) and threads == 32 * wq * qb <= most <= 512
    assert lr == min(tsp._tail_shape(r, cap), r)
    assert max(4 * 128 * lr, 8 * cap) + 4 * 129 + 16 <= qbytes
    assert qbytes % 128 == 16 and smem == qb * qbytes <= SMEM_CAP
    assert qb == 4 or 2 * qb * qbytes > SMEM_CAP or 64 * wq * qb > most
    for nq in (1, max(1, qb - 1), qb + 1, 10_000):
        grid = -(-nq // qb)
        assert grid * qb >= nq > (grid - 1) * qb


def test_tail_layout_refuses_what_does_not_fit():
    """cap = 16384 (all 128 slots of every lane at r = 96 or 128) is the
    deepest the plans ask for (`_MAX_K` = 12288): one query a CTA of 16
    warps. A deeper cap (32768, 32 warps, a 256 KB sort) exceeds a CTA's
    threads and shared memory, and the layout says so with 0 queries per
    CTA."""
    assert tsp._MAX_K == 12288
    assert tsp._tail_layout(96, 8192)[0] == 1
    assert tsp._tail_layout(96, 16384)[:2] == (1, 512)
    assert tsp._tail_layout(128, 16384)[:2] == (1, 512)
    assert tsp._tail_layout(256, 32768)[0] == 0


@pytest.mark.parametrize("dp", [8, 128, 256, 960, 2400])
@pytest.mark.parametrize("keep", [2, 4])
@pytest.mark.parametrize("bf16", [0, 1])
def test_exact_layout_fits_every_plan_class(dp, keep, bf16):
    """K9's and K10's layout at any width: the stages of two CTAs fit an
    SM's shared memory (228 KB, 1 KB of it reserved per CTA), a thread
    owns queries of one lane (256 threads), a row's dimensions take whole
    stages, and for every class of the card's f32 plan the grid covers
    the queries, the 128 lanes and the rows."""
    lay = tsp._exact_layout(keep, bf16)
    qb, lc, qt, rg, kc, stages, smem = lay
    assert 2 * (smem + 1024) <= 233472 and lc * qb // qt == 256
    assert tsp._exact_layout(0, bf16) == lay          # K10's is K9's
    assert -(-dp // kc) * kc >= dp and dp % 8 == 0 and kc % 8 == 0
    ob = 2 if bf16 else 4
    assert smem == stages * (rg * lc * (ob * kc + 16) + qb * (4 * kc + 16))
    for k in (100, 1000, 3072):
        r, kp, tile, _ = tsp._f32_config(k, "cuda")
        assert kp in (2, 4) and tile // 128 <= 256
        for n in (1, 8191, 20_001, 1_000_000):
            for nq in (1, 63, 64, 65, 10_000):
                gx, gy, gz = tsp._exact_grid(n, nq, tile, lay)
                assert gx * qb >= nq > (gx - 1) * qb
                assert gy * lc == 128
                assert gz * tile >= n > (gz - 1) * tile and gz < 1 << 16


def test_exact_layout_refuses_other_keeps():
    with pytest.raises(ValueError, match="keep"):
        tsp._exact_layout(3, 0)
