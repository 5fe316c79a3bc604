"""K2 (`scan.cand_merge`) on the CPU: what its card kernel rests on, and
the two-pass scan at the plan's deepest class against
`rayuela_tpu.search.scan_codes_pallas.pallas_scan_codes_decode_topk_2p`
run in interpret mode.

The kernel reads its candidates as runs of ``ncand / ndisc`` rows, each
ascending per (lane, query), and with ``cut`` reads a discard only where
its whole run entered the buffer: that holds where ``disc[t]`` is never
below run t's last key, as the per-tile cut of K1, K8 and K5 writes it.
A one-pass split's certificate has no such bound, so its merges pass
``cut=False``. Here the plain versions of the three candidates kernels
are held to that contract, a split's certificate is shown to lie below
its r-th key, and each caller is held to the flag it states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.search import scan_codes_pallas as jsc
from rayuela_tpu_torch.search import scan as tsp
from rayuela_tpu_torch.search import scan_codes as tsc
from tests.torch_parity import assert_tie_rule, gauss_dataset, int_dataset

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    later tests' data depend on these)."""
    return np.random.default_rng(0)


D, M, H = 32, 4, 16


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _codes_case(rng, n, nq, kind="gauss"):
    """RVQ-4+1 codes (norms byte) of n rows and nq queries → (index, -2Q
    f32 operand, decode operands)."""
    mk = int_dataset if kind == "int" else gauss_dataset
    C, B = mk(rng, d=D, n=n, m=M, h=H, pq=False)
    ncb = (rng.integers(0, 60, 12) if kind == "int"
           else rng.random(12) * 40).astype(np.float32)
    nco = rng.integers(0, 12, n).astype(np.int32)
    idx = tsc.build_codes_index(_t(C), _t(B), pq=False, d=D,
                                norms_cbook=_t(ncb), norms_codes=_t(nco))
    Q = (rng.integers(-3, 4, (nq, D)) if kind == "int"
         else rng.standard_normal((nq, D))).astype(np.float32)
    Cf, nrm = idx.decode_operands(D, torch.float32)
    return idx, _t(Q), tsc._query_operand(_t(Q), Cf.shape[1],
                                          torch.float32), Cf, nrm


def _assert_cut_runs(cand, disc, keep):
    """Runs of ``keep`` rows ascending per (lane, query), and each
    discard at least its run's last key."""
    runs = cand.reshape(disc.shape[0], keep, *cand.shape[1:])
    assert bool((runs[:, 1:] >= runs[:, :-1]).all())
    assert bool((disc >= runs[:, -1]).all())


@pytest.mark.parametrize("keep", [2, 4])
def test_candidates_kernels_write_ascending_runs_above_their_discards(rng,
                                                                      keep):
    """The statement `cut=True` makes, on the plain versions of K1, K8
    and K5 (which the kernels equal bit for bit on the card), without
    the pre-min, n ragged against the tile, on Gaussian data."""
    n, nq, tile = 9000, 6, 2048
    idx, Q, Qm, Cf, nrm = _codes_case(rng, n, nq)
    idbits = tsp._pack_idbits(-(-n // tile) * tile)
    kw = dict(tile=tile, keep=keep, idbits=idbits)
    _assert_cut_runs(*tsc.codes_decode_candidates_plain(
        Qm, Cf, nrm, idx.packed, has_norms=True, **kw), keep)
    codes = tsc.unpack_codes(idx.packed, idx.mprime)
    Xd, x2 = tsp.decode_base(idx.C, codes[:, :-1],
                             norm_term=idx.norms_cbook[codes[:, -1].long()])
    _assert_cut_runs(*tsp.scan_candidates_plain(
        tsp._query_operand(Q, D, torch.float32), Xd, x2, premin=0, **kw),
        keep)
    T = tsc.build_luts(idx.C, Q, norms_cbook=idx.norms_cbook)
    _assert_cut_runs(*tsc.codes_lut_candidates_plain(
        T.contiguous(), idx.packed, **kw), keep)


def test_a_onepass_splits_certificate_can_lie_below_its_rth_key(rng):
    """K14's splits (a per-tile cut of keep = 2 carried over a tile
    range): a tile that holds more than `keep` of a lane's r smallest
    sends the rest to the certificate, below the split's r-th key, so
    the merge of the splits reads every certificate (`cut=False`); it
    still equals the one-pass buffer over the whole base. K4's splits
    (keep = 0) keep the (r + 1)-th key, never below."""
    n, nq, r, keep, tile = 32_768, 4, 14, 2, 2048
    idx, Q, Qm, Cf, nrm = _codes_case(rng, n, nq)
    idbits = tsp._pack_idbits(n)
    kw = dict(r=r, idbits=idbits, has_norms=True)
    half = (idx.packed[:n // 2], idx.packed[n // 2:])
    splits = [tsc.codes_decode_onepass_plain(Qm, Cf, nrm, p, tile=tile,
                                             keep=keep, **kw) for p in half]
    # the second half's row ids restart at 0: lift them past the first's
    s1 = splits[1]
    s1[s1 < tsp.IMAX] += n // 2 // tsp.LANES
    cert = torch.stack([s[r] for s in splits])
    assert bool((cert < torch.stack([s[r - 1] for s in splits])).any())
    whole = tsc.codes_decode_onepass_plain(Qm, Cf, nrm, idx.packed,
                                           tile=tile, keep=keep, **kw)
    cand = torch.cat([s[:r] for s in splits])
    assert torch.equal(tsp.cand_merge(cand, cert.contiguous(), r), whole)
    o4 = tsc.codes_decode_topk_plain(Qm, Cf, nrm, idx.packed, tile=tile,
                                     r=48, idbits=idbits, has_norms=True)
    assert bool((o4[48] >= o4[47]).all())


def test_each_caller_states_its_flag(rng, monkeypatch):
    """The two-pass scans (decoded, codes by decoding, codes by tables)
    merge with `cut=True`, the decoded scan with a pre-min and the
    one-pass splits with `cut=False`; `cut` needs whole runs."""
    n, nq, k = 5000, 3, 20
    idx, Q, Qm, Cf, nrm = _codes_case(rng, n, nq)
    seen = []
    real = tsp.cand_merge

    def spy(cand, disc, r, cut=False):
        seen.append(cut)
        return real(cand, disc, r, cut)
    monkeypatch.setattr(tsp, "cand_merge", spy)
    monkeypatch.setattr(tsc, "cand_merge", spy)
    tsc.scan_codes_decode_topk_2p(Q, Cf, nrm, idx.packed, k=k, pq=False,
                                  r=16, keep=2)
    T = tsc.build_luts(idx.C, Q, norms_cbook=idx.norms_cbook)
    tsc.scan_codes_topk(T, idx.packed, k=k, r=16, keep=2,
                        lut_dtype=torch.float32)
    codes = tsc.unpack_codes(idx.packed, idx.mprime)
    Xd, x2 = tsp.decode_base(idx.C, codes[:, :-1],
                             norm_term=idx.norms_cbook[codes[:, -1].long()])
    tsp.scan_topk_packed(Q, Xd, x2, k=k, r=16, keep=2)
    tsp.scan_topk_packed(Q, Xd, x2, k=k, r=16, keep=2, premin=1)
    cand = torch.full((2 * 48, tsp.LANES, nq), tsp.IMAX, dtype=torch.int32)
    disc = torch.full((2, tsp.LANES, nq), tsp.IMAX, dtype=torch.int32)
    tsp._merge_onepass(None, cand, disc, 48)
    assert seen == [True, True, True, False, False]
    with pytest.raises(ValueError, match="multiple of ndisc"):
        real(cand[:95].contiguous(), disc, 48, cut=True)
    assert [tsp._merge_runs(*a) for a in (
        (8, 2, True), (246, 123, True), (96, 2, True), (28, 2, False),
        (95, 2, False), (7, 0, False), (0, 5, True))] == [
        (4, True), (2, True), (4, False), (2, False), (1, False),
        (1, False), (4, False)]


def test_deep_plan_two_pass_scan_matches_jax(rng):
    """K1 + K2 + K3 at the plan's deepest class (r = 96, keep = 4, tile =
    2048: the k = 4096 plan) == JAX `pallas_scan_codes_decode_topk_2p`
    in interpret mode on integer data, with more candidates than the
    96-deep buffer (30 tiles, 120 a lane)."""
    n, nq, k = 60_000, 8, 1500
    idx, Q, Qm, Cf, nrm = _codes_case(rng, n, nq, kind="int")
    jCf, jnrm = jsc.build_decode_operands(
        jnp.asarray(idx.C.numpy()), pq=False, d=D,
        norms_cbook=jnp.asarray(idx.norms_cbook.numpy()),
        op_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(jCf), Cf.numpy())
    js, ji, jf = jsc.pallas_scan_codes_decode_topk_2p(
        jnp.asarray(Q.numpy()), jCf, jnrm, jnp.asarray(idx.packed.numpy()),
        k=k, pq=False, r=96, bq=8, tile=2048, keep=4, keep2=0, rows2=32,
        interpret=True, op_dtype=jnp.float32)
    ts, ti, tf = tsc.scan_codes_decode_topk_2p(Q, Cf, nrm, idx.packed, k=k,
                                               pq=False, r=96, tile=2048,
                                               keep=4)
    assert_tie_rule(js, ji, ts, ti)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
