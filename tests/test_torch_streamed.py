"""The streamed searches of `rayuela_tpu_torch` (the base stays in host
memory and goes through the device shard by shard) against the JAX
package's and against the port's own resident searches, on the CPU.

On the CPU the shard feed hands out host slices: the same loop as on
the card without the side stream, whose copies cannot run here. Data are
small integers, so every score is exact in both packages. Against the
port's resident search everything compares by position: both order by
(score, id). The JAX f32 kernels order equal scores arbitrarily, so
against JAX the scores compare exactly and the ids as sets within groups
of equal score but the last (`_assert_f32_tie_rule`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu import api as japi
from rayuela_tpu.search import scan_codes_pallas as jsc
from rayuela_tpu.search import scan_pallas as jsp
from rayuela_tpu_torch import api as tapi
from rayuela_tpu_torch import convert
from rayuela_tpu_torch.search import scan as tsp
from rayuela_tpu_torch.search import scan_codes as tsc
from tests.test_torch_scan_f32 import _assert_f32_tie_rule
from tests.torch_parity import int_dataset

torch.set_num_threads(2)

D, M, H = 24, 4, 32


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    the data depend on the tests that ran before)."""
    return np.random.default_rng(0)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _case(rng, pq, n, nq=7):
    C, B = int_dataset(rng, d=D, n=n, m=M, h=H, pq=pq)
    Q = rng.integers(-3, 4, (nq, D)).astype(np.float32)
    ncb = nco = None
    if not pq:
        ncb = rng.integers(0, 60, H).astype(np.float32)
        nco = rng.integers(0, H, n).astype(np.int32)
    packed = tsc.pack_codes(_t(B), None if nco is None else _t(nco)).numpy()
    return C, B, Q, ncb, nco, packed


@pytest.mark.parametrize("pq", [True, False])
def test_search_codes_streamed_lut_f32_matches_jax_and_resident(rng, pq):
    """Four uneven shards (3 x 1500 + 400 rows), ``mode="lut"``,
    ``pack=False``: the JAX streamed search under the tie rule, the
    port's resident search by position; the codes stay a numpy array."""
    n, k = 4900, 30
    C, B, Q, ncb, nco, packed = _case(rng, pq, n)
    mp = M + (not pq)
    jd, ji = jsc.search_codes_streamed(
        jnp.asarray(C), packed, jnp.asarray(Q), k, pq=pq, d=D,
        norms_cbook=None if pq else jnp.asarray(ncb), mprime=mp,
        shard_n=1500, interpret=True, mode="lut", pack=False, bq=8,
        lut_dtype=jnp.float32)
    kw = dict(pq=pq, d=D, norms_cbook=None if pq else _t(ncb), mprime=mp)
    td, ti = tsc.search_codes_streamed(_t(C), packed, _t(Q), k, shard_n=1500,
                                       mode="lut", pack=False, **kw)
    _assert_f32_tie_rule(jd, ji, td, ti, exact=True)
    idx = tsc.CodesIndex(_t(packed), mp, _t(C), pq=pq, d=D,
                         norms_cbook=kw["norms_cbook"])
    rd, ri = tsc.search_codes(idx, _t(Q), k, mode="lut", pack=False)
    assert torch.equal(ti, ri) and torch.equal(td, rd)
    assert ti.dtype == torch.int32 and td.shape == (7, k)


def _assert_within_a_step(d, ref, Q, rows):
    """Packed scans return scores cut to the key's step, 2**(idbits -
    23) of the raw score (without +|q|^2), idbits the row-id width of a
    base padded to ``rows`` rows per lane."""
    q2 = (_t(Q) ** 2).sum(-1, keepdim=True)
    step = 2.0 ** ((rows - 1).bit_length() - 23)
    d, ref = _t(d), _t(ref)
    assert bool(((d - ref).abs() <= step * (ref - q2).abs() + 1e-6).all())


@pytest.mark.parametrize("mode", ["decode", "lut"])
def test_search_codes_streamed_packed_modes_serve_the_resident_result(rng,
                                                                      mode):
    """The default (packed) scans streamed in 3 uneven shards: the
    dists are the exact integer dists of the LUT oracle cut to each
    shard's truncation step (64 row ids per lane at the port's tile), as
    the resident search's and the JAX streamed search's (interpret,
    packed keys, f32 operands) are; every id scores its dist; ids may
    differ among equal scores (the packed order is the shard's own)."""
    n, k = 4000, 25
    C, B, Q, ncb, nco, packed = _case(rng, False, n)
    jd, _ = jsc.search_codes_streamed(
        jnp.asarray(C), packed, jnp.asarray(Q), k, d=D,
        norms_cbook=jnp.asarray(ncb), mprime=M + 1, shard_n=1700,
        interpret=True, mode=mode, pack=True, lut_dtype=jnp.float32)
    td, ti = tsc.search_codes_streamed(_t(C), packed, _t(Q), k, d=D,
                                       norms_cbook=_t(ncb), mprime=M + 1,
                                       shard_n=1700, mode=mode)
    idx = tsc.CodesIndex(_t(packed), M + 1, _t(C), pq=False, d=D,
                         norms_cbook=_t(ncb))
    rd, _ = tsc.search_codes(idx, _t(Q), k, mode=mode)
    Bn = _t(np.concatenate([B, nco[:, None]], 1))
    T = tsc.build_luts(_t(C), _t(Q), norms_cbook=_t(ncb))
    s_all, i_all = tsc.lut_scan(T, Bn, n)
    q2 = (_t(Q) ** 2).sum(-1, keepdim=True)
    exact = s_all[:, :k] + q2
    for got in (td, rd, jd):
        _assert_within_a_step(got, exact, Q, 64)
    by_id = torch.empty_like(s_all).scatter_(1, i_all.long(), s_all)
    _assert_within_a_step(td, by_id.gather(1, ti.long()) + q2, Q, 64)
    assert all(len(set(r.tolist())) == k for r in ti)


def test_search_codes_streamed_memmap_and_k_beyond_the_last_shard(rng,
                                                                  tmp_path):
    """The codes as an ``np.memmap`` over a file; k = 300 is larger than
    the last shard (100 rows), which then gives all its rows; the index
    whose codes are swapped per shard serves each shard's own size."""
    n, k = 3100, 300
    C, B, Q, _, _, packed = _case(rng, True, n)
    path = tmp_path / "codes.i32"
    packed.tofile(path)
    mm = np.memmap(path, dtype=np.int32, mode="r", shape=packed.shape)
    td, ti = tsc.search_codes_streamed(_t(C), mm, _t(Q), k, pq=True, d=D,
                                       shard_n=1000, mode="lut", pack=False)
    idx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=D)
    rd, ri = tsc.search_codes(idx, _t(Q), k, mode="lut", pack=False)
    assert torch.equal(ti, ri) and torch.equal(td, rd)
    # k beyond the whole base clamps to every row once
    td, ti = tsc.search_codes_streamed(_t(C), mm, _t(Q), n + 50, pq=True,
                                       d=D, shard_n=1000)
    assert td.shape == (7, n) and sorted(ti[0].tolist()) == list(range(n))
    assert bool((td[:, 1:] >= td[:, :-1]).all())


def test_shard_feed_and_swap(rng):
    """`_ShardFeed` on the CPU hands out each shard's rows in order, and
    `CodesIndex.swap_packed` serves the new shard's size with the operand
    cache kept."""
    packed = rng.integers(0, 1 << 20, (2500, 2)).astype(np.int32)
    bounds = [(0, 1000), (1000, 2000), (2000, 2500)]
    feed = tsc._ShardFeed(packed, bounds, torch.device("cpu"))
    for j, (a, b) in enumerate(bounds):
        pk = feed.wait(feed.start(j))
        assert pk.dtype == torch.int32 and pk.is_contiguous()
        np.testing.assert_array_equal(pk.numpy(), packed[a:b])
    C, B = int_dataset(rng, d=D, n=300, m=M, h=H, pq=True)
    idx = tsc.build_codes_index(_t(C), _t(B), pq=True, d=D)
    ops = idx.decode_operands(D, torch.float32)
    idx._segments[0] = "stale"
    idx.swap_packed(tsc.pack_codes(_t(B[:120])))
    assert idx.n == 120 and not idx._segments
    assert idx.decode_operands(D, torch.float32) is ops


@pytest.mark.parametrize("pq,norms", [(True, False), (False, True)])
def test_search_streamed_decoded_matches_jax_and_resident(rng, pq, norms):
    """`scan.search_streamed` (decode a shard, search, release, merge)
    in 4 uneven shards with ``pack=False``: the JAX `search_streamed`
    (interpret mode, which is its f32 scan) under the tie rule, the
    port's resident f32 search by position; the codes and norm terms
    stay numpy arrays."""
    n, k = 4900, 30
    C, B, Q, ncb, nco, _ = _case(rng, pq, n)
    nt = None if not norms else ncb[nco]
    jd, ji = jsp.search_streamed(
        jnp.asarray(C), B, jnp.asarray(Q), k, pq=pq, d=D,
        norm_term=nt, shard_size=1500, interpret=True)
    td, ti = tsp.search_streamed(_t(C), B, _t(Q), k, pq=pq, d=D,
                                 norm_term=nt, shard_size=1500, pack=False)
    _assert_f32_tie_rule(jd, ji, td, ti, exact=True)
    idx = tsp.build_index(_t(C), _t(B), pq=pq, d=D,
                          norm_term=None if nt is None else _t(nt))
    rd, ri = tsp.search(idx, _t(Q), k, pack=False)
    assert torch.equal(ti, ri) and torch.equal(td, rd)
    # the packed scan streamed: the same dists cut to a truncation step
    pd, pi = tsp.search_streamed(_t(C), B, _t(Q), k, pq=pq, d=D,
                                 norm_term=nt, shard_size=1500)
    _assert_within_a_step(pd, rd, Q, 64)
    assert pi.dtype == torch.int32


def test_api_search_streamed_rotates_opq_queries(rng):
    """`api.search_streamed` with an OPQ model: the queries are rotated
    by R as in `api.search`; == the JAX facade's streamed search (tie
    rule) and the port's resident `api.search` on the same codes (by
    position), ``mode="lut"``, ``pack=False``, 3 shards."""
    n, k = 3000, 20
    C, B, Q, _, _, packed = _case(rng, True, n)
    # a signed permutation: an exact rotation of integer queries
    perm = rng.permutation(D)
    R = np.zeros((D, D), np.float32)
    R[np.arange(D), perm] = rng.choice([-1.0, 1.0], D)
    jmodel = japi.MCQModel("opq", jnp.asarray(C), R=jnp.asarray(R), h=H)
    jd, ji = japi.search_streamed(jmodel, packed, jnp.asarray(Q), k,
                                  shard_n=1100, mode="lut", pack=False,
                                  bq=8)
    model = convert.model_from_arrays("opq", C, R=R, h=H, device="cpu")
    td, ti = tapi.search_streamed(model, packed, Q, k, shard_n=1100,
                                  mode="lut", pack=False)
    _assert_f32_tie_rule(jd, ji, td, ti, exact=True)
    index = convert.index_from_arrays(model, B, None, None, d=D)
    rd, ri = tapi.search(index, Q, k, mode="lut", pack=False)
    assert torch.equal(ti, ri) and torch.equal(td, rd)
    # without the rotation the result is another one
    ud, _ = tsc.search_codes_streamed(_t(C), packed, _t(Q), k, pq=True, d=D,
                                      shard_n=1100, mode="lut", pack=False)
    assert not torch.equal(ud, td)
