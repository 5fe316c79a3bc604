"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where torch sees no CUDA device, and
run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest imports jax, which the
port and these tests do not need).

On small-integer data every score is exact in f32, so kernel and plain
version must give identical int32 outputs. In bf16 on Gaussian data the
kernel sums in another order than cuBLAS: at least 99% of the ids agree
and every score moves by at most one truncation step. The encode kernels
K11 (ICM sweeps) and K13 (Viterbi) are held the same way: identical
codes (and K11's energies) on {-1, 0, 1} data; on Gaussian data at least
99% of codes equal, K11's mean energy within 1e-4 relative and K13's
chain energies within 1e-5 relative (+ 1e-3 absolute). K5 (the LUT
scan) adds table values in the plain version's order, so it is identical
on any data. The exact-float kernels (K9, K10 on a decoded base; K6,
K7 on tables; the pair merge) give identical pairs and counts on integer
data, and K6/K7 on any data; on Gaussian data K9's scores are within
1e-5 relative (+ 5e-5) of the plain version's with at least 99.9% of ids
equal by position. Training on the card is reproducible: two runs from one
seed give bitwise-equal codebooks. A CUDA tensor never takes a plain
version: where the kernels cannot build, the call raises."""

import numpy as np
import pytest
import torch

import rayuela_tpu_torch.api as tapi
from rayuela_tpu_torch.kernels.build import query
from rayuela_tpu_torch.ops import icm as ticm
from rayuela_tpu_torch.ops import viterbi as tvit
from rayuela_tpu_torch.ops.qerror import veccost_chunked
from rayuela_tpu_torch.search import scan as tsp
from rayuela_tpu_torch.search import scan_codes as tsc

pytestmark = pytest.mark.cuda

D, H = 128, 256


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, *, pq, kind, dtype, n, nq, seed=0):
    rng = np.random.default_rng(seed)
    m = 8 if pq else 7
    ds = D // m if pq else D
    if kind == "int":
        C = rng.integers(-2, 3, (m, H, ds)).astype(np.float32)
        Q = rng.integers(-3, 4, (nq, D)).astype(np.float32)
        ncb = rng.integers(0, 500, H).astype(np.float32)
    else:
        C = rng.standard_normal((m, H, ds)).astype(np.float32)
        Q = rng.standard_normal((nq, D)).astype(np.float32)
        ncb = (rng.random(H) * 1000).astype(np.float32)
    B = rng.integers(0, H, (n, m)).astype(np.int32)
    nco = None if pq else rng.integers(0, H, n).astype(np.int32)
    t = lambda a: None if a is None else torch.as_tensor(a, device=dev)
    idx = tsc.build_codes_index(t(C), t(B), pq=pq, d=D,
                                norms_cbook=None if pq else t(ncb),
                                norms_codes=t(nco))
    Cf, nrm = idx.decode_operands(D, dtype)
    Qt = t(Q)
    return idx, Qt, Cf, nrm, tsc._query_operand(Qt, Cf.shape[1], dtype)


def _close(got, ref, idbits, atol=0.0):
    (gv, gi), (rv, ri) = got, ref
    step = 2.0 ** (idbits - 23)
    tol = step * torch.maximum(gv.abs(), rv.abs()) + atol
    worst = float(((gv - rv).abs() - tol).max())
    assert worst <= 0, f"a score is {worst} beyond one truncation step"
    same = float((gi == ri).float().mean())
    assert same >= 0.99, f"only {same} of ids equal by position"


@pytest.mark.parametrize("pq", [True, False])
@pytest.mark.parametrize("keep,r", [(2, 16), (4, 32)])
def test_two_pass_kernels_equal_plain_on_integer_data(dev, pq, keep, r):
    n, nq = 20_000, 40                 # n ragged against the tile
    idx, Q, Cf, nrm, Qm = _case(dev, pq=pq, kind="int",
                                dtype=torch.float32, n=n, nq=nq)
    idbits = tsp._pack_idbits(-(-n // 8192) * 8192)
    kw = dict(tile=8192, keep=keep, idbits=idbits, has_norms=not pq)
    n1, n2 = tsc.codes_decode_candidates.launches, tsc.cand_merge.launches
    cand, disc = tsc.codes_decode_candidates(Qm, Cf, nrm, idx.packed, **kw)
    cand0, disc0 = tsc.codes_decode_candidates_plain(Qm, Cf, nrm,
                                                     idx.packed, **kw)
    torch.cuda.synchronize()
    assert torch.equal(cand, cand0) and torch.equal(disc, disc0)
    out = tsc.cand_merge(cand, disc, r)
    assert torch.equal(out, tsc.cand_merge_plain(cand, disc, r))
    assert tsc.codes_decode_candidates.launches == n1 + 1
    assert tsc.cand_merge.launches == n2 + 1
    rows = out[:r].contiguous()
    for cap in (128, 1024, 4096 if r == 32 else 2048):
        n3 = tsp.tail_merge.launches
        a, b = tsp.tail_merge(rows, cap), tsp.tail_merge_plain(rows, cap)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert tsp.tail_merge.launches == n3 + 1


# the (r, cap) classes the plans give K3: the packed plans' r = 16 / 32 /
# 48 / 96 with cap = next_pow2(k) up to 8192, and the rescue's r = 48
TAIL_CLASSES = [(16, 128), (16, 2048), (32, 1024), (32, 4096), (48, 128),
                (48, 1024), (48, 8192), (96, 4096), (96, 8192)]


def _tail_rows(dev, r, nq, seed=0):
    """Per-lane ascending keys ``(r, 128, nq)`` int32 from a narrow range,
    so that equal keys meet in different lanes (and within a lane), with
    some lanes' tails padded with INT_MAX, as K2 leaves a lane that
    found fewer than r rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(-4 * r, 4 * r, (r, 128, nq), generator=g,
                         device=dev, dtype=torch.int32) * 1000
    keys[r // 2:, 3] = tsp.IMAX
    keys[1:, 77, ::3] = tsp.IMAX
    keys[:, 100] = tsp.IMAX
    return keys.sort(dim=0).values.contiguous()


@pytest.mark.parametrize("r,cap", TAIL_CLASSES)
@pytest.mark.parametrize("nq", ["1", "qb-1", "qb+1", "10000"])
def test_tail_merge_equals_plain_at_every_plan_class(dev, r, cap, nq):
    """K3 against its plain version bit for bit at each (r, cap) class,
    at a query count of 1, one less and one more than the kernel's query
    block, and the main path's 10,000: ties between lanes, duplicates
    within a lane and INT_MAX tails included."""
    qb = tsp._tail_layout(r, cap)[0]
    nq = {"1": 1, "qb-1": max(1, qb - 1), "qb+1": qb + 1, "10000": 10_000}[nq]
    rows = _tail_rows(dev, r, nq)
    n3 = tsp.tail_merge.launches
    a = tsp.tail_merge(rows, cap)
    b = tsp.tail_merge_plain(rows, cap)
    torch.cuda.synchronize()
    assert tsp.tail_merge.launches == n3 + 1
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("r,cap", TAIL_CLASSES + [(14, 128), (96, 16384)])
def test_tail_layout_is_the_kernels(dev, r, cap):
    """K3's layout comes from its source (`rq_tail_layout`), and
    `scan._tail_layout` states it; a cap whose run buffers do not fit
    one CTA raises rather than launch."""
    L0 = tsp._tail_shape(r, cap)
    py = tsp._tail_layout(r, cap)
    if not py[0]:
        with pytest.raises(RuntimeError, match="rq_tail_layout"):
            query("rq_tail_layout", r, cap, L0, size=5, device=dev)
        with pytest.raises(ValueError, match="cap"):
            tsp.tail_merge(_tail_rows(dev, r, 2), cap)
        return
    assert query("rq_tail_layout", r, cap, L0, size=5, device=dev) == py


ONEPASS_NQ = (1, 2, 5, 15, 16, 17, 33, 128)


@pytest.mark.parametrize("nq", ONEPASS_NQ)
@pytest.mark.parametrize("d", [128, 960])
@pytest.mark.parametrize("pq", [True, False])
@pytest.mark.parametrize("mprime", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rescue_kernel_equals_plain_on_integer_data(dev, nq, d, pq, mprime,
                                                    dtype):
    """K4 against its plain version: identical int32 buffers at 1 to 128
    queries (the last block of 32 or 16 queries cut short where nq is
    not a multiple), rows of one d-block and of eight
    (d = 960), both norm branches, 8 and 16 packed bytes a row, f32 and
    bf16 operands (small integers are exact in both); then K3 on them."""
    n = 20_000
    m = mprime if pq else mprime - 1
    idx, Q, Cf, nrm, Qm = _wide_codes_case(dev, pq=pq, kind="int",
                                           dtype=dtype, n=n, nq=nq, d=d, m=m)
    idbits = tsp._pack_idbits(-(-n // 2048) * 2048)
    kw = dict(tile=2048, r=48, idbits=idbits, has_norms=not pq)
    n4 = tsc.codes_decode_topk.launches
    out = tsc.codes_decode_topk(Qm, Cf, nrm, idx.packed, **kw)
    torch.cuda.synchronize()
    assert tsc.codes_decode_topk.launches == n4 + 1
    assert torch.equal(out, tsc.codes_decode_topk_plain(Qm, Cf, nrm,
                                                        idx.packed, **kw))
    rows = out[:48].contiguous()
    a, b = tsp.tail_merge(rows, 8192), tsp.tail_merge_plain(rows, 8192)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dp,nw", [(128, 2), (1024, 2), (128, 4),
                                   (2432, 2)])
def test_rescue_layout_is_the_kernels(dev, dp, nw):
    """K4's and K8's keep=0 layouts come from their source: 32 queries x 8
    lanes a CTA where two such CTAs fit an SM, else 16 x 16 (f32 rows at
    dp = 1024, any row at d ~2400); the queries whole and the 32 rows of a
    step at one d-block, at the operand type with 16 bytes of padding a
    row, their norms and codes in shared memory; K4 on bf16 (the
    tensor-core score) also the step's products (qb rows of 40 floats),
    the queries' margins, the norms of the rows' values and, at one
    d-block, a second step's rows and norms and 64 qb requests for the
    fmaf chain (an int and a 16-bit item each). K8 on bf16 takes the
    same score function, so the same layout as K4."""
    cap = getattr(torch.cuda.get_device_properties(dev),
                  "shared_memory_per_block_optin", 232_448)   # H100: 227 KB
    db = dp if dp <= 256 else 128

    def smem(qb, words, ob, mma):
        pad = 16 // ob
        return ob * (qb * (dp + pad) + 32 * (db + pad)) + 4 * 32 \
            + 4 * 32 * words + (4 * (qb * 41 + 32) if mma else 0) \
            + (ob * 32 * (dp + pad) + 4 * 32 + 6 * 64 * qb
               if mma and dp <= 256 else 0)

    for bf16 in (0, 1):
        ob = 2 if bf16 else 4
        for name, words, lay in (
                ("K4", nw, tsc._rescue_layout(dp, nw, 48, bf16, dev)),
                ("K8", 0, tsp._topk_layout(dp, 48, bf16, dev))):
            mma = bool(bf16)
            qb = 32 if smem(32, words, ob, mma) <= (cap - 1024) // 2 else 16
            assert lay[:2] == (qb, 256 // qb), (name, dp, bf16)
            assert lay[3:] == (db, smem(qb, words, ob, mma)), (name, dp, bf16)
            assert lay[2] == (2 if qb == 32 else
                              min(2, (cap + 1024) // (lay[4] + 1024))), \
                (name, dp, bf16)
    assert tsc._rescue_layout(128, 2, 48, 1, dev)[:3] == (32, 8, 2)
    assert tsc._rescue_layout(1024, 2, 48, 1, dev)[:3] == (32, 8, 2)
    with pytest.raises(RuntimeError, match="rq_codes_topk_layout"):
        tsc._rescue_layout(128, 2, 32, 1, dev)


@pytest.mark.parametrize("nq", [1, 8, 33, 128, 1259])
def test_rescue_launches_its_layout(dev, monkeypatch, nq):
    """The wrappers of K4 and K8 (keep=0) launch the queries per CTA of
    their layout entry and the row split `scan._onepass_rows` makes of
    it, and the buffers of a split launch merge to the plain ones."""
    n = 50_000
    idx, Q, Cf, nrm, Qm = _case(dev, pq=False, kind="int",
                                dtype=torch.bfloat16, n=n, nq=nq)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    idbits = tsp._pack_idbits(-(-n // 2048) * 2048)
    seen = []
    real = tsc.launch

    def spy(name, *args, **kw):
        seen.append((name, args))
        return real(name, *args, **kw)
    monkeypatch.setattr(tsc, "launch", spy)
    monkeypatch.setattr(tsp, "launch", spy)
    kw = dict(tile=2048, r=48, idbits=idbits)
    out = tsc.codes_decode_topk(Qm, Cf, nrm, idx.packed, has_norms=True,
                                **kw)
    assert torch.equal(out, tsc.codes_decode_topk_plain(
        Qm, Cf, nrm, idx.packed, has_norms=True, **kw))
    lay = tsc._rescue_layout(128, idx.packed.shape[1], 48, 1, dev)
    nrows, rows_per = tsp._onepass_rows(n, nq, 2048, 48, lay, 128, sms)
    (name, args), rest = seen[0], seen[1:]
    assert name == "rq_codes_decode_topk"
    assert args[13:16] == (nrows, rows_per, lay[0])
    assert [nm for nm, _ in rest] == (["rq_cand_merge"] if rows_per < nrows
                                      else [])
    seen.clear()
    codes = tsc.unpack_codes(idx.packed, idx.mprime)
    Xf, x2 = tsp.decode_base(idx.C, codes[:, :-1],
                             norm_term=idx.norms_cbook[codes[:, -1].long()])
    Xd = Xf.to(torch.bfloat16)
    out8 = tsp.scan_onepass(Qm, Xd, x2, premin=0, **kw)
    assert torch.equal(out8, tsp.scan_onepass_plain(Qm, Xd, x2, premin=0,
                                                    **kw))
    lay = tsp._topk_layout(128, 48, 1, dev)
    nrows, rows_per = tsp._onepass_rows(n, nq, 2048, 48, lay, 128, sms)
    assert seen[0][0] == "rq_scan_onepass"
    assert seen[0][1][8:11] == (nrows, rows_per, lay[0])


@pytest.mark.parametrize("pq", [True, False])
def test_bf16_scans_within_one_truncation_step(dev, pq):
    n, nq, k = 50_000, 64, 100
    idx, Q, Cf, nrm, Qm = _case(dev, pq=pq, kind="gauss",
                                dtype=torch.bfloat16, n=n, nq=nq)
    idbits = tsp._pack_idbits(-(-n // 8192) * 8192)
    kw = dict(tile=8192, keep=2, idbits=idbits, has_norms=not pq)
    s, i, _ = tsc.scan_codes_decode_topk_2p(Q, Cf, nrm, idx.packed, k=k,
                                            pq=pq, r=16, keep=2)
    o0 = tsc.cand_merge_plain(*tsc.codes_decode_candidates_plain(
        Qm, Cf, nrm, idx.packed, **kw), 16)
    v0, i0, _ = tsp._packed_candidates(o0, nq, 16, k, idbits)
    _close((s, i), (v0, i0), idbits)


def test_search_on_the_card_equals_the_cpu_search(dev):
    """The facade's scan on the card (f32 operands) returns the CPU
    search's exact result, including a query the rescue repairs."""
    rng = np.random.default_rng(1)
    n, m, k = 30_000, 8, 50
    C = rng.integers(-1, 2, (m, H, D // m)).astype(np.float32)
    B = rng.integers(0, H, (n, m)).astype(np.int32)
    B[np.arange(20) * 128] = B[0]          # 20 exact ties in lane 0
    Q = rng.integers(-1, 2, (8, D)).astype(np.float32)
    Q[0] = np.concatenate([C[j, B[0, j]] for j in range(m)])
    out = []
    for device in ("cpu", dev):
        idx = tsc.build_codes_index(torch.as_tensor(C, device=device),
                                    torch.as_tensor(B, device=device),
                                    pq=True, d=D)
        out.append(tsc.search_codes(idx, torch.as_tensor(Q), k,
                                    op_dtype=torch.float32))
    assert torch.equal(out[0][0], out[1][0].cpu())
    assert torch.equal(out[0][1], out[1][1].cpu())


def test_cuda_tensors_never_fall_back(dev):
    idx, Q, Cf, nrm, Qm = _case(dev, pq=True, kind="int",
                                dtype=torch.float32, n=3000, nq=4)
    with pytest.raises(ValueError, match="keep=3"):
        tsc.codes_decode_candidates(Qm, Cf, nrm, idx.packed, tile=8192,
                                    keep=3, idbits=8, has_norms=False)
    cand = torch.zeros((4, 128, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="r=20"):
        tsc.cand_merge(cand, cand[:1].contiguous(), 20)
    with pytest.raises(ValueError, match="r=16, keep=2"):
        tsc.codes_decode_onepass(Qm, Cf, nrm, idx.packed, tile=2048, r=16,
                                 keep=2, idbits=8, has_norms=False)


@pytest.mark.parametrize("pq", [True, False])
@pytest.mark.parametrize("r,keep,tile", [(14, 2, 2048), (12, 4, 2048),
                                         (28, 4, 8192), (28, 4, 4096)])
@pytest.mark.parametrize("nq", [1, 40, 9000, "one wave"])
def test_onepass_cut_kernel_equals_plain_on_integer_data(dev, pq, r, keep,
                                                         tile, nq):
    """K14 against K1 → K2's plain versions: identical buffers, with the
    row range split over CTAs, K2 merging the splits (1, 40 and 9000
    queries), and not (one query block per CTA slot of the card: one
    whole wave)."""
    n = 20_000 if nq in (1, 40) else 50_001
    if nq == "one wave":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nq = 32 * 2 * sms
        assert tsc._onepass_tiles_per(2 * sms, -(-n // tile),
                                      2 * sms) == -(-n // tile)
    idx, Q, Cf, nrm, Qm = _case(dev, pq=pq, kind="int",
                                dtype=torch.float32, n=n, nq=nq)
    idbits = tsp._pack_idbits(-(-n // tile) * tile)
    kw = dict(tile=tile, r=r, keep=keep, idbits=idbits, has_norms=not pq)
    n14 = tsc.codes_decode_onepass.launches
    out = tsc.codes_decode_onepass(Qm, Cf, nrm, idx.packed, **kw)
    torch.cuda.synchronize()
    assert tsc.codes_decode_onepass.launches == n14 + 1
    ref = tsc.codes_decode_onepass_plain(Qm, Cf, nrm, idx.packed, **kw)
    assert torch.equal(out, ref)


# K14's compiled (r, keep), each at a tile the one-pass plan gives it
ONEPASS_PLANS = ((14, 2, 2048), (12, 4, 2048), (28, 4, 8192))


def _mma_smem(dp, nw, nbuf):
    """Shared bytes of a bf16 K1/K14 CTA (`mma_smem` in codes_scan.cu):
    32 queries whole and their margins, nbuf buffers of 128 rows at one
    d-block and their two norms (x2 and that of the f32 values), at 16
    bytes of padding a row; the running norms of the CTA's share of a
    step (128 rows over a cluster of 8 CTAs: 16) and their codes for two
    steps; at one d-block 16 requests a thread for the fmaf chain (an
    int key and a 16-bit item each)."""
    db, rpc = (dp if dp <= 256 else 128), 128 // 8
    return 2 * (32 * (dp + 8) + nbuf * 128 * (db + 8)) \
        + 4 * (32 + 2 * nbuf * 128 + rpc) + 8 * rpc * nw \
        + (6 * 16 * 256 if dp <= 256 else 0)


@pytest.mark.parametrize("r,keep", [(14, 2), (12, 4), (28, 4)])
def test_onepass_layout_is_the_kernels(dev, r, keep):
    """K14's layout comes from its source. f32: 32 queries per CTA, r
    rows of 16 (lane, query) pairs x 256 threads of scratch per CTA, two
    CTAs per SM (the occupancy its launch bounds ask for), the row as one
    d-block at dp = 128 and blocks of 128 at GIST's dp = 1024, the tile,
    the queries, the norms and the codes of a step in shared memory,
    clusters of one CTA. bf16 (the tensor-core body): the same CTA and
    scratch in clusters of 8 CTAs, the queries whole and two step
    buffers where two CTAs an SM still fit (dp = 128), else one (dp =
    1024); the card holds at least one cluster and at most its CTA slots
    over 8."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem = 4 * (128 * 129 + 32 * 128 + 128 + 128 * 2)
    for dp in (128, 1024):
        assert tsc._onepass_layout(r, keep, dp, 2, 0, torch.device(dev)) == (
            32, r * 4096, 2, 128, smem, 1, 2 * sms, 1)
        lay = tsc._onepass_layout(r, keep, dp, 2, 1, torch.device(dev))
        nbuf = 2 if dp == 128 else 1
        assert lay[:2] == (32, r * 4096) and lay[3:6] == (
            dp if dp <= 256 else 128, _mma_smem(dp, 2, nbuf), 8), lay
        assert lay[7] == nbuf and lay[2] in (1, 2), lay
        assert 1 <= lay[6] <= lay[2] * sms // 8, lay
    with pytest.raises(RuntimeError, match="rq_codes_onepass_layout"):
        tsc._onepass_layout(16, 2, 128, 2, 1, torch.device(dev))


@pytest.mark.parametrize("keep", [2, 4])
def test_candidates_layout_is_the_kernels(dev, keep):
    """K1's layout entry: on bf16 the tensor-core body's (clusters of 8
    CTAs of 32 queries, no scratch), on f32 the fmaf body's (32 queries,
    two CTAs an SM, clusters of one); `mma_smem`'s bytes at dp = 128 and
    GIST's 1024 with 2 and 4 packed words a row."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dp in (128, 1024):
        for nw in (2, 4):
            lay = tsc._candidates_layout(keep, dp, nw, 1, torch.device(dev))
            nbuf = 2 if dp == 128 else 1
            assert lay[:2] == (32, 0) and lay[5] == 8 and lay[7] == nbuf
            assert lay[4] == _mma_smem(dp, nw, nbuf), lay
            assert 1 <= lay[6] <= lay[2] * sms // 8, lay
            f32 = tsc._candidates_layout(keep, dp, nw, 0, torch.device(dev))
            assert f32[:2] == (32, 0) and f32[5:] == (1, f32[2] * sms, 1)
    with pytest.raises(RuntimeError, match="rq_codes_candidates_layout"):
        tsc._candidates_layout(3, 128, 2, 1, torch.device(dev))


@pytest.mark.parametrize("nq", [1, 33, 100, 300])
@pytest.mark.parametrize("d", [128, 960])
@pytest.mark.parametrize("pq", [True, False])
@pytest.mark.parametrize("mprime", [8, 16])
def test_bf16_codes_kernels_equal_plain_on_integer_data(dev, nq, d, pq,
                                                        mprime):
    """K1, K14 and K4 on bf16 operands (the tensor-core score) against
    their plain versions: identical int32 buffers on small-integer data
    (exact in bf16 and in any f32 sum order), at one d-block and eight,
    both norm branches, 8 and 16 packed bytes a row, query counts that
    fill no whole cluster of 8 x 32 queries (300: one and a part), and
    a base of n = 20,001
    rows (the last row id holds one row: pad rows score +inf)."""
    n = 20_001
    m = mprime if pq else mprime - 1
    idx, Q, Cf, nrm, Qm = _wide_codes_case(dev, pq=pq, kind="int",
                                           dtype=torch.bfloat16, n=n, nq=nq,
                                           d=d, m=m)
    args = (Qm, Cf, nrm, idx.packed)
    n1, n4, n14 = (tsc.codes_decode_candidates.launches,
                   tsc.codes_decode_topk.launches,
                   tsc.codes_decode_onepass.launches)
    for keep in (2, 4):
        kw = dict(tile=8192, keep=keep, has_norms=not pq,
                  idbits=tsp._pack_idbits(-(-n // 8192) * 8192))
        cand, disc = tsc.codes_decode_candidates(*args, **kw)
        cand0, disc0 = tsc.codes_decode_candidates_plain(*args, **kw)
        assert torch.equal(cand, cand0) and torch.equal(disc, disc0), keep
    for r, keep, tile in ONEPASS_PLANS:
        kw14 = dict(tile=tile, r=r, keep=keep, has_norms=not pq,
                    idbits=tsp._pack_idbits(-(-n // tile) * tile))
        assert torch.equal(tsc.codes_decode_onepass(*args, **kw14),
                           tsc.codes_decode_onepass_plain(*args, **kw14)), r
    kw4 = dict(tile=2048, r=48, has_norms=not pq,
               idbits=tsp._pack_idbits(-(-n // 2048) * 2048))
    assert torch.equal(tsc.codes_decode_topk(*args, **kw4),
                       tsc.codes_decode_topk_plain(*args, **kw4))
    torch.cuda.synchronize()
    assert tsc.codes_decode_candidates.launches == n1 + 2
    assert tsc.codes_decode_onepass.launches == n14 + 3
    assert tsc.codes_decode_topk.launches == n4 + 1


def test_bf16_codes_scans_raise_where_no_cta_fits(dev):
    """At dp = 4096 not even one bf16 K1/K14 CTA (32 queries whole and
    one step of 128 rows) fits an SM's shared memory: the launches fail
    and the wrappers raise, taking neither the fmaf body nor the plain
    version."""
    n, d = 3000, 4096
    idx, Q, Cf, nrm, Qm = _wide_codes_case(dev, pq=True, kind="int",
                                           dtype=torch.bfloat16, n=n, nq=4,
                                           d=d)
    args = (Qm, Cf, nrm, idx.packed)
    n1, n14 = (tsc.codes_decode_candidates.launches,
               tsc.codes_decode_onepass.launches)
    with pytest.raises(RuntimeError, match="rq_codes_decode_candidates"):
        tsc.codes_decode_candidates(*args, tile=8192, keep=2, idbits=8,
                                    has_norms=False)
    with pytest.raises(RuntimeError, match="rq_codes_onepass_layout"):
        tsc.codes_decode_onepass(*args, tile=2048, r=14, keep=2, idbits=8,
                                 has_norms=False)
    assert (tsc.codes_decode_candidates.launches,
            tsc.codes_decode_onepass.launches) == (n1, n14)


@pytest.mark.parametrize("nq", [33, 100])
@pytest.mark.parametrize("d", [128, 960])
@pytest.mark.parametrize("pq", [True, False])
def test_bf16_onepass_keys_equal_two_pass_keys_on_gaussian_data(dev, nq, d,
                                                                pq):
    """The gate of the one-pass = two-pass search, on the card: on
    Gaussian data (sums that round) K14's buffers equal K2's merge of
    K1's candidates bit for bit at each one-pass plan (split or not),
    and K4's first `keep` keys equal those of K2's merge of K1's
    candidates (the tiles' top keeps hold each lane's global top keep):
    the three score each (row, query) to the same bits wherever it sits
    in their tiles."""
    n = 50_001
    idx, Q, Cf, nrm, Qm = _wide_codes_case(dev, pq=pq, kind="gauss",
                                           dtype=torch.bfloat16, n=n, nq=nq,
                                           d=d)
    args = (Qm, Cf, nrm, idx.packed)
    for r, keep, tile in ONEPASS_PLANS:
        idbits = tsp._pack_idbits(-(-n // tile) * tile)
        kw = dict(tile=tile, keep=keep, idbits=idbits, has_norms=not pq)
        two = tsc.cand_merge(*tsc.codes_decode_candidates(*args, **kw), r)
        one = tsc.codes_decode_onepass(*args, r=r, **kw)
        assert torch.equal(one, two), (r, keep, tile)
        o4 = tsc.codes_decode_topk(*args, tile=2048, r=48, idbits=idbits,
                                   has_norms=not pq)
        assert torch.equal(o4[:keep], two[:keep]), (r, keep, tile)


@pytest.mark.parametrize("nq", [33, 100])
@pytest.mark.parametrize("mprime", [8, 16])
def test_bf16_codes_keys_are_the_fmaf_chains(dev, nq, mprime):
    """Where a row is one d-block (d = 128) the tensor-core scans keep the
    fmaf chain's keys: on Gaussian data K1's candidates and K4's buffers
    equal K8's (candidates and keep = 0), which reach the same keys from
    the rows they read (the margin, and the chain where it decides), over
    the same decoded rows and norms (the plain decode, in the kernels'
    codebook order; the norms byte's x2)."""
    n, d = 50_001, 128
    idx, Q, Cf, nrm, Qm = _wide_codes_case(dev, pq=False, kind="gauss",
                                           dtype=torch.bfloat16, n=n, nq=nq,
                                           d=d, m=mprime - 1)
    X, x2 = tsc._decode_x2(Cf, nrm, idx.packed, mprime - 1, True)
    Xd = X.to(torch.bfloat16)
    args = (Qm, Cf, nrm, idx.packed)
    for keep in (2, 4):
        kw = dict(tile=8192, keep=keep,
                  idbits=tsp._pack_idbits(-(-n // 8192) * 8192))
        c1, d1 = tsc.codes_decode_candidates(*args, has_norms=True, **kw)
        c8, d8 = tsp.scan_candidates(Qm, Xd, x2, premin=0, **kw)
        assert torch.equal(c1, c8) and torch.equal(d1, d8), keep
    kw4 = dict(tile=2048, r=48, idbits=tsp._pack_idbits(-(-n // 2048) * 2048))
    assert torch.equal(tsc.codes_decode_topk(*args, has_norms=True, **kw4),
                       tsp.scan_onepass(Qm, Xd, x2, premin=0, **kw4))


@pytest.mark.parametrize("nq", [33, 100])
def test_bf16_decoded_keys_equal_codes_keys_at_gist_width(dev, nq):
    """Beyond one d-block the tensor-core key stands, and it is one
    function of the rows in every bf16 scan: at d = 960 (dp = 1024) on
    Gaussian data K8's candidates and keep = 0 buffers equal K1's and
    K4's over the same decoded rows and norms (one chunk order, one
    accumulation)."""
    n, d = 50_001, 960
    idx, Q, Cf, nrm, Qm = _wide_codes_case(dev, pq=False, kind="gauss",
                                           dtype=torch.bfloat16, n=n, nq=nq,
                                           d=d)
    X, x2 = tsc._decode_x2(Cf, nrm, idx.packed, 7, True)
    Xd = X.to(torch.bfloat16)
    assert Xd.shape[1] == 1024
    args = (Qm, Cf, nrm, idx.packed)
    for keep in (2, 4):
        kw = dict(tile=8192, keep=keep,
                  idbits=tsp._pack_idbits(-(-n // 8192) * 8192))
        c1, d1 = tsc.codes_decode_candidates(*args, has_norms=True, **kw)
        c8, d8 = tsp.scan_candidates(Qm, Xd, x2, premin=0, **kw)
        assert torch.equal(c1, c8) and torch.equal(d1, d8), keep
    kw4 = dict(tile=2048, r=48, idbits=tsp._pack_idbits(-(-n // 2048) * 2048))
    assert torch.equal(tsc.codes_decode_topk(*args, has_norms=True, **kw4),
                       tsp.scan_onepass(Qm, Xd, x2, premin=0, **kw4))


@pytest.mark.parametrize("nq", [1, 33, 300])
@pytest.mark.parametrize("d", [104, 128, 256, 264, 960])
def test_bf16_decoded_kernels_equal_plain_on_integer_data(dev, nq, d):
    """K8 on bf16 rows (the tensor-core candidates body, and keep = 0 on
    the same score function) against its plain versions: identical int32
    buffers on small-integer data at widths that end inside a chunk of
    16 dimensions (104, 264: the zero-filled tail), at one d-block (128,
    256: exact scores sit on key boundaries, so most pairs below a
    buffer's threshold go through the margin to the fmaf chain) and
    eight, keep 2 and 4, a query block cut short and 300 queries, odd
    n."""
    n = 20_001
    idx, Q, Qm = _decoded_case(dev, "int", torch.bfloat16, n, d, nq)
    assert idx.Xd.shape[1] == d
    n8, n1 = tsp.scan_candidates.launches, tsp.scan_onepass.launches
    for keep in (2, 4):
        kw = dict(tile=8192, keep=keep, premin=0,
                  idbits=tsp._pack_idbits(-(-n // 8192) * 8192))
        got = tsp.scan_candidates(Qm, idx.Xd, idx.x2, **kw)
        ref = tsp.scan_candidates_plain(Qm, idx.Xd, idx.x2, **kw)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    kw1 = dict(tile=2048, r=48, premin=0,
               idbits=tsp._pack_idbits(-(-n // 2048) * 2048))
    assert torch.equal(tsp.scan_onepass(Qm, idx.Xd, idx.x2, **kw1),
                       tsp.scan_onepass_plain(Qm, idx.Xd, idx.x2, **kw1))
    torch.cuda.synchronize()
    assert (tsp.scan_candidates.launches,
            tsp.scan_onepass.launches) == (n8 + 2, n1 + 1)


@pytest.mark.parametrize("nq", [33, 100])
@pytest.mark.parametrize("d", [128, 960])
def test_bf16_decoded_onepass_keys_equal_two_pass_keys_on_gaussian_data(
        dev, nq, d):
    """K8's one-pass search equals its two-pass search on the card, on
    Gaussian data (sums that round): at each plan class of the two-pass
    scan, the first `keep` keys of K2's merge of K8's candidates equal
    those of K8 at keep = 0 (the tiles' top keeps hold each lane's
    global top keep), at one d-block (the chain's keys) and at eight
    (the tensor-core keys)."""
    n = 50_001
    idx, Q, Qm = _decoded_case(dev, "gauss", torch.bfloat16, n, d, nq)
    for keep, tile, r in ((2, 8192, 16), (4, 8192, 32), (4, 2048, 96)):
        idbits = tsp._pack_idbits(-(-n // tile) * tile)
        two = tsp.cand_merge(*tsp.scan_candidates(
            Qm, idx.Xd, idx.x2, tile=tile, keep=keep, premin=0,
            idbits=idbits), r)
        one = tsp.scan_onepass(Qm, idx.Xd, idx.x2, tile=2048, r=48,
                               premin=0, idbits=idbits)
        assert torch.equal(one[:keep], two[:keep]), (keep, tile)


def test_bf16_decoded_chain_pairs_only_at_one_dblock(dev):
    """K8 on bf16 rows asks the fmaf chain only where a row is one d-block:
    on small-integer data (exact scores on key boundaries) it does for
    many pairs at d = 128 and for none at d = 960; the count takes a
    launch of its own, which `scan_candidates.launches` does not see, and
    its buffers are the kernel's."""
    n, nq = 20_001, 33
    kw = dict(tile=8192, keep=2, idbits=tsp._pack_idbits(-(-n // 8192) * 8192))
    for d, some in ((128, True), (960, False)):
        idx, Q, Qm = _decoded_case(dev, "int", torch.bfloat16, n, d, nq)
        n8 = tsp.scan_candidates.launches
        got = tsp._chain_pairs(Qm, idx.Xd, idx.x2, **kw)
        assert tsp.scan_candidates.launches == n8
        assert (got > 0) == some and 0 <= got <= n * nq, (d, got)


@pytest.mark.parametrize("pq", [True, False])
def test_onepass_cut_bf16_within_one_truncation_step(dev, pq):
    n, nq, k = 50_000, 64, 100
    idx, Q, Cf, nrm, Qm = _case(dev, pq=pq, kind="gauss",
                                dtype=torch.bfloat16, n=n, nq=nq)
    s, i, _ = tsc.scan_codes_decode_topk(Q, Cf, nrm, idx.packed, k=k, pq=pq,
                                         r=14, keep=2, tile=2048)
    idbits = tsp._pack_idbits(-(-n // 2048) * 2048)
    o0 = tsc.codes_decode_onepass_plain(Qm, Cf, nrm, idx.packed, tile=2048,
                                        r=14, keep=2, idbits=idbits,
                                        has_norms=not pq)
    v0, i0, _ = tsp._packed_candidates(o0, nq, 14, k, idbits)
    _close((s, i), (v0, i0), idbits)


def test_onepass_search_on_the_card_equals_the_cpu_search(dev):
    """`search_codes(twopass=False)` (and with ``stage``, ``qsuper``) on
    the card returns the CPU search's exact result, and the two-pass
    search's at the same tile, including a query the rescue repairs."""
    rng = np.random.default_rng(1)
    n, m, k = 30_000, 8, 50
    C = rng.integers(-1, 2, (m, H, D // m)).astype(np.float32)
    B = rng.integers(0, H, (n, m)).astype(np.int32)
    B[np.arange(20) * 128] = B[0]          # 20 exact ties in lane 0
    Q = rng.integers(-1, 2, (8, D)).astype(np.float32)
    Q[0] = np.concatenate([C[j, B[0, j]] for j in range(m)])
    out = []
    for device, kw in (("cpu", dict(twopass=False)),
                       (dev, dict(twopass=False)),
                       (dev, dict(stage=1, tile=8192)),
                       (dev, dict(twopass=False, qsuper=4, tile=8192)),
                       (dev, dict())):
        idx = tsc.build_codes_index(torch.as_tensor(C, device=device),
                                    torch.as_tensor(B, device=device),
                                    pq=True, d=D)
        n14 = tsc.codes_decode_onepass.launches
        out.append(tsc.search_codes(idx, torch.as_tensor(Q), k,
                                    op_dtype=torch.float32, **kw))
        if device == dev and kw:
            assert tsc.codes_decode_onepass.launches == n14 + 1
    for got in out[1:]:
        assert torch.equal(out[0][0], got[0].cpu())
        assert torch.equal(out[0][1], got[1].cpu())


def _same_up_to_ties(a, b):
    """Two exact searches of integer data agree by position: the kernels
    equal their plain versions, and a flagged query's exact re-run takes
    the lowest id among equal scores on either device."""
    (da, ia), (db, ib) = [(d.cpu(), i.cpu()) for d, i in (a, b)]
    assert torch.equal(da, db) and torch.equal(ia, ib)


def _decoded_case(dev, kind, dtype, n, d, nq, seed=0):
    """A decoded index (d padded to the kernel's width), -2Q at the
    operand dtype, and the raw queries."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        X = rng.integers(-3, 4, (n, d)).astype(np.float32)
        Q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    else:
        X = rng.standard_normal((n, d)).astype(np.float32)
        Q = rng.standard_normal((nq, d)).astype(np.float32)
    Xt = torch.as_tensor(X, device=dev)
    idx = tsp.LinscanIndex(Xt.to(dtype), (Xt * Xt).sum(-1))
    Qt = torch.as_tensor(Q, device=dev)
    return idx, Qt, tsp._query_operand(Qt, idx.Xd.shape[1], dtype)


@pytest.mark.parametrize("d,nq", [(24, 33), (100, 1), (128, 33)])
@pytest.mark.parametrize("keep,tile", [(2, 8192), (4, 8192), (4, 2048),
                                       (2, 1024)])
def test_decoded_scan_kernel_equals_plain_on_integer_data(dev, d, nq, keep,
                                                          tile):
    n = 20_001                          # odd, ragged against the tile
    idx, Q, Qm = _decoded_case(dev, "int", torch.float32, n, d, nq)
    idbits = tsp._pack_idbits(-(-n // tile) * tile)
    kw = dict(tile=tile, keep=keep, premin=0, idbits=idbits)
    n8 = tsp.scan_candidates.launches
    cand, disc = tsp.scan_candidates(Qm, idx.Xd, idx.x2, **kw)
    torch.cuda.synchronize()
    assert tsp.scan_candidates.launches == n8 + 1
    cand0, disc0 = tsp.scan_candidates_plain(Qm, idx.Xd, idx.x2, **kw)
    assert torch.equal(cand, cand0) and torch.equal(disc, disc0)


@pytest.mark.parametrize("nq", ONEPASS_NQ)
@pytest.mark.parametrize("d", [24, 100, 128, 960])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoded_onepass_kernel_equals_plain_on_integer_data(dev, d, nq,
                                                             dtype):
    """K8 at keep = 0 against its plain version: identical int32 buffers
    at 1 to 128 queries (query blocks cut short), rows narrower than 128
    (d = 24, 100 -> 104), of one d-block and of eight, f32 and bf16
    rows."""
    n = 20_001
    idx, Q, Qm = _decoded_case(dev, "int", dtype, n, d, nq)
    idbits = tsp._pack_idbits(-(-n // 2048) * 2048)
    kw = dict(tile=2048, r=48, premin=0, idbits=idbits)
    n8 = tsp.scan_onepass.launches
    out = tsp.scan_onepass(Qm, idx.Xd, idx.x2, **kw)
    torch.cuda.synchronize()
    assert tsp.scan_onepass.launches == n8 + 1
    assert torch.equal(out, tsp.scan_onepass_plain(Qm, idx.Xd, idx.x2, **kw))


@pytest.mark.parametrize("d", [24, 100, 128])
@pytest.mark.parametrize("keep,tile,r", [(2, 8192, 16), (4, 8192, 32),
                                         (4, 2048, 96), (0, 2048, 48)])
def test_decoded_scan_bf16_within_one_truncation_step(dev, d, keep, tile, r):
    n, nq, k = 50_001, 33, 100
    idx, Q, Qm = _decoded_case(dev, "gauss", torch.bfloat16, n, d, nq)
    idbits = tsp._pack_idbits(-(-n // tile) * tile)
    s, i, _ = tsp.scan_topk_packed(Q, idx.Xd, idx.x2, k=k, r=r, tile=tile,
                                   keep=keep)
    kw = dict(tile=tile, premin=0, idbits=idbits)
    if keep:
        o0 = tsp.cand_merge_plain(*tsp.scan_candidates_plain(
            Qm, idx.Xd, idx.x2, keep=keep, **kw), r)
    else:
        o0 = tsp.scan_onepass_plain(Qm, idx.Xd, idx.x2, r=r, **kw)
    v0, i0, _ = tsp._packed_candidates(o0, nq, r, k, idbits)
    # at d = 24 a top-100 score can lie near zero while its terms do not:
    # the two f32 sums (the kernel's dimension order, cuBLAS's) then
    # differ by more than a relative step; terms reach ~10, 24 of them
    _close((s, i), (v0, i0), idbits, atol=2e-5)


def test_decoded_search_on_the_card_equals_the_cpu_search(dev):
    """`scan.search` on the card (f32 index, integer data) returns the
    CPU search's result, through the shallowest and the deepest class of
    the plan (K2 at r = 96, K3 over 128-deep lists) and the exact rescan
    of a query with a lane pile-up."""
    rng = np.random.default_rng(2)
    n, d, k = 30_000, 32, 50
    X = rng.integers(-3, 4, (n, d)).astype(np.float32)
    X[np.arange(20) * 128] = X[0]          # 20 exact ties in lane 0
    Q = rng.integers(-3, 4, (8, d)).astype(np.float32)
    Q[0] = X[0]
    for k in (k, 3500):
        out = []
        for device in ("cpu", dev):
            Xt = torch.as_tensor(X, device=device)
            idx = tsp.LinscanIndex(Xt, (Xt * Xt).sum(-1))
            out.append(tsp.search(idx, torch.as_tensor(Q), k))
        _same_up_to_ties(out[0], out[1])
        assert set(range(0, 20 * 128, 128)) <= set(out[1][1][0].tolist())


@pytest.mark.parametrize("h,pq,nq", [(16, False, 33), (256, False, 1),
                                     (256, True, 33), (16, True, 1)])
@pytest.mark.parametrize("kind,dtype", [("int", torch.float32),
                                        ("gauss", torch.float32),
                                        ("gauss", torch.bfloat16)])
@pytest.mark.parametrize("keep", [2, 4])
def test_lut_scan_kernel_equals_plain(dev, h, pq, nq, kind, dtype, keep):
    """K5 sums the table values in the plain version's order: identical
    int32 outputs on integer and on Gaussian data, f32 and bf16 tables,
    one and two code words (m' = 8 and 7 + 1), odd n."""
    rng = np.random.default_rng(4)
    n, m = 20_001, 8 if pq else 7
    ds = D // m if pq else D
    mk = (lambda *sh: rng.integers(-2, 3, sh)) if kind == "int" \
        else (lambda *sh: rng.standard_normal(sh))
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                    device=dev)
    C, Q = t(mk(m, h, ds)), t(mk(nq, D))
    B = t(rng.integers(0, h, (n, m)), torch.int32)
    ncb = None if pq else t(rng.random(h) * 100)
    nco = None if pq else t(rng.integers(0, h, n), torch.int32)
    T = tsc.build_luts(C, Q, pq=pq, d=D, norms_cbook=ncb).to(dtype)
    packed = tsc.pack_codes(B, nco)
    kw = dict(tile=8192, keep=keep,
              idbits=tsp._pack_idbits(-(-n // 8192) * 8192))
    n5 = tsc.codes_lut_candidates.launches
    cand, disc = tsc.codes_lut_candidates(T.contiguous(), packed, **kw)
    torch.cuda.synchronize()
    assert tsc.codes_lut_candidates.launches == n5 + 1
    cand0, disc0 = tsc.codes_lut_candidates_plain(T.contiguous(), packed,
                                                  **kw)
    assert torch.equal(cand, cand0) and torch.equal(disc, disc0)


def test_lut_search_on_the_card_equals_the_cpu_search(dev):
    """`search_codes(mode="lut")` on the card (f32 tables, integer data)
    returns the CPU search's result."""
    rng = np.random.default_rng(5)
    n, m, k = 30_000, 7, 50
    C = rng.integers(-1, 2, (m, H, D)).astype(np.float32)
    B = rng.integers(0, H, (n, m)).astype(np.int32)
    ncb = rng.integers(0, 300, H).astype(np.float32)
    nco = rng.integers(0, H, n).astype(np.int32)
    Q = rng.integers(-1, 2, (9, D)).astype(np.float32)
    out = []
    for device in ("cpu", dev):
        t = lambda a: torch.as_tensor(a, device=device)
        idx = tsc.build_codes_index(t(C), t(B), norms_cbook=t(ncb),
                                    norms_codes=t(nco))
        out.append(tsc.search_codes(idx, t(Q), k, mode="lut",
                                    op_dtype=torch.float32))
    _same_up_to_ties(out[0], out[1])


def test_new_scans_never_fall_back(dev, tmp_path, monkeypatch):
    """Arguments the kernels do not take raise; and where the kernels
    cannot be built (the build directory cannot be made), a call on CUDA
    tensors raises instead of taking the plain version."""
    from rayuela_tpu_torch.kernels import build
    idx, Q, Qm = _decoded_case(dev, "int", torch.float32, 3000, 24, 4)
    with pytest.raises(ValueError, match="keep=8"):
        tsp.scan_candidates(Qm, idx.Xd, idx.x2, tile=8192, keep=8, premin=0,
                            idbits=8)
    with pytest.raises(ValueError, match="premin=1"):
        tsp.scan_candidates(Qm, idx.Xd, idx.x2, tile=8192, keep=2, premin=1,
                            idbits=8)
    with pytest.raises(ValueError, match="r=16"):
        tsp.scan_onepass(Qm, idx.Xd, idx.x2, tile=2048, r=16, premin=0,
                         idbits=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        tsp.scan_candidates(Qm[:, :20].contiguous(),
                            idx.Xd[:, :20].contiguous(), idx.x2, tile=8192,
                            keep=2, premin=0, idbits=8)
    T = torch.zeros((8, 512, 4), device=dev)
    packed = torch.zeros((3000, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        tsc.codes_lut_candidates(T, packed, tile=8192, keep=2, idbits=8)
    blocker = tmp_path / "not_a_directory"
    blocker.write_text("")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", blocker / "_build")
    with pytest.raises(OSError):
        tsp.scan_candidates(Qm, idx.Xd, idx.x2, tile=8192, keep=2, premin=0,
                            idbits=8)
    with pytest.raises(OSError):
        tsc.codes_lut_candidates(T[:, :256].contiguous(), packed, tile=8192,
                                 keep=2, idbits=8)


def _encode_case(dev, kind, n, m, seed=0, h=H, d=D):
    rng = np.random.default_rng(seed)
    if kind == "int":
        X = rng.integers(-1, 2, (n, d)).astype(np.float32)
        C = rng.integers(-1, 2, (m, h, d)).astype(np.float32)
    else:
        X = rng.standard_normal((n, d)).astype(np.float32)
        C = (rng.standard_normal((m, h, d)) * 0.3).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    order = rng.permutation(m).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(X), t(C), t(B), t(order)


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("m", [7, 8])
def test_icm_sweeps_kernel_equals_plain(dev, kind, m):
    X, C, B, order = _encode_case(dev, kind, 8192, m)
    for icmiter in (0, 1, 4):
        n11 = ticm.icm_sweeps.launches
        gb, ge = ticm.icm_sweeps(X, C, B, order, icmiter)
        torch.cuda.synchronize()
        assert ticm.icm_sweeps.launches == n11 + 1
        rb, re_ = ticm.icm_sweeps_plain(X, C, B, order, icmiter,
                                        op_dtype=torch.bfloat16)
        if kind == "int":
            assert torch.equal(gb, rb) and torch.equal(ge, re_)
        else:
            assert float((gb == rb).float().mean()) >= 0.99
            me, mr = float(ge.double().mean()), float(re_.double().mean())
            assert abs(me - mr) <= 1e-4 * abs(mr)


@pytest.mark.parametrize("h", [16, 32, 48, 200])
def test_icm_sweeps_kernel_any_h(dev, h):
    """h outside the compiled label counts is padded by the wrapper:
    identical to the plain version on integer data, no padded label
    ever chosen."""
    X, C, B, order = _encode_case(dev, "int", 4096, 4, h=h)
    for icmiter in (0, 4):
        gb, ge = ticm.icm_sweeps(X, C, B, order, icmiter)
        rb, re_ = ticm.icm_sweeps_plain(X, C, B, order, icmiter,
                                        op_dtype=torch.bfloat16)
        assert int(gb.max()) < h
        assert torch.equal(gb, rb) and torch.equal(ge, re_)


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("h,d", [(512, D), (1000, 64), (H, 960)])
def test_icm_sweeps_kernel_wide_shapes(dev, kind, h, d):
    """K11 beyond one block of labels (h = 512, and 1000 padded to 1024)
    and at GIST's d = 960 (8 vectors a CTA) against its plain version:
    identical on integer data, the K11 bound on Gaussian."""
    X, C, B, order = _encode_case(dev, kind, 2000, 8, h=h, d=d)
    for icmiter in (0, 2):
        gb, ge = ticm.icm_sweeps(X, C, B, order, icmiter)
        rb, re_ = ticm.icm_sweeps_plain(X, C, B, order, icmiter,
                                        op_dtype=torch.bfloat16)
        assert int(gb.max()) < h
        _icm_close(kind, (gb, ge), (rb, re_))


@pytest.mark.parametrize("m,h,d", [(7, 16, 8), (15, 200, 128),
                                   (7, 1024, 128), (15, 256, 960),
                                   (7, 200, 2400), (15, 16, 100)])
def test_icm_kernels_equal_plain_on_integer_data_at_every_layout(dev, m, h,
                                                                  d):
    """K11 and K12 (the tensor-core visit) against their plain versions on
    small-integer data (exact in bf16 and in any f32 sum order): identical
    codes and energies at m = 7 and 15, h from 16 to 1024 (padded to a
    multiple of 128 labels), d from 8 to 2400 through every layout (32
    vectors a CTA at d = 8 to 128, 8 with two CTAs an SM at d = 960, 8
    with one at d = 2400; d = 8 and 100 end inside a chunk of 16), n not
    a multiple of any CTA."""
    n = 999
    X, C, B, order = _encode_case(dev, "int", n, m, h=h, d=d)
    for icmiter in (0, 2):
        got = ticm.icm_sweeps(X, C, B, order, icmiter)
        ref = ticm.icm_sweeps_plain(X, C, B, order, icmiter,
                                    op_dtype=torch.bfloat16)
        assert int(got[0].max()) < h
        _icm_close("int", got, ref)
    rng = np.random.default_rng(6)
    orders = torch.as_tensor(np.stack([rng.permutation(m) for _ in range(2)]),
                             dtype=torch.int32, device=dev)
    kw = dict(ilsiter=2, icmiter=2, npert=2)
    got = ticm.encoding_ils(X, C, B, orders, 12345, **kw)
    ref = ticm.encoding_ils_plain(X, C, B, orders, 12345,
                                  op_dtype=torch.bfloat16, **kw)
    _icm_close("int", got, ref)


@pytest.mark.parametrize("m,d", [(15, 128), (7, 960)])
def test_icm_kernels_on_gaussian_data_at_the_main_widths(dev, m, d):
    """K11 (icmiter = 4) and K12 (4 rounds) on Gaussian data against their
    plain versions at SR-D-15+1's m and at GIST's d: at least 99% of codes
    equal and the mean energy within 1e-4 relative (PERF.md §2)."""
    X, C, B, order = _encode_case(dev, "gauss", 4096, m, d=d)
    _icm_close("gauss", ticm.icm_sweeps(X, C, B, order, 4),
               ticm.icm_sweeps_plain(X, C, B, order, 4,
                                     op_dtype=torch.bfloat16))
    rng = np.random.default_rng(7)
    orders = torch.as_tensor(np.stack([rng.permutation(m) for _ in range(4)]),
                             dtype=torch.int32, device=dev)
    kw = dict(ilsiter=4, icmiter=2, npert=2)
    _icm_close("gauss", ticm.encoding_ils(X, C, B, orders, 99, **kw),
               ticm.encoding_ils_plain(X, C, B, orders, 99,
                                       op_dtype=torch.bfloat16, **kw))


@pytest.mark.parametrize("d,m", [(8, 7), (100, 8), (128, 7), (128, 16),
                                 (256, 8), (440, 8), (960, 7), (960, 16),
                                 (2400, 16), (3600, 8)])
def test_icm_layout_is_the_kernels(dev, d, m):
    """K11's and K12's layout comes from their source (`rq_icm_layout`),
    `ops.icm._icm_layout` states it, and the card holds at least the CTAs
    an SM the layout was chosen for; a shape no CTA fits raises in both."""
    lay = query("rq_icm_layout", d, m, size=4, device=dev)
    assert lay[:3] == ticm._icm_layout(d, m)
    assert lay[3] >= lay[1], lay
    with pytest.raises(RuntimeError, match="rq_icm_layout"):
        query("rq_icm_layout", 4096, 8, size=4, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ticm._icm_layout(4096, 8)


def _icm_close(kind, got, ref):
    (gb, ge), (rb, re_) = got, ref
    if kind == "int":
        assert torch.equal(gb, rb) and torch.equal(ge, re_)
    else:
        assert float((gb == rb).float().mean()) >= 0.99
        me, mr = float(ge.double().mean()), float(re_.double().mean())
        assert abs(me - mr) <= 1e-4 * abs(mr)


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("m,h,d,n", [(7, H, D, 8191), (8, 200, D, 4096),
                                     (8, 512, 64, 2000), (4, H, 960, 1000)])
def test_ils_kernel_equals_plain(dev, kind, m, h, d, n):
    """K12 (whole ILS in one launch) against its plain version: on
    integer data codes and energies identical (the counter-hash
    perturbation is the same function of seed, vector and round), on
    Gaussian data the K11 bound; the energy never rises above B0's."""
    X, C, B, _ = _encode_case(dev, kind, n, m, h=h, d=d)
    rng = np.random.default_rng(5)
    orders = torch.as_tensor(np.stack([rng.permutation(m) for _ in range(3)]),
                             dtype=torch.int32, device=dev)
    kw = dict(ilsiter=3, icmiter=2, npert=2)
    n12 = ticm.encoding_ils.launches
    got = ticm.encoding_ils(X, C, B, orders, 987654321, **kw)
    torch.cuda.synchronize()
    assert ticm.encoding_ils.launches == n12 + 1
    ref = ticm.encoding_ils_plain(X, C, B, orders, 987654321,
                                  op_dtype=torch.bfloat16, **kw)
    assert int(got[0].max()) < h
    _icm_close(kind, got, ref)
    _, e0 = ticm.icm_sweeps_plain(X, C, B, list(range(m)), 0,
                                  op_dtype=torch.bfloat16)
    assert bool((got[1] <= e0 + 1e-3 * e0.abs()).all())
    kw0 = dict(ilsiter=0, icmiter=2, npert=2)
    got0 = ticm.encoding_ils(X, C, B, orders[:0].contiguous(), 1, **kw0)
    assert torch.equal(got0[0], B)
    _icm_close(kind, got0, ticm.encoding_ils_plain(
        X, C, B, orders[:0], 1, op_dtype=torch.bfloat16, **kw0))


def test_whole_ils_encode_runs_one_launch(dev):
    """`encoding_icm(impl="pallas-ils")` on CUDA tensors is one K12
    launch, and no K11 launch."""
    X, C, B, _ = _encode_case(dev, "gauss", 3000, 4)
    gen = torch.Generator(device=dev).manual_seed(0)
    n11, n12 = ticm.icm_sweeps.launches, ticm.encoding_ils.launches
    out = ticm.encoding_icm(gen, X, C, B, ilsiter=4, impl="pallas-ils")
    torch.cuda.synchronize()
    assert ticm.encoding_ils.launches == n12 + 1
    assert ticm.icm_sweeps.launches == n11
    assert out.shape == B.shape and out.dtype == torch.int32


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("m", [7, 8])
def test_viterbi_kernel_equals_plain(dev, kind, m):
    X, C, _, _ = _encode_case(dev, kind, 8192, m)
    n13 = tvit.viterbi_encode.launches
    got = tvit.viterbi_encode(X, C)
    torch.cuda.synchronize()
    assert tvit.viterbi_encode.launches == n13 + 1
    ref = tvit.viterbi_encode_plain(X, C)
    if kind == "int":
        assert torch.equal(got, ref)
    else:
        eg, er = tvit.chain_energy(X, C, got), tvit.chain_energy(X, C, ref)
        assert bool(((eg - er).abs() <= 1e-5 * er.abs() + 1e-3).all())
        assert float((got == ref).float().mean()) >= 0.99


def test_encode_kernels_never_fall_back(dev):
    X, C, B, order = _encode_case(dev, "gauss", 64, 4)
    with pytest.raises(ValueError, match="shared memory"):
        ticm.icm_sweeps(torch.zeros(64, 4096, device=dev),
                        torch.zeros(4, H, 4096, device=dev), B, order, 1)
    with pytest.raises(ValueError, match="h=2048"):
        ticm.icm_sweeps(X, torch.zeros(4, 2048, D, device=dev), B, order, 1)
    with pytest.raises(ValueError, match="shared memory"):
        ticm.encoding_ils(torch.zeros(64, 4096, device=dev),
                          torch.zeros(4, H, 4096, device=dev), B,
                          order[None], 0, ilsiter=1, icmiter=1, npert=1)
    with pytest.raises(ValueError, match="int32"):
        ticm.icm_sweeps(X, C, B.long(), order, 1)
    with pytest.raises(ValueError, match="h <= 1024"):
        tvit.viterbi_encode(X, torch.zeros(64, 1024, D, device=dev))


def test_sr_d_training_is_reproducible_on_the_card(dev):
    """Two `train(method="sr_d")` runs from one seed give bitwise-equal
    codebooks and codes: every float sum of the path (k-means and OPQ
    centres, the codebook statistics) is deterministic."""
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.standard_normal((6000, 32)).astype(np.float32),
                        device=dev)
    runs = [tapi.train(X, method="sr_d", m=4, h=64, niter=2, seed=7)
            for _ in range(2)]
    assert torch.equal(runs[0].codebooks, runs[1].codebooks)
    assert torch.equal(runs[0].train_codes, runs[1].train_codes)


# ---------------------------------------------------------------------------
# The exact-float scans: K9, K10, K6, K7 and the pair merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,nq", [(24, 33), (100, 1), (128, 33), (136, 65),
                                  (264, 63), (960, 129)])
@pytest.mark.parametrize("keep,tile,r", [(2, 8192, 16), (4, 8192, 32),
                                         (4, 2048, 48), (2, 1024, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_scan_kernels_equal_plain_on_integer_data(dev, d, nq, keep, tile,
                                                      r, dtype):
    """K9's two passes and K10 against their plain versions: identical
    pairs and counts (small integers are exact in bf16 too), odd n, query
    counts that are not multiples of the kernels' 64-query block, and rows
    of one, several and a last partial 32-dimension stage."""
    n = 20_001
    idx, Q, Qm = _decoded_case(dev, "int", dtype, n, d, nq)
    n9, nm, n10 = (tsp.scan_f32_candidates.launches, tsp.pair_merge.launches,
                   tsp.verify_counts.launches)
    cv, ci = tsp.scan_f32_candidates(Qm, idx.Xd, idx.x2, tile=tile, keep=keep)
    ov, oi = tsp.pair_merge(cv, ci, r)
    cv0, ci0 = tsp.scan_f32_candidates_plain(Qm, idx.Xd, idx.x2, tile=tile,
                                             keep=keep)
    assert torch.equal(cv, cv0) and torch.equal(ci, ci0)
    ov0, oi0 = tsp.pair_merge_plain(cv, ci, r)
    assert torch.equal(ov, ov0) and torch.equal(oi, oi0)
    s, i, fl = tsp.scan_topk_f32(Q, idx.Xd, idx.x2, k=100, r=r, tile=tile,
                                 keep=keep)
    taus, taui = s[:, -1].contiguous(), i[:, -1].contiguous()
    cnt = tsp.verify_counts(Qm, idx.Xd, idx.x2, taus, taui, tile=tile)
    cnt0 = tsp.verify_counts_plain(Qm, idx.Xd, idx.x2, taus, taui, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(cnt, cnt0) and int(cnt[0].sum()) >= 99 * nq
    assert tsp.scan_f32_candidates.launches == n9 + 2
    assert tsp.pair_merge.launches == nm + 2
    assert tsp.verify_counts.launches == n10 + 2


@pytest.mark.parametrize("d", [24, 100, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_scan_on_gaussian_data(dev, d, dtype):
    """The kernel sums in dimension order, cuBLAS in its own: scores
    within 1e-5 relative + 5e-5, at least 99.9% of ids equal by position,
    flags equal."""
    n, nq, k, r, tile, keep = 50_001, 33, 100, 16, 8192, 2
    idx, Q, Qm = _decoded_case(dev, "gauss", dtype, n, d, nq)
    s, i, fl = tsp.scan_topk_f32(Q, idx.Xd, idx.x2, k=k, r=r, tile=tile,
                                 keep=keep)
    ov, oi = tsp.scan_f32_topk_plain(Qm, idx.Xd, idx.x2, r=r, tile=tile,
                                     keep=keep)
    s0, i0, fl0 = tsp._finish_f32(
        ov, oi, k, r, keep, lambda ts, ti: tsp.verify_counts_plain(
            Qm, idx.Xd, idx.x2, ts, ti, tile=tile))
    assert bool(((s - s0).abs() <= 1e-5 * s0.abs() + 5e-5).all())
    assert float((i == i0).float().mean()) >= 0.999
    assert torch.equal(fl, fl0)


@pytest.mark.parametrize("d", [128, 960])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,r,keep", [(100, 16, 2), (1000, 32, 4)])
def test_f32_counts_see_k9s_scores(dev, d, dtype, k, r, keep):
    """K9 and K10 see the same score bits: for each query a `pack=False`
    scan leaves unflagged, K10's count at K9's own k-th pair, summed over
    the 128 lanes, is exactly k - 1, on Gaussian data."""
    n, nq, tile = 400_001, 100, 8192   # a tile cut flags few queries
    g = torch.Generator(device=dev).manual_seed(d + k)
    X = torch.randn((n, d), generator=g, device=dev)
    Q = torch.randn((nq, d), generator=g, device=dev)
    idx = tsp.LinscanIndex(X.to(dtype), (X * X).sum(-1))
    Qm = tsp._query_operand(Q, idx.Xd.shape[1], dtype)
    del X
    s, i, fl = tsp.scan_topk_f32(Q, idx.Xd, idx.x2, k=k, r=r, tile=tile,
                                 keep=keep)
    cnt = tsp.verify_counts(Qm, idx.Xd, idx.x2, s[:, k - 1].contiguous(),
                            i[:, k - 1].contiguous(), tile=tile)
    torch.cuda.synchronize()
    ok = ~fl
    assert int(ok.sum()) >= nq // 2
    assert bool((cnt[0].sum(0)[ok] == k - 1).all())


@pytest.mark.parametrize("dp", [104, 128, 256, 264, 960, 2432])
@pytest.mark.parametrize("bf16", [0, 1])
def test_decoded_candidates_layout_is_the_kernels(dev, dp, bf16):
    """K8's layout comes from its source (`rq_scan_candidates_layout`),
    `scan._candidates_layout` states it, and the card holds two bf16 CTAs
    an SM at every width (the occupancy its launch bounds ask for), f32
    ones where two fit."""
    lay = query("rq_scan_candidates_layout", dp, bf16, size=5, device=dev)
    assert lay[:4] == tsp._candidates_layout(dp, bf16)
    cap = getattr(torch.cuda.get_device_properties(dev),
                  "shared_memory_per_block_optin", 232_448)
    # the f32 body at dp = 256 holds one CTA an SM (its tile transposed)
    assert lay[4] == (2 if bf16 or lay[3] <= (cap - 1024) // 2 else 1), lay


@pytest.mark.parametrize("keep", [0, 2, 4])
@pytest.mark.parametrize("bf16", [0, 1])
def test_exact_layout_is_the_kernels(dev, keep, bf16):
    """K9's (keep 2, 4) and K10's (keep 0) layout comes from their source
    (`rq_exact_layout`), and `scan._exact_layout` states it; the card
    holds two CTAs an SM (the occupancy its launch bounds ask for)."""
    lay = query("rq_exact_layout", keep, bf16, size=8, device=dev)
    assert lay[:7] == tsp._exact_layout(keep, bf16)
    assert lay[7] == 2, lay


@pytest.mark.parametrize("h,pq,nq", [(16, False, 33), (256, False, 1),
                                     (256, True, 33), (16, True, 1),
                                     (256, False, 64)])
@pytest.mark.parametrize("kind,dtype", [("int", torch.float32),
                                        ("int", torch.bfloat16),
                                        ("gauss", torch.float32),
                                        ("gauss", torch.bfloat16)])
@pytest.mark.parametrize("keep", [2, 4])
@pytest.mark.parametrize("wide", [False, True])
def test_lut_f32_kernels_equal_plain(dev, h, pq, nq, kind, dtype, keep,
                                     wide):
    """K6 and K7 sum the table values in the plain versions' order:
    identical pairs and counts on integer and on Gaussian data, f32 and
    bf16 tables, m' = 8 and 16 (every layout of `_lut_exact_layout` at h
    = 256: 16 or 8 queries a CTA on f32 tables, 32 or 16 on bf16 ones),
    one, two and four code words, odd n, nq ragged against the query
    blocks and against the 16-byte fill (nq = 64: the cp.async fill)."""
    rng = np.random.default_rng(4)
    m = (16 if pq else 15) if wide else (8 if pq else 7)
    n, tile, r = 20_001, 8192, 16
    ds = D // m if pq else D
    mk = (lambda *sh: rng.integers(-2, 3, sh)) if kind == "int" \
        else (lambda *sh: rng.standard_normal(sh))
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                    device=dev)
    C, Q = t(mk(m, h, ds)), t(mk(nq, D))
    B = t(rng.integers(0, h, (n, m)), torch.int32)
    ncb = None if pq else t(rng.random(h) * 100)
    nco = None if pq else t(rng.integers(0, h, n), torch.int32)
    T = tsc.build_luts(C, Q, pq=pq, d=D, norms_cbook=ncb).to(dtype)
    T, packed = T.contiguous(), tsc.pack_codes(B, nco)
    n6, n7 = (tsc.codes_lut_f32_candidates.launches,
              tsc.codes_verify_counts.launches)
    cv, ci = tsc.codes_lut_f32_candidates(T, packed, tile=tile, keep=keep)
    cv0, ci0 = tsc.codes_lut_f32_candidates_plain(T, packed, tile=tile,
                                                  keep=keep)
    assert torch.equal(cv, cv0) and torch.equal(ci, ci0)
    s, i, fl = tsc.scan_codes_topk(T, packed, k=50, r=r, tile=tile,
                                   keep=keep, lut_dtype=dtype, pack=False)
    ov, oi = tsc.codes_lut_topk_f32_plain(T, packed, r=r, tile=tile,
                                          keep=keep)
    s0, i0, fl0 = tsp._finish_f32(
        ov, oi, 50, r, keep, lambda ts, ti: tsc.codes_verify_counts_plain(
            T, packed, ts, ti, tile=tile))
    torch.cuda.synchronize()
    assert torch.equal(s, s0) and torch.equal(i, i0) and torch.equal(fl, fl0)
    assert tsc.codes_lut_f32_candidates.launches == n6 + 2
    assert tsc.codes_verify_counts.launches == n7 + 1


def test_f32_searches_on_the_card_equal_the_cpu_searches(dev):
    """`search(pack=False)` and `search_codes(mode="lut", pack=False)` on
    the card (f32 index and tables, integer data with a lane pile-up
    that the counts flag) return the CPU searches' results by position,
    in both classes of the card's plan; and the streamed searches on the
    card equal the resident ones on the card."""
    rng = np.random.default_rng(6)
    n, m, h, k = 30_000, 7, 64, 50
    C = rng.integers(-1, 2, (m, h, 32)).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    B[np.arange(20) * 128] = B[0]          # 20 exact ties in lane 0
    ncb = rng.integers(0, 300, h).astype(np.float32)
    nco = rng.integers(0, h, n).astype(np.int32)
    Q = rng.integers(-1, 2, (9, 32)).astype(np.float32)
    Q[0] = C[np.arange(m), B[0]].sum(0)
    for k in (k, 700):
        dec, lut = [], []
        for device in ("cpu", dev):
            t = lambda a: torch.as_tensor(a, device=device)
            nt = t(ncb)[t(nco).long()]
            idx = tsp.build_index(t(C), t(B), norm_term=nt,
                                  dtype=torch.float32)
            dec.append(tsp.search(idx, t(Q), k, pack=False))
            cidx = tsc.build_codes_index(t(C), t(B), norms_cbook=t(ncb),
                                         norms_codes=t(nco))
            lut.append(tsc.search_codes(cidx, t(Q), k, mode="lut",
                                        pack=False, op_dtype=torch.float32))
        _same_up_to_ties(dec[0], dec[1])
        _same_up_to_ties(lut[0], lut[1])
        _same_up_to_ties(dec[1], lut[1])
    t = lambda a: torch.as_tensor(a, device=dev)
    sd = tsp.search_streamed(t(C), B, t(Q), k, norm_term=ncb[nco],
                             shard_size=11_000, pack=False)
    _same_up_to_ties(sd, dec[1])
    packed = tsc.pack_codes(torch.as_tensor(B), torch.as_tensor(nco)).numpy()
    for kw in (dict(mode="lut", pack=False, op_dtype=torch.float32),
               dict(mode="decode", op_dtype=torch.float32)):
        ss = tsc.search_codes_streamed(t(C), packed, t(Q), k,
                                       norms_cbook=t(ncb), mprime=m + 1,
                                       shard_n=11_000, **kw)
        if kw["mode"] == "lut":
            _same_up_to_ties(ss, lut[1])
        else:
            rd, _ = tsc.search_codes(cidx, t(Q), k, **kw)
            # packed keys: each shard cuts the raw score to its own step
            step = 2.0 ** (tsp._pack_idbits(32768) - 23)
            raw = rd - (t(Q) ** 2).sum(-1, keepdim=True)
            assert bool(((ss[0] - rd).abs() <= step * raw.abs() + 1e-6).all())


def test_f32_scans_never_fall_back(dev, tmp_path, monkeypatch):
    """What the exact-float kernels do not take raises on CUDA tensors
    (keep=0, the JAX form, is a plain version only; the pair merge is
    compiled to r = 48); and where the kernels cannot be built, the calls
    raise instead of taking the plain versions."""
    from rayuela_tpu_torch.kernels import build
    idx, Q, Qm = _decoded_case(dev, "int", torch.float32, 3000, 24, 4)
    with pytest.raises(ValueError, match="keep=0"):
        tsp.scan_f32_topk(Qm, idx.Xd, idx.x2, r=16, tile=2048, keep=0)
    with pytest.raises(ValueError, match="keep=8"):
        tsp.scan_f32_candidates(Qm, idx.Xd, idx.x2, tile=8192, keep=8)
    cv, ci = tsp.scan_f32_candidates(Qm, idx.Xd, idx.x2, tile=2048, keep=2)
    with pytest.raises(ValueError, match="r=96"):
        tsp.pair_merge(cv, ci, 96)
    T = torch.zeros((8, 256, 4), device=dev)
    packed = torch.zeros((3000, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="keep=0"):
        tsc.codes_lut_topk_f32(T, packed, r=16, tile=2048, keep=0)
    taus = torch.zeros(4, device=dev)
    taui = torch.zeros(4, dtype=torch.int32, device=dev)
    blocker = tmp_path / "not_a_directory"
    blocker.write_text("")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", blocker / "_build")
    for call in (
            lambda: tsp.scan_f32_candidates(Qm, idx.Xd, idx.x2, tile=2048,
                                            keep=2),
            lambda: tsp.pair_merge(cv, ci, 16),
            lambda: tsp.verify_counts(Qm, idx.Xd, idx.x2, taus, taui,
                                      tile=2048),
            lambda: tsc.codes_lut_f32_candidates(T, packed, tile=2048,
                                                 keep=2),
            lambda: tsc.codes_verify_counts(T, packed, taus, taui,
                                            tile=2048)):
        with pytest.raises(OSError):
            call()


# ---------------------------------------------------------------------------
# The wide configurations: rows over several d-blocks (K1, K4, K14, K8,
# K9, K10), 128-bit codes with f32 tables (K5, K6, K7 at 8 queries a
# CTA), the fusion probe's kernel
# ---------------------------------------------------------------------------

WIDE_D = (384, 784, 960)


def _wide_codes_case(dev, *, pq, kind, dtype, n, nq, d, seed=0, m=None):
    """`_case` at width d: PQ-8 (subspaces of ceil(d/8)) or 7 additive
    codebooks + the norms byte, or ``m`` codebooks."""
    rng = np.random.default_rng(seed)
    m = m or (8 if pq else 7)
    ds = -(-d // m) if pq else d
    mk = (lambda *sh: rng.integers(-2, 3, sh)) if kind == "int" \
        else (lambda *sh: rng.standard_normal(sh))
    t = lambda a, dt=torch.float32: None if a is None else torch.as_tensor(
        np.asarray(a), dtype=dt, device=dev)
    C, Q = t(mk(m, H, ds)), t(mk(nq, d))
    B = t(rng.integers(0, H, (n, m)), torch.int32)
    ncb = None if pq else t(rng.integers(0, 500, H))
    nco = None if pq else t(rng.integers(0, H, n), torch.int32)
    idx = tsc.build_codes_index(C, B, pq=pq, d=d, norms_cbook=ncb,
                                norms_codes=nco)
    Cf, nrm = idx.decode_operands(d, dtype)
    return idx, Q, Cf, nrm, tsc._query_operand(Q, Cf.shape[1], dtype)


@pytest.mark.parametrize("pq,m,d", [(pq, None, d) for pq in (True, False)
                                    for d in WIDE_D]
                         + [(False, 15, 128), (True, 16, 128),
                            (False, 15, 960)])
def test_wide_codes_kernels_equal_plain_on_integer_data(dev, pq, m, d):
    """K1 (and K2 on its output), K4 and K14 against their plain versions:
    identical int32 outputs over rows of several d-blocks (dp = 384, 896,
    1024; the PQ layout's |x_hat|^2 summed over the blocks), and at
    m' = 16, four packed words a row (SR-D-15+1 with its norms byte,
    PQ-16), at d = 128 and 960."""
    n, nq = 20_000, 40
    idx, Q, Cf, nrm, Qm = _wide_codes_case(dev, pq=pq, kind="int",
                                           dtype=torch.float32, n=n, nq=nq,
                                           d=d, m=m)
    assert Cf.shape[1] == -(-d // 128) * 128
    idbits = tsp._pack_idbits(-(-n // 8192) * 8192)
    kw = dict(tile=8192, keep=4, idbits=idbits, has_norms=not pq)
    n1, n4, n14 = (tsc.codes_decode_candidates.launches,
                   tsc.codes_decode_topk.launches,
                   tsc.codes_decode_onepass.launches)
    cand, disc = tsc.codes_decode_candidates(Qm, Cf, nrm, idx.packed, **kw)
    cand0, disc0 = tsc.codes_decode_candidates_plain(Qm, Cf, nrm, idx.packed,
                                                     **kw)
    assert torch.equal(cand, cand0) and torch.equal(disc, disc0)
    assert torch.equal(tsc.cand_merge(cand, disc, 32),
                       tsc.cand_merge_plain(cand, disc, 32))
    idb4 = tsp._pack_idbits(-(-n // 2048) * 2048)
    kw4 = dict(tile=2048, r=48, idbits=idb4, has_norms=not pq)
    assert torch.equal(
        tsc.codes_decode_topk(Qm, Cf, nrm, idx.packed, **kw4),
        tsc.codes_decode_topk_plain(Qm, Cf, nrm, idx.packed, **kw4))
    for r, keep, tile in ((14, 2, 2048), (28, 4, 8192)):
        kw14 = dict(tile=tile, r=r, keep=keep, has_norms=not pq,
                    idbits=tsp._pack_idbits(-(-n // tile) * tile))
        assert torch.equal(
            tsc.codes_decode_onepass(Qm, Cf, nrm, idx.packed, **kw14),
            tsc.codes_decode_onepass_plain(Qm, Cf, nrm, idx.packed, **kw14))
    torch.cuda.synchronize()
    assert tsc.codes_decode_candidates.launches == n1 + 1
    assert tsc.codes_decode_topk.launches == n4 + 1
    assert tsc.codes_decode_onepass.launches == n14 + 2


@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_decoded_kernels_equal_plain_on_integer_data(dev, d, dtype):
    """K8 (both forms), K9 with the pair merge, and K10 over rows of
    several d-blocks (the last one partial at d = 784 and 960): identical
    keys, pairs and counts (small integers are exact in bf16 too)."""
    n, nq = 20_001, 33
    idx, Q, Qm = _decoded_case(dev, "int", dtype, n, d, nq)
    assert idx.Xd.shape[1] == d
    n8, n9, n10 = (tsp.scan_candidates.launches, tsp.scan_f32_candidates
                   .launches, tsp.verify_counts.launches)
    kw = dict(tile=8192, keep=4, premin=0,
              idbits=tsp._pack_idbits(-(-n // 8192) * 8192))
    got = tsp.scan_candidates(Qm, idx.Xd, idx.x2, **kw)
    ref = tsp.scan_candidates_plain(Qm, idx.Xd, idx.x2, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    kw1 = dict(tile=2048, r=48, premin=0,
               idbits=tsp._pack_idbits(-(-n // 2048) * 2048))
    assert torch.equal(tsp.scan_onepass(Qm, idx.Xd, idx.x2, **kw1),
                       tsp.scan_onepass_plain(Qm, idx.Xd, idx.x2, **kw1))
    cv, ci = tsp.scan_f32_candidates(Qm, idx.Xd, idx.x2, tile=8192, keep=2)
    cv0, ci0 = tsp.scan_f32_candidates_plain(Qm, idx.Xd, idx.x2, tile=8192,
                                             keep=2)
    assert torch.equal(cv, cv0) and torch.equal(ci, ci0)
    s, i, fl = tsp.scan_topk_f32(Q, idx.Xd, idx.x2, k=100, r=16, tile=8192,
                                 keep=2)
    taus, taui = s[:, -1].contiguous(), i[:, -1].contiguous()
    cnt = tsp.verify_counts(Qm, idx.Xd, idx.x2, taus, taui, tile=8192)
    cnt0 = tsp.verify_counts_plain(Qm, idx.Xd, idx.x2, taus, taui, tile=8192)
    torch.cuda.synchronize()
    assert torch.equal(cnt, cnt0)
    assert tsp.scan_candidates.launches == n8 + 1
    assert tsp.scan_f32_candidates.launches == n9 + 2
    assert tsp.verify_counts.launches == n10 + 2


@pytest.mark.parametrize("d", WIDE_D)
def test_wide_scans_on_gaussian_data(dev, d):
    """PERF.md's limits over several d-blocks: K1 (both layouts), K14
    and K8 in bf16 within one truncation step (+ the f32 rounding of
    sums of d terms near zero) of their plain versions with 99% of ids
    by position; K9 in f32 within 1e-5 relative (+ 1e-4), at least 99.9%
    of ids by position, equal flags."""
    n, nq, k = 50_000, 33, 100
    idbits = tsp._pack_idbits(-(-n // 8192) * 8192)
    atol = d * 2e-6
    for pq in (True, False):
        idx, Q, Cf, nrm, Qm = _wide_codes_case(
            dev, pq=pq, kind="gauss", dtype=torch.bfloat16, n=n, nq=nq, d=d)
        s, i, _ = tsc.scan_codes_decode_topk_2p(Q, Cf, nrm, idx.packed, k=k,
                                                pq=pq, r=16, keep=2)
        o0 = tsc.cand_merge_plain(*tsc.codes_decode_candidates_plain(
            Qm, Cf, nrm, idx.packed, tile=8192, keep=2, idbits=idbits,
            has_norms=not pq), 16)
        _close((s, i), tsp._packed_candidates(o0, nq, 16, k, idbits)[:2],
               idbits, atol=atol)
        s, i, _ = tsc.scan_codes_decode_topk(Q, Cf, nrm, idx.packed, k=k,
                                             pq=pq, r=28, keep=4, tile=8192)
        o0 = tsc.codes_decode_onepass_plain(Qm, Cf, nrm, idx.packed,
                                            tile=8192, r=28, keep=4,
                                            idbits=idbits, has_norms=not pq)
        _close((s, i), tsp._packed_candidates(o0, nq, 28, k, idbits)[:2],
               idbits, atol=atol)
    idx, Q, Qm = _decoded_case(dev, "gauss", torch.bfloat16, n, d, nq)
    s, i, _ = tsp.scan_topk_packed(Q, idx.Xd, idx.x2, k=k, r=16, tile=8192,
                                   keep=2)
    o0 = tsp.cand_merge_plain(*tsp.scan_candidates_plain(
        Qm, idx.Xd, idx.x2, tile=8192, keep=2, premin=0, idbits=idbits), 16)
    _close((s, i), tsp._packed_candidates(o0, nq, 16, k, idbits)[:2],
           idbits, atol=atol)
    idx, Q, Qm = _decoded_case(dev, "gauss", torch.float32, n, d, nq)
    s, i, fl = tsp.scan_topk_f32(Q, idx.Xd, idx.x2, k=k, r=16, tile=8192,
                                 keep=2)
    ov, oi = tsp.scan_f32_topk_plain(Qm, idx.Xd, idx.x2, r=16, tile=8192,
                                     keep=2)
    s0, i0, fl0 = tsp._finish_f32(
        ov, oi, k, 16, 2, lambda ts, ti: tsp.verify_counts_plain(
            Qm, idx.Xd, idx.x2, ts, ti, tile=8192))
    assert bool(((s - s0).abs() <= 1e-5 * s0.abs() + 1e-4).all())
    assert float((i == i0).float().mean()) >= 0.999
    assert torch.equal(fl, fl0)


def _lut_case(dev, mprime, h, kind, n, nq, seed=7):
    """Tables (m', h, nq) f32 and packed codes of m' bytes (the last
    byte read as the norms byte, as the kernels do)."""
    rng = np.random.default_rng(seed)
    mk = (lambda *sh: rng.integers(-20, 21, sh)) if kind == "int" \
        else (lambda *sh: rng.standard_normal(sh))
    T = torch.as_tensor(np.asarray(mk(mprime, h, nq)), dtype=torch.float32,
                        device=dev)
    B = torch.as_tensor(rng.integers(0, h, (n, mprime)), dtype=torch.int32,
                        device=dev)
    return T.contiguous(), tsc.pack_codes(B[:, :-1], B[:, -1])


@pytest.mark.parametrize("mprime,qb", [(14, 16), (15, 8), (16, 8)])
@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_lut_kernels_at_128_bits_equal_plain(dev, mprime, qb, kind):
    """K5, K6 and K7 with f32 tables of h = 256 entries: 16 queries' tables
    fit up to m' = 14; from 15 (the 128-bit configurations: 15 + the
    norms byte, PQ-16) a CTA takes 8 queries (`rq_lut_layout`). Either
    way the sums go in the plain versions' order: identical outputs on
    any data, nq ragged against both query blocks."""
    n, nq, tile, r, keep = 20_001, 37, 8192, 16, 2
    assert tsc._lut_layout(mprime, H, 0, dev)[0] == qb
    assert tsc._lut_layout(mprime, H, 1, dev)[0] == 16
    T, packed = _lut_case(dev, mprime, H, kind, n, nq)
    n5, n6, n7 = (tsc.codes_lut_candidates.launches,
                  tsc.codes_lut_f32_candidates.launches,
                  tsc.codes_verify_counts.launches)
    kw = dict(tile=tile, keep=keep,
              idbits=tsp._pack_idbits(-(-n // tile) * tile))
    got = tsc.codes_lut_candidates(T, packed, **kw)
    ref = tsc.codes_lut_candidates_plain(T, packed, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    s, i, fl = tsc.scan_codes_topk(T, packed, k=100, r=r, tile=tile,
                                   keep=keep, lut_dtype=torch.float32,
                                   pack=False)
    ov, oi = tsc.codes_lut_topk_f32_plain(T, packed, r=r, tile=tile,
                                          keep=keep)
    s0, i0, fl0 = tsp._finish_f32(
        ov, oi, 100, r, keep, lambda ts, ti: tsc.codes_verify_counts_plain(
            T, packed, ts, ti, tile=tile))
    torch.cuda.synchronize()
    assert torch.equal(s, s0) and torch.equal(i, i0) and torch.equal(fl, fl0)
    assert tsc.codes_lut_candidates.launches == n5 + 1
    assert tsc.codes_lut_f32_candidates.launches == n6 + 1
    assert tsc.codes_verify_counts.launches == n7 + 1


@pytest.mark.parametrize("mprime", [8, 14, 15, 16, 29])
@pytest.mark.parametrize("bf16", [0, 1])
def test_lut_exact_layout_is_the_kernels(dev, mprime, bf16):
    """K6/K7's layout comes from their source (`rq_lut_exact_layout`) and
    `scan_codes._lut_exact_layout` states it; where the tables fit, the
    card holds at least one CTA an SM."""
    lay = query("rq_lut_exact_layout", mprime, H, bf16, size=4, device=dev)
    assert lay[:3] == tsc._lut_exact_layout(mprime, H, bf16)
    assert (lay[3] >= 1) == bool(lay[0]), lay


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("keep", [2, 4])
def test_lut_f32_kernels_beyond_four_words_equal_plain(dev, kind, keep):
    """bf16 tables of m' = 29 (8 queries a CTA, eight code words: the
    words past the fourth are read in the step, not a step ahead): K6 and
    K7 equal their plain versions."""
    n, nq, tile, r = 20_001, 20, 8192, 16
    T, packed = _lut_case(dev, 29, H, kind, n, nq)
    T = T.to(torch.bfloat16).contiguous()
    cv, ci = tsc.codes_lut_f32_candidates(T, packed, tile=tile, keep=keep)
    cv0, ci0 = tsc.codes_lut_f32_candidates_plain(T, packed, tile=tile,
                                                  keep=keep)
    assert torch.equal(cv, cv0) and torch.equal(ci, ci0)
    s, i, fl = tsc.scan_codes_topk(T, packed, k=100, r=r, tile=tile,
                                   keep=keep, lut_dtype=torch.bfloat16,
                                   pack=False)
    ov, oi = tsc.codes_lut_topk_f32_plain(T, packed, r=r, tile=tile,
                                          keep=keep)
    s0, i0, fl0 = tsp._finish_f32(
        ov, oi, 100, r, keep, lambda ts, ti: tsc.codes_verify_counts_plain(
            T, packed, ts, ti, tile=tile))
    torch.cuda.synchronize()
    assert torch.equal(s, s0) and torch.equal(i, i0) and torch.equal(fl, fl0)


def test_icm_beyond_the_kernels_takes_the_xla_path(dev):
    """Codebooks of h = 2048 labels: `encoding_icm(impl="auto")` and
    `api.index_base` of an LSQ model complete through the ``xla`` path,
    chosen by shape before any launch (K11 and K12 never launch); the ILS
    codes cost no more than the start codes; an explicit ``"pallas"`` or
    ``"pallas-ils"`` raises. Viterbi takes its ``xla`` path by shape
    where the JAX package's ``auto`` serves a shape K13 does not take
    (m = 1 at h = 1152; h = 1030, not a multiple of 8) and keeps K13's
    refusal where neither kernel holds it (m = 16 at h = 512), which
    ``impl="xla"`` serves."""
    rng = np.random.default_rng(8)
    n, m, h = 3000, 4, 2048
    X = torch.as_tensor(rng.standard_normal((n, D)), dtype=torch.float32,
                        device=dev)
    C = torch.as_tensor(rng.standard_normal((m, h, D)) * 0.3,
                        dtype=torch.float32, device=dev)
    B0 = torch.as_tensor(rng.integers(0, h, (n, m)), dtype=torch.int32,
                         device=dev)
    launches = (ticm.icm_sweeps.launches, ticm.encoding_ils.launches)
    xla = ticm.encoding_icm.routes["xla"]
    gen = torch.Generator(device=dev).manual_seed(0)
    B = ticm.encoding_icm(gen, X, C, B0, ilsiter=4)
    model = tapi.MCQModel("lsq", C, h=h, train_codes=B0)
    index = tapi.index_base(model, X, ilsiter=2)
    dists, ids = tapi.search(index, X[:50], k=5)
    torch.cuda.synchronize()
    assert ticm.encoding_icm.routes["xla"] == xla + 2
    assert (ticm.icm_sweeps.launches, ticm.encoding_ils.launches) == launches
    cost = lambda codes: veccost_chunked(X, C, codes)
    assert bool((cost(B) <= cost(B0) + 1e-3).all())
    assert bool(torch.isfinite(dists).all()) and bool((ids < n).all())
    for impl in ("pallas", "pallas-ils"):
        with pytest.raises(ValueError, match="h=2048"):
            ticm.encoding_icm(gen, X, C, B0, ilsiter=1, impl=impl)
    Xv = X[:256].contiguous()
    n13, xv = tvit.viterbi_encode.launches, tvit.viterbi_encode.routes["xla"]
    for mv, hv in ((1, 1152), (2, 1030)):
        Cv = torch.as_tensor(rng.standard_normal((mv, hv, D)),
                             dtype=torch.float32, device=dev)
        got = tvit.viterbi_encode(Xv, Cv)
        assert torch.equal(got, tvit.viterbi_encode_plain(Xv, Cv, chunk=64))
    assert tvit.viterbi_encode.launches == n13
    assert tvit.viterbi_encode.routes["xla"] == xv + 2
    Cv = torch.as_tensor(rng.standard_normal((16, 512, D)),
                         dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="h <= 1024"):
        tvit.viterbi_encode(Xv, Cv)
    got = tvit.viterbi_encode(Xv, Cv, impl="xla")
    assert tvit.viterbi_encode.launches == n13
    assert torch.equal(got, tvit.viterbi_encode_plain(Xv, Cv, chunk=64))


def test_lut_tables_beyond_8_queries_raise(dev):
    """Where not even 8 queries' tables fit (f32, m' = 29 at h = 256:
    4 pairs x 8 bytes x 7424 entries) the LUT kernels raise; bf16 tables
    of that width take 8 queries."""
    T, packed = _lut_case(dev, 29, H, "int", 3000, 4)
    with pytest.raises(ValueError, match="8 queries"):
        tsc.codes_lut_candidates(T, packed, tile=8192, keep=2, idbits=8)
    with pytest.raises(ValueError, match="8 queries"):
        tsc.codes_lut_f32_candidates(T, packed, tile=8192, keep=2)
    assert tsc._lut_layout(29, H, 1, dev)[0] == 8
    Tb = T.to(torch.bfloat16).contiguous()
    kw = dict(tile=8192, keep=2, idbits=8)
    got = tsc.codes_lut_candidates(Tb, packed, **kw)
    ref = tsc.codes_lut_candidates_plain(Tb, packed, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("split", [True, False])
def test_fusion_kernel_equals_plain(dev, split):
    """The fusion probe's kernel (each product and sum rounded apart)
    equals its plain version bit for bit for every k, rows ragged
    against its CTAs' ranges."""
    from rayuela_tpu_torch.demos import fusion_probe as tfp
    rng = np.random.default_rng(8)
    for rows in (8 * 1001, 65_536):
        X = torch.as_tensor(rng.standard_normal((rows, 256),
                                                dtype=np.float32),
                            device=dev)
        for k in tfp.KS:
            n0 = tfp.fusion_chain.launches
            got = tfp.fusion_chain(X, k, split=split)
            torch.cuda.synchronize()
            assert tfp.fusion_chain.launches == n0 + 1
            assert torch.equal(got, tfp.fusion_chain_plain(X, k))
    regs = tfp.kernel_attrs(8, split, dev)
    assert regs[0] > 0 and regs[1] == 0


def test_search_at_gist_width_in_every_mode(dev, monkeypatch):
    """`api.search` at d = 960 through every scan on the card (decoded,
    decoded pack=False, codes two-pass, one-pass and LUT, LUT
    pack=False) does not raise, launches its kernels, and hands an exact
    scan no more queries than the certificate flagged."""
    from rayuela_tpu_torch import convert
    from rayuela_tpu_torch.search import linscan
    rng = np.random.default_rng(9)
    n, d, m, h, nq, k = 30_000, 960, 4, 16, 64, 50
    C = (rng.standard_normal((m, h, d)) * 0.5).astype(np.float32)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = torch.as_tensor(rng.standard_normal((nq, d)), dtype=torch.float32,
                        device=dev)
    tc = rng.integers(0, h, (4000, m)).astype(np.int32)
    model = convert.model_from_arrays("rvq", C, h=h, device=dev,
                                      train_codes=tc)
    dec = tapi.index_base(model, X)
    codes = tapi.index_base(model, X, mode="codes")
    rescued = []
    exact, lut_tiled = linscan.exact_rescan, tsc._lut_scan_tiled

    def count_exact(Qx, *a, **kw):
        rescued.append(Qx.shape[0])
        return exact(Qx, *a, **kw)

    def count_lut(index, Qx, *a, **kw):
        rescued.append(Qx.shape[0])
        return lut_tiled(index, Qx, *a, **kw)

    monkeypatch.setattr(linscan, "exact_rescan", count_exact)
    monkeypatch.setattr(tsc, "_lut_scan_tiled", count_lut)
    si, sc = dec.scan_index, codes.scan_index
    Cf, nrm = sc.decode_operands(d, torch.bfloat16)
    T = tsc.build_luts(sc.C, Q, pq=sc.pq, d=d, norms_cbook=sc.norms_cbook)
    r, keep, tile = tsp._scan_config(k)
    rf, kf, tf, _ = tsp._f32_config(k, dev)
    ro, ko, to = tsc._onepass_config(k, sc.mprime)
    cases = (
        (dec, {}, tsp.scan_candidates, lambda: tsp.scan_topk_packed(
            Q, si.Xd, si.x2, k=k, r=r, tile=tile, keep=keep)[2]),
        (dec, dict(pack=False), tsp.verify_counts, lambda: tsp.scan_topk_f32(
            Q, si.Xd, si.x2, k=k, r=rf, tile=tf, keep=kf)[2]),
        (codes, {}, tsc.codes_decode_candidates,
         lambda: tsc.scan_codes_decode_topk_2p(
             Q, Cf, nrm, sc.packed, k=k, pq=sc.pq, r=r, keep=keep)[2]),
        (codes, dict(twopass=False), tsc.codes_decode_onepass,
         lambda: tsc.scan_codes_decode_topk(
             Q, Cf, nrm, sc.packed, k=k, pq=sc.pq, r=ro, keep=ko,
             tile=to)[2]),
        (codes, dict(mode="lut"), tsc.codes_lut_candidates,
         lambda: tsc.scan_codes_topk(T.to(torch.bfloat16), sc.packed, k=k,
                                     r=r, tile=tile, keep=keep,
                                     lut_dtype=torch.bfloat16)[2]),
        (codes, dict(mode="lut", pack=False, op_dtype=torch.float32),
         tsc.codes_verify_counts, lambda: tsc.scan_codes_topk(
             T, sc.packed, k=k, r=rf, tile=tf, keep=kf,
             lut_dtype=torch.float32, pack=False)[2]))
    for index, kw, kernel, flags in cases:
        rescued.clear()
        n0 = kernel.launches
        dists, ids = tapi.search(index, Q, k=k, **kw)
        torch.cuda.synchronize()
        assert kernel.launches > n0, kw
        assert dists.shape == (nq, k) and bool(torch.isfinite(dists).all())
        assert bool(((ids >= 0) & (ids < n)).all())
        assert sum(rescued) <= int(flags().sum()), kw
