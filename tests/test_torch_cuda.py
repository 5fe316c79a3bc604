"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where torch sees no CUDA device, and
run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest imports jax, which the
port and these tests do not need).

On small-integer data every score is exact in f32, so kernel and plain
version must give identical int32 outputs. In bf16 on Gaussian data the
kernel sums in another order than cuBLAS: at least 99% of the ids agree
and every score moves by at most one truncation step."""

import numpy as np
import pytest
import torch

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


def _close(got, ref, idbits):
    (gv, gi), (rv, ri) = got, ref
    step = 2.0 ** (idbits - 23)
    tol = step * torch.maximum(gv.abs(), rv.abs())
    assert bool(((gv - rv).abs() <= tol).all())
    assert float((gi == ri).float().mean()) >= 0.99


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


@pytest.mark.parametrize("pq", [True, False])
def test_rescue_kernel_equals_plain_on_integer_data(dev, pq):
    n, nq = 20_000, 5
    idx, Q, Cf, nrm, Qm = _case(dev, pq=pq, kind="int",
                                dtype=torch.float32, n=n, nq=nq)
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
    with pytest.raises(ValueError, match="r=12"):
        tsc.cand_merge(cand, cand[:1].contiguous(), 12)
