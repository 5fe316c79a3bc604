"""The host-side mirrors of the layouts of K8's bf16 candidates body, of
the ICM kernels K11/K12 and of the exact-float LUT kernels K6/K7, on the
CPU: the vectors or queries a CTA takes, its shared bytes and whether it
fits, for every shape the wrappers take. `tests/test_torch_cuda.py`
holds each mirror to the kernel's own answer on the card
(`rq_scan_candidates_layout`, `rq_icm_layout`, `rq_lut_exact_layout`)."""

import numpy as np
import pytest
import torch

from rayuela_tpu_torch.ops import icm as ticm
from rayuela_tpu_torch.search import scan as tsp
from rayuela_tpu_torch.search import scan_codes as tsc

# shared memory an H100 CTA may opt in to, and what two CTAs an SM leave
# each (every CTA also takes 1 KB of the SM's)
CAP = 232_448
CAP2 = (CAP - 1024) // 2


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    the data of later tests in the same process depend on this file)."""
    return np.random.default_rng(0)


@pytest.mark.parametrize("dp", [8, 104, 128, 256, 264, 960, 1024, 2400])
def test_bf16_candidates_layout_fits_two_ctas_at_any_width(dp):
    """K8 on bf16: 32 queries a CTA, stages of 128 dimensions, 2 deep, two
    CTAs an SM at every width. A stage holds 128 rows at 136 bf16 and the
    step's x2; beyond one d-block also the 32 queries' block, so the CTA
    does not grow with dp; at one d-block the CTA keeps its queries whole
    (dp + 8 bf16), the rows' norms and their 8 partial sums each, the
    queries' margins and 8 warps x 256 chain requests (an int and a
    16-bit item each)."""
    qb, kc, stages, smem = tsp._candidates_layout(dp, 1)
    assert (qb, kc, stages) == (32, 128, 2)
    if dp <= 256:
        want = 2 * (2 * 128 * 136 + 512) + 2 * 32 * (dp + 8) \
            + 4 * (9 * 128 + 32) + 6 * 8 * 256
    else:
        want = 2 * (2 * 160 * 136 + 512)
    assert smem == want
    assert smem <= CAP2
    assert smem % 16 == 0


@pytest.mark.parametrize("dp", [8, 104, 128, 256, 264, 960, 2432])
def test_f32_candidates_layout_is_the_fmaf_body(dp):
    """K8 on f32 keeps the 4 x 4-blocked fmaf body: 32 queries, one
    d-block (the row up to 256, else 128) transposed at 129 floats a
    dimension, the queries of that block and the rows' norms."""
    db = dp if dp <= 256 else 128
    assert tsp._candidates_layout(dp, 0) == (
        32, db, 1, 4 * (db * 129 + 32 * db + 128))


@pytest.mark.parametrize("m", [7, 8, 15, 16])
@pytest.mark.parametrize("d,vectors,ctas", [
    (8, 32, 2), (100, 32, 2), (128, 32, 2), (256, 32, 2), (440, 16, 2),
    (960, 8, 2), (2400, 8, 1)])
def test_icm_layout_takes_the_largest_cta_that_fits(m, d, vectors, ctas):
    """K11 and K12: the largest CTA (32, 16 or 8 vectors) with which two
    CTAs fit an SM, else one; the shared bytes are xb and rest (bf16 rows
    of d rounded up to 8 and then 16, + 8), S (f32 rows of d rounded up
    to 8), the codes twice, K12's energies, the argmin exchange of 4
    warps and the visit's new and old codes (the codebook is read from
    L1/L2, not staged)."""
    got = ticm._icm_layout(d, m)
    dp = -(-d // 8) * 8
    xst = -(-dp // 16) * 16 + 8

    def smem(v):
        return (4 * v * xst + 4 * v * dp + 8 * v * m + 4 * v + 32 * v
                + 8 * v)

    assert got == (vectors, ctas, smem(vectors))
    cap = CAP2 if ctas == 2 else CAP
    assert got[2] <= cap
    # nothing larger fits the same number of CTAs an SM
    assert all(smem(v) > cap for v in (32, 16, 8) if v > vectors)
    if ctas == 1:
        assert smem(8) > CAP2


@pytest.mark.parametrize("d,m", [(3700, 8), (4096, 4), (3600, 64)])
def test_icm_layout_raises_where_no_cta_fits(d, m):
    """Where not even 8 vectors fit one CTA the layout raises, and so do
    the wrappers on the card."""
    with pytest.raises(ValueError, match="shared memory"):
        ticm._icm_layout(d, m)


@pytest.mark.parametrize("h,hk", [(16, 128), (32, 128), (128, 128),
                                  (200, 256), (256, 256), (1000, 1024),
                                  (1024, 1024)])
def test_labels_pad_to_whole_blocks(h, hk):
    """The kernels take labels in blocks of 128: h pads to the next
    multiple (zero rows whose |C|^2 is +inf never win an argmin)."""
    assert ticm._padded_h(h) == hk


def test_cpu_operands_are_the_tensors_themselves(rng):
    """On the CPU `IcmOperands` keeps X and C as they are (the plain
    versions run at f32): no padding of d or h, no bf16 copies."""
    X = torch.as_tensor(rng.standard_normal((50, 100)).astype(np.float32))
    C = torch.as_tensor(rng.standard_normal((7, 200, 100)).astype(np.float32))
    ops = ticm.IcmOperands(X, C)
    assert ops.X is X and ops.C is C and not ops.cuda
    assert not hasattr(ops, "Cr") and not hasattr(ops, "Cf")


@pytest.mark.parametrize("h,d", [(16, 8), (200, 100), (256, 128), (128, 24)])
def test_fragment_order_of_the_codebook(rng, h, d):
    """The card's wrapper hands the kernels the codebook in the tensor
    cores' B-fragment order (`IcmOperands.Cf`, `_fragment_order`): per
    codebook, 32-label group and 16-dimension chunk, lane ``4 r + c``
    holds, for n-tile t < 4, label ``32 g + 8 t + r`` at dimensions ``2 c,
    2 c + 1`` (b0) and ``2 c + 8, 2 c + 9`` (b1), zeros past h and d."""
    m = 3
    C = torch.as_tensor(rng.standard_normal((m, h, d)).astype(np.float32))
    hk, d16 = ticm._padded_h(h), -(-d // 16) * 16
    Cb = torch.zeros(m, hk, d16, dtype=torch.bfloat16)
    Cb[:, :h, :d] = C.to(torch.bfloat16)
    Cf = ticm._fragment_order(Cb).reshape(m, hk // 32, d16 // 16, 32, 16)
    for g in range(hk // 32):
        for ks in range(d16 // 16):
            for lane in range(32):
                r, c = lane >> 2, lane & 3
                for t in range(4):
                    lab = 32 * g + 8 * t + r
                    k = 16 * ks + 2 * c
                    want = torch.stack([Cb[:, lab, k], Cb[:, lab, k + 1],
                                        Cb[:, lab, k + 8],
                                        Cb[:, lab, k + 9]], -1)
                    assert torch.equal(Cf[:, g, ks, lane, 4 * t:4 * t + 4],
                                       want)


@pytest.mark.parametrize("mprime,h,bf16,qb", [
    (8, 256, 0, 16), (8, 256, 1, 32), (16, 256, 0, 8), (16, 256, 1, 16),
    (14, 256, 0, 16), (15, 256, 0, 8), (8, 16, 0, 16), (8, 16, 1, 32),
    (28, 256, 0, 8), (29, 256, 1, 8), (29, 256, 0, 0), (57, 256, 1, 0)])
def test_lut_exact_layout_takes_the_most_queries_that_fit(mprime, h, bf16,
                                                          qb):
    """K6 and K7 keep the tables of a CTA's queries code-major, each
    entry's queries contiguous: the most of (32 on bf16 tables), 16 and 8
    queries whose m' h entries fit the shared memory a CTA may opt in to
    (m' h = 2048: 16 queries' f32 tables or 32 queries' bf16 ones, 128
    KB; m' h = 4096: 8 and 16), and 0 where not even 8 fit (the bytes then
    are 8 queries'). A thread reads 16 bytes of an entry (4 f32 or 8 bf16
    queries), 128 rows a CTA."""
    tb = 2 if bf16 else 4
    got = tsc._lut_exact_layout(mprime, h, bf16)
    q = qb or 8
    assert got == (qb, 128 * q * tb // 16, q * mprime * h * tb)
    if qb:
        assert got[2] <= CAP
    # nothing larger fits
    assert all(c * mprime * h * tb > CAP
               for c in ((32, 16, 8) if bf16 else (16, 8)) if c > qb)
    assert got[1] <= 512
