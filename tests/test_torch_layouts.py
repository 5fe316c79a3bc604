"""The host-side mirrors of the layouts of K8's candidates bodies, of
the ICM kernels K11/K12, of the LUT body of K5, K6 and K7 and of the
Viterbi kernel K13, on the CPU: the vectors or queries a CTA takes, its
shared bytes and whether it fits, for every shape the wrappers take.
`tests/test_torch_cuda.py` holds each mirror to the kernel's own answer
on the card (`rq_scan_candidates_layout`, `rq_icm_layout`,
`rq_lut_exact_layout`, `rq_viterbi_layout`)."""

import numpy as np
import pytest
import torch

from rayuela_tpu_torch.ops import icm as ticm
from rayuela_tpu_torch.ops import viterbi as tvit
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
def test_f32_candidates_layout_is_the_exact_float_body(dp):
    """K8 on f32 rows runs K9's exact-float body at every width: 64
    queries a CTA, stages of 64 dimensions, 2 deep; a stage holds 8 row
    ids x 16 lanes of rows and the 64 queries, each at 64 f32 + 16
    bytes, so the CTA does not grow with dp and two fit an SM."""
    smem = 2 * (8 * 16 * 272 + 64 * 272)
    assert tsp._candidates_layout(dp, 0) == (64, 64, 2, smem)
    assert smem == tsp._exact_layout(2, 0)[6] == tsp._exact_layout(4, 0)[6]
    assert smem <= CAP2
    assert smem % 16 == 0


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
    """K5, K6 and K7 keep the tables of a CTA's queries code-major, each
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mprime,h", [(5, 256), (8, 256), (14, 256),
                                      (15, 256), (16, 256), (28, 256),
                                      (29, 256), (56, 256), (57, 256),
                                      (29, 16), (64, 128)])
def test_lut_operands_refused_where_no_query_block_fits(mprime, h, dtype):
    """The card's check of LUT operands (`_check_lut_layout`, the same for
    K5, K6 and K7: one body, one layout) refuses the tables exactly where
    `_lut_exact_layout` has no query block (f32 beyond m' h = 7104 at h =
    256: 8 queries' tables past the shared memory), with one message that
    names the bytes of 8 queries' tables; a code beyond one byte and
    2**20 queries are refused on their own."""
    bf16 = int(dtype == torch.bfloat16)
    qb, _, smem = tsc._lut_exact_layout(mprime, h, bf16)
    if qb:
        tsc._check_lut_layout(mprime, h, 1000, dtype)
    else:
        with pytest.raises(ValueError) as err:
            tsc._check_lut_layout(mprime, h, 1000, dtype)
        assert str(err.value) == (f"m'*h={mprime * h} tables of 8 queries "
                                  f"({smem} bytes) exceed the kernels' "
                                  "shared memory")
        assert smem == 8 * mprime * h * (2 if bf16 else 4) > CAP
    with pytest.raises(ValueError, match="h=512 > 256"):
        tsc._check_lut_layout(mprime, 512, 1000, dtype)
    with pytest.raises(ValueError, match="2\\*\\*20"):
        tsc._check_lut_layout(mprime, 16, 1 << 20, dtype)


def _k13_smem(v, slots, m, h, d):
    """K13's shared bytes: the ring of 8 KB slots, f_i and f_{i+1} (one
    buffer at m = 1) as f32 (h, v), the vectors as f32 rows of d rounded
    up to 16 plus 4, two mbarriers a slot and two for the vectors."""
    dp = -(-d // 16) * 16
    return (8192 * slots + 4 * min(m, 2) * h * v + 4 * v * (dp + 4)
            + 8 * (2 * slots + 2))


@pytest.mark.parametrize("m,h,d,vectors,slots,ctas", [
    (7, 256, 128, 32, 4, 2), (15, 256, 128, 32, 4, 2),
    (7, 256, 960, 32, 4, 1), (15, 256, 960, 32, 4, 1),
    (16, 256, 128, 32, 4, 2), (11, 512, 128, 16, 4, 2),
    (4, 1024, 128, 8, 4, 2), (1, 256, 128, 32, 4, 2),
    (3, 100, 24, 32, 4, 2), (2, 1024, 128, 8, 4, 2),
    (8, 256, 1500, 16, 4, 1), (8, 1024, 4000, 8, 4, 1)])
def test_viterbi_layout_takes_the_largest_instance_that_fits(
        m, h, d, vectors, slots, ctas):
    """K13: the most vectors a CTA (32, 16, 8) with at most 8192 (vectors
    x labels, h rounded up to 4), then two CTAs an SM where they fit,
    then the deepest ring (4, 3, 2 slots); its forward costs take two
    stages whatever m, so m changes nothing but at m = 1."""
    got = tvit._viterbi_layout(m, h, d)
    assert got == (vectors, slots, ctas, _k13_smem(vectors, slots, m, h, d))
    hp = -(-h // 4) * 4
    cap = CAP2 if ctas == 2 else CAP
    assert got[3] <= cap and vectors * hp <= 8192
    # no larger instance fits: more vectors (within the label cap) at one
    # CTA an SM, the same vectors at more CTAs, a deeper ring
    assert all(_k13_smem(v, 2, m, h, d) > CAP
               for v in (32, 16) if v > vectors and v * hp <= 8192)
    if ctas == 1:
        assert _k13_smem(vectors, 2, m, h, d) > CAP2
    assert slots == 4 or _k13_smem(vectors, slots + 1, m, h, d) > cap


@pytest.mark.parametrize("m,h,d", [
    (8, 256, 128), (16, 256, 128), (4, 1024, 128), (16, 512, 128),
    (2, 1152, 128), (2, 2048, 16), (12, 512, 128), (11, 512, 128),
    (1, 1152, 128), (1, 2048, 128), (2, 1030, 128), (16, 516, 128)])
def test_viterbi_smallest_instance_within_the_former_bytes(m, h, d):
    """At every shape of the route test (`test_torch_routes.py::
    test_viterbi_route_follows_the_kernels_shapes`) K13's smallest
    instance (8 vectors, one CTA an SM, 2 slots) takes no more shared
    memory than the former layout (`_smem_bytes`), so the kernel fits
    every shape `viterbi_kernel_takes` names, and the layout answers
    there."""
    assert _k13_smem(8, 2, m, h, d) <= tvit._smem_bytes(m, h, d)
    if tvit.viterbi_kernel_takes(m, h, d):
        assert tvit._viterbi_layout(m, h, d)[3] <= CAP


@pytest.mark.parametrize("m,h,d", [(2, 1025, 128), (1, 2048, 128),
                                   (4, 1024, 7000), (2, 256, 60000),
                                   (0, 256, 128)])
def test_viterbi_layout_raises_where_nothing_fits(m, h, d):
    """Past 1024 labels, or where not even 8 vectors' rows fit one CTA,
    the layout raises."""
    with pytest.raises(ValueError, match="no K13 layout"):
        tvit._viterbi_layout(m, h, d)


@pytest.mark.parametrize("h,d", [(256, 128), (100, 24), (130, 40)])
def test_viterbi_codebooks_in_fragment_order(rng, h, d):
    """The card's wrapper hands K13 the codebooks in the A-fragment order
    of mma m16n8k8 (`_k13_codebooks`): per codebook, 128-label block and
    16-dimension chunk, for m-tile t (16 labels) and k-step s (8
    dimensions) lane ``4 g + q`` holds labels ``g``, ``g + 8`` at
    dimensions ``q``, ``q + 4``, as (g, q), (g + 8, q), (g, q + 4), (g +
    8, q + 4); zeros past h and d. Summing lane products over the tiles
    in that order gives C X^T."""
    m = 3
    C = torch.as_tensor(rng.standard_normal((m, h, d)).astype(np.float32))
    Cf = tvit._k13_codebooks(C)
    nlb, nkc = -(-h // 128), -(-d // 16)
    assert Cf.shape == (m, nlb, nkc, 8, 2, 32, 4) and Cf.is_contiguous()
    Cp = torch.zeros(m, nlb * 128, nkc * 16)
    Cp[:, :h, :d] = C
    for lb in range(nlb):
        for kc in range(nkc):
            for t in range(8):
                for s in range(2):
                    for lane in range(32):
                        g, q = lane >> 2, lane & 3
                        lab = 128 * lb + 16 * t + g
                        k = 16 * kc + 8 * s + q
                        want = torch.stack([Cp[:, lab, k], Cp[:, lab + 8, k],
                                            Cp[:, lab, k + 4],
                                            Cp[:, lab + 8, k + 4]], -1)
                        assert torch.equal(Cf[:, lb, kc, t, s, lane], want)
