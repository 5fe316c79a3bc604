"""The encoders' routes by shape in `rayuela_tpu_torch`, and the ported
``xla`` paths against the JAX package's on the CPU.

`encoding_icm(impl="auto")` and `viterbi_encode(impl="auto")` take, on
the card, the ``xla`` path for the codebook shapes their kernels do not
take (h above 1024, a CTA beyond shared memory), decided from the shape
before any launch. The ``xla`` ICM path is the JAX package's
``_encoding_icm_xla``: its sweep (`_icm_sweeps`) and its energy
(`_chunk_energy`) are deterministic, so on small-integer data, where
every sum is exact in f32 in any order, they equal the JAX package's
code for code and value for value; on Gaussian data the table rows are
summed in another order, so near-ties may flip (at least 99% of the
codes agree, energies within 1e-5 relative). The whole encoder draws its
perturbations from another generator than JAX's threefry keys, so it is
held to the JAX encoder's mean quantization error within 5% (the bound
`tests/test_torch_icm.py` holds the relaunch path to) and must not raise
the error of its start codes. Viterbi's ``xla`` path is exact: its chain
energies equal the JAX XLA path's on integer data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayuela_tpu.ops import icm as jicm
from rayuela_tpu.ops import viterbi as jvit
from rayuela_tpu.ops.qerror import get_binaries as j_get_binaries
from rayuela_tpu.ops.qerror import get_unaries as j_get_unaries
from rayuela_tpu_torch.ops import icm as ticm
from rayuela_tpu_torch.ops import viterbi as tvit
from rayuela_tpu_torch.ops.qerror import veccost

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """A generator of each test's own (the suite's shared one would make
    the data of later tests in the same process depend on this file)."""
    return np.random.default_rng(0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _case(rng, kind, n, d, m, h):
    if kind == "int":
        X = rng.integers(-1, 2, (n, d)).astype(np.float32)
        C = rng.integers(-1, 2, (m, h, d)).astype(np.float32)
    else:
        X = rng.standard_normal((n, d)).astype(np.float32)
        C = (rng.standard_normal((m, h, d)) * 0.4).astype(np.float32)
    B = rng.integers(0, h, (n, m)).astype(np.int32)
    return X, C, B


@pytest.mark.parametrize("m,h,d,takes", [
    (8, 256, 128, True), (8, 1024, 128, True), (8, 1152, 128, False),
    (8, 2048, 128, False), (8, 256, 3700, False), (4, 256, 4096, False),
    (16, 1024, 960, True)])
def test_icm_route_follows_the_kernels_shapes(m, h, d, takes):
    """`icm_kernel_takes` is h <= 1024 and a CTA of `_icm_layout` within
    shared memory; ``auto`` on the card takes the kernels there and the
    ``xla`` path elsewhere, and on the CPU always the kernels' relaunch
    path (their plain versions)."""
    assert ticm.icm_kernel_takes(m, h, d) == takes
    if h <= 1024:
        fits = True
        try:
            ticm._icm_layout(d, m)
        except ValueError:
            fits = False
        assert fits == takes
    assert ticm._auto_impl(torch.device("cuda"), m, h, d) == \
        ("pallas" if takes else "xla")
    assert ticm._auto_impl(torch.device("cpu"), m, h, d) == "pallas"


@pytest.mark.parametrize("m,h,d,takes,auto", [
    (8, 256, 128, True, "pallas"), (16, 256, 128, True, "pallas"),
    (4, 1024, 128, True, "pallas"), (16, 512, 128, False, "pallas"),
    (2, 1152, 128, False, "pallas"), (2, 2048, 16, False, "pallas"),
    (12, 512, 128, False, "pallas"), (11, 512, 128, True, "pallas"),
    (1, 1152, 128, False, "xla"), (1, 2048, 128, False, "pallas"),
    (2, 1030, 128, False, "xla"), (16, 516, 128, False, "xla")])
def test_viterbi_route_follows_the_kernels_shapes(m, h, d, takes, auto):
    """`viterbi_kernel_takes` is h <= 1024 and K13's forward costs, bin
    tile and vectors within shared memory (`_smem_bytes`). ``auto`` on
    the card takes the ``xla`` path only where K13 does not take the
    shape and the JAX package's ``auto`` serves it on the TPU (h not a
    multiple of 8, or its Pallas kernel within 16 MiB of VMEM); elsewhere
    it is the kernel, whose refusal stands. On the CPU it is always the
    kernel's plain version."""
    assert tvit.viterbi_kernel_takes(m, h, d) == takes
    assert takes == (h <= 1024 and tvit._smem_bytes(m, h, d)
                     <= tvit._MAX_SMEM)
    assert tvit._auto_impl(torch.device("cuda"), m, h, d) == auto
    assert tvit._auto_impl(torch.device("cpu"), m, h, d) == "pallas"


def _jax_tables(X, C):
    """The JAX package's unaries (m, n, h) and f32 tables, as its XLA
    encoder builds them."""
    m, h = C.shape[:2]
    u = jnp.transpose(j_get_unaries(jnp.asarray(X), jnp.asarray(C)),
                      (1, 0, 2))
    Bin = j_get_binaries(jnp.asarray(C)) \
        * (1.0 - jnp.eye(m))[:, :, None, None]
    T = jnp.transpose(Bin, (1, 0, 2, 3)).reshape(m, m * h, h)
    return u, Bin, T


@pytest.mark.parametrize("kind,h", [("int", 2048), ("gauss", 2048),
                                    ("int", 96)])
def test_xla_sweep_equals_jax(rng, kind, h):
    """The ported sweep and energy against the JAX package's
    `_icm_sweeps` and `_chunk_energy` on the same unaries, tables and
    start codes, with one node order: on integer data identical codes
    and energies; on Gaussian data >= 99% of codes, energies within
    1e-5 relative (+ 1e-4)."""
    m = 3
    X, C, B = _case(rng, kind, 48, 8, m, h)
    order = [2, 0, 1]
    u, Bin, T = _jax_tables(X, C)
    jB = np.asarray(jicm._icm_sweeps(u, T, jnp.asarray(B),
                                     jnp.asarray(order, jnp.int32), 2))
    je = np.asarray(jicm._chunk_energy(u, Bin, jnp.asarray(jB)))
    tBin, tT = ticm._conditioning_tables(_t(C), torch.float32)
    tu = ticm._unaries(_t(X), _t(C), (_t(C) ** 2).sum(-1))
    np.testing.assert_array_equal(tBin.numpy(), np.asarray(Bin))
    tB = ticm._icm_sweeps(tu, tT, _t(B), order, 2)
    te = ticm._chunk_energy(tu, tBin, _t(jB)).numpy()
    if kind == "int":
        np.testing.assert_array_equal(tB.numpy(), jB)
        np.testing.assert_array_equal(te, je)
    else:
        assert float((tB.numpy() == jB).mean()) >= 0.99
        np.testing.assert_allclose(te, je, rtol=1e-5, atol=1e-4)
    # E + |x|^2 is the reconstruction cost of the codes
    np.testing.assert_allclose(
        te + (X ** 2).sum(1), veccost(_t(X), _t(C), _t(jB)).numpy(),
        rtol=1e-5, atol=1e-3)


def test_xla_encoder_matches_jax_at_h_2048(rng):
    """`encoding_icm(impl="xla")` at h = 2048 against the JAX package's
    `_encoding_icm_xla` (f32 tables on the CPU, the same chunk): mean
    quantization error within 5% of JAX's, and neither raises the error
    of the start codes."""
    n, d, m, h, chunk = 96, 8, 2, 2048, 48
    X, C, B0 = _case(rng, "gauss", n, d, m, h)
    kw = dict(ilsiter=3, icmiter=2, npert=1)
    jB = jicm._encoding_icm_xla(jax.random.PRNGKey(0), jnp.asarray(X),
                                jnp.asarray(C), jnp.asarray(B0), chunk=chunk,
                                **kw)
    routes = dict(ticm.encoding_icm.routes)
    tB = ticm.encoding_icm(torch.Generator().manual_seed(0), _t(X), _t(C),
                           _t(B0), chunk=chunk, impl="xla", **kw)
    assert ticm.encoding_icm.routes["xla"] == routes["xla"] + 1
    assert tB.shape == (n, m) and tB.dtype == torch.int32
    cost = lambda B: float(veccost(_t(X), _t(C), _t(B)).mean())
    jc, tc, c0 = cost(np.asarray(jB)), cost(tB), cost(B0)
    assert tc <= c0 and jc <= c0
    assert abs(tc - jc) <= 0.05 * jc


def test_xla_encoder_keeps_only_better_codes(rng):
    """Per vector the ``xla`` encoder's codes cost no more than its start
    codes (the strict accept on the MRF energy), on any chunking."""
    X, C, B0 = _case(rng, "gauss", 70, 8, 3, 16)
    c0 = veccost(_t(X), _t(C), _t(B0))
    for chunk in (70, 16):
        B = ticm.encoding_icm(torch.Generator().manual_seed(1), _t(X), _t(C),
                              _t(B0), ilsiter=4, icmiter=2, npert=2,
                              chunk=chunk, impl="xla")
        assert bool((veccost(_t(X), _t(C), B) <= c0 + 1e-4).all())


def test_viterbi_xla_path_equals_jax_at_h_2048(rng):
    """`viterbi_encode(impl="xla")` at h = 2048: the chunked min-plus
    formulation, chain energies equal to the JAX package's
    `_viterbi_encode_xla` on integer data (every cost exact), and the
    routes counted."""
    X, C, _ = _case(rng, "int", 10, 4, 2, 2048)
    routes = dict(tvit.viterbi_encode.routes)
    tB = tvit.viterbi_encode(_t(X), _t(C), chunk=4, impl="xla")
    assert tvit.viterbi_encode.routes["xla"] == routes["xla"] + 1
    jB = np.asarray(jvit._viterbi_encode_xla(jnp.asarray(X), jnp.asarray(C),
                                             chunk=4))
    np.testing.assert_array_equal(
        tvit.chain_energy(_t(X), _t(C), tB).numpy(),
        tvit.chain_energy(_t(X), _t(C), _t(jB)).numpy())
    with pytest.raises(ValueError, match="impl"):
        tvit.viterbi_encode(_t(X), _t(C), impl="triton")


def _jax_viterbi_vmem(m, h, d, bc=256):
    """VMEM bytes of the JAX package's Pallas Viterbi kernel
    (`viterbi_encode_pallas`), counted from its BlockSpecs: its blocked
    inputs double-buffered (X^T's (d, bc) block, the (m h, d) codebook,
    the (m h, 1) norms padded to 128 lanes, the (max(1, m - 1), h, h)
    pair terms), its (m, bc) output double-buffered and its (m, h, bc)
    forward-cost scratch."""
    ins = d * bc + m * h * d + m * h * 128 + max(1, m - 1) * h * h
    return 4 * (2 * ins + 2 * m * bc + m * h * bc)


@pytest.mark.parametrize("m,h", [(2, 1152), (2, 2048), (2, 1536), (6, 1024),
                                 (12, 512), (16, 512), (24, 256), (48, 128)])
def test_jax_viterbi_kernel_holds_no_shape_k13_refuses(m, h):
    """Where K13 refuses a shape (m >= 2, h a multiple of 8, d = 128),
    the JAX package's Pallas Viterbi kernel needs more VMEM than the
    16 MiB default scoped limit as well: `viterbi_encode(impl="auto")`
    keeps the kernel's refusal there (``impl="xla"`` serves the shape),
    and the port's count of that VMEM is the kernel's."""
    assert not tvit.viterbi_kernel_takes(m, h, 128)
    assert _jax_viterbi_vmem(m, h, 128) > 16 << 20
    assert tvit._tpu_kernel_vmem(m, h, 128) == _jax_viterbi_vmem(m, h, 128)
    assert tvit._auto_impl(torch.device("cuda"), m, h, 128) == "pallas"


@pytest.mark.parametrize("h", [1032, 1152, 1256])
def test_jax_viterbi_kernel_holds_m1_past_k13(h):
    """At m = 1 (no pair terms) the JAX package's Pallas kernel holds h
    past K13's 1024 to about 1260 labels: `viterbi_encode(impl="auto")`
    serves those shapes on the card by its ``xla`` path."""
    assert not tvit.viterbi_kernel_takes(1, h, 128)
    assert _jax_viterbi_vmem(1, h, 128) <= 16 << 20
    assert tvit._auto_impl(torch.device("cuda"), 1, h, 128) == "xla"
