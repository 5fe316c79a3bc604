"""Viterbi (min-sum) encoding for chain-structured MCQ (counterpart of
`rayuela_tpu/ops/viterbi.py` and of the kernel in
`rayuela_tpu/ops/viterbi_pallas.py`).

The chain MRF of ChainQ: unaries ``u_i(b) = |C_i[b]|^2 - 2 C_i[b].x``
and adjacent-pair terms ``bin_i(a, b) = 2 C_i[a].C_{i+1}[b]``. The
forward pass ``f_{i+1}(b) = u_{i+1}(b) + min_a [f_i(a) + bin_i(a, b)]``
and a backtrace from the lowest-index argmin of ``f_{m-1}``, taking at
each stage the lowest ``a`` that attains the minimum, give the exact
chain-optimal codes.

`viterbi_encode` launches kernel K13 (``csrc/viterbi.cu``) for CUDA
tensors and runs the plain version `viterbi_encode_plain` for CPU
tensors; with ``impl="xla"`` it runs the JAX package's XLA formulation
(``_viterbi_encode_xla``: the chunked min-plus forward pass with argmin
tables, which is also the plain version). ``impl="auto"`` takes that
path on the card only for shapes the JAX package's ``auto`` serves on
the TPU but K13 does not take (`_auto_impl`); elsewhere it is the
kernel, which raises for a shape it does not take. The kernel computes
the unaries in its body, as the TPU kernel does; the plain version
takes them from a full-f32 matmul (`_unaries_flat`), so the two sum
each dot product in another order.
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.kernels.build import launch
from rayuela_tpu_torch.utils import exact_f32

# vectors per K13 CTA, and the bytes of its tile of bin_i rows (both as
# in csrc/viterbi.cu); the kernel's shared memory limit
_VB, _TILE_BYTES, _MAX_SMEM = 8, 32768, 232448


def chain_binaries(C: torch.Tensor) -> torch.Tensor:
    """Adjacent-pair MRF terms ``(m-1, h, h)``: ``2 C_i C_{i+1}^T``."""
    exact_f32()
    return 2.0 * torch.einsum("ihd,igd->ihg", C[:-1], C[1:])


def chain_unaries(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Unary terms ``(m, n, h)``: ``|c|^2 - 2 c.x``."""
    m, h, _ = C.shape
    return _unaries_flat(X, C).reshape(-1, m, h).permute(1, 0, 2)


def _unaries_flat(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Unaries as ``(n, m*h)`` f32 (TF32 off)."""
    exact_f32()
    Cf = C.reshape(-1, C.shape[2])
    return (Cf * Cf).sum(-1)[None, :] - 2.0 * (X @ Cf.T)


def chain_energy(X: torch.Tensor, C: torch.Tensor,
                 B: torch.Tensor) -> torch.Tensor:
    """Chain MRF energy of codes ``B (n, m)`` per vector (n,):
    ``sum_i u_i(B_i) + sum_i bin_i(B_i, B_{i+1})``, the objective
    Viterbi minimises (``|x - x_hat|^2 - |x|^2`` for chain-supported
    codebooks)."""
    m = C.shape[0]
    Bl = B.long()
    u = chain_unaries(X, C)
    e = sum(u[i].gather(1, Bl[:, i:i + 1])[:, 0] for i in range(m))
    if m > 1:
        bins = chain_binaries(C)
        e = e + sum(bins[i][Bl[:, i], Bl[:, i + 1]] for i in range(m - 1))
    return e


def _viterbi_chunk(u: torch.Tensor, binaries: torch.Tensor) -> torch.Tensor:
    """Viterbi over one chunk: ``u (m, c, h)`` → codes ``(c, m)`` int32,
    with the per-stage argmin tables kept for the backtrace."""
    m = u.shape[0]
    f, tables = u[0], []
    for i in range(m - 1):
        tot = f[:, :, None] + binaries[i][None]         # (c, a, b)
        mn, am = tot.min(dim=1)
        tables.append(am)
        f = u[i + 1] + mn
    b = f.argmin(-1)
    out = [b]
    for am in reversed(tables):
        b = am.gather(1, b[:, None])[:, 0]
        out.append(b)
    return torch.stack(out[::-1], dim=1).to(torch.int32)


def viterbi_encode_plain(X: torch.Tensor, C: torch.Tensor,
                         chunk: int = 2048) -> torch.Tensor:
    """Plain version of `viterbi_encode` (same contract), chunked over n
    so the (chunk, h, h) min-plus transient stays bounded."""
    m, h, _ = C.shape
    binaries = chain_binaries(C)
    outs = []
    for s in range(0, X.shape[0], chunk):
        u = _unaries_flat(X[s:s + chunk], C).reshape(-1, m, h)
        outs.append(_viterbi_chunk(u.permute(1, 0, 2), binaries))
    if not outs:
        return torch.empty(0, m, dtype=torch.int32, device=X.device)
    return torch.cat(outs)


def _smem_bytes(m: int, h: int, d: int) -> int:
    """K13's dynamic shared memory, as ``rq_viterbi_encode`` computes
    it: the forward costs, one tile of bin_i and the CTA's vectors."""
    ta = max(1, _TILE_BYTES // (4 * h))
    return 4 * (_VB * m * h + ta * h + _VB * d)


def viterbi_kernel_takes(m: int, h: int, d: int) -> bool:
    """Whether K13 takes codebooks ``(m, h, d)`` on the card: h up to
    1024 and its forward costs, bin tile and vectors within shared
    memory (`_smem_bytes`)."""
    return h <= 1024 and _smem_bytes(m, h, d) <= _MAX_SMEM


def _tpu_kernel_vmem(m: int, h: int, d: int, bc: int = 256) -> int:
    """VMEM bytes of the JAX package's Pallas Viterbi kernel
    (``viterbi_encode_pallas``): its blocked inputs double-buffered (a
    (d, bc) block of X^T, the (m h, d) codebook, the (m h, 1) norms
    padded to 128 lanes, the (max(1, m - 1), h, h) pair terms), its
    (m, bc) output double-buffered and its (m, h, bc) forward costs."""
    ins = d * bc + m * h * d + m * h * 128 + max(1, m - 1) * h * h
    return 4 * (2 * ins + 2 * m * bc + m * h * bc)


# the TPU's default scoped-VMEM limit (bytes)
_TPU_VMEM = 16 << 20


def _auto_impl(device, m: int, h: int, d: int) -> str:
    """What ``impl="auto"`` runs on ``device`` for codebooks ``(m, h,
    d)``: the kernel (its plain version on the CPU), and on the card
    ``"xla"`` where K13 does not take the shape but the JAX package's
    ``auto`` serves it on the TPU: by its XLA path (h not a multiple of
    8) or by a Pallas kernel within the scoped VMEM (at d = 128 only
    m = 1 past h = 1024). Where neither kernel holds the shape, the kernel's
    refusal stands."""
    if torch.device(device).type == "cuda" \
            and not viterbi_kernel_takes(m, h, d) \
            and (h % 8 or _tpu_kernel_vmem(m, h, d) <= _TPU_VMEM):
        return "xla"
    return "pallas"


# the xla path's (chunk, h, h) min-plus transient at most (bytes)
_XLA_TRANSIENT = 1 << 29


def viterbi_encode(X: torch.Tensor, C: torch.Tensor, chunk: int = 2048,
                   impl: str = "auto") -> torch.Tensor:
    """Kernel K13: exact chain-optimal codes ``(n, m) int32`` of
    ``X (n, d)`` f32 under ``C (m, h, d)`` f32. ``impl="pallas"``: the
    plain version for CPU tensors (chunked by ``chunk``); on the card the
    kernel, any h up to 1024 (the JAX wrapper's ``h % 8 == 0`` is not
    needed here) while its forward-cost stack, bin tile and vectors fit
    shared memory (`viterbi_kernel_takes`), else it raises.
    ``impl="xla"``: the chunked min-plus formulation on X's device, its
    chunk cut so the (chunk, h, h) transient stays within 512 MB.
    ``impl="auto"``: the kernel, or ``xla`` on the card where the kernel
    does not take the shape and the JAX package's ``auto`` serves it
    (`_auto_impl`); `viterbi_encode.routes` counts the calls of each.
    Source: ``rayuela_tpu_torch/csrc/viterbi.cu``."""
    if X.dim() != 2 or C.dim() != 3 or X.shape[1] != C.shape[2]:
        raise ValueError(f"X {tuple(X.shape)} and C {tuple(C.shape)} must "
                         "be (n, d) and (m, h, d)")
    if X.dtype != torch.float32 or C.dtype != torch.float32:
        raise ValueError("X and C must be float32")
    if X.device != C.device:
        raise ValueError("X and C must share one device")
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"impl={impl!r}: 'auto', 'pallas' or 'xla'")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {X.device}")
    m, h, d = C.shape
    if impl == "auto":
        impl = _auto_impl(X.device, m, h, d)
    viterbi_encode.routes[impl] += 1
    if impl == "xla":
        return viterbi_encode_plain(
            X, C, max(1, min(chunk, _XLA_TRANSIENT // (4 * h * h))))
    if X.device.type == "cpu":
        return viterbi_encode_plain(X, C, chunk)
    smem = _smem_bytes(m, h, d)
    if not viterbi_kernel_takes(m, h, d):
        raise ValueError(f"m={m}, h={h}, d={d}: the kernel needs h <= 1024 "
                         f"and its {smem} bytes of forward costs, bin tile "
                         f"and vectors within {_MAX_SMEM} (impl='xla' "
                         f"serves any shape)")
    n = X.shape[0]
    out = torch.empty(n, m, dtype=torch.int32, device=X.device)
    if n == 0:
        return out
    Xc = X.contiguous()
    Ct = C.transpose(1, 2).contiguous()                     # (m, d, h)
    c2 = (C * C).sum(-1).reshape(-1).contiguous()
    if m > 1:
        bins = chain_binaries(C).contiguous()
        binsT = bins.transpose(1, 2).contiguous()
    else:                        # no pair terms; the kernel reads none
        bins = binsT = torch.zeros(1, dtype=torch.float32, device=X.device)
    launch("rq_viterbi_encode", Xc, Ct, c2, bins, binsT, out, n, m, h, d,
           device=X.device)
    viterbi_encode.launches += 1
    return out


viterbi_encode.launches = 0
viterbi_encode.routes = {"pallas": 0, "xla": 0}
