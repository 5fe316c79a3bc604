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
the unaries in its body, as the TPU kernel does (on the tensor cores,
3xTF32); the plain version takes them from a full-f32 matmul
(`_unaries_flat`), so the two sum each dot product in another order.
The kernel's layout by shape is `_viterbi_layout` (``rq_viterbi_layout``
in the source); the codebooks reach it in mma fragment order
(`_k13_codebooks`).
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.kernels.build import launch
from rayuela_tpu_torch.utils import exact_f32

# the shared memory of K13's former layout (the bound of the shapes it
# takes: `_smem_bytes`): 8 vectors a CTA and a 32 KB tile of bin_i rows;
# the opt-in shared memory a CTA may use
_VB, _TILE_BYTES, _MAX_SMEM = 8, 32768, 232448
# K13's layout (`vt_layout` in csrc/viterbi.cu): labels and dimensions
# of a codebook tile, bytes of a ring slot, (vectors x labels) a CTA at
# most
_LB, _KC = 128, 16
_SLOT, _SLICES = 4 * _LB * _KC, 8192


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
    """The shared memory of K13's former layout (8 vectors and the whole
    forward-cost stack a CTA, a 32 KB tile of bin_i rows): the bound of
    the shapes K13 takes (`viterbi_kernel_takes`). The smallest instance
    of `_viterbi_layout` takes less at every shape."""
    ta = max(1, _TILE_BYTES // (4 * h))
    return 4 * (_VB * m * h + ta * h + _VB * d)


def viterbi_kernel_takes(m: int, h: int, d: int) -> bool:
    """Whether K13 takes codebooks ``(m, h, d)`` on the card: h up to
    1024 and `_smem_bytes` within shared memory (the shapes the former
    layout held; `_viterbi_layout` fits each of them)."""
    return h <= 1024 and _smem_bytes(m, h, d) <= _MAX_SMEM


def _layout_smem(v: int, slots: int, m: int, h: int, d: int) -> int:
    """Shared bytes of a K13 CTA of ``v`` vectors and ``slots`` ring
    slots: the ring, f_i and f_{i+1} (one buffer at m = 1), the vectors
    (rows of d rounded up to 16, + 4) and the mbarriers."""
    dp = -(-d // _KC) * _KC
    return (slots * _SLOT + 4 * min(m, 2) * v * h + 4 * v * (dp + 4)
            + 8 * (2 * slots + 2))


def _viterbi_layout(m: int, h: int, d: int) -> tuple[int, int, int, int]:
    """K13's layout at ``(m, h, d)``, as ``rq_viterbi_layout`` states it:
    ``(vectors a CTA, ring slots, CTAs an SM is meant to hold, shared
    bytes a CTA)``. The most vectors (32, 16, 8) with at most 8192
    (vectors x labels, h rounded up to 4), then two CTAs an SM where they
    fit, then the deepest ring (4, 3, 2 slots of 8 KB); a shape nothing
    fits raises."""
    if 1 <= h <= 1024 and m >= 1 and d >= 1:
        hp = -(-h // 4) * 4
        for v in (32, 16, 8):
            if v * hp > _SLICES:
                continue
            for ctas, cap in ((2, (_MAX_SMEM - 1024) // 2), (1, _MAX_SMEM)):
                for slots in (4, 3, 2):
                    smem = _layout_smem(v, slots, m, h, d)
                    if smem <= cap:
                        return v, slots, ctas, smem
    raise ValueError(f"m={m}, h={h}, d={d}: no K13 layout fits shared "
                     f"memory (h <= 1024)")


def _k13_codebooks(C: torch.Tensor) -> torch.Tensor:
    """``C (m, h, d)`` as K13 reads it: per codebook, tiles of 128 labels
    x 16 dimensions (zero pads past h and d), each in the A-fragment
    order of mma m16n8k8: (m-tile of 16 labels, k-step of 8 dimensions,
    lane, 4 values), lane ``4 g + q`` holding labels ``g``, ``g + 8`` of
    dimensions ``q``, ``q + 4`` as ``(g, q), (g + 8, q), (g, q + 4),
    (g + 8, q + 4)`` → ``(m, h/128, d/16, 8, 2, 32, 4)`` contiguous."""
    m, h, d = C.shape
    nlb, nkc = -(-h // _LB), -(-d // _KC)
    Cp = C.new_zeros(m, nlb * _LB, nkc * _KC)
    Cp[:, :h, :d] = C
    # label = lb 128 + mt 16 + rh 8 + g; dim = kc 16 + ks 8 + ch 4 + q
    t = Cp.reshape(m, nlb, 8, 2, 8, nkc, 2, 2, 4)
    return t.permute(0, 1, 5, 2, 6, 4, 8, 7, 3).reshape(
        m, nlb, nkc, 8, 2, 32, 4).contiguous()


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
    needed here) at the shapes `viterbi_kernel_takes` names, else it
    raises; it takes the layout `_viterbi_layout` gives, a persistent grid
    of CTAs an SM times the SMs, and a scratch for their forward costs
    (grid x m x h x vectors a CTA, f32).
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
    if not viterbi_kernel_takes(m, h, d):
        raise ValueError(f"m={m}, h={h}, d={d}: the kernel needs h <= 1024 "
                         f"and its former {_smem_bytes(m, h, d)} bytes of "
                         f"forward costs, bin tile and vectors within "
                         f"{_MAX_SMEM} (impl='xla' serves any shape)")
    n = X.shape[0]
    out = torch.empty(n, m, dtype=torch.int32, device=X.device)
    if n == 0:
        return out
    v, _, ctas, _ = _viterbi_layout(m, h, d)
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    grid = min(-(-n // v), sms * ctas)
    ldx = -(-d // 4) * 4
    Xc = X.contiguous()
    if ldx != d:         # the kernel copies rows of 16-byte multiples
        Xc = torch.nn.functional.pad(Xc, (0, ldx - d))
    elif Xc.data_ptr() % 16:
        Xc = Xc.clone()
    c2 = (C * C).sum(-1).contiguous()
    if m > 1:
        bins = chain_binaries(C)
        binsT = bins.transpose(1, 2).contiguous()
        hp = -(-h // 4) * 4
        bins = torch.nn.functional.pad(bins, (0, hp - h)).contiguous()
    else:                        # no pair terms; the kernel reads none
        bins = binsT = torch.zeros(1, dtype=torch.float32, device=X.device)
    scr = torch.empty(grid * m * h * v, dtype=torch.float32, device=X.device)
    launch("rq_viterbi_encode", Xc, _k13_codebooks(C), c2, bins, binsT, scr,
           out, n, m, h, d, ldx, grid, v, device=X.device)
    viterbi_encode.launches += 1
    return out


viterbi_encode.launches = 0
viterbi_encode.routes = {"pallas": 0, "xla": 0}
