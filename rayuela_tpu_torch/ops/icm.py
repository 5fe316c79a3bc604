"""ILS over ICM sweeps for fully-connected MCQ, LSQ and LSQ++
(counterpart of `rayuela_tpu/ops/icm.py` and of the sweep kernel in
`rayuela_tpu/ops/icm_pallas.py`).

One ICM visit of node i conditions on every other codebook's current
code through the running sum ``S = sum_j C_j[B_j]``:
``cond_i(b) = u_i(b) + 2 (S - C_i[B_i]).C_i[b]`` with the unaries
``u_i(b) = |C_i[b]|^2 - 2 C_i[b].x``, then takes the lowest-index argmin
over b. `encoding_icm` is the JAX package's per-round relaunch loop:
the energy of the start codes from a sweep call with ``icmiter=0``, then
per ILS round a perturbation of ``npert`` positions, one sweep call and
a per-vector strict accept.

`icm_sweeps` launches kernel K11 (``csrc/icm.cu``, bf16 operands, the
TPU kernel's objective) for CUDA tensors and runs the plain version
`icm_sweeps_plain` at f32 for CPU tensors: the JAX package likewise
sweeps with bf16 tables on the chip and f32 ones on the CPU.

Randomness comes from a `torch.Generator` on the data's device, so
codes do not reproduce the JAX package's threefry draws: parity is
statistical (mean cost), except for the sweeps themselves.
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.kernels.build import launch
from rayuela_tpu_torch.utils import exact_f32

# vectors per plain sweep block: bounds the (m, chunk, h) unaries
_PLAIN_CHUNK = 8192
# label counts the kernel is compiled for (any other h up to the last is
# padded to the next), and its shared memory limit
_KERNEL_H = (32, 64, 128, 256)
_MAX_SMEM = 232448


def icm_sweeps_plain(X: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
                     order, icmiter: int, op_dtype=torch.bfloat16,
                     chunk: int = _PLAIN_CHUNK
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `icm_sweeps`. ``op_dtype=bfloat16`` is the TPU
    kernel's objective (X and C rounded to bf16, ``S - C_i[B_i]``
    rounded to bf16 before its dot, f32 sums); ``float32`` is the JAX
    package's XLA sweep with f32 tables."""
    exact_f32()
    order = [int(i) for i in torch.as_tensor(order).tolist()]
    Co = C.to(op_dtype).float()
    c2 = (C * C).sum(-1)
    outs, engs = [], []
    for s in range(0, X.shape[0], chunk):
        b, e = _sweep_block(X[s:s + chunk].to(op_dtype).float(), Co, c2,
                            B[s:s + chunk], order, icmiter, op_dtype)
        outs.append(b)
        engs.append(e)
    if not outs:
        return B.to(torch.int32), torch.empty(0, device=X.device)
    return torch.cat(outs), torch.cat(engs)


def _sweep_block(Xo, Co, c2, B, order, icmiter, op_dtype):
    m = Co.shape[0]
    u = c2[:, None, :] - 2.0 * torch.einsum("nd,mhd->mnh", Xo, Co)
    B = B.long().clone()
    G = [Co[j].index_select(0, B[:, j]) for j in range(m)]
    S = torch.zeros_like(Xo)
    for j in order:
        S = S + G[j]
    for t in range(icmiter * m):
        i = order[t % m]
        rest = (S - G[i]).to(op_dtype).float()
        nb = (u[i] + 2.0 * (rest @ Co[i].T)).argmin(-1)
        B[:, i] = nb
        gnew = Co[i].index_select(0, nb)
        S = S + (gnew - G[i])
        G[i] = gnew
    acc = torch.zeros(Xo.shape[0], device=Xo.device)
    for i in order:
        ui = u[i].gather(1, B[:, i:i + 1])[:, 0]
        rest = (S - G[i]).to(op_dtype).float()
        acc = acc + ((ui + 2.0 * (rest * G[i]).sum(-1)) + ui)
    return B.to(torch.int32), 0.5 * acc


class IcmOperands:
    """``X (n, d)`` and ``C (m, h, d)`` f32 prepared once for many sweep
    calls: on the card the kernel's bf16 operands (X, C's rows, C
    transposed per codebook) and f32 ``|C|^2``, with h padded to the
    next label count the kernel is compiled for by zero rows whose
    ``|C|^2`` is +inf (they never win an argmin); on the CPU the tensors
    themselves."""

    def __init__(self, X: torch.Tensor, C: torch.Tensor):
        if X.dim() != 2 or C.dim() != 3 or X.shape[1] != C.shape[2]:
            raise ValueError(f"X {tuple(X.shape)} and C {tuple(C.shape)} "
                             "must be (n, d) and (m, h, d)")
        if X.dtype != torch.float32 or C.dtype != torch.float32:
            raise ValueError("X and C must be float32")
        if X.device != C.device:
            raise ValueError("X and C must share one device")
        self.device = X.device
        self.n, self.d = X.shape
        self.m, self.h = C.shape[0], C.shape[1]
        self.cuda = X.device.type == "cuda"
        if X.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {X.device}")
        if not self.cuda:
            self.X, self.C = X, C
            return
        if self.h > _KERNEL_H[-1]:
            raise ValueError(f"h={self.h}: the kernel takes h up to "
                             f"{_KERNEL_H[-1]}")
        if _smem_bytes(self.d, self.m) > _MAX_SMEM:
            raise ValueError(f"d={self.d}, m={self.m}: the kernel's "
                             "per-vector state exceeds shared memory")
        self.hk = next(hk for hk in _KERNEL_H if hk >= self.h)
        pad = self.hk - self.h
        Cb = torch.nn.functional.pad(C, (0, 0, 0, pad)).to(torch.bfloat16)
        c2 = torch.nn.functional.pad((C * C).sum(-1), (0, pad),
                                     value=float("inf"))
        self.Xb = X.to(torch.bfloat16).contiguous()
        self.Cr = Cb.reshape(self.m * self.hk, self.d).contiguous()
        self.Ct = Cb.transpose(1, 2).contiguous()           # (m, d, hk)
        self.c2 = c2.reshape(-1).contiguous()


def _smem_bytes(d: int, m: int) -> int:
    """K11's dynamic shared memory, as ``launch_icm`` computes it."""
    return 4 * ((3 * 8 * d * 4 + 8 * m * 4 + 15) // 16 * 16)


def _sweeps(ops: IcmOperands, B: torch.Tensor, order, icmiter: int):
    if not ops.cuda:
        return icm_sweeps_plain(ops.X, ops.C, B, order, icmiter,
                                torch.float32)
    order = torch.as_tensor(order, dtype=torch.int32,
                            device=ops.device).contiguous()
    if B.shape != (ops.n, ops.m) or B.dtype != torch.int32 \
            or B.device != ops.device or not B.is_contiguous():
        raise ValueError(f"B must be contiguous ({ops.n}, {ops.m}) int32 "
                         f"on {ops.device}")
    if order.shape != (ops.m,):
        raise ValueError(f"order must be a ({ops.m},) node order")
    if icmiter < 0:
        raise ValueError(f"icmiter={icmiter} < 0")
    out = torch.empty_like(B)
    E = torch.empty(ops.n, dtype=torch.float32, device=ops.device)
    if ops.n:
        launch("rq_icm_sweeps", ops.Xb, ops.Cr, ops.Ct, ops.c2, B, order,
               out, E, ops.n, ops.d, ops.m, ops.hk, icmiter,
               device=ops.device)
        icm_sweeps.launches += 1
    return out, E


def icm_sweeps(X: torch.Tensor, C: torch.Tensor, B: torch.Tensor, order,
               icmiter: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K11: ``icmiter`` ICM sweeps over the m nodes in ``order``
    for every vector → ``(codes (n, m) int32, energy (n,) f32)``, the
    MRF energy of the output codes without the ``|x|^2`` term
    (``icmiter=0`` only evaluates it). ``X (n, d)``, ``C (m, h, d)``
    f32, ``B (n, m)`` int32, ``order (m,)`` a permutation of the nodes
    (int32 on X's device for the kernel). CPU tensors take the plain
    version at f32.
    Source: ``rayuela_tpu_torch/csrc/icm.cu``."""
    return _sweeps(IcmOperands(X, C), B, order, icmiter)


icm_sweeps.launches = 0


def _ils_schedule(gen: torch.Generator, m: int, ilsiter: int,
                  randord: bool, device) -> torch.Tensor:
    """One node order per ILS round, shared by all vectors →
    ``(ilsiter, m) int32`` on ``device``."""
    if randord:
        orders = [torch.randperm(m, generator=gen, device=gen.device)
                  for _ in range(ilsiter)]
    else:
        orders = [torch.arange(m)] * ilsiter
    if not orders:
        return torch.empty(0, m, dtype=torch.int32, device=device)
    return torch.stack(orders).to(device=device, dtype=torch.int32)


def _perturb(gen: torch.Generator, B: torch.Tensor, npert: int,
             h: int) -> torch.Tensor:
    """Redraw ``npert`` positions per vector (with replacement, the last
    hit wins) as uniform codes."""
    n, m = B.shape
    pos = torch.randint(0, m, (n, npert), generator=gen, device=B.device)
    val = torch.randint(0, h, (n, npert), generator=gen, device=B.device,
                        dtype=B.dtype)
    nodes = torch.arange(m, device=B.device)[None, :]
    out = B
    for t in range(npert):
        out = torch.where(nodes == pos[:, t:t + 1], val[:, t:t + 1], out)
    return out


def encoding_icm(gen: torch.Generator, X: torch.Tensor, C: torch.Tensor,
                 B0: torch.Tensor, *, ilsiter: int = 8, icmiter: int = 4,
                 npert: int = 4, randord: bool = True, impl: str = "auto"
                 ) -> torch.Tensor:
    """ILS-over-ICM encoding → improved codes ``(n, m) int32``. ``gen``
    lies on X's device. Defaults are the reference experiment settings.
    ``impl="auto"`` sweeps through `icm_sweeps` (the kernel on the card,
    the plain version on the CPU); the whole-ILS kernel
    (``impl="pallas-ils"``) is not ported."""
    if impl.startswith("pallas-ils"):
        raise NotImplementedError("the whole-ILS kernel (K12) is not "
                                  "ported yet (ROADMAP B10)")
    if impl not in ("auto", "pallas"):
        raise ValueError(f"impl={impl!r}: 'auto' or 'pallas'")
    ops = IcmOperands(X, C)
    orders = _ils_schedule(gen, ops.m, ilsiter, randord, X.device)
    B = B0.to(device=X.device, dtype=torch.int32).contiguous()
    if ilsiter == 0:
        return B
    _, E = _sweeps(ops, B, orders[0], 0)
    for t in range(ilsiter):
        Bt = _perturb(gen, B, npert, ops.h)
        Bt, Et = _sweeps(ops, Bt, orders[t], icmiter)
        keep = Et < E
        B = torch.where(keep[:, None], Bt, B)
        E = torch.minimum(Et, E)
    return B


def encoding_icm_checkpoints(gen: torch.Generator, X: torch.Tensor,
                             C: torch.Tensor, B0: torch.Tensor,
                             ilsiters=(16, 32, 64), **kw
                             ) -> list[torch.Tensor]:
    """The codes after several cumulative ILS budgets; each snapshot
    continues from the previous one."""
    outs, B, done = [], B0, 0
    for target in sorted(ilsiters):
        if target > done:
            B = encoding_icm(gen, X, C, B, ilsiter=target - done, **kw)
            done = target
        outs.append(B)
    return outs
