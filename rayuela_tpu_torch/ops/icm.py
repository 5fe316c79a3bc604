"""ILS over ICM sweeps for fully-connected MCQ, LSQ and LSQ++
(counterpart of `rayuela_tpu/ops/icm.py` and of the kernels in
`rayuela_tpu/ops/icm_pallas.py`).

One ICM visit of node i conditions on every other codebook's current
code through the running sum ``S = sum_j C_j[B_j]``:
``cond_i(b) = u_i(b) + 2 (S - C_i[B_i]).C_i[b]`` with the unaries
``u_i(b) = |C_i[b]|^2 - 2 C_i[b].x``, then takes the lowest-index argmin
over b. `encoding_icm` is the JAX package's per-round relaunch loop:
the energy of the start codes from a sweep call with ``icmiter=0``, then
per ILS round a perturbation of ``npert`` positions, one sweep call and
a per-vector strict accept; with ``impl="pallas-ils"`` it is one launch
of the whole-ILS kernel.

Kernels (``csrc/icm.cu``, bf16 operands, the TPU kernels' objective),
each launched for CUDA tensors, its plain version run at f32 for CPU
tensors (the JAX package likewise sweeps with bf16 tables on the chip
and f32 ones on the CPU):

* K11 `icm_sweeps` replaces ``icm_pallas.py::_kernel`` (launched at
  ``icm_pallas.py:276`` by ``icm_sweeps_pallas``); plain version
  `icm_sweeps_plain`.
* K12 `encoding_ils` replaces ``icm_pallas.py::_kernel_ils`` (launched
  at ``icm_pallas.py:326`` by ``encoding_ils_pallas``); plain version
  `encoding_ils_plain`. Its perturbation is the TPU kernel's counter
  hash of (seed, global vector id, round, draw), so its codes equal the
  JAX kernel's on data that bf16 holds exactly.

Both are bound on the card by their conditional dot products (h*d
multiply-adds per visit and vector on the CUDA cores) and the L2 reads
of the codebook slab that feed them; see the kernels' header.

Randomness otherwise comes from a `torch.Generator` on the data's
device, so the relaunch path's codes do not reproduce the JAX package's
threefry draws: parity is statistical (mean cost), except for the
sweeps and the whole-ILS kernel themselves.
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.kernels.build import launch
from rayuela_tpu_torch.utils import exact_f32

# vectors per plain sweep block: bounds the (m, chunk, h) unaries
_PLAIN_CHUNK = 8192
# label counts the kernels are compiled for; a larger h is padded to a
# multiple of the last (one register block of 256 labels), up to _MAX_H
_KERNEL_H = (32, 64, 128, 256)
_MAX_H = 1024
_MAX_SMEM = 232448
_M32 = 0xFFFFFFFF


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
    u = _unaries(Xo, Co, c2)
    B = B.long().clone()
    S, G = _rebuild(Co, B, order)
    S = _visits(u, Co, S, G, B, order, icmiter, op_dtype)
    return B.to(torch.int32), _energy(u, S, G, B, order, op_dtype)


def _unaries(Xo, Co, c2):
    return c2[:, None, :] - 2.0 * torch.einsum("nd,mhd->mnh", Xo, Co)


def _rebuild(Co, B, nodes):
    """``(S, G)``: each node's row ``G[j] = Co[j][B_j]`` and their sum
    over ``nodes`` in that order."""
    G = [Co[j].index_select(0, B[:, j]) for j in range(Co.shape[0])]
    S = torch.zeros(B.shape[0], Co.shape[2], device=Co.device)
    for j in nodes:
        S = S + G[j]
    return S, G


def _visits(u, Co, S, G, B, order, icmiter, op_dtype):
    """``icmiter * m`` visits in ``order``; updates ``B`` and ``G`` in
    place and returns S."""
    m = Co.shape[0]
    for t in range(icmiter * m):
        i = order[t % m]
        rest = (S - G[i]).to(op_dtype).float()
        nb = (u[i] + 2.0 * (rest @ Co[i].T)).argmin(-1)
        B[:, i] = nb
        gnew = Co[i].index_select(0, nb)
        S = S + (gnew - G[i])
        G[i] = gnew
    return S


def _energy(u, S, G, B, nodes, op_dtype):
    """The MRF energy of ``B`` without ``|x|^2``, summed over ``nodes``
    in that order."""
    acc = torch.zeros(B.shape[0], device=S.device)
    for i in nodes:
        ui = u[i].gather(1, B[:, i:i + 1])[:, 0]
        rest = (S - G[i]).to(op_dtype).float()
        acc = acc + ((ui + 2.0 * (rest * G[i]).sum(-1)) + ui)
    return 0.5 * acc


class IcmOperands:
    """``X (n, d)`` and ``C (m, h, d)`` f32 prepared once for many kernel
    calls: on the card the kernels' bf16 operands (X, C's rows, C
    transposed per codebook) and f32 ``|C|^2``, with h padded to a label
    count the kernels are compiled for (`_padded_h`) by zero rows whose
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
        if self.h > _MAX_H:
            raise ValueError(f"h={self.h}: the kernels take h up to {_MAX_H}")
        if _warp_bytes(self.d, self.m) > _MAX_SMEM:
            raise ValueError(f"d={self.d}, m={self.m}: the kernels' "
                             "per-vector state exceeds shared memory")
        self.hk = _padded_h(self.h)
        pad = self.hk - self.h
        Cb = torch.nn.functional.pad(C, (0, 0, 0, pad)).to(torch.bfloat16)
        c2 = torch.nn.functional.pad((C * C).sum(-1), (0, pad),
                                     value=float("inf"))
        self.Xb = X.to(torch.bfloat16).contiguous()
        self.Cr = Cb.reshape(self.m * self.hk, self.d).contiguous()
        self.Ct = Cb.transpose(1, 2).contiguous()           # (m, d, hk)
        self.c2 = c2.reshape(-1).contiguous()


def _padded_h(h: int) -> int:
    """The label count the kernels run ``h`` at: the next of
    `_KERNEL_H`, or beyond it the next multiple of 256."""
    return next((hk for hk in _KERNEL_H if hk >= h), -(-h // 256) * 256)


def _warp_bytes(d: int, m: int) -> int:
    """One warp's shared state in K11 and K12 (8 vectors' x, S, weights,
    codes, best codes and energies), as ``warp_bytes`` in icm.cu computes
    it. A CTA runs 4, 2 or 1 warps, as many as fit in `_MAX_SMEM`."""
    return (3 * 8 * d * 4 + 2 * 8 * m * 4 + 8 * 4 + 15) // 16 * 16


def _check_codes(ops: IcmOperands, B: torch.Tensor) -> None:
    if B.shape != (ops.n, ops.m) or B.dtype != torch.int32 \
            or B.device != ops.device or not B.is_contiguous():
        raise ValueError(f"B must be contiguous ({ops.n}, {ops.m}) int32 "
                         f"on {ops.device}")


def _sweeps(ops: IcmOperands, B: torch.Tensor, order, icmiter: int):
    if not ops.cuda:
        return icm_sweeps_plain(ops.X, ops.C, B, order, icmiter,
                                torch.float32)
    order = torch.as_tensor(order, dtype=torch.int32,
                            device=ops.device).contiguous()
    _check_codes(ops, B)
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
    (int32 on X's device for the kernel); on the card h <= 1024 and d
    up to ~2400 (one warp's state in shared memory, `_warp_bytes`). CPU
    tensors take the plain version at f32.
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


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    c < 2**32, in halves so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's counter hash on uint32 values held in int64."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _hash_perturb(B: torch.Tensor, gid: torch.Tensor, seed: int, r: int,
                  npert: int, h: int) -> torch.Tensor:
    """Round r's redraws of K12 for the vectors ``gid`` (int64 global
    ids): draw p sets position ``hash(ctr) % m`` to ``hash(ctr ^
    0x5BD1E995) % h`` (the last hit wins), ``ctr = seed + gid *
    0x9E3779B9 + r * 0x85EBCA6B + p * 0xC2B2AE35`` mod 2**32."""
    m = B.shape[1]
    base = (_mul32(gid, 0x9E3779B9) + ((seed + r * 0x85EBCA6B) & _M32)) \
        & _M32
    nodes = torch.arange(m, device=B.device)[None, :]
    for p in range(npert):
        ctr = (base + ((p * 0xC2B2AE35) & _M32)) & _M32
        pos = _hash32(ctr) % m
        val = _hash32(ctr ^ 0x5BD1E995) % h
        B = torch.where(nodes == pos[:, None], val[:, None], B)
    return B


def encoding_ils_plain(X: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
                       orders, seed: int, *, ilsiter: int, icmiter: int,
                       npert: int, op_dtype=torch.bfloat16,
                       chunk: int = _PLAIN_CHUNK
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `encoding_ils` (same arguments and outputs).
    ``op_dtype=bfloat16`` is the TPU kernel's objective, ``float32`` the
    f32 sweep's; S is rebuilt and the energy summed in codebook order,
    as the TPU kernel does."""
    exact_f32()
    orders = torch.as_tensor(orders).reshape(-1, C.shape[0]).tolist()
    if len(orders) < ilsiter:
        raise ValueError(f"orders holds {len(orders)} rounds < "
                         f"ilsiter={ilsiter}")
    m, h = C.shape[0], C.shape[1]
    nodes = range(m)
    Co = C.to(op_dtype).float()
    c2 = (C * C).sum(-1)
    outs, engs = [], []
    for s in range(0, X.shape[0], chunk):
        Xo = X[s:s + chunk].to(op_dtype).float()
        u = _unaries(Xo, Co, c2)
        gid = torch.arange(s, s + Xo.shape[0], device=X.device)
        Bb = B[s:s + chunk].long()
        S, G = _rebuild(Co, Bb, nodes)
        Eb = _energy(u, S, G, Bb, nodes, op_dtype)
        for r in range(ilsiter):
            Bt = _hash_perturb(Bb, gid, seed & _M32, r, npert, h)
            S, G = _rebuild(Co, Bt, nodes)
            S = _visits(u, Co, S, G, Bt, orders[r], icmiter, op_dtype)
            e = _energy(u, S, G, Bt, nodes, op_dtype)
            keep = e < Eb
            Bb = torch.where(keep[:, None], Bt, Bb)
            Eb = torch.where(keep, e, Eb)
        outs.append(Bb.to(torch.int32))
        engs.append(Eb)
    if not outs:
        return B.to(torch.int32), torch.empty(0, device=X.device)
    return torch.cat(outs), torch.cat(engs)


def _ils(ops: IcmOperands, B: torch.Tensor, orders: torch.Tensor, seed: int,
         *, ilsiter: int, icmiter: int, npert: int):
    if not ops.cuda:
        return encoding_ils_plain(ops.X, ops.C, B, orders, seed,
                                  ilsiter=ilsiter, icmiter=icmiter,
                                  npert=npert, op_dtype=torch.float32)
    _check_codes(ops, B)
    if orders.shape != (ilsiter, ops.m) or orders.dtype != torch.int32 \
            or orders.device != ops.device or not orders.is_contiguous():
        raise ValueError(f"orders must be contiguous ({ilsiter}, {ops.m}) "
                         f"int32 on {ops.device}")
    if min(ilsiter, icmiter, npert) < 0:
        raise ValueError("ilsiter, icmiter and npert must be >= 0")
    out = torch.empty_like(B)
    E = torch.empty(ops.n, dtype=torch.float32, device=ops.device)
    if ops.n:
        seed32 = ((seed & _M32) ^ 0x80000000) - 0x80000000   # as C int
        launch("rq_icm_ils", ops.Xb, ops.Cr, ops.Ct, ops.c2, B, orders, out,
               E, ops.n, ops.d, ops.m, ops.h, ops.hk, ilsiter, icmiter,
               npert, seed32, device=ops.device)
        encoding_ils.launches += 1
    return out, E


def encoding_ils(X: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
                 orders: torch.Tensor, seed: int, *, ilsiter: int,
                 icmiter: int, npert: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K12, the whole ILS loop in one launch (counterpart of
    ``encoding_ils_pallas``) → ``(best codes (n, m) int32, their energy
    (n,) f32)`` without the ``|x|^2`` term. Per vector, from B: per
    round r < ``ilsiter``, ``npert`` redraws by the counter hash of
    (``seed``, the vector's index in X, r, draw), ``icmiter`` sweeps in
    the node order ``orders[r]`` (``orders (ilsiter, m)`` int32 on X's
    device), and a strict accept on the energy; ``ilsiter=0`` returns B
    and its energy. CPU tensors take the plain version at f32.
    Source: ``rayuela_tpu_torch/csrc/icm.cu``."""
    return _ils(IcmOperands(X, C), B, orders, seed, ilsiter=ilsiter,
                icmiter=icmiter, npert=npert)


encoding_ils.launches = 0


def encoding_icm(gen: torch.Generator, X: torch.Tensor, C: torch.Tensor,
                 B0: torch.Tensor, *, ilsiter: int = 8, icmiter: int = 4,
                 npert: int = 4, randord: bool = True, impl: str = "auto"
                 ) -> torch.Tensor:
    """ILS-over-ICM encoding → improved codes ``(n, m) int32``. ``gen``
    lies on X's device. Defaults are the reference experiment settings.
    ``impl="auto"`` (or ``"pallas"``) relaunches `icm_sweeps` per round
    (the kernel on the card, the plain version on the CPU);
    ``impl="pallas-ils"`` is one `encoding_ils` call (K12 on the card),
    with the node orders from ``gen`` and one int32 seed drawn after them;
    ``"pallas-ils-interpret"`` runs its plain version at the kernel's
    bf16 objective on any device."""
    if impl not in ("auto", "pallas", "pallas-ils", "pallas-ils-interpret"):
        raise ValueError(f"impl={impl!r}: 'auto', 'pallas', 'pallas-ils' or "
                         "'pallas-ils-interpret'")
    m = C.shape[0]
    orders = _ils_schedule(gen, m, ilsiter, randord, X.device)
    B = B0.to(device=X.device, dtype=torch.int32).contiguous()
    if impl.startswith("pallas-ils"):
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                 device=gen.device))
        kw = dict(ilsiter=ilsiter, icmiter=icmiter, npert=npert)
        if impl == "pallas-ils-interpret":
            return encoding_ils_plain(X, C, B, orders, seed, **kw)[0]
        return encoding_ils(X, C, B, orders, seed, **kw)[0]
    ops = IcmOperands(X, C)
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
