"""Packed selection keys and the cross-lane top-k merge (counterpart of
the shared helpers of `rayuela_tpu/search/scan_pallas.py`).

A scan keeps per-lane key buffers: row ``gid`` lives in lane
``gid % 128`` with per-lane row id ``rid = gid >> 7``, and its key is
the top ``32 - idbits`` bits of the score's sortable int32 form above
``rid``. Signed key order is (truncated score, rid), total within a
lane; the cross-lane merge breaks ties between lanes by lane, so the
final order is (truncated score, gid).
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.kernels.build import launch

LANES = 128
IMAX = torch.iinfo(torch.int32).max

# query block of the plain versions: bounds their transient memory
_QBLOCK = 2048


def _pack_idbits(npad: int) -> int:
    """Row-id width of the packed keys for a base padded to ``npad``
    rows; 0 when the ids need more than 16 bits (n > 8.4M: the score
    bits left over get too coarse — such bases run in segments)."""
    rowmax = npad // LANES
    idbits = max(1, (rowmax - 1).bit_length())
    return idbits if idbits <= 16 else 0


def _sortable_key(s: torch.Tensor) -> torch.Tensor:
    """f32 → int32 whose signed order is the float order: the lower 31
    bits of negatives are flipped. Monotone, so truncating low bits
    (floor in key space) stays monotone."""
    bits = s.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _unsortable_key(k: torch.Tensor) -> torch.Tensor:
    """Inverse of `_sortable_key` (int32 keys → f32)."""
    bits = torch.where(k >= 0, k, k ^ 0x7FFFFFFF)
    return bits.contiguous().view(torch.float32)


def _decode_packed_vals(skeys: torch.Tensor, idbits: int) -> torch.Tensor:
    """Packed keys → the truncated f32 scores they were selected by."""
    return _unsortable_key(skeys & -(1 << idbits))


def _row_key(s: torch.Tensor, t: int, *, rows: int,
             idbits: int) -> torch.Tensor:
    """Keys of a ``(rows * 128, nq)`` f32 score block that starts at row
    id ``t * rows`` → ``(rows, 128, nq)`` int32."""
    sv = s.reshape(rows, LANES, -1)
    rid = (torch.arange(rows, dtype=torch.int32, device=s.device)
           + t * rows).view(rows, 1, 1)
    return (_sortable_key(sv) & -(1 << idbits)) | rid


def _tail_shape(r: int, cap: int) -> int:
    """Per-lane list length the merge reads: a key of lane rank >= cap
    can never reach the global top-cap."""
    rpad = 1 << max(0, (r - 1).bit_length())
    return min(cap, rpad)


def tail_merge_plain(rows: torch.Tensor, cap: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `tail_merge` (same signature and outputs)."""
    r, _, nq = rows.shape
    L0 = _tail_shape(r, cap)
    K = rows[:L0]
    if L0 > r:
        K = torch.cat([K, torch.full((L0 - r, LANES, nq), IMAX,
                                     dtype=torch.int32, device=rows.device)])
    lane = torch.arange(LANES, dtype=torch.int64, device=rows.device)
    keys = torch.empty((nq, cap), dtype=torch.int32, device=rows.device)
    lanes = torch.empty_like(keys)
    for q0 in range(0, nq, _QBLOCK):
        comp = (K[:, :, q0:q0 + _QBLOCK].long() * LANES
                + lane[None, :, None])
        comp = comp.reshape(L0 * LANES, -1).T
        v = torch.topk(comp, cap, dim=1, largest=False, sorted=True).values
        keys[q0:q0 + _QBLOCK] = (v >> 7).to(torch.int32)
        lanes[q0:q0 + _QBLOCK] = (v & (LANES - 1)).to(torch.int32)
    return keys, lanes


def tail_merge(rows: torch.Tensor, cap: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3: per query, the ``cap`` smallest (key, lane) pairs over
    the 128 ascending per-lane lists of ``rows (r, 128, nq)`` int32,
    ordered by (key, lane) → ``keys (nq, cap)``, ``lanes (nq, cap)``.
    ``cap`` is a power of two no larger than ``next_pow2(r) * 128``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``rayuela_tpu_torch/csrc/topk_tail.cu``) or raise."""
    if rows.dtype != torch.int32 or rows.dim() != 3 \
            or rows.shape[1] != LANES or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (r, 128, nq) int32")
    r, _, nq = rows.shape
    L0 = _tail_shape(r, cap)
    if cap & (cap - 1) or not 1 <= cap <= L0 * LANES:
        raise ValueError(f"cap={cap} must be a power of two <= "
                         f"{L0 * LANES}")
    if rows.device.type == "cpu":
        return tail_merge_plain(rows, cap)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if L0 > 128:
        raise ValueError(f"r={r} with cap={cap}: per-lane lists of {L0} "
                         "exceed the kernel's shared memory (<= 128)")
    keys = torch.empty((nq, cap), dtype=torch.int32, device=rows.device)
    lanes = torch.empty_like(keys)
    if nq:
        launch("rq_tail_merge", rows, keys, lanes, r, nq, cap, L0,
               device=rows.device)
        tail_merge.launches += 1
    return keys, lanes


tail_merge.launches = 0


def _packed_candidates(outp: torch.Tensor, nq: int, r: int, k: int,
                       idbits: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-lane key buffer ``outp (r, 128, nqp)`` → ``(truncated scores
    (nq, k) f32, gids (nq, k) int32, tau (nq,) int32)``, where tau is
    the k-th key: the boundary the scan's certificate is held against."""
    rpad = 1 << max(0, (r - 1).bit_length())
    cap = min(1 << max(0, (k - 1).bit_length()), rpad * LANES)
    keys, lanes = tail_merge(outp[:r].contiguous(), cap)
    skeys, slanes = keys[:nq, :k], lanes[:nq, :k]
    ids = (skeys & ((1 << idbits) - 1)) * LANES + slanes
    return _decode_packed_vals(skeys, idbits), ids, skeys[:, k - 1]

