"""Packed selection keys, the kernels every packed scan shares, and the
scan over a decoded base (counterpart of
`rayuela_tpu/search/scan_pallas.py`).

A scan keeps per-lane key buffers: row ``gid`` lives in lane
``gid % 128`` with per-lane row id ``rid = gid >> 7``, and its key is
the top ``32 - idbits`` bits of the score's sortable int32 form above
``rid``. Signed key order is (truncated score, rid), total within a
lane; the cross-lane merge breaks ties between lanes by lane, so the
final order is (truncated score, gid).

What a packed scan computes is a function of the scores and of
``(tile, keep, premin, r)`` alone. Per (lane, query), over the lane's
row ids in order: within each tile, windows of ``2**premin``
consecutive row ids reduce to their minimum key; if ``keep`` and
``keep < rows_eff`` only the tile's ``keep`` smallest survive; the
``r`` smallest survivors overall, ascending, are rows ``0..r-1`` of the
``(r + 1, 128, nq)`` buffer, and row ``r``, the certificate, is the
minimum of every key that is not among them (INT32_MAX if none). A
query whose certificate beats its k-th key may have lost a true top-k
member and is flagged. The pre-min exists in the plain versions only
(``premin=0`` on the card: it saved no time there).

The decoded index is the base decoded once (``Xd (n, d)``, bfloat16 on
the card, and the norm terms ``x2 (n,)``); a search is K8
`scan_candidates` (per tile and (lane, query) the ``keep`` smallest
keys) → K2 `cand_merge` → K3 `tail_merge`, and flagged queries re-run
through `linscan.exact_rescan`. Every kernel wrapper takes its plain
PyTorch version for CPU tensors only; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.kernels.build import launch
from rayuela_tpu_torch.utils import cdiv, exact_f32

LANES = 128
IMAX = torch.iinfo(torch.int32).max

# query block of the plain versions: bounds their transient memory
_QBLOCK = 1024

# row ids are 16 bits wide, so one scan call covers this many rows;
# larger bases run in segments with an exact merge
_SEG_DECODED = (1 << 16) * LANES

# the kernels' compile-time variants: per-tile keep of the candidates
# kernels, buffer depth r of K2, and r of the one-pass kernels
_KEEPS = (2, 4)
_RS = (16, 32, 48, 96)
_ONEPASS_R = 48
_MAX_DP = 256
_MAX_SPLITS = 4096

# largest candidate array (bytes) one scan call may allocate: larger
# query batches run in chunks
_CAND_CAP = 3 << 30

# deepest k the plan serves by kernel (see `_scan_config`)
_MAX_K = 64 * LANES
_TILE = 8192


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


def _finish(outp: torch.Tensor, nq: int, r: int, k: int, idbits: int):
    """Per-lane buffer ``outp (r + 1, 128, nq)`` → ``(truncated scores,
    ids, flagged)``: a query is flagged when some lane's certificate
    beats its k-th key."""
    vals, ids, tau = _packed_candidates(outp, nq, r, k, idbits)
    flagged = (outp[r] < tau[None, :]).any(0)
    return vals, ids, flagged


def _query_operand(Q: torch.Tensor, dp: int, dtype) -> torch.Tensor:
    """``-2 Q`` zero-padded to dp columns, at the operand dtype."""
    Qm = torch.nn.functional.pad(-2.0 * Q, (0, dp - Q.shape[1]))
    return Qm.to(dtype).contiguous()


def _query_chunks(nq: int, bytes_per_query: int) -> list[tuple[int, int]]:
    """Ranges ``(a, b)`` that cut a batch of ``nq`` queries so that no
    chunk's candidate array (``bytes_per_query`` each) passes
    `_CAND_CAP`."""
    per = max(1, _CAND_CAP // max(1, bytes_per_query))
    return [(a, min(a + per, nq)) for a in range(0, max(nq, 1), per)]


# ---------------------------------------------------------------------------
# Kernel K2 and the plain selection every scan's plain version shares
# ---------------------------------------------------------------------------

def _premin_plain(kv: torch.Tensor, premin: int):
    """Keys ``(rows, 128, nq)`` → the minimum of each window of
    ``2**premin`` consecutive rows ``(rows >> premin, 128, nq)`` and the
    minimum of every other key ``(128, nq)``."""
    w = 1 << premin
    srt = kv.reshape(kv.shape[0] // w, w, *kv.shape[1:]).sort(dim=1).values
    return srt[:, 0], srt[:, 1].amin(0)


def _candidates_plain(keys_fn, n: int, nq: int, device, *, tile: int,
                      keep: int, premin: int = 0):
    """Per tile and (lane, query): the ``keep`` smallest keys after the
    pre-min, ascending, and the smallest of the tile's other keys.
    ``keys_fn(t, q0, q1)`` gives tile t's keys ``(tile/128, 128, q1-q0)``
    for the queries [q0, q1)."""
    ntiles, rows_eff = cdiv(n, tile), (tile // LANES) >> premin
    cand = torch.empty((ntiles * keep, LANES, nq), dtype=torch.int32,
                       device=device)
    disc = torch.empty((ntiles, LANES, nq), dtype=torch.int32, device=device)
    for t in range(ntiles):
        for q0 in range(0, nq, _QBLOCK):
            q1 = min(q0 + _QBLOCK, nq)
            kv = keys_fn(t, q0, q1)
            lost = None
            if premin:
                kv, lost = _premin_plain(kv, premin)
            top = torch.topk(kv, min(keep + 1, rows_eff), dim=0,
                             largest=False, sorted=True).values
            cand[t * keep:(t + 1) * keep, :, q0:q1] = top[:keep]
            d = top[keep] if rows_eff > keep else torch.full_like(top[0],
                                                                  IMAX)
            disc[t, :, q0:q1] = d if lost is None else torch.minimum(d, lost)
    return cand, disc


def _onepass_plain(keys_fn, n: int, nq: int, device, *, tile: int, r: int,
                   premin: int = 0) -> torch.Tensor:
    """Per (lane, query) over all tiles: the ``r`` smallest keys after
    the pre-min, ascending, then the smallest other key →
    ``(r + 1, 128, nq)``. ``keys_fn`` as in `_candidates_plain`."""
    out = torch.empty((r + 1, LANES, nq), dtype=torch.int32, device=device)
    for q0 in range(0, nq, _QBLOCK):
        q1 = min(q0 + _QBLOCK, nq)
        buf = torch.full((r + 1, LANES, q1 - q0), IMAX, dtype=torch.int32,
                         device=device)
        lost = buf[0].clone()
        for t in range(cdiv(n, tile)):
            kv = keys_fn(t, q0, q1)
            if premin:
                kv, lo = _premin_plain(kv, premin)
                lost = torch.minimum(lost, lo)
            buf = torch.topk(torch.cat([buf, kv]), r + 1, dim=0,
                             largest=False, sorted=True).values
        buf[r] = torch.minimum(buf[r], lost)
        out[:, :, q0:q1] = buf
    return out


def cand_merge_plain(cand, disc, r: int):
    """Plain version of `cand_merge` (same signature and outputs)."""
    ncand, _, nq = cand.shape
    out = torch.empty((r + 1, LANES, nq), dtype=torch.int32,
                      device=cand.device)
    for q0 in range(0, nq, _QBLOCK):
        c = cand[:, :, q0:q0 + _QBLOCK]
        if ncand < r + 1:
            c = torch.cat([c, torch.full((r + 1 - ncand,) + c.shape[1:],
                                         IMAX, dtype=torch.int32,
                                         device=c.device)])
        top = torch.topk(c, r + 1, dim=0, largest=False, sorted=True).values
        cert = top[r]
        if disc.shape[0]:
            cert = torch.minimum(cert, disc[:, :, q0:q0 + _QBLOCK].amin(0))
        out[:r, :, q0:q0 + _QBLOCK] = top[:r]
        out[r, :, q0:q0 + _QBLOCK] = cert
    return out


def cand_merge(cand, disc, r: int):
    """Kernel K2, pass 2 of every two-pass scan. Per (lane, query): the
    ``r`` smallest keys of ``cand (ncand, 128, nq)``, ascending, then one
    certificate row, ``min(every discard minimum in disc (ndisc, 128,
    nq), every candidate not kept)`` → ``(r + 1, 128, nq)`` int32.
    Source: ``rayuela_tpu_torch/csrc/codes_scan.cu``."""
    for t in (cand, disc):
        if t.dtype != torch.int32 or t.dim() != 3 \
                or t.shape[1] != LANES or not t.is_contiguous():
            raise ValueError("cand and disc must be contiguous "
                             "(rows, 128, nq) int32")
    if cand.device != disc.device or cand.shape[2] != disc.shape[2]:
        raise ValueError("cand and disc disagree in device or nq")
    if cand.device.type == "cpu":
        return cand_merge_plain(cand, disc, r)
    if cand.device.type != "cuda":
        raise ValueError(f"unsupported device {cand.device}")
    if r not in _RS:
        raise ValueError(f"r={r}: the kernel takes {_RS}")
    nq = cand.shape[2]
    out = torch.empty((r + 1, LANES, nq), dtype=torch.int32,
                      device=cand.device)
    if nq:
        launch("rq_cand_merge", cand, disc, out, cand.shape[0],
               disc.shape[0], nq, r, device=cand.device)
        cand_merge.launches += 1
    return out


cand_merge.launches = 0


def _alloc_candidates(n: int, nq: int, tile: int, keep: int, device):
    """Outputs of a candidates kernel → ``(ntiles, cand, disc)``."""
    ntiles = cdiv(n, tile)
    cand = torch.empty((ntiles * keep, LANES, nq), dtype=torch.int32,
                       device=device)
    disc = torch.empty((ntiles, LANES, nq), dtype=torch.int32, device=device)
    return ntiles, cand, disc


def _alloc_onepass(n: int, nq: int, tile: int, r: int, device):
    """Outputs of a one-pass kernel → ``(out, cand, disc, nrows,
    rows_per)``. The row range is split until the card holds ~4 CTAs per
    SM: such a kernel serves a few queries, and one CTA per query pair
    walking the whole base would leave most SMs idle. With one split
    ``cand`` and ``disc`` are views of the final ``out (r + 1, 128,
    nq)``; with more they are scratch that K2 merges into it
    (`_merge_onepass`)."""
    out = torch.empty((r + 1, LANES, nq), dtype=torch.int32, device=device)
    nrows = cdiv(n, tile) * tile // LANES
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = min(nrows, _MAX_SPLITS, max(1, cdiv(4 * sms, cdiv(nq, 2))))
    rows_per = cdiv(nrows, splits)
    splits = cdiv(nrows, rows_per)
    if splits == 1:
        return out, out[:r], out[r:], nrows, rows_per
    cand = torch.empty((splits * r, LANES, nq), dtype=torch.int32,
                       device=device)
    disc = torch.empty((splits, LANES, nq), dtype=torch.int32, device=device)
    return out, cand, disc, nrows, rows_per


def _merge_onepass(out, cand, disc, r: int):
    """The one-pass kernel's final buffer: ``out`` when it wrote there,
    else K2 over its splits."""
    return out if disc.shape[0] == 1 else cand_merge(cand, disc, r)


# ---------------------------------------------------------------------------
# Kernel K8: the scan over a decoded base
# ---------------------------------------------------------------------------

def _check_decoded(Qm, Xd, x2, tile: int, premin: int) -> bool:
    """Validate the decoded-scan operands; True when they lie on a CUDA
    device (launch the kernel), False on the CPU (plain version)."""
    dev = Qm.device
    if Xd.device != dev or x2.device != dev:
        raise ValueError("operands must share one device")
    if Xd.dtype not in (torch.float32, torch.bfloat16) \
            or Qm.dtype != Xd.dtype or x2.dtype != torch.float32:
        raise ValueError("Qm and Xd must share a float32 or bfloat16 dtype "
                         "and x2 must be float32")
    if Xd.dim() != 2 or Qm.dim() != 2 or Qm.shape[1] != Xd.shape[1] \
            or x2.shape != (Xd.shape[0],):
        raise ValueError(f"inconsistent shapes Qm {tuple(Qm.shape)}, Xd "
                         f"{tuple(Xd.shape)}, x2 {tuple(x2.shape)}")
    if not all(t.is_contiguous() for t in (Qm, Xd, x2)):
        raise ValueError("operands must be contiguous")
    rows = tile // LANES
    if tile % LANES or rows & (rows - 1):
        raise ValueError(f"tile/128={tile / LANES} must be a power of two")
    if premin < 0 or not rows >> premin:
        raise ValueError(f"premin={premin} must leave tile/128 >> premin "
                         ">= 1")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if Xd.shape[1] % 8 or Xd.shape[1] > _MAX_DP:
        raise ValueError(f"d={Xd.shape[1]} must be a multiple of 8 (the "
                         "kernel reads rows 16 bytes at a time; "
                         f"`LinscanIndex` pads) and at most {_MAX_DP} (the "
                         "tile must fit the kernel's shared memory)")
    if Xd.data_ptr() % 16:
        raise ValueError("Xd must be 16-byte aligned")
    if Qm.shape[0] >= 1 << 21 or cdiv(Xd.shape[0], tile) >= 1 << 16:
        raise ValueError("at most 2**21 queries and 2**16 - 1 tiles per "
                         "call")
    return True


def _decoded_keys_fn(Qm, Xd, x2, tile: int, idbits: int):
    """`keys_fn` of the plain selections for a decoded base: scores
    ``Xd Qm^T + x2`` in f32, +inf at and past row n."""
    exact_f32()
    n, rows = Xd.shape[0], tile // LANES
    Qf = Qm.float()

    def keys(t, q0, q1):
        g0 = t * tile
        S = torch.full((tile, q1 - q0), float("inf"), dtype=torch.float32,
                       device=Qm.device)
        nv = max(0, min(tile, n - g0))
        S[:nv] = Xd[g0:g0 + nv].float() @ Qf[q0:q1].T + x2[g0:g0 + nv, None]
        return _row_key(S, t, rows=rows, idbits=idbits)
    return keys


def scan_candidates_plain(Qm, Xd, x2, *, tile: int, keep: int, premin: int,
                          idbits: int):
    """Plain version of `scan_candidates` (same signature and outputs)."""
    return _candidates_plain(
        _decoded_keys_fn(Qm, Xd, x2, tile, idbits), Xd.shape[0], Qm.shape[0],
        Qm.device, tile=tile, keep=keep, premin=premin)


def scan_candidates(Qm, Xd, x2, *, tile: int, keep: int, premin: int,
                    idbits: int):
    """Kernel K8, pass 1 of the decoded scan. For each tile of ``tile``
    rows and each (lane, query): windows of ``2**premin`` consecutive
    row ids reduce to their minimum key, then the ``keep`` smallest keys,
    ascending, and the smallest of the tile's other keys (INT32_MAX when
    none).

    ``Qm (nq, dp)`` is ``-2 Q`` at the operand dtype, ``Xd (n, dp)`` the
    decoded base at that dtype (dp a multiple of 8 on the card), ``x2
    (n,)`` f32. Returns ``cand (ntiles*keep, 128, nq)`` and ``disc
    (ntiles, 128, nq)`` int32. The kernel is compiled without the
    pre-min (it saved no time on the card): a CUDA tensor with
    ``premin != 0`` raises. Source:
    ``rayuela_tpu_torch/csrc/decoded_scan.cu``."""
    on_card = _check_decoded(Qm, Xd, x2, tile, premin)
    if keep < 1 or keep > (tile // LANES) >> premin:
        raise ValueError(f"1 <= keep={keep} <= (tile/128) >> premin")
    if not on_card:
        return scan_candidates_plain(Qm, Xd, x2, tile=tile, keep=keep,
                                     premin=premin, idbits=idbits)
    if keep not in _KEEPS or premin:
        raise ValueError(f"keep={keep}, premin={premin}: the kernel takes "
                         f"keep in {_KEEPS}, premin=0")
    (n, dp), nq = Xd.shape, Qm.shape[0]
    ntiles, cand, disc = _alloc_candidates(n, nq, tile, keep, Qm.device)
    if nq and n:
        launch("rq_scan_candidates", Qm, Xd, x2, cand, disc, n, nq, dp,
               ntiles, tile // LANES, keep, idbits,
               int(Xd.dtype == torch.bfloat16), device=Qm.device)
        scan_candidates.launches += 1
    return cand, disc


scan_candidates.launches = 0


def scan_onepass_plain(Qm, Xd, x2, *, tile: int, r: int, premin: int,
                       idbits: int):
    """Plain version of `scan_onepass` (same signature and outputs)."""
    return _onepass_plain(
        _decoded_keys_fn(Qm, Xd, x2, tile, idbits), Xd.shape[0], Qm.shape[0],
        Qm.device, tile=tile, r=r, premin=premin)


def scan_onepass(Qm, Xd, x2, *, tile: int, r: int, premin: int,
                 idbits: int):
    """Kernel K8 at ``keep=0``: the one-pass decoded scan. Per (lane,
    query) over the whole base (padded to a multiple of ``tile`` rows):
    the ``r`` smallest keys after the pre-min, ascending, then the
    smallest other key → ``(r + 1, 128, nq)`` int32. Scores exactly as
    `scan_candidates`. On the card the row range is split over CTAs and
    K2 merges the splits; the kernel is compiled for ``r=48`` without
    the pre-min. Source: ``rayuela_tpu_torch/csrc/decoded_scan.cu``."""
    if not _check_decoded(Qm, Xd, x2, tile, premin):
        return scan_onepass_plain(Qm, Xd, x2, tile=tile, r=r, premin=premin,
                                  idbits=idbits)
    if r != _ONEPASS_R or premin:
        raise ValueError(f"r={r}, premin={premin}: the kernel takes "
                         f"r={_ONEPASS_R}, premin=0")
    (n, dp), nq = Xd.shape, Qm.shape[0]
    dev = Qm.device
    if not nq:
        return torch.empty((r + 1, LANES, 0), dtype=torch.int32, device=dev)
    out, cand, disc, nrows, rows_per = _alloc_onepass(n, nq, tile, r, dev)
    launch("rq_scan_onepass", Qm, Xd, x2, cand, disc, n, nq, dp, nrows,
           rows_per, r, idbits, int(Xd.dtype == torch.bfloat16), device=dev)
    scan_onepass.launches += 1
    return _merge_onepass(out, cand, disc, r)


scan_onepass.launches = 0


def scan_topk_packed(Q, Xd, x2, *, k: int, r: int = 32, tile: int = _TILE,
                     keep: int = 4, premin: int = 0):
    """Exact-unless-flagged top-k over a decoded base (K8 → K2 → K3) →
    ``(truncated scores (nq, k) f32 without +|q|^2, ids (nq, k) int32,
    flagged (nq,) bool)``.

    ``Xd (n, d)`` f32 or bf16, ``x2 (n,)`` the norm terms, ``Q (nq, d)``.
    ``keep`` is the per-(lane, tile) pre-reduction (0: none, the
    one-pass kernel); ``premin`` the lossy pre-filter: windows of
    ``2**premin`` consecutive row ids of a lane keep only their minimum
    (plain version only: CPU tensors). Every loss is caught by the
    certificate and flags the query."""
    n = Xd.shape[0]
    if k > r * LANES:
        raise ValueError(f"k={k} > r*128={r * LANES}")
    rows = tile // LANES
    if tile % LANES or rows & (rows - 1):
        raise ValueError(f"tile/128={tile / LANES} must be a power of two")
    if premin < 0 or (rows >> premin) < max(1, keep):
        raise ValueError(f"premin={premin} must leave tile/128 >> premin "
                         f">= max(1, keep={keep})")
    rows_eff = rows >> premin
    if keep and (keep & (keep - 1) or keep > rows_eff):
        raise ValueError(f"keep={keep} must be a power of two <= "
                         f"(tile/128)>>premin={rows_eff}")
    idbits = _pack_idbits(cdiv(n, tile) * tile)
    if not idbits:
        raise ValueError(f"n={n} exceeds the packed row-id range "
                         f"({_SEG_DECODED} rows per call); segment the base")
    Qm = _query_operand(Q.to(torch.float32), Xd.shape[1], Xd.dtype)
    x2 = x2.to(torch.float32).contiguous()
    if keep and keep < rows_eff:
        cand, disc = scan_candidates(Qm, Xd, x2, tile=tile, keep=keep,
                                     premin=premin, idbits=idbits)
        outp = cand_merge(cand, disc, r)
    else:
        outp = scan_onepass(Qm, Xd, x2, tile=tile, r=r, premin=premin,
                            idbits=idbits)
    return _finish(outp, Q.shape[0], r, min(k, n), idbits)


# ---------------------------------------------------------------------------
# The decoded index and its search front end
# ---------------------------------------------------------------------------

def decode_base(C: torch.Tensor, B: torch.Tensor, *, pq: bool = False,
                d: int | None = None,
                norm_term: torch.Tensor | None = None,
                dtype=torch.float32, chunk: int = 65536):
    """One-time base decode → ``(Xd (n, d) at dtype, x2 (n,) f32)``.
    ``norm_term`` overrides the exact ``|x_hat|^2`` (quantized norms of
    the additive models, codebook norms of CQ)."""
    from rayuela_tpu_torch.ops.qerror import reconstruct, reconstruct_pq
    Xs, x2s = [], []
    for s in range(0, B.shape[0], chunk):
        Bc = B[s:s + chunk]
        Xc = reconstruct_pq(C, Bc, d) if pq else reconstruct(C, Bc)
        Xs.append(Xc.to(dtype))
        x2s.append((Xc * Xc).sum(-1))
    if not Xs:
        width = d if pq and d is not None else C.shape[2]
        return (torch.zeros(0, width, dtype=dtype, device=C.device),
                torch.zeros(0, dtype=torch.float32, device=C.device))
    x2 = torch.cat(x2s) if norm_term is None else \
        norm_term.to(torch.float32).reshape(-1)
    return torch.cat(Xs), x2


class LinscanIndex:
    """A decoded, scan-ready base set: build once, search many times.
    ``Xd`` is kept zero-padded to a multiple of 8 columns (the kernel
    reads rows 16 bytes at a time); ``d`` is its true width."""

    def __init__(self, Xd: torch.Tensor, x2: torch.Tensor):
        self.n, self.d = Xd.shape
        self.Xd = torch.nn.functional.pad(
            Xd, (0, cdiv(self.d, 8) * 8 - self.d)).contiguous()
        self.x2 = x2.to(torch.float32).contiguous()


def build_index(C: torch.Tensor, B: torch.Tensor, *, pq: bool = False,
                d: int | None = None,
                norm_term: torch.Tensor | None = None,
                dtype=None) -> LinscanIndex:
    """``dtype=None`` picks bfloat16 on the card (half the device memory
    and the tile loads; scores keep f32 accumulation) and float32 on the
    CPU (the tests compare exactly)."""
    if dtype is None:
        dtype = torch.bfloat16 if C.device.type == "cuda" else torch.float32
    return LinscanIndex(*decode_base(C, B, pq=pq, d=d, norm_term=norm_term,
                                     dtype=dtype))


def _scan_config(k: int) -> tuple[int, int, int]:
    """Scan plan of the two-pass scans for a top-k of size ``k`` →
    ``(r, keep, tile)``, for k up to `_MAX_K`.

    A lane's share of the top-k is about Poisson(k / 128), and K2's
    per-lane buffer ``r`` must hold it in all 128 lanes, or the query is
    flagged and re-runs exactly; ``keep`` must hold a lane's share
    within one tile, so the deepest class takes a smaller tile. Both set
    how much K2 reads, so they stay as small as the flag rate allows.
    The class limits are where the flag counts measured on the card
    (PERF.md) pass a few per cent of a batch; beyond `_MAX_K` most
    queries overflow the deepest buffer (r = 96), and the searches take
    their exact scan directly."""
    if k <= 512:
        return 16, 2, _TILE
    if k <= 2048:
        return 32, 4, _TILE
    if k <= 3072:
        return 48, 4, _TILE
    return _RS[-1], 4, 2048


def _scan_segments(Q, Xd, x2, *, k: int, r: int, tile: int, keep: int):
    """A base beyond the packed row-id range: the scan per
    `_SEG_DECODED`-row segment with an exact merge on the device; the
    segments' flags are OR-ed."""
    best_d = best_i = flagged = None
    for st in range(0, Xd.shape[0], _SEG_DECODED):
        Xs, x2s = Xd[st:st + _SEG_DECODED], x2[st:st + _SEG_DECODED]
        dv, iv, fl = scan_topk_packed(Q, Xs, x2s, k=min(k, Xs.shape[0]),
                                      r=r, tile=tile, keep=keep)
        iv = iv + st
        if best_d is None:
            best_d, best_i, flagged = dv, iv, fl
            continue
        cd, ci = torch.cat([best_d, dv], 1), torch.cat([best_i, iv], 1)
        top = torch.topk(cd, k, dim=1, largest=False, sorted=True)
        best_d, best_i = top.values, torch.gather(ci, 1, top.indices)
        flagged = flagged | fl
    return best_d, best_i, flagged


def search(index: LinscanIndex, Q, k: int, *, r: int | None = None,
           tile: int | None = None, keep: int | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k search over a decoded index → ``(dists (nq, k) f32
    with +|q|^2, ids (nq, k) int32)``: the kernel scan, then
    `exact_rescan` for every query its certificate flags.

    ``r``/``tile``/``keep`` default to the plan of the k class
    (`_scan_config`). Beyond `_MAX_K` the search is `exact_rescan`
    alone. A query batch whose candidate array
    would pass `_CAND_CAP` bytes runs in chunks."""
    from rayuela_tpu_torch.search.linscan import exact_rescan

    Xd, x2 = index.Xd, index.x2
    Q = torch.as_tensor(Q, dtype=torch.float32, device=Xd.device)
    Q = torch.nn.functional.pad(Q, (0, Xd.shape[1] - Q.shape[1]))
    k = min(k, index.n)       # never return padded (inf, fake-id) rows
    if r is None and k > _MAX_K:
        return exact_rescan(Q, Xd, x2, k)
    ar, akeep, atile = _scan_config(min(k, _MAX_K))
    if r is None and keep is None and tile is None \
            and k > cdiv(index.n, atile) * akeep * LANES:
        # the tiles keep fewer than k candidates (k most of a small base)
        return exact_rescan(Q, Xd, x2, k)
    r = ar if r is None else r
    keep = akeep if keep is None else keep
    tile = atile if tile is None else tile
    segmented = cdiv(index.n, tile) * tile > _SEG_DECODED
    q2 = (Q * Q).sum(-1, keepdim=True)
    ntiles = cdiv(min(index.n, _SEG_DECODED), tile)
    parts = []
    for a, b in _query_chunks(Q.shape[0], ntiles * max(keep, 1) * LANES * 4):
        if segmented:
            parts.append(_scan_segments(Q[a:b], Xd, x2, k=k, r=r, tile=tile,
                                        keep=keep))
        else:
            parts.append(scan_topk_packed(Q[a:b], Xd, x2, k=k, r=r,
                                          tile=tile, keep=keep))
    s, i, flagged = (torch.cat(p) for p in zip(*parts))
    s = s + q2
    if bool(flagged.any()):
        qidx = torch.nonzero(flagged).flatten()
        s[qidx], i[qidx] = exact_rescan(Q[qidx], Xd, x2, k)
    return s, i
