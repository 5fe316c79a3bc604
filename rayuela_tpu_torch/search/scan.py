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

``search(..., pack=False)`` is the exact-float scan: it selects by the
untruncated f32 score and the global row id, a total order (score,
gid), so its result is the exact top-k of the f32 scores with the
lowest id among equal ones. K9 (`scan_f32_candidates`, then
`pair_merge`) gives per (lane, query) the ``r`` smallest pairs, the
final top-k over the ``r * 128`` candidates is a `torch.topk`, and K10
`verify_counts` counts, per (lane, query), the rows that come before
the k-th pair: more than ``r`` of them in a lane (or more than ``keep``
in one tile of a lane) and the query is flagged and re-runs through
`linscan.exact_rescan`.
"""

from __future__ import annotations

import functools

import torch

from rayuela_tpu_torch.kernels.build import launch, query
from rayuela_tpu_torch.utils import (as_tensor, cdiv, exact_f32,
                                     topk_lowest_id)
from rayuela_tpu_torch.utils import sortable_key as _sortable_key

LANES = 128
IMAX = torch.iinfo(torch.int32).max

# query block of the plain versions: bounds their transient memory
_QBLOCK = 1024

# row ids are 16 bits wide, so one scan call covers this many rows;
# larger bases run in segments with an exact merge
_SEG_DECODED = (1 << 16) * LANES

# the kernels' compile-time variants: per-tile keep of the candidates
# kernels, buffer depth r of K2 (the two-pass plans' r, and the one-pass
# plan's, whose K14 splits K2 merges), and r of the keep=0 one-pass
# kernels
_KEEPS = (2, 4)
_RS = (12, 14, 16, 28, 32, 48, 96)
_ONEPASS_R = 48
_MAX_SPLITS = 4096
# the cost model of the keep=0 one-pass splits (`_onepass_splits`), in
# microseconds on an H100 (`demos/time_onepass.py --sweep`: 6.3 to 8.6
# at 1 to 128 queries): one step of a one-pass CTA (32 rows) per 128
# dimensions, and one candidate row of K2's merge, per wave of
# _MERGE_THREADS threads an SM
_STEP_US, _MERGE_US, _MERGE_THREADS = 8.0, 0.2, 2048

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


# K3's layout constants (`tail_layout`, csrc/topk_tail.cu): threads and
# queries of a CTA at most, values a warp sorts at most, bytes of a
# query's lane offsets and span
_TAIL_THREADS, _TAIL_QB, _WARP_N, _TAIL_META = 256, 4, 1024, 536
# dynamic shared memory one CTA may take on the card (H100: 227 KB)
_SMEM_CAP = 232448


def _tail_layout(r: int, cap: int) -> tuple[int, int, int, int, int]:
    """K3's layout at ``(r, cap)``, as the kernel's source states it
    (`tail_layout`, ``csrc/topk_tail.cu``): ``(queries per CTA, threads
    per CTA, slots staged per lane, bytes of one query's region, shared
    bytes per CTA)``. A query takes ``max(1, cap / 1024)`` warps, which
    sort its survivors in registers; its region holds its staged lists
    (``min(L0, r)`` slots of 128 keys), later its warps' exchanges and
    its sorted keys and lanes (``8 * cap`` bytes), then its lane offsets
    and span; it is 16 bytes past a multiple of 128 so that the queries
    of one load instruction meet distinct banks. Queries per CTA halve
    from 4 until the regions fit and the CTA keeps to 256 threads; 0
    where not even one query fits (``cap > 8192``)."""
    lr = min(_tail_shape(r, cap), r)
    wq = max(1, cap // _WARP_N)
    r1 = max(4 * LANES * lr, 8 * cap)
    qbytes = cdiv(r1 + _TAIL_META, 128) * 128 + 16
    qb = _TAIL_QB
    while qb and (qb * qbytes > _SMEM_CAP or 32 * wq * qb > _TAIL_THREADS):
        qb >>= 1
    return qb, 32 * wq * qb, lr, qbytes, qb * qbytes


def tail_merge(rows: torch.Tensor, cap: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3: per query, the ``cap`` smallest (key, lane) pairs over
    the 128 ascending per-lane lists of ``rows (r, 128, nq)`` int32,
    ordered by (key, lane) → ``keys (nq, cap)``, ``lanes (nq, cap)``.
    ``cap`` is a power of two no larger than ``next_pow2(r) * 128``; on
    the card also no larger than 8192 (`_tail_layout`), the deepest the
    plans ask for (`_MAX_K`).

    On the card a warp finds a query's cap-th pair by bisection over
    counts of the sorted lists, and ``max(1, cap / 1024)`` warps sort the
    lanes' surviving prefixes in registers (`_tail_layout`); it uses that
    each lane's list is ascending. CPU tensors take the plain version;
    CUDA tensors launch the kernel
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
    if not _tail_layout(r, cap)[0]:
        raise ValueError(f"cap={cap}: one query's sort exceeds a CTA's "
                         "shared memory (cap <= 8192)")
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


def _onepass_splits(ctas: int, nsteps: int, slots: int, step_us: float,
                    merge_us: float) -> int:
    """Steps per CTA of a keep=0 one-pass kernel (K4, K8) whose grid has
    ``ctas`` CTAs per split and whose rows take ``nsteps`` steps, on a
    card of ``slots`` CTA slots. With ``s`` splits of ``per`` steps the
    scan takes about ``ceil(ctas * s / slots)`` waves of ``per`` steps
    of ``step_us`` each, and K2 then merges ``s`` candidate blocks at
    ``merge_us`` each (none with one split): the fewest splits within 2%
    of the least such cost, with at most 4 waves of CTAs unless the query
    blocks alone are more."""
    cap = max(1, min(nsteps, _MAX_SPLITS, cdiv(4 * slots, ctas)))
    cost = {}
    for s in range(1, cap + 1):
        per = cdiv(nsteps, s)
        sp = cdiv(nsteps, per)
        cost.setdefault(per, cdiv(ctas * sp, slots) * per * step_us
                        + (sp > 1) * sp * merge_us)
    least = min(cost.values())
    return max(per for per, c in cost.items() if c <= 1.02 * least)


def _onepass_rows(n: int, nq: int, tile: int, r: int, layout, dp: int,
                  sms: int) -> tuple[int, int]:
    """``(nrows, rows_per)`` of a keep=0 one-pass kernel with ``layout``
    (its ``(queries per CTA, lanes per CTA, CTAs per SM, d-block, shared
    bytes)``, from the kernel's source) on a card of ``sms`` SMs: its
    grid has a CTA per query block and lane group, a CTA takes 32 / lanes
    row ids a step, and the row range is split over more CTAs
    (`_onepass_splits`) where those do not fill the card. K2's cost per
    candidate block grows with the plane of (lane, query) pairs beyond a
    wave of its threads."""
    qb, ln, per_sm = layout[:3]
    nr = 32 // ln
    nrows = cdiv(n, tile) * tile // LANES
    merge_waves = cdiv(LANES * nq, sms * _MERGE_THREADS)
    per = _onepass_splits(
        cdiv(nq, qb) * (LANES // ln), cdiv(nrows, nr), sms * per_sm,
        _STEP_US * cdiv(dp, 128), r * _MERGE_US * merge_waves)
    return nrows, per * nr


def _alloc_onepass(n: int, nq: int, tile: int, r: int, device, layout,
                   dp: int):
    """Outputs of a keep=0 one-pass kernel with ``layout`` →
    ``(out, cand, disc, nrows, rows_per)`` (`_onepass_rows`). With one
    split ``cand`` and ``disc`` are views of the final ``out (r + 1,
    128, nq)``; with more they are scratch that K2 merges into it
    (`_merge_onepass`)."""
    out = torch.empty((r + 1, LANES, nq), dtype=torch.int32, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    nrows, rows_per = _onepass_rows(n, nq, tile, r, layout, dp, sms)
    if rows_per >= nrows:
        return out, out[:r], out[r:], nrows, rows_per
    splits = cdiv(nrows, rows_per)
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
    if Xd.shape[1] % 8:
        raise ValueError(f"d={Xd.shape[1]} must be a multiple of 8 (the "
                         "kernel reads rows 16 bytes at a time; "
                         "`LinscanIndex` pads)")
    if Xd.data_ptr() % 16:
        raise ValueError("Xd must be 16-byte aligned")
    if Qm.shape[0] >= 1 << 21 or cdiv(Xd.shape[0], tile) >= 1 << 16:
        raise ValueError("at most 2**21 queries and 2**16 - 1 tiles per "
                         "call")
    return True


def _decoded_scores_fn(Qm, Xd, x2, tile: int):
    """Scores of a decoded base by tile: ``scores(t, q0, q1)`` is ``Xd
    Qm^T + x2`` in f32 for tile t and the queries [q0, q1), ``(tile,
    q1 - q0)``, +inf at and past row n."""
    exact_f32()
    n = Xd.shape[0]
    Qf = Qm.float()

    def scores(t, q0, q1):
        g0 = t * tile
        S = torch.full((tile, q1 - q0), float("inf"), dtype=torch.float32,
                       device=Qm.device)
        nv = max(0, min(tile, n - g0))
        S[:nv] = Xd[g0:g0 + nv].float() @ Qf[q0:q1].T + x2[g0:g0 + nv, None]
        return S
    return scores


def _keys_fn(scores, tile: int, idbits: int):
    """`keys_fn` of the plain packed selections from a tile score
    function."""
    rows = tile // LANES
    return lambda t, q0, q1: _row_key(scores(t, q0, q1), t, rows=rows,
                                      idbits=idbits)


def _decoded_keys_fn(Qm, Xd, x2, tile: int, idbits: int):
    return _keys_fn(_decoded_scores_fn(Qm, Xd, x2, tile), tile, idbits)


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
    (ntiles, 128, nq)`` int32. On bf16 rows the kernel scores on the
    tensor cores (K1's score function, a CTA of 32 queries over 128-row
    steps staged 128 dimensions at a time, `_candidates_layout`); where
    a row is one d-block (dp <= 256) its keys are the fmaf chain's, as
    the f32 body's and the plain version's f32 matmul's on data whose
    sums round alike, beyond that the tensor-core keys. The kernel is
    compiled without the pre-min (it saved no time on the card): a CUDA
    tensor with ``premin != 0`` raises. Source:
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
        _launch_candidates(Qm, Xd, x2, cand, disc, 0, tile, keep, idbits)
        scan_candidates.launches += 1
    return cand, disc


scan_candidates.launches = 0


def _launch_candidates(Qm, Xd, x2, cand, disc, stats, tile: int, keep: int,
                       idbits: int) -> None:
    """K8's launch on checked CUDA operands; ``stats`` (an int32 tensor,
    or 0) gains the pairs the fmaf chain scored (bf16 rows)."""
    (n, dp), nq = Xd.shape, Qm.shape[0]
    bf16 = int(Xd.dtype == torch.bfloat16)
    if bf16 and Qm.data_ptr() % 16:      # the kernel copies 16 bytes
        Qm = Qm.clone()
    launch("rq_scan_candidates", Qm, Xd, x2, cand, disc, stats, n, nq, dp,
           cdiv(n, tile), tile // LANES, keep, idbits, bf16,
           device=Qm.device)


def _chain_pairs(Qm, Xd, x2, *, tile: int, keep: int, idbits: int) -> int:
    """The (row, query) pairs whose key K8 on bf16 rows takes from the fmaf
    chain (where a row is one d-block: pairs whose tensor-core score lies
    near a key boundary and could enter their buffer). One more launch of
    the kernel, not counted in ``scan_candidates.launches``."""
    if not _check_decoded(Qm, Xd, x2, tile, 0) \
            or Xd.dtype != torch.bfloat16 or keep not in _KEEPS:
        raise ValueError("the chain's pairs are counted on bf16 CUDA "
                         f"operands at keep in {_KEEPS}")
    n, nq = Xd.shape[0], Qm.shape[0]
    _, cand, disc = _alloc_candidates(n, nq, tile, keep, Qm.device)
    stats = torch.zeros(1, dtype=torch.int32, device=Qm.device)
    if nq and n:
        _launch_candidates(Qm, Xd, x2, cand, disc, stats, tile, keep, idbits)
    return int(stats[0])


# K8's bf16 body (`rows_mma_kernel`): queries per CTA, dimensions per
# stage, stages, chain requests of a warp's pass
_RM_QB, _RM_KC, _RM_STAGES, _RM_CAP = 32, 128, 2, 256


def _candidates_layout(dp: int, bf16: int) -> tuple[int, int, int, int]:
    """K8's layout at width ``dp``, as the kernel's source states it
    (`rq_scan_candidates_layout`): ``(queries per CTA, dimensions per
    stage, stages, shared bytes per CTA)``. On bf16 a stage holds 128
    rows of up to 128 dimensions at ``128 + 8`` bf16 (beyond one d-block
    the CTA's queries' block too) and the step's ``x2``; at one d-block
    (dp <= 256) the CTA also keeps its queries whole (``dp + 8`` bf16
    each), the rows' norms and 8 partial sums of each, the queries'
    margins and each of its 8 warps' requests for the fmaf chain (an int
    key and a 16-bit item each). The
    f32 body holds the 4 x 4-blocked tile of one d-block transposed (129
    floats a dimension), the queries of that block and the rows'
    norms."""
    if not bf16:
        db = dp if dp <= 256 else 128
        return 32, db, 1, 4 * (db * (LANES + 1) + 32 * db + LANES)
    wide = dp > 256
    stage = 2 * (LANES + (_RM_QB if wide else 0)) * (_RM_KC + 8) + 4 * LANES
    extra = 0 if wide else (2 * _RM_QB * (dp + 8) + 4 * (9 * LANES + _RM_QB)
                            + 6 * 8 * _RM_CAP)
    return _RM_QB, _RM_KC, _RM_STAGES, _RM_STAGES * stage + extra


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
    `scan_candidates` at every width (on bf16 rows the tensor-core score
    and its keys). On the card a CTA holds 8 lanes for a block of 32
    queries (16 x 16 where 32 queries of a wide f32 row do not fit;
    `_topk_layout`), reads each row once per query block and keeps each
    (lane, query)'s buffer in a thread's registers; where those CTAs do
    not fill the card the row range is split over more and K2 merges the
    splits. The kernel is compiled for ``r=48`` without the pre-min.
    Source: ``rayuela_tpu_torch/csrc/decoded_scan.cu``."""
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
    bf16 = int(Xd.dtype == torch.bfloat16)
    layout = _topk_layout(dp, r, bf16, dev)
    out, cand, disc, nrows, rows_per = _alloc_onepass(n, nq, tile, r, dev,
                                                      layout, dp)
    launch("rq_scan_onepass", Qm, Xd, x2, cand, disc, n, nq, dp, nrows,
           rows_per, layout[0], r, idbits, bf16, device=dev)
    scan_onepass.launches += 1
    return _merge_onepass(out, cand, disc, r)


@functools.lru_cache(maxsize=None)
def _topk_layout(dp: int, r: int, bf16: int,
                 device: torch.device) -> tuple[int, int, int, int, int]:
    """The layout of K8 at keep=0 at width ``dp``: ``(queries per CTA,
    lanes per CTA, CTAs per SM, d-block, shared bytes per CTA)``, as the
    kernel's source states it."""
    return query("rq_scan_onepass_layout", dp, r, bf16, size=5,
                 device=device)


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
# Kernels K9 and K10: the exact-float scan and its counting certificate
# ---------------------------------------------------------------------------

# the id an empty slot carries (its score is +inf)
NOID = IMAX
# buffer depths the pair merge kernel is compiled for
_F32_RS = (16, 32, 48)
# a (score, gid) pair as one int64 whose order is (score, gid): the
# plain versions select on it; this one pads
_PAIR_PAD = (0x7F800000 << 32) | NOID


def _pair_key(v: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``(sortable(v) << 32) | id``; -0.0 counts as 0.0, as a float
    compare does."""
    return (_sortable_key(v + 0.0).long() << 32) | (ids.long() & 0xFFFFFFFF)


def _unpair(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `_pair_key`; a +inf score carries `NOID`."""
    v = _unsortable_key((key >> 32).to(torch.int32))
    ids = (key & 0xFFFFFFFF).to(torch.int32)
    return v, torch.where(v == float("inf"), NOID, ids)


def _tile_pairs(scores, t: int, q0: int, q1: int, tile: int):
    """Tile t's pair keys ``(tile / 128, 128, q1 - q0)`` int64."""
    S = scores(t, q0, q1)
    gid = torch.arange(t * tile, (t + 1) * tile, device=S.device)
    return _pair_key(S, gid[:, None]).reshape(tile // LANES, LANES, -1)


def _f32_candidates_plain(scores, n: int, nq: int, device, *, tile: int,
                          keep: int):
    """Per tile and (lane, query): the ``keep`` smallest (score, gid)
    pairs, ascending → ``candv`` f32, ``candi`` int32, each ``(ntiles *
    keep, 128, nq)``. ``scores`` as `_decoded_scores_fn` gives it."""
    ntiles, candv, candi = _alloc_pairs(n, nq, tile, keep, device)
    for t in range(ntiles):
        for q0 in range(0, nq, _QBLOCK):
            q1 = min(q0 + _QBLOCK, nq)
            top = torch.topk(_tile_pairs(scores, t, q0, q1, tile), keep,
                             dim=0, largest=False, sorted=True).values
            sl = slice(t * keep, (t + 1) * keep)
            candv[sl, :, q0:q1], candi[sl, :, q0:q1] = _unpair(top)
    return candv, candi


def _f32_onepass_plain(scores, n: int, nq: int, device, *, tile: int,
                       r: int):
    """Per (lane, query) over all tiles: the ``r`` smallest (score, gid)
    pairs, ascending → ``outv`` f32, ``outi`` int32, each ``(r, 128,
    nq)``: what the JAX package's f32 kernels emit (no per-tile
    pre-reduction)."""
    outv = torch.empty((r, LANES, nq), dtype=torch.float32, device=device)
    outi = torch.empty_like(outv, dtype=torch.int32)
    for q0 in range(0, nq, _QBLOCK):
        q1 = min(q0 + _QBLOCK, nq)
        buf = torch.full((r, LANES, q1 - q0), _PAIR_PAD, dtype=torch.int64,
                         device=device)
        for t in range(cdiv(n, tile)):
            buf = torch.topk(
                torch.cat([buf, _tile_pairs(scores, t, q0, q1, tile)]), r,
                dim=0, largest=False, sorted=True).values
        outv[:, :, q0:q1], outi[:, :, q0:q1] = _unpair(buf)
    return outv, outi


def _verify_counts_plain(scores, n: int, taus, taui, *, tile: int):
    """Per (lane, query): the rows that come before ``(taus[q],
    taui[q])`` in the order (score, gid), summed over the tiles (row 0)
    and the largest count of one tile (row 1) → ``(2, 128, nq)`` int32."""
    nq = taus.shape[0]
    cnt = torch.zeros((2, LANES, nq), dtype=torch.int32, device=taus.device)
    for t in range(cdiv(n, tile)):
        gid = torch.arange(t * tile, (t + 1) * tile,
                           device=taus.device)[:, None]
        for q0 in range(0, nq, _QBLOCK):
            q1 = min(q0 + _QBLOCK, nq)
            S, ts, ti = scores(t, q0, q1), taus[q0:q1], taui[q0:q1]
            below = (S < ts) | ((S == ts) & (gid < ti))
            c = below.reshape(tile // LANES, LANES, -1).sum(0).int()
            cnt[0, :, q0:q1] += c
            cnt[1, :, q0:q1] = torch.maximum(cnt[1, :, q0:q1], c)
    return cnt


def _alloc_pairs(n: int, nq: int, tile: int, keep: int, device):
    """Outputs of an exact-float candidates kernel → ``(ntiles, candv,
    candi)``."""
    ntiles = cdiv(n, tile)
    candv = torch.empty((ntiles * keep, LANES, nq), dtype=torch.float32,
                        device=device)
    return ntiles, candv, torch.empty_like(candv, dtype=torch.int32)


def _check_f32_plan(n: int, tile: int, keep: int) -> None:
    rows = tile // LANES
    if tile % LANES or rows & (rows - 1) or rows > 256:
        raise ValueError(f"tile/128={tile / LANES} must be a power of two "
                         "<= 256 (a slot remembers its tile step in a byte)")
    if keep < 0 or keep > rows:
        raise ValueError(f"0 <= keep={keep} <= tile/128={rows}")
    if cdiv(n, tile) * tile > IMAX:
        raise ValueError(f"n={n}: global row ids are int32")


def _check_pairs(candv, candi) -> None:
    if candv.dtype != torch.float32 or candi.dtype != torch.int32 \
            or candv.dim() != 3 or candv.shape != candi.shape \
            or candv.shape[1] != LANES or candv.device != candi.device \
            or not (candv.is_contiguous() and candi.is_contiguous()):
        raise ValueError("candv (f32) and candi (int32) must be contiguous "
                         "(rows, 128, nq) tensors of one shape and device")


def _check_tau(taus, taui, nq: int, device) -> None:
    if taus.dtype != torch.float32 or taui.dtype != torch.int32 \
            or taus.shape != (nq,) or taui.shape != (nq,) \
            or taus.device != device or taui.device != device \
            or not (taus.is_contiguous() and taui.is_contiguous()):
        raise ValueError("taus (f32) and taui (int32) must be contiguous "
                         f"({nq},) tensors on {device}")


# K9's and K10's layout constants (`exact_rows_kernel`,
# csrc/decoded_scan.cu): queries and lanes per CTA, queries per thread,
# row ids per group, dimensions per stage, stages in flight
_EX_QB, _EX_LC, _EX_QT, _EX_RG, _EX_KC, _EX_STAGES = 64, 16, 4, 8, 64, 2


def _exact_layout(keep: int, bf16: int) -> tuple[int, ...]:
    """K9's (``keep`` 2 or 4) and K10's (``keep=0``) layout, as the
    kernel's source states it (`rq_exact_layout`): ``(queries per CTA,
    lanes per CTA, queries per thread, row ids per group, dimensions per
    stage, stages, shared bytes per CTA)``. A thread owns one lane and
    its queries; a stage holds a chunk of the group's rows (``row ids x
    lanes`` rows of ``dimensions x operand bytes + 16`` bytes) and of the
    CTA's queries (f32, the same pad). Any width dp takes ``cdiv(dp,
    dimensions per stage)`` stages a group, so the layout depends on
    neither dp nor keep."""
    if keep not in (0,) + _KEEPS:
        raise ValueError(f"keep={keep}: the kernels take 0 (K10) or "
                         f"{_KEEPS}")
    xrow = (2 if bf16 else 4) * _EX_KC + 16
    stage = _EX_RG * _EX_LC * xrow + _EX_QB * (4 * _EX_KC + 16)
    return (_EX_QB, _EX_LC, _EX_QT, _EX_RG, _EX_KC, _EX_STAGES,
            _EX_STAGES * stage)


def _exact_grid(n: int, nq: int, tile: int, layout) -> tuple[int, int, int]:
    """K9's and K10's grid: ``(query blocks, lane blocks, tiles)``."""
    return cdiv(nq, layout[0]), LANES // layout[1], cdiv(n, tile)


def _f32_queries(Qm: torch.Tensor) -> torch.Tensor:
    """K9's and K10's query operand: ``Qm`` in f32 (a bf16 operand
    widened exactly), 16-byte aligned for the kernels' copies."""
    Qf = Qm.float()
    return Qf if Qf.data_ptr() % 16 == 0 else Qf.clone()


def scan_f32_candidates_plain(Qm, Xd, x2, *, tile: int, keep: int):
    """Plain version of `scan_f32_candidates` (same signature and
    outputs)."""
    return _f32_candidates_plain(
        _decoded_scores_fn(Qm, Xd, x2, tile), Xd.shape[0], Qm.shape[0],
        Qm.device, tile=tile, keep=keep)


def scan_f32_candidates(Qm, Xd, x2, *, tile: int, keep: int):
    """Kernel K9, pass 1 of the exact-float scan. For each tile of
    ``tile`` rows and each (lane, query): the ``keep`` smallest (score,
    gid) pairs, ascending, where the score is ``Xd Qm^T + x2`` in f32
    exactly as `scan_candidates` takes it (+inf at and past row n; such
    a slot carries the id `NOID`) → ``candv`` f32 and ``candi`` int32,
    each ``(ntiles * keep, 128, nq)``. Operands as `scan_candidates`.
    On the card a CTA scores 64 queries against 16 lanes of a tile, row
    ids 8 at a time, its rows and queries staged 64 dimensions a stage
    (`_exact_layout`, `_exact_grid`); K10 is the same body. Source:
    ``rayuela_tpu_torch/csrc/decoded_scan.cu``."""
    on_card = _check_decoded(Qm, Xd, x2, tile, 0)
    _check_f32_plan(Xd.shape[0], tile, keep)
    if keep < 1:
        raise ValueError("keep=0 has no candidates pass: `scan_f32_topk`")
    if not on_card:
        return scan_f32_candidates_plain(Qm, Xd, x2, tile=tile, keep=keep)
    if keep not in _KEEPS:
        raise ValueError(f"keep={keep}: the kernel takes {_KEEPS}")
    (n, dp), nq = Xd.shape, Qm.shape[0]
    ntiles, candv, candi = _alloc_pairs(n, nq, tile, keep, Qm.device)
    if nq and n:
        launch("rq_scan_f32_candidates", _f32_queries(Qm), Xd, x2, candv,
               candi, n, nq, dp, ntiles, tile // LANES, keep,
               int(Xd.dtype == torch.bfloat16), device=Qm.device)
        scan_f32_candidates.launches += 1
    return candv, candi


scan_f32_candidates.launches = 0


def pair_merge_plain(candv, candi, r: int):
    """Plain version of `pair_merge` (same signature and outputs)."""
    ncand, _, nq = candv.shape
    outv = torch.empty((r, LANES, nq), dtype=torch.float32,
                       device=candv.device)
    outi = torch.empty_like(outv, dtype=torch.int32)
    for q0 in range(0, nq, _QBLOCK):
        key = _pair_key(candv[:, :, q0:q0 + _QBLOCK],
                        candi[:, :, q0:q0 + _QBLOCK])
        if ncand < r:
            key = torch.cat([key, torch.full(
                (r - ncand,) + key.shape[1:], _PAIR_PAD, dtype=torch.int64,
                device=key.device)])
        top = torch.topk(key, r, dim=0, largest=False, sorted=True).values
        outv[:, :, q0:q0 + _QBLOCK], outi[:, :, q0:q0 + _QBLOCK] = _unpair(top)
    return outv, outi


def pair_merge(candv, candi, r: int):
    """Pass 2 of the exact-float scans (K9 and K6). Per (lane, query):
    the ``r`` smallest (score, gid) pairs of ``candv``/``candi (ncand,
    128, nq)``, ascending → ``outv`` f32, ``outi`` int32, each ``(r, 128,
    nq)``, the buffers the TPU kernels carry across their tile axis. A
    +inf score carries `NOID`. Source:
    ``rayuela_tpu_torch/csrc/codes_scan.cu``."""
    _check_pairs(candv, candi)
    if candv.device.type == "cpu":
        return pair_merge_plain(candv, candi, r)
    if candv.device.type != "cuda":
        raise ValueError(f"unsupported device {candv.device}")
    if r not in _F32_RS:
        raise ValueError(f"r={r}: the kernel takes {_F32_RS}")
    nq = candv.shape[2]
    outv = torch.empty((r, LANES, nq), dtype=torch.float32,
                       device=candv.device)
    outi = torch.empty_like(outv, dtype=torch.int32)
    if nq:
        launch("rq_pair_merge", candv, candi, outv, outi, candv.shape[0], nq,
               r, device=candv.device)
        pair_merge.launches += 1
    return outv, outi


pair_merge.launches = 0


def _f32_topk_plain(scores, n: int, nq: int, device, *, r: int, tile: int,
                    keep: int):
    """Per (lane, query) the ``r`` smallest (score, gid) pairs → ``(outv,
    outi)``: the one-pass form without ``keep`` (or when it cuts
    nothing), else the per-tile cut and the merge."""
    if not keep or keep >= tile // LANES:
        return _f32_onepass_plain(scores, n, nq, device, tile=tile, r=r)
    return pair_merge_plain(*_f32_candidates_plain(
        scores, n, nq, device, tile=tile, keep=keep), r)


def scan_f32_topk_plain(Qm, Xd, x2, *, r: int, tile: int, keep: int):
    """Plain version of `scan_f32_topk` (same signature and outputs)."""
    return _f32_topk_plain(_decoded_scores_fn(Qm, Xd, x2, tile), Xd.shape[0],
                           Qm.shape[0], Qm.device, r=r, tile=tile, keep=keep)


def scan_f32_topk(Qm, Xd, x2, *, r: int, tile: int, keep: int):
    """Kernel K9 whole: per (lane, query) the ``r`` smallest (score,
    gid) pairs over the base, ascending → ``outv (r, 128, nq)`` f32,
    ``outi (r, 128, nq)`` int32 global ids. With ``keep`` each tile is
    first cut to its ``keep`` smallest per lane (`scan_f32_candidates`,
    then `pair_merge`); ``keep=0`` is the JAX package's form without
    that cut, which has a plain version only: on the card the running
    buffer of the TPU kernel has no counterpart, and a CUDA tensor with
    ``keep=0`` raises."""
    on_card = _check_decoded(Qm, Xd, x2, tile, 0)
    _check_f32_plan(Xd.shape[0], tile, keep)
    if not on_card:
        return scan_f32_topk_plain(Qm, Xd, x2, r=r, tile=tile, keep=keep)
    if keep not in _KEEPS:
        raise ValueError(f"keep={keep}: the kernels take keep in {_KEEPS}")
    return pair_merge(*scan_f32_candidates(Qm, Xd, x2, tile=tile, keep=keep),
                      r)


def verify_counts_plain(Qm, Xd, x2, taus, taui, *, tile: int):
    """Plain version of `verify_counts` (same signature and outputs)."""
    return _verify_counts_plain(_decoded_scores_fn(Qm, Xd, x2, tile),
                                Xd.shape[0], taus, taui, tile=tile)


def verify_counts(Qm, Xd, x2, taus, taui, *, tile: int):
    """Kernel K10, the counting certificate of the exact-float scan. Per
    (lane, query): how many rows come strictly before the query's
    boundary pair ``(taus[q], taui[q])`` in the order (score, gid),
    summed over the tiles (row 0) and the largest count of one tile
    (row 1) → ``(2, 128, nq)`` int32. The scores are K9's, bit for bit.

    The JAX package counts the scores strictly below the k-th score;
    counting in the total order also counts the rows that tie with the
    k-th score at a lower id, which are top-k members themselves, so an
    unflagged result is the exact top-k by (score, id) and not only by
    score. A boundary score of -inf counts nothing. Source:
    ``rayuela_tpu_torch/csrc/decoded_scan.cu``."""
    on_card = _check_decoded(Qm, Xd, x2, tile, 0)
    _check_f32_plan(Xd.shape[0], tile, 0)
    _check_tau(taus, taui, Qm.shape[0], Qm.device)
    if not on_card:
        return verify_counts_plain(Qm, Xd, x2, taus, taui, tile=tile)
    (n, dp), nq = Xd.shape, Qm.shape[0]
    cnt = torch.zeros((2, LANES, nq), dtype=torch.int32, device=Qm.device)
    if nq and n:
        launch("rq_scan_verify_counts", _f32_queries(Qm), Xd, x2, taus,
               taui, cnt, n, nq, dp, cdiv(n, tile), tile // LANES,
               int(Xd.dtype == torch.bfloat16), device=Qm.device)
        verify_counts.launches += 1
    return cnt


verify_counts.launches = 0


def candidate_ids(outi: torch.Tensor, nq: int, r: int) -> torch.Tensor:
    """The id buffer ``(r, 128, nq)`` of global ids → the ``(nq, r *
    128)`` candidate matrix."""
    return outi[:, :, :nq].reshape(r * LANES, nq).T


def _finish_f32(outv, outi, k: int, r: int, keep: int, count):
    """Per-lane pair buffers → ``(scores (nq, k), ids (nq, k) int32,
    flagged (nq,))``: the top-k of the ``r * 128`` candidates by (score,
    id), then ``count(taus, taui)`` (K10 or K7) at the k-th pair. A
    query is flagged when a lane holds more than ``r`` rows before its
    boundary, or, with ``keep``, one tile of a lane more than ``keep``."""
    nq = outv.shape[2]
    s, i = topk_lowest_id(outv.reshape(r * LANES, nq).T, k,
                          candidate_ids(outi, nq, r))
    i = i.to(torch.int32)
    cnt = count(s[:, k - 1].contiguous(), i[:, k - 1].contiguous())
    flagged = (cnt[0] > r).any(0)
    if keep:
        flagged |= (cnt[1] > keep).any(0)
    return s, i, flagged


def _check_f32_topk(k: int, r: int, keep: int) -> None:
    if k > r * LANES:
        raise ValueError(f"k={k} > r*128={r * LANES}")
    if keep and keep & (keep - 1):
        raise ValueError(f"keep={keep} must be 0 or a power of two")


def scan_topk_f32(Q, Xd, x2, *, k: int, r: int = 48, tile: int = 2048,
                  keep: int = 0):
    """Exact-unless-flagged top-k of the untruncated f32 scores over a
    decoded base (K9 → `torch.topk` over the candidates → K10): the
    counterpart of the JAX package's ``pallas_scan_topk(pack=False)`` →
    ``(scores (nq, k) f32 without +|q|^2, ids (nq, k) int32, flagged
    (nq,) bool)``, ascending by (score, id).

    ``r`` and ``tile`` default as in the JAX package. ``keep`` cuts each
    tile to its ``keep`` smallest pairs per lane first (the card's
    kernels need it: 2 or 4); the certificate then also holds a lane's
    per-tile count against ``keep``. ``keep=0`` is the JAX form, on CPU
    tensors only."""
    n = Xd.shape[0]
    _check_f32_topk(k, r, keep)
    Qm = _query_operand(Q.to(torch.float32), Xd.shape[1], Xd.dtype)
    x2 = x2.to(torch.float32).contiguous()
    outv, outi = scan_f32_topk(Qm, Xd, x2, r=r, tile=tile, keep=keep)
    return _finish_f32(
        outv, outi, min(k, n), r, keep,
        lambda ts, ti: verify_counts(Qm, Xd, x2, ts, ti, tile=tile))


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


def _f32_config(k: int, device) -> tuple[int, int, int, int]:
    """Plan of the exact-float scans → ``(r, keep, tile, deepest k)``.
    CPU tensors take the JAX package's f32 plan (no per-tile cut, tile
    2048). The card's kernels need the cut, and the flag statistics of
    ``(k, r, keep, tile)`` do not depend on the key, so they take the
    packed plan's classes (`_scan_config`) as far as the pair merge
    kernel's deepest buffer."""
    if torch.device(device).type == "cuda":
        kmax = 3072
        return (*_scan_config(min(k, kmax)), kmax)
    return (16 if k <= 512 else 48), 0, 2048, 48 * LANES


def _f32_bytes_per_query(n: int, r: int, tile: int, keep: int) -> int:
    """Bytes of one query's largest array in an exact-float scan: a
    (score, id) pair per candidate, or with ``keep=0`` the per-lane
    buffers and the tile being merged into them."""
    return (cdiv(n, tile) * keep or r + tile // LANES) * LANES * 8


def merge_topk(best, new, k: int):
    """Merge two top-k results ``(scores, ids)`` of disjoint row ranges
    → the ``k`` smallest by (score, id)."""
    if best is None:
        return new
    cs, ci = torch.cat([best[0], new[0]], 1), torch.cat([best[1], new[1]], 1)
    v, i = topk_lowest_id(cs, min(k, cs.shape[1]), ci)
    return v, i.to(torch.int32)


def _scan_segments(Q, Xd, x2, *, k: int, r: int, tile: int, keep: int):
    """A base beyond the packed row-id range: the scan per
    `_SEG_DECODED`-row segment with an exact merge on the device; the
    segments' flags are OR-ed."""
    best = flagged = None
    for st in range(0, Xd.shape[0], _SEG_DECODED):
        Xs, x2s = Xd[st:st + _SEG_DECODED], x2[st:st + _SEG_DECODED]
        dv, iv, fl = scan_topk_packed(Q, Xs, x2s, k=min(k, Xs.shape[0]),
                                      r=r, tile=tile, keep=keep)
        best = merge_topk(best, (dv, iv + st), k)
        flagged = fl if flagged is None else flagged | fl
    return (*best, flagged)


def search(index: LinscanIndex, Q, k: int, *, r: int | None = None,
           tile: int | None = None, keep: int | None = None,
           pack: bool | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k search over a decoded index → ``(dists (nq, k) f32
    with +|q|^2, ids (nq, k) int32)``: the kernel scan, then
    `exact_rescan` for every query its certificate flags.

    ``pack=None`` (or True) is the packed scan: the exact top-k of the
    truncated scores. ``pack=False`` is the exact-float scan
    (`scan_topk_f32`): the exact top-k of the f32 scores, the lowest id
    among equal ones; it wants no segments (its ids are 32 bits wide),
    and an index built with ``dtype=torch.float32`` is what it is meant
    for (a bfloat16 one is allowed: the scores accumulate in f32 either
    way).

    ``r``/``tile``/``keep`` default to the plan of the k class
    (`_scan_config`, `_f32_config`). Beyond the plan's deepest k the
    search is `exact_rescan` alone. A query batch whose candidate array
    would pass `_CAND_CAP` bytes runs in chunks."""
    from rayuela_tpu_torch.search.linscan import exact_rescan

    Xd, x2 = index.Xd, index.x2
    Q = torch.as_tensor(Q, dtype=torch.float32, device=Xd.device)
    Q = torch.nn.functional.pad(Q, (0, Xd.shape[1] - Q.shape[1]))
    k = min(k, index.n)       # never return padded (inf, fake-id) rows
    f32 = pack is not None and not pack
    if f32:
        ar, akeep, atile, kmax = _f32_config(k, Xd.device)
    else:
        ar, akeep, atile = _scan_config(min(k, _MAX_K))
        kmax = _MAX_K
    if r is None and k > kmax:
        return exact_rescan(Q, Xd, x2, k)
    if r is None and keep is None and tile is None and akeep \
            and k > cdiv(index.n, atile) * akeep * LANES:
        # the tiles keep fewer than k candidates (k most of a small base)
        return exact_rescan(Q, Xd, x2, k)
    r = ar if r is None else r
    keep = akeep if keep is None else keep
    tile = atile if tile is None else tile
    q2 = (Q * Q).sum(-1, keepdim=True)
    if f32:
        scan = scan_topk_f32
        per_query = _f32_bytes_per_query(index.n, r, tile, keep)
    else:
        segmented = cdiv(index.n, tile) * tile > _SEG_DECODED
        scan = _scan_segments if segmented else scan_topk_packed
        per_query = (cdiv(min(index.n, _SEG_DECODED), tile) * max(keep, 1)
                     * LANES * 4)
    parts = [scan(Q[a:b], Xd, x2, k=k, r=r, tile=tile, keep=keep)
             for a, b in _query_chunks(Q.shape[0], per_query)]
    s, i, flagged = (torch.cat(p) for p in zip(*parts))
    s = s + q2
    if bool(flagged.any()):
        qidx = torch.nonzero(flagged).flatten()
        s[qidx], i[qidx] = exact_rescan(Q[qidx], Xd, x2, k)
    return s, i


def search_streamed(C, B, Q, k: int, *, pq: bool = False,
                    d: int | None = None, norm_term=None,
                    shard_size: int = 1 << 20, **kw
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Search a base too large to keep decoded on the device: the codes
    ``B (n, m)`` (and ``norm_term (n,)``) stay in host memory, a numpy
    array or a CPU tensor, and go through the device shard by shard,
    ``shard_size`` rows at a time: each shard is decoded
    (`build_index`), searched (`search`; ``kw`` goes there, so
    ``pack=False`` works) and released, and the shards' top-k lists
    merge exactly on the device, by (score, id). ``C`` and ``Q`` stay
    on their device when they are tensors and go to the card otherwise."""
    C = as_tensor(C)
    dev = C.device
    Q = as_tensor(Q, dev)
    n = B.shape[0]
    d = Q.shape[1] if d is None else d
    best = None
    for start in range(0, n, shard_size):
        stop = min(start + shard_size, n)
        nt = None if norm_term is None else as_tensor(norm_term[start:stop],
                                                      dev)
        idx = build_index(C, as_tensor(B[start:stop], dev, torch.int32),
                          pq=pq, d=d, norm_term=nt)
        dv, di = search(idx, Q, min(k, stop - start), **kw)
        best = merge_topk(best, (dv, di + start), k)
        del idx
    return best
