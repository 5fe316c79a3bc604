"""Code-resident search: scan packed uint8 codes, never a decoded base
(counterpart of `rayuela_tpu/search/scan_codes_pallas.py`).

The index on the card is the packed codes (m bytes per vector, plus one
norms byte for additive models). A search runs in two passes:

* K1 `codes_decode_candidates`: each tile of rows is decoded once from
  its codes and scored against every query; per (lane, query) the tile
  keeps its ``keep`` smallest packed keys and the minimum of the rest.
  In LUT mode K5 `codes_lut_candidates` takes its place: a row's score
  is the sum of its codes' entries in per-query tables (`build_luts`).
* K2 `cand_merge`: per (lane, query) the r smallest candidates, plus a
  certificate row, the smallest key the scan threw away.
* K3 `scan.tail_merge`: the 128 per-lane lists merge into the query's
  top-k.

A query whose certificate beats its k-th key may have lost a true
top-k member; it re-runs through K4 `codes_decode_topk`, a one-pass
scan with a deep per-lane buffer (where that is deeper than the
plan's), and when K4 flags it again, through the plain LUT oracle
`lut_scan`. The result is the exact top-k of the
truncated kernel scores, certified per query.

``search_codes(twopass=False)`` (or with ``stage=``, or an explicit
``r``/``keep``/``tile``/``bq``, as the JAX package routes them) takes
the one-pass scan with a per-tile cut instead of K1 → K2: K14
`codes_decode_onepass` computes K1 → K2's function at the one-pass
plan's ``(r, keep, tile)`` (`_onepass_config`) in one pass, with no
candidate array in device memory, then K3 and the same rescue.

``search_codes(mode="lut", pack=False)`` is the exact-float LUT scan
(see `scan`): K6 `codes_lut_f32_candidates` → `scan.pair_merge` →
`torch.topk` over the candidates → K7 `codes_verify_counts`; its result
is the exact top-k of the f32 table sums, the lowest id among equal
ones. `search_codes_streamed` serves a base whose packed codes stay in
host memory.

Every kernel wrapper takes its plain PyTorch version for CPU tensors
only; for CUDA tensors it launches the kernel or raises. The TPU kernels
they replace, in `rayuela_tpu/search/scan_codes_pallas.py` (definition,
launch): K1 ``_codes_decode_kernel_candidates`` (:384, :727), K2
``_cand_merge_kernel`` (:424, :761), K4 and K14
``_codes_decode_kernel_packed`` (:318) at keep = 0 and keep > 0, with
``_codes_decode_kernel_packed_multi`` (:332) and ``_staged`` (:365) for
K14 (launched at :613), K5 ``_codes_scan_kernel_packed`` (:220, :866),
K6 ``_codes_scan_kernel`` (:179, :898), K7 ``_codes_verify_kernel``
(:232, :932). On the card K1, K4 and K14 score bf16 operands on the
tensor cores with one score function, so their keys agree (f32 operands
in fmaf chains); where a row is one d-block (dp <= 256) that function
keeps the fmaf chain's key, scoring again by the chain the pairs whose
tensor-core score lies near a key boundary. K1 and K14 share each
decoded group of rows over a cluster of query blocks, on either operand
type (bf16: bound by the latency of a step, its L2 gathers, the stores
to the cluster, the cluster barrier; f32: by its fmaf chains, 64 a
thread), K5–K7 (one body with three sinks) by their table reads from
shared memory, K2 by reading its candidates (the kernels' headers in
``csrc/`` say more).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rayuela_tpu_torch.kernels.build import launch, query
from rayuela_tpu_torch.search import scan
from rayuela_tpu_torch.search.scan import (  # noqa: F401 (re-exported)
    _KEEPS, LANES, _alloc_candidates, _alloc_onepass,
    _candidates_plain, _finish, _merge_onepass, _onepass_plain,
    _pack_idbits, _query_operand, _row_key, cand_merge, cand_merge_plain)
from rayuela_tpu_torch.utils import (as_tensor, cdiv, exact_f32, splitarray,
                                     tiled_topk, topk_lowest_id)

# row ids are 16 bits wide, so one scan call covers this many rows;
# larger bases run in segments with an exact merge
_DECODE_SEG = (1 << 16) * LANES

# rescue kernel shape: one-pass scan, keep=0, a 48-deep per-lane buffer
# (K4 is compiled for this depth alone, at 32 and 16 queries a CTA)
_RESCUE_R, _RESCUE_TILE = scan._ONEPASS_R, 2048

# K14's compiled (r, keep) pairs: the one-pass plan's (`_onepass_config`)
_ONEPASS_CUTS = ((14, 2), (12, 4), (28, 4))
# the most CTAs K14's splits may give its grid, unless the query blocks
# alone are more (each CTA holds its own scratch: at r = 28 ~0.9 GB of the
# bf16 body's, ~0.4 GB of the f32 body's). On an NVIDIA H100 80GB HBM3
# that is 8 waves of the bf16 body's 30 cluster slots of 8 CTAs and 16 of
# the f32 body's 15: the f32 body's 80 clusters at nq = 1e4 then take 3
# splits, 16 whole waves, where 8 waves left them unsplit in 5.3 (115 ->
# 105 ms at 700 W, PERF.md §6)
_ONEPASS_CTAS = 1920

# tile of the two-pass scans (K1 and K5)
_TILE = 8192


# ---------------------------------------------------------------------------
# Index build: packed codes, LUTs, decode operands
# ---------------------------------------------------------------------------

def pack_codes(B: torch.Tensor,
               norms_codes: torch.Tensor | None = None) -> torch.Tensor:
    """Pack codes into int32 words, 4 codes per word, little-endian
    bytes → ``(n, ceil(m'/4)) int32``, where m' counts the optional
    norms byte (last). All codes must be < 256."""
    B = torch.as_tensor(B)
    if norms_codes is not None:
        B = torch.cat([B, torch.as_tensor(norms_codes, device=B.device)
                       .reshape(-1, 1).to(B.dtype)], dim=1)
    n, mprime = B.shape
    nw = cdiv(mprime, 4)
    Bp = torch.nn.functional.pad(B.long(), (0, nw * 4 - mprime))
    w = Bp.reshape(n, nw, 4)
    packed = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) \
        | (w[..., 3] << 24)
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
    return packed.to(torch.int32).contiguous()


def unpack_codes(packed: torch.Tensor, mprime: int) -> torch.Tensor:
    """Inverse of `pack_codes` → ``(n, m') int32``."""
    u = packed.long() & 0xFFFFFFFF
    cols = [(u[:, j // 4] >> (8 * (j % 4))) & 0xFF for j in range(mprime)]
    return torch.stack(cols, dim=1).to(torch.int32)


def build_luts(C: torch.Tensor, Q: torch.Tensor, *, pq: bool = False,
               d: int | None = None,
               norms_cbook: torch.Tensor | None = None) -> torch.Tensor:
    """Per-query LUT stack ``T (m', h, nq) f32``: PQ
    ``|C_j[c]|^2 - 2 C_j[c].q_sub_j``; additive ``-2 C_j[c].q`` plus,
    with ``norms_cbook`` (h' <= h,), the norms table the extra byte
    indexes. Scores exclude ``+|q|^2``."""
    exact_f32()
    m, h, ds = C.shape
    nq = Q.shape[0]
    if pq:
        d = Q.shape[1] if d is None else d
        tabs = []
        for j, (st, sz) in enumerate(splitarray(d, m)):
            Qs = torch.nn.functional.pad(Q[:, st:st + sz], (0, ds - sz))
            c2 = (C[j] * C[j]).sum(-1, keepdim=True)
            tabs.append(c2 - 2.0 * (C[j] @ Qs.T))
        T = torch.stack(tabs)
    else:
        T = -2.0 * torch.einsum("mhd,qd->mhq", C, Q)
    if norms_cbook is not None:
        nc = norms_cbook.reshape(-1)
        if nc.numel() > h:
            raise ValueError(
                f"norms codebook ({nc.numel()} entries) must fit the "
                f"(h={h})-row table stack; train it with h' <= h")
        nt = torch.nn.functional.pad(nc, (0, h - nc.numel()))
        T = torch.cat([T, nt[None, :, None].expand(1, h, nq)], dim=0)
    return T


def build_decode_operands(C: torch.Tensor, *, pq: bool, d: int,
                          norms_cbook: torch.Tensor | None = None,
                          op_dtype=torch.float32
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Codebooks flattened for the decode kernels: ``Cflat (m*h, dp)``
    at the operand dtype, dp = d rounded up to 128 (block-diagonal
    subspace placement for PQ), and the norms table tiled to
    ``(h, 128)`` (zeros when unused)."""
    m, h, ds = C.shape
    dp = cdiv(d, LANES) * LANES
    if pq:
        Cf = torch.zeros(m * h, dp, dtype=torch.float32, device=C.device)
        for j, (st, sz) in enumerate(splitarray(d, m)):
            Cf[j * h:(j + 1) * h, st:st + sz] = C[j][:, :sz]
    else:
        Cf = torch.nn.functional.pad(C.reshape(m * h, ds), (0, dp - ds))
    if norms_cbook is None:
        nrm = torch.zeros(h, LANES, dtype=torch.float32, device=C.device)
    else:
        nc = norms_cbook.reshape(-1)
        nrm = torch.nn.functional.pad(nc, (0, h - nc.numel()))[:, None]
        nrm = nrm.expand(h, LANES)
    return (Cf.to(op_dtype).contiguous(), nrm.to(op_dtype).contiguous())


class CodesIndex:
    """Scan-ready packed-code index, ~m bytes per vector on the device.
    Build once with `build_codes_index`, search many times."""

    def __init__(self, packed: torch.Tensor, mprime: int, C: torch.Tensor,
                 *, pq: bool, d: int, norms_cbook: torch.Tensor | None):
        self.packed, self.mprime, self.C = packed, mprime, C
        self.pq, self.d, self.norms_cbook = pq, d, norms_cbook
        self.n = packed.shape[0]
        self._decode_ops: dict = {}
        self._segments: dict = {}      # sub-indexes of a segmented base

    def swap_packed(self, packed: torch.Tensor) -> None:
        """Serve another shard of codes from this index (the streamed
        search): the operand cache stays, the old buffer is released."""
        self.packed, self.n = packed, packed.shape[0]
        self._segments.clear()      # they hold slices of the old buffer

    def decode_operands(self, d: int, op_dtype):
        """Cached `build_decode_operands` (they depend only on C, d and
        the dtype)."""
        key = (d, op_dtype)
        if key not in self._decode_ops:
            self._decode_ops[key] = build_decode_operands(
                self.C, pq=self.pq, d=d, norms_cbook=self.norms_cbook,
                op_dtype=op_dtype)
        return self._decode_ops[key]


def build_codes_index(C: torch.Tensor, B: torch.Tensor, *,
                      pq: bool = False, d: int | None = None,
                      norms_cbook: torch.Tensor | None = None,
                      norms_codes: torch.Tensor | None = None
                      ) -> CodesIndex:
    if (norms_cbook is None) != (norms_codes is None):
        raise ValueError("norms_cbook and norms_codes go together")
    if not pq and norms_cbook is None:
        raise ValueError("additive codebooks need a quantized-norms byte "
                         "for the code-resident scan; train one with "
                         "rayuela_tpu_torch.search.norms")
    packed = pack_codes(B.to(torch.int32), norms_codes)
    mprime = B.shape[1] + (0 if norms_codes is None else 1)
    return CodesIndex(packed, mprime, C, pq=pq,
                      d=d if d is not None else -1, norms_cbook=norms_cbook)


# ---------------------------------------------------------------------------
# Plain LUT oracle
# ---------------------------------------------------------------------------

def _lut_sums(T: torch.Tensor, B: torch.Tensor, lut_dtype) -> torch.Tensor:
    """``sum_j T_j[code_j]`` → ``(nq, n)`` f32: the table values rounded
    to ``lut_dtype``, added in f32 in codebook order, the norms table
    last, as the kernels take them."""
    mprime, h, nq = T.shape
    flat = T.to(lut_dtype).float().permute(2, 0, 1).reshape(nq, mprime * h)
    idx = (B.long() + torch.arange(mprime, device=B.device)[None, :] * h)
    s = flat.index_select(1, idx[:, 0])
    for j in range(1, mprime):
        s = s + flat.index_select(1, idx[:, j])
    return s


def lut_scan(T: torch.Tensor, B: torch.Tensor, k: int,
             lut_dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-accumulate LUT scan (`_lut_sums`) with exact top-k, the
    lowest id among equal scores: the oracle of the tests. Scores
    exclude ``+|q|^2``."""
    v, i = topk_lowest_id(_lut_sums(T, B, lut_dtype), min(k, B.shape[0]))
    return v, i.to(torch.int32)


def _lut_scan_tiled(index: CodesIndex, Q: torch.Tensor, k: int, d: int,
                    lut_dtype, qblock: int = 128,
                    seg: int = 1 << 19) -> tuple[torch.Tensor, torch.Tensor]:
    """`lut_scan` over the whole base, tiled over query blocks and base
    segments with an exact merge (`utils.tiled_topk`), so the (qblock,
    seg) score block stays bounded: the fallback for queries a
    certificate flags and for a k beyond the kernels' plan. Scores
    exclude ``+|q|^2``."""
    block: dict = {}

    def score_tile(q0, q1, st, stop):
        if block.get("q") != (q0, q1):      # one table build per block
            block.update(q=(q0, q1), T=build_luts(
                index.C, Q[q0:q1], pq=index.pq, d=d,
                norms_cbook=index.norms_cbook))
        return _lut_sums(block["T"], unpack_codes(index.packed[st:stop],
                                                  index.mprime), lut_dtype)

    return tiled_topk(Q.shape[0], index.n, seg, min(k, index.n), score_tile,
                      qblock)


# ---------------------------------------------------------------------------
# Kernels K1, K2, K4 and their plain versions
# ---------------------------------------------------------------------------

def _check_operands(Qm, Cflat, nrm, packed, has_norms: bool) -> bool:
    """Validate the decode-scan operands; True when they lie on a CUDA
    device (launch the kernel), False on the CPU (plain version)."""
    dev = Qm.device
    if any(t.device != dev for t in (Cflat, nrm, packed)):
        raise ValueError("operands must share one device")
    if Qm.dtype not in (torch.float32, torch.bfloat16) \
            or Cflat.dtype != Qm.dtype or nrm.dtype != Qm.dtype:
        raise ValueError("Qm, Cflat, nrm must share a float32 or bfloat16 "
                         "dtype")
    if packed.dtype != torch.int32:
        raise ValueError("packed codes must be int32")
    if not all(t.is_contiguous() for t in (Qm, Cflat, nrm, packed)):
        raise ValueError("operands must be contiguous")
    h = nrm.shape[0]
    if nrm.dim() != 2 or nrm.shape[1] != LANES or Cflat.shape[0] % h \
            or Qm.shape[1] != Cflat.shape[1]:
        raise ValueError(f"inconsistent shapes Qm {tuple(Qm.shape)}, "
                         f"Cflat {tuple(Cflat.shape)}, "
                         f"nrm {tuple(nrm.shape)}")
    m = Cflat.shape[0] // h
    if packed.dim() != 2 or packed.shape[1] != cdiv(m + has_norms, 4):
        raise ValueError(f"packed width {packed.shape[1]} inconsistent "
                         f"with m={m}, has_norms={has_norms}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if Cflat.shape[1] % LANES:
        raise ValueError(f"dp={Cflat.shape[1]} must be a multiple of 128")
    if Cflat.data_ptr() % 16:
        raise ValueError("Cflat must be 16-byte aligned: the kernels read "
                         "it 16 bytes at a time")
    if Qm.data_ptr() % 16:
        raise ValueError("Qm must be 16-byte aligned: the kernels read it "
                         "16 bytes at a time")
    if Qm.shape[0] >= 1 << 21:
        raise ValueError("at most 2**21 queries per call")
    return True


def _decode_x2(Cflat, nrm, packed_rows, m: int, has_norms: bool):
    """Decode rows: ``(X (rows, dp) f32 holding op-dtype values,
    x2 (rows,) f32)``, summed in codebook order as the kernels do."""
    h = nrm.shape[0]
    codes = unpack_codes(packed_rows, m + has_norms).long()
    acc = torch.zeros(packed_rows.shape[0], Cflat.shape[1],
                      dtype=torch.float32, device=Cflat.device)
    for j in range(m):
        acc = acc + Cflat.index_select(0, codes[:, j] + j * h).float()
    x2 = (nrm[codes[:, m], 0].float() if has_norms
          else (acc * acc).sum(1))
    return acc.to(Cflat.dtype).float(), x2


def _decode_keys_fn(Qm, Cflat, nrm, packed, tile: int, has_norms: bool,
                    idbits: int):
    """`keys_fn` of the plain selections (`scan._candidates_plain`) for
    rows decoded from their codes: scores ``X Qm^T + x2`` in f32, +inf at
    and past row n."""
    exact_f32()
    n, rows = packed.shape[0], tile // LANES
    m = Cflat.shape[0] // nrm.shape[0]
    Qf = Qm.float()

    def keys(t, q0, q1):
        g0 = t * tile
        X, x2 = _decode_x2(Cflat, nrm, packed[g0:g0 + tile], m, has_norms)
        S = torch.full((tile, q1 - q0), float("inf"), dtype=torch.float32,
                       device=Qm.device)
        nv = max(0, min(tile, n - g0))
        S[:nv] = X @ Qf[q0:q1].T + x2[:, None]
        return _row_key(S, t, rows=rows, idbits=idbits)
    return keys


def codes_decode_candidates_plain(Qm, Cflat, nrm, packed, *, tile: int,
                                  keep: int, idbits: int,
                                  has_norms: bool):
    """Plain version of `codes_decode_candidates` (same signature and
    outputs)."""
    return _candidates_plain(
        _decode_keys_fn(Qm, Cflat, nrm, packed, tile, has_norms, idbits),
        packed.shape[0], Qm.shape[0], Qm.device, tile=tile, keep=keep)


def codes_decode_candidates(Qm, Cflat, nrm, packed, *, tile: int,
                            keep: int, idbits: int, has_norms: bool):
    """Kernel K1, pass 1 of the scan. For each tile of ``tile`` rows and
    each (lane, query): the ``keep`` smallest packed keys, ascending,
    and the smallest of the tile's other keys (INT32_MAX when none).

    ``Qm (nq, dp)`` is ``-2 Q`` at the operand dtype, ``Cflat
    (m*h, dp)`` and ``nrm (h, 128)`` come from `build_decode_operands`,
    ``packed (n, nw)`` from `pack_codes`. Returns ``cand
    (ntiles*keep, 128, nq)`` and ``disc (ntiles, 128, nq)`` int32.
    On the card a cluster of CTAs on neighbouring query blocks shares
    each decoded group of rows (`_candidates_layout`, from the kernel's
    source); bf16 operands score on the tensor cores, f32 operands in
    fmaf chains (a CTA of 128 queries x 16 lanes, each thread 8 row ids
    x 8 queries of its lane). Source:
    ``rayuela_tpu_torch/csrc/codes_scan.cu``."""
    if tile % LANES or keep < 1 or keep > tile // LANES:
        raise ValueError(f"tile={tile} must be a multiple of 128 and "
                         f"1 <= keep={keep} <= tile/128")
    if not _check_operands(Qm, Cflat, nrm, packed, has_norms):
        return codes_decode_candidates_plain(
            Qm, Cflat, nrm, packed, tile=tile, keep=keep, idbits=idbits,
            has_norms=has_norms)
    if keep not in _KEEPS:
        raise ValueError(f"keep={keep}: the kernel takes {_KEEPS}")
    n, nw = packed.shape
    (nq, dp), h = Qm.shape, nrm.shape[0]
    bf16 = int(Qm.dtype == torch.bfloat16)
    ntiles, cand, disc = _alloc_candidates(n, nq, tile, keep, Qm.device)
    if nq and n:
        launch("rq_codes_decode_candidates", Qm, Cflat, nrm, packed, cand,
               disc, n, nq, dp, Cflat.shape[0] // h, h, nw, int(has_norms),
               ntiles, tile // LANES, keep, idbits, bf16, device=Qm.device)
        codes_decode_candidates.launches += 1
        codes_decode_candidates.launches_f32 += not bf16
    return cand, disc


# launches, and of those the f32 instance's
codes_decode_candidates.launches = 0
codes_decode_candidates.launches_f32 = 0


@functools.lru_cache(maxsize=None)
def _candidates_layout(keep: int, dp: int, nw: int, bf16: int,
                       device: torch.device) -> tuple[int, ...]:
    """K1's layout at width ``dp`` with ``nw`` packed words a row, as the
    kernel's source states it: ``(queries per CTA, scratch ints per CTA
    (0), CTAs per SM, d-block, shared bytes per CTA, CTAs per cluster,
    clusters the card holds at once, step buffers, lanes per CTA)``."""
    return query("rq_codes_candidates_layout", keep, dp, nw, bf16, size=9,
                 device=device)


def codes_decode_topk_plain(Qm, Cflat, nrm, packed, *, tile: int, r: int,
                            idbits: int, has_norms: bool):
    """Plain version of `codes_decode_topk` (same signature and
    outputs)."""
    return _onepass_plain(
        _decode_keys_fn(Qm, Cflat, nrm, packed, tile, has_norms, idbits),
        packed.shape[0], Qm.shape[0], Qm.device, tile=tile, r=r)


def codes_decode_topk(Qm, Cflat, nrm, packed, *, tile: int, r: int,
                      idbits: int, has_norms: bool):
    """Kernel K4, the one-pass scan the rescue runs. Per (lane, query)
    over the whole base (padded to a multiple of ``tile`` rows): the
    ``r`` smallest packed keys, ascending, then the (r+1)-th smallest,
    the certificate → ``(r + 1, 128, nq)`` int32. Scores exactly as K1.
    On the card a CTA holds 8 lanes for a block of 32 queries (16 x 16
    where 32 queries of a wide f32 row do not fit; `_rescue_layout`,
    from the kernel's source), decodes each row once per query block and
    keeps each (lane, query)'s 48-deep buffer in a thread's registers;
    where those CTAs do not fill the card the row range is split over
    more and K2 merges the splits (`scan._alloc_onepass`). Source:
    ``rayuela_tpu_torch/csrc/codes_scan.cu``."""
    if tile % LANES:
        raise ValueError(f"tile={tile} must be a multiple of 128")
    if not _check_operands(Qm, Cflat, nrm, packed, has_norms):
        return codes_decode_topk_plain(Qm, Cflat, nrm, packed, tile=tile,
                                       r=r, idbits=idbits,
                                       has_norms=has_norms)
    if r != _RESCUE_R:
        raise ValueError(f"r={r}: the kernel takes r={_RESCUE_R}")
    n, nw = packed.shape
    (nq, dp), h = Qm.shape, nrm.shape[0]
    dev = Qm.device
    if not nq:
        return torch.empty((r + 1, LANES, 0), dtype=torch.int32, device=dev)
    bf16 = int(Qm.dtype == torch.bfloat16)
    layout = _rescue_layout(dp, nw, r, bf16, dev)
    out, cand, disc, nrows, rows_per = _alloc_onepass(n, nq, tile, r, dev,
                                                      layout, dp)
    launch("rq_codes_decode_topk", Qm, Cflat, nrm, packed, cand, disc, n,
           nq, dp, Cflat.shape[0] // h, h, nw, int(has_norms), nrows,
           rows_per, layout[0], r, idbits, bf16, device=dev)
    codes_decode_topk.launches += 1
    return _merge_onepass(out, cand, disc, r)


@functools.lru_cache(maxsize=None)
def _rescue_layout(dp: int, nw: int, r: int, bf16: int,
                   device: torch.device) -> tuple[int, int, int, int, int]:
    """K4's layout at width ``dp`` with ``nw`` packed words a row:
    ``(queries per CTA, lanes per CTA, CTAs per SM, d-block, shared
    bytes per CTA)``, as the kernel's source states it."""
    return query("rq_codes_topk_layout", dp, nw, r, bf16, size=5,
                 device=device)


codes_decode_topk.launches = 0


# ---------------------------------------------------------------------------
# Kernel K14: the one-pass decode scan with a per-tile cut
# ---------------------------------------------------------------------------

def codes_decode_onepass_plain(Qm, Cflat, nrm, packed, *, tile: int, r: int,
                               keep: int, idbits: int, has_norms: bool):
    """Plain version of `codes_decode_onepass` (same signature and
    outputs): K1's plain candidates, then K2's plain merge."""
    return cand_merge_plain(*codes_decode_candidates_plain(
        Qm, Cflat, nrm, packed, tile=tile, keep=keep, idbits=idbits,
        has_norms=has_norms), r)


def codes_decode_onepass(Qm, Cflat, nrm, packed, *, tile: int, r: int,
                         keep: int, idbits: int, has_norms: bool):
    """Kernel K14, the one-pass scan with a per-tile cut: per (lane,
    query) each tile of ``tile`` rows keeps its ``keep`` smallest keys,
    and the ``r`` smallest survivors over the whole base, ascending,
    then the certificate, min(every per-tile discard, every survivor not
    kept) → ``(r + 1, 128, nq)`` int32: K1 → K2's function (K1's
    scores, bit for bit) with no candidate array. Operands as
    `codes_decode_candidates`. On the card K14 is K1's body (a cluster
    of CTAs shares each decoded group of rows; bf16: 32 queries x 128
    lanes a CTA, f32: 128 queries x 16 lanes) carrying its buffers over
    all tiles; the row range is split over clusters, on tile boundaries,
    where that fills the card's waves better (`_onepass_grid`), and K2
    merges the splits. Source: ``rayuela_tpu_torch/csrc/codes_scan.cu``.
    """
    rows = tile // LANES
    if tile % LANES or not 1 <= keep <= rows:
        raise ValueError(f"tile={tile} must be a multiple of 128 and "
                         f"1 <= keep={keep} <= tile/128")
    if not _check_operands(Qm, Cflat, nrm, packed, has_norms):
        return codes_decode_onepass_plain(Qm, Cflat, nrm, packed, tile=tile,
                                          r=r, keep=keep, idbits=idbits,
                                          has_norms=has_norms)
    if (r, keep) not in _ONEPASS_CUTS:
        raise ValueError(f"(r={r}, keep={keep}): the kernel takes "
                         f"{_ONEPASS_CUTS}")
    n, nw = packed.shape
    (nq, dp), h = Qm.shape, nrm.shape[0]
    dev = Qm.device
    if not (nq and n):
        return torch.full((r + 1, LANES, nq), scan.IMAX, dtype=torch.int32,
                          device=dev)
    bf16 = int(Qm.dtype == torch.bfloat16)
    layout = _onepass_layout(r, keep, dp, nw, bf16, dev)
    ntiles = cdiv(n, tile)
    nqb, tiles_per = _onepass_grid(nq, ntiles, layout)
    splits = cdiv(ntiles, tiles_per)
    out = torch.empty((r + 1, LANES, nq), dtype=torch.int32, device=dev)
    if splits == 1:
        cand, disc = out[:r], out[r:]
    else:
        cand = torch.empty((splits * r, LANES, nq), dtype=torch.int32,
                           device=dev)
        disc = torch.empty((splits, LANES, nq), dtype=torch.int32,
                           device=dev)
    scratch = torch.empty(nqb * LANES // layout[8] * splits * layout[1],
                          dtype=torch.int32, device=dev)
    launch("rq_codes_decode_onepass", Qm, Cflat, nrm, packed, cand, disc,
           scratch, n, nq, dp, Cflat.shape[0] // h, h, nw, int(has_norms),
           rows, ntiles, tiles_per, r, keep, idbits, bf16, device=dev)
    codes_decode_onepass.launches += 1
    codes_decode_onepass.launches_f32 += not bf16
    return _merge_onepass(out, cand, disc, r)


# launches, and of those the f32 instance's
codes_decode_onepass.launches = 0
codes_decode_onepass.launches_f32 = 0


@functools.lru_cache(maxsize=None)
def _onepass_layout(r: int, keep: int, dp: int, nw: int, bf16: int,
                    device: torch.device) -> tuple[int, ...]:
    """K14's ``(queries per CTA, scratch ints per CTA, CTAs per SM,
    d-block, shared bytes per CTA, CTAs per cluster, clusters the card
    holds at once, step buffers, lanes per CTA)`` at these operands, as
    the kernel's source states them (bf16: dp up to 256 is one d-block
    and a CTA takes all 128 lanes; f32: pieces of 128 dimensions, a CTA
    16 lanes, so a query block has 8 CTAs)."""
    return query("rq_codes_onepass_layout", r, keep, dp, nw, bf16, size=9,
                 device=device)


def _query_blocks(nq: int, qb: int, cluster: int) -> int:
    """The query blocks of a K1 or K14 grid: ``nq`` queries in blocks of
    ``qb``, padded to whole clusters of ``cluster`` blocks (a padded
    block decodes its share of each step and writes nothing)."""
    return cdiv(nq, qb * cluster) * cluster


def _onepass_grid(nq: int, ntiles: int, layout) -> tuple[int, int]:
    """K14's ``(query blocks, tiles per CTA)`` for ``nq`` queries over
    ``ntiles`` tiles from its layout (`_onepass_layout`): the query
    blocks padded to whole clusters, and the rows split by
    `_onepass_tiles_per` over the card's cluster slots (the CTAs of a
    cluster walk one tile range; a split has ``128 / lanes`` clusters per
    cluster of query blocks, one a lane block)."""
    qb, cluster, held, lanes = layout[0], layout[5], layout[6], layout[8]
    nqb = _query_blocks(nq, qb, cluster)
    return nqb, _onepass_tiles_per(nqb // cluster * (LANES // lanes), ntiles,
                                   held, cluster)


def _onepass_tiles_per(nqb: int, ntiles: int, slots: int,
                       cluster: int = 1) -> int:
    """Tiles per K14 CTA. Its clusters of ``cluster`` CTAs (``nqb`` and
    ``slots`` count clusters) walk whole tile ranges, so
    with ``tiles_per`` tiles (``s = ceil(ntiles / tiles_per)`` splits) the
    scan takes about ``ceil(nqb * s / slots)`` waves of ``tiles_per``
    tiles each: the fewest splits within 2% of the least such cost, with
    at most ``_ONEPASS_CTAS`` CTAs unless the query blocks alone are
    more."""
    cap = max(1, min(ntiles, max(nqb, _ONEPASS_CTAS // cluster) // nqb))
    cost = {}
    for s in range(1, cap + 1):
        tp = cdiv(ntiles, s)
        cost.setdefault(tp, cdiv(nqb * cdiv(ntiles, tp), slots) * tp)
    least = min(cost.values())
    return max(tp for tp, c in cost.items() if c <= 1.02 * least)


# ---------------------------------------------------------------------------
# Kernel K5: the LUT scan
# ---------------------------------------------------------------------------

def _lut_scores_fn(T, packed, tile: int):
    """Scores of a LUT scan by tile: ``scores(t, q0, q1)`` is ``sum_j
    T[j, code_j(g), q]`` in f32, codebook order, for tile t and the
    queries [q0, q1), ``(tile, q1 - q0)``, +inf at and past row n."""
    mprime, h, nq = T.shape
    flat = T.reshape(mprime * h, nq)

    def scores(t, q0, q1):
        g0 = t * tile
        codes = unpack_codes(packed[g0:g0 + tile], mprime).long()
        Tb = flat[:, q0:q1].float()
        S = torch.full((tile, q1 - q0), float("inf"), dtype=torch.float32,
                       device=T.device)
        nv = codes.shape[0]
        acc = torch.zeros((nv, q1 - q0), dtype=torch.float32,
                          device=T.device)
        for j in range(mprime):          # codebook order, the norms last
            acc = acc + Tb.index_select(0, codes[:, j] + j * h)
        S[:nv] = acc
        return S
    return scores


def _check_lut(T, packed, tile: int) -> bool:
    """Validate the LUT-scan operands of K5, K6 and K7; True when they lie
    on a CUDA device (launch the kernel), False on the CPU (plain
    version)."""
    if T.dim() != 3 or packed.dim() != 2 \
            or packed.shape[1] != cdiv(T.shape[0], 4):
        raise ValueError(f"T {tuple(T.shape)} must be (m', h, nq) and "
                         f"packed {tuple(packed.shape)} (n, ceil(m'/4))")
    if T.dtype not in (torch.float32, torch.bfloat16) \
            or packed.dtype != torch.int32:
        raise ValueError("T must be float32 or bfloat16 and packed int32")
    if T.device != packed.device:
        raise ValueError("operands must share one device")
    if not (T.is_contiguous() and packed.is_contiguous()):
        raise ValueError("operands must be contiguous")
    rows = tile // LANES
    if tile % LANES or rows & (rows - 1):
        raise ValueError(f"tile/128={tile / LANES} must be a power of two")
    if T.device.type == "cpu":
        return False
    if T.device.type != "cuda":
        raise ValueError(f"unsupported device {T.device}")
    _check_lut_layout(*T.shape, T.dtype)
    return True


def _check_lut_layout(mprime: int, h: int, nq: int, dtype) -> None:
    """The limits of the one LUT body (K5-K7) on the card: a code is one
    byte, the CTA's tables fit its shared memory (`_lut_exact_layout`),
    and the query count fits the launch."""
    if h > 256:
        raise ValueError(f"h={h} > 256: a code is one byte (and its tables "
                         "must fit the kernels' shared memory)")
    qb, _, smem = _lut_exact_layout(mprime, h, int(dtype == torch.bfloat16))
    if not qb:
        raise ValueError(f"m'*h={mprime * h} tables of 8 queries ({smem} "
                         "bytes) exceed the kernels' shared memory")
    if nq >= 1 << 20:
        raise ValueError("at most 2**20 queries per call")


def _lut_exact_layout(mprime: int, h: int, bf16: int) -> tuple[int, int,
                                                                 int]:
    """The LUT body's (K5, K6, K7) ``(queries per CTA, threads per CTA,
    shared bytes per CTA)`` at m' tables of h entries, as
    ``rq_lut_exact_layout`` states it: the tables of the CTA's queries,
    code-major with the queries of an entry contiguous; the most queries
    of (32 on bf16 tables), 16, 8 whose tables fit, 0 where none does
    (the bytes then are 8 queries'); 128 rows of ``qb / v`` threads each,
    a thread reading ``v = 16 / sizeof(T)`` queries' values of an
    entry."""
    tb = 2 if bf16 else 4
    qb = next((q for q in ((32, 16, 8) if bf16 else (16, 8))
               if q * mprime * h * tb <= scan._SMEM_CAP), 0)
    q = qb or 8
    return qb, LANES * q * tb // 16, q * mprime * h * tb


def codes_lut_candidates_plain(T, packed, *, tile: int, keep: int,
                               idbits: int):
    """Plain version of `codes_lut_candidates` (same signature and
    outputs)."""
    return _candidates_plain(
        scan._keys_fn(_lut_scores_fn(T, packed, tile), tile, idbits),
        packed.shape[0], T.shape[2], T.device, tile=tile, keep=keep)


def codes_lut_candidates(T, packed, *, tile: int, keep: int, idbits: int):
    """Kernel K5, pass 1 of the LUT scan. Row ``g`` scores ``sum_j
    T[j, code_j(g), q]`` against query q: the table values at ``T``'s
    dtype (bfloat16 or float32), summed in f32 in codebook order, the
    norms table last; +inf at and past row n. For each tile of ``tile``
    rows and each (lane, query): the ``keep`` smallest packed keys,
    ascending, and the smallest of the tile's other keys.

    ``T (m', h, nq)`` is `build_luts`' stack at the table dtype,
    ``packed (n, ceil(m'/4))`` from `pack_codes`. Returns ``cand
    (ntiles*keep, 128, nq)`` and ``disc (ntiles, 128, nq)`` int32.
    Source: ``rayuela_tpu_torch/csrc/lut_scan.cu``."""
    on_card = _check_lut(T, packed, tile)
    if keep < 1 or keep > tile // LANES:
        raise ValueError(f"1 <= keep={keep} <= tile/128")
    if not on_card:
        return codes_lut_candidates_plain(T, packed, tile=tile, keep=keep,
                                          idbits=idbits)
    if keep not in _KEEPS:
        raise ValueError(f"keep={keep}: the kernel takes {_KEEPS}")
    mprime, h, nq = T.shape
    rows = tile // LANES
    n, nw = packed.shape
    ntiles, cand, disc = _alloc_candidates(n, nq, tile, keep, T.device)
    if nq and n:
        launch("rq_codes_lut_candidates", T, packed, cand, disc, n, nq,
               mprime, h, nw, ntiles, rows, keep, idbits,
               int(T.dtype == torch.bfloat16), device=T.device)
        codes_lut_candidates.launches += 1
    return cand, disc


codes_lut_candidates.launches = 0


# ---------------------------------------------------------------------------
# Kernels K6 and K7: the exact-float LUT scan and its counting certificate
# ---------------------------------------------------------------------------

def codes_lut_f32_candidates_plain(T, packed, *, tile: int, keep: int):
    """Plain version of `codes_lut_f32_candidates` (same signature and
    outputs)."""
    return scan._f32_candidates_plain(
        _lut_scores_fn(T, packed, tile), packed.shape[0], T.shape[2],
        T.device, tile=tile, keep=keep)


def codes_lut_f32_candidates(T, packed, *, tile: int, keep: int):
    """Kernel K6, pass 1 of the exact-float LUT scan. For each tile of
    ``tile`` rows and each (lane, query): the ``keep`` smallest (score,
    gid) pairs, ascending, the scores exactly K5's f32 sums (+inf at and
    past row n; such a slot carries the id `scan.NOID`) → ``candv`` f32
    and ``candi`` int32, each ``(ntiles * keep, 128, nq)``;
    `scan.pair_merge` is pass 2. Operands as `codes_lut_candidates`.
    Source: ``rayuela_tpu_torch/csrc/lut_scan.cu``."""
    on_card = _check_lut(T, packed, tile)
    scan._check_f32_plan(packed.shape[0], tile, keep)
    if keep < 1:
        raise ValueError("keep=0 has no candidates pass: "
                         "`codes_lut_topk_f32`")
    if not on_card:
        return codes_lut_f32_candidates_plain(T, packed, tile=tile,
                                              keep=keep)
    if keep not in _KEEPS:
        raise ValueError(f"keep={keep}: the kernel takes {_KEEPS}")
    mprime, h, nq = T.shape
    n, nw = packed.shape
    ntiles, candv, candi = scan._alloc_pairs(n, nq, tile, keep, T.device)
    if nq and n:
        launch("rq_codes_lut_f32_candidates", T, packed, candv, candi, n, nq,
               mprime, h, nw, ntiles, tile // LANES, keep,
               int(T.dtype == torch.bfloat16), device=T.device)
        codes_lut_f32_candidates.launches += 1
    return candv, candi


codes_lut_f32_candidates.launches = 0


def codes_lut_topk_f32_plain(T, packed, *, r: int, tile: int, keep: int):
    """Plain version of `codes_lut_topk_f32` (same signature and
    outputs)."""
    return scan._f32_topk_plain(
        _lut_scores_fn(T, packed, tile), packed.shape[0], T.shape[2],
        T.device, r=r, tile=tile, keep=keep)


def codes_lut_topk_f32(T, packed, *, r: int, tile: int, keep: int):
    """Kernel K6 whole: per (lane, query) the ``r`` smallest (score,
    gid) pairs of the LUT scan, ascending → ``outv (r, 128, nq)`` f32,
    ``outi (r, 128, nq)`` int32 global ids. ``keep`` as in
    `scan.scan_f32_topk`: the card's kernels need 2 or 4, ``keep=0`` (the
    JAX package's form) has a plain version only."""
    on_card = _check_lut(T, packed, tile)
    scan._check_f32_plan(packed.shape[0], tile, keep)
    if not on_card:
        return codes_lut_topk_f32_plain(T, packed, r=r, tile=tile, keep=keep)
    if keep not in _KEEPS:
        raise ValueError(f"keep={keep}: the kernels take keep in {_KEEPS}")
    return scan.pair_merge(
        *codes_lut_f32_candidates(T, packed, tile=tile, keep=keep), r)


def codes_verify_counts_plain(T, packed, taus, taui, *, tile: int):
    """Plain version of `codes_verify_counts` (same signature and
    outputs)."""
    return scan._verify_counts_plain(_lut_scores_fn(T, packed, tile),
                                     packed.shape[0], taus, taui, tile=tile)


def codes_verify_counts(T, packed, taus, taui, *, tile: int):
    """Kernel K7, the counting certificate of the exact-float LUT scan:
    `scan.verify_counts` on K6's scores, bit for bit → ``(2, 128, nq)``
    int32. Source: ``rayuela_tpu_torch/csrc/lut_scan.cu``."""
    on_card = _check_lut(T, packed, tile)
    scan._check_f32_plan(packed.shape[0], tile, 0)
    scan._check_tau(taus, taui, T.shape[2], T.device)
    if not on_card:
        return codes_verify_counts_plain(T, packed, taus, taui, tile=tile)
    mprime, h, nq = T.shape
    n, nw = packed.shape
    cnt = torch.zeros((2, LANES, nq), dtype=torch.int32, device=T.device)
    if nq and n:
        launch("rq_codes_lut_verify_counts", T, packed, taus, taui, cnt, n,
               nq, mprime, h, nw, cdiv(n, tile), tile // LANES,
               int(T.dtype == torch.bfloat16), device=T.device)
        codes_verify_counts.launches += 1
    return cnt


codes_verify_counts.launches = 0


# ---------------------------------------------------------------------------
# Scan entry points and the search front end
# ---------------------------------------------------------------------------

def _scan_setup(Q, Cflat, packed, k: int, r: int, tile: int):
    n = packed.shape[0]
    if k > r * LANES:
        raise ValueError(f"k={k} > r*128={r * LANES}")
    idbits = _pack_idbits(cdiv(n, tile) * tile)
    if not idbits:
        raise ValueError(f"n={n} exceeds the packed row-id range "
                         f"({_DECODE_SEG} rows per call); segment the base")
    return _query_operand(Q, Cflat.shape[1], Cflat.dtype), idbits


def scan_codes_decode_topk_2p(Q, Cflat, nrm, packed, *, k: int, pq: bool,
                              r: int = 32, tile: int = _TILE,
                              keep: int = 4):
    """Two-pass decode scan (K1 → K2 → K3) → ``(truncated scores
    (nq, k) f32 without +|q|^2, ids (nq, k) int32, flagged (nq,) bool)``:
    the exact top-k of the truncated scores unless flagged."""
    Qm, idbits = _scan_setup(Q, Cflat, packed, k, r, tile)
    cand, disc = codes_decode_candidates(Qm, Cflat, nrm, packed, tile=tile,
                                         keep=keep, idbits=idbits,
                                         has_norms=not pq)
    outp = cand_merge(cand, disc, r, cut=True)
    return _finish(outp, Q.shape[0], r, min(k, packed.shape[0]), idbits)


def _check_onepass_plan(r: int, tile: int, keep: int, qsuper: int,
                        stage: int) -> None:
    """The JAX package's checks of a one-pass decode plan
    (``pallas_scan_codes_decode_topk``): its bitonic widths are powers of
    two, and ``stage`` needs a per-tile cut and excludes ``qsuper``."""
    rows = tile // LANES
    if tile % LANES or rows & (rows - 1):
        raise ValueError(f"tile/128={tile / LANES} must be a power of two")
    if keep and (keep & (keep - 1) or keep > rows):
        raise ValueError(f"keep={keep} must be a power of two <= {rows}")
    wide = keep if (keep and keep < rows) else rows
    if stage:
        if not keep or keep >= rows:
            raise ValueError("staged merge requires 0 < keep < tile/128")
        if qsuper > 1:
            raise ValueError("stage and qsuper are mutually exclusive")
        w = r + keep * stage
        if w & (w - 1):
            raise ValueError(f"r+keep*stage={w} must be a power of two")
        if (keep * stage) & (keep * stage - 1):
            raise ValueError(f"keep*stage={keep * stage} must be a power "
                             "of two (staging-sort width)")
    elif (r + wide) & (r + wide - 1):
        raise ValueError(f"r+{wide}={r + wide} must be a power of two")


def scan_codes_decode_topk(Q, Cflat, nrm, packed, *, k: int, pq: bool,
                           r: int = _RESCUE_R, tile: int = _RESCUE_TILE,
                           keep: int = 0, qsuper: int = 1, stage: int = 0):
    """One-pass decode scan → K3, same contract as
    `scan_codes_decode_topk_2p`: K4 (no per-tile cut, ``keep=0``: the
    rescue kernel) or K14 (``keep > 0``). ``qsuper`` and ``stage`` name
    the TPU kernel's bodies (a query super-block; a buffer merge once per
    ``stage`` tiles): they compute one function, checked as the JAX
    package checks them, and on the card K14 decodes each step once per
    32 queries and merges after every tile whatever they are."""
    _check_onepass_plan(r, tile, keep, qsuper, stage)
    Qm, idbits = _scan_setup(Q, Cflat, packed, k, r, tile)
    kw = dict(tile=tile, r=r, idbits=idbits, has_norms=not pq)
    if keep:
        outp = codes_decode_onepass(Qm, Cflat, nrm, packed, keep=keep, **kw)
    else:
        outp = codes_decode_topk(Qm, Cflat, nrm, packed, **kw)
    return _finish(outp, Q.shape[0], r, min(k, packed.shape[0]), idbits)


def scan_codes_topk(T, packed, *, k: int, r: int = 32, tile: int = _TILE,
                    keep: int = 4, lut_dtype=torch.bfloat16,
                    pack: bool = True):
    """LUT scan over per-query tables ``T (m', h, nq)`` from
    `build_luts` → ``(scores (nq, k) f32 without +|q|^2, ids (nq, k)
    int32, flagged (nq,) bool)``. The table values are rounded to
    ``lut_dtype`` before the sums; the sums are f32.

    ``pack=True``: the two-pass packed scan (K5 → K2 → K3), the exact
    top-k of the truncated scores unless flagged. ``pack=False``: the
    exact-float scan (K6 → `torch.topk` over the candidates → K7), the
    counterpart of the JAX package's
    ``pallas_scan_codes_topk(pack=False)``: the exact top-k of the f32
    sums by (score, id) unless flagged; ``keep=0`` there is the JAX
    form without the per-tile cut (CPU tensors only)."""
    mprime, h, nq = T.shape
    n = packed.shape[0]
    Tq = T.to(lut_dtype).contiguous()
    if not pack:
        scan._check_f32_topk(k, r, keep)
        outv, outi = codes_lut_topk_f32(Tq, packed, r=r, tile=tile,
                                        keep=keep)
        return scan._finish_f32(
            outv, outi, min(k, n), r, keep,
            lambda ts, ti: codes_verify_counts(Tq, packed, ts, ti,
                                               tile=tile))
    if k > r * LANES:
        raise ValueError(f"k={k} > r*128={r * LANES}")
    if keep < 1 or keep & (keep - 1):
        raise ValueError(f"keep={keep} must be a power of two >= 1 (the "
                         "LUT scan has no one-pass kernel)")
    idbits = _pack_idbits(cdiv(n, tile) * tile)
    if not idbits:
        raise ValueError(f"n={n} exceeds the packed row-id range "
                         f"({_DECODE_SEG} rows per call); segment the base")
    cand, disc = codes_lut_candidates(Tq, packed, tile=tile, keep=keep,
                                      idbits=idbits)
    outp = cand_merge(cand, disc, r, cut=True)
    return _finish(outp, nq, r, min(k, n), idbits)


def _codes_config(k: int, mode: str = "decode", n: int | None = None,
                  f32_on=None) -> tuple[str, int, int, int]:
    """Scan plan for a top-k of size ``k`` → (kind, r, keep, tile): the
    two-pass scan at the plan every packed scan shares
    (`scan._scan_config`: the flag statistics depend on ``(k, r, keep,
    tile)``, not on where a score comes from), and beyond its deepest
    buffer the plain LUT scan. A base of ``n`` rows whose tiles keep
    fewer than k candidates (k most of a small base) cannot be served in
    two passes: decode mode takes the one-pass K4 scan where its buffer
    holds k, and the plain LUT scan serves the rest. ``f32_on`` names
    the device of an exact-float LUT scan, which takes its own plan
    (`scan._f32_config`, kind "f32")."""
    if f32_on is not None:
        r, keep, tile, kmax = scan._f32_config(k, f32_on)
        if k > kmax or (keep and n is not None
                        and k > cdiv(n, tile) * keep * LANES):
            return "lut", 0, 0, 0
        return "f32", r, keep, tile
    if k > scan._MAX_K:
        return "lut", 0, 0, 0
    r, keep, tile = scan._scan_config(k)
    if n is not None and k > cdiv(n, tile) * keep * LANES:
        if mode == "decode" and k <= _RESCUE_R * LANES:
            return "1p", _RESCUE_R, 0, _RESCUE_TILE
        return "lut", 0, 0, 0
    return "2p", r, keep, tile


def _onepass_config(k: int, mprime: int) -> tuple[int, int, int]:
    """The JAX package's one-pass decode plan (``_codes_auto_config`` in
    decode mode) → ``(r, keep, tile)``: (14, 2, 2048) to k=512, then
    (28, 4, 8192); with more than 11 bytes per code (12, 4, 2048) and
    (28, 4, 4096). Its ``bq`` and ``qsuper`` are TPU blocking."""
    small = mprime <= 11
    if k <= 512:
        return (14, 2, 2048) if small else (12, 4, 2048)
    return (28, 4, 8192) if small else (28, 4, 4096)


def _rescue(Q, Cf, nrm, index: CodesIndex, s, i, flagged, k: int, d: int,
            op_dtype, deep: bool):
    """Re-run certificate-flagged queries exactly: through K4 when
    ``deep`` (its buffer is deeper than the plan's), then the queries K4
    flags (again) through the LUT oracle: a K4 pass with the same buffer
    would flag them again."""
    still = torch.nonzero(flagged).flatten()
    if deep:
        s2, i2, f2 = scan_codes_decode_topk(Q[still], Cf, nrm,
                                            index.packed, k=k, pq=index.pq)
        s[still], i[still] = s2, i2
        still = still[f2]
    if still.numel():
        s2, i2 = _lut_scan_tiled(index, Q[still], k, d, op_dtype)
        s[still], i[still] = s2, i2
    return s, i


def _search_segments(index: CodesIndex, Q, k: int, **kw):
    """A base beyond the packed row-id range: `search_codes` per
    `_DECODE_SEG`-row segment with an exact merge on the device
    (`scan.segments_topk`). Each segment's call certifies and rescues its
    own queries, so it hands the loop no flag."""
    none = torch.zeros(Q.shape[0], dtype=torch.bool, device=Q.device)

    def scan_one(st, stop, kseg):
        sub = index._segments.get(st)
        if sub is None:
            sub = CodesIndex(index.packed[st:stop], index.mprime, index.C,
                             pq=index.pq, d=index.d,
                             norms_cbook=index.norms_cbook)
            sub._decode_ops = index._decode_ops     # one operand cache
            index._segments[st] = sub
        return (*search_codes(sub, Q, kseg, **kw), none)

    return scan.segments_topk(index.n, _DECODE_SEG, k, scan_one)[:2]


def search_codes(index: CodesIndex, Q, k: int, *,
                 op_dtype=None, mode: str = "decode",
                 pack: bool | None = None, twopass: bool | None = None,
                 r: int | None = None, keep: int | None = None,
                 tile: int | None = None, bq: int | None = None,
                 stage: int | None = None, qsuper: int | None = None,
                 vmem_mb: int | None = None, lut_dtype=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (for the kernel scores) over a packed-code index →
    ``(dists (nq, k) f32 with +|q|^2, ids (nq, k) int32)``.

    ``mode="decode"`` scores a row by decoding it (K1/K14/K4),
    ``mode="lut"`` by summing per-query table entries (K5); flagged
    queries re-run exactly. ``op_dtype`` is the dtype of the kernels'
    operands (decode) or tables (lut): bfloat16 on the card, float32 on
    the CPU by default; ``lut_dtype``, the JAX package's name for it,
    sets it as well (the two must agree where both are given).
    ``pack=None`` (or True) selects by packed keys,
    the exact top-k of the truncated scores; ``mode="lut", pack=False``
    is the exact-float scan (K6, K7): the exact top-k of the f32 table
    sums by (score, id), with no segments (its ids are 32 bits wide). In
    ``mode="decode"`` the JAX package always packs and ``pack`` only
    picks its plan; here the argument is accepted and the plan stays.

    Decode mode routes as the JAX package does: the two-pass scan (K1 →
    K2) unless ``twopass=False``, ``stage`` or an explicit ``r``,
    ``keep``, ``tile`` or ``bq`` is given; then the one-pass scan with a
    per-tile cut (K14, at `_onepass_config`'s plan for what is not
    given; ``keep=0`` is K4's form). Both return the exact top-k of the
    same truncated keys where their plans give the keys the same id
    bits. ``stage`` and ``qsuper`` are checked as the JAX package checks
    them and compute the same function; ``bq`` and ``vmem_mb`` are TPU
    blocking and have no effect on the card. In LUT mode ``r``, ``keep``
    and ``tile`` replace the plan's and the routing arguments have no
    effect. A base beyond `_DECODE_SEG` rows runs in segments, and a
    query batch whose candidate array would pass `scan._CAND_CAP` bytes
    in chunks (where the JAX package takes the one-pass scan instead)."""
    if mode not in ("decode", "lut"):
        raise ValueError(f"mode {mode!r}: 'decode' or 'lut'")
    dev = index.packed.device
    Q = torch.as_tensor(Q, dtype=torch.float32, device=dev)
    if lut_dtype is not None:
        if op_dtype is not None and op_dtype != lut_dtype:
            raise ValueError(f"lut_dtype={lut_dtype} and op_dtype={op_dtype}"
                             " name the one operand dtype")
        op_dtype = lut_dtype
    if op_dtype is None:
        op_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    k = min(k, index.n)
    f32 = mode == "lut" and pack is not None and not pack
    stage, qsuper = stage or 0, qsuper or 1
    if twopass is None:
        twopass = r is None and keep is None and tile is None \
            and bq is None and not stage
    plan = dict(twopass=twopass, r=r, keep=keep, tile=tile, stage=stage,
                qsuper=qsuper)
    if index.n > _DECODE_SEG and not f32:
        return _search_segments(index, Q, k, op_dtype=op_dtype, mode=mode,
                                **plan)
    d = Q.shape[1] if index.d in (-1, None) else index.d
    q2 = (Q * Q).sum(-1, keepdim=True)
    if mode == "decode" and not twopass:
        kind = "onepass"
        pr, pkeep, ptile = _onepass_config(k, index.mprime)
    else:
        kind, pr, pkeep, ptile = _codes_config(k, mode, index.n,
                                               dev if f32 else None)
    if kind == "lut":
        s, i = _lut_scan_tiled(index, Q, k, d, op_dtype)
        return s + q2, i
    r = pr if r is None else r
    keep = pkeep if keep is None else keep
    tile = ptile if tile is None else tile
    if mode == "decode":
        Cf, nrm = index.decode_operands(d, op_dtype)
    parts = []
    per_query = cdiv(index.n, tile) * max(keep, 1) * LANES * 4
    if f32:
        per_query = scan._f32_bytes_per_query(index.n, r, tile, keep)
    elif kind == "onepass":   # its output and its buffers' scratch
        per_query = (2 * r + 1) * LANES * 4
    for a, b in scan._query_chunks(Q.shape[0], per_query):
        Qc = Q[a:b]
        if mode == "lut":
            T = build_luts(index.C, Qc, pq=index.pq, d=d,
                           norms_cbook=index.norms_cbook)
            parts.append(scan_codes_topk(T, index.packed, k=k, r=r,
                                         tile=tile, keep=keep,
                                         lut_dtype=op_dtype, pack=not f32))
        elif kind == "2p":
            parts.append(scan_codes_decode_topk_2p(
                Qc, Cf, nrm, index.packed, k=k, pq=index.pq, r=r,
                tile=tile, keep=keep))
        elif kind == "onepass":
            parts.append(scan_codes_decode_topk(
                Qc, Cf, nrm, index.packed, k=k, pq=index.pq, r=r,
                tile=tile, keep=keep, qsuper=qsuper, stage=stage))
        else:
            parts.append(scan_codes_decode_topk(Qc, Cf, nrm, index.packed,
                                                k=k, pq=index.pq))
    s, i, fl = (torch.cat(p) for p in zip(*parts))
    if bool(fl.any()):
        if mode == "lut":
            still = torch.nonzero(fl).flatten()
            s[still], i[still] = _lut_scan_tiled(index, Q[still], k, d,
                                                 op_dtype)
        else:
            s, i = _rescue(Q, Cf, nrm, index, s, i, fl, k, d, op_dtype,
                           deep=r < _RESCUE_R)
    return s + q2, i


class _ShardFeed:
    """Packed-code shards from host memory to ``device``, one ahead.

    On the card a shard is staged in one of two pinned host buffers and
    copied with ``non_blocking=True`` on a side stream, so the copy of
    shard j + 1 runs behind the scan of shard j. Two events keep it
    right: the scan's stream waits for the copy's event before it reads
    the shard, and a staging buffer is written again only after the copy
    that last read it has finished. At most two shards are on the
    device, the one being scanned and the one in flight. On the CPU the
    same calls hand out host slices."""

    def __init__(self, B_packed, bounds, device):
        self.B, self.bounds, self.dev = B_packed, bounds, device
        self.on_card = device.type == "cuda"
        if self.on_card:
            rows = max(b - a for a, b in bounds)
            self.side = torch.cuda.Stream(device)
            self.stage = [torch.empty((rows, B_packed.shape[1]),
                                      dtype=torch.int32, pin_memory=True)
                          for _ in range(2)]
            self.copied = [None, None]

    def start(self, j: int):
        """Begin bringing shard j → a handle for `wait`."""
        a, b = self.bounds[j]
        if not self.on_card:      # a read-only memmap slice is copied
            return torch.from_numpy(np.require(
                self.B[a:b], requirements=("C", "W"))), None
        slot = j % 2
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        stage = self.stage[slot][:b - a]
        np.copyto(stage.numpy(), self.B[a:b])
        with torch.cuda.stream(self.side):
            pk = torch.empty_like(stage, device=self.dev)
            pk.copy_(stage, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.side)
        self.copied[slot] = ev
        return pk, ev

    def wait(self, handle) -> torch.Tensor:
        """The shard, safe to read on the current stream."""
        pk, ev = handle
        if ev is not None:
            cur = torch.cuda.current_stream(self.dev)
            cur.wait_event(ev)
            pk.record_stream(cur)   # it was allocated on the side stream
        return pk


def search_codes_streamed(C, B_packed, Q, k: int, *, pq: bool = False,
                          d: int | None = None, norms_cbook=None,
                          mprime: int | None = None,
                          shard_n: int = 100_000_000, **kw
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Code-resident search over a base too large for the device: the
    packed codes ``B_packed (n, ceil(m'/4)) int32`` (`pack_codes`
    layout, the norms byte included for additive models: pass
    ``mprime``) stay in host memory, a numpy array or an ``np.memmap``
    over a code file, and stream to the device ``shard_n`` rows at a
    time. Each shard runs the whole `search_codes` pipeline (``kw`` goes
    there: ``mode="lut"``, ``pack=False``) on one `CodesIndex` whose
    codes are swapped per shard; the next shard's copy is started before
    the current shard's scan (`_ShardFeed`); the shards' top-k lists
    merge exactly on the device, by (score, id). ``C`` and ``Q`` stay
    on their device when they are tensors and go to the card otherwise."""
    if not isinstance(B_packed, np.memmap):
        B_packed = np.asarray(B_packed)
    n, nw = B_packed.shape
    C = as_tensor(C)
    dev = C.device
    Q = as_tensor(Q, dev)
    ncb = None if norms_cbook is None else as_tensor(norms_cbook, dev)
    d = Q.shape[1] if d is None else d
    bounds = [(st, min(st + shard_n, n)) for st in range(0, n, shard_n)]
    feed = _ShardFeed(B_packed, bounds, dev)
    index = best = None
    nxt = feed.start(0)
    for j, (start, stop) in enumerate(bounds):
        pk = feed.wait(nxt)
        if index is None:
            index = CodesIndex(pk, nw * 4 if mprime is None else mprime, C,
                               pq=pq, d=d, norms_cbook=ncb)
        else:
            index.swap_packed(pk)       # releases the shard before
        del pk
        if j + 1 < len(bounds):
            nxt = feed.start(j + 1)     # behind this shard's scan
        s, i = search_codes(index, Q, min(k, stop - start), **kw)
        best = scan.merge_topk(best, (s, i + start), k)
    return best
