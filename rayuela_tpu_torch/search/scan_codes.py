"""Code-resident search: scan packed uint8 codes, never a decoded base
(counterpart of `rayuela_tpu/search/scan_codes_pallas.py`).

The index on the card is the packed codes (m bytes per vector, plus one
norms byte for additive models). A search runs in two passes:

* K1 `codes_decode_candidates`: each 8192-row tile is decoded once from
  its codes and scored against every query; per (lane, query) the tile
  keeps its ``keep`` smallest packed keys and the minimum of the rest.
* K2 `cand_merge`: per (lane, query) the r smallest candidates, plus a
  certificate row, the smallest key the scan threw away.
* K3 `scan.tail_merge`: the 128 per-lane lists merge into the query's
  top-k.

A query whose certificate beats its k-th key may have lost a true
top-k member; it re-runs through K4 `codes_decode_topk`, a one-pass
scan with a deep per-lane buffer, and when K4 flags it again, through
the plain LUT oracle `lut_scan`. The result is the exact top-k of the
truncated kernel scores, certified per query.

Every kernel wrapper takes its plain PyTorch version for CPU tensors
only; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.kernels.build import launch
from rayuela_tpu_torch.search.scan import (IMAX, LANES, _pack_idbits,
                                           _packed_candidates, _row_key)
from rayuela_tpu_torch.utils import cdiv, exact_f32, splitarray

# row ids are 16 bits wide, so one single-segment scan covers this many
# rows; larger bases are not ported yet (ROADMAP A2)
_DECODE_SEG = (1 << 16) * LANES

# rescue kernel shape: one-pass scan, keep=0, a 48-deep per-lane buffer
_RESCUE_R, _RESCUE_TILE = 48, 2048

# the kernels' compile-time variants (those `_codes_config` plans) and
# shared-memory limit; K4 runs only at the rescue depth _RESCUE_R
_KEEPS = (2, 4)
_RS = (16, 32, _RESCUE_R)
_MAX_DP = 256
_MAX_SPLITS = 4096

# query block of the plain versions: bounds their transient memory
_QBLOCK = 1024


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

def lut_scan(T: torch.Tensor, B: torch.Tensor, k: int,
             lut_dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-accumulate LUT scan ``sum_j T_j[code_j]`` with exact top-k:
    the fallback for queries the rescue kernel flags, and the oracle of
    the tests. Scores exclude ``+|q|^2``."""
    mprime, h, nq = T.shape
    n = B.shape[0]
    flat = T.to(lut_dtype).float().permute(2, 0, 1).reshape(nq, mprime * h)
    idx = (B.long() + torch.arange(mprime, device=B.device)[None, :] * h)
    s = flat[:, idx].sum(2)
    top = torch.topk(s, min(k, n), dim=1, largest=False, sorted=True)
    return top.values, top.indices.to(torch.int32)


def _lut_scan_tiled(index: CodesIndex, Q: torch.Tensor, k: int, d: int,
                    lut_dtype, qblock: int = 128,
                    seg: int = 1 << 19) -> tuple[torch.Tensor, torch.Tensor]:
    """`lut_scan` over the whole base, tiled over base segments (outer,
    each unpacked once) and query blocks, with an exact top-k merge, so
    the (qblock, seg, m') gather stays bounded. Scores exclude
    ``+|q|^2``."""
    nq = Q.shape[0]
    blocks = [(q0, min(q0 + qblock, nq)) for q0 in range(0, nq, qblock)]
    Ts = [build_luts(index.C, Q[a:b], pq=index.pq, d=d,
                     norms_cbook=index.norms_cbook) for a, b in blocks]
    bs: list = [None] * len(blocks)
    bi: list = [None] * len(blocks)
    for st in range(0, index.n, seg):
        stop = min(st + seg, index.n)
        Bseg = unpack_codes(index.packed[st:stop], index.mprime)
        for j in range(len(blocks)):
            s2, i2 = lut_scan(Ts[j], Bseg, min(k, stop - st), lut_dtype)
            i2 = i2 + st
            if bs[j] is None:
                bs[j], bi[j] = s2, i2
            else:
                cs = torch.cat([bs[j], s2], dim=1)
                ci = torch.cat([bi[j], i2], dim=1)
                top = torch.topk(cs, min(k, cs.shape[1]), dim=1,
                                 largest=False, sorted=True)
                bs[j] = top.values
                bi[j] = torch.gather(ci, 1, top.indices)
    return torch.cat(bs, 0), torch.cat(bi, 0)


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
    if Cflat.shape[1] > _MAX_DP or Cflat.shape[1] % LANES:
        raise ValueError(f"dp={Cflat.shape[1]} must be a multiple of 128 "
                         f"and at most {_MAX_DP} (the decoded tile must fit "
                         "the kernel's shared memory)")
    if Cflat.data_ptr() % 16:
        raise ValueError("Cflat must be 16-byte aligned: the kernels read "
                         "it 16 bytes at a time")
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


def _tile_keys(Cflat, nrm, packed, Qf, g0: int, tile: int, m: int,
               has_norms: bool, idbits: int) -> torch.Tensor:
    """Keys of rows [g0, g0 + tile) against ``Qf`` → (tile/128, 128, nq);
    rows at or past n score +inf."""
    exact_f32()
    n = packed.shape[0]
    X, x2 = _decode_x2(Cflat, nrm, packed[g0:g0 + tile], m, has_norms)
    S = torch.full((tile, Qf.shape[0]), float("inf"), dtype=torch.float32,
                   device=Qf.device)
    nv = max(0, min(tile, n - g0))
    S[:nv] = X @ Qf.T + x2[:, None]
    rows = tile // LANES
    return _row_key(S, g0 // tile, rows=rows, idbits=idbits)


def codes_decode_candidates_plain(Qm, Cflat, nrm, packed, *, tile: int,
                                  keep: int, idbits: int,
                                  has_norms: bool):
    """Plain version of `codes_decode_candidates` (same signature and
    outputs)."""
    n, nq = packed.shape[0], Qm.shape[0]
    m = Cflat.shape[0] // nrm.shape[0]
    ntiles, rows = cdiv(n, tile), tile // LANES
    cand = torch.empty((ntiles * keep, LANES, nq), dtype=torch.int32,
                       device=Qm.device)
    disc = torch.empty((ntiles, LANES, nq), dtype=torch.int32,
                       device=Qm.device)
    Qf = Qm.float()
    for t in range(ntiles):
        for q0 in range(0, nq, _QBLOCK):
            kv = _tile_keys(Cflat, nrm, packed, Qf[q0:q0 + _QBLOCK],
                            t * tile, tile, m, has_norms, idbits)
            top = torch.topk(kv, min(keep + 1, rows), dim=0, largest=False,
                             sorted=True).values
            cand[t * keep:(t + 1) * keep, :, q0:q0 + _QBLOCK] = top[:keep]
            disc[t, :, q0:q0 + _QBLOCK] = top[keep] if rows > keep else IMAX
    return cand, disc


def codes_decode_candidates(Qm, Cflat, nrm, packed, *, tile: int,
                            keep: int, idbits: int, has_norms: bool):
    """Kernel K1, pass 1 of the scan. For each tile of ``tile`` rows and
    each (lane, query): the ``keep`` smallest packed keys, ascending,
    and the smallest of the tile's other keys (INT32_MAX when none).

    ``Qm (nq, dp)`` is ``-2 Q`` at the operand dtype, ``Cflat
    (m*h, dp)`` and ``nrm (h, 128)`` come from `build_decode_operands`,
    ``packed (n, nw)`` from `pack_codes`. Returns ``cand
    (ntiles*keep, 128, nq)`` and ``disc (ntiles, 128, nq)`` int32.
    Source: ``rayuela_tpu_torch/csrc/codes_scan.cu``."""
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
    ntiles = cdiv(n, tile)
    cand = torch.empty((ntiles * keep, LANES, nq), dtype=torch.int32,
                       device=Qm.device)
    disc = torch.empty((ntiles, LANES, nq), dtype=torch.int32,
                       device=Qm.device)
    if nq and n:
        launch("rq_codes_decode_candidates", Qm, Cflat, nrm, packed, cand,
               disc, n, nq, dp, Cflat.shape[0] // h, h, nw, int(has_norms),
               ntiles, tile // LANES, keep, idbits,
               int(Qm.dtype == torch.bfloat16), device=Qm.device)
        codes_decode_candidates.launches += 1
    return cand, disc


codes_decode_candidates.launches = 0


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
    """Kernel K2, pass 2 of the scan. Per (lane, query): the ``r``
    smallest keys of ``cand (ncand, 128, nq)``, ascending, then one
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


def codes_decode_topk_plain(Qm, Cflat, nrm, packed, *, tile: int, r: int,
                            idbits: int, has_norms: bool):
    """Plain version of `codes_decode_topk` (same signature and
    outputs)."""
    n, nq = packed.shape[0], Qm.shape[0]
    m = Cflat.shape[0] // nrm.shape[0]
    npad = cdiv(n, tile) * tile
    out = torch.empty((r + 1, LANES, nq), dtype=torch.int32,
                      device=Qm.device)
    Qf = Qm.float()
    for q0 in range(0, nq, _QBLOCK):
        Qb = Qf[q0:q0 + _QBLOCK]
        buf = torch.full((r + 1, LANES, Qb.shape[0]), IMAX,
                         dtype=torch.int32, device=Qm.device)
        for g0 in range(0, npad, tile):
            kv = _tile_keys(Cflat, nrm, packed, Qb, g0, tile, m, has_norms,
                            idbits)
            buf = torch.topk(torch.cat([buf, kv]), r + 1, dim=0,
                             largest=False, sorted=True).values
        out[:, :, q0:q0 + _QBLOCK] = buf
    return out


def codes_decode_topk(Qm, Cflat, nrm, packed, *, tile: int, r: int,
                      idbits: int, has_norms: bool):
    """Kernel K4, the one-pass scan the rescue runs. Per (lane, query)
    over the whole base (padded to a multiple of ``tile`` rows): the
    ``r`` smallest packed keys, ascending, then the (r+1)-th smallest,
    the certificate → ``(r + 1, 128, nq)`` int32. Scores exactly as K1.
    On the card the row range is split over CTAs and K2 merges the
    splits. Source: ``rayuela_tpu_torch/csrc/codes_scan.cu``."""
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
    out = torch.empty((r + 1, LANES, nq), dtype=torch.int32, device=dev)
    if not nq:
        return out
    # split the row range until the card holds ~4 CTAs per SM: the rescue
    # serves a few queries, and one CTA per query pair walking the whole
    # base would leave most SMs idle
    nrows = cdiv(n, tile) * tile // LANES
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = min(nrows, _MAX_SPLITS, max(1, cdiv(4 * sms, cdiv(nq, 2))))
    rows_per = cdiv(nrows, splits)
    splits = cdiv(nrows, rows_per)
    if splits == 1:
        cand, disc = out[:r], out[r:]
    else:
        cand = torch.empty((splits * r, LANES, nq), dtype=torch.int32,
                           device=dev)
        disc = torch.empty((splits, LANES, nq), dtype=torch.int32,
                           device=dev)
    launch("rq_codes_decode_topk", Qm, Cflat, nrm, packed, cand, disc, n,
           nq, dp, Cflat.shape[0] // h, h, nw, int(has_norms), nrows,
           rows_per, r, idbits, int(Qm.dtype == torch.bfloat16), device=dev)
    codes_decode_topk.launches += 1
    return out if splits == 1 else cand_merge(cand, disc, r)


codes_decode_topk.launches = 0


# ---------------------------------------------------------------------------
# Scan entry points and the search front end
# ---------------------------------------------------------------------------

def _query_operand(Q: torch.Tensor, dp: int, dtype) -> torch.Tensor:
    """``-2 Q`` zero-padded to dp columns, at the operand dtype."""
    Qm = torch.nn.functional.pad(-2.0 * Q, (0, dp - Q.shape[1]))
    return Qm.to(dtype).contiguous()


def _scan_setup(Q, Cflat, packed, k: int, r: int, tile: int):
    n = packed.shape[0]
    if k > r * LANES:
        raise ValueError(f"k={k} > r*128={r * LANES}")
    idbits = _pack_idbits(cdiv(n, tile) * tile)
    if not idbits:
        raise ValueError(f"n={n} too large for packed row ids")
    return _query_operand(Q, Cflat.shape[1], Cflat.dtype), idbits


def _finish(outp, nq: int, r: int, k: int, idbits: int):
    vals, ids, tau = _packed_candidates(outp, nq, r, k, idbits)
    flagged = (outp[r] < tau[None, :]).any(0)
    return vals, ids, flagged


def scan_codes_decode_topk_2p(Q, Cflat, nrm, packed, *, k: int, pq: bool,
                              r: int = 32, tile: int = 8192,
                              keep: int = 4):
    """Two-pass decode scan (K1 → K2 → K3) → ``(truncated scores
    (nq, k) f32 without +|q|^2, ids (nq, k) int32, flagged (nq,) bool)``:
    the exact top-k of the truncated scores unless flagged."""
    Qm, idbits = _scan_setup(Q, Cflat, packed, k, r, tile)
    cand, disc = codes_decode_candidates(Qm, Cflat, nrm, packed, tile=tile,
                                         keep=keep, idbits=idbits,
                                         has_norms=not pq)
    outp = cand_merge(cand, disc, r)
    return _finish(outp, Q.shape[0], r, min(k, packed.shape[0]), idbits)


def scan_codes_decode_topk(Q, Cflat, nrm, packed, *, k: int, pq: bool,
                           r: int = _RESCUE_R, tile: int = _RESCUE_TILE):
    """One-pass decode scan (K4 → K3), same contract as
    `scan_codes_decode_topk_2p`."""
    Qm, idbits = _scan_setup(Q, Cflat, packed, k, r, tile)
    outp = codes_decode_topk(Qm, Cflat, nrm, packed, tile=tile, r=r,
                             idbits=idbits, has_norms=not pq)
    return _finish(outp, Q.shape[0], r, min(k, packed.shape[0]), idbits)


def _codes_config(k: int) -> tuple[str, int, int]:
    """Scan plan for a top-k of size ``k`` → (kind, r, keep).

    K2's per-lane buffer ``r`` must hold k across 128 lanes with room
    for the uneven spread of the top-k over lanes, and K1's per-tile
    ``keep`` must hold a lane's share of the top-k within one tile. Both
    set how much K2 reads, so they stay as small as the flag rate
    allows: r=16, keep=2 up to k=512; r=32, keep=4 up to k=4096. Larger
    k runs the one-pass K4 scan at its deepest buffer, and beyond
    48*128 keys per lane the plain LUT scan."""
    if k <= 512:
        return "2p", 16, 2
    if k <= 4096:
        return "2p", 32, 4
    if k <= _RESCUE_R * LANES:
        return "1p", _RESCUE_R, 0
    return "lut", 0, 0


def _rescue(Q, Cf, nrm, index: CodesIndex, s, i, flagged, k: int, d: int,
            op_dtype, deep: bool):
    """Re-run certificate-flagged queries exactly: through K4's deep
    buffer when ``deep``, then the queries K4 flags (again) through the
    LUT oracle: a K4 pass with the same buffer would flag them again."""
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


def search_codes(index: CodesIndex, Q, k: int, *,
                 op_dtype=None, mode: str = "decode", qsuper: int = 1,
                 stage: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (for the kernel scores) over a packed-code index →
    ``(dists (nq, k) f32 with +|q|^2, ids (nq, k) int32)``.

    ``op_dtype`` is the kernels' operand dtype: bfloat16 on the card,
    float32 on the CPU by default. The JAX package's ``qsuper`` and
    ``stage`` variants and its LUT mode are not ported."""
    if qsuper != 1 or stage:
        raise NotImplementedError(
            "the qsuper/stage variants of the one-pass scan are not "
            "ported yet (ROADMAP B11)")
    if mode != "decode":
        raise NotImplementedError(
            f"mode={mode!r}: the LUT-mode scan (kernel K5) is not ported "
            "yet (ROADMAP B8)")
    if index.n > _DECODE_SEG:
        raise NotImplementedError(
            f"n={index.n} > {_DECODE_SEG}: segmented bases are not ported "
            "yet (ROADMAP A2)")
    dev = index.packed.device
    Q = torch.as_tensor(Q, dtype=torch.float32, device=dev)
    if op_dtype is None:
        op_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    k = min(k, index.n)
    d = Q.shape[1] if index.d in (-1, None) else index.d
    q2 = (Q * Q).sum(-1, keepdim=True)
    kind, r, keep = _codes_config(k)
    if kind == "lut":
        s, i = _lut_scan_tiled(index, Q, k, d, op_dtype)
        return s + q2, i
    Cf, nrm = index.decode_operands(d, op_dtype)
    if kind == "2p":
        s, i, fl = scan_codes_decode_topk_2p(Q, Cf, nrm, index.packed, k=k,
                                             pq=index.pq, r=r, keep=keep)
    else:
        s, i, fl = scan_codes_decode_topk(Q, Cf, nrm, index.packed, k=k,
                                          pq=index.pq)
    if bool(fl.any()):
        s, i = _rescue(Q, Cf, nrm, index, s, i, fl, k, d, op_dtype,
                       deep=kind == "2p")
    return s + q2, i


def search_codes_streamed(*args, **kwargs):
    """Search over packed codes held in host memory: not ported yet."""
    raise NotImplementedError(
        "streamed search over host-resident codes is not ported yet "
        "(ROADMAP A7)")
