"""The (data, model) mesh of ranks and the sharded searches (counterpart
of `rayuela_tpu/parallel/mesh.py`).

The JAX package is one controller driving many devices: a function takes
a global array and ``shard_map`` splits it. PyTorch runs one process a
GPU (SPMD): every rank calls the same function, and each says here what
it passes.

* A **replicated** argument (queries, codebooks, tables, a rotation) is
  the same on every rank.
* A **row-sharded** argument (training vectors, base codes, a decoded
  base) is either the global array, the same on every rank, of which
  rank r of the ``data`` axis takes rows ``splitarray(n, P)[r]`` as a
  view, or a `RowShard`: the rank's own rows, their first global row and
  the global row count (`shard_data`, `launch.host_local_to_global`,
  where no rank ever holds the whole array). Shards may be uneven; no
  pad rows are added.
* Results are replicated: every rank gets the merged top-k, the reduced
  statistics, the same codebooks. Per-row results (codes) come back in
  the form their rows went in: a global array gathered from the ranks,
  or a `RowShard`.

Axes: ``data`` splits the rows (statistics and objectives are all-
reduced sums over it, top-k lists all-gathered and merged), ``model``
the m subspaces of the PQ Lloyd step; ranks that share a ``data``
coordinate hold the same rows. Every collective goes through the small
set of helpers below (sum, all-gather of equal-size tensors, OR of
flags); under gloo they move CUDA tensors through host copies, since
gloo's support for them is partial. A mesh made without a process group
is one rank, whose collectives return their input.

Search: the index rows shard over ``data``, queries replicate; each rank
runs the port's single-device kernel path on its rows, adds its first
row to the ids, pads its (nq, k) list with (+inf, -1) and all-gathers
it; the lists merge by (score, id) (`utils.topk_lowest_id`) and the
flags are OR-ed. The packed scans truncate scores by ``idbits``, which
depends on the rows a call scans, so a shard keeps more score bits than
the single-device scan and the merged result may differ from it on
near-ties, by one truncation step, as in the JAX package; ``pack=False``
is exact.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
import torch.distributed as dist

from rayuela_tpu_torch.utils import (Ranks, as_tensor, cdiv, splitarray,
                                     topk_lowest_id)

AXES = ("data", "model")


class Mesh:
    """A ``(data, model)`` mesh over the ranks of the process group (or
    one rank without one): the rank's ``device``, its ``coords`` along
    each axis and the axis sizes ``shape`` (``mesh.shape["data"]``, as
    in JAX). ``device_mesh`` is the `torch.distributed.DeviceMesh`
    whose per-axis groups the collectives use (None for one rank
    without a process group)."""

    def __init__(self, shape: dict, device, coords: dict,
                 device_mesh=None):
        self.shape = dict(shape)
        self.device = torch.device(device)
        self.coords = dict(coords)
        self.device_mesh = device_mesh
        self._groups = {}

    def group(self, axis: str):
        """The process group of ``axis`` (looked up once: the trainers
        issue a collective a k-means++ pick)."""
        if self.device_mesh is None:
            return None
        if axis not in self._groups:
            self._groups[axis] = self.device_mesh.get_group(axis)
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, coords={self.coords}, "
                f"device={self.device})")


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device=None) -> Mesh:
    """Build a ``(data, model)`` mesh over all ranks
    (`torch.distributed.device_mesh.init_device_mesh`, dims ``("data",
    "model")``); ``n_data`` defaults to the world size over ``n_model``,
    and the mesh must cover the world. ``device`` is where this rank's
    tensors live: the card by default (``cuda:<rank % cards>`` under
    NCCL), ``"cpu"`` for gloo ranks on the CPU. Without a process group
    the mesh is this one rank (``n_data * n_model`` must be 1)."""
    if not (dist.is_available() and dist.is_initialized()):
        if (n_data or 1) * n_model != 1:
            raise ValueError("a mesh of more than one rank needs a process "
                             "group (`launch.initialize`)")
        return Mesh({"data": 1, "model": 1},
                    "cuda" if device is None else device,
                    {"data": 0, "model": 0})
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) must cover the "
                         f"world of {world} ranks")
    backend = dist.get_backend()
    if device is None:
        device = (f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
                  if backend == "nccl" else "cuda")
    # the DeviceMesh's device type only places DTensors, which nothing
    # here uses; "cpu" keeps it from choosing a card for gloo ranks
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          (n_data, n_model), mesh_dim_names=AXES)
    return Mesh({"data": n_data, "model": n_model}, device,
                {a: dm.get_local_rank(a) for a in AXES}, dm)


# ---------------------------------------------------------------------------
# The collectives: every communication of the package goes through these
# ---------------------------------------------------------------------------

def _through_host(mesh: Mesh, t: torch.Tensor, axis: str) -> bool:
    return t.is_cuda and dist.get_backend(mesh.group(axis)) == "gloo"


def _all_reduce(mesh: Mesh, t: torch.Tensor, axis: str = "data"
                ) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis`` (a new tensor; every
    rank gets the same bits)."""
    group = mesh.group(axis)
    if group is None:
        return t
    host = _through_host(mesh, t, axis)
    out = t.detach().to("cpu" if host else t.device, copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device) if host else out


def _all_gather(mesh: Mesh, t: torch.Tensor, axis: str = "data"
                ) -> list[torch.Tensor]:
    """Every rank's ``t`` along ``axis``, in rank order; the tensors
    must have one shape."""
    group = mesh.group(axis)
    if group is None:
        return [t]
    host = _through_host(mesh, t, axis)
    src = t.detach().contiguous()
    src = src.cpu() if host else src
    out = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if host else out


def _any(mesh: Mesh, flags: torch.Tensor, axis: str = "data"
         ) -> torch.Tensor:
    """The OR of boolean ``flags`` over the ranks of ``axis``."""
    return _all_reduce(mesh, flags.to(torch.int32), axis) > 0


# ---------------------------------------------------------------------------
# Row sharding
# ---------------------------------------------------------------------------

class RowShard(NamedTuple):
    """One rank's rows of a row-sharded array: ``local``, the global
    index of its first row ``start``, the global row count ``n``, along
    ``axis``."""
    local: torch.Tensor
    start: int
    n: int
    axis: int = 0


def shard_data(mesh: Mesh, x, axis: int = 0) -> RowShard:
    """This rank's rows of the global ``x`` along ``axis`` over the
    ``data`` axis (``splitarray(n, P)[r]``, a view of ``x`` on the
    mesh's device)."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    st, sz = splitarray(n, mesh.shape["data"])[mesh.coords["data"]]
    return RowShard(x.narrow(axis, st, sz).to(mesh.device), st, n, axis)


def replicate(mesh: Mesh, x) -> torch.Tensor:
    """``x`` (the same on every rank) on the mesh's device."""
    return torch.as_tensor(x).to(mesh.device)


def pad_to_multiple(x: torch.Tensor, mult: int, axis: int = 0, fill=0):
    """Pad ``x`` along ``axis`` to a multiple of ``mult`` → ``(padded,
    n)``. The sharded functions need no padding (shards may be uneven);
    kept for the JAX contract."""
    n = x.shape[axis]
    pad = -n % mult
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], axis), n


def _rows(mesh: Mesh, x, dtype=None) -> RowShard:
    """``x`` as this rank's rows (a `RowShard` passes through)."""
    if isinstance(x, RowShard):
        if x.axis != 0:
            raise ValueError("the sharded functions shard axis 0")
        local = x.local.to(mesh.device)
        return RowShard(local if dtype is None else local.to(dtype),
                        x.start, x.n)
    rs = shard_data(mesh, x)
    return rs if dtype is None else rs._replace(local=rs.local.to(dtype))


def _same_rows(a: RowShard, b: RowShard) -> None:
    if (a.start, a.n, a.local.shape[0]) != (b.start, b.n, b.local.shape[0]):
        raise ValueError("row-sharded arguments must hold the same rows")


def _like(mesh: Mesh, x, out: torch.Tensor, rows: RowShard):
    """A per-row result ``out`` of this rank's ``rows`` in the form the
    rows came in: a `RowShard`, or the global array gathered from the
    ``data`` ranks (`_gather_rows`)."""
    if isinstance(x, RowShard):
        return RowShard(out, rows.start, rows.n)
    return _gather_rows(mesh, RowShard(out, rows.start, rows.n),
                        [sz for _, sz in splitarray(rows.n,
                                                    mesh.shape["data"])])


def _ranks(mesh: Mesh, rows: RowShard) -> Ranks:
    """The ``data`` ranks over which ``rows`` are spread, as the
    trainers take them (`utils.Ranks`): the all-reduce and all-gather
    over ``data``, this rank's place, its first row and the row
    count."""
    return Ranks(partial(_all_reduce, mesh), partial(_all_gather, mesh),
                 mesh.coords["data"], rows.start, rows.n)


def _gather_rows(mesh: Mesh, rows: RowShard,
                 sizes: list[int] | None = None) -> torch.Tensor:
    """The global array of which every ``data`` rank holds ``rows``, on
    every rank: the shares, of the ``sizes`` in rank order (all-gathered
    where None: shares of any size, `launch.host_local_to_global`),
    padded to one size for the all-gather."""
    if sizes is None:
        sizes = [int(s) for s in _all_gather(mesh, torch.tensor(
            [rows.local.shape[0]], device=mesh.device))]
    out = rows.local
    pad = out.new_zeros((max(sizes) - out.shape[0],) + tuple(out.shape[1:]))
    parts = _all_gather(mesh, torch.cat([out, pad]))
    return torch.cat([p[:sz] for p, sz in zip(parts, sizes)])


def _merge(mesh: Mesh, s: torch.Tensor, i: torch.Tensor, k: int):
    """Merge the ranks' top-k lists ``(s (nq, k_r), i (nq, k_r))``
    (global ids): each padded with (+inf, -1) to k columns, the scores'
    bits and the ids stacked into one (2, nq, k) int32 tensor for one
    all-gather over ``data``, then the k smallest by (score, id)."""
    nq = s.shape[0]
    pad = k - s.shape[1]
    s = torch.cat([s.float(), s.new_full((nq, pad), float("inf"),
                                         dtype=torch.float32)], 1)
    i = torch.cat([i.to(torch.int32), i.new_full((nq, pad), -1,
                                                 dtype=torch.int32)], 1)
    parts = _all_gather(mesh, torch.stack([s.view(torch.int32), i]))
    cs = torch.cat([p[0].view(torch.float32) for p in parts], 1)
    ci = torch.cat([p[1] for p in parts], 1)
    v, ids = topk_lowest_id(cs, k, ci)
    return v, ids.to(torch.int32)


# ---------------------------------------------------------------------------
# The sharded searches
# ---------------------------------------------------------------------------

def sharded_scan_topk(mesh: Mesh, Q, C, B, *, k: int, pq: bool = False,
                      norm_term=None, tile: int = 1 << 14):
    """Data-parallel exact ADC scan (`linscan.scan_topk` on each rank's
    codes, library calls) → ``(dists (nq, k) f32 with +|q|^2, ids (nq, k)
    int32)``: the exact top-k, the lowest id among equal scores (the
    global top-k lies in the union of the ranks' top-k). ``B`` (and
    ``norm_term``) row-sharded; ``Q``, ``C`` replicated."""
    from rayuela_tpu_torch.search.linscan import scan_topk

    rows = _rows(mesh, B, torch.int32)
    nt = None
    if norm_term is not None:
        nt = _rows(mesh, norm_term, torch.float32)
        _same_rows(rows, nt)
        nt = nt.local
    k = min(k, rows.n)
    s, i = scan_topk(as_tensor(Q, mesh.device), as_tensor(C, mesh.device),
                     rows.local, k=min(k, rows.local.shape[0]), pq=pq,
                     norm_term=nt, tile=tile)
    return _merge(mesh, s, i + rows.start, k)


def _merged(mesh: Mesh, rows: RowShard, k: int, part):
    s, i, fl = part
    return (*_merge(mesh, s, i + rows.start, k), _any(mesh, fl))


def sharded_search(mesh: Mesh, Xd, x2, Q, *, k: int, r: int | None = None,
                   bq: int | None = None, tile: int | None = None,
                   interpret: bool = False, pack: bool | None = None):
    """Data-parallel search of a decoded index → ``(dists (nq, k) f32
    with +|q|^2, ids (nq, k) int32, flagged (nq,) bool)``. ``Xd (n, dp)``
    and ``x2 (n,)`` row-sharded, ``Q`` replicated. Each rank runs
    `scan.search_flagged` on its rows: K8 → K2 → K3 (in segments beyond
    the packed row-id range), or with ``pack=False`` K9 → pair merge →
    K10 (the exact-float scan), at the plan of its ``min(k, rows)``;
    ``r``/``tile`` replace the plan's. Flagged queries (on any rank)
    re-run exactly through `sharded_search_exact`. ``bq`` and
    ``interpret`` are the TPU kernel's blocking and emulation and have
    no effect here (CPU tensors take the plain versions)."""
    from rayuela_tpu_torch.search.scan import search_flagged

    X = _rows(mesh, Xd)
    x2r = _rows(mesh, x2, torch.float32)
    _same_rows(X, x2r)
    k = min(k, X.n)
    Q = as_tensor(Q, mesh.device)
    Q = torch.nn.functional.pad(Q, (0, X.local.shape[1] - Q.shape[1]))
    return _merged(mesh, X, k, search_flagged(
        X.local, x2r.local, Q, min(k, X.local.shape[0]), r=r, tile=tile,
        pack=pack))


def sharded_search_exact(mesh: Mesh, Xd, x2, Q, *, C=None, B=None,
                         pq: bool = False, norm_term=None, k: int, **kw):
    """`sharded_search`, then the single-device contract: the queries a
    certificate flags re-run exactly, through `sharded_scan_topk` over
    the codes (``C``, ``B``, ``norm_term``) where given, else through an
    exact rescan of each rank's decoded rows, merged again. Returns
    ``(dists, ids)``."""
    from rayuela_tpu_torch.search.linscan import exact_rescan

    d, i, fl = sharded_search(mesh, Xd, x2, Q, k=k, **kw)
    if bool(fl.any()):
        qidx = torch.nonzero(fl).flatten()
        Qf = as_tensor(Q, mesh.device)[qidx]
        kk = d.shape[1]
        if C is not None and B is not None:
            d2, i2 = sharded_scan_topk(mesh, Qf, C, B, k=kk, pq=pq,
                                       norm_term=norm_term)
        else:
            X = _rows(mesh, Xd)
            x2r = _rows(mesh, x2, torch.float32)
            Qp = torch.nn.functional.pad(Qf, (0, X.local.shape[1]
                                              - Qf.shape[1]))
            s, ii = exact_rescan(Qp, X.local, x2r.local,
                                 min(kk, X.local.shape[0]))
            d2, i2 = _merge(mesh, s, ii + X.start, kk)
        d[qidx], i[qidx] = d2, i2
    return d, i


def _lut_exact(T: torch.Tensor, packed: torch.Tensor, k: int, lut_dtype,
               seg: int = 1 << 19, qblock: int = 128):
    """The exact tiled LUT scan of per-query tables ``T (m', h, nq)``
    over packed codes (`scan_codes.lut_scan` in bounded blocks) →
    ``(scores without +|q|^2, ids, flagged=False)``."""
    from rayuela_tpu_torch.search.scan_codes import _lut_sums, unpack_codes
    from rayuela_tpu_torch.utils import tiled_topk

    mprime, nq = T.shape[0], T.shape[2]

    def score_tile(q0, q1, st, stop):
        return _lut_sums(T[:, :, q0:q1], unpack_codes(packed[st:stop],
                                                      mprime), lut_dtype)

    s, i = tiled_topk(nq, packed.shape[0], seg, k, score_tile, qblock)
    return s, i, torch.zeros(nq, dtype=torch.bool, device=T.device)


def _sharded_lut_exact(mesh: Mesh, T, packed, k: int, lut_dtype=None):
    """The exact LUT scan of per-query tables ``T (m', h, nq)`` over
    row-sharded packed codes → ``(scores (nq, k) without +|q|^2, ids)``:
    each rank scans its rows in bounded blocks, and the lists merge. The
    rescue of the queries `sharded_search_codes` flags."""
    P = _rows(mesh, packed, torch.int32)
    T = as_tensor(T, mesh.device)
    k = min(k, P.n)
    s, i, _ = _lut_exact(T, P.local, min(k, P.local.shape[0]),
                         _op_dtype(lut_dtype, mesh.device))
    return _merge(mesh, s, i + P.start, k)


def _op_dtype(dtype, device):
    if dtype is not None:
        return dtype
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def sharded_search_codes(mesh: Mesh, T, packed, *, k: int,
                         r: int | None = None, bq: int | None = None,
                         tile: int | None = None, lut_dtype=None,
                         interpret: bool = False, pack: bool | None = None):
    """Data-parallel LUT search of packed codes → ``(scores (nq, k) f32
    without +|q|^2, ids (nq, k) int32, flagged (nq,) bool)``. ``T (m',
    h, nq)`` from `scan_codes.build_luts` replicated, ``packed`` (the
    `pack_codes` words) row-sharded. Each rank runs
    `scan_codes.scan_codes_topk` on its rows: K5 → K2 → K3 (in segments
    beyond the packed row-id range), or with ``pack=False`` K6 → pair
    merge → K7, at the plan of its ``min(k, rows)``; a k beyond the plan
    is the exact tiled LUT scan. ``lut_dtype`` rounds the table values
    (bfloat16 on the card, float32 on the CPU by default); ``bq`` and
    ``interpret`` have no effect here."""
    from rayuela_tpu_torch.search import scan, scan_codes

    P = _rows(mesh, packed, torch.int32)
    dev = mesh.device
    T = as_tensor(T, dev)
    lut_dtype = _op_dtype(lut_dtype, dev)
    f32 = pack is not None and not pack
    k = min(k, P.n)
    nl = P.local.shape[0]
    kl = min(k, nl)
    kind, pr, pkeep, ptile = scan_codes._codes_config(
        kl, "lut", nl, dev if f32 else None)
    if kind == "lut":
        return _merged(mesh, P, k, _lut_exact(T, P.local, kl, lut_dtype))
    r = pr if r is None else r
    keep = pkeep
    tile = ptile if tile is None else tile
    per_query = (scan._f32_bytes_per_query(nl, r, tile, keep) if f32 else
                 cdiv(min(nl, scan_codes._DECODE_SEG), tile) * max(keep, 1)
                 * scan.LANES * 4)

    def scan_one(st, stop, kseg):
        parts = [scan_codes.scan_codes_topk(
            T[:, :, a:b], P.local[st:stop], k=kseg, r=r, tile=tile,
            keep=keep, lut_dtype=lut_dtype, pack=not f32)
            for a, b in scan._query_chunks(T.shape[2], per_query)]
        return tuple(torch.cat(p) for p in zip(*parts))

    if not f32 and nl > scan_codes._DECODE_SEG:
        part = scan.segments_topk(nl, scan_codes._DECODE_SEG, kl, scan_one)
    else:
        part = scan_one(0, nl, kl)
    return _merged(mesh, P, k, part)


def sharded_search_codes_decode(mesh: Mesh, Q, C, packed, *, k: int,
                                pq: bool, d: int | None = None,
                                norms_cbook=None, r: int | None = None,
                                bq: int | None = None,
                                tile: int | None = None,
                                keep: int | None = None, op_dtype=None,
                                interpret: bool = False,
                                qsuper: int | None = None):
    """Data-parallel code-resident search that decodes in the kernel →
    ``(scores (nq, k) f32 without +|q|^2, ids (nq, k) int32, flagged
    (nq,) bool)``. ``Q``, ``C`` (and ``norms_cbook``) replicated,
    ``packed`` row-sharded. Each rank runs the one-pass scan
    `scan_codes.scan_codes_decode_topk` on its rows, as the JAX package
    runs its one-pass kernel: K14 (``keep > 0``) or K4 (``keep=0``) → K3
    (in segments beyond the packed row-id range), at the one-pass plan
    of its ``min(k, rows)`` (`scan_codes._onepass_config`) for what is
    not given. ``op_dtype`` is the operands' (bfloat16 on the card,
    float32 on the CPU by default); ``qsuper`` is checked as the JAX
    package checks it; ``bq`` and ``interpret`` have no effect here."""
    from rayuela_tpu_torch.search import scan, scan_codes

    dev = mesh.device
    Q = as_tensor(Q, dev)
    C = as_tensor(C, dev)
    d = Q.shape[1] if d is None else d
    op_dtype = _op_dtype(op_dtype, dev)
    ncb = None if norms_cbook is None else as_tensor(norms_cbook, dev)
    Cf, nrm = scan_codes.build_decode_operands(C, pq=pq, d=d,
                                               norms_cbook=ncb,
                                               op_dtype=op_dtype)
    P = _rows(mesh, packed, torch.int32)
    k = min(k, P.n)
    nl = P.local.shape[0]
    kl = min(k, nl)
    pr, pkeep, ptile = scan_codes._onepass_config(
        kl, C.shape[0] + (ncb is not None))
    r = pr if r is None else r
    keep = pkeep if keep is None else keep
    tile = ptile if tile is None else tile
    per_query = (2 * r + 1) * scan.LANES * 4

    def scan_one(st, stop, kseg):
        parts = [scan_codes.scan_codes_decode_topk(
            Q[a:b], Cf, nrm, P.local[st:stop], k=kseg, pq=pq, r=r,
            tile=tile, keep=keep, qsuper=qsuper or 1)
            for a, b in scan._query_chunks(Q.shape[0], per_query)]
        return tuple(torch.cat(p) for p in zip(*parts))

    if nl > scan_codes._DECODE_SEG:
        part = scan.segments_topk(nl, scan_codes._DECODE_SEG, kl, scan_one)
    else:
        part = scan_one(0, nl, kl)
    return _merged(mesh, P, k, part)


# ---------------------------------------------------------------------------
# The PQ Lloyd step over both axes
# ---------------------------------------------------------------------------

def pq_lloyd_step_sharded(mesh: Mesh, Xs, centers, h: int):
    """One Lloyd step of all m subspace quantizers at once → ``(centers
    (m, h, ds), objective)``, the global results on every rank.
    ``Xs (m, n, ds)`` and ``centers (m, h, ds)`` are the global arrays
    (the same on every rank): n splits over ``data``, m over ``model``.
    Each rank assigns its rows of its subspaces; the counts, sums and
    objective are all-reduced over ``data``; an empty cluster takes the
    most costly points of the whole subspace (`kmeans.update_centers`
    over the ``data`` ranks, its subspaces at once: each rank's
    costliest h points all-gathered, ranked by (cost, global row)); the
    subspaces all-gather over ``model``. The mesh comes first here, where the JAX
    step reads it from its arguments' shardings."""
    from rayuela_tpu_torch.ops.kmeans import assign, update_centers

    Xs = torch.as_tensor(Xs).to(mesh.device)
    centers = torch.as_tensor(centers).to(mesh.device)
    m, n, ds = Xs.shape
    msplit = splitarray(m, mesh.shape["model"])
    ms, msz = msplit[mesh.coords["model"]]
    ns, nsz = splitarray(n, mesh.shape["data"])[mesh.coords["data"]]
    X = Xs[ms:ms + msz, ns:ns + nsz]
    cent = centers[ms:ms + msz]
    a, mind2 = assign(X, cent)
    new = update_centers(X, a, h, cent, costs=mind2,
                         ranks=_ranks(mesh, RowShard(X, ns, n, 1)))
    obj = _all_reduce(mesh, _all_reduce(mesh, mind2.sum()), "model")
    big = max(sz for _, sz in msplit)
    padded = torch.cat([new, new.new_zeros(big - msz, h, ds)])
    parts = _all_gather(mesh, padded, "model")
    full = torch.cat([p[:sz] for p, (_, sz) in zip(parts, msplit)])
    return full, obj / (m * n)
