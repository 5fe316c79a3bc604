"""Facade: train / index / search in three calls (counterpart of
`rayuela_tpu/api.py`):

    import rayuela_tpu_torch.api as rq
    model = rq.train(Xt, method="sr_d", m=7, h=256)
    index = rq.index_base(model, Xb)            # or mode="codes"
    dists, ids = rq.search(index, Q, k=100)

Every entry point runs on the card unless the caller asks for the CPU:
a tensor stays on its device, a numpy array goes to ``"cuda"`` (and
where there is no card that raises), and ``device="cpu"`` asks for the
CPU, where the kernels' plain versions run.

All nine methods of `METHODS`: PQ, OPQ, RVQ, ERVQ (RVQ fine-tuned),
CompQ (RVQ init, then beam-search training) and ChainQ and the LSQ
family (LSQ, SR-C, SR-D) through the staged OPQ → ChainQ init, served
from the decoded index (``mode="decoded"``, the default: the base
decoded once, bfloat16 on the card) or the code-resident one
(``mode="codes"``: ~m bytes per vector, scanned by decoding or, with
``search(..., mode="lut")``, through per-query tables);
`search_streamed` serves packed codes that stay in host memory.
`save_model` / `load_model` / `save_index` / `load_index` keep the JAX
package's HDF5 layout, so a file that either package wrote loads in the
other. ``mesh=`` (a `rayuela_tpu_torch.parallel.make_mesh` result, every
rank of the process group calling with the same arguments) trains and
searches over several GPUs (`rayuela_tpu_torch.parallel`). The
defaults are the JAX facade's (``method="sr_d"``, ``mode="decoded"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from rayuela_tpu_torch.utils import as_tensor, exact_f32

METHODS = ("pq", "opq", "rvq", "ervq", "chainq", "lsq", "sr_c", "sr_d",
           "compq")
PORTED = METHODS
_ORTHOGONAL = ("pq", "opq")
_ROTATED = ("opq", "chainq")      # search rotates the queries by R


@dataclass
class MCQModel:
    """A trained quantizer: codebooks + method metadata."""
    method: str
    codebooks: torch.Tensor          # (m, h, d*) f32
    R: torch.Tensor | None = None    # rotation (OPQ / ChainQ)
    h: int = 256
    train_codes: torch.Tensor | None = None
    extras: dict = field(default_factory=dict)

    @property
    def pq_layout(self) -> bool:
        return self.method in _ORTHOGONAL


@dataclass
class MCQIndex:
    """A searchable base set: codes + scan index + norms. ``mode`` is
    ``"decoded"`` (scan_index a `scan.LinscanIndex`) or ``"codes"``
    (a `scan_codes.CodesIndex`, ~m bytes per vector)."""
    model: MCQModel
    codes: torch.Tensor              # (n, m) int32
    scan_index: Any                  # LinscanIndex | CodesIndex
    norms_codebook: torch.Tensor | None = None
    norm_codes: torch.Tensor | None = None
    mode: str = "decoded"


def _check_method(method: str) -> str:
    method = method.lower()
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    return method


def train(Xt, method: str = "sr_d", m: int = 8, h: int = 256,
          niter: int = 25, seed: int = 0, device=None,
          mesh=None, **kw) -> MCQModel:
    """Train a quantizer on ``Xt (n, d)``. ``device`` defaults to
    ``Xt``'s when it is a tensor and to the card otherwise
    (``device="cpu"`` asks for the CPU). ERVQ fine-tunes an RVQ model,
    CompQ trains from one; ChainQ and the LSQ family follow the
    reference pipeline: OPQ → ChainQ → {chainq | lsq | sr_c | sr_d};
    ``kw`` goes to the last stage's trainer.

    With ``mesh`` (every rank of the process group making the same call;
    the model lives on the mesh's device) every method trains data-parallel
    over the mesh's ``data`` ranks: the same trainers, given the ranks
    (`utils.Ranks`; the LSQ family's last stage
    `parallel.train_lsq_family_sharded`). ``Xt`` is then the
    global array on every rank, of which each rank trains on its rows, or
    a `parallel.mesh.RowShard` of the rank's own rows
    (`parallel.host_local_to_global`), so that no rank holds the whole
    training set. Each rank trains on its rows with the statistics
    (counts, sums, objectives, normal equations, the rotation's ``X^T
    X_hat``) all-reduced and every solve replicated, so every rank holds
    the same codebooks; ``train_codes`` is the global (n, m) array on
    every rank. The result equals the single-device one to the order of
    the sums; the k-means seeding draws over all ranks' rows
    (`ops.kmeans.kmeanspp_spread`), not as the single-device
    `torch.multinomial` does. The JAX package shards ``Xt`` and lets its
    compiler place the same collectives."""
    from rayuela_tpu_torch.models.chainq import train_chainq
    from rayuela_tpu_torch.models.compq import train_compq
    from rayuela_tpu_torch.models.ervq import train_ervq_from_scratch
    from rayuela_tpu_torch.models.lsq import train_lsq
    from rayuela_tpu_torch.models.opq import train_opq
    from rayuela_tpu_torch.models.pq import train_pq
    from rayuela_tpu_torch.models.rvq import train_rvq
    from rayuela_tpu_torch.models.sr import train_sr

    method = _check_method(method)
    ranks = rows = None
    if mesh is None:
        Xt = as_tensor(Xt, device)
        gen = torch.Generator(device=Xt.device).manual_seed(seed)
    else:
        from rayuela_tpu_torch.parallel.mesh import _ranks, _rows
        rows = _rows(mesh, Xt, torch.float32)
        Xt, ranks = rows.local, _ranks(mesh, rows)
        gen = torch.Generator(device=mesh.device).manual_seed(seed)

    def done(codebooks, B, R=None):
        if mesh is not None:
            from rayuela_tpu_torch.parallel.mesh import _gather_rows
            B = _gather_rows(mesh, rows._replace(local=B))
        return MCQModel(method, codebooks, R=R, h=h, train_codes=B)

    if method == "pq":
        model, B, _ = train_pq(gen, Xt, m, h, iters=niter, ranks=ranks, **kw)
        return done(model.codebooks, B)
    if method == "rvq":
        model, B, _ = train_rvq(gen, Xt, m, h, niter=niter, ranks=ranks,
                                **kw)
        return done(model.codebooks, B)
    if method == "ervq":
        model, B, _ = train_ervq_from_scratch(gen, Xt, m, h, niter=niter,
                                              ranks=ranks, **kw)
        return done(model.codebooks, B)
    if method == "compq":
        rvq, B0, _ = train_rvq(gen, Xt, m, h, niter=niter, ranks=ranks)
        model, B, _ = train_compq(Xt, rvq.codebooks, B0, niter=niter,
                                  ranks=ranks, **kw)
        return done(model.codebooks, B)
    if method == "opq":
        model, B, _ = train_opq(gen, Xt, m, h, niter=niter, ranks=ranks,
                                **kw)
        return done(model.codebooks, B, model.R)
    opq, B0, _ = train_opq(gen, Xt, m, h, niter=niter, ranks=ranks)
    if method == "chainq":
        model, B, _ = train_chainq(Xt, B0, opq.R, h=h, niter=niter,
                                   ranks=ranks, **kw)
        return done(model.codebooks, B, model.R)
    cq, B1, _ = train_chainq(Xt, B0, opq.R, h=h, niter=niter, ranks=ranks)
    if mesh is not None:
        from rayuela_tpu_torch.parallel import train_lsq_family_sharded
        model, B, _ = train_lsq_family_sharded(
            mesh, gen, rows, rows._replace(local=B1), cq.R, h=h,
            niter=niter, method=method.upper(), **kw)
        B = B.local
    elif method == "lsq":
        model, B, _ = train_lsq(gen, Xt, B1, cq.R, h=h, niter=niter, **kw)
    else:
        model, B, _ = train_sr(gen, Xt, B1, cq.R, h=h, niter=niter,
                               method=method.upper(), **kw)
    return done(model.codebooks, B)


def encode(model: MCQModel, X, gen=None, **kw) -> torch.Tensor:
    """Encode vectors with a trained model → (n, m) int32. RVQ and ERVQ
    encode greedily, CompQ by its beam search (``kw``: ``H``,
    ``chunk``). The LSQ family starts from the greedy RVQ encode and
    runs ILS/ICM at the base budget (``ilsiter=32`` unless ``kw`` says
    otherwise), drawing from ``gen`` (a generator on X's device; seeded
    with 1 if None); ``impl="pallas-ils"`` runs all rounds in one
    whole-ILS kernel launch (`ops.icm.encoding_icm`)."""
    from rayuela_tpu_torch.models.chainq import ChainQModel, quantize_chainq
    from rayuela_tpu_torch.models.compq import quantize_compq
    from rayuela_tpu_torch.models.opq import OPQModel, quantize_opq
    from rayuela_tpu_torch.models.pq import PQModel, quantize_pq
    from rayuela_tpu_torch.models.rvq import quantize_rvq
    from rayuela_tpu_torch.ops.icm import encoding_icm

    method = _check_method(model.method)
    X = as_tensor(X, model.codebooks.device)
    if method == "pq":
        return quantize_pq(PQModel(model.codebooks), X)
    if method == "opq":
        return quantize_opq(OPQModel(model.codebooks, model.R), X)
    if method in ("rvq", "ervq"):
        return quantize_rvq(model.codebooks, X)[0]
    if method == "compq":
        return quantize_compq(model.codebooks, X, **kw)[0]
    if method == "chainq":
        return quantize_chainq(ChainQModel(model.codebooks, model.R), X)
    if gen is None:
        gen = torch.Generator(device=X.device).manual_seed(1)
    B0, _ = quantize_rvq(model.codebooks, X)
    kw.setdefault("ilsiter", 32)
    return encoding_icm(gen, X, model.codebooks, B0, **kw)


def index_base(model: MCQModel, Xb, mode: str = "decoded",
               seed: int = 2, **kw) -> MCQIndex:
    """Encode the base set on the model's device (``kw`` goes to
    `encode`) and build the scan index: ``mode="decoded"`` the base
    decoded once (bfloat16 on the card), ``mode="codes"`` the packed
    codes. A non-orthogonal model with its ``train_codes`` gets the norms
    byte (its codebook has 256 entries, capped at h for
    ``mode="codes"`` so that it stacks with the per-codebook tables);
    without them (a model carried over by `convert.model_from_arrays`)
    the decoded index keeps the exact |x_hat|^2, and ``mode="codes"``
    raises in `build_codes_index`, as in the JAX facade. One generator
    seeded with ``seed`` serves the encode and the norms codebook."""
    from rayuela_tpu_torch.search.norms import (get_norms_codebook,
                                                quantize_norms)
    from rayuela_tpu_torch.search.scan import build_index
    from rayuela_tpu_torch.search.scan_codes import build_codes_index

    if mode not in ("decoded", "codes"):
        raise ValueError(f"mode {mode!r}: 'decoded' or 'codes'")
    Xb = as_tensor(Xb, model.codebooks.device)
    gen = torch.Generator(device=Xb.device).manual_seed(seed)
    B = encode(model, Xb, gen=gen, **kw)
    norms_cb = norm_codes = None
    if not model.pq_layout and model.train_codes is not None:
        nh = min(256, model.h) if mode == "codes" else 256
        _, norms_cb = get_norms_codebook(gen, model.codebooks,
                                         model.train_codes, h=nh)
        norm_codes, _ = quantize_norms(model.codebooks, B, norms_cb)
    if mode == "codes":
        idx = build_codes_index(model.codebooks, B, pq=model.pq_layout,
                                d=Xb.shape[1], norms_cbook=norms_cb,
                                norms_codes=norm_codes)
    else:
        nt = None if norms_cb is None else norms_cb[norm_codes.long()]
        idx = build_index(model.codebooks, B, pq=model.pq_layout,
                          d=Xb.shape[1], norm_term=nt)
    return MCQIndex(model, B, idx, norms_cb, norm_codes, mode=mode)


def search(index: MCQIndex, Q, k: int = 100, mesh=None,
           **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k search on the index's device → ``(dists (nq, k) f32 with
    +|q|^2, ids (nq, k) int32)``: the exact top-k of the scan's
    truncated scores (bfloat16 operands on the card, float32 on the
    CPU). OPQ and ChainQ queries are rotated by the model's R first.
    ``kw`` goes to `scan.search` (decoded) or `scan_codes.search_codes`
    (codes; ``mode="lut"`` picks the table scan, ``twopass=False``,
    ``stage`` or an explicit ``r``/``keep``/``tile`` the one-pass decode
    scan, as in the JAX package). ``pack=False`` asks
    for the exact-float scan: the exact top-k of the untruncated f32
    scores, the lowest id among equal ones (decoded index, or codes with
    ``mode="lut"``).

    With ``mesh`` every rank passes the global index and scans its own
    row range of it (a view), and the ranks' lists merge, as in the JAX
    package: a codes index by the LUT scan
    (`parallel.sharded_search_codes`; ``lut_dtype`` or ``op_dtype``
    rounds the tables), its flagged queries through the exact tiled LUT
    scan of each rank's rows; a decoded index by
    `parallel.mesh.sharded_search_exact`, its flagged queries through
    the exact rescan of each rank's decoded rows, the single-device
    search's rescue. (The JAX package rescues them from the codes, which
    spares it a gather of the decoded rows; a rank here rescans its own
    rows, which gathers nothing and on the card takes a quarter of the
    codes rescue's time.)"""
    from rayuela_tpu_torch.search import scan, scan_codes

    model = index.model
    _check_method(model.method)
    Q = as_tensor(Q, model.codebooks.device)
    if model.method in _ROTATED:
        exact_f32()
        Q = Q @ model.R
    if mesh is not None:
        return _search_sharded(mesh, index, Q, k, **kw)
    if index.mode == "codes":
        return scan_codes.search_codes(index.scan_index, Q, k, **kw)
    return scan.search(index.scan_index, Q, k, **kw)


def _search_sharded(mesh, index: MCQIndex, Q, k: int, **kw):
    """``mesh=`` path of `search` (``Q`` already rotated)."""
    from rayuela_tpu_torch.parallel import mesh as pmesh
    from rayuela_tpu_torch.search import scan_codes

    k = min(k, index.scan_index.n)
    if index.mode == "codes":
        ix = index.scan_index
        kw.pop("mode", None)
        lut_dtype = kw.pop("lut_dtype", kw.pop("op_dtype", None))
        d = Q.shape[1] if ix.d in (-1, None) else ix.d
        T = scan_codes.build_luts(ix.C, Q, pq=ix.pq, d=d,
                                  norms_cbook=ix.norms_cbook)
        s, i, fl = pmesh.sharded_search_codes(mesh, T, ix.packed, k=k,
                                              lut_dtype=lut_dtype, **kw)
        if bool(fl.any()):
            qidx = torch.nonzero(fl).flatten()
            s[qidx], i[qidx] = pmesh._sharded_lut_exact(
                mesh, T[:, :, qidx], ix.packed, k, lut_dtype)
        return s + (Q * Q).sum(-1, keepdim=True), i
    return pmesh.sharded_search_exact(mesh, index.scan_index.Xd,
                                      index.scan_index.x2, Q, k=k, **kw)


def search_streamed(model: MCQModel, B_packed, Q, k: int = 100,
                    norms_cbook=None, mprime: int | None = None,
                    shard_n: int = 100_000_000,
                    **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k search over a base too large for the device: the packed
    codes ``B_packed`` (`scan_codes.pack_codes` layout, the norms byte
    included for additive models) stay in host memory, a numpy array or
    an ``np.memmap`` over a code file, and stream through the model's
    device ``shard_n`` rows at a time with an exact merge; the next
    shard's copy runs behind the current shard's scan
    (`scan_codes.search_codes_streamed`, where ``kw`` goes). OPQ and
    ChainQ queries are rotated by the model's R first, as in `search`."""
    from rayuela_tpu_torch.search import scan_codes

    _check_method(model.method)
    Q = as_tensor(Q, model.codebooks.device)
    if model.method in _ROTATED:
        exact_f32()
        Q = Q @ model.R
    return scan_codes.search_codes_streamed(
        model.codebooks, B_packed, Q, k, pq=model.pq_layout,
        norms_cbook=norms_cbook, mprime=mprime, shard_n=shard_n, **kw)


# ---------------------------------------------------------------------------
# Persistence: the JAX package's HDF5 layout
# ---------------------------------------------------------------------------
#
# A model is the group ``model``: attributes ``method`` and ``h``,
# datasets ``codebooks`` (f32), ``R`` (f32, OPQ / ChainQ) and
# ``train_codes`` (uint8 for h <= 256, else int32). An index adds, at the
# root, ``codes`` (as the training codes), ``norms_codebook`` (f32) and
# ``norm_codes`` (uint8), and the attributes ``mode`` and ``d`` (the
# true width). The scan structures are rebuilt on load. In memory the
# layout is a dict of numpy arrays and attributes keyed by their path in
# the file, an attribute's name marked with ``@`` (`saved_model`,
# `saved_index`); the HDF5 functions only move such a dict, so the
# card's machine, which has no h5py, runs everything else.

_NUMPY = {torch.float32: np.float32, torch.int32: np.int32}


def _tensor(a, dtype, device):
    # a copy: the arrays may be read-only views (of HDF5 or JAX
    # buffers); the numpy cast widens a bfloat16 array, which torch does
    # not take
    return torch.tensor(np.array(a, dtype=_NUMPY[dtype]), device=device)


def _opt(a, dtype, device):
    return None if a is None else _tensor(a, dtype, device)


def _numpy(t, dtype):
    return None if t is None else t.detach().cpu().numpy().astype(dtype)


def _codes_np(B, h: int) -> np.ndarray:
    return _numpy(B, np.uint8 if h <= 256 else np.int32)


def saved_model(model: MCQModel) -> dict:
    """The arrays and attributes `save_model` writes into the group
    ``model``, keyed by name (``"@method"``, ``"@h"``, ``"codebooks"``,
    ``"R"``, ``"train_codes"``; None where the model has none)."""
    return {"@method": model.method, "@h": int(model.h),
            "codebooks": _numpy(model.codebooks, np.float32),
            "R": _numpy(model.R, np.float32),
            "train_codes": (None if model.train_codes is None else
                            _codes_np(model.train_codes, model.h))}


def saved_index(index: MCQIndex) -> dict:
    """The arrays and attributes `save_index` writes, keyed by their
    path in the file: the model's under ``"model/"``, then ``"codes"``,
    ``"norms_codebook"``, ``"norm_codes"``, ``"@mode"`` and ``"@d"``,
    the index's true width (the decoded base's columns are padded)."""
    return {**{f"model/{k}": v for k, v in saved_model(index.model).items()},
            "codes": _codes_np(index.codes, index.model.h),
            "norms_codebook": _numpy(index.norms_codebook, np.float32),
            "norm_codes": (None if index.norm_codes is None else
                           _codes_np(index.norm_codes, 256)),
            "@mode": index.mode, "@d": int(index.scan_index.d)}


def model_from_saved(saved: dict, device=None) -> MCQModel:
    """`MCQModel` from `saved_model`'s dict on ``device`` (the card
    unless the caller names another)."""
    device = "cuda" if device is None else device
    return MCQModel(str(saved["@method"]),
                    _tensor(saved["codebooks"], torch.float32, device),
                    R=_opt(saved.get("R"), torch.float32, device),
                    h=int(saved["@h"]),
                    train_codes=_opt(saved.get("train_codes"), torch.int32,
                                     device))


def index_from_saved(saved: dict, mode: str | None = None,
                     device=None) -> MCQIndex:
    """`MCQIndex` from `saved_index`'s dict on ``device`` (the card
    unless the caller names another), in the saved layout or ``mode``
    (see `rebuild_index`)."""
    model = model_from_saved({k[6:]: v for k, v in saved.items()
                              if k.startswith("model/")}, device)
    return rebuild_index(model, saved["codes"], saved.get("norms_codebook"),
                         saved.get("norm_codes"), int(saved["@d"]),
                         mode=str(saved["@mode"]) if mode is None else mode)


def rebuild_index(model: MCQModel, codes, norms_codebook, norm_codes,
                  d: int, mode: str = "codes") -> MCQIndex:
    """`MCQIndex` on the model's device from numpy base codes ``(n,
    m)``, norms codebook and norms codes (both None for PQ) and the
    base's width ``d``, in either layout. A norms codebook with more
    entries than the model's h (a decoded index's 256) cannot stack with
    the per-codebook tables of the code-resident index: for
    ``mode="codes"`` it is derived anew at h entries from the codes,
    drawn from a generator seeded with 3, as the JAX package's
    `load_index` does."""
    from rayuela_tpu_torch.search.norms import (get_norms_codebook,
                                                quantize_norms)
    from rayuela_tpu_torch.search.scan import build_index
    from rayuela_tpu_torch.search.scan_codes import build_codes_index

    if mode not in ("decoded", "codes"):
        raise ValueError(f"mode {mode!r}: 'decoded' or 'codes'")
    dev = model.codebooks.device
    B = _tensor(codes, torch.int32, dev)
    ncb = _opt(norms_codebook, torch.float32, dev)
    nco = _opt(norm_codes, torch.int32, dev)
    C, pq = model.codebooks, model.pq_layout
    if mode == "codes":
        if ncb is not None and ncb.numel() > model.h:
            gen = torch.Generator(device=dev).manual_seed(3)
            _, ncb = get_norms_codebook(gen, C, B, h=model.h)
            nco, _ = quantize_norms(C, B, ncb)
        idx = build_codes_index(C, B, pq=pq, d=d, norms_cbook=ncb,
                                norms_codes=nco)
    else:
        nt = None if ncb is None else ncb[nco.long()]
        idx = build_index(C, B, pq=pq, d=d, norm_term=nt)
    return MCQIndex(model, B, idx, ncb, nco, mode=mode)


def _h5_write(f, saved: dict) -> None:
    for key, v in saved.items():
        if v is None:
            continue
        path, _, name = key.rpartition("/")
        g = f.require_group(path) if path else f
        if name.startswith("@"):
            g.attrs[name[1:]] = v
        else:
            g.create_dataset(name, data=v)


def _h5_read(g, prefix: str = "") -> dict:
    import h5py
    out = {f"{prefix}@{k}": v for k, v in g.attrs.items()}
    for k, v in g.items():
        if isinstance(v, h5py.Group):
            out.update(_h5_read(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v[()]
    return out


def save_model(path: str, model: MCQModel) -> None:
    """Write a model to HDF5 (the JAX package's layout: f32 codebooks,
    0-based uint8 codes for h <= 256). Needs h5py, imported here."""
    import h5py
    with h5py.File(path, "w") as f:
        _h5_write(f, {f"model/{k}": v for k, v in saved_model(model).items()})


def load_model(path: str, device=None) -> MCQModel:
    """Read a model that either package saved, onto ``device`` (the
    card unless the caller names another)."""
    import h5py
    with h5py.File(path, "r") as f:
        return model_from_saved(_h5_read(f["model"]), device)


def save_index(path: str, index: MCQIndex) -> None:
    """Write an index: the model, the base codes and the norms byte,
    not the scan structures, which `load_index` rebuilds (the base
    encode is the costly part they hold)."""
    import h5py
    with h5py.File(path, "w") as f:
        _h5_write(f, saved_index(index))


def load_index(path: str, mode: str | None = None, device=None) -> MCQIndex:
    """Rebuild an index that either package saved, on ``device`` (the
    card unless the caller names another). ``mode`` overrides the saved
    layout, e.g. a decoded save loaded code-resident (`rebuild_index`)."""
    import h5py
    with h5py.File(path, "r") as f:
        saved = _h5_read(f)
    return index_from_saved(saved, mode=mode, device=device)
