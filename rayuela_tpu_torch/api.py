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

Ported: PQ, RVQ, OPQ, ChainQ and the LSQ family (LSQ, SR-C, SR-D), the
last four through the staged OPQ → ChainQ init, served from the decoded
index (``mode="decoded"``, the default: the base decoded once, bfloat16
on the card) or the code-resident one (``mode="codes"``: ~m bytes per
vector, scanned by decoding or, with ``search(..., mode="lut")``,
through per-query tables); `search_streamed` serves packed codes that
stay in host memory. ERVQ, CompQ and multi-device training and
search raise `NotImplementedError` naming the ROADMAP item that brings
them. The defaults are the JAX facade's (``method="sr_d"``,
``mode="decoded"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from rayuela_tpu_torch.utils import as_tensor, exact_f32

METHODS = ("pq", "opq", "rvq", "ervq", "chainq", "lsq", "sr_c", "sr_d",
           "compq")
PORTED = ("pq", "opq", "rvq", "chainq", "lsq", "sr_c", "sr_d")
_ORTHOGONAL = ("pq", "opq")
_ROTATED = ("opq", "chainq")      # search rotates the queries by R
_ROADMAP = {"ervq": "A6", "compq": "A6"}


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
    if method not in PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP "
            f"{_ROADMAP[method]}); ported: {PORTED}")
    return method


def train(Xt, method: str = "sr_d", m: int = 8, h: int = 256,
          niter: int = 25, seed: int = 0, device=None,
          mesh=None, **kw) -> MCQModel:
    """Train a quantizer on ``Xt (n, d)``. ``device`` defaults to
    ``Xt``'s when it is a tensor and to the card otherwise
    (``device="cpu"`` asks for the CPU). ChainQ and the LSQ family follow the
    reference pipeline: OPQ → ChainQ → {chainq | lsq | sr_c | sr_d};
    ``kw`` goes to the last stage's trainer."""
    from rayuela_tpu_torch.models.chainq import train_chainq
    from rayuela_tpu_torch.models.lsq import train_lsq
    from rayuela_tpu_torch.models.opq import train_opq
    from rayuela_tpu_torch.models.pq import train_pq
    from rayuela_tpu_torch.models.rvq import train_rvq
    from rayuela_tpu_torch.models.sr import train_sr

    if mesh is not None:
        raise NotImplementedError("multi-device training is not ported "
                                  "yet (ROADMAP A9)")
    method = _check_method(method)
    Xt = as_tensor(Xt, device)
    gen = torch.Generator(device=Xt.device).manual_seed(seed)
    if method == "pq":
        model, B, _ = train_pq(gen, Xt, m, h, iters=niter, **kw)
        return MCQModel(method, model.codebooks, h=h, train_codes=B)
    if method == "rvq":
        model, B, _ = train_rvq(gen, Xt, m, h, niter=niter, **kw)
        return MCQModel(method, model.codebooks, h=h, train_codes=B)
    if method == "opq":
        model, B, _ = train_opq(gen, Xt, m, h, niter=niter, **kw)
        return MCQModel(method, model.codebooks, R=model.R, h=h,
                        train_codes=B)
    opq, B0, _ = train_opq(gen, Xt, m, h, niter=niter)
    if method == "chainq":
        model, B, _ = train_chainq(Xt, B0, opq.R, h=h, niter=niter, **kw)
        return MCQModel(method, model.codebooks, R=model.R, h=h,
                        train_codes=B)
    cq, B1, _ = train_chainq(Xt, B0, opq.R, h=h, niter=niter)
    if method == "lsq":
        model, B, _ = train_lsq(gen, Xt, B1, cq.R, h=h, niter=niter, **kw)
    else:
        model, B, _ = train_sr(gen, Xt, B1, cq.R, h=h, niter=niter,
                               method=method.upper(), **kw)
    return MCQModel(method, model.codebooks, h=h, train_codes=B)


def encode(model: MCQModel, X, gen=None, **kw) -> torch.Tensor:
    """Encode vectors with a trained model → (n, m) int32. The LSQ
    family starts from the greedy RVQ encode and runs ILS/ICM at the
    base budget (``ilsiter=32`` unless ``kw`` says otherwise), drawing
    from ``gen`` (a generator on X's device; seeded with 1 if None);
    ``impl="pallas-ils"`` runs all rounds in one whole-ILS kernel
    launch (`ops.icm.encoding_icm`)."""
    from rayuela_tpu_torch.models.chainq import ChainQModel, quantize_chainq
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
    if method == "rvq":
        return quantize_rvq(model.codebooks, X)[0]
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
    ``mode="lut"``)."""
    from rayuela_tpu_torch.search import scan, scan_codes

    if mesh is not None:
        raise NotImplementedError("multi-device search is not ported yet "
                                  "(ROADMAP A9)")
    model = index.model
    _check_method(model.method)
    Q = as_tensor(Q, model.codebooks.device)
    if model.method in _ROTATED:
        exact_f32()
        Q = Q @ model.R
    if index.mode == "codes":
        return scan_codes.search_codes(index.scan_index, Q, k, **kw)
    return scan.search(index.scan_index, Q, k, **kw)


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
