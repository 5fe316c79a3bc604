"""Facade: train / index / search in three calls (counterpart of
`rayuela_tpu/api.py`):

    import rayuela_tpu_torch.api as rq
    model = rq.train(Xt, method="rvq", m=7, h=256, device="cuda")
    index = rq.index_base(model, Xb, mode="codes")
    dists, ids = rq.search(index, Q, k=100)

Ported: PQ, RVQ, OPQ, ChainQ and the LSQ family (LSQ, SR-C, SR-D), the
last four through the staged OPQ → ChainQ init, served through the
code-resident scan. ERVQ, CompQ, the decoded index and multi-device
search raise `NotImplementedError` naming the ROADMAP item that brings
them. The defaults are the JAX facade's (``method="sr_d"``,
``mode="decoded"``), so a default `index_base` call raises until the
decoded index is ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from rayuela_tpu_torch.utils import exact_f32

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
    """A searchable base set: codes + scan index + norms. Only
    ``mode="codes"`` (packed codes, ~m bytes per vector) is ported."""
    model: MCQModel
    codes: torch.Tensor              # (n, m) int32
    scan_index: Any                  # CodesIndex
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


def _tensor(X, device) -> torch.Tensor:
    if device is None:
        device = X.device if isinstance(X, torch.Tensor) else "cpu"
    return torch.as_tensor(X, dtype=torch.float32, device=device)


def train(Xt, method: str = "sr_d", m: int = 8, h: int = 256,
          niter: int = 25, seed: int = 0, device=None,
          mesh=None, **kw) -> MCQModel:
    """Train a quantizer on ``Xt (n, d)``. ``device`` defaults to
    ``Xt``'s (CPU for numpy input). ChainQ and the LSQ family follow the
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
    Xt = _tensor(Xt, device)
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
    from ``gen`` (a generator on X's device; seeded with 1 if None)."""
    from rayuela_tpu_torch.models.chainq import ChainQModel, quantize_chainq
    from rayuela_tpu_torch.models.opq import OPQModel, quantize_opq
    from rayuela_tpu_torch.models.pq import PQModel, quantize_pq
    from rayuela_tpu_torch.models.rvq import quantize_rvq
    from rayuela_tpu_torch.ops.icm import encoding_icm

    method = _check_method(model.method)
    X = _tensor(X, model.codebooks.device)
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
    """Encode the base set (``kw`` goes to `encode`) and build the
    code-resident index, with the norms byte for every non-orthogonal
    model (its codebook capped at h entries so it stacks with the
    per-codebook tables). One generator seeded with ``seed`` serves the
    encode and the norms codebook."""
    from rayuela_tpu_torch.search.norms import (get_norms_codebook,
                                                quantize_norms)
    from rayuela_tpu_torch.search.scan_codes import build_codes_index

    if mode == "decoded":
        raise NotImplementedError("the decoded index is not ported yet "
                                  "(ROADMAP A5); use mode='codes'")
    if mode != "codes":
        raise ValueError(f"mode {mode!r}: 'codes' (or 'decoded', not "
                         "ported yet)")
    Xb = _tensor(Xb, model.codebooks.device)
    gen = torch.Generator(device=Xb.device).manual_seed(seed)
    B = encode(model, Xb, gen=gen, **kw)
    norms_cb = norm_codes = None
    if not model.pq_layout:
        if model.train_codes is None:
            raise ValueError("an additive model needs its train_codes to "
                             "train the norms codebook")
        _, norms_cb = get_norms_codebook(gen, model.codebooks,
                                         model.train_codes,
                                         h=min(256, model.h))
        norm_codes, _ = quantize_norms(model.codebooks, B, norms_cb)
    idx = build_codes_index(model.codebooks, B, pq=model.pq_layout,
                            d=Xb.shape[1], norms_cbook=norms_cb,
                            norms_codes=norm_codes)
    return MCQIndex(model, B, idx, norms_cb, norm_codes, mode="codes")


def search(index: MCQIndex, Q, k: int = 100, mesh=None,
           **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k search → ``(dists (nq, k) f32 with +|q|^2, ids (nq, k)
    int32)``: the exact top-k of the scan's truncated scores (bfloat16
    operands on the card, float32 on the CPU). OPQ and ChainQ queries
    are rotated by the model's R first."""
    from rayuela_tpu_torch.search.scan_codes import search_codes

    if mesh is not None:
        raise NotImplementedError("multi-device search is not ported yet "
                                  "(ROADMAP A9)")
    if index.mode != "codes":
        raise NotImplementedError("the decoded index is not ported yet "
                                  "(ROADMAP A5)")
    model = index.model
    _check_method(model.method)
    if model.method in _ROTATED:
        exact_f32()
        Q = _tensor(Q, model.R.device) @ model.R
    return search_codes(index.scan_index, Q, k, **kw)
