"""Facade: train / index / search in three calls (counterpart of
`rayuela_tpu/api.py`):

    import rayuela_tpu_torch.api as rq
    model = rq.train(Xt, method="rvq", m=7, h=256, device="cuda")
    index = rq.index_base(model, Xb, mode="codes")
    dists, ids = rq.search(index, Q, k=100)

This slice serves PQ and RVQ through the code-resident scan. The other
methods, the decoded index and multi-device search raise
`NotImplementedError` naming the ROADMAP item that brings them. The
defaults are the JAX facade's (``method="sr_d"``, ``mode="decoded"``),
so a default call raises until those routes are ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

METHODS = ("pq", "opq", "rvq", "ervq", "chainq", "lsq", "sr_c", "sr_d",
           "compq")
PORTED = ("pq", "rvq")
_ORTHOGONAL = ("pq", "opq")
_ROADMAP = {"opq": "A4", "chainq": "A4", "lsq": "A4", "sr_c": "A4",
            "sr_d": "A4", "ervq": "A6", "compq": "A6"}


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
          mesh=None) -> MCQModel:
    """Train a quantizer on ``Xt (n, d)``. ``device`` defaults to
    ``Xt``'s (CPU for numpy input)."""
    from rayuela_tpu_torch.models.pq import train_pq
    from rayuela_tpu_torch.models.rvq import train_rvq

    if mesh is not None:
        raise NotImplementedError("multi-device training is not ported "
                                  "yet (ROADMAP A9)")
    method = _check_method(method)
    Xt = _tensor(Xt, device)
    gen = torch.Generator(device=Xt.device).manual_seed(seed)
    if method == "pq":
        model, B, _ = train_pq(gen, Xt, m, h, iters=niter)
    else:
        model, B, _ = train_rvq(gen, Xt, m, h, niter=niter)
    return MCQModel(method, model.codebooks, h=h, train_codes=B)


def encode(model: MCQModel, X) -> torch.Tensor:
    """Encode vectors with a trained model → (n, m) int32."""
    from rayuela_tpu_torch.models.pq import PQModel, quantize_pq
    from rayuela_tpu_torch.models.rvq import quantize_rvq

    method = _check_method(model.method)
    X = _tensor(X, model.codebooks.device)
    if method == "pq":
        return quantize_pq(PQModel(model.codebooks), X)
    return quantize_rvq(model.codebooks, X)[0]


def index_base(model: MCQModel, Xb, mode: str = "decoded",
               seed: int = 2) -> MCQIndex:
    """Encode the base set and build the code-resident index, with the
    norms byte for additive models (its codebook capped at h entries so
    it stacks with the per-codebook tables)."""
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
    B = encode(model, Xb)
    norms_cb = norm_codes = None
    if not model.pq_layout:
        if model.train_codes is None:
            raise ValueError("an additive model needs its train_codes to "
                             "train the norms codebook")
        gen = torch.Generator(device=Xb.device).manual_seed(seed)
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
    operands on the card, float32 on the CPU)."""
    from rayuela_tpu_torch.search.scan_codes import search_codes

    if mesh is not None:
        raise NotImplementedError("multi-device search is not ported yet "
                                  "(ROADMAP A9)")
    if index.mode != "codes":
        raise NotImplementedError("the decoded index is not ported yet "
                                  "(ROADMAP A5)")
    _check_method(index.model.method)
    return search_codes(index.scan_index, Q, k, **kw)
