"""Carry a model or an index across from the JAX package.

The functions take the arrays that `rayuela_tpu.api.MCQModel`,
`MCQIndex` and `rayuela_tpu.search.scan_pallas.LinscanIndex` hold, as
numpy arrays (``np.asarray`` of each field), so a model trained or a
base encoded or decoded by the JAX package serves from this port
unchanged: the codes pack into the same words and the search scores
them the same way. They copy to the device they are given: like the
facade, the card unless the caller names the CPU.
"""

from __future__ import annotations

import torch

from rayuela_tpu_torch.api import (MCQIndex, MCQModel, _tensor,
                                   model_from_saved, rebuild_index)
from rayuela_tpu_torch.search.scan import LinscanIndex


def model_from_arrays(method: str, codebooks, R=None, h: int = 256,
                      train_codes=None, device="cuda") -> MCQModel:
    """`MCQModel` from the JAX model's codebooks ``(m, h, d*)``,
    rotation and training codes."""
    return model_from_saved({"@method": method.lower(), "@h": h,
                             "codebooks": codebooks, "R": R,
                             "train_codes": train_codes}, device)


def index_from_arrays(model: MCQModel, codes, norms_codebook, norm_codes,
                      d: int) -> MCQIndex:
    """Code-resident `MCQIndex` from the JAX index's base codes
    ``(n, m)``, norms codebook ``(h',)`` and norms codes ``(n,)``
    (both None for PQ), on the model's device (`api.rebuild_index`)."""
    return rebuild_index(model, codes, norms_codebook, norm_codes, d)


def decoded_index_from_arrays(Xd, x2, device="cuda") -> LinscanIndex:
    """`LinscanIndex` from a JAX `LinscanIndex`'s decoded base ``Xd (n,
    d)`` (float32, or bfloat16, which is widened to float32) and
    norm terms ``x2 (n,)``. The base stays float32, with no round trip
    through bfloat16: an index the JAX package built in f32 serves the
    exact-float search (``pack=False``) from the same values, and values
    that were bfloat16 are exact in it."""
    return LinscanIndex(_tensor(Xd, torch.float32, device),
                        _tensor(x2, torch.float32, device))
