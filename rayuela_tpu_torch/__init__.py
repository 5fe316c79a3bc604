"""PyTorch/CUDA port of `rayuela_tpu` for one NVIDIA H100.

The package mirrors `rayuela_tpu`'s module names and public contracts
(``X (n, d)`` f32, ``C (m, h, d)`` f32, ``B (n, m)`` int32 0-based, the
`pack_codes` word layout, search returning ``(dists (nq, k) f32,
ids (nq, k))`` with the ``+|q|^2`` term included). It never imports
jax: the JAX package is the reference the tests hold it against.

Importing the package imports `api` and `utils`, as `rayuela_tpu`
does (``import rayuela_tpu_torch.api as rq``); the subpackages
`experiments`, `io`, `models`, `ops`, `parallel` and `search` re-export
their public names. No import builds or loads the CUDA kernels (they
build at their first launch) or creates a process group.
"""

from rayuela_tpu_torch import api, utils  # noqa: F401

__version__ = "0.1.0"

__all__ = ["api", "experiments", "io", "models", "ops", "parallel",
           "search", "utils", "__version__"]
