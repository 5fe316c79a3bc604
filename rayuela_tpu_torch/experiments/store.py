"""HDF5 result store — checkpoint/resume backbone of the experiment
pipelines (a copy of `rayuela_tpu/experiments/store.py`).

The reference's schema (`demos/experiment_utils.jl:5-61`):
``{trial}/C_{i}`` per-codebook f32 arrays, ``{trial}/B`` and
``{trial}/B_base`` as **0-based uint8**, ``{trial}/R`` rotation,
``{trial}/train_error``, ``{trial}/recall``. The group and dataset
names, dtypes and write order are the JAX package's, so both packages
write the same bytes for the same arrays and read each other's files.
Staged pipelines (OPQ → ChainQ → LSQ/SR) reload the previous stage's
group as init. Arrays are numpy; h5py is imported inside the calls, so
importing this module needs none (the card's machine has no h5py).
"""

from __future__ import annotations

import os

import numpy as np


def _codes_u8(B) -> np.ndarray:
    B = np.asarray(B)
    if B.max(initial=0) > 255:
        raise ValueError("codes exceed uint8 range (h > 256?)")
    return B.astype(np.uint8)


def save_results(path: str, trial: int, *, C, B, train_error,
                 R=None, B_base=None, recall=None, opq_error=None,
                 norms_codebook=None, norms_codes=None,
                 overwrite: bool = True) -> None:
    """Write one trial group. ``C``: (m, h, d*) array or list of (h, d*).

    Covers all reference flavors (``save_results_pq/_opq/_lsq`` and
    their ``_query_base`` variants) via optional fields."""
    import h5py
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "a") as f:
        g = f"{trial}"
        if g in f:
            if not overwrite:
                raise ValueError(f"trial {trial} already in {path}")
            del f[g]
        grp = f.create_group(g)
        C = np.asarray(C)
        for i in range(C.shape[0]):
            grp.create_dataset(f"C_{i}", data=C[i].astype(np.float32))
        grp.create_dataset("B", data=_codes_u8(B))
        grp.create_dataset("train_error", data=np.float32(train_error))
        if R is not None:
            grp.create_dataset("R", data=np.asarray(R, np.float32))
        if B_base is not None:
            grp.create_dataset("B_base", data=_codes_u8(B_base))
        if recall is not None:
            grp.create_dataset("recall", data=np.asarray(recall,
                                                         np.float32))
        if opq_error is not None:
            grp.create_dataset("opq_error", data=np.asarray(opq_error,
                                                            np.float32))
        if norms_codebook is not None:
            grp.create_dataset("norms_codebook",
                               data=np.asarray(norms_codebook, np.float32))
        if norms_codes is not None:
            grp.create_dataset("norms_codes",
                               data=_codes_u8(norms_codes))


def load_results(path: str, trial: int) -> dict:
    """Load one trial group back into a dict with ``C`` stacked to
    (m, h, d*) f32 and codes widened to int32 (0-based).

    Reference ``load_chainq``/``load_rvq``
    (`demos/experiment_utils.jl:45-60`)."""
    import h5py
    out: dict = {}
    with h5py.File(path, "r") as f:
        grp = f[f"{trial}"]
        cbs = sorted((k for k in grp if k.startswith("C_")),
                     key=lambda k: int(k[2:]))
        out["C"] = np.stack([np.asarray(grp[k], np.float32) for k in cbs])
        for k in grp:
            if k.startswith("C_"):
                continue
            v = np.asarray(grp[k])
            if k in ("B", "B_base", "norms_codes"):
                v = v.astype(np.int32)
            out[k] = v
    return out


def list_trials(path: str) -> list[int]:
    if not os.path.exists(path):
        return []
    import h5py
    with h5py.File(path, "r") as f:
        return sorted(int(k) for k in f.keys() if k.isdigit())
