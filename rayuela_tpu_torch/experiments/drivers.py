"""Experiment drivers — the train/query/base protocol over all methods
(counterpart of `rayuela_tpu/experiments/drivers.py`).

The reference's ``experiment_*`` functions and its pipeline scripts
`demos/demos_train_query_base.jl` / `demos/demos_query_base.jl`:

* train on ``Xt``, encode the base set, scan the queries (knn=1000),
  evaluate recall@N, persist the trial to the HDF5 store;
* orthogonal methods (PQ/OPQ) use ``m`` codebooks; non-orthogonal
  (RVQ/ERVQ/ChainQ/LSQ/SR/CompQ) use ``m-1`` plus one quantized-norms
  byte at equal bits per vector;
* staged initialization OPQ → ChainQ → LSQ/SR, with the ChainQ stage's
  output checkpointed and reloadable.

Where the JAX package takes a PRNG key, these functions take a
`torch.Generator` on the device they run on, and treat it as a key:
every stage draws from a fresh generator derived from the key's seed and
the stage (`fold_in`), never from the key's own state, so a stage draws
the same whatever ran before it. The runners derive the key of a trial
from ``seed + trial`` (JAX's ``PRNGKey(seed + trial)``), so a resumed
run draws what a fresh one would. Datasets are numpy; a trial moves them
to its device once. Everything runs on the card unless the caller asks
for the CPU (``device="cpu"``), where the kernels' plain versions run;
nothing falls back to the CPU when the card or a kernel fails.
With ``mesh=`` (every rank of the process group running the same call)
every method runs data-parallel over the mesh's ``data`` ranks
(`rayuela_tpu_torch.parallel`), as the JAX package's run shards ``Xt``
and ``Xb``: each rank trains on its rows of the training set (the
statistics all-reduced, the solves replicated), encodes its rows of the
base (the codes all-gathered), trains the norms codebook on its rows of
the training codes, and scans its rows of the base (K8 → K2 → K3 on the
card, `parallel.sharded_search_exact`; the ranks' lists merge). Only the
rank at the mesh's origin writes the store.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch

from rayuela_tpu_torch.experiments.datasets import (Dataset,
                                                    exact_ground_truth,
                                                    read_dataset)
from rayuela_tpu_torch.experiments.store import (list_trials, load_results,
                                                 save_results)
from rayuela_tpu_torch.models.chainq import quantize_chainq, train_chainq
from rayuela_tpu_torch.models.compq import quantize_compq, train_compq
from rayuela_tpu_torch.models.ervq import train_ervq_from_scratch
from rayuela_tpu_torch.models.lsq import train_lsq
from rayuela_tpu_torch.models.opq import quantize_opq, train_opq
from rayuela_tpu_torch.models.pq import quantize_pq, train_pq
from rayuela_tpu_torch.models.rvq import quantize_rvq, train_rvq
from rayuela_tpu_torch.models.sr import train_sr
from rayuela_tpu_torch.ops.icm import encoding_icm, encoding_icm_checkpoints
from rayuela_tpu_torch.ops.qerror import qerror, veccost
from rayuela_tpu_torch.search.linscan import (eval_recall, linscan_lsq,
                                              linscan_opq, linscan_pq)
from rayuela_tpu_torch.search.norms import get_norms_codebook, quantize_norms
from rayuela_tpu_torch.utils import as_tensor, fold_in

# the stages a key feeds: training (k-means seeds, ILS perturbations, SR
# noise, the OPQ init of the chain), the norms codebook, the base encode
# (JAX's ``fold_in(key, 7)``) and the high-recall ladder's init codes and
# encode (``fold_in(key, 11)``)
_TRAIN, _NORMS, _BASE, _LADDER = 0, 1, 7, 11

def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _on_device(ds: Dataset, device) -> Dataset:
    """The dataset's vectors as f32 tensors on ``device`` (one copy of a
    base that is the training set); the ground truth stays numpy."""
    Xt = as_tensor(ds.Xt, device)
    Xb = Xt if ds.Xb is ds.Xt else as_tensor(ds.Xb, device)
    return Dataset(ds.name, Xt, Xb, as_tensor(ds.Xq, device), ds.gt)


class _Laps:
    """Seconds per stage of one experiment (the card synchronized at
    each mark)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: dict = {}
        self._t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, stage: str) -> None:
        t = self._now()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + t - self._t
        self._t = t


def _encode_base(mesh, encode: Callable, Xb):
    """``encode(X) -> codes`` of the base ``Xb``; with ``mesh`` each rank
    encodes its rows, and the codes are all-gathered."""
    if mesh is None:
        return encode(Xb)
    from rayuela_tpu_torch.parallel.mesh import _like, shard_data
    rows = shard_data(mesh, Xb)
    return _like(mesh, Xb, encode(rows.local), rows)


def _search_sharded(mesh, C, Q, rows, knn: int, *, pq: bool, R=None,
                    norm_term=None):
    """The recall search over ``mesh``: each rank decodes its ``rows`` of
    the base codes (a `RowShard`; ``norm_term`` its rows' norm terms) and
    scans them (`parallel.mesh.sharded_search_exact`: K8 → K2 → K3 on the
    card, flagged queries rescued exactly), the queries rotated by ``R``
    where given → the merged ids."""
    from rayuela_tpu_torch.parallel.mesh import (RowShard,
                                                 sharded_search_exact)
    from rayuela_tpu_torch.search.scan import build_index
    if R is not None:
        Q = Q @ R
    idx = build_index(C, rows.local, pq=pq, d=Q.shape[1],
                      norm_term=norm_term)
    return sharded_search_exact(
        mesh, RowShard(idx.Xd, rows.start, rows.n),
        RowShard(idx.x2, rows.start, rows.n), Q, k=knn)[1]


def _finish_nonorth(gen, name, C, B, Xb_codes, R, ds: Dataset,
                    train_error, knn, verbose, store, trial, laps,
                    mesh=None):
    """Shared tail for non-orthogonal methods: norms codebook from the
    TRAIN codes, base norms quantization, the scan with the norms byte,
    recall. With ``mesh``, the norms codebook's k-means spans the ranks'
    rows of the training codes, and each rank quantizes the norms of
    its rows of the base and scans them (`_search_sharded`)."""
    dev = gen.device
    Q = as_tensor(ds.Xq, dev)
    if mesh is None:
        _, norms_cbook = get_norms_codebook(fold_in(gen, _NORMS), C, B)
        base_norm_codes, _ = quantize_norms(C, Xb_codes, norms_cbook)
        _, ids = linscan_lsq(C, Q, Xb_codes, norms_cbook, base_norm_codes,
                             R=R, k=knn)
    else:
        from rayuela_tpu_torch.parallel import (norms_codebook_sharded,
                                                shard_data)
        from rayuela_tpu_torch.parallel.mesh import _like
        _, norms_cbook = norms_codebook_sharded(mesh, fold_in(gen, _NORMS),
                                                C, B)
        rows = shard_data(mesh, Xb_codes)
        nco, _ = quantize_norms(C, rows.local, norms_cbook)
        ids = _search_sharded(mesh, C, Q, rows, knn, pq=False, R=R,
                              norm_term=norms_cbook[nco.long()])
        base_norm_codes = _like(mesh, Xb_codes, nco, rows)
    recall = eval_recall(ids, ds.gt, verbose=verbose)
    laps("search")
    out = dict(name=name, C=C, B=B, R=R, B_base=Xb_codes,
               train_error=float(train_error), recall=recall,
               seconds=laps.seconds)
    if store is not None:
        save_results(store, trial, C=_np(C), B=_np(B),
                     train_error=train_error, R=_np(R),
                     B_base=_np(Xb_codes), recall=recall,
                     norms_codebook=_np(norms_cbook),
                     norms_codes=_np(base_norm_codes))
    return out


def _orth_search(mesh, C, Q, Bb, knn: int, R=None):
    """PQ's / OPQ's recall search (``R``: OPQ's rotation) → ids."""
    if mesh is None:
        return (linscan_pq(C, Q, Bb, k=knn) if R is None
                else linscan_opq(C, Q, Bb, R, k=knn))[1]
    from rayuela_tpu_torch.parallel import shard_data
    return _search_sharded(mesh, C, Q, shard_data(mesh, Bb), knn, pq=True,
                           R=R)


def experiment_pq(gen, ds: Dataset, m: int = 8, h: int = 256,
                  niter: int = 25, knn: int = 1000, verbose: bool = True,
                  store: str | None = None, trial: int = 0, mesh=None):
    """Reference `src/PQ.jl:104-132`. With ``mesh``, data-parallel
    (`parallel.train_pq_sharded`, each rank's rows of the base)."""
    dev, laps = gen.device, _Laps(gen.device)
    Xt = as_tensor(ds.Xt, dev)
    if mesh is None:
        model, B, err = train_pq(fold_in(gen, _TRAIN), Xt, m, h,
                                 iters=niter)
    else:
        from rayuela_tpu_torch.parallel import train_pq_sharded
        model, B, err = train_pq_sharded(mesh, fold_in(gen, _TRAIN), Xt, m,
                                         h, iters=niter)
    laps("train")
    Bb = _encode_base(mesh, lambda X: quantize_pq(model, X),
                      as_tensor(ds.Xb, dev))
    laps("encode")
    ids = _orth_search(mesh, model.codebooks, as_tensor(ds.Xq, dev), Bb,
                       knn)
    recall = eval_recall(ids, ds.gt, verbose=verbose)
    laps("search")
    if store is not None:
        save_results(store, trial, C=_np(model.codebooks), B=_np(B),
                     train_error=float(err), B_base=_np(Bb), recall=recall)
    return dict(name="pq", model=model, B=B, B_base=Bb,
                train_error=float(err), recall=recall,
                seconds=laps.seconds)


def _train_opq(mesh, gen, Xt, m, h, niter):
    """OPQ, the method and the LSQ family's first stage, data-parallel
    with ``mesh`` (`parallel.train_opq_sharded`)."""
    if mesh is None:
        return train_opq(gen, Xt, m, h, niter=niter)
    from rayuela_tpu_torch.parallel import train_opq_sharded
    return train_opq_sharded(mesh, gen, Xt, m, h, niter=niter)


def experiment_opq(gen, ds: Dataset, m: int = 8, h: int = 256,
                   niter: int = 25, knn: int = 1000,
                   verbose: bool = True, store: str | None = None,
                   trial: int = 0, mesh=None):
    """Reference `src/OPQ.jl:143-197`. With ``mesh``, data-parallel."""
    dev, laps = gen.device, _Laps(gen.device)
    model, B, obj = _train_opq(mesh, fold_in(gen, _TRAIN),
                               as_tensor(ds.Xt, dev), m, h, niter)
    laps("train")
    Bb = _encode_base(mesh, lambda X: quantize_opq(model, X),
                      as_tensor(ds.Xb, dev))
    laps("encode")
    ids = _orth_search(mesh, model.codebooks, as_tensor(ds.Xq, dev), Bb,
                       knn, R=model.R)
    recall = eval_recall(ids, ds.gt, verbose=verbose)
    laps("search")
    if store is not None:
        save_results(store, trial, C=_np(model.codebooks), B=_np(B),
                     R=_np(model.R), train_error=float(obj[-1]),
                     B_base=_np(Bb), recall=recall)
    return dict(name="opq", model=model, B=B, B_base=Bb, R=model.R,
                train_error=float(obj[-1]), recall=recall, obj=_np(obj),
                seconds=laps.seconds)


def _train_rvq(mesh, gen, Xt, m, h, niter):
    """RVQ, the method and CompQ's init, data-parallel with ``mesh``
    (`parallel.train_rvq_sharded`)."""
    if mesh is None:
        return train_rvq(gen, Xt, m, h, niter=niter)
    from rayuela_tpu_torch.parallel import train_rvq_sharded
    return train_rvq_sharded(mesh, gen, Xt, m, h, niter=niter)


def experiment_rvq(gen, ds: Dataset, m: int = 7, h: int = 256,
                   niter: int = 25, knn: int = 1000,
                   verbose: bool = True, store: str | None = None,
                   trial: int = 0, mesh=None):
    """Reference `src/RVQ.jl:125-188`. With ``mesh``, data-parallel."""
    dev, laps = gen.device, _Laps(gen.device)
    model, B, err = _train_rvq(mesh, fold_in(gen, _TRAIN),
                               as_tensor(ds.Xt, dev), m, h, niter)
    laps("train")
    Bb = _encode_base(mesh, lambda X: quantize_rvq(model, X)[0],
                      as_tensor(ds.Xb, dev))
    laps("encode")
    return _finish_nonorth(gen, "rvq", model.codebooks, B, Bb, None, ds,
                           float(err), knn, verbose, store, trial, laps,
                           mesh)


def experiment_ervq(gen, ds: Dataset, m: int = 7, h: int = 256,
                    niter: int = 25, knn: int = 1000,
                    verbose: bool = True, store: str | None = None,
                    trial: int = 0, mesh=None):
    """Reference `src/ERVQ.jl:151-242` (RVQ init inside the trainer).
    With ``mesh``, data-parallel
    (`parallel.train_ervq_from_scratch_sharded`)."""
    dev, laps = gen.device, _Laps(gen.device)
    Xt = as_tensor(ds.Xt, dev)
    if mesh is None:
        model, B, err = train_ervq_from_scratch(fold_in(gen, _TRAIN), Xt, m,
                                                h, niter=niter)
    else:
        from rayuela_tpu_torch.parallel import train_ervq_from_scratch_sharded
        model, B, err = train_ervq_from_scratch_sharded(
            mesh, fold_in(gen, _TRAIN), Xt, m, h, niter=niter)
    laps("train")
    Bb = _encode_base(mesh, lambda X: quantize_rvq(model.codebooks, X)[0],
                      as_tensor(ds.Xb, dev))
    laps("encode")
    return _finish_nonorth(gen, "ervq", model.codebooks, B, Bb, None, ds,
                           float(err), knn, verbose, store, trial, laps,
                           mesh)


def experiment_chainq(gen, ds: Dataset, m: int = 7, h: int = 256,
                      niter: int = 25, knn: int = 1000,
                      verbose: bool = True, store: str | None = None,
                      trial: int = 0, opq_init=None, mesh=None):
    """ChainQ end-to-end (exported but undefined in the reference). OPQ
    init per `demos/demos_train_query_base.jl:52-58`. With ``mesh``,
    training and the base Viterbi encode run data-parallel
    (`parallel.train_chainq_sharded`, each rank's rows of the base)."""
    dev, laps = gen.device, _Laps(gen.device)
    Xt = as_tensor(ds.Xt, dev)
    if opq_init is None:
        opq_model, B_opq, _ = _train_opq(mesh, fold_in(gen, _TRAIN), Xt, m,
                                         h, niter)
        opq_init = (B_opq, opq_model.R)
    B0 = as_tensor(opq_init[0], dev, torch.int32)
    R0 = as_tensor(opq_init[1], dev)
    if mesh is not None:
        from rayuela_tpu_torch.parallel import train_chainq_sharded
        model, B, obj = train_chainq_sharded(mesh, Xt, B0, R0, h=h,
                                             niter=niter)
    else:
        model, B, obj = train_chainq(Xt, B0, R0, h=h, niter=niter)
    laps("train")
    Bb = _encode_base(mesh, lambda X: quantize_chainq(model, X),
                      as_tensor(ds.Xb, dev))
    laps("encode")
    out = _finish_nonorth(gen, "chainq", model.codebooks, B, Bb, model.R,
                          ds, float(obj[-1]), knn, verbose, store, trial,
                          laps, mesh)
    out["obj"] = _np(obj)
    return out


def _lsq_family(gen, ds, m, h, niter, knn, verbose, store, trial,
                trainer: Callable, name: str, chain_init,
                ilsiter, icmiter, npert, randord, chunk, mesh=None):
    """``trainer(gen, Xt, B0, R0, **ils)`` trains this stage (over
    ``mesh`` when its caller made it so, `_sharded_trainer`). With
    ``mesh`` the ChainQ init trains data-parallel
    (`parallel.train_chainq_sharded`) and the base encode runs on the
    rank's rows (`_encode_base_sharded`)."""
    dev, laps = gen.device, _Laps(gen.device)
    Xt, Xb = as_tensor(ds.Xt, dev), as_tensor(ds.Xb, dev)
    if chain_init is None:
        opq_model, B_opq, _ = _train_opq(mesh, fold_in(gen, _TRAIN), Xt, m,
                                         h, niter)
        if mesh is not None:
            from rayuela_tpu_torch.parallel import train_chainq_sharded
            cq_model, B_cq, _ = train_chainq_sharded(
                mesh, Xt, B_opq, opq_model.R, h=h, niter=niter)
        else:
            cq_model, B_cq, _ = train_chainq(Xt, B_opq, opq_model.R, h=h,
                                             niter=niter)
        chain_init = (B_cq, cq_model.R)
    B0 = as_tensor(chain_init[0], dev, torch.int32)
    R0 = as_tensor(chain_init[1], dev)
    model, B, obj = trainer(fold_in(gen, _TRAIN), Xt, B0, R0, h=h,
                            niter=niter, ilsiter=ilsiter, icmiter=icmiter,
                            npert=npert, randord=randord)
    laps("train")
    # Base encode: greedy sequential init + 4x ILS budget. The reference
    # inits from RANDOM codes (`src/SR.jl:283-287`, `src/LSQ.jl:438-440`);
    # greedy costs one extra pass and starts ILS far closer to the
    # training optimum.
    enc = dict(ilsiter=ilsiter * 4, icmiter=icmiter, npert=npert,
               randord=randord, chunk=chunk)
    if mesh is not None:
        Bb, base_error = _encode_base_sharded(mesh, fold_in(gen, _BASE), Xb,
                                              model.codebooks, **enc)
    else:
        Bb0, _ = quantize_rvq(model.codebooks, Xb)
        Bb = encoding_icm(fold_in(gen, _BASE), Xb, model.codebooks, Bb0,
                          **enc)
        base_error = float(qerror(Xb, model.codebooks, Bb))
    laps("encode")
    if verbose:
        print(f"{name}: train {float(obj[-1]):.5g} base {base_error:.5g}")
    out = _finish_nonorth(gen, name, model.codebooks, B, Bb, None, ds,
                          float(obj[-1]), knn, verbose, store, trial, laps,
                          mesh)
    out["obj"] = _np(obj)
    out["base_error"] = base_error
    return out


def _encode_base_sharded(mesh, gen, Xb, C, **enc):
    """`_lsq_family`'s base encode over ``mesh`` → ``(codes (n, m),
    mean squared error)``: the rank's rows of ``Xb`` get the greedy init,
    the ILS (`parallel.sharded_encoding_icm`, the rank's own stream of
    ``gen``) and their squared error; the codes are all-gathered and the
    error sums all-reduced."""
    from rayuela_tpu_torch.parallel import shard_data, sharded_encoding_icm
    from rayuela_tpu_torch.parallel.mesh import _all_reduce, _like

    rows = shard_data(mesh, Xb)
    B0, _ = quantize_rvq(C, rows.local)
    B = sharded_encoding_icm(mesh, gen, rows, C, rows._replace(local=B0),
                             **enc).local
    err = _all_reduce(mesh, veccost(rows.local, C, B).sum()) / rows.n
    return _like(mesh, Xb, B, rows), float(err)


def _sharded_trainer(mesh, method: str, chunk: int, schedule: int = 1,
                     p: float = 0.5) -> Callable:
    """`parallel.train_lsq_family_sharded` over ``mesh`` at ``method``
    (``schedule``, ``p``: SR's) as `_lsq_family`'s stage trainer."""
    from rayuela_tpu_torch.parallel import train_lsq_family_sharded

    def trainer(g, X, B0, R0, **kw):
        return train_lsq_family_sharded(mesh, g, X, B0, R0, method=method,
                                        schedule=schedule, p=p, chunk=chunk,
                                        **kw)
    return trainer


def experiment_lsq(gen, ds: Dataset, m: int = 7, h: int = 256,
                   niter: int = 25, knn: int = 1000,
                   verbose: bool = True, store: str | None = None,
                   trial: int = 0, chain_init=None, ilsiter: int = 8,
                   icmiter: int = 4, npert: int = 4,
                   randord: bool = True, chunk: int = 8192, mesh=None):
    """Reference `src/LSQ.jl:383-476`."""
    trainer = (train_lsq if mesh is None else
               _sharded_trainer(mesh, "LSQ", chunk))
    return _lsq_family(gen, ds, m, h, niter, knn, verbose, store, trial,
                       trainer, "lsq", chain_init, ilsiter, icmiter,
                       npert, randord, chunk, mesh=mesh)


def experiment_sr(gen, ds: Dataset, m: int = 7, h: int = 256,
                  niter: int = 25, knn: int = 1000, verbose: bool = True,
                  store: str | None = None, trial: int = 0,
                  chain_init=None, ilsiter: int = 8, icmiter: int = 4,
                  npert: int = 4, randord: bool = True,
                  method: str = "SR_D", schedule: int = 1,
                  p: float = 0.5, chunk: int = 8192, mesh=None):
    """Reference `src/SR.jl:178-402` (CPU/CUDA variants unified)."""
    def trainer(g, X, B0, R0, **kw):
        return train_sr(g, X, B0, R0, method=method, schedule=schedule,
                        p=p, **kw)
    if mesh is not None:
        trainer = _sharded_trainer(mesh, method, chunk, schedule, p)
    return _lsq_family(gen, ds, m, h, niter, knn, verbose, store, trial,
                       trainer, f"sr-{method[-1].lower()}", chain_init,
                       ilsiter, icmiter, npert, randord, chunk, mesh=mesh)


def experiment_compq(gen, ds: Dataset, m: int = 7, h: int = 256,
                     niter: int = 25, knn: int = 1000,
                     verbose: bool = True, store: str | None = None,
                     trial: int = 0, H: int = 16, lr_total: float = 0.01,
                     update: str = "sgd", mesh=None):
    """CompQ end-to-end: RVQ init → competitive training → beam base
    encode → norms-byte scan. Reference `demos/demo_compq.jl` +
    `src/CompetitiveQ.jl:138-221`. With ``mesh``, data-parallel
    (`parallel.train_compq_sharded`)."""
    dev, laps = gen.device, _Laps(gen.device)
    Xt = as_tensor(ds.Xt, dev)
    rvq_model, B0, _ = _train_rvq(mesh, fold_in(gen, _TRAIN), Xt, m, h,
                                  niter)
    kw = dict(niter=niter, H=H, lr_total=lr_total, update=update)
    if mesh is None:
        model, B, obj = train_compq(Xt, rvq_model.codebooks, B0, **kw)
    else:
        from rayuela_tpu_torch.parallel import train_compq_sharded
        model, B, obj = train_compq_sharded(mesh, Xt, rvq_model.codebooks,
                                            B0, **kw)
    laps("train")
    Bb = _encode_base(mesh, lambda X: quantize_compq(model, X, H=H)[0],
                      as_tensor(ds.Xb, dev))
    laps("encode")
    out = _finish_nonorth(gen, "compq", model.codebooks, B, Bb, None, ds,
                          float(obj[-1]), knn, verbose, store, trial, laps,
                          mesh)
    out["obj"] = _np(obj)
    return out


ALL_METHODS = ("pq", "opq", "rvq", "ervq", "chainq", "lsq", "sr_c",
               "sr_d", "compq")


def _query_base(ds: Dataset, device=None) -> Dataset:
    """The query==base dataset: the training set is the base searched,
    and the ground truth, which indexes ``Xb``, is recomputed against it
    on ``device`` unless the two sets are one (LabelMe/MNIST files)."""
    gt = ds.gt
    if not (ds.Xb.shape == ds.Xt.shape and np.array_equal(ds.Xb, ds.Xt)):
        gt = exact_ground_truth(ds.Xq, ds.Xt, device=device)
    return Dataset(ds.name, ds.Xt, ds.Xt, ds.Xq, gt)


def run_query_base(dataset: str | Dataset, m: int = 8, h: int = 256,
                   niter: int = 25, ntrials: int = 10, knn: int = 1000,
                   methods=ALL_METHODS, results_dir: str = "results",
                   verbose: bool = True, seed: int = 0, device=None,
                   **exp_kw):
    """The query==base protocol of `demos/demos_query_base.jl`
    (LabelMe22K / MNIST): the training set IS the base set — queries
    are searched against the training codes directly, over ``ntrials``
    repetitions (the reference uses 10)."""
    ds = (read_dataset(dataset, device=device) if isinstance(dataset, str)
          else dataset)
    return run_train_query_base(_query_base(ds, device), m=m, h=h,
                                niter=niter, ntrials=ntrials, knn=knn,
                                methods=methods, results_dir=results_dir,
                                verbose=verbose, seed=seed, device=device,
                                **exp_kw)


def high_recall_experiment(gen, ds: Dataset, m: int = 7, h: int = 256,
                           niter: int = 25,
                           ilsiters=(1, 2, 4, 8, 16, 32, 64),
                           knn: int = 1000, verbose: bool = True,
                           method: str = "SR_D", **sr_kw):
    """Recall as a function of the base-encoding ILS budget — the
    reference's ``high_recall_experiments``
    (`demos/demos_train_query_base.jl:98-158`). Returns
    ``{ilsiter: recall_curve}``. ``chunk`` in ``sr_kw`` goes to the base
    encode (the port's SR trainer takes none)."""
    chunk = sr_kw.pop("chunk", 8192)
    dev = gen.device
    Xt, Xb = as_tensor(ds.Xt, dev), as_tensor(ds.Xb, dev)
    opq_model, B_opq, _ = train_opq(fold_in(gen, _TRAIN), Xt, m, h,
                                    niter=niter)
    cq_model, B_cq, _ = train_chainq(Xt, B_opq, opq_model.R, h=h,
                                     niter=niter)
    model, B, _ = train_sr(fold_in(gen, _TRAIN), Xt, B_cq, cq_model.R,
                           h=h, niter=niter, method=method, **sr_kw)
    ladder = fold_in(gen, _LADDER)
    Bb0 = torch.randint(0, h, (Xb.shape[0], B.shape[1]),
                        generator=fold_in(ladder, 0), device=dev,
                        dtype=torch.int32)
    snaps = encoding_icm_checkpoints(fold_in(ladder, 1), Xb,
                                     model.codebooks, Bb0,
                                     ilsiters=ilsiters, chunk=chunk)
    _, norms_cbook = get_norms_codebook(fold_in(gen, _NORMS),
                                        model.codebooks, B)
    Xq = as_tensor(ds.Xq, dev)
    out = {}
    for ils, Bb in zip(sorted(ilsiters), snaps):
        bnorm, _ = quantize_norms(model.codebooks, Bb, norms_cbook)
        _, ids = linscan_lsq(model.codebooks, Xq, Bb, norms_cbook, bnorm,
                             k=knn)
        out[ils] = eval_recall(ids, ds.gt, verbose=False)
        if verbose:
            print(f"ilsiter={ils}: r@1={out[ils][0]:.4f}")
    return out


def _lsq_config(name: str, m: int, config, verbose: bool,
                exp_kw: dict) -> tuple[dict, dict]:
    """``config`` resolved to the LSQ family's keywords: the incumbent's
    (or an `hpo.LSQConfig`'s) ilsiter / icmiter / npert / randord for
    LSQ and SR under the explicit keywords, schedule / p for SR."""
    if config is None:
        return exp_kw, {}
    from rayuela_tpu_torch.experiments.hpo import LSQConfig, incumbent
    cfg = incumbent(name, m) if config == "incumbent" else config
    if not isinstance(cfg, LSQConfig):
        raise ValueError(
            f"config={config!r}: 'incumbent' or an hpo.LSQConfig")
    if verbose:
        print(f"[config] LSQ-family hyperparameters: {cfg}")
    exp_kw = dict(dict(ilsiter=cfg.ilsiter, icmiter=cfg.icmiter,
                       npert=cfg.npert, randord=cfg.randord), **exp_kw)
    return exp_kw, dict(schedule=cfg.schedule, p=cfg.p)


def _run_trial(ds: Dataset, trial: int, results_dir: str | None,
               m: int = 8, h: int = 256, niter: int = 25, knn: int = 1000,
               methods=ALL_METHODS, verbose: bool = True, seed: int = 0,
               resume: bool = False, device=None, sr_extra=None,
               mesh=None, **exp_kw) -> dict:
    """One trial of the protocol → ``{method: result}``. Results go to
    ``results_dir/{dataset}_{method}.h5``; with ``results_dir=None``
    nothing is stored or resumed, and h5py is never imported (the card's
    machine has none). With ``mesh`` every method runs data-parallel,
    and only the rank at the mesh's origin writes (every rank reads what
    it resumes)."""
    writes = mesh is None or not any(mesh.coords.values())
    dev = torch.device(device or "cuda")
    dsd = _on_device(ds, dev)
    key = torch.Generator(device=dev).manual_seed(seed + trial)
    chain_init = None
    out_t: dict = {}
    for method in methods:
        t0 = time.time()
        path = (None if results_dir is None
                else os.path.join(results_dir, f"{ds.name}_{method}.h5"))
        if resume and path is not None and trial in list_trials(path):
            saved = load_results(path, trial)
            if method == "chainq" and "R" in saved:
                chain_init = (as_tensor(saved["B"], dev, torch.int32),
                              as_tensor(saved["R"], dev))
            if verbose:
                print(f"[trial {trial}] {method}: resumed from {path}")
            out_t[method] = dict(name=method, recall=saved.get("recall"),
                                 resumed=True)
            continue
        store = path if writes else None
        if method in ("pq", "opq"):
            fn = experiment_pq if method == "pq" else experiment_opq
            out = fn(key, dsd, m, h, niter, knn, verbose, store, trial,
                     mesh=mesh)
        elif method == "rvq":
            out = experiment_rvq(key, dsd, m - 1, h, niter, knn, verbose,
                                 store, trial, mesh=mesh)
        elif method == "ervq":
            out = experiment_ervq(key, dsd, m - 1, h, niter, knn, verbose,
                                  store, trial, mesh=mesh)
        elif method == "chainq":
            out = experiment_chainq(key, dsd, m - 1, h, niter, knn,
                                    verbose, store, trial, mesh=mesh)
            chain_init = (out["B"], out["R"])
        elif method == "lsq":
            out = experiment_lsq(key, dsd, m - 1, h, niter, knn, verbose,
                                 store, trial, chain_init=chain_init,
                                 mesh=mesh, **exp_kw)
        elif method in ("sr_c", "sr_d"):
            out = experiment_sr(key, dsd, m - 1, h, niter, knn, verbose,
                                store, trial, chain_init=chain_init,
                                method=method.upper(), mesh=mesh,
                                **{**(sr_extra or {}), **exp_kw})
        elif method == "compq":
            out = experiment_compq(key, dsd, m - 1, h, niter, knn,
                                   verbose, store, trial, mesh=mesh)
        else:
            raise ValueError(f"unknown method {method!r}")
        if verbose:
            print(f"[trial {trial}] {method}: r@1={out['recall'][0]:.4f} "
                  f"({time.time() - t0:.1f}s)")
        out_t[method] = out
    return out_t


def run_train_query_base(dataset: str | Dataset = "sift1m", m: int = 8,
                         h: int = 256, niter: int = 25,
                         ntrials: int = 1, knn: int = 1000,
                         methods=ALL_METHODS, results_dir: str = "results",
                         verbose: bool = True, seed: int = 0,
                         resume: bool = False, mesh=None, config=None,
                         device=None, **exp_kw):
    """The full protocol of `demos/demos_train_query_base.jl:9-96`:
    every method at equal bits per vector (PQ/OPQ: m codebooks;
    non-orthogonal: m-1 + norms byte), staged OPQ→ChainQ→LSQ/SR init
    shared within a trial, results per (dataset, method) HDF5 file, on
    ``device`` (the card unless the caller asks for the CPU).

    ``resume=True`` reproduces the reference's crash recovery: (method,
    trial) pairs already in the store are skipped, and a completed
    ChainQ stage is reloaded from HDF5 to seed the LSQ/SR stages.

    ``config`` selects the LSQ-family hyperparameters: ``"incumbent"``
    looks up the reference's SMAC-recorded incumbent for ``(dataset,
    m)`` (`rayuela_tpu_torch.experiments.hpo.INCUMBENTS`; unknown
    datasets fall back to the defaults), or pass an ``hpo.LSQConfig``.
    The incumbent's ilsiter / icmiter / npert / randord apply to LSQ and
    SR; schedule / p to SR only. Explicit keyword overrides still win.

    ``mesh`` (every rank of the process group making the same call; its
    device is the default) runs every method data-parallel: each rank
    trains on its rows of the training set, encodes and scans its rows
    of the base; only the rank at the mesh's origin writes the store."""
    if mesh is not None and device is None:
        device = mesh.device
    ds = (read_dataset(dataset, device=device) if isinstance(dataset, str)
          else dataset)
    os.makedirs(results_dir, exist_ok=True)
    exp_kw, sr_extra = _lsq_config(ds.name, m, config, verbose, exp_kw)
    results: dict = {}
    for trial in range(ntrials):
        out_t = _run_trial(ds, trial, results_dir, m=m, h=h, niter=niter,
                           knn=knn, methods=methods, verbose=verbose,
                           seed=seed, resume=resume, device=device,
                           sr_extra=sr_extra, mesh=mesh, **exp_kw)
        for method, out in out_t.items():
            results.setdefault(method, []).append(out)
    return results
