"""The rank side of `tests/test_torch_parallel.py`: each check of the
multi-GPU layer run by one gloo rank on the CPU (the file imports no jax;
the test module spawns the ranks with `parallel.dryrun.run_ranks` and
holds their results against the JAX package and the port's
single-process calls)."""

import numpy as np
import torch

from rayuela_tpu_torch import api
from rayuela_tpu_torch.experiments import drivers
from rayuela_tpu_torch.experiments.datasets import make_synthetic
from rayuela_tpu_torch.models.opq import train_opq
from rayuela_tpu_torch.ops import kmeans as tkm
from rayuela_tpu_torch.ops.codebook_update import codebook_stats
from rayuela_tpu_torch.ops.qerror import reconstruct_pq
from rayuela_tpu_torch.parallel import (global_mesh, host_local_to_global,
                                        kmeans_sharded, make_mesh,
                                        make_sr_train_step,
                                        pq_lloyd_step_sharded, shard_data,
                                        sharded_encoding_icm,
                                        sharded_scan_topk, sharded_search,
                                        sharded_search_codes,
                                        sharded_search_codes_decode,
                                        sharded_viterbi_encode,
                                        train_chainq_sharded,
                                        train_compq_sharded,
                                        train_ervq_sharded,
                                        train_lsq_family_sharded,
                                        train_opq_sharded, train_pq_sharded,
                                        train_rvq_sharded)
from rayuela_tpu_torch.parallel import mesh as pmesh
from rayuela_tpu_torch.search import scan, scan_codes


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, pmesh.RowShard):
        x = x.local
    return x.detach().cpu().numpy()


def _api_checks(mesh, data, out):
    """The facade's ``mesh=`` paths beside its meshless calls."""
    Xt, Xb, Q = (data[k] for k in ("api_Xt", "api_Xb", "api_Q"))
    model = api.train(Xt, method="pq", m=4, h=16, niter=3, device="cpu")
    idx = api.index_base(model, Xb)
    out["api_decoded"] = [_np(t) for t in (*api.search(idx, Q, k=15),
                                           *api.search(idx, Q, k=15,
                                                       mesh=mesh))]
    out["api_decoded_Xd"] = _np(idx.scan_index.Xd)
    out["api_decoded_x2"] = _np(idx.scan_index.x2)
    idx = api.index_base(model, Xb[:1500], mode="codes")
    Qc = Q[:5]
    out["api_codes"] = [_np(t) for t in (*api.search(idx, Qc, k=10,
                                                     mode="lut"),
                                         *api.search(idx, Qc, k=10,
                                                     mesh=mesh))]
    # a tie-saturated base: 24 copies of one vector in lane 0 of the
    # first shard overflow an r = 6 buffer, and the flagged queries must
    # be rescued through each rank's rows, never a whole-base unpack
    Xs, Qs = data["tie_Xb"], data["tie_Q"]
    idx = api.index_base(model, Xs, mode="codes")
    seen, flagged = [], []
    unpack, merged = scan_codes.unpack_codes, pmesh._merged

    def spy_unpack(packed, mp):
        seen.append(int(packed.shape[0]))
        return unpack(packed, mp)

    def spy_merged(mesh_, rows, k, part):
        flagged.append(bool(part[2].any()))
        return merged(mesh_, rows, k, part)

    scan_codes.unpack_codes, pmesh._merged = spy_unpack, spy_merged
    try:
        s2, i2 = api.search(idx, Qs, k=16, mesh=mesh, lut_dtype=torch.float32,
                            r=6, tile=1024, pack=True)
    finally:
        scan_codes.unpack_codes, pmesh._merged = unpack, merged
    Xd = _np(reconstruct_pq(model.codebooks, idx.codes, Xs.shape[1]))
    D = ((Qs[:, None, :] - Xd[None]) ** 2).sum(-1)
    out["api_rescue"] = dict(s=_np(s2), ref=np.sort(D, 1)[:, :16],
                             seen=seen, flagged=any(flagged))
    # training through the facade
    X = data["api_train_X"]
    ref = api.train(X, method="chainq", m=3, h=8, niter=2, device="cpu")
    got = api.train(X, method="chainq", m=3, h=8, niter=2, mesh=mesh)
    lsq = api.train(X, method="lsq", m=3, h=8, niter=2, mesh=mesh,
                    ilsiter=1, icmiter=1, npert=1, chunk=256)
    out["api_train"] = dict(ref=_np(ref.train_codes),
                            got=_np(got.train_codes),
                            cb=(tuple(got.codebooks.shape),
                                tuple(ref.codebooks.shape)),
                            lsq=(tuple(lsq.codebooks.shape),
                                 tuple(lsq.train_codes.shape)))


DRIVER_DATA = dict(d=8, ntrain=400, nbase=1003, nquery=200, ncenters=4,
                   seed=0, name="m", device="cpu")
DRIVER_KW = dict(m=3, h=4, niter=2, knn=10, verbose=False)
DRIVER_ILS = dict(ilsiter=2, icmiter=1, npert=1, chunk=256)
# the drivers' experiments and their own keywords (CompQ's beam must not
# be wider than h)
DRIVER_RUNS = (("chainq", drivers.experiment_chainq, {}),
               ("sr_d", drivers.experiment_sr, DRIVER_ILS),
               ("pq", drivers.experiment_pq, {}),
               ("opq", drivers.experiment_opq, {}),
               ("rvq", drivers.experiment_rvq, {}),
               ("ervq", drivers.experiment_ervq, {}),
               ("compq", drivers.experiment_compq, dict(H=4)))


def driver_runs(mesh=None) -> dict:
    """The drivers' experiments on a small base (ragged against 4
    ranks), with or without ``mesh`` → their codes, errors and recall
    curves."""
    ds = make_synthetic(**DRIVER_DATA)
    out = {}
    for name, fn, extra in DRIVER_RUNS:
        r = fn(torch.Generator().manual_seed(0), ds, mesh=mesh,
               **DRIVER_KW, **extra)
        C = r["C"] if "C" in r else r["model"].codebooks
        out[name] = dict(B_base=_np(r["B_base"]), C=_np(C),
                         train_error=r["train_error"],
                         base_error=r.get("base_error"),
                         recall=np.asarray(r["recall"]))
    return out


# `api.train`'s keywords per method in `_train_checks`: the LSQ family's
# ILS, CompQ's beam
API_KW = {"lsq": dict(ilsiter=1, icmiter=1, npert=1, chunk=256),
          "sr_c": dict(ilsiter=1, icmiter=1, npert=1, chunk=256),
          "sr_d": dict(ilsiter=1, icmiter=1, npert=1, chunk=256),
          "compq": dict(H=4)}
# (method, m) of the stochastic trainings held to the JAX package
STOCHASTIC = (("pq", 4), ("opq", 4), ("rvq", 3), ("ervq", 3), ("compq", 3))
# one seed's error moves by ~5% here (k-means++ at h = 16): a mean over 4
# seeds spreads by ~2.4%, two such means part by 5% about one time in
# seven; over 12 the gate of 5% stands at ~2.5 deviations
SEEDS = range(12)


def _picks(mesh, X, w, n, gen):
    """``n`` independent rows drawn by `kmeans.spread_pick` from the
    spread ``X`` (a `RowShard`) with weights ``w`` (its rows'): n sets
    of the same rows, one collective."""
    ranks = pmesh._ranks(mesh, X)
    nl = X.local.shape[0]
    u = torch.rand(n, 2, generator=gen, dtype=torch.float64)
    return tkm.spread_pick(u, X.local[None].expand(n, nl, -1),
                           w[None].expand(n, nl), ranks)[:, 0]


def _train_checks(mesh, rank, data, out):
    """The data-parallel trainers: a Lloyd step with empty clusters, one
    OPQ rotation step, ERVQ and CompQ from a fixed init, the seeding's
    draws on an even and on a ragged layout with an empty rank, the
    stochastic trainings through the facade, and every method through
    the facade on each rank's own rows."""
    X = _t(data["dp_lloyd_X"])
    rows = shard_data(mesh, X)
    ranks = pmesh._ranks(mesh, rows)
    a, mind2 = tkm.assign(rows.local, _t(data["dp_lloyd_C"]))
    out["dp_lloyd"] = _np(tkm.update_centers(
        rows.local, a, 12, _t(data["dp_lloyd_C"]), costs=mind2,
        ranks=ranks))
    Xo = _t(data["dp_opq_X"])
    rows = shard_data(mesh, Xo)
    model, _, obj = train_opq(torch.Generator().manual_seed(3), rows.local,
                              4, 8, niter=1, ranks=pmesh._ranks(mesh, rows))
    out["dp_opq"] = dict(R=_np(model.R), C=_np(model.codebooks),
                         obj=_np(obj))
    Xe, B0, C0 = (_t(data[k]) for k in ("dp_X", "dp_B0", "dp_C0"))
    model, B, err = train_ervq_sharded(mesh, Xe, B0, C0, niter=3)
    out["dp_ervq"] = dict(C=_np(model.codebooks), B=_np(B), err=float(err))
    for update in ("sgd", "lsq"):
        model, B, obj = train_compq_sharded(mesh, Xe, C0, B0, niter=4, H=4,
                                            chunk=512, update=update)
        out[f"dp_compq_{update}"] = dict(C=_np(model.codebooks), B=_np(B),
                                         obj=_np(obj))
    # the seeding's draws: 37 rows (value = global row + 1) with the
    # weights of `dp_w`, spread evenly and as (10, 0, 15, 12)
    vals = torch.arange(1, 38, dtype=torch.float32)[:, None]
    w = _t(data["dp_w"])
    sizes = (10, 0, 15, 12)
    st = sum(sizes[:rank])
    mine = host_local_to_global(mesh, vals[st:st + sizes[rank]])
    even = shard_data(mesh, vals)
    out["dp_picks"] = {
        layout: _np(_picks(mesh, X_, w[X_.start:X_.start
                                       + X_.local.shape[0]],
                           data["dp_npicks"],
                           torch.Generator().manual_seed(5)))
        for layout, X_ in (("even", even), ("empty rank", mine))}
    Xk = host_local_to_global(mesh, _t(data["dp_lloyd_X"][:37])[
        st:st + sizes[rank]])
    res = kmeans_sharded(mesh, torch.Generator().manual_seed(0), Xk, 4,
                         iters=3)
    out["dp_kmeans_empty_rank"] = dict(C=_np(res.centers),
                                       a=_np(res.assignments),
                                       obj=float(res.objective))
    # the stochastic trainings: `api.train(mesh=)`'s trainers at its
    # generator of each seed; ERVQ and CompQ from the seed's RVQ, which
    # is the RVQ stage `api.train` would run for them
    Xs = _t(data["dp_st_X"])
    st_out = {}

    def keep(method, seed, model, B):
        st_out[(method, seed)] = dict(C=_np(model.codebooks), B=_np(B),
                                      R=_np(model.R) if hasattr(model, "R")
                                      else None)
    for seed in SEEDS:
        gen = lambda: torch.Generator().manual_seed(seed)
        keep("pq", seed, *train_pq_sharded(mesh, gen(), Xs, 4, 16, 4)[:2])
        keep("opq", seed, *train_opq_sharded(mesh, gen(), Xs, 4, 16, 4)[:2])
        rvq, B0, _ = train_rvq_sharded(mesh, gen(), Xs, 3, 16, 4)
        keep("rvq", seed, rvq, B0)
        keep("ervq", seed,
             *train_ervq_sharded(mesh, Xs, B0, rvq.codebooks, 4)[:2])
        keep("compq", seed, *train_compq_sharded(
            mesh, Xs, rvq.codebooks, B0, niter=4, H=4)[:2])
    out["dp_stochastic"] = st_out
    # every method through the facade, each rank passing its own rows
    Xa = _t(data["api_train_X"][:403])
    sizes = (100, 0, 150, 153)
    st = sum(sizes[:rank])
    own = host_local_to_global(mesh, Xa[st:st + sizes[rank]])
    out["dp_api"] = {}
    for method in api.METHODS:
        mdl = api.train(own, method=method, m=3, h=8, niter=2, mesh=mesh,
                        **API_KW.get(method, {}))
        out["dp_api"][method] = dict(
            C=_np(mdl.codebooks), B=_np(mdl.train_codes),
            R=None if mdl.R is None else _np(mdl.R))


def _segment_checks(mesh, data, out):
    """Shards beyond the packed row-id range run in segments (the
    ranges cut small here)."""
    T, packed = _t(data["seg_T"]), _t(data["seg_packed"])
    Q, C = _t(data["seg_Q"]), _t(data["seg_C"])
    seg_codes, seg_decoded = scan_codes._DECODE_SEG, scan._SEG_DECODED
    scan_codes._DECODE_SEG = 512           # 1250 rows a shard
    try:
        out["seg_codes"] = [_np(t) for t in sharded_search_codes(
            mesh, T, packed, k=15, r=16, tile=2048,
            lut_dtype=torch.float32)]
        out["seg_decode"] = [_np(t) for t in sharded_search_codes_decode(
            mesh, Q, C, packed, k=15, pq=True, d=16, r=24, tile=1024,
            keep=0, op_dtype=torch.float32)]
    finally:
        scan_codes._DECODE_SEG = seg_codes
    Xd, Qd = _t(data["segd_Xd"]), _t(data["segd_Q"])
    x2 = (Xd * Xd).sum(-1)
    kw = dict(k=15, r=14, tile=1024, pack=True)
    whole = pmesh.sharded_search_exact(mesh, Xd, x2, Qd, **kw)
    scan._SEG_DECODED = 1024               # 1250 rows a shard
    try:
        cut = pmesh.sharded_search_exact(mesh, Xd, x2, Qd, **kw)
    finally:
        scan._SEG_DECODED = seg_decoded
    out["seg_decoded"] = [_np(t) for t in (*whole, *cut)]


def run_checks(rank: int, world: int, data: dict) -> dict:
    mesh = make_mesh(world, 1, device="cpu")
    mesh22 = make_mesh(2, world // 2, device="cpu")
    out = {"coords": (mesh.coords, mesh22.coords)}

    # search: the exact scan, the three kernel forms
    Q, C, B = _t(data["scan_Q"]), _t(data["scan_C"]), _t(data["scan_B"])
    out["scan"] = [_np(t) for t in sharded_scan_topk(mesh, Q, C, B, k=20,
                                                     tile=512)]
    T, packed = _t(data["codes_T"]), _t(data["codes_packed"])
    out["codes"] = [_np(t) for t in sharded_search_codes(
        mesh, T, packed, k=15, r=16, tile=2048, lut_dtype=torch.float32)]
    out["codes_f32"] = [_np(t) for t in sharded_search_codes(
        mesh, T, packed, k=15, lut_dtype=torch.float32, pack=False)]
    Qc, Cc = _t(data["codes_Q"]), _t(data["codes_C"])
    out["decode"] = [_np(t) for t in sharded_search_codes_decode(
        mesh, Qc, Cc, packed, k=15, pq=True, d=16, r=28, tile=1024, keep=4,
        op_dtype=torch.float32)]
    out["decode_qsuper"] = [_np(t) for t in sharded_search_codes_decode(
        mesh, Qc, Cc, packed, k=15, pq=True, d=16, r=28, bq=4, tile=1024,
        keep=4, op_dtype=torch.float32, qsuper=2)]
    Xd, Qd = _t(data["dec_Xd"]), _t(data["dec_Q"])
    x2 = (Xd * Xd).sum(-1)
    out["decoded"] = [_np(t) for t in sharded_search(
        mesh, Xd, x2, Qd, k=15, r=16, bq=8, tile=2048)]
    out["decoded_exact"] = [_np(t) for t in pmesh.sharded_search_exact(
        mesh, Xd, x2, Qd, k=15, r=16, tile=2048)]
    out["decoded_f32"] = [_np(t) for t in sharded_search(
        mesh, Xd, x2, Qd, k=15, pack=False)]

    # the statistics, the SR / LSQ step, the PQ Lloyd step
    Xs, Bs = _t(data["stats_X"]), _t(data["stats_B"])
    rows, brows = shard_data(mesh, Xs), shard_data(mesh, Bs)
    G, F = codebook_stats(rows.local, brows.local, 8, chunk=128)
    out["stats"] = [_np(pmesh._all_reduce(mesh, G)),
                    _np(pmesh._all_reduce(mesh, F))]
    X, B0 = _t(data["step_X"]), _t(data["step_B"])
    step = make_sr_train_step(mesh, h=8, niter=4, ilsiter=2, icmiter=2,
                              npert=1, method="LSQ", chunk=64,
                              stats_chunk=128)
    C1, B1, obj1 = step(X, B0, torch.zeros(3, 8, 16), 0,
                        torch.Generator().manual_seed(0))
    out["step"] = dict(C=_np(C1), B=_np(B1), obj=float(obj1))
    step_d = make_sr_train_step(mesh, h=8, niter=4, ilsiter=2, icmiter=2,
                                npert=1, chunk=64, stats_chunk=128)
    Cd, _, _ = step_d(shard_data(mesh, X), shard_data(mesh, B0), C1, 1,
                      torch.Generator().manual_seed(1))
    out["step_srd_C"] = _np(Cd)
    out["lloyd"] = [_np(t) for t in pq_lloyd_step_sharded(
        mesh22, _t(data["lloyd_X"]), _t(data["lloyd_C"]), 8)]

    # bootstrap: uneven local shares through host_local_to_global
    sizes = data["h2g_sizes"]
    st = sum(sizes[:rank])
    Bl = data["h2g_B"][st:st + sizes[rank]]
    g = host_local_to_global(global_mesh(device="cpu"), Bl)
    out["h2g"] = dict(start=g.start, n=g.n, rows=g.local.shape[0],
                      scan=[_np(t) for t in sharded_scan_topk(
                          mesh, _t(data["h2g_Q"]), _t(data["h2g_C"]), g,
                          k=10)])
    out["global_mesh"] = dict(global_mesh(n_model=2, device="cpu").shape)

    # ChainQ, the LSQ family, the encoders
    out["viterbi"] = _np(sharded_viterbi_encode(
        mesh, _t(data["vit_X"]), _t(data["vit_C"])))
    for key in ("cq", "cq_ragged"):
        Xc, Bc = _t(data[f"{key}_X"]), _t(data[f"{key}_B"])
        model, Bq, obj = train_chainq_sharded(
            mesh, Xc, Bc, torch.eye(12), h=8, niter=data[f"{key}_niter"])
        out[key] = dict(R=_np(model.R), B=_np(Bq), obj=_np(obj),
                        C=_np(model.codebooks))
    Xl, Bl0 = _t(data["lsq_X"]), _t(data["lsq_B"])
    gen = torch.Generator().manual_seed(0)
    lsq = {}
    for method, kw in (("LSQ", dict(niter=3, ilsiter=2, icmiter=2)),
                       ("SR_D", dict(niter=2, ilsiter=1, icmiter=1)),
                       ("SR_C", dict(niter=2, ilsiter=1, icmiter=1))):
        model, Bq, obj = train_lsq_family_sharded(
            mesh, gen, Xl, Bl0, torch.eye(12), h=8, npert=1, method=method,
            chunk=256, **kw)
        lsq[method] = dict(C=_np(model.codebooks), B=_np(Bq), obj=_np(obj))
    out["lsq"] = lsq
    out["icm"] = _np(sharded_encoding_icm(
        mesh, gen, _t(data["icm_X"]), _t(data["icm_C"]), _t(data["icm_B"]),
        ilsiter=2, icmiter=2, npert=1, chunk=128))

    _api_checks(mesh, data, out)
    _train_checks(mesh, rank, data, out)
    _segment_checks(mesh, data, out)
    out["drivers"] = driver_runs(mesh)
    return out


def run_two_hosts(rank: int, world: int, data: dict) -> dict:
    """Each of two ranks passes only its half of the codes."""
    mesh = global_mesh(device="cpu")
    n = data["B"].shape[0]
    half = n // world
    Bg = host_local_to_global(mesh, data["B"][rank * half:(rank + 1) * half])
    d, i = sharded_scan_topk(mesh, data["Q"], data["C"], Bg, k=10)
    return dict(n=Bg.n, start=Bg.start, d=_np(d), i=_np(i))
