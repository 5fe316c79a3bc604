"""The multi-process dry run (counterpart of the JAX package's
``__graft_entry__.py``) and the helper that spawns its ranks.

`entry()` returns the deployment hot path of the flagship model: the ADC
scan with quantized-norms terms (`linscan.scan_topk` with a norm term).
`dryrun_multichip(n)` spawns ``n`` gloo ranks on the CPU, builds a
``(data, model)`` mesh over them and runs the sharded steps at the
protocol's shapes (m = 8, h = 256, d = 128, n = 2048). `run_ranks`
spawns a world of ranks for any module-level function and returns what
each returned.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch


def _synth(n=4096, d=64, m=8, h=256, nq=32, seed=0, full_dim=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    ds = d if full_dim else d // m
    C = rng.standard_normal((m, h, ds)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m)).astype(np.int32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    return X, C, B, Q


def entry(device=None):
    """``(fn, example_args)``: the LSQ-style ADC scan with a norm term at
    the JAX entry's shapes (n = 4096, d = 64, m = 4, h = 256, 32
    queries, k = 100), its arguments on ``device`` (the card unless the
    caller asks for the CPU)."""
    from rayuela_tpu_torch.search.linscan import scan_topk

    device = "cuda" if device is None else device
    _, C, B, Q = _synth(m=4, full_dim=True)
    rng = np.random.default_rng(1)
    dbnorms = rng.random(B.shape[0]).astype(np.float32) * 4.0

    def fn(Q, C, B, dbnorms):
        return scan_topk(Q, C, B, k=100, pq=False, tile=2048,
                         norm_term=dbnorms)

    return fn, tuple(torch.as_tensor(a, device=device)
                     for a in (Q, C, B, dbnorms))


def _rank_main(fn, rank: int, world: int, tmp: str, pg_timeout: float,
               threads: int | None) -> None:
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=pg_timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, args=(), *, timeout: float = 120.0,
              pg_timeout: float = 60.0, threads: int | None = 1) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` processes started by
    the ``spawn`` method, joined into one gloo process group through a
    file store in a fresh temporary directory; returns each rank's
    result, in rank order. ``fn`` is a module-level function, ``args``
    and its result picklable; the arguments go through a file (through
    the start pipe, a large argument would hold each start until the
    previous rank had read it). Collectives time out after
    ``pg_timeout`` seconds and the ranks must end within ``timeout``; a
    rank that fails, hangs or exits non-zero raises RuntimeError (the
    others are stopped). ``threads`` caps each rank's torch threads."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rq_ranks_")
    torch.save(tuple(args), os.path.join(tmp, "args.pt"))
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, tmp, pg_timeout, threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        failed = []
        for r, p in enumerate(procs):
            if p.is_alive():
                failed.append(f"rank {r} did not end within {timeout} s")
            elif p.exitcode != 0:
                err = outs[r] + ".err"
                msg = open(err).read() if os.path.exists(err) else ""
                failed.append(f"rank {r} exited {p.exitcode}\n{msg}")
        if failed:
            raise RuntimeError("\n".join(failed))
        return [torch.load(o, weights_only=False) for o in outs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)


def _dryrun_rank(rank: int, world: int) -> dict:
    from rayuela_tpu_torch.ops.codebook_update import (_solve_direct,
                                                       codebook_stats)
    from rayuela_tpu_torch.ops.qerror import qerror
    from rayuela_tpu_torch.parallel.lsq_sharded import make_sr_train_step
    from rayuela_tpu_torch.parallel.mesh import (make_mesh,
                                                 pq_lloyd_step_sharded,
                                                 shard_data,
                                                 sharded_scan_topk)
    from rayuela_tpu_torch.search.linscan import scan_topk

    n_model = 2 if world % 2 == 0 else 1
    mesh = make_mesh(world // n_model, n_model, device="cpu")

    # the SR-D step at the protocol's shapes: the (2048, 2048) system
    mp, hp, np_, dp_ = 8, 256, 2048, 128
    Xp, _, Bp, _ = _synth(n=np_, d=dp_, m=mp, h=hp, full_dim=True)
    Xs, Bs = shard_data(mesh, Xp), shard_data(mesh, Bp)
    C0 = torch.zeros(mp, hp, dp_)
    step = make_sr_train_step(mesh, h=hp, niter=4, ilsiter=2, icmiter=2,
                              npert=1, chunk=256, stats_chunk=512)
    C1, B1, obj1 = step(Xs, Bs, C0, 0, torch.Generator().manual_seed(0))
    C2, B2, obj2 = step(Xs, B1, C1, 1, torch.Generator().manual_seed(1))
    assert float(obj2) < float(obj1), "the sharded SR step must improve"

    # the LSQ step's solve equals the single-rank solve
    step_lsq = make_sr_train_step(mesh, h=hp, niter=4, ilsiter=1,
                                  icmiter=1, npert=1, method="LSQ",
                                  chunk=256, stats_chunk=512)
    C1l, _, _ = step_lsq(Xs, Bs, C0, 0, torch.Generator().manual_seed(0))
    Xt, Bt = torch.from_numpy(Xp), torch.from_numpy(Bp)
    C_ref = _solve_direct(*codebook_stats(Xt, Bt, hp), hp, 1e-4)
    e_sh, e_ref = float(qerror(Xt, C1l, Bt)), float(qerror(Xt, C_ref, Bt))
    solve_rel = abs(e_sh - e_ref) / max(e_ref, 1e-9)
    assert solve_rel < 1e-3, f"sharded solve {e_sh} != single {e_ref}"

    # the PQ Lloyd step on the (data, model) mesh
    m, h, n, d, nq = 4, 16, 512, 32, 8
    X, Cf, B, Q = _synth(n=n, d=d, m=m, h=h, nq=nq, full_dim=True)
    Xsub = torch.from_numpy(X).reshape(n, m, d // m).permute(1, 0, 2)
    cent = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (m, h, d // m)).astype(np.float32))
    cent, pq_obj = pq_lloyd_step_sharded(mesh, Xsub, cent, h)
    assert cent.shape == (m, h, d // m) and torch.isfinite(pq_obj)

    # the sharded scan equals the local one
    dists, ids = sharded_scan_topk(mesh, Q, Cf, shard_data(mesh, B), k=10,
                                   tile=256)
    d_ref, i_ref = scan_topk(torch.from_numpy(Q), torch.from_numpy(Cf),
                             torch.from_numpy(B), k=10, tile=256)
    assert torch.equal(ids, i_ref), "sharded scan != local scan"
    assert torch.allclose(dists, d_ref, rtol=1e-5, atol=1e-4)
    return dict(mesh=dict(mesh.shape), sr_obj=float(obj2),
                solve_rel=solve_rel, pq_obj=float(pq_obj))


def dryrun_multichip(n_devices: int) -> dict:
    """Spawn ``n_devices`` gloo ranks on the CPU, a ``(n/2, 2)`` mesh (or
    ``(n, 1)`` for odd n), and check on each: the SR-D step at the
    protocol's shapes improves its objective; the LSQ step's (2048,
    2048) solve equals the single-rank solve; the PQ Lloyd step runs
    over both axes; the sharded scan equals the local one. Raises if a
    rank fails; returns rank 0's summary."""
    res = run_ranks(_dryrun_rank, n_devices, timeout=300.0)[0]
    print(f"dryrun_multichip ok: mesh={res['mesh']} "
          f"sr_obj(m8,h256,d128)={res['sr_obj']:.4f} "
          f"solve2048_match={res['solve_rel']:.2e} "
          f"pq_obj={res['pq_obj']:.4f}")
    return res


if __name__ == "__main__":
    import sys
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
