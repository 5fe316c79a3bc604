"""Time the data-parallel trainers' k-means++ seeding on one card: where
a pick over the mesh's ranks spends its time, beside the single-device
pick.

    python3 rayuela_tpu_torch/demos/time_train_sharded.py [--root DIR]
        [--n 100000] [--d 128] [--k 256] [--picks-only] [--out FILE]
    python3 rayuela_tpu_torch/demos/time_train_sharded.py --device cpu \\
        --n 5000 --k 32

A world of 1 over NCCL in this process (gloo with ``--device cpu``),
`parallel.make_mesh` over it, and Gaussian X (n, d) from seed 0. Each
time is the best of 3 calls (`demos.best_ms`: CUDA events on the card),
divided by the k - 1 picks where it says "a pick":

1. ``init``: `ops.kmeans.kmeanspp_init` (single device,
   `torch.multinomial`), ms a pick;
2. ``spread``: `kmeanspp_spread` over the mesh's ``data`` ranks, ms a
   pick;
3. ``spread_alone``: `kmeanspp_spread` over a `utils.Ranks` of this
   process alone, whose sum and gather return their input: the same
   launches without a collective, ms a pick;
4. ``all_gather`` / ``all_reduce``: `mesh._all_gather` and
   `mesh._all_reduce` of one pick's (1, d + 1) f64 alone, ms a call;
5. ``spread_issue``: the host clock from the call of (2) to its return,
   before the synchronize, ms a pick (near (2): the host sets the pace);
6. ``lloyd`` / ``lloyd_mesh``: one `update_centers` with its repick at
   k centres, single device and over the mesh, ms;
7. ``rvq`` / ``rvq_mesh``: `train_rvq` (m = 7, h = k, niter = 10),
   single device and `parallel.train_rvq_sharded`, s (the host clock to
   a synchronize);
8. ``profile``: `torch.profiler` over (2) at k = 64, the ops by host
   time: calls, host and device µs a pick, and the kernel launches a
   pick.

Each line of the output is one JSON object; the first names the card and
its power limit. ``--picks-only`` stops after (1)-(6), so that short
runs of two versions alternate in one call. ``--root DIR`` imports
``rayuela_tpu_torch`` from DIR (an unpacked earlier commit; run the file
by its path, not with ``-m``), so two versions are held to each other
on one card in one call. ``--out FILE`` writes the records as one JSON list.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--picks-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = args.root or str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, root)

    import torch
    import torch.distributed as dist

    from rayuela_tpu_torch.demos import best_ms
    from rayuela_tpu_torch.ops import kmeans as tkm
    from rayuela_tpu_torch.parallel import make_mesh
    from rayuela_tpu_torch.parallel import mesh as pmesh
    from rayuela_tpu_torch.utils import Ranks

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip() if on_card else "cpu")
    records = [{"root": root, "card": smi}]
    print(json.dumps(records[0]), flush=True)

    def emit(**rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="time_train_sharded_")
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"file://{tmp}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(device=dev)
        n, d, k = args.n, args.d, args.k
        X = torch.randn(n, d, generator=torch.Generator().manual_seed(0)
                        ).to(dev)
        rows = pmesh.shard_data(mesh, X)
        ranks = pmesh._ranks(mesh, rows)
        alone = Ranks(lambda t: t.clone(), lambda t: [t], 0, 0, n)
        gen = lambda: torch.Generator(device=dev).manual_seed(0)
        X3 = X[None]
        picks = k - 1

        t = {}
        t["init"] = best_ms(lambda: tkm.kmeanspp_init(gen(), X, k), 3,
                            on_card) / picks
        t["spread"] = best_ms(lambda: tkm.kmeanspp_spread(gen(), X3, k,
                                                          ranks),
                              3, on_card) / picks
        t["spread_alone"] = best_ms(lambda: tkm.kmeanspp_spread(
            gen(), X3, k, alone), 3, on_card) / picks
        one = torch.zeros(1, d + 1, dtype=torch.float64, device=dev)
        t["all_gather"] = best_ms(lambda: [pmesh._all_gather(mesh, one)
                                           for _ in range(picks)],
                                  3, on_card) / picks
        t["all_reduce"] = best_ms(lambda: [pmesh._all_reduce(mesh, one)
                                           for _ in range(picks)],
                                  3, on_card) / picks
        issue = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            tkm.kmeanspp_spread(gen(), X3, k, ranks)
            issue.append((time.perf_counter() - t0) * 1e3 / picks)
            sync()
        t["spread_issue"] = min(issue)
        C = tkm.kmeanspp_init(gen(), X, k)
        a, mind2 = tkm.assign(X, C)
        t["lloyd"] = best_ms(lambda: tkm.update_centers(
            X, a, k, C, costs=mind2), 3, on_card)
        t["lloyd_mesh"] = best_ms(lambda: tkm.update_centers(
            X, a, k, C, costs=mind2, ranks=ranks), 3, on_card)
        emit(n=n, d=d, k=k, ms=t)
        if not args.picks_only:
            train_and_profile(mesh, X, k, ranks, gen, sync, on_card, emit)
    finally:
        dist.destroy_process_group()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


def train_and_profile(mesh, X, k, ranks, gen, sync, on_card, emit):
    """(7) and (8)."""
    from rayuela_tpu_torch.models.rvq import train_rvq
    from rayuela_tpu_torch.ops import kmeans as tkm
    from rayuela_tpu_torch.parallel import train_rvq_sharded

    X3 = X[None]
    secs = {}
    for name, fn in (("rvq", lambda: train_rvq(gen(), X, 7, k,
                                               niter=10)),
                     ("rvq_mesh", lambda: train_rvq_sharded(
                         mesh, gen(), X, 7, k, niter=10))):
        fn()
        best = float("inf")
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        secs[name] = best
    emit(train_s=secs, m=7, h=k, niter=10)

    from torch.profiler import ProfilerActivity, profile
    kp = 64
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    tkm.kmeanspp_spread(gen(), X3, kp, ranks)
    sync()
    with profile(activities=acts) as prof:
        tkm.kmeanspp_spread(gen(), X3, kp, ranks)
        sync()
    rows_ = []
    launches = 0
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                     "cudaLaunchKernelExC"):
            launches += e.count
        rows_.append(dict(op=e.key, calls=e.count / (kp - 1),
                          host_us=e.self_cpu_time_total / (kp - 1),
                          device_us=dev_us / (kp - 1)))
    rows_.sort(key=lambda r: -r["host_us"])
    emit(profile=rows_[:25], launches_a_pick=launches / (kp - 1), k=kp)


if __name__ == "__main__":
    sys.exit(main())
