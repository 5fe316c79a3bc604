"""`rayuela-demo-torch` console entry (counterpart of
`rayuela_tpu/cli.py`): the reference's `demos/demos_train_query_base.jl`
/ `demos_query_base.jl` as a CLI.

Runs every MCQ method at equal bits per vector on a dataset (SIFT1M et
al. from $RAYUELA_DATA, or the synthetic family on any machine) on the
card (``--device cpu`` asks for the CPU), stores per-trial results to
HDF5, prints recall tables, and writes the recall plot.

Examples:
  rayuela-demo-torch --dataset synthetic-small --m 4 --h 16 --niter 3 --knn 100
  rayuela-demo-torch --dataset sift1m --m 8 --ntrials 10
  rayuela-demo-torch --dataset mnist --protocol query_base
  python -m rayuela_tpu_torch.cli --device cpu --dataset synthetic-small
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="synthetic-small")
    ap.add_argument("--m", type=int, default=8,
                    help="codebooks for orthogonal methods; "
                         "non-orthogonal use m-1 + norms byte")
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=25)
    ap.add_argument("--ntrials", type=int, default=1)
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--methods", nargs="*", default=None)
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--protocol", choices=["train_query_base",
                                           "query_base"],
                    default="train_query_base")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="skip (method, trial) pairs already in the "
                         "results store — the reference's staged-HDF5 "
                         "crash recovery")
    ap.add_argument("--device", default="cuda",
                    help="torch device the protocol runs on")
    args = ap.parse_args()

    from rayuela_tpu_torch.experiments.drivers import (ALL_METHODS,
                                                       run_query_base,
                                                       run_train_query_base)
    from rayuela_tpu_torch.experiments.viz import (load_recalls, make_plots,
                                                   print_recalls)

    methods = tuple(args.methods) if args.methods else ALL_METHODS
    runner = (run_train_query_base
              if args.protocol == "train_query_base" else run_query_base)
    results = runner(args.dataset, m=args.m, h=args.h, niter=args.niter,
                     ntrials=args.ntrials, knn=args.knn, methods=methods,
                     results_dir=args.results_dir, seed=args.seed,
                     resume=args.resume, device=args.device)

    name = args.dataset
    print("\n=== recall summary ===")
    for method in results:
        try:
            print_recalls(load_recalls(args.results_dir, name, method),
                          label=method)
        except FileNotFoundError:
            pass
    png = make_plots(args.results_dir, name, list(results))
    print(f"plot written to {png}")


if __name__ == "__main__":
    main()
