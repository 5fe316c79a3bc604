"""The experiment protocols of the JAX package's BASELINE.md rows, run
through the port on the card, beside those rows.

    python3 -m rayuela_tpu_torch.demos.run_protocols [--shapes sift1m
        labelme mnist] [--trials-sift1m 2] [--trials-qb 10] [--seed 0]
        [--out FILE] [--device cuda]

* ``sift1m``: the 64-bit train/query/base protocol on SIFT1M's shape
  (BASELINE.md:57): ``read_dataset("synthetic-corr")`` (d = 128, 1e5
  train, 1e6 base, 1e4 queries, exact ground truth on the device), the
  nine methods at m = 8 (PQ/OPQ) or 7 + the norms byte, h = 256,
  niter = 10, knn = 1000, the chain init shared within a trial.
* ``labelme`` / ``mnist``: the query=base protocol on LabelMe22K's and
  MNIST's shapes (BASELINE.md:53-54, the data of the JAX package's
  `demos/bench_query_base10.py`: synthetic-corr from seed 7, 20,019 /
  60,000 training vectors searched as the base, 2,000 / 10,000
  queries, ground truth recomputed on the device).

Each trial runs through the runner's per-trial function without a
results store (the card's machine has no h5py), trial t keyed by
``seed + t`` as the public runners key it. Per method the script prints
recall@1 as mean ± sample std over the trials beside the JAX row, and
the mean seconds of training, base encode and search; ``--out`` writes
the rows, the trials and the card's name and power limit as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

# recall@1 of the JAX package's runs (BASELINE.md): the 64-bit SIFT1M
# shape (:57, one trial a method), and mean and std over 10 trials of
# the query=base shapes (:53, :54)
JAX_ROWS = {
    "sift1m": {"pq": .1669, "opq": .3399, "rvq": .9985, "ervq": .9995,
               "chainq": .8734, "lsq": .9977, "sr_c": .9820,
               "sr_d": .9984, "compq": .9985},
    "labelme": {"pq": (.0627, .0050), "opq": (.0755, .0048),
                "rvq": (.4004, .0134), "ervq": (.4043, .0156),
                "chainq": (.1522, .0063), "lsq": (.2779, .0091),
                "sr_c": (.1535, .0106), "sr_d": (.2838, .0122),
                "compq": (.4288, .0112)},
    "mnist": {"pq": (.0338, .0022), "opq": (.0470, .0028),
              "rvq": (.3096, .0046), "ervq": (.3131, .0057),
              "chainq": (.1174, .0111), "lsq": (.2212, .0069),
              "sr_c": (.1817, .0063), "sr_d": (.2308, .0044),
              "compq": (.2926, .0101)},
}
# the high-recall ladder (BASELINE.md:58): SR-D-7 on the SIFT1M shape,
# recall@1 by the base encode's ILS budget
JAX_LADDER = {1: .9356, 4: .9929, 16: .9981, 64: .9993}
QB_SHAPES = {"labelme": (20019, 2000), "mnist": (60000, 10000)}
PROTOCOL = dict(m=8, h=256, niter=10, knn=1000)


def dataset(shape: str, device=None):
    """The protocol's dataset on ``shape`` (the ground truth computed
    on ``device``)."""
    from rayuela_tpu_torch.experiments.datasets import (make_synthetic,
                                                        read_dataset)
    from rayuela_tpu_torch.experiments.drivers import _query_base

    if shape == "sift1m":
        return read_dataset("synthetic-corr", device=device)
    ntrain, nquery = QB_SHAPES[shape]
    ds = make_synthetic(d=128, ntrain=ntrain, nbase=4096, nquery=nquery,
                        ncenters=64, seed=7, corr=True,
                        name=f"synthetic-corr-qb-{shape}", device=device)
    return _query_base(ds, device)


def rows(ds, trials, seed: int = 0, device=None, methods=None,
         verbose: bool = False) -> dict:
    """``{method: {"recall1": [...], "seconds": [{stage: s}, ...]}}``
    over ``trials``, each through the runner's per-trial function
    without a store."""
    from rayuela_tpu_torch.experiments.drivers import ALL_METHODS, _run_trial

    out: dict = {}
    for t in trials:
        res = _run_trial(ds, t, None, methods=methods or ALL_METHODS,
                         verbose=verbose, seed=seed, device=device,
                         **PROTOCOL)
        for meth, o in res.items():
            rec = out.setdefault(meth, {"recall1": [], "seconds": []})
            rec["recall1"].append(float(o["recall"][0]))
            rec["seconds"].append(o["seconds"])
    return out


def spread(vals) -> tuple[float, float]:
    """``(mean, sample std)``; the std is 0 for one value."""
    v = np.asarray(vals, np.float64)
    return float(v.mean()), float(v.std(ddof=1)) if len(v) > 1 else 0.0


def report(shape: str, table: dict) -> None:
    for meth, rec in table.items():
        mean, sd = spread(rec["recall1"])
        ref = JAX_ROWS[shape][meth]
        ref = (f"{ref[0]:.4f} ± {ref[1]:.4f}" if isinstance(ref, tuple)
               else f"{ref:.4f}")
        secs = {k: np.mean([s[k] for s in rec["seconds"]])
                for k in rec["seconds"][0]}
        print(f"  {shape} {meth:6s} recall@1 {mean:.4f} ± {sd:.4f} over "
              f"{len(rec['recall1'])} (JAX {ref}); s a trial: train "
              f"{secs['train']:.2f}, base encode {secs['encode']:.2f}, "
              f"search {secs['search']:.2f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["sift1m", "labelme"],
                    choices=["sift1m", "labelme", "mnist"])
    ap.add_argument("--trials-sift1m", type=int, default=2)
    ap.add_argument("--trials-qb", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    card = None
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(card)
    result = {"card": card, "shapes": {}}
    for shape in args.shapes:
        t0 = time.perf_counter()
        ds = dataset(shape, args.device)
        t1 = time.perf_counter()
        n = args.trials_sift1m if shape == "sift1m" else args.trials_qb
        table = rows(ds, range(n), args.seed, args.device)
        wall = time.perf_counter() - t1
        print(f"== {shape}: {n} trials, data + ground truth "
              f"{t1 - t0:.1f} s, protocol {wall:.1f} s")
        report(shape, table)
        result["shapes"][shape] = {"trials": n, "data_s": t1 - t0,
                                   "wall_s": wall, "rows": table}
        del ds
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
