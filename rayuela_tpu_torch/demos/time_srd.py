"""Train SR-D-7+1 over several seeds and report its quality: the seed
spread of the LSQ++ main path on `chip_smoke.py` phase 4's data.

    python3 rayuela_tpu_torch/demos/time_srd.py [--root DIR]
        [--seeds 0 1 2] [--out FILE] [--save DIR | --load DIR]
        [--plain-icm]
    python3 rayuela_tpu_torch/demos/time_srd.py --compare A.json[,A2.json]
        B.json[,B2.json]

Phase 4's data (synthetic-corr from seed 0: d = 128, 1e5 train, 1e6
base, 1e4 queries, exact ground truth), then for each training seed
``api.train(method="sr_d", m=7, h=256, niter=10, seed=s)`` →
``api.index_base`` in codes mode and in the default decoded mode →
``api.search(k=100)`` → ``eval_recall``. Each line is one JSON object
(the first names the card and its power limit): the train seconds,
the train qerror, the base qerror of the encoded base, recall@1
through the codes index and the decoded index, recall@1 of the exact
f32 scan of the decoded base with its exact norms (no norms byte, no
bf16), and the RMS error of the quantized norms over the base; the last
line holds their means and sample standard deviations over the seeds.

``--root DIR`` imports ``rayuela_tpu_torch`` from DIR (an unpacked
earlier commit; run the file by its path, not with ``-m``), so two
versions are held to each other on one card in one call. ``--out
FILE`` writes the records as one JSON list. ``--save DIR`` keeps each
seed's model (codebooks and training codes); ``--load DIR`` takes those
models instead of training, so one version's models are encoded and
searched by another's kernels. ``--plain-icm`` trains with K11's
plain version (`icm_sweeps_plain` at the kernel's bf16 objective, on the
card) in place of the kernel, a third sum order of the same visit; the
base is encoded by the kernel as before.

``--compare A B`` (no card needed) pairs two sets of ``--out`` files
(each a comma-separated list, joined by seed) seed for seed and prints,
for each metric and each side, the median, mean and sample standard
deviation, the robust one (1.4826 median absolute deviations), the
lowest value and its seed and the count below 0.99; then the seeds on
which A lies above and below B and the two-sided p of the sign test
and of Wilcoxon's signed-rank test on the differences.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

D, NTRAIN, NBASE, NQ = 128, 100_000, 1_000_000, 10_000


def spread(vals):
    """``(mean, sample standard deviation)`` of ``vals``."""
    n = len(vals)
    mean = sum(vals) / n
    var = sum((v - mean) ** 2 for v in vals) / max(1, n - 1)
    return mean, var ** 0.5


def exact_recall1(Xq, C, B, gt, qblock=1024):
    """recall@1 of the exact f32 scan of ``reconstruct(C, B)`` with its
    exact squared norms."""
    import torch

    from rayuela_tpu_torch.ops.qerror import reconstruct
    from rayuela_tpu_torch.utils import exact_f32
    exact_f32()
    Xd = reconstruct(C, B)
    x2 = (Xd * Xd).sum(-1)
    top = torch.cat([torch.addmm(x2[None, :], Xq[q0:q0 + qblock], Xd.T,
                                 alpha=-2.0).argmin(1)
                     for q0 in range(0, Xq.shape[0], qblock)])
    gt = torch.as_tensor(gt, device=top.device).reshape(-1)
    return float((top == gt).float().mean())


KEYS = ("train_qerror", "base_qerror", "recall1_codes", "recall1_decoded",
        "recall1_exact", "norms_rmse")


def compare(paths_a, paths_b):
    """Paired statistics of two sets of ``--out`` files (comma-separated
    paths, joined by seed), one JSON line a metric."""
    from statistics import median

    from scipy.stats import binomtest, wilcoxon

    def load(paths):
        return {r["seed"]: r for p in paths.split(",")
                for r in json.loads(Path(p).read_text()) if "seed" in r}

    def arm(vals, seeds):
        mid = median(vals)
        low = min(range(len(vals)), key=vals.__getitem__)
        return {"median": mid, "mean_sd": spread(vals),
                "mad_sd": 1.4826 * median(abs(v - mid) for v in vals),
                "min": vals[low], "min_seed": seeds[low],
                "under_0.99": sum(v < 0.99 for v in vals)}

    a, b = load(paths_a), load(paths_b)
    for key in KEYS:
        seeds = [s for s in sorted(set(a) & set(b))
                 if key in a[s] and key in b[s]]
        if not seeds:
            continue
        va, vb = [a[s][key] for s in seeds], [b[s][key] for s in seeds]
        diff = [x - y for x, y in zip(va, vb)]
        above = sum(d > 0 for d in diff)
        below = sum(d < 0 for d in diff)
        print(json.dumps({
            "metric": key, "pairs": len(seeds), "a": paths_a, "b": paths_b,
            "arm_a": arm(va, seeds), "arm_b": arm(vb, seeds),
            "a_above_b": above, "a_below_b": below,
            "sign_p": binomtest(above, above + below).pvalue
            if above + below else 1.0,
            "wilcoxon_p": float(wilcoxon(va, vb).pvalue)
            if above + below else 1.0}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--load", default=None)
    ap.add_argument("--plain-icm", action="store_true")
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return 0
    root = args.root or str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, root)
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.experiments.datasets import make_synthetic
    from rayuela_tpu_torch.ops import icm as ticm
    from rayuela_tpu_torch.ops.qerror import qerror, veccost_chunked
    from rayuela_tpu_torch.search.linscan import eval_recall
    from rayuela_tpu_torch.search.norms import quantize_norms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": root, "card": smi}), flush=True)
    kernel_icm = ticm.IcmOperands, ticm._sweeps

    class PlainOperands(ticm.IcmOperands):
        def __init__(self, X, C):
            super().__init__(X, C)
            self.X, self.C = X, C

    plain_icm = PlainOperands, (lambda ops, B, order, icmiter:
                                ticm.icm_sweeps_plain(ops.X, ops.C, B, order,
                                                      icmiter))
    ds = make_synthetic(d=D, ntrain=NTRAIN, nbase=NBASE, nquery=NQ,
                        corr=True, seed=0, name="synthetic-corr",
                        device="cuda")
    Xt = torch.as_tensor(ds.Xt, device="cuda")
    Xb = torch.as_tensor(ds.Xb, device="cuda")
    Xq = torch.as_tensor(ds.Xq, device="cuda")
    recs = []
    for seed in args.seeds:
        k11 = ticm.icm_sweeps.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if args.load:
            model = rq.MCQModel("sr_d", h=256, **torch.load(
                Path(args.load) / f"sr_d_{seed}.pt", map_location="cuda"))
        else:
            if args.plain_icm:
                ticm.IcmOperands, ticm._sweeps = plain_icm
            model = rq.train(Xt, method="sr_d", m=7, h=256, niter=10,
                             seed=seed)
            ticm.IcmOperands, ticm._sweeps = kernel_icm
        torch.cuda.synchronize()
        if args.save:
            Path(args.save).mkdir(parents=True, exist_ok=True)
            torch.save({"codebooks": model.codebooks,
                        "train_codes": model.train_codes},
                       Path(args.save) / f"sr_d_{seed}.pt")
        rec = {"root": root, "seed": seed, "model": args.load or root,
               "icm": "plain" if args.plain_icm else "kernel",
               "train_s": time.perf_counter() - t0,
               "train_k11_launches": ticm.icm_sweeps.launches - k11,
               "train_qerror": float(qerror(Xt, model.codebooks,
                                            model.train_codes))}
        for mode in ("codes", "decoded"):
            index = rq.index_base(model, Xb, mode=mode)
            if mode == "codes":
                rec["base_qerror"] = float(veccost_chunked(
                    Xb, model.codebooks, index.codes).mean())
                rec["recall1_exact"] = exact_recall1(
                    Xq, model.codebooks, index.codes, ds.gt)
                _, exact = quantize_norms(model.codebooks, index.codes,
                                          index.norms_codebook)
                err = index.norms_codebook[index.norm_codes.long()] - exact
                rec["norms_rmse"] = float((err * err).mean().sqrt())
            _, ids = rq.search(index, Xq, k=100)
            rec[f"recall1_{mode}"] = float(
                eval_recall(ids, ds.gt, verbose=False)[0])
            del index, ids
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    summary = {"root": root, "seeds": args.seeds,
               **{k: spread([r[k] for r in recs]) for k in KEYS}}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(recs + [summary], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
