"""Time the ICM kernels K11 `icm_sweeps` (icmiter = 4) and K12
`encoding_ils` (8 rounds) at the shapes the main path gives them, and
hold two versions' outputs to each other bit for bit on integer data.

    python3 rayuela_tpu_torch/demos/time_icm.py [--root DIR]
        [--out FILE] [--against FILE] [--reps N]

Each line is one JSON object (CUDA events, the mean of ``--reps`` calls
after a warm one; the first line names the card and its power limit):
K11 and K12 on n = 1e5 vectors at d = 128 and GIST's d = 960, m = 7 and
15 codebooks of h = 256 (SR-D-7+1's and SR-D-15+1's encoders), Gaussian
vectors and codebooks scaled as a trained model's, random start codes;
K12 with 4 redraws a round and one visit order a round. Each carries the
bound of the call: its visits' products, 2 n icmiter m h d operations
(per round for K12), at the bf16 tensor-core peak of an H100 SXM (989
TFLOP/s). Then both kernels once on small-integer data (n = 9,999, the
same widths): exact in bf16 and in any f32 sum order, so every version
must give the same codes and energies.

Every output carries a digest (`time_exact.digest`). ``--out FILE``
writes them; ``--against FILE`` asserts that this run's equal those in
FILE for the integer-data cases (exit 1 otherwise) and reports the
Gaussian ones, whose f32 sums may round otherwise in another version.
``--root DIR`` imports ``rayuela_tpu_torch`` from DIR (an unpacked
earlier commit; run the file by its path, not with ``-m``), so two
versions run on one card in one call, in turns: the parent with
``--out``, then this version with ``--against``, then the parent again.
The data come from fixed seeds, the same in every run.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


N, H, ICMITER, ILSITER, NPERT = 100_000, 256, 4, 8, 4
SHAPES = ((128, 7), (128, 15), (960, 7), (960, 15))   # (d, m)
PEAK = 989e12


def _sibling(name: str):
    """A script of this directory as a module (not through the package,
    which ``--root`` may take from another tree)."""
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    root = args.root or str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from rayuela_tpu_torch.ops import icm as ticm

    digest = _sibling("time_exact").digest

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": root, "card": smi}), flush=True)

    def ms(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    digests, exact = {}, {}

    def emit(case, rec, outs, is_exact):
        rec = {"root": root, "case": case, **rec}
        digests[case] = rec["digest"] = digest(*outs)
        exact[case] = rec["exact"] = is_exact
        print(json.dumps(rec), flush=True)

    def operands(kind, n, d, m, seed):
        rng = np.random.default_rng(seed)
        if kind == "int":
            X = rng.integers(-1, 2, (n, d))
            C = rng.integers(-1, 2, (m, H, d))
        else:
            X = rng.standard_normal((n, d))
            C = rng.standard_normal((m, H, d)) * 0.3
        t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,
                                                        device=dev)
        return (t(X), t(C), t(rng.integers(0, H, (n, m)), torch.int32),
                t(rng.permutation(m), torch.int32),
                t(np.stack([rng.permutation(m) for _ in range(ILSITER)]),
                  torch.int32))

    for kind, n in (("gauss", N), ("int", 9_999)):
        for d, m in SHAPES:
            X, C, B, order, orders = operands(kind, n, d, m, d + m)
            fn11 = lambda: ticm.icm_sweeps(X, C, B, order, ICMITER)
            fn12 = lambda: ticm.encoding_ils(X, C, B, orders, 12345,
                                             ilsiter=ILSITER,
                                             icmiter=ICMITER, npert=NPERT)
            ops = 2.0 * n * ICMITER * m * H * d
            shape = {"d": d, "m": m, "h": H, "n": n, "data": kind}
            rec11 = {"kernel": "icm_sweeps", "icmiter": ICMITER, **shape}
            rec12 = {"kernel": "encoding_ils", "ilsiter": ILSITER,
                     "icmiter": ICMITER, **shape}
            if kind == "gauss":
                reps = args.reps if d <= 256 else 1
                rec11.update(ms=ms(fn11, reps), bound_ms=ops / PEAK * 1e3)
                rec12.update(ms=ms(fn12, reps),
                             bound_ms=ILSITER * ops / PEAK * 1e3)
            emit(f"icm_sweeps {kind} d={d} m={m}", rec11, fn11(),
                 kind == "int")
            emit(f"encoding_ils {kind} d={d} m={m}", rec12, fn12(),
                 kind == "int")
            del X, C, B
            torch.cuda.empty_cache()

    if args.out:
        Path(args.out).write_text(json.dumps(digests, indent=1))
    if args.against:
        ref = json.loads(Path(args.against).read_text())
        both = [c for c in digests if c in ref]
        diff = sorted(c for c in both if ref[c] != digests[c])
        bad = [c for c in diff if exact[c]]
        print(json.dumps({"root": root, "against": args.against,
                          "identical": sorted(set(both) - set(diff)),
                          "different": diff, "different_exact": bad}),
              flush=True)
        if bad or not both:
            print(f"outputs differ from {args.against}: {bad}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
