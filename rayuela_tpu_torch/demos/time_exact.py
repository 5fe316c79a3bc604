"""Time K3 `tail_merge` and the exact-float scan kernels K9
`scan_f32_candidates` and K10 `verify_counts` at the shapes the main path
gives them, and hold two versions' outputs to each other bit for bit.

    python3 rayuela_tpu_torch/demos/time_exact.py [--root DIR]
        [--out FILE] [--against FILE] [--reps N]

Each line is one JSON object (CUDA events, the mean of ``--reps`` calls
after a warm one; the first line names the card and its power limit):

- K3 at the k = 100, 1000 and 4096 plans (`scan._scan_config`: r = 16,
  32, 96; cap = 128, 1024, 4096) over nq = 1e4 queries of per-lane
  ascending keys (the sortable keys of Gaussian scores), beside
  `torch.topk` over the same (nq, r * 128) keys;
- K9 and K10 at the k = 100 and 1000 plans of the card's f32 plan
  (`scan._f32_config`) over nq = 1e4 Gaussian queries: n = 1e6 rows at
  d = 128 (an f32 and a bf16 index) and n = 5e5 at GIST's d = 960 (f32),
  beside `chip_smoke.library_scan` (`addmm` + `topk` per 1024 queries
  over the same rows in f32); K10 counts at K9's own k-th pairs.

Every output carries a digest (two position-weighted int64 sums of its
32-bit words, taken on the card). ``--out FILE`` writes them; ``--against
FILE`` asserts that this run's equal those in FILE (exit 1 otherwise).
``--root DIR`` imports ``rayuela_tpu_torch`` from DIR (an unpacked
earlier commit; run the file by its path, not with ``-m``), so two
versions run on one card in one call, in turns: the parent with
``--out``, then this version with ``--against``, then the parent again.
The data come from fixed seeds on the card, the same in every run.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

NQ = 10_000
TAIL_KS = (100, 1000, 4096)


def digest(*ts):
    """Two int64 sums of each tensor's 32-bit words, each word weighted by
    a function of its position (wrapping), taken on the tensor's device
    (`time_onepass.py` and `time_icm.py` take theirs from here)."""
    import torch
    out = []
    for t in ts:
        w = t.contiguous().view(-1).view(torch.int32)
        a = b = 0
        for off in range(0, w.numel(), 1 << 24):
            x = w[off:off + (1 << 24)].long()
            i = torch.arange(off, off + x.numel(), device=x.device)
            a += int((x * (i * 2654435761 + 1)).sum())
            b += int(((x + i) * ((x ^ (i * 7 + 3)) | 1)).sum())
        out.append(f"{a % (1 << 64):016x}{b % (1 << 64):016x}")
    return out
SCAN_KS = (100, 1000)
SCANS = ((128, 1_000_000, ("float32", "bfloat16")),
         (960, 500_000, ("float32",)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    own = Path(__file__).resolve().parents[2]
    root = args.root or str(own)
    sys.path.insert(0, root)
    import torch

    from rayuela_tpu_torch.search import scan as tsp

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  own / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
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

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    digests = {}

    def emit(case, rec, outs):
        rec = {"root": root, "case": case, **rec}
        digests[case] = rec["digest"] = digest(*outs)
        print(json.dumps(rec), flush=True)

    for k in TAIL_KS:
        r = tsp._scan_config(k)[0]
        rpad = 1 << max(0, (r - 1).bit_length())
        cap = min(1 << (k - 1).bit_length(), rpad * tsp.LANES)
        s = torch.randn((r, tsp.LANES, NQ), generator=gen(k), device=dev)
        rows = tsp._sortable_key(s).sort(dim=0).values.contiguous()
        del s
        flat = rows.permute(2, 0, 1).reshape(NQ, -1).contiguous()
        t = ms(lambda: tsp.tail_merge(rows, cap), 2 * args.reps)
        lib = ms(lambda: torch.topk(flat, k, dim=1, largest=False),
                 2 * args.reps)
        out = tsp.tail_merge(rows, cap)
        plain = tsp.tail_merge_plain(rows, cap)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out[0], plain[0])
                     and torch.equal(out[1], plain[1]))
        emit(f"tail_merge k={k}", {"kernel": "tail_merge", "k": k, "r": r,
                                   "cap": cap, "nq": NQ, "ms": t,
                                   "topk_ms": lib, "equals_plain": equal},
             out)
        if not equal:
            print("tail_merge != its plain version", file=sys.stderr)
            return 1
        del rows, flat, out, plain
    torch.cuda.empty_cache()

    for d, n, dtypes in SCANS:
        X = torch.randn((n, d), generator=gen(d), device=dev)
        Q = torch.randn((NQ, d), generator=gen(d + 1), device=dev)
        x2 = (X * X).sum(-1)
        XT = X.T.contiguous()
        Qf = tsp._query_operand(Q, d, torch.float32)
        lib = {k: ms(lambda: smoke.library_scan(Qf, XT, x2, k), 1)
               for k in SCAN_KS}
        del XT
        torch.cuda.empty_cache()
        for dt in dtypes:
            dtype = getattr(torch, dt)
            Xd = X.to(dtype).contiguous()
            Qm = tsp._query_operand(Q, d, dtype)
            for k in SCAN_KS:
                r, keep, tile, _ = tsp._f32_config(k, dev)
                reps = args.reps if d <= 256 else max(1, args.reps - 1)
                t9 = ms(lambda: tsp.scan_f32_candidates(
                    Qm, Xd, x2, tile=tile, keep=keep), reps)
                cv, ci = tsp.scan_f32_candidates(Qm, Xd, x2, tile=tile,
                                                 keep=keep)
                emit(f"scan_f32_candidates d={d} {dt} k={k}",
                     {"kernel": "scan_f32_candidates", "d": d, "n": n,
                      "nq": NQ, "dtype": dt, "k": k,
                      "plan": [r, keep, tile], "ms": t9,
                      "library_ms": lib[k]}, (cv, ci))
                ov, oi = tsp.pair_merge(cv, ci, r)
                del cv, ci
                taus = []
                tsp._finish_f32(ov, oi, k, r, keep,
                                lambda ts, ti: taus.append((ts, ti)) or
                                torch.zeros((2, tsp.LANES, NQ),
                                            dtype=torch.int32, device=dev))
                ts, ti = taus[0]
                del ov, oi
                t10 = ms(lambda: tsp.verify_counts(Qm, Xd, x2, ts, ti,
                                                   tile=tile), reps)
                cnt = tsp.verify_counts(Qm, Xd, x2, ts, ti, tile=tile)
                emit(f"verify_counts d={d} {dt} k={k}",
                     {"kernel": "verify_counts", "d": d, "n": n, "nq": NQ,
                      "dtype": dt, "k": k, "plan": [r, keep, tile],
                      "ms": t10, "library_ms": lib[k]}, (cnt,))
                del cnt
                torch.cuda.empty_cache()
            del Xd, Qm
        del X, Q, x2, Qf
        torch.cuda.empty_cache()

    if args.out:
        Path(args.out).write_text(json.dumps(digests, indent=1))
    if args.against:
        ref = json.loads(Path(args.against).read_text())
        diff = sorted(c for c in digests if c in ref and ref[c] != digests[c])
        same = sorted(c for c in digests if c in ref and ref[c] == digests[c])
        print(json.dumps({"root": root, "against": args.against,
                          "identical": same, "different": diff}), flush=True)
        if diff or not same:
            print(f"outputs differ from {args.against}: {diff}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
