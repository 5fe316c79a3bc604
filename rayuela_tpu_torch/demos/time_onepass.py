"""Time the code-resident scan kernels K1 `codes_decode_candidates`, K14
`codes_decode_onepass` and K4 `codes_decode_topk` (the rescue), and K8's
keep=0 form `scan_onepass`, at the shapes the main path gives them, and
sweep K4's row splits.

    python rayuela_tpu_torch/demos/time_onepass.py [--root DIR] [--sweep]

The bases are the RVQ-7+1 layout of `chip_smoke.py` (h = 256, Gaussian
codebooks and queries from ``default_rng(0)``, bf16 operands): n = 1e6 at
d = 128 and n = 5e5 at GIST's d = 960 (dp = 1024). Each line is one JSON
object: K1 and K14 at nq = 1e4 at the k = 100 and k = 1000 plans
(`scan._scan_config`, `scan_codes._onepass_config`) at both widths, the
mean of 3 calls after a warm one; K4's milliseconds at nq = 1, 2, 5, 8,
16, 32 and 128 at the rescue's plan (r = 48, tile 2048) and K8's at nq =
128 over the same rows decoded, the mean of ``--reps`` calls after a warm
one (CUDA events; the wrappers' time, K2's merge of K14's and K4's
splits included). The first line names the card and its power limit.
``--root DIR`` imports ``rayuela_tpu_torch`` from DIR (an unpacked earlier
commit; run the file by its path, not with ``-m``, so that nothing is
imported before), so that two versions are timed on one card in one
call. ``--sweep`` (this version only) times K4 at each query count for a
range of forced row splits, each beside K2's merge of that many splits
alone: the data of the split rule's cost model (`scan._onepass_rows`).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

N, D, M, H = 1_000_000, 128, 7, 256
NQS = (1, 2, 5, 8, 16, 32, 128)
SCANS = ((D, N), (960, 500_000))     # (d, n) of the K1 and K14 timings
NQ = 10_000                          # their query batch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    root = args.root or str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": root, "card": smi}), flush=True)

    def base(rng, d, n, nq):
        """Codes of n rows (7 codebooks + the norms byte) and nq queries
        at width d → (index, bf16 decode operands, -2Q)."""
        C = torch.as_tensor(rng.standard_normal((M, H, d)).astype("float32"),
                            device=dev)
        Q = torch.as_tensor(rng.standard_normal((nq, d)).astype("float32"),
                            device=dev)
        ncb = torch.as_tensor((rng.random(H) * 1000).astype("float32"),
                              device=dev)
        B = torch.as_tensor(rng.integers(0, H, (n, M)).astype("int32"),
                            device=dev)
        nco = torch.as_tensor(rng.integers(0, H, n).astype("int32"),
                              device=dev)
        idx = tsc.build_codes_index(C, B, pq=False, d=d, norms_cbook=ncb,
                                    norms_codes=nco)
        Cf, nrm = idx.decode_operands(d, torch.bfloat16)
        return idx, Cf, nrm, tsc._query_operand(Q, Cf.shape[1],
                                                torch.bfloat16)

    def ms(fn, reps=args.reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for d, n in SCANS:
        idx, Cf, nrm, Qm = base(np.random.default_rng(0), d, n, NQ)
        args4 = (Qm, Cf, nrm, idx.packed)
        for k in (100, 1000):
            _, r2, keep, tile = tsc._codes_config(k)
            kw1 = dict(tile=tile, keep=keep, has_norms=True,
                       idbits=tsp._pack_idbits(-(-n // tile) * tile))
            t = ms(lambda: tsc.codes_decode_candidates(*args4, **kw1), 3)
            print(json.dumps({"root": root, "kernel":
                              "codes_decode_candidates", "d": d, "n": n,
                              "nq": NQ, "k": k, "plan": [r2, keep, tile],
                              "ms": t}), flush=True)
            r1, keep1, tile1 = tsc._onepass_config(k, idx.mprime)
            kw14 = dict(tile=tile1, r=r1, keep=keep1, has_norms=True,
                        idbits=tsp._pack_idbits(-(-n // tile1) * tile1))
            t = ms(lambda: tsc.codes_decode_onepass(*args4, **kw14), 3)
            print(json.dumps({"root": root, "kernel": "codes_decode_onepass",
                              "d": d, "n": n, "nq": NQ, "k": k,
                              "plan": [r1, keep1, tile1], "ms": t}),
                  flush=True)
        del idx, Cf, nrm, Qm, args4
        torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    idx, Cf, nrm, Qm = base(rng, D, N, max(NQS))
    ncb = idx.norms_cbook
    tile, r = tsc._RESCUE_TILE, tsc._RESCUE_R
    idbits = tsp._pack_idbits(-(-N // tile) * tile)
    kw = dict(tile=tile, r=r, idbits=idbits, has_norms=True)
    for nq in NQS:
        Qr = Qm[:nq].contiguous()
        t = ms(lambda: tsc.codes_decode_topk(Qr, Cf, nrm, idx.packed, **kw))
        print(json.dumps({"root": root, "kernel": "codes_decode_topk",
                          "nq": nq, "ms": t}), flush=True)
    codes = tsc.unpack_codes(idx.packed, idx.mprime)
    Xf, x2 = tsp.decode_base(idx.C, codes[:, :-1],
                             norm_term=ncb[codes[:, -1].long()])
    Xd = Xf.to(torch.bfloat16)
    del Xf
    Qr = Qm[:128].contiguous()
    kw8 = dict(tile=tile, r=r, idbits=idbits, premin=0)
    t = ms(lambda: tsp.scan_onepass(Qr, Xd, x2, **kw8))
    print(json.dumps({"root": root, "kernel": "scan_onepass", "nq": 128,
                      "ms": t}), flush=True)
    del Xd
    if not args.sweep:
        return
    rule = tsp._onepass_rows
    nrows = -(-N // tile) * tile // tsp.LANES
    layout = tsc._rescue_layout(D, idx.packed.shape[1], r, 1,
                                torch.device(dev))
    nr = 32 // layout[1]
    try:
        for nq in NQS:
            Qr = Qm[:nq].contiguous()
            for splits in (1, 2, 4, 8, 16, 32, 64, 128, 256):
                rows_per = -(-(-(-nrows // splits)) // nr) * nr
                tsp._onepass_rows = lambda *a, rp=rows_per: (nrows, rp)
                t = ms(lambda: tsc.codes_decode_topk(
                    Qr, Cf, nrm, idx.packed, **kw), 3)
                sp = -(-nrows // rows_per)
                cand = torch.zeros((sp * r, tsp.LANES, nq),
                                   dtype=torch.int32, device=dev)
                disc = torch.zeros((sp, tsp.LANES, nq), dtype=torch.int32,
                                   device=dev)
                tm = ms(lambda: tsp.cand_merge(cand, disc, r), 3) \
                    if sp > 1 else 0.0
                del cand, disc
                print(json.dumps({"sweep": "codes_decode_topk", "nq": nq,
                                  "layout": list(layout), "splits": sp,
                                  "rows_per": rows_per, "ms": t,
                                  "merge_ms": tm}), flush=True)
    finally:
        tsp._onepass_rows = rule


if __name__ == "__main__":
    main()
