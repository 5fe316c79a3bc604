"""Time the code-resident scan kernels K1 `codes_decode_candidates`, K14
`codes_decode_onepass` and K4 `codes_decode_topk` (the rescue), and the
decoded scan K8 `scan_candidates` and its keep=0 form `scan_onepass`, at
the shapes the main path gives them, hold two versions' outputs to each
other, and sweep K4's row splits.

    python rayuela_tpu_torch/demos/time_onepass.py [--root DIR]
        [--out FILE] [--against FILE] [--sweep] [--f32 [--codes-only]]

The bases are the RVQ-7+1 layout of `chip_smoke.py` (h = 256, Gaussian
codebooks and queries from ``default_rng(0)``, bf16 operands): n = 1e6 at
d = 128 and n = 5e5 at GIST's d = 960 (dp = 1024 for the codes scans).
Each line is one JSON object: K1 and K14 at nq = 1e4 at the k = 100 and
k = 1000 plans (`scan._scan_config`, `scan_codes._onepass_config`) at
both widths, the mean of 3 calls after a warm one; K8 at the same plans
over the same rows decoded (bf16, dp = d), beside
`chip_smoke.library_scan` (`addmm` + `topk` per 1024 queries over the
rows in f32), the mean of 3 calls (2 at d = 960), at d = 128 also with
the rows' own |x|^2 for x2, each with the count of (row, query) pairs
whose key the fmaf chain gave (`scan._chain_pairs`, where the version
has it); K8 on small-integer
rows (n = 2e5, nq = 1000, both forms, both widths: exactness only);
K4's milliseconds at nq = 1, 2, 5, 8, 16, 32 and 128 at the rescue's
plan (r = 48, tile 2048) and K8's at nq = 128 over the decoded rows at
d = 128, the mean of ``--reps`` calls after a warm one (CUDA events; the
wrappers' time, K2's merge of K14's and K4's splits included). The first
line names the card and its power limit. ``--f32`` times instead the f32
instances of K1, K14 and K8 alone on the same codes (f32 operands; K8
over the rows decoded to f32, the yardstick of the same arithmetic
without a decode), nq = 1e4: at d = 128 at both plans, each beside its
plain version (one call), and at d = 960 (n = 5e5) at the k = 1000
plans; each beside `chip_smoke.library_scan`, its bound (the products at
the f32 CUDA-core peak, 67 TFLOP/s, or the bytes, each input read and
each output written once, at 3.35 TB/s) and, for K1 and K14, the L2
bytes its decode gathers (`gather_bytes`: a row once per cluster of
query blocks of the version's layout); then K1 and K14 on PQ-8 bases at
d = 128 and 256, digests only (the PQ layout's norms). ``--codes-only``
keeps of it K1 and K14 at d = 128 alone (no plain version, library call
or K8): the quick look at a variant of the kernels, a copy of the
package with a constant changed passed as ``--root``.

Every output carries a digest (`time_exact.digest`). ``--out FILE``
writes them; ``--against FILE`` asserts that this run's equal those in
FILE (exit 1 otherwise) for every case marked ``"exact"``: all but K8's
Gaussian candidates at d = 960, whose keys are the tensor cores' where
K8's former fmaf body took the fmaf chain's. ``--root DIR`` imports
``rayuela_tpu_torch`` from DIR (an unpacked earlier commit; run the file
by its path, not with ``-m``, so that nothing is imported before), so
that two versions are timed on one card in one call, in turns: the
parent with ``--out``, then this version with ``--against``, then the
parent again. ``--sweep`` (this version only) times K4 at each query
count for a range of forced row splits, each beside K2's merge of that
many splits alone: the data of the split rule's cost model
(`scan._onepass_rows`).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


N, D, M, H = 1_000_000, 128, 7, 256
NQS = (1, 2, 5, 8, 16, 32, 128)
SCANS = ((D, N), (960, 500_000))     # (d, n) of the K1 and K14 timings
NQ = 10_000                          # their query batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--codes-only", action="store_true")
    args = ap.parse_args(argv)
    own = Path(__file__).resolve().parents[2]
    root = args.root or str(own)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  own / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    spec = importlib.util.spec_from_file_location(
        "time_exact", Path(__file__).with_name("time_exact.py"))
    texact = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(texact)
    digest = texact.digest
    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": root, "card": smi}), flush=True)

    def base(rng, d, n, nq, dtype=torch.bfloat16):
        """Codes of n rows (7 codebooks + the norms byte) and nq queries
        at width d → (index, decode operands at dtype, -2Q)."""
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
        Cf, nrm = idx.decode_operands(d, dtype)
        return idx, Cf, nrm, tsc._query_operand(Q, Cf.shape[1], dtype)

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

    digests, exact = {}, {}

    def emit(case, rec, outs, is_exact=True):
        rec = {"root": root, "case": case, **rec}
        digests[case] = rec["digest"] = digest(*outs)
        exact[case] = rec["exact"] = is_exact
        print(json.dumps(rec), flush=True)

    def decoded(idx, Qm, d):
        """The rows of idx decoded at width d (bf16, and f32 transposed
        for the library's scan), their x2, and -2Q at width d."""
        codes = tsc.unpack_codes(idx.packed, idx.mprime)
        Xf, x2 = tsp.decode_base(idx.C, codes[:, :-1],
                                 norm_term=idx.norms_cbook[codes[:, -1]
                                                           .long()])
        return (Xf.to(torch.bfloat16), Xf.T.contiguous(), x2,
                Qm[:, :d].contiguous())

    if args.f32:
        f32_times(base, ms, emit, smoke, tsp, tsc, args.codes_only)
        return report(args, root, digests, exact)

    for d, n in SCANS:
        idx, Cf, nrm, Qm = base(np.random.default_rng(0), d, n, NQ)
        args4 = (Qm, Cf, nrm, idx.packed)
        for k in (100, 1000):
            _, r2, keep, tile = tsc._codes_config(k)
            kw1 = dict(tile=tile, keep=keep, has_norms=True,
                       idbits=tsp._pack_idbits(-(-n // tile) * tile))
            t = ms(lambda: tsc.codes_decode_candidates(*args4, **kw1), 3)
            emit(f"codes_decode_candidates d={d} k={k}",
                 {"kernel": "codes_decode_candidates", "d": d, "n": n,
                  "nq": NQ, "k": k, "plan": [r2, keep, tile], "ms": t},
                 tsc.codes_decode_candidates(*args4, **kw1))
            r1, keep1, tile1 = tsc._onepass_config(k, idx.mprime)
            kw14 = dict(tile=tile1, r=r1, keep=keep1, has_norms=True,
                        idbits=tsp._pack_idbits(-(-n // tile1) * tile1))
            t = ms(lambda: tsc.codes_decode_onepass(*args4, **kw14), 3)
            emit(f"codes_decode_onepass d={d} k={k}",
                 {"kernel": "codes_decode_onepass", "d": d, "n": n,
                  "nq": NQ, "k": k, "plan": [r1, keep1, tile1], "ms": t},
                 (tsc.codes_decode_onepass(*args4, **kw14),))
        del Cf, nrm, args4
        torch.cuda.empty_cache()
        Xd, XT, x2, Q8 = decoded(idx, Qm, d)
        Qf = Q8.float()
        # the norms byte's x2, and (one d-block) the rows' own |x|^2, as an
        # index whose norm term is its rows' norm: the share of pairs that
        # the fmaf chain keys depends on it (where a version counts them)
        x2s = {"": x2}
        if d <= 256:
            x2s[" x2=|x|^2"] = (XT * XT).sum(0)
        for k in (100, 1000):
            _, r2, keep, tile = tsc._codes_config(k)
            kw8 = dict(tile=tile, keep=keep, premin=0,
                       idbits=tsp._pack_idbits(-(-n // tile) * tile))
            reps = 3 if d <= 256 else 2
            lib = ms(lambda: smoke.library_scan(Qf, XT, x2, k), reps)
            for tag, xx in x2s.items():
                t = ms(lambda: tsp.scan_candidates(Q8, Xd, xx, **kw8), reps)
                chain = getattr(tsp, "_chain_pairs", None)
                emit(f"scan_candidates d={d} k={k}{tag}",
                     {"kernel": "scan_candidates", "d": d, "n": n, "nq": NQ,
                      "k": k, "plan": [r2, keep, tile], "ms": t,
                      "library_ms": lib, "chain_pairs":
                      chain(Q8, Xd, xx, **{c: kw8[c] for c in
                                           ("tile", "keep", "idbits")})
                      if chain else None},
                     tsp.scan_candidates(Q8, Xd, xx, **kw8), d <= 256)
        del idx, Qm, Xd, XT, x2, Q8, Qf, x2s
        torch.cuda.empty_cache()

    rng = np.random.default_rng(1)
    for d in (128, 960):
        n, nq = 200_000, 1000
        X = torch.as_tensor(rng.integers(-3, 4, (n, d)).astype("float32"),
                            device=dev)
        Qi = torch.as_tensor(rng.integers(-3, 4, (nq, d)).astype("float32"),
                             device=dev)
        Xd, x2 = X.to(torch.bfloat16), (X * X).sum(-1)
        Q8 = tsp._query_operand(Qi, d, torch.bfloat16)
        for keep, tile in ((2, 8192), (4, 8192)):
            kw8 = dict(tile=tile, keep=keep, premin=0,
                       idbits=tsp._pack_idbits(-(-n // tile) * tile))
            emit(f"scan_candidates int d={d} keep={keep}",
                 {"kernel": "scan_candidates", "data": "int", "d": d},
                 tsp.scan_candidates(Q8, Xd, x2, **kw8))
        kw0 = dict(tile=2048, r=48, premin=0,
                   idbits=tsp._pack_idbits(-(-n // 2048) * 2048))
        emit(f"scan_onepass int d={d}",
             {"kernel": "scan_onepass", "data": "int", "d": d},
             (tsp.scan_onepass(Q8, Xd, x2, **kw0),))
        del X, Qi, Xd, x2, Q8
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
        emit(f"codes_decode_topk nq={nq}",
             {"kernel": "codes_decode_topk", "nq": nq, "ms": t},
             (tsc.codes_decode_topk(Qr, Cf, nrm, idx.packed, **kw),))
    codes = tsc.unpack_codes(idx.packed, idx.mprime)
    Xf, x2 = tsp.decode_base(idx.C, codes[:, :-1],
                             norm_term=ncb[codes[:, -1].long()])
    Xd = Xf.to(torch.bfloat16)
    del Xf
    Qr = Qm[:128].contiguous()
    kw8 = dict(tile=tile, r=r, idbits=idbits, premin=0)
    t = ms(lambda: tsp.scan_onepass(Qr, Xd, x2, **kw8))
    emit("scan_onepass nq=128", {"kernel": "scan_onepass", "nq": 128,
                                 "ms": t},
         (tsp.scan_onepass(Qr, Xd, x2, **kw8),))
    del Xd
    code = report(args, root, digests, exact)
    if code or not args.sweep:
        return code
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
    return 0


def report(args, root, digests, exact) -> int:
    """Write the digests (``--out``) or hold them against a file's
    (``--against``) → the exit code."""
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


def gather_bytes(tsc, keep, n, nq, dp, m, nw, device):
    """L2 bytes that a K1 or K14 call gathers to decode its rows: each row
    is decoded once per cluster of query blocks of its layout (the
    version's `_candidates_layout`; an earlier layout of 8 fields reads
    the same way), m codebook rows of dp f32 values and its nw code words
    a decode."""
    lay = tsc._candidates_layout(keep, dp, nw, 0, device)
    per = lay[0] * lay[5]
    return n * -(-nq // per) * (m * dp + nw) * 4, per


def f32_times(base, ms, emit, smoke, tsp, tsc, codes_only=False):
    """The f32 instances of K1, K14 and K8 (see the module's docstring):
    at d = 128 (n = 1e6) at both plans, each beside its plain version, at
    GIST's d = 960 (n = 5e5) at the k = 1000 plans; then K1 and K14 on a
    PQ-8 base at d = 128 and 256 (n = 2e5, the k = 100 plans), digests
    only: the PQ layout's norms are the rows' own sums. ``codes_only``:
    K1 and K14 at d = 128 alone, without their plain versions, the
    library's scan and K8 (a quick look at a variant)."""
    import numpy as np
    import torch

    peak, hbm = smoke.PEAK["f32 CUDA-core"], smoke.PEAK["HBM"]
    dev = torch.device("cuda")
    for d, n, ks in ((D, N, (100, 1000)),
                     *(() if codes_only else ((960, 500_000, (1000,)),))):
        idx, Cf, nrm, Qm = base(np.random.default_rng(0), d, n, NQ,
                                torch.float32)
        dp, nw = Cf.shape[1], idx.packed.shape[1]
        args4 = (Qm, Cf, nrm, idx.packed)
        codes = tsc.unpack_codes(idx.packed, idx.mprime)
        Xd, x2 = tsp.decode_base(idx.C, codes[:, :-1],
                                 norm_term=idx.norms_cbook[codes[:, -1]
                                                           .long()])
        del codes
        XT, Q8 = Xd.T.contiguous(), Qm[:, :d].contiguous()

        def bound(*tensors):
            return max(2.0 * n * NQ * d / peak,
                       smoke.nbytes(*tensors) / hbm) * 1e3

        for k in ks:
            lib = None if codes_only else ms(
                lambda: smoke.library_scan(Q8, XT, x2, k), 3)
            _, r2, keep, tile = tsc._codes_config(k)
            r1, keep1, tile1 = tsc._onepass_config(k, idx.mprime)
            runs = (
                ("codes_decode_candidates", [r2, keep, tile],
                 tsc.codes_decode_candidates,
                 tsc.codes_decode_candidates_plain, args4,
                 dict(tile=tile, keep=keep, has_norms=True)),
                ("codes_decode_onepass", [r1, keep1, tile1],
                 tsc.codes_decode_onepass, tsc.codes_decode_onepass_plain,
                 args4, dict(tile=tile1, r=r1, keep=keep1, has_norms=True)),
                ("scan_candidates", [r2, keep, tile], tsp.scan_candidates,
                 tsp.scan_candidates_plain, (Q8, Xd, x2),
                 dict(tile=tile, keep=keep, premin=0)))
            for name, plan, fn, plain, a, kw in runs[:2 if codes_only
                                                    else 3]:
                kw["idbits"] = tsp._pack_idbits(-(-n // kw["tile"])
                                                * kw["tile"])
                t = ms(lambda: fn(*a, **kw), 3)
                out = fn(*a, **kw)
                out = out if isinstance(out, tuple) else (out,)
                rec = {"kernel": name, "dtype": "float32", "d": d, "n": n,
                       "nq": NQ, "k": k, "plan": plan, "ms": t,
                       "plain_ms": ms(lambda: plain(*a, **kw), 1)
                       if d == D and not codes_only else None,
                       "library_ms": lib, "bound_ms": bound(*a, *out)}
                if name != "scan_candidates":
                    rec["l2_gather_bytes"], rec["queries_a_decode"] = \
                        gather_bytes(tsc, kw["keep"], n, NQ, dp,
                                     idx.mprime - 1, nw, dev)
                emit(f"{name} f32 d={d} k={k}", rec, out)
                del out
                torch.cuda.empty_cache()
        del idx, Cf, nrm, Qm, args4, Xd, XT, x2, Q8
        torch.cuda.empty_cache()
    for d in () if codes_only else (D, 256):
        rng = np.random.default_rng(2)
        n, m = 200_000, 8
        C = torch.as_tensor(rng.standard_normal((m, H, d // m))
                            .astype("float32"), device=dev)
        B = torch.as_tensor(rng.integers(0, H, (n, m)).astype("int32"),
                            device=dev)
        Q = torch.as_tensor(rng.standard_normal((NQ, d)).astype("float32"),
                            device=dev)
        idx = tsc.build_codes_index(C, B, pq=True, d=d)
        Cf, nrm = idx.decode_operands(d, torch.float32)
        a = (tsc._query_operand(Q, Cf.shape[1], torch.float32), Cf, nrm,
             idx.packed)
        _, _, keep, tile = tsc._codes_config(100)
        r1, keep1, tile1 = tsc._onepass_config(100, idx.mprime)
        kw = dict(tile=tile, keep=keep, has_norms=False,
                  idbits=tsp._pack_idbits(-(-n // tile) * tile))
        kw14 = dict(tile=tile1, r=r1, keep=keep1, has_norms=False,
                    idbits=tsp._pack_idbits(-(-n // tile1) * tile1))
        emit(f"codes_decode_candidates f32 pq d={d}",
             {"kernel": "codes_decode_candidates", "dtype": "float32",
              "layout": "PQ-8", "d": d, "n": n, "nq": NQ},
             tsc.codes_decode_candidates(*a, **kw))
        emit(f"codes_decode_onepass f32 pq d={d}",
             {"kernel": "codes_decode_onepass", "dtype": "float32",
              "layout": "PQ-8", "d": d, "n": n, "nq": NQ},
             (tsc.codes_decode_onepass(*a, **kw14),))
        del idx, Cf, nrm, a
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
