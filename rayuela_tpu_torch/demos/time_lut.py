"""Time the LUT scan kernels K5 `codes_lut_candidates`, K6
`codes_lut_f32_candidates` and K7 `codes_verify_counts` at the shapes the
main path gives them, probe how K6/K7's time splits, and hold two
versions' outputs to each other bit for bit.

    python3 rayuela_tpu_torch/demos/time_lut.py [--root DIR]
        [--out FILE] [--against FILE] [--reps N]

Each line is one JSON object (CUDA events, the mean of ``--reps`` calls
after a warm one; the first line names the card and its power limit).
Operands: n = 1e6 rows of uniform random code bytes, nq = 1e4 queries'
Gaussian tables of h = 256 entries, m' = 8 tables (RVQ-7+1 and SR-D-7+1
with their norms byte) in f32 and in bf16, and m' = 16 (128 bits) in
f32. For each the card's exact-float plans (`scan._f32_config`: k = 100
and 1000; m' = 16 at k = 100):

- K6 and K7, and the whole exact-float search (`scan_codes_topk(...,
  pack=False)`: K6, the pair merge, the top-k, K7), beside the bound of
  the sums (n nq m' f32 adds at the CUDA cores' peak, 67 TFLOP/s) and,
  on f32 tables, the library's way to the same top-k
  (`library_lut`: per 1024 queries one
  `embedding_bag(mode="sum")` over the codes and one `topk`; whether its
  scores equal the plain version's prints);
- K5 at the packed plan of the same k (`scan._scan_config`), whose body
  this file's K6/K7 do not share;
- the probes: K7 on codes that are all equal (every row reads the same
  entries: no bank conflicts) beside random codes, and K6 at keep = 2
  and keep = 4 (the k = 100 and 1000 plans share tile 8192).

Every output carries a digest (`time_exact.digest`). ``--out FILE``
writes them; ``--against FILE`` asserts that this run's equal those in
FILE (exit 1 otherwise): K5-K7 sum in the plain versions' order, so any
two versions agree on any data. ``--root DIR`` imports
``rayuela_tpu_torch`` from DIR (an unpacked earlier commit; run the file
by its path, not with ``-m``), so two versions run on one card in one
call, in turns: the parent with ``--out``, then this version with
``--against``, then the parent again. The data come from fixed seeds on
the card, the same in every run.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

N, NQ, H = 1_000_000, 10_000, 256
CASES = ((8, "float32", (100, 1000)), (8, "bfloat16", (100, 1000)),
         (16, "float32", (100,)))
PEAK_F32, HBM = 67e12, 3.35e12


def lut_offsets(packed, mprime, h=256):
    """Each row's m' codes as offsets into the stacked (m' h) tables:
    the bags of `library_lut`."""
    import torch

    from rayuela_tpu_torch.search import scan_codes as tsc
    codes = tsc.unpack_codes(packed, mprime).long()
    return codes + torch.arange(mprime, device=codes.device) * h


def library_lut(T, offs, k, qblock=1024):
    """The library's way to the top-k of the LUT sums: per query block
    one `embedding_bag(mode="sum")` of each row's table entries (``offs``
    from `lut_offsets`, the weight the (m' h, qblock) block of ``T``'s
    f32 values) and one `topk` along the rows → the first block's
    scores."""
    import torch
    mprime, h, nq = T.shape
    W = T.float().reshape(mprime * h, nq)
    first = None
    for q0 in range(0, nq, qblock):
        S = torch.nn.functional.embedding_bag(
            offs, W[:, q0:q0 + qblock].contiguous(), mode="sum")
        torch.topk(S, k, dim=0, largest=False)
        if first is None:
            first = S
    return first


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
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

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

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    digests = {}

    def emit(case, rec, outs):
        rec = {"root": root, "case": case, **rec}
        digests[case] = rec["digest"] = digest(*outs)
        print(json.dumps(rec), flush=True)

    def taus_of(cv, ci, k, r, keep):
        """K6's k-th pairs, as the search takes them (`_finish_f32`)."""
        taus = []
        tsp._finish_f32(*tsp.pair_merge(cv, ci, r), k, r, keep,
                        lambda ts, ti: taus.append((ts, ti)) or
                        torch.zeros((2, tsp.LANES, NQ), dtype=torch.int32,
                                    device=dev))
        return taus[0]

    for mprime, dt, ks in CASES:
        dtype = getattr(torch, dt)
        nw = -(-mprime // 4)
        T = torch.randn((mprime, H, NQ), generator=gen(mprime),
                        device=dev).to(dtype).contiguous()
        packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (N, nw),
                               generator=gen(mprime + 1), device=dev,
                               dtype=torch.int32)
        shape = {"mprime": mprime, "h": H, "n": N, "nq": NQ, "tables": dt}

        def bound(*outs):
            """The larger of the sums' adds at the f32 peak and the bytes
            of the tables, the codes and the outputs at the HBM rate."""
            ops = N * NQ * mprime / PEAK_F32
            moved = sum(t.numel() * t.element_size()
                        for t in (T, packed, *outs)) / HBM
            return {"bound_ms": max(ops, moved) * 1e3,
                    "bound_by": "operations" if ops >= moved else "bytes"}

        offs = lib = None
        if dtype == torch.float32:
            offs = lut_offsets(packed, mprime, H)
        for k in ks:
            r, keep, tile, _ = tsp._f32_config(k, dev)
            plan = {"k": k, "plan": [r, keep, tile]}
            if offs is not None:
                lib = ms(lambda: library_lut(T, offs, k), 1)
                S = library_lut(T, offs, k)
                plain = tsc._lut_scores_fn(T, packed, tile)(0, 0, 1024)
                lib_equal = bool(torch.equal(S[:tile], plain))
                del S, plain
            t6 = ms(lambda: tsc.codes_lut_f32_candidates(
                T, packed, tile=tile, keep=keep), args.reps)
            cv, ci = tsc.codes_lut_f32_candidates(T, packed, tile=tile,
                                                  keep=keep)
            rec = {"kernel": "codes_lut_f32_candidates", **shape, **plan,
                   "ms": t6, **bound(cv, ci), "library_ms": lib}
            if lib is not None:
                rec["library_equals_plain"] = lib_equal
            emit(f"K6 m'={mprime} {dt} k={k}", rec, (cv, ci))
            ts, ti = taus_of(cv, ci, k, r, keep)
            del cv, ci
            t7 = ms(lambda: tsc.codes_verify_counts(T, packed, ts, ti,
                                                    tile=tile), args.reps)
            cnt = tsc.codes_verify_counts(T, packed, ts, ti, tile=tile)
            emit(f"K7 m'={mprime} {dt} k={k}",
                 {"kernel": "codes_verify_counts", **shape, **plan,
                  "ms": t7, **bound(ts, ti, cnt)}, (cnt,))
            del cnt
            if mprime == 8 and dtype == torch.float32 and k == ks[0]:
                same = torch.zeros_like(packed)
                t7s = ms(lambda: tsc.codes_verify_counts(
                    T, same, ts, ti, tile=tile), args.reps)
                cnt = tsc.codes_verify_counts(T, same, ts, ti, tile=tile)
                emit(f"K7 m'={mprime} {dt} k={k} equal codes",
                     {"kernel": "codes_verify_counts", **shape, **plan,
                      "codes": "all equal", "ms": t7s,
                      "random_codes_ms": t7}, (cnt,))
                del same, cnt
            kw = dict(k=k, r=r, tile=tile, keep=keep, lut_dtype=dtype,
                      pack=False)
            tw = ms(lambda: tsc.scan_codes_topk(T, packed, **kw), args.reps)
            out = tsc.scan_codes_topk(T, packed, **kw)
            emit(f"search m'={mprime} {dt} k={k}",
                 {"search": "scan_codes_topk(pack=False)", **shape, **plan,
                  "ms": tw, "queries_per_s": NQ / tw * 1e3,
                  "flagged": int(out[2].sum())}, out)
            del out
            r5, keep5, tile5 = tsp._scan_config(k)
            idbits = tsp._pack_idbits(-(-N // tile5) * tile5)
            t5 = ms(lambda: tsc.codes_lut_candidates(
                T, packed, tile=tile5, keep=keep5, idbits=idbits), args.reps)
            out = tsc.codes_lut_candidates(T, packed, tile=tile5, keep=keep5,
                                           idbits=idbits)
            emit(f"K5 m'={mprime} {dt} k={k}",
                 {"kernel": "codes_lut_candidates", **shape, "k": k,
                  "plan": [r5, keep5, tile5], "ms": t5, **bound(*out)},
                 out)
            del out, ts, ti
            torch.cuda.empty_cache()
        del T, packed, offs
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
