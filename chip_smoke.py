#!/usr/bin/env python3
"""Smoke run of `rayuela_tpu_torch` on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Builds the CUDA kernels from ``rayuela_tpu_torch/csrc`` and runs the
phases below; any failure exits non-zero.

1. Kernels against their plain PyTorch versions on the card, at
   n = 1,000,000 codes, d = 128, nq = 1024, for the RVQ layout (7
   codebooks + the norms byte) and the PQ layout (8 codebooks): in f32
   on small-integer data, where every score is exact and the outputs
   must be identical, and in bf16 on Gaussian data, where the kernels
   sum in another order than cuBLAS (>= 99.9% of ids equal by position,
   every score within one truncation step). Then each kernel's time
   beside its plain version's at the search batch of the main path
   (nq = 1e4; K4 at 128 rescued queries), where the timed runs' results
   are held against each other in the same way, and K4 in bf16 at the
   1, 2 and 8 flagged queries the main path's rescue gives it, where the
   base is split over the most CTAs and K2 merges the splits.
1b. The encode kernels against their plain versions on the card, at
   n = 65,536, d = 128, h = 256, m = 7 and 8: K11 `icm_sweeps` at
   icmiter 0, 1 and 4 with a shuffled node order, K13 `viterbi_encode`.
   On {-1, 0, 1} data every value is exact and codes (and K11's
   energies) must be identical; on Gaussian data >= 99% of codes equal,
   K11's mean energy within 1e-4 relative, K13's chain energies within
   1e-5 relative (+ 1e-3 absolute). Then both kernels' times beside
   their plain versions' at the main path's shapes (1e5 vectors, m=7,
   K11 at icmiter=4), held against each other in the same way.
2. Rescue: an index with many exact ties of one query in one lane,
   served through the facade; the rescue kernel must run and the result
   must equal the plain LUT oracle.
3. The search path through the facade: synthetic-corr data (d = 128,
   1e5 train, 1e6 base, 1e4 queries), `api.train` → `api.index_base(
   mode="codes")` → `api.search(k=100)` and `(k=1000)` → `eval_recall`,
   for RVQ (m=7) and PQ (m=8), with queries/s.
4. The LSQ++ main path through the facade on phase 3's data:
   `api.train(method="sr_d", m=7, h=256, niter=10)` (OPQ → ChainQ →
   SR-D, ilsiter 8, icmiter 4, npert 4) → `api.index_base(mode="codes")`
   (greedy init, then ILS at ilsiter=32 over the 1e6 base, + the norms
   byte) → `api.search(k=100)` and `(k=1000)` → `eval_recall`, with the
   seconds of each step, the base encode rate (over the whole
   index_base call) and queries/s; recall@1 must reach 0.99.

The launch counters are set to 0 just before phase 3 and read right
after its facade searches, and again for phase 4: every kernel of the
search path must have launched in each, and K11 and K13 in phase 4.
After that read, K11 is held against its plain version once more at the
base-encode shape (the whole 1e6 base, the SR-D codebooks, the greedy
codes, icmiter 4), as in phase 1b on Gaussian data. The
flag counts and the profiler pass run after those reads. The line before
the last is a JSON summary of the kernels (launches from phase 4); the
last line is the device record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

N, D, NQ1, NQ, NTRAIN = 1_000_000, 128, 1024, 10_000, 100_000
DEV = "cuda"
# recall@1 on synthetic-corr at 64 bits from BASELINE.md (JAX package):
# quality references, not speed figures
JAX_RECALL1 = {"rvq": 0.9985, "pq": 0.1669, "sr_d": 0.9984}
REPLACES = {
    "codes_decode_candidates":
        "rayuela_tpu/search/scan_codes_pallas.py:384",
    "cand_merge": "rayuela_tpu/search/scan_codes_pallas.py:424",
    "tail_merge": "rayuela_tpu/search/scan_pallas.py:796",
    "codes_decode_topk": "rayuela_tpu/search/scan_codes_pallas.py:318",
    "icm_sweeps": "rayuela_tpu/ops/icm_pallas.py:62",
    "viterbi_encode": "rayuela_tpu/ops/viterbi_pallas.py:49",
}
SOURCES = {
    "codes_decode_candidates": "rayuela_tpu_torch/csrc/codes_scan.cu",
    "cand_merge": "rayuela_tpu_torch/csrc/codes_scan.cu",
    "tail_merge": "rayuela_tpu_torch/csrc/topk_tail.cu",
    "codes_decode_topk": "rayuela_tpu_torch/csrc/codes_scan.cu",
    "icm_sweeps": "rayuela_tpu_torch/csrc/icm.cu",
    "viterbi_encode": "rayuela_tpu_torch/csrc/viterbi.cu",
}
N1B, NT = 65_536, 100_000     # phase 1b vectors; the timed encode batch


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def note(errs, name, err):
    """Keep the largest error measured for kernel ``name``."""
    errs[name] = max(errs.get(name, 0.0), err)


def int_err(*pairs):
    """Max abs difference over pairs of int32 tensors, as a float."""
    return max(float((a.long() - b.long()).abs().max()) for a, b in pairs)


def timed(fn, reps):
    """``(mean milliseconds of fn() over reps runs after one warm run,
    by CUDA events; the last run's result)``."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


class Phase1:
    """Kernels against their plain versions on one layout and dtype."""

    def __init__(self, rng, pq: bool, kind: str, dtype, nq: int):
        import torch

        from rayuela_tpu_torch.search import scan_codes as tsc
        m, h = (8, 256) if pq else (7, 256)
        ds = D // m if pq else D
        if kind == "int":
            C = rng.integers(-2, 3, (m, h, ds)).astype("float32")
            Q = rng.integers(-3, 4, (nq, D)).astype("float32")
            ncb = rng.integers(0, 500, h).astype("float32")
        else:
            C = rng.standard_normal((m, h, ds)).astype("float32")
            Q = rng.standard_normal((nq, D)).astype("float32")
            ncb = (rng.random(h) * 1000).astype("float32")
        dev = DEV
        B = torch.as_tensor(rng.integers(0, h, (N, m)).astype("int32"),
                            device=dev)
        nco = (None if pq else torch.as_tensor(
            rng.integers(0, h, N).astype("int32"), device=dev))
        self.idx = tsc.build_codes_index(
            torch.as_tensor(C, device=dev), B, pq=pq, d=D,
            norms_cbook=None if pq else torch.as_tensor(ncb, device=dev),
            norms_codes=nco)
        self.Q = torch.as_tensor(Q, device=dev)
        self.Cf, self.nrm = self.idx.decode_operands(D, dtype)
        self.Qm = tsc._query_operand(self.Q, self.Cf.shape[1], dtype)
        self.pq, self.kind, self.dtype = pq, kind, dtype
        self.name = (f"{'PQ-8' if pq else 'RVQ-7+1'} {kind} "
                     f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")


def plain_topk(outp, r, k, idbits):
    """`_finish` of scan_codes with the plain cross-lane merge."""
    from rayuela_tpu_torch.search.scan import (_decode_packed_vals,
                                               tail_merge_plain)
    rpad = 1 << max(0, (r - 1).bit_length())
    cap = min(1 << max(0, (k - 1).bit_length()), rpad * 128)
    keys, lanes = tail_merge_plain(outp[:r].contiguous(), cap)
    sk = keys[:, :k]
    ids = (sk & ((1 << idbits) - 1)) * 128 + lanes[:, :k]
    fl = (outp[r] < sk[:, k - 1][None, :]).any(0)
    return _decode_packed_vals(sk, idbits), ids, fl


def compare_topk(tag, got, ref, idbits, exact):
    """Returns the max abs score difference; raises on disagreement."""
    import torch
    (gv, gi, gf), (rv, ri, rf) = got, ref
    err = float((gv - rv).abs().max())
    if exact:
        check(torch.equal(gv, rv) and torch.equal(gi, ri)
              and torch.equal(gf, rf), f"{tag}: kernel != plain")
        print(f"  {tag}: identical (vals, ids, flags)")
        return err
    same = float((gi == ri).float().mean())
    step = 2.0 ** (idbits - 23)
    tol = step * torch.maximum(gv.abs(), rv.abs())
    within = bool(((gv - rv).abs() <= tol).all())
    print(f"  {tag}: ids equal by position {same:.6f}, max |dscore| "
          f"{err:.3g}, within one truncation step: {within}")
    check(same >= 0.999, f"{tag}: only {same:.6f} of ids equal")
    check(within, f"{tag}: a score moved by more than one truncation step")
    return err


def phase1(rng, errs):
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print(f"== phase 1: kernels vs plain, n={N}, d={D}, nq={NQ1}")
    for pq in (False, True):
        for kind, dtype in (("int", torch.float32),
                            ("gauss", torch.bfloat16)):
            c = Phase1(rng, pq, kind, dtype, NQ1)
            exact = kind == "int"
            print(f" {c.name}")
            for k in (100, 1000):
                _, r, keep = tsc._codes_config(k)
                idbits = tsp._pack_idbits(-(-N // 8192) * 8192)
                kw = dict(tile=8192, keep=keep, idbits=idbits,
                          has_norms=not pq)
                cand, disc = tsc.codes_decode_candidates(
                    c.Qm, c.Cf, c.nrm, c.idx.packed, **kw)
                cand0, disc0 = tsc.codes_decode_candidates_plain(
                    c.Qm, c.Cf, c.nrm, c.idx.packed, **kw)
                if exact:
                    check(torch.equal(cand, cand0)
                          and torch.equal(disc, disc0),
                          f"K1 {c.name} k={k}: kernel != plain")
                out = tsc.cand_merge(cand, disc, r)
                out0 = tsc.cand_merge_plain(cand, disc, r)
                check(torch.equal(out, out0),
                      f"K2 {c.name} k={k}: kernel != plain")
                note(errs, "cand_merge", int_err((out, out0)))
                cap = 1 << (k - 1).bit_length()
                rows = out[:r].contiguous()
                a, b = tsp.tail_merge(rows, cap), tsp.tail_merge_plain(rows,
                                                                       cap)
                check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                      f"K3 {c.name} k={k}: kernel != plain")
                note(errs, "tail_merge", int_err((a[0], b[0]), (a[1], b[1])))
                print(f"  k={k}: K2, K3 identical on the same inputs")
                got = tsc.scan_codes_decode_topk_2p(
                    c.Q, c.Cf, c.nrm, c.idx.packed, k=k, pq=pq, r=r,
                    keep=keep)
                ref = plain_topk(tsc.cand_merge_plain(cand0, disc0, r), r,
                                 k, idbits)
                note(errs, "codes_decode_candidates",
                     compare_topk(f"k={k} K1+K2+K3", got, ref, idbits, exact))
            # K4 at the rescue configuration
            k, r4 = 1000, tsc._RESCUE_R
            idb4 = tsp._pack_idbits(-(-N // tsc._RESCUE_TILE)
                                    * tsc._RESCUE_TILE)
            kw4 = dict(tile=tsc._RESCUE_TILE, r=r4, idbits=idb4,
                       has_norms=not pq)
            o4 = tsc.codes_decode_topk(c.Qm, c.Cf, c.nrm, c.idx.packed,
                                       **kw4)
            o40 = tsc.codes_decode_topk_plain(c.Qm, c.Cf, c.nrm,
                                              c.idx.packed, **kw4)
            if exact:
                check(torch.equal(o4, o40), f"K4 {c.name}: kernel != plain")
            got = tsc.scan_codes_decode_topk(c.Q, c.Cf, c.nrm, c.idx.packed,
                                             k=k, pq=pq)
            note(errs, "codes_decode_topk",
                 compare_topk(f"k={k} K4+K3 (r=48, tile=2048)", got,
                              plain_topk(o40, r4, k, idb4), idb4, exact))
            del c
            torch.cuda.empty_cache()


def kernel_times(rng, errs):
    """Each kernel beside its plain version at the main path's search
    batch (bf16 RVQ-7+1 layout, nq=1e4; K4 at 128 rescued queries), the
    results of the timed runs held against each other as in phase 1."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print(f"== kernel times (ms; CUDA events) and checks, bf16 RVQ-7+1, "
          f"n={N}, nq={NQ}")
    c = Phase1(rng, False, "gauss", torch.bfloat16, NQ)
    times = {}
    idbits = tsp._pack_idbits(-(-N // 8192) * 8192)
    args = (c.Qm, c.Cf, c.nrm, c.idx.packed)
    for k in (100, 1000):
        _, r, keep = tsc._codes_config(k)
        kw = dict(tile=8192, keep=keep, idbits=idbits, has_norms=True)
        t = {}
        ms, (cand, disc) = timed(
            lambda: tsc.codes_decode_candidates(*args, **kw), 3)
        pms, (cand0, disc0) = timed(
            lambda: tsc.codes_decode_candidates_plain(*args, **kw), 1)
        t["codes_decode_candidates"] = (ms, pms)
        ms, out = timed(lambda: tsc.cand_merge(cand, disc, r), 5)
        pms, out0 = timed(lambda: tsc.cand_merge_plain(cand, disc, r), 2)
        check(torch.equal(out, out0), f"K2 nq={NQ} k={k}: kernel != plain")
        note(errs, "cand_merge", int_err((out, out0)))
        t["cand_merge"] = (ms, pms)
        rows, cap = out[:r].contiguous(), 1 << (k - 1).bit_length()
        ms, (kk, ln) = timed(lambda: tsp.tail_merge(rows, cap), 5)
        pms, (kk0, ln0) = timed(lambda: tsp.tail_merge_plain(rows, cap), 2)
        check(torch.equal(kk, kk0) and torch.equal(ln, ln0),
              f"K3 nq={NQ} k={k}: kernel != plain")
        note(errs, "tail_merge", int_err((kk, kk0), (ln, ln0)))
        t["tail_merge"] = (ms, pms)
        note(errs, "codes_decode_candidates", compare_topk(
            f"k={k} K1+K2+K3", plain_topk(out, r, k, idbits),
            plain_topk(tsc.cand_merge_plain(cand0, disc0, r), r, k, idbits),
            idbits, exact=False))
        del cand, disc, cand0, disc0
        for name, (ms, pms) in t.items():
            print(f"  k={k} {name}: kernel {ms:.3f} ms, plain {pms:.3f} ms "
                  f"(r={r}, keep={keep})")
        if k == 1000:
            times.update(t)
    Qr = c.Qm[:128].contiguous()
    r4 = tsc._RESCUE_R
    idb4 = tsp._pack_idbits(-(-N // tsc._RESCUE_TILE) * tsc._RESCUE_TILE)
    kw4 = dict(tile=tsc._RESCUE_TILE, r=r4, idbits=idb4, has_norms=True)
    ms, o4 = timed(lambda: tsc.codes_decode_topk(Qr, *args[1:], **kw4), 2)
    pms, o40 = timed(lambda: tsc.codes_decode_topk_plain(Qr, *args[1:],
                                                         **kw4), 1)
    note(errs, "codes_decode_topk", compare_topk(
        "128 queries, k=1000 K4+K3", plain_topk(o4, r4, 1000, idb4),
        plain_topk(o40, r4, 1000, idb4), idb4, exact=False))
    times["codes_decode_topk"] = (ms, pms)
    print(f"  codes_decode_topk (128 queries, r=48): kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms")
    # the rescue's own batch: a few flagged queries, the base split over
    # the most CTAs and the splits merged by K2
    for nq in (1, 2, 8):
        Qr = c.Qm[:nq].contiguous()
        for k in (100, 1000):
            o4 = tsc.codes_decode_topk(Qr, *args[1:], **kw4)
            o40 = tsc.codes_decode_topk_plain(Qr, *args[1:], **kw4)
            note(errs, "codes_decode_topk", compare_topk(
                f"{nq} queries, k={k} K4+K3", plain_topk(o4, r4, k, idb4),
                plain_topk(o40, r4, k, idb4), idb4, exact=False))
    del c
    torch.cuda.empty_cache()
    return times


def _encode_case(rng, kind, n, m, h=256):
    """X (n, D), C (m, h, D) as f32 tensors on the card."""
    import torch
    if kind == "int":
        X = rng.integers(-1, 2, (n, D)).astype("float32")
        C = rng.integers(-1, 2, (m, h, D)).astype("float32")
    else:
        X = rng.standard_normal((n, D)).astype("float32")
        C = (rng.standard_normal((m, h, D)) * 0.3).astype("float32")
    return torch.as_tensor(X, device=DEV), torch.as_tensor(C, device=DEV)


def compare_icm(tag, got, ref, exact):
    """K11 against its plain version → max |dE| over the vectors whose
    codes agree; raises on disagreement."""
    import torch
    (gb, ge), (rb, re_) = got, ref
    same_rows = (gb == rb).all(1)
    err = float((ge - re_)[same_rows].abs().max()) if bool(
        same_rows.any()) else float("inf")
    if exact:
        check(torch.equal(gb, rb) and torch.equal(ge, re_),
              f"{tag}: kernel != plain")
        print(f"  {tag}: identical (codes, energies)")
        return err
    same = float((gb == rb).float().mean())
    me, mr = float(ge.double().mean()), float(re_.double().mean())
    rel = abs(me - mr) / abs(mr)
    print(f"  {tag}: codes equal {same:.6f}, mean energy {me:.6f} vs "
          f"{mr:.6f} (rel {rel:.2e}), max |dE| on equal rows {err:.3g}")
    check(same >= 0.99, f"{tag}: only {same:.6f} of codes equal")
    check(rel <= 1e-4, f"{tag}: mean energy off by {rel:.2e}")
    return err


def compare_viterbi(tag, X, C, got, ref, exact):
    """K13 against its plain version → max |d chain energy|."""
    import torch

    from rayuela_tpu_torch.ops.viterbi import chain_energy
    eg, er = chain_energy(X, C, got), chain_energy(X, C, ref)
    err = float((eg - er).abs().max())
    if exact:
        check(torch.equal(got, ref), f"{tag}: kernel != plain")
        print(f"  {tag}: identical codes")
        return err
    same = float((got == ref).float().mean())
    ok = bool(((eg - er).abs() <= 1e-5 * er.abs() + 1e-3).all())
    print(f"  {tag}: codes equal {same:.6f}, max |d chain energy| "
          f"{err:.3g}, all within 1e-5 rel + 1e-3: {ok}")
    check(same >= 0.99, f"{tag}: only {same:.6f} of codes equal")
    check(ok, f"{tag}: a chain energy moved beyond 1e-5 rel + 1e-3")
    return err


def phase1b(rng, errs):
    import torch

    from rayuela_tpu_torch.ops import icm as ticm
    from rayuela_tpu_torch.ops import viterbi as tvit

    print(f"== phase 1b: encode kernels vs plain, n={N1B}, d={D}, h=256")
    for m in (7, 8):
        for kind in ("int", "gauss"):
            exact = kind == "int"
            X, C = _encode_case(rng, kind, N1B, m)
            B = torch.as_tensor(rng.integers(0, 256, (N1B, m)),
                                dtype=torch.int32, device=DEV)
            order = torch.as_tensor(rng.permutation(m), dtype=torch.int32,
                                    device=DEV)
            for icmiter in (0, 1, 4):
                got = ticm.icm_sweeps(X, C, B, order, icmiter)
                ref = ticm.icm_sweeps_plain(X, C, B, order, icmiter,
                                            op_dtype=torch.bfloat16)
                note(errs, "icm_sweeps", compare_icm(
                    f"K11 m={m} {kind} icmiter={icmiter}", got, ref, exact))
            got = tvit.viterbi_encode(X, C)
            ref = tvit.viterbi_encode_plain(X, C)
            note(errs, "viterbi_encode", compare_viterbi(
                f"K13 m={m} {kind}", X, C, got, ref, exact))
            del X, C, B
    torch.cuda.empty_cache()


def encode_kernel_times(rng, errs):
    """K11 (icmiter=4) and K13 beside their plain versions at the main
    path's encode batch (1e5 vectors, m=7, Gaussian data), the timed
    runs' results held against each other as in phase 1b. Returns
    {name: (kernel ms, plain ms)}."""
    import torch

    from rayuela_tpu_torch.ops import icm as ticm
    from rayuela_tpu_torch.ops import viterbi as tvit

    print(f"== encode kernel times (ms; CUDA events), n={NT}, m=7, d={D}")
    m = 7
    X, C = _encode_case(rng, "gauss", NT, m)
    B = torch.as_tensor(rng.integers(0, 256, (NT, m)), dtype=torch.int32,
                        device=DEV)
    order = torch.as_tensor(rng.permutation(m), dtype=torch.int32,
                            device=DEV)
    ms, got = timed(lambda: ticm.icm_sweeps(X, C, B, order, 4), 5)
    pms, ref = timed(lambda: ticm.icm_sweeps_plain(
        X, C, B, order, 4, op_dtype=torch.bfloat16), 1)
    note(errs, "icm_sweeps", compare_icm("K11 timed, icmiter=4", got, ref,
                                         exact=False))
    print(f"  icm_sweeps: kernel {ms:.3f} ms, plain {pms:.3f} ms")
    times = {"icm_sweeps": (ms, pms)}
    ms, got = timed(lambda: tvit.viterbi_encode(X, C), 5)
    pms, ref = timed(lambda: tvit.viterbi_encode_plain(X, C), 1)
    note(errs, "viterbi_encode", compare_viterbi("K13 timed", X, C, got,
                                                 ref, exact=False))
    print(f"  viterbi_encode: kernel {ms:.3f} ms, plain {pms:.3f} ms")
    times["viterbi_encode"] = (ms, pms)
    del X, C, B
    torch.cuda.empty_cache()
    return times


def phase2(rng):
    """Exact ties of query 0 piled into one lane of one tile, served
    through the facade in f32 on {-1, 0, 1} data, where every score is
    an exact small integer."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch import convert
    from rayuela_tpu_torch.ops.qerror import reconstruct_pq
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print("== phase 2: rescue of certificate-flagged queries")
    m, h, k, nq = 8, 256, 100, 64
    C = rng.integers(-1, 2, (m, h, D // m)).astype("float32")
    B = rng.integers(0, h, (N, m)).astype("int32")
    best = rng.integers(0, h, m).astype("int32")
    B[np.arange(40) * 128] = best              # lane 0, row ids 0..39
    model = convert.model_from_arrays("pq", C, h=h, device=DEV)
    index = convert.index_from_arrays(model, B, None, None, d=D)
    Bt = index.codes
    Q = rng.integers(-1, 2, (nq, D)).astype("float32")
    Q[0] = reconstruct_pq(model.codebooks, Bt[:1], D)[0].cpu().numpy()
    k4 = tsc.codes_decode_topk.launches
    dists, ids = rq.search(index, Q, k=k, op_dtype=torch.float32)
    torch.cuda.synchronize()
    check(tsc.codes_decode_topk.launches > k4, "rescue kernel K4 not run")
    Qt = torch.as_tensor(Q, device=DEV)
    T = tsc.build_luts(model.codebooks, Qt, pq=True, d=D)
    s0, _ = tsc.lut_scan(T, Bt, k)
    q2 = (Qt * Qt).sum(1, keepdim=True)
    # scores are exact integers, but a key keeps only the top bits of a
    # score: one truncation step (floor in key space) is the tolerance
    step = 2.0 ** (tsp._pack_idbits(-(-N // 2048) * 2048) - 23)
    tol = step * s0.abs()
    check(bool(((dists - (s0 + q2)).abs() <= tol).all()),
          "rescued dists != the LUT oracle's")
    # every returned id scores its reported distance, ids distinct
    codes = Bt[ids.long()].long() + torch.arange(m, device=DEV) * h
    flat = T.permute(2, 0, 1).reshape(nq, m * h)
    own = torch.gather(flat, 1, codes.reshape(nq, -1)).reshape(
        nq, k, m).sum(2)
    check(bool(((own + q2 - dists).abs() <= step * own.abs()).all()),
          "a returned id does not score its distance")
    check(all(len(set(r.tolist())) == k for r in ids), "duplicate ids")
    check(set(range(0, 40 * 128, 128)) <= set(ids[0].tolist()),
          "a planted tie of query 0 was lost")
    print(f"  K4 launched {tsc.codes_decode_topk.launches - k4} time(s); "
          f"result equals the LUT oracle within one truncation step")


def profile(fn):
    """Device time by kernel over one call of ``fn``, and the device's
    idle share of the call's wall time (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda x: -x[1])
    busy = sum(ms for _, ms in rows)
    if not rows:
        print("    profile: no device time recorded (not measured)")
        return
    print(f"    profile: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}")
    for name, ms in rows[:8]:
        print(f"      {ms:9.2f} ms  {name[:90]}")


def phase3(seed, card):
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.experiments.datasets import make_synthetic
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import eval_recall

    print(f"== phase 3: facade main path, synthetic-corr d={D}, "
          f"1e5 train, {N} base, {NQ} queries ({card})")
    t0 = time.perf_counter()
    ds = make_synthetic(d=D, ntrain=NTRAIN, nbase=N, nquery=NQ,
                        corr=True, seed=seed, name="synthetic-corr",
                        device=DEV)
    print(f"  data + exact ground truth: {time.perf_counter() - t0:.1f} s")
    Xq = torch.as_tensor(ds.Xq, device=DEV)
    out, served = {}, {}
    for method, m in (("rvq", 7), ("pq", 8)):
        t0 = time.perf_counter()
        model = rq.train(ds.Xt, method=method, m=m, h=256, niter=10,
                         seed=seed, device=DEV)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        index = rq.index_base(model, ds.Xb, mode="codes")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"  {method} m={m}: train {t1 - t0:.1f} s, index_base "
              f"{t2 - t1:.1f} s")
        for k in (100, 1000):
            k4 = tsc.codes_decode_topk.launches
            dists, ids = rq.search(index, Xq, k=k)
            torch.cuda.synchronize()
            rescues = tsc.codes_decode_topk.launches - k4
            check(dists.shape == (NQ, k) and ids.shape == (NQ, k),
                  "search returned the wrong shape")
            check(bool(torch.isfinite(dists).all()), "non-finite dists")
            check(bool(((ids >= 0) & (ids < N)).all()), "ids out of range")
            curve = eval_recall(ids, ds.gt, verbose=False)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                rq.search(index, Xq, k=k)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            wall = float(np.median(walls))
            print(f"  {method} k={k}: recall@1 {curve[0]:.4f} @10 "
                  f"{curve[9]:.4f} @100 {curve[99]:.4f}; search "
                  f"{NQ / wall:,.0f} queries/s (median of "
                  f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms); "
                  f"rescue launches {rescues}")
            out[(method, k)] = (float(curve[0]), NQ / wall)
        print(f"  {method}: recall@1 {out[(method, 100)][0]:.4f} "
              f"(JAX package, BASELINE.md: {JAX_RECALL1[method]})")
        served[method] = index
        del model
    check(out[("rvq", 100)][0] >= 0.98,
          f"RVQ recall@1 {out[('rvq', 100)][0]:.4f} < 0.98")
    return served, Xq, ds


def check_search(dists, ids, k):
    import torch
    check(dists.shape == (NQ, k) and ids.shape == (NQ, k),
          "search returned the wrong shape")
    check(bool(torch.isfinite(dists).all()), "non-finite dists")
    check(bool(((ids >= 0) & (ids < N)).all()), "ids out of range")


def phase4(seed, card, ds, Xq):
    """The LSQ++ main path: train SR-D, encode the base, search."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.ops.qerror import qerror, veccost_chunked
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import eval_recall

    print(f"== phase 4: LSQ++ (SR-D) main path, synthetic-corr d={D}, "
          f"{NTRAIN} train, {N} base, {NQ} queries, m=7+1, h=256, "
          f"niter=10 ({card})")
    t0 = time.perf_counter()
    model = rq.train(ds.Xt, method="sr_d", m=7, h=256, niter=10,
                     seed=seed, device=DEV)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    Xt = torch.as_tensor(ds.Xt, device=DEV)
    qe = float(qerror(Xt, model.codebooks, model.train_codes))
    print(f"  train (OPQ -> ChainQ -> SR-D): {t1 - t0:.1f} s; train "
          f"qerror {qe:.4f} (|x|^2 mean "
          f"{float((Xt * Xt).sum(1).mean()):.4f})")
    check(np.isfinite(qe), "non-finite train qerror")
    Xb = torch.as_tensor(ds.Xb, device=DEV)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    index = rq.index_base(model, Xb, mode="codes")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bqe = float(veccost_chunked(Xb, model.codebooks, index.codes).mean())
    print(f"  index_base (greedy + ILS 32 rounds, norms byte, pack): "
          f"{t2 - t1:.1f} s, {N / (t2 - t1):,.0f} base vectors/s; base "
          f"qerror {bqe:.4f}")
    # the base gets fewer ILS rounds than the training codes, but a
    # broken encode lands far above the training error
    check(bqe < 1.25 * qe, f"base qerror {bqe:.4f} vs train {qe:.4f}")
    out = {}
    for k in (100, 1000):
        k4 = tsc.codes_decode_topk.launches
        dists, ids = rq.search(index, Xq, k=k)
        torch.cuda.synchronize()
        rescues = tsc.codes_decode_topk.launches - k4
        check_search(dists, ids, k)
        curve = eval_recall(ids, ds.gt, verbose=False)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            rq.search(index, Xq, k=k)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        wall = float(np.median(walls))
        print(f"  sr_d k={k}: recall@1 {curve[0]:.4f} @10 {curve[9]:.4f} "
              f"@100 {curve[99]:.4f}; search {NQ / wall:,.0f} queries/s "
              f"(median of {', '.join(f'{w * 1e3:.1f}' for w in walls)} "
              f"ms); rescue launches {rescues}")
        out[k] = float(curve[0])
    print(f"  sr_d: recall@1 {out[100]:.4f} (JAX package, BASELINE.md: "
          f"{JAX_RECALL1['sr_d']})")
    check(out[100] >= 0.99, f"SR-D recall@1 {out[100]:.4f} < 0.99")
    return index, Xb


def base_encode_check(rng, errs, model, Xb):
    """K11 against its plain version at the base-encode shape the main
    path launches it at: one icmiter=4 sweep over the whole base from the
    greedy codes, with the SR-D model's codebooks."""
    import torch

    from rayuela_tpu_torch.models.rvq import quantize_rvq
    from rayuela_tpu_torch.ops import icm as ticm

    m = model.codebooks.shape[0]
    print(f"== K11 vs plain at the base encode: n={Xb.shape[0]}, m={m}, "
          f"SR-D codebooks, greedy codes")
    B0 = quantize_rvq(model.codebooks, Xb)[0].to(torch.int32).contiguous()
    order = torch.as_tensor(rng.permutation(m), dtype=torch.int32,
                            device=DEV)
    got = ticm.icm_sweeps(Xb, model.codebooks, B0, order, 4)
    ref = ticm.icm_sweeps_plain(Xb, model.codebooks, B0, order, 4,
                                op_dtype=torch.bfloat16)
    note(errs, "icm_sweeps", compare_icm("K11 base icmiter=4", got, ref,
                                         exact=False))


def diagnostics(served, Xq):
    """After the main paths' launch counts were read: the queries the
    two-pass certificate flags, and one search's device time by kernel."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan_codes as tsc

    print("== diagnostics of the phase-3 and phase-4 indexes")
    for method, index in served.items():
        si = index.scan_index
        Cf, nrm = si.decode_operands(D, torch.bfloat16)
        for k in (100, 1000):
            _, r, keep = tsc._codes_config(k)
            fl = tsc.scan_codes_decode_topk_2p(Xq, Cf, nrm, si.packed, k=k,
                                               pq=si.pq, r=r, keep=keep)[2]
            print(f"  {method} k={k}: {int(fl.sum())} of {NQ} queries "
                  f"flagged by the two-pass certificate")
            profile(lambda: rq.search(index, Xq, k=k))


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's ``-Xptxas=-v`` output:
    its (mangled) name, registers and spills."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split(" for ", 1)[1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name[:72]}: {regs}; {spill}")
            name, spill = None, ""
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from rayuela_tpu_torch.kernels import build
    from rayuela_tpu_torch.ops import icm as ticm
    from rayuela_tpu_torch.ops import viterbi as tvit
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    t0 = time.perf_counter()
    _, log = build.build()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary(log):
        print("  " + line)

    rng = np.random.default_rng(args.seed)
    search_wrappers = {
        "codes_decode_candidates": tsc.codes_decode_candidates,
        "cand_merge": tsc.cand_merge, "tail_merge": tsp.tail_merge,
        "codes_decode_topk": tsc.codes_decode_topk}
    wrappers = dict(search_wrappers, icm_sweeps=ticm.icm_sweeps,
                    viterbi_encode=tvit.viterbi_encode)
    errs = {}
    phase_t = {}

    def run(name, fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        phase_t[name] = time.perf_counter() - t
        print(f"-- {name}: {phase_t[name]:.1f} s")
        return r

    try:
        run("phase 1", phase1, rng, errs)
        times = run("kernel times", kernel_times, rng, errs)
        run("phase 1b", phase1b, rng, errs)
        times.update(run("encode kernel times", encode_kernel_times, rng,
                         errs))
        run("phase 2", phase2, rng)
        for w in wrappers.values():
            w.launches = 0
        served, Xq, ds = run("phase 3", phase3, args.seed, smi)
        launches = {n: w.launches for n, w in search_wrappers.items()}
        print(f"phase-3 launches: {launches}")
        check(all(launches.values()), "a kernel of the search path never "
              "launched in phase 3")
        for w in wrappers.values():
            w.launches = 0
        served["sr_d"], Xb = run("phase 4", phase4, args.seed, smi, ds, Xq)
        launches = {n: w.launches for n, w in wrappers.items()}
        print(f"main-path (phase-4) launches: {launches}")
        check(all(launches.values()), "a kernel of the path never launched "
              "on the main path")
        del ds
        run("base encode check", base_encode_check, rng, errs,
            served["sr_d"].model, Xb)
        del Xb
        run("diagnostics", diagnostics, served, Xq)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n],
         "replaces": REPLACES[n], "launches": launches[n],
         "max_abs_err": errs[n], "ms": times[n][0],
         "plain_ms": times[n][1]} for n in wrappers]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
