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
   (nq = 1e4; K4 and K8's keep=0 form at 128 rescued queries), where
   the timed runs' results are held against each other in the same way,
   and K4 in bf16 at the 1, 2 and 8 flagged queries the main path's
   rescue gives it, where the base is split over CTAs and K2 merges the
   splits; timed at 1 and 8 beside its plain version, its bound and the
   library's call. On bf16 operands K1, K14 and K4 score on the tensor
   cores with one score function: at each plan K4's first `keep` keys
   must equal those of K2's merge of K1's candidates on Gaussian data
   (128 queries; phase 8 the same at d = 960 on 32), the ground of the
   one-pass = two-pass gate of phases 7 and 8.
1c. K8 (`scan_candidates`, and `scan_onepass`, its keep=0 form) and K5
   (`codes_lut_candidates`) against their plain versions at n = 1e6,
   d = 128, nq = 1024: identical int32 outputs in f32 on small-integer
   data for every (r, keep, tile) the plan uses and keep=0; in bf16 on
   Gaussian data K8 within the bounds of phase 1 and K5 (which adds its
   table values in the plain version's order) identical again. Then
   their times at nq = 1e4 beside the plain versions', and whether K8
   gives K1's keys on the same codes.
1d. The exact-float kernels against their plain versions at n = 1e6,
   d = 128, nq = 1024, f32 and bf16 operands: K9 (`scan_f32_candidates`
   and `pair_merge`) and K10 (`verify_counts`) for the classes of the
   card's f32 plan, K6 (`codes_lut_f32_candidates`) and K7
   (`codes_verify_counts`) for both keeps. On small-integer data the
   pairs, the counts, the top-k and the flags must be identical; on
   Gaussian data K9's scores lie within 1e-5 relative (+ 1e-4: the
   terms reach ~1e2) with >= 99.9% of ids equal by position and equal
   flags, and K6/K7, which add in the plain versions' order, are
   identical again. K6/K7's layout (`rq_lut_exact_layout`) must be its
   Python mirror's, and whether the library's sums (`embedding_bag`)
   equal the kernels' prints. Their times at nq = 1e4 stand with the
   other kernels' (f32 index and f32 tables: the operands of phase 6).
1b. The encode kernels against their plain versions on the card, at
   n = 65,536, d = 128, h = 256, m = 7 and 8: K11 `icm_sweeps` at
   icmiter 0, 1 and 4 with a shuffled node order, K13 `viterbi_encode`.
   On {-1, 0, 1} data every value is exact and codes (and K11's
   energies) must be identical; on Gaussian data >= 99% of codes equal,
   K11's mean energy within 1e-4 relative, K13's chain energies within
   1e-5 relative (+ 1e-3 absolute). Then both kernels' times beside
   their plain versions' at the main path's shapes (1e5 vectors, m=7,
   K11 at icmiter=4), held against each other in the same way.
1e. K12 (`encoding_ils`, the whole ILS loop in one launch) against its
   plain version at n = 65,536, d = 128, m = 7, h = 256, ilsiter 8,
   icmiter 4, npert 4: codes and energies identical on {-1, 0, 1} data,
   the K11 bound on Gaussian data; K11 once more at h = 512 and at d =
   960 (both kinds of data); K14 (`codes_decode_onepass`, the one-pass
   scan with a per-tile cut) against K1 → K2's plain versions at n =
   1e6, nq = 1024, both layouts, both one-pass plans (`_onepass_config`:
   (14, 2, 2048) at k = 100, (28, 4, 8192) at k = 1000): identical int32
   outputs on integer data, the phase-1 bounds on Gaussian data. Then
   K14's time at nq = 1e4 and K12's at 1e5 vectors beside their plain
   versions', held against each other in the same way, and K14's time
   with its row range unsplit beside the splits its wrapper chooses
   (identical buffers).
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
   index_base call) and queries/s; recall@1 must reach 0.99 and lie
   within three seed standard deviations (`SRD_SEED_SD`) of the JAX
   row. Then C5: an LSQ model at h = 2048 (RVQ-trained codebooks, m =
   4) encodes 2e4 base vectors through `api.index_base`, which must
   take the ported ``xla`` ICM path alone (no K11 or K12 launch),
   improve on the greedy codes and serve a search; an explicit
   ``impl="pallas"`` there must raise.

5. The decoded-index and LUT-mode main path on phase 4's model:
   `api.index_base(model, Xb)` with the default mode (decoded, bf16) →
   `api.search(k=100)` and `(k=1000)` with recall and queries/s;
   `linscan_lsq` on the same codes must equal the facade's result;
   `api.search(index_codes, mode="lut")` at both k. After the launch
   counts of these calls were read, the results are held against phase
   4's decode-mode search and the LUT oracle on 64 queries; then an
   explicit one-pass configuration (keep=0) on 128 queries runs with
   counts of its own; then the plan sweep: flagged queries and time of
   the decoded and the LUT scan at k = 2048, 4096 and 8192 for the buffer
   depths and tiles the plan chooses among, beside the exact scans that
   serve a k beyond the plan.

6. The exact-float main path on phase 4's model and codes: an f32
   decoded index (`build_index(dtype=float32)` on phase 5's codes) →
   `api.search(..., pack=False)` at k = 100 and 1000 with recall and
   queries/s; `api.search(index_codes, mode="lut", pack=False)` with
   f32 tables at both k; `linscan_lsq(..., pack=False)`, which must
   equal the facade's result; `api.search_streamed` over the packed
   base held in host memory, 4 shards, in LUT mode with ``pack=False``
   (dists within 1e-5 relative of the resident search's, >= 99.9% of ids
   equal by position: flagged queries re-run on tables built for another
   batch) and in decode mode
   (packed keys: within one truncation step of the resident search),
   each beside the resident search's wall time. No packed scan kernel
   may launch in the ``pack=False`` calls. After the counts were read:
   the f32 results against `exact_rescan` and the LUT oracle on 64
   queries, the flag counts of the f32 plan at k = 100, 1000 and 3072
   (the deepest k it serves on the card), and one search's device time
   by kernel.

Every kernel's time stands beside its bound (the larger of its
operations over the card's published peak for the operand type and its
bytes, each input read and each output written once, over 3.35 TB/s)
and, where one PyTorch call computes the same function, that call's
time (`matmul` + `topk` over the decoded base for the scans, `topk`
for K3, `topk` along the candidates for K2 and the pair merge,
`embedding_bag` + `topk` over the codes and tables for K5 and K6,
`amin` for the fusion kernel at k = 0). K3 is also timed at the deepest plan a
k = 4096 search takes (r = 96, cap = 4096, nq = 1e4, Gaussian keys),
beside `topk` and held against its plain version.

7. The whole-ILS encode and the one-pass decode scan on phase 4's model
   and data: `api.index_base(mode="codes", impl="pallas-ils")` over the
   1e6 base at ilsiter 32 (one K12 launch, no K11), its wall beside
   phase 4's relaunch encode, its base quantization error within 1% of
   the relaunch codes', recall@1 >= 0.99 through the default codes
   search; then `api.search(index4, twopass=False)` at k = 100 and 1000,
   `stage=1` at k = 1000 and `twopass=False, qsuper=4` at k = 100 with
   queries/s (K14 → K3, K4 rescue). After the counts were read, K12 is
   held against its plain version on the operands of that base encode
   (below), each
   result must equal the two-pass search's (phase 4's route) on every
   query that did not reach the LUT oracle, both plans' flagged counts
   print, and the two base encodes and one one-pass search are
   profiled by kernel.

8. GIST1M's shape (d = 960; its published split of 1e5 train and 1e4
   queries, the 1e6 base cut to 5e5, synthetic-corr drawn from the
   seed, exact ground truth on the card): `api.train(method="sr_d",
   m=7, h=256, niter=10)` → `api.index_base` in both modes (5e5 x 32
   ILS rounds through K11 each) → at k = 100 and 1000 the decoded index
   (K8 → K2 → K3, 0.96 GB bf16), decode mode (K1), one-pass
   (`twopass=False`, K14), LUT mode (K5) and `pack=False` over the f32
   decoded index (K9, pair merge, K10; 1.92 GB), with recall and
   queries/s. After its counts were read: decode mode's recall@1 within
   0.01 of the decoded index's with its norm terms at the operand type,
   as decode mode reads them (the gap to the default decoded index,
   whose norm terms are f32, prints); the
   one-pass result equal to the two-pass one on every query that did
   not reach the LUT oracle; on the first 256 queries each search
   against the exact scan of its own scores (the ids distinct, each
   dist its id's score in f64 and the worst id's score the exact k-th
   one, to one truncation step for packed keys or 1e-5 for the
   exact-float scan; LUT mode against the LUT oracle on the batch's own
   tables: identical truncated scores, ids equal within equal scores);
   every scan kernel against its plain version on those queries over
   the whole base (K4 on 8 of them, K8's keep=0 form on 32); then the
   kernels' times at d = 960 beside their bounds and the library's
   call; then K4 on the rescue's own batch (the queries decode mode's
   two-pass scan flags at k = 100), timed and held against its plain
   version, and decode mode's k = 100 search profiled by kernel, the
   rescue's K4 and its K2 apart.
9. 128 bits on phase 3's data (d = 128): `api.train(method="sr_d",
   m=15, ...)` → `index_base(mode="codes")` (m' = 16) → LUT mode with
   bf16 tables (K5, 16 queries a CTA) and f32 tables (K5, 8 queries a
   CTA), the `pack=False` LUT search (K6, pair merge, K7) and decode
   mode (K1 at m = 15), at k = 100 and 1000, recall@1 >= 0.99 through
   each; then PQ-16 through the f32-table LUT search, recall@1 >= 0.75
   (BASELINE.md:56: SR-D 1.000, PQ .823). After its counts were read,
   K5 (both table types), K6 and K7 against their plain versions on its
   tables, K1 (+K2+K3) and K4 at m = 15 against theirs, and the times of
   K5-K7 and K1 at m = 15.
Then the two probes at the JAX probes' sizes: the fusion probe (its
kernel against its plain version for every k and both source forms,
timed) and the scan-tail probe (K8 alone and the steps after it).

The launch counters are set to 0 just before phase 3 and read right
after its facade searches, and again for phase 4, for phase 5's default
calls and for its one-pass call, for phases 6 to 9 and for the probes:
every kernel of the search path must have launched in each, K11 and K13
in phase 4, K8, K5, K2 and K3 in phase 5, K8's keep=0 form in the
one-pass call, K9, K10, K6, K7 and the pair merge in phase 6, K12
(once) and K14 in phase 7, K11, K13, K8, K1, K14, K5, K9, the pair
merge, K10, K2, K3 and the rescue's K4 in phase 8, K11, K13, K5, K6,
the pair merge, K7,
K1, K2 and K3 in phase 9, the fusion kernel and K8 in the probes.
After that read, K11 is held against its plain version once more at the
base-encode shape (the whole 1e6 base, the SR-D codebooks, the greedy
codes, icmiter 4), as in phase 1b on Gaussian data; after phase 7's,
K12 runs again on the operands phase 7's base encode gave it (the 1e6
base, the greedy codes, its 32 node orders and its seed), must give
phase 7's codes and is held against its plain version there in the same
way. The
flag counts and the profiler pass run after those reads. The line before
the last is a JSON summary of the kernels (launches from the phase
named beside them); the last line is the device record.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

N, D, NQ1, NQ, NTRAIN = 1_000_000, 128, 1024, 10_000, 100_000
DEV = "cuda"
# recall@1 on synthetic-corr at 64 bits from BASELINE.md (JAX package):
# quality references, not speed figures
JAX_RECALL1 = {"rvq": 0.9985, "pq": 0.1669, "sr_d": 0.9984}
# the sample standard deviation of SR-D-7+1's recall@1 through the codes
# index over training seeds 0-39 on phase 4's data (NVIDIA H100 80GB HBM3,
# 700 W; `rayuela_tpu_torch/demos/time_srd.py`): phase 4 holds its recall
# to the JAX row within three of them
SRD_SEED_SD = 0.0024
REPLACES = {
    "codes_decode_candidates":
        "rayuela_tpu/search/scan_codes_pallas.py:384",
    "cand_merge": "rayuela_tpu/search/scan_codes_pallas.py:424",
    "tail_merge": "rayuela_tpu/search/scan_pallas.py:796",
    "codes_decode_topk": "rayuela_tpu/search/scan_codes_pallas.py:318",
    "icm_sweeps": "rayuela_tpu/ops/icm_pallas.py:62",
    "viterbi_encode": "rayuela_tpu/ops/viterbi_pallas.py:49",
    "scan_candidates": "rayuela_tpu/search/scan_pallas.py:701",
    "scan_onepass": "rayuela_tpu/search/scan_pallas.py:679",
    "codes_lut_candidates": "rayuela_tpu/search/scan_codes_pallas.py:220",
    "scan_f32_candidates": "rayuela_tpu/search/scan_pallas.py:629",
    "pair_merge": "rayuela_tpu/search/scan_pallas.py:657",
    "verify_counts": "rayuela_tpu/search/scan_pallas.py:734",
    "codes_lut_f32_candidates":
        "rayuela_tpu/search/scan_codes_pallas.py:179",
    "codes_verify_counts": "rayuela_tpu/search/scan_codes_pallas.py:232",
    "encoding_ils": "rayuela_tpu/ops/icm_pallas.py:111",
    "codes_decode_onepass": "rayuela_tpu/search/scan_codes_pallas.py:332",
    "fusion_chain": "demos/bench_mosaic_fusion.py:75",
}
SOURCES = {
    "codes_decode_candidates": "rayuela_tpu_torch/csrc/codes_scan.cu",
    "cand_merge": "rayuela_tpu_torch/csrc/codes_scan.cu",
    "tail_merge": "rayuela_tpu_torch/csrc/topk_tail.cu",
    "codes_decode_topk": "rayuela_tpu_torch/csrc/codes_scan.cu",
    "icm_sweeps": "rayuela_tpu_torch/csrc/icm.cu",
    "viterbi_encode": "rayuela_tpu_torch/csrc/viterbi.cu",
    "scan_candidates": "rayuela_tpu_torch/csrc/decoded_scan.cu",
    "scan_onepass": "rayuela_tpu_torch/csrc/decoded_scan.cu",
    "codes_lut_candidates": "rayuela_tpu_torch/csrc/lut_scan.cu",
    "scan_f32_candidates": "rayuela_tpu_torch/csrc/decoded_scan.cu",
    "pair_merge": "rayuela_tpu_torch/csrc/codes_scan.cu",
    "verify_counts": "rayuela_tpu_torch/csrc/decoded_scan.cu",
    "codes_lut_f32_candidates": "rayuela_tpu_torch/csrc/lut_scan.cu",
    "codes_verify_counts": "rayuela_tpu_torch/csrc/lut_scan.cu",
    "encoding_ils": "rayuela_tpu_torch/csrc/icm.cu",
    "codes_decode_onepass": "rayuela_tpu_torch/csrc/codes_scan.cu",
    "fusion_chain": "rayuela_tpu_torch/csrc/fusion_probe.cu",
}
# published peaks of one H100 SXM at its full power limit (per second)
PEAK = {"bf16 tensor-core": 989e12, "f32 CUDA-core": 67e12, "HBM": 3.35e12}
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


def timed(fn, reps, warm=True):
    """``(mean milliseconds of fn() over reps runs after one warm run,
    by CUDA events; the last run's result)``. ``warm=False`` skips the
    warm run: for a plain version that takes seconds and whose time is
    no yardstick."""
    import torch
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def record(times, name, ms, plain_ms, flop, peak, moved, library_ms=None):
    """Keep kernel ``name``'s times beside its bound: the larger of
    ``flop`` over the published peak ``peak`` and ``moved`` bytes over
    the HBM rate (``plain_ms`` None: the plain version was not timed at
    this shape)."""
    ops_ms = flop / PEAK[peak] * 1e3
    bytes_ms = moved / PEAK["HBM"] * 1e3
    times[name] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms}
    lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
    plain = "not timed" if plain_ms is None else f"{plain_ms:.3f} ms"
    print(f"  {name}: kernel {ms:.3f} ms, plain {plain}{lib}; "
          f"bound {max(ops_ms, bytes_ms):.3f} ms by "
          f"{times[name]['bound_by']} ({flop:.3g} flop at the {peak} peak "
          f"{ops_ms:.3f} ms, {moved:.3g} bytes {bytes_ms:.3f} ms)")


def library_scan(Qm, XdT, x2, k, qblock=1024):
    """The library's way to the same top-k: per query block one
    `addmm` (scores ``Qm Xd^T + x2`` in f32) and one `topk`."""
    import torch
    out = []
    for q0 in range(0, Qm.shape[0], qblock):
        sc = torch.addmm(x2[None, :], Qm[q0:q0 + qblock], XdT)
        out.append(torch.topk(sc, k, dim=1, largest=False))
    return out


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
    """The top-k of a key buffer by the plain cross-lane merge, with the
    flags (`profile_scan_tail.plain_topk`)."""
    from rayuela_tpu_torch.demos.profile_scan_tail import plain_topk as pt
    return pt(outp, r, k, idbits)


def row_scores(Qm, X, x2):
    """``(q, ids) -> Qm[q] . X[ids] + x2[ids]`` in f64: the raw scores of
    single (query, row) pairs on a scan's own operands."""
    def scores(q, ids):
        ids = ids.long()
        return (Qm[q].double() * X[ids].double()).sum(-1) \
            + x2.double()[ids]
    return scores


def unshared(gi, ri, kth, scores, tol):
    """The ids that one of two top-k lists ``(nq, k)`` holds and the other
    does not → ``(share of ids shared, all of them explained)``: explained
    where its own score (`row_scores`) lies within ``tol`` (per query) of
    the plain list's k-th score ``kth``, a tie at the boundary that
    either version may break its way. A row the kernel dropped or made
    up scores far inside the list and is not."""
    import torch
    missing = []
    for a, b in ((gi, ri), (ri, gi)):
        bs = b.sort(1).values
        pos = torch.searchsorted(bs, a.contiguous()).clamp(max=b.shape[1] - 1)
        missing.append(bs.gather(1, pos) != a)
    q = torch.cat([torch.nonzero(m, as_tuple=True)[0] for m in missing])
    ids = torch.cat([gi[missing[0]], ri[missing[1]]])
    ok = bool(((scores(q, ids) - kth.double()[q]).abs()
               <= tol.double()[q]).all()) if q.numel() else True
    return 1.0 - float(missing[0].float().mean()), ok


def compare_topk(tag, got, ref, idbits, exact, scores=None):
    """A packed top-k ``(truncated scores, ids, flags)`` against the plain
    version's → the max abs score difference; raises on disagreement.
    Integer data: identical. Else every score within one truncation step
    of the plain one's at the same position and, by PERF.md §2's rule,
    >= 99.9% of ids equal by position. With ``scores`` (`row_scores`, for
    d = 960, where one step of a raw score near -|q|^2 is ~0.5 wide and
    holds many neighbours, so a sum that rounds across a step boundary
    reorders them): >= 99.9% of ids shared, and every id of one list
    missing from the other within two steps of the plain k-th score."""
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
    check(within, f"{tag}: a score moved by more than one truncation step")
    if scores is None:
        print(f"  {tag}: ids equal by position {same:.6f}, max |dscore| "
              f"{err:.3g}, within one truncation step: {within}")
        check(same >= 0.999, f"{tag}: only {same:.6f} of ids equal")
        return err
    kth = rv[:, -1]
    hits, ok = unshared(gi, ri, kth, scores, 2 * step * kth.abs())
    print(f"  {tag}: ids shared {hits:.6f} (equal by position {same:.6f}), "
          f"those not shared within two steps of the k-th: {ok}; max "
          f"|dscore| {err:.3g}, within one truncation step: {within}")
    check(hits >= 0.999, f"{tag}: only {hits:.6f} of ids shared")
    check(ok, f"{tag}: an id not shared lies off the boundary")
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
                _, r, keep, _ = tsc._codes_config(k)
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
                # K8's keep=0 form over the same rows decoded: the same
                # scores (exact on integer data), so the same keys
                codes = tsc.unpack_codes(c.idx.packed, c.idx.mprime)
                if pq:
                    Xd, x2 = tsp.decode_base(c.idx.C, codes, pq=True, d=D)
                else:
                    Xd, x2 = tsp.decode_base(
                        c.idx.C, codes[:, :-1],
                        norm_term=c.idx.norms_cbook[codes[:, -1].long()])
                o8 = tsp.scan_onepass(c.Qm, Xd, x2, tile=tsc._RESCUE_TILE,
                                      r=r4, premin=0, idbits=idb4)
                same = float((o8 == o4).float().mean())
                print(f"  K8 (keep=0) keys equal to K4's on the same codes: "
                      f"{same:.6f}")
                check(same == 1.0, f"K8 (keep=0) {c.name}: keys != K4's")
                del codes, Xd, x2, o8
            got = tsc.scan_codes_decode_topk(c.Q, c.Cf, c.nrm, c.idx.packed,
                                             k=k, pq=pq)
            note(errs, "codes_decode_topk",
                 compare_topk(f"k={k} K4+K3 (r=48, tile=2048)", got,
                              plain_topk(o40, r4, k, idb4), idb4, exact))
            del c
            torch.cuda.empty_cache()


def kernel_times(rng, errs):
    """Each search kernel beside its plain version, its bound and the
    library's call at the main path's search batch (bf16 RVQ-7+1 layout,
    nq=1e4; the one-pass kernels at 128 rescued queries), the results of
    the timed runs held against each other as in phase 1."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print(f"== kernel times (ms; CUDA events) and checks, bf16 RVQ-7+1, "
          f"n={N}, nq={NQ}")
    c = Phase1(rng, False, "gauss", torch.bfloat16, NQ)
    times = {}
    idbits = tsp._pack_idbits(-(-N // 8192) * 8192)
    args = (c.Qm, c.Cf, c.nrm, c.idx.packed)
    # the same base decoded, for the library's call and for K8
    codes = tsc.unpack_codes(c.idx.packed, c.idx.mprime)
    ncb = c.idx.norms_cbook
    Xf, x2 = tsp.decode_base(c.idx.C, codes[:, :-1],
                             norm_term=ncb[codes[:, -1].long()])
    XfT, Qmf = Xf.T.contiguous(), c.Qm.float()
    flop = 2.0 * N * NQ * D
    for k in (100, 1000):
        _, r, keep, _ = tsc._codes_config(k)
        kw = dict(tile=8192, keep=keep, idbits=idbits, has_norms=True)
        print(f" k={k} plan (r={r}, keep={keep})")
        scan_lib_ms, _ = timed(lambda: library_scan(Qmf, XfT, x2, k), 1)
        ms, (cand, disc) = timed(
            lambda: tsc.codes_decode_candidates(*args, **kw), 3)
        pms, (cand0, disc0) = timed(
            lambda: tsc.codes_decode_candidates_plain(*args, **kw), 1)
        t = {}
        record(t, "codes_decode_candidates", ms, pms, flop,
               "bf16 tensor-core", nbytes(*args, cand, disc), scan_lib_ms)
        ms, out = timed(lambda: tsc.cand_merge(cand, disc, r), 5)
        pms, out0 = timed(lambda: tsc.cand_merge_plain(cand, disc, r), 2)
        check(torch.equal(out, out0), f"K2 nq={NQ} k={k}: kernel != plain")
        note(errs, "cand_merge", int_err((out, out0)))
        # the library's top-r of each (lane, query) over the candidates:
        # K2's buffer without its certificate
        lib2_ms, _ = timed(lambda: torch.topk(cand, r, dim=0, largest=False),
                           2)
        # one compare per candidate at the least, at the CUDA cores'
        # issue rate (half the FMA flop rate)
        record(t, "cand_merge", ms, pms, 2.0 * cand.numel(),
               "f32 CUDA-core", nbytes(cand, disc, out), lib2_ms)
        rows, cap = out[:r].contiguous(), 1 << (k - 1).bit_length()
        flat = rows.permute(2, 0, 1).reshape(NQ, -1).contiguous()
        lib_ms, _ = timed(lambda: torch.topk(flat, k, dim=1, largest=False),
                          5)
        ms, (kk, ln) = timed(lambda: tsp.tail_merge(rows, cap), 5)
        pms, (kk0, ln0) = timed(lambda: tsp.tail_merge_plain(rows, cap), 2)
        check(torch.equal(kk, kk0) and torch.equal(ln, ln0),
              f"K3 nq={NQ} k={k}: kernel != plain")
        note(errs, "tail_merge", int_err((kk, kk0), (ln, ln0)))
        record(t, "tail_merge", ms, pms, 2.0 * rows.numel(),
               "f32 CUDA-core", nbytes(rows, kk, ln), lib_ms)
        note(errs, "codes_decode_candidates", compare_topk(
            f"k={k} K1+K2+K3", plain_topk(out, r, k, idbits),
            plain_topk(tsc.cand_merge_plain(cand0, disc0, r), r, k, idbits),
            idbits, exact=False))
        del cand0, disc0
        k4_keys_equal_k1s(args, True, out, keep, idbits, f"k={k} plan")
        decoded_lut_times(c, Xf, x2, k, cand, disc, scan_lib_ms, errs, t)
        del cand, disc
        f32_times(c, Xf, x2, k, scan_lib_ms, errs, t)
        if k == 1000:
            times.update(t)
    del XfT, Qmf
    tail_deep(times, errs)
    Qr = c.Qm[:128].contiguous()
    r4 = tsc._RESCUE_R
    idb4 = tsp._pack_idbits(-(-N // tsc._RESCUE_TILE) * tsc._RESCUE_TILE)
    kw4 = dict(tile=tsc._RESCUE_TILE, r=r4, idbits=idb4, has_norms=True)
    print(" one-pass kernels, 128 queries, r=48, tile=2048")
    XfT = Xf.T.contiguous()
    lib_ms, _ = timed(lambda: library_scan(Qr.float(), XfT, x2, 1000), 2)
    del XfT
    ms, o4 = timed(lambda: tsc.codes_decode_topk(Qr, *args[1:], **kw4), 2)
    pms, o40 = timed(lambda: tsc.codes_decode_topk_plain(Qr, *args[1:],
                                                         **kw4), 1)
    note(errs, "codes_decode_topk", compare_topk(
        "128 queries, k=1000 K4+K3", plain_topk(o4, r4, 1000, idb4),
        plain_topk(o40, r4, 1000, idb4), idb4, exact=False))
    record(times, "codes_decode_topk", ms, pms, 2.0 * N * 128 * D,
           "bf16 tensor-core", nbytes(Qr, *args[1:], o4), lib_ms)
    Xd = Xf.to(torch.bfloat16)
    kw8 = dict(tile=tsc._RESCUE_TILE, r=r4, premin=0, idbits=idb4)
    ms, o8 = timed(lambda: tsp.scan_onepass(Qr, Xd, x2, **kw8), 2)
    pms, o80 = timed(lambda: tsp.scan_onepass_plain(Qr, Xd, x2, **kw8), 1)
    note(errs, "scan_onepass", compare_topk(
        "128 queries, k=1000 K8(keep=0)+K3", plain_topk(o8, r4, 1000, idb4),
        plain_topk(o80, r4, 1000, idb4), idb4, exact=False))
    record(times, "scan_onepass", ms, pms, 2.0 * N * 128 * D,
           "bf16 tensor-core", nbytes(Qr, Xd, x2, o8), lib_ms)
    # Gaussian data: K4 rounds its norms table and its summed codebook
    # rows to bf16, the decoded base its f32 rows, so the keys may differ
    same = float((o8 == o4).float().mean())
    print(f"  K8 (keep=0) keys equal to K4's on the same Gaussian codes "
          f"(bf16 norms and rows rounded apart): {same:.6f}")
    del Xd, o8, o80
    # the rescue's own batch: a few flagged queries, the base split over
    # CTAs and the splits merged by K2; timed at 1 and 8 queries
    XfT = Xf.T.contiguous()
    for nq in (1, 2, 8):
        Qr = c.Qm[:nq].contiguous()
        for k in (100, 1000):
            o4 = tsc.codes_decode_topk(Qr, *args[1:], **kw4)
            o40 = tsc.codes_decode_topk_plain(Qr, *args[1:], **kw4)
            note(errs, "codes_decode_topk", compare_topk(
                f"{nq} queries, k={k} K4+K3", plain_topk(o4, r4, k, idb4),
                plain_topk(o40, r4, k, idb4), idb4, exact=False))
        if nq == 2:
            continue
        lib_ms, _ = timed(lambda: library_scan(Qr.float(), XfT, x2, 1000),
                          5)
        ms, o4 = timed(lambda: tsc.codes_decode_topk(Qr, *args[1:], **kw4),
                       5)
        pms, _ = timed(lambda: tsc.codes_decode_topk_plain(
            Qr, *args[1:], **kw4), 1, warm=False)
        check(torch.equal(o4, tsc.codes_decode_topk(Qr, *args[1:], **kw4)),
              f"K4 {nq} queries: two calls differ")
        record(times, f"codes_decode_topk nq={nq}", ms, pms,
               2.0 * N * nq * D, "bf16 tensor-core",
               nbytes(Qr, *args[1:], o4), lib_ms)
    del c, XfT, Xf
    torch.cuda.empty_cache()
    return times


def tail_deep(times, errs, k=4096):
    """K3 at the deepest plan class that a k = 4096 search takes (r = 96,
    cap = 4096) over nq = 1e4 queries of per-lane ascending keys (the
    sortable keys of Gaussian scores, a seed of their own: a 96-deep
    buffer of phase-1 candidates would take 10 GB), held against its
    plain version and timed beside `torch.topk` over the same keys."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp

    r = tsp._scan_config(k)[0]
    cap = min(1 << (k - 1).bit_length(),
              (1 << (r - 1).bit_length()) * tsp.LANES)
    g = torch.Generator(device=DEV).manual_seed(k)
    rows = tsp._sortable_key(torch.randn((r, tsp.LANES, NQ), generator=g,
                                         device=DEV))
    rows = rows.sort(dim=0).values.contiguous()
    flat = rows.permute(2, 0, 1).reshape(NQ, -1).contiguous()
    lib_ms, _ = timed(lambda: torch.topk(flat, k, dim=1, largest=False), 3)
    del flat
    ms, (kk, ln) = timed(lambda: tsp.tail_merge(rows, cap), 3)
    pms, (kk0, ln0) = timed(lambda: tsp.tail_merge_plain(rows, cap), 1)
    check(torch.equal(kk, kk0) and torch.equal(ln, ln0),
          f"K3 r={r} cap={cap} nq={NQ}: kernel != plain")
    note(errs, "tail_merge", int_err((kk, kk0), (ln, ln0)))
    print(f" K3 at the k={k} plan (r={r}, cap={cap}), Gaussian keys")
    record(times, f"tail_merge k={k}", ms, pms, 2.0 * rows.numel(),
           "f32 CUDA-core", nbytes(rows, kk, ln), lib_ms)


def k4_keys_equal_k1s(args, has_norms, out, keep, idbits, tag, nq=128):
    """K4 (the rescue's one-pass scan) against K1 -> K2 on Gaussian data:
    on bf16 operands the three code-resident scans share one tensor-core
    score, so K4's first ``keep`` keys of each (lane, query) equal those
    of K2's merge of K1's candidates ``out`` (the tiles' top keeps hold
    each lane's top keep) for the first ``nq`` queries of ``args`` (K1's
    operands), bit for bit; the one-pass = two-pass gate of phases 7 and
    8 rests on it."""
    from rayuela_tpu_torch.search import scan_codes as tsc
    o4 = tsc.codes_decode_topk(
        args[0][:nq].contiguous(), *args[1:], tile=tsc._RESCUE_TILE,
        r=tsc._RESCUE_R, idbits=idbits, has_norms=has_norms)
    same = float((o4[:keep] == out[:keep, :, :nq]).float().mean())
    print(f"  {tag}: K4's first {keep} keys equal to K1 -> K2's on {nq} "
          f"Gaussian queries: {same:.6f}")
    check(same == 1.0, f"{tag}: K4's keys != K1's on Gaussian data")


def decoded_lut_times(c, Xf, x2, k, cand1, disc1, lib_ms, errs, t):
    """K8 and K5 at the k-class plan on the codes of ``c`` (whose K1
    output is ``cand1, disc1``; ``lib_ms`` is the library's call on the
    same decoded base): times beside the plain versions', and K8's keys
    against K1's."""
    import torch

    from rayuela_tpu_torch.demos.time_lut import library_lut, lut_offsets
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    r, keep, _ = tsp._scan_config(k)
    idbits = tsp._pack_idbits(-(-N // 8192) * 8192)
    Xd = Xf.to(torch.bfloat16)
    kw = dict(tile=8192, keep=keep, idbits=idbits)
    ms, (cand, disc) = timed(
        lambda: tsp.scan_candidates(c.Qm, Xd, x2, premin=0, **kw), 3)
    pms, (cand0, disc0) = timed(
        lambda: tsp.scan_candidates_plain(c.Qm, Xd, x2, premin=0, **kw), 1)
    record(t, "scan_candidates", ms, pms, 2.0 * N * NQ * D,
           "bf16 tensor-core", nbytes(c.Qm, Xd, x2, cand, disc), lib_ms)
    note(errs, "scan_candidates", compare_topk(
        f"k={k} K8+K2+K3", plain_topk(tsp.cand_merge(cand, disc, r), r, k,
                                      idbits),
        plain_topk(tsp.cand_merge_plain(cand0, disc0, r), r, k, idbits),
        idbits, exact=False))
    same = float(((cand == cand1).float().mean()
                  + (disc == disc1).float().mean()) / 2)
    print(f"  K8 keys equal to K1's on the same codes and norms byte (K8 "
          f"scans rows decoded from the f32 codebooks, K1 its bf16 "
          f"operands: below 1 on Gaussian data): {same:.6f}")
    pairs = tsp._chain_pairs(c.Qm, Xd, x2, **kw)
    print(f"  K8 k={k} plan: {pairs:,} of {N * NQ:,} (row, query) pairs "
          f"keyed by the fmaf chain ({pairs / (N * NQ):.3e})")
    del cand0, disc0, cand, disc, Xd
    T = tsc.build_luts(c.idx.C, c.Q, norms_cbook=c.idx.norms_cbook)
    Tb = T.to(torch.bfloat16).contiguous()
    offs = lut_offsets(c.idx.packed, c.idx.mprime)
    lib5_ms, _ = timed(lambda: library_lut(Tb, offs, k), 1)
    del offs
    for name, Tq, reps in (("bf16", Tb, 3), ("f32", T.contiguous(), 1)):
        ms, (cand, disc) = timed(
            lambda: tsc.codes_lut_candidates(Tq, c.idx.packed, **kw), reps)
        pms, (cand0, disc0) = timed(
            lambda: tsc.codes_lut_candidates_plain(Tq, c.idx.packed, **kw), 1)
        check(torch.equal(cand, cand0) and torch.equal(disc, disc0),
              f"K5 {name} tables nq={NQ} k={k}: kernel != plain")
        note(errs, "codes_lut_candidates", int_err((cand, cand0),
                                                   (disc, disc0)))
        if name == "bf16":
            record(t, "codes_lut_candidates", ms, pms,
                   1.0 * N * NQ * c.idx.mprime, "f32 CUDA-core",
                   nbytes(Tq, c.idx.packed, cand, disc), lib5_ms)
        else:
            print(f"  codes_lut_candidates with f32 tables: kernel "
                  f"{ms:.3f} ms, plain {pms:.3f} ms")
        del cand, disc, cand0, disc0
    torch.cuda.empty_cache()


def compare_f32(tag, got, ref, exact, scores=None):
    """Two exact-float top-k results ``(scores, ids, flagged)`` → the
    max abs score difference; raises on disagreement. Exact data: all
    identical. Else scores within 1e-5 relative + 1e-4 (the terms of a
    score reach ~1e2 and round at that size) and, by PERF.md §2's rule,
    >= 99.9% of ids equal by position and flags equal. With ``scores``
    (`row_scores`; d = 960, where the scores near the k-th crowd closer
    than that tolerance): >= 99.5% of ids shared, every id of one list
    missing from the other within twice the tolerance of the plain k-th
    score; the flags print (their counts, K10's, may differ at the
    boundary, see `check_f32_kernels`)."""
    import torch
    (gv, gi, gf), (rv, ri, rf) = got, ref
    err = float((gv - rv).abs().max())
    if exact:
        check(torch.equal(gv, rv) and torch.equal(gi, ri)
              and torch.equal(gf, rf), f"{tag}: kernel != plain")
        print(f"  {tag}: identical (scores, ids, flags)")
        return err
    same = float((gi == ri).float().mean())
    within = bool(((gv - rv).abs()
                   <= 1e-5 * torch.maximum(gv.abs(), rv.abs()) + 1e-4).all())
    check(within, f"{tag}: a score moved by more than 1e-5 relative")
    flags = f"flags equal: {bool(torch.equal(gf, rf))} ({int(gf.sum())} " \
            f"against {int(rf.sum())} flagged)"
    if scores is None:
        print(f"  {tag}: ids equal by position {same:.6f}, max |dscore| "
              f"{err:.3g}, within 1e-5 relative: {within}, {flags}")
        check(same >= 0.999, f"{tag}: only {same:.6f} of ids equal")
        check(torch.equal(gf, rf), f"{tag}: flags differ")
        return err
    kth = rv[:, -1]
    hits, ok = unshared(gi, ri, kth, scores, 2 * (1e-5 * kth.abs() + 1e-4))
    print(f"  {tag}: ids shared {hits:.6f} (equal by position {same:.6f}), "
          f"those not shared within twice the tolerance of the k-th: {ok}; "
          f"max |dscore| {err:.3g}, within 1e-5 relative: {within}, {flags}")
    check(hits >= 0.995, f"{tag}: only {hits:.6f} of ids shared")
    check(ok, f"{tag}: an id not shared lies off the boundary")
    return err


def finish_f32(ov, oi, counts, k, r, keep):
    """`scan._finish_f32` that also hands back the boundary pairs it
    counted at → ``((scores, ids, flagged), (taus, taui))``."""
    from rayuela_tpu_torch.search import scan as tsp
    kept = {}

    def count(ts, ti):
        kept["tau"] = (ts, ti)
        return counts(ts, ti)
    return tsp._finish_f32(ov, oi, k, r, keep, count), kept["tau"]


def f32_pipeline(cands, merge, counts, k, r, keep):
    """K9 or K6 from ``cands() -> (candv, candi)`` through ``merge`` and
    the top-k to the flags of ``counts(taus, taui)`` → ``((scores, ids,
    flagged), (candv, candi), (taus, taui))``."""
    cv, ci = cands()
    res, tau = finish_f32(*merge(cv, ci, r), counts, k, r, keep)
    return res, (cv, ci), tau


def check_f32_kernels(tag, kernel, plain, k, r, keep, exact, errs, names,
                      scores=None):
    """The kernel pipeline against the plain one (``kernel``, ``plain``:
    ``(cands, merge, counts)``), and each kernel on the other's inputs
    where those must give identical outputs. Gaussian data: the counts at
    the kernel's boundary pairs differ in at most 1e-3 of (lane, query);
    with ``scores`` (`compare_f32`'s d = 960 rule) they lie within the
    plain counts at the boundary's score -/+ 1e-5 relative + 1e-4 (a row
    that close counts on either side in the two sums; a count is
    monotone in the boundary)."""
    import torch
    got, (cv, ci), tau = f32_pipeline(*kernel, k, r, keep)
    ref, (cv0, ci0), _ = f32_pipeline(*plain, k, r, keep)
    if exact:
        check(torch.equal(cv, cv0) and torch.equal(ci, ci0),
              f"{tag}: candidates kernel != plain")
    # the merge and, on exact data, the counts: same inputs, same outputs
    mv, mi = kernel[1](cv, ci, r)
    mv0, mi0 = plain[1](cv, ci, r)
    check(torch.equal(mv, mv0) and torch.equal(mi, mi0),
          f"{tag}: pair merge kernel != plain")
    note(errs, "pair_merge", int_err((mi, mi0)))
    del cv, ci, cv0, ci0, mv, mi, mv0, mi0
    cnt, cnt0 = kernel[2](*tau), plain[2](*tau)
    dc = int((cnt.long() - cnt0.long()).abs().max())
    off = float((cnt != cnt0).float().mean())
    if exact:
        check(dc == 0, f"{tag}: counts kernel != plain")
    elif scores is None:
        check(off <= 1e-3, f"{tag}: {off:.2e} of the counts differ")
    else:
        ts, ti = tau
        delta = 1e-5 * ts.abs() + 1e-4
        lo, hi = plain[2](ts - delta, ti), plain[2](ts + delta, ti)
        inside = bool(((lo <= cnt) & (cnt <= hi)).all())
        print(f"  {tag}: K10's counts within the plain counts at the "
              f"boundary -/+ 1e-5 relative: {inside} ({off:.2e} differ at "
              f"the boundary itself; bracket at most "
              f"{int((hi.long() - lo.long()).max())} wide)")
        check(inside, f"{tag}: the counts leave the plain bracket")
    err = compare_f32(tag, got, ref, exact, scores)
    note(errs, names[0], err)
    note(errs, names[1], float(dc))
    return err


def decoded_f32_fns(Qm, Xd, x2, tile, keep):
    """``(cands, merge, counts)`` of K9/K10 and of their plain versions
    on a decoded base."""
    from rayuela_tpu_torch.search import scan as tsp
    kw = dict(tile=tile, keep=keep)
    kernel = (lambda: tsp.scan_f32_candidates(Qm, Xd, x2, **kw),
              tsp.pair_merge,
              lambda ts, ti: tsp.verify_counts(Qm, Xd, x2, ts, ti,
                                               tile=tile))
    plain = (lambda: tsp.scan_f32_candidates_plain(Qm, Xd, x2, **kw),
             tsp.pair_merge_plain,
             lambda ts, ti: tsp.verify_counts_plain(Qm, Xd, x2, ts, ti,
                                                    tile=tile))
    return kernel, plain


def lut_f32_fns(T, packed, tile, keep):
    """``(cands, merge, counts)`` of K6/K7 and of their plain versions
    on tables ``T`` (at the table dtype, contiguous)."""
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    kw = dict(tile=tile, keep=keep)
    kernel = (lambda: tsc.codes_lut_f32_candidates(T, packed, **kw),
              tsp.pair_merge,
              lambda ts, ti: tsc.codes_verify_counts(T, packed, ts, ti,
                                                     tile=tile))
    plain = (lambda: tsc.codes_lut_f32_candidates_plain(T, packed, **kw),
             tsp.pair_merge_plain,
             lambda ts, ti: tsc.codes_verify_counts_plain(T, packed, ts, ti,
                                                          tile=tile))
    return kernel, plain


F32_PLANS = ((16, 2, 8192, 100), (32, 4, 8192, 1000), (48, 4, 8192, 3072))


def phase1d(rng, errs):
    """K9, K10, K6, K7 and the pair merge against their plain versions."""
    import torch

    from rayuela_tpu_torch.demos.time_lut import library_lut, lut_offsets
    from rayuela_tpu_torch.kernels.build import query
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print(f"== phase 1d: exact-float kernels vs plain, n={N}, d={D}, "
          f"nq={NQ1}")
    for kind, dtype in (("int", torch.float32), ("int", torch.bfloat16),
                        ("gauss", torch.float32), ("gauss", torch.bfloat16)):
        exact = kind == "int"
        if exact:
            X = rng.integers(-3, 4, (N, D)).astype("float32")
            Q = rng.integers(-3, 4, (NQ1, D)).astype("float32")
        else:
            X = rng.standard_normal((N, D)).astype("float32")
            Q = rng.standard_normal((NQ1, D)).astype("float32")
        X, Q = torch.as_tensor(X, device=DEV), torch.as_tensor(Q, device=DEV)
        idx = tsp.LinscanIndex(X.to(dtype), (X * X).sum(-1))
        del X
        Qm = tsp._query_operand(Q, D, dtype)
        name = f"K9/K10 {kind} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
        print(f" {name}")
        for r, keep, tile, k in F32_PLANS[:3 if exact else 2]:
            kernel, plain = decoded_f32_fns(Qm, idx.Xd, idx.x2, tile, keep)
            check_f32_kernels(
                f"r={r} keep={keep} tile={tile} k={k}", kernel, plain, k, r,
                keep, exact, errs, ("scan_f32_candidates", "verify_counts"))
        del idx
        torch.cuda.empty_cache()
    for kind, dtype in (("int", torch.float32), ("gauss", torch.float32),
                        ("gauss", torch.bfloat16)):
        c = Phase1(rng, False, kind, torch.float32, NQ1)
        T = tsc.build_luts(c.idx.C, c.Q, norms_cbook=c.idx.norms_cbook)
        T = T.to(dtype).contiguous()
        bf16 = int(dtype == torch.bfloat16)
        lay = query("rq_lut_exact_layout", c.idx.mprime, 256, bf16, size=4,
                    device=torch.device(DEV))
        print(f" K6/K7 RVQ-7+1 {kind} {'bf16' if bf16 else 'f32'} tables; "
              f"layout (queries, threads, shared bytes, CTAs an SM) {lay}")
        check(lay[:3] == tsc._lut_exact_layout(c.idx.mprime, 256, bf16),
              "K6/K7's layout differs from its mirror")
        if kind == "gauss":
            # the library's sums (embedding_bag over the tables' f32
            # values) against the plain version's on the first tile
            offs = lut_offsets(c.idx.packed[:8192], c.idx.mprime)
            same = torch.equal(library_lut(T, offs, 1),
                               tsc._lut_scores_fn(T, c.idx.packed, 8192)(
                                   0, 0, min(1024, NQ1)))
            print(f"  the library's scores (embedding_bag) equal the "
                  f"kernels' (the plain version's) on the first tile: {same}")
            del offs
        for r, keep, tile, k in F32_PLANS[:2]:
            kernel, plain = lut_f32_fns(T, c.idx.packed, tile, keep)
            check_f32_kernels(
                f"r={r} keep={keep} tile={tile} k={k}", kernel, plain, k, r,
                keep, True, errs,
                ("codes_lut_f32_candidates", "codes_verify_counts"))
        del c, T
        torch.cuda.empty_cache()


def f32_times(c, Xf, x2, k, lib_ms, errs, t):
    """K9 (both passes), K10, K6 and K7 at the f32 plan's class for
    ``k`` on the codes of ``c``: times beside the plain versions', the
    timed runs' results held against each other. The f32 index and the
    f32 tables are recorded (phase 6's operands); the bf16 ones print."""
    import torch

    from rayuela_tpu_torch.demos.time_lut import library_lut, lut_offsets
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    r, keep, tile, _ = tsp._f32_config(k, DEV)
    flop = 2.0 * N * NQ * D

    def finish(ov, oi, counts):
        return finish_f32(ov, oi, counts, k, r, keep)

    kernel, plain = decoded_f32_fns(
        tsp._query_operand(c.Q, D, torch.float32), Xf, x2, tile, keep)
    ms, (cv, ci) = timed(kernel[0], 2)
    pms, (cv0, ci0) = timed(plain[0], 1, warm=False)
    mms, (ov, oi) = timed(lambda: tsp.pair_merge(cv, ci, r), 3)
    mpms, (ov0, oi0) = timed(lambda: tsp.pair_merge_plain(cv, ci, r), 1,
                             warm=False)
    check(torch.equal(ov, ov0) and torch.equal(oi, oi0),
          f"pair merge nq={NQ} k={k}: kernel != plain")
    got, tau = finish(ov, oi, kernel[2])
    ov0, oi0 = tsp.pair_merge_plain(cv0, ci0, r)
    del cv0, ci0
    ref, _ = finish(ov0, oi0, plain[2])
    note(errs, "scan_f32_candidates", compare_f32(
        f"k={k} K9+top-k+K10, f32 index", got, ref, exact=False))
    vms, cnt = timed(lambda: kernel[2](*tau), 2)
    vpms, cnt0 = timed(lambda: plain[2](*tau), 1, warm=False)
    off = float((cnt != cnt0).float().mean())
    check(off <= 1e-3, f"K10 nq={NQ} k={k}: {off:.2e} of the counts differ")
    note(errs, "verify_counts", float((cnt.long() - cnt0.long()).abs().max()))
    Qm = tsp._query_operand(c.Q, D, torch.float32)
    record(t, "scan_f32_candidates", ms, pms, flop, "f32 CUDA-core",
           nbytes(Qm, Xf, x2, cv, ci), lib_ms)
    # the library's top-r of each (lane, query) over the candidate scores
    # (the pair merge orders equal scores by id as well)
    libm_ms, _ = timed(lambda: torch.topk(cv, r, dim=0, largest=False), 2)
    record(t, "pair_merge", mms, mpms, 2.0 * cv.numel(), "f32 CUDA-core",
           nbytes(cv, ci, ov, oi), libm_ms)
    record(t, "verify_counts", vms, vpms, flop, "f32 CUDA-core",
           nbytes(Qm, Xf, x2, *tau, cnt))
    del cv, ci, ov, oi, ov0, oi0, cnt, cnt0, got, ref
    # the bf16 index: the kernels' times alone (phase 1d holds them
    # against their plain versions)
    Xb = Xf.to(torch.bfloat16)
    kernel, _ = decoded_f32_fns(c.Qm, Xb, x2, tile, keep)
    ms, _ = timed(kernel[0], 2)
    vms, _ = timed(lambda: kernel[2](*tau), 2)
    print(f"  on the bf16 index: scan_f32_candidates {ms:.3f} ms, "
          f"verify_counts {vms:.3f} ms; their bound at the bf16 tensor-core "
          f"peak {flop / PEAK['bf16 tensor-core'] * 1e3:.3f} ms")
    del Xb
    torch.cuda.empty_cache()
    T = tsc.build_luts(c.idx.C, c.Q, norms_cbook=c.idx.norms_cbook)
    T = T.contiguous()
    adds = 1.0 * N * NQ * c.idx.mprime
    offs = lut_offsets(c.idx.packed, c.idx.mprime)
    lib6_ms, _ = timed(lambda: library_lut(T, offs, k), 1)
    del offs
    kernel, plain = lut_f32_fns(T, c.idx.packed, tile, keep)
    ms, (cv, ci) = timed(kernel[0], 2)
    pms, (cv0, ci0) = timed(plain[0], 1, warm=False)
    check(torch.equal(cv, cv0) and torch.equal(ci, ci0),
          f"K6 f32 tables nq={NQ} k={k}: kernel != plain")
    del cv0, ci0
    _, tau = finish(*tsp.pair_merge(cv, ci, r), kernel[2])
    vms, cnt = timed(lambda: kernel[2](*tau), 2)
    vpms, cnt0 = timed(lambda: plain[2](*tau), 1, warm=False)
    check(torch.equal(cnt, cnt0),
          f"K7 f32 tables nq={NQ} k={k}: kernel != plain")
    note(errs, "codes_lut_f32_candidates", 0.0)
    note(errs, "codes_verify_counts", 0.0)
    record(t, "codes_lut_f32_candidates", ms, pms, adds, "f32 CUDA-core",
           nbytes(T, c.idx.packed, cv, ci), lib6_ms)
    record(t, "codes_verify_counts", vms, vpms, adds, "f32 CUDA-core",
           nbytes(T, c.idx.packed, *tau, cnt))
    del cv, ci, cnt, cnt0
    Tb = T.to(torch.bfloat16).contiguous()
    kernel, _ = lut_f32_fns(Tb, c.idx.packed, tile, keep)
    ms, _ = timed(kernel[0], 2)
    vms, _ = timed(lambda: kernel[2](*tau), 2)
    print(f"  with bf16 tables: codes_lut_f32_candidates {ms:.3f} ms, "
          f"codes_verify_counts {vms:.3f} ms")
    del T, Tb
    torch.cuda.empty_cache()


def phase1c(rng, errs):
    """K8 (both forms) and K5 against their plain versions."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print(f"== phase 1c: K8 and K5 vs plain, n={N}, d={D}, nq={NQ1}")
    idb1 = tsp._pack_idbits(-(-N // 2048) * 2048)
    plans = sorted({tsp._scan_config(k)
                    for k in (100, 1000, 2049, tsp._MAX_K)})
    for kind, dtype in (("int", torch.float32), ("gauss", torch.bfloat16)):
        exact = kind == "int"
        if exact:
            X = rng.integers(-3, 4, (N, D)).astype("float32")
            Q = rng.integers(-3, 4, (NQ1, D)).astype("float32")
        else:
            X = rng.standard_normal((N, D)).astype("float32")
            Q = rng.standard_normal((NQ1, D)).astype("float32")
        X, Q = torch.as_tensor(X, device=DEV), torch.as_tensor(Q, device=DEV)
        idx = tsp.LinscanIndex(X.to(dtype), (X * X).sum(-1))
        del X
        Qm = tsp._query_operand(Q, D, dtype)
        name = f"K8 {kind} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
        print(f" {name}")
        for r, keep, tile in plans:
            idbits = tsp._pack_idbits(-(-N // tile) * tile)
            kw = dict(tile=tile, keep=keep, premin=0, idbits=idbits)
            tag = f"r={r} keep={keep} tile={tile}"
            cand, disc = tsp.scan_candidates(Qm, idx.Xd, idx.x2, **kw)
            cand0, disc0 = tsp.scan_candidates_plain(Qm, idx.Xd, idx.x2,
                                                     **kw)
            if exact:
                check(torch.equal(cand, cand0)
                      and torch.equal(disc, disc0),
                      f"{name} {tag}: kernel != plain")
            out = tsp.cand_merge(cand, disc, r)
            out0 = tsp.cand_merge_plain(cand, disc, r)
            check(torch.equal(out, out0), f"K2 {name} {tag}: kernel != plain")
            note(errs, "cand_merge", int_err((out, out0)))
            del cand, disc, out
            # a k in the plan's class: K3 then merges its deepest lists
            k = min(r * 64, tsp._MAX_K)
            got = tsp.scan_topk_packed(Q, idx.Xd, idx.x2, k=k, r=r,
                                       tile=tile, keep=keep)
            ref = plain_topk(tsp.cand_merge_plain(cand0, disc0, r), r, k,
                             idbits)
            note(errs, "scan_candidates", compare_topk(
                f"{tag} k={k} K8+K2+K3", got, ref, idbits, exact))
            del cand0, disc0, out0
        kw = dict(tile=2048, r=tsp._ONEPASS_R, premin=0, idbits=idb1)
        o8 = tsp.scan_onepass(Qm, idx.Xd, idx.x2, **kw)
        o80 = tsp.scan_onepass_plain(Qm, idx.Xd, idx.x2, **kw)
        if exact:
            check(torch.equal(o8, o80), f"{name} keep=0: kernel != plain")
        got = tsp.scan_topk_packed(Q, idx.Xd, idx.x2, k=1000, tile=2048,
                                   r=tsp._ONEPASS_R, keep=0)
        note(errs, "scan_onepass", compare_topk(
            "keep=0 r=48 tile=2048 k=1000 K8+K3", got,
            plain_topk(o80, tsp._ONEPASS_R, 1000, idb1), idb1, exact))
        del idx, o8, o80
        torch.cuda.empty_cache()
    for kind, dtype in (("int", torch.float32), ("gauss", torch.float32),
                        ("gauss", torch.bfloat16)):
        c = Phase1(rng, False, kind, torch.float32, NQ1)
        T = tsc.build_luts(c.idx.C, c.Q, norms_cbook=c.idx.norms_cbook)
        T = T.to(dtype).contiguous()
        for keep, tile in ((2, 8192), (4, 8192), (4, 2048)):
            kw = dict(tile=tile, keep=keep,
                      idbits=tsp._pack_idbits(-(-N // tile) * tile))
            cand, disc = tsc.codes_lut_candidates(T, c.idx.packed, **kw)
            cand0, disc0 = tsc.codes_lut_candidates_plain(T, c.idx.packed,
                                                          **kw)
            check(torch.equal(cand, cand0) and torch.equal(disc, disc0),
                  f"K5 {kind} {dtype} keep={keep}: kernel != plain")
            note(errs, "codes_lut_candidates", int_err((cand, cand0),
                                                       (disc, disc0)))
            del cand, disc, cand0, disc0
        print(f" K5 RVQ-7+1 {kind} "
              f"{'bf16' if dtype == torch.bfloat16 else 'f32'} tables: "
              f"identical (keep 2 and 4, tiles 8192 and 2048)")
        del c, T
        torch.cuda.empty_cache()


def _encode_case(rng, kind, n, m, h=256, d=D):
    """X (n, d), C (m, h, d) as f32 tensors on the card."""
    import torch
    if kind == "int":
        X = rng.integers(-1, 2, (n, d)).astype("float32")
        C = rng.integers(-1, 2, (m, h, d)).astype("float32")
    else:
        X = rng.standard_normal((n, d)).astype("float32")
        C = (rng.standard_normal((m, h, d)) * 0.3).astype("float32")
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
    runs' results held against each other as in phase 1b, with their
    bounds (K11: icmiter * m visits of h * d multiply-adds per vector,
    on bf16 operands with f32 accumulation, so held to the bf16
    tensor-core peak; K13: m * h * d multiply-adds for the unaries and
    (m - 1) * h * h add-min pairs per vector on f32 inputs, held to the
    f32 CUDA-core peak)."""
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
    times = {}
    record(times, "icm_sweeps", ms, pms, 2.0 * 4 * m * 256 * D * NT,
           "bf16 tensor-core", nbytes(X, C, B, order, *got))
    ms, got = timed(lambda: tvit.viterbi_encode(X, C), 5)
    pms, ref = timed(lambda: tvit.viterbi_encode_plain(X, C), 1)
    note(errs, "viterbi_encode", compare_viterbi("K13 timed", X, C, got,
                                                 ref, exact=False))
    record(times, "viterbi_encode", ms, pms,
           NT * (2.0 * m * 256 * D + 2.0 * (m - 1) * 256 * 256),
           "f32 CUDA-core", nbytes(X, C, got))
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


def profile(fn, top=8):
    """Device time by kernel over one call of ``fn``, and the device's
    idle share of the call's wall time (torch.profiler) → ``(wall ms,
    [(kernel, device ms)])``, the kernels by time (none where the
    profiler recorded no device time)."""
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
        return wall * 1e3, rows
    print(f"    profile: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}")
    for name, ms in rows[:top]:
        print(f"      {ms:9.2f} ms  {name[:90]}")
    return wall * 1e3, rows


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
        with chainq_operands() as vit:
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


def check_search(dists, ids, k, n=N):
    import torch
    check(dists.shape == (NQ, k) and ids.shape == (NQ, k),
          "search returned the wrong shape")
    check(bool(torch.isfinite(dists).all()), "non-finite dists")
    check(bool(((ids >= 0) & (ids < n)).all()), "ids out of range")


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
    jax1 = JAX_RECALL1["sr_d"]
    z = (jax1 - out[100]) / SRD_SEED_SD
    print(f"  sr_d: recall@1 {out[100]:.4f} (JAX package, BASELINE.md: "
          f"{jax1}; {z:+.2f} seed standard deviations below it)")
    check(out[100] >= 0.99, f"SR-D recall@1 {out[100]:.4f} < 0.99")
    check(z <= 3.0, f"SR-D recall@1 {out[100]:.4f} lies {z:.2f} seed "
          f"standard deviations ({SRD_SEED_SD}) below the JAX row {jax1}")
    return index, Xb, t2 - t1


def c5_check(ds, Xq, n=20_000):
    """An LSQ-family model at h = 2048 (RVQ-trained codebooks, m = 4,
    served as an LSQ model) encodes a base through `api.index_base`: the
    ICM encode takes the ported ``xla`` path by shape, before any launch
    (no K11 or K12 launch), improves on the greedy codes it starts from,
    and the decoded index serves a search; an explicit ``impl="pallas"``
    on those codebooks raises."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.models.rvq import quantize_rvq
    from rayuela_tpu_torch.ops import icm as ticm
    from rayuela_tpu_torch.ops.qerror import veccost_chunked

    h, m = 2048, 4
    print(f"== C5: an LSQ model at h={h} (m={m}, d={D}) encodes {n} base "
          f"vectors through index_base")
    rvq = rq.train(ds.Xt[:n], method="rvq", m=m, h=h, niter=2, device=DEV)
    C = rvq.codebooks
    model = rq.MCQModel("lsq", C, h=h, train_codes=rvq.train_codes)
    Xb = torch.as_tensor(ds.Xb[:n], device=DEV)
    xla = ticm.encoding_icm.routes["xla"]
    n11, n12 = ticm.icm_sweeps.launches, ticm.encoding_ils.launches
    torch.cuda.synchronize()
    t = time.perf_counter()
    index = rq.index_base(model, Xb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(ticm.encoding_icm.routes["xla"] == xla + 1
          and (ticm.icm_sweeps.launches, ticm.encoding_ils.launches)
          == (n11, n12), "the h=2048 encode did not take the xla path alone")
    greedy = float(veccost_chunked(Xb, C, quantize_rvq(C, Xb)[0]).mean())
    bqe = float(veccost_chunked(Xb, C, index.codes).mean())
    print(f"  index_base (greedy + ILS 32 rounds by the xla path): "
          f"{wall:.1f} s; base qerror {bqe:.4f} (greedy {greedy:.4f})")
    check(bqe <= greedy, f"ILS raised the base qerror {greedy} -> {bqe}")
    dists, ids = rq.search(index, Xq[:1000], k=10)
    check(bool(torch.isfinite(dists).all())
          and bool(((ids >= 0) & (ids < n)).all()),
          "the h=2048 index returned bad results")
    gen = torch.Generator(device=DEV).manual_seed(0)
    try:
        ticm.encoding_icm(gen, Xb[:64], C, index.codes[:64], impl="pallas")
        raised = False
    except ValueError as e:
        raised = f"h={h}" in str(e)
    check(raised, "impl='pallas' at h=2048 did not raise")
    del index, Xb


def shared_ids(a, b):
    """Mean share of each row's ids that the two results have in common
    (as sets)."""
    return sum(len(set(x.tolist()) & set(y.tolist()))
               for x, y in zip(a.cpu(), b.cpu())) / a.numel()


def warm_walls(fn, reps=3):
    """Host-clock seconds of ``reps`` calls of ``fn``, each to a
    synchronize."""
    import torch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return walls


def phase5(card, ds, Xq, Xb, index4):
    """The decoded-index and LUT-mode main path on phase 4's model: the
    default calls only, so that the launch counts read after it are this
    path's own. Returns the index and the results for `phase5_checks`."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search.linscan import eval_recall, linscan_lsq

    print(f"== phase 5: decoded-index and LUT-mode main path, SR-D-7+1, "
          f"{N} base, {NQ} queries ({card})")
    model = index4.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = rq.index_base(model, Xb)             # the default: decoded
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    si = index.scan_index
    check(index.mode == "decoded" and isinstance(si, tsp.LinscanIndex)
          and si.Xd.dtype == torch.bfloat16 and si.Xd.shape == (N, D),
          "index_base's default is not the bf16 decoded index")
    same_codes = bool(torch.equal(index.codes, index4.codes))
    print(f"  index_base (default mode): {t1 - t0:.1f} s, "
          f"{N / (t1 - t0):,.0f} base vectors/s; decoded base "
          f"{nbytes(si.Xd, si.x2) / 1e6:.0f} MB; codes equal to phase 4's: "
          f"{same_codes}")
    res = {}
    for k in (100, 1000):
        for name, idx, kw in (("decoded", index, {}),
                              ("lut", index4, {"mode": "lut"})):
            dists, ids = rq.search(idx, Xq, k=k, **kw)
            torch.cuda.synchronize()
            check_search(dists, ids, k)
            curve = eval_recall(ids, ds.gt, verbose=False)
            walls = warm_walls(lambda: rq.search(idx, Xq, k=k, **kw))
            wall = float(np.median(walls))
            print(f"  {name} k={k}: recall@1 {curve[0]:.4f} @10 "
                  f"{curve[9]:.4f} @100 {curve[99]:.4f}; search "
                  f"{NQ / wall:,.0f} queries/s (median of "
                  f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms)")
            check(curve[0] >= 0.99,
                  f"{name} SR-D recall@1 {curve[0]:.4f} < 0.99")
            res[(name, k)] = (dists, ids)
    # the reference's front end on the same codes: the facade's result
    dists, ids = res[("decoded", 100)]
    dls, ils = linscan_lsq(model.codebooks, Xq, index.codes,
                           index.norms_codebook, index.norm_codes, k=100)
    check(torch.equal(ils, ids) and torch.equal(dls, dists),
          "linscan_lsq != api.search on the same codes")
    print("  linscan_lsq(k=100) on the same codes: identical to api.search")
    return index, res


def phase5_checks(Xq, index4, res):
    """Phase 5's results against phase 4's decode-mode search and the
    LUT oracle; runs after phase 5's launch counts were read."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print("== phase 5 results against decode mode and the LUT oracle")
    step = 2.0 ** (tsp._pack_idbits(-(-N // 8192) * 8192) - 23)
    q2 = (Xq * Xq).sum(-1, keepdim=True)
    for k in (100, 1000):
        d4, i4 = rq.search(index4, Xq, k=k)
        for name in ("decoded", "lut"):
            dists, ids = res[(name, k)]
            hits = shared_ids(ids[:512], i4[:512])
            print(f"  {name} k={k} against decode mode: ids equal by "
                  f"position {float((ids == i4).float().mean()):.4f}, "
                  f"shared ids (first 512 queries) {hits:.4f}, max |ddist| "
                  f"{float((dists - d4).abs().max()):.3g}")
            # decode mode reads the norm term from a bf16 table, the
            # decoded index keeps it in f32, LUT mode rounds each table
            # entry: the same neighbourhoods, not the same keys
            check(hits >= 0.8, f"{name} k={k} shares only {hits:.4f} of "
                  "decode mode's ids")
        # the LUT oracle on the same tables (bf16 on the card): one
        # truncation step of the raw score
        dl, il = res[("lut", k)]
        so, io = tsc._lut_scan_tiled(
            index4.scan_index, Xq[:64], k, D,
            torch.bfloat16 if Xq.device.type == "cuda" else torch.float32)
        raw = dl[:64] - q2[:64]
        same = shared_ids(il[:64], io)
        # + the f32 rounding of adding and taking away |q|^2
        tol = step * so.abs() + 1e-6 * (q2[:64] + so.abs())
        within = bool(((raw - so).abs() <= tol).all())
        print(f"  lut k={k} vs the LUT oracle (64 queries): shared ids "
              f"{same:.6f}, scores within one truncation step: {within}")
        check(same >= 0.98 and within, f"LUT mode k={k} != the LUT oracle")


def phase5_onepass(index, Xq, res):
    """An explicit one-pass configuration through the facade: K8 at
    keep=0 (with K2 over its splits and K3), with launch counts of its
    own."""
    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp

    print("== phase 5, explicit one-pass configuration")
    d1, i1 = rq.search(index, Xq[:128], k=100, keep=0, r=tsp._ONEPASS_R,
                       tile=2048)
    agree = float((i1 == res[("decoded", 100)][1][:128]).float().mean())
    print(f"  search(keep=0, r=48, tile=2048) on 128 queries: ids equal to "
          f"the plan's by position {agree:.6f}")
    # a flagged query's exact re-run orders within a truncation step anew
    check(agree >= 0.98, "the one-pass configuration disagrees")


def close_to_resident(tag, got, ref):
    """A streamed exact-float search against the resident one → ``(share
    of ids equal by position, share of queries identical in dists and
    ids)``. The two run the same kernels on the same tables, but a
    flagged query re-runs through the LUT oracle, which builds its
    tables for another batch of queries (cuBLAS then sums in another
    order), and the flags of four shards are not those of the whole
    base; and the shard merge orders by the dist, which rounding can
    make equal where the raw scores were not. So: dists within 1e-5
    relative + 1e-4, >= 99.9% of ids equal by position."""
    import torch
    (gd, gi), (rd, ri) = got, ref
    within = bool(((gd - rd).abs() <= 1e-5 * rd.abs() + 1e-4).all())
    same = float((gi == ri).float().mean())
    whole = float(((gi == ri).all(1) & (gd == rd).all(1)).float().mean())
    check(within, f"{tag}: a dist is more than 1e-5 relative from the "
          f"resident search's (max {float((gd - rd).abs().max()):.3g})")
    check(same >= 0.999, f"{tag}: only {same:.6f} of ids equal the resident "
          "search's by position")
    return same, whole


def phase6(card, ds, Xq, index4, index5):
    """The exact-float main path (``pack=False``) and the streamed
    searches on phase 4's model and codes: the default calls only, so
    that the launch counts read after it are this path's own. Returns
    the f32 index and the results for `phase6_checks`."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search.linscan import eval_recall, linscan_lsq

    print(f"== phase 6: exact-float (pack=False) and streamed main path, "
          f"SR-D-7+1, {N} base, {NQ} queries ({card})")
    model = index4.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nt = index5.norms_codebook[index5.norm_codes.long()]
    si = tsp.build_index(model.codebooks, index5.codes, d=D, norm_term=nt,
                         dtype=torch.float32)
    torch.cuda.synchronize()
    print(f"  build_index(dtype=float32) on phase 5's codes: "
          f"{time.perf_counter() - t0:.2f} s, decoded base "
          f"{nbytes(si.Xd, si.x2) / 1e6:.0f} MB")
    check(si.Xd.dtype == torch.float32 and si.Xd.shape == (N, D),
          "not an f32 decoded index")
    index = rq.MCQIndex(model, index5.codes, si, index5.norms_codebook,
                        index5.norm_codes, mode="decoded")
    lut = {"mode": "lut", "pack": False, "op_dtype": torch.float32}
    res, walls6 = {}, {}
    for k in (100, 1000):
        for name, idx, kw in (("decoded", index, {"pack": False}),
                              ("lut", index4, lut)):
            dists, ids = rq.search(idx, Xq, k=k, **kw)
            torch.cuda.synchronize()
            check_search(dists, ids, k)
            curve = eval_recall(ids, ds.gt, verbose=False)
            walls = warm_walls(lambda: rq.search(idx, Xq, k=k, **kw))
            wall = float(np.median(walls))
            print(f"  {name} pack=False k={k}: recall@1 {curve[0]:.4f} @10 "
                  f"{curve[9]:.4f} @100 {curve[99]:.4f}; search "
                  f"{NQ / wall:,.0f} queries/s (median of "
                  f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms)")
            check(curve[0] >= 0.99,
                  f"{name} pack=False SR-D recall@1 {curve[0]:.4f} < 0.99")
            res[(name, k)] = (dists, ids)
            walls6[(name, k)] = wall
    dists, ids = res[("decoded", 100)]
    dls, ils = linscan_lsq(model.codebooks, Xq, index.codes,
                           index.norms_codebook, index.norm_codes, k=100,
                           pack=False)
    check(torch.equal(ils, ids) and torch.equal(dls, dists),
          "linscan_lsq(pack=False) != api.search(pack=False)")
    print("  linscan_lsq(k=100, pack=False) on the same codes: identical to "
          "api.search")
    # the packed base in host memory, streamed in 4 shards
    host = index4.scan_index.packed.cpu().numpy()
    skw = dict(norms_cbook=index4.norms_codebook, mprime=8,
               shard_n=N // 4, **lut)
    sd, si_ = rq.search_streamed(model, host, Xq, k=100, **skw)
    torch.cuda.synchronize()
    rd, ri = res[("lut", 100)]
    same, whole = close_to_resident("search_streamed(mode='lut', pack=False)",
                                    (sd, si_), (rd, ri))
    walls = warm_walls(lambda: rq.search_streamed(model, host, Xq, k=100,
                                                  **skw))
    print(f"  search_streamed, 4 shards, lut pack=False k=100: dists within "
          f"1e-5 relative of the resident search's, ids equal by position "
          f"{same:.6f}, queries identical in both {whole:.4f}; wall "
          f"{float(np.median(walls)) * 1e3:.1f} ms (median of "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}) against "
          f"{walls6[('lut', 100)] * 1e3:.1f} ms resident")
    return index, res, host


def phase6_streamed_decode(index4, Xq, host):
    """`api.search_streamed` in decode mode (packed keys): counts of its
    own. A shard's keys keep more score bits than the whole base's, so
    the result is held to the resident search within one truncation
    step."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp

    print("== phase 6, streamed search in decode mode")
    skw = dict(norms_cbook=index4.norms_codebook, mprime=8, shard_n=N // 4)
    sd, si = rq.search_streamed(index4.model, host, Xq, k=100, **skw)
    torch.cuda.synchronize()
    check_search(sd, si, 100)
    rwalls = warm_walls(lambda: rq.search(index4, Xq, k=100))
    rd, ri = rq.search(index4, Xq, k=100)
    walls = warm_walls(lambda: rq.search_streamed(index4.model, host, Xq,
                                                  k=100, **skw))
    step = 2.0 ** (tsp._pack_idbits(-(-N // 8192) * 8192) - 23)
    raw = rd - (Xq * Xq).sum(-1, keepdim=True)
    within = bool(((sd - rd).abs() <= step * raw.abs() + 1e-6 * rd.abs())
                  .all())
    same = float((si == ri).float().mean())
    hits = shared_ids(si[:512], ri[:512])
    print(f"  search_streamed, 4 shards, decode mode k=100: ids equal to the "
          f"resident search by position {same:.4f}, shared ids (first 512 "
          f"queries) {hits:.4f}, dists within one truncation step: "
          f"{within}; wall "
          f"{float(np.median(walls)) * 1e3:.1f} ms (median of "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}) against "
          f"{float(np.median(rwalls)) * 1e3:.1f} ms resident")
    # rows within one step of each other order by row id, and a shard's
    # step is finer than the whole base's: the same neighbourhoods
    check(within and hits >= 0.9, "streamed decode mode disagrees with the "
          "resident search")


def phase6_checks(Xq, index4, index, res):
    """Phase 6's results against the exact scans on 64 queries; the flag
    counts of the f32 plan; one search's device time by kernel. Runs
    after phase 6's launch counts were read."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import exact_rescan

    print("== phase 6 results against exact_rescan and the LUT oracle, "
          "flags, profiles")
    si, sc = index.scan_index, index4.scan_index
    q2 = (Xq * Xq).sum(-1, keepdim=True)
    # the tables of the whole batch, as the search builds them: an
    # oracle on tables built for 64 queries alone would sum in another
    # order
    T = tsc.build_luts(sc.C, Xq, norms_cbook=sc.norms_cbook)
    codes = tsc.unpack_codes(sc.packed, sc.mprime)
    for k in (100, 1000, 3072):
        r, keep, tile, _ = tsp._f32_config(k, DEV)
        fl = tsp.scan_topk_f32(Xq, si.Xd, si.x2, k=k, r=r, tile=tile,
                               keep=keep)[2]
        fll = tsc.scan_codes_topk(T, sc.packed, k=k, r=r, tile=tile,
                                  keep=keep, lut_dtype=torch.float32,
                                  pack=False)[2]
        print(f"  f32 plan k={k} (r={r}, keep={keep}, tile={tile}): "
              f"{int(fl.sum())} of {NQ} queries flagged (decoded), "
              f"{int(fll.sum())} (lut)")
        if k > 1000:
            continue
        dd, di = res[("decoded", k)]
        ed, ei = exact_rescan(Xq[:64], si.Xd, si.x2, k)
        same = float((di[:64] == ei).float().mean())
        within = bool(((dd[:64] - ed).abs() <= 1e-5 * ed.abs() + 1e-4).all())
        print(f"  decoded pack=False k={k} vs exact_rescan (64 queries; "
              f"cuBLAS sums in another order): ids equal by position "
              f"{same:.6f}, dists within 1e-5 relative: {within}")
        check(same >= 0.999 and within,
              f"decoded pack=False k={k} != exact_rescan")
        ld, li = res[("lut", k)]
        so, io = tsc.lut_scan(T[:, :, :64], codes, k)
        ok = ~fll[:64]      # a flagged query re-ran on tables of its own
        check(torch.equal(li[:64][ok], io[ok])
              and torch.equal(ld[:64][ok], (so + q2[:64])[ok]),
              f"lut pack=False k={k} != the LUT oracle by position")
        print(f"  lut pack=False k={k} vs the LUT oracle on the same tables "
              f"({int(ok.sum())} unflagged of 64 queries): identical by "
              f"position")
        profile(lambda: rq.search(index, Xq, k=k, pack=False))
        profile(lambda: rq.search(index4, Xq, k=k, mode="lut", pack=False,
                                  op_dtype=torch.float32))


SWEEP_NQ = 2500
SWEEP_K = (2048, 4096, 8192)
SWEEP_PLANS = ((32, 4, 8192), (48, 4, 8192), (96, 4, 8192), (96, 4, 2048),
               (96, 4, 1024))


def plan_sweep(index, index4, Xq):
    """What the plan's deep classes rest on: for each k, the queries
    each (r, keep, tile) flags and the time of the scan (pass 1 → K2 →
    K3, CUDA events) over `SWEEP_NQ` queries of the main path, for the
    decoded and the LUT scan, beside the exact scans that serve a k
    beyond the plan (`exact_rescan`, `_lut_scan_tiled`)."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import exact_rescan

    print(f"== plan sweep: flagged of {SWEEP_NQ} queries and scan ms, "
          f"SR-D-7+1, n={N}")
    si, sc = index.scan_index, index4.scan_index
    Q = Xq[:SWEEP_NQ].contiguous()
    T = tsc.build_luts(sc.C, Q, norms_cbook=sc.norms_cbook)
    for k in SWEEP_K:
        ems, _ = timed(lambda: exact_rescan(Q, si.Xd, si.x2, k), 1)
        lms, _ = timed(lambda: tsc._lut_scan_tiled(sc, Q, k, D,
                                                   torch.bfloat16), 1)
        print(f"  k={k}: exact_rescan {ems:.1f} ms, LUT oracle {lms:.1f} ms; "
              f"the plan takes {tsp._scan_config(min(k, tsp._MAX_K))}"
              f"{'' if k <= tsp._MAX_K else ' up to k=' + str(tsp._MAX_K)}")
        for r, keep, tile in SWEEP_PLANS:
            if k > r * 128:
                continue
            ms, out = timed(lambda: tsp.scan_topk_packed(
                Q, si.Xd, si.x2, k=k, r=r, tile=tile, keep=keep), 1)
            lm, lout = timed(lambda: tsc.scan_codes_topk(
                T, sc.packed, k=k, r=r, tile=tile, keep=keep,
                lut_dtype=torch.bfloat16), 1)
            print(f"    r={r} keep={keep} tile={tile}: decoded "
                  f"{int(out[2].sum())} flagged, {ms:.1f} ms; lut "
                  f"{int(lout[2].sum())} flagged, {lm:.1f} ms")
            del out, lout
        torch.cuda.empty_cache()


def base_encode_check(rng, errs, model, Xb):
    """K11 against its plain version at the base-encode shape the main
    path launches it at: one icmiter=4 sweep over the whole base from the
    greedy codes, with the SR-D model's codebooks → ``(ms of the sweep,
    its operations)`` (CUDA events; the products of its visits)."""
    import torch

    from rayuela_tpu_torch.models.rvq import quantize_rvq
    from rayuela_tpu_torch.ops import icm as ticm

    m = model.codebooks.shape[0]
    print(f"== K11 vs plain at the base encode: n={Xb.shape[0]}, "
          f"d={Xb.shape[1]}, m={m}, SR-D codebooks, greedy codes")
    B0 = quantize_rvq(model.codebooks, Xb)[0].to(torch.int32).contiguous()
    order = torch.as_tensor(rng.permutation(m), dtype=torch.int32,
                            device=DEV)
    ms, got = timed(lambda: ticm.icm_sweeps(Xb, model.codebooks, B0,
                                            order, 4), 3)
    ref = ticm.icm_sweeps_plain(Xb, model.codebooks, B0, order, 4,
                                op_dtype=torch.bfloat16)
    note(errs, "icm_sweeps", compare_icm("K11 base icmiter=4", got, ref,
                                         exact=False))
    return ms, 2.0 * 4 * m * model.codebooks.shape[1] * Xb.shape[1] \
        * Xb.shape[0]


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
            _, r, keep, _ = tsc._codes_config(k)
            fl = tsc.scan_codes_decode_topk_2p(Xq, Cf, nrm, si.packed, k=k,
                                               pq=si.pq, r=r, keep=keep)[2]
            print(f"  {method} k={k}: {int(fl.sum())} of {NQ} queries "
                  f"flagged by the two-pass certificate")
            profile(lambda: rq.search(index, Xq, k=k))


def diagnostics5(index, index4, Xq):
    """After phase 5's launch counts were read: the queries each scan's
    certificate flags, and one search's device time by kernel."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print("== diagnostics of the phase-5 searches (k=4096: the plan's "
          "deepest class)")
    si, sc = index.scan_index, index4.scan_index
    for k in (100, 1000, 4096):
        r, keep, tile = tsp._scan_config(k)
        fl = tsp.scan_topk_packed(Xq, si.Xd, si.x2, k=k, r=r, tile=tile,
                                  keep=keep)[2]
        print(f"  decoded k={k}: {int(fl.sum())} of {NQ} queries flagged "
              f"(r={r}, keep={keep}, tile={tile})")
        if k < 4096 and si.Xd.dtype == torch.bfloat16:
            Qm = tsp._query_operand(Xq, si.Xd.shape[1], si.Xd.dtype)
            pairs = tsp._chain_pairs(Qm, si.Xd, si.x2, tile=tile,
                                     keep=keep, idbits=tsp._pack_idbits(
                                         -(-N // tile) * tile))
            print(f"  K8 k={k} plan: {pairs:,} of {N * NQ:,} (row, query) "
                  f"pairs keyed by the fmaf chain "
                  f"({pairs / (N * NQ):.3e}): their tensor-core scores lie "
                  "near a key boundary below their buffer's threshold")
        profile(lambda: rq.search(index, Xq, k=k))
        T = tsc.build_luts(sc.C, Xq, norms_cbook=sc.norms_cbook)
        fl = tsc.scan_codes_topk(T, sc.packed, k=k, r=r, tile=tile,
                                 keep=keep, lut_dtype=torch.bfloat16)[2]
        del T
        print(f"  lut k={k}: {int(fl.sum())} of {NQ} queries flagged")
        profile(lambda: rq.search(index4, Xq, k=k, mode="lut"))


ILS_KW = dict(ilsiter=8, icmiter=4, npert=4)   # phase 1e's K12 runs


def _orders(rng, m, rounds):
    """``rounds`` node orders (rounds, m) int32 on the card."""
    import numpy as np
    import torch
    return torch.as_tensor(np.stack([rng.permutation(m)
                                     for _ in range(rounds)]),
                           dtype=torch.int32, device=DEV)


def phase1e(rng, errs):
    """K12 and K14 against their plain versions on the card, and K11 at
    the shapes beyond its former range (h = 512, d = 960)."""
    import torch

    from rayuela_tpu_torch.ops import icm as ticm
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    m = 7
    print(f"== phase 1e: K12 vs plain, n={N1B}, d={D}, m={m}, h=256, "
          f"{ILS_KW}")
    for kind in ("int", "gauss"):
        X, C = _encode_case(rng, kind, N1B, m)
        B = torch.as_tensor(rng.integers(0, 256, (N1B, m)),
                            dtype=torch.int32, device=DEV)
        orders = _orders(rng, m, ILS_KW["ilsiter"])
        seed = int(rng.integers(0, 2 ** 31 - 1))
        got = ticm.encoding_ils(X, C, B, orders, seed, **ILS_KW)
        ref = ticm.encoding_ils_plain(X, C, B, orders, seed,
                                      op_dtype=torch.bfloat16, **ILS_KW)
        note(errs, "encoding_ils", compare_icm(f"K12 {kind}", got, ref,
                                               kind == "int"))
        del X, C, B
    print("  K11 beyond one register block of labels and at GIST's d")
    for h, d in ((512, D), (256, 960)):
        for kind in ("int", "gauss"):
            X, C = _encode_case(rng, kind, 16_384, 8, h=h, d=d)
            B = torch.as_tensor(rng.integers(0, h, (16_384, 8)),
                                dtype=torch.int32, device=DEV)
            order = _orders(rng, 8, 1)[0]
            got = ticm.icm_sweeps(X, C, B, order, 4)
            ref = ticm.icm_sweeps_plain(X, C, B, order, 4,
                                        op_dtype=torch.bfloat16)
            note(errs, "icm_sweeps", compare_icm(
                f"K11 h={h} d={d} {kind} icmiter=4", got, ref,
                kind == "int"))
            del X, C, B
    print(f"  K14 vs plain, n={N}, d={D}, nq={NQ1}, the one-pass plans")
    for pq in (False, True):
        for kind, dtype in (("int", torch.float32),
                            ("gauss", torch.bfloat16)):
            c = Phase1(rng, pq, kind, dtype, NQ1)
            exact = kind == "int"
            print(f" {c.name}")
            for k in (100, 1000):
                r, keep, tile = tsc._onepass_config(k, c.idx.mprime)
                idbits = tsp._pack_idbits(-(-N // tile) * tile)
                kw = dict(tile=tile, r=r, keep=keep, idbits=idbits,
                          has_norms=not pq)
                out = tsc.codes_decode_onepass(c.Qm, c.Cf, c.nrm,
                                               c.idx.packed, **kw)
                ref = tsc.codes_decode_onepass_plain(c.Qm, c.Cf, c.nrm,
                                                     c.idx.packed, **kw)
                if exact:
                    check(torch.equal(out, ref),
                          f"K14 {c.name} k={k}: kernel != plain")
                note(errs, "codes_decode_onepass", compare_topk(
                    f"k={k} K14+K3 (r={r}, keep={keep}, tile={tile})",
                    plain_topk(out, r, k, idbits),
                    plain_topk(ref, r, k, idbits), idbits, exact))
            del c
            torch.cuda.empty_cache()


def onepass_ils_times(rng, errs):
    """K14 beside its plain version (K1 → K2's plain versions), its bound
    and the library's call at the main path's search batch (bf16
    RVQ-7+1 layout, nq=1e4, both one-pass plans; the k=1000 plan's
    figures are kept), and K12 beside its plain version at the timed
    encode batch (1e5 vectors, m=7, ilsiter 8, icmiter 4; bound as K11:
    its visits' multiply-adds at the bf16 tensor-core peak), the results
    of the timed runs held against each other as in phase 1e."""
    import torch

    from rayuela_tpu_torch.ops import icm as ticm
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print(f"== K14 and K12 times (ms; CUDA events), bf16 RVQ-7+1, n={N}, "
          f"nq={NQ}")
    c = Phase1(rng, False, "gauss", torch.bfloat16, NQ)
    args = (c.Qm, c.Cf, c.nrm, c.idx.packed)
    codes = tsc.unpack_codes(c.idx.packed, c.idx.mprime)
    ncb = c.idx.norms_cbook
    Xf, x2 = tsp.decode_base(c.idx.C, codes[:, :-1],
                             norm_term=ncb[codes[:, -1].long()])
    XfT, Qmf = Xf.T.contiguous(), c.Qm.float()
    del Xf, codes
    times = {}
    for k in (100, 1000):
        r, keep, tile = tsc._onepass_config(k, c.idx.mprime)
        idbits = tsp._pack_idbits(-(-N // tile) * tile)
        kw = dict(tile=tile, r=r, keep=keep, idbits=idbits, has_norms=True)
        print(f" k={k} one-pass plan (r={r}, keep={keep}, tile={tile})")
        lib_ms, _ = timed(lambda: library_scan(Qmf, XfT, x2, k), 1)
        ms, out = timed(lambda: tsc.codes_decode_onepass(*args, **kw), 2)
        pms, ref = timed(lambda: tsc.codes_decode_onepass_plain(*args, **kw),
                         1, warm=False)
        note(errs, "codes_decode_onepass", compare_topk(
            f"k={k} K14+K3 timed", plain_topk(out, r, k, idbits),
            plain_topk(ref, r, k, idbits), idbits, exact=False))
        lay = tsc._onepass_layout(
            r, keep, c.Qm.shape[1], c.idx.packed.shape[1], 1, c.Qm.device)
        ntiles = -(-N // tile)
        _, tp = tsc._onepass_grid(NQ, ntiles, lay)
        slots = f"{lay[6]} slots of {lay[5]}-CTA clusters"
        rule = tsc._onepass_tiles_per
        tsc._onepass_tiles_per = lambda nqb, ntiles, slots: ntiles
        try:
            ms1, out1 = timed(lambda: tsc.codes_decode_onepass(*args, **kw),
                              2)
        finally:
            tsc._onepass_tiles_per = rule
        check(torch.equal(out1, out), f"K14 k={k}: one split != "
              f"{-(-ntiles // tp)} splits")
        print(f"  K14 at {-(-ntiles // tp)} splits ({tp} of {ntiles} tiles "
              f"per CTA, {slots}) {ms:.3f} ms; unsplit "
              f"{ms1:.3f} ms; the same buffers")
        del out1
        t = {}
        record(t, "codes_decode_onepass", ms, pms, 2.0 * N * NQ * D,
               "bf16 tensor-core", nbytes(*args, out), lib_ms)
        if k == 1000:
            times.update(t)
        del out, ref
        torch.cuda.empty_cache()
    del XfT, Qmf, c
    m = 7
    X, C = _encode_case(rng, "gauss", NT, m)
    B = torch.as_tensor(rng.integers(0, 256, (NT, m)), dtype=torch.int32,
                        device=DEV)
    orders = _orders(rng, m, ILS_KW["ilsiter"])
    ms, got = timed(lambda: ticm.encoding_ils(X, C, B, orders, 7, **ILS_KW),
                    2)
    pms, ref = timed(lambda: ticm.encoding_ils_plain(
        X, C, B, orders, 7, op_dtype=torch.bfloat16, **ILS_KW), 1,
        warm=False)
    note(errs, "encoding_ils", compare_icm("K12 timed", got, ref,
                                           exact=False))
    visits = ILS_KW["ilsiter"] * ILS_KW["icmiter"] * m
    record(times, "encoding_ils", ms, pms, 2.0 * visits * 256 * D * NT,
           "bf16 tensor-core", nbytes(X, C, B, orders, *got))
    del X, C, B
    torch.cuda.empty_cache()
    return times


def phase7(card, ds, Xq, Xb, index4, wall4):
    """The whole-ILS encode and the one-pass decode scan through the
    facade at full width, on phase 4's model and data."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.ops import icm as ticm
    from rayuela_tpu_torch.ops.qerror import veccost_chunked
    from rayuela_tpu_torch.search.linscan import eval_recall

    print(f"== phase 7: whole-ILS encode (K12) and one-pass decode scan "
          f"(K14), SR-D-7+1, {N} base, {NQ} queries ({card})")
    model = index4.model
    ils, cap = ticm._ils, {}

    def capture(ops, B, orders, seed, **kw):
        """K12's launch as the facade makes it, its operands kept for
        `ils_base_check`."""
        cap.update(B=B, orders=orders, seed=seed, kw=kw)
        return ils(ops, B, orders, seed, **kw)

    ticm._ils = capture
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        index = rq.index_base(model, Xb, mode="codes", impl="pallas-ils")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        ticm._ils = ils
    q7 = float(veccost_chunked(Xb, model.codebooks, index.codes).mean())
    q4 = float(veccost_chunked(Xb, model.codebooks, index4.codes).mean())
    print(f"  index_base(impl='pallas-ils', ILS 32 rounds in one launch): "
          f"{wall:.2f} s, {N / wall:,.0f} base vectors/s (relaunch path, "
          f"phase 4: {wall4:.2f} s); base qerror {q7:.6f} against the "
          f"relaunch codes' {q4:.6f} ({q7 / q4 - 1:+.4%})")
    check(q7 <= 1.01 * q4, f"K12's base qerror {q7:.6f} > 1.01 x {q4:.6f}")
    dists, ids = rq.search(index, Xq, k=100)
    check_search(dists, ids, 100)
    r1 = float(eval_recall(ids, ds.gt, verbose=False)[0])
    print(f"  default codes search of the K12 index: recall@1 {r1:.4f}")
    check(r1 >= 0.99, f"recall@1 {r1:.4f} < 0.99 on the K12 index")
    res = {}
    calls = [(f"twopass=False k={k}", k, dict(twopass=False))
             for k in (100, 1000)]
    calls += [("stage=1 k=1000", 1000, dict(stage=1)),
              ("twopass=False qsuper=4 k=100", 100,
               dict(twopass=False, qsuper=4))]
    for tag, k, kw in calls:
        dists, ids = rq.search(index4, Xq, k=k, **kw)
        check_search(dists, ids, k)
        walls = warm_walls(lambda: rq.search(index4, Xq, k=k, **kw))
        wall = float(np.median(walls))
        print(f"  search({tag}): {NQ / wall:,.0f} queries/s (median of "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms)")
        res[tag] = (k, kw, dists, ids)
    return index, res, cap


def ils_base_check(errs, model, Xb, index, cap):
    """After phase 7's launch counts were read: K12 on the operands phase
    7's base encode gave it (the 1e6 base, the SR-D codebooks, the greedy
    codes, its 32 node orders and seed) once more, which must give phase
    7's codes, against its plain version at the bf16 objective."""
    import torch

    from rayuela_tpu_torch.ops import icm as ticm

    kw = cap["kw"]
    print(f"== K12 vs plain at the base encode: n={Xb.shape[0]}, "
          f"m={model.codebooks.shape[0]}, SR-D codebooks, greedy codes, "
          f"seed {cap['seed']}, {kw}")
    args = (Xb, model.codebooks, cap["B"], cap["orders"], cap["seed"])
    got = ticm.encoding_ils(*args, **kw)
    check(torch.equal(got[0], index.codes),
          "K12 on phase 7's operands does not give phase 7's codes")
    t = time.perf_counter()
    ref = ticm.encoding_ils_plain(*args, op_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    print(f"  plain version: {time.perf_counter() - t:.1f} s")
    note(errs, "encoding_ils", compare_icm(
        f"K12 base ilsiter={kw['ilsiter']}", got, ref, exact=False))


def phase7_checks(Xq, Xb, index4, res):
    """After phase 7's launch counts were read: each one-pass search
    against the two-pass search on the same index, which must be
    identical but for queries that reached the LUT oracle (a query K4
    flags again), and the flagged counts of both plans."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan_codes as tsc

    print("== phase 7 results against the two-pass search (phase 4's)")
    si = index4.scan_index
    Cf, nrm = si.decode_operands(D, torch.bfloat16)
    ref = {}
    for tag, (k, kw, dists, ids) in res.items():
        if k not in ref:
            ref[k] = rq.search(index4, Xq, k=k)
        rd, ri = ref[k]
        r2, keep2, tile2 = tsc._codes_config(k)[1:]
        fl2 = tsc.scan_codes_decode_topk_2p(Xq, Cf, nrm, si.packed, k=k,
                                            pq=si.pq, r=r2, keep=keep2,
                                            tile=tile2)[2]
        r, keep, tile = tsc._onepass_config(k, si.mprime)
        fl1 = tsc.scan_codes_decode_topk(Xq, Cf, nrm, si.packed, k=k,
                                         pq=si.pq, r=r, keep=keep,
                                         tile=tile)[2]
        either = torch.nonzero(fl1 | fl2).flatten()
        oracle = torch.zeros_like(fl1)
        if either.numel():     # the rescue's K4 pass: its flags go on
            oracle[either] = tsc.scan_codes_decode_topk(
                Xq[either], Cf, nrm, si.packed, k=k, pq=si.pq)[2]
        same = (dists == rd).all(1) & (ids == ri).all(1)
        bad = int((~same & ~oracle).sum())
        print(f"  {tag}: flagged one-pass {int(fl1.sum())}, two-pass "
              f"{int(fl2.sum())} of {NQ}; {int(oracle.sum())} reach the LUT "
              f"oracle; identical to the two-pass result: "
              f"{int(same.sum())} of {NQ} queries")
        check(bad == 0, f"{tag}: {bad} queries differ from the two-pass "
              "search outside the LUT oracle's")
    print("  device time of the two base encodes, by kernel")
    model = index4.model
    for impl in ("pallas-ils", "auto"):
        print(f"   index_base(impl={impl!r})")
        profile(lambda: rq.index_base(model, Xb, mode="codes", impl=impl))
    profile(lambda: rq.search(index4, Xq, k=1000, twopass=False))


# ---------------------------------------------------------------------------
# Phase 8: GIST1M's shape (d = 960) through every scan; phase 9: 128-bit
# codes (m' = 16) with f32 tables; the two probes
# ---------------------------------------------------------------------------

D8 = 960            # GIST1M's width (rayuela_tpu/experiments/datasets.py)
N8 = 500_000        # phase 8's base: GIST1M's 1e6 cut in half to keep the
                    # script's time (two base encodes at d = 960 took 82 s
                    # each at 1e6 on an H100 before K11 ran on the tensor
                    # cores; 3.7 s each at 5e5 since, PERF.md)
NSUB = 256          # the query subset of the phase 8 and 9 checks
SCANS8 = (("decoded", "index", {}),
          ("decode mode", "codes", {}),
          ("one-pass", "codes", {"twopass": False}),
          ("lut", "codes", {"mode": "lut"}),
          ("decoded pack=False", "f32", {"pack": False}))


def truncated(raw, idbits):
    """The f32 scores a packed key keeps of ``raw``."""
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.utils import sortable_key
    return tsp._unsortable_key(sortable_key(raw) & -(1 << idbits))


def exact64(Qm, X, x2, k, chunk=64):
    """The ``k`` smallest raw scores ``Qm x + x2`` of each query over the
    rows ``X``, in f64 (no rounding that matters at these sizes),
    ascending → ``(nq, k)``."""
    import torch
    X64, x64 = X.double(), x2.double()[None, :]
    out = [torch.topk(torch.addmm(x64, Qm[a:a + chunk].double(), X64.T), k,
                      dim=1, largest=False).values
           for a in range(0, Qm.shape[0], chunk)]
    del X64
    return torch.cat(out)


def check_topk(tag, got, q2, Qm, X, x2, best, tol_rel):
    """A search's ``(dists, ids)`` on the check subset against the exact
    scan of its own scores, ``Qm x + x2`` over the rows ``X`` (``best``:
    their k smallest per query, `exact64`): the ids distinct, each
    dist (less ``q2``) within ``tol_rel`` relative of its own id's score
    in f64, and the worst id returned within the same of the exact k-th
    score, so the ids are the exact top-k up to scores that close
    (``tol_rel``: one truncation step for packed keys, 1e-5 for the
    exact-float scans; + 1e-5 of the largest score: the f32 rounding of
    a sum of d terms and of adding |q|^2)."""
    import torch
    d, ids = got
    own = torch.cat([
        (X[ids[a:a + 64].long()].double() * Qm[a:a + 64].double()[:, None])
        .sum(-1) + x2.double()[ids[a:a + 64].long()]
        for a in range(0, ids.shape[0], 64)])
    atol = 1e-5 * float(own.abs().max())
    raw = d.double() - q2.double()
    own_ok = bool(((raw - own).abs() <= tol_rel * own.abs() + atol).all())
    kth = best[:, -1]
    worst = own.max(1).values
    top_ok = bool((worst <= kth + tol_rel * kth.abs() + atol).all())
    distinct = all(len(set(r.tolist())) == ids.shape[1] for r in ids.cpu())
    print(f"  {tag}: {ids.shape[0]} queries, dists are their ids' scores "
          f"{own_ok}, the worst id within {tol_rel:.3g} relative of the "
          f"exact k-th score {top_ok}, ids distinct {distinct}")
    check(own_ok and top_ok and distinct,
          f"{tag}: not the exact top-k of its own scores")


NENC = 16_384       # vectors of the phase 8 and 9 encode-kernel checks


@contextlib.contextmanager
def chainq_operands():
    """Within the block ChainQ's K13 calls go through a wrapper that keeps
    the operands of the latest one, its first `NENC` vectors and its
    codebooks, in the yielded dict (``"ops"``); its launches count as
    before."""
    from rayuela_tpu_torch.models import chainq
    real, kept = chainq.viterbi_encode, {}

    def keep(X, C, *a, **kw):
        kept["ops"] = (X[:NENC].clone(), C.clone())
        return real(X, C, *a, **kw)
    chainq.viterbi_encode = keep
    try:
        yield kept
    finally:
        chainq.viterbi_encode = real


def encode_checks(rng, errs, tag, model, Xb, vit, label=""):
    """K11 and K13 against their plain versions on a slice of a phase's
    own operands, after its launch counts were read: K11 as
    `base_encode_check` on the phase's first `NENC` base vectors, K13 on
    those of its last ChainQ encode (``vit``, `chainq_operands`). Both
    timed there (CUDA events) beside their bounds → ``{name + label:
    record}`` (the ``wide`` records)."""
    from rayuela_tpu_torch.ops import viterbi as tvit

    t = {}
    ms, ops = base_encode_check(rng, errs, model, Xb)
    record(t, "icm_sweeps" + label, ms, None, ops, "bf16 tensor-core",
           nbytes(Xb, model.codebooks))
    X, C = vit
    ms, got = timed(lambda: tvit.viterbi_encode(X, C), 3)
    note(errs, "viterbi_encode", compare_viterbi(
        f"K13 {tag}: the last ChainQ encode, {X.shape[0]} vectors, "
        f"m={C.shape[0]}, d={C.shape[2]}", X, C, got,
        tvit.viterbi_encode_plain(X, C), exact=False))
    m, h, d = C.shape
    record(t, "viterbi_encode" + label, ms, None,
           X.shape[0] * (2.0 * m * h * d + 2.0 * (m - 1) * h * h),
           "f32 CUDA-core", nbytes(X, C, got))
    print(f"  {tag}: K11 {t['icm_sweeps' + label]['ms']:.3f} ms "
          f"(bound {t['icm_sweeps' + label]['bound_ms']:.3f}), K13 "
          f"{ms:.3f} ms (bound {t['viterbi_encode' + label]['bound_ms']:.3f})"
          f" on {Xb.shape[0]} / {X.shape[0]} vectors")
    return t


def phase8(seed, card):
    """GIST1M's shape through the facade: data, training, both base
    encodes and every scan at k = 100 and 1000, the default calls only,
    so that the launch counts read after it are this path's own."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.experiments.datasets import make_synthetic
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search.linscan import eval_recall

    print(f"== phase 8: GIST1M's shape, synthetic-corr d={D8}, {NTRAIN} "
          f"train, {N8} base, {NQ} queries, SR-D m=7+1, h=256, niter=10 "
          f"({card})")
    t0 = time.perf_counter()
    ds = make_synthetic(d=D8, ntrain=NTRAIN, nbase=N8, nquery=NQ, corr=True,
                        seed=seed, name="synthetic-corr-960", device=DEV)
    print(f"  data + exact ground truth: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with chainq_operands() as vit:
        model = rq.train(ds.Xt, method="sr_d", m=7, h=256, niter=10,
                         seed=seed, device=DEV)
    torch.cuda.synchronize()
    print(f"  train (OPQ -> ChainQ -> SR-D): {time.perf_counter() - t0:.1f} s")
    Xb = torch.as_tensor(ds.Xb, device=DEV)
    Xq = torch.as_tensor(ds.Xq, device=DEV)
    gt = ds.gt
    del ds
    out = {"model": model, "Xq": Xq, "gt": gt, "vit": vit["ops"],
           "Xb": Xb[:NENC].clone()}
    for name, mode in (("index", "decoded"), ("codes", "codes")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = rq.index_base(model, Xb, mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"  index_base(mode={mode!r}): {wall:.1f} s, "
              f"{N8 / wall:,.0f} base vectors/s")
    del Xb
    index = out["index"]
    check(index.scan_index.Xd.shape == (N8, D8)
          and index.scan_index.Xd.dtype == torch.bfloat16,
          "phase 8's decoded index is not the bf16 one")
    check(torch.equal(index.codes, out["codes"].codes),
          "the two base encodes of phase 8 differ")
    nt = index.norms_codebook[index.norm_codes.long()]
    si = tsp.build_index(model.codebooks, index.codes, d=D8, norm_term=nt,
                         dtype=torch.float32)
    out["f32"] = rq.MCQIndex(model, index.codes, si, index.norms_codebook,
                             index.norm_codes, mode="decoded")
    print(f"  decoded base bf16 {nbytes(index.scan_index.Xd) / 1e9:.2f} GB, "
          f"f32 {nbytes(si.Xd) / 1e9:.2f} GB, codes "
          f"{nbytes(out['codes'].scan_index.packed) / 1e6:.0f} MB")
    res, recall = {}, {}
    for k in (100, 1000):
        for name, which, kw in SCANS8:
            idx = out[which]
            dists, ids = rq.search(idx, Xq, k=k, **kw)
            torch.cuda.synchronize()
            check_search(dists, ids, k, N8)
            curve = eval_recall(ids, gt, verbose=False)
            walls = warm_walls(lambda: rq.search(idx, Xq, k=k, **kw))
            print(f"  {name} k={k}: recall@1 {curve[0]:.4f} @10 "
                  f"{curve[9]:.4f} @100 {curve[99]:.4f}; search "
                  f"{NQ / float(np.median(walls)):,.0f} queries/s (median "
                  f"of {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms)")
            res[(name, k)] = (dists, ids)
            recall[(name, k)] = float(curve[0])
    out["res"], out["recall"] = res, recall
    return out


def phase8_checks(errs, p8):
    """After phase 8's launch counts were read: recall of decode mode
    against the decoded index; one-pass against two-pass on every query;
    each search on the first `NSUB` queries against the exact scan of its
    own scores; and every scan kernel against its plain version on those
    queries over the whole base."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import eval_recall

    print(f"== phase 8 results: recall, one-pass against two-pass, the "
          f"first {NSUB} queries against the exact scans and the plain "
          f"versions")
    res, rec, Xq = p8["res"], p8["recall"], p8["Xq"]
    sc, si, sf = (p8["codes"].scan_index, p8["index"].scan_index,
                  p8["f32"].scan_index)
    dt = si.Xd.dtype            # the operands' type (bf16 on the card)
    Cf, nrm = sc.decode_operands(D8, dt)
    m = sc.mprime - 1
    # decode mode reads the norm term from the norms table at the operand
    # type (bf16 on the card, as the JAX package does), the decoded index
    # in f32: the decoded index with its norm terms rounded the same way
    # scores what decode mode scores
    index, model = p8["index"], p8["model"]
    nt = index.norms_codebook[index.norm_codes.long()]
    sb = tsp.build_index(model.codebooks, index.codes, d=D8,
                         norm_term=nt.to(si.Xd.dtype).float())
    same_norms = rq.MCQIndex(model, index.codes, sb, index.norms_codebook,
                             index.norm_codes, mode="decoded")
    for k in (100, 1000):
        dm, dec = rec[("decode mode", k)], rec[("decoded", k)]
        rb = float(eval_recall(rq.search(same_norms, Xq, k=k)[1], p8["gt"],
                               verbose=False)[0])
        print(f"  k={k}: recall@1 decode mode {dm:.4f}, decoded index "
              f"{dec:.4f} (gap {dec - dm:+.4f}); the decoded index with its "
              f"norm terms at the operand type, as decode mode reads them, "
              f"{rb:.4f} (gap {rb - dm:+.4f})")
        check(abs(rb - dm) <= 0.01, f"k={k}: decode mode and the decoded "
              f"index of the same scores lie {abs(rb - dm):.4f} apart")
    del same_norms, sb
    oracle_by_k = {}
    for k in (100, 1000):
        one, two = res[("one-pass", k)], res[("decode mode", k)]
        r, keep, tile = tsc._onepass_config(k, sc.mprime)
        fl1 = tsc.scan_codes_decode_topk(Xq, Cf, nrm, sc.packed, k=k,
                                         pq=False, r=r, keep=keep,
                                         tile=tile)[2]
        r2, keep2, tile2 = tsc._codes_config(k)[1:]
        fl2 = tsc.scan_codes_decode_topk_2p(Xq, Cf, nrm, sc.packed, k=k,
                                            pq=False, r=r2, keep=keep2,
                                            tile=tile2)[2]
        if k == 100:
            p8["flagged"] = fl2     # decode mode's rescue batch at k = 100
        either = torch.nonzero(fl1 | fl2).flatten()
        oracle = torch.zeros_like(fl1)
        if either.numel():
            oracle[either] = tsc.scan_codes_decode_topk(
                Xq[either], Cf, nrm, sc.packed, k=k, pq=False)[2]
        same = (one[0] == two[0]).all(1) & (one[1] == two[1]).all(1)
        bad = int((~same & ~oracle).sum())
        print(f"  one-pass k={k}: flagged {int(fl1.sum())}, two-pass "
              f"{int(fl2.sum())} of {NQ}; {int(oracle.sum())} reach the LUT "
              f"oracle; identical to the two-pass result: "
              f"{int(same.sum())} of {NQ} queries")
        check(bad == 0, f"one-pass k={k}: {bad} queries differ from the "
              "two-pass search outside the LUT oracle's")
        oracle_by_k[k] = oracle[:NSUB]
    Q = Xq[:NSUB].contiguous()
    q2 = (Q * Q).sum(-1, keepdim=True)
    # each scan's own scores: -2Q at the operand dtype against its rows
    Qm = tsp._query_operand(Q, D8, dt)
    Qc = tsp._query_operand(Q, Cf.shape[1], dt)
    Qf = tsp._query_operand(Q, D8, torch.float32)
    Xc, x2c = tsc._decode_x2(Cf, nrm, sc.packed, m, True)
    own = {"decoded": (Qm, si.Xd, si.x2), "decode mode": (Qc, Xc, x2c),
           "one-pass": (Qc, Xc, x2c), "decoded pack=False": (Qf, sf.Xd,
                                                              sf.x2)}
    # a query the decoded scan flags re-runs through `exact_rescan`, with
    # its query in f32
    rescued = (Qf, si.Xd, si.x2)
    best = {name: exact64(*ops, 1000) for name, ops in own.items()
            if name != "one-pass"}
    best["one-pass"] = best["decode mode"]
    best_rescued = exact64(*rescued, 1000)
    every = torch.ones(NSUB, dtype=torch.bool, device=Q.device)
    for k in (100, 1000):
        r, keep, tile = tsp._scan_config(k)
        idb = tsp._pack_idbits(-(-N8 // tile) * tile)
        fl = tsp.scan_topk_packed(Q, si.Xd, si.x2, k=k, r=r, tile=tile,
                                  keep=keep)[2]
        for name, ops in own.items():
            d, i = res[(name, k)]
            if name == "one-pass":
                t1 = tsc._onepass_config(k, sc.mprime)[2]
                step = 2.0 ** (tsp._pack_idbits(-(-N8 // t1) * t1) - 23)
            else:
                step = 1e-5 if "pack=False" in name else 2.0 ** (idb - 23)
            if name == "decoded":
                parts = (("", ~fl, ops, best[name]),
                         (", flagged: exact_rescan", fl, rescued,
                          best_rescued))
            elif name in ("decode mode", "one-pass"):
                # a query K4 flags again took the LUT oracle's scores
                parts = (("", ~oracle_by_k[k], ops, best[name]),)
            else:
                parts = (("", every, ops, best[name]),)
            for tag, sel, (Qx, X, x2), b in parts:
                if bool(sel.any()):
                    check_topk(f"{name} k={k}{tag}", (d[:NSUB][sel],
                                                      i[:NSUB][sel]),
                               q2[sel], Qx[sel], X, x2, b[sel][:, :k], step)
        # LUT mode: the oracle sums the batch's own bf16 tables in the
        # kernel's order, so an unflagged query's truncated scores are
        # identical by position and its ids the same within equal scores
        T = tsc.build_luts(sc.C, Xq, norms_cbook=sc.norms_cbook)
        fl = tsc.scan_codes_topk(T, sc.packed, k=k, r=tsp._scan_config(k)[0],
                                 tile=tsp._scan_config(k)[2],
                                 keep=tsp._scan_config(k)[1],
                                 lut_dtype=dt)[2][:NSUB]
        so, io = tsc.lut_scan(T[:, :, :NSUB], tsc.unpack_codes(
            sc.packed, sc.mprime), k, lut_dtype=dt)
        del T
        d, i = res[("lut", k)]
        ok = ~fl
        want = truncated(so, idb) + q2
        same_d = bool(torch.equal(d[:NSUB][ok], want[ok]))
        bad = 0
        for q in torch.nonzero(ok).flatten().tolist():
            dv, gi, ri = want[q], i[q], io[q]
            inner = dv != dv[-1]
            bad += set(gi[inner].tolist()) != set(ri[inner].tolist())
        print(f"  lut k={k} vs the LUT oracle on the batch's tables "
              f"({int(ok.sum())} unflagged of {NSUB}): truncated scores "
              f"identical by position {same_d}, ids equal within equal "
              f"scores on all but {bad}")
        check(same_d and bad == 0, f"lut k={k} != the LUT oracle's top-k")
        del so, io
    wide_kernels_vs_plain(errs, p8, Q, (Xc, x2c))
    del Xc, x2c
    torch.cuda.empty_cache()


def wide_kernels_vs_plain(errs, p8, Q, dec):
    """Each scan kernel of phase 8 against its plain version on phase 8's
    operands, ``Q`` over the whole base, by the d = 960 rules of
    `compare_topk` and `check_f32_kernels` (``dec``: decode mode's rows
    and norms, `scan_codes._decode_x2`, for the scores of its ids)."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    sc, si, sf = (p8["codes"].scan_index, p8["index"].scan_index,
                  p8["f32"].scan_index)
    dt = si.Xd.dtype
    Cf, nrm = sc.decode_operands(D8, dt)
    Qm = tsp._query_operand(Q, D8, dt)
    Qc = tsp._query_operand(Q, Cf.shape[1], dt)
    Qf = tsp._query_operand(Q, D8, torch.float32)
    args = (Qc, Cf, nrm, sc.packed)
    own = {"scan_candidates": row_scores(Qm, si.Xd, si.x2),
           "codes_decode_candidates": row_scores(Qc, *dec)}
    for k in (100, 1000):
        r, keep, tile = tsp._scan_config(k)
        idb = tsp._pack_idbits(-(-N8 // tile) * tile)
        kw = dict(tile=tile, keep=keep, idbits=idb)
        for name, fn, plain, a in (
                ("scan_candidates", tsp.scan_candidates,
                 tsp.scan_candidates_plain, (Qm, si.Xd, si.x2)),
                ("codes_decode_candidates", tsc.codes_decode_candidates,
                 tsc.codes_decode_candidates_plain, args)):
            extra = dict(premin=0) if name == "scan_candidates" else \
                dict(has_norms=True)
            got = tsp.cand_merge(*fn(*a, **kw, **extra), r)
            ref = tsp.cand_merge_plain(*plain(*a, **kw, **extra), r)
            note(errs, name, compare_topk(
                f"{name} d={D8} k={k} (+K2+K3) vs plain",
                plain_topk(got, r, k, idb), plain_topk(ref, r, k, idb), idb,
                False, own[name]))
            if name == "codes_decode_candidates":
                k4_keys_equal_k1s(args, True, got, keep, idb,
                                  f"d={D8} k={k} plan", nq=32)
        r1, keep1, tile1 = tsc._onepass_config(k, sc.mprime)
        idb1 = tsp._pack_idbits(-(-N8 // tile1) * tile1)
        kw1 = dict(tile=tile1, r=r1, keep=keep1, idbits=idb1, has_norms=True)
        note(errs, "codes_decode_onepass", compare_topk(
            f"codes_decode_onepass d={D8} k={k} (r={r1}, keep={keep1}, "
            f"tile={tile1}) vs plain",
            plain_topk(tsc.codes_decode_onepass(*args, **kw1), r1, k, idb1),
            plain_topk(tsc.codes_decode_onepass_plain(*args, **kw1), r1, k,
                       idb1), idb1, False, own["codes_decode_candidates"]))
        T = tsc.build_luts(sc.C, Q, norms_cbook=sc.norms_cbook)
        Tb = T.to(dt).contiguous()
        got = tsc.codes_lut_candidates(Tb, sc.packed, **kw)
        ref = tsc.codes_lut_candidates_plain(Tb, sc.packed, **kw)
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"codes_lut_candidates d={D8} k={k}: kernel != plain")
        note(errs, "codes_lut_candidates", int_err((got[0], ref[0]),
                                                   (got[1], ref[1])))
        print(f"  codes_lut_candidates d={D8} k={k} vs plain: identical")
        rf, kf, tf, _ = tsp._f32_config(k, DEV)
        kernel, plain = decoded_f32_fns(Qf, sf.Xd, sf.x2, tf, kf)
        check_f32_kernels(f"K9/K10 d={D8} f32 index k={k} vs plain", kernel,
                          plain, k, rf, kf, False, errs,
                          ("scan_f32_candidates", "verify_counts"),
                          row_scores(Qf, sf.Xd, sf.x2))
    r4 = tsc._RESCUE_R
    idb4 = tsp._pack_idbits(-(-N8 // tsc._RESCUE_TILE) * tsc._RESCUE_TILE)
    kw4 = dict(tile=tsc._RESCUE_TILE, r=r4, idbits=idb4)
    Q8 = Qc[:8].contiguous()
    note(errs, "codes_decode_topk", compare_topk(
        f"codes_decode_topk d={D8} 8 queries (the rescue) vs plain",
        plain_topk(tsc.codes_decode_topk(Q8, *args[1:], has_norms=True,
                                         **kw4), r4, 1000, idb4),
        plain_topk(tsc.codes_decode_topk_plain(Q8, *args[1:],
                                               has_norms=True, **kw4),
                   r4, 1000, idb4), idb4, False,
        own["codes_decode_candidates"]))
    Qm8 = Qm[:32].contiguous()
    note(errs, "scan_onepass", compare_topk(
        f"scan_onepass d={D8} 32 queries (keep=0) vs plain",
        plain_topk(tsp.scan_onepass(Qm8, si.Xd, si.x2, premin=0, **kw4), r4,
                   1000, idb4),
        plain_topk(tsp.scan_onepass_plain(Qm8, si.Xd, si.x2, premin=0,
                                          **kw4), r4, 1000, idb4),
        idb4, False, own["scan_candidates"]))
    torch.cuda.empty_cache()


def wide_times(p8):
    """The scan kernels at d = 960 over phase 8's base at the main path's
    batch (nq = 1e4, the k = 1000 plan), CUDA events, beside their bound
    and the library's `addmm` + `topk` → ``{name: record}``."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    k = 1000
    print(f"== scan kernel times at d={D8} (ms; CUDA events), SR-D-7+1, "
          f"n={N8}, nq={NQ}, k={k} plan")
    sc, si, sf = (p8["codes"].scan_index, p8["index"].scan_index,
                  p8["f32"].scan_index)
    Q, dt = p8["Xq"], si.Xd.dtype
    Cf, nrm = sc.decode_operands(D8, dt)
    Qm = tsp._query_operand(Q, D8, dt)
    Qc = tsp._query_operand(Q, Cf.shape[1], dt)
    XfT = sf.Xd.T.contiguous()
    lib_ms, _ = timed(lambda: library_scan(Qm.float(), XfT, sf.x2, k), 1)
    del XfT
    torch.cuda.empty_cache()
    r, keep, tile = tsp._scan_config(k)
    idb = tsp._pack_idbits(-(-N8 // tile) * tile)
    kw = dict(tile=tile, keep=keep, idbits=idb)
    t = {}
    flop = 2.0 * N8 * NQ * D8
    ms, out = timed(lambda: tsp.scan_candidates(Qm, si.Xd, si.x2, premin=0,
                                                **kw), 2)
    record(t, "scan_candidates", ms, None, flop, "bf16 tensor-core",
           nbytes(Qm, si.Xd, si.x2, *out), lib_ms)
    del out
    args = (Qc, Cf, nrm, sc.packed)
    ms, out = timed(lambda: tsc.codes_decode_candidates(
        *args, has_norms=True, **kw), 2)
    record(t, "codes_decode_candidates", ms, None, flop, "bf16 tensor-core",
           nbytes(*args, *out), lib_ms)
    del out
    r1, keep1, tile1 = tsc._onepass_config(k, sc.mprime)
    kw1 = dict(tile=tile1, r=r1, keep=keep1, has_norms=True,
               idbits=tsp._pack_idbits(-(-N8 // tile1) * tile1))
    ms, out = timed(lambda: tsc.codes_decode_onepass(*args, **kw1), 2)
    record(t, "codes_decode_onepass", ms, None, flop, "bf16 tensor-core",
           nbytes(*args, out), lib_ms)
    del out
    rf, kf, tf, _ = tsp._f32_config(k, DEV)
    Qf = tsp._query_operand(Q, D8, torch.float32)
    ms, (cv, ci) = timed(lambda: tsp.scan_f32_candidates(
        Qf, sf.Xd, sf.x2, tile=tf, keep=kf), 2)
    record(t, "scan_f32_candidates", ms, None, flop, "f32 CUDA-core",
           nbytes(Qf, sf.Xd, sf.x2, cv, ci), lib_ms)
    ov, oi = tsp.pair_merge(cv, ci, rf)
    _, tau = finish_f32(ov, oi, lambda ts, ti: tsp.verify_counts(
        Qf, sf.Xd, sf.x2, ts, ti, tile=tf), k, rf, kf)
    del cv, ci, ov, oi
    ms, cnt = timed(lambda: tsp.verify_counts(Qf, sf.Xd, sf.x2, *tau,
                                              tile=tf), 2)
    record(t, "verify_counts", ms, None, flop, "f32 CUDA-core",
           nbytes(Qf, sf.Xd, sf.x2, *tau, cnt))
    torch.cuda.empty_cache()
    return t


def rescue8(errs, p8):
    """K4 on phase 8's own rescue batch (the queries decode mode's
    two-pass scan flags at k = 100), timed beside its plain version, its
    bound and the library's call and held against the plain version by
    the d = 960 rule; then decode mode's k = 100 search profiled by
    kernel, with the rescue's kernels apart → ``{name: record}``."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    sc, sf = p8["codes"].scan_index, p8["f32"].scan_index
    Xq, fl = p8["Xq"], p8["flagged"]
    dt = p8["index"].scan_index.Xd.dtype
    Cf, nrm = sc.decode_operands(D8, dt)
    Qf = Xq[fl].contiguous()
    nf = Qf.shape[0]
    print(f"== phase 8's rescue: K4 on the {nf} queries decode mode flags "
          f"at k=100 (d={D8}, n={N8}, r=48, tile 2048; CUDA events)")
    t = {}
    if nf:
        Qc = tsp._query_operand(Qf, Cf.shape[1], dt)
        r4, tile4 = tsc._RESCUE_R, tsc._RESCUE_TILE
        idb4 = tsp._pack_idbits(-(-N8 // tile4) * tile4)
        kw4 = dict(tile=tile4, r=r4, idbits=idb4, has_norms=True)
        args = (Qc, Cf, nrm, sc.packed)
        lay = tsc._rescue_layout(Cf.shape[1], sc.packed.shape[1], r4,
                                 int(dt == torch.bfloat16), Qc.device)
        print(f"  layout (queries, lanes per CTA, CTAs per SM, d-block, "
              f"shared bytes): {lay}")
        XfT = sf.Xd.T.contiguous()
        lib_ms, _ = timed(lambda: library_scan(
            tsp._query_operand(Qf, D8, torch.float32), XfT, sf.x2, 1000), 1)
        del XfT
        torch.cuda.empty_cache()
        ms, o4 = timed(lambda: tsc.codes_decode_topk(*args, **kw4), 2)
        pms, o40 = timed(lambda: tsc.codes_decode_topk_plain(*args, **kw4),
                         1, warm=False)
        Xc, x2c = tsc._decode_x2(Cf, nrm, sc.packed, sc.mprime - 1, True)
        note(errs, "codes_decode_topk", compare_topk(
            f"codes_decode_topk d={D8} on the {nf} flagged queries vs plain",
            plain_topk(o4, r4, 100, idb4), plain_topk(o40, r4, 100, idb4),
            idb4, False, row_scores(Qc, Xc, x2c)))
        del Xc, x2c, o4, o40
        record(t, f"codes_decode_topk d={D8} flagged nq={nf}", ms, pms,
               2.0 * N8 * nf * D8, "bf16 tensor-core",
               nbytes(*args) + 49 * 128 * nf * 4, lib_ms)
    torch.cuda.empty_cache()
    print("  decode mode k=100, device time by kernel")
    k4 = tsc.codes_decode_topk.launches
    wall, rows = profile(lambda: rq.search(p8["codes"], Xq, k=100), top=12)
    busy = sum(ms for _, ms in rows)
    k4ms = sum(ms for name, ms in rows if "scan_topk_kernel" in name)
    # K2 at r = 48 merges K4's splits (the profiler's names may be
    # mangled or not)
    k2ms = sum(ms for name, ms in rows
               if re.search(r"cand_merge_kernel(ILi48E|<48>)", name))
    print(f"  the rescue's K4 {k4ms:.2f} ms ({tsc.codes_decode_topk.launches - k4}"
          f" launch(es)) + its K2<48> {k2ms:.2f} ms: "
          f"{(k4ms + k2ms) / max(busy, 1e-9):.3f} of the device busy time, "
          f"{(k4ms + k2ms) / wall:.3f} of the wall")
    # K1: the tensor-core body at R = 0 on bf16, the fmaf body on f32
    k1ms = sum(ms for name, ms in rows if re.search(
        r"codes_mma_kernel(<\d+, 0,|ILi\d+ELi0E)|scan_candidates_kernel",
        name))
    if k1ms:
        print(f"  K1 {k1ms:.2f} ms: {k1ms / max(busy, 1e-9):.3f} of the "
              f"device busy time, {k1ms / wall:.3f} of the wall")
    else:
        print("  (the profiler holds no record of the scan kernel K1)")
    # the search without its rescue: the two-pass scan and its flags
    r2, keep2, tile2 = tsc._codes_config(100)[1:]
    scan_ms, _ = timed(lambda: tsc.scan_codes_decode_topk_2p(
        Xq, Cf, nrm, sc.packed, k=100, pq=False, r=r2, keep=keep2,
        tile=tile2), 1)
    print(f"  the two-pass scan alone (K1 -> K2 -> K3 and the flags; CUDA "
          f"events): {scan_ms:.2f} ms")
    return t


def phase9(seed, card, ds, Xq):
    """128 bits on phase 3's data: SR-D-15+1 (m' = 16) through the LUT
    searches with bf16 and f32 tables, the exact-float LUT search and
    decode mode, then PQ-16 through the f32-table LUT search; the default
    calls only."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search.linscan import eval_recall

    print(f"== phase 9: 128 bits, synthetic-corr d={D}, {NTRAIN} train, {N} "
          f"base, {NQ} queries: SR-D m=15+1 and PQ-16, h=256, niter=10 "
          f"({card})")
    out, recall = {}, {}
    f32 = {"op_dtype": torch.float32}
    for method, m, calls in (
            ("sr_d", 15, (("lut bf16 tables", {"mode": "lut"}),
                          ("lut f32 tables", {"mode": "lut", **f32}),
                          ("lut pack=False", {"mode": "lut", "pack": False,
                                              **f32}),
                          ("decode mode", {}))),
            ("pq", 16, (("lut f32 tables", {"mode": "lut", **f32}),))):
        t0 = time.perf_counter()
        with chainq_operands() as vit:
            model = rq.train(ds.Xt, method=method, m=m, h=256, niter=10,
                             seed=seed, device=DEV)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        index = rq.index_base(model, ds.Xb, mode="codes")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(index.scan_index.mprime == 16, f"{method}: m' != 16")
        print(f"  {method} m={m}: train {t1 - t0:.1f} s, index_base "
              f"{t2 - t1:.1f} s ({N / (t2 - t1):,.0f} base vectors/s), "
              f"m'={index.scan_index.mprime}")
        out[method] = index
        if method == "sr_d":
            out["vit"] = vit["ops"]
            out["Xb"] = torch.as_tensor(ds.Xb[:NENC], device=DEV).clone()
        for name, kw in calls:
            for k in (100, 1000):
                dists, ids = rq.search(index, Xq, k=k, **kw)
                torch.cuda.synchronize()
                check_search(dists, ids, k)
                curve = eval_recall(ids, ds.gt, verbose=False)
                walls = warm_walls(lambda: rq.search(index, Xq, k=k, **kw))
                print(f"  {method} {name} k={k}: recall@1 {curve[0]:.4f} "
                      f"@10 {curve[9]:.4f} @100 {curve[99]:.4f}; search "
                      f"{NQ / float(np.median(walls)):,.0f} queries/s "
                      f"(median of "
                      f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms)")
                recall[(method, name, k)] = float(curve[0])
    for (method, name, k), r1 in recall.items():
        floor = 0.99 if method == "sr_d" else 0.75
        check(r1 >= floor, f"phase 9 {method} {name} k={k}: recall@1 "
              f"{r1:.4f} < {floor}")
    print(f"  recall@1 gates met: SR-D-15+1 >= 0.99 through each scan, PQ-16 "
          f">= 0.75 (JAX package, BASELINE.md:56: SR-D 1.000, PQ .823)")
    return out


def phase9_checks(errs, p9, Xq):
    """After phase 9's launch counts were read: the LUT kernels at
    m' = 16 against their plain versions on phase 9's tables (bf16: 16
    queries a CTA; f32: 8) and K1 (+K2+K3) and K4 at m = 15 on its
    operands, the first `NSUB` queries over the whole base; then their
    times and K1's at m = 15 on the whole batch beside their bounds →
    ``{name: record}``."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    sc = p9["sr_d"].scan_index
    print(f"== phase 9 kernels at m'={sc.mprime} against their plain "
          f"versions ({NSUB} queries) and their times (nq={NQ}, CUDA "
          f"events)")
    for dt in (torch.bfloat16, torch.float32):
        bf16 = int(dt == torch.bfloat16)
        qb, smem = tsc._lut_layout(sc.mprime, 256, bf16, Xq.device)
        qx, threads, smem_x = tsc._lut_exact_layout(sc.mprime, 256, bf16)
        print(f"  LUT kernels with {dt} tables: K5 {qb} queries a CTA, "
              f"{smem} bytes of shared memory; K6/K7 {qx} queries and "
              f"{threads} threads a CTA, {smem_x} bytes")
    T = tsc.build_luts(sc.C, Xq, norms_cbook=sc.norms_cbook)
    t = {}
    for k in (100, 1000):
        r, keep, tile = tsp._scan_config(k)
        idb = tsp._pack_idbits(-(-N // tile) * tile)
        kw = dict(tile=tile, keep=keep, idbits=idb)
        for dt in (torch.bfloat16, torch.float32):
            Ts = T[:, :, :NSUB].to(dt).contiguous()
            got = tsc.codes_lut_candidates(Ts, sc.packed, **kw)
            ref = tsc.codes_lut_candidates_plain(Ts, sc.packed, **kw)
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"K5 m'=16 {dt} k={k}: kernel != plain")
            note(errs, "codes_lut_candidates", int_err((got[0], ref[0]),
                                                       (got[1], ref[1])))
        rf, kf, tf, _ = tsp._f32_config(k, DEV)
        kernel, plain = lut_f32_fns(T[:, :, :NSUB].contiguous(), sc.packed,
                                    tf, kf)
        check_f32_kernels(f"K6/K7 m'=16 f32 tables k={k}", kernel, plain, k,
                          rf, kf, True, errs,
                          ("codes_lut_f32_candidates", "codes_verify_counts"))
        print(f"  K5 m'=16 k={k}: identical with bf16 and f32 tables")
    Cf, nrm = sc.decode_operands(D, torch.bfloat16)
    Qs = tsp._query_operand(Xq[:NSUB], Cf.shape[1], torch.bfloat16)
    args = (Cf, nrm, sc.packed)
    for k in (100, 1000):
        r, keep, tile = tsp._scan_config(k)
        idb = tsp._pack_idbits(-(-N // tile) * tile)
        kw = dict(tile=tile, keep=keep, idbits=idb, has_norms=True)
        got = tsp.cand_merge(*tsc.codes_decode_candidates(Qs, *args, **kw), r)
        ref = tsp.cand_merge_plain(*tsc.codes_decode_candidates_plain(
            Qs, *args, **kw), r)
        note(errs, "codes_decode_candidates", compare_topk(
            f"K1 m=15 k={k} (+K2+K3) vs plain", plain_topk(got, r, k, idb),
            plain_topk(ref, r, k, idb), idb, exact=False))
    r4 = tsc._RESCUE_R
    kw4 = dict(tile=tsc._RESCUE_TILE, r=r4, has_norms=True,
               idbits=tsp._pack_idbits(-(-N // tsc._RESCUE_TILE)
                                       * tsc._RESCUE_TILE))
    Q8 = Qs[:8].contiguous()
    note(errs, "codes_decode_topk", compare_topk(
        "K4 m=15 8 queries (the rescue) vs plain",
        plain_topk(tsc.codes_decode_topk(Q8, *args, **kw4), r4, 1000,
                   kw4["idbits"]),
        plain_topk(tsc.codes_decode_topk_plain(Q8, *args, **kw4), r4, 1000,
                   kw4["idbits"]), kw4["idbits"], exact=False))
    del got, ref, Qs, Q8
    k = 1000
    r, keep, tile = tsp._scan_config(k)
    kw = dict(tile=tile, keep=keep,
              idbits=tsp._pack_idbits(-(-N // tile) * tile))
    adds = 1.0 * N * NQ * sc.mprime
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        Tq = T.to(dt).contiguous()
        ms, out = timed(lambda: tsc.codes_lut_candidates(Tq, sc.packed, **kw),
                        2)
        record(t, f"codes_lut_candidates {name} tables m'=16", ms, None, adds,
               "f32 CUDA-core", nbytes(Tq, sc.packed, *out))
        del out, Tq
    rf, kf, tf, _ = tsp._f32_config(k, DEV)
    kernel, _ = lut_f32_fns(T.contiguous(), sc.packed, tf, kf)
    ms, (cv, ci) = timed(kernel[0], 2)
    record(t, "codes_lut_f32_candidates f32 tables m'=16", ms, None, adds,
           "f32 CUDA-core", nbytes(T, sc.packed, cv, ci))
    _, tau = finish_f32(*tsp.pair_merge(cv, ci, rf), kernel[2], k, rf, kf)
    del cv, ci
    ms, cnt = timed(lambda: kernel[2](*tau), 2)
    record(t, "codes_verify_counts f32 tables m'=16", ms, None, adds,
           "f32 CUDA-core", nbytes(T, sc.packed, *tau, cnt))
    del T
    Qm = tsp._query_operand(Xq, Cf.shape[1], torch.bfloat16)
    codes = tsc.unpack_codes(sc.packed, sc.mprime)
    Xf, x2 = tsp.decode_base(sc.C, codes[:, :-1],
                             norm_term=sc.norms_cbook[codes[:, -1].long()])
    XfT = Xf.T.contiguous()
    del Xf, codes
    lib_ms, _ = timed(lambda: library_scan(Qm.float(), XfT, x2, k), 1)
    del XfT
    args = (Qm, *args)
    ms, out = timed(lambda: tsc.codes_decode_candidates(
        *args, has_norms=True, **kw), 2)
    record(t, "codes_decode_candidates m=15", ms, None, 2.0 * N * NQ * D,
           "bf16 tensor-core", nbytes(*args, *out), lib_ms)
    del out
    torch.cuda.empty_cache()
    return t


def probes(errs):
    """The counterparts of the JAX package's two probes, at its sizes:
    `rayuela_tpu_torch.demos.fusion_probe` and `.profile_scan_tail`."""
    from rayuela_tpu_torch.demos import fusion_probe, profile_scan_tail

    print("== probe: python -m rayuela_tpu_torch.demos.fusion_probe")
    fus = fusion_probe.main([])
    check(fus["equal"], "the fusion kernel != its plain version")
    note(errs, "fusion_chain", 0.0)
    print("== probe: python -m rayuela_tpu_torch.demos.profile_scan_tail")
    tail = profile_scan_tail.main([])
    for k in (1000, 100):
        check(tail[k]["ids_equal"] >= 0.999 and tail[k]["within_step"],
              f"scan-tail probe k={k}: K8 disagrees with its plain version")
    check(tail["launches"] > 0, "the scan-tail probe never launched K8")
    return fus, tail


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's ``-Xptxas=-v`` output:
    its (mangled) name, registers and spills."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split(" for ", 1)[1].strip()
            # drop the anonymous namespace's prefix: the kernel's name and
            # its template arguments (e.g. ...Li28ELi4E: R=28, KEEP=4) stay
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "",
                          name)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name[:96]}: {regs}; {spill}")
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

    from rayuela_tpu_torch.demos import fusion_probe
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
    t_start = t0 = time.perf_counter()
    _, log = build.build()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary(log):
        print("  " + line)
    for dp in (D, 1024):
        cuda = torch.device(DEV)
        print(f"  layouts at dp={dp}, bf16, 2 packed words a row (queries "
              f"per CTA, scratch ints per CTA, CTAs per SM, d-block, shared "
              f"bytes, CTAs per cluster, clusters the card holds, step "
              f"buffers): K1 keep=4 {tsc._candidates_layout(4, dp, 2, 1, cuda)}"
              f", K14 (28, 4) {tsc._onepass_layout(28, 4, dp, 2, 1, cuda)}; "
              f"K4 (queries, lanes per CTA, CTAs per SM, d-block, shared "
              f"bytes) {tsc._rescue_layout(dp, 2, 48, 1, cuda)}")

    rng = np.random.default_rng(args.seed)
    search_wrappers = {
        "codes_decode_candidates": tsc.codes_decode_candidates,
        "cand_merge": tsc.cand_merge, "tail_merge": tsp.tail_merge,
        "codes_decode_topk": tsc.codes_decode_topk}
    path4 = dict(search_wrappers, icm_sweeps=ticm.icm_sweeps,
                 viterbi_encode=tvit.viterbi_encode)
    path5 = {"scan_candidates": tsp.scan_candidates,
             "codes_lut_candidates": tsc.codes_lut_candidates,
             "cand_merge": tsp.cand_merge, "tail_merge": tsp.tail_merge}
    path5b = {"scan_onepass": tsp.scan_onepass,
              "cand_merge": tsp.cand_merge, "tail_merge": tsp.tail_merge}
    path7 = {"encoding_ils": ticm.encoding_ils,
             "codes_decode_onepass": tsc.codes_decode_onepass,
             "tail_merge": tsp.tail_merge}
    path6 = {"scan_f32_candidates": tsp.scan_f32_candidates,
             "pair_merge": tsp.pair_merge,
             "verify_counts": tsp.verify_counts,
             "codes_lut_f32_candidates": tsc.codes_lut_f32_candidates,
             "codes_verify_counts": tsc.codes_verify_counts}
    path8 = {**path5, "scan_f32_candidates": tsp.scan_f32_candidates,
             "pair_merge": tsp.pair_merge,
             "verify_counts": tsp.verify_counts, "codes_decode_candidates":
             tsc.codes_decode_candidates, "codes_decode_onepass":
             tsc.codes_decode_onepass,
             "codes_decode_topk": tsc.codes_decode_topk,
             "icm_sweeps": ticm.icm_sweeps,
             "viterbi_encode": tvit.viterbi_encode}
    path9 = {"codes_lut_candidates": tsc.codes_lut_candidates,
             "codes_lut_f32_candidates": tsc.codes_lut_f32_candidates,
             "pair_merge": tsp.pair_merge,
             "codes_verify_counts": tsc.codes_verify_counts,
             "codes_decode_candidates": tsc.codes_decode_candidates,
             "cand_merge": tsp.cand_merge, "tail_merge": tsp.tail_merge,
             "icm_sweeps": ticm.icm_sweeps,
             "viterbi_encode": tvit.viterbi_encode}
    probe_path = {"fusion_chain": fusion_probe.fusion_chain,
                  "scan_candidates": tsp.scan_candidates}
    wrappers = {**path4, **path5, **path5b, **path6, **path7, **probe_path}
    errs = {}
    phase_t = {}

    def run(name, fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        phase_t[name] = time.perf_counter() - t
        print(f"-- {name}: {phase_t[name]:.1f} s")
        return r

    def zero():
        for w in wrappers.values():
            w.launches = 0

    try:
        run("phase 1", phase1, rng, errs)
        run("phase 1c", phase1c, rng, errs)
        run("phase 1d", phase1d, rng, errs)
        times = run("kernel times", kernel_times, rng, errs)
        run("phase 1b", phase1b, rng, errs)
        times.update(run("encode kernel times", encode_kernel_times, rng,
                         errs))
        run("phase 1e", phase1e, rng, errs)
        times.update(run("K14 and K12 times", onepass_ils_times, rng, errs))
        run("phase 2", phase2, rng)
        zero()
        served, Xq, ds = run("phase 3", phase3, args.seed, smi)
        launches = {n: w.launches for n, w in search_wrappers.items()}
        print(f"phase-3 launches: {launches}")
        check(all(launches.values()), "a kernel of the search path never "
              "launched in phase 3")
        zero()
        served["sr_d"], Xb, wall4 = run("phase 4", phase4, args.seed, smi,
                                        ds, Xq)
        launches4 = {n: w.launches for n, w in path4.items()}
        print(f"phase-4 launches: {launches4}")
        check(all(launches4.values()), "a kernel of the path never launched "
              "in phase 4")
        run("base encode check", base_encode_check, rng, errs,
            served["sr_d"].model, Xb)
        run("C5 check", c5_check, ds, Xq)
        zero()
        index5, res5 = run("phase 5", phase5, smi, ds, Xq, Xb,
                           served["sr_d"])
        launches5 = {n: w.launches for n, w in path5.items()}
        print(f"phase-5 launches: {launches5}")
        check(all(launches5.values()), "a kernel of the path never launched "
              "in phase 5")
        check(tsp.scan_onepass.launches == 0
              and tsc.codes_decode_candidates.launches == 0,
              "phase 5's counts hold launches of another path")
        zero()
        index6, res6, host = run("phase 6", phase6, smi, ds, Xq,
                                 served["sr_d"], index5)
        launches6 = {n: w.launches for n, w in path6.items()}
        print(f"phase-6 launches: {launches6}")
        check(all(launches6.values()), "a kernel of the path never launched "
              "in phase 6")
        packed6 = {n: w.launches for n, w in wrappers.items()
                   if n not in path6 and w.launches}
        check(not packed6, f"a pack=False call launched {packed6}")
        zero()
        index7, res7, cap7 = run("phase 7", phase7, smi, ds, Xq, Xb,
                                 served["sr_d"], wall4)
        launches7 = {n: w.launches for n, w in path7.items()}
        print(f"phase-7 launches: {launches7}")
        check(all(launches7.values()), "a kernel of the path never launched "
              "in phase 7")
        check(ticm.encoding_ils.launches == 1
              and ticm.icm_sweeps.launches == 0,
              "the whole-ILS encode was not one K12 launch")
        run("K12 base encode check", ils_base_check, errs,
            served["sr_d"].model, Xb, index7, cap7)
        del index7, cap7
        zero()
        p9 = run("phase 9", phase9, args.seed, smi, ds, Xq)
        launches9 = {n: w.launches for n, w in path9.items()}
        print(f"phase-9 launches: {launches9}")
        check(all(launches9.values()), "a kernel of the path never launched "
              "in phase 9")
        wide = run("phase 9 checks", phase9_checks, errs, p9, Xq)
        # K4 at the rescue's few queries stands beside its 128-query time
        wide.update({n: rec for n, rec in times.items() if " " in n})
        wide.update(run("phase 9 encode checks", encode_checks, rng, errs,
                        "m=15", p9["sr_d"].model, p9["Xb"], p9["vit"],
                        " m=15"))
        del p9, ds
        zero()
        run("phase 6 streamed decode", phase6_streamed_decode,
            served["sr_d"], Xq, host)
        print("phase-6 streamed decode-mode launches: "
              f"{ {n: w.launches for n, w in search_wrappers.items()} }")
        check(tsc.codes_decode_candidates.launches >= 4
              and tsp.cand_merge.launches >= 4,
              "the streamed search did not scan its 4 shards")
        del host
        zero()
        run("phase 5 one-pass", phase5_onepass, index5, Xq, res5)
        launches5b = {n: w.launches for n, w in path5b.items()}
        print(f"phase-5 one-pass launches: {launches5b}")
        check(all(launches5b.values()), "a kernel of the one-pass "
              "configuration never launched")
        run("phase 5 checks", phase5_checks, Xq, served["sr_d"], res5)
        del res5
        run("diagnostics", diagnostics, served, Xq)
        run("diagnostics 5", diagnostics5, index5, served["sr_d"], Xq)
        run("phase 6 checks", phase6_checks, Xq, served["sr_d"], index6, res6)
        del res6, index6
        run("phase 7 checks", phase7_checks, Xq, Xb, served["sr_d"], res7)
        del res7, Xb
        run("plan sweep", plan_sweep, index5, served["sr_d"], Xq)
        del index5, served, Xq
        torch.cuda.empty_cache()
        zero()
        p8 = run("phase 8", phase8, args.seed, smi)
        launches8 = {n: w.launches for n, w in path8.items()}
        print(f"phase-8 launches: {launches8}")
        check(all(launches8.values()), "a kernel of the path never launched "
              "in phase 8")
        run("phase 8 checks", phase8_checks, errs, p8)
        wide.update(run("phase 8 encode checks", encode_checks, rng, errs,
                        f"d={D8}", p8["model"], p8["Xb"], p8["vit"]))
        wide.update(run("d=960 kernel times", wide_times, p8))
        wide.update(run("phase 8 rescue", rescue8, errs, p8))
        del p8
        torch.cuda.empty_cache()
        zero()
        fus, _ = run("probes", probes, errs)
        launches_p = {n: w.launches for n, w in probe_path.items()}
        print(f"probe launches: {launches_p}")
        check(all(launches_p.values()), "a probe's kernel never launched")
        times["fusion_chain"] = {
            "ms": fus["ms"][("split", 0)], "plain_ms": fus["plain_ms"][0],
            "bound_ms": fus["bound_ms"], "bound_by": "bytes",
            "library_ms": fus["library_ms"]}
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s, the build included")
    # a kernel's launches are those of the latest main path that runs it;
    # the wide paths' own counts and times stand beside them
    on_path = {n: ("phase 7", launches7[n]) if n in ("encoding_ils",
                                                     "codes_decode_onepass")
               else ("probes", launches_p[n]) if n == "fusion_chain"
               else ("phase 6", launches6[n]) if n in launches6
               else ("phase 5", launches5[n]) if n in launches5
               else ("phase 5, explicit one-pass configuration",
                     launches5b[n]) if n in launches5b
               else ("phase 4", launches4[n]) for n in wrappers}
    wide_by = {}
    for label, rec in wide.items():
        wide_by.setdefault(label.split(" ")[0], {})[
            label if " " in label else f"{label} d={D8}"] = rec
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n],
         "replaces": REPLACES[n], "launches": on_path[n][1],
         "launches_in": on_path[n][0], "max_abs_err": errs[n], **times[n],
         "launches_wide": {"phase 8": launches8.get(n, 0),
                           "phase 9": launches9.get(n, 0)},
         "wide": wide_by.get(n, {})}
        for n in wrappers]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
