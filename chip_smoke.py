#!/usr/bin/env python3
"""Smoke run of `rayuela_tpu_torch` on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--phase13]

Builds the CUDA kernels from ``rayuela_tpu_torch/csrc`` and runs the
phases below; any failure exits non-zero. ``--phase13`` runs the build,
phases 3 and 4 (whose models and queries phase 13 serves) and phase 13
alone, and prints no kernel summary.

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
   library's call; each of those K2 merges of K4's splits (sorted runs
   of 48 keys whose certificates may lie below them, `cut=False`) must
   equal K2's plain version. K2 (`cand_merge`, with the per-tile cut's
   `cut=True`) must equal its plain version at the k = 100 and 1000
   plans and at the deepest plan (r = 96, keep = 4, tile = 2048) on one
   chunk of the search batch (`scan._query_chunks`: 3,216 queries) of
   K1's candidates, where it is timed beside its plain version and
   `torch.topk` along the candidates; its bound counts the bytes these
   inputs require (`merge_needs`). On bf16 operands K1, K14 and K4 score
   on the tensor cores with one score function: at each plan K4's first
   `keep` keys must equal those of K2's merge of K1's candidates on
   Gaussian data
   (128 queries; phase 8 the same at d = 960 on 32), the ground of the
   one-pass = two-pass gate of phases 7 and 8; on f32 operands (the
   cluster fmaf body) the same on Gaussian f32 data of both layouts at
   both plans, the ground of phase 4f's gate.
1c. K8 (`scan_candidates`, and `scan_onepass`, its keep=0 form) and K5
   (`codes_lut_candidates`) against their plain versions at n = 1e6,
   d = 128, nq = 1024: identical int32 outputs in f32 on small-integer
   data for every (r, keep, tile) the plan uses and keep=0 (and K2 on
   K8's candidates, with `cut=True` and without); in f32 and in bf16 on
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
   identical again. The LUT body's layout (K5-K7,
   `rq_lut_exact_layout`) must be its Python mirror's, and whether the
   library's sums (`embedding_bag`) equal the kernels' prints. Their
   times at nq = 1e4 stand with the other kernels' (f32 index and f32
   tables: the operands of phase 6).
1b. The encode kernels against their plain versions on the card, at
   n = 65,536, d = 128, h = 256, m = 7 and 8: K11 `icm_sweeps` at
   icmiter 0, 1 and 4 with a shuffled node order, K13 `viterbi_encode`
   (also at m = 15 and at d = 960, where its layout differs).
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
   (identical buffers; K2's merge of those splits equal to its plain
   version).
1f. The f32 instances of K1 and K14 (`codes_f32_kernel`, one body over
   clusters of 8 CTAs) against their plain versions on small-integer
   data at the main path's layout, at GIST's d = 960 (the queries
   reloaded a piece of 128 dimensions at a time) and at m = 15 + the
   norms byte at d = 128, n = 2e5, nq = 1124 (one whole cluster of 8 x
   128 queries, then a part of a query block), the k = 100 and 1000
   plans of each: identical int32 outputs.
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
4f. Phase 4's codes index searched on f32 operands through the facade,
   `api.search(..., op_dtype=torch.float32)`, two-pass (f32 K1 → K2 →
   K3) and `twopass=False` (f32 K14 → K3), at k = 100 and 1000, with
   recall@1 and queries/s, counts of their own. After the counts were
   read: recall@1 >= 0.99 through each; the one-pass result equal to the
   two-pass one on every query that did not reach the LUT oracle; on the
   first 256 queries each search against the exact scan of its own
   scores (the rows decoded in f32, -2q in f32: the plain version's), to
   one truncation step; each search's device time by kernel; then f32
   K1 and K14 timed at both plans beside their plain versions (at least
   99.9% of the keys equal: cuBLAS rounds the plain matmul apart from
   the fmaf chains), the library's scan and their bound.

5. The decoded-index and LUT-mode main path on phase 4's model:
   `api.index_base(model, Xb)` with the default mode (decoded, bf16) →
   `api.search(k=100)` and `(k=1000)` with recall and queries/s;
   `linscan_lsq` on the same codes must equal the facade's result;
   `api.search(index_codes, mode="lut")` at both k. After the launch
   counts of these calls were read, the results are held against phase
   4's decode-mode search and the LUT oracle on 64 queries; then an
   explicit one-pass configuration (keep=0) on 128 queries runs with
   counts of its own; then the plan sweep: flagged queries (beside the
   count a binomial model of the lanes and tiles expects) and time of
   the decoded and the LUT scan at k = 2048, 4096, 8192, 10240 and
   12288 for the buffer depths and tiles the plan chooses among, beside
   the exact scans; the deep band's class must flag at most 5% / 10% of
   the sweep's 2,500 queries at k = 10240 / 12288. Then the deep band
   (8192 < k <= 12288: K8 / K1 / K5 → K2 at r = 128 → K3 at cap =
   16384): `api.search` at k = 10240 and 12288 over those queries on the
   decoded index and the codes index in decode and LUT mode, the launch
   counts set to 0 just before each call and read just after (each
   form's candidates kernel, K2 and K3 must have launched), the exact
   scans wrapped to count the queries they serve, which must be the
   queries the certificate flags; each result against the exact scan of
   its kernels' own scores (the flagged queries against the exact scan
   that served them) by the packed-key contract, one truncation step;
   K2 at r = 128 and K3 at cap = 16384 bit-equal to their plain
   versions on the first query chunk of each search's operands, and
   timed at k = 12288 beside their plain versions, `torch.topk` and
   their bounds; the searches' walls beside those of `exact_rescan` and
   the LUT oracle, which served these k before.

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
   may launch in the ``pack=False`` calls. Then, with counts of its own,
   the default (packed) search over the same f32 index at k = 100 and
   1000 (f32 K8 → K2 → K3, `exact_rescan` for flagged queries) with
   recall@1 >= 0.99 and queries/s; after its counts were read, on the
   first `NSUB` queries its kernels against `scan_topk_packed`'s plain
   versions by PERF.md §2's packed rule (and the search's result equal
   to its kernels' on every unflagged query), its flagged counts, its
   device time by kernel and f32 K8's time at the k = 1000 plan beside
   its plain version, bound and the library's call. After the
   ``pack=False`` counts were read:
   the f32 results against `exact_rescan` and the LUT oracle on 64
   queries, the flag counts of the f32 plan at k = 100, 1000 and 3072,
   and one search's device time by kernel. Then beyond k = 3072 (the
   card's f32 plan r = 96, keep 4, tile 2048, to the JAX f32 plan's
   k = 6144): `api.search(pack=False)` at k = 4096 and 6144 over the
   plan sweep's 2,500 queries and the f32 LUT search at k = 4096, counts
   set to 0 just before each call and read just after (K9 or K6, the
   pair merge and K10 or K7 must have launched), the exact scans
   serving exactly the flagged queries; the decoded results against
   `exact_rescan` by the rule above, the LUT result's unflagged queries
   equal to the LUT oracle's on the same tables, and on an f32 base of
   small integers (every score exact) `search(pack=False)` equal to
   `exact_rescan` on every query; the pair merge at r = 96 bit-equal to
   its plain version on the first query chunk of K9's and K6's
   candidates, and timed at k = 6144 beside its plain version,
   `torch.topk` and its bound.

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
   rescue's K4 and its K2 apart; then one decode-mode search on f32
   operands (f32 K1, the norms table in f32) at k = 100 on the first 256
   queries, its recall@1 beside the bf16 codes search's and the decoded
   index's on the same queries: a report, not a gate; and one default
   (packed) search over the f32 decoded index (f32 K8) on those queries,
   its recall@1 reported and its kernels held against their plain
   versions by the d = 960 rule of `compare_topk`.
9. 128 bits on phase 3's data (d = 128): `api.train(method="sr_d",
   m=15, ...)` → `index_base(mode="codes")` (m' = 16) → LUT mode with
   bf16 tables (K5 on the LUT body, 16 queries a CTA) and f32 tables
   (K5, 8 queries a CTA), the `pack=False` LUT search (K6, pair merge,
   K7) and decode mode (K1 at m = 15), at k = 100 and 1000, recall@1
   >= 0.99 through each; then PQ-16 through the f32-table LUT search,
   recall@1 >= 0.75 (BASELINE.md:56: SR-D 1.000, PQ .823). After its
   counts were read, K5 (both table types), K6 and K7 against their
   plain versions on its tables, K1 (+K2+K3) and K4 at m = 15 against
   theirs, and the times of K5-K7 and K1 at m = 15.
10. ERVQ and CompQ through the facade on phase 3's data:
   `api.train(method="ervq" | "compq", m=7, h=256, niter=10)` (RVQ, then
   ERVQ's fine-tuning or CompQ's beam training) → `api.index_base(
   mode="codes")` over the 1e6 base (ERVQ's greedy encode, CompQ's
   H = 16 beam) → `api.search(k=100)` and `(k=1000)`, with train
   seconds, base vectors/s and queries/s; then ERVQ's default decoded
   index at k = 100. Recall@1 >= 0.99 through each, printed beside the
   JAX rows. After its counts were read, the persistence on the card:
   each ERVQ index (both modes) turned into the saved arrays
   (`api.saved_index`) and rebuilt on the card (`api.index_from_saved`)
   must search as the live one (dists and ids, k = 100); the decoded
   save rebuilt code-resident within 0.005 recall@1 of the live codes
   index; where h5py imports, the HDF5 round trip too (a line says
   whether it ran).
Then the two probes at the JAX probes' sizes: the fusion probe (its
kernel against its plain version for every k and both source forms,
timed beside `amin` and its bound, its launch's device time apart) and
the scan-tail probe (K8 alone and the steps after it).
11. The experiment protocols through the drivers
   (`rayuela_tpu_torch.experiments`, the rows of
   `rayuela_tpu_torch/demos/run_protocols.py`), after the probes: (a)
   the 64-bit SIFT1M-shape protocol on `read_dataset("synthetic-corr")`
   (1e5 train, 1e6 base, 1e4 queries, ground truth on the card), one
   trial of the nine methods at m = 8 (7 + the norms byte), h = 256,
   niter = 10, knn = 1000 through the runner's per-trial function
   without a store, each method's train, base-encode and search seconds
   printed and its recall@1 within 0.02 of the JAX row (BASELINE.md:57),
   PQ < OPQ < ChainQ < SR-C < min(LSQ, SR-D); (f) where h5py imports,
   the public runner with a results store (PQ and RVQ) read back by
   `list_trials` and `load_results` (a line says whether it ran); (c) the
   high-recall ladder on (a)'s data (SR-D m = 7, ilsiters 1 / 4 / 16 /
   64): non-decreasing within 0.002, recall@1 >= 0.99 at 64; (b)
   query=base at LabelMe's shape (`demos/bench_query_base10.py`'s data,
   3 trials): each method's mean recall@1 within 3 JAX stds of the JAX
   10-trial mean (BASELINE.md:53); (d) `hpo.optimize` over
   `default_objective` (1e4 / 1e5 / 1e3 synthetic-corr, m = 8, niter =
   3), 3 evaluations, each loss in [0, 1); then (e) the native xvecs
   reader on a 1e5 x 128 fvecs and bvecs file, full and range reads bit
   for bit the numpy path's, both times printed.
12. Multi-GPU over `torch.distributed` (`rayuela_tpu_torch.parallel`),
   after phase 11: (a) a world of 1 over NCCL in this process (a file
   store; no fallback to gloo or the CPU): `api.train(method="sr_d",
   m=7, h=256, niter=10, mesh=mesh)` on phase 3's 1e5 training vectors
   (OPQ, then the sharded ChainQ and SR-D: all-reduced statistics, K13
   and K11 on the rank's rows), its train qerror within 5% of phase 4's
   meshless model; `api.search(..., mesh=mesh)` at k = 100 and 1000 on
   the 1e4 queries over phase 4's codes index (the LUT form, as the JAX
   package's ``mesh=`` search takes it: K5 → K2 → K3) and phase 5's
   decoded index (K8 → K2 → K3), whose ids must equal the single-device
   call of the same form (``mode="lut"`` for the codes index) on every
   query that call's certificate does not flag, recall@1 >= 0.99, with
   queries/s and the NCCL all-gather's ms, and for the decoded index
   where the time goes beside the single-device search (the scan, the
   merge, the rescue through the decoded rows and through the codes,
   both searches by kernel). Then the data-parallel training of PQ-8,
   OPQ-8, RVQ-7, ERVQ-7 and CompQ-7 (h = 256, niter = 10) through
   `api.train(mesh=mesh)` on the same 1e5 vectors, each train qerror
   within 2% of the meshless `api.train` of the same seed in this run
   (phases 3 and 10 trained PQ, RVQ, ERVQ and CompQ; OPQ trains here),
   the seconds of both and the collectives each ``mesh=`` training
   issued (> 0); CompQ's yardstick is the meshless CompQ loop from the
   ``mesh=`` RVQ init of the seed, from which its ``mesh=`` training
   started (`compq_from_init12`: the meshless CompQ starts from an RVQ
   of other seeding draws, which CompQ's capped SGD step carries far);
   then one trial of the runner (`drivers._run_trial`,
   what `run_train_query_base` runs a trial with, without a store) of
   those five methods under ``mesh=`` at phase 11 (a)'s SIFT1M shape,
   each recall@1 within 0.02 of its JAX row, with the launches of K8 →
   K2 → K3 in its sharded recall searches; then `destroy_process_group`.
   (b) A world of 2 over gloo, both ranks on ``cuda:0``, spawned (the
   ``spawn`` method: this process holds a CUDA context), each loading
   only its half of the 1e6 base (`host_local_to_global`): the sharded
   decode-mode search (K14 → K3), the LUT search (K5 → K2 → K3), the
   decoded search over a bf16 and, with ``pack=False``, an f32 half
   (K8 → K2 → K3; K9 → pair merge → K10) at k = 100 and 1000, and K4 at
   keep = 0 on 1,024 queries, each held in this process against the
   single-device search of the whole base on the queries no certificate
   flagged, to one truncation step (every raw score within a step, every
   id one list holds and the other not within a step of the other's k-th
   score), the ``pack=False`` ids equal; one SR-D step and one ChainQ
   step on the ranks' halves of the training set, whose all-reduced
   (G, F) equal the single-device `codebook_stats` (G bit for bit, F to
   the reduction order), both ranks' codebooks and rotation bit-identical;
   queries/s of each sharded search and the gloo all-gather's ms (host
   copies). Then each rank trains PQ, OPQ, RVQ, ERVQ, CompQ and SR-D
   through `api.train(mesh=mesh)` on its half of the training set alone
   (`host_local_to_global`): both ranks' codebooks, R and (gathered)
   train codes bit-identical, each train qerror within 2% of the
   meshless model of (a) (SR-D: phase 4's; CompQ: the meshless loop
   from the two ranks' RVQ model), the seconds printed. A rank that fails or exits non-zero fails the
   run.
13. The JAX bench's scale rows (bench.py:34-55), after phase 12, each
   base released before the next is built, 1,000 of phase 3's queries:
   (1) the SIFT1B shape, 1e9 random PQ-8 codes on the card (phase 3's
   codebooks, 8 GB, 120 segments of 2**23 rows), `search_codes` at
   k = 100 (K1 → K2 → K3 a segment, K4 for a flagged segment); (2) the
   SIFT100M shape, 1e8 codes of phase 4's SR-D-7+1 (7 random codes, the
   norms byte the row's decode norm quantized by a norms codebook trained
   on the base's own decodes: random codes decode to other norms than
   the data's), decode mode at k = 1000 and 100, LUT mode at k = 100 (K5)
   and one `api.search` at k = 1000, which must equal `search_codes`;
   (3) those codes decoded into a bf16 decoded index (`build_index`,
   25.6 GB), `scan.search` at k = 1000 and 100 (K8 → K2 → K3 a segment);
   (4) 2e8 random PQ-8 codes in host memory, a numpy array and an
   `np.memmap` over a file, `search_codes_streamed` in shards of 1e8 at
   k = 100, and the resident search of the same rows. Each search runs
   once with the launch counts set to 0 just before it and read just
   after it (its repairs recorded: the flagged (query, segment) pairs K4
   re-ran, the queries an exact scan served), then is timed (median of
   3 calls by the host clock to a synchronize, each kernel launch
   bracketed by CUDA events: queries/s, the wall, the kernels' sum, the
   rest). Checks, each a failure: the answer's shape (finite dists, ids
   in [0, n), distinct, sorted by (dist, id)); rows planted on both sides
   of the first, second and last segment boundary and the last two rows
   (at 1e9 the first 8 queries' exact PQ encodings, and 16 copies of the
   first one's in lane 0 of segment 5, which must flag and come back; at
   1e8 the first 8 queries replaced by those rows' decodes) at the head of
   their queries' lists within one truncation step; on the first 32
   (1e9) or 64 (1e8) queries each search against the exact scan of its
   own keys (the plain version's scores of each segment's rows at the
   operand type, cut to the segment's id bits, top k by (score, id),
   merged by (dist, id)) by phase 8's set rule (>= 99.9% of ids shared,
   every id not shared within two truncation steps of the k-th by its own
   score), and at 1e9 also against the uncut f32 LUT oracle by the
   two-step rule (its share printed); the 1e9 search allocating at most
   3 GB beyond what was allocated before it; the decoded index's build
   holding its base once (at most 1 GB beyond it); the streamed result
   over the memmap equal to that over the array, and equal to the
   resident search's on every query neither flagged (dists by position,
   ids within groups of equal dist).

The launch counters are set to 0 just before phase 3 and read right
after its facade searches, and again for phase 4, for phase 4f, for
phase 5's default calls and for its one-pass call, for phase 6, its
packed search and phases 7 to 10 and for the probes; K1's, K14's and
K8's counts of their f32 instance's launches are set to 0 with them,
and again just before phase 8's f32 searches, and read after phase 4f,
phase 6's packed search, those searches and phase 9:
every kernel of the search path must have launched in each, K11 and K13
in phase 4, f32 K1, f32 K14, K2 and K3 in phase 4f, K8, K5, K2 and K3
in phase 5, K8's keep=0 form in the
one-pass call, K9, K10, K6, K7 and the pair merge in phase 6 (and in
each of phase 6 deep's calls, set to 0 just before each), f32 K8, K2
and K3 in its packed search, K8 / K1 / K5, K2 and K3 in each of the
deep band's calls (set to 0 just before each), f32 K1 and f32 K8 in
phase 8's f32 searches, K12 (once) and K14 in phase 7, K11, K13, K8,
K1, K14, K5, K9, the pair merge, K10, K2, K3 and the rescue's K4 in
phase 8, K11, K13, K5, K6, the pair merge, K7, K1, K2 and K3 in phase
9, K1, K2, K3 and K8 in phase 10, the fusion kernel and K8 in the
probes, K8, K2, K3, K11 and K13 in phase 11 (its
(a)-(d), set to 0 just before it), and in phase 12 K2-K5, K8-K11, K13,
K14 and the pair merge: in (a) set to 0 just before each mesh= call and
read right after it, in (b) each spawned rank's counts, every one of
these kernels on each rank; the single-device references beside them
are counted and printed apart; in phase 13 K1-K5 and K8, set to 0 just
before each search and read just after it, summed over its searches
(and in its step 5, the exact-float searches over 2e7 rows, K6, K7,
K9, K10 and the pair merge, set to 0 before each); in phase 5m (the
decoded search's key modes over phase 5's bf16 and phase 6's f32 index:
score16, qbias and every pre-min the plan's tile admits, at k = 100 and
1000) K8, K2 and K3 set to 0 just before each search and read just after
it, K8's counter of the mode holding each of its launches (the pre-min's
in-scan rescue re-runs K8 at premin = 0), then the mode instances
against the plain version (integer data at d = 128 and dp = 384, bit
for bit; Gaussian within a step), score16 and qbias against the exact
top-k of their own scores, the pre-min searches against the default
search, score16 past 15 row-id bits as the default mode, and each
instance's time beside the default mode's.
After that read, K11 is held against its plain version once more at the
base-encode shape (the whole 1e6 base, the SR-D codebooks, the greedy
codes, icmiter 4), as in phase 1b on Gaussian data; after phase 7's,
K12 runs again on the operands phase 7's base encode gave it (the 1e6
base, the greedy codes, its 32 node orders and its seed), must give
phase 7's codes and is held against its plain version there in the same
way. The
flag counts and the profiler pass run after those reads. The line before
the last is a JSON summary of the kernels (launches from the phase
named beside them, and phase 10's apart; the f32 instances of K1, K14
and K8 as entries of their own, their launches phase 4f's and the
packed search's of phase 6; K8's qbias, score16 and pre-min instances
on both bodies as entries of their own, their launches phase 5m's);
each entry also carries its launches in phase 11 and in phase 12; the
last line is the device record.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

N, D, NQ1, NQ, NTRAIN = 1_000_000, 128, 1024, 10_000, 100_000
DEV = "cuda"
# recall@1 on synthetic-corr at 64 bits from BASELINE.md (JAX package):
# quality references, not speed figures
JAX_RECALL1 = {"rvq": 0.9985, "pq": 0.1669, "sr_d": 0.9984, "ervq": 0.9995,
               "compq": 0.9985}
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
PEAK = {"bf16 tensor-core": 989e12, "tf32 tensor-core": 495e12,
        "f32 CUDA-core": 67e12, "HBM": 3.35e12}
N1B, NT = 65_536, 100_000     # phase 1b vectors; the timed encode batch
# the kernels of the protocols' path (phase 11): K8 → K2 → K3 under
# `linscan_*`, K11 in the LSQ family's encodes, K13 in ChainQ's
PATH11 = ("scan_candidates", "cand_merge", "tail_merge", "icm_sweeps",
          "viterbi_encode")


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


def merge_needs(cand, disc, out, r, cut, chunk=64):
    """What K2 (`cand_merge`) must move on these inputs, given its output
    ``out`` → ``(bytes, keys read)``: the 32-byte sectors of candidates
    and discards that the data requires, and the outputs written once.
    The candidates come in runs of ``ncand / ndisc`` rows, each ascending
    per (lane, query). A run's first member is required; a later member
    only where the one before lies among the ``r`` smallest of its
    (lane, query) (at most ``out[r - 1]``: else it and the rest of its
    run, no smaller, neither enter nor lower the certificate below it);
    with ``cut``, disc[t] only where the run's last member does (without,
    every discard). A sector is required where any of its 8 queries
    requires its key. `nbytes` of the inputs counts every byte."""
    import torch
    ncand, lanes, nq = cand.shape
    ndisc = disc.shape[0]
    run = ncand // ndisc if ndisc and ncand % ndisc == 0 else 1
    thr = out[r - 1].reshape(1, 1, -1)
    sectors = keys = 0
    nruns = ncand // run
    for t0 in range(0, nruns, chunk):
        t1 = min(nruns, t0 + chunk)
        inn = cand[t0 * run:t1 * run].reshape(t1 - t0, run, -1) <= thr
        need = torch.ones_like(inn)
        need[:, 1:] = inn[:, :-1]
        if cut:
            need = torch.cat([need, inn[:, -1:]], 1)
        keys += int(need.sum())
        sectors += int(need.reshape(t1 - t0, need.shape[1], -1, 8).any(-1)
                       .sum())
        del inn, need
    if not cut:
        keys += disc.numel()
        sectors += disc.numel() // 8
    return 32 * sectors + 4 * out.numel(), keys


def record_merge(times, name, ms, plain_ms, cand, disc, out, r, cut,
                 library_ms):
    """`record` for K2: its bound counts the bytes and keys these inputs
    require (`merge_needs`; one compare a key at the CUDA cores' issue
    rate, half the FMA flop rate); the former bound, every byte of the
    inputs read, is printed beside it."""
    moved, keys = merge_needs(cand, disc, out, r, cut)
    record(times, name, ms, plain_ms, 2.0 * keys, "f32 CUDA-core", moved,
           library_ms)
    every = nbytes(cand, disc, out)
    share = moved / every
    print(f"    K2 bytes required {moved:.4g} of {every:.4g} ({share:.3f});"
          f" every byte read once: {every / PEAK['HBM'] * 1e3:.3f} ms")


def split_merges_equal_plain(errs, tag, fn):
    """``fn()`` with K2's merges of one-pass splits (`_merge_onepass`)
    captured, each then held against K2's plain version → fn's result.
    Those runs are sorted buffers of r keys whose certificates may lie
    below them (`cut=False`); the count of such (lane, query)s is
    printed."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    seen, real = [], tsp._merge_onepass

    def capture(out, cand, disc, r):
        if disc.shape[0] > 1:
            seen.append((cand, disc, r))
        return real(out, cand, disc, r)
    tsp._merge_onepass = tsc._merge_onepass = capture
    try:
        res = fn()
    finally:
        tsp._merge_onepass = tsc._merge_onepass = real
    check(seen, f"{tag}: no split to merge")
    for cand, disc, r in seen:
        out, out0 = tsp.cand_merge(cand, disc, r), tsp.cand_merge_plain(
            cand, disc, r)
        check(torch.equal(out, out0), f"K2 {tag}, {disc.shape[0]} splits "
              f"(r={r}): kernel != plain")
        note(errs, "cand_merge", int_err((out, out0)))
        below = int((disc < cand.reshape(-1, r, *cand.shape[1:])[:, -1])
                    .sum())
        print(f"  {tag}: K2 over {disc.shape[0]} splits (r={r}) identical "
              f"to plain; {below} certificates below their split's r-th key")
    return res


def record(times, name, ms, plain_ms, flop, peak, moved, library_ms=None):
    """Keep kernel ``name``'s times beside its bound: the larger of
    ``flop`` over the published peak ``peak`` and ``moved`` bytes over
    the HBM rate (``plain_ms`` None: the plain version was not timed at
    this shape). Work on two kinds of unit passes ``peak=None`` and
    ``flop`` as ``{peak: operations}``: its operations' time is the sum
    of each kind's over its peak."""
    if peak is None:
        ops_ms = sum(f / PEAK[p] for p, f in flop.items()) * 1e3
        peak = " + ".join(flop)
        flop = sum(flop.values())
    else:
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


def plain_topk(outp, r, k, idbits, score16=False):
    """The top-k of a key buffer by the plain cross-lane merge, with the
    flags (`profile_scan_tail.plain_topk`)."""
    from rayuela_tpu_torch.demos.profile_scan_tail import plain_topk as pt
    return pt(outp, r, k, idbits, score16)


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
                            ("gauss", torch.bfloat16),
                            ("gauss", torch.float32)):
            c = Phase1(rng, pq, kind, dtype, NQ1)
            exact = kind == "int"
            # Gaussian f32: the cluster fmaf body's keys against K4's
            # (the one-pass = two-pass gate of phase 4f); the other
            # kernels are held on the bf16 Gaussian case
            if kind == "gauss" and dtype == torch.float32:
                print(f" {c.name}")
                args = (c.Qm, c.Cf, c.nrm, c.idx.packed)
                for k in (100, 1000):
                    _, r, keep, _ = tsc._codes_config(k)
                    idbits = tsp._pack_idbits(-(-N // 8192) * 8192)
                    out = tsc.cand_merge(*tsc.codes_decode_candidates(
                        *args, tile=8192, keep=keep, idbits=idbits,
                        has_norms=not pq), r, cut=True)
                    k4_keys_equal_k1s(args, not pq, out, keep, idbits,
                                      f"k={k} plan, f32")
                del c, args, out
                torch.cuda.empty_cache()
                continue
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
                    note(errs, "codes_decode_candidates f32",
                         int_err((cand, cand0), (disc, disc0)))
                out = tsc.cand_merge(cand, disc, r, cut=True)
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
        ms, out = timed(lambda: tsc.cand_merge(cand, disc, r, cut=True), 5)
        pms, out0 = timed(lambda: tsc.cand_merge_plain(cand, disc, r), 2)
        check(torch.equal(out, out0), f"K2 nq={NQ} k={k}: kernel != plain")
        note(errs, "cand_merge", int_err((out, out0)))
        # the library's top-r of each (lane, query) over the candidates:
        # K2's buffer without its certificate
        lib2_ms, _ = timed(lambda: torch.topk(cand, r, dim=0, largest=False),
                           2)
        record_merge(t, "cand_merge", ms, pms, cand, disc, out, r, True,
                     lib2_ms)
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
    merge_deep(times, errs, c)
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
            o4 = split_merges_equal_plain(
                errs, f"K4 {nq} queries",
                lambda: tsc.codes_decode_topk(Qr, *args[1:], **kw4))
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


def merge_deep(times, errs, c, k=4096):
    """K2 at the deepest plan class that a k = 4096 search takes (r = 96,
    keep = 4, tile = 2048) on one chunk of the main path's batch of
    K1's candidates over ``c``'s codes (`scan._query_chunks`: 3,216 of
    nq = 1e4 queries), held against its plain version with the main
    path's ``cut`` and without, and timed beside it and `torch.topk`
    along the candidates."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    r, keep, tile = tsp._scan_config(k)
    ntiles = -(-N // tile)
    nq = tsp._query_chunks(NQ, ntiles * keep * tsp.LANES * 4)[0][1]
    kw = dict(tile=tile, keep=keep, has_norms=True,
              idbits=tsp._pack_idbits(ntiles * tile))
    cand, disc = tsc.codes_decode_candidates(
        c.Qm[:nq].contiguous(), c.Cf, c.nrm, c.idx.packed, **kw)
    print(f" K2 at the k={k} plan (r={r}, keep={keep}, tile={tile}), one "
          f"chunk of {nq} queries")
    lib_ms, _ = timed(lambda: torch.topk(cand, r, dim=0, largest=False), 2)
    ms, out = timed(lambda: tsp.cand_merge(cand, disc, r, cut=True), 5)
    pms, out0 = timed(lambda: tsp.cand_merge_plain(cand, disc, r), 1)
    check(torch.equal(out, out0)
          and torch.equal(tsp.cand_merge(cand, disc, r), out0),
          f"K2 r={r} nq={nq}: kernel != plain")
    note(errs, "cand_merge", int_err((out, out0)))
    record_merge(times, f"cand_merge k={k}", ms, pms, cand, disc, out, r,
                 True, lib_ms)


def deep_merges(fn, *a):
    """``fn(*a)`` with K2's launches at the deepest plan class (r = 96)
    counted, at the wrappers' launch → ``(fn's result, launches)``."""
    from rayuela_tpu_torch.search import scan as tsp
    real, seen = tsp.launch, [0]

    def count(name, *args, **kw):
        # rq_cand_merge's arguments: cand, disc, out, ncand, ndisc, nq, r
        seen[0] += name == "rq_cand_merge" and args[6] == 96
        return real(name, *args, **kw)
    tsp.launch = count
    try:
        res = fn(*a)
    finally:
        tsp.launch = real
    return res, seen[0]


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
        f"k={k} K8+K2+K3", plain_topk(tsp.cand_merge(cand, disc, r,
                                                     cut=True), r, k, idbits),
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
        print(f" K5-K7 RVQ-7+1 {kind} {'bf16' if bf16 else 'f32'} tables; "
              f"layout (queries, threads, shared bytes, CTAs an SM) {lay}")
        check(lay[:3] == tsc._lut_exact_layout(c.idx.mprime, 256, bf16),
              "the LUT body's layout differs from its mirror")
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
    # (the pair merge orders equal scores by id as well); its bytes are
    # the scores and the outputs: an id is read only for a candidate
    # that enters
    libm_ms, _ = timed(lambda: torch.topk(cv, r, dim=0, largest=False), 2)
    record(t, "pair_merge", mms, mpms, 2.0 * cv.numel(), "f32 CUDA-core",
           nbytes(cv, ov, oi), libm_ms)
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
                    for k in (100, 1000, 2049, 8192, tsp._MAX_K)})
    for kind, dtype in (("int", torch.float32), ("gauss", torch.float32),
                        ("gauss", torch.bfloat16)):
        exact = kind == "int"
        # f32 K8 (K9's body) is an entry of its own in the kernels line
        k8 = "scan_candidates" + (" f32" if dtype == torch.float32 else "")
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
            out = tsp.cand_merge(cand, disc, r, cut=True)
            out0 = tsp.cand_merge_plain(cand, disc, r)
            check(torch.equal(out, out0)
                  and torch.equal(tsp.cand_merge(cand, disc, r), out0),
                  f"K2 {name} {tag}: kernel != plain")
            note(errs, "cand_merge", int_err((out, out0)))
            del cand, disc, out
            # a k in the plan's class: K3 then merges its deepest lists
            k = min(r * 64, tsp._MAX_K)
            got = tsp.scan_topk_packed(Q, idx.Xd, idx.x2, k=k, r=r,
                                       tile=tile, keep=keep)
            ref = plain_topk(tsp.cand_merge_plain(cand0, disc0, r), r, k,
                             idbits)
            note(errs, k8, compare_topk(
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
    # K13 at the 128-bit chain (m = 15) and at GIST's width: their
    # layouts differ (one CTA an SM at d = 960)
    for m, d in ((15, D), (7, 960)):
        for kind in ("int", "gauss"):
            X, C = _encode_case(rng, kind, N1B, m, d=d)
            got = tvit.viterbi_encode(X, C)
            ref = tvit.viterbi_encode_plain(X, C)
            note(errs, "viterbi_encode", compare_viterbi(
                f"K13 m={m} d={d} {kind}", X, C, got, ref, kind == "int"))
            del X, C, got, ref
    torch.cuda.empty_cache()


def viterbi_ops(n, m, h, d):
    """K13's operations on n vectors by the unit that can do them
    fastest: the unaries' m h d f32 multiply-adds per vector (2
    operations each) at the tf32 tensor-core peak three times over (the
    3xTF32 split, the card's fastest way to f32 accuracy), and the
    (m - 1) h^2 adds and mins of the min-plus (1 operation each) at the
    f32 CUDA-core peak."""
    return {"tf32 tensor-core": 3 * 2.0 * n * m * h * d,
            "f32 CUDA-core": 2.0 * n * (m - 1) * h * h}


def encode_kernel_times(rng, errs):
    """K11 (icmiter=4) and K13 beside their plain versions at the main
    path's encode batch (1e5 vectors, m=7, Gaussian data), the timed
    runs' results held against each other as in phase 1b, with their
    bounds (K11: icmiter * m visits of h * d multiply-adds per vector,
    on bf16 operands with f32 accumulation, so held to the bf16
    tensor-core peak; K13: `viterbi_ops`)."""
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
    record(times, "viterbi_encode", ms, pms, viterbi_ops(NT, m, 256, D),
           None, nbytes(X, C, got))
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
        model.extras["train_s"] = t1 - t0
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


def oracle_flags(Xq, Cf, nrm, si, k):
    """The flags of the one-pass and the two-pass plans at ``k`` over the
    codes index ``si`` (decode operands ``Cf``, ``nrm``), and the queries
    that reach the LUT oracle: those either plan flags that the rescue's
    K4 pass flags again → ``(one-pass flags, two-pass flags, oracle)``."""
    import torch

    from rayuela_tpu_torch.search import scan_codes as tsc
    r, keep, tile = tsc._onepass_config(k, si.mprime)
    fl1 = tsc.scan_codes_decode_topk(Xq, Cf, nrm, si.packed, k=k, pq=si.pq,
                                     r=r, keep=keep, tile=tile)[2]
    r2, keep2, tile2 = tsc._codes_config(k)[1:]
    fl2 = tsc.scan_codes_decode_topk_2p(Xq, Cf, nrm, si.packed, k=k,
                                        pq=si.pq, r=r2, keep=keep2,
                                        tile=tile2)[2]
    either = torch.nonzero(fl1 | fl2).flatten()
    oracle = torch.zeros_like(fl1)
    if either.numel():     # the rescue's K4 pass: its flags go on
        oracle[either] = tsc.scan_codes_decode_topk(
            Xq[either], Cf, nrm, si.packed, k=k, pq=si.pq)[2]
    return fl1, fl2, oracle


def phase4f(card, ds, Xq, index4):
    """Phase 4's SR-D-7+1 codes index searched on f32 operands (the
    cluster fmaf body: f32 K1, or K14 one-pass, then K2, K3 and the
    rescue) through the facade, `api.search(..., op_dtype=float32)`
    two-pass and `twopass=False` at k = 100 and 1000: recall@1 and
    queries/s (host clock, median of 3 warm calls) → the results."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import eval_recall

    print(f"== phase 4f: the codes search on f32 operands, SR-D-7+1, {N} "
          f"base, {NQ} queries ({card})")
    res = {}
    for k in (100, 1000):
        for tag, kw in (("two-pass", {}), ("one-pass", {"twopass": False})):
            kw = dict(kw, op_dtype=torch.float32)
            k4 = tsc.codes_decode_topk.launches
            dists, ids = rq.search(index4, Xq, k=k, **kw)
            torch.cuda.synchronize()
            rescues = tsc.codes_decode_topk.launches - k4
            check_search(dists, ids, k)
            r1 = float(eval_recall(ids, ds.gt, verbose=False)[0])
            walls = warm_walls(lambda: rq.search(index4, Xq, k=k, **kw))
            wall = float(np.median(walls))
            print(f"  f32 {tag} k={k}: recall@1 {r1:.4f}; {NQ / wall:,.0f} "
                  f"queries/s (median of "
                  f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms); rescue "
                  f"launches {rescues}")
            res[(tag, k)] = (dists, ids, r1)
    return res


def phase4f_checks(Xq, index4, res):
    """After phase 4f's counts were read: recall@1 >= 0.99 through each
    search; the one-pass result equal to the two-pass one on every query
    that did not reach the LUT oracle; on the first `NSUB` queries each
    search against the exact scan of its own scores (the plain version's
    rows decoded in f32 and -2q in f32; a query that reached the LUT
    oracle took the oracle's scores and is left out), to one truncation
    step; each search's device time by kernel → f32 K1's and K14's times
    at the k = 1000 plans beside their plain versions, the library's
    scan and their bound."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print("== phase 4f results: recall, one-pass against two-pass, the "
          f"first {NSUB} queries against the exact scan of their scores")
    for (tag, k), (_, _, r1) in res.items():
        check(r1 >= 0.99, f"f32 {tag} k={k}: recall@1 {r1:.4f} < 0.99")
    si = index4.scan_index
    Cf, nrm = si.decode_operands(D, torch.float32)
    has_norms = not si.pq
    Q = Xq[:NSUB].contiguous()
    q2 = (Q * Q).sum(-1, keepdim=True)
    Qm = tsc._query_operand(Q, Cf.shape[1], torch.float32)
    X, x2 = tsc._decode_x2(Cf, nrm, si.packed, si.mprime - has_norms,
                           has_norms)
    best = exact64(Qm, X, x2, 1000)
    for k in (100, 1000):
        fl1, fl2, oracle = oracle_flags(Xq, Cf, nrm, si, k)
        one, two = res[("one-pass", k)], res[("two-pass", k)]
        same = (one[0] == two[0]).all(1) & (one[1] == two[1]).all(1)
        bad = int((~same & ~oracle).sum())
        print(f"  f32 k={k}: flagged one-pass {int(fl1.sum())}, two-pass "
              f"{int(fl2.sum())} of {NQ}; {int(oracle.sum())} reach the LUT "
              f"oracle; one-pass identical to two-pass on "
              f"{int(same.sum())} of {NQ} queries")
        check(bad == 0, f"f32 k={k}: {bad} queries differ from the two-pass "
              "search outside the LUT oracle's")
        sel = ~oracle[:NSUB]
        for tag, t in (("two-pass", tsc._codes_config(k)[3]),
                       ("one-pass", tsc._onepass_config(k, si.mprime)[2])):
            d, i = res[(tag, k)][:2]
            step = 2.0 ** (tsp._pack_idbits(-(-N // t) * t) - 23)
            if bool(sel.any()):
                check_topk(f"f32 {tag} k={k}", (d[:NSUB][sel], i[:NSUB][sel]),
                           q2[sel], Qm[sel], X, x2, best[sel][:, :k], step)
    del best
    for k in (100, 1000):
        for kw in ({}, {"twopass": False}):
            print(f"  device time of the f32 search at k={k} {kw}")
            profile(lambda: rq.search(index4, Xq, k=k, op_dtype=torch.float32,
                                      **kw))
    # the kernels at the main path's shapes (this index, nq = 1e4)
    times = {}
    Qf = tsc._query_operand(Xq, Cf.shape[1], torch.float32)
    args = (Qf, Cf, nrm, si.packed)
    XT = X.T.contiguous()
    del X
    flop = 2.0 * N * NQ * D
    for k in (100, 1000):
        keep, tile = tsc._codes_config(k)[2:]
        r1, keep1, tile1 = tsc._onepass_config(k, si.mprime)
        lib_ms, _ = timed(lambda: library_scan(Qf, XT, x2, k), 1)
        t = {}
        for name, kernel, plain, kw in (
                ("codes_decode_candidates", tsc.codes_decode_candidates,
                 tsc.codes_decode_candidates_plain,
                 dict(tile=tile, keep=keep)),
                ("codes_decode_onepass", tsc.codes_decode_onepass,
                 tsc.codes_decode_onepass_plain,
                 dict(tile=tile1, r=r1, keep=keep1))):
            kw.update(has_norms=has_norms,
                      idbits=tsp._pack_idbits(-(-N // kw["tile"])
                                              * kw["tile"]))
            ms, out = timed(lambda: kernel(*args, **kw), 2)
            pms, ref = timed(lambda: plain(*args, **kw), 1, warm=False)
            out = out if isinstance(out, tuple) else (out,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            # Gaussian-like data: cuBLAS rounds the plain version's matmul
            # apart from the fmaf chains; the keys agree but near a step
            same = min(float((a == b).float().mean())
                       for a, b in zip(out, ref))
            print(f"  f32 {name} k={k}: keys equal to the plain version's "
                  f"{same:.6f}")
            check(same >= 0.999, f"f32 {name} k={k}: {same:.6f} of the keys "
                  "equal to the plain version's")
            record(t, f"{name} f32", ms, pms, flop, "f32 CUDA-core",
                   nbytes(*args, *out), lib_ms)
            del out, ref
        if k == 1000:
            times.update(t)
    del XT, Qf, args
    torch.cuda.empty_cache()
    return times


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


def phase6_packed(card, ds, Xq, index):
    """The default (packed) search over phase 6's f32 decoded index at
    k = 100 and 1000: f32 K8 → K2 → K3, `exact_rescan` for the queries
    the certificate flags; the default calls only, so that the launch
    counts read after it are this path's own → ``{k: (dists, ids)}``."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search.linscan import eval_recall

    print(f"== phase 6 packed: the default search over the f32 decoded "
          f"index (f32 K8), SR-D-7+1, {N} base, {NQ} queries ({card})")
    res = {}
    for k in (100, 1000):
        dists, ids = rq.search(index, Xq, k=k)
        torch.cuda.synchronize()
        check_search(dists, ids, k)
        curve = eval_recall(ids, ds.gt, verbose=False)
        walls = warm_walls(lambda: rq.search(index, Xq, k=k))
        print(f"  decoded f32 packed k={k}: recall@1 {curve[0]:.4f} @10 "
              f"{curve[9]:.4f} @100 {curve[99]:.4f}; search "
              f"{NQ / float(np.median(walls)):,.0f} queries/s (median of "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms)")
        check(curve[0] >= 0.99,
              f"decoded f32 packed SR-D recall@1 {curve[0]:.4f} < 0.99")
        res[k] = (dists, ids)
    return res


def phase6_packed_checks(errs, Xq, index, res):
    """After the packed search's counts were read: on the first `NSUB`
    queries its kernels (f32 K8 → K2 → K3, `scan_topk_packed`) against
    the plain versions on the same operands by PERF.md §2's packed rule,
    and the search's result equal to its kernels' top-k on every query
    they do not flag; the flagged count of the whole batch and the
    search's device time by kernel; f32 K8's time at the k = 1000 plan
    beside its plain version, its bound and the library's scan →
    ``{"scan_candidates f32": record}``."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp

    print(f"== phase 6 packed results: the first {NSUB} queries against the "
          f"plain versions, flags, profiles, f32 K8's time")
    si = index.scan_index
    Q = Xq[:NSUB].contiguous()
    q2 = (Q * Q).sum(-1, keepdim=True)
    Qm = tsp._query_operand(Q, si.Xd.shape[1], torch.float32)
    for k in (100, 1000):
        r, keep, tile = tsp._scan_config(k)
        idb = tsp._pack_idbits(-(-N // tile) * tile)
        got = tsp.scan_topk_packed(Q, si.Xd, si.x2, k=k, r=r, tile=tile,
                                   keep=keep)
        ref = plain_topk(tsp.cand_merge_plain(*tsp.scan_candidates_plain(
            Qm, si.Xd, si.x2, tile=tile, keep=keep, premin=0, idbits=idb),
            r), r, k, idb)
        note(errs, "scan_candidates f32", compare_topk(
            f"f32 index k={k} {NSUB} queries K8+K2+K3 vs plain", got, ref,
            idb, False))
        d, i = res[k]
        gv, gi, gf = got
        ok = ~gf
        same = bool(torch.equal(i[:NSUB][ok], gi[ok])) and bool(
            ((d[:NSUB] - (gv + q2)).abs()[ok]
             <= 1e-6 * d[:NSUB].abs()[ok]).all())
        print(f"  the search's result on the {int(ok.sum())} unflagged of "
              f"{NSUB} queries is its kernels' top-k (+|q|^2): {same}")
        check(same, f"decoded f32 packed k={k}: the search's result is not "
              "its kernels' top-k")
        fl = tsp.scan_topk_packed(Xq, si.Xd, si.x2, k=k, r=r, tile=tile,
                                  keep=keep)[2]
        print(f"  k={k} plan (r={r}, keep={keep}, tile={tile}): "
              f"{int(fl.sum())} of {NQ} queries flagged → exact_rescan")
        print(f"  device time of the packed f32 search at k={k}")
        wall, rows = profile(lambda: rq.search(index, Xq, k=k))
        k8 = sum(ms for name, ms in rows
                 if re.search(r"exact_rows_kernel.*KeySink", name))
        print(f"  f32 K8 {k8:.2f} ms of a {wall:.1f} ms wall "
              f"({k8 / wall:.3f})")
    # f32 K8 at the main path's batch (nq = 1e4), the k = 1000 plan
    times = {}
    Qf = tsp._query_operand(Xq, si.Xd.shape[1], torch.float32)
    XT = si.Xd.T.contiguous()
    lib_ms, _ = timed(lambda: library_scan(Qf, XT, si.x2, 1000), 1)
    del XT
    r, keep, tile = tsp._scan_config(1000)
    idb = tsp._pack_idbits(-(-N // tile) * tile)
    kw = dict(tile=tile, keep=keep, premin=0, idbits=idb)
    ms, out = timed(lambda: tsp.scan_candidates(Qf, si.Xd, si.x2, **kw), 2)
    pms, ref = timed(lambda: tsp.scan_candidates_plain(Qf, si.Xd, si.x2,
                                                       **kw), 1, warm=False)
    eq = min(float((a == b).float().mean()) for a, b in zip(out, ref))
    print(f"  f32 K8 k=1000 plan, nq={NQ}: keys equal to the plain "
          f"version's (cuBLAS sums in another order) {eq:.6f}")
    note(errs, "scan_candidates f32", compare_topk(
        f"f32 index k=1000 nq={NQ} K8 (+K2+K3) vs plain",
        plain_topk(tsp.cand_merge(*out, r, cut=True), r, 1000, idb),
        plain_topk(tsp.cand_merge_plain(*ref, r), r, 1000, idb), idb,
        False))
    record(times, "scan_candidates f32", ms, pms, 2.0 * N * NQ * D,
           "f32 CUDA-core", nbytes(Qf, si.Xd, si.x2, *out), lib_ms)
    del out, ref
    torch.cuda.empty_cache()
    return times


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
SWEEP_K = (2048, 4096, 8192, 10240, 12288)
SWEEP_PLANS = ((32, 4, 8192), (48, 4, 8192), (96, 4, 8192), (96, 4, 2048),
               (96, 4, 1024), (128, 4, 2048), (128, 4, 1024))
# the deep band (8192 < k <= 12288): the share of the sweep's queries the
# plan's class may flag on phase 5's index at each k
DEEP_FLAG_MAX = {10240: 0.05, 12288: 0.10}


def binom_tail(m, p, t):
    """P(X > t) for X ~ Binomial(m, p)."""
    if t >= m:
        return 0.0
    lp, lq = math.log(p), math.log1p(-p)
    return sum(math.exp(math.lgamma(m + 1) - math.lgamma(j + 1)
                       - math.lgamma(m - j + 1) + j * lp + (m - j) * lq)
               for j in range(t + 1, m + 1))


def predicted_flags(n, k, r, keep, tile, nq=SWEEP_NQ):
    """The queries of ``nq`` a plan (r, keep, tile) should flag if a
    query's top-k were k rows drawn at random from n (a lane's share is
    then Binomial(n / 128, k / n), a lane-tile's Binomial(tile / 128,
    k / n)): one minus the chance that no lane holds more than r of them
    and no lane-tile more than keep, the lanes and tiles taken as
    independent."""
    p = k / n
    lane = binom_tail(-(-n // 128), p, r)
    cell = binom_tail(tile // 128, p, keep) if keep else 0.0
    ok = (1 - lane) ** 128 * (1 - cell) ** (128 * -(-n // tile))
    return nq * (1 - ok)


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

    print(f"== plan sweep: flagged of {SWEEP_NQ} queries (beside the count "
          f"`predicted_flags` expects) and scan ms, SR-D-7+1, n={N}")
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
            fl = int(out[2].sum())
            print(f"    r={r} keep={keep} tile={tile}: decoded {fl} "
                  f"flagged, {ms:.1f} ms; lut {int(lout[2].sum())} "
                  f"flagged, {lm:.1f} ms; predicted "
                  f"{predicted_flags(N, k, r, keep, tile):.1f}")
            if k in DEEP_FLAG_MAX and (r, keep, tile) == tsp._scan_config(k):
                check(fl <= DEEP_FLAG_MAX[k] * SWEEP_NQ,
                      f"the plan's class at k={k} flags {fl} of "
                      f"{SWEEP_NQ} queries (at most "
                      f"{DEEP_FLAG_MAX[k]:.0%})")
            del out, lout
        torch.cuda.empty_cache()


DEEP_K = (10240, 12288)
# the deep band's forms: the candidates kernel each runs before K2 and K3
DEEP_SCANS = {"decoded": "scan_candidates",
              "decode": "codes_decode_candidates",
              "lut": "codes_lut_candidates"}
# the exact-float searches served by the pair merge at r = 96
F32_DEEP_K = (4096, 6144)
F32_SCANS = {"decoded": ("scan_f32_candidates", "verify_counts"),
             "lut": ("codes_lut_f32_candidates", "codes_verify_counts")}


@contextlib.contextmanager
def exact_scans_served(served):
    """Within the block, every call of the exact scans that serve a
    flagged query (`linscan.exact_rescan`, `scan_codes._lut_scan_tiled`)
    appends the number of queries it serves to ``served``."""
    from rayuela_tpu_torch.search import linscan as tls
    from rayuela_tpu_torch.search import scan_codes as tsc
    ex, lut = tls.exact_rescan, tsc._lut_scan_tiled

    def spy_ex(Qx, *a, **kw):
        served.append(Qx.shape[0])
        return ex(Qx, *a, **kw)

    def spy_lut(index, Qx, *a, **kw):
        served.append(Qx.shape[0])
        return lut(index, Qx, *a, **kw)
    tls.exact_rescan, tsc._lut_scan_tiled = spy_ex, spy_lut
    try:
        yield served
    finally:
        tls.exact_rescan, tsc._lut_scan_tiled = ex, lut


def facade_calls(forms, wrappers, zero):
    """``forms``: ``(form, k, index, kwargs, kernel names)``. Each
    `api.search(index, Q, k, **kwargs)` on the plan sweep's queries with
    the launch counts set to 0 just before it and read just after it, the
    exact scans counting the queries they serve, then timed (median of 3
    warm calls, host clock to a synchronize) → ``{(form, k): {"res":
    (dists, ids), "launches", "served", "wall"}}``."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    out = {}
    for form, k, idx, kw, names, Q in forms:
        served = []
        zero()
        with exact_scans_served(served):
            dists, ids = rq.search(idx, Q, k=k, **kw)
            torch.cuda.synchronize()
        launches = {n: wrappers[n].launches for n in names}
        check(all(launches.values()), f"{form} k={k}: a kernel of its path "
              f"never launched: {launches}")
        check(dists.shape == ids.shape == (Q.shape[0], k)
              and bool(torch.isfinite(dists).all())
              and bool(((ids >= 0) & (ids < N)).all()),
              f"{form} k={k}: malformed result")
        walls = warm_walls(lambda: rq.search(idx, Q, k=k, **kw))
        wall = float(np.median(walls))
        print(f"  {form} k={k}: launches {launches}; the exact scans served "
              f"{sum(served)} queries in {len(served)} calls; search "
              f"{wall * 1e3:.1f} ms, {Q.shape[0] / wall:,.0f} queries/s "
              f"(median of {', '.join(f'{w * 1e3:.1f}' for w in walls)} "
              "ms)")
        out[(form, k)] = {"res": (dists, ids), "launches": launches,
                          "served": sum(served), "wall": wall}
    return out


def deep_band(card, Xq, index, index4, wrappers, zero):
    """The deep top-k band through the facade (8192 < k <= 12288, the
    plan's class r = 128, keep 4, tile 1024: K8 / K1 / K5 → K2 at
    r = 128 → K3 at cap = 16384, flagged queries through the exact
    scans): `api.search` at k = 10240 and 12288 over the plan sweep's
    queries on phase 5's decoded index and phase 4's codes index in
    decode and LUT mode (`facade_calls`), beside the exact scans that
    served these k before the plan reached them."""
    import numpy as np
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import exact_rescan

    print(f"== deep band: api.search at k = {DEEP_K} over {SWEEP_NQ} "
          f"queries, SR-D-7+1, n={N} ({card})")
    Q = Xq[:SWEEP_NQ].contiguous()
    si, sc = index.scan_index, index4.scan_index
    forms = []
    for k in DEEP_K:
        check(tsp._scan_config(k)[0] == 128 and k <= tsp._MAX_K,
              f"k={k} is not the plan's deep class")
        ems = float(np.median(warm_walls(
            lambda: exact_rescan(Q, si.Xd, si.x2, k))))
        lms = float(np.median(warm_walls(
            lambda: tsc._lut_scan_tiled(sc, Q, k, D, torch.bfloat16))))
        print(f"  k={k}, the exact scans alone (median of 3): exact_rescan "
              f"{ems * 1e3:.1f} ms ({SWEEP_NQ / ems:,.0f} queries/s), the "
              f"LUT oracle {lms * 1e3:.1f} ms ({SWEEP_NQ / lms:,.0f})")
        forms += [(form, k, idx, kw, (DEEP_SCANS[form], "cand_merge",
                                      "tail_merge"), Q)
                  for form, idx, kw in (("decoded", index, {}),
                                        ("decode", index4, {}),
                                        ("lut", index4, {"mode": "lut"}))]
    return facade_calls(forms, wrappers, zero)


def packed_contract(tag, got, ref, q2, idbits):
    """A packed search's ``(dists with +|q|^2, ids)`` against an exact
    scan's ``(raw scores, ids)`` on the same queries, by the packed-key
    contract (`tests/torch_parity.py::assert_close_topk`): each raw
    score within one truncation step (2**(idbits - 23) of its magnitude)
    of the exact one at its position, + 1e-5 of the score and |q|^2 (the
    f32 rounding of the sums and of adding |q|^2), and at least 99% of
    the ids shared → the share of ids shared."""
    import torch
    (gd, gi), (rv, ri) = got, ref
    raw = gd - q2
    step = 2.0 ** (idbits - 23)
    tol = step * torch.maximum(raw.abs(), rv.abs()) + 1e-5 * (q2 + rv.abs())
    worst = float(((raw - rv).abs() - tol).max())
    bs = ri.long().sort(1).values
    gl = gi.long().contiguous()
    pos = torch.searchsorted(bs, gl).clamp(max=bs.shape[1] - 1)
    hits = float((bs.gather(1, pos) == gl).float().mean())
    print(f"  {tag}: ids shared {hits:.6f}, equal by position "
          f"{float((gl == ri.long()).float().mean()):.6f}; every score within "
          f"one truncation step of the exact scan's: {worst <= 0}")
    check(worst <= 0, f"{tag}: a score lies {worst:.3g} beyond one "
          "truncation step of the exact scan's")
    check(hits >= 0.99, f"{tag}: only {hits:.6f} of ids shared")
    return hits


def merges_equal_plain(errs, tag, cand, disc, r, cap):
    """K2 (with the per-tile cut's ``cut=True`` and without) and K3 at
    ``cap`` on K2's output, each bit-equal to its plain version → K2's
    output."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    out, out0 = tsp.cand_merge(cand, disc, r, cut=True), \
        tsp.cand_merge_plain(cand, disc, r)
    check(torch.equal(out, out0)
          and torch.equal(tsp.cand_merge(cand, disc, r), out0),
          f"K2 r={r} {tag}: kernel != plain")
    note(errs, "cand_merge", int_err((out, out0)))
    rows = out[:r].contiguous()
    (kk, ln), (kk0, ln0) = tsp.tail_merge(rows, cap), \
        tsp.tail_merge_plain(rows, cap)
    check(torch.equal(kk, kk0) and torch.equal(ln, ln0),
          f"K3 r={r} cap={cap} {tag}: kernel != plain")
    note(errs, "tail_merge", int_err((kk, kk0), (ln, ln0)))
    print(f"  {tag}: K2 at r={r} ({cand.shape[0]} candidate rows, "
          f"{cand.shape[2]} queries) and K3 at cap={cap} identical to their "
          f"plain versions")
    return out


def deep_band_checks(errs, times, Xq, index, index4, res):
    """After the deep band's launch counts were read: each search against
    the exact scan of its own scores (the kernels' operands: -2Q at the
    operand type against the decoded rows, decode mode's rows decoded
    from its operands, the LUT oracle) by the packed-key contract, a
    flagged query against the exact scan that served it; the exact scans
    served the flagged queries and no other; K2 at r = 128 and K3 at
    cap = 16384 bit-equal to their plain versions on the first query
    chunk of each search's own operands, and timed on the decoded
    index's at k = 12288 beside their plain versions, `torch.topk` and
    their bounds."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import exact_rescan

    print("== deep band results against the exact scans; K2 and K3 against "
          "their plain versions")
    Q = Xq[:SWEEP_NQ].contiguous()
    q2 = (Q * Q).sum(-1, keepdim=True)
    si, sc = index.scan_index, index4.scan_index
    # the codes searches' operand type: bf16 on the card
    op = torch.bfloat16 if sc.packed.device.type == "cuda" else torch.float32
    Cf, nrm = sc.decode_operands(D, op)
    Xc, x2c = tsc._decode_x2(Cf, nrm, sc.packed, sc.mprime - 1, True)

    def own(Qm, X, x2, k):
        """The exact top-k of ``Qm x + x2`` → (raw scores, ids)."""
        Qo = Qm.float() * -0.5          # exact: Qm is -2Q rounded
        d, i = exact_rescan(Qo, X, x2, k)
        return d - (Qo * Qo).sum(-1, keepdim=True), i

    for k in DEEP_K:
        r, keep, tile = tsp._scan_config(k)
        ntiles = -(-N // tile)
        idbits = tsp._pack_idbits(ntiles * tile)
        per_query = ntiles * keep * tsp.LANES * 4
        chunks = tsp._query_chunks(SWEEP_NQ, per_query)
        nq1 = chunks[0][1]
        cap = min(1 << (k - 1).bit_length(), 128 * tsp.LANES)
        Qm = tsp._query_operand(Q, D, si.Xd.dtype)
        Qc = tsp._query_operand(Q, Cf.shape[1], op)
        T = [tsc.build_luts(sc.C, Q[a:b], norms_cbook=sc.norms_cbook)
             for a, b in chunks]
        kw = dict(r=r, tile=tile, keep=keep)
        flags = {
            "decoded": tsp.search_flagged(si.Xd, si.x2, Q, k)[2],
            "decode": tsc.scan_codes_decode_topk_2p(
                Q, Cf, nrm, sc.packed, k=k, pq=sc.pq, **kw)[2],
            "lut": torch.cat([tsc.scan_codes_topk(t, sc.packed, k=k,
                                                  lut_dtype=op, **kw)[2]
                              for t in T])}
        for form, fl in flags.items():
            rec = res[(form, k)]
            nfl = int(fl.sum())
            print(f"  {form} k={k}: {nfl} of {SWEEP_NQ} queries flagged; "
                  f"the exact scans served {rec['served']}")
            check(rec["served"] == nfl, f"{form} k={k}: the exact scans "
                  f"served {rec['served']} queries, the certificate flags "
                  f"{nfl}")
            if form == "decoded":
                rv, ri = own(Qm, si.Xd, si.x2, k)
            elif form == "decode":
                rv, ri = own(Qc, Xc, x2c, k)
            else:
                rv, ri = tsc._lut_scan_tiled(sc, Q, k, D, op)
            ri = ri.long()
            if nfl:            # a flagged query took the exact scan's
                if form == "decoded":
                    fd, fi = exact_rescan(Q[fl], si.Xd, si.x2, k)
                    rv[fl], ri[fl] = fd - q2[fl], fi.long()
                else:
                    fd, fi = tsc._lut_scan_tiled(sc, Q[fl], k, D, op)
                    rv[fl], ri[fl] = fd, fi.long()
            packed_contract(f"{form} k={k} against the exact scan",
                            rec["res"], (rv, ri), q2, idbits)
            del rv, ri
        # the first chunk of each search's own candidates
        kc = dict(tile=tile, keep=keep, idbits=idbits)
        cands = {
            "decoded": lambda: tsp.scan_candidates(
                Qm[:nq1].contiguous(), si.Xd, si.x2, premin=0, **kc),
            "decode": lambda: tsc.codes_decode_candidates(
                Qc[:nq1].contiguous(), Cf, nrm, sc.packed,
                has_norms=not sc.pq, **kc),
            "lut": lambda: tsc.codes_lut_candidates(
                T[0].to(op).contiguous(), sc.packed, **kc)}
        for form, fn in cands.items():
            cand, disc = fn()
            tag = f"{form} k={k}, the first chunk"
            if form != "decoded" or k != DEEP_K[-1]:
                merges_equal_plain(errs, tag, cand, disc, r, cap)
                del cand, disc
                continue
            lib_ms, _ = timed(lambda: torch.topk(cand, r, dim=0,
                                                 largest=False), 2)
            ms, out = timed(lambda: tsp.cand_merge(cand, disc, r, cut=True),
                            3)
            pms, _ = timed(lambda: tsp.cand_merge_plain(cand, disc, r), 1,
                           warm=False)
            out = merges_equal_plain(errs, tag, cand, disc, r, cap)
            print(f" K2 at the k={k} plan (r={r}, keep={keep}, tile={tile}), "
                  f"one chunk of {nq1} queries")
            record_merge(times, f"cand_merge k={k}", ms, pms, cand, disc,
                         out, r, True, lib_ms)
            del cand, disc
            rows = out[:r].contiguous()
            flat = rows.permute(2, 0, 1).reshape(nq1, -1).contiguous()
            lib3, _ = timed(lambda: torch.topk(flat, k, dim=1,
                                               largest=False), 3)
            del flat
            ms3, (kk, ln) = timed(lambda: tsp.tail_merge(rows, cap), 3)
            pms3, _ = timed(lambda: tsp.tail_merge_plain(rows, cap), 1,
                            warm=False)
            print(f" K3 at the k={k} plan (r={r}, cap={cap}) on that "
                  f"chunk's K2 output")
            record(times, f"tail_merge k={k}", ms3, pms3,
                   2.0 * rows.numel(), "f32 CUDA-core",
                   nbytes(rows, kk, ln), lib3)
            del out, rows, kk, ln
        del T
        torch.cuda.empty_cache()
    del Xc, x2c
    for name in ("cand_merge", "tail_merge"):
        times[f"{name} k={DEEP_K[-1]}"]["launches"] = sum(
            rec["launches"][name] for rec in res.values())
    torch.cuda.empty_cache()


def phase6_deep(card, Xq, index, index4, wrappers, zero):
    """The exact-float searches beyond k = 3072 through the facade (the
    card's plan r = 96, keep 4, tile 2048: K9 → the pair merge at r = 96
    → top-k → K10, and K6 → the pair merge → K7 on f32 tables):
    `api.search(pack=False)` at k = 4096 and 6144 over the plan sweep's
    queries on phase 6's f32 index, and `api.search(mode="lut",
    pack=False, op_dtype=float32)` at k = 4096 on phase 4's codes index
    (`facade_calls`)."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp

    print(f"== phase 6 deep: pack=False at k = {F32_DEEP_K} over {SWEEP_NQ} "
          f"queries, SR-D-7+1, n={N} ({card})")
    Q = Xq[:SWEEP_NQ].contiguous()
    lut = dict(mode="lut", pack=False, op_dtype=torch.float32)
    forms = []
    for form, idx, kw, ks in (("decoded", index, {"pack": False}, F32_DEEP_K),
                              ("lut", index4, lut, F32_DEEP_K[:1])):
        for k in ks:
            check(tsp._f32_config(k, DEV)[0] == 96,
                  f"k={k}: the card's f32 plan is not r = 96")
            scan, count = F32_SCANS[form]
            forms.append((form, k, idx, kw, (scan, "pair_merge", count), Q))
    return facade_calls(forms, wrappers, zero)


def phase6_deep_checks(errs, times, Xq, index, index4, res):
    """After phase 6 deep's launch counts were read: the exact scans
    served the flagged queries and no other; the decoded searches against
    `exact_rescan` by PERF.md §2's rule (cuBLAS sums in another order:
    scores within 1e-5 relative + 1e-4, >= 99.9% of ids equal by
    position) and, on an f32 base of small integers where every score is
    exact, equal to it; the LUT search's unflagged queries equal to the
    LUT oracle on the same tables by position; the pair merge at r = 96
    bit-equal to its plain version on the first query chunk of K9's and
    K6's candidates, timed on K9's at k = 6144 beside its plain version,
    `torch.topk` and its bound."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import exact_rescan

    print("== phase 6 deep results against the exact scans; the pair merge "
          "at r = 96 against its plain version")
    Q = Xq[:SWEEP_NQ].contiguous()
    q2 = (Q * Q).sum(-1, keepdim=True)
    si, sc = index.scan_index, index4.scan_index
    codes = tsc.unpack_codes(sc.packed, sc.mprime)
    for (form, k), rec in res.items():
        r, keep, tile, _ = tsp._f32_config(k, DEV)
        per_query = tsp._f32_bytes_per_query(N, r, tile, keep)
        chunks = tsp._query_chunks(SWEEP_NQ, per_query)
        nq1 = chunks[0][1]
        dd, di = rec["res"]
        if form == "decoded":
            fl = tsp.search_flagged(si.Xd, si.x2, Q, k, pack=False)[2]
            ed, ei = exact_rescan(Q, si.Xd, si.x2, k)
            same = float((di == ei).float().mean())
            within = bool(((dd - ed).abs() <= 1e-5 * ed.abs() + 1e-4).all())
            print(f"  decoded pack=False k={k}: {int(fl.sum())} of "
                  f"{SWEEP_NQ} flagged, the exact scans served "
                  f"{rec['served']}; against exact_rescan: ids equal by "
                  f"position {same:.6f}, dists within 1e-5 relative: "
                  f"{within}")
            check(same >= 0.999 and within,
                  f"decoded pack=False k={k} != exact_rescan")
            del ed, ei
            cv, ci = tsp.scan_f32_candidates(
                tsp._query_operand(Q[:nq1], D, torch.float32), si.Xd, si.x2,
                tile=tile, keep=keep)
        else:
            T = [tsc.build_luts(sc.C, Q[a:b], norms_cbook=sc.norms_cbook)
                 for a, b in chunks]
            fl = torch.cat([tsc.scan_codes_topk(
                t, sc.packed, k=k, r=r, tile=tile, keep=keep,
                lut_dtype=torch.float32, pack=False)[2] for t in T])
            ok = ~fl
            bad = 0
            for (a, b), t in zip(chunks, T):
                for q0 in range(a, b, 250):
                    q1 = min(q0 + 250, b)
                    so, io = tsc.lut_scan(t[:, :, q0 - a:q1 - a], codes, k)
                    sel = ok[q0:q1]
                    bad += int((~((di[q0:q1] == io).all(1)
                                  & (dd[q0:q1] == so + q2[q0:q1]).all(1))
                                & sel).sum())
            print(f"  lut pack=False k={k}: {int(fl.sum())} of {SWEEP_NQ} "
                  f"flagged, the exact scans served {rec['served']}; "
                  f"unflagged queries identical to the LUT oracle on the "
                  f"same tables by position: all but {bad}")
            check(bad == 0, f"lut pack=False k={k} != the LUT oracle")
            cv, ci = tsc.codes_lut_f32_candidates(T[0], sc.packed, tile=tile,
                                                  keep=keep)
            del T
        check(rec["served"] == int(fl.sum()), f"{form} pack=False k={k}: "
              f"the exact scans served {rec['served']} queries, the "
              f"certificate flags {int(fl.sum())}")
        tag = f"{form} pack=False k={k}, the first chunk ({nq1} queries)"
        if form == "decoded" and k == F32_DEEP_K[-1]:
            mms, (ov, oi) = timed(lambda: tsp.pair_merge(cv, ci, r), 3)
            mpms, (ov0, oi0) = timed(lambda: tsp.pair_merge_plain(cv, ci, r),
                                     1, warm=False)
            libm_ms, _ = timed(lambda: torch.topk(cv, r, dim=0,
                                                  largest=False), 2)
            print(f" the pair merge at the k={k} plan (r={r}, keep={keep}, "
                  f"tile={tile}), one chunk of {nq1} queries")
            record(times, f"pair_merge k={k}", mms, mpms, 2.0 * cv.numel(),
                   "f32 CUDA-core", nbytes(cv, ov, oi), libm_ms)
        else:
            (ov, oi), (ov0, oi0) = tsp.pair_merge(cv, ci, r), \
                tsp.pair_merge_plain(cv, ci, r)
        check(torch.equal(ov, ov0) and torch.equal(oi, oi0),
              f"pair merge r={r} {tag}: kernel != plain")
        note(errs, "pair_merge", 0.0)
        print(f"  {tag}: the pair merge at r={r} identical to its plain "
              f"version")
        del cv, ci, ov, oi, ov0, oi0
        torch.cuda.empty_cache()
    times[f"pair_merge k={F32_DEEP_K[-1]}"]["launches"] = sum(
        rec["launches"]["pair_merge"] for rec in res.values())
    del codes
    # an f32 base of small integers: every score exact, so the result is
    # exact_rescan's by position, ties ordered by id in both
    g = torch.Generator(device=DEV).manual_seed(F32_DEEP_K[-1])
    X = torch.randint(-3, 4, (N, D), generator=g, device=DEV).float()
    Qi = torch.randint(-3, 4, (SWEEP_NQ, D), generator=g, device=DEV).float()
    idx = tsp.LinscanIndex(X, (X * X).sum(-1))
    del X
    for k in F32_DEEP_K:
        dv, iv = tsp.search(idx, Qi, k, pack=False)
        ed, ei = exact_rescan(Qi, idx.Xd, idx.x2, k)
        fl = int(tsp.search_flagged(idx.Xd, idx.x2, Qi, k, pack=False)[2]
                 .sum())
        same = bool(torch.equal(iv.long(), ei.long()) and torch.equal(dv, ed))
        print(f"  integer f32 base, pack=False k={k}: {fl} of {SWEEP_NQ} "
              f"flagged; ids and dists identical to exact_rescan on every "
              f"query: {same}")
        check(same, f"integer f32 base, pack=False k={k} != exact_rescan")
    del idx
    torch.cuda.empty_cache()


# the decoded search's key modes (phase 5m): the pre-min the kernel times
# take (the JAX package's plan value for its small-k class), the searches
# timed beside the default mode, and the K8 counters of each mode
PM_TIMED = 2
MODES_TIMED = ("default", "score16", "qbias", "premin=1", "premin=2")
MODE_COUNTERS = ("launches", "launches_f32", "launches_qbias",
                 "launches_score16", "launches_premin")


def admitted_premins(k):
    """Every pre-min the JAX validation admits at the plan of ``k``:
    ``(tile / 128) >> p >= keep``."""
    from rayuela_tpu_torch.search import scan as tsp
    _, keep, tile = tsp._scan_config(k)
    return list(range(1, (tile // 128 // keep).bit_length()))


def mode_counts(zero=False):
    """K8's launch counters (each mode's beside the total); ``zero``
    sets them to 0 first."""
    from rayuela_tpu_torch.search import scan as tsp
    if zero:
        for a in MODE_COUNTERS:
            setattr(tsp.scan_candidates, a, 0)
    return {a: getattr(tsp.scan_candidates, a) for a in MODE_COUNTERS}


def search_modes(k):
    """``(name, search keywords)`` of phase 5m at ``k``."""
    return ([("default", {}), ("score16", {"score16": True}),
             ("qbias", {"qbias": True})]
            + [(f"premin={p}", {"premin": p}) for p in admitted_premins(k)])


def phase5m(card, Xq, indexes, wrappers, zero):
    """The decoded search's key modes through the facade over phase 5's
    bf16 and phase 6's f32 decoded index (``indexes``: body → index), at
    k = 100 and 1000: score16, qbias and every pre-min the plan's tile
    admits, each search once with the launch counts set to 0 just before
    it and read just after it (K8's counter of the mode must count each
    of its launches: the pre-min's in-scan rescue re-runs K8 at premin =
    0), then the default mode and the timed modes' queries/s (median of
    3 warm calls) → ``(results, {body: {counter: launches}})``."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq

    res, by_body = {}, {}
    for body, index in indexes.items():
        print(f"== phase 5m: the decoded search's key modes, {body} decoded "
              f"index, SR-D-7+1, {N} base, {NQ} queries ({card})")
        tot = dict.fromkeys(MODE_COUNTERS, 0)
        for k in (100, 1000):
            for name, kw in search_modes(k):
                zero()
                mode_counts(zero=True)
                out = rq.search(index, Xq, k=k, **kw)
                torch.cuda.synchronize()
                path = {n: wrappers[n].launches for n in
                        ("scan_candidates", "cand_merge", "tail_merge")}
                mc = mode_counts()
                check_search(*out, k)
                check(all(path.values()), f"{body} {name} k={k}: a kernel "
                      f"of the path never launched: {path}")
                n8 = mc["launches"]
                check(mc["launches_f32"] == (n8 if body == "f32" else 0),
                      f"{body} {name} k={k}: K8 ran on the other body")
                for mode in ("qbias", "score16"):
                    want = n8 if mode in kw else 0
                    check(mc[f"launches_{mode}"] == want and n8 > 0,
                          f"{body} {name} k={k}: {mc}")
                check(bool(mc["launches_premin"]) == ("premin" in kw),
                      f"{body} {name} k={k}: {mc}")
                for a in MODE_COUNTERS:
                    tot[a] += mc[a]
                line = (f"  {name} k={k}: K8 launches {mc}, "
                        f"K2 {path['cand_merge']}, K3 {path['tail_merge']}")
                if name in MODES_TIMED:
                    walls = warm_walls(lambda: rq.search(index, Xq, k=k,
                                                         **kw))
                    line += (f"; {NQ / float(np.median(walls)):,.0f} "
                             f"queries/s (median of "
                             f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}"
                             f" ms)")
                print(line)
                res[(body, k, name)] = out
        by_body[body] = tot
        print(f"  {body} phase-5m K8 launches: {tot}")
    return res, by_body


def mode_scores(Q, si, mode):
    """The scores a mode's search ranks by, on the first queries ``Q``
    (f32, the index's width) of a decoded index ``si``, by the plain
    version's f32 matmul on the kernels' operands → ``(nq, n)``: score16
    the scores rounded to bfloat16, qbias ``max(s + |q|^2, +0.0)``, else
    the raw scores (without |q|^2)."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    n, nq = si.Xd.shape[0], Q.shape[0]
    Qm = tsp._query_operand(Q, si.Xd.shape[1], si.Xd.dtype)
    q2 = (Q * Q).sum(-1) if mode == "qbias" else None
    S = tsp._decoded_scores_fn(Qm, si.Xd, si.x2, n, q2)(0, 0, nq).T
    if mode == "score16":
        S = S.to(torch.bfloat16).float()
    return S.contiguous()


def mode_contract(tag, got, ref, step, atol):
    """A search's ``(values, ids)`` against the exact top-k of its mode's
    scores ``(values, ids)`` on the same queries: each value within
    ``step`` (relative) of the reference's at its position + ``atol``
    (per query), >= 99% of the ids shared → the share of ids shared."""
    import torch
    (gv, gi), (rv, ri) = got, ref
    tol = step * torch.maximum(gv.abs(), rv.abs()) + atol
    worst = float(((gv - rv).abs() - tol).max())
    bs = ri.long().sort(1).values
    gl = gi.long().contiguous()
    pos = torch.searchsorted(bs, gl).clamp(max=bs.shape[1] - 1)
    hits = float((bs.gather(1, pos) == gl).float().mean())
    print(f"  {tag}: ids shared {hits:.6f}, equal by position "
          f"{float((gl == ri.long()).float().mean()):.6f}; every value within "
          f"a step of the exact top-k's: {worst <= 0}")
    check(worst <= 0, f"{tag}: a value lies {worst:.3g} beyond a step")
    check(hits >= 0.99, f"{tag}: only {hits:.6f} of ids shared")
    return hits


def modes_kernels_vs_plain(rng, errs):
    """K8's mode instances against the plain version on both bodies:
    bit for bit on small-integer data at d = 128 and at dp = 384 (three
    d-blocks of the bf16 body, six stages of the f32 one); within one
    truncation step (a bf16 step under score16) on Gaussian data through
    K2 and K3."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp

    n, nq, tile, keep, r, k = 100_001, 300, 8192, 2, 16, 100
    idbits = tsp._pack_idbits(-(-n // tile) * tile)
    modes = {"qbias": {"qbias": True}, "score16": {"score16": True},
             "premin": {"premin": PM_TIMED}}
    for kind, widths in (("int", (128, 384)), ("gauss", (128,))):
        for d in widths:
            if kind == "int":
                X = rng.integers(-3, 4, (n, d)).astype("float32")
                Q = rng.integers(-3, 4, (nq, d)).astype("float32")
            else:
                X = rng.standard_normal((n, d)).astype("float32")
                Q = rng.standard_normal((nq, d)).astype("float32")
            Xt = torch.as_tensor(X, device=DEV)
            Qt = torch.as_tensor(Q, device=DEV)
            for body, dt in (("bf16", torch.bfloat16),
                             ("f32", torch.float32)):
                Xd = Xt.to(dt)
                x2 = (Xd.float() ** 2).sum(-1)
                Qm = tsp._query_operand(Qt, d, dt)
                for mode, mkw in modes.items():
                    name = "scan_candidates " + mode + (
                        " f32" if body == "f32" else "")
                    tag = f"K8 {mode} {body} {kind} d={d}"
                    kw = dict(tile=tile, keep=keep, idbits=idbits,
                              premin=mkw.get("premin", 0),
                              score16=mkw.get("score16", False),
                              q2=(Qt * Qt).sum(-1) if "qbias" in mkw
                              else None)
                    if kind == "int":
                        got = tsp.scan_candidates(Qm, Xd, x2, **kw)
                        ref = tsp.scan_candidates_plain(Qm, Xd, x2, **kw)
                        same = all(torch.equal(a, b)
                                   for a, b in zip(got, ref))
                        print(f"  {tag}: identical (cand, disc): {same}")
                        check(same, f"{tag}: kernel != plain")
                        note(errs, name, int_err(*zip(got, ref)))
                        continue
                    got = tsp.scan_topk_packed(Qt, Xd, x2, k=k, r=r,
                                               tile=tile, keep=keep, **mkw)
                    o0 = tsp.cand_merge_plain(*tsp.scan_candidates_plain(
                        Qm, Xd, x2, **kw), r)
                    v0, i0, f0 = tsp._packed_candidates(
                        o0, nq, r, k, idbits, "score16" in mkw)
                    ref = (v0, i0, (o0[r] < f0[None, :]).any(0))
                    note(errs, name, compare_topk(
                        tag, got, ref, 16 if "score16" in mkw else idbits,
                        False))
            del Xt, Xd


def phase5m_checks(rng, errs, times, Xq, indexes, res):
    """After phase 5m's counts were read: the kernels against their plain
    versions (`modes_kernels_vs_plain`); on the first `NSUB` queries each
    mode's search against the exact top-k of its own scores (score16:
    the bf16-rounded scores, one bf16 step; qbias: the clamped
    distances, one truncation step of them + 1e-5 of |q|^2); the
    pre-min searches' ids and dists equal to the default search's on
    every query no exact scan served, and at k = 100 with premin <= 2
    their ids on every query, the lossy scan's flags, the rescue's slots
    and what stayed flagged printed; score16 over a base past 15 row-id
    bits equal to the default mode with no score16 launch; each mode's
    K8 at the k = 1000 plan over all `NQ` queries, held through K2 and
    the plain K3 to its plain version by `compare_topk` (score16 at a
    bf16 step), and its time beside the default mode's, its plain
    version's, its bound and the library's scan → ``{name: record}``."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.utils import topk_lowest_id

    print("== phase 5m results: kernels against plain, each mode against "
          "its exact top-k, pre-min against the default, times")
    modes_kernels_vs_plain(rng, errs)
    Q = Xq[:NSUB].contiguous()
    q2 = (Q * Q).sum(-1, keepdim=True)
    for body, index in indexes.items():
        si = index.scan_index
        for mode in ("score16", "qbias"):
            S = mode_scores(Q, si, mode)
            for k in (100, 1000):
                # the queries `exact_rescan` served hold its f32 scores
                # (of the f32 queries, not the kernels' operands)
                ok = ~tsp.search_flagged(si.Xd, si.x2, Q, k,
                                         **{mode: True})[2]
                rv, ri = topk_lowest_id(S[ok], k)
                d, i = res[(body, k, mode)]
                got = d[:NSUB] - (0 if mode == "qbias" else q2)
                _, _, tile = tsp._scan_config(k)
                idb = tsp._pack_idbits(-(-N // tile) * tile)
                step = 2.0 ** -7 if mode == "score16" else 2.0 ** (idb - 23)
                mode_contract(f"{body} {mode} k={k} vs the exact top-k of "
                              f"its scores (the {int(ok.sum())} of {NSUB} "
                              f"queries it did not flag)",
                              (got[ok], i[:NSUB][ok]), (rv, ri), step,
                              1e-5 * (q2[ok] + rv.abs()))
            del S
        for k in (100, 1000):
            r, keep, tile = tsp._scan_config(k)
            d0, i0 = res[(body, k, "default")]
            fl0 = tsp.search_flagged(si.Xd, si.x2, Xq, k)[2]
            for p in admitted_premins(k):
                d, i = res[(body, k, f"premin={p}")]
                lossy = tsp.scan_topk_packed(Xq, si.Xd, si.x2, k=k, r=r,
                                             tile=tile, keep=keep,
                                             premin=p)[2]
                flp = tsp.search_flagged(si.Xd, si.x2, Xq, k, premin=p)[2]
                nfl = int(lossy.sum())
                ok = ~(fl0 | flp)
                same = bool(torch.equal(i[ok], i0[ok])) and bool(
                    torch.equal(d[ok], d0[ok]))
                eq = float((i == i0).float().mean())
                print(f"  {body} premin={p} k={k}: {nfl} of {NQ} queries "
                      f"flagged by the lossy scan, {min(nfl, tsp._PREMIN_NR)}"
                      f" rescue slots used, {int(flp.sum())} left to "
                      f"exact_rescan (the default search: {int(fl0.sum())});"
                      f" on the {int(ok.sum())} queries no exact scan "
                      f"served the ids and dists equal the default "
                      f"search's: {same}; ids equal by position on all "
                      f"{NQ}: {eq:.6f}")
                check(same, f"{body} premin={p} k={k}: the pre-min search "
                      "differs from the default search")
                # the small-k class at the JAX plan's pre-min and below:
                # every lossy flag finds a rescue slot, so the ids are
                # the default search's on every query
                if k == 100 and p <= PM_TIMED:
                    check(nfl <= tsp._PREMIN_NR and eq == 1.0,
                          f"{body} premin={p} k={k}: ids differ from the "
                          f"default search's on {1 - eq:.6f} of queries")
    # score16 past its id bits: a base of more than 2**22 rows (phase 5's
    # rows five times over), where `search` takes the default mode
    si = indexes["bf16"].scan_index
    big = tsp.LinscanIndex(si.Xd.repeat(5, 1), si.x2.repeat(5))
    Qb = Xq[:1000].contiguous()
    mode_counts(zero=True)
    got = tsp.search(big, Qb, 100, score16=True)
    mc = mode_counts()
    ref = tsp.search(big, Qb, 100)
    same = bool(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
    print(f"  score16 over {big.n:,} rows (row ids past 15 bits): equal to "
          f"the default mode {same}, K8 launches {mc}")
    check(same and mc["launches_score16"] == 0 and mc["launches"] > 0,
          "score16 past its id bits did not run as the default mode")
    del big, got, ref
    torch.cuda.empty_cache()
    # each mode's K8 at the main path's batch, the k = 1000 plan
    r, keep, tile = tsp._scan_config(1000)
    idb = tsp._pack_idbits(-(-N // tile) * tile)
    for body, index in indexes.items():
        si = index.scan_index
        f32 = body == "f32"
        Qm = tsp._query_operand(Xq, si.Xd.shape[1], si.Xd.dtype)
        # the library's f32 scan of the same rows (kernel_times' form)
        XT, Qlib = si.Xd.float().T.contiguous(), Qm.float()
        lib_ms, _ = timed(lambda: library_scan(Qlib, XT, si.x2, 1000), 1)
        del XT, Qlib
        base = dict(tile=tile, keep=keep, idbits=idb, premin=0)
        ms0, _ = timed(lambda: tsp.scan_candidates(Qm, si.Xd, si.x2,
                                                   **base), 2)
        print(f"  {body} K8 default mode, k=1000 plan, nq={NQ}: {ms0:.3f} ms")
        if not f32:      # the pairs each mode's keys take from the chain
            chain = {m: tsp._chain_pairs(Qm, si.Xd, si.x2, **base, **kw)
                     for m, kw in (("default", {}),
                                   ("qbias", {"q2": (Xq * Xq).sum(-1)}),
                                   ("score16", {"score16": True}))}
            print(f"  bf16 K8 (row, query) pairs keyed by the fmaf chain, "
                  f"k=1000 plan, of {N * NQ:.3g}: {chain}")
        for mode, kw in (("qbias", {"q2": (Xq * Xq).sum(-1)}),
                         ("score16", {"score16": True}),
                         ("premin", {"premin": PM_TIMED})):
            kw = dict(base, **kw)
            ms, out = timed(lambda: tsp.scan_candidates(Qm, si.Xd, si.x2,
                                                        **kw), 2)
            pms, ref = timed(lambda: tsp.scan_candidates_plain(
                Qm, si.Xd, si.x2, **kw), 1, warm=False)
            eq = min(float((a == b).float().mean())
                     for a, b in zip(out, ref))
            name = f"scan_candidates {mode}" + (" f32" if f32 else "")
            print(f"  {name}: keys equal to the plain version's {eq:.6f}")
            # held as f32 K8 is at this shape: through K2 (the pre-min's
            # cut=False, as `search` merges it) and the plain K3
            pm, s16 = kw["premin"] > 0, kw.get("score16", False)
            note(errs, name, compare_topk(
                f"{body} K8 {mode} k=1000 nq={NQ} (+K2+K3) vs plain",
                plain_topk(tsp.cand_merge(*out, r, cut=not pm), r, 1000,
                           idb, s16),
                plain_topk(tsp.cand_merge_plain(*ref, r), r, 1000, idb, s16),
                16 if s16 else idb, False))
            record(times, name, ms, pms, 2.0 * N * NQ * D,
                   "f32 CUDA-core" if f32 else "bf16 tensor-core",
                   nbytes(Qm, si.Xd, si.x2, *out), lib_ms)
            del out, ref
        torch.cuda.empty_cache()
    return times


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
                    note(errs, "codes_decode_onepass f32",
                         int_err((out, ref)))
                note(errs, "codes_decode_onepass", compare_topk(
                    f"k={k} K14+K3 (r={r}, keep={keep}, tile={tile})",
                    plain_topk(out, r, k, idbits),
                    plain_topk(ref, r, k, idbits), idbits, exact))
            del c
            torch.cuda.empty_cache()


def phase1f(rng, errs, n=200_000, nq=NQ1 + 100):
    """The f32 instances of K1 and K14 (the cluster fmaf body) against
    their plain versions on small-integer data: the main path's layout
    (d = 128, 7 codebooks + the norms byte), GIST's d = 960 (dp = 1024:
    the queries reloaded a piece at a time) and m = 15 (+ the norms
    byte: four code words a row) at d = 128, n = 2e5, the k = 100 and
    1000 plans of each: identical int32 outputs. nq = 1124 fills one
    cluster of 8 x 128 queries and then a part of one query block, so
    the padded query blocks and the partial block's guards are held
    exactly here (phase 1 runs a whole cluster)."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print(f"== phase 1f: f32 K1 and K14 vs plain on integer data, n={n}, "
          f"nq={nq}")
    for d, m in ((D, 7), (960, 7), (D, 15)):
        t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,
                                                        device=DEV)
        C = t(rng.integers(-2, 3, (m, 256, d)))
        Q = t(rng.integers(-3, 4, (nq, d)))
        idx = tsc.build_codes_index(
            C, t(rng.integers(0, 256, (n, m)), torch.int32), pq=False, d=d,
            norms_cbook=t(rng.integers(0, 500, 256)),
            norms_codes=t(rng.integers(0, 256, n), torch.int32))
        Cf, nrm = idx.decode_operands(d, torch.float32)
        args = (tsc._query_operand(Q, Cf.shape[1], torch.float32), Cf, nrm,
                idx.packed)
        for k in (100, 1000):
            _, _, keep, tile = tsc._codes_config(k)
            kw = dict(tile=tile, keep=keep, has_norms=True,
                      idbits=tsp._pack_idbits(-(-n // tile) * tile))
            got = tsc.codes_decode_candidates(*args, **kw)
            ref = tsc.codes_decode_candidates_plain(*args, **kw)
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"f32 K1 d={d} m={m} k={k}: kernel != plain")
            note(errs, "codes_decode_candidates f32",
                 int_err((got[0], ref[0]), (got[1], ref[1])))
            r1, keep1, tile1 = tsc._onepass_config(k, idx.mprime)
            kw14 = dict(tile=tile1, r=r1, keep=keep1, has_norms=True,
                        idbits=tsp._pack_idbits(-(-n // tile1) * tile1))
            got = tsc.codes_decode_onepass(*args, **kw14)
            ref = tsc.codes_decode_onepass_plain(*args, **kw14)
            check(torch.equal(got, ref),
                  f"f32 K14 d={d} m={m} k={k}: kernel != plain")
            note(errs, "codes_decode_onepass f32", int_err((got, ref)))
            print(f"  d={d} (dp={Cf.shape[1]}) m={m}+1 k={k}: K1 (keep={keep}"
                  f", tile={tile}) and K14 (r={r1}, keep={keep1}, "
                  f"tile={tile1}) identical to their plain versions")
        del idx, Cf, nrm, args, got, ref
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
        tsc._onepass_tiles_per = lambda nqb, ntiles, *a: ntiles
        try:
            ms1, out1 = timed(lambda: tsc.codes_decode_onepass(*args, **kw),
                              2)
        finally:
            tsc._onepass_tiles_per = rule
        check(torch.equal(out1, out), f"K14 k={k}: one split != "
              f"{-(-ntiles // tp)} splits")
        check(torch.equal(split_merges_equal_plain(
            errs, f"K14 k={k}", lambda: tsc.codes_decode_onepass(*args,
                                                                 **kw)),
            out), f"K14 k={k}: two calls differ")
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

    print("== phase 7 results against the two-pass search (phase 4's)")
    si = index4.scan_index
    Cf, nrm = si.decode_operands(D, torch.bfloat16)
    ref = {}
    for tag, (k, kw, dists, ids) in res.items():
        if k not in ref:
            ref[k] = rq.search(index4, Xq, k=k)
        rd, ri = ref[k]
        fl1, fl2, oracle = oracle_flags(Xq, Cf, nrm, si, k)
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
           viterbi_ops(X.shape[0], m, h, d), None, nbytes(X, C, got))
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


def phase8_f32(p8):
    """One decode-mode search on f32 operands at d = 960, k = 100, on the
    first `NSUB` queries (the cluster fmaf body over 8 pieces of 128
    dimensions, the queries reloaded a piece at a time, the norms table
    in f32): its recall@1 beside the bf16 codes search's and the decoded
    index's on the same queries. A report (how much of decode mode's gap
    to the decoded index the bf16 norms table makes, PERF.md §7), not a
    gate. Then the default (packed) search over the f32 decoded index on
    those queries (f32 K8 over 15 stages of 64 dimensions), its recall@1
    reported → its ``(dists, ids)`` for `phase8_f32_checks`."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search.linscan import eval_recall

    Q, gt = p8["Xq"][:NSUB].contiguous(), p8["gt"][:NSUB]
    print(f"== phase 8 f32: decode mode on f32 operands, d={D8}, k=100, "
          f"{NSUB} queries")
    rec = {}
    for tag, which, kw in (("decode mode, f32 operands", "codes",
                            {"op_dtype": torch.float32}),
                           ("decode mode, bf16 operands", "codes", {}),
                           ("decoded index, f32 rows (packed)", "f32", {}),
                           ("decoded index", "index", {})):
        dists, ids = rq.search(p8[which], Q, k=100, **kw)
        check(bool(torch.isfinite(dists).all())
              and bool(((ids >= 0) & (ids < N8)).all()),
              f"phase 8 {tag}: non-finite dists or ids out of range")
        rec[tag] = float(eval_recall(ids, gt, verbose=False)[0])
        if which == "f32":
            out = dists, ids
    print("  recall@1 on the same queries: " + ", ".join(
        f"{tag} {r:.4f}" for tag, r in rec.items()))
    return out


def phase8_f32_checks(errs, p8, res):
    """After phase 8's f32 counts were read: the packed search over the
    f32 decoded index (`phase8_f32`'s ``res``) against the exact scan of
    its own truncated scores, its kernels (f32 K8 → K2 → K3) held against
    the plain versions on the same operands by the d = 960 rule of
    `compare_topk` (by set, with the rows' own scores), and the search's
    result equal to its kernels' top-k on every query they do not
    flag."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp

    sf = p8["f32"].scan_index
    Q = p8["Xq"][:NSUB].contiguous()
    q2 = (Q * Q).sum(-1, keepdim=True)
    Qm = tsp._query_operand(Q, D8, torch.float32)
    r, keep, tile = tsp._scan_config(100)
    idb = tsp._pack_idbits(-(-N8 // tile) * tile)
    print(f"== phase 8 f32 results: the packed search over the f32 decoded "
          f"index, d={D8}, k=100, {NSUB} queries, against the plain versions")
    got = tsp.scan_topk_packed(Q, sf.Xd, sf.x2, k=100, r=r, tile=tile,
                               keep=keep)
    ref = plain_topk(tsp.cand_merge_plain(*tsp.scan_candidates_plain(
        Qm, sf.Xd, sf.x2, tile=tile, keep=keep, premin=0, idbits=idb), r),
        r, 100, idb)
    note(errs, "scan_candidates f32", compare_topk(
        f"scan_candidates f32 d={D8} k=100 (+K2+K3) vs plain", got, ref, idb,
        False, row_scores(Qm, sf.Xd, sf.x2)))
    d, i = res
    gv, gi, gf = got
    ok = ~gf
    same = bool(torch.equal(i[ok], gi[ok])) and bool(
        ((d - (gv + q2)).abs()[ok] <= 1e-6 * d.abs()[ok]).all())
    print(f"  the search's result on the {int(ok.sum())} unflagged of {NSUB} "
          f"queries is its kernels' top-k (+|q|^2): {same}")
    check(same, "phase 8's packed f32 search is not its kernels' top-k")


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
        fl1, fl2, oracle = oracle_flags(Xq, Cf, nrm, sc, k)
        if k == 100:
            p8["flagged"] = fl2     # decode mode's rescue batch at k = 100
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
            got = tsp.cand_merge(*fn(*a, **kw, **extra), r, cut=True)
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
    and the library's `addmm` + `topk` → ``{name: record}`` (K8 on the
    f32 index as ``"scan_candidates f32"``)."""
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
    Qf = tsp._query_operand(Q, D8, torch.float32)
    ms, out = timed(lambda: tsp.scan_candidates(Qf, sf.Xd, sf.x2, premin=0,
                                                **kw), 2)
    record(t, "scan_candidates f32", ms, None, flop, "f32 CUDA-core",
           nbytes(Qf, sf.Xd, sf.x2, *out), lib_ms)
    del out
    rf, kf, tf, _ = tsp._f32_config(k, DEV)
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
    # K1: the tensor-core body at R = 0 (the search's bf16 operands)
    k1ms = sum(ms for name, ms in rows if re.search(
        r"codes_mma_kernel(<\d+, 0,|ILi\d+ELi0E)", name))
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
        model.extras["train_s"] = t1 - t0
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
        qx, threads, smem_x = tsc._lut_exact_layout(sc.mprime, 256, bf16)
        print(f"  LUT body (K5-K7) with {dt} tables: {qx} queries and "
              f"{threads} threads a CTA, {smem_x} bytes of shared memory")
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
        got = tsp.cand_merge(*tsc.codes_decode_candidates(Qs, *args, **kw), r,
                             cut=True)
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


def phase10(seed, card, ds, Xq):
    """ERVQ and CompQ through the facade on phase 3's data: train, encode
    the base, search the codes index at k = 100 and 1000 (and ERVQ's
    decoded index at k = 100)."""
    import numpy as np
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.ops.qerror import qerror
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import eval_recall

    print(f"== phase 10: ERVQ and CompQ through the facade, synthetic-corr "
          f"d={D}, {NTRAIN} train, {N} base, {NQ} queries, m=7+1, h=256, "
          f"niter=10 ({card})")
    Xt = torch.as_tensor(ds.Xt, device=DEV)
    Xb = torch.as_tensor(ds.Xb, device=DEV)
    out = {"models": {}, "indexes": {}, "recall1": {}}

    def searched(tag, index, k):
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
        print(f"  {tag} k={k}: recall@1 {curve[0]:.4f} @10 {curve[9]:.4f} "
              f"@100 {curve[99]:.4f}; search {NQ / wall:,.0f} queries/s "
              f"(median of {', '.join(f'{w * 1e3:.1f}' for w in walls)} "
              f"ms); rescue launches {rescues}")
        out["recall1"][(tag, k)] = float(curve[0])
        return float(curve[0])

    for method in ("ervq", "compq"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = rq.train(Xt, method=method, m=7, h=256, niter=10, seed=seed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.extras["train_s"] = t1 - t0
        qe = float(qerror(Xt, model.codebooks, model.train_codes))
        index = rq.index_base(model, Xb, mode="codes")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"  {method} m=7: train {t1 - t0:.1f} s (train qerror "
              f"{qe:.4f}); index_base ({'greedy' if method == 'ervq' else 'H = 16 beam'}"
              f" encode, norms byte, pack) {t2 - t1:.1f} s, "
              f"{N / (t2 - t1):,.0f} base vectors/s")
        check(np.isfinite(qe), f"non-finite {method} train qerror")
        if method == "compq":
            # the training codes precede the last codebook step
            qr = float(qerror(Xt, model.codebooks, rq.encode(model, Xt)))
            print(f"  compq: train qerror {qr:.4f} at the beam's codes for "
                  f"the final codebooks")
        for k in (100, 1000):
            r1 = searched(method, index, k)
            check(r1 >= 0.99, f"{method} recall@1 {r1:.4f} < 0.99 at k={k}")
        print(f"  {method}: recall@1 {out['recall1'][(method, 100)]:.4f} "
              f"(JAX package, BASELINE.md: {JAX_RECALL1[method]})")
        out["models"][method] = model
        out["indexes"][(method, "codes")] = index
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = rq.index_base(out["models"]["ervq"], Xb)
    torch.cuda.synchronize()
    print(f"  ervq decoded index (bf16 base): index_base "
          f"{time.perf_counter() - t0:.1f} s")
    check(dec.mode == "decoded", "ERVQ's default index is not the decoded one")
    r1 = searched("ervq decoded", dec, 100)
    check(r1 >= 0.99, f"ervq decoded recall@1 {r1:.4f} < 0.99")
    out["indexes"][("ervq", "decoded")] = dec
    return out


def phase10_checks(ds, Xq, p10):
    """The persistence on the card, after phase 10's counts were read:
    each ERVQ index turned into the saved arrays and rebuilt on the card
    searches as the live one (dists and ids at k = 100); the decoded save
    rebuilt code-resident (the layout override: at h = 256 its norms
    codebook of 256 entries stacks with the tables as it is) keeps
    recall@1 within 0.005 of the live codes index; where h5py imports,
    the same through HDF5 files."""
    import tempfile

    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.search.linscan import eval_recall

    print("== phase 10 checks: the persistence on the card")

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    live = {mode: p10["indexes"][("ervq", mode)]
            for mode in ("codes", "decoded")}
    ref = {mode: rq.search(idx, Xq, k=100) for mode, idx in live.items()}
    for mode, idx in live.items():
        t = time.perf_counter()
        saved = rq.saved_index(idx)
        again = rq.index_from_saved(saved, device=DEV)
        torch.cuda.synchronize()
        print(f"  ervq {mode}: saved arrays -> rebuilt on the card in "
              f"{time.perf_counter() - t:.1f} s (d = {saved['@d']}, codes "
              f"{saved['codes'].dtype})")
        check(again.mode == mode and again.codes.device.type == "cuda",
              f"the rebuilt {mode} index is not on the card")
        check(same(rq.search(again, Xq, k=100), ref[mode]),
              f"the rebuilt ervq {mode} index searches apart from the live "
              f"one")
    over = rq.index_from_saved(rq.saved_index(live["decoded"]), mode="codes",
                               device=DEV)
    check(over.norms_codebook.numel() == 256, "the override's norms codebook")
    r_over = float(eval_recall(rq.search(over, Xq, k=100)[1], ds.gt,
                               verbose=False)[0])
    r_live = p10["recall1"][("ervq", 100)]
    print(f"  ervq decoded save rebuilt code-resident: recall@1 {r_over:.4f} "
          f"(live codes index {r_live:.4f})")
    check(abs(r_over - r_live) <= 0.005,
          f"the layout override's recall@1 {r_over:.4f} vs {r_live:.4f}")
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("  HDF5 round trip: not run (h5py is not installed here)")
        return
    with tempfile.TemporaryDirectory() as tmp:
        for mode, idx in live.items():
            path = os.path.join(tmp, f"{mode}.h5")
            rq.save_index(path, idx)
            check(same(rq.search(rq.load_index(path, device=DEV), Xq,
                                 k=100), ref[mode]),
                  f"the HDF5 round trip of the ervq {mode} index")
        rq.save_model(os.path.join(tmp, "m.h5"), p10["models"]["compq"])
        m = rq.load_model(os.path.join(tmp, "m.h5"), device=DEV)
        check(torch.equal(m.codebooks, p10["models"]["compq"].codebooks),
              "the HDF5 round trip of the compq model")
    print("  HDF5 round trip: ran (both ervq indexes, the compq model)")


def phase11(seed, card):
    """The experiment protocols through the port's drivers on the card:
    (a) the 64-bit SIFT1M-shape protocol (one trial of the nine methods,
    the runner's per-trial function without a store), (f) where h5py
    imports the public runner with a results store, (c) the high-recall
    ladder on (a)'s data, (b) query=base at LabelMe's shape over 3
    trials and (d) an HPO campaign of 3 evaluations."""
    import tempfile

    import numpy as np
    import torch

    from rayuela_tpu_torch.demos import run_protocols as rp
    from rayuela_tpu_torch.experiments import drivers, hpo
    from rayuela_tpu_torch.experiments.datasets import make_synthetic

    print(f"== phase 11: the experiment protocols through the drivers "
          f"({card})")
    out = {}
    t0 = time.perf_counter()
    ds = rp.dataset("sift1m", DEV)
    print(f"  (a) read_dataset('synthetic-corr'): {ds.Xt.shape[0]} train, "
          f"{ds.Xb.shape[0]} base, {ds.Xq.shape[0]} queries, d = "
          f"{ds.Xt.shape[1]}, exact ground truth on the card, "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["a"] = rp.rows(ds, [0], seed, DEV)
    print(f"  (a) one trial of the nine methods at {rp.PROTOCOL} (m - 1 "
          f"+ the norms byte but PQ and OPQ): "
          f"{time.perf_counter() - t0:.1f} s")
    r1 = {}
    for meth, rec in out["a"].items():
        s, r1[meth] = rec["seconds"][0], rec["recall1"][0]
        print(f"  (a) {meth:6s} train {s['train']:.2f} s, base encode "
              f"{s['encode']:.2f} s, search {s['search']:.2f} s; recall@1 "
              f"{r1[meth]:.4f} (JAX {rp.JAX_ROWS['sift1m'][meth]:.4f})")
    check(list(r1) == list(drivers.ALL_METHODS), "(a) ran other methods")
    far = {m: (r1[m], ref) for m, ref in rp.JAX_ROWS["sift1m"].items()
           if abs(r1[m] - ref) > 0.02}
    check(not far, f"(a) recall@1 beyond 0.02 of the JAX row: {far}")
    check(r1["pq"] < r1["opq"] < r1["chainq"] < r1["sr_c"]
          < min(r1["lsq"], r1["sr_d"]),
          f"(a) the order PQ < OPQ < ChainQ < SR-C < min(LSQ, SR-D) "
          f"breaks: {r1}")
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("  (f) the runner with a results store: not run (h5py is not "
              "installed here)")
    else:
        from rayuela_tpu_torch.experiments import store
        with tempfile.TemporaryDirectory() as tmp:
            res = drivers.run_train_query_base(
                ds, methods=("pq", "rvq"), results_dir=tmp, verbose=False,
                seed=seed, device=DEV, **rp.PROTOCOL)
            for meth in ("pq", "rvq"):
                path = os.path.join(tmp, f"{ds.name}_{meth}.h5")
                check(store.list_trials(path) == [0],
                      f"(f) the {meth} store's trials")
                check(np.array_equal(store.load_results(path, 0)["recall"],
                                     res[meth][0]["recall"]),
                      f"(f) the {meth} store's recall")
        print("  (f) the runner with a results store: ran (PQ and RVQ on "
              "(a)'s data; list_trials and load_results read it back)")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lad = drivers.high_recall_experiment(gen, ds, m=7, h=256, niter=10,
                                         ilsiters=(1, 4, 16, 64), knn=1000,
                                         verbose=False)
    curve = [float(lad[i][0]) for i in rp.JAX_LADDER]
    out["c"] = dict(zip(rp.JAX_LADDER, curve))
    print(f"  (c) the high-recall ladder (SR-D m = 7, ilsiters 1 / 4 / 16 / "
          f"64): recall@1 {' / '.join(f'{v:.4f}' for v in curve)} (JAX "
          f"{' / '.join(f'{v:.4f}' for v in rp.JAX_LADDER.values())}), "
          f"{time.perf_counter() - t0:.1f} s")
    check(all(b >= a - 0.002 for a, b in zip(curve, curve[1:])),
          f"(c) the ladder falls: {curve}")
    check(curve[-1] >= 0.99, f"(c) recall@1 {curve[-1]:.4f} < 0.99 at 64")
    out["sift1m"] = ds      # phase 12 (a)'s trial runs on it
    t0 = time.perf_counter()
    qb = rp.dataset("labelme", DEV)
    t1 = time.perf_counter()
    out["b"] = rp.rows(qb, range(3), seed, DEV)
    print(f"  (b) query=base at LabelMe's shape ({qb.Xt.shape[0]} base = "
          f"train, {qb.Xq.shape[0]} queries): data and ground truth "
          f"{t1 - t0:.1f} s, 3 trials {time.perf_counter() - t1:.1f} s")
    far = {}
    for meth, rec in out["b"].items():
        mean, sd = rp.spread(rec["recall1"])
        jm, js = rp.JAX_ROWS["labelme"][meth]
        sec = np.mean([sum(s.values()) for s in rec["seconds"]])
        print(f"  (b) {meth:6s} recall@1 {mean:.4f} ± {sd:.4f} (JAX {jm:.4f}"
              f" ± {js:.4f} over 10 trials); {sec:.2f} s a trial")
        if abs(mean - jm) > 3 * js:
            far[meth] = (mean, jm, js)
    check(not far, f"(b) mean recall@1 beyond 3 JAX stds of the JAX mean: "
          f"{far}")
    del qb
    t0 = time.perf_counter()
    hd = make_synthetic(d=D, ntrain=10_000, nbase=100_000, nquery=1_000,
                        corr=True, device=DEV)
    objective = hpo.default_objective(hd, m=8, h=256, niter=3, device=DEV)
    walls = []

    def timed_objective(cfg):
        t = time.perf_counter()
        loss = objective(cfg)
        walls.append(time.perf_counter() - t)
        return loss

    t1 = time.perf_counter()
    best, loss, hist = hpo.optimize(timed_objective, m=8, budget=3,
                                    seed=0, verbose=False)
    losses = [v for _, v in hist]
    out["d"] = dict(losses=losses, walls=walls)
    print(f"  (d) HPO, 3 evaluations on synthetic-corr (1e4 train, 1e5 "
          f"base, 1e3 queries; data {t1 - t0:.1f} s): losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; seconds an evaluation "
          f"{', '.join(f'{w:.1f}' for w in walls)}; incumbent {best} "
          f"(loss {loss:.4f})")
    check(len(losses) == 3 and all(0.0 <= v < 1.0 for v in losses),
          f"(d) an evaluation crashed or scored 1: {losses}")
    return out


def phase11_xvecs(rng):
    """(e) The native xvecs reader on the card's host: a 1e5 x 128 fvecs
    and bvecs file, full and range reads, bit for bit the numpy path's."""
    import tempfile

    import numpy as np

    from rayuela_tpu_torch.io import native, xvecs

    t0 = time.perf_counter()
    check(native.available(), "(e) the native xvecs reader did not build")
    print(f"== phase 11 (e): native xvecs reader built or loaded in "
          f"{time.perf_counter() - t0:.1f} s ({native.library_path().name})")
    data = {"fvecs": rng.standard_normal((100_000, D)).astype(np.float32),
            "bvecs": rng.integers(0, 256, (100_000, D)).astype(np.uint8)}
    with tempfile.TemporaryDirectory() as tmp:
        for flavor, X in data.items():
            path = os.path.join(tmp, f"x.{flavor}")
            getattr(xvecs, f"{flavor}_write")(path, X)
            read = getattr(xvecs, f"{flavor}_read")
            for start, count in ((0, None), (31_337, 4_096)):
                t0 = time.perf_counter()
                ref = read(path, start, count, native="never")
                t1 = time.perf_counter()
                got = read(path, start, count, native="always")
                t2 = time.perf_counter()
                check(got.dtype == ref.dtype and got.shape == ref.shape
                      and got.tobytes() == ref.tobytes(),
                      f"(e) the native {flavor} read [{start}, +{count}) "
                      f"differs from the numpy path")
                print(f"  (e) {flavor} {os.path.getsize(path) / 1e6:.1f} MB, "
                      f"rows [{start}, {start + got.shape[0]}): numpy "
                      f"{(t1 - t0) * 1e3:.2f} ms, native "
                      f"{(t2 - t1) * 1e3:.2f} ms, bit for bit equal")


# ---------------------------------------------------------------------------
# Phase 12: multi-GPU over torch.distributed
# ---------------------------------------------------------------------------

# the kernels the multi-GPU path runs (K2-K5, K8-K11, K13, K14 and the
# pair merge); the sharded searches scan codes by K14, K4 or K5, never
# by the two-pass decode scan K1
PATH12 = ("cand_merge", "tail_merge", "codes_decode_topk",
          "codes_lut_candidates", "scan_candidates", "scan_f32_candidates",
          "pair_merge", "verify_counts", "icm_sweeps", "viterbi_encode",
          "codes_decode_onepass")


# the kernels with an f32 instance, whose launches count apart
F32_12 = ("codes_decode_candidates", "codes_decode_onepass",
          "scan_candidates")


def _wrappers12():
    from rayuela_tpu_torch.ops import icm as ticm
    from rayuela_tpu_torch.ops import viterbi as tvit
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    mods = (tsc, tsp, ticm, tvit)
    return {n: next(getattr(m, n) for m in mods if hasattr(m, n))
            for n in PATH12 + F32_12}


def _zero12():
    for w in _wrappers12().values():
        w.launches = 0
        if hasattr(w, "launches_f32"):
            w.launches_f32 = 0


def _counts12():
    """This process's launches of the multi-GPU path's kernels, and of
    the f32 instances under ``"<name> f32"``."""
    wr = _wrappers12()
    out = {n: wr[n].launches for n in PATH12}
    out.update({f"{n} f32": wr[n].launches_f32 for n in F32_12})
    return out


def raw_close12(tag, got, ref, q2, idbits, ok, exact):
    """A sharded top-k ``(raw scores without +|q|^2, ids)`` against the
    single-device search's ``(dists with +|q|^2, ids)`` on the queries
    ``ok`` that no certificate flagged. ``exact`` (``pack=False``): equal
    ids. Else to one truncation step (that of the coarser scan, the whole
    base's ``idbits``): every raw score within a step of the other's at
    the same position, and an id that one list holds and the other does
    not lies within a step of the other list's k-th score (a step holds
    many neighbours: the two lists may break the boundary's ties their
    own way)."""
    import torch
    (gs, gi), (rd, ri) = got, ref
    gs, gi = gs[ok], gi[ok]
    rs, ri = (rd - q2)[ok], ri[ok]
    if exact:
        check(torch.equal(gi, ri), f"{tag}: ids differ from the "
              "single-device search")
        print(f"  {tag}: ids equal to the single-device search on "
              f"{int(ok.sum())} unflagged queries")
        return
    eps = 4 * 2.0 ** -23 * q2[ok]
    step = 2.0 ** (idbits - 23)
    tol = step * torch.maximum(gs.abs(), rs.abs()) + eps
    within = bool(((gs - rs).abs() <= tol).all())
    boundary, shared = True, 0
    for (av, ai), (bv, bi) in (((gs, gi), (rs, ri)), ((rs, ri), (gs, gi))):
        bsort = bi.sort(1).values
        pos = torch.searchsorted(bsort, ai.contiguous()).clamp(
            max=bi.shape[1] - 1)
        miss = bsort.gather(1, pos) != ai
        kth = bv[:, -1:]
        lim = kth - step * kth.abs() - eps
        boundary &= bool((av[miss] >= lim.expand_as(av)[miss]).all())
        shared = 1.0 - float(miss.float().mean())
    print(f"  {tag}: {int(ok.sum())} unflagged queries, ids shared "
          f"{shared:.6f} (equal by position "
          f"{float((gi == ri).float().mean()):.6f}), every score within "
          f"one truncation step: {within}, every id not shared within a "
          f"step of the other list's k-th score: {boundary}")
    if not within:
        excess = (gs - rs).abs() - tol
        for flat in excess.flatten().topk(5).indices.tolist():
            q, j = divmod(flat, gs.shape[1])
            print(f"    query {q} position {j}: sharded {float(gs[q, j])!r} "
                  f"(id {int(gi[q, j])}), single-device {float(rs[q, j])!r}"
                  f" (id {int(ri[q, j])}), tolerance {float(tol[q, j])!r}")
    check(within, f"{tag}: a score moved by more than one truncation step")
    check(boundary, f"{tag}: an id not shared lies off the boundary")


# the methods `api.train(mesh=)` trains data-parallel through
# `parallel.train_sharded`, with their m at 64 bits
DP12 = (("pq", 8), ("opq", 8), ("rvq", 7), ("ervq", 7), ("compq", 7))


def train_qerror(Xt, model):
    """A facade model's train qerror on ``Xt``; CompQ's at the beam's
    codes for its final codebooks (its train codes precede the last
    codebook step, and their error moves by seed far more, phase 10)."""
    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.ops.qerror import qerror, qerror_opq
    if model.method == "compq":
        return float(qerror(Xt, model.codebooks, rq.encode(model, Xt)))
    if model.method == "opq":
        return float(qerror_opq(Xt, model.codebooks, model.train_codes,
                                model.R))
    return float(qerror(Xt, model.codebooks, model.train_codes,
                        pq=model.method == "pq"))


class Collectives:
    """Counts this process's `torch.distributed` all-reduces and
    all-gathers (every collective of `parallel.mesh`) while entered."""

    def __enter__(self):
        import torch.distributed as dist
        self.count, self._orig = 0, (dist.all_reduce, dist.all_gather)

        def counted(fn):
            def call(*a, **kw):
                self.count += 1
                return fn(*a, **kw)
            return call
        dist.all_reduce, dist.all_gather = map(counted, self._orig)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.all_reduce, dist.all_gather = self._orig


def phase12_train(seed, card, p, mesh, count):
    """(a) continued: the five data-parallel trainings through
    ``api.train(mesh=)`` on phase 3's training set beside the meshless
    models of the same seed (``p["meshless"]``; OPQ's trained here), then
    one runner trial of the five under ``mesh=`` at the SIFT1M shape on
    phase 11's dataset (its launches counted by ``count``). Returns the train seconds and
    qerrors and the trial's recall@1 and seconds."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.demos import run_protocols as rp
    from rayuela_tpu_torch.experiments import drivers

    Xt = torch.as_tensor(p["Xt"], device=DEV)
    out = {"train": {}}
    models = {}
    for method, m in DP12:
        if method not in p["meshless"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = rq.train(Xt, method=method, m=m, h=256, niter=10,
                           seed=seed, device=DEV)
            torch.cuda.synchronize()
            ref.extras["train_s"] = time.perf_counter() - t0
            p["meshless"][method] = ref
        ref = p["meshless"][method]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Collectives() as coll:
            model = count(lambda: rq.train(Xt, method=method, m=m, h=256,
                                           niter=10, seed=seed, mesh=mesh))
            torch.cuda.synchronize()
        t = time.perf_counter() - t0
        models[method] = model
        qe, qr = train_qerror(Xt, model), train_qerror(Xt, ref)
        out["train"][method] = dict(mesh_s=t, s=ref.extras["train_s"],
                                    qerror=qe, meshless_qerror=qr,
                                    collectives=coll.count)
        print(f"  train(method={method!r}, m={m}, mesh=) {t:.2f} s, "
              f"{coll.count} collectives; train qerror {qe:.4f} (meshless "
              f"{qr:.4f} in {ref.extras['train_s']:.2f} s; {card})")
        check(coll.count > 0, f"train({method}, mesh=) issued no collective")
        check(model.train_codes.shape == (Xt.shape[0], m),
              f"train({method}, mesh=) codes are not the global array")
        if method == "compq":
            qr = compq_from_init12(Xt, models["rvq"], qe, "(a)")
            out["train"][method]["loop_qerror"] = qr
        check(abs(qe - qr) <= 0.02 * qr, f"train({method}, mesh=) "
              f"qerror {qe:.4f} beyond 2% of the meshless {qr:.4f}")
    ds = p["sift1m"]
    t0 = time.perf_counter()
    with Collectives() as coll:
        res = count(lambda: drivers._run_trial(
            ds, 0, None, methods=tuple(m for m, _ in DP12), verbose=False,
            seed=seed, device=DEV, mesh=mesh, **rp.PROTOCOL))
    out["trial_s"] = time.perf_counter() - t0
    out["trial"] = {}
    for meth, rec in res.items():
        r1, ref = float(rec["recall"][0]), rp.JAX_ROWS["sift1m"][meth]
        out["trial"][meth] = dict(recall1=r1, seconds=rec["seconds"])
        sec = ", ".join(f"{k} {v:.2f} s" for k, v in rec["seconds"].items())
        print(f"  trial under mesh= (SIFT1M shape): {meth:6s} recall@1 "
              f"{r1:.4f} (JAX {ref:.4f}); {sec}")
    print(f"  the trial: {out['trial_s']:.1f} s, {coll.count} collectives "
          f"({card})")
    far = {m: (v["recall1"], rp.JAX_ROWS["sift1m"][m])
           for m, v in out["trial"].items()
           if abs(v["recall1"] - rp.JAX_ROWS["sift1m"][m]) > 0.02}
    check(list(out["trial"]) == [m for m, _ in DP12],
          "the mesh= trial ran other methods")
    check(not far, f"mesh= trial recall@1 beyond 0.02 of the JAX row: {far}")
    return out


def compq_from_init12(Xt, rvq, qe, tag):
    """The yardstick of a ``mesh=`` CompQ: the meshless CompQ loop
    (`models.compq.train_compq`) from the ``mesh=`` RVQ model ``rvq`` of
    the same seed, the init from which ``api.train(method="compq",
    mesh=)`` trained, so that the two differ by the order of the sums
    alone. A meshless CompQ of the same seed starts from an RVQ of other
    seeding draws, and the capped SGD step carries such a difference far
    (the objective rises from the init's before it falls; the trajectory
    is printed), so it is no yardstick. Returns the loop's train
    qerror."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.models.compq import train_compq

    model, _, obj = train_compq(Xt, rvq.codebooks, rvq.train_codes,
                                niter=10)
    torch.cuda.synchronize()
    qr = train_qerror(Xt, rq.MCQModel("compq", model.codebooks))
    print(f"  {tag} CompQ: the meshless loop from the mesh= RVQ init gives "
          f"train qerror {qr:.4f} (mesh= {qe:.4f}); its objective "
          f"{float(obj[0]):.4f} (the init) -> max {float(obj.max()):.4f} "
          f"-> {float(obj[-1]):.4f}")
    return qr


def phase12a(seed, card, p):
    """(a) A world of 1 over NCCL inside this process: the facade's
    ``mesh=`` training and searches against the single-device calls.
    The launch counts are set to 0 just before each ``mesh=`` call and
    read right after it (``res["launches"]``); the single-device
    references' launches are counted apart (``res["ref_launches"]``)."""
    import datetime
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.ops.qerror import qerror
    from rayuela_tpu_torch.parallel import make_mesh
    from rayuela_tpu_torch.parallel import mesh as pmesh
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import eval_recall

    on_mesh, on_ref = {}, {}

    def count(into, fn):
        _zero12()
        out = fn()
        for n, c in _counts12().items():
            into[n] = into.get(n, 0) + c
        return out

    print(f"== phase 12 (a): a world of 1 over NCCL, SR-D-7+1 trained and "
          f"searched through the facade's mesh= ({card})")
    tmp = tempfile.mkdtemp(prefix="rq12a_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh()
        check(dist.get_backend() == "nccl" and mesh.device.type == "cuda",
              "phase 12 (a) is not an NCCL mesh on the card")
        index4, index5, Xq = p["index4"], p["index5"], p["Xq"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = count(on_mesh, lambda: rq.train(
            p["Xt"], method="sr_d", m=7, h=256, niter=10, seed=seed,
            mesh=mesh))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        Xt = torch.as_tensor(p["Xt"], device=DEV)
        qe = float(qerror(Xt, model.codebooks, model.train_codes))
        qe4 = float(qerror(Xt, index4.model.codebooks,
                           index4.model.train_codes))
        print(f"  train(mesh=) (OPQ -> sharded ChainQ -> sharded SR-D, "
              f"niter=10, phase 4's settings): {t1 - t0:.1f} s ({card}); "
              f"train qerror {qe:.4f} (phase 4's meshless model "
              f"{qe4:.4f})")
        check(np.isfinite(qe) and qe <= 1.05 * qe4,
              f"train(mesh=) qerror {qe:.4f} vs meshless {qe4:.4f}")
        q2 = (Xq * Xq).sum(-1, keepdim=True)
        res = {}
        for form, index, kw in (("codes, LUT form", index4, {"mode": "lut"}),
                                ("decoded", index5, {})):
            si = index.scan_index
            for k in (100, 1000):
                mesh_call = lambda: rq.search(index, Xq, k=k, mesh=mesh)
                dm, im = count(on_mesh, mesh_call)
                walls = count(on_mesh, lambda: warm_walls(mesh_call))
                dr, ir = count(on_ref, lambda: rq.search(index, Xq, k=k,
                                                         **kw))
                torch.cuda.synchronize()
                check_search(dm, im, k)
                if index is index4:
                    _, r, keep, tile = tsc._codes_config(k, "lut", N)
                    T = tsc.build_luts(si.C, Xq, pq=si.pq, d=D,
                                       norms_cbook=si.norms_cbook)
                    fl = count(on_ref, lambda: tsc.scan_codes_topk(
                        T, si.packed, k=k, r=r, tile=tile, keep=keep)[2])
                    del T
                else:
                    fl = count(on_ref, lambda: tsp.search_flagged(
                        si.Xd, si.x2, Xq, k)[2])
                ok = ~fl
                same = bool(torch.equal(im[ok], ir[ok]))
                curve = eval_recall(im, p["gt"], verbose=False)
                wall = float(np.median(walls))
                print(f"  {form} k={k}: recall@1 {curve[0]:.4f}; search "
                      f"(mesh=) {NQ / wall:,.0f} queries/s (median of "
                      f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; "
                      f"{card}); "
                      f"ids equal to the single-device call on the "
                      f"{int(ok.sum())} queries no certificate flagged: "
                      f"{same} (all {NQ}: "
                      f"{bool(torch.equal(im, ir))})")
                check(same, f"{form} k={k}: the mesh= ids differ from the "
                      "single-device call's on an unflagged query")
                check(curve[0] >= 0.99, f"{form} k={k}: recall@1 "
                      f"{curve[0]:.4f} < 0.99")
                res[(form, k)] = NQ / wall
                if index is index5:
                    res[("breakdown", k)] = count(
                        on_ref, lambda: breakdown12(mesh, index5, Xq, k,
                                                    card))
        x = torch.zeros(2, NQ, 1000, dtype=torch.int32, device=DEV)
        ms, _ = timed(lambda: pmesh._all_gather(mesh, x), 10)
        print(f"  the merge's all-gather at k = 1000 (scores and ids, 2 x "
              f"{NQ} x 1000 int32) over NCCL (a world of 1): {ms:.3f} ms "
              f"({card})")
        res["all_gather_ms"] = ms
        before = dict(on_mesh)
        res["dp"] = phase12_train(seed, card, p, mesh,
                                  lambda fn: count(on_mesh, fn))
        res["dp_launches"] = {n: c - before.get(n, 0)
                              for n, c in on_mesh.items()}
        print(f"  launches of the data-parallel trainings and the trial: "
              f"{res['dp_launches']}")
        check(all(res["dp_launches"][n] for n in ("scan_candidates",
                                                  "cand_merge",
                                                  "tail_merge")),
              "the mesh= trial's searches did not run K8 -> K2 -> K3")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    res["launches"], res["ref_launches"] = on_mesh, on_ref
    return res


def breakdown12(mesh, index, Xq, k, card):
    """Where the decoded index's ``search(mesh=)`` spends its time beside
    the single-device search, at a world of 1: each by CUDA events over 3
    calls after a warm one. The scan (`sharded_search`: the kernel scan
    and the merge), the merge alone on the scan's list, and the rescue of
    the flagged queries in its two forms: the exact rescan of the decoded
    rows (what ``mesh=`` and the single-device search run) and
    `sharded_scan_topk` over the codes (the JAX package's ``mesh=``
    rescue), then both whole searches under the profiler."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.parallel import mesh as pmesh
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search.linscan import exact_rescan

    si = index.scan_index
    nt = index.norms_codebook.reshape(-1)[index.norm_codes.long()]
    Q = torch.nn.functional.pad(Xq, (0, si.Xd.shape[1] - Xq.shape[1]))
    out = {}
    out["scan_ms"], (d, i, fl) = timed(
        lambda: pmesh.sharded_search(mesh, si.Xd, si.x2, Xq, k=k), 3)
    out["single_scan_ms"], _ = timed(
        lambda: tsp.search_flagged(si.Xd, si.x2, Q, k), 3)
    out["merge_ms"], _ = timed(lambda: pmesh._merge(mesh, d, i, k), 3)
    qidx = torch.nonzero(fl).flatten()
    out["flagged"] = int(qidx.numel())
    if out["flagged"]:
        out["codes_rescue_ms"], _ = timed(lambda: pmesh.sharded_scan_topk(
            mesh, Xq[qidx], index.model.codebooks, index.codes, k=k,
            norm_term=nt), 3)
        out["rows_rescue_ms"], _ = timed(lambda: exact_rescan(
            Q[qidx], si.Xd, si.x2, k), 3)
    print(f"  decoded k={k}, where the time goes ({card}): sharded_search "
          f"{out['scan_ms']:.2f} ms (the single-device kernel scan "
          f"{out['single_scan_ms']:.2f} ms; the merge alone "
          f"{out['merge_ms']:.2f} ms); the rescue of its "
          f"{out['flagged']} flagged queries through the decoded rows "
          f"{out.get('rows_rescue_ms', 0.0):.2f} ms, through the codes "
          f"(the JAX package's mesh= rescue) "
          f"{out.get('codes_rescue_ms', 0.0):.2f} ms")
    print(f"  decoded k={k}, search(mesh=) by kernel:")
    out["mesh_profile"] = profile(lambda: rq.search(index, Xq, k=k,
                                                    mesh=mesh))[1][:8]
    print(f"  decoded k={k}, the single-device search by kernel:")
    out["single_profile"] = profile(lambda: rq.search(index, Xq,
                                                      k=k))[1][:8]
    return out


def phase12_rank(rank, world, tmp):
    """(b) One of two gloo ranks on ``cuda:0``: its half of the base,
    the sharded searches, one SR-D step and one ChainQ step."""
    import numpy as np
    import torch

    from rayuela_tpu_torch.ops.codebook_update import codebook_stats
    from rayuela_tpu_torch.parallel import (host_local_to_global, make_mesh,
                                            make_sr_train_step,
                                            sharded_search,
                                            sharded_search_codes,
                                            sharded_search_codes_decode,
                                            train_chainq_sharded)
    from rayuela_tpu_torch.parallel import mesh as pmesh
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    torch.cuda.set_device(0)
    mesh = make_mesh(world, 1, device="cuda:0")
    dev = mesh.device
    rep = np.load(os.path.join(tmp, "replicated.npz"))
    own = np.load(os.path.join(tmp, f"rank{rank}.npz"))
    t = lambda a: torch.as_tensor(a, device=dev)
    C, Q = t(rep["C"]), t(rep["Q"])
    ncb4, ncb5 = t(rep["ncb4"]), t(rep["ncb5"])
    B = host_local_to_global(mesh, own["B"])
    rows = lambda x: pmesh.RowShard(x, B.start, B.n)
    packed = rows(tsc.pack_codes(B.local, t(own["nco4"])))
    nt = ncb5.reshape(-1)[t(own["nco5"]).long()]
    Xd, x2 = (rows(a) for a in tsp.decode_base(C, B.local, norm_term=nt,
                                               dtype=torch.bfloat16))
    Xf, x2f = (rows(a) for a in tsp.decode_base(C, B.local, norm_term=nt,
                                                dtype=torch.float32))
    T = tsc.build_luts(C, Q, norms_cbook=ncb4)
    forms = {
        "codes, decode (K14)": lambda k: sharded_search_codes_decode(
            mesh, Q, C, packed, k=k, pq=False, d=D, norms_cbook=ncb4),
        "codes, LUT (K5)": lambda k: sharded_search_codes(mesh, T, packed,
                                                          k=k),
        "decoded, packed (K8)": lambda k: sharded_search(mesh, Xd, x2, Q,
                                                         k=k),
        "decoded, pack=False (K9, K10)": lambda k: sharded_search(
            mesh, Xf, x2f, Q, k=k, pack=False),
    }
    out, walls = {}, {}
    for k in (100, 1000):
        for name, fn in forms.items():
            res = fn(k)
            ws = warm_walls(lambda: fn(k))
            out[(name, k)] = [a.cpu() for a in res]
            walls[(name, k)] = float(np.median(ws))
    # K4 (keep = 0, its one compiled depth) on the rescue's scale
    k4 = lambda: sharded_search_codes_decode(
        mesh, Q[:1024], C, packed, k=100, pq=False, d=D, norms_cbook=ncb4,
        r=48, tile=2048, keep=0)
    out[("codes, decode keep=0 (K4)", 100)] = [a.cpu() for a in k4()]
    walls[("codes, decode keep=0 (K4)", 100)] = float(np.median(
        warm_walls(k4)))
    x = torch.zeros(2, NQ, 1000, dtype=torch.int32, device=dev)
    gather_ms, _ = timed(lambda: pmesh._all_gather(mesh, x), 5)
    # one SR-D step and one ChainQ step on the rank's half of the
    # training set; their all-reduced (G, F)
    X = host_local_to_global(mesh, own["X"])
    Bt = host_local_to_global(mesh, own["Bt"])
    G, F = codebook_stats(X.local, Bt.local, 256)
    G, F = pmesh._all_reduce(mesh, G), pmesh._all_reduce(mesh, F)
    step = make_sr_train_step(mesh, h=256, niter=10)
    C1, B1, obj = step(X, Bt, C, 1, torch.Generator().manual_seed(0))
    cq, _, cq_obj = train_chainq_sharded(mesh, X, Bt, torch.eye(D, device=dev),
                                         h=256, niter=1)
    dp = dp_rank12(mesh, X, int(rep["seed"]))
    res = dict(launches=_counts12(), walls=walls, gather_ms=gather_ms,
               sr_C=C1.cpu(), sr_obj=float(obj), cq_C=cq.codebooks.cpu(),
               cq_R=cq.R.cpu(), cq_obj=cq_obj.cpu(), start=B.start, n=B.n,
               dp=dp)
    if rank == 0:
        res.update(out=out, G=G.cpu(), F=F.cpu())
    return res


def dp_rank12(mesh, X, seed):
    """(b) on one rank: every data-parallel method, and SR-D, trained
    through ``api.train(mesh=)`` on the rank's rows ``X`` (a `RowShard`)
    → ``{method: {s, C, R, B}}`` on the host."""
    import torch

    import rayuela_tpu_torch.api as rq

    dp = {}
    for method, m in DP12 + (("sr_d", 7),):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mdl = rq.train(X, method=method, m=m, h=256, niter=10, seed=seed,
                       mesh=mesh)
        torch.cuda.synchronize()
        dp[method] = dict(s=time.perf_counter() - t0, C=mdl.codebooks.cpu(),
                          R=None if mdl.R is None else mdl.R.cpu(),
                          B=mdl.train_codes.cpu())
    return dp


def dp_checks12(card, Xt, refs, ranks):
    """(b)'s trainings held in this process: both ranks' results
    bit-identical, each train qerror within 2% of the meshless model of
    ``refs`` → ``{method: {s, qerror, meshless_qerror}}``."""
    import torch

    import rayuela_tpu_torch.api as rq

    out = {}
    for method, got in ranks[0]["dp"].items():
        same = all(torch.equal(got[k], ranks[1]["dp"][method][k])
                   for k in ("C", "B") + (("R",) if got["R"] is not None
                                          else ()))
        model = rq.MCQModel(method, got["C"].to(DEV),
                            R=None if got["R"] is None else got["R"].to(DEV),
                            train_codes=got["B"].to(DEV))
        qe, qr = train_qerror(Xt, model), train_qerror(Xt, refs[method])
        if method == "compq":
            rvq = ranks[0]["dp"]["rvq"]
            qr = compq_from_init12(Xt, rq.MCQModel(
                "rvq", rvq["C"].to(DEV), train_codes=rvq["B"].to(DEV)), qe,
                "(b)")
        out[method] = dict(s=[r["dp"][method]["s"] for r in ranks],
                           qerror=qe, meshless_qerror=qr)
        print(f"  train(method={method!r}, mesh=) on each rank's half: "
              f"{', '.join(f'{t:.2f}' for t in out[method]['s'])} s; train "
              f"qerror {qe:.4f} (meshless {qr:.4f}); both ranks' codebooks"
              f"{', R' if got['R'] is not None else ''} and train codes "
              f"bit-identical: {same} ({card})")
        check(same, f"train({method}, mesh=): the two ranks differ")
        check(got["B"].shape == (Xt.shape[0], got["C"].shape[0]),
              f"train({method}, mesh=): codes are not the global array")
        check(abs(qe - qr) <= 0.02 * qr, f"train({method}, mesh=) over "
              f"2 gloo ranks: qerror {qe:.4f} beyond 2% of {qr:.4f}")
    return out


def phase12b(seed, card, p):
    """(b) A world of 2 over gloo, both ranks on ``cuda:0`` (spawned),
    each holding its half of the 1e6 base, held against the
    single-device searches of the whole base in this process."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from rayuela_tpu_torch.ops.codebook_update import codebook_stats
    from rayuela_tpu_torch.parallel.dryrun import run_ranks
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    print(f"== phase 12 (b): a world of 2 over gloo, both ranks on cuda:0, "
          f"each holding its half of the {N} base ({card})")
    index4, index5, Xq = p["index4"], p["index5"], p["Xq"]
    npy = lambda a: a.detach().cpu().numpy()
    tmp = tempfile.mkdtemp(prefix="rq12b_")
    try:
        np.savez(os.path.join(tmp, "replicated.npz"), seed=seed,
                 C=npy(index4.model.codebooks), Q=npy(Xq),
                 ncb4=npy(index4.norms_codebook),
                 ncb5=npy(index5.norms_codebook))
        Xt = np.asarray(p["Xt"], np.float32)
        halves = [(0, N // 2), (N // 2, N)]
        thalves = [(0, NTRAIN // 2), (NTRAIN // 2, NTRAIN)]
        for r, ((a, b), (ta, tb)) in enumerate(zip(halves, thalves)):
            np.savez(os.path.join(tmp, f"rank{r}.npz"),
                     B=npy(index4.codes[a:b]),
                     nco4=npy(index4.norm_codes[a:b]),
                     nco5=npy(index5.norm_codes[a:b]), X=Xt[ta:tb],
                     Bt=npy(index4.model.train_codes[ta:tb]))
        t0 = time.perf_counter()
        try:
            ranks = run_ranks(phase12_rank, 2, (tmp,), timeout=600.0,
                              pg_timeout=300.0, threads=None)
        except RuntimeError as e:
            raise Failed(f"phase 12 (b): {e}")
        print(f"  spawn, the 2 ranks' work and join: "
              f"{time.perf_counter() - t0:.1f} s ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    check([(r["start"], r["n"]) for r in ranks] == [(0, N), (N // 2, N)],
          "host_local_to_global gave the wrong row ranges")
    for (name, k), w in r0["walls"].items():
        nq = 1024 if "K4" in name else NQ
        print(f"  {name} k={k}: {nq / w:,.0f} queries/s over 2 gloo ranks "
              f"on one card ({card})")
    print(f"  the merge's all-gather at k = 1000 (2 x {NQ} x 1000 int32) "
          f"over gloo (host copies, 2 ranks on one card): "
          f"{r0['gather_ms']:.3f} ms ({card})")
    # the single-device searches of the whole base
    q2 = (Xq * Xq).sum(-1, keepdim=True)
    f32 = tsp.build_index(index4.model.codebooks, index4.codes,
                          d=D, dtype=torch.float32,
                          norm_term=index5.scan_index.x2)
    idb = tsp._pack_idbits(tsp.cdiv(N, tsp._TILE) * tsp._TILE)
    for (name, k), (s, i, fl) in r0["out"].items():
        s, i, fl = s.to(DEV), i.to(DEV), fl.to(DEV)
        nq = s.shape[0]
        ok = ~fl
        if name.startswith("codes, LUT"):
            ref = tsc.search_codes(index4.scan_index, Xq, k, mode="lut")
        elif name.startswith("codes"):
            ref = tsc.search_codes(index4.scan_index, Xq[:nq], k)
        else:
            # the decoded searches' own flags: a flagged query's rescue
            # (a library matmul) rounds its scores apart from the kernels'
            ix = f32 if "pack=False" in name else index5.scan_index
            *ref, rfl = tsp.search_flagged(ix.Xd, ix.x2, Xq, k,
                                           pack=False if ix is f32 else None)
            ok = ok & ~rfl
            s = s - q2        # the decoded search's dists carry +|q|^2
        print(f"  {name} k={k}: {int(fl.sum())} of {nq} queries flagged")
        raw_close12(f"{name} k={k}", (s, i), ref, q2[:nq], idb, ok,
                    exact="pack=False" in name)
    del f32
    Xtd = torch.as_tensor(Xt, device=DEV)
    G, F = codebook_stats(Xtd, index4.model.train_codes, 256)
    gG, gF = r0["G"].to(DEV), r0["F"].to(DEV)
    print(f"  all-reduced (G, F) against the single-device codebook_stats: "
          f"G equal {bool(torch.equal(gG, G))}, F max |diff| "
          f"{float((gF - F).abs().max()):.3g} (max |F| "
          f"{float(F.abs().max()):.3g})")
    check(torch.equal(gG, G), "the all-reduced G differs")
    check(bool(torch.allclose(gF, F, rtol=1e-5, atol=1e-4 *
                              float(F.abs().max()))),
          "the all-reduced F differs beyond the reduction order")
    same = all(torch.equal(ranks[0][key], ranks[1][key])
               for key in ("sr_C", "cq_C", "cq_R"))
    print(f"  SR-D step objective {r0['sr_obj']:.4f}, ChainQ step "
          f"objectives {r0['cq_obj'].tolist()}; both ranks' codebooks "
          f"(SR-D step, ChainQ) and rotation bit-identical: {same}")
    check(same, "the two ranks' codebooks differ")
    dp = dp_checks12(card, torch.as_tensor(p["Xt"], device=DEV),
                     dict(p["meshless"], sr_d=index4.model), ranks)
    return [r["launches"] for r in ranks], dp


# ---------------------------------------------------------------------------
# Phase 13: the SIFT100M / SIFT1B scale
# ---------------------------------------------------------------------------

# the JAX bench's scale rows (bench.py:34-55, :341-460): 1e9 and 1e8 codes
# resident on the card, 2e8 codes in host memory streamed in shards of 1e8;
# 1,000 queries each
N13B, N13M, N13S, SHARD13, NQ13 = (1_000_000_000, 100_000_000, 200_000_000,
                                   100_000_000, 1000)
# queries held against the oracles at 1e9 and at each 1e8 search
ORACLE13B, ORACLE13M = 32, 64
# the exact-float searches past 2**23 rows: rows of step 2's base, queries
N13F, NQ13F = 20_000_000, 1000
# the segment of the 1e9 base whose lane 0 holds 16 copies of the first
# query's code: the (query, segment) pair the certificate must flag
FLAG13 = 5
# the most a search over the 1e9 base may allocate beyond what was
# allocated before it (bytes)
EXTRA13 = 3_000_000_000
# the kernels of phase 13's path and their launch entry points
PATH13 = {"codes_decode_candidates": "K1", "cand_merge": "K2",
          "tail_merge": "K3", "codes_decode_topk": "K4",
          "codes_lut_candidates": "K5", "scan_candidates": "K8"}
ENTRY13 = {"rq_codes_decode_candidates": "K1", "rq_cand_merge": "K2",
           "rq_tail_merge": "K3", "rq_codes_decode_topk": "K4",
           "rq_codes_lut_candidates": "K5", "rq_scan_candidates": "K8"}


@contextlib.contextmanager
def launch_events(events):
    """Within the block every kernel launch of the scans (`scan.launch`,
    which `scan_codes` imports) is bracketed by two CUDA events on the
    launching stream, appended to ``events`` as ``(entry point, start,
    end)``."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    real = tsp.launch

    def timed_launch(name, *a, device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(device):
            start.record()
            real(name, *a, device=device)
            end.record()
        events.append((name, start, end))
    tsp.launch = tsc.launch = timed_launch
    try:
        yield events
    finally:
        tsp.launch = tsc.launch = real


@contextlib.contextmanager
def flags13(rec, Q):
    """Within the block the searches' repairs are recorded in ``rec``:
    ``"pairs"`` the flagged (query, segment) pairs decode mode's rescue
    took (`scan_codes._rescue`), ``"flagged"`` their queries (indices
    into ``Q``), ``"exact"`` the queries an exact scan served (the LUT
    oracle, `exact_rescan`; matched by their rows of ``Q``) and
    ``"exact_calls"`` those scans' calls."""
    from rayuela_tpu_torch.search import linscan as tls
    from rayuela_tpu_torch.search import scan_codes as tsc
    rescue, lut, ex = tsc._rescue, tsc._lut_scan_tiled, tls.exact_rescan
    rec.update(pairs=0, flagged=set(), exact=set(), exact_calls=0)

    def served(Qx):
        rec["exact_calls"] += 1
        hit = (Qx[:, None, :Q.shape[1]] == Q[None]).all(-1).nonzero()
        rec["exact"] |= set(hit[:, 1].tolist())

    def spy_rescue(Qx, Cf, nrm, index, s, i, flagged, *a, **kw):
        rec["pairs"] += int(flagged.sum())
        rec["flagged"] |= set(flagged.nonzero().flatten().tolist())
        return rescue(Qx, Cf, nrm, index, s, i, flagged, *a, **kw)

    def spy_lut(index, Qx, *a, **kw):
        served(Qx)
        return lut(index, Qx, *a, **kw)

    def spy_ex(Qx, *a, **kw):
        served(Qx)
        return ex(Qx, *a, **kw)
    tsc._rescue, tsc._lut_scan_tiled, tls.exact_rescan = (spy_rescue,
                                                          spy_lut, spy_ex)
    try:
        yield rec
    finally:
        tsc._rescue, tsc._lut_scan_tiled, tls.exact_rescan = rescue, lut, ex


def search13(tag, fn, Q, card, wrappers, zero, reps=3):
    """One search of phase 13: ``fn() -> (dists, ids)`` over the queries
    ``Q`` once with the launch counts set to 0 just before it and read
    just after it (the main path's run; its repairs recorded by
    `flags13`, its peak device memory), then ``reps`` more calls, each
    timed by the host clock to a synchronize and by CUDA events around
    each kernel launch → ``{"res", "launches", "flags", "peak", "before",
    "wall", "kernel_ms", "by_kernel", "walls"}`` (the median wall and its
    call's kernel sums)."""
    import torch
    rec = {}
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero()
    with flags13(rec, Q):
        res = fn()
        torch.cuda.synchronize()
    launches = {n: wrappers[n].launches for n in PATH13}
    peak = torch.cuda.max_memory_allocated()
    runs = []
    for _ in range(reps):
        events = []
        with launch_events(events):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        by = {}
        for name, s, e in events:
            key = ENTRY13.get(name, name)
            by[key] = by.get(key, 0.0) + s.elapsed_time(e)
        runs.append((wall, by, len(events)))
    walls = [w for w, _, _ in runs]
    wall, by, nev = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    kms = sum(by.values())
    print(f"  {tag}: {Q.shape[0] / wall:,.1f} queries/s, wall "
          f"{wall * 1e3:.1f} ms (median of "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}); "
          f"kernels {kms:.1f} ms ({nev} launches: "
          f"{', '.join(f'{k} {v:.1f}' for k, v in sorted(by.items()))}), "
          f"the rest {wall * 1e3 - kms:.1f} ms; flagged (query, segment) "
          f"pairs {rec['pairs']} of {len(rec['flagged'])} queries, "
          f"{len(rec['exact'])} queries served by an exact scan in "
          f"{rec['exact_calls']} calls; launches {launches}; peak "
          f"{peak / 1e9:.3f} GB allocated ({(peak - before) / 1e9:.3f} "
          f"beyond the {before / 1e9:.3f} before the call); {card}")
    return {"res": res, "launches": launches, "flags": rec, "peak": peak,
            "before": before, "wall": wall, "kernel_ms": kms,
            "by_kernel": by, "walls": walls}


def op13():
    """The operand type of the codes searches on ``DEV`` (bfloat16 on
    the card, float32 on the CPU), which their oracles score with."""
    import torch
    return torch.bfloat16 if torch.device(DEV).type == "cuda" \
        else torch.float32


def oracle13(n, seg, k, q2, scores_of, views):
    """The exact top-k of the kernels' own keys over ``n`` rows in
    segments of ``seg``: per segment the plain version's scores of its
    rows (``scores_of(start, stop) -> (stop - start, nq)`` f32), for each
    view ``(first column, last column, tile)`` its columns cut as the
    segment's packed keys cut them (the id bits of its rows padded to
    ``tile``; ``tile=0``: uncut, the exact f32 order), the segment's top k
    by (score, row id), then ``+ q2`` and the merge by (dist, id), as the
    search merges its segments → a ``(dists (nq, k), ids (nq, k) int32)``
    a view. No kernel runs: library calls on the card."""
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.utils import sortable_key, topk_lowest_id
    best = [None] * len(views)
    for st in range(0, n, seg):
        stop = min(st + seg, n)
        S = scores_of(st, stop).T
        for v, (a, b, tile) in enumerate(views):
            sv = S[a:b].contiguous()
            if tile:
                bits = tsp._pack_idbits(-(-(stop - st) // tile) * tile)
                sv = tsp._unsortable_key(sortable_key(sv) & -(1 << bits))
            vals, ids = topk_lowest_id(sv, min(k, stop - st))
            best[v] = tsp.merge_topk(best[v], (vals + q2, ids.int() + st),
                                     k)
        del S, sv
    return best


def hold13(tag, got, ref, q2, step, scores, exact):
    """A search's ``(dists, ids)`` on the oracle's queries against the
    oracle's, by phase 8's set rule: >= 99.9% of ids shared and every id
    one list holds and the other not within two truncation steps
    (``step``, relative) of the oracle's k-th raw score by its own score
    (``scores(q, ids)`` in f64, `unshared`). The share counts the queries
    no exact scan served (``exact``: indices), whose lists hold uncut
    scores; the two-step rule holds every query."""
    import torch
    (gd, gi), (rd, ri) = got, ref
    gi, ri = gi.long(), ri.long()
    kth = rd[:, -1] - q2[:, 0]
    tol = 2 * step * kth.abs() + 1e-5 * q2[:, 0]
    _, ok = unshared(gi, ri, kth, scores, tol)
    keep = torch.tensor([q not in exact for q in range(gi.shape[0])],
                        device=gi.device)
    hits = shared_ids(gi[keep], ri[keep]) if bool(keep.any()) else 1.0
    same = float((gi[keep] == ri[keep]).float().mean())
    dsame = float((gd[keep] == rd[keep]).float().mean())
    print(f"    {tag}: {gi.shape[0]} queries ({int((~keep).sum())} served "
          f"by an exact scan): ids shared {hits:.6f}, equal by position "
          f"{same:.6f}, dists equal by position {dsame:.6f} (nan: every "
          f"query served so); every id not shared within two steps of the "
          f"k-th: {ok}")
    check(hits >= 0.999, f"{tag}: only {hits:.6f} of ids shared")
    check(ok, f"{tag}: an id not shared lies off the boundary")
    return hits


def shape13(tag, res, nq, k, n):
    """The answer's shape: finite dists ``(nq, k)``, ids in [0, n),
    distinct in each row, sorted by (dist, id)."""
    import torch
    d, i = res
    check(d.shape == i.shape == (nq, k), f"{tag}: shape {tuple(d.shape)}")
    check(bool(torch.isfinite(d).all()), f"{tag}: non-finite dists")
    check(bool(((i >= 0) & (i < n)).all()), f"{tag}: ids out of range")
    srt = i.sort(1).values
    check(bool((srt[:, 1:] != srt[:, :-1]).all()), f"{tag}: an id twice")
    up = d[:, 1:] - d[:, :-1]
    check(bool((up >= 0).all()) and bool((i[:, 1:][up == 0]
                                          > i[:, :-1][up == 0]).all()),
          f"{tag}: not sorted by (dist, id)")


def planted13(tag, res, planted, q2, step):
    """Each planted row ``(row, query)`` in its query's top k, its dist
    within one truncation step of the query's first."""
    d, i = res
    for p, j in planted:
        at = (i[j] == p).nonzero().flatten()
        check(at.numel() == 1, f"{tag}: planted row {p} missing from query "
              f"{j}'s top k")
        raw0 = float(d[j, 0] - q2[j, 0])
        gap = float(d[j, at[0]] - d[j, 0])
        check(gap <= step * abs(raw0) + 1e-5 * float(q2[j, 0]),
              f"{tag}: planted row {p} lies {gap:.3g} behind query {j}'s "
              f"first")
    print(f"    {tag}: the {len(planted)} planted rows at the head of their "
          f"queries' lists (rows {sorted({p for p, _ in planted})[:8]}...)")


def boundary_rows13(n, seg):
    """Rows on both sides of the first, second and last segment boundary
    and the last two rows."""
    s = n // seg
    return [seg - 1, seg, 2 * seg - 1, 2 * seg, s * seg - 1, s * seg,
            n - 2, n - 1]


def random_codes13(n, words, gen):
    """``(n, words)`` int32 of uniform random bytes on the card, filled a
    chunk at a time into one buffer (at h = 256 a uniform byte is a
    uniform code): the base's bytes and no more."""
    import torch
    buf = torch.empty(n * words * 4, dtype=torch.uint8, device=DEV)
    step = 1 << 30
    for a in range(0, buf.numel(), step):
        buf[a:a + step].random_(0, 256, generator=gen)
    return buf.view(torch.int32).view(n, words)


def pair_decode13(Qm, Cf, nrm, packed, m, has_norms):
    """``(q, ids) -> `` the decode scan's own scores of single (query,
    row) pairs in f64 (the plain version's decode, `_decode_x2`)."""
    from rayuela_tpu_torch.search import scan_codes as tsc

    def scores(q, ids):
        X, x2 = tsc._decode_x2(Cf, nrm, packed[ids.long()], m, has_norms)
        return (X.double() * Qm[q].double()).sum(-1) + x2.double()
    return scores


def pair_lut13(T, packed, mprime):
    """``(q, ids) ->`` the table sums of single (query, row) pairs in
    f64 over the tables ``T (m', h, nq)``."""
    from rayuela_tpu_torch.search import scan_codes as tsc

    def scores(q, ids):
        codes = tsc.unpack_codes(packed[ids.long()], mprime).long()
        return sum(T[j, codes[:, j], q].double() for j in range(mprime))
    return scores


def phase13_1b(seed, card, pq_index, Xq, wrappers, zero):
    """Step 1: the SIFT1B shape, 1e9 PQ-8 codes resident on the card."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.utils import exact_f32

    seg = tsc._DECODE_SEG
    C, k = pq_index.C, 100
    print(f"== phase 13 (1): SIFT1B shape, {N13B:,} PQ-8 codes resident "
          f"({N13B * 8 / 1e9:.1f} GB), {-(-N13B // seg)} segments, "
          f"{NQ13} queries, k={k} ({card})")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    packed = random_codes13(N13B, 2, gen)
    Q = Xq[:NQ13].contiguous()
    # the first 8 queries' exact PQ encodings on both sides of segment
    # boundaries, and 16 copies of the first one's in lane 0 of a segment
    sub = Q[:8].reshape(8, 8, -1)
    d2 = ((sub[:, :, None, :] - C[None]) ** 2).sum(-1)        # (8, m, h)
    rows = tsc.pack_codes(d2.argmin(-1).to(torch.int32))
    planted = list(zip(boundary_rows13(N13B, seg), range(8)))
    copies = [FLAG13 * seg + t * 128 for t in range(16)]
    packed[torch.tensor([p for p, _ in planted], device=DEV)] = rows
    packed[torch.tensor(copies, device=DEV)] = rows[0]
    planted += [(p, 0) for p in copies]
    index = tsc.CodesIndex(packed, 8, C, pq=True, d=D, norms_cbook=None)
    torch.cuda.synchronize()
    print(f"  base built and planted in {time.perf_counter() - t0:.1f} s")
    rec = search13("decode k=100", lambda: tsc.search_codes(index, Q, k), Q,
                   card, wrappers, zero)
    extra = rec["peak"] - rec["before"]
    check(extra <= EXTRA13, f"1e9 search allocated {extra / 1e9:.3f} GB "
          f"beyond the base ({EXTRA13 / 1e9:.0f} at most)")
    check(all(rec["launches"][n] for n in (
        "codes_decode_candidates", "cand_merge", "tail_merge",
        "codes_decode_topk")), f"1e9: a kernel of the path never launched: "
        f"{rec['launches']}")
    check(0 in rec["flags"]["flagged"], "1e9: the 16 copies in one lane "
          "did not flag their query")
    q2 = (Q * Q).sum(-1, keepdim=True)
    nseg = -(-N13B // seg)
    k1 = rec["by_kernel"].get("K1", 0.0)
    print(f"    K1 per segment ({seg:,} rows x {NQ13} queries): "
          f"{k1 / nseg:.2f} ms over {nseg} segments, "
          f"{k1 / nseg * 1e10 / (seg * NQ13):.2f} ms per 1e10 "
          f"row-queries")
    step = 2.0 ** (tsp._pack_idbits(seg) - 23)
    dists, ids = rec["res"]
    shape13("1e9", rec["res"], NQ13, k, N13B)
    planted13("1e9", rec["res"], planted, q2, step)
    # the oracle: the kernels' own scores (bf16 -2q and codebooks; a PQ
    # row is its codewords side by side, so its score is a sum of
    # tables), then the uncut f32 tables
    t0 = time.perf_counter()
    exact_f32()
    nq = ORACLE13B
    Cf, nrm = index.decode_operands(D, op13())
    Qm = tsp._query_operand(Q[:nq], Cf.shape[1], Cf.dtype).float()
    Cb = Cf.float()
    own = (Cb @ Qm.T + (Cb * Cb).sum(1, keepdim=True)).reshape(8, -1, nq)
    T32 = tsc.build_luts(C, Q[:nq], pq=True, d=D)
    both = torch.cat([own, T32], 2)           # one pass for both oracles
    ref, ref32 = oracle13(N13B, seg, k, q2[:nq], lambda a, b:
                          tsc._lut_scores_fn(both, packed[a:b], b - a)(
                              0, 0, 2 * nq),
                          [(0, nq, tsc._TILE), (nq, 2 * nq, 0)])
    got = (dists[:nq], ids[:nq])
    flags = rec["flags"]
    hold13("1e9 vs the exact scan of its own keys", got, ref, q2[:nq], step,
           pair_decode13(Qm, Cf, nrm, packed, 8, False), flags["exact"])
    hits = shared_ids(ids[:nq], ref32[1])
    kth = ref32[0][:, -1] - q2[:nq, 0]
    _, ok = unshared(ids[:nq].long(), ref32[1].long(), kth,
                     pair_lut13(T32, packed, 8),
                     2 * step * kth.abs() + 1e-5 * q2[:nq, 0])
    print(f"    1e9 vs the exact f32 LUT oracle (uncut f32 tables): ids "
          f"shared {hits:.6f} (ties within a step of 2**-7 of the score "
          f"break by row id in the keys, by score here); every id not "
          f"shared within two steps of the k-th: {ok} (oracles "
          f"{time.perf_counter() - t0:.1f} s)")
    check(ok, "1e9: an id not shared with the f32 LUT oracle lies off the "
          "boundary")
    rec["res"] = None
    return rec


def phase13_100m(seed, card, srd_index, Xq, wrappers, zero):
    """Step 2: the SIFT100M shape, 1e8 SR-D-7+1 codes (the main path's
    index form) → the searches and the codes for step 3."""
    import torch

    import rayuela_tpu_torch.api as rq
    from rayuela_tpu_torch.ops.qerror import reconstruct
    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.norms import (get_norms_codebook,
                                                quantize_norms)
    from rayuela_tpu_torch.utils import exact_f32

    seg = tsc._DECODE_SEG
    C = srd_index.scan_index.C
    print(f"== phase 13 (2): SIFT100M shape, {N13M:,} SR-D-7+1 codes "
          f"resident ({N13M * 8 / 1e9:.1f} GB), {-(-N13M // seg)} segments, "
          f"{NQ13} queries ({card})")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 1)
    packed = random_codes13(N13M, 2, gen)
    # 7 random codes a row. Random codes decode to other norms than the
    # data's (the codebooks' cross terms no longer cancel), so the norms
    # codebook is trained as `index_base` trains one, on the decodes of
    # the codes it serves (2**20 of the rows); each row's last byte is
    # its decode's quantized norm
    exact_f32()
    sample = tsc.unpack_codes(packed[:1 << 20], 7)
    _, ncb = get_norms_codebook(gen, C, sample, h=256)
    own = (reconstruct(C, sample) ** 2).sum(-1)
    ncb4 = srd_index.scan_index.norms_cbook
    qs = own.quantile(torch.tensor([0, .25, .5, .75, 1], device=DEV))
    print(f"  decode norms of the random rows: quartiles "
          f"{[round(float(x), 1) for x in qs]}; "
          f"phase 4's norms codebook (the data's) spans "
          f"[{float(ncb4.min()):.1f}, {float(ncb4.max()):.1f}], the base's "
          f"own [{float(ncb.min()):.1f}, {float(ncb.max()):.1f}]")
    del sample, own
    for a in range(0, N13M, 1 << 21):
        w = packed[a:a + (1 << 21)]
        nco, _ = quantize_norms(C, tsc.unpack_codes(w, 7), ncb)
        hi = (w[:, 1].long() & 0xFFFFFF) | (nco.long() << 24)
        w[:, 1] = torch.where(hi >= 1 << 31, hi - (1 << 32), hi).to(
            torch.int32)
    planted = list(zip(boundary_rows13(N13M, seg), range(8)))
    prow = torch.tensor([p for p, _ in planted], device=DEV)
    Q = Xq[:NQ13].clone()
    # the first 8 queries: the decodes of 8 rows beside segment boundaries
    Q[:8] = reconstruct(C, tsc.unpack_codes(packed[prow], 7))
    index = tsc.CodesIndex(packed, 8, C, pq=False, d=D, norms_cbook=ncb)
    torch.cuda.synchronize()
    print(f"  base built (norms bytes from the decodes) in "
          f"{time.perf_counter() - t0:.1f} s")
    q2 = (Q * Q).sum(-1, keepdim=True)
    out = {}
    for tag, k, kw in (("decode k=1000", 1000, {}),
                       ("decode k=100", 100, {}),
                       ("lut k=100", 100, {"mode": "lut"})):
        rec = search13(tag, lambda: tsc.search_codes(index, Q, k, **kw), Q,
                       card, wrappers, zero)
        want = ("codes_lut_candidates",) if kw else (
            "codes_decode_candidates",)
        check(all(rec["launches"][n] for n in want + ("cand_merge",
                                                      "tail_merge")),
              f"1e8 {tag}: a kernel of the path never launched: "
              f"{rec['launches']}")
        shape13(f"1e8 {tag}", rec["res"], NQ13, k, N13M)
        step = 2.0 ** (tsp._pack_idbits(seg) - 23)
        planted13(f"1e8 {tag}", rec["res"], planted, q2, step)
        out[tag] = rec
    # one `api.search` on the same index: the facade's route to the same
    # result (the 1e8 rows' codes stay packed in the scan index alone; the
    # search reads the model and the scan index)
    zero()
    big = rq.MCQIndex(srd_index.model, None, index, ncb, None, mode="codes")
    fd, fi = rq.search(big, Q, k=1000)
    torch.cuda.synchronize()
    fl = {n: wrappers[n].launches for n in PATH13}
    print(f"  api.search k=1000: launches {fl}")
    check(fl["codes_decode_candidates"] > 0, "api.search never launched K1")
    d0, i0 = out["decode k=1000"]["res"]
    check(torch.equal(fd, d0) and torch.equal(fi, i0),
          "api.search != search_codes at k=1000")
    out["api"] = {"launches": fl}
    # the oracles on the first queries: the exact scan of each search's
    # own keys, one segment at a time
    t0 = time.perf_counter()
    nq = ORACLE13M
    Cf, nrm = index.decode_operands(D, op13())
    Qm = tsp._query_operand(Q[:nq], Cf.shape[1], Cf.dtype)

    def decode_scores(a, b):
        X, x2 = tsc._decode_x2(Cf, nrm, packed[a:b], 7, True)
        return X @ Qm.float().T + x2[:, None]
    ref = oracle13(N13M, seg, 1000, q2[:nq], decode_scores,
                   [(0, nq, tsc._TILE)])[0]
    pair = pair_decode13(Qm, Cf, nrm, packed, 7, True)
    step = 2.0 ** (tsp._pack_idbits(seg) - 23)
    for tag, k in (("decode k=1000", 1000), ("decode k=100", 100)):
        dists, ids = out[tag]["res"]
        # the first k of the merged top-1000 are the merged top-k
        hold13(f"1e8 {tag} vs the exact scan of its own keys",
               (dists[:nq], ids[:nq]), (ref[0][:, :k], ref[1][:, :k]),
               q2[:nq], step, pair, out[tag]["flags"]["exact"])
    T = tsc.build_luts(C, Q[:nq], norms_cbook=ncb).to(op13())
    ref = oracle13(N13M, seg, 100, q2[:nq], lambda a, b:
                   tsc._lut_scores_fn(T, packed[a:b], b - a)(0, 0, nq),
                   [(0, nq, tsc._TILE)])[0]
    dists, ids = out["lut k=100"]["res"]
    hold13("1e8 lut k=100 vs the exact scan of its own keys",
           (dists[:nq], ids[:nq]), ref, q2[:nq], step,
           pair_lut13(T, packed, 8), out["lut k=100"]["flags"]["exact"])
    print(f"    (oracles {time.perf_counter() - t0:.1f} s)")
    for rec in out.values():
        rec.pop("res", None)
    return out, index, Q, planted


def phase13_decoded(card, srd_index, index, Q, planted, wrappers, zero):
    """Step 3: step 2's codes decoded into a bf16 decoded index (the
    base's single copy: `decode_base` fills one buffer)."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc

    seg = tsp._SEG_DECODED
    C, ncb, n = index.C, index.norms_cbook, index.n
    print(f"== phase 13 (3): step 2's {n:,} codes decoded to a bf16 decoded "
          f"index ({n * D * 2 / 1e9:.1f} GB), {-(-n // seg)} segments "
          f"({card})")
    t0 = time.perf_counter()
    B = torch.empty((n, 7), dtype=torch.int32, device=DEV)
    nt = torch.empty(n, dtype=torch.float32, device=DEV)
    for a in range(0, n, 1 << 22):
        codes = tsc.unpack_codes(index.packed[a:a + (1 << 22)], 8)
        B[a:a + (1 << 22)] = codes[:, :7]
        nt[a:a + (1 << 22)] = ncb[codes[:, 7].long()]
    del codes
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dindex = tsp.build_index(C, B, pq=False, d=D, norm_term=nt,
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    del B, nt
    xb = dindex.Xd.numel() * dindex.Xd.element_size()
    print(f"  build_index: {time.perf_counter() - t0:.1f} s, "
          f"{extra / 1e9:.3f} GB allocated at its peak for a "
          f"{xb / 1e9:.3f} GB base")
    # one copy of the base and a decode chunk's temporaries
    check(extra <= xb + 1e9, f"build_index held {extra / 1e9:.3f} GB for a "
          f"{xb / 1e9:.3f} GB base")
    q2 = (Q * Q).sum(-1, keepdim=True)
    step = 2.0 ** (tsp._pack_idbits(seg) - 23)
    out = {}
    for k in (1000, 100):
        tag = f"decoded k={k}"
        rec = search13(tag, lambda: tsp.search(dindex, Q, k), Q, card,
                       wrappers, zero)
        check(all(rec["launches"][n] for n in ("scan_candidates",
                                               "cand_merge", "tail_merge")),
              f"1e8 {tag}: a kernel of the path never launched: "
              f"{rec['launches']}")
        shape13(f"1e8 {tag}", rec["res"], NQ13, k, n)
        planted13(f"1e8 {tag}", rec["res"], planted, q2, step)
        out[tag] = rec
    t0 = time.perf_counter()
    nq = ORACLE13M
    Xd, x2 = dindex.Xd, dindex.x2
    Qm = tsp._query_operand(Q[:nq], Xd.shape[1], Xd.dtype)
    ref = oracle13(n, seg, 1000, q2[:nq], lambda a, b:
                   tsp._decoded_scores_fn(Qm, Xd[a:b], x2[a:b], b - a)(
                       0, 0, nq), [(0, nq, tsp._TILE)])[0]
    for k in (1000, 100):
        tag = f"decoded k={k}"
        dists, ids = out[tag].pop("res")
        hold13(f"1e8 {tag} vs the exact scan of its own keys",
               (dists[:nq], ids[:nq]), (ref[0][:, :k], ref[1][:, :k]),
               q2[:nq], step, row_scores(Qm, Xd, x2),
               out[tag]["flags"]["exact"])
    print(f"    (oracle {time.perf_counter() - t0:.1f} s)")
    return out


def phase13_f32(card, index, Q, wrappers, zero):
    """Step 5: the exact-float scans past 2**23 rows, unsegmented (their
    ids are 32 bits wide): `search_codes(mode="lut", pack=False)` over
    the first `N13F` of step 2's codes (f32 tables: K6 → pair merge →
    K7) and `search(pack=False)` over the same rows decoded into an f32
    decoded index (K9 → pair merge → K10), `NQ13F` queries, k = 100,
    each held by (score, id) to its exact scan (`_lut_scan_tiled`,
    `exact_rescan`): the LUT search's table sums are the oracle's bit
    for bit, the decoded search's fmaf chains sum in another order than
    the exact scan's matmul (PERF.md §2's f32 rule); then the decoded
    rows, overwritten by small integers and searched by integer queries,
    where every score is exact, equal to `exact_rescan` by (score, id)."""
    import torch

    from rayuela_tpu_torch.search import scan as tsp
    from rayuela_tpu_torch.search import scan_codes as tsc
    from rayuela_tpu_torch.search.linscan import exact_rescan

    n, k = N13F, 100
    Qf = Q[:NQ13F].contiguous()
    q2 = (Qf * Qf).sum(-1, keepdim=True)
    sub = tsc.CodesIndex(index.packed[:n], 8, index.C, pq=False, d=D,
                         norms_cbook=index.norms_cbook)
    print(f"== phase 13 (5): pack=False over {n:,} rows (past 2**23, one "
          f"unsegmented call each), {NQ13F} queries, k={k} ({card})")
    out = {}
    path = ("codes_lut_f32_candidates", "pair_merge", "codes_verify_counts")
    zero()
    t0 = time.perf_counter()
    got = tsc.search_codes(sub, Qf, k, mode="lut", pack=False,
                           op_dtype=torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {p: wrappers[p].launches for p in path}
    print(f"  LUT pack=False over {n * 8 / 1e6:.0f} MB of codes: {wall:.2f} s "
          f"(the first call); launches {launches}")
    check(all(launches.values()), f"LUT pack=False at {n}: a kernel of the "
          f"path never launched: {launches}")
    shape13("LUT pack=False 2e7", got, NQ13F, k, n)
    t0 = time.perf_counter()
    rs, ri = tsc._lut_scan_tiled(sub, Qf, k, D, torch.float32)
    same = bool(torch.equal(got[1], ri.int())) and bool(
        torch.equal(got[0], rs + q2))
    print(f"  LUT pack=False == `_lut_scan_tiled` by (score, id) on all "
          f"{NQ13F} queries: {same} (oracle {time.perf_counter() - t0:.1f}"
          f" s)")
    check(same, f"LUT pack=False at {n} rows != its exact scan")
    out["lut"] = launches
    del got, rs, ri
    # the same rows decoded in f32: 10.24 GB
    t0 = time.perf_counter()
    ncb = index.norms_cbook
    B = torch.empty((n, 7), dtype=torch.int32, device=DEV)
    nt = torch.empty(n, dtype=torch.float32, device=DEV)
    for a in range(0, n, 1 << 22):
        codes = tsc.unpack_codes(sub.packed[a:a + (1 << 22)], 8)
        B[a:a + (1 << 22)] = codes[:, :7]
        nt[a:a + (1 << 22)] = ncb[codes[:, 7].long()]
    del codes
    dindex = tsp.build_index(index.C, B, pq=False, d=D, norm_term=nt,
                             dtype=torch.float32)
    del B, nt
    torch.cuda.synchronize()
    print(f"  f32 decoded index of {n:,} rows "
          f"({nbytes(dindex.Xd) / 1e9:.2f} GB) built in "
          f"{time.perf_counter() - t0:.1f} s")
    path = ("scan_f32_candidates", "pair_merge", "verify_counts")
    zero()
    t0 = time.perf_counter()
    got = tsp.search(dindex, Qf, k, pack=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {p: wrappers[p].launches for p in path}
    print(f"  decoded pack=False: {wall:.2f} s (the first call); launches "
          f"{launches}")
    check(all(launches.values()), f"decoded pack=False at {n}: a kernel of "
          f"the path never launched: {launches}")
    shape13("decoded pack=False 2e7", got, NQ13F, k, n)
    t0 = time.perf_counter()
    ref = exact_rescan(Qf, dindex.Xd, dindex.x2, k)
    Qm = tsp._query_operand(Qf, dindex.Xd.shape[1], torch.float32)
    zf = torch.zeros(NQ13F, dtype=torch.bool, device=DEV)
    compare_f32(f"decoded pack=False at {n:,} rows vs exact_rescan "
                f"(oracle {time.perf_counter() - t0:.1f} s)",
                (got[0] - q2, got[1], zf), (ref[0] - q2, ref[1], zf),
                False, row_scores(Qm, dindex.Xd, dindex.x2))
    # the same 2e7 rows overwritten in place by small integers, with
    # integer queries: every score exact, so the search is exact_rescan's
    # by (score, id) on every query
    del got, ref
    g = torch.Generator(device=DEV).manual_seed(N13F)
    dindex.Xd.random_(-3, 4, generator=g)
    for a in range(0, n, 1 << 22):
        xa = dindex.Xd[a:a + (1 << 22)]
        dindex.x2[a:a + (1 << 22)] = (xa * xa).sum(-1)
    Qi = torch.randint(-3, 4, Qf.shape, generator=g, device=DEV).float()
    got = tsp.search(dindex, Qi, k, pack=False)
    ref = exact_rescan(Qi, dindex.Xd, dindex.x2, k)
    same = bool(torch.equal(got[1].long(), ref[1].long())
                and torch.equal(got[0], ref[0]))
    print(f"  decoded pack=False at {n:,} rows of small integers: ids and "
          f"dists identical to exact_rescan on all {NQ13F} queries: {same}")
    check(same, f"decoded pack=False at {n} integer rows != exact_rescan")
    out["decoded"] = launches
    del dindex, got, ref
    torch.cuda.empty_cache()
    return out


def merged_equal13(tag, got, ref, skip):
    """Two searches of the same rows in other segments and shards: on
    every query neither flagged (``skip``) the dists equal by position
    and the ids equal as sets within every group of equal dist but the
    one at position k (merges by (dist, id) where f32 rounding of
    ``+ |q|^2`` can tie dists whose raw scores differ)."""
    import torch
    (gd, gi), (rd, ri) = got, ref
    keep = [q for q in range(gd.shape[0]) if q not in skip]
    gd, gi, rd, ri = (t[keep].cpu() for t in (gd, gi, rd, ri))
    check(torch.equal(gd, rd), f"{tag}: dists differ on an unflagged query")
    for q in range(gd.shape[0]):
        inner = rd[q] != rd[q, -1]
        check(sorted(gi[q, inner].tolist()) == sorted(ri[q, inner].tolist()),
              f"{tag}: ids differ on an unflagged query")
    same = float((gi == ri).float().mean())
    print(f"    {tag}: {len(keep)} unflagged queries, dists equal, ids "
          f"equal by position {same:.6f}")


def phase13_streamed(seed, card, pq_index, Xq, wrappers, zero):
    """Step 4: 2e8 PQ-8 codes in host memory, a numpy array and an
    `np.memmap` over a file, searched in shards of 1e8 rows (each shard
    itself segmented), against the resident search of the same rows."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from rayuela_tpu_torch.search import scan_codes as tsc

    C, k = pq_index.C, 100
    Q = Xq[:NQ13].contiguous()
    print(f"== phase 13 (4): {N13S:,} PQ-8 codes in host memory "
          f"({N13S * 8 / 1e9:.1f} GB), shards of {SHARD13:,} rows, {NQ13} "
          f"queries, k={k} ({card})")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 2)
    host = random_codes13(N13S, 2, gen).cpu().numpy()
    tmp = tempfile.mkdtemp(prefix="rq13_")
    try:
        path = os.path.join(tmp, "codes.i32")
        mm = np.memmap(path, dtype=np.int32, mode="w+", shape=host.shape)
        mm[:] = host
        mm.flush()
        del mm
        mm = np.memmap(path, dtype=np.int32, mode="r", shape=host.shape)
        print(f"  codes made and written to a file in "
              f"{time.perf_counter() - t0:.1f} s")

        def streamed(B):
            return lambda: tsc.search_codes_streamed(
                C, B, Q, k, pq=True, d=D, mprime=8, shard_n=SHARD13)
        out = {"numpy": search13("streamed, numpy", streamed(host), Q,
                                 card, wrappers, zero)}
        # the file was just written: its pages are in the host's cache
        out["memmap"] = search13("streamed, np.memmap (a warm read)",
                                 streamed(mm), Q, card, wrappers, zero,
                                 reps=1)
        del mm
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for form, rec in out.items():
        check(all(rec["launches"][n] for n in ("codes_decode_candidates",
                                               "cand_merge", "tail_merge")),
              f"streamed {form}: a kernel of the path never launched: "
              f"{rec['launches']}")
        shape13(f"streamed {form}", rec["res"], NQ13, k, N13S)
    check(all(torch.equal(a, b) for a, b in zip(out["numpy"]["res"],
                                                out["memmap"]["res"])),
          "the streamed search over the np.memmap != over the array")
    index = tsc.CodesIndex(torch.from_numpy(host).to(DEV), 8, C, pq=True,
                           d=D, norms_cbook=None)
    del host
    res = search13("resident 2e8", lambda: tsc.search_codes(index, Q, k), Q,
                   card, wrappers, zero, reps=1)
    skip = set()
    for rec in (out["numpy"], res):
        skip |= rec["flags"]["flagged"] | rec["flags"]["exact"]
    merged_equal13("streamed vs resident", out["numpy"]["res"], res["res"],
                   skip)
    out["resident"] = res
    for rec in out.values():
        rec.pop("res", None)
    return out


def phase13(seed, card, p13, wrappers, zero):
    """Phase 13: the serving path at the JAX bench's scale rows. Each
    base is released before the next is built → the records of each
    search and the launches of the phase's path, summed over its runs."""
    import torch
    t0 = time.perf_counter()
    out = {"1e9": phase13_1b(seed, card, p13["pq"].scan_index, p13["Xq"],
                             wrappers, zero)}
    torch.cuda.empty_cache()
    out["1e8"], index, Q, planted = phase13_100m(
        seed, card, p13["srd"], p13["Xq"], wrappers, zero)
    out["decoded"] = phase13_decoded(card, p13["srd"], index, Q, planted,
                                     wrappers, zero)
    torch.cuda.empty_cache()
    out["f32"] = phase13_f32(card, index, Q, wrappers, zero)
    del index
    torch.cuda.empty_cache()
    out["streamed"] = phase13_streamed(seed, card, p13["pq"].scan_index,
                                       p13["Xq"], wrappers, zero)
    torch.cuda.empty_cache()
    recs = [out["1e9"], *out["1e8"].values(), *out["decoded"].values(),
            *out["streamed"].values()]
    out["launches"] = {n: sum(r["launches"][n] for r in recs)
                       for n in PATH13}
    print(f"phase-13 launches of its path (each search's counts set to 0 "
          f"just before it and read just after it, summed): "
          f"{ {PATH13[n]: c for n, c in out['launches'].items()} }; "
          f"{time.perf_counter() - t0:.1f} s")
    check(all(out["launches"].values()), "a kernel of phase 13's path never "
          "launched")
    return out


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
    ap.add_argument("--phase13", action="store_true",
                    help="the build, phases 3 and 4 (whose models and "
                    "queries phase 13 serves) and phase 13 alone")
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
              f"buffers, lanes per CTA): K1 keep=4 {tsc._candidates_layout(4, dp, 2, 1, cuda)}"
              f", K14 (28, 4) {tsc._onepass_layout(28, 4, dp, 2, 1, cuda)}; "
              f"K4 (queries, lanes per CTA, CTAs per SM, d-block, shared "
              f"bytes) {tsc._rescue_layout(dp, 2, 48, 1, cuda)}")
        print(f"  layouts at dp={dp}, f32 (the same fields, then lanes per "
              f"CTA): K1 keep=4 {tsc._candidates_layout(4, dp, 2, 0, cuda)}"
              f", K14 (28, 4) {tsc._onepass_layout(28, 4, dp, 2, 0, cuda)}")

    rng = np.random.default_rng(args.seed)
    search_wrappers = {
        "codes_decode_candidates": tsc.codes_decode_candidates,
        "cand_merge": tsc.cand_merge, "tail_merge": tsp.tail_merge,
        "codes_decode_topk": tsc.codes_decode_topk}
    path4 = dict(search_wrappers, icm_sweeps=ticm.icm_sweeps,
                 viterbi_encode=tvit.viterbi_encode)
    # the f32-operand codes search (phase 4f): f32 K1, K14, then K2, K3
    path4f = {"codes_decode_candidates": tsc.codes_decode_candidates,
              "codes_decode_onepass": tsc.codes_decode_onepass,
              "cand_merge": tsc.cand_merge, "tail_merge": tsp.tail_merge}
    path5 = {"scan_candidates": tsp.scan_candidates,
             "codes_lut_candidates": tsc.codes_lut_candidates,
             "cand_merge": tsp.cand_merge, "tail_merge": tsp.tail_merge}
    # the packed search over phase 6's f32 index: f32 K8, then K2, K3
    path6p = {"scan_candidates": tsp.scan_candidates,
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
    # ERVQ and CompQ (phase 10): the codes searches (K1 → K2 → K3, K4 for
    # flagged queries) and ERVQ's decoded search (K8 → K2 → K3)
    path10 = {"codes_decode_candidates": tsc.codes_decode_candidates,
              "cand_merge": tsc.cand_merge, "tail_merge": tsp.tail_merge,
              "scan_candidates": tsp.scan_candidates}
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

    # the wrappers that also count their f32 instance's launches
    f32_wrappers = {n: w for n, w in wrappers.items()
                    if hasattr(w, "launches_f32")}

    def zero():
        for w in wrappers.values():
            w.launches = 0
        for w in f32_wrappers.values():
            w.launches_f32 = 0

    try:
        if not args.phase13:
            run("phase 1", phase1, rng, errs)
            run("phase 1c", phase1c, rng, errs)
            run("phase 1d", phase1d, rng, errs)
            times = run("kernel times", kernel_times, rng, errs)
            run("phase 1b", phase1b, rng, errs)
            times.update(run("encode kernel times", encode_kernel_times,
                             rng, errs))
            run("phase 1e", phase1e, rng, errs)
            run("phase 1f", phase1f, rng, errs)
            times.update(run("K14 and K12 times", onepass_ils_times, rng,
                             errs))
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
        # what phase 13 serves: phase 3's PQ-8 and phase 4's SR-D-7+1
        # indexes (their codebooks) and phase 3's queries
        p13 = {"pq": served["pq"], "srd": served["sr_d"], "Xq": Xq}
        if args.phase13:
            zero()
            run("phase 13", phase13, args.seed, smi, p13, wrappers, zero)
            print(f"chip_smoke: phases 3, 4 and 13 passed in "
                  f"{time.perf_counter() - t_start:.1f} s, the build "
                  f"included")
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": name,
                "count": torch.cuda.device_count()}}))
            return 0
        run("base encode check", base_encode_check, rng, errs,
            served["sr_d"].model, Xb)
        run("C5 check", c5_check, ds, Xq)
        zero()
        res4f = run("phase 4f", phase4f, smi, ds, Xq, served["sr_d"])
        launches4f = {n: w.launches for n, w in path4f.items()}
        launches4f32 = {n: w.launches_f32 for n, w in f32_wrappers.items()
                        if n in path4f}
        print(f"phase-4f launches: {launches4f}; of the f32 instances: "
              f"{launches4f32}")
        check(all(launches4f.values()) and all(launches4f32.values()),
              "a kernel of the f32-operand search never launched in phase "
              "4f")
        times.update(run("phase 4f checks", phase4f_checks, Xq,
                         served["sr_d"], res4f))
        del res4f
        zero()
        index5, res5 = run("phase 5", phase5, smi, ds, Xq, Xb,
                           served["sr_d"])
        # what phase 12 serves: phase 4's codes index, phase 5's decoded
        # index, phase 3's queries and training set
        p12 = dict(index4=served["sr_d"], index5=index5, Xq=Xq, Xt=ds.Xt,
                   gt=ds.gt, meshless={m: served[m].model
                                       for m in ("pq", "rvq")})
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
        res6p = run("phase 6 packed", phase6_packed, smi, ds, Xq, index6)
        launches6p = {n: w.launches for n, w in path6p.items()}
        launches6pf = tsp.scan_candidates.launches_f32
        print(f"phase-6 packed launches: {launches6p}; of f32 K8: "
              f"{launches6pf}")
        check(all(launches6p.values()) and launches6pf > 0,
              "a kernel of the packed search over the f32 index never "
              "launched")
        check(launches6pf == launches6p["scan_candidates"],
              "the packed search over the f32 index launched K8 on bf16 "
              "rows")
        times.update(run("phase 6 packed checks", phase6_packed_checks, errs,
                         Xq, index6, res6p))
        del res6p
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
        launches9f = {n: w.launches_f32 for n, w in f32_wrappers.items()}
        print(f"phase-9 launches: {launches9}; of the f32 instances: "
              f"{launches9f}")
        check(all(launches9.values()), "a kernel of the path never launched "
              "in phase 9")
        wide = run("phase 9 checks", phase9_checks, errs, p9, Xq)
        # K4 at the rescue's few queries stands beside its 128-query time
        wide.update({n: rec for n, rec in times.items() if " " in n})
        wide.update(run("phase 9 encode checks", encode_checks, rng, errs,
                        "m=15", p9["sr_d"].model, p9["Xb"], p9["vit"],
                        " m=15"))
        del p9
        zero()
        p10 = run("phase 10", phase10, args.seed, smi, ds, Xq)
        launches10 = {n: w.launches for n, w in path10.items()}
        print(f"phase-10 launches: {launches10}; K4 (rescues) "
              f"{tsc.codes_decode_topk.launches}")
        check(all(launches10.values()), "a kernel of the path never launched "
              "in phase 10")
        launches10.update({n: w.launches for n, w in wrappers.items()
                           if n not in launches10})
        launches10f = {n: w.launches_f32 for n, w in f32_wrappers.items()}
        run("phase 10 checks", phase10_checks, ds, Xq, p10)
        p12["meshless"].update(p10["models"])
        del p10, ds
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
        _, deep = run("diagnostics 5", deep_merges, diagnostics5, index5,
                      served["sr_d"], Xq)
        run("phase 6 checks", phase6_checks, Xq, served["sr_d"], index6, res6)
        res6d = run("phase 6 deep", phase6_deep, smi, Xq, index6,
                    served["sr_d"], wrappers, zero)
        run("phase 6 deep checks", phase6_deep_checks, errs, times, Xq,
            index6, served["sr_d"], res6d)
        # the key modes over phase 5's bf16 and phase 6's f32 index
        bodies = {"bf16": index5, "f32": index6}
        res5m, launches5m = run("phase 5m", phase5m, smi, Xq, bodies,
                                wrappers, zero)
        run("phase 5m checks", phase5m_checks, rng, errs, times, Xq, bodies,
            res5m)
        del res6, index6, res6d, res5m, bodies
        run("phase 7 checks", phase7_checks, Xq, Xb, served["sr_d"], res7)
        del res7, Xb
        deep += run("plan sweep", deep_merges, plan_sweep, index5,
                    served["sr_d"], Xq)[1]
        print(f"K2 launches at r = 96 (the k = 4096 and 8192 plans) in the "
              f"diagnostics and the plan sweep: {deep}")
        times["cand_merge k=4096"]["launches"] = deep
        res_deep = run("deep band", deep_band, smi, Xq, index5,
                       served["sr_d"], wrappers, zero)
        run("deep band checks", deep_band_checks, errs, times, Xq, index5,
            served["sr_d"], res_deep)
        del res_deep
        # the deep instances of K2, K3 and the pair merge: times at the
        # deep plans' shapes, launches of the deep band's and phase 6
        # deep's searches
        wide.update({n: times[n] for n in (
            f"cand_merge k={DEEP_K[-1]}", f"tail_merge k={DEEP_K[-1]}",
            f"pair_merge k={F32_DEEP_K[-1]}")})
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
        wide_f32 = {f"scan_candidates f32 d={D8}":
                    wide.pop("scan_candidates f32")}
        wide.update(run("phase 8 rescue", rescue8, errs, p8))
        for w in f32_wrappers.values():
            w.launches_f32 = 0
        res8f = run("phase 8 f32", phase8_f32, p8)
        launches8f = {n: w.launches_f32 for n, w in f32_wrappers.items()}
        print(f"phase-8 f32 launches of the f32 instances: {launches8f}")
        check(launches8f["codes_decode_candidates"] > 0,
              "phase 8's f32 search never launched f32 K1")
        check(launches8f["scan_candidates"] > 0,
              "phase 8's packed search over the f32 index never launched "
              "f32 K8")
        run("phase 8 f32 checks", phase8_f32_checks, errs, p8, res8f)
        del res8f
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
        del fus
        torch.cuda.empty_cache()
        zero()
        p12["sift1m"] = run("phase 11", phase11, args.seed, smi)["sift1m"]
        launches11 = {n: w.launches for n, w in wrappers.items()}
        launches11f = {n: w.launches_f32 for n, w in f32_wrappers.items()}
        print(f"phase-11 launches: {launches11}; of the f32 instances: "
              f"{launches11f}")
        check(all(launches11[n] for n in PATH11), "a kernel of the "
              "protocols' path never launched in phase 11")
        run("phase 11 (e)", phase11_xvecs, rng)
        zero()
        res12a = run("phase 12 (a)", phase12a, args.seed, smi, p12)
        launches12a = res12a["launches"]
        zero()
        rank_launches, dp12b = run("phase 12 (b)", phase12b, args.seed,
                                   smi, p12)
        ref12 = _counts12()
        launches12r = {n: res12a["ref_launches"][n] + c
                       for n, c in ref12.items()}
        launches12 = {n: launches12a.get(n, 0)
                      + sum(r.get(n, 0) for r in rank_launches)
                      for n in wrappers}
        launches12f = {n: launches12a[f"{n} f32"]
                       + sum(r[f"{n} f32"] for r in rank_launches)
                       for n in F32_12}
        print(f"phase-12 launches of the multi-GPU path: (a), the mesh= "
              f"training and searches in this process: {launches12a}; "
              f"(b), rank 0: {rank_launches[0]}; rank 1: "
              f"{rank_launches[1]}; in all: "
              f"{ {n: launches12[n] for n in PATH12} }; of the f32 "
              f"instances: {launches12f}")
        print(f"phase-12 launches of the single-device references (not "
              f"counted above): {launches12r}")
        check(all(launches12[n] for n in PATH12), "a kernel of the "
              "multi-GPU path never launched in phase 12")
        check(all(launches12a[n] for n in ("icm_sweeps", "viterbi_encode",
                                           "codes_lut_candidates",
                                           "scan_candidates")),
              "phase 12 (a) did not train and search through the kernels")
        check(all(r[n] for r in rank_launches for n in PATH12),
              "a rank of phase 12 (b) never launched a kernel of its path")
        del res12a
        del p12
        torch.cuda.empty_cache()
        zero()
        run("phase 13", phase13, args.seed, smi, p13, wrappers, zero)
        del p13
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
    # the f32 instances of K1 and K14 (the cluster fmaf body): launches of
    # phase 4f, times at its shapes; f32 K8 (K9's body with the packed-key
    # sink): launches of phase 6's packed search, times at its shapes and
    # at d = 960
    f32_on = {**{n: ("phase 4f", launches4f32[n]) for n in launches4f32},
              "scan_candidates": ("phase 6, packed search over the f32 index",
                                  launches6pf)}
    f32 = [{"name": f"{n} (f32 operands)", "route": "cuda",
            "source": SOURCES[n], "replaces": REPLACES[n],
            "launches": f32_on[n][1], "launches_in": f32_on[n][0],
            "max_abs_err": errs[f"{n} f32"], **times[f"{n} f32"],
            "launches_wide": {"phase 8": launches8f[n],
                              "phase 9": launches9f[n]},
            "launches_phase10": launches10f[n],
            "launches_phase11": launches11f[n],
            "launches_phase12": launches12f[n],
            "wide": wide_f32 if n == "scan_candidates" else {}}
           for n in ("codes_decode_candidates", "codes_decode_onepass",
                     "scan_candidates")]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n],
         "replaces": REPLACES[n], "launches": on_path[n][1],
         "launches_in": on_path[n][0], "max_abs_err": errs[n], **times[n],
         "launches_wide": {"phase 8": launches8.get(n, 0),
                           "phase 9": launches9.get(n, 0)},
         "launches_phase10": launches10[n],
         "launches_phase11": launches11[n],
         "launches_phase12": launches12[n],
         "wide": wide_by.get(n, {})}
        for n in wrappers] + f32 + [
        {"name": f"scan_candidates ({mode}"
                 f"{', f32 operands' if body == 'f32' else ''})",
         "route": "cuda", "source": "rayuela_tpu_torch/csrc/decoded_modes.cu",
         "replaces": REPLACES["scan_candidates"],
         "launches": launches5m[body][f"launches_{mode}"],
         "launches_in": "phase 5m", "max_abs_err": errs[key],
         **times[key]}
        for body in ("bf16", "f32") for mode in ("qbias", "score16", "premin")
        for key in [f"scan_candidates {mode}"
                    + (" f32" if body == "f32" else "")]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
