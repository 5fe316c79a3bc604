// Code-resident scan kernels for Hopper (sm_90a): K1, K2, K4 and K14, and
// the pair merge of the exact-float scans (K9, K6).
//
// Replaces (rayuela_tpu/search/scan_codes_pallas.py):
//   K1  codes_decode_candidates <- _codes_decode_kernel_candidates (:384,
//                                  launched at :727)
//   K2  cand_merge              <- _cand_merge_kernel (:424, at :761)
//   K4  codes_decode_topk       <- _codes_decode_kernel_packed (:318) with
//                                  keep = 0, launched at :613
//   K14 codes_decode_onepass    <- the keep > 0 bodies launched at :613:
//                                  _codes_decode_kernel_packed (:318),
//                                  _codes_decode_kernel_packed_multi
//                                  (:332, qsuper) and _staged (:365)
//   pair_merge                  <- the running (r, 128, bq) buffer of
//                                  _scan_kernel (scan_pallas.py) and
//                                  _codes_scan_kernel: its merge across
//                                  the sequential tile axis
//
// K4 is the one-pass body of scan_common.cuh (which states the key and
// selection contract) over the row source of this file. K1 and K14 are
// one body per operand type, shared over a cluster of CTAs
// (`codes_mma_kernel` on bf16, `codes_f32_kernel` on f32, below, which
// say why), K14 being K1 with a loop over the tiles inside the CTA: K1 ->
// K2's function at (r, keep, tile) in one pass, with no candidate array
// in device memory. A row decodes to x_hat = sum_j Cflat[j*h + code_j]
// (f32, codebook order), rounded to the operand type; its norm x2 is
// |x_hat|^2 of the f32 row (PQ) or nrm[norm_code] (additive models).
// Beyond dp = 256 a row decodes and scores in d-blocks of 128, the
// codebook rows summed in codebook order within each block. K4 takes the
// score function of K1 and K14 on either operand type: the three give the
// same keys.
//
// What bounds them on the card. K1 and K14 do n*nq*dp multiply-adds (on
// the tensor cores for bf16, in fmaf chains on the CUDA cores for f32) and
// decode every row once per cluster of query blocks: m codebook rows of dp
// values gathered from Cflat, which sits in L2 (m*h*dp operands, too large
// for L1 beside the rows). The decode reads Cflat 16 bytes per thread,
// coalesced, with several codebook loads in flight per thread: a decode
// that waited on one 2-byte load at a time was latency-bound. Each body
// says what bounds it. K2 and K4's selection is register insertion into a
// sorted array: after the first few rows nearly every key is rejected by
// one compare. K2 is bound by reading its candidate array (coalesced:
// consecutive threads take consecutive queries) and at deep buffers by
// its insertions; it says below how it uses the ascending runs its
// callers write.
// K4 scores K1's products for the flagged queries and decodes every row
// once per query block of its CTA (32 queries; 16 where a wide f32 row
// needs it), 32 rows of a lane group at a time (`decode_lanes`; the
// one-pass body of scan_common.cuh says why); with few queries its row
// range is split over CTAs, and the splits trade its waves against K2's
// merge of them (`rq_codes_topk_layout` reports the layout the wrapper
// splits from). K14's clusters walk whole tile ranges, so the wrapper
// splits the rows until the waves fill the card's cluster slots
// (`rq_codes_onepass_layout` reports them), or a last wave part-empty
// would cost as much as a full one.
#include "scan_common.cuh"

namespace {

constexpr int DEC_BATCH = 8;   // codebook loads a decoding thread keeps in flight
constexpr int K14_PAIRS = 16;  // (lane, query) pairs of a K14 thread (4 x 4)
// buffer loads a K14 tile-end merge keeps in flight (`merge_survivors`)
constexpr int MERGE_BATCH = 7;

// The 16 bytes of dimensions [col, col + V) of a row with codes `wl`:
// sum_j Cflat[j*h + code_j] in codebook order, f32, to acc[0..V). Up to
// BATCH codebook loads are issued before any is added, so their L2
// latencies overlap (the sum does not depend on BATCH).
template <typename T, int BATCH = DEC_BATCH>
__device__ __forceinline__ void decode_chunk(const T* __restrict__ Cflat,
                                             const int* wl, int m, int h,
                                             int dp, int col,
                                             float (&acc)[Vec16<T>::N]) {
#pragma unroll
  for (int e = 0; e < Vec16<T>::N; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < m; j0 += BATCH) {
    uint4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (j0 + u < m)
        v[u] = __ldg(reinterpret_cast<const uint4*>(
            Cflat + (size_t)((j0 + u) * h + code_of(wl, j0 + u)) * dp +
            col));
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (j0 + u < m) Vec16<T>::add(v[u], acc);
  }
}

// Sixteen bytes of T holding the values of acc[0..N) rounded to T (round
// to nearest even, as torch's .to(torch.bfloat16) does).
__device__ __forceinline__ uint4 pack16(const float (&acc)[4]) {
  return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                    __float_as_uint(acc[2]), __float_as_uint(acc[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&acc)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i])) |
           ((unsigned)__bfloat16_as_ushort(
                __float2bfloat16_rn(acc[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Dimensions [b0, b0 + cpr * V) of one row with codes `wl`, decoded by
// the G threads of its group (t: the thread's lane in the warp): each
// takes the 16-byte chunks c = t % G, t % G + G, ... in ascending order,
// hands each to store(c, the chunk rounded to T) and sums the squares of
// its f32 values; the G sums then add in a shuffle tree. Returns the
// row's |x_hat|^2 over the block, in every thread of the group. K1, K14
// and K4 decode through this one function, so their rows and norms are
// bit for bit the same.
template <typename T, int BATCH, class Store>
__device__ __forceinline__ float decode_row(const T* __restrict__ Cflat,
                                            const int* wl, int m, int h,
                                            int dp, int b0, int cpr, int G,
                                            int t, Store store) {
  constexpr int V = Vec16<T>::N;
  float part = 0.f;
  for (int c = t % G; c < cpr; c += G) {
    float acc[V];
    decode_chunk<T, BATCH>(Cflat, wl, m, h, dp, b0 + c * V, acc);
    store(c, pack16(acc));
#pragma unroll
    for (int e = 0; e < V; ++e) part += acc[e] * acc[e];
  }
  for (int o = G >> 1; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  return part;
}

// Decode dimensions [b0, b0 + nb) of the NL lanes [l0, l0 + NL) of the
// NR row ids rid .. rid + NR - 1 (dp values a row), stored row by row at
// the operand type: row j < NR * NL (row id rid + j / NL, lane l0 + j %
// NL) at Xs[j * xs + kk], its norm at x2s[j]: the norms byte's entry, or
// |x_hat|^2 of the f32 row (the PQ layout), which a block at b0 > 0 adds
// to the earlier blocks' sum (the one-pass body's layout). The codes load
// at b0 = 0 and stay for the row's later blocks. G threads share a row
// (`decode_row`), so a warp's loads are coalesced. With xns, a row of one
// d-block also gives the norm of its f32 values at xns[j]
// (`score_slack`). Ends with a barrier.
template <typename T, int NL, int NR>
__device__ void decode_lanes(const T* __restrict__ Cflat,
                             const T* __restrict__ nrm,
                             const int* __restrict__ packed, int n, int rid,
                             int l0, int m, int h, int nw, int b0, int nb,
                             int dp, int has_norms, T* Xs, int xs,
                             float* x2s, int* words, float* xns) {
  constexpr int V = Vec16<T>::N, ROWS = NL * NR;
  const int tid = threadIdx.x;
  if (b0 == 0) {
    for (int i = tid; i < ROWS * nw; i += blockDim.x) {
      const int j = i / nw;
      const long long gid = (long long)(rid + j / NL) * LANES + l0 + j % NL;
      words[i] = gid < n ? packed[gid * nw + i % nw] : 0;
    }
    __syncthreads();
  }
  const int cpr = nb / V;              // 16-byte chunks per row
  const int G = cpr < 32 ? cpr : 32;   // threads per row (a power of 2)
  const int t = tid & 31, per_warp = 32 / G;
  const int row_step = (blockDim.x >> 5) * per_warp;
  // ROWS (32) is a multiple of per_warp (G >= 16 at nb >= 128), so a
  // warp's threads take the loop and the shuffles together
  for (int j = (tid >> 5) * per_warp + t / G; j < ROWS; j += row_step) {
    const int* wl = words + j * nw;
    const float part = decode_row<T, DEC_BATCH>(
        Cflat, wl, m, h, dp, b0, cpr, G, t, [&](int c, uint4 v) {
          *reinterpret_cast<uint4*>(Xs + j * xs + c * V) = v;
        });
    if (t % G == 0) {
      x2s[j] = has_norms ? to_f32(nrm[(size_t)code_of(wl, m) * LANES])
                         : (b0 == 0 ? part : x2s[j] + part);
      if (xns) xns[j] = sqrtf(part);
    }
  }
  __syncthreads();
}

// Row source of K4 (the one-pass body of scan_common.cuh) and the
// operands of K1 and K14 (their own bodies, below): rows decoded from
// their packed codes.
template <typename T> struct CodesSrc {
  using Op = T;
  // bf16 rows score on the tensor cores (K4 here; K1 and K14 in their own
  // body below)
  static constexpr bool kTensorScores = std::is_same<T, __nv_bfloat16>::value;
  const T* Cflat;
  const T* nrm;
  const int* packed;
  int m, h, nw, has_norms;
  __host__ __device__ int lane_words() const { return nw; }
  template <int NL, int NR>
  __device__ __forceinline__ void load_lanes(int n, int rid, int l0, int b0,
                                             int nb, int dp, T* Xs, int xs,
                                             float* x2s, int* words,
                                             float* xns = nullptr) const {
    decode_lanes<T, NL, NR>(Cflat, nrm, packed, n, rid, l0, m, h, nw, b0, nb,
                            dp, has_norms, Xs, xs, x2s, words, xns);
  }
};

// K2: one thread per (lane, query). The R smallest candidate keys
// ascending to out[0..R), then min(every discard, every candidate not
// kept) to out[R].
//
// The candidates arrive in runs, each ascending per (lane, query): a
// tile's keep smallest keys (the two-pass scans' per-tile cut) or a
// split's sorted buffer (the one-pass kernels' splits), which the wrapper
// hands over as runs of `run` = 4, 2 or 1 of its rows (`scan._merge_runs`:
// the pieces of an ascending run ascend). With `cut`, disc[t] is the next
// key of run t's tile, never below the run's last key; without, it is
// any certificate.
//
// What bounds it on the card: reading the candidates (coalesced:
// consecutive threads take consecutive queries) with enough loads in
// flight, and, at deep buffers, the insertions: after the first R
// candidates a (lane, query) takes about R ln(ncand / R) more, and a warp
// pays for the busiest of its 32. So:
// - the first R candidates, which always enter, are loaded together and
//   sorted once by a network (`sort_keys`), skipping the merges that the
//   runs' ascending blocks make needless;
// - a run's next member is loaded only where the member before may enter
//   (is below the buffer's R-th key when tested): once a member fails,
//   the rest of its run, no smaller, can neither enter nor lower `rest`
//   below it. With `cut`, disc[t] is read only where the whole run may
//   have entered (else `rest` is at most the member that failed, at most
//   disc[t]); without, every discard row is read at the end;
// - the runs go in batches of CM_BATCH, each member's loads issued
//   before the insertions of the one before, so that their latencies hide
//   under them. Runs of 4 go batch by batch, member after member
//   ("rounds"), the next batch's first members loaded ahead where
//   CM_AHEAD(R) and each batch's discards taken in the next; runs of 2
//   or 1 as a wavefront (`wave_step`), in which each step merges the
//   first members of one batch, the second of the batch before and the
//   discards of the one before that, so that a step waits on its loads
//   once. For runs of 4 the wavefront's deeper lag let more keys past a
//   staler threshold and was slower;
// - an insertion computes every slot from the old buffer by one min and
//   one max (`key_insert`): no step waits on another. At R = 96 and 128
//   (the k <= 8192 and k <= 12288 plans) a thread stages up to 16 keys
//   and the warp merges them into its buffers together by a bitonic
//   merge (`merge_staged`): about two fifths of the min / max operations
//   of inserting each key on its own, at the price of one CTA an SM
//   (2.93 against 3.84 ms on the k = 4096 plan's chunk); at R = 48 the
//   two CTAs an SM of plain insertions were faster (2.32 against 2.76 ms
//   at the k = 3072 plan). At R = 128 the buffer and the stage take 255
//   registers and the runs-of-4 instance spills ~120 bytes; a stage of 8
//   spilled as much and was slower (3.04 against 2.60 ms on the
//   k = 12288 plan's chunk of 1,609 queries, demos/time_exact.py).
// The outputs are the same bits whatever the order of the insertions.
// At n = 1e6, nq = 1e4 (NVIDIA H100 80GB HBM3, 700 W; demos/time_exact.py
// --only cand_merge): 0.76 / 1.60 / 2.29 ms at the k = 100 / 1000 / 3072
// plans and 2.69 on the k = 4096 plan's chunk of 3,216 queries (a design
// that took one row at a time: 1.04 / 2.32 / 3.85 / 7.72), against a
// bound of 0.337 / 0.428 / 0.503 / 0.459 (the bytes these inputs require
// at 3.35 TB/s, `chip_smoke.merge_needs`). On keys that rise row after
// row, where only the runs' first members are read and none enters, it
// takes 0.34 / 0.44 / 0.52 / 0.76 against 0.238 / 0.287 / 0.336 / 0.335:
// the later members' dependent loads and the insertions cost the rest.
constexpr int CM_BATCH = 8;
// whether the next batch's first members are loaded before a batch is
// merged, and the CTAs an SM must hold (`__launch_bounds__`)
template <int R>
constexpr bool CM_AHEAD = R <= 32;
template <int R>
constexpr int CM_CTAS = R > 48 ? 1 : 2;
// keys a thread stages before it merges them into its buffer together
// (`merge_staged`; 0: each key is inserted on its own)
template <int R>
constexpr int CM_STAGE = R > 48 ? 16 : 0;

__host__ __device__ constexpr int log2_ceil(int x) {
  int lg = 0;
  while ((1 << lg) < x) ++lg;
  return lg;
}

__device__ __forceinline__ void cas_keys(int& a, int& b) {
  const int lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

// Sort buf ascending: a bitonic network whose merges all compare upward
// (a merge's first step pairs slot i with its mirror in the block), over
// the R keys padded with +inf to a power of two, so that a comparator
// reaching past R - 1 would do nothing and is left out. Aligned blocks of
// `sorted` keys (a power of two) that arrive ascending skip the merges up
// to that size.
template <int R>
__device__ __forceinline__ void sort_keys(int (&buf)[R], int sorted) {
#pragma unroll
  for (int lg = 1; lg <= log2_ceil(R); ++lg) {
    if ((1 << lg) <= sorted) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = i ^ ((1 << lg) - 1);
      if (j > i && j < R) cas_keys(buf[i], buf[j]);
    }
#pragma unroll
    for (int ls = lg - 2; ls >= 0; --ls)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int j = i ^ (1 << ls);
        if (j > i && j < R) cas_keys(buf[i], buf[j]);
      }
  }
}

// Insert x, x < buf[R - 1], into the ascending buffer; its last key joins
// `rest`. Slot i takes the middle of (buf[i - 1], x, buf[i]).
template <int R>
__device__ __forceinline__ void key_insert(int (&buf)[R], int& rest, int x) {
  rest = min(rest, buf[R - 1]);
#pragma unroll
  for (int i = R - 1; i > 0; --i) buf[i] = max(buf[i - 1], min(x, buf[i]));
  buf[0] = min(x, buf[0]);
}

// Slot i of the bitonic sequence that `merge_staged` sorts: P - R - S
// slots of -inf (left out: no comparator moves them), the buffer
// ascending, the staged keys descending.
template <int R, int S>
__device__ __forceinline__ int& staged_slot(int (&buf)[R], int (&stg)[S],
                                            int i) {
  constexpr int P = 1 << log2_ceil(R + S), o = P - R - S;
  return i < o + R ? buf[i < o ? 0 : i - o] : stg[i < P ? P - 1 - i : 0];
}

// Merge the S ascending staged keys into the ascending buffer by a
// bitonic merge: the R smallest stay in buf, the smallest of the others
// joins `rest`, and the stage empties (INT_MAX).
template <int R, int S>
__device__ __forceinline__ void merge_staged(int (&buf)[R], int (&stg)[S],
                                             int& rest) {
  constexpr int LG = log2_ceil(R + S), P = 1 << LG, o = P - R - S;
#pragma unroll
  for (int ls = LG - 1; ls >= 0; --ls)
#pragma unroll
    for (int i = o; i < P; ++i) {
      const int j = i + (1 << ls);
      // two buffer keys meet only in order in the first step
      if (!(i >> ls & 1) && j < P && (ls < LG - 1 || j >= o + R))
        cas_keys(staged_slot(buf, stg, i), staged_slot(buf, stg, j));
    }
  rest = min(rest, stg[S - 1]);
#pragma unroll
  for (int c = 0; c < S; ++c) stg[c] = INT_MAX;
}

// min over rows [a, b) of p[row * plane], B loads in flight
template <int B>
__device__ __forceinline__ int min_rows(const int* p, size_t plane, int a,
                                        int b) {
  int m = INT_MAX;
  for (int row = a; row < b; row += B) {
    int v[B];
#pragma unroll
    for (int u = 0; u < B; ++u)
      v[u] = row + u < b ? __ldcs(p + (size_t)(row + u) * plane) : INT_MAX;
#pragma unroll
    for (int u = 0; u < B; ++u) m = min(m, v[u]);
  }
  return m;
}

// The members x of a batch of runs that may enter the buffer (below its
// R-th key); the others join `rest`.
template <int R, int B>
__device__ __forceinline__ unsigned may_enter(const int (&x)[B],
                                              const int (&buf)[R],
                                              int& rest) {
  const int thr = buf[R - 1];
  unsigned take = 0;
#pragma unroll
  for (int u = 0; u < B; ++u) {
    if (x[u] < thr)
      take |= 1u << u;
    else
      rest = min(rest, x[u]);
  }
  return take;
}

// Insert the members `take` of x in order, each tested again against the
// buffer's R-th key (with a stage: staged, after the warp has merged its
// stages together where one could overflow) → the members that entered.
template <int R, int B, int S>
__device__ __forceinline__ unsigned enter(const int (&x)[B], unsigned take,
                                          int (&buf)[R],
                                          int (&stg)[S > 0 ? S : 1],
                                          int& nstg, int& rest) {
  if constexpr (S > 0) {
    if (__any_sync(~0u, nstg + __popc(take) > S)) {
      merge_staged(buf, stg, rest);
      nstg = 0;
    }
  }
  unsigned in = 0;
  for (unsigned rem = take; rem; rem &= rem - 1) {
    const int uu = __ffs(rem) - 1;
    int v = x[0];
#pragma unroll
    for (int u = 1; u < B; ++u)
      if (u == uu) v = x[u];
    if (v >= buf[R - 1]) {
      rest = min(rest, v);
      continue;
    }
    if constexpr (S > 0) {
      key_insert<S>(stg, rest, v);
      ++nstg;
    } else {
      key_insert<R>(buf, rest, v);
    }
    in |= 1u << uu;
  }
  return in;
}

// Stage M of a step of K2's wavefront, then the stages below it (see the
// kernel): stage M < run holds member M of the batch of runs t0 - M B,
// stage `run` their discards.
template <int M, int R, int B, int S>
__device__ __forceinline__ void wave_step(int (&v)[3][B], int (&buf)[R],
                                          int (&stg)[S > 0 ? S : 1],
                                          int& nstg, int& rest, const int* cp,
                                          const int* dp, size_t plane,
                                          size_t rstride, int run, int cut,
                                          int t0) {
  if constexpr (M >= 0) {
    if (M == run) {  // discards, where a whole run may have entered
#pragma unroll
      for (int u = 0; u < B; ++u) rest = min(rest, v[M][u]);
    } else if (M < run) {
      const int tb = t0 - M * B;
      const unsigned take = may_enter(v[M], buf, rest);
      if constexpr (M < 2) {
        const bool last = M + 1 == run;
#pragma unroll
        for (int u = 0; u < B; ++u)
          v[M + 1][u] =
              (take >> u & 1) && (cut || !last)
                  ? __ldcs(last ? dp + (size_t)(tb + u) * plane
                                : cp + (tb + u) * rstride +
                                      (size_t)(M + 1) * plane)
                  : INT_MAX;
      }
      enter<R, B, S>(v[M], take, buf, stg, nstg, rest);
    }
    wave_step<M - 1, R, B, S>(v, buf, stg, nstg, rest, cp, dp, plane,
                              rstride, run, cut, t0);
  }
}

template <int R, bool WAVE>
__global__ void __launch_bounds__(THREADS, CM_CTAS<R>)
    cand_merge_kernel(const int* __restrict__ cand,
                      const int* __restrict__ disc, int* __restrict__ out,
                      int ncand, int ndisc, int nq, int run, int cut) {
  constexpr int B = CM_BATCH, S = CM_STAGE<R>;
  static_assert(S == 0 || S >= B, "a stage takes up to B keys at once");
  const size_t plane = (size_t)LANES * nq;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int* cp = cand + idx;
  const int* dp = disc + idx;
  const size_t rstride = (size_t)run * plane;
  const int fill = min(R, ncand);
  int buf[R];
#pragma unroll
  for (int c = 0; c < R; ++c)
    buf[c] = c < fill ? __ldcs(cp + (size_t)c * plane) : INT_MAX;
  // the fill is a prefix of one run, or aligned blocks of the largest
  // power of two that divides the run length, each ascending
  sort_keys<R>(buf, fill <= run ? 1 << 30 : run & -run);
  int rest = INT_MAX;
  int t = fill / run;  // runs wholly in the fill
  if (cut) rest = min_rows<B>(dp, plane, 0, t);
  int j = fill - t * run;  // members of run t in the fill
  if (j) {
    for (; j < run; ++j) {
      const int x = __ldcs(cp + t * rstride + (size_t)j * plane);
      if (x >= buf[R - 1]) {
        rest = min(rest, x);
        break;
      }
      key_insert<R>(buf, rest, x);
    }
    if (cut && j == run) rest = min(rest, __ldcs(dp + (size_t)t * plane));
    ++t;
  }
  const int nruns = ncand / run;
  // the first members of the batch of runs at t0 (INT_MAX: none)
  auto firsts = [&](int (&v)[B], int t0) {
#pragma unroll
    for (int u = 0; u < B; ++u)
      v[u] = t0 + u < nruns ? __ldcs(cp + (t0 + u) * rstride) : INT_MAX;
  };
  int stg[S ? S : 1];  // the staged keys, ascending (INT_MAX: none)
  int nstg = 0;
#pragma unroll
  for (int c = 0; c < (S ? S : 1); ++c) stg[c] = INT_MAX;
  // The wavefront: at the step of batch t0, stage m < run holds member m
  // of the batch t0 - m B and stage `run` its discards, each loaded in
  // the step before. The stages go from the top down: each folds into
  // `rest` what cannot enter, loads the next member (or the discard) of
  // the runs whose member may enter into the stage above, which it has
  // just emptied, then inserts its keys; stage 0 then takes the next
  // batch's first members. A member that turns out not to enter leaves
  // the one loaded after it no smaller, to fold into `rest` in its turn.
  if constexpr (WAVE) {
    int v[3][B];
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int u = 0; u < B; ++u) v[m][u] = INT_MAX;
    firsts(v[0], t);
    for (int t0 = t; t0 - run * B < nruns; t0 += B) {
      int xn[B];
      if constexpr (CM_AHEAD<R>) firsts(xn, t0 + B);
      wave_step<2, R, B, S>(v, buf, stg, nstg, rest, cp, dp, plane,
                            rstride, run, cut, t0);
      if constexpr (CM_AHEAD<R>) {
#pragma unroll
        for (int u = 0; u < B; ++u) v[0][u] = xn[u];
      } else {
        firsts(v[0], t0 + B);
      }
    }
  } else {
    int x[B];  // member j of each run of the batch (INT_MAX: none)
    firsts(x, t);
    // the discards of the batch before's runs that entered whole, loaded
    // there and taken here, so that no batch waits on its own
    int dv[B] = {};
    unsigned din = 0;
    for (; t < nruns; t += B) {
      const int* c0 = cp + t * rstride;
      int xn[B];
      if constexpr (CM_AHEAD<R>) firsts(xn, t + B);
      for (int j = 0;; ++j) {
        const unsigned take = may_enter(x, buf, rest);
        // with a stage, the warp goes through the rounds together
        if (S ? !__any_sync(~0u, take) : !take) break;
        // the next member of the runs that may enter (after the last one,
        // their discards), in flight under the insertions
        const bool last = j + 1 == run;
        int y[B];
        if (!last) {
#pragma unroll
          for (int u = 0; u < B; ++u)
            y[u] = take >> u & 1 ? __ldcs(c0 + u * rstride +
                                          (size_t)(j + 1) * plane)
                                 : INT_MAX;
        } else if (cut) {
#pragma unroll
          for (int u = 0; u < B; ++u)
            if (din >> u & 1) rest = min(rest, dv[u]);
#pragma unroll
          for (int u = 0; u < B; ++u)
            dv[u] = take >> u & 1 ? __ldcs(dp + (size_t)(t + u) * plane)
                                  : INT_MAX;
        }
        const unsigned in = enter<R, B, S>(x, take, buf, stg, nstg, rest);
        if (last) {
          if (cut) din = in;
          break;
        }
#pragma unroll
        for (int u = 0; u < B; ++u) x[u] = in >> u & 1 ? y[u] : INT_MAX;
      }
      if constexpr (CM_AHEAD<R>) {
#pragma unroll
        for (int u = 0; u < B; ++u) x[u] = xn[u];
      } else {
        firsts(x, t + B);
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u)
      if (din >> u & 1) rest = min(rest, dv[u]);
  }
  if constexpr (S > 0) merge_staged(buf, stg, rest);
  if (!cut) rest = min(rest, min_rows<B>(dp, plane, 0, ndisc));
#pragma unroll
  for (int c = 0; c < R; ++c) out[c * plane + idx] = buf[c];
  out[R * plane + idx] = rest;
}

template <int R>
cudaError_t launch_merge(const void* cand, const void* disc, void* out,
                         int ncand, int ndisc, int nq, int run, int cut,
                         cudaStream_t st) {
  const size_t plane = (size_t)LANES * nq;
  const unsigned grid = (unsigned)((plane + THREADS - 1) / THREADS);
  if (run <= 2)
    cand_merge_kernel<R, true><<<grid, THREADS, 0, st>>>(
        (const int*)cand, (const int*)disc, (int*)out, ncand, ndisc, nq, run,
        cut);
  else
    cand_merge_kernel<R, false><<<grid, THREADS, 0, st>>>(
        (const int*)cand, (const int*)disc, (int*)out, ncand, ndisc, nq, run,
        cut);
  return cudaGetLastError();
}

// The pair merge: one thread per (lane, query). The R smallest of the
// candidate (score, gid) pairs, ascending, to outv / outi[0..R). The
// candidates arrive in ascending gid among equal scores (tile after
// tile, and ascending within a tile), so a strict `<` on the scores
// keeps the order (score, gid); a +inf candidate never enters, and an
// empty slot stays (+inf, NOID).
//
// What bounds it on the card: reading the scores, 4 bytes per candidate
// (coalesced: consecutive threads take consecutive queries), once, and
// the insertions: one costs ~5 R instructions, and a warp pays one for
// every row on which any of its 32 (lane, query)s takes a candidate,
// which at these plans is nearly every row (a row's candidate enters
// with probability ~R / row). The former form took one row at a time,
// its score load waited on before the next (one load in flight a
// thread), and inserted by a bubble pass whose R steps each waited on
// the last. Now a thread loads a batch of PM_BATCH(R) rows' scores
// (streaming loads) before it compares any, marks those below its R-th
// score at the batch's start, loads their ids together, and inserts them
// in row order, each tested again against the R-th score of the moment:
// the outputs are the same bits, and a warp pays one insertion per
// candidate of its busiest thread in the batch instead of one per row
// that any thread takes. An insertion computes every slot from the old
// buffer (no step waits on another). At n = 1e6, nq = 1e4 (NVIDIA H100
// 80GB HBM3, 700 W): 2.149 / 5.891 / 17.390 -> 1.268 / 3.614 / 5.964 ms
// at the k = 100 / 1000 / 3072 plans, against a bound of 0.425 / 0.850
// / 0.899 (the scores read once and the outputs written once at 3.35
// TB/s); on scores that rise row after row (nothing enters after the
// first rows) it takes 0.539 / 1.293 / 2.461 (demos/probe_minplus.py),
// so the insertions, not the loads, hold it below half its bound at
// every plan. Merging each
// batch by bitonic networks instead (the same work on every lane) was
// slower at every plan.
template <int R>
constexpr int PM_BATCH = R <= 32 ? 16 : 8;

// insert (s, id), s < bv[R - 1], into the ascending buffer, dropping its
// last pair; among equal scores the buffer's pairs stay ahead
template <int R>
__device__ __forceinline__ void pair_insert(float (&bv)[R], int (&bi)[R],
                                            float s, int id) {
  // slot i takes its left neighbour where s < bv[i - 1], s where only
  // s < bv[i], else keeps its own
  bool below = s < bv[R - 1];
#pragma unroll
  for (int i = R - 1; i > 0; --i) {
    const bool left = s < bv[i - 1];
    bv[i] = left ? bv[i - 1] : below ? s : bv[i];
    bi[i] = left ? bi[i - 1] : below ? id : bi[i];
    below = left;
  }
  if (below) {
    bv[0] = s;
    bi[0] = id;
  }
}

template <int R>
__global__ void __launch_bounds__(THREADS)
    pair_merge_kernel(const float* __restrict__ candv,
                      const int* __restrict__ candi, float* __restrict__ outv,
                      int* __restrict__ outi, int ncand, int nq) {
  constexpr int B = PM_BATCH<R>;
  const size_t plane = (size_t)LANES * nq;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  float bv[R];
  int bi[R];
#pragma unroll
  for (int c = 0; c < R; ++c) {
    bv[c] = pos_inf();
    bi[c] = NOID;
  }
  int row = 0;
  for (; row + B <= ncand; row += B) {
    float s[B];
    int id[B];
#pragma unroll
    for (int u = 0; u < B; ++u)
      s[u] = __ldcs(candv + (size_t)(row + u) * plane + idx);
    unsigned take = 0;
#pragma unroll
    for (int u = 0; u < B; ++u) take |= (s[u] < bv[R - 1] ? 1u : 0u) << u;
#pragma unroll
    for (int u = 0; u < B; ++u)
      id[u] = take >> u & 1u ? __ldcs(candi + (size_t)(row + u) * plane + idx)
                             : NOID;
    while (take) {
      const int uu = __ffs(take) - 1;
      take &= take - 1;
      float sv = s[0];
      int iv = id[0];
#pragma unroll
      for (int u = 1; u < B; ++u)
        if (u == uu) {
          sv = s[u];
          iv = id[u];
        }
      if (sv < bv[R - 1]) pair_insert(bv, bi, sv, iv);
    }
  }
  for (; row < ncand; ++row) {
    const float s = candv[(size_t)row * plane + idx];
    if (s < bv[R - 1])
      pair_insert(bv, bi, s, candi[(size_t)row * plane + idx]);
  }
#pragma unroll
  for (int c = 0; c < R; ++c) {
    outv[c * plane + idx] = bv[c];
    outi[c * plane + idx] = bi[c];
  }
}

template <int R>
cudaError_t launch_pair_merge(const void* candv, const void* candi,
                              void* outv, void* outi, int ncand, int nq,
                              cudaStream_t st) {
  const size_t plane = (size_t)LANES * nq;
  pair_merge_kernel<R><<<(unsigned)((plane + THREADS - 1) / THREADS),
                         THREADS, 0, st>>>(
      (const float*)candv, (const int*)candi, (float*)outv, (int*)outi,
      ncand, nq);
  return cudaGetLastError();
}

// K14's tile-end merge for one (lane, query): the tile's KEEP survivors
// `carry` (ascending) into the ascending R-key buffer buf[c * stride]
// (device memory private to the thread), and every key that does not
// make it into the R smallest into `rest`. A streaming merge: position c
// takes the smaller of buf[c] and the carry's head, the larger joins the
// carry; the carry left at the end is what the buffer evicted. Most tiles
// of a scan bring nothing below buf[R-1]: one load decides that. A merge
// loads MERGE_BATCH positions before it merges any, so their latencies
// overlap (the keys it leaves do not depend on the batch).
template <int R, int KEEP>
__device__ __forceinline__ void merge_survivors(int (&carry)[KEEP], int& rest,
                                                int* buf, int stride) {
  constexpr int B = MERGE_BATCH;
  if (carry[0] < buf[(size_t)(R - 1) * stride]) {
#pragma unroll 1
    for (int c0 = 0; c0 < R; c0 += B) {
      int x[B];
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (c0 + u < R) x[u] = buf[(size_t)(c0 + u) * stride];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (c0 + u >= R) break;
        const int lo = min(carry[0], x[u]), hi = max(carry[0], x[u]);
#pragma unroll
        for (int e = 0; e < KEEP - 1; ++e) carry[e] = carry[e + 1];
        carry[KEEP - 1] = hi;
#pragma unroll
        for (int e = KEEP - 1; e > 0; --e) {
          const int a = carry[e - 1], b = carry[e];
          carry[e - 1] = min(a, b);
          carry[e] = max(a, b);
        }
        buf[(size_t)(c0 + u) * stride] = lo;
      }
    }
  }
  rest = min(rest, carry[0]);
}

// ---------------------------------------------------------------------------
// K1 and K14 on bf16 operands: the tensor-core body shared over a cluster
// ---------------------------------------------------------------------------
//
// A CTA that decodes its rows itself gathers m codebook rows from L2 for
// every row it scores (1.8 GB of L2 reads per 32-query block at n = 1e6,
// d = 128, m = 7, bf16), and that grows with n * nq * d. Here the products
// go to the tensor cores (`tile_scores`, the score function K4 shares),
// and a cluster of MMA_CL CTAs on neighbouring query blocks shares each
// decoded step: each CTA decodes 128 / MMA_CL of the step's rows and
// writes them, with their norms, into the shared memory of every CTA of
// the cluster (distributed shared memory), then a cluster barrier
// publishes the step. A row is decoded once per MMA_CL * 32 queries. With
// two step buffers (where two CTAs an SM still fit) the next step's decode
// goes into the other buffer, so one cluster barrier a step serves both
// directions; with one a second barrier keeps the writers out until every
// CTA has scored. The codes of a CTA's rows are fetched a step ahead. The
// f32 instances share their decoded rows the same way (`codes_f32_kernel`,
// below), over a layout of their own.
//
// A CTA holds 32 queries and 256 threads; warp w scores queries [16 (w %
// 2), +16) against lanes [32 (w / 2), +32), four m16n8 tiles, and its
// thread owns 2 queries x 8 lanes: the same 16 (lane, query) pairs at
// every step, whose KEEP-deep buffers and certificates stay in registers
// (K1's selection, unchanged). Queries sit whole in shared memory at any
// dp; rows in d-blocks (`scan_dblock`: the decode's blocks are K4's, so
// the PQ layout's norms sum in K4's order). The grid is (query blocks
// padded to a multiple of MMA_CL, splits): K1 is one tile a CTA (R = 0),
// K14 walks its split's tiles and merges the survivors at each tile's end
// into its running buffer in `scratch` (`merge_survivors`).
//
// Clusters of 8 CTAs, the largest portable size: a row is then decoded
// once per 256 queries. The cluster size, the loads a decoding thread
// keeps in flight and the step buffers were chosen by trial variants on
// an H100 whose times are not kept (not measured by a script in the
// repo). What bounds the body at d = 128 is the latency chain of a step,
// not a rate: the gathers of a thread's rows, the stores to the peers and
// the cluster barrier (PERF.md gives the rates, from chip_smoke.py).

constexpr int MMA_QB = 32;        // queries per CTA
constexpr int MMA_CL = 8;         // CTAs per cluster, along the query blocks
constexpr int MMA_DEC_BATCH = 4;  // codebook loads a decoding thread keeps
                                  // in flight (the buffers hold registers)

__device__ __forceinline__ unsigned peer_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(unsigned a, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_cluster(unsigned a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v)
               : "memory");
}
// every thread of every CTA of the cluster; the writes before it are
// visible after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// This CTA's share of a step: lanes [rank * RPC, +RPC) of its row id,
// dimensions [b0, b0 + nb), decoded as decode_lanes decodes (the same
// threads per row, chunks and sums) and written to every CTA of the
// cluster: the values at Xb[lane * xs + kk], the norm at x2b[lane] and,
// with xnb (a row of one d-block), the norm of its f32 values at
// xnb[lane] (the same offsets in each CTA). x2own keeps the PQ layout's
// running norm of this CTA's rows across the d-blocks; `words` holds
// their codes (the caller fetched them a step ahead). No barrier at the
// end: the caller's cluster barrier publishes the step.
__device__ void decode_share(const CodesSrc<__nv_bfloat16>& src, int rank,
                             int b0, int nb, int dp, __nv_bfloat16* Xb,
                             int xs, float* x2b, float* xnb, float* x2own,
                             const int* words) {
  constexpr int RPC = LANES / MMA_CL, V = 8;
  const int tid = threadIdx.x, nw = src.nw, l0 = rank * RPC;
  const int cpr = nb / V, G = cpr < 32 ? cpr : 32;
  const int t = tid & 31, per_warp = 32 / G;
  const int row_step = (THREADS >> 5) * per_warp;
  const unsigned xa = smem_addr(Xb), x2a = smem_addr(x2b);
  // RPC (16) is a multiple of per_warp (2, or 1 at G = 32): a warp takes
  // the loop and the shuffles together
  for (int j = (tid >> 5) * per_warp + t / G; j < RPC; j += row_step) {
    const int* wl = words + j * nw;
    const unsigned row = xa + 2u * (unsigned)((l0 + j) * xs);
    const unsigned xna = xnb ? smem_addr(xnb + l0 + j) : 0u;
    const float part = decode_row<__nv_bfloat16, MMA_DEC_BATCH>(
        src.Cflat, wl, src.m, src.h, dp, b0, cpr, G, t,
        [&](int c, uint4 v) {
#pragma unroll
          for (int p = 0; p < MMA_CL; ++p)
            st_cluster(peer_addr(row + 2u * (unsigned)(c * V), p), v);
        });
    if (t % G == 0) {
      const float x =
          src.has_norms ? to_f32(src.nrm[(size_t)code_of(wl, src.m) * LANES])
                        : (b0 == 0 ? part : x2own[j] + part);
      x2own[j] = x;
#pragma unroll
      for (int p = 0; p < MMA_CL; ++p)
        st_cluster(peer_addr(x2a + 4u * (unsigned)(l0 + j), p), x);
      if (xnb) {
        const float xn = sqrtf(part);
#pragma unroll
        for (int p = 0; p < MMA_CL; ++p) st_cluster(peer_addr(xna, p), xn);
      }
    }
  }
}

// Shared bytes of a CTA with nbuf step buffers: the queries whole and
// their margins (`slack_of_query`), the step's 128 rows at one d-block and their two norms
// (x2, and that of the f32 values) per buffer, this CTA's running norms
// and the codes of its rows for two steps (16 bytes of padding a row: the
// ldmatrix rows fall in distinct banks); where a row is one d-block, room
// for the chains' requests (16 a thread: a key and an item each).
inline size_t mma_smem(int dp, int nw, int nbuf) {
  const size_t rpc = LANES / MMA_CL, db = scan_dblock(dp);
  return 2 * ((size_t)MMA_QB * (dp + 8) + (size_t)nbuf * LANES * (db + 8)) +
         4 * (MMA_QB + 2 * (size_t)nbuf * LANES + rpc) +
         8 * rpc * (size_t)nw + (dp <= NARROW_DP ? 6 * 16 * THREADS : 0);
}

// Step buffers at width dp: 2 where two such CTAs fit an SM, else 1 where
// two or one fit, else 0 (none fits, or a thread would fetch more than
// one word of a step's codes).
inline int mma_nbuf(int dp, int nw) {
  int dev = 0, cap = 0;
  if (LANES / MMA_CL * nw > THREADS || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  // two CTAs an SM: each also takes 1 KB of the SM's shared memory
  if (mma_smem(dp, nw, 2) <= (size_t)(cap - 1024) / 2) return 2;
  return mma_smem(dp, nw, 1) <= (size_t)cap ? 1 : 0;
}

// K1 (R = 0: tile blockIdx.y, its KEEP smallest keys and certificate per
// (lane, query) to cand/disc as every candidates kernel writes them) and
// K14 (R > 0: tiles [s * tiles_per, +tiles_per) of split s = blockIdx.y,
// the running R-key buffer in `scratch`, the survivors merged at each
// tile's end) on bf16 operands. Launched in clusters of MMA_CL CTAs along x (the query
// blocks); the CTAs of a cluster walk the same rows.
template <int KEEP, int R, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
    codes_mma_kernel(const CodesSrc<__nv_bfloat16> src,
                     const __nv_bfloat16* __restrict__ Qm,
                     int* __restrict__ cand, int* __restrict__ disc,
                     int* __restrict__ scratch, int n, int nq, int dp,
                     int rows, int ntiles, int tiles_per, int nbuf,
                     int idbits) {
  using T = __nv_bfloat16;
  constexpr int RPC = LANES / MMA_CL, V = 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int db = WIDE ? DBLK : dp, xs = db + V, qs = dp + V;
  T* Qs = reinterpret_cast<T*>(smem_raw);             // MMA_QB * qs
  T* Xs = Qs + MMA_QB * qs;                           // nbuf * LANES * xs
  float* x2s = reinterpret_cast<float*>(Xs + nbuf * LANES * xs);
  float* xns = x2s + nbuf * LANES;                    // nbuf * LANES
  float* qcs = xns + nbuf * LANES;                    // MMA_QB
  float* x2own = qcs + MMA_QB;                        // RPC
  int* words = reinterpret_cast<int*>(x2own + RPC);   // 2 * RPC * nw
  // one d-block: the chains' requests, 16 a thread (keys, then items)
  int* rkeys = words + 2 * RPC * src.nw;
  unsigned short* ritems =
      reinterpret_cast<unsigned short*>(rkeys + 16 * THREADS);
  const int rank = cluster_rank();
  const int q0 = blockIdx.x * MMA_QB, s = blockIdx.y;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int qw = (warp & 1) * 16, lw = (warp >> 1) * 32;
  const int vmask = -(1 << idbits);
  for (int i = threadIdx.x; i < MMA_QB * (dp / V); i += THREADS) {
    const int qq = i / (dp / V), c = i % (dp / V);
    *reinterpret_cast<uint4*>(Qs + qq * qs + c * V) =
        q0 + qq < nq ? *reinterpret_cast<const uint4*>(
                           Qm + (size_t)(q0 + qq) * dp + c * V)
                     : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (!WIDE) {
    __syncthreads();
    if (threadIdx.x < MMA_QB)
      qcs[threadIdx.x] = slack_of_query(Qs + threadIdx.x * qs, dp);
  }
  constexpr int STRIDE = K14_PAIRS * THREADS;
  int* buf = nullptr;
  if constexpr (R > 0) {
    buf = scratch + ((size_t)s * gridDim.x + blockIdx.x) * R * STRIDE +
          threadIdx.x;
    for (int c = 0; c < R * K14_PAIRS; ++c) buf[(size_t)c * THREADS] = INT_MAX;
  }
  // pair p = 4 i + e: lane lw + 8 i + 2 (l % 4) + e % 2, query q0 + qw +
  // l / 4 + 8 (e / 2) (`tile_scores`' accumulator)
  int best[16][KEEP];
  int rest[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) rest[p] = INT_MAX;
  const int t0 = s * tiles_per, t1 = min(ntiles, t0 + tiles_per);
  // thread i < RPC * nw fetches word i of the codes of this CTA's rows of
  // row id rid, a step before the decode reads them (words[step % 2])
  const int nword = LANES / MMA_CL * src.nw;
  auto fetch = [&](int rid) {
    const long long gid = (long long)rid * LANES + rank * RPC +
                          threadIdx.x / src.nw;
    return threadIdx.x < nword && rid < t1 * rows && gid < n
               ? src.packed[gid * src.nw + threadIdx.x % src.nw]
               : 0;
  };
  if (threadIdx.x < nword)
    words[((t0 * rows) & 1) * nword + threadIdx.x] = fetch(t0 * rows);
  // every CTA of the cluster has started (its shared memory may be
  // written) and the queries and the first codes are in place
  cluster_sync();

  // the margins of the thread's two queries (one d-block)
  const float qc0 = WIDE ? 0.f : qcs[qw + (l >> 2)],
              qc1 = WIDE ? 0.f : qcs[qw + (l >> 2) + 8];
  int unit = 0;  // decoded (step, d-block) units so far
  for (int t = t0; t < t1; ++t) {
#pragma unroll
    for (int p = 0; p < 16; ++p)
#pragma unroll
      for (int c = 0; c < KEEP; ++c) best[p][c] = INT_MAX;
    for (int step = 0; step < rows; ++step) {
      const int rid = t * rows + step;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      int b = 0;
      const int* wcur = words + (rid & 1) * nword;
      const int wnext = fetch(rid + 1);
      for (int b0 = 0; b0 < dp; b0 += db, ++unit) {
        b = nbuf == 2 ? unit & 1 : 0;
        // one buffer: every CTA has scored the last unit before any
        // writes over it (two: the last barrier saw to the other buffer)
        if (nbuf == 1 && unit > 0) cluster_sync();
        decode_share(src, rank, b0, db, dp, Xs + b * LANES * xs, xs,
                     x2s + b * LANES, WIDE ? nullptr : xns + b * LANES, x2own,
                     wcur);
        // the next step's codes, to the buffer its decode reads (the last
        // readers of that buffer, a step ago, passed a barrier since)
        if (b0 + db >= dp && threadIdx.x < nword)
          words[((rid + 1) & 1) * nword + threadIdx.x] = wnext;
        cluster_sync();
        tile_scores<4>(Qs + qw * qs + b0, qs, Xs + (b * LANES + lw) * xs, xs,
                       db, acc);
      }
      // pair p = 4 i + e: the keys lo <= hi its score allows (one key
      // where the score settles it, or beyond one d-block, where the
      // tensor-core key stands), lo in place of the score; eq: the pairs
      // whose key is known, need: those the fmaf chain decides
      const float* x2 = x2s + b * LANES;
      unsigned eq = 0, need = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 4 * i + e;
          const int lane = lw + 8 * i + 2 * (l & 3) + (e & 1);
          const bool pad = (long long)rid * LANES + lane >= n;
          const float sc = pad ? __int_as_float(0x7F800000)
                               : acc[i][e] + x2[lane];
          int lo, hi;
          if constexpr (WIDE) {
            lo = hi = row_key(sc, rid, vmask);
          } else {
            margin_keys(sc,
                        score_slack(sc, e >> 1 ? qc1 : qc0,
                                    xns[b * LANES + lane]),
                        rid, vmask, lo, hi);
          }
          eq |= (unsigned)(lo == hi) << p;
          need |= (unsigned)(lo != hi && lo < max(best[p][KEEP - 1], rest[p]))
                  << p;
          acc[i][e] = __int_as_float(lo);
        }
#pragma unroll
      for (int p = 0; p < 16; ++p)
        if (eq >> p & 1)
          insert_sorted<KEEP>(best[p], rest[p],
                              __float_as_int(acc[p >> 2][p & 3]));
      if constexpr (!WIDE) {
        int total;
        const int base = warp_offsets(need, total);
        if (total) {
          int* keys = rkeys + warp * 32 * 16;
          unsigned short* item = ritems + warp * 32 * 16;
          int k = base;
#pragma unroll
          for (int p = 0; p < 16; ++p)
            if (need >> p & 1) {
              item[k] = (unsigned short)((l << 4) | p);
              keys[k++] = __float_as_int(acc[p >> 2][p & 3]);
            }
          warp_chain_keys(item, keys, total, [&](int it) {
            const int sl = it >> 4, p = it & 15;
            const int lane = lw + 8 * (p >> 2) + 2 * (sl & 3) + (p & 1);
            const int q = qw + (sl >> 2) + 8 * ((p & 3) >> 1);
            return row_key(chain_score(Xs + (b * LANES + lane) * xs,
                                       Qs + q * qs, dp, x2[lane]),
                           rid, vmask);
          });
          k = base;
#pragma unroll
          for (int p = 0; p < 16; ++p)
            if (need >> p & 1)
              insert_sorted<KEEP>(best[p], rest[p], keys[k++]);
        }
      }
    }
    if constexpr (R > 0) {
#pragma unroll
      for (int p = 0; p < 16; ++p)
        merge_survivors<R, KEEP>(
            best[p], rest[p], buf + (size_t)p * THREADS, STRIDE);
    }
  }
  // the last remote writes came before the last cluster barrier: no CTA
  // of the cluster touches another's shared memory after this point

  const size_t plane = (size_t)LANES * nq;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * i + e;
      const int q = q0 + qw + (l >> 2) + 8 * (e >> 1);
      if (q >= nq) continue;
      const size_t off =
          (size_t)(lw + 8 * i + 2 * (l & 3) + (e & 1)) * nq + q;
      if constexpr (R == 0) {
#pragma unroll
        for (int c = 0; c < KEEP; ++c)
          cand[(size_t)(t0 * KEEP + c) * plane + off] = best[p][c];
        disc[(size_t)t0 * plane + off] = rest[p];
      } else {
        const int* bp = buf + (size_t)p * THREADS;
        for (int c = 0; c < R; ++c)
          cand[((size_t)s * R + c) * plane + off] = bp[(size_t)c * STRIDE];
        disc[(size_t)s * plane + off] = rest[p];
      }
    }
}

template <int KEEP, int R>
auto mma_kernel(int dp) -> decltype(&codes_mma_kernel<KEEP, R, false>) {
  return dp > NARROW_DP ? codes_mma_kernel<KEEP, R, true>
                        : codes_mma_kernel<KEEP, R, false>;
}

// A launch configuration of THREADS threads a CTA in clusters of
// `cluster` CTAs along x.
struct ClusterConfig {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterConfig(dim3 grid, size_t smem, cudaStream_t st, int cluster)
      : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// K1 (R = 0, tiles_per = 1) or K14 on bf16 operands over nq queries: the
// grid's query blocks padded to a multiple of MMA_CL (a padded block
// decodes its share of each step and writes nothing).
template <int KEEP, int R>
cudaError_t launch_mma(const CodesSrc<__nv_bfloat16>& src, const void* Qm,
                       void* cand, void* disc, void* scratch, int n, int nq,
                       int dp, int rows, int ntiles, int tiles_per,
                       int idbits, cudaStream_t st) {
  const int nbuf = mma_nbuf(dp, src.nw);
  if (!nbuf) return cudaErrorInvalidValue;
  const int ncl = (nq + MMA_QB * MMA_CL - 1) / (MMA_QB * MMA_CL);
  const size_t smem = mma_smem(dp, src.nw, nbuf);
  auto kern = mma_kernel<KEEP, R>(dp);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ClusterConfig c(dim3(ncl * MMA_CL, (ntiles + tiles_per - 1) / tiles_per),
                  smem, st, MMA_CL);
  e = cudaLaunchKernelEx(&c.cfg, kern, src, (const __nv_bfloat16*)Qm,
                         (int*)cand, (int*)disc, (int*)scratch, n, nq, dp,
                         rows, ntiles, tiles_per, nbuf, idbits);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The layout of a K1 or K14 kernel `kern` into out[9]: queries per CTA,
// ints of scratch per CTA, CTAs per SM, the d-block, shared bytes per CTA,
// CTAs per cluster, the clusters the card holds at once, step buffers,
// lanes per CTA.
inline cudaError_t codes_layout(const void* kern, int dblock, size_t smem,
                                int scratch, int qb, int cluster, int nbuf,
                                int lanes, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  out[0] = qb;
  out[1] = scratch;
  out[3] = dblock;
  out[4] = (int)smem;
  out[5] = cluster;
  out[7] = nbuf;
  out[8] = lanes;
  int dev = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &out[2], kern, THREADS, smem)) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if (cluster == 1) {
    out[6] = out[2] * sms;
    return cudaSuccess;
  }
  ClusterConfig c(dim3(cluster * sms), smem, 0, cluster);
  return cudaOccupancyMaxActiveClusters(&out[6], kern, &c.cfg);
}

// The layout of K1 (R = 0) or K14 on bf16 operands at (dp, nw).
template <int KEEP, int R>
cudaError_t mma_layout(int dp, int nw, int* out) {
  const int nbuf = mma_nbuf(dp, nw);
  if (!nbuf) return cudaErrorInvalidValue;
  return codes_layout((const void*)mma_kernel<KEEP, R>(dp), scan_dblock(dp),
                      mma_smem(dp, nw, nbuf), R * K14_PAIRS * THREADS, MMA_QB,
                      MMA_CL, nbuf, LANES, out);
}

// ---------------------------------------------------------------------------
// K1 and K14 on f32 operands: the fmaf body shared over a cluster
// ---------------------------------------------------------------------------
//
// The f32 instances keep the fmaf chain's score (scan_common.cuh) and K4's
// f32 instance keeps it too, so their keys stay the former body's bit for
// bit on any data: the rows decode through `decode_chunk` (the codebook
// rows summed in codebook order), the PQ layout's norms sum in the former
// body's order, and a score is one fmaf chain in dimension order from zero
// across the d-blocks, then + x2.
//
// What bounded the former body (4 x 4 blocks of lanes x queries a thread
// over a CTA of 32 queries and all 128 lanes). Every CTA decoded each
// 128-row step itself: m codebook rows of dp f32 values gathered from L2
// for every row, about 1.1 TB of L2 reads a search at n = 1e6, nq = 1e4,
// d = 128, m = 7, against the 2.56e12 operations of its scores. And a
// thread's 4 x 4 block took 20 shared loads (one value each per thread) per
// 64 FMAs, where an SM delivers 32 such values a clock against 128 FMAs.
//
// The layout. A CTA scores F_QB = 128 queries against F_LC = 16 lanes, and
// the grid is (query blocks padded to whole clusters, 128 / F_LC lane
// blocks, tiles for K1 or splits for K14): a cluster of F_CL = 8 CTAs runs
// neighbouring query blocks of one lane block over the same rows. It walks
// its rows in groups of F_RG = 8 row ids (F_GR = 128 rows), each decoded
// once per cluster: CTA `rank` decodes rows [rank * F_RPC, +F_RPC) of the
// group and writes them, with their norms, into the shared memory of every
// CTA of the cluster (`decode_f32_share`, as the bf16 body's
// `decode_share`), and a cluster barrier publishes them. So a row is
// decoded once per F_CL * F_QB = 1024 queries: about 72 GB of L2 gathers a
// search at the shape above (n * ceil(nq / 1024) rows of m * dp * 4
// bytes). A thread owns one lane and F_QT = 8 queries (query group qg,
// queries qg + 4 j) and scores the group's F_RG row ids of its lane against
// them: 64 fmaf chains in registers, 16 16-byte shared loads per 256 FMAs
// (one value per four FMAs, the SM's own ratio), while its selection state
// stays that of its 8 (lane, query) pairs. Rows and queries sit row-major
// in shared memory, 16 bytes of padding a row, so the 8 rows or 4 queries
// that a warp's load instruction reads fall in distinct banks.
//
// Every group goes through in pieces of DBLK dimensions, ascending, the
// chains staying in registers, so any dp takes this one body. The queries
// stay resident where they fit beside two group buffers (dp = 128); else
// each piece brings its block of the CTA's queries (cp.async, in flight
// under the decode), a reload per piece. A row of one d-block (dp <=
// NARROW_DP) sums its squares per thread across the pieces and reduces
// once; a wider row reduces per piece and adds the pieces: the former
// body's sums either way. Two group buffers: the next piece's decode goes
// into the other buffer, one cluster barrier a piece. The codes of a CTA's
// rows are fetched a group ahead. One CTA an SM: the 64 chains, the pairs'
// state and the decode's loads want more than the 128 registers of two,
// and two group buffers with the queries take 204 KB (at most 206 KB with
// the queries reloaded, within the card's 227 KB at every dp).
// The grid's CTAs, layout and shared bytes come from the kernel's source
// (`rq_codes_candidates_layout`, `rq_codes_onepass_layout`).
//
// What bounds it at d = 128: the scores, which keep the FMA pipes and the
// shared-memory loads both busy at once (a load instruction of 16 bytes a
// thread takes four of the SM's 128-byte cycles, so a thread's 16 loads
// per 256 FMAs are the SM's 32 values against its 128 FMAs a clock), and
// beside them, with no other CTA on the SM to fill the gaps, each group's
// decode, peer stores, cluster barrier and key selection. Variants timed
// on an H100 (PERF.md §6, `demos/time_onepass.py --f32 --codes-only` on
// copies of this package): two CTAs an SM with 8 x 4 tiles and one group
// buffer, and the next group's codebook loads held in registers across
// the key selection (which spilled), were both slower.

constexpr int F_QT = 8;                      // queries a thread scores
constexpr int F_RG = 8;                      // row ids of a group
constexpr int F_LC = 16;                     // lanes per CTA
constexpr int F_QB = THREADS * F_QT / F_LC;  // queries per CTA (128)
constexpr int F_GR = F_RG * F_LC;            // rows of a group (128)
constexpr int F_CL = 8;            // CTAs per cluster, along the query blocks
constexpr int F_RPC = F_GR / F_CL;  // rows a CTA decodes a group (16)
constexpr int F_PAD = 4;            // floats of padding a staged row
constexpr int F_XS = DBLK + F_PAD;  // row stride of a group buffer
constexpr int F_NBUF = 2;           // group buffers
static_assert(F_LC % 8 == 0 && (F_LC / 8) * (F_QB / (4 * F_QT)) == 8,
              "eight warps of 8 lanes x 4 query groups");
static_assert(F_RPC % 8 == 0, "whole rows for each of the eight warps");

// This CTA's share of a group: rows [rank * F_RPC, +F_RPC) (row i: row id
// rid0 + i / F_LC, lane l0 + i % F_LC, its codes at words[(i - rank *
// F_RPC) * nw]), dimensions [b0, b0 + DBLK) of dp, decoded by a warp a row
// (thread t: 16 bytes at b0 + 4 t, the former body's chunk of that thread;
// DEC_BATCH codebook loads in flight) and written to Xb[i * F_XS + kk] of
// every CTA of the cluster. part[k] carries a thread's sum of squares of
// its row k across the pieces of a row of one d-block; a wider row sums a
// piece at a time, and x2own keeps its running norm. At the row's last
// piece its norm goes to x2b[i] of every CTA. No barrier at the end: the
// caller's cluster barrier publishes the piece.
__device__ __forceinline__ void decode_f32_share(
    const CodesSrc<float>& src, int rank, int b0, int dp, bool one_block,
    bool last, float* Xb, float* x2b, float* x2own,
    float (&part)[F_RPC / 8], const int* words) {
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const unsigned xa = smem_addr(Xb), x2a = smem_addr(x2b);
#pragma unroll
  for (int k = 0; k < F_RPC / 8; ++k) {
    const int j = warp + 8 * k, i = rank * F_RPC + j;
    const int* wl = words + j * src.nw;
    float acc[4];
    decode_chunk<float>(src.Cflat, wl, src.m, src.h, dp, b0 + 4 * t, acc);
    const unsigned a = xa + 4u * (unsigned)(i * F_XS + 4 * t);
    const uint4 v = pack16(acc);
#pragma unroll
    for (int p = 0; p < F_CL; ++p) st_cluster(peer_addr(a, p), v);
    float pt = one_block && b0 > 0 ? part[k] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) pt += acc[e] * acc[e];
    part[k] = pt;
    if (one_block && !last) continue;
    for (int o = 16; o > 0; o >>= 1)
      pt += __shfl_xor_sync(0xffffffffu, pt, o);
    if (t == 0) {
      const float x =
          src.has_norms ? src.nrm[(size_t)code_of(wl, src.m) * LANES]
                        : (one_block || b0 == 0 ? pt : x2own[j] + pt);
      x2own[j] = x;
      if (last) {
#pragma unroll
        for (int p = 0; p < F_CL; ++p)
          st_cluster(peer_addr(x2a + 4u * (unsigned)i, p), x);
      }
    }
  }
}

// acc[r][j] += row r of the thread's lane . its query j over one piece of
// DBLK dimensions, fmaf chains in dimension order: rows at xb + r * F_LC *
// F_XS, queries at qb + 4 j * qs.
__device__ __forceinline__ void score_f32_piece(const float* xb,
                                                const float* qb, int qs,
                                                float (&acc)[F_RG][F_QT]) {
#pragma unroll 2
  for (int kk = 0; kk < DBLK; kk += 4) {
    float4 qv[F_QT];
#pragma unroll
    for (int j = 0; j < F_QT; ++j)
      qv[j] = *reinterpret_cast<const float4*>(qb + 4 * j * qs + kk);
#pragma unroll
    for (int r = 0; r < F_RG; ++r) {
      const float4 x =
          *reinterpret_cast<const float4*>(xb + r * F_LC * F_XS + kk);
#pragma unroll
      for (int j = 0; j < F_QT; ++j) {
        acc[r][j] = fmaf(x.x, qv[j].x, acc[r][j]);
        acc[r][j] = fmaf(x.y, qv[j].y, acc[r][j]);
        acc[r][j] = fmaf(x.z, qv[j].z, acc[r][j]);
        acc[r][j] = fmaf(x.w, qv[j].w, acc[r][j]);
      }
    }
  }
}

// K1 (R = 0: tile blockIdx.z, its KEEP smallest keys and certificate per
// (lane, query) to cand/disc) and K14 (R > 0: tiles [s * tiles_per,
// +tiles_per) of split s = blockIdx.z, the running R-key buffer in
// `scratch`, the survivors merged at each tile's end) on f32 operands.
// CTA (query block x, lane block y); launched in clusters of F_CL CTAs
// along x, which walk the same rows. RES: the queries resident.
template <int KEEP, int R, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
    codes_f32_kernel(const CodesSrc<float> src, const float* __restrict__ Qm,
                     int* __restrict__ cand, int* __restrict__ disc,
                     int* __restrict__ scratch, int n, int nq, int dp,
                     int rows, int ntiles, int tiles_per, int idbits) {
  extern __shared__ __align__(16) float fsm[];
  const int qs = (RES ? dp : DBLK) + F_PAD;     // query stride
  float* Qs = fsm;                              // F_QB * qs
  float* Xs = Qs + F_QB * qs;                   // F_NBUF * F_GR * F_XS
  float* x2s = Xs + F_NBUF * F_GR * F_XS;       // F_NBUF * F_GR
  float* x2own = x2s + F_NBUF * F_GR;           // F_RPC
  int* words = reinterpret_cast<int*>(x2own + F_RPC);  // 2 * F_RPC * nw
  const int rank = cluster_rank();
  const int q0 = blockIdx.x * F_QB, l0 = blockIdx.y * F_LC, s = blockIdx.z;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  // the thread's lane in the CTA and its first query (then every 4th)
  const int ll = (warp % (F_LC / 8)) * 8 + (t & 7);
  const int qt0 = (warp / (F_LC / 8)) * 4 * F_QT + (t >> 3);
  const int lane = l0 + ll;
  const int vmask = -(1 << idbits);
  const int nblk = dp / DBLK;
  const bool one_block = dp <= NARROW_DP;
  if constexpr (RES) {
    const int c4 = dp / 4;
    for (int i = threadIdx.x; i < F_QB * c4; i += THREADS) {
      const int qq = i / c4, c = i % c4;
      *reinterpret_cast<float4*>(Qs + qq * qs + 4 * c) =
          q0 + qq < nq ? *reinterpret_cast<const float4*>(
                             Qm + (size_t)(q0 + qq) * dp + 4 * c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  constexpr int STRIDE = F_QT * THREADS;
  int* buf = nullptr;
  if constexpr (R > 0) {
    buf = scratch +
          (((size_t)s * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
              R * STRIDE +
          threadIdx.x;
    for (int c = 0; c < R * F_QT; ++c) buf[(size_t)c * THREADS] = INT_MAX;
  }
  int best[F_QT][KEEP];
  int rest[F_QT];
#pragma unroll
  for (int j = 0; j < F_QT; ++j) rest[j] = INT_MAX;
  const int t0 = R > 0 ? s * tiles_per : s;
  const int t1 = R > 0 ? min(ntiles, t0 + tiles_per) : s + 1;
  const int ng = (rows + F_RG - 1) / F_RG;  // groups a tile
  const int nunits = (t1 - t0) * ng;
  // thread i < nword fetches word i % nw of row i / nw of this CTA's share
  // of group u (u = (tile - t0) * ng + group), a group before the decode
  // reads it (words[u % 2]); zero past the tile and past n
  const int nword = F_RPC * src.nw;
  auto fetch = [&](int u) {
    if (threadIdx.x >= nword || u >= nunits) return 0;
    const int g = u % ng, i = rank * F_RPC + threadIdx.x / src.nw;
    const int r = g * F_RG + i / F_LC;
    const long long gid =
        (long long)((t0 + u / ng) * rows + r) * LANES + l0 + i % F_LC;
    return r < rows && gid < n ? src.packed[gid * src.nw + threadIdx.x %
                                            src.nw]
                               : 0;
  };
  if (threadIdx.x < nword) words[threadIdx.x] = fetch(0);
  // every CTA of the cluster has started (its shared memory may be
  // written) and the queries and the first codes are in place
  cluster_sync();

  float part[F_RPC / 8];
  int piece = 0;  // pieces decoded so far
  for (int u = 0; u < nunits; ++u) {
    const int g = u % ng;
    const int rid0 = (t0 + u / ng) * rows + g * F_RG;
    const int nr = min(F_RG, rows - g * F_RG);
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < F_QT; ++j)
#pragma unroll
        for (int c = 0; c < KEEP; ++c) best[j][c] = INT_MAX;
    }
    const int* wcur = words + (u & 1) * nword;
    const int wnext = fetch(u + 1);
    float acc[F_RG][F_QT];
#pragma unroll
    for (int r = 0; r < F_RG; ++r)
#pragma unroll
      for (int j = 0; j < F_QT; ++j) acc[r][j] = 0.f;
    int bi = 0;
    for (int b = 0; b < nblk; ++b, ++piece) {
      // the buffer of the piece before last, which every CTA of the
      // cluster had scored before it passed the last cluster barrier
      bi = piece & 1;
      if constexpr (!RES) {
        // the piece's block of the queries, in flight under the decode,
        // once the CTA's readers of the last one are done
        __syncthreads();
        for (int i = threadIdx.x; i < F_QB * (DBLK / 4); i += THREADS) {
          const int qq = i / (DBLK / 4), c = i % (DBLK / 4);
          const bool ok = q0 + qq < nq;
          cp_async16(Qs + qq * qs + 4 * c,
                     ok ? Qm + (size_t)(q0 + qq) * dp + b * DBLK + 4 * c
                        : Qm,
                     ok);
        }
        cp_async_commit();
      }
      decode_f32_share(src, rank, b * DBLK, dp, one_block, b == nblk - 1,
                       Xs + bi * F_GR * F_XS, x2s + bi * F_GR, x2own, part,
                       wcur);
      // the next group's codes, to the buffer its decode reads (the last
      // readers of that buffer, a group ago, passed a barrier since)
      if (b == nblk - 1 && threadIdx.x < nword)
        words[((u + 1) & 1) * nword + threadIdx.x] = wnext;
      if constexpr (!RES) cp_async_wait<0>();
      cluster_sync();
      score_f32_piece(Xs + bi * F_GR * F_XS + ll * F_XS,
                      Qs + qt0 * qs + (RES ? b * DBLK : 0), qs, acc);
    }
    const float* x2 = x2s + bi * F_GR;
#pragma unroll
    for (int r = 0; r < F_RG; ++r) {
      if (r >= nr) break;
      const int rid = rid0 + r;
      const bool pad = (long long)rid * LANES + lane >= n;
      const float xx = x2[r * F_LC + ll];
#pragma unroll
      for (int j = 0; j < F_QT; ++j) {
        const float sc = pad ? __int_as_float(0x7F800000) : acc[r][j] + xx;
        insert_sorted<KEEP>(best[j], rest[j], row_key(sc, rid, vmask));
      }
    }
    if constexpr (R > 0) {
      if (g == ng - 1) {
        // the tile's end: the R-th key of each pair's buffer, all loaded
        // before any merge (most tiles bring nothing below it)
        int thr[F_QT];
#pragma unroll
        for (int j = 0; j < F_QT; ++j)
          thr[j] = buf[(size_t)j * THREADS + (size_t)(R - 1) * STRIDE];
#pragma unroll
        for (int j = 0; j < F_QT; ++j) {
          if (best[j][0] < thr[j])
            merge_survivors<R, KEEP>(best[j], rest[j],
                                     buf + (size_t)j * THREADS, STRIDE);
          else
            rest[j] = min(rest[j], best[j][0]);
        }
      }
    }
  }
  // the last remote writes came before the last cluster barrier: no CTA
  // of the cluster touches another's shared memory after this point

  const size_t plane = (size_t)LANES * nq;
#pragma unroll
  for (int j = 0; j < F_QT; ++j) {
    const int q = q0 + qt0 + 4 * j;
    if (q >= nq) continue;
    const size_t off = (size_t)lane * nq + q;
    if constexpr (R == 0) {
#pragma unroll
      for (int c = 0; c < KEEP; ++c)
        cand[(size_t)(t0 * KEEP + c) * plane + off] = best[j][c];
      disc[(size_t)t0 * plane + off] = rest[j];
    } else {
      const int* bp = buf + (size_t)j * THREADS;
      for (int c = 0; c < R; ++c)
        cand[((size_t)s * R + c) * plane + off] = bp[(size_t)c * STRIDE];
      disc[(size_t)s * plane + off] = rest[j];
    }
  }
}

// Shared bytes of an f32 K1/K14 CTA: its queries (whole where `resident`,
// else one piece of DBLK), F_NBUF group buffers of F_GR rows of DBLK
// values and their norms, the running norms and the codes (two groups) of
// its share of a group.
inline size_t f32_smem(int dp, int nw, bool resident) {
  const size_t qd = resident ? dp : DBLK;
  return 4 * ((size_t)F_QB * (qd + F_PAD) +
              (size_t)F_NBUF * F_GR * (F_XS + 1) + F_RPC +
              2 * (size_t)F_RPC * nw);
}

// Whether the f32 body keeps its queries resident at (dp, nw): 1 where
// they fit beside the group buffers (dp = 128 on an H100), 0 where they
// are reloaded a piece at a time, -1 where a thread would fetch more than
// one word of a group's codes or no CTA fits.
inline int f32_resident(int dp, int nw) {
  int dev = 0, cap = 0;
  if (F_RPC * nw > THREADS || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  if (f32_smem(dp, nw, true) <= (size_t)cap) return 1;
  return f32_smem(dp, nw, false) <= (size_t)cap ? 0 : -1;
}

template <int KEEP, int R>
auto f32_kernel(bool resident)
    -> decltype(&codes_f32_kernel<KEEP, R, true>) {
  return resident ? codes_f32_kernel<KEEP, R, true>
                  : codes_f32_kernel<KEEP, R, false>;
}

// K1 (R = 0, tiles_per = 1) or K14 on f32 operands over nq queries: grid
// (query blocks padded to a multiple of F_CL, lane blocks, tiles or
// splits); a padded block decodes its share of each group and writes
// nothing.
template <int KEEP, int R>
cudaError_t launch_f32(const CodesSrc<float>& src, const void* Qm,
                       void* cand, void* disc, void* scratch, int n, int nq,
                       int dp, int rows, int ntiles, int tiles_per,
                       int idbits, cudaStream_t st) {
  const int res = f32_resident(dp, src.nw);
  if (res < 0) return cudaErrorInvalidValue;
  const int ncl = (nq + F_QB * F_CL - 1) / (F_QB * F_CL);
  const size_t smem = f32_smem(dp, src.nw, res);
  auto kern = f32_kernel<KEEP, R>(res);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ClusterConfig c(dim3(ncl * F_CL, LANES / F_LC,
                       R > 0 ? (ntiles + tiles_per - 1) / tiles_per : ntiles),
                  smem, st, F_CL);
  e = cudaLaunchKernelEx(&c.cfg, kern, src, (const float*)Qm, (int*)cand,
                         (int*)disc, (int*)scratch, n, nq, dp, rows, ntiles,
                         tiles_per, idbits);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The layout of K1 (R = 0) or K14 on f32 operands at (dp, nw).
template <int KEEP, int R>
cudaError_t f32_layout(int dp, int nw, int* out) {
  const int res = f32_resident(dp, nw);
  if (res < 0) return cudaErrorInvalidValue;
  return codes_layout((const void*)f32_kernel<KEEP, R>(res), DBLK,
                      f32_smem(dp, nw, res), R * F_QT * THREADS, F_QB, F_CL,
                      F_NBUF, F_LC, out);
}

}  // namespace

extern "C" {

const char* rq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int rq_codes_decode_candidates(const void* Qm, const void* Cflat,
                               const void* nrm, const void* packed,
                               void* cand, void* disc, int n, int nq,
                               int dp, int m, int h, int nw, int has_norms,
                               int ntiles, int rows, int keep, int idbits,
                               int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const CodesSrc<__nv_bfloat16> src{(const __nv_bfloat16*)Cflat,
                                      (const __nv_bfloat16*)nrm,
                                      (const int*)packed, m, h, nw,
                                      has_norms};
    switch (keep) {
      case 2: return (int)launch_mma<2, 0>(src, Qm, cand, disc, nullptr, n,
                                           nq, dp, rows, ntiles, 1, idbits,
                                           st);
      case 4: return (int)launch_mma<4, 0>(src, Qm, cand, disc, nullptr, n,
                                           nq, dp, rows, ntiles, 1, idbits,
                                           st);
    }
    return (int)cudaErrorInvalidValue;
  }
  const CodesSrc<float> src{(const float*)Cflat, (const float*)nrm,
                            (const int*)packed, m, h, nw, has_norms};
  switch (keep) {
    case 2: return (int)launch_f32<2, 0>(src, Qm, cand, disc, nullptr, n, nq,
                                         dp, rows, ntiles, 1, idbits, st);
    case 4: return (int)launch_f32<4, 0>(src, Qm, cand, disc, nullptr, n, nq,
                                         dp, rows, ntiles, 1, idbits, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K1's layout at (keep, dp, nw) into out[9]: queries per CTA, ints of
// scratch per CTA (none), CTAs per SM, the d-block, shared bytes per CTA,
// CTAs per cluster, the clusters the card holds at once, step buffers,
// lanes per CTA.
int rq_codes_candidates_layout(int keep, int dp, int nw, int bf16,
                               void* out) {
  if (keep != 2 && keep != 4) return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)(keep == 2 ? mma_layout<2, 0>(dp, nw, (int*)out)
                           : mma_layout<4, 0>(dp, nw, (int*)out));
  return (int)(keep == 2 ? f32_layout<2, 0>(dp, nw, (int*)out)
                         : f32_layout<4, 0>(dp, nw, (int*)out));
}

// K4 at qb queries a CTA (the layout's) over row ids split rows_per a CTA
int rq_codes_decode_topk(const void* Qm, const void* Cflat, const void* nrm,
                         const void* packed, void* cand, void* disc, int n,
                         int nq, int dp, int m, int h, int nw, int has_norms,
                         int nrows, int rows_per, int qb, int r, int idbits,
                         int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RQ_K4(T, R)                                                         \
  return (int)launch_topk<CodesSrc<T>, R>(                                  \
      CodesSrc<T>{(const T*)Cflat, (const T*)nrm, (const int*)packed, m, h, \
                  nw, has_norms},                                           \
      Qm, cand, disc, n, nq, dp, nrows, rows_per, qb, idbits, st)
  if (r == 48) {
    if (bf16) RQ_K4(__nv_bfloat16, 48);
    RQ_K4(float, 48);
  }
#undef RQ_K4
  return (int)cudaErrorInvalidValue;
}

// K4's layout at (dp, nw) into out[5]: queries per CTA, lanes per CTA,
// CTAs per SM, the d-block, shared bytes per CTA. The wrapper launches
// that many queries a CTA and splits its rows from the rest.
int rq_codes_topk_layout(int dp, int nw, int r, int bf16, void* out) {
  if (r != 48) return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)topk_layout<CodesSrc<__nv_bfloat16>, 48>(dp, nw, (int*)out);
  return (int)topk_layout<CodesSrc<float>, 48>(dp, nw, (int*)out);
}

// K14's (r, keep) pairs are the one-pass plan's: (14, 2), (12, 4), (28, 4)
int rq_codes_decode_onepass(const void* Qm, const void* Cflat,
                            const void* nrm, const void* packed, void* cand,
                            void* disc, void* scratch, int n, int nq, int dp,
                            int m, int h, int nw, int has_norms, int rows,
                            int ntiles, int tiles_per, int r, int keep,
                            int idbits, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const CodesSrc<__nv_bfloat16> src{(const __nv_bfloat16*)Cflat,
                                      (const __nv_bfloat16*)nrm,
                                      (const int*)packed, m, h, nw,
                                      has_norms};
#define RQ_K14B(R, K)                                                      \
  return (int)launch_mma<K, R>(src, Qm, cand, disc, scratch, n, nq, dp,    \
                               rows, ntiles, tiles_per, idbits, st)
    if (r == 14 && keep == 2) RQ_K14B(14, 2);
    if (r == 12 && keep == 4) RQ_K14B(12, 4);
    if (r == 28 && keep == 4) RQ_K14B(28, 4);
#undef RQ_K14B
    return (int)cudaErrorInvalidValue;
  }
  const CodesSrc<float> src{(const float*)Cflat, (const float*)nrm,
                            (const int*)packed, m, h, nw, has_norms};
#define RQ_K14(R, K)                                                       \
  return (int)launch_f32<K, R>(src, Qm, cand, disc, scratch, n, nq, dp,    \
                               rows, ntiles, tiles_per, idbits, st)
  if (r == 14 && keep == 2) RQ_K14(14, 2);
  if (r == 12 && keep == 4) RQ_K14(12, 4);
  if (r == 28 && keep == 4) RQ_K14(28, 4);
#undef RQ_K14
  return (int)cudaErrorInvalidValue;
}

// K14's layout at (r, keep, dp, nw) into out[9]: queries per CTA, ints of
// scratch per CTA (`scratch` holds one such block per CTA of the grid),
// CTAs per SM, the d-block, shared bytes per CTA, CTAs per cluster, the
// clusters the card holds at once, step buffers, lanes per CTA (the grid
// has 128 / lanes CTAs per query block and split). The wrapper pads the
// query blocks to whole clusters and sizes its scratch and its splits
// from these.
int rq_codes_onepass_layout(int r, int keep, int dp, int nw, int bf16,
                            void* out) {
#define RQ_K14L(R, K)                                                 \
  return (int)(bf16 ? mma_layout<K, R>(dp, nw, (int*)out)             \
                    : f32_layout<K, R>(dp, nw, (int*)out))
  if (r == 14 && keep == 2) RQ_K14L(14, 2);
  if (r == 12 && keep == 4) RQ_K14L(12, 4);
  if (r == 28 && keep == 4) RQ_K14L(28, 4);
#undef RQ_K14L
  return (int)cudaErrorInvalidValue;
}

int rq_cand_merge(const void* cand, const void* disc, void* out, int ncand,
                  int ndisc, int nq, int r, int run, int cut, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (run < 1 || run > 4 || ncand % run || (cut && ncand != run * ndisc))
    return (int)cudaErrorInvalidValue;
#define RQ_K2(R)                                                           \
  case R:                                                                  \
    return (int)launch_merge<R>(cand, disc, out, ncand, ndisc, nq, run, cut, \
                                st)
  switch (r) {
    RQ_K2(12);
    RQ_K2(14);
    RQ_K2(16);
    RQ_K2(28);
    RQ_K2(32);
    RQ_K2(48);
    RQ_K2(96);
    RQ_K2(128);
  }
#undef RQ_K2
  return (int)cudaErrorInvalidValue;
}

int rq_pair_merge(const void* candv, const void* candi, void* outv,
                  void* outi, int ncand, int nq, int r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 16: return (int)launch_pair_merge<16>(candv, candi, outv, outi, ncand, nq, st);
    case 32: return (int)launch_pair_merge<32>(candv, candi, outv, outi, ncand, nq, st);
    case 48: return (int)launch_pair_merge<48>(candv, candi, outv, outi, ncand, nq, st);
    case 96: return (int)launch_pair_merge<96>(candv, candi, outv, outi, ncand, nq, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
