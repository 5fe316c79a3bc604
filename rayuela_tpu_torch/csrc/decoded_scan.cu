// Decoded-index scan kernels for Hopper (sm_90a): K8, K9 and K10.
//
// Replaces rayuela_tpu/search/scan_pallas.py::_scan_kernel_packed and
// ::_scan_kernel_packed_staged (both behind pallas_scan_topk(pack=True)):
//   scan_candidates  <- the two bodies with keep > 0
//   scan_onepass     <- _scan_kernel_packed with keep = 0
// The TPU's staged body gives the same output as its per-tile body: it
// pre-reduces every tile to the same per-lane top-keep and only merges
// its running buffer less often. The output here is defined as a
// function of the scores and (tile, keep, r) alone (see
// scan_common.cuh), so one kernel stands for both bodies and there is
// no `stage` argument. The TPU bodies' optional pre-min (a window
// minimum in front of the selection, which saves selection arithmetic
// there) has no instance here: register insertion rejects most keys
// with one compare, and a window minimum in front of it was measured
// to save no time on this card (its plain version stays, for CPU
// tensors). The TPU keeps one running buffer per query block across a
// sequential tile axis; here every (tile, query block) CTA writes its
// tile's per-lane top-keep and discard minimum, and K2 (cand_merge,
// codes_scan.cu) reduces them to the (r + 1, 128, nq) buffer the TPU
// kernel emits.
//
// K8's kernels are the scan bodies of scan_common.cuh over the row
// source of this file: the 128 rows of a row id are a contiguous block of the
// decoded base Xd (n, dp), dp a multiple of 8, already at the operand
// type, and their norms come from x2 (n,) f32. The scores are those of
// K1: the same f32 dot in dimension order plus x2. A row wider than 256
// (GIST's d = 960) goes through in d-blocks of 128 (scan_common.cuh).
//
// K9 and K10 replace scan_pallas.py::_scan_kernel and ::_verify_kernel
// (pallas_scan_topk(pack=False), the idbits = 0 form of the counting
// pass: the packed branch of the JAX host code returns before it):
//   scan_f32_candidates  <- _scan_kernel's distance block and per-tile
//                           selection; pair_merge (codes_scan.cu) stands
//                           for its running (r, 128, bq) buffer
//   scan_verify_counts   <- _verify_kernel
// Both are one body (`exact_rows_kernel`, at the end of this file) with
// the selecting and the counting sink of scan_common.cuh: one scoring
// code, so the counts are taken on the very scores the selection saw.
// What bounds them and what the body does about it is said there.
//
// What bounds K8 on the card. n*nq*dp multiply-adds on the CUDA cores
// (1.3e12 at n=1e6, nq=1e4, dp=128), as K1, without K1's decode. Every
// CTA reads its whole tile (2 MB in bf16) from device memory or L2; the
// grid runs the query blocks of one tile together, so a tile comes from
// device memory once or twice and from L2 for the other query blocks.
// A warp reads 64- or 128-byte runs of a row (whole sectors) and writes
// them transposed into shared memory at distinct banks, four loads in
// flight per thread. scan_onepass (keep = 0) is the one-pass body of
// scan_common.cuh over the same rows (`load_lanes`: a lane group's rows
// are one contiguous run of Xd): it reads a row once per query block of
// its CTA (up to 32 queries), and the query blocks of one lane group and
// split are neighbours in the grid, so they find its rows in L2; it does
// K8's multiply-adds for the queries it is given, and with few queries
// its row range is split over CTAs as K4's is.

#include "scan_common.cuh"

namespace {

constexpr int LOAD_BATCH = 4;  // 16-byte loads a thread keeps in flight

// Row source of K8: rows of the decoded base.
template <typename T> struct RowsSrc {
  using Op = T;
  static constexpr bool kQueryFastest = true;
  const T* Xd;
  const float* x2;
  __host__ __device__ int words() const { return 0; }
  // A warp pass takes V lanes x 32/V chunks of 16 bytes: thread t reads
  // chunk c0 + t % (32/V) of lane l0 + t / (32/V), so 32/V neighbours
  // read one contiguous run, and element e of the chunk goes to bank
  // (V * (t % (32/V)) + t / (32/V) + e) % 32, distinct over the warp.
  // The d-block [b0, b0 + nb) is chunks b0/V .. (b0 + nb)/V of a row (nb
  // and b0 are multiples of 8).
  __device__ __forceinline__ void load(int n, int rid, int b0, int nb,
                                       int dp, float* XsT, float* x2s,
                                       int*) const {
    constexpr int V = Vec16<T>::N;
    constexpr int CW = 32 / V;
    const int cpr = nb / V;               // 16-byte chunks of the block
    const int cb = b0 / V;                // its first chunk in the row
    const int t = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int lgroups = LANES / V;
    const int items = lgroups * ((cpr + CW - 1) / CW);
    const long long g0 = (long long)rid * LANES;
    for (int it0 = warp; it0 < items; it0 += nwarps * LOAD_BATCH) {
      uint4 u[LOAD_BATCH];
#pragma unroll
      for (int b = 0; b < LOAD_BATCH; ++b) {
        const int it = it0 + b * nwarps;
        const int lane = (it % lgroups) * V + t / CW;
        const int c = (it / lgroups) * CW + t % CW;
        const long long gid = g0 + lane;
        u[b] = make_uint4(0u, 0u, 0u, 0u);
        if (it < items && c < cpr && gid < n)
          u[b] = __ldg(reinterpret_cast<const uint4*>(Xd + (size_t)gid * dp) +
                       cb + c);
      }
#pragma unroll
      for (int b = 0; b < LOAD_BATCH; ++b) {
        const int it = it0 + b * nwarps;
        const int lane = (it % lgroups) * V + t / CW;
        const int c = (it / lgroups) * CW + t % CW;
        if (it < items && c < cpr) {
          float v[V];
#pragma unroll
          for (int e = 0; e < V; ++e) v[e] = 0.f;
          Vec16<T>::add(u[b], v);
#pragma unroll
          for (int e = 0; e < V; ++e) XsT[(c * V + e) * LP + lane] = v[e];
        }
      }
    }
    if (threadIdx.x < LANES) {
      const long long gid = g0 + threadIdx.x;
      x2s[threadIdx.x] = gid < n ? x2[gid] : 0.f;
    }
    __syncthreads();
  }
  __host__ __device__ int lane_words() const { return 0; }
  // The NL lanes [l0, l0 + NL) of the NR row ids rid .. rid + NR - 1
  // (NR runs of NL consecutive rows of Xd) at dimensions [b0, b0 + nb),
  // row by row at the operand type: item i is chunk i % cpr of row j =
  // i / cpr (row id rid + j / NL, lane l0 + j % NL), so neighbouring
  // threads read one contiguous run, and its 16 bytes go to Xs[j * xs +
  // c * V ..) as they are.
  template <int NL, int NR>
  __device__ __forceinline__ void load_lanes(int n, int rid, int l0, int b0,
                                             int nb, int dp, T* Xs, int xs,
                                             float* x2s, int*) const {
    constexpr int V = Vec16<T>::N;
    const int cpr = nb / V, cb = b0 / V, items = NL * NR * cpr;
    for (int it0 = threadIdx.x; it0 < items;
         it0 += blockDim.x * LOAD_BATCH) {
      uint4 u[LOAD_BATCH];
#pragma unroll
      for (int b = 0; b < LOAD_BATCH; ++b) {
        const int it = it0 + b * blockDim.x, j = it / cpr;
        const long long gid =
            (long long)(rid + j / NL) * LANES + l0 + j % NL;
        u[b] = make_uint4(0u, 0u, 0u, 0u);
        if (it < items && gid < n)
          u[b] = __ldg(reinterpret_cast<const uint4*>(Xd + (size_t)gid * dp) +
                       cb + it % cpr);
      }
#pragma unroll
      for (int b = 0; b < LOAD_BATCH; ++b) {
        const int it = it0 + b * blockDim.x;
        if (it < items)
          *reinterpret_cast<uint4*>(Xs + (it / cpr) * xs + (it % cpr) * V) =
              u[b];
      }
    }
    for (int j = threadIdx.x; j < NL * NR; j += blockDim.x) {
      const long long gid = (long long)(rid + j / NL) * LANES + l0 + j % NL;
      x2s[j] = gid < n ? x2[gid] : 0.f;
    }
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// K9 and K10: the exact-float body
// ---------------------------------------------------------------------------
// What bounds it on the card: n*nq*dp multiply-adds on the CUDA cores
// (1.28e12 at n = 1e6, nq = 1e4, dp = 128: 38.2 ms at 67 TFLOP/s). Each
// (query, row) score is one f32 chain, acc = 0, acc = fmaf(x, q, acc)
// over the dimensions in ascending order (bf16 operands widened
// exactly), then acc + x2: the arithmetic of the body this one replaced
// (scan_common.cuh's 4 x 4 blocks), so the outputs are the same bits.
// What the design does about the bound:
//  - A CTA scores EX_QB = 64 queries against EX_LC lanes of the tile,
//    walking the tile's row ids in groups of EX_RG = 8. A thread owns one
//    lane and EX_QT queries (qg + EX_QB / EX_QT * j), and scores a
//    group's 8 row ids of its lane against them: 8 * EX_QT chains in
//    registers but only EX_QT (lane, query) pairs of sink state, which it
//    pushes in row-id order once a group is scored, so a pair still
//    meets its rows in ascending gid. Per 4 dimensions a thread issues
//    EX_QT + 8 16-byte shared loads (bf16 rows: 8-byte loads and one
//    widening a value) for 32 * EX_QT fmaf.
//  - Rows and queries are staged in chunks of EX_KC = 64 dimensions by
//    cp.async, EX_STAGES = 2 deep: the next stage loads while this one
//    is scored, one barrier a stage (with two CTAs an SM a shorter chunk
//    or a deeper ring spends more on barriers and copies than it hides).
//    A row chunk is 128 or 256 contiguous bytes of Xd (whole sectors);
//    staged rows and queries sit row-major with a 16-byte pad, so the
//    rows and queries a quarter-warp's load instruction reads fall in
//    distinct banks. Each thread's copies have fixed row and piece
//    offsets, so a stage's addresses are one add.
//  - The sink state is small, so the CTA fits in EX_MINB CTAs' share of
//    the registers and shared memory: two CTAs an SM interleave their
//    barriers and loads.
//  - The queries travel with the rows in the same stage (any dp, no
//    d-block special case): a CTA reads its queries once per group of
//    8 row ids, against once per row id and d-block before.
//  - The grid runs the query blocks of one (tile, lane block) together,
//    so its rows come from device memory about once and from L2 for the
//    other query blocks: a row is read from L2 once per 64 queries.
//  - Thread qg of a lane writes queries qg + EX_QB / EX_QT * j: the
//    finish writes EX_QB / EX_QT consecutive queries of a lane at once.
constexpr int EX_QB = 64;      // queries per CTA
constexpr int EX_LC = 16;      // lanes per CTA
constexpr int EX_RG = 8;       // row ids per group (a thread's rows)
constexpr int EX_QT = 4;       // queries per thread
constexpr int EX_KC = 64;      // dimensions per stage
constexpr int EX_STAGES = 2;   // stages in flight
constexpr int EX_MINB = 2;     // CTAs an SM holds
constexpr int EX_QG = EX_QB / EX_QT;     // query groups of a lane
constexpr int EX_QROW = 4 * EX_KC + 16;  // bytes of a staged query (f32)
static_assert(EX_LC * EX_QG == THREADS, "one thread a (lane, query group)");

template <typename T>
__host__ __device__ constexpr int ex_xrow() {  // bytes of a staged row
  return (int)sizeof(T) * EX_KC + 16;
}
template <typename T>
__host__ __device__ constexpr int ex_stage() {
  return EX_RG * EX_LC * ex_xrow<T>() + EX_QB * EX_QROW;
}
template <typename T>
__host__ __device__ constexpr int ex_smem() {
  return EX_STAGES * ex_stage<T>();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four dimensions [kk, kk + 4) of a staged row, widened to f32.
__device__ __forceinline__ void row4(const unsigned char* row, int kk,
                                     const float*, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(row + 4 * kk);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void row4(const unsigned char* row, int kk,
                                     const __nv_bfloat16*, float (&v)[4]) {
  // the element at the lower address is the low half of a word
  const uint2 u = *reinterpret_cast<const uint2*>(row + 2 * kk);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xFFFF0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

// A thread's share of a stage's copies. Stage: chunk c (dimensions
// [64 c, 64 c + 64)) of the ng <= EX_RG row ids rid0 .. of lanes [l0, l0 +
// EX_LC) (row rid0 + i, lane l0 + ll at slot i * EX_LC + ll), then of
// queries [q0, q0 + EX_QB); zeros past n, nq, dp. Copy k of a thread
// takes piece `pc` of slot `slot + k * dslot` (rows) or of query
// `qq + k * dq`: the piece and the lane (query) are the thread's for good.
template <typename T> struct ExCopies {
  static constexpr int V = 16 / (int)sizeof(T);  // elements of a piece
  static constexpr int PR = EX_KC / V;           // pieces of a staged row
  static constexpr int NX = EX_RG * EX_LC * PR / THREADS;  // row copies
  static constexpr int NQ = EX_QB * (EX_KC / 4) / THREADS;  // query copies
  static constexpr int DI = THREADS / PR / EX_LC;  // row ids between copies
  static constexpr int DQ = THREADS / (EX_KC / 4);  // queries between copies
  static_assert(NX * THREADS == EX_RG * EX_LC * PR && DI * EX_LC * PR ==
                THREADS && NQ * THREADS == EX_QB * (EX_KC / 4), "layout");
  int i0, lane, pc, qq, qpc;
  __device__ ExCopies(int l0) {
    const int row = threadIdx.x / PR;
    pc = threadIdx.x % PR;
    i0 = row / EX_LC;
    lane = l0 + row % EX_LC;
    qq = threadIdx.x / (EX_KC / 4);
    qpc = threadIdx.x % (EX_KC / 4);
  }
  __device__ __forceinline__ void issue(unsigned char* stage,
                                        const T* __restrict__ Xd,
                                        const float* __restrict__ Qf, int n,
                                        int nq, int dp, int rid0, int ng,
                                        int q0, int c) const {
    const int k0 = c * EX_KC;
    const int kx = k0 + pc * V, kq = k0 + qpc * 4;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const int i = i0 + k * DI;
      const long long gid = (long long)(rid0 + i) * LANES + lane;
      const bool ok = i < ng && gid < n && kx < dp;
      cp_async16(stage + ((i * EX_LC + lane % EX_LC) * ex_xrow<T>() +
                          pc * 16),
                 ok ? Xd + gid * dp + kx : Xd, ok);
    }
    unsigned char* qst = stage + EX_RG * EX_LC * ex_xrow<T>();
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const int q = q0 + qq + k * DQ;
      const bool ok = q < nq && kq < dp;
      cp_async16(qst + (qq + k * DQ) * EX_QROW + qpc * 16,
                 ok ? Qf + (size_t)q * dp + kq : Qf, ok);
    }
  }
};

// The exact-float body (K9 with a SelectSink, K10 with the CountSink):
// CTA (query block, lane block, tile) over Xd (n, dp) at T, the norms x2
// and the f32 queries Qf (nq, dp), -2q widened exactly.
template <typename T, class Sink>
__global__ void __launch_bounds__(THREADS, EX_MINB)
    exact_rows_kernel(const T* __restrict__ Xd, const float* __restrict__ x2,
                      const float* __restrict__ Qf, const Sink sink, int n,
                      int nq, int dp, int rows) {
  extern __shared__ __align__(16) unsigned char exsm[];
  const int q0 = blockIdx.x * EX_QB, l0 = blockIdx.y * EX_LC;
  const int t = blockIdx.z;
  const int qg = threadIdx.x % EX_QG, ll = threadIdx.x / EX_QG;
  const int lane = l0 + ll;
  const int nch = (dp + EX_KC - 1) / EX_KC;
  const int nst = (rows + EX_RG - 1) / EX_RG * nch;
  const ExCopies<T> cp(l0);

  typename Sink::State st[EX_QT];
#pragma unroll
  for (int j = 0; j < EX_QT; ++j) sink.init(st[j], q0 + qg + EX_QG * j, nq);
  float acc[EX_RG][EX_QT];
#pragma unroll
  for (int i = 0; i < EX_RG; ++i)
#pragma unroll
    for (int j = 0; j < EX_QT; ++j) acc[i][j] = 0.f;

  // stage s: group s / nch, chunk s % nch, buffer s % EX_STAGES
  auto issue = [&](int s) {
    const int g = s / nch;
    cp.issue(exsm + (s % EX_STAGES) * ex_stage<T>(), Xd, Qf, n, nq, dp,
             t * rows + g * EX_RG, min(EX_RG, rows - g * EX_RG), q0,
             s - g * nch);
  };
#pragma unroll
  for (int s = 0; s < EX_STAGES - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }
  int g = 0, c = 0;
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<EX_STAGES - 2>();
    __syncthreads();  // stage s has landed; stage s - 1 is read by all
    if (s + EX_STAGES - 1 < nst) issue(s + EX_STAGES - 1);
    cp_async_commit();
    const unsigned char* stage = exsm + (s % EX_STAGES) * ex_stage<T>();
    const unsigned char* xs = stage + ll * ex_xrow<T>();
    const unsigned char* qs =
        stage + EX_RG * EX_LC * ex_xrow<T>() + qg * EX_QROW;
    const int nd = min(EX_KC, dp - c * EX_KC);
    const bool last = c == nch - 1;
    float x2v[EX_RG];
    if (last) {  // the norms of the group's rows, ahead of their use
#pragma unroll
      for (int i = 0; i < EX_RG; ++i) {
        const long long gid =
            (long long)(t * rows + g * EX_RG + i) * LANES + lane;
        x2v[i] = gid < n && g * EX_RG + i < rows ? __ldg(x2 + gid) : 0.f;
      }
    }
#pragma unroll 1
    for (int kk = 0; kk < nd; kk += 4) {
      float4 qv[EX_QT];
#pragma unroll
      for (int j = 0; j < EX_QT; ++j)
        qv[j] = *reinterpret_cast<const float4*>(qs + j * EX_QG * EX_QROW +
                                                 4 * kk);
#pragma unroll
      for (int i = 0; i < EX_RG; ++i) {
        float xv[4];
        row4(xs + i * EX_LC * ex_xrow<T>(), kk, (const T*)nullptr, xv);
#pragma unroll
        for (int j = 0; j < EX_QT; ++j) {
          acc[i][j] = fmaf(xv[0], qv[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv[1], qv[j].y, acc[i][j]);
          acc[i][j] = fmaf(xv[2], qv[j].z, acc[i][j]);
          acc[i][j] = fmaf(xv[3], qv[j].w, acc[i][j]);
        }
      }
    }
    if (last) {  // the group is scored: push in row-id order
      const int ng = min(EX_RG, rows - g * EX_RG);
#pragma unroll
      for (int i = 0; i < EX_RG; ++i) {
        const int step = g * EX_RG + i;
        const long long gid = (long long)(t * rows + step) * LANES + lane;
        if (i < ng) {
#pragma unroll
          for (int j = 0; j < EX_QT; ++j)
            sink.push(st[j], gid >= n ? pos_inf() : acc[i][j] + x2v[i],
                      step, (int)gid);
        }
#pragma unroll
        for (int j = 0; j < EX_QT; ++j) acc[i][j] = 0.f;
      }
      ++g;
      c = 0;
    } else {
      ++c;
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < EX_QT; ++j) {
    const int q = q0 + qg + EX_QG * j;
    if (q < nq) sink.finish(st[j], t, rows, lane, q, nq);
  }
}

template <typename T, class Sink>
cudaError_t launch_exact(const void* Qf, const void* Xd, const void* x2,
                         const Sink& sink, int n, int nq, int dp, int ntiles,
                         int rows, cudaStream_t st) {
  const dim3 grid((nq + EX_QB - 1) / EX_QB, LANES / EX_LC, ntiles);
  return launch_scan(exact_rows_kernel<T, Sink>, grid, ex_smem<T>(), st,
                     (const T*)Xd, (const float*)x2, (const float*)Qf, sink,
                     n, nq, dp, rows);
}

}  // namespace

extern "C" {

int rq_scan_candidates(const void* Qm, const void* Xd, const void* x2,
                       void* cand, void* disc, int n, int nq, int dp,
                       int ntiles, int rows, int keep, int idbits, int bf16,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RQ_K8(T, K)                                                       \
  return (int)launch_candidates<RowsSrc<T>, K>(                           \
      RowsSrc<T>{(const T*)Xd, (const float*)x2}, Qm, cand, disc, n, nq,  \
      dp, ntiles, rows, idbits, st)
  if (bf16) {
    switch (keep) {
      case 2: RQ_K8(__nv_bfloat16, 2);
      case 4: RQ_K8(__nv_bfloat16, 4);
    }
  } else {
    switch (keep) {
      case 2: RQ_K8(float, 2);
      case 4: RQ_K8(float, 4);
    }
  }
#undef RQ_K8
  return (int)cudaErrorInvalidValue;
}

// K8 at keep = 0: the one-pass body at qb queries a CTA (the layout's)
// over row ids split rows_per a CTA.
int rq_scan_onepass(const void* Qm, const void* Xd, const void* x2,
                    void* cand, void* disc, int n, int nq, int dp, int nrows,
                    int rows_per, int qb, int r, int idbits, int bf16,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RQ_K8_1P(T, R)                                                     \
  return (int)launch_topk<RowsSrc<T>, R>(                                  \
      RowsSrc<T>{(const T*)Xd, (const float*)x2}, Qm, cand, disc, n, nq,   \
      dp, nrows, rows_per, qb, idbits, st)
  if (r == 48) {
    if (bf16) RQ_K8_1P(__nv_bfloat16, 48);
    RQ_K8_1P(float, 48);
  }
#undef RQ_K8_1P
  return (int)cudaErrorInvalidValue;
}

// The layout of K8 at keep = 0 at width dp into out[5] (as
// rq_codes_topk_layout: queries per CTA, lanes per CTA, CTAs per SM, the
// d-block, shared bytes per CTA).
int rq_scan_onepass_layout(int dp, int r, int bf16, void* out) {
  if (r != 48) return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)topk_layout<RowsSrc<__nv_bfloat16>, 48>(dp, 0, (int*)out);
  return (int)topk_layout<RowsSrc<float>, 48>(dp, 0, (int*)out);
}

// K9, pass 1: per tile and (lane, query) the `keep` smallest (f32
// score, gid) pairs → candv, candi (ntiles * keep, 128, nq). Qf is -2q
// in f32 (a bf16 operand widened exactly), Xd at the operand type.
int rq_scan_f32_candidates(const void* Qf, const void* Xd, const void* x2,
                           void* candv, void* candi, int n, int nq, int dp,
                           int ntiles, int rows, int keep, int bf16,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RQ_K9(T, K)                                                     \
  return (int)launch_exact<T>(Qf, Xd, x2,                               \
                              SelectSink<K>{(float*)candv, (int*)candi}, \
                              n, nq, dp, ntiles, rows, st)
  if (bf16) {
    switch (keep) {
      case 2: RQ_K9(__nv_bfloat16, 2);
      case 4: RQ_K9(__nv_bfloat16, 4);
    }
  } else {
    switch (keep) {
      case 2: RQ_K9(float, 2);
      case 4: RQ_K9(float, 4);
    }
  }
#undef RQ_K9
  return (int)cudaErrorInvalidValue;
}

// K10: per (lane, query) the rows before (taus[q], taui[q]) in the order
// (score, gid), summed over the tiles into cnt[0] and their largest
// per-tile count into cnt[1]; cnt (2, 128, nq) arrives zeroed. Operands
// as K9's.
int rq_scan_verify_counts(const void* Qf, const void* Xd, const void* x2,
                          const void* taus, const void* taui, void* cnt,
                          int n, int nq, int dp, int ntiles, int rows,
                          int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const CountSink sink{(const float*)taus, (const int*)taui, (int*)cnt};
  if (bf16)
    return (int)launch_exact<__nv_bfloat16>(Qf, Xd, x2, sink, n, nq, dp,
                                            ntiles, rows, st);
  return (int)launch_exact<float>(Qf, Xd, x2, sink, n, nq, dp, ntiles, rows,
                                  st);
}

// The layout of K9 and K10 into out[8] (scan._exact_layout mirrors the
// first seven): queries per CTA, lanes per CTA, queries per thread, row
// ids per group, dimensions per stage, stages, bytes of shared memory
// per CTA, and the CTAs an SM holds at once (of the selecting instance
// at `keep`, or the counting one at keep = 0).
int rq_exact_layout(int keep, int bf16, void* out) {
  int* o = (int*)out;
  o[0] = EX_QB;
  o[1] = EX_LC;
  o[2] = EX_QT;
  o[3] = EX_RG;
  o[4] = EX_KC;
  o[5] = EX_STAGES;
  o[6] = bf16 ? ex_smem<__nv_bfloat16>() : ex_smem<float>();
#define RQ_OCC(T, S)                                                       \
  do {                                                                     \
    auto kern = exact_rows_kernel<T, S>;                                   \
    cudaError_t e = cudaFuncSetAttribute(                                  \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, o[6]);          \
    if (e != cudaSuccess) return (int)e;                                   \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(             \
        &o[7], kern, THREADS, o[6]);                                       \
  } while (0)
  if (bf16) {
    if (keep == 2) RQ_OCC(__nv_bfloat16, SelectSink<2>);
    if (keep == 4) RQ_OCC(__nv_bfloat16, SelectSink<4>);
    if (keep == 0) RQ_OCC(__nv_bfloat16, CountSink);
  } else {
    if (keep == 2) RQ_OCC(float, SelectSink<2>);
    if (keep == 4) RQ_OCC(float, SelectSink<4>);
    if (keep == 0) RQ_OCC(float, CountSink);
  }
#undef RQ_OCC
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
