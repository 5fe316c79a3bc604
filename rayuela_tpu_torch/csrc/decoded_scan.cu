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
// source of this file, and on bf16 rows its candidates kernel is a body
// of this file (`rows_mma_kernel`): the 128 rows of a row id are a
// contiguous block of the decoded base Xd (n, dp), dp a multiple of 8,
// already at the operand type, and their norms come from x2 (n,) f32. On
// f32 rows the scores are the fmaf chain's (K1's f32 body: the dot in
// dimension order plus x2); on bf16 rows they are the tensor-core score
// of K1, K14 and K4 (`tile_scores`), and where a row is one d-block the
// keys are the fmaf chain's (`margin_keys`), so K8's keys equal K1's on
// the same rows at any width and the f32 body's at one d-block. A row
// wider than 256 (GIST's d = 960) goes through in d-blocks of 128.
//
// K9 and K10 replace scan_pallas.py::_scan_kernel and ::_verify_kernel
// (pallas_scan_topk(pack=False), the idbits = 0 form of the counting
// pass: the packed branch of the JAX host code returns before it):
//   scan_f32_candidates  <- _scan_kernel's distance block and per-tile
//                           selection; pair_merge (codes_scan.cu) stands
//                           for its running (r, 128, bq) buffer
//   scan_verify_counts   <- _verify_kernel
// Both are one body (`exact_rows_kernel`, below) with the selecting and
// the counting sink of scan_common.cuh: one scoring code, so the counts
// are taken on the very scores the selection saw. What bounds them and
// what the body does about it is said there.
//
// What bounds K8 on the card. 2*n*nq*dp operations (2.6e12 at n = 1e6,
// nq = 1e4, dp = 128: 2.6 ms at the bf16 tensor-core peak) and, per
// query block, its tile's rows (2 MB in bf16), which it reads rather than
// decodes. The bf16 body (`rows_mma_kernel`, below, which says what it
// does about the rest) puts the products on the tensor cores and stages
// 128-row steps by cp.async; the grid runs the query blocks of one tile
// together, so a tile comes from device memory about once and from L2 for
// the other query blocks. The f32 body keeps the 4 x 4 fmaf blocks of
// scan_common.cuh (a warp reads 64- or 128-byte runs of a row and writes
// them transposed into shared memory, four loads in flight a thread).
// scan_onepass (keep = 0) is the one-pass body of scan_common.cuh over the
// same rows (`load_lanes`: a lane group's rows are one contiguous run of
// Xd): it reads a row once per query block of its CTA (up to 32 queries),
// and the query blocks of one lane group and split are neighbours in the
// grid, so they find its rows in L2; on bf16 it scores on the tensor
// cores as the candidates body does, and with few queries its row range
// is split over CTAs as K4's is.

#include "scan_common.cuh"

namespace {

constexpr int LOAD_BATCH = 4;  // 16-byte loads a thread keeps in flight

// Row source of K8: rows of the decoded base. On bf16 rows K8 at keep =
// 0 scores on the tensor cores (`tensor_scores`), as its candidates body
// (`rows_mma_kernel`, below) does.
template <typename T> struct RowsSrc {
  using Op = T;
  static constexpr bool kQueryFastest = true;
  static constexpr bool kTensorScores = std::is_same<T, __nv_bfloat16>::value;
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
  // c * V ..) as they are. On bf16 a block that ends inside a chunk of
  // 16 dimensions gets zeros in the rest of it (the tensor-core score
  // reads whole chunks), and with xns (a row of one d-block) the norm of
  // each row's values goes to xns[j] (`group8_norm`).
  template <int NL, int NR>
  __device__ __forceinline__ void load_lanes(int n, int rid, int l0, int b0,
                                             int nb, int dp, T* Xs, int xs,
                                             float* x2s, int*,
                                             float* xns = nullptr) const {
    constexpr int V = Vec16<T>::N;
    const int cpr = nb / V, cb = b0 / V;
    // chunks stored a row: the tail chunk of zeros (bf16, an odd count)
    const int cpe = kTensorScores ? (cpr + 1) & ~1 : cpr;
    const int items = NL * NR * cpe;
    for (int it0 = threadIdx.x; it0 < items;
         it0 += blockDim.x * LOAD_BATCH) {
      uint4 u[LOAD_BATCH];
#pragma unroll
      for (int b = 0; b < LOAD_BATCH; ++b) {
        const int it = it0 + b * blockDim.x, j = it / cpe, c = it % cpe;
        const long long gid =
            (long long)(rid + j / NL) * LANES + l0 + j % NL;
        u[b] = make_uint4(0u, 0u, 0u, 0u);
        if (it < items && c < cpr && gid < n)
          u[b] = __ldg(reinterpret_cast<const uint4*>(Xd + (size_t)gid * dp) +
                       cb + c);
      }
#pragma unroll
      for (int b = 0; b < LOAD_BATCH; ++b) {
        const int it = it0 + b * blockDim.x;
        if (it < items)
          *reinterpret_cast<uint4*>(Xs + (it / cpe) * xs + (it % cpe) * V) =
              u[b];
      }
    }
    for (int j = threadIdx.x; j < NL * NR; j += blockDim.x) {
      const long long gid = (long long)(rid + j / NL) * LANES + l0 + j % NL;
      x2s[j] = gid < n ? x2[gid] : 0.f;
    }
    __syncthreads();
    if constexpr (kTensorScores) {
      if (xns) {  // 8 threads a row; every thread takes the shuffles
        for (int j0 = 0; j0 < NL * NR; j0 += blockDim.x / 8) {
          const int j = j0 + threadIdx.x / 8, g = threadIdx.x % 8;
          const float xn = group8_norm(
              j < NL * NR ? row_sq_part(Xs + j * xs, cpr, g, 0.f) : 0.f);
          if (g == 0 && j < NL * NR) xns[j] = xn;
        }
        __syncthreads();
      }
    }
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

// ---------------------------------------------------------------------------
// K8 on bf16 operands: the tensor-core candidates body
// ---------------------------------------------------------------------------
// What bounded K8's fmaf body (scan_common.cuh's 4 x 4 blocks): n*nq*dp
// multiply-adds on the CUDA cores, 20 shared loads per 64 of them, and a
// step that waited on its own row loads (PERF.md §6: 100.8 ms at d = 128,
// 516 ms at d = 960 on an H100, the library's addmm + topk 270 ms there).
// Here the products go to the tensor cores with the score function of K1,
// K14 and K4 (`tile_scores`: one mma.sync m16n8k16 per 16-dimension
// chunk, ascending, from a zero accumulator, added in f32, then + x2), so
// K8's keys equal K1's on the same rows at any width. What the design
// does about the rest:
//  - A CTA holds RM_QB = 32 queries and walks its tile's row ids, 128
//    rows a step, in stages of up to RM_KC = 128 dimensions copied by
//    cp.async, RM_STAGES = 2 deep: the next stage loads while this one is
//    scored, one barrier a stage, two CTAs an SM. Warp w scores queries
//    [16 (w % 2), +16) against lanes [32 (w / 2), +32), four m16n8 tiles;
//    its thread owns 2 queries x 8 lanes, the same 16 (lane, query) pairs
//    at every step, whose KEEP-deep buffers and certificates stay in
//    registers (K1's selection, unchanged). The grid runs the query blocks
//    of one tile together (query blocks fastest), so a tile comes from
//    device memory about once and from L2 for the other query blocks. K8
//    reads its rows rather than decoding them, so it needs no cluster.
//  - Where a row is one d-block (dp <= NARROW_DP) the queries sit whole in
//    shared memory and the keys are the fmaf chain's (`margin_keys`). The
//    rows' norms that the margin needs come from the staged rows (8
//    threads a row, `row_sq_part`, `group8_norm`: the same bits as K8 at
//    keep = 0), so the index stays 2 d + 4 bytes a vector. The pairs the
//    chain decides (a tensor-core score near a key boundary, below its
//    buffer's threshold) are scored at the end of their step, a warp's
//    side by side, from the staged rows, and each thread inserts its own
//    (K1's structure, RM_CAP requests a warp a pass). Their share depends
//    on the data: where the candidates' scores lie near 0 (a norms term
//    near -2 x.q) a key step there is narrow against the margin, and a
//    few percent of all pairs go to the chain. A variant that held them
//    across steps and scored them from Xd in L2 waited on those loads and
//    ran several times slower on such data (trial variants on an H100,
//    not measured by a script in the repo).
//  - Beyond one d-block (GIST's d = 960) the tensor-core key stands, as in
//    K1, and each stage carries the queries' block with the rows' block,
//    so shared memory does not grow with dp.
//  - A block that ends inside a 16-dimension chunk (dp a multiple of 8,
//    not of 16) is zero-filled there by the copies (cp.async of zero
//    bytes), the queries' pads likewise.
constexpr int RM_QB = 32;           // queries per CTA
constexpr int RM_KC = DBLK;         // dimensions per stage
constexpr int RM_XS = RM_KC + 8;    // bf16 stride of a staged row or query
constexpr int RM_STAGES = 2;        // stages in flight
constexpr int RM_CAP = 256;         // chain requests of a warp's pass
constexpr int RM_WARPS = THREADS / 32;

// Bytes of a stage: 128 rows (and, beyond one d-block, the CTA's queries)
// at RM_XS, then the step's x2 (128 f32).
__host__ __device__ constexpr int rm_stage(bool wide) {
  return 2 * (LANES + (wide ? RM_QB : 0)) * RM_XS + 4 * LANES;
}
// Shared bytes of a CTA at width dp: the stages; at one d-block also the
// queries whole (dp + 8 bf16 a query), the rows' norms and the 8 partial
// sums of each (`row_sq_part`), the queries' margins and each warp's
// RM_CAP chain requests (a key and an item each).
inline size_t rm_smem(int dp) {
  const bool wide = dp > NARROW_DP;
  return (size_t)RM_STAGES * rm_stage(wide) +
         (wide ? 0
               : 2 * (size_t)RM_QB * (dp + 8) + 4 * (9 * LANES + RM_QB) +
                     6 * (size_t)RM_WARPS * RM_CAP);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// K8's candidates on bf16 rows: CTA (query block, tile) writes, per
// (lane, query), the KEEP smallest keys ascending to cand[t * KEEP + c]
// and the smallest other key to disc[t], as the fmaf body does. stats,
// where given, gains the number of pairs the fmaf chain scored.
template <int KEEP, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
    rows_mma_kernel(const __nv_bfloat16* __restrict__ Xd,
                    const float* __restrict__ x2,
                    const __nv_bfloat16* __restrict__ Qm,
                    int* __restrict__ cand, int* __restrict__ disc,
                    int* __restrict__ stats, int n, int nq, int dp, int rows,
                    int idbits) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SB = rm_stage(WIDE);
  constexpr int X2OFF = 2 * (LANES + (WIDE ? RM_QB : 0)) * RM_XS;
  const int qs = dp + 8;
  T* Qs = reinterpret_cast<T*>(smem_raw + RM_STAGES * SB);  // one d-block
  float* xns = reinterpret_cast<float*>(Qs + RM_QB * qs);    // LANES
  float* xsq = xns + LANES;                                  // 8 LANES
  float* qcs = xsq + 8 * LANES;                              // RM_QB
  int* rkeys = reinterpret_cast<int*>(qcs + RM_QB);          // warps x CAP
  unsigned short* ritems =                                   // warps x CAP
      reinterpret_cast<unsigned short*>(rkeys + RM_WARPS * RM_CAP);
  const int t = blockIdx.y, q0 = blockIdx.x * RM_QB;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int qw = (warp & 1) * 16, lw = (warp >> 1) * 32;
  const int vmask = -(1 << idbits);
  const int nblk = (dp + RM_KC - 1) / RM_KC;  // stages a step
  const int nunits = rows * nblk;

  // stage u: block u % nblk of row id t * rows + u / nblk
  auto issue = [&](int u) {
    const int step = u / nblk, blk = u - step * nblk;
    const int b0 = blk * RM_KC, cpr = min(RM_KC, dp - b0) / 8;
    const int cpe = (cpr + 1) & ~1;  // with the chunk of zeros to 16
    unsigned char* st = smem_raw + (u % RM_STAGES) * SB;
    T* Xs = reinterpret_cast<T*>(st);
    const long long g0 = (long long)(t * rows + step) * LANES;
    for (int i = threadIdx.x; i < LANES * cpe; i += THREADS) {
      const int r = i / cpe, c = i - r * cpe;
      const bool ok = c < cpr && g0 + r < n;
      cp_async16(Xs + r * RM_XS + c * 8,
                 ok ? Xd + (size_t)(g0 + r) * dp + b0 + c * 8 : Xd, ok);
    }
    if constexpr (WIDE) {
      T* Qb = Xs + LANES * RM_XS;
      for (int i = threadIdx.x; i < RM_QB * cpe; i += THREADS) {
        const int q = i / cpe, c = i - q * cpe;
        const bool ok = c < cpr && q0 + q < nq;
        cp_async16(Qb + q * RM_XS + c * 8,
                   ok ? Qm + (size_t)(q0 + q) * dp + b0 + c * 8 : Qm, ok);
      }
    }
    if (blk == nblk - 1 && threadIdx.x < LANES) {  // the step's x2
      const long long g = g0 + threadIdx.x;
      cp_async4(reinterpret_cast<float*>(st + X2OFF) + threadIdx.x,
                g < n ? x2 + g : x2, g < n);
    }
  };

  if constexpr (!WIDE) {  // the queries whole (zero pads) and margins
    const int cq = qs / 8;
    for (int i = threadIdx.x; i < RM_QB * cq; i += THREADS) {
      const int q = i / cq, c = i - q * cq;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < dp / 8 && q0 + q < nq)
        v = *reinterpret_cast<const uint4*>(Qm + (size_t)(q0 + q) * dp +
                                            c * 8);
      *reinterpret_cast<uint4*>(Qs + q * qs + c * 8) = v;
    }
    __syncthreads();
    if (threadIdx.x < RM_QB)
      qcs[threadIdx.x] = slack_of_query(Qs + threadIdx.x * qs, dp);
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < RM_STAGES - 1; ++s) {
    if (s < nunits) issue(s);
    cp_async_commit();
  }

  // pair p = 4 i + e: lane lw + 8 i + 2 (l % 4) + e % 2, query q0 + qw +
  // l / 4 + 8 (e / 2) (`tile_scores`' accumulator)
  int best[16][KEEP];
  int rest[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    rest[p] = INT_MAX;
#pragma unroll
    for (int c = 0; c < KEEP; ++c) best[p][c] = INT_MAX;
  }
  // one d-block: the warp's requests for the chain (RM_CAP a pass: keys,
  // then items) and the warp's count of them (nreq); thread (r8, g8) sums
  // the squares of the rows r8 + 32 k for their norms, its partial sums
  // at xsq across the d-blocks of a step
  int* keys = rkeys + warp * RM_CAP;
  unsigned short* item = ritems + warp * RM_CAP;
  int nreq = 0;
  const int g8 = threadIdx.x & 7, r8 = threadIdx.x >> 3;
  float acc[4][4];
  for (int u = 0; u < nunits; ++u) {
    cp_async_wait<RM_STAGES - 2>();
    __syncthreads();  // stage u has landed; stage u - 1 is read by all
    if (u + RM_STAGES - 1 < nunits) issue(u + RM_STAGES - 1);
    cp_async_commit();
    const int step = u / nblk, blk = u - step * nblk;
    const int b0 = blk * RM_KC, nb = min(RM_KC, dp - b0);
    const unsigned char* st = smem_raw + (u % RM_STAGES) * SB;
    const T* Xs = reinterpret_cast<const T*>(st);
    if (blk == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    }
    if constexpr (!WIDE) {
      for (int k = 0; k < LANES * 8 / THREADS; ++k) {
        const int r = r8 + k * (THREADS / 8);
        const float a = row_sq_part(Xs + r * RM_XS, nb / 8, g8,
                                    blk == 0 ? 0.f : xsq[8 * r + g8]);
        if (blk == nblk - 1) {
          const float xn = group8_norm(a);  // every thread takes it
          if (g8 == 0) xns[r] = xn;
        } else {
          xsq[8 * r + g8] = a;
        }
      }
    }
    const int nk = (nb + 15) & ~15;
    if constexpr (WIDE)
      tile_scores<4>(Xs + (LANES + qw) * RM_XS, RM_XS, Xs + lw * RM_XS, RM_XS,
                     nk, acc);
    else
      tile_scores<4>(Qs + qw * qs + b0, qs, Xs + lw * RM_XS, RM_XS, nk, acc);
    if (blk != nblk - 1) continue;

    if constexpr (!WIDE) __syncthreads();  // the rows' norms, for all
    // pair p: the keys lo <= hi its score allows (one key where the score
    // settles it, or beyond one d-block, where the tensor-core key
    // stands), lo in place of the score; eq: the pairs whose key is known,
    // need: those the fmaf chain decides
    const int rid = t * rows + step;
    const float* x2s = reinterpret_cast<const float*>(st + X2OFF);
    unsigned eq = 0, need = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 4 * i + e;
        const int lane = lw + 8 * i + 2 * (l & 3) + (e & 1);
        const bool pad = (long long)rid * LANES + lane >= n;
        const float sc =
            pad ? __int_as_float(0x7F800000) : acc[i][e] + x2s[lane];
        int lo, hi;
        if constexpr (WIDE) {
          lo = hi = row_key(sc, rid, vmask);
        } else {
          margin_keys(sc,
                      score_slack(sc, qcs[qw + (l >> 2) + 8 * (e >> 1)],
                                  xns[lane]),
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
      // the step's requests, in passes of RM_CAP (more than one only where
      // most pairs sit on a key boundary: small-integer data), scored by
      // the chain 32 side by side while the step's rows are staged (at nb
      // = dp; a wider row's first block is gone, and its rows come from
      // Xd), and each inserted by the thread that owns its pair
      int total;
      const int base = warp_offsets(need, total);
      nreq += total;
      for (int off = 0; off < total; off += RM_CAP) {
        const int cnt = min(RM_CAP, total - off);
        int k = base - off;
#pragma unroll
        for (int p = 0; p < 16; ++p)
          if (need >> p & 1) {
            if (k >= 0 && k < cnt) {
              item[k] = (unsigned short)((l << 4) | p);
              keys[k] = __float_as_int(acc[p >> 2][p & 3]);
            }
            ++k;
          }
        warp_chain_keys(item, keys, cnt, [&](int it) {
          const int sl = it >> 4, p = it & 15;
          const int lane = lw + 8 * (p >> 2) + 2 * (sl & 3) + (p & 1);
          const int q = qw + (sl >> 2) + 8 * ((p & 3) >> 1);
          const T* xr = nblk == 1
                            ? Xs + lane * RM_XS
                            : Xd + ((size_t)rid * LANES + lane) * dp;
          return row_key(chain_score(xr, Qs + q * qs, dp, x2s[lane]), rid,
                         vmask);
        });
        k = base - off;
#pragma unroll
        for (int p = 0; p < 16; ++p)
          if (need >> p & 1) {
            if (k >= 0 && k < cnt)
              insert_sorted<KEEP>(best[p], rest[p], keys[k]);
            ++k;
          }
        __syncwarp();  // the arrays are read before the next pass
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (!WIDE) {
    if (stats && l == 0 && nreq) atomicAdd(stats, nreq);
  }

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
#pragma unroll
      for (int c = 0; c < KEEP; ++c)
        cand[(size_t)(t * KEEP + c) * plane + off] = best[p][c];
      disc[(size_t)t * plane + off] = rest[p];
    }
}

template <int KEEP>
auto rows_mma(int dp) -> decltype(&rows_mma_kernel<KEEP, false>) {
  return dp > NARROW_DP ? rows_mma_kernel<KEEP, true>
                        : rows_mma_kernel<KEEP, false>;
}

template <int KEEP>
cudaError_t launch_rows_mma(const void* Qm, const void* Xd, const void* x2,
                            void* cand, void* disc, void* stats, int n,
                            int nq, int dp, int ntiles, int rows, int idbits,
                            cudaStream_t st) {
  const dim3 grid((nq + RM_QB - 1) / RM_QB, ntiles);
  return launch_scan(rows_mma<KEEP>(dp), grid, rm_smem(dp), st,
                     (const __nv_bfloat16*)Xd, (const float*)x2,
                     (const __nv_bfloat16*)Qm, (int*)cand, (int*)disc,
                     (int*)stats, n, nq, dp, rows, idbits);
}

}  // namespace

extern "C" {

// K8: per tile and (lane, query) the keep smallest keys and the
// certificate. bf16 rows take the tensor-core body (`rows_mma_kernel`);
// stats (bf16 only, may be null) gains the pairs the fmaf chain scored.
int rq_scan_candidates(const void* Qm, const void* Xd, const void* x2,
                       void* cand, void* disc, void* stats, int n, int nq,
                       int dp, int ntiles, int rows, int keep, int idbits,
                       int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    switch (keep) {
      case 2: return (int)launch_rows_mma<2>(Qm, Xd, x2, cand, disc, stats,
                                             n, nq, dp, ntiles, rows, idbits,
                                             st);
      case 4: return (int)launch_rows_mma<4>(Qm, Xd, x2, cand, disc, stats,
                                             n, nq, dp, ntiles, rows, idbits,
                                             st);
    }
    return (int)cudaErrorInvalidValue;
  }
  const RowsSrc<float> src{(const float*)Xd, (const float*)x2};
  switch (keep) {
    case 2: return (int)launch_candidates<RowsSrc<float>, 2>(
        src, Qm, cand, disc, n, nq, dp, ntiles, rows, idbits, st);
    case 4: return (int)launch_candidates<RowsSrc<float>, 4>(
        src, Qm, cand, disc, n, nq, dp, ntiles, rows, idbits, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K8's layout at width dp into out[5] (scan._candidates_layout mirrors
// the first four): queries per CTA, dimensions per stage, stages, bytes of
// shared memory per CTA, and the CTAs an SM holds at once (of the keep =
// 2 instance; keep = 4 takes the same layout).
int rq_scan_candidates_layout(int dp, int bf16, void* out) {
  int* o = (int*)out;
  const void* kern;
  if (bf16) {
    o[0] = RM_QB;
    o[1] = RM_KC;
    o[2] = RM_STAGES;
    o[3] = (int)rm_smem(dp);
    kern = (const void*)rows_mma<2>(dp);
  } else {
    using S = RowsSrc<float>;
    o[0] = K1_QB;
    o[1] = scan_dblock(dp);
    o[2] = 1;
    o[3] = (int)scan_smem(dp, K1_QB, 0);
    kern = dp > NARROW_DP ? (const void*)scan_candidates_kernel<S, 2, true>
                          : (const void*)scan_candidates_kernel<S, 2, false>;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, o[3]);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[4], kern,
                                                            THREADS, o[3]);
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
