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
// The kernels are the scan bodies of scan_common.cuh over the row source
// of this file: the 128 rows of a row id are a contiguous block of the
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
// Both are the exact scan body of scan_common.cuh over the same row
// source, with the selecting and the counting sink: one scoring code, so
// the counts are taken on the very scores the selection saw. Each does
// K8's n*nq*dp multiply-adds on the CUDA cores, which bound it (the f32
// CUDA-core rate is the peak for an f32 base); the selecting sink adds
// one compare per score and, rarely, an insertion; the counting sink a
// compare and an add, and one pair of integer atomics per (lane, query,
// tile).
//
// What bounds it on the card. n*nq*dp multiply-adds on the CUDA cores
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
// score, gid) pairs → candv, candi (ntiles * keep, 128, nq).
int rq_scan_f32_candidates(const void* Qm, const void* Xd, const void* x2,
                           void* candv, void* candi, int n, int nq, int dp,
                           int ntiles, int rows, int keep, int bf16,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RQ_K9(T, K)                                                        \
  return (int)launch_exact(RowsSrc<T>{(const T*)Xd, (const float*)x2}, Qm, \
                           SelectSink<K>{(float*)candv, (int*)candi}, n,   \
                           nq, dp, ntiles, rows, st)
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
// per-tile count into cnt[1]; cnt (2, 128, nq) arrives zeroed.
int rq_scan_verify_counts(const void* Qm, const void* Xd, const void* x2,
                          const void* taus, const void* taui, void* cnt,
                          int n, int nq, int dp, int ntiles, int rows,
                          int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const CountSink sink{(const float*)taus, (const int*)taui, (int*)cnt};
  if (bf16)
    return (int)launch_exact(
        RowsSrc<__nv_bfloat16>{(const __nv_bfloat16*)Xd, (const float*)x2},
        Qm, sink, n, nq, dp, ntiles, rows, st);
  return (int)launch_exact(RowsSrc<float>{(const float*)Xd, (const float*)x2},
                           Qm, sink, n, nq, dp, ntiles, rows, st);
}

}  // extern "C"
