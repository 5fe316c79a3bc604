// LUT-mode code scan kernels for Hopper (sm_90a): K5, K6 and K7.
//
// Replaces rayuela_tpu/search/scan_codes_pallas.py::
// _codes_scan_kernel_packed (scores by _lut_scores), behind
// pallas_scan_codes_topk(pack=True). Row gid (lane gid % 128, row id
// rid = gid >> 7) scores
//   s[gid, q] = sum_j T[j*h + code_j(gid), q],  j = 0 .. m'-1 in order,
// with T (m'*h, nq) the per-query tables at the table type (f32 or
// bf16; the values are rounded to it before the sum, the sum is f32),
// code_j byte j % 4 of word j / 4 of the row's packed codes, the norms
// byte last, and +inf for pad rows gid >= n. Keys and selection are
// those of scan_common.cuh: CTA (tile, query block) writes, per (lane,
// query), the tile's KEEP smallest keys ascending and the smallest
// other key, and K2 (cand_merge, codes_scan.cu) reduces the tiles to
// the (r + 1, 128, nq) buffer the TPU kernel emits; the TPU's sequential
// tile axis with its running buffer has no counterpart on this card.
//
// K6 and K7 replace ::_codes_scan_kernel and ::_codes_verify_kernel
// (pallas_scan_codes_topk(pack=False); the idbits = 0 form of the
// counting pass, the only one the JAX host code reaches): the same table
// fill and the same sums as K5, handed to the selecting and the counting
// sink of scan_common.cuh. codes_lut_f32_candidates writes per tile and
// (lane, query) the `keep` smallest (f32 score, gid) pairs, which
// pair_merge (codes_scan.cu) reduces to the (r, 128, nq) buffers of the
// TPU kernel; codes_lut_verify_counts counts the rows before a query's
// boundary. Both are bound as K5 is, by their table reads from shared
// memory; with f32 tables a CTA's 16 queries take 128 KB of it.
//
// What bounds it on the card. n*nq*m' table reads from shared memory
// and as many f32 adds (8e10 at n=1e6, nq=1e4, m'=8); the one-hot
// matmuls of the TPU body are plain lookups here. A CTA keeps the
// tables of 16 queries in shared memory, two queries interleaved per
// entry, so one 4- or 8-byte shared load serves two (row, query) sums:
// 64 KB in bf16 and 128 KB in f32 at m'*h = 2048 (dynamic shared
// memory, opted in). The 32 rows of a warp hold random codes, so their
// loads of one table collide on banks: the expected cost of a lookup
// scan, measured and not engineered around. The codes come straight
// from device memory, 32 consecutive rows per warp load.

#include "scan_common.cuh"

namespace {

constexpr int K5_QB = 16;  // queries per CTA: 8 warps x 2

// A table entry for two queries, and its two values as f32.
template <typename T> struct Pair;
template <> struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ type make(float a, float b) {
    return make_float2(a, b);
  }
  static __device__ __forceinline__ void add(const type& v, float& a,
                                             float& b) {
    a += v.x;
    b += v.y;
  }
};
template <> struct Pair<__nv_bfloat16> {
  using type = unsigned;  // low half the first query's bf16, high the second's
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.f);
  }
  static __device__ __forceinline__ type make(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
    return (unsigned)__bfloat16_as_ushort(a) |
           ((unsigned)__bfloat16_as_ushort(b) << 16);
  }
  static __device__ __forceinline__ void add(const type& v, float& a,
                                             float& b) {
    a += __uint_as_float(v << 16);
    b += __uint_as_float(v & 0xFFFF0000u);
  }
};

// The tables of the CTA's 16 queries, two queries interleaved per
// entry: Ts[pair * mh + row]. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void lut_fill_tables(
    const T* __restrict__ Tq, int q0, int nq, int mh,
    typename Pair<T>::type* Ts) {
  const T zero = Pair<T>::zero();
  for (int i = threadIdx.x; i < (K5_QB / 2) * mh; i += blockDim.x) {
    const int row = i / (K5_QB / 2), qa = q0 + 2 * (i % (K5_QB / 2));
    const T a = qa < nq ? Tq[(size_t)row * nq + qa] : zero;
    const T b = qa + 1 < nq ? Tq[(size_t)row * nq + qa + 1] : zero;
    Ts[(i % (K5_QB / 2)) * mh + row] = Pair<T>::make(a, b);
  }
  __syncthreads();
}

// The scores of rows g0 + 32 i, i < 4, against the warp's two queries
// (tables Tw): f32 sums in codebook order, the norms table last.
template <typename T>
__device__ __forceinline__ void lut_block_scores(
    const typename Pair<T>::type* Tw, const int* __restrict__ packed,
    long long g0, int n, int nw, int mprime, int h, float (&acc)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int w = 0; w < nw; ++w) {
    unsigned wd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long gid = g0 + 32 * i;
      wd[i] = gid < n ? (unsigned)__ldg(packed + gid * nw + w) : 0u;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = 4 * w + b;
      if (j < mprime) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Pair<T>::add(Tw[j * h + (int)((wd[i] >> (8 * b)) & 0xFFu)],
                       acc[i][0], acc[i][1]);
      }
    }
  }
}

// grid (ntiles, cdiv(nq, 16)). Warp w of CTA (t, qb) serves queries
// q0 + 2w and q0 + 2w + 1; its thread lg the lanes lg + 32 i, i < 4.
template <typename T, int KEEP>
__global__ void __launch_bounds__(THREADS)
    lut_candidates_kernel(const T* __restrict__ Tq,
                          const int* __restrict__ packed,
                          int* __restrict__ cand, int* __restrict__ disc,
                          int n, int nq, int mprime, int h, int nw, int rows,
                          int idbits) {
  using P = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* Ts = reinterpret_cast<P*>(smem_raw);  // (K5_QB / 2) * mprime * h
  const int mh = mprime * h;
  const int t = blockIdx.x, q0 = blockIdx.y * K5_QB;
  const int lg = threadIdx.x & 31, qg = threadIdx.x >> 5;
  const int vmask = -(1 << idbits);
  lut_fill_tables<T>(Tq, q0, nq, mh, Ts);
  const P* Tw = Ts + qg * mh;

  int best[4][2][KEEP];
  int rest[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      rest[i][j] = INT_MAX;
#pragma unroll
      for (int c = 0; c < KEEP; ++c) best[i][j][c] = INT_MAX;
    }

  for (int step = 0; step < rows; ++step) {
    const int rid = t * rows + step;
    const long long g0 = (long long)rid * LANES + lg;
    float acc[4][2];
    lut_block_scores<T>(Tw, packed, g0, n, nw, mprime, h, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool pad = g0 + 32 * i >= n;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float s = pad ? __int_as_float(0x7F800000) : acc[i][j];
        insert_sorted<KEEP>(best[i][j], rest[i][j], row_key(s, rid, vmask));
      }
    }
  }

  const size_t plane = (size_t)LANES * nq;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = q0 + qg * 2 + j;
      if (q >= nq) continue;
      const size_t off = (size_t)(lg + 32 * i) * nq + q;
#pragma unroll
      for (int c = 0; c < KEEP; ++c)
        cand[(size_t)(t * KEEP + c) * plane + off] = best[i][j][c];
      disc[(size_t)t * plane + off] = rest[i][j];
    }
}

template <typename T, int KEEP>
cudaError_t launch_lut(const void* Tq, const void* packed, void* cand,
                       void* disc, int n, int nq, int mprime, int h, int nw,
                       int ntiles, int rows, int idbits, cudaStream_t st) {
  const size_t smem =
      sizeof(typename Pair<T>::type) * (size_t)(K5_QB / 2) * mprime * h;
  auto kern = lut_candidates_kernel<T, KEEP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(ntiles, (nq + K5_QB - 1) / K5_QB);
  kern<<<grid, THREADS, smem, st>>>((const T*)Tq, (const int*)packed,
                                    (int*)cand, (int*)disc, n, nq, mprime, h,
                                    nw, rows, idbits);
  return cudaGetLastError();
}

// K6 (a SelectSink) and K7 (the CountSink): the grid, blocking, table
// fill and sums of K5, the scores handed to the sink.
template <typename T, class Sink>
__global__ void __launch_bounds__(THREADS)
    lut_exact_kernel(const T* __restrict__ Tq, const int* __restrict__ packed,
                     const Sink sink, int n, int nq, int mprime, int h,
                     int nw, int rows) {
  using P = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* Ts = reinterpret_cast<P*>(smem_raw);  // (K5_QB / 2) * mprime * h
  const int mh = mprime * h;
  const int t = blockIdx.x, q0 = blockIdx.y * K5_QB;
  const int lg = threadIdx.x & 31, qg = threadIdx.x >> 5;
  lut_fill_tables<T>(Tq, q0, nq, mh, Ts);
  const P* Tw = Ts + qg * mh;

  typename Sink::State st[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) sink.init(st[i][j], q0 + qg * 2 + j, nq);

  for (int step = 0; step < rows; ++step) {
    const int g0 = (t * rows + step) * LANES + lg;
    float acc[4][2];
    lut_block_scores<T>(Tw, packed, g0, n, nw, mprime, h, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gid = g0 + 32 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        sink.push(st[i][j], gid >= n ? pos_inf() : acc[i][j], step, gid);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = q0 + qg * 2 + j;
      if (q < nq) sink.finish(st[i][j], t, rows, lg + 32 * i, q, nq);
    }
}

template <typename T, class Sink>
cudaError_t launch_lut_exact(const void* Tq, const void* packed,
                             const Sink& sink, int n, int nq, int mprime,
                             int h, int nw, int ntiles, int rows,
                             cudaStream_t st) {
  const size_t smem =
      sizeof(typename Pair<T>::type) * (size_t)(K5_QB / 2) * mprime * h;
  auto kern = lut_exact_kernel<T, Sink>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(ntiles, (nq + K5_QB - 1) / K5_QB);
  kern<<<grid, THREADS, smem, st>>>((const T*)Tq, (const int*)packed, sink, n,
                                    nq, mprime, h, nw, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int rq_codes_lut_candidates(const void* Tq, const void* packed, void* cand,
                            void* disc, int n, int nq, int mprime, int h,
                            int nw, int ntiles, int rows, int keep,
                            int idbits, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RQ_K5(T, K)                                                       \
  return (int)launch_lut<T, K>(Tq, packed, cand, disc, n, nq, mprime, h,  \
                               nw, ntiles, rows, idbits, st)
  if (bf16) {
    switch (keep) {
      case 2: RQ_K5(__nv_bfloat16, 2);
      case 4: RQ_K5(__nv_bfloat16, 4);
    }
  } else {
    switch (keep) {
      case 2: RQ_K5(float, 2);
      case 4: RQ_K5(float, 4);
    }
  }
#undef RQ_K5
  return (int)cudaErrorInvalidValue;
}

// K6, pass 1: per tile and (lane, query) the `keep` smallest (f32
// score, gid) pairs → candv, candi (ntiles * keep, 128, nq).
int rq_codes_lut_f32_candidates(const void* Tq, const void* packed,
                                void* candv, void* candi, int n, int nq,
                                int mprime, int h, int nw, int ntiles,
                                int rows, int keep, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RQ_K6(T, K)                                                          \
  return (int)launch_lut_exact<T>(Tq, packed,                                \
                                  SelectSink<K>{(float*)candv, (int*)candi}, \
                                  n, nq, mprime, h, nw, ntiles, rows, st)
  if (bf16) {
    switch (keep) {
      case 2: RQ_K6(__nv_bfloat16, 2);
      case 4: RQ_K6(__nv_bfloat16, 4);
    }
  } else {
    switch (keep) {
      case 2: RQ_K6(float, 2);
      case 4: RQ_K6(float, 4);
    }
  }
#undef RQ_K6
  return (int)cudaErrorInvalidValue;
}

// K7: the counts of rq_scan_verify_counts (decoded_scan.cu) on K6's
// scores; cnt (2, 128, nq) arrives zeroed.
int rq_codes_lut_verify_counts(const void* Tq, const void* packed,
                               const void* taus, const void* taui, void* cnt,
                               int n, int nq, int mprime, int h, int nw,
                               int ntiles, int rows, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const CountSink sink{(const float*)taus, (const int*)taui, (int*)cnt};
  if (bf16)
    return (int)launch_lut_exact<__nv_bfloat16>(Tq, packed, sink, n, nq,
                                                mprime, h, nw, ntiles, rows,
                                                st);
  return (int)launch_lut_exact<float>(Tq, packed, sink, n, nq, mprime, h, nw,
                                      ntiles, rows, st);
}

}  // extern "C"
