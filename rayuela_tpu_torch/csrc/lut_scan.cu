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
// tables of QB queries in shared memory, two queries interleaved per
// entry, so one 4- or 8-byte shared load serves two (row, query) sums:
// at QB = 16, 64 KB in bf16 and 128 KB in f32 at m'*h = 2048 (dynamic
// shared memory, opted in). Where 16 queries' tables do not fit (f32
// tables at 128 bits: m'*h = 4096 takes 256 KB) a CTA takes 8 queries,
// and a warp serves a query pair for half of the 128 lanes: the same
// sums, half the rows a thread per step. `lut_qb` makes the choice, and
// `rq_lut_layout` reports it. The 32 rows of a warp hold random codes,
// so their loads of one table collide on banks: the expected cost of a
// lookup scan, measured and not engineered around. The codes come
// straight from device memory, 32 consecutive rows per warp load.

#include "scan_common.cuh"

namespace {

constexpr int LUT_QB = 16;  // queries per CTA (8 warps x 2) where they fit

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

// The tables of the CTA's QB queries, two queries interleaved per
// entry: Ts[pair * mh + row]. Ends with a barrier.
template <typename T, int QB>
__device__ __forceinline__ void lut_fill_tables(
    const T* __restrict__ Tq, int q0, int nq, int mh,
    typename Pair<T>::type* Ts) {
  const T zero = Pair<T>::zero();
  for (int i = threadIdx.x; i < (QB / 2) * mh; i += blockDim.x) {
    const int row = i / (QB / 2), qa = q0 + 2 * (i % (QB / 2));
    const T a = qa < nq ? Tq[(size_t)row * nq + qa] : zero;
    const T b = qa + 1 < nq ? Tq[(size_t)row * nq + qa + 1] : zero;
    Ts[(i % (QB / 2)) * mh + row] = Pair<T>::make(a, b);
  }
  __syncthreads();
}

// The scores of rows g0 + 32 i, i < L, against the warp's two queries
// (tables Tw): f32 sums in codebook order, the norms table last.
template <typename T, int L>
__device__ __forceinline__ void lut_block_scores(
    const typename Pair<T>::type* Tw, const int* __restrict__ packed,
    long long g0, int n, int nw, int mprime, int h, float (&acc)[L][2]) {
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int w = 0; w < nw; ++w) {
    unsigned wd[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const long long gid = g0 + 32 * i;
      wd[i] = gid < n ? (unsigned)__ldg(packed + gid * nw + w) : 0u;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = 4 * w + b;
      if (j < mprime) {
#pragma unroll
        for (int i = 0; i < L; ++i)
          Pair<T>::add(Tw[j * h + (int)((wd[i] >> (8 * b)) & 0xFFu)],
                       acc[i][0], acc[i][1]);
      }
    }
  }
}

// The blocking of a LUT CTA with QB queries: 8 warps over QB / 2 query
// pairs, so each pair has 16 / QB warps and a warp's thread lg serves
// the L = QB / 4 lanes lo + lg + 32 i, i < L, from lane lo of the warp's
// share. QB = 16: warp w takes pair w, lanes lg + 32 i, i < 4.
template <int QB> struct LutBlock {
  static constexpr int NP = QB / 2, L = QB / 4;
  int lg, pair, lo;
  __device__ __forceinline__ LutBlock()
      : lg(threadIdx.x & 31),
        pair(QB == LUT_QB ? threadIdx.x >> 5 : (threadIdx.x >> 5) % NP),
        lo(QB == LUT_QB ? 0 : (threadIdx.x >> 5) / NP * 32 * L) {}
};

// grid (ntiles, cdiv(nq, QB)). The warps of CTA (t, qb) that serve pair
// p take queries q0 + 2p and q0 + 2p + 1 (`LutBlock`).
template <typename T, int KEEP, int QB>
__global__ void __launch_bounds__(THREADS)
    lut_candidates_kernel(const T* __restrict__ Tq,
                          const int* __restrict__ packed,
                          int* __restrict__ cand, int* __restrict__ disc,
                          int n, int nq, int mprime, int h, int nw, int rows,
                          int idbits) {
  using P = typename Pair<T>::type;
  constexpr int L = LutBlock<QB>::L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* Ts = reinterpret_cast<P*>(smem_raw);  // (QB / 2) * mprime * h
  const int mh = mprime * h;
  const int t = blockIdx.x, q0 = blockIdx.y * QB;
  const LutBlock<QB> lb;
  const int vmask = -(1 << idbits);
  lut_fill_tables<T, QB>(Tq, q0, nq, mh, Ts);
  const P* Tw = Ts + lb.pair * mh;

  int best[L][2][KEEP];
  int rest[L][2];
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      rest[i][j] = INT_MAX;
#pragma unroll
      for (int c = 0; c < KEEP; ++c) best[i][j][c] = INT_MAX;
    }

  for (int step = 0; step < rows; ++step) {
    const int rid = t * rows + step;
    const long long g0 = (long long)rid * LANES + lb.lo + lb.lg;
    float acc[L][2];
    lut_block_scores<T, L>(Tw, packed, g0, n, nw, mprime, h, acc);
#pragma unroll
    for (int i = 0; i < L; ++i) {
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
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = q0 + lb.pair * 2 + j;
      if (q >= nq) continue;
      const size_t off = (size_t)(lb.lo + lb.lg + 32 * i) * nq + q;
#pragma unroll
      for (int c = 0; c < KEEP; ++c)
        cand[(size_t)(t * KEEP + c) * plane + off] = best[i][j][c];
      disc[(size_t)t * plane + off] = rest[i][j];
    }
}

// Bytes of a LUT CTA's tables at qb queries, m' * h entries a table.
template <typename T> size_t lut_smem(int qb, int mprime, int h) {
  return sizeof(typename Pair<T>::type) * (size_t)(qb / 2) * mprime * h;
}

// Queries per LUT CTA: LUT_QB where their tables fit the shared memory a
// CTA may opt in to, else 8, else 0 (none fits).
template <typename T> int lut_qb(int mprime, int h) {
  int dev = 0, cap = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  for (int qb = LUT_QB; qb >= 8; qb /= 2)
    if (lut_smem<T>(qb, mprime, h) <= (size_t)cap) return qb;
  return 0;
}

template <typename T, int KEEP>
cudaError_t launch_lut(const void* Tq, const void* packed, void* cand,
                       void* disc, int n, int nq, int mprime, int h, int nw,
                       int ntiles, int rows, int idbits, cudaStream_t st) {
  const int qb = lut_qb<T>(mprime, h);
  if (!qb) return cudaErrorInvalidValue;
  const dim3 grid(ntiles, (nq + qb - 1) / qb);
  auto kern = qb == LUT_QB ? lut_candidates_kernel<T, KEEP, LUT_QB>
                           : lut_candidates_kernel<T, KEEP, 8>;
  return launch_scan(kern, grid, lut_smem<T>(qb, mprime, h), st,
                     (const T*)Tq, (const int*)packed, (int*)cand,
                     (int*)disc, n, nq, mprime, h, nw, rows, idbits);
}

// K6 (a SelectSink) and K7 (the CountSink): the grid, blocking, table
// fill and sums of K5, the scores handed to the sink.
template <typename T, class Sink, int QB>
__global__ void __launch_bounds__(THREADS)
    lut_exact_kernel(const T* __restrict__ Tq, const int* __restrict__ packed,
                     const Sink sink, int n, int nq, int mprime, int h,
                     int nw, int rows) {
  using P = typename Pair<T>::type;
  constexpr int L = LutBlock<QB>::L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* Ts = reinterpret_cast<P*>(smem_raw);  // (QB / 2) * mprime * h
  const int mh = mprime * h;
  const int t = blockIdx.x, q0 = blockIdx.y * QB;
  const LutBlock<QB> lb;
  lut_fill_tables<T, QB>(Tq, q0, nq, mh, Ts);
  const P* Tw = Ts + lb.pair * mh;

  typename Sink::State st[L][2];
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) sink.init(st[i][j], q0 + lb.pair * 2 + j, nq);

  for (int step = 0; step < rows; ++step) {
    const int g0 = (t * rows + step) * LANES + lb.lo + lb.lg;
    float acc[L][2];
    lut_block_scores<T, L>(Tw, packed, g0, n, nw, mprime, h, acc);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int gid = g0 + 32 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        sink.push(st[i][j], gid >= n ? pos_inf() : acc[i][j], step, gid);
    }
  }

#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = q0 + lb.pair * 2 + j;
      if (q < nq) sink.finish(st[i][j], t, rows, lb.lo + lb.lg + 32 * i, q, nq);
    }
}

template <typename T, class Sink>
cudaError_t launch_lut_exact(const void* Tq, const void* packed,
                             const Sink& sink, int n, int nq, int mprime,
                             int h, int nw, int ntiles, int rows,
                             cudaStream_t st) {
  const int qb = lut_qb<T>(mprime, h);
  if (!qb) return cudaErrorInvalidValue;
  const dim3 grid(ntiles, (nq + qb - 1) / qb);
  auto kern = qb == LUT_QB ? lut_exact_kernel<T, Sink, LUT_QB>
                           : lut_exact_kernel<T, Sink, 8>;
  return launch_scan(kern, grid, lut_smem<T>(qb, mprime, h), st,
                     (const T*)Tq, (const int*)packed, sink, n, nq, mprime, h,
                     nw, rows);
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

// The LUT kernels' layout at (m', h) and the table type into out[2]:
// queries per CTA (16 or 8; 0 where not even 8 queries' tables fit) and
// the bytes of shared memory of that choice (of 8 queries' when none).
int rq_lut_layout(int mprime, int h, int bf16, void* out) {
  int* o = (int*)out;
  o[0] = bf16 ? lut_qb<__nv_bfloat16>(mprime, h) : lut_qb<float>(mprime, h);
  const int qb = o[0] ? o[0] : 8;
  o[1] = (int)(bf16 ? lut_smem<__nv_bfloat16>(qb, mprime, h)
                    : lut_smem<float>(qb, mprime, h));
  return 0;
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
