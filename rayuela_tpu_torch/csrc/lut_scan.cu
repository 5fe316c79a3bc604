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
// counting pass, the only one the JAX host code reaches): K5's sums,
// handed to the selecting and the counting sink of scan_common.cuh.
// codes_lut_f32_candidates writes per tile and (lane, query) the `keep`
// smallest (f32 score, gid) pairs, which pair_merge (codes_scan.cu)
// reduces to the (r, 128, nq) buffers of the TPU kernel;
// codes_lut_verify_counts counts the rows before a query's boundary.
//
// What bounds them on the card. n*nq*m' table reads from shared memory
// and as many f32 adds (8e10 at n=1e6, nq=1e4, m'=8); the one-hot
// matmuls of the TPU body are plain lookups here, and shared memory
// serves 128 bytes a clock an SM. K5 keeps the tables of QB queries, two
// queries interleaved per entry, so one 4- or 8-byte shared load serves
// two (row, query) sums: at QB = 16, 64 KB in bf16 and 128 KB in f32 at
// m'*h = 2048 (dynamic shared memory, opted in). Where 16 queries'
// tables do not fit (f32 tables at 128 bits: m'*h = 4096 takes 256 KB) a
// CTA takes 8 queries, and a warp serves a query pair for half of the
// 128 lanes: the same sums, half the rows a thread per step. `lut_qb`
// makes the choice, and `rq_lut_layout` reports it. The 32 rows of a
// warp hold random codes, so their loads of one table collide on banks;
// the codes come straight from device memory, 32 consecutive rows per
// warp load. K6 and K7 lay the tables out code-major instead, each
// entry's queries contiguous, so the threads of a row read one entry
// together (below: `lut_exact_kernel`, `lx_qb`, `rq_lut_exact_layout`).

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

// ---------------------------------------------------------------------------
// K6 and K7: the exact-float LUT scan and its counting pass
// ---------------------------------------------------------------------------
// One body, the scores handed to a SelectSink (K6) or the CountSink (K7)
// of scan_common.cuh. A CTA holds the tables of QB queries, code-major
// with its queries contiguous, Ts[(j * h + code) * QB + q], and walks
// `tpc` tiles of the query block (the tables filled once, by cp.async).
// A thread owns one lane (gid % 128) and the V = 16 / sizeof(T) queries
// [qv, qv + V) of the block: per step it reads its row's code words (the
// QB / V threads of a row load the same words: one transaction) and per
// codebook one 16-byte entry slice, V table values of its row's code,
// which it adds to V f32 sums in codebook order. The threads of a row
// read consecutive words of one entry, so a phase of a shared load (128
// bytes) serves 128 / (QB * sizeof(T)) rows, which collide on banks only
// where their entries do (f32 at 16 queries: two rows, 1.5 wavefronts a
// phase on random codes, where a body whose threads each read their own
// row's 8-byte entry of two queries meets 16 random entries a phase, ~3
// wavefronts for 32 sums). The sink state of a
// thread is its lane's V (lane, query) pairs, in registers across the
// tile's steps.
template <typename T> struct LxVec;
template <> struct LxVec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void add(const uint4& e,
                                             float (&acc)[V]) {
    acc[0] += __uint_as_float(e.x);
    acc[1] += __uint_as_float(e.y);
    acc[2] += __uint_as_float(e.z);
    acc[3] += __uint_as_float(e.w);
  }
};
template <> struct LxVec<__nv_bfloat16> {
  static constexpr int V = 8;  // word k: query 2k in its low half
  static __device__ __forceinline__ void add(const uint4& e,
                                             float (&acc)[V]) {
    const unsigned w[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] += __uint_as_float(w[k] << 16);
      acc[2 * k + 1] += __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
};

// The tables of queries [q0, q0 + QB) into Ts (zeros past nq), 16-byte
// cp.async copies where whole chunks of V queries lie aligned in Tq, else
// one value at a time. Ends with a barrier.
template <typename T, int QB>
__device__ __forceinline__ void lx_fill(const T* __restrict__ Tq, int q0,
                                        int nq, int mh, unsigned char* Ts) {
  constexpr int V = LxVec<T>::V, CPE = QB / V;  // 16-byte chunks an entry
  if (nq % V == 0 && (reinterpret_cast<size_t>(Tq) & 15) == 0) {
    for (int i = threadIdx.x; i < mh * CPE; i += blockDim.x) {
      const int e = i / CPE, q = q0 + (i % CPE) * V;
      cp_async16(Ts + (size_t)i * 16, Tq + (size_t)e * nq + (q < nq ? q : 0),
                 q < nq);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    T* Td = reinterpret_cast<T*>(Ts);
    for (int i = threadIdx.x; i < mh * QB; i += blockDim.x) {
      const int q = q0 + i % QB;
      Td[i] = q < nq ? Tq[(size_t)(i / QB) * nq + q] : Pair<T>::zero();
    }
  }
  __syncthreads();
}

// Code words [w0, w0 + 4) of row gid (zeros past nw, and for a pad row).
__device__ __forceinline__ void lx_words(const int* __restrict__ packed,
                                         long long gid, int n, int nw, int w0,
                                         unsigned (&wd)[4]) {
#pragma unroll
  for (int w = 0; w < 4; ++w)
    wd[w] = gid < n && w0 + w < nw
                ? (unsigned)__ldg(packed + gid * nw + w0 + w)
                : 0u;
}

// Add the table values of codebooks [j0, j0 + 16) below m' (codes in the
// 4 words wd) to acc, in codebook order. Tv is the thread's slice of the
// first entry, hb the bytes of one codebook's tables. The 16 loads are
// issued before the first add, so their latencies overlap; each has its
// own predicate, which folds away where m' is compiled in.
template <typename T, int EB>
__device__ __forceinline__ void lx_sum16(const unsigned char* Tv, int hb,
                                         const unsigned (&wd)[4], int j0,
                                         int mprime,
                                         float (&acc)[LxVec<T>::V]) {
  uint4 e[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j0 + j < mprime)
      e[j] = *reinterpret_cast<const uint4*>(
          Tv + (j0 + j) * hb +
          (int)((wd[j >> 2] >> (8 * (j & 3))) & 0xFFu) * EB);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j0 + j < mprime) LxVec<T>::add(e[j], acc);
}

// grid (cdiv(ntiles, tpc), cdiv(nq, QB)), 128 * QB / V threads. M > 0
// compiles for m' = M tables (the predicates of `lx_sum16` fold away: at
// m' = 8 K7 takes half the time of the M = 0 form, which reads m' at run
// time and branches around each predicated load).
template <typename T, class Sink, int QB, int M>
__global__ void __launch_bounds__(LANES * QB / LxVec<T>::V, 1)
    lut_exact_kernel(const T* __restrict__ Tq, const int* __restrict__ packed,
                     const Sink sink, int n, int nq, int mprime_, int h,
                     int nw, int rows, int ntiles, int tpc) {
  const int mprime = M ? M : mprime_;
  constexpr int V = LxVec<T>::V, TPR = QB / V;
  constexpr int EB = QB * (int)sizeof(T);  // bytes of an entry
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = blockIdx.y * QB;
  const int lane = threadIdx.x / TPR, qv = (threadIdx.x % TPR) * V;
  lx_fill<T, QB>(Tq, q0, nq, mprime * h, smem_raw);
  const unsigned char* Tv = smem_raw + qv * (int)sizeof(T);
  const int hb = h * EB;  // bytes of a codebook's tables

  const int t1 = min(ntiles, (int)(blockIdx.x + 1) * tpc);
  for (int t = blockIdx.x * tpc; t < t1; ++t) {
    typename Sink::State st[V];
#pragma unroll
    for (int v = 0; v < V; ++v) sink.init(st[v], q0 + qv + v, nq);
    unsigned cur[4], nxt[4];
    lx_words(packed, (long long)t * rows * LANES + lane, n, nw, 0, cur);
    for (int step = 0; step < rows; ++step) {
      const long long gid = ((long long)t * rows + step) * LANES + lane;
      // codebooks 0-15: words prefetched a step ahead; any further ones
      // loaded here
      lx_words(packed, gid + LANES, step + 1 < rows ? n : 0, nw, 0, nxt);
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      lx_sum16<T, EB>(Tv, hb, cur, 0, mprime, acc);
      for (int j0 = 16; j0 < mprime; j0 += 16) {
        unsigned wd[4];
        lx_words(packed, gid, n, nw, j0 / 4, wd);
        lx_sum16<T, EB>(Tv, hb, wd, j0, mprime, acc);
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        sink.push(st[v], gid >= n ? pos_inf() : acc[v], step, (int)gid);
#pragma unroll
      for (int w = 0; w < 4; ++w) cur[w] = nxt[w];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int q = q0 + qv + v;
      if (q < nq) sink.finish(st[v], t, rows, lane, q, nq);
    }
  }
}

// Queries per K6/K7 CTA: the most of (32 on bf16 tables), 16, 8 whose
// tables fit the shared memory a CTA may opt in to; 0 where none does.
template <typename T> int lx_qb(int mprime, int h) {
  int dev = 0, cap = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  for (int qb = sizeof(T) == 2 ? 32 : 16; qb >= 8; qb /= 2)
    if (sizeof(T) * (size_t)qb * mprime * h <= (size_t)cap) return qb;
  return 0;
}

// The compiled instance for qb queries a CTA and m' tables (nullptr:
// none): m' = 8 and 16 at the query blocks h = 256 gives them have their
// own (`lut_exact_kernel`'s M).
template <typename T, class Sink>
auto lx_kernel(int qb, int mprime)
    -> decltype(&lut_exact_kernel<T, Sink, 8, 0>) {
  constexpr int Q8 = sizeof(T) == 2 ? 32 : 16, Q16 = Q8 / 2;
  if (qb == Q8 && mprime == 8) return lut_exact_kernel<T, Sink, Q8, 8>;
  if (qb == Q16 && mprime == 16) return lut_exact_kernel<T, Sink, Q16, 16>;
  if constexpr (sizeof(T) == 2)
    if (qb == 32) return lut_exact_kernel<T, Sink, 32, 0>;
  return qb == 16 ? lut_exact_kernel<T, Sink, 16, 0>
         : qb == 8 ? lut_exact_kernel<T, Sink, 8, 0>
                   : nullptr;
}

template <typename T, class Sink>
cudaError_t launch_lut_exact(const void* Tq, const void* packed,
                             const Sink& sink, int n, int nq, int mprime,
                             int h, int nw, int ntiles, int rows,
                             cudaStream_t st) {
  const int qb = lx_qb<T>(mprime, h);
  auto kern = lx_kernel<T, Sink>(qb, mprime);
  if (!kern) return cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * (size_t)qb * mprime * h;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  // up to 4 tiles a CTA (one table fill for several tiles) while the grid
  // keeps 8 CTAs an SM
  const int nqb = (nq + qb - 1) / qb;
  int tpc = 4;
  while (tpc > 1 && (long long)((ntiles + tpc - 1) / tpc) * nqb < 8LL * sms)
    tpc /= 2;
  const dim3 grid((ntiles + tpc - 1) / tpc, nqb);
  kern<<<grid, qb * LANES / LxVec<T>::V, smem, st>>>(
      (const T*)Tq, (const int*)packed, sink, n, nq, mprime, h, nw, rows,
      ntiles, tpc);
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

// K5's layout at (m', h) and the table type into out[2]:
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

// K6/K7's layout at (m', h) and the table type into out[4]: queries per
// CTA (32, 16 or 8; 0 where not even 8 queries' tables fit), threads per
// CTA, bytes of shared memory (of 8 queries' tables when none fits) and
// the CTAs of K7 an SM holds at once.
int rq_lut_exact_layout(int mprime, int h, int bf16, void* out) {
  int* o = (int*)out;
  o[0] = bf16 ? lx_qb<__nv_bfloat16>(mprime, h) : lx_qb<float>(mprime, h);
  const int qb = o[0] ? o[0] : 8, tb = bf16 ? 2 : 4;
  o[1] = qb * LANES * tb / 16;
  o[2] = qb * mprime * h * tb;
  o[3] = 0;
  if (!o[0]) return 0;
  auto kern = bf16 ? (void*)lx_kernel<__nv_bfloat16, CountSink>(qb, mprime)
                   : (void*)lx_kernel<float, CountSink>(qb, mprime);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, o[2]);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[3], kern, o[1],
                                                            o[2]);
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
