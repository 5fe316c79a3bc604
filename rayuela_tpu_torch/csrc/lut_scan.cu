// LUT-mode code scan kernels for Hopper (sm_90a): K5, K6 and K7, one body.
//
// They replace rayuela_tpu/search/scan_codes_pallas.py::
// _codes_scan_kernel_packed (K5, behind pallas_scan_codes_topk(pack=True)),
// ::_codes_scan_kernel (K6) and ::_codes_verify_kernel (K7, the idbits = 0
// form of the counting pass, the only one the JAX host code reaches; both
// behind pack=False). Row gid (lane gid % 128, row id gid >> 7) scores
//   s[gid, q] = sum_j T[j*h + code_j(gid), q],  j = 0 .. m'-1 in order,
// with T (m'*h, nq) the per-query tables at the table type (f32 or bf16;
// the values are rounded to it before the sum, the sum is f32 from +0),
// code_j byte j % 4 of word j / 4 of the row's packed codes, the norms
// byte last, and +inf for pad rows gid >= n. One body (`lut_exact_kernel`)
// computes the sums and hands each to a sink of scan_common.cuh:
// - K5 (`KeySink`): per tile and (lane, query) the KEEP smallest packed
//   keys ascending and the smallest other key; K2 (cand_merge,
//   codes_scan.cu) reduces the tiles to the (r + 1, 128, nq) buffer the TPU
//   kernel emits (its sequential tile axis with a running buffer has no
//   counterpart on this card);
// - K6 (`SelectSink`): per tile and (lane, query) the `keep` smallest (f32
//   score, gid) pairs, which pair_merge (codes_scan.cu) reduces to the
//   (r, 128, nq) buffers of the TPU kernel;
// - K7 (`CountSink`): the rows before each query's boundary.
// The three see the same sums bit for bit.
//
// What bounds them on the card. n*nq*m' table reads from shared memory
// and as many f32 adds (8e10 at n=1e6, nq=1e4, m'=8); the one-hot
// matmuls of the TPU body are plain lookups here, and shared memory
// serves 128 bytes a clock an SM, which sets the floor: the lookups, not
// the adds (67 TFLOP/s would take 1.2 ms) nor the bytes. The design
// below serves several rows' lookups with one 128-byte phase.

#include "scan_common.cuh"

namespace {

// The body. A CTA holds the tables of QB queries, code-major with its
// queries contiguous, Ts[(j * h + code) * QB + q], and walks `tpc` tiles
// of the query block (the tables filled once, by cp.async). A thread owns
// one lane (gid % 128) and the V = 16 / sizeof(T) queries [qv, qv + V) of
// the block: per step it reads its row's code words (the QB / V threads of
// a row load the same words: one transaction) and per codebook one 16-byte
// entry slice, V table values of its row's code, which it adds to V f32
// sums in codebook order. The threads of a row read consecutive words of
// one entry, so a phase of a shared load (128 bytes) serves 128 / (QB *
// sizeof(T)) rows, which collide on banks only where their entries do (f32
// at 16 queries: two rows, 1.5 wavefronts a phase on random codes, where a
// body whose threads each read their own row's 8-byte entry of two queries
// meets 16 random entries a phase, ~3 wavefronts for 32 sums). The sink
// state of a thread is its lane's V (lane, query) pairs, in registers
// across the tile's steps. `lx_qb` picks QB (32 queries on bf16 tables, 16
// on f32, halved where the tables do not fit), `rq_lut_exact_layout`
// reports it.
template <typename T> struct LxVec;
template <> struct LxVec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ float zero() { return 0.f; }
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
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.f);
  }
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
      Td[i] = q < nq ? Tq[(size_t)(i / QB) * nq + q] : LxVec<T>::zero();
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

  const int t0 = blockIdx.x * tpc, t1 = min(ntiles, t0 + tpc);
  // codebooks 0-15: words prefetched a step ahead, across the CTA's tiles;
  // any further ones loaded in the step
  unsigned cur[4], nxt[4];
  lx_words(packed, (long long)t0 * rows * LANES + lane, n, nw, 0, cur);
  for (int t = t0; t < t1; ++t) {
    typename Sink::State st[V];
#pragma unroll
    for (int v = 0; v < V; ++v) sink.init(st[v], q0 + qv + v, nq);
    for (int step = 0; step < rows; ++step) {
      const long long gid = ((long long)t * rows + step) * LANES + lane;
      const bool ahead = step + 1 < rows || t + 1 < t1;
      lx_words(packed, gid + LANES, ahead ? n : 0, nw, 0, nxt);
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
    if constexpr (run_finish<Sink>::value) {
      sink.finish_run(st, t, lane, q0 + qv, nq);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int q = q0 + qv + v;
        if (q < nq) sink.finish(st[v], t, rows, lane, q, nq);
      }
    }
  }
}

// Queries per LUT CTA: the most of (32 on bf16 tables), 16, 8 whose
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
  // several tiles a CTA (one table fill for at least 256 row steps: 4
  // tiles of 8192 rows, 16 of 2048) while the grid keeps 8 CTAs an SM
  const int nqb = (nq + qb - 1) / qb;
  int tpc = max(4, 256 / rows);
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

// K5: per tile and (lane, query) the `keep` smallest packed keys
// (`row_key` at idbits) → cand (ntiles * keep, 128, nq), and the smallest
// other key → disc (ntiles, 128, nq).
int rq_codes_lut_candidates(const void* Tq, const void* packed, void* cand,
                            void* disc, int n, int nq, int mprime, int h,
                            int nw, int ntiles, int rows, int keep,
                            int idbits, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int vmask = -(1 << idbits);
#define RQ_K5(T, K)                                                     \
  return (int)launch_lut_exact<T>(                                      \
      Tq, packed, KeySink<K>{(int*)cand, (int*)disc, vmask}, n, nq,     \
      mprime, h, nw, ntiles, rows, st)
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

// The layout of K5-K7 at (m', h) and the table type into out[4]: queries
// per CTA (32, 16 or 8; 0 where not even 8 queries' tables fit), threads per
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
