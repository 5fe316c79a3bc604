// Code-resident scan kernels for Hopper (sm_90a): K1, K2 and K4.
//
// Replaces (rayuela_tpu/search/scan_codes_pallas.py):
//   K1 codes_decode_candidates  <- _codes_decode_kernel_candidates
//   K2 cand_merge               <- _cand_merge_kernel
//   K4 codes_decode_topk        <- _codes_decode_kernel_packed (keep=0)
//
// Logical contract (shared with the plain PyTorch versions in
// rayuela_tpu_torch/search/scan_codes.py). Row gid lives in lane
// gid % 128 with per-lane row id rid = gid >> 7. A row decodes to
// x_hat = sum_j Cflat[j*h + code_j] (f32, codebook order), rounded to
// the operand type; its norm x2 is |x_hat|^2 of the f32 row (PQ) or
// nrm[norm_code] (additive models). The score against query q is
// dot(x_hat, Qm[q]) + x2, with Qm = -2q in the operand type and an f32
// dot taken in dimension order, and +inf for pad rows gid >= n. The
// selection key is (sortable(score) & -(1 << idbits)) | rid: unique per
// (lane, query), so per-lane selections have no ties.
//
// What bounds them on the card. K1 does n*nq*dp multiply-adds (1.3e12
// FMAs at n=1e6, nq=1e4, dp=128) on the CUDA cores, and before that it
// decodes every row once per 32-query block: m codebook rows of dp
// values gathered from Cflat, which sits in L2 (m*h*dp operands, too
// large for L1 beside the tile). Each CTA decodes 128 rows (one rid) at
// a time into shared memory, transposed with a padded stride so the
// score reads are free of bank conflicts. The decode reads Cflat 16
// bytes per thread, coalesced, with up to 8 codebook loads in flight
// per thread: a decode that waited on one 2-byte load at a time was
// latency-bound and took most of K1's time. Each thread scores a 4-lane
// x 4-query register block (one 16-byte shared load brings four
// dimensions of a query) and keeps the top-keep keys and the discard
// minimum of its 16 (lane, query) pairs in registers; two CTAs share an
// SM, so one decodes while the other scores. K2 and K4's selection is
// register insertion into a sorted array: after the first few rows
// nearly every key is rejected by one compare. K2 is bound by reading
// its candidate array (coalesced: consecutive threads take consecutive
// queries). K4 re-decodes its rows for every 2 queries; it serves only
// the rare certificate-flagged queries, so it is bound by latency: a
// few queries would leave most SMs idle, so the wrapper splits the row
// range over enough CTAs to fill the card and K2 merges the per-split
// buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int LANES = 128;
constexpr int LP = LANES + 1;  // padded stride of the transposed tile
constexpr int K1_QB = 32;      // queries per K1 CTA (8 warps x 4)
constexpr int K4_QB = 2;       // queries per K4 CTA (2 x 128 lanes)
constexpr int THREADS = 256;
constexpr int DEC_BATCH = 8;   // codebook loads a decoding thread keeps in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round an f32 value to the operand type T and back (round to nearest
// even, as torch's .to(torch.bfloat16) does)
template <typename T> __device__ __forceinline__ float round_op(float x);
template <> __device__ __forceinline__ float round_op<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_op<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int row_key(float s, int rid, int vmask) {
  int b = __float_as_int(s);
  b = b >= 0 ? b : (b ^ 0x7FFFFFFF);
  return (b & vmask) | rid;
}

__device__ __forceinline__ int code_of(const int* words, int j) {
  return (int)(((unsigned)words[j >> 2] >> (8 * (j & 3))) & 0xFFu);
}

// Insert key x into the ascending array buf; `rest` keeps the minimum
// of every key that is not (or no longer) in buf.
template <int K>
__device__ __forceinline__ void insert_sorted(int (&buf)[K], int& rest,
                                              int x) {
  if (x < buf[K - 1]) {
    rest = min(rest, buf[K - 1]);
    buf[K - 1] = x;
#pragma unroll
    for (int i = K - 1; i > 0; --i) {
      const int a = buf[i - 1], b = buf[i];
      buf[i - 1] = min(a, b);
      buf[i] = max(a, b);
    }
  } else {
    rest = min(rest, x);
  }
}

// Sixteen bytes of T, widened to f32 and added to acc[0..N) in order.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void add(const uint4& u, float* acc) {
    acc[0] += __uint_as_float(u.x);
    acc[1] += __uint_as_float(u.y);
    acc[2] += __uint_as_float(u.z);
    acc[3] += __uint_as_float(u.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // little-endian: the element at the lower address is the low half;
  // a bf16 is the top half of the f32 with the same value
  static __device__ __forceinline__ void add(const uint4& u, float* acc) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += __uint_as_float(w[i] << 16);
      acc[2 * i + 1] += __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

// Decode the 128 rows of row id `rid` into XsT[kk * LP + lane] (values
// rounded to T) and their norms into x2s[lane]. G threads share a row,
// each 16 bytes of it at a time, so a warp's loads are coalesced; each
// thread issues up to DEC_BATCH codebook loads before it adds any, so
// their L2 latencies overlap. Ends with a barrier.
template <typename T>
__device__ void decode_rows(const T* __restrict__ Cflat,
                            const T* __restrict__ nrm,
                            const int* __restrict__ packed, int n, int rid,
                            int m, int h, int nw, int dp, int has_norms,
                            float* XsT, float* x2s, int* words) {
  constexpr int V = Vec16<T>::N;
  const int tid = threadIdx.x;
  const long long g0 = (long long)rid * LANES;
  for (int i = tid; i < LANES * nw; i += blockDim.x) {
    const long long gid = g0 + i / nw;
    words[i] = gid < n ? packed[gid * nw + i % nw] : 0;
  }
  __syncthreads();
  const int cpr = dp / V;              // 16-byte chunks per row
  const int G = cpr < 32 ? cpr : 32;   // threads per row (a power of 2)
  const int t = tid & 31, per_warp = 32 / G;
  const int row_step = (blockDim.x >> 5) * per_warp;
  for (int lane = (tid >> 5) * per_warp + t / G; lane < LANES;
       lane += row_step) {
    const int* wl = words + lane * nw;
    float part = 0.f;
    for (int c = t % G; c < cpr; c += G) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int j0 = 0; j0 < m; j0 += DEC_BATCH) {
        uint4 v[DEC_BATCH];
#pragma unroll
        for (int u = 0; u < DEC_BATCH; ++u)
          if (j0 + u < m)
            v[u] = __ldg(reinterpret_cast<const uint4*>(
                Cflat + (size_t)((j0 + u) * h + code_of(wl, j0 + u)) * dp +
                c * V));
#pragma unroll
        for (int u = 0; u < DEC_BATCH; ++u)
          if (j0 + u < m) Vec16<T>::add(v[u], acc);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        XsT[(c * V + e) * LP + lane] = round_op<T>(acc[e]);
        part += acc[e] * acc[e];
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (t % G == 0)
      x2s[lane] = has_norms
                      ? to_f32(nrm[(size_t)code_of(wl, m) * LANES])
                      : part;
  }
  __syncthreads();
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <typename T>
__device__ void load_queries(const T* __restrict__ Qm, int q0, int nq,
                             int dp, int nqb, float* Qs) {
  for (int i = threadIdx.x; i < nqb * dp; i += blockDim.x) {
    const int q = q0 + i / dp;
    Qs[i] = q < nq ? to_f32(Qm[(size_t)q * dp + i % dp]) : 0.f;
  }
}

// K1: grid (ntiles, cdiv(nq, 32)). CTA (t, qb) scans tile t (rows row
// ids) for 32 queries and writes, per (lane, query), the KEEP smallest
// keys ascending to cand[t*KEEP + c] and the smallest other key to
// disc[t] (INT_MAX when nothing was discarded).
template <typename T, int KEEP>
__global__ void __launch_bounds__(THREADS, 2)
    decode_candidates_kernel(const T* __restrict__ Qm,
                             const T* __restrict__ Cflat,
                             const T* __restrict__ nrm,
                             const int* __restrict__ packed,
                             int* __restrict__ cand, int* __restrict__ disc,
                             int n, int nq, int dp, int m, int h, int nw,
                             int has_norms, int rows, int idbits) {
  extern __shared__ __align__(16) float smem[];
  float* XsT = smem;                  // dp * LP
  float* Qs = XsT + dp * LP;          // K1_QB * dp
  float* x2s = Qs + K1_QB * dp;       // LANES
  int* words = (int*)(x2s + LANES);   // LANES * nw
  const int t = blockIdx.x, q0 = blockIdx.y * K1_QB;
  const int lg = threadIdx.x & 31, qg = threadIdx.x >> 5;
  const int vmask = -(1 << idbits);
  load_queries<T>(Qm, q0, nq, dp, K1_QB, Qs);

  int best[4][4][KEEP];
  int rest[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rest[i][j] = INT_MAX;
#pragma unroll
      for (int c = 0; c < KEEP; ++c) best[i][j][c] = INT_MAX;
    }

  for (int step = 0; step < rows; ++step) {
    const int rid = t * rows + step;
    __syncthreads();  // the previous step's readers are done with XsT
    decode_rows<T>(Cflat, nrm, packed, n, rid, m, h, nw, dp, has_norms,
                   XsT, x2s, words);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // dot products in dimension order; one 16-byte shared load brings
    // four dimensions of a query (dp is a multiple of 128)
    const float* qrow = Qs + (qg * 4) * dp;
    for (int kk0 = 0; kk0 < dp; kk0 += 4) {
      float4 qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qv[j] = *reinterpret_cast<const float4*>(qrow + j * dp + kk0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = XsT[(kk0 + e) * LP + lg + 32 * i];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xv[i], comp(qv[j], e), acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lane = lg + 32 * i;
      const bool pad = (long long)rid * LANES + lane >= n;
      const float x2 = x2s[lane];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = pad ? __int_as_float(0x7F800000) : acc[i][j] + x2;
        insert_sorted<KEEP>(best[i][j], rest[i][j], row_key(s, rid, vmask));
      }
    }
  }

  const size_t plane = (size_t)LANES * nq;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + qg * 4 + j;
      if (q >= nq) continue;
      const size_t off = (size_t)(lg + 32 * i) * nq + q;
#pragma unroll
      for (int c = 0; c < KEEP; ++c)
        cand[(size_t)(t * KEEP + c) * plane + off] = best[i][j][c];
      disc[(size_t)t * plane + off] = rest[i][j];
    }
}

// K4: grid (cdiv(nq, 2), splits). Thread (lane, query) of CTA (qb, s)
// scans row ids [s * rows_per, (s + 1) * rows_per) and writes its R
// smallest keys ascending to cand[s*R .. s*R + R) and the smallest other
// key to disc[s]. With one split that is the final (R+1)-row buffer;
// with more, K2 merges the splits into it (the certificate stays exact:
// every key not kept is some split's rejected key or a merge loser).
template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
    decode_topk_kernel(const T* __restrict__ Qm, const T* __restrict__ Cflat,
                       const T* __restrict__ nrm,
                       const int* __restrict__ packed, int* __restrict__ cand,
                       int* __restrict__ disc, int n, int nq, int dp, int m,
                       int h, int nw, int has_norms, int nrows, int rows_per,
                       int idbits) {
  extern __shared__ __align__(16) float smem[];
  float* XsT = smem;                  // dp * LP
  float* Qs = XsT + dp * LP;          // K4_QB * dp
  float* x2s = Qs + K4_QB * dp;       // LANES
  int* words = (int*)(x2s + LANES);   // LANES * nw
  const int lane = threadIdx.x & (LANES - 1), qi = threadIdx.x >> 7;
  const int q0 = blockIdx.x * K4_QB, q = q0 + qi, s = blockIdx.y;
  const int vmask = -(1 << idbits);
  load_queries<T>(Qm, q0, nq, dp, K4_QB, Qs);

  int buf[R];
#pragma unroll
  for (int c = 0; c < R; ++c) buf[c] = INT_MAX;
  int rest = INT_MAX;
  const float* qrow = Qs + qi * dp;
  const int rid1 = min(nrows, (s + 1) * rows_per);
  for (int rid = s * rows_per; rid < rid1; ++rid) {
    __syncthreads();
    decode_rows<T>(Cflat, nrm, packed, n, rid, m, h, nw, dp, has_norms,
                   XsT, x2s, words);
    float acc = 0.f;
    for (int kk = 0; kk < dp; ++kk)
      acc = fmaf(XsT[kk * LP + lane], qrow[kk], acc);
    const bool pad = (long long)rid * LANES + lane >= n;
    const float sc = pad ? __int_as_float(0x7F800000) : acc + x2s[lane];
    insert_sorted<R>(buf, rest, row_key(sc, rid, vmask));
  }
  if (q >= nq) return;
  const size_t plane = (size_t)LANES * nq, off = (size_t)lane * nq + q;
#pragma unroll
  for (int c = 0; c < R; ++c) cand[((size_t)s * R + c) * plane + off] = buf[c];
  disc[(size_t)s * plane + off] = rest;
}

// K2: one thread per (lane, query). The R smallest candidate keys
// ascending to out[0..R), then min(every discard minimum, every
// candidate not kept) to out[R].
template <int R>
__global__ void __launch_bounds__(THREADS)
    cand_merge_kernel(const int* __restrict__ cand,
                      const int* __restrict__ disc, int* __restrict__ out,
                      int ncand, int ndisc, int nq) {
  const size_t plane = (size_t)LANES * nq;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  int buf[R];
#pragma unroll
  for (int c = 0; c < R; ++c) buf[c] = INT_MAX;
  int rest = INT_MAX;
  for (int row = 0; row < ncand; ++row)
    insert_sorted<R>(buf, rest, cand[row * plane + idx]);
  for (int row = 0; row < ndisc; ++row)
    rest = min(rest, disc[row * plane + idx]);
#pragma unroll
  for (int c = 0; c < R; ++c) out[c * plane + idx] = buf[c];
  out[R * plane + idx] = rest;
}

size_t scan_smem(int dp, int qb, int nw) {
  return sizeof(float) * ((size_t)dp * LP + (size_t)qb * dp + LANES) +
         sizeof(int) * (size_t)LANES * nw;
}

template <typename T, int KEEP>
cudaError_t launch_candidates(const void* Qm, const void* Cflat,
                              const void* nrm, const void* packed,
                              void* cand, void* disc, int n, int nq,
                              int dp, int m, int h, int nw, int has_norms,
                              int ntiles, int rows, int idbits,
                              cudaStream_t st) {
  const size_t smem = scan_smem(dp, K1_QB, nw);
  auto kern = decode_candidates_kernel<T, KEEP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(ntiles, (nq + K1_QB - 1) / K1_QB);
  kern<<<grid, THREADS, smem, st>>>(
      (const T*)Qm, (const T*)Cflat, (const T*)nrm, (const int*)packed,
      (int*)cand, (int*)disc, n, nq, dp, m, h, nw, has_norms, rows, idbits);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_topk(const void* Qm, const void* Cflat, const void* nrm,
                        const void* packed, void* cand, void* disc, int n,
                        int nq, int dp, int m, int h, int nw, int has_norms,
                        int nrows, int rows_per, int idbits,
                        cudaStream_t st) {
  const size_t smem = scan_smem(dp, K4_QB, nw);
  auto kern = decode_topk_kernel<T, R>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((nq + K4_QB - 1) / K4_QB, (nrows + rows_per - 1) / rows_per);
  kern<<<grid, THREADS, smem, st>>>(
      (const T*)Qm, (const T*)Cflat, (const T*)nrm, (const int*)packed,
      (int*)cand, (int*)disc, n, nq, dp, m, h, nw, has_norms, nrows,
      rows_per, idbits);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_merge(const void* cand, const void* disc, void* out,
                         int ncand, int ndisc, int nq, cudaStream_t st) {
  const size_t plane = (size_t)LANES * nq;
  cand_merge_kernel<R><<<(unsigned)((plane + THREADS - 1) / THREADS),
                         THREADS, 0, st>>>(
      (const int*)cand, (const int*)disc, (int*)out, ncand, ndisc, nq);
  return cudaGetLastError();
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
#define RQ_K1(T, K)                                                        \
  return (int)launch_candidates<T, K>(Qm, Cflat, nrm, packed, cand, disc, \
                                      n, nq, dp, m, h, nw, has_norms,     \
                                      ntiles, rows, idbits, st)
  if (bf16) {
    switch (keep) {
      case 2: RQ_K1(__nv_bfloat16, 2);
      case 4: RQ_K1(__nv_bfloat16, 4);
    }
  } else {
    switch (keep) {
      case 2: RQ_K1(float, 2);
      case 4: RQ_K1(float, 4);
    }
  }
#undef RQ_K1
  return (int)cudaErrorInvalidValue;
}

int rq_codes_decode_topk(const void* Qm, const void* Cflat, const void* nrm,
                         const void* packed, void* cand, void* disc, int n,
                         int nq, int dp, int m, int h, int nw, int has_norms,
                         int nrows, int rows_per, int r, int idbits,
                         int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RQ_K4(T, R)                                                        \
  return (int)launch_topk<T, R>(Qm, Cflat, nrm, packed, cand, disc, n, nq, \
                                dp, m, h, nw, has_norms, nrows, rows_per,  \
                                idbits, st)
  if (r == 48) {
    if (bf16) RQ_K4(__nv_bfloat16, 48);
    RQ_K4(float, 48);
  }
#undef RQ_K4
  return (int)cudaErrorInvalidValue;
}

int rq_cand_merge(const void* cand, const void* disc, void* out, int ncand,
                  int ndisc, int nq, int r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 16: return (int)launch_merge<16>(cand, disc, out, ncand, ndisc, nq, st);
    case 32: return (int)launch_merge<32>(cand, disc, out, ncand, ndisc, nq, st);
    case 48: return (int)launch_merge<48>(cand, disc, out, ncand, ndisc, nq, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
