// Code-resident scan kernels for Hopper (sm_90a): K1, K2 and K4, and the
// pair merge of the exact-float scans (K9, K6).
//
// Replaces (rayuela_tpu/search/scan_codes_pallas.py):
//   K1 codes_decode_candidates  <- _codes_decode_kernel_candidates
//   K2 cand_merge               <- _cand_merge_kernel
//   K4 codes_decode_topk        <- _codes_decode_kernel_packed (keep=0)
//   pair_merge                  <- the running (r, 128, bq) buffer of
//                                  _scan_kernel (scan_pallas.py) and
//                                  _codes_scan_kernel: its merge across
//                                  the sequential tile axis
//
// K1 and K4 are the two scan bodies of scan_common.cuh (which states the
// key and selection contract) over the row source of this file: a row
// decodes to x_hat = sum_j Cflat[j*h + code_j] (f32, codebook order),
// rounded to the operand type; its norm x2 is |x_hat|^2 of the f32 row
// (PQ) or nrm[norm_code] (additive models).
//
// What bounds them on the card. K1 does n*nq*dp multiply-adds (1.3e12
// FMAs at n=1e6, nq=1e4, dp=128) on the CUDA cores, and before that it
// decodes every row once per 32-query block: m codebook rows of dp
// values gathered from Cflat, which sits in L2 (m*h*dp operands, too
// large for L1 beside the tile). Each CTA decodes 128 rows (one rid) at
// a time into shared memory. The decode reads Cflat 16 bytes per
// thread, coalesced, with up to 8 codebook loads in flight per thread:
// a decode that waited on one 2-byte load at a time was latency-bound
// and took most of K1's time. K2 and K4's selection is register
// insertion into a sorted array: after the first few rows nearly every
// key is rejected by one compare. K2 is bound by reading its candidate
// array (coalesced: consecutive threads take consecutive queries). K4
// re-decodes its rows for every 2 queries; it serves only the rare
// certificate-flagged queries, so it is bound by latency.

#include "scan_common.cuh"

namespace {

constexpr int DEC_BATCH = 8;   // codebook loads a decoding thread keeps in flight

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

// Row source of K1 and K4: rows decoded from their packed codes.
template <typename T> struct CodesSrc {
  using Op = T;
  static constexpr bool kQueryFastest = false;
  const T* Cflat;
  const T* nrm;
  const int* packed;
  int m, h, nw, has_norms;
  __host__ __device__ int words() const { return LANES * nw; }
  __device__ __forceinline__ void load(int n, int rid, int dp, float* XsT,
                                       float* x2s, int* words) const {
    decode_rows<T>(Cflat, nrm, packed, n, rid, m, h, nw, dp, has_norms, XsT,
                   x2s, words);
  }
};

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

template <int R>
cudaError_t launch_merge(const void* cand, const void* disc, void* out,
                         int ncand, int ndisc, int nq, cudaStream_t st) {
  const size_t plane = (size_t)LANES * nq;
  cand_merge_kernel<R><<<(unsigned)((plane + THREADS - 1) / THREADS),
                         THREADS, 0, st>>>(
      (const int*)cand, (const int*)disc, (int*)out, ncand, ndisc, nq);
  return cudaGetLastError();
}

// The pair merge: one thread per (lane, query). The R smallest of the
// candidate (score, gid) pairs, ascending, to outv / outi[0..R). The
// candidates arrive in ascending gid among equal scores (tile after
// tile, and ascending within a tile), so a strict `<` on the scores
// keeps the order (score, gid); a +inf candidate never enters, and an
// empty slot stays (+inf, NOID). Bound by reading its candidates (8
// bytes each, coalesced: consecutive threads take consecutive queries);
// after the first tiles nearly every candidate is rejected by one
// compare before its id is read.
template <int R>
__global__ void __launch_bounds__(THREADS)
    pair_merge_kernel(const float* __restrict__ candv,
                      const int* __restrict__ candi, float* __restrict__ outv,
                      int* __restrict__ outi, int ncand, int nq) {
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
  for (int row = 0; row < ncand; ++row) {
    const float s = candv[row * plane + idx];
    if (s < bv[R - 1]) {
      bv[R - 1] = s;
      bi[R - 1] = candi[row * plane + idx];
#pragma unroll
      for (int i = R - 1; i > 0; --i) {
        const bool sw = bv[i] < bv[i - 1];
        const float va = bv[i - 1], vb = bv[i];
        const int ia = bi[i - 1], ib = bi[i];
        bv[i - 1] = sw ? vb : va;
        bv[i] = sw ? va : vb;
        bi[i - 1] = sw ? ib : ia;
        bi[i] = sw ? ia : ib;
      }
    }
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
#define RQ_K1(T, K)                                                         \
  return (int)launch_candidates<CodesSrc<T>, K>(                            \
      CodesSrc<T>{(const T*)Cflat, (const T*)nrm, (const int*)packed, m, h, \
                  nw, has_norms},                                           \
      Qm, cand, disc, n, nq, dp, ntiles, rows, idbits, st)
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
#define RQ_K4(T, R)                                                         \
  return (int)launch_topk<CodesSrc<T>, R>(                                  \
      CodesSrc<T>{(const T*)Cflat, (const T*)nrm, (const int*)packed, m, h, \
                  nw, has_norms},                                           \
      Qm, cand, disc, n, nq, dp, nrows, rows_per, idbits, st)
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
    case 96: return (int)launch_merge<96>(cand, disc, out, ncand, ndisc, nq, st);
  }
  return (int)cudaErrorInvalidValue;
}

int rq_pair_merge(const void* candv, const void* candi, void* outv,
                  void* outi, int ncand, int nq, int r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 16: return (int)launch_pair_merge<16>(candv, candi, outv, outi, ncand, nq, st);
    case 32: return (int)launch_pair_merge<32>(candv, candi, outv, outi, ncand, nq, st);
    case 48: return (int)launch_pair_merge<48>(candv, candi, outv, outi, ncand, nq, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
