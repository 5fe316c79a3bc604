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
// K1 and K4 are two scan bodies of scan_common.cuh (which states the
// key and selection contract) over the row source of this file: a row
// decodes to x_hat = sum_j Cflat[j*h + code_j] (f32, codebook order),
// rounded to the operand type; its norm x2 is |x_hat|^2 of the f32 row
// (PQ) or nrm[norm_code] (additive models). Beyond dp = 256 a row
// decodes and scores in d-blocks of 128 (scan_common.cuh), the codebook
// rows summed in codebook order within each block. K14 is K1's body (its
// decode, its blocking and its scores, bit for bit) with a loop over
// the tiles inside the CTA: K1 -> K2's function at (r, keep, tile) in
// one pass, with no candidate array in device memory.
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
// array (coalesced: consecutive threads take consecutive queries); with
// few queries (a few hundred threads) by the latency of its loads, one
// per candidate row. K4 does K1's multiply-adds for the flagged queries
// and decodes every row once per query block of its CTA (32 queries, as
// K1; 16 where a wide f32 row needs it), 32 rows of a lane group at a
// time (`decode_lanes`; the one-pass body of scan_common.cuh says why);
// with few queries its row range is split over CTAs, and the splits
// trade its waves against K2's merge of them (`rq_codes_topk_layout`
// reports the layout the wrapper splits from). K14 is bound
// as K1 is (the same products and the same decode per 32 queries, and
// K1's register block: at keep = 4 both spill, see -Xptxas=-v); its
// CTAs walk whole tile ranges, so the wrapper splits the rows until the
// waves of CTAs fill the card's CTA slots (`rq_codes_onepass_layout`
// reports them), or a last wave part-empty would cost as much as a full
// one.
#include "scan_common.cuh"

namespace {

constexpr int DEC_BATCH = 8;   // codebook loads a decoding thread keeps in flight
constexpr int K14_PAIRS = 16;  // (lane, query) pairs of a K14 thread (4 x 4)

// The 16 bytes of dimensions [col, col + V) of a row with codes `wl`:
// sum_j Cflat[j*h + code_j] in codebook order, f32, to acc[0..V). Up to
// DEC_BATCH codebook loads are issued before any is added, so their L2
// latencies overlap.
template <typename T>
__device__ __forceinline__ void decode_chunk(const T* __restrict__ Cflat,
                                             const int* wl, int m, int h,
                                             int dp, int col,
                                             float (&acc)[Vec16<T>::N]) {
#pragma unroll
  for (int e = 0; e < Vec16<T>::N; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < m; j0 += DEC_BATCH) {
    uint4 v[DEC_BATCH];
#pragma unroll
    for (int u = 0; u < DEC_BATCH; ++u)
      if (j0 + u < m)
        v[u] = __ldg(reinterpret_cast<const uint4*>(
            Cflat + (size_t)((j0 + u) * h + code_of(wl, j0 + u)) * dp +
            col));
#pragma unroll
    for (int u = 0; u < DEC_BATCH; ++u)
      if (j0 + u < m) Vec16<T>::add(v[u], acc);
  }
}

// Decode dimensions [b0, b0 + nb) of the 128 rows of row id `rid` (dp
// values each) into XsT[kk * LP + lane] (values rounded to T) and their
// norms into x2s[lane]: the norms byte's entry, or |x_hat|^2 of the f32
// row (the PQ layout), which a block at b0 > 0 adds to the earlier
// blocks' sum. The codes load at b0 = 0 and stay for the row's later
// blocks. G threads share a row, each 16 bytes of it at a time, so a
// warp's loads are coalesced; each thread issues up to DEC_BATCH
// codebook loads before it adds any, so their L2 latencies overlap.
// Ends with a barrier.
template <typename T>
__device__ void decode_rows(const T* __restrict__ Cflat,
                            const T* __restrict__ nrm,
                            const int* __restrict__ packed, int n, int rid,
                            int m, int h, int nw, int b0, int nb, int dp,
                            int has_norms, float* XsT, float* x2s,
                            int* words) {
  constexpr int V = Vec16<T>::N;
  const int tid = threadIdx.x;
  const long long g0 = (long long)rid * LANES;
  if (b0 == 0) {
    for (int i = tid; i < LANES * nw; i += blockDim.x) {
      const long long gid = g0 + i / nw;
      words[i] = gid < n ? packed[gid * nw + i % nw] : 0;
    }
    __syncthreads();
  }
  const int cpr = nb / V;              // 16-byte chunks per row
  const int G = cpr < 32 ? cpr : 32;   // threads per row (a power of 2)
  const int t = tid & 31, per_warp = 32 / G;
  const int row_step = (blockDim.x >> 5) * per_warp;
  for (int lane = (tid >> 5) * per_warp + t / G; lane < LANES;
       lane += row_step) {
    const int* wl = words + lane * nw;
    float part = 0.f;
    for (int c = t % G; c < cpr; c += G) {
      float acc[V];
      decode_chunk<T>(Cflat, wl, m, h, dp, b0 + c * V, acc);
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
                      : (b0 == 0 ? part : x2s[lane] + part);
  }
  __syncthreads();
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

// decode_rows for the NL lanes [l0, l0 + NL) of the NR row ids rid ..
// rid + NR - 1, stored row by row at the operand type: row j < NR * NL
// (row id rid + j / NL, lane l0 + j % NL) at Xs[j * xs + kk], its norm at
// x2s[j] (the one-pass body's layout). The same threads per row, chunks
// and sums as decode_rows, so the values and norms are bit for bit the
// same. Ends with a barrier.
template <typename T, int NL, int NR>
__device__ void decode_lanes(const T* __restrict__ Cflat,
                             const T* __restrict__ nrm,
                             const int* __restrict__ packed, int n, int rid,
                             int l0, int m, int h, int nw, int b0, int nb,
                             int dp, int has_norms, T* Xs, int xs,
                             float* x2s, int* words) {
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
    float part = 0.f;
    for (int c = t % G; c < cpr; c += G) {
      float acc[V];
      decode_chunk<T>(Cflat, wl, m, h, dp, b0 + c * V, acc);
      *reinterpret_cast<uint4*>(Xs + j * xs + c * V) = pack16(acc);
#pragma unroll
      for (int e = 0; e < V; ++e) part += acc[e] * acc[e];
    }
    for (int o = G >> 1; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (t % G == 0)
      x2s[j] = has_norms ? to_f32(nrm[(size_t)code_of(wl, m) * LANES])
                         : (b0 == 0 ? part : x2s[j] + part);
  }
  __syncthreads();
}

// Row source of K1, K4 and K14: rows decoded from their packed codes.
template <typename T> struct CodesSrc {
  using Op = T;
  static constexpr bool kQueryFastest = false;
  const T* Cflat;
  const T* nrm;
  const int* packed;
  int m, h, nw, has_norms;
  __host__ __device__ int words() const { return LANES * nw; }
  __host__ __device__ int lane_words() const { return nw; }
  __device__ __forceinline__ void load(int n, int rid, int b0, int nb,
                                       int dp, float* XsT, float* x2s,
                                       int* words) const {
    decode_rows<T>(Cflat, nrm, packed, n, rid, m, h, nw, b0, nb, dp,
                   has_norms, XsT, x2s, words);
  }
  template <int NL, int NR>
  __device__ __forceinline__ void load_lanes(int n, int rid, int l0, int b0,
                                             int nb, int dp, T* Xs, int xs,
                                             float* x2s, int* words) const {
    decode_lanes<T, NL, NR>(Cflat, nrm, packed, n, rid, l0, m, h, nw, b0, nb,
                            dp, has_norms, Xs, xs, x2s, words);
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

// K14's tile-end merge for one (lane, query): the tile's KEEP survivors
// `carry` (ascending) into the ascending R-key buffer buf[c * stride]
// (device memory private to the thread), and every key that does not
// make it into the R smallest into `rest`. A streaming merge: position c
// takes the smaller of buf[c] and the carry's head, the larger joins the
// carry; the carry left at the end is what the buffer evicted. Most tiles
// of a scan bring nothing below buf[R-1]: one load decides that.
template <int R, int KEEP>
__device__ __forceinline__ void merge_survivors(int (&carry)[KEEP], int& rest,
                                                int* buf, int stride) {
  if (carry[0] < buf[(size_t)(R - 1) * stride]) {
#pragma unroll 1
    for (int c = 0; c < R; ++c) {
      const int x = buf[(size_t)c * stride];
      const int lo = min(carry[0], x), hi = max(carry[0], x);
#pragma unroll
      for (int e = 0; e < KEEP - 1; ++e) carry[e] = carry[e + 1];
      carry[KEEP - 1] = hi;
#pragma unroll
      for (int e = KEEP - 1; e > 0; --e) {
        const int a = carry[e - 1], b = carry[e];
        carry[e - 1] = min(a, b);
        carry[e] = max(a, b);
      }
      buf[(size_t)c * stride] = lo;
    }
  }
  rest = min(rest, carry[0]);
}

// K14: the one-pass scan with a per-tile cut. Grid (query blocks of 32,
// splits). CTA (qb, s) decodes each 128-row step of tiles [s*tiles_per,
// (s+1)*tiles_per) once into shared memory and scores it for its 32
// queries, K1's blocking: a thread owns 4 lanes x 4 queries. Per
// (lane, query) the tile's KEEP smallest keys stay in registers and the
// rest go to the certificate `rest`, as in K1; at the tile's end the
// survivors merge into the running R-key buffer, which lives in `scratch`
// (per CTA R x 16 x 256 ints, laid out [c][pair][thread] so that a warp's
// loads are coalesced). The buffers of the resident CTAs (264 x 458 KB
// at R = 28) outgrow the 50 MB L2, so they stream between device memory
// and L2; what a tile's end reads for most pairs is the one load of
// buf[R-1] that rejects its survivors. At the end the
// buffer goes to cand[s*R .. s*R + R) and the certificate to disc[s],
// with one split the final (R+1)-row buffer; with more K2 merges the
// splits (every key not kept is some split's rejected key or a merge
// loser, so the certificate stays exact). WIDE: the d-blocks of
// `step_scores`.
template <class Src, int R, int KEEP, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
    scan_onepass_cut_kernel(const Src src,
                            const typename Src::Op* __restrict__ Qm,
                            int* __restrict__ cand, int* __restrict__ disc,
                            int* __restrict__ scratch, int n, int nq, int dp,
                            int rows, int ntiles, int tiles_per, int idbits) {
  using T = typename Src::Op;
  extern __shared__ __align__(16) float smem[];
  const int db = WIDE ? DBLK : dp;
  float* XsT = smem;                  // db * LP
  float* Qs = XsT + db * LP;          // K1_QB * db
  float* x2s = Qs + K1_QB * db;       // LANES
  int* words = (int*)(x2s + LANES);   // src.words()
  const int q0 = blockIdx.x * K1_QB, s = blockIdx.y;
  const int lg = threadIdx.x & 31, qg = threadIdx.x >> 5;
  const int vmask = -(1 << idbits);
  constexpr int STRIDE = K14_PAIRS * THREADS;
  int* buf = scratch +
             ((size_t)s * gridDim.x + blockIdx.x) * R * STRIDE + threadIdx.x;
  if constexpr (!WIDE) load_queries<T>(Qm, q0, nq, dp, K1_QB, Qs);
  for (int c = 0; c < R * K14_PAIRS; ++c) buf[(size_t)c * THREADS] = INT_MAX;

  int best[4][4][KEEP];
  int rest[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) rest[i][j] = INT_MAX;

  const int t1 = min(ntiles, (s + 1) * tiles_per);
  for (int t = s * tiles_per; t < t1; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < KEEP; ++c) best[i][j][c] = INT_MAX;
    for (int step = 0; step < rows; ++step) {
      const int rid = t * rows + step;
      float acc[4][4];
      step_scores<WIDE>(src, Qm, q0, nq, n, rid, dp, XsT, Qs, x2s, words,
                        acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lane = lg + 32 * i;
        const bool pad = (long long)rid * LANES + lane >= n;
        const float x2 = x2s[lane];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sc = pad ? __int_as_float(0x7F800000) : acc[i][j] + x2;
          insert_sorted<KEEP>(best[i][j], rest[i][j], row_key(sc, rid, vmask));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        merge_survivors<R, KEEP>(best[i][j], rest[i][j],
                                 buf + (size_t)(i * 4 + j) * THREADS, STRIDE);
  }

  const size_t plane = (size_t)LANES * nq;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + qg * 4 + j;
      if (q >= nq) continue;
      const size_t off = (size_t)(lg + 32 * i) * nq + q;
      const int* b = buf + (size_t)(i * 4 + j) * THREADS;
      for (int c = 0; c < R; ++c)
        cand[((size_t)s * R + c) * plane + off] = b[(size_t)c * STRIDE];
      disc[(size_t)s * plane + off] = rest[i][j];
    }
}

// K14's layout for its wrapper at width dp: out[0] queries per CTA,
// out[1] ints of scratch per CTA, out[2] the CTAs an SM holds at once,
// out[3] the d-block, out[4] the bytes of shared memory per CTA.
template <class Src, int R, int KEEP>
cudaError_t onepass_cut_layout(int dp, int words, int* out) {
  const size_t smem = scan_smem(dp, K1_QB, words);
  auto kern = dp > NARROW_DP ? scan_onepass_cut_kernel<Src, R, KEEP, true>
                             : scan_onepass_cut_kernel<Src, R, KEEP, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  out[0] = K1_QB;
  out[1] = R * K14_PAIRS * THREADS;
  out[3] = scan_dblock(dp);
  out[4] = (int)smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kern,
                                                       THREADS, smem);
}

template <class Src, int R, int KEEP>
cudaError_t launch_onepass_cut(const Src& src, const void* Qm, void* cand,
                               void* disc, void* scratch, int n, int nq,
                               int dp, int rows, int ntiles, int tiles_per,
                               int idbits, cudaStream_t st) {
  const dim3 grid((nq + K1_QB - 1) / K1_QB,
                  (ntiles + tiles_per - 1) / tiles_per);
  const size_t smem = scan_smem(dp, K1_QB, src.words());
  auto kern = dp > NARROW_DP ? scan_onepass_cut_kernel<Src, R, KEEP, true>
                             : scan_onepass_cut_kernel<Src, R, KEEP, false>;
  return launch_scan(kern, grid, smem, st, src, (const typename Src::Op*)Qm,
                     (int*)cand, (int*)disc, (int*)scratch, n, nq, dp, rows,
                     ntiles, tiles_per, idbits);
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
#define RQ_K14(T, R, K)                                                     \
  return (int)launch_onepass_cut<CodesSrc<T>, R, K>(                        \
      CodesSrc<T>{(const T*)Cflat, (const T*)nrm, (const int*)packed, m, h, \
                  nw, has_norms},                                           \
      Qm, cand, disc, scratch, n, nq, dp, rows, ntiles, tiles_per, idbits, \
      st)
#define RQ_K14_T(T)                                  \
  if (r == 14 && keep == 2) RQ_K14(T, 14, 2);        \
  if (r == 12 && keep == 4) RQ_K14(T, 12, 4);        \
  if (r == 28 && keep == 4) RQ_K14(T, 28, 4);
  if (bf16) {
    RQ_K14_T(__nv_bfloat16)
  } else {
    RQ_K14_T(float)
  }
#undef RQ_K14_T
#undef RQ_K14
  return (int)cudaErrorInvalidValue;
}

// K14's layout at (r, keep, dp, nw) into out[5]: queries per CTA, ints of
// scratch per CTA (`scratch` holds one such block per CTA of the grid),
// CTAs per SM, the d-block, shared bytes per CTA. The wrapper sizes its
// scratch and its splits from these.
int rq_codes_onepass_layout(int r, int keep, int dp, int nw, int bf16,
                            void* out) {
#define RQ_K14L(T, R, K)                                                   \
  return (int)onepass_cut_layout<CodesSrc<T>, R, K>(dp, LANES * nw,        \
                                                    (int*)out)
#define RQ_K14L_T(T)                                 \
  if (r == 14 && keep == 2) RQ_K14L(T, 14, 2);       \
  if (r == 12 && keep == 4) RQ_K14L(T, 12, 4);       \
  if (r == 28 && keep == 4) RQ_K14L(T, 28, 4);
  if (bf16) {
    RQ_K14L_T(__nv_bfloat16)
  } else {
    RQ_K14L_T(float)
  }
#undef RQ_K14L_T
#undef RQ_K14L
  return (int)cudaErrorInvalidValue;
}

int rq_cand_merge(const void* cand, const void* disc, void* out, int ncand,
                  int ndisc, int nq, int r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 12: return (int)launch_merge<12>(cand, disc, out, ncand, ndisc, nq, st);
    case 14: return (int)launch_merge<14>(cand, disc, out, ncand, ndisc, nq, st);
    case 28: return (int)launch_merge<28>(cand, disc, out, ncand, ndisc, nq, st);
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
