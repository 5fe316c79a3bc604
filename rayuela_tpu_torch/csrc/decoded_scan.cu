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
// there) and their key modes (qbias, score16) are instances of K8's
// bodies in decoded_modes.cu (decoded_rows.cuh says how): register
// insertion rejects most keys with one compare, so the pre-min saves no
// time on this card, and the search's plan does not ask for it. The
// TPU keeps one running buffer per query block across a
// sequential tile axis; here every (tile, query block) CTA writes its
// tile's per-lane top-keep and discard minimum, and K2 (cand_merge,
// codes_scan.cu) reduces them to the (r + 1, 128, nq) buffer the TPU
// kernel emits.
//
// K8's candidates kernel is a body of decoded_rows.cuh at either type:
// the 128 rows of a row id are a contiguous block of the decoded base Xd
// (n, dp), dp a multiple of 8, already at the operand type, and their
// norms come from x2 (n,) f32. On f32 rows it is K9/K10's exact-float
// body (`exact_rows_kernel`) with the packed-key sink of scan_common.cuh
// (`KeySink`): the scores are the fmaf chain's (the dot in dimension
// order plus x2, K1's f32 arithmetic), the keys those of the body it
// replaced, bit for bit. On bf16 rows it is `rows_mma_kernel`: the
// tensor-core score of K1, K14 and K4 (`tile_scores`), and where a row is
// one d-block the keys are the fmaf chain's (`margin_keys`), so K8's keys
// equal K1's on the same rows at any width and the f32 body's at one
// d-block. Either takes a row wider than 256 (GIST's d = 960) in stages.
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
// nq = 1e4, dp = 128: 2.6 ms at the bf16 tensor-core peak, 38.2 ms at the
// f32 CUDA-core one) and, per query block, its tile's rows (2 MB in
// bf16), which it reads rather than decodes. The bf16 body
// (`rows_mma_kernel`, below, which says what it does about the rest) puts
// the products on the tensor cores and stages 128-row steps by cp.async;
// the f32 body is K9's (below: 64 queries x 16 lanes a CTA, rows and
// queries staged together, 32 chains a thread). Both grids run the query
// blocks of one tile together, so a tile comes from device memory about
// once and from L2 for the other query blocks. scan_onepass (keep = 0) is
// the one-pass body of scan_common.cuh over the same rows (`load_lanes`:
// a lane group's rows are one contiguous run of Xd): it reads a row once
// per query block of its CTA (up to 32 queries), and the query blocks of
// one lane group and split are neighbours in the grid, so they find its
// rows in L2; on bf16 it scores on the tensor cores as the candidates
// body does, and with few queries its row range is split over CTAs as
// K4's is.

#include "decoded_rows.cuh"

namespace {

constexpr int LOAD_BATCH = 4;  // 16-byte loads a thread keeps in flight

// Row source of K8 at keep = 0: rows of the decoded base. On bf16 rows
// it scores on the tensor cores (`tensor_scores`), as K8's candidates
// body (`rows_mma_kernel`, below) does.
template <typename T> struct RowsSrc {
  using Op = T;
  static constexpr bool kTensorScores = std::is_same<T, __nv_bfloat16>::value;
  const T* Xd;
  const float* x2;
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

}  // namespace

extern "C" {

// K8's key modes and pre-min (decoded_modes.cu).
int rq_scan_candidates_modes(const void* Qm, const void* Xd, const void* x2,
                             const void* q2, void* cand, void* disc,
                             void* stats, int n, int nq, int dp, int ntiles,
                             int rows, int keep, int idbits, int bf16,
                             int mode, int premin, void* stream);

// K8: per tile and (lane, query) the keep smallest keys and the
// certificate. bf16 rows take the tensor-core body (`rows_mma_kernel`),
// f32 rows the exact-float body with the packed-key sink (Qm then -2q in
// f32, 16-byte aligned); stats (bf16 only, may be null) gains the pairs
// the fmaf chain scored. mode (K8_PLAIN, K8_QBIAS with the queries' |q|^2
// in q2, K8_SCORE16) and premin > 0 take the instances of
// decoded_modes.cu.
int rq_scan_candidates(const void* Qm, const void* Xd, const void* x2,
                       const void* q2, void* cand, void* disc, void* stats,
                       int n, int nq, int dp, int ntiles, int rows, int keep,
                       int idbits, int bf16, int mode, int premin,
                       void* stream) {
  if (mode != K8_PLAIN || premin)
    return rq_scan_candidates_modes(Qm, Xd, x2, q2, cand, disc, stats, n, nq,
                                    dp, ntiles, rows, keep, idbits, bf16,
                                    mode, premin, stream);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    switch (keep) {
      case 2: return (int)launch_rows_mma<2>(Qm, Xd, x2, q2, cand, disc,
                                             stats, n, nq, dp, ntiles, rows,
                                             idbits, 0, st);
      case 4: return (int)launch_rows_mma<4>(Qm, Xd, x2, q2, cand, disc,
                                             stats, n, nq, dp, ntiles, rows,
                                             idbits, 0, st);
    }
    return (int)cudaErrorInvalidValue;
  }
#define RQ_K8(K)                                                          \
  return (int)launch_exact<float>(                                        \
      Qm, Xd, x2, KeySink<K>{(int*)cand, (int*)disc, -(1 << idbits)}, n,  \
      nq, dp, ntiles, rows, st)
  switch (keep) {
    case 2: RQ_K8(2);
    case 4: RQ_K8(4);
  }
#undef RQ_K8
  return (int)cudaErrorInvalidValue;
}

// K8's layout at width dp into out[5] (scan._candidates_layout mirrors
// the first four): queries per CTA, dimensions per stage, stages, bytes of
// shared memory per CTA, and the CTAs an SM holds at once (of the keep =
// 2 instance; keep = 4 takes the same layout). The f32 body's is K9's at
// every dp.
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
    o[0] = EX_QB;
    o[1] = EX_KC;
    o[2] = EX_STAGES;
    o[3] = ex_smem<float>();
    kern = (const void*)exact_rows_kernel<float, KeySink<2>>;
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
