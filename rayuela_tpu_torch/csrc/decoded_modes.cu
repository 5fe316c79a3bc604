// K8's key modes and pre-min for Hopper (sm_90a): the instances of K8's
// candidates bodies (decoded_rows.cuh) that scan_pallas.py::
// _scan_kernel_packed and ::_scan_kernel_packed_staged run with qbias,
// score16 or premin > 0. The default key mode without the pre-min stays in
// decoded_scan.cu, whose rq_scan_candidates hands every other launch here;
// a source of its own, so that nvcc compiles these 30 instances beside
// the other sources.

#include "decoded_rows.cuh"

namespace {

template <int MODE, bool PM>
cudaError_t launch_k8(const void* Qm, const void* Xd, const void* x2,
                      const void* q2, void* cand, void* disc, void* stats,
                      int n, int nq, int dp, int ntiles, int rows, int keep,
                      int idbits, int bf16, int premin, cudaStream_t st) {
  if (bf16) {
    switch (keep) {
      case 2:
        return launch_rows_mma<2, MODE, PM>(Qm, Xd, x2, q2, cand, disc,
                                            stats, n, nq, dp, ntiles, rows,
                                            idbits, premin, st);
      case 4:
        return launch_rows_mma<4, MODE, PM>(Qm, Xd, x2, q2, cand, disc,
                                            stats, n, nq, dp, ntiles, rows,
                                            idbits, premin, st);
    }
    return cudaErrorInvalidValue;
  }
#define RQ_K8M(K)                                                        \
  return launch_exact<float>(                                            \
      Qm, Xd, x2,                                                        \
      K8Sink<K, MODE, PM>{(int*)cand, (int*)disc, -(1 << idbits), idbits, \
                          (const float*)q2, (1 << premin) - 1},          \
      n, nq, dp, ntiles, rows, st)
  switch (keep) {
    case 2: RQ_K8M(2);
    case 4: RQ_K8M(4);
  }
#undef RQ_K8M
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K8 in key mode `mode` (K8_QBIAS: q2 the queries' |q|^2, f32; K8_SCORE16:
// idbits <= 15) and with the pre-min at premin (0: none); arguments
// otherwise as rq_scan_candidates's.
int rq_scan_candidates_modes(const void* Qm, const void* Xd, const void* x2,
                             const void* q2, void* cand, void* disc,
                             void* stats, int n, int nq, int dp, int ntiles,
                             int rows, int keep, int idbits, int bf16,
                             int mode, int premin, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((mode == K8_QBIAS && !q2) || (mode == K8_SCORE16 && idbits > 15) ||
      premin < 0 || (rows >> premin) < 1)
    return (int)cudaErrorInvalidValue;
#define RQ_MODE(M, P)                                                     \
  return (int)launch_k8<M, P>(Qm, Xd, x2, q2, cand, disc, stats, n, nq, dp, \
                              ntiles, rows, keep, idbits, bf16, premin, st)
  switch (mode) {
    case K8_PLAIN:
      if (premin) RQ_MODE(K8_PLAIN, true);
      break;
    case K8_QBIAS:
      if (premin) RQ_MODE(K8_QBIAS, true);
      RQ_MODE(K8_QBIAS, false);
    case K8_SCORE16:
      if (premin) RQ_MODE(K8_SCORE16, true);
      RQ_MODE(K8_SCORE16, false);
  }
#undef RQ_MODE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
