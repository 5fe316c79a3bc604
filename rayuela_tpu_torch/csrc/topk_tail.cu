// Cross-lane top-k merge for Hopper (sm_90a): K3.
//
// Replaces rayuela_tpu/search/scan_pallas.py::_tail_kernel (called by
// _tail_candidates_pallas). Input: a scan's per-lane key buffer
// rows (r, 128, nq) int32, each lane's list ascending. Output, per
// query, the cap smallest (key, lane) pairs over the 128 lists ordered
// by (key, lane): keys (nq, cap) and lanes (nq, cap). Since
// gid = rid * 128 + lane and the key's low bits are rid, that order is
// (truncated score, gid), so ties between lanes resolve the same way
// in the kernel and in the plain version and their outputs are equal.
//
// What bounds it on the card: almost nothing at the search path's
// shapes (nq * 128 * L0 keys read once, a few hundred MB at nq=1e4).
// One CTA per query loads only each lane's first L0 = min(cap,
// next_pow2(r)) keys (a key of lane rank >= cap cannot reach the global
// top-cap) as composites int64(key) * 128 + lane into shared memory
// and bitonic-sorts them there: 128 * L0 <= 8192 composites (64 KB,
// dynamic shared memory) for the rescue buffer r = 48. Reads are
// strided by nq, so they are not coalesced; at these volumes that
// costs under a millisecond.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int LANES = 128;

__global__ void __launch_bounds__(1024)
    tail_merge_kernel(const int* __restrict__ rows, int* __restrict__ keys,
                      int* __restrict__ lanes, int r, int nq, int cap,
                      int L0) {
  extern __shared__ long long s[];
  const int N = LANES * L0;
  const int q = blockIdx.x;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int slot = i / LANES, lane = i % LANES;
    const int key =
        slot < r ? rows[((size_t)slot * LANES + lane) * nq + q] : INT_MAX;
    s[i] = (long long)key * LANES + lane;
  }
  __syncthreads();
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const long long a = s[i], b = s[p];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            s[i] = b;
            s[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const long long v = s[i];
    keys[(size_t)q * cap + i] = (int)(v >> 7);  // floor(v / 128)
    lanes[(size_t)q * cap + i] = (int)(v & (LANES - 1));
  }
}

}  // namespace

extern "C" int rq_tail_merge(const void* rows, void* keys, void* lanes,
                             int r, int nq, int cap, int L0, void* stream) {
  const int N = LANES * L0;
  const size_t smem = sizeof(long long) * (size_t)N;
  cudaError_t e = cudaFuncSetAttribute(
      tail_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = N < 1024 ? N : 1024;
  tail_merge_kernel<<<nq, threads, smem, (cudaStream_t)stream>>>(
      (const int*)rows, (int*)keys, (int*)lanes, r, nq, cap, L0);
  return (int)cudaGetLastError();
}
