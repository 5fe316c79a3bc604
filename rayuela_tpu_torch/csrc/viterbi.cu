// Viterbi (min-sum) chain encoding for Hopper (sm_90a): K13.
//
// Replaces rayuela_tpu/ops/viterbi_pallas.py::_viterbi_kernel (called by
// viterbi_encode_pallas). Contract, shared with the plain version
// viterbi_encode_plain in rayuela_tpu_torch/ops/viterbi.py: given X
// (n, d) f32, the codebooks transposed Ct (m, d, h) f32, c2 = |C|^2
// (m*h) f32 and the chain binaries bin (m-1, h, h) f32, bin_i(a, b) =
// 2 C_i[a].C_{i+1}[b], the unaries are u_i(b) = c2_i(b) - 2 C_i[b].x in
// f32 (computed here, as in the TPU kernel), the forward pass is f_0 =
// u_0, f_{i+1}(b) = u_{i+1}(b) + min_a [f_i(a) + bin_i(a, b)], the code
// of the last stage is the lowest b attaining min f_{m-1}, and each
// earlier code the lowest a attaining min_a f_i(a) + bin_i(a, b_{i+1}).
// Output: codes (n, m) int32. The plain version takes its unaries from
// a matmul, which sums each dot in another order; after the unaries,
// every add is rounded once in the same order as there, so on data
// whose dots are exact in f32 (small integers) the codes are identical.
//
// What bounds it on the card: the min-plus work, (m-1) h^2 add-min pairs
// per vector (393k at m=7, h=256), beside m h d unary FMAs (229k at
// d=128), and the reading of bin_i, h^2 f32 (256 KB) per stage, which
// does not fit in shared memory, and of C_i, h d f32 (128 KB).
// Measured at 20.25 ms per 1e5 vectors at m=7, d=128 (NVIDIA H100 80GB
// HBM3 at 700 W), 12% of the f32 peak: neither bound is reached, and
// each tile load, which sits between two CTA barriers and overlaps no
// compute, is the likely limit (8x faster than the plain version all
// the same).
//
// What the design does about it: a CTA takes 8 vectors and one thread
// per label b. bin_i streams through shared memory in 32 KB tiles of
// rows a, each tile used by all 8 vectors, so L2 serves 32 KB of bin per
// vector and stage; the forward costs f_i of the 8 vectors sit in shared
// memory transposed ([a][v]), so one 16-byte broadcast read feeds four
// vectors. The unaries are computed in the kernel, so no (n, m h) unary
// tensor goes through HBM: the 8 vectors sit in shared memory ([k][v]),
// and thread b reads C_i[b] as a column of Ct, coalesced across the
// CTA and served by L2 (C is m h d f32, 917 KB at m=7), 16 KB per vector
// and stage. No argmin table is kept: as in the TPU kernel, the
// backtrace recomputes each argmin from the stored f_i (one warp per
// vector, h adds per stage) with the column bin_i[:, b] read as a row of
// the transposed binaries binT, coalesced.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int VB = 8;              // vectors per CTA
constexpr int TILE_BYTES = 32768;  // rows of bin_i staged per tile

// keep (v, i) the smaller value, the lower index on ties; i == INT_MAX
// marks "no candidate yet"
__device__ __forceinline__ void argmin_merge(float& v, int& i, float ov,
                                             int oi) {
  if (oi != INT_MAX && (i == INT_MAX || ov < v || (ov == v && oi < i))) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    argmin_merge(v, i, ov, oi);
  }
}

// u_i(b) = c2_i(b) - 2 C_i[b].x_v for the CTA's VB vectors: this
// thread's label b, C_i read transposed (Ct[i][k][b], coalesced across
// the CTA's threads, through L2), x from shared memory ([k][v], two
// 16-byte broadcast reads per dimension), f32 FMAs in ascending k
__device__ __forceinline__ void unaries(const float* __restrict__ Ct,
                                        const float* __restrict__ c2,
                                        const float* xs, int i, int b, int h,
                                        int d, float (&u)[VB]) {
  float acc[VB];
#pragma unroll
  for (int v = 0; v < VB; ++v) acc[v] = 0.f;
  const float* ct = Ct + (size_t)i * d * h + b;
#pragma unroll 4
  for (int k = 0; k < d; ++k) {
    const float c = ct[(size_t)k * h];
    const float4 x0 = *reinterpret_cast<const float4*>(xs + k * VB);
    const float4 x1 = *reinterpret_cast<const float4*>(xs + k * VB + 4);
    acc[0] = fmaf(x0.x, c, acc[0]);
    acc[1] = fmaf(x0.y, c, acc[1]);
    acc[2] = fmaf(x0.z, c, acc[2]);
    acc[3] = fmaf(x0.w, c, acc[3]);
    acc[4] = fmaf(x1.x, c, acc[4]);
    acc[5] = fmaf(x1.y, c, acc[5]);
    acc[6] = fmaf(x1.z, c, acc[6]);
    acc[7] = fmaf(x1.w, c, acc[7]);
  }
  const float cb = c2[(size_t)i * h + b];
#pragma unroll
  for (int v = 0; v < VB; ++v) u[v] = cb - 2.f * acc[v];
}

__global__ void viterbi_kernel(const float* __restrict__ X,
                               const float* __restrict__ Ct,
                               const float* __restrict__ c2,
                               const float* __restrict__ bin,
                               const float* __restrict__ binT,
                               int* __restrict__ out, int n, int m, int h,
                               int d, int ta) {
  extern __shared__ __align__(16) float smem[];
  float* fst = smem;                          // (m, h, VB): f_i(a), [i][a][v]
  float* tile = fst + (size_t)m * h * VB;     // (ta, h): rows of bin_i
  float* xs = tile + (size_t)ta * h;          // (d, VB): x, [k][v]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int v0 = blockIdx.x * VB;
  const int b = tid;                          // this thread's label
  const bool own = b < h;
  float u[VB];

  for (int e = tid; e < VB * d; e += nthr) {  // coalesced along k
    const int v = e / d, k = e - v * d;
    xs[k * VB + v] = v0 + v < n ? X[(size_t)(v0 + v) * d + k] : 0.f;
  }
  __syncthreads();
  if (own) {
    unaries(Ct, c2, xs, 0, b, h, d, u);
#pragma unroll
    for (int v = 0; v < VB; ++v) fst[(size_t)b * VB + v] = u[v];
  }
  for (int i = 0; i + 1 < m; ++i) {
    float mn[VB];
#pragma unroll
    for (int v = 0; v < VB; ++v) mn[v] = INFINITY;
    const float* bi = bin + (size_t)i * h * h;
    const float* fi = fst + (size_t)i * h * VB;
    for (int a0 = 0; a0 < h; a0 += ta) {
      const int rows = min(ta, h - a0);
      __syncthreads();  // f_i written, and the last tile read
      for (int e = tid; e < rows * h; e += nthr)
        tile[e] = bi[(size_t)a0 * h + e];
      __syncthreads();
      if (own) {
        for (int a = 0; a < rows; ++a) {
          const float bv = tile[a * h + b];
          const float4 f0 =
              *reinterpret_cast<const float4*>(fi + (size_t)(a0 + a) * VB);
          const float4 f1 = *reinterpret_cast<const float4*>(
              fi + (size_t)(a0 + a) * VB + 4);
          mn[0] = fminf(mn[0], f0.x + bv);
          mn[1] = fminf(mn[1], f0.y + bv);
          mn[2] = fminf(mn[2], f0.z + bv);
          mn[3] = fminf(mn[3], f0.w + bv);
          mn[4] = fminf(mn[4], f1.x + bv);
          mn[5] = fminf(mn[5], f1.y + bv);
          mn[6] = fminf(mn[6], f1.z + bv);
          mn[7] = fminf(mn[7], f1.w + bv);
        }
      }
    }
    if (own) {
      unaries(Ct, c2, xs, i + 1, b, h, d, u);
      float* fn = fst + ((size_t)(i + 1) * h + b) * VB;
#pragma unroll
      for (int v = 0; v < VB; ++v) fn[v] = u[v] + mn[v];
    }
  }
  __syncthreads();

  // backtrace, one warp per vector
  const int warp = tid >> 5, lane = tid & 31, nw = nthr >> 5;
  for (int v = warp; v < VB; v += nw) {
    if (v0 + v >= n) continue;               // uniform across the warp
    int* o = out + (size_t)(v0 + v) * m;
    float best = INFINITY;
    int arg = INT_MAX;
    for (int a = lane; a < h; a += 32)
      argmin_merge(best, arg, fst[((size_t)(m - 1) * h + a) * VB + v], a);
    warp_argmin(best, arg);
    int bn = arg;
    if (lane == 0) o[m - 1] = bn;
    for (int i = m - 2; i >= 0; --i) {
      const float* col = binT + ((size_t)i * h + bn) * h;  // bin_i[:, bn]
      best = INFINITY;
      arg = INT_MAX;
      for (int a = lane; a < h; a += 32)
        argmin_merge(best, arg, fst[((size_t)i * h + a) * VB + v] + col[a],
                     a);
      warp_argmin(best, arg);
      bn = arg;
      if (lane == 0) o[i] = bn;
    }
  }
}

}  // namespace

extern "C" int rq_viterbi_encode(const void* X, const void* Ct,
                                 const void* c2, const void* bin,
                                 const void* binT, void* out, int n, int m,
                                 int h, int d, void* stream) {
  if (n <= 0) return 0;
  if (h < 1 || h > 1024 || m < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int ta = TILE_BYTES / (4 * h) > 0 ? TILE_BYTES / (4 * h) : 1;
  const size_t smem =
      sizeof(float) * ((size_t)VB * m * h + (size_t)ta * h + (size_t)VB * d);
  cudaError_t e = cudaFuncSetAttribute(
      viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (h + 31) / 32 * 32;
  const int grid = (n + VB - 1) / VB;
  viterbi_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)Ct, (const float*)c2, (const float*)bin,
      (const float*)binT, (int*)out, n, m, h, d, ta);
  return (int)cudaGetLastError();
}
