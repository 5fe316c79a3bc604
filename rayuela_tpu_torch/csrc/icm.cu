// ICM sweeps for Hopper (sm_90a): K11.
//
// Replaces rayuela_tpu/ops/icm_pallas.py::_kernel (called by
// icm_sweeps_pallas). Contract, shared with the plain version
// icm_sweeps_plain(op_dtype=bfloat16) in rayuela_tpu_torch/ops/icm.py:
// X and C are rounded to bf16 (xb, Cb), c2 = |C|^2 comes from the f32 C,
// S = sum_j Cb_j[B_j] over the nodes in `order` (f32). Each of the
// icmiter*m visits takes node i = order[t % m] and sets
//   B_i <- argmin_b  c2_i(b) - 2 xb.Cb_i[b] + 2 bf16(S - Cb_i[B_i]).Cb_i[b]
// (f32 accumulation, ties to the lowest b), then S <- S + (Cb_i[new] -
// Cb_i[old]). The output energy is E = 1/2 sum_i [cond_i(B_i) + u_i(B_i)]
// with u_i(b) = c2_i(b) - 2 xb.Cb_i[b], summed over i in `order`;
// icmiter = 0 only evaluates E. Outputs: codes (n, m) int32, E (n,) f32.
//
// What bounds it on the card: the conditional dot products, h*d
// multiply-adds per visit and vector (32,768 at h=256, d=128; 0.92 M per
// ILS round at m=7, icmiter=4), on the CUDA cores in f32, and the L2
// reads of Cb_i^T that feed them (16 bytes per 64 FMAs of a lane).
// Measured at 1.2e13 FMA/s, 36% of the f32 peak (NVIDIA H100 80GB HBM3
// at 700 W), so the reads, not the FMAs, are the likely limit.
//
// What the design does about it:
// * No per-vector state beyond x, S and the codes. The TPU kernel kept
//   unaries (m, c, h), one-hot indicators and per-node contributions
//   G (m, c, d) in VMEM; that does not fit in 227 KB of shared memory.
//   Here Cb_i[B_i] is a row lookup (Mosaic's missing integer gather is no
//   constraint on Hopper), and the unary dot is folded into the
//   conditional one: cond_i(b) = c2_i(b) + 2 (bf16(S - Cb_i[B_i]) - xb)
//   .Cb_i[b], one pass over Cb_i per visit and no unary state, for any m
//   (keeping the unaries instead would take m*h*4 bytes per vector,
//   114 KB for 16 vectors at m=7, and not fit at m=16). Its rounding
//   differs from the two-dot form only in the f32 accumulation; on data
//   that bf16 holds exactly (small integers) it is identical.
// * A warp owns 8 vectors and all h labels (h/32 per lane), so each
//   lane keeps an 8 x h/32 register block of sums: per dimension one
//   16-byte load of Cb_i^T (h/32 labels), two 16-byte broadcast reads of
//   the 8 vectors' weights, 8*h/32 FMAs. The argmin over h is one warp
//   shuffle reduction, with no shared memory.
// * The codebook slab Cb (m*h*d bf16 = 458 KB at m=7) fits in L2, not in
//   shared memory, so every warp reads Cb_i^T (64 KB) straight through
//   L1/L2. A variant that staged Cb_i^T per visit through shared memory
//   in 32-row chunks shared by the CTA's 4 warps was measured slower
//   (NVIDIA H100 80GB HBM3 at 700 W: 8.29 against 7.73 ms for one
//   icmiter=4 call on 1e5 vectors at m=7, d=128, h=256; its CTA-wide
//   barriers cost more than the L2 reads they save) and was dropped.
// * The node order is an argument read by the kernel (the TPU wrapper
//   permuted C and B on the host instead).
// * The kernel is compiled for h in {32, 64, 128, 256}. The wrapper
//   pads any other h up to the next of these with zero rows whose c2 is
//   +inf: their cond is +inf, so they never win the argmin, and being
//   the highest labels they never win a tie either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int WV = 8;     // vectors per warp
constexpr int WARPS = 4;  // warps per CTA

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// NB consecutive bf16 labels of one row of Cb_i^T, widened to f32
// (little-endian: the lower address is the low half; a bf16 is the top
// half of the f32 of the same value)
template <int NB> struct Labels;
template <> struct Labels<8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* c) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[2 * i] = __uint_as_float(w[i] << 16);
      c[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};
template <> struct Labels<4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* c) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    c[0] = __uint_as_float(u.x << 16);
    c[1] = __uint_as_float(u.x & 0xFFFF0000u);
    c[2] = __uint_as_float(u.y << 16);
    c[3] = __uint_as_float(u.y & 0xFFFF0000u);
  }
};
template <> struct Labels<1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* c) {
    c[0] = bf(*p);
  }
};
template <> struct Labels<2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* c) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    c[0] = __uint_as_float(u << 16);
    c[1] = __uint_as_float(u & 0xFFFF0000u);
  }
};

__device__ __forceinline__ void argmin_merge(float& v, int& i, float ov,
                                             int oi) {
  if (oi != INT_MAX && (i == INT_MAX || ov < v || (ov == v && oi < i))) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[v][j] += sum_k w[k][v] * rows[k][lane*NB + j] over kc dimensions;
// rows has a row stride of H labels, w a row stride of WV vectors
template <int NB>
__device__ __forceinline__ void accumulate(const __nv_bfloat16* rows, int kc,
                                           const float* w,
                                           float (&acc)[WV][NB], int lane) {
  constexpr int H = 32 * NB;
  const __nv_bfloat16* p = rows + lane * NB;
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    float c[NB];
    Labels<NB>::load(p + (size_t)k * H, c);
    const float4 w0 = *reinterpret_cast<const float4*>(w + k * WV);
    const float4 w1 = *reinterpret_cast<const float4*>(w + k * WV + 4);
    const float wv[WV] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int v = 0; v < WV; ++v)
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[v][j] = fmaf(wv[v], c[j], acc[v][j]);
  }
}

template <int NB>
__global__ void __launch_bounds__(WARPS * 32)
    icm_sweeps_kernel(const __nv_bfloat16* __restrict__ X,   // (n, d)
                      const __nv_bfloat16* __restrict__ Cr,  // (m*H, d)
                      const __nv_bfloat16* __restrict__ Ct,  // (m, d, H)
                      const float* __restrict__ c2,          // (m*H)
                      const int* __restrict__ Bin,           // (n, m)
                      const int* __restrict__ order,         // (m)
                      int* __restrict__ Bout, float* __restrict__ E, int n,
                      int d, int m, int icmiter, int warp_bytes) {
  constexpr int H = 32 * NB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = reinterpret_cast<float*>(smem + (size_t)warp * warp_bytes);
  float* ss = xs + WV * d;     // S, [v][k]
  float* wt = ss + WV * d;     // weights bf16(S - Cb_i[B_i]) - xb, [k][v]
  int* bs = reinterpret_cast<int*>(wt + WV * d);  // codes, [v][j]
  const int v0 = (blockIdx.x * WARPS + warp) * WV;
  const int nd = WV * d;

  for (int e = lane; e < nd; e += 32) {
    const int v = e / d, k = e - v * d;
    xs[e] = v0 + v < n ? bf(X[(size_t)(v0 + v) * d + k]) : 0.f;
  }
  for (int e = lane; e < WV * m; e += 32) {
    const int v = e / m;
    bs[e] = v0 + v < n ? Bin[(size_t)v0 * m + e] : 0;
  }
  __syncwarp();
  for (int e = lane; e < nd; e += 32) {
    const int v = e / d, k = e - v * d;
    float s = 0.f;
    for (int t = 0; t < m; ++t) {
      const int j = order[t];
      s += bf(Cr[((size_t)j * H + bs[v * m + j]) * d + k]);
    }
    ss[e] = s;
  }
  __syncwarp();

  for (int t = 0; t < icmiter * m; ++t) {
    const int i = order[t % m];
    for (int e = lane; e < nd; e += 32) {
      const int v = e / d, k = e - v * d;
      const float g = bf(Cr[((size_t)i * H + bs[v * m + i]) * d + k]);
      wt[k * WV + v] = round_bf16(ss[e] - g) - xs[e];
    }
    __syncwarp();
    float acc[WV][NB];
#pragma unroll
    for (int v = 0; v < WV; ++v)
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[v][j] = 0.f;
    accumulate<NB>(Ct + (size_t)i * d * H, d, wt, acc, lane);
    int nb[WV];
#pragma unroll
    for (int v = 0; v < WV; ++v) {
      float best = INFINITY;
      int arg = INT_MAX;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int b = lane * NB + j;
        argmin_merge(best, arg, c2[i * H + b] + 2.f * acc[v][j], b);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, arg, off);
        argmin_merge(best, arg, ov, oi);
      }
      nb[v] = arg;
    }
#pragma unroll
    for (int v = 0; v < WV; ++v) {
      const int old = bs[v * m + i];
      if (nb[v] != old) {  // S + (g_new - g_old), as the TPU kernel
        const __nv_bfloat16* gn = Cr + ((size_t)i * H + nb[v]) * d;
        const __nv_bfloat16* go = Cr + ((size_t)i * H + old) * d;
        for (int k = lane; k < d; k += 32)
          ss[v * d + k] += bf(gn[k]) - bf(go[k]);
      }
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int v = 0; v < WV; ++v) bs[v * m + i] = nb[v];
    }
    __syncwarp();
  }

  for (int v = 0; v < WV; ++v) {
    if (v0 + v >= n) break;  // uniform across the warp
    float acc = 0.f;
    for (int t = 0; t < m; ++t) {
      const int i = order[t];
      const int bi = bs[v * m + i];
      const __nv_bfloat16* g = Cr + ((size_t)i * H + bi) * d;
      float xg = 0.f, rg = 0.f;
      for (int k = lane; k < d; k += 32) {
        const float gk = bf(g[k]);
        xg = fmaf(xs[v * d + k], gk, xg);
        rg = fmaf(round_bf16(ss[v * d + k] - gk), gk, rg);
      }
      xg = warp_sum(xg);
      rg = warp_sum(rg);
      const float u = c2[i * H + bi] - 2.f * xg;
      acc += (u + 2.f * rg) + u;
    }
    if (lane == 0) E[v0 + v] = 0.5f * acc;
    for (int j = lane; j < m; j += 32)
      Bout[(size_t)(v0 + v) * m + j] = bs[v * m + j];
  }
}

template <int NB>
int launch_icm(const void* X, const void* Cr, const void* Ct, const void* c2,
               const void* Bin, const void* order, void* Bout, void* E,
               int n, int d, int m, int icmiter, cudaStream_t stream) {
  // per-warp x, S, weights (f32) and codes; 16-byte aligned
  const int warp_bytes = (3 * WV * d * 4 + WV * m * 4 + 15) / 16 * 16;
  const size_t smem = (size_t)WARPS * warp_bytes;
  auto kern = icm_sweeps_kernel<NB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + WARPS * WV - 1) / (WARPS * WV);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      (const __nv_bfloat16*)X, (const __nv_bfloat16*)Cr,
      (const __nv_bfloat16*)Ct, (const float*)c2, (const int*)Bin,
      (const int*)order, (int*)Bout, (float*)E, n, d, m, icmiter,
      warp_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rq_icm_sweeps(const void* X, const void* Cr, const void* Ct,
                             const void* c2, const void* Bin,
                             const void* order, void* Bout, void* E, int n,
                             int d, int m, int h, int icmiter,
                             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define RQ_ICM(NB) \
  return launch_icm<NB>(X, Cr, Ct, c2, Bin, order, Bout, E, n, d, m, icmiter, s)
  switch (h) {
    case 32: RQ_ICM(1);
    case 64: RQ_ICM(2);
    case 128: RQ_ICM(4);
    case 256: RQ_ICM(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RQ_ICM
}
