// ICM sweeps for Hopper (sm_90a): K11, and the whole-ILS encode K12.
//
// K11 replaces rayuela_tpu/ops/icm_pallas.py::_kernel (launched at :276
// by icm_sweeps_pallas). Contract, shared with the plain version
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
// K12 replaces rayuela_tpu/ops/icm_pallas.py::_kernel_ils (launched at
// :326 by encoding_ils_pallas): the whole ILS loop in one launch, with
// the plain version encoding_ils_plain(op_dtype=bfloat16). Per vector:
// B_best = B0 and E_best = energy(B0); then per round r < ilsiter, from
// B_best, npert redraws (draw p sets position hash32(ctr) % m to
// hash32(ctr ^ 0x5BD1E995) % h, the last hit winning, with the uint32
// counter ctr = seed + gid*0x9E3779B9 + r*0x85EBCA6B + p*0xC2B2AE35 and
// gid the vector's global index), S rebuilt from the perturbed codes,
// icmiter*m visits in the order orders[r, t % m] (K11's visit), the
// energy, and a strict accept. Outputs: B_best (n, m) int32, E_best (n,).
// Unlike K11, K12 rebuilds S and sums its energy over the nodes in
// codebook order 0..m-1, as the TPU kernel does (its rebuild and its
// energy loop run over 0..m-1 while K11's TPU kernel receives its inputs
// permuted by `order`). The two orders are kept as they are: each kernel
// matches its TPU kernel bit for bit on data that bf16 holds exactly.
//
// What bounds them on the card: the conditional dot products, h*d
// multiply-adds per visit and vector (32,768 at h=256, d=128; 0.92 M per
// ILS round at m=7, icmiter=4), on the CUDA cores in f32, and the L2
// reads of Cb_i^T that feed them (16 bytes per 64 FMAs of a lane).
// Measured at 1.2e13 FMA/s, 36% of the f32 peak (NVIDIA H100 80GB HBM3
// at 700 W), so the reads, not the FMAs, are the likely limit. K12 does
// the same visits for all rounds in one launch; its per-round rebuild,
// perturbation and energy add m*d reads and 2*m*d FMAs per vector, under
// 1% of a round's visits.
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
// * A warp owns 8 vectors and all h labels, in register blocks of up to
//   256 labels (8 per lane): per dimension one 16-byte load of Cb_i^T,
//   two 16-byte broadcast reads of the 8 vectors' weights, 64 FMAs. For
//   h > 256 the visit loops over blocks of 256 labels and each lane
//   carries its running (min, argmin) across them, ties to the lower
//   label; the argmin over the lanes is one warp shuffle reduction, with
//   no shared memory.
// * A warp's state (x, S and the weights: 3*8*d f32, and the codes) sits
//   in shared memory, so d sets the warps per CTA at launch: 4 while four
//   warps' state fits in 227 KB (d <= 598 at m=8), 2 up to d = 1200, then
//   1. K12 adds B_best and E_best to the same per-warp block (K11 leaves
//   them unused: one layout for both). The hash runs in registers, and
//   the rounds loop inside the launch: no host sync per round.
// * The codebook slab Cb (m*h*d bf16 = 458 KB at m=7) fits in L2, not in
//   shared memory, so every warp reads Cb_i^T (64 KB) straight through
//   L1/L2. A variant that staged Cb_i^T per visit through shared memory
//   in 32-row chunks shared by the CTA's 4 warps was measured slower
//   (NVIDIA H100 80GB HBM3 at 700 W: 8.29 against 7.73 ms for one
//   icmiter=4 call on 1e5 vectors at m=7, d=128, h=256; its CTA-wide
//   barriers cost more than the L2 reads they save) and was dropped.
// * The node order is an argument read by the kernel (the TPU wrapper
//   permuted C and B on the host instead).
// * The kernels are compiled for 32, 64, 128 labels and for blocks of
//   256. The wrapper pads any other h up to 32, 64, 128 or a multiple of
//   256 (at most 1024) with zero rows whose c2 is +inf: their cond is
//   +inf, so they never win the argmin, and being the highest labels
//   they never win a tie either. K12 draws its perturbed values below
//   the true h, which it takes as an argument of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int WV = 8;         // vectors per warp
constexpr int MAX_WARPS = 4;  // warps per CTA where their state fits
constexpr int MAX_SMEM = 232448;

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

// butterfly sum: every lane ends with the same bits (each level adds the
// same two partial sums, in either order)
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[v][j] += sum_k w[k][v] * rows[k][lane*NB + j] over kc dimensions;
// rows has a row stride of ldh labels, w a row stride of WV vectors
template <int NB>
__device__ __forceinline__ void accumulate(const __nv_bfloat16* rows, int kc,
                                           int ldh, const float* w,
                                           float (&acc)[WV][NB], int lane) {
  const __nv_bfloat16* p = rows + lane * NB;
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    float c[NB];
    Labels<NB>::load(p + (size_t)k * ldh, c);
    const float4 w0 = *reinterpret_cast<const float4*>(w + k * WV);
    const float4 w1 = *reinterpret_cast<const float4*>(w + k * WV + 4);
    const float wv[WV] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int v = 0; v < WV; ++v)
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[v][j] = fmaf(wv[v], c[j], acc[v][j]);
  }
}

// A warp's 8 vectors in shared memory: x, S ([v][k]), the visit weights
// bf16(S - Cb_i[B_i]) - xb ([k][v]), the current codes ([v][j]), and
// K12's best codes and energies.
struct Warp {
  float *xs, *ss, *wt;
  int *bs, *bb;
  float* eb;
  __device__ Warp(unsigned char* base, int d, int m) {
    xs = reinterpret_cast<float*>(base);
    ss = xs + WV * d;
    wt = ss + WV * d;
    bs = reinterpret_cast<int*>(wt + WV * d);
    bb = bs + WV * m;
    eb = reinterpret_cast<float*>(bb + WV * m);
  }
};

__host__ __device__ inline int warp_bytes(int d, int m) {
  return (3 * WV * d * 4 + 2 * WV * m * 4 + WV * 4 + 15) / 16 * 16;
}

// node visited t-th: order[t], or t in codebook order (order == nullptr)
__device__ __forceinline__ int node(const int* order, int t) {
  return order ? order[t] : t;
}

// Bring the warp's vectors x (rounded to bf16) and codes B0 in; vectors
// at and past n read as zero.
__device__ void load_vectors(const Warp& w, const __nv_bfloat16* X,
                             const int* Bin, int v0, int n, int d, int m,
                             int lane) {
  for (int e = lane; e < WV * d; e += 32) {
    const int v = e / d, k = e - v * d;
    w.xs[e] = v0 + v < n ? bf(X[(size_t)(v0 + v) * d + k]) : 0.f;
  }
  for (int e = lane; e < WV * m; e += 32) {
    const int v = e / m;
    w.bs[e] = v0 + v < n ? Bin[(size_t)v0 * m + e] : 0;
  }
  __syncwarp();
}

// S = sum of Cb_j[B_j] over the nodes in `order` (f32, in that order)
__device__ void rebuild(const Warp& w, const __nv_bfloat16* Cr,
                        const int* order, int H, int d, int m, int lane) {
  for (int e = lane; e < WV * d; e += 32) {
    const int v = e / d, k = e - v * d;
    float s = 0.f;
    for (int t = 0; t < m; ++t) {
      const int j = node(order, t);
      s += bf(Cr[((size_t)j * H + w.bs[v * m + j]) * d + k]);
    }
    w.ss[e] = s;
  }
  __syncwarp();
}

// One ICM visit of node i for the warp's 8 vectors.
template <int NB>
__device__ void visit(const Warp& w, int i, const __nv_bfloat16* Cr,
                      const __nv_bfloat16* Ct, const float* c2, int H, int d,
                      int m, int lane) {
  constexpr int HB = 32 * NB;  // labels per register block
  for (int e = lane; e < WV * d; e += 32) {
    const int v = e / d, k = e - v * d;
    const float g = bf(Cr[((size_t)i * H + w.bs[v * m + i]) * d + k]);
    w.wt[k * WV + v] = round_bf16(w.ss[e] - g) - w.xs[e];
  }
  __syncwarp();
  float best[WV];
  int arg[WV];
#pragma unroll
  for (int v = 0; v < WV; ++v) {
    best[v] = INFINITY;
    arg[v] = INT_MAX;
  }
  for (int b0 = 0; b0 < H; b0 += HB) {
    float acc[WV][NB];
#pragma unroll
    for (int v = 0; v < WV; ++v)
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[v][j] = 0.f;
    accumulate<NB>(Ct + (size_t)i * d * H + b0, d, H, w.wt, acc, lane);
#pragma unroll
    for (int v = 0; v < WV; ++v)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int b = b0 + lane * NB + j;
        argmin_merge(best[v], arg[v], c2[i * H + b] + 2.f * acc[v][j], b);
      }
  }
#pragma unroll
  for (int v = 0; v < WV; ++v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[v], off);
      const int oi = __shfl_xor_sync(0xffffffffu, arg[v], off);
      argmin_merge(best[v], arg[v], ov, oi);
    }
  }
#pragma unroll
  for (int v = 0; v < WV; ++v) {
    const int old = w.bs[v * m + i];
    if (arg[v] != old) {  // S + (g_new - g_old), as the TPU kernel
      const __nv_bfloat16* gn = Cr + ((size_t)i * H + arg[v]) * d;
      const __nv_bfloat16* go = Cr + ((size_t)i * H + old) * d;
      for (int k = lane; k < d; k += 32)
        w.ss[v * d + k] += bf(gn[k]) - bf(go[k]);
    }
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < WV; ++v) w.bs[v * m + i] = arg[v];
  }
  __syncwarp();
}

// Energy of vector v's current codes, summed over the nodes in `order`;
// every lane returns the same value.
__device__ float energy(const Warp& w, int v, const __nv_bfloat16* Cr,
                        const float* c2, const int* order, int H, int d,
                        int m, int lane) {
  float acc = 0.f;
  for (int t = 0; t < m; ++t) {
    const int i = node(order, t);
    const int bi = w.bs[v * m + i];
    const __nv_bfloat16* g = Cr + ((size_t)i * H + bi) * d;
    float xg = 0.f, rg = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float gk = bf(g[k]);
      xg = fmaf(w.xs[v * d + k], gk, xg);
      rg = fmaf(round_bf16(w.ss[v * d + k] - gk), gk, rg);
    }
    xg = warp_sum(xg);
    rg = warp_sum(rg);
    const float u = c2[i * H + bi] - 2.f * xg;
    acc += (u + 2.f * rg) + u;
  }
  return 0.5f * acc;
}

// K11
template <int NB>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    icm_sweeps_kernel(const __nv_bfloat16* __restrict__ X,   // (n, d)
                      const __nv_bfloat16* __restrict__ Cr,  // (m*H, d)
                      const __nv_bfloat16* __restrict__ Ct,  // (m, d, H)
                      const float* __restrict__ c2,          // (m*H)
                      const int* __restrict__ Bin,           // (n, m)
                      const int* __restrict__ order,         // (m)
                      int* __restrict__ Bout, float* __restrict__ E, int n,
                      int d, int m, int H, int icmiter) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Warp w(smem + (size_t)warp * warp_bytes(d, m), d, m);
  const int v0 = (blockIdx.x * (blockDim.x >> 5) + warp) * WV;

  load_vectors(w, X, Bin, v0, n, d, m, lane);
  rebuild(w, Cr, order, H, d, m, lane);
  for (int t = 0; t < icmiter * m; ++t)
    visit<NB>(w, order[t % m], Cr, Ct, c2, H, d, m, lane);

  for (int v = 0; v < WV; ++v) {
    if (v0 + v >= n) break;  // uniform across the warp
    const float e = energy(w, v, Cr, c2, order, H, d, m, lane);
    if (lane == 0) E[v0 + v] = e;
    for (int j = lane; j < m; j += 32)
      Bout[(size_t)(v0 + v) * m + j] = w.bs[v * m + j];
  }
}

__device__ __forceinline__ unsigned hash32(unsigned x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// K12
template <int NB>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    icm_ils_kernel(const __nv_bfloat16* __restrict__ X,   // (n, d)
                   const __nv_bfloat16* __restrict__ Cr,  // (m*H, d)
                   const __nv_bfloat16* __restrict__ Ct,  // (m, d, H)
                   const float* __restrict__ c2,          // (m*H)
                   const int* __restrict__ Bin,           // (n, m)
                   const int* __restrict__ orders,        // (ilsiter, m)
                   int* __restrict__ Bout, float* __restrict__ E, int n,
                   int d, int m, int h, int H, int ilsiter, int icmiter,
                   int npert, unsigned seed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Warp w(smem + (size_t)warp * warp_bytes(d, m), d, m);
  const int v0 = (blockIdx.x * (blockDim.x >> 5) + warp) * WV;

  load_vectors(w, X, Bin, v0, n, d, m, lane);
  for (int e = lane; e < WV * m; e += 32) w.bb[e] = w.bs[e];
  rebuild(w, Cr, nullptr, H, d, m, lane);
  for (int v = 0; v < WV; ++v) {
    const float e = energy(w, v, Cr, c2, nullptr, H, d, m, lane);
    if (lane == 0) w.eb[v] = e;
  }
  __syncwarp();

  for (int r = 0; r < ilsiter; ++r) {
    for (int e = lane; e < WV * m; e += 32) w.bs[e] = w.bb[e];
    __syncwarp();
    if (lane < WV) {  // lane v redraws vector v's positions in order
      const unsigned gid = (unsigned)(v0 + lane);
      const unsigned base = seed + gid * 0x9E3779B9u + (unsigned)r * 0x85EBCA6Bu;
      for (int p = 0; p < npert; ++p) {
        const unsigned ctr = base + (unsigned)p * 0xC2B2AE35u;
        const int pos = (int)(hash32(ctr) % (unsigned)m);
        const int val = (int)(hash32(ctr ^ 0x5BD1E995u) % (unsigned)h);
        w.bs[lane * m + pos] = val;
      }
    }
    __syncwarp();
    rebuild(w, Cr, nullptr, H, d, m, lane);
    const int* ord = orders + (size_t)r * m;
    for (int t = 0; t < icmiter * m; ++t)
      visit<NB>(w, ord[t % m], Cr, Ct, c2, H, d, m, lane);
    for (int v = 0; v < WV; ++v) {
      const float e = energy(w, v, Cr, c2, nullptr, H, d, m, lane);
      if (e < w.eb[v]) {  // the same bits in every lane: a uniform branch
        for (int j = lane; j < m; j += 32) w.bb[v * m + j] = w.bs[v * m + j];
        __syncwarp();
        if (lane == 0) w.eb[v] = e;
      }
      __syncwarp();
    }
  }

  for (int v = 0; v < WV; ++v) {
    if (v0 + v >= n) break;  // uniform across the warp
    if (lane == 0) E[v0 + v] = w.eb[v];
    for (int j = lane; j < m; j += 32)
      Bout[(size_t)(v0 + v) * m + j] = w.bb[v * m + j];
  }
}

// warps per CTA whose state fits in shared memory (0: not even one)
int warps_for(int d, int m) {
  for (int wp = MAX_WARPS; wp > 0; wp >>= 1)
    if ((size_t)wp * warp_bytes(d, m) <= (size_t)MAX_SMEM) return wp;
  return 0;
}

template <class Kern>
int launch_cfg(Kern kern, int n, int d, int m, int& grid, int& threads,
               size_t& smem) {
  const int wp = warps_for(d, m);
  if (!wp) return (int)cudaErrorInvalidValue;
  smem = (size_t)wp * warp_bytes(d, m);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  grid = (n + wp * WV - 1) / (wp * WV);
  threads = wp * 32;
  return 0;
}

template <int NB>
int launch_icm(const void* X, const void* Cr, const void* Ct, const void* c2,
               const void* Bin, const void* order, void* Bout, void* E,
               int n, int d, int m, int H, int icmiter, cudaStream_t stream) {
  auto kern = icm_sweeps_kernel<NB>;
  int grid, threads;
  size_t smem;
  if (int e = launch_cfg(kern, n, d, m, grid, threads, smem)) return e;
  kern<<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)X, (const __nv_bfloat16*)Cr,
      (const __nv_bfloat16*)Ct, (const float*)c2, (const int*)Bin,
      (const int*)order, (int*)Bout, (float*)E, n, d, m, H, icmiter);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_ils(const void* X, const void* Cr, const void* Ct, const void* c2,
               const void* Bin, const void* orders, void* Bout, void* E,
               int n, int d, int m, int h, int H, int ilsiter, int icmiter,
               int npert, int seed, cudaStream_t stream) {
  auto kern = icm_ils_kernel<NB>;
  int grid, threads;
  size_t smem;
  if (int e = launch_cfg(kern, n, d, m, grid, threads, smem)) return e;
  kern<<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)X, (const __nv_bfloat16*)Cr,
      (const __nv_bfloat16*)Ct, (const float*)c2, (const int*)Bin,
      (const int*)orders, (int*)Bout, (float*)E, n, d, m, h, H, ilsiter,
      icmiter, npert, (unsigned)seed);
  return (int)cudaGetLastError();
}

}  // namespace

// H: the padded label count, 32, 64, 128 or a multiple of 256
extern "C" int rq_icm_sweeps(const void* X, const void* Cr, const void* Ct,
                             const void* c2, const void* Bin,
                             const void* order, void* Bout, void* E, int n,
                             int d, int m, int H, int icmiter,
                             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define RQ_ICM(NB) \
  return launch_icm<NB>(X, Cr, Ct, c2, Bin, order, Bout, E, n, d, m, H, icmiter, s)
  switch (H) {
    case 32: RQ_ICM(1);
    case 64: RQ_ICM(2);
    case 128: RQ_ICM(4);
  }
  if (H > 0 && H % 256 == 0) RQ_ICM(8);
#undef RQ_ICM
  return (int)cudaErrorInvalidValue;
}

// h: the true label count (perturbed values are drawn below it)
extern "C" int rq_icm_ils(const void* X, const void* Cr, const void* Ct,
                          const void* c2, const void* Bin, const void* orders,
                          void* Bout, void* E, int n, int d, int m, int h,
                          int H, int ilsiter, int icmiter, int npert,
                          int seed, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define RQ_ILS(NB)                                                          \
  return launch_ils<NB>(X, Cr, Ct, c2, Bin, orders, Bout, E, n, d, m, h, H, \
                        ilsiter, icmiter, npert, seed, s)
  switch (H) {
    case 32: RQ_ILS(1);
    case 64: RQ_ILS(2);
    case 128: RQ_ILS(4);
  }
  if (H > 0 && H % 256 == 0) RQ_ILS(8);
#undef RQ_ILS
  return (int)cudaErrorInvalidValue;
}
