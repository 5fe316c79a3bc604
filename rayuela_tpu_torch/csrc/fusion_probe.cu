// The fusion probe for Hopper (sm_90a): k chained elementwise ops over a
// streamed f32 matrix, kept alive by a running minimum.
//
// Replaces demos/bench_mosaic_fusion.py::_kernel_chain (launched at :75),
// the probe that asked whether Mosaic gives each chained elementwise op a
// pass over the block. Its function, here and in the plain version
// (rayuela_tpu_torch/demos/fusion_probe.py): X (rows, 256) f32, rows a
// multiple of 8; y = X, then k times y = y * 1.0000001 + 0.5, each
// product and each sum rounded to f32 (no fused multiply-add: nvcc would
// contract `a * b + c` into one, and the plain version rounds twice, so
// the chain is written with __fmul_rn / __fadd_rn); out (8, 256),
// out[i, c] = min over the rows r = i (mod 8) of y[r, c]. A minimum does
// not depend on the order it is taken in, so the kernel equals the plain
// version bit for bit.
//
// The chain comes in two source forms, as in the TPU probe: SPLIT, one
// statement per op in a loop, and one nested expression
// (`Chain<K>::apply`). Both are the same dataflow; the probe reads their
// registers (`rq_fusion_attrs`) and times.
//
// What bounds it on the card: reading X once, 1 GiB at the probe's size
// (0.32 ms at 3.35 TB/s). The chain is 2k f32 ops an element, which at
// k = 8 is 4.3e9 ops, a fifth of the stream's time at the CUDA cores'
// issue rate: an extra op should cost nothing until the ops outrun the
// stream. CTA p takes one contiguous range of rows (a multiple of 8), a
// thread one float4 column group and every fourth row of the range, 8
// loads in flight, and keeps the minima of its 2 row classes x 4
// columns in registers; a second kernel takes the minimum over the CTAs'
// partial (8, 256) blocks.

#include <cuda_runtime.h>

namespace {

constexpr int COLS = 256;
constexpr int VEC = COLS / 4;       // float4 column groups of a row
constexpr int TPB = 256;            // threads a CTA: VEC x 4 row phases
constexpr int BATCH = 4;            // row pairs a thread loads at once
constexpr float MUL = 1.0000001f, ADD = 0.5f;

template <int K> struct Chain {
  static __device__ __forceinline__ float apply(float y) {
    return __fadd_rn(__fmul_rn(Chain<K - 1>::apply(y), MUL), ADD);
  }
};
template <> struct Chain<0> {
  static __device__ __forceinline__ float apply(float y) { return y; }
};

template <int K, bool SPLIT>
__device__ __forceinline__ float chain(float y) {
  if constexpr (SPLIT) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      y = __fmul_rn(y, MUL);
      y = __fadd_rn(y, ADD);
    }
    return y;
  } else {
    return Chain<K>::apply(y);
  }
}

__device__ __forceinline__ float fmin_ordered(float a, float b) {
  return b < a ? b : a;
}

// CTA p: rows [p * rpc, min(rows, (p + 1) * rpc)), rpc a multiple of 8.
// Thread t: column group t % VEC, rows rp + 4 j of the range (rp = t /
// VEC): row class rp for even j, rp + 4 for odd j.
template <int K, bool SPLIT>
__global__ void __launch_bounds__(TPB)
    fusion_chain_kernel(const float4* __restrict__ X, float4* __restrict__ part,
                        int rows, int rpc) {
  const int cg = threadIdx.x % VEC, rp = threadIdx.x / VEC;
  const int r0 = blockIdx.x * rpc, r1 = min(rows, r0 + rpc);
  const float inf = __int_as_float(0x7F800000);
  float m[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[a][e] = inf;
  for (int r = r0 + rp; r < r1; r += 8 * BATCH) {
    float4 v[BATCH][2];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int row = r + 8 * b + 4 * a;
        v[b][a] = row < r1 ? __ldg(X + (size_t)row * VEC + cg)
                           : make_float4(inf, inf, inf, inf);
      }
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const bool live = r + 8 * b + 4 * a < r1;
        const float x[4] = {v[b][a].x, v[b][a].y, v[b][a].z, v[b][a].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (live) m[a][e] = fmin_ordered(m[a][e], chain<K, SPLIT>(x[e]));
      }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
    part[((size_t)blockIdx.x * 8 + rp + 4 * a) * VEC + cg] =
        make_float4(m[a][0], m[a][1], m[a][2], m[a][3]);
}

// out[i] = min over the nparts partial blocks of part[p * 8 * COLS + i].
__global__ void __launch_bounds__(TPB)
    fusion_min_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int nparts) {
  const int i = blockIdx.x * TPB + threadIdx.x;
  float m = __int_as_float(0x7F800000);
  for (int p = 0; p < nparts; ++p)
    m = fmin_ordered(m, part[(size_t)p * 8 * COLS + i]);
  out[i] = m;
}

template <int K, bool SPLIT>
cudaError_t launch_chain(const void* X, void* part, void* out, int rows,
                         int nparts, cudaStream_t st) {
  const int rpc = ((rows / 8 + nparts - 1) / nparts) * 8;
  fusion_chain_kernel<K, SPLIT><<<nparts, TPB, 0, st>>>(
      (const float4*)X, (float4*)part, rows, rpc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fusion_min_kernel<<<8 * COLS / TPB, TPB, 0, st>>>((const float*)part,
                                                    (float*)out, nparts);
  return cudaGetLastError();
}

template <int K, bool SPLIT> cudaError_t chain_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fusion_chain_kernel<K, SPLIT>);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return e;
}

}  // namespace

#define RQ_FUSION_K(F, ...)                                   \
  switch (k) {                                                \
    case 0: return (int)F<0, SPLIT>(__VA_ARGS__);             \
    case 1: return (int)F<1, SPLIT>(__VA_ARGS__);             \
    case 2: return (int)F<2, SPLIT>(__VA_ARGS__);             \
    case 4: return (int)F<4, SPLIT>(__VA_ARGS__);             \
    case 8: return (int)F<8, SPLIT>(__VA_ARGS__);             \
  }

template <bool SPLIT>
static int fusion_chain(const void* X, void* part, void* out, int rows,
                        int nparts, int k, cudaStream_t st) {
  RQ_FUSION_K(launch_chain, X, part, out, rows, nparts, st)
  return (int)cudaErrorInvalidValue;
}

template <bool SPLIT> static int fusion_attrs(int k, int* out) {
  RQ_FUSION_K(chain_attrs, out)
  return (int)cudaErrorInvalidValue;
}

#undef RQ_FUSION_K

extern "C" {

// X (rows, 256) f32 → out (8, 256) f32 through nparts CTAs, whose
// partial minima go to part (nparts, 8, 256) f32; k in {0, 1, 2, 4, 8},
// split: the one-statement-per-op source form.
int rq_fusion_chain(const void* X, void* part, void* out, int rows,
                    int nparts, int k, int split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return split ? fusion_chain<true>(X, part, out, rows, nparts, k, st)
               : fusion_chain<false>(X, part, out, rows, nparts, k, st);
}

// The chain kernel's registers and local (spill) bytes a thread at
// (k, split) into out[2].
int rq_fusion_attrs(int k, int split, void* out) {
  return split ? fusion_attrs<true>(k, (int*)out)
               : fusion_attrs<false>(k, (int*)out);
}

}  // extern "C"
