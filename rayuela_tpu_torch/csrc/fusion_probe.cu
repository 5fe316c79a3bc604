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
// stream.
//
// One launch. A persistent grid, as many CTAs as the card holds at once
// (`fusion_layout`: the SMs times the CTAs an SM holds), splits the row
// groups of 8 rows evenly, so no tail wave is left. A thread takes one
// float4 column group and one row class of its CTA's range, BATCH loads
// in flight, and keeps that class's 4 minima in registers; the CTA writes
// its partial (8, 256) block. The minimum across CTAs is taken in the same
// launch, in two levels so that no single CTA reads every block: the last
// CTA of each group of `group` CTAs to finish (a ticket after
// __threadfence) folds its group's blocks into one, and the last of those
// folds the groups' blocks into out, with all its threads and BATCH loads
// in flight each.

#include <cuda_runtime.h>

namespace {

constexpr int COLS = 256;
constexpr int VEC = COLS / 4;       // float4 column groups of a row
constexpr int TPB = 8 * VEC;        // threads a CTA: VEC x 8 row classes
constexpr int BATCH = 8;            // row groups a thread loads at once
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

__device__ __forceinline__ float4 fmin4(const float4& a, const float4& b) {
  return make_float4(fmin_ordered(a.x, b.x), fmin_ordered(a.y, b.y),
                     fmin_ordered(a.z, b.z), fmin_ordered(a.w, b.w));
}

// True in every thread of the CTA that arrives last of `count` at
// `ticket` (which it sets back to 0 for the next launch). Each thread's
// earlier writes are visible device-wide before its CTA takes a ticket.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket,
                                               unsigned count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == count - 1;
    if (last) atomicExch(ticket, 0u);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// dst[t] = min over the count blocks src[i * TPB + t], thread t (blocks
// written by other CTAs: read through L2), BATCH loads in flight.
__device__ __forceinline__ void fold_blocks(const float4* src, int count,
                                            float4* dst) {
  const float inf = __int_as_float(0x7F800000);
  float4 m = make_float4(inf, inf, inf, inf);
  int i = 0;
  for (; i + BATCH <= count; i += BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      v[b] = __ldcg(src + (size_t)(i + b) * TPB + threadIdx.x);
#pragma unroll
    for (int b = 0; b < BATCH; ++b) m = fmin4(m, v[b]);
  }
  for (; i < count; ++i)
    m = fmin4(m, __ldcg(src + (size_t)i * TPB + threadIdx.x));
  dst[threadIdx.x] = m;
}

// grid P = gridDim.x (`fusion_layout`). CTA p: row groups [G p / P,
// G (p + 1) / P) of the G = rows / 8. Thread t: column group t % VEC, row
// class t / VEC. part holds P + ceil(P / group) blocks of (8, 256): the
// CTAs', then the groups'; tickets ceil(P / group) + 1 zeros.
template <int K, bool SPLIT>
__global__ void __launch_bounds__(TPB, 2)
    fusion_chain_kernel(const float4* __restrict__ X, float4* part,
                        float4* __restrict__ out, unsigned* tickets,
                        int rows, int group) {
  const int cg = threadIdx.x % VEC, cls = threadIdx.x / VEC;
  const int P = gridDim.x, p = blockIdx.x;
  const long long G = rows / 8;
  const int g0 = (int)(G * p / P), g1 = (int)(G * (p + 1) / P);
  const float inf = __int_as_float(0x7F800000);
  float m[4] = {inf, inf, inf, inf};
  for (int g = g0; g < g1; g += BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      v[b] = g + b < g1 ? __ldcs(X + ((size_t)(g + b) * 8 + cls) * VEC + cg)
                        : make_float4(inf, inf, inf, inf);
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const float x[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (g + b < g1) m[e] = fmin_ordered(m[e], chain<K, SPLIT>(x[e]));
    }
  }
  part[(size_t)p * TPB + threadIdx.x] = make_float4(m[0], m[1], m[2], m[3]);

  const int ngroups = (P + group - 1) / group, grp = p / group;
  const int first = grp * group, count = min(P, first + group) - first;
  float4* gpart = part + (size_t)P * TPB;
  if (!last_to_arrive(tickets + grp, count)) return;
  fold_blocks(part + (size_t)first * TPB, count, gpart + (size_t)grp * TPB);
  if (!last_to_arrive(tickets + ngroups, ngroups)) return;
  fold_blocks(gpart, ngroups, out);
}

// The persistent grid of (k, split) into out[2]: CTAs (the SMs times the
// CTAs an SM holds) and CTAs a group.
template <int K, bool SPLIT> cudaError_t fusion_layout(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fusion_chain_kernel<K, SPLIT>, TPB, 0)) != cudaSuccess)
    return e;
  out[0] = sms * per_sm;
  int group = 1;
  while (group * group < out[0]) ++group;
  out[1] = group;
  return cudaSuccess;
}

template <int K, bool SPLIT>
cudaError_t launch_chain(const void* X, void* part, void* out, void* tickets,
                         int rows, int nparts, int group, cudaStream_t st) {
  fusion_chain_kernel<K, SPLIT><<<nparts, TPB, 0, st>>>(
      (const float4*)X, (float4*)part, (float4*)out, (unsigned*)tickets,
      rows, group);
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
static int fusion_chain(const void* X, void* part, void* out, void* tickets,
                        int rows, int nparts, int group, int k,
                        cudaStream_t st) {
  RQ_FUSION_K(launch_chain, X, part, out, tickets, rows, nparts, group, st)
  return (int)cudaErrorInvalidValue;
}

template <bool SPLIT> static int fusion_attrs(int k, int* out) {
  RQ_FUSION_K(chain_attrs, out)
  return (int)cudaErrorInvalidValue;
}

template <bool SPLIT> static int fusion_grid(int k, int* out) {
  RQ_FUSION_K(fusion_layout, out)
  return (int)cudaErrorInvalidValue;
}

#undef RQ_FUSION_K

extern "C" {

// X (rows, 256) f32 → out (8, 256) f32 through nparts CTAs in groups of
// `group` (`rq_fusion_layout`); part (nparts + ceil(nparts / group), 8,
// 256) f32 scratch, tickets ceil(nparts / group) + 1 zeroed int32 (left
// zero); k in {0, 1, 2, 4, 8}, split: the one-statement-per-op source form.
int rq_fusion_chain(const void* X, void* part, void* out, void* tickets,
                    int rows, int nparts, int group, int k, int split,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return split ? fusion_chain<true>(X, part, out, tickets, rows, nparts,
                                    group, k, st)
               : fusion_chain<false>(X, part, out, tickets, rows, nparts,
                                     group, k, st);
}

// The persistent grid at (k, split) into out[2]: CTAs and CTAs a group.
int rq_fusion_layout(int k, int split, void* out) {
  return split ? fusion_grid<true>(k, (int*)out)
               : fusion_grid<false>(k, (int*)out);
}

// The chain kernel's registers and local (spill) bytes a thread at
// (k, split) into out[2].
int rq_fusion_attrs(int k, int split, void* out) {
  return split ? fusion_attrs<true>(k, (int*)out)
               : fusion_attrs<false>(k, (int*)out);
}

}  // extern "C"
