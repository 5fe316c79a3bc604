// ICM sweeps for Hopper (sm_90a): K11, and the whole-ILS encode K12.
//
// K11 replaces rayuela_tpu/ops/icm_pallas.py::_kernel (launched at :276
// by icm_sweeps_pallas). Contract, shared with the plain version
// icm_sweeps_plain(op_dtype=bfloat16) in rayuela_tpu_torch/ops/icm.py:
// X and C are rounded to bf16 (xb, Cb), c2 = |C|^2 comes from the f32 C,
// S = sum_j Cb_j[B_j] over the nodes in `order` (f32). Each of the
// icmiter*m visits takes node i = order[t % m] and sets
//   B_i <- argmin_b  (c2_i(b) - 2 xb.Cb_i[b]) + 2 bf16(S - Cb_i[B_i]).Cb_i[b]
// (the plain version's two dot products, f32 sums, ties to the lowest
// b), then S <- S + (Cb_i[new] - Cb_i[old]). The output energy is E =
// 1/2 sum_i [cond_i(B_i) + u_i(B_i)] with u_i(b) = c2_i(b) - 2 xb.Cb_i[b],
// summed over i in `order`; icmiter = 0 only evaluates E. Outputs: codes
// (n, m) int32, E (n,) f32.
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
// What bounds them on the card: the conditional dot products of the
// visits, 2*h*d products per visit and vector for ur = rest.Cb_i[b] and
// as many for ux = xb.Cb_i[b] (recomputed each visit: caching ux would
// take V*m*h*4 bytes of shared memory), bf16 operands with f32 sums, so
// the tensor cores' rate (989 TFLOP/s dense on an H100 SXM): 2*n*icmiter
// *m*h*d operations a call count the ur products once, as the bound in
// PERF.md does. The former body ran them as fmaf on the CUDA cores, 8
// vectors a warp reading Cb_i^T through L1/L2 (7.78 ms per 1e5-vector
// call at d = 128 on an H100, 2.4% of that bound; at d = 960 two warps an
// SM fitted, 32x slower for 7.5x the work). The codebook slab is the
// other cost: Cb_i is h*d*2 bytes per visit (64 KB at h = 256, d = 128;
// 480 KB at d = 960), read from L2 once per CTA of V vectors.
//
// What the design does about it:
// * A CTA of IC_WARPS = 4 warps owns V = 8T vectors (T = 4, 2 or 1, by
//   what fits) and scores a visit of node i as m16n8k16 products
//   (mma.sync, bf16 operands, f32 accumulators): the A operand of m-tile
//   tau stacks 8 vectors' rest rows (rows 0-7) over the same 8 vectors' xb
//   rows (rows 8-15), so one product gives both dots, and the thread that
//   holds ur of a (vector, label) also holds its ux: cond is formed in
//   the thread that owns the pair, from its accumulator fragments. rest
//   = bf16(S - Cb_i[B_i]) is built per visit in shared memory; xb sits
//   there for the whole launch, both with rows zero-padded to whole
//   chunks of 16 dimensions (any d).
// * The labels go in groups of 32, warp w taking groups w, w + 4, ...
//   (four n-tiles each), its thread a running (min, argmin) per m-tile
//   across them (ties to the lower label), then the 4 threads of a row
//   (shuffles) and the 4 warps (shared memory). The wrapper pads h to a
//   multiple of 128 with zero rows whose c2 is +inf: their cond is +inf,
//   so they never win the argmin, and being the highest labels they never
//   win a tie either. K12 draws its perturbed values below the true h,
//   which it takes as an argument of its own.
// * The codebook's B fragments come straight from L1/L2 into registers:
//   the wrapper keeps a copy of Cb in the fragments' order (`IcmOperands
//   .Cf`: per node, 32-label group and 16-dimension chunk, each lane's 32
//   bytes together), so a warp's loads are 1 KB runs, 16 bytes a thread,
//   and the loads of the next IC_KB chunks issue before this IC_KB's
//   products.
//   No shared-memory stage and no barrier stand between a visit's
//   products. A first version staged (128 labels x 64 dimensions) tiles
//   through a 3-stage cp.async ring shared by the CTA: each short tile
//   waited on L2 behind a barrier (trial variants on an H100, not
//   measured by a script in the repo). Each product chunk of 16
//   dimensions starts from a zero accumulator and is added in f32
//   (`mma_bf16` in scan_common.cuh): the tensor cores' own accumulation
//   could drop low bits against a large running sum.
// * Shared memory per CTA (`icm_smem`): xb and rest (bf16), S (f32, rows
//   of d rounded up to 8), the codes (K12: also the best codes and
//   energies) and the argmin exchange. The layout (`icm_layout`) takes
//   the largest T with which two CTAs fit an SM, else one: at m = 8 T = 4
//   to d ~ 430, T = 2 to ~880, T = 1 with two CTAs to ~1780 (GIST's 960),
//   then one CTA (T = 2, then 1) to ~3600; beyond, the wrappers raise.
// * The energy (per vector, a warp over its dimensions), the rebuild of S,
//   the S update and K12's perturbation and accept keep the former
//   kernel's arithmetic, so they give the same bits on the same codes; a
//   thread takes 8 dimensions of a vector at a time in the rebuild and
//   the update (16-byte codebook loads, issued together), and a warp's
//   vectors load their energy's codebook rows together: one visit's
//   update waited on 32 dependent 2-byte loads a thread before, as long
//   as its products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "scan_common.cuh"

namespace {

constexpr int IC_WARPS = 4;                 // warps per CTA
constexpr int IC_THREADS = IC_WARPS * 32;
constexpr int IC_LB = 32 * IC_WARPS;        // the labels' padding
constexpr int IC_KB = 2;   // 16-dim chunks whose fragments load together
constexpr int IC_UB = 4;   // S-update tasks a thread loads together
constexpr int IC_SMEM = 232448;             // opt-in shared memory a CTA

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

__host__ __device__ inline int round_up(int x, int a) {
  return (x + a - 1) / a * a;
}
// bf16 stride of a staged vector row (xb, rest): whole chunks of 16
// dimensions and 16 bytes more, so that the 8 rows an ldmatrix reads fall
// in distinct banks
__host__ __device__ inline int icm_xst(int dp) {
  return round_up(dp, 16) + 8;
}
// Shared bytes of a CTA of T m-tiles (8 T vectors) at width d (dp = d
// padded to a multiple of 8) with m codebooks.
__host__ __device__ inline int icm_smem(int d, int m, int t) {
  const int v = 8 * t, dp = round_up(d, 8);
  return 4 * v * icm_xst(dp) + 4 * v * dp + 8 * v * m + 4 * v +
         8 * IC_WARPS * v + 8 * v;
}

// The layout at (d, m) into out[3]: m-tiles T, the CTAs an SM is meant
// to hold, shared bytes; false where not even one CTA fits.
bool icm_layout(int d, int m, int* out) {
  for (int ctas = 2; ctas >= 1; --ctas) {
    const int cap = ctas == 2 ? (IC_SMEM - 1024) / 2 : IC_SMEM;
    for (int t = 4; t >= 1; t >>= 1)
      if (icm_smem(d, m, t) <= cap) {
        out[0] = t;
        out[1] = ctas;
        out[2] = icm_smem(d, m, t);
        return true;
      }
  }
  return false;
}

// The CTA's vectors in shared memory.
struct State {
  __nv_bfloat16 *xs, *rs;       // V x xst: xb, rest
  float* ss;                    // V x dp: S (zero pads)
  int *bs, *bb;                 // V x m: codes, K12's best codes
  float* eb;                    // V: K12's best energies
  float* redv;                  // IC_WARPS x V: argmin exchange
  int* redi;                    // IC_WARPS x V
  int *newc, *oldc;             // V: the visit's new and old codes
  int v, d, dp, xst, m;
  __device__ State(unsigned char* base, int t, int d_, int m_)
      : v(8 * t), d(d_), dp(round_up(d_, 8)), xst(icm_xst(round_up(d_, 8))),
        m(m_) {
    xs = reinterpret_cast<__nv_bfloat16*>(base);
    rs = xs + v * xst;
    ss = reinterpret_cast<float*>(rs + v * xst);
    bs = reinterpret_cast<int*>(ss + v * dp);
    bb = bs + v * m;
    eb = reinterpret_cast<float*>(bb + v * m);
    redv = eb + v;
    redi = reinterpret_cast<int*>(redv + IC_WARPS * v);
    newc = redi + IC_WARPS * v;
    oldc = newc + v;
  }
};

// The node of visit g of a launch whose rounds take vr visits each in
// the order ord[round, :] (K11: one round, K12: ilsiter)
__device__ __forceinline__ int visit_node(const int* ord, int g, int vr,
                                          int m) {
  return ord[(g / vr) * m + (g % vr) % m];
}

// node visited t-th: order[t], or t in codebook order (order == nullptr)
__device__ __forceinline__ int node(const int* order, int t) {
  return order ? order[t] : t;
}

// Bring the CTA's vectors xb (zero pads) and codes B0 in; vectors at and
// past n read as zero. Zeroes rest's pads too.
__device__ void load_vectors(const State& s, const __nv_bfloat16* X,
                             const int* Bin, int v0, int n) {
  for (int e = threadIdx.x; e < s.v * s.xst; e += IC_THREADS) {
    const int v = e / s.xst, k = e - v * s.xst;
    s.xs[e] = v0 + v < n && k < s.d ? X[(size_t)(v0 + v) * s.d + k]
                                    : __float2bfloat16_rn(0.f);
    s.rs[e] = __float2bfloat16_rn(0.f);
  }
  for (int e = threadIdx.x; e < s.v * s.m; e += IC_THREADS) {
    const int v = e / s.m;
    s.bs[e] = v0 + v < n ? Bin[(size_t)v0 * s.m + e] : 0;
  }
  __syncthreads();
}

// 8 bf16 values of a codebook row (16 bytes), widened to f32
__device__ __forceinline__ void row8(const __nv_bfloat16* p, float (&x)[8]) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), x);
}

// S = sum of Cb_j[B_j] over the nodes in `order` (f32, in that order),
// and rest = bf16(S - Cb_i[B_i]) for the first visit's node i (i < 0:
// none). A thread takes 8 dimensions of a vector at a time, so that its
// codebook loads are 16 bytes and independent of each other.
__device__ void rebuild(const State& s, const __nv_bfloat16* Cr,
                        const int* order, int H, int i) {
  const int c8 = s.dp / 8;
  for (int e = threadIdx.x; e < s.v * c8; e += IC_THREADS) {
    const int v = e / c8, k = 8 * (e - v * c8);
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int t = 0; t < s.m; ++t) {
      const int j = node(order, t);
      float x[8];
      row8(Cr + ((size_t)j * H + s.bs[v * s.m + j]) * s.dp + k, x);
#pragma unroll
      for (int q = 0; q < 8; ++q) a[q] += x[q];
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) s.ss[v * s.dp + k + q] = a[q];
    if (i >= 0) {
      float g[8];
      row8(Cr + ((size_t)i * H + s.bs[v * s.m + i]) * s.dp + k, g);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        s.rs[v * s.xst + k + q] = __float2bfloat16_rn(a[q] - g[q]);
    }
  }
  __syncthreads();
}

// The visits [g0, g1) of a launch whose rounds take vr visits each in
// the order ord (rest holds visit g0's). Cf is the codebook in the B
// fragments' order: per node, 32-label group and 16-dimension chunk, the
// 32 lanes' 32 bytes (4 n-tiles x {b0, b1}). Each visit ends with a
// barrier: its warps score on their own until then.
template <int T>
__device__ void visits(const State& s, const uint4* __restrict__ Cf,
                       const __nv_bfloat16* __restrict__ Cr,
                       const float* __restrict__ c2, const int* ord, int H,
                       int vr, int g0, int g1) {
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int nks = round_up(s.dp, 16) / 16, ngr = H / 32;
  // A rows of m-tile tau: rest of vector 8 tau + (l & 7) for l & 15 < 8,
  // else its xb; columns (l >> 4) * 8 on (`tile_scores`' addressing)
  const __nv_bfloat16* arow[T];
#pragma unroll
  for (int tau = 0; tau < T; ++tau)
    arow[tau] = ((l & 15) < 8 ? s.rs : s.xs) + (8 * tau + (l & 7)) * s.xst +
                (l >> 4) * 8;
  for (int g = g0; g < g1; ++g) {
    const int i = visit_node(ord, g, vr, s.m);
    float best[T];
    int arg[T];
#pragma unroll
    for (int tau = 0; tau < T; ++tau) {
      best[tau] = INFINITY;
      arg[tau] = INT_MAX;
    }
    for (int gr = warp; gr < ngr; gr += IC_WARPS) {
      const uint4* bp = Cf + ((size_t)i * ngr + gr) * nks * 64 + 2 * l;
      float cb[4][2];  // c2 of the thread's labels of the group, ahead
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cb[t][e] = __ldg(c2 + i * H + 32 * gr + 8 * t + 2 * (l & 3) + e);
      float acc[T][4][4];
#pragma unroll
      for (int tau = 0; tau < T; ++tau)
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[tau][t][e] = 0.f;
      // the fragments of chunks k0 .. k0 + IC_KB - 1 in cur, of the next
      // IC_KB in nxt (loading while cur's products run)
      uint4 cur[IC_KB][2] = {}, nxt[IC_KB][2] = {};
#pragma unroll
      for (int q = 0; q < IC_KB; ++q)
        if (q < nks) {
          cur[q][0] = __ldg(bp + 64 * q);
          cur[q][1] = __ldg(bp + 64 * q + 1);
        }
      for (int k0 = 0; k0 < nks; k0 += IC_KB) {
#pragma unroll
        for (int q = 0; q < IC_KB; ++q)
          if (k0 + IC_KB + q < nks) {
            nxt[q][0] = __ldg(bp + 64 * (k0 + IC_KB + q));
            nxt[q][1] = __ldg(bp + 64 * (k0 + IC_KB + q) + 1);
          }
#pragma unroll
        for (int q = 0; q < IC_KB; ++q)
          if (k0 + q < nks) {
            unsigned a[T][4];
#pragma unroll
            for (int tau = 0; tau < T; ++tau)
              ldmatrix_x4(a[tau], arow[tau] + 16 * (k0 + q));
#pragma unroll
            for (int tau = 0; tau < T; ++tau) {
              mma_bf16(acc[tau][0], a[tau], cur[q][0].x, cur[q][0].y);
              mma_bf16(acc[tau][1], a[tau], cur[q][0].z, cur[q][0].w);
              mma_bf16(acc[tau][2], a[tau], cur[q][1].x, cur[q][1].y);
              mma_bf16(acc[tau][3], a[tau], cur[q][1].z, cur[q][1].w);
            }
          }
#pragma unroll
        for (int q = 0; q < IC_KB; ++q) {
          cur[q][0] = nxt[q][0];
          cur[q][1] = nxt[q][1];
        }
      }
      // cond of the group's labels: rows l / 4 (rest) and l / 4 + 8 (xb)
      // of m-tile tau are vector 8 tau + l / 4
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = 32 * gr + 8 * t + 2 * (l & 3) + e;
#pragma unroll
          for (int tau = 0; tau < T; ++tau)
            argmin_merge(best[tau], arg[tau],
                         fmaf(2.f, acc[tau][t][e],
                              fmaf(-2.f, acc[tau][t][e + 2], cb[t][e])),
                         b);
        }
    }
#pragma unroll
    for (int tau = 0; tau < T; ++tau) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[tau], off);
        const int oi = __shfl_xor_sync(0xffffffffu, arg[tau], off);
        argmin_merge(best[tau], arg[tau], ov, oi);
      }
      if ((l & 3) == 0) {
        s.redv[warp * s.v + 8 * tau + (l >> 2)] = best[tau];
        s.redi[warp * s.v + 8 * tau + (l >> 2)] = arg[tau];
      }
    }
    __syncthreads();
    if (threadIdx.x < s.v) {
      const int v = threadIdx.x;
      float bv = s.redv[v];
      int bi = s.redi[v];
      for (int w = 1; w < IC_WARPS; ++w)
        argmin_merge(bv, bi, s.redv[w * s.v + v], s.redi[w * s.v + v]);
      s.oldc[v] = s.bs[v * s.m + i];
      s.newc[v] = bi;
      s.bs[v * s.m + i] = bi;
    }
    __syncthreads();
    // S + (g_new - g_old), as the TPU kernel; then the next visit's rest;
    // a task is 8 dimensions of a vector (16-byte loads), and a thread
    // issues the loads of IC_UB tasks before it uses any
    const int i2 = g + 1 < g1 ? visit_node(ord, g + 1, vr, s.m) : -1;
    const int c8 = s.dp / 8, tasks = s.v * c8;
    for (int e0 = threadIdx.x; e0 < tasks; e0 += IC_UB * IC_THREADS) {
      uint4 un[IC_UB], uo[IC_UB], ux[IC_UB];
#pragma unroll
      for (int j = 0; j < IC_UB; ++j) {
        const int e = e0 + j * IC_THREADS;
        if (e < tasks) {
          const int v = e / c8, k = 8 * (e - v * c8);
          const int nw = s.newc[v], od = s.oldc[v];
          if (nw != od) {
            un[j] = __ldg(reinterpret_cast<const uint4*>(
                Cr + ((size_t)i * H + nw) * s.dp + k));
            uo[j] = __ldg(reinterpret_cast<const uint4*>(
                Cr + ((size_t)i * H + od) * s.dp + k));
          }
          if (i2 >= 0)
            ux[j] = __ldg(reinterpret_cast<const uint4*>(
                Cr + ((size_t)i2 * H + s.bs[v * s.m + i2]) * s.dp + k));
        }
      }
#pragma unroll
      for (int j = 0; j < IC_UB; ++j) {
        const int e = e0 + j * IC_THREADS;
        if (e >= tasks) break;
        const int v = e / c8, k = 8 * (e - v * c8);
        float* sv = s.ss + v * s.dp + k;
        float a[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) a[q] = sv[q];
        if (s.newc[v] != s.oldc[v]) {
          float gn[8], go[8];
          unpack16(un[j], gn);
          unpack16(uo[j], go);
#pragma unroll
          for (int q = 0; q < 8; ++q) sv[q] = a[q] += gn[q] - go[q];
        }
        if (i2 >= 0) {
          float gx[8];
          unpack16(ux[j], gx);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            s.rs[v * s.xst + k + q] = __float2bfloat16_rn(a[q] - gx[q]);
        }
      }
    }
    __syncthreads();  // S and the next rest, before any warp reads them
  }
}

// Energies of the warp's vectors v = warp + IC_WARPS j (j < 2 T) from
// their current codes, summed over the nodes in `order`, to e[j]: the
// same value in every lane. Each vector's sums are the former kernel's
// (a lane's fmaf chains over its dimensions lane, lane + 32, ... in
// ascending order, then a butterfly sum), but the 2 T vectors' codebook
// loads of a dimension issue together.
template <int T>
__device__ void energies(const State& s, const __nv_bfloat16* Cr,
                         const float* c2, const int* order, int H,
                         float (&e)[2 * T]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 2 * T; ++j) e[j] = 0.f;
  for (int t = 0; t < s.m; ++t) {
    const int i = node(order, t);
    int bi[2 * T];
    float xg[2 * T], rg[2 * T];
#pragma unroll
    for (int j = 0; j < 2 * T; ++j) {
      bi[j] = s.bs[(warp + IC_WARPS * j) * s.m + i];
      xg[j] = rg[j] = 0.f;
    }
    for (int k = lane; k < s.d; k += 32) {
      float gk[2 * T];
#pragma unroll
      for (int j = 0; j < 2 * T; ++j)
        gk[j] = bf(Cr[((size_t)i * H + bi[j]) * s.dp + k]);
#pragma unroll
      for (int j = 0; j < 2 * T; ++j) {
        const int v = warp + IC_WARPS * j;
        xg[j] = fmaf(bf(s.xs[v * s.xst + k]), gk[j], xg[j]);
        rg[j] = fmaf(round_bf16(s.ss[v * s.dp + k] - gk[j]), gk[j], rg[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * T; ++j) {
      const float u = c2[i * H + bi[j]] - 2.f * warp_sum(xg[j]);
      e[j] += (u + 2.f * warp_sum(rg[j])) + u;
    }
  }
#pragma unroll
  for (int j = 0; j < 2 * T; ++j) e[j] *= 0.5f;
}

// K11
template <int T>
__global__ void __launch_bounds__(IC_THREADS)
    icm_sweeps_kernel(const __nv_bfloat16* __restrict__ X,   // (n, d)
                      const __nv_bfloat16* __restrict__ Cr,  // (m*H, dp)
                      const uint4* __restrict__ Cf,          // fragments
                      const float* __restrict__ c2,          // (m*H)
                      const int* __restrict__ Bin,           // (n, m)
                      const int* __restrict__ order,         // (m)
                      int* __restrict__ Bout, float* __restrict__ E, int n,
                      int d, int m, int H, int icmiter) {
  extern __shared__ __align__(16) unsigned char icm_smem_raw[];
  const State s(icm_smem_raw, T, d, m);
  const int v0 = blockIdx.x * s.v, warp = threadIdx.x >> 5;
  load_vectors(s, X, Bin, v0, n);
  rebuild(s, Cr, order, H, icmiter ? order[0] : -1);
  visits<T>(s, Cf, Cr, c2, order, H, icmiter * m, 0, icmiter * m);

  float en[2 * T];
  energies<T>(s, Cr, c2, order, H, en);
#pragma unroll
  for (int j = 0; j < 2 * T; ++j) {
    const int v = warp + IC_WARPS * j;
    if ((threadIdx.x & 31) == 0 && v0 + v < n) E[v0 + v] = en[j];
  }
  for (int e = threadIdx.x; e < s.v * m; e += IC_THREADS)
    if (v0 + e / m < n) Bout[(size_t)v0 * m + e] = s.bs[e];
}

__device__ __forceinline__ unsigned hash32(unsigned x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// K12
template <int T>
__global__ void __launch_bounds__(IC_THREADS)
    icm_ils_kernel(const __nv_bfloat16* __restrict__ X,   // (n, d)
                   const __nv_bfloat16* __restrict__ Cr,  // (m*H, dp)
                   const uint4* __restrict__ Cf,          // fragments
                   const float* __restrict__ c2,          // (m*H)
                   const int* __restrict__ Bin,           // (n, m)
                   const int* __restrict__ orders,        // (ilsiter, m)
                   int* __restrict__ Bout, float* __restrict__ E, int n,
                   int d, int m, int h, int H, int ilsiter, int icmiter,
                   int npert, unsigned seed) {
  extern __shared__ __align__(16) unsigned char icm_smem_raw[];
  const State s(icm_smem_raw, T, d, m);
  const int v0 = blockIdx.x * s.v, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, vr = icmiter * m;
  load_vectors(s, X, Bin, v0, n);
  for (int e = threadIdx.x; e < s.v * m; e += IC_THREADS) s.bb[e] = s.bs[e];
  rebuild(s, Cr, nullptr, H, -1);
  float en[2 * T];
  energies<T>(s, Cr, c2, nullptr, H, en);
#pragma unroll
  for (int j = 0; j < 2 * T; ++j)
    if (lane == 0) s.eb[warp + IC_WARPS * j] = en[j];
  __syncthreads();

  for (int r = 0; r < ilsiter; ++r) {
    for (int e = threadIdx.x; e < s.v * m; e += IC_THREADS) s.bs[e] = s.bb[e];
    __syncthreads();
    if (threadIdx.x < s.v) {  // thread v redraws vector v's positions in order
      const int v = threadIdx.x;
      const unsigned gid = (unsigned)(v0 + v);
      const unsigned base = seed + gid * 0x9E3779B9u + (unsigned)r * 0x85EBCA6Bu;
      for (int p = 0; p < npert; ++p) {
        const unsigned ctr = base + (unsigned)p * 0xC2B2AE35u;
        const int pos = (int)(hash32(ctr) % (unsigned)m);
        const int val = (int)(hash32(ctr ^ 0x5BD1E995u) % (unsigned)h);
        s.bs[v * m + pos] = val;
      }
    }
    __syncthreads();
    rebuild(s, Cr, nullptr, H, vr ? orders[(size_t)r * m] : -1);
    visits<T>(s, Cf, Cr, c2, orders, H, vr, r * vr, (r + 1) * vr);
    energies<T>(s, Cr, c2, nullptr, H, en);
#pragma unroll
    for (int j = 0; j < 2 * T; ++j) {
      const int v = warp + IC_WARPS * j;
      // the same in every lane; each lane reads eb[v] before lane 0
      // writes it
      const bool better = en[j] < s.eb[v];
      __syncwarp();
      if (better) {
        for (int q = lane; q < m; q += 32) s.bb[v * m + q] = s.bs[v * m + q];
        if (lane == 0) s.eb[v] = en[j];
      }
    }
    __syncthreads();
  }

  for (int v = threadIdx.x; v < s.v; v += IC_THREADS)
    if (v0 + v < n) E[v0 + v] = s.eb[v];
  for (int e = threadIdx.x; e < s.v * m; e += IC_THREADS)
    if (v0 + e / m < n) Bout[(size_t)v0 * m + e] = s.bb[e];
}

// The compiled instance for T m-tiles (nullptr: none).
template <class K>
K pick(int t, K k1, K k2, K k4) {
  return t == 1 ? k1 : t == 2 ? k2 : t == 4 ? k4 : nullptr;
}

template <class K, typename... A>
int launch_icm(K kern, int n, const int* lay, cudaStream_t st, A... args) {
  if (!kern) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay[2]);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + 8 * lay[0] - 1) / (8 * lay[0]);
  kern<<<grid, IC_THREADS, lay[2], st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// H: the padded label count, a multiple of 128; Cr's rows are dp = d
// rounded up to a multiple of 8 wide (zero pads), X's d; Cf the same
// codebook in the B fragments' order (`visits`; ops.icm.IcmOperands).
extern "C" int rq_icm_sweeps(const void* X, const void* Cr, const void* Cf,
                             const void* c2, const void* Bin,
                             const void* order, void* Bout, void* E, int n,
                             int d, int m, int H, int icmiter, void* stream) {
  if (n <= 0) return 0;
  int lay[3];
  if (H <= 0 || H % IC_LB || !icm_layout(d, m, lay))
    return (int)cudaErrorInvalidValue;
  auto kern = pick(lay[0], icm_sweeps_kernel<1>, icm_sweeps_kernel<2>,
                   icm_sweeps_kernel<4>);
  return launch_icm(kern, n, lay, (cudaStream_t)stream,
                    (const __nv_bfloat16*)X, (const __nv_bfloat16*)Cr,
                    (const uint4*)Cf, (const float*)c2, (const int*)Bin,
                    (const int*)order, (int*)Bout, (float*)E, n, d, m, H,
                    icmiter);
}

// h: the true label count (perturbed values are drawn below it)
extern "C" int rq_icm_ils(const void* X, const void* Cr, const void* Cf,
                          const void* c2, const void* Bin, const void* orders,
                          void* Bout, void* E, int n, int d, int m, int h,
                          int H, int ilsiter, int icmiter, int npert,
                          int seed, void* stream) {
  if (n <= 0) return 0;
  int lay[3];
  if (H <= 0 || H % IC_LB || !icm_layout(d, m, lay))
    return (int)cudaErrorInvalidValue;
  auto kern = pick(lay[0], icm_ils_kernel<1>, icm_ils_kernel<2>,
                   icm_ils_kernel<4>);
  return launch_icm(kern, n, lay, (cudaStream_t)stream,
                    (const __nv_bfloat16*)X, (const __nv_bfloat16*)Cr,
                    (const uint4*)Cf, (const float*)c2, (const int*)Bin,
                    (const int*)orders, (int*)Bout, (float*)E, n, d, m, h, H,
                    ilsiter, icmiter, npert, (unsigned)seed);
}

// The layout of K11 and K12 at (d, m) into out[4] (ops.icm._icm_layout
// mirrors the first three): vectors per CTA, the CTAs an SM is meant to
// hold, shared bytes per CTA, and the CTAs an SM holds at once (of K12's
// instance; K11's takes the same shared memory).
extern "C" int rq_icm_layout(int d, int m, void* out) {
  int* o = (int*)out;
  int lay[3];
  if (!icm_layout(d, m, lay)) return (int)cudaErrorInvalidValue;
  o[0] = 8 * lay[0];
  o[1] = lay[1];
  o[2] = lay[2];
  auto kern = pick(lay[0], icm_ils_kernel<1>, icm_ils_kernel<2>,
                   icm_ils_kernel<4>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay[2]);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[3], kern, IC_THREADS, lay[2]);
}
