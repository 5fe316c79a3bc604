// Viterbi (min-sum) chain encoding for Hopper (sm_90a): K13.
//
// Replaces rayuela_tpu/ops/viterbi_pallas.py::_viterbi_kernel (called by
// viterbi_encode_pallas). Contract, shared with the plain version
// viterbi_encode_plain in rayuela_tpu_torch/ops/viterbi.py: given X
// (n, d) f32 and the codebooks C (m, h, d) f32, c2 = |C|^2 (m*h) f32 and
// the chain binaries bin (m-1, h, h) f32, bin_i(a, b) = 2 C_i[a].C_{i+1}[b],
// the unaries are u_i(b) = c2_i(b) - 2 C_i[b].x in f32 (computed here, as
// in the TPU kernel), the forward pass is f_0 = u_0, f_{i+1}(b) =
// u_{i+1}(b) + min_a [f_i(a) + bin_i(a, b)], the code of the last stage
// is the lowest b attaining min f_{m-1}, and each earlier code the lowest
// a attaining min_a f_i(a) + bin_i(a, b_{i+1}), recomputed from the
// stored f_i (no argmin table, as in the TPU kernel). Output: codes
// (n, m) int32. Each candidate f_i(a) + bin_i(a, b) is one rounded add
// and the min picks one of them, so f_{i+1} is the same for any order of
// a; only the unaries' dot products sum in another order than the plain
// version's matmul. On data whose dots are exact (small integers) the
// codes are identical.
//
// What bounds it on the card: the min-plus, (m-1) h^2 add-min pairs per
// vector (393k at m=7, h=256), two instructions each (FADD, FMNMX), and
// FMNMX runs at half rate: 60.5 pairs a cycle an SM in a microbenchmark
// of independent chains, 0.414 ms a stage per 1e5 vectors at h=256
// (rayuela_tpu_torch/demos/probe_minplus.py). Beside
// it the m h d unary multiply-adds (229k at d=128) and the L2 reads of
// bin_i (h^2 f32, 256 KB a stage) and of C_i (h d f32) by every CTA. The
// former kernel (8 vectors and one label a thread per CTA, tiles copied
// between two CTA barriers, unaries on the CUDA cores) took 20.16 /
// 84.77 / 83.90 / 245.38 ms per 1e5 vectors at (m, d) = (7, 128) /
// (15, 128) / (7, 960) / (15, 960), h=256; this one 6.27 / 14.27 / 14.14
// / 30.85 (NVIDIA H100 80GB HBM3 at 700 W, CUDA events, the same call).
// Its min-plus runs at 0.910 ms a stage (the same probe), 46% of FMNMX's
// rate; the ring's copies hide under it (with the copies of bin_i
// dropped it took the same time). Against the unaries at the 3xTF32 rate
// plus the adds and mins at the f32 peak (1.452 / 3.335 / 3.259 / 7.208
// ms at those shapes) it runs at 23%; against the unaries plus the
// min-plus at the FMNMX rate (2.629 / 6.081 / 4.436 / 9.954) at 42% at
// d=128 and 31-32% at d=960.
//
// What the design does about it:
// * The min-plus is a register-tiled tropical product: a consumer thread
//   keeps 4 labels x 8 vectors of running minima (32 chains) and per row
//   a reads one 16-byte slice of bin_i's row and two 16-byte broadcast
//   slices of f_i: 3 shared loads for 64 ALU instructions. Where the
//   CTA's (vectors x labels) tile has fewer than 256 such slices (h <
//   256 at 32 vectors) G lanes of one warp share a slice and split its
//   rows, their minima folded by shuffles (min is exact in any order).
// * A ring of S slots of 8 KB in shared memory, filled by bulk copies
//   (cp.async.bulk, completion on an mbarrier per slot) by a producer
//   warp that runs ahead across stages and blocks of vectors: the
//   codebook tiles of the unaries and the row tiles of bin_i go through
//   it in the order the 8 consumer warps take them, and a slot is
//   refilled when all 8 have released it. No CTA barrier stands between
//   a copy and its use; the consumers meet twice a stage (the unaries
//   written, the forward costs complete). A consumer fences its shared
//   reads (fence.proxy.async) before it releases a slot or the vectors'
//   buffer: without it a refill overtook the last reads of X and the
//   codes of a block's first vectors changed from launch to launch.
// * 32 vectors a CTA (16 at h <= 512, 8 at h <= 1024): the CTA reads
//   bin_i once per 32 vectors, 8 KB per vector and stage at h=256 (32
//   before), and C_i once per 32 vectors. Only f_i and f_{i+1} stay in
//   shared memory (ping-pong); every f_i is also written to a per-CTA
//   scratch in device memory (grid x m x h x V f32, read back by the
//   backtrace, L2-resident for the most part), so the shared memory does
//   not grow with m and the grid is persistent: a CTA walks blocks of
//   vectors, and the producer prefetches the next block (its vectors and
//   first codebook tiles) under the current block's last stage and
//   backtrace. 64 vectors a CTA (16 consumer warps, one CTA an SM) was
//   no faster.
// * The unaries on the tensor cores: per codebook the (labels x d) block
//   of C_i times the CTA's (d x vectors) block of X by mma.sync m16n8k8
//   TF32 with the 3xTF32 split (hi*hi + hi*lo + lo*hi, f32 accumulation),
//   since the TPU kernel asks HIGHEST precision; on small integers every
//   product and sum is exact. The codebook arrives in tiles of 128 labels
//   x 16 dimensions already in A-fragment order (the wrapper's `Cf`), a
//   warp 16 labels of a tile, one 16-byte load per k-step; X is staged
//   per block by one bulk copy per vector row. No (n, m h) unary tensor
//   goes through device memory.
// * The layout (`vt_layout`, reported by rq_viterbi_layout): the most
//   vectors a CTA with at most 8192 (vectors x labels), then two CTAs an
//   SM where they fit, then the deepest ring (4, 3, 2 slots). Its
//   smallest instance takes less shared memory than the former kernel,
//   so it takes every shape the former kernel took.
// * The backtrace: a warp per V/8 vectors of the block, their argmins
//   recomputed together from the scratch's f_i and the column
//   bin_i[:, b] read as a row of the transposed binaries binT, coalesced.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int VT_CWARPS = 8;                  // consumer warps
constexpr int VT_CONS = 32 * VT_CWARPS;       // consumer threads
constexpr int VT_THREADS = VT_CONS + 32;      // and the producer warp
constexpr int VT_LB = 16 * VT_CWARPS;         // labels of a codebook tile
constexpr int VT_KC = 16;                     // dimensions of a codebook tile
constexpr int VT_TILE = 4 * VT_LB * VT_KC;    // bytes of a ring slot (8192)
constexpr int VT_SLICES = 8192;               // vectors x labels a CTA at most
constexpr int VT_SMEM = 232448;               // opt-in shared memory a CTA

__host__ __device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// shared bytes of a CTA of V vectors and S ring slots: the ring, f_i and
// f_{i+1} ([a][v], one buffer at m = 1), the vectors (rows of dp + 4),
// the mbarriers
size_t vt_smem(int V, int S, int m, int h, int d) {
  return (size_t)S * VT_TILE + 4ull * (m > 1 ? 2 : 1) * V * h +
         4ull * V * (round_up(d, VT_KC) + 4) + 8ull * (2 * S + 2);
}

// out: vectors a CTA, ring slots, CTAs an SM is meant to hold, bytes
bool vt_layout(int m, int h, int d, int* out) {
  if (h < 1 || h > 1024 || m < 1 || d < 1) return false;
  const int hp = round_up(h, 4);
  for (int V = 32; V >= 8; V >>= 1) {
    if (V * hp > VT_SLICES) continue;
    for (int ctas = 2; ctas >= 1; --ctas) {
      const size_t cap = ctas == 2 ? (VT_SMEM - 1024) / 2 : VT_SMEM;
      for (int S = 4; S >= 2; --S)
        if (vt_smem(V, S, m, h, d) <= cap) {
          out[0] = V;
          out[1] = S;
          out[2] = ctas;
          out[3] = (int)vt_smem(V, S, m, h, d);
          return true;
        }
    }
  }
  return false;
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device
// to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// order this thread's shared-memory reads before the bulk copies (the
// async proxy) that a later arrival lets overwrite them
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the consumer warps' barrier (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(VT_CONS) : "memory");
}

// TF32 rounding to nearest, ties away from zero (cvt.rna for finite x):
// half an ulp of TF32 added to the magnitude's bits, the low 13 bits
// dropped. Two integer instructions, where cvt.rna takes four (it guards
// inf and NaN).
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 values (lo rounded as well: mma's .tf32
// operands are TF32 values)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(x));
  lo = rna_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// keep (v, i) the smaller value, the lower index on ties; i == INT_MAX
// marks "no candidate yet"
__device__ __forceinline__ void argmin_merge(float& v, int& i, float ov,
                                             int oi) {
  if (oi != INT_MAX && (i == INT_MAX || ov < v || (ov == v && oi < i))) {
    v = ov;
    i = oi;
  }
}

// one row a of the tropical product: mn[l][v] = min(mn, f(v) + bin(l))
__device__ __forceinline__ void minplus_row(float (&mn)[4][8],
                                            const float4& bv,
                                            const float4& f0,
                                            const float4& f1) {
  const float b[4] = {bv.x, bv.y, bv.z, bv.w};
  const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int v = 0; v < 8; ++v) mn[l][v] = fminf(mn[l][v], f[v] + b[l]);
}

// A CTA: the producer warp (the last) fills the ring; 8 consumer warps
// take, per block of V vectors and per codebook j: the unaries u_j
// (tensor cores, all label blocks in registers), then, for j > 0, the
// min-plus over bin_{j-1} into f_j = u_j + min; then the backtrace.
template <int V>
__global__ void __launch_bounds__(VT_THREADS, 2)
    viterbi_kernel(const float* __restrict__ X, int ldx,
                   const float* __restrict__ Cf,
                   const float* __restrict__ c2,
                   const float* __restrict__ bin,
                   const float* __restrict__ binT, float* __restrict__ scr,
                   int* __restrict__ out, int n, int m, int h, int d, int S) {
  constexpr int NVG = V / 8;                 // n-tiles (8 vectors each)
  constexpr int NLB = VT_SLICES / V / VT_LB; // label blocks at most
  constexpr int VW = V / VT_CWARPS;          // vectors a warp backtraces
  extern __shared__ __align__(128) unsigned char smem[];
  const int hp = round_up(h, 4);
  const int dp = round_up(d, VT_KC), dps = dp + 4;
  const int nlb = (h + VT_LB - 1) / VT_LB, nkc = dp / VT_KC;
  const int ta = VT_TILE / (4 * hp);         // bin rows a tile
  unsigned char* ring = smem;
  float* fb = reinterpret_cast<float*>(smem + (size_t)S * VT_TILE);
  float* xs = fb + (size_t)(m > 1 ? 2 : 1) * h * V;      // (V, dps)
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + (size_t)V * dps);
  uint64_t* empty = full + S;
  uint64_t* xfull = empty + S;
  uint64_t* xempty = xfull + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nblk = (n + V - 1) / V;

  // zero pads: the dimensions past ldx and, before the first copy, rows
  // past n (they stay finite)
  for (int i = tid; i < V * dps; i += blockDim.x) xs[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], VT_CWARPS);
    }
    mbar_init(xfull, 1);
    mbar_init(xempty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (warp == VT_CWARPS) {  // the producer
    if (lane == 0) {
      int slot = 0;
      unsigned ph = 0;
      auto put = [&](const float* src, unsigned bytes) {
        mbar_wait(&empty[slot], ph ^ 1);
        mbar_expect_tx(&full[slot], bytes);
        bulk_copy(ring + (size_t)slot * VT_TILE, src, bytes, &full[slot]);
        if (++slot == S) {
          slot = 0;
          ph ^= 1;
        }
      };
      unsigned it = 0;
      for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x, ++it) {
        const int rows = min(V, n - blk * V);
        mbar_wait(xempty, (it & 1) ^ 1);
        mbar_expect_tx(xfull, (unsigned)rows * ldx * 4);
        for (int v = 0; v < rows; ++v)
          bulk_copy(xs + (size_t)v * dps, X + (size_t)(blk * V + v) * ldx,
                    (unsigned)ldx * 4, xfull);
        for (int j = 0; j < m; ++j) {
          const float* cj = Cf + (size_t)j * nlb * nkc * (VT_TILE / 4);
          for (int t = 0; t < nlb * nkc; ++t)
            put(cj + (size_t)t * (VT_TILE / 4), VT_TILE);
          if (j > 0) {
            const float* bj = bin + (size_t)(j - 1) * h * hp;
            for (int a0 = 0; a0 < h; a0 += ta)
              put(bj + (size_t)a0 * hp, (unsigned)(min(ta, h - a0) * hp * 4));
          }
        }
      }
    }
    return;
  }

  const int g = lane >> 2, q = lane & 3;
  // this thread's slice of the tropical product: labels 4 lg .. 4 lg + 3,
  // vectors 8 vg .. 8 vg + 7, rows gi, gi + G, ... of each tile
  const int nlg = hp / 4, ntl = nlg * NVG;
  int G = 1;
  while (G < 32 && 2 * G * ntl <= VT_CONS) G <<= 1;
  const int sl = tid / G, gi = tid % G;
  const bool mp = sl < ntl;
  const int lg = sl % nlg, vg = sl / nlg;
  float* sc = scr + (size_t)blockIdx.x * m * h * V;  // [j][a][v]
  int slot = 0;
  unsigned ph = 0;
  auto release = [&]() {
    fence_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (++slot == S) {
      slot = 0;
      ph ^= 1;
    }
  };

  unsigned it = 0;
  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x, ++it) {
    mbar_wait(xfull, it & 1);
    for (int j = 0; j < m; ++j) {
      // ---- unaries u_j: acc[lb][nt] is the m16n8 tile of labels
      // lb * 128 + 16 warp .. + 15 and vectors 8 nt .. 8 nt + 7
      float acc[NLB][NVG][4];
#pragma unroll
      for (int lb = 0; lb < NLB; ++lb)
#pragma unroll
        for (int nt = 0; nt < NVG; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[lb][nt][e] = 0.f;
#pragma unroll
      for (int lb = 0; lb < NLB; ++lb) {
        if (lb >= nlb) break;
        for (int kc = 0; kc < nkc; ++kc) {
          mbar_wait(&full[slot], ph);
          const float* T =
              reinterpret_cast<const float*>(ring + (size_t)slot * VT_TILE);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const float4 a = *reinterpret_cast<const float4*>(
                T + ((warp * 2 + ks) * 32 + lane) * 4);
            uint32_t ah[4], al[4];
            split_tf32(a.x, ah[0], al[0]);
            split_tf32(a.y, ah[1], al[1]);
            split_tf32(a.z, ah[2], al[2]);
            split_tf32(a.w, ah[3], al[3]);
            const float* xk = xs + kc * VT_KC + ks * 8 + q;
#pragma unroll
            for (int nt = 0; nt < NVG; ++nt) {
              const float* xr = xk + (size_t)(nt * 8 + g) * dps;
              uint32_t bh[2], bl[2];
              split_tf32(xr[0], bh[0], bl[0]);
              split_tf32(xr[4], bh[1], bl[1]);
              mma_tf32(acc[lb][nt], al, bh);
              mma_tf32(acc[lb][nt], ah, bl);
              mma_tf32(acc[lb][nt], ah, bh);
            }
          }
          release();
        }
      }
      if (j == m - 1) fence_async();
      // f_{j-1} complete, f_{j-2} no longer read (and, at j = 0, the last
      // block's backtrace done with the scratch)
      consumers_sync();
      // the block's vectors are read by every warp: refill xs
      if (j == m - 1 && tid == 0) mbar_arrive(xempty);
      float* fu = fb + (size_t)(j & 1) * h * V;
#pragma unroll
      for (int lb = 0; lb < NLB; ++lb) {
        if (lb >= nlb) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int b = lb * VT_LB + warp * 16 + hh * 8 + g;
          if (b < h) {
            const float cb = c2[(size_t)j * h + b];
#pragma unroll
            for (int nt = 0; nt < NVG; ++nt) {
              const float2 u = make_float2(cb - 2.f * acc[lb][nt][2 * hh],
                                           cb - 2.f * acc[lb][nt][2 * hh + 1]);
              const size_t o = (size_t)b * V + nt * 8 + 2 * q;
              *reinterpret_cast<float2*>(fu + o) = u;
              if (j == 0) *reinterpret_cast<float2*>(sc + o) = u;
            }
          }
        }
      }
      consumers_sync();  // u_j written
      if (j == 0) continue;

      // ---- f_j = u_j + min_a [f_{j-1}(a) + bin_{j-1}(a, .)]
      const float* fi = fb + (size_t)((j - 1) & 1) * h * V;
      float mn[4][8];
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int v = 0; v < 8; ++v) mn[l][v] = INFINITY;
      for (int a0 = 0; a0 < h; a0 += ta) {
        mbar_wait(&full[slot], ph);
        const float* T =
            reinterpret_cast<const float*>(ring + (size_t)slot * VT_TILE);
        const int rows = min(ta, h - a0);
        if (mp) {
#pragma unroll 2
          for (int a = gi; a < rows; a += G) {
            const float4 bv =
                *reinterpret_cast<const float4*>(T + a * hp + 4 * lg);
            const float* fr = fi + (size_t)(a0 + a) * V + 8 * vg;
            minplus_row(mn, bv, *reinterpret_cast<const float4*>(fr),
                        *reinterpret_cast<const float4*>(fr + 4));
          }
        }
        release();
      }
      for (int off = 1; off < G; off <<= 1)
#pragma unroll
        for (int l = 0; l < 4; ++l)
#pragma unroll
          for (int v = 0; v < 8; ++v)
            mn[l][v] =
                fminf(mn[l][v], __shfl_xor_sync(0xffffffffu, mn[l][v], off));
      if (mp && gi == 0) {
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int b = 4 * lg + l;
          if (b < h) {
            const size_t o = (size_t)b * V + 8 * vg;
            float4 u0 = *reinterpret_cast<float4*>(fu + o);
            float4 u1 = *reinterpret_cast<float4*>(fu + o + 4);
            u0.x += mn[l][0];
            u0.y += mn[l][1];
            u0.z += mn[l][2];
            u0.w += mn[l][3];
            u1.x += mn[l][4];
            u1.y += mn[l][5];
            u1.z += mn[l][6];
            u1.w += mn[l][7];
            *reinterpret_cast<float4*>(fu + o) = u0;
            *reinterpret_cast<float4*>(fu + o + 4) = u1;
            float* s = sc + (size_t)j * h * V + o;
            *reinterpret_cast<float4*>(s) = u0;
            *reinterpret_cast<float4*>(s + 4) = u1;
          }
        }
      }
    }
    consumers_sync();  // every f_j of the block in the scratch

    // ---- backtrace: this warp's VW vectors together
    int bn[VW];
    float best[VW];
    int arg[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      best[k] = INFINITY;
      arg[k] = INT_MAX;
    }
    const int v0 = warp * VW;
    for (int a = lane; a < h; a += 32) {
      const float* fr = sc + ((size_t)(m - 1) * h + a) * V + v0;
#pragma unroll
      for (int k = 0; k < VW; ++k) argmin_merge(best[k], arg[k], fr[k], a);
    }
#pragma unroll
    for (int k = 0; k < VW; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[k], off);
        const int oi = __shfl_xor_sync(0xffffffffu, arg[k], off);
        argmin_merge(best[k], arg[k], ov, oi);
      }
      bn[k] = arg[k] == INT_MAX ? 0 : arg[k];
      const int vec = blk * V + v0 + k;
      if (lane == 0 && vec < n) out[(size_t)vec * m + m - 1] = bn[k];
    }
    for (int i = m - 2; i >= 0; --i) {
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        best[k] = INFINITY;
        arg[k] = INT_MAX;
      }
      for (int a = lane; a < h; a += 32) {
        const float* fr = sc + ((size_t)i * h + a) * V + v0;
#pragma unroll
        for (int k = 0; k < VW; ++k)
          argmin_merge(best[k], arg[k],
                       fr[k] + binT[((size_t)i * h + bn[k]) * h + a], a);
      }
#pragma unroll
      for (int k = 0; k < VW; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best[k], off);
          const int oi = __shfl_xor_sync(0xffffffffu, arg[k], off);
          argmin_merge(best[k], arg[k], ov, oi);
        }
        bn[k] = arg[k] == INT_MAX ? 0 : arg[k];
        const int vec = blk * V + v0 + k;
        if (lane == 0 && vec < n) out[(size_t)vec * m + i] = bn[k];
      }
    }
  }
}

template <typename F>
F pick(int V, F k8, F k16, F k32) {
  return V == 32 ? k32 : V == 16 ? k16 : k8;
}

}  // namespace

// The layout of K13 at (m, h, d): vectors a CTA, ring slots, the CTAs an
// SM is meant to hold, shared bytes a CTA, and the CTAs an SM holds
// (the occupancy query's answer) → out[0..5).
extern "C" int rq_viterbi_layout(int m, int h, int d, void* out) {
  int* o = (int*)out;
  if (!vt_layout(m, h, d, o)) return (int)cudaErrorInvalidValue;
  auto kern = pick(o[0], viterbi_kernel<8>, viterbi_kernel<16>,
                   viterbi_kernel<32>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, o[3]);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[4], kern, VT_THREADS, o[3]);
}

// X (n, ldx) f32 with ldx a multiple of 4 (zero pads past d), Cf the
// codebooks in tiles of A fragments (m, ceil(h/128), ceil(d/16), 8, 2,
// 32, 4), c2 (m, h), bin (m-1, h, hp) with hp = h rounded up to 4 (zero
// pads), binT (m-1, h, h), scr grid x m x h x vecs f32, out (n, m)
// int32; `grid` persistent CTAs. `vecs` is the vectors a CTA that scr was
// sized for: a layout that takes another count is refused, so the kernel
// never writes past scr.
extern "C" int rq_viterbi_encode(const void* X, const void* Cf,
                                 const void* c2, const void* bin,
                                 const void* binT, void* scr, void* out,
                                 int n, int m, int h, int d, int ldx,
                                 int grid, int vecs, void* stream) {
  if (n <= 0) return 0;
  int lay[4];
  if (!vt_layout(m, h, d, lay) || lay[0] != vecs || grid < 1 || ldx < d ||
      ldx % 4)
    return (int)cudaErrorInvalidValue;
  auto kern = pick(lay[0], viterbi_kernel<8>, viterbi_kernel<16>,
                   viterbi_kernel<32>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay[3]);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, VT_THREADS, lay[3], (cudaStream_t)stream>>>(
      (const float*)X, ldx, (const float*)Cf, (const float*)c2,
      (const float*)bin, (const float*)binT, (float*)scr, (int*)out, n, m, h,
      d, lay[1]);
  return (int)cudaGetLastError();
}
