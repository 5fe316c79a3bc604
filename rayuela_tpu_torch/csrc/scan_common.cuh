// Shared device code of the packed-key scans for Hopper (sm_90a): the
// key format, the register selection, the tensor-core score and its
// keys, and the one-pass body that K4 (codes_scan.cu) and K8 at keep = 0
// (decoded_scan.cu) instantiate with their own row source (the candidates
// kernels K1/K14 and bf16 K8 have bodies of their own over the same score
// and keys). The exact-float scans (K9, K10 in decoded_scan.cu; K6, K7 in
// lut_scan.cu) share the sinks at the end of this file, and with the
// packed-key sink there the same bodies are K8 on f32 rows
// (decoded_scan.cu) and K5 (lut_scan.cu).
//
// Logical contract (shared with the plain PyTorch versions in
// rayuela_tpu_torch/search/). Row gid lives in lane gid % 128 with
// per-lane row id rid = gid >> 7. Its score against query q is
// dot(x, Qm[q]) + x2, with x the row at the operand type, Qm = -2q at
// the operand type and an f32 dot taken in dimension order (on the
// tensor cores in chunks of 16, below), and +inf for pad rows gid >= n. The selection key is
// (sortable(score) & -(1 << idbits)) | rid: unique per (lane, query),
// so per-lane selections have no ties. Per (lane, query), over the
// lane's row ids in order: a tile keeps its KEEP smallest keys, and
// every key that is dropped on the way goes into one running minimum,
// the certificate.
//
// A row source `Src` (of the one-pass body) provides
//   using Op = float | __nv_bfloat16     the operand type
//   int lane_words() const               ints of scratch per row
//   void load_lanes<NL, NR>(n, rid, l0, b0, nb, dp, Xs, xs, x2s, words)
//                                        (Xs: Op *)
// where load_lanes() brings dimensions [b0, b0 + nb) of the NL lanes
// [l0, l0 + NL) of the NR row ids rid .. rid + NR - 1 (dp values each)
// into shared memory row by row: row j < NR * NL (row id rid + j / NL,
// lane l0 + j % NL) at Xs[j * xs + kk] at the operand type, its norm at
// x2s[j] (a block at b0 > 0 only adding to what the earlier blocks left
// there, where the norms come from the row itself), and ends with a
// barrier.
//
// The d-blocks. Up to NARROW_DP a row is one block (b0 = 0, nb = dp). A
// wider row (GIST's d = 960) goes through in blocks of DBLK dimensions,
// in ascending order: the per-thread scores stay in registers across the
// blocks, so a score is still one fmaf chain in dimension order and its
// bits do not depend on the blocking (`scan_dblock`; the one-pass
// layout, `topk_smem`, is the kernels' alone, the wrappers ask for it).
//
// The tensor-core score. The bf16 code-resident scans (K1 and K14 in
// codes_scan.cu, K4 below) score on the tensor cores instead: a score is
// the f32 sum, over the 16-dimension chunks of the row in ascending order
// (d-blocks ascending), of one mma.sync m16n8k16 each (bf16 operands, f32
// accumulator) from a zero accumulator, then + x2 in f32 (`tile_scores`).
// One instruction shape and one chunk order in all of them, so that they
// give the same score bits for a (row, query) wherever it sits in a tile:
// the one-pass search (K14, and K4's rescue) equals the two-pass one (K1
// -> K2). The bf16 decoded scans (K8's candidates body in
// decoded_scan.cu, K8 at keep = 0 below) take the same score over the
// rows they read. Where a row is one d-block (dp <= NARROW_DP) the key is
// then the fmaf chain's: a tensor-core score settles it unless it lies
// near a key boundary, and there the pair is scored again by the chain
// (`margin_keys`). A d not a multiple of 16 scores with its last chunk
// zero-filled in shared memory (the rows' and the queries' pads), so any
// dp a multiple of 8 takes the same function. The f32 instances keep the
// fmaf chain (f32 K1 and K14: `codes_f32_kernel` in codes_scan.cu; f32
// K8: `exact_rows_kernel` in decoded_scan.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <type_traits>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int NARROW_DP = 256;  // up to this width a row is one d-block
constexpr int DBLK = 128;       // the d-block of a wider row

// The d-block of a scan over rows of dp values.
__host__ __device__ inline int scan_dblock(int dp) {
  return dp <= NARROW_DP ? dp : DBLK;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes from device memory to shared memory, asynchronously (zeros
// where `full` is false); a commit closes a group, a wait<N> returns once
// at most N groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int row_key(float s, int rid, int vmask) {
  int b = __float_as_int(s);
  b = b >= 0 ? b : (b ^ 0x7FFFFFFF);
  return (b & vmask) | rid;
}

__device__ __forceinline__ int code_of(const int* words, int j) {
  return (int)(((unsigned)words[j >> 2] >> (8 * (j & 3))) & 0xFFu);
}

// Insert key x into the ascending array buf; `rest` keeps the minimum
// of every key that is not (or no longer) in buf.
template <int K>
__device__ __forceinline__ void insert_sorted(int (&buf)[K], int& rest,
                                              int x) {
  if (x < buf[K - 1]) {
    rest = min(rest, buf[K - 1]);
    buf[K - 1] = x;
#pragma unroll
    for (int i = K - 1; i > 0; --i) {
      const int a = buf[i - 1], b = buf[i];
      buf[i - 1] = min(a, b);
      buf[i] = max(a, b);
    }
  } else {
    rest = min(rest, x);
  }
}

// Sixteen bytes of T, widened to f32 and added to acc[0..N) in order.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void add(const uint4& u, float* acc) {
    acc[0] += __uint_as_float(u.x);
    acc[1] += __uint_as_float(u.y);
    acc[2] += __uint_as_float(u.z);
    acc[3] += __uint_as_float(u.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // little-endian: the element at the lower address is the low half;
  // a bf16 is the top half of the f32 with the same value
  static __device__ __forceinline__ void add(const uint4& u, float* acc) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += __uint_as_float(w[i] << 16);
      acc[2 * i + 1] += __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

// Elements of T in 16 bytes, unpacked to f32 (exact: a bf16 is the top
// half of the f32 with the same value; the lower address is the low half).
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core score of the bf16 codes scans (K1, K14, K4)
// ---------------------------------------------------------------------------

// Whether row source Src scores on the tensor cores (`Src::kTensorScores`;
// a source that does not say keeps the fmaf chain).
template <class Src, class = void> struct tensor_scores : std::false_type {};
template <class Src>
struct tensor_scores<Src, std::void_t<decltype(Src::kTensorScores)>>
    : std::bool_constant<Src::kTensorScores> {};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four (or two) 8 x 8 matrices of 16-bit values from shared memory; thread
// i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// acc += A B: A 16 x 16 (row-major, bf16), B 16 x 8 (column-major, bf16),
// acc the 16 x 8 f32 sums of the warp (thread l holds rows l / 4 and
// l / 4 + 8, columns 2 (l % 4) and 2 (l % 4) + 1). The product is one
// m16n8k16 from a zero accumulator, added to acc in f32 (round to
// nearest): the tensor cores' own accumulation may drop the low bits of
// the products against a large running sum, a chunk's sum of 16 does not
// meet one.
__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// The score function of the bf16 codes scans, for one warp: acc[t] += the
// products of 16 queries (rows of Q, qs elements apart) with the 8 rows
// X[8 t .. 8 t + 8) (xs elements apart), over dimensions [0, nk) of both
// in chunks of 16, ascending, one m16n8k16 product a chunk and tile
// (`mma_bf16`).
// acc[t][e] is query l / 4 + 8 (e / 2) against row 8 t + 2 (l % 4) +
// e % 2 (l the thread's lane in the warp). Operands load with ldmatrix:
// each row's stride is 16 bytes past a multiple of 128, so the 8 rows of
// a matrix fall in distinct banks. Both operands are 16-byte aligned.
template <int NT>
__device__ __forceinline__ void tile_scores(const __nv_bfloat16* Q, int qs,
                                            const __nv_bfloat16* X, int xs,
                                            int nk, float (&acc)[NT][4]) {
  static_assert(NT == 1 || NT % 2 == 0, "NT: 1 or even");
  const int l = threadIdx.x & 31;
  const __nv_bfloat16* qa = Q + (l & 15) * qs + (l >> 4) * 8;
  const __nv_bfloat16* xa =
      X + ((NT == 1 ? 0 : (l >> 4) * 8) + (l & 7)) * xs + ((l >> 3) & 1) * 8;
  for (int k0 = 0; k0 < nk; k0 += 16) {
    unsigned a[4];
    ldmatrix_x4(a, qa + k0);
    if constexpr (NT == 1) {
      unsigned b[2];
      ldmatrix_x2(b, xa + k0);
      mma_bf16(acc[0], a, b[0], b[1]);
    } else {
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        unsigned b[4];
        ldmatrix_x4(b, xa + t * 8 * xs + k0);
        mma_bf16(acc[t], a, b[0], b[1]);
        mma_bf16(acc[t + 1], a, b[2], b[3]);
      }
    }
  }
}

// The keys of the tensor-core scores, where a row is one d-block. A key
// keeps the bits of the score above its idbits low ones (`row_key`), so a
// tensor-core score s and the fmaf chain's score of the same pair give
// one key unless a key boundary lies between them: they differ by a few
// f32 rounding steps of the products' magnitude, a step of the key is
// 2^idbits of them. The scan takes the keys lo and hi of s - slack and s
// + slack (`score_slack`): where they agree that is the chain's key too;
// where they do not and lo could enter the pair's buffer, the pair is
// scored again by the chain (`chain_score`), the requests of a warp's
// threads side by side (`warp_offsets`, `warp_chain_keys`). So a key is
// the fmaf chain's, that of the f32 bodies and of the plain versions' f32
// matmul, and the tensor cores do the work of every pair away from a
// boundary. The chain's key is held at lo or above, so that a key is a
// function of the pair alone even where the two sums were further apart
// than the margin: the one-pass scans then still keep the two-pass
// scan's keys.

// |v| in f32 of dp bf16 values (16-byte aligned), one fmaf chain in
// dimension order, times dp 2^-25 (the factor of `score_slack`): the same
// bits in every kernel that asks.
__device__ __forceinline__ float slack_of_query(const __nv_bfloat16* v,
                                               int dp) {
  float a = 0.f;
  for (int k = 0; k < dp; k += 8) {
    float x[8];
    unpack16(*reinterpret_cast<const uint4*>(v + k), x);
#pragma unroll
    for (int e = 0; e < 8; ++e) a = fmaf(x[e], x[e], a);
  }
  return __fmul_rn(sqrtf(a), (float)dp * 0x1p-25f);
}

// The score of the f32 bodies: x . q over dp bf16 values (16-byte
// aligned, dp a multiple of 8), one fmaf chain in dimension order from
// zero, then + x2.
__device__ __forceinline__ float chain_score(const __nv_bfloat16* x,
                                             const __nv_bfloat16* q, int dp,
                                             float x2) {
  float a = 0.f;
#pragma unroll 2
  for (int k = 0; k < dp; k += 8) {
    float xv[8], qv[8];
    unpack16(*reinterpret_cast<const uint4*>(x + k), xv);
    unpack16(*reinterpret_cast<const uint4*>(q + k), qv);
#pragma unroll
    for (int e = 0; e < 8; ++e) a = fmaf(xv[e], qv[e], a);
  }
  return a + x2;
}

// The squares of a staged bf16 row's values (16-byte aligned) in its
// 16-byte chunks g, g + 8, ... below nc, one fmaf chain in that order,
// added to a: thread g < 8 of the 8 consecutive threads that share a row.
// A row staged in blocks of 128 dimensions continues the chain block by
// block (16 chunks a block: the same chunks of a thread, in the same
// order).
__device__ __forceinline__ float row_sq_part(const __nv_bfloat16* row,
                                             int nc, int g, float a) {
  for (int c = g; c < nc; c += 8) {
    float x[8];
    unpack16(*reinterpret_cast<const uint4*>(row + 8 * c), x);
#pragma unroll
    for (int e = 0; e < 8; ++e) a = fmaf(x[e], x[e], a);
  }
  return a;
}

// The norm of the f32 values of a bf16 row (xn of `score_slack`) from the
// `row_sq_part`s of its 8 consecutive threads, added in a butterfly: the
// same bits in every thread of the group and in every kernel that asks
// (K8's candidates and keep = 0 bodies). Every thread of the warp calls it.
__device__ __forceinline__ float group8_norm(float a) {
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  a += __shfl_xor_sync(0xffffffffu, a, 4);
  return sqrtf(a);
}

// The margin around a tensor-core score s of a pair whose query gives qc
// (`slack_of_query`: its norm qn times dp 2^-25) and whose row's f32
// values have norm xn: qn xn bounds the sum of the products' magnitudes,
// the partial sums of both the chain and the chunks. The chain rounds dp
// times, each by at most 2^-24 of that bound, and mostly in both
// directions (a spread of sqrt(dp) steps); the tensor cores drop at most
// ~17 steps of a chunk's largest product; two more roundings add x2. The
// margin takes dp / 2 steps of 2^-24 of the bound, and 2^-21 of |s|
// (rounded as written, in every kernel alike).
__device__ __forceinline__ float score_slack(float s, float qc, float xn) {
  return fmaf(fabsf(s), 0x1p-21f, __fmul_rn(qc, xn));
}

// The keys lo <= hi that the margin allows a tensor-core score s (x2
// added; +inf for a pad row) of row id rid.
__device__ __forceinline__ void margin_keys(float s, float slack, int rid,
                                            int vmask, int& lo, int& hi) {
  const bool pad = __float_as_int(s) == 0x7F800000;
  lo = row_key(pad ? s : s - slack, rid, vmask);
  hi = row_key(pad ? s : s + slack, rid, vmask);
}

// K8's key modes (scan_pallas.py::_row_key(nonneg=True) under qbias,
// ::_row_key16 under score16), numbered as scan.py numbers them.
constexpr int K8_PLAIN = 0, K8_QBIAS = 1, K8_SCORE16 = 2;

// The key of score s (x2 added; +inf for a pad row) of row id rid in mode
// M: PLAIN `row_key`; QBIAS the score plus the query's |q|^2 (q2), clamped
// at +0.0, whose bits are then their own sortable form; SCORE16 the score
// rounded to bf16 (to nearest even), its 16 bits sign-fixed and shifted
// above the idbits (<= 15) of the row id. Each is a non-decreasing
// function of s (the rounding of s + q2 and to bf16 are monotone), so the
// keys of s - slack and s + slack bound the key of every score between
// them: `margin_keys` holds in every mode (`margin_keys_mode`), only the
// share of pairs whose bounds differ changes (fewer under SCORE16, whose
// steps are 2^8 relative; more under QBIAS where s + q2 lies near 0).
template <int M>
__device__ __forceinline__ int mode_key(float s, float q2, int rid,
                                        int idbits, int vmask) {
  if constexpr (M == K8_QBIAS) {
    const float v = __fadd_rn(s, q2);
    return (__float_as_int(v > 0.f ? v : 0.f) & vmask) | rid;
  } else if constexpr (M == K8_SCORE16) {
    const int b = (int)(short)__bfloat16_as_ushort(__float2bfloat16_rn(s));
    return (int)((unsigned)(b >= 0 ? b : b ^ 0x7FFF) << idbits) | rid;
  } else {
    return row_key(s, rid, vmask);
  }
}

// `margin_keys` in mode M (q2 and idbits as `mode_key` takes them).
template <int M>
__device__ __forceinline__ void margin_keys_mode(float s, float slack,
                                                 float q2, int rid,
                                                 int idbits, int vmask,
                                                 int& lo, int& hi) {
  const bool pad = __float_as_int(s) == 0x7F800000;
  lo = mode_key<M>(pad ? s : s - slack, q2, rid, idbits, vmask);
  hi = mode_key<M>(pad ? s : s + slack, q2, rid, idbits, vmask);
}

// The pre-min of K8 (scan_pallas.py::_premin): key x of a window of
// consecutive row ids folds into the window's running minimum win
// (INT_MAX at the window's start), the larger of the two into rest. Over
// a window that leaves win its minimum and rest the minimum of its other
// keys, in any order of the keys.
__device__ __forceinline__ void window_fold(int& win, int& rest, int x) {
  rest = min(rest, max(win, x));
  win = min(win, x);
}

// A warp's requests for the chain: bit p of `need` asks for pair p of the
// calling thread. Returns the index of the calling thread's first request
// in the warp's request arrays (its others follow, in the order of p) and
// the warp's count in `total`. Every thread of the warp calls it.
__device__ __forceinline__ int warp_offsets(unsigned need, int& total) {
  const unsigned full = 0xffffffffu;
  const int l = threadIdx.x & 31, c = __popc(need);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(full, incl, o);
    if (l >= o) incl += v;
  }
  total = __shfl_sync(full, incl, 31);
  return incl - c;
}

// The warp's `total` requests, side by side over its lanes: request i is
// item[i] (the caller's encoding of a pair) with its lower key keys[i];
// keys[i] becomes max(chain(item[i]), keys[i]), chain returning the
// pair's key from the fmaf chain's score. Every thread of the warp calls
// it; the barriers order the caller's writes before and its reads after.
template <class Chain>
__device__ __forceinline__ void warp_chain_keys(const unsigned short* item,
                                                int* keys, int total,
                                                Chain chain) {
  __syncwarp();
  for (int i = threadIdx.x & 31; i < total; i += 32)
    keys[i] = max(chain((int)item[i]), keys[i]);
  __syncwarp();
}

// The one-pass body (K4, and K8 at keep = 0), which replaces
// scan_codes_pallas.py::_codes_decode_kernel_packed (:318) and
// scan_pallas.py::_scan_kernel_packed at keep = 0. Per (lane, query)
// over row ids [s * rows_per, (s + 1) * rows_per): the R smallest keys
// ascending to cand[s*R .. s*R + R) and the smallest other key to
// disc[s]. With one split that is the final (R+1)-row buffer; with more,
// K2 merges the splits into it (the certificate stays exact: every key
// not kept is some split's rejected key or a merge loser).
//
// What bounds it on this card. The TPU kernel keeps an (r, 128, bq)
// buffer in VMEM, so it decodes a tile once per bq queries. Here the
// R-deep buffer of a (lane, query) pair is a sorted register array
// (R = 48: 48 registers, one insertion a compare after the first rows),
// which leaves room for one pair per thread: 256 pairs a CTA. At 2
// queries x 128 lanes a CTA decoded (K4) or loaded (K8) every row once
// per 2 queries, and the L2 gathers of the decode, waited on 8 chunks a
// thread per step, bounded it (on an H100, 34 ms for 128 queries at
// n = 1e6, 11x the library's scan). The lever is the rows a CTA decodes
// per query, not the depth of the buffer: a CTA here holds LN = 8 lanes
// x QB = 32 queries (16 x 16 where 32 queries of a wide f32 row would
// not leave two CTAs an SM), so a row is decoded or loaded once per 32
// queries, and the 128 / LN lane groups run as CTAs of their own: the
// grid is (query blocks, lane groups, splits). That layout serves a few
// queries best too (on an H100, a sweep of 2 to 32 queries a CTA over 1
// to 128 queries, `demos/time_onepass.py --sweep`): the lane groups
// multiply the CTAs a split has, so fewer splits fill the card and K2
// merges fewer. The buffers take 48 of a thread's 128 registers (two
// CTAs an SM), so a step brings NR = 32 / LN row ids at once (32 rows,
// one barrier and one wait on the gathers for all), and a thread scores
// its query against its lane of each, NR independent chains. One pair
// per thread makes the shared loads the bound of the scoring (each
// operand is read by its own thread), so rows and queries sit in shared
// memory at the operand type, row by row (stride + 16 bytes: the lanes x
// queries of a warp read distinct banks), and one 16-byte load brings 8
// bf16 dimensions of a row or of a query, the query's shared by the NR
// rows. A score is the fmaf chain in dimension order (over the values
// widened to f32) plus x2 of the former kernel and of K1, so the keys are
// bit for bit those of the former kernel on any data. WIDE rows (dp >
// NARROW_DP) go through in d-blocks of DBLK, the scores staying in
// registers across the blocks; the queries stay whole (at dp = 1024 and
// QB = 32, 66 KB in bf16). `topk_qb` picks QB, `rq_codes_topk_layout`
// and `rq_scan_onepass_layout` report it and the CTAs an SM holds, and
// the wrappers split the rows from that.
//
// K4 on bf16 operands (`tensor_scores`) takes the tensor-core score of K1
// and K14 instead of the fmaf chain, so that its keys equal theirs on any
// data: a step's QB x 32 products are QB / 4 m16n8 tiles, one a warp
// (`tile_scores`), accumulated over the d-blocks in the fragments; at the
// step's end they pass through shared memory to the thread that owns each
// (lane, query), and at one d-block the key is the chain's
// (`margin_keys`, over the step's rows, still in shared memory). The
// layout, buffers and splits are the fmaf body's. K8 at keep = 0 on bf16
// rows takes the same score function (its row source computes the rows'
// norms from the staged rows, `group8_norm`, as K8's candidates body
// does), so that its keys equal K8's candidates' and K4's on any data.
template <class Src, int R, int LN>
__global__ void __launch_bounds__(THREADS, 2)
    scan_topk_kernel(const Src src, const typename Src::Op* __restrict__ Qm,
                     int* __restrict__ cand, int* __restrict__ disc, int n,
                     int nq, int dp, int nrows, int rows_per, int idbits) {
  using T = typename Src::Op;
  constexpr int QB = THREADS / LN, NR = 32 / LN, V = Vec16<T>::N;
  constexpr bool MMA = tensor_scores<Src>::value;
  constexpr int SS = 40;  // row stride of the products in shared memory
  static_assert(!MMA || std::is_same<T, __nv_bfloat16>::value,
                "tensor-core scores take bf16 operands");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int db = scan_dblock(dp), xs = db + V, qs = dp + V;
  // MMA at one d-block: the keys are the fmaf chain's, and the rows of two
  // steps stay, so that the chain's requests of a step wait for the next
  // step's and a warp serves both in one pass
  const bool one_block = db == dp;
  const int nbx = MMA && one_block ? 2 : 1;
  T* Qs = reinterpret_cast<T*>(smem_raw);  // QB * qs
  T* Xs0 = Qs + QB * qs;                   // nbx * NR * LN * xs
  float* x2s0 = reinterpret_cast<float*>(Xs0 + nbx * NR * LN * xs);
  int* words = reinterpret_cast<int*>(x2s0 + nbx * NR * LN);  // lane_words
  // MMA: the products (QB x SS), the queries' margins, the rows' norms
  // and, at one d-block, the chain's requests of two steps (64 NR a warp:
  // keys, then items)
  float* S = reinterpret_cast<float*>(words + NR * LN * src.lane_words());
  float* qcs = S + QB * SS;
  float* xns = qcs + QB;
  int* rkeys = reinterpret_cast<int*>(xns + NR * LN);
  unsigned short* ritems =
      reinterpret_cast<unsigned short*>(rkeys + 64 * NR * (THREADS / 32));
  const int j = threadIdx.x % LN, qi = threadIdx.x / LN;
  const int l0 = blockIdx.y * LN, lane = l0 + j;
  const int q = blockIdx.x * QB + qi, s = blockIdx.z;
  const int vmask = -(1 << idbits);
  for (int i = threadIdx.x; i < QB * dp; i += THREADS) {
    const int qq = blockIdx.x * QB + i / dp;
    Qs[(i / dp) * qs + i % dp] =
        qq < nq ? Qm[(size_t)qq * dp + i % dp] : T(0.f);
  }
  if constexpr (MMA) {
    // the pads: a last chunk of 16 that dp ends inside reads zeros there
    for (int i = threadIdx.x; i < QB * V; i += THREADS)
      Qs[(i / V) * qs + dp + i % V] = T(0.f);
    __syncthreads();
    if (threadIdx.x < QB)
      qcs[threadIdx.x] = slack_of_query(
          reinterpret_cast<const __nv_bfloat16*>(Qs) + threadIdx.x * qs, dp);
  }

  const bool live = q < nq;
  const T* qrow = Qs + qi * qs;
  if constexpr (MMA) __syncthreads();  // qcs
  const float qc = MMA ? qcs[qi] : 0.f;
  int buf[R];
#pragma unroll
  for (int c = 0; c < R; ++c) buf[c] = INT_MAX;
  int rest = INT_MAX;
  const int rid1 = min(nrows, (s + 1) * rows_per);
  const int warp = threadIdx.x >> 5, lt = threadIdx.x & 31;
  // MMA: warp w < QB / 4 scores queries [16 (w / 4), +16) against the
  // rows [8 (w % 4), +8) of the step (row r * LN + j: row id rid0 + r,
  // lane l0 + j)
  const bool tiled = warp < QB / 4;
  const int qt = 16 * (warp >> 2), rt = 8 * (warp & 3);
  // the chain's requests waiting in the warp's arrays: the warp's count,
  // and where the thread's of the last step start and how many they are
  int woff = 0, pstart = 0, pcount = 0;
  for (int rid0 = s * rows_per; rid0 < rid1; rid0 += NR) {
    const int bb = nbx == 2 ? ((rid0 - s * rows_per) / NR) & 1 : 0;
    T* Xs = Xs0 + bb * NR * LN * xs;
    float* x2s = x2s0 + bb * NR * LN;
    float acc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = 0.f;
    float frag[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    for (int b0 = 0; b0 < dp; b0 += db) {
      const int nb = min(db, dp - b0);
      __syncthreads();  // the readers of the last block are done with Xs
      if constexpr (MMA)
        src.template load_lanes<LN, NR>(n, rid0, l0, b0, nb, dp, Xs, xs, x2s,
                                        words, one_block ? xns : nullptr);
      else
        src.template load_lanes<LN, NR>(n, rid0, l0, b0, nb, dp, Xs, xs, x2s,
                                        words);
      if constexpr (MMA) {
        if (tiled)
          tile_scores<1>(reinterpret_cast<const __nv_bfloat16*>(Qs) +
                             qt * qs + b0,
                         qs,
                         reinterpret_cast<const __nv_bfloat16*>(Xs) + rt * xs,
                         xs, nb, frag);
      } else if (live) {
        for (int kk = 0; kk < nb; kk += V) {
          float v[V];
          unpack16(*reinterpret_cast<const uint4*>(qrow + b0 + kk), v);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            float x[V];
            unpack16(*reinterpret_cast<const uint4*>(
                         Xs + (r * LN + j) * xs + kk), x);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[r] = fmaf(x[e], v[e], acc[r]);
          }
        }
      }
    }
    if constexpr (MMA) {
      // (the last step's readers of S passed the barrier of this step's
      // first block)
      if (tiled) {
        const int qq = qt + (lt >> 2), rr = rt + 2 * (lt & 3);
        S[qq * SS + rr] = frag[0][0];
        S[qq * SS + rr + 1] = frag[0][1];
        S[(qq + 8) * SS + rr] = frag[0][2];
        S[(qq + 8) * SS + rr + 1] = frag[0][3];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] = S[qi * SS + r * LN + j];
    }
    // the keys lo <= hi each row's score allows (one key where the score
    // is the fmaf chain's or settles it), lo in place of the score; eq:
    // the rows whose key is known, need: those the chain decides
    unsigned eq = 0, need = 0;
    const int thr = max(buf[R - 1], rest);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int rid = rid0 + r;
      const bool pad = (long long)rid * LANES + lane >= n;
      const float sc =
          pad ? __int_as_float(0x7F800000) : acc[r] + x2s[r * LN + j];
      int lo, hi;
      if (MMA && one_block) {
        margin_keys(sc, score_slack(sc, qc, xns[r * LN + j]), rid, vmask, lo,
                    hi);
      } else {
        lo = hi = row_key(sc, rid, vmask);
      }
      const bool in = live && rid < rid1;
      eq |= (unsigned)(in && lo == hi) << r;
      need |= (unsigned)(in && lo != hi && lo < thr) << r;
      acc[r] = __int_as_float(lo);
    }
    // one copy of the R-deep insertion for the step's rows (and one for
    // each step's keys from the chain below): the step's code stays small
#pragma unroll 1
    for (int r = 0; r < NR; ++r) {
      float a = acc[0];
#pragma unroll
      for (int u = 1; u < NR; ++u) a = r == u ? acc[u] : a;
      if (eq >> r & 1) insert_sorted<R>(buf, rest, __float_as_int(a));
    }
    if constexpr (MMA) {
      if (one_block) {
        int total;
        const int base = woff + warp_offsets(need, total);
        int* keys = rkeys + warp * 64 * NR;
        unsigned short* item = ritems + warp * 64 * NR;
        int k = base;
#pragma unroll
        for (int r = 0; r < NR; ++r)
          if (need >> r & 1) {
            item[k] = (unsigned short)((lt << 3) | (bb << 2) | r);
            keys[k++] = __float_as_int(acc[r]);
          }
        woff += total;
        if (bb == 1 || rid0 + NR >= rid1) {  // the last step's rows go next
          if (woff) {
            warp_chain_keys(item, keys, woff, [&](int it) {
              const int t = warp * 32 + (it >> 3), r = it & 3, jj = t % LN;
              const int o = ((it >> 2) & 1) * NR * LN + r * LN + jj;
              return row_key(
                  chain_score(
                      reinterpret_cast<const __nv_bfloat16*>(Xs0) + o * xs,
                      reinterpret_cast<const __nv_bfloat16*>(Qs) +
                          (t / LN) * qs,
                      dp, x2s0[o]),
                  rid0 - (bb - ((it >> 2) & 1)) * NR + r, vmask);
            });
#pragma unroll 1
            for (int c = 0; c < pcount; ++c)
              insert_sorted<R>(buf, rest, keys[pstart + c]);
#pragma unroll 1
            for (int c = base; c < k; ++c)
              insert_sorted<R>(buf, rest, keys[c]);
          }
          woff = pcount = 0;
        } else {
          pstart = base;
          pcount = k - base;
        }
      }
    }
  }
  if (!live) return;
  const size_t plane = (size_t)LANES * nq, off = (size_t)lane * nq + q;
#pragma unroll
  for (int c = 0; c < R; ++c) cand[((size_t)s * R + c) * plane + off] = buf[c];
  disc[(size_t)s * plane + off] = rest;
}

// Shared memory of a one-pass CTA of qb queries over operands of
// op_bytes: the queries whole, the 32 rows of a step (its THREADS / qb
// lanes of 32 qb / THREADS row ids) at one d-block, their norms and
// codes; on the tensor cores (mma) also the step's products (qb rows of
// 40), the queries' margins, the norms of the rows' values and, where a
// row is one d-block, a second step's rows and norms and room for the
// chain's requests of two steps (64 qb keys and items).
inline size_t topk_smem(int dp, int qb, int lane_words, int op_bytes,
                        bool mma) {
  const size_t pad = 16 / op_bytes, rows = 32;
  return (size_t)op_bytes * ((size_t)qb * (dp + pad) +
                             rows * (scan_dblock(dp) + pad)) +
         sizeof(float) * rows + sizeof(int) * rows * (size_t)lane_words +
         (mma ? sizeof(float) * ((size_t)qb * 41 + rows) +
                    (dp <= NARROW_DP
                         ? (size_t)op_bytes * rows * (dp + pad) +
                               sizeof(float) * rows + 6 * 64 * (size_t)qb
                         : 0)
              : 0);
}

// Queries per one-pass CTA at width dp: 32 where two such CTAs fit an
// SM, else 16 where one fits, else 0 (none fits).
inline int topk_qb(int dp, int lane_words, int op_bytes, bool mma) {
  int dev = 0, cap = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  // two CTAs an SM: each also takes 1 KB of the SM's shared memory
  if (topk_smem(dp, 32, lane_words, op_bytes, mma) <=
      (size_t)(cap - 1024) / 2)
    return 32;
  return topk_smem(dp, 16, lane_words, op_bytes, mma) <= (size_t)cap ? 16
                                                                       : 0;
}

// The compiled instance for qb queries a CTA (nullptr: none).
template <class Src, int R>
auto topk_kernel(int qb) -> decltype(&scan_topk_kernel<Src, R, 8>) {
  return qb == 32 ? scan_topk_kernel<Src, R, 8>
                  : qb == 16 ? scan_topk_kernel<Src, R, 16> : nullptr;
}

// Opt kernel `kern` in to `smem` bytes of dynamic shared memory and
// launch it with THREADS threads a CTA on stream st.
template <typename... P, typename... A>
cudaError_t launch_scan(void (*kern)(P...), dim3 grid, size_t smem,
                        cudaStream_t st, A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

// The one-pass body at qb queries a CTA (`topk_qb`; the wrapper passes
// the layout it was given) over row ids split rows_per a CTA.
template <class Src, int R>
cudaError_t launch_topk(const Src& src, const void* Qm, void* cand,
                        void* disc, int n, int nq, int dp, int nrows,
                        int rows_per, int qb, int idbits, cudaStream_t st) {
  auto kern = topk_kernel<Src, R>(qb);
  if (!kern) return cudaErrorInvalidValue;
  const dim3 grid((nq + qb - 1) / qb, LANES / (THREADS / qb),
                  (nrows + rows_per - 1) / rows_per);
  const size_t smem = topk_smem(dp, qb, src.lane_words(),
                                sizeof(typename Src::Op),
                                tensor_scores<Src>::value);
  return launch_scan(kern, grid, smem, st, src, (const typename Src::Op*)Qm,
                     (int*)cand, (int*)disc, n, nq, dp, nrows, rows_per,
                     idbits);
}

// The one-pass layout at width dp into out[5]: queries per CTA, lanes per
// CTA, the CTAs an SM holds at once, the d-block, the bytes of shared
// memory per CTA.
template <class Src, int R>
cudaError_t topk_layout(int dp, int lane_words, int* out) {
  constexpr int ob = sizeof(typename Src::Op);
  constexpr bool mma = tensor_scores<Src>::value;
  const int qb = topk_qb(dp, lane_words, ob, mma);
  auto kern = topk_kernel<Src, R>(qb);
  if (!kern) return cudaErrorInvalidValue;
  const size_t smem = topk_smem(dp, qb, lane_words, ob, mma);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  out[0] = qb;
  out[1] = THREADS / qb;
  out[3] = scan_dblock(dp);
  out[4] = (int)smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kern,
                                                       THREADS, smem);
}

// ---------------------------------------------------------------------------
// The exact-float scans: K9 and K10 (decoded_scan.cu), K6 and K7
// (lut_scan.cu); and K5, the packed LUT scan, on K6/K7's body
// ---------------------------------------------------------------------------
// They order rows by (untruncated f32 score, global row id), a total
// order. A thread meets the rows of a (lane, query) pair in ascending
// gid, so a strict `<` on the scores alone keeps that order: of two
// equal scores the later one loses. The scan body hands every score to
// a sink, and the sinks below make the selecting kernel (K9, K6), the
// counting kernel (K10, K7) and, on the LUT body, the packed-key kernel
// (K5) of one body, so that all see the same scores bit for bit.
//
// A sink provides
//   struct State                         per (lane, query), in registers
//   void init(State&, q, nq) const
//   void push(State&, s, step, gid) const     row `gid`, the tile's
//                                             step-th row id, scores s
//   void finish(const State&, t, rows, lane, q, nq) const

constexpr int NOID = INT_MAX;  // the id of an empty slot (score +inf)

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7F800000);
}

// Selecting sink. Per (lane, query): the tile's KEEP smallest scores
// ascending in v, and in byte c of `steps` the tile step (< 256) that
// slot c came from: four ids in one register. finish() writes them as
// candv / candi[(t * KEEP + c), lane, q], the id of a +inf slot as NOID.
template <int KEEP> struct SelectSink {
  float* candv;
  int* candi;
  struct State {
    float v[KEEP];
    unsigned steps;
  };
  __device__ __forceinline__ void init(State& st, int, int) const {
#pragma unroll
    for (int c = 0; c < KEEP; ++c) st.v[c] = pos_inf();
    st.steps = 0u;
  }
  __device__ __forceinline__ void push(State& st, float s, int step,
                                       int) const {
    if (s < st.v[KEEP - 1]) {
      int p = 0;  // slots that stay in front: those not above s
#pragma unroll
      for (int c = 0; c < KEEP - 1; ++c) p += st.v[c] <= s;
#pragma unroll
      for (int c = KEEP - 1; c > 0; --c) st.v[c] = c > p ? st.v[c - 1] : st.v[c];
#pragma unroll
      for (int c = 0; c < KEEP; ++c) st.v[c] = c == p ? s : st.v[c];
      const unsigned sh = 8u * p;
      const unsigned low = st.steps & ((1u << sh) - 1u);
      const unsigned high = ((st.steps >> sh) << sh) << 8;
      st.steps = low | ((unsigned)step << sh) | high;
    }
  }
  __device__ __forceinline__ void finish(const State& st, int t, int rows,
                                         int lane, int q, int nq) const {
    const size_t plane = (size_t)LANES * nq, off = (size_t)lane * nq + q;
#pragma unroll
    for (int c = 0; c < KEEP; ++c) {
      const int rid = t * rows + (int)((st.steps >> (8 * c)) & 0xFFu);
      candv[(size_t)(t * KEEP + c) * plane + off] = st.v[c];
      candi[(size_t)(t * KEEP + c) * plane + off] =
          st.v[c] == pos_inf() ? NOID : rid * LANES + lane;
    }
  }
};

// Counting sink. Per (lane, query): how many of the tile's rows come
// strictly before the query's boundary (taus[q], taui[q]) in the order
// (score, gid). finish() adds the count to cnt[0, lane, q] and raises
// cnt[1, lane, q] to it: the total over tiles and the largest count of
// one tile (integer atomics: the result does not depend on their
// order). The wrapper zeroes cnt.
struct CountSink {
  const float* taus;
  const int* taui;
  int* cnt;
  struct State {
    float ts;
    int ti, c;
  };
  __device__ __forceinline__ void init(State& st, int q, int nq) const {
    st.ts = q < nq ? taus[q] : -pos_inf();
    st.ti = q < nq ? taui[q] : 0;
    st.c = 0;
  }
  __device__ __forceinline__ void push(State& st, float s, int,
                                       int gid) const {
    st.c += (s < st.ts) || (s == st.ts && gid < st.ti);
  }
  __device__ __forceinline__ void finish(const State& st, int, int, int lane,
                                         int q, int nq) const {
    if (st.c == 0) return;
    const size_t off = (size_t)lane * nq + q;
    atomicAdd(cnt + off, st.c);
    atomicMax(cnt + (size_t)LANES * nq + off, st.c);
  }
};

// Packed-key sink: K5 on K6/K7's body (lut_scan.cu). Per (lane, query):
// the tile's KEEP smallest packed keys (`row_key`: the score's sortable
// bits above idbits, the row id gid >> 7 below; a pad row arrives as +inf)
// ascending, and the smallest other key. finish() writes them as
// cand[(t * KEEP + c), lane, q] and disc[t, lane, q], the buffers K2
// (cand_merge) reduces, as the candidates bodies above write them.
template <int KEEP> struct KeySink {
  int* cand;
  int* disc;
  int vmask;  // -(1 << idbits)
  struct State {
    int best[KEEP];
    int rest;
  };
  __device__ __forceinline__ void init(State& st, int, int) const {
#pragma unroll
    for (int c = 0; c < KEEP; ++c) st.best[c] = INT_MAX;
    st.rest = INT_MAX;
  }
  __device__ __forceinline__ void push(State& st, float s, int,
                                       int gid) const {
    insert_sorted<KEEP>(st.best, st.rest, row_key(s, gid / LANES, vmask));
  }
  __device__ __forceinline__ void finish(const State& st, int t, int,
                                         int lane, int q, int nq) const {
    const size_t plane = (size_t)LANES * nq, off = (size_t)lane * nq + q;
#pragma unroll
    for (int c = 0; c < KEEP; ++c)
      cand[(size_t)(t * KEEP + c) * plane + off] = st.best[c];
    disc[(size_t)t * plane + off] = st.rest;
  }
  // finish() of the V queries [q, q + V) of one lane, q a multiple of 4:
  // per plane V / 4 16-byte stores where the V lie below nq and the
  // planes' rows are 16-byte aligned, else one key at a time for the
  // queries below nq. (With one key a store, a warp's 32 keys land in 32
  // sectors on bf16 tables, V = 8, and in 16 on f32; 16-byte stores fill
  // each sector in one or two stores.)
  static constexpr bool kRunFinish = true;
  template <int V>
  __device__ __forceinline__ void finish_run(const State (&st)[V], int t,
                                             int lane, int q, int nq) const {
    static_assert(V % 4 == 0, "whole 16-byte runs");
    if (q + V > nq || nq % 4 ||
        ((reinterpret_cast<size_t>(cand) | reinterpret_cast<size_t>(disc)) &
         15)) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (q + v < nq) finish(st[v], t, 0, lane, q + v, nq);
      return;
    }
    const size_t plane = (size_t)LANES * nq, off = (size_t)lane * nq + q;
#pragma unroll
    for (int w = 0; w < V / 4; ++w) {
      const State* s = st + 4 * w;
#pragma unroll
      for (int c = 0; c < KEEP; ++c)
        *reinterpret_cast<int4*>(cand + (size_t)(t * KEEP + c) * plane +
                                 off + 4 * w) =
            make_int4(s[0].best[c], s[1].best[c], s[2].best[c], s[3].best[c]);
      *reinterpret_cast<int4*>(disc + (size_t)t * plane + off + 4 * w) =
          make_int4(s[0].rest, s[1].rest, s[2].rest, s[3].rest);
    }
  }
};

// Whether a sink writes a thread's V queries of one lane in one call
// (`finish_run`), as KeySink does.
template <class Sink, class = void> struct run_finish : std::false_type {};
template <class Sink>
struct run_finish<Sink, std::void_t<decltype(Sink::kRunFinish)>>
    : std::true_type {};

}  // namespace
