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
// A pair is the composite int64(key) * 128 + lane; a lane reads only
// its first L0 = min(cap, next_pow2(r)) keys (a key of lane rank >= cap
// cannot reach the global top-cap), slots r .. L0 - 1 reading INT_MAX.
//
// What bounds it on the card: bytes, each key read once (nq * 128 *
// min(L0, r) * 4, 82 / 164 MB at nq = 1e4 and the k = 100 / 1000 plans)
// and each output written once. The design keeps the work per query
// near that: it never sorts the 128 * L0 composites, it uses that each
// lane's list is already sorted.
//   1. A CTA takes `qb` consecutive queries, so one load of a (slot,
//      lane) row covers 4 queries (16 bytes) where it can, and stages
//      the lists in shared memory slot-major, per query: a thread that
//      owns lanes t, t + 32, t + 64, t + 96 meets its lanes at banks t
//      whatever slot it reads.
//   2. A warp per query finds the cap-th composite T by bisection on its
//      value: count(<= t) is the sum over the 128 lanes of a binary
//      search in the lane's sorted list (4 a thread in lockstep, one
//      warp sum).
//   3. Lane l's survivors are its prefix of count(< T) composites (the
//      lane of T adds the copies of T that make the total cap); a warp
//      scan over the lanes gives each prefix its offset.
//   4. The query's `wq` = max(1, cap / 1024) warps hold its cap
//      survivors in registers, up to 32 a thread, and sort them with a
//      bitonic network: shuffles and register swaps within a warp, and
//      for the merges across the warps of a query one exchange through
//      shared memory a step. Where the survivors span less than 2^32
//      (the usual case) they sort as 32-bit distances from the least one.
//   5. The sorted pairs go through shared memory (a swizzle keeps both
//      sides free of bank conflicts) and out, keys and lanes, coalesced.
// The host-side layout (`tail_layout`, mirrored by scan._tail_layout)
// sizes a query's region of shared memory and picks qb.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int LANES = 128;
constexpr int MAX_THREADS = 256;       // threads of a CTA at most
constexpr int MAX_QB = 4;              // queries of a CTA at most
constexpr int WARP_N = 1024;           // values a warp sorts at most
constexpr int TAIL_SMEM_CAP = 232448;  // dynamic shared memory a CTA may use
constexpr int META = 4 * (LANES + 2) + 16;  // offsets, then the span
constexpr unsigned FULL = 0xffffffffu;

template <int W> struct VecOf;
template <> struct VecOf<1> { using type = int; };
template <> struct VecOf<4> { using type = int4; };
__device__ __forceinline__ int part(int v, int) { return v; }
__device__ __forceinline__ int part(int4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

struct TailLayout {
  int qb;       // queries per CTA
  int wq;       // warps per query
  int threads;  // threads per CTA, 32 * wq * qb
  int lr;       // slots staged per lane, min(L0, r)
  int r1;       // bytes of a query's buffer: its lists, then its sort
  int qbytes;   // bytes of one query's region
  int smem;     // bytes of shared memory per CTA
};

// The layout of K3 at (r, cap, L0); qb = 0 when not even one query's
// region fits. A query's region holds its staged lists, later the
// exchanges of its warps' sort and its sorted keys and lanes (8 * cap
// bytes), then 129 lane offsets and the survivors' span; its size is 16 bytes past a multiple of
// 128, so that the queries of one load instruction write to distinct
// banks. Up to 4 queries a CTA, as long as the CTA keeps to 8 warps and
// its shared memory.
inline TailLayout tail_layout(int r, int cap, int L0) {
  TailLayout t;
  t.lr = L0 < r ? L0 : r;
  t.wq = cap > WARP_N ? cap / WARP_N : 1;
  const int staged = 4 * LANES * t.lr;
  t.r1 = staged > 8 * cap ? staged : 8 * cap;
  t.qbytes = (t.r1 + META + 127) / 128 * 128 + 16;
  t.qb = MAX_QB;
  while (t.qb > 0 && (t.qb * t.qbytes > TAIL_SMEM_CAP ||
                      32 * t.wq * t.qb > MAX_THREADS))
    t.qb >>= 1;
  t.threads = 32 * t.wq * t.qb;
  t.smem = t.qb * t.qbytes;
  return t;
}

// Key of lane l at slot i of a staged query (INT_MAX past the r slots).
__device__ __forceinline__ int lane_key(const int* stg, int lr, int l,
                                        int i) {
  return i < lr ? stg[i * LANES + l] : INT_MAX;
}

// How many composites of lanes t + 32 a (a < 4) are <= tt[a], into c[a]
// (each lane's L0 keys sorted, L0 a power of two): key * 128 + l <= t
// exactly when key <= floor((t - l) / 128). The four binary searches run
// in lockstep, so their loads overlap.
__device__ __forceinline__ void count4(const int* stg, int lr, int L0,
                                       int t, const long long (&tt)[4],
                                       int (&c)[4]) {
  long long kt[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    kt[a] = (tt[a] - (t + 32 * a)) >> 7;
    c[a] = 0;
  }
  for (int s = L0 >> 1; s > 0; s >>= 1)
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if ((long long)lane_key(stg, lr, t + 32 * a, c[a] + s - 1) <= kt[a])
        c[a] += s;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    c[a] += (long long)lane_key(stg, lr, t + 32 * a, c[a]) <= kt[a];
}

// 1. The lists of queries q0 .. q0 + nv - 1 into their regions, query
// fastest, W queries a load (nq, q0 and qb multiples of W).
template <int W>
__device__ __forceinline__ void load_lists(const int* __restrict__ rows,
                                           unsigned char* sm, int qbytes,
                                           int nq, int q0, int nv, int qb,
                                           int lr) {
  using Vec = typename VecOf<W>::type;
  constexpr int B = 8;  // loads in flight per thread
  const int per = qb / W, total = lr * LANES * per;
  for (int i0 = threadIdx.x; i0 < total; i0 += blockDim.x * B) {
    Vec v[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b * blockDim.x, e = i / per, q = i % per * W;
      if (i < total && q < nv)
        v[b] = __ldg(reinterpret_cast<const Vec*>(rows + (size_t)e * nq +
                                                  q0 + q));
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b * blockDim.x, e = i / per, q = i % per * W;
      if (i < total && q < nv) {
#pragma unroll
        for (int u = 0; u < W; ++u)
          ((int*)(sm + (size_t)(q + u) * qbytes))[e] = part(v[b], u);
      }
    }
  }
}

// 2-3. A warp's query: the cap-th composite T by bisection, then each
// lane's prefix of survivors and its offset, into off[0 .. 128]; the
// least composite, a survivor, to lo0.
__device__ __forceinline__ long long find_prefixes(const int* st, int* off,
                                                   int lr, int L0, int cap,
                                                   int t, long long& lo0) {
  const int j = (cap + LANES - 1) / LANES - 1;  // slot bounding T above
  long long lo = LLONG_MAX, hi = LLONG_MIN;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int l = t + 32 * a;
    lo = min(lo, (long long)lane_key(st, lr, l, 0) * LANES + l);
    hi = max(hi, (long long)lane_key(st, lr, l, j) * LANES + l);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, o));
    hi = max(hi, __shfl_xor_sync(FULL, hi, o));
  }
  lo0 = lo;
  // count(<= hi) >= cap, count(< lo) = 0: bisect to the least t with
  // count(<= t) >= cap
  int p[4];
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const long long tt[4] = {mid, mid, mid, mid};
    count4(st, lr, L0, t, tt, p);
    if (__reduce_add_sync(FULL, p[0] + p[1] + p[2] + p[3]) >= cap)
      hi = mid;
    else
      lo = mid + 1;
  }
  const long long T = lo;
  const long long tb[4] = {T - 1, T - 1, T - 1, T - 1};
  count4(st, lr, L0, t, tb, p);
  const int below = __reduce_add_sync(FULL, p[0] + p[1] + p[2] + p[3]);
  const int lt = (int)(T & (LANES - 1));  // T's lane holds its copies
#pragma unroll
  for (int a = 0; a < 4; ++a)
    if (t + 32 * a == lt) p[a] += cap - below;
  int carry = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    int x = p[a];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d);
      if (t >= d) x += y;
    }
    off[32 * a + t] = carry + x - p[a];
    carry += __shfl_sync(FULL, x, 31);
  }
  if (t == 0) off[LANES] = cap;
  return T;
}

// The lane whose prefix holds survivor `pos` (off nondecreasing).
__device__ __forceinline__ int lane_of(const int* off, int pos) {
  int l = 0;
#pragma unroll
  for (int s = LANES / 2; s > 0; s >>= 1)
    if (off[l + s] <= pos) l += s;
  return l;
}

// log2 of the values a warp holds at EPT a thread.
template <int EPT>
__host__ __device__ constexpr int log_warp() {
  if constexpr (EPT > 1)
    return 1 + log_warp<EPT / 2>();
  else
    return 5;
}

// Steps j = 2^(ltop - 1) .. 1 of bitonic stage k over the values a warp
// holds, thread t at positions g0 + t * EPT + e of its query's sequence:
// a partner at distance j >= EPT sits in thread t ^ (j / EPT) (a
// shuffle), a nearer one in this thread (a register swap). Stage k
// sorts ascending where bit k of the position is 0.
template <typename V, int EPT>
__device__ __forceinline__ void warp_steps(V (&v)[EPT], int t, int g0, int k,
                                           int ltop) {
#pragma unroll
  for (int lj = log_warp<EPT>() - 1; lj >= 0; --lj) {
    if (lj >= ltop) continue;
    const int j = 1 << lj;
    if (j >= EPT) {
      const bool lower = (t & (j / EPT)) == 0;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const bool asc = ((g0 + t * EPT + e) & k) == 0;
        const V o = __shfl_xor_sync(FULL, v[e], j / EPT);
        v[e] = asc == lower ? min(v[e], o) : max(v[e], o);
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        if ((e ^ j) > e) {
          const bool asc = ((g0 + t * EPT + e) & k) == 0;
          const V a = v[e], b = v[e ^ j];
          v[e] = asc ? min(a, b) : max(a, b);
          v[e ^ j] = asc ? max(a, b) : min(a, b);
        }
      }
    }
  }
}

// Position pos of a warp's sorted keys (lanes) in shared memory: rows of
// 32 words with the column xor-ed by the row, so that the blocked writes
// and the strided reads both meet 32 banks.
__device__ __forceinline__ int swz(int pos) {
  return (pos & ~31) | ((pos ^ (pos >> 5)) & 31);
}

// A query's cap survivors (prefixes at off) sorted by its wq warps, warp
// w holding positions w * 32 * EPT .. in registers: as composites (V =
// long long) or as their distance from the least one lo0 (V = unsigned:
// one compare and one shuffle a step), then written over the query's
// buffer xb: keys at xb[swz(pos)], lanes at xb[cap + swz(pos)]. Every
// warp of the CTA calls it with the same cap and wq (a warp of no query
// with valid = false): its steps across warps take CTA barriers.
template <typename V, int EPT>
__device__ __forceinline__ void sort_survivors(int* xb, const int* off,
                                               int lr, int cap, int wq, int w,
                                               int t, long long lo0,
                                               bool valid) {
  constexpr int NW = 32 * EPT;  // values of a warp
  constexpr int LOGNW = log_warp<EPT>();
  const V pad = sizeof(V) == 4 ? (V)~0u : (V)LLONG_MAX;  // sorts last
  const long long base = sizeof(V) == 4 ? lo0 : 0;
  const int g0 = w * NW;
  V v[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int pos = g0 + t * EPT + e;
    v[e] = pad;
    if (valid && pos < cap) {
      const int l = lane_of(off, pos);
      v[e] = (V)((long long)lane_key(xb, lr, l, pos - off[l]) * LANES + l -
                 base);
    }
  }
#pragma unroll
  for (int lk = 1; lk <= LOGNW; ++lk) warp_steps<V, EPT>(v, t, g0, 1 << lk, lk);
  __syncthreads();  // every warp has read its lists: xb is free
  V* ex = reinterpret_cast<V*>(xb);  // [warp][e][thread]
  for (int k = 2 * NW; k <= wq * NW; k <<= 1) {
    for (int j = k / 2; j >= NW; j >>= 1) {
      const int pw = w ^ (j / NW);
      const bool lower = (w & (j / NW)) == 0;
      if (valid) {
#pragma unroll
        for (int e = 0; e < EPT; ++e) ex[(w * EPT + e) * 32 + t] = v[e];
      }
      __syncthreads();
      if (valid) {
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          const V o = ex[(pw * EPT + e) * 32 + t];
          const bool asc = ((g0 + t * EPT + e) & k) == 0;
          v[e] = asc == lower ? min(v[e], o) : max(v[e], o);
        }
      }
      __syncthreads();
    }
    warp_steps<V, EPT>(v, t, g0, k, LOGNW);
  }
  if (!valid) return;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int pos = g0 + t * EPT + e;
    if (pos < cap) {
      const long long x = (long long)v[e] + base;
      xb[swz(pos)] = (int)(x >> 7);  // floor(x / 128)
      xb[cap + swz(pos)] = (int)(x & (LANES - 1));
    }
  }
}

// K3: CTA of qb queries, wq warps a query, EPT values a thread.
template <int EPT, int W>
__global__ void __launch_bounds__(MAX_THREADS)
    tail_merge_kernel(const int* __restrict__ rows, int* __restrict__ keys,
                      int* __restrict__ lanes, int nq, int cap, int L0,
                      int lr, int qb, int wq, int r1, int qbytes) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int q0 = blockIdx.x * qb;
  const int nv = min(qb, nq - q0);
  load_lists<W>(rows, sm, qbytes, nq, q0, nv, qb, lr);
  __syncthreads();
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int q = warp; q < nv; q += nwarps) {  // 2-3: a warp a query
    long long lo0;
    const long long T =
        find_prefixes((int*)(sm + (size_t)q * qbytes),
                      (int*)(sm + (size_t)q * qbytes + r1), lr, L0, cap, t,
                      lo0);
    if (t == 0) {  // the query's span, for its warps' choice of V
      long long* span =
          (long long*)(sm + (size_t)q * qbytes + r1 + 4 * (LANES + 2));
      span[0] = lo0;
      span[1] = T;
    }
  }
  __syncthreads();
  // 4: one value type for the whole CTA (its steps across warps are CTA
  // barriers): 32-bit where every query's survivors span < 2^32
  const int q = warp / wq, w = warp % wq;
  const bool valid = q < nv;
  unsigned char* reg = sm + (size_t)(valid ? q : 0) * qbytes;
  const long long* span = (const long long*)(reg + r1 + 4 * (LANES + 2));
  const long long lo0 = span[0];
  const bool narrow = __syncthreads_and(!valid || span[1] - lo0 < 0xFFFFFFFFll);
  int* xb = (int*)reg;
  const int* off = (const int*)(reg + r1);
  if (narrow)
    sort_survivors<unsigned, EPT>(xb, off, lr, cap, wq, w, t, lo0, valid);
  else
    sort_survivors<long long, EPT>(xb, off, lr, cap, wq, w, t, lo0, valid);
  if (!valid) return;
  __syncwarp();
  // 5: a warp writes its own positions
  const int nw = 32 * EPT;
  for (int i = w * nw + t; i < min(cap, (w + 1) * nw); i += 32) {
    keys[(size_t)(q0 + q) * cap + i] = xb[swz(i)];
    lanes[(size_t)(q0 + q) * cap + i] = xb[cap + swz(i)];
  }
}

}  // namespace

extern "C" int rq_tail_merge(const void* rows, void* keys, void* lanes,
                             int r, int nq, int cap, int L0, void* stream) {
  const TailLayout t = tail_layout(r, cap, L0);
  if (t.qb == 0 || (cap & (cap - 1)) || (L0 & (L0 - 1)) || L0 > LANES)
    return (int)cudaErrorInvalidValue;
  const int grid = (nq + t.qb - 1) / t.qb;
  // four queries a load where rows, nq and qb keep them aligned
  const int w = (size_t)rows % 16 == 0 && nq % 4 == 0 && t.qb % 4 == 0
                    ? 4 : 1;
  const int ept = cap >= WARP_N ? 32 : cap <= 32 ? 1 : cap / 32;
  cudaStream_t st = (cudaStream_t)stream;
#define RQ_K3(E, V)                                                         \
  if (ept == E && w == V) {                                                 \
    auto kern = tail_merge_kernel<E, V>;                                    \
    cudaError_t e = cudaFuncSetAttribute(                                   \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem);         \
    if (e != cudaSuccess) return (int)e;                                    \
    kern<<<grid, t.threads, t.smem, st>>>(                                  \
        (const int*)rows, (int*)keys, (int*)lanes, nq, cap, L0, t.lr, t.qb, \
        t.wq, t.r1, t.qbytes);                                              \
    return (int)cudaGetLastError();                                         \
  }
#define RQ_K3W(E) RQ_K3(E, 1) RQ_K3(E, 4)
  RQ_K3W(1) RQ_K3W(2) RQ_K3W(4) RQ_K3W(8) RQ_K3W(16) RQ_K3W(32)
#undef RQ_K3W
#undef RQ_K3
  return (int)cudaErrorInvalidValue;
}

// K3's layout at (r, cap, L0) into out[5]: queries per CTA, threads per
// CTA, slots staged per lane, bytes of one query's region, bytes of
// shared memory per CTA (scan._tail_layout mirrors it).
extern "C" int rq_tail_layout(int r, int cap, int L0, void* out) {
  const TailLayout t = tail_layout(r, cap, L0);
  int* o = (int*)out;
  o[0] = t.qb;
  o[1] = t.threads;
  o[2] = t.lr;
  o[3] = t.qbytes;
  o[4] = t.smem;
  return t.qb == 0 ? (int)cudaErrorInvalidValue : 0;
}
