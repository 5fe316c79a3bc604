"""What bounds K13's min-plus and the pair merge's insertions on the card.

    python3 rayuela_tpu_torch/demos/probe_minplus.py [--reps N]

Each line is one JSON object (the first names the card and its power
limit; CUDA events):

- the issue rate of the min-plus's two instructions, from a
  microbenchmark compiled here with nvcc (into ``rayuela_tpu_torch/
  _build/``): 32 independent chains a thread of ``m = min(m, f + b)``
  (FADD + FMNMX), of FADD alone, and a model of K13's inner loop (4
  labels x 8 vectors a thread, a row of bin from shared memory, f
  broadcast: the shape of `minplus_row` in ``csrc/viterbi.cu`` written
  out here, not the kernel's own code, so a change to the kernel does
  not reach it), two CTAs of 8 warps an SM; rates in pairs a cycle an
  SM at the nominal 1.98 GHz;
- K13 (`viterbi_encode`) on n = 1e5 Gaussian vectors, h = 256, d = 16, at
  m = 7 and 15: the time of one stage of the min-plus is the difference
  over 8 stages (the unaries of 16 dimensions cost little), beside the
  floor the first rate sets;
- the pair merge (`scan.pair_merge`) at the k = 100 / 1000 / 3072 plans
  of the card's f32 plan on K9's candidates over n = 1e6 rows, d = 128,
  nq = 1e4, and on candidates of the same shape whose scores rise row
  after row (nothing enters after the first rows: the loads and compares
  alone); the difference is what its insertions cost.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CLOCK = 1.98e9          # H100 SXM boost clock (Hz)
N, H = 100_000, 256

_SRC = r"""
#include <cuda_runtime.h>
template <int MODE>
__global__ void __launch_bounds__(256, 2) minplus(float* out, int iters) {
  __shared__ __align__(16) float fs[256 * 32];
  __shared__ __align__(16) float ts[8 * 256];
  const int tid = threadIdx.x;
  for (int i = tid; i < 256 * 32; i += 256) fs[i] = (i * 37 % 101) * 0.01f;
  for (int i = tid; i < 8 * 256; i += 256) ts[i] = (i * 53 % 97) * 0.01f;
  __syncthreads();
  float acc = 0.f;
  if (MODE < 2) {  // chains: FADD + FMNMX, or FADD alone
    float a[32], b[32], c = 1.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) { a[j] = tid + j; b[j] = j * 0.5f; }
    for (int it = 0; it < iters * 256; ++it) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        a[j] = MODE == 0 ? fminf(a[j], b[j] + c) : a[j] + c;
      c += 1e-7f;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) acc += a[j];
  } else {  // a model of K13's loop: 4 labels x 8 vectors, bin's row from
            // shared memory
    const int lg = tid % 64, vg = tid / 64;
    float mn[4][8];
#pragma unroll
    for (int l = 0; l < 4; ++l)
#pragma unroll
      for (int v = 0; v < 8; ++v) mn[l][v] = 1e30f;
    for (int it = 0; it < iters; ++it) {
#pragma unroll 2
      for (int r = 0; r < 256; ++r) {
        const float4 bv = *(const float4*)(ts + (r & 7) * 256 + 4 * lg);
        const float4 f0 = *(const float4*)(fs + r * 32 + 8 * vg);
        const float4 f1 = *(const float4*)(fs + r * 32 + 8 * vg + 4);
        const float b[4] = {bv.x, bv.y, bv.z, bv.w};
        const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
        for (int l = 0; l < 4; ++l)
#pragma unroll
          for (int v = 0; v < 8; ++v) mn[l][v] = fminf(mn[l][v], f[v] + b[l]);
      }
    }
#pragma unroll
    for (int l = 0; l < 4; ++l)
#pragma unroll
      for (int v = 0; v < 8; ++v) acc += mn[l][v];
  }
  out[blockIdx.x * 256 + tid] = acc;
}
extern "C" int probe_minplus(int mode, int ctas, int iters, void* out,
                             float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {  // the first warms up
    cudaEventRecord(e0);
    if (mode == 0) minplus<0><<<ctas, 256>>>((float*)out, iters);
    if (mode == 1) minplus<1><<<ctas, 256>>>((float*)out, iters);
    if (mode == 2) minplus<2><<<ctas, 256>>>((float*)out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}
"""


def _microbenchmark(build_dir: Path):
    """Compile `_SRC` with nvcc → the loaded library."""
    import ctypes

    from rayuela_tpu_torch.kernels.build import _nvcc
    build_dir.mkdir(parents=True, exist_ok=True)
    src, lib = build_dir / "probe_minplus.cu", build_dir / "probe_minplus.so"
    src.write_text(_SRC)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.probe_minplus.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    so.probe_minplus.restype = ctypes.c_int
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import ctypes

    import numpy as np
    import torch

    from rayuela_tpu_torch.kernels.build import BUILD_DIR
    from rayuela_tpu_torch.ops import viterbi as tvit
    from rayuela_tpu_torch.search import scan as tsp

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    so = _microbenchmark(BUILD_DIR)
    out = torch.empty(2 * sms * 256, device=dev)
    iters = 200
    rates = {}
    for mode, name in ((0, "fadd+fmnmx chains"), (1, "fadd chains"),
                       (2, "model of K13's min-plus loop")):
        t = ctypes.c_float()
        err = so.probe_minplus(mode, 2 * sms, iters, out.data_ptr(),
                               ctypes.addressof(t))
        if err:
            raise RuntimeError(f"probe_minplus: CUDA error {err}")
        pairs = 2 * sms * 256 * iters * 256 * 32
        rates[mode] = pairs / (t.value * 1e-3) / sms / CLOCK
        print(json.dumps({"part": "microbenchmark", "case": name,
                          "ms": t.value,
                          "pairs_per_clock_per_sm": rates[mode]}), flush=True)

    def ms(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((N, 16)), dtype=torch.float32,
                        device=dev)
    times = {}
    for m in (7, 15):
        C = torch.as_tensor(rng.standard_normal((m, H, 16)) * 0.3,
                            dtype=torch.float32, device=dev)
        times[m] = ms(lambda: tvit.viterbi_encode(X, C), args.reps)
        print(json.dumps({"part": "K13", "m": m, "d": 16, "n": N, "h": H,
                          "ms": times[m]}), flush=True)
    stage = (times[15] - times[7]) / 8
    floor = N * H * H / (rates[0] * sms * CLOCK) * 1e3
    print(json.dumps({"part": "K13", "ms_per_stage": stage,
                      "floor_ms_per_stage": floor,
                      "share_of_floor": floor / stage}), flush=True)
    del X

    g = torch.Generator(device=dev).manual_seed(128)
    Xs = torch.randn((1_000_000, 128), generator=g, device=dev)
    Q = torch.randn((10_000, 128), generator=g, device=dev)
    x2 = (Xs * Xs).sum(-1)
    Qm = tsp._query_operand(Q, 128, torch.float32)
    for k in (100, 1000, 3072):
        r, keep, tile, _ = tsp._f32_config(k, dev)
        cv, ci = tsp.scan_f32_candidates(Qm, Xs, x2, tile=tile, keep=keep)
        t = ms(lambda: tsp.pair_merge(cv, ci, r), 2 * args.reps)
        rising = torch.arange(cv.shape[0], dtype=torch.float32,
                              device=dev)[:, None, None].expand_as(cv)
        rising = rising.contiguous()
        t0 = ms(lambda: tsp.pair_merge(rising, ci, r), 2 * args.reps)
        print(json.dumps({"part": "pair_merge", "k": k, "r": r,
                          "ncand": cv.shape[0], "ms": t,
                          "rising_scores_ms": t0,
                          "insertions_ms": t - t0}), flush=True)
        del cv, ci, rising
    return 0


if __name__ == "__main__":
    sys.exit(main())
