"""The fusion probe: does an extra elementwise op cost the card anything
before the stream of its operand does? (counterpart of the JAX package's
`demos/bench_mosaic_fusion.py`, which asked whether Mosaic gives each
chained elementwise op a pass over the block.)

    python -m rayuela_tpu_torch.demos.fusion_probe            # on the card
    python -m rayuela_tpu_torch.demos.fusion_probe --device cpu --rows 65536
    python3 rayuela_tpu_torch/demos/fusion_probe.py --root DIR  # DIR's kernel

X (rows, 256) f32, 1 GiB at the JAX probe's 1,048,576 rows; y = X, then k
times ``y = y * 1.0000001 + 0.5`` (each product and sum rounded to f32);
out (8, 256) the minimum of y over the rows of each class mod 8, which
keeps the chain alive. Kernel: `fusion_chain` (source
``rayuela_tpu_torch/csrc/fusion_probe.cu``), in two source forms like
the TPU probe's (one statement per op, or one nested expression), for
k in 0, 1, 2, 4, 8. On the card each call is timed by CUDA events (the
mean of 20 back-to-back calls after a warm one, so that the host's work
for a call overlaps the card's on the one before), held bit for bit
against the plain version, and set beside the stream's bound (the bytes
of X over 3.35 TB/s) and, at k = 0, the library's `amin`, timed the same
way; torch.profiler gives the device time of each kernel a call
launches (`amin`'s too); the two forms' registers come from the
compiled kernels. On the CPU the plain version runs alone (host
clock: no device time). ``--root DIR`` imports ``rayuela_tpu_torch`` from
DIR (an unpacked earlier commit; run this file by its path, not with
``-m``) and times that tree's kernel the same way, so two versions run on
one card in one call.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROWS, COLS = 1 << 20, 256          # the JAX probe's 128 blocks of 8192
KS = (0, 1, 2, 4, 8)
MUL, ADD = 1.0000001, 0.5
HBM = 3.35e12                      # bytes/s, one H100 SXM


def fusion_chain_plain(X: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of `fusion_chain` (same signature and output)."""
    y = X
    for _ in range(k):
        y = y * MUL + ADD
    return y.view(-1, 8, COLS).amin(0)


def fusion_chain(X: torch.Tensor, k: int, *, split: bool = True
                 ) -> torch.Tensor:
    """The fusion probe's kernel: ``X (rows, 256)`` f32, rows a multiple
    of 8 → ``(8, 256)`` f32, the minimum over each row class mod 8 of X
    after k chained ``y * 1.0000001 + 0.5`` (k in 0, 1, 2, 4, 8);
    ``split`` picks the source form (one statement per op, or one
    expression). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if X.dtype != torch.float32 or X.dim() != 2 or X.shape[1] != COLS \
            or X.shape[0] % 8 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous (rows, {COLS}) float32 "
                         "with rows a multiple of 8")
    if k not in KS:
        raise ValueError(f"k={k}: the kernel takes {KS}")
    if X.device.type == "cpu":
        return fusion_chain_plain(X, k)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.shape[0] >= 1 << 31:
        raise ValueError("rows must fit an int32")
    from rayuela_tpu_torch.kernels.build import launch
    nparts, group = _layout(k, split, X.device)
    ngroups = -(-nparts // group)
    part = torch.empty((nparts + ngroups, 8, COLS), dtype=torch.float32,
                       device=X.device)
    tickets = torch.zeros(ngroups + 1, dtype=torch.int32, device=X.device)
    out = torch.empty((8, COLS), dtype=torch.float32, device=X.device)
    launch("rq_fusion_chain", X, part, out, tickets, X.shape[0], nparts,
           group, k, int(split), device=X.device)
    fusion_chain.launches += 1
    return out


fusion_chain.launches = 0


@functools.lru_cache(maxsize=None)
def _layout(k: int, split: bool, device: torch.device) -> tuple[int, int]:
    """The kernel's persistent grid at (k, split): ``(CTAs, CTAs a
    group)``, the CTAs as many as the card holds at once, the group about
    their square root (`rq_fusion_layout`)."""
    from rayuela_tpu_torch.kernels.build import query
    return query("rq_fusion_layout", k, int(split), size=2, device=device)


def kernel_attrs(k: int, split: bool, device) -> tuple[int, int]:
    """``(registers, local bytes)`` of a thread of the compiled chain
    kernel at (k, split)."""
    from rayuela_tpu_torch.kernels.build import query
    return query("rq_fusion_attrs", k, int(split), size=2,
                 device=torch.device(device))


def mean_ms(fn, reps: int, on_card: bool) -> float:
    """Mean ms of ``reps`` back-to-back calls of ``fn`` after a warm one:
    CUDA events around the run on the card, the host clock on the
    CPU."""
    fn()
    if not on_card:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def launch_ms(fn, reps: int) -> dict[str, float]:
    """Device ms of a launch of each kernel ``fn`` calls, by name
    (torch.profiler over ``reps`` calls after a warm one: each kernel's
    mean over the launches the profiler recorded, which may miss a
    few)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    short = lambda key: key.replace("(anonymous namespace)::", "") \
        .removeprefix("void ").split("(")[0]
    return {short(e.key): e.device_time_total / 1e3 / e.count
            for e in prof.key_averages() if e.device_time_total > 0}


def main(argv=None) -> dict:
    """Run the probe and print its lines → its results: ``ms`` and
    ``plain_ms`` by (form, k), the bound, the library's ``amin``, the
    slope per extra op, the registers by (form, k) and ``launch_ms`` (the
    device ms of a launch by kernel, by (form, k)) on the card, and
    ``equal``: every kernel output equal to the plain version's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    probe = _probe(args.root)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((args.rows, COLS),
                                            dtype=np.float32), device=dev)
    gib = X.numel() * 4 / 2 ** 30
    bound = X.numel() * 4 / HBM * 1e3
    clock = ("CUDA events" if on_card
             else "host clock, plain version only")
    print(f"fusion probe ({Path(probe.__file__).resolve().parents[2]}): X "
          f"({args.rows}, {COLS}) f32, {gib:.3f} GiB streamed a call; bound "
          f"{bound:.4f} ms (bytes / 3.35 TB/s); {clock}; mean of "
          f"{args.reps} back-to-back calls")
    res = {"ms": {}, "plain_ms": {}, "regs": {}, "launch_ms": {},
           "bound_ms": bound, "equal": True, "rows": args.rows}
    amin = lambda: X.view(-1, 8, COLS).amin(0)
    lib = mean_ms(amin, args.reps, on_card)
    res["library_ms"] = lib
    if on_card:
        res["library_launch_ms"] = launch_ms(amin, args.reps)
    for k in KS:
        pms = mean_ms(lambda: fusion_chain_plain(X, k), args.reps, on_card)
        ref = fusion_chain_plain(X, k)
        res["plain_ms"][k] = pms
        line = f"  k={k}: plain {pms:.4f} ms"
        for split in ((True, False) if on_card else ()):
            form = "split" if split else "one-expr"
            call = functools.partial(probe.fusion_chain, X, k, split=split)
            ms = mean_ms(call, args.reps, on_card)
            same = bool(torch.equal(call(), ref))
            regs = probe.kernel_attrs(k, split, dev)
            apart = launch_ms(call, args.reps)
            res["ms"][(form, k)], res["regs"][(form, k)] = ms, regs
            res["launch_ms"][(form, k)] = apart
            res["equal"] &= same
            line += (f"; {form} {ms:.4f} ms ({regs[0]} registers, "
                     f"{regs[1]} local bytes), equal to plain: {same}, by "
                     "kernel: " + ", ".join(f"{n} {t:.4f} ms"
                                            for n, t in apart.items()))
        print(line)
    print(f"  library amin (the k=0 function) {lib:.4f} ms" + (
        ", by kernel: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                    res["library_launch_ms"].items())
        if on_card else ""))
    if not on_card:
        return res
    ks = np.array([1, 2, 4, 8], float)
    for form in ("split", "one-expr"):
        slope = float(np.polyfit(ks, [res["ms"][(form, int(k))]
                                      for k in ks], 1)[0])
        res[f"slope_{form}"] = slope
    base, slope = res["ms"][("split", 0)], res["slope_split"]
    apart = abs(res["ms"][("split", 8)] - res["ms"][("one-expr", 8)]) \
        / res["ms"][("one-expr", 8)]
    same_regs = all(res["regs"][("split", k)] == res["regs"][("one-expr", k)]
                    for k in KS)
    print(f"  slope {slope * 1e3:+.2f} us per extra op (split; one-expr "
          f"{res['slope_one-expr'] * 1e3:+.2f}); k=0 {base:.4f} ms = "
          f"{bound / base:.3f} of the bound; split vs one-expr at k=8 "
          f"{apart * 100:.2f}% apart, the same registers at every k: "
          f"{same_regs}")
    res["same_regs"], res["apart8"] = same_regs, apart
    print(f"  k=0: split {base:.4f} ms against amin {lib:.4f} ms "
          f"({lib / base:.3f}x) and the bound {bound:.4f} ms "
          f"({bound / base:.3f} of it)")
    if 8 * abs(slope) <= 0.05 * base:
        print(f"VERDICT: an extra elementwise op costs the card nothing "
              f"before the stream does: 8 ops move the call by "
              f"{8 * slope * 1e3:+.2f} us of {base * 1e3:.1f} (the chain "
              f"runs under the 1 GiB read)")
    else:
        print(f"VERDICT: each elementwise op costs {slope * 1e3:.2f} us, "
              f"{slope / base * 100:.2f}% of the k=0 call: the chain does "
              f"not hide under the stream")
    return res


def _probe(root):
    """The fusion probe whose kernel `main` times: this module, or with
    ``root`` the one of the package under root (this file run by its
    path)."""
    if root is None and __name__ != "__main__":
        return sys.modules[__name__]
    root = root or str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, root)
    mod = importlib.import_module("rayuela_tpu_torch.demos.fusion_probe")
    if not Path(mod.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise SystemExit(f"rayuela_tpu_torch was imported from "
                         f"{mod.__file__}, not from {root}: run this file "
                         "by its path")
    return mod


if __name__ == "__main__":
    main()
