"""The fusion probe: does an extra elementwise op cost the card anything
before the stream of its operand does? (counterpart of the JAX package's
`demos/bench_mosaic_fusion.py`, which asked whether Mosaic gives each
chained elementwise op a pass over the block.)

    python -m rayuela_tpu_torch.demos.fusion_probe            # on the card
    python -m rayuela_tpu_torch.demos.fusion_probe --device cpu --rows 65536

X (rows, 256) f32, 1 GiB at the JAX probe's 1,048,576 rows; y = X, then k
times ``y = y * 1.0000001 + 0.5`` (each product and sum rounded to f32);
out (8, 256) the minimum of y over the rows of each class mod 8, which
keeps the chain alive. Kernel: `fusion_chain` (source
``rayuela_tpu_torch/csrc/fusion_probe.cu``), in two source forms like
the TPU probe's (one statement per op, or one nested expression), for
k in 0, 1, 2, 4, 8. On the card each call is timed by CUDA events (best
of 5), held bit for bit against the plain version, and set beside the
stream's bound (the bytes of X over 3.35 TB/s) and, at k = 0, the
library's `amin`; the two forms' registers come from the compiled
kernels. On the CPU the plain version runs alone (host clock: no device
time).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rayuela_tpu_torch.demos import best_ms
from rayuela_tpu_torch.kernels.build import launch, query

ROWS, COLS = 1 << 20, 256          # the JAX probe's 128 blocks of 8192
KS = (0, 1, 2, 4, 8)
MUL, ADD = 1.0000001, 0.5
# CTAs of the kernel's first pass (each takes a contiguous run of rows);
# its second pass takes the minimum over their partial (8, 256) blocks
NPARTS = 1024
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
    nparts = max(1, min(NPARTS, X.shape[0] // 8))
    part = torch.empty((nparts, 8, COLS), dtype=torch.float32,
                       device=X.device)
    out = torch.empty((8, COLS), dtype=torch.float32, device=X.device)
    launch("rq_fusion_chain", X, part, out, X.shape[0], nparts, k,
           int(split), device=X.device)
    fusion_chain.launches += 1
    return out


fusion_chain.launches = 0


def kernel_attrs(k: int, split: bool, device) -> tuple[int, int]:
    """``(registers, local bytes)`` of a thread of the compiled chain
    kernel at (k, split)."""
    return query("rq_fusion_attrs", k, int(split), size=2,
                 device=torch.device(device))


def main(argv=None) -> dict:
    """Run the probe and print its lines → its results: ``ms`` and
    ``plain_ms`` by (form, k), the bound, the library's ``amin``, the
    slope per extra op, the registers by (form, k) (on the card), and
    ``equal``: every kernel output equal to the plain version's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((args.rows, COLS),
                                            dtype=np.float32), device=dev)
    gib = X.numel() * 4 / 2 ** 30
    bound = X.numel() * 4 / HBM * 1e3
    clock = "CUDA events" if on_card else "host clock, plain version only"
    print(f"fusion probe: X ({args.rows}, {COLS}) f32, {gib:.3f} GiB "
          f"streamed a call; bound {bound:.4f} ms (bytes / 3.35 TB/s); "
          f"{clock}; best of {args.reps}")
    res = {"ms": {}, "plain_ms": {}, "regs": {}, "bound_ms": bound,
           "equal": True, "rows": args.rows}
    lib = best_ms(lambda: X.view(-1, 8, COLS).amin(0), args.reps, on_card)
    res["library_ms"] = lib
    for k in KS:
        pms = best_ms(lambda: fusion_chain_plain(X, k), args.reps, on_card)
        ref = fusion_chain_plain(X, k)
        res["plain_ms"][k] = pms
        line = f"  k={k}: plain {pms:.4f} ms"
        for split in ((True, False) if on_card else ()):
            form = "split" if split else "one-expr"
            ms = best_ms(lambda: fusion_chain(X, k, split=split),
                          args.reps, on_card)
            same = bool(torch.equal(fusion_chain(X, k, split=split), ref))
            regs = kernel_attrs(k, split, dev)
            res["ms"][(form, k)], res["regs"][(form, k)] = ms, regs
            res["equal"] &= same
            line += (f"; {form} {ms:.4f} ms ({regs[0]} registers, "
                     f"{regs[1]} local bytes), equal to plain: {same}")
        print(line)
    print(f"  library amin (the k=0 function) {lib:.4f} ms")
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


if __name__ == "__main__":
    main()
