"""Probes of the port's kernels: the counterparts of the JAX package's
`demos/profile_scan_tail.py` and `demos/bench_mosaic_fusion.py`. Each
has a ``main()`` that runs on the card, or on the CPU with
``--device cpu`` (the plain versions, timed by the host clock)."""

import time

import torch


def best_ms(fn, reps: int, on_card: bool) -> float:
    """Best of ``reps`` timed calls of ``fn`` after one warm call, each
    to a synchronize: CUDA events on the card, the host clock on the
    CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if on_card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t) * 1e3)
    return best
