"""Profile the decoded-index search at k = 1000 and 100: how much of it is
the scan kernel K8 and how much the candidate processing after it
(counterpart of the JAX package's `demos/profile_scan_tail.py`, which
re-issued the decoded scan's Pallas kernel to time it alone).

    python -m rayuela_tpu_torch.demos.profile_scan_tail          # on the card
    python -m rayuela_tpu_torch.demos.profile_scan_tail --device cpu \\
        --n 70000 --nq 64

PQ-8, h = 256, n = 1e6, d = 128, nq = 1e4 from ``default_rng(0)``, as the
JAX probe; the decoded index is bfloat16 on the card. For each k, at the
plan's (r, keep, tile) (`scan._scan_config`), the best of 3 calls, each
timed to a synchronize (CUDA events on the card, the host clock on the
CPU, where the plain versions run):

1. `scan.search`, end to end;
2. `scan.scan_topk_packed`: K8 → K2 → K3 and the flags, no rescue;
3. K8 alone (`scan.scan_candidates`): the JAX probe's kernel-only call;
4. K2 → K3 and the flag test on (3)'s output: its raw-output call
   followed by the candidate processing;
5. `torch.topk` alone over the (nq, r·128) keys of K2's buffer;
6. `torch.sort` alone over them.

(3)'s output on the first 256 queries, merged and cut to the top-k by
the plain versions, is held against `scan_candidates_plain` on those
queries: at least 99.9% of ids equal by position and every score within
one truncation step (the kernel sums in dimension order, the plain
version through the library's matmul).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rayuela_tpu_torch.demos import best_ms
from rayuela_tpu_torch.search import scan

N, D, M, H, NQ = 1_000_000, 128, 8, 256, 10_000
SUBSET = 256


def plain_topk(outp, r: int, k: int, idbits: int, score16: bool = False):
    """The top-k of a (r + 1, 128, nq) key buffer by the plain cross-lane
    merge → (truncated scores, ids, flagged): `scan._finish` with the
    plain version of K3 (``score16``: the keys are `scan._row_key16`'s)."""
    rpad = 1 << max(0, (r - 1).bit_length())
    cap = min(1 << max(0, (k - 1).bit_length()), rpad * scan.LANES)
    keys, lanes = scan.tail_merge_plain(outp[:r].contiguous(), cap)
    sk = keys[:, :k]
    ids = (sk & ((1 << idbits) - 1)) * scan.LANES + lanes[:, :k]
    flagged = (outp[r] < sk[:, k - 1][None, :]).any(0)
    return scan._decode_packed_vals(sk, idbits, score16), ids, flagged


def main(argv=None) -> dict:
    """Run the probe and print its lines → ``{k: {step: ms}}`` with, per
    k, the subset check (``ids_equal``, ``within_step``) and K8's
    launches in the probe (``launches``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--nq", type=int, default=NQ)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)
    C = torch.as_tensor(rng.standard_normal((M, H, D // M)),
                        dtype=torch.float32, device=dev)
    B = torch.as_tensor(rng.integers(0, H, size=(args.n, M)),
                        dtype=torch.int32, device=dev)
    Q = torch.as_tensor(rng.standard_normal((args.nq, D)),
                        dtype=torch.float32, device=dev)
    index = scan.build_index(C, B, pq=True, d=D)
    Xd, x2 = index.Xd, index.x2
    Qm = scan._query_operand(Q, Xd.shape[1], Xd.dtype)
    nq = Q.shape[0]
    print(f"scan-tail probe: PQ-8 decoded index ({Xd.dtype}), n={args.n}, "
          f"d={D}, nq={nq}; best of {args.reps}, "
          f"{'CUDA events' if on_card else 'host clock, plain versions'}")
    out, k8 = {}, scan.scan_candidates.launches
    for k in (1000, 100):
        r, keep, tile = scan._scan_config(k)
        idbits = scan._pack_idbits(-(-args.n // tile) * tile)
        kw = dict(tile=tile, keep=keep, premin=0, idbits=idbits)
        ms = {}
        ms["search"] = best_ms(lambda: scan.search(index, Q, k), args.reps,
                                on_card)
        ms["scan_topk_packed"] = best_ms(lambda: scan.scan_topk_packed(
            Q, Xd, x2, k=k, r=r, tile=tile, keep=keep), args.reps, on_card)
        ms["K8"] = best_ms(lambda: scan.scan_candidates(Qm, Xd, x2, **kw),
                            args.reps, on_card)
        cand, disc = scan.scan_candidates(Qm, Xd, x2, **kw)
        # K8's bound: its products at the operand type's peak (bf16 on the
        # tensor cores, f32 on the CUDA cores of an H100 SXM), or its bytes
        # (each input read, each output written once) at 3.35 TB/s
        peak = 989e12 if Xd.dtype == torch.bfloat16 else 67e12
        moved = sum(t.numel() * t.element_size()
                    for t in (Qm, Xd, x2, cand, disc))
        bound = max(2.0 * args.n * nq * Xd.shape[1] / peak, moved / 3.35e12)
        ms["K2+K3+flags"] = best_ms(lambda: scan._finish(
            scan.cand_merge(cand, disc, r, cut=True), nq, r, k, idbits),
            args.reps, on_card)
        outp = scan.cand_merge(cand, disc, r, cut=True)
        keys = outp[:r].reshape(r * scan.LANES, nq).T.contiguous()
        ms["topk"] = best_ms(lambda: torch.topk(keys, k, dim=1,
                                                 largest=False),
                              args.reps, on_card)
        ms["sort"] = best_ms(lambda: torch.sort(keys, dim=1), args.reps,
                              on_card)
        sub = slice(0, min(SUBSET, nq))
        got = plain_topk(scan.cand_merge_plain(
            cand[:, :, sub].contiguous(), disc[:, :, sub].contiguous(), r),
            r, k, idbits)
        ref = plain_topk(scan.cand_merge_plain(*scan.scan_candidates_plain(
            Qm[sub].contiguous(), Xd, x2, **kw), r), r, k, idbits)
        same = float((got[1] == ref[1]).float().mean())
        step = 2.0 ** (idbits - 23)
        within = bool(((got[0] - ref[0]).abs()
                       <= step * torch.maximum(got[0].abs(),
                                               ref[0].abs())).all())
        out[k] = dict(ms, r=r, keep=keep, tile=tile, ids_equal=same,
                      within_step=within, k8_bound_ms=bound * 1e3)
        print(f" k={k} (r={r}, keep={keep}, tile={tile}): "
              + ", ".join(f"{name} {v:.3f} ms" for name, v in ms.items())
              + f"; K8's bound {bound * 1e3:.3f} ms")
        print(f"  K8 share of the search {ms['K8'] / ms['search']:.3f}; "
              f"K8 on the first {sub.stop} queries against its plain "
              f"version: ids equal by position {same:.6f}, scores within "
              f"one truncation step: {within}")
        del cand, disc, outp, keys
    out["launches"] = scan.scan_candidates.launches - k8
    return out


if __name__ == "__main__":
    main()
