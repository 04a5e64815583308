#!/usr/bin/env python3
"""The cluster ring kernels (A4, A5) at each slice size, on one GPU.

    python3 torch_port_ring_sweep.py [--elements 25557032] [--ranks 8]
                                     [--reps 20] [--ptxas]

``horovod_tpu_torch/csrc/ring_cluster.cu`` is compiled at one slice,
128 threads a CTA of 16 elements each.  This script copies it, with the
headers beside it, under ``build/ring_sweep/<threads>/``, sets the copy's
``kThreads`` to 128, 256, 512 and 1024 (slices of 2048 to 16384
elements), compiles the copies in parallel (``--ptxas`` adds
``-Xptxas -v`` and prints each kernel's registers, shared memory and
spills) and runs each through the port's own wrappers.  For each slice:

* what the card gives the kernel (``cluster_info``: registers, spill
  bytes, shared memory and CTAs an SM, clusters resident at once);
* A5 Sum and A4 bitwise against their plain versions at 2, 3, 5 and 8
  ranks of a few thousand elements and, once, at full width;
* the time of A5 Sum and of A4 at ``--ranks`` ranks of ``--elements``
  float32 (the default is the ring phase of ``chip_smoke.py``: 8 ranks of
  ResNet-50's 25,557,032 gradients), by CUDA events, the slices taken in
  turns, forwards and then backwards, beside the bound (each input read
  once, each output written once) and the library calls that fill one
  output and every rank's.

Prints the card's name and power limit, one ``sweep {...}`` line a slice
and pass, and a ``best {...}`` line.  Inputs are random normal from a
seed; the kernels' time does not depend on the values.  Needs one card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import chip_smoke
from chip_smoke import check, log, same_bits, time_cuda

THREADS = (128, 256, 512, 1024)
KTHREADS = "constexpr int kThreads = 128;"
SMALL_RINGS = [(2, 5000), (3, 4000), (5, 3001), (8, 40000)]


def build_copies(ptxas: bool) -> dict:
    """{threads: (library path, ptxas lines)}: a copy of ring_cluster.cu
    at each thread count, compiled in parallel."""
    from horovod_tpu_torch.ops import _build

    built = _build.build_copies(
        "ring_cluster",
        {str(t): {KTHREADS: f"constexpr int kThreads = {t};"}
         for t in THREADS},
        _build.BUILD_DIR.parent / "ring_sweep",
        ["-Xptxas", "-v"] if ptxas else [])
    return {t: (path, [ln.strip() for ln in out.splitlines()
                       if "ptxas info" in ln
                       and ("Used" in ln or "Compiling" in ln)])
            for t, (path, out) in ((int(k), v) for k, v in built.items())}


def small_checks(ring_mod, device) -> int:
    """A5 and A4 bitwise their plain versions on small rings, ragged
    slices included; returns the rings checked."""
    import torch

    gen = torch.Generator(device=device).manual_seed(11)
    for n, size in SMALL_RINGS:
        xs = [torch.randn(size, generator=gen, device=device)
              for _ in range(n)]
        got = ring_mod.cluster_allreduce_sum(xs)
        want = ring_mod.ring_allreduce_plain(xs)
        for r in range(n):
            check(same_bits(got[r], want[0]), f"A5 n={n} rank {r}")
        rows = size // 128 + 1
        bl = [torch.randn(rows, 128, generator=gen, device=device)
              for _ in range(n)]
        got = ring_mod.cluster_allgather(bl)
        for r in range(n):
            check(same_bits(got[r], torch.cat(bl)), f"A4 n={n} rank {r}")
    return len(SMALL_RINGS)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, default=25_557_032)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_ring_sweep: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.REPO))
    from horovod_tpu_torch.ops import ring as ring_mod

    built = build_copies(args.ptxas)
    log(chip_smoke.nvidia_smi_line())
    kernels = {}
    for t, (path, lines) in built.items():
        kernels[t] = ring_mod.bind_cluster(ctypes.CDLL(str(path)))
        for line in lines:
            log(f"ptxas threads={t} {line}")

    def use(t):
        ring_mod._cluster_kernels = lambda: kernels[t]

    device = torch.device("cuda", 0)
    n, size = args.ranks, args.elements
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    xs = [torch.randn(size, generator=gen, device=device) for _ in range(n)]
    blocks = chip_smoke._rank_blocks(xs)
    e = ring_mod.chunk_elems(size, n)
    want5 = ring_mod.ring_allreduce_plain(xs)[0]
    want4 = torch.cat(blocks)
    stacked = torch.stack(xs)
    total = torch.empty_like(xs[0])
    cat_outs = [torch.empty_like(want4) for _ in range(n)]
    sum_outs = [torch.empty_like(x) for x in xs]

    def sum_all_ranks():
        torch.sum(stacked, 0, out=total)
        for o in sum_outs:
            o.copy_(total)

    def cat_all_ranks():
        for o in cat_outs:
            torch.cat(blocks, out=o)

    b4, b5 = chip_smoke._ring_bounds(n, size, e)
    library = dict(
        A5=dict(library_ms=time_cuda(lambda: stacked.sum(0), args.reps),
                library_all_ranks_ms=time_cuda(sum_all_ranks, args.reps),
                **b5),
        A4=dict(library_ms=time_cuda(lambda: torch.cat(blocks), args.reps),
                library_all_ranks_ms=time_cuda(cat_all_ranks, args.reps),
                **b4))
    log("library " + json.dumps(library))

    slices = {}
    for t in THREADS:
        use(t)
        info = {kind: ring_mod.cluster_info(kind == "A5", n)
                for kind in ("A4", "A5")}
        slices[t] = info["A5"]["slice"]
        rings = small_checks(ring_mod, device)
        got5 = ring_mod.cluster_allreduce_sum(xs)
        got4 = ring_mod.cluster_allgather(blocks)
        for r in range(n):
            check(same_bits(got5[r], want5), f"A5 {t} threads full width")
            check(same_bits(got4[r], want4), f"A4 {t} threads full width")
        del got5, got4
        log("variant " + json.dumps(dict(threads=t, small_rings=rings,
                                         **info)))
    times = {t: {"A5": [], "A4": []} for t in THREADS}
    for order in (THREADS, THREADS[::-1]):
        for t in order:
            use(t)
            times[t]["A5"].append(time_cuda(
                lambda: ring_mod.cluster_allreduce_sum(xs), args.reps))
            times[t]["A4"].append(time_cuda(
                lambda: ring_mod.cluster_allgather(blocks), args.reps))
            log("sweep " + json.dumps(dict(
                slice=slices[t], threads=t, ranks=n, elements=size,
                A5_ms=times[t]["A5"][-1], A4_ms=times[t]["A4"][-1])))
    torch.cuda.synchronize()
    best = {kind: min(THREADS, key=lambda t: min(times[t][kind]))
            for kind in ("A5", "A4")}
    log("best " + json.dumps(dict(
        A5_slice=slices[best["A5"]], A4_slice=slices[best["A4"]],
        A5_ms=min(times[best["A5"]]["A5"]),
        A4_ms=min(times[best["A4"]]["A4"]), bound=dict(
            A5=b5["bound_ms"], A4=b4["bound_ms"]))))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except chip_smoke.SmokeFailure as err:
        print(f"torch_port_ring_sweep: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
