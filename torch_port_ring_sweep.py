#!/usr/bin/env python3
"""The cluster ring kernels (A4, A5, A6) at each CTA shape, on one GPU;
with ``--kernels global`` the global-slot ones at each occupancy.

    python3 torch_port_ring_sweep.py [--elements 25557032] [--ranks 8]
                                     [--reps 20] [--ptxas]
                                     [--kernels all|A4A5|A6|global]

``horovod_tpu_torch/csrc/ring_cluster.cu`` is compiled at one CTA shape
a kernel: A4/A5 at 128 threads of 16 elements each (a slice of 2048),
A6 at 128 threads and one warp a 1024-element quantization block (a
slice of 4096).  This script copies the source, with the headers beside
it, under ``build/ring_sweep/<name>/`` with other shapes set, compiles
the copies in parallel (``--ptxas`` adds ``-Xptxas -v`` and prints each
kernel's registers, shared memory and spills) and runs each through the
port's own wrappers:

* A4/A5 (copies ``t<threads>``): ``kThreads`` 128, 256, 512 and 1024,
  slices of 2048 to 16384 elements;
* A6 (copies ``q<warps>w<threads>``): one warp a block (a lane 32
  elements) or two (a lane 16, the block's absmax combined through
  shared memory), at CTAs of 64 to 512 threads, so a CTA holds whole
  blocks; and at the shipped shape two levers: a register cap of 6 or 8
  CTAs an SM (``q1w128_cap6``, ``_cap8``) and evict-first input loads
  (``q1w128_ldcs``).

For each copy: what the card gives the kernel (``cluster_info``:
registers, spill bytes, shared memory and CTAs an SM, clusters resident
at once); the kernel bitwise against its plain version (A6 any NaN equal
to any NaN) at 2, 3, 5 and 8 ranks of a few thousand elements, ragged
slices included (A6 also at 3 ranks of NaN/inf/subnormal values) and,
once, at full width.  Then the time at ``--ranks`` ranks of
``--elements`` float32 (the default is the ring phase of
``chip_smoke.py``: 8 ranks of ResNet-50's 25,557,032 gradients), by CUDA
events, the copies taken in turns, forwards and then backwards, beside
the bound (each input read once, each output written once), the library
calls that fill one output and every rank's (A4/A5) and the global-slot
A6 of ``ring.cu`` at the same ranks (A6).

``--kernels global`` copies ``horovod_tpu_torch/csrc/ring.cu`` instead
(``build/ring_sweep_global/c<n>/``) with its floor of CTAs an SM,
``kCtasPerSm``, at 1 (no register cap), 2 and 3 (the shipped one),
holds each copy's one-launch A4/A5/A6 bitwise against the plain
versions at 9 and 12 ranks and at full width, and times them in turns
at ``--ranks`` ranks of ``--elements`` (default 12 x 12,778,516, the
size ``chip_smoke.py`` times them at): ``sweep_global {...}`` lines and
a ``best_global {...}`` line.

Prints the card's name and power limit, one ``variant {...}`` line a
copy, one ``sweep {...}`` / ``sweep_a6 {...}`` line a copy and pass, and
a ``best {...}`` / ``best_a6 {...}`` line.  Inputs are random normal
from a seed; the kernels' time does not depend on the values.  Needs
one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys

import chip_smoke
from chip_smoke import check, log, same_bits, time_cuda

THREADS = (128, 256, 512, 1024)
KTHREADS = "constexpr int kThreads = 128;"
# A6: (warps a quantization block, threads a CTA)
A6_SHAPES = ((1, 64), (1, 128), (1, 256), (1, 512),
             (2, 64), (2, 128), (2, 256), (2, 512))
KQTHREADS = "constexpr int kQThreads = 128;"
KQBLOCKWARPS = "constexpr int kQBlockWarps = 1;"
# A6 levers at the shipped shape: a register cap that lets 6 or 8 CTAs
# reside on an SM, and evict-first loads of the inputs (each read once)
A6_LEVERS = {
    "q1w128_cap6": {"__launch_bounds__(kQThreads)":
                    "__launch_bounds__(kQThreads, 6)"},
    "q1w128_cap8": {"__launch_bounds__(kQThreads)":
                    "__launch_bounds__(kQThreads, 8)"},
    "q1w128_ldcs": {"v[k] = __ldg(reinterpret_cast<const float4*>(x + block":
                    "v[k] = __ldcs(reinterpret_cast<const float4*>(x + block"},
}
SMALL_RINGS = [(2, 5000), (3, 4000), (5, 3001), (8, 40000)]
# ring.cu: its floor of CTAs an SM (the register cap) and the copies'
KCTAS = "constexpr int kCtasPerSm = 3;"
GLOBAL_CTAS = (1, 2, 3)
GLOBAL_RINGS = [(9, 5000), (12, 3001)]


def _a6_name(shape) -> str:
    return "q{}w{}".format(*shape)


def a6_copies() -> dict:
    """{name: patches} of every A6 copy: the shapes, then the levers."""
    copies = {_a6_name((w, t)): {
        KQTHREADS: f"constexpr int kQThreads = {t};",
        KQBLOCKWARPS: f"constexpr int kQBlockWarps = {w};"}
        for w, t in A6_SHAPES}
    copies.update(A6_LEVERS)
    return copies


def build_copies(ptxas: bool, kinds) -> dict:
    """{name: (library path, ptxas lines)}: a copy of ring_cluster.cu at
    each A4/A5 thread count and each A6 shape, compiled in parallel."""
    from horovod_tpu_torch.ops import _build

    variants = {}
    if "A4A5" in kinds:
        variants.update({f"t{t}": {KTHREADS: f"constexpr int kThreads = {t};"}
                         for t in THREADS})
    if "A6" in kinds:
        variants.update(a6_copies())
    built = _build.build_copies(
        "ring_cluster", variants, _build.BUILD_DIR.parent / "ring_sweep",
        ["-Xptxas", "-v"] if ptxas else [])
    return {name: (path, [ln.strip() for ln in out.splitlines()
                          if "ptxas info" in ln
                          and ("Used" in ln or "Compiling" in ln)])
            for name, (path, out) in built.items()}


def small_checks(ring_mod, device, kinds) -> int:
    """The kernels of ``kinds`` bitwise their plain versions on small
    rings, ragged slices included; returns the rings checked."""
    import torch

    gen = torch.Generator(device=device).manual_seed(11)
    rings = [(f"n={n}", [torch.randn(size, generator=gen, device=device)
                         for _ in range(n)]) for n, size in SMALL_RINGS]
    if "A6" in kinds:
        special = [chip_smoke.wide_values(3001, torch.float32, device, gen)
                   for _ in range(3)]
        special[0][5], special[1][1030], special[2][2100] = (
            math.nan, math.inf, -math.inf)
        rings.append(("special n=3", special))
    for what, xs in rings:
        n = len(xs)
        if "A6" in kinds:
            got = ring_mod.cluster_quantized_allreduce(xs)
            want = ring_mod.ring_allreduce_plain(xs, quantized=True)
            for r in range(n):
                check(same_bits(got[r], want[0]), f"A6 {what} rank {r}")
        if "A4A5" in kinds and not what.startswith("special"):
            got = ring_mod.cluster_allreduce_sum(xs)
            want = ring_mod.ring_allreduce_plain(xs)
            for r in range(n):
                check(same_bits(got[r], want[0]), f"A5 {what} rank {r}")
            rows = xs[0].numel() // 128 + 1
            bl = [torch.randn(rows, 128, generator=gen, device=device)
                  for _ in range(n)]
            got = ring_mod.cluster_allgather(bl)
            for r in range(n):
                check(same_bits(got[r], torch.cat(bl)),
                      f"A4 {what} rank {r}")
    return len(rings)


def sweep_a4a5(ring_mod, use, xs, reps, device) -> None:
    import torch

    n, size = len(xs), xs[0].numel()
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
        A5=dict(library_ms=time_cuda(lambda: stacked.sum(0), reps),
                library_all_ranks_ms=time_cuda(sum_all_ranks, reps), **b5),
        A4=dict(library_ms=time_cuda(lambda: torch.cat(blocks), reps),
                library_all_ranks_ms=time_cuda(cat_all_ranks, reps), **b4))
    log("library " + json.dumps(library))
    del stacked, total, cat_outs, sum_outs

    names = [f"t{t}" for t in THREADS]
    slices = {}
    for t, name in zip(THREADS, names):
        use(name)
        info = {kind: ring_mod.cluster_info(kind, n) for kind in ("A4", "A5")}
        slices[t] = info["A5"]["slice"]
        rings = small_checks(ring_mod, device, ("A4A5",))
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
            use(f"t{t}")
            times[t]["A5"].append(time_cuda(
                lambda: ring_mod.cluster_allreduce_sum(xs), reps))
            times[t]["A4"].append(time_cuda(
                lambda: ring_mod.cluster_allgather(blocks), reps))
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


def sweep_a6(ring_mod, use, xs, reps, device) -> None:
    """Each A6 shape checked and timed, the global-slot A6 of ring.cu at
    the same ranks beside it in every turn."""
    import torch

    n, size = len(xs), xs[0].numel()
    want = ring_mod.ring_allreduce_plain(xs, quantized=True)[0]
    bound = chip_smoke._a6_bound(n, size)
    got = ring_mod.global_allreduce(xs, True)
    for r in range(n):
        check(same_bits(got[r], want), f"A6 global slots n={n} rank {r}")
    del got
    infos = {}
    for name in a6_copies():
        use(name)
        infos[name] = ring_mod.cluster_info("A6", n)
        rings = small_checks(ring_mod, device, ("A6",))
        got = ring_mod.cluster_quantized_allreduce(xs)
        for r in range(n):
            check(same_bits(got[r], want), f"A6 {name} full width rank {r}")
        del got
        log("variant " + json.dumps(dict(kernel="A6", copy=name,
                                         small_rings=rings, **infos[name])))
    names = list(a6_copies()) + ["global"]
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            if name != "global":
                use(name)
            times[name].append(time_cuda(
                (lambda: ring_mod.global_allreduce(xs, True))
                if name == "global"
                else (lambda: ring_mod.cluster_quantized_allreduce(xs)), reps))
            log("sweep_a6 " + json.dumps(dict(
                copy=name, ranks=n, elements=size, ms=times[name][-1],
                slice=infos[name]["slice"] if name in infos else None)))
    torch.cuda.synchronize()
    best = min(names[:-1], key=lambda name: min(times[name]))
    log("best_a6 " + json.dumps(dict(
        copy=best, ms=min(times[best]), global_ms=min(times["global"]),
        **bound, config=infos[best])))


def build_global_copies(ptxas: bool) -> dict:
    """{name: (library path, ptxas lines)}: a copy of ring.cu at each
    floor of CTAs an SM, compiled in parallel."""
    from horovod_tpu_torch.ops import _build

    built = _build.build_copies(
        "ring", {f"c{c}": {KCTAS: f"constexpr int kCtasPerSm = {c};"}
                 for c in GLOBAL_CTAS},
        _build.BUILD_DIR.parent / "ring_sweep_global",
        ["-Xptxas", "-v"] if ptxas else [])
    return {name: (path, [ln.strip() for ln in out.splitlines()
                          if "ptxas info" in ln
                          and ("Used" in ln or "spill" in ln
                               or "Compiling" in ln)])
            for name, (path, out) in built.items()}


def sweep_global(ring_mod, use, xs, reps, device) -> None:
    """Each copy of ring.cu's one-launch A4/A5/A6 checked on small rings
    and at full width, then timed in turns, forwards and backwards."""
    import torch

    n, size = len(xs), xs[0].numel()
    gen = torch.Generator(device=device).manual_seed(12)
    rings = [[torch.randn(m, generator=gen, device=device)
              for _ in range(k)] for k, m in GLOBAL_RINGS] + [xs]
    names = [f"c{c}" for c in GLOBAL_CTAS]
    for name in names:
        use(name)
        for ring in rings:
            blocks = chip_smoke._rank_blocks(ring)
            for q in (False, True):
                want = ring_mod.ring_allreduce_plain(ring, quantized=q)[0]
                got = ring_mod.global_allreduce(ring, q)
                check(all(same_bits(g, want) for g in got),
                      f"global {name} n={len(ring)} quantized={q}")
            want = ring_mod.ring_allgather_2d_plain(blocks)[0]
            check(all(same_bits(g, want)
                      for g in ring_mod._allgather_kernel(blocks)),
                  f"global {name} A4 n={len(ring)}")
        log("variant " + json.dumps(dict(kernel="global", copy=name,
                                         rings=[len(r) for r in rings])))
    blocks = chip_smoke._rank_blocks(xs)
    calls = {"A5": lambda: ring_mod.global_allreduce(xs, False),
             "A6": lambda: ring_mod.global_allreduce(xs, True),
             "A4": lambda: ring_mod._allgather_kernel(blocks)}
    times = {name: {k: [] for k in calls} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            use(name)
            for kind, fn in calls.items():
                times[name][kind].append(time_cuda(fn, reps))
            log("sweep_global " + json.dumps(dict(
                copy=name, ranks=n, elements=size,
                **{f"{k}_ms": v[-1] for k, v in times[name].items()})))
    torch.cuda.synchronize()
    log("best_global " + json.dumps({
        kind: dict(copy=min(names, key=lambda m: min(times[m][kind])),
                   ms=min(min(times[m][kind]) for m in names))
        for kind in calls}))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int)
    ap.add_argument("--ranks", type=int)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--kernels", choices=("all", "A4A5", "A6", "global"),
                    default="all")
    args = ap.parse_args()
    wide = args.kernels == "global"
    if args.elements is None:
        args.elements = 12_778_516 if wide else 25_557_032
    if args.ranks is None:
        args.ranks = 12 if wide else 8
    if not torch.cuda.is_available():
        print("torch_port_ring_sweep: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.REPO))
    from horovod_tpu_torch.ops import ring as ring_mod

    kinds = ("A4A5", "A6") if args.kernels == "all" else (args.kernels,)
    built = (build_global_copies(args.ptxas) if wide
             else build_copies(args.ptxas, kinds))
    log(chip_smoke.nvidia_smi_line())
    kernels = {}
    bind = ring_mod.bind_global if wide else ring_mod.bind_cluster
    for name, (path, lines) in built.items():
        kernels[name] = bind(ctypes.CDLL(str(path)))
        for line in lines:
            log(f"ptxas {name} {line}")

    def use(name):
        if wide:
            ring_mod._kernels = lambda: kernels[name]
        else:
            ring_mod._cluster_kernels = lambda: kernels[name]

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    xs = [torch.randn(args.elements, generator=gen, device=device)
          for _ in range(args.ranks)]
    if wide:
        sweep_global(ring_mod, use, xs, args.reps, device)
    if "A4A5" in kinds:
        sweep_a4a5(ring_mod, use, xs, args.reps, device)
    if "A6" in kinds:
        sweep_a6(ring_mod, use, xs, args.reps, device)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except chip_smoke.SmokeFailure as err:
        print(f"torch_port_ring_sweep: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
