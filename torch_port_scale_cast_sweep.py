#!/usr/bin/env python3
"""Kernel A1 (``csrc/scale_cast.cu``) at other CTA shapes and
occupancies, on one GPU.

    python3 torch_port_scale_cast_sweep.py [--reps 20] [--ptxas]

The kernel is compiled with ``kElems = 16`` elements a thread (a CTA's
share of the elements: one step of its threads; past one wave the grid
is a whole number of waves), ``kThreads = 256`` and ``kBlocksPerSm = 4``
(a wave: 4 CTAs on each SM, which also caps the registers at 64 a
thread), loading with ``__ldg`` and storing plainly.  This script
copies the source under ``build/scale_cast_sweep/<variant>/`` with
other values of those constants, CTAs of two steps, or (``cs``) the
loads and stores of the aligned chunks as ``__ldcs`` / ``__stcs``
(evict-first: every byte is touched once) (``VARIANTS``), compiles the
copies in parallel (``_build.build_copies``; ``--ptxas`` prints each
one's registers and spills) and times each, launching its table
directly, so that the times are the card's and not the host's:

* one buffer of ResNet-50's 25,557,032 gradients, float32 to float32 and
  float32 to bfloat16, against ``torch.mul``;
* the pre pass of the training path (the 161 float32 gradients, scale
  1/2, into one fp16 buffer) and the post pass (back into the gradients,
  scale 2), as one launch each;

each against its bound (each input read once, each output written once),
the variants taken in turns, forwards and then backwards.  Every variant
is first checked bitwise against the plain versions.  Prints the card's
name and power limit, one ``sweep {...}`` line a variant and pass and a
``best {...}`` line.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys

import chip_smoke
from chip_smoke import check, log, same_bits, time_cuda

SHIPPED = dict(kElems=16, kThreads=256, kBlocksPerSm=4)


def _const(**values) -> dict:
    """The patches that set the named constants to ``values``."""
    return {f"constexpr int {k} = {SHIPPED[k]};": f"constexpr int {k} = {v};"
            for k, v in values.items()}


#: {variant: patches of csrc/scale_cast.cu}; "shipped" is the source as is
VARIANTS = {
    "shipped": {},
    "cs": {
        "w[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);":
            "w[k] = __ldcs(reinterpret_cast<const uint4*>(p) + k);",
        "reinterpret_cast<uint4*>(d0 + c * C::kN)[k] = w[k];":
            "__stcs(reinterpret_cast<uint4*>(d0 + c * C::kN) + k, w[k]);"},
    "2_steps": {"const int64_t cta = (int64_t)kThreads * kElems;":
                "const int64_t cta = (int64_t)kThreads * kElems * 2;"},
    "8_elems": _const(kElems=8),
    "128_threads": _const(kThreads=128, kBlocksPerSm=8),
    "8_elems_128_threads": _const(kElems=8, kThreads=128, kBlocksPerSm=8),
    "512_threads": _const(kThreads=512, kBlocksPerSm=2),
    "8_elems_512_threads": _const(kElems=8, kThreads=512, kBlocksPerSm=2),
}


def build_copies(ptxas: bool) -> dict:
    """{variant: (library path, ptxas lines)}, compiled in parallel."""
    from horovod_tpu_torch.ops import _build

    built = _build.build_copies(
        "scale_cast", VARIANTS,
        _build.BUILD_DIR.parent / "scale_cast_sweep",
        ["-Xptxas", "-v"] if ptxas else [])
    return {name: (path, [ln.strip() for ln in out.splitlines()
                          if "registers" in ln or "spill" in ln])
            for name, (path, out) in built.items()}


def launcher(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.hvtpu_scale_cast_table
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cases(device):
    """[(name, launch, scale, output tensors, plain outputs, bytes,
    library call)]: each case's one launch, (table, source addresses,
    destination addresses, count, total)."""
    import numpy as np
    import torch

    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.ops import scale_cast

    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    shapes = chip_smoke.resnet50_grad_shapes()
    n = sum(math.prod(s) for s in shapes)
    big = torch.randn(n, generator=gen, device=device)
    out = []
    for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        dst = torch.empty(n, dtype=dt, device=device)
        (_, _, table, total), = scale_cast.launch_tables(
            [n], [(0, 0, 0, code)], 1)
        ptrs = (scale_cast._addresses([big]), scale_cast._addresses([dst]))
        lib_out = torch.empty_like(dst)
        out.append((f"buffer_to_{str(dt)[6:]}", (table, *ptrs, 1, total), 0.5,
                    [dst], [scale_cast.fused_scale_cast_plain(big, 0.5, dt)],
                    n * (4 + dst.element_size()),
                    lambda o=lib_out: torch.mul(big, 0.5, out=o)))
    grads = [torch.randn(s, generator=gen, device=device) for s in shapes]
    flat = torch.empty(n, dtype=torch.float16, device=device)
    sizes = [g.numel() for g in grads]
    offsets = (np.cumsum(sizes) - np.asarray(sizes)).astype(np.uint64)
    at_flat = offsets * np.uint64(2) + np.uint64(flat.data_ptr())
    (_, _, pre, total), = scale_cast.launch_tables(
        sizes, [(0, 0, 0, 2)] * len(sizes), len(sizes))
    want_flat, specs = scale_cast.scale_cast_pack_plain(
        grads, 0.5, Compression.fp16)
    flats = [g.reshape(-1) for g in grads]
    out.append(("pre_pass", (pre, scale_cast._addresses(grads), at_flat,
                             len(sizes), total), 0.5, [flat],
                [want_flat], n * 6, lambda: torch._foreach_mul(flats, 0.5)))
    outs = [torch.empty_like(g) for g in grads]
    (_, _, post, total), = scale_cast.launch_tables(
        sizes, [(2, 2, 0, 0)] * len(sizes), len(sizes))
    want_outs = scale_cast.unpack_cast_scale_plain(
        want_flat, specs, [torch.float32] * len(grads), 2.0)
    out.append(("post_pass", (post, at_flat, scale_cast._addresses(outs),
                              len(sizes), total), 2.0, outs,
                want_outs, n * 6, lambda: torch._foreach_mul(outs, 2.0)))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_scale_cast_sweep: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.REPO))
    log(chip_smoke.nvidia_smi_line())
    built = build_copies(args.ptxas)
    device = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(device).cuda_stream
    fns = {key: launcher(path) for key, (path, _) in built.items()}
    work = cases(device)

    def run(fn, launch, scale):
        table, srcs, dsts, count, total = launch
        err = fn(table.ctypes.data, srcs.ctypes.data, dsts.ctypes.data,
                 count, total, scale, stream)
        check(err == 0, f"launch failed with cudaError {err}")

    for key, fn in fns.items():
        for name, launch, scale, outs, want, _, _ in work:
            for o in outs:
                o.fill_(7.0)
            run(fn, launch, scale)
            torch.cuda.synchronize()
            check(all(same_bits(o, w) for o, w in zip(outs, want)),
                  f"variant {key} {name}: differs from the plain version")
    log(f"sweep: {len(fns)} variants bitwise equal to the plain versions "
        f"in {len(work)} cases")
    times = {}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for key in order:
            for name, launch, scale, *_ in work:
                times.setdefault((key, name), []).append(time_cuda(
                    lambda: run(fns[key], launch, scale), args.reps))
    if args.ptxas:
        for key in VARIANTS:
            log(f"ptxas {key}: " + " | ".join(built[key][1][-2:]))
    for name, _, _, _, _, nbytes, library in work:
        bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        lib_ms = time_cuda(library, args.reps)
        for key in VARIANTS:
            log("sweep " + json.dumps(dict(
                variant=key, case=name, ms=times[(key, name)],
                bound_ms=bound, library_ms=lib_ms)))
        best = min(VARIANTS, key=lambda k: sum(times[(k, name)]))
        log("best " + json.dumps(dict(variant=best, case=name,
                                      ms=times[(best, name)])))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except chip_smoke.SmokeFailure as e:
        print(f"torch_port_scale_cast_sweep: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
