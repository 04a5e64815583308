#!/usr/bin/env python3
"""Kernels A2 and A3 (``csrc/quantize_int8.cu``) at other CTA shapes and
store hints, on one GPU.

    python3 torch_port_quantize_sweep.py [--reps 20] [--ptxas]

The kernels are compiled with ``kWarps = 8`` warps a CTA (a warp a
quantization block), ``__stcs`` (evict-first) stores and, in A2,
``__ldcs`` (evict-first) loads.  This script copies the source under
``build/quantize_sweep/<variant>/`` with 4 or 16 warps a CTA, plain
stores, ``__ldg`` loads in A2, ``__ldcs`` loads in A3, or A2's codes
rounded by one float-to-int conversion (``VARIANTS``), compiles the copies in parallel
(``_build.build_copies``; ``--ptxas`` prints each one's registers and
spills) and times each on one buffer of ResNet-50's 25,557,032
gradients, launching the libraries directly so that the times are the
card's and not the host's: A2 from float32 (deterministic and
stochastic) and bfloat16, A3 to float32 and bfloat16, each against its
bound (each input read once, each output written once) and A3 against
``torch.mul`` of the codes by the scales, the variants taken in turns,
forwards and then backwards.  Every variant is first checked bitwise
against the plain versions.

Then it times, with the host's clock, the codec's pass over the 161
gradients (one call a tensor) through the wrappers, against
``torch.mul``, and the parts of a call alone: the launch through
``ctypes``, A3's output allocation, and A2's two allocations against one
buffer cut into the codes and an aligned view of the scales.

Prints the card's name and power limit, one ``sweep {...}`` line a
variant and case, a ``best {...}`` line a case and a ``host {...}``
line.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import sys
import time

import chip_smoke
from chip_smoke import check, log, same_bits, time_cuda

#: {variant: patches of csrc/quantize_int8.cu}; "shipped" is the source
VARIANTS = {
    "shipped": {},
    "plain_stores": {"constexpr bool kStreamingStores = true;":
                     "constexpr bool kStreamingStores = false;"},
    "4_warps": {"constexpr int kWarps = 8;": "constexpr int kWarps = 4;"},
    "16_warps": {"constexpr int kWarps = 8;": "constexpr int kWarps = 16;"},
    "a2_ldg": {"w[i] = __ldcs(reinterpret_cast<const uint4*>(xb)":
               "w[i] = __ldg(reinterpret_cast<const uint4*>(xb)"},
    "a3_ldcs": {"c[i].word = __ldg(cb + i * 32 + lane);":
                "c[i].word = __ldcs(cb + i * 32 + lane);"},
    "a2_int_codes": {
        "out.q[j] = hvtpu::code_of(floorf(__fadd_rn(t, u)));":
            "out.q[j] = (int8_t)min(max(__float2int_rd(__fadd_rn(t, u)), "
            "-127), 127);",
        "out.q[j] = hvtpu::round_code(v[i][j], inv);":
            "out.q[j] = (int8_t)min(max(__float2int_rn(flush(__fmul_rn("
            "v[i][j], inv))), -127), 127);"},
}


def build_copies(ptxas: bool) -> dict:
    """{variant: (library path, ptxas lines)}, compiled in parallel."""
    from horovod_tpu_torch.ops import _build

    built = _build.build_copies(
        "quantize_int8", VARIANTS,
        _build.BUILD_DIR.parent / "quantize_sweep",
        ["-Xptxas", "-v"] if ptxas else [])
    return {name: (path, [ln.strip() for ln in out.splitlines()
                          if "registers" in ln or "spill" in ln])
            for name, (path, out) in built.items()}


def launchers(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    q, d = lib.hvtpu_quantize_int8, lib.hvtpu_dequantize_int8
    q.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p]
    q.restype = ctypes.c_int
    d.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    d.restype = ctypes.c_int
    return q, d


def cases(device, n: int):
    """[(name, launch(q, d, stream) -> cudaError, outputs, plain
    outputs, bytes, library call or None)]."""
    import torch

    from horovod_tpu_torch.ops import quantize as qm

    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    seed = torch.tensor(1234567, dtype=torch.int32, device=device)
    g = qm.num_blocks(n)
    out = []
    for in_dt, code, stochastic in ((torch.float32, 0, False),
                                    (torch.float32, 0, True),
                                    (torch.bfloat16, 1, False)):
        x = chip_smoke.wide_values(n, in_dt, device, gen)
        codes = torch.empty((g * qm.QROWS, qm.LANES), dtype=torch.int8,
                            device=device)
        scales = torch.empty((g, 1), dtype=torch.float32, device=device)
        pq, ps, _ = qm.quantize_int8_blocks_plain(x, stochastic=stochastic,
                                                  seed=seed)
        name = (f"quantize_{str(in_dt)[6:]}"
                + ("_stochastic" if stochastic else ""))
        out.append((name, lambda qfn, dfn, stream, x=x, c=codes,
                    sc=scales, k=code, st=stochastic: qfn(
                        x.data_ptr(), k, n, c.data_ptr(), sc.data_ptr(),
                        seed.data_ptr(), int(st), stream),
                    [codes, scales], [pq, ps],
                    chip_smoke._int8_bytes(n, x.element_size(), 0, True),
                    None))
    codes, scales, _ = qm.quantize_int8_blocks_plain(
        torch.randn(n, generator=gen, device=device))
    for out_dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        dst = torch.empty(n, dtype=out_dt, device=device)
        padded = torch.empty((g, qm.QBLOCK), dtype=out_dt, device=device)
        out.append((f"dequantize_to_{str(out_dt)[6:]}",
                    lambda qfn, dfn, stream, o=dst, k=code: dfn(
                        codes.data_ptr(), scales.data_ptr(), n,
                        o.data_ptr(), k, stream),
                    [dst], [qm.dequantize_int8_blocks_plain(codes, scales, n,
                                                            out_dt)],
                    chip_smoke._int8_bytes(n, 0, dst.element_size(), False),
                    lambda p=padded: torch.mul(codes.view(-1, qm.QBLOCK),
                                               scales, out=p)))
    return out


def host_times(device, shapes, reps: int) -> dict:
    """Host ms of a pass over ``shapes`` (the codec's one call a tensor),
    with the host's clock: A2 and A3 through their wrappers, A3's library
    call (``torch.mul``), and the parts of a wrapper's call alone: the
    library's launch through ``ctypes`` (output allocated beforehand),
    A3's output allocation, and A2's two (two ``new_empty``, or one
    buffer cut into the codes and an aligned view of the scales)."""
    import torch

    from horovod_tpu_torch.ops import quantize as qm

    grads = [torch.randn(math.prod(s), device=device) for s in shapes]
    coded = [qm.quantize_int8_blocks(g) for g in grads]
    outs = [torch.empty(n, device=device) for _, _, n in coded]
    dequantize = qm._library()[1]
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    i8, f32 = torch.int8, torch.float32

    def one_buffer():
        for q, _, _ in coded:
            g = q.shape[0] // qm.QROWS
            buf = q.new_empty(g * (qm.QBLOCK + 4))
            buf[:g * qm.QBLOCK].view(g * qm.QROWS, qm.LANES)
            buf[g * qm.QBLOCK:].view(f32).view(g, 1)

    cases = {
        "a3_wrapper": lambda: [qm.dequantize_int8_blocks(q, s, n)
                               for q, s, n in coded],
        "torch_mul": lambda: [torch.mul(q.view(-1, qm.QBLOCK), s)
                              for q, s, _ in coded],
        "a2_wrapper": lambda: [qm.quantize_int8_blocks(g) for g in grads],
        "a3_launch_alone": lambda: [
            dequantize(q.data_ptr(), s.data_ptr(), n, o.data_ptr(), 0,
                       stream) for (q, s, n), o in zip(coded, outs)],
        "a3_output_new_empty": lambda: [q.new_empty(n, dtype=f32)
                                        for q, _, n in coded],
        "a2_outputs_two_new_empty": lambda: [
            (q.new_empty(q.shape, dtype=i8),
             q.new_empty((q.shape[0] // qm.QROWS, 1), dtype=f32))
            for q, _, _ in coded],
        "a2_outputs_one_buffer": one_buffer,
    }
    times = {k: [] for k in cases}
    for order in (list(cases), list(cases)[::-1]) * 2:
        for key in order:
            fn = cases[key]
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) / reps * 1e3)
    return dict(tensors=len(shapes), turns_ms=times,
                us_a_call={k: statistics.median(v) / len(shapes) * 1e3
                           for k, v in times.items()})


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_quantize_sweep: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.REPO))
    log(chip_smoke.nvidia_smi_line())
    built = build_copies(args.ptxas)
    device = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(device).cuda_stream
    fns = {key: launchers(path) for key, (path, _) in built.items()}
    shapes = chip_smoke.resnet50_grad_shapes()
    n = sum(math.prod(s) for s in shapes)
    work = cases(device, n)

    def run(key, launch):
        err = launch(*fns[key], stream)
        check(err == 0, f"variant {key}: launch failed with cudaError {err}")

    for key in fns:
        for name, launch, outs, want, _, _ in work:
            for o in outs:
                o.fill_(7)
            run(key, launch)
            torch.cuda.synchronize()
            check(all(same_bits(o, w) for o, w in zip(outs, want)),
                  f"variant {key} {name}: differs from the plain version")
    log(f"sweep: {len(fns)} variants bitwise equal to the plain versions "
        f"in {len(work)} cases")
    times = {}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for key in order:
            for name, launch, *_ in work:
                times.setdefault((key, name), []).append(time_cuda(
                    lambda: run(key, launch), args.reps))
    if args.ptxas:
        for key in VARIANTS:
            log(f"ptxas {key}: " + " | ".join(built[key][1]))
    for name, _, _, _, nbytes, library in work:
        bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        lib_ms = time_cuda(library, args.reps) if library else None
        for key in VARIANTS:
            log("sweep " + json.dumps(dict(
                variant=key, case=name, n=n, ms=times[(key, name)],
                bound_ms=bound, library_ms=lib_ms)))
        best = min(VARIANTS, key=lambda k: sum(times[(k, name)]))
        log("best " + json.dumps(dict(variant=best, case=name,
                                      ms=times[(best, name)])))
    log("host " + json.dumps(host_times(device, shapes, args.reps)))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except chip_smoke.SmokeFailure as e:
        print(f"torch_port_quantize_sweep: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
