"""The table of peaks and the fixed names by which the benchmark sorts
the device's kernels into groups.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 989 TFLOP/s in bf16 and fp16, 67 TFLOP/s in float32 outside the
tensor cores (PyTorch's default keeps float32 matrix products off TF32),
3.35 TB/s of HBM.

Groups, in the order a kernel is tried: ``a1`` (the program's kernel A1,
``scale_cast_table_kernel``), ``nccl``, ``attention`` (fused attention
kernels: PyTorch's SDPA backends on Hopper, ``pytorch_flash::flash_*``,
``fmha_cutlass*`` and cuDNN's ``*_sdpa_*``, and any other whose name
says flash, fmha, sdpa or attention; tried before ``conv_gemm``, whose
``cudnn``, ``cutlass`` and ``sm90_`` would take them), ``conv_gemm``
(cuDNN's and cuBLAS's convolution and matrix-product kernels, by the
names they carry on Hopper: ``sm90_xmma_*``, ``nvjet_*``, cutlass,
``*gemm*``, and cuDNN's own helpers), then ``other`` (elementwise,
reductions, pools, copies).
"""

from __future__ import annotations

import re

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = PEAK_FLOPS["bfloat16"]

GROUPS = (
    ("a1", re.compile(r"scale_cast_table_kernel")),
    ("nccl", re.compile(r"nccl", re.I)),
    ("attention", re.compile(r"flash|fmha|sdpa|attention", re.I)),
    ("conv_gemm", re.compile(
        r"cudnn|xmma|implicit_gemm|implicit_convolve|fprop|dgrad|wgrad|"
        r"winograd|nvjet|gemm|gemv|cutlass|cublas|splitKreduce|sm90_",
        re.I)),
)


def group_of(name: str) -> str:
    for group, rx in GROUPS:
        if rx.search(name):
            return group
    return "other"
