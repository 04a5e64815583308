// The block-absmax int8 formula shared by quantize_int8.cu (A2) and
// ring.cu (A6), as horovod_tpu/ops/pallas_ops.py:block_scale_inv is shared
// by the Pallas quantize kernel and the ring's per-hop requantization:
//   scale = flush(absmax * f32(1/127))      absmax propagates NaN
//   inv   = scale > 0 ? 1 / scale : 0
//   q     = clip(rint(flush(x * inv)), -127, 127), a NaN code -> 0
// with float32 subnormals counted as 0, as the TPU (and XLA on the CPU)
// computes.  Every multiply and division is an _rn intrinsic, so nvcc
// contracts nothing into an FMA.  ops/quantize.py's flush /
// block_scale_inv / round_codes are the plain versions, bit for bit.
// flush is also the subnormal rule of every ring kernel (ring_common.cuh).

#pragma once

#include <stdint.h>

namespace hvtpu {

constexpr int kQBlock = 1024;              // elements per quantization block
constexpr float kInv127 = 0x1.020408p-7f;  // f32(1/127)
constexpr float kFltMin = 0x1p-126f;

// the TPU flushes float32 subnormals; NaN compares false and stays
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kFltMin ? 0.0f : v;
}

// max that propagates NaN (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// warp-wide NaN-propagating max; every lane gets the result
__device__ __forceinline__ float warp_max_nan(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
  return m;
}

// scale of a block from its (flushed) absmax; inv = 1/scale or 0
__device__ __forceinline__ float block_scale(float absmax, float* inv) {
  float scale = __fmul_rn(absmax, kInv127);
  if (scale < kFltMin) scale = 0.0f;  // NaN stays NaN
  *inv = scale > 0.0f ? __fdiv_rn(1.0f, scale) : 0.0f;
  return scale;
}

// a rounded value as an int8 code: NaN -> 0, clipped to [-127, 127]
__device__ __forceinline__ int8_t code_of(float r) {
  if (r != r) r = 0.0f;
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)(int)r;
}

// deterministic code of a flushed element v under inv
__device__ __forceinline__ int8_t round_code(float v, float inv) {
  return code_of(rintf(flush(__fmul_rn(v, inv))));
}

}  // namespace hvtpu
