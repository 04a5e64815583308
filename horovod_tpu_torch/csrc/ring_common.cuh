// What the ring kernels of ring.cu and ring_cluster.cu share:
//
// * 16-byte float32 accesses: a rank's buffer is `size` floats, read as
//   zeros at and past `size` (the reference pads a rank's tensor to whole
//   chunks) and written only below it.  Subnormals flush as in
//   quant_common.cuh.
// * A6's per-hop int8 arithmetic on a lane's share of one 1024-element
//   quantization block (V float4, the lane's elements `first + k*128` of
//   the block for k < V): its absmax, its codes under A2's formula
//   (quant_common.cuh, the one copy of the rounding), a reduce-scatter
//   hop's accumulate flush(fma(float(q), s, flush(x_local))) with one
//   rounding, as XLA fuses the reference's dequantize-and-add, and the
//   dequantized q * s an output receives.  ops/ring.py's plain A6
//   computes the same, bit for bit.  How a block's absmax is combined
//   across the lanes (and warps) that share it is the kernel's.

#pragma once

#include <stdint.h>

#include "quant_common.cuh"

namespace hvtpu {

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float4 flush4(float4 v) {
  return make_float4(flush(v.x), flush(v.y), flush(v.z), flush(v.w));
}

// elements g..g+3 of x, zero at and past `size` (the reference's padding)
__device__ __forceinline__ float4 load4(const float* x, int64_t g,
                                        int64_t size) {
  if (g + 4 <= size) return __ldg(reinterpret_cast<const float4*>(x + g));
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = g + k < size ? __ldg(x + g + k) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(float* out, int64_t g, int64_t size,
                                       float4 v) {
  if (g + 4 <= size) {
    *reinterpret_cast<float4*>(out + g) = v;
    return;
  }
  const float w[4] = {v.x, v.y, v.z, v.w};
  for (int k = 0; k < 4 && g + k < size; ++k) out[g + k] = w[k];
}

// -- A6 ---------------------------------------------------------------------

// A lane's share of a block on the wire: 4 int8 codes a word, word k the
// codes of float4 k, and the block's scale.
template <int V>
struct Codes {
  uint32_t word[V];
  float scale;
};

// NaN-propagating absmax of a lane's (flushed) share
template <int V>
__device__ __forceinline__ float lane_absmax(const float4 (&v)[V]) {
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m = max_nan(m, fabsf(v[k].x));
    m = max_nan(m, fabsf(v[k].y));
    m = max_nan(m, fabsf(v[k].z));
    m = max_nan(m, fabsf(v[k].w));
  }
  return m;
}

// the codes of a lane's share under its block's absmax
template <int V>
__device__ __forceinline__ Codes<V> encode(const float4 (&v)[V],
                                           float absmax) {
  float inv;
  Codes<V> c;
  c.scale = block_scale(absmax, &inv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const uint32_t q0 = (uint8_t)round_code(v[k].x, inv);
    const uint32_t q1 = (uint8_t)round_code(v[k].y, inv);
    const uint32_t q2 = (uint8_t)round_code(v[k].z, inv);
    const uint32_t q3 = (uint8_t)round_code(v[k].w, inv);
    c.word[k] = q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
  }
  return c;
}

// a block a warp: the absmax is one warp reduction
template <int V>
__device__ __forceinline__ Codes<V> quantize_warp(const float4 (&v)[V]) {
  return encode(v, warp_max_nan(lane_absmax(v)));
}

__device__ __forceinline__ float code(uint32_t word, int j) {
  return (float)(int8_t)(word >> (8 * j));
}

// q * s of the 4 codes of a word
__device__ __forceinline__ float4 dequantize4(uint32_t word, float scale) {
  return make_float4(__fmul_rn(code(word, 0), scale),
                     __fmul_rn(code(word, 1), scale),
                     __fmul_rn(code(word, 2), scale),
                     __fmul_rn(code(word, 3), scale));
}

// a reduce-scatter hop: the received codes of a word onto the local x
__device__ __forceinline__ float4 accumulate4(uint32_t word, float scale,
                                              float4 x) {
  x = flush4(x);
  return make_float4(flush(__fmaf_rn(code(word, 0), scale, x.x)),
                     flush(__fmaf_rn(code(word, 1), scale, x.y)),
                     flush(__fmaf_rn(code(word, 2), scale, x.z)),
                     flush(__fmaf_rn(code(word, 3), scale, x.w)));
}

// q * s of a lane's share into out[g + k*128 ...], g the lane's first
// element; nothing written at or past `size`
template <int V>
__device__ __forceinline__ void store_dequantized(float* out, int64_t g,
                                                  int64_t size,
                                                  const Codes<V>& c) {
#pragma unroll
  for (int k = 0; k < V; ++k)
    store4(out, g + k * 128, size, dequantize4(c.word[k], c.scale));
}

}  // namespace hvtpu
