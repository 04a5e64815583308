// 16-byte float32 accesses shared by the ring kernels of ring.cu and
// ring_cluster.cu: a rank's buffer is `size` floats, read as zeros at and
// past `size` (the reference pads a rank's tensor to whole chunks) and
// written only below it.  Subnormals flush as in quant_common.cuh.

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

}  // namespace hvtpu
