// Block-absmax int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces horovod_tpu/ops/pallas_ops.py:_quantize_kernel (called from
// quantize_int8_blocks, A2) and :_dequantize_kernel (called from
// dequantize_int8_blocks, A3): the codec of Compression.int8 and
// Compression.int8_stochastic.
//
// Per 1024-element block (zero-padded at the end of the buffer):
//   scale = absmax * f32(1/127)
//   inv   = scale > 0 ? 1 / scale : 0
//   q     = clip(rint(x * inv), -127, 127)             deterministic
//   q     = clip(floor(x * inv + u), -127, 127)         stochastic
//   out   = OutT(float(q) * scale)                      dequantize
// with the TPU's treatment of subnormals (a float32 input, product or
// scale of magnitude below FLT_MIN counts as 0), a NaN-propagating absmax
// (a block holding NaN gets scale NaN and codes 0) and a NaN code
// clipped to 0: the formula of quant_common.cuh, which ring.cu's A6
// shares.  The plain versions in ops/quantize.py compute the same, bit for
// bit.
//
// u is 23 random bits over 2^23: u = (bits >> 9) * 2^-23, bits =
// dither_bits(seed, element index), a counter-based hash (two rounds of
// murmur3's 32-bit finaliser), so any element's u depends only on the
// seed and its index.  The seed is read from device memory (an int32
// the wrapper computed on the device), so no host sync is needed.
//
// Bound: memory.  Quantize reads the input once and writes 1 byte a
// element plus 4 bytes a block; dequantize reads 1 byte a element plus
// the scales and writes the output once.  At 3.35 TB/s a 25.56 M f32
// buffer takes at least ~38 us either way.  A few dozen operations a
// element do not come near the card's rate.
//
// Design: one CUDA block of 128 threads per quantization block, 8
// elements a thread.  Loads are 16-byte vectors when the input pointer
// is 16-byte aligned and the 8 elements are in range (bucket pieces are
// views at any offset, so the scalar path stays); the absmax is a warp
// shuffle reduction then one across the 4 warps in shared memory; each
// thread writes its 8 codes as one 8-byte store.  Dequantize runs a
// grid-stride loop over groups of 8 elements.  Every multiply and add is
// an _rn intrinsic, so nvcc contracts nothing into an FMA, and the build
// has no --use_fast_math.
//
// C ABI (loaded with ctypes): dtype codes 0 = f32, 1 = bf16, 2 = f16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_common.cuh"

namespace {

using hvtpu::flush;
using hvtpu::max_nan;

constexpr int kBlock = hvtpu::kQBlock;   // elements per quantization block
constexpr int kThreads = 128;  // threads per quantization block
constexpr int kPer = kBlock / kThreads;  // 8 elements a thread
// dequantize's grid-stride loop: 2048 blocks of 256 threads fill any
// current card (H100: 132 SMs x 8 such blocks), more would only queue
constexpr int64_t kMaxDequantizeBlocks = 2048;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t dither_bits(uint32_t key, uint32_t ctr) {
  return mix32(mix32(ctr * 0x9E3779B1u + key) ^ key);
}

template <typename T>
struct Words {  // 16-byte words holding kPer elements of T
  static constexpr int kCount = kPer * sizeof(T) / sizeof(uint4);
};

template <typename InT, bool kStochastic>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const InT* __restrict__ x, int8_t* __restrict__ codes,
                float* __restrict__ scales, int64_t n,
                const int32_t* __restrict__ seed, bool vectorized) {
  const int64_t base = (int64_t)blockIdx.x * kBlock + threadIdx.x * kPer;
  float v[kPer];
  if (vectorized && base + kPer <= n) {
    constexpr int kW = Words<InT>::kCount;
    uint4 w[kW];  // declared as words, read as InT: 16-byte aligned
    const uint4* xw = reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int i = 0; i < kW; ++i) w[i] = __ldg(xw + i);
    const InT* xin = reinterpret_cast<const InT*>(w);
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = to_f32(xin[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      v[k] = base + k < n ? to_f32(x[base + k]) : 0.0f;
  }
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = flush(v[k]);
    m = max_nan(m, fabsf(v[k]));
  }
  m = hvtpu::warp_max_nan(m);
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = max_nan(max_nan(warp_max[0], warp_max[1]),
              max_nan(warp_max[2], warp_max[3]));

  float inv;
  const float scale = hvtpu::block_scale(m, &inv);
  const uint32_t key = kStochastic ? (uint32_t)*seed : 0u;

  union {
    int8_t q[kPer];
    uint2 word;
  } out;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (kStochastic) {
      const float t = flush(__fmul_rn(v[k], inv));
      const uint32_t bits = dither_bits(key, (uint32_t)(base + k));
      const float u = __fmul_rn((float)(bits >> 9), 0x1p-23f);
      out.q[k] = hvtpu::code_of(floorf(__fadd_rn(t, u)));
    } else {
      out.q[k] = hvtpu::round_code(v[k], inv);
    }
  }
  // codes hold whole blocks and are 8-byte aligned (the wrapper allocates
  // them), so every thread stores its 8 codes at once
  *reinterpret_cast<uint2*>(codes + base) = out.word;
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

template <typename OutT>
__global__ void __launch_bounds__(256)
dequantize_kernel(const int8_t* __restrict__ codes,
                  const float* __restrict__ scales, OutT* __restrict__ out,
                  int64_t n, bool vectorized) {
  const int64_t groups = (n + kPer - 1) / kPer;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t base = g * kPer;
    const float s = flush(__ldg(scales + base / kBlock));
    union {
      int8_t q[kPer];
      uint2 word;
    } in;
    if (vectorized) {
      in.word = __ldg(reinterpret_cast<const uint2*>(codes + base));
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) in.q[k] = codes[base + k];
    }
    constexpr int kW = Words<OutT>::kCount;
    uint4 ow[kW];
    OutT* o = reinterpret_cast<OutT*>(ow);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      o[k] = from_f32<OutT>(__fmul_rn((float)in.q[k], s));
    if (vectorized && base + kPer <= n) {
      uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll
      for (int i = 0; i < kW; ++i) dst[i] = ow[i];
    } else {
      for (int k = 0; k < kPer && base + k < n; ++k) out[base + k] = o[k];
    }
  }
}

template <typename InT>
int launch_quantize(const void* x, int64_t n, void* codes, void* scales,
                    const void* seed, bool stochastic, cudaStream_t stream) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const bool vectorized = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const InT* xi = static_cast<const InT*>(x);
  int8_t* q = static_cast<int8_t*>(codes);
  float* s = static_cast<float*>(scales);
  const int32_t* sd = static_cast<const int32_t*>(seed);
  if (stochastic)
    quantize_kernel<InT, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xi, q, s, n, sd, vectorized);
  else
    quantize_kernel<InT, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xi, q, s, n, sd, vectorized);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_dequantize(const void* codes, const void* scales, int64_t n,
                      void* out, cudaStream_t stream) {
  const bool vectorized = reinterpret_cast<uintptr_t>(codes) % 8 == 0 &&
                          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t groups = (n + kPer - 1) / kPer;
  int64_t blocks = (groups + 255) / 256;
  if (blocks > kMaxDequantizeBlocks) blocks = kMaxDequantizeBlocks;
  dequantize_kernel<OutT><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<OutT*>(out), n, vectorized);
  return (int)cudaGetLastError();
}

}  // namespace

// codes: ceil(n/1024)*1024 int8; scales: ceil(n/1024) f32; seed: one
// device int32, read only when stochastic != 0.
extern "C" int hvtpu_quantize_int8(const void* x, int in_dtype, int64_t n,
                                   void* codes, void* scales,
                                   const void* seed, int stochastic,
                                   void* stream) {
  if (n < 0 || (stochastic && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0:
      return launch_quantize<float>(x, n, codes, scales, seed,
                                    stochastic != 0, s);
    case 1:
      return launch_quantize<__nv_bfloat16>(x, n, codes, scales, seed,
                                            stochastic != 0, s);
    case 2:
      return launch_quantize<__half>(x, n, codes, scales, seed,
                                     stochastic != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: n elements of out_dtype; codes and scales as above.
extern "C" int hvtpu_dequantize_int8(const void* codes, const void* scales,
                                     int64_t n, void* out, int out_dtype,
                                     void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch_dequantize<float>(codes, scales, n, out, s);
    case 1: return launch_dequantize<__nv_bfloat16>(codes, scales, n, out, s);
    case 2: return launch_dequantize<__half>(codes, scales, n, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
