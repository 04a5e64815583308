// fused_scale_cast for Hopper (sm_90a): out[i] = OutT(float(x[i]) * scale).
//
// Replaces horovod_tpu/ops/pallas_ops.py:_scale_cast_kernel (called from
// fused_scale_cast), the pre/postscale pass around a fused allreduce.
//
// Bound: memory.  One read of n * sizeof(InT) bytes and one write of
// n * sizeof(OutT) bytes, one multiply per element: at 3.35 TB/s a pass
// over ResNet-50's 25.56 M f32 gradients (f32 -> f32) takes at least
// ~61 us.  On the training path it runs once per gradient tensor, many of
// them BatchNorm vectors of 64..2048 elements, where the launch, not the
// bandwidth, sets the time.
//
// Design: the TPU kernel's (8,128) padding, 256-row tiles and two-call
// split do not carry over.  Each thread moves 8 elements per step with
// 16-byte vector loads and stores (1 or 2 of them per side, by dtype) in
// a grid-stride loop; the elements past the last full vector, and any
// buffer whose pointers are not 16-byte aligned (a slice of a fused
// buffer), take the scalar loop.  The multiply is __fmul_rn and the
// narrowing casts are round-to-nearest-even (__float2bfloat16_rn,
// __float2half_rn), so with no --use_fast_math (which would flush
// denormals) the result is bitwise PyTorch's (x.float() * scale).to(out).
//
// C ABI (loaded with ctypes): dtype codes 0 = f32, 1 = bf16, 2 = f16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;        // elements per thread per step
constexpr int kThreads = 256;
// grid-stride loop: 8 blocks on each of an H100's 132 SMs; a larger grid
// would only queue
constexpr int64_t kMaxBlocks = 1056;

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

template <typename T>
struct Words {  // 16-byte words holding kVec elements of T
  static constexpr int kCount = kVec * sizeof(T) / sizeof(uint4);
};

template <typename InT, typename OutT>
__global__ void __launch_bounds__(kThreads)
scale_cast_kernel(const InT* __restrict__ x, OutT* __restrict__ out,
                  int64_t n, float scale, bool vectorized) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t scalar_from = 0;
  if (vectorized) {
    constexpr int kIn = Words<InT>::kCount;
    constexpr int kOut = Words<OutT>::kCount;
    const int64_t nvec = n / kVec;
    const uint4* xw = reinterpret_cast<const uint4*>(x);
    uint4* ow = reinterpret_cast<uint4*>(out);
    for (int64_t v = tid; v < nvec; v += stride) {
      uint4 in_w[kIn];
#pragma unroll
      for (int w = 0; w < kIn; ++w) in_w[w] = __ldg(xw + v * kIn + w);
      const InT* xin = reinterpret_cast<const InT*>(in_w);
      uint4 out_w[kOut];
      OutT* o = reinterpret_cast<OutT*>(out_w);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        o[k] = from_f32<OutT>(__fmul_rn(to_f32(xin[k]), scale));
#pragma unroll
      for (int w = 0; w < kOut; ++w) ow[v * kOut + w] = out_w[w];
    }
    scalar_from = nvec * kVec;
  }
  for (int64_t i = scalar_from + tid; i < n; i += stride)
    out[i] = from_f32<OutT>(__fmul_rn(to_f32(x[i]), scale));
}

template <typename InT, typename OutT>
int launch(const void* x, void* out, int64_t n, float scale,
           cudaStream_t stream) {
  const bool vectorized = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                          (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t work = vectorized ? (n / kVec + n % kVec) : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  scale_cast_kernel<InT, OutT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const InT*>(x), static_cast<OutT*>(out), n, scale,
      vectorized);
  return (int)cudaGetLastError();
}

template <typename InT>
int dispatch_out(const void* x, void* out, int64_t n, int out_dtype,
                 float scale, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return launch<InT, float>(x, out, n, scale, stream);
    case 1: return launch<InT, __nv_bfloat16>(x, out, n, scale, stream);
    case 2: return launch<InT, __half>(x, out, n, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int hvtpu_scale_cast(const void* x, void* out, int64_t n,
                                int in_dtype, int out_dtype, float scale,
                                void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0: return dispatch_out<float>(x, out, n, out_dtype, scale, s);
    case 1:
      return dispatch_out<__nv_bfloat16>(x, out, n, out_dtype, scale, s);
    case 2: return dispatch_out<__half>(x, out, n, out_dtype, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
