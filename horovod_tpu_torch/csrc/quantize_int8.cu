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
// seed and its index, whatever thread computes it.  The seed is read
// from device memory (an int32 the wrapper computed on the device), so
// no host sync is needed.
//
// Bound: memory.  Quantize reads the input once and writes 1 byte an
// element plus 4 bytes a block; dequantize reads 1 byte an element plus
// the scales and writes the output once.  At 3.35 TB/s a 25.56 M float32
// buffer takes at least 38.2 us either way.  A few dozen operations an
// element do not come near the card's rate.
//
// Design: a warp owns a whole quantization block, 8 warps a CTA, one
// CTA per 8 blocks (a persistent wave of warps looping over the blocks,
// and 2 blocks a warp, were 1-5% slower in torch_port_quantize_sweep.py).
// The block is cut into 16-byte words of the wide side (the
// input of A2, the output of A3): 4 float32 or 8 bfloat16/float16
// elements.  Word w of a block belongs to lane w % 32, so every load and
// store instruction of a warp covers a contiguous span, and each lane
// holds 32 elements of the block.
//   A2: a lane issues all its loads (8 or 4 words, evict-first: read
//       once) before anything else, reduces its 32 values, and the warp's
//       absmax is a shuffle reduction (no shared memory, no
//       __syncthreads); each word's codes go out as one 4- or 8-byte
//       store, the scale from lane 0.
//   A3: a lane loads the codes of its words (4 or 8 bytes each) and the
//       block's scale (one address for the whole warp), then writes each
//       word as one 16-byte store.
// Stores are evict-first.  On the 25.56 M buffer A2 reaches ~90% of the
// bound and A3 ~81% (H100 80GB HBM3, 700 W; PERF.md).  Index arithmetic
// inside a block is 32-bit.  A2's input in a block that is not whole
// (the last) or not 16-byte aligned, and A3's codes at an unaligned
// address, load element by element; A3's words that pass n, or an
// unaligned output, store element by element: bucket pieces are views
// at any offset.  Every multiply and add is an _rn intrinsic, so nvcc
// contracts nothing into an FMA, and the build has no --use_fast_math.
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

constexpr int kBlock = hvtpu::kQBlock;  // elements per quantization block
constexpr int kWarps = 8;               // warps a CTA, a block each
constexpr int kThreads = 32 * kWarps;
// __stcs (evict-first) stores: 2-3% faster for A3, a tie for A2 (sweep)
constexpr bool kStreamingStores = true;

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

// The words of a block of T: kElems elements a 16-byte word, kPerLane
// words a lane; the codes of one word travel as one Codes.
template <typename T>
struct Words {
  static constexpr int kElems = 16 / sizeof(T);
  static constexpr int kPerLane = kBlock / kElems / 32;
};
template <int kElems> struct CodeWord;
template <> struct CodeWord<4> { using type = uint32_t; };
template <> struct CodeWord<8> { using type = uint2; };

template <typename T>
__device__ __forceinline__ void store(T* p, T v) {
  if constexpr (kStreamingStores) __stcs(p, v);
  else *p = v;
}

template <typename InT, bool kStochastic>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const InT* __restrict__ x, int8_t* __restrict__ codes,
                float* __restrict__ scales, int64_t n, int64_t blocks,
                const int32_t* __restrict__ seed, bool aligned) {
  constexpr int kE = Words<InT>::kElems, kL = Words<InT>::kPerLane;
  using Codes = typename CodeWord<kE>::type;
  const int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= blocks) return;  // the warp's block: whole warps leave
  const int lane = threadIdx.x & 31;
  // issued first: its latency hides under the block's loads
  const uint32_t key = kStochastic ? (uint32_t)__ldg(seed) : 0u;
  const int64_t base = b * kBlock;
  const InT* xb = x + base;
  const int m = n - base < kBlock ? (int)(n - base) : kBlock;
  float v[kL][kE];
  if (aligned && m == kBlock) {
    // every load in flight before the first use; evict-first (__ldcs):
    // the input is read once, and streaming it through L2 would push out
    // the codes being written (8-9% faster than __ldg in the sweep)
    uint4 w[kL];
#pragma unroll
    for (int i = 0; i < kL; ++i)
      w[i] = __ldcs(reinterpret_cast<const uint4*>(xb) + i * 32 + lane);
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const InT* e = reinterpret_cast<const InT*>(&w[i]);
#pragma unroll
      for (int j = 0; j < kE; ++j) v[i][j] = to_f32(e[j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const int off = (i * 32 + lane) * kE;
#pragma unroll
      for (int j = 0; j < kE; ++j)
        v[i][j] = off + j < m ? to_f32(xb[off + j]) : 0.0f;
    }
  }
  float a = 0.0f;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      v[i][j] = flush(v[i][j]);
      a = max_nan(a, fabsf(v[i][j]));
    }
  }
  float inv;
  const float scale = hvtpu::block_scale(hvtpu::warp_max_nan(a), &inv);
  Codes* cb = reinterpret_cast<Codes*>(codes + base);
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    const int off = (i * 32 + lane) * kE;
    union {
      int8_t q[kE];
      Codes word;
    } out;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (kStochastic) {
        const float t = flush(__fmul_rn(v[i][j], inv));
        const uint32_t bits =
            dither_bits(key, (uint32_t)base + (uint32_t)(off + j));
        // (bits >> 9) * 2^-23 exactly, as 1.m - 1 (Sterbenz): no
        // conversion instruction
        const float u =
            __fsub_rn(__uint_as_float(0x3F800000u | (bits >> 9)), 1.0f);
        out.q[j] = hvtpu::code_of(floorf(__fadd_rn(t, u)));
      } else {
        out.q[j] = hvtpu::round_code(v[i][j], inv);
      }
    }
    // codes hold whole blocks and start 16-byte aligned (the wrapper
    // allocates them), so every word's codes go out at once
    store(cb + i * 32 + lane, out.word);
  }
  if (lane == 0) scales[b] = scale;
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ codes,
                  const float* __restrict__ scales, OutT* __restrict__ out,
                  int64_t n, int64_t blocks, bool aligned) {
  constexpr int kE = Words<OutT>::kElems, kL = Words<OutT>::kPerLane;
  using Codes = typename CodeWord<kE>::type;
  const int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= blocks) return;
  const int lane = threadIdx.x & 31;
  const int64_t base = b * kBlock;
  const int m = n - base < kBlock ? (int)(n - base) : kBlock;
  // codes hold whole blocks: every load is in range
  union {
    Codes word;
    int8_t q[kE];
  } c[kL];
  if (aligned) {
    const Codes* cb = reinterpret_cast<const Codes*>(codes + base);
#pragma unroll
    for (int i = 0; i < kL; ++i) c[i].word = __ldg(cb + i * 32 + lane);
  } else {
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const int off = (i * 32 + lane) * kE;
#pragma unroll
      for (int j = 0; j < kE; ++j) c[i].q[j] = codes[base + off + j];
    }
  }
  const float s = flush(__ldg(scales + b));
  OutT* ob = out + base;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    const int off = (i * 32 + lane) * kE;
    uint4 word;  // declared as a word, written as OutT
    OutT* o = reinterpret_cast<OutT*>(&word);
#pragma unroll
    for (int j = 0; j < kE; ++j)
      o[j] = from_f32<OutT>(__fmul_rn((float)c[i].q[j], s));
    if (aligned && off + kE <= m) {
      store(reinterpret_cast<uint4*>(ob + off), word);
    } else {
#pragma unroll
      for (int j = 0; j < kE; ++j)  // unrolled: `word` stays in registers
        if (off + j < m) ob[off + j] = o[j];
    }
  }
}

// a warp a block; 0 when the grid would be too large
unsigned grid_of(int64_t blocks) {
  const int64_t ctas = (blocks + kWarps - 1) / kWarps;
  return ctas > 0x7FFFFFFF ? 0u : (unsigned)ctas;
}

template <typename InT, bool kStochastic>
int launch_quantize_mode(const void* x, int64_t n, void* codes,
                         void* scales, const void* seed,
                         cudaStream_t stream) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  const unsigned grid = grid_of(blocks);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  quantize_kernel<InT, kStochastic><<<grid, kThreads, 0, stream>>>(
          static_cast<const InT*>(x), static_cast<int8_t*>(codes),
          static_cast<float*>(scales), n, blocks,
          static_cast<const int32_t*>(seed), aligned);
  return (int)cudaGetLastError();
}

template <typename InT>
int launch_quantize(const void* x, int64_t n, void* codes, void* scales,
                    const void* seed, bool stochastic, cudaStream_t stream) {
  return stochastic ? launch_quantize_mode<InT, true>(x, n, codes, scales,
                                                      seed, stream)
                    : launch_quantize_mode<InT, false>(x, n, codes, scales,
                                                       seed, stream);
}

template <typename OutT>
int launch_dequantize(const void* codes, const void* scales, int64_t n,
                      void* out, cudaStream_t stream) {
  using Codes = typename CodeWord<Words<OutT>::kElems>::type;
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  const unsigned grid = grid_of(blocks);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  const bool aligned =
      reinterpret_cast<uintptr_t>(codes) % sizeof(Codes) == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  dequantize_kernel<OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<OutT*>(out), n, blocks, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// codes: ceil(n/1024)*1024 int8, 16-byte aligned; scales: ceil(n/1024)
// f32; seed: one device int32, read only when stochastic != 0.
extern "C" int hvtpu_quantize_int8(const void* x, int in_dtype, int64_t n,
                                   void* codes, void* scales,
                                   const void* seed, int stochastic,
                                   void* stream) {
  if (n < 0 || (stochastic && seed == nullptr) ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
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

// out: n elements of out_dtype; codes and scales as above (codes at any
// address).
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
