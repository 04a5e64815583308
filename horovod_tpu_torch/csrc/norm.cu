// TpuBatchNorm for Hopper (sm_90a): the statistics, the normalize, the
// ReLU and the block's residual add, two kernels forward and two backward.
//
// Replaces no Pallas kernel: the JAX package's norm
// (horovod_tpu/models/tpu_norm.py) is plain jnp, which XLA fuses with the
// ReLU and the residual add.  Eager PyTorch ran the same function as ~25
// ops a norm (an fp32 copy of the activation, per-channel broadcasts over
// channels-last memory, column reductions) and as many backward nodes.
//
// Over the (M, C) rows of a channels-last activation (M = N*H*W), with R
// rounding to the compute dtype:
//
//   norm_stats        per-channel fp32 sums of x and x^2 -> mean, E[x^2],
//                     var = max(E[x^2] - mean^2, 0), the running stats,
//                     inv = scale * rsqrt(var + eps), shift = bias -
//                     mean * inv, a = R(inv), b = R(shift)
//   norm_apply        y = relu?(R(r + R(R(x * a) + b)))  (r: the residual,
//                     where one is added)
//   norm_grad_reduce  per-channel fp32 sums of g and g * x, g = dy masked
//                     by the ReLU -> d scale, d bias, d mean, d E[x^2]
//   norm_grad_input   dx = R(a * g + c0 + c1 * x), c0 = d mean / M,
//                     c1 = 2 d E[x^2] / M, in fp32, rounded once; dr = g
//                     where a residual was added
//   norm_finalize     the statistics' tail alone: after the moments were
//                     averaged over ranks (synchronized norm), or from the
//                     running stats (eval)
//
// Each rounding of the plain composition (ops/norm.py batch_norm_plain)
// happens in its order (__fmul_rn / __fadd_rn, round-to-nearest-even
// casts, no --use_fast_math), so the forward is the plain one bit for bit
// wherever a and b round alike.  The backward differentiates that forward
// with the roundings as identities: where the variance clamps, it passes
// no gradient.
//
// Bound: memory.  In bf16 the forward moves 6 bytes an element (the sums
// read x; apply reads x and writes y), 8 with a residual; the backward 10
// (the sums read dy and x; dx reads both and writes), 16 with a residual
// (the mask reads the saved y twice, dr is written).  ResNet-50 at batch
// 256 moves ~59 GB a step through them: ~17.6 ms at 3.35 TB/s.
//
// Design.  A thread owns V neighbouring channels (one 16-byte vector;
// one element where a row, C elements, is not a multiple of 16 bytes;
// ops/norm.py hands every tensor over 16-byte aligned); the
// threads of a row tile sit on neighbouring vectors of a row, at most 8
// of them (128 bytes), and a CTA covers kThreads / (threads a row) rows
// an iteration, so a warp reads whole lines.  The grid is channel tiles
// x row chunks, sized by ops/norm.py `plan` from (M, C) to one wave: as
// many CTAs as the card holds at once of that kernel
// (hvtpu_norm_ctas_per_sm), so no second, partial wave trails.  A thread
// keeps its channels' constants in registers and kUnroll rows' loads in
// flight.  The reductions are deterministic: a thread sums its rows in
// order, the CTA combines its row groups in a fixed order in shared
// memory into one partial per channel, the last CTA of each kGroup
// chunks (a counter, which that CTA resets) sums their partials in a
// fixed order, and the last of those groups sums the groups' and
// finalizes.  The two levels and the narrow tiles (64 channels in bf16)
// keep each serial sum short: it is the reduction kernels' tail.  No
// float atomics: the same input gives the same bits, which keeps remat's
// recomputation bitwise.
//
// C ABI (loaded with ctypes): dtype codes 0 = f32, 1 = bf16, 2 = f16;
// `plan` is int64[7] (rows, channels, threads a row, tiles, rows an
// iteration, chunks, rows a chunk).  Every function returns the launch's
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kGroup = 16;  // chunks whose partials one CTA sums first

// rows of the statistics buffer (ops/norm.py STAT_ROWS)
enum StatRow { kA = 0, kB, kMean, kRstd, kInv, kScale, kPass, kStatRows };
// rows of the gradient buffer (ops/norm.py GRAD_ROWS)
enum GradRow { kDScale = 0, kDBias, kDMean, kDMeanSq, kGradRows };
// where the backward's ReLU mask comes from (ops/norm.py MASK_*)
enum Mask { kNoMask = 0, kRecompute = 1, kSaved = 2 };

struct Plan {
  int64_t rows;
  int64_t channels;
  int64_t tpr;         // threads a row tile
  int64_t tiles;       // channel tiles (gridDim.y)
  int64_t rpi;         // rows an iteration (kThreads / tpr)
  int64_t chunks;      // row chunks (gridDim.x)
  int64_t chunk_rows;  // a multiple of rpi
};

template <typename T> struct Tr;
template <> struct Tr<float> {
  using Bits = uint32_t;
  static __device__ __forceinline__ float f(Bits b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ Bits bits(float v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct Tr<__nv_bfloat16> {
  using Bits = uint16_t;
  static __device__ __forceinline__ float f(Bits b) {
    return __uint_as_float((uint32_t)b << 16);
  }
  static __device__ __forceinline__ Bits bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float round(float v) {
    return f(bits(v));
  }
};
template <> struct Tr<__half> {
  using Bits = uint16_t;
  static __device__ __forceinline__ float f(Bits b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ Bits bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
  static __device__ __forceinline__ float round(float v) {
    return f(bits(v));
  }
};

template <int kBytes> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };

// V elements of one row, moved as one word
template <typename T, int V>
struct Vec {
  using Bits = typename Tr<T>::Bits;
  using W = typename Word<sizeof(Bits) * V>::type;
  union {
    W w;
    Bits b[V];
  };
  __device__ __forceinline__ void load(const Bits* p) {
    w = *reinterpret_cast<const W*>(p);
  }
  __device__ __forceinline__ void store(Bits* p) const {
    *reinterpret_cast<W*>(p) = w;
  }
  __device__ __forceinline__ float operator[](int k) const {
    return Tr<T>::f(b[k]);
  }
};

// a thread's place: its first channel, its row in an iteration
struct Lane {
  int64_t col;
  int64_t row;  // first row of the thread in the CTA's chunk
  int64_t end;  // the chunk's end
  int i;
  bool on;
};

template <int V>
__device__ __forceinline__ Lane lane_of(const Plan& p) {
  const int t = threadIdx.x;
  const int j = t % (int)p.tpr;
  Lane l;
  l.i = t / (int)p.tpr;
  l.col = ((int64_t)blockIdx.y * p.tpr + j) * V;
  l.on = l.i < p.rpi && l.col < p.channels;
  l.row = (int64_t)blockIdx.x * p.chunk_rows + l.i;
  const int64_t end = (int64_t)(blockIdx.x + 1) * p.chunk_rows;
  l.end = end < p.rows ? end : p.rows;
  return l;
}

// Fixed-order sum of src[r][c] over rows [r0, r1), for the tile's
// channels: thread (g, cc) of the CTA takes rows r0 + g, r0 + g + G, ...
// (G = kThreads / channels of a tile), then the G sums combine in order
// of g in shared memory.  Every thread of the CTA calls it; it returns
// true, with the channel's sum in *out and its index in *c, in the
// threads g = 0 that hold one of the tile's channels.
template <int V>
__device__ bool sum_rows(const Plan& p, const float2* src, int64_t r0,
                         int64_t r1, float2* out, int64_t* c) {
  __shared__ float2 red[kThreads];
  const int tc = (int)p.tpr * V;  // channels of a tile
  const int groups = kThreads / tc;
  const int t = threadIdx.x, g = t / tc;
  const int64_t ch = (int64_t)blockIdx.y * tc + t % tc;
  float2 acc = make_float2(0.f, 0.f);
  if (g < groups && ch < p.channels) {
#pragma unroll 4
    for (int64_t r = r0 + g; r < r1; r += groups) {
      const float2 w = __ldcg(src + r * p.channels + ch);
      acc.x += w.x;
      acc.y += w.y;
    }
  }
  red[t] = acc;
  __syncthreads();
  if (g != 0 || ch >= p.channels) return false;
  for (int k = 1; k < groups; ++k) {
    const float2 w = red[k * tc + t];
    acc.x += w.x;
    acc.y += w.y;
  }
  *out = acc;
  *c = ch;
  return true;
}

// True in every thread of the CTA that arrives last of `n` at *counter,
// which that CTA resets for the next launch.  Each thread's writes before
// the call are fenced, so the last CTA reads them (through L2, __ldcg).
__device__ bool arrive(unsigned* counter, unsigned n) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == n - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  return last;
}

// The per-channel sums of (u, v) over the whole grid, in a fixed order:
// the CTA combines its row groups in shared memory into one partial per
// channel (partials[chunk][c]); the last CTA of each kGroup chunks sums
// theirs (into the group rows after the chunks); the last of the groups
// sums those.  True, with the channel's total in *out and its index in
// *c, in the threads of the tile's last CTA that hold a channel.
template <int V>
__device__ bool reduce_grid(const Plan& p, const Lane& l, const float* u,
                            const float* v, float2* __restrict__ partials,
                            unsigned* counters, float2* out, int64_t* c) {
  __shared__ float2 red[kThreads * V];
  const int tc = (int)p.tpr * V;
  const int t = threadIdx.x;
  if (l.on) {
    const int base = l.i * tc + (t % (int)p.tpr) * V;
#pragma unroll
    for (int k = 0; k < V; ++k) red[base + k] = make_float2(u[k], v[k]);
  }
  __syncthreads();
  const int64_t ch = (int64_t)blockIdx.y * tc + t;
  if (t < tc && ch < p.channels) {
    float2 acc = red[t];
    for (int i = 1; i < (int)p.rpi; ++i) {
      const float2 w = red[i * tc + t];
      acc.x += w.x;
      acc.y += w.y;
    }
    partials[(int64_t)blockIdx.x * p.channels + ch] = acc;
  }
  const int64_t groups = (p.chunks + kGroup - 1) / kGroup;
  const int64_t group = blockIdx.x / kGroup;
  const int64_t g0 = group * kGroup;
  const int64_t g1 = g0 + kGroup < p.chunks ? g0 + kGroup : p.chunks;
  unsigned* cnt = counters + (int64_t)blockIdx.y * (groups + 1);
  if (!arrive(cnt + group, (unsigned)(g1 - g0))) return false;
  float2* gpart = partials + p.chunks * p.channels;
  float2 sum;
  int64_t gc;
  if (sum_rows<V>(p, partials, g0, g1, &sum, &gc))
    gpart[group * p.channels + gc] = sum;
  if (!arrive(cnt + groups, (unsigned)groups)) return false;
  return sum_rows<V>(p, gpart, 0, groups, out, c);
}

// The per-channel constants from the mean and the variance.
template <typename T>
__device__ __forceinline__ void finish(int64_t c, int64_t C, float mean,
                                       float var, float pass,
                                       const float* scale, const float* bias,
                                       float eps, float* st) {
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  const float s = scale[c];
  const float inv = __fmul_rn(rstd, s);
  const float shift = __fadd_rn(__fmul_rn(-mean, inv), bias[c]);
  st[kA * C + c] = Tr<T>::round(inv);
  st[kB * C + c] = Tr<T>::round(shift);
  st[kMean * C + c] = mean;
  st[kRstd * C + c] = rstd;
  st[kInv * C + c] = inv;
  st[kScale * C + c] = s;
  st[kPass * C + c] = pass;
}

// From the batch's moments: the clamped variance, the running stats, the
// constants.
template <typename T>
__device__ __forceinline__ void from_moments(
    int64_t c, int64_t C, float mean, float msq, const float* scale,
    const float* bias, float* run_mean, float* run_var, float momentum,
    float one_minus_m, float eps, int update, float* st) {
  const float raw = __fsub_rn(msq, __fmul_rn(mean, mean));
  const float var = raw < 0.f ? 0.f : raw;  // keeps a NaN, as clamp does
  if (update) {
    run_mean[c] = __fadd_rn(__fmul_rn(momentum, run_mean[c]),
                            __fmul_rn(one_minus_m, mean));
    run_var[c] = __fadd_rn(__fmul_rn(momentum, run_var[c]),
                           __fmul_rn(one_minus_m, var));
  }
  finish<T>(c, C, mean, var, raw >= 0.f ? 1.f : 0.f, scale, bias, eps, st);
}

// ---------------------------------------------------------------------------
// forward

struct StatsArgs {
  Plan p;
  const void* x;
  float2* partials;    // [chunks + groups][C]: (sum, sum of squares)
  unsigned* counters;  // [tiles][groups + 1], zero between launches
  float* out;          // finalize: [kStatRows][C]; else [2][C] moments
  const float* scale;
  const float* bias;
  float* run_mean;
  float* run_var;
  float momentum, one_minus_m, eps, inv_rows;
  int finalize, update;
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
norm_stats_kernel(const StatsArgs a) {
  using B = typename Tr<T>::Bits;
  const Plan& p = a.p;
  const Lane l = lane_of<V>(p);
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  if (l.on) {
    const B* x = static_cast<const B*>(a.x) + l.col;
    const int64_t step = p.rpi * p.channels;
    int64_t r = l.row;
    for (; r + (kUnroll - 1) * p.rpi < l.end; r += kUnroll * p.rpi) {
      Vec<T, V> w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u].load(x + r * p.channels + u * step);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float f = w[u][k];
          s[k] += f;
          q[k] = fmaf(f, f, q[k]);
        }
    }
    for (; r < l.end; r += p.rpi) {
      Vec<T, V> w;
      w.load(x + r * p.channels);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = w[k];
        s[k] += f;
        q[k] = fmaf(f, f, q[k]);
      }
    }
  }
  float2 tot;
  int64_t c;
  if (!reduce_grid<V>(p, l, s, q, a.partials, a.counters, &tot, &c)) return;
  const float mean = tot.x * a.inv_rows, msq = tot.y * a.inv_rows;
  if (!a.finalize) {
    a.out[c] = mean;
    a.out[p.channels + c] = msq;
    return;
  }
  from_moments<T>(c, p.channels, mean, msq, a.scale, a.bias, a.run_mean,
                  a.run_var, a.momentum, a.one_minus_m, a.eps, a.update,
                  a.out);
}

struct FinalizeArgs {
  int64_t channels;
  const float* moments;  // [2][C] averaged moments, or null: eval
  float* stats;          // [kStatRows][C]
  const float* scale;
  const float* bias;
  float* run_mean;
  float* run_var;
  float momentum, one_minus_m, eps;
  int update;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_finalize_kernel(const FinalizeArgs a) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.channels) return;
  if (a.moments)
    from_moments<T>(c, a.channels, a.moments[c], a.moments[a.channels + c],
                    a.scale, a.bias, a.run_mean, a.run_var, a.momentum,
                    a.one_minus_m, a.eps, a.update, a.stats);
  else  // eval: the running stats as they are, no clamp
    finish<T>(c, a.channels, a.run_mean[c], a.run_var[c], 0.f, a.scale,
              a.bias, a.eps, a.stats);
}

struct ApplyArgs {
  Plan p;
  const void* x;
  const void* res;
  void* y;
  const float* stats;
};

template <typename T, bool kRes, bool kRelu>
__device__ __forceinline__ float epilogue(float x, float a, float b,
                                          float r) {
  float v = Tr<T>::round(__fmul_rn(x, a));
  v = Tr<T>::round(__fadd_rn(v, b));
  if (kRes) v = Tr<T>::round(__fadd_rn(r, v));
  if (kRelu) v = v < 0.f ? 0.f : v;  // keeps a NaN, as relu does
  return v;
}

template <typename T, int V, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
norm_apply_kernel(const ApplyArgs a) {
  using B = typename Tr<T>::Bits;
  const Plan& p = a.p;
  const Lane l = lane_of<V>(p);
  if (!l.on) return;
  const int64_t C = p.channels;
  float ca[V], cb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    ca[k] = a.stats[kA * C + l.col + k];
    cb[k] = a.stats[kB * C + l.col + k];
  }
  const B* x = static_cast<const B*>(a.x) + l.col;
  const B* res = static_cast<const B*>(a.res) + l.col;
  B* y = static_cast<B*>(a.y) + l.col;
  const int64_t step = p.rpi * C;
  int64_t r = l.row;
  for (; r + (kUnroll - 1) * p.rpi < l.end; r += kUnroll * p.rpi) {
    Vec<T, V> vx[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      vx[u].load(x + r * C + u * step);
      if (kRes) vr[u].load(res + r * C + u * step);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Vec<T, V> out;
#pragma unroll
      for (int k = 0; k < V; ++k)
        out.b[k] = Tr<T>::bits(epilogue<T, kRes, kRelu>(
            vx[u][k], ca[k], cb[k], kRes ? vr[u][k] : 0.f));
      out.store(y + r * C + u * step);
    }
  }
  for (; r < l.end; r += p.rpi) {
    Vec<T, V> vx, vr, out;
    vx.load(x + r * C);
    if (kRes) vr.load(res + r * C);
#pragma unroll
    for (int k = 0; k < V; ++k)
      out.b[k] = Tr<T>::bits(epilogue<T, kRes, kRelu>(
          vx[k], ca[k], cb[k], kRes ? vr[k] : 0.f));
    out.store(y + r * C);
  }
}

// ---------------------------------------------------------------------------
// backward

struct GradArgs {
  Plan p;
  const void* dy;
  const void* x;
  const void* y;  // the saved output (kSaved)
  const float* stats;
  float2* partials;    // norm_grad_reduce: [chunks + groups][C]
                       // (sum g, sum g x)
  unsigned* counters;  // norm_grad_reduce: [tiles][groups + 1]
  float* grads;        // norm_grad_reduce: [kGradRows][C]
  const float* dmom;   // norm_grad_input: [2][C] d mean, d E[x^2]
  void* dx;
  void* dr;
  float inv_rows;
  int training;
};

// dy masked by the ReLU: zero where the ReLU's output is <= 0, as
// threshold_backward reads it
template <typename T, int kMask>
__device__ __forceinline__ float masked(float dy, float x, float y, float a,
                                        float b) {
  if (kMask == kRecompute) {
    const float v = Tr<T>::round(__fadd_rn(Tr<T>::round(__fmul_rn(x, a)), b));
    return v <= 0.f ? 0.f : dy;
  }
  if (kMask == kSaved) return y <= 0.f ? 0.f : dy;
  return dy;
}

template <typename T, int V, int kMask>
__global__ void __launch_bounds__(kThreads)
norm_grad_reduce_kernel(const GradArgs a) {
  using B = typename Tr<T>::Bits;
  const Plan& p = a.p;
  const Lane l = lane_of<V>(p);
  const int64_t C = p.channels;
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  if (l.on) {
    float ca[V], cb[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      ca[k] = kMask == kRecompute ? a.stats[kA * C + l.col + k] : 0.f;
      cb[k] = kMask == kRecompute ? a.stats[kB * C + l.col + k] : 0.f;
    }
    const B* dy = static_cast<const B*>(a.dy) + l.col;
    const B* x = static_cast<const B*>(a.x) + l.col;
    const B* y = static_cast<const B*>(a.y) + l.col;
    const int64_t step = p.rpi * C;
    int64_t r = l.row;
    for (; r + (kUnroll - 1) * p.rpi < l.end; r += kUnroll * p.rpi) {
      Vec<T, V> vd[kUnroll], vx[kUnroll], vy[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        vd[u].load(dy + r * C + u * step);
        vx[u].load(x + r * C + u * step);
        if (kMask == kSaved) vy[u].load(y + r * C + u * step);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xf = vx[u][k];
          const float g = masked<T, kMask>(
              vd[u][k], xf, kMask == kSaved ? vy[u][k] : 0.f, ca[k], cb[k]);
          s[k] += g;
          q[k] = fmaf(g, xf, q[k]);
        }
    }
    for (; r < l.end; r += p.rpi) {
      Vec<T, V> vd, vx, vy;
      vd.load(dy + r * C);
      vx.load(x + r * C);
      if (kMask == kSaved) vy.load(y + r * C);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xf = vx[k];
        const float g = masked<T, kMask>(
            vd[k], xf, kMask == kSaved ? vy[k] : 0.f, ca[k], cb[k]);
        s[k] += g;
        q[k] = fmaf(g, xf, q[k]);
      }
    }
  }
  float2 tot;
  int64_t c;
  if (!reduce_grid<V>(p, l, s, q, a.partials, a.counters, &tot, &c)) return;
  const float* st = a.stats;
  const float sg = tot.x, sgx = tot.y;
  const float mean = st[kMean * C + c], rstd = st[kRstd * C + c];
  // d inv: a = R(inv) takes sum g x, b = R(bias - mean inv) takes sum g
  const float dinv = fmaf(-mean, sg, sgx);
  a.grads[kDScale * C + c] = dinv * rstd;
  a.grads[kDBias * C + c] = sg;
  float dmean = 0.f, dmsq = 0.f;
  if (a.training) {
    // rstd = (var + eps)^-1/2, inv = rstd scale, var = E[x^2] - mean^2
    const float dvar =
        st[kPass * C + c] != 0.f
            ? -0.5f * dinv * st[kScale * C + c] * rstd * rstd * rstd
            : 0.f;
    dmean = fmaf(-2.f * mean, dvar, -st[kInv * C + c] * sg);
    dmsq = dvar;
  }
  a.grads[kDMean * C + c] = dmean;
  a.grads[kDMeanSq * C + c] = dmsq;
}

template <typename T, int V, int kMask>
__global__ void __launch_bounds__(kThreads)
norm_grad_input_kernel(const GradArgs a) {
  using B = typename Tr<T>::Bits;
  const Plan& p = a.p;
  const Lane l = lane_of<V>(p);
  if (!l.on) return;
  const int64_t C = p.channels;
  float ca[V], cb[V], c0[V], c1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int64_t c = l.col + k;
    ca[k] = a.stats[kA * C + c];
    cb[k] = kMask == kRecompute ? a.stats[kB * C + c] : 0.f;
    c0[k] = a.training ? a.dmom[c] * a.inv_rows : 0.f;
    c1[k] = a.training ? 2.f * a.dmom[C + c] * a.inv_rows : 0.f;
  }
  const B* dy = static_cast<const B*>(a.dy) + l.col;
  const B* x = static_cast<const B*>(a.x) + l.col;
  const B* y = static_cast<const B*>(a.y) + l.col;
  B* dx = static_cast<B*>(a.dx) + l.col;
  B* dr = static_cast<B*>(a.dr) + l.col;
  const int64_t step = p.rpi * C;
  int64_t r = l.row;
  for (; r + (kUnroll - 1) * p.rpi < l.end; r += kUnroll * p.rpi) {
    Vec<T, V> vd[kUnroll], vx[kUnroll], vy[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      vd[u].load(dy + r * C + u * step);
      vx[u].load(x + r * C + u * step);
      if (kMask == kSaved) vy[u].load(y + r * C + u * step);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Vec<T, V> ox, og;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xf = vx[u][k];
        const float g = masked<T, kMask>(
            vd[u][k], xf, kMask == kSaved ? vy[u][k] : 0.f, ca[k], cb[k]);
        ox.b[k] = Tr<T>::bits(fmaf(c1[k], xf, fmaf(ca[k], g, c0[k])));
        og.b[k] = Tr<T>::bits(g);
      }
      ox.store(dx + r * C + u * step);
      if (kMask == kSaved) og.store(dr + r * C + u * step);
    }
  }
  for (; r < l.end; r += p.rpi) {
    Vec<T, V> vd, vx, vy, ox, og;
    vd.load(dy + r * C);
    vx.load(x + r * C);
    if (kMask == kSaved) vy.load(y + r * C);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xf = vx[k];
      const float g = masked<T, kMask>(
          vd[k], xf, kMask == kSaved ? vy[k] : 0.f, ca[k], cb[k]);
      ox.b[k] = Tr<T>::bits(fmaf(c1[k], xf, fmaf(ca[k], g, c0[k])));
      og.b[k] = Tr<T>::bits(g);
    }
    ox.store(dx + r * C);
    if (kMask == kSaved) og.store(dr + r * C);
  }
}

// ---------------------------------------------------------------------------
// host side

template <int N> using IntC = std::integral_constant<int, N>;

// f(T{}, IntC<V>{}) for the dtype code and the vector width: the full
// 16 bytes, or one element
template <typename F>
int by_type(int dtype, int vec, F&& f) {
  switch (dtype) {
    case 0:
      if (vec == 4) return f(float{}, IntC<4>{});
      if (vec == 1) return f(float{}, IntC<1>{});
      break;
    case 1:
      if (vec == 8) return f(__nv_bfloat16{}, IntC<8>{});
      if (vec == 1) return f(__nv_bfloat16{}, IntC<1>{});
      break;
    case 2:
      if (vec == 8) return f(__half{}, IntC<8>{});
      if (vec == 1) return f(__half{}, IntC<1>{});
      break;
    default:
      break;
  }
  return (int)cudaErrorInvalidValue;
}

bool plan_of(const int64_t* in, int vec, Plan* p) {
  p->rows = in[0];
  p->channels = in[1];
  p->tpr = in[2];
  p->tiles = in[3];
  p->rpi = in[4];
  p->chunks = in[5];
  p->chunk_rows = in[6];
  return p->rows > 0 && p->channels > 0 && vec > 0 &&
         p->channels % vec == 0 && p->tpr > 0 && p->tpr * vec <= kThreads &&
         p->rpi > 0 && p->tpr * p->rpi <= kThreads &&
         p->tiles * p->tpr * vec >= p->channels && p->tiles < 65536 &&
         p->chunk_rows > 0 && p->chunk_rows % p->rpi == 0 &&
         p->chunks > 0 && p->chunks * p->chunk_rows >= p->rows &&
         (p->chunks - 1) * p->chunk_rows < p->rows &&
         p->chunks <= 0x7fffffff;
}

dim3 grid_of(const Plan& p) {
  return dim3((unsigned)p.chunks, (unsigned)p.tiles);
}

float inv_rows_of(const Plan& p) { return (float)(1.0 / (double)p.rows); }

}  // namespace

extern "C" int hvtpu_norm_threads() { return kThreads; }
extern "C" int hvtpu_norm_group() { return kGroup; }
extern "C" int hvtpu_norm_stat_rows() { return kStatRows; }
extern "C" int hvtpu_norm_grad_rows() { return kGradRows; }

// CTAs of one kernel an SM holds at once, into *out: kind 0 norm_stats,
// 1 norm_apply (variant 2 residual + relu), 2 norm_grad_reduce, 3
// norm_grad_input (variant the mask).  ops/norm.py sizes each grid to
// one such wave.
extern "C" int hvtpu_norm_ctas_per_sm(int kind, int dtype, int vec,
                                      int variant, int* out) {
  return by_type(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    const void* fn = nullptr;
    if (kind == 0)
      fn = (const void*)norm_stats_kernel<T, V>;
    else if (kind == 1)
      fn = variant == 3   ? (const void*)norm_apply_kernel<T, V, true, true>
           : variant == 2 ? (const void*)norm_apply_kernel<T, V, true, false>
           : variant == 1 ? (const void*)norm_apply_kernel<T, V, false, true>
                          : (const void*)norm_apply_kernel<T, V, false, false>;
    else if (kind == 2)
      fn = variant == kSaved
               ? (const void*)norm_grad_reduce_kernel<T, V, kSaved>
           : variant == kRecompute
               ? (const void*)norm_grad_reduce_kernel<T, V, kRecompute>
               : (const void*)norm_grad_reduce_kernel<T, V, kNoMask>;
    else if (kind == 3)
      fn = variant == kSaved
               ? (const void*)norm_grad_input_kernel<T, V, kSaved>
           : variant == kRecompute
               ? (const void*)norm_grad_input_kernel<T, V, kRecompute>
               : (const void*)norm_grad_input_kernel<T, V, kNoMask>;
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn,
                                                             kThreads, 0);
  });
}

// training forward, first kernel: the statistics; finalize = 1 writes
// the constants ([kStatRows][C]) and the running stats, finalize = 0
// the moments ([2][C]: mean, E[x^2]) for norm_finalize
extern "C" int hvtpu_norm_stats(int dtype, int vec, const int64_t* plan,
                                const void* x, void* partials,
                                void* counters, void* out, const void* scale,
                                const void* bias, void* run_mean,
                                void* run_var, float momentum,
                                float one_minus_m, float eps, int finalize,
                                int update, void* stream) {
  StatsArgs a;
  if (!plan_of(plan, vec, &a.p)) return (int)cudaErrorInvalidValue;
  a.x = x;
  a.partials = static_cast<float2*>(partials);
  a.counters = static_cast<unsigned*>(counters);
  a.out = static_cast<float*>(out);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.run_mean = static_cast<float*>(run_mean);
  a.run_var = static_cast<float*>(run_var);
  a.momentum = momentum;
  a.one_minus_m = one_minus_m;
  a.eps = eps;
  a.inv_rows = inv_rows_of(a.p);
  a.finalize = finalize;
  a.update = update;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_type(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    norm_stats_kernel<T, decltype(v)::value>
        <<<grid_of(a.p), kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  });
}

// the constants from averaged moments ([2][C]), or from the running
// stats where moments is null (eval)
extern "C" int hvtpu_norm_finalize(int dtype, int64_t channels,
                                   const void* moments, void* stats,
                                   const void* scale, const void* bias,
                                   void* run_mean, void* run_var,
                                   float momentum, float one_minus_m,
                                   float eps, int update, void* stream) {
  if (channels <= 0) return (int)cudaErrorInvalidValue;
  FinalizeArgs a;
  a.channels = channels;
  a.moments = static_cast<const float*>(moments);
  a.stats = static_cast<float*>(stats);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.run_mean = static_cast<float*>(run_mean);
  a.run_var = static_cast<float*>(run_var);
  a.momentum = momentum;
  a.one_minus_m = one_minus_m;
  a.eps = eps;
  a.update = update;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((channels + kThreads - 1) / kThreads);
  return by_type(dtype, 1, [&](auto t, auto) {
    using T = decltype(t);
    norm_finalize_kernel<T><<<blocks, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  });
}

// y = relu?(R(res + R(R(x a) + b))), res null for none
extern "C" int hvtpu_norm_apply(int dtype, int vec, const int64_t* plan,
                                const void* x, const void* res, void* y,
                                const void* stats, int relu, void* stream) {
  ApplyArgs a;
  if (!plan_of(plan, vec, &a.p)) return (int)cudaErrorInvalidValue;
  a.x = x;
  a.res = res;
  a.y = y;
  a.stats = static_cast<const float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a.p);
  return by_type(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    if (res && relu)
      norm_apply_kernel<T, V, true, true><<<grid, kThreads, 0, s>>>(a);
    else if (res)
      norm_apply_kernel<T, V, true, false><<<grid, kThreads, 0, s>>>(a);
    else if (relu)
      norm_apply_kernel<T, V, false, true><<<grid, kThreads, 0, s>>>(a);
    else
      norm_apply_kernel<T, V, false, false><<<grid, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  });
}

// backward, first kernel: sum g and sum g x, then d scale, d bias and
// (training) d mean, d E[x^2] into grads ([kGradRows][C])
extern "C" int hvtpu_norm_grad_reduce(int dtype, int vec, const int64_t* plan,
                                      int mask, const void* dy,
                                      const void* x, const void* y,
                                      const void* stats, void* partials,
                                      void* counters, void* grads,
                                      int training, void* stream) {
  GradArgs a = {};
  if (!plan_of(plan, vec, &a.p) || mask < kNoMask || mask > kSaved ||
      (mask == kSaved && !y))
    return (int)cudaErrorInvalidValue;
  a.dy = dy;
  a.x = x;
  a.y = y;
  a.stats = static_cast<const float*>(stats);
  a.partials = static_cast<float2*>(partials);
  a.counters = static_cast<unsigned*>(counters);
  a.grads = static_cast<float*>(grads);
  a.inv_rows = inv_rows_of(a.p);
  a.training = training;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a.p);
  return by_type(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    if (mask == kSaved)
      norm_grad_reduce_kernel<T, V, kSaved><<<grid, kThreads, 0, s>>>(a);
    else if (mask == kRecompute)
      norm_grad_reduce_kernel<T, V, kRecompute><<<grid, kThreads, 0, s>>>(a);
    else
      norm_grad_reduce_kernel<T, V, kNoMask><<<grid, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  });
}

// backward, second kernel: dx (and dr = g under kSaved) from the
// constants and dmom ([2][C]: d mean, d E[x^2], averaged over ranks for a
// synchronized norm; unread unless training)
extern "C" int hvtpu_norm_grad_input(int dtype, int vec, const int64_t* plan,
                                     int mask, const void* dy, const void* x,
                                     const void* y, const void* stats,
                                     const void* dmom, void* dx, void* dr,
                                     int training, void* stream) {
  GradArgs a = {};
  if (!plan_of(plan, vec, &a.p) || mask < kNoMask || mask > kSaved ||
      (mask == kSaved && (!y || !dr)) || (training && !dmom))
    return (int)cudaErrorInvalidValue;
  a.dy = dy;
  a.x = x;
  a.y = y;
  a.stats = static_cast<const float*>(stats);
  a.dmom = static_cast<const float*>(dmom);
  a.dx = dx;
  a.dr = dr;
  a.inv_rows = inv_rows_of(a.p);
  a.training = training;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a.p);
  return by_type(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    if (mask == kSaved)
      norm_grad_input_kernel<T, V, kSaved><<<grid, kThreads, 0, s>>>(a);
    else if (mask == kRecompute)
      norm_grad_input_kernel<T, V, kRecompute><<<grid, kThreads, 0, s>>>(a);
    else
      norm_grad_input_kernel<T, V, kNoMask><<<grid, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  });
}
