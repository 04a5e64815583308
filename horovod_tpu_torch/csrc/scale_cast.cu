// fused_scale_cast for Hopper (sm_90a), over a table of tensors.
//
// Replaces horovod_tpu/ops/pallas_ops.py:_scale_cast_kernel (called from
// fused_scale_cast), the pre/postscale that horovod_tpu/eager/controller.py
// _apply_scale runs around the staged fused allreduce, together with the
// codec's cast and the pack into (unpack out of) the flat buffer that the
// reference runs beside it, tensor by tensor.
//
// One launch covers a table of entries (src, dst, n, start, four dtype
// codes).  Element i of an entry becomes
//
//     dst[i] = Dst(Own(f32(Own(Spec(src[i]))) * scale))
//
// which is both directions of the staged path: the prescale, the wire
// cast and the pack (Spec = Own = the gradient's dtype = Src, Dst = the
// flat buffer's), and the unpack, the codec's cast back and the
// postscale (Src = the flat buffer's dtype, Spec = the piece's, Own =
// Dst = the gradient's).  Every rounding of the reference's steps
// happens in its order: the multiply is __fmul_rn, the narrowing casts
// are round-to-nearest-even, and nothing is built with --use_fast_math
// (which would flush denormals), so the result is bitwise PyTorch's
// composition of the same casts.
//
// Bound: memory.  Each element is read once and written once, one
// multiply: a pass over ResNet-50's 25.56 M float32 gradients into an
// fp16 wire moves 153 MB, at least ~46 us at 3.35 TB/s.
//
// Design: the CTAs take equal ranges of the concatenated element space
// (the entries' prefix offsets `start`) and find their first entry by a
// binary search over the table, which travels by value in the kernel's
// parameters (__grid_constant__, read in place).  A CTA's range is
// kElems elements a thread; past one wave
// (kBlocksPerSm CTAs on each SM, the SM count queried from the device)
// the grid is a whole number of waves, so the block scheduler evens out
// the SMs' shares.  Within an entry a thread moves chunks of 8 elements
// (4 from float32 to float32): 16-byte words, one on a 2-byte side and
// two on a float32 side, the lanes of a warp on neighbouring chunks, 16
// elements a thread in flight.  Chunks start at the first element whose
// destination is 16-byte aligned; the source is loaded as words where it
// is aligned at the same element, else element by element.  The
// few elements before and after the aligned chunks take a scalar loop,
// so a destination at an odd offset moves as fast as an aligned one on
// the store side.
//
// The table is bounded by CUDA's 32,764-byte parameter limit (CUDA >=
// 12.1): hvtpu_scale_cast_max_entries() entries a launch; the caller
// splits a larger group over several launches.  A table of one entry
// launches an instance of that size, so a one-tensor call does not copy
// 32 KB of parameters.
//
// C ABI (loaded with ctypes): dtype codes 0 = f32, 1 = bf16, 2 = f16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kElems = 16;        // elements a thread a step
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;   // a wave: 1024 threads an SM
constexpr int kParamLimit = 32764;

struct Entry {
  const void* src;
  void* dst;
  int64_t n;      // elements
  int64_t start;  // prefix offset in the launch's element space
  uint8_t src_dt, spec_dt, own_dt, dst_dt;
};

struct Header {
  int32_t count;
  float scale;
  int64_t total;
};

template <int kCap>
struct Table {
  Header h;
  Entry e[kCap];
};

constexpr int kMaxEntries =
    (int)((kParamLimit - sizeof(Header)) / sizeof(Entry));
static_assert(sizeof(Table<kMaxEntries>) <= kParamLimit,
              "the table must fit the kernel parameter limit");

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

// v rounded to the dtype of `code`, kept in float32 (exact: float32
// holds every bfloat16 and float16 value)
__device__ __forceinline__ float round_to(int code, float v) {
  if (code == 1) return __bfloat162float(__float2bfloat16_rn(v));
  if (code == 2) return __half2float(__float2half_rn(v));
  return v;
}

struct Chain {  // what happens to an element between load and store
  int spec, own;
  float scale;
  __device__ __forceinline__ float operator()(float v) const {
    v = round_to(own, round_to(spec, v));
    return round_to(own, __fmul_rn(v, scale));
  }
};

// A chunk: the elements a thread moves at once, as many as 16 bytes of
// the narrower of the two dtypes hold (8, or 4 for float32 to float32),
// in one or two 16-byte words a side.
template <typename S, typename D>
struct Chunk {
  static constexpr int kN =
      16 / (sizeof(S) < sizeof(D) ? sizeof(S) : sizeof(D));
  static constexpr int kSrcBytes = kN * sizeof(S);
  static constexpr int kDstBytes = kN * sizeof(D);
  static constexpr int kSrcWords = kSrcBytes / 16;
  static constexpr int kDstWords = kDstBytes / 16;
  static constexpr int kPerStep = kElems / kN;  // chunks a thread a step
};

// Elements [p0, p1) of one entry, by the CTA's threads.  Chunk c of the
// aligned body starts at element a + c * kN; the lanes of a warp take
// neighbouring chunks.
template <typename S, typename D>
__device__ void run_piece(const Entry& en, int64_t p0, int64_t p1,
                          const Chain& f) {
  using C = Chunk<S, D>;
  const S* __restrict__ src = static_cast<const S*>(en.src);
  D* __restrict__ dst = static_cast<D*>(en.dst);
  // the first element at or after p0 whose destination chunk is aligned
  const unsigned mis =
      (unsigned)(reinterpret_cast<uintptr_t>(dst + p0) % C::kDstBytes);
  int64_t a = p0 + (mis ? (int64_t)((C::kDstBytes - mis) / sizeof(D)) : 0);
  if (a > p1) a = p1;
  const int64_t chunks = (p1 - a) / C::kN;
  const int64_t b = a + chunks * C::kN;
  const bool vec_src =
      reinterpret_cast<uintptr_t>(src + a) % C::kSrcBytes == 0;
  const S* __restrict__ s0 = src + a;
  D* __restrict__ d0 = dst + a;
  for (int64_t c0 = threadIdx.x; c0 < chunks;
       c0 += (int64_t)C::kPerStep * kThreads) {
    float x[C::kPerStep][C::kN];
#pragma unroll
    for (int u = 0; u < C::kPerStep; ++u) {
      const int64_t c = c0 + (int64_t)u * kThreads;
      if (c >= chunks) break;
      const S* p = s0 + c * C::kN;
      if (vec_src) {
        uint4 w[C::kSrcWords];
#pragma unroll
        for (int k = 0; k < C::kSrcWords; ++k)
          w[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
        const S* v = reinterpret_cast<const S*>(w);
#pragma unroll
        for (int k = 0; k < C::kN; ++k) x[u][k] = to_f32(v[k]);
      } else {
#pragma unroll
        for (int k = 0; k < C::kN; ++k) x[u][k] = to_f32(__ldg(p + k));
      }
    }
#pragma unroll
    for (int u = 0; u < C::kPerStep; ++u) {
      const int64_t c = c0 + (int64_t)u * kThreads;
      if (c >= chunks) break;
      uint4 w[C::kDstWords];
      D* v = reinterpret_cast<D*>(w);
#pragma unroll
      for (int k = 0; k < C::kN; ++k) v[k] = from_f32<D>(f(x[u][k]));
#pragma unroll
      for (int k = 0; k < C::kDstWords; ++k)
        reinterpret_cast<uint4*>(d0 + c * C::kN)[k] = w[k];
    }
  }
  // the unaligned head [p0, a) and the ragged tail [b, p1)
  const int64_t head = a - p0;
  for (int64_t i = threadIdx.x; i < head + (p1 - b); i += kThreads) {
    const int64_t j = i < head ? p0 + i : b + (i - head);
    dst[j] = from_f32<D>(f(to_f32(__ldg(src + j))));
  }
}

template <typename S>
__device__ __forceinline__ void dispatch_dst(const Entry& en, int64_t p0,
                                             int64_t p1, const Chain& f) {
  switch (en.dst_dt) {
    case 0: run_piece<S, float>(en, p0, p1, f); break;
    case 1: run_piece<S, __nv_bfloat16>(en, p0, p1, f); break;
    default: run_piece<S, __half>(en, p0, p1, f); break;
  }
}

template <int kCap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
scale_cast_table_kernel(const __grid_constant__ Table<kCap> t) {
  const int64_t total = t.h.total;
  // equal ranges, a multiple of 16 elements (whole chunks, 16-byte
  // aligned in any dtype for an aligned entry, so a single buffer has no
  // head or tail inside), every CTA of every wave with a share
  int64_t per = (total + gridDim.x - 1) / gridDim.x;
  per = (per + 15) / 16 * 16;
  const int64_t lo = (int64_t)blockIdx.x * per;
  const int64_t hi = lo + per < total ? lo + per : total;
  if (lo >= hi) return;
  // the last entry that starts at or before lo (zero-length entries share
  // their start with the next one, so it holds element lo)
  int e = 0, last = t.h.count - 1;
  while (e < last) {
    const int mid = (e + last + 1) / 2;
    if (t.e[mid].start <= lo) e = mid; else last = mid - 1;
  }
  for (; e < t.h.count && t.e[e].start < hi; ++e) {
    const Entry& en = t.e[e];
    const int64_t p0 = (lo > en.start ? lo : en.start) - en.start;
    const int64_t end = en.start + en.n;
    const int64_t p1 = (hi < end ? hi : end) - en.start;
    if (p0 >= p1) continue;
    const Chain f{en.spec_dt, en.own_dt, t.h.scale};
    switch (en.src_dt) {
      case 0: dispatch_dst<float>(en, p0, p1, f); break;
      case 1: dispatch_dst<__nv_bfloat16>(en, p0, p1, f); break;
      default: dispatch_dst<__half>(en, p0, p1, f); break;
    }
  }
}

template <int kCap>
int launch(const Entry* entries, const uint64_t* srcs, const uint64_t* dsts,
           int count, int64_t total, float scale,
           int64_t blocks, cudaStream_t stream) {
  Table<kCap> t;
  t.h.count = count;
  t.h.scale = scale;
  t.h.total = total;
  memcpy(t.e, entries, sizeof(Entry) * (size_t)count);
  for (int i = 0; i < count; ++i) {
    t.e[i].src = reinterpret_cast<const void*>(srcs[i]);
    t.e[i].dst = reinterpret_cast<void*>(dsts[i]);
  }
  scale_cast_table_kernel<kCap><<<(unsigned)blocks, kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hvtpu_scale_cast_max_entries() { return kMaxEntries; }

extern "C" int hvtpu_scale_cast_entry_bytes() { return (int)sizeof(Entry); }

// entries: `count` Entry records in host memory, their pointers taken
// from srcs[i] / dsts[i] (device addresses), all copied into the launch's
// parameters before this returns; total: the sum of their n, each
// entry's start its prefix offset.
extern "C" int hvtpu_scale_cast_table(const void* entries,
                                      const uint64_t* srcs,
                                      const uint64_t* dsts, int count,
                                      int64_t total, float scale,
                                      void* stream) {
  if (count < 1 || count > kMaxEntries || total < 0)
    return (int)cudaErrorInvalidValue;
  const Entry* es = static_cast<const Entry*>(entries);
  int64_t start = 0;  // the binary search needs the prefix offsets
  for (int i = 0; i < count; ++i) {
    if (es[i].src_dt > 2 || es[i].spec_dt > 2 || es[i].own_dt > 2 ||
        es[i].dst_dt > 2 || es[i].n < 0 || es[i].start != start)
      return (int)cudaErrorInvalidValue;
    start += es[i].n;
  }
  if (start != total) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t wave = (int64_t)sms * kBlocksPerSm;
  const int64_t cta = (int64_t)kThreads * kElems;
  int64_t blocks = (total + cta - 1) / cta;
  if (blocks > wave) blocks = (blocks + wave - 1) / wave * wave;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count == 1)
    return launch<1>(es, srcs, dsts, count, total, scale, blocks, s);
  return launch<kMaxEntries>(es, srcs, dsts, count, total, scale, blocks, s);
}
