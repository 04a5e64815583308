// Ring collectives A4, A5 and A6 over 2 to 8 virtual ranks of one card,
// as thread block clusters, for Hopper (sm_90a).
//
// Replaces horovod_tpu/ops/ring.py:_allgather_kernel (A4, called from
// ring_allgather_2d), :_allreduce_kernel (A5, called from
// _ring_allreduce_2d with quantized=False) and
// :_quantized_allreduce_kernel (A6, with _quantize_block and
// _dequantize_block, called from _ring_allreduce_2d with quantized=True)
// for 2 <= n <= 8 ranks.  There
// every rank is a TPU core that pushes its slot to the right neighbour by
// remote DMA and meets it on DMA semaphores.  Here the n ranks are the n
// CTAs of one thread block cluster: CTA rank r of the cluster is rank r,
// its two slots sit in its own shared memory, and a hop's payload is
// stored straight into the right neighbour's slot through distributed
// shared memory (st.shared::cluster on the address mapa gives).  The
// reference's receive and ACK semaphores become one hardware cluster
// barrier a hop (barrier.cluster.arrive.release / wait.acquire): a port of
// what the kernel computes, not of its protocol.  csrc/ring.cu keeps the
// global-slot kernels for n > 8.
//
// Bound: bytes.  HBM sees only what the bound counts: each rank's input
// read once and its output written once.  A5 reads its rank's chunk c in
// the reduce-scatter hop where chunk c passes the rank (the owner's own
// chunk before the first hop) and writes each of the n chunks of its
// output once; A4 reads its rank's block once and writes n blocks; A6
// reads and writes as A5 does.  The ring's own traffic, (2n-2) hops of a
// chunk a rank for A5 and A6 (A6: 1 byte an element and 4 bytes a 1024)
// and n-1 for A4, crosses the SM-to-SM network and never touches HBM.
// No flags, no spins, no cooperative launch, no scratch in device
// memory.
//
// Design:
// * A cluster is persistent and walks slices c, c + C, ... of the chunk
//   (C clusters, as many as cudaOccupancyMaxActiveClusters allows, at
//   most one a slice); all n CTAs walk the same slices in the same order
//   and reach every barrier, the ragged last slice included.  Clusters
//   never wait on each other.  Each slice is a ring of its own, so the
//   result is the whole-chunk ring's bit for bit.
// * A slice is kThreads * 16 elements (4 float4 a thread, 16-byte
//   accesses): 2048 at 128 threads, 16 KB of slots a CTA.  The smallest
//   slice measured fastest on an H100 (2048 to 16384; the sweep in
//   torch_port_ring_sweep.py recompiles a copy of this file at other
//   thread counts): it lets the most clusters be resident, and so the
//   most CTAs overlap each other's barriers and loads.  The running sum
//   stays in registers across the hops.
// * Two slots a CTA are enough across both phases and across slices.
//   Hops are numbered h = 0, 1, ... over the CTA's whole walk and hop h
//   writes slot h & 1 of the right neighbour.  The barrier of hop h+1
//   lies between every CTA's read of slot h & 1 at hop h and the next
//   write into it, at hop h+2.
// * Overlap: A5 and A6 issue the HBM load of the hop's local chunk after
//   their arrive and before their wait, so the load is in flight across
//   the barrier.
// * A6 (its own CTA shape, kQThreads): a 1024-element quantization block
//   lies inside one CTA, kQBlockWarps warps a block, a lane 32 or 16
//   elements of it (float4 k at element first + k*128), so the absmax is
//   one warp reduction (and, at 2 warps a block, one exchange through
//   shared memory).  A reduce-scatter hop quantizes the running sum,
//   stores its codes and scale into the right neighbour's slot, arrives,
//   loads the local chunk, waits, reads its own slot and accumulates.
//   The sender and the receiver of a lane's codes are the same warp and
//   lane of their CTAs, so the slot's layout inside a block is the
//   pair's own: a lane's codes go as 16-byte pieces at piece*512 +
//   lane*16, each warp instruction 512 contiguous bytes, no bank
//   conflict; lane 0 of a block's first warp stores its scale.  A slot
//   is a slice's codes, and the scales of both slots follow both slots'
//   codes.  Warps whose block lies past the chunk load and store nothing
//   and pass every barrier.  One warp a block at 128 threads (a slice of
//   4096, 5 CTAs an SM at 96 registers) measured fastest on an H100
//   against 2 warps a block, 64-512 threads, a register cap and
//   evict-first loads (torch_port_ring_sweep.py).
// * Every CTA passes a cluster barrier before its first store into a
//   neighbour (the neighbour must be running) and before it exits (no
//   CTA's shared memory is written after it has exited).
//
// Arithmetic (ops/ring.py's plain versions compute the same, bit for bit;
// float32 subnormals count as 0, as on the TPU and XLA's CPU):
//   A5: acc = flush(recv + flush(x_local)), __fadd_rn, so chunk c is
//       ((x_c + x_{c+1}) + ...) + x_{c+n-1}, ranks mod n; the owner
//       stores its reduced chunk and the all-gather relays it verbatim.
//   A6: a reduce-scatter hop requantizes the running sum with A2's
//       formula and accumulates acc = flush(fma(float(q), s,
//       flush(x_local))), __fmaf_rn; the owner quantizes its reduced
//       chunk once and writes q0*s0; the all-gather relays the codes and
//       scales verbatim (ring_common.cuh holds the arithmetic, shared
//       with ring.cu's global-slot A6).
//   A4: a copy; each rank forwards the block it received last.
// Padding: A5 and A6 read zeros past `size` and write nothing there; A4's
// chunk is a multiple of 128 elements, and the ragged slice is masked.
//
// C ABI (loaded with ctypes).  Pointers travel by value in the kernel's
// parameters (__grid_constant__, read in place with the rank as index):
// `xs` and `outs` are host arrays of n device addresses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_common.cuh"
#include "ring_common.cuh"

namespace {

using hvtpu::flush;
using hvtpu::flush4;
using hvtpu::kQBlock;
using hvtpu::load4;
using hvtpu::store4;
using hvtpu::zero4;

constexpr int kMaxRanks = 8;   // the portable cluster size
constexpr int kVec = 4;        // float4 a thread a slice
constexpr int kThreads = 128;  // a CTA of A4 and A5
constexpr int64_t kSlice = (int64_t)kThreads * kVec * 4;  // elements

// A6: a CTA, warps a quantization block, and what follows from them
constexpr int kQThreads = 128;
constexpr int kQBlockWarps = 1;
constexpr int kQLaneVec = kQBlock / (4 * 32 * kQBlockWarps);  // float4
constexpr int kQBlocks = kQThreads / (32 * kQBlockWarps);     // a slice
constexpr int64_t kQSlice = (int64_t)kQBlocks * kQBlock;      // elements
// two slots of a slice's codes, then the two slots' scales
constexpr size_t kQSmem = 2 * (size_t)kQSlice + 2 * 4 * kQBlocks;
static_assert(kQThreads % (32 * kQBlockWarps) == 0 && kQLaneVec % 4 == 0,
              "A6: whole blocks a CTA, whole 16-byte pieces a lane");

struct Ptrs {
  const float* x[kMaxRanks];
  float* out[kMaxRanks];
};

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// my stores into the cluster's shared memory become visible to every
// CTA that has passed the matching wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void push4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void push_words(uint32_t addr, uint32_t a,
                                           uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ void push_scale(uint32_t addr, float s) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(s)
               : "memory");
}

// One CTA's view of its ring: its slots, the right neighbour's, and the
// float4 of a slice that thread `threadIdx.x` owns.
struct Slots {
  float4* mine;       // 2 slots of kSlice floats
  uint32_t right;     // the right neighbour's slot 0, shared::cluster

  __device__ static int64_t elem(int k) {  // element of float4 k in a slice
    return (int64_t)(k * kThreads + threadIdx.x) * 4;
  }
  __device__ void push(int h, int k, float4 v) const {
    push4(right + (uint32_t)(((h & 1) * (kSlice / 4) + k * kThreads +
                              threadIdx.x) * 16),
          v);
  }
  __device__ float4 read(int h, int k) const {
    return mine[(h & 1) * (kSlice / 4) + k * kThreads + threadIdx.x];
  }
};

__device__ __forceinline__ Slots cluster_slots(int n, int me) {
  extern __shared__ float4 slot_mem[];
  Slots s;
  s.mine = slot_mem;
  s.right = map_rank(shared_addr(slot_mem), (unsigned)((me + 1) % n));
  return s;
}

// -- A4 ---------------------------------------------------------------------

// x: rank's (CH, 128) block of `chunk` elements; out: (n*CH, 128)
__global__ void __launch_bounds__(kThreads)
allgather_cluster_kernel(const __grid_constant__ Ptrs p, int n,
                         int64_t chunk) {
  const int me = (int)cluster_ctarank();
  const Slots slots = cluster_slots(n, me);
  const float* __restrict__ x = p.x[me];
  float* __restrict__ out = p.out[me];
  const int64_t nslices = (chunk + kSlice - 1) / kSlice;
  int h = 0;
  cluster_sync();  // every CTA of the cluster runs before any push
  for (int64_t slice = cluster_id(); slice < nslices;
       slice += cluster_count()) {
    const int64_t off = slice * kSlice;
    const int64_t len = chunk - off < kSlice ? chunk - off : kSlice;
    float4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t e = off + Slots::elem(k);
      if (e - off < len) {
        v[k] = __ldg(reinterpret_cast<const float4*>(x + e));
        *reinterpret_cast<float4*>(out + me * chunk + e) = v[k];
      }
    }
    for (int i = 0; i < n - 1; ++i, ++h) {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (Slots::elem(k) < len) slots.push(h, k, v[k]);
      cluster_sync();
      const int src = (me - i - 1 + n) % n;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = off + Slots::elem(k);
        if (e - off < len) {
          v[k] = slots.read(h, k);
          *reinterpret_cast<float4*>(out + src * chunk + e) = v[k];
        }
      }
    }
  }
  cluster_sync();  // no neighbour stores into a CTA that has exited
}

// -- A5 ---------------------------------------------------------------------

// x, out: `size` float32 per rank, seen as n chunks of `chunk` elements
// (zero past size)
__global__ void __launch_bounds__(kThreads)
allreduce_cluster_kernel(const __grid_constant__ Ptrs p, int n, int64_t size,
                         int64_t chunk) {
  const int me = (int)cluster_ctarank();
  const Slots slots = cluster_slots(n, me);
  const float* __restrict__ x = p.x[me];
  float* __restrict__ out = p.out[me];
  const int64_t nslices = (chunk + kSlice - 1) / kSlice;
  int h = 0;
  cluster_sync();  // every CTA of the cluster runs before any push
  for (int64_t slice = cluster_id(); slice < nslices;
       slice += cluster_count()) {
    const int64_t off = slice * kSlice;
    const int64_t len = chunk - off < kSlice ? chunk - off : kSlice;
    float4 acc[kVec];
    float4 loc[kVec];
    // phase 1: reduce-scatter; my own chunk starts the walk
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t e = off + Slots::elem(k);
      acc[k] = e - off < len ? flush4(load4(x, me * chunk + e, size))
                             : zero4();
    }
    for (int i = 0; i < n - 1; ++i, ++h) {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (Slots::elem(k) < len) slots.push(h, k, acc[k]);
      cluster_arrive();
      const int c = (me - i - 1 + n) % n;  // the chunk received now
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = off + Slots::elem(k);
        loc[k] = e - off < len ? load4(x, c * chunk + e, size) : zero4();
      }
      cluster_wait();
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (Slots::elem(k) < len) {
          const float4 r = slots.read(h, k);
          const float4 l = flush4(loc[k]);
          acc[k] = make_float4(flush(__fadd_rn(r.x, l.x)),
                               flush(__fadd_rn(r.y, l.y)),
                               flush(__fadd_rn(r.z, l.z)),
                               flush(__fadd_rn(r.w, l.w)));
        }
      }
    }
    // I hold the reduced chunk me+1
    const int owned = (me + 1) % n;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t e = off + Slots::elem(k);
      if (e - off < len) store4(out, owned * chunk + e, size, acc[k]);
    }
    // phase 2: all-gather of the reduced chunks
    for (int i = 0; i < n - 1; ++i, ++h) {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (Slots::elem(k) < len) slots.push(h, k, acc[k]);
      cluster_sync();
      const int c = (me - i + n) % n;  // owned by rank me-i-1
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = off + Slots::elem(k);
        if (e - off < len) {
          acc[k] = slots.read(h, k);
          store4(out, c * chunk + e, size, acc[k]);
        }
      }
    }
  }
  cluster_sync();  // no neighbour stores into a CTA that has exited
}

// -- A6 ---------------------------------------------------------------------

using Codes = hvtpu::Codes<kQLaneVec>;

// One CTA's view of its A6 ring: its slots, the right neighbour's, and
// where thread `threadIdx.x`'s share of its block sits in a slot.
struct QSlots {
  const uint8_t* mine;  // kQSmem bytes
  uint32_t right;       // the right neighbour's byte 0, shared::cluster
  uint32_t codes;       // my first 16-byte piece in a slot
  uint32_t scale;       // my block's scale in slot 0
  bool scale_owner;     // lane 0 of the block's first warp

  __device__ void push(int h, const Codes& c) const {
    const uint32_t base = right + (uint32_t)((h & 1) * kQSlice) + codes;
#pragma unroll
    for (int p = 0; p < kQLaneVec / 4; ++p)
      push_words(base + p * 512, c.word[4 * p], c.word[4 * p + 1],
                 c.word[4 * p + 2], c.word[4 * p + 3]);
    if (scale_owner) push_scale(right + scale + (h & 1) * 4 * kQBlocks,
                                c.scale);
  }
  __device__ Codes read(int h) const {
    const uint8_t* base = mine + (h & 1) * kQSlice + codes;
    Codes c;
#pragma unroll
    for (int p = 0; p < kQLaneVec / 4; ++p) {
      const uint4 w = *reinterpret_cast<const uint4*>(base + p * 512);
      c.word[4 * p] = w.x;
      c.word[4 * p + 1] = w.y;
      c.word[4 * p + 2] = w.z;
      c.word[4 * p + 3] = w.w;
    }
    c.scale = *reinterpret_cast<const float*>(mine + scale +
                                              (h & 1) * 4 * kQBlocks);
    return c;
  }
};

// the codes of my share of a block: the block's absmax is one warp
// reduction, then at 2 warps a block one exchange through `red`.  Every
// thread of the CTA calls it (it may hold a __syncthreads).
__device__ __forceinline__ Codes quantize_block(const float4 (&v)[kQLaneVec],
                                                float* red) {
  float m = hvtpu::warp_max_nan(hvtpu::lane_absmax(v));
  if constexpr (kQBlockWarps == 2) {
    // red[w] is rewritten one hop later, after a cluster barrier that
    // every thread passes after this read
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = m;
    __syncthreads();
    m = hvtpu::max_nan(red[warp & ~1], red[warp | 1]);
  }
  return hvtpu::encode(v, m);
}

// my share of the block that starts at element `block` of x: one branch
// a share, so every load of a whole share is in flight at once
__device__ __forceinline__ void load_share(float4 (&v)[kQLaneVec],
                                           const float* __restrict__ x,
                                           int64_t block, int first,
                                           int64_t size) {
  if (block + kQBlock <= size) {
#pragma unroll
    for (int k = 0; k < kQLaneVec; ++k)
      v[k] = __ldg(reinterpret_cast<const float4*>(x + block + first +
                                                   k * 128));
  } else {
#pragma unroll
    for (int k = 0; k < kQLaneVec; ++k)
      v[k] = load4(x, block + first + k * 128, size);
  }
}

// x, out: `size` float32 per rank, seen as n chunks of `chunk` elements
// (zero past size)
__global__ void __launch_bounds__(kQThreads)
quantized_allreduce_cluster_kernel(const __grid_constant__ Ptrs p, int n,
                                   int64_t size, int64_t chunk) {
  extern __shared__ float4 slot_mem[];
  __shared__ float red[kQThreads / 32];
  const int me = (int)cluster_ctarank();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = warp / kQBlockWarps;     // my block of a slice
  const int part = warp % kQBlockWarps;  // my warp's part of it
  // my elements of the block: first + k*128, k < kQLaneVec
  const int first = part * kQLaneVec * 128 + lane * 4;
  QSlots slots;
  slots.mine = reinterpret_cast<const uint8_t*>(slot_mem);
  const uint32_t base = shared_addr(slot_mem);
  slots.right = map_rank(base, (unsigned)((me + 1) % n));
  slots.codes = (uint32_t)(b * kQBlock + part * (kQLaneVec / 4) * 512 +
                           lane * 16);
  slots.scale = (uint32_t)(2 * kQSlice + b * 4);
  slots.scale_owner = part == 0 && lane == 0;
  const float* __restrict__ x = p.x[me];
  float* __restrict__ out = p.out[me];
  const int64_t nslices = (chunk + kQSlice - 1) / kQSlice;
  int h = 0;
  cluster_sync();  // every CTA of the cluster runs before any push
  for (int64_t slice = cluster_id(); slice < nslices;
       slice += cluster_count()) {
    const int64_t blk = slice * kQSlice + b * kQBlock;  // in a chunk
    const bool active = blk < chunk;  // chunk is whole blocks
    float4 acc[kQLaneVec];
    float4 loc[kQLaneVec];
    // phase 1: reduce-scatter, requantizing every hop; my own chunk
    // starts the walk
    if (active) {
      load_share(acc, x, me * chunk + blk, first, size);
#pragma unroll
      for (int k = 0; k < kQLaneVec; ++k) acc[k] = flush4(acc[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kQLaneVec; ++k) acc[k] = zero4();
    }
    for (int i = 0; i < n - 1; ++i, ++h) {
      const Codes c = quantize_block(acc, red);
      if (active) slots.push(h, c);
      cluster_arrive();
      const int ch = (me - i - 1 + n) % n;  // the chunk received now
      if (active) load_share(loc, x, ch * chunk + blk, first, size);
      cluster_wait();
      if (active) {
        const Codes in = slots.read(h);
#pragma unroll
        for (int k = 0; k < kQLaneVec; ++k)
          acc[k] = hvtpu::accumulate4(in.word[k], in.scale, loc[k]);
      }
    }
    // I hold the reduced chunk me+1: quantized once, kept as q0*s0
    Codes c = quantize_block(acc, red);
    if (active)
      hvtpu::store_dequantized(out, ((me + 1) % n) * chunk + blk + first,
                               size, c);
    // phase 2: all-gather, relaying the codes verbatim
    for (int i = 0; i < n - 1; ++i, ++h) {
      if (active) slots.push(h, c);
      cluster_sync();
      if (active) {
        c = slots.read(h);
        const int ch = (me - i + n) % n;  // owned by rank me-i-1
        hvtpu::store_dequantized(out, ch * chunk + blk + first, size, c);
      }
    }
  }
  cluster_sync();  // no neighbour stores into a CTA that has exited
}

// -- launch -----------------------------------------------------------------

enum Kind { kAllgather = 0, kAllreduce = 1, kQuantized = 2, kKinds = 3 };

const void* kernel(Kind kind) {
  switch (kind) {
    case kAllgather:
      return (const void*)allgather_cluster_kernel;
    case kAllreduce:
      return (const void*)allreduce_cluster_kernel;
    default:
      return (const void*)quantized_allreduce_cluster_kernel;
  }
}

int threads(Kind kind) { return kind == kQuantized ? kQThreads : kThreads; }

int64_t slice_elems(Kind kind) {
  return kind == kQuantized ? kQSlice : kSlice;
}

// the launch configuration of a kernel for n ranks; grid not yet set
cudaError_t configure(Kind kind, int n, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem =
      kind == kQuantized ? kQSmem : 2 * (size_t)kSlice * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel(kind), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)n);
  cfg->blockDim = dim3((unsigned)threads(kind));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Clusters of n that the card keeps resident at once, cached per
// (kernel, n, device): the query costs more than the launch.
int active_clusters(Kind kind, int n, const cudaLaunchConfig_t& cfg,
                    int* out) {
  static int cache[kKinds][kMaxRanks + 1][8];  // 0: not yet asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int* slot = dev < 8 ? &cache[kind][n][dev] : nullptr;
  if (slot && *slot > 0) {
    *out = *slot;
    return 0;
  }
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel(kind), &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  if (slot) *slot = clusters;
  *out = clusters;
  return 0;
}

int launch(Kind kind, const int64_t* xs, const int64_t* outs, int n,
           int64_t size, int64_t chunk, void* stream) {
  if (n < 2 || n > kMaxRanks || chunk <= 0) return (int)cudaErrorInvalidValue;
  Ptrs p{};
  for (int r = 0; r < n; ++r) {
    if (xs[r] % 16 || outs[r] % 16) return (int)cudaErrorInvalidValue;
    p.x[r] = reinterpret_cast<const float*>(xs[r]);
    p.out[r] = reinterpret_cast<float*>(outs[r]);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kind, n, static_cast<cudaStream_t>(stream),
                              &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  const int qerr = active_clusters(kind, n, cfg, &clusters);
  if (qerr) return qerr;
  const int64_t nslices = (chunk + slice_elems(kind) - 1) / slice_elems(kind);
  if (clusters > nslices) clusters = (int)nslices;
  cfg.gridDim = dim3((unsigned)(clusters * n));
  if (kind == kAllgather) {
    void* args[] = {&p, &n, &chunk};
    err = cudaLaunchKernelExC(&cfg, kernel(kind), args);
  } else {
    void* args[] = {&p, &n, &size, &chunk};
    err = cudaLaunchKernelExC(&cfg, kernel(kind), args);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// A4: `chunk` = CH*128 elements a rank, a multiple of 128.
extern "C" int hvtpu_ring_cluster_allgather(const int64_t* xs,
                                            const int64_t* outs, int n,
                                            int64_t chunk, void* stream) {
  if (chunk % 128) return (int)cudaErrorInvalidValue;
  return launch(kAllgather, xs, outs, n, chunk, chunk, stream);
}

// A5: `size` float32 a rank, `chunk` a multiple of 1024 with
// n*chunk >= size.
extern "C" int hvtpu_ring_cluster_allreduce(const int64_t* xs,
                                            const int64_t* outs, int n,
                                            int64_t size, int64_t chunk,
                                            void* stream) {
  if (size <= 0 || chunk % kQBlock || (int64_t)n * chunk < size)
    return (int)cudaErrorInvalidValue;
  return launch(kAllreduce, xs, outs, n, size, chunk, stream);
}

// A6: as A5, int8 codes and a float32 scale a 1024 on every hop.
extern "C" int hvtpu_ring_cluster_quantized_allreduce(const int64_t* xs,
                                                      const int64_t* outs,
                                                      int n, int64_t size,
                                                      int64_t chunk,
                                                      void* stream) {
  if (size <= 0 || chunk % kQBlock || (int64_t)n * chunk < size)
    return (int)cudaErrorInvalidValue;
  return launch(kQuantized, xs, outs, n, size, chunk, stream);
}

// What the card gives kernel `kind` (0 A4, 1 A5, 2 A6), for the record:
// info[0] registers a thread, [1] local (spill) bytes a thread, [2]
// shared memory a CTA (dynamic and static), [3] CTAs resident an SM, [4]
// clusters of n resident at once, [5] elements a slice.
extern "C" int hvtpu_ring_cluster_info(int kind, int n, int* info) {
  if (n < 2 || n > kMaxRanks || kind < 0 || kind >= kKinds)
    return (int)cudaErrorInvalidValue;
  const Kind k = static_cast<Kind>(kind);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel(k));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure(k, n, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel(k), threads(k), cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  const int qerr = active_clusters(k, n, cfg, &clusters);
  if (qerr) return qerr;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = (int)(cfg.dynamicSmemBytes + fa.sharedSizeBytes);
  info[3] = per_sm;
  info[4] = clusters;
  info[5] = (int)slice_elems(k);
  return 0;
}
