// Ring collectives over the virtual ranks of one card, for Hopper (sm_90a).
// A4, A5 and A6 run here only past 8 ranks, where a thread block cluster
// no longer holds a CTA a rank (ring_cluster.cu takes 2 to 8; ops/ring.py
// kernel_route picks).
//
// Replaces horovod_tpu/ops/ring.py:_allgather_kernel (A4, called from
// ring_allgather_2d), :_allreduce_kernel (A5) and
// :_quantized_allreduce_kernel (A6, with _quantize_block and
// _dequantize_block), both called from _ring_allreduce_2d.  There every
// rank is a TPU core that pushes its slot to the right neighbour by remote
// DMA.  Here the n ranks are virtual: each rank's input, output, slots and
// flag words sit in this card's memory, reached through a per-rank pointer
// table, and one cooperative launch runs every rank.  The protocol is the
// reference's, step by step:
//   wait for the right neighbour's ACK that its slot is free (step >= 1),
//   write the payload into its slot, raise its receive flag,
//   wait for my own receive flag, consume my slot,
//   ACK the left neighbour (step < n-2: at n = 2 no ACK is ever sent).
// Each phase has its own slot pair (reduce-scatter 0/1, all-gather 2/3):
// a rank may start phase 2 while its neighbour still waits in phase 1.
// Flags are counters, zeroed by the wrapper on the launch stream before
// every call; on one card stream order rules out a stale flag from the
// previous call (ranks in separate processes will need epochs instead,
// and flags at system scope).  Peer memory across cards only changes
// where the table's pointers point.
//
// Residency: block b of every rank walks the same slices of its chunk in
// the same order (slices b, b+B, ..., each 8 quantization blocks of 1024
// elements), and every slice is a ring of its own with its own slots and
// flags, so no grid-wide barrier is needed and the result is bitwise the
// whole-chunk ring's.  A rank spins while it waits on a neighbour, so all
// n*B blocks must be resident: the launch is cooperative and B is cut to
// what the occupancy query allows; a grid that cannot be resident fails
// the launch.  Every spin is bounded (~4 s of clock64) and ends in
// __trap(), so a protocol fault fails the run instead of hanging it.
//
// Memory ordering: a block's stores into the neighbour's slot, then
// __syncthreads(), then thread 0 raises the flag with a release increment
// at device scope; the waiter's thread 0 spins on acquire loads, then
// __syncthreads(), and every thread reads the slot with __ldcg (L1 is not
// coherent across SMs and a slot is rewritten every other step).
//
// Arithmetic (the plain versions in ops/ring.py compute the same, bit for
// bit; float32 subnormals count as 0, as on the TPU and XLA's CPU):
//   A5: acc = flush(recv + flush(x_local)), __fadd_rn, so chunk c is
//       ((x_c + x_{c+1}) + ...) + x_{c+n-1}, ranks mod n.
//   A6: every hop carries int8 codes and one float32 scale per 1024
//       elements (quant_common.cuh, A2's formula; the per-hop
//       arithmetic is ring_common.cuh's); a reduce-scatter hop
//       requantizes and accumulates acc = flush(fma(float(q), s,
//       flush(x_local))) with __fmaf_rn, as XLA fuses the reference's
//       dequantize-and-add; the owner quantizes its reduced chunk once and
//       writes q0*s0, not its accumulator, and the all-gather relays the
//       received codes verbatim.
//   A4: a copy; each rank forwards the block it received last.
//
// Bound: memory.  Each rank's input is read once and its output written
// once; the ring adds, for every hop, the payload's store into the
// neighbour's slot and the load back out (float32 for A4/A5, 1 byte and
// 4 bytes per 1024 for A6) and A5/A6 read the local chunk again at every
// reduce-scatter hop.  No arithmetic comes near the card's rate.
//
// Design: 256 threads a block, 16-byte accesses.  A5/A4: a thread holds
// 8 float4 of the slice in registers across the hops.  A6: warp w owns
// quantization block w of the slice, a lane 8 float4 of it, so the absmax
// is one warp reduction.  The running sum stays in registers; only the
// payload crosses memory.
//
// C ABI (loaded with ctypes).  The table holds per rank, as int64:
// input, output, slots (4 of `chunk` float32, or int8 codes for A6),
// scale slots (A6: 4 of chunk/1024 float32), flags (per slice: receive
// counters of slots 0-3, then ACK counters of slots 0-3).

#include <cuda/atomic>
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kSlice = kWarps * kQBlock;      // 8192 elements
constexpr int kVec = kSlice / (4 * kThreads);     // float4 a thread: 8
constexpr int kLaneVec = kQBlock / (4 * 32);      // float4 a lane (A6): 8
constexpr long long kSpinCycles = 1LL << 33;      // ~4 s at 1.98 GHz

struct Rank {  // one row of the pointer table (ops/ring.py:_launch)
  const float* x;
  float* out;
  void* slots;
  float* scale_slots;
  unsigned* flags;
};

__device__ __forceinline__ void wait_at_least(unsigned* flag,
                                              unsigned target) {
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> f(*flag);
    const long long start = clock64();
    while (f.load(cuda::std::memory_order_acquire) < target) {
      if (clock64() - start > kSpinCycles) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void raise_flag(unsigned* flag) {
  __syncthreads();  // every thread's stores, or loads of a freed slot, first
  if (threadIdx.x == 0) {
    __threadfence();
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> f(*flag);
    f.fetch_add(1u, cuda::std::memory_order_release);
  }
}

// One slice's ring, seen from rank `me`.  Steps count from 0 in each
// phase; `slot` is an absolute slot index (phase 1: 0/1, phase 2: 2/3).
struct Ring {
  const Rank* table;
  int n;
  int me;
  int64_t slice;

  __device__ const Rank& self() const { return table[me]; }
  __device__ const Rank& right() const { return table[(me + 1) % n]; }
  __device__ const Rank& left() const { return table[(me + n - 1) % n]; }
  __device__ unsigned* recv_flag(const Rank& r, int slot) const {
    return r.flags + slice * 8 + slot;
  }
  __device__ unsigned* ack_flag(const Rank& r, int slot) const {
    return r.flags + slice * 8 + 4 + slot;
  }
  // before writing the right neighbour's `slot` at step i: its ACK that
  // the slot is free (the slot was its send slot at step i-1)
  __device__ void wait_free(int i, int slot) const {
    if (i >= 1) wait_at_least(ack_flag(self(), slot), (i + 1) / 2);
  }
  __device__ void sent(int slot) const {
    raise_flag(recv_flag(right(), slot));
  }
  __device__ void wait_received(int i, int slot) const {
    wait_at_least(recv_flag(self(), slot), i / 2 + 1);
  }
  // my send slot of step i is dead: the left neighbour writes it next
  __device__ void free_slot(int i, int slot) const {
    if (i < n - 2) raise_flag(ack_flag(left(), slot));
  }
};

__device__ __forceinline__ float4 slot4(const Rank& r, int slot,
                                        int64_t chunk, int64_t e) {
  const float* s = static_cast<const float*>(r.slots) + slot * chunk + e;
  return __ldcg(reinterpret_cast<const float4*>(s));
}

__device__ __forceinline__ void push4(const Rank& r, int slot, int64_t chunk,
                                      int64_t e, float4 v) {
  float* s = static_cast<float*>(r.slots) + slot * chunk + e;
  *reinterpret_cast<float4*>(s) = v;
}

// -- A4 ---------------------------------------------------------------------

// x: rank's (CH, 128) block of `chunk` elements; out: (n*CH, 128)
__global__ void __launch_bounds__(kThreads)
allgather_kernel(const Rank* __restrict__ table, int n, int64_t chunk,
                 int blocks_per_rank) {
  const int me = blockIdx.x / blocks_per_rank;
  const int64_t nslices = (chunk + kSlice - 1) / kSlice;
  for (int64_t slice = blockIdx.x % blocks_per_rank; slice < nslices;
       slice += blocks_per_rank) {
    const Ring ring{table, n, me, slice};
    const Rank& self = ring.self();
    const Rank& right = ring.right();
    const int64_t off = slice * kSlice;
    const int64_t len = chunk - off < kSlice ? chunk - off : kSlice;  // x128
    float4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t e = off + (int64_t)(k * kThreads + threadIdx.x) * 4;
      if (e - off < len) {
        v[k] = __ldg(reinterpret_cast<const float4*>(self.x + e));
        *reinterpret_cast<float4*>(self.out + me * chunk + e) = v[k];
      }
    }
    for (int i = 0; i < n - 1; ++i) {
      const int recv = (i + 1) & 1;
      ring.wait_free(i, recv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = off + (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e - off < len) push4(right, recv, chunk, e, v[k]);
      }
      ring.sent(recv);
      ring.wait_received(i, recv);
      const int src = (me - i - 1 + 2 * n) % n;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = off + (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e - off < len) {
          v[k] = slot4(self, recv, chunk, e);
          *reinterpret_cast<float4*>(self.out + src * chunk + e) = v[k];
        }
      }
      ring.free_slot(i, i & 1);
    }
  }
}

// -- A5 ---------------------------------------------------------------------

// x, out: `size` float32 per rank, seen as n chunks of `chunk` elements
// (zero past size)
__global__ void __launch_bounds__(kThreads)
allreduce_kernel(const Rank* __restrict__ table, int n, int64_t size,
                 int64_t chunk, int blocks_per_rank) {
  const int me = blockIdx.x / blocks_per_rank;
  const int64_t nslices = (chunk + kSlice - 1) / kSlice;
  for (int64_t slice = blockIdx.x % blocks_per_rank; slice < nslices;
       slice += blocks_per_rank) {
    const Ring ring{table, n, me, slice};
    const Rank& self = ring.self();
    const Rank& right = ring.right();
    const int64_t off = slice * kSlice;
    const int64_t len = chunk - off < kSlice ? chunk - off : kSlice;  // x1024
    float4 acc[kVec];
    // phase 1: reduce-scatter; my own chunk starts the walk
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t e = off + (int64_t)(k * kThreads + threadIdx.x) * 4;
      acc[k] = e - off < len ? flush4(load4(self.x, me * chunk + e, size))
                             : zero4();
    }
    for (int i = 0; i < n - 1; ++i) {
      const int recv = (i + 1) & 1;
      ring.wait_free(i, recv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = off + (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e - off < len) push4(right, recv, chunk, e, acc[k]);
      }
      ring.sent(recv);
      ring.wait_received(i, recv);
      const int c = (me - i - 1 + 2 * n) % n;  // the chunk received now
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = off + (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e - off < len) {
          const float4 r = slot4(self, recv, chunk, e);
          const float4 x = flush4(load4(self.x, c * chunk + e, size));
          acc[k] = make_float4(flush(__fadd_rn(r.x, x.x)),
                               flush(__fadd_rn(r.y, x.y)),
                               flush(__fadd_rn(r.z, x.z)),
                               flush(__fadd_rn(r.w, x.w)));
        }
      }
      ring.free_slot(i, i & 1);
    }
    // I hold the reduced chunk me+1
    const int owned = (me + 1) % n;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t e = off + (int64_t)(k * kThreads + threadIdx.x) * 4;
      if (e - off < len) store4(self.out, owned * chunk + e, size, acc[k]);
    }
    // phase 2: all-gather of the reduced chunks, slots 2/3
    for (int i = 0; i < n - 1; ++i) {
      const int recv = 2 + ((i + 1) & 1);
      ring.wait_free(i, recv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = off + (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e - off < len) push4(right, recv, chunk, e, acc[k]);
      }
      ring.sent(recv);
      ring.wait_received(i, recv);
      const int c = (me - i + 2 * n) % n;  // owned by rank me-i-1
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = off + (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e - off < len) {
          acc[k] = slot4(self, recv, chunk, e);
          store4(self.out, c * chunk + e, size, acc[k]);
        }
      }
      ring.free_slot(i, 2 + (i & 1));
    }
  }
}

// -- A6 ---------------------------------------------------------------------

// A lane's share of one quantization block: 8 float4, element
// lane*4 + k*128 of the block for k = 0..7 (a warp's k-th access is 512
// contiguous bytes, its codes 128 contiguous bytes); the arithmetic is
// ring_common.cuh's, shared with ring_cluster.cu's A6.
using Codes = hvtpu::Codes<kLaneVec>;
using hvtpu::accumulate4;
using hvtpu::store_dequantized;

// block `blk` (index within a chunk's quantization blocks) of `slot`
__device__ __forceinline__ void push_codes(const Rank& r, int slot,
                                           int64_t chunk, int64_t blk,
                                           const Codes& c) {
  int8_t* q = static_cast<int8_t*>(r.slots) + slot * chunk + blk * kQBlock;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kLaneVec; ++k)
    *reinterpret_cast<uint32_t*>(q + lane * 4 + k * 128) = c.word[k];
  if (lane == 0) r.scale_slots[slot * (chunk / kQBlock) + blk] = c.scale;
}

__device__ __forceinline__ Codes slot_codes(const Rank& r, int slot,
                                            int64_t chunk, int64_t blk) {
  const int8_t* q =
      static_cast<const int8_t*>(r.slots) + slot * chunk + blk * kQBlock;
  const int lane = threadIdx.x & 31;
  Codes c;
#pragma unroll
  for (int k = 0; k < kLaneVec; ++k)
    c.word[k] = __ldcg(reinterpret_cast<const unsigned int*>(
        q + lane * 4 + k * 128));
  c.scale = __ldcg(r.scale_slots + slot * (chunk / kQBlock) + blk);
  return c;
}

__global__ void __launch_bounds__(kThreads)
quantized_allreduce_kernel(const Rank* __restrict__ table, int n,
                           int64_t size, int64_t chunk,
                           int blocks_per_rank) {
  const int me = blockIdx.x / blocks_per_rank;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t nslices = (chunk + kSlice - 1) / kSlice;
  for (int64_t slice = blockIdx.x % blocks_per_rank; slice < nslices;
       slice += blocks_per_rank) {
    const Ring ring{table, n, me, slice};
    const Rank& self = ring.self();
    const Rank& right = ring.right();
    const int64_t blk = slice * kWarps + warp;  // my warp's block of a chunk
    const bool active = blk * kQBlock < chunk;
    const int64_t e0 = blk * kQBlock + lane * 4;  // my first element
    float4 acc[kLaneVec];
    if (active) {
#pragma unroll
      for (int k = 0; k < kLaneVec; ++k)
        acc[k] = flush4(load4(self.x, me * chunk + e0 + k * 128, size));
    }
    // phase 1: reduce-scatter, requantizing every hop
    for (int i = 0; i < n - 1; ++i) {
      const int recv = (i + 1) & 1;
      Codes c;
      if (active) c = hvtpu::quantize_warp(acc);
      ring.wait_free(i, recv);
      if (active) push_codes(right, recv, chunk, blk, c);
      ring.sent(recv);
      ring.wait_received(i, recv);
      if (active) {
        const int ch = (me - i - 1 + 2 * n) % n;
        const Codes in = slot_codes(self, recv, chunk, blk);
#pragma unroll
        for (int k = 0; k < kLaneVec; ++k) {
          acc[k] = accumulate4(
              in.word[k], in.scale,
              load4(self.x, ch * chunk + e0 + k * 128, size));
        }
      }
      ring.free_slot(i, i & 1);
    }
    // the owner quantizes its reduced chunk once and keeps q0*s0
    Codes c;
    if (active) {
      c = hvtpu::quantize_warp(acc);
      store_dequantized(self.out, ((me + 1) % n) * chunk + e0, size, c);
    }
    // phase 2: all-gather, relaying the codes verbatim, slots 2/3
    for (int i = 0; i < n - 1; ++i) {
      const int recv = 2 + ((i + 1) & 1);
      ring.wait_free(i, recv);
      if (active) push_codes(right, recv, chunk, blk, c);
      ring.sent(recv);
      ring.wait_received(i, recv);
      if (active) {
        c = slot_codes(self, recv, chunk, blk);
        store_dequantized(self.out, ((me - i + 2 * n) % n) * chunk + e0,
                          size, c);
      }
      ring.free_slot(i, 2 + (i & 1));
    }
  }
}

// Blocks a rank: as many as the card keeps resident for n ranks, at most
// one a slice; 0 when n ranks cannot all be resident.
int blocks_per_rank(const void* kernel, int n, int64_t nslices, int* out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  int64_t b = (int64_t)per_sm * sms / n;
  if (b > nslices) b = nslices;
  if (b < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *out = (int)b;
  return 0;
}

int launch(const void* kernel, void** args, int n, int blocks,
           cudaStream_t stream) {
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3((unsigned)(n * blocks)), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// A4: `size` and `chunk` are both CH*128, a multiple of 128.
extern "C" int hvtpu_ring_allgather(const void* table, int n, int64_t size,
                                    int64_t chunk, int64_t slice,
                                    int quantized, void* stream) {
  if (n < 2 || size != chunk || chunk <= 0 || chunk % 128 || slice != kSlice ||
      quantized)
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)allgather_kernel;
  int b = 0;
  const int err =
      blocks_per_rank(kernel, n, (chunk + kSlice - 1) / kSlice, &b);
  if (err) return err;
  const Rank* t = static_cast<const Rank*>(table);
  void* args[] = {&t, &n, &chunk, &b};
  return launch(kernel, args, n, b, static_cast<cudaStream_t>(stream));
}

// A5 (quantized = 0) and A6 (quantized = 1): `size` float32 a rank,
// `chunk` a multiple of 1024 with n*chunk >= size.
extern "C" int hvtpu_ring_allreduce(const void* table, int n, int64_t size,
                                    int64_t chunk, int64_t slice,
                                    int quantized, void* stream) {
  if (n < 2 || size <= 0 || chunk <= 0 || chunk % kQBlock ||
      (int64_t)n * chunk < size || slice != kSlice)
    return (int)cudaErrorInvalidValue;
  const void* kernel = quantized ? (const void*)quantized_allreduce_kernel
                                 : (const void*)allreduce_kernel;
  int b = 0;
  const int err =
      blocks_per_rank(kernel, n, (chunk + kSlice - 1) / kSlice, &b);
  if (err) return err;
  const Rank* t = static_cast<const Rank*>(table);
  void* args[] = {&t, &n, &size, &chunk, &b};
  return launch(kernel, args, n, b, static_cast<cudaStream_t>(stream));
}
