// Ring collectives through slots in device memory, for Hopper (sm_90a):
// A4, A5 and A6 over two transports.
//
// Replaces horovod_tpu/ops/ring.py:_allgather_kernel (A4, called from
// ring_allgather_2d), :_allreduce_kernel (A5) and
// :_quantized_allreduce_kernel (A6, with _quantize_block and
// _dequantize_block), both called from _ring_allreduce_2d.  There every
// rank is a TPU core that pushes its slot to the right neighbour by remote
// DMA.  Here a rank is B blocks, and each rank's slots and flag words sit
// in device memory, reached through one row of pointers (Rank) a rank:
//
// * Ranks in one launch (hvtpu_ring_allgather, hvtpu_ring_allreduce): the
//   virtual ranks of one card past 8 (ring_cluster.cu takes 2 to 8;
//   ops/ring.py kernel_route picks).  A table of n rows in device memory
//   and one cooperative launch of n*B blocks; block k is rank k / B.  The
//   wrapper allocates the slots and zeroes the flags for every call.
// * A rank per process (hvtpu_ring_allgather_rank,
//   hvtpu_ring_allreduce_rank; ops/ring.py ProcessRing): each process
//   holds one rank's card tensors and launches its own B blocks.  Its
//   slots and flags are one cudaMalloc of its own (hvtpu_ring_ipc_alloc),
//   zeroed once and exported by a CUDA IPC handle; it maps its
//   neighbours' (hvtpu_ring_ipc_open) and passes three rows, left, self
//   and right, by value.  A peer may be another process on this card or a
//   card across NVLink: only where the pointers point differs.  B is
//   agreed once per communicator (the least hvtpu_ring_ipc_blocks over
//   the ranks), since block b of a rank talks only to block b of its
//   neighbours.
//
// The protocol is the reference's, step by step:
//   wait for the right neighbour's ACK that its slot is free (step >= 1),
//   write the payload into its slot, raise its receive flag,
//   wait for my own receive flag, consume my slot,
//   ACK the left neighbour (step < n-2: at n = 2 no ACK is ever sent).
// Each phase has its own slot pair (reduce-scatter 0/1, all-gather 2/3):
// a rank may start phase 2 while its neighbour still waits in phase 1.
//
// Slices: block b of every rank walks the same slices of its chunk in the
// same order (slices b, b+B, ..., each 8 quantization blocks of 1024
// elements), and every slice is a ring of its own with its own slots and
// flags, so no grid-wide barrier is needed and the result is bitwise the
// whole-chunk ring's.  A slice's slots and flags sit at fixed addresses
// whatever the call's size or kind (slot k of slice s at (4s + k) * 8192
// float32, A6's codes in the first quarter of it), so one block owns them
// in every call.
//
// Epochs: the flags are 64-bit words, each with one writer.  A raise
// stores tag(e, c) = e << 16 | c, e the call's epoch and c the number of
// raises of that word in the call; a wait is for tag(e, c) or more.  The
// epoch grows by one a call (ProcessRing counts it; in one launch it is 1,
// on fresh flags), so a value left by an earlier call is below every
// target of this one and nothing is zeroed between calls.  c < 2^15 (n is
// below 2^16), and e reaches 2^48, where the tag would wrap, after 8
// years at a call a microsecond.
//
// Between calls there is no host barrier: a left neighbour that begins
// call e+1 must not overwrite a slot that I still read in call e.  For A5
// and A6 the all-gather's relay order gives that.  The left neighbour
// leaves call e only after its all-gather step 1 found my ACK of step 0
// (n >= 3), or after my all-gather payload reached it (n = 2, where it is
// my right neighbour too); both follow my last reduce-scatter read.  Its
// all-gather of call e+1 follows its reduce-scatter of call e+1, which
// needs my ACK (n >= 3) or payload (n = 2) of call e+1.  For A4 it fails
// at even n: my last step reads slot 1, and nothing the left neighbour
// waits for follows that read.  A call of another kind or size also
// meets a slice's slots in another order.  So every block enters a call
// through a handshake: block b waits for done[b] >= e-1, a word in my
// memory that my right neighbour's block b sets to e-1 when it leaves
// call e-1, after its last read; it sets done[b] of the left neighbour to
// e when it leaves.  Every block runs it, slices or none, so the words
// count calls.  The other direction needs nothing: I waited for every
// write the left neighbour made into my slots in call e before I left it.
// On fresh flags (epoch 1) there is nothing to wait for.
//
// Memory ordering: a block's stores into the neighbour's slot, then
// __syncthreads(), then thread 0's fence and a release store of the flag;
// the waiter's thread 0 spins on acquire loads, then __syncthreads(), and
// every thread reads the slot with __ldcg (L1 is not coherent across SMs
// and a slot is rewritten every other step).  With a rank a process the
// fence is __threadfence_system() and the flag's store and loads are at
// thread_scope_system, so that a peer process, or a card across NVLink,
// sees a slot before its flag.  In one launch every rank is on this card
// and device scope is enough.
//
// Residency: a rank spins while it waits on a neighbour, so all of a
// launch's blocks must be resident: the launch is cooperative and B is
// cut to what the occupancy query allows; a grid that cannot be resident
// fails the launch.  Ranks in processes that share a card without MPS are
// time-sliced: the card runs one process's blocks at a time and compute
// preemption switches contexts while they spin, so a wait on a peer can
// take a whole time slice.  Every spin is bounded in wall time
// (%globaltimer, nanoseconds) and ends in __trap(), so a dead peer fails
// the run instead of hanging it.  The bound is 120 s: far above a
// time-sliced wait (a slice is milliseconds) and above the host skew
// between ranks that launch the same call, and twice the stall watchdog's
// default warning (60 s), which names a slow rank first.  clock64() would
// not do: it counts one SM's cycles, and a preempted CTA may resume on
// another SM.
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
// reduce-scatter hop.  Across cards the hop's store crosses NVLink.  No
// arithmetic comes near the card's rate.
//
// Design: 256 threads a block, 16-byte accesses, at least 3 blocks an SM
// (kCtasPerSm; A5 spills a few registers for it).  A5/A4: a thread holds
// 8 float4 of the slice in registers across the hops.  A6: warp w owns
// quantization block w of the slice, a lane 8 float4 of it, so the absmax
// is one warp reduction.  The running sum stays in registers; only the
// payload crosses memory.
//
// C ABI (loaded with ctypes).  A row holds, as int64: input, output,
// slots (4 a slice of 8192 float32, slice-major), scale slots (A6: 4 a
// slice of 8 float32), flags (8 a slice: receive flags of slots 0-3, then
// ACK flags), done (one a block).  Every entry point returns a cudaError_t;
// hvtpu_ring_error_name names one.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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
// __launch_bounds__'s floor of CTAs an SM: 80 registers a thread, so a
// rank of the one-launch route gets 3 * 132 / n blocks and a rank of its
// own 396 (torch_port_ring_sweep.py --kernels global times 1, 2 and 3)
constexpr int kCtasPerSm = 3;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kSlice = kWarps * kQBlock;      // 8192 elements
constexpr int kVec = kSlice / (4 * kThreads);     // float4 a thread: 8
constexpr int kLaneVec = kQBlock / (4 * 32);      // float4 a lane (A6): 8
constexpr int kCountBits = 16;                    // tag(e, c) = e << 16 | c
constexpr int kMaxRanks = 1 << kCountBits;
constexpr uint64_t kSpinNanos = 120ull * 1000 * 1000 * 1000;  // 120 s

struct Rank {  // one row (ops/ring.py: _launch, ProcessRing._rows)
  const float* x;
  float* out;
  void* slots;
  float* scale_slots;
  uint64_t* flags;
  uint64_t* done;
};

// what a launch passes by value
struct Launch {
  const Rank* table;         // ranks in one launch: n rows; else null
  Rank left, self, right;    // a rank per process: this rank's rows
  int n;
  int rank;                  // a rank per process: this rank
  int blocks;                // B, blocks a rank
  int64_t size;
  int64_t chunk;
  uint64_t epoch;
};

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <cuda::thread_scope S>
__device__ __forceinline__ void spin(uint64_t* flag, uint64_t target) {
  cuda::atomic_ref<uint64_t, S> f(*flag);
  if (f.load(cuda::std::memory_order_acquire) < target) {
    const uint64_t start = globaltimer();
    while (f.load(cuda::std::memory_order_acquire) < target) {
      if (globaltimer() - start > kSpinNanos) __trap();
    }
  }
}

// `system`: the flag's writer may be another process or card
__device__ __forceinline__ void wait_at_least(uint64_t* flag,
                                              uint64_t target, bool system) {
  if (threadIdx.x == 0) {
    if (system)
      spin<cuda::thread_scope_system>(flag, target);
    else
      spin<cuda::thread_scope_device>(flag, target);
  }
  __syncthreads();
}

__device__ __forceinline__ void raise_flag(uint64_t* flag, uint64_t value,
                                           bool system) {
  __syncthreads();  // every thread's stores, or loads of a freed slot, first
  if (threadIdx.x == 0) {
    if (system) {
      __threadfence_system();
      cuda::atomic_ref<uint64_t, cuda::thread_scope_system>(*flag).store(
          value, cuda::std::memory_order_release);
    } else {
      __threadfence();
      cuda::atomic_ref<uint64_t, cuda::thread_scope_device>(*flag).store(
          value, cuda::std::memory_order_release);
    }
  }
}

// This block's rank, its index among the rank's B blocks and its rows.
struct Block {
  int me;
  int index;
  bool system;  // a rank a process: flags at system scope
  const Rank* self;
  const Rank* left;
  const Rank* right;

  __device__ explicit Block(const Launch& L) : system(!L.table) {
    if (L.table) {
      me = blockIdx.x / L.blocks;
      index = blockIdx.x % L.blocks;
      self = L.table + me;
      left = L.table + (me + L.n - 1) % L.n;
      right = L.table + (me + 1) % L.n;
    } else {
      me = L.rank;
      index = blockIdx.x;
      self = &L.self;
      left = &L.left;
      right = &L.right;
    }
  }
  // the handshake of the header: the right neighbour's block has left
  // the previous call
  __device__ void enter(uint64_t epoch) const {
    if (epoch > 1) wait_at_least(self->done + index, epoch - 1, system);
  }
  __device__ void leave(uint64_t epoch) const {
    raise_flag(left->done + index, epoch, system);
  }
};

// One slice's ring, seen from one block.  Steps count from 0 in each
// phase; `slot` is an absolute slot index (phase 1: 0/1, phase 2: 2/3).
struct Ring {
  const Block& b;
  int n;
  int64_t slice;
  uint64_t epoch;

  __device__ uint64_t tag(int count) const {
    return epoch << kCountBits | (uint64_t)count;
  }
  __device__ uint64_t* recv_flag(const Rank& r, int slot) const {
    return r.flags + slice * 8 + slot;
  }
  __device__ uint64_t* ack_flag(const Rank& r, int slot) const {
    return r.flags + slice * 8 + 4 + slot;
  }
  // before writing the right neighbour's `slot` at step i: its ACK that
  // the slot is free (the slot was its send slot at step i-1)
  __device__ void wait_free(int i, int slot) const {
    if (i >= 1)
      wait_at_least(ack_flag(*b.self, slot), tag((i + 1) / 2), b.system);
  }
  __device__ void sent(int i, int slot) const {
    raise_flag(recv_flag(*b.right, slot), tag(i / 2 + 1), b.system);
  }
  __device__ void wait_received(int i, int slot) const {
    wait_at_least(recv_flag(*b.self, slot), tag(i / 2 + 1), b.system);
  }
  // my send slot of step i is dead: the left neighbour writes it next
  __device__ void free_slot(int i, int slot) const {
    if (i < n - 2)
      raise_flag(ack_flag(*b.left, slot), tag(i / 2 + 1), b.system);
  }
  // element e of the slice (0 <= e < kSlice) in `slot` of rank r
  __device__ float* at(const Rank& r, int slot, int64_t e) const {
    return static_cast<float*>(r.slots) + (slice * 4 + slot) * kSlice + e;
  }
};

__device__ __forceinline__ float4 slot4(const Ring& ring, int slot,
                                        int64_t e) {
  return __ldcg(reinterpret_cast<const float4*>(ring.at(*ring.b.self, slot,
                                                        e)));
}

__device__ __forceinline__ void push4(const Ring& ring, int slot, int64_t e,
                                      float4 v) {
  *reinterpret_cast<float4*>(ring.at(*ring.b.right, slot, e)) = v;
}

// -- A4 ---------------------------------------------------------------------

// x: rank's (CH, 128) block of `chunk` elements; out: (n*CH, 128)
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
allgather_kernel(const __grid_constant__ Launch L) {
  const Block b(L);
  const int n = L.n, me = b.me;
  const int64_t chunk = L.chunk;
  const int64_t nslices = (chunk + kSlice - 1) / kSlice;
  b.enter(L.epoch);
  for (int64_t slice = b.index; slice < nslices; slice += L.blocks) {
    const Ring ring{b, n, slice, L.epoch};
    const Rank& self = *b.self;
    const int64_t off = slice * kSlice;
    const int64_t len = chunk - off < kSlice ? chunk - off : kSlice;  // x128
    float4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t e = (int64_t)(k * kThreads + threadIdx.x) * 4;
      if (e < len) {
        v[k] = __ldg(reinterpret_cast<const float4*>(self.x + off + e));
        *reinterpret_cast<float4*>(self.out + me * chunk + off + e) = v[k];
      }
    }
    for (int i = 0; i < n - 1; ++i) {
      const int recv = (i + 1) & 1;
      ring.wait_free(i, recv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e < len) push4(ring, recv, e, v[k]);
      }
      ring.sent(i, recv);
      ring.wait_received(i, recv);
      const int src = (me - i - 1 + 2 * n) % n;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e < len) {
          v[k] = slot4(ring, recv, e);
          *reinterpret_cast<float4*>(self.out + src * chunk + off + e) = v[k];
        }
      }
      ring.free_slot(i, i & 1);
    }
  }
  b.leave(L.epoch);
}

// -- A5 ---------------------------------------------------------------------

// x, out: `size` float32 per rank, seen as n chunks of `chunk` elements
// (zero past size)
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
allreduce_kernel(const __grid_constant__ Launch L) {
  const Block b(L);
  const int n = L.n, me = b.me;
  const int64_t size = L.size, chunk = L.chunk;
  const int64_t nslices = (chunk + kSlice - 1) / kSlice;
  b.enter(L.epoch);
  for (int64_t slice = b.index; slice < nslices; slice += L.blocks) {
    const Ring ring{b, n, slice, L.epoch};
    const Rank& self = *b.self;
    const int64_t off = slice * kSlice;
    const int64_t len = chunk - off < kSlice ? chunk - off : kSlice;  // x1024
    float4 acc[kVec];
    // phase 1: reduce-scatter; my own chunk starts the walk
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t e = (int64_t)(k * kThreads + threadIdx.x) * 4;
      acc[k] = e < len ? flush4(load4(self.x, me * chunk + off + e, size))
                       : zero4();
    }
    for (int i = 0; i < n - 1; ++i) {
      const int recv = (i + 1) & 1;
      ring.wait_free(i, recv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e < len) push4(ring, recv, e, acc[k]);
      }
      ring.sent(i, recv);
      ring.wait_received(i, recv);
      const int c = (me - i - 1 + 2 * n) % n;  // the chunk received now
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e < len) {
          const float4 r = slot4(ring, recv, e);
          const float4 x = flush4(load4(self.x, c * chunk + off + e, size));
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
      const int64_t e = (int64_t)(k * kThreads + threadIdx.x) * 4;
      if (e < len) store4(self.out, owned * chunk + off + e, size, acc[k]);
    }
    // phase 2: all-gather of the reduced chunks, slots 2/3
    for (int i = 0; i < n - 1; ++i) {
      const int recv = 2 + ((i + 1) & 1);
      ring.wait_free(i, recv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e < len) push4(ring, recv, e, acc[k]);
      }
      ring.sent(i, recv);
      ring.wait_received(i, recv);
      const int c = (me - i + 2 * n) % n;  // owned by rank me-i-1
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = (int64_t)(k * kThreads + threadIdx.x) * 4;
        if (e < len) {
          acc[k] = slot4(ring, recv, e);
          store4(self.out, c * chunk + off + e, size, acc[k]);
        }
      }
      ring.free_slot(i, 2 + (i & 1));
    }
  }
  b.leave(L.epoch);
}

// -- A6 ---------------------------------------------------------------------

// A lane's share of one quantization block: 8 float4, element
// lane*4 + k*128 of the block for k = 0..7 (a warp's k-th access is 512
// contiguous bytes, its codes 128 contiguous bytes); the arithmetic is
// ring_common.cuh's, shared with ring_cluster.cu's A6.
using Codes = hvtpu::Codes<kLaneVec>;
using hvtpu::accumulate4;
using hvtpu::store_dequantized;

// the codes of quantization block `w` of the slice in `slot` of rank r:
// the first quarter of the slot's bytes; its scale in the scale slot
__device__ __forceinline__ int8_t* slot_codes_at(const Ring& ring,
                                                 const Rank& r, int slot,
                                                 int w) {
  return reinterpret_cast<int8_t*>(ring.at(r, slot, 0)) + w * kQBlock;
}

__device__ __forceinline__ float* slot_scale_at(const Ring& ring,
                                                const Rank& r, int slot,
                                                int w) {
  return r.scale_slots + (ring.slice * 4 + slot) * kWarps + w;
}

__device__ __forceinline__ void push_codes(const Ring& ring, int slot, int w,
                                           const Codes& c) {
  int8_t* q = slot_codes_at(ring, *ring.b.right, slot, w);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kLaneVec; ++k)
    *reinterpret_cast<uint32_t*>(q + lane * 4 + k * 128) = c.word[k];
  if (lane == 0) *slot_scale_at(ring, *ring.b.right, slot, w) = c.scale;
}

__device__ __forceinline__ Codes slot_codes(const Ring& ring, int slot,
                                            int w) {
  const int8_t* q = slot_codes_at(ring, *ring.b.self, slot, w);
  const int lane = threadIdx.x & 31;
  Codes c;
#pragma unroll
  for (int k = 0; k < kLaneVec; ++k)
    c.word[k] = __ldcg(reinterpret_cast<const unsigned int*>(
        q + lane * 4 + k * 128));
  c.scale = __ldcg(slot_scale_at(ring, *ring.b.self, slot, w));
  return c;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
quantized_allreduce_kernel(const __grid_constant__ Launch L) {
  const Block b(L);
  const int n = L.n, me = b.me;
  const int64_t size = L.size, chunk = L.chunk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t nslices = (chunk + kSlice - 1) / kSlice;
  b.enter(L.epoch);
  for (int64_t slice = b.index; slice < nslices; slice += L.blocks) {
    const Ring ring{b, n, slice, L.epoch};
    const Rank& self = *b.self;
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
      if (active) push_codes(ring, recv, warp, c);
      ring.sent(i, recv);
      ring.wait_received(i, recv);
      if (active) {
        const int ch = (me - i - 1 + 2 * n) % n;
        const Codes in = slot_codes(ring, recv, warp);
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
      if (active) push_codes(ring, recv, warp, c);
      ring.sent(i, recv);
      ring.wait_received(i, recv);
      if (active) {
        c = slot_codes(ring, recv, warp);
        store_dequantized(self.out, ((me - i + 2 * n) % n) * chunk + e0,
                          size, c);
      }
      ring.free_slot(i, 2 + (i & 1));
    }
  }
  b.leave(L.epoch);
}

const void* kernel_of(int kind) {  // 0: A4, 1: A5, 2: A6
  return kind == 0   ? (const void*)allgather_kernel
         : kind == 1 ? (const void*)allreduce_kernel
                     : (const void*)quantized_allreduce_kernel;
}

// Blocks of `kernel` the current card keeps resident at once, for a
// cooperative launch.
int resident_blocks(const void* kernel, int* out) {
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
  *out = per_sm * sms;
  return 0;
}

int launch(const void* kernel, Launch* args, int grid, cudaStream_t stream) {
  void* params[] = {args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3((unsigned)grid), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool bad_shape(int kind, int n, int64_t size, int64_t chunk, int64_t slice) {
  if (n < 2 || n >= kMaxRanks || slice != kSlice || chunk <= 0) return true;
  if (kind == 0) return size != chunk || chunk % 128;  // A4: one block
  return size <= 0 || chunk % kQBlock || (int64_t)n * chunk < size;
}

// ranks in one launch: B as many as the card keeps resident for n ranks,
// at most one a slice
int launch_table(int kind, const void* table, int n, int64_t size,
                 int64_t chunk, void* stream) {
  const void* kernel = kernel_of(kind);
  int resident = 0;
  const int err = resident_blocks(kernel, &resident);
  if (err) return err;
  int64_t b = resident / n;
  const int64_t nslices = (chunk + kSlice - 1) / kSlice;
  if (b > nslices) b = nslices;
  if (b < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Launch args{};
  args.table = static_cast<const Rank*>(table);
  args.n = n;
  args.rank = -1;
  args.blocks = (int)b;
  args.size = size;
  args.chunk = chunk;
  args.epoch = 1;  // fresh flags
  return launch(kernel, &args, n * (int)b,
                static_cast<cudaStream_t>(stream));
}

// a rank per process: `rows` holds this rank's left, self and right rows
int launch_rank(int kind, const int64_t* rows, int n, int rank, int blocks,
                uint64_t epoch, int64_t size, int64_t chunk,
                void* stream) {
  if (rank < 0 || rank >= n || blocks < 1 || epoch < 1 ||
      epoch >> (64 - kCountBits))
    return (int)cudaErrorInvalidValue;
  Launch args{};
  Rank* r[3] = {&args.left, &args.self, &args.right};
  for (int k = 0; k < 3; ++k) {
    const int64_t* row = rows + 6 * k;
    *r[k] = Rank{reinterpret_cast<const float*>(row[0]),
                 reinterpret_cast<float*>(row[1]),
                 reinterpret_cast<void*>(row[2]),
                 reinterpret_cast<float*>(row[3]),
                 reinterpret_cast<uint64_t*>(row[4]),
                 reinterpret_cast<uint64_t*>(row[5])};
  }
  args.n = n;
  args.rank = rank;
  args.blocks = blocks;
  args.size = size;
  args.chunk = chunk;
  args.epoch = epoch;
  return launch(kernel_of(kind), &args, blocks,
                static_cast<cudaStream_t>(stream));
}

}  // namespace

// -- ranks in one launch ------------------------------------------------------

// A4: `size` and `chunk` are both CH*128, a multiple of 128.
extern "C" int hvtpu_ring_allgather(const void* table, int n, int64_t size,
                                    int64_t chunk, int64_t slice,
                                    int quantized, void* stream) {
  if (quantized || bad_shape(0, n, size, chunk, slice))
    return (int)cudaErrorInvalidValue;
  return launch_table(0, table, n, size, chunk, stream);
}

// A5 (quantized = 0) and A6 (quantized = 1): `size` float32 a rank,
// `chunk` a multiple of 1024 with n*chunk >= size.
extern "C" int hvtpu_ring_allreduce(const void* table, int n, int64_t size,
                                    int64_t chunk, int64_t slice,
                                    int quantized, void* stream) {
  if (bad_shape(1, n, size, chunk, slice)) return (int)cudaErrorInvalidValue;
  return launch_table(quantized ? 2 : 1, table, n, size, chunk, stream);
}

// -- a rank per process -------------------------------------------------------

extern "C" int hvtpu_ring_allgather_rank(const int64_t* rows, int n,
                                         int rank, int blocks,
                                         uint64_t epoch, int64_t size,
                                         int64_t chunk, int64_t slice,
                                         int quantized, void* stream) {
  if (quantized || bad_shape(0, n, size, chunk, slice))
    return (int)cudaErrorInvalidValue;
  return launch_rank(0, rows, n, rank, blocks, epoch, size, chunk, stream);
}

extern "C" int hvtpu_ring_allreduce_rank(const int64_t* rows, int n,
                                         int rank, int blocks,
                                         uint64_t epoch, int64_t size,
                                         int64_t chunk, int64_t slice,
                                         int quantized, void* stream) {
  if (bad_shape(1, n, size, chunk, slice)) return (int)cudaErrorInvalidValue;
  return launch_rank(quantized ? 2 : 1, rows, n, rank, blocks, epoch, size,
                     chunk, stream);
}

// B of this card for a communicator: the least, over A4, A5 and A6, of
// the blocks a cooperative launch keeps resident.
extern "C" int hvtpu_ring_ipc_blocks(int* out) {
  int least = 0;
  for (int kind = 0; kind < 3; ++kind) {
    int b = 0;
    const int err = resident_blocks(kernel_of(kind), &b);
    if (err) return err;
    if (kind == 0 || b < least) least = b;
  }
  if (least < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *out = least;
  return 0;
}

// A rank's slots and flags: `bytes` of device memory from cudaMalloc (so
// the handle names the allocation's base), zeroed once, finished before
// the handle leaves this process; `handle` receives the
// cudaIpcMemHandle_t (64 bytes).
extern "C" int hvtpu_ring_ipc_alloc(int64_t bytes, void** ptr, void* handle) {
  void* p = nullptr;
  cudaError_t err = cudaMalloc(&p, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(p, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), p);
  if (err != cudaSuccess) {
    cudaFree(p);
    return (int)err;
  }
  *ptr = p;
  return 0;
}

// Map a peer's allocation (its handle, 64 bytes) into this process.
extern "C" int hvtpu_ring_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int hvtpu_ring_ipc_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int hvtpu_ring_ipc_free(void* ptr) { return (int)cudaFree(ptr); }

extern "C" const char* hvtpu_ring_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
