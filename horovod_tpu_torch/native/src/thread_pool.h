// Worker pool for parallel host-memory packing.
//
// Parity: horovod/common/thread_pool.cc (used there to parallelize
// MemcpyInFusionBuffer on CPU).  Here it parallelizes gather/scatter of
// many eager tensors (e.g. torch grads) into/out of one flat fusion
// staging buffer before/after a fused collective.
#pragma once

#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace hvt {

class ThreadPool {
 public:
  explicit ThreadPool(int num_threads);
  ~ThreadPool();
  // Run fn(i) for i in [0, n) across the pool; blocks until done.
  void ParallelFor(int64_t n, const std::function<void(int64_t)>& fn);
  int num_threads() const { return static_cast<int>(workers_.size()); }

 private:
  void Loop();
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::queue<std::function<void()>> tasks_;
  int64_t outstanding_ = 0;
  bool stop_ = false;
};

// Process-wide pool, lazily constructed.
ThreadPool& GlobalPool();

}  // namespace hvt
