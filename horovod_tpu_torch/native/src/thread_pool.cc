#include "thread_pool.h"

#include <algorithm>
#include <cstring>

namespace hvt {

ThreadPool::ThreadPool(int num_threads) {
  num_threads = std::max(1, num_threads);
  workers_.reserve(num_threads);
  for (int i = 0; i < num_threads; ++i) {
    workers_.emplace_back([this] { Loop(); });
  }
}

ThreadPool::~ThreadPool() {
  {
    std::lock_guard<std::mutex> g(mu_);
    stop_ = true;
  }
  cv_.notify_all();
  for (std::thread& t : workers_) t.join();
}

void ThreadPool::Loop() {
  for (;;) {
    std::function<void()> task;
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
      if (stop_ && tasks_.empty()) return;
      task = std::move(tasks_.front());
      tasks_.pop();
    }
    task();
    {
      std::lock_guard<std::mutex> g(mu_);
      if (--outstanding_ == 0) done_cv_.notify_all();
    }
  }
}

void ThreadPool::ParallelFor(int64_t n, const std::function<void(int64_t)>& fn) {
  if (n <= 0) return;
  if (n == 1 || workers_.empty()) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  {
    std::lock_guard<std::mutex> g(mu_);
    outstanding_ += n;
    for (int64_t i = 0; i < n; ++i) {
      tasks_.push([&fn, i] { fn(i); });
    }
  }
  cv_.notify_all();
  std::unique_lock<std::mutex> lk(mu_);
  done_cv_.wait(lk, [this] { return outstanding_ == 0; });
}

ThreadPool& GlobalPool() {
  static ThreadPool pool(
      std::max(2u, std::thread::hardware_concurrency() / 2));
  return pool;
}

}  // namespace hvt
