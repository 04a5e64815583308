// Chrome-trace timeline writer.
//
// Parity: horovod/common/timeline.cc (Timeline, TimelineController) —
// the HOROVOD_TIMELINE chrome://tracing JSON of per-tensor lifecycle
// phases (NEGOTIATE_* -> QUEUE -> fusion memcpy -> collective).  Here
// the phase vocabulary is the port's pipeline (NEGOTIATE -> QUEUE ->
// PACK -> COLLECTIVE -> UNPACK); the file format is identical, so
// the same chrome://tracing / Perfetto UI reads both.
#pragma once

#include <cstdio>
#include <mutex>
#include <string>

namespace hvt {

class TimelineWriter {
 public:
  TimelineWriter(const std::string& path, int32_t rank);
  ~TimelineWriter();
  bool ok() const { return f_ != nullptr; }
  // ph: 'B' begin, 'E' end, 'X' complete (with dur_us), 'i' instant.
  void Event(const std::string& name, char ph, const std::string& category,
             double ts_us, double dur_us = 0);
  void MarkCycle(double ts_us);
  void Flush();

 private:
  std::mutex mu_;
  FILE* f_ = nullptr;
  int32_t rank_;
  bool first_ = true;
};

}  // namespace hvt
