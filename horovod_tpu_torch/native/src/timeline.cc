#include "timeline.h"

namespace hvt {

static std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

TimelineWriter::TimelineWriter(const std::string& path, int32_t rank)
    : rank_(rank) {
  f_ = fopen(path.c_str(), "w");
  if (f_) fputs("[\n", f_);
}

TimelineWriter::~TimelineWriter() {
  if (f_) {
    // Chrome tracing tolerates a missing closing bracket (crash-safe
    // appends, same property the reference relies on); close properly.
    fputs("\n]\n", f_);
    fclose(f_);
  }
}

void TimelineWriter::Event(const std::string& name, char ph,
                           const std::string& category, double ts_us,
                           double dur_us) {
  if (!f_) return;
  std::lock_guard<std::mutex> g(mu_);
  if (!first_) fputs(",\n", f_);
  first_ = false;
  if (ph == 'X') {
    fprintf(f_,
            "{\"name\":\"%s\",\"cat\":\"%s\",\"ph\":\"X\",\"ts\":%.3f,"
            "\"dur\":%.3f,\"pid\":%d,\"tid\":0}",
            JsonEscape(name).c_str(), JsonEscape(category).c_str(), ts_us,
            dur_us, rank_);
  } else {
    fprintf(f_,
            "{\"name\":\"%s\",\"cat\":\"%s\",\"ph\":\"%c\",\"ts\":%.3f,"
            "\"pid\":%d,\"tid\":0}",
            JsonEscape(name).c_str(), JsonEscape(category).c_str(), ph, ts_us,
            rank_);
  }
}

void TimelineWriter::MarkCycle(double ts_us) {
  // Parity: HOROVOD_TIMELINE_MARK_CYCLES instant events.
  Event("CYCLE", 'i', "cycle", ts_us);
}

void TimelineWriter::Flush() {
  std::lock_guard<std::mutex> g(mu_);
  if (f_) fflush(f_);
}

}  // namespace hvt
