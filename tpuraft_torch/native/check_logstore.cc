// Sanitizer exercise driver for the log storage engine (logstore.cc).
//
// Built with -fsanitize=thread / address by `make -C native san` and run
// by `make check` (SURVEY.md §6 "race detection": the reference leans on
// JVM memory safety + lock discipline; the C++ engines get TSAN/ASAN
// builds in CI instead).  Drives the real C ABI concurrently:
// one appender (raft log appends are single-writer by design) against
// readers and a prefix-truncator, then reopen-and-verify.

#include <atomic>
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

extern "C" {
struct tls_handle;
tls_handle* tls_open(const char* dir, int64_t seg_max, char* err, int errlen);
void tls_close(tls_handle* h);
int64_t tls_first_index(tls_handle* h);
int64_t tls_last_index(tls_handle* h);
int64_t tls_get(tls_handle* h, int64_t index, uint8_t** out);
void tls_free(uint8_t* buf);
int64_t tls_append(tls_handle* h, const uint8_t* frames, int64_t total,
                   int sync, char* err, int errlen);
int tls_truncate_prefix(tls_handle* h, int64_t first_kept);
int tls_truncate_suffix(tls_handle* h, int64_t last_kept);
}

namespace {

constexpr size_t kHdr = 32;

// Entry blob per tpuraft/entity.py _HDR "<BBHqqHHII".
std::string make_frame(int64_t index, int64_t term, const std::string& data) {
  std::string blob(kHdr, '\0');
  uint8_t* p = reinterpret_cast<uint8_t*>(blob.data());
  p[0] = 0xB8;
  p[1] = 1;  // DATA
  memcpy(p + 4, &term, 8);
  memcpy(p + 12, &index, 8);
  uint32_t dl = static_cast<uint32_t>(data.size());
  memcpy(p + 24, &dl, 4);
  uLong c = crc32(0L, Z_NULL, 0);
  c = crc32(c, reinterpret_cast<const Bytef*>(data.data()), dl);
  uint32_t crc = static_cast<uint32_t>(c);
  memcpy(p + 28, &crc, 4);
  blob += data;
  uint32_t flen = static_cast<uint32_t>(blob.size());
  std::string frame(4, '\0');
  memcpy(frame.data(), &flen, 4);
  return frame + blob;
}

}  // namespace

int main(int argc, char** argv) {
  const char* dir = argc > 1 ? argv[1] : "/tmp/tpuraft_check_logstore";
  std::string cmd = std::string("rm -rf ") + dir;
  if (system(cmd.c_str()) != 0) return 2;
  char err[256] = {0};
  tls_handle* h = tls_open(dir, 1 << 16 /*small segs -> many rotations*/,
                           err, sizeof(err));
  if (!h) {
    fprintf(stderr, "open failed: %s\n", err);
    return 1;
  }

  constexpr int64_t kN = 4000;
  std::atomic<int64_t> appended{0};
  std::atomic<bool> stop{false};

  std::thread appender([&] {
    for (int64_t i = 1; i <= kN; ++i) {
      std::string f = make_frame(i, 7, "payload-" + std::to_string(i));
      char e[256];
      int64_t n = tls_append(h, reinterpret_cast<const uint8_t*>(f.data()),
                             static_cast<int64_t>(f.size()),
                             (i % 64) == 0 /*periodic fsync*/, e, sizeof(e));
      if (n != 1) {
        fprintf(stderr, "append %lld failed: %s\n", (long long)i, e);
        abort();
      }
      appended.store(i, std::memory_order_release);
    }
  });

  std::vector<std::thread> readers;
  for (int t = 0; t < 3; ++t) {
    readers.emplace_back([&] {
      uint64_t checked = 0;
      while (!stop.load(std::memory_order_acquire)) {
        int64_t hi = appended.load(std::memory_order_acquire);
        int64_t lo = tls_first_index(h);
        if (hi < lo) continue;
        int64_t idx = lo + (checked * 97) % (hi - lo + 1);
        uint8_t* blob = nullptr;
        int64_t n = tls_get(h, idx, &blob);
        if (n > 0) {
          int64_t got;
          memcpy(&got, blob + 12, 8);
          if (got != idx) {
            fprintf(stderr, "index mismatch %lld != %lld\n", (long long)got,
                    (long long)idx);
            abort();
          }
          tls_free(blob);
        }
        ++checked;
      }
    });
  }

  std::thread truncator([&] {
    while (!stop.load(std::memory_order_acquire)) {
      int64_t hi = appended.load(std::memory_order_acquire);
      if (hi > 600) {
        tls_truncate_prefix(h, hi - 500);
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(5));
    }
  });

  appender.join();
  stop.store(true, std::memory_order_release);
  for (auto& r : readers) r.join();
  truncator.join();

  if (tls_last_index(h) != kN) {
    fprintf(stderr, "last index %lld != %lld\n",
            (long long)tls_last_index(h), (long long)kN);
    return 1;
  }
  // suffix truncation + reopen survives
  if (tls_truncate_suffix(h, kN - 10) != 0) return 1;
  tls_close(h);
  h = tls_open(dir, 1 << 16, err, sizeof(err));
  if (!h || tls_last_index(h) != kN - 10) {
    fprintf(stderr, "reopen: %s last=%lld\n", err,
            h ? (long long)tls_last_index(h) : -1);
    return 1;
  }
  uint8_t* blob = nullptr;
  int64_t n = tls_get(h, tls_first_index(h), &blob);
  if (n <= 0) return 1;
  tls_free(blob);
  tls_close(h);
  printf("check_logstore OK (%lld entries, concurrent read/truncate)\n",
         (long long)kN);
  return 0;
}
