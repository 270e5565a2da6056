// Sanitizer exercise driver for the shared multi-group log engine
// (multilog.cc): concurrent per-group appenders + readers + a syncer +
// prefix truncation + GC, then reopen-and-verify every group.
// Run under TSAN and ASAN by `make -C native check-native`.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

extern "C" {
struct tlm_handle;
tlm_handle* tlm_open(const char* dir, int64_t seg_max, char* err, int errlen);
void tlm_close(tlm_handle* h);
uint32_t tlm_register_group(tlm_handle* h, const char* name, char* err,
                            int errlen);
int64_t tlm_first(tlm_handle* h, uint32_t gid);
int64_t tlm_last(tlm_handle* h, uint32_t gid);
int64_t tlm_append(tlm_handle* h, uint32_t gid, const uint8_t* frames,
                   int64_t total, char* err, int errlen);
int tlm_sync(tlm_handle* h, char* err, int errlen);
int64_t tlm_sync_count(tlm_handle* h);
int64_t tlm_get(tlm_handle* h, uint32_t gid, int64_t index, uint8_t** out);
void tlm_free(uint8_t* buf);
int tlm_truncate_prefix(tlm_handle* h, uint32_t gid, int64_t first_kept);
int64_t tlm_gc(tlm_handle* h);
int64_t tlm_file_count(tlm_handle* h);
}

namespace {

constexpr size_t kHdr = 32;

std::string make_frame(int64_t index, int64_t term, const std::string& data) {
  std::string blob(kHdr, '\0');
  uint8_t* p = reinterpret_cast<uint8_t*>(blob.data());
  p[0] = 0xB8;
  p[1] = 1;
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
  const char* dir = argc > 1 ? argv[1] : "/tmp/tpuraft_check_multilog";
  std::string cmd = std::string("rm -rf ") + dir;
  if (system(cmd.c_str()) != 0) return 2;
  char err[256] = {0};
  tlm_handle* h = tlm_open(dir, 1 << 16, err, sizeof(err));
  if (!h) {
    fprintf(stderr, "open failed: %s\n", err);
    return 1;
  }

  constexpr int kGroups = 8;
  constexpr int64_t kPerGroup = 1500;
  uint32_t gids[kGroups];
  for (int g = 0; g < kGroups; ++g) {
    std::string name = "grp" + std::to_string(g);
    gids[g] = tlm_register_group(h, name.c_str(), err, sizeof(err));
    if (!gids[g]) {
      fprintf(stderr, "register failed: %s\n", err);
      return 1;
    }
  }

  std::atomic<int64_t> appended[kGroups];
  for (auto& a : appended) a.store(0);
  std::atomic<bool> stop{false};

  std::vector<std::thread> appenders;
  for (int g = 0; g < kGroups; ++g) {
    appenders.emplace_back([&, g] {
      for (int64_t i = 1; i <= kPerGroup; ++i) {
        std::string f = make_frame(i, g + 1, "d" + std::to_string(i));
        char e[256];
        if (tlm_append(h, gids[g], (const uint8_t*)f.data(),
                       (int64_t)f.size(), e, sizeof(e)) != 1) {
          fprintf(stderr, "append g%d/%lld: %s\n", g, (long long)i, e);
          abort();
        }
        appended[g].store(i, std::memory_order_release);
      }
    });
  }

  std::thread syncer([&] {
    while (!stop.load(std::memory_order_acquire)) {
      char e[256];
      if (tlm_sync(h, e, sizeof(e)) != 0) {
        fprintf(stderr, "sync: %s\n", e);
        abort();
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(2));
    }
  });

  std::vector<std::thread> readers;
  for (int t = 0; t < 2; ++t) {
    readers.emplace_back([&, t] {
      uint64_t n = 0;
      while (!stop.load(std::memory_order_acquire)) {
        int g = (int)(n % kGroups);
        int64_t hi = appended[g].load(std::memory_order_acquire);
        int64_t lo = tlm_first(h, gids[g]);
        if (hi >= lo && hi > 0) {
          int64_t idx = lo + (int64_t)((n * 131) % (uint64_t)(hi - lo + 1));
          uint8_t* blob = nullptr;
          int64_t r = tlm_get(h, gids[g], idx, &blob);
          if (r > 0) {
            int64_t got;
            memcpy(&got, blob + 12, 8);
            if (got != idx) {
              fprintf(stderr, "g%d idx %lld != %lld\n", g, (long long)got,
                      (long long)idx);
              abort();
            }
            tlm_free(blob);
          }
        }
        ++n;
      }
    });
  }

  std::thread truncator([&] {
    while (!stop.load(std::memory_order_acquire)) {
      for (int g = 0; g < kGroups; g += 2) {
        int64_t hi = appended[g].load(std::memory_order_acquire);
        if (hi > 400) tlm_truncate_prefix(h, gids[g], hi - 300);
      }
      tlm_gc(h);
      std::this_thread::sleep_for(std::chrono::milliseconds(7));
    }
  });

  for (auto& a : appenders) a.join();
  stop.store(true, std::memory_order_release);
  syncer.join();
  for (auto& r : readers) r.join();
  truncator.join();

  char e2[256];
  tlm_sync(h, e2, sizeof(e2));
  tlm_close(h);

  h = tlm_open(dir, 1 << 16, err, sizeof(err));
  if (!h) {
    fprintf(stderr, "reopen failed: %s\n", err);
    return 1;
  }
  for (int g = 0; g < kGroups; ++g) {
    std::string name = "grp" + std::to_string(g);
    uint32_t gid = tlm_register_group(h, name.c_str(), err, sizeof(err));
    if (tlm_last(h, gid) != kPerGroup) {
      fprintf(stderr, "g%d last %lld != %lld\n", g,
              (long long)tlm_last(h, gid), (long long)kPerGroup);
      return 1;
    }
    uint8_t* blob = nullptr;
    int64_t r = tlm_get(h, gid, tlm_first(h, gid), &blob);
    if (r <= 0) return 1;
    tlm_free(blob);
  }
  printf("check_multilog OK (%d groups x %lld entries, %lld fsync rounds, "
         "%lld files)\n",
         kGroups, (long long)kPerGroup, (long long)tlm_sync_count(h),
         (long long)tlm_file_count(h));
  tlm_close(h);
  return 0;
}
