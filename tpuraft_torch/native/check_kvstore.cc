// Sanitizer exercise driver for the KV storage engine (kvstore.cc).
// Concurrent writers / readers / scanner / checkpointer over the real
// C ABI, then reopen-and-verify.  Run under TSAN and ASAN by
// `make -C native check-native` (SURVEY.md §6 race-detection row).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* tkv_open(const char* dir, int sync, int64_t ckpt_wal_bytes,
               char* err, int errlen);
void* tkv_open2(const char* dir, int sync, int64_t ckpt_wal_bytes,
                int64_t memtable_budget, int64_t max_runs,
                char* err, int errlen);
int64_t tkv_run_count(void* h);
void tkv_close(void* h);
void tkv_free(uint8_t* p);
int tkv_apply_batch(void* h, const uint8_t* ops, int64_t len,
                    char* err, int errlen);
int64_t tkv_get(void* h, int col, const uint8_t* k, int64_t kl,
                uint8_t** out);
int64_t tkv_scan(void* h, int col, const uint8_t* start, int64_t sl,
                 const uint8_t* end, int64_t el, int64_t limit,
                 int with_values, int reverse, uint8_t** out);
int tkv_checkpoint(void* h, char* err, int errlen);
int64_t tkv_count(void* h, int col);
}

namespace {

// op(1) col(1) klen(4) key vlen(4) val
std::string put_op(const std::string& k, const std::string& v) {
  std::string s;
  s.push_back(1);
  s.push_back(0);
  uint32_t kl = k.size(), vl = v.size();
  s.append(reinterpret_cast<char*>(&kl), 4);
  s += k;
  s.append(reinterpret_cast<char*>(&vl), 4);
  s += v;
  return s;
}

}  // namespace

int main(int argc, char** argv) {
  const char* dir = argc > 1 ? argv[1] : "/tmp/tpuraft_check_kvstore";
  std::string cmd = std::string("rm -rf ") + dir;
  if (system(cmd.c_str()) != 0) return 2;
  char err[256] = {0};
  void* h = tkv_open(dir, 0 /*no fsync: sanitizer speed*/, 1 << 16,
                     err, sizeof(err));
  if (!h) {
    fprintf(stderr, "open failed: %s\n", err);
    return 1;
  }

  constexpr int kWriters = 3;
  constexpr int kPerWriter = 2000;
  std::atomic<bool> stop{false};

  std::vector<std::thread> writers;
  for (int w = 0; w < kWriters; ++w) {
    writers.emplace_back([&, w] {
      for (int i = 0; i < kPerWriter; ++i) {
        std::string k = "k" + std::to_string(w) + "-" + std::to_string(i);
        std::string ops = put_op(k, "v" + std::to_string(i));
        char e[256];
        if (tkv_apply_batch(h, reinterpret_cast<const uint8_t*>(ops.data()),
                            static_cast<int64_t>(ops.size()), e,
                            sizeof(e)) != 0) {
          fprintf(stderr, "put failed: %s\n", e);
          abort();
        }
      }
    });
  }

  std::thread reader([&] {
    uint64_t i = 0;
    while (!stop.load(std::memory_order_acquire)) {
      std::string k = "k0-" + std::to_string(i++ % kPerWriter);
      uint8_t* out = nullptr;
      int64_t n = tkv_get(h, 0, reinterpret_cast<const uint8_t*>(k.data()),
                          static_cast<int64_t>(k.size()), &out);
      if (n >= 0) tkv_free(out);
    }
  });

  std::thread scanner([&] {
    while (!stop.load(std::memory_order_acquire)) {
      uint8_t* out = nullptr;
      int64_t n = tkv_scan(h, 0, nullptr, 0, nullptr, 0, 64, 1, 0, &out);
      if (n >= 0) tkv_free(out);
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  });

  std::thread ckpt([&] {
    while (!stop.load(std::memory_order_acquire)) {
      char e[256];
      tkv_checkpoint(h, e, sizeof(e));
      std::this_thread::sleep_for(std::chrono::milliseconds(10));
    }
  });

  for (auto& w : writers) w.join();
  stop.store(true, std::memory_order_release);
  reader.join();
  scanner.join();
  ckpt.join();

  int64_t n = tkv_count(h, 0);
  if (n != kWriters * kPerWriter) {
    fprintf(stderr, "count %lld != %d\n", (long long)n,
            kWriters * kPerWriter);
    return 1;
  }
  tkv_close(h);
  // reopen: checkpoint + WAL replay must reconstruct everything
  h = tkv_open(dir, 0, 1 << 16, err, sizeof(err));
  if (!h) {
    fprintf(stderr, "reopen failed: %s\n", err);
    return 1;
  }
  if (tkv_count(h, 0) != kWriters * kPerWriter) {
    fprintf(stderr, "reopen count %lld\n", (long long)tkv_count(h, 0));
    return 1;
  }
  tkv_close(h);
  printf("check_kvstore OK (%d entries, concurrent write/read/scan/ckpt)\n",
         kWriters * kPerWriter);

  // -- LSM phase: spills + background compactor under the sanitizer ---------
  std::string lsm_dir = std::string(dir) + "_lsm";
  cmd = std::string("rm -rf ") + lsm_dir;
  if (system(cmd.c_str()) != 0) return 2;
  h = tkv_open2(lsm_dir.c_str(), 0, 1 << 16, 16 << 10 /*16KB budget*/,
                3 /*max runs -> frequent compaction*/, err, sizeof(err));
  if (!h) {
    fprintf(stderr, "lsm open failed: %s\n", err);
    return 1;
  }
  std::atomic<bool> lstop{false};
  std::vector<std::thread> lwriters;
  constexpr int kLsmPer = 1500;
  for (int w = 0; w < 2; ++w) {
    lwriters.emplace_back([&, w] {
      for (int i = 0; i < kLsmPer; ++i) {
        std::string k = "L" + std::to_string(w) + "-" + std::to_string(i);
        std::string ops = put_op(k, std::string(100, 'x'));
        char e[256];
        if (tkv_apply_batch(h, reinterpret_cast<const uint8_t*>(ops.data()),
                            static_cast<int64_t>(ops.size()), e,
                            sizeof(e)) != 0) {
          fprintf(stderr, "lsm put failed: %s\n", e);
          abort();
        }
      }
    });
  }
  std::thread lreader([&] {
    uint64_t i = 0;
    while (!lstop.load(std::memory_order_acquire)) {
      std::string k = "L0-" + std::to_string(i++ % kLsmPer);
      uint8_t* out = nullptr;
      int64_t n = tkv_get(h, 0, reinterpret_cast<const uint8_t*>(k.data()),
                          static_cast<int64_t>(k.size()), &out);
      if (n >= 0) tkv_free(out);
      uint8_t* sc = nullptr;
      n = tkv_scan(h, 0, nullptr, 0, nullptr, 0, 32, 1, i % 2, &sc);
      if (n >= 0) tkv_free(sc);
    }
  });
  for (auto& w : lwriters) w.join();
  lstop.store(true, std::memory_order_release);
  lreader.join();
  if (tkv_count(h, 0) != 2 * kLsmPer) {
    fprintf(stderr, "lsm count %lld != %d\n", (long long)tkv_count(h, 0),
            2 * kLsmPer);
    return 1;
  }
  int64_t runs = tkv_run_count(h);
  tkv_close(h);
  h = tkv_open2(lsm_dir.c_str(), 0, 1 << 16, 16 << 10, 3, err, sizeof(err));
  if (!h || tkv_count(h, 0) != 2 * kLsmPer) {
    fprintf(stderr, "lsm reopen count mismatch\n");
    return 1;
  }
  tkv_close(h);
  printf("check_kvstore LSM OK (%d entries, %lld runs, concurrent "
         "write/read/scan + background compaction)\n",
         2 * kLsmPer, (long long)runs);
  return 0;
}
