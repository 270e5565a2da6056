// tpuraft native KV storage engine.
//
// Reference parity: the role RocksDB (C++, via rocksdbjni) plays under
// rhea:storage/RocksRawKVStore — the durable ordered-KV engine shared by
// every RegionEngine of a process (SURVEY.md §3.2/§3.4).  Purpose-built
// for RheaKV's access pattern — point ops + range scans from a
// single-writer state-machine thread.  TWO storage modes:
//
// MEMTABLE mode (memtable_budget = 0, the original engine): ordered
// in-memory tables + CRC-framed WAL + atomic full checkpoint that
// truncates the WAL.  Datasets must fit RAM; checkpoints are O(dataset).
//
// LSM mode (memtable_budget > 0 via tkv_open2 — VERDICT r1 #7, the
// RocksDB >RAM role): when the memtable reaches the budget it SPILLS to
// an immutable sorted-run file (run_<seq>.sst: per-column sorted points
// with tombstone flags + range tombstones, CRC trailer, mmap'd with a
// sparse in-memory index) listed in an atomically-rewritten manifest;
// the WAL truncates at each spill, so recovery replays at most one
// memtable's worth.  Reads merge memtable -> runs newest-first with
// point/range tombstones masking older eras.  A background thread
// compacts when runs exceed max_runs: size-tiered pick-K — the cheapest
// contiguous window of runs merges into one (tombstones drop only on
// bottom-tier merges), so compaction I/O per cycle is independent of
// total store size — immutable runs swap under the store mutex, writers
// only ever touch the memtable.  Working sets page via mmap, so datasets
// several times RAM (or budget) stay serviceable.
//
// Columns (fixed): 0=data 1=sequence 2=lock 3=meta.  Column semantics
// (what a sequence/lock value means) live in the Python wrapper
// (tpuraft/rheakv/native_store.py) — apply-time logic is single-threaded
// through the raft state machine, so read-modify-write up there is safe.
//
// On-disk layout under the store dir:
//   wal.log     repeated [ u32le len | u32le crc32(payload) | payload ]
//               payload = 1+ ops: op(1) col(1) klen(4) key vlen(4) val
//               op: 1=put 2=delete 3=delete_range(key=start, val=end)
//               One record per write call -> each call is atomic; a torn
//               tail (short frame or CRC mismatch) is dropped on replay.
//   checkpoint  magic "TKV1" | per col: u32 count, (klen key vlen val)* |
//               u32 crc32(everything after magic)
//               written tmp+fsync+rename+dirsync, then the WAL truncates.
//
// Exposed as a C ABI for ctypes.  All returned buffers are malloc'd and
// released with tkv_free.

#include <atomic>
#include <cerrno>
#include <string_view>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <tuple>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>
#include <zlib.h>

namespace {

constexpr int kNumCols = 4;
constexpr char kCkptMagic[4] = {'T', 'K', 'V', '1'};
constexpr uint8_t kOpPut = 1;
constexpr uint8_t kOpDelete = 2;
constexpr uint8_t kOpDeleteRange = 3;
constexpr int64_t kDefaultCkptWalBytes = 64LL << 20;

uint32_t load_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
void put_u32(std::string* out, uint32_t v) {
  out->append(reinterpret_cast<const char*>(&v), 4);
}

uint32_t crc32_of(const void* data, size_t n) {
  return static_cast<uint32_t>(
      crc32(0L, static_cast<const Bytef*>(data), static_cast<uInt>(n)));
}

bool fsync_fd(int fd) { return fsync(fd) == 0; }

bool fsync_dir(const std::string& dir) {
  int fd = open(dir.c_str(), O_RDONLY);
  if (fd < 0) return false;
  bool ok = fsync(fd) == 0;
  close(fd);
  return ok;
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

using Table = std::map<std::string, std::string>;

constexpr char kRunMagic[4] = {'T', 'K', 'R', '1'};
constexpr uint8_t kPtLive = 0;
constexpr uint8_t kPtTomb = 1;
constexpr size_t kIdxStride = 64;  // sparse index: every Nth point

// An immutable sorted-run file (LSM mode), mmap'd.
// Layout: magic | per col: [u32 n_points, points..., u32 n_ranges,
// ranges...] | u32 crc(body).  point = u8 flag u32 klen key u32 vlen
// val; range = u32 slen s u32 elen e (end empty = +inf).
struct Run {
  std::string path;
  uint32_t seq = 0;
  int fd = -1;
  uint8_t* map = reinterpret_cast<uint8_t*>(MAP_FAILED);
  size_t map_len = 0;

  struct ColIdx {
    uint32_t n_points = 0;
    size_t points_off = 0;   // file offset of first point entry
    size_t points_end = 0;
    // sparse index: (key of point i*kIdxStride, its file offset)
    std::vector<std::pair<std::string, size_t>> sparse;
    std::vector<std::pair<std::string, std::string>> ranges;
    // lazily-built full offsets (reverse scans); empty until needed
    std::vector<uint32_t> all_offsets;
  };
  ColIdx cols[kNumCols];

  ~Run() {
    if (map != MAP_FAILED) munmap(map, map_len);
    if (fd >= 0) close(fd);
  }
};

struct Store {
  std::mutex mu;
  std::string dir;
  Table cols[kNumCols];
  int wal_fd = -1;
  int64_t wal_bytes = 0;
  bool sync = true;
  int64_t ckpt_wal_bytes = kDefaultCkptWalBytes;
  int64_t ckpt_retry_floor = 0;  // backoff marker after a failed auto-ckpt

  // -- LSM mode (memtable_budget > 0) --------------------------------------
  int64_t memtable_budget = 0;        // 0 = memtable mode (legacy)
  int64_t max_runs = 6;
  int64_t mem_bytes = 0;              // approx bytes held by cols+dead+ranges
  Table dead[kNumCols];               // point tombstones (key -> "")
  std::vector<std::pair<std::string, std::string>> range_dead[kNumCols];
  std::vector<std::unique_ptr<Run>> runs;  // oldest .. newest
  uint32_t next_run_seq = 1;
  // background compaction (size-tiered pick-K; see compactor_main)
  std::thread compactor;
  std::condition_variable compact_cv;
  bool stopping = false;
  bool compact_running = false;
  int64_t compactions = 0;               // cycles completed
  int64_t compact_input_bytes = 0;       // cumulative input bytes merged
  int64_t compact_last_input_bytes = 0;  // last cycle's input bytes

  bool lsm() const { return memtable_budget > 0; }

  std::string wal_path() const { return dir + "/wal.log"; }
  std::string ckpt_path() const { return dir + "/checkpoint"; }
  std::string manifest_path() const { return dir + "/manifest"; }
};

// -- op encoding shared by WAL records and tkv_apply_batch ------------------

// Validates and applies one op stream to the tables. Returns false on a
// malformed stream (nothing about partial application matters to callers:
// WAL replay treats malformed == torn tail, and tkv_apply_batch validates
// before applying).
bool parse_ops(const uint8_t* p, size_t n,
               std::vector<std::tuple<uint8_t, uint8_t, std::string,
                                      std::string>>* out) {
  size_t off = 0;
  while (off < n) {
    if (off + 2 + 4 > n) return false;
    uint8_t op = p[off], col = p[off + 1];
    off += 2;
    if (op < kOpPut || op > kOpDeleteRange || col >= kNumCols) return false;
    uint32_t klen = load_u32(p + off);
    off += 4;
    if (off + klen + 4 > n) return false;
    std::string key(reinterpret_cast<const char*>(p + off), klen);
    off += klen;
    uint32_t vlen = load_u32(p + off);
    off += 4;
    if (off + vlen > n) return false;
    std::string val(reinterpret_cast<const char*>(p + off), vlen);
    off += vlen;
    out->emplace_back(op, col, std::move(key), std::move(val));
  }
  return true;
}

void apply_ops(Store* s,
               const std::vector<std::tuple<uint8_t, uint8_t, std::string,
                                            std::string>>& ops) {
  for (const auto& [op, col, key, val] : ops) {
    Table& t = s->cols[col];
    if (!s->lsm()) {
      switch (op) {
        case kOpPut:
          t[key] = val;
          break;
        case kOpDelete:
          t.erase(key);
          break;
        case kOpDeleteRange: {
          auto lo = key.empty() ? t.begin() : t.lower_bound(key);
          auto hi = val.empty() ? t.end() : t.lower_bound(val);
          t.erase(lo, hi);
          break;
        }
      }
      continue;
    }
    // LSM mode: deletions become tombstones so older runs stay masked
    Table& dd = s->dead[col];
    switch (op) {
      case kOpPut: {
        auto [it, inserted] = t.insert_or_assign(key, val);
        (void)it;
        s->mem_bytes += static_cast<int64_t>(key.size() + val.size());
        auto di = dd.find(key);
        if (di != dd.end()) {
          s->mem_bytes -= static_cast<int64_t>(di->first.size());
          dd.erase(di);
        }
        break;
      }
      case kOpDelete: {
        auto li = t.find(key);
        if (li != t.end()) {
          s->mem_bytes -=
              static_cast<int64_t>(li->first.size() + li->second.size());
          t.erase(li);
        }
        if (dd.emplace(key, std::string()).second)
          s->mem_bytes += static_cast<int64_t>(key.size());
        break;
      }
      case kOpDeleteRange: {
        auto lo = key.empty() ? t.begin() : t.lower_bound(key);
        auto hi = val.empty() ? t.end() : t.lower_bound(val);
        for (auto it = lo; it != hi; ++it)
          s->mem_bytes -=
              static_cast<int64_t>(it->first.size() + it->second.size());
        t.erase(lo, hi);
        // point tombstones inside the range are subsumed by it
        auto dlo = key.empty() ? dd.begin() : dd.lower_bound(key);
        auto dhi = val.empty() ? dd.end() : dd.lower_bound(val);
        for (auto it = dlo; it != dhi; ++it)
          s->mem_bytes -= static_cast<int64_t>(it->first.size());
        dd.erase(dlo, dhi);
        s->range_dead[col].emplace_back(key, val);
        s->mem_bytes += static_cast<int64_t>(key.size() + val.size());
        break;
      }
    }
  }
}

// -- LSM runs (memtable_budget > 0) -----------------------------------------

bool write_all_fd(int fd, const void* buf, size_t len, std::string* err) {
  const char* p = static_cast<const char*>(buf);
  while (len > 0) {
    ssize_t w = write(fd, p, len);
    if (w < 0) {
      if (errno == EINTR) continue;
      *err = std::string("write: ") + strerror(errno);
      return false;
    }
    p += w;
    len -= static_cast<size_t>(w);
  }
  return true;
}

// Serialize (live, dead, ranges) into a run file: tmp + fsync + rename.
bool run_write(Store* s, const std::string& path, const Table live[],
               const Table dead[],
               const std::vector<std::pair<std::string, std::string>> ranges[],
               std::string* err) {
  std::string tmp = path + ".tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) {
    *err = std::string("run tmp open: ") + strerror(errno);
    return false;
  }
  uLong crc = crc32(0L, Z_NULL, 0);
  auto emit = [&](const void* p, size_t n) -> bool {
    crc = crc32(crc, static_cast<const Bytef*>(p), static_cast<uInt>(n));
    return write_all_fd(fd, p, n, err);
  };
  bool ok = write_all_fd(fd, kRunMagic, 4, err);  // magic not in crc
  for (int c = 0; ok && c < kNumCols; ++c) {
    // merged sorted points: live + dead (both std::map -> ordered merge)
    uint32_t n = static_cast<uint32_t>(live[c].size() + dead[c].size());
    ok = ok && emit(&n, 4);
    auto li = live[c].begin();
    auto di = dead[c].begin();
    while (ok && (li != live[c].end() || di != dead[c].end())) {
      bool take_live =
          di == dead[c].end() ||
          (li != live[c].end() && li->first < di->first);
      uint8_t flag = take_live ? kPtLive : kPtTomb;
      const std::string& k = take_live ? li->first : di->first;
      const std::string* v = take_live ? &li->second : nullptr;
      uint32_t klen = static_cast<uint32_t>(k.size());
      uint32_t vlen = v ? static_cast<uint32_t>(v->size()) : 0;
      ok = ok && emit(&flag, 1) && emit(&klen, 4) && emit(k.data(), klen) &&
           emit(&vlen, 4) && (vlen == 0 || emit(v->data(), vlen));
      if (take_live) ++li; else ++di;
    }
    uint32_t nr = static_cast<uint32_t>(ranges[c].size());
    ok = ok && emit(&nr, 4);
    for (size_t i = 0; ok && i < ranges[c].size(); ++i) {
      uint32_t sl = static_cast<uint32_t>(ranges[c][i].first.size());
      uint32_t el = static_cast<uint32_t>(ranges[c][i].second.size());
      ok = ok && emit(&sl, 4) && emit(ranges[c][i].first.data(), sl) &&
           emit(&el, 4) && emit(ranges[c][i].second.data(), el);
    }
  }
  uint32_t trailer = static_cast<uint32_t>(crc);
  ok = ok && write_all_fd(fd, &trailer, 4, err);
  ok = ok && fsync_fd(fd);
  close(fd);
  if (!ok) {
    unlink(tmp.c_str());
    if (err->empty()) *err = "run write failed";
    return false;
  }
  if (rename(tmp.c_str(), path.c_str()) != 0 || !fsync_dir(s->dir)) {
    *err = std::string("run rename: ") + strerror(errno);
    return false;
  }
  return true;
}

// mmap + validate + build the sparse index.
bool run_open(const std::string& path, Run* r, std::string* err) {
  r->path = path;
  r->fd = open(path.c_str(), O_RDONLY);
  if (r->fd < 0) {
    *err = std::string("run open: ") + strerror(errno);
    return false;
  }
  struct stat st;
  if (fstat(r->fd, &st) != 0 || st.st_size < 8) {
    *err = "run stat/short";
    return false;
  }
  r->map_len = static_cast<size_t>(st.st_size);
  r->map = static_cast<uint8_t*>(
      mmap(nullptr, r->map_len, PROT_READ, MAP_SHARED, r->fd, 0));
  if (r->map == MAP_FAILED) {
    *err = std::string("run mmap: ") + strerror(errno);
    return false;
  }
  if (memcmp(r->map, kRunMagic, 4) != 0) {
    *err = "run magic";
    return false;
  }
  size_t body_len = r->map_len - 8;
  uint32_t want = load_u32(r->map + 4 + body_len);
  if (crc32_of(r->map + 4, body_len) != want) {
    *err = "run crc";
    return false;
  }
  size_t off = 4, end = 4 + body_len;
  for (int c = 0; c < kNumCols; ++c) {
    auto need = [&](size_t n) { return off + n <= end; };
    if (!need(4)) { *err = "run truncated"; return false; }
    Run::ColIdx& ci = r->cols[c];
    ci.n_points = load_u32(r->map + off);
    off += 4;
    ci.points_off = off;
    for (uint32_t i = 0; i < ci.n_points; ++i) {
      if (!need(9)) { *err = "run truncated"; return false; }
      size_t e_off = off;
      uint32_t klen = load_u32(r->map + off + 1);
      if (!need(9 + klen)) { *err = "run truncated"; return false; }
      if (i % kIdxStride == 0) {
        ci.sparse.emplace_back(
            std::string(reinterpret_cast<const char*>(r->map + off + 5),
                        klen),
            e_off);
      }
      uint32_t vlen = load_u32(r->map + off + 5 + klen);
      off += 9 + klen + vlen;
      if (off > end) { *err = "run truncated"; return false; }
    }
    ci.points_end = off;
    if (!need(4)) { *err = "run truncated"; return false; }
    uint32_t nr = load_u32(r->map + off);
    off += 4;
    for (uint32_t i = 0; i < nr; ++i) {
      if (!need(4)) { *err = "run truncated"; return false; }
      uint32_t sl = load_u32(r->map + off);
      off += 4;
      if (!need(sl + 4)) { *err = "run truncated"; return false; }
      std::string sk(reinterpret_cast<const char*>(r->map + off), sl);
      off += sl;
      uint32_t el = load_u32(r->map + off);
      off += 4;
      if (!need(el)) { *err = "run truncated"; return false; }
      std::string ek(reinterpret_cast<const char*>(r->map + off), el);
      off += el;
      ci.ranges.emplace_back(std::move(sk), std::move(ek));
    }
  }
  return true;
}

// One point entry at `off`; returns its total size and the fields.
size_t run_point(const Run& r, size_t off, uint8_t* flag,
                 std::string_view* key, std::string_view* val) {
  *flag = r.map[off];
  uint32_t klen = load_u32(r.map + off + 1);
  *key = std::string_view(
      reinterpret_cast<const char*>(r.map + off + 5), klen);
  uint32_t vlen = load_u32(r.map + off + 5 + klen);
  *val = std::string_view(
      reinterpret_cast<const char*>(r.map + off + 9 + klen), vlen);
  return 9 + klen + vlen;
}

bool ranges_cover(const std::vector<std::pair<std::string, std::string>>& rs,
                  std::string_view key) {
  for (const auto& [s, e] : rs) {
    if (key >= s && (e.empty() || key < e)) return true;
  }
  return false;
}

bool manifest_rewrite(Store* s, std::string* err) {
  std::string body;
  for (const auto& r : s->runs) {
    // store basename only (dir may be moved)
    std::string base = r->path.substr(r->path.rfind('/') + 1);
    put_u32(&body, static_cast<uint32_t>(base.size()));
    body += base;
  }
  std::string tmp = s->manifest_path() + ".tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) { *err = "manifest tmp"; return false; }
  bool ok = write_all_fd(fd, body.data(), body.size(), err) && fsync_fd(fd);
  close(fd);
  if (!ok) return false;
  if (rename(tmp.c_str(), s->manifest_path().c_str()) != 0 ||
      !fsync_dir(s->dir)) {
    *err = "manifest rename";
    return false;
  }
  return true;
}

bool manifest_load(Store* s, std::string* err) {
  FILE* f = fopen(s->manifest_path().c_str(), "rb");
  if (!f) return errno == ENOENT ? true : (*err = "manifest open", false);
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(size < 0 ? 0 : size));
  bool rok = buf.empty() ||
             fread(buf.data(), 1, buf.size(), f) == buf.size();
  fclose(f);
  if (!rok) { *err = "manifest read"; return false; }
  size_t off = 0;
  while (off + 4 <= buf.size()) {
    uint32_t sl = load_u32(buf.data() + off);
    off += 4;
    if (off + sl > buf.size()) { *err = "manifest truncated"; return false; }
    std::string name(reinterpret_cast<const char*>(buf.data() + off), sl);
    off += sl;
    auto run = std::make_unique<Run>();
    if (!run_open(s->dir + "/" + name, run.get(), err)) return false;
    // recover next_run_seq from names run_<seq>.sst
    uint32_t seq = static_cast<uint32_t>(
        strtoul(name.c_str() + 4, nullptr, 10));
    run->seq = seq;
    if (seq >= s->next_run_seq) s->next_run_seq = seq + 1;
    s->runs.push_back(std::move(run));
  }
  return true;
}

// -- merged reads (memtable -> runs newest-first) ---------------------------

enum class Hit { kLive, kTomb, kMiss };

Hit mem_lookup(const Store* s, int col, const std::string& key,
               std::string* val) {
  auto it = s->cols[col].find(key);
  if (it != s->cols[col].end()) {
    *val = it->second;
    return Hit::kLive;
  }
  if (s->dead[col].count(key)) return Hit::kTomb;
  if (ranges_cover(s->range_dead[col], key)) return Hit::kTomb;
  return Hit::kMiss;
}

Hit run_lookup(const Run& r, int col, std::string_view key,
               std::string* val) {
  const Run::ColIdx& ci = r.cols[col];
  if (ci.n_points > 0 && !ci.sparse.empty() && key >= ci.sparse[0].first) {
    // last sparse anchor with anchor.key <= key
    size_t lo = 0, hi = ci.sparse.size();
    while (lo + 1 < hi) {
      size_t mid = (lo + hi) / 2;
      if (ci.sparse[mid].first <= key) lo = mid;
      else hi = mid;
    }
    size_t off = ci.sparse[lo].second;
    for (size_t i = 0; i < kIdxStride && off < ci.points_end; ++i) {
      uint8_t flag;
      std::string_view k, v;
      size_t sz = run_point(r, off, &flag, &k, &v);
      if (k == key) {
        if (flag == kPtTomb) return Hit::kTomb;
        val->assign(v.data(), v.size());
        return Hit::kLive;
      }
      if (k > key) break;
      off += sz;
    }
  }
  if (ranges_cover(ci.ranges, key)) return Hit::kTomb;
  return Hit::kMiss;
}

// merged point get; s->mu held.
Hit merged_get(const Store* s, int col, const std::string& key,
               std::string* val) {
  Hit h = mem_lookup(s, col, key, val);
  if (h != Hit::kMiss) return h;
  for (auto it = s->runs.rbegin(); it != s->runs.rend(); ++it) {
    h = run_lookup(**it, col, key, val);
    if (h != Hit::kMiss) return h;
  }
  return Hit::kMiss;
}

// -- merged scan cursors ----------------------------------------------------

struct Cursor {
  // era rank: higher = newer (memtable = INT_MAX)
  int rank = 0;
  bool valid = false;
  std::string_view key;
  std::string_view val;
  uint8_t flag = kPtLive;

  // mem era: forward mode walks [li, le); reverse mode walks (li, le]
  // BACKWARD with le as the exclusive top (current = prev(le))
  const Table* live = nullptr;
  const Table* dead = nullptr;
  Table::const_iterator li, le, di, de;
  std::string mem_key;  // owned copy for mem entries
  // run era
  const Run* run = nullptr;
  int col = 0;
  size_t off = 0, end_off = 0;
  // reverse support
  bool reverse = false;
  const std::vector<uint32_t>* offsets = nullptr;  // full (reverse only)
  size_t rev_i = 0;  // index+1 into offsets

  void load_mem() {
    bool lv, dv;
    if (!reverse) {
      lv = li != le;
      dv = di != de;
    } else {
      lv = le != li;  // non-empty window (li = low bound, le = top)
      dv = de != di;
    }
    if (!lv && !dv) { valid = false; return; }
    bool take_live;
    const std::string* k;
    const std::string* v = nullptr;
    if (!reverse) {
      take_live = lv && (!dv || li->first < di->first);
      k = take_live ? &li->first : &di->first;
      if (take_live) v = &li->second;
    } else {
      auto lp = lv ? std::prev(le) : Table::const_iterator();
      auto dp = dv ? std::prev(de) : Table::const_iterator();
      take_live = lv && (!dv || !(lp->first < dp->first));
      k = take_live ? &lp->first : &dp->first;
      if (take_live) v = &lp->second;
    }
    mem_key = *k;
    key = mem_key;
    if (take_live) { flag = kPtLive; val = *v; }
    else { flag = kPtTomb; val = {}; }
    valid = true;
  }

  void adv_mem() {
    if (!reverse) {
      bool lv = li != le, dv = di != de;
      bool take_live = lv && (!dv || li->first < di->first);
      if (take_live) ++li; else ++di;
    } else {
      bool lv = le != li, dv = de != di;
      auto lp = lv ? std::prev(le) : Table::const_iterator();
      auto dp = dv ? std::prev(de) : Table::const_iterator();
      bool take_live = lv && (!dv || !(lp->first < dp->first));
      if (take_live) --le; else --de;
    }
    load_mem();
  }

  void load_run() {
    if (!reverse) {
      if (off >= end_off) { valid = false; return; }
      run_point(*run, off, &flag, &key, &val);
    } else {
      if (rev_i == 0) { valid = false; return; }
      size_t o = (*offsets)[rev_i - 1];
      run_point(*run, o, &flag, &key, &val);
    }
    valid = true;
  }

  void adv_run() {
    if (!reverse) {
      uint8_t f;
      std::string_view k, v;
      off += run_point(*run, off, &f, &k, &v);
    } else {
      --rev_i;
    }
    load_run();
  }

  void advance() {
    if (live) adv_mem();
    else adv_run();
  }
};

const std::vector<uint32_t>& run_all_offsets(Run& r, int col) {
  Run::ColIdx& ci = r.cols[col];
  if (ci.all_offsets.empty() && ci.n_points > 0) {
    ci.all_offsets.reserve(ci.n_points);
    size_t off = ci.points_off;
    for (uint32_t i = 0; i < ci.n_points && off < ci.points_end; ++i) {
      ci.all_offsets.push_back(static_cast<uint32_t>(off));
      uint8_t f;
      std::string_view k, v;
      off += run_point(r, off, &f, &k, &v);
    }
  }
  return ci.all_offsets;
}

// Position a run cursor at the first point >= start (forward) or last
// point < end-bound (reverse uses all_offsets).
void run_seek(Run& r, int col, Cursor* c, std::string_view start,
              std::string_view end, bool reverse) {
  Run::ColIdx& ci = r.cols[col];
  c->run = &r;
  c->col = col;
  c->reverse = reverse;
  if (!reverse) {
    size_t off = ci.points_off;
    if (!start.empty() && !ci.sparse.empty() && start > ci.sparse[0].first) {
      size_t lo = 0, hi = ci.sparse.size();
      while (lo + 1 < hi) {
        size_t mid = (lo + hi) / 2;
        if (ci.sparse[mid].first <= start) lo = mid;
        else hi = mid;
      }
      off = ci.sparse[lo].second;
    }
    // linear skip to >= start
    while (off < ci.points_end) {
      uint8_t f;
      std::string_view k, v;
      size_t sz = run_point(r, off, &f, &k, &v);
      if (start.empty() || k >= start) break;
      off += sz;
    }
    c->off = off;
    c->end_off = ci.points_end;
    c->load_run();
    // clamp at end bound during merge (caller checks)
  } else {
    const auto& offs = run_all_offsets(r, col);
    // rev_i = count of points with key < end (end empty = all)
    size_t lo = 0, hi = offs.size();
    if (!end.empty()) {
      while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        uint8_t f;
        std::string_view k, v;
        run_point(r, offs[mid], &f, &k, &v);
        if (k < end) lo = mid + 1;
        else hi = mid;
      }
      c->rev_i = lo;
    } else {
      c->rev_i = offs.size();
    }
    c->offsets = &offs;
    c->load_run();
  }
}

// The merged scan over memtable + runs with tombstone masking.
// emit(key, val) returns false to stop (limit reached).
template <typename Emit>
void merged_scan(Store* s, int col, const std::string& start,
                 const std::string& end, bool reverse, Emit emit) {
  std::vector<std::unique_ptr<Cursor>> curs;
  {  // memtable cursor (rank = runs.size())
    auto c = std::make_unique<Cursor>();
    c->rank = static_cast<int>(s->runs.size());
    c->live = &s->cols[col];
    c->dead = &s->dead[col];
    c->reverse = reverse;
    const Table& lv = s->cols[col];
    const Table& dd = s->dead[col];
    if (!reverse) {
      c->li = start.empty() ? lv.begin() : lv.lower_bound(start);
      c->le = lv.end();
      c->di = start.empty() ? dd.begin() : dd.lower_bound(start);
      c->de = dd.end();
    } else {
      // backward walk of [lower_bound(start), lower_bound(end)):
      // li/di = low bounds, le/de = exclusive tops (current = prev(top))
      c->li = start.empty() ? lv.begin() : lv.lower_bound(start);
      c->le = end.empty() ? lv.end() : lv.lower_bound(end);
      c->di = start.empty() ? dd.begin() : dd.lower_bound(start);
      c->de = end.empty() ? dd.end() : dd.lower_bound(end);
    }
    c->load_mem();
    curs.push_back(std::move(c));
  }
  for (size_t i = 0; i < s->runs.size(); ++i) {
    auto c = std::make_unique<Cursor>();
    c->rank = static_cast<int>(i);
    run_seek(*s->runs[i], col, c.get(), start, end, reverse);
    curs.push_back(std::move(c));
  }
  auto newer_masks = [&](int rank, std::string_view key) -> bool {
    // ranges of strictly newer eras mask `key`
    if (rank < static_cast<int>(s->runs.size()) &&
        ranges_cover(s->range_dead[col], key))
      return true;
    for (size_t i = static_cast<size_t>(rank) + 1; i < s->runs.size(); ++i) {
      if (ranges_cover(s->runs[i]->cols[col].ranges, key)) return true;
    }
    return false;
  };
  while (true) {
    // pick the smallest (forward) / largest (reverse) key among cursors
    Cursor* best = nullptr;
    for (auto& c : curs) {
      if (!c->valid) continue;
      // bound checks
      if (!reverse) {
        if (!end.empty() && c->key >= end) { c->valid = false; continue; }
      } else {
        if (!start.empty() && c->key < start) { c->valid = false; continue; }
      }
      if (best == nullptr) { best = c.get(); continue; }
      if (!reverse) {
        if (c->key < best->key ||
            (c->key == best->key && c->rank > best->rank))
          best = c.get();
      } else {
        if (c->key > best->key ||
            (c->key == best->key && c->rank > best->rank))
          best = c.get();
      }
    }
    if (best == nullptr) return;
    std::string cur_key(best->key);
    bool visible = best->flag == kPtLive && !newer_masks(best->rank, cur_key);
    if (visible) {
      if (!emit(cur_key, best->val)) return;
    }
    // advance every cursor standing at cur_key
    for (auto& c : curs) {
      while (c->valid && c->key == cur_key) c->advance();
    }
  }
}

// -- LSM spill & compaction -------------------------------------------------

bool wal_restart(Store* s, std::string* err) {
  if (ftruncate(s->wal_fd, 0) != 0 || lseek(s->wal_fd, 0, SEEK_SET) < 0 ||
      (s->sync && !fsync_fd(s->wal_fd))) {
    *err = std::string("wal restart: ") + strerror(errno);
    return false;
  }
  s->wal_bytes = 0;
  return true;
}

// Spill the memtable (live + tombstones + ranges) to a new run; s->mu held.
bool spill(Store* s, std::string* err) {
  char name[32];
  snprintf(name, sizeof(name), "run_%08u.sst", s->next_run_seq);
  std::string path = s->dir + "/" + name;
  if (!run_write(s, path, s->cols, s->dead, s->range_dead, err)) return false;
  auto run = std::make_unique<Run>();
  run->seq = s->next_run_seq;
  if (!run_open(path, run.get(), err)) return false;
  s->next_run_seq++;
  s->runs.push_back(std::move(run));
  if (!manifest_rewrite(s, err)) return false;
  for (int c = 0; c < kNumCols; ++c) {
    s->cols[c].clear();
    s->dead[c].clear();
    s->range_dead[c].clear();
  }
  s->mem_bytes = 0;
  // Durable-op order matters: the legacy checkpoint must be durably gone
  // BEFORE the WAL is truncated.  If we truncated first and crashed before
  // the unlink hit disk, reopen would ckpt_load the stale checkpoint into
  // the memtable (newest rank), shadowing newer values in the runs.  With
  // this order every crash window is consistent: ckpt+full-WAL replay
  // reproduces exactly the content just spilled to the run.
  if (unlink(s->ckpt_path().c_str()) == 0) {
    if (!fsync_dir(s->dir)) {
      *err = "spill: fsync dir after ckpt unlink";
      return false;
    }
  } else if (errno != ENOENT) {
    // an unremovable stale checkpoint would shadow the runs on reopen;
    // failing the spill keeps WAL + checkpoint consistent instead
    *err = std::string("spill: ckpt unlink: ") + strerror(errno);
    return false;
  }
  // memtable content is durable in the run: restart the WAL
  if (!wal_restart(s, err)) return false;
  s->compact_cv.notify_all();
  return true;
}

// Merge a CONTIGUOUS window of runs (oldest..newest within the window)
// into one run file.  `bottom` means the window starts at the store's
// oldest run: only then may tombstones (point + range) be dropped —
// anywhere else they must survive to keep masking runs below the
// window.  Runs are immutable and only the compactor removes them, so
// this reads without the mutex.
bool merge_runs_to_file(Store* s, const std::vector<Run*>& inputs,
                        const std::string& path, std::string* err,
                        bool bottom) {
  std::string tmp = path + ".tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) { *err = "merge tmp open"; return false; }
  uLong crc = crc32(0L, Z_NULL, 0);
  bool ok = write_all_fd(fd, kRunMagic, 4, err);
  auto emit = [&](const void* p, size_t n) -> bool {
    crc = crc32(crc, static_cast<const Bytef*>(p), static_cast<uInt>(n));
    return write_all_fd(fd, p, n, err);
  };
  for (int c = 0; ok && c < kNumCols; ++c) {
    // two passes (count, then entries) — run files are modest and
    // mmap'd, so the double walk is cheap relative to the write
    for (int pass = 0; ok && pass < 2; ++pass) {
      uint32_t count = 0;
      std::vector<Cursor> curs(inputs.size());
      for (size_t i = 0; i < inputs.size(); ++i) {
        curs[i].rank = static_cast<int>(i);
        run_seek(*inputs[i], c, &curs[i], {}, {}, false);
      }
      auto newer_masks = [&](int rank, std::string_view key) {
        for (size_t i = static_cast<size_t>(rank) + 1; i < inputs.size();
             ++i) {
          if (ranges_cover(inputs[i]->cols[c].ranges, key)) return true;
        }
        return false;
      };
      while (ok) {
        Cursor* best = nullptr;
        for (auto& cu : curs) {
          if (!cu.valid) continue;
          if (best == nullptr || cu.key < best->key ||
              (cu.key == best->key && cu.rank > best->rank))
            best = &cu;
        }
        if (best == nullptr) break;
        std::string cur_key(best->key);
        // non-bottom merges keep the newest version even when it is a
        // tombstone: it still masks data in runs below the window
        bool keep = !newer_masks(best->rank, cur_key) &&
                    (best->flag == kPtLive || !bottom);
        if (keep) {
          if (pass == 0) {
            ++count;
          } else {
            uint8_t flag = best->flag;
            uint32_t klen = static_cast<uint32_t>(cur_key.size());
            uint32_t vlen = static_cast<uint32_t>(best->val.size());
            ok = emit(&flag, 1) && emit(&klen, 4) &&
                 emit(cur_key.data(), klen) && emit(&vlen, 4) &&
                 (vlen == 0 || emit(best->val.data(), vlen));
          }
        }
        for (auto& cu : curs) {
          while (cu.valid && cu.key == cur_key) cu.advance();
        }
      }
      if (pass == 0 && ok) ok = emit(&count, 4);
    }
    if (bottom) {
      uint32_t nr = 0;  // bottom merge: nothing older left to mask
      ok = ok && emit(&nr, 4);
    } else {
      // union of the window's range tombstones: after the merge they
      // mask exactly the runs below the window, as each input's did
      uint32_t nr = 0;
      for (const Run* r : inputs)
        nr += static_cast<uint32_t>(r->cols[c].ranges.size());
      ok = ok && emit(&nr, 4);
      for (const Run* r : inputs) {
        for (const auto& [rs, re] : r->cols[c].ranges) {
          uint32_t sl = static_cast<uint32_t>(rs.size());
          uint32_t el = static_cast<uint32_t>(re.size());
          ok = ok && emit(&sl, 4) && emit(rs.data(), sl) &&
               emit(&el, 4) && emit(re.data(), el);
          if (!ok) break;
        }
        if (!ok) break;
      }
    }
  }
  uint32_t trailer = static_cast<uint32_t>(crc);
  ok = ok && write_all_fd(fd, &trailer, 4, err);
  ok = ok && fsync_fd(fd);
  close(fd);
  if (!ok) { unlink(tmp.c_str()); return false; }
  if (rename(tmp.c_str(), path.c_str()) != 0 || !fsync_dir(s->dir)) {
    *err = "merge rename";
    return false;
  }
  return true;
}

void compactor_main(Store* s) {
  std::unique_lock<std::mutex> lk(s->mu);
  while (!s->stopping) {
    if (static_cast<int64_t>(s->runs.size()) <= s->max_runs) {
      s->compact_cv.wait(lk);
      continue;
    }
    // Size-tiered pick-K (VERDICT r2 #7): merge the cheapest CONTIGUOUS
    // window of K runs (contiguity preserves rank order — newer masks
    // older) instead of merge-all, so compaction I/O per cycle tracks
    // the small spill tier, not total store size.  K restores the run
    // count to max_runs; min-total-bytes picks the fresh small spills
    // over the big bottom run until tiers grow comparable.
    size_t n = s->runs.size();
    size_t k = n - static_cast<size_t>(s->max_runs) + 1;
    size_t win = 0;
    int64_t best_bytes = -1;
    for (size_t i = 0; i + k <= n; ++i) {
      int64_t b = 0;
      for (size_t j = i; j < i + k; ++j)
        b += static_cast<int64_t>(s->runs[j]->map_len);
      if (best_bytes < 0 || b < best_bytes) {
        best_bytes = b;
        win = i;
      }
    }
    bool bottom = win == 0;  // only a bottom merge may drop tombstones
    std::vector<Run*> inputs;
    for (size_t j = win; j < win + k; ++j)
      inputs.push_back(s->runs[j].get());
    uint32_t seq = s->next_run_seq++;
    s->compact_running = true;
    lk.unlock();
    char name[32];
    snprintf(name, sizeof(name), "run_%08u.sst", seq);
    std::string path = s->dir + "/" + name;
    std::string err;
    auto merged = std::make_unique<Run>();
    bool ok = merge_runs_to_file(s, inputs, path, &err, bottom) &&
              run_open(path, merged.get(), &err);
    merged->seq = seq;
    lk.lock();
    s->compact_running = false;
    if (!ok) {
      fprintf(stderr, "tpuraft-kvstore: compaction failed: %s\n",
              err.c_str());
      unlink(path.c_str());
      // back off until the next spill wakes us; bounded wait so a
      // stopping flag set while we merged can't strand tkv_close
      // (the notify may have fired before this wait began)
      if (!s->stopping) s->compact_cv.wait_for(lk, std::chrono::seconds(1));
      continue;
    }
    s->compactions++;
    s->compact_input_bytes += best_bytes;
    s->compact_last_input_bytes = best_bytes;
    // swap the window for the merged run; spills during the merge only
    // APPENDED (newer), so indexes [win, win+k) are still the inputs
    std::vector<std::string> old_paths;
    for (size_t j = win; j < win + k; ++j)
      old_paths.push_back(s->runs[j]->path);
    s->runs.erase(s->runs.begin() + win, s->runs.begin() + win + k);
    s->runs.insert(s->runs.begin() + win, std::move(merged));
    if (!manifest_rewrite(s, &err)) {
      // KEEP the old files: the durable manifest still references
      // them, and deleting would make the store unopenable after a
      // crash.  They leak until the next successful rewrite (any
      // spill), which then lists the merged run instead.
      fprintf(stderr, "tpuraft-kvstore: manifest rewrite failed (%s); "
              "retaining pre-compaction run files\n", err.c_str());
    } else {
      for (const auto& p : old_paths) unlink(p.c_str());
    }
  }
}

// -- WAL --------------------------------------------------------------------

bool wal_append(Store* s, const uint8_t* payload, size_t n, std::string* err) {
  std::string rec;
  rec.reserve(8 + n);
  put_u32(&rec, static_cast<uint32_t>(n));
  put_u32(&rec, crc32_of(payload, n));
  rec.append(reinterpret_cast<const char*>(payload), n);
  const char* p = rec.data();
  size_t left = rec.size();
  while (left > 0) {
    ssize_t w = write(s->wal_fd, p, left);
    if (w < 0) {
      if (errno == EINTR) continue;
      *err = std::string("wal write: ") + strerror(errno);
      return false;
    }
    p += w;
    left -= static_cast<size_t>(w);
  }
  if (s->sync && !fsync_fd(s->wal_fd)) {
    *err = std::string("wal fsync: ") + strerror(errno);
    return false;
  }
  s->wal_bytes += static_cast<int64_t>(rec.size());
  return true;
}

// Replays wal.log over the tables; stops cleanly at a torn tail.
bool wal_replay(Store* s, std::string* err) {
  FILE* f = fopen(s->wal_path().c_str(), "rb");
  if (!f) {
    if (errno == ENOENT) return true;
    *err = std::string("wal open: ") + strerror(errno);
    return false;
  }
  fseek(f, 0, SEEK_END);
  int64_t file_size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (file_size < 0) {
    // can't size the file: a bookkeeping failure must not become data
    // loss via the truncate below
    fclose(f);
    *err = std::string("wal size probe: ") + strerror(errno);
    return false;
  }
  std::vector<uint8_t> buf;
  int64_t valid_end = 0;
  for (;;) {
    uint8_t hdr[8];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t len = load_u32(hdr), crc = load_u32(hdr + 4);
    // The header is not self-checksummed: clamp the length field against
    // the bytes actually present so a corrupted tail can't trigger a
    // giant allocation — anything oversized is by definition torn.
    if (static_cast<int64_t>(len) > file_size - valid_end - 8) break;
    buf.resize(len);
    if (len > 0 && fread(buf.data(), 1, len, f) != len) break;
    if (crc32_of(buf.data(), len) != crc) break;
    std::vector<std::tuple<uint8_t, uint8_t, std::string, std::string>> ops;
    if (!parse_ops(buf.data(), len, &ops)) break;
    apply_ops(s, ops);
    valid_end += 8 + static_cast<int64_t>(len);
  }
  fclose(f);
  // drop the torn tail so future appends never sit after garbage
  if (truncate(s->wal_path().c_str(), valid_end) != 0 && errno != ENOENT) {
    *err = std::string("wal truncate: ") + strerror(errno);
    return false;
  }
  s->wal_bytes = valid_end;
  return true;
}

// -- checkpoint -------------------------------------------------------------

bool ckpt_load(Store* s, std::string* err) {
  FILE* f = fopen(s->ckpt_path().c_str(), "rb");
  if (!f) {
    if (errno == ENOENT) return true;
    *err = std::string("checkpoint open: ") + strerror(errno);
    return false;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 8) {
    fclose(f);
    *err = "checkpoint too short";
    return false;
  }
  std::vector<uint8_t> blob(static_cast<size_t>(size));
  bool read_ok = fread(blob.data(), 1, blob.size(), f) == blob.size();
  fclose(f);
  if (!read_ok || memcmp(blob.data(), kCkptMagic, 4) != 0) {
    *err = "checkpoint magic/read failure";
    return false;
  }
  size_t body_len = blob.size() - 8;
  uint32_t want = load_u32(blob.data() + 4 + body_len);
  if (crc32_of(blob.data() + 4, body_len) != want) {
    *err = "checkpoint crc mismatch";
    return false;
  }
  size_t off = 4;
  for (int c = 0; c < kNumCols; ++c) {
    if (off + 4 > 4 + body_len) { *err = "checkpoint truncated"; return false; }
    uint32_t count = load_u32(blob.data() + off);
    off += 4;
    auto hint = s->cols[c].end();
    for (uint32_t i = 0; i < count; ++i) {
      if (off + 4 > 4 + body_len) { *err = "checkpoint truncated"; return false; }
      uint32_t klen = load_u32(blob.data() + off);
      off += 4;
      if (off + klen + 4 > 4 + body_len) { *err = "checkpoint truncated"; return false; }
      std::string key(reinterpret_cast<const char*>(blob.data() + off), klen);
      off += klen;
      uint32_t vlen = load_u32(blob.data() + off);
      off += 4;
      if (off + vlen > 4 + body_len) { *err = "checkpoint truncated"; return false; }
      std::string val(reinterpret_cast<const char*>(blob.data() + off), vlen);
      off += vlen;
      // checkpoint is written in order: amortized O(1) insertion at end
      hint = s->cols[c].emplace_hint(hint, std::move(key), std::move(val));
    }
  }
  return true;
}

bool ckpt_write(Store* s, std::string* err) {
  std::string body;
  for (int c = 0; c < kNumCols; ++c) {
    put_u32(&body, static_cast<uint32_t>(s->cols[c].size()));
    for (const auto& [k, v] : s->cols[c]) {
      put_u32(&body, static_cast<uint32_t>(k.size()));
      body += k;
      put_u32(&body, static_cast<uint32_t>(v.size()));
      body += v;
    }
  }
  std::string tmp = s->ckpt_path() + ".tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) {
    *err = std::string("checkpoint tmp open: ") + strerror(errno);
    return false;
  }
  // Stream magic, body, CRC trailer — no concatenated second copy of the
  // dataset while the store mutex is held.
  char trailer[4];
  uint32_t crc = crc32_of(body.data(), body.size());
  memcpy(trailer, &crc, 4);  // native-endian, matching load_u32
  const std::pair<const char*, size_t> parts[] = {
      {kCkptMagic, 4}, {body.data(), body.size()}, {trailer, 4}};
  bool ok = true;
  for (const auto& [p0, n0] : parts) {
    const char* p = p0;
    size_t left = n0;
    while (ok && left > 0) {
      ssize_t w = write(fd, p, left);
      if (w < 0) {
        if (errno == EINTR) continue;
        ok = false;
        break;
      }
      p += w;
      left -= static_cast<size_t>(w);
    }
    if (!ok) break;
  }
  ok = ok && fsync_fd(fd);
  close(fd);
  if (!ok) {
    *err = std::string("checkpoint write: ") + strerror(errno);
    unlink(tmp.c_str());
    return false;
  }
  if (rename(tmp.c_str(), s->ckpt_path().c_str()) != 0 ||
      !fsync_dir(s->dir)) {
    *err = std::string("checkpoint rename: ") + strerror(errno);
    return false;
  }
  // the checkpoint now covers everything: restart the WAL
  if (ftruncate(s->wal_fd, 0) != 0 ||
      lseek(s->wal_fd, 0, SEEK_SET) < 0 ||
      (s->sync && !fsync_fd(s->wal_fd))) {
    *err = std::string("wal restart: ") + strerror(errno);
    return false;
  }
  s->wal_bytes = 0;
  s->ckpt_retry_floor = 0;  // any successful checkpoint clears the backoff
  return true;
}

// Auto-checkpoint if the WAL has grown past the threshold.  A checkpoint
// failure is NOT a write failure: by this point the op is fsynced in the
// WAL and applied, so it must be reported durable.  Replay is idempotent
// (put/delete/delete-range), so even a rename-then-truncate-failed half
// checkpoint recovers correctly.  On failure, back off: don't retry the
// full O(n) serialization until the WAL grows by another threshold.
void maybe_ckpt(Store* s) {
  if (s->ckpt_wal_bytes <= 0 || s->wal_bytes < s->ckpt_wal_bytes) return;
  if (s->wal_bytes < s->ckpt_retry_floor) return;
  std::string cerr;
  if (!ckpt_write(s, &cerr)) {
    s->ckpt_retry_floor = s->wal_bytes + s->ckpt_wal_bytes;
    fprintf(stderr, "tpuraft-kvstore: auto-checkpoint failed (%s); "
            "will retry after %lld more WAL bytes\n",
            cerr.c_str(), static_cast<long long>(s->ckpt_wal_bytes));
  } else {
    s->ckpt_retry_floor = 0;
  }
}

// One durable write: WAL first, then tables, then maybe spill/checkpoint.
bool do_write(Store* s, const uint8_t* payload, size_t n, std::string* err) {
  std::vector<std::tuple<uint8_t, uint8_t, std::string, std::string>> ops;
  if (!parse_ops(payload, n, &ops)) {
    *err = "malformed op stream";
    return false;
  }
  if (!wal_append(s, payload, n, err)) return false;
  apply_ops(s, ops);
  if (s->lsm()) {
    if (s->mem_bytes >= s->memtable_budget) {
      std::string serr;
      if (!spill(s, &serr)) {
        // like a failed auto-checkpoint: the op IS durable (WAL),
        // report success and retry the spill on later writes
        fprintf(stderr, "tpuraft-kvstore: spill failed (%s); retrying "
                "on later writes\n", serr.c_str());
      }
    }
  } else {
    maybe_ckpt(s);
  }
  return true;
}

uint8_t* copy_out(const std::string& data) {
  uint8_t* out = static_cast<uint8_t*>(malloc(data.size() ? data.size() : 1));
  if (out) memcpy(out, data.data(), data.size());
  return out;
}

}  // namespace

extern "C" {

// LSM-capable open (VERDICT r1 #7): memtable_budget_bytes > 0 enables
// sorted-run spill + background compaction; 0 keeps the legacy
// memtable+checkpoint engine bit-for-bit.
void* tkv_open2(const char* dir, int sync, int64_t ckpt_wal_bytes,
                int64_t memtable_budget_bytes, int64_t max_runs,
                char* err, int errlen) {
  auto s = std::make_unique<Store>();
  s->dir = dir;
  s->sync = sync != 0;
  if (ckpt_wal_bytes > 0) s->ckpt_wal_bytes = ckpt_wal_bytes;
  if (memtable_budget_bytes > 0) s->memtable_budget = memtable_budget_bytes;
  if (max_runs > 1) s->max_runs = max_runs;
  if (mkdir(dir, 0755) != 0 && errno != EEXIST) {
    set_err(err, errlen, std::string("mkdir: ") + strerror(errno));
    return nullptr;
  }
  std::string msg;
  if (!s->lsm()) {
    // Guard against opening an LSM-tiered directory without LSM params
    // (legacy tkv_open or a config downgrade): the manifest's runs would
    // be silently invisible — reads miss most of the dataset and the next
    // checkpoint durably excludes it.  Fail loudly instead.
    struct stat st;
    if (stat(s->manifest_path().c_str(), &st) == 0) {
      set_err(err, errlen,
              "LSM directory (manifest present) opened without LSM params; "
              "reopen with memtable_budget_bytes > 0 (tkv_open2)");
      return nullptr;
    }
  }
  if (s->lsm() && !manifest_load(s.get(), &msg)) {
    set_err(err, errlen, msg);
    return nullptr;
  }
  // legacy checkpoint (pre-LSM dirs / mode downgrade): becomes the
  // initial memtable; the next spill converts it to a run
  if (!ckpt_load(s.get(), &msg) || !wal_replay(s.get(), &msg)) {
    set_err(err, errlen, msg);
    return nullptr;
  }
  if (s->lsm()) {
    // full recount: wal_replay's apply_ops already accounted its part,
    // so summing on top would double-count and trigger premature spills
    s->mem_bytes = 0;
    for (int c = 0; c < kNumCols; ++c) {
      for (const auto& [k, v] : s->cols[c])
        s->mem_bytes += static_cast<int64_t>(k.size() + v.size());
      for (const auto& [k, v] : s->dead[c])
        s->mem_bytes += static_cast<int64_t>(k.size());
      for (const auto& [a, b] : s->range_dead[c])
        s->mem_bytes += static_cast<int64_t>(a.size() + b.size());
    }
  }
  s->wal_fd = open(s->wal_path().c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (s->wal_fd < 0) {
    set_err(err, errlen, std::string("wal open: ") + strerror(errno));
    return nullptr;
  }
  if (s->lsm()) {
    Store* sp = s.get();
    s->compactor = std::thread([sp] { compactor_main(sp); });
  }
  return s.release();
}

void* tkv_open(const char* dir, int sync, int64_t ckpt_wal_bytes,
               char* err, int errlen) {
  return tkv_open2(dir, sync, ckpt_wal_bytes, 0, 0, err, errlen);
}

void tkv_close(void* h) {
  auto* s = static_cast<Store*>(h);
  if (!s) return;
  if (s->compactor.joinable()) {
    {
      std::lock_guard<std::mutex> g(s->mu);
      s->stopping = true;
    }
    s->compact_cv.notify_all();
    s->compactor.join();
  }
  if (s->wal_fd >= 0) close(s->wal_fd);
  delete s;
}

int64_t tkv_run_count(void* h) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  return static_cast<int64_t>(s->runs.size());
}

int64_t tkv_mem_bytes(void* h) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  return s->mem_bytes;
}

int64_t tkv_compactions(void* h) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  return s->compactions;
}

int64_t tkv_compact_input_bytes(void* h) {
  // cumulative input bytes across all compaction cycles (write
  // amplification accounting)
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  return s->compact_input_bytes;
}

int64_t tkv_compact_last_input_bytes(void* h) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  return s->compact_last_input_bytes;
}

int64_t tkv_data_bytes(void* h) {
  // total bytes across run files (the on-disk LSM footprint)
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  int64_t total = 0;
  for (const auto& r : s->runs) total += static_cast<int64_t>(r->map_len);
  return total;
}

void tkv_free(uint8_t* p) { free(p); }

int tkv_apply_batch(void* h, const uint8_t* ops, int64_t len,
                    char* err, int errlen) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  std::string msg;
  if (!do_write(s, ops, static_cast<size_t>(len), &msg)) {
    set_err(err, errlen, msg);
    return -1;
  }
  return 0;
}

int64_t tkv_get(void* h, int col, const uint8_t* k, int64_t kl,
                uint8_t** out) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  if (col < 0 || col >= kNumCols) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  std::string key(reinterpret_cast<const char*>(k), kl);
  std::string val;
  if (merged_get(s, col, key, &val) != Hit::kLive) return -1;
  *out = copy_out(val);
  return static_cast<int64_t>(val.size());
}

// Packed result: u32 count | repeated (u32 klen key [u32 vlen val]).
// with_values=0 omits values. reverse=1 returns descending order.
// limit<0 means unbounded.
int64_t tkv_scan(void* h, int col, const uint8_t* start, int64_t sl,
                 const uint8_t* end, int64_t el, int64_t limit,
                 int with_values, int reverse, uint8_t** out) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  if (col < 0 || col >= kNumCols) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  std::string skey(reinterpret_cast<const char*>(start), sl);
  std::string ekey(reinterpret_cast<const char*>(end), el);
  std::string body;
  uint32_t count = 0;
  merged_scan(s, col, skey, ekey, reverse != 0,
              [&](const std::string& k, std::string_view v) {
    if (limit >= 0 && count >= static_cast<uint64_t>(limit)) return false;
    put_u32(&body, static_cast<uint32_t>(k.size()));
    body += k;
    if (with_values) {
      put_u32(&body, static_cast<uint32_t>(v.size()));
      body.append(v.data(), v.size());
    }
    ++count;
    return true;
  });
  std::string packed;
  packed.reserve(4 + body.size());
  put_u32(&packed, count);
  packed += body;
  *out = copy_out(packed);
  return static_cast<int64_t>(packed.size());
}

int64_t tkv_count_range(void* h, int col, const uint8_t* start, int64_t sl,
                        const uint8_t* end, int64_t el) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  if (col < 0 || col >= kNumCols) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  std::string skey(reinterpret_cast<const char*>(start), sl);
  std::string ekey(reinterpret_cast<const char*>(end), el);
  if (!s->lsm()) {
    Table& t = s->cols[col];
    auto lo = skey.empty() ? t.begin() : t.lower_bound(skey);
    auto hi = ekey.empty() ? t.end() : t.lower_bound(ekey);
    return static_cast<int64_t>(std::distance(lo, hi));
  }
  int64_t n = 0;
  merged_scan(s, col, skey, ekey, false,
              [&](const std::string&, std::string_view) {
    ++n;
    return true;
  });
  return n;
}

int tkv_checkpoint(void* h, char* err, int errlen) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  std::string msg;
  // LSM mode: "checkpoint" = flush the memtable to a run (WAL resets
  // either way; recovery stays O(memtable))
  bool ok = s->lsm() ? spill(s, &msg) : ckpt_write(s, &msg);
  if (!ok) {
    set_err(err, errlen, msg);
    return -1;
  }
  return 0;
}

int64_t tkv_wal_bytes(void* h) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  return s->wal_bytes;
}

int64_t tkv_count(void* h, int col) {
  auto* s = static_cast<Store*>(h);
  if (!s) return -1;
  if (col < 0 || col >= kNumCols) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  if (!s->lsm()) return static_cast<int64_t>(s->cols[col].size());
  int64_t n = 0;  // LSM: merged live count (O(dataset) walk — stats use)
  merged_scan(s, col, std::string(), std::string(), false,
              [&](const std::string&, std::string_view) {
    ++n;
    return true;
  });
  return n;
}

}  // extern "C"
