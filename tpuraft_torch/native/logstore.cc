// tpuraft native log storage engine.
//
// Reference parity: the role RocksDB (C++, via rocksdbjni) plays under
// core:storage/impl/RocksDBLogStorage — the durable raft log engine behind
// the Python LogStorage SPI (SURVEY.md §3.4 "Native / non-Java components").
// Where the reference keys a general-purpose LSM by 8-byte big-endian index,
// this engine is purpose-built for raft's access pattern: append-mostly,
// contiguous reads, prefix truncation at snapshot, suffix truncation on
// conflict.
//
// On-disk format — IDENTICAL to tpuraft/storage/log_storage.py FileLogStorage
// (the two engines are interchangeable on the same directory):
//   seg_<first_index>.log : repeated [ u32le frame_len | entry blob ]
//   meta                  : i64le first_log_index (atomic tmp+rename)
//   conf.idx              : packed i64le indexes of CONFIGURATION entries
// Entry blob layout (tpuraft/entity.py _HDR "<BBHqqHHII"):
//   magic(1)=0xB8 type(1) rsv(2) term(8) index(8) npeers(2) nold(2)
//   data_len(4) crc32(4) | peers_blob | data
//   crc32 = zlib crc over data first, then peers_blob.
//
// Exposed as a C ABI for ctypes (tpuraft/storage/native_log.py).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <fcntl.h>
#include <memory>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>
#include <zlib.h>

namespace {

constexpr uint8_t kMagic = 0xB8;
constexpr uint8_t kTypeConfiguration = 2;
constexpr size_t kHdrSize = 32;
constexpr size_t kFrameSize = 4;  // u32 length prefix

// -- little-endian unaligned loads (format is LE; TPU hosts are LE) ---------

uint16_t load_u16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
uint32_t load_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
int64_t load_i64(const uint8_t* p) { int64_t v; memcpy(&v, p, 8); return v; }

struct EntryHeader {
  uint8_t type;
  int64_t term;
  int64_t index;
  uint16_t peers_len;
  uint32_t data_len;
  uint32_t crc;
};

// Parses + validates one entry blob. Returns false on any corruption.
bool parse_entry(const uint8_t* blob, size_t len, EntryHeader* out,
                 bool verify_crc) {
  if (len < kHdrSize) return false;
  if (blob[0] != kMagic) return false;
  out->type = blob[1];
  out->term = load_i64(blob + 4);
  out->index = load_i64(blob + 12);
  out->peers_len = load_u16(blob + 20);
  out->data_len = load_u32(blob + 24);
  out->crc = load_u32(blob + 28);
  if (kHdrSize + out->peers_len + (size_t)out->data_len != len) return false;
  if (verify_crc) {
    const uint8_t* peers = blob + kHdrSize;
    const uint8_t* data = peers + out->peers_len;
    uLong c = crc32(0L, Z_NULL, 0);
    c = crc32(c, data, out->data_len);
    c = crc32(c, peers, out->peers_len);
    if ((uint32_t)c != out->crc) return false;
  }
  return true;
}

bool fsync_fd(int fd) { return ::fsync(fd) == 0; }

bool fsync_dir(const std::string& dir) {
  int fd = ::open(dir.c_str(), O_RDONLY);
  if (fd < 0) return false;
  bool ok = fsync_fd(fd);
  ::close(fd);
  return ok;
}

bool write_all(int fd, const uint8_t* buf, size_t len) {
  while (len > 0) {
    ssize_t n = ::write(fd, buf, len);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    buf += n;
    len -= (size_t)n;
  }
  return true;
}

// Atomic small-file write: tmp + fsync + rename + dir fsync.
bool atomic_write_file(const std::string& dir, const std::string& name,
                       const uint8_t* buf, size_t len) {
  std::string tmp = dir + "/" + name + ".tmp";
  std::string dst = dir + "/" + name;
  int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return false;
  bool ok = write_all(fd, buf, len) && fsync_fd(fd);
  ::close(fd);
  if (!ok) return false;
  if (::rename(tmp.c_str(), dst.c_str()) != 0) return false;
  return fsync_dir(dir);
}

// -- one append-only segment file with an in-memory offset index ------------

struct Segment {
  std::string path;
  int64_t first_index = 0;
  std::vector<int64_t> offsets;  // offsets[i] = file offset of first_index+i
  int64_t size = 0;
  int fd = -1;

  int64_t last_index() const {
    return first_index + (int64_t)offsets.size() - 1;
  }

  bool open_file(bool create) {
    fd = ::open(path.c_str(), O_RDWR | (create ? O_CREAT : 0), 0644);
    return fd >= 0;
  }

  // Rebuild the offset index; truncate a torn tail write if found.
  bool scan() {
    struct stat st;
    if (::fstat(fd, &st) != 0) return false;
    int64_t end = st.st_size;
    std::vector<uint8_t> buf((size_t)end);
    if (end > 0) {
      ssize_t n = ::pread(fd, buf.data(), (size_t)end, 0);
      if (n != end) return false;
    }
    int64_t off = 0, good_end = 0;
    while (off + (int64_t)kFrameSize <= end) {
      uint32_t flen = load_u32(buf.data() + off);
      if (off + (int64_t)kFrameSize + flen > end) break;  // torn write
      EntryHeader h;
      if (!parse_entry(buf.data() + off + kFrameSize, flen, &h, true)) break;
      offsets.push_back(off);
      off += (int64_t)kFrameSize + flen;
      good_end = off;
    }
    if (good_end < end) {
      if (::ftruncate(fd, good_end) != 0) return false;
    }
    size = good_end;
    return true;
  }

  // Returns the framed blob length at `index`, copied into out (malloc'd).
  int64_t read_entry(int64_t index, uint8_t** out) const {
    int64_t off = offsets[(size_t)(index - first_index)];
    uint8_t hdr[kFrameSize];
    if (::pread(fd, hdr, kFrameSize, off) != (ssize_t)kFrameSize) return -1;
    uint32_t flen = load_u32(hdr);
    uint8_t* blob = (uint8_t*)malloc(flen);
    if (!blob) return -1;
    if (::pread(fd, blob, flen, off + kFrameSize) != (ssize_t)flen) {
      free(blob);
      return -1;
    }
    *out = blob;
    return (int64_t)flen;
  }

  bool truncate_to(int64_t last_index_kept) {
    int64_t n_keep = last_index_kept - first_index + 1;
    if (n_keep >= (int64_t)offsets.size()) return true;
    int64_t new_size = n_keep > 0 ? offsets[(size_t)n_keep] : 0;
    if (::ftruncate(fd, new_size) != 0) return false;
    if (!fsync_fd(fd)) return false;
    offsets.resize((size_t)n_keep);
    size = new_size;
    return true;
  }

  void close_file() {
    if (fd >= 0) {
      ::close(fd);
      fd = -1;
    }
  }

  void remove_file() {
    close_file();
    ::unlink(path.c_str());
  }
};

}  // namespace

// -- the engine --------------------------------------------------------------

struct tls_handle {
  std::string dir;
  int64_t seg_max;
  int64_t first = 1;
  std::vector<std::unique_ptr<Segment>> segments;
  std::vector<int64_t> conf_indexes;
  std::mutex mu;
  std::string last_error;

  int64_t last_index_locked() const {
    if (segments.empty()) return first - 1;
    return segments.back()->last_index();
  }

  bool save_meta() {
    uint8_t buf[8];
    memcpy(buf, &first, 8);
    return atomic_write_file(dir, "meta", buf, 8);
  }

  void load_meta() {
    int fd = ::open((dir + "/meta").c_str(), O_RDONLY);
    if (fd < 0) return;
    uint8_t buf[8];
    if (::read(fd, buf, 8) == 8) first = load_i64(buf);
    ::close(fd);
  }

  bool rewrite_conf() {
    std::vector<uint8_t> buf(conf_indexes.size() * 8);
    for (size_t i = 0; i < conf_indexes.size(); ++i)
      memcpy(buf.data() + i * 8, &conf_indexes[i], 8);
    return atomic_write_file(dir, "conf.idx", buf.data(), buf.size());
  }

  void load_conf() {
    conf_indexes.clear();
    int fd = ::open((dir + "/conf.idx").c_str(), O_RDONLY);
    if (fd < 0) return;
    struct stat st;
    if (::fstat(fd, &st) == 0 && st.st_size >= 8) {
      std::vector<uint8_t> buf((size_t)st.st_size);
      ssize_t n = ::read(fd, buf.data(), buf.size());
      int64_t last = last_index_locked();
      for (ssize_t off = 0; off + 8 <= n; off += 8) {
        int64_t idx = load_i64(buf.data() + off);
        if (idx >= first && idx <= last) conf_indexes.push_back(idx);
      }
    }
    ::close(fd);
  }

  Segment* find_segment(int64_t index) {
    size_t lo = 0, hi = segments.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      Segment* s = segments[mid].get();
      if (index < s->first_index) {
        hi = mid;
      } else if (index > s->last_index()) {
        lo = mid + 1;
      } else {
        return s;
      }
    }
    return nullptr;
  }
};

extern "C" {

tls_handle* tls_open(const char* dir_path, int64_t seg_max_bytes,
                     char* errbuf, int errlen) {
  auto set_err = [&](const std::string& msg) {
    if (errbuf && errlen > 0) {
      snprintf(errbuf, (size_t)errlen, "%s", msg.c_str());
    }
  };
  auto h = std::make_unique<tls_handle>();
  h->dir = dir_path;
  h->seg_max = seg_max_bytes > 0 ? seg_max_bytes : (64LL << 20);
  if (::mkdir(dir_path, 0755) != 0 && errno != EEXIST) {
    set_err(std::string("mkdir failed: ") + strerror(errno));
    return nullptr;
  }
  h->load_meta();

  // Collect seg_<first>.log names sorted by first index.
  std::vector<std::pair<int64_t, std::string>> names;
  DIR* d = ::opendir(dir_path);
  if (!d) {
    set_err(std::string("opendir failed: ") + strerror(errno));
    return nullptr;
  }
  while (struct dirent* ent = ::readdir(d)) {
    std::string n = ent->d_name;
    if (n.rfind("seg_", 0) == 0 && n.size() > 8 &&
        n.compare(n.size() - 4, 4, ".log") == 0) {
      names.emplace_back(strtoll(n.c_str() + 4, nullptr, 10), n);
    }
  }
  ::closedir(d);
  std::sort(names.begin(), names.end());

  bool drop_rest = false;
  for (auto& [fidx, name] : names) {
    auto seg = std::make_unique<Segment>();
    seg->path = h->dir + "/" + name;
    seg->first_index = fidx;
    if (!seg->open_file(false)) continue;
    if (!seg->scan()) {
      set_err("segment scan failed: " + seg->path);
      return nullptr;
    }
    // Stale: fully below first_log_index — crash mid truncate_prefix
    // (meta saved, file not yet deleted).
    bool stale = seg->first_index < h->first &&
                 (seg->offsets.empty() || seg->last_index() < h->first);
    if (drop_rest || stale) {
      seg->remove_file();
      continue;
    }
    if (seg->offsets.empty() ||
        (!h->segments.empty() &&
         seg->first_index != h->segments.back()->last_index() + 1)) {
      // Empty (torn) segment or a hole from a torn multi-segment batch
      // append: everything from here on is unreachable.
      seg->remove_file();
      drop_rest = true;
      continue;
    }
    h->segments.push_back(std::move(seg));
  }
  h->load_conf();
  return h.release();
}

void tls_close(tls_handle* h) {
  if (!h) return;
  {
    std::lock_guard<std::mutex> g(h->mu);
    for (auto& s : h->segments) s->close_file();
    h->segments.clear();
  }
  delete h;
}

int64_t tls_first_index(tls_handle* h) {
  std::lock_guard<std::mutex> g(h->mu);
  return h->first;
}

int64_t tls_last_index(tls_handle* h) {
  std::lock_guard<std::mutex> g(h->mu);
  return h->last_index_locked();
}

// Returns blob length and sets *out (caller frees with tls_free), or -1 if
// the index is absent.
int64_t tls_get(tls_handle* h, int64_t index, uint8_t** out) {
  std::lock_guard<std::mutex> g(h->mu);
  if (index < h->first) return -1;
  Segment* s = h->find_segment(index);
  if (!s) return -1;
  return s->read_entry(index, out);
}

void tls_free(uint8_t* buf) { free(buf); }

// frames = concatenated [u32le len | entry blob]; returns entries appended
// or -1 (error text in errbuf).
int64_t tls_append(tls_handle* h, const uint8_t* frames, int64_t total,
                   int sync, char* errbuf, int errlen) {
  auto fail = [&](const std::string& msg) -> int64_t {
    if (errbuf && errlen > 0) snprintf(errbuf, (size_t)errlen, "%s", msg.c_str());
    return -1;
  };
  std::lock_guard<std::mutex> g(h->mu);

  // Parse every frame up front: indexes, types, rotation points.
  struct Frame {
    int64_t off;  // offset in `frames`
    int64_t len;  // frame (incl. length prefix) size
    EntryHeader hdr;
  };
  std::vector<Frame> parsed;
  int64_t expected = h->last_index_locked() + 1;
  int64_t off = 0;
  while (off < total) {
    if (off + (int64_t)kFrameSize > total) return fail("truncated frame header");
    uint32_t flen = load_u32(frames + off);
    if (off + (int64_t)kFrameSize + flen > total) return fail("truncated frame");
    Frame f;
    f.off = off;
    f.len = (int64_t)kFrameSize + flen;
    if (!parse_entry(frames + off + kFrameSize, flen, &f.hdr, false))
      return fail("bad entry blob in append batch");
    if (f.hdr.index != expected)
      return fail("non-contiguous append: have last=" +
                  std::to_string(expected - 1) + ", got " +
                  std::to_string(f.hdr.index));
    ++expected;
    parsed.push_back(f);
    off += f.len;
  }
  if (parsed.empty()) return 0;

  // Write contiguous runs, rotating segments at seg_max.  One write() per
  // touched segment (the reference batches via RocksDB WriteBatch).  The
  // in-memory index (offsets / conf_indexes) is only updated after the
  // bytes hit the fd, so a failed write leaves the index consistent with
  // the durable prefix.
  std::vector<Segment*> touched;
  bool new_conf = false;
  size_t i = 0;
  while (i < parsed.size()) {
    if (h->segments.empty() || h->segments.back()->size >= h->seg_max) {
      auto seg = std::make_unique<Segment>();
      seg->first_index = parsed[i].hdr.index;
      seg->path = h->dir + "/seg_" + std::to_string(seg->first_index) + ".log";
      if (!seg->open_file(true)) return fail("segment create failed");
      if (!fsync_dir(h->dir)) return fail("dir fsync failed");
      h->segments.push_back(std::move(seg));
    }
    Segment* cur = h->segments.back().get();
    // Greedy: take frames until rotation is due.
    int64_t run_start = parsed[i].off;
    int64_t run_len = 0;
    int64_t fill = cur->size;
    size_t j = i;
    while (j < parsed.size() && (run_len == 0 || fill < h->seg_max)) {
      fill += parsed[j].len;
      run_len += parsed[j].len;
      ++j;
    }
    if (::lseek(cur->fd, cur->size, SEEK_SET) < 0)
      return fail("seek failed");
    if (!write_all(cur->fd, frames + run_start, (size_t)run_len))
      return fail(std::string("write failed: ") + strerror(errno));
    int64_t off_in_seg = cur->size;
    for (size_t k = i; k < j; ++k) {
      cur->offsets.push_back(off_in_seg);
      off_in_seg += parsed[k].len;
      if (parsed[k].hdr.type == kTypeConfiguration) {
        h->conf_indexes.push_back(parsed[k].hdr.index);
        new_conf = true;
      }
    }
    cur->size = fill;
    if (touched.empty() || touched.back() != cur) touched.push_back(cur);
    i = j;
  }
  if (new_conf) {
    // Sidecar BEFORE the entry fsync (see FileLogStorage.append_entries).
    if (!h->rewrite_conf()) return fail("conf sidecar write failed");
  }
  if (sync) {
    // fsync oldest-first so a crash leaves a prefix, never a hole.
    for (Segment* s : touched)
      if (!fsync_fd(s->fd)) return fail("fsync failed");
  }
  return (int64_t)parsed.size();
}

int tls_truncate_prefix(tls_handle* h, int64_t first_kept) {
  std::lock_guard<std::mutex> g(h->mu);
  if (first_kept <= h->first) return 0;
  h->first = first_kept;
  if (!h->save_meta()) return -1;
  while (!h->segments.empty() &&
         h->segments.front()->last_index() < first_kept) {
    h->segments.front()->remove_file();
    h->segments.erase(h->segments.begin());
  }
  if (!h->conf_indexes.empty() && h->conf_indexes.front() < first_kept) {
    std::vector<int64_t> kept;
    for (int64_t i : h->conf_indexes)
      if (i >= first_kept) kept.push_back(i);
    h->conf_indexes = std::move(kept);
    if (!h->rewrite_conf()) return -1;
  }
  return 0;
}

int tls_truncate_suffix(tls_handle* h, int64_t last_kept) {
  std::lock_guard<std::mutex> g(h->mu);
  while (!h->segments.empty() &&
         h->segments.back()->first_index > last_kept) {
    h->segments.back()->remove_file();
    h->segments.pop_back();
  }
  if (!h->segments.empty() && !h->segments.back()->truncate_to(last_kept))
    return -1;
  if (!h->conf_indexes.empty() && h->conf_indexes.back() > last_kept) {
    std::vector<int64_t> kept;
    for (int64_t i : h->conf_indexes)
      if (i <= last_kept) kept.push_back(i);
    h->conf_indexes = std::move(kept);
    if (!h->rewrite_conf()) return -1;
  }
  return 0;
}

int tls_reset(tls_handle* h, int64_t next_index) {
  std::lock_guard<std::mutex> g(h->mu);
  for (auto& s : h->segments) s->remove_file();
  h->segments.clear();
  h->first = next_index;
  h->conf_indexes.clear();
  if (!h->rewrite_conf()) return -1;
  if (!h->save_meta()) return -1;
  return 0;
}

int64_t tls_conf_count(tls_handle* h) {
  std::lock_guard<std::mutex> g(h->mu);
  return (int64_t)h->conf_indexes.size();
}

int64_t tls_conf_indexes(tls_handle* h, int64_t* out, int64_t cap) {
  std::lock_guard<std::mutex> g(h->mu);
  int64_t n = std::min<int64_t>(cap, (int64_t)h->conf_indexes.size());
  for (int64_t i = 0; i < n; ++i) out[i] = h->conf_indexes[(size_t)i];
  return n;
}

}  // extern "C"
