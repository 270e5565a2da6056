// tpuraft shared multi-group log engine.
//
// Reference parity: RocksDB's role under core:storage/impl/RocksDBLogStorage
// when ONE process hosts MANY raft groups (SURVEY.md §3.1 log-storage row,
// §8.3 "group-sharded column spaces; batched group-fsync"): all groups of a
// process share one engine instance and one write stream, so a flush round
// covering N groups costs ONE fsync (the RocksDB WriteBatch+sync role) and
// the process holds O(total_bytes/seg_max) fds instead of O(groups) segment
// directories.
//
// Layout: a single sequence of journal files shared by every group:
//   journal_<seq>.log : repeated records
//     [u32le len | u32le crc | u32le gid | u8 rectype | payload]
//       len = bytes after the len field; crc = crc32(gid..payload).
//   groups            : atomic registry [u32 gid | u32 nlen | name]*
// Record types:
//   1 entry         payload = LogEntry blob (same format as logstore.cc;
//                   entry-internal CRC retained)
//   2 trunc_suffix  payload = i64 last_kept          (fsynced)
//   3 reset         payload = i64 next_index         (fsynced)
//   4 marker        payload = i64 first, i64 last    (GC state carry)
//   5 trunc_prefix  payload = i64 first_kept         (lazily durable)
//
// Durability contract: tlm_append stages writes (no fsync); tlm_sync
// fsyncs the active journal once for EVERYTHING staged — the Python side
// coalesces concurrent groups' flushes into one tlm_sync (group commit).
// Rotation fsyncs the outgoing file, so only the newest journal can have
// a torn tail; recovery truncates it and (bit-rot only) drops later files.
//
// Index semantics mirror raft: an appended entry with index <= last
// overwrites and truncates the suffix (conflict rule); appends must
// otherwise be contiguous per group.
//
// GC: the oldest journal file is deleted once it holds no live entry
// (live = some group's current position points into it).  Load-bearing
// control records are first re-asserted as a rectype-4 marker in the
// active journal, so dropping the file never loses truncation state.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <dirent.h>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>
#include <zlib.h>

namespace {

constexpr uint8_t kRecEntry = 1;
constexpr uint8_t kRecTruncSuffix = 2;
constexpr uint8_t kRecReset = 3;
constexpr uint8_t kRecMarker = 4;
constexpr uint8_t kRecTruncPrefix = 5;

constexpr uint8_t kEntryMagic = 0xB8;
constexpr uint8_t kTypeConfiguration = 2;
constexpr size_t kEntryHdr = 32;
constexpr size_t kRecHdr = 4 + 4 + 4 + 1;  // len crc gid rectype

uint32_t load_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
int64_t load_i64(const uint8_t* p) { int64_t v; memcpy(&v, p, 8); return v; }

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

struct Loc {
  uint32_t file;  // journal seq
  uint32_t off;   // record offset within the file (points at len field)
};

struct GroupLog {
  std::string name;
  uint64_t reg_epoch_at = 0;   // registry epoch of this group's record
  int64_t first = 1;
  int64_t base = 1;            // index of positions.front()
  std::deque<Loc> positions;   // base .. base+size-1
  std::vector<int64_t> conf_indexes;

  int64_t last() const { return base + (int64_t)positions.size() - 1; }
  bool has(int64_t idx) const { return idx >= base && idx <= last(); }
};

struct JournalFile {
  uint32_t seq = 0;
  int fd = -1;
  int64_t size = 0;
  int64_t live_entries = 0;       // positions currently pointing here
  std::set<uint32_t> groups;      // gids with ANY record in this file

  std::string path(const std::string& dir) const {
    char buf[32];
    snprintf(buf, sizeof(buf), "journal_%08u.log", seq);
    return dir + "/" + buf;
  }
};

struct tlm_handle {
  std::string dir;
  int64_t seg_max = 64LL << 20;
  std::mutex mu;
  std::mutex sync_mu;            // serializes fsync rounds (NOT under mu)
  uint64_t write_epoch = 0;      // bumped per staged write (under mu)
  uint64_t synced_epoch = 0;     // last epoch covered by an fsync
  std::map<uint32_t, GroupLog> groups;
  std::map<std::string, uint32_t> by_name;
  uint32_t next_gid = 1;
  std::deque<std::unique_ptr<JournalFile>> files;  // oldest..newest
  int64_t sync_rounds = 0;       // fsync calls through tlm_sync
  int64_t appends = 0;           // tlm_append calls (coalescing ratio)
  bool active_dirty = false;     // staged bytes not yet fsynced
  int reg_fd = -1;               // append-only group registry
  // registry epochs mirror write_epoch/synced_epoch: a bool flag would
  // lose a registration racing a sync round's post-fsync clear
  uint64_t reg_epoch = 0;        // bumped per registry append (under mu)
  uint64_t reg_synced_epoch = 0; // last registry epoch fsynced

  JournalFile* file_by_seq(uint32_t seq) {
    for (auto& f : files)
      if (f->seq == seq) return f.get();
    return nullptr;
  }

  JournalFile* active() { return files.empty() ? nullptr : files.back().get(); }

  // The registry is APPEND-ONLY ([u32 gid | u32 name_len | name] per
  // group): rewriting the whole file per registration made booting G
  // groups O(G^2) bytes + G rename+fsync rounds (profiled: 1.7ms per
  // registration at 1K, the dominant 16K-boot cost).  Registration
  // appends one record (no fsync); the NEXT sync round fsyncs the
  // registry BEFORE the journal, so a journal record's gid can never
  // be durable without its registry entry.
  bool append_group_record(uint32_t gid, const std::string& name) {
    if (reg_fd < 0) return false;
    std::string buf;
    uint32_t nl = (uint32_t)name.size();
    buf.append((const char*)&gid, 4);
    buf.append((const char*)&nl, 4);
    buf += name;
    // a partial write mid-file would make every LATER record misparse
    // at boot: retry shorts (write_all), and roll a failed append back
    // to the pre-write offset so the stream stays clean
    off_t at = ::lseek(reg_fd, 0, SEEK_CUR);
    if (!write_all(reg_fd, (const uint8_t*)buf.data(), buf.size())) {
      if (at >= 0) {
        (void)!::ftruncate(reg_fd, at);
        ::lseek(reg_fd, at, SEEK_SET);
      }
      return false;
    }
    ++reg_epoch;
    return true;
  }

  // fsync the registry if it has unsynced appends; call BEFORE any
  // journal fsync — a journal record's gid must never be durable
  // without its registry entry (an orphan gid would shadow the group's
  // data after a re-register).  Safe under mu (locked control-record
  // paths) and from sync_unlocked's pre-snapshot.
  bool flush_registry_locked(std::string* err) {
    if (reg_epoch <= reg_synced_epoch || reg_fd < 0) return true;
    uint64_t target = reg_epoch;
    if (!fsync_fd(reg_fd)) { *err = "registry fsync failed"; return false; }
    if (reg_synced_epoch < target) reg_synced_epoch = target;
    return true;
  }

  // Returns false when the registry cannot be READ (open failure, or a
  // short/failed read of an existing file).  The caller must treat that
  // as fatal for the whole open: the journal scan's unregistered-gid
  // guard depends on a complete registry — scanning with a partial one
  // would misread every group's acked records as orphan garbage and
  // truncate the journals to nothing.
  bool load_groups() {
    reg_fd = ::open((dir + "/groups").c_str(),
                    O_RDWR | O_CREAT | O_CLOEXEC, 0644);
    if (reg_fd < 0) return false;
    fsync_dir(dir);  // the one-time file creation
    struct stat st {};
    size_t good = 0;
    bool read_ok = false;
    // fstat failure must NOT read as "fresh empty registry" (st is
    // zero-initialized): an empty groups map + populated journals would
    // send every record into the unregistered-gid tear below.  The
    // caller fails the open and closes reg_fd.
    if (::fstat(reg_fd, &st) != 0) return false;
    if (st.st_size > 0) {
      std::vector<uint8_t> buf((size_t)st.st_size);
      size_t got = 0;
      while (got < buf.size()) {
        ssize_t n = ::pread(reg_fd, buf.data() + got, buf.size() - got,
                            (off_t)got);
        if (n < 0 && errno == EINTR) continue;
        if (n <= 0) break;
        got += (size_t)n;
      }
      if (got == buf.size()) {
        read_ok = true;
        size_t off = 0;
        uint32_t expect = 1;
        while (off + 8 <= buf.size()) {
          uint32_t gid = load_u32(buf.data() + off);
          uint32_t nl = load_u32(buf.data() + off + 4);
          if (off + 8 + nl > buf.size()) break;  // torn append
          // Registry records carry no per-record CRC, but gids are
          // allocated monotonically under mu, so records MUST carry
          // strictly increasing gids.  A violation is unsynced-tail
          // garbage (partial-page writeback can flip bits there):
          // without this check a flipped gid byte could ALIAS an acked
          // gid and shadow that group's log.  Treat it as a torn tail.
          // Strictly INCREASING — not gap-free — because registries
          // written before register_group rolled next_gid back on a
          // failed append can legally hold gaps in their durable
          // region; demanding exact sequence would truncate those
          // acked registrations on upgrade.  (A flipped NAME byte in
          // the tail stays undetected — it only garbles an unacked
          // group's name, never aliases a gid; a flipped-HIGH gid
          // registers a garbage gid whose real records then hit the
          // journal scan's unregistered-gid tear.)  Known residual:
          // records carry no per-record CRC, so rot in the FSYNCED
          // region is indistinguishable from tail garbage and gets
          // truncated rather than failing loudly — strictly safer than
          // the silent gid aliasing the unguarded parse allowed, but a
          // future registry format bump should add per-record CRCs.
          if (gid < expect) break;
          expect = gid + 1;
          off += 8;
          std::string name((const char*)buf.data() + off, nl);
          off += nl;
          groups[gid].name = name;
          by_name[name] = gid;
          next_gid = std::max(next_gid, gid + 1);
          good = off;
        }
      }
    } else if (st.st_size == 0) {
      read_ok = true;  // fresh registry
    }
    // drop a torn TAIL so later appends extend a clean record stream —
    // but only after a successful full read: truncating on a failed
    // read would forget every group (journal gids would orphan)
    if (read_ok && good < (size_t)st.st_size)
      (void)!::ftruncate(reg_fd, (off_t)good);
    ::lseek(reg_fd, (off_t)(read_ok ? good : st.st_size), SEEK_SET);
    return read_ok;
  }

  // -- record application (shared by recovery scan and live appends) --------

  void drop_loc_count(const Loc& l) {
    JournalFile* f = file_by_seq(l.file);
    if (f) --f->live_entries;
  }

  void clamp_suffix(GroupLog& g, int64_t last_kept) {
    while (g.last() > last_kept && !g.positions.empty()) {
      drop_loc_count(g.positions.back());
      g.positions.pop_back();
    }
    while (!g.conf_indexes.empty() && g.conf_indexes.back() > last_kept)
      g.conf_indexes.pop_back();
  }

  void clamp_prefix(GroupLog& g, int64_t first_kept) {
    if (first_kept <= g.first) return;
    g.first = first_kept;
    while (!g.positions.empty() && g.base < first_kept) {
      drop_loc_count(g.positions.front());
      g.positions.pop_front();
      ++g.base;
    }
    if (g.positions.empty()) g.base = std::max(g.base, first_kept);
    size_t keep = 0;
    while (keep < g.conf_indexes.size() && g.conf_indexes[keep] < first_kept)
      ++keep;
    if (keep)
      g.conf_indexes.erase(g.conf_indexes.begin(),
                           g.conf_indexes.begin() + (long)keep);
  }

  void reset_group(GroupLog& g, int64_t next_index) {
    for (const Loc& l : g.positions) drop_loc_count(l);
    g.positions.clear();
    g.conf_indexes.clear();
    g.first = next_index;
    g.base = next_index;
  }

  // Returns false only for structurally invalid ENTRY sequencing (live
  // append validation); the recovery scan treats false as corruption.
  bool apply_record(uint32_t gid, uint8_t rectype, const uint8_t* payload,
                    size_t plen, Loc loc, std::string* err) {
    GroupLog& g = groups[gid];  // callers verified gid is registered
    switch (rectype) {
      case kRecEntry: {
        if (plen < kEntryHdr || payload[0] != kEntryMagic) {
          *err = "bad entry blob";
          return false;
        }
        int64_t idx = load_i64(payload + 12);
        if (g.positions.empty()) {
          // first entry after open/reset/suffix-trunc-to-empty
          if (idx < g.first) {
            *err = "append below first_log_index";
            return false;
          }
          g.base = idx;
        } else if (idx <= g.last()) {
          clamp_suffix(g, idx - 1);  // conflict overwrite truncates
          if (g.positions.empty()) g.base = idx;
        } else if (idx != g.last() + 1) {
          *err = "non-contiguous append: have last=" +
                 std::to_string(g.last()) + ", got " + std::to_string(idx);
          return false;
        }
        g.positions.push_back(loc);
        JournalFile* f = file_by_seq(loc.file);
        if (f) ++f->live_entries;
        if (payload[1] == kTypeConfiguration) g.conf_indexes.push_back(idx);
        return true;
      }
      case kRecTruncSuffix:
        if (plen < 8) { *err = "short trunc record"; return false; }
        clamp_suffix(g, load_i64(payload));
        return true;
      case kRecReset:
        if (plen < 8) { *err = "short reset record"; return false; }
        reset_group(g, load_i64(payload));
        return true;
      case kRecMarker: {
        if (plen < 16) { *err = "short marker"; return false; }
        int64_t mf = load_i64(payload), ml = load_i64(payload + 8);
        clamp_suffix(g, ml);
        clamp_prefix(g, mf);
        return true;
      }
      case kRecTruncPrefix:
        if (plen < 8) { *err = "short trunc record"; return false; }
        clamp_prefix(g, load_i64(payload));
        return true;
      default:
        *err = "unknown record type";
        return false;
    }
  }

  // -- writing ---------------------------------------------------------------

  bool rotate_locked(std::string* err) {
    if (active() != nullptr) {
      // outgoing file becomes immutable: make it durable NOW so only
      // the newest journal can ever have a torn tail
      if (!fsync_fd(active()->fd)) { *err = "rotate fsync failed"; return false; }
    }
    auto f = std::make_unique<JournalFile>();
    f->seq = files.empty() ? 1 : files.back()->seq + 1;
    f->fd = ::open(f->path(dir).c_str(), O_RDWR | O_CREAT | O_APPEND, 0644);
    if (f->fd < 0) { *err = std::string("journal create: ") + strerror(errno); return false; }
    files.push_back(std::move(f));
    if (!fsync_dir(dir)) { *err = "dir fsync failed"; return false; }
    return true;
  }

  bool write_record_locked(uint32_t gid, uint8_t rectype,
                           const uint8_t* payload, size_t plen,
                           Loc* loc_out, std::string* err) {
    // staging invariant: no journal byte for a gid may exist before
    // its registry entry is DURABLE — any concurrent round's journal
    // fsync covers all staged bytes, so ordering fsyncs inside rounds
    // cannot close this on its own.  One registry fsync per group's
    // first record at most (usually a prior round already covered it).
    auto git = groups.find(gid);
    if (git != groups.end()
        && git->second.reg_epoch_at > reg_synced_epoch) {
      if (!flush_registry_locked(err)) return false;
    }
    if (active() == nullptr || active()->size >= seg_max) {
      if (!rotate_locked(err)) return false;
    }
    JournalFile* f = active();
    std::vector<uint8_t> rec(kRecHdr + plen);
    uint32_t len = (uint32_t)(4 + 4 + 1 + plen);
    memcpy(rec.data(), &len, 4);
    memcpy(rec.data() + 8, &gid, 4);
    rec[12] = rectype;
    memcpy(rec.data() + 13, payload, plen);
    uLong c = crc32(0L, Z_NULL, 0);
    c = crc32(c, rec.data() + 8, (uInt)(4 + 1 + plen));
    uint32_t crc = (uint32_t)c;
    memcpy(rec.data() + 4, &crc, 4);
    if (!write_all(f->fd, rec.data(), rec.size())) {
      *err = std::string("journal write: ") + strerror(errno);
      return false;
    }
    if (loc_out) *loc_out = Loc{f->seq, (uint32_t)f->size};
    f->size += (int64_t)rec.size();
    f->groups.insert(gid);
    active_dirty = true;
    ++write_epoch;
    return true;
  }

  bool write_control_locked(uint32_t gid, uint8_t rectype, int64_t a,
                            std::string* err, int64_t b = INT64_MIN) {
    uint8_t payload[16];
    memcpy(payload, &a, 8);
    size_t plen = 8;
    if (b != INT64_MIN) {
      memcpy(payload + 8, &b, 8);
      plen = 16;
    }
    return write_record_locked(gid, rectype, payload, plen, nullptr, err);
  }

  bool sync_active_locked(std::string* err) {
    if (!flush_registry_locked(err)) return false;  // registry FIRST
    if (active() == nullptr || !active_dirty) return true;
    if (!fsync_fd(active()->fd)) { *err = "fsync failed"; return false; }
    active_dirty = false;
    synced_epoch = write_epoch;
    ++sync_rounds;
    return true;
  }

  // The group-commit sync: fsync OUTSIDE mu, so concurrent staging
  // (which runs inline on the host event loop) never blocks behind a
  // flush round.  sync_mu serializes rounds; the epoch check lets a
  // caller whose bytes another thread's round already covered return
  // without a redundant fsync.
  bool sync_unlocked(std::string* err) {
    std::lock_guard<std::mutex> sg(sync_mu);
    int fd = -1, rfd = -1;
    uint64_t target, rtarget;
    {
      std::lock_guard<std::mutex> g(mu);
      target = write_epoch;
      rtarget = reg_epoch;
      if (rtarget > reg_synced_epoch) rfd = reg_fd;
      if ((synced_epoch >= target || active() == nullptr) && rfd < 0)
        return true;
      // only touch the journal when IT has unsynced bytes — a
      // registry-only round must not pay a redundant journal fsync
      if (synced_epoch < target && active() != nullptr)
        fd = active()->fd;
    }
    // registry FIRST: a journal record's gid must never be durable
    // without its registry entry (an orphan gid would shadow the
    // group's data after a re-register).  The epoch snapshot bounds
    // what this fsync proves: a registration racing this round keeps
    // reg_epoch > reg_synced_epoch and the next round covers it.
    if (rfd >= 0) {
      if (!fsync_fd(rfd)) { *err = "registry fsync failed"; return false; }
      std::lock_guard<std::mutex> g(mu);
      if (reg_synced_epoch < rtarget) reg_synced_epoch = rtarget;
    }
    if (fd >= 0) {
      if (!fsync_fd(fd)) { *err = "fsync failed"; return false; }
    }
    {
      std::lock_guard<std::mutex> g(mu);
      if (synced_epoch < target) synced_epoch = target;
      if (write_epoch == target) active_dirty = false;
      ++sync_rounds;
    }
    return true;
  }
};

}  // namespace

extern "C" {

tlm_handle* tlm_open(const char* dir_path, int64_t seg_max_bytes,
                     char* errbuf, int errlen) {
  auto set_err = [&](const std::string& msg) {
    if (errbuf && errlen > 0) snprintf(errbuf, (size_t)errlen, "%s", msg.c_str());
  };
  auto h = std::make_unique<tlm_handle>();
  h->dir = dir_path;
  if (seg_max_bytes > 0) h->seg_max = seg_max_bytes;
  // every error return below must release what was opened so far:
  // open failures are RETRYABLE (transient EIO), and a caller looping
  // on retries must not leak fds per attempt until EMFILE
  auto fail_close = [&]() {
    for (auto& f : h->files)
      if (f->fd >= 0) ::close(f->fd);
    h->files.clear();
    if (h->reg_fd >= 0) {
      ::close(h->reg_fd);
      h->reg_fd = -1;
    }
  };
  if (::mkdir(dir_path, 0755) != 0 && errno != EEXIST) {
    set_err(std::string("mkdir failed: ") + strerror(errno));
    return nullptr;
  }
  if (!h->load_groups()) {
    // FAIL the open rather than scan with a partial registry: the
    // unregistered-gid guard below would read every group's acked
    // records as orphan garbage and truncate the journals to nothing —
    // a transient registry EIO must surface as a retryable open error,
    // never as data destruction.
    fail_close();
    set_err("groups registry unreadable");
    return nullptr;
  }

  std::vector<std::pair<uint32_t, std::string>> names;
  DIR* d = ::opendir(dir_path);
  if (!d) {
    set_err(std::string("opendir failed: ") + strerror(errno));
    fail_close();
    return nullptr;
  }
  while (struct dirent* ent = ::readdir(d)) {
    std::string n = ent->d_name;
    if (n.rfind("journal_", 0) == 0 && n.size() == 20 &&
        n.compare(n.size() - 4, 4, ".log") == 0) {
      names.emplace_back((uint32_t)strtoul(n.c_str() + 8, nullptr, 10), n);
    }
  }
  ::closedir(d);
  std::sort(names.begin(), names.end());

  bool drop_rest = false;
  for (auto& [seq, name] : names) {
    std::string path = h->dir + "/" + name;
    if (drop_rest) {
      ::unlink(path.c_str());
      continue;
    }
    auto f = std::make_unique<JournalFile>();
    f->seq = seq;
    f->fd = ::open(path.c_str(), O_RDWR | O_APPEND, 0644);
    if (f->fd < 0) continue;
    struct stat st;
    if (::fstat(f->fd, &st) != 0) {
      set_err("fstat failed");
      ::close(f->fd);  // not yet in h->files: fail_close won't see it
      fail_close();
      return nullptr;
    }
    std::vector<uint8_t> buf((size_t)st.st_size);
    if (st.st_size > 0 &&
        ::pread(f->fd, buf.data(), buf.size(), 0) != (ssize_t)buf.size()) {
      set_err("journal read failed");
      ::close(f->fd);
      fail_close();
      return nullptr;
    }
    // the file must be registered before records apply (live counts)
    JournalFile* fp = f.get();
    h->files.push_back(std::move(f));
    int64_t off = 0, good_end = 0;
    while (off + (int64_t)kRecHdr <= st.st_size) {
      uint32_t len = load_u32(buf.data() + off);
      if (len < 9 || off + 4 + (int64_t)len > st.st_size) break;  // torn
      uint32_t crc = load_u32(buf.data() + off + 4);
      uLong c = crc32(0L, Z_NULL, 0);
      c = crc32(c, buf.data() + off + 8, (uInt)(len - 4));
      if ((uint32_t)c != crc) break;  // torn/corrupt
      uint32_t gid = load_u32(buf.data() + off + 8);
      uint8_t rectype = buf[(size_t)off + 12];
      // Power-loss orphan guard: a record whose gid has no registry
      // entry can only be an unsynced tail — every sync round fsyncs
      // the registry BEFORE the journal, so any DURABLY ACKED journal
      // byte at or past this offset would imply the registry entry is
      // durable too.  Adopting the record instead would let a future
      // re-register reassign the gid and shadow this data (and a
      // contiguity clash between orphan and adopted entries could tear
      // the scan mid-journal, dropping later groups' acked records).
      if (h->groups.find(gid) == h->groups.end())
        break;  // unregistered gid -> unacked tail: truncate here
      std::string aerr;
      if (!h->apply_record(gid, rectype, buf.data() + off + 13, len - 9,
                           Loc{seq, (uint32_t)off}, &aerr))
        break;  // structurally bad -> treat as tear
      off += 4 + (int64_t)len;
      good_end = off;
    }
    if (good_end < st.st_size) {
      // torn tail: truncate; everything after (later files) is
      // unreachable (they were created after this tail was written)
      if (::ftruncate(fp->fd, good_end) != 0) {
        set_err("torn-tail truncate failed");
        fail_close();
        return nullptr;
      }
      drop_rest = true;
    }
    fp->size = good_end;
  }
  return h.release();
}

void tlm_close(tlm_handle* h) {
  if (!h) return;
  {
    std::lock_guard<std::mutex> g(h->mu);
    for (auto& f : h->files)
      if (f->fd >= 0) ::close(f->fd);
    h->files.clear();
    if (h->reg_fd >= 0) {
      if (h->reg_epoch > h->reg_synced_epoch) (void)fsync_fd(h->reg_fd);
      ::close(h->reg_fd);
      h->reg_fd = -1;
    }
  }
  delete h;
}

// Registers (or looks up) a group by name; returns its gid, or 0 on error.
uint32_t tlm_register_group(tlm_handle* h, const char* name,
                            char* errbuf, int errlen) {
  std::lock_guard<std::mutex> g(h->mu);
  auto it = h->by_name.find(name);
  if (it != h->by_name.end()) return it->second;
  uint32_t gid = h->next_gid++;
  h->groups[gid].name = name;
  h->by_name[name] = gid;
  h->groups[gid].reg_epoch_at = h->reg_epoch + 1;  // set by the append
  if (!h->append_group_record(gid, name)) {
    // roll the registration back COMPLETELY: leaving the gid cached in
    // by_name would make a retried register return it without any
    // registry record staged (the staging guard in write_record_locked
    // then passes vacuously), so journal records could become durable
    // for a gid absent from the registry — on reboot the gid orphans
    // and next_gid could reassign it, shadowing the group's data.
    h->groups.erase(gid);
    h->by_name.erase(name);
    h->next_gid = gid;  // we hold mu: nobody consumed a later gid
    if (errbuf && errlen > 0)
      snprintf(errbuf, (size_t)errlen, "groups registry write failed");
    return 0;
  }
  return gid;
}

int64_t tlm_first(tlm_handle* h, uint32_t gid) {
  std::lock_guard<std::mutex> g(h->mu);
  auto it = h->groups.find(gid);
  return it == h->groups.end() ? 1 : it->second.first;
}

int64_t tlm_last(tlm_handle* h, uint32_t gid) {
  std::lock_guard<std::mutex> g(h->mu);
  auto it = h->groups.find(gid);
  if (it == h->groups.end()) return 0;
  GroupLog& gl = it->second;
  return gl.positions.empty() ? gl.first - 1 : gl.last();
}

// frames = concatenated [u32le blob_len | entry blob] (the LogStorage batch
// format).  Stages the records; durability comes from tlm_sync.  Live
// appends must be strictly contiguous per group (LogManager truncates
// explicitly first); the overwrite rule only serves the recovery scan.
int64_t tlm_append(tlm_handle* h, uint32_t gid, const uint8_t* frames,
                   int64_t total, char* errbuf, int errlen) {
  auto fail = [&](const std::string& msg) -> int64_t {
    if (errbuf && errlen > 0) snprintf(errbuf, (size_t)errlen, "%s", msg.c_str());
    return -1;
  };
  std::lock_guard<std::mutex> g(h->mu);
  auto git = h->groups.find(gid);
  if (git == h->groups.end()) return fail("unregistered group");
  GroupLog& gl = git->second;

  // Pass 1: validate frames + contiguity up front.
  struct Pending {
    const uint8_t* blob;
    uint32_t blen;
  };
  std::vector<Pending> pend;
  int64_t expected = gl.positions.empty() ? -1 : gl.last() + 1;
  int64_t off = 0;
  while (off < total) {
    if (off + 4 > total) return fail("truncated frame header");
    uint32_t blen = load_u32(frames + off);
    if (off + 4 + (int64_t)blen > total) return fail("truncated frame");
    const uint8_t* blob = frames + off + 4;
    if (blen < kEntryHdr || blob[0] != kEntryMagic)
      return fail("bad entry blob");
    int64_t idx = load_i64(blob + 12);
    if (expected == -1) {
      if (idx < gl.first) return fail("append below first_log_index");
    } else if (idx != expected) {
      return fail("non-contiguous append: have last=" +
                  std::to_string(expected - 1) + ", got " +
                  std::to_string(idx));
    }
    expected = idx + 1;
    pend.push_back({blob, blen});
    off += 4 + (int64_t)blen;
  }
  if (pend.empty()) return 0;

  // Pass 2: write in segment-sized runs — ONE write() per touched
  // journal — then index.  Index updates happen only after the run's
  // bytes hit the fd, so a failed write leaves the in-memory index
  // consistent with the durable prefix.
  std::string err;
  size_t i = 0;
  while (i < pend.size()) {
    if (h->active() == nullptr || h->active()->size >= h->seg_max) {
      if (!h->rotate_locked(&err)) return fail(err);
    }
    JournalFile* f = h->active();
    std::string buf;
    std::vector<std::pair<Loc, size_t>> staged;  // (loc, pend idx)
    int64_t fsize = f->size;
    size_t j = i;
    while (j < pend.size() && (staged.empty() || fsize < h->seg_max)) {
      const Pending& p = pend[j];
      uint32_t len = (uint32_t)(4 + 4 + 1 + p.blen);
      size_t base = buf.size();
      buf.resize(base + 4 + len);
      uint8_t* rec = (uint8_t*)buf.data() + base;
      memcpy(rec, &len, 4);
      memcpy(rec + 8, &gid, 4);
      rec[12] = kRecEntry;
      memcpy(rec + 13, p.blob, p.blen);
      uLong c = crc32(0L, Z_NULL, 0);
      c = crc32(c, rec + 8, (uInt)(4 + 1 + p.blen));
      uint32_t crc = (uint32_t)c;
      memcpy(rec + 4, &crc, 4);
      staged.emplace_back(Loc{f->seq, (uint32_t)fsize}, j);
      fsize += (int64_t)(4 + len);
      ++j;
    }
    if (!write_all(f->fd, (const uint8_t*)buf.data(), buf.size()))
      return fail(std::string("journal write: ") + strerror(errno));
    f->size = fsize;
    f->groups.insert(gid);
    h->active_dirty = true;
    for (auto& [loc, pi] : staged) {
      if (!h->apply_record(gid, kRecEntry, pend[pi].blob, pend[pi].blen,
                           loc, &err))
        return fail(err);  // unreachable after pass-1 validation
    }
    i = j;
  }
  ++h->appends;
  return (int64_t)pend.size();
}

// ONE fsync covering every group's staged appends since the last sync.
// The fsync runs OUTSIDE the engine mutex (see sync_unlocked).
int tlm_sync(tlm_handle* h, char* errbuf, int errlen) {
  std::string err;
  if (!h->sync_unlocked(&err)) {
    if (errbuf && errlen > 0) snprintf(errbuf, (size_t)errlen, "%s", err.c_str());
    return -1;
  }
  return 0;
}

int64_t tlm_sync_count(tlm_handle* h) {
  std::lock_guard<std::mutex> g(h->mu);
  return h->sync_rounds;
}

int64_t tlm_append_count(tlm_handle* h) {
  std::lock_guard<std::mutex> g(h->mu);
  return h->appends;
}

int64_t tlm_file_count(tlm_handle* h) {
  std::lock_guard<std::mutex> g(h->mu);
  return (int64_t)h->files.size();
}

// Returns blob length and sets *out (caller frees with tlm_free); -1 on
// a missing index, -2 on record corruption (CRC/gid mismatch — bit rot
// of a record the index says is live; callers must fail LOUDLY, not
// treat it as a hole).  The preads run OUTSIDE the engine mutex (a cold
// read must not stall every group's appends); the fd is dup'd under the
// lock so a racing GC unlink/close cannot invalidate it mid-read.
int64_t tlm_get(tlm_handle* h, uint32_t gid, int64_t index, uint8_t** out) {
  int fd = -1;
  Loc loc{0, 0};
  {
    std::lock_guard<std::mutex> g(h->mu);
    auto it = h->groups.find(gid);
    if (it == h->groups.end()) return -1;
    GroupLog& gl = it->second;
    if (index < gl.first || !gl.has(index)) return -1;
    loc = gl.positions[(size_t)(index - gl.base)];
    JournalFile* f = h->file_by_seq(loc.file);
    if (!f) return -1;
    fd = ::dup(f->fd);
    if (fd < 0) return -1;
  }
  // -1 = environmental failure (short pread, malloc) — indistinct from
  // a missing record, NOT a corruption verdict; -2 only when the bytes
  // were fully read and the CRC or stored gid actually mismatches.
  int64_t result = -1;
  uint8_t hdr[kRecHdr];
  struct stat st {};
  if (::pread(fd, hdr, kRecHdr, loc.off) == (ssize_t)kRecHdr &&
      ::fstat(fd, &st) == 0) {
    uint32_t len = load_u32(hdr);
    // CRC-guard the read path, not just recovery: the stored crc covers
    // gid..payload, so recompute over the header tail + blob and reject
    // rotted records instead of silently decoding garbage.  A len rotted
    // HIGH overruns the journal extent (records are never physically
    // truncated under a live index — suffix truncation only clamps the
    // in-memory positions, GC unlinks whole files) — that is corruption
    // too, not a short read to shrug off as a hole.
    if (len < 9 || load_u32(hdr + 8) != gid ||
        loc.off + 4 + (int64_t)len > (int64_t)st.st_size) {
      result = -2;  // framing/gid contradicts the live index: corruption
    } else {
      uint32_t blen = len - 9;
      uint8_t* blob = (uint8_t*)malloc(blen ? blen : 1);
      if (blob) {
        if (::pread(fd, blob, blen, loc.off + kRecHdr) == (ssize_t)blen) {
          uLong c = crc32(0L, Z_NULL, 0);
          c = crc32(c, hdr + 8, 5);          // gid + rectype
          c = crc32(c, blob, (uInt)blen);     // payload
          if ((uint32_t)c == load_u32(hdr + 4)) {
            *out = blob;
            result = (int64_t)blen;
          } else {
            free(blob);
            result = -2;
          }
        } else {
          free(blob);
        }
      }
    }
  }
  ::close(fd);
  return result;
}

void tlm_free(uint8_t* buf) { free(buf); }

int tlm_truncate_prefix(tlm_handle* h, uint32_t gid, int64_t first_kept) {
  std::lock_guard<std::mutex> g(h->mu);
  auto it = h->groups.find(gid);
  if (it == h->groups.end()) return -1;
  if (first_kept <= it->second.first) return 0;
  std::string err;
  // lazily durable: losing this record only means re-keeping entries
  if (!h->write_control_locked(gid, kRecTruncPrefix, first_kept, &err))
    return -1;
  h->clamp_prefix(it->second, first_kept);
  return 0;
}

int tlm_truncate_suffix(tlm_handle* h, uint32_t gid, int64_t last_kept) {
  std::lock_guard<std::mutex> g(h->mu);
  auto it = h->groups.find(gid);
  if (it == h->groups.end()) return -1;
  GroupLog& gl = it->second;
  if (gl.positions.empty() || gl.last() <= last_kept) return 0;
  std::string err;
  // durability-critical (raft conflict resolution): record + fsync
  if (!h->write_control_locked(gid, kRecTruncSuffix, last_kept, &err))
    return -1;
  if (!h->sync_active_locked(&err)) return -1;
  h->clamp_suffix(gl, last_kept);
  return 0;
}

int tlm_reset(tlm_handle* h, uint32_t gid, int64_t next_index) {
  std::lock_guard<std::mutex> g(h->mu);
  auto it = h->groups.find(gid);
  if (it == h->groups.end()) return -1;
  std::string err;
  if (!h->write_control_locked(gid, kRecReset, next_index, &err)) return -1;
  if (!h->sync_active_locked(&err)) return -1;
  h->reset_group(it->second, next_index);
  return 0;
}

int64_t tlm_conf_count(tlm_handle* h, uint32_t gid) {
  std::lock_guard<std::mutex> g(h->mu);
  auto it = h->groups.find(gid);
  return it == h->groups.end() ? 0 : (int64_t)it->second.conf_indexes.size();
}

int64_t tlm_conf_indexes(tlm_handle* h, uint32_t gid, int64_t* out,
                         int64_t cap) {
  std::lock_guard<std::mutex> g(h->mu);
  auto it = h->groups.find(gid);
  if (it == h->groups.end()) return 0;
  auto& v = it->second.conf_indexes;
  int64_t n = std::min<int64_t>(cap, (int64_t)v.size());
  for (int64_t i = 0; i < n; ++i) out[i] = v[(size_t)i];
  return n;
}

// Deletes fully-dead oldest journal files.  Returns files deleted, -1 on
// error.  Never touches the active (newest) file.
int64_t tlm_gc(tlm_handle* h) {
  std::lock_guard<std::mutex> g(h->mu);
  int64_t deleted = 0;
  std::string err;
  while (h->files.size() > 1) {
    JournalFile* f = h->files.front().get();
    if (f->live_entries > 0) break;
    // re-assert every resident group's state as a marker in the active
    // journal, so dropping this file's control records loses nothing
    for (uint32_t gid : f->groups) {
      auto it = h->groups.find(gid);
      if (it == h->groups.end()) continue;
      GroupLog& gl = it->second;
      int64_t last = gl.positions.empty() ? gl.first - 1 : gl.last();
      if (!h->write_control_locked(gid, kRecMarker, gl.first, &err, last))
        return -1;
    }
    if (!h->sync_active_locked(&err)) return -1;
    std::string path = f->path(h->dir);
    ::close(f->fd);
    ::unlink(path.c_str());
    h->files.pop_front();
    if (!fsync_dir(h->dir)) return -1;
    ++deleted;
  }
  return deleted;
}

}  // extern "C"
