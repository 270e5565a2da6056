// tpuraft native transport: epoll event-loop TCP engine for the RPC
// protocol plane.
//
// Reference parity: the role Netty's native epoll transport plays under
// SOFABolt (SURVEY.md §3.4 "Netty native transport"): a C event loop
// owning every socket — one listener multiplexing all raft groups, a
// pooled auto-reconnecting outbound connection per destination — with
// the Python asyncio runtime above it only ever touching complete
// frames.  Wire format is identical to tpuraft/rpc/tcp.py:
//
//   u32 payload_len | u64 seq | u8 flags | payload   (little-endian)
//
// so native and pure-Python endpoints interoperate on the same port.
//
// Threading model: one I/O thread runs epoll_wait and performs ALL
// socket reads/writes.  API calls from the host thread only mutate
// queues under the global context mutex and arm EPOLLOUT / write to a
// wakeup eventfd; completed inbound frames flow back through an event
// queue drained via tnt_next_event, with a notify eventfd the host can
// register in its own event loop (asyncio add_reader).  The two queues
// are the hand-off rings of the reference's Disruptor usage (SURVEY.md
// §3.4 "LMAX Disruptor" row).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kHdrSize = 13;  // u32 len + u64 seq + u8 flags
constexpr uint32_t kMaxFrame = 256u * 1024 * 1024;  // matches tcp.py
constexpr int kListenBacklog = 128;

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

// The wire format is pinned little-endian (tcp.py's struct "<IQB"), so
// serialize explicitly rather than via native-endian memcpy.
uint32_t load_le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

uint64_t load_le64(const uint8_t* p) {
  return static_cast<uint64_t>(load_le32(p)) |
         (static_cast<uint64_t>(load_le32(p + 4)) << 32);
}

void store_le32(char* p, uint32_t v) {
  p[0] = static_cast<char>(v & 0xff);
  p[1] = static_cast<char>((v >> 8) & 0xff);
  p[2] = static_cast<char>((v >> 16) & 0xff);
  p[3] = static_cast<char>((v >> 24) & 0xff);
}

void store_le64(char* p, uint64_t v) {
  store_le32(p, static_cast<uint32_t>(v & 0xffffffffu));
  store_le32(p + 4, static_cast<uint32_t>(v >> 32));
}

struct Conn {
  int64_t id = 0;
  int fd = -1;
  std::string endpoint;      // outbound: pool key "host:port"; inbound: peer
  bool outbound = false;
  bool connecting = false;   // nonblocking connect in flight
  std::string rbuf;          // inbound byte stream
  size_t roff = 0;           // parse offset into rbuf
  std::deque<std::string> wq;
  size_t woff = 0;           // bytes of wq.front() already written
  bool want_write = false;   // EPOLLOUT currently armed
};

struct Event {
  int type;                  // 1 = frame, 2 = closed
  int64_t conn_id;
  uint64_t seq;
  uint8_t flags;
  std::string payload;
  std::string endpoint;
};

struct Ctx {
  std::mutex mu;
  int ep = -1;               // epoll fd
  int wake_fd = -1;          // host -> io thread
  int notify_fd = -1;        // io thread -> host
  bool stopping = false;
  int64_t next_id = 1;
  std::map<int64_t, std::unique_ptr<Conn>> conns;
  std::map<std::string, int64_t> pool;   // outbound endpoint -> conn id
  std::map<int64_t, int> listeners;      // id -> listen fd
  // listeners parked after a persistent accept error (e.g. EMFILE),
  // re-armed once their deadline passes — avoids a level-triggered
  // busy-spin while the condition lasts
  std::map<int64_t, std::chrono::steady_clock::time_point> parked;
  std::deque<Event> events;
  std::thread io;

  ~Ctx() {
    for (auto& [id, c] : conns) {
      if (c->fd >= 0) close(c->fd);
    }
    for (auto& [id, fd] : listeners) close(fd);
    if (ep >= 0) close(ep);
    if (wake_fd >= 0) close(wake_fd);
    if (notify_fd >= 0) close(notify_fd);
  }
};

void notify(Ctx* c) {
  uint64_t one = 1;
  ssize_t r = write(c->notify_fd, &one, 8);
  (void)r;  // eventfd counter saturation is fine; host drains level-wise
}

void push_event(Ctx* c, Event ev) {
  c->events.push_back(std::move(ev));
  notify(c);
}

// Must hold c->mu.  Emits CLOSED and removes the connection.
void close_conn(Ctx* c, int64_t id) {
  auto it = c->conns.find(id);
  if (it == c->conns.end()) return;
  Conn* conn = it->second.get();
  Event ev;
  ev.type = 2;
  ev.conn_id = id;
  ev.seq = 0;
  ev.flags = 0;
  ev.endpoint = conn->endpoint;
  if (conn->outbound) {
    auto pit = c->pool.find(conn->endpoint);
    if (pit != c->pool.end() && pit->second == id) c->pool.erase(pit);
  }
  if (conn->fd >= 0) close(conn->fd);  // epoll deregisters automatically
  c->conns.erase(it);
  push_event(c, std::move(ev));
}

// Must hold c->mu.  Parse complete frames out of conn->rbuf.
void parse_frames(Ctx* c, Conn* conn, bool* fatal) {
  *fatal = false;
  for (;;) {
    size_t avail = conn->rbuf.size() - conn->roff;
    if (avail < kHdrSize) break;
    const uint8_t* p =
        reinterpret_cast<const uint8_t*>(conn->rbuf.data()) + conn->roff;
    uint32_t len = load_le32(p);
    uint64_t seq = load_le64(p + 4);
    uint8_t flags = p[12];
    if (len > kMaxFrame) {
      *fatal = true;  // protocol desync; unrecoverable stream position
      return;
    }
    if (avail < kHdrSize + len) break;
    Event ev;
    ev.type = 1;
    ev.conn_id = conn->id;
    ev.seq = seq;
    ev.flags = flags;
    ev.endpoint = conn->endpoint;
    ev.payload.assign(reinterpret_cast<const char*>(p) + kHdrSize, len);
    push_event(c, std::move(ev));
    conn->roff += kHdrSize + len;
  }
  // compact once the consumed prefix dominates, keeping appends O(1) am.
  if (conn->roff > 0 && conn->roff >= conn->rbuf.size() / 2 &&
      conn->rbuf.size() > 4096) {
    conn->rbuf.erase(0, conn->roff);
    conn->roff = 0;
  } else if (conn->roff == conn->rbuf.size()) {
    conn->rbuf.clear();
    conn->roff = 0;
  }
}

// Must hold c->mu.  Returns false if the connection died.
bool flush_writes(Ctx* c, Conn* conn) {
  while (!conn->wq.empty()) {
    const std::string& buf = conn->wq.front();
    ssize_t n = send(conn->fd, buf.data() + conn->woff,
                     buf.size() - conn->woff, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (errno == EINTR) continue;
      return false;
    }
    conn->woff += static_cast<size_t>(n);
    if (conn->woff == conn->wq.front().size()) {
      conn->wq.pop_front();
      conn->woff = 0;
    }
  }
  bool want = !conn->wq.empty() || conn->connecting;
  if (want != conn->want_write) {
    conn->want_write = want;
    epoll_event ev{};
    ev.events = EPOLLIN | (want ? EPOLLOUT : 0u);
    ev.data.u64 = static_cast<uint64_t>(conn->id);
    epoll_ctl(c->ep, EPOLL_CTL_MOD, conn->fd, &ev);
  }
  return true;
}

void handle_readable(Ctx* c, Conn* conn) {
  char buf[65536];
  for (;;) {
    ssize_t n = recv(conn->fd, buf, sizeof(buf), 0);
    if (n > 0) {
      conn->rbuf.append(buf, static_cast<size_t>(n));
      bool fatal = false;
      parse_frames(c, conn, &fatal);
      if (fatal) {
        close_conn(c, conn->id);
        return;
      }
      if (n < static_cast<ssize_t>(sizeof(buf))) return;  // drained
      continue;
    }
    if (n == 0) {  // peer closed
      close_conn(c, conn->id);
      return;
    }
    if (errno == EAGAIN || errno == EWOULDBLOCK) return;
    if (errno == EINTR) continue;
    close_conn(c, conn->id);
    return;
  }
}

void handle_accept(Ctx* c, int64_t listener_id, int lfd) {
  for (;;) {
    sockaddr_in addr{};
    socklen_t alen = sizeof(addr);
    int fd = accept4(lfd, reinterpret_cast<sockaddr*>(&addr), &alen,
                     SOCK_NONBLOCK | SOCK_CLOEXEC);
    if (fd < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) return;
      if (errno == EINTR || errno == ECONNABORTED) continue;
      // persistent failure (EMFILE/ENFILE/...): park the listener so
      // level-triggered epoll doesn't busy-spin while it lasts
      epoll_ctl(c->ep, EPOLL_CTL_DEL, lfd, nullptr);
      c->parked[listener_id] =
          std::chrono::steady_clock::now() + std::chrono::milliseconds(100);
      return;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    auto conn = std::make_unique<Conn>();
    conn->id = c->next_id++;
    conn->fd = fd;
    char ip[64];
    inet_ntop(AF_INET, &addr.sin_addr, ip, sizeof(ip));
    conn->endpoint = std::string(ip) + ":" + std::to_string(
        ntohs(addr.sin_port));
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = static_cast<uint64_t>(conn->id);
    if (epoll_ctl(c->ep, EPOLL_CTL_ADD, fd, &ev) != 0) {
      close(fd);
      continue;
    }
    c->conns.emplace(conn->id, std::move(conn));
  }
}

void io_loop(Ctx* c) {
  epoll_event evs[64];
  for (;;) {
    int timeout_ms = 1000;
    {
      std::lock_guard<std::mutex> g0(c->mu);
      if (!c->parked.empty()) timeout_ms = 50;
    }
    int n = epoll_wait(c->ep, evs, 64, timeout_ms);
    std::lock_guard<std::mutex> g(c->mu);
    if (c->stopping) return;
    // re-arm listeners parked after persistent accept errors
    if (!c->parked.empty()) {
      auto now = std::chrono::steady_clock::now();
      for (auto it = c->parked.begin(); it != c->parked.end();) {
        if (now < it->second) {
          ++it;
          continue;
        }
        auto lit = c->listeners.find(it->first);
        if (lit != c->listeners.end()) {
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.u64 = static_cast<uint64_t>(it->first);
          epoll_ctl(c->ep, EPOLL_CTL_ADD, lit->second, &ev);
        }
        it = c->parked.erase(it);
      }
    }
    for (int i = 0; i < n; ++i) {
      uint64_t id64 = evs[i].data.u64;
      if (id64 == 0) {  // wakeup eventfd
        uint64_t junk;
        while (read(c->wake_fd, &junk, 8) == 8) {
        }
        continue;
      }
      int64_t id = static_cast<int64_t>(id64);
      auto lit = c->listeners.find(id);
      if (lit != c->listeners.end()) {
        handle_accept(c, id, lit->second);
        continue;
      }
      auto it = c->conns.find(id);
      if (it == c->conns.end()) continue;  // closed earlier this batch
      Conn* conn = it->second.get();
      uint32_t flags = evs[i].events;
      if (conn->connecting && (flags & (EPOLLOUT | EPOLLERR | EPOLLHUP))) {
        int soerr = 0;
        socklen_t slen = sizeof(soerr);
        getsockopt(conn->fd, SOL_SOCKET, SO_ERROR, &soerr, &slen);
        if (soerr != 0) {
          close_conn(c, id);
          continue;
        }
        conn->connecting = false;
        if (!flush_writes(c, conn)) {
          close_conn(c, id);
          continue;
        }
      } else if (flags & (EPOLLERR | EPOLLHUP)) {
        // drain any final bytes first, then close
        handle_readable(c, conn);
        if (c->conns.count(id)) close_conn(c, id);
        continue;
      }
      if (flags & EPOLLIN) {
        handle_readable(c, conn);
        if (!c->conns.count(id)) continue;
      }
      if (flags & EPOLLOUT) {
        if (!flush_writes(c, conn)) close_conn(c, id);
      }
    }
  }
}

void wake(Ctx* c) {
  uint64_t one = 1;
  ssize_t r = write(c->wake_fd, &one, 8);
  (void)r;
}

std::string frame(uint64_t seq, uint8_t flags, const uint8_t* payload,
                  int64_t len) {
  std::string out;
  out.reserve(kHdrSize + static_cast<size_t>(len));
  char hdr[kHdrSize];
  store_le32(hdr, static_cast<uint32_t>(len));
  store_le64(hdr + 4, seq);
  hdr[12] = static_cast<char>(flags);
  out.append(hdr, kHdrSize);
  if (len > 0) out.append(reinterpret_cast<const char*>(payload),
                          static_cast<size_t>(len));
  return out;
}

bool resolve(const std::string& host, int port, sockaddr_in* out,
             std::string* emsg) {
  memset(out, 0, sizeof(*out));
  out->sin_family = AF_INET;
  out->sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host.c_str(), &out->sin_addr) == 1) return true;
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  int rc = getaddrinfo(host.c_str(), nullptr, &hints, &res);
  if (rc != 0 || !res) {
    *emsg = std::string("resolve ") + host + ": " + gai_strerror(rc);
    if (res) freeaddrinfo(res);
    return false;
  }
  out->sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
  freeaddrinfo(res);
  return true;
}

}  // namespace

extern "C" {

void* tnt_create(char* err, int errlen) {
  auto c = std::make_unique<Ctx>();
  c->ep = epoll_create1(EPOLL_CLOEXEC);
  c->wake_fd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  c->notify_fd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  if (c->ep < 0 || c->wake_fd < 0 || c->notify_fd < 0) {
    set_err(err, errlen, std::string("create: ") + strerror(errno));
    return nullptr;
  }
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.u64 = 0;  // id 0 = wakeup fd
  if (epoll_ctl(c->ep, EPOLL_CTL_ADD, c->wake_fd, &ev) != 0) {
    set_err(err, errlen, std::string("epoll wakeup: ") + strerror(errno));
    return nullptr;
  }
  Ctx* raw = c.release();
  raw->io = std::thread(io_loop, raw);
  return raw;
}

void tnt_destroy(void* h) {
  auto* c = static_cast<Ctx*>(h);
  if (!c) return;
  {
    std::lock_guard<std::mutex> g(c->mu);
    c->stopping = true;
  }
  wake(c);
  if (c->io.joinable()) c->io.join();
  delete c;
}

int tnt_notify_fd(void* h) {
  return static_cast<Ctx*>(h)->notify_fd;
}

// Returns the bound port, or -1.
int tnt_listen(void* h, const char* host, int port, char* err, int errlen) {
  auto* c = static_cast<Ctx*>(h);
  sockaddr_in addr;
  std::string emsg;
  if (!resolve(host, port, &addr, &emsg)) {
    set_err(err, errlen, emsg);
    return -1;
  }
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
  if (fd < 0) {
    set_err(err, errlen, std::string("socket: ") + strerror(errno));
    return -1;
  }
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, kListenBacklog) != 0) {
    set_err(err, errlen, std::string("bind/listen: ") + strerror(errno));
    close(fd);
    return -1;
  }
  sockaddr_in bound{};
  socklen_t blen = sizeof(bound);
  getsockname(fd, reinterpret_cast<sockaddr*>(&bound), &blen);
  std::lock_guard<std::mutex> g(c->mu);
  int64_t id = c->next_id++;
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.u64 = static_cast<uint64_t>(id);
  if (epoll_ctl(c->ep, EPOLL_CTL_ADD, fd, &ev) != 0) {
    set_err(err, errlen, std::string("epoll add: ") + strerror(errno));
    close(fd);
    return -1;
  }
  c->listeners.emplace(id, fd);
  return ntohs(bound.sin_port);
}

// Queue a frame to `endpoint` ("host:port"), creating/reusing the pooled
// outbound connection.  Returns the conn id used (>0), or -1.
int64_t tnt_send_to(void* h, const char* endpoint, uint64_t seq,
                    uint8_t flags, const uint8_t* payload, int64_t len,
                    char* err, int errlen) {
  auto* c = static_cast<Ctx*>(h);
  if (len < 0 || static_cast<uint64_t>(len) > kMaxFrame) {
    set_err(err, errlen, "oversized frame");
    return -1;
  }
  std::string ep(endpoint);
  auto colon = ep.rfind(':');
  if (colon == std::string::npos) {
    set_err(err, errlen, "endpoint must be host:port");
    return -1;
  }
  std::unique_lock<std::mutex> g(c->mu);
  auto pit = c->pool.find(ep);
  Conn* conn = nullptr;
  if (pit != c->pool.end()) {
    auto it = c->conns.find(pit->second);
    if (it != c->conns.end()) conn = it->second.get();
  }
  if (conn == nullptr) {
    // resolve only on new-connection creation, outside the lock (may
    // hit DNS; the pooled fast path above never pays for it)
    g.unlock();
    sockaddr_in addr;
    std::string emsg;
    if (!resolve(ep.substr(0, colon), atoi(ep.c_str() + colon + 1), &addr,
                 &emsg)) {
      set_err(err, errlen, emsg);
      return -1;
    }
    g.lock();
    // another caller may have created the connection meanwhile
    pit = c->pool.find(ep);
    if (pit != c->pool.end()) {
      auto it = c->conns.find(pit->second);
      if (it != c->conns.end()) conn = it->second.get();
    }
    if (conn != nullptr) {
      conn->wq.push_back(frame(seq, flags, payload, len));
      if (!conn->want_write) {
        conn->want_write = true;
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.u64 = static_cast<uint64_t>(conn->id);
        epoll_ctl(c->ep, EPOLL_CTL_MOD, conn->fd, &ev);
      }
      return conn->id;
    }
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (fd < 0) {
      set_err(err, errlen, std::string("socket: ") + strerror(errno));
      return -1;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    int rc = connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    if (rc != 0 && errno != EINPROGRESS) {
      set_err(err, errlen, std::string("connect: ") + strerror(errno));
      close(fd);
      return -1;
    }
    auto nc = std::make_unique<Conn>();
    nc->id = c->next_id++;
    nc->fd = fd;
    nc->endpoint = ep;
    nc->outbound = true;
    nc->connecting = (rc != 0);
    nc->want_write = true;  // EPOLLOUT armed below
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.u64 = static_cast<uint64_t>(nc->id);
    if (epoll_ctl(c->ep, EPOLL_CTL_ADD, fd, &ev) != 0) {
      set_err(err, errlen, std::string("epoll add: ") + strerror(errno));
      close(fd);
      return -1;
    }
    conn = nc.get();
    c->pool[ep] = nc->id;
    c->conns.emplace(nc->id, std::move(nc));
  }
  conn->wq.push_back(frame(seq, flags, payload, len));
  if (!conn->want_write) {
    conn->want_write = true;
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.u64 = static_cast<uint64_t>(conn->id);
    epoll_ctl(c->ep, EPOLL_CTL_MOD, conn->fd, &ev);
  }
  return conn->id;
}

// Queue a frame on an existing connection (server responses).  Returns 0,
// or -1 if the connection is gone (peer will retry — matches tcp.py).
int tnt_send_conn(void* h, int64_t conn_id, uint64_t seq, uint8_t flags,
                  const uint8_t* payload, int64_t len) {
  auto* c = static_cast<Ctx*>(h);
  if (len < 0 || static_cast<uint64_t>(len) > kMaxFrame) return -1;
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->conns.find(conn_id);
  if (it == c->conns.end()) return -1;
  Conn* conn = it->second.get();
  conn->wq.push_back(frame(seq, flags, payload, len));
  if (!conn->want_write) {
    conn->want_write = true;
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.u64 = static_cast<uint64_t>(conn->id);
    epoll_ctl(c->ep, EPOLL_CTL_MOD, conn->fd, &ev);
  }
  return 0;
}

// Close and forget the pooled outbound connection to `endpoint` (fails
// its in-flight requests with a CLOSED event).
int tnt_drop_endpoint(void* h, const char* endpoint) {
  auto* c = static_cast<Ctx*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  auto pit = c->pool.find(endpoint);
  if (pit == c->pool.end()) return 0;
  close_conn(c, pit->second);
  return 1;
}

// Dequeue one event.  Returns 1 and fills the out-params (payload is
// malloc'd, free with tnt_free), or 0 if the queue is empty.  Event
// types: 1 = frame {conn_id, seq, flags, payload}, 2 = connection
// closed {conn_id, endpoint}.
int tnt_next_event(void* h, int* type, int64_t* conn_id, uint64_t* seq,
                   uint8_t* flags, uint8_t** payload, int64_t* len,
                   char* endpoint_out, int endpoint_cap) {
  auto* c = static_cast<Ctx*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  if (c->events.empty()) {
    // level-style notify: clear the counter only when fully drained, so
    // a host read of the eventfd between notifies can't strand events
    uint64_t junk;
    while (read(c->notify_fd, &junk, 8) == 8) {
    }
    return 0;
  }
  Event& ev = c->events.front();
  *type = ev.type;
  *conn_id = ev.conn_id;
  *seq = ev.seq;
  *flags = ev.flags;
  *len = static_cast<int64_t>(ev.payload.size());
  uint8_t* out = static_cast<uint8_t*>(
      malloc(ev.payload.size() ? ev.payload.size() : 1));
  if (!out) return 0;  // retry later; event stays queued
  memcpy(out, ev.payload.data(), ev.payload.size());
  *payload = out;
  if (endpoint_out && endpoint_cap > 0) {
    snprintf(endpoint_out, static_cast<size_t>(endpoint_cap), "%s",
             ev.endpoint.c_str());
  }
  c->events.pop_front();
  return 1;
}

void tnt_free(uint8_t* p) { free(p); }

}  // extern "C"
