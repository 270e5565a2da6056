// Sanitizer exercise driver for the epoll transport engine
// (transport.cc).  Two engines in one process — a server echoing frames
// and a client with concurrent sender threads — exercising the I/O
// thread / host thread hand-off rings under TSAN and ASAN
// (`make -C native check-native`).

#include <poll.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* tnt_create(char* err, int errlen);
void tnt_destroy(void* h);
int tnt_notify_fd(void* h);
int tnt_listen(void* h, const char* host, int port, char* err, int errlen);
int64_t tnt_send_to(void* h, const char* endpoint, uint64_t seq,
                    uint8_t flags, const uint8_t* payload, int64_t len,
                    char* err, int errlen);
int tnt_send_conn(void* h, int64_t conn_id, uint64_t seq, uint8_t flags,
                  const uint8_t* payload, int64_t len, char* err, int errlen);
int tnt_next_event(void* h, int* type, int64_t* conn_id, uint64_t* seq,
                   uint8_t* flags, uint8_t** payload, int64_t* len,
                   char* endpoint_out, int endpoint_cap);
void tnt_free(uint8_t* p);
}

namespace {

constexpr int kSenders = 4;
constexpr int kPerSender = 500;

bool wait_readable(int fd, int timeout_ms) {
  pollfd p{fd, POLLIN, 0};
  return poll(&p, 1, timeout_ms) > 0;
}

}  // namespace

int main() {
  char err[256] = {0};
  void* server = tnt_create(err, sizeof(err));
  void* client = tnt_create(err, sizeof(err));
  if (!server || !client) {
    fprintf(stderr, "create failed: %s\n", err);
    return 1;
  }
  int port = tnt_listen(server, "127.0.0.1", 0, err, sizeof(err));
  if (port <= 0) {
    fprintf(stderr, "listen failed: %s\n", err);
    return 1;
  }
  std::string ep = "127.0.0.1:" + std::to_string(port);

  std::atomic<bool> stop{false};
  std::atomic<int> echoed{0};

  // server: drain frames, echo each back on its connection
  std::thread echo([&] {
    int nfd = tnt_notify_fd(server);
    while (!stop.load(std::memory_order_acquire)) {
      int type;
      int64_t conn_id, len;
      uint64_t seq;
      uint8_t flags;
      uint8_t* payload = nullptr;
      char epbuf[64];
      int got = tnt_next_event(server, &type, &conn_id, &seq, &flags,
                               &payload, &len, epbuf, sizeof(epbuf));
      if (!got) {
        wait_readable(nfd, 50);
        continue;
      }
      if (type == 1) {  // frame
        char e[256];
        if (tnt_send_conn(server, conn_id, seq, 1, payload, len, e,
                          sizeof(e)) != 0) {
          fprintf(stderr, "echo send failed: %s\n", e);
          abort();
        }
        echoed.fetch_add(1, std::memory_order_relaxed);
      }
      tnt_free(payload);
    }
  });

  // client: concurrent senders (the send path locks per engine), one
  // drainer counting echo responses
  std::atomic<int> acked{0};
  std::thread drain([&] {
    int nfd = tnt_notify_fd(client);
    while (acked.load(std::memory_order_acquire) < kSenders * kPerSender) {
      int type;
      int64_t conn_id, len;
      uint64_t seq;
      uint8_t flags;
      uint8_t* payload = nullptr;
      char epbuf[64];
      int got = tnt_next_event(client, &type, &conn_id, &seq, &flags,
                               &payload, &len, epbuf, sizeof(epbuf));
      if (!got) {
        if (!wait_readable(nfd, 2000)) {
          fprintf(stderr, "stalled at %d acks\n",
                  acked.load(std::memory_order_relaxed));
          abort();
        }
        continue;
      }
      if (type == 1) acked.fetch_add(1, std::memory_order_release);
      tnt_free(payload);
    }
  });

  std::vector<std::thread> senders;
  for (int s = 0; s < kSenders; ++s) {
    senders.emplace_back([&, s] {
      for (int i = 0; i < kPerSender; ++i) {
        std::string msg =
            "m" + std::to_string(s) + "-" + std::to_string(i);
        char e[256];
        if (tnt_send_to(client, ep.c_str(),
                        static_cast<uint64_t>(s) << 32 | i, 0,
                        reinterpret_cast<const uint8_t*>(msg.data()),
                        static_cast<int64_t>(msg.size()), e,
                        sizeof(e)) < 0) {
          fprintf(stderr, "send failed: %s\n", e);
          abort();
        }
      }
    });
  }

  for (auto& s : senders) s.join();
  drain.join();
  stop.store(true, std::memory_order_release);
  echo.join();
  tnt_destroy(client);
  tnt_destroy(server);
  if (echoed.load() < kSenders * kPerSender) {
    fprintf(stderr, "echoed %d < %d\n", echoed.load(),
            kSenders * kPerSender);
    return 1;
  }
  printf("check_transport OK (%d frames echoed, %d sender threads)\n",
         kSenders * kPerSender, kSenders);
  return 0;
}
