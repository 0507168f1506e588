// The TCPStore of paddle_tpu_torch: a key-value rendezvous server and its
// client over TCP, with a blocking WAIT and an atomic ADD (reference:
// paddle/phi/core/distributed/store/tcp_store.h:121). The wire protocol and
// the C ABI names are those of the JAX package's native core, so a client of
// either package talks to a server of the other.
//
// Protocol, one request and one reply a round trip, integers little-endian:
//   request:  op(1) keylen(u32) key vallen(u32) val
//   ops:      0=SET 1=GET 2=ADD(val = int64 delta) 3=WAIT(val = int64 ms)
//             4=DELETE
//   reply:    status(1: 0 ok, 1 missing or timed out) vallen(u32) val
//
// Built with `g++ -O2 -shared -fPIC` on first use (core/native.py) and
// loaded with ctypes.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct StoreServer {
  int listen_fd = -1;
  int port = 0;
  std::thread accept_thread;
  std::vector<std::thread> workers;
  std::atomic<bool> running{false};

  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> data;
  std::set<int> clients;  // open connections, shut down by stop()

  void handle_client(int fd) {
    for (;;) {
      uint8_t op;
      if (!recv_all(fd, &op, 1)) break;
      uint32_t klen;
      if (!recv_all(fd, &klen, 4)) break;
      std::string key(klen, '\0');
      if (klen && !recv_all(fd, &key[0], klen)) break;
      uint32_t vlen;
      if (!recv_all(fd, &vlen, 4)) break;
      std::string val(vlen, '\0');
      if (vlen && !recv_all(fd, &val[0], vlen)) break;

      uint8_t status = 0;
      std::string out;
      if (op == 0) {  // SET
        std::lock_guard<std::mutex> lk(mu);
        data[key] = val;
        cv.notify_all();
      } else if (op == 1) {  // GET, non-blocking
        std::lock_guard<std::mutex> lk(mu);
        auto it = data.find(key);
        if (it == data.end()) {
          status = 1;
        } else {
          out = it->second;
        }
      } else if (op == 2) {  // ADD
        int64_t delta = 0;
        if (val.size() == 8) memcpy(&delta, val.data(), 8);
        std::lock_guard<std::mutex> lk(mu);
        int64_t cur = 0;
        auto it = data.find(key);
        if (it != data.end() && it->second.size() == 8)
          memcpy(&cur, it->second.data(), 8);
        cur += delta;
        std::string enc(8, '\0');
        memcpy(&enc[0], &cur, 8);
        data[key] = enc;
        out = enc;
        cv.notify_all();
      } else if (op == 3) {  // WAIT until the key exists, or the timeout
        int64_t timeout_ms = 300000;
        if (val.size() == 8) memcpy(&timeout_ms, val.data(), 8);
        std::unique_lock<std::mutex> lk(mu);
        bool ok = cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
          return !running || data.count(key) > 0;
        });
        if (!ok || data.count(key) == 0) {
          status = 1;
        } else {
          out = data[key];
        }
      } else if (op == 4) {  // DELETE: consumed keys must not accumulate
        std::lock_guard<std::mutex> lk(mu);
        status = data.erase(key) ? 0 : 1;
      }
      uint32_t olen = static_cast<uint32_t>(out.size());
      if (!send_all(fd, &status, 1)) break;
      if (!send_all(fd, &olen, 4)) break;
      if (olen && !send_all(fd, out.data(), olen)) break;
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      clients.erase(fd);
    }
    ::close(fd);
  }

  bool start(int want_port) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
        ::listen(listen_fd, 128) != 0) {
      ::close(listen_fd);
      listen_fd = -1;
      return false;
    }
    socklen_t len = sizeof(addr);
    getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    running = true;
    accept_thread = std::thread([this] {
      while (running) {
        int fd = ::accept(listen_fd, nullptr, nullptr);
        if (fd < 0) break;
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        {
          std::lock_guard<std::mutex> lk(mu);
          if (!running) {
            ::close(fd);
            break;
          }
          clients.insert(fd);
        }
        workers.emplace_back([this, fd] { handle_client(fd); });
      }
    });
    return true;
  }

  // Stops accepting, ends every blocked WAIT, shuts every open connection
  // and joins every thread, so no handler outlives the server.
  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu);
      if (!running && listen_fd < 0) return;
      running = false;
      for (int fd : clients) ::shutdown(fd, SHUT_RDWR);
      cv.notify_all();
    }
    if (listen_fd >= 0) {
      ::shutdown(listen_fd, SHUT_RDWR);
      ::close(listen_fd);
      listen_fd = -1;
    }
    if (accept_thread.joinable()) accept_thread.join();
    for (auto& w : workers)
      if (w.joinable()) w.join();
    workers.clear();
  }

  ~StoreServer() { stop(); }
};

struct StoreClient {
  int fd = -1;
  std::mutex mu;

  bool connect_to(const char* host, int port, int timeout_ms) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    do {
      fd = ::socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      addr.sin_port = htons(static_cast<uint16_t>(port));
      inet_pton(AF_INET, host, &addr.sin_addr);
      if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        return true;
      }
      ::close(fd);
      fd = -1;
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
    } while (std::chrono::steady_clock::now() < deadline);
    return false;
  }

  bool request(uint8_t op, const std::string& key, const std::string& val,
               uint8_t* status, std::string* out) {
    std::lock_guard<std::mutex> lk(mu);
    uint32_t klen = static_cast<uint32_t>(key.size());
    uint32_t vlen = static_cast<uint32_t>(val.size());
    if (!send_all(fd, &op, 1) || !send_all(fd, &klen, 4) ||
        (klen && !send_all(fd, key.data(), klen)) || !send_all(fd, &vlen, 4) ||
        (vlen && !send_all(fd, val.data(), vlen)))
      return false;
    if (!recv_all(fd, status, 1)) return false;
    uint32_t olen;
    if (!recv_all(fd, &olen, 4)) return false;
    out->resize(olen);
    if (olen && !recv_all(fd, &(*out)[0], olen)) return false;
    return true;
  }

  ~StoreClient() {
    if (fd >= 0) ::close(fd);
  }
};

// copies a reply into the caller's buffer: its length, or -3 when the
// buffer is too small (the value stays on the server; the caller grows to
// the size written in the buffer's first 8 bytes)
int copy_out(const std::string& out, uint8_t* buf, int cap) {
  int n = static_cast<int>(out.size());
  if (n > cap) {
    if (cap >= 8) {
      int64_t need = n;
      memcpy(buf, &need, 8);
    }
    return -3;
  }
  memcpy(buf, out.data(), n);
  return n;
}

}  // namespace

// ===========================================================================
// C ABI (the names of the JAX package's core.cc)
// ===========================================================================

EXPORT void* pt_store_server_start(int port) {
  auto* s = new StoreServer();
  if (!s->start(port)) {
    delete s;
    return nullptr;
  }
  return s;
}

EXPORT int pt_store_server_port(void* h) {
  return static_cast<StoreServer*>(h)->port;
}

EXPORT void pt_store_server_stop(void* h) {
  auto* s = static_cast<StoreServer*>(h);
  s->stop();
  delete s;
}

EXPORT void* pt_store_client_connect(const char* host, int port, int timeout_ms) {
  auto* c = new StoreClient();
  if (!c->connect_to(host, port, timeout_ms)) {
    delete c;
    return nullptr;
  }
  return c;
}

EXPORT void pt_store_client_close(void* h) { delete static_cast<StoreClient*>(h); }

// 0 ok, -1 io error
EXPORT int pt_store_set(void* h, const char* key, const uint8_t* val, int vlen) {
  uint8_t status;
  std::string out;
  auto* c = static_cast<StoreClient*>(h);
  if (!c->request(0, key, std::string(reinterpret_cast<const char*>(val), vlen),
                  &status, &out))
    return -1;
  return status;
}

// length, or -1 missing, -2 io error, -3 buffer too small
EXPORT int pt_store_get(void* h, const char* key, uint8_t* buf, int cap) {
  uint8_t status;
  std::string out;
  auto* c = static_cast<StoreClient*>(h);
  if (!c->request(1, key, "", &status, &out)) return -2;
  if (status != 0) return -1;
  return copy_out(out, buf, cap);
}

// the new value, or INT64_MIN on an io error
EXPORT int64_t pt_store_add(void* h, const char* key, int64_t delta) {
  uint8_t status;
  std::string out, val(8, '\0');
  memcpy(&val[0], &delta, 8);
  auto* c = static_cast<StoreClient*>(h);
  if (!c->request(2, key, val, &status, &out) || out.size() != 8) return INT64_MIN;
  int64_t res;
  memcpy(&res, out.data(), 8);
  return res;
}

// 0 deleted, 1 absent, -2 io error
EXPORT int pt_store_delete(void* h, const char* key) {
  uint8_t status;
  std::string out;
  auto* c = static_cast<StoreClient*>(h);
  if (!c->request(4, key, "", &status, &out)) return -2;
  return status;
}

// length, or -1 timed out, -2 io error, -3 buffer too small
EXPORT int pt_store_wait(void* h, const char* key, int64_t timeout_ms, uint8_t* buf,
                         int cap) {
  uint8_t status;
  std::string out, val(8, '\0');
  memcpy(&val[0], &timeout_ms, 8);
  auto* c = static_cast<StoreClient*>(h);
  if (!c->request(3, key, val, &status, &out)) return -2;
  if (status != 0) return -1;
  return copy_out(out, buf, cap);
}
