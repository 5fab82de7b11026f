// Native HTTP/1.1 server for the lapis-silo-tpu API layer.
//
// The reference's API layer is native (Poco HTTPServer,
// reference src/silo_api/api.cpp:174-204, request_handler_factory.cpp);
// this is the equivalent here: a small epoll server that owns every
// socket byte — accept, parse, keep-alive, response framing — and calls a
// registered handler (the Python router, via ctypes) only for the actual
// routing + query work. The Python front-end measured ~437 req/s on two
// vCPUs with per-request thread spawns and email.parser header parsing;
// this layer removes all of that from the request path.
//
// Threading model:
//   - ONE I/O thread owns all connection state (accept, epoll, reads,
//     writes) — no locks on the socket path.
//   - N worker threads pop parsed requests from a queue and run the
//     handler callback (the Python side blocks on the device micro-batcher
//     with the GIL released, so concurrent workers pipeline).
//   - Workers hand finished responses back through a completion queue +
//     eventfd; the I/O thread writes them out.
//
// Contract with the handler: it must call silo_http_respond(req, ...)
// exactly once before returning (synchronous model); if it does not, the
// worker sends a generic 500 so a lost response can never wedge a client.
//
// Count fast path (reference parity: the reference serves queries entirely
// in native code, src/silo_api/query_handler.cpp:22-74): the Python side
// registers exact `POST /query` bodies whose response is a pure count
// (silo_fastpath_register). The I/O thread matches arriving bodies against
// that map and — on a hit — queues {conn_key, handle} for a single Python
// drainer thread (silo_fastpath_wait) instead of waking a worker. The
// drainer answers a whole batch with ONE device dispatch and hands the
// counts back (silo_fastpath_respond_counts); response JSON is formatted
// here. Per-request Python work on this path is zero.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <cctype>
#include <cstdlib>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <functional>
#include <cstdint>
#include <cstdio>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kMaxHeaderBytes = 64 * 1024;
constexpr size_t kMaxBodyBytes = 256ull * 1024 * 1024;
constexpr int kListenBacklog = 1024;

struct PendingResponse {
  bool set = false;
  int status = 500;
  std::string body;
  bool has_data_version = false;
  std::string data_version;
};

using HandlerFn = void (*)(void* req, const char* method, const char* target,
                           const char* body, int64_t body_len);

struct Task {
  uint64_t conn_key = 0;
  bool keep_alive = true;
  std::string method;
  std::string target;
  std::string body;
};

struct Completion {
  uint64_t conn_key = 0;
  bool close_after = false;
  std::string bytes;
};

struct FpTask {
  uint64_t conn_key = 0;
  uint32_t handle = 0;
  bool keep_alive = true;
};

const char* status_reason(int status) {
  switch (status) {
    case 200: return "OK";
    case 400: return "Bad Request";
    case 404: return "Not Found";
    case 405: return "Method Not Allowed";
    case 408: return "Request Timeout";
    case 413: return "Payload Too Large";
    case 431: return "Request Header Fields Too Large";
    case 500: return "Internal Server Error";
    case 503: return "Service Unavailable";
    default: return "Unknown";
  }
}

std::string build_response(const PendingResponse& r, bool keep_alive) {
  std::string out;
  out.reserve(r.body.size() + 160);
  out += "HTTP/1.1 ";
  out += std::to_string(r.status);
  out += ' ';
  out += status_reason(r.status);
  out += "\r\nContent-Type: application/json\r\nContent-Length: ";
  out += std::to_string(r.body.size());
  if (r.has_data_version) {
    out += "\r\ndata-version: ";
    out += r.data_version;
  }
  if (!keep_alive) out += "\r\nConnection: close";
  out += "\r\n\r\n";
  out += r.body;
  return out;
}

bool iequals(const std::string& a, const char* b) {
  size_t n = strlen(b);
  if (a.size() != n) return false;
  for (size_t i = 0; i < n; i++) {
    if (tolower((unsigned char)a[i]) != tolower((unsigned char)b[i])) return false;
  }
  return true;
}

struct Server {
  int listen_fd = -1;
  int epoll_fd = -1;
  int event_fd = -1;
  int port = 0;
  HandlerFn handler = nullptr;
  std::atomic<bool> stopping{false};

  std::thread io_thread;
  std::vector<std::thread> workers;

  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<Task> queue;

  std::mutex c_mu;
  std::deque<Completion> completions;

  // Count fast path. ONE mutex guards map + queue + in-flight keep-alive
  // state so a clear() strictly precedes any later match: after clear
  // returns, no task for a cleared entry can still enter fp_queue.
  std::atomic<bool> fp_enabled{false};
  std::mutex fp_mu;
  std::condition_variable fp_cv;
  std::unordered_map<std::string, uint32_t> fp_map;
  std::deque<FpTask> fp_queue;
  std::unordered_map<uint64_t, bool> fp_keepalive;  // in-flight requests

  struct Conn {
    int fd = -1;
    uint32_t gen = 0;
    std::string in;
    std::string out;
    bool busy = false;           // a request is with a worker
    bool close_after = false;    // close once out drains
    bool want_write = false;     // EPOLLOUT subscribed
    bool sent_continue = false;  // 100 Continue already sent this request
  };
  std::vector<Conn> conns;
  std::vector<uint32_t> free_slots;

  uint64_t key_of(uint32_t slot) const {
    return (uint64_t(slot) << 32) | conns[slot].gen;
  }

  void update_events(uint32_t slot) {
    Conn& c = conns[slot];
    if (c.fd < 0) return;
    epoll_event ev{};
    ev.events = EPOLLIN | (c.want_write ? EPOLLOUT : 0u);
    ev.data.u64 = slot;
    epoll_ctl(epoll_fd, EPOLL_CTL_MOD, c.fd, &ev);
  }

  void close_conn(uint32_t slot) {
    Conn& c = conns[slot];
    if (c.fd < 0) return;
    epoll_ctl(epoll_fd, EPOLL_CTL_DEL, c.fd, nullptr);
    ::close(c.fd);
    c.fd = -1;
    c.gen++;  // stale completions for this slot are dropped
    c.in.clear();
    c.in.shrink_to_fit();
    c.out.clear();
    c.out.shrink_to_fit();
    c.busy = false;
    c.close_after = false;
    c.want_write = false;
    c.sent_continue = false;
    free_slots.push_back(slot);
  }

  void send_error_and_close(uint32_t slot, int status) {
    PendingResponse r;
    r.set = true;
    r.status = status;
    r.body = "{\"error\":\"";
    r.body += status_reason(status);
    r.body += "\",\"message\":\"\"}";
    conns[slot].out += build_response(r, /*keep_alive=*/false);
    conns[slot].close_after = true;
    try_write(slot);
  }

  // Parse as many complete requests as are buffered (one at a time: the
  // connection goes busy until its response is written).
  void try_parse(uint32_t slot) {
    Conn& c = conns[slot];
    while (c.fd >= 0 && !c.busy) {
      size_t head_end = c.in.find("\r\n\r\n");
      if (head_end == std::string::npos) {
        if (c.in.size() > kMaxHeaderBytes) send_error_and_close(slot, 431);
        return;
      }
      // request line
      size_t line_end = c.in.find("\r\n");
      size_t sp1 = c.in.find(' ');
      size_t sp2 = (sp1 == std::string::npos) ? std::string::npos
                                              : c.in.find(' ', sp1 + 1);
      if (sp1 == std::string::npos || sp2 == std::string::npos ||
          sp2 > line_end) {
        send_error_and_close(slot, 400);
        return;
      }
      std::string method = c.in.substr(0, sp1);
      std::string target = c.in.substr(sp1 + 1, sp2 - sp1 - 1);
      std::string version = c.in.substr(sp2 + 1, line_end - sp2 - 1);
      bool keep_alive = version != "HTTP/1.0";

      size_t content_length = 0;
      bool chunked = false;
      size_t pos = line_end + 2;
      while (pos < head_end) {
        size_t eol = c.in.find("\r\n", pos);
        if (eol == std::string::npos || eol > head_end) eol = head_end;
        size_t colon = c.in.find(':', pos);
        if (colon != std::string::npos && colon < eol) {
          std::string name = c.in.substr(pos, colon - pos);
          size_t vstart = colon + 1;
          while (vstart < eol && c.in[vstart] == ' ') vstart++;
          std::string value = c.in.substr(vstart, eol - vstart);
          if (iequals(name, "content-length")) {
            content_length = strtoull(value.c_str(), nullptr, 10);
          } else if (iequals(name, "connection")) {
            if (iequals(value, "close")) keep_alive = false;
            else if (iequals(value, "keep-alive")) keep_alive = true;
          } else if (iequals(name, "transfer-encoding")) {
            if (value.find("chunked") != std::string::npos) chunked = true;
          } else if (iequals(name, "expect")) {
            // try_parse rescans headers on every read event while the
            // body is incomplete: send the interim response ONCE
            if (iequals(value, "100-continue") && !c.sent_continue) {
              c.sent_continue = true;
              c.out += "HTTP/1.1 100 Continue\r\n\r\n";
              try_write(slot);
              if (c.fd < 0) return;
            }
          }
        }
        pos = eol + 2;
      }
      if (chunked) {  // not used by any known client of this API
        send_error_and_close(slot, 400);
        return;
      }
      if (content_length > kMaxBodyBytes) {
        send_error_and_close(slot, 413);
        return;
      }
      size_t body_start = head_end + 4;
      if (c.in.size() < body_start + content_length) return;  // need more

      c.sent_continue = false;  // next request may Expect its own 100
      std::string body = c.in.substr(body_start, content_length);
      c.in.erase(0, body_start + content_length);
      c.busy = true;
      if (!keep_alive) c.close_after = true;

      // Count fast path: exact-body match dispatches straight to the batch
      // drainer — no worker wake-up, no Python on the request path.
      if (fp_enabled.load(std::memory_order_acquire) && method == "POST" &&
          target == "/query") {
        bool hit = false;
        {
          std::lock_guard<std::mutex> lk(fp_mu);
          auto it = fp_map.find(body);
          if (it != fp_map.end()) {
            hit = true;
            uint64_t key = key_of(slot);
            fp_keepalive[key] = keep_alive;
            fp_queue.push_back(FpTask{key, it->second, keep_alive});
          }
        }
        if (hit) {
          fp_cv.notify_one();
          continue;  // next pipelined request
        }
      }

      Task task;
      task.conn_key = key_of(slot);
      task.keep_alive = keep_alive;
      task.method = std::move(method);
      task.target = std::move(target);
      task.body = std::move(body);
      {
        std::lock_guard<std::mutex> lk(q_mu);
        queue.push_back(std::move(task));
      }
      q_cv.notify_one();
    }
  }

  void try_write(uint32_t slot) {
    Conn& c = conns[slot];
    while (c.fd >= 0 && !c.out.empty()) {
      ssize_t n = ::send(c.fd, c.out.data(), c.out.size(), MSG_NOSIGNAL);
      if (n > 0) {
        c.out.erase(0, size_t(n));
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        if (!c.want_write) {
          c.want_write = true;
          update_events(slot);
        }
        return;
      }
      close_conn(slot);
      return;
    }
    if (c.fd < 0) return;
    if (c.want_write) {
      c.want_write = false;
      update_events(slot);
    }
    if (c.close_after) close_conn(slot);
  }

  void on_readable(uint32_t slot) {
    Conn& c = conns[slot];
    char buf[16384];
    bool eof = false;
    while (c.fd >= 0) {
      ssize_t n = ::recv(c.fd, buf, sizeof(buf), 0);
      if (n > 0) {
        c.in.append(buf, size_t(n));
        // while a request is in flight try_parse returns without running
        // the size checks: bound the buffered bytes (pipelined request +
        // slack) so a client can't grow c.in without limit
        if (c.in.size() > kMaxBodyBytes + kMaxHeaderBytes) {
          close_conn(slot);
          return;
        }
        if (size_t(n) < sizeof(buf)) break;
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
      eof = true;  // peer closed its write side (or hard error)
      break;
    }
    if (c.fd < 0) return;
    // parse BEFORE deciding to drop: a client may send request + FIN in one
    // round (shutdown(SHUT_WR) then read the response)
    try_parse(slot);
    if (eof && c.fd >= 0) {
      if (!c.busy && c.out.empty()) close_conn(slot);
      else c.close_after = true;
    }
  }

  void on_accept() {
    while (true) {
      int fd = accept4(listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
      if (fd < 0) return;
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      uint32_t slot;
      if (!free_slots.empty()) {
        slot = free_slots.back();
        free_slots.pop_back();
      } else {
        slot = uint32_t(conns.size());
        conns.emplace_back();
      }
      Conn& c = conns[slot];
      c.fd = fd;
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.u64 = slot;
      epoll_ctl(epoll_fd, EPOLL_CTL_ADD, fd, &ev);
    }
  }

  void drain_completions() {
    uint64_t tick;
    while (read(event_fd, &tick, sizeof(tick)) > 0) {
    }
    std::deque<Completion> done;
    {
      std::lock_guard<std::mutex> lk(c_mu);
      done.swap(completions);
    }
    for (Completion& comp : done) {
      uint32_t slot = uint32_t(comp.conn_key >> 32);
      if (slot >= conns.size()) continue;
      Conn& c = conns[slot];
      if (c.fd < 0 || c.gen != uint32_t(comp.conn_key)) continue;  // stale
      c.out += comp.bytes;
      c.busy = false;
      if (comp.close_after) c.close_after = true;
      try_write(slot);
      if (c.fd >= 0 && !c.close_after) try_parse(slot);  // pipelined next
    }
  }

  void io_loop() {
    epoll_event events[128];
    while (!stopping.load(std::memory_order_relaxed)) {
      int n = epoll_wait(epoll_fd, events, 128, 500);
      for (int i = 0; i < n; i++) {
        uint64_t tag = events[i].data.u64;
        if (tag == UINT64_MAX) {
          on_accept();
        } else if (tag == UINT64_MAX - 1) {
          drain_completions();
        } else {
          uint32_t slot = uint32_t(tag);
          if (slot >= conns.size() || conns[slot].fd < 0) continue;
          // read first: EPOLLHUP can arrive together with final data
          if (events[i].events & EPOLLIN) on_readable(slot);
          if (conns[slot].fd < 0) continue;
          if (events[i].events & EPOLLERR) {
            close_conn(slot);
            continue;
          }
          if (events[i].events & EPOLLHUP) {
            Conn& c = conns[slot];
            if (!c.busy && c.out.empty()) {
              close_conn(slot);
              continue;
            }
            c.close_after = true;
          }
          if (events[i].events & EPOLLOUT) try_write(slot);
        }
      }
    }
    for (uint32_t slot = 0; slot < conns.size(); slot++) {
      if (conns[slot].fd >= 0) close_conn(slot);
    }
  }

  void worker_loop() {
    while (true) {
      Task task;
      {
        std::unique_lock<std::mutex> lk(q_mu);
        q_cv.wait(lk, [&] { return stopping.load() || !queue.empty(); });
        if (queue.empty()) {
          if (stopping.load()) return;
          continue;
        }
        task = std::move(queue.front());
        queue.pop_front();
      }
      PendingResponse resp;
      handler(&resp, task.method.c_str(), task.target.c_str(),
              task.body.data(), int64_t(task.body.size()));
      if (!resp.set) {
        resp.status = 500;
        resp.body =
            "{\"error\":\"Internal server error\","
            "\"message\":\"handler produced no response\"}";
      }
      Completion comp;
      comp.conn_key = task.conn_key;
      comp.close_after = !task.keep_alive;
      comp.bytes = build_response(resp, task.keep_alive);
      {
        // the event_fd write stays under c_mu: stop() closes the fd under
        // the same lock, so a late completion can never write to a closed
        // (or kernel-reused) descriptor
        std::lock_guard<std::mutex> lk(c_mu);
        completions.push_back(std::move(comp));
        uint64_t one = 1;
        ssize_t ignored = write(event_fd, &one, sizeof(one));
        (void)ignored;
      }
    }
  }

  bool start(const char* bind_addr, int want_port, int n_workers,
             bool reuse_port) {
    listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    if (reuse_port) {
      // Several server PROCESSES share one port; the kernel load-balances
      // accepted connections across their listen queues. This is how the
      // API front-end scales past one Python interpreter's GIL
      // (cli.py --apiProcesses).
      setsockopt(listen_fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
    }
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(uint16_t(want_port));
    if (inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1) {
      addr.sin_addr.s_addr = INADDR_ANY;
    }
    if (bind(listen_fd, (sockaddr*)&addr, sizeof(addr)) < 0) return false;
    if (listen(listen_fd, kListenBacklog) < 0) return false;
    socklen_t len = sizeof(addr);
    getsockname(listen_fd, (sockaddr*)&addr, &len);
    port = ntohs(addr.sin_port);

    epoll_fd = epoll_create1(0);
    event_fd = eventfd(0, EFD_NONBLOCK);
    if (epoll_fd < 0 || event_fd < 0) return false;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = UINT64_MAX;
    epoll_ctl(epoll_fd, EPOLL_CTL_ADD, listen_fd, &ev);
    ev.data.u64 = UINT64_MAX - 1;
    epoll_ctl(epoll_fd, EPOLL_CTL_ADD, event_fd, &ev);

    io_thread = std::thread([this] { io_loop(); });
    for (int i = 0; i < n_workers; i++) {
      workers.emplace_back([this] { worker_loop(); });
    }
    return true;
  }

  void stop() {
    stopping.store(true);
    q_cv.notify_all();
    fp_cv.notify_all();
    uint64_t one = 1;
    ssize_t ignored = write(event_fd, &one, sizeof(one));
    (void)ignored;
    if (io_thread.joinable()) io_thread.join();
    for (auto& w : workers) {
      if (w.joinable()) w.join();
    }
    // close under c_mu: the Python drainer thread outlives this join set
    // and may still be finishing a respond call — its event_fd write holds
    // the same lock, so it either lands before the close or sees -1
    std::lock_guard<std::mutex> lk(c_mu);
    if (listen_fd >= 0) ::close(listen_fd);
    if (epoll_fd >= 0) ::close(epoll_fd);
    if (event_fd >= 0) ::close(event_fd);
    listen_fd = epoll_fd = event_fd = -1;
  }
};

std::mutex g_servers_mu;
// shared_ptr: a drainer thread blocked in silo_fastpath_wait must keep the
// Server alive across silo_http_stop (stop() wakes it; the last reference
// releases the object).
std::vector<std::shared_ptr<Server>> g_servers;

std::shared_ptr<Server> get_server(int server_id) {
  std::lock_guard<std::mutex> lk(g_servers_mu);
  if (server_id < 0 || size_t(server_id) >= g_servers.size()) return nullptr;
  return g_servers[size_t(server_id)];
}

}  // namespace

extern "C" {

// Fill the response for a request handle received by the handler callback.
// Must be called exactly once, inside the callback, before it returns.
void silo_http_respond(void* req, int status, const char* body,
                       int64_t body_len, const char* data_version) {
  auto* r = static_cast<PendingResponse*>(req);
  r->set = true;
  r->status = status;
  r->body.assign(body, size_t(body_len));
  if (data_version != nullptr) {
    r->has_data_version = true;
    r->data_version = data_version;
  }
}

// Start a server; returns a server id >= 0, or -1 on failure.
// reuse_port != 0 sets SO_REUSEPORT so multiple processes can share the
// port (kernel-level connection load balancing).
int silo_http_create_ex(const char* bind_addr, int port, int n_workers,
                        HandlerFn handler, int reuse_port) {
  auto server = std::make_shared<Server>();
  server->handler = handler;
  if (!server->start(bind_addr, port, n_workers > 0 ? n_workers : 8,
                     reuse_port != 0)) {
    return -1;
  }
  std::lock_guard<std::mutex> lk(g_servers_mu);
  g_servers.push_back(std::move(server));
  return int(g_servers.size()) - 1;
}

int silo_http_create(const char* bind_addr, int port, int n_workers,
                     HandlerFn handler) {
  return silo_http_create_ex(bind_addr, port, n_workers, handler, 0);
}

int silo_http_port(int server_id) {
  auto server = get_server(server_id);
  return server ? server->port : -1;
}

// ---- count fast path ------------------------------------------------------

// Register (or refresh) a fast-path entry: an exact `POST /query` body whose
// response is {"queryResult": [{"count": N}]}. `handle` is an opaque Python-
// side program id (generation-tagged there). Also enables the fast path.
void silo_fastpath_register(int server_id, const char* body, int64_t body_len,
                            uint32_t handle) {
  auto server = get_server(server_id);
  if (!server) return;
  {
    std::lock_guard<std::mutex> lk(server->fp_mu);
    server->fp_map[std::string(body, size_t(body_len))] = handle;
  }
  server->fp_enabled.store(true, std::memory_order_release);
}

// Drop every registered body (snapshot swap). After this returns, no new
// fast-path task for a cleared entry can enter the queue — tasks already
// queued still carry their old (generation-tagged) handles and must be
// answered by the drainer before it retires the old program table.
void silo_fastpath_clear(int server_id) {
  auto server = get_server(server_id);
  if (!server) return;
  std::lock_guard<std::mutex> lk(server->fp_mu);
  server->fp_map.clear();
}

// Block (call with the GIL released) until fast-path tasks are queued; pop
// up to max_n into keys/handles. Returns the count, 0 on timeout, -1 when
// the server is stopping (drainer should exit).
int silo_fastpath_wait(int server_id, uint64_t* keys, uint32_t* handles,
                       int max_n, int timeout_ms) {
  auto server = get_server(server_id);
  if (!server) return -1;
  std::unique_lock<std::mutex> lk(server->fp_mu);
  bool ready = server->fp_cv.wait_for(
      lk, std::chrono::milliseconds(timeout_ms),
      [&] { return server->stopping.load() || !server->fp_queue.empty(); });
  if (!server->fp_queue.empty()) {
    int n = 0;
    while (n < max_n && !server->fp_queue.empty()) {
      FpTask& t = server->fp_queue.front();
      keys[n] = t.conn_key;
      handles[n] = t.handle;
      n++;
      server->fp_queue.pop_front();
    }
    return n;
  }
  return (ready && server->stopping.load()) ? -1 : 0;
}

namespace {

void fp_complete(Server& server, const uint64_t* keys, int n,
                 const std::function<void(int, PendingResponse&)>& fill) {
  std::vector<bool> keep(size_t(n), true);
  {
    std::lock_guard<std::mutex> lk(server.fp_mu);
    for (int i = 0; i < n; i++) {
      auto it = server.fp_keepalive.find(keys[i]);
      if (it != server.fp_keepalive.end()) {
        keep[size_t(i)] = it->second;
        server.fp_keepalive.erase(it);
      }
    }
  }
  std::vector<Completion> done;
  done.reserve(size_t(n));
  for (int i = 0; i < n; i++) {
    PendingResponse r;
    fill(i, r);
    Completion comp;
    comp.conn_key = keys[i];
    comp.close_after = !keep[size_t(i)];
    comp.bytes = build_response(r, keep[size_t(i)]);
    done.push_back(std::move(comp));
  }
  {
    // event_fd write under c_mu: stop() closes the fd under the same lock
    // after joining the io/worker threads, but the DRAINER calling this is
    // an external thread — without the lock it could write into a closed
    // or kernel-reused descriptor during shutdown
    std::lock_guard<std::mutex> lk(server.c_mu);
    for (auto& comp : done) server.completions.push_back(std::move(comp));
    uint64_t one = 1;
    ssize_t ignored = write(server.event_fd, &one, sizeof(one));
    (void)ignored;
  }
}

}  // namespace

// Answer a batch of fast-path tasks with their counts; the response JSON is
// formatted here, byte-identical to the Python router's json.dumps output.
void silo_fastpath_respond_counts(int server_id, const uint64_t* keys,
                                  const int64_t* counts, int n,
                                  const char* data_version) {
  auto server = get_server(server_id);
  if (!server) return;
  fp_complete(*server, keys, n, [&](int i, PendingResponse& r) {
    r.set = true;
    r.status = 200;
    char buf[64];
    int len = snprintf(buf, sizeof(buf), "%lld", (long long)counts[i]);
    r.body.reserve(32 + size_t(len));
    r.body += "{\"queryResult\": [{\"count\": ";
    r.body.append(buf, size_t(len));
    r.body += "}]}";
    if (data_version != nullptr) {
      r.has_data_version = true;
      r.data_version = data_version;
    }
  });
}

// Answer a batch of fast-path tasks with one shared error payload.
void silo_fastpath_respond_error(int server_id, const uint64_t* keys, int n,
                                 int status, const char* body,
                                 int64_t body_len) {
  auto server = get_server(server_id);
  if (!server) return;
  fp_complete(*server, keys, n, [&](int, PendingResponse& r) {
    r.set = true;
    r.status = status;
    r.body.assign(body, size_t(body_len));
  });
}

void silo_http_stop(int server_id) {
  std::shared_ptr<Server> server;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    if (server_id < 0 || size_t(server_id) >= g_servers.size()) return;
    server = std::move(g_servers[size_t(server_id)]);
  }
  if (server) server->stop();
}

}  // extern "C"
