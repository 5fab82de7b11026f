// HTTP load generator for the serving benchmarks.
//
// The box has 2 vCPUs: Python client threads throttle any serving
// measurement above a few thousand req/s, so load generation is native
// (the reference world benches its Poco server with external tools the
// same way). One epoll loop drives N keep-alive connections, each with one
// in-flight POST; bodies rotate per-connection through a body file
// and latencies are recorded per response.
//
// Usage: loadgen <host> <port> <path> <bodies.txt> <connections> <seconds>
// bodies.txt: one request body per line.
// Output: one JSON line {"requests":N,"elapsed_s":T,"req_per_s":R,
//                        "p50_ms":…,"p99_ms":…,"errors":E}

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <string>
#include <vector>

namespace {

double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
}

struct Conn {
  int fd = -1;
  std::string out;      // bytes still to write for the current request
  size_t out_off = 0;
  std::string in;       // response bytes accumulated
  double sent_at = 0;
  size_t next_body = 0;  // rotating index into the body list
  bool connecting = false;
};

std::vector<std::string> g_requests;  // pre-rendered full HTTP requests

std::string render_request(const std::string& host, const std::string& path,
                           const std::string& body) {
  std::string r;
  r.reserve(body.size() + 128);
  r += "POST ";
  r += path;
  r += " HTTP/1.1\r\nHost: ";
  r += host;
  r += "\r\nContent-Type: application/json\r\nContent-Length: ";
  r += std::to_string(body.size());
  r += "\r\n\r\n";
  r += body;
  return r;
}

// A complete HTTP/1.1 response (headers + content-length body) sitting at
// the front of `in`? Returns its total size, or 0 if incomplete.
size_t response_size(const std::string& in, int* status) {
  size_t head_end = in.find("\r\n\r\n");
  if (head_end == std::string::npos) return 0;
  *status = 0;
  size_t sp = in.find(' ');
  if (sp != std::string::npos && sp + 4 <= head_end)
    *status = atoi(in.c_str() + sp + 1);
  size_t cl = 0;
  const char* needles[2] = {"\r\ncontent-length:", "\r\nContent-Length:"};
  for (const char* needle : needles) {
    size_t pos = in.find(needle);
    if (pos != std::string::npos && pos < head_end) {
      cl = size_t(atoll(in.c_str() + pos + strlen(needle)));
      break;
    }
  }
  size_t total = head_end + 4 + cl;
  return in.size() >= total ? total : 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 7) {
    fprintf(stderr,
            "usage: %s <host> <port> <path> <bodies.txt> <conns> <secs>\n",
            argv[0]);
    return 2;
  }
  const char* host = argv[1];
  int port = atoi(argv[2]);
  const char* path = argv[3];
  const char* bodies_path = argv[4];
  int n_conns = atoi(argv[5]);
  double seconds = atof(argv[6]);

  std::vector<std::string> bodies;
  {
    FILE* f = fopen(bodies_path, "rb");
    if (!f) { perror("bodies"); return 2; }
    std::string line;
    int ch;
    while ((ch = fgetc(f)) != EOF) {
      if (ch == '\n') {
        if (!line.empty()) bodies.push_back(line);
        line.clear();
      } else {
        line.push_back(char(ch));
      }
    }
    if (!line.empty()) bodies.push_back(line);
    fclose(f);
  }
  if (bodies.empty()) { fprintf(stderr, "no bodies\n"); return 2; }
  g_requests.reserve(bodies.size());
  for (auto& b : bodies) g_requests.push_back(render_request(host, path, b));

  sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    fprintf(stderr, "host must be an IPv4 address\n");
    return 2;
  }

  int ep = epoll_create1(0);
  std::vector<Conn> conns{size_t(n_conns)};
  long errors = 0;

  auto start_request = [&](int ci) {
    Conn& c = conns[size_t(ci)];
    c.out = g_requests[(c.next_body + size_t(ci)) % g_requests.size()];
    c.next_body += size_t(n_conns);  // distinct rotation per connection
    c.out_off = 0;
    c.in.clear();
    c.sent_at = now_s();
    epoll_event ev;
    ev.events = EPOLLOUT | EPOLLIN;
    ev.data.u32 = uint32_t(ci);
    epoll_ctl(ep, EPOLL_CTL_MOD, c.fd, &ev);
  };

  auto open_conn = [&](int ci) -> bool {
    Conn& c = conns[size_t(ci)];
    c.fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (c.fd < 0) return false;
    int one = 1;
    setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    int rc = connect(c.fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    c.connecting = (rc < 0 && errno == EINPROGRESS);
    if (rc < 0 && !c.connecting) { close(c.fd); c.fd = -1; return false; }
    epoll_event ev;
    ev.events = EPOLLOUT | EPOLLIN;
    ev.data.u32 = uint32_t(ci);
    epoll_ctl(ep, EPOLL_CTL_ADD, c.fd, &ev);
    return true;
  };

  for (int i = 0; i < n_conns; i++) {
    if (!open_conn(i)) { fprintf(stderr, "connect failed\n"); return 2; }
    start_request(i);
  }

  std::vector<double> latencies;
  latencies.reserve(1 << 20);
  double t0 = now_s();
  double deadline = t0 + seconds;
  std::vector<epoll_event> events(1024);
  char buf[1 << 16];

  while (true) {
    double left = deadline - now_s();
    if (left <= 0) break;
    int n = epoll_wait(ep, events.data(), int(events.size()),
                       std::max(1, int(left * 1000)));
    for (int e = 0; e < n; e++) {
      int ci = int(events[size_t(e)].data.u32);
      Conn& c = conns[size_t(ci)];
      if (c.fd < 0) continue;
      uint32_t flags = events[size_t(e)].events;
      if (flags & (EPOLLERR | EPOLLHUP)) {
        errors++;
        epoll_ctl(ep, EPOLL_CTL_DEL, c.fd, nullptr);
        close(c.fd);
        c.fd = -1;
        if (open_conn(ci)) start_request(ci);
        continue;
      }
      if ((flags & EPOLLOUT) && c.out_off < c.out.size()) {
        c.connecting = false;
        ssize_t w = send(c.fd, c.out.data() + c.out_off,
                         c.out.size() - c.out_off, MSG_NOSIGNAL);
        if (w > 0) c.out_off += size_t(w);
        if (c.out_off == c.out.size()) {
          epoll_event ev;
          ev.events = EPOLLIN;
          ev.data.u32 = uint32_t(ci);
          epoll_ctl(ep, EPOLL_CTL_MOD, c.fd, &ev);
        }
      }
      if (flags & EPOLLIN) {
        while (true) {
          ssize_t r = recv(c.fd, buf, sizeof(buf), 0);
          if (r > 0) {
            c.in.append(buf, size_t(r));
            continue;
          }
          if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
          // peer closed (or error): recycle the connection
          errors += (c.out_off < c.out.size() || !c.in.empty()) ? 1 : 0;
          epoll_ctl(ep, EPOLL_CTL_DEL, c.fd, nullptr);
          close(c.fd);
          c.fd = -1;
          break;
        }
        if (c.fd < 0) {
          if (open_conn(ci)) start_request(ci);
          continue;
        }
        int status = 0;
        size_t total = response_size(c.in, &status);
        if (total) {
          if (status == 200) latencies.push_back(now_s() - c.sent_at);
          else errors++;
          start_request(ci);  // next body on the same keep-alive connection
        }
      }
    }
  }
  double elapsed = now_s() - t0;
  for (auto& c : conns)
    if (c.fd >= 0) close(c.fd);
  close(ep);

  std::sort(latencies.begin(), latencies.end());
  size_t cnt = latencies.size();
  double p50 = cnt ? latencies[cnt / 2] * 1e3 : 0;
  double p99 = cnt ? latencies[size_t(double(cnt) * 0.99)] * 1e3 : 0;
  printf(
      "{\"requests\": %zu, \"elapsed_s\": %.3f, \"req_per_s\": %.1f, "
      "\"p50_ms\": %.3f, \"p99_ms\": %.3f, \"errors\": %ld}\n",
      cnt, elapsed, double(cnt) / elapsed, p50, p99, errors);
  return 0;
}
