// Thread-stress harness for the native engine, built with -fsanitize=thread
// by tests/test_torch_tsan.py. The reference has an actual data race on a shared
// latency slice (ssd_test/main.go:80, all goroutines append to one slice);
// this engine's contract is caller-owned PER-THREAD latency arrays and
// per-thread buffers — this harness drives that contract hard under TSAN:
// N threads share one read-only offsets table (the reference shared its
// offset pattern too, ssd_test/main.go:133) but write only their own
// buffers/latency arrays. Any aliasing bug in the engine shows up as a
// ThreadSanitizer report, failing the test.
//
// The reactor phases at the bottom extend the matrix to the TLS and
// HTTP/2 state machines: h2c exactly-once multiplexing against a canned
// in-file server, mid-handshake plaintext garbage, pre-handshake RSTs,
// and pool destroy with handshakes still in flight.
//
// Exit 0 + no TSAN output = clean.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <atomic>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sched.h>
#include <unistd.h>

extern "C" {
int64_t tb_now_ns();
void* tb_alloc_aligned(size_t size, size_t align);
void tb_free_aligned(void* p);
int tb_open(const char* path, int flags, int* direct_applied);
int tb_close(int fd);
int64_t tb_pread_blocks(int fd, void* buf, int64_t block_size,
                        const int64_t* offsets, int64_t n_offsets,
                        int64_t* lat_ns);
int64_t tb_pwrite_blocks(int fd, const void* buf, int64_t block_size,
                         const int64_t* offsets, int64_t n_offsets,
                         int fsync_each, int64_t* lat_ns);
void tb_fill_random(void* buf, int64_t n, uint64_t seed);
void* tb_dlpack_create(void* data, int64_t rows, int64_t cols, void* deleter);
void tb_dlpack_free(void* managed);
int64_t tb_pool_create(int threads, int cap, int tls,
                       const char* cafile, int insecure);
int64_t tb_pool_create2(int threads, int cap, int tls,
                        const char* cafile, int insecure, int mode);
int tb_pool_is_reactor(int64_t h);
int tb_pool_ring_next_batch(int64_t h, int timeout_ms, int max_n,
                            uint64_t* tags, int64_t* results, int* statuses,
                            int64_t* fbs, int64_t* totals, int64_t* starts);
int tb_pool_submit(int64_t h, const char* host, int port, const char* path,
                   const char* headers, void* buf, int64_t buf_len,
                   uint64_t tag);
int tb_pool_next_batch(int64_t h, int timeout_ms, int max_n, uint64_t* tags,
                       int64_t* results, int* statuses, int64_t* fbs,
                       int64_t* totals, int64_t* starts);
int tb_pool_next(int64_t h, int timeout_ms, uint64_t* tag, int64_t* result,
                 int* status, int64_t* fb, int64_t* total, int64_t* start);
int tb_pool_destroy(int64_t h);
void* tb_srv_start(const void* body, int64_t body_len, const char* meta_json,
                   int* port_out);
int tb_srv_stop(void* handle);
int tb_tls_available();
}

// Minimal single-purpose HTTP server for the pool stress: keep-alive —
// each accepted connection serves up to 4 requests (so the pool workers'
// per-thread connection REUSE path runs), then closes (so the reconnect
// path runs too).
static int g_srv_fd = -1;

static void handle_conn(int c) {
  for (int served = 0; served < 4; served++) {
    char req[2048];
    ssize_t n = 0, got = 0;
    bool have = false;
    while (got < static_cast<ssize_t>(sizeof req) &&
           (n = recv(c, req + got, sizeof req - got, 0)) > 0) {
      got += n;
      if (memmem(req, got, "\r\n\r\n", 4)) {
        have = true;
        break;
      }
    }
    if (!have) break;  // peer closed between requests
    const bool last = served == 3;
    char resp[256];
    int m = snprintf(resp, sizeof resp,
                     "HTTP/1.1 200 OK\r\nContent-Length: 16\r\n%s\r\n"
                     "0123456789abcdef",
                     last ? "Connection: close\r\n" : "");
    send(c, resp, m, 0);
    if (last) break;
  }
  close(c);
}

static void serve_loop() {
  // One handler thread per connection: a serial server deadlocks with
  // keep-alive pool workers (worker A idles between requests on its held
  // connection while B/C/D block behind it in the backlog). Handlers are
  // joined before returning; they unblock when the peer closes.
  std::vector<std::thread> handlers;
  for (;;) {
    int c = accept(g_srv_fd, nullptr, nullptr);
    if (c < 0) break;  // listener shut down
    handlers.emplace_back(handle_conn, c);
  }
  for (auto& h : handlers) h.join();
}

// Fetch-pool stress: 2 submitter threads race 64 tasks into a 4-worker
// pool against the in-process keep-alive server while the main thread
// drains — the pool's mutex/condvar/ring accounting plus the workers'
// connection-reuse and reconnect paths all run under TSAN.
static int stress_fetch_pool() {
  g_srv_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (g_srv_fd < 0) return 1;
  int one = 1;
  setsockopt(g_srv_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in a;
  memset(&a, 0, sizeof a);
  a.sin_family = AF_INET;
  a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  a.sin_port = 0;
  if (bind(g_srv_fd, reinterpret_cast<struct sockaddr*>(&a), sizeof a) != 0) {
    close(g_srv_fd);
    return 2;
  }
  socklen_t alen = sizeof a;
  getsockname(g_srv_fd, reinterpret_cast<struct sockaddr*>(&a), &alen);
  int port = ntohs(a.sin_port);
  listen(g_srv_fd, 16);
  std::thread srv(serve_loop);

  // Every exit path below must stop the listener and join srv — a
  // joinable std::thread destroyed alive calls std::terminate.
  auto stop_server = [&]() {
    shutdown(g_srv_fd, SHUT_RDWR);  // close() alone does not wake accept()
    close(g_srv_fd);
    srv.join();
  };

  const int kTasks = 64;
  int64_t pool = tb_pool_create(4, 32, 0, "", 0);
  if (pool == 0) {
    stop_server();
    return 3;
  }
  std::vector<void*> bufs(kTasks);
  for (int i = 0; i < kTasks; i++) bufs[i] = tb_alloc_aligned(4096, 4096);

  std::atomic<int> submitted{0};
  std::atomic<int> done_submitters{0};
  std::atomic<bool> submit_failed{false};
  std::vector<std::thread> submitters;
  for (int si = 0; si < 2; si++) {
    submitters.emplace_back([&, si]() {
      for (int i = si; i < kTasks; i += 2) {
        for (;;) {
          int rc = tb_pool_submit(pool, "127.0.0.1", port, "/x", "",
                                  bufs[i], 4096, i);
          if (rc == 0) break;
          if (rc == -EAGAIN) {
            // Ring full (64 tasks vs cap 32): the MAIN thread drains
            // concurrently; yield instead of hammering the pool mutex.
            sched_yield();
            continue;
          }
          submit_failed.store(true);  // hard error: stop submitting
          done_submitters.fetch_add(1);
          return;
        }
        submitted.fetch_add(1);
      }
      done_submitters.fetch_add(1);
    });
  }
  // Drain CONCURRENTLY with submission (the ring is smaller than the
  // task count, so a submit-then-drain sequence would deadlock). Done
  // when everything submitted has drained and both submitters finished —
  // a hard submit error just shrinks the total instead of turning into
  // 30s-per-missing-task timeouts.
  // Alternate the single and BATCHED drain paths so TSAN sees both
  // completion handoffs racing the submitters.
  int drained = 0;
  int bad = 0;
  bool use_batch = false;
  for (;;) {
    if (drained == kTasks) break;
    if (done_submitters.load() == 2 && drained >= submitted.load()) break;
    if (use_batch) {
      uint64_t tags[8];
      int64_t results[8], fbs[8], totals[8], starts[8];
      int statuses[8];
      int n = tb_pool_next_batch(pool, 30000, 8, tags, results, statuses,
                                 fbs, totals, starts);
      if (n <= 0) {  // stall: bail with a failure instead of hanging
        bad++;
        break;
      }
      for (int i = 0; i < n; i++)
        if (results[i] != 16 || statuses[i] != 200) bad++;
      drained += n;
    } else {
      uint64_t tag;
      int64_t result, fb, total, start;
      int status;
      int rc = tb_pool_next(pool, 30000, &tag, &result, &status, &fb,
                            &total, &start);
      if (rc != 1) {  // stall: bail with a failure instead of hanging
        bad++;
        break;
      }
      if (result != 16 || status != 200) bad++;
      drained++;
    }
    use_batch = !use_batch;
  }
  for (auto& t : submitters) t.join();
  if (submit_failed.load()) bad++;
  tb_pool_destroy(pool);
  for (auto b : bufs) tb_free_aligned(b);
  stop_server();
  return bad ? 10 : 0;
}

// C loopback server + discard-mode stress: the fetch pool's 4 workers
// hammer tb_srv_* with a mix of ranged media GETs (landed + content-
// checked), discard tasks (NULL buffer → per-thread scratch), and
// metadata GETs — both new concurrency surfaces (server conn threads,
// worker discard scratch) race under TSAN, and the stop protocol's
// tracked-connection shutdown runs at the end.
static int stress_srv_and_discard() {
  const int64_t kBody = 1 << 20;
  uint8_t* body = static_cast<uint8_t*>(tb_alloc_aligned(kBody, 4096));
  if (!body) return 1;
  tb_fill_random(body, kBody, 77);
  int port = 0;
  void* srv = tb_srv_start(body, kBody, "{\"size\": \"1048576\"}", &port);
  if (!srv) {
    tb_free_aligned(body);
    return 2;
  }
  const int kTasks = 48;
  int64_t pool = tb_pool_create(4, 64, 0, "", 0);
  if (!pool) {
    tb_srv_stop(srv);
    tb_free_aligned(body);
    return 3;
  }
  std::vector<void*> bufs(kTasks, nullptr);
  std::vector<int> starts(kTasks, 0);
  const char* media = "/storage/v1/b/b/o/x?alt=media";
  int bad = 0;
  int submitted_ok = 0;  // drain exactly what actually enqueued
  for (int i = 0; i < kTasks; i++) {
    int rc;
    if (i % 3 == 0) {  // discard full-media (NULL buffer)
      rc = tb_pool_submit(pool, "127.0.0.1", port, media, "", nullptr, 0, i);
    } else if (i % 3 == 1) {  // ranged media, landed + verified below
      bufs[i] = tb_alloc_aligned(65536, 4096);
      if (!bufs[i]) {  // NULL means DISCARD to the pool: never submit it
        bad++;
        continue;
      }
      starts[i] = (i * 4096) % (1 << 19);
      char hdrs[64];
      snprintf(hdrs, sizeof hdrs, "Range: bytes=%d-%d\r\n", starts[i],
               starts[i] + 65535);
      rc = tb_pool_submit(pool, "127.0.0.1", port, media, hdrs, bufs[i],
                          65536, i);
    } else {  // metadata JSON
      bufs[i] = tb_alloc_aligned(4096, 4096);
      if (!bufs[i]) {
        bad++;
        continue;
      }
      rc = tb_pool_submit(pool, "127.0.0.1", port, "/storage/v1/b/b/o/x", "",
                          bufs[i], 4096, i);
    }
    if (rc)
      bad++;
    else
      submitted_ok++;
  }
  for (int n = 0; n < submitted_ok; n++) {
    uint64_t tag;
    int64_t result, fb, total, start;
    int status;
    int rc = tb_pool_next(pool, 30000, &tag, &result, &status, &fb, &total,
                          &start);
    if (rc != 1) {
      bad++;
      break;
    }
    int i = static_cast<int>(tag);
    if (i % 3 == 0) {
      if (result != kBody || status != 200) bad++;
    } else if (i % 3 == 1) {
      if (result != 65536 || status != 206 ||
          memcmp(bufs[i], body + starts[i], 65536) != 0)
        bad++;
    } else {
      if (result <= 0 || status != 200) bad++;
    }
  }
  tb_pool_destroy(pool);
  int leaked = tb_srv_stop(srv);
  for (auto b : bufs)
    if (b) tb_free_aligned(b);
  if (!leaked) tb_free_aligned(body);  // leak contract: keep body pinned
  return bad ? 20 : 0;
}

// Abrupt keep-alive server: serves 2 responses per connection WITHOUT a
// "Connection: close" announcement, then closes — the peer sees a bare
// FIN on a conn it believed reusable. This is the stale-keep-alive
// shape that triggers (a) the batch-edge deferred conn free (a FIN
// event and a reuse race in one epoll batch) and (b) the fresh-socket
// retransmit contract.
static int g_srv2_fd = -1;

static void handle_conn_abrupt(int c) {
  for (int served = 0; served < 2; served++) {
    char req[2048];
    ssize_t n = 0, got = 0;
    bool have = false;
    while (got < static_cast<ssize_t>(sizeof req) &&
           (n = recv(c, req + got, sizeof req - got, 0)) > 0) {
      got += n;
      if (memmem(req, got, "\r\n\r\n", 4)) {
        have = true;
        break;
      }
    }
    if (!have) break;
    const char* resp =
        "HTTP/1.1 200 OK\r\nContent-Length: 16\r\n\r\n0123456789abcdef";
    send(c, resp, strlen(resp), 0);
  }
  close(c);  // unannounced: keep-alive peers must survive the bare FIN
}

static void serve_loop_abrupt() {
  std::vector<std::thread> handlers;
  for (;;) {
    int c = accept(g_srv2_fd, nullptr, nullptr);
    if (c < 0) break;
    handlers.emplace_back(handle_conn_abrupt, c);
  }
  for (auto& h : handlers) h.join();
}

// Reactor vs the abrupt server: single-threaded submit/drain interleave
// (the ring cap forces -EAGAIN backpressure) with every completion
// REQUIRED to succeed — a stale FIN racing connection reuse must end in
// a fresh-socket retransmit, never a surfaced error — and exactly-once
// delivery asserted. The FIN-vs-reuse races also hammer the batch-edge
// deferred conn free under TSAN.
static int stress_reactor_stale_churn() {
  g_srv2_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (g_srv2_fd < 0) return 1;
  int one = 1;
  setsockopt(g_srv2_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in a;
  memset(&a, 0, sizeof a);
  a.sin_family = AF_INET;
  a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  a.sin_port = 0;
  if (bind(g_srv2_fd, reinterpret_cast<struct sockaddr*>(&a), sizeof a) != 0) {
    close(g_srv2_fd);
    return 2;
  }
  socklen_t alen = sizeof a;
  getsockname(g_srv2_fd, reinterpret_cast<struct sockaddr*>(&a), &alen);
  int port = ntohs(a.sin_port);
  listen(g_srv2_fd, 16);
  std::thread srv(serve_loop_abrupt);

  const int kTasks = 96;
  int64_t pool = tb_pool_create2(3, 24, 0, "", 0, 1);
  int bad = 0;
  std::vector<int> seen(kTasks, 0);
  std::vector<void*> bufs(kTasks, nullptr);
  if (!pool) {
    bad = 100;
  } else {
    int next = 0, drained = 0;
    auto drain_some = [&](int timeout_ms) {
      uint64_t tags[8];
      int64_t results[8], fbs[8], totals[8], starts[8];
      int statuses[8];
      int n = tb_pool_ring_next_batch(pool, timeout_ms, 8, tags, results,
                                      statuses, fbs, totals, starts);
      for (int i = 0; i < n; i++) {
        int t = static_cast<int>(tags[i]);
        if (t < 0 || t >= kTasks || seen[t]++) {
          bad++;
          continue;
        }
        // Success REQUIRED: stale FINs must be absorbed by the
        // fresh-socket retransmit, not surfaced.
        if (results[i] != 16 || statuses[i] != 200) bad++;
      }
      return n;
    };
    while (drained < kTasks) {
      while (next < kTasks) {
        void* b = tb_alloc_aligned(4096, 4096);
        if (!b) {
          bad++;
          break;
        }
        int rc = tb_pool_submit(pool, "127.0.0.1", port, "/x", "", b, 4096,
                                next);
        if (rc == -EAGAIN) {
          tb_free_aligned(b);
          break;  // backpressure: drain below
        }
        if (rc != 0) {
          tb_free_aligned(b);
          bad++;
          break;
        }
        bufs[next++] = b;
      }
      int n = drain_some(30000);
      if (n <= 0) {
        bad++;  // stall: bail instead of hanging
        break;
      }
      drained += n;
    }
    tb_pool_destroy(pool);
  }
  shutdown(g_srv2_fd, SHUT_RDWR);
  close(g_srv2_fd);
  srv.join();
  for (auto b : bufs)
    if (b) tb_free_aligned(b);
  return bad ? 50 : 0;
}

// Reactor stress: 2 submitter threads race a mixed task set (landed +
// content-checked ranges, discard, metadata) into the epoll reactor
// against the all-native loopback server while the main thread drains
// through MIXED single/batched paths (tb_pool_next, tb_pool_next_batch,
// tb_pool_ring_next_batch) — the SPSC ring handoff, the doorbell
// eventfd, the submit inbox and the loop's connection state machines
// all race under TSAN, and EXACTLY-ONCE delivery is asserted on a tag
// bitmap (a duplicated or lost completion is a correctness bug, not
// just a race).
static int stress_reactor() {
  const int64_t kBody = 1 << 20;
  uint8_t* body = static_cast<uint8_t*>(tb_alloc_aligned(kBody, 4096));
  if (!body) return 1;
  tb_fill_random(body, kBody, 99);
  int port = 0;
  void* srv = tb_srv_start(body, kBody, "{\"size\": \"1048576\"}", &port);
  if (!srv) {
    tb_free_aligned(body);
    return 2;
  }
  const int kTasks = 64;
  // 2 event loops, 6-connection budget, cap 32 < kTasks so the -EAGAIN
  // admission path races the drain too.
  int64_t pool = tb_pool_create2(6, 32, 0, "", 0, 1 | (2 << 8));
  int bad = 0;
  if (!pool || !tb_pool_is_reactor(pool)) {
    tb_srv_stop(srv);
    tb_free_aligned(body);
    return 3;
  }
  std::vector<void*> bufs(kTasks, nullptr);
  std::vector<int> starts(kTasks, 0);
  const char* media = "/storage/v1/b/b/o/x?alt=media";
  std::atomic<int> submitted{0};
  std::atomic<int> done_submitters{0};
  std::atomic<bool> submit_failed{false};
  std::vector<std::thread> submitters;
  for (int si = 0; si < 2; si++) {
    submitters.emplace_back([&, si]() {
      for (int i = si; i < kTasks; i += 2) {
        int rc;
        if (i % 3 == 1) {
          bufs[i] = tb_alloc_aligned(65536, 4096);
          if (!bufs[i]) {
            submit_failed.store(true);
            continue;
          }
          starts[i] = (i * 4096) % (1 << 19);
        } else if (i % 3 == 2) {
          bufs[i] = tb_alloc_aligned(4096, 4096);
          if (!bufs[i]) {
            submit_failed.store(true);
            continue;
          }
        }
        for (;;) {
          if (i % 3 == 0) {
            rc = tb_pool_submit(pool, "127.0.0.1", port, media, "", nullptr,
                                0, i);
          } else if (i % 3 == 1) {
            char hdrs[64];
            snprintf(hdrs, sizeof hdrs, "Range: bytes=%d-%d\r\n", starts[i],
                     starts[i] + 65535);
            rc = tb_pool_submit(pool, "127.0.0.1", port, media, hdrs,
                                bufs[i], 65536, i);
          } else {
            rc = tb_pool_submit(pool, "127.0.0.1", port,
                                "/storage/v1/b/b/o/x", "", bufs[i], 4096, i);
          }
          if (rc == 0) break;
          if (rc == -EAGAIN) {
            sched_yield();  // main thread drains concurrently
            continue;
          }
          submit_failed.store(true);
          break;
        }
        if (rc == 0) submitted.fetch_add(1);
      }
      done_submitters.fetch_add(1);
    });
  }
  // Exactly-once ledger: each tag must come back exactly once.
  std::vector<int> seen(kTasks, 0);
  int drained = 0;
  int which = 0;
  for (;;) {
    if (done_submitters.load() == 2 && drained >= submitted.load()) break;
    uint64_t tags[8];
    int64_t results[8], fbs[8], totals[8], st_ns[8];
    int statuses[8];
    int n;
    if (which == 0) {
      int rc = tb_pool_next(pool, 30000, &tags[0], &results[0], &statuses[0],
                            &fbs[0], &totals[0], &st_ns[0]);
      n = rc == 1 ? 1 : rc;
    } else if (which == 1) {
      n = tb_pool_next_batch(pool, 30000, 8, tags, results, statuses, fbs,
                             totals, st_ns);
    } else {
      n = tb_pool_ring_next_batch(pool, 30000, 8, tags, results, statuses,
                                  fbs, totals, st_ns);
    }
    which = (which + 1) % 3;
    if (n <= 0) {
      if (done_submitters.load() == 2 && drained >= submitted.load()) break;
      bad++;  // stall: bail instead of hanging
      break;
    }
    for (int i = 0; i < n; i++) {
      int t = static_cast<int>(tags[i]);
      if (t < 0 || t >= kTasks || seen[t]++) {
        bad++;  // duplicate or junk tag: delivery not exactly-once
        continue;
      }
      if (t % 3 == 0) {
        if (results[i] != kBody || statuses[i] != 200) bad++;
      } else if (t % 3 == 1) {
        if (results[i] != 65536 || statuses[i] != 206 ||
            memcmp(bufs[t], body + starts[t], 65536) != 0)
          bad++;
      } else {
        if (results[i] <= 0 || statuses[i] != 200) bad++;
      }
    }
    drained += n;
  }
  for (auto& t : submitters) t.join();
  if (submit_failed.load()) bad++;
  for (int t = 0; t < kTasks; t++)
    if (seen[t] > 1) bad++;  // belt+braces: ledger re-check after joins
  tb_pool_destroy(pool);
  int leaked = tb_srv_stop(srv);
  for (auto b : bufs)
    if (b) tb_free_aligned(b);
  if (!leaked) tb_free_aligned(body);
  return bad ? 30 : 0;
}

// Destroy-ordering hammer: create → submit (leaving work IN FLIGHT) →
// destroy, in a tight loop. tb_pool_destroy must drain the doorbell and
// rings and join every loop thread BEFORE freeing — the shutdown
// ordering the thread-per-connection teardown never had a test for. A
// use-after-free here is a TSAN/ASAN report or a crash; a missed join
// is a leaked-thread wreck on iteration 2.
static int stress_reactor_destroy_hammer() {
  const int64_t kBody = 512 * 1024;
  uint8_t* body = static_cast<uint8_t*>(tb_alloc_aligned(kBody, 4096));
  if (!body) return 1;
  tb_fill_random(body, kBody, 123);
  int port = 0;
  void* srv = tb_srv_start(body, kBody, "{\"size\": \"524288\"}", &port);
  if (!srv) {
    tb_free_aligned(body);
    return 2;
  }
  const char* media = "/storage/v1/b/b/o/x?alt=media";
  int bad = 0;
  for (int it = 0; it < 12; it++) {
    int64_t pool = tb_pool_create2(4, 16, 0, "", 0, 1 | ((it % 2 + 1) << 8));
    if (!pool) {
      bad++;
      continue;
    }
    for (int i = 0; i < 8; i++)
      tb_pool_submit(pool, "127.0.0.1", port, media, "", nullptr, 0, i);
    // Vary how much settles before the teardown races the in-flight
    // wakes: drain nothing / one / a small batch.
    if (it % 3 == 1) {
      uint64_t tag;
      int64_t result, fb, total, start;
      int status;
      tb_pool_next(pool, 50, &tag, &result, &status, &fb, &total, &start);
    } else if (it % 3 == 2) {
      uint64_t tags[4];
      int64_t results[4], fbs[4], totals[4], starts2[4];
      int statuses[4];
      tb_pool_ring_next_batch(pool, 50, 4, tags, results, statuses, fbs,
                              totals, starts2);
    }
    if (tb_pool_destroy(pool) != 0) bad++;
  }
  int leaked = tb_srv_stop(srv);
  if (!leaked) tb_free_aligned(body);  // leak contract: keep body pinned
  return bad ? 40 : 0;
}

// Loopback listener helper for the TLS/h2 reactor phases below (the
// earlier phases predate it and keep their inline setup).
static int mk_listener(int* fd_out, int* port_out) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in a;
  memset(&a, 0, sizeof a);
  a.sin_family = AF_INET;
  a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  a.sin_port = 0;
  if (bind(fd, reinterpret_cast<struct sockaddr*>(&a), sizeof a) != 0) {
    close(fd);
    return -1;
  }
  socklen_t alen = sizeof a;
  getsockname(fd, reinterpret_cast<struct sockaddr*>(&a), &alen);
  listen(fd, 16);
  *fd_out = fd;
  *port_out = ntohs(a.sin_port);
  return 0;
}

// TLS reactor vs a server that answers the ClientHello with PLAINTEXT
// GARBAGE mid-handshake: every task must settle with a surfaced error
// (TB_ETLS is permanent — no retransmit storm, no hang), exactly once,
// and the nonblocking handshake state machine's error path plus the
// SSL teardown run under the sanitizer.
static int stress_reactor_tls_midreset() {
  if (!tb_tls_available()) return 0;  // no OpenSSL in this image: skip
  int lfd = -1, port = 0;
  if (mk_listener(&lfd, &port)) return 1;
  std::thread srv([lfd]() {
    std::vector<std::thread> handlers;
    for (;;) {
      int c = accept(lfd, nullptr, nullptr);
      if (c < 0) break;
      handlers.emplace_back([c]() {
        char b[512];
        recv(c, b, sizeof b, 0);  // swallow (part of) the ClientHello
        const char* junk = "HTTP/1.1 400 this is not TLS\r\n\r\n";
        send(c, junk, strlen(junk), 0);
        close(c);
      });
    }
    for (auto& h : handlers) h.join();
  });
  const int kTasks = 12;
  int64_t pool = tb_pool_create2(2, 16, 1, "", 1, 1);
  int bad = 0;
  std::vector<void*> bufs(kTasks, nullptr);
  std::vector<int> seen(kTasks, 0);
  if (!pool) {
    bad = 100;
  } else {
    int ok_sub = 0;
    for (int i = 0; i < kTasks; i++) {
      bufs[i] = tb_alloc_aligned(4096, 4096);
      if (!bufs[i]) {
        bad++;
        continue;
      }
      if (tb_pool_submit(pool, "127.0.0.1", port, "/x", "", bufs[i], 4096, i))
        bad++;
      else
        ok_sub++;
    }
    for (int n = 0; n < ok_sub; n++) {
      uint64_t tag;
      int64_t result, fb, total, start;
      int status;
      int rc = tb_pool_next(pool, 30000, &tag, &result, &status, &fb, &total,
                            &start);
      if (rc != 1) {  // stall: bail instead of hanging
        bad++;
        break;
      }
      int t = static_cast<int>(tag);
      if (t < 0 || t >= kTasks || seen[t]++) {
        bad++;
        continue;
      }
      if (result >= 0) bad++;  // garbage-for-TLS MUST surface as an error
    }
    tb_pool_destroy(pool);
  }
  shutdown(lfd, SHUT_RDWR);
  close(lfd);
  srv.join();
  for (auto b : bufs)
    if (b) tb_free_aligned(b);
  return bad ? 60 : 0;
}

// TLS reactor vs a server that RSTs every accepted connection before a
// single handshake byte flows (SO_LINGER{1,0} close): the reset lands
// in C_CONNECTING or C_TLS_HANDSHAKE depending on timing, and either
// way each task must settle exactly once — fresh-connection failures
// surface, they never loop the retransmit rule.
static int stress_reactor_tls_reset() {
  if (!tb_tls_available()) return 0;
  int lfd = -1, port = 0;
  if (mk_listener(&lfd, &port)) return 1;
  std::thread srv([lfd]() {
    for (;;) {
      int c = accept(lfd, nullptr, nullptr);
      if (c < 0) break;
      struct linger lg;
      lg.l_onoff = 1;
      lg.l_linger = 0;
      setsockopt(c, SOL_SOCKET, SO_LINGER, &lg, sizeof lg);
      close(c);  // RST, not FIN
    }
  });
  const int kTasks = 12;
  int64_t pool = tb_pool_create2(2, 16, 1, "", 1, 1);
  int bad = 0;
  std::vector<int> seen(kTasks, 0);
  if (!pool) {
    bad = 100;
  } else {
    int ok_sub = 0;
    for (int i = 0; i < kTasks; i++) {
      if (tb_pool_submit(pool, "127.0.0.1", port, "/x", "", nullptr, 0, i))
        bad++;
      else
        ok_sub++;
    }
    for (int n = 0; n < ok_sub; n++) {
      uint64_t tag;
      int64_t result, fb, total, start;
      int status;
      int rc = tb_pool_next(pool, 30000, &tag, &result, &status, &fb, &total,
                            &start);
      if (rc != 1) {
        bad++;
        break;
      }
      int t = static_cast<int>(tag);
      if (t < 0 || t >= kTasks || seen[t]++) {
        bad++;
        continue;
      }
      if (result >= 0) bad++;  // the RST must surface, not succeed
    }
    tb_pool_destroy(pool);
  }
  shutdown(lfd, SHUT_RDWR);
  close(lfd);
  srv.join();
  return bad ? 70 : 0;
}

// Destroy-with-handshake-in-flight: the server accepts and then says
// NOTHING, so every connection parks in C_TLS_HANDSHAKE waiting for a
// ServerHello that never comes — and tb_pool_destroy tears the reactor
// down mid-handshake, repeatedly. SSL objects owned by half-open
// connections must be freed exactly once (ASAN), and the loop join
// must not race the in-flight wakes (TSAN).
static int stress_reactor_tls_destroy_inflight() {
  if (!tb_tls_available()) return 0;
  int lfd = -1, port = 0;
  if (mk_listener(&lfd, &port)) return 1;
  std::thread srv([lfd]() {
    std::vector<int> conns;
    for (;;) {
      int c = accept(lfd, nullptr, nullptr);
      if (c < 0) break;
      conns.push_back(c);  // hold silently: the handshake never advances
    }
    for (int c : conns) close(c);
  });
  int bad = 0;
  for (int it = 0; it < 6; it++) {
    int64_t pool = tb_pool_create2(2, 16, 1, "", 1, 1 | ((it % 2 + 1) << 8));
    if (!pool) {
      bad++;
      continue;
    }
    for (int i = 0; i < 6; i++)
      tb_pool_submit(pool, "127.0.0.1", port, "/x", "", nullptr, 0, i);
    if (it % 2) {  // sometimes give the handshakes a beat to get airborne
      uint64_t tag;
      int64_t result, fb, total, start;
      int status;
      tb_pool_next(pool, 20, &tag, &result, &status, &fb, &total, &start);
    }
    if (tb_pool_destroy(pool) != 0) bad++;
  }
  shutdown(lfd, SHUT_RDWR);
  close(lfd);
  srv.join();
  return bad ? 80 : 0;
}

// Minimal canned h2c server for the multiplexing stress: consume the
// client preface, speak just enough HTTP/2 (SETTINGS + ACK, canned
// ":status 200" HEADERS and a 16-byte END_STREAM DATA per request
// stream) to complete real streams. Everything else (WINDOW_UPDATE,
// PRIORITY) is read and ignored.
static void h2c_handle(int c) {
  uint8_t buf[65536];
  size_t got = 0;
  while (got < 24) {  // client connection preface
    ssize_t n = recv(c, buf + got, sizeof buf - got, 0);
    if (n <= 0) {
      close(c);
      return;
    }
    got += static_cast<size_t>(n);
  }
  uint8_t sf[9] = {0, 0, 0, 4, 0, 0, 0, 0, 0};  // empty server SETTINGS
  send(c, sf, sizeof sf, 0);
  memmove(buf, buf + 24, got - 24);
  got -= 24;
  for (;;) {
    while (got < 9) {
      ssize_t n = recv(c, buf + got, sizeof buf - got, 0);
      if (n <= 0) {
        close(c);
        return;
      }
      got += static_cast<size_t>(n);
    }
    size_t flen = static_cast<size_t>(buf[0]) << 16 |
                  static_cast<size_t>(buf[1]) << 8 | buf[2];
    uint8_t ftype = buf[3], fflags = buf[4];
    uint32_t sid = (static_cast<uint32_t>(buf[5]) << 24 |
                    static_cast<uint32_t>(buf[6]) << 16 |
                    static_cast<uint32_t>(buf[7]) << 8 | buf[8]) &
                   0x7fffffffu;
    if (9 + flen > sizeof buf) {
      close(c);
      return;
    }
    while (got < 9 + flen) {
      ssize_t n = recv(c, buf + got, sizeof buf - got, 0);
      if (n <= 0) {
        close(c);
        return;
      }
      got += static_cast<size_t>(n);
    }
    if (ftype == 4 && !(fflags & 0x1)) {  // SETTINGS: ACK it
      uint8_t ack[9] = {0, 0, 0, 4, 1, 0, 0, 0, 0};
      send(c, ack, sizeof ack, 0);
    } else if (ftype == 1) {  // HEADERS: canned 200 + END_STREAM DATA
      uint8_t resp[9 + 1 + 9 + 16];
      resp[0] = 0; resp[1] = 0; resp[2] = 1;    // HEADERS, len 1
      resp[3] = 1; resp[4] = 0x4;               // END_HEADERS
      resp[5] = static_cast<uint8_t>(sid >> 24);
      resp[6] = static_cast<uint8_t>(sid >> 16);
      resp[7] = static_cast<uint8_t>(sid >> 8);
      resp[8] = static_cast<uint8_t>(sid);
      resp[9] = 0x88;                           // indexed ":status 200"
      uint8_t* d = resp + 10;
      d[0] = 0; d[1] = 0; d[2] = 16;            // DATA, len 16
      d[3] = 0; d[4] = 0x1;                     // END_STREAM
      d[5] = static_cast<uint8_t>(sid >> 24);
      d[6] = static_cast<uint8_t>(sid >> 16);
      d[7] = static_cast<uint8_t>(sid >> 8);
      d[8] = static_cast<uint8_t>(sid);
      memcpy(d + 9, "0123456789abcdef", 16);
      send(c, resp, sizeof resp, 0);
    }
    memmove(buf, buf + 9 + flen, got - 9 - flen);
    got -= 9 + flen;
  }
}

// h2c prior-knowledge reactor stress: 48 tasks multiplex as streams
// over at most 2 connections against the canned server while the main
// thread drains — frame reassembly, the per-stream ledger in the conn
// state machine, and stream-vs-connection completion all race under
// the sanitizer, with exactly-once delivery asserted per tag.
static int stress_reactor_h2() {
  int lfd = -1, port = 0;
  if (mk_listener(&lfd, &port)) return 1;
  std::thread srv([lfd]() {
    std::vector<std::thread> handlers;
    for (;;) {
      int c = accept(lfd, nullptr, nullptr);
      if (c < 0) break;
      handlers.emplace_back(h2c_handle, c);
    }
    for (auto& h : handlers) h.join();
  });
  const int kTasks = 48;
  int64_t pool = tb_pool_create2(2, 32, 0, "", 0, 1 | 0x20000);
  int bad = 0;
  std::vector<void*> bufs(kTasks, nullptr);
  std::vector<int> seen(kTasks, 0);
  if (!pool) {
    bad = 100;
  } else {
    int next = 0, drained = 0, ok_sub = 0;
    bool sub_done = false;
    while (!sub_done || drained < ok_sub) {
      while (next < kTasks) {
        void* b = tb_alloc_aligned(4096, 4096);
        if (!b) {
          bad++;
          next++;
          continue;
        }
        int rc = tb_pool_submit(pool, "127.0.0.1", port, "/x", "", b, 4096,
                                next);
        if (rc == -EAGAIN) {
          tb_free_aligned(b);
          break;  // backpressure: drain below
        }
        if (rc != 0) {
          tb_free_aligned(b);
          bad++;
          next++;
          continue;
        }
        bufs[next++] = b;
        ok_sub++;
      }
      sub_done = next >= kTasks;
      if (sub_done && drained >= ok_sub) break;
      uint64_t tags[8];
      int64_t results[8], fbs[8], totals[8], starts[8];
      int statuses[8];
      int n = tb_pool_ring_next_batch(pool, 30000, 8, tags, results, statuses,
                                      fbs, totals, starts);
      if (n <= 0) {  // stall: bail instead of hanging
        bad++;
        break;
      }
      for (int i = 0; i < n; i++) {
        int t = static_cast<int>(tags[i]);
        if (t < 0 || t >= kTasks || seen[t]++) {
          bad++;
          continue;
        }
        if (results[i] != 16 || statuses[i] != 200 ||
            memcmp(bufs[t], "0123456789abcdef", 16) != 0)
          bad++;
      }
      drained += n;
    }
    tb_pool_destroy(pool);
  }
  shutdown(lfd, SHUT_RDWR);
  close(lfd);
  srv.join();
  for (auto b : bufs)
    if (b) tb_free_aligned(b);
  return bad ? 90 : 0;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <scratch-dir>\n", argv[0]);
    return 2;
  }
  const std::string dir = argv[1];
  const int kThreads = 8;
  const int64_t kBlock = 4096;
  const int64_t kBlocks = 64;

  // Shared read-only offset table (reference shared its pattern too).
  std::vector<int64_t> offsets(kBlocks);
  for (int64_t i = 0; i < kBlocks; ++i) offsets[i] = i * kBlock;

  // Each thread: write its own file, read it back, dlpack round-trips —
  // all through engine entry points, with thread-owned buffers/latencies.
  std::vector<std::thread> threads;
  std::vector<int> rc(kThreads, 0);
  for (int t = 0; t < kThreads; ++t) {
    threads.emplace_back([&, t]() {
      std::string path = dir + "/stress_" + std::to_string(t);
      void* buf = tb_alloc_aligned(kBlock * kBlocks, 4096);
      if (!buf) { rc[t] = 1; return; }
      tb_fill_random(buf, kBlock * kBlocks, 1234 + t);
      std::vector<int64_t> lat(kBlocks);  // per-thread latency array

      int direct = 0;
      int fd = tb_open(path.c_str(), /*write|create|direct*/ 1 | 2 | 4, &direct);
      if (fd < 0) { rc[t] = 2; tb_free_aligned(buf); return; }
      if (tb_pwrite_blocks(fd, buf, kBlock, offsets.data(), kBlocks, 0,
                           lat.data()) < 0) rc[t] = 3;
      tb_close(fd);

      fd = tb_open(path.c_str(), /*read|direct*/ 4, &direct);
      if (fd < 0) { rc[t] = 4; tb_free_aligned(buf); return; }
      for (int pass = 0; pass < 4 && rc[t] == 0; ++pass) {
        if (tb_pread_blocks(fd, buf, kBlock, offsets.data(), kBlocks,
                            lat.data()) < 0) rc[t] = 5;
        void* m = tb_dlpack_create(buf, kBlocks, kBlock, nullptr);
        if (!m) rc[t] = 6;
        else tb_dlpack_free(m);
        (void)tb_now_ns();
      }
      tb_close(fd);
      tb_free_aligned(buf);
      std::remove(path.c_str());
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < kThreads; ++t) {
    if (rc[t]) { std::fprintf(stderr, "thread %d failed rc=%d\n", t, rc[t]); return 1; }
  }
  int prc = stress_fetch_pool();
  if (prc) { std::fprintf(stderr, "fetch-pool stress failed rc=%d\n", prc); return 1; }
  int src = stress_srv_and_discard();
  if (src) { std::fprintf(stderr, "srv/discard stress failed rc=%d\n", src); return 1; }
  int rrc = stress_reactor();
  if (rrc) { std::fprintf(stderr, "reactor stress failed rc=%d\n", rrc); return 1; }
  int crc = stress_reactor_stale_churn();
  if (crc) { std::fprintf(stderr, "reactor stale-churn stress failed rc=%d\n", crc); return 1; }
  int hrc = stress_reactor_destroy_hammer();
  if (hrc) { std::fprintf(stderr, "reactor destroy hammer failed rc=%d\n", hrc); return 1; }
  int h2rc = stress_reactor_h2();
  if (h2rc) { std::fprintf(stderr, "reactor h2 stress failed rc=%d\n", h2rc); return 1; }
  int t1 = stress_reactor_tls_midreset();
  if (t1) { std::fprintf(stderr, "reactor tls midreset stress failed rc=%d\n", t1); return 1; }
  int t2 = stress_reactor_tls_reset();
  if (t2) { std::fprintf(stderr, "reactor tls reset stress failed rc=%d\n", t2); return 1; }
  int t3 = stress_reactor_tls_destroy_inflight();
  if (t3) { std::fprintf(stderr, "reactor tls destroy-inflight stress failed rc=%d\n", t3); return 1; }
  std::puts("stress ok");
  return 0;
}
