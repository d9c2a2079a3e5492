// tpubench native data-path engine.
//
// The reference's entire data path is native (Go compiles to machine code);
// SURVEY §2.5 ledgers the components that must therefore be native here:
//
//   1. O_DIRECT aligned block I/O (reference: read_operation/main.go:34,
//      write_operations/main.go:36, ssd_test/main.go:42 — Go got alignment
//      only incidentally; we handle it explicitly).
//   2. Per-op high-resolution timing in the hot loop, written into
//      caller-owned (per-thread) latency arrays — fixing the reference's
//      shared-slice data race (ssd_test/main.go:80).
//   3. fsync-per-block durable write path (write_operations/main.go:63-71).
//   4. A streaming HTTP/1.1 receive path that lands response bodies directly
//      in pre-registered buffers (reference granule loop main.go:125,140),
//      with a first-byte timestamp the Go code never measured.
//
// Plain C ABI; Python binds via ctypes (no pybind11 in this image). All
// blocking calls run without the GIL (ctypes releases it), so Python worker
// threads get real I/O concurrency.

#include <cctype>
#include <cerrno>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>

#include <arpa/inet.h>
#include <dlfcn.h>
#include <fcntl.h>
#include <poll.h>
#include <pthread.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include "hpack_huffman.h"

extern "C" {

// ----------------------------------------------------------------- clock --
int64_t tb_now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

// --------------------------------------------------- transport counters --
// tb_stats_*: engine-wide transport state that was previously invisible
// from Python — bytes on the wire, h2 frame/flow-control activity, recv
// wait time, connects/handshakes. Process-cumulative, atomically updated
// (relaxed: they are monotone counters, not synchronization); callers
// (the flight recorder) diff two snapshots to scope a run. The counter
// NAMES are API (Python builds its dict from tb_stats_name); indices are
// not — always resolve by name.
enum {
  TB_STAT_BYTES_TX = 0,       // payload bytes handed to send/SSL_write
  TB_STAT_BYTES_RX,           // payload bytes returned by recv/SSL_read
  TB_STAT_RECV_WAIT_NS,       // wall time blocked inside recv/SSL_read —
                              // the receive-side stall (peer/flow-control
                              // starvation shows up here)
  TB_STAT_CONNECTS,           // tb_http_connect successes (TCP connects)
  TB_STAT_TLS_HANDSHAKES,     // completed TLS handshakes
  TB_STAT_CONN_CLOSES,        // tb_conn handles closed
  TB_STAT_H2_FRAMES_RX,       // h2 frames consumed by the poll loop
  TB_STAT_H2_DATA_BYTES_RX,   // DATA frame payload bytes (incl. padding)
  TB_STAT_H2_WINDOW_UPDATES_TX,  // flow-control credit frames sent
  TB_STAT_H2_STREAMS_OPENED,  // streams submitted (gRPC + raw GET)
  TB_STAT_H2_RST_RX,          // RST_STREAM frames received
  TB_STAT_H2_GOAWAY_RX,       // GOAWAY frames received
  // Fetch-executor completion-queue handoff (BENCH_r05 attributed the
  // native executor's deficit to per-completion queue crossings):
  TB_STAT_POOL_WAKES,          // consumer wakes that returned >=1 completion
  TB_STAT_POOL_COMPLETIONS,    // completions delivered across all wakes —
                               // completions/wakes is the batching ratio
  TB_STAT_POOL_BATCHED_WAKES,  // wakes that drained >1 completion in one
                               // lock crossing (tb_pool_next_batch)
  // Reactor-mode executor (tb_pool_create2 mode=reactor): the epoll loop
  // and the lock-free completion-ring handoff, counted so the three-arm
  // A/B's verdict is attributable to the dispatch path, not asserted.
  TB_STAT_REACTOR_LOOPS,       // epoll_wait iterations across all loops
  TB_STAT_REACTOR_EPOLL_EVENTS,  // epoll events delivered — events/loops
                                 // is the per-iteration batching of I/O
  TB_STAT_REACTOR_COMPLETIONS,   // completions enqueued to SPSC rings
  TB_STAT_REACTOR_DOORBELL_WAKES,  // eventfd doorbells rung (only on a
                                   // ring's empty→nonempty transition —
                                   // steady-state backlog rings none)
  TB_STAT_REACTOR_RING_DEPTH_SUM,  // ring depth observed at each enqueue,
                                   // summed — mean depth = sum/completions
  TB_STAT_REACTOR_RING_DEPTH_MAX,  // max ring depth observed (per reset)
  // Reactor TLS/h2 (the nonblocking transport state machines):
  TB_STAT_REACTOR_TLS_HANDSHAKES,  // handshakes completed by the epoll-
                                   // driven WANT_READ/WANT_WRITE machine
  TB_STAT_REACTOR_TLS_RESUMES,     // handshakes that resumed a cached
                                   // session (keep-alive reconnect hits)
  TB_STAT_REACTOR_H2_STREAMS,      // h2 streams opened by the reactor
                                   // (many per connection — the FIFO's
                                   // in-flight dimension)
  TB_STAT_REACTOR_FLOW_STALL_NS,   // ns flow-control credit (WINDOW_
                                   // UPDATE) sat queued before reaching
                                   // the wire — credit-return latency
  TB_STAT_COUNT
};
static int64_t tb_stats_v[TB_STAT_COUNT];
static const char* const tb_stats_names[TB_STAT_COUNT] = {
    "bytes_tx",
    "bytes_rx",
    "recv_wait_ns",
    "connects",
    "tls_handshakes",
    "conn_closes",
    "h2_frames_rx",
    "h2_data_bytes_rx",
    "h2_window_updates_tx",
    "h2_streams_opened",
    "h2_rst_rx",
    "h2_goaway_rx",
    "pool_wakes",
    "pool_completions",
    "pool_batched_wakes",
    "reactor_loops",
    "reactor_epoll_events",
    "reactor_completions",
    "reactor_doorbell_wakes",
    "reactor_ring_depth_sum",
    "reactor_ring_depth_max",
    "reactor_tls_handshakes",
    "reactor_tls_resumes",
    "reactor_h2_streams",
    "reactor_flow_stall_ns",
};

static inline void tb_stat_add(int idx, int64_t v) {
  __atomic_fetch_add(&tb_stats_v[idx], v, __ATOMIC_RELAXED);
}

static inline void tb_stat_max(int idx, int64_t v) {
  int64_t cur = __atomic_load_n(&tb_stats_v[idx], __ATOMIC_RELAXED);
  while (cur < v &&
         !__atomic_compare_exchange_n(&tb_stats_v[idx], &cur, v, true,
                                      __ATOMIC_RELAXED, __ATOMIC_RELAXED)) {
  }
}

int tb_stats_count() { return TB_STAT_COUNT; }

const char* tb_stats_name(int i) {
  return (i >= 0 && i < TB_STAT_COUNT) ? tb_stats_names[i] : "";
}

int tb_stats_read(int64_t* out, int cap) {
  int n = cap < TB_STAT_COUNT ? cap : TB_STAT_COUNT;
  for (int i = 0; i < n; i++)
    out[i] = __atomic_load_n(&tb_stats_v[i], __ATOMIC_RELAXED);
  return n;
}

void tb_stats_reset() {
  for (int i = 0; i < TB_STAT_COUNT; i++)
    __atomic_store_n(&tb_stats_v[i], 0, __ATOMIC_RELAXED);
}

// --------------------------------------------------------------- buffers --
// Aligned allocation: O_DIRECT requires buffer, offset and length aligned to
// the logical block size (typically 512; 4096 is safe for both).
void* tb_alloc_aligned(size_t size, size_t align) {
  void* p = nullptr;
  if (posix_memalign(&p, align, size) != 0) return nullptr;
  return p;
}

void tb_free_aligned(void* p) { free(p); }

// ---------------------------------------------------------------- dlpack --
// DLPack producer over engine-owned aligned buffers (SURVEY §2.5.4: expose
// pinned host buffers to JAX/numpy with no Python-held copy). Minimal stable
// ABI structs (dlpack.h v0.8 layout); the tensor does NOT own the bytes —
// buffer lifetime stays with the AlignedBuffer, the deleter frees only the
// descriptor. kDLCPU = 1, uint dtype code = 1.
struct TbDLDevice { int32_t device_type; int32_t device_id; };
struct TbDLDataType { uint8_t code; uint8_t bits; uint16_t lanes; };
struct TbDLTensor {
  void* data;
  TbDLDevice device;
  int32_t ndim;
  TbDLDataType dtype;
  int64_t* shape;
  int64_t* strides;
  uint64_t byte_offset;
};
struct TbDLManagedTensor {
  TbDLTensor dl_tensor;
  void* manager_ctx;
  void (*deleter)(TbDLManagedTensor*);
};

static void tb_dlpack_deleter(TbDLManagedTensor* t) {
  if (!t) return;
  free(t->dl_tensor.shape);  // strides allocated in the same block
  free(t);
}

// 2-D row-major uint8 tensor (rows, cols) viewing `data`. Returns an opaque
// DLManagedTensor* for Python to wrap in a "dltensor" PyCapsule. `deleter`
// (optional) overrides the default descriptor-free — the Python side passes
// a ctypes callback here so the consumer's deleter call also un-pins the
// producer buffer (DLPack contract: the managed tensor keeps data alive).
void* tb_dlpack_create(void* data, int64_t rows, int64_t cols,
                       void (*deleter)(TbDLManagedTensor*)) {
  if (!data || rows <= 0 || cols <= 0) return nullptr;
  TbDLManagedTensor* t =
      static_cast<TbDLManagedTensor*>(calloc(1, sizeof(TbDLManagedTensor)));
  if (!t) return nullptr;
  int64_t* dims = static_cast<int64_t*>(malloc(4 * sizeof(int64_t)));
  if (!dims) {
    free(t);
    return nullptr;
  }
  dims[0] = rows;
  dims[1] = cols;
  dims[2] = cols;  // strides (elements): row-major contiguous
  dims[3] = 1;
  t->dl_tensor.data = data;
  t->dl_tensor.device.device_type = 1;  // kDLCPU
  t->dl_tensor.device.device_id = 0;
  t->dl_tensor.ndim = 2;
  t->dl_tensor.dtype.code = 1;  // kDLUInt
  t->dl_tensor.dtype.bits = 8;
  t->dl_tensor.dtype.lanes = 1;
  t->dl_tensor.shape = dims;
  t->dl_tensor.strides = dims + 2;
  t->dl_tensor.byte_offset = 0;
  t->manager_ctx = nullptr;
  t->deleter = deleter ? deleter : tb_dlpack_deleter;
  return t;
}

// Invokes the tensor's registered deleter (unconsumed-capsule destructor
// path; consumers call t->deleter themselves).
void tb_dlpack_free(void* managed) {
  TbDLManagedTensor* t = static_cast<TbDLManagedTensor*>(managed);
  if (t && t->deleter) t->deleter(t);
}

// Descriptor-only free, for custom deleters to delegate to.
void tb_dlpack_free_descriptor(void* managed) {
  tb_dlpack_deleter(static_cast<TbDLManagedTensor*>(managed));
}

// ------------------------------------------------------------------ open --
// flags: bit0 write (else read), bit1 create+trunc, bit2 O_DIRECT wanted.
// Returns fd >= 0; *direct_applied set to 1 if O_DIRECT actually engaged
// (tmpfs and some FUSE configs reject it — we fall back and report, rather
// than failing the benchmark).
int tb_open(const char* path, int flags, int* direct_applied) {
  int oflags = (flags & 1) ? O_WRONLY : O_RDONLY;
  if (flags & 2) oflags |= O_CREAT | O_TRUNC;
  int want_direct = (flags & 4) ? 1 : 0;
  if (direct_applied) *direct_applied = 0;
#ifdef O_DIRECT
  if (want_direct) {
    int fd = open(path, oflags | O_DIRECT, 0644);
    if (fd >= 0) {
      if (direct_applied) *direct_applied = 1;
      return fd;
    }
    if (errno != EINVAL && errno != ENOTSUP && errno != EOPNOTSUPP)
      return -errno;
  }
#endif
  int fd = open(path, oflags, 0644);
  return fd >= 0 ? fd : -errno;
}

int tb_close(int fd) { return close(fd) == 0 ? 0 : -errno; }

int64_t tb_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -errno;
  return static_cast<int64_t>(st.st_size);
}

// ----------------------------------------------------------- block reads --
// The ssd_test hot loop (ssd_test/main.go:65-89): for each offset, one timed
// pread of block_size bytes into `buf`. Latencies (ns) land in lat_ns[i] —
// the caller passes a private per-thread array, so there is no shared
// mutable state (the reference raced here). Returns total bytes read, or
// -errno on the first failure.
int64_t tb_pread_blocks(int fd, void* buf, int64_t block_size,
                        const int64_t* offsets, int64_t n, int64_t* lat_ns) {
  int64_t total = 0;
  char* p = static_cast<char*>(buf);
  for (int64_t i = 0; i < n; i++) {
    int64_t t0 = tb_now_ns();
    int64_t got = 0;
    while (got < block_size) {
      ssize_t k = pread(fd, p + got, block_size - got, offsets[i] + got);
      if (k < 0) {
        if (errno == EINTR) continue;
        return -errno;
      }
      if (k == 0) break;  // EOF: short final block is legal
      got += k;
    }
    if (lat_ns) lat_ns[i] = tb_now_ns() - t0;
    total += got;
  }
  return total;
}

// Sequential whole-file streaming (read_operation/main.go:45-53 semantics,
// minus its re-read-at-EOF bug: we always pread from explicit offsets).
// Repeat passes re-read from offset 0 deliberately (SURVEY §3.3 note).
int64_t tb_read_file_seq(int fd, void* buf, int64_t buf_size, int64_t passes,
                         int64_t* pass_lat_ns) {
  int64_t total = 0;
  char* p = static_cast<char*>(buf);
  for (int64_t pass = 0; pass < passes; pass++) {
    int64_t t0 = tb_now_ns();
    int64_t off = 0;
    for (;;) {
      ssize_t k = pread(fd, p, buf_size, off);
      if (k < 0) {
        if (errno == EINTR) continue;
        return -errno;
      }
      if (k == 0) break;
      off += k;
      total += k;
    }
    if (pass_lat_ns) pass_lat_ns[pass] = tb_now_ns() - t0;
  }
  return total;
}

// ----------------------------------------------------------- block writes --
// write_operations/main.go:46-76 semantics: per block seek+write and
// (optionally) fsync-per-block. Data comes from the caller-filled buffer.
// Latency per block includes the fsync when enabled (that IS the measured
// durable-write cost). Returns total bytes written or -errno.
int64_t tb_pwrite_blocks(int fd, const void* buf, int64_t block_size,
                         const int64_t* offsets, int64_t n, int fsync_each,
                         int64_t* lat_ns) {
  int64_t total = 0;
  const char* p = static_cast<const char*>(buf);
  for (int64_t i = 0; i < n; i++) {
    int64_t t0 = tb_now_ns();
    int64_t put = 0;
    while (put < block_size) {
      ssize_t k = pwrite(fd, p + put, block_size - put, offsets[i] + put);
      if (k < 0) {
        if (errno == EINTR) continue;
        return -errno;
      }
      put += k;
    }
    if (fsync_each && fsync(fd) != 0) return -errno;
    if (lat_ns) lat_ns[i] = tb_now_ns() - t0;
    total += put;
  }
  return total;
}

// xorshift64* fill — fast deterministic "random" payload for write benches
// (reference uses crypto/rand per block, write_operations/main.go:46; the
// bench measures the I/O path, not the RNG, so a cheap PRNG is the right
// trade and is reproducible).
void tb_fill_random(void* buf, int64_t n, uint64_t seed) {
  uint64_t x = seed ? seed : 0x9E3779B97F4A7C15ULL;
  uint64_t* p64 = static_cast<uint64_t*>(buf);
  int64_t words = n / 8;
  for (int64_t i = 0; i < words; i++) {
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    p64[i] = x * 0x2545F4914F6CDD1DULL;
  }
  char* tail = static_cast<char*>(buf) + words * 8;
  for (int64_t i = 0; i < n % 8; i++) tail[i] = static_cast<char>(x >> (8 * i));
}

// ------------------------------------------------------- HTTP/1.1 client --
// Minimal plain-TCP GET: connect, send request, parse headers, stream the
// body into the caller's pre-registered buffer. Out-params: HTTP status,
// first-byte timestamp (ns, CLOCK_MONOTONIC — comparable with tb_now_ns),
// and total body bytes. Supports Content-Length bodies (what the fake GCS
// server and GCS JSON media GETs produce). Returns body length, or -errno /
// -1000-series protocol errors.
//
// TLS is supported through the tb_conn layer below (dlopen'd OpenSSL), so
// the same receive loop can face both localhost plaintext servers and real
// https endpoints (SURVEY hard-part (b)).
// Error-code contract with the Python layer (gcs_http classifies
// transient-vs-permanent on these codes, NOT on message text): -1001/-1002
// are protocol-shape failures (permanent — retrying the same request against
// the same server yields the same malformed/oversized response); -1003/-1004
// are network-condition failures (transient, like plain -errno socket
// errors).
enum {
  TB_EPROTO = -1001,    // malformed response [permanent]
  TB_ETOOBIG = -1002,   // body exceeds buffer [permanent]
  TB_ERESOLVE = -1003,  // getaddrinfo failure [transient]
  TB_ESHORT = -1004,    // peer closed before the response was complete
                        // (mid-headers or body short of Content-Length)
                        // [transient]
  TB_ECHUNKED = -1005,  // Transfer-Encoding: chunked — unsupported here;
                        // rejected loudly instead of returning chunk
                        // framing as body bytes [permanent]
  TB_ETLS = -1006,      // TLS unavailable / handshake or verification
                        // failure — reproduces against the same endpoint
                        // and trust config [permanent]
  TB_EGRPC = -1007,     // RPC finished with a nonzero grpc-status; the
                        // status lands in grpc_status_out and the caller
                        // classifies on it (NOT_FOUND permanent,
                        // UNAVAILABLE transient, …)
};

// Connect a TCP socket for HTTP use (TCP_NODELAY). Returns fd >= 0, or
// TB_ERESOLVE / -errno.
int tb_http_connect(const char* host, int port) {
  char portstr[16];
  snprintf(portstr, sizeof portstr, "%d", port);
  struct addrinfo hints, *res = nullptr;
  memset(&hints, 0, sizeof hints);
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host, portstr, &hints, &res) != 0) return TB_ERESOLVE;
  int fd = -1;
  for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) return -ECONNREFUSED;
  tb_stat_add(TB_STAT_CONNECTS, 1);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  // Bounded blocking I/O (the Python pool uses timeout=60 — same here):
  // a hung peer surfaces as -EAGAIN (classified transient, retried under
  // policy) instead of stalling a worker thread forever.
  struct timeval tv;
  tv.tv_sec = 60;
  tv.tv_usec = 0;
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  return fd;
}

int tb_http_close(int fd) { return close(fd) == 0 ? 0 : -errno; }

// ------------------------------------------------------------------- TLS --
// TLS via dlopen(libssl.so.3 / .so.1.1): the image ships OpenSSL runtime
// libraries but not headers, so the handful of client-side entry points are
// declared here and resolved at first use. The receive loop itself is shared with
// the plaintext path through the tb_conn vtable below — TLS is a transport
// detail, not a second implementation.
namespace tls {
typedef void* (*fn_pv)();
static void* libssl = nullptr;
static void* libcrypto = nullptr;
static void* (*SSL_CTX_new_)(void*) = nullptr;
static void (*SSL_CTX_free_)(void*) = nullptr;
static void* (*TLS_client_method_)() = nullptr;
static int (*SSL_CTX_set_default_verify_paths_)(void*) = nullptr;
static int (*SSL_CTX_load_verify_locations_)(void*, const char*, const char*) =
    nullptr;
static void (*SSL_CTX_set_verify_)(void*, int, void*) = nullptr;
static void* (*SSL_new_)(void*) = nullptr;
static void (*SSL_free_)(void*) = nullptr;
static int (*SSL_set_fd_)(void*, int) = nullptr;
static int (*SSL_connect_)(void*) = nullptr;
static int (*SSL_read_)(void*, void*, int) = nullptr;
static int (*SSL_write_)(void*, const void*, int) = nullptr;
static int (*SSL_shutdown_)(void*) = nullptr;
static int (*SSL_pending_)(void*) = nullptr;
static long (*SSL_ctrl_)(void*, int, long, void*) = nullptr;
static void* (*SSL_get0_param_)(void*) = nullptr;
static int (*SSL_CTX_up_ref_)(void*) = nullptr;
static int (*SSL_set_alpn_protos_)(void*, const unsigned char*, unsigned) =
    nullptr;
static void (*SSL_get0_alpn_selected_)(const void*, const unsigned char**,
                                       unsigned*) = nullptr;
static int (*X509_VERIFY_PARAM_set1_host_)(void*, const char*, size_t) = nullptr;
static int (*X509_VERIFY_PARAM_set1_ip_asc_)(void*, const char*) = nullptr;
// Nonblocking-reactor additions: WANT_READ/WANT_WRITE classification and
// session resumption on keep-alive reconnect.
static int (*SSL_get_error_)(const void*, int) = nullptr;
static int (*SSL_session_reused_)(void*) = nullptr;
static void* (*SSL_get1_session_)(void*) = nullptr;
static int (*SSL_set_session_)(void*, void*) = nullptr;
static void (*SSL_SESSION_free_)(void*) = nullptr;

static bool do_load() {
  // RTLD_GLOBAL so libssl can resolve its libcrypto dependency if the
  // loader brings them in separately.
  // Try 3.x, then 1.1 (every symbol used here exists since 1.0.2),
  // then the unversioned dev symlink.
  libcrypto = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_GLOBAL);
  if (!libcrypto) libcrypto = dlopen("libcrypto.so.1.1", RTLD_NOW | RTLD_GLOBAL);
  if (!libcrypto) libcrypto = dlopen("libcrypto.so", RTLD_NOW | RTLD_GLOBAL);
  libssl = dlopen("libssl.so.3", RTLD_NOW | RTLD_GLOBAL);
  if (!libssl) libssl = dlopen("libssl.so.1.1", RTLD_NOW | RTLD_GLOBAL);
  if (!libssl) libssl = dlopen("libssl.so", RTLD_NOW | RTLD_GLOBAL);
  if (!libssl || !libcrypto) return false;
#define TB_SYM(lib, name)                                       \
  do {                                                          \
    *reinterpret_cast<void**>(&name##_) = dlsym(lib, #name);    \
    if (!name##_) return false;                                 \
  } while (0)
  TB_SYM(libssl, SSL_CTX_new);
  TB_SYM(libssl, SSL_CTX_free);
  TB_SYM(libssl, TLS_client_method);
  TB_SYM(libssl, SSL_CTX_set_default_verify_paths);
  TB_SYM(libssl, SSL_CTX_load_verify_locations);
  TB_SYM(libssl, SSL_CTX_set_verify);
  TB_SYM(libssl, SSL_new);
  TB_SYM(libssl, SSL_free);
  TB_SYM(libssl, SSL_set_fd);
  TB_SYM(libssl, SSL_connect);
  TB_SYM(libssl, SSL_read);
  TB_SYM(libssl, SSL_write);
  TB_SYM(libssl, SSL_shutdown);
  TB_SYM(libssl, SSL_pending);
  TB_SYM(libssl, SSL_ctrl);
  TB_SYM(libssl, SSL_get0_param);
  TB_SYM(libssl, SSL_CTX_up_ref);
  TB_SYM(libssl, SSL_set_alpn_protos);
  TB_SYM(libssl, SSL_get0_alpn_selected);
  TB_SYM(libcrypto, X509_VERIFY_PARAM_set1_host);
  TB_SYM(libcrypto, X509_VERIFY_PARAM_set1_ip_asc);
  TB_SYM(libssl, SSL_get_error);
  TB_SYM(libssl, SSL_session_reused);
  TB_SYM(libssl, SSL_get1_session);
  TB_SYM(libssl, SSL_set_session);
  TB_SYM(libssl, SSL_SESSION_free);
#undef TB_SYM
  return true;
}

static bool load() {
  // C++11 magic-static: exactly one thread runs do_load(), concurrent
  // callers block until the init completes — the global function-pointer
  // stores are fully visible before any caller proceeds (workers hit
  // first-https-use concurrently; an unsynchronized flag would race).
  static bool ok = do_load();
  return ok;
}

// One SSL_CTX per trust configuration, created once and shared by every
// connection: re-parsing the CA bundle / system trust store per connect
// costs tens of ms and would skew exactly the connect/TTFB timings this
// benchmark measures (the Python pool it is A/B'd against also shares one
// ssl.SSLContext). SSL_new up-refs the CTX, so cached entries can live for
// the process lifetime.
struct CtxCacheEntry {
  char cafile[512];
  int insecure;
  void* ctx;
};
static CtxCacheEntry ctx_cache[8];
static int ctx_cache_n = 0;
static pthread_mutex_t ctx_cache_mu = PTHREAD_MUTEX_INITIALIZER;

static void* make_ctx(const char* cafile, int insecure) {
  void* ctx = SSL_CTX_new_(TLS_client_method_());
  if (!ctx) return nullptr;
  if (insecure) {
    SSL_CTX_set_verify_(ctx, 0 /*SSL_VERIFY_NONE*/, nullptr);
  } else {
    SSL_CTX_set_verify_(ctx, 1 /*SSL_VERIFY_PEER*/, nullptr);
    int ok = (cafile && cafile[0])
                 ? SSL_CTX_load_verify_locations_(ctx, cafile, nullptr)
                 : SSL_CTX_set_default_verify_paths_(ctx);
    if (ok != 1) {
      SSL_CTX_free_(ctx);
      return nullptr;
    }
  }
  return ctx;
}

static void* get_ctx(const char* cafile, int insecure) {
  const char* cf = cafile ? cafile : "";
  if (strlen(cf) >= sizeof ctx_cache[0].cafile)
    return make_ctx(cafile, insecure);  // pathological path: uncached
  // The caller always receives an OWNED reference (freed after SSL_new):
  // cache hits up-ref the cached CTX, so the cache's own reference keeps
  // it alive for the process lifetime.
  pthread_mutex_lock(&ctx_cache_mu);
  for (int i = 0; i < ctx_cache_n; i++) {
    if (ctx_cache[i].insecure == insecure &&
        strcmp(ctx_cache[i].cafile, cf) == 0) {
      void* c = ctx_cache[i].ctx;
      SSL_CTX_up_ref_(c);
      pthread_mutex_unlock(&ctx_cache_mu);
      return c;
    }
  }
  void* ctx = make_ctx(cafile, insecure);
  if (ctx && ctx_cache_n < static_cast<int>(sizeof ctx_cache / sizeof ctx_cache[0])) {
    snprintf(ctx_cache[ctx_cache_n].cafile, sizeof ctx_cache[0].cafile, "%s", cf);
    ctx_cache[ctx_cache_n].insecure = insecure;
    ctx_cache[ctx_cache_n].ctx = ctx;
    ctx_cache_n++;
    SSL_CTX_up_ref_(ctx);  // the cache's reference
  }
  pthread_mutex_unlock(&ctx_cache_mu);
  return ctx;
}
}  // namespace tls

int tb_tls_available() { return tls::load() ? 1 : 0; }

// State of one in-progress HTTP/1.1 response (the streaming receive):
// headers parsed by http_begin, body served incrementally by resp_read so
// callers stream socket→destination with no full-body intermediate buffer
// (the reference's hot loop streams through a 2 MB granule, main.go:140 —
// an up-front full-body landing would be a different, worse program).
struct tb_resp {
  int active;       // body not yet fully consumed
  int status;       // HTTP status code
  int http_minor;   // 0 or 1
  int server_close; // server announced Connection: close
  int client_close; // we requested Connection: close
  int junk;         // bytes beyond Content-Length arrived with the headers
  int64_t content_len;  // -1 = close-delimited
  int64_t body_got;
  int64_t first_byte_ns;
  // Body bytes that arrived in the same recv as the headers (bounded by
  // the header scratch size).
  int leftover_off, leftover_len;
  uint8_t leftover[16384];
};

// One h2 stream in flight on a connection (gRPC ReadObject or plain h2
// GET). Slots live in tb_conn's fixed table; id == 0 marks a free slot.
struct h2_stream {
  uint32_t id;       // h2 stream id (odd); 0 = slot free
  uint64_t tag;      // caller correlation id
  int raw_body;      // 1 = plain GET (DATA bytes land in `out` verbatim);
                     // 0 = gRPC (DATA carries length-prefixed messages)
  uint8_t* out;      // caller's destination buffer
  int64_t out_cap;
  int64_t out_len;
  uint8_t* scratch;  // gRPC message reassembly (from the conn's pool)
  size_t msg_len, msg_got, prefix_got;
  uint8_t prefix[5];
  int grpc_status;   // -1 until a trailer carries one
  int http_status;   // -1 until response HEADERS carry :status
  int64_t content_len;  // -1 until response HEADERS carry content-length
  int got_headers;
  int done;          // END_STREAM (or RST_STREAM) seen
  int64_t err;       // terminal per-stream error (0 = none)
  int64_t t_start, first_byte_ns;
  uint64_t unacked;  // consumed DATA not yet returned as stream window
};

static const int kH2MaxStreams = 32;  // concurrent streams per connection
static const size_t kGrpcScratchCap = (2u << 20) + 65536;

// Connection handle: plaintext (ssl == null) or TLS. Returned to Python as
// an opaque int64 (heap pointer); every path through the receive loop goes
// through the conn_* helpers so both transports share one implementation.
struct tb_conn {
  int fd;
  void* ssl;
  // h2 session state: lazily initialized on first gRPC/h2 use; streams on
  // one connection use odd ids 1, 3, 5, … and may be CONCURRENT (the
  // stream table below) — grpc-go multiplexes by default, and that is
  // where a native gRPC receive wins.
  int h2_started;
  uint32_t next_stream;
  h2_stream* streams;  // kH2MaxStreams slots, lazily allocated
  // Free-list of gRPC reassembly scratches: a per-RPC 2 MiB malloc/free
  // would sit inside the timed window of the very path being benchmarked.
  uint8_t* scratch_pool[8];
  int scratch_pool_n;
  // Streaming-GET state (lazily allocated by tb_conn_get_begin, reused
  // across sequential GETs on this connection, freed in tb_conn_close).
  tb_resp* resp;
};

// SSL_read/SSL_write take int lengths: cap chunks well under INT_MAX so
// multi-GiB receive buffers never produce a negative length (the loop in
// request_on just calls again for the rest).
static const size_t kTlsIoCap = size_t{1} << 30;

static ssize_t conn_send(tb_conn* c, const void* p, size_t n) {
  if (!c->ssl) {
    ssize_t k = send(c->fd, p, n, 0);
    if (k > 0) tb_stat_add(TB_STAT_BYTES_TX, k);
    return k;
  }
  if (n > kTlsIoCap) n = kTlsIoCap;
  for (;;) {
    errno = 0;  // stale EINTR from an earlier call must not loop us
    int k = tls::SSL_write_(c->ssl, p, static_cast<int>(n));
    if (k <= 0) {
      if (errno == EINTR) continue;  // interrupted syscall under SSL_write
      errno = ECONNRESET;  // classified transient, like any mid-stream break
      return -1;
    }
    tb_stat_add(TB_STAT_BYTES_TX, k);
    return k;
  }
}

static ssize_t conn_recv(tb_conn* c, void* p, size_t n) {
  // Receive-side stall accounting: wall time blocked waiting for bytes
  // (two vDSO clock reads per recv — noise next to a syscall).
  int64_t t0 = tb_now_ns();
  if (!c->ssl) {
    ssize_t k = recv(c->fd, p, n, 0);
    tb_stat_add(TB_STAT_RECV_WAIT_NS, tb_now_ns() - t0);
    if (k > 0) tb_stat_add(TB_STAT_BYTES_RX, k);
    return k;
  }
  if (n > kTlsIoCap) n = kTlsIoCap;
  for (;;) {
    errno = 0;  // stale EINTR from an earlier call must not loop us
    int k = tls::SSL_read_(c->ssl, p, static_cast<int>(n));
    if (k < 0) {
      if (errno == EINTR) continue;  // interrupted syscall under SSL_read
      tb_stat_add(TB_STAT_RECV_WAIT_NS, tb_now_ns() - t0);
      errno = ECONNRESET;
      return -1;
    }
    tb_stat_add(TB_STAT_RECV_WAIT_NS, tb_now_ns() - t0);
    if (k > 0) tb_stat_add(TB_STAT_BYTES_RX, k);
    return k;  // 0 = close_notify / EOF, same contract as recv
  }
}

// True only for a provably idle connection (nothing buffered, nothing
// pending on the wire) — the reuse-time drain check.
static int conn_idle(tb_conn* c) {
  if (c->ssl && tls::SSL_pending_(c->ssl) > 0) return 0;
  char junk;
  ssize_t pk = recv(c->fd, &junk, 1, MSG_PEEK | MSG_DONTWAIT);
  // Raw bytes pending on a TLS socket may be an in-flight close_notify —
  // conservatively not reusable either way.
  if (pk >= 0 || (errno != EAGAIN && errno != EWOULDBLOCK)) return 0;
  return 1;
}

int64_t tb_conn_plain(int fd) {
  tb_conn* c = static_cast<tb_conn*>(calloc(1, sizeof(tb_conn)));
  if (!c) return -ENOMEM;
  c->fd = fd;
  return reinterpret_cast<int64_t>(c);
}

// TLS handshake on a connected fd. On failure the fd is NOT closed (the
// caller owns it). ``sni`` is the server name for SNI + certificate
// verification; ``cafile`` overrides the system trust store; ``insecure``
// skips verification entirely (tests against self-signed endpoints);
// ``alpn_h2`` offers ALPN "h2" and REQUIRES the server to select it (the
// gRPC path misparses an HTTP/1.1 fallback as frame garbage — fail the
// handshake instead).
int64_t tb_conn_tls(int fd, const char* sni, const char* cafile, int insecure,
                    int alpn_h2) {
  if (!tls::load()) return TB_ETLS;
  void* ctx = tls::get_ctx(cafile, insecure);
  if (!ctx) return TB_ETLS;
  void* ssl = tls::SSL_new_(ctx);
  tls::SSL_CTX_free_(ctx);  // drop our reference; SSL holds its own
  if (!ssl) return TB_ETLS;
  if (sni && sni[0]) {
    // SNI (SSL_set_tlsext_host_name macro = SSL_ctrl 55/0).
    tls::SSL_ctrl_(ssl, 55, 0, const_cast<char*>(sni));
    if (!insecure) {
      void* param = tls::SSL_get0_param_(ssl);
      struct in_addr a4;
      struct in6_addr a6;
      int is_ip = inet_pton(AF_INET, sni, &a4) == 1 ||
                  inet_pton(AF_INET6, sni, &a6) == 1;
      int ok = is_ip ? tls::X509_VERIFY_PARAM_set1_ip_asc_(param, sni)
                     : tls::X509_VERIFY_PARAM_set1_host_(param, sni, 0);
      if (ok != 1) {
        tls::SSL_free_(ssl);
        return TB_ETLS;
      }
    }
  }
  if (alpn_h2) {
    static const unsigned char kH2[] = {2, 'h', '2'};
    if (tls::SSL_set_alpn_protos_(ssl, kH2, sizeof kH2) != 0) {
      tls::SSL_free_(ssl);
      return TB_ETLS;
    }
  }
  if (tls::SSL_set_fd_(ssl, fd) != 1) {
    tls::SSL_free_(ssl);
    return TB_ETLS;
  }
  errno = 0;
  if (tls::SSL_connect_(ssl) != 1) {
    // Distinguish network conditions (socket timeout from SO_RCVTIMEO,
    // reset, interrupt — transient, retried under policy) from
    // protocol/trust failures (TB_ETLS, permanent: they reproduce).
    int e = errno;
    tls::SSL_free_(ssl);
    if (e == EAGAIN || e == EWOULDBLOCK || e == ETIMEDOUT ||
        e == ECONNRESET || e == EPIPE || e == EINTR)
      return -e;
    return TB_ETLS;
  }
  if (alpn_h2) {
    const unsigned char* sel = nullptr;
    unsigned sel_len = 0;
    tls::SSL_get0_alpn_selected_(ssl, &sel, &sel_len);
    if (sel_len != 2 || memcmp(sel, "h2", 2) != 0) {
      tls::SSL_shutdown_(ssl);
      tls::SSL_free_(ssl);
      return TB_ETLS;
    }
  }
  tb_conn* c = static_cast<tb_conn*>(calloc(1, sizeof(tb_conn)));
  if (!c) {
    tls::SSL_free_(ssl);
    return -ENOMEM;
  }
  tb_stat_add(TB_STAT_TLS_HANDSHAKES, 1);
  c->fd = fd;
  c->ssl = ssl;
  return reinterpret_cast<int64_t>(c);
}

int tb_conn_close(int64_t h) {
  if (h <= 0) return -EINVAL;
  tb_stat_add(TB_STAT_CONN_CLOSES, 1);
  tb_conn* c = reinterpret_cast<tb_conn*>(h);
  if (c->ssl) {
    tls::SSL_shutdown_(c->ssl);  // best-effort close_notify
    tls::SSL_free_(c->ssl);
  }
  int rc = close(c->fd) == 0 ? 0 : -errno;
  if (c->streams) {
    for (int i = 0; i < kH2MaxStreams; i++) free(c->streams[i].scratch);
    free(c->streams);
  }
  for (int i = 0; i < c->scratch_pool_n; i++) free(c->scratch_pool[i]);
  free(c->resp);
  free(c);
  return rc;
}

// One GET on an ALREADY-CONNECTED socket (keep-alive: the caller pools
// connections, so the receive loop can be measured with the same
// connection discipline as the pooled Python client instead of paying a
// fresh TCP handshake per GET). The socket is NOT closed here on success;
// *reusable_out reports whether it may carry another request (complete
// Content-Length body, no "Connection: close" from the server). On ANY
// error return the caller must tb_http_close the fd — the stream state is
// unknown.
// Send one GET and parse the response headers into ``r``; body bytes that
// arrived with the headers are stashed in ``r->leftover``. Body streams via
// resp_read. Returns 0, or -errno / TB_* (the connection is then unusable).
static int64_t http_begin(tb_conn* cn, const char* host, int port,
                          const char* path,
                          const char* extra_headers,  // "K: V\r\n..." or ""
                          tb_resp* r) {
  r->active = 0;
  r->status = 0;
  r->http_minor = 0;
  r->server_close = r->client_close = r->junk = 0;
  r->content_len = -1;
  r->body_got = 0;
  r->first_byte_ns = 0;
  r->leftover_off = r->leftover_len = 0;
  char req[4096];
  int m = snprintf(req, sizeof req,
                   "GET %s HTTP/1.1\r\nHost: %s:%d\r\nUser-Agent: tpubench-native\r\n"
                   "%s\r\n",
                   path, host, port, extra_headers ? extra_headers : "");
  if (m <= 0 || m >= static_cast<int>(sizeof req)) return TB_EPROTO;
  for (int sent = 0; sent < m;) {
    ssize_t k = conn_send(cn, req + sent, m - sent);
    if (k < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    sent += k;
  }

  // Read headers (into a bounded scratch), find \r\n\r\n.
  char hdr[16384];
  const int hdr_cap = static_cast<int>(sizeof hdr) - 1;  // reserve NUL slot
  int hlen = 0;
  char* body_start = nullptr;
  int body_in_hdr = 0;
  while (hlen < hdr_cap) {
    ssize_t k = conn_recv(cn, hdr + hlen, hdr_cap - hlen);
    if (k < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (k == 0) break;
    if (r->first_byte_ns == 0) r->first_byte_ns = tb_now_ns();
    hlen += k;
    hdr[hlen] = 0;
    char* p = static_cast<char*>(memmem(hdr, hlen, "\r\n\r\n", 4));
    if (p) {
      body_start = p + 4;
      body_in_hdr = hlen - static_cast<int>(body_start - hdr);
      break;
    }
  }
  if (!body_start) {
    // Header buffer exhausted without a terminator: the server is speaking
    // broken HTTP (permanent). EOF mid-headers: early close (transient) —
    // same condition class as a body cut short.
    return hlen >= hdr_cap ? TB_EPROTO : TB_ESHORT;
  }

  if (sscanf(hdr, "HTTP/1.%d %d", &r->http_minor, &r->status) != 2)
    return TB_EPROTO;

  // Case-insensitive Content-Length / Transfer-Encoding / Connection scan
  // over the header block. Chunked bodies are rejected (TB_ECHUNKED): this
  // receive path has no de-chunker, and copying chunk framing into the
  // buffer as body bytes would be silent corruption.
  for (char* line = hdr; line < body_start;) {
    char* eol = static_cast<char*>(memmem(line, body_start - line, "\r\n", 2));
    if (!eol) break;
    if (strncasecmp(line, "Content-Length:", 15) == 0)
      r->content_len = strtoll(line + 15, nullptr, 10);
    if (strncasecmp(line, "Transfer-Encoding:", 18) == 0) {
      // Transfer-coding names are case-insensitive (RFC 9112 §7).
      for (char* p = line + 18; p + 7 <= eol; p++) {
        if (strncasecmp(p, "chunked", 7) == 0) return TB_ECHUNKED;
      }
    }
    if (strncasecmp(line, "Connection:", 11) == 0) {
      for (char* p = line + 11; p + 5 <= eol; p++) {
        if (strncasecmp(p, "close", 5) == 0) r->server_close = 1;
      }
    }
    line = eol + 2;
  }

  // Unknown body length is only readable when the connection is committed
  // to closing — server announced close, HTTP/1.0 default-close, or WE
  // requested "Connection: close" (a conformant server must then close
  // after responding, RFC 9112 §9.6, whether or not it echoes the
  // header): read-to-FIN then terminates. A keep-alive response with
  // neither Content-Length nor Transfer-Encoding leaves no way to find
  // the body end — recv would block forever — so that shape is a
  // protocol error, not a hang.
  r->client_close =
      extra_headers && strcasestr(extra_headers, "connection: close") != nullptr;
  if (r->content_len < 0 && !r->server_close && !r->client_close &&
      r->http_minor >= 1)
    return TB_EPROTO;

  if (body_in_hdr > 0) {
    memcpy(r->leftover, body_start, body_in_hdr);
    r->leftover_len = body_in_hdr;
    // Bytes beyond Content-Length arrived with the headers: pipelined
    // junk — the stream is served correctly (consumption stops at
    // Content-Length) but the connection must not be pooled.
    if (r->content_len >= 0 && body_in_hdr > r->content_len) r->junk = 1;
  }
  r->active = !(r->content_len == 0);
  return 0;
}

// Serve body bytes into ``dst``: fills ``want`` bytes completely unless
// the body ends first (buffered-reader semantics — a 2 MB granule costs
// ONE call, not one per TCP segment). Returns bytes served (0 = body
// complete), or -errno / TB_ESHORT (peer FIN before Content-Length).
static int64_t resp_read(tb_conn* cn, tb_resp* r, uint8_t* dst, int64_t want) {
  if (!r->active || want <= 0) return 0;
  if (r->content_len >= 0) {
    int64_t left = r->content_len - r->body_got;
    if (want > left) want = left;
    if (want <= 0) {
      r->active = 0;
      return 0;
    }
  }
  int64_t got = 0;
  // Leftover body bytes from the header read serve first.
  if (r->leftover_off < r->leftover_len) {
    int64_t take = r->leftover_len - r->leftover_off;
    if (take > want) take = want;
    memcpy(dst, r->leftover + r->leftover_off, take);
    r->leftover_off += static_cast<int>(take);
    got = take;
  }
  while (got < want) {
    ssize_t k = conn_recv(cn, dst + got, static_cast<size_t>(want - got));
    if (k < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (k == 0) {
      if (r->content_len < 0) {  // close-delimited: FIN ends the body
        r->active = 0;
        break;
      }
      return TB_ESHORT;  // peer FIN before Content-Length bytes arrived
    }
    if (r->first_byte_ns == 0) r->first_byte_ns = tb_now_ns();
    got += k;
  }
  r->body_got += got;
  if (r->content_len >= 0 && r->body_got >= r->content_len) r->active = 0;
  return got;
}

// Keep-alive verdict after a response: body boundary known and fully
// consumed, HTTP/1.1, no close announced either way, no pipelined junk,
// and the socket provably idle.
static int resp_reusable(tb_conn* cn, tb_resp* r) {
  if (r->active || r->content_len < 0 || r->server_close || r->client_close ||
      r->http_minor < 1 || r->junk)
    return 0;
  return conn_idle(cn);
}

static int64_t request_on(tb_conn* cn, const char* host, int port,
                          const char* path,
                          const char* extra_headers,  // "K: V\r\n..." or ""
                          void* buf, int64_t buf_len, int* status_out,
                          int64_t* first_byte_ns_out, int64_t* total_ns_out,
                          int* reusable_out) {
  int64_t t_start = tb_now_ns();
  if (reusable_out) *reusable_out = 0;
  tb_resp r;
  int64_t rc = http_begin(cn, host, port, path, extra_headers, &r);
  if (rc != 0) return rc;
  if (status_out) *status_out = r.status;
  uint8_t* out = static_cast<uint8_t*>(buf);
  int64_t got = 0;
  for (;;) {
    int64_t want = buf_len - got;
    if (want <= 0) {
      if (r.content_len >= 0) {
        if (r.active) return TB_ETOOBIG;  // known length doesn't fit
        break;
      }
      // Close-delimited body that exactly fills the buffer: probe one
      // byte — EOF proves an exact fit; more data is a real overflow.
      uint8_t probe;
      int64_t k = resp_read(cn, &r, &probe, 1);
      if (k < 0) return k;
      if (k > 0) return TB_ETOOBIG;
      break;
    }
    int64_t k = resp_read(cn, &r, out + got, want);
    if (k < 0) return k;
    if (k == 0) break;
    got += k;
  }
  if (reusable_out) *reusable_out = resp_reusable(cn, &r);
  if (first_byte_ns_out) *first_byte_ns_out = r.first_byte_ns;
  if (total_ns_out) *total_ns_out = tb_now_ns() - t_start;
  return got;
}

// ---- streaming GET on a connection handle ----
// The zero-intermediate-copy receive path: begin parses headers, then the
// caller pulls body bytes directly into its own memory (granule buffer or
// staging slot) — the same socket→destination streaming discipline as the
// Python client's readinto loop, with native header parse and timestamps.
// Contract: begin → N× body_read → end. On any negative return the
// connection is unusable and the caller must tb_conn_close it.

int64_t tb_conn_get_begin(int64_t h, const char* host, int port,
                          const char* path, const char* extra_headers,
                          int* status_out, int64_t* content_len_out,
                          int64_t* first_byte_ns_out) {
  if (h <= 0) return -EINVAL;
  tb_conn* cn = reinterpret_cast<tb_conn*>(h);
  if (!cn->resp) {
    cn->resp = static_cast<tb_resp*>(malloc(sizeof(tb_resp)));
    if (!cn->resp) return -ENOMEM;
  }
  int64_t rc = http_begin(cn, host, port, path, extra_headers, cn->resp);
  if (rc != 0) return rc;
  if (status_out) *status_out = cn->resp->status;
  if (content_len_out) *content_len_out = cn->resp->content_len;
  if (first_byte_ns_out) *first_byte_ns_out = cn->resp->first_byte_ns;
  return 0;
}

int64_t tb_conn_body_read(int64_t h, void* dst, int64_t want) {
  if (h <= 0) return -EINVAL;
  tb_conn* cn = reinterpret_cast<tb_conn*>(h);
  if (!cn->resp) return -EINVAL;
  return resp_read(cn, cn->resp, static_cast<uint8_t*>(dst), want);
}

// Finish the streaming GET: *reusable_out reports whether the connection
// may carry another request (not reusable when the body was abandoned
// mid-stream). Always safe to call once after begin succeeded.
int tb_conn_get_end(int64_t h, int* reusable_out) {
  if (h <= 0) return -EINVAL;
  tb_conn* cn = reinterpret_cast<tb_conn*>(h);
  if (!cn->resp) return -EINVAL;
  if (reusable_out) *reusable_out = resp_reusable(cn, cn->resp);
  cn->resp->active = 0;
  return 0;
}

// Plain-fd wrapper (back-compat entry point; plaintext only).
int64_t tb_http_request(int fd, const char* host, int port, const char* path,
                        const char* extra_headers, void* buf, int64_t buf_len,
                        int* status_out, int64_t* first_byte_ns_out,
                        int64_t* total_ns_out, int* reusable_out) {
  tb_conn c{};
  c.fd = fd;
  return request_on(&c, host, port, path, extra_headers, buf, buf_len,
                    status_out, first_byte_ns_out, total_ns_out, reusable_out);
}

// Handle-based entry point: one GET on a tb_conn (plaintext or TLS).
int64_t tb_conn_request(int64_t h, const char* host, int port,
                        const char* path, const char* extra_headers, void* buf,
                        int64_t buf_len, int* status_out,
                        int64_t* first_byte_ns_out, int64_t* total_ns_out,
                        int* reusable_out) {
  if (h <= 0) return -EINVAL;
  return request_on(reinterpret_cast<tb_conn*>(h), host, port, path,
                    extra_headers, buf, buf_len, status_out, first_byte_ns_out,
                    total_ns_out, reusable_out);
}

// One-shot GET: fresh connection, with an explicit "Connection: close"
// request header so a close-delimited (no Content-Length) HTTP/1.1
// response is legal: the server commits to closing and read-to-FIN
// terminates. The pooled path is tb_http_connect + tb_http_request
// (keep-alive).
int64_t tb_http_get(const char* host, int port, const char* path,
                    const char* extra_headers, void* buf, int64_t buf_len,
                    int* status_out, int64_t* first_byte_ns_out,
                    int64_t* total_ns_out) {
  int64_t t_start = tb_now_ns();
  int fd = tb_http_connect(host, port);
  if (fd < 0) return fd;
  char hdrs[4096];
  int hm = snprintf(hdrs, sizeof hdrs, "%sConnection: close\r\n",
                    extra_headers ? extra_headers : "");
  if (hm <= 0 || hm >= static_cast<int>(sizeof hdrs)) {
    close(fd);
    return TB_EPROTO;
  }
  int64_t n = tb_http_request(fd, host, port, path, hdrs, buf,
                              buf_len, status_out, first_byte_ns_out,
                              nullptr, nullptr);
  close(fd);
  if (n >= 0 && total_ns_out) *total_ns_out = tb_now_ns() - t_start;
  return n;
}

// ------------------------------------------------------------- gRPC / h2 --
// Native receive for the gRPC path (SURVEY §2.5.1 names "HTTP/gRPC
// response bodies"): a hand-rolled minimal HTTP/2 client speaking exactly
// the google.storage.v2.Storage/ReadObject RPC shape over h2c prior
// knowledge (what an insecure gRPC port speaks) or TLS via the tb_conn
// layer. Scope decisions, made for a benchmark receive path rather than a
// general h2 stack:
//
// * HPACK: requests encode every header as "literal, never indexed, new
//   name", no huffman — minimal and legal. Responses are parsed
//   STRUCTURALLY: every entry form has explicit lengths, so entries can
//   be skipped exactly without maintaining the dynamic table or decoding
//   huffman; grpc-status is extracted opportunistically when it appears
//   in plain literal form, and success is otherwise judged by stream
//   completion + delivered byte count (the caller sized the buffer from
//   object metadata).
// * Flow control: we advertise a 2^31-1 stream window and widen the
//   connection window up front, then top both up as DATA is consumed.
// * One connection = sequential RPCs on odd stream ids (1, 3, 5, …) —
//   keep-alive parity with the pooled paths; no concurrent streams.
// * gRPC messages (5-byte length-prefixed ReadObjectResponse protos) are
//   reassembled in a scratch buffer, then ChecksummedData.content bytes
//   are copied into the caller's aligned buffer. That is one scratch→dest
//   copy — same count as the Python client's deserialize path, and the
//   protobuf wire format (length-delimited submessages) does not permit
//   landing content in place without first seeing the enclosing lengths.

namespace h2 {

// ---- frame io ----
static const uint8_t kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";

static int send_all(tb_conn* c, const uint8_t* p, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t k = conn_send(c, p + off, n - off);
    if (k < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    off += static_cast<size_t>(k);
  }
  return 0;
}

static int recv_all(tb_conn* c, uint8_t* p, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t k = conn_recv(c, p + off, n - off);
    if (k < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (k == 0) return TB_ESHORT;
    off += static_cast<size_t>(k);
  }
  return 0;
}

static void put32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24;
  p[1] = v >> 16;
  p[2] = v >> 8;
  p[3] = v;
}

static int send_frame(tb_conn* c, uint8_t type, uint8_t flags, uint32_t stream,
                      const uint8_t* payload, uint32_t len) {
  uint8_t hdr[9];
  hdr[0] = len >> 16;
  hdr[1] = len >> 8;
  hdr[2] = len;
  hdr[3] = type;
  hdr[4] = flags;
  put32(hdr + 5, stream & 0x7fffffffu);
  int rc = send_all(c, hdr, 9);
  if (rc != 0) return rc;
  if (len) rc = send_all(c, payload, len);
  return rc;
}

// ---- HPACK request encoding: literal never-indexed, new name, no huffman.
static size_t hp_int(uint8_t* out, uint64_t v) {
  // 7-bit prefix integer with a zeroed first byte (string length form).
  if (v < 127) {
    out[0] = static_cast<uint8_t>(v);
    return 1;
  }
  out[0] = 127;
  v -= 127;
  size_t n = 1;
  while (v >= 128) {
    out[n++] = static_cast<uint8_t>(v | 0x80);
    v >>= 7;
  }
  out[n++] = static_cast<uint8_t>(v);
  return n;
}

static size_t hp_header(uint8_t* out, const char* name, const char* value) {
  size_t n = 0;
  out[n++] = 0x10;  // literal never-indexed, name literal
  n += hp_int(out + n, strlen(name));
  memcpy(out + n, name, strlen(name));
  n += strlen(name);
  n += hp_int(out + n, strlen(value));
  memcpy(out + n, value, strlen(value));
  n += strlen(value);
  return n;
}

// ---- structural HPACK response parsing ----
// Decode a prefix integer; returns bytes consumed or 0 on truncation.
static size_t hpd_int(const uint8_t* p, size_t n, int prefix_bits,
                      uint64_t* out) {
  if (n == 0) return 0;
  uint64_t max_prefix = (1u << prefix_bits) - 1;
  uint64_t v = p[0] & max_prefix;
  size_t i = 1;
  if (v == max_prefix) {
    uint64_t m = 0;
    for (;;) {
      if (i >= n || m > 56) return 0;
      uint8_t b = p[i++];
      v += static_cast<uint64_t>(b & 0x7f) << m;
      if (!(b & 0x80)) break;
      m += 7;
    }
  }
  *out = v;
  return i;
}

// HPACK Huffman decoding (RFC 7541 §5.2 + Appendix B): canonical decode
// tree built once from the spec table. Real gRPC servers huffman-encode
// trailer names/values (grpc-status), so the parser must decode, not
// just skip.
struct HuffNode {
  int16_t next[2];
  int16_t sym;  // >= 0: leaf (256 = EOS)
};

static const HuffNode* huff_tree() {
  static HuffNode* tree = [] {
    // 257 codes x <= 30 bits bounds the node count.
    static HuffNode nodes[257 * 30 + 1];
    int count = 1;
    nodes[0] = {{-1, -1}, -1};
    for (int sym = 0; sym < 257; sym++) {
      uint32_t code = kHpackHuffman[sym].code;
      int bits = kHpackHuffman[sym].bits;
      int cur = 0;
      for (int b = bits - 1; b >= 0; b--) {
        int bit = (code >> b) & 1;
        if (nodes[cur].next[bit] < 0) {
          nodes[cur].next[bit] = static_cast<int16_t>(count);
          nodes[count] = {{-1, -1}, -1};
          count++;
        }
        cur = nodes[cur].next[bit];
      }
      nodes[cur].sym = static_cast<int16_t>(sym);
    }
    return nodes;
  }();
  return tree;
}

// Decode a huffman-coded string into out[cap]. Returns decoded length or
// -1 (EOS in stream, truncated code mid-symbol is tolerated as RFC
// padding, output overflow).
static int64_t huff_decode(const uint8_t* p, size_t n, uint8_t* out,
                           size_t cap) {
  const HuffNode* t = huff_tree();
  int cur = 0;
  size_t o = 0;
  for (size_t i = 0; i < n; i++) {
    for (int b = 7; b >= 0; b--) {
      int nxt = t[cur].next[(p[i] >> b) & 1];
      if (nxt < 0) return -1;
      cur = nxt;
      if (t[cur].sym >= 0) {
        if (t[cur].sym == 256) return -1;  // EOS must not appear
        if (o >= cap) return -1;
        out[o++] = static_cast<uint8_t>(t[cur].sym);
        cur = 0;
      }
    }
  }
  // Leftover bits are EOS-prefix padding (<= 7 bits), consumed above.
  return static_cast<int64_t>(o);
}

// One string (possibly huffman-coded): returns bytes consumed; *s/*slen
// point at the raw (still-encoded when *huff) payload.
static size_t hpd_str(const uint8_t* p, size_t n, const uint8_t** s,
                      size_t* slen, int* huff) {
  if (n == 0) return 0;
  *huff = p[0] & 0x80;
  uint64_t len;
  size_t i = hpd_int(p, n, 7, &len);
  if (i == 0 || len > n - i) return 0;
  *s = p + i;
  *slen = static_cast<size_t>(len);
  return i + static_cast<size_t>(len);
}

// Resolve a parsed string into a bounded plain-text buffer. Returns the
// plain length, or -1 when it cannot fit / cannot decode (caller treats
// the entry as not-the-one-it-wants — never fatal).
static int64_t hp_resolve(const uint8_t* s, size_t slen, int huff,
                          uint8_t* out, size_t cap) {
  if (!huff) {
    if (slen > cap) return -1;
    memcpy(out, s, slen);
    return static_cast<int64_t>(slen);
  }
  return huff_decode(s, slen, out, cap);
}

// Parse an ASCII-decimal value into *out (leaves it untouched on junk —
// including values that would overflow: a hostile 23-digit content-length
// must not reach signed-overflow UB in the accumulate).
static void parse_int_value(const uint8_t* v, int64_t n, int* out) {
  if (n <= 0) return;
  int st = 0;
  for (int64_t j = 0; j < n; j++) {
    if (v[j] < '0' || v[j] > '9') return;
    int d = v[j] - '0';
    if (st > (INT_MAX - d) / 10) return;
    st = st * 10 + d;
  }
  *out = st;
}

static void parse_int64_value(const uint8_t* v, int64_t n, int64_t* out) {
  if (n <= 0) return;
  int64_t st = 0;
  for (int64_t j = 0; j < n; j++) {
    if (v[j] < '0' || v[j] > '9') return;
    int64_t d = v[j] - '0';
    if (st > (INT64_MAX - d) / 10) return;
    st = st * 10 + d;
  }
  *out = st;
}

// h2 static-table :status entries (RFC 7541 Appendix A, indices 8-14):
// responses commonly encode the status as a single indexed byte (0x88 =
// ":status 200").
static int static_status(uint64_t idx) {
  static const int kStatus[] = {200, 204, 206, 304, 400, 404, 500};
  return (idx >= 8 && idx <= 14) ? kStatus[idx - 8] : -1;
}

// Walk one header block, extracting grpc-status (plain or huffman-coded
// literals; indexed entries cannot carry it — grpc-status is not in the
// h2 static table and we advertise a zero-size dynamic table) and, when
// ``http_status`` is given, :status (indexed static-table entries 8-14,
// literal-with-name-index 8, or a literal ":status" name). When
// ``content_len`` is given, content-length is extracted the same two
// ways (literal name, or literal with static name-index 28) so the raw
// h2 GET path can detect under-delivery — the h1 path's TB_ESHORT rule
// (tb_resp.content_len, above). Returns 0 on success, TB_EPROTO on a
// malformed block.
static int parse_header_block(const uint8_t* p, size_t n, int* grpc_status,
                              int* http_status = nullptr,
                              int64_t* content_len = nullptr) {
  size_t i = 0;
  while (i < n) {
    uint8_t b = p[i];
    uint64_t idx;
    size_t k;
    if (b & 0x80) {  // indexed field: nothing to skip beyond the index
      k = hpd_int(p + i, n - i, 7, &idx);
      if (k == 0) return TB_EPROTO;
      i += k;
      if (http_status) {
        int st = static_status(idx);
        if (st > 0) *http_status = st;
      }
      continue;
    } else if ((b & 0xe0) == 0x20) {  // dynamic table size update
      k = hpd_int(p + i, n - i, 5, &idx);
      if (k == 0) return TB_EPROTO;
      i += k;
      continue;
    } else if (b & 0x40) {  // literal with incremental indexing
      k = hpd_int(p + i, n - i, 6, &idx);
    } else {  // literal without indexing / never indexed (4-bit prefix)
      k = hpd_int(p + i, n - i, 4, &idx);
    }
    if (k == 0) return TB_EPROTO;
    int has_name_literal = (idx == 0);
    i += k;
    const uint8_t* name = nullptr;
    size_t name_len = 0;
    int name_huff = 0;
    if (has_name_literal) {
      k = hpd_str(p + i, n - i, &name, &name_len, &name_huff);
      if (k == 0) return TB_EPROTO;
      i += k;
    }
    const uint8_t* val = nullptr;
    size_t val_len = 0;
    int val_huff = 0;
    k = hpd_str(p + i, n - i, &val, &val_len, &val_huff);
    if (k == 0) return TB_EPROTO;
    i += k;
    if (name && (grpc_status || http_status || content_len)) {
      uint8_t nbuf[32];
      int64_t nl = hp_resolve(name, name_len, name_huff, nbuf, sizeof nbuf);
      int is_grpc = grpc_status && nl == 11 &&
                    memcmp(nbuf, "grpc-status", 11) == 0;
      int is_http = http_status && nl == 7 && memcmp(nbuf, ":status", 7) == 0;
      int is_clen = content_len && nl == 14 &&
                    memcmp(nbuf, "content-length", 14) == 0;
      if (is_grpc || is_http) {
        uint8_t vbuf[16];
        int64_t vl = hp_resolve(val, val_len, val_huff, vbuf, sizeof vbuf);
        parse_int_value(vbuf, vl, is_grpc ? grpc_status : http_status);
      } else if (is_clen) {
        uint8_t vbuf[24];
        int64_t vl = hp_resolve(val, val_len, val_huff, vbuf, sizeof vbuf);
        parse_int64_value(vbuf, vl, content_len);
      }
    } else if (!name && http_status && idx >= 8 && idx <= 14) {
      // Literal with an indexed NAME (static entries 8-14 all carry the
      // name ":status") and a literal value — how servers encode statuses
      // outside the static table's seven.
      uint8_t vbuf[16];
      int64_t vl = hp_resolve(val, val_len, val_huff, vbuf, sizeof vbuf);
      parse_int_value(vbuf, vl, http_status);
    } else if (!name && content_len && idx == 28) {
      // Static entry 28 is "content-length" (empty value) — servers
      // emit the header as literal-with-name-index 28 + literal value.
      uint8_t vbuf[24];
      int64_t vl = hp_resolve(val, val_len, val_huff, vbuf, sizeof vbuf);
      parse_int64_value(vbuf, vl, content_len);
    }
  }
  return 0;
}

// ---- minimal protobuf ----
static size_t pb_varint(uint8_t* out, uint64_t v) {
  size_t n = 0;
  while (v >= 128) {
    out[n++] = static_cast<uint8_t>(v | 0x80);
    v >>= 7;
  }
  out[n++] = static_cast<uint8_t>(v);
  return n;
}

static size_t pb_str(uint8_t* out, uint32_t field, const char* s) {
  size_t n = 0;
  out[n++] = static_cast<uint8_t>(field << 3 | 2);
  n += pb_varint(out + n, strlen(s));
  memcpy(out + n, s, strlen(s));
  return n + strlen(s);
}

static size_t pbd_varint(const uint8_t* p, size_t n, uint64_t* out) {
  uint64_t v = 0;
  size_t i = 0;
  int shift = 0;
  for (;;) {
    if (i >= n || shift > 63) return 0;
    uint8_t b = p[i++];
    v |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *out = v;
  return i;
}

// Extract ChecksummedData.content (field 1 of field 1) from one serialized
// ReadObjectResponse; appends into dst. Returns bytes appended or TB_EPROTO.
static int64_t pb_extract_content(const uint8_t* msg, size_t n, uint8_t* dst,
                                  int64_t dst_cap) {
  size_t i = 0;
  int64_t out = 0;
  while (i < n) {
    uint64_t tag;
    size_t k = pbd_varint(msg + i, n - i, &tag);
    if (k == 0) return TB_EPROTO;
    i += k;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = tag & 7;
    uint64_t len = 0;
    switch (wire) {
      case 0:  // varint
        k = pbd_varint(msg + i, n - i, &len);
        if (k == 0) return TB_EPROTO;
        i += k;
        break;
      case 1:  // fixed64
        if (i + 8 > n) return TB_EPROTO;
        i += 8;
        break;
      case 5:  // fixed32
        if (i + 4 > n) return TB_EPROTO;
        i += 4;
        break;
      case 2: {  // length-delimited
        k = pbd_varint(msg + i, n - i, &len);
        // Subtraction-form bound: i + k + len can wrap uint64.
        if (k == 0 || len > n - i - k) return TB_EPROTO;
        i += k;
        if (field == 1) {
          // checksummed_data submessage: find content (field 1, bytes).
          const uint8_t* sub = msg + i;
          size_t sn = static_cast<size_t>(len);
          size_t j = 0;
          while (j < sn) {
            uint64_t stag;
            size_t sk = pbd_varint(sub + j, sn - j, &stag);
            if (sk == 0) return TB_EPROTO;
            j += sk;
            uint32_t sfield = static_cast<uint32_t>(stag >> 3);
            uint32_t swire = stag & 7;
            uint64_t slen = 0;
            if (swire == 2) {
              sk = pbd_varint(sub + j, sn - j, &slen);
              // Subtraction form again: j + sk + slen can wrap uint64.
              if (sk == 0 || slen > sn - j - sk) return TB_EPROTO;
              j += sk;
              if (sfield == 1) {
                if (slen > static_cast<uint64_t>(dst_cap - out))
                  return TB_ETOOBIG;
                memcpy(dst + out, sub + j, slen);
                out += static_cast<int64_t>(slen);
              }
              j += static_cast<size_t>(slen);
            } else if (swire == 0) {
              sk = pbd_varint(sub + j, sn - j, &slen);
              if (sk == 0) return TB_EPROTO;
              j += sk;
            } else if (swire == 5) {
              if (j + 4 > sn) return TB_EPROTO;
              j += 4;
            } else if (swire == 1) {
              if (j + 8 > sn) return TB_EPROTO;
              j += 8;
            } else {
              return TB_EPROTO;
            }
          }
        }
        i += static_cast<size_t>(len);
        break;
      }
      default:
        return TB_EPROTO;
    }
  }
  return out;
}

}  // namespace h2

// -------------------------------------------------------- fetch executor --
// Native fan-out runtime (the errgroup analog in C++): N worker threads
// pull GET tasks from a queue, run the streaming receive into the task's
// caller-owned aligned buffer over a per-thread keep-alive connection, and
// push completions to a ring the caller drains — the per-request hot path
// never touches the Python interpreter. HTTP/1.1 over plaintext or TLS
// (pool-level transport config); gRPC fan-out rides the Python-orchestrated
// pools or the multiplexed h2 stream machinery above.
namespace fp {

struct Task {
  char host[256];
  int port;
  char path[1024];
  char headers[2048];
  uint8_t* buf;
  int64_t buf_len;
  uint64_t tag;  // caller correlation id
  // results
  int64_t start_ns;  // request start (CLOCK_MONOTONIC): first-byte
                     // latency = first_byte_ns - start_ns
  int64_t result;  // body length or negative TB_*/-errno
  int status;
  int64_t first_byte_ns;
  int64_t total_ns;
  // Reactor-mode fields (legacy thread pool ignores them):
  Task* next;    // intrusive FIFO link (target queue / submit inbox)
  int attempt;   // stale-keep-alive retransmit budget consumed
};

// Both executor flavors return an opaque int64 handle whose pointee
// BEGINS with a kind tag, so every tb_pool_* entry point dispatches on
// the same handle type (Python never needs to know which it holds).
enum { kPoolKindThreads = 0x7b01, kPoolKindReactor = 0x7b02 };

struct Pool {
  int kind;  // kPoolKindThreads — MUST stay the first member
  pthread_mutex_t mu;
  pthread_cond_t sub_cv;   // signals workers: task available / shutdown
  pthread_cond_t done_cv;  // signals consumer: completion available
  Task** subq;             // submission ring
  Task** doneq;            // completion ring
  int cap;
  int sub_head, sub_len;
  int done_head, done_len;
  int inflight;  // submitted but not yet in doneq
  int shutdown;
  pthread_t* threads;
  int n_threads;
  // Endpoint transport (pool-level: a pool serves one endpoint class):
  // tls wraps each worker connection via the tb_conn TLS layer, verified
  // against `cafile`/system store with the task host as SNI.
  int tls;
  int insecure;
  char cafile[512];
};

struct WorkerConn {
  char host[256];
  int port;
  int64_t h;  // tb_conn handle; 0 = none
};

static void wc_close(WorkerConn* wc) {
  if (wc->h > 0) tb_conn_close(wc->h);
  wc->h = 0;
}

// Discard-mode GET (task buf == NULL): stream the body through one hot
// granule-sized scratch window and drop it — the reference's io.Discard
// hot loop (main.go:140) and the Python staging-"none" path both discard
// this way, so the fetch-only A/B compares like with like (landing a
// whole 48 MB body through DRAM costs real memory bandwidth the discard
// path never pays). Returns total body bytes or a negative code.
static const int64_t kDiscardScratch = 2 << 20;  // reference granule

static int64_t discard_get(WorkerConn* wc, Task* t, uint8_t* scratch,
                           int* reusable_out) {
  int status = 0;
  int64_t clen = -1, fb = 0;
  int64_t rc = tb_conn_get_begin(wc->h, t->host, t->port, t->path,
                                 t->headers, &status, &clen, &fb);
  if (rc != 0) return rc;
  t->status = status;
  t->first_byte_ns = fb;
  int64_t total = 0;
  for (;;) {
    int64_t k = tb_conn_body_read(wc->h, scratch, kDiscardScratch);
    if (k < 0) return k;
    if (k == 0) break;
    total += k;
  }
  tb_conn_get_end(wc->h, reusable_out);
  return total;
}

static void* worker_main(void* arg) {
  Pool* p = static_cast<Pool*>(arg);
  WorkerConn wc;
  wc.host[0] = 0;
  wc.port = -1;
  wc.h = 0;
  uint8_t* scratch = nullptr;  // lazily allocated, discard tasks only
  for (;;) {
    pthread_mutex_lock(&p->mu);
    while (p->sub_len == 0 && !p->shutdown)
      pthread_cond_wait(&p->sub_cv, &p->mu);
    if (p->sub_len == 0 && p->shutdown) {
      pthread_mutex_unlock(&p->mu);
      break;
    }
    Task* t = p->subq[p->sub_head];
    p->sub_head = (p->sub_head + 1) % p->cap;
    p->sub_len--;
    pthread_mutex_unlock(&p->mu);

    // Per-thread keep-alive: reuse the connection while the target
    // matches (the benchmark pattern: one endpoint, many GETs).
    if (wc.h > 0 && (strcmp(wc.host, t->host) != 0 || wc.port != t->port))
      wc_close(&wc);
    int attempt = 0;
    for (;;) {
      int fresh = 0;
      if (wc.h <= 0) {
        int fd = tb_http_connect(t->host, t->port);
        if (fd < 0) {
          t->result = fd;
          break;
        }
        int64_t h = p->tls
                        ? tb_conn_tls(fd, t->host, p->cafile, p->insecure, 0)
                        : tb_conn_plain(fd);
        if (h <= 0) {
          close(fd);  // handshake failed: fd still ours
          t->result = h;
          break;
        }
        wc.h = h;
        snprintf(wc.host, sizeof wc.host, "%s", t->host);
        wc.port = t->port;
        fresh = 1;
      }
      int reusable = 0;
      t->start_ns = tb_now_ns();
      if (t->buf == nullptr) {
        if (!scratch)
          scratch = static_cast<uint8_t*>(malloc(kDiscardScratch));
        t->result = scratch ? discard_get(&wc, t, scratch, &reusable)
                            : -ENOMEM;
        t->total_ns = tb_now_ns() - t->start_ns;
      } else {
        t->result = tb_conn_request(wc.h, t->host, t->port, t->path,
                                    t->headers, t->buf, t->buf_len,
                                    &t->status, &t->first_byte_ns,
                                    &t->total_ns, &reusable);
      }
      if (t->result >= 0) {
        if (!reusable) wc_close(&wc);
        break;
      }
      wc_close(&wc);
      // One retransmit when the FIRST use of a kept-alive connection
      // failed (stale pool socket) — same discipline as NativeConnPool,
      // including its permanent-code carve-out: protocol-shape failures
      // (TB_EPROTO/TB_ETOOBIG/TB_ECHUNKED/TB_ETLS) reproduce on a fresh
      // socket, so a retransmit only re-measures the failure.
      int permanent = t->result == TB_EPROTO || t->result == TB_ETOOBIG ||
                      t->result == TB_ECHUNKED || t->result == TB_ETLS;
      if (!fresh && attempt == 0 && !permanent) {
        attempt = 1;
        continue;
      }
      break;
    }

    pthread_mutex_lock(&p->mu);
    p->doneq[(p->done_head + p->done_len) % p->cap] = t;
    p->done_len++;
    pthread_cond_signal(&p->done_cv);
    pthread_mutex_unlock(&p->mu);
  }
  wc_close(&wc);
  free(scratch);
  return nullptr;
}

}  // namespace fp

// ------------------------------------------------ reactor-mode executor --
// The epoll rebuild of the fetch pool (ROADMAP item 3): BENCH_r05 measured
// the thread-per-connection pool LOSING to the pure-Python hot loop on a
// share-capped host because every completion pays a mutex/condvar crossing
// and every connection pays a context switch. Reactor mode replaces both:
//
//   * One (or a few) event-loop threads own ALL connections through epoll;
//     a connection is a nonblocking HTTP/1.1 state machine
//     (CONNECT→SEND→HEADERS→BODY→IDLE) with keep-alive reuse, so many
//     in-flight GETs share few sockets and zero per-request threads.
//   * Completions travel to the consumer over a lock-free SPSC ring per
//     loop (producer = the loop thread, consumer = the draining caller)
//     with an eventfd doorbell rung only on the ring's empty→nonempty
//     transition — the steady-state hot path has NO lock crossing and no
//     syscall per completion; one consumer wake drains the whole backlog.
//   * Submission stays mutex-guarded (it is the cold path: the Python
//     caller already serializes submits) with its own eventfd doorbell
//     into the loop.
//
// Scope: HTTP/1.1 and HTTP/2 over plaintext or TLS. TLS is a nonblocking
// OpenSSL state machine driven by WANT_READ/WANT_WRITE off epoll
// readiness (C_TLS_HANDSHAKE below), with session resumption cached per
// target for keep-alive reconnects. h2 grows the same state machine to
// frame multiplexing: many concurrent streams ride one connection (the
// per-target FIFO's in-flight dimension), with connection+stream
// flow-control credit surfaced through tb_stats_*. ALPN picks h2 vs
// http/1.1 per target; plaintext h2 uses prior knowledge (test servers).
// Error-code and retransmit contracts match the legacy pool exactly: the
// first use of a kept-alive connection gets one retransmit on a fresh
// socket (transient codes only); per-task errors land in the completion's
// result; the pool itself survives.
namespace rx {

enum {
  C_CONNECTING = 0,
  C_TLS_HANDSHAKE,  // SSL_connect in flight, driven by epoll readiness
  C_SEND,
  C_HDR,
  C_BODY,
  C_IDLE,
  C_H2,             // established h2 session (streams carry the tasks)
};

// SSL_get_error results the nonblocking machine dispatches on.
enum {
  kSslErrWantRead = 2,
  kSslErrWantWrite = 3,
  kSslErrSyscall = 5,
  kSslErrZeroReturn = 6,
};

struct Loop;
struct Target;

// One h2 stream in flight on a reactor connection (id == 0 = slot free).
struct H2Stream {
  uint32_t id;
  fp::Task* task;
  int64_t body_got;
  int status;            // :status from response HEADERS (0 until seen)
  int64_t content_len;   // -1 until response HEADERS carry content-length
  int got_headers;
  int64_t unacked;       // consumed DATA not yet returned as stream window
};

static const int kRxH2Streams = 32;              // streams per connection
static const int64_t kRxStreamWindow = 1 << 20;  // SETTINGS initial window
static const int64_t kRxConnWindow = 1 << 23;    // connection window target
static const int kRxH2OutCap = 32 * 1024;        // pending-frame send buffer

struct Conn {
  int fd;
  int state;
  int fresh;        // no request completed on this connection yet
  int registered;   // fd added to the loop's epoll set
  uint32_t events;  // current epoll interest
  Target* target;
  Loop* loop;
  fp::Task* task;   // in-flight task (null when IDLE); during
                    // CONNECTING/TLS_HANDSHAKE: the task waiting for the
                    // transport to come up (not yet begun)
  int64_t last_activity_ns;
  int resp_bytes;   // any response bytes seen for the CURRENT task
  int dead;         // closed this iteration; freed at the batch edge
  // TLS (nonblocking): ssl != null once the handshake starts. tls_want
  // records the last WANT_READ/WANT_WRITE so the epoll interest can
  // follow OpenSSL's state machine, not just the socket direction.
  void* ssl;
  int tls_want;     // 0, EPOLLIN or EPOLLOUT
  // request send state
  char req[4608];
  int req_len, req_off;
  // response header state
  uint8_t hdr[16384];
  int hlen;
  // parsed response state
  int status, http_minor, server_close, junk;
  int64_t content_len, body_got;
  // body bytes that arrived in the same recv as the headers
  int lo_off, lo_len;  // window into hdr[]
  // ---- h2 flavor (ALPN selected h2, or prior-knowledge mode) ----
  int h2;                   // transport is h2
  int h2_started;           // preface+SETTINGS queued
  uint32_t h2_next_stream;  // next odd stream id
  int h2_nstreams;          // active streams
  int h2_peer_max_streams;  // peer SETTINGS_MAX_CONCURRENT_STREAMS
  uint8_t* h2_out;          // pending frame bytes (lazily allocated)
  int h2_out_len, h2_out_off;
  int64_t h2_wu_queued_ns;  // oldest unflushed WINDOW_UPDATE enqueue time
  uint8_t h2_fh[9];         // frame-header accumulate
  int h2_fh_got;
  uint32_t h2_flen, h2_fstream;
  uint8_t h2_ftype, h2_fflags;
  int h2_fbuf_got;          // non-DATA payload accumulated into hdr[]
  int h2_data_rem;          // DATA payload bytes still to stream
  int h2_pad_rem;           // trailing padding still to discard
  int h2_pad_pending;       // PADDED flag seen, pad-length byte unread
  int64_t h2_conn_unacked;  // consumed bytes not yet conn-window-updated
  uint8_t* h2_hb;           // HEADERS+CONTINUATION accumulate (lazy)
  int h2_hb_len;
  uint32_t h2_hdr_stream;   // stream whose header block is accumulating
  uint8_t h2_hdr_flags;     // flags of the initiating HEADERS frame
  int h2_hdr_cont;          // awaiting CONTINUATION
  H2Stream h2_streams[kRxH2Streams];
  Conn* next;  // intrusive list per target
};

static const int kRxH2HbCap = 32 * 1024;  // header-block accumulate cap

struct Target {
  char host[256];
  int port;
  int resolved;  // sockaddr cached (getaddrinfo once per target)
  struct sockaddr_storage addr;
  socklen_t addr_len;
  void* tls_session;  // cached SSL_SESSION: resumption on reconnect
  fp::Task *q_head, *q_tail;  // pending tasks FIFO
  Conn* conns;
  int n_conns;
  Target* next;
};

struct Reactor;

struct Loop {
  Reactor* r;
  pthread_t thread;
  int started;
  int epfd;
  int submit_efd;  // doorbell: submissions / shutdown
  // SPSC completion ring: loop thread produces, the draining caller
  // consumes. Capacity >= pool cap, so it can never overflow (inflight
  // is capped at submit time).
  fp::Task** ring;
  uint32_t ring_mask;
  uint32_t ring_head;  // producer-owned (atomic)
  uint32_t ring_tail;  // consumer-owned (atomic)
  // submit inbox (mutex: cold path)
  pthread_mutex_t in_mu;
  fp::Task *in_head, *in_tail;
  Target* targets;
  int max_conns;  // this loop's share of the connection budget
  uint8_t* scratch;  // discard-mode landing window (loop-thread-owned)
  int ding_pending;  // completions enqueued since the last doorbell
                     // flush (loop-thread-local)
  Conn* dead;        // conns closed mid-iteration, freed at the batch
                     // edge — an epoll_wait batch can still hold a
                     // pending event whose data.ptr is such a conn
                     // (EPOLL_CTL_DEL does not retract already-returned
                     // events), so the memory must outlive the batch
};

struct Reactor {
  int kind;  // fp::kPoolKindReactor — MUST stay the first member
  int cap;
  int n_loops;
  int done_efd;  // consumer doorbell, shared by all loops
  int shutdown;  // atomic
  int inflight;  // atomic
  uint64_t rr;   // round-robin submit cursor (atomic)
  Loop* loops;
  // Endpoint transport (reactor-wide, mirroring fp::Pool's):
  int tls;
  int insecure;
  int h2_mode;   // 0 = h1 only; 1 = ALPN h2-or-http/1.1 (TLS);
                 // 2 = h2 prior knowledge (plaintext test servers)
  char cafile[512];
  void* ssl_ctx; // one owned SSL_CTX reference for the reactor lifetime
};

static const int64_t kIoTimeoutNs = 60LL * 1000000000LL;  // legacy parity
static const int64_t kDiscardWin = 256 * 1024;

// ---- SPSC ring ----
static void ring_push(Loop* L, fp::Task* t) {
  uint32_t h = __atomic_load_n(&L->ring_head, __ATOMIC_RELAXED);
  uint32_t tl = __atomic_load_n(&L->ring_tail, __ATOMIC_ACQUIRE);
  uint32_t depth = h - tl;
  L->ring[h & L->ring_mask] = t;
  __atomic_store_n(&L->ring_head, h + 1, __ATOMIC_RELEASE);
  tb_stat_add(TB_STAT_REACTOR_COMPLETIONS, 1);
  tb_stat_add(TB_STAT_REACTOR_RING_DEPTH_SUM, depth + 1);
  tb_stat_max(TB_STAT_REACTOR_RING_DEPTH_MAX, depth + 1);
  // Doorbell COALESCING: the ring is not rung per completion but when
  // kDingBatch completions have piled up (and always at the end of the
  // loop iteration) — one consumer wake hands over a batch. Measured on
  // the loopback A/B: per-completion dings wake the consumer so eagerly
  // that batches collapse to 1 (the handoff tax in eventfd form), while
  // flushing ONLY at iteration end serializes consumer against loop
  // (goodput halves). The threshold keeps both: batches ≥ kDingBatch at
  // high completion rate, iteration-end latency bound at low rate.
  L->ding_pending++;
}

static const int kDingBatch = 16;

static void ding_flush(Loop* L) {
  if (!L->ding_pending) return;
  L->ding_pending = 0;
  uint64_t one = 1;
  ssize_t k = write(L->r->done_efd, &one, sizeof one);
  (void)k;
  tb_stat_add(TB_STAT_REACTOR_DOORBELL_WAKES, 1);
}

// Drain up to max_n completed tasks across all loop rings (consumer side
// of the SPSC contract: ONE draining thread at a time, which is what the
// Python executor does — the legacy pool's multi-consumer mutex is the
// cost this path exists to remove).
static int ring_drain(Reactor* r, int max_n, fp::Task** out) {
  int n = 0;
  for (int li = 0; li < r->n_loops && n < max_n; li++) {
    Loop* L = &r->loops[li];
    uint32_t tl = __atomic_load_n(&L->ring_tail, __ATOMIC_RELAXED);
    uint32_t h = __atomic_load_n(&L->ring_head, __ATOMIC_ACQUIRE);
    while (tl != h && n < max_n) {
      out[n++] = L->ring[tl & L->ring_mask];
      tl++;
    }
    __atomic_store_n(&L->ring_tail, tl, __ATOMIC_RELEASE);
  }
  return n;
}

// ---- completion ----
static void complete_task(Loop* L, fp::Task* t, int64_t result) {
  t->result = result;
  t->total_ns = tb_now_ns() - t->start_ns;
  ring_push(L, t);
}

// ---- transport I/O (plaintext or nonblocking TLS) ----
// Same contract as send/recv on a nonblocking socket: >0 bytes moved,
// 0 = orderly EOF (recv only), -1 with errno. OpenSSL's WANT_READ /
// WANT_WRITE both surface as errno=EAGAIN with c->tls_want recording
// WHICH readiness unblocks the machine (an SSL_read can want EPOLLOUT
// mid-renegotiation) so callers can set epoll interest accordingly.
static ssize_t rx_send(Conn* c, const void* p, size_t n) {
  if (!c->ssl) {
    ssize_t k = send(c->fd, p, n, MSG_NOSIGNAL);
    if (k > 0) tb_stat_add(TB_STAT_BYTES_TX, k);
    return k;
  }
  if (n > kTlsIoCap) n = kTlsIoCap;
  errno = 0;
  int k = tls::SSL_write_(c->ssl, p, static_cast<int>(n));
  if (k > 0) {
    c->tls_want = 0;
    tb_stat_add(TB_STAT_BYTES_TX, k);
    return k;
  }
  int err = tls::SSL_get_error_(c->ssl, k);
  if (err == kSslErrWantRead) {
    c->tls_want = EPOLLIN;
    errno = EAGAIN;
    return -1;
  }
  if (err == kSslErrWantWrite) {
    c->tls_want = EPOLLOUT;
    errno = EAGAIN;
    return -1;
  }
  if (err == kSslErrSyscall && errno == EINTR) return -1;  // caller loops
  if (errno == 0 || errno == EAGAIN) errno = ECONNRESET;
  return -1;  // classified transient, like any mid-stream break (legacy)
}

static ssize_t rx_recv(Conn* c, void* p, size_t n) {
  if (!c->ssl) {
    ssize_t k = recv(c->fd, p, n, 0);
    if (k > 0) tb_stat_add(TB_STAT_BYTES_RX, k);
    return k;
  }
  if (n > kTlsIoCap) n = kTlsIoCap;
  errno = 0;
  int k = tls::SSL_read_(c->ssl, p, static_cast<int>(n));
  if (k > 0) {
    c->tls_want = 0;
    tb_stat_add(TB_STAT_BYTES_RX, k);
    return k;
  }
  int err = tls::SSL_get_error_(c->ssl, k);
  if (err == kSslErrZeroReturn) return 0;  // close_notify = orderly EOF
  if (err == kSslErrWantRead) {
    c->tls_want = EPOLLIN;
    errno = EAGAIN;
    return -1;
  }
  if (err == kSslErrWantWrite) {
    c->tls_want = EPOLLOUT;
    errno = EAGAIN;
    return -1;
  }
  if (err == kSslErrSyscall && k == 0) return 0;  // EOF sans close_notify
  if (err == kSslErrSyscall && errno == EINTR) return -1;  // caller loops
  if (errno == 0 || errno == EAGAIN) errno = ECONNRESET;
  return -1;
}

// ---- connection helpers ----
static void conn_want(Conn* c, uint32_t ev) {
  if (c->registered && c->events == ev) return;
  struct epoll_event e;
  e.events = ev;
  e.data.ptr = c;
  epoll_ctl(c->loop->epfd, c->registered ? EPOLL_CTL_MOD : EPOLL_CTL_ADD,
            c->fd, &e);
  c->registered = 1;
  c->events = ev;
}

// Close + unlink a connection, DEFERRING the free to the batch edge
// (dead list): the current epoll_wait batch may still hold an event for
// this conn, and loop_main must be able to recognize and skip it.
static void conn_free(Loop* L, Conn* c) {
  Target* t = c->target;
  Conn** pp = &t->conns;
  while (*pp && *pp != c) pp = &(*pp)->next;
  if (*pp) *pp = c->next;
  t->n_conns--;
  epoll_ctl(L->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  if (c->ssl) {
    tls::SSL_shutdown_(c->ssl);  // best-effort close_notify (nonblocking)
    tls::SSL_free_(c->ssl);
    c->ssl = nullptr;
  }
  free(c->h2_out);
  c->h2_out = nullptr;
  free(c->h2_hb);
  c->h2_hb = nullptr;
  close(c->fd);
  tb_stat_add(TB_STAT_CONN_CLOSES, 1);
  c->dead = 1;
  c->next = L->dead;
  L->dead = c;
}

// Batch edge: no event returned by the PREVIOUS epoll_wait can still
// reference these (DEL + close happened before the next wait).
static void reap_dead(Loop* L) {
  Conn* c = L->dead;
  L->dead = nullptr;
  while (c) {
    Conn* nxt = c->next;
    free(c);
    c = nxt;
  }
}

static void target_queue_push(Target* t, fp::Task* task, int front) {
  task->next = nullptr;
  if (front) {
    task->next = t->q_head;
    t->q_head = task;
    if (!t->q_tail) t->q_tail = task;
  } else if (t->q_tail) {
    t->q_tail->next = task;
    t->q_tail = task;
  } else {
    t->q_head = t->q_tail = task;
  }
}

static fp::Task* target_queue_pop(Target* t) {
  fp::Task* task = t->q_head;
  if (!task) return nullptr;
  t->q_head = task->next;
  if (!t->q_head) t->q_tail = nullptr;
  task->next = nullptr;
  return task;
}

static void pump_target(Loop* L, Target* t);

// Fail the conn's current task. When the failure happened on the FIRST
// use of a kept-alive connection with nothing of the response seen yet,
// the task gets one retransmit on a fresh socket — the legacy pool's
// stale-connection discipline, permanent-code carve-out included.
static void conn_fail(Loop* L, Conn* c, int64_t code) {
  fp::Task* task = c->task;
  c->task = nullptr;
  Target* t = c->target;
  int was_fresh = c->fresh;
  int saw_bytes = c->resp_bytes;
  conn_free(L, c);
  if (task) {
    int permanent = code == TB_EPROTO || code == TB_ETOOBIG ||
                    code == TB_ECHUNKED || code == TB_ETLS;
    if (!was_fresh && !saw_bytes && task->attempt == 0 && !permanent) {
      task->attempt = 1;
      target_queue_push(t, task, /*front=*/1);
    } else {
      complete_task(L, task, code);
    }
  }
  pump_target(L, t);
}

// Cache this connection's TLS session on the target so the NEXT fresh
// connection resumes it (abbreviated handshake on keep-alive reconnect).
// Captured on the first completed request, not at handshake time: TLS 1.3
// session tickets arrive after the handshake, and by the first response
// they have been consumed into the session.
static void tls_cache_session(Conn* c) {
  if (!c->ssl || !c->fresh) return;
  void* sess = tls::SSL_get1_session_(c->ssl);
  if (!sess) return;
  if (c->target->tls_session)
    tls::SSL_SESSION_free_(c->target->tls_session);
  c->target->tls_session = sess;
}

// Finish the current task successfully and decide connection reuse.
static void conn_finish(Loop* L, Conn* c) {
  fp::Task* task = c->task;
  c->task = nullptr;
  tls_cache_session(c);
  c->fresh = 0;
  task->status = c->status;
  int reusable = c->content_len >= 0 && !c->server_close &&
                 c->http_minor >= 1 && !c->junk &&
                 !(c->ssl && tls::SSL_pending_(c->ssl) > 0);
  complete_task(L, task, c->body_got);
  if (!reusable) {
    Target* t = c->target;
    conn_free(L, c);
    pump_target(L, t);
    return;
  }
  c->state = C_IDLE;
  c->resp_bytes = 0;
  conn_want(c, EPOLLIN);  // idle: readable means FIN/junk → close
  pump_target(L, c->target);
}

// =================== h2 flavor: nonblocking frame multiplexing ==========
// The h1 state machine above owns one task per connection; the h2 flavor
// owns a STREAM TABLE — queued tasks become concurrent streams on the
// same socket, which is where the per-target FIFO's in-flight dimension
// moves from sockets to stream ids. Frame building reuses the blocking
// path's HPACK helpers (h2::hp_header / h2::parse_header_block); frame
// I/O is rebuilt nonblocking: sends accumulate in h2_out and drain on
// writability, DATA payloads stream straight into task buffers.

static void conn_h2_io(Loop* L, Conn* c);

// Ensure `need` bytes of send-buffer room (compacts; lazily allocates).
static int h2_out_room(Conn* c, int need) {
  if (!c->h2_out) {
    c->h2_out = static_cast<uint8_t*>(malloc(kRxH2OutCap));
    if (!c->h2_out) return 0;
  }
  if (c->h2_out_off > 0) {
    memmove(c->h2_out, c->h2_out + c->h2_out_off,
            c->h2_out_len - c->h2_out_off);
    c->h2_out_len -= c->h2_out_off;
    c->h2_out_off = 0;
  }
  return kRxH2OutCap - c->h2_out_len >= need;
}

// Append one frame (caller guaranteed room via h2_out_room).
static void h2_out_frame(Conn* c, uint8_t type, uint8_t flags,
                         uint32_t stream, const uint8_t* payload,
                         uint32_t len) {
  uint8_t* p = c->h2_out + c->h2_out_len;
  p[0] = len >> 16;
  p[1] = len >> 8;
  p[2] = len;
  p[3] = type;
  p[4] = flags;
  h2::put32(p + 5, stream & 0x7fffffffu);
  if (len) memcpy(p + 9, payload, len);
  c->h2_out_len += 9 + static_cast<int>(len);
}

// Queue the session prologue: preface, SETTINGS (zero HPACK dynamic
// table — parse_header_block never indexes; finite per-stream window so
// flow control is real, not 2^31-sized), push disabled, and the
// connection window top-up.
static int h2_session_begin(Conn* c) {
  if (!h2_out_room(c, 128)) return -ENOMEM;
  memcpy(c->h2_out + c->h2_out_len, h2::kPreface, 24);
  c->h2_out_len += 24;
  uint8_t s[18];
  s[0] = 0; s[1] = 0x1;  // HEADER_TABLE_SIZE = 0
  h2::put32(s + 2, 0);
  s[6] = 0; s[7] = 0x2;  // ENABLE_PUSH = 0
  h2::put32(s + 8, 0);
  s[12] = 0; s[13] = 0x4;  // INITIAL_WINDOW_SIZE
  h2::put32(s + 14, static_cast<uint32_t>(kRxStreamWindow));
  h2_out_frame(c, 4, 0, 0, s, 18);
  uint8_t wu[4];
  h2::put32(wu, static_cast<uint32_t>(kRxConnWindow - 65535));
  h2_out_frame(c, 8, 0, 0, wu, 4);
  tb_stat_add(TB_STAT_H2_WINDOW_UPDATES_TX, 1);
  c->h2_started = 1;
  c->h2_next_stream = 1;
  c->h2_peer_max_streams = kRxH2Streams;
  c->state = C_H2;
  return 0;
}

// Can this connection take another queued task as a new stream?
static int h2_can_admit(Conn* c) {
  if (!c->h2 || !c->h2_started || c->dead) return 0;
  int max = c->h2_peer_max_streams < kRxH2Streams ? c->h2_peer_max_streams
                                                  : kRxH2Streams;
  if (c->h2_nstreams >= max) return 0;
  if (c->h2_next_stream >= 0x40000000u) return 0;  // id space spent
  // Room for a worst-case HEADERS frame, keeping slack for control
  // frames (ACKs / WINDOW_UPDATEs are tens of bytes).
  return h2_out_room(c, 4608 + 9 + 256);
}

static H2Stream* rx_h2_stream_of(Conn* c, uint32_t id) {
  if (id == 0) return nullptr;
  for (int i = 0; i < kRxH2Streams; i++)
    if (c->h2_streams[i].id == id) return &c->h2_streams[i];
  return nullptr;
}

static void h2_stream_done(Loop* L, Conn* c, H2Stream* s, int64_t result) {
  fp::Task* task = s->task;
  task->status = s->status;
  s->id = 0;
  s->task = nullptr;
  c->h2_nstreams--;
  tls_cache_session(c);
  c->fresh = 0;  // a completed stream proves the connection live
  complete_task(L, task, result);
}

// Fail one stream, honoring the stale-keep-alive retransmit discipline
// per stream: first failure on a NON-fresh connection with none of this
// stream's response seen retransmits once on a fresh socket.
static void h2_stream_fail(Loop* L, Conn* c, H2Stream* s, int64_t code) {
  fp::Task* task = s->task;
  int saw = s->got_headers || s->body_got > 0;
  s->id = 0;
  s->task = nullptr;
  c->h2_nstreams--;
  int permanent = code == TB_EPROTO || code == TB_ETOOBIG ||
                  code == TB_ECHUNKED || code == TB_ETLS;
  if (!c->fresh && !saw && task->attempt == 0 && !permanent) {
    task->attempt = 1;
    target_queue_push(c->target, task, /*front=*/1);
  } else {
    complete_task(L, task, code);
  }
}

// Connection-level failure: every active stream settles (retransmit rule
// per stream), then the socket dies.
static void h2_conn_fail(Loop* L, Conn* c, int64_t code) {
  Target* t = c->target;
  for (int i = 0; i < kRxH2Streams; i++)
    if (c->h2_streams[i].id) h2_stream_fail(L, c, &c->h2_streams[i], code);
  if (c->task) {  // transport-pending task (pre-session failure)
    fp::Task* task = c->task;
    c->task = nullptr;
    complete_task(L, task, code);
  }
  conn_free(L, c);
  pump_target(L, t);
}

// Open a queued task as a new stream: HPACK-encode the request (h2 wants
// lowercase names; Host becomes :authority) and queue HEADERS with
// END_STREAM|END_HEADERS.
static void h2_admit(Loop* L, Conn* c, fp::Task* task) {
  uint8_t hb[4608];
  size_t n = 0;
  char auth[300];
  snprintf(auth, sizeof auth, "%s:%d", task->host, task->port);
  n += h2::hp_header(hb + n, ":method", "GET");
  n += h2::hp_header(hb + n, ":scheme", c->loop->r->tls ? "https" : "http");
  n += h2::hp_header(hb + n, ":authority", auth);
  n += h2::hp_header(hb + n, ":path", task->path);
  const char* h = task->headers;
  char name[256], val[2048];
  int bad = 0;
  while (*h && !bad) {
    const char* eol = strstr(h, "\r\n");
    if (!eol) eol = h + strlen(h);
    const char* colon = static_cast<const char*>(
        memchr(h, ':', static_cast<size_t>(eol - h)));
    if (colon && colon > h) {
      size_t nl = static_cast<size_t>(colon - h);
      const char* v = colon + 1;
      while (v < eol && *v == ' ') v++;
      size_t vl = static_cast<size_t>(eol - v);
      if (nl >= sizeof name || vl >= sizeof val) {
        bad = 1;
        break;
      }
      for (size_t i = 0; i < nl; i++)
        name[i] = static_cast<char>(tolower(static_cast<unsigned char>(h[i])));
      name[nl] = 0;
      memcpy(val, v, vl);
      val[vl] = 0;
      // Connection-specific headers don't exist in h2; Host rode in as
      // :authority above.
      if (strcmp(name, "host") != 0 && strcmp(name, "connection") != 0) {
        if (n + nl + vl + 12 > sizeof hb) {
          bad = 1;
          break;
        }
        n += h2::hp_header(hb + n, name, val);
      }
    }
    h = *eol ? eol + 2 : eol;
  }
  if (bad) {
    complete_task(L, task, TB_EPROTO);
    return;
  }
  H2Stream* s = nullptr;
  for (int i = 0; i < kRxH2Streams; i++)
    if (c->h2_streams[i].id == 0) {
      s = &c->h2_streams[i];
      break;
    }
  if (!s || !h2_out_room(c, static_cast<int>(n) + 9)) {
    // h2_can_admit guards both; belt+braces.
    target_queue_push(c->target, task, /*front=*/1);
    return;
  }
  memset(s, 0, sizeof *s);
  s->id = c->h2_next_stream;
  c->h2_next_stream += 2;
  s->task = task;
  s->content_len = -1;
  c->h2_nstreams++;
  task->start_ns = tb_now_ns();
  h2_out_frame(c, 1, 0x4 | 0x1 /*END_HEADERS|END_STREAM*/, s->id, hb,
               static_cast<uint32_t>(n));
  tb_stat_add(TB_STAT_H2_STREAMS_OPENED, 1);
  tb_stat_add(TB_STAT_REACTOR_H2_STREAMS, 1);
}

// Return consumed flow-control credit. The WHOLE DATA frame length
// (padding included) counts against both windows, so the caller credits
// once per frame. Updates are queued at half-window consumption;
// REACTOR_FLOW_STALL_NS measures how long queued credit waits for the
// wire (stamped here, settled when h2_out drains).
static void h2_credit(Conn* c, H2Stream* s, int64_t nbytes) {
  c->h2_conn_unacked += nbytes;
  if (s) s->unacked += nbytes;
  int queued = 0;
  uint8_t wu[4];
  if (c->h2_conn_unacked > kRxConnWindow / 2 && h2_out_room(c, 13)) {
    h2::put32(wu, static_cast<uint32_t>(c->h2_conn_unacked));
    h2_out_frame(c, 8, 0, 0, wu, 4);
    c->h2_conn_unacked = 0;
    tb_stat_add(TB_STAT_H2_WINDOW_UPDATES_TX, 1);
    queued = 1;
  }
  if (s && s->unacked > kRxStreamWindow / 2 && h2_out_room(c, 13)) {
    h2::put32(wu, static_cast<uint32_t>(s->unacked));
    h2_out_frame(c, 8, 0, s->id, wu, 4);
    s->unacked = 0;
    tb_stat_add(TB_STAT_H2_WINDOW_UPDATES_TX, 1);
    queued = 1;
  }
  if (queued && !c->h2_wu_queued_ns) c->h2_wu_queued_ns = tb_now_ns();
}

// A stream's response ended (END_STREAM): settle against content-length
// the way the h1 machine settles against TB_ESHORT.
static void h2_stream_end(Loop* L, Conn* c, H2Stream* s) {
  if (s->content_len >= 0 && s->body_got != s->content_len) {
    h2_stream_fail(L, c, s,
                   s->body_got < s->content_len ? TB_ESHORT : TB_EPROTO);
    return;
  }
  h2_stream_done(L, c, s, s->body_got);
}

// Parse one complete header block for a stream (response HEADERS or
// trailers). Returns 0, or a connection-fatal code.
static int64_t h2_on_header_block(Loop* L, Conn* c, const uint8_t* p,
                                  size_t n, uint32_t stream_id,
                                  int end_stream) {
  int status = 0;
  int64_t clen = -1;
  if (h2::parse_header_block(p, n, nullptr, &status, &clen) != 0)
    return TB_EPROTO;
  H2Stream* s = rx_h2_stream_of(c, stream_id);
  if (!s) return 0;  // already settled (e.g. RST after overflow)
  if (!s->got_headers) {
    s->got_headers = 1;
    s->status = status ? status : s->status;
    if (clen >= 0) s->content_len = clen;
    if (s->task->first_byte_ns == 0) s->task->first_byte_ns = tb_now_ns();
    // The h1 machine rejects a known-length body that can't fit before
    // landing a byte; same here.
    if (s->task->buf && s->content_len > s->task->buf_len) {
      h2_stream_fail(L, c, s, TB_ETOOBIG);
      return 0;
    }
  }
  if (end_stream && s->id) h2_stream_end(L, c, s);
  return 0;
}

// Dispatch one fully-buffered non-DATA frame (payload in c->hdr).
// Returns 0, or a code that fails the whole connection.
static int64_t h2_on_frame(Loop* L, Conn* c) {
  const uint8_t* p = c->hdr;
  uint32_t len = c->h2_flen;
  switch (c->h2_ftype) {
    case 1: {  // HEADERS
      uint32_t off = 0, end = len;
      if (c->h2_fflags & 0x8) {  // PADDED
        if (len < 1) return TB_EPROTO;
        uint8_t pl = p[0];
        off = 1;
        if (1u + pl > len) return TB_EPROTO;
        end = len - pl;
      }
      if (c->h2_fflags & 0x20) {  // PRIORITY fields
        if (off + 5 > end) return TB_EPROTO;
        off += 5;
      }
      if (off > end) return TB_EPROTO;
      if (c->h2_fflags & 0x4) {  // END_HEADERS: parse in place
        return h2_on_header_block(L, c, p + off, end - off, c->h2_fstream,
                                  c->h2_fflags & 0x1);
      }
      // CONTINUATION follows: start accumulating.
      if (!c->h2_hb) {
        c->h2_hb = static_cast<uint8_t*>(malloc(kRxH2HbCap));
        if (!c->h2_hb) return -ENOMEM;
      }
      if (end - off > static_cast<uint32_t>(kRxH2HbCap)) return TB_EPROTO;
      memcpy(c->h2_hb, p + off, end - off);
      c->h2_hb_len = static_cast<int>(end - off);
      c->h2_hdr_stream = c->h2_fstream;
      c->h2_hdr_flags = c->h2_fflags;
      c->h2_hdr_cont = 1;
      return 0;
    }
    case 9: {  // CONTINUATION
      if (!c->h2_hdr_cont || c->h2_fstream != c->h2_hdr_stream)
        return TB_EPROTO;
      if (c->h2_hb_len + len > static_cast<uint32_t>(kRxH2HbCap))
        return TB_EPROTO;
      memcpy(c->h2_hb + c->h2_hb_len, p, len);
      c->h2_hb_len += static_cast<int>(len);
      if (c->h2_fflags & 0x4) {
        c->h2_hdr_cont = 0;
        return h2_on_header_block(L, c, c->h2_hb,
                                  static_cast<size_t>(c->h2_hb_len),
                                  c->h2_hdr_stream, c->h2_hdr_flags & 0x1);
      }
      return 0;
    }
    case 3: {  // RST_STREAM
      if (len != 4) return TB_EPROTO;
      tb_stat_add(TB_STAT_H2_RST_RX, 1);
      H2Stream* s = rx_h2_stream_of(c, c->h2_fstream);
      if (s) h2_stream_fail(L, c, s, -ECONNRESET);
      return 0;
    }
    case 4: {  // SETTINGS
      if (c->h2_fflags & 0x1) return 0;  // ACK of ours
      if (len % 6 != 0) return TB_EPROTO;
      for (uint32_t i = 0; i + 6 <= len; i += 6) {
        uint16_t id = static_cast<uint16_t>(p[i] << 8 | p[i + 1]);
        uint32_t v = static_cast<uint32_t>(p[i + 2]) << 24 |
                     static_cast<uint32_t>(p[i + 3]) << 16 |
                     static_cast<uint32_t>(p[i + 4]) << 8 | p[i + 5];
        if (id == 0x3)  // MAX_CONCURRENT_STREAMS (0 would deadlock: clamp)
          c->h2_peer_max_streams =
              v == 0 ? 1
                     : (v > static_cast<uint32_t>(kRxH2Streams)
                            ? kRxH2Streams
                            : static_cast<int>(v));
      }
      if (!h2_out_room(c, 9)) return -ENOMEM;
      h2_out_frame(c, 4, 0x1 /*ACK*/, 0, nullptr, 0);
      return 0;
    }
    case 6: {  // PING
      if (len != 8) return TB_EPROTO;
      if (c->h2_fflags & 0x1) return 0;
      if (!h2_out_room(c, 17)) return -ENOMEM;
      h2_out_frame(c, 6, 0x1 /*ACK*/, 0, p, 8);
      return 0;
    }
    case 7:  // GOAWAY: the peer is done with this connection
      tb_stat_add(TB_STAT_H2_GOAWAY_RX, 1);
      return -ECONNRESET;
    case 5:  // PUSH_PROMISE with ENABLE_PUSH=0 advertised is a violation
      return TB_EPROTO;
    default:  // PRIORITY / WINDOW_UPDATE (we send no DATA) / unknown
      return 0;
  }
}
static void conn_begin(Loop* L, Conn* c, fp::Task* task) {
  c->task = task;
  c->resp_bytes = 0;
  c->hlen = 0;
  c->status = 0;
  c->http_minor = 0;
  c->server_close = 0;
  c->junk = 0;
  c->content_len = -1;
  c->body_got = 0;
  c->lo_off = c->lo_len = 0;
  task->start_ns = tb_now_ns();
  c->req_len = snprintf(
      c->req, sizeof c->req,
      "GET %s HTTP/1.1\r\nHost: %s:%d\r\nUser-Agent: tpubench-native\r\n"
      "%s\r\n",
      task->path, task->host, task->port, task->headers);
  c->req_off = 0;
  if (c->req_len <= 0 || c->req_len >= static_cast<int>(sizeof c->req)) {
    complete_task(L, c->task, TB_EPROTO);
    c->task = nullptr;
    c->state = C_IDLE;
    return;
  }
  c->state = C_SEND;
  c->last_activity_ns = tb_now_ns();
  conn_want(c, EPOLLIN | EPOLLOUT);
}

static void conn_io(Loop* L, Conn* c);

// ---- TLS handshake (nonblocking SSL_connect off epoll readiness) ----

// Attach an SSL object to a connected fd: SNI + hostname verification +
// ALPN offer + cached-session resumption, mirroring tb_conn_tls's setup.
// Returns 0 (state = C_TLS_HANDSHAKE) or TB_ETLS.
static int64_t rx_tls_begin(Loop* L, Conn* c) {
  Reactor* r = L->r;
  Target* t = c->target;
  void* ssl = tls::SSL_new_(r->ssl_ctx);
  if (!ssl) return TB_ETLS;
  // SNI (SSL_set_tlsext_host_name macro = SSL_ctrl 55/0).
  tls::SSL_ctrl_(ssl, 55, 0, t->host);
  if (!r->insecure) {
    void* param = tls::SSL_get0_param_(ssl);
    struct in_addr a4;
    struct in6_addr a6;
    int is_ip = inet_pton(AF_INET, t->host, &a4) == 1 ||
                inet_pton(AF_INET6, t->host, &a6) == 1;
    int ok = is_ip ? tls::X509_VERIFY_PARAM_set1_ip_asc_(param, t->host)
                   : tls::X509_VERIFY_PARAM_set1_host_(param, t->host, 0);
    if (ok != 1) {
      tls::SSL_free_(ssl);
      return TB_ETLS;
    }
  }
  if (r->h2_mode == 1) {
    // Offer h2 AND http/1.1: unlike the gRPC conn path, the reactor has
    // an h1 state machine to fall back to when the server declines h2.
    static const unsigned char kAlpn[] = {2,  'h', '2', 8,   'h', 't',
                                          't', 'p', '/', '1', '.', '1'};
    if (tls::SSL_set_alpn_protos_(ssl, kAlpn, sizeof kAlpn) != 0) {
      tls::SSL_free_(ssl);
      return TB_ETLS;
    }
  }
  if (t->tls_session) tls::SSL_set_session_(ssl, t->tls_session);
  if (tls::SSL_set_fd_(ssl, c->fd) != 1) {
    tls::SSL_free_(ssl);
    return TB_ETLS;
  }
  c->ssl = ssl;
  c->state = C_TLS_HANDSHAKE;
  return 0;
}

static void conn_transport_ready(Loop* L, Conn* c);

// Drive SSL_connect one readiness notification's worth: WANT_READ /
// WANT_WRITE retune the epoll interest; completion classifies ALPN and
// hands off; failure is terminal for the pending task (handshakes only
// ever run on fresh sockets — legacy parity with the worker's
// tb_conn_tls failure path, transient-errno carve-out included).
static void rx_tls_handshake(Loop* L, Conn* c) {
  errno = 0;
  int k = tls::SSL_connect_(c->ssl);
  if (k == 1) {
    tb_stat_add(TB_STAT_TLS_HANDSHAKES, 1);
    tb_stat_add(TB_STAT_REACTOR_TLS_HANDSHAKES, 1);
    if (tls::SSL_session_reused_(c->ssl))
      tb_stat_add(TB_STAT_REACTOR_TLS_RESUMES, 1);
    if (L->r->h2_mode == 1) {
      const unsigned char* sel = nullptr;
      unsigned sel_len = 0;
      tls::SSL_get0_alpn_selected_(c->ssl, &sel, &sel_len);
      if (sel_len == 2 && memcmp(sel, "h2", 2) == 0) c->h2 = 1;
    }
    conn_transport_ready(L, c);
    return;
  }
  int err = tls::SSL_get_error_(c->ssl, k);
  if (err == kSslErrWantRead) {
    conn_want(c, EPOLLIN);
    return;
  }
  if (err == kSslErrWantWrite) {
    conn_want(c, EPOLLOUT);
    return;
  }
  int e = errno;
  int64_t code = (e == EAGAIN || e == EWOULDBLOCK || e == ETIMEDOUT ||
                  e == ECONNRESET || e == EPIPE || e == EINTR)
                     ? -e
                     : TB_ETLS;
  fp::Task* task = c->task;
  c->task = nullptr;
  Target* t = c->target;
  conn_free(L, c);
  if (task) complete_task(L, task, code);
  pump_target(L, t);
}

// The transport (TCP, and TLS when configured) is up: start the h2
// session or begin the pending h1 request.
static void conn_transport_ready(Loop* L, Conn* c) {
  fp::Task* task = c->task;
  c->task = nullptr;
  if (c->h2) {
    if (h2_session_begin(c) != 0) {
      Target* t = c->target;
      conn_free(L, c);
      if (task) complete_task(L, task, -ENOMEM);
      pump_target(L, t);
      return;
    }
    if (task) h2_admit(L, c, task);
    conn_h2_io(L, c);  // flush the prologue + HEADERS now
    if (!c->dead) pump_target(L, c->target);
    return;
  }
  if (!task) {  // nothing pending anymore (cannot happen today)
    c->state = C_IDLE;
    conn_want(c, EPOLLIN);
    pump_target(L, c->target);
    return;
  }
  conn_begin(L, c, task);
  if (c->task && c->state == C_SEND) conn_io(L, c);
}

// TCP connect completed: count it and enter the transport bring-up.
static void conn_connected(Loop* L, Conn* c) {
  tb_stat_add(TB_STAT_CONNECTS, 1);
  if (L->r->tls) {
    int64_t rc = rx_tls_begin(L, c);
    if (rc != 0) {
      fp::Task* task = c->task;
      c->task = nullptr;
      Target* t = c->target;
      conn_free(L, c);
      if (task) complete_task(L, task, rc);
      pump_target(L, t);
      return;
    }
    rx_tls_handshake(L, c);
    return;
  }
  conn_transport_ready(L, c);
}

// Open a new nonblocking connection for `t` carrying `task`.
static void conn_open(Loop* L, Target* t, fp::Task* task) {
  if (!t->resolved) {
    char portstr[16];
    snprintf(portstr, sizeof portstr, "%d", t->port);
    struct addrinfo hints, *res = nullptr;
    memset(&hints, 0, sizeof hints);
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    if (getaddrinfo(t->host, portstr, &hints, &res) != 0 || !res) {
      complete_task(L, task, TB_ERESOLVE);
      return;
    }
    memcpy(&t->addr, res->ai_addr, res->ai_addrlen);
    t->addr_len = res->ai_addrlen;
    freeaddrinfo(res);
    t->resolved = 1;
  }
  int fd = socket(t->addr.ss_family, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) {
    complete_task(L, task, -errno);
    return;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  Conn* c = static_cast<Conn*>(calloc(1, sizeof(Conn)));
  if (!c) {
    close(fd);
    complete_task(L, task, -ENOMEM);
    return;
  }
  c->fd = fd;
  c->loop = L;
  c->target = t;
  c->fresh = 1;
  if (L->r->h2_mode == 2) c->h2 = 1;  // prior-knowledge h2c
  c->task = task;  // pending: begun once the transport is up
  task->start_ns = tb_now_ns();
  c->next = t->conns;
  t->conns = c;
  t->n_conns++;
  int rc = connect(fd, reinterpret_cast<struct sockaddr*>(&t->addr),
                   t->addr_len);
  if (rc == 0) {
    conn_connected(L, c);
    return;
  }
  if (errno != EINPROGRESS) {
    // conn_fail would retransmit; a connect failure on a FRESH socket is
    // terminal for the task (legacy parity: tb_http_connect error).
    int cerr = errno;
    c->task = nullptr;
    conn_free(L, c);
    complete_task(L, task, -cerr);
    pump_target(L, t);
    return;
  }
  c->state = C_CONNECTING;
  conn_want(c, EPOLLOUT);
}

// Admit queued tasks: reuse idle connections first, then open new ones
// up to this loop's connection budget — the multiplexing that lets many
// in-flight GETs share few sockets. Exception: a task on its
// stale-keep-alive RETRANSMIT (attempt > 0) must land on a FRESH socket
// (the legacy-pool contract) — another idle keep-alive conn may be
// exactly as stale (a server idle-timeout typically FINs the whole pool
// at once), and a second stale failure would surface a spurious error.
static void pump_target(Loop* L, Target* t) {
  for (;;) {
    if (!t->q_head) return;
    // h2: established connections with free stream slots take queued
    // tasks first — the FIFO's in-flight dimension is stream ids, not
    // sockets. Retransmits still demand a FRESH socket (below).
    if (t->q_head->attempt == 0) {
      Conn* hc = nullptr;
      for (Conn* c = t->conns; c; c = c->next)
        if (h2_can_admit(c)) {
          hc = c;
          break;
        }
      if (hc) {
        h2_admit(L, hc, target_queue_pop(t));
        conn_h2_io(L, hc);  // flush the HEADERS now
        continue;
      }
    }
    Conn* idle = nullptr;
    for (Conn* c = t->conns; c; c = c->next)
      if (c->state == C_IDLE && !c->task) {
        idle = c;
        break;
      }
    if (t->q_head->attempt > 0) {
      if (t->n_conns >= L->max_conns) {
        if (!idle) return;   // all busy: wait for capacity
        conn_free(L, idle);  // suspect idle socket makes the room
      }
      conn_open(L, t, target_queue_pop(t));
      continue;
    }
    if (idle) {
      fp::Task* task = target_queue_pop(t);
      conn_begin(L, idle, task);
      if (idle->state == C_SEND) conn_io(L, idle);
      continue;
    }
    if (t->n_conns >= L->max_conns) return;
    fp::Task* task = target_queue_pop(t);
    conn_open(L, t, task);
  }
}

// ---- response parsing (nonblocking flavor of http_begin) ----
static int64_t parse_headers(Conn* c) {
  c->hdr[c->hlen] = 0;
  char* h = reinterpret_cast<char*>(c->hdr);
  char* p = static_cast<char*>(memmem(h, c->hlen, "\r\n\r\n", 4));
  if (!p) return 1;  // need more bytes
  char* body_start = p + 4;
  int body_in_hdr = c->hlen - static_cast<int>(body_start - h);
  if (sscanf(h, "HTTP/1.%d %d", &c->http_minor, &c->status) != 2)
    return TB_EPROTO;
  for (char* line = h; line < body_start;) {
    char* eol = static_cast<char*>(memmem(line, body_start - line, "\r\n", 2));
    if (!eol) break;
    if (strncasecmp(line, "Content-Length:", 15) == 0)
      c->content_len = strtoll(line + 15, nullptr, 10);
    if (strncasecmp(line, "Transfer-Encoding:", 18) == 0) {
      for (char* q = line + 18; q + 7 <= eol; q++)
        if (strncasecmp(q, "chunked", 7) == 0) return TB_ECHUNKED;
    }
    if (strncasecmp(line, "Connection:", 11) == 0) {
      for (char* q = line + 11; q + 5 <= eol; q++)
        if (strncasecmp(q, "close", 5) == 0) c->server_close = 1;
    }
    line = eol + 2;
  }
  // Keep-alive response with no body delimiter: unreadable (the reactor
  // never sends "Connection: close" — it exists to pool connections).
  if (c->content_len < 0 && !c->server_close && c->http_minor >= 1)
    return TB_EPROTO;
  c->lo_off = static_cast<int>(body_start - h);
  c->lo_len = c->lo_off + body_in_hdr;
  if (c->content_len >= 0 && body_in_hdr > c->content_len) c->junk = 1;
  return 0;
}

// Land body bytes into the task's destination (or the loop's discard
// scratch). Returns dest pointer + capacity for the next recv.
static uint8_t* body_dest(Loop* L, Conn* c, int64_t* cap) {
  fp::Task* t = c->task;
  if (t->buf == nullptr) {
    *cap = kDiscardWin;
    return L->scratch;
  }
  *cap = t->buf_len - c->body_got;
  return t->buf + c->body_got;
}

static void conn_body_done(Loop* L, Conn* c) { conn_finish(L, c); }

// One readiness notification worth of I/O on a connection: advance the
// state machine until EAGAIN or the task settles.
static void conn_io(Loop* L, Conn* c) {
  c->last_activity_ns = tb_now_ns();
  if (c->state == C_H2) {
    conn_h2_io(L, c);
    return;
  }
  if (c->state == C_TLS_HANDSHAKE) {
    rx_tls_handshake(L, c);
    return;
  }
  if (c->state == C_CONNECTING) {
    int err = 0;
    socklen_t len = sizeof err;
    getsockopt(c->fd, SOL_SOCKET, SO_ERROR, &err, &len);
    if (err != 0) {
      // Fresh-socket connect failure: terminal (legacy parity).
      fp::Task* task = c->task;
      c->task = nullptr;
      Target* t = c->target;
      conn_free(L, c);
      if (task) complete_task(L, task, -err);
      pump_target(L, t);
      return;
    }
    conn_connected(L, c);
    return;
  }
  if (c->state == C_SEND) {
    while (c->req_off < c->req_len) {
      ssize_t k = rx_send(c, c->req + c->req_off, c->req_len - c->req_off);
      if (k < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          // A TLS write can want READ readiness (and vice versa): follow
          // the state machine, not the socket direction.
          conn_want(c, c->ssl && c->tls_want == EPOLLIN
                           ? EPOLLIN
                           : EPOLLIN | EPOLLOUT);
          return;
        }
        conn_fail(L, c, errno ? -errno : -ECONNRESET);
        return;
      }
      c->req_off += static_cast<int>(k);
    }
    c->state = C_HDR;
    conn_want(c, EPOLLIN);
  }
  if (c->state == C_HDR) {
    for (;;) {
      int cap = static_cast<int>(sizeof c->hdr) - 1 - c->hlen;
      if (cap <= 0) {
        conn_fail(L, c, TB_EPROTO);
        return;
      }
      ssize_t k = rx_recv(c, c->hdr + c->hlen, cap);
      if (k < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          conn_want(c, c->ssl && c->tls_want == EPOLLOUT
                           ? EPOLLIN | EPOLLOUT
                           : EPOLLIN);
          return;
        }
        conn_fail(L, c, errno ? -errno : -ECONNRESET);
        return;
      }
      if (k == 0) {
        conn_fail(L, c, TB_ESHORT);
        return;
      }
      c->resp_bytes = 1;
      if (c->task->first_byte_ns == 0) c->task->first_byte_ns = tb_now_ns();
      c->hlen += static_cast<int>(k);
      int64_t rc = parse_headers(c);
      if (rc == 1) continue;  // headers incomplete
      if (rc != 0) {
        conn_fail(L, c, rc);
        return;
      }
      c->state = C_BODY;
      // Serve leftover body bytes that rode in with the headers.
      int64_t lo = c->lo_len - c->lo_off;
      if (lo > 0) {
        if (c->content_len >= 0 && lo > c->content_len) lo = c->content_len;
        if (c->task->buf != nullptr) {
          if (lo > c->task->buf_len) {
            conn_fail(L, c, TB_ETOOBIG);
            return;
          }
          memcpy(c->task->buf, c->hdr + c->lo_off, lo);
        }
        c->body_got = lo;
      }
      if (c->content_len >= 0 && c->body_got >= c->content_len) {
        conn_body_done(L, c);
        return;
      }
      break;
    }
  }
  if (c->state == C_BODY) {
    for (;;) {
      int64_t cap = 0;
      uint8_t* dst = body_dest(L, c, &cap);
      int64_t left = c->content_len >= 0 ? c->content_len - c->body_got
                                         : INT64_MAX;
      if (c->task->buf != nullptr && cap <= 0 && left > 0) {
        if (c->content_len >= 0) {  // known length doesn't fit
          conn_fail(L, c, TB_ETOOBIG);
          return;
        }
        // Close-delimited body that exactly fills the buffer: probe one
        // byte — EOF proves an exact fit; more data is a real overflow
        // (legacy request_on parity).
        uint8_t probe;
        ssize_t pk = rx_recv(c, &probe, 1);
        if (pk < 0) {
          if (errno == EINTR) continue;
          if (errno == EAGAIN || errno == EWOULDBLOCK) {
            conn_want(c, c->ssl && c->tls_want == EPOLLOUT
                             ? EPOLLIN | EPOLLOUT
                             : EPOLLIN);
            return;
          }
          conn_fail(L, c, errno ? -errno : -ECONNRESET);
          return;
        }
        if (pk == 0) {
          conn_body_done(L, c);
          return;
        }
        conn_fail(L, c, TB_ETOOBIG);
        return;
      }
      int64_t want = cap < left ? cap : left;
      if (want <= 0) {
        conn_body_done(L, c);
        return;
      }
      ssize_t k = rx_recv(c, dst, static_cast<size_t>(want));
      if (k < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          conn_want(c, c->ssl && c->tls_want == EPOLLOUT
                           ? EPOLLIN | EPOLLOUT
                           : EPOLLIN);
          return;
        }
        conn_fail(L, c, errno ? -errno : -ECONNRESET);
        return;
      }
      if (k == 0) {
        if (c->content_len < 0) {
          conn_body_done(L, c);  // close-delimited: FIN ends the body
          return;
        }
        conn_fail(L, c, TB_ESHORT);
        return;
      }
      c->body_got += k;
      if (c->content_len >= 0 && c->body_got >= c->content_len) {
        conn_body_done(L, c);
        return;
      }
    }
  }
  if (c->state == C_IDLE) {
    // Readable while idle = server FIN or junk: either way, not a
    // connection we may reuse.
    Target* t = c->target;
    conn_free(L, c);
    pump_target(L, t);
  }
}

// One readiness notification worth of h2 I/O: drain the send buffer,
// then consume frames until EAGAIN. DATA payloads stream directly into
// task buffers (discard tasks land in the loop scratch); non-DATA frames
// buffer whole in c->hdr (bounded by the default 16384 MAX_FRAME_SIZE we
// never raise) and dispatch through h2_on_frame.
static void conn_h2_io(Loop* L, Conn* c) {
  if (c->dead) return;
  c->last_activity_ns = tb_now_ns();
  // ---- send side ----
  for (;;) {
    if (c->h2_out_off >= c->h2_out_len) {
      c->h2_out_off = c->h2_out_len = 0;
      if (c->h2_wu_queued_ns) {
        tb_stat_add(TB_STAT_REACTOR_FLOW_STALL_NS,
                    tb_now_ns() - c->h2_wu_queued_ns);
        c->h2_wu_queued_ns = 0;
      }
      break;
    }
    ssize_t k = rx_send(c, c->h2_out + c->h2_out_off,
                        c->h2_out_len - c->h2_out_off);
    if (k < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      h2_conn_fail(L, c, errno ? -errno : -ECONNRESET);
      return;
    }
    c->h2_out_off += static_cast<int>(k);
  }
  // ---- receive side ----
  int blocked = 0;
  while (!blocked) {
    if (c->h2_fh_got < 9) {
      ssize_t k = rx_recv(c, c->h2_fh + c->h2_fh_got, 9 - c->h2_fh_got);
      if (k < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          blocked = 1;
          break;
        }
        h2_conn_fail(L, c, errno ? -errno : -ECONNRESET);
        return;
      }
      if (k == 0) {
        // Orderly close: with streams in flight it's an early end
        // (TB_ESHORT, per-stream retransmit rule applies); an idle
        // keep-alive close settles nothing.
        h2_conn_fail(L, c, TB_ESHORT);
        return;
      }
      c->h2_fh_got += static_cast<int>(k);
      if (c->h2_fh_got < 9) continue;
      c->h2_flen = static_cast<uint32_t>(c->h2_fh[0]) << 16 |
                   static_cast<uint32_t>(c->h2_fh[1]) << 8 | c->h2_fh[2];
      c->h2_ftype = c->h2_fh[3];
      c->h2_fflags = c->h2_fh[4];
      c->h2_fstream = (static_cast<uint32_t>(c->h2_fh[5]) << 24 |
                       static_cast<uint32_t>(c->h2_fh[6]) << 16 |
                       static_cast<uint32_t>(c->h2_fh[7]) << 8 | c->h2_fh[8]) &
                      0x7fffffffu;
      tb_stat_add(TB_STAT_H2_FRAMES_RX, 1);
      if (c->h2_ftype == 0) {  // DATA: stream it
        tb_stat_add(TB_STAT_H2_DATA_BYTES_RX, c->h2_flen);
        // The WHOLE payload (padding included) counts against both
        // flow-control windows; credit once, up front.
        h2_credit(c, rx_h2_stream_of(c, c->h2_fstream), c->h2_flen);
        c->h2_data_rem = static_cast<int>(c->h2_flen);
        c->h2_pad_rem = 0;
        c->h2_pad_pending = (c->h2_fflags & 0x8) ? 1 : 0;
      } else {
        if (c->h2_flen > sizeof c->hdr) {
          h2_conn_fail(L, c, TB_EPROTO);
          return;
        }
        c->h2_fbuf_got = 0;
      }
    }
    if (c->h2_ftype == 0) {
      if (c->h2_pad_pending) {
        uint8_t pl;
        ssize_t k = rx_recv(c, &pl, 1);
        if (k < 0) {
          if (errno == EINTR) continue;
          if (errno == EAGAIN || errno == EWOULDBLOCK) {
            blocked = 1;
            break;
          }
          h2_conn_fail(L, c, errno ? -errno : -ECONNRESET);
          return;
        }
        if (k == 0) {
          h2_conn_fail(L, c, TB_ESHORT);
          return;
        }
        if (1u + pl > c->h2_flen) {
          h2_conn_fail(L, c, TB_EPROTO);
          return;
        }
        c->h2_pad_pending = 0;
        c->h2_data_rem = static_cast<int>(c->h2_flen) - 1 - pl;
        c->h2_pad_rem = pl;
      }
      while (c->h2_data_rem > 0) {
        H2Stream* s = rx_h2_stream_of(c, c->h2_fstream);
        uint8_t* dst;
        int64_t cap;
        if (s && s->task->buf) {
          cap = s->task->buf_len - s->body_got;
          dst = s->task->buf + s->body_got;
          if (cap <= 0) {
            // Over-delivery into a sized buffer: stream-level TB_ETOOBIG
            // (permanent), cancel the stream, swallow the rest.
            uint32_t sid = s->id;
            h2_stream_fail(L, c, s, TB_ETOOBIG);
            if (h2_out_room(c, 13)) {
              uint8_t rst[4];
              h2::put32(rst, 0x8 /*CANCEL*/);
              h2_out_frame(c, 3, 0, sid, rst, 4);
            }
            continue;
          }
        } else {
          dst = L->scratch;
          cap = kDiscardWin;
        }
        int64_t want = cap < c->h2_data_rem ? cap : c->h2_data_rem;
        ssize_t k = rx_recv(c, dst, static_cast<size_t>(want));
        if (k < 0) {
          if (errno == EINTR) continue;
          if (errno == EAGAIN || errno == EWOULDBLOCK) {
            blocked = 1;
            break;
          }
          h2_conn_fail(L, c, errno ? -errno : -ECONNRESET);
          return;
        }
        if (k == 0) {
          h2_conn_fail(L, c, TB_ESHORT);
          return;
        }
        c->h2_data_rem -= static_cast<int>(k);
        if (s) {
          if (s->body_got == 0 && s->task->first_byte_ns == 0)
            s->task->first_byte_ns = tb_now_ns();
          s->body_got += k;
        }
      }
      if (blocked) break;
      while (c->h2_pad_rem > 0) {
        int64_t want =
            c->h2_pad_rem < kDiscardWin ? c->h2_pad_rem : kDiscardWin;
        ssize_t k = rx_recv(c, L->scratch, static_cast<size_t>(want));
        if (k < 0) {
          if (errno == EINTR) continue;
          if (errno == EAGAIN || errno == EWOULDBLOCK) {
            blocked = 1;
            break;
          }
          h2_conn_fail(L, c, errno ? -errno : -ECONNRESET);
          return;
        }
        if (k == 0) {
          h2_conn_fail(L, c, TB_ESHORT);
          return;
        }
        c->h2_pad_rem -= static_cast<int>(k);
      }
      if (blocked) break;
      if (c->h2_fflags & 0x1) {  // END_STREAM
        H2Stream* s = rx_h2_stream_of(c, c->h2_fstream);
        if (s) h2_stream_end(L, c, s);
      }
      c->h2_fh_got = 0;
      continue;
    }
    // Non-DATA: buffer the whole payload, then dispatch.
    while (c->h2_fbuf_got < static_cast<int>(c->h2_flen)) {
      ssize_t k =
          rx_recv(c, c->hdr + c->h2_fbuf_got, c->h2_flen - c->h2_fbuf_got);
      if (k < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          blocked = 1;
          break;
        }
        h2_conn_fail(L, c, errno ? -errno : -ECONNRESET);
        return;
      }
      if (k == 0) {
        h2_conn_fail(L, c, TB_ESHORT);
        return;
      }
      c->h2_fbuf_got += static_cast<int>(k);
    }
    if (blocked) break;
    int64_t rc = h2_on_frame(L, c);
    if (rc != 0) {
      h2_conn_fail(L, c, rc);
      return;
    }
    c->h2_fh_got = 0;
  }
  if (c->dead) return;
  uint32_t ev = EPOLLIN;
  if (c->h2_out_off < c->h2_out_len) ev |= EPOLLOUT;
  if (c->ssl && c->tls_want == EPOLLOUT) ev |= EPOLLOUT;
  conn_want(c, ev);
}

static Target* find_target(Loop* L, const char* host, int port) {
  for (Target* t = L->targets; t; t = t->next)
    if (t->port == port && strcmp(t->host, host) == 0) return t;
  Target* t = static_cast<Target*>(calloc(1, sizeof(Target)));
  if (!t) return nullptr;
  snprintf(t->host, sizeof t->host, "%s", host);
  t->port = port;
  t->next = L->targets;
  L->targets = t;
  return t;
}

static void dispatch_task(Loop* L, fp::Task* task) {
  Target* t = find_target(L, task->host, task->port);
  if (!t) {
    complete_task(L, task, -ENOMEM);
    return;
  }
  target_queue_push(t, task, /*front=*/0);
  pump_target(L, t);
}

static void sweep_timeouts(Loop* L) {
  int64_t now = tb_now_ns();
  for (Target* t = L->targets; t; t = t->next) {
    Conn* c = t->conns;
    while (c) {
      Conn* nxt = c->next;
      int busy = c->task != nullptr || (c->h2 && c->h2_nstreams > 0);
      if (busy && now - c->last_activity_ns > kIoTimeoutNs) {
        // Same surface as the legacy pool's SO_RCVTIMEO expiry: every
        // in-flight task fails -EAGAIN (transient, bypasses the stale
        // retransmit rule), the connection dies.
        fp::Task* task = c->task;
        c->task = nullptr;
        for (int si = 0; si < kRxH2Streams; si++) {
          if (!c->h2_streams[si].id) continue;
          fp::Task* st = c->h2_streams[si].task;
          c->h2_streams[si].id = 0;
          c->h2_streams[si].task = nullptr;
          c->h2_nstreams--;
          complete_task(L, st, -EAGAIN);
        }
        conn_free(L, c);
        if (task) complete_task(L, task, -EAGAIN);
        pump_target(L, t);
        // conn list mutated: restart the walk for this target.
        nxt = t->conns;
      }
      c = nxt;
    }
  }
}

static void* loop_main(void* arg) {
  Loop* L = static_cast<Loop*>(arg);
  Reactor* r = L->r;
  struct epoll_event evs[64];
  int64_t last_sweep = tb_now_ns();
  while (!__atomic_load_n(&r->shutdown, __ATOMIC_ACQUIRE)) {
    int n = epoll_wait(L->epfd, evs, 64, 500);
    tb_stat_add(TB_STAT_REACTOR_LOOPS, 1);
    if (n > 0) tb_stat_add(TB_STAT_REACTOR_EPOLL_EVENTS, n);
    if (__atomic_load_n(&r->shutdown, __ATOMIC_ACQUIRE)) break;
    for (int i = 0; i < n; i++) {
      if (evs[i].data.ptr == L) {
        // Submission doorbell: drain the eventfd, then the inbox.
        uint64_t v;
        ssize_t k = read(L->submit_efd, &v, sizeof v);
        (void)k;
        pthread_mutex_lock(&L->in_mu);
        fp::Task* head = L->in_head;
        L->in_head = L->in_tail = nullptr;
        pthread_mutex_unlock(&L->in_mu);
        while (head) {
          fp::Task* nxt = head->next;
          head->next = nullptr;
          dispatch_task(L, head);
          head = nxt;
        }
        continue;
      }
      Conn* c = static_cast<Conn*>(evs[i].data.ptr);
      if (c->dead) continue;  // closed earlier in this same batch
      if (evs[i].events & (EPOLLERR | EPOLLHUP)) {
        if (c->state == C_H2 && c->h2_nstreams > 0) {
          conn_io(L, c);  // h2 streams in flight: surface the error per stream
        } else if (c->state == C_IDLE || !c->task) {
          Target* t = c->target;
          conn_free(L, c);
          pump_target(L, t);
        } else if (c->state == C_BODY && c->content_len < 0) {
          conn_io(L, c);  // close-delimited body: HUP may carry the end
        } else {
          conn_io(L, c);  // let recv/getsockopt surface the real errno
        }
      } else {
        conn_io(L, c);
      }
      if (L->ding_pending >= kDingBatch) ding_flush(L);
    }
    int64_t now = tb_now_ns();
    if (now - last_sweep > 1000000000LL) {
      sweep_timeouts(L);
      last_sweep = now;
    }
    // Flush the coalesced doorbell BEFORE blocking again: a deferred
    // ring that survived into epoll_wait would leave the consumer
    // sleeping on ready completions. Then reap this batch's closed
    // conns — the next epoll_wait can't reference them.
    ding_flush(L);
    reap_dead(L);
  }
  ding_flush(L);  // shutdown path: wake a blocked consumer
  reap_dead(L);
  return nullptr;
}

static uint32_t pow2_at_least(uint32_t v) {
  uint32_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

static int64_t reactor_create(int conns, int cap, int n_loops, int tls,
                              const char* cafile, int insecure, int h2_mode) {
  if (conns <= 0 || cap <= 0) return 0;
  if (n_loops <= 0) n_loops = 1;
  if (n_loops > conns) n_loops = conns;
  if (n_loops > 16) n_loops = 16;
  Reactor* r = static_cast<Reactor*>(calloc(1, sizeof(Reactor)));
  if (!r) return 0;
  r->kind = fp::kPoolKindReactor;
  r->cap = cap;
  r->n_loops = n_loops;
  r->tls = tls;
  r->insecure = insecure;
  r->h2_mode = h2_mode;
  snprintf(r->cafile, sizeof r->cafile, "%s", cafile ? cafile : "");
  if (tls) {
    r->ssl_ctx = tls::get_ctx(r->cafile[0] ? r->cafile : nullptr, insecure);
    if (!r->ssl_ctx) {
      free(r);
      return 0;
    }
  }
  r->done_efd = eventfd(0, EFD_NONBLOCK);
  r->loops = static_cast<Loop*>(calloc(n_loops, sizeof(Loop)));
  if (r->done_efd < 0 || !r->loops) {
    if (r->done_efd >= 0) close(r->done_efd);
    free(r->loops);
    if (r->ssl_ctx) tls::SSL_CTX_free_(r->ssl_ctx);
    free(r);
    return 0;
  }
  uint32_t ring_cap = pow2_at_least(static_cast<uint32_t>(cap) + 1);
  int ok = 1;
  for (int i = 0; i < n_loops; i++) {
    Loop* L = &r->loops[i];
    L->r = r;
    L->epfd = epoll_create1(0);
    L->submit_efd = eventfd(0, EFD_NONBLOCK);
    L->ring = static_cast<fp::Task**>(calloc(ring_cap, sizeof(fp::Task*)));
    L->ring_mask = ring_cap - 1;
    L->scratch = static_cast<uint8_t*>(malloc(kDiscardWin));
    L->max_conns = conns / n_loops + (i < conns % n_loops ? 1 : 0);
    if (L->max_conns < 1) L->max_conns = 1;
    pthread_mutex_init(&L->in_mu, nullptr);
    if (L->epfd < 0 || L->submit_efd < 0 || !L->ring || !L->scratch) {
      ok = 0;
      continue;
    }
    struct epoll_event e;
    e.events = EPOLLIN;
    e.data.ptr = L;  // loop pointer marks the submit doorbell
    if (epoll_ctl(L->epfd, EPOLL_CTL_ADD, L->submit_efd, &e) != 0) ok = 0;
  }
  if (ok) {
    for (int i = 0; i < n_loops; i++) {
      Loop* L = &r->loops[i];
      if (pthread_create(&L->thread, nullptr, loop_main, L) == 0)
        L->started = 1;
      else
        ok = 0;
    }
  }
  if (!ok) {
    __atomic_store_n(&r->shutdown, 1, __ATOMIC_RELEASE);
    for (int i = 0; i < n_loops; i++) {
      Loop* L = &r->loops[i];
      if (L->started) {
        uint64_t one = 1;
        ssize_t k = write(L->submit_efd, &one, sizeof one);
        (void)k;
        pthread_join(L->thread, nullptr);
      }
      if (L->epfd >= 0) close(L->epfd);
      if (L->submit_efd >= 0) close(L->submit_efd);
      free(L->ring);
      free(L->scratch);
      pthread_mutex_destroy(&L->in_mu);
    }
    close(r->done_efd);
    free(r->loops);
    if (r->ssl_ctx) tls::SSL_CTX_free_(r->ssl_ctx);
    free(r);
    return 0;
  }
  return reinterpret_cast<int64_t>(r);
}

static int reactor_submit(Reactor* r, fp::Task* t) {
  if (__atomic_load_n(&r->shutdown, __ATOMIC_ACQUIRE)) {
    free(t);
    return -EINVAL;
  }
  // Admission cap: inflight is bounded by `cap`, which also bounds ring
  // depth (the ring can therefore never overflow).
  int cur = __atomic_load_n(&r->inflight, __ATOMIC_RELAXED);
  for (;;) {
    if (cur >= r->cap) {
      free(t);
      return -EAGAIN;
    }
    if (__atomic_compare_exchange_n(&r->inflight, &cur, cur + 1, true,
                                    __ATOMIC_ACQ_REL, __ATOMIC_RELAXED))
      break;
  }
  uint64_t i = __atomic_fetch_add(&r->rr, 1, __ATOMIC_RELAXED);
  Loop* L = &r->loops[i % r->n_loops];
  pthread_mutex_lock(&L->in_mu);
  t->next = nullptr;
  int was_empty = L->in_head == nullptr;
  if (L->in_tail)
    L->in_tail->next = t;
  else
    L->in_head = t;
  L->in_tail = t;
  pthread_mutex_unlock(&L->in_mu);
  // Doorbell only on the inbox's empty→nonempty transition: the loop
  // drains the WHOLE inbox per ding, so a burst of resubmissions costs
  // one syscall, not one per task.
  if (was_empty) {
    uint64_t one = 1;
    ssize_t k = write(L->submit_efd, &one, sizeof one);
    (void)k;
  }
  return 0;
}

// Consumer wait-and-drain. Returns count (0 on timeout). SPSC contract:
// one draining thread at a time.
static int reactor_drain(Reactor* r, int timeout_ms, int max_n,
                         fp::Task** out) {
  int n = ring_drain(r, max_n, out);
  if (n > 0 || timeout_ms == 0) return n;
  int64_t deadline =
      timeout_ms < 0 ? INT64_MAX : tb_now_ns() + timeout_ms * 1000000LL;
  for (;;) {
    if (__atomic_load_n(&r->shutdown, __ATOMIC_ACQUIRE) &&
        __atomic_load_n(&r->inflight, __ATOMIC_RELAXED) == 0)
      return 0;
    int64_t left_ms = timeout_ms < 0
                          ? 1000
                          : (deadline - tb_now_ns()) / 1000000LL;
    if (left_ms <= 0) return 0;
    if (left_ms > 1000) left_ms = 1000;  // bounded: shutdown stays visible
    struct pollfd pfd;
    pfd.fd = r->done_efd;
    pfd.events = POLLIN;
    int prc = poll(&pfd, 1, static_cast<int>(left_ms));
    if (prc > 0) {
      uint64_t v;
      ssize_t k = read(r->done_efd, &v, sizeof v);
      (void)k;
    }
    n = ring_drain(r, max_n, out);
    if (n > 0) return n;
  }
}

static int reactor_destroy(Reactor* r) {
  __atomic_store_n(&r->shutdown, 1, __ATOMIC_RELEASE);
  for (int i = 0; i < r->n_loops; i++) {
    uint64_t one = 1;
    ssize_t k = write(r->loops[i].submit_efd, &one, sizeof one);
    (void)k;
  }
  // Join EVERY loop thread before freeing anything it might touch —
  // the destroy-vs-in-flight-wake ordering the thread-per-connection
  // teardown never pinned.
  for (int i = 0; i < r->n_loops; i++)
    if (r->loops[i].started) pthread_join(r->loops[i].thread, nullptr);
  for (int i = 0; i < r->n_loops; i++) {
    Loop* L = &r->loops[i];
    // Undrained submissions.
    fp::Task* t = L->in_head;
    while (t) {
      fp::Task* nxt = t->next;
      free(t);
      t = nxt;
    }
    // Targets: queued tasks + live connections (their in-flight tasks
    // are cancelled; buffers stay caller-owned, and after the joins
    // above nothing writes into them anymore).
    Target* tg = L->targets;
    while (tg) {
      Target* tn = tg->next;
      fp::Task* q = tg->q_head;
      while (q) {
        fp::Task* qn = q->next;
        free(q);
        q = qn;
      }
      Conn* c = tg->conns;
      while (c) {
        Conn* cn = c->next;
        if (c->ssl) tls::SSL_free_(c->ssl);
        close(c->fd);
        tb_stat_add(TB_STAT_CONN_CLOSES, 1);
        for (int si = 0; si < kRxH2Streams; si++)
          if (c->h2_streams[si].id) free(c->h2_streams[si].task);
        free(c->h2_out);
        free(c->h2_hb);
        free(c->task);
        free(c);
        c = cn;
      }
      if (tg->tls_session) tls::SSL_SESSION_free_(tg->tls_session);
      free(tg);
      tg = tn;
    }
    // Undrained completions in the ring.
    uint32_t tl = __atomic_load_n(&L->ring_tail, __ATOMIC_RELAXED);
    uint32_t h = __atomic_load_n(&L->ring_head, __ATOMIC_ACQUIRE);
    while (tl != h) {
      free(L->ring[tl & L->ring_mask]);
      tl++;
    }
    close(L->epfd);
    close(L->submit_efd);
    free(L->ring);
    free(L->scratch);
    pthread_mutex_destroy(&L->in_mu);
  }
  close(r->done_efd);
  free(r->loops);
  if (r->ssl_ctx) tls::SSL_CTX_free_(r->ssl_ctx);
  free(r);
  return 0;
}

}  // namespace rx

// Create a fetch pool: `threads` workers, submission/completion capacity
// `cap` tasks; `tls` makes every worker connection TLS (verified against
// `cafile` or the system store, task host as SNI; `insecure` skips
// verification for self-signed test endpoints). Returns an opaque handle
// (or 0 on failure — including TLS requested but OpenSSL unavailable).
int64_t tb_pool_create(int threads, int cap, int tls, const char* cafile,
                       int insecure) {
  if (threads <= 0 || cap <= 0) return 0;
  if (tls && !tb_tls_available()) return 0;
  if (cafile && strlen(cafile) >= sizeof(fp::Pool{}.cafile)) return 0;
  fp::Pool* p = static_cast<fp::Pool*>(calloc(1, sizeof(fp::Pool)));
  if (!p) return 0;
  p->kind = fp::kPoolKindThreads;
  p->cap = cap;
  p->tls = tls;
  p->insecure = insecure;
  snprintf(p->cafile, sizeof p->cafile, "%s", cafile ? cafile : "");
  p->subq = static_cast<fp::Task**>(calloc(cap, sizeof(fp::Task*)));
  p->doneq = static_cast<fp::Task**>(calloc(cap, sizeof(fp::Task*)));
  p->threads = static_cast<pthread_t*>(calloc(threads, sizeof(pthread_t)));
  if (!p->subq || !p->doneq || !p->threads) {
    free(p->subq);
    free(p->doneq);
    free(p->threads);
    free(p);
    return 0;
  }
  pthread_mutex_init(&p->mu, nullptr);
  pthread_cond_init(&p->sub_cv, nullptr);
  pthread_cond_init(&p->done_cv, nullptr);
  // Only successfully spawned threads count (and get joined): under
  // RLIMIT_NPROC pressure a partial pool still serves; zero workers is a
  // creation failure.
  int created = 0;
  for (int i = 0; i < threads; i++) {
    if (pthread_create(&p->threads[created], nullptr, fp::worker_main, p) == 0)
      created++;
  }
  p->n_threads = created;
  if (created == 0) {
    pthread_mutex_destroy(&p->mu);
    pthread_cond_destroy(&p->sub_cv);
    pthread_cond_destroy(&p->done_cv);
    free(p->subq);
    free(p->doneq);
    free(p->threads);
    free(p);
    return 0;
  }
  return reinterpret_cast<int64_t>(p);
}

// Mode-aware pool creation. ``mode`` low byte: 0 = legacy
// thread-per-connection pool (exactly tb_pool_create), 1 = reactor
// (epoll event loop + SPSC completion rings); bits 8-15 carry the
// reactor loop-thread count (0 → 1); bit 16 (0x10000) offers h2 via
// ALPN and falls back to http/1.1 per the server's selection (TLS
// only); bit 17 (0x20000) speaks h2 with prior knowledge on plaintext
// sockets (h2c test servers). TLS in reactor mode is the same
// nonblocking state machine (handshake off epoll readiness, session
// resumption on keep-alive reconnect) — it no longer falls back to the
// legacy pool. In reactor mode ``threads`` is the CONNECTION budget,
// not a thread count: the loop multiplexes all of them; in-flight GETs
// beyond it queue per target (and, on h2, fan out as concurrent
// streams) and reuse keep-alive sockets as they free — many GETs, few
// sockets, zero per-request threads.
int64_t tb_pool_create2(int threads, int cap, int tls, const char* cafile,
                        int insecure, int mode) {
  int flavor = mode & 0xff;
  if (flavor == 0) return tb_pool_create(threads, cap, tls, cafile, insecure);
  if (flavor != 1) return 0;
  int loops = (mode >> 8) & 0xff;
  int h2_mode = (mode & 0x20000) ? 2 : ((mode & 0x10000) ? 1 : 0);
  if (h2_mode == 1 && !tls) return 0;  // ALPN needs a TLS handshake
  if (h2_mode == 2 && tls) return 0;   // prior knowledge is plaintext h2c
  if (tls && !tb_tls_available()) return 0;
  if (cafile && strlen(cafile) >= sizeof(rx::Reactor{}.cafile)) return 0;
  return rx::reactor_create(threads, cap, loops, tls, cafile, insecure,
                            h2_mode);
}

// 1 when the handle is a reactor-mode pool (introspection for tests and
// the Python mode label).
int tb_pool_is_reactor(int64_t h) {
  if (h == 0) return 0;
  return *reinterpret_cast<int*>(h) == fp::kPoolKindReactor ? 1 : 0;
}


// Submit one GET. The caller owns `buf` until the task completes (comes
// back from tb_pool_next). Returns 0, or -EAGAIN when the ring is full
// (the caller drains completions and resubmits), or -EINVAL.
int tb_pool_submit(int64_t h, const char* host, int port, const char* path,
                   const char* headers, void* buf, int64_t buf_len,
                   uint64_t tag) {
  if (h == 0) return -EINVAL;
  fp::Pool* p = reinterpret_cast<fp::Pool*>(h);
  if (!host || strlen(host) >= sizeof(fp::Task{}.host)) return -EINVAL;
  if (!path || strlen(path) >= sizeof(fp::Task{}.path)) return -EINVAL;
  if (headers && strlen(headers) >= sizeof(fp::Task{}.headers)) return -EINVAL;
  fp::Task* t = static_cast<fp::Task*>(calloc(1, sizeof(fp::Task)));
  if (!t) return -ENOMEM;
  snprintf(t->host, sizeof t->host, "%s", host);
  t->port = port;
  snprintf(t->path, sizeof t->path, "%s", path);
  snprintf(t->headers, sizeof t->headers, "%s", headers ? headers : "");
  t->buf = static_cast<uint8_t*>(buf);
  t->buf_len = buf_len;
  t->tag = tag;
  if (p->kind == fp::kPoolKindReactor)
    return rx::reactor_submit(reinterpret_cast<rx::Reactor*>(h), t);
  pthread_mutex_lock(&p->mu);
  if (p->inflight >= p->cap || p->shutdown) {
    int sd = p->shutdown;  // read under the lock
    pthread_mutex_unlock(&p->mu);
    free(t);
    return sd ? -EINVAL : -EAGAIN;
  }
  p->subq[(p->sub_head + p->sub_len) % p->cap] = t;
  p->sub_len++;
  p->inflight++;
  pthread_cond_signal(&p->sub_cv);
  pthread_mutex_unlock(&p->mu);
  return 0;
}

// Reactor drain → caller arrays: copy results, free tasks, settle the
// admission count, and keep the pool_* wake counters comparable across
// both executor flavors (completions/wakes stays THE batching ratio).
static int rx_drain_out(rx::Reactor* r, int timeout_ms, int max_n,
                        uint64_t* tags, int64_t* results, int* statuses,
                        int64_t* fbs, int64_t* totals, int64_t* starts) {
  fp::Task* batch[256];
  if (max_n > 256) max_n = 256;
  int n = rx::reactor_drain(r, timeout_ms, max_n, batch);
  for (int i = 0; i < n; i++) {
    fp::Task* t = batch[i];
    if (tags) tags[i] = t->tag;
    if (results) results[i] = t->result;
    if (statuses) statuses[i] = t->status;
    if (fbs) fbs[i] = t->first_byte_ns;
    if (totals) totals[i] = t->total_ns;
    if (starts) starts[i] = t->start_ns;
    free(t);
    __atomic_fetch_sub(&r->inflight, 1, __ATOMIC_ACQ_REL);
  }
  if (n > 0) {
    tb_stat_add(TB_STAT_POOL_WAKES, 1);
    tb_stat_add(TB_STAT_POOL_COMPLETIONS, n);
    if (n > 1) tb_stat_add(TB_STAT_POOL_BATCHED_WAKES, 1);
  }
  return n;
}

// Wait for one completion (timeout_ms < 0 = forever, 0 = poll). Fills the
// out params; returns 1 on a completion, 0 on timeout, -EINVAL on a bad
// handle. The completed task's buffer is back in the caller's hands.
int tb_pool_next(int64_t h, int timeout_ms, uint64_t* tag_out,
                 int64_t* result_out, int* status_out,
                 int64_t* first_byte_ns_out, int64_t* total_ns_out,
                 int64_t* start_ns_out) {
  if (h == 0) return -EINVAL;
  fp::Pool* p = reinterpret_cast<fp::Pool*>(h);
  if (p->kind == fp::kPoolKindReactor)
    return rx_drain_out(reinterpret_cast<rx::Reactor*>(h), timeout_ms, 1,
                        tag_out, result_out, status_out, first_byte_ns_out,
                        total_ns_out, start_ns_out);
  pthread_mutex_lock(&p->mu);
  if (p->done_len == 0) {
    if (timeout_ms == 0) {
      pthread_mutex_unlock(&p->mu);
      return 0;
    }
    if (timeout_ms < 0) {
      while (p->done_len == 0 && !(p->shutdown && p->inflight == 0))
        pthread_cond_wait(&p->done_cv, &p->mu);
    } else {
      struct timespec ts;
      clock_gettime(CLOCK_REALTIME, &ts);
      ts.tv_sec += timeout_ms / 1000;
      ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
      if (ts.tv_nsec >= 1000000000L) {
        ts.tv_sec++;
        ts.tv_nsec -= 1000000000L;
      }
      while (p->done_len == 0 && !(p->shutdown && p->inflight == 0)) {
        if (pthread_cond_timedwait(&p->done_cv, &p->mu, &ts) != 0) break;
      }
    }
    if (p->done_len == 0) {
      pthread_mutex_unlock(&p->mu);
      return 0;
    }
  }
  fp::Task* t = p->doneq[p->done_head];
  p->done_head = (p->done_head + 1) % p->cap;
  p->done_len--;
  p->inflight--;
  pthread_mutex_unlock(&p->mu);
  if (tag_out) *tag_out = t->tag;
  if (result_out) *result_out = t->result;
  if (status_out) *status_out = t->status;
  if (first_byte_ns_out) *first_byte_ns_out = t->first_byte_ns;
  if (total_ns_out) *total_ns_out = t->total_ns;
  if (start_ns_out) *start_ns_out = t->start_ns;
  free(t);
  tb_stat_add(TB_STAT_POOL_WAKES, 1);
  tb_stat_add(TB_STAT_POOL_COMPLETIONS, 1);
  return 1;
}

// Batched completion handoff: wait like tb_pool_next, then drain up to
// `max_n` ready completions in the SAME lock crossing — under fan-out,
// completions pile up while the consumer processes the previous one, so
// one wake amortizes the mutex/condvar cost across the whole backlog
// (the per-completion handoff tax BENCH_r05 measured). Fills the
// parallel out arrays; returns the count drained (0 on timeout),
// -EINVAL on a bad handle or max_n. max_n is clamped to 256.
int tb_pool_next_batch(int64_t h, int timeout_ms, int max_n,
                       uint64_t* tags_out, int64_t* results_out,
                       int* statuses_out, int64_t* first_byte_ns_out,
                       int64_t* total_ns_out, int64_t* start_ns_out) {
  if (h == 0 || max_n <= 0) return -EINVAL;
  fp::Pool* p = reinterpret_cast<fp::Pool*>(h);
  if (p->kind == fp::kPoolKindReactor)
    return rx_drain_out(reinterpret_cast<rx::Reactor*>(h), timeout_ms, max_n,
                        tags_out, results_out, statuses_out,
                        first_byte_ns_out, total_ns_out, start_ns_out);
  fp::Task* batch[256];
  if (max_n > 256) max_n = 256;
  pthread_mutex_lock(&p->mu);
  if (p->done_len == 0) {
    if (timeout_ms == 0) {
      pthread_mutex_unlock(&p->mu);
      return 0;
    }
    if (timeout_ms < 0) {
      while (p->done_len == 0 && !(p->shutdown && p->inflight == 0))
        pthread_cond_wait(&p->done_cv, &p->mu);
    } else {
      struct timespec ts;
      clock_gettime(CLOCK_REALTIME, &ts);
      ts.tv_sec += timeout_ms / 1000;
      ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
      if (ts.tv_nsec >= 1000000000L) {
        ts.tv_sec++;
        ts.tv_nsec -= 1000000000L;
      }
      while (p->done_len == 0 && !(p->shutdown && p->inflight == 0)) {
        if (pthread_cond_timedwait(&p->done_cv, &p->mu, &ts) != 0) break;
      }
    }
    if (p->done_len == 0) {
      pthread_mutex_unlock(&p->mu);
      return 0;
    }
  }
  int n = 0;
  while (p->done_len > 0 && n < max_n) {
    fp::Task* t = p->doneq[p->done_head];
    p->done_head = (p->done_head + 1) % p->cap;
    p->done_len--;
    p->inflight--;
    batch[n++] = t;
  }
  pthread_mutex_unlock(&p->mu);
  for (int i = 0; i < n; i++) {
    fp::Task* t = batch[i];
    if (tags_out) tags_out[i] = t->tag;
    if (results_out) results_out[i] = t->result;
    if (statuses_out) statuses_out[i] = t->status;
    if (first_byte_ns_out) first_byte_ns_out[i] = t->first_byte_ns;
    if (total_ns_out) total_ns_out[i] = t->total_ns;
    if (start_ns_out) start_ns_out[i] = t->start_ns;
    free(t);
  }
  tb_stat_add(TB_STAT_POOL_WAKES, 1);
  tb_stat_add(TB_STAT_POOL_COMPLETIONS, n);
  if (n > 1) tb_stat_add(TB_STAT_POOL_BATCHED_WAKES, 1);
  return n;
}

// The ring-drain entry point (the symbol whose ABSENCE marks a stale
// .so: Python degrades to tb_pool_next_batch, then to tb_pool_next).
// On a reactor pool this IS the lock-free SPSC drain; on a legacy pool
// it delegates to the mutex-guarded batch drain, so either symbol works
// on either handle.
int tb_pool_ring_next_batch(int64_t h, int timeout_ms, int max_n,
                            uint64_t* tags_out, int64_t* results_out,
                            int* statuses_out, int64_t* first_byte_ns_out,
                            int64_t* total_ns_out, int64_t* start_ns_out) {
  return tb_pool_next_batch(h, timeout_ms, max_n, tags_out, results_out,
                            statuses_out, first_byte_ns_out, total_ns_out,
                            start_ns_out);
}

// Shut down: workers finish queued tasks, then exit; joins all threads.
// Undrained completions are freed (their buffers stay caller-owned).
// Reactor pools CANCEL queued/in-flight tasks instead: the doorbell and
// rings are drained and every loop thread joined BEFORE anything is
// freed, so after destroy returns nothing writes into caller buffers.
int tb_pool_destroy(int64_t h) {
  if (h == 0) return -EINVAL;
  fp::Pool* p = reinterpret_cast<fp::Pool*>(h);
  if (p->kind == fp::kPoolKindReactor)
    return rx::reactor_destroy(reinterpret_cast<rx::Reactor*>(h));
  pthread_mutex_lock(&p->mu);
  p->shutdown = 1;
  pthread_cond_broadcast(&p->sub_cv);
  pthread_cond_broadcast(&p->done_cv);
  pthread_mutex_unlock(&p->mu);
  for (int i = 0; i < p->n_threads; i++) pthread_join(p->threads[i], nullptr);
  for (int i = 0; i < p->done_len; i++)
    free(p->doneq[(p->done_head + i) % p->cap]);
  pthread_mutex_destroy(&p->mu);
  pthread_cond_destroy(&p->sub_cv);
  pthread_cond_destroy(&p->done_cv);
  free(p->subq);
  free(p->doneq);
  free(p->threads);
  free(p);
  return 0;
}

// Test hook: run the structural HPACK parse over one header block and
// return the extracted grpc-status (-1 unknown) or TB_EPROTO — lets the
// huffman-coded trailer path be exercised directly (the hermetic grpc
// server happens to send grpc-status unencoded).
int tb_hpack_scan_status(const void* block, int64_t n) {
  int st = -1;
  int rc = h2::parse_header_block(static_cast<const uint8_t*>(block),
                                  static_cast<size_t>(n), &st);
  return rc != 0 ? rc : st;
}

// ------------------------------------------------- h2 stream machinery --
// One receive loop serves BOTH native h2 flavors — gRPC ReadObject
// streams (length-prefixed messages reassembled per stream, content
// extracted) and plain h2 GETs (DATA bytes land in the caller's buffer
// verbatim) — with CONCURRENT streams per connection: submit N, then
// poll completions. grpc-go multiplexes streams per connection by
// default (the reference's transport, go.mod:20); sequential-only was
// the round-2 limitation.

// Bring up the h2 session once per connection: client preface +
// SETTINGS(HEADER_TABLE_SIZE=0, INITIAL_WINDOW_SIZE=2^31-1,
// MAX_FRAME_SIZE=2^24-1) + connection WINDOW_UPDATE, and the stream
// table.
static int h2_ensure_session(tb_conn* c) {
  if (c->h2_started) return 0;
  int rc;
  if ((rc = h2::send_all(c, h2::kPreface, sizeof(h2::kPreface) - 1)) != 0)
    return rc;
  uint8_t st[18];
  uint8_t* p = st;
  p[0] = 0; p[1] = 1; h2::put32(p + 2, 0); p += 6;              // table 0
  p[0] = 0; p[1] = 4; h2::put32(p + 2, 0x7fffffffu); p += 6;    // window
  p[0] = 0; p[1] = 5; h2::put32(p + 2, 0x00ffffffu); p += 6;    // frame
  if ((rc = h2::send_frame(c, 4 /*SETTINGS*/, 0, 0, st, 18)) != 0) return rc;
  uint8_t wu[4];
  h2::put32(wu, 0x40000000u - 65535);
  if ((rc = h2::send_frame(c, 8 /*WINDOW_UPDATE*/, 0, 0, wu, 4)) != 0)
    return rc;
  if (!c->streams) {
    c->streams = static_cast<h2_stream*>(
        calloc(kH2MaxStreams, sizeof(h2_stream)));
    if (!c->streams) return -ENOMEM;
  }
  c->h2_started = 1;
  c->next_stream = 1;
  return 0;
}

static h2_stream* h2_find_stream(tb_conn* c, uint32_t id) {
  for (int i = 0; i < kH2MaxStreams; i++)
    if (c->streams[i].id == id) return &c->streams[i];
  return nullptr;
}

// Append caller metadata ("k: v\r\n" lines, e.g. authorization) to an
// HPACK block; h2 requires lowercase field names, enforced here rather
// than trusted. Returns new block length or 0 on malformed input.
static size_t h2_append_metadata(uint8_t* hb, size_t hn,
                                 const char* extra_headers) {
  for (const char* ph = extra_headers ? extra_headers : ""; *ph;) {
    const char* eol = strstr(ph, "\r\n");
    size_t line_len = eol ? static_cast<size_t>(eol - ph) : strlen(ph);
    const char* colon = static_cast<const char*>(memchr(ph, ':', line_len));
    if (!colon || colon == ph) return 0;
    char nbuf[128];
    size_t nl = static_cast<size_t>(colon - ph);
    if (nl >= sizeof nbuf) return 0;
    for (size_t i = 0; i < nl; i++)
      nbuf[i] = static_cast<char>(tolower(static_cast<unsigned char>(ph[i])));
    nbuf[nl] = 0;
    const char* v = colon + 1;
    while (*v == ' ' && v < ph + line_len) v++;
    char vbuf[4096];
    size_t vl = static_cast<size_t>(ph + line_len - v);
    if (vl >= sizeof vbuf) return 0;
    memcpy(vbuf, v, vl);
    vbuf[vl] = 0;
    hn += h2::hp_header(hb + hn, nbuf, vbuf);
    ph = eol ? eol + 2 : ph + line_len;
  }
  return hn;
}

// Open a stream slot with common init. ``*err_out`` distinguishes the two
// failure modes: -EAGAIN (table full — the caller polls a completion and
// retries) vs -ENOMEM (scratch allocation failed — retrying cannot help;
// reporting it as EAGAIN would spin the caller forever).
static h2_stream* h2_open_stream(tb_conn* c, uint64_t tag, void* buf,
                                 int64_t buf_len, int raw_body,
                                 int* err_out) {
  h2_stream* s = h2_find_stream(c, 0);
  if (!s) {
    *err_out = -EAGAIN;
    return nullptr;
  }
  memset(s, 0, sizeof *s);
  s->tag = tag;
  s->raw_body = raw_body;
  s->out = static_cast<uint8_t*>(buf);
  s->out_cap = buf_len;
  s->grpc_status = -1;
  s->http_status = -1;
  s->content_len = -1;
  s->t_start = tb_now_ns();
  if (!raw_body) {
    s->scratch = c->scratch_pool_n
                     ? c->scratch_pool[--c->scratch_pool_n]
                     : static_cast<uint8_t*>(malloc(kGrpcScratchCap));
    if (!s->scratch) {
      *err_out = -ENOMEM;
      return nullptr;
    }
  }
  s->id = c->next_stream;
  c->next_stream += 2;
  tb_stat_add(TB_STAT_H2_STREAMS_OPENED, 1);
  return s;
}

static void h2_close_stream(tb_conn* c, h2_stream* s) {
  if (s->scratch) {
    if (c->scratch_pool_n <
        static_cast<int>(sizeof c->scratch_pool / sizeof c->scratch_pool[0]))
      c->scratch_pool[c->scratch_pool_n++] = s->scratch;
    else
      free(s->scratch);
    s->scratch = nullptr;
  }
  s->id = 0;
}

// Submit one gRPC ReadObject as a new concurrent stream. Returns 0, or
// -EAGAIN (stream table full — poll a completion first), or a fatal
// -errno/TB_* (the connection is then unusable).
int64_t tb_grpc_submit(int64_t h, const char* authority,
                       const char* bucket_path, const char* object_name,
                       const char* extra_headers, int64_t read_offset,
                       int64_t read_limit, void* buf, int64_t buf_len,
                       uint64_t tag) {
  if (h <= 0) return -EINVAL;
  // Headers land in hb[8192] (fixed fields ~120 B + authority + extra
  // metadata such as an OAuth bearer token) and the request proto in
  // req[2048] (framing ~30 B + bucket + object): bound the
  // caller-supplied strings so neither buffer can overflow. GCS caps
  // object names at 1024 bytes — these limits sit above real use.
  if (!authority || strlen(authority) > 512) return -EINVAL;
  if (!bucket_path || !object_name ||
      strlen(bucket_path) + strlen(object_name) > 1700)
    return -EINVAL;
  if (extra_headers && strlen(extra_headers) > 4096) return -EINVAL;
  tb_conn* c = reinterpret_cast<tb_conn*>(h);
  int rc;
  if ((rc = h2_ensure_session(c)) != 0) return rc;
  int oerr = 0;
  h2_stream* s = h2_open_stream(c, tag, buf, buf_len, 0, &oerr);
  if (!s) return oerr;

  // HEADERS: the gRPC request headers, literal never-indexed.
  uint8_t hb[8192];
  size_t hn = 0;
  hn += h2::hp_header(hb + hn, ":method", "POST");
  hn += h2::hp_header(hb + hn, ":scheme", c->ssl ? "https" : "http");
  hn += h2::hp_header(hb + hn, ":path",
                      "/google.storage.v2.Storage/ReadObject");
  hn += h2::hp_header(hb + hn, ":authority", authority);
  hn += h2::hp_header(hb + hn, "content-type", "application/grpc");
  hn += h2::hp_header(hb + hn, "te", "trailers");
  size_t hn2 = h2_append_metadata(hb, hn, extra_headers);
  if (extra_headers && extra_headers[0] && hn2 == 0) {
    h2_close_stream(c, s);
    return -EINVAL;
  }
  hn = hn2 ? hn2 : hn;
  if ((rc = h2::send_frame(c, 1 /*HEADERS*/, 0x4 /*END_HEADERS*/, s->id, hb,
                           static_cast<uint32_t>(hn))) != 0) {
    h2_close_stream(c, s);
    return rc;
  }

  // DATA: 5-byte gRPC prefix + ReadObjectRequest proto, END_STREAM.
  uint8_t req[2048];
  size_t rn = 5;
  rn += h2::pb_str(req + rn, 1, bucket_path);
  rn += h2::pb_str(req + rn, 2, object_name);
  if (read_offset > 0) {
    req[rn++] = 4 << 3;  // field 4 varint
    rn += h2::pb_varint(req + rn, static_cast<uint64_t>(read_offset));
  }
  if (read_limit > 0) {
    req[rn++] = 5 << 3;  // field 5 varint
    rn += h2::pb_varint(req + rn, static_cast<uint64_t>(read_limit));
  }
  req[0] = 0;  // uncompressed — and no grpc-accept-encoding offered, so a
               // conformant server may not send compressed messages back
  h2::put32(req + 1, static_cast<uint32_t>(rn - 5));
  if ((rc = h2::send_frame(c, 0 /*DATA*/, 0x1 /*END_STREAM*/, s->id, req,
                           static_cast<uint32_t>(rn))) != 0) {
    h2_close_stream(c, s);
    return rc;
  }
  return 0;
}

// Submit one plain h2 GET (the HTTP/2 branch of the reference's client,
// main.go:76-80) as a new concurrent stream: DATA payload bytes land in
// ``buf`` verbatim; :status surfaces in the completion's http_status.
int64_t tb_h2_submit_get(int64_t h, const char* authority, const char* path,
                         const char* extra_headers, void* buf,
                         int64_t buf_len, uint64_t tag) {
  if (h <= 0) return -EINVAL;
  if (!authority || strlen(authority) > 512) return -EINVAL;
  if (!path || strlen(path) > 2048) return -EINVAL;
  if (extra_headers && strlen(extra_headers) > 4096) return -EINVAL;
  tb_conn* c = reinterpret_cast<tb_conn*>(h);
  int rc;
  if ((rc = h2_ensure_session(c)) != 0) return rc;
  int oerr = 0;
  h2_stream* s = h2_open_stream(c, tag, buf, buf_len, 1, &oerr);
  if (!s) return oerr;
  uint8_t hb[8192];
  size_t hn = 0;
  hn += h2::hp_header(hb + hn, ":method", "GET");
  hn += h2::hp_header(hb + hn, ":scheme", c->ssl ? "https" : "http");
  hn += h2::hp_header(hb + hn, ":path", path);
  hn += h2::hp_header(hb + hn, ":authority", authority);
  size_t hn2 = h2_append_metadata(hb, hn, extra_headers);
  if (extra_headers && extra_headers[0] && hn2 == 0) {
    h2_close_stream(c, s);
    return -EINVAL;
  }
  hn = hn2 ? hn2 : hn;
  // GET has no request body: END_STREAM rides the HEADERS frame.
  if ((rc = h2::send_frame(c, 1 /*HEADERS*/, 0x4 | 0x1, s->id, hb,
                           static_cast<uint32_t>(hn))) != 0) {
    h2_close_stream(c, s);
    return rc;
  }
  return 0;
}

// Receive ``payload`` DATA bytes for stream ``s`` DIRECTLY into its
// destination — raw flavor: the caller's buffer; gRPC flavor: the
// reassembly scratch (then content-extracted into the caller's buffer,
// the one copy the protobuf framing forces) — no intermediate chunk
// buffer on the hot path. Unknown/errored streams drain through a scrap
// buffer. Returns 0, or a connection-fatal -errno/TB_ESHORT; per-stream
// failures land in s->err (remaining payload is drained, the connection
// survives).
static int h2_recv_data(tb_conn* c, h2_stream* s, uint32_t payload) {
  int rc;
  uint32_t done = 0;
  while (done < payload) {
    if (!s || s->err) {  // discard: junk stream or already-failed stream
      uint8_t sink[65536];
      uint32_t w = payload - done;
      if (w > sizeof sink) w = sizeof sink;
      if ((rc = h2::recv_all(c, sink, w)) != 0) return rc;
      done += w;
      continue;
    }
    if (s->first_byte_ns == 0) s->first_byte_ns = tb_now_ns();
    if (s->raw_body) {
      uint32_t w = payload - done;
      if (static_cast<int64_t>(w) > s->out_cap - s->out_len) {
        s->err = TB_ETOOBIG;
        continue;
      }
      if ((rc = h2::recv_all(c, s->out + s->out_len, w)) != 0) return rc;
      s->out_len += w;
      done += w;
      continue;
    }
    if (s->msg_len == 0) {
      // Reading the 5-byte gRPC message prefix.
      uint8_t b;
      if ((rc = h2::recv_all(c, &b, 1)) != 0) return rc;
      done += 1;
      s->prefix[s->prefix_got++] = b;
      if (s->prefix_got == 5) {
        if (s->prefix[0] != 0) {
          // Compressed message: we never offered grpc-accept-encoding,
          // so this violates the negotiation (gRPC protocol spec §
          // "Message-Encoding") — reject loudly rather than mis-deliver.
          s->err = TB_EPROTO;
          continue;
        }
        s->msg_len = (static_cast<size_t>(s->prefix[1]) << 24) |
                     (s->prefix[2] << 16) | (s->prefix[3] << 8) |
                     s->prefix[4];
        s->msg_got = 0;
        s->prefix_got = 0;
        if (s->msg_len > kGrpcScratchCap) {
          s->err = TB_ETOOBIG;
          continue;
        }
        // msg_len == 0 (empty message): next iteration reads a prefix.
      }
      continue;
    }
    uint32_t want = payload - done;
    size_t need = s->msg_len - s->msg_got;
    if (want > need) want = static_cast<uint32_t>(need);
    if ((rc = h2::recv_all(c, s->scratch + s->msg_got, want)) != 0) return rc;
    s->msg_got += want;
    done += want;
    if (s->msg_got == s->msg_len) {
      int64_t k = h2::pb_extract_content(s->scratch, s->msg_len,
                                         s->out + s->out_len,
                                         s->out_cap - s->out_len);
      if (k < 0) {
        s->err = k;
        continue;
      }
      s->out_len += k;
      s->msg_len = 0;
      s->msg_got = 0;
    }
  }
  return 0;
}

// Mark stream terminal state at END_STREAM and compute its result.
static void h2_stream_finish(h2_stream* s) {
  s->done = 1;
  if (s->err) return;
  if (!s->raw_body) {
    if (s->msg_len != 0 || s->prefix_got != 0) s->err = TB_ESHORT;
    else if (!s->got_headers) s->err = TB_EPROTO;
    else if (s->grpc_status > 0) s->err = TB_EGRPC;
  } else if (!s->got_headers) {
    s->err = TB_EPROTO;
  } else if ((s->http_status == 200 || s->http_status == 206) &&
             s->content_len >= 0 && s->out_len < s->content_len) {
    // Cleanly END_STREAMed short of the announced content-length: a
    // truncated success is still a failure (proxy died mid-stream,
    // backend exhausted). Same rule as the h1 path's TB_ESHORT and
    // gcs_grpc read_ranges' short-stream rejection; scoped to success
    // statuses so error bodies keep their existing reporting path.
    s->err = TB_ESHORT;
  }
}

// Run the receive loop until SOME stream completes (or a connection-fatal
// error). Returns 1 with the completion out-params filled; 0 when no
// streams are active; negative on a fatal error — every in-flight stream
// on this connection is then dead and the caller must tb_conn_close it.
int64_t tb_grpc_poll(int64_t h, uint64_t* tag_out, int64_t* result_out,
                     int* grpc_status_out, int* http_status_out,
                     int64_t* first_byte_ns_out, int64_t* total_ns_out) {
  if (h <= 0) return -EINVAL;
  tb_conn* c = reinterpret_cast<tb_conn*>(h);
  if (!c->h2_started || !c->streams) return 0;
  int rc;
  uint64_t conn_unacked = 0;
  h2_stream* ready = nullptr;
  for (;;) {
    // A stream completed during an earlier pass (frames interleave)?
    for (int i = 0; i < kH2MaxStreams && !ready; i++)
      if (c->streams[i].id && c->streams[i].done) ready = &c->streams[i];
    if (ready) break;
    int any_active = 0;
    for (int i = 0; i < kH2MaxStreams; i++)
      if (c->streams[i].id) any_active = 1;
    if (!any_active) return 0;

    uint8_t fh[9];
    if ((rc = h2::recv_all(c, fh, 9)) != 0) return rc;
    uint32_t flen = (fh[0] << 16) | (fh[1] << 8) | fh[2];
    uint8_t ftype = fh[3];
    uint8_t fflags = fh[4];
    uint32_t fstream = ((fh[5] & 0x7f) << 24) | (fh[6] << 16) |
                       (fh[7] << 8) | fh[8];
    if (flen > (16u << 20)) return TB_EPROTO;
    tb_stat_add(TB_STAT_H2_FRAMES_RX, 1);
    if (ftype == 0) tb_stat_add(TB_STAT_H2_DATA_BYTES_RX, flen);
    switch (ftype) {
      case 0: {  // DATA
        h2_stream* s = h2_find_stream(c, fstream);
        if (!s && fstream == 0) return TB_EPROTO;
        uint32_t left = flen;
        uint32_t pad = 0;
        if (fflags & 0x8) {  // PADDED
          // A PADDED frame carries at least the pad-length byte; flen ==
          // 0 would otherwise consume a byte of the NEXT frame.
          if (flen < 1) return TB_EPROTO;
          uint8_t pl;
          if ((rc = h2::recv_all(c, &pl, 1)) != 0) return rc;
          pad = pl;
          left -= 1;
          if (pad + 1 > flen) return TB_EPROTO;
        }
        uint32_t payload = left - pad;
        if ((rc = h2_recv_data(c, s, payload)) != 0) return rc;
        while (pad) {
          uint8_t sink[256];
          uint32_t w = pad > sizeof sink ? sizeof sink : pad;
          if ((rc = h2::recv_all(c, sink, w)) != 0) return rc;
          pad -= w;
        }
        // Flow control: return consumed DATA as connection credit plus
        // PER-STREAM credit — each stream's own consumption tops up its
        // own window (batched at 1 MB) so concurrent streams never starve
        // each other.
        conn_unacked += flen;
        if (conn_unacked >= (1u << 20)) {
          uint8_t wu[4];
          h2::put32(wu, static_cast<uint32_t>(conn_unacked));
          h2::send_frame(c, 8, 0, 0, wu, 4);
          tb_stat_add(TB_STAT_H2_WINDOW_UPDATES_TX, 1);
          conn_unacked = 0;
        }
        if (s) {
          s->unacked += flen;
          if (s->unacked >= (1u << 20) && !s->done && !(fflags & 0x1)) {
            uint8_t wu[4];
            h2::put32(wu, static_cast<uint32_t>(s->unacked));
            h2::send_frame(c, 8, 0, fstream, wu, 4);
            tb_stat_add(TB_STAT_H2_WINDOW_UPDATES_TX, 1);
            s->unacked = 0;
          }
          if (fflags & 0x1) {
            h2_stream_finish(s);  // END_STREAM
          } else if (s->err && !s->done) {
            // Per-stream failure mid-body (buffer overflow, compressed
            // message, bad proto): CANCEL the stream so the server stops
            // sending, instead of silently draining — and crediting —
            // the entire remaining body. Late frames for this id are
            // discarded by the unknown-stream path once the slot frees.
            uint8_t code[4];
            h2::put32(code, 8 /*CANCEL*/);
            h2::send_frame(c, 3 /*RST_STREAM*/, 0, fstream, code, 4);
            s->done = 1;
          }
        }
        break;
      }
      case 1: {  // HEADERS (response headers or trailers)
        h2_stream* s = h2_find_stream(c, fstream);
        uint8_t* hbuf = static_cast<uint8_t*>(malloc(flen ? flen : 1));
        if (!hbuf) return -ENOMEM;
        if ((rc = h2::recv_all(c, hbuf, flen)) != 0) {
          free(hbuf);
          return rc;
        }
        size_t off = 0;
        uint32_t blen = flen;
        if (fflags & 0x8) {  // PADDED
          // flen == 0 has no pad-length byte to read — hbuf[0] would be
          // uninitialized memory.
          if (blen < 1) {
            free(hbuf);
            return TB_EPROTO;
          }
          uint8_t pad = hbuf[0];
          off = 1;
          if (pad + 1u > blen) {
            free(hbuf);
            return TB_EPROTO;
          }
          blen -= 1 + pad;
        }
        if (fflags & 0x20) {  // PRIORITY
          if (blen < 5) {
            free(hbuf);
            return TB_EPROTO;
          }
          off += 5;
          blen -= 5;
        }
        // Header blocks larger than one frame arrive as HEADERS +
        // CONTINUATION frames (RFC 9113 §6.10): until END_HEADERS, the
        // very next frames MUST be CONTINUATIONs on the same stream —
        // append their fragments. Bounded: a block past 64 KB is not a
        // storage-endpoint response.
        static const size_t kHdrBlockCap = 64 * 1024;
        static const int kMaxContinuations = 64;  // byte cap alone doesn't
        // bound the loop: zero-length CONTINUATIONs never advance bn.
        uint8_t* block = hbuf + off;  // view into hbuf while single-frame
        uint8_t* owned = nullptr;     // reassembly buffer once continuing
        size_t bn = blen;
        uint8_t hflags = fflags;
        int fragments = 0;
        while (!(hflags & 0x4)) {  // no END_HEADERS yet
          if (++fragments > kMaxContinuations) {
            free(hbuf);
            free(owned);
            return TB_EPROTO;
          }
          uint8_t ch[9];
          if ((rc = h2::recv_all(c, ch, 9)) != 0) {
            free(hbuf);
            free(owned);
            return rc;
          }
          uint32_t clen2 = (ch[0] << 16) | (ch[1] << 8) | ch[2];
          uint32_t cstream = ((ch[5] & 0x7f) << 24) | (ch[6] << 16) |
                             (ch[7] << 8) | ch[8];
          if (ch[3] != 9 /*CONTINUATION*/ || cstream != fstream ||
              bn + clen2 > kHdrBlockCap) {
            free(hbuf);
            free(owned);
            return TB_EPROTO;
          }
          if (!owned) {
            owned = static_cast<uint8_t*>(malloc(kHdrBlockCap));
            if (!owned) {
              free(hbuf);
              return -ENOMEM;
            }
            memcpy(owned, block, bn);
            block = owned;
          }
          if (clen2 && (rc = h2::recv_all(c, owned + bn, clen2)) != 0) {
            free(hbuf);
            free(owned);
            return rc;
          }
          bn += clen2;
          hflags = ch[4];  // only END_HEADERS (0x4) is defined here
        }
        int gs = -1, hs = -1;
        int64_t cl = -1;
        rc = h2::parse_header_block(block, bn, &gs, &hs, &cl);
        free(hbuf);
        free(owned);
        if (rc != 0) return rc;
        if (s) {
          if (s->first_byte_ns == 0) s->first_byte_ns = tb_now_ns();
          if (gs >= 0) s->grpc_status = gs;
          // Only the FINAL response HEADERS' announcement counts: an
          // interim 1xx block (RFC 9113 §8.1) is informational — marking
          // it as "the response" would discard the real block's
          // content-length and silently disable the truncation check —
          // and trailers (got_headers already set) must not
          // retroactively change it. The interim guard covers :status
          // too: a late 1xx block must not overwrite the response status
          // (which would flip the 200/206 gate of the truncation check).
          bool interim = hs >= 100 && hs < 200;
          if (!interim) {
            if (hs >= 0) s->http_status = hs;
            if (cl >= 0 && !s->got_headers) s->content_len = cl;
            s->got_headers = 1;
          }
          if (fflags & 0x1) {
            if (interim) {
              // END_STREAM on an interim response is a stream protocol
              // violation (RFC 9113 §8.1: interim responses cannot end a
              // stream). Finishing normally here would run
              // h2_stream_finish with the truncation check silently
              // disabled (no final headers ⇒ no content-length) — fail
              // the STREAM loudly instead; the connection survives.
              if (!s->err) s->err = TB_EPROTO;
              s->done = 1;
            } else {
              h2_stream_finish(s);
            }
          }
        }
        break;
      }
      case 3: {  // RST_STREAM: fatal for THAT stream, not the connection
        uint8_t code[4];
        if (flen != 4) return TB_EPROTO;
        if ((rc = h2::recv_all(c, code, 4)) != 0) return rc;
        tb_stat_add(TB_STAT_H2_RST_RX, 1);
        h2_stream* s = h2_find_stream(c, fstream);
        if (s) {
          s->err = TB_ESHORT;
          s->done = 1;
        }
        break;
      }
      case 4: {  // SETTINGS
        if (!(fflags & 0x1)) {  // not an ACK: read, then ACK
          uint8_t sink[256];
          uint32_t left = flen;
          while (left) {
            uint32_t w = left > sizeof sink ? sizeof sink : left;
            if ((rc = h2::recv_all(c, sink, w)) != 0) return rc;
            left -= w;
          }
          h2::send_frame(c, 4, 0x1, 0, nullptr, 0);
        }
        break;
      }
      case 6: {  // PING
        uint8_t pp[8];
        if (flen != 8) return TB_EPROTO;
        if ((rc = h2::recv_all(c, pp, 8)) != 0) return rc;
        if (!(fflags & 0x1)) h2::send_frame(c, 6, 0x1, 0, pp, 8);
        break;
      }
      case 7: {  // GOAWAY: connection-fatal for our purposes
        tb_stat_add(TB_STAT_H2_GOAWAY_RX, 1);
        return TB_ESHORT;
      }
      default: {  // WINDOW_UPDATE, PRIORITY, PUSH_PROMISE(never), unknown
        uint8_t sink[256];
        uint32_t left = flen;
        while (left) {
          uint32_t w = left > sizeof sink ? sizeof sink : left;
          if ((rc = h2::recv_all(c, sink, w)) != 0) return rc;
          left -= w;
        }
        break;
      }
    }
  }
  // Flush remaining connection-window credit so long-lived connections
  // never slowly drain the shared window.
  if (conn_unacked > 0) {
    uint8_t wu[4];
    h2::put32(wu, static_cast<uint32_t>(conn_unacked));
    h2::send_frame(c, 8, 0, 0, wu, 4);
    tb_stat_add(TB_STAT_H2_WINDOW_UPDATES_TX, 1);
  }
  if (tag_out) *tag_out = ready->tag;
  if (grpc_status_out) *grpc_status_out = ready->grpc_status;
  if (http_status_out) *http_status_out = ready->http_status;
  if (first_byte_ns_out) *first_byte_ns_out = ready->first_byte_ns;
  if (total_ns_out) *total_ns_out = tb_now_ns() - ready->t_start;
  if (result_out) *result_out = ready->err ? ready->err : ready->out_len;
  h2_close_stream(c, ready);
  return 1;
}

// One gRPC ReadObject on a tb_conn handle — the sequential convenience
// wrapper over submit+poll (exactly one stream in flight). Returns
// content bytes landed in ``buf``, or a negative TB_*/-errno code.
// ``grpc_status_out`` is the trailer's grpc-status when it was parseable,
// else -1 (success is then judged by the caller comparing the byte count
// against object metadata).
int64_t tb_grpc_read(int64_t h, const char* authority, const char* bucket_path,
                     const char* object_name,
                     const char* extra_headers,  // "k: v\r\n..." or ""
                     int64_t read_offset, int64_t read_limit, void* buf,
                     int64_t buf_len, int64_t* first_byte_ns_out,
                     int64_t* total_ns_out, int* grpc_status_out) {
  if (grpc_status_out) *grpc_status_out = -1;
  int64_t rc = tb_grpc_submit(h, authority, bucket_path, object_name,
                              extra_headers, read_offset, read_limit, buf,
                              buf_len, 0);
  if (rc != 0) return rc;
  uint64_t tag;
  int64_t result = 0;
  int gs = -1;
  rc = tb_grpc_poll(h, &tag, &result, &gs, nullptr, first_byte_ns_out,
                    total_ns_out);
  if (grpc_status_out) *grpc_status_out = gs;
  if (rc < 0) return rc;
  if (rc == 0) return TB_EPROTO;  // submitted stream vanished: broken state
  return result;
}

// --------------------------- loopback source server (tb_srv_*) -----------
// A minimal HTTP/1.1 object server running entirely on native threads,
// serving pre-rendered bytes from caller-owned memory. Purpose: the
// native-executor bench window needs a loopback source that does NOT
// burn the host CPU in a Python interpreter loop — on a single-core
// host a Python loopback server competes with the client and the JAX
// transfer path for the one core, confounding the measurement. Routes:
// GET ...alt=media (+ optional "Range: bytes=a-b") → 200/206 slice of
// the body; any other GET → the caller-provided metadata JSON.
// Keep-alive; one detached pthread per connection.

namespace srv {

struct server {
  int listen_fd;
  const uint8_t* body;
  int64_t body_len;
  char* meta_json;
  pthread_t accept_thread;
  int stop;  // cross-thread: access ONLY via __atomic builtins
  pthread_mutex_t mu;
  int conn_fds[256];  // live connection fds, for shutdown on stop
  int n_conns;
  int active;  // live connection-thread count (atomic access only)
  int64_t rejected;  // connections refused at the tracking cap (under mu)
};

struct srv_conn_arg {
  server* s;
  int fd;
};

static int srv_send_all(int fd, const void* p, int64_t n) {
  const uint8_t* b = static_cast<const uint8_t*>(p);
  int64_t off = 0;
  while (off < n) {
    ssize_t w = send(fd, b + off, static_cast<size_t>(n - off), MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return -1;
    }
    off += w;
  }
  return 0;
}

// Track/untrack a live connection fd. Returns 1 on success; 0 when the
// 256-fd tracking table is full — the caller must then REJECT the
// connection. An untracked connection would survive tb_srv_stop's
// shutdown sweep, block the bounded thread-join wait, and force the
// server struct (and the caller's body buffer) to leak silently with
// nothing attributing it; rejecting + logging makes the leak condition
// loud and attributable instead.
static int srv_track_conn(server* s, int fd, int add) {
  int ok = 1;
  pthread_mutex_lock(&s->mu);
  if (add) {
    if (s->n_conns < 256) {
      s->conn_fds[s->n_conns++] = fd;
    } else {
      ok = 0;
      s->rejected++;
      fprintf(stderr,
              "tpubench tb_srv: connection-tracking cap (256) reached; "
              "rejecting new connection (total rejected: %lld)\n",
              static_cast<long long>(s->rejected));
    }
  } else {
    for (int i = 0; i < s->n_conns; i++) {
      if (s->conn_fds[i] == fd) {
        s->conn_fds[i] = s->conn_fds[--s->n_conns];
        break;
      }
    }
  }
  pthread_mutex_unlock(&s->mu);
  return ok;
}

static void* srv_conn_main(void* argp) {
  srv_conn_arg* a = static_cast<srv_conn_arg*>(argp);
  server* s = a->s;
  int fd = a->fd;
  free(a);
  char req[8192];
  size_t have = 0;
  while (!__atomic_load_n(&s->stop, __ATOMIC_ACQUIRE)) {
    // Accumulate one request head (these clients send no bodies).
    char* end = nullptr;
    while (!(end = static_cast<char*>(
                 memmem(req, have, "\r\n\r\n", 4)))) {
      if (have >= sizeof(req) - 1) goto done;  // oversized head: drop
      ssize_t r = recv(fd, req + have, sizeof(req) - 1 - have, 0);
      if (r <= 0) goto done;
      have += static_cast<size_t>(r);
    }
    {
      size_t head_len = static_cast<size_t>(end - req) + 4;
      req[head_len - 1] = '\0';  // NUL-terminate for strstr/sscanf
      int is_media = strstr(req, "alt=media") != nullptr;
      int64_t start = 0, last = s->body_len - 1;
      int ranged = 0;
      int unsatisfiable = 0;
      const char* rg = strstr(req, "\r\nRange: bytes=");
      if (!rg) rg = strstr(req, "\r\nrange: bytes=");
      if (rg) {
        const char* rv = rg + 15;
        if (rv[0] == '-' && isdigit(static_cast<unsigned char>(rv[1]))) {
          // Suffix range "bytes=-N" (RFC 9110 §14.1.2): the LAST N bytes
          // — sscanf's "%lld" would otherwise swallow the sign and serve
          // a 206 from offset 0 with a wrong Content-Range. N == 0 and
          // empty bodies are unsatisfiable → 416, never a bogus 206.
          long long suf = atoll(rv + 1);
          ranged = 1;
          if (suf <= 0 || s->body_len == 0) {
            unsatisfiable = 1;
          } else {
            start = suf >= s->body_len ? 0 : s->body_len - suf;
            last = s->body_len - 1;
          }
        } else {
          long long as = 0, bs = -1;
          if (sscanf(rv, "%lld-%lld", &as, &bs) >= 1) {
            ranged = 1;
            start = as;
            last = bs >= 0 ? bs : s->body_len - 1;
            if (as >= s->body_len) unsatisfiable = 1;  // past EOF → 416
          }
        }
      }
      char hdr[512];
      if (!is_media) {
        int mlen = static_cast<int>(strlen(s->meta_json));
        int hn = snprintf(hdr, sizeof(hdr),
                          "HTTP/1.1 200 OK\r\n"
                          "Content-Type: application/json\r\n"
                          "Content-Length: %d\r\n\r\n",
                          mlen);
        if (srv_send_all(fd, hdr, hn) != 0) goto done;
        if (srv_send_all(fd, s->meta_json, mlen) != 0) goto done;
      } else if (unsatisfiable) {
        int hn = snprintf(hdr, sizeof(hdr),
                          "HTTP/1.1 416 Range Not Satisfiable\r\n"
                          "Content-Range: bytes */%lld\r\n"
                          "Content-Length: 0\r\n\r\n",
                          static_cast<long long>(s->body_len));
        if (srv_send_all(fd, hdr, hn) != 0) goto done;
      } else {
        if (start < 0) start = 0;
        if (last > s->body_len - 1) last = s->body_len - 1;
        int64_t n = last >= start ? last - start + 1 : 0;
        int hn;
        if (ranged) {
          hn = snprintf(hdr, sizeof(hdr),
                        "HTTP/1.1 206 Partial Content\r\n"
                        "Content-Type: application/octet-stream\r\n"
                        "Content-Range: bytes %lld-%lld/%lld\r\n"
                        "Content-Length: %lld\r\n\r\n",
                        static_cast<long long>(start),
                        static_cast<long long>(last),
                        static_cast<long long>(s->body_len),
                        static_cast<long long>(n));
        } else {
          hn = snprintf(hdr, sizeof(hdr),
                        "HTTP/1.1 200 OK\r\n"
                        "Content-Type: application/octet-stream\r\n"
                        "Content-Length: %lld\r\n\r\n",
                        static_cast<long long>(n));
        }
        if (srv_send_all(fd, hdr, hn) != 0) goto done;
        if (n > 0 && srv_send_all(fd, s->body + start, n) != 0) goto done;
      }
      // Keep-alive: drop the consumed head, keep any pipelined tail.
      memmove(req, req + head_len, have - head_len);
      have -= head_len;
    }
  }
done:
  srv_track_conn(s, fd, 0);
  close(fd);
  __sync_fetch_and_sub(&s->active, 1);
  return nullptr;
}

static void* srv_accept_main(void* argp) {
  server* s = static_cast<server*>(argp);
  while (!__atomic_load_n(&s->stop, __ATOMIC_ACQUIRE)) {
    int fd = accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (errno == EINTR) continue;
      return nullptr;  // listen fd closed: stopping
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    srv_conn_arg* a = static_cast<srv_conn_arg*>(malloc(sizeof(srv_conn_arg)));
    if (!a) {
      close(fd);
      continue;
    }
    a->s = s;
    a->fd = fd;
    if (!srv_track_conn(s, fd, 1)) {
      // Tracking table full: refuse rather than serve an fd that stop()
      // could never shut down (see srv_track_conn).
      close(fd);
      free(a);
      continue;
    }
    __sync_fetch_and_add(&s->active, 1);
    pthread_t t;
    pthread_attr_t attr;
    pthread_attr_init(&attr);
    pthread_attr_setdetachstate(&attr, PTHREAD_CREATE_DETACHED);
    if (pthread_create(&t, &attr, srv_conn_main, a) != 0) {
      srv_track_conn(s, fd, 0);
      __sync_fetch_and_sub(&s->active, 1);
      close(fd);
      free(a);
    }
    pthread_attr_destroy(&attr);
  }
  return nullptr;
}

}  // namespace srv

// Start the loopback server on 127.0.0.1:<ephemeral>. ``body``/``meta_json``
// are BORROWED: the caller keeps them alive until tb_srv_stop returns.
// Returns an opaque handle (NULL on failure); *port_out gets the port.
void* tb_srv_start(const void* body, int64_t body_len, const char* meta_json,
                   int* port_out) {
  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) return nullptr;
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr;
  memset(&addr, 0, sizeof addr);
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = 0;
  if (bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0 ||
      listen(lfd, 64) != 0) {
    close(lfd);
    return nullptr;
  }
  socklen_t alen = sizeof addr;
  if (getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &alen) != 0) {
    close(lfd);
    return nullptr;
  }
  srv::server* s =
      static_cast<srv::server*>(calloc(1, sizeof(srv::server)));
  if (!s) {
    close(lfd);
    return nullptr;
  }
  s->listen_fd = lfd;
  s->body = static_cast<const uint8_t*>(body);
  s->body_len = body_len;
  s->meta_json = strdup(meta_json ? meta_json : "{}");
  pthread_mutex_init(&s->mu, nullptr);
  if (pthread_create(&s->accept_thread, nullptr, srv::srv_accept_main, s) != 0) {
    close(lfd);
    free(s->meta_json);
    free(s);
    return nullptr;
  }
  if (port_out) *port_out = ntohs(addr.sin_port);
  return s;
}

// Stop. Closes the listener, shuts down live (tracked) connections, and
// waits (bounded) for connection threads to exit. Returns 0 when every
// connection thread exited — the caller may free the body buffer — or 1
// when some thread is still alive (blocked on an untracked/stalled
// peer): the server struct is then intentionally LEAKED rather than
// freed under a thread that still dereferences it, and the caller must
// keep the body buffer pinned for the life of the process.
int tb_srv_stop(void* handle) {
  if (!handle) return 0;
  srv::server* s = static_cast<srv::server*>(handle);
  __atomic_store_n(&s->stop, 1, __ATOMIC_RELEASE);
  shutdown(s->listen_fd, SHUT_RDWR);
  close(s->listen_fd);
  pthread_join(s->accept_thread, nullptr);
  pthread_mutex_lock(&s->mu);
  for (int i = 0; i < s->n_conns; i++) shutdown(s->conn_fds[i], SHUT_RDWR);
  pthread_mutex_unlock(&s->mu);
  for (int spins = 0;
       __atomic_load_n(&s->active, __ATOMIC_ACQUIRE) > 0 && spins < 2000;
       spins++)
    usleep(1000);  // connection threads close their own fds
  if (__atomic_load_n(&s->active, __ATOMIC_ACQUIRE) > 0)
    return 1;  // leak: never free under a live thread
  free(s->meta_json);
  pthread_mutex_destroy(&s->mu);
  free(s);
  return 0;
}

}  // extern "C"
