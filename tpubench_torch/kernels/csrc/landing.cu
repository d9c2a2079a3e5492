// Landing kernels for the staging path on Hopper (sm_90a).
//
// tb_land replaces the TPU kernel tpubench/staging/pallas_stage.py:pallas_land
// (_land_kernel): one pass over a staged slot that writes a landed copy and
// adds the slot's mod-2^32 byte sum into a device accumulator.
// tb_checksum replaces pallas_stage.py:pallas_checksum (_checksum_kernel)
// and the XLA op staging/device.py:_accum_checksum: the same sum, no copy.
//
// Bound: both are memory-bound. tb_land moves 2n bytes (n read, n written),
// tb_checksum n bytes read, so the least time is bytes / HBM bandwidth
// (3.35 TB/s on an H100 SXM). The byte adds are ~n integer operations,
// three orders of magnitude below the card's integer rate.
//
// tb_land: the TPU kernel walks (512, 128) blocks in order and carries the
// sum in SMEM from one grid step to the next. Blocks here run in parallel
// and in no order, so the sequential accumulator becomes a grid-stride loop
// over 16-byte uint4 vectors (coalesced: neighbouring threads read
// neighbouring 16 B), a per-thread uint32 sum (__dp4a adds the four bytes
// of each 32-bit word), a warp shuffle and shared-memory block reduction,
// and ONE atomicAdd per block into a caller-zeroed accumulator. Addition
// mod 2^32 is associative and commutative, so the result is bit-exact
// whatever order the atomics land in. A scalar loop takes the n % 16 tail,
// so any n is accepted (the validate ring's slots are lane-rounded only,
// not whole 512-row blocks).
//
// tb_checksum: bound by bytes too, but at the validate ring's 7.46 MB slot
// the bytes take ~2.2 us at the HBM rate, while a launch costs a fixed
// ~1.7 us even for an empty kernel, plus one memory latency (both measured
// back to back on an NVIDIA H100 80GB HBM3 at 700.00 W by
// scripts/checksum_designs.py), so fixed costs decide. The first port's
// grid-stride loop added its own: 1,056 small blocks, a thread's second
// load sent only after its first add, 1,056 same-address atomics. This
// kernel is a persistent grid of two 256-thread blocks per SM, each owning
// one contiguous 128-byte-aligned chunk (the split is checksum_plan in
// kernels/landing.py, passed in as blocks x chunk). Every thread sends its
// 8 independent 16-byte loads before its first add, so a whole main-path
// chunk (~28 KB per block, ~56 KB per SM) is in flight in one memory round
// trip; the loads carry the L2::256B prefetch hint; each block adds its
// sum with one atomicAdd (264 in all). The designs tried and not kept
// (1-D bulk copies into an mbarrier-signalled shared-memory ring, other
// grids and unrolls) are in scripts/checksum_designs.cu.
//
// Launch contract: x and out are 16-byte aligned (the Python wrapper
// checks), the kernel runs on the caller's stream, allocates nothing and
// does not synchronise. Each entry point returns cudaGetLastError().
//
// tb_stream_create gives each staging worker a stream of its own: PyTorch's
// torch.cuda.Stream hands out 32 pooled streams per device in rotation, so
// 48 workers would share them in pairs.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads fills an SM's 2048 slots
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;

// SM count per device, read once: every fetch thread launches through
// grid_for, so the attribute query stays off the launch path.
std::atomic<int> g_sms[kMaxDevices];

__device__ __forceinline__ uint32_t add_bytes(uint4 v, uint32_t s) {
  s = __dp4a(v.x, 0x01010101u, s);
  s = __dp4a(v.y, 0x01010101u, s);
  s = __dp4a(v.z, 0x01010101u, s);
  s = __dp4a(v.w, 0x01010101u, s);
  return s;
}

// Sum of s over the block; the result is valid in thread 0.
__device__ __forceinline__ uint32_t block_sum(uint32_t s) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFullMask, s, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFullMask, s, off);
  }
  return s;
}

template <bool kStore>
__global__ void __launch_bounds__(kThreads)
land_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
            uint32_t* __restrict__ acc, int64_t n) {
  const int64_t nvec = n / 16;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ ov = reinterpret_cast<uint4*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t s = 0;
  for (int64_t i = first; i < nvec; i += stride) {
    const uint4 v = __ldg(xv + i);
    if (kStore) ov[i] = v;
    s = add_bytes(v, s);
  }
  for (int64_t i = nvec * 16 + first; i < n; i += stride) {
    const uint8_t b = x[i];
    if (kStore) out[i] = b;
    s += b;
  }
  s = block_sum(s);
  if (threadIdx.x == 0) atomicAdd(acc, s);
}

cudaError_t grid_for(int64_t n, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  const int64_t want = (n / 16 + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  *blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// ---- tb_checksum: persistent blocks, every load in flight before an add ----

constexpr int kLoads = 8;  // 16-byte loads a thread sends before its first add

// A 16-byte load that skips L1 and carries the L2::256B prefetch-size hint:
// on a miss, L2 fetches the surrounding 256 bytes from HBM with it. The
// input is streamed once, in order, so the extra bytes are the next loads'.
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Block b sums [b * chunk, min(n, (b + 1) * chunk)): the chunk's whole
// 16-byte vectors kThreads * kLoads at a time (one pass for a main-path
// chunk), then its last n % 16 bytes (tail chunk only) one by one.
__global__ void __launch_bounds__(kThreads)
checksum_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ acc, int64_t n,
                int64_t chunk) {
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  const int64_t body = lo < hi ? (hi - lo) & ~int64_t{15} : 0;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + lo);
  const int64_t nvec = body / 16;
  uint32_t s = 0;
  for (int64_t base = threadIdx.x; base < nvec; base += kThreads * kLoads) {
    uint4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int64_t i = base + static_cast<int64_t>(k) * kThreads;
      v[k] = i < nvec ? load_stream(xv + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) s = add_bytes(v[k], s);
  }
  for (int64_t j = lo + body + threadIdx.x; j < hi; j += kThreads) s += x[j];
  s = block_sum(s);
  if (threadIdx.x == 0) atomicAdd(acc, s);
}

cudaError_t launch_checksum(const uint8_t* x, uint32_t* acc, int64_t n, int blocks,
                            int64_t chunk, cudaStream_t stream) {
  if (blocks < 1 || chunk < 1 || chunk % 16 || static_cast<int64_t>(blocks) * chunk < n) {
    return cudaErrorInvalidValue;
  }
  checksum_kernel<<<blocks, kThreads, 0, stream>>>(x, acc, n, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tb_land(const uint8_t* x, uint8_t* out, uint32_t* acc, int64_t n,
                       void* stream) {
  int blocks = 0;
  cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  land_kernel<true><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, acc, n);
  return static_cast<int>(cudaGetLastError());
}

// blocks x chunk is the wrapper's checksum_plan(n, SMs): chunk a multiple of
// 16 (whole vectors) and blocks * chunk >= n.
extern "C" int tb_checksum(const uint8_t* x, uint32_t* acc, int64_t n, int blocks,
                           int64_t chunk, void* stream) {
  return static_cast<int>(
      launch_checksum(x, acc, n, blocks, chunk, static_cast<cudaStream_t>(stream)));
}

// A non-blocking stream on the current device, owned by the caller.
extern "C" int tb_stream_create(void** stream) {
  cudaStream_t s = nullptr;
  const cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream = s;
  return static_cast<int>(err);
}
