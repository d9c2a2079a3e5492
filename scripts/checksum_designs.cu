// The designs tried for tb_checksum, built beside the shipped one so that
// scripts/checksum_designs.py can time them all on one card in one run.
// Only the shipped design lives in the port (landing.cu, included here:
// a persistent grid over checksum_plan's chunks, 8 loads a thread in flight
// with the L2::256B hint); this file adds the alternatives:
//
//   grid_stride   the first port's kernel: land_kernel<false> on grid_for's
//                 grid (up to 8 blocks of 256 threads per SM, each thread
//                 one or two 16-byte loads), one atomicAdd per block;
//   bulk<S, R>    one thread puts the block's chunk in flight as 1-D bulk
//                 copies (cp.async.bulk, the Tensor Memory Accelerator)
//                 into a ring of R shared-memory stages of S bytes, each
//                 signalled by an mbarrier; every warp sums the stages as
//                 they land and a stage is refilled once summed;
//   regs<T, K, H> persistent blocks of T threads over the same chunks as
//                 the shipped kernel, each thread starting K independent
//                 16-byte loads before its first add, with (H) or without
//                 the L2::256B prefetch hint;
//   stride<T, K, H> the same K loads a thread, but interleaved over the
//                 whole input as the grid-stride loop is (load k of a
//                 thread is k grid-widths after its first);
//
// and two floors of the timing, which read nothing and add 0: one block
// that returns at once, and the split's blocks each doing only the
// block's atomicAdd.

#include "../tpubench_torch/kernels/csrc/landing.cu"

namespace {

template <int kT>
__device__ __forceinline__ uint32_t block_sum_of(uint32_t s) {
  __shared__ uint32_t warp_sums[kT / 32];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFullMask, s, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kT / 32 ? warp_sums[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFullMask, s, off);
  }
  return s;
}

template <bool kHint>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  if (kHint) return load_stream(p);
  return __ldg(p);
}

template <int kT, int kK, bool kHint>
__global__ void __launch_bounds__(kT)
regs_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ acc, int64_t n,
            int64_t chunk) {
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  const int64_t body = lo < hi ? (hi - lo) & ~int64_t{15} : 0;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + lo);
  const int64_t nvec = body / 16;
  uint32_t s = 0;
  for (int64_t base = threadIdx.x; base < nvec; base += kT * kK) {
    uint4 v[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int64_t i = base + static_cast<int64_t>(k) * kT;
      v[k] = i < nvec ? load16<kHint>(xv + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) s = add_bytes(v[k], s);
  }
  for (int64_t j = lo + body + threadIdx.x; j < hi; j += kT) s += x[j];
  s = block_sum_of<kT>(s);
  if (threadIdx.x == 0) atomicAdd(acc, s);
}

template <int kT, int kK, bool kHint>
__global__ void __launch_bounds__(kT)
stride_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ acc, int64_t n) {
  const int64_t nvec = n / 16;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kT;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kT + threadIdx.x;
  uint32_t s = 0;
  for (int64_t base = first; base < nvec; base += stride * kK) {
    uint4 v[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int64_t i = base + k * stride;
      v[k] = i < nvec ? load16<kHint>(xv + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) s = add_bytes(v[k], s);
  }
  for (int64_t j = nvec * 16 + first; j < n; j += stride) s += x[j];
  s = block_sum_of<kT>(s);
  if (threadIdx.x == 0) atomicAdd(acc, s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory; the barrier's phase completes when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Block b sums [b * chunk, min(n, (b + 1) * chunk)): the chunk's whole
// 16-byte vectors through the stage ring, its last n % 16 bytes (tail
// chunk only) with scalar loads.
template <int kStage, int kRing>
__global__ void __launch_bounds__(kThreads)
bulk_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ acc,
                int64_t n, int64_t chunk) {
  extern __shared__ __align__(128) uint4 ring[];  // kRing stages of kStage bytes
  __shared__ __align__(8) uint64_t full[kRing];
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  const int64_t body = lo < hi ? (hi - lo) & ~int64_t{15} : 0;
  const int64_t stages = (body + kStage - 1) / kStage;
  auto fetch = [&](int64_t i) {
    const int64_t off = i * kStage;
    const int64_t left = body - off;
    bulk_load(ring + (i % kRing) * (kStage / 16), x + lo + off,
              static_cast<uint32_t>(left < kStage ? left : kStage), &full[i % kRing]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int64_t i = 0; i < kRing && i < stages; ++i) fetch(i);
  }
  uint32_t s = 0;
  for (int64_t i = 0; i < stages; ++i) {
    mbar_wait(&full[i % kRing], static_cast<uint32_t>((i / kRing) & 1));
    const int64_t left = body - i * kStage;
    const int nvec = static_cast<int>((left < kStage ? left : kStage) / 16);
    const uint4* v = ring + (i % kRing) * (kStage / 16);
    for (int j = threadIdx.x; j < nvec; j += kThreads) s = add_bytes(v[j], s);
    if (i + kRing < stages) {  // uniform across the block
      __syncthreads();         // every thread is done with this stage
      if (threadIdx.x == 0) fetch(i + kRing);
    }
  }
  for (int64_t j = lo + body + threadIdx.x; j < hi; j += kThreads) s += x[j];
  s = block_sum(s);
  if (threadIdx.x == 0) atomicAdd(acc, s);
}

template <int kStage, int kRing>
cudaError_t launch_bulk(const uint8_t* x, uint32_t* acc, int64_t n, int blocks,
                            int64_t chunk, cudaStream_t stream) {
  constexpr int kSmem = kStage * kRing;
  // The ring takes more than the 48 KB of shared memory a block gets
  // without asking; the attribute is set once per device.
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(bulk_kernel<kStage, kRing>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_release);
  }
  bulk_kernel<kStage, kRing><<<blocks, kThreads, kSmem, stream>>>(x, acc, n, chunk);
  return cudaGetLastError();
}

template <int kT, int kK, bool kHint>
cudaError_t launch_regs(const uint8_t* x, uint32_t* acc, int64_t n, int blocks,
                        int64_t chunk, cudaStream_t stream) {
  regs_kernel<kT, kK, kHint><<<blocks, kT, 0, stream>>>(x, acc, n, chunk);
  return cudaGetLastError();
}

template <int kT, int kK, bool kHint>
cudaError_t launch_stride(const uint8_t* x, uint32_t* acc, int64_t n, int blocks,
                          cudaStream_t stream) {
  stride_kernel<kT, kK, kHint><<<blocks, kT, 0, stream>>>(x, acc, n);
  return cudaGetLastError();
}

cudaError_t launch_grid_stride(const uint8_t* x, uint32_t* acc, int64_t n,
                               cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return err;
  land_kernel<false><<<blocks, kThreads, 0, stream>>>(x, nullptr, acc, n);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

__global__ void atomics_kernel(uint32_t* acc) {
  if (threadIdx.x == 0) atomicAdd(acc, 0u);
}

}  // namespace

// Design `design` (the index in DESIGNS of checksum_designs.py) over
// blocks x chunk; grid_stride and the empty floor take their own grid.
extern "C" int tbx_checksum(int design, const uint8_t* x, uint32_t* acc, int64_t n,
                            int blocks, int64_t chunk, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (design) {
    case 0: err = launch_checksum(x, acc, n, blocks, chunk, st); break;
    case 1: err = launch_grid_stride(x, acc, n, st); break;
    case 2: err = launch_bulk<16 * 1024, 4>(x, acc, n, blocks, chunk, st); break;
    case 3: err = launch_bulk<8 * 1024, 8>(x, acc, n, blocks, chunk, st); break;
    case 4: err = launch_bulk<32 * 1024, 2>(x, acc, n, blocks, chunk, st); break;
    case 5: err = launch_bulk<16 * 1024, 8>(x, acc, n, blocks, chunk, st); break;
    case 6: err = launch_regs<256, 16, false>(x, acc, n, blocks, chunk, st); break;
    case 7: err = launch_regs<512, 8, false>(x, acc, n, blocks, chunk, st); break;
    case 8: err = launch_regs<1024, 4, false>(x, acc, n, blocks, chunk, st); break;
    case 9: err = launch_regs<512, 8, true>(x, acc, n, blocks, chunk, st); break;
    case 10: err = launch_regs<256, 4, true>(x, acc, n, blocks, chunk, st); break;
    case 11: err = launch_stride<512, 8, false>(x, acc, n, blocks, st); break;
    case 12: err = launch_stride<256, 8, false>(x, acc, n, blocks, st); break;
    case 13: err = launch_stride<256, 4, false>(x, acc, n, blocks, st); break;
    case 14: err = launch_stride<512, 8, true>(x, acc, n, blocks, st); break;
    case 15: err = launch_stride<256, 4, true>(x, acc, n, blocks, st); break;
    case 16: err = launch_stride<256, 1, true>(x, acc, n, blocks, st); break;
    case 17: err = launch_stride<256, 2, true>(x, acc, n, blocks, st); break;
    case 18: err = launch_stride<1024, 4, true>(x, acc, n, blocks, st); break;
    case 19:
      empty_kernel<<<1, 32, 0, st>>>();
      err = cudaGetLastError();
      break;
    case 20:
      atomics_kernel<<<blocks, kThreads, 0, st>>>(acc);
      err = cudaGetLastError();
      break;
    default: break;
  }
  return static_cast<int>(err);
}
