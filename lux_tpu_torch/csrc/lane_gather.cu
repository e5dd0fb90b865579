// Per-row lane shuffle out[r, c] = x[r, idx[r, c]] on (R, 128), for sm_90a.
//
// Replaces: lux_tpu/ops/pallas_shuffle.py lane_gather (kernel body
// _lane_kernel), the TPU lane-axis dynamic gather that is one unfused Benes
// pass of the routed pull and one level of its fill-forward.
//
// What bounds it on the H100: memory.  Per element it reads the value (4 or
// 2 bytes) and its index (1 byte as uint8, 4 as int32) and writes the value;
// there is no arithmetic but address math.  So the bound is
// R * 128 * (2 * esize + isize) bytes over 3.35 TB/s: 0.0451 ms at the main
// path's (131072, 128) f32 / uint8, 0.0056 at a part's (16384, 128), 0.0014
// at a ring or scatter bucket's (4096, 128).
//
// The old design: one warp a row, grid-striding over rows.  A
// lane loaded four indices as one vector, then read its four values from
// the row in device memory (after the first miss from L1) and stored them
// as one vector.  Each row was a chain of dependent memory latencies with
// nothing of the next row in flight, and at 4,096 rows the grid was 512
// blocks that each lived for about one such chain.  It read 0.0557 ms at
// the main shape (81 % of the bound), and at the small shapes it lost to
// torch.gather (PERF.md, kernel 3).
//
// This design streams tiles through shared memory with the Tensor Memory
// Accelerator.  A block owns tiles of T rows (T * 128 values and their
// indices, each one contiguous range of device memory); thread 0 starts
// two one-dimensional bulk copies a tile (cp.async.bulk, completing on the
// stage's mbarrier) into a ring of kStages = 2 stages, so while the block
// gathers one tile the next is in flight.  The gather reads
// x[r, idx[r, c]] and idx from shared memory and stores 16-byte vectors,
// a warp a contiguous 512 bytes.  The grid is persistent: one block an SM
// walks the tiles.  For small R, T shrinks (32 down to 1, a power of two)
// until there is at least one tile an SM, so 4,096 rows still fill the
// 132 SMs.  Two stages and one block an SM (about 40 KB of tiles an SM)
// were chosen on the card among rings of 2 to 4 stages and 1 to 4 blocks
// an SM: at the main shape the deeper rings and the extra blocks read no
// faster.  Every form stays: f32, bf16 and int32 values
// (moved as raw bits), uint8 and int32 indices, any R >= 1.  x and idx
// must start on a 16-byte boundary (the bulk copies' rule; the wrapper
// raises on a view that does not).  Index values are promised to be < 128
// (the planners assert it); the kernel reads idx & 127, so a bad index
// reads a wrong value of its own row, never outside the tile.
#include <atomic>

#include "lux_shuffle.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kMaxTileRows = 32;
constexpr int kBlocksPerSm = 1;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive once on bar and add tx_bytes to the transfer count its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t tx_bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(tx_bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// One-dimensional bulk copy (TMA) of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from device memory into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Sixteen bytes of consecutive elements of one row: E indices and values.
template <typename T> struct Chunk {
  static constexpr int E = 16 / sizeof(T);
};

template <typename I, int E> struct IdxE;
template <> struct IdxE<uint8_t, 4> {
  static __device__ __forceinline__ void load(const uint8_t* p, int (&o)[4]) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = (w >> (8 * j)) & 127;
  }
};
template <> struct IdxE<uint8_t, 8> {
  static __device__ __forceinline__ void load(const uint8_t* p, int (&o)[8]) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = (w.x >> (8 * j)) & 127;
      o[4 + j] = (w.y >> (8 * j)) & 127;
    }
  }
};
template <> struct IdxE<int32_t, 4> {
  static __device__ __forceinline__ void load(const int32_t* p, int (&o)[4]) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    o[0] = w.x & 127; o[1] = w.y & 127; o[2] = w.z & 127; o[3] = w.w & 127;
  }
};
template <> struct IdxE<int32_t, 8> {
  static __device__ __forceinline__ void load(const int32_t* p, int (&o)[8]) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int4 w = reinterpret_cast<const int4*>(p)[m];
      o[4 * m] = w.x & 127; o[4 * m + 1] = w.y & 127;
      o[4 * m + 2] = w.z & 127; o[4 * m + 3] = w.w & 127;
    }
  }
};

template <typename T>
__device__ __forceinline__ uint4 pack16(const T (&v)[Chunk<T>::E]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    return make_uint4(v[0] | (uint32_t(v[1]) << 16), v[2] | (uint32_t(v[3]) << 16),
                      v[4] | (uint32_t(v[5]) << 16), v[6] | (uint32_t(v[7]) << 16));
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const T* __restrict__ x, const I* __restrict__ idx, T* __restrict__ out,
                   long long rows, int tile_rows, long long num_tiles) {
  constexpr int E = Chunk<T>::E;
  extern __shared__ __align__(128) unsigned char smem[];
  const int x_bytes = tile_rows * kLane * (int)sizeof(T);
  const int stage_bytes = x_bytes + tile_rows * kLane * (int)sizeof(I);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes);

  // Thread 0 starts tile t's two copies into stage s.
  auto issue = [&](long long t, int s) {
    const long long r0 = t * tile_rows;
    const int n = (int)(rows - r0 < tile_rows ? rows - r0 : tile_rows);
    const uint32_t xb = n * kLane * sizeof(T), ib = n * kLane * sizeof(I);
    mbar_expect_tx(&bar[s], xb + ib);
    bulk_load(smem + s * stage_bytes, x + r0 * kLane, xb, &bar[s]);
    bulk_load(smem + s * stage_bytes + x_bytes, idx + r0 * kLane, ib, &bar[s]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      const long long t = blockIdx.x + (long long)s * gridDim.x;
      if (t < num_tiles) issue(t, s);
    }

  int it = 0;
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x, ++it) {
    const int s = it % kStages;
    while (!mbar_try_wait(&bar[s], (uint32_t)(it / kStages) & 1u)) {
    }
    const T* xs = reinterpret_cast<const T*>(smem + s * stage_bytes);
    const I* is = reinterpret_cast<const I*>(smem + s * stage_bytes + x_bytes);
    const long long r0 = t * tile_rows;
    const int n = (int)(rows - r0 < tile_rows ? rows - r0 : tile_rows);
    uint4* o = reinterpret_cast<uint4*>(out + r0 * kLane);
    for (int c = threadIdx.x; c < n * kLane / E; c += kThreads) {
      const int p = c * E;
      const T* xr = xs + (p & ~(kLane - 1));
      int q[E];
      IdxE<I, E>::load(is + p, q);
      T v[E];
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = xr[q[j]];
      o[c] = pack16<T>(v);
    }
    __syncthreads();  // every read of stage s is done
    if (threadIdx.x == 0) {
      const long long next = t + (long long)kStages * gridDim.x;
      if (next < num_tiles) {
        // order this block's reads of the stage before the copy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(next, s);
      }
    }
  }
}

// Per device: the SM count and whether each kernel form may take its
// dynamic shared memory (set once; above 48 KB it must be opted in).
int num_sms(int dev) {
  static std::atomic<int> sms[64];
  int n = sms[dev & 63].load(std::memory_order_relaxed);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev & 63].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <typename T, typename I>
int smem_bytes(int tile_rows) {
  return kStages * tile_rows * kLane * (int)(sizeof(T) + sizeof(I)) + kStages * 8;
}

template <typename T, typename I>
cudaError_t launch(const void* x, const void* idx, long long rows, void* out,
                   cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  static std::atomic<unsigned long long> opted{0};
  if (!(opted.load(std::memory_order_relaxed) >> (dev & 63) & 1)) {
    const cudaError_t rc = cudaFuncSetAttribute(lane_gather_kernel<T, I>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                smem_bytes<T, I>(kMaxTileRows));
    if (rc != cudaSuccess) return rc;
    opted.fetch_or(1ull << (dev & 63));
  }
  const long long want_tiles = (long long)kBlocksPerSm * num_sms(dev);
  int tile_rows = kMaxTileRows;
  while (tile_rows > 1 && (rows + tile_rows - 1) / tile_rows < want_tiles) tile_rows >>= 1;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  const int grid = (int)(tiles < want_tiles ? tiles : want_tiles);
  lane_gather_kernel<T, I><<<grid, kThreads, smem_bytes<T, I>(tile_rows), stream>>>(
      static_cast<const T*>(x), static_cast<const I*>(idx), static_cast<T*>(out), rows,
      tile_rows, tiles);
  return cudaSuccess;
}

}  // namespace

// esize: 4 (float32, int32) or 2 (bfloat16); isize: 1 (uint8) or 4 (int32).
// x, idx and out must start on a 16-byte boundary.  Returns
// cudaGetLastError() after the launch (0 = launched); cudaErrorInvalidValue
// for an unsupported size, rows < 1 or a misaligned array.
extern "C" int lux_lane_gather(const void* x, int esize, const void* idx, int isize,
                               long long rows, void* out, void* stream) {
  if (rows < 1 || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(idx) |
                    reinterpret_cast<uintptr_t>(out)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (esize == 4 && isize == 1) rc = launch<uint32_t, uint8_t>(x, idx, rows, out, s);
  else if (esize == 4 && isize == 4) rc = launch<uint32_t, int32_t>(x, idx, rows, out, s);
  else if (esize == 2 && isize == 1) rc = launch<uint16_t, uint8_t>(x, idx, rows, out, s);
  else if (esize == 2 && isize == 4) rc = launch<uint16_t, int32_t>(x, idx, rows, out, s);
  else return (int)cudaErrorInvalidValue;
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
