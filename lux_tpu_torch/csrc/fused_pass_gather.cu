// One pass-fused group of a routed permutation: 2-3 Benes passes chained on
// a tile held in shared memory, for sm_90a.
//
// Replaces: lux_tpu/ops/pallas_shuffle.py fused_pass_gather (kernel body
// _pf_kernel), the TPU kernel that chains a group's steps on a VMEM tile so
// the group costs one read and one write of the array instead of one per
// pass.
//
// What bounds it on the H100: memory.  Per element it reads the value once
// and one index per step, and writes the value once:
// n * (2 * esize + steps * isize) bytes over 3.35 TB/s — at the main path's
// groups (n = 2^24, f32, 2-3 steps of uint8 indices) 167.8-184.5 MB, 0.050-
// 0.055 ms.  Every step is a permutation within a block of the group's
// digits, so nothing but the first read and the last write needs device
// memory.
//
// Design: one CTA of up to 512 threads per tile of block_rows x 128
// elements (the planner's tile, ops/shuffle._pf_block_rows: at most 128
// rows = 16,384 elements), with TWO CTAs resident on each SM, so one CTA's
// tile load and stores overlap the other's shared-memory steps:
//   * the tile comes in with cp.async, 16 bytes a copy, every copy of the
//     CTA in flight at once, into a swizzled shared buffer (lux_shuffle.cuh);
//   * each thread owns units of 16 consecutive positions (two at the full
//     tile): a step reads the unit's 16 indices in one 16-byte load (a warp
//     reads 512 contiguous bytes), gathers the 16 sources of the step's
//     input into registers, and after a barrier writes them back in place.
//     One buffer, not two: 64 KB for f32, 32 KB for bf16.  The in-tile
//     relayout (the reference's reshape/transpose/reshape) is folded into
//     the read address, so it costs no pass of its own, and through a
//     128-entry lane table per step (lux_shuffle.cuh, step_base) an
//     element's address is one table read and one XOR;
//   * the next step's indices are loaded before that barrier, so their
//     latency hides behind it;
//   * the last step writes straight to device memory, 16 bytes a store.
// __launch_bounds__(512, 2) holds a thread to 64 registers: 32 values, the
// index words, addresses.
#include "lux_shuffle.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnitsPerThread = 2;
constexpr int kMaxTile = kThreads * kUnit * kUnitsPerThread;  // 16,384 elements

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads, 2)
fused_pass_kernel(const T* __restrict__ x, T* __restrict__ out, StepPlan plan, int tile_elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint16_t lut[kMaxSteps * kLane];
  T* tile = reinterpret_cast<T*>(smem);
  const long long base = (long long)blockIdx.x * tile_elems;
  const int units = tile_elems / kUnit;
  tile_load_async(x + base, tile, tile_elems);
  build_lane_luts<T>(plan, lut);
  bool act[kUnitsPerThread];
  int p0[kUnitsPerThread];
  Idx16<I> q[kUnitsPerThread];
#pragma unroll
  for (int g = 0; g < kUnitsPerThread; ++g) {
    const int u = threadIdx.x + g * blockDim.x;
    act[g] = u < units;
    p0[g] = u * kUnit;
    if (act[g]) q[g].load(static_cast<const I*>(plan.idx[0]) + base + p0[g]);
  }
  cp_async_wait_all();
  __syncthreads();
  T v[kUnitsPerThread][kUnit];
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    if (s < plan.n_steps) {
#pragma unroll
      for (int g = 0; g < kUnitsPerThread; ++g)
        if (act[g])
          step_read16(tile, step_base<T>(plan, s, 0, p0[g] & ~(kLane - 1)), lut + s * kLane,
                      q[g], v[g]);
      if (s + 1 < plan.n_steps) {
        const I* next = static_cast<const I*>(plan.idx[s + 1 < kMaxSteps ? s + 1 : s]) + base;
#pragma unroll
        for (int g = 0; g < kUnitsPerThread; ++g)
          if (act[g]) q[g].load(next + p0[g]);
        __syncthreads();
#pragma unroll
        for (int g = 0; g < kUnitsPerThread; ++g)
          if (act[g]) store16_tile(tile, p0[g], v[g]);
        __syncthreads();
      } else {
#pragma unroll
        for (int g = 0; g < kUnitsPerThread; ++g)
          if (act[g]) store16_global(out + base + p0[g], v[g]);
      }
    }
  }
}

template <typename T, typename I>
int launch(const void* x, const StepPlan& plan, long long rows, int block_rows, void* out,
           cudaStream_t stream) {
  static size_t opted = 48 * 1024;  // per instantiation: the largest opted in
  const int tile_elems = block_rows * kLane;
  // a thread owns up to two units; a small tile runs one thread a unit
  const int units = tile_elems / kUnit;
  const int threads = units < kThreads ? units : kThreads;
  const size_t smem = (size_t)tile_elems * sizeof(T);
  if (smem > opted) {
    // above 48 KB the kernel must opt in (its static shared memory counts
    // against the same per-block limit)
    const cudaError_t e = cudaFuncSetAttribute(
        fused_pass_kernel<T, I>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  const long long tiles = rows / block_rows;
  fused_pass_kernel<T, I><<<(unsigned)tiles, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), plan, tile_elems);
  return 0;
}

bool shape_ok(long long rows, int block_rows) {
  const long long tile_elems = (long long)block_rows * kLane;
  return block_rows >= 1 && tile_elems <= kMaxTile && rows >= block_rows &&
         rows % block_rows == 0 && rows / block_rows <= 0x7fffffffLL;
}

}  // namespace

// x, out: (rows, 128) of esize-byte elements (4 or 2), 16-byte aligned;
// idx: a host array of kMaxSteps device pointers to the (rows, 128) index
// tiles of isize bytes (1 or 4), 16-byte aligned; desc: the host step table
// (lux_shuffle.cuh).  rows must be a positive multiple of block_rows, and a
// tile (block_rows * 128) at most 16,384 elements.  Returns
// cudaGetLastError() after the launch (0 = launched); cudaErrorInvalidValue
// for a malformed call.
extern "C" int lux_fused_pass_gather(const void* x, int esize, const void* const* idx,
                                     int isize, const int32_t* desc, long long rows,
                                     int block_rows, void* out, void* stream) {
  StepPlan plan;
  if (!parse_steps(desc, idx, &plan) || !shape_ok(rows, block_rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (esize == 4 && isize == 1) rc = launch<uint32_t, uint8_t>(x, plan, rows, block_rows, out, s);
  else if (esize == 4 && isize == 4) rc = launch<uint32_t, int32_t>(x, plan, rows, block_rows, out, s);
  else if (esize == 2 && isize == 1) rc = launch<uint16_t, uint8_t>(x, plan, rows, block_rows, out, s);
  else if (esize == 2 && isize == 4) rc = launch<uint16_t, int32_t>(x, plan, rows, block_rows, out, s);
  else return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
