// The route's final pass group chained with the segmented reduction by
// destination rank (the routed pull's fused-mx reduce), for sm_90a.
//
// Replaces: lux_tpu/ops/pallas_shuffle.py mxreduce_pass_gather (kernel body
// _mx_kernel).  On the TPU each (8, 128) tile runs the group's gathers in
// VMEM, masks sentinel slots, and reduces every row with a one-hot
// (v_blk, 128) @ (128, 1) MXU contraction into the (v_blk, 1) output block
// that scalar-prefetched tile_block / tile_first route it to; the grid runs
// in order, so the tiles of one block accumulate in grid order.
//
// What bounds it on the H100: memory.  Per group-space element it reads the
// value, one index per step and one rank byte, and it writes the small
// totals vector: n2 * (esize + steps * isize + 1) + totals bytes.  The
// one-hot contraction would multiply the work by v_blk for nothing here.
//
// Design.  Hopper runs CTAs in no order, so one CTA owns one output block:
// the planner aligns every block's span to tiles, so a block's tiles are
// contiguous (tile_block is nondecreasing) and the CTA finds them by binary
// search.  It walks them in order, in chunks of up to kChunk elements:
//   * load the chunk into shared memory (a pad word every 32 elements keeps
//     the per-thread walk below free of bank conflicts);
//   * run the group's steps tile by tile, ping-pong between two buffers,
//     each step's relayout folded into its read address;
//   * reduce: ranks are nondecreasing along the final layout, and a rank's
//     real slots are contiguous (sentinel slots, rank == v_blk, are padding
//     and carry nothing), so each thread walks a contiguous slice in order,
//     combining runs of equal rank.  A run closed strictly inside a slice
//     belongs to that thread alone and is combined into the block's
//     accumulator directly; the runs touching a slice's ends are merged in
//     slice order by warp 0 (eight slices a lane, then lane 0 over the
//     lanes).  The order of every combination is fixed, so results are
//     deterministic, with no atomics.
// Float sums accumulate in f32 (out f32); int32 sums wrap through uint32;
// min/max keep the type (NaN propagates like torch.minimum/maximum).
// Known limit: a block that spans many tiles (an RMAT hub) is walked by one
// CTA, so that CTA sets the kernel's tail — the same hub cost as
// spmv_blockcsr; splitting it is later work.
#include "lux_ops.cuh"
#include "lux_shuffle.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;  // ops/shuffle.MX_MAX_TILE_ELEMS
constexpr int kPadded = kChunk + kChunk / 32;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ int padix(int p) { return p + (p >> 5); }

// Runs of equal rank seen in order: the first run (kept, it may continue a
// run that began before), the open last run, and everything in between
// combined into acc as it closes.
template <typename TAcc, int OP>
struct Runs {
  int fk, lk, n;
  TAcc fv, lv;
  __device__ void init() { fk = -1; lk = -1; n = 0; fv = Combine<TAcc, OP>::neutral(); lv = fv; }
  __device__ void add(int k, TAcc v, TAcc* acc) {
    if (n > 0 && k == lk) { lv = Combine<TAcc, OP>::apply(lv, v); return; }
    if (n == 1) { fk = lk; fv = lv; }
    else if (n > 1) acc[lk] = Combine<TAcc, OP>::apply(acc[lk], lv);
    lk = k; lv = v; ++n;
  }
  // Fold a later summary (its first run, and its last run if it has two).
  __device__ void add_summary(int sfk, TAcc sfv, int slk, TAcc slv, int sn, TAcc* acc) {
    if (sn == 0) return;
    add(sfk, sfv, acc);
    if (sn > 1) add(slk, slv, acc);
  }
  __device__ void finish() { if (n == 1) { fk = lk; fv = lv; } }
  __device__ void flush(TAcc* acc) {
    if (n > 1) acc[fk] = Combine<TAcc, OP>::apply(acc[fk], fv);
    if (n > 0) acc[lk] = Combine<TAcc, OP>::apply(acc[lk], lv);
  }
};

template <typename T, typename TAcc, int OP, typename I>
__global__ void __launch_bounds__(kThreads)
mxreduce_kernel(const T* __restrict__ x, StepPlan plan, const I* __restrict__ ranks,
                const int32_t* __restrict__ tile_block, int num_tiles, int tile_elems,
                int v_blk, TAcc* __restrict__ out) {
  using C = Combine<TAcc, OP>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf0 = reinterpret_cast<T*>(smem);
  T* buf1 = buf0 + kPadded;
  TAcc* acc = reinterpret_cast<TAcc*>(buf1 + kPadded);
  TAcc* s_fv = acc + v_blk;
  TAcc* s_lv = s_fv + kThreads;
  int* s_fk = reinterpret_cast<int*>(s_lv + kThreads);
  int* s_lk = s_fk + kThreads;
  int* s_n = s_lk + kThreads;
  __shared__ int span[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) span[0] = lower_bound_i32(tile_block, num_tiles, b);
  if (tid == 32) span[1] = lower_bound_i32(tile_block, num_tiles, b + 1);
  for (int v = tid; v < v_blk; v += kThreads) acc[v] = C::neutral();
  __syncthreads();
  const int t_end = span[1];
  const int per_chunk = kChunk / tile_elems;
  for (int t0 = span[0]; t0 < t_end; t0 += per_chunk) {
    const int nt = min(per_chunk, t_end - t0);
    const int len = nt * tile_elems;
    const long long base = (long long)t0 * tile_elems;
    for (int p = tid; p < len; p += kThreads) buf0[padix(p)] = x[base + p];
    __syncthreads();
    int cur = 0;
#pragma unroll
    for (int s = 0; s < kMaxSteps; ++s) {
      if (s < plan.n_steps) {
        const I* ix = static_cast<const I*>(plan.idx[s]) + base;
        const T* src = cur ? buf1 : buf0;
        T* dst = cur ? buf0 : buf1;
        const bool rel = plan.has_relayout[s] != 0;
        for (int p = tid; p < len; p += kThreads) {
          const int toff = p & ~(tile_elems - 1);
          int a = ((p - toff) & ~(kLane - 1)) | (int)ix[p];
          if (rel) a = relayout_src(plan.rel[s], a);
          dst[padix(p)] = src[padix(toff + a)];
        }
        __syncthreads();
        cur ^= 1;
      }
    }
    const T* vals = cur ? buf1 : buf0;
    // each thread: its contiguous slice, in order
    const int per = (len + kThreads - 1) / kThreads;
    const int lo = min(tid * per, len), hi = min(lo + per, len);
    Runs<TAcc, OP> runs;
    runs.init();
    for (int p = lo; p < hi; ++p) {
      const int k = (int)ranks[base + p];
      if (k >= v_blk) continue;  // the sentinel: padding, carries nothing
      runs.add(k, load_as<TAcc>(vals + padix(p)), acc);
    }
    runs.finish();
    s_fk[tid] = runs.fk; s_fv[tid] = runs.fv;
    s_lk[tid] = runs.lk; s_lv[tid] = runs.lv; s_n[tid] = runs.n;
    __syncthreads();
    if (tid < 32) {
      Runs<TAcc, OP> lane_runs;
      lane_runs.init();
      constexpr int kPerLane = kThreads / 32;
      for (int j = tid * kPerLane; j < (tid + 1) * kPerLane; ++j)
        lane_runs.add_summary(s_fk[j], s_fv[j], s_lk[j], s_lv[j], s_n[j], acc);
      lane_runs.finish();
      Runs<TAcc, OP> all;
      all.init();
      for (int l = 0; l < 32; ++l) {
        const int fk = __shfl_sync(0xffffffffu, lane_runs.fk, l);
        const int lk = __shfl_sync(0xffffffffu, lane_runs.lk, l);
        const int n = __shfl_sync(0xffffffffu, lane_runs.n, l);
        const TAcc fv = __shfl_sync(0xffffffffu, lane_runs.fv, l);
        const TAcc lv = __shfl_sync(0xffffffffu, lane_runs.lv, l);
        if (tid == 0) all.add_summary(fk, fv, lk, lv, n, acc);
      }
      if (tid == 0) {
        all.finish();
        all.flush(acc);
      }
    }
    __syncthreads();
  }
  for (int v = tid; v < v_blk; v += kThreads) out[(long long)b * v_blk + v] = acc[v];
}

template <typename T, typename TAcc, int OP, typename I>
int launch(const void* x, const StepPlan& plan, const void* ranks, const int32_t* tile_block,
           int num_tiles, int tile_elems, int v_blk, int num_blocks, void* out,
           cudaStream_t stream) {
  static size_t attr_smem = 48 * 1024;  // per instantiation: the largest opted in
  const size_t smem = 2 * (size_t)kPadded * sizeof(T) + (size_t)v_blk * sizeof(TAcc) +
                      2 * (size_t)kThreads * sizeof(TAcc) + 3 * (size_t)kThreads * sizeof(int);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > attr_smem) {
    // the dynamic size alone: the kernel's static shared memory counts
    // against the same per-block limit
    const cudaError_t e = cudaFuncSetAttribute(
        mxreduce_kernel<T, TAcc, OP, I>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_smem = smem;
  }
  mxreduce_kernel<T, TAcc, OP, I><<<num_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), plan, static_cast<const I*>(ranks), tile_block, num_tiles,
      tile_elems, v_blk, static_cast<TAcc*>(out));
  return 0;
}

template <typename I>
int dispatch(const void* x, int kind, int op, const StepPlan& plan, const void* ranks,
             const int32_t* tile_block, int num_tiles, int tile_elems, int v_blk, int num_blocks,
             void* out, cudaStream_t s) {
  switch (kind * 3 + op) {
    case LUX_F32 * 3 + LUX_SUM:
      return launch<float, float, LUX_SUM, I>(x, plan, ranks, tile_block, num_tiles, tile_elems, v_blk, num_blocks, out, s);
    case LUX_F32 * 3 + LUX_MIN:
      return launch<float, float, LUX_MIN, I>(x, plan, ranks, tile_block, num_tiles, tile_elems, v_blk, num_blocks, out, s);
    case LUX_F32 * 3 + LUX_MAX:
      return launch<float, float, LUX_MAX, I>(x, plan, ranks, tile_block, num_tiles, tile_elems, v_blk, num_blocks, out, s);
    case LUX_I32 * 3 + LUX_SUM:
      return launch<int32_t, uint32_t, LUX_SUM, I>(x, plan, ranks, tile_block, num_tiles, tile_elems, v_blk, num_blocks, out, s);
    case LUX_I32 * 3 + LUX_MIN:
      return launch<int32_t, int32_t, LUX_MIN, I>(x, plan, ranks, tile_block, num_tiles, tile_elems, v_blk, num_blocks, out, s);
    case LUX_I32 * 3 + LUX_MAX:
      return launch<int32_t, int32_t, LUX_MAX, I>(x, plan, ranks, tile_block, num_tiles, tile_elems, v_blk, num_blocks, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (rows, 128) values of `kind` (LUX_F32 or LUX_I32) in the group's entry
// layout; idx: a host array of kMaxSteps device pointers to the (rows, 128)
// index tiles; desc: the host step table; ranks: (rows, 128) rank map of the
// final layout (v_blk = sentinel), same element size as the index tiles
// (isize 1 or 4); tile_block: (rows / block_rows,) nondecreasing output block
// of each tile.  out: (num_blocks * v_blk,) f32 for float sums, else the
// value type.  Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for a malformed call.
extern "C" int lux_mxreduce_pass_gather(const void* x, int kind, const void* const* idx,
                                        int isize, const int32_t* desc, const void* ranks,
                                        int rsize, const int32_t* tile_block, long long rows,
                                        int block_rows, int v_blk, int num_blocks, int op,
                                        void* out, void* stream) {
  StepPlan plan;
  const int tile_elems = block_rows * kLane;
  if (!parse_steps(desc, idx, &plan) || block_rows < 1 || rows < block_rows ||
      rows % block_rows != 0 || tile_elems > kChunk || (tile_elems & (tile_elems - 1)) != 0 ||
      v_blk < 1 || v_blk > 255 || num_blocks < 1 || rsize != isize || rows / block_rows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_tiles = (int)(rows / block_rows);
  int rc;
  if (isize == 1)
    rc = dispatch<uint8_t>(x, kind, op, plan, ranks, tile_block, num_tiles, tile_elems, v_blk, num_blocks, out, s);
  else if (isize == 4)
    rc = dispatch<int32_t>(x, kind, op, plan, ranks, tile_block, num_tiles, tile_elems, v_blk, num_blocks, out, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
