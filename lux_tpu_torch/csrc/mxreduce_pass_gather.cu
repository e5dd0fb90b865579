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
// value, one index per step and one rank, and it writes the totals once:
// n2 * (esize + steps * isize + isize) + num_blocks * v_blk * osize bytes
// (osize 4, 2 for a bf16 min/max) — at
// the main path's plan (n2 = 2^25, f32, 2 steps of uint8) 203.5 MB, 0.061 ms
// over 3.35 TB/s.  The one-hot contraction would multiply the work by v_blk
// for nothing here.
//
// Design: one sorted-key segmented reduce over the whole array, balanced
// over the card.  Along the final layout the flat key
// tile_block[tile] * v_blk + rank never decreases once sentinel slots
// (rank == v_blk, padding that carries nothing) are set aside: each tile
// lies in one output block, a block's tiles are contiguous, and ranks never
// decrease within a block's span.  So the array can be cut at any tile
// boundary, whatever the blocks' sizes (an RMAT hub block holds 27 % of the
// tiles at scale 20).  Three launches on the caller's stream, the first and
// the last shared with spmv_blockcsr (lux_runs.cuh):
//   0. fill: every total starts as the reduce's neutral value, so keys no
//      real slot touches come out neutral;
//   1. chunks: one CTA of 512 threads per chunk of kChunk = 8,192 elements
//      (whole tiles; the last chunk may be short), two CTAs per SM.  The
//      chunk comes in with cp.async into a swizzled shared buffer; each
//      thread owns 16 consecutive positions, loads their indices and ranks
//      16 at a time (the ranks and its tile's block before the steps, so
//      their latency hides behind them), runs the group's steps in place
//      as fused_pass_gather does (lane tables included), and keeps the
//      final step's 16 values in registers.  It walks
//      them in order, combining runs of equal key: a run closed strictly
//      inside its slice is complete and is written straight to out[key].
//      The slices' summaries (run count, first and last run) are combined
//      in a fixed tree of warp shuffles, over the 32 lanes of each warp,
//      then over the 16 warps; runs closed there are complete too.  The chunk's first and last
//      runs may continue into its neighbours: they go to the summary (key
//      and value of each, and the run count) in scratch;
//   2. fold: one CTA combines the chunks' summaries in chunk order with the
//      same combination, in a fixed tree: a key that spans many chunks (a
//      hub's rank may span dozens) costs one combination a chunk, and the
//      combination that joins two pieces of a run writes it once it is
//      whole.
// Every combination has a fixed order, so results are deterministic, with
// no atomics.  Float sums accumulate in f32 (out f32); int32 sums wrap
// through uint32; min/max keep the type (NaN propagates like
// torch.minimum/maximum).  bf16 values move through the steps as raw
// 16-bit words (half the tile: 16 KB a chunk) and widen to f32 when the
// final step hands them to the runs: sums accumulate in f32 and come out
// f32, min/max compare the exact widening and come out bf16.
//
// The program's edge function is not in the kernel: the caller applies it
// to the entry layout beforehand (ops/expand.apply_fused), with the plan's
// weights laid out in that entry layout at plan time.  The steps only
// permute within a tile, so the values the runs see are the same.
#include "lux_runs.cuh"
#include "lux_shuffle.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = kThreads * kUnit;  // 8192 = ops/shuffle.MX_MAX_TILE_ELEMS

// A stepped element widened to the accumulation type: T is f32, int32, or
// the raw bits of a bf16 (uint16_t).
template <typename TAcc, typename T>
__device__ __forceinline__ TAcc widen(T v) {
  if constexpr (sizeof(T) == 2) return bf16_bits_to_float(v);
  else return static_cast<TAcc>(v);
}

template <typename T, typename TAcc, typename TOut, int OP, typename I>
__global__ void __launch_bounds__(kThreads, 2)
mx_chunk_kernel(const T* __restrict__ x, StepPlan plan, const I* __restrict__ ranks,
                const int32_t* __restrict__ tile_block, int num_tiles, int tile_elems,
                int v_blk, TOut* __restrict__ out, void* scratch, int num_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  __shared__ uint16_t lut[kMaxSteps * kLane];
  const int c = blockIdx.x;
  const int per_chunk = kChunk / tile_elems;
  const int t0 = c * per_chunk;
  const int len = min(per_chunk, num_tiles - t0) * tile_elems;
  const long long base = (long long)t0 * tile_elems;
  const int tid = threadIdx.x;
  const int p0 = tid * kUnit;
  const bool active = p0 < len;
  const int toff = p0 & ~(tile_elems - 1);
  const int row = (p0 - toff) & ~(kLane - 1);
  tile_load_async(x + base, tile, len);
  build_lane_luts<T>(plan, lut);
  Idx16<I> q, rk;
  int kbase = 0;
  if (active) {
    q.load(static_cast<const I*>(plan.idx[0]) + base + p0);
    rk.load(ranks + base + p0);
    kbase = tile_block[t0 + p0 / tile_elems] * v_blk;
  }
  cp_async_wait_all();
  __syncthreads();
  T v[kUnit];
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    if (s < plan.n_steps) {
      if (active) step_read16(tile, step_base<T>(plan, s, toff, row), lut + s * kLane, q, v);
      if (s + 1 < plan.n_steps) {
        if (active) q.load(static_cast<const I*>(plan.idx[s + 1 < kMaxSteps ? s + 1 : s]) + base + p0);
        __syncthreads();
        if (active) store16_tile(tile, p0, v);
        __syncthreads();
      }
    }
  }
  // the final layout's 16 values are in v: walk their runs in order
  Runs<TAcc, OP> runs;
  runs.init();
  if (active) {
#pragma unroll
    for (int j = 0; j < kUnit; ++j) {
      const int k = rk[j];
      if (k < v_blk) runs.add(kbase + k, widen<TAcc>(v[j]), out);
    }
  }
  runs.finish();
  const Runs<TAcc, OP> all = cta_combine(runs, out);
  if (tid == 0) Parts<TAcc>(scratch, num_chunks).put(c, all);
}

int num_chunks_of(int num_tiles, int tile_elems) {
  const int per_chunk = kChunk / tile_elems;
  return (num_tiles + per_chunk - 1) / per_chunk;
}

template <typename T, typename TAcc, typename TOut, int OP, typename I>
int launch(const void* x, const StepPlan& plan, const void* ranks, const int32_t* tile_block,
           int num_tiles, int tile_elems, int v_blk, int num_blocks, void* out, void* scratch,
           cudaStream_t stream) {
  const int num_chunks = num_chunks_of(num_tiles, tile_elems);
  TOut* o = static_cast<TOut*>(out);
  launch_fill<TAcc, OP>(o, (long long)num_blocks * v_blk, stream);
  mx_chunk_kernel<T, TAcc, TOut, OP, I><<<num_chunks, kThreads, kChunk * sizeof(T), stream>>>(
      static_cast<const T*>(x), plan, static_cast<const I*>(ranks), tile_block, num_tiles,
      tile_elems, v_blk, o, scratch, num_chunks);
  runs_fold_kernel<TAcc, OP, TOut><<<1, kFoldThreads, 0, stream>>>(scratch, num_chunks, o);
  return 0;
}

// The instantiation of (kind, op, I), handed to f as template arguments:
// the stepped element type, the accumulation type, the totals' type.
template <typename I, typename F>
int dispatch(int kind, int op, F&& f) {
  using BF = __nv_bfloat16;
  switch (kind * 3 + op) {
    case LUX_F32 * 3 + LUX_SUM: return f.template run<float, float, float, LUX_SUM, I>();
    case LUX_F32 * 3 + LUX_MIN: return f.template run<float, float, float, LUX_MIN, I>();
    case LUX_F32 * 3 + LUX_MAX: return f.template run<float, float, float, LUX_MAX, I>();
    case LUX_BF16 * 3 + LUX_SUM: return f.template run<uint16_t, float, float, LUX_SUM, I>();
    case LUX_BF16 * 3 + LUX_MIN: return f.template run<uint16_t, float, BF, LUX_MIN, I>();
    case LUX_BF16 * 3 + LUX_MAX: return f.template run<uint16_t, float, BF, LUX_MAX, I>();
    case LUX_I32 * 3 + LUX_SUM:
      return f.template run<int32_t, uint32_t, uint32_t, LUX_SUM, I>();
    case LUX_I32 * 3 + LUX_MIN: return f.template run<int32_t, int32_t, int32_t, LUX_MIN, I>();
    case LUX_I32 * 3 + LUX_MAX: return f.template run<int32_t, int32_t, int32_t, LUX_MAX, I>();
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int dispatch_index(int isize, int kind, int op, F&& f) {
  if (isize == 1) return dispatch<uint8_t>(kind, op, f);
  if (isize == 4) return dispatch<int32_t>(kind, op, f);
  return (int)cudaErrorInvalidValue;
}

struct Launch {
  const void* x;
  const StepPlan* plan;
  const void* ranks;
  const int32_t* tile_block;
  int num_tiles, tile_elems, v_blk, num_blocks;
  void* out;
  void* scratch;
  cudaStream_t stream;
  template <typename T, typename TAcc, typename TOut, int OP, typename I>
  int run() const {
    return launch<T, TAcc, TOut, OP, I>(x, *plan, ranks, tile_block, num_tiles, tile_elems,
                                        v_blk, num_blocks, out, scratch, stream);
  }
};

}  // namespace

// x: (rows, 128) values of `kind` (LUX_F32, LUX_BF16 or LUX_I32) in the
// group's entry layout; idx: a host array of kMaxSteps device pointers to the (rows, 128)
// index tiles; desc: the host step table; ranks: (rows, 128) rank map of the
// final layout (v_blk = sentinel), same element size as the index tiles
// (isize 1 or 4); tile_block: (rows / block_rows,) nondecreasing output block
// of each tile.  out: (num_blocks * v_blk,) f32 for float sums (bf16
// included), else the value type.  scratch: at least 20 * num_chunks bytes of device memory for
// the chunk summaries, num_chunks = ceil(tiles / (8192 / (block_rows *
// 128))) (ops/shuffle.mx_num_chunks).  Every array 16-byte aligned.
// Returns cudaGetLastError() after the launches (0 = launched);
// cudaErrorInvalidValue for a malformed call.
extern "C" int lux_mxreduce_pass_gather(const void* x, int kind, const void* const* idx,
                                        int isize, const int32_t* desc, const void* ranks,
                                        int rsize, const int32_t* tile_block, long long rows,
                                        int block_rows, int v_blk, int num_blocks, int op,
                                        void* out, void* scratch, long long scratch_bytes,
                                        void* stream) {
  StepPlan plan;
  const int tile_elems = block_rows * kLane;
  if (!parse_steps(desc, idx, &plan) || block_rows < 1 || rows < block_rows ||
      rows % block_rows != 0 || tile_elems > kChunk || (tile_elems & (tile_elems - 1)) != 0 ||
      v_blk < 1 || v_blk > 255 || num_blocks < 1 || rsize != isize ||
      rows / block_rows > INT32_MAX || (long long)num_blocks * v_blk > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int num_tiles = (int)(rows / block_rows);
  if (scratch_bytes < (long long)kPartBytes * num_chunks_of(num_tiles, tile_elems))
    return (int)cudaErrorInvalidValue;
  const Launch l{x, &plan, ranks, tile_block, num_tiles, tile_elems, v_blk, num_blocks, out,
                 scratch, static_cast<cudaStream_t>(stream)};
  const int rc = dispatch_index(isize, kind, op, l);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
