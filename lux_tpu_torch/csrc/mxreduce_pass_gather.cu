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
// n2 * (esize + steps * isize + isize) + num_blocks * v_blk * 4 bytes — at
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
// tiles at scale 20).  Three launches on the caller's stream:
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
// torch.minimum/maximum).
#include "lux_ops.cuh"
#include "lux_shuffle.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = kThreads * kUnit;  // 8192 = ops/shuffle.MX_MAX_TILE_ELEMS
constexpr int kWarps = kThreads / 32;
constexpr int kFoldThreads = 1024;
constexpr int kFillThreads = 256;

// Runs of equal key seen in order: the first run (kept, it may continue a
// run that began before), the open last run, and every run in between,
// which is complete when it closes and is written to out.  Once finished
// (n == 1: first == last) it summarises a slice: its run count, its first
// and its last run.
template <typename TAcc, int OP>
struct Runs {
  int fk, lk, n;
  TAcc fv, lv;
  __device__ void init() { fk = -1; lk = -1; n = 0; fv = Combine<TAcc, OP>::neutral(); lv = fv; }
  __device__ void add(int k, TAcc v, TAcc* out) {
    if (n > 0 && k == lk) { lv = Combine<TAcc, OP>::apply(lv, v); return; }
    if (n == 1) { fk = lk; fv = lv; }
    else if (n > 1) out[lk] = Combine<TAcc, OP>::apply(Combine<TAcc, OP>::neutral(), lv);
    lk = k; lv = v; ++n;
  }
  __device__ void finish() { if (n == 1) { fk = lk; fv = lv; } }
};

// The summary of slice a followed by slice b.  A run the two close — a's
// last and b's first, joined or not, unless it is the result's first or
// last run — is complete and is written to out.  Associative, so a fixed
// tree of these combinations is deterministic.
template <typename TAcc, int OP>
__device__ Runs<TAcc, OP> combine(const Runs<TAcc, OP>& a, const Runs<TAcc, OP>& b,
                                  TAcc* __restrict__ out) {
  using C = Combine<TAcc, OP>;
  if (a.n == 0) return b;
  if (b.n == 0) return a;
  Runs<TAcc, OP> r = {a.fk, b.lk, a.n + b.n, a.fv, b.lv};
  if (a.lk == b.fk) {
    const TAcc joined = C::apply(a.lv, b.fv);
    r.n -= 1;
    if (a.n == 1) r.fv = joined;
    if (b.n == 1) r.lv = joined;
    if (a.n > 1 && b.n > 1) out[a.lk] = C::apply(C::neutral(), joined);
  } else {
    if (a.n > 1) out[a.lk] = C::apply(C::neutral(), a.lv);
    if (b.n > 1) out[b.fk] = C::apply(C::neutral(), b.fv);
  }
  return r;
}

// Combine the summaries of lanes [0, width) of a warp in a fixed tree;
// lane 0 returns the whole.  Every lane of the warp must call it.
template <typename TAcc, int OP>
__device__ Runs<TAcc, OP> warp_combine(Runs<TAcc, OP> s, int lane, int width,
                                       TAcc* __restrict__ out) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Runs<TAcc, OP> b;
    b.fk = __shfl_down_sync(0xffffffffu, s.fk, off);
    b.lk = __shfl_down_sync(0xffffffffu, s.lk, off);
    b.n = __shfl_down_sync(0xffffffffu, s.n, off);
    b.fv = __shfl_down_sync(0xffffffffu, s.fv, off);
    b.lv = __shfl_down_sync(0xffffffffu, s.lv, off);
    if ((lane & (2 * off - 1)) == 0 && lane + off < width) s = combine(s, b, out);
  }
  return s;
}

// The summary of chunk c in scratch: key[2c], key[2c + 1] (first and last
// run), n[c] (runs; 0 = only sentinel slots), val[2c], val[2c + 1].
template <typename TAcc>
struct Parts {
  int* key;
  int* n;
  TAcc* val;
  __device__ Parts(void* scratch, int num_chunks)
      : key(static_cast<int*>(scratch)),
        n(static_cast<int*>(scratch) + 2 * num_chunks),
        val(reinterpret_cast<TAcc*>(static_cast<int*>(scratch) + 3 * num_chunks)) {}
};

template <typename TAcc, int OP>
__global__ void __launch_bounds__(kFillThreads)
mx_fill_kernel(TAcc* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = Combine<TAcc, OP>::neutral();
}

template <typename T, typename TAcc, int OP, typename I>
__global__ void __launch_bounds__(kThreads, 2)
mx_chunk_kernel(const T* __restrict__ x, StepPlan plan, const I* __restrict__ ranks,
                const int32_t* __restrict__ tile_block, int num_tiles, int tile_elems,
                int v_blk, TAcc* __restrict__ out, void* scratch, int num_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  __shared__ uint16_t lut[kMaxSteps * kLane];
  __shared__ int w_fk[kWarps], w_lk[kWarps], w_n[kWarps];
  __shared__ TAcc w_fv[kWarps], w_lv[kWarps];
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
      if (k < v_blk) runs.add(kbase + k, static_cast<TAcc>(v[j]), out);
    }
  }
  runs.finish();
  const int lane = tid & 31, warp = tid >> 5;
  const Runs<TAcc, OP> w = warp_combine(runs, lane, 32, out);
  if (lane == 0) {
    w_fk[warp] = w.fk; w_fv[warp] = w.fv;
    w_lk[warp] = w.lk; w_lv[warp] = w.lv; w_n[warp] = w.n;
  }
  __syncthreads();
  if (warp == 0) {
    Runs<TAcc, OP> s;
    s.init();
    if (lane < kWarps) s = {w_fk[lane], w_lk[lane], w_n[lane], w_fv[lane], w_lv[lane]};
    const Runs<TAcc, OP> all = warp_combine(s, lane, kWarps, out);
    if (lane == 0) {
      Parts<TAcc> parts(scratch, num_chunks);
      parts.n[c] = all.n;
      parts.key[2 * c] = all.fk; parts.val[2 * c] = all.fv;
      parts.key[2 * c + 1] = all.lk; parts.val[2 * c + 1] = all.lv;
    }
  }
}

// Fold the chunk summaries in chunk order, in one CTA: each thread
// combines a contiguous range of chunks in order, then the threads'
// summaries are combined in a fixed tree (warps, then the warps' results).
// Every run that crosses a chunk boundary closes in some combination and is
// written there; the whole array's first and last runs are written at the
// end.
template <typename TAcc, int OP>
__global__ void __launch_bounds__(kFoldThreads)
mx_fold_kernel(void* scratch, int num_chunks, TAcc* __restrict__ out) {
  using C = Combine<TAcc, OP>;
  __shared__ int w_fk[32], w_lk[32], w_n[32];
  __shared__ TAcc w_fv[32], w_lv[32];
  const Parts<TAcc> parts(scratch, num_chunks);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (num_chunks + kFoldThreads - 1) / kFoldThreads;
  const int lo = min(tid * per, num_chunks), hi = min(lo + per, num_chunks);
  Runs<TAcc, OP> s;
  s.init();
  for (int c = lo; c < hi; ++c) {
    const Runs<TAcc, OP> b = {parts.key[2 * c], parts.key[2 * c + 1], parts.n[c],
                              parts.val[2 * c], parts.val[2 * c + 1]};
    s = combine(s, b, out);
  }
  const Runs<TAcc, OP> w = warp_combine(s, lane, 32, out);
  if (lane == 0) {
    w_fk[warp] = w.fk; w_fv[warp] = w.fv;
    w_lk[warp] = w.lk; w_lv[warp] = w.lv; w_n[warp] = w.n;
  }
  __syncthreads();
  if (warp == 0) {
    Runs<TAcc, OP> t;
    t.init();
    if (lane < kFoldThreads / 32) t = {w_fk[lane], w_lk[lane], w_n[lane], w_fv[lane], w_lv[lane]};
    const Runs<TAcc, OP> all = warp_combine(t, lane, kFoldThreads / 32, out);
    if (lane == 0 && all.n > 0) {
      out[all.fk] = C::apply(C::neutral(), all.fv);
      if (all.n > 1) out[all.lk] = C::apply(C::neutral(), all.lv);
    }
  }
}

int num_chunks_of(int num_tiles, int tile_elems) {
  const int per_chunk = kChunk / tile_elems;
  return (num_tiles + per_chunk - 1) / per_chunk;
}

template <typename T, typename TAcc, int OP, typename I>
int launch(const void* x, const StepPlan& plan, const void* ranks, const int32_t* tile_block,
           int num_tiles, int tile_elems, int v_blk, int num_blocks, void* out, void* scratch,
           cudaStream_t stream) {
  const int num_chunks = num_chunks_of(num_tiles, tile_elems);
  TAcc* o = static_cast<TAcc*>(out);
  const long long n_out = (long long)num_blocks * v_blk;
  const long long fill_ctas = (n_out + kFillThreads - 1) / kFillThreads;
  mx_fill_kernel<TAcc, OP><<<(unsigned)(fill_ctas < 1056 ? fill_ctas : 1056), kFillThreads, 0,
                             stream>>>(o, n_out);
  mx_chunk_kernel<T, TAcc, OP, I><<<num_chunks, kThreads, kChunk * sizeof(T), stream>>>(
      static_cast<const T*>(x), plan, static_cast<const I*>(ranks), tile_block, num_tiles,
      tile_elems, v_blk, o, scratch, num_chunks);
  mx_fold_kernel<TAcc, OP><<<1, kFoldThreads, 0, stream>>>(scratch, num_chunks, o);
  return 0;
}

// The instantiation of (kind, op, I), handed to f as template arguments.
template <typename I, typename F>
int dispatch(int kind, int op, F&& f) {
  switch (kind * 3 + op) {
    case LUX_F32 * 3 + LUX_SUM: return f.template run<float, float, LUX_SUM, I>();
    case LUX_F32 * 3 + LUX_MIN: return f.template run<float, float, LUX_MIN, I>();
    case LUX_F32 * 3 + LUX_MAX: return f.template run<float, float, LUX_MAX, I>();
    case LUX_I32 * 3 + LUX_SUM: return f.template run<int32_t, uint32_t, LUX_SUM, I>();
    case LUX_I32 * 3 + LUX_MIN: return f.template run<int32_t, int32_t, LUX_MIN, I>();
    case LUX_I32 * 3 + LUX_MAX: return f.template run<int32_t, int32_t, LUX_MAX, I>();
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
  template <typename T, typename TAcc, int OP, typename I>
  int run() const {
    return launch<T, TAcc, OP, I>(x, *plan, ranks, tile_block, num_tiles, tile_elems, v_blk,
                                  num_blocks, out, scratch, stream);
  }
};

}  // namespace

// x: (rows, 128) values of `kind` (LUX_F32 or LUX_I32) in the group's entry
// layout; idx: a host array of kMaxSteps device pointers to the (rows, 128)
// index tiles; desc: the host step table; ranks: (rows, 128) rank map of the
// final layout (v_blk = sentinel), same element size as the index tiles
// (isize 1 or 4); tile_block: (rows / block_rows,) nondecreasing output block
// of each tile.  out: (num_blocks * v_blk,) f32 for float sums, else the
// value type.  scratch: at least 20 * num_chunks bytes of device memory for
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
  if (scratch_bytes < 20LL * num_chunks_of(num_tiles, tile_elems))
    return (int)cudaErrorInvalidValue;
  const Launch l{x, &plan, ranks, tile_block, num_tiles, tile_elems, v_blk, num_blocks, out,
                 scratch, static_cast<cudaStream_t>(stream)};
  const int rc = dispatch_index(isize, kind, op, l);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
