// Segmented inclusive scan with restarts at head flags, for sm_90a.
//
// Replaces: lux_tpu/ops/pallas_scan.py mxscan_segmented (kernel body
// _scan_kernel), the TPU blocked scan that computes each 128-lane row's
// prefix as a head-masked triangular MXU matmul and carries one offset
// through the sequential grid.
//
// What bounds it on the H100: memory.  Per element it must read 4 bytes
// of value and 1 byte of head flag and write 4 bytes; `invalid` is
// computed from a device-side end index where the caller has one (the csc
// path: slots >= row_ptr[-1]) instead of being read.  The arithmetic is a
// handful of shuffles and one combine per element, far below the bytes.
// The triangular matmul is a TPU idiom (the MXU is its fast unit); here a
// warp shuffle scan is the natural unit, and the grid runs in parallel, so
// the TPU's carried scratch offset becomes explicit passes:
//   1. scan_tiles: one warp per tile of kTile elements.  The warp walks
//      its tile in steps of 32 x kItems coalesced elements, scans each
//      32-element row with a segmented shuffle scan, and folds the running
//      carry into the lanes before the row's first head.  It writes the
//      tile-local scan, the tile aggregate (the value of the segment still
//      open at its end, and whether the tile holds a head) and the
//      position of the tile's first head.
//   2. scan_carries: one CTA scans the tile aggregates (a segmented scan
//      again) and writes each tile's carry-in.
//   3. apply_carries: each tile combines its carry-in into the elements
//      before its first head, the only ones pass 1 could not finish.
// Every pass has a fixed combine order, so results are deterministic.
// Invalid slots are replaced by the neutral element before any arithmetic
// (their outputs are unspecified, as in the reference); float sums
// accumulate in f32; int32 sums wrap (uint32 arithmetic); min/max are
// order-insensitive, so they match the plain ladder scan bitwise.
//
// Supported: f32 and int32 values for sum, min and max.
#include "lux_ops.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kItems = 4;                     // elements per lane per step
constexpr int kSteps = 16;                    // steps per tile
constexpr int kTile = 32 * kItems * kSteps;   // 2048 elements, one warp
constexpr int kWarpsPerCta = 8;
constexpr int kCarryThreads = 1024;

template <typename TOut, typename T> __device__ __forceinline__ TOut store_as(T x) {
  return static_cast<TOut>(x);
}

// Inclusive segmented scan across the warp: (x, f) becomes the combine of
// lanes 0..lane, restarting at the last lane whose flag is set.
template <typename T, int OP>
__device__ __forceinline__ void warp_seg_scan(T& x, int& f, int lane) {
  using C = Combine<T, OP>;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(kFull, x, off);
    const int yf = __shfl_up_sync(kFull, f, off);
    if (lane >= off) {
      if (!f) x = C::apply(y, x);
      f |= yf;
    }
  }
}

template <typename TIn, typename T, int OP>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
scan_tiles(const TIn* __restrict__ vals, const uint8_t* __restrict__ head,
           const uint8_t* __restrict__ invalid, const int32_t* __restrict__ valid_end,
           long long n, long long ntiles, TIn* __restrict__ out, T* __restrict__ agg_val,
           int32_t* __restrict__ agg_head, int32_t* __restrict__ first_head) {
  using C = Combine<T, OP>;
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (tile >= ntiles) return;
  const long long vend = valid_end ? (long long)*valid_end : n;
  const long long base = tile * kTile;
  T carry = C::neutral();
  int fh = kTile;
  for (int step = 0; step < kSteps; ++step) {
    if (base + (long long)step * kItems * 32 >= n) break;  // uniform per warp
    T v[kItems];
    int f[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + (step * kItems + k) * 32 + lane;
      const bool in = i < n;
      const bool ok = in && i < vend && !(invalid && invalid[i]);
      v[k] = ok ? load_as<T>(vals + i) : C::neutral();
      f[k] = in ? (head[i] != 0) : 0;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int rel0 = (step * kItems + k) * 32;
      const unsigned heads = __ballot_sync(kFull, f[k]);
      if (heads && fh == kTile) fh = rel0 + __ffs(heads) - 1;
      T x = v[k];
      int fl = f[k];
      warp_seg_scan<T, OP>(x, fl, lane);
      if (!fl) x = C::apply(carry, x);
      const long long i = base + rel0 + lane;
      if (i < n) out[i] = store_as<TIn>(x);
      carry = __shfl_sync(kFull, x, 31);
    }
  }
  if (lane == 0) {
    agg_val[tile] = carry;
    agg_head[tile] = fh < kTile;
    first_head[tile] = fh;
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kCarryThreads)
scan_carries(const T* __restrict__ agg_val, const int32_t* __restrict__ agg_head,
             long long ntiles, T* __restrict__ carry_in) {
  using C = Combine<T, OP>;
  __shared__ T s_val[32];
  __shared__ int s_flag[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = blockDim.x >> 5;
  const long long per = (ntiles + blockDim.x - 1) / blockDim.x;
  const long long lo = min(ntiles, (long long)t * per);
  const long long hi = min(ntiles, lo + per);
  // this thread's run of tiles, combined in order
  T x = C::neutral();
  int f = 0;
  for (long long j = lo; j < hi; ++j) {
    if (agg_head[j]) { x = agg_val[j]; f = 1; } else { x = C::apply(x, agg_val[j]); }
  }
  warp_seg_scan<T, OP>(x, f, lane);
  if (lane == 31) { s_val[warp] = x; s_flag[warp] = f; }
  __syncthreads();
  if (warp == 0) {
    T a = lane < nw ? s_val[lane] : C::neutral();
    int af = lane < nw ? s_flag[lane] : 0;
    warp_seg_scan<T, OP>(a, af, lane);
    s_val[lane] = a;
    s_flag[lane] = af;
  }
  __syncthreads();
  // exclusive prefix of this thread's run = (warps before) then (lanes before)
  T px = __shfl_up_sync(kFull, x, 1);
  int pf = __shfl_up_sync(kFull, f, 1);
  if (lane == 0) { px = C::neutral(); pf = 0; }
  const T wp = warp > 0 ? s_val[warp - 1] : C::neutral();
  T run = pf ? px : C::apply(wp, px);
  for (long long j = lo; j < hi; ++j) {
    carry_in[j] = run;
    run = agg_head[j] ? agg_val[j] : C::apply(run, agg_val[j]);
  }
}

template <typename TIn, typename T, int OP>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
apply_carries(TIn* __restrict__ out, long long n, long long ntiles, const T* __restrict__ carry_in,
              const int32_t* __restrict__ first_head) {
  using C = Combine<T, OP>;
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (tile == 0 || tile >= ntiles) return;
  const T c = carry_in[tile];
  const long long base = tile * kTile;
  const long long end = min(n, base + first_head[tile]);
  for (long long i = base + lane; i < end; i += 32)
    out[i] = store_as<TIn>(C::apply(c, load_as<T>(out + i)));
}

template <typename TIn, typename T, int OP>
void launch(const void* vals, const void* head, const void* invalid, const void* valid_end,
            long long n, void* out, void* scratch, cudaStream_t stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  T* agg_val = static_cast<T*>(scratch);
  int32_t* agg_head = reinterpret_cast<int32_t*>(agg_val + ntiles);
  int32_t* first_head = agg_head + ntiles;
  T* carry_in = reinterpret_cast<T*>(first_head + ntiles);
  const unsigned grid = (unsigned)((ntiles + kWarpsPerCta - 1) / kWarpsPerCta);
  scan_tiles<TIn, T, OP><<<grid, 32 * kWarpsPerCta, 0, stream>>>(
      static_cast<const TIn*>(vals), static_cast<const uint8_t*>(head),
      static_cast<const uint8_t*>(invalid), static_cast<const int32_t*>(valid_end), n, ntiles,
      static_cast<TIn*>(out), agg_val, agg_head, first_head);
  scan_carries<T, OP><<<1, kCarryThreads, 0, stream>>>(agg_val, agg_head, ntiles, carry_in);
  apply_carries<TIn, T, OP><<<grid, 32 * kWarpsPerCta, 0, stream>>>(
      static_cast<TIn*>(out), n, ntiles, carry_in, first_head);
}

}  // namespace

// Elements per pass-1 tile; the wrapper sizes the scratch buffer as
// 4 words of 4 bytes per tile.
extern "C" int lux_mxscan_tile_elems() { return kTile; }

// vals/out: n elements of `kind` (f32 or int32); head: n bytes (0/1);
// invalid: n bytes or null; valid_end: one device int32 or null (slots at or
// past it are invalid).  Returns cudaGetLastError() after the three
// launches; an unsupported (kind, op) pair returns cudaErrorInvalidValue.
extern "C" int lux_mxscan_segmented(const void* vals, int kind, const void* head,
                                    const void* invalid, const void* valid_end, long long n,
                                    int op, void* out, void* scratch, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind * 3 + op) {
    case LUX_F32 * 3 + LUX_SUM:
      launch<float, float, LUX_SUM>(vals, head, invalid, valid_end, n, out, scratch, s);
      break;
    case LUX_F32 * 3 + LUX_MIN:
      launch<float, float, LUX_MIN>(vals, head, invalid, valid_end, n, out, scratch, s);
      break;
    case LUX_F32 * 3 + LUX_MAX:
      launch<float, float, LUX_MAX>(vals, head, invalid, valid_end, n, out, scratch, s);
      break;
    case LUX_I32 * 3 + LUX_SUM:
      launch<int32_t, uint32_t, LUX_SUM>(vals, head, invalid, valid_end, n, out, scratch, s);
      break;
    case LUX_I32 * 3 + LUX_MIN:
      launch<int32_t, int32_t, LUX_MIN>(vals, head, invalid, valid_end, n, out, scratch, s);
      break;
    case LUX_I32 * 3 + LUX_MAX:
      launch<int32_t, int32_t, LUX_MAX>(vals, head, invalid, valid_end, n, out, scratch, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
