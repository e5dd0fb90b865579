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
// path: slots >= row_ptr[-1]) instead of being read.  At the main path's
// 2^24 slots that is 151 MB, 0.045 ms.  The arithmetic is one combine per
// element; what a scan can waste is instructions a byte, so the design
// keeps the per-element work in registers and the shuffles per thread,
// not per element.  The triangular matmul is a TPU idiom (the MXU is its
// fast unit); the grid here runs in parallel, so the TPU's carried scratch
// offset becomes explicit passes:
//   1. scan_tiles: one CTA of 512 threads per tile of kTile = 8,192
//      elements.  Each thread owns 16 consecutive elements: four 16-byte
//      loads of values and one of the 16 head bytes (and one of `invalid`
//      bytes where given).  It scans them serially in registers, restarting
//      at heads.  One segmented shuffle scan over the warp's 32 thread
//      aggregates and one over the CTA's 16 warp aggregates (in shared
//      memory) give each thread its exclusive prefix, which it folds into
//      its elements before its first head; it writes its 16 outputs with
//      four 16-byte stores.  Thread 0 writes the tile aggregate (the value
//      of the segment still open at its end, and whether the tile holds a
//      head) and the position of the tile's first head.
//   2. scan_carries: one CTA scans the tile aggregates (a segmented scan
//      again) and writes each tile's carry-in.
//   3. apply_carries: one CTA per tile combines its carry-in into the
//      elements before its first head, the only ones pass 1 could not
//      finish (on a tile with no head, all of them).  A bf16 sum cannot
//      take its pass-1 output there (that is the tile-local sum already
//      rounded to bf16; adding the carry and rounding again would round
//      twice), so its pass 3 is scan_tiles again in carry mode: the tile
//      rescans its values before its first head in f32, adds its f32
//      carry-in, and rounds each sum once.
// Every pass has a fixed combine order, so results are deterministic.
// Invalid slots are replaced by the neutral element before any arithmetic
// (their outputs are unspecified, as in the reference); float sums
// accumulate in f32 through every pass (tile sums, carries, carry-in), so
// a bf16 sum is rounded to bf16 once, on its way out; int32 sums wrap
// (uint32 arithmetic); min/max are order-insensitive, so they match the
// plain ladder scan bitwise (bf16 compares its exact f32 widening).  An
// array whose base is not 16-byte aligned, and the last thread's elements
// past the end, take scalar loads and stores.  A bf16 element is 2 bytes,
// so bf16 moves n * 5 bytes where f32 moves n * 9.
//
// Supported: f32, bf16 and int32 values for sum, min and max.
#include "lux_ops.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kUnit;  // 8192 elements, one CTA
constexpr int kCarryThreads = 1024;
constexpr int kApplyThreads = 256;

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

// The exclusive prefix of each thread of the CTA, from the threads'
// aggregates (x, f): the combine of every earlier thread's elements back to
// the last head among them.  The tile's own
// aggregate is left in s_val[kWarps - 1], s_flag[kWarps - 1].  Every thread
// must call it (it holds barriers).
template <typename T, int OP>
__device__ __forceinline__ T cta_exclusive(T x, int f, T* s_val, int* s_flag) {
  using C = Combine<T, OP>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_seg_scan<T, OP>(x, f, lane);
  if (lane == 31) { s_val[warp] = x; s_flag[warp] = f; }
  T wx = __shfl_up_sync(kFull, x, 1);
  int wf = __shfl_up_sync(kFull, f, 1);
  if (lane == 0) { wx = C::neutral(); wf = 0; }
  __syncthreads();
  if (warp == 0) {
    T a = lane < kWarps ? s_val[lane] : C::neutral();
    int af = lane < kWarps ? s_flag[lane] : 0;
    warp_seg_scan<T, OP>(a, af, lane);
    if (lane < kWarps) { s_val[lane] = a; s_flag[lane] = af; }
  }
  __syncthreads();
  const T wp = warp > 0 ? s_val[warp - 1] : C::neutral();
  return wf ? wx : C::apply(wp, wx);
}

template <typename TIn, typename T>
__device__ __forceinline__ void store16_as(TIn* __restrict__ p, const T (&v)[kUnit]) {
  if constexpr (sizeof(TIn) == 2) {  // bf16 from f32: two 16-byte stores
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = float_to_bf16_bits(v[8 * m + 2 * e]) |
               (float_to_bf16_bits(v[8 * m + 2 * e + 1]) << 16);
      reinterpret_cast<uint4*>(p)[m] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    uint4 w;
    if constexpr (std::is_floating_point<T>::value)
      w = make_uint4(__float_as_uint(v[4 * m]), __float_as_uint(v[4 * m + 1]),
                     __float_as_uint(v[4 * m + 2]), __float_as_uint(v[4 * m + 3]));
    else
      w = make_uint4((uint32_t)v[4 * m], (uint32_t)v[4 * m + 1], (uint32_t)v[4 * m + 2],
                     (uint32_t)v[4 * m + 3]);
    reinterpret_cast<uint4*>(p)[m] = w;
  }
}

// CARRY = false: pass 1.  CARRY = true: pass 3 of a bf16 sum: the CTA
// takes tile blockIdx.x + 1, loads only the elements before the tile's
// first head (limit), scans them as pass 1 did, and writes each one as its
// carry-in plus its f32 tile-local sum, rounded once.
template <typename TIn, typename T, int OP, bool CARRY>
__global__ void __launch_bounds__(kThreads, 2)
scan_tiles(const TIn* __restrict__ vals, const uint8_t* __restrict__ head,
           const uint8_t* __restrict__ invalid, const int32_t* __restrict__ valid_end,
           long long n, bool vec, TIn* __restrict__ out, T* __restrict__ agg_val,
           int32_t* __restrict__ agg_head, int32_t* __restrict__ first_head,
           const T* __restrict__ carry_in) {
  using C = Combine<T, OP>;
  __shared__ T s_val[kWarps];
  __shared__ int s_flag[kWarps];
  __shared__ int s_first[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile = CARRY ? blockIdx.x + 1LL : blockIdx.x;
  const int limit = CARRY ? first_head[tile] : kTile;
  if (limit == 0) return;  // the whole CTA: pass 1 finished this tile
  const long long p0 = tile * kTile + (long long)tid * kUnit;
  const long long vend = valid_end ? (long long)__ldg(valid_end) : n;
  const long long nn = CARRY && tid * kUnit >= limit ? p0 : n;  // past limit: load nothing
  const bool full = vec && p0 + kUnit <= nn;
  T v[kUnit];
  unsigned hm = 0, bad = 0;  // bit j: element j is a head / is invalid
  if (full) {
    load16_as(vals + p0, v);
    Idx16<uint8_t> h;
    h.load(head + p0);
#pragma unroll
    for (int j = 0; j < kUnit; ++j) hm |= (h[j] != 0) << j;
    if (invalid) {
      Idx16<uint8_t> b;
      b.load(invalid + p0);
#pragma unroll
      for (int j = 0; j < kUnit; ++j) bad |= (b[j] != 0) << j;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kUnit; ++j) {
      const long long i = p0 + j;
      const bool in = i < nn;
      v[j] = in ? load_as<T>(vals + i) : C::neutral();
      hm |= (in && head[i] != 0) << j;
      bad |= (!in || (invalid && invalid[i] != 0)) << j;
    }
  }
  // serial segmented scan of the thread's 16 elements, invalid ones neutral
  T acc = C::neutral();
#pragma unroll
  for (int j = 0; j < kUnit; ++j) {
    const T x = (p0 + j < vend && !((bad >> j) & 1)) ? v[j] : C::neutral();
    acc = ((hm >> j) & 1) ? x : C::apply(acc, x);
    v[j] = acc;
  }
  const int fh = hm ? __ffs(hm) - 1 : kUnit;  // the thread's first head
  // the first head of each warp, then of the tile
  const unsigned with_head = __ballot_sync(kFull, hm != 0);
  const int first_lane = with_head ? __ffs(with_head) - 1 : 0;
  const int lfh = __shfl_sync(kFull, fh, first_lane);
  if (lane == 0) s_first[warp] = with_head ? (warp * 32 + first_lane) * kUnit + lfh : kTile;
  const T px = cta_exclusive<T, OP>(acc, hm != 0, s_val, s_flag);
  if (tid > 0) {  // thread 0's prefix is empty
#pragma unroll
    for (int j = 0; j < kUnit; ++j)
      if (j < fh) v[j] = C::apply(px, v[j]);
  }
  if constexpr (CARRY) {  // every element before the first head: carry + v
    const T c = carry_in[tile];
#pragma unroll
    for (int j = 0; j < kUnit; ++j) v[j] = C::apply(c, v[j]);
    if (full && tid * kUnit + kUnit <= limit) {
      store16_as(out + p0, v);
    } else {
#pragma unroll
      for (int j = 0; j < kUnit; ++j)
        if (tid * kUnit + j < limit && p0 + j < n) out[p0 + j] = narrow<TIn>(v[j]);
    }
    return;
  }
  if (full) {
    store16_as(out + p0, v);
  } else {
#pragma unroll
    for (int j = 0; j < kUnit; ++j)
      if (p0 + j < n) out[p0 + j] = narrow<TIn>(v[j]);
  }
  if (tid == 0) {
    int first = kTile;
    for (int w = 0; w < kWarps; ++w) first = min(first, s_first[w]);
    agg_val[tile] = s_val[kWarps - 1];
    agg_head[tile] = s_flag[kWarps - 1];
    first_head[tile] = first;
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
__global__ void __launch_bounds__(kApplyThreads)
apply_carries(TIn* __restrict__ out, long long n, const T* __restrict__ carry_in,
              const int32_t* __restrict__ first_head) {
  using C = Combine<T, OP>;
  const long long tile = (long long)blockIdx.x + 1;  // tile 0 has nothing before it
  const T c = carry_in[tile];
  const long long base = tile * kTile;
  const long long end = min(n, base + first_head[tile]);
  for (long long i = base + threadIdx.x; i < end; i += kApplyThreads)
    out[i] = narrow<TIn>(C::apply(c, load_as<T>(out + i)));
}

template <typename TIn, typename T, int OP>
void launch(const void* vals, const void* head, const void* invalid, const void* valid_end,
            long long n, void* out, void* scratch, cudaStream_t stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  T* agg_val = static_cast<T*>(scratch);
  int32_t* agg_head = reinterpret_cast<int32_t*>(agg_val + ntiles);
  int32_t* first_head = agg_head + ntiles;
  T* carry_in = reinterpret_cast<T*>(first_head + ntiles);
  const bool vec = ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(head) |
                     reinterpret_cast<uintptr_t>(invalid) | reinterpret_cast<uintptr_t>(out)) &
                    15) == 0;
  const TIn* v = static_cast<const TIn*>(vals);
  const uint8_t* h = static_cast<const uint8_t*>(head);
  const uint8_t* bad = static_cast<const uint8_t*>(invalid);
  const int32_t* ve = static_cast<const int32_t*>(valid_end);
  TIn* o = static_cast<TIn*>(out);
  scan_tiles<TIn, T, OP, false><<<(unsigned)ntiles, kThreads, 0, stream>>>(
      v, h, bad, ve, n, vec, o, agg_val, agg_head, first_head, nullptr);
  if (ntiles < 2) return;  // one tile: pass 1 finished it
  scan_carries<T, OP><<<1, kCarryThreads, 0, stream>>>(agg_val, agg_head, ntiles, carry_in);
  if constexpr (OP == LUX_SUM && sizeof(TIn) < sizeof(T)) {  // a bf16 sum: round once
    scan_tiles<TIn, T, OP, true><<<(unsigned)(ntiles - 1), kThreads, 0, stream>>>(
        v, h, bad, ve, n, vec, o, nullptr, nullptr, first_head, carry_in);
  } else {
    apply_carries<TIn, T, OP><<<(unsigned)(ntiles - 1), kApplyThreads, 0, stream>>>(
        o, n, carry_in, first_head);
  }
}

}  // namespace

// Elements per pass-1 tile; the wrapper sizes the scratch buffer as
// 4 words of 4 bytes per tile.
extern "C" int lux_mxscan_tile_elems() { return kTile; }

// vals/out: n elements of `kind` (f32, bf16 or int32); head: n bytes (0/1);
// invalid: n bytes or null; valid_end: one device int32 or null (slots at or
// past it are invalid).  Returns cudaGetLastError() after the launches; an
// unsupported (kind, op) pair or n outside [1, 2^31 * 8192) returns
// cudaErrorInvalidValue.
extern "C" int lux_mxscan_segmented(const void* vals, int kind, const void* head,
                                    const void* invalid, const void* valid_end, long long n,
                                    int op, void* out, void* scratch, void* stream) {
  if (n <= 0 || (n + kTile - 1) / kTile > INT32_MAX) return (int)cudaErrorInvalidValue;
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
    case LUX_BF16 * 3 + LUX_SUM:
      launch<__nv_bfloat16, float, LUX_SUM>(vals, head, invalid, valid_end, n, out, scratch, s);
      break;
    case LUX_BF16 * 3 + LUX_MIN:
      launch<__nv_bfloat16, float, LUX_MIN>(vals, head, invalid, valid_end, n, out, scratch, s);
      break;
    case LUX_BF16 * 3 + LUX_MAX:
      launch<__nv_bfloat16, float, LUX_MAX>(vals, head, invalid, valid_end, n, out, scratch, s);
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
