// The sorted-key segmented reduction shared by spmv_blockcsr and
// mxreduce_pass_gather.
//
// Both kernels reduce an array whose flat key (output index) never
// decreases once padding is set aside, so the array can be cut anywhere:
// each CTA takes one span, walks its threads' runs of equal key in
// registers and writes every run that closes inside the span; the span's
// first and last runs, which may continue into its neighbours, go to a
// summary in scratch; one folding CTA combines the summaries in span
// order.  Every combination has a fixed order, so results are
// deterministic, with no atomics.  Three launches on the caller's stream:
// runs_fill_kernel (every output starts as the neutral value, so keys no
// real slot touches come out neutral), the kernel's own span kernel, and
// runs_fold_kernel.  Runs accumulate in TAcc and are written as TOut
// (narrow: a bf16 min/max widened to f32 is stored back as bf16, exactly).
#pragma once

#include "lux_ops.cuh"

namespace {

constexpr int kFoldThreads = 1024;
constexpr int kFillThreads = 256;
constexpr int kFillMaxCtas = 1056;  // 8 CTAs of 256 threads on each of 132 SMs

// Write the complete run value v of key k.
template <typename TAcc, int OP, typename TOut>
__device__ __forceinline__ void put_run(TOut* __restrict__ out, int k, TAcc v) {
  out[k] = narrow<TOut>(Combine<TAcc, OP>::apply(Combine<TAcc, OP>::neutral(), v));
}

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
  template <typename TOut>
  __device__ void add(int k, TAcc v, TOut* out) {
    if (n > 0 && k == lk) { lv = Combine<TAcc, OP>::apply(lv, v); return; }
    if (n == 1) { fk = lk; fv = lv; }
    else if (n > 1) put_run<TAcc, OP>(out, lk, lv);
    lk = k; lv = v; ++n;
  }
  __device__ void finish() { if (n == 1) { fk = lk; fv = lv; } }
};

// The summary of slice a followed by slice b.  A run the two close — a's
// last and b's first, joined or not, unless it is the result's first or
// last run — is complete and is written to out.  Associative, so a fixed
// tree of these combinations is deterministic.
template <typename TAcc, int OP, typename TOut>
__device__ Runs<TAcc, OP> combine(const Runs<TAcc, OP>& a, const Runs<TAcc, OP>& b,
                                  TOut* __restrict__ out) {
  using C = Combine<TAcc, OP>;
  if (a.n == 0) return b;
  if (b.n == 0) return a;
  Runs<TAcc, OP> r = {a.fk, b.lk, a.n + b.n, a.fv, b.lv};
  if (a.lk == b.fk) {
    const TAcc joined = C::apply(a.lv, b.fv);
    r.n -= 1;
    if (a.n == 1) r.fv = joined;
    if (b.n == 1) r.lv = joined;
    if (a.n > 1 && b.n > 1) put_run<TAcc, OP>(out, a.lk, joined);
  } else {
    if (a.n > 1) put_run<TAcc, OP>(out, a.lk, a.lv);
    if (b.n > 1) put_run<TAcc, OP>(out, b.fk, b.fv);
  }
  return r;
}

// Combine the summaries of lanes [0, width) of a warp in a fixed tree;
// lane 0 returns the whole.  Every lane of the warp must call it.
template <typename TAcc, int OP, typename TOut>
__device__ Runs<TAcc, OP> warp_combine(Runs<TAcc, OP> s, int lane, int width,
                                       TOut* __restrict__ out) {
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

// Combine the summaries of every thread of the CTA in a fixed tree: each
// warp's lanes, then the warps' results in warp 0.  Thread 0 returns the
// whole.  Every thread of the CTA must call it (it holds a barrier), and
// the CTA's size must be a multiple of 32.
template <typename TAcc, int OP, typename TOut>
__device__ Runs<TAcc, OP> cta_combine(const Runs<TAcc, OP>& s, TOut* __restrict__ out) {
  __shared__ int w_fk[32], w_lk[32], w_n[32];
  __shared__ TAcc w_fv[32], w_lv[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const Runs<TAcc, OP> w = warp_combine(s, lane, 32, out);
  if (lane == 0) {
    w_fk[warp] = w.fk; w_fv[warp] = w.fv;
    w_lk[warp] = w.lk; w_lv[warp] = w.lv; w_n[warp] = w.n;
  }
  __syncthreads();
  Runs<TAcc, OP> all;
  all.init();
  if (warp == 0) {
    if (lane < warps) all = {w_fk[lane], w_lk[lane], w_n[lane], w_fv[lane], w_lv[lane]};
    all = warp_combine(all, lane, warps, out);
  }
  return all;
}

// The summary of span c in scratch: key[2c], key[2c + 1] (first and last
// run), n[c] (runs; 0 = only padding), val[2c], val[2c + 1].  20 bytes a
// span, every field 4 bytes wide.
constexpr int kPartBytes = 20;

template <typename TAcc>
struct Parts {
  static_assert(sizeof(TAcc) == 4, "span summaries hold 4-byte values");
  int* key;
  int* n;
  TAcc* val;
  __device__ Parts(void* scratch, int num_spans)
      : key(static_cast<int*>(scratch)),
        n(static_cast<int*>(scratch) + 2 * num_spans),
        val(reinterpret_cast<TAcc*>(static_cast<int*>(scratch) + 3 * num_spans)) {}
  template <int OP>
  __device__ void put(int c, const Runs<TAcc, OP>& s) {
    n[c] = s.n;
    key[2 * c] = s.fk; val[2 * c] = s.fv;
    key[2 * c + 1] = s.lk; val[2 * c + 1] = s.lv;
  }
  template <int OP>
  __device__ Runs<TAcc, OP> get(int c) const {
    return {key[2 * c], key[2 * c + 1], n[c], val[2 * c], val[2 * c + 1]};
  }
};

template <typename TAcc, int OP, typename TOut>
__global__ void __launch_bounds__(kFillThreads)
runs_fill_kernel(TOut* __restrict__ out, long long n) {
  const TOut neutral = narrow<TOut>(Combine<TAcc, OP>::neutral());
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = neutral;
}

// Fold the span summaries in span order, in one CTA: each thread combines
// a contiguous range of spans in order, then the threads' summaries are
// combined in a fixed tree (cta_combine).  Every run that crosses a span
// boundary closes in some combination and is written there; the whole
// array's first and last runs are written at the end.
template <typename TAcc, int OP, typename TOut>
__global__ void __launch_bounds__(kFoldThreads)
runs_fold_kernel(void* scratch, int num_spans, TOut* __restrict__ out) {
  const Parts<TAcc> parts(scratch, num_spans);
  const int tid = threadIdx.x;
  const int per = (num_spans + kFoldThreads - 1) / kFoldThreads;
  const int lo = min(tid * per, num_spans), hi = min(lo + per, num_spans);
  Runs<TAcc, OP> s;
  s.init();
  for (int c = lo; c < hi; ++c) s = combine(s, parts.template get<OP>(c), out);
  const Runs<TAcc, OP> all = cta_combine(s, out);
  if (tid == 0 && all.n > 0) {
    put_run<TAcc, OP>(out, all.fk, all.fv);
    if (all.n > 1) put_run<TAcc, OP>(out, all.lk, all.lv);
  }
}

// The fill launch: every output starts as the neutral value.
template <typename TAcc, int OP, typename TOut>
void launch_fill(TOut* out, long long n_out, cudaStream_t stream) {
  const long long ctas = (n_out + kFillThreads - 1) / kFillThreads;
  runs_fill_kernel<TAcc, OP, TOut><<<(unsigned)(ctas < kFillMaxCtas ? ctas : kFillMaxCtas),
                                     kFillThreads, 0, stream>>>(out, n_out);
}

}  // namespace
