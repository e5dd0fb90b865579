// Deterministic float sum by a sorted key, for sm_90a.
//
// Replaces no TPU kernel.  It is the port's counterpart of XLA's sorted
// segment_sum (lux_tpu/ops/segment.py:172-176, `jax.ops.segment_sum(...,
// indices_are_sorted=True)` under method "scatter"), which XLA lowers to a
// reduction with a fixed order.  It was added because CUDA's index_add_
// adds floats with atomics whose order changes from run to run, so the
// scatter method's sums did not repeat bitwise on the card.
//
// out[k, c] = sum of vals[e, c] over the slots e with key[e] == k, for
// f32 values (E,) or (E, K); key is int32 and, once the padding sentinel
// (any key outside [0, num_segments)) is set aside, never decreases along
// the array (every layout of the port keeps its destinations so: a CPU
// test pins it, and the CPU wrapper checks it on every call).  Keys no
// slot holds come out 0.  Every combination has a fixed order and no
// atomics, so two runs are bitwise equal.
//
// What bounds it on the H100: memory.  It reads E*K*4 bytes of values and
// E*4 of keys and writes num_segments*K*4; one add per value, so at 3.35
// TB/s and 67 TFLOP/s (f32) the bytes dominate by two orders of magnitude.
//
// Design, (E,): the sorted-key run machinery of lux_runs.cuh, as kernels 1
// and 6 use it: a fill launch (every output 0), one CTA of 512 threads per
// span of 8,192 slots (16 consecutive slots a thread, 16-byte loads when
// both arrays are aligned; runs closed inside the span are written, its
// first and last go to a summary in scratch), then one CTA folds the
// summaries in span order.  A power-law hub is cut into spans like any
// other key, so no thread walks it alone.
//
// Design, (E, K), any K: the rows are cut into spans of kRows2d rows.  A
// group of min(K, 256) threads takes one span, a thread a column, so a
// row's K values are read by neighbouring threads (coalesced).  Each
// thread walks its column down the span in order, eight rows' loads in
// flight at a time, writing every run that closes inside the span; the
// span's first and last runs (keys shared by the columns, values one a
// column) go to scratch.  The fold then gives each run that crosses a span
// boundary to the span where it starts: that thread adds the run's pieces
// span after span, in span order.  Columns beyond 256 take more groups
// (blockIdx.y).
#include "lux_runs.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSpan = kThreads * kUnit;  // 8192 slots = ops/segment.SUM_SPAN_SLOTS
constexpr int kThreads2d = 256;
constexpr int kRows2d = 128;  // rows of one (E, K) span = ops/segment.SUM_SPAN_ROWS
constexpr int kBatch = 8;     // rows whose loads a thread issues together

__global__ void __launch_bounds__(kThreads, 2)
sum_span_kernel(const float* __restrict__ vals, const int32_t* __restrict__ key, long long n,
                int num_segments, bool vec, float* __restrict__ out, void* scratch,
                int num_spans) {
  const long long p0 = (long long)blockIdx.x * kSpan + threadIdx.x * kUnit;
  Runs<float, LUX_SUM> runs;
  runs.init();
  if (p0 < n) {
    float v[kUnit];
    int d[kUnit];
    if (vec && p0 + kUnit <= n) {
      load16_as(vals + p0, v);
      Idx16<int32_t> q;
      q.load(key + p0);
#pragma unroll
      for (int j = 0; j < kUnit; ++j) d[j] = q[j];
    } else {
#pragma unroll
      for (int j = 0; j < kUnit; ++j) {
        const bool in = p0 + j < n;
        v[j] = in ? vals[p0 + j] : 0.f;
        d[j] = in ? key[p0 + j] : -1;  // past the end: padding
      }
    }
#pragma unroll
    for (int j = 0; j < kUnit; ++j)
      if ((unsigned)d[j] < (unsigned)num_segments) runs.add(d[j], v[j], out);
  }
  runs.finish();
  const Runs<float, LUX_SUM> all = cta_combine(runs, out);
  if (threadIdx.x == 0) Parts<float>(scratch, num_spans).put(blockIdx.x, all);
}

// The (E, K) spans' summaries in scratch: run count, first and last key of
// each span (ints), then the first and last runs' partial sums of every
// column (floats).
struct Spans2d {
  int* n;
  int* fk;
  int* lk;
  float* fv;
  float* lv;
  __host__ __device__ Spans2d(void* scratch, long long num_spans, int k)
      : n(static_cast<int*>(scratch)),
        fk(static_cast<int*>(scratch) + num_spans),
        lk(static_cast<int*>(scratch) + 2 * num_spans),
        fv(reinterpret_cast<float*>(static_cast<int*>(scratch) + 3 * num_spans)),
        lv(reinterpret_cast<float*>(static_cast<int*>(scratch) + 3 * num_spans) +
           num_spans * k) {}
  static long long bytes(long long num_spans, int k) { return num_spans * (12LL + 8LL * k); }
};

// The thread's span and column: a group of `lanes` threads a span.
struct Lane2d {
  long long span;
  int col;
  bool live;
  __device__ Lane2d(int k, long long num_spans) {
    const int lanes = k < kThreads2d ? k : kThreads2d;
    const int groups = kThreads2d / lanes;
    const int g = threadIdx.x / lanes;
    span = (long long)blockIdx.x * groups + g;
    col = blockIdx.y * lanes + threadIdx.x % lanes;
    live = g < groups && span < num_spans && col < k;
  }
};

__global__ void __launch_bounds__(kThreads2d)
sum2d_span_kernel(const float* __restrict__ vals, const int32_t* __restrict__ key, long long rows,
                  int k, int num_segments, float* __restrict__ out, void* scratch,
                  long long num_spans) {
  const Lane2d t(k, num_spans);
  if (!t.live) return;
  const long long r0 = t.span * kRows2d;
  const long long r1 = r0 + kRows2d < rows ? r0 + kRows2d : rows;
  int n = 0, fk = -1, lk = -1;
  float fv = 0.f, lv = 0.f;
  for (long long b = r0; b < r1; b += kBatch) {
    int d[kBatch];
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool in = b + j < r1;
      d[j] = in ? __ldg(key + b + j) : -1;
      v[j] = in ? __ldg(vals + (b + j) * k + t.col) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if ((unsigned)d[j] >= (unsigned)num_segments) continue;  // padding
      if (n > 0 && d[j] == lk) { lv += v[j]; continue; }
      if (n == 1) { fk = lk; fv = lv; }
      else if (n > 1) out[(long long)lk * k + t.col] = 0.f + lv;  // closed inside the span
      lk = d[j]; lv = v[j]; ++n;
    }
  }
  if (n == 1) { fk = lk; fv = lv; }
  const Spans2d s(scratch, num_spans, k);
  if (t.col == 0) { s.n[t.span] = n; s.fk[t.span] = fk; s.lk[t.span] = lk; }
  s.fv[t.span * k + t.col] = fv;
  s.lv[t.span * k + t.col] = lv;
}

// Add the pieces of the run of key `key` that continue past span `from`,
// span after span, and write the total.
__device__ void finish_run2d(const Spans2d& s, long long from, long long num_spans, int k, int col,
                             int key, float v, float* __restrict__ out) {
  for (long long t = from + 1; t < num_spans; ++t) {
    const int nt = s.n[t];
    if (nt == 0) continue;  // all padding
    if (s.fk[t] != key) break;
    v += s.fv[t * k + col];
    if (nt > 1) break;  // the run closes in span t
  }
  out[(long long)key * k + col] = 0.f + v;
}

__global__ void __launch_bounds__(kThreads2d)
sum2d_fold_kernel(void* scratch, long long num_spans, int k, float* __restrict__ out) {
  const Lane2d t(k, num_spans);
  if (!t.live) return;
  const Spans2d s(scratch, num_spans, k);
  const int n = s.n[t.span];
  if (n == 0) return;
  int prev = -1;  // the last key of the nearest span before with a key
  for (long long u = t.span - 1; u >= 0; --u)
    if (s.n[u] > 0) { prev = s.lk[u]; break; }
  const int fk = s.fk[t.span];
  if (fk != prev) {  // the span's first run starts here
    const float fv = s.fv[t.span * k + t.col];
    if (n == 1) finish_run2d(s, t.span, num_spans, k, t.col, fk, fv, out);
    else out[(long long)fk * k + t.col] = 0.f + fv;
  }
  if (n > 1)  // the last run starts here too
    finish_run2d(s, t.span, num_spans, k, t.col, s.lk[t.span], s.lv[t.span * k + t.col], out);
}

long long spans_1d(long long n) { return (n + kSpan - 1) / kSpan; }
long long spans_2d(long long rows) { return (rows + kRows2d - 1) / kRows2d; }

long long scratch_need(long long rows, int k) {
  return k == 1 ? (long long)kPartBytes * spans_1d(rows) : Spans2d::bytes(spans_2d(rows), k);
}

}  // namespace

// vals: (rows, k) f32, row-major; key: (rows,) int32, sorted once the
// padding (keys outside [0, num_segments)) is set aside; out: (num_segments,
// k) f32; scratch: at least lux_segment_sum_sorted_scratch(rows, k) bytes.
// Returns cudaGetLastError() after the launches (0 = launched);
// cudaErrorInvalidValue for a malformed call.
extern "C" long long lux_segment_sum_sorted_scratch(long long rows, int k) {
  return scratch_need(rows, k);
}

extern "C" int lux_segment_sum_sorted(const void* vals, const void* key, long long rows, int k,
                                      int num_segments, void* out, void* scratch,
                                      long long scratch_bytes, void* stream) {
  if (rows < 0 || k < 1 || num_segments < 0 || scratch_bytes < scratch_need(rows, k) ||
      (long long)num_segments * k > ((long long)1 << 40))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* v = static_cast<const float*>(vals);
  const int32_t* d = static_cast<const int32_t*>(key);
  launch_fill<float, LUX_SUM>(o, (long long)num_segments * k, s);
  if (rows == 0 || num_segments == 0) return (int)cudaGetLastError();
  if (k == 1) {
    const long long spans = spans_1d(rows);
    if (spans > INT32_MAX) return (int)cudaErrorInvalidValue;
    const bool vec = ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(key)) &
                      15) == 0;
    sum_span_kernel<<<(unsigned)spans, kThreads, 0, s>>>(v, d, rows, num_segments, vec, o,
                                                         scratch, (int)spans);
    runs_fold_kernel<float, LUX_SUM, float><<<1, kFoldThreads, 0, s>>>(scratch, (int)spans, o);
    return (int)cudaGetLastError();
  }
  const long long spans = spans_2d(rows);
  const int lanes = k < kThreads2d ? k : kThreads2d;
  const int groups = kThreads2d / lanes;
  const long long gx = (spans + groups - 1) / groups;
  const long long gy = (k + lanes - 1) / lanes;
  if (gx > INT32_MAX || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  sum2d_span_kernel<<<grid, kThreads2d, 0, s>>>(v, d, rows, k, num_segments, o, scratch, spans);
  sum2d_fold_kernel<<<grid, kThreads2d, 0, s>>>(scratch, spans, k, o);
  return (int)cudaGetLastError();
}
