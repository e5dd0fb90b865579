// Block-CSR segmented reduction by destination, for sm_90a.
//
// Replaces: lux_tpu/ops/pallas_spmv.py spmv_blockcsr (kernel body
// _spmv_kernel), the TPU one-hot (V_BLK, T) @ (T, 1) MXU contraction that
// reduces each edge chunk into its vertex block.
//
// What bounds it on the H100: memory.  Per padded edge slot it must read 4
// bytes of value (2 for bf16) and 4 bytes of e_dst_rel, and it writes 4
// bytes per output vertex; there is one add per slot, so at 3.35 TB/s and
// 67 TFLOP/s (fp32) the bytes dominate by two orders of magnitude.  At the
// main path's layout (RMAT 20: 33,790 chunks of 512 slots) that is 142.6
// MB, 0.0426 ms.  The one-hot contraction is a TPU idiom (it turns a
// scatter into MXU work) and would multiply the arithmetic by V_BLK here
// for nothing.
//
// Design: one balanced grid over all the slots, whatever the degrees.
// build_blockcsr keeps a vertex block's chunks contiguous, sorts the
// block's slots by destination, pads (e_dst_rel == V_BLK) only at the tail
// of the block's last chunk, and sorts chunk_block.  So along the flat
// (C * T) slot array the key chunk_block[slot / T] * V_BLK +
// e_dst_rel[slot] never decreases once padding is set aside (a CPU test
// pins it on real layouts), and the reduction is the sorted-key segmented
// reduce of lux_runs.cuh, which may cut the array anywhere.  An RMAT hub
// (69,263 in-edges at scale 20) no longer runs on one warp while the card
// idles.  Three launches on the caller's stream:
//   0. fill: every output starts as the neutral value, so vertices with no
//      edge and all-padding blocks come out right;
//   1. spans: one CTA of 512 threads per span of kSpan = 8,192 slots (the
//      last may be short), two CTAs per SM.  Each thread owns 16
//      consecutive slots and loads them with 16-byte loads (four of f32 or
//      int32 values, two of bf16, four of e_dst_rel); it looks up the
//      chunk's block once, and again only where its 16 slots cross into the
//      next chunk (t_chunk not a multiple of 16).  It walks its runs of
//      equal key in registers: a run closed inside its 16 slots is written
//      straight to out[key].  The threads' summaries combine in a fixed
//      shuffle tree, over each warp and then over the warps; each run is
//      written by the combination that closes it, and the span's first and
//      last runs go to its summary in scratch;
//   2. fold: one CTA combines the spans' summaries in span order in the
//      same fixed tree.
// Every combination has a fixed order, so results are deterministic, with
// no atomics.  An array whose base is not 16-byte aligned, and the last
// thread's slots past the end, take scalar loads.
//
// Supported: sum of f32 or bf16 values into f32; min/max of f32 or int32
// keeping the type.
#include "lux_runs.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSpan = kThreads * kUnit;  // 8192 slots = ops/spmv.SPAN_SLOTS

// The flat key of a chunk's first slot (its block times v_blk), or -1 for
// a block outside the output (then the chunk's slots are skipped).
__device__ __forceinline__ int chunk_key(const int32_t* __restrict__ chunk_block, long long ch,
                                         int v_blk, int num_vblocks) {
  const int b = __ldg(chunk_block + ch);
  return (unsigned)b < (unsigned)num_vblocks ? b * v_blk : -1;
}

template <typename TIn, typename TAcc, int OP>
__global__ void __launch_bounds__(kThreads, 2)
spmv_span_kernel(const TIn* __restrict__ vals, const int32_t* __restrict__ dst_rel,
                 const int32_t* __restrict__ chunk_block, long long num_chunks, int t_chunk,
                 int v_blk, int num_vblocks, bool vec, TAcc* __restrict__ out, void* scratch,
                 int num_spans) {
  const long long n_slots = num_chunks * t_chunk;
  const long long p0 = (long long)blockIdx.x * kSpan + threadIdx.x * kUnit;
  Runs<TAcc, OP> runs;
  runs.init();
  if (p0 < n_slots) {
    TAcc v[kUnit];
    int d[kUnit];
    if (vec && p0 + kUnit <= n_slots) {
      load16_as(vals + p0, v);
      Idx16<int32_t> q;
      q.load(dst_rel + p0);
#pragma unroll
      for (int j = 0; j < kUnit; ++j) d[j] = q[j];
    } else {
#pragma unroll
      for (int j = 0; j < kUnit; ++j) {
        const bool in = p0 + j < n_slots;
        v[j] = in ? load_as<TAcc>(vals + p0 + j) : Combine<TAcc, OP>::neutral();
        d[j] = in ? dst_rel[p0 + j] : v_blk;  // past the end: padding
      }
    }
    long long ch = p0 / t_chunk;
    int r = (int)(p0 - ch * t_chunk);
    int kb = chunk_key(chunk_block, ch, v_blk, num_vblocks);
#pragma unroll
    for (int j = 0; j < kUnit; ++j) {
      if (r == t_chunk) {  // the slot opens the next chunk
        r = 0;
        ++ch;
        if (ch < num_chunks) kb = chunk_key(chunk_block, ch, v_blk, num_vblocks);
      }
      ++r;
      if ((unsigned)d[j] < (unsigned)v_blk && kb >= 0) runs.add(kb + d[j], v[j], out);
    }
  }
  runs.finish();
  const Runs<TAcc, OP> all = cta_combine(runs, out);
  if (threadIdx.x == 0) Parts<TAcc>(scratch, num_spans).put(blockIdx.x, all);
}

long long num_spans_of(long long n_slots) { return (n_slots + kSpan - 1) / kSpan; }

template <typename TIn, typename TAcc, int OP>
void launch(const void* vals, const void* dst_rel, const void* chunk_block, long long num_chunks,
            int t_chunk, int v_blk, int num_vblocks, void* out, void* scratch,
            cudaStream_t stream) {
  TAcc* o = static_cast<TAcc*>(out);
  launch_fill<TAcc, OP>(o, (long long)num_vblocks * v_blk, stream);
  const int num_spans = (int)num_spans_of(num_chunks * t_chunk);
  if (num_spans == 0) return;
  const bool vec = ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(dst_rel)) &
                    15) == 0;
  spmv_span_kernel<TIn, TAcc, OP><<<num_spans, kThreads, 0, stream>>>(
      static_cast<const TIn*>(vals), static_cast<const int32_t*>(dst_rel),
      static_cast<const int32_t*>(chunk_block), num_chunks, t_chunk, v_blk, num_vblocks, vec, o,
      scratch, num_spans);
  runs_fold_kernel<TAcc, OP><<<1, kFoldThreads, 0, stream>>>(scratch, num_spans, o);
}

}  // namespace

// vals: (num_chunks, t_chunk) values of `kind`; dst_rel: (num_chunks,
// t_chunk) int32, v_blk = padding; chunk_block: (num_chunks,) sorted int32.
// out: (num_vblocks * v_blk,) f32 for sums, else the value type.  scratch:
// at least 20 * ceil(num_chunks * t_chunk / 8192) bytes of device memory
// for the spans' summaries (ops/spmv.SPAN_SLOTS, PART_BYTES).  Returns
// cudaGetLastError() after the launches (0 = launched);
// cudaErrorInvalidValue for an unsupported (kind, op) pair or a malformed
// call (num_vblocks * v_blk must fit in int32, and so must the span count).
extern "C" int lux_spmv_blockcsr(const void* vals, int kind, const void* dst_rel,
                                 const void* chunk_block, long long num_chunks, int t_chunk,
                                 int v_blk, int num_vblocks, int op, void* out, void* scratch,
                                 long long scratch_bytes, void* stream) {
  if (v_blk <= 0 || num_vblocks <= 0 || t_chunk <= 0 || num_chunks < 0 ||
      (long long)num_vblocks * v_blk > INT32_MAX ||
      num_spans_of(num_chunks * t_chunk) > INT32_MAX ||
      scratch_bytes < (long long)kPartBytes * num_spans_of(num_chunks * t_chunk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind * 3 + op) {
    case LUX_F32 * 3 + LUX_SUM:
      launch<float, float, LUX_SUM>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, scratch, s);
      break;
    case LUX_BF16 * 3 + LUX_SUM:
      launch<__nv_bfloat16, float, LUX_SUM>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, scratch, s);
      break;
    case LUX_F32 * 3 + LUX_MIN:
      launch<float, float, LUX_MIN>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, scratch, s);
      break;
    case LUX_F32 * 3 + LUX_MAX:
      launch<float, float, LUX_MAX>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, scratch, s);
      break;
    case LUX_I32 * 3 + LUX_MIN:
      launch<int32_t, int32_t, LUX_MIN>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, scratch, s);
      break;
    case LUX_I32 * 3 + LUX_MAX:
      launch<int32_t, int32_t, LUX_MAX>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, scratch, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
