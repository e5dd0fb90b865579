// Block-CSR segmented reduction by destination, for sm_90a.
//
// Replaces: lux_tpu/ops/pallas_spmv.py spmv_blockcsr (kernel body
// _spmv_kernel), the TPU one-hot (V_BLK, T) @ (T, 1) MXU contraction that
// reduces each edge chunk into its vertex block.
//
// What bounds it on the H100: memory.  Per padded edge slot it must read 4
// bytes of value (2 for bf16) and 4 bytes of e_dst_rel, and it writes 4
// bytes per output vertex; there is one add per slot, so at 3.35 TB/s and
// 67 TFLOP/s (fp32) the bytes dominate by two orders of magnitude.  The
// one-hot contraction is a TPU idiom (it turns a scatter into MXU work) and
// would multiply the arithmetic by V_BLK here for nothing.
//
// Design: use what build_blockcsr guarantees instead.  A vertex block's
// edges sit contiguously from its first chunk, sorted by e_dst_rel, and
// padding (e_dst_rel == V_BLK) only appears at the tail of the block's last
// chunk.  So:
//   * one CTA per vertex block; thread 0 and thread 32 binary-search
//     chunk_block (sorted) for the block's chunk range, so the wrapper
//     needs no chunk_start array and chunk_first is not read;
//   * one coalesced pass over the block's e_dst_rel marks segment
//     boundaries in shared memory (seg[v] = first slot with dst >= v);
//     padding is skipped by its e_dst_rel == V_BLK, never by its value;
//   * each warp then reduces whole vertices: lanes stride the segment,
//     coalesced, and a fixed shuffle tree combines them.  The order is
//     fixed, so results are deterministic; every output is written once,
//     with no atomics.
// Known limit: a hub vertex is reduced by one warp, so on RMAT graphs the
// CTA that holds the largest in-degree runs longest.  Splitting hubs over
// the CTA (or over CTAs with a second pass) is later work.
//
// Supported: sum of f32 or bf16 values into f32; min/max of f32 or int32
// keeping the type.
#include "lux_ops.cuh"

namespace {

constexpr int kThreads = 256;

template <typename TIn, typename TAcc, int OP>
__global__ void __launch_bounds__(kThreads)
spmv_blockcsr_kernel(const TIn* __restrict__ vals, const int32_t* __restrict__ dst_rel,
                     const int32_t* __restrict__ chunk_block, int num_chunks, int t_chunk,
                     int v_blk, TAcc* __restrict__ out) {
  using C = Combine<TAcc, OP>;
  extern __shared__ int seg[];  // v_blk + 2 slot offsets, relative to the span
  __shared__ long long span[2];
  const int b = blockIdx.x;
  blockcsr_span(chunk_block, num_chunks, t_chunk, b, span);
  const long long lo = span[0];
  const int len = (int)(span[1] - lo);
  blockcsr_segments(dst_rel + lo, len, v_blk, seg);
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const TIn* x = vals + lo;
  for (int v = threadIdx.x >> 5; v < v_blk; v += nwarps) {
    const int s = seg[v], e = seg[v + 1];
    TAcc acc = C::neutral();
#pragma unroll 4
    for (int i = s + lane; i < e; i += 32) acc = C::apply(acc, load_as<TAcc>(x + i));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = C::apply(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (lane == 0) out[(long long)b * v_blk + v] = acc;
  }
}

template <typename TIn, typename TAcc, int OP>
void launch(const void* vals, const void* dst_rel, const void* chunk_block, int num_chunks,
            int t_chunk, int v_blk, int num_vblocks, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)(v_blk + 2) * sizeof(int);
  spmv_blockcsr_kernel<TIn, TAcc, OP><<<num_vblocks, kThreads, smem, stream>>>(
      static_cast<const TIn*>(vals), static_cast<const int32_t*>(dst_rel),
      static_cast<const int32_t*>(chunk_block), num_chunks, t_chunk, v_blk,
      static_cast<TAcc*>(out));
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); an
// unsupported (kind, op) pair or a v_blk whose boundary table exceeds the
// default 48 KB of shared memory returns cudaErrorInvalidValue.
extern "C" int lux_spmv_blockcsr(const void* vals, int kind, const void* dst_rel,
                                 const void* chunk_block, int num_chunks, int t_chunk,
                                 int v_blk, int num_vblocks, int op, void* out,
                                 void* stream) {
  if (v_blk <= 0 || (size_t)(v_blk + 2) * sizeof(int) > 48 * 1024 || num_vblocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = kind * 3 + op;
  switch (key) {
    case LUX_F32 * 3 + LUX_SUM:
      launch<float, float, LUX_SUM>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, s);
      break;
    case LUX_BF16 * 3 + LUX_SUM:
      launch<__nv_bfloat16, float, LUX_SUM>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, s);
      break;
    case LUX_F32 * 3 + LUX_MIN:
      launch<float, float, LUX_MIN>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, s);
      break;
    case LUX_F32 * 3 + LUX_MAX:
      launch<float, float, LUX_MAX>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, s);
      break;
    case LUX_I32 * 3 + LUX_MIN:
      launch<int32_t, int32_t, LUX_MIN>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, s);
      break;
    case LUX_I32 * 3 + LUX_MAX:
      launch<int32_t, int32_t, LUX_MAX>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, out, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
