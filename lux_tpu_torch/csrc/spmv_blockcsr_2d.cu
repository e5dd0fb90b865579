// Block-CSR segmented SUM of K-wide rows by destination, for sm_90a.
//
// Replaces: lux_tpu/ops/pallas_spmv.py spmv_blockcsr_2d (kernel body
// _spmv2d_kernel), the TPU one-hot (V_BLK, T) @ (T, K) MXU contraction that
// reduces each chunk's (T, K) per-slot values into its vertex block.  In
// collaborative filtering it is the accumulation accErr[v] = sum over the
// in-edges of err * v_src (col_filter/colfilter_gpu.cu:88-89).
//
// What bounds it on the H100: memory.  Per padded slot it must read K
// values (4 bytes each in f32, 2 in bf16) and a 4-byte e_dst_rel, and it
// writes K f32 per output vertex, with one add per value read.  At the CF
// main shape (C*T ~ 17.3 M slots, K = 20, 2^20 output rows) that is about
// 1.54 GB, 0.46 ms at 3.35 TB/s, against 0.35 G adds, 5 us at the fp32
// rate.  The one-hot contraction would multiply the arithmetic by V_BLK.
//
// Design: the layout guarantees of build_blockcsr that spmv_blockcsr.cu
// relies on (a block's chunks are contiguous and chunk_block is sorted;
// slots are sorted by destination; padding, e_dst_rel == V_BLK, only at the
// tail of the block's last chunk):
//   * one CTA per vertex block finds its slot span and builds the boundary
//     table seg[v] in shared memory (lux_ops.cuh), so chunk_first is not
//     read; padding lies past seg[v_blk] and is skipped by its index, never
//     by its value;
//   * one thread per (vertex, group of 4 columns) walks the vertex's rows in
//     slot order with one 16-byte load a row (8 bytes for bf16): with K = 20
//     the five threads of a vertex read its 80-byte row together.  When K is
//     not a multiple of 4 (or a pointer is not aligned for it) the rows are
//     not 16-byte aligned and the scalar path runs, one thread per (vertex,
//     column);
//   * each thread sums its rows in slot order in f32 and writes each of its
//     outputs once: deterministic, no atomics.  A vertex with no slot gets 0.
// Known limit: one thread walks all the rows of a vertex for its columns,
// so a hub vertex serializes its CTA.  bipartite_ratings (the CF app's
// synthetic graph) is uniform, with in-degree about 16, so it does not show;
// a power-law rating graph read with -file would, as RMAT does in
// spmv_blockcsr.
//
// Supported: f32 or bf16 values, summed into f32.
#include "lux_ops.cuh"

namespace {

constexpr int kThreads = 256;

// Adds VEC consecutive values of a row, widened to f32, into acc.
template <typename TIn, int VEC> struct Row;

template <> struct Row<float, 4> {
  static __device__ __forceinline__ void add(const float* p, float* acc) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    acc[0] += x.x;
    acc[1] += x.y;
    acc[2] += x.z;
    acc[3] += x.w;
  }
};

template <> struct Row<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void add(const __nv_bfloat16* p, float* acc) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    acc[0] += lo.x;
    acc[1] += lo.y;
    acc[2] += hi.x;
    acc[3] += hi.y;
  }
};

template <typename TIn> struct Row<TIn, 1> {
  static __device__ __forceinline__ void add(const TIn* p, float* acc) {
    acc[0] += load_as<float>(p);
  }
};

template <typename TIn, int VEC>
__global__ void __launch_bounds__(kThreads)
spmv_blockcsr_2d_kernel(const TIn* __restrict__ vals, const int32_t* __restrict__ dst_rel,
                        const int32_t* __restrict__ chunk_block, int num_chunks, int t_chunk,
                        int v_blk, int k, float* __restrict__ out) {
  extern __shared__ int seg[];  // v_blk + 2 slot offsets, relative to the span
  __shared__ long long span[2];
  const int b = blockIdx.x;
  blockcsr_span(chunk_block, num_chunks, t_chunk, b, span);
  const long long lo = span[0];
  const int len = (int)(span[1] - lo);
  blockcsr_segments(dst_rel + lo, len, v_blk, seg);
  const int groups = k / VEC;  // column groups of a row
  const TIn* x = vals + lo * k;
  float* o = out + (long long)b * v_blk * k;
  for (int item = threadIdx.x; item < v_blk * groups; item += blockDim.x) {
    const int v = item / groups;
    const int c = (item - v * groups) * VEC;
    const int s = seg[v], e = seg[v + 1];
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int i = s; i < e; ++i) Row<TIn, VEC>::add(x + (long long)i * k + c, acc);
    float* dst = o + (long long)v * k + c;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      dst[0] = acc[0];
    }
  }
}

template <typename TIn>
void launch(const void* vals, const void* dst_rel, const void* chunk_block, int num_chunks,
            int t_chunk, int v_blk, int num_vblocks, int k, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)(v_blk + 2) * sizeof(int);
  // 16-byte rows need K % 4 == 0 and aligned bases (4 values of TIn, 4 f32)
  const bool vec4 = k % 4 == 0 && (uintptr_t)vals % (4 * sizeof(TIn)) == 0 &&
                    (uintptr_t)out % 16 == 0;
  const TIn* v = static_cast<const TIn*>(vals);
  const int32_t* d = static_cast<const int32_t*>(dst_rel);
  const int32_t* cb = static_cast<const int32_t*>(chunk_block);
  float* o = static_cast<float*>(out);
  if (vec4)
    spmv_blockcsr_2d_kernel<TIn, 4><<<num_vblocks, kThreads, smem, stream>>>(
        v, d, cb, num_chunks, t_chunk, v_blk, k, o);
  else
    spmv_blockcsr_2d_kernel<TIn, 1><<<num_vblocks, kThreads, smem, stream>>>(
        v, d, cb, num_chunks, t_chunk, v_blk, k, o);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); a value kind
// other than f32/bf16, k < 1, or a v_blk whose boundary table exceeds the
// default 48 KB of shared memory returns cudaErrorInvalidValue.
extern "C" int lux_spmv_blockcsr_2d(const void* vals, int kind, const void* dst_rel,
                                    const void* chunk_block, int num_chunks, int t_chunk,
                                    int v_blk, int num_vblocks, int k, void* out,
                                    void* stream) {
  if (v_blk <= 0 || (size_t)(v_blk + 2) * sizeof(int) > 48 * 1024 || num_vblocks <= 0 ||
      k < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == LUX_F32)
    launch<float>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, k, out, s);
  else if (kind == LUX_BF16)
    launch<__nv_bfloat16>(vals, dst_rel, chunk_block, num_chunks, t_chunk, v_blk, num_vblocks, k,
                          out, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
