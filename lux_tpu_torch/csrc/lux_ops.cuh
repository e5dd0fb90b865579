// Shared device helpers for the lux_tpu_torch kernels: the three combiners
// of the segmented reductions (sum / min / max), their neutral elements,
// typed loads that widen storage types to the accumulation type (one
// element, or sixteen with 16-byte loads), and the block-CSR span helpers.
//
// Conventions shared with the plain PyTorch versions (ops/spmv.py,
// ops/scan.py):
//   * float sums accumulate in float32;
//   * int32 sums accumulate in uint32, so overflow wraps as in the plain
//     version and the reference (two's complement, no UB);
//   * min/max keep the storage type and propagate NaN like torch.minimum /
//     torch.maximum (a NaN operand gives NaN); bf16 values compare after
//     an exact widening to f32 and are stored back as bf16.
#pragma once

#include <cstdint>
#include <climits>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum LuxOp : int { LUX_SUM = 0, LUX_MIN = 1, LUX_MAX = 2 };
enum LuxKind : int { LUX_F32 = 0, LUX_BF16 = 1, LUX_I32 = 2 };

template <typename T, int OP> struct Combine;

template <typename T> struct Combine<T, LUX_SUM> {
  static __device__ __forceinline__ T neutral() { return T(0); }
  static __device__ __forceinline__ T apply(T a, T b) { return a + b; }
};

template <> struct Combine<float, LUX_MIN> {
  static __device__ __forceinline__ float neutral() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float apply(float a, float b) {
    return (a < b || a != a) ? a : b;
  }
};

template <> struct Combine<float, LUX_MAX> {
  static __device__ __forceinline__ float neutral() { return __int_as_float(0xff800000); }
  static __device__ __forceinline__ float apply(float a, float b) {
    return (a > b || a != a) ? a : b;
  }
};

template <> struct Combine<int32_t, LUX_MIN> {
  static __device__ __forceinline__ int32_t neutral() { return INT_MAX; }
  static __device__ __forceinline__ int32_t apply(int32_t a, int32_t b) { return a < b ? a : b; }
};

template <> struct Combine<int32_t, LUX_MAX> {
  static __device__ __forceinline__ int32_t neutral() { return INT_MIN; }
  static __device__ __forceinline__ int32_t apply(int32_t a, int32_t b) { return a > b ? a : b; }
};

// Widening loads: storage type -> accumulation type.
template <typename TAcc, typename TIn> __device__ __forceinline__ TAcc load_as(const TIn* p);

template <> __device__ __forceinline__ float load_as<float, float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float load_as<float, __nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <> __device__ __forceinline__ int32_t load_as<int32_t, int32_t>(const int32_t* p) { return *p; }
template <> __device__ __forceinline__ uint32_t load_as<uint32_t, int32_t>(const int32_t* p) {
  return static_cast<uint32_t>(*p);
}

// Narrowing stores: accumulation type -> storage type.  A bf16 output
// rounds its f32 value to nearest even, once; for min/max of widened bf16
// values that is exact (the value was a bf16 to begin with).
template <typename TOut, typename TAcc>
__device__ __forceinline__ TOut narrow(TAcc v) {
  if constexpr (std::is_same<TOut, __nv_bfloat16>::value) return __float2bfloat16_rn(v);
  else return static_cast<TOut>(v);
}

// The bf16 whose bits are b (a bf16 is the high half of the f32 it widens to).
__device__ __forceinline__ float bf16_bits_to_float(uint32_t b) { return __uint_as_float(b << 16); }
__device__ __forceinline__ uint32_t float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// --- sixteen elements a thread ---------------------------------------------
//
// The kernels that walk an array in order give each thread kUnit
// consecutive elements and load them with 16-byte loads from a 16-byte
// aligned address (the element index a multiple of 16, the base aligned).

constexpr int kUnit = 16;

// Sixteen consecutive indices, ranks or flag bytes.
template <typename I> struct Idx16;
template <> struct Idx16<uint8_t> {
  uint4 w;
  __device__ __forceinline__ void load(const uint8_t* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ int operator[](int j) const {
    const unsigned word = j < 4 ? w.x : j < 8 ? w.y : j < 12 ? w.z : w.w;
    return (word >> (8 * (j & 3))) & 0xff;
  }
};
template <> struct Idx16<int32_t> {
  int4 w[4];
  __device__ __forceinline__ void load(const int32_t* p) {
#pragma unroll
    for (int m = 0; m < 4; ++m) w[m] = __ldg(reinterpret_cast<const int4*>(p) + m);
  }
  __device__ __forceinline__ int operator[](int j) const {
    const int4& v = w[j >> 2];
    return (j & 3) == 0 ? v.x : (j & 3) == 1 ? v.y : (j & 3) == 2 ? v.z : v.w;
  }
};

// Sixteen consecutive values widened to the accumulation type: four
// 16-byte loads of f32 or int32, two of bf16 (a bf16 is the high half of
// the f32 it widens to).
template <typename TAcc, typename TIn>
__device__ __forceinline__ void load16_as(const TIn* p, TAcc (&v)[kUnit]) {
  if constexpr (sizeof(TIn) == 4) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + m);
      const uint32_t b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (std::is_floating_point<TAcc>::value) v[4 * m + e] = __uint_as_float(b[e]);
        else v[4 * m + e] = static_cast<TAcc>(b[e]);
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + m);
      const uint32_t b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[8 * m + 2 * e] = __uint_as_float(b[e] << 16);
        v[8 * m + 2 * e + 1] = __uint_as_float(b[e] & 0xffff0000u);
      }
    }
  }
}

// The first index of the sorted a[0, n) whose value is >= key.
__device__ __forceinline__ int lower_bound_i32(const int32_t* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (a[m] < key) lo = m + 1; else hi = m;
  }
  return lo;
}

// The slot range [span[0], span[1]) of vertex block b in a block-CSR layout
// (ops/spmv.build_blockcsr): a block's chunks are contiguous and
// chunk_block is sorted, so two binary searches find them.  Threads 0 and
// 32 search; every thread of the CTA must call it (it ends in a barrier).
__device__ __forceinline__ void blockcsr_span(const int32_t* chunk_block, int num_chunks,
                                              int t_chunk, int b, long long* span) {
  if (threadIdx.x == 0)
    span[0] = (long long)lower_bound_i32(chunk_block, num_chunks, b) * t_chunk;
  if (threadIdx.x == 32)
    span[1] = (long long)lower_bound_i32(chunk_block, num_chunks, b + 1) * t_chunk;
  __syncthreads();
}

// The boundary table of one vertex block from its len slots' destination
// ids d (sorted; padding == v_blk only at the tail): seg[v] = the first slot
// whose destination is >= v, for v in [0, v_blk + 1], so vertex v owns
// slots [seg[v], seg[v + 1]) and padding is never inside one.  Slot i opens
// vertices prev+1 .. cur, prev being its predecessor's destination; a
// virtual slot at len with destination v_blk + 1 closes every vertex the
// real slots did not reach.  Every thread of the CTA must call it (it ends
// in a barrier).
__device__ __forceinline__ void blockcsr_segments(const int32_t* d, int len, int v_blk, int* seg) {
  for (int i = threadIdx.x; i <= len; i += blockDim.x) {
    const int cur = i < len ? min(max(d[i], 0), v_blk) : v_blk + 1;
    const int prev = i > 0 ? min(max(d[i - 1], 0), v_blk) : -1;
    for (int v = prev + 1; v <= cur; ++v) seg[v] = i;
  }
  __syncthreads();
}
