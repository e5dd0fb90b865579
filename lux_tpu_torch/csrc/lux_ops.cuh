// Shared device helpers for the lux_tpu_torch kernels: the three combiners
// of the segmented reductions (sum / min / max), their neutral elements,
// and typed loads that widen storage types to the accumulation type.
//
// Conventions shared with the plain PyTorch versions (ops/spmv.py,
// ops/scan.py):
//   * float sums accumulate in float32;
//   * int32 sums accumulate in uint32, so overflow wraps as in the plain
//     version and the reference (two's complement, no UB);
//   * min/max keep the storage type and propagate NaN like torch.minimum /
//     torch.maximum (a NaN operand gives NaN).
#pragma once

#include <cstdint>
#include <climits>
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
