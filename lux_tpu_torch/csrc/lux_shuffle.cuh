// Shared pieces of the routed-pull kernels (lane_gather, sublane_gather,
// fused_pass_gather, mxreduce_pass_gather): raw-bit element types, four-wide
// vector loads and stores, and the step table of a chained pass group.
//
// The gathers only move bits, so values travel as unsigned integers of their
// width (uint32_t for float32 and int32, uint16_t for bfloat16).
//
// A chained group runs n_steps steps on a tile.  Step s reads, for output
// position p of the tile, the element at q = (p & ~127) | idx_s[p] of the
// step's input after an optional relayout; the relayout (a static
// reshape/transpose/reshape of the tile, every axis a power of two) maps
// q to the old position  sum_i ((q >> shift[i]) & mask[i]) << src_shift[i].
// The host packs the table as int32: n_steps, then per step
// (has_relayout, ndim, then ndim triples (shift, mask, src_shift)); see
// ops/shuffle._relayout_desc.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kLane = 128;
constexpr int kMaxSteps = 4;  // ops/shuffle.MAX_STEPS
constexpr int kMaxDims = 8;   // ops/shuffle.MAX_DIMS

struct Relayout {
  int ndim;
  int shift[kMaxDims];
  int mask[kMaxDims];
  int src_shift[kMaxDims];
};

struct StepPlan {
  int n_steps;
  int has_relayout[kMaxSteps];
  Relayout rel[kMaxSteps];
  const void* idx[kMaxSteps];
};

// Parse the host step table; returns false on a malformed table.
inline bool parse_steps(const int32_t* desc, const void* const* idx, StepPlan* plan) {
  int pos = 0;
  plan->n_steps = desc[pos++];
  if (plan->n_steps < 1 || plan->n_steps > kMaxSteps) return false;
  for (int s = 0; s < kMaxSteps; ++s) {
    plan->has_relayout[s] = 0;
    plan->rel[s].ndim = 0;
    plan->idx[s] = s < plan->n_steps ? idx[s] : nullptr;
  }
  for (int s = 0; s < plan->n_steps; ++s) {
    plan->has_relayout[s] = desc[pos++];
    const int ndim = desc[pos++];
    if (ndim < 0 || ndim > kMaxDims || (plan->has_relayout[s] && ndim == 0)) return false;
    plan->rel[s].ndim = ndim;
    for (int i = 0; i < ndim; ++i) {
      plan->rel[s].shift[i] = desc[pos++];
      plan->rel[s].mask[i] = desc[pos++];
      plan->rel[s].src_shift[i] = desc[pos++];
    }
    if (plan->idx[s] == nullptr) return false;
  }
  return true;
}

__device__ __forceinline__ int relayout_src(const Relayout& r, int q) {
  int src = 0;
#pragma unroll
  for (int i = 0; i < kMaxDims; ++i)
    if (i < r.ndim) src += ((q >> r.shift[i]) & r.mask[i]) << r.src_shift[i];
  return src;
}

// Four consecutive indices starting at a multiple of 4.
template <typename I> struct Idx4;
template <> struct Idx4<uint8_t> {
  static __device__ __forceinline__ void load(const uint8_t* p, int out[4]) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Idx4<int32_t> {
  static __device__ __forceinline__ void load(const int32_t* p, int out[4]) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

// Four consecutive raw elements stored at a multiple of 4.
template <typename T> struct Vec4;
template <> struct Vec4<uint32_t> {
  static __device__ __forceinline__ void store(uint32_t* p, const uint32_t v[4]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void load(const uint32_t* p, uint32_t v[4]) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
};
template <> struct Vec4<uint16_t> {
  static __device__ __forceinline__ void store(uint16_t* p, const uint16_t v[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0] | (uint32_t(v[1]) << 16),
                                              v[2] | (uint32_t(v[3]) << 16));
  }
  static __device__ __forceinline__ void load(const uint16_t* p, uint16_t v[4]) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = w.x & 0xffffu; v[1] = w.x >> 16; v[2] = w.y & 0xffffu; v[3] = w.y >> 16;
  }
};

// Copy nbytes (a multiple of 16, both pointers 16-byte aligned) with the
// whole block, 16 bytes a thread.
__device__ __forceinline__ void block_copy16(const void* __restrict__ src, void* __restrict__ dst,
                                             long long nbytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (long long i = threadIdx.x; i < nbytes / 16; i += blockDim.x) d[i] = s[i];
}
