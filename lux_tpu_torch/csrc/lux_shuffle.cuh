// Shared pieces of the routed-pull kernels (lane_gather, sublane_gather,
// fused_pass_gather, mxreduce_pass_gather): raw-bit element types, vector
// loads and stores, the step table of a chained pass group, and the
// swizzled shared-memory tile the two chained kernels step in.
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

#include "lux_ops.cuh"  // kUnit, Idx16

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

// Four consecutive indices starting at a multiple of 4 (lane_gather).
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

// Four consecutive raw elements stored at a multiple of 4 (lane_gather).
template <typename T> struct Vec4;
template <> struct Vec4<uint32_t> {
  static __device__ __forceinline__ void store(uint32_t* p, const uint32_t v[4]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec4<uint16_t> {
  static __device__ __forceinline__ void store(uint16_t* p, const uint16_t v[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0] | (uint32_t(v[1]) << 16),
                                              v[2] | (uint32_t(v[3]) << 16));
  }
};

// --- the chained kernels' tile -------------------------------------------
//
// A thread of fused_pass_gather or mxreduce_pass_gather owns units of 16
// consecutive tile positions: it loads their indices in one 16-byte load
// (uint8) and, in each step, reads their 16 sources into registers; after
// a barrier it writes them back IN PLACE, so a tile needs one buffer.  In
// shared memory the tile is kept as 16-byte chunks with chunk c stored at
// chunk c ^ ((c >> 3) & 7): the eight threads of a quarter-warp then store
// their 16-byte pieces to eight distinct bank groups, where the plain layout
// would put them on two.  Reads go through the same map (Tile<T>::swz).

template <typename T> struct Tile {
  static constexpr int kShift = sizeof(T) == 4 ? 2 : 3;  // log2(elements a chunk)
  static constexpr int kPerChunk = 1 << kShift;
  static __device__ __forceinline__ int chunk(int c) { return c ^ ((c >> 3) & 7); }
  static __device__ __forceinline__ int swz(int p) {
    return p ^ (((p >> (kShift + 3)) & 7) << kShift);
  }
};

__device__ __forceinline__ void cp_async16(void* dst_smem, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Wait for every cp.async this thread issued (a barrier must follow).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying elems elements (elems * sizeof(T) a multiple of 16, src
// 16-byte aligned) into the swizzled tile, 16 bytes a thread per copy, all
// in flight at once; cp_async_wait_all() and a barrier complete it.
template <typename T>
__device__ __forceinline__ void tile_load_async(const T* __restrict__ src, T* tile, int elems) {
  const int chunks = elems / Tile<T>::kPerChunk;
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(tile);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    cp_async16(d + 16 * Tile<T>::chunk(c), s + 16LL * c);
}

__device__ __forceinline__ uint32_t bits32(uint32_t a) { return a; }
__device__ __forceinline__ uint32_t bits32(int32_t a) { return static_cast<uint32_t>(a); }
__device__ __forceinline__ uint32_t bits32(float a) { return __float_as_uint(a); }

// One 16-byte chunk of consecutive elements v[0 .. 16 / sizeof(T)).
template <typename T>
__device__ __forceinline__ uint4 pack_chunk(const T* v) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(bits32(v[0]), bits32(v[1]), bits32(v[2]), bits32(v[3]));
  } else {
    return make_uint4(v[0] | (uint32_t(v[1]) << 16), v[2] | (uint32_t(v[3]) << 16),
                      v[4] | (uint32_t(v[5]) << 16), v[6] | (uint32_t(v[7]) << 16));
  }
}

// Store the 16 values of the unit at tile position p0 (a multiple of 16):
// into the swizzled tile, or straight to device memory.
template <typename T>
__device__ __forceinline__ void store16_tile(T* tile, int p0, const T (&v)[kUnit]) {
  constexpr int e = Tile<T>::kPerChunk;
#pragma unroll
  for (int m = 0; m < kUnit / e; ++m)
    *reinterpret_cast<uint4*>(tile + Tile<T>::swz(p0 + m * e)) = pack_chunk(v + m * e);
}
template <typename T>
__device__ __forceinline__ void store16_global(T* __restrict__ dst, const T (&v)[kUnit]) {
  constexpr int e = Tile<T>::kPerChunk;
#pragma unroll
  for (int m = 0; m < kUnit / e; ++m)
    reinterpret_cast<uint4*>(dst)[m] = pack_chunk(v + m * e);
}

// The address arithmetic of a step, out of the inner loop.  A relayout
// permutes the bits of a tile position (every axis is a power of two), and
// the swizzle XORs bits into bits, so both distribute over positions with
// disjoint bits: the swizzled source of tile position toff | row | lane is
// swz(toff | rel(row)) ^ swz(rel(lane)).  Each CTA tabulates the second
// term for the 128 lanes of every step (lut[s * 128 + lane], in shared
// memory); a unit computes the first once per step; an element costs one
// table read and one XOR.  The CTA's threads stride over the 128 lanes: a
// small tile runs fewer than 128 threads, and every lane is read.
template <typename T>
__device__ __forceinline__ void build_lane_luts(const StepPlan& plan, uint16_t* lut) {
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s)
    if (s < plan.n_steps)
      for (int l = threadIdx.x; l < kLane; l += blockDim.x)
        lut[s * kLane + l] =
            (uint16_t)Tile<T>::swz(plan.has_relayout[s] ? relayout_src(plan.rel[s], l) : l);
}

// The swizzled source of the unit's row part in step s.
template <typename T>
__device__ __forceinline__ int step_base(const StepPlan& plan, int s, int toff, int row) {
  return Tile<T>::swz(toff | (plan.has_relayout[s] ? relayout_src(plan.rel[s], row) : row));
}

// One step's reads for a unit: v[j] = the step input's element at
// row | q[j] (after the step's relayout, if any), through base and the
// step's lane table.
template <typename T, typename I>
__device__ __forceinline__ void step_read16(const T* tile, int base, const uint16_t* lut,
                                            const Idx16<I>& q, T (&v)[kUnit]) {
#pragma unroll
  for (int j = 0; j < kUnit; ++j) v[j] = tile[base ^ lut[q[j]]];
}
