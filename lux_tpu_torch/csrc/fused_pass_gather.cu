// One pass-fused group of a routed permutation: 2-3 Benes passes chained on
// a tile held in shared memory, for sm_90a.
//
// Replaces: lux_tpu/ops/pallas_shuffle.py fused_pass_gather (kernel body
// _pf_kernel), the TPU kernel that chains a group's steps on a VMEM tile so
// the group costs one read and one write of the array instead of one per
// pass.
//
// What bounds it on the H100: memory.  Per element it reads the value once,
// one index per step (1 byte as uint8) and writes the value once:
// n * (2 * esize + steps * isize) bytes over 3.35 TB/s.  Every step is a
// permutation within a block of the group's digits, so nothing but the
// first read and the last write needs device memory.
//
// Design: one CTA per tile of block_rows x 128 elements (the planner sizes
// block_rows so two tiles of 4-byte elements fit the shared-memory budget,
// ops/shuffle._pf_block_rows: at most 128 rows = 128 KB, above the default
// 48 KB, so the wrapper opts the kernel into what the tile needs).
// The tile is loaded with 16-byte vector copies, then each step reads, for
// four consecutive outputs p per thread, the element at
// relayout((p & ~127) | idx[p]) of the current buffer and writes the other
// buffer (ping-pong), with one barrier between steps; the in-tile relayout
// (the reference's reshape/transpose/reshape) is folded into the read
// address, so it costs no pass of its own.  The last step writes straight to
// device memory, four values per vector store.  Index tiles stream from
// device memory, four indices per vector load.
#include "lux_shuffle.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // the H100's per-block shared memory

template <typename T, typename I>
__global__ void __launch_bounds__(kMaxThreads)
fused_pass_kernel(const T* __restrict__ x, T* __restrict__ out, StepPlan plan, int tile_elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf0 = reinterpret_cast<T*>(smem);
  T* buf1 = buf0 + tile_elems;
  const long long base = (long long)blockIdx.x * tile_elems;
  block_copy16(x + base, buf0, (long long)tile_elems * sizeof(T));
  __syncthreads();
  int cur = 0;
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    if (s < plan.n_steps) {
      const I* ix = static_cast<const I*>(plan.idx[s]) + base;
      const T* src = cur ? buf1 : buf0;
      const bool last = s == plan.n_steps - 1;
      T* dst = last ? out + base : (cur ? buf0 : buf1);
      const bool rel = plan.has_relayout[s] != 0;
      for (int p = threadIdx.x * 4; p < tile_elems; p += blockDim.x * 4) {
        int q[4];
        Idx4<I>::load(ix + p, q);
        T v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int a = (p & ~(kLane - 1)) | q[j];
          if (rel) a = relayout_src(plan.rel[s], a);
          v[j] = src[a];
        }
        Vec4<T>::store(dst + p, v);
      }
      if (!last) {
        __syncthreads();
        cur ^= 1;
      }
    }
  }
}

template <typename T, typename I>
int launch(const void* x, const StepPlan& plan, long long rows, int block_rows, void* out,
           cudaStream_t stream) {
  static size_t attr_smem = 48 * 1024;  // per instantiation: the largest opted in
  const int tile_elems = block_rows * kLane;
  const size_t smem = 2 * (size_t)tile_elems * sizeof(T);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > attr_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_pass_kernel<T, I>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_smem = smem;
  }
  int threads = tile_elems / 4;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long tiles = rows / block_rows;
  fused_pass_kernel<T, I><<<(unsigned)tiles, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), plan, tile_elems);
  return 0;
}

}  // namespace

// x, out: (rows, 128) of esize-byte elements (4 or 2); idx: a host array of
// kMaxSteps device pointers to the (rows, 128) index tiles of isize bytes
// (1 or 4); desc: the host step table (lux_shuffle.cuh).  rows must be a
// positive multiple of block_rows.  Returns cudaGetLastError() after the
// launch (0 = launched); cudaErrorInvalidValue for a malformed call.
extern "C" int lux_fused_pass_gather(const void* x, int esize, const void* const* idx,
                                     int isize, const int32_t* desc, long long rows,
                                     int block_rows, void* out, void* stream) {
  StepPlan plan;
  if (!parse_steps(desc, idx, &plan) || block_rows < 1 || rows < block_rows ||
      rows % block_rows != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (esize == 4 && isize == 1) rc = launch<uint32_t, uint8_t>(x, plan, rows, block_rows, out, s);
  else if (esize == 4 && isize == 4) rc = launch<uint32_t, int32_t>(x, plan, rows, block_rows, out, s);
  else if (esize == 2 && isize == 1) rc = launch<uint16_t, uint8_t>(x, plan, rows, block_rows, out, s);
  else if (esize == 2 && isize == 4) rc = launch<uint16_t, int32_t>(x, plan, rows, block_rows, out, s);
  else return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
