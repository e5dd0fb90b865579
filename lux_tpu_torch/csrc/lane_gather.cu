// Per-row lane shuffle out[r, c] = x[r, idx[r, c]] on (R, 128), for sm_90a.
//
// Replaces: lux_tpu/ops/pallas_shuffle.py lane_gather (kernel body
// _lane_kernel), the TPU lane-axis dynamic gather that is one unfused Benes
// pass of the routed pull and one level of its fill-forward.
//
// What bounds it on the H100: memory.  Per element it reads the value (4 or
// 2 bytes) and its index (1 byte as uint8, 4 as int32) and writes the value;
// there is no arithmetic but address math.  So the bound is
// R * 128 * (2 * esize + isize) bytes over 3.35 TB/s.
//
// Design: one warp per row, grid-striding over rows.  Each lane loads four
// consecutive indices as one vector, reads its four values from the row in
// device memory (the 512-byte row is touched by the whole warp, so after
// the first sectors arrive the rest hit in L1), and stores four values as
// one vector.  Any R >= 1 works: the reference's tiling of R < 8 up to a
// full (8, 128) tile is a Mosaic constraint with no counterpart here.  Index
// values are promised to be < 128 (the planners assert it) and are not
// checked on the card.
#include "lux_shuffle.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const T* __restrict__ x, const I* __restrict__ idx, T* __restrict__ out,
                   long long rows) {
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const int lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); r < rows;
       r += warps) {
    const long long off = r * kLane + lane * 4;
    int ix[4];
    Idx4<I>::load(idx + off, ix);
    const T* xr = x + r * kLane;
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(xr + ix[j]);
    Vec4<T>::store(out + off, v);
  }
}

template <typename T, typename I>
void launch(const void* x, const void* idx, long long rows, void* out, cudaStream_t stream) {
  const long long want = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = (int)(want < 132 * 16 ? want : 132 * 16);
  lane_gather_kernel<T, I><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const I*>(idx), static_cast<T*>(out), rows);
}

}  // namespace

// esize: 4 (float32, int32) or 2 (bfloat16); isize: 1 (uint8) or 4 (int32).
// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for an unsupported size or rows < 1.
extern "C" int lux_lane_gather(const void* x, int esize, const void* idx, int isize,
                               long long rows, void* out, void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (esize == 4 && isize == 1) launch<uint32_t, uint8_t>(x, idx, rows, out, s);
  else if (esize == 4 && isize == 4) launch<uint32_t, int32_t>(x, idx, rows, out, s);
  else if (esize == 2 && isize == 1) launch<uint16_t, uint8_t>(x, idx, rows, out, s);
  else if (esize == 2 && isize == 4) launch<uint16_t, int32_t>(x, idx, rows, out, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
