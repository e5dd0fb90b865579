// Per-column sublane shuffle out[s, l] = x[idx[s, l], l] on (d <= 8, L),
// for sm_90a.
//
// Replaces: lux_tpu/ops/pallas_shuffle.py sublane_gather (kernel body
// _sublane_kernel), the TPU gather within one vreg of sublanes that serves
// the small-digit passes of routes over fewer than 128 elements.
//
// What bounds it on the H100: memory, d * L * (2 * esize + isize) bytes.
//
// Design: one thread per column l.  It reads the column's d values (row s
// of every thread is one coalesced access across the warp) into registers,
// then for each s reads idx[s, l], picks the value with an unrolled select
// (a dynamically indexed register array would spill to local memory), and
// writes out[s, l], again coalesced.  Index values are promised < d.
#include "lux_shuffle.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 8;

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
sublane_gather_kernel(const T* __restrict__ x, const I* __restrict__ idx, T* __restrict__ out,
                      int d, long long length) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long l = (long long)blockIdx.x * kThreads + threadIdx.x; l < length; l += stride) {
    T v[kMaxD];
#pragma unroll
    for (int s = 0; s < kMaxD; ++s) v[s] = s < d ? x[s * length + l] : T(0);
#pragma unroll
    for (int s = 0; s < kMaxD; ++s) {
      if (s < d) {
        const int k = (int)idx[s * length + l];
        T pick = v[0];
#pragma unroll
        for (int j = 1; j < kMaxD; ++j) pick = k == j ? v[j] : pick;
        out[s * length + l] = pick;
      }
    }
  }
}

template <typename T, typename I>
void launch(const void* x, const void* idx, int d, long long length, void* out,
            cudaStream_t stream) {
  const long long want = (length + kThreads - 1) / kThreads;
  const int grid = (int)(want < 132 * 16 ? want : 132 * 16);
  sublane_gather_kernel<T, I><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const I*>(idx), static_cast<T*>(out), d, length);
}

}  // namespace

// esize: 4 or 2; isize: 1 or 4; 1 <= d <= 8.  Returns cudaGetLastError()
// after the launch (0 = launched); cudaErrorInvalidValue for bad sizes.
extern "C" int lux_sublane_gather(const void* x, int esize, const void* idx, int isize, int d,
                                  long long length, void* out, void* stream) {
  if (d < 1 || d > kMaxD || length < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (esize == 4 && isize == 1) launch<uint32_t, uint8_t>(x, idx, d, length, out, s);
  else if (esize == 4 && isize == 4) launch<uint32_t, int32_t>(x, idx, d, length, out, s);
  else if (esize == 2 && isize == 1) launch<uint16_t, uint8_t>(x, idx, d, length, out, s);
  else if (esize == 2 && isize == 4) launch<uint16_t, int32_t>(x, idx, d, length, out, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
