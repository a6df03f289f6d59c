// Fused RMSNorm for Hopper.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas
//           (body _rmsnorm_kernel).
// Computes: out = x * rsqrt(mean(x^2) + eps) * (1 + scale), statistics in
//           f32, result cast back to x's dtype.  x is (T, D) row-major.
//
// Bound: device-memory bytes (one read of x, one write of out, ~4 flops per
// element).  Design: one block per row, so a ragged T needs no row-block
// halving; threads stride the row with neighbouring threads on neighbouring
// addresses, reduce the sum of squares with warp shuffles and one shared
// array, then re-read the row (it is in L1/L2 by then) to scale and store.
#include "common.cuh"

namespace {

template <typename T, typename S>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                               T* __restrict__ out, int D, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* orow = out + row * D;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = rt::to_f32(xr[i]);
    ss += v * v;
  }
  ss = rt::warp_sum(ss);

  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    float v = lane < n_warps ? warp_sums[lane] : 0.f;
    v = rt::warp_sum(v);
    if (lane == 0) warp_sums[0] = v;
  }
  __syncthreads();

  const float inv = rsqrtf(warp_sums[0] / static_cast<float>(D) + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float y = rt::to_f32(xr[i]) * inv * (1.f + rt::to_f32(scale[i]));
    orow[i] = rt::from_f32<T>(y);
  }
}

template <typename T, typename S>
void launch(const void* x, const void* scale, void* out, long long T_rows, int D, float eps,
            cudaStream_t stream) {
  const int threads = D >= 2048 ? 256 : (D >= 256 ? 128 : 32);
  rmsnorm_kernel<T, S><<<static_cast<unsigned>(T_rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), D, eps);
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, long long T_rows, int D,
                           float eps, int x_dtype, int s_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == rt::BF16 && s_dtype == rt::BF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, T_rows, D, eps, st);
  else if (x_dtype == rt::BF16 && s_dtype == rt::F32)
    launch<__nv_bfloat16, float>(x, scale, out, T_rows, D, eps, st);
  else if (x_dtype == rt::F32 && s_dtype == rt::BF16)
    launch<float, __nv_bfloat16>(x, scale, out, T_rows, D, eps, st);
  else if (x_dtype == rt::F32 && s_dtype == rt::F32)
    launch<float, float>(x, scale, out, T_rows, D, eps, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
