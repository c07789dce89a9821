// Fused RMSNorm for Hopper (sm_90a), fp32 or bf16 in.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas (the
// pl.pallas_call) and its body _rmsnorm_kernel.  Same function:
// x * rsqrt(mean(x^2) + eps) * scale over the last axis, in fp32 math, cast
// back to x's dtype.  The TPU kernel pads rows to a row-block multiple; here
// every row is its own block, so nothing is padded.
//
// Bound on an H100: by bytes.  It does ~4 operations per element against 8
// bytes moved in fp32 (read x once, write y once), far below the card's
// ~20 operations per byte at 3.35 TB/s and 67 TFLOP/s.  At the serving
// prefill shape (2048 rows x 4096, fp32) that is ~67 MB, ~20 us.
//
// What the design does about it: one 256-thread block per row.  Each thread
// keeps its d/256 values in registers between the sum of squares and the
// scale, so every element is read from device memory once and written once,
// the fusion the Pallas kernel exists for.  Neighbouring threads touch
// neighbouring addresses, so every load and store is coalesced.  The
// per-row sum is reduced with warp shuffles and one pass through shared
// memory.
//
// Interface: plain C, loaded with ctypes.  The kernel launches on the
// caller's stream, allocates nothing, and the entry point returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VPT: values per thread, the smallest power of two with 256 * VPT >= d.
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  const T* xr = x + (long long)blockIdx.x * d;
  T* orow = out + (long long)blockIdx.x * d;
  const int tid = threadIdx.x;

  float vals[VPT];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * kThreads;
    vals[i] = c < d ? to_float(xr[c]) : 0.f;
    ss = fmaf(vals[i], vals[i], ss);
  }

  __shared__ float warp_sums[kWarps];
  __shared__ float inv_rms;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tid % 32 == 0) warp_sums[tid / 32] = ss;
  __syncthreads();
  if (tid < 32) {
    float t = tid < kWarps ? warp_sums[tid] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (tid == 0) inv_rms = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * kThreads;
    if (c < d) orow[c] = from_float<T>(vals[i] * r * scale[c]);
  }
}

template <typename T, int VPT>
cudaError_t launch(const void* x, const float* scale, void* out, long long rows,
                   int d, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, VPT><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_width(const void* x, const float* scale, void* out,
                           long long rows, int d, float eps, cudaStream_t stream) {
  if (d <= kThreads * 1) return launch<T, 1>(x, scale, out, rows, d, eps, stream);
  if (d <= kThreads * 2) return launch<T, 2>(x, scale, out, rows, d, eps, stream);
  if (d <= kThreads * 4) return launch<T, 4>(x, scale, out, rows, d, eps, stream);
  if (d <= kThreads * 8) return launch<T, 8>(x, scale, out, rows, d, eps, stream);
  if (d <= kThreads * 16) return launch<T, 16>(x, scale, out, rows, d, eps, stream);
  if (d <= kThreads * 32) return launch<T, 32>(x, scale, out, rows, d, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           long long rows, int d, float eps, int is_bf16,
                           void* stream) {
  if (d <= 0 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  cudaError_t err = is_bf16 ? dispatch_width<__nv_bfloat16>(x, sc, out, rows, d, eps, s)
                            : dispatch_width<float>(x, sc, out, rows, d, eps, s);
  return (int)err;
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
