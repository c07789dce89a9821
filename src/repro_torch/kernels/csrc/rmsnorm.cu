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
// prefill shape (2048 rows x 4096, fp32) that is ~67 MB, ~20 us; at the
// decode shape (4 rows) the 147 KB take ~0.04 us, so there the launch and
// one memory round trip are the whole cost.
//
// What the design does about it:
//   * 16-byte vector accesses of x, out and scale: one block per row of at
//     most 256 threads, each thread with up to 4 accesses (d=4096 fp32)
//     issued before the first is used, so a decode row costs one memory
//     round trip and a prefill SM holds 8 rows.  Each thread keeps its
//     values in registers between the sum of squares and the scale, so
//     every element is read from device memory once and written once, the
//     fusion the Pallas kernel exists for.
//   * A row whose width is not a multiple of the vector, or a pointer that
//     is not aligned for it, takes the same kernel with scalar accesses.
//   * The per-row sum is reduced with warp shuffles and one pass through
//     shared memory.
//
// Interface: plain C, loaded with ctypes.  The kernel launches on the
// caller's stream, allocates nothing, and the entry point returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N values of T read or written as one access of N * sizeof(T) bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// VEC: values per access (16 bytes' worth, or 1 for the scalar form);
// VPT: accesses per thread, a power of two with blockDim.x * VPT * VEC >= d.
template <typename T, int VEC, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  using XV = Vec<T, VEC>;
  const int n_vec = d / VEC;
  const XV* xr = reinterpret_cast<const XV*>(x + (long long)blockIdx.x * d);
  XV* orow = reinterpret_cast<XV*>(out + (long long)blockIdx.x * d);
  const int tid = threadIdx.x;

  float vals[VPT][VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * blockDim.x;
    XV xv = {};
    if (c < n_vec) xv = xr[c];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      vals[i][j] = c < n_vec ? to_float(xv.v[j]) : 0.f;
      ss = fmaf(vals[i][j], vals[i][j], ss);
    }
  }

  __shared__ float warp_sums[kMaxThreads / 32];
  __shared__ float inv_rms;
  const int n_warps = (blockDim.x + 31) / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tid % 32 == 0) warp_sums[tid / 32] = ss;
  __syncthreads();
  if (tid < 32) {
    float t = tid < n_warps ? warp_sums[tid] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (tid == 0) inv_rms = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  const Vec<float, VEC>* sc = reinterpret_cast<const Vec<float, VEC>*>(scale);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * blockDim.x;
    if (c < n_vec) {
      const Vec<float, VEC> s = sc[c];
      XV y;
#pragma unroll
      for (int j = 0; j < VEC; ++j) y.v[j] = from_float<T>(vals[i][j] * r * s.v[j]);
      orow[c] = y;
    }
  }
}

template <typename T, int VEC, int VPT>
cudaError_t launch(const void* x, const float* scale, void* out, long long rows, int d,
                   int threads, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, VEC, VPT><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

// The fewest accesses per thread that cover a row with at most
// max_threads threads; at most 16 values per thread, which covers d <= 8192
// with up to 1024 threads.
template <typename T, int VEC, int VPT = 1>
cudaError_t dispatch_width(const void* x, const float* scale, void* out, long long rows,
                           int d, int max_threads, float eps, cudaStream_t stream) {
  constexpr bool kLast = VPT * VEC >= 16;
  const int n_vec = d / VEC;
  if (n_vec <= (kLast ? kMaxThreads : max_threads) * VPT) {
    const int threads = ((n_vec + VPT - 1) / VPT + 31) / 32 * 32;
    return launch<T, VEC, VPT>(x, scale, out, rows, d, threads, eps, stream);
  }
  if constexpr (!kLast) {
    return dispatch_width<T, VEC, 2 * VPT>(x, scale, out, rows, d, max_threads, eps, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

// Threads per row are capped at 256 for every row count: at the decode
// shape (4 x 4096 fp32) 1024 threads with one access each are no faster on
// an H100, and at the prefill shape (2048 x 4096) they are slower, since a
// 1024-thread block keeps fewer loads in flight per SM.  chip_smoke.py times
// both caps at both shapes; max_threads > 0 forces a cap for that.
constexpr int kRowThreads = 256;

template <typename T>
cudaError_t dispatch(const void* x, const float* scale, void* out, long long rows, int d,
                     float eps, int max_threads, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (max_threads <= 0) max_threads = kRowThreads;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0
                       && reinterpret_cast<uintptr_t>(scale) % (4 * kVec) == 0;
  if (aligned && d % kVec == 0)
    return dispatch_width<T, kVec>(x, scale, out, rows, d, max_threads, eps, stream);
  return dispatch_width<T, 1>(x, scale, out, rows, d, max_threads, eps, stream);
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           long long rows, int d, float eps, int is_bf16,
                           int max_threads, void* stream) {
  if (d <= 0 || rows > 0x7fffffffLL || max_threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(x, sc, out, rows, d, eps, max_threads, s)
                            : dispatch<float>(x, sc, out, rows, d, eps, max_threads, s);
  return (int)err;
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
