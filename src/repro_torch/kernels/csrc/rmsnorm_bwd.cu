// RMSNorm backward for Hopper (sm_90a), fp32 or bf16.
//
// The gradient of rmsnorm.cu's function (which replaces
// src/repro/kernels/rmsnorm.py, rmsnorm_pallas): y = x * r * s with
// r = rsqrt(mean(x^2) + eps) per row.  The JAX package has no backward
// kernel: it trains through the jnp RMSNorm and lets XLA differentiate it.
// For the output gradient dy it computes, in fp32,
//
//   dx     = r * (dy * s) - x * r^3 * sum(dy * s * x) / d   (per row)
//   dscale = sum over rows of dy * x * r                   (per column)
//
// dx in x's dtype, dscale in the scale parameter's dtype (fp32 or bf16).
//
// Bound on an H100: by bytes.  It reads x and dy and writes dx once, 3
// element accesses against ~11 operations per element, far below the card's
// ~20 operations per byte; at the stablelm-3b training shape (1024 rows x
// 2560, fp32) that is ~31 MB, ~9.4 us at 3.35 TB/s.
//
// Design:
//   * dx: as the forward, each thread holds up to 16 values of x and dy of
//     a row in registers (16-byte accesses, or scalar ones for a width or
//     pointer off the vector grid), so each is read from device memory once;
//     the row's two sums (x^2 and dy*s*x) are reduced together with warp
//     shuffles and one pass through shared memory.
//   * A block walks a contiguous run of rows, and loads its next row while
//     it reduces and writes the current one, so each thread keeps two rows'
//     loads in flight.  The wrapper launches two blocks per SM (at most one
//     per row): ~40 KB of loads in flight per SM at the training shape.
//   * dscale: each block keeps its columns' sums over its rows in registers
//     and writes them as one fp32 row of a (blocks, d) scratch, 2.7 MB at
//     the training shape (264 blocks).  A second kernel sums the scratch's
//     columns with every SM taking part: a block of 256 threads takes 16
//     columns, 16 threads a column each sum every 16th scratch row in row
//     order, and a fixed tree in shared memory adds their 16 sums (160
//     blocks at d = 2560).  No atomics, so the result is deterministic.
//
// Interface: plain C, loaded with ctypes.  The kernels launch on the
// caller's stream and allocate nothing (the caller passes the scratch), and
// the entry point returns cudaGetLastError() so a refused launch is
// reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// At most 16 values per thread in each of six register arrays (x and dy of
// this row and of the next, scale and the dscale sums) cover d <= 8192 with
// 512 threads; a bound of 512 threads lets the compiler give each thread 128
// registers, where 1024 (64 registers) made the 16-value instances spill.
constexpr int kMaxThreads = 512;

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
// VPT: accesses per thread, with blockDim.x * VPT * VEC >= d.
template <typename T, int VEC, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int d, float eps) {
  using XV = Vec<T, VEC>;
  using FV = Vec<float, VEC>;
  const int n_vec = d / VEC;
  const int tid = threadIdx.x;

  float s[VPT][VEC], acc[VPT][VEC];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * blockDim.x;
    FV sv = {};
    if (c < n_vec) sv = reinterpret_cast<const FV*>(scale)[c];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[i][j] = sv.v[j], acc[i][j] = 0.f;
  }

  __shared__ float2 warp_sums[kMaxThreads / 32];
  __shared__ float2 total;
  const int n_warps = (blockDim.x + 31) / 32;
  // This block's rows, and the next row's values loaded ahead.
  const long long r_end = rows * (blockIdx.x + 1) / gridDim.x;
  long long row = rows * blockIdx.x / gridDim.x;
  XV xn[VPT] = {}, gn[VPT] = {};
  auto load_row = [&](long long r) {
    const XV* xr = reinterpret_cast<const XV*>(x + r * d);
    const XV* gr = reinterpret_cast<const XV*>(dy + r * d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * blockDim.x;
      if (c < n_vec) xn[i] = xr[c], gn[i] = gr[c];
    }
  };
  if (row < r_end) load_row(row);
  for (; row < r_end; ++row) {
    float xv[VPT][VEC], gv[VPT][VEC];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * blockDim.x;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        xv[i][j] = c < n_vec ? to_float(xn[i].v[j]) : 0.f;
        gv[i][j] = c < n_vec ? to_float(gn[i].v[j]) : 0.f;
        ss = fmaf(xv[i][j], xv[i][j], ss);
        dot = fmaf(gv[i][j] * s[i][j], xv[i][j], dot);
      }
    }
    if (row + 1 < r_end) load_row(row + 1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    if (tid % 32 == 0) warp_sums[tid / 32] = make_float2(ss, dot);
    __syncthreads();
    if (tid < 32) {
      float2 t = tid < n_warps ? warp_sums[tid] : make_float2(0.f, 0.f);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        t.x += __shfl_xor_sync(0xffffffffu, t.x, off);
        t.y += __shfl_xor_sync(0xffffffffu, t.y, off);
      }
      if (tid == 0) total = t;
    }
    __syncthreads();
    const float r = rsqrtf(total.x / (float)d + eps);
    const float c1 = r * r * r * (total.y / (float)d);

    XV* out = reinterpret_cast<XV*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * blockDim.x;
      if (c < n_vec) {
        XV y;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          y.v[j] = from_float<T>(r * (gv[i][j] * s[i][j]) - xv[i][j] * c1);
          acc[i][j] = fmaf(gv[i][j] * xv[i][j], r, acc[i][j]);
        }
        out[c] = y;
      }
    }
  }

  FV* prow = reinterpret_cast<FV*>(partial + (long long)blockIdx.x * d);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * blockDim.x;
    if (c < n_vec) {
      FV a;
#pragma unroll
      for (int j = 0; j < VEC; ++j) a.v[j] = acc[i][j];
      prow[c] = a;
    }
  }
}

// dscale[c] = sum over the scratch's rows of partial[p][c], in a fixed
// order: thread (c, gy) of a block sums rows gy, gy + kGroups, ... in row
// order, and a fixed tree in shared memory adds the kGroups sums.
constexpr int kCols = 16, kGroups = 16;  // columns and row groups of a block

template <typename S>
__global__ void __launch_bounds__(kCols * kGroups)
rmsnorm_bwd_colsum_kernel(const float* __restrict__ partial, int n_parts, int d,
                          S* __restrict__ dscale) {
  __shared__ float sums[kGroups][kCols + 1];
  const int cx = threadIdx.x % kCols, gy = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + cx;
  float acc = 0.f;
  if (c < d)
    for (int p = gy; p < n_parts; p += kGroups) acc += partial[(long long)p * d + c];
  sums[gy][cx] = acc;
  __syncthreads();
#pragma unroll
  for (int half = kGroups / 2; half > 0; half >>= 1) {
    if (gy < half) sums[gy][cx] += sums[gy + half][cx];
    __syncthreads();
  }
  if (gy == 0 && c < d) dscale[c] = from_float<S>(sums[0][cx]);
}

template <typename T, int VEC, int VPT>
cudaError_t launch(const void* x, const float* scale, const void* dy, void* dx,
                   float* partial, int n_parts, long long rows, int d, int threads, float eps,
                   cudaStream_t stream) {
  rmsnorm_bwd_kernel<T, VEC, VPT><<<(unsigned)n_parts, threads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy), static_cast<T*>(dx),
      partial, rows, d, eps);
  return cudaGetLastError();
}

// The fewest accesses per thread that cover a row with at most 256 threads,
// up to 16 values per thread (then up to 512 threads): d <= 8192.
template <typename T, int VEC, int VPT = 1>
cudaError_t dispatch_width(const void* x, const float* scale, const void* dy, void* dx,
                           float* partial, int n_parts, long long rows, int d, float eps,
                           cudaStream_t stream) {
  constexpr bool kLast = VPT * VEC >= 16;
  constexpr int kRowThreads = 256;
  const int n_vec = d / VEC;
  if (n_vec <= (kLast ? kMaxThreads : kRowThreads) * VPT) {
    const int threads = ((n_vec + VPT - 1) / VPT + 31) / 32 * 32;
    return launch<T, VEC, VPT>(x, scale, dy, dx, partial, n_parts, rows, d, threads, eps,
                               stream);
  }
  if constexpr (!kLast) {
    return dispatch_width<T, VEC, 2 * VPT>(x, scale, dy, dx, partial, n_parts, rows, d, eps,
                                           stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const float* scale, const void* dy, void* dx,
                     float* partial, int n_parts, long long rows, int d, float eps,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dx)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(partial)) %
              (4 * kVec) == 0;
  if (aligned && d % kVec == 0)
    return dispatch_width<T, kVec>(x, scale, dy, dx, partial, n_parts, rows, d, eps, stream);
  return dispatch_width<T, 1>(x, scale, dy, dx, partial, n_parts, rows, d, eps, stream);
}

}  // namespace

// partial: an fp32 scratch of n_parts x d, 1 <= n_parts <= rows.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* dscale, void* partial, int n_parts, long long rows, int d,
                           float eps, int is_bf16, int scale_is_bf16, void* stream) {
  if (d <= 0 || rows > 0x7fffffffLL || n_parts < 1 || n_parts > rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* part = static_cast<float*>(partial);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, sc, dy, dx, part, n_parts, rows, d, eps, s)
              : dispatch<float>(x, sc, dy, dx, part, n_parts, rows, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((d + kCols - 1) / kCols);
  if (scale_is_bf16)
    rmsnorm_bwd_colsum_kernel<__nv_bfloat16><<<blocks, kCols * kGroups, 0, s>>>(
        part, n_parts, d, static_cast<__nv_bfloat16*>(dscale));
  else
    rmsnorm_bwd_colsum_kernel<float><<<blocks, kCols * kGroups, 0, s>>>(
        part, n_parts, d, static_cast<float*>(dscale));
  return (int)cudaGetLastError();
}

extern "C" const char* rmsnorm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
