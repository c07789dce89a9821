// Flash attention backward for Hopper (sm_90a), fp32 or bf16, GQA folded.
//
// The gradient of flash_attention.cu's function (which replaces
// src/repro/kernels/flash_attention.py, flash_attention_pallas).  The JAX
// package has no backward kernel: it trains through the pure-jnp blocked
// attention and lets XLA differentiate it.  For q (B,Sq,H,hd), k, v
// (B,Sk,KV,hd), the forward's output o and row log-sum-exp lse (B,H,Sq), and
// the output gradient dO, it computes FlashAttention-2's backward:
//
//   D  = rowsum(dO * O)                                  (preprocess kernel)
//   P  = exp(S * scale - lse) on visible keys, 0 elsewhere, S = Q K^T
//   dV = sum over the group's heads of P^T dO
//   dS = P * (dO V^T - D)
//   dK = scale * sum over the group's heads of dS^T Q    (dK/dV kernel)
//   dQ = scale * dS K                                    (dQ kernel)
//
// with the forward's masks: keys at or past Sk, and under causal masking
// keys past the query's position (queries and keys aligned at position 0).
// All sums are fp32; dq, dk, dv are written in the input dtype.
//
// Bound on an H100: by operations.  The backward does 2.5x the forward's
// multiply-adds (dV, dP, dK, dQ and the recomputed S: 5 products of the
// forward's 2, counted once each); at the stablelm-3b training shape (B=2,
// S=512, H=KV=32, hd=80, causal) that is ~6.7 GFLOP against ~42 MB moved,
// 0.10 ms at 67 TFLOP/s fp32.  This first kernel is plain fp32 FMA on the
// CUDA cores; tensor cores (mma/wgmma with the forward's 3xTF32 split) and
// TMA are later work.
//
// Design:
//   * Rows are folded as in the forward: folded row f of KV head kvh is query
//     position f / G and head kvh * G + f % G, so the G query heads of a
//     group share every K/V tile, and a dK/dV block sums over the group's
//     heads in its own loop: no atomics, so the result is deterministic.
//   * dK/dV kernel: one block per (batch x KV head, 32-key tile).  K and V
//     stay in shared memory; the block loops over 32-row tiles of folded
//     query rows, loads Q, dO, lse and D, recomputes S and P, and accumulates
//     dV and dK in registers.  Under causal masking the loop starts at the
//     first tile that can see the key tile.
//   * dQ kernel: one block per (batch x KV head, 32 folded rows).  Q and dO
//     stay in shared memory; the block loops over key tiles up to the last
//     one its rows can see, recomputes S, P, dP and dS, and accumulates dQ
//     in registers.
//   * 256 threads.  In the S and dP products thread t holds row t / 8 and
//     keys t % 8 + 8m (m < 4); in the accumulations it holds row (or key)
//     t / 8 and the 16-byte column chunks t % 8 + 8n.  Tiles are fp32 in
//     shared memory with rows padded to hd + 4 floats, so the 8 threads of a
//     16-byte load phase hit distinct banks; the P and dS tiles have rows of
//     40 floats for the same reason.
//
// Interface: plain C, loaded with ctypes.  The kernels launch on the
// caller's stream and allocate nothing: the caller passes D, a (B,H,Sq)
// fp32 scratch.  The entry point returns cudaGetLastError() so a refused
// launch is reported.  All pointers must be 16-byte aligned (the wrapper
// sees to it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // folded query rows per tile
constexpr int kKeys = 32;      // keys per tile
constexpr int kThreads = 256;  // 8 threads per row of a tile
constexpr int kPS = kKeys + 8; // row stride of the P and dS tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

// Four consecutive values from device memory as fp32 (16 bytes of fp32, 8 of
// bf16), and back.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x), acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z), acc.w = fmaf(a, b.w, acc.w);
}

template <int HD>
struct Tile {
  static constexpr int S = HD + 4;              // padded row stride in floats
  static constexpr int kChunks = HD / 4;        // 16-byte fp32 chunks per row
  static constexpr int kCPT = (kChunks + 7) / 8;  // chunks per thread
  static constexpr size_t kBytes =
      sizeof(float) * (size_t)(2 * kRows * S + 2 * kKeys * S + 2 * kRows * kPS + 2 * kRows);
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(kBytes <= 232448, "tiles do not fit shared memory");
};

// Offset of folded row f's (query f / G, head kvh * G + f % G) first element.
__device__ __forceinline__ long long row_offset(int b, int f, int Sq, int H, int G, int kvh,
                                                int hd) {
  return ((b * (long long)Sq + f / G) * H + kvh * G + f % G) * (long long)hd;
}
// Offset of (b, head, query i) in the (B, H, Sq) lse and D arrays.
__device__ __forceinline__ long long stat_offset(int b, int f, int Sq, int H, int G, int kvh) {
  return ((long long)b * H + kvh * G + f % G) * Sq + f / G;
}

// Rows f0 .. f0 + kRows - 1 of q and dO into shared memory (zeros past
// n_rows), with lse in the log2 domain and D.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* q_s, float* do_s, float* lse_s, float* d_s,
                                          const T* q, const T* dO, const float* lse,
                                          const float* D, int b, int kvh, int f0, int n_rows,
                                          int Sq, int H, int G) {
  using L = Tile<HD>;
  for (int e = threadIdx.x; e < kRows * L::kChunks; e += kThreads) {
    const int r = e / L::kChunks, c = e % L::kChunks;
    const int f = f0 + r;
    float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), dv = qv;
    if (f < n_rows) {
      const long long off = row_offset(b, f, Sq, H, G, kvh, HD) + 4 * c;
      qv = ld4(q + off);
      dv = ld4(dO + off);
    }
    st4(q_s + r * L::S + 4 * c, qv);
    st4(do_s + r * L::S + 4 * c, dv);
  }
  if (threadIdx.x < kRows) {
    const int f = f0 + threadIdx.x;
    const bool ok = f < n_rows;
    lse_s[threadIdx.x] = ok ? lse[stat_offset(b, f, Sq, H, G, kvh)] * kLog2e : 0.f;
    d_s[threadIdx.x] = ok ? D[stat_offset(b, f, Sq, H, G, kvh)] : 0.f;
  }
}

// Keys j0 .. j0 + kKeys - 1 of k and v into shared memory (zeros past Sk).
template <typename T, int HD>
__device__ __forceinline__ void load_keys(float* k_s, float* v_s, const T* k, const T* v,
                                          int b, int kvh, int j0, int Sk, int KV) {
  using L = Tile<HD>;
  for (int e = threadIdx.x; e < kKeys * L::kChunks; e += kThreads) {
    const int j = e / L::kChunks, c = e % L::kChunks;
    const int key = j0 + j;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (key < Sk) {
      const long long off = ((b * (long long)Sk + key) * KV + kvh) * HD + 4 * c;
      kv = ld4(k + off);
      vv = ld4(v + off);
    }
    st4(k_s + j * L::S + 4 * c, kv);
    st4(v_s + j * L::S + 4 * c, vv);
  }
}

// P and dS of this thread's row t / 8 and keys t % 8 + 8m of the tile:
// S = Q K^T and dP = dO V^T from shared memory, then the masks.
template <int HD>
__device__ __forceinline__ void probs(float (&p)[4], float (&ds)[4], const float* q_s,
                                      const float* do_s, const float* k_s, const float* v_s,
                                      const float* lse_s, const float* d_s, int f0, int j0,
                                      int n_rows, int Sk, int G, int causal, float scale_log2) {
  using L = Tile<HD>;
  const int r = threadIdx.x / 8, jt = threadIdx.x % 8;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 qa = ld4(q_s + r * L::S + d);
    const float4 da = ld4(do_s + r * L::S + d);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      s[m] = dot4(qa, ld4(k_s + (jt + 8 * m) * L::S + d), s[m]);
      dp[m] = dot4(da, ld4(v_s + (jt + 8 * m) * L::S + d), dp[m]);
    }
  }
  const int f = f0 + r;
  const int qpos = f / G;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int key = j0 + jt + 8 * m;
    const bool ok = f < n_rows && key < Sk && (!causal || key <= qpos);
    p[m] = ok ? exp2f(fmaf(s[m], scale_log2, -lse_s[r])) : 0.f;
    ds[m] = p[m] * (dp[m] - d_s[r]);
  }
}

// D = rowsum(dO * O) for every (b, query, head), one warp per row, written
// in the (B, H, Sq) layout of lse.
template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                                     float* __restrict__ D, long long n_rows, int Sq, int H,
                                     int hd) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int c = lane; c < hd / 4; c += 32)
    acc = dot4(ld4(o + row * hd + 4 * c), ld4(dO + row * hd + 4 * c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long bi = row / H;  // b * Sq + i
    const int h = (int)(row % H);
    D[(bi / Sq * H + h) * Sq + bi % Sq] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ D,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                      int causal, float scale) {
  using L = Tile<HD>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kKeys * L::S;
  float* q_s = v_s + kKeys * L::S;
  float* do_s = q_s + kRows * L::S;
  float* p_s = do_s + kRows * L::S;
  float* ds_s = p_s + kRows * kPS;
  float* lse_s = ds_s + kRows * kPS;
  float* d_s = lse_s + kRows;

  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int j0 = blockIdx.y * kKeys;
  const int n_rows = Sq * G;
  const float scale_log2 = scale * kLog2e;
  load_keys<T, HD>(k_s, v_s, k, v, b, kvh, j0, Sk, KV);

  // This thread's key row and column chunks of dK and dV.
  const int jr = threadIdx.x / 8, ct = threadIdx.x % 8;
  float4 dk_acc[L::kCPT], dv_acc[L::kCPT];
#pragma unroll
  for (int n = 0; n < L::kCPT; ++n)
    dk_acc[n] = dv_acc[n] = make_float4(0.f, 0.f, 0.f, 0.f);

  // Under causal masking folded rows before j0 * G see none of these keys.
  const int f_begin = causal ? (int)(((long long)j0 * G) / kRows * kRows) : 0;
  for (int f0 = f_begin; f0 < n_rows; f0 += kRows) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, HD>(q_s, do_s, lse_s, d_s, q, dO, lse, D, b, kvh, f0, n_rows, Sq, H, G);
    __syncthreads();
    float p[4], ds[4];
    probs<HD>(p, ds, q_s, do_s, k_s, v_s, lse_s, d_s, f0, j0, n_rows, Sk, G, causal,
              scale_log2);
    const int r = threadIdx.x / 8;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      p_s[r * kPS + ct + 8 * m] = p[m];
      ds_s[r * kPS + ct + 8 * m] = ds[m];
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the tile's rows.
#pragma unroll 2
    for (int rr = 0; rr < kRows; ++rr) {
      const float pv = p_s[rr * kPS + jr], dsv = ds_s[rr * kPS + jr];
#pragma unroll
      for (int n = 0; n < L::kCPT; ++n) {
        const int c = ct + 8 * n;
        if (c < L::kChunks) {
          fma4(dv_acc[n], pv, ld4(do_s + rr * L::S + 4 * c));
          fma4(dk_acc[n], dsv, ld4(q_s + rr * L::S + 4 * c));
        }
      }
    }
  }

  const int key = j0 + jr;
  if (key < Sk) {
    const long long off = ((b * (long long)Sk + key) * KV + kvh) * HD;
#pragma unroll
    for (int n = 0; n < L::kCPT; ++n) {
      const int c = ct + 8 * n;
      if (c < L::kChunks) {
        float4 x = dk_acc[n];
        x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
        st4(dk + off + 4 * c, x);
        st4(dv + off + 4 * c, dv_acc[n]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    T* __restrict__ dq, int Sq, int Sk, int H, int KV, int causal,
                    float scale) {
  using L = Tile<HD>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kKeys * L::S;
  float* q_s = v_s + kKeys * L::S;
  float* do_s = q_s + kRows * L::S;
  float* ds_s = do_s + kRows * L::S;
  float* lse_s = ds_s + 2 * kRows * kPS;  // the layout of the dK/dV kernel
  float* d_s = lse_s + kRows;

  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int n_rows = Sq * G;
  // Row tiles run longest first: under causal masking the last rows see the
  // most key tiles.
  const int f0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const float scale_log2 = scale * kLog2e;
  load_rows<T, HD>(q_s, do_s, lse_s, d_s, q, dO, lse, D, b, kvh, f0, n_rows, Sq, H, G);

  int n_kv = (Sk + kKeys - 1) / kKeys;
  if (causal) n_kv = min(n_kv, (min(f0 + kRows, n_rows) - 1) / G / kKeys + 1);

  const int r = threadIdx.x / 8, ct = threadIdx.x % 8;
  float4 dq_acc[L::kCPT];
#pragma unroll
  for (int n = 0; n < L::kCPT; ++n) dq_acc[n] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_kv; ++t) {
    __syncthreads();  // the previous tile's readers are done
    load_keys<T, HD>(k_s, v_s, k, v, b, kvh, t * kKeys, Sk, KV);
    __syncthreads();
    float p[4], ds[4];
    probs<HD>(p, ds, q_s, do_s, k_s, v_s, lse_s, d_s, f0, t * kKeys, n_rows, Sk, G, causal,
              scale_log2);
#pragma unroll
    for (int m = 0; m < 4; ++m) ds_s[r * kPS + ct + 8 * m] = ds[m];
    __syncthreads();
    // dQ += dS K over the tile's keys.
#pragma unroll 2
    for (int j = 0; j < kKeys; ++j) {
      const float dsv = ds_s[r * kPS + j];
#pragma unroll
      for (int n = 0; n < L::kCPT; ++n) {
        const int c = ct + 8 * n;
        if (c < L::kChunks) fma4(dq_acc[n], dsv, ld4(k_s + j * L::S + 4 * c));
      }
    }
  }

  const int f = f0 + r;
  if (f < n_rows) {
    const long long off = row_offset(b, f, Sq, H, G, kvh, HD);
#pragma unroll
    for (int n = 0; n < L::kCPT; ++n) {
      const int c = ct + 8 * n;
      if (c < L::kChunks) {
        float4 x = dq_acc[n];
        x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
        st4(dq + off + 4 * c, x);
      }
    }
  }
}

template <typename K>
cudaError_t configure(K kernel, size_t smem, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) configured[dev] = true;
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dO, void* dq, void* dk, void* dv, float* D,
                   int B, int Sq, int Sk, int H, int KV, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::kBytes;
  static bool dkdv_configured[kMaxDevices] = {};
  static bool dq_configured[kMaxDevices] = {};
  auto dkdv = flash_bwd_dkdv_kernel<T, HD>;
  auto dqk = flash_bwd_dq_kernel<T, HD>;
  cudaError_t err = configure(dkdv, smem, dkdv_configured);
  if (err != cudaSuccess) return err;
  err = configure(dqk, smem, dq_configured);
  if (err != cudaSuccess) return err;

  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dO);
  const long long rows = (long long)B * Sq * H;
  constexpr int kDotWarps = 8;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + kDotWarps - 1) / kDotWarps), 32 * kDotWarps, 0,
                            stream>>>(static_cast<const T*>(o), dot, D, rows, Sq, H, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int key_tiles = (Sk + kKeys - 1) / kKeys;
  const long long row_tiles = ((long long)Sq * (H / KV) + kRows - 1) / kRows;
  if (key_tiles > 65535 || row_tiles > 65535) return cudaErrorInvalidValue;
  if (key_tiles > 0) {
    dkdv<<<dim3((unsigned)(B * KV), (unsigned)key_tiles), kThreads, smem, stream>>>(
        qt, kt, vt, dot, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV,
        causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dqk<<<dim3((unsigned)(B * KV), (unsigned)row_tiles), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dq), Sq, Sk, H, KV, causal, scale);
  return cudaGetLastError();
}

// One instantiation per head dim the forward has: 16, 32, 64, 80, 128, 160.
template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const void* o,
                        const float* lse, const void* dO, void* dq, void* dk, void* dv,
                        float* D, int B, int Sq, int Sk, int H, int KV, int hd, int causal,
                        float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Sk, H, KV, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Sk, H, KV, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Sk, H, KV, causal, scale, s);
    case 80: return launch<T, 80>(q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Sk, H, KV, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Sk, H, KV, causal, scale, s);
    case 160: return launch<T, 160>(q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Sk, H, KV, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dO, void* dq, void* dk,
                                   void* dv, void* D, int B, int Sq, int Sk, int H, int KV,
                                   int hd, int causal, float scale, int is_bf16,
                                   void* stream) {
  if (KV <= 0 || H % KV != 0 || (long long)Sq * (H / KV) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;  // the wrapper zeroes dk and dv
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  cudaError_t err =
      is_bf16 ? dispatch_hd<__nv_bfloat16>(q, k, v, o, l, dO, dq, dk, dv, d, B, Sq, Sk, H, KV,
                                           hd, causal, scale, s)
              : dispatch_hd<float>(q, k, v, o, l, dO, dq, dk, dv, d, B, Sq, Sk, H, KV, hd,
                                   causal, scale, s);
  return (int)err;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
