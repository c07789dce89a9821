// Flash attention forward for Hopper (sm_90a), fp32 or bf16 in, GQA folded.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (the pl.pallas_call) and its body _flash_kernel.  Same function: causal or
// full attention of q (B,Sq,H,hd) over k, v (B,Sk,KV,hd) with scale
// 1/sqrt(hd), online softmax with an fp32 accumulator, running max and
// running sum, keys at or past Sk masked, output acc / max(l, 1e-30) in the
// input dtype.  Unlike the TPU kernel it takes ragged Sq and Sk: rows and
// keys past the end are masked here, so callers need not pad.
//
// Bound on an H100: at the serving prefill shape (B=4, S=512, H=32, KV=4,
// hd=128, causal, fp32) the work is ~8.6 GFLOP against ~75 MB moved, so it
// is bound by operations, not bytes: fp32 has no tensor-core path without
// TF32, which leaves the CUDA cores' 67 TFLOP/s.
//
// What the design does about it:
//   * One thread block per (batch x KV head, tile of 64 folded query rows).
//     A folded row is (query position, head within the group), the Pallas
//     kernel's GQA folding: the G query heads of a group share every K/V
//     tile staged in shared memory, so K/V are read once per group.
//   * A loop over 64-key tiles inside the block takes the place of the
//     TPU's sequential kv grid axis.  Under causal masking the loop stops at
//     the last tile any row of the block can see, so fully masked tiles
//     cost nothing.
//   * Both products are register-blocked SIMT: each of the 256 threads owns
//     4 rows x 4 keys of the score tile and 4 rows x hd/16 columns of the
//     fp32 accumulator, so every shared-memory value loaded feeds 4 FMAs.
//     Row max and row sum are reduced with warp shuffles across the 16
//     threads that share a row.  Padded row strides keep the q/k reads free
//     of bank conflicts.
//   * Tensor cores (wgmma), TMA and warp specialisation are later work; in
//     fp32 they would also need TF32, which changes the numbers.
//
// Interface: plain C, loaded with ctypes.  The kernel launches on the
// caller's stream, allocates nothing, and the entry point returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;          // folded query rows per block
constexpr int kKeys = 64;          // keys per kv tile
constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kRowsPerThread = kRows / 16;
constexpr int kKeysPerThread = kKeys / 16;
constexpr float kNegInf = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // q tile and k tile with a padded stride, v tile, probability tile
  return sizeof(float) * (size_t)(kRows * (HD + 1) + kKeys * (HD + 1) + kKeys * HD +
                                  kRows * (kKeys + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, int causal, float scale) {
  constexpr int QS = HD + 1;        // padded stride of the q and k tiles
  constexpr int PS = kKeys + 1;     // padded stride of the probability tile
  constexpr int DPT = HD / 16;      // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                // kRows x QS
  float* k_s = q_s + kRows * QS;    // kKeys x QS
  float* v_s = k_s + kKeys * QS;    // kKeys x HD
  float* p_s = v_s + kKeys * HD;    // kRows x PS

  const int G = H / KV;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const long long n_rows = (long long)Sq * G;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int tx = tid % 16;          // key / column index within the thread grid
  const int ty = tid / 16;          // row index within the thread grid

  // Stage the q tile.  Folded row r is query position (row0 + r) / G and
  // head kvh * G + (row0 + r) % G; consecutive rows of one position are
  // consecutive heads, so a position's G*HD values are contiguous.
  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const long long f = row0 + r;
    float val = 0.f;
    if (f < n_rows) {
      const long long qpos = f / G;
      const int h = kvh * G + (int)(f % G);
      val = to_float(q[((b * (long long)Sq + qpos) * H + h) * HD + d]);
    }
    q_s[r * QS + d] = val;
  }

  int qpos[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) qpos[i] = (int)((row0 + ty + 16 * i) / G);

  const int n_kv_all = (Sk + kKeys - 1) / kKeys;
  int n_kv = n_kv_all;
  if (causal) {
    const long long last = (row0 + kRows < n_rows ? row0 + kRows : n_rows) - 1;
    const int q_max = (int)(last / G);
    n_kv = min(n_kv_all, q_max / kKeys + 1);
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][DPT];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the previous tile's readers are done with k_s, v_s, p_s
    for (int e = tid; e < kKeys * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const int kp = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (kp < Sk) {
        const long long off = ((b * (long long)Sk + kp) * KV + kvh) * HD + d;
        kval = to_float(k[off]);
        vval = to_float(v[off]);
      }
      k_s[j * QS + d] = kval;
      v_s[j * HD + d] = vval;
    }
    __syncthreads();

    // s = q k^T for this thread's 4 rows x 4 keys.
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = q_s[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) kv[j] = k_s[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Online softmax.  The 16 threads of a row are lanes 0-15 or 16-31 of
    // one warp, so xor shuffles by 8, 4, 2, 1 reduce exactly one row.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      bool ok[kKeysPerThread];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < Sk && (!causal || kp <= qpos[i]);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += p v for this thread's 4 rows x HD/16 columns.
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = p_s[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const float vv = v_s[j * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const long long f = row0 + ty + 16 * i;
    if (f >= n_rows) continue;
    const int h = kvh * G + (int)(f % G);
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + ((b * (long long)Sq + qpos[i]) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c) out[tx + 16 * c] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, int KV, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_rows = (long long)Sq * (H / KV);
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)(B * KV));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KV, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int KV, int hd, int causal,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H, int KV,
                                   int hd, int causal, float scale, int is_bf16,
                                   void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch_hd<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s)
              : dispatch_hd<float>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
