// Flash attention forward for Hopper (sm_90a), fp32 or bf16 in, GQA folded.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (the pl.pallas_call) and its body _flash_kernel.  Same function: causal or
// full attention of q (B,Sq,H,hd) over k, v (B,Sk,KV,hd) with scale
// 1/sqrt(hd), online softmax with an fp32 accumulator, running max and
// running sum, keys at or past Sk masked, output acc / max(l, 1e-30) in the
// input dtype.  Unlike the TPU kernel it takes ragged Sq and Sk: rows and
// keys past the end are masked here, so callers need not pad.
// Optionally (a non-null lse) it also writes each row's log-sum-exp of the
// scaled, masked scores, (B, H, Sq) in fp32, from which the backward
// (flash_attention_bwd.cu) recomputes the probabilities; a null lse writes
// nothing more, so the serving path is unchanged.
//
// Bound on an H100: at the serving prefill shape (B=4, S=512, H=32, KV=4,
// hd=128, causal, fp32) the work is ~8.6 GFLOP against ~75 MB moved, so it
// is bound by operations.  Plain fp32 runs on the CUDA cores (67 TFLOP/s,
// 0.128 ms); one TF32 tensor-core product keeps only ~3 decimal digits and
// misses the 2e-5 fp32 tolerance.
//
// What the design does about it:
//   * Both products run on the tensor cores as
//     mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 with "3xTF32": every fp32
//     operand a is split in registers into hi = tf32(a) and
//     lo = tf32(a - hi), and a.b is taken as lo.hi + hi.lo + hi.hi with fp32
//     accumulators.  That keeps ~fp32 accuracy at 3 tensor-core products, a
//     bound of 3 x 8.6 GFLOP / 495 TFLOP/s = 0.052 ms.  bf16 operands are
//     exact in TF32, so their lo terms are zero and skipped: a bf16 q.k is
//     one product; p stays fp32 (as in the reference), so p.v is two.
//     mma.sync rather than wgmma because the split happens on register
//     fragments, which mma.sync takes directly; wgmma reads B from shared
//     memory and would need hi and lo tiles of k and v.
//   * The tensor core's own fp32 sums are kept short: q.k sums hi.hi and
//     the two small terms in three accumulators (which also gives three
//     independent dependency chains), and each kv tile's p.v goes to a fresh
//     accumulator that is added to the running one by an fp32 fma.
//   * One block per (batch x KV head, 16 folded query rows per warp); a
//     folded row is (query position, head within the group), the Pallas
//     kernel's GQA folding, so the G query heads of a group share every K/V
//     tile.  A warp's score tile, its fp32 accumulator (16 x hd) and its
//     running max and sum live in registers.  4 warps per block, or 8 for
//     fp32 above hd=128, where one block fills the SM's shared memory.
//   * A loop over 32-key tiles inside the block takes the place of the
//     TPU's sequential kv grid axis.  K and V tiles arrive by 16-byte
//     cp.async into a double-buffered ring: tile t+1 is in flight while tile
//     t is computed.  Under causal masking the loop stops at the block's
//     last visible tile, a warp skips the math of tiles none of its rows can
//     see, and the row blocks that see the most tiles are scheduled first.
//     Shared memory is 107 KB at hd=128 fp32, so two blocks share an SM.
//   * Fragment loads are cheap: the k index of an mma step may map to any
//     head-dim column as long as q and k agree, so each thread reads its q
//     and k values for two steps with one 16-byte load; and the p.v step
//     maps its k slots to the keys each thread already holds in its score
//     accumulator, so p needs no shuffle and no trip through shared memory.
//     Row strides are padded so that each warp's loads hit distinct banks.
//   * Row max and row sum are reduced across the 4 threads of a quad, in
//     the log2 domain so each exponential is one exp2.
//   * cudaFuncSetAttribute runs once per instantiation and device, not per
//     launch.
//
// Interface: plain C, loaded with ctypes.  The kernel launches on the
// caller's stream, allocates nothing, and the entry point returns
// cudaGetLastError() so a refused launch is reported.  q, k, v and o must
// be 16-byte aligned (the wrapper sees to it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // loads, stores, the TF32 split, mma, cp.async

namespace {

using namespace mma_tf32;

constexpr int kKeys = 32;            // keys per kv tile
constexpr int kKeyTiles = kKeys / 8; // n-tiles of the score product
constexpr float kNegInf = -1e30f;    // the reference's mask value
constexpr int kMaxDevices = 64;

// The smallest n >= x with n % m == r.
constexpr int pad_to(int x, int m, int r) { return x + ((r - x % m) % m + m) % m; }

template <typename T, int HD>
struct Layout {
  // 4 warps, or 8 where one block of 4 would fill an SM's shared memory
  // alone (fp32 above hd=128): 8 warps then share each K/V tile.
  static constexpr int kWarps = sizeof(T) == 4 && HD > 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // folded query rows per block
  static constexpr int kChunk = 16 / sizeof(T);        // elements per 16-byte copy
  static constexpr int kChunksPerRow = HD / kChunk;
  // Row strides in elements, padded so a warp's fragment loads hit distinct
  // banks: the 4-value q and k loads of 8 (fp32) or 16 (bf16) threads
  // need QS % 32 == 16; the scalar v loads of keys 2*tig need
  // 2 * VS % 32 == 8 in fp32, VS % 32 == 8 in bf16.
  static constexpr int QS = pad_to(HD, 32, 16);
  static constexpr int VS = sizeof(T) == 4 ? pad_to(HD, 16, 4) : pad_to(HD, 32, 8);
  static constexpr int kQ = kRows * QS;
  static constexpr int kK = kKeys * QS;
  static constexpr int kV = kKeys * VS;
  static constexpr size_t kBytes = sizeof(T) * (size_t)(kQ + 2 * (kK + kV));
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert((QS * sizeof(T)) % 16 == 0 && (VS * sizeof(T)) % 16 == 0, "rows must stay 16-byte aligned");
  static_assert(kBytes <= 232448, "tile does not fit shared memory");
};

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<T, HD>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int H, int KV, int causal, float scale) {
  using L = Layout<T, HD>;
  constexpr bool kExact = sizeof(T) == 2;  // bf16: exact in TF32, no lo terms
  constexpr int kNT = HD / 8;              // n-tiles of the accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + L::kQ;                    // 2 stages of kKeys x QS
  T* v_s = k_s + 2 * L::kK;                // 2 stages of kKeys x VS

  // Scores are kept in the log2 domain, s * scale * log2(e), so that
  // exp(s * scale - max) is one exp2.
  const float scale_log2 = scale * 1.4426950408889634f;
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int n_rows = Sq * G;  // < 2^31, checked at the entry point
  // Row blocks run longest first: under causal masking the last rows see
  // the most tiles, and scheduling them first keeps them out of the tail.
  const int row0 = (gridDim.y - 1 - blockIdx.y) * L::kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates

  // Stage the q tile.  Folded row r is query position (row0 + r) / G and
  // head kvh * G + (row0 + r) % G.
  for (int e = tid; e < L::kRows * L::kChunksPerRow; e += L::kThreads) {
    const int r = e / L::kChunksPerRow, c = e % L::kChunksPerRow;
    const int f = row0 + r;
    const bool ok = f < n_rows;
    const int fc = ok ? f : 0;
    const T* src = q + ((b * (long long)Sq + fc / G) * H + kvh * G + fc % G) * HD + c * L::kChunk;
    cp_async16(q_s + r * L::QS + c * L::kChunk, src, ok);
  }
  auto load_kv = [&](int t, int stage) {
    T* ks = k_s + stage * L::kK;
    T* vs = v_s + stage * L::kV;
    for (int e = tid; e < kKeys * L::kChunksPerRow; e += L::kThreads) {
      const int j = e / L::kChunksPerRow, c = e % L::kChunksPerRow;
      const int kp = t * kKeys + j;
      const bool ok = kp < Sk;
      const long long off = ((b * (long long)Sk + (ok ? kp : 0)) * KV + kvh) * HD + c * L::kChunk;
      cp_async16(ks + j * L::QS + c * L::kChunk, k + off, ok);
      cp_async16(vs + j * L::VS + c * L::kChunk, v + off, ok);
    }
  };

  const int n_kv_all = (Sk + kKeys - 1) / kKeys;
  int n_kv = n_kv_all;
  const int last_row = min(row0 + L::kRows, n_rows) - 1;
  if (causal) n_kv = min(n_kv_all, last_row / G / kKeys + 1);

  // This warp's rows: folded w_first .. w_last; this thread's two rows are
  // w_first + g and w_first + g + 8.
  const int w_first = row0 + 16 * warp;
  const int w_last = min(w_first + 15, n_rows - 1);
  const bool warp_has_rows = w_first < n_rows;
  const int w_qmax = warp_has_rows ? w_last / G : -1;
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = (w_first + g + 8 * h) / G;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  if (n_kv > 0) load_kv(0, 0);
  cp_async_commit();

  const T* qw = q_s + (16 * warp) * L::QS;
  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * kKeys;
    if (warp_has_rows && (!causal || k0 <= w_qmax)) {
      const T* ks = k_s + (t & 1) * L::kK;
      const T* vs = v_s + (t & 1) * L::kV;

      // s = q k^T: 16 rows x kKeys keys per warp.  The k index of an mma
      // step is free to map to any head-dim column as long as q and k agree:
      // steps 2j and 2j+1 give thread tig the columns 16j + 4*tig + {0, 1}
      // and {2, 3}, so each thread reads its q and k values for two steps
      // with one 4-value load.  The hi.hi products and the two small-term
      // products go to three accumulators, so each dependency chain is
      // HD/8 products long instead of 3 * HD/8.
      float s[kKeyTiles][4], s_lh[kKeyTiles][4], s_hl[kKeyTiles][4];
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = s_lh[n][i] = s_hl[n][i] = 0.f;
#pragma unroll 2
      for (int j = 0; j < HD / 16; ++j) {
        const int d0 = 16 * j + 4 * tig;
        float qa[4], qb[4];  // rows g and g + 8
        load4(qw + g * L::QS + d0, qa);
        load4(qw + (g + 8) * L::QS + d0, qb);
        float kv[kKeyTiles][4];
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n) load4(ks + (n * 8 + g) * L::QS + d0, kv[n]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a[4] = {qa[2 * h], qb[2 * h], qa[2 * h + 1], qb[2 * h + 1]};
          uint32_t ah[4], al[4];
          to_tf32<4, !kExact>(a, ah, al);
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
            const float bb[2] = {kv[n][2 * h], kv[n][2 * h + 1]};
            uint32_t bh[2], bl[2];
            to_tf32<2, !kExact>(bb, bh, bl);
            if (!kExact) {
              mma(s_lh[n], al, bh);
              mma(s_hl[n], ah, bl);
            }
            mma(s[n], ah, bh);
          }
        }
      }
      if (!kExact) {
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] += s_lh[n][i] + s_hl[n][i];
      }

      // Online softmax over this tile.  Thread holds rows g (s[n][0..1])
      // and g + 8 (s[n][2..3]), keys k0 + 8n + 2*tig + {0, 1}.
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * n + 2 * tig + e;
            const bool ok = kp < Sk && (!causal || kp <= qpos[h]);
            float& x = s[n][2 * h + e];
            x = ok ? x * scale_log2 : kNegInf;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        corr[h] = exp2f(m[h] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[n][2 * h + e];
            x = x > 0.5f * kNegInf ? exp2f(x - m_new) : 0.f;
            rs += x;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[h] = l[h] * corr[h] + rs;
        m[h] = m_new;
      }

      // p as the A operand of p v, with no data movement: step kk of p v
      // maps k slot tig to key 8kk + 2*tig and slot tig + 4 to key
      // 8kk + 2*tig + 1, which are the keys of this thread's own score
      // values s[kk][0..3]; v's fragment follows the same map.
      uint32_t ph[kKeyTiles][4], pl[kKeyTiles][4];
#pragma unroll
      for (int kk = 0; kk < kKeyTiles; ++kk) {
        const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        to_tf32<4, true>(a, ph[kk], pl[kk]);
      }

      // acc = acc * corr + p v.  The tile's p v is summed in a fresh
      // accumulator, kChunk n-tiles at a time, and added to acc by an fp32
      // fma, so the tensor core's fp32 sums run over one tile's keys, not
      // over the whole sequence.
      constexpr int kChunk = 8;
#pragma unroll
      for (int c0 = 0; c0 < kNT; c0 += kChunk) {
        float part[kChunk][4];
#pragma unroll
        for (int n = 0; n < kChunk; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKeyTiles; ++kk) {
          const T* vr = vs + (kk * 8 + 2 * tig) * L::VS + g;
#pragma unroll
          for (int n = 0; n < kChunk; ++n) {
            if (c0 + n >= kNT) break;
            const float bb[2] = {to_float(vr[(c0 + n) * 8]),
                                 to_float(vr[L::VS + (c0 + n) * 8])};
            uint32_t bh[2], bl[2];
            to_tf32<2, !kExact>(bb, bh, bl);
            mma(part[n], pl[kk], bh);
            if (!kExact) mma(part[n], ph[kk], bl);
            mma(part[n], ph[kk], bh);
          }
        }
#pragma unroll
        for (int n = 0; n < kChunk; ++n) {
          if (c0 + n >= kNT) break;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[c0 + n][i] = fmaf(acc[c0 + n][i], corr[i / 2], part[n][i]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (n_kv == 0 issues q alone)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = w_first + g + 8 * h;
    if (f >= n_rows) continue;
    const int head = kvh * G + f % G;
    const float denom = fmaxf(l[h], 1e-30f);
    // m and l are in the log2 domain and already reduced over the quad.
    if (lse != nullptr && tig == 0)
      lse[((long long)b * H + head) * Sq + qpos[h]] = (m[h] + log2f(denom)) * 0.6931471805599453f;
    T* out = o + ((b * (long long)Sq + qpos[h]) * H + head) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      store2<T>(out + n * 8, acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int Sq, int Sk, int H, int KV, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<T, HD>::kBytes;
  auto kernel = flash_fwd_kernel<T, HD>;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const int n_rows = Sq * (H / KV);
  constexpr int kRows = Layout<T, HD>::kRows;
  const long long n_blocks = ((long long)n_rows + kRows - 1) / kRows;
  if (n_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * KV), (unsigned)n_blocks);
  kernel<<<grid, Layout<T, HD>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, H, KV, causal, scale);
  return cudaGetLastError();
}

// One instantiation per head dim a ported config has: 16 (reduced configs),
// 32, 64, 80 (stablelm-3b), 128 and 160 (pixtral-12b).
template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Sk, int H, int KV, int hd, int causal,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, stream);
    case 160: return launch<T, 160>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Sk, int H, int KV,
                                   int hd, int causal, float scale, int is_bf16,
                                   void* stream) {
  if (KV <= 0 || H % KV != 0 || (long long)Sq * (H / KV) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch_hd<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, H, KV, hd, causal, scale, s)
              : dispatch_hd<float>(q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, H, KV, hd, causal, scale, s);
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
