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
// Bound on an H100: by operations.  The function needs 5 products (S, dP,
// dV, dK, dQ); this design executes 7, since the dQ kernel recomputes S and
// dP rather than sum dQ across blocks with atomics.  At the stablelm-3b
// training shape (B=2, S=512, H=KV=32, hd=80, causal) the 7 products are
// ~9.4 GFLOP against ~42 MB moved: 3 x 9.4 GFLOP / 495 TFLOP/s = 0.057 ms on
// the TF32 tensor cores in 3xTF32 (0.041 ms for the 5 the function needs).
//
// What the design does about it:
//   * Every product runs on the tensor cores as
//     mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 with the forward's 3xTF32
//     split (lo.hi + hi.lo + hi.hi, fp32 accumulators; mma_tf32.cuh).  bf16
//     operands (q, k, v, dO) are exact in TF32, so their lo terms are
//     skipped; P and dS are fp32 values computed here, so they are always
//     split (a bf16 P^T dO is two products, as the forward's p.v).
//   * P and dS stay in registers.  A product's accumulator fragment holds,
//     per thread, rows g and g + 8 and columns 2*tig, 2*tig + 1 of each
//     8-wide tile; the next product maps its k slots tig and tig + 4 to
//     exactly those columns (the forward's p.v trick), so P and dS become
//     A operands with no shuffle and no trip through shared memory.
//   * dK/dV kernel: one block per (batch x KV head, 64 keys), 4 warps, each
//     owning 16 keys.  K and V stay in shared memory; tiles of folded query
//     rows (Q, dO, lse, D) stream through a double-buffered ring by cp.async.
//     Per tile a warp forms S^T = K Q^T and dP^T = V dO^T as accumulators,
//     P^T and dS^T in registers (lse and D read per column), then
//     dV += P^T dO and dK += dS^T Q.  The block sums over the G heads of its
//     group in its own loop: no atomics, so the result is deterministic.
//     Where that grid has fewer than ~2 blocks per SM (GQA: few KV heads,
//     G * Sq rows each), up to 8 blocks split each key block's row tiles
//     into contiguous runs and write fp32 partial sums to the scratch; a
//     last kernel adds them in split order, so it stays deterministic.
//   * dQ kernel: one block per (batch x KV head, 64 folded rows), 4 warps of
//     16 rows.  Q and dO stay in shared memory; K/V tiles stream through the
//     ring.  Per tile a warp forms S = Q K^T, dP = dO V^T, dS, then dQ += dS K.
//   * The tensor core's own fp32 sums are kept short: each tile's dV, dK or
//     dQ contribution is summed in a fresh accumulator (2-4 k steps) and
//     added to the running sum by an fp32 add, so no tensor-core sum runs
//     over the whole sequence (the dK and dV sums run over G * Sq rows).
//   * Shared-memory tiles have rows of whole 128-byte lines, and 16-byte
//     chunk c of row r sits at chunk c ^ swz(r).  The score products read
//     4 values a thread (rows g, columns 4*tig..), the accumulations one
//     value at (row 2*tig + e, column g); the swizzle makes both free of
//     bank conflicts, where no padding of the row stride serves both.
//   * Streamed tiles are 32 rows or keys, 16 from hd 128, where a thread's
//     registers and the SM's shared memory run short.  From hd 128 the dK/dV
//     kernel also keeps its dV sums in shared memory (16 bytes per thread
//     and n-tile, never shared between threads) and only dK's in registers:
//     both sums, hd registers a thread, left too few of the 255 and spilled.
//   * Under causal masking the dK/dV loop starts at the first row tile that
//     sees the block's keys and the dQ loop stops at the last key tile its
//     rows see; a warp skips the math of tiles none of its rows or keys can
//     see; dQ's row blocks run longest first, as dK/dV's key blocks do.
//
// Interface: plain C, loaded with ctypes.  The kernels launch on the
// caller's stream and allocate nothing: the caller passes D, an fp32
// scratch of flash_attention_bwd_scratch(...) floats (the row dots, then
// any split dK/dV sums).  The entry point returns cudaGetLastError() so a
// refused launch is reported.  All pointers must be 16-byte aligned (the wrapper
// sees to it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // loads, stores, the TF32 split, mma, cp.async

namespace {

using namespace mma_tf32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwn = 16 * kWarps;  // keys (dK/dV kernel) or folded rows (dQ kernel) a block owns
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;
// The dK/dV grid aims at about two blocks per SM of an H100; with fewer
// (few KV heads, as GQA has) each KV head's folded rows are split between
// up to kMaxSplits blocks, whose partial sums a last kernel adds in order.
constexpr int kTargetBlocks = 256;
constexpr int kMaxSplits = 8;

// Rows or keys a streamed stage holds: 16 from hd 128, where a thread's
// registers and the SM's shared memory run short.
constexpr int tile_rows(int hd) { return hd >= 128 ? 16 : 32; }

// The chunk offset of row r: rows 0..7 XOR their 16-byte chunk index with
// 0, 4, 2, 6, 4, 0, 6, 2.  The 4-value loads of rows g, g+1 (fp32: 8
// threads a phase) and the scalar loads of rows 2*tig + e (a warp) then hit
// distinct banks.
__device__ __forceinline__ int swz(int r) { return (r & 6) ^ ((r & 1) << 2); }

template <typename T, int HD>
struct Layout {
  static constexpr int kChunk = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int kChunks = HD / kChunk;    // chunks of data per row
  static constexpr int kRowBytes = (HD * (int)sizeof(T) + 127) / 128 * 128;
  static constexpr int RS = kRowBytes / (int)sizeof(T);  // row stride, elements
  static constexpr int kTile = tile_rows(HD);
  static constexpr int kRT = kTile / 8;          // 8-wide tiles of a stage
  static constexpr int kOwnElems = kOwn * RS;
  static constexpr int kTileElems = kTile * RS;
  // From hd 128 a thread's dK and dV sums (hd registers) leave too few of
  // the 255 for the rest: the dK/dV kernel then keeps the dV sums in shared
  // memory, each thread's own 16-byte slots, and dK's in registers.
  static constexpr bool kDvShared = HD >= 128;
  // dQ kernel: Q and dO of its rows, 2 stages of K, V.
  static constexpr size_t kBytesDq = sizeof(T) * (size_t)(2 * kOwnElems + 4 * kTileElems);
  // dK/dV kernel: K and V of its keys, 2 stages of Q, dO and of lse, D, and
  // the dV sums where kDvShared.
  static constexpr size_t kBytesDkdv = kBytesDq + sizeof(float) * 4 * kTile +
                                       (kDvShared ? sizeof(float4) * kWarps * HD / 8 * 32 : 0);
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(kBytesDkdv <= 232448, "tiles do not fit shared memory");
};

// Offset of element (r, col) in a swizzled tile of row stride RS.
template <typename T, int RS>
__device__ __forceinline__ int at(int r, int col) {
  constexpr int kC = 16 / sizeof(T);
  return r * RS + (((col / kC) ^ swz(r)) * kC) + col % kC;
}

// Offset of folded row f's (query f / G, head kvh * G + f % G) first element.
__device__ __forceinline__ long long row_offset(int b, int f, int Sq, int H, int G, int kvh,
                                                int hd) {
  return ((b * (long long)Sq + f / G) * H + kvh * G + f % G) * (long long)hd;
}
// Offset of (b, head, query i) in the (B, H, Sq) lse and D arrays.
__device__ __forceinline__ long long stat_offset(int b, int f, int Sq, int H, int G, int kvh) {
  return ((long long)b * H + kvh * G + f % G) * Sq + f / G;
}

// c = a b^T over the head dim, as 16 x (8 kN) accumulator fragments: a is
// 16 rows of one shared tile, b is 8 kN rows of another.  The k index of an
// mma step is free to map to any head-dim column as long as a and b agree:
// steps 2j and 2j+1 give thread tig the columns 16j + 4*tig + {0, 1} and
// {2, 3}, so each thread reads its values for two steps with one 4-value
// load.  The two small 3xTF32 terms go to a second accumulator, added last.
template <typename T, int HD, int kN>
__device__ __forceinline__ void dot_rows(float (&c)[kN][4], const T* a, const T* b) {
  using L = Layout<T, HD>;
  constexpr bool kExact = sizeof(T) == 2;
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  float cs[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = cs[n][i] = 0.f;
#pragma unroll 2
  for (int j = 0; j < HD / 16; ++j) {
    const int d0 = 16 * j + 4 * tig;
    float aa[4], ab[4];  // rows g and g + 8
    load4(a + at<T, L::RS>(g, d0), aa);
    load4(a + at<T, L::RS>(g + 8, d0), ab);
    float bv[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) load4(b + at<T, L::RS>(8 * n + g, d0), bv[n]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x[4] = {aa[2 * h], ab[2 * h], aa[2 * h + 1], ab[2 * h + 1]};
      uint32_t ah[4], al[4];
      to_tf32<4, !kExact>(x, ah, al);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float y[2] = {bv[n][2 * h], bv[n][2 * h + 1]};
        uint32_t bh[2], bl[2];
        to_tf32<2, !kExact>(y, bh, bl);
        if (!kExact) {
          mma(cs[n], al, bh);
          mma(cs[n], ah, bl);
        }
        mma(c[n], ah, bh);
      }
    }
  }
  if (!kExact) {
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[n][i] += cs[n][i];
  }
}

// An accumulator fragment (rows g, g + 8; columns 2*tig, 2*tig + 1 of each
// 8-wide tile) as the split A operand of the next product, whose k slots
// tig and tig + 4 of step kk map to columns 8kk + 2*tig and 8kk + 2*tig + 1.
template <int kN>
__device__ __forceinline__ void as_a(const float (&c)[kN][4], uint32_t (&hi)[kN][4],
                                     uint32_t (&lo)[kN][4]) {
#pragma unroll
  for (int kk = 0; kk < kN; ++kk) {
    const float a[4] = {c[kk][0], c[kk][2], c[kk][1], c[kk][3]};
    to_tf32<4, true>(a, hi[kk], lo[kk]);
  }
}

// part += A B over one stage, A the split fragments of as_a, B the stage
// tile's 8 kN rows at head-dim columns 8n + g (n-tile n of the output).
template <typename T, int HD, int kN>
__device__ __forceinline__ void acc_tile(float (&part)[4], const uint32_t (&hi)[kN][4],
                                         const uint32_t (&lo)[kN][4], const T* b, int n) {
  using L = Layout<T, HD>;
  constexpr bool kExact = sizeof(T) == 2;
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kN; ++kk) {
    const int r = 8 * kk + 2 * tig;
    const float y[2] = {to_float(b[at<T, L::RS>(r, 8 * n + g)]),
                        to_float(b[at<T, L::RS>(r + 1, 8 * n + g)])};
    uint32_t bh[2], bl[2];
    to_tf32<2, !kExact>(y, bh, bl);
    mma(part, lo[kk], bh);
    if (!kExact) mma(part, hi[kk], bl);
    mma(part, hi[kk], bh);
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
  for (int c = lane; c < hd / 4; c += 32) {
    float a[4], b[4];
    load4(o + row * hd + 4 * c, a);
    load4(dO + row * hd + 4 * c, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(a[i], b[i], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long bi = row / H;  // b * Sq + i
    const int h = (int)(row % H);
    D[(bi / Sq * H + h) * Sq + bi % Sq] = acc;
  }
}

// One block per SM is enough occupancy to ask of ptxas: with the default
// bound it capped some instances below 255 registers and spilled.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ D,
                      T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
                      int Sq, int Sk, int H, int KV, int causal, float scale) {
  using L = Layout<T, HD>;
  constexpr int kNT = HD / 8;  // n-tiles of dK and dV
  constexpr int kRT = L::kRT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + L::kOwnElems;
  T* q_s = v_s + L::kOwnElems;           // 2 stages
  T* do_s = q_s + 2 * L::kTileElems;     // 2 stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * L::kTileElems);  // 2 stages
  float* d_s = lse_s + 2 * L::kTile;     // 2 stages
  float4* dv_s = reinterpret_cast<float4*>(d_s + 2 * L::kTile);  // where kDvShared

  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int j0 = blockIdx.y * kOwn;
  const int n_rows = Sq * G;
  const float scale_log2 = scale * kLog2e;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;

  for (int e = tid; e < kOwn * L::kChunks; e += kThreads) {
    const int j = e / L::kChunks, c = e % L::kChunks;
    const int key = j0 + j;
    const bool ok = key < Sk;
    const long long off = ((b * (long long)Sk + (ok ? key : 0)) * KV + kvh) * HD + c * L::kChunk;
    const int dst = j * L::RS + (c ^ swz(j)) * L::kChunk;
    cp_async16(k_s + dst, k + off, ok);
    cp_async16(v_s + dst, v + off, ok);
  }
  // Folded rows f0 .. f0 + kTile - 1 of q and dO, with lse and D, into a stage
  // (zeros past n_rows).
  auto load_rows = [&](int f0, int stage) {
    T* qs = q_s + stage * L::kTileElems;
    T* ds = do_s + stage * L::kTileElems;
    for (int e = tid; e < L::kTile * L::kChunks; e += kThreads) {
      const int r = e / L::kChunks, c = e % L::kChunks;
      const int f = f0 + r;
      const bool ok = f < n_rows;
      const long long off = row_offset(b, ok ? f : 0, Sq, H, G, kvh, HD) + c * L::kChunk;
      const int dst = r * L::RS + (c ^ swz(r)) * L::kChunk;
      cp_async16(qs + dst, q + off, ok);
      cp_async16(ds + dst, dO + off, ok);
    }
    if (tid < L::kTile) {
      const int f = f0 + tid;
      const bool ok = f < n_rows;
      const long long so = stat_offset(b, ok ? f : 0, Sq, H, G, kvh);
      cp_async4(lse_s + stage * L::kTile + tid, lse + so, ok);
      cp_async4(d_s + stage * L::kTile + tid, D + so, ok);
    }
  };

  // Under causal masking folded rows before j0 * G see none of these keys.
  // Of the row tiles from there on, this block takes the blockIdx.z-th of
  // gridDim.z contiguous runs.
  const int f_begin =
      causal ? (int)min((long long)j0 * G / L::kTile * L::kTile, (long long)n_rows) : 0;
  const int n_all = (n_rows - f_begin + L::kTile - 1) / L::kTile;
  const int t_lo = (int)((long long)n_all * blockIdx.z / gridDim.z);
  const int n_tiles = (int)((long long)n_all * (blockIdx.z + 1) / gridDim.z) - t_lo;
  const int f_first = f_begin + t_lo * L::kTile;

  // This warp's keys: kw0 + g and kw0 + g + 8.
  const int kw0 = j0 + 16 * warp;
  const bool warp_has_keys = kw0 < Sk;
  // dV's sums: acc_v, or this thread's slot dv_s[(warp * kNT + n) * 32 + lane]
  // of n-tile n, which no other thread touches.
  float acc_k[kNT][4], acc_v[L::kDvShared ? 1 : kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = 0.f;
    if constexpr (L::kDvShared) {
      dv_s[(warp * kNT + n) * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_v[n][i] = 0.f;
    }
  }

  if (n_tiles > 0) load_rows(f_first, 0);
  cp_async_commit();  // K, V and the first stage

  const T* kw = k_s + 16 * warp * L::RS;
  const T* vw = v_s + 16 * warp * L::RS;
  for (int t = 0; t < n_tiles; ++t) {
    const int f0 = f_first + t * L::kTile;
    if (t + 1 < n_tiles) {
      load_rows(f0 + L::kTile, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int f_last = min(f0 + L::kTile, n_rows) - 1;
    if (warp_has_keys && (!causal || f_last / G >= kw0)) {
      const T* qs = q_s + (t & 1) * L::kTileElems;
      const T* dos = do_s + (t & 1) * L::kTileElems;
      const float* ls = lse_s + (t & 1) * L::kTile;
      const float* dd = d_s + (t & 1) * L::kTile;

      // P^T = exp(S^T * scale - lse) on visible (key, row) pairs.  Thread
      // holds keys kw0 + g (st[n][0..1]) and kw0 + g + 8 (st[n][2..3]),
      // tile rows 8n + 2*tig + {0, 1}.
      float st[kRT][4];
      dot_rows<T, HD, kRT>(st, kw, qs);
#pragma unroll
      for (int n = 0; n < kRT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * n + 2 * tig + e;
          const int f = f0 + r;
          const int qp = f / G;
          const float l = ls[r] * kLog2e;
#pragma unroll
          for (int hk = 0; hk < 2; ++hk) {
            const int key = kw0 + g + 8 * hk;
            const bool ok = f < n_rows && key < Sk && (!causal || key <= qp);
            float& x = st[n][2 * hk + e];
            x = ok ? exp2f(fmaf(x, scale_log2, -l)) : 0.f;
          }
        }
      // dS^T = P^T * (dP^T - D), dP^T = V dO^T.
      float dsT[kRT][4];
      dot_rows<T, HD, kRT>(dsT, vw, dos);
#pragma unroll
      for (int n = 0; n < kRT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dsT[n][i] = st[n][i] * (dsT[n][i] - dd[8 * n + 2 * tig + (i & 1)]);

      uint32_t ph[kRT][4], pl[kRT][4], sh[kRT][4], sl[kRT][4];
      as_a<kRT>(st, ph, pl);
      as_a<kRT>(dsT, sh, sl);
      // dV += P^T dO, dK += dS^T Q, each tile's sum in a fresh accumulator.
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f}, pk[4] = {0.f, 0.f, 0.f, 0.f};
        acc_tile<T, HD, kRT>(pv, ph, pl, dos, n);
        acc_tile<T, HD, kRT>(pk, sh, sl, qs, n);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_k[n][i] += pk[i];
        if constexpr (L::kDvShared) {
          float4& a = dv_s[(warp * kNT + n) * 32 + lane];
          a = make_float4(a.x + pv[0], a.y + pv[1], a.z + pv[2], a.w + pv[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_v[n][i] += pv[i];
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (n_tiles == 0 issues K, V alone)

  // dK and dV, or with split rows this block's fp32 partial sums: dK's at
  // part[2z], dV's at part[2z + 1], each laid out as k.
  float* pk = nullptr;
  float* pv = nullptr;
  if (gridDim.z > 1) {
    const long long n = (long long)gridDim.x * Sk * HD;  // elements of k
    pk = part + 2 * blockIdx.z * n;
    pv = pk + n;
  }
#pragma unroll
  for (int hk = 0; hk < 2; ++hk) {
    const int key = kw0 + g + 8 * hk;
    if (key >= Sk) continue;
    const long long off = ((b * (long long)Sk + key) * KV + kvh) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      float v0, v1;
      if constexpr (L::kDvShared) {
        const float4 a = dv_s[(warp * kNT + n) * 32 + lane];
        v0 = hk ? a.z : a.x, v1 = hk ? a.w : a.y;
      } else {
        v0 = acc_v[n][2 * hk], v1 = acc_v[n][2 * hk + 1];
      }
      if (pk != nullptr) {
        store2<float>(pk + off + 8 * n, acc_k[n][2 * hk], acc_k[n][2 * hk + 1]);
        store2<float>(pv + off + 8 * n, v0, v1);
      } else {
        store2<T>(dk + off + 8 * n, scale * acc_k[n][2 * hk], scale * acc_k[n][2 * hk + 1]);
        store2<T>(dv + off + 8 * n, v0, v1);
      }
    }
  }
}

// dk = scale * the sum of the n_split dK partials, dv = the sum of the dV
// partials, each summed in split order; n elements of k, two a thread.
template <typename T>
__global__ void flash_bwd_sum_kernel(const float* __restrict__ part, int n_split, long long n,
                                     float scale, T* __restrict__ dk, T* __restrict__ dv) {
  const long long i = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float2 sk = make_float2(0.f, 0.f), sv = sk;
  for (int z = 0; z < n_split; ++z) {
    const float2 a = *reinterpret_cast<const float2*>(part + 2 * z * n + i);
    const float2 c = *reinterpret_cast<const float2*>(part + (2 * z + 1) * n + i);
    sk.x += a.x, sk.y += a.y, sv.x += c.x, sv.y += c.y;
  }
  store2<T>(dk + i, scale * sk.x, scale * sk.y);
  store2<T>(dv + i, sv.x, sv.y);
}

// The number of blocks that split each KV head's folded rows in the dK/dV
// kernel: enough for kTargetBlocks, at most kMaxSplits, and at least 4 row
// tiles each.
int dkdv_splits(int B, int Sq, int Sk, int H, int KV, int hd) {
  const long long blocks = (long long)B * KV * ((Sk + kOwn - 1) / kOwn);
  const long long row_tiles = ((long long)Sq * (H / KV) + tile_rows(hd) - 1) / tile_rows(hd);
  if (blocks <= 0 || blocks >= kTargetBlocks) return 1;
  long long n = (kTargetBlocks + blocks - 1) / blocks;
  if (n > row_tiles / 4) n = row_tiles / 4;
  if (n > kMaxSplits) n = kMaxSplits;
  return n > 1 ? (int)n : 1;
}

// The fp32 scratch the entry point needs, in floats: D (rounded up to 16
// bytes), then the split dK/dV partial sums if there are any.
long long scratch_floats(int B, int Sq, int Sk, int H, int KV, int hd) {
  const long long d = ((long long)B * H * Sq + 3) / 4 * 4;
  const int n = dkdv_splits(B, Sq, Sk, H, KV, hd);
  return d + (n > 1 ? 2LL * n * B * Sk * KV * hd : 0);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    T* __restrict__ dq, int Sq, int Sk, int H, int KV, int causal,
                    float scale) {
  using L = Layout<T, HD>;
  constexpr int kNT = HD / 8;  // n-tiles of dQ
  constexpr int kRT = L::kRT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + L::kOwnElems;
  T* k_s = do_s + L::kOwnElems;        // 2 stages
  T* v_s = k_s + 2 * L::kTileElems;    // 2 stages

  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int n_rows = Sq * G;
  // Row blocks run longest first: under causal masking the last rows see the
  // most key tiles.
  const int f0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  const float scale_log2 = scale * kLog2e;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;

  for (int e = tid; e < kOwn * L::kChunks; e += kThreads) {
    const int r = e / L::kChunks, c = e % L::kChunks;
    const int f = f0 + r;
    const bool ok = f < n_rows;
    const long long off = row_offset(b, ok ? f : 0, Sq, H, G, kvh, HD) + c * L::kChunk;
    const int dst = r * L::RS + (c ^ swz(r)) * L::kChunk;
    cp_async16(q_s + dst, q + off, ok);
    cp_async16(do_s + dst, dO + off, ok);
  }
  auto load_keys = [&](int t, int stage) {
    T* ks = k_s + stage * L::kTileElems;
    T* vs = v_s + stage * L::kTileElems;
    for (int e = tid; e < L::kTile * L::kChunks; e += kThreads) {
      const int j = e / L::kChunks, c = e % L::kChunks;
      const int key = t * L::kTile + j;
      const bool ok = key < Sk;
      const long long off =
          ((b * (long long)Sk + (ok ? key : 0)) * KV + kvh) * HD + c * L::kChunk;
      const int dst = j * L::RS + (c ^ swz(j)) * L::kChunk;
      cp_async16(ks + dst, k + off, ok);
      cp_async16(vs + dst, v + off, ok);
    }
  };

  int n_kv = (Sk + L::kTile - 1) / L::kTile;
  if (causal) n_kv = min(n_kv, (min(f0 + kOwn, n_rows) - 1) / G / L::kTile + 1);

  // This warp's rows: folded w_first + g and w_first + g + 8, with their
  // query positions, lse (log2 domain) and D.
  const int w_first = f0 + 16 * warp;
  const bool warp_has_rows = w_first < n_rows;
  const int w_qmax = warp_has_rows ? min(w_first + 15, n_rows - 1) / G : -1;
  int qpos[2];
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = w_first + g + 8 * h;
    const bool ok = f < n_rows;
    const long long so = stat_offset(b, ok ? f : 0, Sq, H, G, kvh);
    qpos[h] = f / G;
    l2[h] = ok ? lse[so] * kLog2e : 0.f;
    dd[h] = ok ? D[so] : 0.f;
  }

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  if (n_kv > 0) load_keys(0, 0);
  cp_async_commit();  // Q, dO and the first stage

  const T* qw = q_s + 16 * warp * L::RS;
  const T* dow = do_s + 16 * warp * L::RS;
  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      load_keys(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * L::kTile;
    if (warp_has_rows && (!causal || k0 <= w_qmax)) {
      const T* ks = k_s + (t & 1) * L::kTileElems;
      const T* vs = v_s + (t & 1) * L::kTileElems;

      // P = exp(S * scale - lse) on visible keys.  Thread holds rows g
      // (s[n][0..1]) and g + 8 (s[n][2..3]), keys k0 + 8n + 2*tig + {0, 1}.
      float s[kRT][4];
      dot_rows<T, HD, kRT>(s, qw, ks);
#pragma unroll
      for (int n = 0; n < kRT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * n + 2 * tig + (i & 1);
          const int h = i / 2;
          const bool ok = key < Sk && (!causal || key <= qpos[h]);
          s[n][i] = ok ? exp2f(fmaf(s[n][i], scale_log2, -l2[h])) : 0.f;
        }
      // dS = P * (dP - D), dP = dO V^T.
      float ds[kRT][4];
      dot_rows<T, HD, kRT>(ds, dow, vs);
#pragma unroll
      for (int n = 0; n < kRT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[n][i] = s[n][i] * (ds[n][i] - dd[i / 2]);

      uint32_t sh[kRT][4], sl[kRT][4];
      as_a<kRT>(ds, sh, sl);
      // dQ += dS K, each tile's sum in a fresh accumulator.
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        acc_tile<T, HD, kRT>(part, sh, sl, ks, n);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] += part[i];
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (n_kv == 0 issues Q, dO alone)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = w_first + g + 8 * h;
    if (f >= n_rows) continue;
    const long long off = row_offset(b, f, Sq, H, G, kvh, HD) + 2 * tig;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      store2<T>(dq + off + 8 * n, scale * acc[n][2 * h], scale * acc[n][2 * h + 1]);
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
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) configured[dev] = true;
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dO, void* dq, void* dk, void* dv, float* D,
                   int B, int Sq, int Sk, int H, int KV, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem_dkdv = Layout<T, HD>::kBytesDkdv, smem_dq = Layout<T, HD>::kBytesDq;
  static bool dkdv_configured[kMaxDevices] = {};
  static bool dq_configured[kMaxDevices] = {};
  auto dkdv = flash_bwd_dkdv_kernel<T, HD>;
  auto dqk = flash_bwd_dq_kernel<T, HD>;
  cudaError_t err = configure(dkdv, smem_dkdv, dkdv_configured);
  if (err != cudaSuccess) return err;
  err = configure(dqk, smem_dq, dq_configured);
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

  const int key_blocks = (Sk + kOwn - 1) / kOwn;
  const long long row_blocks = ((long long)Sq * (H / KV) + kOwn - 1) / kOwn;
  if (key_blocks > 65535 || row_blocks > 65535) return cudaErrorInvalidValue;
  if (key_blocks > 0) {
    const int n_split = dkdv_splits(B, Sq, Sk, H, KV, HD);
    float* part = D + ((long long)B * H * Sq + 3) / 4 * 4;
    dkdv<<<dim3((unsigned)(B * KV), (unsigned)key_blocks, (unsigned)n_split), kThreads,
           smem_dkdv, stream>>>(qt, kt, vt, dot, lse, D, static_cast<T*>(dk),
                                static_cast<T*>(dv), part, Sq, Sk, H, KV, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (n_split > 1) {
      const long long n = (long long)B * Sk * KV * HD;
      constexpr int kSumThreads = 256;
      flash_bwd_sum_kernel<T><<<(unsigned)((n / 2 + kSumThreads - 1) / kSumThreads),
                                kSumThreads, 0, stream>>>(part, n_split, n, scale,
                                                          static_cast<T*>(dk),
                                                          static_cast<T*>(dv));
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  dqk<<<dim3((unsigned)(B * KV), (unsigned)row_blocks), kThreads, smem_dq, stream>>>(
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

// Floats of the fp32 scratch D that flash_attention_bwd needs for these
// shapes: the row dots D (B, H, Sq), then the dK/dV partial sums where the
// dK/dV kernel splits the rows.
extern "C" long long flash_attention_bwd_scratch(int B, int Sq, int Sk, int H, int KV, int hd) {
  if (B <= 0 || Sq <= 0 || KV <= 0 || H % KV != 0) return 0;
  return scratch_floats(B, Sq, Sk, H, KV, hd);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
