// The decode step's weight products for Hopper (sm_90a): y = x @ W for a few
// rows x (the decode batch, at most 32) and a large fp32 weight W, streamed
// from device memory once.
//
// Replaces no Pallas kernel.  The JAX package leaves these products to XLA
// as plain jnp: the q/k/v and output projections
// (src/repro/models/transformer.py, jnp.einsum in the attention block), the
// MLP (src/repro/models/layers.py, mlp_apply) and the LM head
// (src/repro/models/layers.py, lm_head_apply).  It was added because
// cuBLAS's fp32 SGEMM streams these weights at ~45% of HBM's rate at the
// dense decode cells' 16 and 32 rows: its tiles are built for many rows.
//
// Bound on an H100: by bytes.  At 32 rows a weight element serves 32
// multiply-adds, 16 operations a byte; 3xTF32 runs them as 3 TF32 products
// (495 / 3 = 165 TFLOP/s fp32-accurate), so streaming at 3.35 TB/s needs
// 53.6 of the 165.  yi-9b's step reads 34.3 GB of weights: 10.2 ms at
// HBM's rate.
//
// What the design does about it:
//   * Operands swapped: the weight's output features are the M side of
//     mma.sync.m16n8k8 (TF32) and the <= 32 rows its N side, in 1-4 tiles of
//     8 (the template's NT), so no tile wastes most of its rows.
//   * 3xTF32: every fp32 operand is split into hi = tf32(x) and
//     lo = tf32(x - hi) (mma_tf32.cuh), and w.x is taken as
//     lo.hi + hi.lo + hi.hi with fp32 accumulators: fp32 accuracy, no plain
//     TF32.  The tensor core's own sums are kept short: each 32-deep stage
//     of k goes to two fresh accumulators (hi.hi, and the two small terms),
//     which are then added to the running fp32 sum.
//   * Weight streaming: a block owns 128 output columns (two weights' 64
//     where it fuses the gated MLP) and a run of k.  32-row stages of the
//     weight and of x arrive by 16-byte cp.async in a ring of 4 (88-90 KB,
//     so two blocks share an SM and 6 stages are in flight on each), every
//     weight byte once.  x (at most 32 x 11,008 fp32) is read through L2,
//     32 columns of k a stage.
//   * Both layouts.  (K, N) with N contiguous (the projections, the MLP): a
//     row of a stage is 512 contiguous bytes, and a lane reads its 4
//     features of a row with one 16-byte load; the M index of the mma is
//     permuted (row r of a lane's two tiles is feature 4r + 2i, 4r + 2i + 1)
//     so those 4 features feed both of its tiles.  (N, K) with K contiguous
//     (the head, x @ table.T): a stage row is one feature's 32 values of k.
//     Row strides are padded so each warp's loads hit distinct banks.
//   * Split k where the column tiles alone cannot fill the card: a launch
//     runs as clusters of `split` blocks (1-8) over one column tile, each
//     block a run of k; the blocks leave their partial tiles in shared
//     memory, and after a cluster barrier each block sums a share of the
//     tile over the cluster's blocks in rank order through distributed
//     shared memory (no atomics, no workspace, no second launch), so every
//     launch of the same shapes gives the same bits, eager or in a CUDA
//     graph.  The split count comes from the wrapper
//     (kernels/decode_proj.py, plan_split).
//   * Fewer launches, the same bytes and products: one launch reads wq, wk
//     and wv through three pointers (segments of one grid), and one reads
//     w_in and w_gate and writes silu(x.w_gate) * (x.w_in) in its epilogue.
//     Nothing is concatenated.
//
// Interface: plain C, loaded with ctypes.  The kernel launches on the
// caller's stream and allocates nothing, and the entry point returns
// cudaGetLastError() so a refused launch is reported.  x and every weight
// must be 16-byte aligned, K and every N a multiple of 4.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // the TF32 split, mma, cp.async

namespace cg = cooperative_groups;
using namespace mma_tf32;

namespace {

constexpr int kCols = 128;       // output columns a block
constexpr int kMT = 2;           // m16 tiles a warp: 32 columns
constexpr int kWarps = kCols / (16 * kMT);
constexpr int kThreads = 32 * kWarps;
constexpr int kGatedCols = 64;   // columns of each of the two gated weights
constexpr int kBK = 32;          // k a stage
constexpr int kStages = 4;
constexpr int kMidStages = 8;    // stages a mid-level sum holds
constexpr int kMaxRows = 32;
constexpr int kMaxSplit = 8;     // blocks a cluster (the portable limit)
constexpr int kMaxDevices = 64;
constexpr int kSegments = 3;
// shared-memory row strides in floats: (K, N) weight rows (34 16-byte units,
// 2 mod 8, so the 8 lanes of a quarter-warp read distinct bank groups),
// (N, K) weight rows and x rows (36: 4 lanes a row, rows 4 banks apart),
// and the partial tile's rows
constexpr int kLdKN = kCols + 8;
constexpr int kLdK = kBK + 4;
constexpr int kLdP = kCols + 4;

struct Params {
  const float* x;              // (M, K)
  const float* w[kSegments];   // (K, n) each, or (n, K) where transposed; gated: w_in, w_gate
  float* y[kSegments];         // (M, n) each; gated: y[0]
  int n[kSegments];
  int tiles[kSegments];        // column tiles of each segment
  int M, K, k_tiles;
};

template <int NT, bool kNK>
struct Layout {
  static constexpr int kRows = 8 * NT;
  static constexpr int kWFloats = kNK ? kCols * kLdK : kBK * kLdKN;
  static constexpr int kXFloats = kRows * kLdK;
  static constexpr int kStageFloats = kWFloats + kXFloats;
  static constexpr int kPFloats = kRows * kLdP;
  static constexpr size_t kBytes = 4 * (size_t)kStages * kStageFloats;
  static_assert(kPFloats <= kStages * kStageFloats, "the partial tile must fit the ring");
};

// One stage: the weight's 32 rows of k (or its 128 features' 32 values of k)
// and x's rows at the same k, 16-byte cp.async each; chunks past K, past a
// segment's columns or past M are zero-filled and read nothing.
template <int NT, bool kNK, bool kGated>
__device__ __forceinline__ void load_stage(float* ws, float* xs, const Params& p, int seg,
                                           int col0, int kt) {
  const int tid = threadIdx.x;
  const int k0 = kt * kBK;
  const int K = p.K, n = p.n[seg];
#pragma unroll
  for (int it = 0; it < kCols * kBK / 4 / kThreads; ++it) {
    const int c = tid + it * kThreads;
    if (kNK) {
      const int f = c / (kBK / 4), kc = (c % (kBK / 4)) * 4;
      const bool ok = col0 + f < n && k0 + kc < K;
      const float* src = ok ? p.w[seg] + (size_t)(col0 + f) * K + k0 + kc : p.w[seg];
      cp_async16(ws + f * kLdK + kc, src, ok);
    } else {
      const int r = c / (kCols / 4), cc = (c % (kCols / 4)) * 4;
      // gated: columns 0-63 of the stage row from w_in, 64-127 from w_gate
      const int wi = kGated ? cc / kGatedCols : seg;
      const int col = col0 + (kGated ? cc % kGatedCols : cc);
      const bool ok = col < n && k0 + r < K;
      const float* src = ok ? p.w[wi] + (size_t)(k0 + r) * n + col : p.w[wi];
      cp_async16(ws + r * kLdKN + cc, src, ok);
    }
  }
  constexpr int kXChunks = 8 * NT * kBK / 4;
#pragma unroll
  for (int it = 0; it < (kXChunks + kThreads - 1) / kThreads; ++it) {
    const int c = tid + it * kThreads;
    if (c < kXChunks) {
      const int r = c / (kBK / 4), kc = (c % (kBK / 4)) * 4;
      const bool ok = r < p.M && k0 + kc < K;
      const float* src = ok ? p.x + (size_t)r * K + k0 + kc : p.x;
      cp_async16(xs + r * kLdK + kc, src, ok);
    }
  }
}

// The output feature (column of the block's tile) of mma row `row` (0-15)
// of tile i of warp w; see the permutation of the (K, N) layout above.
template <bool kNK>
__device__ __forceinline__ int feature(int w, int i, int row) {
  if (kNK) return 32 * w + 16 * i + row;
  return 32 * w + 4 * (row & 7) + 2 * i + (row >> 3);
}

template <int NT, bool kNK, bool kGated>
__global__ void __launch_bounds__(kThreads, 2) decode_proj_kernel(const Params p) {
  using L = Layout<NT, kNK>;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  // the block's column tile: segment, first column
  int tile = blockIdx.x / ranks, seg = 0;
  while (seg < kSegments - 1 && tile >= p.tiles[seg]) tile -= p.tiles[seg++];
  const int tile_cols = kGated ? kGatedCols : kCols;
  const int col0 = tile * tile_cols;
  // its run of k-tiles
  const int kt0 = (int)((long long)rank * p.k_tiles / ranks);
  const int nk = (int)((long long)(rank + 1) * p.k_tiles / ranks) - kt0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates

  // the running sums: `acc` of every kMidStages stages' `mid`, which sums
  // their stages' fresh tensor-core sums, so no fp32 chain runs long
  float acc[kMT][NT][4], mid[kMT][NT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = mid[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      float* st = smem + s * L::kStageFloats;
      load_stage<NT, kNK, kGated>(st, st + L::kWFloats, p, seg, col0, kt0 + s);
    }
    cp_async_commit();
  }

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t is in for every thread; stage t - 1 is free
    {
      const int s = t + kStages - 1;
      if (s < nk) {
        float* st = smem + (s % kStages) * L::kStageFloats;
        load_stage<NT, kNK, kGated>(st, st + L::kWFloats, p, seg, col0, kt0 + s);
      }
      cp_async_commit();
    }
    const float* ws = smem + (t % kStages) * L::kStageFloats;
    const float* xs = ws + L::kWFloats;

    float big[kMT][NT][4], small[kMT][NT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[i][j][e] = small[i][j][e] = 0.f;

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      // B: x rows 8j + g at k = kk + tig and kk + tig + 4
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* xr = xs + (8 * j + g) * kLdK + kk + tig;
        const float b[2] = {xr[0], xr[4]};
        to_tf32<2, true>(b, bh[j], bl[j]);
      }
      // A: the warp's m16 tiles of the weight at the same k
      float a[kMT][4];
      if (kNK) {
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float* r0 = ws + feature<true>(warp, i, g) * kLdK + kk + tig;
          const float* r1 = r0 + 8 * kLdK;
          a[i][0] = r0[0], a[i][1] = r1[0], a[i][2] = r0[4], a[i][3] = r1[4];
        }
      } else {
        // features 4g .. 4g + 3 of the warp at k and k + 4, a load each
        const float* r0 = ws + (kk + tig) * kLdKN + 32 * warp + 4 * g;
        float v0[4], v1[4];
        load4(r0, v0);
        load4(r0 + 4 * kLdKN, v1);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          a[i][0] = v0[2 * i], a[i][1] = v0[2 * i + 1];
          a[i][2] = v1[2 * i], a[i][3] = v1[2 * i + 1];
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        uint32_t ah[4], al[4];
        to_tf32<4, true>(a[i], ah, al);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma(small[i][j], al, bh[j]);
          mma(small[i][j], ah, bl[j]);
          mma(big[i][j], ah, bh[j]);
        }
      }
    }
    const bool fold = (t + 1) % kMidStages == 0 || t + 1 == nk;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mid[i][j][e] += big[i][j][e] + small[i][j][e];
          if (fold) acc[i][j][e] += mid[i][j][e], mid[i][j][e] = 0.f;
        }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tile goes over it

  // The block's partial tile, (rows, 128 columns), in its shared memory.
  float* part = smem;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = 8 * j + 2 * tig;
      const int f0 = feature<kNK>(warp, i, g), f1 = feature<kNK>(warp, i, g + 8);
      part[row * kLdP + f0] = acc[i][j][0];
      part[(row + 1) * kLdP + f0] = acc[i][j][1];
      part[row * kLdP + f1] = acc[i][j][2];
      part[(row + 1) * kLdP + f1] = acc[i][j][3];
    }
  cluster.sync();

  // Each block of the cluster sums its share of the tile over the cluster's
  // partial tiles in rank order and writes it: the output columns of the
  // tile (64 for the gated MLP, whose gate sums sit 64 columns to the right).
  const int n = p.n[seg];
  float* y = p.y[seg];
  const int total = L::kRows * tile_cols;
  const int lo = (int)((long long)rank * total / ranks);
  const int hi = (int)((long long)(rank + 1) * total / ranks);
  const float* parts[kMaxSplit];
#pragma unroll
  for (int q = 0; q < kMaxSplit; ++q) parts[q] = cluster.map_shared_rank(part, q < ranks ? q : 0);
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    const int row = e / tile_cols, c = e % tile_cols;
    if (row >= p.M || col0 + c >= n) continue;
    const int at = row * kLdP + c;
    // every rank's value in flight at once, then summed in rank order
    float v[kMaxSplit], gv[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < ranks) {
        v[q] = parts[q][at];
        if (kGated) gv[q] = parts[q][at + kGatedCols];
      }
    float sum = v[0], gate = kGated ? gv[0] : 0.f;
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q)
      if (q < ranks) {
        sum += v[q];
        if (kGated) gate += gv[q];
      }
    if (kGated) sum *= gate / (1.f + expf(-gate));  // silu(x.w_gate) * (x.w_in)
    y[(size_t)row * n + col0 + c] = sum;
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// The instance's shared-memory attributes, set once per device.
template <int NT, bool kNK, bool kGated>
cudaError_t configure() {
  using L = Layout<NT, kNK>;
  auto kernel = decode_proj_kernel<NT, kNK, kGated>;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::kBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  return cudaSuccess;
}

// A launch of `blocks` blocks in clusters of `split`.
template <int NT, bool kNK>
cudaLaunchConfig_t config(int blocks, int split, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Layout<NT, kNK>::kBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NT, bool kNK, bool kGated>
cudaError_t launch(const Params& p, int split, cudaStream_t stream) {
  cudaError_t err = configure<NT, kNK, kGated>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const int tiles = p.tiles[0] + p.tiles[1] + p.tiles[2];
  const cudaLaunchConfig_t cfg = config<NT, kNK>(tiles * split, split, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, decode_proj_kernel<NT, kNK, kGated>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `split` blocks the device holds at once; minus an
// error code where it cannot say.
template <int NT, bool kNK, bool kGated>
long long clusters(int split) {
  cudaError_t err = configure<NT, kNK, kGated>();
  if (err != cudaSuccess) return -(long long)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<NT, kNK>(split, split, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(decode_proj_kernel<NT, kNK, kGated>), &cfg);
  return err != cudaSuccess ? -(long long)err : n;
}

template <bool kNK, bool kGated>
cudaError_t dispatch_rows(const Params& p, int split, cudaStream_t s) {
  switch ((p.M + 7) / 8) {
    case 1: return launch<1, kNK, kGated>(p, split, s);
    case 2: return launch<2, kNK, kGated>(p, split, s);
    case 3: return launch<3, kNK, kGated>(p, split, s);
    default: return launch<4, kNK, kGated>(p, split, s);
  }
}

template <bool kNK, bool kGated>
long long clusters_rows(int M, int split) {
  switch ((M + 7) / 8) {
    case 1: return clusters<1, kNK, kGated>(split);
    case 2: return clusters<2, kNK, kGated>(split);
    case 3: return clusters<3, kNK, kGated>(split);
    default: return clusters<4, kNK, kGated>(split);
  }
}

bool misaligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 != 0; }

}  // namespace

// y_i = x @ w_i for the segments i with n_i > 0 (at most three, one launch),
// x (M, K), w_i (K, n_i), or (n_i, K) where `transposed` (y = x @ w.T); or,
// where `gated`, y_0 = silu(x @ w_1) * (x @ w_0) for w_0 = w_in and
// w_1 = w_gate (K, n_0).  `split`: blocks a cluster, each a run of k
// (1-8, at most ceil(K / 32)).
extern "C" int decode_proj_fwd(const void* x, const void* w0, const void* w1,
                               const void* w2, void* y0, void* y1, void* y2, int M, int K,
                               int n0, int n1, int n2, int transposed, int gated, int split,
                               void* stream) {
  Params p = {};
  p.x = static_cast<const float*>(x);
  const void* ws[kSegments] = {w0, w1, w2};
  void* ys[kSegments] = {y0, y1, y2};
  const int ns[kSegments] = {n0, gated ? 0 : n1, gated ? 0 : n2};
  p.M = M, p.K = K, p.k_tiles = (K + kBK - 1) / kBK;
  if (M < 1 || M > kMaxRows || K < 4 || K % 4 || split < 1 || split > kMaxSplit ||
      split > p.k_tiles || misaligned(x) || (gated && (transposed || w1 == nullptr ||
                                                       misaligned(w1))))
    return (int)cudaErrorInvalidValue;
  const int cols = gated ? kGatedCols : kCols;
  for (int i = 0; i < kSegments; ++i) {
    if (ns[i] < 0 || ns[i] % 4 || (ns[i] > 0 && (ws[i] == nullptr || ys[i] == nullptr ||
                                                 misaligned(ws[i]))))
      return (int)cudaErrorInvalidValue;
    p.w[i] = static_cast<const float*>(ws[i]);
    p.y[i] = static_cast<float*>(ys[i]);
    p.n[i] = ns[i];
    p.tiles[i] = (ns[i] + cols - 1) / cols;
  }
  if (gated) p.w[1] = static_cast<const float*>(w1);
  const long long blocks = (long long)(p.tiles[0] + p.tiles[1] + p.tiles[2]) * split;
  if (blocks < 1 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gated) return (int)dispatch_rows<false, true>(p, split, s);
  if (transposed) return (int)dispatch_rows<true, false>(p, split, s);
  return (int)dispatch_rows<false, false>(p, split, s);
}

// Clusters of `split` blocks that the current device holds at once for a
// launch of M rows (the wrapper's split plan keeps a launch in one wave).
extern "C" long long decode_proj_clusters(int M, int transposed, int gated, int split) {
  if (M < 1 || M > kMaxRows || split < 1 || split > kMaxSplit || (gated && transposed))
    return -(long long)cudaErrorInvalidValue;
  if (gated) return clusters_rows<false, true>(M, split);
  if (transposed) return clusters_rows<true, false>(M, split);
  return clusters_rows<false, false>(M, split);
}

extern "C" const char* decode_proj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
