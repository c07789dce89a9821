// Flash-decode for Hopper (sm_90a): one decode step of GQA attention over a
// preallocated k/v cache, fp32.
//
// Replaces no Pallas kernel.  The JAX package's decode attention
// (src/repro/models/attention.py, decode_attention_local) is plain jnp that
// XLA fuses on the TPU.  Its plain PyTorch version (kernels/ref.py,
// decode_attention_ref) copies every layer's whole k and v caches into
// einsum's layout each step, scores every position and masks the empty
// ones; at yi-9b's decode shape (batch 32, 4,096 positions, 4 k/v heads of
// 128) that took ~58 ms of an ~83 ms step.  This kernel does the step in one
// pass over the filled positions, read in place.
//
// Same function: q (B,1,H,hd) against caches (B,S,KV,hd).  Position t of the
// caches takes k_new/v_new (B,1,KV,hd) in place; each query head attends to
// positions 0..t of its k/v head with scale 1/sqrt(hd), softmax in fp32, and
// the output is o / max(l, 1e-30).  It rounds differently from the plain
// version in three ways: the order of the fp32 sums; q is scaled by
// scale x log2(e) before the products, so softmax runs in the log2 domain;
// and the scores' exponentials are the SFU's ex2.approx.ftz (2 ulp, and a
// subnormal input or result flushed to zero).  On the card the outputs lie
// within 1.4e-6 of the plain version's at every case checked.
//
// Bound on an H100: by bytes.  Each (batch row, k/v head) reads (t+1) rows
// of k and of v, hd x 4 bytes each, and does 4 x G x hd operations a row:
// G/2 operations a byte, 4 at G = 8, far under the ~20 a byte where fp32
// FMA on the CUDA cores (67 TFLOP/s) would take over from memory
// (3.35 TB/s).  At yi-9b's decode shape around t = 2,513 a layer reads
// 329 MB: 98 us, 4.7 ms for the 48 layers of a step.
//
// What the design does about it:
//   * The G query heads of a k/v head are folded into one block, so each
//     k/v byte is read from device memory once for all G heads.  Positions
//     past t are never read.
//   * Bytes in flight: 32-position tiles of k and v arrive by 16-byte
//     cp.async in a ring of 2-4 stages (3 at hd 128, 104 KB of shared
//     memory), so two tiles are in flight while one is computed.  A row of
//     one (b, k/v head) is hd x 4 contiguous bytes (512 at hd 128), so
//     neighbouring lanes' 16-byte copies coalesce.  Each warp copies, waits
//     for and reads only its own 8 rows of every tile, so the warps run
//     apart with no barrier of the block inside the loop (a barrier a tile
//     cost a quarter of the time).
//   * Enough blocks: the grid is (splits x KV x B), each block a contiguous
//     run of positions, the runs of one (b, k/v head) differing in length
//     by at most one.  The split count comes from t, B and KV
//     (kernels/decode_attention.py, plan_splits) so the grid comes within
//     one split of a block an SM and never passes it: B x KV alone is 128
//     blocks at yi-9b's decode batch, one split, and 16 at batch 4, eight.
//     (Two blocks of 4 warps fit an SM, but a grid of two a SM ran 3-9%
//     slower at 128 blocks.)  A second small launch merges the splits'
//     (max, sum, weighted sum); a single split writes the output itself.
//   * Scores: a quad of lanes splits a position's hd, each lane reading its
//     k quarter once for all G heads (q, pre-scaled, from shared memory),
//     and two shuffles a head sum the quad.  Each warp keeps its own running
//     max and sum (online softmax in the log2 domain: one exp2 a score), and
//     its weighted sum of v with each lane owning 4 columns of hd for every
//     head.  The warps merge once, at the end, through shared memory.
//   * Position t: the block that owns it copies k_new/v_new into the
//     caches and takes them, not the cache rows, into its tile.  No other
//     block reads row t, so nothing races.
//   * t from the device: where the caller gives a pointer to t (an int64 on
//     the card), every block reads t there, one load a block, for the cache
//     write, its run of positions and the causal limit, and the t passed by
//     value only bounds the split count on the host.  A launch captured in
//     a CUDA graph then stays right for every later step that writes the
//     step's t there (models/decode_graph.py).
//   * fp32 FMA on the CUDA cores throughout: no tensor core, no TF32.
//   * Rows of a tile past the block's last position are zero-filled by the
//     copy itself (no read), so the weighted sum never meets stale data.
//
// Interface: plain C, loaded with ctypes.  The kernels launch on the
// caller's stream and allocate nothing (the wrapper gives the scratch of
// the split partials), and the entry point returns cudaGetLastError() so a
// refused launch is reported.  Every pointer must be 16-byte aligned.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 8;                // positions a warp takes of a tile
constexpr int kTile = kWarps * kWarpRows;   // positions a tile: 32
constexpr int kMaxGroup = 16;               // query heads a k/v head
// Shared memory a block may take so that two blocks share an SM: the SM's
// 228 KB less 1 KB the system keeps for each block, halved.
constexpr int kSmemBudget = (233472 - 2 * 1024) / 2;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

// The smallest n >= x with n % m == r.
constexpr int pad_to(int x, int m, int r) { return x + ((r - x % m) % m + m) % m; }

template <int HD, int GB>
struct Layout {
  static constexpr int kChunks = HD / 4;  // 16-byte chunks a row
  // k rows padded so a quarter-warp's reads of two rows (2 x 64 bytes) hit
  // distinct banks; v rows unpadded, so a warp's reads are one contiguous run.
  static constexpr int KS = pad_to(HD, 32, 16);
  static constexpr int VS = HD;
  static constexpr int kStageFloats = kTile * (KS + VS);
  static constexpr int kQFloats = GB * HD;
  static constexpr int kPFloats = kWarps * kWarpRows * GB;
  static constexpr int kFixedBytes = 4 * (kQFloats + kPFloats);
  static constexpr int kStagesFit = (kSmemBudget - kFixedBytes) / (4 * kStageFloats);
  static constexpr int kStages = kStagesFit < 4 ? kStagesFit : 4;
  static constexpr size_t kBytes = 4 * (size_t)(kQFloats + kPFloats + kStages * kStageFloats);
  // the warps' merge area, laid over the ring after the last tile: each
  // warp's weighted sums (GB x HD), max and sum (GB each)
  static constexpr int kMergeFloats = kWarps * GB * (HD + 2);
  // The weighted sum: a lane owns chunk c of a row (and c + 32 where a row
  // has more than 32 chunks); where it has fewer, the warp's lanes form
  // kGroups groups that take every kGroups-th position of the warp's rows.
  static constexpr int kLaneChunks = (kChunks + 31) / 32;
  static constexpr int kGroups = kChunks >= 32 ? 1 : 32 / kChunks;
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(kStages >= 2, "two stages of the ring do not fit shared memory");
  static_assert(kMergeFloats <= kStages * kStageFloats, "merge area does not fit the ring");
  static_assert(kGroups == 1 || (kChunks & (kChunks - 1)) == 0, "groups need 2^n chunks");
  static_assert(kWarpRows % kGroups == 0, "groups must share a warp's rows evenly");
  static_assert(GB <= kMaxGroup, "group too large");
};

// 16-byte async copy global -> shared; valid false fills the 16 bytes with 0
// and reads nothing.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x by the SFU (ex2.approx: 2 ulp; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HD, int GB>
__global__ void __launch_bounds__(kThreads, 2)
decode_attn_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                   const float* __restrict__ v_new, float* k_cache, float* v_cache,
                   float* __restrict__ o,
                   float* __restrict__ part, int S, int H, int KV, int t_arg,
                   const long long* __restrict__ t_dev, float scale_log2) {
  using L = Layout<HD, GB>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // GB x HD, q * scale * log2(e); rows >= G zero
  float* p_s = q_s + L::kQFloats;      // per warp: kWarpRows x GB probabilities
  float* ring = p_s + L::kPFloats;     // kStages x (kTile x KS of k, kTile x VS of v)

  const int t = t_dev != nullptr ? (int)*t_dev : t_arg;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the splits cut positions 0..t into runs whose lengths differ by at most 1
  const int start = (int)((long long)split * (t + 1) / n_splits);
  const int end = (int)((long long)(split + 1) * (t + 1) / n_splits);  // one past the last
  const int n_tiles = (end - start + kTile - 1) / kTile;

  const long long row_stride = (long long)KV * HD;  // floats from one position to the next
  const long long head0 = (long long)b * S * KV * HD + (long long)kvh * HD;
  const float* kn = k_new + ((long long)b * KV + kvh) * HD;
  const float* vn = v_new + ((long long)b * KV + kvh) * HD;

  // The block that owns position t writes the new k/v into the caches.
  if (split == n_splits - 1) {
    for (int e = tid; e < 2 * L::kChunks; e += kThreads) {
      const bool is_v = e >= L::kChunks;
      const int c = is_v ? e - L::kChunks : e;
      const float4 x = ld4((is_v ? vn : kn) + 4 * c);
      float* dst = (is_v ? v_cache : k_cache) + head0 + t * row_stride + 4 * c;
      *reinterpret_cast<float4*>(dst) = x;
    }
  }

  // Each warp copies, reads and waits for its own kWarpRows rows of every
  // tile, so the warps run apart: no barrier of the block inside the loop.
  const int wrow0 = warp * kWarpRows;
  auto fetch_tile = [&](int tile) {
    float* ks = ring + (tile % L::kStages) * L::kStageFloats + wrow0 * L::KS;
    float* vs = ring + (tile % L::kStages) * L::kStageFloats + kTile * L::KS + wrow0 * L::VS;
    const int base = start + tile * kTile + wrow0;
#pragma unroll
    for (int e = lane; e < kWarpRows * L::kChunks; e += 32) {
      const int r = e / L::kChunks, c = e % L::kChunks;
      const int pos = base + r;
      const bool ok = pos < end;
      const long long off = head0 + pos * row_stride + 4 * c;
      cp_async16(ks + r * L::KS + 4 * c, !ok ? kn : pos == t ? kn + 4 * c : k_cache + off, ok);
      cp_async16(vs + r * L::VS + 4 * c, !ok ? vn : pos == t ? vn + 4 * c : v_cache + off, ok);
    }
  };

  // Start the ring, then stage q while the first tiles are in flight.
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_tiles) fetch_tile(s);
    cp_async_commit();
  }
  for (int e = tid; e < GB * L::kChunks; e += kThreads) {
    const int g = e / L::kChunks, c = e % L::kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < G) {
      x = ld4(q + ((long long)b * H + kvh * G + g) * HD + 4 * c);
      x.x *= scale_log2, x.y *= scale_log2, x.z *= scale_log2, x.w *= scale_log2;
    }
    *reinterpret_cast<float4*>(q_s + g * HD + 4 * c) = x;
  }
  __syncthreads();  // q_s is read by every warp

  // Scores: lane (pp, quarter) takes position pp of the warp's 8 and the
  // chunks quarter, quarter + 4, ... of its row.
  const int pp = lane / 4, quarter = lane % 4;
  // The weighted sum: lane (grp, c0).
  const int grp = L::kChunks >= 32 ? 0 : lane / L::kChunks;
  const int c0 = L::kChunks >= 32 ? lane : lane % L::kChunks;
  const bool pv_lane = grp < L::kGroups;
  float* pw = p_s + warp * kWarpRows * GB;

  float m[GB], l[GB], acc[L::kLaneChunks][GB][4];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < L::kLaneChunks; ++i)
      acc[i][g][0] = acc[i][g][1] = acc[i][g][2] = acc[i][g][3] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<L::kStages - 2>();
    __syncwarp();  // the warp's rows of tile i have landed; its rows of tile i-1 are read
    if (i + L::kStages - 1 < n_tiles) fetch_tile(i + L::kStages - 1);
    cp_async_commit();
    const float* ks = ring + (i % L::kStages) * L::kStageFloats;
    const float* vs = ks + kTile * L::KS;
    const int row = warp * kWarpRows + pp;
    const bool valid = start + i * kTile + row < end;

    float s[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) s[g] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const int ch = 4 * c + quarter;
      const float4 kf = ld4(ks + row * L::KS + 4 * ch);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float4 qf = ld4(q_s + g * HD + 4 * ch);
        s[g] = fmaf(qf.x, kf.x, s[g]);
        s[g] = fmaf(qf.y, kf.y, s[g]);
        s[g] = fmaf(qf.z, kf.z, s[g]);
        s[g] = fmaf(qf.w, kf.w, s[g]);
      }
    }
    float alpha[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
      s[g] = valid ? s[g] : -INFINITY;
      float mx = s[g];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[g], mx);
      // m_new is -inf only while none of the warp's positions was valid
      alpha[g] = m_new == -INFINITY ? 1.f : exp2_approx(m[g] - m_new);
      const float p = valid ? exp2_approx(s[g] - m_new) : 0.f;
      l[g] = fmaf(l[g], alpha[g], p);
      m[g] = m_new;
      if ((g & 3) == quarter) pw[pp * GB + g] = p;
    }
    __syncwarp();

#pragma unroll
    for (int j = 0; j < L::kLaneChunks; ++j)
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        acc[j][g][0] *= alpha[g], acc[j][g][1] *= alpha[g];
        acc[j][g][2] *= alpha[g], acc[j][g][3] *= alpha[g];
      }
    if (pv_lane) {
#pragma unroll
      for (int r0 = 0; r0 < kWarpRows / L::kGroups; ++r0) {
        const int r = grp + r0 * L::kGroups;
        float p[GB];
        if constexpr (GB % 4 == 0) {
#pragma unroll
          for (int g = 0; g < GB; g += 4) {
            const float4 x = ld4(pw + r * GB + g);
            p[g] = x.x, p[g + 1] = x.y, p[g + 2] = x.z, p[g + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < GB; ++g) p[g] = pw[r * GB + g];
        }
        const float* vrow = vs + (warp * kWarpRows + r) * L::VS;
#pragma unroll
        for (int j = 0; j < L::kLaneChunks; ++j) {
          const int c = c0 + 32 * j;
          if (L::kChunks % 32 == 0 || c < L::kChunks) {
            const float4 vf = ld4(vrow + 4 * c);
#pragma unroll
            for (int g = 0; g < GB; ++g) {
              acc[j][g][0] = fmaf(p[g], vf.x, acc[j][g][0]);
              acc[j][g][1] = fmaf(p[g], vf.y, acc[j][g][1]);
              acc[j][g][2] = fmaf(p[g], vf.z, acc[j][g][2]);
              acc[j][g][3] = fmaf(p[g], vf.w, acc[j][g][3]);
            }
          }
        }
      }
    }
    __syncwarp();
  }

  // Merge the warps.  The ring becomes the merge area once no copy is left.
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g) {  // the sum over the warp's quads
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 4);
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 8);
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 16);
  }
  if constexpr (L::kGroups > 1) {  // the sum over the lane groups
#pragma unroll
    for (int j = 0; j < L::kLaneChunks; ++j)
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int off = L::kChunks; off < 32; off *= 2)
            acc[j][g][e] += __shfl_xor_sync(0xffffffffu, acc[j][g][e], off);
  }
  // per warp: its weighted sums (GB x HD) from the ring's start, then
  // after all of those its max and sum (GB each)
  float* acc_s = ring;
  float* ml_s = ring + kWarps * GB * HD;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) ml_s[warp * 2 * GB + g] = m[g], ml_s[warp * 2 * GB + GB + g] = l[g];
  }
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < L::kLaneChunks; ++j) {
      const int c = c0 + 32 * j;
      if (L::kChunks % 32 == 0 || c < L::kChunks) {
#pragma unroll
        for (int g = 0; g < GB; ++g)
          *reinterpret_cast<float4*>(acc_s + (warp * GB + g) * HD + 4 * c) =
              make_float4(acc[j][g][0], acc[j][g][1], acc[j][g][2], acc[j][g][3]);
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ml_s[w * 2 * GB + g]);
    // M is finite: every block holds position start <= t
    float sum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = ml_s[w * 2 * GB + g];
      const float sc = mw == -INFINITY ? 0.f : exp2f(mw - M);
      sum = fmaf(ml_s[w * 2 * GB + GB + g], sc, sum);
      out = fmaf(acc_s[(w * GB + g) * HD + d], sc, out);
    }
    const long long row_out = (long long)b * H + kvh * G + g;
    if (n_splits == 1) {
      o[row_out * HD + d] = out / fmaxf(sum, 1e-30f);
    } else {
      float* pr = part + (row_out * n_splits + split) * (HD + 2);
      pr[2 + d] = out;
      if (d == 0) pr[0] = M, pr[1] = sum;
    }
  }
}

// Merges the splits of each (b, h) row: o = sum_s o_s 2^(m_s - M) /
// max(sum_s l_s 2^(m_s - M), 1e-30), M the largest m_s.  One thread an
// output element.
__global__ void __launch_bounds__(256)
decode_merge_kernel(const float* __restrict__ part, float* __restrict__ o, int rows, int HD,
                    int n_splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)rows * HD) return;
  const long long row = e / HD;
  const int d = (int)(e % HD);
  const float* pr = part + row * n_splits * (HD + 2);
  float M = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, pr[s * (HD + 2)]);
  float sum = 0.f, out = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    const float* ps = pr + s * (HD + 2);
    const float sc = exp2f(ps[0] - M);
    sum = fmaf(ps[1], sc, sum);
    out = fmaf(ps[2 + d], sc, out);
  }
  o[e] = out / fmaxf(sum, 1e-30f);
}

template <int HD, int GB>
cudaError_t launch(const float* q, const float* k_new, const float* v_new, float* k_cache,
                   float* v_cache, float* o, float* part, int B, int S, int H, int KV, int t,
                   const long long* t_dev, int n_splits, float scale, cudaStream_t stream) {
  using L = Layout<HD, GB>;
  auto kernel = decode_attn_kernel<HD, GB>;
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
  const dim3 grid((unsigned)n_splits, (unsigned)KV, (unsigned)B);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(q, k_new, v_new, k_cache, v_cache, o, part, S,
                                                H, KV, t, t_dev, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  const long long total = (long long)B * H * HD;
  decode_merge_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, o, B * H, HD,
                                                                         n_splits);
  return cudaGetLastError();
}

// The group size rounded up to an instance: 1, 2, 4, 8 or 16 query heads
// a k/v head (rows of q past G are zero and their results unused).
template <int HD>
cudaError_t dispatch_group(const float* q, const float* k_new, const float* v_new,
                           float* k_cache, float* v_cache, float* o, float* part, int B, int S,
                           int H, int KV, int t, const long long* t_dev, int n_splits,
                           float scale, cudaStream_t s) {
  const int G = H / KV;
#define DECODE_LAUNCH(GB) \
  launch<HD, GB>(q, k_new, v_new, k_cache, v_cache, o, part, B, S, H, KV, t, t_dev, n_splits, \
                 scale, s)
  if (G <= 1) return DECODE_LAUNCH(1);
  if (G <= 2) return DECODE_LAUNCH(2);
  if (G <= 4) return DECODE_LAUNCH(4);
  if (G <= 8) return DECODE_LAUNCH(8);
  return DECODE_LAUNCH(16);
#undef DECODE_LAUNCH
}

}  // namespace

// One instantiation per head dim a ported config has: 16 (reduced configs),
// 32, 64 (musicgen-medium), 80 (stablelm-3b), 128 and 160 (pixtral-12b).
// t_dev: null, or a device int64 holding t, which the kernel then reads in
// place of t (t still bounds n_splits here).
extern "C" int decode_attention_fwd(const void* q, const void* k_new, const void* v_new,
                                    void* k_cache, void* v_cache, void* o, void* part, int B,
                                    int S, int H, int KV, int hd, int t, int n_splits,
                                    float scale, const void* t_dev, void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || KV > 65535 || H % KV != 0 || H / KV > kMaxGroup ||
      t < 0 || t >= S || n_splits < 1 || n_splits > t + 1 ||
      (n_splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kn = static_cast<const float*>(k_new);
  const float* vn = static_cast<const float*>(v_new);
  float* kc = static_cast<float*>(k_cache);
  float* vc = static_cast<float*>(v_cache);
  float* of = static_cast<float*>(o);
  float* pf = static_cast<float*>(part);
  const long long* td = static_cast<const long long*>(t_dev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)dispatch_group<16>(qf, kn, vn, kc, vc, of, pf, B, S, H, KV, t, td, n_splits, scale, s);
    case 32: return (int)dispatch_group<32>(qf, kn, vn, kc, vc, of, pf, B, S, H, KV, t, td, n_splits, scale, s);
    case 64: return (int)dispatch_group<64>(qf, kn, vn, kc, vc, of, pf, B, S, H, KV, t, td, n_splits, scale, s);
    case 80: return (int)dispatch_group<80>(qf, kn, vn, kc, vc, of, pf, B, S, H, KV, t, td, n_splits, scale, s);
    case 128: return (int)dispatch_group<128>(qf, kn, vn, kc, vc, of, pf, B, S, H, KV, t, td, n_splits, scale, s);
    case 160: return (int)dispatch_group<160>(qf, kn, vn, kc, vc, of, pf, B, S, H, KV, t, td, n_splits, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
