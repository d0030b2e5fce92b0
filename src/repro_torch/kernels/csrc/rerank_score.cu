// Fused re-rank scorer: one user's history against C candidates.
//
// Replaces src/repro/kernels/rerank_score/kernel.py::rerank_score_pallas.
//
// Per candidate c (target t_c, side features io_c), with the user's
// history h_1..h_T, mask m and side features uo:
//   a_{c,s} = silu(silu([h_s, t_c, h_s - t_c, h_s * t_c] @ A1 + ab1) @ A2
//                  + ab2) @ a3 + ab3                        (DIN unit)
//   pooled_c = sum_s a_{c,s} * m_s * h_s                      (no softmax)
//   score_c  = silu(silu([pooled_c, t_c, uo, io_c] @ M1 + mb1) @ M2 + mb2)
//              @ m3 + mb3
//
// The history is shared by every candidate, so the first attention layer
// is decomposed around it, as the TPU kernel does: with A1 split into its
// row blocks (Wa | Wb | Wc | Wd),
//   feat @ A1 = h @ (Wa + Wc) + t @ (Wb - Wc) + (h * t) @ Wd,
// where ah = h @ (Wa + Wc) + ab1 is computed once per chunk for a block's
// kCands candidates, and t @ (Wb - Wc) once per candidate. Only
// (h * t) @ Wd is paid per (candidate, step): D*H1 instead of 4D*H1
// multiply-adds.
//
// Bound on the H100: latency, not bytes or flops. The inputs are a few
// hundred KB (history T*D, C candidates, ~160 KB of weights) and the work
// ~60 MFLOP per request at the paper's widths (C = 64, T = 100), about a
// microsecond at the float32 roof; what costs is the chain of dependent
// phases inside a block and the barriers between blocks.
//
// One launch. A block of 512 threads scores kCands = 4 candidates over
// chunks of kChunk = 32 steps; the blocks of one candidate group form a
// thread-block cluster of CL = clamp(chunks, 4, 8) blocks, block r taking
// chunks r, r + CL, ... in order (at T = 100: 4 blocks of one chunk each,
// 64 blocks at C = 64). Every input comes in by cp.async at the start, the
// score MLP's weight slices last, in flight while the attention runs; the
// loads are issued a warp per row, with no index division. Per chunk, the
// block's 128 (candidate, step) rows go through the two attention layers
// as register-tiled products from shared memory: in layer 1 ((h * t) @ Wd,
// K = D) a thread holds 4 rows x 5 units, one float4 of the rows' inputs
// and 5 weights per step of K (the first design read two shared operands
// per multiply-add); its output, transposed, feeds layer 2 (@ A2, K = H1),
// where two threads split K for 4 rows x 5 units, join by a shuffle, and
// reduce silu(.) * a3 across the row's 8 threads by shuffles. The block's
// partial pooled vectors go to every block of the cluster through
// distributed shared memory, and each block sums the cluster's partials
// in rank order (chunk order whenever T has at most 8 chunks): the same
// sum everywhere, independent of scheduling, with no device counters and
// no partials in device memory. The score MLP is split over the cluster:
// block r computes units [r M1 / CL, ...) of its first layer and
// [r M2 / CL, ...) of its second from its prefetched slices; the first
// layer's outputs are exchanged the same way, and block 0 sums the blocks'
// slices of the last layer in rank order.
//
// Tiles: H1 <= kMaxH1 = 80 (16 thread columns x 5) and H2 <= kMaxH2 = 40
// (8 x 5), zero-padded. ah = h @ (Wa + Wc) is computed by every block for
// its chunk (16 times per chunk at C = 64). Sharing it was not tried: by
// estimate, the cluster barrier it needs costs more than the 46k
// multiply-adds (90 a thread) it saves. Two candidates a block (128
// clusters of 4 at C = 64) do not fit one wave at this kernel's ~150 KB
// of shared memory a block. This design's and the first one's (two
// launches) times, launch by launch, are in PERF.md.
//
// Candidates are not padded: the last group of a row may score fewer.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::silu;
using repro_torch::smem_addr;

constexpr int kThreads = 512;
constexpr int kCands = 4;      // candidates per block
constexpr int kChunk = 32;     // history steps per chunk
constexpr int kRows = kCands * kChunk;    // (candidate, step) rows: 128
constexpr int kMaxH1 = 80;     // layer-1 tile: 16 thread columns x 5 units
constexpr int kMaxH2 = 40;     // layer-2 tile: 8 thread columns x 5 units
constexpr int kX1Stride = kRows + 8;    // layer-1 output rows, conflict-free
constexpr int kAhStride = kMaxH1 + 2;   // ah rows, conflict-free
constexpr int kMinCluster = 4, kMaxCluster = 8;
static_assert(kThreads == 16 * kRows / 4, "16 threads per 4 rows");
size_t g_smem_opted[repro_torch::kMaxDevices] = {};

// Offsets (in floats, each a multiple of 4) of the block's shared arrays.
struct Layout {
  int a1r, wd, wac, a2, ab1, ab2, a3, misc, bt, tg, io, uo, hs, ms, ah, ut,
      x1, wt, part, slots, xx, s1, s2, s2p, sc, m1, m2, mb1, mb2, m3, total;
};

__host__ __device__ inline int take(int& at, int n) {
  const int here = at;
  at += (n + 3) & ~3;
  return here;
}

__host__ __device__ inline Layout layout(int D, int du, int di, int M1,
                                         int M2, int CL) {
  const int K1 = 2 * D + du + di;
  const int per1 = (M1 + CL - 1) / CL, per2 = (M2 + CL - 1) / CL;
  Layout s;
  int at = 0;
  s.a1r = take(at, 3 * D * kMaxH1);          // Wa | Wb | Wc, padded rows
  s.wd = take(at, D * kMaxH1);               // Wd
  s.wac = take(at, D * kMaxH1);              // Wa + Wc
  s.a2 = take(at, kMaxH1 * kMaxH2);
  s.ab1 = take(at, kMaxH1);
  s.ab2 = take(at, kMaxH2);
  s.a3 = take(at, kMaxH2);
  s.misc = take(at, 2);                      // ab3, mb3
  s.bt = take(at, kCands * kMaxH1);          // t_c @ (Wb - Wc)
  s.tg = take(at, kCands * D);               // t_c
  s.io = take(at, kCands * di);              // io_c
  s.uo = take(at, du);
  s.hs = take(at, kChunk * D);               // the chunk's history
  s.ms = take(at, kChunk);                   // its mask
  s.ah = take(at, kChunk * kAhStride);       // h @ (Wa + Wc) + ab1
  s.ut = take(at, D * kRows);                // (h * t), transposed
  s.x1 = take(at, kMaxH1 * kX1Stride);       // layer-1 output, transposed
  s.wt = take(at, kRows);                    // masked attention weights
  s.part = take(at, kCands * D);             // this block's pooled partial
  s.slots = take(at, CL * kCands * D);       // every block's partial
  s.xx = take(at, kCands * K1);              // [pooled, t, uo, io]
  s.s1 = take(at, kCands * M1);              // score layer 1, all units
  s.s2 = take(at, kCands * per2);            // this block's layer-2 slice
  s.s2p = take(at, 2 * kCands * per2);       // its two half sums
  s.sc = take(at, CL * kCands);              // every block's score slice
  s.m1 = take(at, K1 * per1);                // this block's M1 columns
  s.m2 = take(at, M1 * per2);                // this block's M2 columns
  s.mb1 = take(at, per1);
  s.mb2 = take(at, per2);
  s.m3 = take(at, per2);
  s.total = at;
  return s;
}

// rows x cols floats from src (row stride ld) into dst (row stride dld) by
// 4-byte cp.async, zero-filled where row >= nrows or col >= ncols: a warp
// per row, a lane per column (no index division)
__device__ __forceinline__ void stage(float* dst, int dld, const float* src,
                                      int ld, int rows, int cols, int nrows,
                                      int ncols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32)
    for (int c = lane; c < cols; c += 32) {
      const bool ok = r < nrows && c < ncols;
      cp_async4(smem_addr(dst + r * dld + c),
                src + (ok ? static_cast<size_t>(r) * ld + c : 0), ok ? 4 : 0);
    }
}

__global__ void __launch_bounds__(kThreads)
rerank_score_fused(const float* __restrict__ hist,
                   const float* __restrict__ mask,
                   const float* __restrict__ tgt, const float* __restrict__ uo,
                   const float* __restrict__ io, const float* __restrict__ a1,
                   const float* __restrict__ ab1, const float* __restrict__ a2,
                   const float* __restrict__ ab2, const float* __restrict__ a3,
                   const float* __restrict__ ab3, const float* __restrict__ m1,
                   const float* __restrict__ mb1, const float* __restrict__ m2,
                   const float* __restrict__ mb2, const float* __restrict__ m3,
                   const float* __restrict__ mb3, float* __restrict__ out,
                   int T, int D, int C, int du, int di, int H1, int H2, int M1,
                   int M2) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int K1 = 2 * D + du + di;
  const Layout L = layout(D, du, di, M1, M2, CL);
  float *a1r = smem + L.a1r, *wd = smem + L.wd, *wac = smem + L.wac;
  float *a2s = smem + L.a2, *ab1s = smem + L.ab1, *ab2s = smem + L.ab2;
  float *a3s = smem + L.a3, *misc = smem + L.misc, *bt = smem + L.bt;
  float *tg = smem + L.tg, *ios = smem + L.io, *uos = smem + L.uo;
  float *hs = smem + L.hs, *ms = smem + L.ms, *ah = smem + L.ah;
  float *ut = smem + L.ut, *x1 = smem + L.x1, *wt = smem + L.wt;
  float *part = smem + L.part, *slots = smem + L.slots, *xx = smem + L.xx;
  float *s1 = smem + L.s1, *s2 = smem + L.s2, *s2p = smem + L.s2p;
  float *sc = smem + L.sc, *m1s = smem + L.m1, *m2s = smem + L.m2;
  float *mb1s = smem + L.mb1, *mb2s = smem + L.mb2, *m3s = smem + L.m3;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kCands, nc = min(kCands, C - c0);
  const int per1 = (M1 + CL - 1) / CL, per2 = (M2 + CL - 1) / CL;
  const int u0 = rank * per1, v0 = rank * per2;
  const int nchunks = (T + kChunk - 1) / kChunk;

  // the cluster's blocks must all have started before one writes into
  // another's shared memory: arrive now, wait before the first such write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // every input in flight at once: the attention's (group 1), then the
  // score MLP's slices (group 2), used only after the attention
  stage(a1r, kMaxH1, a1, H1, 3 * D, kMaxH1, 3 * D, H1);
  stage(wd, kMaxH1, a1 + 3 * D * H1, H1, D, kMaxH1, D, H1);
  stage(a2s, kMaxH2, a2, H2, kMaxH1, kMaxH2, H1, H2);
  stage(ab1s, 0, ab1, 0, 1, kMaxH1, 1, H1);
  stage(ab2s, 0, ab2, 0, 1, kMaxH2, 1, H2);
  stage(a3s, 0, a3, 0, 1, kMaxH2, 1, H2);
  stage(misc, 0, ab3, 0, 1, 1, 1, 1);
  stage(misc + 1, 0, mb3, 0, 1, 1, 1, 1);
  stage(tg, D, tgt + static_cast<size_t>(c0) * D, D, kCands, D, nc, D);
  stage(ios, di, io + static_cast<size_t>(c0) * di, di, kCands, di, nc, di);
  stage(uos, 0, uo, 0, 1, du, 1, du);
  if (rank < nchunks) {
    const int t0 = rank * kChunk, ns = min(kChunk, T - t0);
    stage(hs, D, hist + static_cast<size_t>(t0) * D, D, kChunk, D, ns, D);
    stage(ms, 0, mask + t0, 0, 1, kChunk, 1, ns);
  }
  cp_async_commit();
  stage(m1s, per1, m1 + u0, M1, K1, per1, K1, M1 - u0);
  stage(m2s, per2, m2 + v0, M2, M1, per2, M1, M2 - v0);
  stage(mb1s, 0, mb1 + u0, 0, 1, per1, 1, M1 - u0);
  stage(mb2s, 0, mb2 + v0, 0, 1, per2, 1, M2 - v0);
  stage(m3s, 0, m3 + v0, 0, 1, per2, 1, M2 - v0);
  cp_async_commit();
  for (int i = tid; i < kCands * D; i += kThreads) part[i] = 0.0f;
  cp_async_wait<1>();
  __syncthreads();
  for (int i = tid; i < D * kMaxH1; i += kThreads)
    wac[i] = a1r[i] + a1r[2 * D * kMaxH1 + i];
  for (int i = tid; i < kCands * kMaxH1; i += kThreads) {
    const int c = i / kMaxH1, j = i - c * kMaxH1;
    float a = 0.0f;
    for (int d = 0; d < D; ++d)
      a = fmaf(tg[c * D + d],
               a1r[(D + d) * kMaxH1 + j] - a1r[(2 * D + d) * kMaxH1 + j], a);
    bt[i] = a;
  }
  const float bias3 = misc[0];

  // this thread's rows r0..r0+3 (one candidate, 4 steps); its layer-1
  // units col1 + 16 i; its layer-2 units col2 + 8 i over the rows j = half
  // (mod 2) of A2; for ah, step a0 and units col1 + 16 i
  const int r0 = (tid >> 4) * 4, col1 = tid & 15;
  const int half = tid & 1, col2 = (tid >> 1) & 7;
  const int cand = r0 / kChunk, s0 = r0 - cand * kChunk;
  const int a0 = tid >> 4;
  for (int ch = rank; ch < nchunks; ch += CL) {
    const int t0 = ch * kChunk, ns = min(kChunk, T - t0);
    if (ch != rank) {                // the first chunk came with group 1
      stage(hs, D, hist + static_cast<size_t>(t0) * D, D, kChunk, D, ns, D);
      stage(ms, 0, mask + t0, 0, 1, kChunk, 1, ns);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    {
      float acc[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) acc[i] = ab1s[col1 + 16 * i];
      for (int d = 0; d < D; ++d) {
        const float h = hs[a0 * D + d];
#pragma unroll
        for (int i = 0; i < 5; ++i)
          acc[i] = fmaf(h, wac[d * kMaxH1 + col1 + 16 * i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) ah[a0 * kAhStride + col1 + 16 * i] = acc[i];
    }
    for (int i = tid; i < D * kRows; i += kThreads) {
      const int d = i / kRows, r = i - d * kRows;
      const int c = r / kChunk, s = r - c * kChunk;
      ut[i] = hs[s * D + d] * tg[c * D + d];
    }
    __syncthreads();

    // layer 1: (h * t) @ Wd for 4 rows x 5 units
    float acc1[4][5] = {};
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(ut + d * kRows + r0);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float b = wd[d * kMaxH1 + col1 + 16 * i];
        acc1[0][i] = fmaf(a.x, b, acc1[0][i]);
        acc1[1][i] = fmaf(a.y, b, acc1[1][i]);
        acc1[2][i] = fmaf(a.z, b, acc1[2][i]);
        acc1[3][i] = fmaf(a.w, b, acc1[3][i]);
      }
    }
    // (x1's readers of the last chunk finished before its closing barrier)
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int j = col1 + 16 * i;
      const float b = bt[cand * kMaxH1 + j];
      float4 v;
      v.x = silu(acc1[0][i] + ah[s0 * kAhStride + j] + b);
      v.y = silu(acc1[1][i] + ah[(s0 + 1) * kAhStride + j] + b);
      v.z = silu(acc1[2][i] + ah[(s0 + 2) * kAhStride + j] + b);
      v.w = silu(acc1[3][i] + ah[(s0 + 3) * kAhStride + j] + b);
      *reinterpret_cast<float4*>(x1 + j * kX1Stride + r0) = v;
    }
    __syncthreads();

    // layer 2: @ A2 for 4 rows x 5 units over half of H1, the halves joined
    // by a shuffle; then silu(.) * a3 summed per row across 8 threads
    float acc2[4][5] = {};
#pragma unroll 2
    for (int j = half; j < H1; j += 2) {
      const float4 a = *reinterpret_cast<const float4*>(x1 + j * kX1Stride + r0);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float b = a2s[j * kMaxH2 + col2 + 8 * i];
        acc2[0][i] = fmaf(a.x, b, acc2[0][i]);
        acc2[1][i] = fmaf(a.y, b, acc2[1][i]);
        acc2[2][i] = fmaf(a.z, b, acc2[2][i]);
        acc2[3][i] = fmaf(a.w, b, acc2[3][i]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 5; ++i)
        acc2[q][i] += __shfl_xor_sync(repro_torch::kFullMask, acc2[q][i], 1);
    float w[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {         // this lane's two of the 4 rows
      float v = 0.0f;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int k = col2 + 8 * i;
        v = fmaf(silu((half ? acc2[2 + q][i] : acc2[q][i]) + ab2s[k]), a3s[k],
                 v);
      }
      v += __shfl_xor_sync(repro_torch::kFullMask, v, 2);
      v += __shfl_xor_sync(repro_torch::kFullMask, v, 4);
      v += __shfl_xor_sync(repro_torch::kFullMask, v, 8);
      w[q] = v;
    }
    if (col2 == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = 2 * half + q;
        wt[r0 + row] = (w[q] + bias3) * ms[s0 + row];
      }
    }
    __syncthreads();

    // this chunk's pooled sums, in step order
    for (int i = tid; i < kCands * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      float a = 0.0f;
      for (int s = 0; s < ns; ++s) a = fmaf(wt[c * kChunk + s], hs[s * D + d], a);
      part[i] += a;
    }
    __syncthreads();                 // hs, wt read before the next chunk
  }

  // every block's partial pooled vectors into every block's slots
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = tid; i < CL * kCands * D; i += kThreads) {
    const int q = i / (kCands * D), e = i - q * (kCands * D);
    cluster.map_shared_rank(slots, q)[rank * kCands * D + e] = part[e];
  }
  cp_async_wait<0>();
  cluster.sync();
  // [pooled (the partials in rank order), t, uo, io] for each candidate
  for (int i = tid; i < kCands * K1; i += kThreads) {
    const int c = i / K1, k = i - c * K1;
    float v;
    if (k < D) {
      v = 0.0f;
      for (int q = 0; q < CL; ++q) v += slots[(q * kCands + c) * D + k];
    } else if (k < 2 * D) {
      v = tg[c * D + k - D];
    } else if (k < 2 * D + du) {
      v = uos[k - 2 * D];
    } else {
      v = ios[c * di + (k - 2 * D - du)];
    }
    xx[i] = v;
  }
  __syncthreads();

  // score layer 1, this block's units, to every block of the cluster
  for (int i = tid; i < kCands * per1; i += kThreads) {
    const int c = i / per1, jj = i - c * per1, j = u0 + jj;
    if (j >= M1) continue;
    const float* x = xx + c * K1;
    float acc[4] = {mb1s[jj], 0.0f, 0.0f, 0.0f};
    int k = 0;
    for (; k + 3 < K1; k += 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e] = fmaf(x[k + e], m1s[(k + e) * per1 + jj], acc[e]);
    }
    for (; k < K1; ++k) acc[0] = fmaf(x[k], m1s[k * per1 + jj], acc[0]);
    const float v = silu((acc[0] + acc[1]) + (acc[2] + acc[3]));
    for (int q = 0; q < CL; ++q) cluster.map_shared_rank(s1, q)[c * M1 + j] = v;
  }
  cluster.sync();

  // score layer 2, this block's units: two threads per unit, each half of
  // M1, then silu(.) * m3
  const int mid = (M1 + 1) / 2;
  for (int i = tid; i < 2 * kCands * per2; i += kThreads) {
    const int o = i >> 1, h = i & 1;
    const int c = o / per2, kk = o - c * per2;
    const float* x = s1 + c * M1;
    float acc[4] = {};
    const int j1 = h ? M1 : mid;
    int j = h ? mid : 0;
    for (; j + 3 < j1; j += 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e] = fmaf(x[j + e], m2s[(j + e) * per2 + kk], acc[e]);
    }
    for (; j < j1; ++j) acc[0] = fmaf(x[j], m2s[j * per2 + kk], acc[0]);
    s2p[i] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  __syncthreads();
  for (int o = tid; o < kCands * per2; o += kThreads) {
    const int kk = o % per2;
    s2[o] = v0 + kk < M2
                ? silu(mb2s[kk] + s2p[2 * o] + s2p[2 * o + 1]) * m3s[kk]
                : 0.0f;
  }
  __syncthreads();
  if (tid < kCands) {
    float v = 0.0f;
    for (int kk = 0; kk < per2; ++kk) v += s2[tid * per2 + kk];
    cluster.map_shared_rank(sc, 0)[rank * kCands + tid] = v;
  }
  cluster.sync();
  if (rank == 0 && tid < nc) {
    float v = 0.0f;
    for (int q = 0; q < CL; ++q) v += sc[q * kCands + tid];
    out[c0 + tid] = v + misc[1];
  }
}

}  // namespace

// H1 <= kMaxH1, H2 <= kMaxH2; no scratch. Returns the first CUDA error.
extern "C" int rerank_score_f32(
    const void* hist, const void* mask, const void* tgt, const void* uo,
    const void* io, const void* a1, const void* ab1, const void* a2,
    const void* ab2, const void* a3, const void* ab3, const void* m1,
    const void* mb1, const void* m2, const void* mb2, const void* m3,
    const void* mb3, void* out, int T, int D, int C, int du, int di, int H1,
    int H2, int M1, int M2, void* stream) {
  if (H1 > kMaxH1 || H2 > kMaxH2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 0) return static_cast<int>(cudaSuccess);
  const int nchunks = (T + kChunk - 1) / kChunk;
  const int CL = std::min(kMaxCluster, std::max(kMinCluster, nchunks));
  const size_t bytes =
      static_cast<size_t>(layout(D, du, di, M1, M2, CL).total) * sizeof(float);
  cudaError_t err =
      repro_torch::allow_smem(rerank_score_fused, bytes, g_smem_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, (C + kCands - 1) / kCands);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  err = cudaLaunchKernelEx(&cfg, rerank_score_fused, f(hist), f(mask), f(tgt),
                           f(uo), f(io), f(a1), f(ab1), f(a2), f(ab2), f(a3),
                           f(ab3), f(m1), f(mb1), f(m2), f(mb2), f(m3), f(mb3),
                           static_cast<float*>(out), T, D, C, du, di, H1, H2,
                           M1, M2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

