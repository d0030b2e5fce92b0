// DIN local activation unit, one target per row.
//
// Replaces src/repro/kernels/din_attention/kernel.py::din_attention_pallas.
//
//   feat[t] = [h_t, tgt, h_t - tgt, h_t * tgt]               (4D)
//   w_t     = (silu(silu(feat[t] @ W1 + b1) @ W2 + b2) @ w3 + b3) * mask_t
//   out     = sum_t w_t * h_t                                 (D)
//
// The feature block is never built. With W1 split into its row blocks
// (Wa | Wb | Wc | Wd) in the concat order above,
//   feat @ W1 = [h, h * tgt] @ [Wa + Wc; Wd] + tgt @ (Wb - Wc),
// and the last term is one vector per row, folded into the bias:
// bias1 = b1 + tgt @ (Wb - Wc), from the staged weights.
//
// Bound on the H100: neither bytes nor flops at serving shapes, but
// latency. The inputs are small (a row's history is T*D floats, the
// weights ~36 KB) and the work ~20 MFLOP at B = 16, T = 100, well under a
// microsecond at either roof; what costs is a launch, the chain of phases
// inside a block and the barriers.
//
// One launch. The history of a row is cut into chunks of kChunk = 16
// steps; the blocks of one row form a thread-block cluster of CL blocks,
// block r taking chunks r, r + CL, ... (at T = 100: 7 blocks of one chunk
// each, 112 blocks at B = 16, where the first design ran 64 blocks of 32
// steps and a second launch to sum them). CL is at most kMaxCluster = 8
// and at most the chunks, and shrinks for large B so that the grid stays
// within what the card holds at once. Every input comes in by cp.async at
// the start (16-byte copies where the layout allows). Per chunk, the two
// hidden layers are register-tiled products from shared memory: a thread
// owns 4 steps x 5 units, reads one float4 of the steps' inputs and 5
// weights per step of K (the first design read two shared operands per
// multiply-add), and the threads that split K join their sums by
// shuffles, each keeping its own rows. Layer 1 (K = 2D over [h, h * tgt])
// splits K in 2, layer 2 (K = H1) in 4; silu(.) * w3 is then summed per
// step across the 8 threads of its units. The block's pooled partial (D
// floats) goes to block 0 of the cluster through distributed shared
// memory, and block 0 sums the partials in rank order: the result does
// not depend on scheduling, and nothing but the output reaches device
// memory (the first design kept per-chunk partials in a scratch buffer).
//
// Tiles: H1 <= kMaxH1 = 80 (16 thread columns x 5) and H2 <= kMaxH2 = 40
// (8 x 5), zero-padded: a padded unit is silu(0) = 0 times a zero weight.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (device time per
// call by CUDA-graph replay, PERF.md, PR 16): B = 16, T = 100, D = 18,
// 80-40: 0.0084 ms against 0.0181 for the first design (two launches, 64
// blocks) in the same chip call; an empty kernel's launch 0.0011, the
// float32 op bound 0.0002.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro_torch::cp_async16;
using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::silu;
using repro_torch::smem_addr;

constexpr int kThreads = 128;
constexpr int kChunk = 16;      // history steps per chunk
constexpr int kMaxH1 = 80;      // layer-1 tile: 16 thread columns x 5 units
constexpr int kMaxH2 = 40;      // layer-2 tile: 8 thread columns x 5 units
constexpr int kMaxCluster = 8;
constexpr int kH1Stride = kChunk + 4;   // layer-1 output rows: float4 reads
static_assert(kThreads == 2 * 16 * (kChunk / 4), "layer 1: 2 x 16 x 4");
static_assert(kThreads == 4 * 8 * (kChunk / 4), "layer 2: 4 x 8 x 4");
size_t g_smem_opted[repro_torch::kMaxDevices] = {};
int g_sms[repro_torch::kMaxDevices] = {};      // per device: SMs
int g_sm_smem[repro_torch::kMaxDevices] = {};  // and shared memory per SM

// Offsets (in floats, each a multiple of 4) of the block's shared arrays.
struct Layout {
  int wbc, wl1, w2, b1, b2, w3, misc, tg, bias1, hs, ms, xt, h1t, wt, part,
      slots, total;
};

__host__ __device__ inline int take(int& at, int n) {
  const int here = at;
  at += (n + 3) & ~3;
  return here;
}

__host__ __device__ inline Layout layout(int D) {
  Layout s;
  int at = 0;
  s.wbc = take(at, 2 * D * kMaxH1);   // Wb | Wc
  s.wl1 = take(at, 2 * D * kMaxH1);   // Wa (then Wa + Wc) | Wd
  s.w2 = take(at, kMaxH1 * kMaxH2);
  s.b1 = take(at, kMaxH1);
  s.b2 = take(at, kMaxH2);
  s.w3 = take(at, kMaxH2);
  s.misc = take(at, 1);               // b3
  s.tg = take(at, D);
  s.bias1 = take(at, kMaxH1);         // b1 + tgt @ (Wb - Wc)
  s.hs = take(at, kChunk * D);        // the chunk's history steps
  s.ms = take(at, kChunk);            // their mask
  s.xt = take(at, 2 * D * kChunk);    // [h, h * tgt], transposed
  s.h1t = take(at, kMaxH1 * kH1Stride);   // layer-1 output, transposed
  s.wt = take(at, kChunk);            // masked activation weights
  s.part = take(at, D);               // this block's pooled partial
  s.slots = take(at, kMaxCluster * D);    // block 0: every block's partial
  s.total = at;
  return s;
}

// rows x cols floats from src (row stride ld) into dst (row stride dld) by
// cp.async, zero-filled where row >= nrows or col >= ncols: 16-byte copies
// when both sides are one dense aligned run, else a warp per row and a
// lane per column
__device__ __forceinline__ void stage(float* dst, int dld, const float* src,
                                      int ld, int rows, int cols, int nrows,
                                      int ncols) {
  const int n = rows * cols;
  if (dld == cols && ld == cols && nrows == rows && ncols == cols &&
      n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (smem_addr(dst) & 15) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads)
      cp_async16(smem_addr(dst + 4 * i), src + 4 * i, 16);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32)
    for (int c = lane; c < cols; c += 32) {
      const bool ok = r < nrows && c < ncols;
      cp_async4(smem_addr(dst + r * dld + c),
                src + (ok ? static_cast<size_t>(r) * ld + c : 0), ok ? 4 : 0);
    }
}

// the n steps of a chunk (zero-filled to kChunk) and their mask
__device__ __forceinline__ void stage_chunk(float* hs, float* ms,
                                            const float* hrow,
                                            const float* mrow, int D, int n) {
  for (int i = threadIdx.x; i < kChunk * D; i += kThreads) {
    const bool ok = i < n * D;
    cp_async4(smem_addr(hs + i), hrow + (ok ? i : 0), ok ? 4 : 0);
  }
  for (int i = threadIdx.x; i < kChunk; i += kThreads) {
    const bool ok = i < n;
    cp_async4(smem_addr(ms + i), mrow + (ok ? i : 0), ok ? 4 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
din_attention_fused(const float* __restrict__ hist,
                    const float* __restrict__ mask,
                    const float* __restrict__ tgt,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    float* __restrict__ out, int T, int D, int H1, int H2) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout L = layout(D);
  float *wbc = smem + L.wbc, *wl1 = smem + L.wl1, *w2s = smem + L.w2;
  float *b1s = smem + L.b1, *b2s = smem + L.b2, *w3s = smem + L.w3;
  float *misc = smem + L.misc, *tg = smem + L.tg, *bias1 = smem + L.bias1;
  float *hs = smem + L.hs, *ms = smem + L.ms, *xt = smem + L.xt;
  float *h1t = smem + L.h1t, *wt = smem + L.wt, *part = smem + L.part;
  float* slots = smem + L.slots;
  const int tid = threadIdx.x, b = blockIdx.x / CL;
  const int nchunks = (T + kChunk - 1) / kChunk;
  const int DH = D * kMaxH1;
  const float* hrow = hist + static_cast<size_t>(b) * T * D;
  const float* mrow = mask + static_cast<size_t>(b) * T;

  // the cluster's blocks must all have started before one writes into
  // block 0's shared memory: arrive now, wait before that write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // every input in flight at once: Wa and Wd side by side (the first
  // layer's weights), Wb | Wc (for bias1), the rest, the first chunk
  stage(wl1, kMaxH1, w1, H1, D, kMaxH1, D, H1);                       // Wa
  stage(wbc, kMaxH1, w1 + D * H1, H1, 2 * D, kMaxH1, 2 * D, H1);      // Wb|Wc
  stage(wl1 + DH, kMaxH1, w1 + 3 * D * H1, H1, D, kMaxH1, D, H1);     // Wd
  stage(w2s, kMaxH2, w2, H2, kMaxH1, kMaxH2, H1, H2);
  stage(b1s, 0, b1, 0, 1, kMaxH1, 1, H1);
  stage(b2s, 0, b2, 0, 1, kMaxH2, 1, H2);
  stage(w3s, 0, w3, 0, 1, kMaxH2, 1, H2);
  stage(misc, 0, b3, 0, 1, 1, 1, 1);
  stage(tg, 0, tgt + static_cast<size_t>(b) * D, 0, 1, D, 1, D);
  if (rank < nchunks) {
    const int t0 = rank * kChunk;
    stage_chunk(hs, ms, hrow + static_cast<size_t>(t0) * D, mrow + t0, D,
                min(kChunk, T - t0));
  }
  cp_async_commit();
  for (int i = tid; i < D; i += kThreads) part[i] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < DH; i += kThreads) wl1[i] += wbc[DH + i];  // Wa + Wc
  for (int j = tid; j < kMaxH1; j += kThreads) {
    float a = b1s[j];
    for (int d = 0; d < D; ++d)
      a = fmaf(tg[d], wbc[d * kMaxH1 + j] - wbc[DH + d * kMaxH1 + j], a);
    bias1[j] = a;
  }
  const float bias3 = misc[0];

  // layer 1: this thread's steps 4 g1 .. 4 g1 + 3, units c1 + 16 i, over
  // the rows k = h1 (mod 2) of [Wa + Wc; Wd]; it keeps steps 2 h1, 2 h1 + 1
  const int h1 = tid & 1, c1 = (tid >> 1) & 15, g1 = tid >> 5;
  // layer 2: steps 4 g2 .. 4 g2 + 3, units c2 + 8 i, over the rows
  // j = q2 (mod 4) of W2; it keeps step q2
  const int q2 = tid & 3, c2 = (tid >> 2) & 7, g2 = tid >> 5;
  for (int ch = rank; ch < nchunks; ch += CL) {
    const int t0 = ch * kChunk, n = min(kChunk, T - t0);
    if (ch != rank) {                // the first chunk came with the weights
      __syncthreads();               // hs, ms, wt read by the last chunk
      stage_chunk(hs, ms, hrow + static_cast<size_t>(t0) * D, mrow + t0, D,
                  n);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int i = tid; i < 2 * D * kChunk; i += kThreads) {
      const int k = i / kChunk, s = i - k * kChunk;
      xt[i] = k < D ? hs[s * D + k] : hs[s * D + k - D] * tg[k - D];
    }
    __syncthreads();

    {  // layer 1
      float acc[4][5] = {};
#pragma unroll 2
      for (int k = h1; k < 2 * D; k += 2) {
        const float4 a =
            *reinterpret_cast<const float4*>(xt + k * kChunk + 4 * g1);
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float w = wl1[k * kMaxH1 + c1 + 16 * i];
          acc[0][i] = fmaf(a.x, w, acc[0][i]);
          acc[1][i] = fmaf(a.y, w, acc[1][i]);
          acc[2][i] = fmaf(a.z, w, acc[2][i]);
          acc[3][i] = fmaf(a.w, w, acc[3][i]);
        }
      }
      // the two K halves swap the steps each gives away
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int j = c1 + 16 * i;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float mine = h1 ? acc[2 + q][i] : acc[q][i];
          const float give = h1 ? acc[q][i] : acc[2 + q][i];
          v[q] = silu(mine + __shfl_xor_sync(repro_torch::kFullMask, give, 1) +
                      bias1[j]);
        }
        *reinterpret_cast<float2*>(h1t + j * kH1Stride + 4 * g1 + 2 * h1) =
            make_float2(v[0], v[1]);
      }
    }
    __syncthreads();

    {  // layer 2, then silu(.) * w3 summed per step
      float acc[4][5] = {};
#pragma unroll 2
      for (int j = q2; j < kMaxH1; j += 4) {
        const float4 a =
            *reinterpret_cast<const float4*>(h1t + j * kH1Stride + 4 * g2);
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float w = w2s[j * kMaxH2 + c2 + 8 * i];
          acc[0][i] = fmaf(a.x, w, acc[0][i]);
          acc[1][i] = fmaf(a.y, w, acc[1][i]);
          acc[2][i] = fmaf(a.z, w, acc[2][i]);
          acc[3][i] = fmaf(a.w, w, acc[3][i]);
        }
      }
      // reduce-scatter over the 4 K quarters: keep steps 2 (q2 >> 1) and
      // 2 (q2 >> 1) + 1 after the swap across lane bit 1, then step q2
      const bool hi2 = q2 & 2, hi1 = q2 & 1;
      float pair[2][5];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float mine = hi2 ? acc[2 + q][i] : acc[q][i];
          const float give = hi2 ? acc[q][i] : acc[2 + q][i];
          pair[q][i] =
              mine + __shfl_xor_sync(repro_torch::kFullMask, give, 2);
        }
      float v = 0.0f;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int k = c2 + 8 * i;
        const float mine = hi1 ? pair[1][i] : pair[0][i];
        const float give = hi1 ? pair[0][i] : pair[1][i];
        const float x =
            mine + __shfl_xor_sync(repro_torch::kFullMask, give, 1);
        v = fmaf(silu(x + b2s[k]), w3s[k], v);
      }
      v += __shfl_xor_sync(repro_torch::kFullMask, v, 4);
      v += __shfl_xor_sync(repro_torch::kFullMask, v, 8);
      v += __shfl_xor_sync(repro_torch::kFullMask, v, 16);
      if (c2 == 0) {
        const int s = 4 * g2 + q2;
        wt[s] = (v + bias3) * ms[s];
      }
    }
    __syncthreads();

    // this chunk's pooled sums, in step order
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.0f;
      for (int s = 0; s < n; ++s) a = fmaf(wt[s], hs[s * D + d], a);
      part[d] += a;
    }
  }

  // every block's partial into block 0's slots, summed there in rank order
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* slots0 = cluster.map_shared_rank(slots, 0);
  for (int d = tid; d < D; d += kThreads) slots0[rank * D + d] = part[d];
  cluster.sync();
  if (rank == 0) {
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.0f;
      for (int q = 0; q < CL; ++q) a += slots[q * D + d];
      out[static_cast<size_t>(b) * D + d] = a;
    }
  }
}

// blocks of `bytes` of shared memory the card holds at once: SMs x blocks
// per SM by shared memory (1 KB of each block's is the system's) and by
// threads; the card's two figures are read once per device
int resident_blocks(size_t bytes) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= repro_torch::kMaxDevices)
    return 0;
  if (g_sms[dev] == 0) {
    cudaDeviceGetAttribute(&g_sm_smem[dev],
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  const int per_sm = std::min(2048 / kThreads,
                              static_cast<int>(g_sm_smem[dev] / (bytes + 1024)));
  return g_sms[dev] * std::max(1, per_sm);
}

}  // namespace

// H1 <= kMaxH1, H2 <= kMaxH2; no scratch. Returns the first CUDA error.
extern "C" int din_attention_f32(const void* hist, const void* mask,
                                 const void* tgt, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, const void* w3,
                                 const void* b3, void* out, int B, int T,
                                 int D, int H1, int H2, void* stream) {
  if (H1 > kMaxH1 || H2 > kMaxH2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const size_t bytes = static_cast<size_t>(layout(D).total) * sizeof(float);
  cudaError_t err =
      repro_torch::allow_smem(din_attention_fused, bytes, g_smem_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a cluster over the row's chunks, as wide as the card holds for B rows
  const int nchunks = (T + kChunk - 1) / kChunk;
  const int CL = std::max(
      1, std::min({kMaxCluster, nchunks, resident_blocks(bytes) / B}));
  cudaLaunchConfig_t cfg = {};
  // one x extent of B clusters (row b = blockIdx.x / CL): a training batch
  // of 65,536 rows and more launches, where the y extent stops at 65,535
  cfg.gridDim = dim3(CL * B);
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
  err = cudaLaunchKernelEx(&cfg, din_attention_fused, f(hist), f(mask),
                           f(tgt), f(w1), f(b1), f(w2), f(b2), f(w3), f(b3),
                           static_cast<float*>(out), T, D, H1, H2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
