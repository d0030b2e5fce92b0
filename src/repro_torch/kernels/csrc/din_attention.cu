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
// Bound on the H100: float32 multiply-adds on the CUDA cores (~6,100 a
// history step at D = 18, 80-40, and 120 silu; the bytes are ~19 floats
// a step). Two paths, one launch a call either way, both kernels named
// din_attention_fused; the shape alone picks one. With chunks =
// ceil(T / kChunk) (kChunk = 16 steps) and R the cluster path's blocks the
// card holds at once (SMs x blocks an SM by shared memory: 528 at D = 18,
// so B <= 75 at T = 100): B * chunks <= R, chunks > kBulkThreads, or a
// bulk layout past a block's shared memory (D past 55) takes the cluster
// path; the rest the bulk path.
//
// Cluster path (serving latency, B = 16): the blocks of one row form a
// thread-block cluster of CL blocks, block r taking chunks r, r + CL, ...
// (at T = 100: 7 blocks of one chunk each, 112 blocks at B = 16). CL is at
// most kMaxCluster = 8 and at most the chunks, and shrinks for large B so
// that the grid stays within what the card holds at once. Every input
// comes in by cp.async at the start. Per chunk, the two hidden layers are
// register-tiled products from shared memory: a thread owns 4 steps x 5
// units, and the threads that split K join their sums by shuffles. Layer
// 1 (K = 2D over [h, h * tgt]) splits K in 2, layer 2 (K = H1) in 4;
// silu(.) * w3 is then summed per step across the 8 threads of its units.
// The block's pooled partial (D floats) goes to block 0 of the cluster
// through distributed shared memory, and block 0 sums the partials in rank
// order. It computes every chunk of every row, masked or not.
//
// Bulk path (the DNN stage's 65,536 pairs, the service's micro-batches of
// 512, training's forward): persistent blocks, one wave of them (SMs x
// the blocks an SM holds: 2 x 132 at D = 18, 8 warps and ~109 KB of shared
// memory each), block i taking rows i, i + grid, ... in that order.
//  - The weights are staged once a block, and [Wa + Wc; Wd] and Wb - Wc
//    folded once a block; only bias1 (2 D H1 multiply-adds) is per row,
//    once in each group the row reaches.
//  - Only the chunks whose mask holds a non-zero are computed. A block
//    scans the masks of its next rows (a chunk a thread) into a ring of
//    (row, chunk) entries; a row whose mask is all zero gets its zero
//    output there. A skipped chunk adds nothing: its steps' weights are
//    (...) * 0. At valid lengths uniform in 1-100 of T = 100 the steps
//    computed fall from 112 a row to ~58: 1.15 a valid step.
//  - A group packs the next kBulkTiles = 8 chunks of the ring, of one row
//    or several, into one product of M = 128 steps. A thread owns 4 steps
//    x 10 units of layer 1 (40 sums over all of K = 2D) and of one half of
//    layer 2's K (the halves joined by shuffles): per K row one float4 of
//    steps and 10 weights in two float4 and a float2 (a column of units
//    padded to kUnitPad floats), against the cluster path's 20 sums for a
//    float4 and 5 scalar loads. Layer 1's output goes out transposed,
//    its step groups XOR-swizzled by unit column, so that the stores and
//    layer 2's loads meet no bank conflict. Six block barriers a group.
//  - The next group's history, mask and targets come in by cp.async into
//    the other half of a double-buffered ring while this group computes.
//  - The pooled sum is segmented: a chunk's partial (its 16 steps in
//    order), then a row's partials in chunk order, as the cluster path
//    with one block a row sums them; a row's result does not depend on
//    the packing or on scheduling.
//
// Steps counter: given a non-null device pointer, each block adds the
// history steps it computed, kChunk a computed chunk (padding past T
// included): B * chunks * kChunk on the cluster path, kChunk x the
// chunks with a non-zero mask entry on the bulk path. Null on every
// serving and training path; ops.computed_steps turns it on.
//
// Tiles: H1 <= kMaxH1 = 80 and H2 <= kMaxH2 = 40, zero-padded: a padded
// unit is silu(0) = 0 times a zero weight.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (device time per
// call by CUDA-graph replay; an empty kernel's launch 0.0011 ms):
//  - cluster path, B = 16, T = 100, D = 18, 80-40: 0.00836-0.00846 ms,
//    the float32 op bound 0.0002;
//  - bulk path, B = 65,536, T = 100, valid lengths uniform in 1-100:
//    2.002-2.004 ms against 4.712 for the cluster path it replaces, in
//    the same call; the op bound 0.609 ms (30% of it). At full masks the
//    layers' multiply-add loops take ~60% of it and silu ~20% (PERF.md).
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

// the bulk path
constexpr int kBulkThreads = 256;
constexpr int kBulkTiles = 8;     // history tiles (chunks) a group
constexpr int kBulkList = 512;    // the ring of (row, tile) entries
constexpr int kRegSteps = 4;      // a thread's steps in both layers
constexpr int kRegUnits = 10;     // and its units, one column of them
constexpr int kUnitPad = 12;      // floats a column takes in a weight row
constexpr int kBulkSteps = kBulkTiles * kChunk;    // a group's M
// layer-1 output rows: rows j and j + 1 (layer 2's two K halves) on
// opposite halves of the banks
constexpr int kBulkStride = kBulkSteps + 16;
constexpr int kCols1 = kMaxH1 / kRegUnits;         // 8 unit columns
constexpr int kCols2 = kMaxH2 / kRegUnits;         // 4
constexpr int kW1Row = kCols1 * kUnitPad;          // 96 floats
constexpr int kW2Row = kCols2 * kUnitPad;          // 48
constexpr int kLast = 1 << 30;    // entry flag: the last tile of its row
static_assert(kMaxH1 % kRegUnits == 0 && kMaxH2 % kRegUnits == 0, "units");
static_assert(kBulkThreads == (kBulkSteps / kRegSteps) * kCols1,
              "layer 1: 32 step groups x 8 unit columns");
static_assert(kBulkThreads == (kBulkSteps / kRegSteps) * kCols2 * 2,
              "layer 2: 32 step groups x 4 unit columns x 2 K halves");
static_assert(kCols1 <= 8 && kBulkSteps / kRegSteps % 8 == 0,
              "the output swizzle: step group ^ unit column");
static_assert(kCols2 == 4, "layer 2's column sum: lane bits 0-1");
static_assert(kBulkThreads == 2 * kBulkSteps,
              "layer 1's operand: a thread a step and a half of K");
static_assert(kChunk % kRegSteps == 0, "a thread's steps lie in one tile");
static_assert(kBulkTiles + 1 + kBulkThreads <= kBulkList,
              "the ring holds the leftover and one scan");
static_assert((kBulkList & (kBulkList - 1)) == 0, "ring index by mask");

size_t g_smem_opted[repro_torch::kMaxDevices] = {};
size_t g_bulk_opted[repro_torch::kMaxDevices] = {};
int g_sms[repro_torch::kMaxDevices] = {};      // per device: SMs
int g_sm_smem[repro_torch::kMaxDevices] = {};  // and shared memory per SM
int g_block_smem[repro_torch::kMaxDevices] = {};  // and the most a block has
// per device: the bulk path's blocks an SM (occupancy) at g_bulk_bytes
int g_bulk_per_sm[repro_torch::kMaxDevices] = {};
size_t g_bulk_bytes[repro_torch::kMaxDevices] = {};

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

// The bulk path's shared arrays (floats; the ring's entries are int2).
struct BulkLayout {
  int w1f, wdiff, w2, b1, b2, w3, misc, un, hs, ms, tg, bias1, wt, part,
      rac, q, sl, wcnt, rowany, total;
};

__host__ __device__ inline BulkLayout bulk_layout(int D) {
  BulkLayout s;
  int at = 0;
  s.w1f = take(at, 2 * D * kW1Row);   // [Wa + Wc; Wd], 12-float columns
  s.wdiff = take(at, D * kMaxH1);     // Wb - Wc
  s.w2 = take(at, kMaxH1 * kW2Row);   // W2, 12-float columns
  s.b1 = take(at, kMaxH1);
  s.b2 = take(at, kMaxH2);
  s.w3 = take(at, kMaxH2);
  s.misc = take(at, 1);               // b3
  // one region, in turn: W1 and W2 as they come, for the fold; a group's
  // [h, h * tgt] transposed (layer 1's operand); its layer-1 output
  // transposed
  int un = 2 * D * kBulkSteps;
  un = un > kMaxH1 * kBulkStride ? un : kMaxH1 * kBulkStride;
  un = un > 4 * D * kMaxH1 + kMaxH1 * kMaxH2 ? un
                                             : 4 * D * kMaxH1 + kMaxH1 * kMaxH2;
  s.un = take(at, un);
  s.hs = take(at, 2 * kBulkSteps * D);    // two groups' history steps
  s.ms = take(at, 2 * kBulkSteps);        // their masks
  s.tg = take(at, 2 * kBulkTiles * D);    // each tile's target
  s.bias1 = take(at, kBulkTiles * kMaxH1);  // a row's, in its first slot
  s.wt = take(at, kBulkSteps);        // masked activation weights
  s.part = take(at, kBulkTiles * D);  // each tile's pooled partial
  s.rac = take(at, D);                // the open row's pooled sum
  s.q = take(at, 2 * kBulkList);      // the ring of (row, tile) entries
  s.sl = take(at, 3 * 2 * kBulkTiles);  // three groups' entries
  s.wcnt = take(at, kBulkThreads / 32);
  s.rowany = take(at, kBulkThreads);
  s.total = at;
  return s;
}

// rows x cols floats from src (row stride ld) into dst (row stride dld) by
// cp.async, zero-filled where row >= nrows or col >= ncols: 16-byte copies
// when both sides are one dense aligned run, else a warp per row and a
// lane per column; NT threads take part
template <int NT>
__device__ __forceinline__ void stage(float* dst, int dld, const float* src,
                                      int ld, int rows, int cols, int nrows,
                                      int ncols) {
  const int n = rows * cols;
  if (dld == cols && ld == cols && nrows == rows && ncols == cols &&
      n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (smem_addr(dst) & 15) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += NT)
      cp_async16(smem_addr(dst + 4 * i), src + 4 * i, 16);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += NT / 32)
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

// the steps counter: a block's computed steps, added once
__device__ __forceinline__ void add_steps(unsigned long long* steps,
                                          unsigned long long n) {
  if (steps != nullptr && threadIdx.x == 0 && n > 0) atomicAdd(steps, n);
}

__global__ void __launch_bounds__(kThreads)
din_attention_fused(const float* __restrict__ hist,
                    const float* __restrict__ mask,
                    const float* __restrict__ tgt,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    float* __restrict__ out, unsigned long long* steps, int T,
                    int D, int H1, int H2) {
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
  stage<kThreads>(wl1, kMaxH1, w1, H1, D, kMaxH1, D, H1);                 // Wa
  stage<kThreads>(wbc, kMaxH1, w1 + D * H1, H1, 2 * D, kMaxH1, 2 * D, H1);
  stage<kThreads>(wl1 + DH, kMaxH1, w1 + 3 * D * H1, H1, D, kMaxH1, D, H1);
  stage<kThreads>(w2s, kMaxH2, w2, H2, kMaxH1, kMaxH2, H1, H2);
  stage<kThreads>(b1s, 0, b1, 0, 1, kMaxH1, 1, H1);
  stage<kThreads>(b2s, 0, b2, 0, 1, kMaxH2, 1, H2);
  stage<kThreads>(w3s, 0, w3, 0, 1, kMaxH2, 1, H2);
  stage<kThreads>(misc, 0, b3, 0, 1, 1, 1, 1);
  stage<kThreads>(tg, 0, tgt + static_cast<size_t>(b) * D, 0, 1, D, 1, D);
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
  int computed = 0;
  for (int ch = rank; ch < nchunks; ch += CL) {
    const int t0 = ch * kChunk, n = min(kChunk, T - t0);
    ++computed;
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
  add_steps(steps, static_cast<unsigned long long>(computed) * kChunk);

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

// ------------------------------------------------------------- bulk path

struct BulkArgs {
  const float *hist, *mask, *tgt, *w1, *b1, *w2, *b2, *w3, *b3;
  float* out;
  unsigned long long* steps;
  int B, T, D, H1, H2;
};

// The ring's state, the same in every thread of a block: entries
// [head, tail) are tiles not yet taken, rows from `next` on (stride
// gridDim.x) not yet scanned.
struct Ring {
  int head, tail;
  long long next;
};

// Scan the masks of this block's next rows, one (row, tile) a thread, until
// the ring holds more than a group or no row is left: each tile with a
// non-zero mask entry joins the ring in (row, tile) order, and a row with
// none gets its zero output here. Every thread of the block calls it.
__device__ __forceinline__ void refill(const BulkArgs& a, Ring& r, int2* q,
                                       int* wcnt, int* rowany, int nch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = max(1, kBulkThreads / nch);     // rows a scan
  const long long stride = gridDim.x;
  while (r.tail - r.head <= kBulkTiles && r.next < a.B) {
    const int k = tid / nch, t = tid - k * nch;
    const long long row = r.next + k * stride;
    bool nz = false;
    if (k < rows && row < a.B) {
      const float* m = a.mask + row * a.T + t * kChunk;
      const int nv = min(kChunk, a.T - t * kChunk);
#pragma unroll
      for (int s = 0; s < kChunk; ++s) nz |= s < nv && m[s] != 0.0f;
      if (nz) rowany[k] = 1;
    }
    const unsigned bal = __ballot_sync(repro_torch::kFullMask, nz);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = __popc(bal & ((1u << lane) - 1)), total = 0;
    for (int w = 0; w < kBulkThreads / 32; ++w) {
      off += w < warp ? wcnt[w] : 0;
      total += wcnt[w];
    }
    if (nz)
      q[(r.tail + off) & (kBulkList - 1)] =
          make_int2(static_cast<int>(row), t);
    if (tid < rows) {
      const long long zr = r.next + tid * stride;
      if (zr < a.B && !rowany[tid])
        for (int d = 0; d < a.D; ++d) a.out[zr * a.D + d] = 0.0f;
      rowany[tid] = 0;
    }
    __syncthreads();
    r.tail += total;
    r.next += rows * stride;
  }
}

// Take the next group (up to kBulkTiles entries) off the ring into `sl`,
// each marked kLast where its row ends, and start the copies of its
// history, mask and targets into one half of the ring's buffers (empty
// slots and steps past T zero-filled). Returns the tiles taken.
__device__ __forceinline__ int take_group(const BulkArgs& a, Ring& r,
                                          const int2* q, int2* sl, float* hs,
                                          float* ms, float* tg, bool vec) {
  const int tid = threadIdx.x, D = a.D, T = a.T;
  const int n = min(kBulkTiles, r.tail - r.head);
  constexpr int kMaskQ = kBulkList - 1;
  if (tid < kBulkTiles) {
    int2 e = make_int2(-1, 0);
    if (tid < n) {
      e = q[(r.head + tid) & kMaskQ];
      const int at = r.head + tid + 1;
      if (at == r.tail || q[at & kMaskQ].x != e.x) e.y |= kLast;
    }
    sl[tid] = e;
  }
  // where a slot's history starts, and how many of its floats are there
  auto slot_src = [&](int slot, int& nf) -> size_t {
    if (slot >= n) {
      nf = 0;
      return 0;
    }
    const int2 e = q[(r.head + slot) & kMaskQ];
    nf = min(kChunk, T - e.y * kChunk) * D;
    return (static_cast<size_t>(e.x) * T + e.y * kChunk) * D;
  };
  if (vec) {   // 16-byte copies: 4 D of them a tile
    for (int c = tid; c < kBulkTiles * 4 * D; c += kBulkThreads) {
      const int slot = c / (4 * D), j = c - slot * 4 * D;
      int nf;
      const size_t at = slot_src(slot, nf);
      const int bytes = 4 * max(0, min(4, nf - 4 * j));
      cp_async16(smem_addr(hs + slot * kChunk * D + 4 * j),
                 a.hist + (bytes ? at + 4 * j : 0), bytes);
    }
  } else {
    for (int c = tid; c < kBulkTiles * kChunk * D; c += kBulkThreads) {
      const int slot = c / (kChunk * D), j = c - slot * kChunk * D;
      int nf;
      const size_t at = slot_src(slot, nf);
      const bool ok = j < nf;
      cp_async4(smem_addr(hs + c), a.hist + (ok ? at + j : 0), ok ? 4 : 0);
    }
  }
  for (int c = tid; c < kBulkSteps; c += kBulkThreads) {
    const int slot = c / kChunk, s = c - slot * kChunk;
    bool ok = false;
    size_t at = 0;
    if (slot < n) {
      const int2 e = q[(r.head + slot) & kMaskQ];
      ok = e.y * kChunk + s < T;
      at = static_cast<size_t>(e.x) * T + e.y * kChunk + s;
    }
    cp_async4(smem_addr(ms + c), a.mask + (ok ? at : 0), ok ? 4 : 0);
  }
  for (int c = tid; c < kBulkTiles * D; c += kBulkThreads) {
    const int slot = c / D, d = c - slot * D;
    const bool ok = slot < n;
    const size_t at =
        ok ? static_cast<size_t>(q[(r.head + slot) & kMaskQ].x) * D + d : 0;
    cp_async4(smem_addr(tg + c), a.tgt + at, ok ? 4 : 0);
  }
  r.head += n;
  return n;
}

__global__ void __launch_bounds__(kBulkThreads, 2)
din_attention_fused(const BulkArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, H1 = a.H1, H2 = a.H2, tid = threadIdx.x;
  const BulkLayout L = bulk_layout(D);
  float *w1f = smem + L.w1f, *wdiff = smem + L.wdiff, *w2s = smem + L.w2;
  float *b1s = smem + L.b1, *b2s = smem + L.b2, *w3s = smem + L.w3;
  float *un = smem + L.un, *bias1 = smem + L.bias1, *wt = smem + L.wt;
  float *part = smem + L.part, *rac = smem + L.rac;
  int2* q = reinterpret_cast<int2*>(smem + L.q);
  int2* sl = reinterpret_cast<int2*>(smem + L.sl);
  int* wcnt = reinterpret_cast<int*>(smem + L.wcnt);
  int* rowany = reinterpret_cast<int*>(smem + L.rowany);
  const int nch = (a.T + kChunk - 1) / kChunk;
  const int DH = D * kMaxH1;
  const bool vec = (reinterpret_cast<uintptr_t>(a.hist) & 15) == 0 &&
                   (static_cast<long long>(a.T) * D) % 4 == 0;

  // the weights, once a block, into the shared region as they come (units
  // zero-padded to kMaxH1, kMaxH2) for the fold: W1 = Wa | Wb | Wc | Wd
  float *w1s = un, *w2t = un + 4 * DH;
  stage<kBulkThreads>(w1s, kMaxH1, a.w1, H1, 4 * D, kMaxH1, 4 * D, H1);
  stage<kBulkThreads>(w2t, kMaxH2, a.w2, H2, kMaxH1, kMaxH2, H1, H2);
  stage<kBulkThreads>(b1s, 0, a.b1, 0, 1, kMaxH1, 1, H1);
  stage<kBulkThreads>(b2s, 0, a.b2, 0, 1, kMaxH2, 1, H2);
  stage<kBulkThreads>(w3s, 0, a.w3, 0, 1, kMaxH2, 1, H2);
  stage<kBulkThreads>(smem + L.misc, 0, a.b3, 0, 1, 1, 1, 1);
  rowany[tid] = 0;
  for (int d = tid; d < D; d += kBulkThreads) rac[d] = 0.0f;
  __syncthreads();

  Ring r{0, 0, blockIdx.x};
  refill(a, r, q, wcnt, rowany, nch);
  int n = take_group(a, r, q, sl, smem + L.hs, smem + L.ms, smem + L.tg, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // [Wa + Wc; Wd] and W2 in columns of kRegUnits units, each padded to
  // kUnitPad floats (a thread's column: two float4 and a float2); Wb - Wc
  for (int i = tid; i < 2 * D * kW1Row; i += kBulkThreads) {
    const int k = i / kW1Row, r = i - k * kW1Row, u = r % kUnitPad;
    const int j = r / kUnitPad * kRegUnits + u;
    // rows: Wa k, Wc 2 D + k (k < D); Wd 3 D + (k - D) = 2 D + k
    w1f[i] = u >= kRegUnits ? 0.0f
             : k < D ? w1s[k * kMaxH1 + j] + w1s[(2 * D + k) * kMaxH1 + j]
                     : w1s[(2 * D + k) * kMaxH1 + j];
  }
  for (int i = tid; i < DH; i += kBulkThreads)
    wdiff[i] = w1s[DH + i] - w1s[2 * DH + i];
  for (int i = tid; i < kMaxH1 * kW2Row; i += kBulkThreads) {
    const int j = i / kW2Row, r = i - j * kW2Row, u = r % kUnitPad;
    w2s[i] = u >= kRegUnits ? 0.0f
                            : w2t[j * kMaxH2 + r / kUnitPad * kRegUnits + u];
  }
  const float bias3 = smem[L.misc];
  int cur = -1;                       // the row whose pooled sum is open
  unsigned long long computed = 0;

  for (int g = 0; n > 0; ++g) {
    const int buf = g & 1;
    const int2* S = sl + (g % 3) * kBulkTiles;
    const float* H = smem + L.hs + buf * kBulkSteps * D;
    const float* MS = smem + L.ms + buf * kBulkSteps;
    const float* TG = smem + L.tg + buf * kBulkTiles * D;
    // the next group's entries and copies, into the other buffers
    refill(a, r, q, wcnt, rowany, nch);
    const int nb = buf ^ 1;
    const int nn = take_group(a, r, q, sl + ((g + 1) % 3) * kBulkTiles,
                              smem + L.hs + nb * kBulkSteps * D,
                              smem + L.ms + nb * kBulkSteps,
                              smem + L.tg + nb * kBulkTiles * D, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                  // this group's inputs are in
    computed += n;

    {  // [h, h * tgt] transposed, layer 1's operand: a thread a step and
       // a half; then bias1 once for each row of the group, in its first
       // slot
      const int s = tid % kBulkSteps, half = tid / kBulkSteps;
      const float *h = H + s * D, *tq = TG + s / kChunk * D;
      float* x = un + half * D * kBulkSteps + s;
      for (int d = 0; d < D; ++d)
        x[d * kBulkSteps] = half ? h[d] * tq[d] : h[d];
    }
    for (int i = tid; i < kBulkTiles * kMaxH1; i += kBulkThreads) {
      const int slot = i / kMaxH1, j = i - slot * kMaxH1;
      if (slot < n && (slot == 0 || S[slot].x != S[slot - 1].x)) {
        float v = b1s[j];
        for (int d = 0; d < D; ++d)
          v = fmaf(TG[slot * D + d], wdiff[d * kMaxH1 + j], v);
        bias1[i] = v;
      }
    }
    __syncthreads();

    {  // layer 1: steps 4 g1 .. 4 g1 + 3, units 10 c1 .. 10 c1 + 9, all of K
      const int c1 = tid % kCols1, g1 = tid / kCols1;
      float acc[kRegSteps][kRegUnits] = {};
#pragma unroll 4
      for (int k = 0; k < 2 * D; ++k) {
        const float4 x = *reinterpret_cast<const float4*>(
            un + k * kBulkSteps + kRegSteps * g1);
        const float* wr = w1f + k * kW1Row + kUnitPad * c1;
        const float4 wa = *reinterpret_cast<const float4*>(wr);
        const float4 wb = *reinterpret_cast<const float4*>(wr + 4);
        const float2 wc = *reinterpret_cast<const float2*>(wr + 8);
        const float xs[kRegSteps] = {x.x, x.y, x.z, x.w};
        const float w[kRegUnits] = {wa.x, wa.y, wa.z, wa.w, wb.x,
                                    wb.y, wb.z, wb.w, wc.x, wc.y};
#pragma unroll
        for (int s = 0; s < kRegSteps; ++s)
#pragma unroll
          for (int i = 0; i < kRegUnits; ++i)
            acc[s][i] = fmaf(xs[s], w[i], acc[s][i]);
      }
      __syncthreads();                // the operand is read: the output
                                      // takes the region
      // the row's bias1 sits in the first slot of its run in the group
      const int slot = kRegSteps * g1 / kChunk;
      int own = slot;
      while (own > 0 && S[own - 1].x == S[slot].x) --own;
      // unit j's 4 steps go to step group g1 ^ (j / kRegUnits) of row j:
      // the 8 columns of a warp's stores on 8 different banks
#pragma unroll
      for (int i = 0; i < kRegUnits; ++i) {
        const int j = kRegUnits * c1 + i;
        const float bj = bias1[own * kMaxH1 + j];
        *reinterpret_cast<float4*>(un + j * kBulkStride +
                                   kRegSteps * (g1 ^ c1)) =
            make_float4(silu(acc[0][i] + bj), silu(acc[1][i] + bj),
                        silu(acc[2][i] + bj), silu(acc[3][i] + bj));
      }
    }
    __syncthreads();

    {  // layer 2: steps 4 g2 .., units 10 c2 .. 10 c2 + 9, over the rows
       // j = hk (mod 2) of W2
      const int c2 = tid % kCols2, hk = tid / kCols2 % 2;
      const int g2 = tid / (2 * kCols2);
      float acc[kRegSteps][kRegUnits] = {};
      for (int cb = 0; cb < kCols1; ++cb) {
        const float* xr = un + kRegSteps * (g2 ^ cb);
#pragma unroll
        for (int jj = hk; jj < kRegUnits; jj += 2) {
          const int j = kRegUnits * cb + jj;
          const float4 x =
              *reinterpret_cast<const float4*>(xr + j * kBulkStride);
          const float* wr = w2s + j * kW2Row + kUnitPad * c2;
          const float4 wa = *reinterpret_cast<const float4*>(wr);
          const float4 wb = *reinterpret_cast<const float4*>(wr + 4);
          const float2 wc = *reinterpret_cast<const float2*>(wr + 8);
          const float xs[kRegSteps] = {x.x, x.y, x.z, x.w};
          const float w[kRegUnits] = {wa.x, wa.y, wa.z, wa.w, wb.x,
                                      wb.y, wb.z, wb.w, wc.x, wc.y};
#pragma unroll
          for (int s = 0; s < kRegSteps; ++s)
#pragma unroll
            for (int i = 0; i < kRegUnits; ++i)
              acc[s][i] = fmaf(xs[s], w[i], acc[s][i]);
        }
      }
      // the two K halves swap the steps each gives away (lane bit 2): this
      // thread keeps steps 2 hk, 2 hk + 1, then silu(.) * w3 over its
      // units, summed across the 4 unit columns (lane bits 0-1)
      float v[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        v[s] = 0.0f;
#pragma unroll
        for (int i = 0; i < kRegUnits; ++i) {
          const int u = kRegUnits * c2 + i;
          const float mine = hk ? acc[2 + s][i] : acc[s][i];
          const float give = hk ? acc[s][i] : acc[2 + s][i];
          const float x = mine + __shfl_xor_sync(repro_torch::kFullMask, give,
                                                 kCols2);
          v[s] = fmaf(silu(x + b2s[u]), w3s[u], v[s]);
        }
        v[s] += __shfl_xor_sync(repro_torch::kFullMask, v[s], 1);
        v[s] += __shfl_xor_sync(repro_torch::kFullMask, v[s], 2);
      }
      if (c2 == 0) {
        const int s0 = kRegSteps * g2 + 2 * hk;
        const float2 m = *reinterpret_cast<const float2*>(MS + s0);
        *reinterpret_cast<float2*>(wt + s0) =
            make_float2((v[0] + bias3) * m.x, (v[1] + bias3) * m.y);
      }
    }
    __syncthreads();

    // each tile's pooled partial, in step order; then each row's, in tile
    // order, written where the row ends
    for (int i = tid; i < n * D; i += kBulkThreads) {
      const int slot = i / D, d = i - slot * D;
      float v = 0.0f;
#pragma unroll 4
      for (int s = 0; s < kChunk; ++s)
        v = fmaf(wt[slot * kChunk + s], H[(slot * kChunk + s) * D + d], v);
      part[i] = v;
    }
    __syncthreads();
    for (int d = tid; d < D; d += kBulkThreads) {
      float v = rac[d];
      int c = cur;
      for (int slot = 0; slot < n; ++slot) {
        const int2 e = S[slot];
        if (e.x != c) {
          v = 0.0f;
          c = e.x;
        }
        v += part[slot * D + d];
        if (e.y & kLast) a.out[static_cast<size_t>(e.x) * D + d] = v;
      }
      rac[d] = v;
    }
    cur = S[n - 1].x;
    n = nn;
  }
  cp_async_wait<0>();                 // the last (empty) group's fills
  add_steps(a.steps, computed * kChunk);
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
    cudaDeviceGetAttribute(&g_block_smem[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  const int per_sm = std::min(2048 / kThreads,
                              static_cast<int>(g_sm_smem[dev] / (bytes + 1024)));
  return g_sms[dev] * std::max(1, per_sm);
}

// the two paths' kernels (one name, two parameter lists)
void (*const cluster_kernel)(const float*, const float*, const float*,
                             const float*, const float*, const float*,
                             const float*, const float*, const float*, float*,
                             unsigned long long*, int, int, int, int) =
    din_attention_fused;
void (*const bulk_kernel)(BulkArgs) = din_attention_fused;

// one wave of the bulk path's blocks: SMs x the blocks an SM holds (by
// registers, threads and shared memory), read once per device and size
int bulk_blocks(size_t bytes) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= repro_torch::kMaxDevices)
    return 0;
  if (g_bulk_bytes[dev] != bytes) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bulk_kernel,
                                                  kBulkThreads, bytes);
    g_bulk_per_sm[dev] = std::max(1, per_sm);
    g_bulk_bytes[dev] = bytes;
  }
  return g_sms[dev] * g_bulk_per_sm[dev];
}

}  // namespace

// H1 <= kMaxH1, H2 <= kMaxH2; no scratch. `steps`: null, or a device
// unsigned 64-bit count that the launch adds its computed steps to.
// Returns the first CUDA error.
extern "C" int din_attention_f32(const void* hist, const void* mask,
                                 const void* tgt, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, const void* w3,
                                 const void* b3, void* out, int B, int T,
                                 int D, int H1, int H2, void* steps,
                                 void* stream) {
  if (H1 > kMaxH1 || H2 > kMaxH2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* counter = static_cast<unsigned long long*>(steps);
  const size_t bytes = static_cast<size_t>(layout(D).total) * sizeof(float);
  const int nchunks = (T + kChunk - 1) / kChunk;
  const int resident = resident_blocks(bytes);
  const size_t bulk_bytes =
      static_cast<size_t>(bulk_layout(D).total) * sizeof(float);
  int dev = 0;
  cudaGetDevice(&dev);
  const bool bulk_fits =
      dev < repro_torch::kMaxDevices &&
      bulk_bytes <= static_cast<size_t>(g_block_smem[dev]);
  cudaError_t err;
  if (nchunks <= kBulkThreads && bulk_fits &&
      static_cast<long long>(B) * nchunks > resident) {
    // past what the card holds as clusters: one wave of persistent blocks
    err = repro_torch::allow_smem(bulk_kernel, bulk_bytes, g_bulk_opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = static_cast<int>(
        std::min<long long>(B, std::max(1, bulk_blocks(bulk_bytes))));
    const BulkArgs args{f(hist), f(mask), f(tgt), f(w1), f(b1), f(w2),
                        f(b2),   f(w3),   f(b3),  static_cast<float*>(out),
                        counter, B,       T,      D,     H1,    H2};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kBulkThreads);
    cfg.dynamicSmemBytes = bulk_bytes;
    cfg.stream = static_cast<cudaStream_t>(stream);
    err = cudaLaunchKernelEx(&cfg, bulk_kernel, args);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  err = repro_torch::allow_smem(cluster_kernel, bytes, g_smem_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a cluster over the row's chunks, as wide as the card holds for B rows
  const int CL = std::max(1, std::min({kMaxCluster, nchunks, resident / B}));
  cudaLaunchConfig_t cfg = {};
  // one x extent of B clusters (row b = blockIdx.x / CL)
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
  err = cudaLaunchKernelEx(&cfg, cluster_kernel, f(hist), f(mask),
                           f(tgt), f(w1), f(b1), f(w2), f(b2), f(w3), f(b3),
                           static_cast<float*>(out), counter, T, D, H1, H2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
