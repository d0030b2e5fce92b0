// Split-K flash decode: GQA attention of one new token over a KV cache
// prefix whose length is read on the device.
//
// Replaces src/repro/kernels/flash_decode/kernel.py::flash_decode_pallas
// (the padding of S to block_k in its ops.py wrapper is TPU tile
// bookkeeping).
//
//   s[b, h, g, j] = q[b, h, g, :] . K[b, j, h, :] * scale,  j < cache_len
//   out[b, h, g, :] = softmax_j(s) @ V[b, :, h, :]          (float32 sums)
//
// Bound on the H100: bytes. Every valid K and V row is read once, and the
// G query heads of a kv head do 4 G flops per value pair, far below the
// card's flops-per-byte line. The TPU grid walks the sequence in order
// inside one program per (b, h), which at B = 1 leaves H programs for 132
// SMs. Here the sequence is split across blocks, one block per (split, h,
// b); the wrapper sizes the splits so that B * H * n_split blocks fill
// whole waves of the card (SM count x resident blocks per SM, read once
// per device), from the shapes alone, never from cache_len.
//
//   * bf16 (flash_decode_split_tc): each of the block's four warps owns
//     every fourth 16-row tile of the block's chunk and streams it through
//     its own ring of kStages tiles in shared memory, filled by 16-byte
//     cp.async.cg copies (rows past cache_len are zero-filled, never read),
//     so the loads of the next tiles are in flight while a tile is
//     computed; the tiles stay bf16, with the 16-byte chunks of a row
//     XOR-swizzled so that ldmatrix reads them without bank conflicts. The
//     scores run on the tensor cores (mma.sync m16n8k16, bf16 in, float32
//     out): keys on M, the G query heads on N (padded to 8 or 16), D on K,
//     with q's fragments loaded into registers once per block. p is rounded
//     to bf16 for the PV product, as the TPU kernel does (p.astype(v.dtype)),
//     transposed in registers by movmatrix, and multiplied with V^T
//     fragments read by ldmatrix.trans; acc stays float32 in registers.
//     Each warp keeps its own (m, l, acc) and the warps merge once, at the
//     end, in warp order through shared memory. No block barrier runs per
//     tile.
//   * float32 (flash_decode_split): full-fp32 arithmetic, off the tensor
//     cores. One block streams its chunk in tiles of kSimtTile rows staged
//     in shared memory; all G query heads score against the same K rows
//     and sum the same V rows with fp32 FMAs, and a running (m, l, acc[G,
//     D]) in float32 follows the online softmax.
//
// With one split a block writes acc / max(l, 1e-30) in q's dtype itself
// (the LM service's shapes: one launch). Otherwise each block writes its
// partial (m, l, acc) to the float32 workspace the wrapper allocates and
// flash_decode_combine, one warp per (b, h, g, 32 columns), merges the
// splits in split order, so results do not depend on scheduling. A block
// whose chunk starts at or past cache_len writes an empty partial (m =
// -1e30, l = 0, acc = 0) and exits.
//
// With an lse pointer (the sequence shards of a device mesh combine their
// partial results by it) the kernel also writes each row's float32
// log-sum-exp m + log(l) over the valid prefix: the one-split block
// itself, else flash_decode_combine. A prefix of length 0 (a shard that
// holds no valid row yet) gives out = 0 and lse = -1e30, never NaN.
//
// cache_len is read from device memory (the TPU kernel's scalar prefetch),
// so the host never waits on it and the launch can be captured into a CUDA
// graph. Scores past it are masked with -1e30, as the reference masks them;
// expf, not __expf.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (device time
// per call by CUDA-graph replay; in parentheses this file's first design,
// commit 61b208e, measured by that commit's chip_smoke.py in the same
// chip call): long_500k (qwen3-8b geometry, bf16) 0.682 ms (2.35), byte
// bound 0.641, SDPA 0.679; starcoder2-7b's geometry (G = 9, bf16) 0.0301
// ms (0.163-0.168), bound 0.0196, SDPA 0.0287, of which 0.0045 ms is the
// two launches over an empty cache; decode_32k (f32) 2.14 ms (2.27),
// bound 1.92; the LM service's shape (f32, one split, one launch) 0.0068
// ms (0.0091).
// Known limits: the float32 path keeps the first design's block-wide tiles
// (four barriers a tile, two shared-memory operands per multiply-add in
// the PV product); the bf16 path takes G <= 16; with more than one split
// the combine is a second launch.
#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;              // cache rows per warp tile: one mma M
constexpr int kTile = 64;              // rows per split granule: kWarps x kRows
constexpr int kSimtTile = 32;          // float32 path: rows per block tile
constexpr float kNegInf = -1e30f;      // the reference's mask value
static_assert(kTile == kWarps * kRows, "a split granule is one tile per warp");
static_assert(kTile % kSimtTile == 0, "chunks are whole float32 tiles");

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(repro_torch::kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// the log-sum-exp of a row from its running (m, l): -1e30 when no
// position was valid
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.0f ? m + logf(l) : kNegInf;
}

// the partial of a block with nothing valid: (m, l, acc) = (-1e30, 0, 0),
// or, with one split, the output 0 (acc / max(l, 1e-30)) and lse -1e30
template <typename T>
__device__ void write_empty(float* part, T* out, float* lse, int G, int D,
                            int n_split) {
  if (n_split == 1) {
    for (int i = threadIdx.x; i < G * D; i += kThreads) store(out + i, 0.0f);
    if (lse != nullptr)
      for (int g = threadIdx.x; g < G; g += kThreads) lse[g] = kNegInf;
    return;
  }
  for (int i = threadIdx.x; i < G * (D + 2); i += kThreads)
    part[i] = i < G ? kNegInf : 0.0f;
}

// ------------------------------------------------------- float32 (SIMT)

// workspace per (b, h, split): m[G], l[G], acc[G][D]
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const int* __restrict__ cache_len, float* __restrict__ work,
                   float* __restrict__ out, float* __restrict__ lse, int H,
                   int G, int S, int chunk, int n_split, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                      // kSimtTile x D
  float* vs = ks + kSimtTile * D;        // kSimtTile x D
  float* qs = vs + kSimtTile * D;        // G x D
  float* acc = qs + G * D;               // G x D
  float* sc = acc + G * D;               // G x kSimtTile: scores, then p
  float* ms = sc + G * kSimtTile;        // G running maxima
  float* ls = ms + G;                    // G running sums
  float* as = ls + G;                    // G rescale factors of the tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = max(0, min(*cache_len, S));
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const size_t bh = static_cast<size_t>(b) * H + h;
  float* part = work + (bh * n_split + split) * G * (D + 2);
  if (start >= end) {                    // nothing valid in this chunk
    write_empty(part, out + bh * G * D, lse ? lse + bh * G : nullptr, G, D,
                n_split);
    return;
  }
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = q[bh * G * D + i];
    acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.0f;
  }
  __syncthreads();

  constexpr int kVpr = D / 4;            // 16-byte loads per row
  constexpr int kLpr = D / 4;            // lanes per row when scoring
  constexpr int kRpw = 32 / kLpr;        // rows a warp scores at once
  constexpr int kQuads = D / 4;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const float* kb = k + static_cast<size_t>(b) * S * row_stride + h * D;
  const float* vb = v + static_cast<size_t>(b) * S * row_stride + h * D;

  for (int t0 = start; t0 < end; t0 += kSimtTile) {
    const int n = min(kSimtTile, end - t0);
    // 1. the tile's K and V rows, once, into shared memory
    for (int i = tid; i < n * kVpr; i += kThreads) {
      const int r = i / kVpr, c = (i % kVpr) * 4;
      const size_t off = (t0 + r) * row_stride + c;
      *reinterpret_cast<float4*>(ks + r * D + c) =
          __ldg(reinterpret_cast<const float4*>(kb + off));
      *reinterpret_cast<float4*>(vs + r * D + c) =
          __ldg(reinterpret_cast<const float4*>(vb + off));
    }
    __syncthreads();
    // 2. scores of every query head against every row; kLpr lanes per row
    //    (rows past the tile's valid ones are masked, their lanes idle in
    //    step with the rest of the warp)
    for (int r0 = warp * kRpw; r0 < kSimtTile; r0 += kWarps * kRpw) {
      const int r = r0 + lane / kLpr, sub = lane % kLpr;
      const float4 kv = *reinterpret_cast<const float4*>(ks + r * D + sub * 4);
      for (int g = 0; g < G; ++g) {
        float part_s =
            dot4(kv, *reinterpret_cast<const float4*>(qs + g * D + sub * 4));
#pragma unroll
        for (int o = kLpr / 2; o > 0; o >>= 1)
          part_s += __shfl_xor_sync(repro_torch::kFullMask, part_s, o);
        if (sub == 0) sc[g * kSimtTile + r] = r < n ? part_s * scale : kNegInf;
      }
    }
    __syncthreads();
    // 3. online softmax per query head: one warp per head, one row per lane
    for (int g = warp; g < G; g += kWarps) {
      const float s = sc[g * kSimtTile + lane];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m_old - m_new);
      const float p_sum = repro_torch::warp_sum(p);
      sc[g * kSimtTile + lane] = p;
      if (lane == 0) {
        ls[g] = ls[g] * alpha + p_sum;
        as[g] = alpha;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    // 4. acc = acc * alpha + p @ V: four output columns per thread, each
    //    V row read once for them
    for (int i = tid; i < G * kQuads; i += kThreads) {
      const int g = i / kQuads, c = (i % kQuads) * 4;
      float4 a = *reinterpret_cast<float4*>(acc + g * D + c);
      const float al = as[g];
      a.x *= al;
      a.y *= al;
      a.z *= al;
      a.w *= al;
      const float* pg = sc + g * kSimtTile;
      for (int j = 0; j < n; ++j) {
        const float p = pg[j];
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * D + c);
        a.x = fmaf(p, vv.x, a.x);
        a.y = fmaf(p, vv.y, a.y);
        a.z = fmaf(p, vv.z, a.z);
        a.w = fmaf(p, vv.w, a.w);
      }
      *reinterpret_cast<float4*>(acc + g * D + c) = a;
    }
    __syncthreads();
  }
  if (n_split == 1) {
    for (int i = tid; i < G * D; i += kThreads)
      out[bh * G * D + i] = acc[i] / fmaxf(ls[i / D], 1e-30f);
    if (lse != nullptr)
      for (int g = tid; g < G; g += kThreads)
        lse[bh * G + g] = row_lse(ms[g], ls[g]);
    return;
  }
  for (int i = tid; i < G * (D + 2); i += kThreads)
    part[i] = i < G ? ms[i] : (i < 2 * G ? ls[i - G] : acc[i - 2 * G]);
}

// ------------------------------------------------ bf16 (tensor cores)

using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::smem_addr;

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 8x8 bf16 matrix held as one register per lane, transposed
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// position of 16-byte chunk c of tile row r: the chunk index XORed with
// the row, so that the 8 rows an ldmatrix reads at one column fall into 8
// distinct bank groups (kCpr chunks per row)
template <int kCpr>
__device__ __forceinline__ int swizzle(int r, int c) {
  if constexpr (kCpr >= 8) {
    return c ^ (r & 7);
  } else {
    return c ^ ((r / (8 / kCpr)) & (kCpr - 1));
  }
}

template <int D, int NT, int NS>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_tc(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ cache_len,
                      float* __restrict__ work,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int H, int G, int S,
                      int chunk, int n_split, float scale) {
  constexpr int kCpr = D / 8;            // 16-byte chunks per row
  constexpr int kStage = 2 * kRows * D;  // bf16 values of a stage: K, V
  constexpr int kKs = D / 16;            // k-steps of QK^T, m-tiles of PV
  constexpr int kGp = NT * 8;            // query heads padded to N tiles
  static_assert(kRows * kCpr % 32 == 0, "whole chunks per lane");
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = max(0, min(*cache_len, S));
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const size_t bh = static_cast<size_t>(b) * H + h;
  float* part = work + (bh * n_split + split) * G * (D + 2);
  if (start >= end) {
    write_empty(part, out + bh * G * D, lse ? lse + bh * G : nullptr, G, D,
                n_split);
    return;
  }

  // q^T as the B operand of the scores: (k = d, n = g), loaded once
  uint32_t qf[kKs][NT][2];
  const __nv_bfloat16* qb = q + bh * G * D;
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int g = nt * 8 + grp;
      const __nv_bfloat16* p = qb + g * D + ks * 16 + tig * 2;
      qf[ks][nt][0] = g < G ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      qf[ks][nt][1] = g < G ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
    }
  }

  const size_t row_stride = static_cast<size_t>(H) * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * S * row_stride + h * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * S * row_stride + h * D;
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * NS * kStage;
  const int n_tiles = (end - start + kRows - 1) / kRows;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

  // the warp's i-th tile (rows start + (warp + i kWarps) kRows ...) into
  // ring stage `stage`; rows at or past `end` are zero-filled
  auto load = [&](int i, int stage) {
    const int row0 = start + (warp + i * kWarps) * kRows;
    __nv_bfloat16* ks = ring + stage * kStage;
    __nv_bfloat16* vs = ks + kRows * D;
#pragma unroll
    for (int u = 0; u < kRows * kCpr / 32; ++u) {
      const int j = lane + 32 * u, r = j / kCpr, c = j % kCpr;
      const int row = row0 + r;
      const bool ok = row < end;
      const size_t off =
          static_cast<size_t>(ok ? row : row0) * row_stride + c * 8;
      const int at = r * D + swizzle<kCpr>(r, c) * 8;
      cp_async16(smem_addr(ks + at), kb + off, ok ? 16 : 0);
      cp_async16(smem_addr(vs + at), vb + off, ok ? 16 : 0);
    }
  };

  // per warp: running max and (per-lane partial) sum of each of the two
  // query-head columns a lane holds per N tile, and O^T (d, g) fragments
  float m[NT][2], l[NT][2], acc[kKs][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[nt][0] = m[nt][1] = kNegInf;
    l[nt][0] = l[nt][1] = 0.0f;
#pragma unroll
    for (int mt = 0; mt < kKs; ++mt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
  }

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < mine) load(s, s);
    cp_async_commit();
  }
  const int mat = lane >> 3;              // the 8x8 matrix a lane addresses
  for (int i = 0; i < mine; ++i) {
    if (i + NS - 1 < mine) load(i + NS - 1, (i + NS - 1) % NS);
    cp_async_commit();
    cp_async_wait<NS - 1>();              // this lane's copies of tile i
    __syncwarp();                         // ... and every other lane's
    const __nv_bfloat16* ks = ring + (i % NS) * kStage;
    const __nv_bfloat16* vs = ks + kRows * D;
    const int row0 = start + (warp + i * kWarps) * kRows;

    // 1. S^T (16 keys x G heads) = K q^T on the tensor cores
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      const int r = (lane & 7) + 8 * (mat & 1), c = 2 * kk + (mat >> 1);
      uint32_t a[4];
      ldsm_x4(smem_addr(ks + r * D + swizzle<kCpr>(r, c) * 8), a);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(sc[nt], a, qf[kk][nt][0], qf[kk][nt][1]);
    }
    // 2. online softmax per column: rows grp and grp + 8 of the tile
    const bool ok0 = row0 + grp < end, ok1 = row0 + grp + 8 < end;
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4], alpha[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float s0 = ok0 ? sc[nt][c] * scale : kNegInf;
        const float s1 = ok1 ? sc[nt][c + 2] * scale : kNegInf;
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(repro_torch::kFullMask, mx, o));
        const float m_new = fmaxf(m[nt][c], mx);
        alpha[c] = expf(m[nt][c] - m_new);
        m[nt][c] = m_new;
        p[c] = expf(s0 - m_new);
        p[c + 2] = expf(s1 - m_new);
        l[nt][c] = l[nt][c] * alpha[c] + p[c] + p[c + 2];
      }
#pragma unroll
      for (int mt = 0; mt < kKs; ++mt) {
        acc[mt][nt][0] *= alpha[0];
        acc[mt][nt][1] *= alpha[1];
        acc[mt][nt][2] *= alpha[0];
        acc[mt][nt][3] *= alpha[1];
      }
      // P^T as the B operand of PV: (k = key, n = g), keys 0-7 and 8-15
      pb[nt][0] = movmatrix_trans(pack_bf16(p[0], p[1]));
      pb[nt][1] = movmatrix_trans(pack_bf16(p[2], p[3]));
    }
    // 3. O^T (D x G) += V^T P^T, V^T read by ldmatrix.trans
#pragma unroll
    for (int mt = 0; mt < kKs; ++mt) {
      const int r = (lane & 7) + 8 * (mat >> 1), c = 2 * mt + (mat & 1);
      uint32_t a[4];
      ldsm_x4_trans(smem_addr(vs + r * D + swizzle<kCpr>(r, c) * 8), a);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[mt][nt], a, pb[nt][0], pb[nt][1]);
    }
    __syncwarp();                         // stage i % NS may be refilled
  }
  cp_async_wait<0>();

  // the lanes of a column hold partial sums of l: complete them
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        l[nt][c] += __shfl_xor_sync(repro_torch::kFullMask, l[nt][c], o);

  // merge the warps in warp order through shared memory (the ring's)
  __syncthreads();
  float* mw = reinterpret_cast<float*>(smem_raw);   // kWarps x kGp
  float* lw = mw + kWarps * kGp;                    // kWarps x kGp
  float* aw = lw + kWarps * kGp;                    // kWarps x kGp x D
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int g = nt * 8 + tig * 2 + c;
      if (grp == 0) {
        mw[warp * kGp + g] = m[nt][c];
        lw[warp * kGp + g] = l[nt][c];
      }
#pragma unroll
      for (int mt = 0; mt < kKs; ++mt) {
        float* row = aw + (warp * kGp + g) * D + mt * 16 + grp;
        row[0] = acc[mt][nt][c];
        row[8] = acc[mt][nt][c + 2];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kGp + g]);
    float ls = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(mw[w * kGp + g] - mx);
      ls = fmaf(lw[w * kGp + g], e, ls);
      a = fmaf(aw[(w * kGp + g) * D + d], e, a);
    }
    if (n_split == 1) {
      out[bh * G * D + i] = __float2bfloat16(a / fmaxf(ls, 1e-30f));
      if (lse != nullptr && d == 0) lse[bh * G + g] = row_lse(mx, ls);
    } else {
      part[2 * G + i] = a;
      if (d == 0) {
        part[g] = mx;
        part[G + g] = ls;
      }
    }
  }
}

// one warp per (b, h, g, 32 columns): the splits' partials merged in split
// order
template <typename T>
__global__ void __launch_bounds__(32)
flash_decode_combine(const float* __restrict__ work, T* __restrict__ out,
                     float* __restrict__ lse, int G, int D, int n_split) {
  const size_t bhg = blockIdx.x;         // (b H + h) G + g
  const size_t bh = bhg / G;
  const int g = static_cast<int>(bhg % G);
  const int d = blockIdx.y * 32 + threadIdx.x;
  if (d >= D) return;
  const size_t stride = static_cast<size_t>(G) * (D + 2);
  const float* base = work + bh * n_split * stride;
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, base[s * stride + g]);
  float l = 0.0f, a = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float* w = base + s * stride;
    const float e = expf(w[g] - m);
    l = fmaf(w[G + g], e, l);
    a = fmaf(w[2 * G + g * D + d], e, a);
  }
  store(out + bhg * D + d, a / fmaxf(l, 1e-30f));
  if (lse != nullptr && d == 0) lse[bhg] = row_lse(m, l);
}

// ------------------------------------------------------------ launching

// one compiled split kernel: its element type, shared memory and the size
// already granted to it per device
template <int D>
struct Simt {
  using T = float;
  static constexpr auto kernel = &flash_decode_split<D>;
  static inline size_t opted[repro_torch::kMaxDevices] = {};
  static size_t bytes(int G) {
    return sizeof(float) *
           (2 * kSimtTile * D + 2 * G * D + G * kSimtTile + 3 * G);
  }
};

template <int D, int NT>
struct Tc {
  using T = __nv_bfloat16;
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr auto kernel = &flash_decode_split_tc<D, NT, kStages>;
  static inline size_t opted[repro_torch::kMaxDevices] = {};
  static size_t bytes(int) {
    const size_t ring = sizeof(__nv_bfloat16) * kWarps * kStages * 2 * kRows * D;
    const size_t merge = sizeof(float) * kWarps * NT * 8 * (D + 2);
    return ring > merge ? ring : merge;
  }
};

// calls f with the configuration of (dtype, G, D)
template <typename F>
int with_config(int bf16, int G, int D, F&& f) {
  const int nt = (G + 7) / 8;
  if (G < 1 || (bf16 && nt > 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    switch (D) {
      case 16: return nt == 1 ? f(Tc<16, 1>{}) : f(Tc<16, 2>{});
      case 32: return nt == 1 ? f(Tc<32, 1>{}) : f(Tc<32, 2>{});
      case 64: return nt == 1 ? f(Tc<64, 1>{}) : f(Tc<64, 2>{});
      case 128: return nt == 1 ? f(Tc<128, 1>{}) : f(Tc<128, 2>{});
    }
  } else {
    switch (D) {
      case 16: return f(Simt<16>{});
      case 32: return f(Simt<32>{});
      case 64: return f(Simt<64>{});
      case 128: return f(Simt<128>{});
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch(int bf16, const void* q, const void* k, const void* v,
           const void* cache_len, void* work, void* out, int B, int H, int G,
           int D, int S, int chunk, int n_split, float scale, void* lse,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_config(bf16, G, D, [&](auto cfg) {
    using Cfg = decltype(cfg);
    using T = typename Cfg::T;
    const size_t bytes = Cfg::bytes(G);
    cudaError_t err = repro_torch::allow_smem(Cfg::kernel, bytes, Cfg::opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    Cfg::kernel<<<dim3(n_split, H, B), kThreads, bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(cache_len),
        static_cast<float*>(work), static_cast<T*>(out),
        static_cast<float*>(lse), H, G, S, chunk, n_split, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
    flash_decode_combine<T><<<dim3(B * H * G, (D + 31) / 32), 32, 0, st>>>(
        static_cast<const float*>(work), static_cast<T*>(out),
        static_cast<float*>(lse), G, D, n_split);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// q (B,H,G,D), caches (B,S,H,D), cache_len one int32 on the device,
// work (B*H*n_split*G*(D+2)) float32 (unused with one split), out
// (B,H,G,D) in q's dtype, lse (B,H,G) float32 or null (not written)
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* cache_len, void* work, void* out,
                                int B, int H, int G, int D, int S, int chunk,
                                int n_split, float scale, void* lse,
                                void* stream) {
  return launch(0, q, k, v, cache_len, work, out, B, H, G, D, S, chunk,
                n_split, scale, lse, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* cache_len, void* work, void* out,
                                 int B, int H, int G, int D, int S, int chunk,
                                 int n_split, float scale, void* lse,
                                 void* stream) {
  return launch(1, q, k, v, cache_len, work, out, B, H, G, D, S, chunk,
                n_split, scale, lse, stream);
}

// the split plan's input: out[0] = blocks of the split kernel for (dtype,
// G, D) resident on one SM, out[1] = the device's SM count. Launches
// nothing; the stream is unused.
extern "C" int flash_decode_residency(int bf16, int G, int D, void* out,
                                      void* stream) {
  (void)stream;
  int* res = static_cast<int*>(out);
  return with_config(bf16, G, D, [&](auto cfg) {
    using Cfg = decltype(cfg);
    const size_t bytes = Cfg::bytes(G);
    cudaError_t err = repro_torch::allow_smem(Cfg::kernel, bytes, Cfg::opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&res[1], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &res[0], Cfg::kernel, kThreads, bytes));
  });
}
