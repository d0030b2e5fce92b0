// Absorbed MLA decode: one new token a sequence, 16 query heads against a
// latent cache whose rows every head shares, with each sequence's length
// read on the device.
//
// New, with no Pallas original: the JAX package's MLA decode is plain jnp
// (src/repro/models/attention.py, the absorbed branch of mla_forward).
//
//   s[b, h, j] = (q_c[b, h, :] . c[b, j, :] + q_r[b, h, :] . r[b, j, :])
//                * scale,                          j < len[b]
//   o[b, h, :] = softmax_j(s) @ c[b, :, :]         (float32 sums)
//
// q_c is the query already absorbed through wk_b (B, 16, 512), q_r its
// rope part (B, 16, 64); c (B, S, 512) and r (B, S, 64) are one layer's
// latent cache; o (B, 16, 512) goes on through wv_b.
//
// Bound on the H100: bytes. A 576-wide bf16 row (1,152 B) serves 16 heads
// for 16 x (576 + 512) multiply-adds, ~30 flops a byte: above the fp32
// ridge, far below the bf16 tensor cores' (~295). The plain version reads
// every row of the cache, valid or not, and upcasts it to float32 in each
// layer; here each valid row is read once, in bf16, and rows past a
// sequence's length never.
//
//   * Balance: a decode batch holds sequences of different lengths, and
//     the grid's shape may not depend on them (they live on the device).
//     One wave of persistent blocks (the card's SM count x resident blocks
//     an SM) splits the valid rows of all sequences, laid end to end, into
//     equal ranges of a multiple of kTile rows; a block's range is cut at
//     sequence boundaries into segments, and each segment ends in a
//     partial result (m, l, acc) in a float32 workspace. The combine kernel
//     merges a sequence's partials in block order, so results do not
//     depend on scheduling. The partial of block j for sequence b lies at
//     slot j + b: a block's segments are of distinct sequences, and a later
//     block's start no earlier sequence, so no two share a slot.
//   * Tiles: a block streams its rows in tiles of kTile rows, the 512-wide
//     c and the 64-wide r of a row side by side in shared memory (rows
//     padded by 8 values so ldmatrix reads them without bank conflicts),
//     two stages filled by 16-byte cp.async.cg copies: tile t + 1 is in
//     flight while tile t is computed. Rows past the segment's end are
//     zero-filled, never read.
//   * Scores on the tensor cores (mma.sync m16n8k16, bf16 in, float32
//     out): each of the four warps takes 16 rows of the tile on M, the 16
//     heads on N, the 576 widths on K (q from shared memory, loaded once a
//     segment). The tile's max of each head meets in shared memory, and
//     every warp keeps the same running max; p = exp(s - m) is rounded to
//     bf16 into shared memory (the plain decode's pr.to(c.dtype)).
//   * o^T (512 x 16) += c^T p^T: each warp owns 128 of the 512 widths (M),
//     the 16 heads on N, the tile's rows on K, with c^T read by
//     ldmatrix.trans from the same tile; acc stays float32 in registers,
//     and each warp keeps its own partial sum l of its rows' p.
//
// The two kernels carry names of the split-K flash-decode family
// (flash_decode_split_tc, flash_decode_combine) in namespace mla_decode:
// the benchmark's table of kernels (portbench/kernels.json) lists every
// kernel of the library by name and has no entry of its own for this
// one yet; a trace tells them from B6's by the namespace.
//
// Rows counter: given a non-null device pointer, each block adds the rows
// it loaded (every valid row once, no padding); rows_read in ops.py turns
// it on, no serving path does.
//
// Known limits: 16 heads of 512 + 64 only (DeepSeek-V2-Lite); one tile in
// flight while one is computed; three block barriers a tile.
#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace mla_decode {

using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::kFullMask;
using repro_torch::smem_addr;

constexpr int kHeads = 16;            // query heads: one mma N pair, one M
constexpr int kLat = 512;             // latent width (c, and o)
constexpr int kRope = 64;             // rope key width (r)
constexpr int kDk = kLat + kRope;     // a row's score width
constexpr int kRow = kDk + 8;         // shared row stride, padded (bf16)
constexpr int kTile = 64;             // cache rows a block tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kPRow = kTile + 8;      // p's shared row stride, padded
constexpr int kMt = kLat / kWarps / 16;   // a warp's 16-wide M tiles of o
constexpr int kKs = kDk / 16;             // k-steps of the scores
constexpr int kChunks = kDk / 8;          // 16-byte chunks of a row
constexpr int kLatChunks = kLat / 8;
// a partial: m[head], l[warp][head], acc[head][kLat]
constexpr int kPart = kHeads * (1 + kWarps + kLat);
constexpr float kNegInf = -1e30f;
static_assert(kTile == 16 * kWarps, "a warp scores 16 rows of a tile");
static_assert(kKs % 2 == 0, "the scores run two k-step chains");

struct Smem {
  __nv_bfloat16 kv[kStages][kTile * kRow];
  __nv_bfloat16 q[kHeads * kRow];
  __nv_bfloat16 p[kHeads * kPRow];
  float mx[kWarps][kHeads];
};

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

// ----------------------------------------------------- the rows' split

__device__ __forceinline__ int clamped_len(const int* lens, int b, int S) {
  return min(max(lens[b], 0), S);
}

// R, the valid rows of all sequences, and each block's share: kTile x
// ceil(R / (kTile x n_blocks)) rows (0 when R is 0)
struct Split {
  long long rows;
  long long quota;
};

__device__ Split split_rows(const int* lens, int B, int S, int n_blocks) {
  long long R = 0;
  for (int b = 0; b < B; ++b) R += clamped_len(lens, b, S);
  const long long per = static_cast<long long>(kTile) * n_blocks;
  return {R, (R + per - 1) / per * kTile};
}

// a block's current tile: sequence b, rows [row, hi) of its segment left;
// cs is the sequence's first row in the rows laid end to end, g1 the end
// of the block's range there
struct Cursor {
  int b;
  int row;
  int hi;
  long long cs;
  long long g1;
  bool done;
};

// the next sequence from b + 1 on with rows in the block's range, or done
__device__ void next_segment(const int* lens, int B, int S, Cursor& u) {
  long long cs = u.cs + clamped_len(lens, u.b, S);
  for (int b = u.b + 1; b < B && cs < u.g1; ++b) {
    const int len = clamped_len(lens, b, S);
    if (len > 0) {
      u.b = b;
      u.cs = cs;
      u.row = 0;
      u.hi = static_cast<int>(min(cs + len, u.g1) - cs);
      return;
    }
  }
  u.done = true;
}

__device__ Cursor first_tile(const int* lens, int B, int S, long long g0,
                             long long g1) {
  Cursor u{0, 0, 0, 0, g1, g0 >= g1};
  long long cs = 0;
  for (int b = 0; b < B && !u.done; ++b) {
    const int len = clamped_len(lens, b, S);
    if (cs + len > g0) {
      u.b = b;
      u.cs = cs;
      u.row = static_cast<int>(max(g0, cs) - cs);
      u.hi = static_cast<int>(min(cs + len, g1) - cs);
      return u;
    }
    cs += len;
  }
  u.done = true;
  return u;
}

__device__ void advance(const int* lens, int B, int S, Cursor& u) {
  u.row += kTile;
  if (u.row >= u.hi) next_segment(lens, B, S, u);
}

// the tile at u into a stage: c then r of each row, zero past the segment.
// A thread copies one 16-byte column of c in every second row and one of r
// in every sixteenth, so its addresses step by a constant stride.
__device__ void load_tile(__nv_bfloat16* stage, const __nv_bfloat16* c,
                          const __nv_bfloat16* r, int S, const Cursor& u) {
  static_assert(kThreads % kLatChunks == 0 && kThreads % (kRope / 8) == 0,
                "whole columns a thread");
  constexpr int kCStep = kThreads / kLatChunks;        // rows between c copies
  constexpr int kRStep = kThreads / (kRope / 8);       // ... between r copies
  const size_t base = static_cast<size_t>(u.b) * S + u.row;
  const int cc = threadIdx.x % kLatChunks, rc = threadIdx.x % (kRope / 8);
  const int n = u.hi - u.row;                          // rows left in the segment
#pragma unroll 4
  for (int t = threadIdx.x / kLatChunks; t < kTile; t += kCStep) {
    const bool ok = t < n;
    cp_async16(smem_addr(stage + t * kRow + cc * 8),
               c + (base + (ok ? t : 0)) * kLat + cc * 8, ok ? 16 : 0);
  }
#pragma unroll
  for (int t = threadIdx.x / (kRope / 8); t < kTile; t += kRStep) {
    const bool ok = t < n;
    cp_async16(smem_addr(stage + t * kRow + kLat + rc * 8),
               r + (base + (ok ? t : 0)) * kRope + rc * 8, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_decode_split_tc(const __nv_bfloat16* __restrict__ q_c,
                      const __nv_bfloat16* __restrict__ q_r,
                      const __nv_bfloat16* __restrict__ c,
                      const __nv_bfloat16* __restrict__ r,
                      const int* __restrict__ lens, float* __restrict__ work,
                      unsigned long long* rows_counter, int B, int S,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const int mat = lane >> 3;                   // the 8x8 matrix a lane addresses

  const Split sp = split_rows(lens, B, S, gridDim.x);
  const long long g0 = sp.quota * blockIdx.x;
  const long long g1 = min(g0 + sp.quota, sp.rows);
  Cursor cur = first_tile(lens, B, S, g0, g1);
  if (cur.done) return;
  Cursor ld = cur;

  load_tile(sm.kv[0], c, r, S, ld);
  cp_async_commit();
  advance(lens, B, S, ld);

  float m[2][2], l[2][2], acc[kMt][2][4];
  unsigned long long loaded = 0;
  bool fresh = true;
  for (int t = 0; !cur.done; ++t) {
    const int stage = t & 1;
    if (fresh) {
      // a segment starts: its sequence's q into shared memory (every warp
      // is past the previous tile's scores), the running state reset
      const __nv_bfloat16* qc = q_c + static_cast<size_t>(cur.b) * kHeads * kLat;
      const __nv_bfloat16* qr = q_r + static_cast<size_t>(cur.b) * kHeads * kRope;
      for (int k = tid; k < kHeads * kChunks; k += kThreads) {
        const int h = k / kChunks, ch = k % kChunks;
        const uint4 v = ch < kLatChunks
            ? *reinterpret_cast<const uint4*>(qc + h * kLat + ch * 8)
            : *reinterpret_cast<const uint4*>(qr + h * kRope +
                                              (ch - kLatChunks) * 8);
        *reinterpret_cast<uint4*>(sm.q + h * kRow + ch * 8) = v;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        m[nt][0] = m[nt][1] = kNegInf;
        l[nt][0] = l[nt][1] = 0.0f;
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
              acc[mt][nt][3] = 0.0f;
      }
      fresh = false;
    }
    cp_async_wait<0>();     // this thread's copies of tile t
    __syncthreads();        // everyone's; tile t - 1's stage and p are free
    if (!ld.done) {
      load_tile(sm.kv[stage ^ 1], c, r, S, ld);
      advance(lens, B, S, ld);
    }
    cp_async_commit();
    const int valid = min(kTile, cur.hi - cur.row);
    loaded += valid;
    const __nv_bfloat16* kv = sm.kv[stage];

    // 1. S^T (the warp's 16 rows x 16 heads) = K q^T, two k-step chains
    float s0[2][4] = {}, s1[2][4] = {};
    auto score = [&](int ks, float(&s)[2][4]) {
      uint32_t a[4], b[4];
      const int ra = warp * 16 + (lane & 7) + 8 * (mat & 1);
      ldsm_x4(smem_addr(kv + ra * kRow + (2 * ks + (mat >> 1)) * 8), a);
      const int hb = (lane & 7) + 8 * (mat >> 1);
      ldsm_x4(smem_addr(sm.q + hb * kRow + (2 * ks + (mat & 1)) * 8), b);
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    };
#pragma unroll 3
    for (int kk = 0; kk < kKs; kk += 2) {
      score(kk, s0);
      score(kk + 1, s1);
    }
    // 2. the tile's max of each head, across the warps
    const int r0 = warp * 16 + grp;
    const bool ok0 = r0 < valid, ok1 = r0 + 8 < valid;
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        sc[nt][cc] = ok0 ? (s0[nt][cc] + s1[nt][cc]) * scale : kNegInf;
        sc[nt][cc + 2] =
            ok1 ? (s0[nt][cc + 2] + s1[nt][cc + 2]) * scale : kNegInf;
        float mx = fmaxf(sc[nt][cc], sc[nt][cc + 2]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
        if (grp == 0) sm.mx[warp][nt * 8 + 2 * tig + cc] = mx;
      }
    }
    __syncthreads();
    // every warp takes the same running max; p to shared memory in bf16
    float alpha[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int h = nt * 8 + 2 * tig + cc;
        float mx = sm.mx[0][h];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm.mx[w][h]);
        const float m_new = fmaxf(m[nt][cc], mx);
        alpha[nt][cc] = expf(m[nt][cc] - m_new);
        m[nt][cc] = m_new;
        const float p0 = expf(sc[nt][cc] - m_new);
        const float p1 = expf(sc[nt][cc + 2] - m_new);
        l[nt][cc] = l[nt][cc] * alpha[nt][cc] + p0 + p1;
        sm.p[h * kPRow + r0] = __float2bfloat16(p0);
        sm.p[h * kPRow + r0 + 8] = __float2bfloat16(p1);
      }
    }
    __syncthreads();
    // 3. o^T (the warp's 128 widths x 16 heads) += c^T p^T
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[mt][nt][0] *= alpha[nt][0];
        acc[mt][nt][1] *= alpha[nt][1];
        acc[mt][nt][2] *= alpha[nt][0];
        acc[mt][nt][3] *= alpha[nt][1];
      }
    }
#pragma unroll 1
    for (int kt = 0; kt < kTile / 16; ++kt) {
      uint32_t b[4];
      const int hb = (lane & 7) + 8 * (mat >> 1);
      ldsm_x4(smem_addr(sm.p + hb * kPRow + (2 * kt + (mat & 1)) * 8), b);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        uint32_t a[4];
        const int ra = kt * 16 + (lane & 7) + 8 * (mat >> 1);
        const int ca = (warp * kMt + mt) * 2 + (mat & 1);
        ldsm_x4_trans(smem_addr(kv + ra * kRow + ca * 8), a);
        mma_bf16(acc[mt][0], a, b[0], b[1]);
        mma_bf16(acc[mt][1], a, b[2], b[3]);
      }
    }

    const int b_now = cur.b;
    advance(lens, B, S, cur);
    fresh = cur.done || cur.b != b_now;
    if (fresh) {
      // the segment ends: its partial to slot blockIdx.x + b
      float* part = work + (static_cast<size_t>(blockIdx.x) + b_now) * kPart;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int h = nt * 8 + 2 * tig + cc;
          float ls = l[nt][cc];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            ls += __shfl_xor_sync(kFullMask, ls, o);
          if (grp == 0) {
            if (warp == 0) part[h] = m[nt][cc];
            part[kHeads + warp * kHeads + h] = ls;
          }
        }
      }
      float* pa = part + kHeads * (1 + kWarps);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        const int d = (warp * kMt + mt) * 16 + grp;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int h = nt * 8 + 2 * tig + cc;
            pa[h * kLat + d] = acc[mt][nt][cc];
            pa[h * kLat + d + 8] = acc[mt][nt][cc + 2];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (rows_counter != nullptr && tid == 0) atomicAdd(rows_counter, loaded);
}

// one block per (b, head): the sequence's partials merged in block order;
// a sequence of length 0 gives 0
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const int* __restrict__ lens,
                     const float* __restrict__ work,
                     __nv_bfloat16* __restrict__ out, int B, int S,
                     int n_blocks) {
  const int b = blockIdx.x / kHeads, h = blockIdx.x % kHeads;
  const Split sp = split_rows(lens, B, S, n_blocks);
  long long cs = 0;
  for (int i = 0; i < b; ++i) cs += clamped_len(lens, i, S);
  const int len = clamped_len(lens, b, S);
  __nv_bfloat16* o = out + (static_cast<size_t>(b) * kHeads + h) * kLat;
  if (len == 0) {
    for (int d = threadIdx.x; d < kLat; d += kThreads)
      o[d] = __float2bfloat16(0.0f);
    return;
  }
  const long long j0 = cs / sp.quota, j1 = (cs + len - 1) / sp.quota;
  float mx = kNegInf;
  for (long long j = j0; j <= j1; ++j)
    mx = fmaxf(mx, work[(j + b) * kPart + h]);
  float ls = 0.0f;
  for (long long j = j0; j <= j1; ++j) {
    const float* part = work + (j + b) * kPart;
    float lj = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lj += part[kHeads + w * kHeads + h];
    ls = fmaf(lj, expf(part[h] - mx), ls);
  }
  for (int d = threadIdx.x; d < kLat; d += kThreads) {
    float a = 0.0f;
    for (long long j = j0; j <= j1; ++j) {
      const float* part = work + (j + b) * kPart;
      a = fmaf(part[kHeads * (1 + kWarps) + h * kLat + d],
               expf(part[h] - mx), a);
    }
    o[d] = __float2bfloat16(a / fmaxf(ls, 1e-30f));
  }
}

size_t g_opted[repro_torch::kMaxDevices] = {};

}  // namespace mla_decode

// q_c (B,16,512), q_r (B,16,64), c (B,S,512), r (B,S,64), all bf16; lens
// (B,) int32 on the device; work ((n_blocks + B) x kPart) float32; out
// (B,16,512) bf16; rows_counter one uint64 or null (not counted)
extern "C" int mla_decode_bf16(const void* q_c, const void* q_r,
                               const void* c, const void* r, const void* lens,
                               void* work, void* out, void* rows_counter,
                               int B, int S, int n_blocks, float scale,
                               void* stream) {
  using namespace mla_decode;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(Smem);
  cudaError_t err =
      repro_torch::allow_smem(flash_decode_split_tc, bytes, g_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_split_tc<<<n_blocks, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q_c),
      static_cast<const __nv_bfloat16*>(q_r),
      static_cast<const __nv_bfloat16*>(c),
      static_cast<const __nv_bfloat16*>(r), static_cast<const int*>(lens),
      static_cast<float*>(work),
      static_cast<unsigned long long*>(rows_counter), B, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine<<<B * kHeads, kThreads, 0, st>>>(
      static_cast<const int*>(lens), static_cast<const float*>(work),
      static_cast<__nv_bfloat16*>(out), B, S, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// out[0] = blocks of the split kernel resident on one SM, out[1] = the
// device's SM count. Launches nothing; the stream is unused.
extern "C" int mla_decode_residency(void* out, void* stream) {
  using namespace mla_decode;
  (void)stream;
  int* res = static_cast<int*>(out);
  const size_t bytes = sizeof(Smem);
  cudaError_t err =
      repro_torch::allow_smem(flash_decode_split_tc, bytes, g_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&res[1], cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &res[0], flash_decode_split_tc, kThreads, bytes));
}
