// Candidate scorer: blocked dot products plus an in-block top-k.
//
// Replaces src/repro/kernels/candidate_scorer/kernel.py::
// candidate_scorer_pallas (the padding of its ops.py wrapper is TPU tile
// bookkeeping; the cross-block merge stays outside the kernel there and
// here).
//
//   score[c] = sum_d cands[c, d] * query[d]          (float32 accumulator)
//   per block of at most kBlockC candidates: its k best (value, index)
//   pairs, best first, in lax.top_k's order: the float's total order
//   (+NaN above +inf, +0 above -0, -NaN below -inf; order_key below),
//   and on equal keys the lower index first. Every row takes part, -inf
//   and NaN scores included; a slot without a row (k above the block's
//   rows) ranks below every row and comes out as (-inf, -1), which the
//   wrapper's merge ranks below every real pair.
//
// Bound on the H100: bytes. Every candidate row is read once (C * D
// values) for 2 flops per value, far below the card's flops-per-byte
// line. Each warp scores 8 float32 or 16 bf16 rows at a time with 16-byte
// loads (neighbouring lanes on neighbouring addresses: a 256-wide float32
// row is two coalesced 512-byte segments), all of a pass's loads, the
// query's slice among them, issued before the first is used, so that 8 KB
// of a warp's rows at D = 256 are in flight together (the first design
// staged the query in shared memory behind a barrier and scored one row
// at a time: a chain of dependent loads). The block's scores stay in
// shared memory; only (k values, k indices) per block reach device memory.
//
// The block is sized from C: a block holds P = C rounded up to a power of
// two (at least 32, at most kBlockC) slots and 4 P threads (128 to 256),
// so the two-tower service's C = 64 runs one block of 256 threads whose
// eight warps score its rows in one pass. The
// selection is a bitonic sort of the block's (score, index) pairs, score
// descending, then index ascending: the sorting threads hold P / TS pairs
// each (TS = P / 2 threads, 32 to 256), pair i at register i / TS of
// thread i % TS. Compare-exchange strides of TS and above are exchanges
// between a thread's registers, strides below 32 are __shfl_xor_sync
// between lanes, and only the strides in between go through shared
// memory. At P <= 64 the sort runs on one warp, every stage unrolled: at
// P = 64, 21 stages without a block barrier, whatever k is. What is
// sorted is each row's rank (Rank below): its score's key in the total
// order and its index in one 64-bit integer, so one comparison orders two
// rows. Only the first k ranks are written; slots past the block's rows
// hold kEmpty, below every row.
//
// The first design's selection, k rounds of block-wide argmax (each a
// scan of the ranks, a shuffle reduce and two barriers), stays as the
// other method, for k <= kArgmaxMaxK, where a chip measurement shows it
// cheaper; launch() picks the method by k and the block size by C.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (device time per
// call by CUDA-graph replay, PERF.md, PR 16; in parentheses the 32-bit
// (score, index) selection of commit 9a81317 in the same chip call): the
// two-tower service's shape (C = 64, D = 256, k = 64, f32) 0.0030 ms
// (0.0037), torch.topk(torch.mv) 0.0116; the recall shape (C = 10^6,
// k = 8, f32) 0.377 ms (0.399), byte bound 0.306, library 0.454. Known
// limit: C of one to a few blocks (1,024 and 4,096 at k = 8: 0.025 and
// 0.036 ms, library 0.015 and 0.024) runs one block per SM on one to four
// SMs; the block's rows are not spread over the card.
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBlockC = 1024;       // candidates per block at most
constexpr int kMaxPer = kBlockC / kMaxThreads;   // pairs a sorting thread holds
// k up to which the block selects by k rounds of argmax, the bitonic sort
// above it. Kernel alone, C = 10^6, D = 256, f32, argmax vs sort, ms (an
// H100 80GB HBM3 at 700 W, PR 14's 32-bit selection; the reading and its
// script in PERF.md at 45f56da):
// k = 8 0.3437 vs 0.3710, k = 24 0.3684 vs 0.3713, k = 32 0.3804 vs
// 0.3713; at C = 64, k = 64 0.0313 vs 0.0038. The crossover lies between
// k = 24 and 32; the sort takes every k above 16.
constexpr int kArgmaxMaxK = 16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// dot of 16 bytes of a candidate row with the matching 16 bytes of the
// query, both loaded raw
__device__ __forceinline__ float dot16(uint4 row, uint4 q, float) {
  const float4 a = *reinterpret_cast<const float4*>(&row);
  const float4 b = *reinterpret_cast<const float4*>(&q);
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
__device__ __forceinline__ float dot16(uint4 row, uint4 q, __nv_bfloat16) {
  const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(&row);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&q);
  float acc = 0.0f;
#pragma unroll
  for (int i = 7; i >= 0; --i)
    acc = fmaf(__bfloat162float(a[i]), __bfloat162float(b[i]), acc);
  return acc;
}

// A row's rank as one signed 64-bit integer, larger = better: the high
// word is the score's key in lax.top_k's total order of floats (its bits
// as a signed int, the magnitude bits flipped when the sign bit is set),
// the low word the complement of the row's index in cands (C < 2^31), so
// that among equal keys the lower index ranks higher. An empty slot is
// kEmpty, below every row. One comparison orders two rows, within a block
// and across blocks (the wrapper's merge is a top-k of the blocks'
// ranks); the score and the index come back from the rank (score_of,
// index_of).
using Rank = long long;
constexpr Rank kEmpty = LLONG_MIN;

__device__ __forceinline__ Rank rank_of(float v, long long i) {
  const int b = __float_as_int(v);
  const int key = b ^ ((b >> 31) & 0x7fffffff);
  return static_cast<Rank>((static_cast<unsigned long long>(
                                static_cast<unsigned>(key)) << 32) |
                           ~static_cast<unsigned>(i));
}
__device__ __forceinline__ float score_of(Rank r) {
  const int key = static_cast<int>(static_cast<unsigned long long>(r) >> 32);
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}
__device__ __forceinline__ long long index_of(Rank r) {
  return ~static_cast<unsigned>(r);
}

// a block's output: k scores, k indices and, when the wrapper merges
// blocks, k ranks
struct BlockOut {
  float* v;
  long long* i;
  Rank* r;                                  // null for a single block
};

// slots of a block: min(C, kBlockC) rounded up to a power of two, >= 32
__host__ __device__ inline int block_slots(int C) {
  int p = 32;
  while (p < C && p < kBlockC) p <<= 1;
  return p;
}

// slot p of the block's output: the rank r, or (-inf, -1) for an empty
// slot (k above the block's rows)
__device__ __forceinline__ void write_rank(int p, Rank r, BlockOut o) {
  const bool real = r != kEmpty;
  o.v[p] = real ? score_of(r) : __int_as_float(static_cast<int>(0xff800000u));
  o.i[p] = real ? index_of(r) : -1;
  if (o.r != nullptr) o.r[p] = r;
}
__device__ __forceinline__ void write_past_slots(int P, int k, BlockOut o) {
  for (int p = P + threadIdx.x; p < k; p += blockDim.x)
    write_rank(p, kEmpty, o);
}

// the block's k best of its n scores by k rounds of block-wide argmax over
// their ranks, kept in shared memory (rk, n entries; a row taken becomes
// kEmpty)
__device__ void select_argmax(const float* sc, Rank* rk, int n, int k,
                              long long base, BlockOut o) {
  __shared__ Rank red[kMaxWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5;
  // sc and rk share their storage: every score is read before any rank
  // is written
  Rank mine[kBlockC / 128];
#pragma unroll
  for (int e = 0; e < kBlockC / 128; ++e) {
    const int r = tid + e * blockDim.x;
    mine[e] = r < n ? rank_of(sc[r], base + r) : kEmpty;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kBlockC / 128; ++e) {
    const int r = tid + e * blockDim.x;
    if (r < n) rk[r] = mine[e];
  }
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    Rank best = kEmpty;
    for (int r = tid; r < n; r += blockDim.x) best = max(best, rk[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      best = max(best, __shfl_xor_sync(repro_torch::kFullMask, best, o));
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nw; ++w) best = max(best, red[w]);
      write_rank(j, best, o);
      if (best != kEmpty) rk[index_of(best) - base] = kEmpty;    // taken
    }
    __syncthreads();
  }
}

// the bitonic sort of kP <= 64 slots on the block's first warp: kP / 32
// ranks a lane, every stage unrolled (strides of 32 between a lane's two
// registers, the rest by __shfl_xor_sync); no shared memory, no barrier
template <int kP>
__device__ void select_sort_warp(const float* sc, int n, int k,
                                 long long base, BlockOut o) {
  constexpr int E = kP / 32;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    Rank v[2];                              // E of them hold ranks
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = e * 32 + lane;
      v[e] = i < n ? rank_of(sc[i], base + i) : kEmpty;
    }
#pragma unroll
    for (int size = 2; size <= kP; size <<= 1) {
#pragma unroll
      for (int j = size >> 1; j > 0; j >>= 1) {
        if (j >= 32) {                      // the lane's two registers
          const bool up = (lane & size) == 0;
          if ((v[1] > v[0]) == up) {
            const Rank t = v[0];
            v[0] = v[1];
            v[1] = t;
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const Rank o = __shfl_xor_sync(repro_torch::kFullMask, v[e], j);
            const bool keep_better =
                ((lane & j) == 0) == (((e * 32 + lane) & size) == 0);
            if ((o > v[e]) == keep_better) v[e] = o;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e * 32 + lane < k)
        write_rank(e * 32 + lane, v[e], o);
  }
  write_past_slots(kP, k, o);
}

// the block's k best of its n scores by a bitonic sort of its P slots;
// rk (P ranks in the scores' storage) carries the shared-memory stages
__device__ void select_sort(const float* sc, Rank* rk, int n, int P, int k,
                            long long base, BlockOut o) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int TS = min(static_cast<int>(blockDim.x), max(32, P >> 1));
  const int E = P / TS;                     // 1, 2 or 4 ranks a thread
  const bool sorter = tid < TS;
  Rank v[kMaxPer];
#pragma unroll
  for (int e = 0; e < kMaxPer; ++e) {
    const int i = e * TS + tid;
    v[e] = sorter && e < E && i < n ? rank_of(sc[i], base + i) : kEmpty;
  }
  __syncthreads();                          // sc's storage is reused below

  // ranks a < b in one thread's registers, positions a TS + tid and
  // b TS + tid: the lower position takes the better rank on ascending runs
  auto exchange = [&](int a, int b, int size) {
    const bool up = ((a * TS + tid) & size) == 0;
    if ((v[b] > v[a]) == up) {
      const Rank t = v[a];
      v[a] = v[b];
      v[b] = t;
    }
  };
  for (int size = 2; size <= P; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= TS) {                        // within a thread
        if (sorter) {
          if (j / TS == 1) {
            exchange(0, 1, size);
            if (E > 2) exchange(2, 3, size);
          } else {
            exchange(0, 2, size);
            exchange(1, 3, size);
          }
        }
      } else if (j >= 32) {                 // across warps
        if (sorter) {
#pragma unroll
          for (int e = 0; e < kMaxPer; ++e)
            if (e < E) rk[e * TS + tid] = v[e];
        }
        __syncthreads();
        if (sorter) {
#pragma unroll
          for (int e = 0; e < kMaxPer; ++e) {
            const int i = e * TS + tid;
            if (e < E) {
              const Rank o = rk[i ^ j];
              const bool keep_better = ((i & j) == 0) == ((i & size) == 0);
              if ((o > v[e]) == keep_better) v[e] = o;
            }
          }
        }
        __syncthreads();
      } else if (sorter) {                  // across lanes
#pragma unroll
        for (int e = 0; e < kMaxPer; ++e) {
          if (e < E) {
            const int i = e * TS + tid;
            const Rank o = __shfl_xor_sync(repro_torch::kFullMask, v[e], j);
            const bool keep_better = ((lane & j) == 0) == ((i & size) == 0);
            if ((o > v[e]) == keep_better) v[e] = o;
          }
        }
      }
    }
  }
  if (sorter) {
#pragma unroll
    for (int e = 0; e < kMaxPer; ++e)
      if (e < E && e * TS + tid < k)
        write_rank(e * TS + tid, v[e], o);
  }
  write_past_slots(P, k, o);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
candidate_topk(const T* __restrict__ cands, const T* __restrict__ query,
               float* __restrict__ vals, long long* __restrict__ idx, int C,
               int D, int k, int vec, Rank* __restrict__ ranks, int sort) {
  extern __shared__ __align__(16) float smem[];
  const int P = block_slots(C);
  float* q = smem;                          // D, rounded up to 4 floats
  float* sc = q + ((D + 3) & ~3);           // P scores
  Rank* rk = reinterpret_cast<Rank*>(sc);   // then P ranks (2 P floats)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kBlockC;
  const int n = static_cast<int>(min(static_cast<long long>(kBlockC),
                                     static_cast<long long>(C) - base));
  if (!vec) {                               // the query as float32
    for (int d = tid; d < D; d += blockDim.x) q[d] = to_float(query[d]);
    __syncthreads();
  }
  constexpr int kPer = 16 / sizeof(T);      // values per 16-byte load
  constexpr int kLoads = 8 / kPer;          // loads per lane and row a pass
  constexpr int kPass = 32 * kPer * kLoads; // 256 row values a warp pass
  constexpr int kUnroll = 2 * kPer;         // rows a warp pass scores
  for (int r0 = warp; r0 < n; r0 += nw * kUnroll) {
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = 0.0f;
    if (vec) {                 // D % kPer == 0, rows and query aligned
      // every load of the pass, the query's slice too, is issued before
      // the first is used
      for (int d0 = 0; d0 < D; d0 += kPass) {
        uint4 raw[kUnroll][kLoads], qr[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int d = d0 + (j * 32 + lane) * kPer;
          qr[j] = d < D ? __ldg(reinterpret_cast<const uint4*>(query + d))
                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            const int r = r0 + u * nw, d = d0 + (j * 32 + lane) * kPer;
            raw[u][j] = r < n && d < D
                            ? __ldg(reinterpret_cast<const uint4*>(
                                  cands + (base + r) * D + d))
                            : make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            const int d = d0 + (j * 32 + lane) * kPer;
            if (d < D) acc[u] += dot16(raw[u][j], qr[j], T());
          }
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * nw;
        if (r >= n) continue;
        const T* row = cands + (base + r) * D;
        for (int d = lane; d < D; d += 32)
          acc[u] = fmaf(to_float(row[d]), q[d], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float a = repro_torch::warp_sum(acc[u]);
      if (lane == 0 && r0 + u * nw < n) sc[r0 + u * nw] = a;
    }
  }
  __syncthreads();
  const size_t at = static_cast<size_t>(blockIdx.x) * k;
  const BlockOut o = {vals + at, idx + at,
                      ranks != nullptr ? ranks + at : nullptr};
  if (sort && P == 32)
    select_sort_warp<32>(sc, n, k, base, o);
  else if (sort && P == 64)
    select_sort_warp<64>(sc, n, k, base, o);
  else if (sort)
    select_sort(sc, rk, n, P, k, base, o);
  else
    select_argmax(sc, rk, n, k, base, o);
}

template <typename T>
int launch(const void* cands, const void* query, void* vals, void* idx,
           int C, int D, int k, int vec, void* ranks, void* stream) {
  // 4 threads a slot within [128, kMaxThreads]: enough warps to score the
  // block's rows in one pass, and at least the P / 2 sorting threads
  const int P = block_slots(C);
  const int threads = min(kMaxThreads, max(128, 4 * P));
  const int sort = k > kArgmaxMaxK;
  const int blocks = (C + kBlockC - 1) / kBlockC;
  const size_t bytes = (((D + 3) & ~3) + 2 * P) * sizeof(float);
  static size_t smem_opted[repro_torch::kMaxDevices] = {};  // per type
  const cudaError_t err =
      repro_torch::allow_smem(candidate_topk<T>, bytes, smem_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  candidate_topk<T><<<blocks, threads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cands), static_cast<const T*>(query),
      static_cast<float*>(vals), static_cast<long long*>(idx), C, D, k, vec,
      static_cast<Rank*>(ranks), sort);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals (ceil(C / kBlockC), k) float32, idx and ranks the same shape int64
// (ranks may be null: one block's output needs no merge)
extern "C" int candidate_scorer_f32(const void* cands, const void* query,
                                    void* vals, void* idx, int C, int D,
                                    int k, int vec, void* ranks,
                                    void* stream) {
  return launch<float>(cands, query, vals, idx, C, D, k, vec, ranks, stream);
}

extern "C" int candidate_scorer_bf16(const void* cands, const void* query,
                                     void* vals, void* idx, int C, int D,
                                     int k, int vec, void* ranks,
                                     void* stream) {
  return launch<__nv_bfloat16>(cands, query, vals, idx, C, D, k, vec, ranks,
                               stream);
}
