// Candidate scorer: blocked dot products plus an in-block top-k.
//
// Replaces src/repro/kernels/candidate_scorer/kernel.py::
// candidate_scorer_pallas (the padding of its ops.py wrapper is TPU tile
// bookkeeping; the cross-block merge stays outside the kernel there and
// here).
//
//   score[c] = sum_d cands[c, d] * query[d]          (float32 accumulator)
//   per block of at most kBlockC candidates: its k best (value, index)
//   pairs, best first; on equal scores the lower index wins, as
//   jnp.argmax and the reference's top-k do.
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
// P = 64, 21 stages without a block barrier, whatever k is. Only the
// first k pairs are written; slots past the block's rows hold (-inf, a
// local index past them) and, if k exceeds the rows, come out as (-inf,
// -1), which the wrapper's merge never picks since it requires k <= C.
//
// The first design's selection, k rounds of block-wide argmax (each a
// scan of the scores, a shuffle reduce and two barriers), stays as the
// other method, for k <= kArgmaxMaxK, where a chip measurement shows it
// cheaper; launch() picks the method by k and the block size by C.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (device time per
// call by CUDA-graph replay; in parentheses this file's first design,
// commit 61b208e, measured by that commit's chip_smoke.py in the same chip
// call): the two-tower service's shape (C = 64, D = 256, k = 64, f32)
// 0.0036-0.0038 ms (0.0321), torch.topk(torch.mv) 0.0119; the recall shape
// (C = 10^6, k = 8, f32) 0.381 ms (0.449), byte bound 0.306, library
// 0.453. Known limit: C of one to a few blocks (1,024 and 4,096 at k = 8:
// 0.037 and 0.048 ms, library 0.017 and 0.027) runs one block per SM on
// one to four SMs; the block's rows are not spread over the card.
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
// H100 80GB HBM3 at 700 W; the reading and its script in PERF.md):
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

// (ov, oi) ranks above (v, i): larger value, then lower index
__device__ __forceinline__ bool ranks_above(float ov, int oi, float v, int i) {
  return ov > v || (ov == v && oi < i);
}

// keep the better of two (value, index) pairs (an empty slot carries
// index INT_MAX)
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ranks_above(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// slots of a block: min(C, kBlockC) rounded up to a power of two, >= 32
__host__ __device__ inline int block_slots(int C) {
  int p = 32;
  while (p < C && p < kBlockC) p <<= 1;
  return p;
}

// the block's k best of its n scores by k rounds of block-wide argmax
__device__ void select_argmax(float* sc, int n, int k, long long base,
                              float* bv_out, long long* bi_out) {
  __shared__ float red_v[kMaxWarps];
  __shared__ int red_i[kMaxWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5;
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  for (int j = 0; j < k; ++j) {
    float bv = neg_inf;
    int bi = INT_MAX;
    for (int r = tid; r < n; r += blockDim.x) {
      const float v = sc[r];
      if (v > neg_inf) better(bv, bi, v, r);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      better(bv, bi, __shfl_xor_sync(repro_torch::kFullMask, bv, o),
             __shfl_xor_sync(repro_torch::kFullMask, bi, o));
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nw; ++w) better(bv, bi, red_v[w], red_i[w]);
      if (bi == INT_MAX) {
        bv_out[j] = neg_inf;
        bi_out[j] = -1;
      } else {
        bv_out[j] = bv;
        bi_out[j] = base + bi;
        sc[bi] = neg_inf;                   // taken
      }
    }
    __syncthreads();
  }
}

// the first k of a sorted block written out; slots past the rows, and
// positions past the slots, come out as (-inf, -1)
__device__ __forceinline__ void write_sorted(int p, float v, int i, int n,
                                             int k, long long base,
                                             float* bv_out,
                                             long long* bi_out) {
  if (p >= k) return;
  const bool real = i < n;
  bv_out[p] = real ? v : __int_as_float(static_cast<int>(0xff800000u));
  bi_out[p] = real ? base + i : -1;
}
__device__ __forceinline__ void write_past_slots(int P, int k, float* bv_out,
                                                 long long* bi_out) {
  for (int p = P + threadIdx.x; p < k; p += blockDim.x) {
    bv_out[p] = __int_as_float(static_cast<int>(0xff800000u));
    bi_out[p] = -1;
  }
}

// the bitonic sort of kP <= 64 slots on the block's first warp: kP / 32
// pairs a lane, every stage unrolled (strides of 32 between a lane's two
// registers, the rest by __shfl_xor_sync); no shared memory, no barrier
template <int kP>
__device__ void select_sort_warp(const float* sc, int n, int k,
                                 long long base, float* bv_out,
                                 long long* bi_out) {
  constexpr int E = kP / 32;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[2];                             // E of them hold pairs
    int ix[2];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ix[e] = e * 32 + lane;
      v[e] = ix[e] < n ? sc[ix[e]]
                       : __int_as_float(static_cast<int>(0xff800000u));
    }
#pragma unroll
    for (int size = 2; size <= kP; size <<= 1) {
#pragma unroll
      for (int j = size >> 1; j > 0; j >>= 1) {
        if (j >= 32) {                      // the lane's two registers
          const bool up = (lane & size) == 0;
          if (ranks_above(v[1], ix[1], v[0], ix[0]) == up) {
            const float tv = v[0];
            const int ti = ix[0];
            v[0] = v[1];
            ix[0] = ix[1];
            v[1] = tv;
            ix[1] = ti;
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float ov = __shfl_xor_sync(repro_torch::kFullMask, v[e], j);
            const int oi = __shfl_xor_sync(repro_torch::kFullMask, ix[e], j);
            const bool keep_better =
                ((lane & j) == 0) == (((e * 32 + lane) & size) == 0);
            if (ranks_above(ov, oi, v[e], ix[e]) == keep_better) {
              v[e] = ov;
              ix[e] = oi;
            }
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      write_sorted(e * 32 + lane, v[e], ix[e], n, k, base, bv_out, bi_out);
  }
  write_past_slots(kP, k, bv_out, bi_out);
}

// the block's k best of its n scores by a bitonic sort of its P slots;
// sc (P floats) and si (P ints) carry the shared-memory stages
__device__ void select_sort(float* sc, int* si, int n, int P, int k,
                            long long base, float* bv_out,
                            long long* bi_out) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int TS = min(static_cast<int>(blockDim.x), max(32, P >> 1));
  const int E = P / TS;                     // 1, 2 or 4 pairs a thread
  const bool sorter = tid < TS;
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  float v[kMaxPer];
  int ix[kMaxPer];
#pragma unroll
  for (int e = 0; e < kMaxPer; ++e) {
    const int i = e * TS + tid;
    v[e] = sorter && e < E && i < n ? sc[i] : neg_inf;
    ix[e] = i;
  }
  __syncthreads();                          // sc is reused below

  // pairs a < b in one thread's registers, positions a TS + tid and
  // b TS + tid: the lower position takes the better pair on ascending runs
  auto exchange = [&](int a, int b, int size) {
    const bool up = ((a * TS + tid) & size) == 0;
    if (ranks_above(v[b], ix[b], v[a], ix[a]) == up) {
      const float tv = v[a];
      const int ti = ix[a];
      v[a] = v[b];
      ix[a] = ix[b];
      v[b] = tv;
      ix[b] = ti;
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
          for (int e = 0; e < kMaxPer; ++e) {
            if (e < E) {
              sc[e * TS + tid] = v[e];
              si[e * TS + tid] = ix[e];
            }
          }
        }
        __syncthreads();
        if (sorter) {
#pragma unroll
          for (int e = 0; e < kMaxPer; ++e) {
            const int i = e * TS + tid;
            if (e < E) {
              const float ov = sc[i ^ j];
              const int oi = si[i ^ j];
              const bool keep_better = ((i & j) == 0) == ((i & size) == 0);
              if (ranks_above(ov, oi, v[e], ix[e]) == keep_better) {
                v[e] = ov;
                ix[e] = oi;
              }
            }
          }
        }
        __syncthreads();
      } else if (sorter) {                  // across lanes
#pragma unroll
        for (int e = 0; e < kMaxPer; ++e) {
          if (e < E) {
            const int i = e * TS + tid;
            const float ov = __shfl_xor_sync(repro_torch::kFullMask, v[e], j);
            const int oi = __shfl_xor_sync(repro_torch::kFullMask, ix[e], j);
            const bool keep_better = ((lane & j) == 0) == ((i & size) == 0);
            if (ranks_above(ov, oi, v[e], ix[e]) == keep_better) {
              v[e] = ov;
              ix[e] = oi;
            }
          }
        }
      }
    }
  }
  if (sorter) {
#pragma unroll
    for (int e = 0; e < kMaxPer; ++e)
      if (e < E)
        write_sorted(e * TS + tid, v[e], ix[e], n, k, base, bv_out, bi_out);
  }
  write_past_slots(P, k, bv_out, bi_out);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
candidate_topk(const T* __restrict__ cands, const T* __restrict__ query,
               float* __restrict__ vals, long long* __restrict__ idx, int C,
               int D, int k, int vec, int sort) {
  extern __shared__ __align__(16) float smem[];
  const int P = block_slots(C);
  float* q = smem;                          // D, rounded up to 4 floats
  float* sc = q + ((D + 3) & ~3);           // P scores
  int* si = reinterpret_cast<int*>(sc + P); // P indices (sort stages)
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
  float* bv_out = vals + static_cast<size_t>(blockIdx.x) * k;
  long long* bi_out = idx + static_cast<size_t>(blockIdx.x) * k;
  if (sort && P == 32)
    select_sort_warp<32>(sc, n, k, base, bv_out, bi_out);
  else if (sort && P == 64)
    select_sort_warp<64>(sc, n, k, base, bv_out, bi_out);
  else if (sort)
    select_sort(sc, si, n, P, k, base, bv_out, bi_out);
  else
    select_argmax(sc, n, k, base, bv_out, bi_out);
}

template <typename T>
int launch(const void* cands, const void* query, void* vals, void* idx,
           int C, int D, int k, int vec, void* stream) {
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
      sort);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals (ceil(C / kBlockC), k) float32, idx the same shape int64
extern "C" int candidate_scorer_f32(const void* cands, const void* query,
                                    void* vals, void* idx, int C, int D,
                                    int k, int vec, void* stream) {
  return launch<float>(cands, query, vals, idx, C, D, k, vec, stream);
}

extern "C" int candidate_scorer_bf16(const void* cands, const void* query,
                                     void* vals, void* idx, int C, int D,
                                     int k, int vec, void* stream) {
  return launch<__nv_bfloat16>(cands, query, vals, idx, C, D, k, vec, stream);
}
