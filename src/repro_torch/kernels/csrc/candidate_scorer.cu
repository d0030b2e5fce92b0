// Candidate scorer: blocked dot products plus an in-block top-k.
//
// Replaces src/repro/kernels/candidate_scorer/kernel.py::
// candidate_scorer_pallas (the padding of its ops.py wrapper is TPU tile
// bookkeeping; the cross-block merge stays outside the kernel there and
// here).
//
//   score[c] = sum_d cands[c, d] * query[d]          (float32 accumulator)
//   per block of kBlockC candidates: its k best (value, index) pairs,
//   best first, found by k rounds of block-wide argmax; on equal scores
//   the lower index wins, as jnp.argmax does.
//
// Bound on the H100: bytes. Every candidate row is read once (C * D
// values) for 2 flops per value, far below the card's flops-per-byte
// line. Each warp scores one row at a time with 16-byte loads
// (neighbouring lanes on neighbouring addresses: a 256-wide float32 row
// is two coalesced 512-byte segments), the query sits in shared memory as
// float32, and the scores of the block's rows stay in shared memory for
// the top-k rounds; only (k values, k indices) per block reach device
// memory. Many small blocks (kBlockC rows, 256 threads, ~5 KB of shared
// memory) keep enough loads in flight to stream the candidates at memory
// speed. A selected slot is marked -inf; a round that finds no slot left
// (k greater than the block's rows) writes -inf and index -1, which the
// wrapper's merge never picks since it requires k <= C.
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockC = 1024;       // candidates per block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// dot of 16 bytes of candidate row with the matching query slice
__device__ __forceinline__ float dot16(const float* row, const float* q) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(q);
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* row,
                                       const float* q) {
  const uint4 raw = *reinterpret_cast<const uint4*>(row);
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float acc = 0.0f;
#pragma unroll
  for (int i = 7; i >= 0; --i) acc = fmaf(__bfloat162float(v[i]), q[i], acc);
  return acc;
}

// keep the better of two (value, index) pairs: larger value, then lower
// index (an empty slot carries index INT_MAX)
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
candidate_topk(const T* __restrict__ cands, const T* __restrict__ query,
               float* __restrict__ vals, long long* __restrict__ idx, int C,
               int D, int k, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* q = smem;                          // D, rounded up to 4 floats
  float* sc = q + ((D + 3) & ~3);           // kBlockC scores
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = static_cast<long long>(blockIdx.x) * kBlockC;
  const int n = static_cast<int>(min(static_cast<long long>(kBlockC),
                                     static_cast<long long>(C) - base));
  for (int d = tid; d < D; d += kThreads) q[d] = to_float(query[d]);
  __syncthreads();
  constexpr int kPer = 16 / sizeof(T);      // values per 16-byte load
  for (int r = warp; r < n; r += kWarps) {
    const T* row = cands + (base + r) * D;
    float acc = 0.0f;
    if (vec) {                              // D % kPer == 0, rows aligned
      for (int d = lane * kPer; d < D; d += 32 * kPer)
        acc += dot16(row + d, q + d);
    } else {
      for (int d = lane; d < D; d += 32)
        acc = fmaf(to_float(row[d]), q[d], acc);
    }
    acc = repro_torch::warp_sum(acc);
    if (lane == 0) sc[r] = acc;
  }
  __syncthreads();
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  float* bv_out = vals + static_cast<size_t>(blockIdx.x) * k;
  long long* bi_out = idx + static_cast<size_t>(blockIdx.x) * k;
  for (int j = 0; j < k; ++j) {
    float bv = neg_inf;
    int bi = INT_MAX;
    for (int r = tid; r < n; r += kThreads) {
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
      for (int w = 1; w < kWarps; ++w) better(bv, bi, red_v[w], red_i[w]);
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

template <typename T>
int launch(const void* cands, const void* query, void* vals, void* idx,
           int C, int D, int k, int vec, void* stream) {
  const int blocks = (C + kBlockC - 1) / kBlockC;
  const size_t bytes = (((D + 3) & ~3) + kBlockC) * sizeof(float);
  static size_t smem_opted[repro_torch::kMaxDevices] = {};  // per type
  const cudaError_t err =
      repro_torch::allow_smem(candidate_topk<T>, bytes, smem_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  candidate_topk<T><<<blocks, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cands), static_cast<const T*>(query),
      static_cast<float*>(vals), static_cast<long long*>(idx), C, D, k, vec);
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
  return launch<__nv_bfloat16>(cands, query, vals, idx, C, D, k, vec,
                               stream);
}
