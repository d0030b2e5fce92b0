// Embedding bag: gather plus weighted sum of table rows.
//
// Replaces src/repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas
// (and the clip / mean combiner of its ops.py wrapper).
//
//   out[b, :] = sum_k w[b, k] * table[clip(ids[b, k], 0, V-1), :]
//   mean:  out[b, :] /= max(sum_k w[b, k], 1e-9)
//
// Bound on the H100: bytes. Each bag reads K rows of D values scattered
// over a table of up to gigabytes, plus its ids and weights, and writes D
// values; there are 2 flops per gathered element. The TPU kernel turns
// the gather into a sequential grid of one-row DMAs; here every bag is
// one warp, lanes walk the row (neighbouring lanes on neighbouring
// addresses, so each gathered row is one coalesced segment), and all bags
// run in parallel. The accumulator is float32 whatever the table type.
#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBagsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table,
                     const int64_t* __restrict__ ids,
                     const float* __restrict__ weights, T* __restrict__ out,
                     long long V, int D, int B, int K, int mean) {
  const int bag = blockIdx.x * kBagsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (bag >= B) return;
  const int64_t* bid = ids + static_cast<size_t>(bag) * K;
  const float* bw =
      weights != nullptr ? weights + static_cast<size_t>(bag) * K : nullptr;
  float denom = 1.0f;
  if (mean) {
    float wsum = 0.0f;
    for (int k = 0; k < K; ++k) wsum += bw != nullptr ? bw[k] : 1.0f;
    denom = fmaxf(wsum, 1e-9f);
  }
  for (int d = lane; d < D; d += 32) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      long long row = bid[k];
      row = row < 0 ? 0 : (row >= V ? V - 1 : row);
      const float w = bw != nullptr ? bw[k] : 1.0f;
      acc = fmaf(w, to_float(table[row * D + d]), acc);
    }
    // denom is 1 for "sum"; "mean" divides like the reference:
    // out / max(sum w, 1e-9)
    store(out + static_cast<size_t>(bag) * D + d, acc / denom);
  }
}

template <typename T>
int launch(const void* table, const void* ids, const void* weights, void* out,
           long long V, int D, int B, int K, int mean, void* stream) {
  const int blocks = (B + kBagsPerBlock - 1) / kBagsPerBlock;
  embedding_bag_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int64_t*>(ids),
      static_cast<const float*>(weights), static_cast<T*>(out), V, D, B, K,
      mean);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int embedding_bag_f32(const void* table, const void* ids,
                                 const void* weights, void* out, long long V,
                                 int D, int B, int K, int mean, void* stream) {
  return launch<float>(table, ids, weights, out, V, D, B, K, mean, stream);
}

extern "C" int embedding_bag_bf16(const void* table, const void* ids,
                                  const void* weights, void* out, long long V,
                                  int D, int B, int K, int mean, void* stream) {
  return launch<__nv_bfloat16>(table, ids, weights, out, V, D, B, K, mean,
                               stream);
}
