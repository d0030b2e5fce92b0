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
//
// The grouped launch (embedding_bag_group_*): all of one model call's
// lookups in ONE launch. The serving path calls B3 once per feature field
// (the reference does too: models/recsys/common.py::embed_fields), five
// launches for a ranker micro-batch of 16, each a microsecond or two
// against a byte bound of a few hundredths: launch cost, not bytes, is
// what the per-field launches pay. So up to kMaxGroups (table, ids,
// weights, combiner) groups of one dtype and one D travel by value as ONE
// __grid_constant__ kernel parameter (no descriptor in device memory: no
// copy, no sync, and the launch can be captured into a CUDA graph); a
// slice of a warp finds its bag's group from the groups' prefix offsets.
// The bag body is sized for the shapes that run (D = 18, K = 1 mostly):
// each bag gets `lanes` lanes, a power of two (16 for D = 18 with 2-float
// loads, so a warp serves two bags), each lane `VEC`-element loads; a
// bag's ids and weights are loaded once, a lane per id, and broadcast by
// shuffles; kUnroll rows' loads are issued before any is accumulated.
// Each group is written at its descriptor's row stride and column offset,
// so the fields of a model call come out already concatenated.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (CUDA-graph
// replay, PERF.md, PR 16): a DIN micro-batch's 5 groups (1,664 bags) in
// 0.0026 ms, against 0.0094 for its five per-table launches and 0.0011
// for an empty kernel's launch.
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


// ------------------------------------------------------------ grouped launch

constexpr int kMaxGroups = 8;      // groups one grouped launch takes
constexpr int kGroupThreads = 128;
constexpr int kUnroll = 4;         // rows in flight per lane
constexpr int kMaxPasses = 2;      // column passes a lane accumulates at once

struct BagGroup {
  const void* table;               // (V, D) of T
  const int64_t* ids;              // (B, K)
  const float* weights;            // (B, K) or null (= ones)
  void* out;                       // bag b at out + b * out_stride + out_col
  long long V;
  int K, mean, out_stride, out_col;
  int bag0;                        // global index of the group's first bag
};

struct BagGroups {
  BagGroup g[kMaxGroups];
  int n, D;
  int total;                       // bags over every group
  int lanes;                       // lanes a bag, a power of two <= 32
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kGroupThreads)
embedding_bag_group_kernel(const __grid_constant__ BagGroups p) {
  const int lanes = p.lanes;
  const int l = threadIdx.x & (lanes - 1);
  const int bag = blockIdx.x * (kGroupThreads / lanes) + threadIdx.x / lanes;
  if (bag >= p.total) return;                 // the whole slice returns
  const unsigned mask =
      lanes == 32 ? repro_torch::kFullMask
                  : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  int gi = 0;
  while (gi + 1 < p.n && bag >= p.g[gi + 1].bag0) ++gi;
  const BagGroup& G = p.g[gi];
  const int b = bag - G.bag0, K = G.K;
  const long long V = G.V;
  const T* table = static_cast<const T*>(G.table);
  const int64_t* bid = G.ids + static_cast<size_t>(b) * K;
  const float* bw =
      G.weights != nullptr ? G.weights + static_cast<size_t>(b) * K : nullptr;
  T* out = static_cast<T*>(G.out) + static_cast<size_t>(b) * G.out_stride +
           G.out_col;
  float denom = 1.0f;
  if (G.mean) {                               // max(sum w, 1e-9)
    float ws = 0.0f;
    for (int k = l; k < K; k += lanes) ws += bw != nullptr ? bw[k] : 1.0f;
    for (int o = lanes >> 1; o > 0; o >>= 1)
      ws += __shfl_xor_sync(mask, ws, o);
    denom = fmaxf(ws, 1e-9f);
  }
  const int ncol = p.D / VEC;                 // VEC-element columns
  for (int c0 = 0; c0 < ncol; c0 += kMaxPasses * lanes) {
    float acc[kMaxPasses][VEC] = {};
    for (int k0 = 0; k0 < K; k0 += lanes) {
      // this lane's id and weight of the next `lanes` of the bag
      long long myid = 0;
      float myw = 0.0f;
      if (k0 + l < K) {
        const long long r = bid[k0 + l];
        myid = r < 0 ? 0 : (r >= V ? V - 1 : r);
        myw = bw != nullptr ? bw[k0 + l] : 1.0f;
      }
      const int kn = min(lanes, K - k0);
      for (int j0 = 0; j0 < kn; j0 += kUnroll) {
        long long row[kUnroll];
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          row[u] = __shfl_sync(mask, myid, j0 + u, lanes);
          w[u] = __shfl_sync(mask, myw, j0 + u, lanes);
        }
        Pack<T, VEC> v[kMaxPasses][kUnroll];
#pragma unroll
        for (int q = 0; q < kMaxPasses; ++q) {
          const int c = c0 + q * lanes + l;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (c < ncol && j0 + u < kn)
              v[q][u] = *reinterpret_cast<const Pack<T, VEC>*>(
                  table + row[u] * p.D + c * VEC);
        }
#pragma unroll
        for (int q = 0; q < kMaxPasses; ++q)
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (c0 + q * lanes + l < ncol && j0 + u < kn)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[q][e] = fmaf(w[u], to_float(v[q][u].v[e]), acc[q][e]);
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxPasses; ++q) {
      const int c = c0 + q * lanes + l;
      if (c < ncol) {
        Pack<T, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) store(&o.v[e], acc[q][e] / denom);
        *reinterpret_cast<Pack<T, VEC>*>(out + c * VEC) = o;
      }
    }
  }
}

// the widest VEC (4, 2 or 1 elements) that divides D and every group's
// output stride and column offset, with every table and output aligned to
// it
template <typename T>
int widest_vec(const BagGroups& p) {
  for (int vec = 4; vec > 1; vec >>= 1) {
    const uintptr_t bytes = vec * sizeof(T);
    bool ok = p.D % vec == 0;
    for (int i = 0; i < p.n && ok; ++i) {
      const BagGroup& g = p.g[i];
      ok = reinterpret_cast<uintptr_t>(g.table) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(g.out) % bytes == 0 &&
           g.out_stride % vec == 0 && g.out_col % vec == 0;
    }
    if (ok) return vec;
  }
  return 1;
}

template <typename T>
int launch_group(const void* groups, void* stream) {
  BagGroups p = *static_cast<const BagGroups*>(groups);
  if (p.n < 1 || p.n > kMaxGroups || p.D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.total <= 0) return static_cast<int>(cudaSuccess);
  const int vec = widest_vec<T>(p);
  const int ncol = p.D / vec;
  p.lanes = 1;
  while (p.lanes < ncol && p.lanes < 32) p.lanes <<= 1;
  const int per_block = kGroupThreads / p.lanes;
  const int blocks = (p.total + per_block - 1) / per_block;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    embedding_bag_group_kernel<T, 4><<<blocks, kGroupThreads, 0, st>>>(p);
  else if (vec == 2)
    embedding_bag_group_kernel<T, 2><<<blocks, kGroupThreads, 0, st>>>(p);
  else
    embedding_bag_group_kernel<T, 1><<<blocks, kGroupThreads, 0, st>>>(p);
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

// groups: a host pointer to one BagGroups (lanes is set here); it is
// copied into the launch's parameters, so it may be freed on return
extern "C" int embedding_bag_group_f32(const void* groups, void* stream) {
  return launch_group<float>(groups, stream);
}

extern "C" int embedding_bag_group_bf16(const void* groups, void* stream) {
  return launch_group<__nv_bfloat16>(groups, stream);
}
