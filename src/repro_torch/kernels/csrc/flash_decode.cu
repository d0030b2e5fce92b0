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
// SMs. Here the sequence is split across blocks:
//
//   * flash_decode_split: one block per (split, h, b) streams its chunk of
//     the cache in tiles of kTile rows. A tile's K and V rows come in once,
//     with 16-byte loads (neighbouring threads on neighbouring addresses),
//     and stay in shared memory as float32; all G query heads of the kv
//     head score against the same K rows and sum the same V rows. A
//     running (m, l, acc[G, D]) in float32 follows the online softmax, and
//     the block writes it to the workspace the wrapper allocates. A block
//     whose chunk starts at or past cache_len writes an empty partial
//     (m = -1e30, l = 0, acc = 0) and exits.
//   * flash_decode_combine: one block per (b, h) merges the splits in
//     split order, so results do not depend on scheduling, and writes
//     acc / max(l, 1e-30) in q's dtype.
//
// cache_len is read from device memory (the TPU kernel's scalar prefetch),
// so the host never waits on it and the launch can be captured into a CUDA
// graph. Scores past it are masked with -1e30, as the reference masks them;
// expf, not __expf. Known limits of this first design: no tensor cores, no
// TMA and no double buffering of the tiles (other resident blocks hide the
// loads), four barriers a tile, and the PV product reads two shared-memory
// operands per multiply-add.
#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;              // cache rows per tile: one per lane
constexpr float kNegInf = -1e30f;      // the reference's mask value

// 16 bytes of a cache row -> float32 values
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(v[i]);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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

// workspace per (b, h, split): m[G], l[G], acc[G][D]
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ cache_len,
                   float* __restrict__ work, int H, int G, int S, int chunk,
                   int n_split, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                      // kTile x D
  float* vs = ks + kTile * D;            // kTile x D
  float* qs = vs + kTile * D;            // G x D
  float* acc = qs + G * D;               // G x D
  float* sc = acc + G * D;               // G x kTile: scores, then p
  float* ms = sc + G * kTile;            // G running maxima
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
    for (int i = tid; i < G * (D + 2); i += kThreads)
      part[i] = i < G ? kNegInf : 0.0f;
    return;
  }
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_float(q[bh * G * D + i]);
    acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.0f;
  }
  __syncthreads();

  constexpr int kPer = 16 / sizeof(T);   // values per 16-byte load
  constexpr int kVpr = D / kPer;         // 16-byte loads per row
  constexpr int kLpr = D / 4;            // lanes per row when scoring
  constexpr int kRpw = 32 / kLpr;        // rows a warp scores at once
  constexpr int kQuads = D / 4;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const T* kb = k + static_cast<size_t>(b) * S * row_stride + h * D;
  const T* vb = v + static_cast<size_t>(b) * S * row_stride + h * D;

  for (int t0 = start; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);
    // 1. the tile's K and V rows, once, into shared memory as float32
    for (int i = tid; i < n * kVpr; i += kThreads) {
      const int r = i / kVpr, c = (i % kVpr) * kPer;
      const size_t off = (t0 + r) * row_stride + c;
      float tmp[kPer];
      load16(kb + off, tmp);
#pragma unroll
      for (int e = 0; e < kPer; e += 4)
        *reinterpret_cast<float4*>(ks + r * D + c + e) =
            make_float4(tmp[e], tmp[e + 1], tmp[e + 2], tmp[e + 3]);
      load16(vb + off, tmp);
#pragma unroll
      for (int e = 0; e < kPer; e += 4)
        *reinterpret_cast<float4*>(vs + r * D + c + e) =
            make_float4(tmp[e], tmp[e + 1], tmp[e + 2], tmp[e + 3]);
    }
    __syncthreads();
    // 2. scores of every query head against every row; kLpr lanes per row
    //    (rows past the tile's valid ones are masked, their lanes idle in
    //    step with the rest of the warp)
    for (int r0 = warp * kRpw; r0 < kTile; r0 += kWarps * kRpw) {
      const int r = r0 + lane / kLpr, sub = lane % kLpr;
      const float4 kv = *reinterpret_cast<const float4*>(ks + r * D + sub * 4);
      for (int g = 0; g < G; ++g) {
        float part_s =
            dot4(kv, *reinterpret_cast<const float4*>(qs + g * D + sub * 4));
#pragma unroll
        for (int o = kLpr / 2; o > 0; o >>= 1)
          part_s += __shfl_xor_sync(repro_torch::kFullMask, part_s, o);
        if (sub == 0) sc[g * kTile + r] = r < n ? part_s * scale : kNegInf;
      }
    }
    __syncthreads();
    // 3. online softmax per query head: one warp per head, one row per lane
    for (int g = warp; g < G; g += kWarps) {
      const float s = sc[g * kTile + lane];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m_old - m_new);
      const float p_sum = repro_torch::warp_sum(p);
      sc[g * kTile + lane] = p;
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
      const float* pg = sc + g * kTile;
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
  for (int i = tid; i < G * (D + 2); i += kThreads)
    part[i] = i < G ? ms[i] : (i < 2 * G ? ls[i - G] : acc[i - 2 * G]);
}

// one block per (b, h): the splits' partials merged in split order
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const float* __restrict__ work, T* __restrict__ out,
                     int G, int D, int n_split) {
  const size_t bh = blockIdx.x;
  const size_t stride = static_cast<size_t>(G) * (D + 2);
  const float* base = work + bh * n_split * stride;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float m = kNegInf;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, base[s * stride + g]);
    float l = 0.0f, a = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float* w = base + s * stride;
      const float e = expf(w[g] - m);
      l = fmaf(w[G + g], e, l);
      a = fmaf(w[2 * G + i], e, a);
    }
    store(out + bh * G * D + i, a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v,
             const void* cache_len, void* work, void* out, int B, int H,
             int G, int S, int chunk, int n_split, float scale,
             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes =
      sizeof(float) * (2 * kTile * D + 2 * G * D + G * kTile + 3 * G);
  static size_t smem_opted[repro_torch::kMaxDevices] = {};
  cudaError_t err =
      repro_torch::allow_smem(flash_decode_split<T, D>, bytes, smem_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_split<T, D><<<dim3(n_split, H, B), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(cache_len),
      static_cast<float*>(work), H, G, S, chunk, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine<T><<<B * H, kThreads, 0, st>>>(
      static_cast<const float*>(work), static_cast<T*>(out), G, D, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cache_len,
           void* work, void* out, int B, int H, int G, int D, int S,
           int chunk, int n_split, float scale, void* stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, cache_len, work, out, B, H, G, S,
                             chunk, n_split, scale, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, cache_len, work, out, B, H, G, S,
                             chunk, n_split, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, cache_len, work, out, B, H, G, S,
                             chunk, n_split, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, cache_len, work, out, B, H, G, S,
                              chunk, n_split, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,H,G,D), caches (B,S,H,D), cache_len one int32 on the device,
// work (B*H*n_split*G*(D+2)) float32, out (B,H,G,D) in q's dtype
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* cache_len, void* work, void* out,
                                int B, int H, int G, int D, int S, int chunk,
                                int n_split, float scale, void* stream) {
  return launch<float>(q, k, v, cache_len, work, out, B, H, G, D, S, chunk,
                       n_split, scale, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* cache_len, void* work, void* out,
                                 int B, int H, int G, int D, int S, int chunk,
                                 int n_split, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cache_len, work, out, B, H, G, D, S,
                               chunk, n_split, scale, stream);
}
