// Fused AUGRU: the input projection for every step, then the T-step
// recurrence with the attention-scaled update gate; final hidden state.
//
// Replaces src/repro/kernels/augru/kernel.py::augru_pallas (and the batch
// padding of its ops.py wrapper, which is TPU tile bookkeeping).
//
//   gx[b, t, :] = x[b, t, :] @ W + bias                 (all B*T rows)
//   per step t, with h_0 = 0 and gate order [r | z | n]:
//     gh = h @ U
//     r  = sigmoid(gx_r + gh_r)
//     z  = sigmoid(gx_z + gh_z) * att[b, t]
//     n  = tanh(gx_n + r * gh_n)
//     h  = (1 - z) * h + z * n
//   out[b, :] = h_T
//
// Bound on the H100: latency. At DIEN's widths (Din = H = 108, T = 100)
// the work is ~0.15 GFLOP at B=16 (microseconds at the float32 roof) and
// the inputs a few MB, but the T steps form a dependent chain, each a
// (1, H) @ (H, 3H) product followed by the gate update. Two kernels:
//
//   * augru_input_proj: gx for all B*T rows as one tiled SIMT product
//     (64x64 output tiles, 16-deep slices of x and W in shared memory,
//     a 4x4 register tile per thread), the TPU kernel's single MXU matmul
//     over every step. Written to a (B*T, 3H) scratch the wrapper owns.
//   * augru_recurrence: one block per batch row walks the T steps. U
//     (H x 3H floats: 140 KB at H = 108) sits in dynamic shared memory
//     for the whole sequence, h in shared memory; one thread per gate
//     column computes its h @ U dot product (h read as float4 broadcasts,
//     four accumulators), then H threads apply the gate update. The
//     step's gx row is loaded from global memory before the dot product,
//     so its latency hides behind it.
//
// Known limits of this first design: 140 KB of shared memory allows one
// block per SM, so only B of the 132 SMs work (16 at the micro-batch,
// 64 at the re-rank); each step reads U from shared memory once, so a step
// costs about (H * 3H / 32) shared-memory wavefronts, and the chain of T
// steps cannot overlap. Full float32: expf / tanhf, no fast intrinsics.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;           // output tile of the input projection
constexpr int kDepth = 16;          // depth slice of the input projection
constexpr int kProjThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxThreads = 1024;   // one thread per gate column: 3H <= 1024
size_t g_smem_opted[repro_torch::kMaxDevices] = {};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// gx (M, N) = x (M, K) @ w (K, N) + bias (N)
__global__ void __launch_bounds__(kProjThreads)
augru_input_proj(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ gx,
                 int M, int K, int N) {
  __shared__ float xs[kDepth][kTile + 1];   // x slice, transposed
  __shared__ float ws[kDepth][kTile];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int i = threadIdx.x; i < kTile * kDepth; i += kProjThreads) {
      const int r = i / kDepth, kk = i - r * kDepth;     // x: row-major
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < M && gk < K) ? x[static_cast<size_t>(gr) * K + gk]
                                     : 0.0f;
      const int wk = i / kTile, c = i - wk * kTile;      // w: row-major
      const int gwk = k0 + wk, gc = col0 + c;
      ws[wk][c] = (gwk < K && gc < N) ? w[static_cast<size_t>(gwk) * N + gc]
                                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < N) gx[static_cast<size_t>(gr) * N + gc] = acc[i][j] + bias[gc];
    }
  }
}

// One block per batch row; blockDim.x >= 3H (a multiple of 32).
__global__ void __launch_bounds__(kMaxThreads)
augru_recurrence(const float* __restrict__ gx, const float* __restrict__ att,
                 const float* __restrict__ u, float* __restrict__ out, int T,
                 int H) {
  extern __shared__ __align__(16) float smem[];
  const int N = 3 * H;
  const int Hp = (H + 3) & ~3;              // h padded to whole float4s
  float* us = smem;                         // H * N    U, row-major
  float* hs = us + ((H * N + 3) & ~3);      // Hp       h, zero padded, aligned
  float* pre = hs + Hp;                     // N        gx_r+gh_r | gx_z+gh_z | gh_n
  float* gxn = pre + N;                     // H        gx_n
  const int b = blockIdx.x, j = threadIdx.x;
  for (int i = j; i < H * N; i += blockDim.x) us[i] = u[i];
  for (int i = j; i < Hp; i += blockDim.x) hs[i] = 0.0f;
  __syncthreads();
  const float* gxb = gx + static_cast<size_t>(b) * T * N;
  const float* atb = att + static_cast<size_t>(b) * T;
  const float4* h4 = reinterpret_cast<const float4*>(hs);
  const int H4 = H >> 2;
  float h_own = 0.0f;                       // h[j] for the threads j < H
  for (int t = 0; t < T; ++t) {
    if (j < N) {
      const float g = gxb[static_cast<size_t>(t) * N + j];
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      const float* uc = us + j;
      for (int k4 = 0; k4 < H4; ++k4) {
        const float4 hv = h4[k4];
        const float* ur = uc + 4 * k4 * N;
        a0 = fmaf(hv.x, ur[0], a0);
        a1 = fmaf(hv.y, ur[N], a1);
        a2 = fmaf(hv.z, ur[2 * N], a2);
        a3 = fmaf(hv.w, ur[3 * N], a3);
      }
      for (int k = 4 * H4; k < H; ++k) a0 = fmaf(hs[k], uc[k * N], a0);
      const float gh = (a0 + a1) + (a2 + a3);
      if (j < 2 * H) {
        pre[j] = g + gh;
      } else {
        pre[j] = gh;
        gxn[j - 2 * H] = g;
      }
    }
    __syncthreads();
    if (j < H) {
      const float r = sigmoid(pre[j]);
      const float z = sigmoid(pre[H + j]) * atb[t];
      const float n = tanhf(gxn[j] + r * pre[2 * H + j]);
      h_own = (1.0f - z) * h_own + z * n;
      hs[j] = h_own;
    }
    __syncthreads();
  }
  if (j < H) out[static_cast<size_t>(b) * H + j] = h_own;
}

}  // namespace

// gx: scratch of B * T * 3H floats. Returns the first CUDA error.
extern "C" int augru_f32(const void* x, const void* att, const void* w,
                         const void* u, const void* bias, void* gx, void* out,
                         int B, int T, int Din, int H, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = 3 * H, M = B * T;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* g = static_cast<float*>(gx);
  if (M > 0) {
    const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    augru_input_proj<<<grid, kProjThreads, 0, st>>>(f(x), f(w), f(bias), g,
                                                    M, Din, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = ((N + 31) / 32) * 32;
  const size_t bytes =
      (((static_cast<size_t>(H) * N + 3) & ~size_t{3}) + ((H + 3) & ~3) + N +
       H) * sizeof(float);
  const cudaError_t err =
      repro_torch::allow_smem(augru_recurrence, bytes, g_smem_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  augru_recurrence<<<B, threads, bytes, st>>>(g, f(att), f(u),
                                              static_cast<float*>(out), T, H);
  return static_cast<int>(cudaGetLastError());
}
