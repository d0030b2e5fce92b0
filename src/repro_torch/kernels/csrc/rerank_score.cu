// Fused re-rank scorer: one user's history against C candidates.
//
// Replaces src/repro/kernels/rerank_score/kernel.py::rerank_score_pallas.
//
// Per candidate c (target t_c, side features io_c), with the user's
// history h_1..h_T, mask m and side features uo:
//   a_{c,s} = silu(silu([h_s, t_c, h_s - t_c, h_s * t_c] @ A1 + ab1) @ A2
//                  + ab2) @ a3 + ab3                        (DIN unit)
//   pooled_c = sum_s a_{c,s} * m_s * h_s                      (no softmax)
//   score_c  = silu(silu([pooled_c, t_c, uo, io_c] @ M1 + mb1) @ M2 + mb2)
//              @ m3 + mb3
//
// The history is shared by every candidate, so the first attention layer
// is decomposed around it, as the TPU kernel does: with A1 split into its
// row blocks (Wa | Wb | Wc | Wd),
//   feat @ A1 = h @ (Wa + Wc) + t @ (Wb - Wc) + (h * t) @ Wd,
// where ah = h @ (Wa + Wc) + ab1 is computed once per block for the
// kCands candidates it scores, and t @ (Wb - Wc) once per candidate. Only
// (h * t) @ Wd is paid per (candidate, step): D*H1 instead of 4D*H1
// multiply-adds.
//
// Bound on the H100: latency and shared-memory traffic, not bytes or
// flops. The inputs are a few hundred KB (history T*D, C candidates,
// ~160 KB of weights) and the work ~30 MFLOP per request at the paper's
// widths, microseconds at either roof. Two kernels:
//
//   * rerank_attention_chunk: the history is split into chunks of kChunk
//     steps and every (chunk, pair of candidates) is a block of its own
//     (128 blocks at C=64, T=100). The pair shares ah for its chunk. The
//     block computes each layer for every (candidate, step, unit) triple at
//     once over 512 threads: every thread owns whole dot products (two
//     accumulators each), the attention weights sit in shared memory
//     (reads conflict-free across a warp), no hidden vector leaves the
//     chip, and a warp per (candidate, step) reduces the attention output.
//     The block writes each candidate's partial pooled vector for its
//     chunk.
//   * rerank_score_mlp: one block per candidate sums the partials in chunk
//     order (the result does not depend on block scheduling), builds
//     [pooled, t, uo, io] and runs the score MLP, one thread per unit, its
//     weights (~136 KB) read through L1/L2, coalesced across units.
//
// Candidates are not padded: the last block of a row may score fewer.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCands = 2;      // candidates per attention block, sharing ah
constexpr int kChunk = 32;     // history steps per attention block
constexpr int kMlpThreads = 256;
size_t g_smem_opted[repro_torch::kMaxDevices] = {};

__global__ void __launch_bounds__(kThreads)
rerank_attention_chunk(const float* __restrict__ hist,
                       const float* __restrict__ mask,
                       const float* __restrict__ tgt,
                       const float* __restrict__ a1,
                       const float* __restrict__ ab1,
                       const float* __restrict__ a2,
                       const float* __restrict__ ab2,
                       const float* __restrict__ a3,
                       const float* __restrict__ ab3,
                       float* __restrict__ partial, int T, int D, int C,
                       int H1, int H2) {
  extern __shared__ float smem[];
  float* wac = smem;                      // D*H1   Wa + Wc
  float* wd = wac + D * H1;               // D*H1   Wd
  float* a2s = wd + D * H1;               // H1*H2
  float* ab1s = a2s + H1 * H2;            // H1
  float* ab2s = ab1s + H1;                // H2
  float* a3s = ab2s + H2;                 // H2
  float* bt = a3s + H2;                   // kCands*H1  t_c @ (Wb - Wc)
  float* tg = bt + kCands * H1;           // kCands*D   t_c
  float* hs = tg + kCands * D;            // kChunk*D   the chunk's history
  float* ms = hs + kChunk * D;            // kChunk     its mask
  float* ah = ms + kChunk;                // kChunk*H1  h @ (Wa + Wc) + ab1
  float* h1 = ah + kChunk * H1;           // kCands*kChunk*H1
  float* g = h1 + kCands * kChunk * H1;   // kCands*kChunk*H2  silu(.) * a3
  float* wt = g + kCands * kChunk * H2;   // kCands*kChunk  masked weights

  const int chunk = blockIdx.x, nchunks = gridDim.x;
  const int t0 = chunk * kChunk, ns = min(kChunk, T - t0);
  const int c0 = blockIdx.y * kCands, nc = min(kCands, C - c0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;

  for (int i = tid; i < D * H1; i += nthreads) {
    wac[i] = a1[i] + a1[2 * D * H1 + i];
    wd[i] = a1[3 * D * H1 + i];
  }
  for (int i = tid; i < H1 * H2; i += nthreads) a2s[i] = a2[i];
  for (int i = tid; i < H1; i += nthreads) ab1s[i] = ab1[i];
  for (int i = tid; i < H2; i += nthreads) {
    ab2s[i] = ab2[i];
    a3s[i] = a3[i];
  }
  for (int i = tid; i < nc * D; i += nthreads)
    tg[i] = tgt[static_cast<size_t>(c0) * D + i];
  for (int i = tid; i < ns * D; i += nthreads)
    hs[i] = hist[static_cast<size_t>(t0) * D + i];
  for (int i = tid; i < ns; i += nthreads) ms[i] = mask[t0 + i];
  __syncthreads();
  for (int i = tid; i < nc * H1; i += nthreads) {
    const int c = i / H1, j = i - c * H1;
    const float* tc = tg + c * D;
    float a = 0.0f;
    for (int d = 0; d < D; ++d)
      a = fmaf(tc[d], a1[(D + d) * H1 + j] - a1[(2 * D + d) * H1 + j], a);
    bt[i] = a;
  }
  // the shared term, once for the block's candidates
  for (int i = tid; i < ns * H1; i += nthreads) {
    const int s = i / H1, j = i - s * H1;
    const float* h = hs + s * D;
    float a0 = ab1s[j], a1v = 0.0f;
    int d = 0;
#pragma unroll 4
    for (; d + 1 < D; d += 2) {
      a0 = fmaf(h[d], wac[d * H1 + j], a0);
      a1v = fmaf(h[d + 1], wac[(d + 1) * H1 + j], a1v);
    }
    if (d < D) a0 = fmaf(h[d], wac[d * H1 + j], a0);
    ah[i] = a0 + a1v;
  }
  __syncthreads();
  // first layer, every (candidate, step, unit)
  const int per_c1 = ns * H1;
  for (int i = tid; i < nc * per_c1; i += nthreads) {
    const int c = i / per_c1, r = i - c * per_c1;
    const int s = r / H1, j = r - s * H1;
    const float* h = hs + s * D;
    const float* tc = tg + c * D;
    float a0 = 0.0f, a1v = 0.0f;
    int d = 0;
#pragma unroll 4
    for (; d + 1 < D; d += 2) {
      a0 = fmaf(h[d] * tc[d], wd[d * H1 + j], a0);
      a1v = fmaf(h[d + 1] * tc[d + 1], wd[(d + 1) * H1 + j], a1v);
    }
    if (d < D) a0 = fmaf(h[d] * tc[d], wd[d * H1 + j], a0);
    h1[(c * kChunk + s) * H1 + j] =
        repro_torch::silu(a0 + a1v + ah[r] + bt[c * H1 + j]);
  }
  __syncthreads();
  // second layer, times the attention output weights
  const int per_c2 = ns * H2;
  for (int i = tid; i < nc * per_c2; i += nthreads) {
    const int c = i / per_c2, r = i - c * per_c2;
    const int s = r / H2, k = r - s * H2;
    const float* x = h1 + (c * kChunk + s) * H1;
    float a0 = ab2s[k], a1v = 0.0f;
    int j = 0;
#pragma unroll 4
    for (; j + 1 < H1; j += 2) {
      a0 = fmaf(x[j], a2s[j * H2 + k], a0);
      a1v = fmaf(x[j + 1], a2s[(j + 1) * H2 + k], a1v);
    }
    if (j < H1) a0 = fmaf(x[j], a2s[j * H2 + k], a0);
    g[(c * kChunk + s) * H2 + k] = repro_torch::silu(a0 + a1v) * a3s[k];
  }
  __syncthreads();
  // attention output: one warp per (candidate, step)
  const float bias3 = ab3[0];
  for (int p = warp; p < nc * ns; p += nwarps) {
    const int c = p / ns, s = p - c * ns;
    const float* gr = g + (c * kChunk + s) * H2;
    float v = 0.0f;
    for (int k = lane; k < H2; k += 32) v += gr[k];
    v = repro_torch::warp_sum(v);
    if (lane == 0) wt[c * kChunk + s] = (v + bias3) * ms[s];
  }
  __syncthreads();
  for (int i = tid; i < nc * D; i += nthreads) {
    const int c = i / D, d = i - c * D;
    float a = 0.0f;
    for (int s = 0; s < ns; ++s) a = fmaf(wt[c * kChunk + s], hs[s * D + d], a);
    partial[(static_cast<size_t>(c0 + c) * nchunks + chunk) * D + d] = a;
  }
}

__global__ void __launch_bounds__(kMlpThreads)
rerank_score_mlp(const float* __restrict__ partial,
                 const float* __restrict__ tgt, const float* __restrict__ uo,
                 const float* __restrict__ io, const float* __restrict__ m1,
                 const float* __restrict__ mb1, const float* __restrict__ m2,
                 const float* __restrict__ mb2, const float* __restrict__ m3,
                 const float* __restrict__ mb3, float* __restrict__ out,
                 int nchunks, int D, int du, int di, int M1, int M2) {
  const int K1 = 2 * D + du + di;
  extern __shared__ float smem[];
  float* xx = smem;                   // K1   [pooled, t, uo, io]
  float* s1 = xx + K1;                // M1   score hidden
  float* s2 = s1 + M1;                // M2   silu(.) * m3
  const int c = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  for (int k = tid; k < K1; k += nthreads) {
    float v;
    if (k < D) {                                    // pooled, chunk order
      const float* p = partial + static_cast<size_t>(c) * nchunks * D + k;
      v = 0.0f;
      for (int q = 0; q < nchunks; ++q) v += p[static_cast<size_t>(q) * D];
    } else if (k < 2 * D) {
      v = tgt[static_cast<size_t>(c) * D + (k - D)];
    } else if (k < 2 * D + du) {
      v = uo[k - 2 * D];
    } else {
      v = io[static_cast<size_t>(c) * di + (k - 2 * D - du)];
    }
    xx[k] = v;
  }
  __syncthreads();
  for (int j = tid; j < M1; j += nthreads) {
    float a0 = mb1[j], a1v = 0.0f;
    int k = 0;
#pragma unroll 4
    for (; k + 1 < K1; k += 2) {
      a0 = fmaf(xx[k], m1[k * M1 + j], a0);
      a1v = fmaf(xx[k + 1], m1[(k + 1) * M1 + j], a1v);
    }
    if (k < K1) a0 = fmaf(xx[k], m1[k * M1 + j], a0);
    s1[j] = repro_torch::silu(a0 + a1v);
  }
  __syncthreads();
  for (int k = tid; k < M2; k += nthreads) {
    float a0 = mb2[k], a1v = 0.0f;
    int j = 0;
#pragma unroll 4
    for (; j + 1 < M1; j += 2) {
      a0 = fmaf(s1[j], m2[j * M2 + k], a0);
      a1v = fmaf(s1[j + 1], m2[(j + 1) * M2 + k], a1v);
    }
    if (j < M1) a0 = fmaf(s1[j], m2[j * M2 + k], a0);
    s2[k] = repro_torch::silu(a0 + a1v) * m3[k];
  }
  __syncthreads();
  if (tid < 32) {
    float v = 0.0f;
    for (int k = tid; k < M2; k += 32) v += s2[k];
    v = repro_torch::warp_sum(v);
    if (tid == 0) out[c] = v + mb3[0];
  }
}

}  // namespace

// partial: scratch of C * ceil(T / kChunk) * D floats
extern "C" int rerank_score_f32(
    const void* hist, const void* mask, const void* tgt, const void* uo,
    const void* io, const void* a1, const void* ab1, const void* a2,
    const void* ab2, const void* a3, const void* ab3, const void* m1,
    const void* mb1, const void* m2, const void* mb2, const void* m3,
    const void* mb3, void* partial, void* out, int T, int D, int C, int du,
    int di, int H1, int H2, int M1, int M2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = (T + kChunk - 1) / kChunk;
  float* part = static_cast<float*>(partial);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (nchunks > 0) {
    const size_t floats = 2 * D * H1 + H1 * H2 + H1 + 2 * H2 +
                          kCands * (H1 + D) + kChunk * (D + 1 + H1) +
                          kCands * kChunk * (H1 + H2 + 1);
    const size_t bytes = floats * sizeof(float);
    cudaError_t err =
        repro_torch::allow_smem(rerank_attention_chunk, bytes, g_smem_opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(nchunks, (C + kCands - 1) / kCands);
    rerank_attention_chunk<<<grid, kThreads, bytes, st>>>(
        f(hist), f(mask), f(tgt), f(a1), f(ab1), f(a2), f(ab2), f(a3),
        f(ab3), part, T, D, C, H1, H2);
    cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return static_cast<int>(launch);
  }
  const size_t mlp_bytes = (2 * D + du + di + M1 + M2) * sizeof(float);
  rerank_score_mlp<<<C, kMlpThreads, mlp_bytes, st>>>(
      part, f(tgt), f(uo), f(io), f(m1), f(mb1), f(m2), f(mb2), f(m3),
      f(mb3), static_cast<float*>(out), nchunks, D, du, di, M1, M2);
  return static_cast<int>(cudaGetLastError());
}
