// DIN local activation unit, one target per row.
//
// Replaces src/repro/kernels/din_attention/kernel.py::din_attention_pallas.
//
//   feat[t] = [h_t, tgt, h_t - tgt, h_t * tgt]               (4D)
//   w_t     = (silu(silu(feat[t] @ W1 + b1) @ W2 + b2) @ w3 + b3) * mask_t
//   out     = sum_t w_t * h_t                                 (D)
//
// The feature block is never built. With W1 split into its row blocks
// (Wa | Wb | Wc | Wd) in the concat order above,
//   feat @ W1 = h @ (Wa + Wc) + tgt @ (Wb - Wc) + (h * tgt) @ Wd,
// and the middle term is one vector per row, folded into the bias.
//
// Bound on the H100: neither bytes nor flops at serving shapes, but
// latency and shared-memory traffic. The inputs are small (a row's history
// is T*D floats, the weights a few tens of KB) and the work a few MFLOP
// per row, far below both roofs. So the history is split into chunks of
// kChunk steps and every (row, chunk) pair is a block of its own (64
// blocks at B=16, T=100, rather than one per row): each block computes
// each layer for every (step, unit) pair of its chunk at once over 512
// threads, every thread owning whole dot products (two accumulators
// each), the weights in shared memory (reads conflict-free across a warp),
// no hidden vector leaving the chip; a warp per step reduces the last
// layer, and the block writes its chunk's partial pooled vector. A second
// kernel sums the partials of each row in chunk order, so the result does
// not depend on block scheduling.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 32;     // history steps per block
size_t g_smem_opted[repro_torch::kMaxDevices] = {};

__global__ void __launch_bounds__(kThreads)
din_attention_chunk(const float* __restrict__ hist,
                    const float* __restrict__ mask,
                    const float* __restrict__ tgt,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    float* __restrict__ partial, int T, int D, int H1,
                    int H2) {
  extern __shared__ float smem[];
  float* wac = smem;                  // D*H1   Wa + Wc
  float* wd = wac + D * H1;           // D*H1   Wd
  float* w2s = wd + D * H1;           // H1*H2
  float* bias1 = w2s + H1 * H2;       // H1     b1 + tgt @ (Wb - Wc)
  float* b2s = bias1 + H1;            // H2
  float* w3s = b2s + H2;              // H2
  float* tg = w3s + H2;               // D
  float* hs = tg + D;                 // kChunk*D   the chunk's history steps
  float* ht = hs + kChunk * D;        // kChunk*D   h * tgt
  float* h1 = ht + kChunk * D;        // kChunk*H1  first hidden
  float* g = h1 + kChunk * H1;        // kChunk*H2  silu(second hidden) * w3
  float* wt = g + kChunk * H2;        // kChunk     masked activation weights

  const int chunk = blockIdx.x, nchunks = gridDim.x, b = blockIdx.y;
  const int t0 = chunk * kChunk, n = min(kChunk, T - t0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const float* hrow = hist + (static_cast<size_t>(b) * T + t0) * D;
  const float* mrow = mask + static_cast<size_t>(b) * T + t0;

  for (int i = tid; i < D; i += nthreads)
    tg[i] = tgt[static_cast<size_t>(b) * D + i];
  for (int i = tid; i < D * H1; i += nthreads) {
    wac[i] = w1[i] + w1[2 * D * H1 + i];
    wd[i] = w1[3 * D * H1 + i];
  }
  for (int i = tid; i < H1 * H2; i += nthreads) w2s[i] = w2[i];
  for (int i = tid; i < H2; i += nthreads) {
    b2s[i] = b2[i];
    w3s[i] = w3[i];
  }
  __syncthreads();
  for (int j = tid; j < H1; j += nthreads) {
    float a = b1[j];
    for (int d = 0; d < D; ++d)
      a = fmaf(tg[d], w1[(D + d) * H1 + j] - w1[(2 * D + d) * H1 + j], a);
    bias1[j] = a;
  }
  for (int i = tid; i < n * D; i += nthreads) {
    const float h = hrow[i];
    hs[i] = h;
    ht[i] = h * tg[i % D];
  }
  __syncthreads();
  // first layer, every (step, unit) of the chunk
  for (int i = tid; i < n * H1; i += nthreads) {
    const int s = i / H1, j = i - s * H1;
    const float* h = hs + s * D;
    const float* q = ht + s * D;
    float a0 = bias1[j], a1 = 0.0f;
#pragma unroll 6
    for (int d = 0; d < D; ++d) {
      a0 = fmaf(h[d], wac[d * H1 + j], a0);
      a1 = fmaf(q[d], wd[d * H1 + j], a1);
    }
    h1[i] = repro_torch::silu(a0 + a1);
  }
  __syncthreads();
  // second layer, times the output layer's weights
  for (int i = tid; i < n * H2; i += nthreads) {
    const int s = i / H2, k = i - s * H2;
    const float* x = h1 + s * H1;
    float a0 = b2s[k], a1 = 0.0f;
    int j = 0;
#pragma unroll 4
    for (; j + 1 < H1; j += 2) {
      a0 = fmaf(x[j], w2s[j * H2 + k], a0);
      a1 = fmaf(x[j + 1], w2s[(j + 1) * H2 + k], a1);
    }
    if (j < H1) a0 = fmaf(x[j], w2s[j * H2 + k], a0);
    g[i] = repro_torch::silu(a0 + a1) * w3s[k];
  }
  __syncthreads();
  // output layer: one warp per step
  const float bias3 = b3[0];
  for (int s = warp; s < n; s += nwarps) {
    float p = 0.0f;
    for (int k = lane; k < H2; k += 32) p += g[s * H2 + k];
    p = repro_torch::warp_sum(p);
    if (lane == 0) wt[s] = (p + bias3) * mrow[s];
  }
  __syncthreads();
  float* prow = partial + (static_cast<size_t>(b) * nchunks + chunk) * D;
  for (int d = tid; d < D; d += nthreads) {
    float a = 0.0f;
    for (int s = 0; s < n; ++s) a = fmaf(wt[s], hs[s * D + d], a);
    prow[d] = a;
  }
}

// out[b, d] = sum over chunks, in chunk order, of partial[b, chunk, d]
__global__ void din_attention_sum(const float* __restrict__ partial,
                                  float* __restrict__ out, int B, int nchunks,
                                  int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * D) return;
  const int b = i / D, d = i - b * D;
  const float* p = partial + static_cast<size_t>(b) * nchunks * D + d;
  float a = 0.0f;
  for (int c = 0; c < nchunks; ++c) a += p[static_cast<size_t>(c) * D];
  out[i] = a;
}

}  // namespace

// partial: scratch of B * ceil(T / kChunk) * D floats
extern "C" int din_attention_f32(const void* hist, const void* mask,
                                 const void* tgt, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, const void* w3,
                                 const void* b3, void* partial, void* out,
                                 int B, int T, int D, int H1, int H2,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = (T + kChunk - 1) / kChunk;
  float* part = static_cast<float*>(partial);
  if (nchunks > 0) {
    const size_t floats = 2 * D * H1 + H1 * H2 + H1 + 2 * H2 + D +
                          kChunk * (2 * D + H1 + H2 + 1);
    const size_t bytes = floats * sizeof(float);
    cudaError_t err =
        repro_torch::allow_smem(din_attention_chunk, bytes, g_smem_opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    din_attention_chunk<<<dim3(nchunks, B), kThreads, bytes, st>>>(
        static_cast<const float*>(hist), static_cast<const float*>(mask),
        static_cast<const float*>(tgt), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(w3),
        static_cast<const float*>(b3), part, T, D, H1, H2);
    cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return static_cast<int>(launch);
  }
  const int threads = 256;
  din_attention_sum<<<(B * D + threads - 1) / threads, threads, 0, st>>>(
      part, static_cast<float*>(out), B, nchunks, D);
  return static_cast<int>(cudaGetLastError());
}
