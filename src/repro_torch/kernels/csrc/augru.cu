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
//   * augru_input_proj: gx for all B*T rows on the tensor cores,
//     mma.sync m16n8k8 in TF32 with the 3xTF32 split (a = a_hi + a_lo,
//     a_hi cut to TF32 and a_lo the exact remainder, which the mma reads
//     cut to TF32 in turn; a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, the
//     small terms first), which keeps ~22 significant bits: float32
//     accuracy at these depths (TF32 alone keeps ~11 and is not used).
//     64 x 64 output tiles, 4 warps of 32 x 32, 16-deep slices of x and W
//     in a 4-stage cp.async ring (strides padded so the fragment loads are
//     conflict-free), the tile written out through shared memory as
//     16-byte row pieces. Rows of gx are padded to whole float4s (NP = 3H
//     rounded up to 4) for the recurrence's 16-byte copies; the wrapper
//     owns the (B*T, NP) scratch.
//   * augru_recurrence: one block per batch row walks the T steps with U
//     in registers for the whole sequence: 4 threads per hidden unit j,
//     thread p holding U's rows [28p, 28p + 28) of j's three gate columns
//     (84 floats), so H <= kMaxH = 112 and a block runs 4 H threads (448
//     at H = 108). A step is, per thread, 7 broadcast float4 loads of h and
//     84 FMAs into 6 independent accumulators, a 2-step shuffle reduction
//     across the unit's 4 lanes, and the gate update on lane p = 0, which
//     writes its h into the other of two h buffers: one barrier a step.
//     gx and att arrive in chunks of kSteps steps by cp.async into a
//     shared-memory ring of two, the next chunk copied while the current
//     one is used.
//
// What a step costs on the card (PERF.md section 6): the 84 FMAs of 14
// warps, then the gate update's expf, division and tanhf, a serial chain;
// neither overlaps the other, since every FMA of step t + 1 needs all of
// h_t. A row spread over a cluster of SMs would cut the FMA share, but a
// cluster barrier costs more cycles than the whole FMA phase. U in registers
// replaces the first design's U in shared memory, whose every step read
// all of U, 140 KB, from there. Full float32 in the recurrence: expf /
// tanhf, no fast intrinsics.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using repro_torch::cp_async16;
using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::smem_addr;

constexpr int kTile = 64;           // output tile of the input projection
constexpr int kDepth = 16;          // depth slice of the input projection
constexpr int kProjThreads = 128;   // 4 warps of 32 x 32 outputs
constexpr int kStages = 4;          // depth slices in flight per block
constexpr int kAStride = kDepth + 4;   // x slice row stride (conflict-free)
constexpr int kBStride = kTile + 8;    // W slice row stride (conflict-free)
constexpr int kCStride = kTile + 8;    // output tile row stride (conflict-free)
static_assert(kTile * kCStride <= kStages * kTile * kAStride,
              "the output tile fits the x ring");

constexpr int kParts = 4;           // threads per hidden unit
constexpr int kSeg = 28;            // rows of U per thread (a multiple of 4)
constexpr int kMaxH = 112;          // largest H a block holds
static_assert(kMaxH == kParts * kSeg, "U's rows split over the parts");
constexpr int kRecThreads = kParts * kMaxH;  // 448
constexpr int kSteps = 16;          // steps of gx per shared-memory chunk

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// v = hi + lo: hi is v cut to TF32 (its top 11 significant bits), lo the
// exact remainder, which the tensor core reads cut to TF32 in turn (the
// mma ignores an operand's low 13 bits): hi*b + lo*b carries ~22 bits
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// gx (M, NP) = x (M, K) @ w (K, N) + bias (N); columns N..NP-1 get zeros
__global__ void __launch_bounds__(kProjThreads)
augru_input_proj(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ gx,
                 int M, int K, int N, int NP) {
  // a ring of (x slice, W slice) stages: cp.async keeps kStages - 1 slices
  // in flight while one is multiplied
  __shared__ __align__(16) float as_ring[kStages][kTile * kAStride];
  __shared__ __align__(16) float bs_ring[kStages][kDepth * kBStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;          // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  // one flat grid, columns fastest (a row tile's blocks run together):
  // B * T rows past 65,535 tiles launch too
  const int ncol = (N + kTile - 1) / kTile;
  const int row0 = static_cast<int>(blockIdx.x / ncol) * kTile;
  const int col0 = static_cast<int>(blockIdx.x % ncol) * kTile;
  auto copy_slice = [&](int k0, int stage) {      // zero-filled past M, K, N
    for (int i = tid; i < kTile * kDepth; i += kProjThreads) {
      const int r = i / kDepth, kk = i - r * kDepth;     // x: row-major
      const int gr = row0 + r, gk = k0 + kk;
      const bool xok = gr < M && gk < K;
      cp_async4(smem_addr(&as_ring[stage][r * kAStride + kk]),
                x + (xok ? static_cast<size_t>(gr) * K + gk : 0), xok ? 4 : 0);
      const int wk = i / kTile, c = i - wk * kTile;      // w: row-major
      const int gwk = k0 + wk, gc = col0 + c;
      const bool wok = gwk < K && gc < N;
      cp_async4(smem_addr(&bs_ring[stage][wk * kBStride + c]),
                w + (wok ? static_cast<size_t>(gwk) * N + gc : 0), wok ? 4 : 0);
    }
  };
  float acc[2][4][4] = {};
  const int slices = (K + kDepth - 1) / kDepth;
  // one commit group per slice (empty past the last), so that waiting for
  // all but kStages - 1 groups waits for slice sl
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < slices) copy_slice(sl * kDepth, sl);
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    const int next = sl + kStages - 1;
    if (next < slices) copy_slice(next * kDepth, next % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* as = as_ring[sl % kStages];
    const float* bs = bs_ring[sl % kStages];
#pragma unroll
    for (int ks = 0; ks < kDepth; ks += 8) {
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a = as + (wm + mt * 16 + g) * kAStride + ks + q;
        split_tf32(a[0], ahi[mt][0], alo[mt][0]);
        split_tf32(a[8 * kAStride], ahi[mt][1], alo[mt][1]);
        split_tf32(a[4], ahi[mt][2], alo[mt][2]);
        split_tf32(a[8 * kAStride + 4], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* b = bs + (ks + q) * kBStride + wn + nt * 8 + g;
        split_tf32(b[0], bhi[nt][0], blo[nt][0]);
        split_tf32(b[4 * kBStride], bhi[nt][1], blo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc[mt][nt], alo[mt], bhi[nt]);
          mma_tf32(acc[mt][nt], ahi[mt], blo[nt]);
          mma_tf32(acc[mt][nt], ahi[mt], bhi[nt]);
        }
    }
    __syncthreads();                  // the stage is refilled next round
  }
  // the tile goes out through shared memory (the ring is free now) as whole
  // 16-byte rows segments: a warp writes two 256-byte row pieces per store
  float* cs = &as_ring[0][0];                     // kTile x kCStride
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + mt * 16 + g + 8 * half, c = wn + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(cs + r * kCStride + c) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
  __syncthreads();
  const int c4 = (tid & (kTile / 4 - 1)) * 4, gc = col0 + c4;
  float4 b4;
  b4.x = gc < N ? bias[gc] : 0.0f;
  b4.y = gc + 1 < N ? bias[gc + 1] : 0.0f;
  b4.z = gc + 2 < N ? bias[gc + 2] : 0.0f;
  b4.w = gc + 3 < N ? bias[gc + 3] : 0.0f;
  if (gc < NP) {
    for (int r = tid / (kTile / 4); r < kTile; r += kProjThreads / (kTile / 4)) {
      const int gr = row0 + r;
      if (gr >= M) break;
      const float4 v = *reinterpret_cast<const float4*>(cs + r * kCStride + c4);
      *reinterpret_cast<float4*>(gx + static_cast<size_t>(gr) * NP + gc) =
          make_float4(v.x + b4.x, v.y + b4.y, v.z + b4.z, v.w + b4.w);
    }
  }
}

// One block per batch row, 4 * round_up(H, 8) threads; gx rows NP apart.
__global__ void __launch_bounds__(kRecThreads, 1)
augru_recurrence(const float* __restrict__ gx, const float* __restrict__ att,
                 const float* __restrict__ u, float* __restrict__ out, int T,
                 int H, int NP) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                       // 2 x kSteps x NP   gx chunks
  float* hb = ring + 2 * kSteps * NP;       // 2 x kMaxH         h, zero padded
  float* ats = hb + 2 * kMaxH;              // 2 x kSteps        att chunks
  const int tid = threadIdx.x, j = tid >> 2, p = tid & 3;
  const int b = blockIdx.x, N = 3 * H;
  const bool unit = j < H, lead = unit && p == 0;

  // this thread's rows of j's three gate columns, for the whole sequence
  float uw[3][kSeg];
#pragma unroll
  for (int i = 0; i < kSeg; ++i) {
    const int k = p * kSeg + i;
    const bool ok = unit && k < H;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
      uw[gate][i] = ok ? u[static_cast<size_t>(k) * N + gate * H + j] : 0.0f;
  }
  for (int i = tid; i < 2 * kMaxH; i += blockDim.x) hb[i] = 0.0f;

  const float* gxb = gx + static_cast<size_t>(b) * T * NP;
  const float* atb = att + static_cast<size_t>(b) * T;
  const int nchunks = (T + kSteps - 1) / kSteps;
  auto copy_chunk = [&](int c) {            // steps [c kSteps, ...) -> ring
    const int t0 = c * kSteps, vecs = min(kSteps, T - t0) * NP / 4;
    const float* src = gxb + static_cast<size_t>(t0) * NP;
    float* dst = ring + (c & 1) * kSteps * NP;
    for (int i = tid; i < vecs; i += blockDim.x)
      cp_async16(smem_addr(dst + 4 * i), src + 4 * i, 16);
    for (int i = tid; i < min(kSteps, T - t0); i += blockDim.x)
      cp_async4(smem_addr(ats + (c & 1) * kSteps + i), atb + t0 + i, 4);
    cp_async_commit();
  };
  if (nchunks > 0) copy_chunk(0);

  float h_own = 0.0f;                       // h[j] on the lead lane
  for (int c = 0; c < nchunks; ++c) {
    // the buffer refilled here was last read before the previous barrier
    if (c + 1 < nchunks) {
      copy_chunk(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* chunk = ring + (c & 1) * kSteps * NP;
    const float* at_chunk = ats + (c & 1) * kSteps;
    const int t0 = c * kSteps, steps = min(kSteps, T - t0);
    for (int s = 0; s < steps; ++s) {
      const int t = t0 + s;
      float g_r = 0.0f, g_z = 0.0f, g_n = 0.0f, a_t = 0.0f;
      if (lead) {                           // off the chain: issued first
        const float* gs = chunk + s * NP;
        g_r = gs[j];
        g_z = gs[H + j];
        g_n = gs[2 * H + j];
        a_t = at_chunk[s];
      }
      const float4* h4 =
          reinterpret_cast<const float4*>(hb + (t & 1) * kMaxH) + p * (kSeg / 4);
      float acc[3][2] = {};
#pragma unroll
      for (int i4 = 0; i4 < kSeg / 4; ++i4) {
        const float4 hv = h4[i4];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          acc[gate][0] = fmaf(hv.x, uw[gate][4 * i4], acc[gate][0]);
          acc[gate][1] = fmaf(hv.y, uw[gate][4 * i4 + 1], acc[gate][1]);
          acc[gate][0] = fmaf(hv.z, uw[gate][4 * i4 + 2], acc[gate][0]);
          acc[gate][1] = fmaf(hv.w, uw[gate][4 * i4 + 3], acc[gate][1]);
        }
      }
      float gh[3];
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        float v = acc[gate][0] + acc[gate][1];
        v += __shfl_xor_sync(repro_torch::kFullMask, v, 1);
        v += __shfl_xor_sync(repro_torch::kFullMask, v, 2);
        gh[gate] = v;
      }
      if (lead) {
        const float r = sigmoid(g_r + gh[0]);
        const float z = sigmoid(g_z + gh[1]) * a_t;
        const float n = tanhf(g_n + r * gh[2]);
        h_own = (1.0f - z) * h_own + z * n;
        hb[((t + 1) & 1) * kMaxH + j] = h_own;
      }
      __syncthreads();
    }
  }
  if (lead) out[static_cast<size_t>(b) * H + j] = h_own;
}

}  // namespace

// gx: scratch of B * T * NP floats, NP = 3H rounded up to a multiple of 4;
// H <= kMaxH. Returns the first CUDA error.
extern "C" int augru_f32(const void* x, const void* att, const void* w,
                         const void* u, const void* bias, void* gx, void* out,
                         int B, int T, int Din, int H, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H < 1 || H > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
  const int N = 3 * H, NP = (N + 3) & ~3, M = B * T;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* g = static_cast<float*>(gx);
  if (M > 0) {
    const unsigned grid = static_cast<unsigned>((N + kTile - 1) / kTile) *
                          static_cast<unsigned>((M + kTile - 1) / kTile);
    augru_input_proj<<<grid, kProjThreads, 0, st>>>(f(x), f(w), f(bias), g,
                                                    M, Din, N, NP);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = kParts * ((H + 7) & ~7);
  const size_t bytes = (2 * kSteps * NP + 2 * kMaxH + 2 * kSteps) * sizeof(float);
  augru_recurrence<<<B, threads, bytes, st>>>(g, f(att), f(u),
                                              static_cast<float*>(out), T, H,
                                              NP);
  return static_cast<int>(cudaGetLastError());
}
