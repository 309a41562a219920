// Weight-only int8 matmul for Hopper (sm_90a), CUDA C++: K7, the
// projections of int8 serving.
//
// Replaces the TPU kernel k8s_dra_driver_tpu/models/quant.py
// `_int8_matmul_kernel` (:137), launched there by `int8_matmul` (:199,
// a 2-D grid) and `int8_bmm` (:255, with a leading expert dimension).
// One kernel with a batch dimension G serves both entry points (G = 1
// for int8_matmul).
//
// Contract.  out[g, m, n] = (sum_k x[g, m, k] * q[g, k, n]) * scale[g, n]:
//   - x: float32 or bfloat16, any strides in g and m (x_g, x_m, in
//     elements; x_g = 0 shares one x among all experts), unit stride in k;
//   - q: int8 [G, K, N] contiguous; scale: f32 [G, N] contiguous;
//   - out: x's dtype, any strides in g and m (o_g, o_m), unit stride in
//     n, so the MoE products write [rows, experts, n] directly.
// The product sums in f32 and is rounded to x's dtype once, after the
// scale (the fused epilogue of the TPU kernel).  Any M, K, N: every
// edge is masked, nothing is assumed a multiple of a tile.
//
// Design.  A decode step's projections have few rows (M = active slots,
// at most 64 on the routed path) and stream the whole weight: the work
// is bound by the int8 weight's bytes.  The block therefore keeps the
// weight out of shared memory and reads it once, straight into
// registers:
//   - one block of 256 threads per (16-row m tile, 64-column n tile,
//     expert); the m tile is the grid's fastest index, so the tiles of
//     one n tile (M > 16) run together and re-read its weights from L2;
//   - the block walks K in chunks of 256.  It stages the chunk of its x
//     rows in shared memory as f32, then each thread loads 16 k rows of
//     its 4 adjacent columns (one 4-byte load each when N % 4 == 0 and q
//     is 4-byte aligned, bytes otherwise), all 16 loads issued before
//     the first use so they are in flight together, and converts int8 to
//     f32 in registers;
//   - the 16 threads of a k slice cover the tile's 64 columns, 16
//     slices split the chunk's k rows (intra-block split-K); each thread
//     sums its rows x 4 columns in registers, reading x as a broadcast
//     from shared memory, and skips rows past M;
//   - at the end the two slices of a warp add by shuffle, the 8 warps'
//     partial tiles meet in the same shared buffer, and the epilogue
//     sums them, multiplies by the column's scale and stores in x's
//     dtype, coalesced along n.
// Bound at the 154M decode step (M = 8 rows, bf16 x): the weight bytes
// dominate, e.g. the 1024 -> 32000 unembed reads 32.8 MB of int8, about
// 9.8 us at 3.35 TB/s; its 0.5 GFLOP are far below any compute bound.
// What the simple design leaves on the table: narrow N fills few SMs
// (wk/wv, N = 256, launch 4 blocks on 132 SMs: split-K across blocks
// would spread them), the FMA runs on the CUDA cores (W8A16 on wgmma
// would dequantize into bf16 registers), and loads are plain loads, not
// TMA.  That is later speed work.
#include <stdint.h>

#include "common.cuh"

namespace tpu_torch {
namespace {

constexpr int kColThreads = 16;                  // threads across columns
constexpr int kCols = 4;                         // columns per thread
constexpr int kTN = kColThreads * kCols;         // 64 columns per block
constexpr int kSlices = 16;                      // k slices per block
constexpr int kThreads = kColThreads * kSlices;  // 256
constexpr int kWarps = kThreads / 32;            // 8
constexpr int kTM = 16;                          // rows per block
constexpr int kKC = 256;                         // k rows per staged chunk
constexpr int kSteps = kKC / kSlices;            // k rows per thread, chunk

__device__ __forceinline__ float int8_at(uint32_t packed, int c) {
  return static_cast<float>(
      static_cast<int8_t>((packed >> (8 * c)) & 0xffu));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int M, int K, int N, long long x_g, long long x_m,
                       long long o_g, long long o_m) {
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;
  const int rows = min(kTM, M - m0);
  const int ct = threadIdx.x % kColThreads;
  const int sl = threadIdx.x / kColThreads;
  const int n = n0 + ct * kCols;
  const T* xb = x + g * x_g + m0 * x_m;
  const int8_t* qb = q + (size_t)g * K * N;

  // x chunk [kTM][kKC] during the k walk; the warps' partial tiles
  // [kWarps][kTM][kTN] in the epilogue (32 KB)
  __shared__ float smem[kWarps * kTM * kTN];
  float acc[kTM][kCols] = {};

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = min(kKC, K - k0);
    __syncthreads();  // the previous chunk's reads of smem are done
    for (int i = threadIdx.x; i < rows * kKC; i += kThreads) {
      const int r = i / kKC, kk = i % kKC;
      smem[i] = kk < kc ? to_f32(xb[r * x_m + k0 + kk]) : 0.f;
    }
    __syncthreads();
    uint32_t wv[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int kk = sl + s * kSlices;
      uint32_t v = 0;
      if (kk < kc && n < N) {
        const int8_t* p = qb + (size_t)(k0 + kk) * N + n;
        if (kVec) {
          v = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (n + c < N) v |= (uint32_t)(uint8_t)__ldg(p + c) << (8 * c);
        }
      }
      wv[s] = v;
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int kk = sl + s * kSlices;
      float w[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) w[c] = int8_at(wv[s], c);
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        if (r < rows) {
          const float a = smem[r * kKC + kk];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(a, w[c], acc[r][c]);
        }
      }
    }
  }

  __syncthreads();  // every read of the x chunk is done: reuse smem
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
        if (lane < 16) smem[(warp * kTM + r) * kTN + ct * kCols + c] = acc[r][c];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * kTN; i += kThreads) {
    const int r = i / kTN, col = i % kTN, nn = n0 + col;
    if (nn >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += smem[(w * kTM + r) * kTN + col];
    store_from_f32(&out[g * o_g + (m0 + r) * o_m + nn],
                   sum * scale[(size_t)g * N + nn]);
  }
}

template <typename T>
int launch(const void* x, const void* q, const void* scale, void* out, int G,
           int M, int K, int N, long long x_g, long long x_m, long long o_g,
           long long o_m, cudaStream_t st) {
  const dim3 grid((M + kTM - 1) / kTM, (N + kTN - 1) / kTN, G);
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  const bool vec = N % kCols == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  if (vec)
    int8_matmul_kernel<T, true><<<grid, kThreads, 0, st>>>(
        xp, qp, sp, op, M, K, N, x_g, x_m, o_g, o_m);
  else
    int8_matmul_kernel<T, false><<<grid, kThreads, 0, st>>>(
        xp, qp, sp, op, M, K, N, x_g, x_m, o_g, o_m);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_torch

extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* out, int G, int M, int K, int N,
                           long long x_g, long long x_m, long long o_g,
                           long long o_m, int dtype, void* stream) {
  using namespace tpu_torch;
  if (G <= 0 || M <= 0 || K <= 0 || N <= 0 || G > 65535 ||
      (N + kTN - 1) / kTN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, q, scale, out, G, M, K, N, x_g, x_m, o_g, o_m,
                           st);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, q, scale, out, G, M, K, N, x_g, x_m,
                                   o_g, o_m, st);
    default:
      return cudaErrorInvalidValue;
  }
}
