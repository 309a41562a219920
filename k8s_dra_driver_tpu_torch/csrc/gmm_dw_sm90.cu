// Grouped-matmul dw on Hopper's tensor cores (sm_90a), bf16 inputs:
// K6's bf16 route, the expert gradients of the dropless sparse-MoE
// layer.
//
// Replaces, for bf16, the TPU kernel `_gmm_dw_kernel` (:126) of
// k8s_dra_driver_tpu/ops/gmm.py, launched there by `_gmm_dw` (:303).
// The contract is `gmm_dw` in gmm.cu, which keeps the f32 route: x
// [M, K] and dy [M, N] rows sorted by expert, every group padded to
// block_m = 128 rows, gs [E] int32 the padded group sizes and nu [1]
// int32 the live row blocks, both read from device memory;
// dw[e] = sum over expert e's live rows r of x[r]^T dy[r] with f32
// sums, written in f32 or (for the backward, which casts to w's
// dtype) rounded once to bf16; an expert without live rows writes
// exact zeros and loads nothing.  bf16 products are exact in f32, so
// only the order of the f32 sums differs from `gmm_dw_reference`.
//
// Bound at the moe_heavy training shape (16,384 routed rows in an
// 18,432-row bound, E = 16, d = 512, f = 4096): 6.9e10 flops, 70 us of
// the card's 989 TFLOP/s bf16, against 88 us for its bytes (the live
// rows of x and dy, the f32 dw): bound by bytes, near the flops.
// The design:
//   - One block of two warpgroups (256 threads) per output tile
//     (expert e, 128 columns of K, 128 columns of N).  The block owns
//     its tile: no atomics, a fixed summation order, a bitwise
//     deterministic result.
//   - The block walks e's live rows, from the group offset (a prefix
//     sum of gs) to min(offset + gs[e], nu * block_m, M), 64 rows a
//     step, through a three-stage cp.async ring of 16-byte copies into the
//     128-byte swizzle: while one stage is multiplied the next two are
//     in flight.  Group offsets and the live end are multiples of 128,
//     so every step is whole.
//   - The contraction runs over rows, so both operands are MN-major
//     and go through the transpose bits: A = x^T, each warpgroup's 64
//     K-columns of the [64 rows][128 K-cols] x stage (a [16][64]
//     MN-major atom column per k16 step); B = dy, the [64 rows][128
//     N-cols] dy stage as two [64][64] halves LBO apart, read exactly
//     as gmm_sm90.cu reads plain w.  Each warpgroup sums its 64 x 128
//     sub-tile with wgmma m64n128k16, f32 accumulators in registers
//     (64 a thread).
//   - The block writes its f32 sums (or bf16 pairs) straight from the
//     accumulator fragments.
// Shared memory 97 KB a block, so two blocks an SM.
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace tpu_torch {
namespace {

using bf16 = __nv_bfloat16;
using sm90::kRowBytes;

constexpr int kBM = 128;       // block_m: group offsets are multiples
constexpr int kTK = 128;       // K columns of dw per block
constexpr int kTN = 128;       // N columns of dw per block
constexpr int kStep = 64;      // rows per step
constexpr int kThreads = 256;  // two warpgroups
constexpr int kStages = 3;
constexpr int kHalf = kStep * kRowBytes;      // a [64][64] half, 8 KB
constexpr int kTileBytes = 2 * kHalf;         // [64 rows][128 cols]
constexpr int kStageBytes = 2 * kTileBytes;   // x and dy, 32 KB
constexpr size_t kSmem = (size_t)kStages * kStageBytes + 1024;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = sm90::pack_bf16(a, b);
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
    gmm_dw_sm90_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                       const int* __restrict__ gs, const int* __restrict__ nu,
                       TOut* __restrict__ dw, int M, int K, int N) {
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * kTK;
  const int n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;
  long long start = 0;
  for (int i = 0; i < e; ++i) start += gs[i];
  long long end = start + gs[e];
  const long long live_end = (long long)nu[0] * kBM;
  if (end > live_end) end = live_end;
  if (end > M) end = M;
  const int n_st = end > start ? (int)((end - start) / kStep) : 0;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;

  // stage s holds rows [start + 64 st, +64) of x (K-cols k0..k0+127)
  // and of dy (N-cols n0..n0+127), each as two [64 rows][64] halves
  auto load = [&](int stage, int st) {
    const uint32_t sX = base + stage * kStageBytes, sD = sX + kTileBytes;
    const long long r0 = start + (long long)st * kStep;
#pragma unroll
    for (int j = 0; j < kStep * 16 / kThreads; ++j) {
      const int c = tid + j * kThreads, r = c / 16, ch = c % 16;
      const uint32_t off = (ch / 8) * kHalf + sm90::swz(r, ch % 8);
      sm90::cp16(sX + off, x + (size_t)(r0 + r) * K + k0 + ch * 8, true);
      sm90::cp16(sD + off, dy + (size_t)(r0 + r) * N + n0 + ch * 8, true);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) load(s, s);
    sm90::cp_commit();
  }

  const int wg = tid / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int st = 0; st < n_st; ++st) {
    sm90::cp_wait<kStages - 2>();  // this thread's copies of step st
    sm90::fence_async_smem();
    __syncthreads();  // everyone's copies; step st - 1's products done
    const uint32_t sX = base + (st % kStages) * kStageBytes,
                   sD = sX + kTileBytes;
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      // 16 rows a k16 step: 2 KB down both MN-major tiles
      const uint64_t da = sm90::desc(sX + wg * kHalf + kk * 16 * kRowBytes);
      const uint64_t db = sm90::desc_lbo(sD + kk * 16 * kRowBytes, kHalf);
      sm90::mma_ss_n128<1, 1>(acc, da, db, 1);
    }
    sm90::wg_commit();
    // refill the stage step st - 1 read, while step st multiplies
    if (st + kStages - 1 < n_st)
      load((st + kStages - 1) % kStages, st + kStages - 1);
    sm90::cp_commit();
    sm90::wg_wait<0>();
    sm90::reg_fence(acc);
  }

  // acc[4 n + 2 h + c]: K-row 64 wg + 16 warp + lane / 4 + 8 h, N-column
  // 8 n + 2 (lane % 4) + c of the tile
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int k = k0 + wg * 64 + warp * 16 + lane / 4;
  TOut* out = dw + (size_t)e * K * N;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = n0 + 8 * n + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(out + (size_t)(k + 8 * h) * N + col, acc[4 * n + 2 * h],
             acc[4 * n + 2 * h + 1]);
  }
}

template <typename TOut>
cudaError_t launch(const void* x, const void* dy, const int* gs,
                   const int* nu, void* dw, int M, int K, int N, int E,
                   cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gmm_dw_sm90_kernel<TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kTN, K / kTK, E);
  gmm_dw_sm90_kernel<TOut><<<grid, kThreads, kSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), gs, nu,
      static_cast<TOut*>(dw), M, K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_torch

// gmm_dw's contract (gmm.cu) for bfloat16 x and dy only, with block_m
// 128 and K and N multiples of 128, x, dy and dw 16-byte aligned; dw
// in float32 or bfloat16 (out_dtype).  Returns cudaGetLastError().
extern "C" int gmm_dw_tc(const void* x, const void* dy, const void* gs,
                         const void* nu, void* dw, int M, int K, int N,
                         int E, int block_m, int dtype, int out_dtype,
                         void* stream) {
  using namespace tpu_torch;
  if (dtype != kBFloat16 || M <= 0 || K <= 0 || N <= 0 || E <= 0 ||
      E > 65535 || block_m != kBM || M % kBM || K % kTK || N % kTN ||
      K / kTK > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dw)) &
      15)
    return cudaErrorMisalignedAddress;
  const int* g = static_cast<const int*>(gs);
  const int* u = static_cast<const int*>(nu);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case kFloat32:
      return launch<float>(x, dy, g, u, dw, M, K, N, E, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, dy, g, u, dw, M, K, N, E, st);
    default:
      return cudaErrorInvalidValue;
  }
}
