// Grouped matmul on Hopper's tensor cores (sm_90a), bf16 inputs: K5's
// bf16 route, the expert products of the dropless sparse-MoE layer.
//
// Replaces, for bf16, the TPU kernels `_gmm_whole_kernel` (:79) and
// `_gmm_kernel` (:101) of k8s_dra_driver_tpu/ops/gmm.py, launched there
// by `_gmm_impl` (:222), and the backward's dx = dy w^T (`_gmm_bwd`
// :375) through `trans_w`.  The contract is `gmm` in gmm.cu, which
// keeps the f32 route: x [M, K] rows sorted by expert, every group
// padded to block_m = 128 rows, w [E, K, N] (or [E, N, K] with
// trans_w), eb [M / 128] int32 each row block's expert and nu [1] int32
// the live row blocks, both read from device memory;
// out[block i] = x[block i] w[eb[i]] with f32 sums, written in bf16;
// blocks i >= nu write exact zeros and issue no loads or products.
// The JAX kernels round nothing between the products, so neither does
// this one: its plain version is `gmm_reference`.
//
// Bound at the moe_heavy training shape (16,384 routed rows, E = 16,
// d = 512, f = 4096; 18,432 static rows): 6.9e10 flops on the routed
// rows, 70 us of the card's 989 TFLOP/s bf16, against about 71 us for
// its bytes (x and out over the static bound, the experts' weights).
// The design:
//   - One block of two warpgroups (256 threads) per 128 x 128 output
//     tile.  Its 128 rows are one row block, so one expert: eb[i] is
//     read once.  Each warpgroup owns 64 rows and sums them with wgmma
//     m64n128k16, bf16 operands from shared memory, f32 accumulators
//     in registers (64 a thread).
//   - K is walked in steps of 64 through a three-stage cp.async ring:
//     while one stage is multiplied the next two are in flight.  A
//     stage holds the x tile [128 rows][64] (K-major) and the w tile
//     [64 k][128 n], in the 128-byte swizzle wgmma reads.  Plain w
//     ([K, N], N fastest) is MN-major, stored as two [64][64] halves
//     and read through the transpose bit with the halves LBO apart;
//     trans_w's w ([N, K]) is K-major like x.  Both orientations read
//     16 contiguous bytes a thread, so no transposed copy is made.
//   - The block writes its f32 sums as bf16 pairs straight from the
//     accumulator fragments.
//   - Dead-tail blocks store zeros and return before any load.
// Shared memory 97 KB a block, so two blocks an SM.
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace tpu_torch {
namespace {

using bf16 = __nv_bfloat16;
using sm90::kRowBytes;

constexpr int kBM = 128;        // rows per block = block_m
constexpr int kBN = 128;        // output columns per block
constexpr int kBK = 64;         // reduction step
constexpr int kThreads = 256;   // two warpgroups
constexpr int kStages = 3;
constexpr int kXBytes = kBM * kRowBytes;   // x tile, 16 KB
constexpr int kWHalf = kBK * kRowBytes;    // a [64][64] half of w, 8 KB
constexpr int kStageBytes = kXBytes + 2 * kWHalf;
constexpr size_t kSmem = (size_t)kStages * kStageBytes + 1024;

template <bool kTransW>
__global__ void __launch_bounds__(kThreads)
    gmm_sm90_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ eb, const int* __restrict__ nu,
                    bf16* __restrict__ out, int K, int N) {
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  if ((int)blockIdx.y >= nu[0]) {
    // dead tail of the static row bound: zeros, no product
    for (int e = tid; e < kBM * kBN / 8; e += kThreads) {
      const int r = e / (kBN / 8), c = e % (kBN / 8);
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + col0 + c * 8) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const bf16* we = w + (size_t)eb[blockIdx.y] * K * N;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int n_k = K / kBK;

  auto load = [&](int stage, int kt) {
    const uint32_t sX = base + stage * kStageBytes, sW = sX + kXBytes;
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < kBM * 8 / kThreads; ++j) {  // x: 128 rows x 8
      const int e = tid + j * kThreads, r = e / 8, c = e % 8;
      sm90::cp16(sX + sm90::swz(r, c), x + (size_t)(row0 + r) * K + k0 + c * 8,
                 true);
    }
#pragma unroll
    for (int j = 0; j < kBK * kBN / 8 / kThreads; ++j) {
      const int e = tid + j * kThreads;
      if (kTransW) {  // w [N, K]: 128 rows of n, 8 chunks of k
        const int r = e / 8, c = e % 8;
        sm90::cp16(sW + sm90::swz(r, c),
                   we + (size_t)(col0 + r) * K + k0 + c * 8, true);
      } else {        // w [K, N]: 64 rows of k, 16 chunks of n
        const int r = e / 16, c = e % 16;
        sm90::cp16(sW + (c / 8) * kWHalf + sm90::swz(r, c % 8),
                   we + (size_t)(k0 + r) * N + col0 + c * 8, true);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    sm90::cp_commit();
  }

  const int wg = tid / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    sm90::cp_wait<kStages - 2>();  // this thread's copies of step kt
    sm90::fence_async_smem();
    __syncthreads();  // everyone's copies; step kt - 1's products done
    const uint32_t sX = base + (kt % kStages) * kStageBytes,
                   sW = sX + kXBytes;
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = sm90::desc(sX + wg * 64 * kRowBytes + kk * 32);
      if (kTransW)
        sm90::mma_ss_n128<0>(acc, da, sm90::desc(sW + kk * 32), 1);
      else
        sm90::mma_ss_n128<1>(
            acc, da, sm90::desc_lbo(sW + kk * 16 * kRowBytes, kWHalf), 1);
    }
    sm90::wg_commit();
    // refill the stage step kt - 1 read, while step kt multiplies
    if (kt + kStages - 1 < n_k)
      load((kt + kStages - 1) % kStages, kt + kStages - 1);
    sm90::cp_commit();
    sm90::wg_wait<0>();
    sm90::reg_fence(acc);
  }

  // acc[4 n + 2 h + c]: row 64 wg + 16 warp + lane / 4 + 8 h, column
  // 8 n + 2 (lane % 4) + c
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r = row0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = col0 + 8 * n + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8 * h) * N + col) =
          sm90::pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  }
}

template <bool kTransW>
cudaError_t launch(const void* x, const void* w, const int* eb,
                   const int* nu, void* out, int M, int K, int N,
                   cudaStream_t st) {
  // above 48 KB of dynamic shared memory; the attribute belongs to the
  // current device, so it is set on every launch (a host-side call)
  cudaError_t err = cudaFuncSetAttribute(
      gmm_sm90_kernel<kTransW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kBN, M / kBM);
  gmm_sm90_kernel<kTransW><<<grid, kThreads, kSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), eb, nu,
      static_cast<bf16*>(out), K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_torch

// gmm's contract (gmm.cu) for bfloat16 only, with block_m 128, K a
// multiple of 64, N of 128, and x, w and out 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int gmm_tc(const void* x, const void* w, const void* eb,
                      const void* nu, void* out, int M, int K, int N, int E,
                      int block_m, int trans_w, int dtype, void* stream) {
  using namespace tpu_torch;
  if (dtype != kBFloat16 || M <= 0 || K <= 0 || N <= 0 || E <= 0 ||
      block_m != kBM || M % kBM || K % kBK || N % kBN || M / kBM > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) &
      15)
    return cudaErrorMisalignedAddress;
  const int* e = static_cast<const int*>(eb);
  const int* u = static_cast<const int*>(nu);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return trans_w ? launch<true>(x, w, e, u, out, M, K, N, st)
                 : launch<false>(x, w, e, u, out, M, K, N, st);
}
