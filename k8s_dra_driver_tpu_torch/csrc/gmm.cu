// Grouped matmul for Hopper (sm_90a), CUDA C++: K5 (gmm) and K6 (gmm dw),
// the expert products of the dropless sparse-MoE layer.  Both here are
// the f32 route on the CUDA cores (bf16 takes gmm_sm90.cu and
// gmm_dw_sm90.cu).
//
// Replaces the TPU kernels of k8s_dra_driver_tpu/ops/gmm.py:
//   - `gmm_kernel` (K5) replaces both `_gmm_whole_kernel` (:79) and
//     `_gmm_kernel` (:101), launched there by `_gmm_impl` (:222).  The
//     whole/blocked split (`_whole_mode`) chose how much of an expert
//     stays in VMEM; what is computed is the same, so one kernel
//     serves both.  It also serves the backward's dx = dy w^T (`_gmm_bwd`
//     :375) through `trans_w`, which reads w as [E, N, K] in place of
//     the JAX package's swapaxes copy.
//   - `gmm_dw_kernel` (K6) replaces `_gmm_dw_kernel` (:126), launched
//     by `_gmm_dw` (:303).
//
// Contract.  x [M, K] rows sorted by expert, every group padded to a
// block_m multiple (block_m a multiple of 64), w [E, K, N] (or
// [E, N, K] with trans_w), one dtype: float32.
// Indices come from device memory, as the Pallas scalar prefetch
// brought them:
// eb [M / block_m] int32 is each row block's expert, nu [1] int32 the
// number of live blocks (sum of group sizes / block_m).
//   K5: out[rows of block i] = x[block i] w[eb[i]], f32 sums, out in
//       x's dtype; blocks i >= nu write zeros and do no product.
//   K6: dw[e] = sum over expert e's live rows r of x[r]^T dy[r], f32,
//       from gs [E] int32 (the padded group sizes); an expert without
//       rows writes exact zeros itself.
//
// Design.  On the TPU the grid ran in order on one core: K6 carried
// each expert's sum in VMEM across its consecutive row blocks and
// reset it at expert boundaries.  Here blocks run in parallel, so:
//   - K5: one block of 256 threads per 64 x 64 output tile.  The tile's
//     64 rows lie in one row block, so one expert; the block walks K in
//     steps of 32, staging a 64 x 32 tile of x and a 32 x 64 tile of
//     w[e] in shared memory as f32, and each thread sums a 4 x 4 set of
//     outputs in registers (rows ty + 16 i, columns tx + 16 j, so a
//     warp's shared reads are broadcast or consecutive).  The
//     transposed read loads w with k fastest, so global reads stay
//     coalesced in both orientations.
//   - K6: one block per (expert, 64-wide k tile, 64-wide n tile).  The
//     block walks its expert's contiguous rows, from the group offset
//     (a prefix sum of gs) to min(offset + gs[e], nu * block_m, M), 32
//     rows at a time: no atomics, and a fixed summation order, so dw is
//     deterministic.  An expert with no live rows skips the loop and
//     stores its zero accumulators: the output is never left unwritten
//     (the JAX wrapper patches that case with a select after its
//     kernel).
// Every product runs in f32 FMA on the CUDA cores.
//
// Bound at the moe_heavy training shape (16,384 routed rows, E = 16,
// d = 512, f = 4096, bf16; the static row bound is 18,432):
//   - K5 does 2 * 16384 * 512 * 4096 = 6.9e10 flops on the routed
//     rows, about 70 us at 989 TFLOP/s bf16, and moves about 237 MB (x
//     and out over the static bound, the 16 experts' weights), about
//     71 us at 3.35 TB/s: both near 70 us on the H100.
//   - K6 does the same flops and moves x, dy and the f32 dw (about
//     304 MB): about 91 us, bound by bytes.
// What the simple design leaves on the table: it never uses the tensor
// cores (wgmma) and stages tiles through registers instead of TMA, so
// the CUDA cores' f32 rate (67 TFLOP/s) is its ceiling; K5 re-reads an
// expert's weights once per 64-row tile; K6 gives a hot expert's whole
// row range to one column of blocks (split-M with a second reduction
// pass would spread it).  That is later speed work.
#include <stdint.h>

#include "common.cuh"

namespace tpu_torch {
namespace {

constexpr int kTM = 64;        // output tile rows (K5) / k tile (K6)
constexpr int kTN = 64;        // output tile columns
constexpr int kTK = 32;        // reduction step staged in shared memory
constexpr int kSide = 16;      // threads per tile side
constexpr int kThreads = kSide * kSide;  // 256, each owning 4 x 4 sums
constexpr int kPer = kTM / kSide;        // 4

template <typename T, bool kTransW>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ eb, const int* __restrict__ nu,
               T* __restrict__ out, int K, int N, int block_m) {
  const int row0 = blockIdx.y * kTM;
  const int col0 = blockIdx.x * kTN;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int blk = row0 / block_m;
  if (blk >= nu[0]) {
    // dead tail of the static row bound: zeros, no product
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int n = col0 + tx + kSide * j;
        if (n < N)
          store_from_f32(&out[(size_t)(row0 + ty + kSide * i) * N + n],
                         0.f);
      }
    return;
  }
  const T* we = w + (size_t)eb[blk] * K * N;
  __shared__ float xs[kTK][kTM + 1];  // [k][row], padded against conflicts
  __shared__ float ws[kTK][kTN + 1];  // [k][col]
  float acc[kPer][kPer] = {};
  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int i = threadIdx.x; i < kTM * kTK; i += kThreads) {
      const int r = i / kTK, kk = i % kTK, k = k0 + kk;
      xs[kk][r] = k < K ? to_f32(x[(size_t)(row0 + r) * K + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < kTK * kTN; i += kThreads) {
      int kk, c;
      if (kTransW) {  // [N, K] in memory: k fastest
        c = i / kTK;
        kk = i % kTK;
      } else {        // [K, N]: n fastest
        kk = i / kTN;
        c = i % kTN;
      }
      const int k = k0 + kk, n = col0 + c;
      float v = 0.f;
      if (k < K && n < N)
        v = to_f32(kTransW ? we[(size_t)n * K + k] : we[(size_t)k * N + n]);
      ws[kk][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      float a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = xs[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = ws[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = col0 + tx + kSide * j;
      if (n < N)
        store_from_f32(&out[(size_t)(row0 + ty + kSide * i) * N + n],
                       acc[i][j]);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const int* __restrict__ gs, const int* __restrict__ nu,
                  float* __restrict__ dw, int M, int K, int N,
                  int block_m) {
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  long long start = 0;
  for (int i = 0; i < e; ++i) start += gs[i];
  long long end = start + gs[e];
  const long long live_end = (long long)nu[0] * block_m;
  if (end > live_end) end = live_end;
  if (end > M) end = M;
  __shared__ float xs[kTK][kTM + 1];  // [row][k]
  __shared__ float ds[kTK][kTN + 1];  // [row][n]
  float acc[kPer][kPer] = {};
  for (long long r0 = start; r0 < end; r0 += kTK) {
    for (int i = threadIdx.x; i < kTK * kTM; i += kThreads) {
      const int rr = i / kTM, c = i % kTM;
      const long long r = r0 + rr;
      const int k = k0 + c;
      xs[rr][c] = (r < end && k < K) ? to_f32(x[(size_t)r * K + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < kTK * kTN; i += kThreads) {
      const int rr = i / kTN, c = i % kTN;
      const long long r = r0 + rr;
      const int n = n0 + c;
      ds[rr][c] = (r < end && n < N) ? to_f32(dy[(size_t)r * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kTK; ++rr) {
      float a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = xs[rr][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = ds[rr][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = k0 + ty + kSide * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = n0 + tx + kSide * j;
      if (n < N) dw[((size_t)e * K + k) * N + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch_gmm(const void* x, const void* w, const int* eb, const int* nu,
               void* out, int M, int K, int N, int block_m, int trans_w,
               cudaStream_t st) {
  const dim3 grid((N + kTN - 1) / kTN, M / kTM);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (trans_w)
    gmm_kernel<T, true><<<grid, kThreads, 0, st>>>(xp, wp, eb, nu, op, K, N,
                                                   block_m);
  else
    gmm_kernel<T, false><<<grid, kThreads, 0, st>>>(xp, wp, eb, nu, op, K,
                                                    N, block_m);
  return cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* dy, const int* gs, const int* nu,
              float* dw, int M, int K, int N, int E, int block_m,
              cudaStream_t st) {
  const dim3 grid((N + kTN - 1) / kTN, (K + kTM - 1) / kTM, E);
  gmm_dw_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gs, nu, dw, M, K,
      N, block_m);
  return cudaGetLastError();
}

bool bad_shape(int M, int K, int N, int E, int block_m) {
  return M <= 0 || K <= 0 || N <= 0 || E <= 0 || block_m <= 0 ||
         block_m % kTM || M % block_m || M / kTM > 65535 || E > 65535;
}

}  // namespace
}  // namespace tpu_torch

extern "C" int gmm(const void* x, const void* w, const void* eb,
                   const void* nu, void* out, int M, int K, int N, int E,
                   int block_m, int trans_w, int dtype, void* stream) {
  using namespace tpu_torch;
  if (bad_shape(M, K, N, E, block_m)) return cudaErrorInvalidValue;
  const int* e = static_cast<const int*>(eb);
  const int* u = static_cast<const int*>(nu);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_gmm<float>(x, w, e, u, out, M, K, N, block_m, trans_w,
                               st);
    default:  // bfloat16 takes gmm_tc (gmm_sm90.cu)
      return cudaErrorInvalidValue;
  }
}

extern "C" int gmm_dw(const void* x, const void* dy, const void* gs,
                      const void* nu, void* dw, int M, int K, int N, int E,
                      int block_m, int dtype, void* stream) {
  using namespace tpu_torch;
  if (bad_shape(M, K, N, E, block_m) || (K + kTM - 1) / kTM > 65535)
    return cudaErrorInvalidValue;
  const int* g = static_cast<const int*>(gs);
  const int* u = static_cast<const int*>(nu);
  float* d = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_dw<float>(x, dy, g, u, d, M, K, N, E, block_m, st);
    default:  // bfloat16 takes gmm_dw_tc (gmm_dw_sm90.cu)
      return cudaErrorInvalidValue;
  }
}
