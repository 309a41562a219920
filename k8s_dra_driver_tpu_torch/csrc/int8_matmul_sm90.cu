// Weight-only int8 matmul for Hopper (sm_90a), CUDA C++: K7, the
// projections of int8 serving.  bf16 x runs on the tensor cores
// (W8A16: mma.sync m16n8k16 on the weight converted to bf16 in
// registers), f32 x on the CUDA cores; both share the grid, the weight
// stream and the epilogue.
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
// edge is masked, nothing is assumed a multiple of a tile.  int8 -> bf16
// is exact (|q| <= 127), and bf16 products are exact in f32, so the
// tensor-core route computes the TPU kernel's dot(x, q.astype(x.dtype),
// preferred_element_type=f32) with another order of f32 sums.
//
// Bound.  A decode step's projections have few rows (M = active slots,
// at most 64 on the routed path) and stream the whole weight once: the
// work is bound by the int8 weight's bytes, e.g. the 154M unembedding
// (1024 -> 32000) reads 32.8 MB, about 9.8 us at 3.35 TB/s.  The design
// spreads that stream over the whole card and keeps many 16-byte loads
// in flight:
//   - A block is 4 warps (128 threads) on one output tile: 16 rows
//     (tensor cores; 4 on the CUDA cores) x 128 columns, one expert g,
//     one slice s of K.  The grid is (m tiles, n tiles, G * splits),
//     m tiles fastest, so the row tiles of one weight tile run together
//     and share its reads in L2.
//   - Split K across blocks.  The wrapper's planner (models/quant.py
//     `int8_plan`) cuts K into `splits` chunks of `k_chunk` rows (a
//     multiple of the block's 64-row k step) so that a narrow product
//     still fills the card with blocks.  With splits > 1 each block
//     writes its f32 tile to the workspace [splits, G, M, N], and
//     `int8_splitk_sum_kernel` adds the slices in slice order,
//     multiplies by the scale, rounds once and writes through the out
//     strides: no float atomics, a deterministic result.  With splits
//     = 1 the block's own epilogue does that.
//   - Inside a block the 4 warps take the chunk's k16 steps in turn.
//     Lane (g = lane / 4, t = lane % 4) loads rows 4t .. 4t+3 of a k16
//     step, 16 contiguous int8 columns 16g .. 16g+15 each: four 16-byte
//     loads.  A ring of two or three steps in registers keeps the
//     weight loads of the next steps in flight while one is multiplied;
//     the ring of three holds the steps' x too.  It costs registers
//     (in bf16 three blocks an SM, not four), so the planner gives it
//     only to bf16 grids that fit at three blocks an SM and whose warps
//     walk at least three steps (the unembedding, the 660M products).  The
//     weight keeps its [K, N] layout: no pre-permuted copy is stored.
//   - Tensor cores: the fragment's k slots (2t, 2t+1, 2t+8, 2t+9) are
//     the physical rows 4t .. 4t+3 and its column g of n8 tile j the
//     physical column 16g + j, for A (x, 8 bf16 a lane, rows beyond M
//     zero in registers) and B alike, so each lane's loads feed its own
//     B fragments: int8 -> f32 by a byte permute into 2^23's mantissa
//     and one subtraction, two values packed to bf16 by a permute.
//   - CUDA cores (f32 x): the same loads, converted to f32, times 4
//     rows of x in f32 FMA (not TF32: it would round x).
//   - The warps' partial tiles (and on the CUDA cores the 4 lanes of a
//     quad, which hold different k) meet in shared memory and are added
//     in a fixed order.
#include <stdint.h>

#include "common.cuh"

namespace tpu_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTN = 128;                // columns per block: 8 x 16
constexpr int kKStep = kWarps * 16;     // k rows per block step
constexpr int kTMTc = 16;               // rows per block, tensor cores
constexpr int kTMF32 = 4;               // rows per block, CUDA cores
constexpr int kGroups = 64;             // partial groups of 32 a warp
constexpr int kPad = 33;                // floats per group, padded

// f32 value of signed byte b (0-3) of a word, given u = word ^
// 0x80808080 (each byte biased by 128): the byte becomes the low
// mantissa byte of 2^23, exact
__device__ __forceinline__ float byte_f32(uint32_t u, int b) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | b)) -
         8388736.f;
}

// two floats that are exact in bf16 as one register of two bf16 (lo in
// the low half): their upper halves
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 int8 of row k, columns c .. c+15 of one expert's [K, N] weight;
// zeros outside it.  kVec: N % 16 == 0 and q 16-byte aligned, so the
// 16 columns are one aligned load, all in or all out.
template <bool kVec>
__device__ __forceinline__ uint4 load_q(const int8_t* __restrict__ qb, int k,
                                        int c, int K, int N) {
  if (kVec) {
    if (k < K && c < N)
      return __ldg(reinterpret_cast<const uint4*>(qb + (size_t)k * N + c));
    return make_uint4(0, 0, 0, 0);
  }
  uint32_t w[4] = {0, 0, 0, 0};
  if (k < K) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (c + j < N)
        w[j / 4] |= (uint32_t)(uint8_t)__ldg(qb + (size_t)k * N + c + j)
                    << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// bf16 x element (raw bits), zero outside [rows) x [K)
__device__ __forceinline__ uint32_t x_bits(const bf16* xb, long long x_m,
                                           int r, int k, int rows, int K) {
  return (r < rows && k < K)
             ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(
                   xb + r * x_m + k))
             : 0u;
}

template <typename T, bool kVec, int kDepth>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_sm90_kernel(const T* __restrict__ x,
                            const int8_t* __restrict__ q,
                            const float* __restrict__ scale,
                            T* __restrict__ out, float* __restrict__ ws,
                            int G, int M, int K, int N, long long x_g,
                            long long x_m, long long o_g, long long o_m,
                            int splits, int k_chunk) {
  constexpr bool kTc = sizeof(T) == 2;
  constexpr int kTM = kTc ? kTMTc : kTMF32;
  const int g = blockIdx.z / splits, s = blockIdx.z % splits;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int rows = min(kTM, M - m0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lg = lane / 4, lt = lane % 4;
  const int col = n0 + 16 * lg;            // this lane's 16 columns
  const T* xb = x + g * x_g + m0 * x_m;
  const int8_t* qb = q + (size_t)g * K * N;
  const int k_begin = s * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  // tensor cores: acc[j][c] of n8 tile j (row lg + 8 (c / 2), fragment
  // column 2 lt + c % 2, i.e. physical column 16 (2 lt + c % 2) + j);
  // CUDA cores: acc[r][j], row r, column 16 lg + j, over rows 4 lt ..
  // 4 lt + 3 of each step only
  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  // a ring of kDepth k16 steps a warp: the weight loads of the next
  // kDepth - 1 steps are in flight while one step is multiplied; the
  // deep ring holds x too, the shallow one loads x as it multiplies
  // (fewer registers)
  constexpr bool kRingX = kDepth > 2;
  constexpr int kXr = kTc ? 8 : 16;
  uint4 wq[kDepth][4];
  uint32_t xr[kRingX ? kDepth : 1][kXr];
  auto load_x = [&](uint32_t (&dst)[kXr], int kb) {
    const bool live = kb < k_end;
    const int k = kb + 4 * lt;
    if constexpr (kTc) {
      // rows lg and lg + 8, k .. k + 3, as the A fragment takes them
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[4 * h + i] =
              live ? x_bits(reinterpret_cast<const bf16*>(xb), x_m,
                            lg + 8 * (i / 2), k + 2 * h + i % 2, rows, K)
                   : 0u;
    } else {
#pragma unroll
      for (int r = 0; r < kTMF32; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[4 * r + i] =
              (live && r < rows && k + i < K)
                  ? __float_as_uint(__ldg(reinterpret_cast<const float*>(xb) +
                                          r * x_m + k + i))
                  : 0u;
    }
  };
  auto load = [&](int d, int kb) {
    const bool live = kb < k_end;
    const int k = kb + 4 * lt;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wq[d][i] = live ? load_q<kVec>(qb, k + i, col, K, N)
                      : make_uint4(0, 0, 0, 0);
    if constexpr (kRingX) load_x(xr[d], kb);
  };
  auto compute = [&](int d, int kb) {
    if constexpr (!kRingX) load_x(xr[0], kb);
    const uint32_t(&xv)[kXr] = xr[kRingX ? d : 0];
    uint32_t u[4][4];  // [row i][word]: bytes biased by 128
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) u[i][w] = word(wq[d][i], w) ^ 0x80808080u;
    if constexpr (kTc) {
      // a[0]: row lg, k .. k+1; a[1]: row lg+8; a[2], a[3]: k+2 .. k+3
      uint32_t a[4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
        a[f] = xv[2 * f] | xv[2 * f + 1] << 16;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int w = j / 4, b = j % 4;
        const uint32_t b0 = pack_exact(byte_f32(u[0][w], b),
                                       byte_f32(u[1][w], b));
        const uint32_t b1 = pack_exact(byte_f32(u[2][w], b),
                                       byte_f32(u[3][w], b));
        mma_bf16(acc[j], a, b0, b1);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int w = j / 4, b = j % 4;
        float wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = byte_f32(u[i][w], b);
#pragma unroll
        for (int r = 0; r < kTMF32; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[j][r] = fmaf(__uint_as_float(xv[4 * r + i]), wv[i],
                             acc[j][r]);
      }
    }
  };
  const int kb0 = k_begin + 16 * warp;
#pragma unroll
  for (int d = 0; d < kDepth - 1; ++d) load(d, kb0 + d * kKStep);
  for (int kb = kb0; kb < k_end; kb += kDepth * kKStep) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      load((d + kDepth - 1) % kDepth, kb + (d + kDepth - 1) * kKStep);
      if (kb + d * kKStep < k_end) compute(d, kb + d * kKStep);
    }
  }

  // partials: group (j, c) of 32 lanes, one per warp (tensor cores), or
  // group (row r, j) with the quad's 4 lanes side by side (CUDA cores)
  __shared__ float red[kWarps * kGroups * kPad];
  float* mine = red + warp * kGroups * kPad;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int grp = kTc ? j * 4 + c : c * 16 + j;
      mine[grp * kPad + lane] = acc[j][c];
    }
  __syncthreads();

  for (int e = threadIdx.x; e < rows * kTN; e += kThreads) {
    const int r = e / kTN, cc = e % kTN, n = n0 + cc;
    if (n >= N) continue;
    float sum = 0.f;
    if constexpr (kTc) {
      // column cc = 16 (2 t + c0) + j, row r = lg + 8 h
      const int d = cc / 16, j = cc % 16;
      const int grp = j * 4 + 2 * (r / 8) + d % 2;
      const int ln = 4 * (r % 8) + d / 2;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += red[(w * kGroups + grp) * kPad + ln];
    } else {
      const int grp = r * 16 + cc % 16, ln = 4 * (cc / 16);
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          sum += red[(w * kGroups + grp) * kPad + ln + t];
    }
    if (splits == 1)
      store_from_f32(&out[g * o_g + (m0 + r) * o_m + n],
                     sum * scale[(size_t)g * N + n]);
    else
      ws[(((size_t)s * G + g) * M + m0 + r) * N + n] = sum;
  }
}

// out[g, m, n] = (sum over slices s, in order, of ws[s, g, m, n]) *
// scale[g, n], rounded once to out's dtype
template <typename T>
__global__ void __launch_bounds__(256)
    int8_splitk_sum_kernel(const float* __restrict__ ws,
                           const float* __restrict__ scale,
                           T* __restrict__ out, int G, int M, int N,
                           long long o_g, long long o_m, int splits) {
  const size_t total = (size_t)G * M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int n = i % N, m = (i / N) % M, g = i / ((size_t)M * N);
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += ws[(size_t)s * total + i];
  store_from_f32(&out[g * o_g + m * o_m + n], sum * scale[(size_t)g * N + n]);
}

template <typename T, int kDepth>
int launch(const void* x, const void* q, const void* scale, void* out,
           void* ws, int G, int M, int K, int N, long long x_g,
           long long x_m, long long o_g, long long o_m, int splits,
           int k_chunk, cudaStream_t st) {
  constexpr int kTM = sizeof(T) == 2 ? kTMTc : kTMF32;
  const dim3 grid((M + kTM - 1) / kTM, (N + kTN - 1) / kTN, G * splits);
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  float* wp = static_cast<float*>(ws);
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (vec)
    int8_matmul_sm90_kernel<T, true, kDepth><<<grid, kThreads, 0, st>>>(
        xp, qp, sp, op, wp, G, M, K, N, x_g, x_m, o_g, o_m, splits, k_chunk);
  else
    int8_matmul_sm90_kernel<T, false, kDepth><<<grid, kThreads, 0, st>>>(
        xp, qp, sp, op, wp, G, M, K, N, x_g, x_m, o_g, o_m, splits, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)G * M * N;
  int8_splitk_sum_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      wp, sp, op, G, M, N, o_g, o_m, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_torch

// K7 for G experts (G = 1: int8_matmul): x float32 (CUDA cores) or
// bfloat16 (tensor cores), K cut into `splits` chunks of `k_chunk` rows
// (a multiple of 64, the chunks covering K exactly once), ws an f32
// workspace [splits, G, M, N] when splits > 1 (unread otherwise), a
// ring of `ring` k16 steps a warp (2, or 3 for bfloat16 x).  Returns
// cudaGetLastError().
extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* out, void* ws, int G, int M, int K, int N,
                           long long x_g, long long x_m, long long o_g,
                           long long o_m, int splits, int k_chunk, int ring,
                           int dtype, void* stream) {
  using namespace tpu_torch;
  if (G <= 0 || M <= 0 || K <= 0 || N <= 0 || splits <= 0 ||
      k_chunk <= 0 || k_chunk % kKStep ||
      (long long)(splits - 1) * k_chunk >= K ||
      (long long)splits * k_chunk < K || (long long)G * splits > 65535 ||
      (N + kTN - 1) / kTN > 65535 || (splits > 1 && ws == nullptr) ||
      (long long)G * M * N > 0x7fffffffLL * 256)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && ring == 2)
    return launch<float, 2>(x, q, scale, out, ws, G, M, K, N, x_g, x_m, o_g,
                            o_m, splits, k_chunk, st);
  if (dtype == kBFloat16 && ring == 2)
    return launch<__nv_bfloat16, 2>(x, q, scale, out, ws, G, M, K, N, x_g,
                                    x_m, o_g, o_m, splits, k_chunk, st);
  if (dtype == kBFloat16 && ring == 3)
    return launch<__nv_bfloat16, 3>(x, q, scale, out, ws, G, M, K, N, x_g,
                                    x_m, o_g, o_m, splits, k_chunk, st);
  return cudaErrorInvalidValue;
}
