// Paged-attention decode for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_paged_decode_kernel` of
// k8s_dra_driver_tpu/ops/paged_attention.py, launched there by
// `_paged_attention_call` (pallas_call) and entered through
// `paged_attention`.  One query token per row attends to the K/V
// pages its block table names: row b reads pool pages tables[b, j]
// for j*bs < lengths[b], masks key positions >= lengths[b], keeps an
// online softmax in f32 and writes the normalized [B, H, D] output.
//
// Design.  The TPU grid ran (row, page) in order with the block table
// riding as scalar prefetch into the K/V index maps.  Here:
//   - one block of 128 threads per (row, KV head); it holds that KV
//     head's G = H / H_kv query heads, so each K/V byte is read once
//     for the whole group (GQA without repeats);
//   - the block loads its own table entries and length (no scalar
//     prefetch on this card) and walks the row's valid pages, 16
//     tokens at a time: a chunk of K and V is staged in shared memory
//     as f32, the G x 16 scores are formed, one thread per query head
//     folds them into that head's running max and sum, and the
//     threads then rescale and accumulate the G x D outputs;
//   - pages past the row's length are never touched; a partial last
//     page is masked by position.
//
// Bound.  The kernel is memory-bound: it must read the valid K/V
// bytes of the step once, so its least time is those bytes over the
// card's 3.35 TB/s.  One block per (row, KV head) leaves most SMs idle
// when rows are few and contexts long, and each block walks its pages
// serially.  The later speed work splits a row's pages across blocks
// (flash-decoding, split-K) and merges the partial softmax states.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace tpu_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;  // tokens staged per pass

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int Hkv, int bs, int n_pages, float scale) {
  constexpr int LD = D + 1;
  __shared__ float sK[kChunk * LD];
  __shared__ float sV[kChunk * D];
  extern __shared__ float dyn[];
  const int G = H / Hkv;
  float* sQ = dyn;                  // [G][D]
  float* sAcc = sQ + G * D;         // [G][D]
  float* sS = sAcc + G * D;         // [G][kChunk] scores, then probs
  float* sM = sS + G * kChunk;      // [G] running max
  float* sL = sM + G;               // [G] running sum
  float* sAlpha = sL + G;           // [G] this chunk's rescale

  const int b = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x;
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    sQ[e] = to_f32(q[((size_t)b * H + hk * G + g) * D + d]);
    sAcc[e] = 0.f;
  }
  if (tid < G) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  const int len = lengths[b];
  const int pages = min((len + bs - 1) / bs, n_pages);

  for (int j = 0; j < pages; ++j) {
    const int blk = tables[(size_t)b * n_pages + j];
    for (int c0 = 0; c0 < bs; c0 += kChunk) {
      const int base = j * bs + c0;  // absolute position of token c0
      if (base >= len) break;        // uniform across the block
      __syncthreads();
      for (int e = tid; e < kChunk * D; e += kThreads) {
        const int t = e / D, d = e % D;
        float kx = 0.f, vx = 0.f;
        if (c0 + t < bs && base + t < len) {
          const size_t off =
              (((size_t)blk * bs + c0 + t) * Hkv + hk) * D + d;
          kx = to_f32(k_pool[off]);
          vx = to_f32(v_pool[off]);
        }
        sK[t * LD + d] = kx;
        sV[t * D + d] = vx;
      }
      __syncthreads();
      for (int e = tid; e < G * kChunk; e += kThreads) {
        const int g = e / kChunk, t = e % kChunk;
        float s = -INFINITY;
        if (c0 + t < bs && base + t < len) {
          float dot = 0.f;
          for (int d = 0; d < D; ++d)
            dot = fmaf(sQ[g * D + d], sK[t * LD + d], dot);
          s = dot * scale;
        }
        sS[e] = s;
      }
      __syncthreads();
      if (tid < G) {
        float* srow = sS + tid * kChunk;
        float mx = -INFINITY;
        for (int t = 0; t < kChunk; ++t) mx = fmaxf(mx, srow[t]);
        // token `base` is valid, so m_new is finite
        const float m_old = sM[tid];
        const float m_new = fmaxf(m_old, mx);
        const float alpha = expf(m_old - m_new);
        float sum = 0.f;
        for (int t = 0; t < kChunk; ++t) {
          const float p = srow[t] == -INFINITY ? 0.f : expf(srow[t] - m_new);
          srow[t] = p;
          sum += p;
        }
        sL[tid] = sL[tid] * alpha + sum;
        sM[tid] = m_new;
        sAlpha[tid] = alpha;
      }
      __syncthreads();
      for (int e = tid; e < G * D; e += kThreads) {
        const int g = e / D, d = e % D;
        float a = sAcc[e] * sAlpha[g];
        const float* prow = sS + g * kChunk;
#pragma unroll
        for (int t = 0; t < kChunk; ++t) a = fmaf(prow[t], sV[t * D + d], a);
        sAcc[e] = a;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    const float l = sL[g];
    store_from_f32(out + ((size_t)b * H + hk * G + g) * D + d,
                   l > 0.f ? sAcc[e] / l : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lengths, void* out, int B,
                   int H, int Hkv, int bs, int n_pages, float scale,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * (size_t)(2 * G * D + G * kChunk + 3 * G);
  dim3 grid(B, Hkv);
  paged_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lengths, static_cast<T*>(out),
      H, Hkv, bs, n_pages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k_pool,
                     const void* v_pool, const int* tables,
                     const int* lengths, void* out, int B, int H, int Hkv,
                     int bs, int n_pages, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, tables, lengths, out, B, H,
                           Hkv, bs, n_pages, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, tables, lengths, out, B, H,
                            Hkv, bs, n_pages, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpu_torch

// q [B,H,D], pools [n_blocks,bs,H_kv,D] (float32 or bfloat16,
// contiguous), tables [B,n_pages] int32, lengths [B] int32, out like q.
// Returns cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* lengths, void* out, int B, int H,
                            int Hkv, int D, int bs, int n_pages, float scale,
                            int dtype, void* stream) {
  using namespace tpu_torch;
  const int* t = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || bs <= 0 || n_pages <= 0)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return launch_d<float>(D, q, k_pool, v_pool, t, len, out, B, H, Hkv,
                             bs, n_pages, scale, st);
    case kBFloat16:
      return launch_d<__nv_bfloat16>(D, q, k_pool, v_pool, t, len, out, B,
                                     H, Hkv, bs, n_pages, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
