// Flash-attention forward for Hopper (sm_90a), CUDA C++: K1's f32
// route, on the CUDA cores (bf16 takes flash_fwd_sm90.cu).
//
// Replaces the TPU kernel `_flash_kernel` of
// k8s_dra_driver_tpu/ops/flash_attention.py, launched there by
// `_flash_block_attention` (pallas_call) and entered through
// `flash_attention` -> `_flash_forward`.  It computes what
// `flash_attention` returns: the normalized softmax(q k^T * scale +
// mask) v in q's dtype, plus the per-row log-sum-exp in f32 (kept for
// the backward kernels of a later slice).
//
// Masks: causal by absolute position, optional sliding window (each
// query sees its `window` most recent keys, itself included), optional
// segment ids [B, T] int32 (queries see keys of their own segment).
// GQA: query head h reads K/V head h / (H / H_kv); K/V are never
// repeated in memory.
//
// Design.  The TPU grid ran (batch-head, q-block, k-block) in order
// on one core and carried the online-softmax statistics across the
// sequential k dimension in VMEM.  Here blocks run in parallel in no
// order, so the k dimension becomes a loop inside the block:
//   - one block of 256 threads per (64-row q tile, head, batch);
//   - four threads per query row, each holding 16 of the 64 scores of
//     a k tile and D/4 of the row's output accumulators in registers;
//   - the loop walks only the k tiles the masks can reach: tiles
//     wholly above the causal diagonal or wholly behind the window are
//     never loaded;
//   - the ragged tail is masked by length (no padding to 128 lanes);
//   - the softmax scale multiplies the f32 scores, not a rounded q.
// Q, K and V tiles sit in shared memory as f32 (rows padded by one
// word against bank conflicts); products and the softmax run in f32
// FMA on the CUDA cores.
//
// Bound.  At long T the kernel does 4*B*H*T^2*D/2 (causal) flops and
// is bound by the tensor cores' bf16 rate, which this kernel does not
// use: the CUDA-core f32 path is its ceiling today.  At the serving
// path's prompt lengths (24-96 tokens) the whole call is a few
// microseconds of work and launch latency bounds it.  The tensor
// cores take bf16 only, so f32 stays here.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace tpu_torch {
namespace {

constexpr int kBlockM = 64;                 // query rows per block
constexpr int kBlockN = 64;                 // keys per k tile
constexpr int kLanes = 4;                   // threads per query row
constexpr int kThreads = kBlockM * kLanes;  // 256
constexpr int kCols = kBlockN / kLanes;     // scores per thread

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (size_t)((kBlockM + 2 * kBlockN) * (D + 1)  // Q,K,V
                                  + kBlockM * (kBlockN + 1))          // P
         + sizeof(int) * kBlockN;                            // k segments
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 T* __restrict__ out, float* __restrict__ lse, int seq,
                 int H, int Hkv, int causal, int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlockN + 1;
  constexpr int kAcc = D / kLanes;
  extern __shared__ float smem[];
  float* sQ = smem;                    // [kBlockM][LD]
  float* sK = sQ + kBlockM * LD;       // [kBlockN][LD]
  float* sV = sK + kBlockN * LD;       // [kBlockN][LD]
  float* sP = sV + kBlockN * LD;       // [kBlockM][LDP]
  int* sSeg = reinterpret_cast<int*>(sP + kBlockM * LDP);

  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int r = tid / kLanes, lane = tid % kLanes;
  const int qi = q0 + r;
  const bool row_ok = qi < seq;

  for (int e = tid; e < kBlockM * D; e += kThreads) {
    const int rr = e / D, c = e % D, t = q0 + rr;
    sQ[rr * LD + c] =
        t < seq ? to_f32(q[(((size_t)b * seq + t) * H + h) * D + c]) : 0.f;
  }
  const int qseg = (seg != nullptr && row_ok) ? seg[(size_t)b * seq + qi] : 0;

  // k tiles the masks can reach for any row of this q tile
  const int q_last = min(q0 + kBlockM, seq) - 1;
  const int kt_hi = (causal ? q_last : seq - 1) / kBlockN;
  const int kt_lo = window > 0 ? max(q0 - (window - 1), 0) / kBlockN : 0;

  float m = -INFINITY, l = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBlockN * D; e += kThreads) {
      const int rr = e / D, c = e % D, t = k0 + rr;
      float kx = 0.f, vx = 0.f;
      if (t < seq) {
        const size_t off = (((size_t)b * seq + t) * Hkv + hk) * D + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      sK[rr * LD + c] = kx;
      sV[rr * LD + c] = vx;
    }
    if (seg != nullptr && tid < kBlockN) {
      const int t = k0 + tid;
      sSeg[tid] = t < seq ? seg[(size_t)b * seq + t] : 0;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        s[j] = fmaf(qd, sK[(j * kLanes + lane) * LD + d], s[j]);
    }
    float tile_max = -INFINITY;
    bool ok[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = j * kLanes + lane, kj = k0 + c;
      bool valid = row_ok && kj < seq;
      if (causal) valid = valid && kj <= qi;
      if (window > 0) valid = valid && qi - kj < window;
      if (seg != nullptr) valid = valid && sSeg[c] == qseg;
      ok[j] = valid;
      s[j] *= scale;
      if (valid) tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    // a row that has seen no valid key yet keeps m = -inf and adds
    // nothing (p = 0, alpha = 1)
    const bool any = m_new != -INFINITY;
    const float alpha = any ? expf(m - m_new) : 1.f;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = (any && ok[j]) ? expf(s[j] - m_new) : 0.f;
      psum += p;
      sP[r * LDP + j * kLanes + lane] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's four threads share one warp
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBlockN; ++c) {
      const float p = sP[r * LDP + c];
      const float* vrow = sV + c * LD;
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        acc[i] = fmaf(p, vrow[i * kLanes + lane], acc[i]);
    }
  }

  if (row_ok) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + (((size_t)b * seq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      store_from_f32(orow + i * kLanes + lane, acc[i] * inv);
    if (lane == 0) lse[((size_t)b * H + h) * seq + qi] = m + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg, void* out, float* lse, int B, int seq,
                   int H, int Hkv, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  // above 48 KB of dynamic shared memory; the attribute belongs to the
  // current device, so it is set on every launch (a host-side call)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((seq + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(out), lse, seq, H, Hkv,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const int* seg, void* out, float* lse, int B, int seq,
                     int H, int Hkv, int causal, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, seg, out, lse, B, seq, H, Hkv, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, seg, out, lse, B, seq, H, Hkv, causal,
                            window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpu_torch

// q [B,T,H,D], k/v [B,T,H_kv,D] (float32, contiguous; the dtype code
// must be float32's, bfloat16 takes flash_fwd_tc),
// seg [B,T] int32 or null, out like q, lse [B,H,T] float32.
// window <= 0 means no window.  Returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* seg, void* out, void* lse, int B,
                         int seq, int H, int Hkv, int D, int causal,
                         int window, float scale, int dtype, void* stream) {
  using namespace tpu_torch;
  const int* s = static_cast<const int*>(seg);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || seq <= 0 || H <= 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return launch_d<float>(D, q, k, v, s, out, l, B, seq, H, Hkv, causal,
                             window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
