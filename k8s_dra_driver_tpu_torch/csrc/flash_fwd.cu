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
//     a k tile and D/4 of the row's output accumulators in registers
//     (columns lane, lane + 4, ...: D = 8 gives each thread two, so
//     every head dim the wrapper takes, 8 to 128, maps whole);
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
//
// The block entry (`flash_fwd_block`) is the same kernel in a second
// mode, the port of `flash_block_attention` for f32: q [B,Tq,H,D]
// against one K/V block [B,Tk,Hkv,D] at absolute positions q_off /
// k_off, masks by absolute position, separate q and k segment ids, and
// the unnormalized accumulator o [B,Tq,H,D] with the running max m and
// sum l [B,H,Tq] as its result (f32).  Rows that see no key of the block
// are written as m = -1e30, l = 0, o = 0, the TPU kernel's values, which
// `merge_flash_stats` relies on.  The mode is a template parameter
// (kBlock): the normalized entry's instantiation keeps q's length and
// segment ids for the keys, a zero offset shift and its own epilogue.
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

template <typename T>
struct FwdArgs {
  const T* q;        // [B, Tq, H, D]
  const T* k;        // [B, Tk, Hkv, D]
  const T* v;
  const int* qseg;   // [B, Tq] or null
  const int* kseg;   // [B, Tk], null exactly when qseg is
  T* out;            // normalized: out [B, Tq, H, D]; block mode: o (f32)
  float* lse;        // normalized: lse [B, H, Tq]; block mode: m
  float* l;          // block mode: l [B, H, Tq]; null when normalized
  int B, Tq, Tk, H, Hkv, q_off, k_off, causal, window;
  float scale;
};

// kBlock: the block entry (offsets, unnormalized statistics); else the
// normalized entry (offsets 0, Tq = Tk)
template <typename T, int D, bool kBlock>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FwdArgs<T> a) {
  // the key block's length and ids: in the normalized entry (Tq = Tk,
  // one segment array) q's fields, as the kernel read them before the
  // block mode existed
  const int H = a.H, Hkv = a.Hkv, Tq = a.Tq, Tk = kBlock ? a.Tk : a.Tq;
  const int* kseg = kBlock ? a.kseg : a.qseg;
  const int causal = a.causal, window = a.window;
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
  const bool row_ok = qi < Tq;
  // qi's position relative to the key block's start (absolute offsets)
  const int shift = kBlock ? a.q_off - a.k_off : 0;
  const int qk = qi + shift;

  for (int e = tid; e < kBlockM * D; e += kThreads) {
    const int rr = e / D, c = e % D, t = q0 + rr;
    sQ[rr * LD + c] =
        t < Tq ? to_f32(a.q[(((size_t)b * Tq + t) * H + h) * D + c]) : 0.f;
  }
  const int qseg =
      (a.qseg != nullptr && row_ok) ? a.qseg[(size_t)b * Tq + qi] : 0;

  // k tiles the masks can reach for any row of this q tile, by absolute
  // position; none when the whole tile is above the diagonal or behind
  // the window (block mode)
  const int q_last = min(q0 + kBlockM, Tq) - 1;
  const int k_hi =
      causal ? (kBlock ? min(q_last + shift, Tk - 1) : q_last) : Tk - 1;
  const int k_lo = window > 0 ? max(q0 + shift - (window - 1), 0) : 0;
  const int kt_lo = k_lo / kBlockN;
  const int kt_hi = (kBlock && k_hi < k_lo) ? kt_lo - 1 : k_hi / kBlockN;

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
      if (t < Tk) {
        const size_t off = (((size_t)b * Tk + t) * Hkv + hk) * D + c;
        kx = to_f32(a.k[off]);
        vx = to_f32(a.v[off]);
      }
      sK[rr * LD + c] = kx;
      sV[rr * LD + c] = vx;
    }
    if (kseg != nullptr && tid < kBlockN) {
      const int t = k0 + tid;
      sSeg[tid] = t < Tk ? kseg[(size_t)b * Tk + t] : 0;
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
      bool valid = row_ok && kj < Tk;
      if (causal) valid = valid && kj <= qk;
      if (window > 0) valid = valid && qk - kj < window;
      if (kseg != nullptr) valid = valid && sSeg[c] == qseg;
      ok[j] = valid;
      s[j] *= a.scale;
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
    T* orow = a.out + (((size_t)b * Tq + qi) * H + h) * D;
    const size_t stat = ((size_t)b * H + h) * Tq + qi;
    if constexpr (kBlock) {  // the statistics as they are
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        store_from_f32(orow + i * kLanes + lane, acc[i]);
      if (lane == 0) {
        a.lse[stat] = m == -INFINITY ? -1e30f : m;
        a.l[stat] = l;
      }
      return;
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      store_from_f32(orow + i * kLanes + lane, acc[i] * inv);
    if (lane == 0) a.lse[stat] = m + logf(l);
  }
}

template <typename T, int D, bool kBlock>
cudaError_t launch(const FwdArgs<T>& a, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  // above 48 KB of dynamic shared memory; the attribute belongs to the
  // current device, so it is set on every launch (a host-side call)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kBlock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + kBlockM - 1) / kBlockM, a.H, a.B);
  flash_fwd_kernel<T, D, kBlock><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const FwdArgs<T>& a, cudaStream_t stream) {
  if (a.B <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.H <= 0 || a.Hkv <= 0 ||
      a.H % a.Hkv)
    return cudaErrorInvalidValue;
  const bool block = a.l != nullptr;
  switch (D) {
    case 8:
      return block ? launch<T, 8, true>(a, stream)
                   : launch<T, 8, false>(a, stream);
    case 16:
      return block ? launch<T, 16, true>(a, stream)
                   : launch<T, 16, false>(a, stream);
    case 32:
      return block ? launch<T, 32, true>(a, stream)
                   : launch<T, 32, false>(a, stream);
    case 64:
      return block ? launch<T, 64, true>(a, stream)
                   : launch<T, 64, false>(a, stream);
    case 128:
      return block ? launch<T, 128, true>(a, stream)
                   : launch<T, 128, false>(a, stream);
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
  if (dtype != kFloat32) return cudaErrorInvalidValue;
  FwdArgs<float> a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.qseg = a.kseg = static_cast<const int*>(seg);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.l = nullptr;
  a.B = B;
  a.Tq = a.Tk = seq;
  a.H = H;
  a.Hkv = Hkv;
  a.q_off = a.k_off = 0;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return launch_d<float>(D, a, static_cast<cudaStream_t>(stream));
}

// The block entry: q [B,Tq,H,D] against k/v [B,Tk,Hkv,D] (float32,
// contiguous; bfloat16 takes flash_fwd_block_tc) at absolute offsets
// q_off / k_off; qseg [B,Tq] and kseg [B,Tk] int32, both or neither;
// writes o [B,Tq,H,D] unnormalized, m and l [B,H,Tq], all float32.
// window <= 0 means no window.  Returns cudaGetLastError().
extern "C" int flash_fwd_block(const void* q, const void* k, const void* v,
                               const void* qseg, const void* kseg, void* o,
                               void* m, void* l, int B, int Tq, int Tk, int H,
                               int Hkv, int D, int q_off, int k_off,
                               int causal, int window, float scale, int dtype,
                               void* stream) {
  using namespace tpu_torch;
  if (dtype != kFloat32 || (qseg == nullptr) != (kseg == nullptr) ||
      m == nullptr || l == nullptr)
    return cudaErrorInvalidValue;
  FwdArgs<float> a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.out = static_cast<float*>(o);
  a.lse = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.B = B;
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.Hkv = Hkv;
  a.q_off = q_off;
  a.k_off = k_off;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return launch_d<float>(D, a, static_cast<cudaStream_t>(stream));
}
