// Flash-attention backward for Hopper (sm_90a), CUDA C++, the f32
// route: K3 (dq) and K4 (dk, dv) for float32 inputs.  bfloat16 inputs
// take the tensor-core kernels of flash_bwd_sm90.cu; wgmma would take
// f32 operands only as TF32, which the f32 training steps cannot
// afford (they are held to 1e-4 of the CPU).
//
// Replaces, for f32, the TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` of k8s_dra_driver_tpu/ops/flash_attention.py,
// both launched there by `flash_block_grads` (two pallas_calls) with
// the score recompute `_bwd_common`.  Same contract: gradients against
// one K/V block, q/do [B,Tq,H,D], k/v [B,Tk,H_kv,D] float32, lse/delta
// [B,H,Tq] f32 with lse = m + log l over the FULL key range and delta =
// rowsum(do * o); outputs are f32.
//
//   p  = exp(q k^T * scale - lse)     (masked pairs: 0)
//   ds = p * (do v^T - delta) * scale
//   dq = ds k          (K3)
//   dv = p^T do,  dk = ds^T q,  summed over the group's query heads (K4)
//
// Masks by absolute position, as K1 and the reference: the blocks start
// at q_off / k_off; causal keeps k <= q, a window keeps q - k < window;
// keys at local index >= k_len are dropped (the reference's
// `k_valid_end`); segment ids [B,Tq] / [B,Tk] int32 keep equal pairs.
// Ragged tails are masked by length, never padded: the JAX package pads
// lse with +1e30 for that.
//
// Design.  On the TPU each kernel's grid ran its reduction axis last,
// in order on one core, with the sum carried in VMEM scratch.  Here
// blocks run in parallel, so each block owns its output tile and loops
// over the reduction itself:
//   - K3: one block of 256 threads per (64-row q tile, head, batch).
//     Q and dO of the tile stay in shared memory; the block walks the
//     k tiles the masks can reach (tiles above the causal diagonal or
//     behind the window are never loaded), four threads per query row,
//     each forming 16 of the 64 scores and dp values of a k tile and
//     holding D/4 of the row's dq in registers (D 8 to 128: at D = 8
//     two columns a thread).
//   - K4: one block of 256 threads per (64-key tile, KV head, batch).
//     K and V of the tile stay in shared memory; the block walks the
//     group's query heads and, for each, the q tiles that can reach the
//     keys, four threads per key row holding D/4 of dk and of dv in
//     registers.  The GQA group sum happens inside the block: no
//     atomics, deterministic, and no [B,H,Tk,D] per-query-head
//     intermediate (the JAX package folds one after its kernel).
// Tiles sit in shared memory as f32, rows padded by one word against
// bank conflicts; every product runs in f32 FMA on the CUDA cores.
//
// Bound.  K3 does 3 and K4 4 products of 2*D flops per valid (q, k)
// pair, against the card's 67 TFLOP/s of f32 outside the tensor cores.
// The f32 route serves the f32 card steps, which are small; it was
// never made fast.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace tpu_torch {
namespace {

constexpr int kTile = 64;                 // rows of every tile
constexpr int kLanes = 4;                 // threads per owned row
constexpr int kThreads = kTile * kLanes;  // 256
constexpr int kCols = kTile / kLanes;     // streamed rows per thread
constexpr int kLDP = kTile + 1;           // padded row of p / ds

struct BwdArgs {
  const int* qseg;     // [B, Tq] or null
  const int* kseg;     // [B, Tk] or null (null iff qseg is)
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  int Tq, Tk, k_len, H, Hkv, q_off, k_off, causal, window;
  float scale;
};

// local query qi < Tq sees local key kj (segments compared by caller's
// ids; ignored without segments)
__device__ __forceinline__ bool pair_ok(int qi, int kj, const BwdArgs& a,
                                        int qs, int ks) {
  if (kj >= a.k_len) return false;
  const int qa = a.q_off + qi, ka = a.k_off + kj;
  if (a.causal && ka > qa) return false;
  if (a.window > 0 && qa - ka >= a.window) return false;
  if (a.qseg != nullptr && qs != ks) return false;
  return true;
}

// rows [t0, t0 + kTile) of head hh of x [B, T, nh, D] into dst
// [kTile][D + 1] as f32; rows past T are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ x,
                                          int t0, int T_, int b, int nh,
                                          int hh) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int rr = e / D, c = e % D, t = t0 + rr;
    dst[rr * LD + c] =
        t < T_ ? x[(((size_t)b * T_ + t) * nh + hh) * D + c] : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1)  // Q, dO, K, V
                                  + kTile * kLDP)      // ds
         + sizeof(int) * kTile;                        // k segments
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1)  // K, V, Q, dO
                                  + 2 * kTile * kLDP   // p, ds
                                  + 2 * kTile)         // lse, delta
         + sizeof(int) * kTile;                        // q segments
}

// K3: grid (ceil(Tq / 64), H, B)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const BwdArgs a, float* __restrict__ dq) {
  constexpr int LD = D + 1;
  constexpr int kAcc = D / kLanes;
  extern __shared__ float smem[];
  float* sQ = smem;               // [kTile][LD]
  float* sDO = sQ + kTile * LD;   // [kTile][LD]
  float* sK = sDO + kTile * LD;   // [kTile][LD]
  float* sV = sK + kTile * LD;    // [kTile][LD]
  float* sDS = sV + kTile * LD;   // [kTile][kLDP]
  int* sSeg = reinterpret_cast<int*>(sDS + kTile * kLDP);

  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int r = tid / kLanes, lane = tid % kLanes;
  const int qi = q0 + r;
  const bool row_ok = qi < a.Tq;

  load_tile<D>(sQ, q, q0, a.Tq, b, a.H, h);
  load_tile<D>(sDO, dout, q0, a.Tq, b, a.H, h);
  const size_t stat = ((size_t)b * a.H + h) * a.Tq + qi;
  const float lse_r = row_ok ? a.lse[stat] : 0.f;
  const float delta_r = row_ok ? a.delta[stat] : 0.f;
  const int qs =
      (a.qseg != nullptr && row_ok) ? a.qseg[(size_t)b * a.Tq + qi] : 0;

  // local keys any row of this q tile can see: [k_lo, k_hi]
  const int q_last = min(q0 + kTile, a.Tq) - 1;
  int k_hi = a.k_len - 1;
  if (a.causal) k_hi = min(k_hi, a.q_off + q_last - a.k_off);
  const int k_lo =
      a.window > 0 ? max(0, a.q_off + q0 - (a.window - 1) - a.k_off) : 0;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  if (k_hi >= k_lo) {
    for (int kt = k_lo / kTile; kt <= k_hi / kTile; ++kt) {
      const int k0 = kt * kTile;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(sK, k, k0, a.Tk, b, a.Hkv, hk);
      load_tile<D>(sV, v, k0, a.Tk, b, a.Hkv, hk);
      if (a.kseg != nullptr && tid < kTile) {
        const int t = k0 + tid;
        sSeg[tid] = t < a.Tk ? a.kseg[(size_t)b * a.Tk + t] : 0;
      }
      __syncthreads();

      float s[kCols], dp[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float qd = sQ[r * LD + d];
        const float od = sDO[r * LD + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = j * kLanes + lane;
          s[j] = fmaf(qd, sK[c * LD + d], s[j]);
          dp[j] = fmaf(od, sV[c * LD + d], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = j * kLanes + lane;
        const int ks = a.kseg != nullptr ? sSeg[c] : 0;
        float ds = 0.f;
        if (row_ok && pair_ok(qi, k0 + c, a, qs, ks)) {
          const float p = expf(s[j] * a.scale - lse_r);
          ds = p * (dp[j] - delta_r) * a.scale;
        }
        sDS[r * kLDP + c] = ds;
      }
      __syncwarp();  // a row's four threads share one warp
      for (int c = 0; c < kTile; ++c) {
        const float dsv = sDS[r * kLDP + c];
        const float* krow = sK + c * LD;
#pragma unroll
        for (int i = 0; i < kAcc; ++i)
          acc[i] = fmaf(dsv, krow[i * kLanes + lane], acc[i]);
      }
    }
  }

  if (row_ok) {
    float* out = dq + (((size_t)b * a.Tq + qi) * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) out[i * kLanes + lane] = acc[i];
  }
}

// K4: grid (ceil(Tk / 64), H_kv, B)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const BwdArgs a, float* __restrict__ dk,
                     float* __restrict__ dv) {
  constexpr int LD = D + 1;
  constexpr int kAcc = D / kLanes;
  extern __shared__ float smem[];
  float* sK = smem;               // [kTile][LD]
  float* sV = sK + kTile * LD;    // [kTile][LD]
  float* sQ = sV + kTile * LD;    // [kTile][LD]
  float* sDO = sQ + kTile * LD;   // [kTile][LD]
  float* sP = sDO + kTile * LD;   // [kTile keys][kLDP]
  float* sDS = sP + kTile * kLDP; // [kTile keys][kLDP]
  float* sLse = sDS + kTile * kLDP;
  float* sDelta = sLse + kTile;
  int* sSeg = reinterpret_cast<int*>(sDelta + kTile);

  const int b = blockIdx.z, hk = blockIdx.y;
  const int group = a.H / a.Hkv;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int c = tid / kLanes, lane = tid % kLanes;
  const int kj = k0 + c;
  const bool key_ok = kj < a.Tk;

  load_tile<D>(sK, k, k0, a.Tk, b, a.Hkv, hk);
  load_tile<D>(sV, v, k0, a.Tk, b, a.Hkv, hk);
  const int ks =
      (a.kseg != nullptr && key_ok) ? a.kseg[(size_t)b * a.Tk + kj] : 0;

  float dk_acc[kAcc], dv_acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // local queries that can see any valid key of this tile: [q_lo, q_hi]
  const int k_last = min(k0 + kTile, a.k_len) - 1;
  int q_lo = 0, q_hi = a.Tq - 1;
  if (a.causal) q_lo = max(0, a.k_off + k0 - a.q_off);
  if (a.window > 0)
    q_hi = min(q_hi, a.k_off + k_last + (a.window - 1) - a.q_off);

  if (k0 < a.k_len && q_lo <= q_hi) {
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      const size_t stat0 = ((size_t)b * a.H + h) * a.Tq;
      for (int it = q_lo / kTile; it <= q_hi / kTile; ++it) {
        const int q0 = it * kTile;
        __syncthreads();  // the previous tile's readers are done
        load_tile<D>(sQ, q, q0, a.Tq, b, a.H, h);
        load_tile<D>(sDO, dout, q0, a.Tq, b, a.H, h);
        if (tid < kTile) {
          const int t = q0 + tid;
          const bool ok = t < a.Tq;
          sLse[tid] = ok ? a.lse[stat0 + t] : 0.f;
          sDelta[tid] = ok ? a.delta[stat0 + t] : 0.f;
          sSeg[tid] = (a.qseg != nullptr && ok)
                          ? a.qseg[(size_t)b * a.Tq + t] : 0;
        }
        __syncthreads();

        float s[kCols], dp[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float kd = sK[c * LD + d];
          const float vd = sV[c * LD + d];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int r = j * kLanes + lane;
            s[j] = fmaf(kd, sQ[r * LD + d], s[j]);
            dp[j] = fmaf(vd, sDO[r * LD + d], dp[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int r = j * kLanes + lane, qi = q0 + r;
          float p = 0.f, ds = 0.f;
          if (key_ok && qi < a.Tq && pair_ok(qi, kj, a, sSeg[r], ks)) {
            p = expf(s[j] * a.scale - sLse[r]);
            ds = p * (dp[j] - sDelta[r]) * a.scale;
          }
          sP[c * kLDP + r] = p;
          sDS[c * kLDP + r] = ds;
        }
        __syncwarp();  // a key row's four threads share one warp
        for (int r = 0; r < kTile; ++r) {
          const float pv = sP[c * kLDP + r];
          const float dsv = sDS[c * kLDP + r];
          const float* orow = sDO + r * LD;
          const float* qrow = sQ + r * LD;
#pragma unroll
          for (int i = 0; i < kAcc; ++i) {
            dv_acc[i] = fmaf(pv, orow[i * kLanes + lane], dv_acc[i]);
            dk_acc[i] = fmaf(dsv, qrow[i * kLanes + lane], dk_acc[i]);
          }
        }
      }
    }
  }

  if (key_ok) {
    const size_t off = (((size_t)b * a.Tk + kj) * a.Hkv + hk) * D;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      dk[off + i * kLanes + lane] = dk_acc[i];
      dv[off + i * kLanes + lane] = dv_acc[i];
    }
  }
}

struct BwdPtrs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  float* dq;  // K3's output
  float* dk;  // K4's outputs
  float* dv;
};

template <int D>
cudaError_t launch(bool dq_pass, const BwdPtrs& p, const BwdArgs& a, int B,
                   cudaStream_t stream) {
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);
  // above 48 KB of dynamic shared memory; the attribute belongs to the
  // current device, so it is set on every launch (a host-side call)
  if (dq_pass) {
    constexpr size_t smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Tq + kTile - 1) / kTile, a.H, B);
    flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, a, p.dq);
  } else {
    constexpr size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Tk + kTile - 1) / kTile, a.Hkv, B);
    flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, a, p.dk, p.dv);
  }
  return cudaGetLastError();
}

cudaError_t launch_d(int D, bool dq_pass, const BwdPtrs& p,
                     const BwdArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 8:
      return launch<8>(dq_pass, p, a, B, stream);
    case 16:
      return launch<16>(dq_pass, p, a, B, stream);
    case 32:
      return launch<32>(dq_pass, p, a, B, stream);
    case 64:
      return launch<64>(dq_pass, p, a, B, stream);
    case 128:
      return launch<128>(dq_pass, p, a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(bool dq_pass, const BwdPtrs& p, const void* lse, const void* delta,
        const void* qseg, const void* kseg, int B, int Tq, int Tk, int k_len,
        int H, int Hkv, int D, int q_off, int k_off, int causal, int window,
        float scale, int dtype, void* stream) {
  if (dtype != kFloat32 || B <= 0 || Tq <= 0 || Tk <= 0 || k_len < 0 ||
      k_len > Tk || H <= 0 || Hkv <= 0 || H % Hkv ||
      (qseg == nullptr) != (kseg == nullptr))
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.Tq = Tq;
  a.Tk = Tk;
  a.k_len = k_len;
  a.H = H;
  a.Hkv = Hkv;
  a.q_off = q_off;
  a.k_off = k_off;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return launch_d(D, dq_pass, p, a, B, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace tpu_torch

// q/do [B,Tq,H,D], k/v [B,Tk,H_kv,D] (float32, contiguous),
// lse/delta [B,H,Tq] float32, qseg [B,Tq] / kseg [B,Tk] int32 or both
// null, dq [B,Tq,H,D] float32.  Keys at local index >= k_len are
// masked; window <= 0 means no window.  Returns cudaGetLastError().
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* qseg,
                            const void* kseg, void* dq, int B, int Tq, int Tk,
                            int k_len, int H, int Hkv, int D, int q_off,
                            int k_off, int causal, int window, float scale,
                            int dtype, void* stream) {
  tpu_torch::BwdPtrs p{q, k, v, dout, static_cast<float*>(dq), nullptr,
                       nullptr};
  return tpu_torch::run(true, p, lse, delta, qseg, kseg, B, Tq, Tk, k_len, H,
                        Hkv, D, q_off, k_off, causal, window, scale, dtype,
                        stream);
}

// As flash_bwd_dq, writing dk and dv [B,Tk,H_kv,D] float32.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* qseg,
                             const void* kseg, void* dk, void* dv, int B,
                             int Tq, int Tk, int k_len, int H, int Hkv, int D,
                             int q_off, int k_off, int causal, int window,
                             float scale, int dtype, void* stream) {
  tpu_torch::BwdPtrs p{q,       k,       v, dout, nullptr,
                       static_cast<float*>(dk), static_cast<float*>(dv)};
  return tpu_torch::run(false, p, lse, delta, qseg, kseg, B, Tq, Tk, k_len,
                        H, Hkv, D, q_off, k_off, causal, window, scale, dtype,
                        stream);
}
