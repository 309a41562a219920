// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16
// inputs: K1's bf16 route.
//
// Replaces, for bf16, the TPU kernel `_flash_kernel` of
// k8s_dra_driver_tpu/ops/flash_attention.py (launched by
// `_flash_block_attention`, entered through `flash_attention` ->
// `_flash_forward`).  The contract is flash_fwd.cu's, which keeps the
// f32 route: q [B,T,H,D], k/v [B,T,H_kv,D] bf16, D 64 or 128, GQA by
// head index, causal, a sliding window, int32 segment ids; the
// normalized output (bf16, or f32 before its final rounding) and the
// f32 lse [B,H,T].
//
// It rounds where the TPU kernel rounds, and so does its plain version
// `flash_forward_reference`:
//   q' = bf16(q * scale)                       (the scale folded into q)
//   per key tile of kTileK, from key 0, with the running max m and
//   sum l in f32 (m starts at -1e30, masked scores are -1e30):
//     m_new = max(m, rowmax(s)),  p = mask ? exp(s - m_new) : 0
//     l = l * exp(m - m_new) + rowsum(p)
//     o = o * exp(m - m_new) + bf16(p) v      (p rounded before p.v)
//   out = o / max(l, 1e-30),  lse = m + log(max(l, 1e-30)).
// A bf16 step of p is 2^-8 of it, so an f32 value one unit in the last
// place away from the plain version's may move one term of o.  So p is
// formed with the plain version's operations (expf of s - m_new, every
// operation rounded on its own, no fused multiply-add), q' with an
// f32 multiply rounded to nearest, and on the card the plain version
// sums its bf16 scores on the tensor cores in the kernel's k16 order.
// The running max depends on the key partition, so the plain version
// walks the keys in blocks of this kernel's tile (`FWD_BLOCK_K`).
//
// Bound.  At the 154M training shape (B=8 T=2048 H=16 Hkv=4 D=64,
// causal) it does 2 products of 2*D flops per valid (q, k) pair,
// 6.9e10 flops: 70 us of the card's 989 TFLOP/s bf16, against 13 us
// for its bytes.  So the tensor cores bound it, and the design keeps
// them fed (the FlashAttention-3 shape, on one warpgroup):
//   - One block of one warpgroup (128 threads) per (64-row q tile,
//     head, batch), flat index, late q tiles (the most keys under a
//     causal mask) first.
//   - S = Q K^T is one wgmma m64n128k16 per k16 step of D, both
//     operands K-major in the 128-byte swizzle; O += P V is wgmma
//     m64n64k16 with P in registers (the A operand) and V read
//     MN-major through the transpose bit, D = 128 as two 64-column
//     halves.  p is rounded and packed to bf16 in registers and never
//     passes through shared memory.
//   - The online softmax runs on the f32 accumulator fragments: each
//     thread holds two rows' 32 scores of a tile; row max and sum are
//     finished across the four threads of a row by shuffles.
//   - Q is loaded once, scaled in f32 and rounded to bf16 on its way
//     into its swizzled tile.  K and V stream through a two-stage
//     cp.async ring: the next tile's copies are in flight while the
//     current one is multiplied, zero-filled past T, so ragged prefill
//     lengths need no padding.  cp.async rather than TMA, as in
//     flash_bwd_sm90.cu: a tile is a [128, D] slice of a strided
//     [B, T, H_kv, D] tensor, written straight into the swizzle.
//   - Key tiles wholly above the causal diagonal or behind the window
//     are never loaded; inside a tile, pairs are masked by position,
//     T and segments only where the tile needs it.
// Shared memory 74 KB at D = 64 (three blocks an SM), 146 KB at
// D = 128 (one).
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace tpu_torch {
namespace {

using bf16 = __nv_bfloat16;
using sm90::kRowBytes;

constexpr int kTileQ = 64;     // query rows per block: one wgmma M
constexpr int kTileK = 128;    // keys per tile: S is one m64n128 product
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // ring of K/V tiles
constexpr float kNegInf = -1e30f;
constexpr int kQSub = kTileQ * kRowBytes;  // a [64][64] bf16 sub-tile
constexpr int kKSub = kTileK * kRowBytes;  // a [128][64] bf16 sub-tile

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* seg;  // [B, T] or null
  void* out;       // [B, T, H, D], bf16 or f32 (out_f32)
  float* lse;      // [B, H, T]
  int B, T, H, Hkv, causal, window, out_f32;
  float scale;
};

template <int D>
__host__ __device__ constexpr int q_bytes() {
  return kTileQ * D * 2;
}

template <int D>
__host__ __device__ constexpr int kv_bytes() {
  return kTileK * D * 2;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q; per stage K, V and the keys' segments; alignment slack
  return (size_t)q_bytes<D>() + kStages * 2 * kv_bytes<D>() +
         kStages * kTileK * 4 + 1024;
}

// query qi sees key kj (segments compared by the caller's ids)
__device__ __forceinline__ bool pair_ok(int qi, int kj, const FwdArgs& a,
                                        int qs, int ks) {
  if (kj >= a.T) return false;
  if (a.causal && kj > qi) return false;
  if (a.window > 0 && qi - kj >= a.window) return false;
  if (a.seg != nullptr && qs != ks) return false;
  return true;
}

// whether some pair of the q tile at q0 and the key tile at k0 needs a
// mask
__device__ __forceinline__ bool tile_masked(int q0, int k0,
                                            const FwdArgs& a) {
  if (a.seg != nullptr || k0 + kTileK > a.T) return true;
  if (a.causal && k0 + kTileK - 1 > q0) return true;
  if (a.window > 0 && q0 + kTileQ - 1 - k0 >= a.window) return true;
  return false;
}

// rows [q0, q0 + 64) of head h of q, scaled in f32 and rounded to bf16,
// into the swizzled tile at dst (D / 64 sub-tiles); rows past T are 0
template <int D>
__device__ __forceinline__ void load_q_scaled(uint8_t* dst, const FwdArgs& a,
                                              int q0, int b, int h) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < kTileQ * kChunks / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / kChunks, c = e % kChunks, t = q0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (t < a.T)
      x = *reinterpret_cast<const uint4*>(
          a.q + (((size_t)b * a.T + t) * a.H + h) * D + c * 8);
    uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair = *reinterpret_cast<__nv_bfloat162*>(&w[i]);
      w[i] = sm90::pack_bf16(__fmul_rn(__low2float(pair), a.scale),
                             __fmul_rn(__high2float(pair), a.scale));
    }
    *reinterpret_cast<uint4*>(dst + (c / 8) * kQSub + sm90::swz(r, c % 8)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// keys [t0, t0 + 128) of KV head hk of x into the swizzled tile at
// shared address dst (D / 64 sub-tiles of 128 rows); zeros past T
template <int D>
__device__ __forceinline__ void load_kv_tile(uint32_t dst,
                                             const bf16* __restrict__ x,
                                             int t0, const FwdArgs& a, int b,
                                             int hk) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int j = 0; j < kTileK * kChunks / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / kChunks, c = e % kChunks, t = t0 + r;
    const bool ok = t < a.T;
    const bf16* src =
        x + (((size_t)b * a.T + (ok ? t : 0)) * a.Hkv + hk) * D + c * 8;
    sm90::cp16(dst + (c / 8) * kKSub + sm90::swz(r, c % 8), src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_sm90_kernel(const FwdArgs a) {
  constexpr int kSub = D / 64;  // 64-column sub-tiles
  constexpr int kK = D / 16;    // k16 steps of S over D
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sKV = base + q_bytes<D>();  // stage s: K, then V
  const uint32_t sSeg = sKV + kStages * 2 * kv_bytes<D>();
  const int* segs = reinterpret_cast<const int*>(gbase + (sSeg - base));

  const int n_qt = (a.T + kTileQ - 1) / kTileQ;
  int bid = blockIdx.x;
  const int h = bid % a.H;
  bid /= a.H;
  const int b = bid % a.B;
  const int q0 = (n_qt - 1 - bid / a.B) * kTileQ;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // rows r0, r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);        // columns 8 n + c0 + {0, 1}

  // key tiles any row of this q tile can see (at least one: each row
  // sees itself, or every key without a causal mask)
  const int q_last = min(q0 + kTileQ, a.T) - 1;
  const int k_hi = a.causal ? q_last : a.T - 1;
  const int k_lo = a.window > 0 ? max(0, q0 - (a.window - 1)) : 0;
  const int kt0 = k_lo / kTileK;
  const int n_it = k_hi / kTileK - kt0 + 1;

  auto load_kv = [&](int stage, int kt) {
    const uint32_t dst = sKV + stage * 2 * kv_bytes<D>();
    load_kv_tile<D>(dst, a.k, kt * kTileK, a, b, hk);
    load_kv_tile<D>(dst + kv_bytes<D>(), a.v, kt * kTileK, a, b, hk);
    if (a.seg != nullptr) {
      const int t = kt * kTileK + tid;
      const bool ok = t < a.T;
      sm90::cp4(sSeg + stage * kTileK * 4 + 4 * tid,
                a.seg + (size_t)b * a.T + (ok ? t : 0), ok);
    }
  };
  load_kv(0, kt0);
  sm90::cp_commit();
  load_q_scaled<D>(gbase, a, q0, b, h);

  int qs[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + 8 * rr;
    qs[rr] = (a.seg != nullptr && qi < a.T) ? a.seg[(size_t)b * a.T + qi] : 0;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kSub][32];
#pragma unroll
  for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[sub][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    if (it + 1 < n_it) {
      load_kv((it + 1) % kStages, kt0 + it + 1);
      sm90::cp_commit();
      sm90::cp_wait<1>();
    } else {
      sm90::cp_wait<0>();
    }
    sm90::fence_async_smem();  // cp.async and Q's stores, for wgmma
    __syncthreads();
    const int k0 = (kt0 + it) * kTileK;
    const uint32_t sK = sKV + st * 2 * kv_bytes<D>(), sV = sK + kv_bytes<D>();

    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
      sm90::mma_ss_n128<0>(
          s, sm90::desc(sQ + (kk / 4) * kQSub + (kk % 4) * 32),
          sm90::desc(sK + (kk / 4) * kKSub + (kk % 4) * 32), kk > 0);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::reg_fence(s);

    // s[4 n + 2 rr + c]: row r0 + 8 rr, key k0 + 8 n + c0 + c
    const bool masked = tile_masked(q0, k0, a);
    if (masked) {
      const int* kseg = segs + st * kTileK;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + c0 + c;
          const int ks = a.seg != nullptr ? kseg[col] : 0;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            if (!pair_ok(q0 + r0 + 8 * rr, k0 + col, a, qs[rr], ks))
              s[4 * n + 2 * rr + c] = kNegInf;
        }
    }
    float mx[2] = {m[0], m[1]};  // becomes m_new = max(m, rowmax(s))
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      corr[rr] = expf(__fsub_rn(m[rr], mx[rr]));
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int rr = (i >> 1) & 1;
      // a masked pair is -1e30, which no score reaches
      const float p = (masked && s[i] == kNegInf)
                          ? 0.f
                          : expf(__fsub_rn(s[i], mx[rr]));
      s[i] = p;
      psum[rr] = __fadd_rn(psum[rr], p);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      psum[rr] = __fadd_rn(psum[rr],
                           __shfl_xor_sync(0xffffffffu, psum[rr], 1));
      psum[rr] = __fadd_rn(psum[rr],
                           __shfl_xor_sync(0xffffffffu, psum[rr], 2));
      l[rr] = __fadd_rn(__fmul_rn(l[rr], corr[rr]), psum[rr]);
      m[rr] = mx[rr];
    }
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[sub][i] = __fmul_rn(o[sub][i], corr[(i >> 1) & 1]);
    uint32_t pf[8][4];  // bf16(p) as the A operand, one per k16 of keys
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pf[kk][j] = sm90::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    sm90::wg_fence();
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        sm90::mma_rs_t(o[sub], pf[kk],
                       sm90::desc(sV + sub * kKSub + kk * 16 * kRowBytes));
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) sm90::reg_fence(o[sub]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) sm90::reg_fence(pf[kk]);
    __syncthreads();  // stage st is refilled next iteration
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + 8 * rr;
    if (qi >= a.T) continue;
    const float lc = fmaxf(l[rr], 1e-30f);
    const size_t row = (((size_t)b * a.T + qi) * a.H + h) * D;
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = sub * 64 + 8 * n + c0;
        const float x0 = __fdiv_rn(o[sub][4 * n + 2 * rr], lc);
        const float x1 = __fdiv_rn(o[sub][4 * n + 2 * rr + 1], lc);
        if (a.out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + row + col) =
              make_float2(x0, x1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + row +
                                       col) = sm90::pack_bf16(x0, x1);
      }
    if (lane % 4 == 0)
      a.lse[((size_t)b * a.H + h) * a.T + qi] = __fadd_rn(m[rr], logf(lc));
  }
}

template <int D>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory; the attribute belongs to the
  // current device, so it is set on every launch (a host-side call)
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.T + kTileQ - 1) / kTileQ * a.H * a.B;
  flash_fwd_sm90_kernel<D><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpu_torch

// flash_fwd's contract (flash_fwd.cu) for bfloat16 inputs only, q, k
// and v 16-byte aligned; out_dtype is the output's dtype code (float32
// or bfloat16).  Returns cudaGetLastError().
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v,
                            const void* seg, void* out, void* lse, int B,
                            int seq, int H, int Hkv, int D, int causal,
                            int window, float scale, int out_dtype,
                            void* stream) {
  using namespace tpu_torch;
  if (B <= 0 || seq <= 0 || H <= 0 || Hkv <= 0 || H % Hkv ||
      (out_dtype != kFloat32 && out_dtype != kBFloat16))
    return cudaErrorInvalidValue;
  // q is read and K/V copied in 16-byte chunks
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) &
      15)
    return cudaErrorMisalignedAddress;
  FwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.seg = static_cast<const int*>(seg);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.T = seq;
  a.H = H;
  a.Hkv = Hkv;
  a.causal = causal;
  a.window = window;
  a.out_f32 = out_dtype == kFloat32;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(a, st);
    case 128:
      return launch<128>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}
