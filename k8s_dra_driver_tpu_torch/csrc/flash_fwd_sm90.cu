// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16
// inputs: K1's bf16 route.
//
// Replaces, for bf16, the TPU kernel `_flash_kernel` of
// k8s_dra_driver_tpu/ops/flash_attention.py (launched by
// `_flash_block_attention`, entered through `flash_attention` ->
// `_flash_forward`).  The contract is flash_fwd.cu's, which keeps the
// f32 route: q [B,T,H,D], k/v [B,T,H_kv,D] bf16, D 8, 16, 32, 64 or
// 128, GQA by head index, causal, a sliding window, int32 segment ids; the
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
//
// Small head dims (D = 8, 16, 32: the JAX package's probe models) run
// the D = 64 tiles with columns D..63 zero in shared memory: the block
// zeroes its tiles once before its first copy, and the copies fill only
// the D real columns, so no padded q, k or v exists in global memory.
// S sums the ceil(D / 16) k16 steps that hold real columns (at D = 8 the
// one step's upper half is zero, which adds exact zeros), P V runs its
// 64 columns and the epilogue stores the first D.  The scale is the
// caller's, D ** -0.5 of the real D.  Same shared memory and registers
// as D = 64; at these dims a prompt fill is a few microseconds and the
// wasted tensor-core columns do not bound it.
//
// The block entry (`flash_fwd_block_tc`) is the same kernel in a second
// mode: the port of `flash_block_attention`, q [B,Tq,H,D] against one
// K/V block [B,Tk,Hkv,D] at absolute positions q_off / k_off (a ring
// hop), with separate q and k segment ids.  Masks and the key-tile range
// compare absolute positions (q_off + i against k_off + j); the result is
// the unnormalized accumulator o [B,Tq,H,D] f32 with the running max m
// and sum l [B,H,Tq] f32, which `merge_flash_stats` folds across hops.
// A q tile whose rows see no key of the block loads no key tile and
// still writes its rows: m = -1e30, l = 0, o = 0, as the TPU kernel
// leaves them.  The mode is a template parameter (kBlock): the
// normalized entry's instantiation reads q's length and segment ids for
// the keys, a zero offset shift and its own epilogue, the code it was
// before the block mode existed (same registers, same time, PERF.md).
// Bound at the ring's hop shape (B=8 Tq=Tk=1024 H=16 Hkv=4 D=64): a full
// hop (every pair valid) is 4*B*H*Tq*Tk*D = 34.4 GFLOP, 34.7 us of the
// tensor cores' bf16 rate, against 17.8 us for its bytes (q, k, v read
// in bf16, o, m, l written in f32): the tensor cores bound it.  The
// diagonal hop does half the pairs, 17.4 us of operations, so its 17.8 us
// of bytes bound it, barely.
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
  const bf16* q;     // [B, Tq, H, D]
  const bf16* k;     // [B, Tk, Hkv, D]
  const bf16* v;
  const int* qseg;   // [B, Tq] or null
  const int* kseg;   // [B, Tk], null exactly when qseg is
  void* out;         // normalized: [B, Tq, H, D], bf16 or f32 (out_f32);
                     // block mode: o [B, Tq, H, D] f32, unnormalized
  float* lse;        // normalized: lse [B, H, Tq]; block mode: m
  float* l;          // block mode: l [B, H, Tq]; null when normalized
  int B, Tq, Tk, H, Hkv, q_off, k_off, causal, window, out_f32;
  float scale;
};

// columns a tile holds in shared memory: D, or 64 (zero past D) for
// the small head dims
template <int D>
__host__ __device__ constexpr int tile_cols() {
  return D < 64 ? 64 : D;
}

template <int D>
__host__ __device__ constexpr int q_bytes() {
  return kTileQ * tile_cols<D>() * 2;
}

template <int D>
__host__ __device__ constexpr int kv_bytes() {
  return kTileK * tile_cols<D>() * 2;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q; per stage K, V and the keys' segments; alignment slack
  return (size_t)q_bytes<D>() + kStages * 2 * kv_bytes<D>() +
         kStages * kTileK * 4 + 1024;
}

// The key block's length and segment ids: the block entry's own, or in
// the normalized entry (Tq = Tk, one segment array) q's, read from q's
// fields so that this instantiation reads what the kernel read before
// the block mode existed.
template <bool kBlock>
__device__ __forceinline__ int key_len(const FwdArgs& a) {
  return kBlock ? a.Tk : a.Tq;
}

template <bool kBlock>
__device__ __forceinline__ const int* key_seg(const FwdArgs& a) {
  return kBlock ? a.kseg : a.qseg;
}

// local query qi sees local key kj: causal and window by absolute
// position (shift = q_off - k_off: qi + shift is qi's position in the
// key block), keys past the block dropped, segments compared by the
// caller's ids
template <bool kBlock>
__device__ __forceinline__ bool pair_ok(int qi, int kj, const FwdArgs& a,
                                        int shift, int qs, int ks) {
  if (kj >= key_len<kBlock>(a)) return false;
  const int qk = qi + shift;
  if (a.causal && kj > qk) return false;
  if (a.window > 0 && qk - kj >= a.window) return false;
  if (key_seg<kBlock>(a) != nullptr && qs != ks) return false;
  return true;
}

// whether some pair of the q tile at q0 and the key tile at k0 (local
// starts) needs a mask
template <bool kBlock>
__device__ __forceinline__ bool tile_masked(int q0, int k0,
                                            const FwdArgs& a, int shift) {
  if (key_seg<kBlock>(a) != nullptr || k0 + kTileK > key_len<kBlock>(a))
    return true;
  const int qk0 = q0 + shift;
  if (a.causal && k0 + kTileK - 1 > qk0) return true;
  if (a.window > 0 && qk0 + kTileQ - 1 - k0 >= a.window) return true;
  return false;
}

// rows [q0, q0 + 64) of head h of q, scaled in f32 and rounded to bf16,
// into the swizzled tile at dst (D / 64 sub-tiles); rows past Tq are 0
template <int D>
__device__ __forceinline__ void load_q_scaled(uint8_t* dst, const FwdArgs& a,
                                              int q0, int b, int h) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kN = kTileQ * kChunks;  // 64 at D = 8: half the threads
#pragma unroll
  for (int j = 0; j < (kN + kThreads - 1) / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (kN % kThreads != 0 && e >= kN) break;
    const int r = e / kChunks, c = e % kChunks, t = q0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (t < a.Tq)
      x = *reinterpret_cast<const uint4*>(
          a.q + (((size_t)b * a.Tq + t) * a.H + h) * D + c * 8);
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
// shared address dst (D / 64 sub-tiles of 128 rows); zeros past Tk
template <int D, bool kBlock>
__device__ __forceinline__ void load_kv_tile(uint32_t dst,
                                             const bf16* __restrict__ x,
                                             int t0, const FwdArgs& a, int b,
                                             int hk) {
  constexpr int kChunks = D / 8;
  const int tk = key_len<kBlock>(a);
#pragma unroll
  for (int j = 0; j < kTileK * kChunks / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / kChunks, c = e % kChunks, t = t0 + r;
    const bool ok = t < tk;
    const bf16* src =
        x + (((size_t)b * tk + (ok ? t : 0)) * a.Hkv + hk) * D + c * 8;
    sm90::cp16(dst + (c / 8) * kKSub + sm90::swz(r, c % 8), src, ok);
  }
}

// kBlock: the block entry (offsets, unnormalized statistics); else the
// normalized entry (offsets 0, Tq = Tk)
template <int D, bool kBlock>
__global__ void __launch_bounds__(kThreads)
flash_fwd_sm90_kernel(const FwdArgs a) {
  constexpr int kSub = tile_cols<D>() / 64;  // 64-column sub-tiles
  constexpr int kK = (D + 15) / 16;          // k16 steps of S over D
  constexpr int kN8 = D < 64 ? D / 8 : 8;    // 8-column groups stored
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sKV = base + q_bytes<D>();  // stage s: K, then V
  const uint32_t sSeg = sKV + kStages * 2 * kv_bytes<D>();
  const int* segs = reinterpret_cast<const int*>(gbase + (sSeg - base));

  const int n_qt = (a.Tq + kTileQ - 1) / kTileQ;
  int bid = blockIdx.x;
  const int h = bid % a.H;
  bid /= a.H;
  const int b = bid % a.B;
  const int q0 = (n_qt - 1 - bid / a.B) * kTileQ;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // rows r0, r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);        // columns 8 n + c0 + {0, 1}

  if constexpr (D < 64) {  // the columns past D stay zero from here on
    uint4* tiles = reinterpret_cast<uint4*>(gbase);
    for (int i = tid; i < (q_bytes<D>() + kStages * 2 * kv_bytes<D>()) / 16;
         i += kThreads)
      tiles[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  // local key tiles any row of this q tile can see, by absolute
  // position: [k_lo, k_hi] clipped to the block.  In the normalized mode
  // there is at least one (each row sees itself); in block mode a hop
  // above the diagonal or behind the window has none, and the rows are
  // written with nothing accumulated.
  const int shift = kBlock ? a.q_off - a.k_off : 0;
  const int tk = key_len<kBlock>(a);
  const int* kseg_ids = key_seg<kBlock>(a);
  const int q_last = min(q0 + kTileQ, a.Tq) - 1;
  const int k_hi =
      a.causal ? (kBlock ? min(q_last + shift, tk - 1) : q_last) : tk - 1;
  const int k_lo = a.window > 0 ? max(0, q0 + shift - (a.window - 1)) : 0;
  const int kt0 = k_lo / kTileK;
  const int n_it = (kBlock && k_hi < k_lo) ? 0 : k_hi / kTileK - kt0 + 1;

  auto load_kv = [&](int stage, int kt) {
    const uint32_t dst = sKV + stage * 2 * kv_bytes<D>();
    load_kv_tile<D, kBlock>(dst, a.k, kt * kTileK, a, b, hk);
    load_kv_tile<D, kBlock>(dst + kv_bytes<D>(), a.v, kt * kTileK, a, b, hk);
    if (kseg_ids != nullptr) {
      const int t = kt * kTileK + tid;
      const bool ok = t < tk;
      sm90::cp4(sSeg + stage * kTileK * 4 + 4 * tid,
                kseg_ids + (size_t)b * tk + (ok ? t : 0), ok);
    }
  };
  if (!kBlock || n_it > 0) {
    load_kv(0, kt0);
    sm90::cp_commit();
  }
  load_q_scaled<D>(gbase, a, q0, b, h);

  int qs[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + 8 * rr;
    qs[rr] =
        (a.qseg != nullptr && qi < a.Tq) ? a.qseg[(size_t)b * a.Tq + qi] : 0;
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
    const bool masked = tile_masked<kBlock>(q0, k0, a, shift);
    if (masked) {
      const int* kseg = segs + st * kTileK;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + c0 + c;
          const int ks = kseg_ids != nullptr ? kseg[col] : 0;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            if (!pair_ok<kBlock>(q0 + r0 + 8 * rr, k0 + col, a, shift, qs[rr],
                                 ks))
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
    if (qi >= a.Tq) continue;
    const size_t row = (((size_t)b * a.Tq + qi) * a.H + h) * D;
    const size_t stat = ((size_t)b * a.H + h) * a.Tq + qi;
    if constexpr (kBlock) {  // the running statistics as they are
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
        for (int n = 0; n < kN8; ++n)
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + row +
                                     sub * 64 + 8 * n + c0) =
              make_float2(o[sub][4 * n + 2 * rr], o[sub][4 * n + 2 * rr + 1]);
      if (lane % 4 == 0) {
        a.lse[stat] = m[rr];
        a.l[stat] = l[rr];
      }
      continue;
    }
    const float lc = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
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
    if (lane % 4 == 0) a.lse[stat] = __fadd_rn(m[rr], logf(lc));
  }
}

template <int D, bool kBlock>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory; the attribute belongs to the
  // current device, so it is set on every launch (a host-side call)
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D, kBlock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.Tq + kTileQ - 1) / kTileQ * a.H * a.B;
  flash_fwd_sm90_kernel<D, kBlock><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const FwdArgs& a, int D, cudaStream_t stream) {
  if (a.B <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.H <= 0 || a.Hkv <= 0 ||
      a.H % a.Hkv)
    return cudaErrorInvalidValue;
  // q is read and K/V copied in 16-byte chunks
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v)) &
      15)
    return cudaErrorMisalignedAddress;
  const bool block = a.l != nullptr;
  switch (D) {
    case 8:
      return block ? launch<8, true>(a, stream) : launch<8, false>(a, stream);
    case 16:
      return block ? launch<16, true>(a, stream) : launch<16, false>(a, stream);
    case 32:
      return block ? launch<32, true>(a, stream) : launch<32, false>(a, stream);
    case 64:
      return block ? launch<64, true>(a, stream) : launch<64, false>(a, stream);
    case 128:
      return block ? launch<128, true>(a, stream)
                   : launch<128, false>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (out_dtype != kFloat32 && out_dtype != kBFloat16)
    return cudaErrorInvalidValue;
  FwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.qseg = a.kseg = static_cast<const int*>(seg);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.l = nullptr;
  a.B = B;
  a.Tq = a.Tk = seq;
  a.H = H;
  a.Hkv = Hkv;
  a.q_off = a.k_off = 0;
  a.causal = causal;
  a.window = window;
  a.out_f32 = out_dtype == kFloat32;
  a.scale = scale;
  return dispatch(a, D, static_cast<cudaStream_t>(stream));
}

// The block entry (flash_fwd_block's contract, flash_fwd.cu) for
// bfloat16 inputs: q [B,Tq,H,D] against k/v [B,Tk,Hkv,D] at absolute
// offsets q_off / k_off; qseg [B,Tq] and kseg [B,Tk] int32, both or
// neither; writes o [B,Tq,H,D], m and l [B,H,Tq], all float32.  dtype is
// the inputs' code and must be bfloat16's.  Returns cudaGetLastError().
extern "C" int flash_fwd_block_tc(const void* q, const void* k, const void* v,
                                  const void* qseg, const void* kseg, void* o,
                                  void* m, void* l, int B, int Tq, int Tk,
                                  int H, int Hkv, int D, int q_off, int k_off,
                                  int causal, int window, float scale,
                                  int dtype, void* stream) {
  using namespace tpu_torch;
  if (dtype != kBFloat16 || (qseg == nullptr) != (kseg == nullptr) ||
      m == nullptr || l == nullptr)
    return cudaErrorInvalidValue;
  FwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.out = o;
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
  a.out_f32 = 1;
  a.scale = scale;
  return dispatch(a, D, static_cast<cudaStream_t>(stream));
}
