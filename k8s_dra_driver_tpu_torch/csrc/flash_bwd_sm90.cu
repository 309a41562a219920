// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16
// inputs: K3 (dq) and K4 (dk, dv).
//
// Replaces, for bf16, the TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` of k8s_dra_driver_tpu/ops/flash_attention.py
// (both launched by `flash_block_grads`, with the score recompute
// `_bwd_common`).  The contract is flash_bwd.cu's, which keeps the f32
// route: q/do [B,Tq,H,D], k/v [B,Tk,H_kv,D] bf16, lse/delta [B,H,Tq]
// f32, absolute offsets q_off/k_off, a valid-key count k_len, causal,
// window, int32 segments, D 8, 16, 32, 64 or 128 with GQA; f32
// outputs.
//
//   p  = exp(q k^T * scale - lse)     (masked pairs: 0)
//   ds = p * (do v^T - delta) * scale
//   dq = bf16(ds) k                           (K3)
//   dv = bf16(p)^T do,  dk = bf16(ds)^T q     (K4, summed over the group)
//
// p and ds are rounded to bf16 before the second products, where the
// TPU kernels round them (`ds.astype(kf.dtype)`, `p.astype(dof.dtype)`,
// `ds.astype(qf.dtype)`); `flash_block_grads_reference` rounds there too.
// A bf16 step of ds is 2^-8 of it, so an f32 value one unit in the last
// place away from the plain version's can move one term of dq by about
// 1e-3 of max|dq| at the training shape.  So p and ds are formed as the
// plain version forms them (expf of s * scale - lse, ds = p * (dp -
// delta) * scale, every operation rounded on its own), and on the card
// the plain version sums its bf16 first products on the tensor cores in
// the kernels' k16 order.
//
// Bound.  At the training shape (B=8 T=2048 H=16 Hkv=4 D=64, causal)
// K3 does 3 and K4 4 products of 2*D flops per valid (q, k) pair: 104
// and 139 us of the card's 989 TFLOP/s bf16, against 25 and 20 us for
// their bytes.  So the tensor cores bound both, and the design keeps
// them fed:
//   - Every product is one warpgroup's wgmma m64n64k16, bf16 operands,
//     f32 accumulators.  K3: S = Q K^T, dP = dO V^T, dQ += dS K.  K4
//     computes the transposed scores, S^T = K Q^T and dP^T = V dO^T
//     (rows are keys, columns queries), so that P^T and dS^T come out in
//     the accumulator layout the next products, dV += P^T dO and
//     dK += dS^T Q, take as their register A operand: p and ds are
//     rounded and packed in registers and never pass through shared
//     memory.  lse and delta are read per accumulator row in K3 (two
//     rows a thread, once per block) and per column in K4 (from the
//     streamed stage).
//   - Tiles sit in shared memory as bf16 in the 128-byte swizzle that
//     wgmma reads: the first products read both operands K-major, the
//     second read K (K3), dO and Q (K4) MN-major through the transpose
//     bit.  D = 128 is two 64-column sub-tiles.
//   - Streamed tiles (K and V in K3; Q, dO, lse, delta and segments in
//     K4) are loaded with cp.async into a ring of two stages: the next
//     tile's copies are in flight while the current one is multiplied.
//     cp.async rather than TMA: a tile is a [64, D] slice of a strided
//     [B, T, H, D] tensor whose rows cp.async writes straight into the
//     swizzle, 16 bytes a thread, with a zero fill past the sequence
//     end; the warpgroup that multiplies also issues the copies, so no
//     tensor map has to be encoded on the host per call
//     (`cuTensorMapEncodeTiled`) and no producer warp or mbarrier ring
//     is needed.
//   - Ownership as in flash_bwd.cu, so the results are deterministic:
//     K3 owns a 64-row q tile and walks the k tiles its masks reach; K4
//     owns a 64-key tile of one KV head and walks the group's query
//     heads and the q tiles that reach it, summing the group inside the
//     block.  No atomics, no scratch reduced across blocks.  Tiles the
//     causal, window and offset bounds exclude are never loaded; inside
//     a tile, pairs are masked by absolute position, k_len and segments
//     only where the tile needs it.
//   - Heavy blocks first: under a causal mask K3's late q tiles and K4's
//     early key tiles walk the most tiles, so the flat block index puts
//     them at the front of the grid.
// One warpgroup of 128 threads per block, 64-row tiles; shared memory
// 49 KB (K3) / 51 KB (K4) at D = 64, twice that at D = 128.
//
// Small head dims (D = 8, 16, 32) run the D = 64 tiles with columns
// D..63 zero in shared memory, as flash_fwd_sm90.cu does: each block
// zeroes its tiles once before its first copy and the copies fill only
// the D real columns (no padded tensor in global memory).  The first
// products sum the ceil(D / 16) k16 steps that hold real columns (at
// D = 8 the step's upper half adds exact zeros), the second run their
// 64 columns, and the epilogues store the first D.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace tpu_torch {
namespace {

using bf16 = __nv_bfloat16;
using sm90::kRowBytes;

constexpr int kTile = 64;      // rows of every tile: one wgmma M or N
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // ring of streamed tiles
constexpr int kSubBytes = kTile * kRowBytes;  // one [64][64] bf16 tile

struct TcArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  const int* qseg;     // [B, Tq] or null
  const int* kseg;     // [B, Tk] or null (null iff qseg is)
  float* dq;
  float* dk;
  float* dv;
  int B, Tq, Tk, k_len, H, Hkv, q_off, k_off, causal, window;
  float scale;
};

// local query qi sees local key kj (segments compared by the caller's
// ids; ignored without segments)
__device__ __forceinline__ bool pair_ok(int qi, int kj, const TcArgs& a,
                                        int qs, int ks) {
  if (qi >= a.Tq || kj >= a.k_len) return false;
  const int qa = a.q_off + qi, ka = a.k_off + kj;
  if (a.causal && ka > qa) return false;
  if (a.window > 0 && qa - ka >= a.window) return false;
  if (a.qseg != nullptr && qs != ks) return false;
  return true;
}

// whether some pair of the q tile at q0 and the k tile at k0 needs a
// mask; past-the-end q rows count only where they could add to an
// output (K4)
__device__ __forceinline__ bool tile_masked(int q0, int k0, const TcArgs& a,
                                            bool ragged_q) {
  if (a.qseg != nullptr || k0 + kTile > a.k_len) return true;
  if (ragged_q && q0 + kTile > a.Tq) return true;
  const int qa = a.q_off + q0, ka = a.k_off + k0;
  if (a.causal && ka + kTile - 1 > qa) return true;
  if (a.window > 0 && qa + kTile - 1 - ka >= a.window) return true;
  return false;
}

// rows [t0, t0 + 64) of head hh of x [B, T, nh, D] into the swizzled
// tile at shared address dst (D / 64 sub-tiles); rows past T are zero
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const bf16* __restrict__ x, int t0,
                                          int T, int b, int nh, int hh) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kN = kTile * kChunks;  // 64 at D = 8: half the threads
#pragma unroll
  for (int j = 0; j < (kN + kThreads - 1) / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (kN % kThreads != 0 && e >= kN) break;
    const int r = e / kChunks, c = e % kChunks, t = t0 + r;
    const bool ok = t < T;
    const bf16* src =
        x + (((size_t)b * T + (ok ? t : 0)) * nh + hh) * D + c * 8;
    sm90::cp16(dst + (c / 8) * kSubBytes + sm90::swz(r, c % 8), src, ok);
  }
}

// 64 consecutive 4-byte entries x[t0 ...] (t < T) into shared address
// dst, by threads [first, first + 64); zeros past T
__device__ __forceinline__ void load_row(uint32_t dst, const void* x,
                                         int t0, int T, int first) {
  const int i = (int)threadIdx.x - first;
  if (i >= 0 && i < kTile) {
    const bool ok = t0 + i < T;
    sm90::cp4(dst + 4 * i,
              static_cast<const float*>(x) + (ok ? t0 + i : 0), ok);
  }
}

// a k16 step of a K-major operand: 32 bytes along the row, the second
// 64 columns in the second sub-tile
__device__ __forceinline__ uint32_t kstep(int kk) {
  return (kk / 4) * kSubBytes + (kk % 4) * 32;
}

// a k16 step down an MN-major operand's sub-tile: 16 rows
__device__ __forceinline__ uint32_t mnstep(int sub, int kk) {
  return sub * kSubBytes + kk * 16 * kRowBytes;
}

// columns a tile holds in shared memory: D, or 64 (zero past D) for
// the small head dims
template <int D>
__host__ __device__ constexpr int tile_cols() {
  return D < 64 ? 64 : D;
}

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * tile_cols<D>() * 2;
}

// the columns past D of every tile at base (n_tiles of them), zeroed
// once before the block's first copy: the copies fill only the D real
// columns, so the padding stays zero
template <int D>
__device__ __forceinline__ void zero_tiles(uint8_t* base, int n_tiles) {
  if constexpr (D < 64) {
    uint4* tiles = reinterpret_cast<uint4*>(base);
    for (int i = threadIdx.x; i < n_tiles * tile_bytes<D>() / 16;
         i += kThreads)
      tiles[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO; per stage K, V; per stage key segments; alignment slack
  return (size_t)(2 + 2 * kStages) * tile_bytes<D>() + kStages * kTile * 4 +
         1024;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V; per stage Q, dO; per stage lse, delta, query segments; slack
  return (size_t)(2 + 2 * kStages) * tile_bytes<D>() +
         kStages * 3 * kTile * 4 + 1024;
}

// p = exp(s * scale - lse) and ds = p * (dp - delta) * scale, each
// operation rounded on its own in the plain version's order (no fused
// multiply-add) and exp the full-precision expf: p and ds are rounded
// to bf16 next, and a last-bit difference here may move them to the
// neighbouring bf16 value
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}

__device__ __forceinline__ float dscore(float p, float dp, float delta,
                                        float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// zero accumulators, pinned before the next wgmma reads them
__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// K3: one block per (64-row q tile, head, batch), flat index, late q
// tiles first
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_sm90_kernel(const TcArgs a) {
  constexpr int kTB = tile_bytes<D>();
  constexpr int kSub = tile_cols<D>() / 64;  // 64-column sub-tiles
  constexpr int kK = (D + 15) / 16;          // k16 steps over D
  constexpr int kN8 = D < 64 ? D / 8 : 8;    // 8-column groups stored
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sDO = base + kTB;
  const uint32_t sKV = base + 2 * kTB;  // stage s: K, then V
  const uint32_t sSeg = sKV + kStages * 2 * kTB;
  const int* segs = reinterpret_cast<const int*>(gbase + (sSeg - base));

  const int n_qt = (a.Tq + kTile - 1) / kTile;
  int bid = blockIdx.x;
  const int h = bid % a.H;
  bid /= a.H;
  const int b = bid % a.B;
  const int q0 = (n_qt - 1 - bid / a.B) * kTile;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // columns 8 n + c0 + {0, 1}
  zero_tiles<D>(gbase, 2 + 2 * kStages);

  // local keys any row of this q tile can see: [k_lo, k_hi]
  const int q_last = min(q0 + kTile, a.Tq) - 1;
  int k_hi = a.k_len - 1;
  if (a.causal) k_hi = min(k_hi, a.q_off + q_last - a.k_off);
  const int k_lo =
      a.window > 0 ? max(0, a.q_off + q0 - (a.window - 1) - a.k_off) : 0;
  const int kt0 = k_lo / kTile;
  const int n_it = k_hi >= k_lo ? k_hi / kTile - kt0 + 1 : 0;

  auto load_kv = [&](int stage, int kt) {
    const uint32_t dst = sKV + stage * 2 * kTB;
    load_tile<D>(dst, a.k, kt * kTile, a.Tk, b, a.Hkv, hk);
    load_tile<D>(dst + kTB, a.v, kt * kTile, a.Tk, b, a.Hkv, hk);
    if (a.kseg != nullptr)
      load_row(sSeg + stage * kTile * 4, a.kseg + (size_t)b * a.Tk,
               kt * kTile, a.Tk, 0);
  };
  if (n_it > 0) {
    load_tile<D>(sQ, a.q, q0, a.Tq, b, a.H, h);
    load_tile<D>(sDO, a.dout, q0, a.Tq, b, a.H, h);
    load_kv(0, kt0);
    sm90::cp_commit();
  }

  float lse[2], dlt[2];
  int qs[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + 8 * rr;
    const bool ok = qi < a.Tq;
    const size_t stat = ((size_t)b * a.H + h) * a.Tq + qi;
    lse[rr] = ok ? a.lse[stat] : 0.f;
    dlt[rr] = ok ? a.delta[stat] : 0.f;
    qs[rr] = (a.qseg != nullptr && ok) ? a.qseg[(size_t)b * a.Tq + qi] : 0;
  }
  float acc[kSub][32];
#pragma unroll
  for (int s = 0; s < kSub; ++s) zero(acc[s]);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    if (it + 1 < n_it) {
      load_kv((it + 1) % kStages, kt0 + it + 1);
      sm90::cp_commit();
      sm90::cp_wait<1>();
    } else {
      sm90::cp_wait<0>();
    }
    sm90::fence_async_smem();
    __syncthreads();
    const int k0 = (kt0 + it) * kTile;
    const uint32_t sK = sKV + st * 2 * kTB, sV = sK + kTB;

    float s[32], dp[32];
    zero(s);
    zero(dp);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
      sm90::mma_ss(s, sm90::desc(sQ + kstep(kk)), sm90::desc(sK + kstep(kk)),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
      sm90::mma_ss(dp, sm90::desc(sDO + kstep(kk)),
                   sm90::desc(sV + kstep(kk)), kk > 0);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::reg_fence(s);
    sm90::reg_fence(dp);

    // ds into dp, in place
    const bool masked = tile_masked(q0, k0, a, false);
    const int* kseg = segs + st * kTile;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + c0 + c;
        const int ks = a.kseg != nullptr ? kseg[col] : 0;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * n + 2 * rr + c;
          float p = prob(s[i], a.scale, lse[rr]);
          if (masked && !pair_ok(q0 + r0 + 8 * rr, k0 + col, a, qs[rr], ks))
            p = 0.f;
          dp[i] = dscore(p, dp[i], dlt[rr], a.scale);
        }
      }
    }
    uint32_t frag[4][4];  // bf16(ds) as the A operand, one per k16 of keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        frag[kk][j] = sm90::pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);

    sm90::wg_fence();
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::mma_rs_t(acc[sub], frag[kk], sm90::desc(sK + mnstep(sub, kk)));
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) sm90::reg_fence(acc[sub]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::reg_fence(frag[kk]);
    __syncthreads();  // stage st is refilled next iteration
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + 8 * rr;
    if (qi >= a.Tq) continue;
    float* out = a.dq + (((size_t)b * a.Tq + qi) * a.H + h) * D;
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int n = 0; n < kN8; ++n)
        *reinterpret_cast<float2*>(out + sub * 64 + 8 * n + c0) =
            make_float2(acc[sub][4 * n + 2 * rr], acc[sub][4 * n + 2 * rr + 1]);
  }
}

// K4: one block per (64-key tile, KV head, batch), flat index, early
// key tiles first
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_sm90_kernel(const TcArgs a) {
  constexpr int kTB = tile_bytes<D>();
  constexpr int kSub = tile_cols<D>() / 64;
  constexpr int kK = (D + 15) / 16;
  constexpr int kN8 = D < 64 ? D / 8 : 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + kTB;
  const uint32_t sQO = base + 2 * kTB;  // stage s: Q, then dO
  const uint32_t sVec = sQO + kStages * 2 * kTB;  // stage s: lse, delta, seg
  const float* vecs = reinterpret_cast<const float*>(gbase + (sVec - base));

  const int group = a.H / a.Hkv;
  int bid = blockIdx.x;
  const int hk = bid % a.Hkv;
  bid /= a.Hkv;
  const int b = bid % a.B;
  const int k0 = (bid / a.B) * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // key rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // query columns 8 n + c0 + {0, 1}
  zero_tiles<D>(gbase, 2 + 2 * kStages);

  // local queries that can see any valid key of this tile: [q_lo, q_hi]
  const int k_last = min(k0 + kTile, a.k_len) - 1;
  int q_lo = 0, q_hi = a.Tq - 1;
  if (a.causal) q_lo = max(0, a.k_off + k0 - a.q_off);
  if (a.window > 0)
    q_hi = min(q_hi, a.k_off + k_last + (a.window - 1) - a.q_off);
  const int qt0 = q_lo / kTile;
  const int nq = (k0 < a.k_len && q_lo <= q_hi) ? q_hi / kTile - qt0 + 1 : 0;
  const int n_it = nq * group;  // (query head, q tile) pairs, heads outer

  auto load_q = [&](int stage, int item) {
    const int h = hk * group + item / nq;
    const int q0 = (qt0 + item % nq) * kTile;
    const uint32_t dst = sQO + stage * 2 * kTB;
    load_tile<D>(dst, a.q, q0, a.Tq, b, a.H, h);
    load_tile<D>(dst + kTB, a.dout, q0, a.Tq, b, a.H, h);
    const uint32_t vec = sVec + stage * 3 * kTile * 4;
    const size_t stat0 = ((size_t)b * a.H + h) * a.Tq;
    load_row(vec, a.lse + stat0, q0, a.Tq, 0);
    load_row(vec + kTile * 4, a.delta + stat0, q0, a.Tq, kTile);
    if (a.qseg != nullptr)
      load_row(vec + 2 * kTile * 4, a.qseg + (size_t)b * a.Tq, q0, a.Tq, 0);
  };
  if (n_it > 0) {
    load_tile<D>(sK, a.k, k0, a.Tk, b, a.Hkv, hk);
    load_tile<D>(sV, a.v, k0, a.Tk, b, a.Hkv, hk);
    load_q(0, 0);
    sm90::cp_commit();
  }

  int ks[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kj = k0 + r0 + 8 * rr;
    ks[rr] = (a.kseg != nullptr && kj < a.Tk) ? a.kseg[(size_t)b * a.Tk + kj]
                                              : 0;
  }
  float dk[kSub][32], dv[kSub][32];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    zero(dk[s]);
    zero(dv[s]);
  }

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    if (it + 1 < n_it) {
      load_q((it + 1) % kStages, it + 1);
      sm90::cp_commit();
      sm90::cp_wait<1>();
    } else {
      sm90::cp_wait<0>();
    }
    sm90::fence_async_smem();
    __syncthreads();
    const int q0 = (qt0 + it % nq) * kTile;
    const uint32_t sQ = sQO + st * 2 * kTB, sDO = sQ + kTB;
    const float* lse = vecs + st * 3 * kTile;
    const float* dlt = lse + kTile;
    const int* qseg = reinterpret_cast<const int*>(dlt + kTile);

    float s[32], dp[32];  // S^T and dP^T: rows keys, columns queries
    zero(s);
    zero(dp);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
      sm90::mma_ss(s, sm90::desc(sK + kstep(kk)), sm90::desc(sQ + kstep(kk)),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
      sm90::mma_ss(dp, sm90::desc(sV + kstep(kk)),
                   sm90::desc(sDO + kstep(kk)), kk > 0);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::reg_fence(s);
    sm90::reg_fence(dp);

    // p into s, ds into dp, in place
    const bool masked = tile_masked(q0, k0, a, true);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + c0 + c;
        const float lc = lse[col], dc = dlt[col];
        const int qs = a.qseg != nullptr ? qseg[col] : 0;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * n + 2 * rr + c;
          float p = prob(s[i], a.scale, lc);
          if (masked && !pair_ok(q0 + col, k0 + r0 + 8 * rr, a, qs, ks[rr]))
            p = 0.f;
          s[i] = p;
          dp[i] = dscore(p, dp[i], dc, a.scale);
        }
      }
    }
    uint32_t pf[4][4], dsf[4][4];  // bf16 P^T and dS^T, one per k16 of queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pf[kk][j] = sm90::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
        dsf[kk][j] =
            sm90::pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
      }

    sm90::wg_fence();
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::mma_rs_t(dv[sub], pf[kk], sm90::desc(sDO + mnstep(sub, kk)));
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::mma_rs_t(dk[sub], dsf[kk], sm90::desc(sQ + mnstep(sub, kk)));
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
      sm90::reg_fence(dk[sub]);
      sm90::reg_fence(dv[sub]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::reg_fence(pf[kk]);
      sm90::reg_fence(dsf[kk]);
    }
    __syncthreads();  // stage st is refilled next iteration
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kj = k0 + r0 + 8 * rr;
    if (kj >= a.Tk) continue;
    const size_t off = (((size_t)b * a.Tk + kj) * a.Hkv + hk) * D;
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub)
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
        const int col = sub * 64 + 8 * n + c0;
        const int i = 4 * n + 2 * rr;
        *reinterpret_cast<float2*>(a.dk + off + col) =
            make_float2(dk[sub][i], dk[sub][i + 1]);
        *reinterpret_cast<float2*>(a.dv + off + col) =
            make_float2(dv[sub][i], dv[sub][i + 1]);
      }
  }
}

template <int D>
cudaError_t launch(bool dq_pass, const TcArgs& a, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory; the attribute belongs to the
  // current device, so it is set on every launch (a host-side call)
  if (dq_pass) {
    constexpr size_t smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_sm90_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int blocks = (a.Tq + kTile - 1) / kTile * a.H * a.B;
    flash_bwd_dq_sm90_kernel<D><<<blocks, kThreads, smem, stream>>>(a);
  } else {
    constexpr size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_sm90_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int blocks = (a.Tk + kTile - 1) / kTile * a.Hkv * a.B;
    flash_bwd_dkv_sm90_kernel<D><<<blocks, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

int run(bool dq_pass, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta,
        const void* qseg, const void* kseg, void* dq, void* dk, void* dv,
        int B, int Tq, int Tk, int k_len, int H, int Hkv, int D, int q_off,
        int k_off, int causal, int window, float scale, int dtype,
        void* stream) {
  if (dtype != kBFloat16 || B <= 0 || Tq <= 0 || Tk <= 0 || k_len < 0 ||
      k_len > Tk || H <= 0 || Hkv <= 0 || H % Hkv ||
      (qseg == nullptr) != (kseg == nullptr))
    return cudaErrorInvalidValue;
  // cp.async moves 16-byte chunks of q, k, v and do
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
      15)
    return cudaErrorMisalignedAddress;
  TcArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.B = B;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:
      return launch<8>(dq_pass, a, st);
    case 16:
      return launch<16>(dq_pass, a, st);
    case 32:
      return launch<32>(dq_pass, a, st);
    case 64:
      return launch<64>(dq_pass, a, st);
    case 128:
      return launch<128>(dq_pass, a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpu_torch

// flash_bwd_dq's contract (flash_bwd.cu) for bfloat16 inputs only
// (dtype must be the bfloat16 code); q, k, v and do 16-byte aligned.
extern "C" int flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* qseg,
                               const void* kseg, void* dq, int B, int Tq,
                               int Tk, int k_len, int H, int Hkv, int D,
                               int q_off, int k_off, int causal, int window,
                               float scale, int dtype, void* stream) {
  return tpu_torch::run(true, q, k, v, dout, lse, delta, qseg, kseg, dq,
                        nullptr, nullptr, B, Tq, Tk, k_len, H, Hkv, D, q_off,
                        k_off, causal, window, scale, dtype, stream);
}

// flash_bwd_dkv's contract (flash_bwd.cu) for bfloat16 inputs only.
extern "C" int flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* qseg,
                                const void* kseg, void* dk, void* dv, int B,
                                int Tq, int Tk, int k_len, int H, int Hkv,
                                int D, int q_off, int k_off, int causal,
                                int window, float scale, int dtype,
                                void* stream) {
  return tpu_torch::run(false, q, k, v, dout, lse, delta, qseg, kseg,
                        nullptr, dk, dv, B, Tq, Tk, k_len, H, Hkv, D, q_off,
                        k_off, causal, window, scale, dtype, stream);
}
