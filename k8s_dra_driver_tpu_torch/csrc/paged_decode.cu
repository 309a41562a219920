// Paged-attention decode for Hopper (sm_90a), CUDA C++: K2.
//
// Replaces the TPU kernel `_paged_decode_kernel` of
// k8s_dra_driver_tpu/ops/paged_attention.py (:125), launched there by
// `_paged_attention_call` (pallas_call :215) and entered through
// `paged_attention`.  One query token per row attends to the K/V pages
// its block table names: row b reads pool pages tables[b, j] for
// j * bs < lengths[b] and masks key positions >= lengths[b].  As in
// the TPU kernel, q, K and V are cast to f32, the running max and sum
// and p . v are kept in f32 with p unrounded, and only the normalized
// [B, H, D] output is rounded to q's dtype.  Only the order of the f32
// sums differs.
//
// Bound.  The kernel is memory-bound: per key and KV head it reads
// 2 * D elements of K/V and does 4 * D * G flops (G query heads per KV
// head), about 4 flops a byte in bf16, far below the ~295 at which the
// tensor cores would be the limit.  Its least time is the valid K/V
// bytes of the call over the card's 3.35 TB/s, so what it needs is
// many bytes in flight on every SM.  One block per (row, KV head) that
// walks its pages in series, one page in flight, left 100 of the 132
// SMs idle at the serving step and waited one DRAM latency per page.
//
// Design: split the pages across blocks (flash-decoding).
//   - The wrapper's planner (ops/paged_attention.py `paged_plan`) cuts
//     each row's table into `splits` spans of `pages_per_split` whole
//     pages from shapes alone (the lengths stay on the card), so that
//     rows x head groups x splits give about two waves of blocks; with
//     132 (row, head group) blocks or more it keeps one split.  A
//     block of 4 warps takes one (split, row, group of kG query heads
//     of one KV head); the grid is 1-D, the split slowest.  A block
//     reads its row's length and exits at once when its span starts at
//     or past it, so the grid is sized by the table width.
//   - A span is cut into chunks of kC tokens (K + V of a chunk: 4 KB,
//     or 32 tokens where rows are narrower than 64 bytes).
//     Warp w takes chunks w, w + 4, ... through its own two-stage ring
//     of 16-byte cp.async copies (zero-filled past the span's last
//     valid key, so null-block tail entries are never read) and keeps
//     its own online softmax: one (token, head) score a lane, the max
//     and sum by shuffles across the chunk's lanes, then p . v with
//     each lane holding D / 32 columns of every head.  Rows sit in
//     shared memory with their 16-byte pieces XOR-swizzled by row, so
//     neither read conflicts on banks.
//   - Small head dims (D = 8, 16, 32: the JAX package's probe models)
//     keep that shape: a chunk holds at most 32 tokens, so a head's
//     scores stay one warp's lanes; a row of fewer than eight 16-byte
//     pieces is swizzled over the pieces it has; and where D < 32, p . v
//     gives each lane one column and 32 / D of the chunk's tokens, the
//     lanes of a column summed by shuffles once the span is walked.
//   - The 4 warps' states are folded in warp order.  A row whose valid
//     keys fit one span (every row of the serving step) writes its
//     normalized output at once.  Otherwise each live block writes its
//     f32 partial (o unnormalized, m, l) to the workspace and bumps its
//     (row, head group) counter; the last block to arrive folds the
//     partials in split order, never in arrival order, so a repeat is
//     bitwise equal, writes the output and resets the counter to 0 for
//     the next call.  One launch, no float atomics.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace tpu_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;         // chunks in flight per warp
constexpr int kChunkBytes = 2048;  // K (and V) bytes of one chunk

template <typename T, int D, int kG>
struct Tile {
  static constexpr int kRow = D * (int)sizeof(T);  // bytes of one key row
  // tokens a chunk: 2 KB of rows, at most 32 (a head's scores of a
  // chunk are reduced across the warp's lanes): 4-32
  static constexpr int kC =
      kChunkBytes / kRow < 32 ? kChunkBytes / kRow : 32;
  static constexpr int kVec = kRow / 16;           // 16-byte pieces a row
  static constexpr int kSwz = (kVec < 8 ? kVec : 8) - 1;  // swizzle mask
  static constexpr int kE = 16 / (int)sizeof(T);   // elements a piece
  static constexpr int kPer = kVec * kC / 32;      // pieces a lane loads
  static constexpr int kCols = D < 32 ? 1 : D / 32;  // p . v columns a lane
  static constexpr int kColLanes = D / kCols;      // lanes over a row
  static constexpr int kTokLanes = 32 / kColLanes;  // lanes of one column
  static constexpr int kPairs = (kG * kC + 31) / 32;  // scores a lane
  static constexpr int kQ = D + 4;                 // padded q row, floats
  static_assert(kPer * 32 == kVec * kC, "a chunk is whole pieces a lane");

  struct alignas(16) Smem {
    unsigned char ring[kWarps][kStages][2][kChunkBytes];  // K, V
    float q[kG][kQ];
    float p[kWarps][kC][kG];  // the chunk's probabilities
    float alpha[kWarps][kG];  // the chunk's rescale of acc
    float o[kWarps][kG][D];   // the warps' states, folded in warp order
    float m[kWarps][kG];
    float l[kWarps][kG];
    int last;
  };
};

// byte offset of 16-byte piece v of row t in a chunk (swizzle mask 7,
// or the row's pieces less one where a row has fewer than 8)
__device__ __forceinline__ int piece(int t, int v, int row_bytes, int swz) {
  return t * row_bytes + ((v ^ (t & swz)) << 4);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}

// N consecutive elements at p (2, 4, 8 or 16 bytes, aligned) as f32
template <typename T, int N>
__device__ __forceinline__ void load_cols(const unsigned char* p,
                                          float (&x)[N]) {
  if constexpr (sizeof(T) == 2 && N == 1) {
    x[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  } else if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = reinterpret_cast<const float*>(p)[i];
  }
}

// fold the softmax state (m2, l2, o2) into (m, l, o); an empty state
// (m = -inf, l = o = 0) leaves the other side unchanged
__device__ __forceinline__ void fold(float& m, float& l, float& o, float m2,
                                     float l2, float o2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  const float ca = expf(m - mn), cb = expf(m2 - mn);
  l = l * ca + l2 * cb;
  o = o * ca + o2 * cb;
  m = mn;
}

// the table entries of the pages this lane copies for the chunk whose
// first token is pos0; tokens at or past `lim` get none (-1)
template <typename T, int D, int kG>
__device__ __forceinline__ void chunk_pages(int (&blk)[Tile<T, D, kG>::kPer],
                                            const int* trow, int pos0,
                                            int lim, int bs, int lane) {
  using C = Tile<T, D, kG>;
#pragma unroll
  for (int i = 0; i < C::kPer; ++i) {
    const int pos = pos0 + (lane + 32 * i) / C::kVec;
    blk[i] = pos < lim ? __ldg(trow + pos / bs) : -1;
  }
}

// start the copies of that chunk into the stage at dk (K, then V);
// tokens at or past `end` are zero-filled and their pages unread
template <typename T, int D, int kG>
__device__ __forceinline__ void load_chunk(
    uint32_t dk, const int (&blk)[Tile<T, D, kG>::kPer], const T* k_pool,
    const T* v_pool, int pos0, int end, int bs, int Hkv, int hk, int lane) {
  using C = Tile<T, D, kG>;
#pragma unroll
  for (int i = 0; i < C::kPer; ++i) {
    const int p = lane + 32 * i, t = p / C::kVec, v = p % C::kVec;
    const int pos = pos0 + t;
    const bool ok = pos < end && blk[i] >= 0;
    const size_t off =
        ok ? (((size_t)blk[i] * bs + pos % bs) * Hkv + hk) * D + v * C::kE
           : 0;
    const uint32_t o = piece(t, v, C::kRow, C::kSwz);
    sm90::cp16(dk + o, k_pool + off, ok);
    sm90::cp16(dk + kChunkBytes + o, v_pool + off, ok);
  }
}

template <typename T, int D, int kG>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int B,
                    int H, int Hkv, int bs, int n_pages, int pages_per_split,
                    int splits, float scale) {
  using C = Tile<T, D, kG>;
  constexpr int kC = C::kC;
  __shared__ typename C::Smem sm;

  const int groups = H / kG;
  const int hg = blockIdx.x % groups;
  const int b = (blockIdx.x / groups) % B;
  const int s = blockIdx.x / (groups * B);
  const int hq0 = hg * kG;           // the block's first query head
  const int hk = hq0 / (H / Hkv);    // their KV head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  T* orow = out + ((size_t)b * H + hq0) * D;

  const int span = pages_per_split * bs;
  const int start = s * span;
  const int* trow = tables + (size_t)b * n_pages;
  // the table entries of this warp's first chunks are read beside the
  // length, not after it: entries past the length name the null block,
  // whose pages are never copied
  int blk[kStages][C::kPer];
#pragma unroll
  for (int k = 0; k < kStages; ++k)
    chunk_pages<T, D, kG>(blk[k], trow, start + (warp + kWarps * k) * kC,
                          min(start + span, n_pages * bs), bs, lane);
  const int len = min(lengths[b], n_pages * bs);
  if (len <= 0) {  // no key: zeros, as the TPU kernel's floor on l gives
    if (s == 0)
      for (int e = tid; e < kG * D; e += kThreads) store_from_f32(orow + e, 0.f);
    return;
  }
  if (start >= len) return;  // a dead split
  const int end = min(start + span, len);
  const int n_live = (len + span - 1) / span;

  for (int e = tid; e < kG * D; e += kThreads)
    sm.q[e / D][e % D] = to_f32(q[((size_t)b * H + hq0) * D + e]);

  // -- this warp's chunks: w, w + 4, ... through a two-stage ring
  const int n_chunks = (end - start + kC - 1) / kC;
  unsigned char* ring = &sm.ring[warp][0][0][0];
  const uint32_t ring_s = sm90::smem_addr(ring);
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    load_chunk<T, D, kG>(ring_s + k * 2 * kChunkBytes, blk[k], k_pool,
                         v_pool, start + (warp + kWarps * k) * kC, end, bs,
                         Hkv, hk, lane);
    sm90::cp_commit();
  }
  __syncthreads();  // q

  float acc[kG][C::kCols];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < C::kCols; ++e) acc[g][e] = 0.f;
  float m_run[C::kPairs], l_run[C::kPairs];
#pragma unroll
  for (int j = 0; j < C::kPairs; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
  }
  // this lane's p . v columns, and its first token of each chunk
  // (tokens t0, t0 + kTokLanes, ...: all of them unless D < 32)
  const int d0 = (C::kTokLanes > 1 ? lane % C::kColLanes : lane) * C::kCols;
  const int t0 = C::kTokLanes > 1 ? lane / C::kColLanes : 0;

  for (int i = 0;; ++i) {
    const int c = warp + kWarps * i;
    if (c >= n_chunks) break;
    sm90::cp_wait<kStages - 1>();
    __syncwarp();
    const int st = i % kStages;
    const unsigned char* sk = ring + st * 2 * kChunkBytes;
    const unsigned char* sv = sk + kChunkBytes;
    const int pos0 = start + c * kC;  // < end: token 0 is valid
    // the table entries of the chunk this stage takes next, read now
    // and used after this chunk's arithmetic
    const int cn = c + kWarps * kStages;
    int nxt[C::kPer];
    chunk_pages<T, D, kG>(nxt, trow, start + cn * kC, end, bs, lane);

    // scores, one (token, head) pair a lane, and the online softmax
    // of each head over the chunk's kC lanes
#pragma unroll
    for (int j = 0; j < C::kPairs; ++j) {
      const int pr = lane + 32 * j;
      const int t = pr % kC, g = pr / kC;
      const bool head = g < kG;  // lanes past kG * kC idle
      const bool live = head && pos0 + t < end;
      const float4* q4 = reinterpret_cast<const float4*>(
          sm.q[head ? g : 0]);
      float dot[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, then summed
#pragma unroll
      for (int v = 0; v < C::kVec; ++v) {
        float kx[C::kE];
        unpack(*reinterpret_cast<const uint4*>(
                   sk + piece(t, v, C::kRow, C::kSwz)),
               kx);
#pragma unroll
        for (int e4 = 0; e4 < C::kE / 4; ++e4) {
          const float4 qv = q4[v * (C::kE / 4) + e4];
          dot[0] = fmaf(qv.x, kx[4 * e4], dot[0]);
          dot[1] = fmaf(qv.y, kx[4 * e4 + 1], dot[1]);
          dot[2] = fmaf(qv.z, kx[4 * e4 + 2], dot[2]);
          dot[3] = fmaf(qv.w, kx[4 * e4 + 3], dot[3]);
        }
      }
      const float sc =
          live ? ((dot[0] + dot[1]) + (dot[2] + dot[3])) * scale : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int off = kC / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // a head's chunk holds at least its valid token 0: mx is finite
      const float m_new = head ? fmaxf(m_run[j], mx) : 0.f;
      float p = live ? expf(sc - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = kC / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (head) {
        const float alpha = expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * alpha + sum;
        m_run[j] = m_new;
        sm.p[warp][t][g] = p;
        if (t == 0) sm.alpha[warp][g] = alpha;
      }
    }
    __syncwarp();

    // p . v: this lane's columns of every head
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float a = sm.alpha[warp][g];
#pragma unroll
      for (int e = 0; e < C::kCols; ++e) acc[g][e] *= a;
    }
    const int v = d0 / C::kE, off = (d0 % C::kE) * (int)sizeof(T);
#pragma unroll 4
    for (int t = t0; t < kC; t += C::kTokLanes) {
      float vx[C::kCols];
      load_cols<T>(sv + piece(t, v, C::kRow, C::kSwz) + off, vx);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float pg = sm.p[warp][t][g];
#pragma unroll
        for (int e = 0; e < C::kCols; ++e) acc[g][e] = fmaf(pg, vx[e], acc[g][e]);
      }
    }
    __syncwarp();

    // refill this stage with the chunk kStages steps ahead
    load_chunk<T, D, kG>(ring_s + st * 2 * kChunkBytes, nxt, k_pool, v_pool,
                         start + cn * kC, end, bs, Hkv, hk, lane);
    sm90::cp_commit();
  }
  sm90::cp_wait<0>();  // the last refills only zero-fill: let them land
  // lanes that took other tokens of the same columns (D < 32) add up
#pragma unroll
  for (int off = C::kColLanes; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < C::kCols; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);

  // -- fold the warps' states in warp order (a warp without a chunk
  // holds the empty state)
  if (t0 == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < C::kCols; ++e) sm.o[warp][g][d0 + e] = acc[g][e];
  }
#pragma unroll
  for (int j = 0; j < C::kPairs; ++j) {
    const int pr = lane + 32 * j;
    if (pr / kC < kG && pr % kC == 0) {
      sm.m[warp][pr / kC] = m_run[j];
      sm.l[warp][pr / kC] = l_run[j];
    }
  }
  __syncthreads();

  const bool direct = n_live == 1;
  for (int e = tid; e < kG * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float m = -INFINITY, l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      fold(m, l, o, sm.m[w][g], sm.l[w][g], sm.o[w][g][d]);
    if (direct) {
      store_from_f32(orow + e, o / l);
    } else {
      float* part = ws + (((size_t)b * H + hq0 + g) * splits + s) * (D + 2);
      part[d] = o;
      if (d == 0) {
        part[D] = m;
        part[D + 1] = l;
      }
    }
  }
  if (direct) return;

  // -- the last live block of this (row, head group) folds the
  // partials in split order
  __threadfence();
  __syncthreads();
  int* ctr = counters + (size_t)b * groups + hg;
  if (tid == 0) sm.last = atomicAdd(ctr, 1) == n_live - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  constexpr int kBatch = 8;  // partials read ahead of their fold
  for (int e = tid; e < kG * D; e += kThreads) {
    const int g = e / D, d = e % D;
    const float* part = ws + ((size_t)b * H + hq0 + g) * splits * (D + 2);
    float m = -INFINITY, l = 0.f, o = 0.f;
    for (int s0 = 0; s0 < n_live; s0 += kBatch) {
      float pm[kBatch], pl[kBatch], po[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const float* ps = part + (size_t)(s0 + k) * (D + 2);
        const bool ok = s0 + k < n_live;
        pm[k] = ok ? __ldcg(ps + D) : -INFINITY;
        pl[k] = ok ? __ldcg(ps + D + 1) : 0.f;
        po[k] = ok ? __ldcg(ps + d) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) fold(m, l, o, pm[k], pl[k], po[k]);
    }
    store_from_f32(orow + e, o / l);
  }
  if (tid == 0) *ctr = 0;
}

template <typename T, int D, int kG>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lengths, void* out,
                   float* ws, int* counters, int B, int H, int Hkv, int bs,
                   int n_pages, int pages_per_split, int splits, float scale,
                   cudaStream_t stream) {
  const long long blocks = (long long)splits * B * (H / kG);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  paged_decode_kernel<T, D, kG><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lengths, static_cast<T*>(out),
      ws, counters, B, H, Hkv, bs, n_pages, pages_per_split, splits, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int kg, const void* q, const void* k_pool,
                     const void* v_pool, const int* tables,
                     const int* lengths, void* out, float* ws, int* counters,
                     int B, int H, int Hkv, int bs, int n_pages, int pps,
                     int splits, float scale, cudaStream_t st) {
  switch (kg) {
    case 1:
      return launch<T, D, 1>(q, k_pool, v_pool, tables, lengths, out, ws,
                             counters, B, H, Hkv, bs, n_pages, pps, splits,
                             scale, st);
    case 2:
      return launch<T, D, 2>(q, k_pool, v_pool, tables, lengths, out, ws,
                             counters, B, H, Hkv, bs, n_pages, pps, splits,
                             scale, st);
    case 4:
      return launch<T, D, 4>(q, k_pool, v_pool, tables, lengths, out, ws,
                             counters, B, H, Hkv, bs, n_pages, pps, splits,
                             scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int D, int kg, const void* q, const void* k_pool,
                     const void* v_pool, const int* tables,
                     const int* lengths, void* out, float* ws, int* counters,
                     int B, int H, int Hkv, int bs, int n_pages, int pps,
                     int splits, float scale, cudaStream_t st) {
  switch (D) {
    case 8:
      return launch_g<T, 8>(kg, q, k_pool, v_pool, tables, lengths, out, ws,
                            counters, B, H, Hkv, bs, n_pages, pps, splits,
                            scale, st);
    case 16:
      return launch_g<T, 16>(kg, q, k_pool, v_pool, tables, lengths, out, ws,
                             counters, B, H, Hkv, bs, n_pages, pps, splits,
                             scale, st);
    case 32:
      return launch_g<T, 32>(kg, q, k_pool, v_pool, tables, lengths, out, ws,
                             counters, B, H, Hkv, bs, n_pages, pps, splits,
                             scale, st);
    case 64:
      return launch_g<T, 64>(kg, q, k_pool, v_pool, tables, lengths, out, ws,
                             counters, B, H, Hkv, bs, n_pages, pps, splits,
                             scale, st);
    case 128:
      return launch_g<T, 128>(kg, q, k_pool, v_pool, tables, lengths, out,
                              ws, counters, B, H, Hkv, bs, n_pages, pps,
                              splits, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tpu_torch

// q [B,H,D], pools [n_blocks,bs,H_kv,D] (float32 or bfloat16,
// contiguous, 16-byte aligned), tables [B,n_pages] int32, lengths [B]
// int32, out like q.  The plan (ops/paged_attention.py `paged_plan`):
// `heads_per_block` query heads of one KV head a block (1, 2 or 4,
// dividing H / H_kv), spans of `pages_per_split` pages, `splits` spans
// covering the table.  With splits > 1: ws, f32 [B, H, splits, D + 2],
// and counters, int32 [B * H / heads_per_block], all 0 (the kernel
// leaves them 0).  Returns cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* lengths, void* out, void* ws,
                            void* counters, int B, int H, int Hkv, int D,
                            int bs, int n_pages, int heads_per_block,
                            int pages_per_split, int splits, float scale,
                            int dtype, void* stream) {
  using namespace tpu_torch;
  const int* t = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kg = heads_per_block;
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || bs <= 0 || n_pages <= 0 ||
      kg <= 0 || (H / Hkv) % kg || pages_per_split <= 0 || splits <= 0 ||
      (long long)(splits - 1) * pages_per_split >= n_pages ||
      (long long)splits * pages_per_split < n_pages ||
      (long long)n_pages * bs > INT_MAX ||
      (splits > 1 && (w == nullptr || ctr == nullptr)))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return launch_d<float>(D, kg, q, k_pool, v_pool, t, len, out, w, ctr,
                             B, H, Hkv, bs, n_pages, pages_per_split, splits,
                             scale, st);
    case kBFloat16:
      return launch_d<__nv_bfloat16>(D, kg, q, k_pool, v_pool, t, len, out,
                                     w, ctr, B, H, Hkv, bs, n_pages,
                                     pages_per_split, splits, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
