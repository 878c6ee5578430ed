// Paged multi-token verify attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_verify_attention.py::paged_verify_attention (body
// _paged_verify_kernel): the speculative-decode verify step's attention of
// W consecutive query tokens per slot (W * Gq query rows per KV head) over
// that slot's KV pages, gathered through a block table, with the
// dequantization of quantized pages fused into the read.  Two entries:
//
//   paged_verify_attention        the Pallas interface: q (B, Hkv, W, Gq,
//                                 D), int8 or packed-int4 code pools with
//                                 group scales, f32 math, the staircase
//                                 mask (query j sees positions
//                                 < kv_lens[b] + j), normalized output.
//   paged_verify_attention_arena  the serving verify step's cache read:
//                                 q (B, Hkv, Gq, W, D) bf16 over the
//                                 arena's bf16 fp pool and int8 code / f32
//                                 per-channel scale pools (P, PS, Hkv, D),
//                                 positions below quant_lens[b] read the
//                                 quant pool.  Every row sees the committed
//                                 prefix, positions < kv_lens[b]; the W new
//                                 tokens meet each other in the caller's
//                                 closed-form merge.  Output is the
//                                 UNNORMALIZED bf16 sum with f32 row max m
//                                 and denominator l, at the rounding points
//                                 of paged_attention_arena: quant values
//                                 round to bf16, scores are bf16-rounded
//                                 dots scaled in f32, the row max is exact
//                                 and taken before the exponentials, p
//                                 rounds to bf16 for the p * V sum.
//
// Bound on this card: bytes.  Every visible K and V element is read once
// (2 bytes fp, or 1 byte code + 4 bytes scale) for 2 flops per query row;
// with 20 rows that is ~10 flops per byte, far below the H100's ridge.
// Design (simple first): one block of 512 threads per (slot, KV head, tile
// of query rows), with the tile's scores over the slot's whole view in
// shared memory where they fit (the serving sizes: 20 rows of 1072
// positions take 86 KB) and, beyond that, in a global f32 workspace
// (B, Hkv, rows, PPS*PS) that the wrapper allocates, so the view has no
// length cap.  The workspace alone cost 7-11% at the main path's shapes
// on an H100 (W = 2 and 5, 1072 positions; paged_attention.cu's costs
// nothing there), so the shared-memory form stays the one the main path
// runs; both sum in the same order.
//   Pass 1: one thread per position computes every tile row's dot
//           product, in order over D (4-wide vector loads of K, q from
//           shared memory), so a K row is read once for the tile's rows.
//   Pass 2: one warp per row: exact row max, exponentials, row sum
//           (lanes strided over the positions, then a butterfly).
//   Pass 3: one thread per (channel, group of rows) sums p * v over the
//           positions in order, eight V rows loaded ahead per step.
// A tile holds at most 32 rows, and at most 16 per (channel, thread group)
// in pass 3 (so 16 at D = 512); more rows take more tiles on a second grid
// axis.  Each row's arithmetic is independent of the other rows', so the
// tiling changes no rounding.  The rows are spread over threads and warps,
// not looped one after another as paged_attention.cu's Gq rows are.  Each
// sum runs in the order kernels/ref.py's paged_verify_attention_arena_ref
// takes, so the plain version reproduces the arena entry's rounding.
// Scratch page 0 and every position at or beyond a row's length contribute
// nothing (their p is 0; positions past the tile's longest row are never
// read).  No wgmma or TMA yet: B * Hkv blocks leave most SMs idle at small
// batch.  D must be a multiple of 4 that divides 512 (vector loads; pass
// 3's thread groups).
#include <math.h>
#include <stdint.h>

#include "paged_pages.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;     // query rows per tile
constexpr int kMaxRowsPerThread = 16;  // pass 3: rows per (channel, group)
constexpr int kAhead = 8;        // pass 3: V rows loaded before their sums

// kArena selects the arena entry: one length for every row, the arena's
// rounding points and the unnormalized output with m and l; otherwise row
// i = j * gq + g sees positions < kv_lens[b] + j (the staircase).
// kSmemScores keeps the tile's scores in shared memory (ws unused).
template <bool kArena, bool kSmemScores, typename Pages, typename QT>
__global__ void __launch_bounds__(kThreads)
    paged_verify_kernel(const QT* __restrict__ q, Pages pages,
                        const int32_t* __restrict__ block_tables,
                        const int32_t* __restrict__ kv_lens,
                        const int32_t* __restrict__ quant_lens,
                        float* __restrict__ ws, QT* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int rows, int tile, int gq, int d, int pps, int ps,
                        float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int s_max = pps * ps;
  const int i0 = blockIdx.y * tile, nt = min(tile, rows - i0);
  float* q_s = smem;                             // (nt, d)
  float* l_s = q_s + nt * d;                     // (nt)
  int* bt_s = reinterpret_cast<int*>(l_s + nt);  // (pps)

  const int hkv = pages.hkv;
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const long long row0 = (long long)blockIdx.x * rows + i0;  // first row
  float* sc = kSmemScores ? reinterpret_cast<float*>(bt_s + pps)
                          : ws + row0 * s_max;   // (nt, s_max) scores, p
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = kv_lens[b];
  const int qlen = kArena ? quant_lens[b] : 0;
  // never past the block table; the tile's last row is its longest
  const int len_hi =
      min(kArena ? base : base + (i0 + nt - 1) / gq, s_max);
  const QT* qb = q + row0 * d;
  for (int i = tid; i < nt * d; i += kThreads) q_s[i] = to_f32(qb[i]);
  for (int i = tid; i < pps; i += kThreads)
    bt_s[i] = block_tables[b * pps + i];
  __syncthreads();

  // Pass 1: every tile row's score at every position up to its longest.
  for (int t = tid; t < len_hi; t += kThreads) {
    const int page = bt_s[t / ps], r = t % ps;
    const bool quant = t < qlen;
    float acc[kMaxRows];
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) acc[i] = 0.f;
    for (int dd = 0; dd < d; dd += 4) {
      float kv[4];
      pages.k4(page, h, r, dd, quant, kv);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < nt) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + i * d + dd);
          acc[i] += qv.x * kv[0];
          acc[i] += qv.y * kv[1];
          acc[i] += qv.z * kv[2];
          acc[i] += qv.w * kv[3];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i)
      if (i < nt)
        sc[(long long)i * s_max + t] =
            (kArena ? bf16_round(acc[i]) : acc[i]) * sm_scale;
  }
  __syncthreads();

  // Pass 2: one warp per row: exact max, exponentials, sum; p is 0 from
  // the row's own length up to the tile's longest row's.
  for (int i = warp; i < nt; i += kWarps) {
    float* row = sc + (long long)i * s_max;
    const int len = min(kArena ? base : base + (i0 + i) / gq, s_max);
    float mx = -INFINITY;
    for (int t = lane; t < len; t += 32) mx = fmaxf(mx, row[t]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = lane; t < len_hi; t += 32) {
      const float p = t < len ? expf(row[t] - mx) : 0.f;
      sum += p;
      row[t] = kArena ? bf16_round(p) : p;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      l_s[i] = sum;
      if (kArena) {
        m_out[row0 + i] = mx;
        l_out[row0 + i] = sum;
      }
    }
  }
  __syncthreads();

  // Pass 3: thread (group, channel) sums p * v over the positions in
  // order for its rows; neighbouring threads read neighbouring channels.
  const int groups = kThreads / d;
  const int per = (nt + groups - 1) / groups;
  const int dd = tid % d, r0 = (tid / d) * per;
  if (r0 >= nt) return;
  const int nr = min(per, nt - r0);
  float acc[kMaxRowsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerThread; ++i) acc[i] = 0.f;
  for (int t0 = 0; t0 < len_hi; t0 += kAhead) {
    float vv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u;
      vv[u] = t < len_hi ? pages.v(bt_s[t / ps], h, t % ps, dd, t < qlen)
                         : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u;
      if (t < len_hi) {
#pragma unroll
        for (int i = 0; i < kMaxRowsPerThread; ++i)
          if (i < nr) acc[i] += sc[(long long)(r0 + i) * s_max + t] * vv[u];
      }
    }
  }
  QT* ob = out + row0 * d;
#pragma unroll
  for (int i = 0; i < kMaxRowsPerThread; ++i) {
    if (i < nr) {
      const int row = r0 + i;
      ob[row * d + dd] = from_f32<QT>(
          kArena ? acc[i] : acc[i] / fmaxf(l_s[row], 1e-30f));
    }
  }
}

// Rows per tile: at most kMaxRows, and at most kMaxRowsPerThread per
// (channel, thread group) in pass 3.
int tile_rows(int d) {
  const int t = kMaxRowsPerThread * (kThreads / d);
  return t < kMaxRows ? t : kMaxRows;
}

// s_max_smem: the positions whose scores shared memory holds (0: none).
size_t smem_bytes(int rows, int d, int pps, int s_max_smem) {
  const int t = tile_rows(d), nt = rows < t ? rows : t;
  return sizeof(float) * ((size_t)nt * d + nt + (size_t)nt * s_max_smem) +
         sizeof(int) * (size_t)pps;
}

bool shape_ok(int rows, int d) {
  return rows >= 1 && d >= 4 && d % 4 == 0 && d <= kThreads &&
         kThreads % d == 0;
}

template <bool kArena, bool kSmemScores, typename Pages, typename QT>
int launch_as(const void* q, Pages pages, const int32_t* block_tables,
              const int32_t* kv_lens, const int32_t* quant_lens, float* ws,
              void* out, float* m, float* l, int b, int rows, int gq, int d,
              int pps, int ps, float sm_scale, size_t smem,
              cudaStream_t stream) {
  auto kernel = paged_verify_kernel<kArena, kSmemScores, Pages, QT>;
  int e = allow_smem(kernel, smem);
  if (e) return e;
  const int tile = tile_rows(d);
  const dim3 grid(b * pages.hkv, (rows + tile - 1) / tile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), pages, block_tables, kv_lens, quant_lens, ws,
      static_cast<QT*>(out), m, l, rows, tile, gq, d, pps, ps, sm_scale);
  return (int)cudaGetLastError();
}

// ws == nullptr: the scores fit in shared memory (the wrapper decides).
template <bool kArena, typename Pages, typename QT>
int launch(const void* q, Pages pages, const int32_t* block_tables,
           const int32_t* kv_lens, const int32_t* quant_lens, float* ws,
           void* out, float* m, float* l, int b, int rows, int gq, int d,
           int pps, int ps, float sm_scale, void* stream) {
  if (!shape_ok(rows, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ws == nullptr)
    return launch_as<kArena, true, Pages, QT>(
        q, pages, block_tables, kv_lens, quant_lens, ws, out, m, l, b, rows,
        gq, d, pps, ps, sm_scale, smem_bytes(rows, d, pps, pps * ps), st);
  return launch_as<kArena, false, Pages, QT>(
      q, pages, block_tables, kv_lens, quant_lens, ws, out, m, l, b, rows, gq,
      d, pps, ps, sm_scale, smem_bytes(rows, d, pps, 0), st);
}

}  // namespace

extern "C" int paged_verify_attention(
    const void* q, int q_is_bf16, const void* k_codes, const float* k_scale,
    const void* v_codes, const float* v_scale, const int32_t* block_tables,
    const int32_t* kv_lens, float* ws, void* out, int b, int hkv, int w,
    int gq, int d, int pps, int ps, int bits, int group, float sm_scale,
    void* stream) {
  PallasPages pages{static_cast<const uint8_t*>(k_codes), k_scale,
                    static_cast<const uint8_t*>(v_codes), v_scale,
                    hkv, ps, d, bits, group};
  if (q_is_bf16)
    return launch<false, PallasPages, __nv_bfloat16>(
        q, pages, block_tables, kv_lens, nullptr, ws, out, nullptr, nullptr,
        b, w * gq, gq, d, pps, ps, sm_scale, stream);
  return launch<false, PallasPages, float>(
      q, pages, block_tables, kv_lens, nullptr, ws, out, nullptr, nullptr, b,
      w * gq, gq, d, pps, ps, sm_scale, stream);
}

extern "C" int paged_verify_attention_arena(
    const void* q, const void* k_pool, const void* v_pool,
    const int8_t* k_codes, const float* k_scale, const int8_t* v_codes,
    const float* v_scale, const int32_t* block_tables, const int32_t* kv_lens,
    const int32_t* quant_lens, float* ws, void* out, float* m, float* l,
    int b, int hkv, int gq, int w, int d, int pps, int ps, float sm_scale,
    void* stream) {
  ArenaPages pages{static_cast<const __nv_bfloat16*>(k_pool),
                   static_cast<const __nv_bfloat16*>(v_pool),
                   k_codes, k_scale, v_codes, v_scale, hkv, ps, d};
  return launch<true, ArenaPages, __nv_bfloat16>(
      q, pages, block_tables, kv_lens, quant_lens, ws, out, m, l, b, gq * w,
      gq, d, pps, ps, sm_scale, stream);
}
