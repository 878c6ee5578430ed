// The split design of the paged attention kernels (paged_attention.cu,
// paged_verify_attention.cu): each slot's positions are cut across blocks,
// in two launches, with every rounding point where the JAX package has it.
//
//   Phase A  split_scores, grid (slot x KV head x chunk, row tile), 128
//            threads: a block takes one chunk of 16-128 positions of a
//            slot's view (32 or 64 at the main shapes: 1,584 or 816
//            blocks), reads only the chunk's block-table entries, loads its
//            K with vector loads (kBatchA 8-channel units in flight per
//            thread) into shared memory as f32, computes every tile row's
//            score (arena: the bf16-rounded dot, scaled in f32), and writes
//            the scores to the f32 workspace and each row's chunk max
//            (-inf where the row sees none of the chunk).  Chunks wholly at
//            or beyond the slot's length write -inf and exit.
//   Phase B  split_values, grid (slot x KV head x 16 channels, row tile),
//            one thread per (row, channel) and at least one per position
//            of a stage: a block takes each row's exact max as the max of
//            its chunk maxima, then walks the slot's positions in stages of
//            kTileB, three or four in flight by cp.async (each position's
//            16-channel V slice as stored, and the stage's scores), turns a
//            landed stage's V into f32 and its scores into p = exp(s - m)
//            (arena: rounded to bf16 for the p * V sum), adds p to each
//            row's denominator in the order the plain version takes it, and
//            each (row, channel) thread adds p * v over the positions in
//            order.  It writes the unnormalized bf16 output with f32 m and l
//            (arena) or the output divided by l (Pallas interface).
//
// Why the p * V sum is not split into per-chunk partials combined after:
// its f32 order fixes the bf16 output's last bits, and an output near zero
// (cancelling terms) moves by more than 2 bf16 ulps when the order changes
// (tests/test_torch_paged_split.py measures it on the CPU: up to 5 ulps at
// the main shape).  The arena entries hold their plain versions
// (kernels/ref.py) within 2 ulps, so each (row, channel) keeps one chain
// over all positions in order: ~1000 dependent FMAs, a few microseconds.
// The score's dot keeps its order too (its bf16 rounding follows from it):
// kWarpDot is paged_attention's (lane l adds channels l, l + 32, ... in
// order, then an xor butterfly), otherwise one thread adds the channels in
// order (paged_verify_attention's).  The row max is exact in any order, and
// the denominator is summed in the plain version's order (kLWidth virtual
// threads each add positions j, j + kLWidth, ... in order, then xor
// butterflies over 32, then the butterflies' results in order).  So the
// kernels equal their plain versions bit for bit wherever expf does.
//
// No float atomics: every sum has one fixed order, so two launches on the
// same input give the same bits.
//
// Gemma-2's local layers and its attention softcap (the arena entries'
// _window_cap variants, template flag kWinCap; without it the kernels are
// the same code as before the flag): phase A caps each scaled f32 score as
// tanhf(s / cap) * cap (IEEE divide: the build has no fast math) before
// it reaches the workspace and the chunk max, and masks each row below its
// own window bound (query token j of a slot at kv_len sees positions p
// with kv_len + j - window < p < kv_len).  A chunk wholly below every
// tile row's bound writes -inf and exits, as one wholly beyond the length
// does, and phase B starts its walk at the stage that holds the tile's
// lowest seen position: the positions it skips have p = 0 exactly, so no
// sum changes a bit.  That skip is the window's only saving: a local
// layer at 6,000 positions reads its 4,096-position window, not the
// prefix.  A row that sees no position (kv_len 0, or a window that ends
// before the prefix) leaves m = -inf, l = 0 and out = 0.
//
// What limits it (H100, main shapes, see PERF.md): neither phase is near
// the byte bound.  Phase A waits on its K loads and then computes with no
// other work to overlap; phase B spends most of a stage turning V and the
// scores into f32 and p between two barriers, with few warps per SM.
#pragma once

#include <math.h>
#include <stdint.h>

#include "paged_pages.cuh"

namespace {

constexpr int kThreads = 128;   // phase A
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 32;    // query rows per block
constexpr int kMinChunk = 16;   // ops.py sizes the chunk maxima for it
constexpr int kMaxChunk = 128;
constexpr int kMaxD = 512;
constexpr int kBatchA = 4;      // phase A: K units in flight per thread
constexpr int kSlice = 16;      // phase B: channels per block
constexpr int kTileB = 128;     // phase B: positions per stage
constexpr int kMaxThreadsB = kMaxTile * kSlice;  // one per (row, channel)

struct Split {
  int rows;      // query rows per (slot, KV head)
  int gq;        // the staircase's step: row i sees base + i / gq
  int tile;      // rows per block
  int hkv, d, pps, ps, s_max;
  int s_pad;     // s_max rounded up to 4: the scores' row stride
  int chunk, n_chunks;
  float sm_scale;
  float* ws;     // (B * Hkv, rows, s_pad) scores
  float* cmax;   // (B * Hkv, rows, n_chunks) chunk maxima
  int w;         // kWinCap: query tokens a slot, row i is token i % w
  int window;    // kWinCap: sliding window (0: none)
  float cap;     // kWinCap: attention softcap (0: none)
};

// Positions row i (of its slot and head) sees, never past the block table.
template <bool kStair>
__device__ __forceinline__ int row_len(int base, int i, const Split& sp) {
  return min(kStair ? base + i / sp.gq : base, sp.s_max);
}

// The first position row i sees (kWinCap): its token j = i % w sits at
// base + j and sees positions > base + j - window.
template <bool kWinCap>
__device__ __forceinline__ int row_lo(int base, int i, const Split& sp) {
  return kWinCap && sp.window > 0
             ? max(0, base + i % sp.w - sp.window + 1) : 0;
}

// The lowest first-seen position of the tile's nt rows from i0.
template <bool kWinCap>
__device__ __forceinline__ int tile_lo(int base, int i0, int nt,
                                       const Split& sp) {
  if (!kWinCap || sp.window <= 0) return 0;
  int lo = row_lo<true>(base, i0, sp);
  for (int i = i0 + 1; i < i0 + min(nt, sp.w); ++i)
    lo = min(lo, row_lo<true>(base, i, sp));
  return lo;
}

// A scaled score, capped (kWinCap, cap > 0) as tanhf(s / cap) * cap.
template <bool kWinCap>
__device__ __forceinline__ float capped(float s, const Split& sp) {
  return kWinCap && sp.cap > 0.f ? tanhf(s / sp.cap) * sp.cap : s;
}

// The sum an xor butterfly (16, 8, 4, 2, 1) over 32 lanes leaves in lane 0.
__device__ __forceinline__ float butterfly32(float (&v)[32]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < off; ++k) v[k] = v[k] + v[k + off];
  return v[0];
}

template <bool kArena, bool kStair, bool kWarpDot, bool kWinCap,
          typename Pages, typename QT>
__global__ void __launch_bounds__(kThreads)
    split_scores(const QT* __restrict__ q, Pages pages,
                 const int32_t* __restrict__ block_tables,
                 const int32_t* __restrict__ kv_lens,
                 const int32_t* __restrict__ quant_lens, Split sp) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x % sp.n_chunks, bh = blockIdx.x / sp.n_chunks;
  const int b = bh / sp.hkv, h = bh % sp.hkv;
  const int i0 = blockIdx.y * sp.tile, nt = min(sp.tile, sp.rows - i0);
  const long long row0 = (long long)bh * sp.rows + i0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = kv_lens[b];
  const int t0 = c * sp.chunk;
  const int n = min(sp.chunk, row_len<kStair>(base, i0 + nt - 1, sp) - t0);
  float* cm = sp.cmax + row0 * sp.n_chunks + c;
  // the chunk lies wholly beyond every tile row's length, or wholly below
  // every tile row's window
  if (n <= 0 || (kWinCap && t0 + n <= tile_lo<kWinCap>(base, i0, nt, sp))) {
    for (int i = tid; i < nt; i += kThreads)
      cm[(long long)i * sp.n_chunks] = -INFINITY;
    return;
  }
  // padded K rows: conflict-free float4s, or 4 positions x 8 lanes
  const int d = sp.d, kst = d + (kWarpDot ? 8 : 4);
  const int p0 = t0 / sp.ps, np = (t0 + n - 1) / sp.ps - p0 + 1;
  float* q_s = smem;                     // (nt, d)
  float* k_s = q_s + nt * d;             // (chunk, kst)
  float* s_s = k_s + sp.chunk * kst;     // (nt, chunk)
  int* bt_s = reinterpret_cast<int*>(s_s + nt * sp.chunk);  // the chunk's
  const int qlen = kArena ? quant_lens[b] : 0;                // pages
  const QT* qb = q + row0 * d;
  for (int i = tid; i < nt * d; i += kThreads) q_s[i] = to_f32(qb[i]);
  for (int i = tid; i < np; i += kThreads)
    bt_s[i] = block_tables[(long long)b * sp.pps + p0 + i];
  __syncthreads();

  // K of the chunk's n positions, kBatchA units per thread in flight
  const int upp = d / 8, units = n * upp;
  for (int u0 = 0; u0 < units; u0 += kThreads * kBatchA) {
    typename Pages::Unit raw[kBatchA];
#pragma unroll
    for (int j = 0; j < kBatchA; ++j) {
      const int u = u0 + j * kThreads + tid;
      if (u < units) {
        const int t = t0 + u / upp;
        raw[j] = pages.fetch_k(bt_s[t / sp.ps - p0], h, t % sp.ps,
                               (u % upp) * 8, t < qlen);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatchA; ++j) {
      const int u = u0 + j * kThreads + tid;
      if (u < units)
        pages.decode(raw[j], t0 + u / upp < qlen,
                     k_s + (u / upp) * kst + (u % upp) * 8);
    }
  }
  __syncthreads();

  if (kWarpDot) {
    // one warp's order: lane l's partial adds channels l, l + 32, ... in
    // order, then an xor butterfly (16, 8, 4, 2, 1) sums the 32 partials.
    // Eight threads take one position: thread k holds the partials of
    // lanes k, k + 8, k + 16, k + 24, so the butterfly's first two steps
    // are its own adds and the last three are xor shuffles over the eight.
    const int k8 = lane & 7;
    for (int t = warp * 4 + (lane >> 3); t - (lane >> 3) < n;
         t += kWarps * 4) {
      const bool live = t < n;
      const float* kr = k_s + (live ? t : 0) * kst;
      for (int i = 0; i < nt; ++i) {
        const float* qr = q_s + i * d;
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < d; j += 32) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int dd = j + k8 + 8 * a;
            if (dd < d) p[a] += qr[dd] * kr[dd];
          }
        }
        float v = (p[0] + p[2]) + (p[1] + p[3]);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (live && k8 == 0)
          s_s[i * sp.chunk + t] = capped<kWinCap>(
              (kArena ? bf16_round(v) : v) * sp.sm_scale, sp);
      }
    }
  } else {
    // one thread per (2 positions, group of up to 8 rows): each dot in
    // order over D, K and q read once for the 16 sums
    const int pairs = (n + 1) / 2, groups = (nt + 7) / 8;
    for (int it = tid; it < pairs * groups; it += kThreads) {
      const int t = (it % pairs) * 2, g0 = (it / pairs) * 8;
      const float* ka = k_s + t * kst;
      const float* kb = k_s + (t + 1 < n ? t + 1 : t) * kst;
      float acc[2][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[0][j] = acc[1][j] = 0.f;
      for (int dd = 0; dd < d; dd += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(ka + dd);
        const float4 k1 = *reinterpret_cast<const float4*>(kb + dd);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 qv = *reinterpret_cast<const float4*>(
              q_s + min(g0 + j, nt - 1) * d + dd);
          acc[0][j] += qv.x * k0.x;
          acc[0][j] += qv.y * k0.y;
          acc[0][j] += qv.z * k0.z;
          acc[0][j] += qv.w * k0.w;
          acc[1][j] += qv.x * k1.x;
          acc[1][j] += qv.y * k1.y;
          acc[1][j] += qv.z * k1.z;
          acc[1][j] += qv.w * k1.w;
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (t + x < n && g0 + j < nt)
            s_s[(g0 + j) * sp.chunk + t + x] = capped<kWinCap>(
                (kArena ? bf16_round(acc[x][j]) : acc[x][j]) * sp.sm_scale,
                sp);
    }
  }
  __syncthreads();

  // the scores to the workspace; each row's max over the positions it sees
  for (int i = warp; i < nt; i += kWarps) {
    const int vis = row_len<kStair>(base, i0 + i, sp) - t0;
    const int lov = row_lo<kWinCap>(base, i0 + i, sp) - t0;
    float* wr = sp.ws + (row0 + i) * sp.s_pad + t0;
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) {
      const float s = s_s[i * sp.chunk + t];
      wr[t] = s;
      if (t < vis && (!kWinCap || t >= lov)) mx = fmaxf(mx, s);
    }
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) cm[(long long)i * sp.n_chunks] = mx;
  }
}

// Phase B; blockDim.x is one thread per (row, channel) of the block,
// rounded up to whole warps, and at least kTileB.  kStages stages of kTileB
// positions, all but one in flight.
template <bool kArena, bool kStair, bool kWinCap, int kLWidth, int kStages,
          typename Pages, typename QT>
__global__ void __launch_bounds__(kMaxThreadsB, 2)
    split_values(Pages pages, const int32_t* __restrict__ block_tables,
                 const int32_t* __restrict__ kv_lens,
                 const int32_t* __restrict__ quant_lens,
                 QT* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, Split sp) {
  static_assert(kLWidth % 32 == 0 && kTileB % kLWidth == 0,
                "the denominator's order");
  constexpr int kPst = kTileB + 4;       // padded score / p rows
  extern __shared__ __align__(16) float smem[];
  const int n_slices = sp.d / kSlice;
  const int sl = blockIdx.x % n_slices, bh = blockIdx.x / n_slices;
  const int b = bh / sp.hkv, h = bh % sp.hkv;
  const int i0 = blockIdx.y * sp.tile, nt = min(sp.tile, sp.rows - i0);
  const long long row0 = (long long)bh * sp.rows + i0;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int base = kv_lens[b];
  const int len_hi = row_len<kStair>(base, i0 + nt - 1, sp);
  const int qlen = kArena ? quant_lens[b] : 0;
  const int c0 = sl * kSlice;
  uint8_t* raw_s = reinterpret_cast<uint8_t*>(smem);  // stages of V as
  float* sc_s = reinterpret_cast<float*>(             // stored, then of
      raw_s + kStages * kTileB * Pages::kStageBytes);  // scores / p
  float* v_s = sc_s + kStages * nt * kPst;            // (kTileB, kSlice)
  float* a_s = v_s + kTileB * kSlice;                 // (nt, kLWidth)
  float* m_s = a_s + nt * kLWidth;                    // (nt) max, then l
  int* len_s = reinterpret_cast<int*>(m_s + nt);      // (nt)
  int* lo_s = len_s + nt;                             // (nt) kWinCap

  // the exact row max: the max of the chunk maxima
  for (int i = tid; i < nt; i += nthr) {
    const float* cm = sp.cmax + (row0 + i) * sp.n_chunks;
    float mx = -INFINITY;
    int k = 0;
    for (; k + 4 <= sp.n_chunks; k += 4) {
      const float a0 = cm[k], a1 = cm[k + 1], a2 = cm[k + 2], a3 = cm[k + 3];
      mx = fmaxf(fmaxf(mx, fmaxf(a0, a1)), fmaxf(a2, a3));
    }
    for (; k < sp.n_chunks; ++k) mx = fmaxf(mx, cm[k]);
    m_s[i] = mx;
    len_s[i] = row_len<kStair>(base, i0 + i, sp);
    if (kWinCap) lo_s[i] = row_lo<kWinCap>(base, i0 + i, sp);
  }
  for (int i = tid; i < nt * kLWidth; i += nthr) a_s[i] = 0.f;

  // stage k: its positions' V slice as stored and its scores, one group
  // of asynchronous copies per stage (empty past the last).  Thread tid
  // copies position tid of a stage (nthr >= kTileB); its page comes from
  // a block-table entry loaded one stage ahead.
  const int32_t* bt = block_tables + (long long)b * sp.pps;
  const int n_tiles = (len_hi + kTileB - 1) / kTileB;
  // kWinCap: the walk starts at the stage of the tile's lowest seen
  // position; the stages before it hold only p = 0
  const int k0 = kWinCap ? tile_lo<kWinCap>(base, i0, nt, sp) / kTileB : 0;
  auto page_of = [&](int k) {
    const int t = k * kTileB + tid;
    return tid < kTileB && t < len_hi ? bt[t / sp.ps] : 0;
  };
  auto issue = [&](int k, int page) {
    if (k < n_tiles) {
      const int t0 = k * kTileB, n = min(kTileB, len_hi - t0);
      if (tid < n) {
        const int t = t0 + tid;
        pages.stage_v(raw_s + ((k % kStages) * kTileB + tid) *
                                  Pages::kStageBytes,
                      page, h, t % sp.ps, c0, t < qlen);
      }
      float* ss = sc_s + (k % kStages) * nt * kPst;
      for (int e = tid; e < nt * (kTileB / 4); e += nthr) {
        const int i = e / (kTileB / 4), tt = (e % (kTileB / 4)) * 4;
        if (tt < n)  // whole float4s: past n is never read
          cp_async16(ss + i * kPst + tt,
                     sp.ws + (row0 + i) * sp.s_pad + t0 + tt);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k0 + k, page_of(k0 + k));
  int page_next = page_of(k0 + kStages - 1);

  // one chain per (row, channel): p * v over the positions in order
  const int ci = tid / kSlice, cc = tid % kSlice;
  const bool chain = ci < nt;
  float acc = 0.f;
  for (int k = k0; k < n_tiles; ++k) {
    const int t0 = k * kTileB, n = min(kTileB, len_hi - t0);
    const uint8_t* rs = raw_s + (k % kStages) * kTileB * Pages::kStageBytes;
    float* ss = sc_s + (k % kStages) * nt * kPst;
    cp_async_wait<kStages - 2>();
    // stage k has landed, stage k - 1 is consumed (m_s, len_s, a_s are
    // set, on the first)
    __syncthreads();
    issue(k + kStages - 1, page_next);  // into the stage tile k - 1 used
    page_next = page_of(k + kStages);
    // V of the stage to f32, in (position, 8 channels) units
    for (int u = tid; u < 2 * n; u += nthr) {
      const bool quant = t0 + (u >> 1) < qlen;
      pages.decode(pages.unstage(rs + (u >> 1) * Pages::kStageBytes, c0,
                                 (u & 1) * 8, quant),
                   quant, v_s + (u >> 1) * kSlice + (u & 1) * 8);
    }
    // p over the stage, in place; virtual thread j of row i adds positions
    // j, j + kLWidth, ... to the row's denominator in order.  (row, lane)
    // pairs four per thread at a time, loads first.
    {
      constexpr int kPer = kTileB / kLWidth;  // positions per pair
      for (int p0 = 0; p0 < nt * kLWidth; p0 += 4 * nthr) {
        float sv[4][kPer], av[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pr = p0 + tid + j * nthr;
          if (pr < nt * kLWidth) {
            const int i = pr / kLWidth, r = pr % kLWidth;
            av[j] = a_s[i * kLWidth + r];
#pragma unroll
            for (int x = 0; x < kPer; ++x)
              sv[j][x] = ss[i * kPst + r + x * kLWidth];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pr = p0 + tid + j * nthr;
          if (pr < nt * kLWidth) {
            const int i = pr / kLWidth, r = pr % kLWidth;
            const int vis = len_s[i] - t0;
            const int lov = kWinCap ? lo_s[i] - t0 : 0;
            const float mx = m_s[i];
#pragma unroll
            for (int x = 0; x < kPer; ++x) {
              const int tt = r + x * kLWidth;
              if (tt < n) {
                const float p = tt < vis && (!kWinCap || tt >= lov)
                                    ? expf(sv[j][x] - mx) : 0.f;
                av[j] += p;
                ss[i * kPst + tt] = kArena ? bf16_round(p) : p;
              }
            }
            a_s[i * kLWidth + r] = av[j];
          }
        }
      }
    }
    __syncthreads();
    if (chain) {
      const float* pr = ss + ci * kPst;
      const float* vr = v_s + cc;
      int tt = 0;
      if (n >= 8) {  // software-pipelined: the next 8 loads ahead
        float pa[8], va[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          pa[u] = pr[u];
          va[u] = vr[u * kSlice];
        }
        for (; tt + 16 <= n; tt += 8) {
          float pn[8], vn[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            pn[u] = pr[tt + 8 + u];
            vn[u] = vr[(tt + 8 + u) * kSlice];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) acc += pa[u] * va[u];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            pa[u] = pn[u];
            va[u] = vn[u];
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += pa[u] * va[u];
        tt += 8;
      }
      for (; tt < n; ++tt) acc += pr[tt] * vr[tt * kSlice];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the last chain is done; a_s, when there was no tile

  // each row's denominator in the plain version's order
  for (int i = tid; i < nt; i += nthr) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kLWidth; w += 32) {
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = a_s[i * kLWidth + w + k];
      const float part = butterfly32(v);
      l = w == 0 ? part : l + part;
    }
    if (kArena && sl == 0) {
      m_out[row0 + i] = m_s[i];
      l_out[row0 + i] = l;
    }
    m_s[i] = l;
  }
  __syncthreads();
  if (chain)
    out[(row0 + ci) * sp.d + c0 + cc] =
        from_f32<QT>(kArena ? acc : acc / fmaxf(m_s[ci], 1e-30f));
}

// Positions per phase-A block, from the shapes alone: the largest power of
// two in [kMinChunk, kMaxChunk] whose K fits 32 KB of shared memory and
// that still gives the card eight blocks per SM (four for tiles of more
// than 8 rows, whose blocks do more arithmetic per byte).
int pick_chunk(long long bh, int tiles, int rows, int s_max, int d) {
  const long long want = (rows <= 8 ? 8LL : 4LL) * 132;
  int c = kMaxChunk;
  while (c > kMinChunk &&
         (c * d > 8192 || bh * tiles * ((s_max + c - 1) / c) < want))
    c /= 2;
  return c;
}

template <bool kArena, bool kStair, bool kWinCap, int kLWidth, int kStages,
          typename Pages, typename QT>
int launch_values(Pages pages, const int32_t* block_tables,
                  const int32_t* kv_lens, const int32_t* quant_lens, QT* out,
                  float* m, float* l, const Split& sp, long long bh,
                  int tiles, cudaStream_t st) {
  auto kb = split_values<kArena, kStair, kWinCap, kLWidth, kStages, Pages,
                         QT>;
  const size_t sb =
      (size_t)kStages * kTileB * Pages::kStageBytes +
      sizeof(float) * ((size_t)kStages * sp.tile * (kTileB + 4) +
                       (size_t)kTileB * kSlice +
                       (size_t)sp.tile * (kLWidth + (kWinCap ? 3 : 2)));
  int e = allow_smem(kb, sb);
  if (e) return e;
  int threads = (sp.tile * kSlice + 31) / 32 * 32;
  if (threads < kTileB) threads = kTileB;
  kb<<<dim3((unsigned)(bh * (sp.d / kSlice)), tiles), threads, sb, st>>>(
      pages, block_tables, kv_lens, quant_lens, out, m, l, sp);
  return (int)cudaGetLastError();
}

// Both phases on `stream`.  ws: the wrapper's f32 workspace of
// B * Hkv * rows * (s_pad + ceil(s_max / kMinChunk)) floats.  kWinCap:
// w query tokens a slot (row i is token i % w), the sliding window and
// the softcap (0: none).
template <bool kArena, bool kStair, bool kWarpDot, int kLWidth,
          typename Pages, typename QT, bool kWinCap = false>
int split_launch(const void* q, Pages pages, const int32_t* block_tables,
                 const int32_t* kv_lens, const int32_t* quant_lens,
                 float* ws, void* out, float* m, float* l, int b, int rows,
                 int gq, int d, int pps, int ps, float sm_scale,
                 void* stream, int w = 1, int window = 0, float cap = 0.f) {
  if (rows < 1 || d < kSlice || d % kSlice || d > kMaxD || pps < 1 ||
      ps < 1 || (kWinCap && (w < 1 || rows % w || window < 0 || cap < 0.f)))
    return (int)cudaErrorInvalidValue;
  Split sp;
  sp.rows = rows;
  sp.gq = gq;
  sp.tile = rows < kMaxTile ? rows : kMaxTile;
  sp.hkv = pages.hkv;
  sp.d = d;
  sp.pps = pps;
  sp.ps = ps;
  sp.s_max = pps * ps;
  sp.s_pad = (sp.s_max + 3) / 4 * 4;
  sp.sm_scale = sm_scale;
  const long long bh = (long long)b * pages.hkv;
  const int tiles = (rows + sp.tile - 1) / sp.tile;
  sp.chunk = pick_chunk(bh, tiles, sp.tile, sp.s_max, d);
  sp.n_chunks = (sp.s_max + sp.chunk - 1) / sp.chunk;
  sp.ws = ws;
  sp.cmax = ws + bh * rows * sp.s_pad;
  sp.w = w;
  sp.window = window;
  sp.cap = cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  auto ka = split_scores<kArena, kStair, kWarpDot, kWinCap, Pages, QT>;
  const size_t sa =
      sizeof(float) * ((size_t)sp.tile * d + (size_t)sp.chunk * (d + 8) +
                       (size_t)sp.tile * sp.chunk) +
      sizeof(int) * (size_t)(sp.chunk / ps + 2);
  int e = allow_smem(ka, sa);
  if (e) return e;
  ka<<<dim3((unsigned)(bh * sp.n_chunks), tiles), kThreads, sa, st>>>(
      static_cast<const QT*>(q), pages, block_tables, kv_lens, quant_lens,
      sp);
  e = (int)cudaGetLastError();
  if (e) return e;

  // phase B: four stages for tiles of up to 8 rows, else three (their
  // scores' shared memory); a thread per (row, channel), and at least one
  // per position of a stage
  if (sp.tile <= 8)
    return launch_values<kArena, kStair, kWinCap, kLWidth, 4>(
        pages, block_tables, kv_lens, quant_lens, static_cast<QT*>(out), m,
        l, sp, bh, tiles, st);
  return launch_values<kArena, kStair, kWinCap, kLWidth, 3>(
      pages, block_tables, kv_lens, quant_lens, static_cast<QT*>(out), m, l,
      sp, bh, tiles, st);
}

}  // namespace
