// Paged quantized decode attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_attention (body
// _paged_attn_kernel): attention of one new query token per slot (Gq GQA
// query rows per KV head) over that slot's KV pages, gathered through a
// block table, with the dequantization of quantized pages fused into the
// read.  Two entry points share the structure:
//
//   paged_attention        the Pallas interface: int8 or packed-int4 code
//                          pools (P, Hkv, PS, D') with group scales, f32
//                          math, masked at kv_lens, normalized output.
//   paged_attention_arena  the serving decode step's layout: per-layer bf16
//                          fp pool plus int8 code pool and per-channel f32
//                          scale pool, all (P, PS, Hkv, D); positions below
//                          quant_lens[b] read the quant pool, the rest the
//                          fp pool.  Quant values round to bf16, scores are
//                          bf16-rounded dots scaled in f32, and the output
//                          is the UNNORMALIZED bf16 sum with f32 max m and
//                          denominator l, so the caller merges the new
//                          token in closed form (the JAX package's
//                          multihead_attention(return_stats=True)).
//
// Bound on this card: bytes.  Every visible K and V element is read once
// (2 bytes fp, or 1 byte code + 4 bytes scale) for 2 flops per query row,
// far below the H100's ridge.  Design (simple first): one block per
// (slot, KV head, tile of up to kTileGq query rows) walks the slot's pages
// in order.  Pass 1: one warp per position, lanes across D, computes the
// tile's scores into a global f32 workspace (B, Hkv, Gq, PPS*PS) that the
// wrapper allocates.  Pass 2: the exact row max, the exponentials and the
// row sums.  Pass 3: one thread per channel accumulates p * v over the
// positions, reading each V row coalesced.  Taking the max before the
// exponentials (rather than rescaling a running max) keeps the arena
// entry's rounding points those of the reference softmax.  The score rows
// live in device memory (L2-resident at serving sizes), not in shared
// memory, so a slot's view has no length cap: shared memory holds only the
// tile's q, the reduction scratch and the block table.  Rows are taken in
// tiles on a second grid axis; each row's arithmetic is independent of the
// others', so the tiling changes no rounding.  Scratch page 0 and every
// position at or beyond the slot's length are never read.  No wgmma or TMA
// yet: with B * Hkv blocks this leaves most SMs idle at small batch;
// splitting the positions of a slot across blocks is the next step.
#include <math.h>
#include <stdint.h>

#include "paged_pages.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileGq = 16;  // query rows per block

// Block-wide reductions; every thread gets the result.
__device__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

// kArena selects the arena's rounding points and unnormalized output.
template <bool kArena, typename Pages, typename QT>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const QT* __restrict__ q, Pages pages,
                           const int32_t* __restrict__ block_tables,
                           const int32_t* __restrict__ kv_lens,
                           const int32_t* __restrict__ quant_lens,
                           float* __restrict__ ws, QT* __restrict__ out,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out, int hkv, int gq, int d,
                           int pps, int ps, float sm_scale) {
  extern __shared__ float smem[];
  const int s_max = pps * ps;
  const int g0 = blockIdx.y * kTileGq, nt = min(kTileGq, gq - g0);
  float* q_s = smem;                      // (nt, d)
  float* red = q_s + nt * d;              // kWarps
  int* bt_s = reinterpret_cast<int*>(red + kWarps);  // (pps)

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const long long row0 = (long long)blockIdx.x * gq + g0;  // first row
  float* sc = ws + row0 * s_max;          // (nt, s_max) scores, then p
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(kv_lens[b], s_max);  // never past the block table
  const int qlen = kArena ? quant_lens[b] : 0;
  const QT* qb = q + row0 * d;
  for (int i = tid; i < nt * d; i += kThreads) q_s[i] = to_f32(qb[i]);
  for (int i = tid; i < pps; i += kThreads) bt_s[i] = block_tables[b * pps + i];
  __syncthreads();

  // Pass 1: scores of every visible position, one warp per position.
  for (int t = warp; t < len; t += kWarps) {
    const int page = bt_s[t / ps], r = t % ps;
    const bool quant = t < qlen;
    float part[kTileGq];
    for (int g = 0; g < nt; ++g) part[g] = 0.f;
    for (int dd = lane; dd < d; dd += 32) {
      const float kv = pages.k(page, h, r, dd, quant);
      for (int g = 0; g < nt; ++g) part[g] += q_s[g * d + dd] * kv;
    }
    for (int g = 0; g < nt; ++g) {
      float v = part[g];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0)
        sc[(long long)g * s_max + t] =
            (kArena ? bf16_round(v) : v) * sm_scale;
    }
  }
  __syncthreads();

  // Pass 2: exact row max, exponentials, row sums.
  float m_g[kTileGq], l_g[kTileGq];
  for (int g = 0; g < nt; ++g) {
    float* row = sc + (long long)g * s_max;
    float mx = -INFINITY;
    for (int t = tid; t < len; t += kThreads) mx = fmaxf(mx, row[t]);
    mx = block_max(mx, red);
    float sum = 0.f;
    for (int t = tid; t < len; t += kThreads) {
      const float p = expf(row[t] - mx);
      sum += p;
      row[t] = kArena ? bf16_round(p) : p;
    }
    m_g[g] = mx;
    l_g[g] = block_sum(sum, red);  // block_sum syncs: row[] is complete
  }

  // Pass 3: one thread per channel accumulates p * v over the positions,
  // page by page in order.
  for (int dd = tid; dd < d; dd += kThreads) {
    float acc[kTileGq];
    for (int g = 0; g < nt; ++g) acc[g] = 0.f;
    for (int t0 = 0, pi = 0; t0 < len; t0 += ps, ++pi) {
      const int page = bt_s[pi];
      const int rows = min(ps, len - t0);
      for (int r = 0; r < rows; ++r) {
        const int t = t0 + r;
        const float vv = pages.v(page, h, r, dd, t < qlen);
        for (int g = 0; g < nt; ++g)
          acc[g] += sc[(long long)g * s_max + t] * vv;
      }
    }
    QT* ob = out + row0 * d;
    for (int g = 0; g < nt; ++g)
      ob[g * d + dd] =
          from_f32<QT>(kArena ? acc[g] : acc[g] / fmaxf(l_g[g], 1e-30f));
  }
  if (kArena && tid == 0) {
    for (int g = 0; g < nt; ++g) {
      m_out[row0 + g] = m_g[g];
      l_out[row0 + g] = l_g[g];
    }
  }
}

size_t smem_bytes(int gq, int d, int pps) {
  const int nt = gq < kTileGq ? gq : kTileGq;
  return sizeof(float) * ((size_t)nt * d + kWarps) + sizeof(int) * (size_t)pps;
}

template <bool kArena, typename Pages, typename QT>
int launch(const void* q, Pages pages, const int32_t* block_tables,
           const int32_t* kv_lens, const int32_t* quant_lens, float* ws,
           void* out, float* m, float* l, int b, int hkv, int gq, int d,
           int pps, int ps, float sm_scale, void* stream) {
  const size_t smem = smem_bytes(gq, d, pps);
  auto kernel = paged_attention_kernel<kArena, Pages, QT>;
  int e = allow_smem(kernel, smem);
  if (e) return e;
  const dim3 grid(b * hkv, (gq + kTileGq - 1) / kTileGq);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), pages, block_tables, kv_lens, quant_lens, ws,
      static_cast<QT*>(out), m, l, hkv, gq, d, pps, ps, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention(const void* q, int q_is_bf16,
                               const void* k_codes, const float* k_scale,
                               const void* v_codes, const float* v_scale,
                               const int32_t* block_tables,
                               const int32_t* kv_lens, float* ws, void* out,
                               int b, int hkv, int gq, int d, int pps, int ps,
                               int bits, int group, float sm_scale,
                               void* stream) {
  PallasPages pages{static_cast<const uint8_t*>(k_codes), k_scale,
                    static_cast<const uint8_t*>(v_codes), v_scale,
                    hkv, ps, d, bits, group};
  if (q_is_bf16)
    return launch<false, PallasPages, __nv_bfloat16>(
        q, pages, block_tables, kv_lens, nullptr, ws, out, nullptr, nullptr,
        b, hkv, gq, d, pps, ps, sm_scale, stream);
  return launch<false, PallasPages, float>(
      q, pages, block_tables, kv_lens, nullptr, ws, out, nullptr, nullptr, b,
      hkv, gq, d, pps, ps, sm_scale, stream);
}

extern "C" int paged_attention_arena(
    const void* q, const void* k_pool, const void* v_pool,
    const int8_t* k_codes, const float* k_scale, const int8_t* v_codes,
    const float* v_scale, const int32_t* block_tables, const int32_t* kv_lens,
    const int32_t* quant_lens, float* ws, void* out, float* m, float* l,
    int b, int hkv, int gq, int d, int pps, int ps, float sm_scale,
    void* stream) {
  ArenaPages pages{static_cast<const __nv_bfloat16*>(k_pool),
                   static_cast<const __nv_bfloat16*>(v_pool),
                   k_codes, k_scale, v_codes, v_scale, hkv, ps, d};
  return launch<true, ArenaPages, __nv_bfloat16>(
      q, pages, block_tables, kv_lens, quant_lens, ws, out, m, l, b, hkv, gq,
      d, pps, ps, sm_scale, stream);
}
