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
// (slot, KV head) walks the slot's pages in order.  Pass 1: one warp per
// position, lanes across D, computes the Gq scores into shared memory.
// Pass 2: the exact row max, the exponentials and the row sums.  Pass 3:
// one thread per channel accumulates p * v over the positions, reading
// each V row coalesced.  Taking the max before the exponentials (rather
// than rescaling a running max) keeps the arena entry's rounding points
// those of the reference softmax.  Scratch page 0 and every position at or
// beyond the slot's length are never read.  No wgmma or TMA yet: with
// B * Hkv blocks this leaves most SMs idle at small batch; splitting the
// positions of a slot across blocks is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGq = 16;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// Where K/V element (t, d) of slot b, head h lives, and how it decodes.
struct PallasPages {  // (P, Hkv, PS, D') codes + (P, Hkv, PS, D/group) f32
  const uint8_t* kc;
  const float* ks;
  const uint8_t* vc;
  const float* vs;
  int hkv, ps, d, bits, group;

  __device__ __forceinline__ long long row(int page, int h, int r) const {
    return ((long long)page * hkv + h) * ps + r;
  }
  __device__ __forceinline__ float load(const uint8_t* c, const float* s,
                                        long long rw, int dd) const {
    int q;
    if (bits == 4) {
      const uint8_t byte = c[rw * (d / 2) + dd / 2];
      q = (int)((dd & 1) ? (byte >> 4) : (byte & 0x0F)) - 8;
    } else {
      q = reinterpret_cast<const int8_t*>(c)[rw * d + dd];
    }
    return (float)q * s[rw * (d / group) + dd / group];
  }
  __device__ __forceinline__ float k(int page, int h, int r, int dd,
                                     bool) const {
    return load(kc, ks, row(page, h, r), dd);
  }
  __device__ __forceinline__ float v(int page, int h, int r, int dd,
                                     bool) const {
    return load(vc, vs, row(page, h, r), dd);
  }
};

struct ArenaPages {  // all (P, PS, Hkv, D): bf16 fp, int8 codes, f32 scales
  const __nv_bfloat16* kf;
  const __nv_bfloat16* vf;
  const int8_t* kc;
  const float* ks;
  const int8_t* vc;
  const float* vs;
  int hkv, ps, d;

  __device__ __forceinline__ long long at(int page, int h, int r,
                                          int dd) const {
    return (((long long)page * ps + r) * hkv + h) * d + dd;
  }
  __device__ __forceinline__ float k(int page, int h, int r, int dd,
                                     bool quant) const {
    const long long i = at(page, h, r, dd);
    return quant ? bf16_round((float)kc[i] * ks[i]) : __bfloat162float(kf[i]);
  }
  __device__ __forceinline__ float v(int page, int h, int r, int dd,
                                     bool quant) const {
    const long long i = at(page, h, r, dd);
    return quant ? bf16_round((float)vc[i] * vs[i]) : __bfloat162float(vf[i]);
  }
};

// kArena selects the arena's rounding points and unnormalized output.
template <bool kArena, typename Pages, typename QT>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const QT* __restrict__ q, Pages pages,
                           const int32_t* __restrict__ block_tables,
                           const int32_t* __restrict__ kv_lens,
                           const int32_t* __restrict__ quant_lens,
                           QT* __restrict__ out, float* __restrict__ m_out,
                           float* __restrict__ l_out, int hkv, int gq, int d,
                           int pps, int ps, float sm_scale) {
  extern __shared__ float smem[];
  const int s_max = pps * ps;
  float* q_s = smem;                      // (gq, d)
  float* sc = q_s + gq * d;               // (gq, s_max) scores, then p
  float* red = sc + (long long)gq * s_max;  // kWarps
  int* bt_s = reinterpret_cast<int*>(red + kWarps);  // (pps)

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(kv_lens[b], s_max);  // never past the block table
  const int qlen = kArena ? quant_lens[b] : 0;
  const QT* qb = q + ((long long)b * hkv + h) * gq * d;
  for (int i = tid; i < gq * d; i += kThreads) q_s[i] = to_f32(qb[i]);
  for (int i = tid; i < pps; i += kThreads) bt_s[i] = block_tables[b * pps + i];
  __syncthreads();

  // Pass 1: scores of every visible position, one warp per position.
  for (int t = warp; t < len; t += kWarps) {
    const int page = bt_s[t / ps], r = t % ps;
    const bool quant = t < qlen;
    float part[kMaxGq];
    for (int g = 0; g < gq; ++g) part[g] = 0.f;
    for (int dd = lane; dd < d; dd += 32) {
      const float kv = pages.k(page, h, r, dd, quant);
      for (int g = 0; g < gq; ++g) part[g] += q_s[g * d + dd] * kv;
    }
    for (int g = 0; g < gq; ++g) {
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
  float m_g[kMaxGq], l_g[kMaxGq];
  for (int g = 0; g < gq; ++g) {
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
    float acc[kMaxGq];
    for (int g = 0; g < gq; ++g) acc[g] = 0.f;
    for (int t0 = 0, pi = 0; t0 < len; t0 += ps, ++pi) {
      const int page = bt_s[pi];
      const int rows = min(ps, len - t0);
      for (int r = 0; r < rows; ++r) {
        const int t = t0 + r;
        const float vv = pages.v(page, h, r, dd, t < qlen);
        for (int g = 0; g < gq; ++g)
          acc[g] += sc[(long long)g * s_max + t] * vv;
      }
    }
    QT* ob = out + ((long long)b * hkv + h) * gq * d;
    for (int g = 0; g < gq; ++g)
      ob[g * d + dd] =
          from_f32<QT>(kArena ? acc[g] : acc[g] / fmaxf(l_g[g], 1e-30f));
  }
  if (kArena && tid == 0) {
    for (int g = 0; g < gq; ++g) {
      m_out[((long long)b * hkv + h) * gq + g] = m_g[g];
      l_out[((long long)b * hkv + h) * gq + g] = l_g[g];
    }
  }
}

size_t smem_bytes(int gq, int d, int pps, int ps) {
  return sizeof(float) * ((size_t)gq * d + (size_t)gq * pps * ps + kWarps) +
         sizeof(int) * (size_t)pps;
}

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int paged_attention(const void* q, int q_is_bf16,
                               const void* k_codes, const float* k_scale,
                               const void* v_codes, const float* v_scale,
                               const int32_t* block_tables,
                               const int32_t* kv_lens, void* out, int b,
                               int hkv, int gq, int d, int pps, int ps,
                               int bits, int group, float sm_scale,
                               void* stream) {
  if (gq > kMaxGq) return (int)cudaErrorInvalidValue;
  PallasPages pages{static_cast<const uint8_t*>(k_codes), k_scale,
                    static_cast<const uint8_t*>(v_codes), v_scale,
                    hkv, ps, d, bits, group};
  const size_t smem = smem_bytes(gq, d, pps, ps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_is_bf16) {
    auto kernel = paged_attention_kernel<false, PallasPages, __nv_bfloat16>;
    int e = allow_smem(kernel, smem);
    if (e) return e;
    kernel<<<b * hkv, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), pages, block_tables, kv_lens,
        nullptr, static_cast<__nv_bfloat16*>(out), nullptr, nullptr, hkv, gq,
        d, pps, ps, sm_scale);
  } else {
    auto kernel = paged_attention_kernel<false, PallasPages, float>;
    int e = allow_smem(kernel, smem);
    if (e) return e;
    kernel<<<b * hkv, kThreads, smem, s>>>(
        static_cast<const float*>(q), pages, block_tables, kv_lens, nullptr,
        static_cast<float*>(out), nullptr, nullptr, hkv, gq, d, pps, ps,
        sm_scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_arena(
    const void* q, const void* k_pool, const void* v_pool,
    const int8_t* k_codes, const float* k_scale, const int8_t* v_codes,
    const float* v_scale, const int32_t* block_tables, const int32_t* kv_lens,
    const int32_t* quant_lens, void* out, float* m, float* l, int b, int hkv,
    int gq, int d, int pps, int ps, float sm_scale, void* stream) {
  if (gq > kMaxGq) return (int)cudaErrorInvalidValue;
  ArenaPages pages{static_cast<const __nv_bfloat16*>(k_pool),
                   static_cast<const __nv_bfloat16*>(v_pool),
                   k_codes, k_scale, v_codes, v_scale, hkv, ps, d};
  const size_t smem = smem_bytes(gq, d, pps, ps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = paged_attention_kernel<true, ArenaPages, __nv_bfloat16>;
  int e = allow_smem(kernel, smem);
  if (e) return e;
  kernel<<<b * hkv, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), pages, block_tables, kv_lens,
      quant_lens, static_cast<__nv_bfloat16*>(out), m, l, hkv, gq, d, pps, ps,
      sm_scale);
  return (int)cudaGetLastError();
}
