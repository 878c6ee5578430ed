// Quantized flash-decode attention over a dense KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (body
// _attn_kernel): attention of one new query token per slot (Gq GQA query
// rows per KV head) over that slot's dense quantized KV, int8 codes
// (B, Hkv, S, D) or nibble-packed int4 (B, Hkv, S, D/2) ((q + 8), low
// nibble first) with f32 group scales (B, Hkv, S, D/group), dequantized
// in f32 inside an online-softmax loop: running max m, denominator l and
// accumulator in f32, scores scaled by 1/sqrt(D), positions at or beyond
// the slot's length masked (a static length, or a (B,) int32 vector of
// per-slot lengths), output acc / max(l, 1e-30) in q's dtype.
//
// Bound on this card: bytes.  Every visible K and V element is read once
// (1 byte or half a byte of code, plus a 4-byte scale per group) for 2
// flops per query row, far below the H100's ridge.  Design (simple
// first): one block of 128 threads per (slot, KV head, tile of query
// rows) walks the slot's positions in order, in chunks of the caller's
// block_s positions (at most kMaxChunk).  For each chunk:
//   1. one warp per position, each lane four channels (one 4-byte or
//      2-byte code load, the group scale, f32 dequantization), computes
//      the tile's scores into shared memory (a butterfly per row);
//   2. one warp per row takes the chunk's max, the new running max, the
//      rescale factor exp(m_old - m_new), the exponentials and the sum;
//   3. one warp per position, each lane four channels, rescales its
//      partial accumulators and adds p * v.
// The four warps' partial accumulators are summed in order at the end.
// Each warp loads kAhead positions' codes before it uses them, so the
// loads of one warp overlap.  Positions at or beyond the slot's length are
// never read, so the work follows the lengths.  The tile holds 16 rows at
// D <= 128 (8 at D <= 256, 4 at D <= 512: the lane's accumulators stay at
// 64 floats); more rows take more tiles on a second grid axis, with no cap
// on Gq.  Nothing caps S but device memory.  No wgmma or TMA yet, and the
// positions of a slot are not split across blocks: with B * Hkv blocks
// most SMs idle at small batch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;   // positions per online-softmax step
constexpr int kAhead = 4;        // positions a warp loads before using them

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

// Channels 4*cq .. 4*cq+3 of position t, dequantized in f32.
template <int kBits>
__device__ __forceinline__ void load4(const uint8_t* __restrict__ codes,
                                      const float* __restrict__ scales,
                                      long long t, int cq, int d, int group,
                                      float* o) {
  int c[4];
  if (kBits == 8) {
    const char4 v = *reinterpret_cast<const char4*>(codes + t * d + 4 * cq);
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  } else {
    const unsigned v =
        *reinterpret_cast<const uint16_t*>(codes + t * (d / 2) + 2 * cq);
    c[0] = (int)(v & 0xF) - 8;
    c[1] = (int)((v >> 4) & 0xF) - 8;
    c[2] = (int)((v >> 8) & 0xF) - 8;
    c[3] = (int)(v >> 12) - 8;
  }
  const float* srow = scales + t * (d / group);
  if (group % 4 == 0) {
    const float s = srow[4 * cq / group];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = (float)c[i] * s;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = (float)c[i] * srow[(4 * cq + i) / group];
  }
}

// kQ: channel quads per lane (D <= 128 * kQ); the tile has 16 / kQ rows.
template <typename QT, int kBits, int kQ>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const QT* __restrict__ q,
                            const uint8_t* __restrict__ k_codes,
                            const float* __restrict__ k_scale,
                            const uint8_t* __restrict__ v_codes,
                            const float* __restrict__ v_scale,
                            const int32_t* __restrict__ kv_lens,
                            int static_len, QT* __restrict__ out, int hkv,
                            int gq, int s, int d, int group, int chunk,
                            float sm_scale) {
  constexpr int kRows = 16 / kQ;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // (kRows, d)
  float* o_s = q_s + kRows * d;         // (kRows, d) the warps' sum
  float* sc = o_s + kRows * d;          // (kRows, chunk) scores, then p
  float* m_s = sc + kRows * chunk;      // (kRows) running max
  float* l_s = m_s + kRows;             // (kRows) running denominator
  float* a_s = l_s + kRows;             // (kRows) this chunk's rescale

  const long long bh = blockIdx.x;      // b * Hkv + h
  const int g0 = blockIdx.y * kRows, nt = min(kRows, gq - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(kv_lens ? kv_lens[blockIdx.x / hkv] : static_len, s);
  const int nq = d / 4;                 // channel quads
  const int cw = kBits == 8 ? d : d / 2;
  const int ng = d / group;
  const uint8_t* kc = k_codes + bh * s * cw;
  const uint8_t* vc = v_codes + bh * s * cw;
  const float* ks = k_scale + bh * s * ng;
  const float* vs = v_scale + bh * s * ng;
  const long long row0 = bh * gq + g0;
  const QT* qb = q + row0 * d;
  for (int i = tid; i < nt * d; i += kThreads) q_s[i] = to_f32(qb[i]);
  if (tid < kRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  float acc[kRows][4 * kQ];             // this warp's partial sums
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < 4 * kQ; ++i) acc[r][i] = 0.f;

  for (int c0 = 0; c0 < len; c0 += chunk) {
    const int cn = min(chunk, len - c0);  // visible positions of the chunk

    // 1. Scores: one warp per position, lanes across the channel quads.
    for (int j0 = warp; j0 < cn; j0 += kWarps * kAhead) {
      float kv[kAhead][4 * kQ];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = j0 + u * kWarps;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const int cq = lane + 32 * k;
          if (j < cn && cq < nq)
            load4<kBits>(kc, ks, c0 + j, cq, d, group, &kv[u][4 * k]);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = j0 + u * kWarps;
        if (j >= cn) break;               // uniform across the warp
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r >= nt) break;
          float part = 0.f;
#pragma unroll
          for (int k = 0; k < kQ; ++k) {
            const int cq = lane + 32 * k;
            if (cq < nq) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(q_s + r * d + 4 * cq);
              part += qv.x * kv[u][4 * k] + qv.y * kv[u][4 * k + 1] +
                      qv.z * kv[u][4 * k + 2] + qv.w * kv[u][4 * k + 3];
            }
          }
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (lane == 0) sc[r * chunk + j] = part * sm_scale;
        }
      }
    }
    __syncthreads();

    // 2. Online softmax: one warp per row.
    for (int r = warp; r < nt; r += kWarps) {
      float* row = sc + r * chunk;
      float mx = -INFINITY;
      for (int j = lane; j < cn; j += 32) mx = fmaxf(mx, row[j]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < cn; j += 32) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();                       // every lane has read m_s[r]
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first chunk
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 3. Rescale, then accumulate p * v: one warp per position.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nt) {
        const float alpha = a_s[r];
#pragma unroll
        for (int i = 0; i < 4 * kQ; ++i) acc[r][i] *= alpha;
      }
    }
    for (int j0 = warp; j0 < cn; j0 += kWarps * kAhead) {
      float vv[kAhead][4 * kQ];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = j0 + u * kWarps;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const int cq = lane + 32 * k;
          if (j < cn && cq < nq)
            load4<kBits>(vc, vs, c0 + j, cq, d, group, &vv[u][4 * k]);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = j0 + u * kWarps;
        if (j >= cn) break;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nt) {
            const float p = sc[r * chunk + j];
#pragma unroll
            for (int i = 0; i < 4 * kQ; ++i) acc[r][i] += p * vv[u][i];
          }
        }
      }
    }
    __syncthreads();   // sc and a_s are rewritten by the next chunk
  }

  // 4. The warps' partial sums, in warp order, then normalize.
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nt) break;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const int cq = lane + 32 * k;
          if (cq < nq) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float* o = o_s + r * d + 4 * cq + i;
              *o = (w == 0 ? 0.f : *o) + acc[r][4 * k + i];
            }
          }
        }
      }
    }
    __syncthreads();
  }
  QT* ob = out + row0 * d;
  for (int i = tid; i < nt * d; i += kThreads)
    ob[i] = from_f32<QT>(o_s[i] / fmaxf(l_s[i / d], 1e-30f));
}

size_t smem_bytes(int rows, int d, int chunk) {
  return sizeof(float) * ((size_t)2 * rows * d + (size_t)rows * chunk +
                          3 * rows);
}

template <typename QT, int kBits, int kQ>
int launch(const void* q, const void* k_codes, const float* k_scale,
           const void* v_codes, const float* v_scale, const int32_t* kv_lens,
           int static_len, void* out, int b, int hkv, int gq, int s, int d,
           int group, int chunk, float sm_scale, cudaStream_t stream) {
  constexpr int kRows = 16 / kQ;
  auto kernel = decode_attention_kernel<QT, kBits, kQ>;
  const size_t smem = smem_bytes(kRows, d, chunk);
  if (smem > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e) return e;
  }
  const dim3 grid(b * hkv, (gq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const uint8_t*>(k_codes),
      k_scale, static_cast<const uint8_t*>(v_codes), v_scale, kv_lens,
      static_len, static_cast<QT*>(out), hkv, gq, s, d, group, chunk,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename QT, int kBits>
int dispatch_d(const void* q, const void* kc, const float* ks,
               const void* vc, const float* vs, const int32_t* kv_lens,
               int static_len, void* out, int b, int hkv, int gq, int s,
               int d, int group, int chunk, float sm_scale,
               cudaStream_t stream) {
  if (d <= 128)
    return launch<QT, kBits, 1>(q, kc, ks, vc, vs, kv_lens, static_len, out,
                                b, hkv, gq, s, d, group, chunk, sm_scale,
                                stream);
  if (d <= 256)
    return launch<QT, kBits, 2>(q, kc, ks, vc, vs, kv_lens, static_len, out,
                                b, hkv, gq, s, d, group, chunk, sm_scale,
                                stream);
  return launch<QT, kBits, 4>(q, kc, ks, vc, vs, kv_lens, static_len, out, b,
                              hkv, gq, s, d, group, chunk, sm_scale, stream);
}

}  // namespace

// kv_lens: a (B,) int32 device vector of per-slot lengths, or null for
// static_len on every slot.  Refuses D not a multiple of 4 or above 512,
// a group not dividing D, bits other than 4 and 8, and a chunk outside
// 1..kMaxChunk.
extern "C" int decode_attention(const void* q, int q_is_bf16,
                                const void* k_codes, const float* k_scale,
                                const void* v_codes, const float* v_scale,
                                const int32_t* kv_lens, int static_len,
                                void* out, int b, int hkv, int gq, int s,
                                int d, int bits, int group, int chunk,
                                float sm_scale, void* stream) {
  if (d < 4 || d % 4 || d > 512 || group < 1 || d % group ||
      (bits != 4 && bits != 8) || chunk < 1 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_is_bf16) {
    if (bits == 8)
      return dispatch_d<__nv_bfloat16, 8>(q, k_codes, k_scale, v_codes,
                                          v_scale, kv_lens, static_len, out,
                                          b, hkv, gq, s, d, group, chunk,
                                          sm_scale, st);
    return dispatch_d<__nv_bfloat16, 4>(q, k_codes, k_scale, v_codes,
                                        v_scale, kv_lens, static_len, out, b,
                                        hkv, gq, s, d, group, chunk,
                                        sm_scale, st);
  }
  if (bits == 8)
    return dispatch_d<float, 8>(q, k_codes, k_scale, v_codes, v_scale,
                                kv_lens, static_len, out, b, hkv, gq, s, d,
                                group, chunk, sm_scale, st);
  return dispatch_d<float, 4>(q, k_codes, k_scale, v_codes, v_scale, kv_lens,
                              static_len, out, b, hkv, gq, s, d, group, chunk,
                              sm_scale, st);
}
