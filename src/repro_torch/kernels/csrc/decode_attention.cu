// Quantized flash-decode attention over a dense KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (body
// _attn_kernel): attention of one new query token per slot (Gq GQA query
// rows per KV head) over that slot's dense quantized KV, int8 codes
// (B, Hkv, S, D) or nibble-packed int4 (B, Hkv, S, D/2) ((q + 8), low
// nibble first) with f32 group scales (B, Hkv, S, D/group), dequantized
// in f32: scores scaled by 1/sqrt(D), positions at or beyond the slot's
// length masked (a static length, or a (B,) int32 vector of per-slot
// lengths), softmax, output acc / max(l, 1e-30) in q's dtype.
//
// Bound on this card: bytes.  Every visible K and V element is read once
// (1 byte or half a byte of code, plus a 4-byte scale per group) for 2
// flops per query row, far below the H100's ridge; at the slot-arena
// shape (B 6, Hkv 8, Gq 4, D 128, S 1056, int8) 14 MB, 4.2 us at 3.35
// TB/s.  Reaching it needs megabytes in flight across the card, so the
// positions of each slot are split across blocks (flash-decoding), two
// launches:
//   1. decode_split_kernel, grid (slot x KV head x split, row tile): each
//      block takes kSplit = 64 positions of one slot and KV head (a fixed
//      count, independent of B, Hkv, S and block_s) and a tile of 4, 8 or
//      16 query rows.  It stages the split's K and V codes and scales in
//      shared memory with 16-byte cp.async, K and V in two copy groups so
//      that the scores overlap V's arrival (rows padded by 16 bytes
//      against bank conflicts), computes the scores with two threads per
//      position (each half the channels, 16-byte code reads, codes widened
//      by a byte permute and a subtraction instead of the quarter-rate
//      int-to-float conversion), takes the split's local max m and
//      denominator l (one warp per row), and sums p * v with each thread
//      four channels of every G-th position; the G groups' partial sums
//      are added in group order.  It writes the unnormalized f32 sum and
//      (m, l) per (row, split) to an f32 workspace.  Splits at or beyond
//      the slot's length neither read nor write: phase 2 stops at the
//      slot's last split.
//   2. decode_combine_kernel, one thread per (row, channel): M = max of
//      the splits' m, then the sum and l over the splits in split order,
//      each split rescaled by exp(m_i - M), and sum / max(l, 1e-30).
// Split boundaries and the combine order depend on position indices only,
// so a slot run alone at its length gives its row of a batched call bit
// for bit, and two launches give the same bits (no atomics).  Sums differ
// in order from the plain version's (held at a tolerance, not bit for
// bit).  f32 FMAs only: no tensor-core dot (bf16 or TF32 rounding of the
// dequantized values would break the f32-q tolerance).  More rows than 16
// take more tiles on the second grid axis, with no cap on Gq; nothing caps
// S but device memory.  On the H100 at the slot-arena shape, phase 1 with
// its loads removed takes most of its time: it is bound by instructions
// (dequantization and FMAs), not bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 64;        // positions per phase-1 block
constexpr int kParts = 2;         // threads per position in the scores
constexpr int kThreads = kParts * kSplit;
constexpr int kScaleStage = 16;   // groups per position staged, at most
constexpr int kCombineThreads = 128;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// n rows of cw code bytes (contiguous in global memory) into shared rows
// of stride ss: 16-byte copies where the rows allow them.
__device__ __forceinline__ void stage_codes(uint8_t* dst, int ss,
                                            const uint8_t* src, int n,
                                            int cw, int tid) {
  if (cw % 16 == 0 && ((uintptr_t)src & 15) == 0) {
    const int per = cw / 16;
    const int sh = (per & (per - 1)) ? -1 : __ffs(per) - 1;
    for (int i = tid; i < n * per; i += kThreads) {
      const int r = sh >= 0 ? i >> sh : i / per, c = i - r * per;
      cp_async16(dst + r * ss + 16 * c, src + (size_t)r * cw + 16 * c);
    }
  } else if (cw % 4 == 0 && ((uintptr_t)src & 3) == 0) {
    const int per = cw / 4;
    for (int i = tid; i < n * per; i += kThreads) {
      const int r = i / per, c = i - r * per;
      cp_async4(dst + r * ss + 4 * c, src + (size_t)r * cw + 4 * c);
    }
  } else {
    for (int i = tid; i < n * cw; i += kThreads) {
      const int r = i / cw;
      dst[r * ss + (i - r * cw)] = src[i];
    }
  }
}

// count contiguous floats into shared memory (16-byte aligned).
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             int count, int tid) {
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    done = count / 4 * 4;
    for (int i = tid; i < count / 4; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
  }
  for (int i = done + tid; i < count; i += kThreads)
    cp_async4(dst + i, src + i);
}

template <int kBits>
__device__ __forceinline__ int code_at(const uint8_t* row, int ch) {
  if (kBits == 8) return (int)(int8_t)row[ch];
  const unsigned b = row[ch >> 1];
  return (int)((ch & 1) ? (b >> 4) : (b & 0xF)) - 8;
}

// Byte i of w (an unsigned value b < 256) as the exact float 2^23 + b: the
// int-to-float conversions run at a quarter of the f32 rate, a byte
// permute and a subtraction at full rate.
__device__ __forceinline__ float biased(unsigned w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + i));
}
constexpr float kBias8 = 8388736.f;   // 2^23 + 128: int8 codes, sign-flipped
constexpr float kBias4 = 8388616.f;   // 2^23 + 8: int4 codes (q + 8)

// The channels of one 32-bit word of codes, as exact floats: 4 (int8) or
// 8 (int4, low nibble first).
template <int kBits>
__device__ __forceinline__ void codes_of(unsigned w, float* o) {
  if (kBits == 8) {
    const unsigned u = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = biased(u, i) - kBias8;
  } else {
    const unsigned lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = biased(lo, i) - kBias4;
      o[2 * i + 1] = biased(hi, i) - kBias4;
    }
  }
}

// The group of channel ch: a shift when the group is a power of two.
__device__ __forceinline__ int group_of(int ch, int group, int gshift) {
  return gshift >= 0 ? ch >> gshift : ch / group;
}

// The 16-byte chunk c of a staged code row, dequantized in f32: 16
// channels (int8) or 32 (int4) from channel kCh * c.
template <int kBits>
__device__ __forceinline__ void dequant_chunk(const uint8_t* row, int c,
                                              const float* srow, int group,
                                              int gshift, float* o) {
  constexpr int kCh = kBits == 8 ? 16 : 32;
  constexpr int kPer = kCh / 4;         // channels per 32-bit word
  const uint4 w = *reinterpret_cast<const uint4*>(row + 16 * c);
  codes_of<kBits>(w.x, o);
  codes_of<kBits>(w.y, o + kPer);
  codes_of<kBits>(w.z, o + 2 * kPer);
  codes_of<kBits>(w.w, o + 3 * kPer);
  const int ch0 = kCh * c;
  if (group % kCh == 0) {
    const float s = srow[group_of(ch0, group, gshift)];
#pragma unroll
    for (int i = 0; i < kCh; ++i) o[i] *= s;
  } else {
#pragma unroll
    for (int i = 0; i < kCh; ++i)
      o[i] *= srow[group_of(ch0 + i, group, gshift)];
  }
}

// Channels 4*cq .. 4*cq+3 of a staged code row, dequantized in f32.
template <int kBits>
__device__ __forceinline__ void dequant_quad(const uint8_t* row, int cq,
                                             const float* srow, int group,
                                             int gshift, float* o) {
  if (kBits == 8) {
    codes_of<8>(*reinterpret_cast<const unsigned*>(row + 4 * cq), o);
  } else {
    float c8[8];
    codes_of<4>(*reinterpret_cast<const uint16_t*>(row + 2 * cq), c8);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = c8[i];
  }
  if (group % 4 == 0) {
    const float s = srow[group_of(4 * cq, group, gshift)];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] *= s;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] *= srow[group_of(4 * cq + i, group, gshift)];
  }
}

struct Layout {   // phase 1's shared memory, in bytes from the base
  int q, kbuf, vbuf, ksc, vsc, sc, ml, total;
};

__host__ __device__ inline Layout layout(int rows, int d, int cw, int ng) {
  const int ss = round16(cw) + 16;
  const bool staged = ng <= kScaleStage;
  const int scales = staged ? round16(kSplit * ng * 4) : 0;
  Layout l;
  l.q = 0;
  l.kbuf = round16(rows * d * 4);
  l.vbuf = l.kbuf + kSplit * ss;
  // after p * v, the groups' partial sums (at most 512 floats a row) go
  // over the K and V codes
  const int kv = 2 * kSplit * ss > rows * 2048 ? 2 * kSplit * ss
                                               : rows * 2048;
  l.ksc = l.kbuf + kv;
  l.vsc = l.ksc + scales;
  l.sc = l.vsc + scales;
  l.ml = l.sc + kParts * rows * kSplit * 4;
  l.total = l.ml + 2 * rows * 4;
  return l;
}

// kRows: query rows per tile, 4, 8 or 16; 8, 6 or 4 blocks an SM.
template <typename QT, int kBits, int kRows>
__global__ void __launch_bounds__(kThreads, 32 / kRows + (kRows == 4 ? 0 : 2))
    decode_split_kernel(const QT* __restrict__ q,
                        const uint8_t* __restrict__ k_codes,
                        const float* __restrict__ k_scale,
                        const uint8_t* __restrict__ v_codes,
                        const float* __restrict__ v_scale,
                        const int32_t* __restrict__ kv_lens, int static_len,
                        float* __restrict__ ws_acc,
                        float2* __restrict__ ws_ml, int hkv, int gq, int s,
                        int d, int group, int nsplit, float sm_scale) {
  constexpr int kCh = kBits == 8 ? 16 : 32;   // channels per 16-byte chunk
  extern __shared__ __align__(16) uint8_t smem[];

  const long long bh = blockIdx.x / nsplit;   // b * Hkv + h
  const int sp = (int)(blockIdx.x - bh * nsplit);
  const int len = min(kv_lens ? kv_lens[bh / hkv] : static_len, s);
  const int p0 = sp * kSplit;
  if (p0 >= len) return;                      // past the slot's length
  const int n = min(kSplit, len - p0);        // visible positions
  const int g0 = blockIdx.y * kRows, nt = min(kRows, gq - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cw = kBits == 8 ? d : d / 2;
  const int ss = round16(cw) + 16;
  const int ng = d / group;
  const int gshift = (group & (group - 1)) ? -1 : __ffs(group) - 1;
  const Layout lay = layout(kRows, d, cw, ng);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);      // (kRows, d)
  uint8_t* kbuf = smem + lay.kbuf;                          // (kSplit, ss)
  uint8_t* vbuf = smem + lay.vbuf;                          // (kSplit, ss)
  float* sc = reinterpret_cast<float*>(smem + lay.sc);  // (kParts, kRows,
                                                        //  kSplit)
  float* m_s = reinterpret_cast<float*>(smem + lay.ml);
  float* l_s = m_s + kRows;

  // Two copy groups, K then V: the scores overlap V's arrival.
  const long long pos = bh * s + p0;          // the split's first position
  const bool staged = ng <= kScaleStage;
  const float* ksc = k_scale + pos * ng;
  const float* vsc = v_scale + pos * ng;
  stage_codes(kbuf, ss, k_codes + pos * cw, n, cw, tid);
  if (staged) {
    float* ks_s = reinterpret_cast<float*>(smem + lay.ksc);
    stage_floats(ks_s, ksc, n * ng, tid);
    ksc = ks_s;
  }
  cp_async_commit();
  stage_codes(vbuf, ss, v_codes + pos * cw, n, cw, tid);
  if (staged) {
    float* vs_s = reinterpret_cast<float*>(smem + lay.vsc);
    stage_floats(vs_s, vsc, n * ng, tid);
    vsc = vs_s;
  }
  cp_async_commit();
  const long long row0 = bh * gq + g0;
  const QT* qb = q + row0 * d;
  for (int i = tid; i < nt * d; i += kThreads) q_s[i] = to_f32(qb[i]);
  cp_async_wait<1>();
  __syncthreads();

  // 1. Scores: kParts threads per position, each a share of the 16-byte
  // chunks; their partial sums go to kParts slices of sc.
  {
    const int p = tid % kSplit, h = tid / kSplit;
    if (p < n) {
      float part[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = 0.f;
      const uint8_t* krow = kbuf + p * ss;
      const float* srow = ksc + p * ng;
      const int nfull = cw / 16;
      const int c_hi = nfull * (h + 1) / kParts;
      for (int c = nfull * h / kParts; c < c_hi; ++c) {
        float kv[kCh];
        dequant_chunk<kBits>(krow, c, srow, group, gshift, kv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nt) {
            const float4* qr =
                reinterpret_cast<const float4*>(q_s + r * d + kCh * c);
#pragma unroll
            for (int i = 0; i < kCh / 4; ++i) {
              const float4 qv = qr[i];
              part[r] = fmaf(qv.x, kv[4 * i], part[r]);
              part[r] = fmaf(qv.y, kv[4 * i + 1], part[r]);
              part[r] = fmaf(qv.z, kv[4 * i + 2], part[r]);
              part[r] = fmaf(qv.w, kv[4 * i + 3], part[r]);
            }
          }
        }
      }
      if (h == kParts - 1) {   // channels of a last, partial chunk
        for (int ch = nfull * kCh; ch < d; ++ch) {
          const float kv = (float)code_at<kBits>(krow, ch) *
                           srow[group_of(ch, group, gshift)];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r < nt) part[r] = fmaf(q_s[r * d + ch], kv, part[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nt) sc[(h * kRows + r) * kSplit + p] = part[r];
    }
  }
  __syncthreads();

  // 2. The split's max and denominator: one warp per row; p over sc[0].
  for (int r = warp; r < nt; r += kThreads / 32) {
    float* s0 = sc + r * kSplit;
    float v[kSplit / 32], mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < kSplit / 32; ++u) {
      const int j = lane + 32 * u;
      float sj = s0[j];
#pragma unroll
      for (int h = 1; h < kParts; ++h) sj += sc[(h * kRows + r) * kSplit + j];
      v[u] = j < n ? sj * sm_scale : -INFINITY;
      mx = fmaxf(mx, v[u]);
    }
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kSplit / 32; ++u) {
      const float pv = expf(v[u] - mx);         // 0 past the length
      s0[lane + 32 * u] = pv;
      sum += pv;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. p * v: each thread four channels of every G-th position.
  const int nq = d / 4, groups = kThreads / nq;
  const int cq = tid % nq, g = tid / nq;
  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  if (g < groups) {
#pragma unroll 4
    for (int j = g; j < n; j += groups) {
      float vv[4];
      dequant_quad<kBits>(vbuf + j * ss, cq, vsc + j * ng, group, gshift,
                          vv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nt) {
          const float pr = sc[r * kSplit + j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(pr, vv[i], acc[r][i]);
        }
      }
    }
  }
  // The groups' partial sums, (groups, kRows, d) over the codes, then
  // added in group order, one quad of a row per thread.
  __syncthreads();
  float* part = reinterpret_cast<float*>(kbuf);
  if (g < groups) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nt)
        *reinterpret_cast<float4*>(part + (g * kRows + r) * d + 4 * cq) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int i = tid; i < nt * nq; i += kThreads) {
    const int r = i / nq, c4 = 4 * (i - r * nq);
    float4 o = *reinterpret_cast<const float4*>(part + r * d + c4);
    for (int gg = 1; gg < groups; ++gg) {
      const float4 x =
          *reinterpret_cast<const float4*>(part + (gg * kRows + r) * d + c4);
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
    }
    *reinterpret_cast<float4*>(ws_acc + ((row0 + r) * nsplit + sp) * d +
                               c4) = o;
  }
  if (tid < nt)
    ws_ml[(row0 + tid) * nsplit + sp] = make_float2(m_s[tid], l_s[tid]);
}

// One thread per (row, channel): M = the max of the splits' m, then l and
// the channel's sum over the splits in split order, each split rescaled
// by exp(m_i - M).
template <typename QT>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_kernel(const float* __restrict__ ws_acc,
                          const float2* __restrict__ ws_ml,
                          const int32_t* __restrict__ kv_lens,
                          int static_len, QT* __restrict__ out, int hkv,
                          int gq, int s, int d, int nsplit,
                          long long total) {
  const long long idx = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  if (idx >= total) return;
  const long long row = idx / d;
  const int c = (int)(idx - row * d);
  const int len = min(kv_lens ? kv_lens[row / ((long long)hkv * gq)]
                              : static_len, s);
  const int ns = len > 0 ? (len + kSplit - 1) / kSplit : 0;
  const float2* ml = ws_ml + row * nsplit;
  const float* acc = ws_acc + row * nsplit * d + c;
  float mx = -INFINITY;
#pragma unroll 8
  for (int i = 0; i < ns; ++i) mx = fmaxf(mx, ml[i].x);
  float l = 0.f, o = 0.f;
#pragma unroll 8
  for (int i = 0; i < ns; ++i) {
    const float2 e = ml[i];
    const float a = expf(e.x - mx);
    l = fmaf(a, e.y, l);
    o = fmaf(a, acc[(long long)i * d], o);
  }
  out[idx] = from_f32<QT>(o / fmaxf(l, 1e-30f));
}

template <typename QT, int kBits, int kRows>
int launch(const void* q, const void* k_codes, const float* k_scale,
           const void* v_codes, const float* v_scale, const int32_t* kv_lens,
           int static_len, float* ws, void* out, int b, int hkv, int gq,
           int s, int d, int group, float sm_scale, cudaStream_t stream) {
  const int nsplit = (s + kSplit - 1) / kSplit;
  const long long blocks = (long long)b * hkv * nsplit;
  const long long rows = (long long)b * hkv * gq;
  if (blocks > 0x7fffffffLL || (gq + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int cw = kBits == 8 ? d : d / 2;
  const size_t smem = layout(kRows, d, cw, d / group).total;
  auto split = decode_split_kernel<QT, kBits, kRows>;
  if (smem > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e) return e;
  }
  float* ws_acc = ws;
  float2* ws_ml = reinterpret_cast<float2*>(ws + rows * nsplit * d);
  split<<<dim3((unsigned)blocks, (gq + kRows - 1) / kRows), kThreads, smem,
          stream>>>(static_cast<const QT*>(q),
                    static_cast<const uint8_t*>(k_codes), k_scale,
                    static_cast<const uint8_t*>(v_codes), v_scale, kv_lens,
                    static_len, ws_acc, ws_ml, hkv, gq, s, d, group, nsplit,
                    sm_scale);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  const long long total = rows * d;
  decode_combine_kernel<QT>
      <<<(unsigned)((total + kCombineThreads - 1) / kCombineThreads),
         kCombineThreads, 0, stream>>>(ws_acc, ws_ml, kv_lens, static_len,
                                       static_cast<QT*>(out), hkv, gq, s, d,
                                       nsplit, total);
  return (int)cudaGetLastError();
}

// The row tile: the fewest of 4, 8 or 16 rows that hold Gq (16 above).
template <typename QT, int kBits>
int dispatch_rows(const void* q, const void* kc, const float* ks,
                  const void* vc, const float* vs, const int32_t* kv_lens,
                  int static_len, float* ws, void* out, int b, int hkv,
                  int gq, int s, int d, int group, float sm_scale,
                  cudaStream_t stream) {
  if (gq <= 4)
    return launch<QT, kBits, 4>(q, kc, ks, vc, vs, kv_lens, static_len, ws,
                                out, b, hkv, gq, s, d, group, sm_scale,
                                stream);
  if (gq <= 8)
    return launch<QT, kBits, 8>(q, kc, ks, vc, vs, kv_lens, static_len, ws,
                                out, b, hkv, gq, s, d, group, sm_scale,
                                stream);
  return launch<QT, kBits, 16>(q, kc, ks, vc, vs, kv_lens, static_len, ws,
                               out, b, hkv, gq, s, d, group, sm_scale,
                               stream);
}

}  // namespace

// kv_lens: a (B,) int32 device vector of per-slot lengths, or null for
// static_len on every slot.  ws: the f32 workspace, B*Hkv*Gq *
// ceil(S / 64) * (D + 2) floats (the partial accumulators, then (m, l)
// pairs).  Refuses D not a multiple of 4 or above 512, a group not
// dividing D, and bits other than 4 and 8.
extern "C" int decode_attention(const void* q, int q_is_bf16,
                                const void* k_codes, const float* k_scale,
                                const void* v_codes, const float* v_scale,
                                const int32_t* kv_lens, int static_len,
                                float* ws, void* out, int b, int hkv, int gq,
                                int s, int d, int bits, int group,
                                float sm_scale, void* stream) {
  if (d < 4 || d % 4 || d > 512 || group < 1 || d % group ||
      (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  if ((long long)b * hkv * gq * s == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_is_bf16) {
    if (bits == 8)
      return dispatch_rows<__nv_bfloat16, 8>(q, k_codes, k_scale, v_codes,
                                          v_scale, kv_lens, static_len, ws,
                                          out, b, hkv, gq, s, d, group,
                                          sm_scale, st);
    return dispatch_rows<__nv_bfloat16, 4>(q, k_codes, k_scale, v_codes,
                                        v_scale, kv_lens, static_len, ws,
                                        out, b, hkv, gq, s, d, group,
                                        sm_scale, st);
  }
  if (bits == 8)
    return dispatch_rows<float, 8>(q, k_codes, k_scale, v_codes, v_scale,
                                kv_lens, static_len, ws, out, b, hkv, gq, s,
                                d, group, sm_scale, st);
  return dispatch_rows<float, 4>(q, k_codes, k_scale, v_codes, v_scale,
                              kv_lens, static_len, ws, out, b, hkv, gq, s, d,
                              group, sm_scale, st);
}
