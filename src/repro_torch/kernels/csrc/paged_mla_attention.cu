// Paged decode attention of multi-head latent attention (DeepSeek-V2), in
// the absorbed form, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no latent attention.  It is
// the decode read of one layer of the serving arena for an MLA model: each
// slot's cache is one latent head (R = 512 channels, the normed c_kv) and
// one rope key (P = 64, rotated), in two bf16 page pools (pages, PS, 1, R)
// and (pages, PS, 1, P).  Every one of the H = 16 query heads reads the
// same positions: its score is q_abs . latent + q_pe . rope over the 576
// channels (q_abs the head's nope query folded through its wkv_b key
// columns), times the softmax scale, and its value is the latent itself.
// Out: the UNNORMALIZED bf16 sum over the seen positions of p * latent,
// with f32 max m and denominator l, so the caller merges the step's own
// token in closed form (as paged_attention_arena's callers do).  A
// position is seen when it lies below the slot's kv_len and on a page
// other than the scratch page 0, so a parked row (every block-table entry
// 0) sees nothing: m = -inf, l = 0, out = 0, and costs no arithmetic.
//
// Bound on this card: both.  A position is 1,152 bytes read for 16 x (576
// + 512) FMAs, 30 f32 flops a byte, above the 20 of the card's CUDA cores
// (67 TFLOP/s f32, 3.35 TB/s): in f32 outside the tensor cores the
// arithmetic bounds it, by a little.  Design, the split-KV scheme of
// paged_split.cuh in two launches with kernels of their own:
//
//   mla_decode_partial  grid (split, slot), 256 threads, ~99 KB of shared
//       memory (two blocks an SM): a block walks its split of the slot's
//       positions in tiles of 32, reading only the tile's block-table
//       entries.  A tile's latent and rope key go to shared memory as bf16,
//       channel-major; each warp takes 72 of the 576 channels and every
//       lane a 4-head x 4-position block of partial scores (a float4 of q
//       and 4 bf16 of K a channel, 16 FMAs), the eight partials are summed
//       in warp order, and one warp a pair of rows keeps the split's online
//       softmax (max, denominator, the rescale of the sums).  Then each
//       thread adds p * latent for 4 heads x 8 channels over the tile's
//       positions in order.  The split's f32 sums, max and denominator go
//       to the workspace.
//   mla_decode_combine  grid (head, slot), 128 threads: the splits' sums
//       rescaled to the row's max and added in split order.
//
// Sums run in a fixed order (no atomics), so two launches give the same
// bits; the order is not kernels/ref.py's, which the tests allow for.
#include "paged_pages.cuh"

namespace {

constexpr int kH = 16;            // query heads, all over one latent head
constexpr int kR = 512;           // latent width: the value
constexpr int kP = 64;            // rope key width
constexpr int kC = kR + kP;       // score width
constexpr int kT = 32;            // positions a tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCw = kC / kWarps;  // score channels a warp
constexpr int kKst = kT + 8;      // k_s row stride (bf16): conflict-free
constexpr int kUnits = kC / 8;    // 8-channel units a position
constexpr int kLoads = kT * kUnits / kThreads;  // a thread's loads a tile
constexpr int kCombine = kR / 4;  // combine threads: 4 channels each

static_assert(kC % kWarps == 0 && kH == 16 && kT == 32, "the lane map");
static_assert(kT * kUnits % kThreads == 0, "whole loads a thread");

struct MlaArgs {
  const __nv_bfloat16* q_abs;   // (B, H, R)
  const __nv_bfloat16* q_pe;    // (B, H, P)
  const __nv_bfloat16* lat;     // (pages, PS, R)
  const __nv_bfloat16* rope;    // (pages, PS, P)
  const int32_t* block_tables;  // (B, PPS)
  const int32_t* kv_lens;       // (B,)
  float* ws_acc;                // (B, n_split, H, R) a split's sums
  float* ws_ml;                 // (B, n_split, H, 2) its max, denominator
  __nv_bfloat16* out;           // (B, H, R)
  float* m;                     // (B, H)
  float* l;                     // (B, H)
  int pps, ps, split, n_split;
  float sm_scale;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__global__ void __launch_bounds__(kThreads, 2)
    mla_decode_partial(MlaArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                         // (kC, kH) f32
  float* part_s = q_s + kC * kH;             // (kWarps, kH, kT) f32
  float* p_s = part_s + kWarps * kH * kT;    // (kT, kH) f32
  float* m_s = p_s + kT * kH;                // (kH) running max
  float* l_s = m_s + kH;                     // (kH) running denominator
  float* al_s = l_s + kH;                    // (kH) this tile's rescale
  int* page_s = reinterpret_cast<int*>(al_s + kH);        // (kT)
  __nv_bfloat16* k_s =
      reinterpret_cast<__nv_bfloat16*>(page_s + kT);      // (kC, kKst)

  const int sp = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(a.kv_lens[b], a.pps * a.ps);
  const int t_lo = sp * a.split;
  if (t_lo >= len) return;  // the combine reads only the splits below len
  const int t_hi = min(t_lo + a.split, len);
  const int32_t* bt = a.block_tables + (long long)b * a.pps;
  float* ml = a.ws_ml + (((long long)b * a.n_split + sp) * kH) * 2;

  // a split wholly on the scratch page (a parked row) sees nothing
  int any = 0;
  for (int pg = t_lo / a.ps + tid; pg <= (t_hi - 1) / a.ps; pg += kThreads)
    any |= bt[pg] != 0;
  if (!__syncthreads_or(any)) {
    if (tid < kH) {
      ml[tid * 2] = -INFINITY;
      ml[tid * 2 + 1] = 0.f;
    }
    return;
  }

  // q as f32, channel-major: q_s[c * kH + h]
  const __nv_bfloat16* qa = a.q_abs + (long long)b * kH * kR;
  const __nv_bfloat16* qp = a.q_pe + (long long)b * kH * kP;
  for (int i = tid; i < kH * kC; i += kThreads) {
    const int h = i / kC, c = i % kC;
    q_s[c * kH + h] = __bfloat162float(c < kR ? qa[h * kR + c]
                                              : qp[h * kP + c - kR]);
  }
  if (tid < kH) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // scores: warp w takes channels [w * kCw, (w + 1) * kCw), lane a block
  // of heads 4 * hs .. + 3 and positions 4 * ts .. + 3
  const int hs = lane & 3, ts = lane >> 2;
  // p * latent: thread a block of heads 4 * hv .. + 3 and channels cv +
  // 64 j, j < 8
  const int hv = tid & 3, cv = tid >> 2;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t0 = t_lo; t0 < t_hi; t0 += kT) {
    const int n = min(kT, t_hi - t0);
    __syncthreads();  // the last tile's p * latent is done with k_s, p_s
    if (tid < kT) page_s[tid] = tid < n ? bt[(t0 + tid) / a.ps] : 0;
    __syncthreads();
    // the tile's latent and rope key, 16 bytes a load, lane = position:
    // a thread's kLoads loads all in flight before any lands in k_s
    {
      const int t = tid % kT, page = page_s[t];
      const bool seen = t < n && page != 0;
      const long long row = (long long)page * a.ps + (t0 + t) % a.ps;
      uint4 raw[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int c8 = (tid + k * kThreads) / kT;
        raw[k] = make_uint4(0u, 0u, 0u, 0u);
        if (seen)
          raw[k] = c8 < kR / 8
                       ? __ldg(reinterpret_cast<const uint4*>(
                             a.lat + row * kR + c8 * 8))
                       : __ldg(reinterpret_cast<const uint4*>(
                             a.rope + row * kP + (c8 - kR / 8) * 8));
      }
      uint16_t* ks = reinterpret_cast<uint16_t*>(k_s);
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int c8 = (tid + k * kThreads) / kT;
        const uint32_t w[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // channel 2j low, 2j + 1 high
          ks[(c8 * 8 + 2 * j) * kKst + t] = (uint16_t)(w[j] & 0xffffu);
          ks[(c8 * 8 + 2 * j + 1) * kKst + t] = (uint16_t)(w[j] >> 16);
        }
      }
    }
    __syncthreads();

    // each warp's partial scores over its channels, in channel order
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      const int c_lo = warp * kCw;
#pragma unroll 4
      for (int c = c_lo; c < c_lo + kCw; ++c) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + c * kH +
                                                           4 * hs);
        const uint2 kw = *reinterpret_cast<const uint2*>(k_s + c * kKst +
                                                         4 * ts);
        const float kv[4] = {bf16_lo(kw.x), bf16_hi(kw.x), bf16_lo(kw.y),
                             bf16_hi(kw.y)};
        const float q4[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += q4[i] * kv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part_s[(warp * kH + 4 * hs + i) * kT + 4 * ts + j] = s[i][j];
    }
    __syncthreads();
    // the partials summed in warp order, scaled, masked
    for (int e = tid; e < kH * kT; e += kThreads) {
      const int h = e / kT, t = e % kT;
      float v = part_s[h * kT + t];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += part_s[(w * kH + h) * kT + t];
      part_s[h * kT + t] =
          t < n && page_s[t] != 0 ? v * a.sm_scale : -INFINITY;
    }
    __syncthreads();
    // the online softmax: warp w keeps rows 2w and 2w + 1, lane = position
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int h = 2 * warp + k;
      const float sv = part_s[h * kT + lane];
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      p_s[lane * kH + h] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        m_s[h] = m_new;
        l_s[h] = l_s[h] * alpha + ps;
        al_s[h] = alpha;
      }
    }
    __syncthreads();
    // p * latent over the tile's positions in order
    {
      const float4 al = *reinterpret_cast<const float4*>(al_s + 4 * hv);
      const float a4[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= a4[i];
      for (int t = 0; t < n; ++t) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + t * kH +
                                                           4 * hv);
        const float p4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = __bfloat162float(k_s[(cv + 64 * j) * kKst + t]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += p4[i] * v;
        }
      }
    }
  }

  // the split's sums, max and denominator
  float* wa = a.ws_acc + (((long long)b * a.n_split + sp) * kH) * kR;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) wa[(4 * hv + i) * kR + cv + 64 * j] = acc[i][j];
  if (tid < kH) {
    ml[tid * 2] = m_s[tid];
    ml[tid * 2 + 1] = l_s[tid];
  }
}

__global__ void __launch_bounds__(kCombine)
    mla_decode_combine(MlaArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = min(a.kv_lens[b], a.pps * a.ps);
  const int n_used = len > 0 ? (len + a.split - 1) / a.split : 0;
  const float* ml = a.ws_ml + (long long)b * a.n_split * kH * 2 + h * 2;
  float mx = -INFINITY;
  for (int s = 0; s < n_used; ++s) mx = fmaxf(mx, ml[(long long)s * kH * 2]);
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  if (mx != -INFINITY) {
    const float* wa = a.ws_acc + ((long long)b * a.n_split * kH + h) * kR +
                      4 * tid;
    for (int s = 0; s < n_used; ++s) {
      const float ms = ml[(long long)s * kH * 2];
      if (ms == -INFINITY) continue;  // no seen position: its sums unset
      const float w = expf(ms - mx);
      const float4 v =
          *reinterpret_cast<const float4*>(wa + (long long)s * kH * kR);
      o.x += w * v.x;
      o.y += w * v.y;
      o.z += w * v.z;
      o.w += w * v.w;
      l += w * ml[(long long)s * kH * 2 + 1];
    }
  }
  __nv_bfloat16* ob = a.out + ((long long)b * kH + h) * kR + 4 * tid;
  ob[0] = __float2bfloat16_rn(o.x);
  ob[1] = __float2bfloat16_rn(o.y);
  ob[2] = __float2bfloat16_rn(o.z);
  ob[3] = __float2bfloat16_rn(o.w);
  if (tid == 0) {
    a.m[b * kH + h] = mx;
    a.l[b * kH + h] = l;
  }
}

}  // namespace

extern "C" int paged_mla_attention(
    const void* q_abs, const void* q_pe, const void* lat, const void* rope,
    const int32_t* block_tables, const int32_t* kv_lens, float* ws_acc,
    float* ws_ml, void* out, float* m, float* l, int b, int h, int r, int p,
    int pps, int ps, int split, float sm_scale, void* stream) {
  if (h != kH || r != kR || p != kP || b < 1 || pps < 1 || ps < 1 ||
      split < kT || split % kT)
    return (int)cudaErrorInvalidValue;
  MlaArgs a;
  a.q_abs = static_cast<const __nv_bfloat16*>(q_abs);
  a.q_pe = static_cast<const __nv_bfloat16*>(q_pe);
  a.lat = static_cast<const __nv_bfloat16*>(lat);
  a.rope = static_cast<const __nv_bfloat16*>(rope);
  a.block_tables = block_tables;
  a.kv_lens = kv_lens;
  a.ws_acc = ws_acc;
  a.ws_ml = ws_ml;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.m = m;
  a.l = l;
  a.pps = pps;
  a.ps = ps;
  a.split = split;
  a.n_split = (pps * ps + split - 1) / split;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      sizeof(float) * ((size_t)kC * kH + (size_t)kWarps * kH * kT +
                       (size_t)kT * kH + 3 * kH) +
      sizeof(int) * kT + sizeof(__nv_bfloat16) * (size_t)kC * kKst;
  int e = allow_smem(mla_decode_partial, smem);
  if (e) return e;
  mla_decode_partial<<<dim3((unsigned)a.n_split, (unsigned)b), kThreads,
                       smem, st>>>(a);
  e = (int)cudaGetLastError();
  if (e) return e;
  mla_decode_combine<<<dim3(kH, (unsigned)b), kCombine, 0, st>>>(a);
  return (int)cudaGetLastError();
}
