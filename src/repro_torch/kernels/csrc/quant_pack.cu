// Fused symmetric group-quantize + int4/int8 pack, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_pack.py::quant_pack
// (body _quant_kernel).  Per token row and per group of `group` channels:
//   scale = max(amax / qmax, 1e-8)                       (f32)
//   q     = clip(rint(x / scale), -qmax - 1, qmax)       (IEEE divide, half-even)
// int8 codes, or int4 codes packed two per byte as (q + 8), low nibble
// first; one f32 scale per group.
//
// What bounds it: bytes.  Each input element is read once and each code
// and scale written once: at (262144, 128) bf16, group 64, that is 102.8 MB,
// 0.031 ms at 3.35 TB/s.  Per element the IEEE divide is a MUFU.RCP, five
// FFMA and an FCHK with a branch around the call of its slow path
// (chip_smoke.py prints the kernel's SASS counts); with the max, the
// round, the clamp and the pack that stays under the ~30 instructions per
// element that the SMs issue in the bound's time.  So the kernel has to
// keep enough 16-byte loads in flight and spend few instructions on
// anything else.
//
// Design: one streaming pass over a flat run of groups.  Rows are
// contiguous and D is a multiple of the group, so group i of the flat
// input has its scale at scales[i] and row boundaries never matter.  A
// segment of SEG lanes takes one group, each lane CPL 16-byte chunks of
// it (8 bf16 or 4 f32), so a warp-wide load covers 512 contiguous bytes
// (4 bf16 groups of 64).  A lane keeps its chunks in registers from the
// amax (reduced with __shfl_xor_sync inside the segment) to the codes,
// which leave as one 8-, 4- or 2-byte store per chunk; the segment's
// first lane writes the scale.  A thread issues its loads (UNROLL groups'
// worth, 32 bytes) before it computes, and each block takes one tile of
// groups: a grid of one pass over the work measured faster on the H100
// than persistent blocks striding over it (their last strides leave SMs
// idle).  Indices are 32-bit, and the grid stays far below its limit,
// because the launcher cuts an input of more than 2^30 elements into
// pieces.
//
// Shapes the vector path cannot take go to quant_pack_scalar below, one
// thread per group with element loads: a group that is not 1-128 whole
// 16-byte chunks (a power of two of them; e.g. group 2, 6 or 10), or an
// x that is not 16-byte aligned (a contiguous view at an odd offset).
//
// The divide stays IEEE: `/` compiles to div.rn.f32 (the build has no
// --use_fast_math), and __float2int_rn rounds half to even.  The codes
// must equal the host quantizer's (core/quantizers.py::group_quantize)
// bit for bit, because the wire bytes are compared with the host path; a
// multiply by the reciprocal of the scale moves codes wherever x / scale
// lies within an ulp of a .5 (quant_boundary.py builds such rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kPiece = 1LL << 30;   // elements per launch

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The 16-byte chunk as f32: 8 bf16 (each the high half of its f32) or 4 f32.
template <typename T>
__device__ __forceinline__ void widen(const uint4& v, float* f);
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& v,
                                                     float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
template <>
__device__ __forceinline__ void widen<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ int quantize(float x, float scale, int qmax) {
  const int q = __float2int_rn(x / scale);
  return min(max(q, -qmax - 1), qmax);
}

// EPC codes of one chunk, stored at their place in the flat code array:
// int8 as EPC bytes, int4 as EPC / 2 bytes of (q + 8), low nibble first.
template <int BITS, int EPC>
__device__ __forceinline__ void store_codes(uint8_t* codes, unsigned e,
                                            const int* q) {
  if constexpr (BITS == 8) {
    uint32_t w[EPC / 4];
#pragma unroll
    for (int i = 0; i < EPC / 4; ++i)
      w[i] = (q[4 * i] & 0xFF) | (q[4 * i + 1] & 0xFF) << 8 |
             (q[4 * i + 2] & 0xFF) << 16 | (uint32_t)(q[4 * i + 3]) << 24;
    if constexpr (EPC == 8)
      *reinterpret_cast<uint2*>(codes + e) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(codes + e) = w[0];
  } else {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < EPC / 2; ++i)
      w |= (uint32_t)((q[2 * i] + 8) | (q[2 * i + 1] + 8) << 4) << (8 * i);
    if constexpr (EPC == 8)
      *reinterpret_cast<uint32_t*>(codes + e / 2) = w;
    else
      *reinterpret_cast<uint16_t*>(codes + e / 2) = (uint16_t)w;
  }
}

template <typename T, int BITS, int SEG, int CPL, int UNROLL>
__global__ void __launch_bounds__(kThreads)
    quant_pack_vec(const T* __restrict__ x, uint8_t* __restrict__ codes,
                   float* __restrict__ scales, unsigned n_groups) {
  constexpr int EPC = 16 / sizeof(T);        // elements per 16-byte chunk
  constexpr int GROUP = SEG * CPL * EPC;
  constexpr int PER_WARP = 32 / SEG;         // groups per warp-wide load
  constexpr int QMAX = (1 << (BITS - 1)) - 1;
  const unsigned lane = threadIdx.x & 31, seg = lane / SEG, sub = lane % SEG;
  const unsigned warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const unsigned g0 = warp * PER_WARP * UNROLL + seg;
  uint4 v[UNROLL][CPL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned g = g0 + u * PER_WARP;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      v[u][c] = g < n_groups ? __ldg(reinterpret_cast<const uint4*>(
                                   x + g * GROUP + (c * SEG + sub) * EPC))
                             : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned g = g0 + u * PER_WARP;
    float f[CPL][EPC];
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      widen<T>(v[u][c], f[c]);
#pragma unroll
      for (int i = 0; i < EPC; ++i) amax = fmaxf(amax, fabsf(f[c][i]));
    }
#pragma unroll
    for (int off = SEG / 2; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, off));
    const float scale = fmaxf(amax / (float)QMAX, 1e-8f);
    if (g < n_groups) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        int q[EPC];
#pragma unroll
        for (int i = 0; i < EPC; ++i) q[i] = quantize(f[c][i], scale, QMAX);
        store_codes<BITS, EPC>(codes, g * GROUP + (c * SEG + sub) * EPC, q);
      }
      if (sub == 0) scales[g] = scale;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_pack_scalar(const T* __restrict__ x, uint8_t* __restrict__ codes,
                      float* __restrict__ scales, unsigned n_groups,
                      int group, int bits) {
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_groups) return;
  const int qmax = (1 << (bits - 1)) - 1;
  const unsigned e0 = g * group;
  float amax = 0.f;
  for (int j = 0; j < group; ++j)
    amax = fmaxf(amax, fabsf(to_f32(x[e0 + j])));
  const float scale = fmaxf(amax / (float)qmax, 1e-8f);
  for (int j = 0; j < group; j += 2) {
    const int q0 = quantize(to_f32(x[e0 + j]), scale, qmax);
    const int q1 = quantize(to_f32(x[e0 + j + 1]), scale, qmax);
    if (bits == 8) {
      codes[e0 + j] = (uint8_t)q0;
      codes[e0 + j + 1] = (uint8_t)q1;
    } else {
      codes[(e0 + j) / 2] = (uint8_t)((q0 + 8) | (q1 + 8) << 4);
    }
  }
  scales[g] = scale;
}

template <typename T, int BITS, int SEG, int CPL>
void run_vec(const T* x, uint8_t* codes, float* scales, unsigned n_groups,
             cudaStream_t s) {
  constexpr int UNROLL = CPL >= 2 ? 1 : 2;
  constexpr unsigned per_block = (kThreads / 32) * (32 / SEG) * UNROLL;
  quant_pack_vec<T, BITS, SEG, CPL, UNROLL>
      <<<(n_groups + per_block - 1) / per_block, kThreads, 0, s>>>(
          x, codes, scales, n_groups);
}

// The vector path for 1-128 chunks a group; false where it cannot.
template <typename T, int BITS>
bool launch_vec(const T* x, uint8_t* codes, float* scales, unsigned n_groups,
                int chunks, cudaStream_t s) {
  switch (chunks) {
    case 1: run_vec<T, BITS, 1, 1>(x, codes, scales, n_groups, s); break;
    case 2: run_vec<T, BITS, 2, 1>(x, codes, scales, n_groups, s); break;
    case 4: run_vec<T, BITS, 4, 1>(x, codes, scales, n_groups, s); break;
    case 8: run_vec<T, BITS, 8, 1>(x, codes, scales, n_groups, s); break;
    case 16: run_vec<T, BITS, 16, 1>(x, codes, scales, n_groups, s); break;
    case 32: run_vec<T, BITS, 32, 1>(x, codes, scales, n_groups, s); break;
    case 64: run_vec<T, BITS, 32, 2>(x, codes, scales, n_groups, s); break;
    case 128: run_vec<T, BITS, 32, 4>(x, codes, scales, n_groups, s); break;
    default: return false;
  }
  return true;
}

template <typename T>
void launch(const T* x, uint8_t* codes, float* scales, unsigned n_groups,
            int group, int bits, cudaStream_t s) {
  const int bytes = group * (int)sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (aligned && bytes % 16 == 0 &&
      (bits == 8 ? launch_vec<T, 8>(x, codes, scales, n_groups, bytes / 16, s)
                 : launch_vec<T, 4>(x, codes, scales, n_groups, bytes / 16,
                                    s)))
    return;
  quant_pack_scalar<T><<<(n_groups + kThreads - 1) / kThreads, kThreads, 0,
                          s>>>(x, codes, scales, n_groups, group, bits);
}

}  // namespace

// x (n_rows, d) bf16 or f32, contiguous at any element offset; codes
// (n_rows, d) int8 or (n_rows, d / 2) uint8 nibbles and scales (n_rows,
// d / group) f32, fresh allocations.  group is even and divides d.
extern "C" int quant_pack(const void* x, int x_is_bf16, void* codes,
                          float* scales, int n_rows, int d, int bits,
                          int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)n_rows * d;
  const long long piece = kPiece / group * group;
  for (long long e0 = 0; e0 < n; e0 += piece) {
    const unsigned n_groups =
        (unsigned)((n - e0 < piece ? n - e0 : piece) / group);
    uint8_t* c = static_cast<uint8_t*>(codes) + (bits == 8 ? e0 : e0 / 2);
    float* sc = scales + e0 / group;
    if (x_is_bf16)
      launch(static_cast<const __nv_bfloat16*>(x) + e0, c, sc, n_groups,
             group, bits, s);
    else
      launch(static_cast<const float*>(x) + e0, c, sc, n_groups, group, bits,
             s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
