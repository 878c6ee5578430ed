// Device code shared by the paged attention kernels (paged_attention.cu,
// paged_verify_attention.cu): bf16 rounding, dtype conversions, and the two
// page layouts a kernel reads K/V through.
//
//   PallasPages  the Pallas kernels' pools: int8 codes (P, Hkv, PS, D) or
//                nibble-packed int4 (P, Hkv, PS, D/2), f32 group scales
//                (P, Hkv, PS, D/group); values dequantize in f32.
//   ArenaPages   the serving arena's per-layer pools, all (P, PS, Hkv, D):
//                bf16 fp pages, int8 codes and f32 per-channel scales;
//                quant values dequantize in f32 and round to bf16 (the
//                reference's _blend_quant).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Where K/V element (t, d) of slot b, head h lives, and how it decodes.
struct PallasPages {
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
  // K elements dd .. dd+3 of one position.
  __device__ __forceinline__ void k4(int page, int h, int r, int dd, bool,
                                     float* o) const {
    const long long rw = row(page, h, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = load(kc, ks, rw, dd + i);
  }
};

struct ArenaPages {
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
  // K elements dd .. dd+3 of one position, in one vector load per pool
  // (dd % 4 == 0 and 16-byte aligned pools: the wrappers check both).
  __device__ __forceinline__ void k4(int page, int h, int r, int dd,
                                     bool quant, float* o) const {
    const long long i = at(page, h, r, dd);
    if (quant) {
      const char4 c = *reinterpret_cast<const char4*>(kc + i);
      const float4 s = *reinterpret_cast<const float4*>(ks + i);
      o[0] = bf16_round((float)c.x * s.x);
      o[1] = bf16_round((float)c.y * s.y);
      o[2] = bf16_round((float)c.z * s.z);
      o[3] = bf16_round((float)c.w * s.w);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(kf + i);
      const __nv_bfloat162 lo =
          *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 hi =
          *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      o[0] = __low2float(lo);
      o[1] = __high2float(lo);
      o[2] = __low2float(hi);
      o[3] = __high2float(hi);
    }
  }
};

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
