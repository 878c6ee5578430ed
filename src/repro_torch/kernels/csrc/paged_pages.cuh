// Device code shared by the paged attention kernels (paged_attention.cu,
// paged_verify_attention.cu through paged_split.cuh): bf16 rounding, dtype
// conversions, and the two page layouts a kernel reads K/V through.
//
//   PallasPages  the Pallas kernels' pools: int8 codes (P, Hkv, PS, D) or
//                nibble-packed int4 (P, Hkv, PS, D/2), f32 group scales
//                (P, Hkv, PS, D/group); values dequantize in f32.
//   ArenaPages   the serving arena's per-layer pools, all (P, PS, Hkv, D):
//                bf16 fp pages, int8 codes and f32 per-channel scales;
//                quant values dequantize in f32 and round to bf16 (the
//                reference's _blend_quant).
//
// Both read K/V in units of 8 channels of one position.  fetch_k() issues
// a K unit's vector loads (16 bytes of bf16; 8 or 4 bytes of codes with
// their scales as two float4s) and decode() turns a unit into 8 f32
// values, so a thread keeps several units' loads in flight before it uses
// any.  V goes through shared memory: stage_v() copies one position's 16
// channels as stored with cp.async (no registers held while in flight),
// unstage() reads a unit back for decode().  Units start at a multiple of
// 8 channels and D is a multiple of 16, so every access is aligned when
// the pools are 16-byte aligned (the wrappers check).
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

// Asynchronous copies from device to shared memory (sm_80 and up).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most n of this thread's copy groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void store8(float* o, const float* v) {
  reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

struct PallasPages {
  const uint8_t* kc;
  const float* ks;
  const uint8_t* vc;
  const float* vs;
  int hkv, ps, d, bits, group;

  struct Unit {
    uint2 c;          // 8 int8 codes, or 8 nibbles in c.x
    float4 s0, s1;    // the 8 channels' scales
  };

  __device__ __forceinline__ Unit fetch_k(int page, int h, int r, int c8,
                                          bool) const {
    const long long rw = ((long long)page * hkv + h) * ps + r;
    Unit u;
    if (bits == 4) {
      u.c.x = *reinterpret_cast<const uint32_t*>(kc + rw * (d / 2) + c8 / 2);
      u.c.y = 0;
    } else {
      u.c = *reinterpret_cast<const uint2*>(kc + rw * d + c8);
    }
    const float* sr = ks + rw * (d / group);
    if (group % 8 == 0) {
      const float v = sr[c8 / group];
      u.s0 = make_float4(v, v, v, v);
      u.s1 = u.s0;
    } else {
      u.s0 = make_float4(sr[c8 / group], sr[(c8 + 1) / group],
                         sr[(c8 + 2) / group], sr[(c8 + 3) / group]);
      u.s1 = make_float4(sr[(c8 + 4) / group], sr[(c8 + 5) / group],
                         sr[(c8 + 6) / group], sr[(c8 + 7) / group]);
    }
    return u;
  }
  // V of one position's 16 channels c0 .. c0+15 as stored, copied
  // asynchronously to dst (kStageBytes): the codes, then the scales of
  // groups c0 / group .. (c0 + 15) / group.
  static constexpr int kStageBytes = 80;
  __device__ __forceinline__ void stage_v(uint8_t* dst, int page, int h,
                                          int r, int c0, bool) const {
    const long long rw = ((long long)page * hkv + h) * ps + r;
    if (bits == 4)
      cp_async8(dst, vc + rw * (d / 2) + c0 / 2);
    else
      cp_async16(dst, vc + rw * d + c0);
    const float* sr = vs + rw * (d / group);
    for (int k = c0 / group; k <= (c0 + 15) / group; ++k)
      cp_async4(dst + 16 + 4 * (k - c0 / group), sr + k);
  }
  // the unit of channels c0 + c8 .. c0 + c8 + 7 of a staged position
  __device__ __forceinline__ Unit unstage(const uint8_t* src, int c0, int c8,
                                          bool) const {
    Unit u;
    if (bits == 4) {
      u.c.x = *reinterpret_cast<const uint32_t*>(src + c8 / 2);
      u.c.y = 0;
    } else {
      u.c = *reinterpret_cast<const uint2*>(src + c8);
    }
    const float* sc = reinterpret_cast<const float*>(src + 16);
    const int g0 = c0 / group;
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = sc[(c0 + c8 + i) / group - g0];
    u.s0 = make_float4(s[0], s[1], s[2], s[3]);
    u.s1 = make_float4(s[4], s[5], s[6], s[7]);
    return u;
  }
  // code * scale in f32, no rounding
  __device__ __forceinline__ void decode(const Unit& u, bool,
                                         float* o) const {
    const float s[8] = {u.s0.x, u.s0.y, u.s0.z, u.s0.w,
                        u.s1.x, u.s1.y, u.s1.z, u.s1.w};
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int q;
      if (bits == 4)
        q = (int)((u.c.x >> (4 * i)) & 0xFu) - 8;
      else
        q = (int)(int8_t)(((i < 4 ? u.c.x : u.c.y) >> (8 * (i & 3))) & 0xFFu);
      v[i] = (float)q * s[i];
    }
    store8(o, v);
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

  struct Unit {
    uint4 raw;        // 8 bf16 values, or 8 int8 codes in raw.x, raw.y
    float4 s0, s1;    // quant units: the 8 channels' scales
  };

  __device__ __forceinline__ Unit fetch_k(int page, int h, int r, int c8,
                                          bool quant) const {
    const long long i = (((long long)page * ps + r) * hkv + h) * d + c8;
    Unit u;
    if (quant) {
      const uint2 codes = *reinterpret_cast<const uint2*>(kc + i);
      u.raw = make_uint4(codes.x, codes.y, 0u, 0u);
      u.s0 = *reinterpret_cast<const float4*>(ks + i);
      u.s1 = *reinterpret_cast<const float4*>(ks + i + 4);
    } else {
      u.raw = *reinterpret_cast<const uint4*>(kf + i);
    }
    return u;
  }
  // V of one position's 16 channels c0 .. c0+15 as stored, copied
  // asynchronously to dst (kStageBytes): 16 codes then 16 scales, or 16
  // bf16 values.
  static constexpr int kStageBytes = 80;
  __device__ __forceinline__ void stage_v(uint8_t* dst, int page, int h,
                                          int r, int c0, bool quant) const {
    const long long i = (((long long)page * ps + r) * hkv + h) * d + c0;
    if (quant) {
      cp_async16(dst, vc + i);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cp_async16(dst + 16 + 16 * k, vs + i + 4 * k);
    } else {
      cp_async16(dst, vf + i);
      cp_async16(dst + 16, vf + i + 8);
    }
  }
  // the unit of channels c0 + c8 .. c0 + c8 + 7 of a staged position
  __device__ __forceinline__ Unit unstage(const uint8_t* src, int, int c8,
                                          bool quant) const {
    Unit u;
    if (quant) {
      const uint2 codes = *reinterpret_cast<const uint2*>(src + c8);
      u.raw = make_uint4(codes.x, codes.y, 0u, 0u);
      u.s0 = *reinterpret_cast<const float4*>(src + 16 + 4 * c8);
      u.s1 = *reinterpret_cast<const float4*>(src + 32 + 4 * c8);
    } else {
      u.raw = *reinterpret_cast<const uint4*>(src + 2 * c8);
    }
    return u;
  }
  // quant: code * scale in f32, rounded to bf16; fp: the bf16 values
  __device__ __forceinline__ void decode(const Unit& u, bool quant,
                                         float* o) const {
    float v[8];
    if (quant) {
      const float s[8] = {u.s0.x, u.s0.y, u.s0.z, u.s0.w,
                          u.s1.x, u.s1.y, u.s1.z, u.s1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = (int)(int8_t)(((i < 4 ? u.raw.x : u.raw.y) >>
                                     (8 * (i & 3))) & 0xFFu);
        v[i] = bf16_round((float)q * s[i]);
      }
    } else {
      const uint32_t w[4] = {u.raw.x, u.raw.y, u.raw.z, u.raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 pair =
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
        v[2 * i] = __low2float(pair);
        v[2 * i + 1] = __high2float(pair);
      }
    }
    store8(o, v);
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
