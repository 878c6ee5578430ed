// Fused symmetric group-quantize + int4/int8 pack, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_pack.py::quant_pack
// (body _quant_kernel).  Per token row and per group of `group` channels:
//   scale = max(amax / qmax, 1e-8)                       (f32)
//   q     = clip(rint(x / scale), -qmax - 1, qmax)       (IEEE divide, half-even)
// int8 codes, or int4 codes packed two per byte as (q + 8), low nibble
// first; one f32 scale per group.
//
// Bound on this card: bytes.  Each input element is read once and each code
// written once (x 2 or 4 bytes in, 1 or 0.5 byte + scale/group out) with a
// handful of flops per element, far below the 295 flop/byte ridge of the
// H100.  Design: one warp per (row, group), the whole grid flat over T * G
// warps so a ragged T needs no padding.  A warp reads its group as
// consecutive element pairs (coalesced), reduces amax with shuffles, and
// every lane quantizes and writes its own pairs.  The divide must stay the
// IEEE one (no --use_fast_math): an approximate divide moves codes at
// rounding boundaries, and the wire bytes must equal the host quantizer's
// bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void quant_pack_kernel(const T* __restrict__ x,
                                  uint8_t* __restrict__ codes,
                                  float* __restrict__ scales, int n_rows,
                                  int d, int bits, int group) {
  const int lane = threadIdx.x & 31;
  const int groups = d / group;
  const long long w =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)n_rows * groups) return;
  const long long row = w / groups;
  const int g = (int)(w % groups);
  const T* xg = x + row * d + (long long)g * group;
  const int pairs = group / 2;

  float amax = 0.f;
  for (int j = lane; j < pairs; j += 32) {
    amax = fmaxf(amax, fabsf(to_f32(xg[2 * j])));
    amax = fmaxf(amax, fabsf(to_f32(xg[2 * j + 1])));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const int qmax = (1 << (bits - 1)) - 1;
  const float scale = fmaxf(amax / (float)qmax, 1e-8f);
  const float lo = (float)(-qmax - 1), hi = (float)qmax;
  for (int j = lane; j < pairs; j += 32) {
    const float q0 = fminf(fmaxf(rintf(to_f32(xg[2 * j]) / scale), lo), hi);
    const float q1 =
        fminf(fmaxf(rintf(to_f32(xg[2 * j + 1]) / scale), lo), hi);
    if (bits == 8) {
      int8_t* out = reinterpret_cast<int8_t*>(codes) + row * d +
                    (long long)g * group + 2 * j;
      out[0] = (int8_t)q0;
      out[1] = (int8_t)q1;
    } else {
      const uint8_t u0 = (uint8_t)((int)q0 + 8);
      const uint8_t u1 = (uint8_t)((int)q1 + 8);
      codes[row * (d / 2) + (long long)g * pairs + j] =
          (uint8_t)(u0 | (u1 << 4));
    }
  }
  if (lane == 0) scales[row * groups + g] = scale;
}

}  // namespace

extern "C" int quant_pack(const void* x, int x_is_bf16, void* codes,
                          float* scales, int n_rows, int d, int bits,
                          int group, void* stream) {
  const long long warps = (long long)n_rows * (d / group);
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  if (blocks == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    quant_pack_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(codes),
        scales, n_rows, d, bits, group);
  } else {
    quant_pack_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<uint8_t*>(codes), scales,
        n_rows, d, bits, group);
  }
  return (int)cudaGetLastError();
}
