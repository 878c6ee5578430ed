// Unpack + dequantize of group-quantized codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/quant_pack.py::dequant_unpack (body _dequant_kernel):
// int8 codes, or int4 nibbles (q + 8, low nibble first) minus 8, times the
// f32 scale of their group, cast to f32 or bf16.  The f32 output is one
// product of an integer and the scale, so it equals the host
// group_dequantize bit for bit.
//
// Bound on this card: bytes (0.5 or 1 byte of code plus a shared scale in,
// 2 or 4 bytes out per element, one multiply).  Design: a flat elementwise
// pass, one thread per pair of output elements (a pair shares its byte for
// int4 and its group always, since groups are even), grid-stride so any T
// fits one launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void dequant_unpack_kernel(const uint8_t* __restrict__ codes,
                                      const float* __restrict__ scales,
                                      T* __restrict__ out, long long n_pairs,
                                      int d, int bits, int group) {
  const int half = d / 2;
  const int groups = d / group;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_pairs; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / half;
    const int j = (int)(i % half);
    int q0, q1;
    if (bits == 4) {
      const uint8_t b = codes[i];
      q0 = (int)(b & 0x0F) - 8;
      q1 = (int)(b >> 4) - 8;
    } else {
      const int8_t* c = reinterpret_cast<const int8_t*>(codes) + 2 * i;
      q0 = c[0];
      q1 = c[1];
    }
    const float s = scales[row * groups + (2 * j) / group];
    T* o = out + row * d + 2 * j;
    o[0] = from_f32<T>((float)q0 * s);
    o[1] = from_f32<T>((float)q1 * s);
  }
}

}  // namespace

extern "C" int dequant_unpack(const void* codes, const float* scales,
                              void* out, int out_is_bf16, int n_rows, int d,
                              int bits, int group, void* stream) {
  const long long n_pairs = (long long)n_rows * (d / 2);
  if (n_pairs == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long want = (n_pairs + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 65535 * 16 ? want : 65535 * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (out_is_bf16) {
    dequant_unpack_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        c, scales, static_cast<__nv_bfloat16*>(out), n_pairs, d, bits, group);
  } else {
    dequant_unpack_kernel<float><<<blocks, threads, 0, s>>>(
        c, scales, static_cast<float*>(out), n_pairs, d, bits, group);
  }
  return (int)cudaGetLastError();
}
