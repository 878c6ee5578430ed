// Unpack + dequantize of group-quantized codes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/quant_pack.py::dequant_unpack (body _dequant_kernel):
// int8 codes, or int4 nibbles (q + 8, low nibble first) minus 8, times the
// f32 scale of their group, cast to f32 or bf16.  The f32 output is one
// product of an integer and the scale, so it equals the host
// group_dequantize bit for bit.
//
// What bounds it: bytes, most of them written.  At (262144, 128) int8 ->
// f32, group 64, the codes and scales are 35.7 MB in and the output
// 134.2 MB out: 169.9 MB, 0.051 ms at 3.35 TB/s, for one multiply an
// element.  So the output has to leave in 16-byte stores and a chunk has
// to spend almost nothing on index arithmetic (the 64-bit divisions a
// flat index needs would cost more than the multiply).
//
// Design: one streaming pass over the flat output in 16-byte chunks (4 f32
// or 8 bf16).  Rows are contiguous and D is a multiple of the group, so
// the flat output's element e has its code at e (int8) or e / 2 (int4)
// and its scale at scales[e / group]; when the group is a whole number of
// chunks, a chunk shares one scale, found with a shift (or one 32-bit
// divide when the chunks a group are not a power of two).  Lane l of a
// warp takes chunks base + l and base + 32 + l, so every warp-wide load
// (4, 8 or 2 code bytes a lane) and 16-byte store covers contiguous
// bytes; a thread issues its code and scale loads before it computes, and
// the outputs leave with evict-first stores (st.global.cs: nothing reads
// them back from L2 soon).  Each block takes one tile of chunks: a grid of
// one pass over the work measured faster on the H100 than persistent
// blocks striding over it.  Indices are 32-bit, and the grid stays far
// below its limit, because the launcher cuts an output of more than 2^30
// elements into pieces.
//
// Shapes the vector path cannot take go to dequant_unpack_scalar below,
// one thread per pair of outputs (a pair shares its byte for int4 and its
// group always, since groups are even): a group that is not a multiple of
// 4 (f32 out) or 8 (bf16 out) elements, e.g. group 2, 6 or 10, or codes
// that are not aligned to a chunk's code bytes (a view at an odd offset).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr long long kPiece = 1LL << 30;   // elements per launch

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Code i (0 <= i < 8) of a chunk's code bytes w (little-endian).
template <int BITS>
__device__ __forceinline__ float code(uint2 w, int i) {
  if constexpr (BITS == 8) {
    const uint32_t word = i < 4 ? w.x : w.y;
    return (float)(int)(int8_t)(word >> (8 * (i & 3)));
  }
  return (float)((int)((w.x >> (4 * i)) & 0xF) - 8);
}

// A chunk's CB code bytes, as a uint2 (the unused bytes zero).
template <int CB>
__device__ __forceinline__ uint2 load_codes(const uint8_t* p) {
  if constexpr (CB == 8) {
    return *reinterpret_cast<const uint2*>(p);
  } else if constexpr (CB == 4) {
    return make_uint2(*reinterpret_cast<const uint32_t*>(p), 0);
  } else {
    return make_uint2(*reinterpret_cast<const uint16_t*>(p), 0);
  }
}

// Four f32 or eight bf16 outputs as one 16-byte store.
__device__ __forceinline__ void store_chunk(float* out, const float* y) {
  __stcs(reinterpret_cast<float4*>(out), make_float4(y[0], y[1], y[2], y[3]));
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* out,
                                            const float* y) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(out), make_uint4(w[0], w[1], w[2], w[3]));
}

template <typename OutT, int BITS>
__global__ void __launch_bounds__(kThreads)
    dequant_unpack_vec(const uint8_t* __restrict__ codes,
                       const float* __restrict__ scales,
                       OutT* __restrict__ out, unsigned n_chunks,
                       unsigned chunks_per_group, int group_shift) {
  constexpr int EPC = 16 / sizeof(OutT);     // outputs per 16-byte chunk
  constexpr int CB = EPC * BITS / 8;         // code bytes per chunk
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const unsigned c0 = (t >> 5) * 32 * kUnroll + (t & 31);
  uint2 w[kUnroll];
  float s[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned c = c0 + 32 * u;
    if (c < n_chunks) {
      w[u] = load_codes<CB>(codes + c * CB);
      s[u] = __ldg(scales + (group_shift >= 0 ? c >> group_shift
                                              : c / chunks_per_group));
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned c = c0 + 32 * u;
    if (c < n_chunks) {
      float y[8];
#pragma unroll
      for (int i = 0; i < EPC; ++i) y[i] = code<BITS>(w[u], i) * s[u];
      store_chunk(out + c * EPC, y);
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    dequant_unpack_scalar(const uint8_t* __restrict__ codes,
                          const float* __restrict__ scales,
                          OutT* __restrict__ out, unsigned n_pairs, int bits,
                          unsigned group) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pairs) return;
  int q0, q1;
  if (bits == 4) {
    const uint8_t b = codes[i];
    q0 = (int)(b & 0x0F) - 8;
    q1 = (int)(b >> 4) - 8;
  } else {
    q0 = (int8_t)codes[2 * i];
    q1 = (int8_t)codes[2 * i + 1];
  }
  const float s = scales[2 * i / group];
  out[2 * i] = from_f32<OutT>((float)q0 * s);
  out[2 * i + 1] = from_f32<OutT>((float)q1 * s);
}

template <typename OutT, int BITS>
void launch_vec(const uint8_t* codes, const float* scales, OutT* out,
                unsigned n, unsigned group, cudaStream_t s) {
  constexpr unsigned EPC = 16 / sizeof(OutT), per_block = kThreads * kUnroll;
  const unsigned n_chunks = n / EPC, per_group = group / EPC;
  const int shift =
      (per_group & (per_group - 1)) ? -1 : __builtin_ctz(per_group);
  dequant_unpack_vec<OutT, BITS>
      <<<(n_chunks + per_block - 1) / per_block, kThreads, 0, s>>>(
          codes, scales, out, n_chunks, per_group, shift);
}

template <typename OutT>
void launch(const uint8_t* codes, const float* scales, OutT* out, unsigned n,
            int bits, unsigned group, cudaStream_t s) {
  constexpr unsigned EPC = 16 / sizeof(OutT);
  const unsigned code_bytes = EPC * bits / 8;
  if (group % EPC == 0 &&
      reinterpret_cast<uintptr_t>(codes) % code_bytes == 0) {
    if (bits == 8)
      launch_vec<OutT, 8>(codes, scales, out, n, group, s);
    else
      launch_vec<OutT, 4>(codes, scales, out, n, group, s);
    return;
  }
  const unsigned n_pairs = n / 2;
  dequant_unpack_scalar<OutT>
      <<<(n_pairs + kThreads - 1) / kThreads, kThreads, 0, s>>>(
          codes, scales, out, n_pairs, bits, group);
}

}  // namespace

// codes (n_rows, d) int8 or (n_rows, d / 2) uint8 nibbles and scales
// (n_rows, d / group) f32, contiguous at any offset; out (n_rows, d) f32
// or bf16, a fresh allocation.  group is even and divides d.
extern "C" int dequant_unpack(const void* codes, const float* scales,
                              void* out, int out_is_bf16, int n_rows, int d,
                              int bits, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)n_rows * d;
  const long long piece = kPiece / group * group;
  for (long long e0 = 0; e0 < n; e0 += piece) {
    const unsigned len = (unsigned)(n - e0 < piece ? n - e0 : piece);
    const uint8_t* c =
        static_cast<const uint8_t*>(codes) + (bits == 8 ? e0 : e0 / 2);
    const float* sc = scales + e0 / group;
    if (out_is_bf16)
      launch(c, sc, static_cast<__nv_bfloat16*>(out) + e0, len, bits,
             (unsigned)group, s);
    else
      launch(c, sc, static_cast<float*>(out) + e0, len, bits,
             (unsigned)group, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
