// Blockwise Hadamard transform y = x @ H_D, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hadamard.py::
// hadamard_transform (body _hadamard_kernel): x (T, D) bf16/f32 times the
// orthonormal (D, D) Hadamard table, f32 accumulation, out f32 or bf16.
// T is any length (the last row tile is masked); D is a power of two,
// 4 <= D <= 512.
//
// Exactness first: every output is ONE in-order FMA chain,
//   acc = 0; for k = 0 .. D-1: acc = fma(x[t][k], H[k][j], acc)
// which is the order a BLAS sgemm micro-kernel takes for K <= its depth
// block, so the device stage reproduces the host pipeline's numpy
// `x @ h` to the bit and the wire bytes do not move.  No split-K, no
// tensor cores or TF32, no butterfly (fast Walsh-Hadamard): each sums in
// another order and gives up that equality.
//
// The table is not read.  Every entry of the host's f32 table
// (transforms.hadamard_matrix) is +c or -c with one f32 c = H[0][0]
// (a +-1 Sylvester matrix divided by one scalar), and the sign of entry
// (k, j) is the parity of popcount(k & j).  The caller passes c.  Since
// fma(-x, c, a) == fma(x, -c, a) bit for bit, each FMA takes +-x against
// a per-thread +-c: with columns j0 .. j0+7 (j0 a multiple of 8) and k in
// blocks k0 .. k0+7, sign(k0+u, j0+t) = parity(k0 & j0) ^ parity(u & t),
// so the first factor flips c once per 8 k-steps and the second is a
// compile-time operand negation of x, which the FFMA takes for free.
//
// Bound on this card: at D=128 and f32 in/out the bytes (x once, y once)
// take 0.08 ms per 262144 rows at 3.35 TB/s; the in-order form does
// 2 T D^2 flops on the f32 pipes, 0.128 ms at 67 TFLOP/s, so this kernel
// is bound by operations.  Design: persistent blocks of 256 threads (as
// many as fit the card, at most 64 registers a thread so that 4 share an
// SM) walk tiles of rows; each thread owns 2 rows x 8 neighbouring
// columns (16 accumulators).  Tiles of x are double-buffered in shared
// memory with 16-byte cp.async (rows padded by 16 bytes against bank
// conflicts), so the next tile's load overlaps this tile's FMAs; bf16
// tiles are widened to f32 in shared memory once, after the copy.  Per 4
// k-steps a thread reads 2 float4 of x (broadcast across the threads of
// its row) for 64 FMAs; the inner loop is FFMAs but for one shared load
// per 32 of them (4 rows a thread with prefetched loads, or 2 blocks an
// SM, measured no faster on the H100).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 2;         // rows per thread
constexpr int kMinBlocks = 4; // per SM: at most 64 registers a thread

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__host__ __device__ constexpr bool parity(int v) {
  return ((v ^ (v >> 1) ^ (v >> 2) ^ (v >> 3)) & 1) != 0;   // v < 16
}

template <int kC>
__device__ __forceinline__ void store_row(float* out, const float* v) {
#pragma unroll
  for (int t = 0; t < kC; t += 4)
    *reinterpret_cast<float4*>(out + t) =
        make_float4(v[t], v[t + 1], v[t + 2], v[t + 3]);
}
template <int kC>
__device__ __forceinline__ void store_row(__nv_bfloat16* out,
                                          const float* v) {
  __nv_bfloat162 p[kC / 2];
#pragma unroll
  for (int t = 0; t < kC / 2; ++t)
    p[t] = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
  if (kC == 8)
    *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(p);
  else
    *reinterpret_cast<uint2*>(out) = *reinterpret_cast<const uint2*>(p);
}

// Shared memory of one block, in bytes: two tiles of x as it arrives
// (rows padded by 16 bytes), then for bf16 x one f32 tile.
__host__ __device__ inline int tile_rows(int d, int kc) {
  return kThreads / (d / kc) * kR;
}
template <typename TIn>
__host__ __device__ inline size_t smem_bytes(int d, int kc) {
  const int tr = tile_rows(d, kc);
  size_t raw = (size_t)2 * tr * (d * sizeof(TIn) + 16);
  if (sizeof(TIn) == 2) raw += (size_t)tr * (d + 4) * sizeof(float);
  return raw;
}

// kC: columns per thread, 8 (4 at D = 4).
template <typename TIn, typename TOut, int kC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    hadamard_kernel(const TIn* __restrict__ x, float c,
                    TOut* __restrict__ y, long long n_rows, int d,
                    long long n_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kVec = 16 / sizeof(TIn);       // elements per 16 bytes
  const int cgs = d / kC;                       // column groups
  const int rl_n = kThreads / cgs;              // row lanes
  const int tr = rl_n * kR;                     // rows per tile
  const int rs_in = d + kVec;                   // staged row stride
  const int rs_f = d + 4;                       // f32 row stride
  TIn* const raw = reinterpret_cast<TIn*>(smem);   // two tiles
  float* xf = reinterpret_cast<float*>(raw + (size_t)2 * tr * rs_in);

  const int tid = threadIdx.x;
  const int cg = tid % cgs, rl = tid / cgs;
  const int j0 = cg * kC;
  const int row_bytes = d * (int)sizeof(TIn);

  auto load = [&](TIn* dst, long long tile) {
    const long long r0 = tile * tr;
    const int rows = (int)min((long long)tr, n_rows - r0);
    const TIn* src = x + r0 * d;
    if (row_bytes >= 16) {
      const int per = d / kVec, shift = __ffs(per) - 1;
      for (int i = tid; i < rows * per; i += kThreads) {
        const int r = i >> shift, q = i & (per - 1);
        cp_async16(dst + r * rs_in + q * kVec, src + (size_t)r * d + q * kVec);
      }
    } else {          // bf16 rows of D = 4: one 8-byte copy each
      for (int r = tid; r < rows; r += kThreads)
        cp_async8(dst + r * rs_in, src + (size_t)r * d);
    }
    cp_async_commit();
  };

  long long tile = blockIdx.x;
  if (tile >= n_tiles) return;
  load(raw, tile);
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles) {
      load(raw + (size_t)((it + 1) & 1) * tr * rs_in, next);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs;
    if (sizeof(TIn) == 2) {   // widen the tile to f32 once
      const __nv_bfloat16* src =
          reinterpret_cast<const __nv_bfloat16*>(raw) +
          (size_t)(it & 1) * tr * rs_in;
      const int per = d / 4;
      for (int i = tid; i < tr * per; i += kThreads) {
        const int r = i / per, q = i - r * per;
        const uint2 w =
            *reinterpret_cast<const uint2*>(src + r * rs_in + 4 * q);
        *reinterpret_cast<float4*>(xf + r * rs_f + 4 * q) = make_float4(
            __uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
            __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
      }
      __syncthreads();
      xs = xf;
    } else {
      xs = reinterpret_cast<const float*>(raw + (size_t)(it & 1) * tr * rs_in);
    }

    float acc[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int t = 0; t < kC; ++t) acc[i][t] = 0.f;
    const float* xr = xs + rl * rs_f;
    for (int k0 = 0; k0 < d; k0 += kC) {
      const float cs = (__popc(k0 & j0) & 1) ? -c : c;
#pragma unroll
      for (int u4 = 0; u4 < kC; u4 += 4) {
        float4 xv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i)
          xv[i] = *reinterpret_cast<const float4*>(
              xr + (size_t)i * rl_n * rs_f + k0 + u4);
#pragma unroll
        for (int uu = 0; uu < 4; ++uu) {
          const int u = u4 + uu;
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const float xk = uu == 0 ? xv[i].x
                             : uu == 1 ? xv[i].y
                             : uu == 2 ? xv[i].z
                                       : xv[i].w;
#pragma unroll
            for (int t = 0; t < kC; ++t)
              acc[i][t] = __fmaf_rn(parity(u & t) ? -xk : xk, cs, acc[i][t]);
          }
        }
      }
    }

    const long long r0 = tile * tr;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const long long row = r0 + rl + i * rl_n;
      if (row < n_rows) store_row<kC>(y + row * d + j0, acc[i]);
    }
    __syncthreads();   // this tile's buffers are free for the next loads
  }
}

template <typename TIn, typename TOut, int kC>
int launch(const void* x, float c, void* y, long long n_rows, int d,
           cudaStream_t s) {
  auto kernel = hadamard_kernel<TIn, TOut, kC>;
  const size_t smem = smem_bytes<TIn>(d, kC);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tr = tile_rows(d, kC);
  const long long n_tiles = (n_rows + tr - 1) / tr;
  const long long grid = n_tiles < (long long)sms * per_sm
                             ? n_tiles : (long long)sms * per_sm;
  kernel<<<(unsigned)grid, kThreads, smem, s>>>(
      static_cast<const TIn*>(x), c, static_cast<TOut*>(y), n_rows, d,
      n_tiles);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch_d(const void* x, float c, void* y, long long n_rows, int d,
             cudaStream_t s) {
  return d == 4 ? launch<TIn, TOut, 4>(x, c, y, n_rows, d, s)
                : launch<TIn, TOut, 8>(x, c, y, n_rows, d, s);
}

}  // namespace

// x (n_rows, d) bf16 or f32, 16-byte aligned; c = H_d[0][0], the host
// table's entry (every entry is +c or -c); y (n_rows, d) f32 or bf16.
// d must be a power of two in [4, 512] (the wrapper checks).
extern "C" int hadamard(const void* x, int x_is_bf16, float c, void* y,
                        int y_is_bf16, long long n_rows, int d,
                        void* stream) {
  if (d < 4 || d > 512 || (d & (d - 1))) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return y_is_bf16
               ? launch_d<__nv_bfloat16, __nv_bfloat16>(x, c, y, n_rows, d, s)
               : launch_d<__nv_bfloat16, float>(x, c, y, n_rows, d, s);
  return y_is_bf16 ? launch_d<float, __nv_bfloat16>(x, c, y, n_rows, d, s)
                   : launch_d<float, float>(x, c, y, n_rows, d, s);
}
