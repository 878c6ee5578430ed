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
// `x @ h` to the bit and the wire bytes do not move.  H is the f32 table
// the host builds (transforms.hadamard_matrix), passed in: 1/sqrt(D)
// computed on the card would round differently.  A butterfly (fast
// Walsh-Hadamard) or a tensor-core product sums in another order and
// gives up that equality.
//
// Bound on this card: at D=128 and f32 in/out the bytes (x once, y once)
// take 0.08 ms per 262144 rows at 3.35 TB/s; the in-order form does
// 2 T D^2 FMA flops on the f32 pipes (no tensor cores: they would change
// the order), 0.128 ms at 67 TFLOP/s, so this kernel is bound by
// operations.  Design: 256 threads per block; each thread owns 4
// neighbouring columns (one float4 of H per k) of R = 8 rows, with 32
// accumulators in registers.  The k axis is walked in chunks of KT rows
// of H; each chunk of H (KT x D) and of the block's x rows (BR x KT, f32,
// row stride padded by 4 floats against bank conflicts) is staged in
// shared memory.  Per 4 k-steps a thread reads 8 float4 of x (broadcast
// within its row group) and 4 float4 of H for 128 FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows per thread

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store4(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  reinterpret_cast<__nv_bfloat162*>(out)[0] = lo;
  reinterpret_cast<__nv_bfloat162*>(out)[1] = hi;
}

__host__ __device__ constexpr int chunk_k(int d) { return d < 64 ? d : 64; }
__host__ __device__ constexpr int block_rows(int d) {
  return (kThreads / (d / 4)) * kRows;
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    hadamard_kernel(const TIn* __restrict__ x, const float* __restrict__ h,
                    TOut* __restrict__ y, int n_rows, int d) {
  extern __shared__ __align__(16) float smem[];
  const int kt = chunk_k(d);
  const int xs_stride = kt + 4;
  const int col_threads = d / 4;
  const int row_groups = kThreads / col_threads;
  const int br = row_groups * kRows;
  float* hs = smem;              // (kt, d)
  float* xs = smem + kt * d;     // (br, kt + 4)

  const int tid = threadIdx.x;
  const int c = tid % col_threads;    // columns 4c .. 4c+3
  const int g = tid / col_threads;    // rows g + row_groups * i
  const long long row0 = (long long)blockIdx.x * br;

  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kt) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < kt * d; e += kThreads) hs[e] = h[k0 * d + e];
    for (int e = tid; e < br * kt; e += kThreads) {
      const int r = e / kt, kk = e % kt;
      const long long row = row0 + r;
      xs[r * xs_stride + kk] =
          row < n_rows ? to_f32(x[row * d + k0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kt; kk += 4) {
      float4 xv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        xv[i] = *reinterpret_cast<const float4*>(
            &xs[(g + row_groups * i) * xs_stride + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 hv =
            *reinterpret_cast<const float4*>(&hs[(kk + u) * d + 4 * c]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float xk = u == 0 ? xv[i].x
                           : u == 1 ? xv[i].y
                           : u == 2 ? xv[i].z
                                    : xv[i].w;
          acc[i][0] = __fmaf_rn(xk, hv.x, acc[i][0]);
          acc[i][1] = __fmaf_rn(xk, hv.y, acc[i][1]);
          acc[i][2] = __fmaf_rn(xk, hv.z, acc[i][2]);
          acc[i][3] = __fmaf_rn(xk, hv.w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long row = row0 + g + row_groups * i;
    if (row < n_rows)
      store4(y + row * d + 4 * c,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const float* h, void* y, int n_rows, int d,
           cudaStream_t s) {
  const int br = block_rows(d);
  const int kt = chunk_k(d);
  const size_t smem = (size_t)(kt * d + br * (kt + 4)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hadamard_kernel<TIn, TOut>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_rows + br - 1) / br);
  hadamard_kernel<TIn, TOut><<<blocks, kThreads, smem, s>>>(
      static_cast<const TIn*>(x), h, static_cast<TOut*>(y), n_rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n_rows, d) bf16 or f32, h (d, d) f32, y (n_rows, d) f32 or bf16.
// d must be a power of two in [4, 512] (the wrapper checks).
extern "C" int hadamard(const void* x, int x_is_bf16, const float* h,
                        void* y, int y_is_bf16, int n_rows, int d,
                        void* stream) {
  if (n_rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return y_is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, h, y, n_rows,
                                                            d, s)
                     : launch<__nv_bfloat16, float>(x, h, y, n_rows, d, s);
  return y_is_bf16 ? launch<float, __nv_bfloat16>(x, h, y, n_rows, d, s)
                   : launch<float, float>(x, h, y, n_rows, d, s);
}
