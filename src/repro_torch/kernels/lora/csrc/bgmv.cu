// Batched grouped LoRA matmul (Punica's BGMV) for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel repro/kernels/lora/lora.py::bgmv (body `_kernel`):
//   y[b] = (x[b] @ A[idx[b]]) @ B[idx[b]]
// x (B, C, Din) in f32, bf16 or f16; A (T, Din, R) f32; B (T, R, Dout) f32; idx (B,)
// int32 -> y (B, C, Dout) in x's dtype, accumulated in f32 and rounded once.
//
// Design (simple and right first): one CTA per (tile of 1024 output columns, group of
// 8 rows of C, batch row). The CTA reads its row's slot id itself (the TPU kernel gets
// it by scalar prefetch) and only that slot's A and B.
//   * Shrink: the 256 threads split Din; each keeps the 8 x 8 partial products of its
//     rows and of one chunk of 8 rank columns in registers; warp shuffles and one pass
//     through shared memory reduce them into h (8, R), which stays in shared memory:
//     the (C, R) intermediate never reaches device memory, as in the TPU kernel.
//   * Expand: each thread owns 4 columns, neighbouring threads on neighbouring
//     columns, so reads of B and writes of y are coalesced, and sums h[c][r] * B[r][n]
//     over r.
// Every column tile of a row recomputes its h: at rank 8 that re-reads the slot's A
// (64 KB at d_model 2048) from L2, cheaper than a second launch and a round trip of h
// through device memory. R is a runtime argument up to kMaxRank, with no padding to a
// lane width (that was a TPU need). Slot 0 is the null adapter: its all-zero tables
// give an exact 0 in every output element (each product is x * 0). An id outside
// [0, T) never reads the tables: its rows are filled with NaN.
//
// Bound on this card: HBM bytes at the serving shapes. The two products do
// 2 R (Din + Dout) operations per token against 4 R (Din + Dout) bytes of factors per
// distinct slot, far below the operations per byte at which the f32 rate binds. At
// decode (B=8, C=1, rank 8) a call moves ~3 MB, under a microsecond at 3.35 TB/s, so
// its time is launch-sized.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;    // rows of C per CTA
constexpr int kRChunk = 8;  // rank columns per shrink pass
constexpr int kColsPerThread = 4;
constexpr int kTileN = kThreads * kColsPerThread;  // output columns per CTA
constexpr int kMaxRank = 64;
constexpr int kMaxGridYZ = 65535;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bgmv_kernel(
    const T* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
    const int* __restrict__ idx, T* __restrict__ y, int C, int Din, int R, int Dout,
    int num_slots) {
  __shared__ float h[kRows][kMaxRank];
  __shared__ float red[kWarps][kRows * kRChunk];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kTileN;
  const int c0 = blockIdx.y * kRows;
  const int rows = min(kRows, C - c0);
  const size_t row0 = (size_t)blockIdx.z * C + c0;  // this CTA's first (b, c) row
  T* yb = y + row0 * Dout;
  const int slot = idx[blockIdx.z];
  if (slot < 0 || slot >= num_slots) {
    for (int c = 0; c < rows; ++c)
      for (int k = 0; k < kColsPerThread; ++k) {
        const int n = n0 + k * kThreads + tid;
        if (n < Dout) yb[(size_t)c * Dout + n] = from_float<T>(NAN);
      }
    return;
  }
  const T* xb = x + row0 * Din;
  const float* as = a + (size_t)slot * Din * R;
  const float* bs = b + (size_t)slot * R * Dout;

  // shrink: h[c][r] = sum_d x[c][d] * A[d][r], kRChunk rank columns per pass
  for (int r0 = 0; r0 < R; r0 += kRChunk) {
    float acc[kRows][kRChunk];
#pragma unroll
    for (int c = 0; c < kRows; ++c)
#pragma unroll
      for (int j = 0; j < kRChunk; ++j) acc[c][j] = 0.f;
    for (int d = tid; d < Din; d += kThreads) {
      const float* ad = as + (size_t)d * R + r0;
      float av[kRChunk];
#pragma unroll
      for (int j = 0; j < kRChunk; ++j) av[j] = r0 + j < R ? ad[j] : 0.f;
#pragma unroll
      for (int c = 0; c < kRows; ++c) {
        const float xv = c < rows ? to_float<T>(xb[(size_t)c * Din + d]) : 0.f;
#pragma unroll
        for (int j = 0; j < kRChunk; ++j) acc[c][j] = fmaf(xv, av[j], acc[c][j]);
      }
    }
#pragma unroll
    for (int c = 0; c < kRows; ++c)
#pragma unroll
      for (int j = 0; j < kRChunk; ++j) {
        const float s = warp_sum(acc[c][j]);
        if (lane == 0) red[warp][c * kRChunk + j] = s;
      }
    __syncthreads();
    if (tid < kRows * kRChunk) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][tid];
      const int j = tid % kRChunk;
      if (r0 + j < R) h[tid / kRChunk][r0 + j] = s;
    }
    __syncthreads();
  }

  // expand: y[c][n] = sum_r h[c][r] * B[r][n]
  float out[kRows][kColsPerThread];
#pragma unroll
  for (int c = 0; c < kRows; ++c)
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) out[c][k] = 0.f;
  for (int r = 0; r < R; ++r) {
    const float* br = bs + (size_t)r * Dout;
    float bv[kColsPerThread];
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      const int n = n0 + k * kThreads + tid;
      bv[k] = n < Dout ? br[n] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kRows; ++c) {
      const float hv = h[c][r];
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k) out[c][k] = fmaf(hv, bv[k], out[c][k]);
    }
  }
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    if (c >= rows) break;
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      const int n = n0 + k * kThreads + tid;
      if (n < Dout) yb[(size_t)c * Dout + n] = from_float<T>(out[c][k]);
    }
  }
}

template <typename T>
void launch(dim3 grid, cudaStream_t s, const void* x, const void* a, const void* b,
            const void* idx, void* y, int C, int Din, int R, int Dout, int num_slots) {
  bgmv_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const int*>(idx), static_cast<T*>(y), C,
      Din, R, Dout, num_slots);
}

}  // namespace

extern "C" {

// x (B, C, Din), a (T, Din, R) f32, b (T, R, Dout) f32, idx (B,) int32 -> y (B, C,
// Dout) in x's dtype. dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns the
// launch's CUDA error (0 = cudaSuccess); the kernel runs asynchronously on `stream`.
int bgmv_launch(int dtype, const void* x, const void* a, const void* b, const void* idx,
                void* y, int B, int C, int Din, int R, int Dout, int num_slots, void* stream) {
  if (R < 1 || R > kMaxRank || B > kMaxGridYZ || (C + kRows - 1) / kRows > kMaxGridYZ)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || C <= 0 || Dout <= 0) return 0;
  const dim3 grid((Dout + kTileN - 1) / kTileN, (C + kRows - 1) / kRows, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(grid, s, x, a, b, idx, y, C, Din, R, Dout, num_slots);
      break;
    case 1:
      launch<__nv_bfloat16>(grid, s, x, a, b, idx, y, C, Din, R, Dout, num_slots);
      break;
    case 2:
      launch<__half>(grid, s, x, a, b, idx, y, C, Din, R, Dout, num_slots);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* bgmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
