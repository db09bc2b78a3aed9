// Per-page KIVI quantization for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of repro/kernels/kv_quant/kv_quant.py:
//   * quantize_pages (body `_kernel`): pages (NP, P, C) f32 -> codes (NP, P, C)
//     uint8 and f32 scale / zero planes, (NP, 1, C) when grouped per channel
//     (min/max over the P tokens: keys) or (NP, P, 1) when grouped per token
//     (min/max over the C channels: values). scale = (hi - lo) / (2^bits - 1),
//     0 replaced by 1; codes = clip(round((x - lo) / scale), 0, 2^bits - 1),
//     rounding half to even; zero = lo;
//   * dequantize_pages (body `_dekernel`): codes * scale + zero into f32, bf16
//     or f16.
//
// Design (simple and right first): one CTA per page, as the TPU grid has one
// step per page. Per-channel groups: one thread per channel walks the P
// tokens, so a warp's loads of one token row are contiguous. Per-token
// groups: one warp per token, lanes split the channels, min and max reduced
// with warp shuffles. Min and max are exact in any order. Every other step is
// a single IEEE-rounded f32 operation written with the _rn intrinsics, which
// nvcc never contracts into a fused multiply-add, and rounding uses rintf
// (half to even, like jnp.round and torch.round), so codes and planes are
// byte-equal to the plain PyTorch version (kernels/kv_quant/ref.py) on the
// same f32 input. Build without --use_fast_math.
//
// Bound on this card: HBM bytes. The pack reads 4 bytes and writes 1 per
// element (plus the planes) and does a handful of operations on each; the
// unpack reads 1 and writes 2 or 4.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// (hi - lo) / qmax with a zero range mapped to 1.
__device__ __forceinline__ float group_scale(float lo, float hi, float qmax) {
  const float s = __fdiv_rn(__fsub_rn(hi, lo), qmax);
  return s == 0.f ? 1.f : s;
}

// clip(rint((x - lo) / scale), 0, qmax): an integral value in [0, 255].
__device__ __forceinline__ uint8_t encode(float x, float lo, float scale, float qmax) {
  const float c = rintf(__fdiv_rn(__fsub_rn(x, lo), scale));
  return (uint8_t)fminf(fmaxf(c, 0.f), qmax);
}

__global__ void __launch_bounds__(kThreads) quantize_pages_kernel(
    const float* __restrict__ x, uint8_t* __restrict__ codes, float* __restrict__ scale,
    float* __restrict__ zero, int P, int C, float qmax, int per_channel) {
  const size_t page = blockIdx.x;
  const float* xp = x + page * P * C;
  uint8_t* cp = codes + page * P * C;
  if (per_channel) {
    // keys: a group is one channel's P tokens
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float lo = xp[c], hi = xp[c];
      for (int t = 1; t < P; ++t) {
        const float v = xp[t * C + c];
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
      const float s = group_scale(lo, hi, qmax);
      scale[page * C + c] = s;
      zero[page * C + c] = lo;
      for (int t = 0; t < P; ++t) cp[t * C + c] = encode(xp[t * C + c], lo, s, qmax);
    }
  } else {
    // values: a group is one token's C channels
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int t = warp; t < P; t += kWarps) {
      const float* row = xp + t * C;
      float lo = row[0], hi = row[0];
      for (int c = lane; c < C; c += 32) {
        lo = fminf(lo, row[c]);
        hi = fmaxf(hi, row[c]);
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      const float s = group_scale(lo, hi, qmax);
      if (lane == 0) {
        scale[page * P + t] = s;
        zero[page * P + t] = lo;
      }
      for (int c = lane; c < C; c += 32) cp[t * C + c] = encode(row[c], lo, s, qmax);
    }
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dequantize_pages_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ scale,
    const float* __restrict__ zero, T* __restrict__ out, int P, int C, int per_channel) {
  const size_t page = blockIdx.x;
  const size_t base = page * P * C;
  for (int e = threadIdx.x; e < P * C; e += kThreads) {
    const int t = e / C;
    const int c = e - t * C;
    const size_t g = per_channel ? page * C + c : page * P + t;
    out[base + e] =
        from_float<T>(__fadd_rn(__fmul_rn((float)codes[base + e], scale[g]), zero[g]));
  }
}

}  // namespace

extern "C" {

// x (NP, P, C) f32 -> codes (NP, P, C) uint8, scale and zero f32 planes of
// (NP, 1, C) when per_channel, else (NP, P, 1). Returns the launch's CUDA
// error (0 = cudaSuccess); the kernel runs asynchronously on `stream`.
int kv_quantize_pages_launch(const void* x, void* codes, void* scale, void* zero, int NP,
                             int P, int C, int bits, int per_channel, void* stream) {
  if (NP <= 0) return 0;
  const float qmax = (float)((1 << bits) - 1);
  quantize_pages_kernel<<<NP, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(codes),
      static_cast<float*>(scale), static_cast<float*>(zero), P, C, qmax, per_channel);
  return (int)cudaGetLastError();
}

// out_dtype: 0 = float32, 1 = bfloat16, 2 = float16.
int kv_dequantize_pages_launch(int out_dtype, const void* codes, const void* scale,
                               const void* zero, void* out, int NP, int P, int C,
                               int per_channel, void* stream) {
  if (NP <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zero);
  switch (out_dtype) {
    case 0:
      dequantize_pages_kernel<float><<<NP, kThreads, 0, s>>>(
          c, sc, z, static_cast<float*>(out), P, C, per_channel);
      break;
    case 1:
      dequantize_pages_kernel<__nv_bfloat16><<<NP, kThreads, 0, s>>>(
          c, sc, z, static_cast<__nv_bfloat16*>(out), P, C, per_channel);
      break;
    case 2:
      dequantize_pages_kernel<__half><<<NP, kThreads, 0, s>>>(
          c, sc, z, static_cast<__half*>(out), P, C, per_channel);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kv_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
