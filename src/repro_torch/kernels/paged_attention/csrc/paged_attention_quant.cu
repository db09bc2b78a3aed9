// Paged decode attention over KIVI-quantized pages for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Replaces repro/kernels/paged_attention/paged_attention.py::
// paged_attention_quant (the Pallas TPU kernel, body `_quant_kernel`). Same
// function: one query token per row attends over a paged KV pool whose
// packed pages hold uint8 codes with f16 scale/zero planes (keys grouped per
// channel: planes (1, D) per page; values per token: planes (P, 1) per page),
// plus a full-precision tail that holds the positions from tail_start[b] up
// (the still-filling page and the step's own K/V). Online softmax in fp32
// over both, in one running (m, l, acc).
//   q (R, KV, G, D); k_codes / v_codes (KV, NB, P, D) uint8; k_scale / k_zero
//   (KV, NB, 1, D) f16; v_scale / v_zero (KV, NB, P, 1) f16; k_tail / v_tail
//   (B, T, KV, D) in q's dtype; block_tables (B, NP), lengths (R,) and
//   tail_start (B,) int32 -> out (R, KV, G, D) in q's dtype, R = B * rows_per_seq.
// Row r belongs to sequence r / rows_per_seq and takes its table, tail_start
// and tail; lengths is per row. rows_per_seq = C is the extend fold (row
// b*C + j is query j of sequence b, with length lengths_b + j + 1) without
// repeating the tails and tables C times in memory; 1 is plain decode.
//
// Validity, as in the TPU kernel and kernels/paged_attention/ref.py: page slot
// `pos` is valid where pos < tail_start[b]; tail slot i (position
// tail_start[b] + i) where that is < lengths[r]. A page value is
// codes * scale + zero in fp32 (two IEEE roundings, the _rn intrinsics, never
// contracted into an FMA), then rounded to the cache's logical dtype
// (`deq`) and back: greedy parity depends on that round trip. Tail values are
// rounded through `deq` too, as the plain version does (a no-op when the tail
// is in the cache dtype, as on the serving path).
//
// Design (simple and right first), the v3 structure of paged_attention.cu:
//   * one CTA per (row, kv); the positions a row needs form one stream, its
//     ceil(tail_start/P) packed pages' valid slots and then its valid tail
//     slots; the stream is staged 64 positions at a time into shared memory
//     as dequantized fp32 K and V (a tile may span pages and the tail);
//   * scores: each warp computes 4 (query head, position) dot products at
//     once, lanes splitting D; online softmax one warp per query head; the
//     (G, D) accumulator in shared memory, one thread per (g, d) with 4
//     partial sums; D a template argument (32, 64, 128 or 256);
//   * a page slot at or past tail_start and a tail slot at or past lengths
//     are never loaded (not multiplied by a zero weight: 0 * Inf is NaN), so
//     garbage there cannot reach the output; a row with nothing valid
//     writes 0.
//
// Bound on this card: HBM bytes. A row reads 2 * D bytes of codes per
// position plus the planes (4 * D bytes of K planes per page, 4 bytes of V
// planes per position) and its tail, against ~4 flops per K/V element pair.
// Left for later PRs: register prefetch of the next tile (as the fp kernel
// does), split-K across CTAs, and one CTA per sequence for the extend fold so
// its C rows share one read of the pages.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // positions staged per tile
// Each warp computes kDots dot products at once, so that their loads and
// shuffle reductions overlap instead of waiting on each other.
constexpr int kDots = 4;
// The P.V sum over a tile keeps kAcc independent partial sums per output.
constexpr int kAcc = 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// 4 consecutive elements as fp32 (16 bytes of f32, 8 of bf16 / f16; the
// wrapper checks the alignment of the base pointers, D % 4 == 0 the rest)
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = to_float(e[i]);
}

// round to the cache's logical dtype and back: 0 = f32, 1 = bf16, 2 = f16
__device__ __forceinline__ float round_deq(float x, int deq) {
  if (deq == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (deq == 2) return __half2float(__float2half_rn(x));
  return x;
}

__device__ __forceinline__ float dequant(uint8_t code, __half s, __half z, int deq) {
  return round_deq(__fadd_rn(__fmul_rn((float)code, __half2float(s)), __half2float(z)),
                   deq);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

size_t smem_floats(int G, int D) {
  // q, acc: G*D each; K, V tiles: kTile*D each; scores: G*kTile; m, l, alpha: G
  return 2 * (size_t)G * D + 2 * (size_t)kTile * D + (size_t)G * kTile + 3 * (size_t)G;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_quant_kernel(
    const T* __restrict__ q, const uint8_t* __restrict__ k_codes,
    const __half* __restrict__ k_scale, const __half* __restrict__ k_zero,
    const uint8_t* __restrict__ v_codes, const __half* __restrict__ v_scale,
    const __half* __restrict__ v_zero, const T* __restrict__ k_tail,
    const T* __restrict__ v_tail, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, const int* __restrict__ tail_start,
    T* __restrict__ out, int KV, int G, int NB, int P, int NP, int T_len,
    int rows_per_seq, int deq, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int GD = G * D;
  float* q_s = smem;             // (G, D)
  float* acc = q_s + GD;         // (G, D) running numerator
  float* k_s = acc + GD;         // (kTile, D)
  float* v_s = k_s + kTile * D;  // (kTile, D)
  float* p_s = v_s + kTile * D;  // (G, kTile) scores, then probabilities
  float* m_s = p_s + G * kTile;  // (G,) running max
  float* l_s = m_s + G;          // (G,) running sum
  float* a_s = l_s + G;          // (G,) this tile's rescale factor

  const int rk = blockIdx.x;  // r * KV + kv
  const int r = rk / KV;
  const int kv = rk - r * KV;
  const int b = r / rows_per_seq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qr = q + (size_t)rk * GD;
  for (int i = threadIdx.x; i < GD; i += kThreads) {
    q_s[i] = to_float(qr[i]);
    acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // the row's stream: its valid page slots, then its valid tail slots
  const int ts = tail_start[b];
  const int n_page = max(0, min(ts, NP * P));
  const int n_tail = max(0, min(lengths[r] - ts, T_len));
  const int n_tokens = n_page + n_tail;
  const int* table = block_tables + (size_t)b * NP;
  constexpr int kGroups = D / 4;  // 4-element groups per position

  for (int tok0 = 0; tok0 < n_tokens; tok0 += kTile) {
    const int n_valid = min(kTile, n_tokens - tok0);
    __syncthreads();  // the previous tile's readers are done with the staging
    for (int c = threadIdx.x; c < n_valid * kGroups; c += kThreads) {
      const int i = c / kGroups;
      const int d = (c - i * kGroups) * 4;
      const int pos = tok0 + i;
      float kf[4], vf[4];
      if (pos < n_page) {
        const int page = pos / P;
        const int slot = pos - page * P;
        const size_t pg = (size_t)kv * NB + table[page];  // page in (KV, NB)
        const size_t off = (pg * P + slot) * D + d;
        const uchar4 kc = *reinterpret_cast<const uchar4*>(k_codes + off);
        const uchar4 vc = *reinterpret_cast<const uchar4*>(v_codes + off);
        const __half* ks = k_scale + pg * D + d;
        const __half* kz = k_zero + pg * D + d;
        const __half vs = v_scale[pg * P + slot];
        const __half vz = v_zero[pg * P + slot];
        kf[0] = dequant(kc.x, ks[0], kz[0], deq);
        kf[1] = dequant(kc.y, ks[1], kz[1], deq);
        kf[2] = dequant(kc.z, ks[2], kz[2], deq);
        kf[3] = dequant(kc.w, ks[3], kz[3], deq);
        vf[0] = dequant(vc.x, vs, vz, deq);
        vf[1] = dequant(vc.y, vs, vz, deq);
        vf[2] = dequant(vc.z, vs, vz, deq);
        vf[3] = dequant(vc.w, vs, vz, deq);
      } else {
        const size_t off = (((size_t)b * T_len + (pos - n_page)) * KV + kv) * D + d;
        load4(k_tail + off, kf);
        load4(v_tail + off, vf);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kf[e] = round_deq(kf[e], deq);
          vf[e] = round_deq(vf[e], deq);
        }
      }
      *reinterpret_cast<float4*>(k_s + i * D + d) = make_float4(kf[0], kf[1], kf[2], kf[3]);
      *reinterpret_cast<float4*>(v_s + i * D + d) = make_float4(vf[0], vf[1], vf[2], vf[3]);
    }
    __syncthreads();
    // scores s[g, j] = scale * q[g] . k[j]: each warp takes kDots (g, j)
    // pairs at a time, lanes split D
    const int n_dots = G * n_valid;
    for (int t0 = warp * kDots; t0 < n_dots; t0 += kWarps * kDots) {
      int qo[kDots], ko[kDots];
      float s[kDots];
#pragma unroll
      for (int u = 0; u < kDots; ++u) {
        const int t = min(t0 + u, n_dots - 1);  // past the end: redo the last
        const int g = t / n_valid;
        qo[u] = g * D;
        ko[u] = (t - g * n_valid) * D;
        s[u] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const int d = lane + 32 * i;
#pragma unroll
        for (int u = 0; u < kDots; ++u) s[u] += q_s[qo[u] + d] * k_s[ko[u] + d];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kDots; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      }
      if (lane < kDots && t0 + lane < n_dots) {
        float mine = s[0];
#pragma unroll
        for (int u = 1; u < kDots; ++u)
          if (lane == u) mine = s[u];
        const int t = t0 + lane;
        const int g = t / n_valid;
        p_s[g * kTile + (t - g * n_valid)] = mine * scale;
      }
    }
    __syncthreads();
    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < n_valid; j += 32) mx = fmaxf(mx, p_s[g * kTile + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n_valid; j += 32) {
        const float e = expf(p_s[g * kTile + j] - m_new);
        p_s[g * kTile + j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
      }
    }
    __syncthreads();
    // acc[g, d] = acc[g, d] * alpha[g] + sum_j p[g, j] * v[j, d]
    for (int i = threadIdx.x; i < GD; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = p_s + g * kTile;
      float part[kAcc] = {};
      int j = 0;
      for (; j + kAcc <= n_valid; j += kAcc) {
#pragma unroll
        for (int u = 0; u < kAcc; ++u) part[u] += pg[j + u] * v_s[(j + u) * D + d];
      }
      for (; j < n_valid; ++j) part[0] += pg[j] * v_s[j * D + d];
      float o = acc[i] * a_s[g];
#pragma unroll
      for (int u = 0; u < kAcc; ++u) o += part[u];
      acc[i] = o;
    }
  }
  __syncthreads();
  T* o = out + (size_t)rk * GD;
  for (int i = threadIdx.x; i < GD; i += kThreads)
    o[i] = from_float<T>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

struct Args {
  const void *q, *k_codes, *k_scale, *k_zero, *v_codes, *v_scale, *v_zero, *k_tail,
      *v_tail;
  const int *tables, *lengths, *tail_start;
  void* out;
  int rows, rows_per_seq, KV, G, NB, P, NP, T_len, deq;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_d(const Args& a) {
  const size_t smem = smem_floats(a.G, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(paged_attention_quant_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_quant_kernel<T, D><<<a.rows * a.KV, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const uint8_t*>(a.k_codes),
      static_cast<const __half*>(a.k_scale), static_cast<const __half*>(a.k_zero),
      static_cast<const uint8_t*>(a.v_codes), static_cast<const __half*>(a.v_scale),
      static_cast<const __half*>(a.v_zero), static_cast<const T*>(a.k_tail),
      static_cast<const T*>(a.v_tail), a.tables, a.lengths, a.tail_start,
      static_cast<T*>(a.out), a.KV, a.G, a.NB, a.P, a.NP, a.T_len, a.rows_per_seq, a.deq,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int D) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(a);
    case 64:
      return launch_d<T, 64>(a);
    case 128:
      return launch_d<T, 128>(a);
    case 256:
      return launch_d<T, 256>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, so the wrapper can refuse a shape
// before launching it.
long long paged_attention_quant_smem_bytes(int G, int D) {
  return (long long)(smem_floats(G, D) * sizeof(float));
}

// dtype (q, tails, out): 0 = float32, 1 = bfloat16, 2 = float16; deq, the
// cache's logical dtype, the same codes. Returns the launch's CUDA error
// (0 = cudaSuccess); the kernel runs asynchronously on `stream`.
int paged_attention_quant_launch(int dtype, int deq, const void* q, const void* k_codes,
                                 const void* k_scale, const void* k_zero,
                                 const void* v_codes, const void* v_scale,
                                 const void* v_zero, const void* k_tail,
                                 const void* v_tail, const void* block_tables,
                                 const void* lengths, const void* tail_start, void* out,
                                 int rows, int rows_per_seq, int KV, int G, int D, int NB,
                                 int P, int NP, int T, float scale, void* stream) {
  if (rows * KV == 0) return 0;
  const Args a{q, k_codes, k_scale, k_zero, v_codes, v_scale, v_zero, k_tail, v_tail,
               static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
               static_cast<const int*>(tail_start), out, rows, rows_per_seq, KV, G, NB,
               P, NP, T, deq, scale, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return launch<float>(a, D);
    case 1:
      return launch<__nv_bfloat16>(a, D);
    case 2:
      return launch<__half>(a, D);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* paged_attention_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
