// Paged decode attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/paged_attention/paged_attention.py::paged_attention
// (the Pallas TPU kernel, body `_kernel`). Same function: one query token per
// row attends over a paged KV pool, online softmax in fp32, positions
// >= lengths[b] masked, the G query heads of a KV head share each page read.
//   q (B, KV, G, D), k_pages / v_pages (KV, NB, P, D), block_tables (B, NP)
//   int32, lengths (B,) int32 -> out (B, KV, G, D) in q's dtype.
//
// Design (simple and right first):
//   * one CTA per (b, kv) row; a loop over only the min(lengths[b], NP * P)
//     positions the row needs, block ids read from the table itself: the
//     TPU grid's sequential page axis becomes this loop;
//   * positions are staged a tile at a time (16 KB of K and 16 KB of V, so
//     64 tokens at D = 128 in bf16; a tile may span pages or cover part of
//     one) into shared memory as fp32. Each thread owns 4 16-byte vectors
//     of each: it starts all of their loads at once into registers, and
//     starts the next tile's loads before this tile's math, so the loads
//     of one tile overlap the math of the previous one;
//   * scores: each warp computes 4 (query head, token) dot products at a
//     time, its lanes splitting D, so 4 shuffle reductions overlap; online
//     softmax: one warp per query head keeps the running max m and sum l;
//     the (G, D) accumulator lives in shared memory, one thread per (g, d)
//     summing the tile's p * v with 4 partial sums; D is a template
//     argument (32, 64, 128 or 256), so every loop over it unrolls;
//   * slots at or past lengths[b] are never loaded and never enter a sum
//     (not multiplied by a zero weight: 0 * Inf would be NaN), so garbage in
//     dead page slots cannot reach the output; a row of length 0 writes 0.
//
// Bound on this card: HBM bytes. Each row streams its K and V pages once:
// B * KV * ceil(L / P) * P * D * 2 * itemsize bytes, against ~4 flops per
// K/V element pair, far below the H100's flop-per-byte balance.
//
// Left for later PRs:
//   * split-K across CTAs for small B * KV (MQA gives only B CTAs for 132
//     SMs) with a second merge pass;
//   * TMA / cp.async pipelines of pages in place of the register staging;
//   * a native chunked (extend) kernel, so prefill stops re-reading each
//     page C times through the batch-axis fold in ops.py.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 16 * 1024;                // K (and V) bytes per tile
constexpr int kVecsPerThread = kTileBytes / 16 / kThreads;  // 16-byte vectors

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

// One tile of K and V in flight: each thread's 16-byte vectors, as loaded.
struct TileRegs {
  uint4 k[kVecsPerThread];
  uint4 v[kVecsPerThread];
};

// Start the loads of positions [tok0, tok0 + n) of this (b, kv) row. Vector
// c of the tile is token c / kVpt, part c % kVpt of its D values; the
// token's page comes from the row's block table. The page base pointers are
// 16-byte aligned (the wrapper checks), and so is every token's row.
template <typename T, int D>
__device__ __forceinline__ void load_tile(TileRegs& r, const T* __restrict__ k_pages,
                                          const T* __restrict__ v_pages,
                                          const int* __restrict__ table, size_t kv_nb,
                                          int P, int tok0, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpt = D / kVec;  // vectors per token
#pragma unroll
  for (int i = 0; i < kVecsPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < n * kVpt) {
      const int tok = tok0 + c / kVpt;
      const int page = tok / P;
      const size_t off = ((kv_nb + table[page]) * P + (tok - page * P)) * (size_t)D +
                         (size_t)(c % kVpt) * kVec;
      r.k[i] = *reinterpret_cast<const uint4*>(k_pages + off);
      r.v[i] = *reinterpret_cast<const uint4*>(v_pages + off);
    }
  }
}

// Convert the loaded vectors to fp32 and store them as the (n, D) K and V
// tiles in shared memory.
template <typename T, int D>
__device__ __forceinline__ void store_tile(const TileRegs& r, float* k_s, float* v_s, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpt = D / kVec;
#pragma unroll
  for (int i = 0; i < kVecsPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < n * kVpt) {
      const T* ek = reinterpret_cast<const T*>(&r.k[i]);
      const T* ev = reinterpret_cast<const T*>(&r.v[i]);
      float4* dk = reinterpret_cast<float4*>(k_s + c * kVec);
      float4* dv = reinterpret_cast<float4*>(v_s + c * kVec);
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        dk[e / 4] = make_float4(to_float(ek[e]), to_float(ek[e + 1]), to_float(ek[e + 2]),
                                to_float(ek[e + 3]));
        dv[e / 4] = make_float4(to_float(ev[e]), to_float(ev[e + 1]), to_float(ev[e + 2]),
                                to_float(ev[e + 3]));
      }
    }
  }
}

int tile_tokens(int D, int itemsize) { return kTileBytes / (D * itemsize); }

size_t smem_floats(int G, int D, int tile) {
  // q, acc: G*D each; K, V tiles: tile*D each; scores: G*tile; m, l, alpha: G
  return 2 * (size_t)G * D + 2 * (size_t)tile * D + (size_t)G * tile + 3 * (size_t)G;
}

// Each warp computes kDots dot products at once, so that their loads and
// shuffle reductions overlap instead of waiting on each other.
constexpr int kDots = 4;
// The P.V sum over a tile keeps kAcc independent partial sums per output.
constexpr int kAcc = 4;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, T* __restrict__ out, int KV, int G, int NB,
    int P, int NP, int tile, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int GD = G * D;
  float* q_s = smem;            // (G, D)
  float* acc = q_s + GD;        // (G, D) running numerator
  float* k_s = acc + GD;        // (tile, D)
  float* v_s = k_s + tile * D;  // (tile, D)
  float* p_s = v_s + tile * D;  // (G, tile) scores, then probabilities
  float* m_s = p_s + G * tile;  // (G,) running max
  float* l_s = m_s + G;         // (G,) running sum
  float* a_s = l_s + G;         // (G,) this tile's rescale factor

  const int row = blockIdx.x;  // b * KV + kv
  const int b = row / KV;
  const int kv = row - b * KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qr = q + (size_t)row * GD;
  for (int i = threadIdx.x; i < GD; i += kThreads) {
    q_s[i] = to_float(qr[i]);
    acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // positions this row reads: a prefix of its table, never past it
  const int n_tokens = max(0, min(lengths[b], NP * P));
  const int* table = block_tables + (size_t)b * NP;
  const size_t kv_nb = (size_t)kv * NB;

  TileRegs regs;
  if (n_tokens > 0)
    load_tile<T, D>(regs, k_pages, v_pages, table, kv_nb, P, 0, min(tile, n_tokens));
  for (int tok0 = 0; tok0 < n_tokens; tok0 += tile) {
    const int n_valid = min(tile, n_tokens - tok0);  // valid tokens: a prefix
    __syncthreads();  // the previous tile's readers are done with the staging
    store_tile<T, D>(regs, k_s, v_s, n_valid);
    __syncthreads();
    const int next = tok0 + tile;
    if (next < n_tokens)  // in flight while this tile's math runs
      load_tile<T, D>(regs, k_pages, v_pages, table, kv_nb, P, next,
                      min(tile, n_tokens - next));
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
        p_s[g * tile + (t - g * n_valid)] = mine * scale;
      }
    }
    __syncthreads();
    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < n_valid; j += 32) mx = fmaxf(mx, p_s[g * tile + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n_valid; j += 32) {
        const float e = expf(p_s[g * tile + j] - m_new);
        p_s[g * tile + j] = e;
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
      const float* pg = p_s + g * tile;
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
  T* o = out + (size_t)row * GD;
  for (int i = threadIdx.x; i < GD; i += kThreads)
    o[i] = from_float<T>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T, int D>
int launch_d(const void* q, const void* k_pages, const void* v_pages,
             const int* block_tables, const int* lengths, void* out, int B, int KV,
             int G, int NB, int P, int NP, float scale, cudaStream_t stream) {
  const int tile = tile_tokens(D, sizeof(T));
  const size_t smem = smem_floats(G, D, tile) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_kernel<T, D><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, lengths, static_cast<T*>(out),
      KV, G, NB, P, NP, tile, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_tables, const int* lengths, void* out, int B, int KV,
           int G, int D, int NB, int P, int NP, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k_pages, v_pages, block_tables, lengths, out, B, KV, G, NB,
                             P, NP, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k_pages, v_pages, block_tables, lengths, out, B, KV, G, NB,
                             P, NP, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k_pages, v_pages, block_tables, lengths, out, B, KV, G,
                              NB, P, NP, scale, stream);
    case 256:
      return launch_d<T, 256>(q, k_pages, v_pages, block_tables, lengths, out, B, KV, G,
                              NB, P, NP, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for an element of `itemsize` bytes,
// so the wrapper can refuse a shape before launching it.
long long paged_attention_smem_bytes(int G, int D, int itemsize) {
  return (long long)(smem_floats(G, D, tile_tokens(D, itemsize)) * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns the CUDA error of
// the launch (0 = cudaSuccess); the kernel runs asynchronously on `stream`.
int paged_attention_launch(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* lengths, void* out, int B, int KV, int G,
                           int D, int NB, int P, int NP, float scale, void* stream) {
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pages, v_pages, tables, lens, out, B, KV, G, D, NB, P, NP,
                           scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, lens, out, B, KV, G, D, NB,
                                   P, NP, scale, s);
    case 2:
      return launch<__half>(q, k_pages, v_pages, tables, lens, out, B, KV, G, D, NB, P, NP,
                            scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
