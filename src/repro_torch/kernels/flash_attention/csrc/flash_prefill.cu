// Causal flash prefill attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/flash_attention/flash_attention.py::flash_prefill
// (the Pallas TPU kernel, body `_kernel`). Same function: every query row i
// of a sequence attends over keys j <= i (and j > i - window when window > 0)
// of the same sequence, online softmax over key tiles in fp32, query head h
// reading KV head h / G, output acc / max(l, 1e-30) in q's dtype.
//   q (B, H, S, D), k / v (B, KV, S, D) -> o (B, H, S, D)
// Each of the four is given by its base pointer and its strides over
// (B, heads, S) in elements; D is contiguous. So the model's (B, S, H, D)
// activations and a (B, W, KV, D) cache window are read in place, without
// the transpose copies the TPU layout would need. Any S: the TPU's S % block
// rule is a VMEM tiling rule, not part of the function.
//
// Bound on this card: operations. 4 * B * H * D flops per live (i, j) pair,
// ~4 * B * H * D * S^2 / 2 causal, against B * (H + 2 KV) * S * D elements
// read and B * H * S * D written once: 989 TFLOP/s on the bf16 / f16 tensor
// cores (25.8 GFLOP = 26 us at B=1, H=24, D=128, S=2048, where the 27 MB take
// 8 us at 3.35 TB/s), 67 TFLOP/s in fp32 on the CUDA cores.
//
// Two kernels, chosen by dtype and D alone (the wrapper's kernel_route):
//   * bf16 / f16 with D in {64, 128} (`flash_prefill_wgmma_kernel`): what
//     the tensor cores need on Hopper. wgmma for both products (the only way
//     to their full rate); TMA loads of K and V into a 2-slot shared-memory
//     ring, the next tile in flight under the current tile's math; 128 query
//     rows per CTA over two warpgroups, 128-key tiles, the mask evaluated on
//     edge tiles only; tiles above the diagonal or wholly before the window
//     are never loaded (the TPU kernel's `pl.when(live)`), and the row tiles
//     launch heaviest first. f16 P is rounded once for the P.V product, as
//     FlashAttention and SDPA do, and keeps 11 bits of mantissa; bf16 P
//     (8 bits rounded once: one case erred by 0.031 against the 3e-2 gate)
//     is split into a head and a remainder, two P.V products, ~16 bits. The
//     TPU kernel multiplies p in fp32.
//   * fp32 inputs, D = 256, or 16-bit D = 32 (`flash_prefill_kernel`): 256
//     threads on the CUDA cores, the q, K and V tiles staged as fp32; thread
//     (tx, ty) of a 16 x 16 grid owns query rows ty + 16a (a < 4), computes
//     their scores against keys tx + 16c (c < 4) over float4 reads, reduces
//     each row's max and sum over the 16 threads sharing ty, and passes the
//     probabilities through shared memory to the P.V product, where it owns
//     the same rows' outputs in float4 column groups tx + 16g. fp32 stays off
//     the tensor cores: TF32 would keep 10 bits of each input.
//
// Left for later PRs: a producer warp with setmaxnreg and ping-pong
// scheduling of the two warpgroups (issuing tile j + 1's Q.K^T right behind
// tile j's P.V without it measured slower), persistent CTAs, D = 256 on the
// tensor cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr int kPad = 4;  // floats of padding per staged row
constexpr int kLp = kBK + kPad;  // row stride of the probability tile

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

// Reductions over the 16 lanes of a half warp (the threads sharing ty).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage 64 rows of D elements (row r at src + r * row_stride; rows at or past
// n_valid are zero and never read) into dst as fp32, row stride D + kPad.
// The wrapper checks that src and the row stride are 16-byte aligned.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           long long row_stride, int n_valid) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kVpr = D / kVec;        // vectors per row
  constexpr int kLd = D + kPad;
  for (int c = threadIdx.x; c < 64 * kVpr; c += kThreads) {
    const int r = c / kVpr;
    const int e0 = (c - r * kVpr) * kVec;
    float4* d = reinterpret_cast<float4*>(dst + r * kLd + e0);
    if (r < n_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * row_stride + e0);
      const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        d[e / 4] = make_float4(to_float(el[e]), to_float(el[e + 1]), to_float(el[e + 2]),
                               to_float(el[e + 3]));
    } else {
#pragma unroll
      for (int e = 0; e < kVec; e += 4) d[e / 4] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ bool live(int i, int j, int S, int window) {
  return j <= i && j < S && (window <= 0 || j > i - window);
}

__device__ __forceinline__ float component(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

size_t smem_bytes(int D) {
  return ((size_t)(kBQ + 2 * kBK) * (D + kPad) + (size_t)kBQ * kLp) * sizeof(float);
}

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int KV, int S, Strides st, float scale, int window) {
  constexpr int kLd = D + kPad;
  constexpr int kGroups = D / 4;                 // float4 columns of a row
  constexpr int kGpt = (kGroups + 15) / 16;      // float4 columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // (kBQ, kLd)
  float* k_s = q_s + kBQ * kLd;    // (kBK, kLd)
  float* v_s = k_s + kBK * kLd;    // (kBK, kLd)
  float* p_s = v_s + kBK * kLd;    // (kBQ, kLp)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  stage_rows<T, D>(q_s, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, min(kBQ, S - q0));

  float m[4], l[4], acc[4][kGpt][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int g = 0; g < kGpt; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][g][e] = 0.f;
  }

  // live key tiles: from the one holding q0 - window + 1 (0 without a window)
  // to the one holding the tile's last row (the diagonal)
  const int last = min(S - 1, q0 + kBQ - 1);
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;
  for (int k0 = first / kBK * kBK; k0 <= last; k0 += kBK) {
    const int n = min(kBK, S - k0);
    __syncthreads();  // the previous tile's readers are done with k_s, v_s, p_s
    stage_rows<T, D>(k_s, kp + k0 * st.ks, st.ks, n);
    stage_rows<T, D>(v_s, vp + k0 * st.vs, st.vs, n);
    __syncthreads();

    // s[a][c] = q[ty + 16a] . k[tx + 16c]
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * a) * kLd + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ka[c] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * c) * kLd + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = s[a][c];
          t = fmaf(qa[a].x, ka[c].x, t);
          t = fmaf(qa[a].y, ka[c].y, t);
          t = fmaf(qa[a].z, ka[c].z, t);
          t = fmaf(qa[a].w, ka[c].w, t);
          s[a][c] = t;
        }
    }

    // online softmax per row: masked scores are kNegInf and their p is 0
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = live(i, k0 + tx + 16 * c, S, window) ? s[a][c] * scale : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = live(i, k0 + tx + 16 * c, S, window) ? expf(s[a][c] - m_new) : 0.f;
        p_s[(ty + 16 * a) * kLp + tx + 16 * c] = p;
        sum += p;
      }
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + half_warp_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int g = 0; g < kGpt; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][g][e] *= alpha;
    }
    __syncthreads();

    // acc[a] += sum_j p[ty + 16a, j] * v[j, 4(tx + 16g) ...]; keys past n have
    // p = 0 and zero V rows
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * a) * kLp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < kGpt; ++g) {
          const int col = 4 * (tx + 16 * g);
          if (col < D) {
            const float4 vv = *reinterpret_cast<const float4*>(v_s + (j + jj) * kLd + col);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const float p = component(pa[a], jj);
              acc[a][g][0] = fmaf(p, vv.x, acc[a][g][0]);
              acc[a][g][1] = fmaf(p, vv.y, acc[a][g][1]);
              acc[a][g][2] = fmaf(p, vv.z, acc[a][g][2]);
              acc[a][g][3] = fmaf(p, vv.w, acc[a][g][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= S) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    T* orow = o + b * st.ob + h * st.oh + i * st.os;
#pragma unroll
    for (int g = 0; g < kGpt; ++g) {
      const int col = 4 * (tx + 16 * g);
      if (col < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) orow[col + e] = from_float<T>(acc[a][g][e] / denom);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit inputs, D in {64, 128}: the same function on Hopper's tensor cores.
// A CTA of two warpgroups owns 128 query rows of one (batch row, head), 64
// per warpgroup. Thread 0 loads Q once and every 128-key K/V tile by TMA into
// 128-byte-swizzled shared memory: Q (128 x D), and a 2-slot ring of K and V
// tiles (128 x D each); the load of tile j + 1 is issued before the
// warpgroups start on tile j, into the slot both released after tile j - 1
// ("empty" mbarriers), and lands on a "full" mbarrier by transaction count.
// Rows past S and the ragged last tile are zero-filled by TMA. Each
// warpgroup computes S = Q.K^T with wgmma m64n128k16 (Q and K from shared
// memory, both K-major), runs the online softmax in the accumulator
// registers (a row spans the 4 threads of a quad; the mask is evaluated only
// on tiles that cross the diagonal, the window's edge or S), converts P in
// place to the 16-bit A-fragment layout (bf16 as head and remainder) and
// accumulates P.V with wgmma m64nDk16, A from registers, V from shared
// memory as the MN-major B operand.
constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kTQ = 128;         // query rows per CTA
constexpr int kTK = 128;         // keys per tile
constexpr int kPanel = 64;       // 16-bit columns of one 128-byte swizzle panel
constexpr int kRowBytes = 128;   // bytes of one panel row
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte-aligned base: Q, then K slots 0 and 1,
// then V slots 0 and 1, each as D / 64 panels of (rows, 64) elements, then
// the mbarriers q_full, full[2], empty[2].
template <int D>
struct WgSmem {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQPanel = kTQ * kRowBytes;
  static constexpr int kKPanel = kTK * kRowBytes;
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kTileBytes = kPanels * kKPanel;  // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + 2 * kTileBytes;
  static constexpr int kBar = kV + 2 * kTileBytes;
  static constexpr int kBytes = kBar + 5 * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Block until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: the (64, rows) box at element coordinates (c0, c1, c2, c3) of `map`
// into shared memory at `dst`, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address `addr`:
// `lbo` and `sbo` in bytes (K-major: sbo = 8 rows; MN-major: lbo = the next
// 64 columns' panel, sbo = 8 rows of K).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_R32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
// d (64 x 128, fp32) (+)= A (64 x 16, shared) . B (16 x 128, shared), both
// K-major; scale_d = 0 overwrites d
#define WG_SS_N128(TY)                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " WG_R64 \
               ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                   \
               : WG_D64                                                            \
               : "l"(a), "l"(b), "r"(scale_d))
// d (64 x N, fp32) += A (64 x 16, registers) . B (16 x N, shared, MN-major)
#define WG_RS_N128(TY)                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " WG_R64 \
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                     \
               : WG_D64                                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
#define WG_RS_N64(TY)                                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_R32  \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                     \
               : WG_D32                                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    WG_SS_N128("bf16");
  else
    WG_SS_N128("f16");
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      WG_RS_N128("bf16");
    else
      WG_RS_N128("f16");
  } else {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      WG_RS_N64("bf16");
    else
      WG_RS_N64("f16");
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  } else {
    const __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  }
}

// Thread 0's load of K/V tile `k0` of (batch row b, KV head kvh) into ring
// slot `slot`: D / 64 panels of K and of V, completing on full[slot].
template <int D>
__device__ __forceinline__ void load_kv_tile(uint32_t base, int slot, int k0, int kvh, int b,
                                             const CUtensorMap* tk, const CUtensorMap* tv) {
  using L = WgSmem<D>;
  const uint32_t full = base + L::kBar + 8 + 8 * slot;
  mbar_expect_tx(full, 2 * L::kTileBytes);
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p) {
    tma_load(base + L::kK + slot * L::kTileBytes + p * L::kKPanel, tk, full, p * kPanel, k0,
             kvh, b);
    tma_load(base + L::kV + slot * L::kTileBytes + p * L::kKPanel, tv, full, p * kPanel, k0,
             kvh, b);
  }
}

// the remainder p - float(pack2(p)) of a packed pair, packed in turn
template <typename T>
__device__ __forceinline__ uint32_t pack2_rest(uint32_t head, float lo, float hi) {
  float2 back;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    back = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&head));
  else
    back = __half22float2(*reinterpret_cast<const __half2*>(&head));
  return pack2<T>(lo - back.x, hi - back.y);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_prefill_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, T* __restrict__ o, int H, int KV, int S,
    long long ob, long long oh, long long os, float scale_log2, int window) {
  using L = WgSmem<D>;
  constexpr int kAcc = D / 2;  // output floats per thread: m64nDk16
  // bf16 P keeps 8 bits: split it into a head and a remainder, two P.V
  // products, as a single rounding measured 0.031 against the plain version
  // (over the 3e-2 gate); f16 P keeps 11 bits and is rounded once
  constexpr bool kSplitP = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;    // + 8 * slot (load_kv_tile)
  const uint32_t bar_empty = bar_q + 24;  // + 8 * slot

  // blocks launch in x-fastest order and the row tile is z, reversed: every
  // (head, batch row) of the heaviest row tile goes first, the light ones fill
  // in behind, so the causal tail does not run last
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;

  // live key tiles: from the one holding q0 - window + 1 (0 without a window)
  // to the one holding the CTA's last row
  const int last = min(S - 1, q0 + kTQ - 1);
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = first / kTK;
  const int n_tiles = last / kTK - t0 + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kWgThreads / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load(base + p * L::kQPanel, &tq, bar_q, p * kPanel, q0, h, b);
    load_kv_tile<D>(base, 0, t0 * kTK, kvh, b, &tk, &tv);
  }

  // this thread's rows: row0 and row0 + 8; columns 8 c + 2 (lane % 4) (+1)
  const int row_lo = q0 + wg * 64;
  const int row0 = row_lo + warp * 16 + lane / 4;
  const uint32_t q_base = base + wg * 64 * kRowBytes;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j & 1;
    if (threadIdx.x == 0 && j + 1 < n_tiles) {
      // slot (j + 1) % 2 last held tile j - 1: both warpgroups must be done
      if (j >= 1) mbar_wait(bar_empty + 8 * (slot ^ 1), ((j - 1) >> 1) & 1);
      load_kv_tile<D>(base, slot ^ 1, (t0 + j + 1) * kTK, kvh, b, &tk, &tv);
    }
    __syncwarp();
    mbar_wait(bar_full + 8 * slot, (j >> 1) & 1);
    const int k0 = (t0 + j) * kTK;
    const uint32_t k_base = base + L::kK + slot * L::kTileBytes;
    const uint32_t v_base = base + L::kV + slot * L::kTileBytes;

    // s = q . k^T over D in 16-wide steps (32 bytes within a panel)
    float s[64];
    wg_fence();
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int kk = 0; kk < kPanel / 16; ++kk)
        wgmma_ss<T>(s, wg_desc(q_base + p * L::kQPanel + kk * 32, 16, 8 * kRowBytes),
                    wg_desc(k_base + p * L::kKPanel + kk * 32, 16, 8 * kRowBytes),
                    p + kk > 0);
    wg_commit_wait();
    wg_fence_regs(s);

    // online softmax in the log2 domain; s[e] holds row row0 + 8 ((e / 2) % 2),
    // key k0 + 8 (e / 4) + 2 (lane % 4) + e % 2. Only a tile that crosses the
    // diagonal, the window's edge or S evaluates the mask.
    const bool masked = k0 + kTK - 1 > row_lo || k0 + kTK > S ||
                        (window > 0 && k0 <= row_lo + 63 - window);
    float mx[2] = {m[0], m[1]};
    if (masked) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int i = row0 + 8 * ((e >> 1) & 1);
        const int jj = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        s[e] = live(i, jj, S, window) ? s[e] * scale_log2 : kNegInf;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        s[e] *= scale_log2;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];  // this thread's share of the row sum; reduced at the end
    }
    if (masked) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int i = row0 + 8 * ((e >> 1) & 1);
        const int jj = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        s[e] = live(i, jj, S, window) ? exp2f(s[e] - m[(e >> 1) & 1]) : 0.f;
        l[(e >> 1) & 1] += s[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        s[e] = exp2f(s[e] - m[(e >> 1) & 1]);
        l[(e >> 1) & 1] += s[e];
      }
    }
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] *= alpha[(e >> 1) & 1];

    // P as the A fragments of 8 16-key steps (step kk holds the score
    // columns of key groups 2 kk and 2 kk + 1): rounded to T, and for bf16
    // the remainder as a second set
    uint32_t pa[8][4], pr[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float lo = s[8 * kk + 2 * f], hi = s[8 * kk + 2 * f + 1];
        pa[kk][f] = pack2<T>(lo, hi);
        if constexpr (kSplitP) pr[kk][f] = pack2_rest<T>(pa[kk][f], lo, hi);
      }

    // acc += P . V: V's keys 16 kk..16 kk + 15 start 16 rows further down
    wg_fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t vd = wg_desc(v_base + kk * 16 * kRowBytes, L::kKPanel, 8 * kRowBytes);
      wgmma_rs<T, D>(acc, pa[kk], vd);
      if constexpr (kSplitP) wgmma_rs<T, D>(acc, pr[kk], vd);
    }
    wg_commit_wait();
    wg_fence_regs(acc);
    if (lane == 0) mbar_arrive(bar_empty + 8 * slot);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  T* orow = o + b * ob + h * oh + 2 * (lane & 3);
#pragma unroll
  for (int e = 0; e < kAcc; e += 2) {
    const int i = row0 + 8 * ((e >> 1) & 1);
    if (i < S)
      *reinterpret_cast<uint32_t*>(orow + i * os + 8 * (e >> 2)) =
          pack2<T>(acc[e] * l[(e >> 1) & 1], acc[e + 1] * l[(e >> 1) & 1]);
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime, so that
// the library links against the CUDA runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
constexpr int kNoEncodeEntryPoint = -100000;  // returned when libcuda lacks it

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (D, S, heads, B) view of a (B, heads, S, D) tensor given by its element
// strides, loaded in (64, rows) boxes with 128-byte swizzle; reads past S
// (or any edge) fill zeros. Returns 0 or -CUresult.
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B,
           long long s_head, long long s_row, long long s_batch, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncodeEntryPoint;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * sizeof(T), (cuuint64_t)s_head * sizeof(T),
                                 (cuuint64_t)s_batch * sizeof(T)};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

template <typename T, int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                 int S, const Strides& st, float scale, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode<T>(&tq, q, D, S, H, B, st.qh, st.qs, st.qb, kTQ);
  if (err == 0) err = encode<T>(&tk, k, D, S, KV, B, st.kh, st.ks, st.kb, kTK);
  if (err == 0) err = encode<T>(&tv, v, D, S, KV, B, st.vh, st.vs, st.vb, kTK);
  if (err != 0) return err;
  const size_t smem = WgSmem<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (S + kTQ - 1) / kTQ);
  flash_prefill_wgmma_kernel<T, D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), H, KV, S, st.ob, st.oh, st.os, scale * kLog2e, window);
  return (int)cudaGetLastError();
}

// route 1: the wgmma kernel (16-bit, D 64 or 128); route 0: the CUDA-core
// kernel (fp32, D = 256, 16-bit D = 32). The wrapper's kernel_route chooses;
// any other pairing is refused.
template <typename T, int D>
int launch_d(int route, const void* q, const void* k, const void* v, void* o, int B, int H,
             int KV, int S, const Strides& st, float scale, int window, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2 && (D == 64 || D == 128)) {
    if (route != 1) return (int)cudaErrorInvalidValue;
    return launch_wgmma<T, D>(q, k, v, o, B, H, KV, S, st, scale, window, stream);
  } else {
    if (route != 0) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(D);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + kBQ - 1) / kBQ, H, B);
    flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, KV, S, st, scale, window);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch(int route, const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int S, int D, const Strides& st, float scale, int window,
           cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(route, q, k, v, o, B, H, KV, S, st, scale, window, stream);
    case 64:
      return launch_d<T, 64>(route, q, k, v, o, B, H, KV, S, st, scale, window, stream);
    case 128:
      return launch_d<T, 128>(route, q, k, v, o, B, H, KV, S, st, scale, window, stream);
    case 256:
      return launch_d<T, 256>(route, q, k, v, o, B, H, KV, S, st, scale, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. route: 0 = CUDA cores,
// 1 = wgmma (16-bit, D 64 or 128). strides: 12 element strides, (batch, head,
// position) of q, k, v and o in that order, read on the host. Returns 0, a
// CUDA error of the launch (> 0) or -CUresult of a failed tensor-map encode;
// the kernel runs asynchronously on `stream`.
int flash_prefill_launch(int dtype, int route, const void* q, const void* k, const void* v,
                         void* o, int B, int H, int KV, int S, int D,
                         const long long* strides, float scale, int window, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(route, q, k, v, o, B, H, KV, S, D, st, scale, window, s);
    case 1:
      return launch<__nv_bfloat16>(route, q, k, v, o, B, H, KV, S, D, st, scale, window, s);
    case 2:
      return launch<__half>(route, q, k, v, o, B, H, KV, S, D, st, scale, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of a route's CTA at head_dim D, in bytes.
int flash_prefill_smem_bytes(int route, int D) {
  if (route == 1) return D == 64 ? WgSmem<64>::kBytes : WgSmem<128>::kBytes;
  return (int)smem_bytes(D);
}

const char* flash_prefill_error_string(int err) {
  static thread_local char msg[96];
  if (err == kNoEncodeEntryPoint) return "libcuda has no cuTensorMapEncodeTiled";
  if (err < 0) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d", -err);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
