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
// the transpose copies the TPU layout would need.
//
// Design (simple and right first). Both paths: one CTA per (64 query rows,
// head, batch row); the TPU grid's sequential key axis becomes a loop inside
// the CTA over 64-key tiles, and only over the tiles that hold a live (i, j)
// pair: tiles above the diagonal and tiles wholly before the window are never
// loaded, the TPU kernel's `pl.when(live)`; any S: the last query tile and
// the last key tile are masked, rows past S are zero in shared memory and
// never read from device memory (the TPU's S % block rule is a VMEM tiling
// rule, not part of the function).
//   * bf16 / f16 inputs, D <= 128 (`flash_prefill_mma_kernel`): 4 warps on
//     the tensor cores, mma.sync m16n8k16 with fp32 accumulation; each warp
//     owns 16 query rows, keeps its scores and the online softmax in
//     registers and feeds the probabilities back as the A operand of P.V,
//     split into a 16-bit head and remainder so p keeps ~16 bits (the TPU
//     kernel multiplies p in fp32);
//   * fp32 inputs, or D = 256 (`flash_prefill_kernel`): 256 threads on the
//     CUDA cores, the q, K and V tiles staged as fp32; thread (tx, ty) of a
//     16 x 16 grid owns query rows ty + 16a (a < 4), computes their scores
//     against keys tx + 16c (c < 4) over float4 reads, reduces each row's
//     max and sum over the 16 threads sharing ty, and passes the
//     probabilities through shared memory to the P.V product, where it owns
//     the same rows' outputs in float4 column groups tx + 16g. fp32 stays off
//     the tensor cores: TF32 would keep 10 bits of each input.
//
// Bound on this card: operations. A (S, S) causal score matrix per head:
// ~4 * B * H * D * S^2 / 2 flops against B * (H + 2 KV) * S * D elements
// read once; 989 TFLOP/s on the bf16 tensor cores, 67 TFLOP/s in fp32 on the
// CUDA cores.
//
// Left for later PRs: wgmma, TMA loads of K and V double-buffered behind the
// math, a CTA per (row tile, KV head) sharing K/V reads across the G query
// heads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// 16-bit inputs, D <= 128: the same function on the tensor cores
// (mma.sync m16n8k16, fp32 accumulation). A CTA of 4 warps owns the same 64
// query rows, 16 per warp; K and V tiles are staged in shared memory as they
// are (16-bit, rows padded by 8 elements so the fragment reads of a warp hit
// 32 distinct banks). Each warp keeps its q rows as A fragments and its
// 16 x 64 scores in the accumulator fragments, runs the online softmax there
// (a row spans the 4 threads of a quad), and feeds the probabilities back as
// the A operand of P.V. P is split into a 16-bit head and a 16-bit remainder,
// two products instead of one, so the product keeps ~16 bits of each p where
// a single rounding keeps 8: the TPU kernel multiplies p in fp32.
constexpr int kMmaThreads = 128;
constexpr int kMmaPad = 8;  // 16-bit elements of padding per staged row

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Copy 64 rows of D 16-bit elements (rows at or past n_valid zero) into dst,
// row stride D + kMmaPad.
template <int D>
__device__ __forceinline__ void stage_rows_16(uint16_t* dst, const uint16_t* __restrict__ src,
                                              long long row_stride, int n_valid) {
  constexpr int kVpr = D / 8;  // 16-byte vectors per row
  for (int c = threadIdx.x; c < 64 * kVpr; c += kMmaThreads) {
    const int r = c / kVpr;
    const int e0 = (c - r * kVpr) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) x = *reinterpret_cast<const uint4*>(src + r * row_stride + e0);
    *reinterpret_cast<uint4*>(dst + r * (D + kMmaPad) + e0) = x;
  }
}

size_t mma_smem_bytes(int D) { return (size_t)(kBQ + 2 * kBK) * (D + kMmaPad) * 2; }

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_prefill_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int KV, int S, Strides st, float scale, int window) {
  constexpr int kLd = D + kMmaPad;
  constexpr int kKs = D / 16;  // 16-wide steps of q . k
  constexpr int kDt = D / 8;   // 8-wide column tiles of the output
  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* q_s = smem16;            // (kBQ, kLd)
  uint16_t* k_s = q_s + kBQ * kLd;   // (kBK, kLd)
  uint16_t* v_s = k_s + kBK * kLd;   // (kBK, kLd)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = lane / 4;  // fragment row (and row + 8)
  const int tig = lane % 4;    // fragment column pair

  stage_rows_16<D>(q_s, reinterpret_cast<const uint16_t*>(q + b * st.qb + h * st.qh +
                                                          q0 * st.qs),
                   st.qs, min(kBQ, S - q0));
  __syncthreads();
  // this warp's 16 rows of q as A fragments: rows r and r + 8, columns
  // 16 ks + 2 tig (+1) and + 8
  const int r = warp * 16 + group;
  uint32_t qa[kKs][4];
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
    const uint16_t* base = q_s + ks * 16 + tig * 2;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(base + r * kLd);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(base + (r + 8) * kLd);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(base + r * kLd + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(base + (r + 8) * kLd + 8);
  }
  const int qi[2] = {q0 + r, q0 + r + 8};  // this thread's two query rows
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kDt][4];
#pragma unroll
  for (int dt = 0; dt < kDt; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int last = min(S - 1, q0 + kBQ - 1);
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  const uint16_t* kp = reinterpret_cast<const uint16_t*>(k + b * st.kb + kvh * st.kh);
  const uint16_t* vp = reinterpret_cast<const uint16_t*>(v + b * st.vb + kvh * st.vh);
  for (int k0 = first / kBK * kBK; k0 <= last; k0 += kBK) {
    const int n = min(kBK, S - k0);
    __syncthreads();  // every warp is done with the previous tile
    stage_rows_16<D>(k_s, kp + k0 * st.ks, st.ks, n);
    stage_rows_16<D>(v_s, vp + k0 * st.vs, st.vs, n);
    __syncthreads();

    // s[nt][e]: row qi[e / 2], key k0 + 8 nt + 2 tig + e % 2
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const uint16_t* kr = k_s + (nt * 8 + group) * kLd + tig * 2;
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks)
        Mma<T>::mma(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr + ks * 16),
                    *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8));
    }

    // online softmax per row, over the quad that holds it
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = live(qi[e / 2], k0 + nt * 8 + tig * 2 + e % 2, S, window);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      m_new[rr] = fmaxf(m[rr], mx[rr]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = live(qi[e / 2], k0 + nt * 8 + tig * 2 + e % 2, S, window);
        s[nt][e] = ok ? expf(s[nt][e] - m_new[e / 2]) : 0.f;
        sum[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
      const float alpha = expf(m[rr] - m_new[rr]);
      l[rr] = l[rr] * alpha + sum[rr];
      m[rr] = m_new[rr];
#pragma unroll
      for (int dt = 0; dt < kDt; ++dt) {
        acc[dt][2 * rr] *= alpha;
        acc[dt][2 * rr + 1] *= alpha;
      }
    }

    // acc += P.V over 16-key steps: the score fragments of key tiles 2kk and
    // 2kk + 1 are the A fragment of step kk; V's B fragment holds keys
    // 2 tig (+1) and + 8 of column 8 dt + group
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float* src = s[2 * kk + f / 2] + 2 * (f % 2);
        ph[f] = Mma<T>::pack(src[0], src[1]);
        const float2 back = Mma<T>::unpack(ph[f]);
        pl[f] = Mma<T>::pack(src[0] - back.x, src[1] - back.y);
      }
      const uint16_t* vr = v_s + (kk * 16 + tig * 2) * kLd + group;
#pragma unroll
      for (int dt = 0; dt < kDt; ++dt) {
        const uint16_t* vc = vr + dt * 8;
        const uint32_t b0 = (uint32_t)vc[0] | ((uint32_t)vc[kLd] << 16);
        const uint32_t b1 = (uint32_t)vc[8 * kLd] | ((uint32_t)vc[9 * kLd] << 16);
        Mma<T>::mma(acc[dt], ph, b0, b1);
        Mma<T>::mma(acc[dt], pl, b0, b1);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qi[rr] >= S) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* orow = o + b * st.ob + h * st.oh + qi[rr] * st.os + tig * 2;
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      orow[dt * 8] = from_float<T>(acc[dt][2 * rr] / denom);
      orow[dt * 8 + 1] = from_float<T>(acc[dt][2 * rr + 1] / denom);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
             int S, const Strides& st, float scale, int window, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  cudaError_t err;
  if constexpr (sizeof(T) == 2 && D <= 128) {  // the tensor cores
    const size_t smem = mma_smem_bytes(D);
    err = cudaFuncSetAttribute(flash_prefill_mma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_prefill_mma_kernel<T, D><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, KV, S, st, scale, window);
  } else {  // fp32 inputs, or D = 256: the CUDA cores
    const size_t smem = smem_bytes(D);
    err = cudaFuncSetAttribute(flash_prefill_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, KV, S, st, scale, window);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
           int S, int D, const Strides& st, float scale, int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, o, B, H, KV, S, st, scale, window, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, o, B, H, KV, S, st, scale, window, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, B, H, KV, S, st, scale, window, stream);
    case 256:
      return launch_d<T, 256>(q, k, v, o, B, H, KV, S, st, scale, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 12 element strides,
// (batch, head, position) of q, k, v and o in that order, read on the host.
// Returns the CUDA error of the launch (0 = cudaSuccess); the kernel runs
// asynchronously on `stream`.
int flash_prefill_launch(int dtype, const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KV, int S, int D, const long long* strides,
                         float scale, int window, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, B, H, KV, S, D, st, scale, window, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, D, st, scale, window, s);
    case 2:
      return launch<__half>(q, k, v, o, B, H, KV, S, D, st, scale, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
