// Paged attention over KIVI-quantized pages for NVIDIA Hopper (sm_90a), plain
// C interface: decode and chunked extend.
//
// Replaces repro/kernels/paged_attention/paged_attention.py::
// paged_attention_quant (the Pallas TPU kernel, body `_quant_kernel`). Same
// function: each query row attends over a paged KV pool whose packed pages
// hold uint8 codes with f16 scale/zero planes (keys grouped per channel:
// planes (1, D) per page; values per token: planes (P, 1) per page), plus a
// full-precision tail that holds the positions from tail_start[b] up (the
// still-filling page and the step's own K/V). Online softmax in fp32 over
// both, in one running (m, l, acc).
//   q (R, KV, G, D); k_codes / v_codes (KV, NB, P, D) uint8; k_scale / k_zero
//   (KV, NB, 1, D) f16; v_scale / v_zero (KV, NB, P, 1) f16; k_tail / v_tail
//   (B, T, KV, D) in q's dtype; block_tables (B, NP), lengths (R,) and
//   tail_start (B,) int32 -> out (R, KV, G, D) in q's dtype, R = B * rows_per_seq.
// Row r belongs to sequence r / rows_per_seq and takes its table, tail_start
// and tail; lengths is per row. rows_per_seq = C is chunked extend (row
// b*C + j is query j of sequence b, with length lengths_b + j + 1): q is then
// (B, C, KV, G, D) in memory. rows_per_seq = 1 is plain decode.
//
// Validity, as in the TPU kernel and kernels/paged_attention/ref.py: page slot
// `pos` is valid where pos < tail_start[b]; tail slot i (position
// tail_start[b] + i) where that is < lengths[r]. A page value is
// codes * scale + zero in fp32 (two IEEE roundings; the CUDA-core kernel
// uses the _rn intrinsics, never contracted), then rounded to the cache's
// logical dtype (`deq`): greedy parity depends on that rounding. Tail values
// are rounded through `deq` too, as the plain version does (a no-op when the
// tail is in the cache dtype, as on the serving path).
//
// Bound on this card: HBM bytes. A (sequence, KV head) reads 2 * D bytes of
// codes per page position plus the planes (4 * D bytes of K planes per page,
// 4 bytes of V planes per position) and its tail, against ~4 * C * G flops
// per K/V element pair and a few more to dequantize it.
//
// Two kernels, chosen by the wrapper's kernel_route (checked here):
//   * q bf16 / f16 with deq == q's dtype (`paged_attention_quant_mma_kernel`):
//     a dequantized page value rounded to deq is then exactly a tensor-core
//     operand, so the tensor cores add no rounding the plain version lacks.
//     The design of paged_attention.cu's mma kernel, with a dequant stage: a
//     CTA of 4 warps owns one (sequence b, KV head, 16-row tile); its rows are
//     the C * G pairs (c, g), c-major, so decode's G heads share a tile and a
//     C = 64 chunk at G = 1 takes 4 tiles, each reading the pages once (not
//     once per query row, as the CUDA-core kernel's fold does). The
//     positions form one stream, walked as 64-position page tiles over
//     [0, tail_start) and then 32-slot tail tiles up to the tile's longest
//     row; no tile mixes the two. A 3-stage cp.async ring holds the RAW
//     bytes of a page tile (K and V codes, the tile's K planes, its V
//     planes: a quarter of the bytes of 16-bit K/V in flight), each warp
//     reading the tile's block-table entries a tile ahead, one per lane,
//     and handing them out by shuffle. Each warp then dequantizes the 16
//     keys its own math reads into one XOR-swizzled 16-bit K tile and one V
//     tile (__fmaf_rn(code, scale, zero), rounded to deq: code * scale is
//     exact in fp32, so this is bit for bit the plain version's value,
//     product and sum each rounded); a __syncwarp, not a CTA barrier, orders
//     the two, so a tile costs one barrier. A tail tile is already in deq's
//     dtype: its rows go by cp.async straight into the ring slot, swizzled,
//     and the math reads them there. S = Q.K^T and O += P.V on mma.sync
//     m16n8k16 (fp32 accumulate), Q's fragments held in registers at
//     D <= 128, K through ldmatrix, V through ldmatrix.trans, each warp a
//     16-key slice of the tile; bf16 P split into a head and a remainder
//     (one rounding failed a 3e-2 gate in flash_prefill), f16 P rounded
//     once; running max and sum in registers. Split-K over the grid's y
//     axis (splits planned on the host from shapes and occupancy, never
//     from lengths), fp32 partials (m, l, acc) merged by
//     `paged_attention_quant_merge_kernel`. Dead data never reaches the
//     math: page slots at or past tail_start, their V planes and the K
//     planes of pages wholly past it are zero-filled by cp.async (src-size
//     0, never read), so they dequantize to 0; so are tail slots past the
//     tile's longest row; positions between a row's end and that are masked
//     to -1e30 with p = 0; a row with nothing valid writes 0, a split that
//     holds nothing m = -1e30, l = 0.
//     On an H100 (chip_smoke.py phase 4) it runs 3.8x the CUDA-core kernel
//     at olmo-1b's decode shape and 13x its fold at a ragged extend layer,
//     at ~33% and ~8% of the bytes bound: a tile's dequant and math issue
//     more instructions than its bytes take to arrive.
//   * everything else: fp32 q, or a deq that differs from q's dtype (a
//     dequantized value would be rounded again on its way into the tensor
//     cores; TF32 would break the 1e-5 fp32 gates): the CUDA-core kernel
//     (`paged_attention_quant_kernel`), one CTA per (row, kv), below.
//
// The CUDA-core kernel (simple and right first), the v3 structure of
// paged_attention.cu's fp32 kernel:
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
// Left for later PRs: fewer instructions per dequantized value (the pack
// into 16 bits, the per-value scale and zero conversions); a split plan that
// sees the lengths (a short extend row's CTAs idle beside a long one's); the
// merge folded into the last CTA of each row tile.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// 16-bit q with deq == q's dtype on the tensor cores (mma.sync), decode and
// chunked extend
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTK = 64;           // positions per page tile
constexpr int kTT = 32;           // slots per tail tile
constexpr int kStages = 3;        // tiles in the shared-memory ring
constexpr int kMergeSplits = 64;  // split weights the merge stages at a time
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 16;                  // query rows per CTA: one mma tile
constexpr int kKW = kTK / kMmaWarps;       // keys per warp per tile
constexpr int kTilePages = kTK / 4;        // pages per page tile at most (P >= 4)

// Shared memory: Q (kRows x D, 16-bit, swizzled), the dequantized K and V
// tiles (kTK x D each, 16-bit, swizzled), then kStages ring stages. A stage
// holds a page tile's raw bytes: K codes (kTK x D, plain rows), V codes, the
// K scale and zero rows of its kTK / P pages (f16, room for P = 4), the V
// scale and zero of its kTK slots (f16); or a tail tile's 16-bit K and V
// (kTT x D each, swizzled) in the places of the K and V codes. After the
// loop the same bytes hold the epilogue's fp32 partials, one (kRows x D + 4)
// block per warp plus m and l.
template <int D>
struct QMmaCfg {
  static constexpr int kCodes = kTK * D;
  static constexpr int kKPlane = kTilePages * D * 2;
  static constexpr int kOffVC = kCodes;
  static constexpr int kOffKS = 2 * kCodes;
  static constexpr int kOffKZ = kOffKS + kKPlane;
  static constexpr int kOffVS = kOffKZ + kKPlane;
  static constexpr int kOffVZ = kOffVS + kTK * 2;
  static constexpr int kStage = kOffVZ + kTK * 2;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kTK * D * 2;
  static constexpr int kOffDK = kQBytes;
  static constexpr int kOffDV = kOffDK + kTileBytes;
  static constexpr int kOffRing = kOffDV + kTileBytes;
  static constexpr int kRing = kOffRing + kStages * kStage;
  static constexpr int kAccStride = D + 4;
  static constexpr int kEpi = (kMmaWarps * kRows * (kAccStride + 2)) * 4;
  static constexpr int kBytes = kRing > kEpi ? kRing : kEpi;
  static_assert(kKW == 16, "a warp's key slice is one k16 step of P.V");
  static_assert(kTT * D * 2 <= kCodes, "a tail tile's K (V) fits the K (V) codes' place");
  static_assert(kStage % 16 == 0 && kOffVS % 16 == 0, "16-byte aligned stage parts");
  static_assert(kBytes <= 232448, "more than a CTA's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk `ch` of row `row` in a swizzled [rows][D]
// 16-bit tile: the chunk index is XORed with the row, so the 8 rows one
// ldmatrix reads at one logical chunk land in 8 distinct bank groups. With
// D = 32 a row is 64 bytes (4 chunks) and two rows share one 128-byte line.
template <int D>
__device__ __forceinline__ int swz(int row, int ch) {
  constexpr int kChunks = D / 8;
  if constexpr (kChunks >= 8)
    return row * D + ((ch ^ (row & 7)) << 3);
  else
    return row * D + ((ch ^ ((row >> 1) & 3)) << 3);
}

// global -> shared copies of 16 (or 8) bytes; src_bytes < that reads only
// src_bytes and zero-fills the rest (0: reads nothing). No "memory" clobber,
// so that the table reads feeding the addresses can be hoisted and overlap;
// cp.async.wait_group and __syncthreads order the shared-memory reads.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, row) . b (16 x 8, col)
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest even into a packed 16-bit pair, lo first
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

// Where row r = c * G + g of (b, kv) lives in q and out: (B, C, KV, G, D).
__device__ __forceinline__ size_t row_offset(int b, int kv, int r, int KV, int G, int C,
                                             int D) {
  const int c = r / G;
  return ((((size_t)b * C + c) * KV + kv) * G + (r - c * G)) * D;
}

// Byte `e` (0..3) of `w` as an exact float: 0x4B0000bb is 2^23 + bb.
__device__ __forceinline__ float code_f32(uint32_t w, int e) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | e)), 8388608.f);
}

// code * scale + zero as the plain version computes it, an f32 product and
// then an f32 sum, each rounded: the product of an 8-bit code and an f16
// scale (11 significant bits) is exact in f32, so one fused rounding of the
// sum gives the same bits.
__device__ __forceinline__ float dequant1(float code, float scale, float zero) {
  return __fmaf_rn(code, scale, zero);
}

// 8 codes (one 8-byte word pair) with per-value planes `s`, `z` (8 f16
// each) -> 8 values rounded to T, packed: the plain version's
// (codes.float() * scale.float() + zero.float()).to(deq), bit for bit.
template <typename T>
__device__ __forceinline__ uint4 dequant8(uint2 codes, const uint4& s, const uint4& z) {
  const __half* hs = reinterpret_cast<const __half*>(&s);
  const __half* hz = reinterpret_cast<const __half*>(&z);
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = dequant1(code_f32(e < 4 ? codes.x : codes.y, e & 3), __half2float(hs[e]),
                    __half2float(hz[e]));
  return make_uint4(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]), pack2<T>(v[4], v[5]),
                    pack2<T>(v[6], v[7]));
}

// the same with one scale and zero for all 8 (a value row)
template <typename T>
__device__ __forceinline__ uint4 dequant8(uint2 codes, __half s, __half z) {
  const float fs = __half2float(s), fz = __half2float(z);
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = dequant1(code_f32(e < 4 ? codes.x : codes.y, e & 3), fs, fz);
  return make_uint4(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]), pack2<T>(v[4], v[5]),
                    pack2<T>(v[6], v[7]));
}

// Rows [row0, row0 + kKW) of a page tile's raw bytes in ring stage `st` ->
// the same rows of the swizzled 16-bit K and V tiles `dk`, `dv`: a warp
// dequantizes the 16 keys its own math reads, so a __syncwarp orders the two
// and no CTA barrier is needed. Each lane takes D / 16 8-value chunks of K
// and the same of V. Zero-filled codes and planes give 0.
template <typename T, int D>
__device__ __forceinline__ void dequant_rows(const uint8_t* st, uint8_t* dk, uint8_t* dv,
                                             int p_log2, int row0, int lane) {
  using L = QMmaCfg<D>;
  constexpr int kC8 = D / 8;  // 8-value chunks per row
#pragma unroll
  for (int i = 0; i < kKW * kC8 / 32; ++i) {
    const int idx = lane + i * 32;
    const int row = row0 + idx / kC8, ch = idx % kC8;
    const int plane = ((row >> p_log2) * D + ch * 8) * 2;
    const uint2 kc = *reinterpret_cast<const uint2*>(st + row * D + ch * 8);
    const uint2 vc = *reinterpret_cast<const uint2*>(st + L::kOffVC + row * D + ch * 8);
    const uint4 ks = *reinterpret_cast<const uint4*>(st + L::kOffKS + plane);
    const uint4 kz = *reinterpret_cast<const uint4*>(st + L::kOffKZ + plane);
    const __half vs = reinterpret_cast<const __half*>(st + L::kOffVS)[row];
    const __half vz = reinterpret_cast<const __half*>(st + L::kOffVZ)[row];
    const int off = 2 * swz<D>(row, ch);
    *reinterpret_cast<uint4*>(dk + off) = dequant8<T>(kc, ks, kz);
    *reinterpret_cast<uint4*>(dv + off) = dequant8<T>(vc, vs, vz);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) paged_attention_quant_mma_kernel(
    const T* __restrict__ q, const uint8_t* __restrict__ k_codes,
    const __half* __restrict__ k_scale, const __half* __restrict__ k_zero,
    const uint8_t* __restrict__ v_codes, const __half* __restrict__ v_scale,
    const __half* __restrict__ v_zero, const T* __restrict__ k_tail,
    const T* __restrict__ v_tail, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, const int* __restrict__ tail_start,
    T* __restrict__ out, float* __restrict__ ws, int B, int KV, int G, int C, int NB,
    int p_log2, int NP, int T_len, int row_tiles, int tiles_per_split, float scale_log2) {
  using L = QMmaCfg<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks per 16-bit row
  constexpr bool kSplitP = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t s_q = smem_u32(smem_raw);
  const uint32_t s_ring = s_q + L::kOffRing;

  const int P = 1 << p_log2;
  const int R = C * G;
  const int rt = blockIdx.x % row_tiles;
  const int bkv = blockIdx.x / row_tiles;
  const int kv = bkv % KV;
  const int b = bkv / KV;
  const int split = blockIdx.y;
  const int r0 = rt * kRows;  // the CTA's first row (< R)
  const int ts = tail_start[b];
  const int n_page = max(0, min(ts, NP * P));  // valid page slots, for every row
  // a row's valid tail slots; the tile's longest row sets its tail tiles
  auto n_tail = [&](int c) { return max(0, min(lengths[b * C + c] - ts, T_len)); };
  int tail_max = 0;
  for (int c = r0 / G; c <= (min(R, r0 + kRows) - 1) / G; ++c)
    tail_max = max(tail_max, n_tail(c));
  const int n_pt = (n_page + kTK - 1) / kTK;  // page tiles, then tail tiles
  const int n_tiles = n_pt + (tail_max + kTT - 1) / kTT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int* table = block_tables + (size_t)b * NP;
  const size_t kv_nb = (size_t)kv * NB;

  // Q rows of this CTA (rows past R are zero), in the first copy group
  for (int i = threadIdx.x; i < kRows * kChunks; i += kMmaThreads) {
    const int rl = i / kChunks, ch = i % kChunks;
    const int r = r0 + rl;
    const T* src = r < R ? q + row_offset(b, kv, r, KV, G, C, D) + ch * 8 : q;
    cp_async16(s_q + 2 * swz<D>(rl, ch), src, r < R ? 16 : 0);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // The block-table entry of page (lane % 16) of page tile t, or 0: each warp
  // reads the <= 16 entries of a tile once, a tile ahead of its copies, and
  // hands them to the lanes that need them by shuffle.
  auto page_entry = [&](int t) {
    const int pl = lane & 15;
    const int pos = t * kTK + (pl << p_log2);
    return t < n_pt && pl < (kTK >> p_log2) && pos < n_page ? table[pos >> p_log2] : 0;
  };
  // Tile t into ring stage `stage` (`entry`: page_entry(t)). A page tile
  // (t < n_pt): positions [t * kTK, t * kTK + kTK), each position's row of K
  // and V codes in 16-byte pieces, the K planes of the tile's pages that
  // hold a valid slot, the V planes 4 slots (8 bytes) a copy. A tail tile:
  // slots [u * kTT, u * kTT + kTT) of (b, kv), 16-bit K and V rows into the
  // swizzled layout the math reads. Everything at or past n_page (tail_max
  // for the tail) is zero-filled. Every lane of every warp calls it.
  auto load_tile = [&](int t, int stage, int entry) {
    const uint32_t st = s_ring + stage * L::kStage;
    auto block = [&](int pl) {  // the pool index (kv, table entry) of page pl
      return kv_nb + __shfl_sync(0xffffffffu, entry, pl & 15);
    };
    if (t < n_pt) {
      const int p0 = t * kTK;
      constexpr int kCV = D / 16;                      // 16-byte code pieces per row
      constexpr int kPer = kTK * kCV / kMmaThreads;    // pieces per thread
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = threadIdx.x + i * kMmaThreads;
        const int row = idx / kCV, ch = idx % kCV;
        const size_t blk = block(row >> p_log2);
        const bool live = p0 + row < n_page;
        const size_t off = live ? (blk * P + (row & (P - 1))) * D + ch * 16 : 0;
        const uint32_t so = st + row * D + ch * 16;
        cp_async16(so, k_codes + off, live ? 16 : 0);
        cp_async16(so + L::kOffVC, v_codes + off, live ? 16 : 0);
      }
      const int pages = kTK >> p_log2;
      constexpr int kPlanePasses = (kTilePages * kChunks + kMmaThreads - 1) / kMmaThreads;
#pragma unroll
      for (int i = 0; i < kPlanePasses; ++i) {
        const int idx = threadIdx.x + i * kMmaThreads;
        const int pl = idx / kChunks, ch = idx % kChunks;
        const size_t blk = block(pl);
        if (pl < pages) {
          const bool live = p0 + (pl << p_log2) < n_page;
          const size_t off = live ? blk * D + ch * 8 : 0;
          const uint32_t so = st + L::kOffKS + (pl * D + ch * 8) * 2;
          cp_async16(so, k_scale + off, live ? 16 : 0);
          cp_async16(so + L::kKPlane, k_zero + off, live ? 16 : 0);
        }
      }
      constexpr int kQuads = kTK / 4;  // 4-slot pieces per V plane
      if (warp == 0) {
        const int plane = lane / kQuads;
        const int row = (lane % kQuads) * 4;
        const size_t blk = block(row >> p_log2);
        const int live = max(0, min(n_page - p0 - row, 4));  // a prefix of the 4 slots
        const size_t off = live ? blk * P + (row & (P - 1)) : 0;
        cp_async8(st + L::kOffVS + plane * kTK * 2 + row * 2, (plane ? v_zero : v_scale) + off,
                  2 * live);
      }
    } else {
      const int i0 = (t - n_pt) * kTT;
      constexpr int kPer = kTT * kChunks / kMmaThreads;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = threadIdx.x + i * kMmaThreads;
        const int row = idx / kChunks, ch = idx % kChunks;
        const bool live = i0 + row < tail_max;
        const size_t off = live ? (((size_t)b * T_len + i0 + row) * KV + kv) * D + ch * 8 : 0;
        const uint32_t so = st + 2 * swz<D>(row, ch);
        cp_async16(so, k_tail + off, live ? 16 : 0);
        cp_async16(so + L::kOffVC, v_tail + off, live ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t_begin + s < t_end) load_tile(t_begin + s, s, page_entry(t_begin + s));
    cp_async_commit();
  }
  int entry = page_entry(t_begin + kStages - 1);  // in flight under the first tile

  const int g4 = lane / 4, tig = lane % 4;
  const int mi = lane / 8, mr = lane % 8;  // this lane's ldmatrix row address
  // this thread's two rows r0 + g4 (+ 8): do they exist, their tail slots
  bool live_row[2];
  int tail_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g4 + 8 * h;
    live_row[h] = r < R;
    tail_row[h] = live_row[h] ? n_tail(r / G) : 0;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // Q's A fragments, loaded once where they fit in registers beside the
  // accumulator (D <= 128); at D = 256 each tile reloads them by ldmatrix
  constexpr bool kQRegs = D <= 128;
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  if constexpr (kQRegs) {
    cp_async_wait<kStages - 2>();  // Q came in the first copy group
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      ldsm_x4(s_q + 2 * swz<D>(mr + (mi & 1) * 8, 2 * kd + (mi >> 1)), qf[kd]);
  }
  const int kw = warp * kKW;  // this warp's first key in a tile
  for (int t = t_begin; t < t_end; ++t) {
    const int j = t - t_begin;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t landed
    __syncthreads();               // everyone's; tile t - 1's slot free
    if (t + kStages - 1 < t_end) {
      load_tile(t + kStages - 1, (j + kStages - 1) % kStages, entry);
      entry = page_entry(t + kStages);
    }
    cp_async_commit();
    const int stage = j % kStages;
    uint32_t kst = s_ring + stage * L::kStage, vst = kst + L::kOffVC;
    // valid keys of the tile, a prefix: for the whole tile and per row
    int tile_lim, lim[2];
    if (t < n_pt) {
      tile_lim = n_page - t * kTK;
      lim[0] = live_row[0] ? tile_lim : 0;
      lim[1] = live_row[1] ? tile_lim : 0;
    } else {
      const int i0 = (t - n_pt) * kTT;
      tile_lim = min(tail_max - i0, kTT);  // warps past the tile's kTT slots idle
      lim[0] = tail_row[0] - i0;
      lim[1] = tail_row[1] - i0;
    }
    if (kw >= tile_lim) continue;  // none of the rows sees any of this warp's keys
    if (t < n_pt) {
      dequant_rows<T, D>(smem_raw + L::kOffRing + stage * L::kStage, smem_raw + L::kOffDK,
                         smem_raw + L::kOffDV, p_log2, kw, lane);
      __syncwarp();
      kst = s_q + L::kOffDK;
      vst = s_q + L::kOffDV;
    }

    // s = q . k^T: 16 rows x 16 keys (two 8-key blocks), D in 16-wide steps
    float s[2][4] = {};
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t kb[4];
      ldsm_x4(kst + 2 * swz<D>(kw + mr + (mi >> 1) * 8, 2 * kd + (mi & 1)), kb);
      if constexpr (kQRegs) {
        mma16816<T>(s[0], qf[kd], kb[0], kb[1]);
        mma16816<T>(s[1], qf[kd], kb[2], kb[3]);
      } else {
        uint32_t a[4];
        ldsm_x4(s_q + 2 * swz<D>(mr + (mi & 1) * 8, 2 * kd + (mi >> 1)), a);
        mma16816<T>(s[0], a, kb[0], kb[1]);
        mma16816<T>(s[1], a, kb[2], kb[3]);
      }
    }
    // online softmax in the log2 domain; s[n][e] is row g4 + 8 (e / 2), key
    // kw + 8 n + 2 tig + e % 2; a masked score is -1e30 and its p is 0
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kw + 8 * n + 2 * tig + (e & 1);
        s[n][e] = key < lim[e >> 1] ? s[n][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];  // this thread's share of the row sum, reduced at the end
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kw + 8 * n + 2 * tig + (e & 1);
        s[n][e] = key < lim[e >> 1] ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // acc += P . V over the warp's 16 keys: P's A fragment from the two
    // score blocks; V's B fragments by ldmatrix.trans, two 8-column blocks
    // at a time
    uint32_t pa[4], pr[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float lo = s[f >> 1][2 * (f & 1)], hi = s[f >> 1][2 * (f & 1) + 1];
      pa[f] = pack2<T>(lo, hi);
      if constexpr (kSplitP) pr[f] = pack2_rest<T>(pa[f], lo, hi);
    }
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t vb[4];
      ldsm_x4_trans(vst + 2 * swz<D>(kw + mr + (mi & 1) * 8, n + (mi >> 1)), vb);
      mma16816<T>(acc[n], pa, vb[0], vb[1]);
      mma16816<T>(acc[n + 1], pa, vb[2], vb[3]);
      if constexpr (kSplitP) {
        mma16816<T>(acc[n], pr, vb[0], vb[1]);
        mma16816<T>(acc[n + 1], pr, vb[2], vb[3]);
      }
    }
  }

  // epilogue: each warp's (m, l, acc) into shared memory, then the 4 warps
  // that split a row's keys are merged, and the row is normalized (one
  // split) or written as this split's partial
  cp_async_wait<0>();
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem_raw);
  float* m_s = acc_s + kMmaWarps * kRows * L::kAccStride;
  float* l_s = m_s + kMmaWarps * kRows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const int rw = warp * kRows + g4;  // this thread's first row slot
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(acc_s + rw * L::kAccStride + 8 * n + 2 * tig) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(acc_s + (rw + 8) * L::kAccStride + 8 * n + 2 * tig) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if (tig == 0) {
    m_s[rw] = m[0];
    m_s[rw + 8] = m[1];
    l_s[rw] = l[0];
    l_s[rw + 8] = l[1];
  }
  __syncthreads();
  const size_t nrows = (size_t)B * KV * R;
  for (int i = threadIdx.x; i < kRows * D; i += kMmaThreads) {
    const int rl = i / D, d = i % D;
    const int r = r0 + rl;
    if (r >= R) continue;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) mm = fmaxf(mm, m_s[w * kRows + rl]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float wt = exp2f(m_s[w * kRows + rl] - mm);
      ls += wt * l_s[w * kRows + rl];
      o += wt * acc_s[(w * kRows + rl) * L::kAccStride + d];
    }
    if (gridDim.y == 1) {
      out[row_offset(b, kv, r, KV, G, C, D) + d] = from_float<T>(o / fmaxf(ls, 1e-30f));
    } else {
      const size_t row = (size_t)bkv * R + r;
      ws[(split * nrows + row) * D + d] = o;
      if (d == 0) {
        ws[(size_t)gridDim.y * nrows * D + split * nrows + row] = mm;
        ws[(size_t)gridDim.y * nrows * (D + 1) + split * nrows + row] = ls;
      }
    }
  }
}

// out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i over the splits'
// partials; a row whose splits saw nothing (every l_i = 0) writes 0.
// Workspace: acc (splits, nrows, D), then m (splits, nrows), then l. One CTA
// of D threads per row: the splits' weights go through shared memory, then
// each thread sums its column over the splits.
template <typename T>
__global__ void __launch_bounds__(256) paged_attention_quant_merge_kernel(
    const float* __restrict__ ws, T* __restrict__ out, int nrows, int D, int splits, int KV,
    int G, int C) {
  __shared__ float m_s[kMergeSplits], l_s[kMergeSplits], w_s[kMergeSplits];
  __shared__ float factor;
  const int row = blockIdx.x, d = threadIdx.x;
  const float* ws_m = ws + (size_t)splits * nrows * D;
  const float* ws_l = ws_m + (size_t)splits * nrows;
  float o = 0.f, ls = 0.f;
  // splits in chunks of kMergeSplits: weights relative to the running max
  float mm = kNegInf;
  for (int s0 = 0; s0 < splits; s0 += kMergeSplits) {
    const int n = min(kMergeSplits, splits - s0);
    __syncthreads();
    for (int i = d; i < n; i += blockDim.x) {
      m_s[i] = ws_m[(size_t)(s0 + i) * nrows + row];
      l_s[i] = ws_l[(size_t)(s0 + i) * nrows + row];
    }
    __syncthreads();
    if (d == 0) {
      float cm = mm;
      for (int i = 0; i < n; ++i) cm = fmaxf(cm, m_s[i]);
      float cl = ls * exp2f(mm - cm);
      for (int i = 0; i < n; ++i) {
        w_s[i] = exp2f(m_s[i] - cm);
        cl += w_s[i] * l_s[i];
      }
      factor = exp2f(mm - cm);  // this chunk's rescale of the running sums
      mm = cm;
      ls = cl;
    }
    __syncthreads();
    o *= factor;
#pragma unroll 4
    for (int i = 0; i < n; ++i) o += w_s[i] * ws[((size_t)(s0 + i) * nrows + row) * D + d];
  }
  __syncthreads();
  if (d == 0) factor = 1.f / fmaxf(ls, 1e-30f);
  __syncthreads();
  const int R = C * G;
  const int bkv = row / R;
  out[row_offset(bkv / KV, bkv % KV, row - bkv * R, KV, G, C, D) + d] =
      from_float<T>(o * factor);
}

struct Args {
  const void *q, *k_codes, *k_scale, *k_zero, *v_codes, *v_scale, *v_zero, *k_tail,
      *v_tail;
  const int *tables, *lengths, *tail_start;
  void* out;
  void* workspace;
  int rows, rows_per_seq, KV, G, NB, P, NP, T_len, deq, splits;
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

template <typename T, int D>
int launch_mma(const Args& a) {
  using L = QMmaCfg<D>;
  int p_log2 = 0;
  while ((1 << p_log2) < a.P) ++p_log2;
  if ((1 << p_log2) != a.P || a.P < 4 || a.P > kTK) return (int)cudaErrorInvalidValue;
  const int C = a.rows_per_seq, B = a.rows / C, R = C * a.G;
  const int row_tiles = (R + kRows - 1) / kRows;
  // the most tiles a (b, kv) can have: every page slot, then every tail slot
  const int max_tiles = (a.NP * a.P + kTK - 1) / kTK + (a.T_len + kTT - 1) / kTT;
  int tiles_per_split = (max_tiles + a.splits - 1) / a.splits;
  if (tiles_per_split < 1) tiles_per_split = 1;
  cudaError_t err = cudaFuncSetAttribute(paged_attention_quant_mma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.KV * row_tiles, a.splits);
  float* ws = static_cast<float*>(a.workspace);
  paged_attention_quant_mma_kernel<T, D><<<grid, kMmaThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const uint8_t*>(a.k_codes),
      static_cast<const __half*>(a.k_scale), static_cast<const __half*>(a.k_zero),
      static_cast<const uint8_t*>(a.v_codes), static_cast<const __half*>(a.v_scale),
      static_cast<const __half*>(a.v_zero), static_cast<const T*>(a.k_tail),
      static_cast<const T*>(a.v_tail), a.tables, a.lengths, a.tail_start,
      static_cast<T*>(a.out), ws, B, a.KV, a.G, C, a.NB, p_log2, a.NP, a.T_len, row_tiles,
      tiles_per_split, a.scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  paged_attention_quant_merge_kernel<T><<<B * a.KV * R, D, 0, a.stream>>>(
      ws, static_cast<T*>(a.out), B * a.KV * R, D, a.splits, a.KV, a.G, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mma_t(const Args& a, int D) {
  switch (D) {
    case 32:
      return launch_mma<T, 32>(a);
    case 64:
      return launch_mma<T, 64>(a);
    case 128:
      return launch_mma<T, 128>(a);
    case 256:
      return launch_mma<T, 256>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// CTAs of the mma kernel one SM holds at once, for the wrapper's split plan
// (the query needs the kernel's shared-memory attribute set first).
template <typename T, int D>
int mma_ctas_per_sm() {
  const auto kern = paged_attention_quant_mma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         QMmaCfg<D>::kBytes);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kMmaThreads,
                                                        QMmaCfg<D>::kBytes);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
int mma_ctas_per_sm_t(int D) {
  switch (D) {
    case 32:
      return mma_ctas_per_sm<T, 32>();
    case 64:
      return mma_ctas_per_sm<T, 64>();
    case 128:
      return mma_ctas_per_sm<T, 128>();
    case 256:
      return mma_ctas_per_sm<T, 256>();
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

long long mma_smem_bytes(int D) {
  switch (D) {
    case 32:
      return QMmaCfg<32>::kBytes;
    case 64:
      return QMmaCfg<64>::kBytes;
    case 128:
      return QMmaCfg<128>::kBytes;
    case 256:
      return QMmaCfg<256>::kBytes;
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA of `route`'s kernel needs (0 = the CUDA-core
// kernel, 1 = the mma kernel, fixed by D), so the wrapper can refuse a shape
// before launching it; -1 for a head_dim the mma kernel does not take.
long long paged_attention_quant_smem_bytes(int route, int G, int D) {
  if (route == 1) return mma_smem_bytes(D);
  return (long long)(smem_floats(G, D) * sizeof(float));
}

// CTAs of the mma kernel (route 1) that one SM holds at once for 16-bit
// dtype (1 = bfloat16, 2 = float16) and head_dim D; a negative value is
// -(CUDA error).
int paged_attention_quant_ctas_per_sm(int dtype, int D) {
  if (dtype == 1) return mma_ctas_per_sm_t<__nv_bfloat16>(D);
  if (dtype == 2) return mma_ctas_per_sm_t<__half>(D);
  return -(int)cudaErrorInvalidValue;
}

// dtype (q, tails, out): 0 = float32, 1 = bfloat16, 2 = float16; deq, the
// cache's logical dtype, the same codes. route: 0 = the CUDA-core kernel
// (any dtype and deq; splits = 1), 1 = the mma kernel (dtype 1 or 2 with
// deq == dtype). The wrapper's kernel_route chooses; any other pairing is
// refused. workspace: splits * rows * KV * G * (D + 2) floats when splits > 1.
// Returns the launches' CUDA error (0 = cudaSuccess); the kernels run
// asynchronously on `stream`.
int paged_attention_quant_launch(int dtype, int deq, int route, const void* q,
                                 const void* k_codes, const void* k_scale,
                                 const void* k_zero, const void* v_codes,
                                 const void* v_scale, const void* v_zero,
                                 const void* k_tail, const void* v_tail,
                                 const void* block_tables, const void* lengths,
                                 const void* tail_start, void* out, void* workspace,
                                 int rows, int rows_per_seq, int KV, int G, int D, int NB,
                                 int P, int NP, int T, int splits, float scale,
                                 void* stream) {
  if (rows * KV == 0) return 0;
  if (splits < 1 || rows_per_seq < 1 || rows % rows_per_seq) return (int)cudaErrorInvalidValue;
  const Args a{q, k_codes, k_scale, k_zero, v_codes, v_scale, v_zero, k_tail, v_tail,
               static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
               static_cast<const int*>(tail_start), out, workspace, rows, rows_per_seq, KV,
               G, NB, P, NP, T, deq, splits, scale, static_cast<cudaStream_t>(stream)};
  if (route == 1) {
    if (deq != dtype) return (int)cudaErrorInvalidValue;
    if (dtype == 1) return launch_mma_t<__nv_bfloat16>(a, D);
    if (dtype == 2) return launch_mma_t<__half>(a, D);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0 || splits != 1) return (int)cudaErrorInvalidValue;
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
