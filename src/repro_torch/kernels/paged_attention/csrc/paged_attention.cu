// Paged attention for NVIDIA Hopper (sm_90a), plain C interface: decode and
// chunked extend over a paged KV pool.
//
// Replaces repro/kernels/paged_attention/paged_attention.py::paged_attention
// (the Pallas TPU kernel, body `_kernel`). Same function: each query row
// attends over the positions of its sequence's block table that it may see,
// online softmax in fp32, the G query heads of a KV head share each page
// read, a row with no valid position writes 0.
//   q (B, C, KV, G, D), k_pages / v_pages (KV, NB, P, D), block_tables
//   (B, NP) int32, lengths (B,) int32 -> out (B, C, KV, G, D) in q's dtype.
// Decode is C = 1 and row (c, g) sees positions < lengths[b]. Chunked extend
// (`causal`) sees positions < lengths[b] + c + 1: the page-resident prefix
// plus in-chunk causality, the mask of ref.py::paged_attention_chunked_ref,
// which the reference's own fold into the batch axis computes too. No row
// reads past NP * P.
//
// Bound on this card: HBM bytes. Each (sequence, KV head) row tile streams
// its live K and V pages once, B * KV * min(L, NP * P) * D * 2 * itemsize
// bytes, against ~4 * C * G flops per K/V element pair: ~1 flop per byte in
// decode, ~64 in a C = 64 chunk at G = 1, both far below the H100's ~295.
// So the design aims at bytes in flight and at reading each page once.
//
// Two kernels, chosen by dtype alone (the wrapper's kernel_route, checked
// here):
//   * bf16 / f16, D in {32, 64, 128, 256} (`paged_attention_mma_kernel`):
//     a CTA of 4 warps owns one (sequence b, KV head, 16-row tile); its rows
//     are the C * G pairs (c, g), c-major, so decode's G heads share one
//     tile and a C = 64 extend chunk at G = 1 takes 4 tiles. The 4 warps
//     split each 64-key tile into 16-key slices and merge their (m, l, acc)
//     in shared memory at the end; a page is read once per (b, kv, row
//     tile), not once per query row as the fold did (the row tiles of one
//     (b, kv) are adjacent in the grid and meet the pages in L2).
//     S = Q.K^T and O += P.V on mma.sync m16n8k16 (fp32 accumulate), Q
//     staged once, K through ldmatrix, V through ldmatrix.trans; the
//     running max and sum stay in registers. bf16 P is split into a head
//     and a remainder, two P.V products (one rounding failed a 3e-2 gate in
//     flash_prefill); f16 P is rounded once.
//     K/V tiles arrive in a 3-stage shared-memory ring filled by 16-byte
//     cp.async.cg copies, four threads per key row, each key row's address
//     from the block table the CTA reads itself (page = pos / P, slot =
//     pos % P: any page size), the table reads issued before the copies;
//     XOR-swizzled so that ldmatrix reads are conflict-free. Slots at or
//     past the CTA's last visible position are never read: cp.async fills
//     them with zeros, so a dead V row is 0 and p = 0 times it is 0, not
//     NaN; masked scores are -1e30 with p = 0 exactly, as in the plain
//     version. Split-K (flash-decoding): grid (b * KV * row tiles, splits),
//     the split count planned on the host from shapes and the kernel's
//     occupancy (plan_splits); with splits > 1 each CTA writes fp32
//     partials (m, l, acc) to a workspace and `paged_attention_merge_kernel`
//     combines them, out = sum e^(m_i - M) acc_i / sum e^(m_i - M) l_i. A
//     split past a row's last position writes m = -1e30, l = 0.
//     On an H100 (chip_smoke.py phase 4) the mma kernel alone ran within
//     1.2x of the bytes bound at the olmo-1b decode shape; the rest of a
//     call was the merge's launch. A long row's tiles are then bound by
//     their instruction latency, one or two warps per scheduler.
//   * fp32 (`paged_attention_kernel`): the CUDA cores, decode rows only
//     (extend folds its C positions into the batch axis); TF32 would keep
//     10 bits of each input and break the 1e-5 gates. One CTA per (b, kv),
//     positions staged a 16 KB tile at a time into shared memory as fp32,
//     the next tile's loads in flight under this tile's math; dot products
//     four at a time per warp with shuffle reductions, one warp per query
//     head for the online softmax, the (G, D) accumulator in shared memory.
//     Slots at or past lengths[b] are never loaded.
//
// Left for later PRs: the merge folded into the last CTA of each row tile
// (it costs a launch); fewer instructions per 16-key slice (the table
// reads, the rescale); the split choice from the real lengths (the host
// plans from the table width, so as not to read lengths back).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
int launch_cuda_core(const void* q, const void* k_pages, const void* v_pages,
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

// ---------------------------------------------------------------------------
// 16-bit pages on the tensor cores (mma.sync), decode and chunked extend
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTK = 64;      // keys per tile
constexpr int kStages = 3;   // tiles in the shared-memory ring
constexpr int kMergeSplits = 64;  // split weights the merge stages at a time
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kRows = 16;                // query rows per CTA: one mma tile
constexpr int kKW = kTK / kMmaWarps;     // keys per warp per tile

// Shared memory: Q (kRows x D), then kStages K tiles, then kStages V tiles,
// all 16-bit and swizzled; after the loop the same bytes hold the epilogue's
// fp32 partials, one (kRows x D + 4) block per warp plus m and l.
template <int D>
struct MmaCfg {
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kTK * D * 2;
  static constexpr int kRing = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kAccStride = D + 4;
  static constexpr int kEpi = (kMmaWarps * kRows * (kAccStride + 2)) * 4;
  static constexpr int kBytes = kRing > kEpi ? kRing : kEpi;
  static_assert(kKW == 16, "a warp's key slice is one k16 step of P.V");
  static_assert(kBytes <= 232448, "more than a CTA's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk `ch` of row `row` in a swizzled [rows][D]
// tile: the chunk index is XORed with the row, so the 8 rows one ldmatrix
// reads at one logical chunk land in 8 distinct bank groups. With D = 32 a
// row is 64 bytes (4 chunks) and two rows share one 128-byte line.
template <int D>
__device__ __forceinline__ int swz(int row, int ch) {
  constexpr int kChunks = D / 8;
  if constexpr (kChunks >= 8)
    return row * D + ((ch ^ (row & 7)) << 3);
  else
    return row * D + ((ch ^ ((row >> 1) & 3)) << 3);
}

// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros. No
// "memory" clobber, so that the table reads feeding the addresses can be
// hoisted and overlap; cp.async.wait_group and __syncthreads order the
// shared-memory reads.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) paged_attention_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ block_tables, const int* __restrict__ lengths,
    T* __restrict__ out, float* __restrict__ ws, int B, int KV, int G, int C, int causal,
    int NB, int P, int NP, int row_tiles, int tiles_per_split, float scale_log2) {
  using L = MmaCfg<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr bool kSplitP = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t s_q = smem_u32(smem_raw);
  const uint32_t s_k = s_q + L::kQBytes;
  const uint32_t s_v = s_k + kStages * L::kTileBytes;

  const int R = C * G;
  const int rt = blockIdx.x % row_tiles;
  const int bkv = blockIdx.x / row_tiles;
  const int kv = bkv % KV;
  const int b = bkv / KV;
  const int split = blockIdx.y;
  const int r0 = rt * kRows;  // the CTA's first row (< R)
  const int len_b = lengths[b];
  // a row's visible positions: lengths[b] in decode, lengths[b] + c + 1 in
  // extend, never past the table
  auto row_len = [&](int r) { return causal ? len_b + r / G + 1 : len_b; };
  const int n_keys = max(0, min(row_len(min(R, r0 + kRows) - 1), NP * P));
  const int n_tiles = (n_keys + kTK - 1) / kTK;
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
  // K and V of positions [t * kTK, t * kTK + kTK) into ring slot `stage`;
  // positions at or past n_keys are zero-filled and never read. kTPR
  // threads copy one key row, consecutive 16-byte chunks side by side; a
  // thread serves kPer keys kKeys apart, its block-table reads first.
  constexpr int kTPR = 4;
  constexpr int kCPT = kChunks / kTPR;          // chunks per thread and key
  constexpr int kKeys = kMmaThreads / kTPR;     // keys per pass
  constexpr int kPer = kTK / kKeys;             // keys per thread
  const int c_own = threadIdx.x % kTPR;
  const int kr_own = threadIdx.x / kTPR;
  auto load_tile = [&](int t, int stage) {
    size_t off[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int pos = t * kTK + kr_own + j * kKeys;
      const int page = pos / P;
      off[j] = pos < n_keys ? ((kv_nb + table[page]) * P + (pos - page * P)) * (size_t)D : 0;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int kr = kr_own + j * kKeys;
      const int bytes = t * kTK + kr < n_keys ? 16 : 0;
#pragma unroll
      for (int i = 0; i < kCPT; ++i) {
        const int ch = c_own + kTPR * i;
        const uint32_t so = stage * L::kTileBytes + 2 * swz<D>(kr, ch);
        cp_async16(s_k + so, k_pages + off[j] + ch * 8, bytes);
        cp_async16(s_v + so, v_pages + off[j] + ch * 8, bytes);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t_begin + s < t_end) load_tile(t_begin + s, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, tig = lane % 4;
  const int mi = lane / 8, mr = lane % 8;  // this lane's ldmatrix row address
  // this thread's two rows r0 + g4 (+ 8): how far each sees
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g4 + 8 * h;
    lim[h] = r < R ? max(0, min(row_len(r), n_keys)) : 0;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int j = t - t_begin;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t landed
    __syncthreads();               // everyone's; and tile t - 1's slot is free
    if (t + kStages - 1 < t_end) load_tile(t + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    const int key0 = t * kTK + warp * kKW;  // this warp's first key
    if (key0 >= n_keys) continue;            // none of the rows sees any of them
    const uint32_t kst = s_k + (j % kStages) * L::kTileBytes;
    const uint32_t vst = s_v + (j % kStages) * L::kTileBytes;

    // s = q . k^T: 16 rows x 16 keys (two 8-key blocks), D in 16-wide steps
    float s[2][4] = {};
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4], kb[4];
      ldsm_x4(s_q + 2 * swz<D>(mr + (mi & 1) * 8, 2 * kd + (mi >> 1)), a);
      ldsm_x4(kst + 2 * swz<D>(warp * kKW + mr + (mi >> 1) * 8, 2 * kd + (mi & 1)), kb);
      mma16816<T>(s[0], a, kb[0], kb[1]);
      mma16816<T>(s[1], a, kb[2], kb[3]);
    }
    // online softmax in the log2 domain; s[n][e] is row g4 + 8 (e / 2), key
    // key0 + 8 n + 2 tig + e % 2; a masked score is -1e30 and its p is 0
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * n + 2 * tig + (e & 1);
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
        const int key = key0 + 8 * n + 2 * tig + (e & 1);
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
      ldsm_x4_trans(vst + 2 * swz<D>(warp * kKW + mr + (mi & 1) * 8, n + (mi >> 1)), vb);
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
__global__ void __launch_bounds__(256) paged_attention_merge_kernel(
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

template <typename T, int D>
int launch_mma(const void* q, const void* k_pages, const void* v_pages,
               const int* block_tables, const int* lengths, void* out, void* workspace, int B,
               int KV, int G, int C, int causal, int NB, int P, int NP, int splits, float scale,
               cudaStream_t stream) {
  using L = MmaCfg<D>;
  const int R = C * G;
  const int row_tiles = (R + kRows - 1) / kRows;
  const int key_tiles = (NP * P + kTK - 1) / kTK;
  int tiles_per_split = (key_tiles + splits - 1) / splits;
  if (tiles_per_split < 1) tiles_per_split = 1;
  cudaError_t err = cudaFuncSetAttribute(paged_attention_mma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * KV * row_tiles, splits);
  paged_attention_mma_kernel<T, D><<<grid, kMmaThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, lengths, static_cast<T*>(out),
      static_cast<float*>(workspace), B, KV, G, C, causal, NB, P, NP, row_tiles,
      tiles_per_split, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  paged_attention_merge_kernel<T><<<B * KV * R, D, 0, stream>>>(
      static_cast<const float*>(workspace), static_cast<T*>(out), B * KV * R, D, splits, KV,
      G, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mma_t(const void* q, const void* k_pages, const void* v_pages,
                 const int* block_tables, const int* lengths, void* out, void* workspace, int B,
                 int KV, int G, int C, int causal, int D, int NB, int P, int NP, int splits,
                 float scale, cudaStream_t stream) {
#define PA_MMA_D(DD)                                                                       \
  case DD:                                                                                 \
    return launch_mma<T, DD>(q, k_pages, v_pages, block_tables, lengths, out, workspace, B, \
                             KV, G, C, causal, NB, P, NP, splits, scale, stream);
  switch (D) {
    PA_MMA_D(32)
    PA_MMA_D(64)
    PA_MMA_D(128)
    PA_MMA_D(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_MMA_D
}

// CTAs of the mma kernel one SM holds at once, for the wrapper's split plan
// (the query needs the kernel's shared-memory attribute set first).
template <typename T, int D>
int mma_ctas_per_sm() {
  const auto kern = paged_attention_mma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MmaCfg<D>::kBytes);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kMmaThreads,
                                                        MmaCfg<D>::kBytes);
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

int launch_cuda_core_f32(const void* q, const void* k_pages, const void* v_pages,
                         const int* block_tables, const int* lengths, void* out, int B, int KV,
                         int G, int D, int NB, int P, int NP, float scale,
                         cudaStream_t stream) {
#define PA_CORE_D(DD)                                                                 \
  case DD:                                                                            \
    return launch_cuda_core<float, DD>(q, k_pages, v_pages, block_tables, lengths, out, \
                                       B, KV, G, NB, P, NP, scale, stream);
  switch (D) {
    PA_CORE_D(32)
    PA_CORE_D(64)
    PA_CORE_D(128)
    PA_CORE_D(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_CORE_D
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA of the CUDA-core kernel (route 0) needs for
// an element of `itemsize` bytes, so the wrapper can refuse a shape before
// launching it. The mma kernel's (route 1) is fixed by D and always fits.
long long paged_attention_smem_bytes(int G, int D, int itemsize) {
  return (long long)(smem_floats(G, D, tile_tokens(D, itemsize)) * sizeof(float));
}

// CTAs of the mma kernel (route 1) that one SM holds at once for 16-bit
// dtype (1 = bfloat16, 2 = float16) and head_dim D; a negative value is
// -(CUDA error).
int paged_attention_ctas_per_sm(int dtype, int D) {
  if (dtype == 1) return mma_ctas_per_sm_t<__nv_bfloat16>(D);
  if (dtype == 2) return mma_ctas_per_sm_t<__half>(D);
  return -(int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. route: 0 = the CUDA-core
// kernel (float32, decode rows only: C = 1, causal = 0, splits = 1), 1 = the
// mma kernel (16-bit). The wrapper's kernel_route chooses; any other pairing
// is refused. q / out are (B, C, KV, G, D); causal = 1 gives row (c, g)
// lengths[b] + c + 1 positions, causal = 0 lengths[b]. workspace: splits *
// B * KV * C * G * (D + 2) floats when splits > 1. Returns the CUDA error of
// the launches (0 = cudaSuccess); the kernels run asynchronously on `stream`.
int paged_attention_launch(int dtype, int route, const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* lengths, void* out, void* workspace, int B, int KV,
                           int G, int C, int causal, int D, int NB, int P, int NP, int splits,
                           float scale, void* stream) {
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (dtype != 0 || C != 1 || causal != 0 || splits != 1) return (int)cudaErrorInvalidValue;
    return launch_cuda_core_f32(q, k_pages, v_pages, tables, lens, out, B, KV, G, D, NB, P,
                                NP, scale, s);
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 1:
      return launch_mma_t<__nv_bfloat16>(q, k_pages, v_pages, tables, lens, out, workspace, B,
                                         KV, G, C, causal, D, NB, P, NP, splits, scale, s);
    case 2:
      return launch_mma_t<__half>(q, k_pages, v_pages, tables, lens, out, workspace, B, KV, G,
                                  C, causal, D, NB, P, NP, splits, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
