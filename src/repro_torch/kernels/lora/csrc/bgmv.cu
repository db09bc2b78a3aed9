// Batched grouped LoRA matmul (Punica's BGMV) for NVIDIA Hopper (sm_90a), plain C
// interface, with up to three adapter sites sharing one input and the delta added to
// each site's base output in the epilogue.
//
// Replaces the Pallas TPU kernel repro/kernels/lora/lora.py::bgmv (body `_kernel`):
//   y[b] = (x[b] @ A[idx[b]]) @ B[idx[b]]
// x (B, C, Din) in f32, bf16 or f16; per site A (T, Din, R) f32, B (T, R, Dout) f32;
// idx (B,) int32. A site writes round(y) into a new (B, C, Dout) tensor, or, given a
// base (B, C, Dout) in x's dtype, round(float(base) + float(round(y))) into the base in
// place: PyTorch's own `base + y` on the rounded delta. The sums run in f32 and the
// delta is rounded once. Slot 0 (all-zero tables) gives an exact 0; an id outside
// [0, T) never reads the tables and its rows come back NaN.
//
// What bounds it on this card: bytes. The two products do 2 R (Din + Dout) operations
// per token against 4 R (Din + Dout) bytes of factors per distinct slot, far below the
// operations per byte at which the f32 rate binds, so the work stays on the CUDA cores
// in f32 FMA (TF32 tensor cores would break the f32 gates; at rank 8 wgmma and TMA pay
// nothing). At decode a call moves a few MB: its time is latency, so the design is
// about loads in flight, few dependent round trips and enough CTAs for 132 SMs.
//
// Design. One CTA of 128 threads per (site, column span, tile of ROWS rows of C, batch
// row); the grid is planned on the host (lora/bgmv.py::plan). The rank instance RP
// (8, 16, 32, 64; a smaller R reads its padded columns as zero) and ROWS (1 .. 64) are
// template parameters, so the loops inside a rank chunk unroll into registers.
//   * Shrink, split over a thread block cluster: the K CTAs of a cluster (K <= 8,
//     consecutive along x, all on one site and one row tile) each take 1/K of Din, so
//     the slot's A and x's rows are read once per cluster, not once per column span.
//     A lane takes 16 bytes of x per row (8 bf16 values) and the matching 8 rows of A
//     (R contiguous f32 each, as float4s), all loaded before the first FMA; with more
//     than 4 rows the warps split the rows, with fewer they split Din. The (rows x 8)
//     partial sums of a rank chunk are reduced inside each warp by a butterfly that
//     halves the values a lane keeps at each step (about one shuffle per value, not
//     five), then across warps through shared memory, then pushed into every CTA of
//     the cluster through distributed shared memory; after one cluster barrier each
//     CTA sums the K partials in rank order, so all of them hold the same h.
//   * Expand: a thread owns 4 neighbouring columns per pass (float4 loads of B, 8- or
//     16-byte stores) over the CTA's whole span after its single shrink; at rank <= 16
//     it keeps all of B's ranks for those columns in registers and walks every row of
//     the tile (B read once per row tile); a span narrower than 512 columns splits the
//     rows over the idle threads. At decode B's first columns and the bases are loaded
//     before the shrink, so their latency hides behind it. The base is read and
//     written in place, so each group of rows loads its bases before any store.
//   * Ragged widths: a Din that is not a multiple of 16 bytes of x, an R that is not a
//     multiple of 4 or a Dout that is not a multiple of 4 take scalar loads and stores;
//     the wrapper refuses data that is not 16-byte aligned.
// The sums' order depends on the plan (K, ROWS), not on the sites or the bases: one
// launch with bases equals PyTorch's base + the same launch's deltas bit for bit.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

constexpr int kMaxSites = 3;

// the launch's arguments, passed to the kernel by value (lora/bgmv.py mirrors them)
struct BgmvSite {
  const float* a;    // (T, Din, R)
  const float* b;    // (T, R, Dout)
  const void* base;  // (B, C, Dout) in x's dtype, or null
  void* out;         // base itself, or a new (B, C, Dout)
  int dout;
  int num_slots;     // T
  int ctas;          // CTAs along x, a multiple of the cluster size
  int span;          // columns per CTA, a multiple of 4
};

struct BgmvArgs {
  BgmvSite site[kMaxSites];
  int nsites;
  const void* x;
  const int* idx;
  int B, C, Din, R;
  int row_tiles;
  int cluster;  // K
  int d_share;  // Din per cluster rank, a multiple of 16 bytes of x
};

namespace {

using Site = BgmvSite;
using Args = BgmvArgs;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                 // output columns per thread per pass
constexpr int kPass = kThreads * kVec;  // 512 columns
constexpr int kChunk = 8;               // rank columns per shrink round / expand step
constexpr int kMaxCluster = 8;
constexpr int kMaxRank = 64;
constexpr int kMaxValues = 512;         // ROWS * RP: h of one CTA
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

// 4 neighbouring elements as raw bits: one 8-byte (16-bit types) or 16-byte (f32)
// access, unpacked and packed with bit operations so that they stay in registers
template <typename T> struct Raw4 { using type = uint2; };
template <> struct Raw4<float> { using type = float4; };

template <typename T> __device__ __forceinline__ unsigned short bits16(T x);
template <>
__device__ __forceinline__ unsigned short bits16<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
template <> __device__ __forceinline__ unsigned short bits16<__half>(__half x) {
  return __half_as_ushort(x);
}

template <typename T>
__device__ __forceinline__ float get4(const typename Raw4<T>::type& r, int k) {
  if constexpr (sizeof(T) == 4) {
    return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
  } else {
    const uint32_t w = k < 2 ? r.x : r.y;
    const unsigned short h = (unsigned short)(k % 2 ? w >> 16 : w & 0xffffu);
    if constexpr (std::is_same<T, __half>::value)
      return __half2float(__ushort_as_half(h));
    else
      return __bfloat162float(__ushort_as_bfloat16(h));
  }
}

// round each value to T and pack
template <typename T>
__device__ __forceinline__ typename Raw4<T>::type pack4(const float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    return make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      w[i] = (uint32_t)bits16<T>(from_float<T>(v[2 * i])) |
             ((uint32_t)bits16<T>(from_float<T>(v[2 * i + 1])) << 16);
    return make_uint2(w[0], w[1]);
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One step of the butterfly below: N values held, partners at xor S.
template <int M, int N, int S>
__device__ __forceinline__ void scatter_step(float (&v)[M], int lane) {
  if constexpr (S > 0) {
    if constexpr (N > 1) {
      const bool up = (lane & S) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
      }
      scatter_step<M, N / 2, S / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], S);
      scatter_step<M, 1, S / 2>(v, lane);
    }
  }
}

// Sum N values per lane over the warp's 32 lanes. Each step exchanges half of the
// values a lane still holds with its partner, so the warp spends about N shuffles,
// not 5 N. Returns the index of the first value the lane holds: lane keeps
// v[0 .. max(1, N / 32)) = the sums of the original [first, first + that), where
// first = lane * N / 32 (at each step a lane whose bit S is set keeps the upper half).
// Each sum is the same tree over the lanes (partners at xor 16, 8, 4, 2, 1) whatever N
// is.
template <int N>
__device__ __forceinline__ int warp_reduce_scatter(float (&v)[N], int lane) {
  scatter_step<N, N, 16>(v, lane);
  return lane * N / 32;
}

__device__ __forceinline__ int pow2_at_least(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

__device__ __forceinline__ uint32_t word(const uint4& u, int w) {
  return w == 0 ? u.x : w == 1 ? u.y : w == 2 ? u.z : u.w;
}

// element i of 16 bytes of x, as float
template <typename T> __device__ __forceinline__ float elem(const uint4& u, int i);
template <> __device__ __forceinline__ float elem<float>(const uint4& u, int i) {
  return __uint_as_float(word(u, i));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int i) {
  const uint32_t w = word(u, i / 2);
  return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
}
template <> __device__ __forceinline__ float elem<__half>(const uint4& u, int i) {
  const uint32_t w = word(u, i / 2);
  return __half2float(__ushort_as_half((unsigned short)(i % 2 ? w >> 16 : w & 0xffffu)));
}

// 16 bytes of row `p` from column d (16 / sizeof(T) values), zero past `len`
template <typename T>
__device__ __forceinline__ uint4 load_x(const T* p, int d, int len, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + d));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(T) == 4) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d + i < len) w[i] = __ldg(q + d + i);
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (d + i < len) w[i / 2] |= (uint32_t)__ldg(q + d + i) << (16 * (i % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// rank columns [r0, r0 + 8) of one row of A (row length R), zero past R
__device__ __forceinline__ void load_a(float (&out)[kChunk], const float* row, int r0,
                                       int R, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kChunk; q += 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + q < R) f = __ldg(reinterpret_cast<const float4*>(row + r0 + q));
      out[q] = f.x;
      out[q + 1] = f.y;
      out[q + 2] = f.z;
      out[q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) out[j] = r0 + j < R ? __ldg(row + r0 + j) : 0.f;
  }
}

// rows [r0, r0 + NB) of B (stride Dout) at columns [n, n + 4), zero past R or n1
template <int NB>
__device__ __forceinline__ void load_b(float4 (&out)[NB], const float* bs, int r0, int R,
                                       int n, int n1, int dout, bool vec) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + j < R) {
      const float* p = bs + (size_t)(r0 + j) * dout + n;
      if (vec) {
        f = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        f.x = __ldg(p);
        if (n + 1 < n1) f.y = __ldg(p + 1);
        if (n + 2 < n1) f.z = __ldg(p + 2);
        if (n + 3 < n1) f.w = __ldg(p + 3);
      }
    }
    out[j] = f;
  }
}

// acc[0..4) += sum over NB ranks of h[r] * B[r][n..n+4); h in shared memory, 16-byte
// aligned, read as broadcasts
template <int NB>
__device__ __forceinline__ void expand_fma(float (&acc)[kVec], const float* h,
                                           const float4 (&bv)[NB]) {
#pragma unroll
  for (int j = 0; j < NB; j += 4) {
    const float4 h4 = *reinterpret_cast<const float4*>(h + j);
    const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[0] = fmaf(hv[q], bv[j + q].x, acc[0]);
      acc[1] = fmaf(hv[q], bv[j + q].y, acc[1]);
      acc[2] = fmaf(hv[q], bv[j + q].z, acc[2]);
      acc[3] = fmaf(hv[q], bv[j + q].w, acc[3]);
    }
  }
}

// the base's 4 values at column n of the thread's rows k0 .. k0 + NQ - 1 (row
// phase + k * phases; vector path only: the scalar path reads its base in store_row)
template <typename T, int NQ>
__device__ __forceinline__ void load_bases(typename Raw4<T>::type (&bq)[NQ],
                                           const T* base, int k0, int phase, int phases,
                                           int rows, int dout, int n, bool vec) {
  if (!base || !vec) return;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int c = phase + (k0 + i) * phases;
    if (c >= rows) break;
    bq[i] = *reinterpret_cast<const typename Raw4<T>::type*>(base + (size_t)c * dout + n);
  }
}

// one row's 4 outputs at column n: round(acc), or base + round(acc) (PyTorch's add on
// the rounded delta), written as one vector where Dout allows it (the base's values
// `bq` loaded beforehand)
template <typename T>
__device__ __forceinline__ void store_row(T* out, const T* base,
                                          const typename Raw4<T>::type& bq,
                                          const float (&acc)[kVec], int n, int n1,
                                          bool vec) {
  if (vec) {
    float o[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      o[k] = base ? get4<T>(bq, k) + to_float<T>(from_float<T>(acc[k])) : acc[k];
    *reinterpret_cast<typename Raw4<T>::type*>(out + n) = pack4<T>(o);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (n + k >= n1) break;
      const T delta = from_float<T>(acc[k]);
      out[n + k] =
          base ? from_float<T>(to_float<T>(base[n + k]) + to_float<T>(delta)) : delta;
    }
  }
}

// B of the expand in registers: every rank when RP <= kRegRanks (rows one at a time),
// else chunks of kRegRanks with the rows' partial sums in registers (ROWS <= 4)
constexpr int kRegRanks = 16;

// which (rank instance, rows of C per CTA) pairs exist
__host__ __device__ constexpr bool instance_ok(int rp, int rows) {
  return rp <= kRegRanks ? rows * rp <= kMaxValues : rows <= 4;
}

template <typename T, int RP, int ROWS>
__global__ void __launch_bounds__(kThreads) bgmv_kernel(const Args args) {
  constexpr int G = 16 / sizeof(T);        // x values per 16 bytes
  constexpr int SR = ROWS < 4 ? ROWS : 4;  // rows per shrink round
  constexpr int NROW = ROWS / SR < kWarps ? ROWS / SR : kWarps;  // warps splitting rows
  constexpr int NDW = kWarps / NROW;       // warps splitting a row's Din share
  constexpr int V = ROWS * RP;             // h values of this CTA
  constexpr int NV = SR * kChunk;          // partial sums per lane and round
  constexpr int RB = RP < kRegRanks ? RP : kRegRanks;  // ranks of B per expand step
  static_assert(instance_ok(RP, ROWS) && RP <= kMaxRank && RP % kChunk == 0, "instance");
  __shared__ float red[kWarps][V];                  // per-warp partial h
  __shared__ float hall[kMaxCluster][V];            // per-cluster-rank partial h
  __shared__ __align__(16) float hs[V];             // h
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // this CTA's site and column range
  // (constant indices only: a computed index would copy the sites to local memory)
  int cx = blockIdx.x;
  Site site = args.site[0];
  if (args.nsites > 1 && cx >= site.ctas) {
    cx -= site.ctas;
    site = args.site[1];
    if (args.nsites > 2 && cx >= site.ctas) {
      cx -= site.ctas;
      site = args.site[2];
    }
  }
  const int C = args.C, Din = args.Din, R = args.R, K = args.cluster;
  const int rank = cx % K;  // the site's first CTA starts a cluster
  const int b = blockIdx.z, c0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, C - c0);
  const int dout = site.dout;
  const int n0 = cx * site.span, n1 = min(n0 + site.span, dout);
  const size_t row0 = (size_t)b * C + c0;  // this CTA's first (b, c) row
  T* out = static_cast<T*>(site.out) + row0 * dout;
  const T* base = site.base ? static_cast<const T*>(site.base) + row0 * dout : nullptr;
  const bool vec_b = dout % kVec == 0;

  const int slot = args.idx[b];
  if (slot < 0 || slot >= site.num_slots) {  // the same for the whole cluster
    for (int n = n0 + tid * kVec; n < n1; n += kPass)
      for (int c = 0; c < rows; ++c)
        for (int k = 0; k < kVec && n + k < n1; ++k)
          out[(size_t)c * dout + n + k] = from_float<T>(NAN);
    return;
  }
  const float* bs = site.b + (size_t)slot * R * dout;

  // the expand's threads: `tcols` of them on neighbouring column quads, the CTA's
  // rows split over kThreads / tcols phases (a narrow span still keeps every
  // thread busy)
  const int tcols = min(kThreads, pow2_at_least((site.span + kVec - 1) / kVec));
  const int phases = kThreads / tcols, phase = tid / tcols;
  const int nfirst = n0 + (tid % tcols) * kVec;

  // the expand's first B and bases, in flight during the shrink (decode-sized
  // tiles only: with more rows the shrink needs the registers)
  constexpr bool kPrefetch = ROWS <= 2 && RP <= kRegRanks;
  constexpr int kGroup = ROWS < 8 ? ROWS : 8;  // rows whose bases load together
  using Raw = typename Raw4<T>::type;
  float4 bfirst[kPrefetch ? RB : 1];
  Raw bqfirst[kGroup];
  const bool prefetched = kPrefetch && nfirst < n1 && phase < rows;
  if constexpr (kPrefetch) {
    if (prefetched) {
      load_b<RB>(bfirst, bs, 0, R, nfirst, n1, dout, vec_b);
      load_bases<T, kGroup>(bqfirst, base, 0, phase, phases, rows, dout, nfirst, vec_b);
    }
  }

  // shrink: warp w takes the row rounds w % NROW, w % NROW + NROW, ... over its
  // 1 / NDW of this CTA's Din share; rows it does not take stay 0 in red[w]
  const bool clustered = K > 1;
  if (clustered) cluster_arrive_relaxed();  // waited for before the first remote write
  for (int v = lane; v < V; v += 32) red[warp][v] = 0.f;
  __syncwarp();
  const T* xb = static_cast<const T*>(args.x) + row0 * Din;
  const float* as = site.a + (size_t)slot * Din * R;
  const int dlo = rank * args.d_share, dhi = min(Din, dlo + args.d_share);
  const bool vec_x = Din % G == 0, vec_a = R % 4 == 0;
  const int dfirst = dlo + ((warp / NROW) * 32 + lane) * G;
#pragma unroll 1
  for (int sb = (warp % NROW) * SR; sb < rows; sb += NROW * SR) {
#pragma unroll 1
    for (int rc = 0; rc < R; rc += kChunk) {
      float acc[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] = 0.f;
      for (int d = dfirst; d < dhi; d += NDW * 32 * G) {
        uint4 xv[SR];  // raw: converted at the FMA
#pragma unroll
        for (int c = 0; c < SR; ++c)
          xv[c] = sb + c < rows ? load_x<T>(xb + (size_t)(sb + c) * Din, d, Din, vec_x)
                                : make_uint4(0u, 0u, 0u, 0u);
        float av[G][kChunk];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          if (d + i < Din) {
            load_a(av[i], as + (size_t)(d + i) * R, rc, R, vec_a);
          } else {
#pragma unroll
            for (int j = 0; j < kChunk; ++j) av[i][j] = 0.f;
          }
        }
#pragma unroll
        for (int c = 0; c < SR; ++c)
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const float xf = elem<T>(xv[c], i);
#pragma unroll
            for (int j = 0; j < kChunk; ++j)
              acc[c * kChunk + j] = fmaf(xf, av[i][j], acc[c * kChunk + j]);
          }
      }
      const int first = warp_reduce_scatter<NV>(acc, lane);
      constexpr int kept = NV >= 32 ? NV / 32 : 1;
#pragma unroll
      for (int i = 0; i < kept; ++i) {
        const int v = first + i;  // (row sb + v / 8, rank rc + v % 8)
        red[warp][(sb + v / kChunk) * RP + rc + v % kChunk] = acc[i];
      }
    }
  }
  __syncthreads();
  // sum over the warps, then push into slot `rank` of every CTA of the cluster
  if (clustered) cluster_wait();  // every CTA of the cluster has started
  cg::cluster_group cluster = cg::this_cluster();
  for (int v = tid; v < V; v += kThreads) {
    float p = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) p += red[w][v];
    if (clustered) {
      for (int k = 0; k < K; ++k)
        cluster.map_shared_rank(&hall[0][0], k)[rank * V + v] = p;
    } else {
      hall[0][v] = p;
    }
  }
  if (clustered) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  for (int v = tid; v < V; v += kThreads) {
    float h = 0.f;
    for (int k = 0; k < K; ++k) h += hall[k][v];
    hs[v] = h;
  }
  __syncthreads();

  // expand: y[c][n] = sum_r h[c][r] * B[r][n] over this CTA's columns, 4 a thread.
  // The base is read and written in place, so the compiler may not move a row's
  // base load above an earlier row's store: each group's bases are loaded first.
  for (int n = nfirst, pass = 0; n < n1; n += tcols * kVec, ++pass) {
    const bool first = kPrefetch && pass == 0 && prefetched;
    if constexpr (RP <= kRegRanks) {
      // all of B's ranks in registers, read once for all the thread's rows
      float4 bv[RB];
      if (first) {
#pragma unroll
        for (int j = 0; j < RB; ++j) bv[j] = bfirst[kPrefetch ? j : 0];
      } else {
        load_b<RB>(bv, bs, 0, R, n, n1, dout, vec_b);
      }
#pragma unroll 1
      for (int k0 = 0; phase + k0 * phases < rows; k0 += kGroup) {
        Raw bq[kGroup];
        if (first) {
#pragma unroll
          for (int i = 0; i < kGroup; ++i) bq[i] = bqfirst[i];
        } else {
          load_bases<T, kGroup>(bq, base, k0, phase, phases, rows, dout, n, vec_b);
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int c = phase + (k0 + i) * phases;
          if (c >= rows) break;
          float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
          expand_fma<RB>(acc, &hs[c * RP], bv);
          store_row<T>(out + (size_t)c * dout, base ? base + (size_t)c * dout : nullptr,
                       bq[i], acc, n, n1, vec_b);
        }
      }
    } else {
      // chunks of B's ranks, the rows' partial sums in registers (ROWS <= 4)
      float acc[ROWS][kVec];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
#pragma unroll
        for (int q = 0; q < kVec; ++q) acc[k][q] = 0.f;
#pragma unroll 1
      for (int rc = 0; rc < R; rc += RB) {
        float4 bv[RB];
        load_b<RB>(bv, bs, rc, R, n, n1, dout, vec_b);
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const int c = phase + k * phases;
          if (c < rows) expand_fma<RB>(acc[k], &hs[c * RP + rc], bv);
        }
      }
      Raw bq[ROWS];
      load_bases<T, ROWS>(bq, base, 0, phase, phases, rows, dout, n, vec_b);
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int c = phase + k * phases;
        if (c < rows)
          store_row<T>(out + (size_t)c * dout, base ? base + (size_t)c * dout : nullptr,
                       bq[k], acc[k], n, n1, vec_b);
      }
    }
  }
}

template <typename T, int RP, int ROWS>
cudaError_t launch(const Args& args, dim3 grid, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bgmv_kernel<T, RP, ROWS>, args);
}

// the instance of ROWS rows, where instance_ok(RP, ROWS)
template <typename T, int RP, int ROWS>
cudaError_t launch_rows(const Args& args, dim3 grid, int cluster, cudaStream_t s) {
  if constexpr (instance_ok(RP, ROWS)) return launch<T, RP, ROWS>(args, grid, cluster, s);
  return cudaErrorInvalidValue;
}

template <typename T, int RP>
cudaError_t by_rows(int rows, const Args& args, dim3 grid, int cluster, cudaStream_t s) {
  switch (rows) {
    case 1: return launch_rows<T, RP, 1>(args, grid, cluster, s);
    case 2: return launch_rows<T, RP, 2>(args, grid, cluster, s);
    case 4: return launch_rows<T, RP, 4>(args, grid, cluster, s);
    case 8: return launch_rows<T, RP, 8>(args, grid, cluster, s);
    case 16: return launch_rows<T, RP, 16>(args, grid, cluster, s);
    case 32: return launch_rows<T, RP, 32>(args, grid, cluster, s);
    case 64: return launch_rows<T, RP, 64>(args, grid, cluster, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_rank(int rank, int rows, const Args& args, dim3 grid, int cluster,
                    cudaStream_t s) {
  switch (rank) {
    case 8: return by_rows<T, 8>(rows, args, grid, cluster, s);
    case 16: return by_rows<T, 16>(rows, args, grid, cluster, s);
    case 32: return by_rows<T, 32>(rows, args, grid, cluster, s);
    case 64: return by_rows<T, 64>(rows, args, grid, cluster, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One launch over `args->nsites` sites (see Args). dtype: 0 = float32, 1 = bfloat16,
// 2 = float16; rank: the instance (8, 16, 32 or 64, at least args->R); rows: rows of C
// per CTA (1, 2, 4, ..., 64; rows * rank <= 512, and rows <= 4 at rank 32 and 64).
// The grid is (sum of the sites' ctas, row_tiles, B) in clusters of (args->cluster,
// 1, 1). Returns the launch's CUDA error
// (0 = cudaSuccess); the kernel runs asynchronously on `stream`.
int bgmv_launch(int dtype, int rank, int rows, const BgmvArgs* args, void* stream) {
  const Args& a = *args;
  if (a.nsites < 1 || a.nsites > kMaxSites || a.R < 1 || a.R > rank || rank > kMaxRank ||
      !instance_ok(rank, rows) || a.B > kMaxGridYZ || a.row_tiles > kMaxGridYZ ||
      a.cluster < 1 || a.cluster > kMaxCluster || a.row_tiles * rows < a.C ||
      a.d_share * a.cluster < a.Din)
    return (int)cudaErrorInvalidValue;
  const int x_bytes = dtype == 0 ? 4 : 2;
  if (a.d_share % (16 / x_bytes) != 0) return (int)cudaErrorInvalidValue;
  long ctas = 0;
  for (int i = 0; i < a.nsites; ++i) {
    if (a.site[i].ctas < 1 || a.site[i].ctas % a.cluster != 0 || a.site[i].span % kVec)
      return (int)cudaErrorInvalidValue;
    ctas += a.site[i].ctas;
  }
  if (a.B <= 0 || a.C <= 0) return 0;
  if (ctas > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, a.row_tiles, a.B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = by_rank<float>(rank, rows, a, grid, a.cluster, s); break;
    case 1: err = by_rank<__nv_bfloat16>(rank, rows, a, grid, a.cluster, s); break;
    case 2: err = by_rank<__half>(rank, rows, a, grid, a.cluster, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* bgmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
