// Per-page KIVI quantization for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/kv_quant/kv_quant.py:
//   * quantize_pages (:30, body `_kernel` :17, pallas_call :37): pages
//     (NP, P, C) of any float type -> codes (NP, P, C) uint8 and scale / zero
//     planes, (NP, 1, C) when grouped per channel (min/max over the P tokens:
//     keys) or (NP, P, 1) when grouped per token (min/max over the C
//     channels: values). scale = (hi - lo) / (2^bits - 1), 0 replaced by 1;
//     codes = clip(round((x - lo) / scale), 0, 2^bits - 1), rounding half to
//     even; zero = lo. The TPU kernel casts the page to f32 inside itself;
//     so does this one, in registers (exact for bf16 and f16), and it stores
//     the planes as f32 or, for the serving store, rounded once to f16;
//   * dequantize_pages (:60, body `_dekernel` :55, pallas_call :64):
//     codes * scale + zero into f32, bf16 or f16.
//
// Bound on this card (H100 SXM, 3.35 TB/s): HBM bytes. The pack reads each
// input element once (4 or 2 bytes) and writes one code byte plus the
// planes: at (4096, 16, 128) f32 46.1 MB, 13.8 us; bf16 pages with f16
// planes (the serving store's call) 27.3 MB, 8.1 us. The unpack reads one
// byte and writes 2 or 4. The work between is a handful of f32 operations
// per element, so what keeps a kernel from its bound is the latency of each
// warp's chain of loads and operations, and instructions per element:
//   * the pack (quantize_pages_warp_kernel, C = 32/64/128/256): one warp
//     per page, every page's warp in flight at once. A page is one
//     contiguous block of P * C * sizeof(T) bytes: per channel (two passes
//     over the page) lane 0 fetches it with one 1-D bulk copy
//     (cp.async.bulk ... mbarrier::complete_tx::bytes) into the warp's
//     shared memory, so the loads cost no registers; per token (one pass)
//     once every SM has 4 pages, lanes load their 16-byte vectors straight
//     into registers. On the H100, rings of 2-4 pages walked by persistent
//     warps were no faster than a warp for every page. Up to one wave of
//     pages (8 CTAs of 256 threads an SM; a decode step's fill of 256
//     pages) the CTA-per-page kernel (quantize_pages_kernel, 8 warps on
//     each page) ran faster on the H100, so the plan takes it there. The
//     route, grid and warps per CTA come from the wrapper's plan
//     (kv_quant.py::pack_plan);
//   * the vector layout: each lane owns whole 16-byte vectors of a row (4 f32
//     or 8 bf16 / f16 channels, upcast in registers); a warp reads 512
//     contiguous bytes at a time (no shared-memory bank conflicts). Per
//     channel, all lanes share a row and walk the rows, min and max a loop in
//     registers (where a row has fewer than 32 vectors, the lanes split the
//     rows and combine in log2(32 * vec / C) shuffles). Per token, 8 lanes
//     (16 for f32 at C = 256) share a row, which reduces in 3 (4) shuffles;
//   * the codes: (x - lo) / scale is first estimated with the group's
//     correctly rounded reciprocal (estimate_codes), 5 operations and no
//     division; only a vector holding an estimate within 2^-10 of a
//     half-integer, or a group whose scale has no safe reciprocal, is
//     encoded again through the division. The division compiles to a
//     reciprocal, five FMAs and a range check per element, and a zero
//     dividend (each group's minimum) took its slow path: with the estimate
//     the pack beat the parent's kernel on the H100, with the division
//     alone it lost to it;
//   * packed stores: 4 (f32) or 8 (16-bit) codes leave a lane as one word,
//     so a warp writes whole runs of the code page, and a lane's per-channel
//     plane values leave as one vector;
//   * the unpack (dequantize_pages_vec_kernel, C a multiple of 16 and P of
//     4): grid stride over units of 4 rows x the channels of one 16-byte
//     store (4 f32 or 8 bf16 / f16), so a warp's stores are contiguous; a
//     unit's four code loads issue together, its planes load once as
//     float4s, two integer divisions per unit. Any other shape takes the
//     scalar kernels (generic routes).
//
// Byte-equality with the plain versions (kernels/kv_quant/ref.py): min and
// max are exact in any order. Every other step is one IEEE-rounded f32
// operation, (hi - lo) / qmax, x - lo, (x - lo) / scale, code * scale, + zero,
// written with the _rn intrinsics, which nvcc never contracts: a fused
// multiply-add would skip the product's rounding, and a quotient taken as a
// product with the reciprocal may differ from the division in its last bit,
// and either moves a code on a rounding boundary or an output by one ulp.
// So the reciprocal only estimates: the estimate is within 2^-14 of the
// correctly rounded quotient (a group's quotients are at most qmax), so where
// it lies 2^-10 or more from every half-integer the exact quotient rounds to
// the same code, and everywhere else the code comes from the division.
// Rounding to an integer adds 2^23 (a round-half-to-even add, exact for
// 0 <= q < 2^22, like rintf, jnp.round and torch.round) and reads the low
// byte; a code goes back to f32 the same way. Build without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // scalar kernels and the unpack
constexpr int kMaxWarps = 4;
constexpr float kMagic = 8388608.f;  // 2^23
constexpr uint32_t kMagicBits = 0x4B000000u;
constexpr float kNear = 0.5f - 0x1p-10f;  // estimates closer to a half take the division

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ unsigned short bits16(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ unsigned short bits16(__half x) { return __half_as_ushort(x); }

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

// clip(rint((x - lo) / scale), 0, qmax) as an integer in [0, 255]: the
// division, correctly rounded. Clipping first and then rounding gives the
// same integer (qmax is integral), and a NaN quotient clips to 0 either way.
// A zero dividend (the group's minimum) would send the division down its
// slow path; its quotient is 0.
__device__ __forceinline__ uint32_t encode(float x, float lo, float scale, float qmax) {
  const float n = __fsub_rn(x, lo);
  const float d = __fdiv_rn(n == 0.f ? scale : n, scale);
  const float q = fminf(fmaxf(n == 0.f ? 0.f : d, 0.f), qmax);
  return __float_as_uint(__fadd_rn(q, kMagic)) & 0xffu;
}

// The reciprocal a group's codes are estimated with (estimate_codes): 1 / s
// correctly rounded, or NaN where s lies outside [2^-125, 2^125], so that
// every code of the group takes the division.
__device__ __forceinline__ float group_rcp(float s) {
  return s >= 0x1p-125f && s <= 0x1p125f ? __frcp_rn(s) : __uint_as_float(0x7fc00000u);
}

// the code in byte `k` of `w` as an exact f32
__device__ __forceinline__ float code_float(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(kMagicBits | ((w >> (8 * k)) & 0xffu)), kMagic);
}

// 16 bytes of T at `p` (shared or global) as 16 / sizeof(T) floats
template <typename T> struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack16_bf16(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack16_f16(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
    f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[Vec<T>::kN]);
template <>
__device__ __forceinline__ void load_vec<float>(const float* p, float (&f)[4]) {
  unpack16(*reinterpret_cast<const uint4*>(p), f);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16>(const __nv_bfloat16* p,
                                                       float (&f)[8]) {
  unpack16_bf16(*reinterpret_cast<const uint4*>(p), f);
}
template <>
__device__ __forceinline__ void load_vec<__half>(const __half* p, float (&f)[8]) {
  unpack16_f16(*reinterpret_cast<const uint4*>(p), f);
}

// N plane values at `p` (element offset `i`, a multiple of N) as one vector
// store: f32 or, with `f16`, each rounded once to f16
template <int N>
__device__ __forceinline__ void store_planes(void* p, size_t i, const float* v, int f16) {
  if (f16) {
    uint32_t w[N / 2];
#pragma unroll
    for (int k = 0; k < N / 2; ++k)
      w[k] = (uint32_t)__half_as_ushort(__float2half_rn(v[2 * k])) |
             ((uint32_t)__half_as_ushort(__float2half_rn(v[2 * k + 1])) << 16);
    __half* dst = static_cast<__half*>(p) + i;
    if constexpr (N == 8) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    }
  } else {
    float* dst = static_cast<float*>(p) + i;
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(dst + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

__device__ __forceinline__ void store_plane(void* p, size_t i, float v, int f16) {
  if (f16) {
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// ---------------------------------------------------------------- mbarrier + bulk copy
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

// `bytes` (a multiple of 16) from global `src` (16-byte aligned) into shared
// `dst`, completing that many transaction bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------- the pack, a warp per page
// The codes of N values `f` as N / 4 words, estimated: each quotient as
// (x - lo) * r, with r the group's correctly rounded reciprocal, within
// 3 * 2^-24 relative of the exact quotient (under 2^-14 for quotients up to
// 256, a group's largest). Where no estimate of the vector lies within 2^-10
// of a half-integer, every exact quotient rounds to the same integer as its
// estimate; returns whether one does (or the group has no reciprocal,
// r = NaN), and then the caller encodes the vector again by exact_codes.
// That branch is rare (2 in 2^10 values of random data) and kept inline:
// on the H100 noting the vectors and encoding them after the page was
// slower.
// kS: 1 when each value has its own group (lo[e], r[e]), 0 when all share
// lo[0].
template <int N, int kS>
__device__ __forceinline__ bool estimate_codes(const float (&f)[N], const float* lo,
                                               const float* r, uint32_t (&w)[N / 4]) {
  uint32_t c[N];
  bool near = false;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    // 0 <= q < qmax + 2^-14, so rint(q) <= qmax needs no clip, and 2^23 +
    // rint(q) holds it in its low byte
    const float q = __fmul_rn(__fsub_rn(f[e], lo[kS * e]), r[kS * e]);
    const float t = __fadd_rn(q, kMagic);
    near |= !(fabsf(__fsub_rn(q, __fsub_rn(t, kMagic))) < kNear);  // NaN: near
    c[e] = __float_as_uint(t);
  }
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    w[k] = __byte_perm(__byte_perm(c[4 * k], c[4 * k + 1], 0x0040),
                       __byte_perm(c[4 * k + 2], c[4 * k + 3], 0x0040), 0x5410);
  return near;
}

// The same words by the division (encode).
template <int N, int kS>
__device__ __forceinline__ void exact_codes(const float (&f)[N], const float* lo,
                                            const float* s, float qmax, uint32_t (&w)[N / 4]) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    uint32_t c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = encode(f[4 * k + e], lo[kS * (4 * k + e)],
                                              s[kS * (4 * k + e)], qmax);
    w[k] = c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
  }
}

// the words of one lane's codes of a row, at byte `at` of the code page
template <int N>
__device__ __forceinline__ void store_codes(uint8_t* p, const uint32_t (&w)[N / 4]) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// A CTA of blockDim.x / 32 warps, each packing one page: page blockIdx.x *
// warps + warp. With `bulk` the page arrives by one bulk copy into the
// warp's buffer in dynamic shared memory (warps pages, then warps
// mbarriers); else each lane loads its vectors from HBM directly.
// A lane owns whole 16-byte vectors of a row: per channel, all lanes of a
// warp share a row (up to C / vec of them) and walk the rows; per token, 8
// lanes (16 for f32 at C = 256, C / vec where that is fewer) share a row,
// so a row reduces in 3 or 4 shuffle steps.
template <typename T, int C, bool kPerChannel>
__global__ void __launch_bounds__(kMaxWarps * 32) quantize_pages_warp_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ codes, void* __restrict__ scale,
    void* __restrict__ zero, int NP, int P, float qmax, int plane_f16, int bulk) {
  constexpr int kVec = Vec<T>::kN;                  // channels per 16-byte vector
  constexpr int kRowVecs = C / kVec;                // vectors per row
  // lanes sharing a row: per channel all (up to 32), per token 8, or more
  // where a lane would otherwise hold over 4 vectors of a row (f32, C = 256)
  constexpr int kTokenLanes = kRowVecs / 4 > 8 ? kRowVecs / 4 : 8;
  constexpr int kWant = kPerChannel ? 32 : kTokenLanes;
  constexpr int kLanes = kRowVecs < kWant ? kRowVecs : kWant;
  constexpr int kRows = 32 / kLanes;                // rows a warp reads at once
  constexpr int kPer = kRowVecs / kLanes;           // vectors per lane per row
  constexpr int kVals = kVec * kPer;                // values per lane per row
  static_assert(kRowVecs % kLanes == 0, "C must be 32, 64, 128 or 256");

  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const size_t page = (size_t)blockIdx.x * warps + warp;
  if (page >= (size_t)NP) return;  // no CTA-wide barrier below: warps run apart
  const T* tile = x + page * P * C;
  if (bulk) {
    const uint32_t page_bytes = (uint32_t)P * C * sizeof(T);
    unsigned char* buf = smem + (size_t)warp * page_bytes;
    const uint32_t bar = smem_u32(smem + (size_t)warps * page_bytes) + 8u * warp;
    if (lane == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(bar, page_bytes);
      bulk_load(smem_u32(buf), tile, page_bytes, bar);
    }
    __syncwarp();
    mbar_wait(bar, 0);
    tile = reinterpret_cast<const T*>(buf);
  }
  uint8_t* cp = codes + page * P * C;
  const int col = lane % kLanes;  // this lane's vectors: col + j * kLanes
  const int r0 = lane / kLanes;   // in rows r0, r0 + kRows, ...

  if constexpr (kPerChannel) {
    // keys: a group is one channel's P tokens
    float lo[kVals], hi[kVals];
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      lo[i] = __uint_as_float(0x7f800000u);  // +inf
      hi[i] = __uint_as_float(0xff800000u);  // -inf
    }
#pragma unroll(kVals == 4 ? 4 : 2)  // 8 values a lane: registers
    for (int r = r0; r < P; r += kRows) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float f[kVec];
        load_vec<T>(tile + r * C + (col + j * kLanes) * kVec, f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          lo[j * kVec + e] = fminf(lo[j * kVec + e], f[e]);
          hi[j * kVec + e] = fmaxf(hi[j * kVec + e], f[e]);
        }
      }
    }
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < kVals; ++i) {
        lo[i] = fminf(lo[i], __shfl_xor_sync(0xffffffffu, lo[i], o));
        hi[i] = fmaxf(hi[i], __shfl_xor_sync(0xffffffffu, hi[i], o));
      }
    }
    float sc[kVals], rc[kVals];
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      sc[i] = group_scale(lo[i], hi[i], qmax);
      rc[i] = group_rcp(sc[i]);
    }
    if (r0 == 0) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const size_t at = page * C + (size_t)(col + j * kLanes) * kVec;
        store_planes<kVec>(scale, at, sc + j * kVec, plane_f16);
        store_planes<kVec>(zero, at, lo + j * kVec, plane_f16);
      }
    }
#pragma unroll(kVals == 4 ? 2 : 1)
    for (int r = r0; r < P; r += kRows) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c0 = (col + j * kLanes) * kVec;
        float f[kVec];
        load_vec<T>(tile + r * C + c0, f);
        uint32_t w[kVec / 4];
        if (estimate_codes<kVec, 1>(f, lo + j * kVec, rc + j * kVec, w))
          exact_codes<kVec, 1>(f, lo + j * kVec, sc + j * kVec, qmax, w);
        store_codes<kVec>(cp + r * C + c0, w);
      }
    }
  } else {
    // values: a group is one token's C channels
    for (int rb = 0; rb < P; rb += kRows) {
      const int r = rb + r0;
      const bool live = r < P;
      const int rr = live ? r : P - 1;  // spare lanes shadow the last row
      float f[kPer][kVec];
      float lo = __uint_as_float(0x7f800000u), hi = __uint_as_float(0xff800000u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        load_vec<T>(tile + rr * C + (col + j * kLanes) * kVec, f[j]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          lo = fminf(lo, f[j][e]);
          hi = fmaxf(hi, f[j][e]);
        }
      }
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      const float sc = group_scale(lo, hi, qmax);
      const float rc = group_rcp(sc);
      if (!live) continue;
      if (col == 0) {
        store_plane(scale, page * P + r, sc, plane_f16);
        store_plane(zero, page * P + r, lo, plane_f16);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        uint32_t w[kVec / 4];
        if (estimate_codes<kVec, 0>(f[j], &lo, &rc, w))
          exact_codes<kVec, 0>(f[j], &lo, &sc, qmax, w);
        store_codes<kVec>(cp + r * C + (col + j * kLanes) * kVec, w);
      }
    }
  }
}

// ---------------------------------------------------------------- the pack, generic route
// Any C, and any C up to one wave of pages: one CTA per page, as the TPU
// grid has one step per page. Per channel, one thread per channel walks the
// P tokens; per token, one warp per token, lanes split the channels. With
// few pages its 8 warps a page keep more loads in flight than one warp a
// page does.
template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_pages_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ codes, void* __restrict__ scale,
    void* __restrict__ zero, int P, int C, float qmax, int per_channel, int plane_f16) {
  constexpr int kWarps = kThreads / 32;
  const size_t page = blockIdx.x;
  const T* xp = x + page * P * C;
  uint8_t* cp = codes + page * P * C;
  if (per_channel) {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float lo = to_float(xp[c]), hi = lo;
      for (int t = 1; t < P; ++t) {
        const float v = to_float(xp[t * C + c]);
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
      const float s = group_scale(lo, hi, qmax);
      store_plane(scale, page * C + c, s, plane_f16);
      store_plane(zero, page * C + c, lo, plane_f16);
      for (int t = 0; t < P; ++t) cp[t * C + c] = (uint8_t)encode(to_float(xp[t * C + c]), lo, s, qmax);
    }
  } else {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int t = warp; t < P; t += kWarps) {
      const T* row = xp + t * C;
      float lo = to_float(row[0]), hi = lo;
      for (int c = lane; c < C; c += 32) {
        lo = fminf(lo, to_float(row[c]));
        hi = fmaxf(hi, to_float(row[c]));
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      const float s = group_scale(lo, hi, qmax);
      if (lane == 0) {
        store_plane(scale, page * P + t, s, plane_f16);
        store_plane(zero, page * P + t, lo, plane_f16);
      }
      for (int c = lane; c < C; c += 32) cp[t * C + c] = (uint8_t)encode(to_float(row[c]), lo, s, qmax);
    }
  }
}

// ---------------------------------------------------------------- the unpack
constexpr int kUnpackRows = 4;  // rows of one column group a thread takes

// C a multiple of 16, P of kUnpackRows: grid-stride over units of V
// channels x kUnpackRows rows of one page, V = 16 / sizeof(T) so that each
// row of a unit leaves as one 16-byte store and a warp's stores are
// contiguous. A unit's code loads (4 or 8 bytes a row) issue together, its
// planes load once (per channel: V scales and zeros as float4s, per token:
// one float4 each of the 4 rows').
template <typename T, bool kPerChannel>
__global__ void __launch_bounds__(kThreads) dequantize_pages_vec_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ scale,
    const float* __restrict__ zero, T* __restrict__ out, uint32_t units, uint32_t cols,
    uint32_t P) {
  constexpr int V = 16 / sizeof(T);
  const uint32_t per_page = P / kUnpackRows * cols;  // units per page
  const uint32_t C = cols * V;
  for (uint32_t u = blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += gridDim.x * blockDim.x) {
    const uint32_t page = u / per_page, rest = u - page * per_page;
    const uint32_t rb = rest / cols, cg = rest - rb * cols;
    const size_t at = ((size_t)page * P + rb * kUnpackRows) * C + cg * V;
    uint32_t cw[kUnpackRows][V / 4];
#pragma unroll
    for (int i = 0; i < kUnpackRows; ++i) {
      if constexpr (V == 4) {
        cw[i][0] = __ldg(reinterpret_cast<const unsigned int*>(codes + at + (size_t)i * C));
      } else {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(codes + at + (size_t)i * C));
        cw[i][0] = w.x;
        cw[i][1] = w.y;
      }
    }
    float s[kUnpackRows][V], z[kUnpackRows][V];
    if constexpr (kPerChannel) {
      const size_t pc = (size_t)page * C + cg * V;
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(scale + pc) + q);
        const float4 b = __ldg(reinterpret_cast<const float4*>(zero + pc) + q);
        const float sa[4] = {a.x, a.y, a.z, a.w}, za[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kUnpackRows; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[i][4 * q + e] = sa[e];
            z[i][4 * q + e] = za[e];
          }
        }
      }
    } else {
      const size_t row = (size_t)page * P + rb * kUnpackRows;
      const float4 a = __ldg(reinterpret_cast<const float4*>(scale + row));
      const float4 b = __ldg(reinterpret_cast<const float4*>(zero + row));
      const float sa[4] = {a.x, a.y, a.z, a.w}, za[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kUnpackRows; ++i) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s[i][e] = sa[i];
          z[i][e] = za[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kUnpackRows; ++i) {
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = __fadd_rn(__fmul_rn(code_float(cw[i][e / 4], e % 4), s[i][e]), z[i][e]);
      T* dst = out + at + (size_t)i * C;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
        uint32_t p[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          p[k] = (uint32_t)bits16(from_float<T>(o[2 * k])) |
                 ((uint32_t)bits16(from_float<T>(o[2 * k + 1])) << 16);
        *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
      }
    }
  }
}

// Any C: one CTA per page, one element per thread step.
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

// ---------------------------------------------------------------- launch helpers
struct PackArgs {
  const void* x;
  void* codes;
  void* scale;
  void* zero;
  int NP, P, C, per_channel, plane_f16, warps, bulk, grid;
  float qmax;
};

template <typename T, int C, bool kPerChannel>
int launch_warp(const PackArgs& a, cudaStream_t stream) {
  auto kernel = quantize_pages_warp_kernel<T, C, kPerChannel>;
  const size_t smem = (size_t)a.warps * a.bulk * ((size_t)a.P * C * sizeof(T) + 8);
  if (smem > 48 * 1024) {
    // the opt-in above 48 KB, once per device and size
    static size_t set[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64 || set[dev] < smem) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev >= 0 && dev < 64) set[dev] = smem;
    }
  }
  kernel<<<a.grid, a.warps * 32, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<uint8_t*>(a.codes), a.scale, a.zero, a.NP,
      a.P, a.qmax, a.plane_f16, a.bulk);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int launch_warp_axis(const PackArgs& a, cudaStream_t stream) {
  return a.per_channel ? launch_warp<T, C, true>(a, stream) : launch_warp<T, C, false>(a, stream);
}

template <typename T>
int launch_pack(const PackArgs& a, int route, cudaStream_t stream) {
  if (route == 1) {
    quantize_pages_kernel<T><<<a.NP, kThreads, 0, stream>>>(
        static_cast<const T*>(a.x), static_cast<uint8_t*>(a.codes), a.scale, a.zero, a.P,
        a.C, a.qmax, a.per_channel, a.plane_f16);
    return (int)cudaGetLastError();
  }
  if (route != 0 || a.warps < 1 || a.warps > kMaxWarps || a.grid < 1 ||
      (size_t)a.grid * a.warps < (size_t)a.NP)
    return (int)cudaErrorInvalidValue;
  switch (a.C) {
    case 32: return launch_warp_axis<T, 32>(a, stream);
    case 64: return launch_warp_axis<T, 64>(a, stream);
    case 128: return launch_warp_axis<T, 128>(a, stream);
    case 256: return launch_warp_axis<T, 256>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_unpack(const uint8_t* c, const float* s, const float* z, void* out, int NP, int P,
                  int C, int per_channel, int route, int grid, cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  if (route == 1) {
    dequantize_pages_kernel<T><<<NP, kThreads, 0, stream>>>(c, s, z, o, P, C, per_channel);
    return (int)cudaGetLastError();
  }
  if (route != 0 || C % 16 != 0 || P % kUnpackRows != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const uint32_t per_row = 16 / sizeof(T);  // V, codes of one 16-byte store
  const uint32_t units = (uint32_t)((size_t)NP * P * C / (per_row * kUnpackRows));
  const uint32_t cols = (uint32_t)(C / per_row);
  if (per_channel) {
    dequantize_pages_vec_kernel<T, true><<<grid, kThreads, 0, stream>>>(c, s, z, o, units,
                                                                         cols, (uint32_t)P);
  } else {
    dequantize_pages_vec_kernel<T, false><<<grid, kThreads, 0, stream>>>(c, s, z, o, units,
                                                                          cols, (uint32_t)P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (NP, P, C) of in_dtype (0 = float32, 1 = bfloat16, 2 = float16) ->
// codes (NP, P, C) uint8, scale and zero planes of (NP, 1, C) when
// per_channel, else (NP, P, 1), float32 or (plane_f16) float16. route 0:
// the warp kernel (C = 32/64/128/256; x 16-byte aligned), one warp per page
// on `grid` CTAs of `warps` warps (grid * warps >= NP), each page by a bulk
// copy (`bulk`) or by direct loads; route 1: the generic kernel, one CTA per
// page. Returns the launch's CUDA error (0 = cudaSuccess); the kernel runs
// asynchronously on `stream`.
int kv_quantize_pages_launch(int in_dtype, int plane_f16, const void* x, void* codes,
                             void* scale, void* zero, int NP, int P, int C, int bits,
                             int per_channel, int route, int warps, int bulk, int grid,
                             void* stream) {
  if (NP <= 0) return 0;
  const PackArgs a{x, codes, scale, zero, NP, P, C, per_channel, plane_f16, warps, bulk,
                   grid, (float)((1 << bits) - 1)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0: return launch_pack<float>(a, route, s);
    case 1: return launch_pack<__nv_bfloat16>(a, route, s);
    case 2: return launch_pack<__half>(a, route, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out_dtype: 0 = float32, 1 = bfloat16, 2 = float16. route 0: the vector
// kernel (C a multiple of 16, 16-byte aligned bases) on `grid` CTAs; route
// 1: the scalar kernel, one CTA per page.
int kv_dequantize_pages_launch(int out_dtype, const void* codes, const void* scale,
                               const void* zero, void* out, int NP, int P, int C,
                               int per_channel, int route, int grid, void* stream) {
  if (NP <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zero);
  switch (out_dtype) {
    case 0: return launch_unpack<float>(c, sc, z, out, NP, P, C, per_channel, route, grid, s);
    case 1:
      return launch_unpack<__nv_bfloat16>(c, sc, z, out, NP, P, C, per_channel, route, grid, s);
    case 2: return launch_unpack<__half>(c, sc, z, out, NP, P, C, per_channel, route, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kv_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
