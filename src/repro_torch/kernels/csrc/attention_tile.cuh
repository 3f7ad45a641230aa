// The bf16 attention tile loop on Hopper's tensor cores (sm_90a), shared by
// flash_attention.cu (K2, prefill) and decode_attention_paged.cu (K3 at
// admission).  Each file stages its own tiles in shared memory (TMA for
// contiguous K/V, cp.async gathers for pages); this header holds what runs
// on them once they are there.
//
// One consumer warpgroup (128 threads) owns BQ = 64 query rows that share a
// KV head.  For each KV tile of BK = 64 positions it runs
//   S = Q K^T       wgmma m64n64k16, Q and K from shared memory (K-major),
//   fp32 online softmax in registers (row max and sum over the 4 lanes of
//                   a row; the mask is the caller's, masked scores -1e30),
//   O += P V        wgmma m64nDk16, P converted to bf16 in registers as the
//                   A operand, V from shared memory as a transposed
//                   (MN-major) B operand,
// and keeps O (D/2 floats a thread), the row max and the row sum in
// registers.  Exponentials are base 2 with log2(e) folded into the scale;
// that leaves -1e30 sentinels and -inf keys as they are (exp2 of 0 is 1, of
// -1e30 is 0), so a row's result equals the base-e softmax of the plain
// version up to fp32 rounding.
//
// Shared-memory layout of a (64 rows x D) bf16 tile (Q, K and V alike): D is
// cut into panels of PW = SW / 2 elements (SW = 128 bytes, or 64 for
// D = 32); a panel holds all 64 rows, row r at r * SW bytes, with the
// swizzle TMA's CU_TENSOR_MAP_SWIZZLE_{128,64}B writes (16-byte chunk c of
// row r lands at chunk c ^ (r mod 8) for 128 B; ^ ((r / 2) mod 4) for 64 B).
// Tiles start on 1024-byte boundaries.  wgmma descriptors:
//   K-major (Q, K): start + 32 bytes per k16 step inside a panel, SBO = 8
//                   rows (8 * SW bytes), LBO unused;
//   MN-major (V):   start + 16 rows per k16 step, LBO = one panel
//                   (64 * SW bytes, the next PW columns of D), SBO = 8 rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr int BQ = 64;   // query rows per consumer warpgroup
constexpr int BK = 64;   // key positions per KV tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int swizzle_bytes(int D) { return D >= 64 ? 128 : 64; }
// bytes of one (64 x D) bf16 tile
__host__ __device__ constexpr int tile_bytes(int D) { return BK * D * 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col) in a swizzled (64 x D) tile; col % 8 == 0
// (a 16-byte chunk).
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  constexpr int SW = swizzle_bytes(D), PW = SW / 2;
  const uint32_t o = row * SW + (col % PW) * 2;
  return (col / PW) * (BK * SW) + (o ^ (((o >> 7) & (SW / 16 - 1)) << 4));
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 fills zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Make this thread's generic-proxy writes to shared memory (plain stores,
// cp.async) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  constexpr int SW = swizzle_bytes(D);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)((8 * SW) >> 4) << 32) | ((uint64_t)(SW == 128 ? 1 : 2) << 62);
}
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  constexpr int SW = swizzle_bytes(D);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((BK * SW) >> 4) << 16)
         | ((uint64_t)((8 * SW) >> 4) << 32) | ((uint64_t)(SW == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving register reads or writes across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define TILE_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TILE_F16(d, i) TILE_F4(d, i), TILE_F4(d, i + 4), TILE_F4(d, i + 8), TILE_F4(d, i + 12)

// S (64 x 64, fp32) += A (64 x 16) B (16 x 64)^T, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : TILE_F16(d, 0), TILE_F16(d, 16)
      : "l"(da), "l"(db));
}

// O (64 x N, fp32) += A (64 x 16, bf16 registers) B (16 x N), B from shared
// memory, MN-major (transposed).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : TILE_F16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TILE_F16(d, 0), TILE_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TILE_F16(d, 0), TILE_F16(d, 16), TILE_F16(d, 32), TILE_F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef TILE_F16
#undef TILE_F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A warpgroup's running attention state for its 64 rows.  Thread t of the
// warpgroup holds rows row(0) = 16 * (t / 32) + (t % 32) / 4 and row(1) =
// row(0) + 8; o[4j + e] is column 8j + 2 (t % 4) + (e & 1) of row(e >> 1),
// as the wgmma accumulator lays it out (S has the same layout over 64 columns).
template <int D>
struct Tile {
  float o[D / 2];
  float m[2];   // running row max (base-2 scaled scores)
  float l[2];   // this thread's part of the running row sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }
  __device__ __forceinline__ static int row(int h) {
    const int t = threadIdx.x % 128;
    return 16 * (t / 32) + (t % 32) / 4 + 8 * h;
  }
  __device__ __forceinline__ static int col(int j, int e) {
    return 8 * j + 2 * (threadIdx.x % 4) + (e & 1);
  }

  // One KV tile: sq, sk, sv are the shared addresses of this warpgroup's Q
  // tile and the stage's K and V tiles; mask(h, row(h), col, x) returns the
  // scaled score x, -1e30 where the position is masked, or -inf where it
  // does not exist.
  template <class Mask>
  __device__ __forceinline__ void step(uint32_t sq, uint32_t sk, uint32_t sv, float scale_log2,
                                       Mask mask) {
    constexpr int SW = swizzle_bytes(D), PW = SW / 2;
    __syncwarp();  // wgmma is .aligned: the warp's threads issue it together
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const uint32_t off = (k * 16 / PW) * (BK * SW) + (k * 16 % PW) * 2;
      wgmma_ss_n64(s, desc_k_major<D>(sq + off), desc_k_major<D>(sk + off));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = mask(e >> 1, row(e >> 1), col(j, e), s[4 * j + e] * scale_log2);
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - m[e >> 1]);
        s[4 * j + e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];

    // P as the A operand: k16 step ks covers S columns 16 ks .. 16 ks + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[ks][i] = pack_bf16(s[8 * ks + 2 * i], s[8 * ks + 2 * i + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs<D>(o, pa[ks], desc_mn_major<D>(sv + ks * 16 * SW));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
  }

  // Finish the row sums over the 4 lanes of each row; store(h, row(h), col,
  // a, b) receives columns col and col + 1 of a row, normalised.  A row that never
  // saw a position keeps m = -1e30 (the caller may replace its output).
  template <class Store>
  __device__ __forceinline__ void finish(Store store) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = 1.f / fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(h, row(h), col(j, 0), o[4 * j + 2 * h] * l[h], o[4 * j + 2 * h + 1] * l[h]);
  }
};

}  // namespace tile
