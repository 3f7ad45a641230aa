// The bf16 attention tile loop on Hopper's tensor cores (sm_90a), shared by
// flash_attention.cu (K2, prefill), decode_attention.cu (K1, dense decode and
// verify) and decode_attention_paged.cu (K3, paged admission, decode and
// verify), with what stages its tiles: TMA and mbarriers for the contiguous
// K/V of K1 and K2, K3's cp.async page walk.  K1 and K3 also share the query
// load of one KV head's rows, the split-KV arithmetic and the combine of the
// splits.
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
// Split-KV (K1, K3).  A (KV head, batch row, query tile) whose blocks would
// not fill the card is cut into n_split static, equal ranges of the row's
// 64-position tiles (over S, or over P*ps for pages: cache lengths live on
// the device, so the host cannot cut by them); each split is one block, and
// the splits of a query tile form one thread-block cluster.  A block walks
// the tiles of its range that its rows can see, then writes its unnormalised
// O, row max m and row sum l to its own shared memory (m = -inf marks a
// split that walked no tile); after a cluster barrier each block combines a
// share of the rows' columns from every split's shared memory (distributed
// shared memory):  M = max m_i,  O = sum 2^(m_i - M) O_i / sum 2^(m_i - M) l_i,
// skipping the marked splits.  A row whose every split scored only -1e30
// keeps M = -1e30 and gets equal weights: the mean of V over every slot
// its splits walked, as the plain version's uniform softmax (K1); K3
// replaces such a row by its mean of V over the table.  The cluster takes
// the place of a workspace in device memory, of a second kernel for the
// combine and of a last-block-done ticket: nothing to allocate, size or
// zero, one launch a call, no atomics.  It caps n_split at the portable
// cluster size, 8.
//
// Head dims that are not a whole number of panels (h2o-danube's D = 120)
// run at the padded width DP = tile_dim(D) (128), the columns past D zeros:
// TMA fills them from outside the tensor (a 4-D map over (B, S, K, D), so
// the last panel never reaches into the next KV head), the Q load and K3's
// gather with cp.async's zero fill.  The zeros add nothing to Q K^T; P V
// makes DP columns and only the first D are stored.  The softmax scale is
// the caller's, from the real D.
//
// Shared-memory layout of a (64 rows x DP) bf16 tile (Q, K and V alike): DP
// is cut into panels of PW = SW / 2 elements (SW = 128 bytes, or 64 for
// D = 32); a panel holds all 64 rows, row r at r * SW bytes, with the
// swizzle TMA's CU_TENSOR_MAP_SWIZZLE_{128,64}B writes (16-byte chunk c of
// row r lands at chunk c ^ (r mod 8) for 128 B; ^ ((r / 2) mod 4) for 64 B).
// Tiles start on 1024-byte boundaries.  wgmma descriptors:
//   K-major (Q, K): start + 32 bytes per k16 step inside a panel, SBO = 8
//                   rows (8 * SW bytes), LBO unused;
//   MN-major (V):   start + 16 rows per k16 step, LBO = one panel
//                   (64 * SW bytes, the next PW columns of D), SBO = 8 rows.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile {

constexpr int BQ = 64;   // query rows per consumer warpgroup
constexpr int BK = 64;   // key positions per KV tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int swizzle_bytes(int D) { return D >= 64 ? 128 : 64; }
// D padded to a whole number of swizzle panels: the width of every tile
__host__ __device__ constexpr int tile_dim(int D) {
  return (D + swizzle_bytes(D) / 2 - 1) / (swizzle_bytes(D) / 2) * (swizzle_bytes(D) / 2);
}
// bytes of one (64 x DP) bf16 tile
__host__ __device__ constexpr int tile_bytes(int D) { return BK * tile_dim(D) * 2; }

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
// 4-byte asynchronous copy global -> shared (through L1).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // at most N of this thread's newest copy groups still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }
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
template <int N>  // at most N of this warpgroup's newest wgmma groups still in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait0() { wgmma_wait<0>(); }
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

// Issue s (64 x 64, fp32) += A B^T over the DP columns of two (64 x DP)
// tiles at shared addresses a and b, both K-major (S = Q K^T).  The caller
// fences, commits and waits.
template <int D>
__device__ __forceinline__ void ss_product(float (&s)[32], uint32_t a, uint32_t b) {
  constexpr int SW = swizzle_bytes(D), PW = SW / 2;
#pragma unroll
  for (int k = 0; k < tile_dim(D) / 16; ++k) {
    const uint32_t off = (k * 16 / PW) * (BK * SW) + (k * 16 % PW) * 2;
    wgmma_ss_n64(s, desc_k_major<D>(a + off), desc_k_major<D>(b + off));
  }
}

// A 64 x 64 fp32 accumulator (Tile's layout) as bf16 A fragments, one for
// each k16 step over its columns: step ks covers columns 16 ks .. 16 ks + 15.
__device__ __forceinline__ void pack_frags(uint32_t (&f)[4][4], const float (&a)[32]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[ks][i] = pack_bf16(a[8 * ks + 2 * i], a[8 * ks + 2 * i + 1]);
}

// Issue o (64 x DP, fp32) += F B: F the A fragments of four k16 steps, B the
// (64 x DP) tile at shared address b, read MN-major (O += P V).  The caller
// fences, commits and waits.
template <int D>
__device__ __forceinline__ void rs_product(float (&o)[tile_dim(D) / 2], const uint32_t (&f)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs<tile_dim(D)>(o, f[ks], desc_mn_major<D>(b + ks * 16 * swizzle_bytes(D)));
}

// A warpgroup's running attention state for its 64 rows.  Thread t of the
// warpgroup holds rows row(0) = 16 * (t / 32) + (t % 32) / 4 and row(1) =
// row(0) + 8; o[4j + e] is column 8j + 2 (t % 4) + (e & 1) of row(e >> 1),
// as the wgmma accumulator lays it out (S has the same layout over 64
// columns).  O spans the padded width DP; columns D .. DP - 1 stay 0.
template <int D>
struct Tile {
  static constexpr int DP = tile_dim(D);
  float o[DP / 2];
  float m[2];   // running row max (base-2 scaled scores)
  float l[2];   // this thread's part of the running row sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
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
    __syncwarp();  // wgmma is .aligned: the warp's threads issue it together
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    ss_product<D>(s, sq, sk);
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
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];

    uint32_t pa[4][4];  // P as the A operand
    pack_frags(pa, s);
    fence_regs(o);
    wgmma_fence();
    rs_product<D>(o, pa, sv);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
  }

  // Finish the row sums over the 4 lanes of each row; store(h, row(h), col,
  // a, b) receives columns col and col + 1 < D of a row, normalised.  A row
  // that never saw a position keeps m = -1e30 (the caller may replace its output).
  template <class Store>
  __device__ __forceinline__ void finish(Store store) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = 1.f / fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (D == DP || col(j, 0) < D)
          store(h, row(h), col(j, 0), o[4 * j + 2 * h] * l[h], o[4 * j + 2 * h + 1] * l[h]);
  }
};

// ------------------------------------------------------ TMA (K1, K2 K/V tiles)

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// Box (column c, KV head kh, position s, batch row b) of a kv_map.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int kh, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(kh), "r"(s),
         "r"(b)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A tensor map over k or v (B, S, K, D) bf16 whose box is one swizzle panel
// (PW columns) of one KV head at 64 positions; positions past S, and columns
// past D in the last panel of a padded tile, arrive as zeros.
template <int D>
bool kv_map(CUtensorMap* map, const void* ptr, int B, int S, int K) {
  constexpr int SW = swizzle_bytes(D);
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)K * D * 2,
                                 (cuuint64_t)S * K * D * 2};
  const cuuint32_t box[4] = {SW / 2, 1, BK, 1}, one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------- K1 and K3: split-KV

constexpr int STAGES = 3;          // K/V tiles a block has staged or in flight
constexpr int RING = STAGES + 1;   // rows of per-tile slot (and position) indices
constexpr int MAX_SPLIT = 8;       // splits of a query tile: the portable cluster size
constexpr int FILL = 1;            // blocks per SM the split count aims for

// Byte offsets from the 1024-aligned base of a K1/K3 block's dynamic shared
// memory: WGS Q tiles; the K/V stages; K3's pool rows a tile (walk's ring);
// K1's positions, a row a stage; K1's mbarriers, one a stage; four per-row
// arrays for the combine (m, l, then M and 1/L); K3's mean of V.
template <int D, int WGS>
struct Layout {
  static constexpr uint32_t kv = WGS * tile_bytes(D);
  static constexpr uint32_t slot = kv + STAGES * 2 * tile_bytes(D);  // int [RING][BK]
  static constexpr uint32_t pos = slot + RING * BK * 4;              // int [RING][BK]
  static constexpr uint32_t bar = pos + RING * BK * 4;               // uint64 [STAGES]
  static constexpr uint32_t rows = bar + STAGES * 8;                 // float [4][WGS * BQ]
  static constexpr uint32_t mean = rows + 4 * WGS * BQ * 4;          // float [D]
  static constexpr size_t bytes = 1024 + mean + D * 4;
  static_assert(WGS <= STAGES, "the combine keeps each split's O in the K/V stages");
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + (((smem_u32(raw) + 1023) & ~1023u) - smem_u32(raw));
}

inline int sm_count() {
  static int n[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (!n[dev]) cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

// Tiles a split of n_tiles walks (the last split may walk fewer).
__host__ __device__ __forceinline__ int split_span(int n_tiles, int n_split) {
  return (n_tiles + n_split - 1) / n_split;
}

// The split count of a launch whose `blocks` query tiles walk n_tiles KV
// tiles each: as many as keep the launch to FILL blocks on every SM (one
// wave: a second, partial wave would cost a whole block's time), at most
// one split a tile and MAX_SPLIT, then evened so that every split's range
// holds a tile.
inline int split_count(int blocks, int n_tiles) {
  if (n_tiles <= 1) return 1;
  int s = FILL * sm_count() / blocks;
  s = s < 1 ? 1 : s;
  s = s < n_tiles ? s : n_tiles;
  s = s < MAX_SPLIT ? s : MAX_SPLIT;
  return split_span(n_tiles, split_span(n_tiles, s));
}

// Launch the K1/K3 kernel Kern: n_split blocks of a query tile side by side
// along x, as one cluster when n_split > 1 (else a plain launch).  smem is
// the kernel's fixed Layout size; its opt-in is set on the first call.
template <auto Kern, class... A>
cudaError_t launch_split(dim3 grid, int threads, size_t smem, int n_split, cudaStream_t stream,
                         A... args) {
  static const cudaError_t e =
      cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = n_split > 1 ? 1 : 0;
  const cudaError_t l = cudaLaunchKernelEx(&cfg, Kern, args...);
  return l != cudaSuccess ? l : cudaGetLastError();
}

// Query rows r0 .. r0 + 64 * WGS - 1 of KV head kh into the WGS Q tiles at
// sq: row r = t * G + g is query head kh * G + g of token t; rows past
// n_tok * G, and columns past D, are zeros.  One cp.async group.
template <int D, int WGS>
__device__ __forceinline__ void load_q(uint32_t sq, const __nv_bfloat16* __restrict__ q, int b,
                                       int n_tok, int H, int G, int kh, int r0) {
  constexpr int CH = tile_dim(D) / 8;
  const int TG = n_tok * G;
  for (int i = threadIdx.x; i < BQ * WGS * CH; i += 128 * WGS) {
    const int r = r0 + i / CH, c = i % CH * 8, rr = min(r, TG - 1);
    cp_async16(sq + (i / CH / BQ) * tile_bytes(D) + tile_offset<D>(i / CH % BQ, c),
               q + (((size_t)b * n_tok + rr / G) * H + kh * G + rr % G) * D + min(c, D - 8),
               r < TG && c < D ? 16 : 0);
  }
  cp_async_commit();
}

// K3's walk over n KV tiles of gathered pages, STAGES in flight (load_q's
// group must come first).
// slots(i, ring), run by threads < BK, writes tile i's pool rows to
// slot[ring][tid] (-1: not read; zeros arrive instead), and whatever else its
// mask needs; every thread then gathers the tile's K and V rows
// (kp/vp + row * row_stride + head_off) with 16-byte cp.async copies into the
// swizzled layout wgmma reads (columns past D as zeros).  mask(i, ring, h, c,
// x) is Tile::step's mask for column c of tile i.
template <int D, int WGS, class Slots, class Mask>
__device__ __forceinline__ void walk(Tile<D>& t, unsigned char* sm, int n,
                                     const __nv_bfloat16* __restrict__ kp,
                                     const __nv_bfloat16* __restrict__ vp, size_t row_stride,
                                     size_t head_off, float scale_log2, Slots slots, Mask mask) {
  using L = Layout<D, WGS>;
  constexpr int TB = tile_bytes(D), NT = 128 * WGS, CH = tile_dim(D) / 8;
  const int* sslot = reinterpret_cast<const int*>(sm + L::slot);
  const uint32_t sq = smem_u32(sm), skv = sq + L::kv;
  const int tid = threadIdx.x, wg = tid / 128;
  auto load = [&](int i) {
    const int* sl = sslot + (i % RING) * BK;
    const uint32_t st = skv + (i % STAGES) * 2 * TB;
    for (int e = tid; e < BK * CH; e += NT) {
      const int j = e / CH, c = e % CH * 8, row = sl[j], nb = row >= 0 && c < D ? 16 : 0;
      const size_t at = (size_t)max(row, 0) * row_stride + head_off + min(c, D - 8);
      const uint32_t off = tile_offset<D>(j, c);
      cp_async16(st + off, kp + at, nb);
      cp_async16(st + TB + off, vp + at, nb);
    }
  };
  if (tid < BK)
    for (int i = 0; i < STAGES && i < n; ++i) slots(i, i % RING);
  __syncthreads();  // slot rows of the first tiles written
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i (and the Q tiles) landed
    fence_async_smem();
    __syncthreads();              // ... for every thread; tile i - 1 consumed
    if (i + STAGES - 1 < n) load(i + STAGES - 1);
    cp_async_commit();
    if (tid < BK && i + STAGES < n) slots(i + STAGES, (i + STAGES) % RING);
    const uint32_t st = skv + (i % STAGES) * 2 * TB;
    const int ring = i % RING;
    t.step(sq + wg * TB, st, st + TB, scale_log2,
           [&](int h, int, int c, float x) { return mask(i, ring, h, c, x); });
  }
  cp_async_wait<0>();
}

// Write the block's rows 0 .. nr - 1 (row wg * 64 + r is row r of warpgroup
// wg's tile).  One split: from the registers.  Several: the combine of the
// header note over the cluster's shared memory, each block storing every
// n_split-th chunk of the rows' columns.  nothing() runs on every thread of
// the block before its stores when one of its rows saw no position
// (M <= -1e30); store(r, c, x0, x1, M) receives columns c and c + 1 of row r
// and the row's M.
template <int D, int WGS, class Nothing, class Store>
__device__ __forceinline__ void finish_rows(Tile<D>& t, unsigned char* sm, int nr, int n_split,
                                            bool walked, Nothing nothing, Store store) {
  using L = Layout<D, WGS>;
  constexpr int NT = 128 * WGS, N = WGS * BQ, DP = tile_dim(D);
  const int tid = threadIdx.x, wg = tid / 128;
  if (n_split == 1) {
    bool none = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) none |= wg * BQ + Tile<D>::row(h) < nr && t.m[h] == NEG_INF;
    if (__syncthreads_or(none)) {
      nothing();
      __syncthreads();
    }
    t.finish([&](int h, int r, int c, float x0, float x1) {
      if (wg * BQ + r < nr) store(wg * BQ + r, c, x0, x1, t.m[h]);
    });
    return;
  }
  float* po = reinterpret_cast<float*>(sm + L::kv);  // [N][DP] unnormalised O
  float* pm = reinterpret_cast<float*>(sm + L::rows);
  float *pl = pm + N, *sM = pl + N, *sL = sM + N;
  __syncthreads();  // every warpgroup's last product has read the stages
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    t.l[h] += __shfl_xor_sync(0xffffffffu, t.l[h], 1);
    t.l[h] += __shfl_xor_sync(0xffffffffu, t.l[h], 2);
    const int r = wg * BQ + Tile<D>::row(h);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<float2*>(po + r * DP + Tile<D>::col(j, 0)) =
          make_float2(t.o[4 * j + 2 * h], t.o[4 * j + 2 * h + 1]);
    if (tid % 4 == 0) {
      pm[r] = walked ? t.m[h] : -INFINITY;  // -inf: an empty split, skipped
      pl[r] = t.l[h];
    }
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();  // every split's partials written
  for (int r = tid; r < nr; r += NT) {
    float M = -INFINITY, sum = 0.f;
    for (int k = 0; k < n_split; ++k) M = fmaxf(M, cluster.map_shared_rank(pm, k)[r]);
    for (int k = 0; k < n_split; ++k) {
      const float mk = cluster.map_shared_rank(pm, k)[r];
      if (mk != -INFINITY) sum += exp2f(mk - M) * cluster.map_shared_rank(pl, k)[r];
    }
    sM[r] = M;
    sL[r] = 1.f / fmaxf(sum, 1e-30f);
  }
  if (__syncthreads_or(tid < nr && sM[tid] <= NEG_INF)) {
    nothing();
    __syncthreads();
  }
  for (int e = blockIdx.x % n_split * NT + tid; e < nr * (D / 2); e += n_split * NT) {
    const int r = e / (D / 2), c = e % (D / 2) * 2;
    const float M = sM[r];
    float x0 = 0.f, x1 = 0.f;
    for (int k = 0; k < n_split; ++k) {
      const float mk = cluster.map_shared_rank(pm, k)[r];
      if (mk == -INFINITY) continue;
      const float w = exp2f(mk - M);
      const float2 o =
          *reinterpret_cast<const float2*>(cluster.map_shared_rank(po, k) + r * DP + c);
      x0 += w * o.x;
      x1 += w * o.y;
    }
    store(r, c, x0 * sL[r], x1 * sL[r], M);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

}  // namespace tile
