// Flash attention (prefill) for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas (the
// TPU kernel _attn_kernel).  Same function: causal or not, an optional
// sliding window, a q_offset continuation, GQA through kv head h / G with no
// KV repeat, and whole-tile skipping of fully masked KV tiles.  Keys past Sk
// do not exist (-inf); masked keys score -1e30, as on the TPU.
//
// Bound on this card: operations at long prompts, bytes at short ones.  The
// main path's largest call (B=4, S=512, H=16, D=128, causal) needs ~4.3
// GFLOP (~4.4 us at 989 TFLOP/s bf16) and moves ~25 MB (~7.5 us at 3.35
// TB/s); smaller buckets are bytes-bound.
//
// bf16 (every serve): flash_wgmma_kernel, the tensor-core tile loop of
// attention_tile.cuh (ptxas/SASS: S = QK^T on HGMMA.64x64x16.F32.BF16 with
// both operands from shared memory, O += PV on HGMMA.64x128x16.F32.BF16 with
// P from registers; chip_smoke.py checks both forms in the built library).
// One block per (tile of 64 query rows, batch*head), heaviest causal tiles
// first; one consumer warpgroup (two were no faster at S = 512:
// attention_variants.py).  K and V tiles of 64 positions come by TMA
// (one thread issues them, an mbarrier per stage counts the bytes) through
// tensor maps over the (B, Sk, K, D) tensors with the 128-byte swizzle wgmma
// reads (64-byte at D = 32); rows past Sk are out of bounds and arrive as
// zeros.  Two stages: tile i+1 is in flight while tile i is multiplied.
// cuTensorMapEncodeTiled comes from the runtime's cudaGetDriverEntryPoint,
// so the library links no libcuda.  The loop over KV tiles stops at the
// causal limit and starts at the window's first visible tile, with
// per-element masks inside.
//
// Training: given a non-null lse, both kernels also write each row's
// log-sum-exp of its scaled scores from the running max and sum they keep
// anyway (flash_attention_bwd.cu recomputes P from it); serving passes null.
//
// float32: flash_kernel, on the CUDA cores (tensor cores in TF32 cannot
// hold the 2e-5 float32 tolerance).  One block of 128 threads per (64-row q
// tile, batch*head); q and 64-key K/V tiles staged in shared memory as fp32
// (rows padded to D+1 floats); each thread owns an 8x4 micro-tile of the
// scores and an 8 x D/16 slice of the output accumulator in registers; row
// max and sum are reduced over the 16 threads that share a row.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, inputs rotated past the L2): B=4 S=512 causal bf16 0.0249 ms, 3.3x
// its bound, against 0.2979 ms for the CUDA-core kernel it replaces and
// 0.0216 ms for scaled_dot_product_attention.  What still holds it back:
// no producer/consumer warp specialisation (a block barrier every tile, and
// S = QK^T waits for the previous tile's softmax and PV), no persistent
// grid (512 blocks make two uneven waves on 132 SMs), causal diagonal tiles
// multiplied whole, and the G heads of a KV head in separate blocks (K/V
// read G times, from L2).  The M9 models (same script and card): G = 5
// (qwen2.5-14b) B=4 S=512 0.0599 ms, 4.0x its bound and 1.6x SDPA's 0.0376
// (the five heads of a KV head in five blocks); head_dim 120 (h2o-danube, a
// 128-wide tile) B=1 S=8192 window 4096 1.6716 ms, 4.3x its bound, against
// 3.9336 ms for SDPA given the window as a mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile.cuh"

namespace {

// ----------------------------------------------------- float32, CUDA cores

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BK = 64, THREADS = 128;

template <int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int K,
    int causal, int window, int q_offset, float scale) {
  constexpr int DC = (D + 15) / 16;  // output columns per thread (the last may lie past D)
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / K);
  extern __shared__ float smem[];
  float* sq = smem;                 // BQ x (D+1)
  float* sk = sq + BQ * (D + 1);    // BK x (D+1)
  float* sv = sk + BK * (D + 1);    // BK x D
  float* sp = sv + BK * D;          // BQ x (BK+1)  probabilities
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;  // rows rg*8+i, cols cg+16c

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    sq[r * (D + 1) + d] =
        qi < Sq ? q[(((size_t)b * Sq + qi) * H + h) * D + d] * scale : 0.f;
  }
  float acc[8][DC], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // KV tiles that any row of this q tile can see
  int k_end = Sk, k_begin = 0;
  if (causal) k_end = min(Sk, q_offset + q0 + BQ);
  if (window >= 0) k_begin = max(0, q_offset + q0 - window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile consumed (and q tile staged)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D, kj = k0 + j;
      const size_t off = (((size_t)b * Sk + kj) * K + kh) * D + d;
      sk[j * (D + 1) + d] = kj < Sk ? k[off] : 0.f;
      sv[j * D + d] = kj < Sk ? v[off] : 0.f;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = sq[(rg * 8 + i) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sk[(cg + 16 * c) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] += qv[i] * kv[c];
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rg * 8 + i, q_pos = q_offset + q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + cg + 16 * c;
        float x = s[i][c];
        if (kp >= Sk) x = -INFINITY;
        else if ((causal && kp > q_pos) || (window >= 0 && kp <= q_pos - window)) x = NEG_INF;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx), corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        sp[r * (BK + 1) + cg + 16 * c] = p;
        sum += p;
      }
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = cg + 16 * c < D ? sv[j * D + cg + 16 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = sp[(rg * 8 + i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + rg * 8 + i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && cg == 0) lse[((size_t)b * H + h) * Sq + qi] = m[i] - logf(inv);
    float* o = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (cg + 16 * c < D) o[cg + 16 * c] = acc[i][c] * inv;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Sk, int H, int K, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  auto kern = flash_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((Sq + BQ - 1) / BQ, B * H), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Sk, H, K, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16, wgmma

constexpr int WGS = 1;  // consumer warpgroups (64 query rows each) per block

template <int D>
constexpr size_t wgmma_smem() {  // Q tiles, 2 stages of K and V, 2 mbarriers, alignment slack
  return 1024 + (size_t)(WGS + 4) * tile::tile_bytes(D) + 16;
}

template <int D>
__global__ void __launch_bounds__(128 * WGS) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int K, int causal, int window, int q_offset,
    float scale_log2) {
  using namespace tile;
  constexpr int ROWS = BQ * WGS, TB = tile_bytes(D), SW = swizzle_bytes(D), PW = SW / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, skv = base + WGS * TB, full = skv + 4 * TB;  // full[2]: 8 B each
  const int tid = threadIdx.x, wg = tid / 128;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // heaviest causal tiles first

  // KV tiles that any row of this q tile can see
  int k_end = Sk, k_begin = 0;
  if (causal) k_end = min(Sk, q_offset + q0 + ROWS);
  if (window >= 0) k_begin = max(0, q_offset + q0 - window + 1) / BK * BK;
  const int n = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto issue = [&](int i) {  // one thread: tile i's K and V into stage i % 2
    const uint32_t st = skv + (i & 1) * 2 * TB, bar = full + (i & 1) * 8;
    mbar_expect_tx(bar, 2 * TB);
#pragma unroll
    for (int p = 0; p < tile_dim(D) / PW; ++p) {
      tma_load_4d(st + p * BK * SW, &kmap, bar, p * PW, kh, k_begin + i * BK, b);
      tma_load_4d(st + TB + p * BK * SW, &vmap, bar, p * PW, kh, k_begin + i * BK, b);
    }
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n > 0) issue(0);
  }
  constexpr int CH = tile_dim(D) / 8;  // 16-byte chunks a row; those past D are zeros
  for (int i = tid; i < ROWS * CH; i += 128 * WGS) {
    const int r = i / CH, c = i % CH * 8, qi = q0 + r;
    cp_async16(sq + (r / BQ) * TB + tile_offset<D>(r % BQ, c),
               q + (((size_t)b * Sq + min(qi, Sq - 1)) * H + h) * D + min(c, D - 8),
               qi < Sq && c < D ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();  // q tile staged, barriers initialised

  Tile<D> t;
  t.init();
  const int row0 = q_offset + q0 + wg * BQ;  // position of this warpgroup's first row
  for (int i = 0; i < n; ++i) {
    const int k0 = k_begin + i * BK;
    if (i > 0) __syncthreads();  // tile i-1 consumed: its stage takes tile i+1
    if (tid == 0 && i + 1 < n) issue(i + 1);
    mbar_wait(full + (i & 1) * 8, (i >> 1) & 1);
    const uint32_t st = skv + (i & 1) * 2 * TB;
    t.step(sq + wg * TB, st, st + TB, scale_log2, [&](int, int r, int c, float x) {
      const int kp = k0 + c, qp = row0 + r;
      if (kp >= Sk) return -INFINITY;
      if ((causal && kp > qp) || (window >= 0 && kp <= qp - window)) return NEG_INF;
      return x;
    });
  }
  t.finish([&](int, int r, int c, float x0, float x1) {
    const int qi = q0 + wg * BQ + r;
    if (qi < Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * Sq + qi) * H + h) * D + c) =
          __floats2bfloat162_rn(x0, x1);
  });
  // log-sum-exp of each row's scaled scores (the backward's): finish left
  // the row max m (base 2) and 1 / the row sum in l, alike in a row's 4 lanes
  if (lse != nullptr && tid % 4 == 0)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = q0 + wg * BQ + Tile<D>::row(half);
      if (qi < Sq) lse[((size_t)b * H + h) * Sq + qi] = t.m[half] / LOG2E - logf(t.l[half]);
    }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                 int Sq, int Sk, int H, int K, int causal, int window, int q_offset, float scale,
                 cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!tile::kv_map<D>(&kmap, k, B, Sk, K) || !tile::kv_map<D>(&vmap, v, B, Sk, K))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wgmma_smem<D>();
  auto kern = flash_wgmma_kernel<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = tile::BQ * WGS;
  kern<<<dim3(B * H, (Sq + rows - 1) / rows), 128 * WGS, smem, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), lse,
      Sq, Sk, H, K, causal, window, q_offset, scale * tile::LOG2E);
  return (int)cudaGetLastError();
}

#define FLASH_ARGS q, k, v, out, lse, B, Sq, Sk, H, K, causal, window, q_offset, scale, st

int dispatch(int D, int dtype, const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Sk, int H, int K, int causal, int window,
             int q_offset, float scale, cudaStream_t st) {
  if (dtype == 0) switch (D) {
      case 32: return launch<32>(FLASH_ARGS);
      case 64: return launch<64>(FLASH_ARGS);
      case 120: return launch<120>(FLASH_ARGS);
      case 128: return launch<128>(FLASH_ARGS);
    }
  if (dtype == 1) switch (D) {
      case 32: return launch_wgmma<32>(FLASH_ARGS);
      case 64: return launch_wgmma<64>(FLASH_ARGS);
      case 120: return launch_wgmma<120>(FLASH_ARGS);
      case 128: return launch_wgmma<128>(FLASH_ARGS);
    }
  return (int)cudaErrorInvalidValue;
}

#undef FLASH_ARGS

}  // namespace

// Which kernel a call takes: 1 = flash_wgmma_kernel (bf16, tensor cores),
// 0 = flash_kernel (float32, CUDA cores).  The dtype alone decides.
extern "C" int flash_attention_route(int dtype) { return dtype == 1 ? 1 : 0; }

// q (B, Sq, H, D); k, v (B, Sk, K, D); out (B, Sq, H, D).  All contiguous.
// lse, if not null: (B, H, Sq) float32, each row's log-sum-exp of its scaled
// scores (what the backward, flash_attention_bwd.cu, recomputes P from);
// serving passes null.  dtype: 0 = float32, 1 = bfloat16.  window < 0 means
// no sliding window.
// Returns cudaGetLastError() after the launch, or the error that refused it
// (cudaErrorInvalidValue for a tensor map the driver does not encode).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               float* lse, int B, int Sq, int Sk, int H, int K, int D,
                               int causal, int window, int q_offset, float scale, int dtype,
                               void* stream) {
  return dispatch(D, dtype, q, k, v, out, lse, B, Sq, Sk, H, K, causal, window, q_offset,
                  scale, static_cast<cudaStream_t>(stream));
}
