// Paged flash-decode attention of T new query tokens against a global KV page
// pool through per-row block tables, for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_paged_pallas
// (the TPU kernel _paged_decode_kernel).  Same function: the pool is
// (n_pages, ps, K, D); row b's table index i names the page that holds
// positions i*ps .. i*ps+ps-1 (positions are written once, never wrapped, so
// no kv_pos pool exists); -1 entries are unset.  Query row r = t*G + g of KV
// head kh sits at q_pos = cache_len - T + t and sees position p iff its page
// is set and p <= q_pos (and p > q_pos - window with a window).  Masked
// scores are -1e30 (not -inf): a row that sees nothing at all gets what the
// plain version's uniform softmax gives, the mean of V over every table
// entry with unset entries read as page 0 (an idle batch row: the mean of
// page 0).  It stays finite.
//
// Bound on this card, at the serving path's largest shapes (qwen3-1.7b, 16
// heads / 8 KV heads, D = 128, bf16, max_context 1024, B = 8):
//   decode/verify, T = 9 over 1024 positions a row: K and V read once,
//     2 * 8 * 1024 * 8 * 128 * 2 B = 33.6 MB -> 10 us at 3.35 TB/s, against
//     0.6 GFLOP -> bytes;
//   admission, T = 1024 over 1024 positions (causal): 34 GFLOP -> 35 us at
//     989 TFLOP/s bf16, against ~100 MB of q, out, K and V -> 30 us; the two
//     are close, operations slightly ahead.
// This kernel multiplies on the CUDA cores in fp32, so at admission sizes
// it is held to the 67 TFLOP/s fp32 rate, not the tensor cores'.
//
// Design: one block per (tile of at most 32 query rows, KV head, batch row).
// The rows of a tile share one KV head (GQA), so each K/V position is read
// once for all of them; tiling the rows over the grid keeps the fp32 query
// and accumulator tiles in shared memory at any T (admission runs T up to
// max_context).  A block walks only the positions its rows can see, from its
// first row's window start (0 without a window) to its last row's q_pos, in
// tiles of 64 positions.  Each position's page id comes from the block table
// with a plain load; unset pages are not read at all.  K/V are staged in
// shared memory as fp32 (K rows padded to D+1 floats, free of bank
// conflicts) with an fp32 online softmax, as in decode_attention.cu.  Shared
// memory follows from the tile's row count at launch and opts in above
// 48 KB.  Later steps: split-KV for the decode shapes (64 blocks for 132 SMs)
// and wgmma with TMA-staged pages for admission.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;        // positions per tile
constexpr int ROWS = 32;      // query rows per block, at most
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ cache_len, const int* __restrict__ bt,
    T* __restrict__ out, int n_tok, int H, int K, int n_pages, int ps, int P,
    int rows, int window, float scale) {
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K, TG = n_tok * G;
  const int r0 = blockIdx.x * rows, nr = min(rows, TG - r0);
  extern __shared__ float smem[];
  float* sq = smem;                      // rows x D      scaled queries
  float* sacc = sq + rows * D;           // rows x D      output accumulator
  float* sk = sacc + rows * D;           // BK x (D+1)    K tile
  float* sv = sk + BK * (D + 1);         // BK x D        V tile
  float* ss = sv + BK * D;               // rows x BK     scores, then p
  float* sm = ss + rows * BK;            // rows          running max
  float* sl = sm + rows;                 // rows          running sum
  float* scorr = sl + rows;              // rows          this tile's rescale
  int* sslot = reinterpret_cast<int*>(scorr + rows);  // BK: pool slot, -1 unread
  int* sflag = sslot + BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* btb = bt + (size_t)b * P;
  const size_t slot_stride = (size_t)K * D;  // one page slot: K heads x D
  const int q0 = cache_len[b] - n_tok;       // position of token 0
  // the positions some row of this tile can see lie in [lo, hi]
  const int hi = min(q0 + (r0 + nr - 1) / G, P * ps - 1);
  const int lo = window < 0 ? 0 : max(0, q0 + r0 / G - window + 1);

  for (int i = tid; i < nr * D; i += THREADS) {
    const int r = r0 + i / D, d = i % D, t = r / G, g = r % G;
    sq[i] = to_f(q[(((size_t)b * n_tok + t) * H + kh * G + g) * D + d]) * scale;
    sacc[i] = 0.f;
  }
  for (int r = tid; r < nr; r += THREADS) {
    sm[r] = NEG_INF;
    sl[r] = 0.f;
  }

  for (int s0 = lo / BK * BK; s0 <= hi; s0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int j = tid; j < BK; j += THREADS) {
      const int p = s0 + j;
      int page = p >= lo && p <= hi ? btb[p / ps] : -1;
      page = min(page, n_pages - 1);  // as the plain version's clamp
      sslot[j] = page >= 0 ? page * ps + p % ps : -1;
    }
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D, slot = sslot[j];
      const size_t at = (size_t)slot * slot_stride + (size_t)kh * D + d;
      sk[j * (D + 1) + d] = slot >= 0 ? to_f(kp[at]) : 0.f;
      sv[j * D + d] = slot >= 0 ? to_f(vp[at]) : 0.f;
    }
    __syncthreads();

    // scores: a warp covers 32 positions of one row (q broadcast, K conflict-free)
    for (int i = tid; i < nr * BK; i += THREADS) {
      const int r = i / BK, j = i % BK;
      const float* qr = sq + r * D;
      const float* kj = sk + j * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qr[d] * kj[d];
      const int p = s0 + j, q_pos = q0 + (r0 + r) / G;
      const bool ok = sslot[j] >= 0 && p <= q_pos && (window < 0 || p > q_pos - window);
      ss[i] = ok ? dot : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < nr; r += THREADS / 32) {
      float* sr = ss + r * BK;
      float mx = NEG_INF;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, sr[j]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm[r], m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        scorr[r] = c;
        sl[r] = sl[r] * c + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V: consecutive threads take consecutive d
    for (int i = tid; i < nr * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const float* pr = ss + r * BK;
      float a = 0.f;
#pragma unroll 16
      for (int j = 0; j < BK; ++j) a += pr[j] * sv[j * D + d];
      sacc[i] = sacc[i] * scorr[r] + a;
    }
  }
  __syncthreads();

  // a row that saw no position keeps m = -1e30: the plain version's softmax
  // over P*ps masked slots is uniform, so its output is the mean of V over
  // every table entry, an unset entry read as page 0 (computed only if needed)
  if (tid == 0) {
    int any = 0;
    for (int r = 0; r < nr; ++r) any |= sm[r] == NEG_INF;
    *sflag = any;
  }
  __syncthreads();
  if (*sflag) {
    for (int d = tid; d < D; d += THREADS) {
      float sum = 0.f, page0 = 0.f;
      int n_unset = 0;
      for (int i = 0; i < P; ++i) {
        const int page = min(btb[i], n_pages - 1);
        if (page < 0) {
          ++n_unset;
          continue;
        }
        for (int s = 0; s < ps; ++s)
          sum += to_f(vp[((size_t)page * ps + s) * slot_stride + (size_t)kh * D + d]);
      }
      for (int s = 0; n_unset && s < ps; ++s)
        page0 += to_f(vp[(size_t)s * slot_stride + (size_t)kh * D + d]);
      sv[d] = (sum + n_unset * page0) / (float)(P * ps);
    }
    __syncthreads();
  }
  for (int i = tid; i < nr * D; i += THREADS) {
    const int rl = i / D, r = r0 + rl, d = i % D, t = r / G, g = r % G;
    store(out + (((size_t)b * n_tok + t) * H + kh * G + g) * D + d,
          sm[rl] == NEG_INF ? sv[d] : sacc[i] / fmaxf(sl[rl], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* cache_len,
           const int* bt, void* out, int B, int n_tok, int H, int K, int n_pages,
           int ps, int P, int window, float scale, cudaStream_t stream) {
  const int TG = n_tok * (H / K), rows = TG < ROWS ? TG : ROWS;
  const size_t smem = sizeof(float) * (2 * rows * D + BK * (D + 1) + BK * D + rows * BK
                                       + 3 * rows) + sizeof(int) * (BK + 1);
  auto kern = paged_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((TG + rows - 1) / rows, K, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      cache_len, bt, static_cast<T*>(out), n_tok, H, K, n_pages, ps, P, rows, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* kp, const void* vp, const int* cl,
               const int* bt, void* out, int B, int n_tok, int H, int K, int n_pages,
               int ps, int P, int window, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, kp, vp, cl, bt, out, B, n_tok, H, K, n_pages, ps, P,
                                  window, scale, st);
    case 64: return launch<T, 64>(q, kp, vp, cl, bt, out, B, n_tok, H, K, n_pages, ps, P,
                                  window, scale, st);
    case 128: return launch<T, 128>(q, kp, vp, cl, bt, out, B, n_tok, H, K, n_pages, ps, P,
                                    window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, H, D); k_pages, v_pages (n_pages, ps, K, D); cache_len (B,) int32
// (the T new tokens included); block_tables (B, P) int32, -1 = unset;
// out (B, T, H, D).  All contiguous.  dtype: 0 = float32, 1 = bfloat16.
// window < 0 means no sliding window.  Returns cudaGetLastError() after launch.
extern "C" int decode_attention_paged(const void* q, const void* k_pages,
                                      const void* v_pages, const int* cache_len,
                                      const int* block_tables, void* out, int B, int n_tok,
                                      int H, int K, int D, int n_pages, int ps, int P,
                                      int window, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k_pages, v_pages, cache_len, block_tables, out, B, n_tok,
                             H, K, n_pages, ps, P, window, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, cache_len, block_tables, out, B,
                                     n_tok, H, K, n_pages, ps, P, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
