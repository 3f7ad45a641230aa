// Mamba2 SSD (state-space duality) chunked scan, for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (the TPU kernel
// _ssd_kernel).  Same function: for head h of batch row b, with
// cs = cumsum(dt * A) inside a chunk,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//           + exp(cs_i) * (state_in @ C_i)
//   state = exp(cs_last) * state_in + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
// chunk after chunk, from the initial state (or zeros) to the final state,
// which is returned in fp32.  Head h reads B and C of group h / (H / G).
// The decay is never factored as exp(cs_i) * exp(-cs_j): cs reaches about
// -400 over a long chunk and exp(-cs_j) would overflow fp32.
//
// Bound on this card: bytes.  At the serving shape (one prompt of S = 400,
// H = 80 heads of P = 64, N = 128, one group, bf16) the function must read
// x (4.1 MB), dt, B and C, and write y (4.1 MB) and the fp32 final state
// (2.6 MB): ~11 MB, about 3.3 us at 3.35 TB/s.  Its products are ~1.5
// GFLOP, 1.5 us on the bf16 tensor cores.
//
// Design (a simple, correct kernel: the products run on the CUDA cores in
// fp32; wgmma and TMA come later):
// * One block per (head, batch row): the TPU grid's sequential chunk axis
//   becomes a loop inside the block, with the (P, N) fp32 state carried in
//   registers (32 values a thread at P = 64, N = 128) and mirrored in shared
//   memory for the inter-chunk term.  80 blocks at the serving shape: 80 of
//   the 132 SMs busy, one block each.
// * The kernel scans in chunks of 64 rows whatever the caller's chunk is
//   (the function is the same; only rounding moves).  A 64-row chunk fits
//   shared memory whole: B and C (64 x N), x (64 x P), the decay-masked
//   score tile (64 x 64) and the state (P x N), ~132 KB at N = 128, rows
//   padded by one float so that the column walks are free of bank
//   conflicts.  It also halves the work of a 256-row chunk: the quadratic
//   intra-chunk term costs c/2 * (N + P) per token, against a fixed 2 * P * N
//   for the state terms.
// * Rows past S (the ragged tail) are loaded as zeros with dt = 0: they leave
//   the state unchanged and are not written.  x, dt, B and C are read by
//   their (batch, sequence) strides, so the model's views of the conv output
//   need no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CH = 64;        // rows per chunk
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int RP = 4;         // P <= 64: output rows per thread in the P axis
constexpr int RN = 8;         // N <= 128: state columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t smem_floats(int P, int N) {
  const int NP = N + 1;
  return 2 * (size_t)CH * NP + (size_t)CH * P + (size_t)CH * (CH + 1) + (size_t)P * NP + 3 * CH;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ s0,
    T* __restrict__ y, float* __restrict__ sf, int S, int H, int G, int P, int N,
    long long sxb, long long sxs, long long sdb, long long sds, long long sbb,
    long long sbs, long long scb, long long scs) {
  const int h = blockIdx.x, b = blockIdx.y, g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int NP = N + 1, MP = CH + 1, np16 = N / 16, pp16 = P / 16;
  extern __shared__ float smem[];
  float* sB = smem;              // CH x NP   B rows of the chunk
  float* sC = sB + CH * NP;      // CH x NP   C rows
  float* sX = sC + CH * NP;      // CH x P    x rows
  float* sM = sX + CH * P;       // CH x MP   (C_i . B_j) exp(cs_i - cs_j) dt_j, j <= i
  float* sS = sM + CH * MP;      // P x NP    the state entering the chunk
  float* sCs = sS + P * NP;      // CH        cumsum of dt * A
  float* sDt = sCs + CH;         // CH        dt
  float* sW = sDt + CH;          // CH        exp(cs_last - cs_j) dt_j
  const float Ah = A[h];

  float st[RP][RN];  // this thread's state: p = ty + 16 r, n = tx + 16 c
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      st[r][c] = 0.f;
      if (r < pp16 && c < np16) {
        const int p = ty + 16 * r, n = tx + 16 * c;
        if (s0) st[r][c] = s0[(((size_t)b * H + h) * P + p) * N + n];
        sS[p * NP + n] = st[r][c];
      }
    }

  for (int c0 = 0; c0 < S; c0 += CH) {
    const int rows = min(CH, S - c0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = tid; i < CH; i += THREADS)
      sDt[i] = i < rows ? dt[b * sdb + (c0 + i) * sds + h] : 0.f;
    for (int idx = tid; idx < CH * N; idx += THREADS) {
      const int i = idx / N, n = idx % N;
      const bool in = i < rows;
      sB[i * NP + n] = in ? to_f(Bm[b * sbb + (c0 + i) * sbs + (long long)g * N + n]) : 0.f;
      sC[i * NP + n] = in ? to_f(Cm[b * scb + (c0 + i) * scs + (long long)g * N + n]) : 0.f;
    }
    for (int idx = tid; idx < CH * P; idx += THREADS) {
      const int i = idx / P, p = idx % P;
      sX[idx] = i < rows ? to_f(x[b * sxb + (c0 + i) * sxs + (long long)h * P + p]) : 0.f;
    }
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum of dt * A over the 64 rows, two a lane
      const float v0 = sDt[2 * tid] * Ah, v1 = sDt[2 * tid + 1] * Ah;
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += u;
      }
      const float excl = incl - (v0 + v1);
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      sCs[2 * tid] = excl + v0;
      sCs[2 * tid + 1] = incl;
      sW[2 * tid] = expf(last - (excl + v0)) * sDt[2 * tid];
      sW[2 * tid + 1] = expf(last - incl) * sDt[2 * tid + 1];
    }
    __syncthreads();

    // scores: rows i = ty + 16 a, columns j = tx + 16 c
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * NP + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * NP + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] += cv[a] * bv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + 16 * a, j = tx + 16 * c;
          sM[i * MP + j] = j <= i ? acc[a][c] * expf(sCs[i] - sCs[j]) * sDt[j] : 0.f;
        }
    }
    __syncthreads();

    // y rows i = ty + 16 a, columns p = tx + 16 c: the intra-chunk product
    // plus the decayed contribution of the state entering the chunk
    {
      float acc[4][RP] = {};
      for (int j = 0; j < rows; ++j) {
        float mv[4], xv[RP];
#pragma unroll
        for (int a = 0; a < 4; ++a) mv[a] = sM[(ty + 16 * a) * MP + j];
#pragma unroll
        for (int c = 0; c < RP; ++c) xv[c] = c < pp16 ? sX[j * P + tx + 16 * c] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < RP; ++c) acc[a][c] += mv[a] * xv[c];
      }
      float inter[4][RP] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[RP];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * NP + n];
#pragma unroll
        for (int c = 0; c < RP; ++c) sv[c] = c < pp16 ? sS[(tx + 16 * c) * NP + n] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < RP; ++c) inter[a][c] += cv[a] * sv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i >= rows) continue;
        const float decay = expf(sCs[i]);
        T* yrow = y + (((size_t)b * S + c0 + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < RP; ++c)
          if (c < pp16) store(yrow + tx + 16 * c, acc[a][c] + decay * inter[a][c]);
      }
    }

    // the state leaving the chunk (registers only: sS is still being read)
    {
      const float chunk_decay = expf(sCs[CH - 1]);
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) st[r][c] *= chunk_decay;
      for (int j = 0; j < rows; ++j) {
        const float w = sW[j];
        float xw[RP], bv[RN];
#pragma unroll
        for (int r = 0; r < RP; ++r) xw[r] = r < pp16 ? sX[j * P + ty + 16 * r] * w : 0.f;
#pragma unroll
        for (int c = 0; c < RN; ++c) bv[c] = c < np16 ? sB[j * NP + tx + 16 * c] : 0.f;
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c) st[r][c] += xw[r] * bv[c];
      }
    }
    __syncthreads();  // every read of sS for this chunk is done
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        if (r < pp16 && c < np16) sS[(ty + 16 * r) * NP + tx + 16 * c] = st[r][c];
  }

#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c)
      if (r < pp16 && c < np16)
        sf[(((size_t)b * H + h) * P + ty + 16 * r) * N + tx + 16 * c] = st[r][c];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* C,
           const void* s0, void* y, void* sf, int Bsz, int S, int H, int G, int P, int N,
           long long sxb, long long sxs, long long sdb, long long sds, long long sbb,
           long long sbs, long long scb, long long scs, cudaStream_t stream) {
  const size_t bytes = smem_floats(P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<dim3(H, Bsz), THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(C), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sf), S, H, G, P, N, sxb, sxs, sdb, sds, sbb, sbs,
      scb, scs);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, H, P) and y in the model dtype (dtype 0 = float32, 1 = bfloat16);
// dt (B, S, H), A (H,), s0 (B, H, P, N) or null, sf (B, H, P, N) in float32.
// x, dt, B and C are addressed by their batch and sequence strides (in
// elements); their trailing (H, P), H and (G, N) dimensions are packed.
// y and sf are contiguous.  P and N are multiples of 16, P <= 64, N <= 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* C, const void* s0, void* y, void* sf, int Bsz, int S, int H,
                        int G, int P, int N, long long sxb, long long sxs, long long sdb,
                        long long sds, long long sbb, long long sbs, long long scb,
                        long long scs, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, C, s0, y, sf, Bsz, S, H, G, P, N, sxb, sxs, sdb,
                                 sds, sbb, sbs, scb, scs, s);
  return launch<float>(x, dt, A, Bm, C, s0, y, sf, Bsz, S, H, G, P, N, sxb, sxs, sdb, sds, sbb,
                       sbs, scb, scs, s);
}
