// Backward of the Mamba2 SSD chunked scan (K4), for NVIDIA Hopper (sm_90a).
//
// Replaces: what JAX differentiates in training through
// src/repro/kernels/ssd_scan.py::ssd_scan_pallas (off the TPU the reference
// sends the scan to its plain version, ref.ssd_scan, and takes its gradient
// by autodiff; it has no custom_vjp).  Given dy (B, S, H, P) and the
// forward's inputs, the gradients of y = ssd_scan(x, dt, A, B, C) (the final
// state takes none): dx (B, S, H, P) and dB, dC (B, S, G, N) in x's dtype,
// ddt (B, S, H) and dA (H,) in fp32.
//
// The exact reverse of the forward's 64-row chunk decomposition
// (ssd_scan.cu).  For head h of batch row b, in a chunk with cs = cumsum(dt
// A), L_ij = exp(cs_i - cs_j) (j <= i), w_j = exp(cs_last - cs_j) dt_j, the
// state S entering the chunk and G the gradient of the state leaving it:
//   dx_j  = dt_j sum_i (C_i.B_j) L_ij dy_i + w_j G B_j
//   dB_j  = dt_j sum_i (dy_i.x_j) L_ij C_i + w_j G^T x_j
//   dC_i  = sum_j (dy_i.x_j) L_ij dt_j B_j + exp(cs_i) S^T dy_i
//   G_in  = exp(cs_last) G + sum_i exp(cs_i) dy_i C_i^T     (from zero after
//           the last chunk: the reverse recurrence over chunks)
// and the decay's gradient: with F_ij = (C_i.B_j) L_ij (dy_i.x_j) and u_j =
// x_j.(G B_j),
//   dcs_i = sum_j F_ij dt_j - dt_i sum_k F_ki + exp(cs_i) dy_i.(S C_i)
//           - w_i u_i [+ exp(cs_last) <G, S> + sum_j w_j u_j at i = last]
//   ddt_j = sum_i F_ij + exp(cs_last - cs_j) u_j + A da_j,
//   da_k  = sum_{i >= k} dcs_i (the cumsum's transpose),  dA = sum dt_k da_k.
// The decay is never factored as exp(cs_i) exp(-cs_j): cs reaches about
// -400 over a chunk.  Rows past S are zeros with dt = 0: every term they
// enter is zero, and they are not written.
//
// Bound on this card: bytes.  At the training shape (B = 4, S = 2048, H = 80
// heads of P = 64, N = 128, one group, bf16) the function must read x and dy
// and write dx (3 x 84 MB), read B and C and write dB and dC (8.4 MB), read
// dt and write ddt: 265 MB, 0.079 ms at 3.35 TB/s.  Its products at 64-row
// chunks (C.B a group; a head's dy.x and the intra-chunk forms of dx, dB and
// dC over the causal half; the three terms through G or S, G's step back and
// the recomputed state update) are 70 GFLOP, 0.071 ms on the bf16 tensor
// cores (chip_smoke.py's ssd_bwd_cost).
//
// Design: a right kernel first, on the CUDA cores in fp32 for both dtypes
// (bf16 inputs are widened on load; the outputs are rounded once).
// ssd_bwd_kernel, one block of 256 threads a (head, batch row):
// * Phase 1 walks the chunks forward from the initial state (or zeros) and
//   writes the state entering each chunk to a workspace (B, nc, H, P, N)
//   fp32: the states are recomputed here rather than kept by the forward,
//   so serving's K4 is unchanged and autograd holds nothing more than the
//   inputs; 335 MB at the training shape, alive for the call only (under
//   remat, one layer's at a time).
// * Phase 2 walks the chunks backward with G in registers (32 values a
//   thread), mirrored in shared memory.  A chunk's B, C, x, dy, the state
//   entering it, G, the masked decayed scores (C.B) L and (dy.x) L fit
//   shared memory whole (~205 KB at P = 64, N = 128; rows padded by one
//   float so that column walks are free of bank conflicts).
// * dB and dC are written per head into fp32 workspaces (B, S, H, N) and dA
//   per (row, head); ssd_bwd_reduce_kernel sums the H / G heads of a group
//   and the batch rows of dA in a fixed order.  No atomics anywhere: two
//   calls give the same bits, as launch.train's exact replays need.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, inputs rotated past the L2): see PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CH = 64;        // rows per chunk, as the forward's
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int RP = 4;         // P <= 64: rows of P a thread
constexpr int RN = 8;         // N <= 128: columns of N a thread
constexpr int MP = CH + 1;

size_t smem_floats(int P, int N) {
  const size_t NP = N + 1, XP = P + 1;
  return 2 * CH * NP + 2 * CH * XP + 2 * (size_t)P * NP + 2 * CH * MP + 16 * CH + 9 * CH + 16;
}

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T st(float v);
template <> __device__ __forceinline__ float st<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// sum over the 16 lanes that share ty (lane ^ off keeps bit 4 for off < 16)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sum32(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ s0,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ states, float* __restrict__ dBh, float* __restrict__ dCh,
    float* __restrict__ dApart, int S, int H, int G, int P, int N, long long sxb,
    long long sxs, long long sdb, long long sds, long long sbb, long long sbs, long long scb,
    long long scs) {
  const int h = blockIdx.x, b = blockIdx.y, g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, lane = tid % 32, warp = tid / 32;
  const int NP = N + 1, XP = P + 1, np16 = N / 16, pp16 = P / 16;
  const int nc = (S + CH - 1) / CH;
  extern __shared__ float smem[];
  float* sB = smem;             // CH x NP   B rows of the chunk
  float* sC = sB + CH * NP;     // CH x NP   C rows
  float* sX = sC + CH * NP;     // CH x XP   x rows
  float* sDY = sX + CH * XP;    // CH x XP   dy rows
  float* sS = sDY + CH * XP;    // P x NP    the state entering the chunk
  float* sG = sS + P * NP;      // P x NP    the gradient of the state leaving it
  float* sK = sG + P * NP;      // CH x MP   (C_i.B_j) L_ij, j <= i
  float* sD = sK + CH * MP;     // CH x MP   (dy_i.x_j) L_ij, j <= i
  float* sPart = sD + CH * MP;  // 16 x CH   column partials of F
  float* sDt = sPart + 16 * CH;  // CH each: dt, cs, w, exp(cs), row and column
  float* sCs = sDt + CH;         // sums of F, u, the inter-chunk term of dcs
  float* sW = sCs + CH;
  float* sEx = sW + CH;
  float* sRowT = sEx + CH;
  float* sColF = sRowT + CH;
  float* sU = sColF + CH;
  float* sR = sU + CH;
  float* sRed = sR + CH;         // 8 warps' partials of <G, S>
  const float Ah = A[h];

  // chunk c0's rows into shared memory (zeros past S): dt and B always, x,
  // C and dy when asked
  auto load = [&](int c0, bool all) {
    const int rows = min(CH, S - c0);
    for (int i = tid; i < CH; i += THREADS)
      sDt[i] = i < rows ? dt[b * sdb + (long long)(c0 + i) * sds + h] : 0.f;
    for (int idx = tid; idx < CH * N; idx += THREADS) {
      const int i = idx / N, n = idx % N;
      const bool in = i < rows;
      sB[i * NP + n] =
          in ? ld(Bm[b * sbb + (long long)(c0 + i) * sbs + (long long)g * N + n]) : 0.f;
      if (all)
        sC[i * NP + n] =
            in ? ld(Cm[b * scb + (long long)(c0 + i) * scs + (long long)g * N + n]) : 0.f;
    }
    for (int idx = tid; idx < CH * P; idx += THREADS) {
      const int i = idx / P, p = idx % P;
      const bool in = i < rows;
      sX[i * XP + p] = in ? ld(x[b * sxb + (long long)(c0 + i) * sxs + (long long)h * P + p]) : 0.f;
      if (all)
        sDY[i * XP + p] = in ? ld(dy[(((size_t)b * S + c0 + i) * H + h) * P + p]) : 0.f;
    }
  };
  // warp 0: cs = inclusive cumsum of dt * A, w = exp(cs_last - cs) dt,
  // exp(cs), two rows a lane
  auto cumsum = [&]() {
    if (tid < 32) {
      const float v0 = sDt[2 * tid] * Ah, v1 = sDt[2 * tid + 1] * Ah;
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += u;
      }
      const float excl = incl - (v0 + v1);
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      const float c0v = excl + v0;
      sCs[2 * tid] = c0v;
      sCs[2 * tid + 1] = incl;
      sW[2 * tid] = expf(last - c0v) * sDt[2 * tid];
      sW[2 * tid + 1] = expf(last - incl) * sDt[2 * tid + 1];
      sEx[2 * tid] = expf(c0v);
      sEx[2 * tid + 1] = expf(incl);
    }
  };

  // ---- phase 1: the state entering each chunk, into the workspace
  float sv[RP][RN];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      sv[r][c] = 0.f;
      if (s0 && r < pp16 && c < np16)
        sv[r][c] = s0[(((size_t)b * H + h) * P + ty + 16 * r) * N + tx + 16 * c];
    }
  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * CH, rows = min(CH, S - c0);
    __syncthreads();  // the previous chunk is consumed
    load(c0, false);
    __syncthreads();
    cumsum();
    __syncthreads();
    float* ws = states + (((size_t)b * nc + ci) * H + h) * P * N;
    const float decay = expf(sCs[CH - 1]);
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        if (r < pp16 && c < np16) ws[(ty + 16 * r) * N + tx + 16 * c] = sv[r][c];
        sv[r][c] *= decay;
      }
    for (int j = 0; j < rows; ++j) {
      const float w = sW[j];
      float xw[RP], bv[RN];
#pragma unroll
      for (int r = 0; r < RP; ++r) xw[r] = r < pp16 ? sX[j * XP + ty + 16 * r] * w : 0.f;
#pragma unroll
      for (int c = 0; c < RN; ++c) bv[c] = c < np16 ? sB[j * NP + tx + 16 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) sv[r][c] += xw[r] * bv[c];
    }
  }

  // ---- phase 2: the chunks in reverse, G from zero
  float gr[RP][RN];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      gr[r][c] = 0.f;
      if (r < pp16 && c < np16) sG[(ty + 16 * r) * NP + tx + 16 * c] = 0.f;
    }
  float dA_acc = 0.f;  // lane 0 of warp 0
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int c0 = ci * CH, rows = min(CH, S - c0);
    __syncthreads();  // the previous chunk is consumed
    load(c0, true);
    const float* ws = states + (((size_t)b * nc + ci) * H + h) * P * N;
    for (int idx = tid; idx < P * N; idx += THREADS) sS[(idx / N) * NP + idx % N] = ws[idx];
    __syncthreads();
    cumsum();
    __syncthreads();

    // the scores C.B and dy.x of rows i = ty + 16 a, columns j = tx + 16 c;
    // masked and decayed into sK and sD; F's row sums (times dt_j) and
    // column partials
    {
      float cb[4][4] = {}, dm[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * NP + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * NP + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) cb[a][c] += cv[a] * bv[c];
      }
      for (int p = 0; p < P; ++p) {
        float yv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = sDY[(ty + 16 * a) * XP + p];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = sX[(tx + 16 * c) * XP + p];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) dm[a][c] += yv[a] * xv[c];
      }
      float rowT[4] = {}, colF[4] = {};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + 16 * a, j = tx + 16 * c;
          float k = 0.f, d = 0.f;
          if (j <= i) {
            const float L = expf(sCs[i] - sCs[j]);
            k = cb[a][c] * L;
            d = dm[a][c] * L;
          }
          sK[i * MP + j] = k;
          sD[i * MP + j] = d;
          const float f = k * dm[a][c];
          rowT[a] += f * sDt[j];
          colF[c] += f;
        }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float v = sum16(rowT[a]);
        if (tx == 0) sRowT[ty + 16 * a] = v;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) sPart[ty * CH + tx + 16 * c] = colF[c];
    }
    __syncthreads();
    if (tid < CH) {
      float s = 0.f;
      for (int t = 0; t < 16; ++t) s += sPart[t * CH + tid];
      sColF[tid] = s;
    }

    // dx of rows j = ty + 16 a, columns p = tx + 16 c; u_j = x_j.(G B_j)
    {
      float k1[4][RP] = {}, k2[4][RP] = {};
      for (int i = 0; i < CH; ++i) {
        float kv[4], yv[RP];
#pragma unroll
        for (int a = 0; a < 4; ++a) kv[a] = sK[i * MP + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < RP; ++c) yv[c] = c < pp16 ? sDY[i * XP + tx + 16 * c] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < RP; ++c) k1[a][c] += kv[a] * yv[c];
      }
      for (int n = 0; n < N; ++n) {
        float bv[4], gv[RP];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = sB[(ty + 16 * a) * NP + n];
#pragma unroll
        for (int c = 0; c < RP; ++c) gv[c] = c < pp16 ? sG[(tx + 16 * c) * NP + n] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < RP; ++c) k2[a][c] += bv[a] * gv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = ty + 16 * a;
        float u = 0.f;
#pragma unroll
        for (int c = 0; c < RP; ++c)
          if (c < pp16) u += sX[j * XP + tx + 16 * c] * k2[a][c];
        u = sum16(u);
        if (tx == 0) sU[j] = u;
        if (j < rows) {
          T* row = dx + (((size_t)b * S + c0 + j) * H + h) * P;
#pragma unroll
          for (int c = 0; c < RP; ++c)
            if (c < pp16) row[tx + 16 * c] = st<T>(sDt[j] * k1[a][c] + sW[j] * k2[a][c]);
        }
      }
    }

    // dB of rows j = ty + 16 a, columns n = tx + 16 c (this head's share)
    {
      float e1[4][RN] = {}, e2[4][RN] = {};
      for (int i = 0; i < CH; ++i) {
        float dv[4], cv[RN];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = sD[i * MP + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < RN; ++c) cv[c] = c < np16 ? sC[i * NP + tx + 16 * c] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < RN; ++c) e1[a][c] += dv[a] * cv[c];
      }
      for (int p = 0; p < P; ++p) {
        float xv[4], gv[RN];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = sX[(ty + 16 * a) * XP + p];
#pragma unroll
        for (int c = 0; c < RN; ++c) gv[c] = c < np16 ? sG[p * NP + tx + 16 * c] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < RN; ++c) e2[a][c] += xv[a] * gv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = ty + 16 * a;
        if (j >= rows) continue;
        float* row = dBh + (((size_t)b * S + c0 + j) * H + h) * N;
#pragma unroll
        for (int c = 0; c < RN; ++c)
          if (c < np16) row[tx + 16 * c] = sDt[j] * e1[a][c] + sW[j] * e2[a][c];
      }
    }

    // dC of rows i = ty + 16 a, columns n = tx + 16 c (this head's share);
    // R_i = exp(cs_i) dy_i.(S C_i), the inter-chunk term of dcs_i
    {
      float f1[4][RN] = {}, f2[4][RN] = {};
      for (int j = 0; j < CH; ++j) {
        const float dtj = sDt[j];
        float dv[4], bv[RN];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = sD[(ty + 16 * a) * MP + j] * dtj;
#pragma unroll
        for (int c = 0; c < RN; ++c) bv[c] = c < np16 ? sB[j * NP + tx + 16 * c] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < RN; ++c) f1[a][c] += dv[a] * bv[c];
      }
      for (int p = 0; p < P; ++p) {
        float yv[4], sv2[RN];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = sDY[(ty + 16 * a) * XP + p];
#pragma unroll
        for (int c = 0; c < RN; ++c) sv2[c] = c < np16 ? sS[p * NP + tx + 16 * c] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < RN; ++c) f2[a][c] += yv[a] * sv2[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        const float e = sEx[i];
        float r = 0.f;
#pragma unroll
        for (int c = 0; c < RN; ++c)
          if (c < np16) r += e * f2[a][c] * sC[i * NP + tx + 16 * c];
        r = sum16(r);
        if (tx == 0) sR[i] = r;
        if (i < rows) {
          float* row = dCh + (((size_t)b * S + c0 + i) * H + h) * N;
#pragma unroll
          for (int c = 0; c < RN; ++c)
            if (c < np16) row[tx + 16 * c] = f1[a][c] + e * f2[a][c];
        }
      }
    }
    __syncthreads();  // sU, sR and sColF are complete; nothing reads sG any more

    // <G, S> over the block, then G steps back over the chunk
    {
      float gs = 0.f;
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c)
          if (r < pp16 && c < np16) gs += gr[r][c] * sS[(ty + 16 * r) * NP + tx + 16 * c];
      gs = sum32(gs);
      if (lane == 0) sRed[warp] = gs;
      const float decay = sEx[CH - 1];
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) gr[r][c] *= decay;
      for (int i = 0; i < rows; ++i) {
        const float e = sEx[i];
        float yv[RP], cv[RN];
#pragma unroll
        for (int r = 0; r < RP; ++r) yv[r] = r < pp16 ? sDY[i * XP + ty + 16 * r] * e : 0.f;
#pragma unroll
        for (int c = 0; c < RN; ++c) cv[c] = c < np16 ? sC[i * NP + tx + 16 * c] : 0.f;
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c) gr[r][c] += yv[r] * cv[c];
      }
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c)
          if (r < pp16 && c < np16) sG[(ty + 16 * r) * NP + tx + 16 * c] = gr[r][c];
    }
    __syncthreads();  // sRed

    // warp 0: dcs, its reverse cumsum da, ddt and this chunk's share of dA,
    // rows 2 lane and 2 lane + 1
    if (tid < 32) {
      float gsum = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) gsum += sRed[w];
      const int i0 = 2 * lane, i1 = i0 + 1;
      const float wu0 = sW[i0] * sU[i0], wu1 = sW[i1] * sU[i1];
      const float wu_all = sum32(wu0 + wu1);
      float d0 = sRowT[i0] - sDt[i0] * sColF[i0] + sR[i0] - wu0;
      float d1 = sRowT[i1] - sDt[i1] * sColF[i1] + sR[i1] - wu1;
      if (i1 == CH - 1) d1 += sEx[CH - 1] * gsum + wu_all;
      // suffix sums over the lanes: acc = d0 + d1 of this lane and every later one
      float acc = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float t = __shfl_down_sync(0xffffffffu, acc, off);
        if (lane + off < 32) acc += t;
      }
      const float da0 = acc, da1 = acc - d0;
      const float last = sCs[CH - 1];
      const float dd0 = sColF[i0] + expf(last - sCs[i0]) * sU[i0] + Ah * da0;
      const float dd1 = sColF[i1] + expf(last - sCs[i1]) * sU[i1] + Ah * da1;
      if (i0 < rows) ddt[((size_t)b * S + c0 + i0) * H + h] = dd0;
      if (i1 < rows) ddt[((size_t)b * S + c0 + i1) * H + h] = dd1;
      const float part = sum32(sDt[i0] * da0 + sDt[i1] * da1);
      if (lane == 0) dA_acc += part;
    }
  }
  if (tid == 0) dApart[(size_t)b * H + h] = dA_acc;
}

// dB and dC: the sum over a group's H / G heads, in order, rounded to the
// model dtype; dA: the sum over the batch rows, in order.
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
                                      const float* __restrict__ dApart, T* __restrict__ dB,
                                      T* __restrict__ dC, float* __restrict__ dA, int Bsz, int S,
                                      int H, int G, int N) {
  const int rep = H / G;
  const size_t total = (size_t)Bsz * S * G * N;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int n = e % N;
    const size_t bsg = e / N;
    const int gi = bsg % G;
    const size_t bs = bsg / G;
    const size_t src = (bs * H + (size_t)gi * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += dBh[src + (size_t)r * N];
      sc += dCh[src + (size_t)r * N];
    }
    dB[e] = st<T>(sb);
    dC[e] = st<T>(sc);
  }
  const size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (t < (size_t)H) {
    float s = 0.f;
    for (int b = 0; b < Bsz; ++b) s += dApart[(size_t)b * H + t];
    dA[t] = s;
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* C,
           const void* s0, const void* dy, void* dx, void* ddt, void* dA, void* dB, void* dC,
           void* states, void* dBh, void* dCh, void* dApart, int Bsz, int S, int H, int G, int P,
           int N, long long sxb, long long sxs, long long sdb, long long sds, long long sbb,
           long long sbs, long long scb, long long scs, cudaStream_t stream) {
  // the opt-in once, for the largest P and N the kernel takes
  static const cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(64, 128) * sizeof(float)));
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<T><<<dim3(H, Bsz), THREADS, smem_floats(P, N) * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(C), static_cast<const float*>(s0),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(states), static_cast<float*>(dBh), static_cast<float*>(dCh),
      static_cast<float*>(dApart), S, H, G, P, N, sxb, sxs, sdb, sds, sbb, sbs, scb, scs);
  cudaError_t l = cudaGetLastError();
  if (l != cudaSuccess) return (int)l;
  const size_t total = (size_t)Bsz * S * G * N;
  const size_t need = (total > (size_t)H ? total : (size_t)H) + 255;
  const int blocks = (int)(need / 256 < 1056 ? need / 256 : 1056);
  ssd_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dBh), static_cast<const float*>(dCh),
      static_cast<const float*>(dApart), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), Bsz, S, H, G, N);
  return (int)cudaGetLastError();
}

}  // namespace

// 0: neither dtype goes to a tensor-core kernel.
extern "C" int ssd_scan_bwd_route(int) { return 0; }

// x (B, S, H, P), B and C (B, S, G, N), dy, dx (B, S, H, P), dB and dC (B, S,
// G, N) in the model dtype (dtype 0 = float32, 1 = bfloat16); dt (B, S, H),
// A (H,), s0 (B, H, P, N) or null, ddt (B, S, H), dA (H,) in float32.  x, dt,
// B and C are addressed by their batch and sequence strides (in elements),
// their trailing dimensions packed; dy and the outputs are contiguous.
// Workspaces (float32, contiguous, written before they are read): states
// (B, ceil(S / 64), H, P, N), dBh and dCh (B, S, H, N), dApart (B, H).  P and
// N multiples of 16, P <= 64, N <= 128.  S >= 1.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* C, const void* s0, const void* dy, void* dx, void* ddt,
                            void* dA, void* dB, void* dC, void* states, void* dBh, void* dCh,
                            void* dApart, int Bsz, int S, int H, int G, int P, int N,
                            long long sxb, long long sxs, long long sdb, long long sds,
                            long long sbb, long long sbs, long long scb, long long scs,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || P % 16 || N % 16 || P < 16 || P > 64 || N < 16 || N > 128 || H % G)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(x, dt, A, Bm, C, s0, dy, dx, ddt, dA, dB, dC, states, dBh, dCh, dApart, Bsz,
                     S, H, G, P, N, sxb, sxs, sdb, sds, sbb, sbs, scb, scs, s);
  };
  return dtype == 1 ? run(__nv_bfloat16()) : run(float());
}
