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
// enter is zero, and they are not written.  Given S and G, every term is
// local to its chunk: the chunks can be worked on in parallel.
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
// Two kernels; the C entry point picks one by dtype (ssd_scan_bwd_route).
//
// ssd_bwd_wgmma_kernel (bfloat16, every training step; P = 64, N = 128):
// chunk-parallel on the tensor cores, in the forward's decomposition
// (ssd_wgmma_kernel) run in both directions.  One warpgroup a block, 100 KB
// of shared memory, two blocks an SM (one an SM took 40% longer on an
// NVIDIA H100 80GB HBM3: the products wait on each other, and the other
// block fills in).
// * Grid (blocks, H, B): the nc chunks of a (row, head) are cut into spans,
//   one block a span, and the blocks of a (row, head) form one thread-block
//   cluster.  Spans: as few as still give two waves of blocks, at most 8 (a
//   portable cluster) and one a chunk: 2 spans of 16 chunks at mamba2-2.7b's
//   training shape (640 blocks), 8 for a batch row or two.  Fewer, longer
//   spans pay the combine and each phase's start less often (8 spans of 4
//   chunks were ~6% slower there on the same card).
// * Phase A walks the span twice (16-byte cp.async into attention_tile.cuh's
//   swizzled tiles): with x and B it forms, from zero, the span's state
//   update U = exp(cs_last) U + (x o w)^T B, writing U before each later
//   chunk (the state entering it from a zero span state) to the chunk's slot
//   of the states workspace and log Dpre (the decay of the span's earlier
//   chunks) to aux; with dy and C its gradient update V = sum of Dpre (dy o
//   exp(cs))^T C.  Each chunk's product (wgmma m64n128k16, the A operand
//   built in registers) is added into U or V kept in fp32 in shared memory:
//   two 64-register accumulators held across the walk spilled.
// * The combine, in the cluster's shared memory: block k owns 1/nb of the
//   16-byte units of U and V and walks them through the spans (mapa and
//   shared::cluster loads and stores), forward from the initial state for S
//   (S = D_m S + U_m) and backward from zero for G (G = D_m G + V_m),
//   leaving in place the S entering and the G leaving each span.  Two
//   cluster barriers; no second launch, no atomics.
// * Each chunk's slot is then rewritten as the S entering it, Dpre S_span +
//   the slot, as the bf16 hi and lo tiles phase B wants (staged in shared
//   memory, stored 16 bytes a thread, the next slot loaded meanwhile): phase
//   B then copies them in with the chunk.  Building them from the fp32 slot
//   in phase B was slower: its 64 loads a thread wait with G in registers.
// * Phase B walks the span in reverse with G, the gradient of the state
//   leaving the chunk, in fp32 registers.  Per chunk: the masked decay L_ij
//   = exp(cs_i - cs_j) once, to shared memory (its lower triangle, 2,080
//   exponentials); D = dy x^T (m64n64k16), masked, decayed, times dt_j, as
//   hi and lo A operands of dC += (D o L o dt) B, after dC = exp(cs_i) dy S
//   (m64n64k16, S's tiles read MN-major, hi and lo; R_i from it), in two
//   halves of 64 columns (one 64-column accumulator at a time: no spills);
//   G to the state tiles; K^T = B C^T and D^T = x dy^T (m64n64k16, both
//   K-major), whose product F^T gives dcs's two sums and whose masked forms
//   are dx's (bf16) and dB's (hi and lo) A operands; dx = w_j B G^T (hi and
//   lo) + (K^T o L o dt) dy; dB = w_j x G + (D^T o L o dt) C in two halves
//   (u_j from x G); G steps back, G = exp(cs_last) G + (dy o exp(cs))^T C
//   (m64n128k16).  Warp 0 turns the 64 rows' sums into dcs, its suffix sums
//   (5 shuffle steps), ddt and the chunk's share of dA.
// * dB and dC are written per head into fp32 workspaces laid out (B, H, S,
//   N), a block's rows one contiguous run, and dA per (row, head, chunk);
//   ssd_bwd_reduce4_kernel sums a group's heads (four columns a thread) and
//   dA's shares in a fixed order.
// * The thread's accumulator offsets go through an empty asm each chunk, so
//   that they are recomputed where used instead of held in registers across
//   the chunk loops (held, they spilled; 255 registers, no spills now).
// Precision.  At the training shape ddt comes out near 1 from terms near
// 900, and chip_smoke.py holds it elementwise to 2e-2: whatever feeds dcs
// needs some 16 bits, not bf16's 8.  x, dy, B and C are exact in bf16, so:
// the state updates' A operands (x o w, dy o exp(cs)) go in as hi + lo bf16
// pairs (two wgmma into one fp32 accumulator); U, V, the combine and G stay
// fp32 (the workspace too); S (hi + lo tiles from the fp32 S) and G enter
// their products as hi + lo tiles; F, u, R and <G, S> are fp32 sums of those
// products, and w_j and exp(cs_i) scale dx's, dB's and dC's terms through G
// and S in fp32.  dB's and dC's masked scores D^T and D also go in as hi +
// lo: rounded to bf16 alone, their O(1) per-head terms left errors near 1%
// of the tensor's RMS, which the row check reads as 0.17 of a small row's
// RMS.  Only dx's masked scores K^T are rounded to bf16, once, as the
// forward rounds its scores; dx, dB and dC are rounded once.
//
// ssd_bwd_kernel (float32): CUDA cores (tensor cores in TF32 cannot hold the
// 1e-4 float32 tolerance).  One block of 256 threads a (head, batch row):
// * Phase 1 walks the chunks forward from the initial state (or zeros) and
//   writes the state entering each chunk to the workspace (B, nc, H, P, N).
// * Phase 2 walks the chunks backward with G in registers (32 values a
//   thread), mirrored in shared memory.  A chunk's B, C, x, dy, the state
//   entering it, G, the masked decayed scores (C.B) L and (dy.x) L fit
//   shared memory whole (~205 KB at P = 64, N = 128; rows padded by one
//   float so that column walks are free of bank conflicts).
// * dB and dC per head (B, S, H, N) and dA per (row, head);
//   ssd_bwd_reduce_kernel sums a group's heads and the rows in order.
//
// Determinism: no atomics anywhere, every sum in a fixed order (the
// cluster's walk, the reductions over heads and dA's shares; the span count
// depends on the card's SM count and the shape, not on timing): two calls
// give the same bits, as launch.train's exact replays need.  The states
// workspace is alive for the call only (under remat, one layer's at a time).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, inputs rotated past the L2): see PERF.md.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile.cuh"

namespace {

constexpr int CH = 64;        // rows per chunk, as the forward's

// ------------------------------------------------------ float32, CUDA cores

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int RP = 4;         // P <= 64: rows of P a thread
constexpr int RN = 8;         // N <= 128: columns of N a thread
constexpr int MP = CH + 1;

size_t smem_floats(int P, int N) {
  const size_t NP = N + 1, XP = P + 1;
  return 2 * CH * NP + 2 * CH * XP + 2 * (size_t)P * NP + 2 * CH * MP + 16 * CH + 9 * CH + 16;
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

__global__ void __launch_bounds__(THREADS) ssd_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ s0,
    const float* __restrict__ dy, float* __restrict__ dx, float* __restrict__ ddt,
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
          in ? Bm[b * sbb + (long long)(c0 + i) * sbs + (long long)g * N + n] : 0.f;
      if (all)
        sC[i * NP + n] =
            in ? Cm[b * scb + (long long)(c0 + i) * scs + (long long)g * N + n] : 0.f;
    }
    for (int idx = tid; idx < CH * P; idx += THREADS) {
      const int i = idx / P, p = idx % P;
      const bool in = i < rows;
      sX[i * XP + p] = in ? x[b * sxb + (long long)(c0 + i) * sxs + (long long)h * P + p] : 0.f;
      if (all)
        sDY[i * XP + p] = in ? dy[(((size_t)b * S + c0 + i) * H + h) * P + p] : 0.f;
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
          float* row = dx + (((size_t)b * S + c0 + j) * H + h) * P;
#pragma unroll
          for (int c = 0; c < RP; ++c)
            if (c < pp16) row[tx + 16 * c] = sDt[j] * k1[a][c] + sW[j] * k2[a][c];
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

// dB and dC: the sum over a group's H / G heads of per-head partials (B, S,
// H, N), in order; dA: the sum over the batch rows, in order.
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
                                      const float* __restrict__ dApart, float* __restrict__ dB,
                                      float* __restrict__ dC, float* __restrict__ dA, int Bsz,
                                      int S, int H, int G, int N) {
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
    dB[e] = sb;
    dC[e] = sc;
  }
  const size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (t < (size_t)H) {
    float s = 0.f;
    for (int b = 0; b < Bsz; ++b) s += dApart[(size_t)b * H + t];
    dA[t] = s;
  }
}

// The bf16 path's: partials laid out (B, H, S, N), four columns a thread,
// rounded once to bf16; dA's shares (B, H, parts), summed over the rows and
// each row's shares in order.
__global__ void ssd_bwd_reduce4_kernel(const float4* __restrict__ dBh,
                                       const float4* __restrict__ dCh,
                                       const float* __restrict__ dApart,
                                       __nv_bfloat162* __restrict__ dB,
                                       __nv_bfloat162* __restrict__ dC, float* __restrict__ dA,
                                       int Bsz, int S, int H, int G, int N4, int parts) {
  const int rep = H / G;
  const size_t total = (size_t)Bsz * S * G * N4, step = (size_t)S * N4;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int n4 = e % N4;
    const size_t bsg = e / N4;
    const int gi = bsg % G;
    const size_t bs = bsg / G;
    const size_t src = ((bs / S * H + (size_t)gi * rep) * S + bs % S) * N4 + n4;
    float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
    for (int r = 0; r < rep; ++r) {
      const float4 u = dBh[src + r * step], v = dCh[src + r * step];
      sb = make_float4(sb.x + u.x, sb.y + u.y, sb.z + u.z, sb.w + u.w);
      sc = make_float4(sc.x + v.x, sc.y + v.y, sc.z + v.z, sc.w + v.w);
    }
    dB[2 * e] = __floats2bfloat162_rn(sb.x, sb.y);
    dB[2 * e + 1] = __floats2bfloat162_rn(sb.z, sb.w);
    dC[2 * e] = __floats2bfloat162_rn(sc.x, sc.y);
    dC[2 * e + 1] = __floats2bfloat162_rn(sc.z, sc.w);
  }
  const size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (t < (size_t)H) {
    float s = 0.f;
    for (int b = 0; b < Bsz; ++b)
      for (int k = 0; k < parts; ++k) s += dApart[((size_t)b * H + t) * parts + k];
    dA[t] = s;
  }
}

// Blocks of 256 threads over `work` elements (at least H, for dA), at most
// 1056 (eight an SM).
int reduce_blocks(size_t work, int H) {
  const size_t need = (work > (size_t)H ? work : (size_t)H) + 255;
  return (int)(need / 256 < 1056 ? need / 256 : 1056);
}

int launch_fp32(const void* x, const void* dt, const void* A, const void* Bm, const void* C,
                const void* s0, const void* dy, void* dx, void* ddt, void* dA, void* dB, void* dC,
                void* states, void* dBh, void* dCh, void* dApart, int Bsz, int S, int H, int G,
                int P, int N, long long sxb, long long sxs, long long sdb, long long sds,
                long long sbb, long long sbs, long long scb, long long scs, cudaStream_t stream) {
  // the opt-in once, for the largest P and N the kernel takes
  static const cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(64, 128) * sizeof(float)));
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<<<dim3(H, Bsz), THREADS, smem_floats(P, N) * sizeof(float), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(C), static_cast<const float*>(s0),
      static_cast<const float*>(dy), static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(states), static_cast<float*>(dBh), static_cast<float*>(dCh),
      static_cast<float*>(dApart), S, H, G, P, N, sxb, sxs, sdb, sds, sbb, sbs, scb, scs);
  const cudaError_t l = cudaGetLastError();
  if (l != cudaSuccess) return (int)l;
  ssd_bwd_reduce_kernel<<<reduce_blocks((size_t)Bsz * S * G * N, H), 256, 0, stream>>>(
      static_cast<const float*>(dBh), static_cast<const float*>(dCh),
      static_cast<const float*>(dApart), static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), Bsz, S, H, G, N);
  return (int)cudaGetLastError();
}

// ------------------------------------------- bfloat16, wgmma, one cluster

constexpr int WP = 64;              // head dim P of the tensor-core kernel
constexpr int WN = 128;             // state dim N
constexpr int MAX_BLOCKS = 8;       // spans (blocks, one cluster) of a (row, head)
constexpr int MIN_BLOCKS = 2;       // blocks an SM the registers are held to
constexpr int UNITS = WP * WN / 4;  // 16-byte units of a (P x N) fp32 state

// Byte offsets from the 1024-aligned base of the block's dynamic shared
// memory: the chunk's x and dy (64 x P bf16) and B and C (64 x N), swizzled
// as attention_tile.cuh's tiles; S or G (P x N) as bf16 hi and lo tiles;
// the chunk's masked decay L (64 x 64 fp32, rows i, pitch LP); then floats:
// per row dt, cs, w, exp(cs), F's row sums, u, R and a factor;
// four warps' column sums of F^T dt; <G, S> by warp, the span's log decay
// and the spans' decays.  Phase A keeps its fp32 U and V (P x N each, row
// major) in place of C, the state tiles and the decay, and loads its chunks
// into x's and B's tiles; the combine walks U and V there.
struct WLayout {
  static constexpr int LP = CH + 1;  // the decay matrix's row pitch, in floats
  static constexpr uint32_t x = 0, dy = CH * WP * 2, b = 2 * CH * WP * 2, c = b + CH * WN * 2,
                            hi = c + CH * WN * 2, lo = hi + WP * WN * 2, dec = lo + WP * WN * 2,
                            vec = dec + CH * LP * 4;
  static constexpr uint32_t v = c, u = lo;  // phase A's V and U (P x N fp32 each)
  static constexpr size_t bytes = 1024 + vec + (12 * CH + 16) * 4;
  static_assert(u + WP * WN * 4 <= vec && v + WP * WN * 4 <= u, "U and V fit");
};

#define SSD_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SSD_F16(d, i) SSD_F4(d, i), SSD_F4(d, i + 4), SSD_F4(d, i + 8), SSD_F4(d, i + 12)

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64), both from shared memory: A
// K-major, B MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n64_t(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : SSD_F16(d, 0), SSD_F16(d, 16)
      : "l"(da), "l"(db));
}

#undef SSD_F16
#undef SSD_F4

// The accumulator layout of thread t (wgmma's, as attention_tile.cuh's Tile):
// rows row(t, h) = 16 (t / 32) + (t % 32) / 4 + 8 h, columns col(t, j, e) =
// 8 j + 2 (t % 4) + (e & 1).  The kernel passes t through an empty asm at
// every chunk, so that the compiler recomputes these offsets where they are
// used rather than holding them in registers across the chunk loops.
__device__ __forceinline__ int row(int t, int h) { return 16 * (t / 32) + (t % 32) / 4 + 8 * h; }
__device__ __forceinline__ int col(int t, int j, int e) { return 8 * j + 2 * (t % 4) + (e & 1); }
__device__ __forceinline__ int opaque(int t) {
  asm volatile("" : "+r"(t));
  return t;
}

// The shared::cluster address of this block's shared address a in block
// `rank`, and 16-byte loads and stores there.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster(uint32_t a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// Byte offset of element (r, c) in a swizzled 64-row bf16 tile W wide.
template <int W>
__device__ __forceinline__ uint32_t at(int r, int c) {
  return tile::tile_offset<W>(r, c & ~7) + (c & 7) * 2;
}

__device__ __forceinline__ float bf_at(const unsigned char* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

// v0, v1 as bf16 pairs: hi rounded, lo what the rounding left.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = tile::pack_bf16(v0 - f.x, v1 - f.y);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = 0.f;
}

// A 64 x N accumulator from a row-major fp32 (64 x N) array, thread t its
// own positions.
__device__ __forceinline__ void get(float (&a)[64], const float* src, int t) {
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 v = *reinterpret_cast<const float2*>(src + row(t, hh) * WN + col(t, j, 0));
      a[4 * j + 2 * hh] = v.x;
      a[4 * j + 2 * hh + 1] = v.y;
    }
}

// A 64 x N fp32 accumulator (rows p, columns n) into the bf16 hi and lo
// tiles (P x N) at byte offsets hi and lo from sm (shared or global memory).
__device__ __forceinline__ void put_split(unsigned char* sm, uint32_t hi, uint32_t lo,
                                          const float (&a)[64], int t) {
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t hv, lv;
      split2(a[4 * j + 2 * hh], a[4 * j + 2 * hh + 1], hv, lv);
      const uint32_t o = at<WN>(row(t, hh), col(t, j, 0));
      *reinterpret_cast<uint32_t*>(sm + hi + o) = hv;
      *reinterpret_cast<uint32_t*>(sm + lo + o) = lv;
    }
}

// a (P x N fp32 in shared memory, row major) = d a + acc at thread t's
// positions, a's old values first to prev when given (i = 0: a = acc).
__device__ __forceinline__ void accumulate(float* a, const float (&acc)[64], float d, int i,
                                           float* prev, int t) {
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float2* q = reinterpret_cast<float2*>(a + row(t, hh) * WN + col(t, j, 0));
      const float2 o = i ? *q : make_float2(0.f, 0.f);
      if (prev) *reinterpret_cast<float2*>(prev + row(t, hh) * WN + col(t, j, 0)) = o;
      *q = make_float2(d * o.x + acc[4 * j + 2 * hh], d * o.y + acc[4 * j + 2 * hh + 1]);
    }
}

// acc (P x N) += (u o f)^T v: u the chunk's 64 x P tile at byte offset tu
// (x or dy), f a factor per row, v its 64 x N tile at tv (B or C) read
// MN-major.  (u o f)^T is built in registers as bf16 hi and lo parts: eight
// wgmma m64n128k16 into acc.
__device__ __forceinline__ void add_outer(float (&acc)[64], const unsigned char* sm,
                                          uint32_t base, uint32_t tu, const float* f,
                                          uint32_t tv, int t) {
  using namespace tile;
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = row(t, r & 1), j = 16 * ks + 8 * (r >> 1) + 2 * (t % 4);
      split2(bf_at(sm + tu + at<WP>(j, p)) * f[j], bf_at(sm + tu + at<WP>(j + 1, p)) * f[j + 1],
             hi[ks][r], lo[ks][r]);
    }
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_rs<WN>(acc, hi[ks], desc_mn_major<WN>(base + tv + ks * 16 * 128));
    wgmma_rs<WN>(acc, lo[ks], desc_mn_major<WN>(base + tv + ks * 16 * 128));
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
}

// acc (64 x 64) = u S[:, 64 half .. 64 half + 63]: u the 64 x P tile at
// shared address ua (K-major), S the P x N state as the hi and lo tiles
// (MN-major, the half's panel): eight wgmma m64n64k16.
__device__ __forceinline__ void times_state(float (&acc)[32], uint32_t ua, uint32_t hi,
                                            uint32_t lo, int half) {
  using namespace tile;
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t da = desc_k_major<WP>(ua + ks * 32);
    wgmma_ss_n64_t(acc, da, desc_mn_major<WP>(hi + half * CH * 128 + ks * 16 * 128));
    wgmma_ss_n64_t(acc, da, desc_mn_major<WP>(lo + half * CH * 128 + ks * 16 * 128));
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
}

// s (64 x 64 scores of thread t) masked to the causal half and decayed:
// s_rc *= L_ij dt_j (j <= i; else 0) with L the chunk's decay (its lower
// triangle), where (i, j) = (r, c) (rows_i) or (c, r).
template <bool rows_i>
__device__ __forceinline__ void mask_decay(float (&s)[32], const float* L, const float* dt,
                                           int t) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row(t, e >> 1), c = col(t, jj, e), i = rows_i ? r : c, j = rows_i ? c : r;
      s[4 * jj + e] = j <= i ? s[4 * jj + e] * L[i * WLayout::LP + j] * dt[j] : 0.f;
    }
}

// acc (64 x W) += F v: F the A fragments of four k16 steps (hi and, with
// LO, lo), v the 64 x W tile at shared address tv (MN-major).
template <int W, bool LO>
__device__ __forceinline__ void add_rs(float (&acc)[W / 2], const uint32_t (&hi)[4][4],
                                       const uint32_t (&lo)[4][4], uint32_t tv) {
  using namespace tile;
  fence_regs(acc);
  wgmma_fence();
  rs_product<W>(acc, hi, tv);
  if (LO) rs_product<W>(acc, lo, tv);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
}

// The 64 x 64 fp32 s as bf16 A fragments, hi and lo.
__device__ __forceinline__ void split_frags(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                            const float (&s)[32]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split2(s[8 * ks + 2 * i], s[8 * ks + 2 * i + 1], hi[ks][i], lo[ks][i]);
}

// d += the dot of each of thread t's two rows of acc (64 x 64, columns 64
// half ..) with the same row and columns of the 64 x N tile at v.
__device__ __forceinline__ void rowdot(float (&d)[2], const float (&acc)[32],
                                       const unsigned char* v, int t, int half) {
#pragma unroll
  for (int j = 0; j < WP / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          v + at<WN>(row(t, hh), CH * half + col(t, j, 0))));
      d[hh] += w.x * acc[4 * j + 2 * hh] + w.y * acc[4 * j + 2 * hh + 1];
    }
}
// d summed over each row's four lanes.
__device__ __forceinline__ void quad_sum(float (&d)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    d[hh] += __shfl_xor_sync(0xffffffffu, d[hh], 1);
    d[hh] += __shfl_xor_sync(0xffffffffu, d[hh], 2);
  }
}

// acc (64 x W) with each row r scaled by f[r].
template <int M>
__device__ __forceinline__ void scale_rows(float (&acc)[M], const float* f, int t) {
  const float f0 = f[row(t, 0)], f1 = f[row(t, 1)];
#pragma unroll
  for (int e = 0; e < M; ++e) acc[e] *= e % 4 < 2 ? f0 : f1;
}

// The rows of acc (64 x 64, columns 64 half ..) below `rows` to rows c0..
// of head h of a (B, H, S, N) fp32 array: a block's rows are one
// contiguous run.
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[32], int b, int S,
                                           int H, int h, int c0, int rows, int t, int half) {
#pragma unroll
  for (int j = 0; j < WP / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row(t, hh);
      if (r < rows)
        *reinterpret_cast<float2*>(dst + (((size_t)b * H + h) * S + c0 + r) * WN + CH * half +
                                   col(t, j, 0)) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
}

__global__ void __launch_bounds__(128, MIN_BLOCKS) ssd_bwd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ s0,
    const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ states, float* __restrict__ dBh,
    float* __restrict__ dCh, float* __restrict__ aux, int S, int H, int G, int span,
    long long sxb, long long sxs, long long sdb, long long sds, long long sbb, long long sbs,
    long long scb, long long scs) {
  using namespace tile;
  using L = WLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(sm);
  float* vec = reinterpret_cast<float*>(sm + L::vec);
  float *sdt = vec, *scm = vec + CH, *sw = vec + 2 * CH, *se = vec + 3 * CH;
  float *scf = vec + 4 * CH, *su = vec + 5 * CH, *sr = vec + 6 * CH, *sf = vec + 7 * CH;
  float *spart = vec + 8 * CH, *sred = vec + 12 * CH;  // [4][CH]; [0..3] <G,S>, [4] log D, [8..] D
  float* sL = reinterpret_cast<float*>(sm + L::dec);  // L_ij = exp(cs_i - cs_j), j <= i
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int k = blockIdx.x, nb = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), nc = (S + CH - 1) / CH, first = k * span;
  const int n = min(span, nc - first);  // chunks of this span, >= 1
  const float Ah = A[h];
  auto slot = [&](int ci) { return states + (((size_t)b * nc + ci) * H + h) * WP * WN; };
  float* dap = aux + ((size_t)b * H + h) * nc;  // per chunk: log Dpre, then its share of dA

  // chunk ci into the tiles (zeros past S), then warp 0 forms cs = inclusive
  // cumsum of dt * A, w = exp(cs_last - cs) dt and exp(cs), two rows a lane.
  // what: 0 its x and B, 1 its dy and C into x's and B's tiles (and the
  // factor exp(cs + logd) a row), 2 x, dy, B, C and its slot (the S entering
  // it as hi and lo tiles).
  auto land = [&](int ci, int what, float logd) {
    const int c0 = ci * CH, rows = min(CH, S - c0);
    __syncthreads();  // the previous chunk's tiles and sums are consumed
    if (tid < CH) {
      if (tid < rows)
        cp_async4(smem_u32(sdt + tid), dt + b * sdb + (long long)(c0 + tid) * sds + h);
      else
        sdt[tid] = 0.f;
    }
    for (int e = tid; e < CH * WP / 8; e += 128) {
      const int r = e / (WP / 8), c = e % (WP / 8) * 8, rr = c0 + min(r, rows - 1);
      const uint32_t off = tile_offset<WP>(r, c);
      if (what != 1)
        cp_async16(base + L::x + off, x + b * sxb + rr * sxs + h * WP + c, r < rows ? 16 : 0);
      if (what != 0)
        cp_async16(base + (what == 1 ? L::x : L::dy) + off,
                   dy + (((size_t)b * S + rr) * H + h) * WP + c, r < rows ? 16 : 0);
    }
    for (int e = tid; e < CH * WN / 8; e += 128) {
      const int r = e / (WN / 8), c = e % (WN / 8) * 8, rr = c0 + min(r, rows - 1);
      const uint32_t off = tile_offset<WN>(r, c);
      if (what != 1)
        cp_async16(base + L::b + off, Bm + b * sbb + rr * sbs + g * WN + c, r < rows ? 16 : 0);
      if (what != 0)
        cp_async16(base + (what == 1 ? L::b : L::c) + off, Cm + b * scb + rr * scs + g * WN + c,
                   r < rows ? 16 : 0);
    }
    if (what == 2)
      for (int e = tid; e < 2 * WP * WN / 8; e += 128)
        cp_async16(base + L::hi + e * 16, slot(ci) + e * 4, 16);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (tid < 32) {
      const float v0 = sdt[2 * tid] * Ah, v1 = sdt[2 * tid + 1] * Ah;
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += u;
      }
      const float excl = incl - (v0 + v1), last = __shfl_sync(0xffffffffu, incl, 31);
      const float c0v = excl + v0;
      scm[2 * tid] = c0v;
      scm[2 * tid + 1] = incl;
      sw[2 * tid] = expf(last - c0v) * sdt[2 * tid];
      sw[2 * tid + 1] = expf(last - incl) * sdt[2 * tid + 1];
      se[2 * tid] = expf(c0v);
      se[2 * tid + 1] = expf(incl);
      if (what == 1) {
        sf[2 * tid] = expf(c0v + logd);
        sf[2 * tid + 1] = expf(incl + logd);
      }
    }
    __syncthreads();
  };

  // ---- phase A: the span's U and V from zero, in shared memory (each
  // thread its own positions): pass 1 walks x and B, U = exp(cs_last) U +
  // (x o w)^T B, writing the state entering each later chunk (from a zero
  // span state) to its slot and log Dpre to aux; pass 2 walks dy and C, V +=
  // (dy o exp(cs) Dpre)^T C
  float* pu = reinterpret_cast<float*>(sm + L::u);
  float* pv = reinterpret_cast<float*>(sm + L::v);
  float logd = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    logd = 0.f;
    for (int i = 0; i < n; ++i) {
      const int ci = first + i;
      land(ci, pass, logd);
      float acc[64];
      zero(acc);
      add_outer(acc, sm, base, L::x, pass ? sf : sw, L::b, tid);
      if (!pass && tid == 0) dap[ci] = logd;
      accumulate(pass ? pv : pu, acc, pass ? 1.f : se[CH - 1], i, pass || !i ? nullptr : slot(ci),
                 opaque(tid));
      logd += scm[CH - 1];
    }
  }

  // ---- the combine.  Block k walks its share of the units of U and V
  // through the spans in order, S forward from the initial state and G
  // backward from zero, leaving in slot m the S entering and the G leaving
  // span m.
  if (tid == 0) sred[4] = logd;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();  // every block's U, V and decay are complete
  if (tid < nb) sred[8 + tid] = expf(*cluster.map_shared_rank(sred + 4, tid));  // D_m
  __syncthreads();
  {
    const int per = (UNITS + nb - 1) / nb, end = min(UNITS, (k + 1) * per);
    const float4* init = s0 ? reinterpret_cast<const float4*>(s0 + ((size_t)b * H + h) * WP * WN)
                            : nullptr;
    for (int unit = k * per + tid; unit < end; unit += 128) {
      // S forward through every span's U, then G backward through every V:
      // the spans' values loaded first, then the walk leaves its own
      float4 w[MAX_BLOCKS], s = init ? init[unit] : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t au = base + L::u + unit * 16, av = base + L::v + unit * 16;
#pragma unroll
      for (int m = 0; m < MAX_BLOCKS; ++m)
        if (m < nb) w[m] = ld_cluster(mapa(au, m));
#pragma unroll
      for (int m = 0; m < MAX_BLOCKS; ++m)
        if (m < nb) {
          const float d = sred[8 + m];
          st_cluster(mapa(au, m), s);
          s = make_float4(d * s.x + w[m].x, d * s.y + w[m].y, d * s.z + w[m].z, d * s.w + w[m].w);
        }
#pragma unroll
      for (int m = 0; m < MAX_BLOCKS; ++m)
        if (m < nb) w[m] = ld_cluster(mapa(av, m));
      s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int mm = 0; mm < MAX_BLOCKS; ++mm) {
        const int m = MAX_BLOCKS - 1 - mm;  // the spans in reverse
        if (m < nb) {
          const float d = sred[8 + m];
          st_cluster(mapa(av, m), s);
          s = make_float4(d * s.x + w[m].x, d * s.y + w[m].y, d * s.z + w[m].z, d * s.w + w[m].w);
        }
      }
    }
  }
  cluster.sync();  // every walk is done: U and V are this block's own again
  // each chunk's slot becomes the S entering it, Dpre S_span + its slot, as
  // the bf16 hi and lo tiles phase B copies in (the slot's first and second
  // 16 KB), staged in x's, dy's and B's place and stored 16 bytes a thread
  // (the next chunk's slot is loaded while this one's tiles are stored)
  float nx[64];
  if (n > 1) get(nx, slot(first + 1), tid);
  for (int i = 0; i < n; ++i) {
    float* sl = slot(first + i);
    const float dpre = i ? expf(dap[first + i]) : 0.f;
    float st[64];
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v = *reinterpret_cast<const float2*>(pu + row(tid, hh) * WN + col(tid, j, 0));
        st[4 * j + 2 * hh] = i ? dpre * v.x + nx[4 * j + 2 * hh] : v.x;
        st[4 * j + 2 * hh + 1] = i ? dpre * v.y + nx[4 * j + 2 * hh + 1] : v.y;
      }
    if (i && i + 1 < n) get(nx, slot(first + i + 1), tid);
    __syncthreads();  // the staging tiles are free
    put_split(sm, L::x, L::x + WP * WN * 2, st, tid);
    __syncthreads();
    for (int e = tid; e < 2 * WP * WN / 8; e += 128)
      reinterpret_cast<float4*>(sl)[e] = *reinterpret_cast<const float4*>(sm + L::x + e * 16);
  }
  float Gr[64];  // the gradient of the state leaving the current chunk
  get(Gr, pv, tid);

  // ---- phase B: the span's chunks in reverse
  for (int i = n - 1; i >= 0; --i) {
    const int ci = first + i, c0 = ci * CH, rows = min(CH, S - c0), t = opaque(tid);
    land(ci, 2, 0.f);
    // the chunk's decay, once: its lower triangle, rows r and 63 - r (65
    // entries) to four threads
    for (int e = tid % 4; e < CH + 1; e += 4) {
      const int r = tid / 4, lo = e <= r, ri = lo ? r : CH - 1 - r, cj = lo ? e : e - r - 1;
      sL[ri * L::LP + cj] = expf(scm[ri] - scm[cj]);
    }
    __syncthreads();  // the decay matrix is complete
    {  // dC = exp(cs_i) dy S + (D o L o dt) B with D = dy x^T; R_i = exp(cs_i) C_i . (dy S)_i
      uint32_t fh[4][4], fl[4][4];
      {
        float s[32];
        zero(s);
        fence_regs(s);
        wgmma_fence();
        ss_product<WP>(s, base + L::dy, base + L::x);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        mask_decay<true>(s, sL, sdt, t);
        split_frags(fh, fl, s);
      }
      float d[2] = {0.f, 0.f};
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {  // N in two halves of 64
        float acc[32];
        times_state(acc, base + L::dy, base + L::hi, base + L::lo, half);
        rowdot(d, acc, sm + L::c, t, half);
        scale_rows(acc, se, t);
        add_rs<WP, true>(acc, fh, fl, base + L::b + half * CH * 128);
        store_rows(dCh, acc, b, S, H, h, c0, rows, t, half);
      }
      quad_sum(d);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (t % 4 == 0) sr[row(t, hh)] = se[row(t, hh)] * d[hh];
    }
    {  // <G, S> with S from its tiles, then G leaving the chunk to the tiles
      float gs = 0.f;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t o = at<WN>(row(t, hh), col(t, j, 0));
          const float2 hv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sm + L::hi + o));
          const float2 lv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sm + L::lo + o));
          gs += Gr[4 * j + 2 * hh] * (hv.x + lv.x) + Gr[4 * j + 2 * hh + 1] * (hv.y + lv.y);
        }
      gs = sum32(gs);
      if (lane == 0) sred[warp] = gs;
      __syncthreads();  // every warp has read S's tiles
      put_split(sm, L::hi, L::lo, Gr, t);
    }
    fence_async_smem();
    __syncthreads();
    // F^T = K^T o L o D^T with K^T = B C^T and D^T = x dy^T (rows j, columns
    // i): its row sums (sum_i F_ij) and its column sums weighted by dt_j, the
    // last over the rows' lanes and then the four warps; then K^T o L o dt
    // (dx's A operand) and D^T o L o dt (dB's, hi and lo)
    uint32_t kf[4][4], fh[4][4], fl[4][4];
    {
      float kt[32], dtt[32];
      zero(kt);
      zero(dtt);
      fence_regs(kt);
      fence_regs(dtt);
      wgmma_fence();
      ss_product<WN>(kt, base + L::b, base + L::c);
      ss_product<WP>(dtt, base + L::x, base + L::dy);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(kt);
      fence_regs(dtt);
      float cf[2] = {0.f, 0.f}, cl[16];
      zero(cl);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rj = row(t, e >> 1), ic = col(t, jj, e);
          const float f = ic >= rj ? kt[4 * jj + e] * dtt[4 * jj + e] * sL[ic * L::LP + rj] : 0.f;
          cf[e >> 1] += f;
          cl[2 * jj + (e & 1)] += f * sdt[rj];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        cf[hh] += __shfl_xor_sync(0xffffffffu, cf[hh], 1);
        cf[hh] += __shfl_xor_sync(0xffffffffu, cf[hh], 2);
        if (t % 4 == 0) scf[row(t, hh)] = cf[hh];
      }
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int off = 4; off < 32; off *= 2) cl[c] += __shfl_xor_sync(0xffffffffu, cl[c], off);
      if (lane < 4)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) spart[warp * CH + col(t, jj, e)] = cl[2 * jj + e];
      mask_decay<false>(kt, sL, sdt, t);
      pack_frags(kf, kt);
      mask_decay<false>(dtt, sL, sdt, t);
      split_frags(fh, fl, dtt);
    }
    {  // dx = w_j (B G^T)_j + (K^T o L o dt) dy
      float acc[32];
      zero(acc);
      fence_regs(acc);
      wgmma_fence();
      ss_product<WN>(acc, base + L::b, base + L::hi);
      ss_product<WN>(acc, base + L::b, base + L::lo);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      scale_rows(acc, sw, t);
      add_rs<WP, false>(acc, kf, kf, base + L::dy);
#pragma unroll
      for (int j = 0; j < WP / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row(t, hh);
          if (r < rows)
            *reinterpret_cast<__nv_bfloat162*>(dx + (((size_t)b * S + c0 + r) * H + h) * WP +
                                               col(t, j, 0)) =
                __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
    }
    {  // dB = w_j (x G)_j + (D^T o L o dt) C; u_j = B_j . (x G)_j
      float d[2] = {0.f, 0.f};
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {  // N in two halves of 64
        float acc[32];
        times_state(acc, base + L::x, base + L::hi, base + L::lo, half);
        rowdot(d, acc, sm + L::b, t, half);
        scale_rows(acc, sw, t);
        add_rs<WP, true>(acc, fh, fl, base + L::c + half * CH * 128);
        store_rows(dBh, acc, b, S, H, h, c0, rows, t, half);
      }
      quad_sum(d);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (t % 4 == 0) su[row(t, hh)] = d[hh];
    }
    if (i) {  // G steps back over the chunk: G = exp(cs_last) G + (dy o exp(cs))^T C
      const float decay = se[CH - 1];
#pragma unroll
      for (int e = 0; e < 64; ++e) Gr[e] *= decay;
      add_outer(Gr, sm, base, L::dy, se, L::c, t);
    }
    __syncthreads();  // the rows' sums are complete
    // warp 0: dcs, its suffix sums da, ddt and this chunk's share of dA,
    // rows 2 lane and 2 lane + 1
    if (tid < 32) {
      const float gsum = sred[0] + sred[1] + sred[2] + sred[3];
      const int i0 = 2 * lane, i1 = i0 + 1;
      const float rt0 = spart[i0] + spart[CH + i0] + spart[2 * CH + i0] + spart[3 * CH + i0];
      const float rt1 = spart[i1] + spart[CH + i1] + spart[2 * CH + i1] + spart[3 * CH + i1];
      const float wu0 = sw[i0] * su[i0], wu1 = sw[i1] * su[i1];
      const float wu_all = sum32(wu0 + wu1);
      float d0 = rt0 - sdt[i0] * scf[i0] + sr[i0] - wu0;
      float d1 = rt1 - sdt[i1] * scf[i1] + sr[i1] - wu1;
      if (i1 == CH - 1) d1 += se[CH - 1] * gsum + wu_all;
      float acc = d0 + d1;  // this lane's and every later lane's
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float u = __shfl_down_sync(0xffffffffu, acc, off);
        if (lane + off < 32) acc += u;
      }
      const float da0 = acc, da1 = acc - d0, last = scm[CH - 1];
      const float dd0 = scf[i0] + expf(last - scm[i0]) * su[i0] + Ah * da0;
      const float dd1 = scf[i1] + expf(last - scm[i1]) * su[i1] + Ah * da1;
      if (i0 < rows) ddt[((size_t)b * S + c0 + i0) * H + h] = dd0;
      if (i1 < rows) ddt[((size_t)b * S + c0 + i1) * H + h] = dd1;
      const float part = sum32(sdt[i0] * da0 + sdt[i1] * da1);
      if (lane == 0) dap[ci] = part;
    }
  }
}

int launch_wgmma(const void* x, const void* dt, const void* A, const void* Bm, const void* C,
                 const void* s0, const void* dy, void* dx, void* ddt, void* dA, void* dB,
                 void* dC, void* states, void* dBh, void* dCh, void* aux, int Bsz, int S, int H,
                 int G, long long sxb, long long sxs, long long sdb, long long sds, long long sbb,
                 long long sbs, long long scb, long long scs, cudaStream_t stream) {
  // spans a (row, head): as few as still give two waves of blocks (MIN_BLOCKS
  // an SM), at most MAX_BLOCKS (one cluster) and one a chunk; fewer, longer
  // spans pay the combine and each phase's start less often
  const int nc = (S + CH - 1) / CH, pairs = Bsz * H;
  const int want = (2 * MIN_BLOCKS * tile::sm_count() + pairs - 1) / pairs;
  const int cap = want < MAX_BLOCKS ? want : MAX_BLOCKS;
  const int span = tile::split_span(nc, nc < cap ? nc : cap);
  const int nb = tile::split_span(nc, span);
  // a cluster launch even for one span (the combine addresses the cluster);
  // the opt-in once
  static const cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WLayout::bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nb;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, H, Bsz);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = WLayout::bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t l = cudaLaunchKernelEx(
      &cfg, ssd_bwd_wgmma_kernel, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const __nv_bfloat16*>(Bm), static_cast<const __nv_bfloat16*>(C),
      static_cast<const float*>(s0), static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ddt), static_cast<float*>(states),
      static_cast<float*>(dBh), static_cast<float*>(dCh), static_cast<float*>(aux), S, H, G, span,
      sxb, sxs, sdb, sds, sbb, sbs, scb, scs);
  if (l == cudaSuccess) l = cudaGetLastError();
  if (l != cudaSuccess) return (int)l;
  ssd_bwd_reduce4_kernel<<<reduce_blocks((size_t)Bsz * S * G * WN / 4, H), 256, 0, stream>>>(
      static_cast<const float4*>(dBh), static_cast<const float4*>(dCh),
      static_cast<const float*>(aux), static_cast<__nv_bfloat162*>(dB),
      static_cast<__nv_bfloat162*>(dC), static_cast<float*>(dA), Bsz, S, H, G, WN / 4, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 if the C entry point sends this dtype to ssd_bwd_wgmma_kernel.
extern "C" int ssd_scan_bwd_route(int dtype) { return dtype == 1; }

// x (B, S, H, P), B and C (B, S, G, N), dy, dx (B, S, H, P), dB and dC (B, S,
// G, N) in the model dtype (dtype 0 = float32, 1 = bfloat16); dt (B, S, H),
// A (H,), s0 (B, H, P, N) or null, ddt (B, S, H), dA (H,) in float32.  x, dt,
// B and C are addressed by their batch and sequence strides (in elements),
// their trailing dimensions packed; dy and the outputs are contiguous.
// Workspaces (float32, contiguous, written before they are read): states
// (B, ceil(S / 64), H, P, N); dBh and dCh (B, S, H, N), in bfloat16 laid out
// (B, H, S, N); aux (B, H,
// ceil(S / 64)) (float32 uses its first B * H entries).  float32: P and N multiples
// of 16, P <= 64, N <= 128.  bfloat16: P = 64, N = 128, x, B and C 16-byte
// aligned with strides that are multiples of 8 elements.  S >= 1.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* C, const void* s0, const void* dy, void* dx, void* ddt,
                            void* dA, void* dB, void* dC, void* states, void* dBh, void* dCh,
                            void* aux, int Bsz, int S, int H, int G, int P, int N,
                            long long sxb, long long sxs, long long sdb, long long sds,
                            long long sbb, long long sbs, long long scb, long long scs,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || H % G) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (P != WP || N != WN) return (int)cudaErrorInvalidValue;
    return launch_wgmma(x, dt, A, Bm, C, s0, dy, dx, ddt, dA, dB, dC, states, dBh, dCh, aux, Bsz,
                        S, H, G, sxb, sxs, sdb, sds, sbb, sbs, scb, scs, s);
  }
  if (P % 16 || N % 16 || P < 16 || P > 64 || N < 16 || N > 128) return (int)cudaErrorInvalidValue;
  return launch_fp32(x, dt, A, Bm, C, s0, dy, dx, ddt, dA, dB, dC, states, dBh, dCh, aux, Bsz, S,
                     H, G, P, N, sxb, sxs, sdb, sds, sbb, sbs, scb, scs, s);
}
