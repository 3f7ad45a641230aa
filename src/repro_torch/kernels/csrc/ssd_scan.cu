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
// -400 over a long chunk and exp(-cs_j) would overflow fp32.  Both kernels
// scan in chunks of 64 rows whatever the caller's chunk is (the function is
// the same; only rounding moves).  Rows past S (the ragged tail) are loaded
// as zeros with dt = 0: they leave the state unchanged and are not written.
// x, dt, B and C are read by their (batch, sequence) strides, so the model's
// views of the conv output need no copy.
//
// Bound on this card: bytes.  At the serving shape (one prompt of S = 400,
// H = 80 heads of P = 64, N = 128, one group, bf16) the function must read
// x (4.1 MB), dt, B and C, and write y (4.1 MB) and the fp32 final state
// (2.6 MB): ~11 MB, about 3.3 us at 3.35 TB/s.  Its products are ~1.2
// GFLOP, 1.2 us on the bf16 tensor cores.
//
// Two kernels; the C entry point picks one by dtype (ssd_scan_route).
//
// ssd_wgmma_kernel (bfloat16, every serve; P = 64, N = 128): chunk-parallel
// on the tensor cores, in the decomposition of the plain version (each
// chunk's own state contribution, then the short recurrence over chunks).
// * Grid (blocks, H, B): the nc chunks of a (row, head) are cut into spans of
//   ceil(nc / min(nc, 8)) consecutive chunks, one block (one warpgroup) a
//   span, and the blocks of a (row, head) form one thread-block cluster (at
//   most 8, the portable size; one span is a cluster of one).  At the
//   serving shape: 7 chunks, 7 blocks a head, 560 blocks, 76 KB of shared
//   memory and at most 168 registers a thread, so three blocks an SM.
// * Phase A: the block walks its span, chunk by chunk (x, B, C by 16-byte
//   cp.async into the 128-byte-swizzled panels of attention_tile.cuh, dt by
//   4-byte cp.async), and accumulates its span's update from a zero state,
//   U = exp(cs_last) U + (x o w)^T B with w = exp(cs_last - cs_j) dt_j
//   (wgmma m64n128k16, the A operand x o w built in registers and rounded to
//   bf16 there, B read MN-major as PV's V), and its span decay D = exp(sum
//   of the chunks' cs_last).  A span of one chunk (every span at S <= 512)
//   also forms that chunk's intra-chunk term here: the scores C.B^T (wgmma
//   m64n64k16, both K-major, as S = QK^T at D = 128, issued with U's
//   product), masked and decayed in fp32 and packed to bf16 as the A operand
//   (as P in PV), times x (MN-major), kept in registers.  U is published in
//   bf16 over the chunk's x and B.
// * The combine, by bulk copies between the cluster's blocks (no workspace,
//   no second launch, no atomics; loads from the other blocks' shared memory
//   were measured slower, PERF.md): block r
//   owns 1/nb of the 16-byte units of S^T.  Every block copies each owner
//   its U over the owner's units and its D; the owner walks its units
//   through the spans in order in fp32 from the initial state (S = S D_m +
//   U_m), writes the final state, and copies back to each block m the bf16
//   state entering span m, which lands in m's S^T.  Each exchange completes
//   on an mbarrier of the receiving block; only the mbarriers' set-up needs
//   a cluster barrier, and it is waited for after phase A.
// * Phase B: y += (C o exp(cs_i)) . S^T_in (C's rows scaled in registers and
//   rounded to bf16, S^T MN-major), eight wgmma m64n64k16, and y is stored
//   in bf16.  A span of more chunks reloads each chunk, forms its
//   intra-chunk term as above, and steps the state on in fp32 registers
//   between its chunks (one batch with the scores' product), writing S^T
//   anew.
// Precision: the scores, x o w, C o exp(cs_i), U and S^T are rounded to bf16
// before their products or copies (fp32 accumulation); the combine's walk
// and the final state are fp32.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (device
// time, inputs rotated past the L2): see PERF.md; attention_variants.py
// times MAX_BLOCKS, STAGES and MIN_BLOCKS.
//
// ssd_kernel (float32): CUDA cores (tensor cores in TF32 cannot hold the
// 1e-4 float32 tolerance).  One block per (head, batch row) walks the chunks
// in order with the (P, N) fp32 state in registers (32 values a thread at
// P = 64, N = 128), mirrored in shared memory for the inter-chunk term; a
// 64-row chunk fits shared memory whole (B, C, x, the decay-masked score
// tile and the state, ~132 KB at N = 128, rows padded by one float so that
// the column walks are free of bank conflicts).
//
// Both kernels set their shared-memory opt-in once, not per launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile.cuh"

namespace {

constexpr int CH = 64;  // rows per chunk

// ------------------------------------------------------ float32, CUDA cores

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int RP = 4;         // P <= 64: output rows per thread in the P axis
constexpr int RN = 8;         // N <= 128: state columns per thread

size_t smem_floats(int P, int N) {
  const int NP = N + 1;
  return 2 * (size_t)CH * NP + (size_t)CH * P + (size_t)CH * (CH + 1) + (size_t)P * NP + 3 * CH;
}

__global__ void __launch_bounds__(THREADS) ssd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ sf, int S, int H, int G, int P, int N,
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
      sB[i * NP + n] = in ? Bm[b * sbb + (c0 + i) * sbs + (long long)g * N + n] : 0.f;
      sC[i * NP + n] = in ? Cm[b * scb + (c0 + i) * scs + (long long)g * N + n] : 0.f;
    }
    for (int idx = tid; idx < CH * P; idx += THREADS) {
      const int i = idx / P, p = idx % P;
      sX[idx] = i < rows ? x[b * sxb + (c0 + i) * sxs + (long long)h * P + p] : 0.f;
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
        float* yrow = y + (((size_t)b * S + c0 + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < RP; ++c)
          if (c < pp16) yrow[tx + 16 * c] = acc[a][c] + decay * inter[a][c];
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

int launch_fp32(const void* x, const void* dt, const void* A, const void* Bm, const void* C,
                const void* s0, void* y, void* sf, int Bsz, int S, int H, int G, int P, int N,
                long long sxb, long long sxs, long long sdb, long long sds, long long sbb,
                long long sbs, long long scb, long long scs, cudaStream_t stream) {
  // the opt-in once, for the largest P and N the kernel takes
  static const cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(64, 128) * sizeof(float)));
  if (e != cudaSuccess) return (int)e;
  ssd_kernel<<<dim3(H, Bsz), THREADS, smem_floats(P, N) * sizeof(float), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(C), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sf), S, H, G, P, N, sxb, sxs, sdb, sds, sbb, sbs,
      scb, scs);
  return (int)cudaGetLastError();
}

// ------------------------------------------- bfloat16, wgmma, one cluster

constexpr int WP = 64;          // head dim P of the tensor-core kernel
constexpr int WN = 128;         // state dim N
constexpr int MAX_BLOCKS = 8;   // spans (blocks, one cluster) of a (row, head)
constexpr int STAGES = 1;       // chunk stages (2: a longer span prefetches its next chunk)
constexpr int MIN_BLOCKS = 3;   // blocks an SM the registers are held to
constexpr int UNITS = WN * WP * 2 / 16;  // 16-byte units of an (N x P) bf16 tile

// Byte offsets from the 1024-aligned base of the block's dynamic shared
// memory: STAGES chunk stages (x 64 x P, B and C 64 x N, bf16, swizzled as
// attention_tile.cuh's tiles); S^T (N x P bf16, swizzled, the inter-chunk
// operand); the inbox of the combine (every span's U over this block's share
// of the units, a slot a span, then their decays, 16 bytes each); per stage
// dt, cs and w (64 floats each); two mbarriers (inbox, S^T); this span's
// decay, a 16-byte record.  The published update U (bf16, S^T's layout)
// takes the place of stage 0's x and B once phase A is done with them.
struct WLayout {
  static constexpr uint32_t XB = CH * WP * 2, NB = CH * WN * 2, STAGE = XB + 2 * NB;
  __host__ __device__ static constexpr uint32_t x(int s) { return s * STAGE; }
  __host__ __device__ static constexpr uint32_t b(int s) { return s * STAGE + XB; }
  __host__ __device__ static constexpr uint32_t c(int s) { return s * STAGE + XB + NB; }
  static constexpr uint32_t u = 0;
  static constexpr uint32_t st = STAGES * STAGE;
  static constexpr uint32_t inbox = st + UNITS * 16;
  static constexpr uint32_t dec_in = inbox + (UNITS + MAX_BLOCKS) * 16;
  static constexpr uint32_t vec = dec_in + MAX_BLOCKS * 16;
  static constexpr uint32_t bar = vec + STAGES * 3 * CH * 4;
  static constexpr uint32_t dec = bar + 16;
  static constexpr size_t bytes = 1024 + dec + 16;
  static_assert(UNITS * 16 <= XB + NB, "U fits in stage 0's x and B");
};

// The shared::cluster address of local shared address a in block `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// Bulk copy of `bytes` (a multiple of 16) from this block's shared memory to
// dst in a block of the cluster, completing on that block's mbarrier.
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk copies have finished reading their sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__global__ void __launch_bounds__(128, MIN_BLOCKS) ssd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ s0,
    __nv_bfloat16* __restrict__ y, float* __restrict__ sf, int S, int H, int G, int span,
    long long sxb, long long sxs, long long sdb, long long sds, long long sbb, long long sbs,
    long long scb, long long scs) {
  using namespace tile;
  using L = WLayout;
  using T = Tile<WP>;  // the accumulator layout: rows T::row(h), columns T::col(j, e)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(sm);
  float* vec = reinterpret_cast<float*>(sm + L::vec);  // [STAGES][dt, cs, w][CH]
  const int tid = threadIdx.x, q = tid % 4, r0 = T::row(0);
  const int k = blockIdx.x, nb = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), first = k * span;
  const int n = min(span, (S + CH - 1) / CH - first);  // chunks of this span, >= 1
  const float Ah = A[h];
  // the combine's units (16 bytes of S^T) are cut into nb shares, one a block
  const int per = (UNITS + nb - 1) / nb;
  auto share = [&](int r) { return min(UNITS, (r + 1) * per) - r * per; };
  const uint32_t bar_in = base + L::bar, bar_st = bar_in + 8;
  if (tid == 0) {
    mbar_init(bar_in, 1);
    mbar_init(bar_st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_in, nb * (share(k) + 1) * 16);  // every span's U and decay
    mbar_expect_tx(bar_st, UNITS * 16);                 // S^T, from every block
  }
  cluster_arrive();  // waited for once phase A is done

  // chunk i of the span into stage i % STAGES: one cp.async group
  auto load = [&](int i) {
    const int st = i % STAGES, c0 = (first + i) * CH, rows = min(CH, S - c0);
    float* sdt = vec + st * 3 * CH;
    if (tid < CH) {
      if (tid < rows)
        cp_async4(smem_u32(sdt + tid), dt + b * sdb + (long long)(c0 + tid) * sds + h);
      else
        sdt[tid] = 0.f;
    }
    for (int e = tid; e < CH * WP / 8; e += 128) {
      const int r = e / (WP / 8), c = e % (WP / 8) * 8, rr = c0 + min(r, rows - 1);
      cp_async16(base + L::x(st) + tile_offset<WP>(r, c), x + b * sxb + rr * sxs + h * WP + c,
                 r < rows ? 16 : 0);
    }
    for (int e = tid; e < CH * WN / 8; e += 128) {
      const int r = e / (WN / 8), c = e % (WN / 8) * 8, rr = c0 + min(r, rows - 1);
      const uint32_t off = tile_offset<WN>(r, c);
      cp_async16(base + L::b(st) + off, Bm + b * sbb + rr * sbs + g * WN + c, r < rows ? 16 : 0);
      cp_async16(base + L::c(st) + off, Cm + b * scb + rr * scs + g * WN + c, r < rows ? 16 : 0);
    }
  };
  auto issue = [&](int i) {
    if (i < n) load(i);
    cp_async_commit();
  };
  // wait for chunk i (issuing chunk i + STAGES - 1 first), then warp 0 forms
  // cs = inclusive cumsum of dt * A and w = exp(cs_last - cs) dt, two rows a lane
  auto land = [&](int i) {
    __syncthreads();  // chunk i - 1 consumed: its stage may be refilled
    issue(i + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    fence_async_smem();
    __syncthreads();
    float* sdt = vec + i % STAGES * 3 * CH;
    if (tid < 32) {
      const float v0 = sdt[2 * tid] * Ah, v1 = sdt[2 * tid + 1] * Ah;
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const float excl = incl - (v0 + v1), last = __shfl_sync(0xffffffffu, incl, 31);
      sdt[CH + 2 * tid] = excl + v0;
      sdt[CH + 2 * tid + 1] = incl;
      sdt[2 * CH + 2 * tid] = expf(last - (excl + v0)) * sdt[2 * tid];
      sdt[2 * CH + 2 * tid + 1] = expf(last - incl) * sdt[2 * tid + 1];
    }
    __syncthreads();
  };
  // The products of the chunk in stage st, the first two as one batch.
  // state (when given): *state = exp(cs_last) *state + (x o w)^T B, the A
  // operand x o w (w = exp(cs_last - cs_j) dt_j) built in registers.  acc
  // (when given): *acc += the intra-chunk term, the scores C.B^T masked (j <=
  // i) and decayed (exp(cs_i - cs_j) dt_j) in fp32, as bf16 A operand, times x.
  auto products = [&](float(*state)[WN / 2], float(*acc)[32], int st) {
    const float* sdt = vec + st * 3 * CH;
    const float *scs = sdt + CH, *sw = sdt + 2 * CH;
    uint32_t xa[4][4];  // A = (x o w)^T: row p, column j
    if (state) {
      const float decay = expf(scs[CH - 1]);
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) (*state)[e] *= decay;
      const unsigned char* sx = sm + L::x(st);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = r0 + 8 * (r & 1), j = 16 * ks + 8 * (r >> 1) + 2 * q;
          auto xv = [&](int jj) {  // x[jj][p]: rows of the swizzled tile
            return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                sx + tile_offset<WP>(jj, p & ~7) + (p & 7) * 2));
          };
          xa[ks][r] = pack_bf16(xv(j) * sw[j], xv(j + 1) * sw[j + 1]);
        }
      fence_regs(*state);
    }
    float cb[32];
    if (acc) {
#pragma unroll
      for (int e = 0; e < 32; ++e) cb[e] = 0.f;
      fence_regs(cb);
    }
    wgmma_fence();
    if (acc)
#pragma unroll
      for (int kk = 0; kk < WN / 16; ++kk) {
        const uint32_t off = (kk * 16 / 64) * (CH * 128) + (kk * 16 % 64) * 2;
        wgmma_ss_n64(cb, desc_k_major<WN>(base + L::c(st) + off),
                     desc_k_major<WN>(base + L::b(st) + off));
      }
    if (state)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs<WN>(*state, xa[ks], desc_mn_major<WN>(base + L::b(st) + ks * 16 * 128));
    wgmma_commit();
    wgmma_wait0();
    if (state) fence_regs(*state);
    if (!acc) return;
    fence_regs(cb);
    const float csr[2] = {scs[r0], scs[r0 + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = T::col(j, e);
        cb[4 * j + e] = c <= T::row(e >> 1)
                            ? cb[4 * j + e] * expf(csr[e >> 1] - scs[c]) * sdt[c] : 0.f;
      }
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[ks][r] = pack_bf16(cb[8 * ks + 2 * r], cb[8 * ks + 2 * r + 1]);
    fence_regs(*acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs<WP>(*acc, pa[ks], desc_mn_major<WP>(base + L::x(st) + ks * 16 * 128));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(*acc);
  };
  // acc += (C o exp(cs_i)) . S^T (C's rows scaled in registers), then the
  // rows of chunk i (stage st) that exist are stored as y
  auto inter_store = [&](float(&acc)[32], int i, int st) {
    const float* scs = vec + st * 3 * CH + CH;
    const float er[2] = {expf(scs[r0]), expf(scs[r0 + 8])};
    uint32_t ca[WN / 16][4];
#pragma unroll
    for (int ks = 0; ks < WN / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i_ = r0 + 8 * (r & 1), nn = 16 * ks + 8 * (r >> 1) + 2 * q;
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            sm + L::c(st) + tile_offset<WN>(i_, nn & ~7) + (nn & 7) * 2));
        ca[ks][r] = pack_bf16(v.x * er[r & 1], v.y * er[r & 1]);
      }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WN / 16; ++ks)
      wgmma_rs<WP>(acc, ca[ks], desc_mn_major<WP>(base + L::st + ks * 16 * 128));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    const int c0 = (first + i) * CH, rows = min(CH, S - c0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = T::row(hh);
        if (row < rows)
          *reinterpret_cast<__nv_bfloat162*>(y + (((size_t)b * S + c0 + row) * H + h) * WP +
                                             T::col(j, 0)) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
  };
  auto zero = [](auto& a) {
#pragma unroll
    for (int e = 0; e < (int)(sizeof(a) / sizeof(a[0])); ++e) a[e] = 0.f;
  };

  // ---- phase A: this span's update from a zero state and its decay (and,
  // for a span of one chunk, that chunk's intra-chunk term)
  float u[WN / 2], yacc[32];
  zero(u);
  zero(yacc);
  float log_decay = 0.f;
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    land(i);
    if (n == 1)
      products(&u, &yacc, 0);
    else
      products(&u, nullptr, i % STAGES);
    log_decay += vec[i % STAGES * 3 * CH + 2 * CH - 1];
  }
  cp_async_wait<0>();
  __syncthreads();  // every product has read x and B: U takes their place
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = T::row(e >> 1), nn = T::col(j, e);
      *reinterpret_cast<__nv_bfloat16*>(sm + L::u + tile_offset<WP>(nn, p & ~7) + (p & 7) * 2) =
          __float2bfloat16(u[4 * j + e]);
    }
  if (tid == 0)
    *reinterpret_cast<float4*>(sm + L::dec) = make_float4(expf(log_decay), 0.f, 0.f, 0.f);
  fence_async_smem();  // U and D, before the bulk copies read them
  __syncthreads();

  // ---- the combine.  Block r owns units [r * per, r * per + share(r)) of
  // S^T.  Each block sends every owner its U over the owner's units and its
  // decay (bulk copies into the owner's inbox, slot k); the owner walks its
  // units through the spans in order in fp32 from the initial state,
  // leaving in slot m the bf16 state entering span m, and sends slot m into
  // block m's S^T; what leaves the last span is the final state.  Copies
  // only: no block reads another's shared memory.
  cluster_wait();  // every block's mbarriers are initialised
  if (tid < nb) {
    bulk_to_peer(mapa(base + L::inbox + k * per * 16, tid), base + L::u + tid * per * 16,
                 share(tid) * 16, mapa(bar_in, tid));
    bulk_to_peer(mapa(base + L::dec_in + k * 16, tid), base + L::dec, 16, mapa(bar_in, tid));
    bulk_commit();
  }
  mbar_wait(bar_in, 0);
  const float* dec = reinterpret_cast<const float*>(sm + L::dec_in);
  const size_t state0 = ((size_t)b * H + h) * WP * WN;
  for (int i = tid; i < share(k); i += 128) {
    const int unit = k * per + i, nn = unit / 8, p0 = (unit % 8 ^ nn % 8) * 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = s0 ? s0[state0 + (p0 + e) * WN + nn] : 0.f;
#pragma unroll
    for (int m = 0; m < MAX_BLOCKS; ++m) {
      if (m >= nb) break;
      uint4* slot = reinterpret_cast<uint4*>(sm + L::inbox + (m * per + i) * 16);
      const uint4 um = *slot;
      *slot = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                         pack_bf16(v[6], v[7]));
      const uint32_t w4[4] = {um.x, um.y, um.z, um.w};
      const float d = dec[4 * m];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // bf16 pairs: low half first
        v[2 * e] = v[2 * e] * d + __uint_as_float(w4[e] << 16);
        v[2 * e + 1] = v[2 * e + 1] * d + __uint_as_float(w4[e] & 0xffff0000u);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sf[state0 + (p0 + e) * WN + nn] = v[e];
  }
  fence_async_smem();  // the slots, before the bulk copies read them
  __syncthreads();
  if (tid < nb) {
    bulk_to_peer(mapa(base + L::st + k * per * 16, tid), base + L::inbox + tid * per * 16,
                 share(k) * 16, mapa(bar_st, tid));
    bulk_commit();
  }
  mbar_wait(bar_st, 0);  // this block's S^T is complete
  if (tid < nb) bulk_wait_read();  // (and so is every copy this block sent)

  // ---- phase B: y of each chunk of the span
  if (n == 1) {
    inter_store(yacc, 0, 0);
    return;
  }
  float s[WN / 2];  // the state entering the chunk, fp32, from the bf16 S^T
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = T::row(e >> 1), nn = T::col(j, e);
      s[4 * j + e] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
          sm + L::st + tile_offset<WP>(nn, p & ~7) + (p & 7) * 2));
    }
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    land(i);
    const int st = i % STAGES;
    zero(yacc);
    if (i + 1 == n) {
      products(nullptr, &yacc, st);
      inter_store(yacc, i, st);
      break;
    }
    products(&s, &yacc, st);  // s: the state entering the next chunk
    inter_store(yacc, i, st);
    __syncthreads();  // every warp's inter-chunk product has read S^T
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = T::row(e >> 1), nn = T::col(j, e);
        *reinterpret_cast<__nv_bfloat16*>(sm + L::st + tile_offset<WP>(nn, p & ~7) +
                                          (p & 7) * 2) = __float2bfloat16(s[4 * j + e]);
      }
    fence_async_smem();
  }
}

int launch_wgmma(const void* x, const void* dt, const void* A, const void* Bm, const void* C,
                 const void* s0, void* y, void* sf, int Bsz, int S, int H, int G,
                 long long sxb, long long sxs, long long sdb, long long sds, long long sbb,
                 long long sbs, long long scb, long long scs, cudaStream_t stream) {
  const int nc = (S + CH - 1) / CH;
  const int span = tile::split_span(nc, nc < MAX_BLOCKS ? nc : MAX_BLOCKS);
  const int nb = tile::split_span(nc, span);
  // a cluster launch even for one span: the combine's copies and barriers
  // address the cluster; the opt-in once
  static const cudaError_t e = cudaFuncSetAttribute(
      ssd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WLayout::bytes);
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
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, ssd_wgmma_kernel, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(s0),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(sf), S, H, G, span, sxb, sxs, sdb, sds,
      sbb, sbs, scb, scs);
  return (int)(l != cudaSuccess ? l : cudaGetLastError());
}

}  // namespace

// 1 if the C entry point sends this dtype to ssd_wgmma_kernel.
extern "C" int ssd_scan_route(int dtype) { return dtype == 1; }

// x (B, S, H, P) and y in the model dtype (dtype 0 = float32, 1 = bfloat16);
// dt (B, S, H), A (H,), s0 (B, H, P, N) or null, sf (B, H, P, N) in float32.
// x, dt, B and C are addressed by their batch and sequence strides (in
// elements); their trailing (H, P), H and (G, N) dimensions are packed.
// y and sf are contiguous.  float32: P and N multiples of 16, P <= 64,
// N <= 128.  bfloat16: P = 64, N = 128, x, B and C 16-byte aligned with
// strides that are multiples of 8 elements.  S >= 1.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* C, const void* s0, void* y, void* sf, int Bsz, int S, int H,
                        int G, int P, int N, long long sxb, long long sxs, long long sdb,
                        long long sds, long long sbb, long long sbs, long long scb,
                        long long scs, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (P != WP || N != WN) return (int)cudaErrorInvalidValue;
    return launch_wgmma(x, dt, A, Bm, C, s0, y, sf, Bsz, S, H, G, sxb, sxs, sdb, sds, sbb, sbs,
                        scb, scs, st);
  }
  return launch_fp32(x, dt, A, Bm, C, s0, y, sf, Bsz, S, H, G, P, N, sxb, sxs, sdb, sds, sbb,
                     sbs, scb, scs, st);
}
