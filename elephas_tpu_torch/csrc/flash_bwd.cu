// Flash-attention backward for Hopper (sm_90a): the dQ and dK/dV kernels.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` in
// elephas_tpu/ops/pallas_attention.py (launched by `_bwd_calls`). Given
// q, k, v, dO, the forward's per-row logsumexp and delta = rowsum(dO*O)
// (computed outside, and possibly GLOBAL row statistics of a ring), they
// recompute the probabilities tile by tile and accumulate, in f32,
//
//   P = exp(S - lse),  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO,
//
// masked on global positions (q_offset / k_offset) with the causal and
// sliding-window rules. Ragged lengths are masked in the kernel, never
// padded in memory: keys k >= Sk and query rows q >= Sq (whose lse is
// not a statistic of anything) contribute nothing. A fully masked row
// (lse ~ -1e30) never reaches the exponential. GQA maps each query head
// to its kv row; every query head of a group adds into its kv head.
//
// Design. The JAX split into two kernels is kept; neither needs atomics,
// so two runs give the same bits.
// - dQ: one CTA per (batch*head, q tile) loops over the K/V tiles from
//   the window's lower edge up to the causal diagonal and keeps dQ in
//   registers, written once.
// - dK/dV: one CTA per (batch*kv_head, 128-row k tile) loops over the
//   group's query heads and, for each, over the q tiles that can see
//   this k tile (the kv-major grid of `_bwd_calls`), keeping dK and dV
//   in registers, written once.
// Every body is instantiated at head_dim 16, 32 and 64, the head dims
// of the repo's configurations (hopper.cuh `with_head_dim`). Bodies:
// - dK/dV, bf16 (the working type): CTAs of the first k tiles (the most
//   live q tiles under causal masking) scheduled first. One producer
//   warp TMA-loads K and V once and then, per live q tile, Q and dO
//   into a 6-stage ring of shared memory guarded by full/empty
//   mbarriers; its lanes stage that tile's lse (times log2 e) and delta
//   beside them (a 1-D bulk copy would need 16-byte aligned rows, which
//   a ragged Sq does not give). A tile row is the head's 2*D bytes in
//   the swizzle of that width (128, 64 or 32 bytes; hopper.cuh `Rows`).
//   Two consumer warpgroups of 64 key rows compute S^T = K Q^T and dP^T
//   = V dO^T with wgmma m64n64k16 (D/16 k steps) from shared memory,
//   form P = exp2(S^T scale log2 e - lse log2 e) and dS = P (dP -
//   delta) scale on the accumulators in registers (the per-element mask
//   only on tiles that hold a masked pair), pack both to bf16 in
//   registers (the TPU kernels' `p.astype(do.dtype)` and
//   `ds.astype(q.dtype)`) and feed them as the register A operand of dV
//   += P^T dO and dK += dS^T Q (m64nDk16, dO and Q MN-major from the
//   ring).
// - dQ, bf16: the same shape turned q-major. One CTA per (batch*head,
//   128-row q tile), the last q tiles (the most live K/V tiles under
//   causal masking) scheduled first. The producer warp TMA-loads Q and
//   dO once, then streams the live 64-row K and V tiles through a
//   6-stage ring under full/empty mbarriers. Each of two consumer
//   warpgroups owns 64 query rows, whose lse (times log2 e) and delta
//   it holds in registers (two rows a thread), and per K/V tile computes
//   S = Q K^T and dP = dO V^T with wgmma m64n64k16 from shared memory
//   (P formed from S while dP is still in flight), dS = P (dP - delta)
//   scale on the accumulators, packed to bf16 (`ds.astype(k.dtype)`)
//   as the register A operand of dQ += dS K (m64nDk16, K MN-major from
//   the same ring slot, with the transpose bit). A warpgroup whose rows
//   meet no key of a tile skips its products. dQ leaves through the
//   warpgroup's Q rows in shared memory in 16-byte stores, rows past Sq
//   dropped.
// - f32 (both kernels): 256 threads on the CUDA cores, each holding a
//   4x4 block of the 64x64 score tile and a 4x(D/16) block of every
//   accumulator.
//
// What bounds it on the H100. At the training shape (B 8, H 16, S 1024,
// D 64, causal, bf16) dQ needs 3 products (S, dP, dQ) and dK/dV 4 (S,
// dP, dV, dK) of 2*D flops per unmasked (q, k) pair: 25.8 and 34.4
// GFLOP against about 85 and 102 MB of inputs and outputs, so both sit
// at the ridge (dQ: 0.026 ms of operations at 989 TFLOP/s, 0.025 ms of
// bytes at 3.35 TB/s). Both bodies run their products in two dependent
// steps per tile within a warpgroup (S and dP, then dQ or dV and dK),
// with the elementwise step between them on the CUDA cores and MUFU;
// the second warpgroup and the ring's prefetch overlap them. At head_dim
// 32 and 16 the products shrink with D while the elementwise step per
// (q, k) pair does not, so it takes a larger share of each tile.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace etpu;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;          // f32 bodies: query rows per tile
constexpr int BK = 64;          // f32 bodies: key rows per tile
constexpr int THREADS = 256;    // f32 bodies: 16 x 16 threads, 4 x 4 each

// lse and delta of query rows [q0, q0 + BQ) into shared memory; rows past
// Sq read 0 (they are masked out of every product).
template <int NT>
__device__ __forceinline__ void stage_stats(float* lse_s, float* delta_s,
                                            const float* lse,
                                            const float* delta, int q0,
                                            int Sq) {
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const bool in = q0 + i < Sq;
    lse_s[i] = in ? lse[q0 + i] : 0.f;
    delta_s[i] = in ? delta[q0 + i] : 0.f;
  }
}

// ------------------------------------------------------- f32, CUDA cores
template <int D>
struct F32Layout {
  static constexpr int LD = D + 1;   // operand tiles; +1 spreads banks
  static constexpr int LDP = BK + 1;
  // four operand tiles, two 64 x 64 probability tiles, lse and delta
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)4 * 64 * LD + (size_t)2 * 64 * LDP + 2 * 64);
};

template <int D>
struct F32Smem {
  float *a, *b, *c, *d, *p, *ds, *lse, *delta;
  __device__ explicit F32Smem(float* raw) {
    using L = F32Layout<D>;
    a = raw;
    b = a + 64 * L::LD;
    c = b + 64 * L::LD;
    d = c + 64 * L::LD;
    p = d + 64 * L::LD;
    ds = p + 64 * L::LDP;
    lse = ds + 64 * L::LDP;
    delta = lse + 64;
  }
};

// The thread's 4 x 4 blocks of X1 Y1^T and X2 Y2^T: rows ty*4 + i of the
// X tiles against rows tx + 16*j of the Y tiles (all stride LD).
template <int D>
__device__ __forceinline__ void dots4x4(const float* x1, const float* y1,
                                        const float* x2, const float* y2,
                                        int ty, int tx, float (&o1)[4][4],
                                        float (&o2)[4][4]) {
  constexpr int LD = F32Layout<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o1[i][j] = o2[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a1[4], a2[4], b1[4], b2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a1[i] = x1[(ty * 4 + i) * LD + d];
      a2[i] = x2[(ty * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b1[j] = y1[(tx + 16 * j) * LD + d];
      b2[j] = y2[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o1[i][j] = fmaf(a1[i], b1[j], o1[i][j]);
        o2[i][j] = fmaf(a2[i], b2[j], o2[i][j]);
      }
  }
}

// acc[i][j] += sum_c P[ty*4 + i][c] * Y[c][tx + 16*j] over the 64 rows
// of the Y tile.
template <int D>
__device__ __forceinline__ void accumulate4(float (&acc)[4][D / 16],
                                            const float* p, const float* y,
                                            int ty, int tx) {
  constexpr int LD = F32Layout<D>::LD, LDP = F32Layout<D>::LDP;
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty * 4 + i) * LDP + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float yv = y[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], yv, acc[i][j]);
    }
  }
}

template <int D>
__device__ __forceinline__ void write4(const float (&acc)[4][D / 16],
                                       float* out, int row0, int limit,
                                       int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= limit) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      out[(size_t)r * D + tx + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int KVH, int Sq,
                        int Sk, int q_offset, int k_offset, int causal,
                        int window, float scale) {
  using L = F32Layout<D>;
  extern __shared__ float smem_f[];
  const F32Smem<D> sm(smem_f);
  float *Qs = sm.a, *dOs = sm.b, *Ks = sm.c, *Vs = sm.d;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int h = bh % H;
  const int kv_row = (bh / H) * KVH + h / (H / KVH);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage_rows<D, L::LD, THREADS>(Qs, q + (size_t)bh * Sq * D, q0, BQ, Sq);
  stage_rows<D, L::LD, THREADS>(dOs, dout + (size_t)bh * Sq * D, q0, BQ,
                                Sq);
  stage_stats<THREADS>(sm.lse, sm.delta, lse + (size_t)bh * Sq,
                       delta + (size_t)bh * Sq, q0, Sq);
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int nk = (Sk + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    if (!rows_meet(q0, q0 + BQ - 1, k0, k0 + BK - 1, q_offset, k_offset,
                   causal, window))
      continue;
    __syncthreads();
    stage_rows<D, L::LD, THREADS>(Ks, k + (size_t)kv_row * Sk * D, k0, BK,
                                  Sk);
    stage_rows<D, L::LD, THREADS>(Vs, v + (size_t)kv_row * Sk * D, k0, BK,
                                  Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dots4x4<D>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (pair_valid(q0 + r, k0 + c, Sq, Sk, q_offset, k_offset, causal,
                       window)) {
          const float p = expf(s[i][j] * scale - sm.lse[r]);
          ds = p * (dp[i][j] - sm.delta[r]) * scale;
        }
        sm.ds[r * L::LDP + c] = ds;
      }
    }
    __syncthreads();
    accumulate4<D>(acc, sm.ds, Ks, ty, tx);   // dQ += dS K
  }
  write4<D>(acc, dq + (size_t)bh * Sq * D, q0, Sq, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int KVH, int Sq, int Sk, int q_offset,
                         int k_offset, int causal, int window,
                         float scale) {
  using L = F32Layout<D>;
  extern __shared__ float smem_f[];
  const F32Smem<D> sm(smem_f);
  float *Ks = sm.a, *Vs = sm.b, *Qs = sm.c, *dOs = sm.d;
  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int grp = H / KVH;
  const int qrow0 = (bkv / KVH) * H + (bkv % KVH) * grp;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage_rows<D, L::LD, THREADS>(Ks, k + (size_t)bkv * Sk * D, k0, BK, Sk);
  stage_rows<D, L::LD, THREADS>(Vs, v + (size_t)bkv * Sk * D, k0, BK, Sk);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < grp; ++g) {
    const size_t bh = (size_t)qrow0 + g;
    for (int qi = 0; qi < nq; ++qi) {
      const int q0 = qi * BQ;
      if (!rows_meet(q0, q0 + BQ - 1, k0, k0 + BK - 1, q_offset, k_offset,
                     causal, window))
        continue;
      __syncthreads();
      stage_rows<D, L::LD, THREADS>(Qs, q + bh * Sq * D, q0, BQ, Sq);
      stage_rows<D, L::LD, THREADS>(dOs, dout + bh * Sq * D, q0, BQ, Sq);
      stage_stats<THREADS>(sm.lse, sm.delta, lse + bh * Sq, delta + bh * Sq,
                           q0, Sq);
      __syncthreads();
      // S^T and dP^T: key rows ty*4 + i against query rows tx + 16*j
      float s[4][4], dp[4][4];
      dots4x4<D>(Ks, Qs, Vs, dOs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float p = 0.f, ds = 0.f;
          if (pair_valid(q0 + c, k0 + r, Sq, Sk, q_offset, k_offset, causal,
                         window)) {
            p = expf(s[i][j] * scale - sm.lse[c]);
            ds = p * (dp[i][j] - sm.delta[c]) * scale;
          }
          sm.p[r * L::LDP + c] = p;
          sm.ds[r * L::LDP + c] = ds;
        }
      }
      __syncthreads();
      accumulate4<D>(dv_acc, sm.p, dOs, ty, tx);   // dV += P^T dO
      accumulate4<D>(dk_acc, sm.ds, Qs, ty, tx);   // dK += dS^T Q
    }
  }
  const size_t base = (size_t)bkv * Sk * D;
  write4<D>(dk_acc, dk + base, k0, Sk, ty, tx);
  write4<D>(dv_acc, dv + base, k0, Sk, ty, tx);
}

// ------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, KVH, Sq, Sk, q_offset, k_offset, causal, window;
  float scale;
  cudaStream_t stream;
};

// ------------------------------------ dK/dV bf16: wgmma over TMA tiles
namespace dkv {

constexpr int KROWS = 128;          // key rows per CTA: 2 warpgroups x 64
constexpr int QROWS = 64;           // query rows per ring stage
constexpr int STAGES = 6;           // Q/dO tiles in flight
constexpr int THREADS = 2 * 128 + 32;  // 2 consumer warpgroups + producer

template <int D>
struct Layout {
  // K, V (16 KB each at D 64), the Q ring, the dO ring (8 KB tiles at D
  // 64), the lse/delta ring (64 + 64 f32 per stage), then the barriers:
  // kvfull, full[STAGES], empty[STAGES]; +1024 for alignment. 131 KB at
  // D 64, 68 KB at D 32, 36 KB at D 16 (the stage count stays, as in
  // flash_fwd.cu); no setmaxnreg (see flash_fwd.cu)
  static constexpr uint32_t row = Rows<D>::bytes;
  static constexpr uint32_t KV_TILE = KROWS * row, Q_TILE = QROWS * row;
  static constexpr uint32_t k = 0, v = KV_TILE, q = 2 * KV_TILE,
                            dout = q + STAGES * Q_TILE,
                            stats = dout + STAGES * Q_TILE,
                            bars = stats + STAGES * 2 * QROWS * 4;
  static constexpr size_t bytes = bars + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int BKV, int H, int KVH, int Sq, int Sk,
                           int q_offset, int k_offset, int causal,
                           int window, float scale) {
  using L = Layout<D>;
  constexpr uint32_t KV_TILE = L::KV_TILE, Q_TILE = L::Q_TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Ks = sm + L::k;
  uint8_t* Vs = sm + L::v;
  uint8_t* Qs = sm + L::q;
  uint8_t* dOs = sm + L::dout;
  float* stats = reinterpret_cast<float*>(sm + L::stats);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + STAGES;

  // CTAs of the first k tiles (seen by the most q tiles under causal
  // masking) get the lowest block ids
  const int k0 = (int)blockIdx.x / BKV * KROWS;
  const int bkv = blockIdx.x % BKV;
  const int grp = H / KVH;
  // the group's query heads: rows b*H + kh*grp + g
  const int qrow0 = (bkv / KVH) * H + (bkv % KVH) * grp;
  const int k_last = min(k0 + KROWS, Sk) - 1;
  const int nq = (Sq + QROWS - 1) / QROWS;

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane (lse and delta)
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: K and V once; then, for each query head of the
    // group and each live q tile, Q and dO by TMA and lse*log2(e) and
    // delta by the warp's lanes (rows past Sq read 0: they are masked)
    if (lane == 0) {
      mbar_expect_tx(kvfull, 2 * KV_TILE);
      tma_load_3d(Ks, &tk, kvfull, 0, k0, bkv);
      tma_load_3d(Vs, &tv, kvfull, 0, k0, bkv);
    }
    int s = 0;
    uint32_t phase = 0;
    for (int g = 0; g < grp; ++g) {
      const int bh = qrow0 + g;
      for (int qi = 0; qi < nq; ++qi) {
        const int q0 = qi * QROWS;
        if (!rows_meet(q0, min(q0 + QROWS, Sq) - 1, k0, k_last, q_offset,
                       k_offset, causal, window))
          continue;
        mbar_wait(&empty[s], phase ^ 1);
        float* st = stats + s * 2 * QROWS;
        for (int i = lane; i < QROWS; i += 32) {
          const bool in = q0 + i < Sq;
          const size_t row = (size_t)bh * Sq + q0 + i;
          st[i] = in ? lse[row] * kLog2e : 0.f;
          st[QROWS + i] = in ? delta[row] : 0.f;
        }
        if (lane == 0) {
          // arrives (after this lane's lse/delta stores) and expects the
          // two tiles' bytes
          mbar_expect_tx(&full[s], 2 * Q_TILE);
          tma_load_3d(Qs + s * Q_TILE, &tq, &full[s], 0, q0, bh);
          tma_load_3d(dOs + s * Q_TILE, &tdo, &full[s], 0, q0, bh);
        } else {
          mbar_arrive(&full[s]);
        }
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns key rows wk0 .. wk0 + 63
    const int wg = warp / 4;
    const int wk0 = k0 + 64 * wg;
    const int krow = wk0 + 16 * (warp % 4) + lane / 4;  // and krow + 8
    uint8_t* Kw = Ks + wg * 64 * L::row;
    uint8_t* Vw = Vs + wg * 64 * L::row;
    const uint64_t kdesc = desc_sw<D>(Kw), vdesc = desc_sw<D>(Vw);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kvfull, 0);
    int s = 0;
    uint32_t phase = 0;
    for (int g = 0; g < grp; ++g) {
      for (int qi = 0; qi < nq; ++qi) {
        const int q0 = qi * QROWS;
        if (!rows_meet(q0, min(q0 + QROWS, Sq) - 1, k0, k_last, q_offset,
                       k_offset, causal, window))
          continue;
        mbar_wait(&full[s], phase);
        const uint64_t qdesc = desc_sw<D>(Qs + s * Q_TILE);
        const uint64_t dodesc = desc_sw<D>(dOs + s * Q_TILE);
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, D/16
        // k16 steps over the head dim
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, kdesc + 2 * kk, qdesc + 2 * kk, kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dpt, vdesc + 2 * kk, dodesc + 2 * kk, kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(st);
        fence_operands(dpt);

        // P = exp2(S*scale*log2(e) - lse*log2(e)) and dS = P (dP - delta)
        // scale on the accumulator layout, packed to bf16 (the TPU
        // kernels' casts) into the A fragments of the next two products
        // one k step at a time, so S^T and dP^T die as the fragments
        // fill. Column c is query q0 + c; this thread's columns come in
        // pairs (c, c + 1), whose lse and delta it reads as float2.
        const float2* lse2 =
            reinterpret_cast<const float2*>(stats + s * 2 * QROWS);
        const float2* dl = lse2 + QROWS / 2;
        const bool masked =
            q0 + QROWS > Sq || wk0 + 64 > Sk ||
            !rows_all_valid(q0, q0 + QROWS - 1, wk0, wk0 + 63, q_offset,
                            k_offset, causal, window);
        const float scale_log2 = scale * kLog2e;
        uint32_t pa[4][4], dsa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int c = 16 * kk + 8 * jj + 2 * (lane % 4);
            const float2 ls = lse2[c / 2], de = dl[c / 2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int i = 8 * kk + 4 * jj + 2 * hh;  // columns c, c + 1
              float p0 = exp2_ftz(fmaf(st[i], scale_log2, -ls.x));
              float p1 = exp2_ftz(fmaf(st[i + 1], scale_log2, -ls.y));
              if (masked) {
                // a masked pair never weighs in (a fully masked query
                // row's lse is ~-1e30: its exponential is dropped here)
                const int kl = krow + 8 * hh;
                p0 = pair_valid(q0 + c, kl, Sq, Sk, q_offset, k_offset,
                                causal, window) ? p0 : 0.f;
                p1 = pair_valid(q0 + c + 1, kl, Sq, Sk, q_offset, k_offset,
                                causal, window) ? p1 : 0.f;
              }
              pa[kk][2 * jj + hh] = pack_bf16(p0, p1);
              dsa[kk][2 * jj + hh] =
                  pack_bf16(p0 * (dpt[i] - de.x) * scale,
                            p1 * (dpt[i + 1] - de.y) * scale);
            }
          }

        // dV += P^T dO and dK += dS^T Q, the A operands from registers,
        // dO and Q MN-major from the ring
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_tb<D>(dv_acc, pa[kk], dodesc + L::row * kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_tb<D>(dk_acc, dsa[kk], qdesc + L::row * kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dk_acc);
        fence_operands(dv_acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    // dK and dV through this warpgroup's K and V rows to 16-byte stores
    acc_to_tile<D>(dk_acc, 1.f, 1.f, Kw);
    acc_to_tile<D>(dv_acc, 1.f, 1.f, Vw);
    wg_barrier(1 + wg);
    const size_t base = ((size_t)bkv * Sk + wk0) * D;
    tile_to_rows<D>(Kw, dk + base, Sk - wk0);
    tile_to_rows<D>(Vw, dv + base, Sk - wk0);
  }
}

template <int D>
cudaError_t launch(const Args& a) {
  // with Sq == 0 no Q/dO tile is loaded; the maps still need an extent
  const void* qp = a.Sq > 0 ? a.q : a.k;
  const void* gp = a.Sq > 0 ? a.dout : a.k;
  const int qrows = a.Sq > 0 ? a.Sq : a.Sk;
  const int qslabs = a.Sq > 0 ? a.B * a.H : a.B * a.KVH;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_rows_map<D>(&tq, qp, qrows, qslabs, QROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tdo, gp, qrows, qslabs, QROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tk, a.k, a.Sk, a.B * a.KVH, KROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tv, a.v, a.Sk, a.B * a.KVH, KROWS);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Layout<D>::bytes;
  err = allow_smem(flash_dkv_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.Sk + KROWS - 1) / KROWS * (a.B * a.KVH);
  flash_dkv_wgmma_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.B * a.KVH, a.H, a.KVH, a.Sq, a.Sk,
      a.q_offset, a.k_offset, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

}  // namespace dkv

// ----------------------------------------- dQ bf16: wgmma over TMA tiles
namespace dq {

constexpr int QROWS = 128;          // query rows per CTA: 2 warpgroups x 64
constexpr int KROWS = 64;           // key rows per ring stage
constexpr int STAGES = 6;           // K/V tiles in flight
constexpr int THREADS = 2 * 128 + 32;  // 2 consumer warpgroups + producer

template <int D>
struct Layout {
  // Q, dO (16 KB each at D 64), the K ring, the V ring (8 KB tiles at D
  // 64), then the barriers: qfull, full[STAGES], empty[STAGES]; +1024
  // for alignment. 129 KB at D 64, 65 KB at D 32, 33 KB at D 16
  static constexpr uint32_t row = Rows<D>::bytes;
  static constexpr uint32_t Q_TILE = QROWS * row, KV_TILE = KROWS * row;
  static constexpr uint32_t q = 0, dout = Q_TILE, k = 2 * Q_TILE,
                            v = k + STAGES * KV_TILE,
                            bars = v + STAGES * KV_TILE;
  static constexpr size_t bytes = bars + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int BH, int H, int KVH,
                          int Sq, int Sk, int q_offset, int k_offset,
                          int causal, int window, float scale) {
  using L = Layout<D>;
  constexpr uint32_t Q_TILE = L::Q_TILE, KV_TILE = L::KV_TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qs = sm + L::q;
  uint8_t* dOs = sm + L::dout;
  uint8_t* Ks = sm + L::k;
  uint8_t* Vs = sm + L::v;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + STAGES;

  // heaviest first: the CTAs of the last q tiles (the most live K/V
  // tiles under causal masking) get the lowest block ids
  const int nqt = (Sq + QROWS - 1) / QROWS;
  const int q0 = (nqt - 1 - (int)blockIdx.x / BH) * QROWS;
  const int bh = blockIdx.x % BH;
  const int h = bh % H;
  // GQA: query row bh = b*H + h reads kv row b*KVH + h / (H / KVH)
  const int kv_row = (bh / H) * KVH + h / (H / KVH);
  const int q_last = min(q0 + QROWS, Sq) - 1;
  const int nk = (Sk + KROWS - 1) / KROWS;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: Q and dO once, then the live K/V tiles through the
    // ring (rows past each head's length arrive as zeros)
    if (lane == 0) {
      mbar_expect_tx(qfull, 2 * Q_TILE);
      tma_load_3d(Qs, &tq, qfull, 0, q0, bh);
      tma_load_3d(dOs, &tdo, qfull, 0, q0, bh);
      int s = 0;
      uint32_t phase = 0;
      for (int kj = 0; kj < nk; ++kj) {
        const int k0 = kj * KROWS;
        if (!rows_meet(q0, q_last, k0, min(k0 + KROWS, Sk) - 1, q_offset,
                       k_offset, causal, window))
          continue;
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], 2 * KV_TILE);
        tma_load_3d(Ks + s * KV_TILE, &tk, &full[s], 0, k0, kv_row);
        tma_load_3d(Vs + s * KV_TILE, &tv, &full[s], 0, k0, kv_row);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wq0 .. wq0 + 63
    const int wg = warp / 4;
    const int wq0 = q0 + 64 * wg;
    const int wq_last = min(wq0 + 63, Sq - 1);
    const int qrow = wq0 + 16 * (warp % 4) + lane / 4;  // and qrow + 8
    uint8_t* Qw = Qs + wg * 64 * L::row;
    const uint64_t qdesc = desc_sw<D>(Qw);
    const uint64_t dodesc = desc_sw<D>(dOs + wg * 64 * L::row);
    // this thread's two rows' lse * log2(e) and delta (0 past Sq: those
    // rows are masked)
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      const bool in = row < Sq;
      lse2[r] = in ? lse[(size_t)bh * Sq + row] * kLog2e : 0.f;
      dl[r] = in ? delta[(size_t)bh * Sq + row] : 0.f;
    }
    const float scale_log2 = scale * kLog2e;
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    mbar_wait(qfull, 0);
    int s = 0;
    uint32_t phase = 0;
    for (int kj = 0; kj < nk; ++kj) {
      const int k0 = kj * KROWS;
      const int k_last = min(k0 + KROWS, Sk) - 1;
      if (!rows_meet(q0, q_last, k0, k_last, q_offset, k_offset, causal,
                     window))
        continue;
      mbar_wait(&full[s], phase);
      if (wq0 < Sq && rows_meet(wq0, wq_last, k0, k_last, q_offset,
                                k_offset, causal, window)) {
        const uint64_t kdesc = desc_sw<D>(Ks + s * KV_TILE);
        const uint64_t vdesc = desc_sw<D>(Vs + s * KV_TILE);
        // S = Q K^T and dP = dO V^T (64 queries x 64 keys each, D/16 k16
        // steps) as two groups, so P is formed while dP is still in
        // flight
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, qdesc + 2 * kk, kdesc + 2 * kk, kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dpt, dodesc + 2 * kk, vdesc + 2 * kk, kk);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operands(st);

        // P = exp2(S*scale*log2(e) - lse*log2(e)) in place of S, on the
        // accumulator layout: element i is row qrow + 8*((i/2)%2), key
        // k0 + 8*(i/4) + 2*(lane%4) + i%2. A masked pair never weighs in
        // (a fully masked row's lse is ~-1e30: its exponential is
        // dropped here).
        const bool masked =
            wq0 + 64 > Sq || k0 + KROWS > Sk ||
            !rows_all_valid(wq0, wq0 + 63, k0, k0 + KROWS - 1, q_offset,
                            k_offset, causal, window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i / 2) % 2;
          float p = exp2_ftz(fmaf(st[i], scale_log2, -lse2[r]));
          if (masked) {
            const int kl = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
            p = pair_valid(qrow + 8 * r, kl, Sq, Sk, q_offset, k_offset,
                           causal, window) ? p : 0.f;
          }
          st[i] = p;
        }
        wgmma_wait<0>();
        fence_operands(dpt);

        // dS = P (dP - delta) scale, packed to bf16 (the TPU kernel's
        // ds.astype(k.dtype)) into the A fragments of dQ += dS K
        uint32_t dsa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 8 * kk + 2 * j;
            const float d = dl[j % 2];
            dsa[kk][j] = pack_bf16(st[i] * (dpt[i] - d) * scale,
                                   st[i + 1] * (dpt[i + 1] - d) * scale);
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_tb<D>(dq_acc, dsa[kk], kdesc + L::row * kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dq_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    // dQ through this warpgroup's Q rows (read by nothing after its last
    // product) to 16-byte stores
    acc_to_tile<D>(dq_acc, 1.f, 1.f, Qw);
    wg_barrier(1 + wg);
    tile_to_rows<D>(Qw, dq + ((size_t)bh * Sq + wq0) * D, Sq - wq0);
  }
}

template <int D>
cudaError_t launch(const Args& a) {
  // with Sk == 0 no K/V tile is loaded; the maps still need an extent
  const void* kp = a.Sk > 0 ? a.k : a.q;
  const void* vp = a.Sk > 0 ? a.v : a.q;
  const int krows = a.Sk > 0 ? a.Sk : a.Sq;
  const int kslabs = a.Sk > 0 ? a.B * a.KVH : a.B * a.H;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_rows_map<D>(&tq, a.q, a.Sq, a.B * a.H, QROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tdo, a.dout, a.Sq, a.B * a.H, QROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tk, kp, krows, kslabs, KROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tv, vp, krows, kslabs, KROWS);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Layout<D>::bytes;
  err = allow_smem(flash_dq_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.H;
  const int grid = (a.Sq + QROWS - 1) / QROWS * BH;
  flash_dq_wgmma_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), BH, a.H,
      a.KVH, a.Sq, a.Sk, a.q_offset, a.k_offset, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

}  // namespace dq

template <int D>
cudaError_t launch_dq(const Args& a, bool bf16_body) {
  if (bf16_body) return dq::launch<D>(a);
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  constexpr size_t smem = F32Layout<D>::bytes;
  auto kernel = flash_dq_f32_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.H, a.KVH, a.Sq, a.Sk,
      a.q_offset, a.k_offset, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, bool bf16_body) {
  if (bf16_body) return dkv::launch<D>(a);
  const dim3 grid((a.Sk + BK - 1) / BK, a.B * a.KVH);
  constexpr size_t smem = F32Layout<D>::bytes;
  auto kernel = flash_dkv_f32_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.H, a.KVH, a.Sq, a.Sk, a.q_offset, a.k_offset, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int B, int H, int KVH, int Sq, int Sk, int q_offset,
               int k_offset, int causal, int window, float scale,
               void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dq, dk, dv, B, H, KVH, Sq,
              Sk, q_offset, k_offset, causal, window, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q, dout (B, H, Sq, D); k, v (B, KVH, Sk, D); lse, delta (B, H, Sq) f32;
// dq like q; dk, dv like k. All contiguous, q/k/v/dout and the outputs
// of one type (is_bf16 ? bf16 : f32; bf16 pointers 16-byte aligned).
// window <= 0 means no sliding window. head_dim D is 16, 32 or 64; any
// other returns cudaErrorInvalidValue. Each returns cudaGetLastError()
// after its launch.
extern "C" int etpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int KVH, int Sq, int Sk, int D,
                                 int q_offset, int k_offset, int causal,
                                 int window, float scale, int is_bf16,
                                 void* stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                           B, H, KVH, Sq, Sk, q_offset, k_offset, causal,
                           window, scale, stream);
  return etpu::with_head_dim(D, [&](auto d) {
    return launch_dq<decltype(d)::value>(a, is_bf16 != 0);
  });
}

extern "C" int etpu_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int H, int KVH,
                                  int Sq, int Sk, int D, int q_offset,
                                  int k_offset, int causal, int window,
                                  float scale, int is_bf16, void* stream) {
  if (B * KVH == 0 || Sk == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H,
                           KVH, Sq, Sk, q_offset, k_offset, causal, window,
                           scale, stream);
  return etpu::with_head_dim(D, [&](auto d) {
    return launch_dkv<decltype(d)::value>(a, is_bf16 != 0);
  });
}
