// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in
// elephas_tpu/ops/pallas_attention.py (launched by `_fwd`): the
// flash-attention-2 forward with f32 online softmax, causal and
// sliding-window masks with whole-tile skipping, ragged lengths, GQA
// through the kv-row map, and global q/k offsets for ring hops. It
// returns O and the per-row logsumexp (natural log); a fully masked row
// gets O = 0 and LSE ~ -1e30, so a cross-hop merge weights it to zero.
//
// Design. The TPU's sequential kv grid axis becomes a loop inside the
// CTA over K/V tiles; tiles wholly above the causal diagonal or below
// the window are skipped before any load. Ragged edges are masked in
// the kernel, never padded in device memory. Both bodies are
// instantiated at head_dim 16, 32, 64 and 128 (hopper.cuh
// `with_head_dim`): 16, 32 and 64 are the head dims of the repo's
// configurations, 128 that of most published LMs (Llama-2-7B,
// Mistral-7B, Llama-3-8B). Two bodies:
//
// - bf16 (the working type): one CTA per (batch*head,
//   128-row q tile), CTAs of the last q tiles (the most live tiles under
//   causal masking) scheduled first. One producer warp issues TMA loads:
//   Q once, then the live 128-row K and V tiles into a 4-stage ring of
//   shared memory guarded by full/empty mbarriers; TMA zero-fills rows
//   past each head's length. A tile row is the head's 2*D bytes in the
//   swizzle of that width (128, 64 or 32 bytes; at D 128 two 64-column
//   blocks of 128 bytes, hopper.cuh `Rows`), so a smaller head dim
//   shrinks the tiles and the products and nothing else. At D 128 the
//   K/V tiles are 64 rows: four stages of 128-row tiles beside Q would
//   take 288 KB of the 227 KB a CTA may use, and a 64 x 64 score tile
//   keeps the consumer's registers (O's 64 f32, S's 32, P's 16) far
//   from a spill in the 9-warp CTA. Two consumer warpgroups of 64 query
//   rows compute S = Q K^T with wgmma m64n128k16 (m64n64k16 at D 128;
//   D/16 k steps) from shared memory, run the
//   online softmax on the wgmma accumulator in registers (each row on
//   the 4 threads of a quad; one FMA and exp2 per score; the
//   per-element mask only on tiles that hold a masked pair), pack P to
//   bf16 in registers (the TPU kernel's `p.astype(v.dtype)`) and feed
//   it as the register A operand of O += P V (m64nDk16, V MN-major; at
//   D 128 one m64n64k16 per column block). O stays in registers across
//   the loop, and leaves through a swizzled shared tile in 16-byte
//   stores.
// - f32: 256 threads on the CUDA cores, each holding a 4x4 block of the
//   64x64 score tile and a 4x(D/16) block of O in registers; row max and
//   sum reduce over the 16 lanes sharing a row with warp shuffles.
//
// What bounds it on the H100. A (q, k) pair costs 4*D flops and each
// operand row is read once per tile, so at head_dim 64 and 128 the loop
// is bound by operations (989 TFLOP/s in bf16). At 32 and 16 the products
// shrink with D while the softmax's FMA and exp2 per score do not, so
// the CUDA cores and MUFU take a larger share of each tile. Within one
// consumer warpgroup the two products and the softmax run in sequence;
// the second warpgroup and the ring's prefetch are what overlap them.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace etpu;

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each 4 rows x 4 columns

template <int D>
constexpr size_t flash_smem_bytes() {
  // Qs[BQ][D+1], Ks[BK][D+1], Vs[BK][D], Ps[BQ][BK+1]; the +1 pads keep
  // the lanes of a warp on distinct banks in the inner products
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// The launch bounds ask for one resident CTA per SM, no more: under
// the default ptxas held the D 32 instance to 64 registers and spilled.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int KVH, int Sq, int Sk,
                     int q_offset, int k_offset, int causal, int window,
                     float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int RC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (D + 1);
  float* Vs = Ks + BK * (D + 1);
  float* Ps = Vs + BK * D;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int h = bh % H;
  // GQA: query row bh = b*H + h reads kv row b*KVH + h / (H / KVH)
  const int kv_row = (bh / H) * KVH + h / (H / KVH);
  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + (size_t)kv_row * Sk * D;
  const T* vp = v + (size_t)kv_row * Sk * D;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // columns tx + 16*j

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * (D + 1) + c] =
        q0 + r < Sq ? to_f32(qp[(size_t)(q0 + r) * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = etpu::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    // whole-tile skip on global positions (the same predicate as the
    // TPU kernel's `diag_reached`); uniform over the CTA
    bool live = !causal || (k_offset + k0 <= q_offset + q0 + BQ - 1);
    if (window > 0) live = live && (k_offset + k0 + BK - 1 > q_offset + q0 - window);
    if (!live) continue;

    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      Ks[r * (D + 1) + c] = in ? to_f32(kp[(size_t)(k0 + r) * D + c]) : 0.f;
      Vs[i] = in ? to_f32(vp[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qg = q_offset + q0 + ty * 4 + i;  // global query position
      bool valid[4];
      float mx = etpu::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = k0 + tx + 16 * j;  // local key row
        const int kg = k_offset + kl;
        valid[j] = kl < Sk;
        if (causal) valid[j] = valid[j] && kg <= qg;
        if (window > 0) valid[j] = valid[j] && kg > qg - window;
        s[i][j] = valid[j] ? s[i][j] * scale : etpu::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = etpu::round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * Sq + r) * D;
#pragma unroll
    for (int j = 0; j < RC; ++j)
      orow[tx + 16 * j] = etpu::from_f32<T>(acc[i][j] / denom);
    if (tx == 0) lse[(size_t)bh * Sq + r] = m[i] + logf(denom);
  }
}

// ------------------------------------------ bf16: wgmma over TMA tiles
using bf16 = __nv_bfloat16;

constexpr int WQ = 128;             // query rows per CTA: 2 warpgroups x 64
constexpr int STAGES = 4;           // K/V tiles in flight
constexpr int WTHREADS = 2 * 128 + 32;  // 2 consumer warpgroups + producer

template <int D>
struct WgmmaLayout {
  // key rows per K/V tile: 128, or 64 at D 128 (see the note at the top)
  static constexpr int WK = D == 128 ? 64 : 128;
  // Q, the K ring, the V ring, then the barriers: qfull, kfull[STAGES],
  // vfull[STAGES], empty[STAGES]; +1024 for alignment. 160 KB at D 128
  // (32 KB of Q, 16 KB tiles), 144 KB at D 64 (16 KB tiles), 73 KB at D
  // 32, 37 KB at D 16: the stage count stays, since the ring's depth
  // hides a load's latency, not its size. No setmaxnreg: it only moves
  // registers within the CTA's launch allocation, which one producer
  // warp barely feeds ((R - 40) x 32 for 256 consumer threads), and a
  // consumer asking for more than is free waits for good (a hang on the
  // card). ptxas fits the consumers in the launch allocation without
  // spills.
  static constexpr uint32_t row = Rows<D>::bytes;   // bytes of a whole row
  static constexpr uint32_t atom = Rows<D>::atom;   // ... in one block
  static constexpr uint32_t tile = WK * row;  // one K or V tile
  static constexpr uint32_t q = 0, k = WQ * row, v = k + STAGES * tile,
                            bars = v + STAGES * tile;
  static constexpr size_t bytes = bars + (1 + 3 * STAGES) * 8 + 1024;
};

// The 64 x (2N) score tile of one warpgroup's rows against one K tile
// (N accumulator registers a thread) is masked per element only where it
// can hold a masked pair: keys past Sk, the causal diagonal, the
// window's lower edge.
template <int N>
__device__ __forceinline__ void mask_scores(float (&s)[N], int qrow, int k0,
                                            int Sq, int Sk, int q_offset,
                                            int k_offset, int causal,
                                            int window) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int kl = k0 + 8 * (i / 4) + 2 * (l % 4) + i % 2;
    if (!pair_valid(qrow + 8 * ((i / 2) % 2), kl, Sq, Sk, q_offset,
                    k_offset, causal, window))
      s[i] = -INFINITY;
  }
}

template <int D>
__global__ void __launch_bounds__(WTHREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int BH, int H, int KVH, int Sq, int Sk,
                           int q_offset, int k_offset, int causal,
                           int window, float scale_log2) {
  using L = WgmmaLayout<D>;
  constexpr uint32_t TILE = L::tile;
  constexpr int WK = L::WK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qs = sm + L::q;
  uint8_t* Ks = sm + L::k;
  uint8_t* Vs = sm + L::v;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  // heaviest first: the CTAs of the last q tiles (the most live K/V
  // tiles under causal masking) get the lowest block ids
  const int nqt = (Sq + WQ - 1) / WQ;
  const int q0 = (nqt - 1 - (int)blockIdx.x / BH) * WQ;
  const int bh = blockIdx.x % BH;
  const int h = bh % H;
  // GQA: query row bh = b*H + h reads kv row b*KVH + h / (H / KVH)
  const int kv_row = (bh / H) * KVH + h / (H / KVH);
  const int q_last = min(q0 + WQ, Sq) - 1;
  const int nk = (Sk + WK - 1) / WK;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: Q once, then the live K/V tiles through the ring
    if (lane == 0) {
      mbar_expect_tx(qfull, WQ * L::row);
      tma_load_tile<D, WQ>(Qs, &tq, qfull, q0, bh);
      int s = 0;
      uint32_t phase = 0;
      for (int kj = 0; kj < nk; ++kj) {
        const int k0 = kj * WK;
        if (!rows_meet(q0, q_last, k0, min(k0 + WK, Sk) - 1, q_offset,
                       k_offset, causal, window))
          continue;
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&kfull[s], TILE);
        tma_load_tile<D, WK>(Ks + s * TILE, &tk, &kfull[s], k0, kv_row);
        mbar_expect_tx(&vfull[s], TILE);
        tma_load_tile<D, WK>(Vs + s * TILE, &tv, &vfull[s], k0, kv_row);
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
    const int qrow = wq0 + 16 * (warp % 4) + lane / 4;  // and qrow + 8
    uint8_t* Qw = Qs + wg * 64 * L::atom;  // its rows in block 0
    const uint64_t qdesc = desc_sw<D>(Qw);
    float oacc[D / 2], m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;

    mbar_wait(qfull, 0);
    int s = 0;
    uint32_t phase = 0;
    for (int kj = 0; kj < nk; ++kj) {
      const int k0 = kj * WK;
      const int k_last = min(k0 + WK, Sk) - 1;
      if (!rows_meet(q0, q_last, k0, k_last, q_offset, k_offset, causal,
                     window))
        continue;
      // S = Q K^T: 64 rows x WK keys, D/16 k16 steps over the head dim
      float sacc[WK / 2];
      mbar_wait(&kfull[s], phase);
      const uint64_t kdesc = desc_sw<D>(Ks + s * TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<WK>(sacc, desc_k<D, WQ>(qdesc, kk),
                     desc_k<D, WK>(kdesc, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sacc);

      if (k0 + WK > Sk ||
          !rows_all_valid(wq0, wq0 + 63, k0, k0 + WK - 1, q_offset,
                          k_offset, causal, window))
        mask_scores(sacc, qrow, k0, Sq, Sk, q_offset, k_offset, causal,
                    window);

      // online softmax in the base-2 domain on the accumulator layout:
      // this thread's 2 rows x WK/4 columns; a row spans the 4 threads of
      // a quad, so max reduces with shuffles over lanes ^1 and ^2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < WK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sacc[i]);
      float mu[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        // a row with nothing unmasked yet subtracts 0: exp2(-inf) = 0
        mu[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = exp2_ftz(m[r] - mu[r]);
        m[r] = m_new;
        lsum[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < WK / 2; ++i) {
        const int r = (i / 2) % 2;
        sacc[i] = exp2_ftz(fmaf(sacc[i], scale_log2, -mu[r]));
        lsum[r] += sacc[i];  // f32; the quad's partial sums meet at the end
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] *= corr[(i / 2) % 2];

      // O += P V with P in bf16 registers (the TPU kernel's
      // p.astype(v.dtype)) and V MN-major from the ring
      uint32_t pa[WK / 16][4];
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) pack_a(sacc, kk, pa[kk]);
      mbar_wait(&vfull[s], phase);
      const uint64_t vdesc = desc_sw<D>(Vs + s * TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)
        wgmma_rs_rows<D, WK>(oacc, pa[kk], vdesc, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(oacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
      inv[r] = 1.f / fmaxf(lsum[r], 1e-30f);
    }
    // O through this warpgroup's Q rows (read by nothing after its last
    // product) to 16-byte stores; LSE in natural-log units, kNegInf for a
    // row with nothing unmasked (O = 0 there)
    acc_to_tile<D, WQ>(oacc, inv[0], inv[1], Qw);
    wg_barrier(1 + wg);
    tile_to_rows<D, WQ>(Qw, o + ((size_t)bh * Sq + wq0) * D, Sq - wq0);
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qrow + 8 * r;
        if (row < Sq)
          lse[(size_t)bh * Sq + row] =
              m[r] == -INFINITY
                  ? kNegInf
                  : m[r] * kLn2 + logf(fmaxf(lsum[r], 1e-30f));
      }
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int H, int KVH, int Sq,
                         int Sk, int q_offset, int k_offset, int causal,
                         int window, float scale, cudaStream_t stream) {
  // with Sk == 0 no K/V tile is loaded; the maps still need an extent
  const void* kp = Sk > 0 ? k : q;
  const void* vp = Sk > 0 ? v : q;
  const int krows = Sk > 0 ? Sk : Sq, kslabs = Sk > 0 ? B * KVH : B * H;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_rows_map<D>(&tq, q, Sq, B * H, WQ);
  constexpr int WK = WgmmaLayout<D>::WK;
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tk, kp, krows, kslabs, WK);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tv, vp, krows, kslabs, WK);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = WgmmaLayout<D>::bytes;
  err = allow_smem(flash_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (Sq + WQ - 1) / WQ * (B * H);
  flash_fwd_wgmma_kernel<D><<<grid, WTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, B * H, H, KVH, Sq, Sk,
      q_offset, k_offset, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KVH, int Sq, int Sk,
                   int q_offset, int k_offset, int causal, int window,
                   float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_wgmma<D>(q, k, v, o, lse, B, H, KVH, Sq, Sk, q_offset,
                           k_offset, causal, window, scale, stream);
  } else {
    const dim3 grid((Sq + BQ - 1) / BQ, B * H);
    constexpr size_t smem = flash_smem_bytes<D>();
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = etpu::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, H, KVH, Sq, Sk,
        q_offset, k_offset, causal, window, scale);
    return cudaGetLastError();
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, KVH, Sk, D), o (B, H, Sq, D), all contiguous
// and of one type (is_bf16 ? bf16 : f32; bf16 q/k/v 16-byte aligned);
// lse (B, H, Sq) f32. window <= 0 means no sliding window. Returns
// cudaGetLastError() after the launch.
extern "C" int etpu_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int KVH,
                              int Sq, int Sk, int D, int q_offset,
                              int k_offset, int causal, int window,
                              float scale, int is_bf16, void* stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  return etpu::with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return is_bf16 ? launch<bf16, kD>(q, k, v, o, l, B, H, KVH, Sq, Sk,
                                      q_offset, k_offset, causal, window,
                                      scale, s)
                   : launch<float, kD>(q, k, v, o, l, B, H, KVH, Sq, Sk,
                                       q_offset, k_offset, causal, window,
                                       scale, s);
  });
}

extern "C" const char* etpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
