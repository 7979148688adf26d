// The f32 flash backward for Hopper (sm_90a): dQ and dK/dV in f32 at
// every head dim, on the tensor cores as 3xTF32 `mma.sync.m16n8k8`.
//
// Replaces, in f32, the TPU kernels `_dq_kernel` and `_dkv_kernel`
// (elephas_tpu/ops/pallas_attention.py:196 and :243); flash_bwd.cu's
// notes give what they compute, its C interface calls these bodies for
// f32 operands. The products' precision is f32_narrow.cuh's: each
// operand split into a TF32 hi and lo, three products a term, about
// 2^-20 relative, where one TF32 pass (2^-11) misses the 1e-4 tolerance.
//
// Bodies.
// - Widths 16 and 32 (head dims 8-32): strips, f32_narrow.cuh's design.
//   A warp owns 16 query rows of one head (dQ,
//   `flash_dq_f32_narrow_kernel`) or 16 key rows of one kv head (dK/dV,
//   `flash_dkv_f32_narrow_kernel`), holds their operands split in
//   registers, and walks only its live rows of the other operand in
//   steps of 8 through its own ring of cp.async stages.
// - Widths 64, 128 and 256 (head dims 40-256): `flash_dq_f32_wide_kernel`
//   and `flash_dkv_f32_wide_kernel`. Held in registers, a strip's two
//   split operands would take 2W registers a lane (512 at 256), and a
//   ring a warp would read each tile once a strip. So:
//   - A CTA holds NS strips of 16 rows in shared memory (its resident
//     rows, `Wide::RES`: 64; at width 256 32 in dK/dV and 16 in dQ) and
//     streams the other operand's tiles (64 rows, 32 at 256) through one
//     ring of two cp.async stages that all its warps read: a tile leaves
//     L2 once a CTA. Rows have a stride of W + 4 floats, so the A reads (rows g and
//     g + 8 at columns t and t + 4) and both B reads (rows g at column t;
//     rows 2t and 2t + 1 at column g) fall on 32 distinct banks.
//   - A warp owns 64 columns of a strip (`CW`), so a strip has CS = W / 64
//     warps (1, 2, 4) and at every width a warp holds the same: its
//     accumulators, 32 registers a lane (dQ) or 64 (dK and dV), and the
//     resident rows' A fragments at its columns, split once (`Strip<64>`
//     of Q and dO, or of K and V: 128). ptxas fits them in 225-233
//     registers (dQ) and 254 (dK/dV) without a spill. (Read from shared
//     memory and split each step instead, they left 133-173 registers and
//     ran 10% slower.)
//   - S = Q K^T and dP = dO V^T (S^T and dP^T in dK/dV) run over the
//     whole head dim: each warp of a strip takes its 64 columns, and the
//     strip's warps add their partials through shared memory
//     (`exchange`: 8 floats a lane stored, the strip's named barrier, CS
//     slots read and added in one order, so every warp holds the same
//     bits). Each then forms P and dS on the C fragments and adds its
//     columns of dQ += dS K (dV += P^T dO, dK += dS^T Q), P and dS fed on
//     as A fragments in place (f32_narrow.cuh).
//   - dQ: one CTA a (query head, q tile), the last q tiles (the heaviest
//     under causal masking) first. The CTA walks the keys from the run of
//     its first row to that of its last; a strip skips the steps of 8
//     keys its rows do not meet.
//   - dK/dV: one CTA a chunk of a plan (ops/flash_attention.py
//     `dkv_plan`, the width-256 bf16 body's): a k tile's walk over
//     (query head of the GQA group, live q tile) cut into chunks of about
//     equal length sized to fill the SMs, so a multi-query group's walk
//     spreads over CTAs (Gemma-2B's one kv head at S 512: 16 k tiles of 32
//     rows, 128 chunks). A chunk that is its k tile's only one stores dK
//     and dV; the chunks of a split tile store f32 partials, which
//     flash_bwd.cu's `flash_dkv_reduce_kernel` sums in chunk order. No
//     atomics, so two runs give the same bits.
//
// What bounds them on the H100: at the f32 gradients' shapes (B 1-2, S
// 512-1024) the operations take 0.01-0.06 ms at the TF32 rate of wgmma
// counted three times, and mma.sync's TF32 rate is 61% of that (304
// TFLOP/s on this card: tests/torch_mma_rate.py). The bodies reach about
// 40% of mma.sync's rate: a step is a chain (B fragments loaded and
// split, the products, the exchange, the elementwise step, the gradient
// products) of about 2,500 SM cycles on the heaviest strips, which 4-8
// warps an SM do not cover (the registers above, and 174-215 KB of
// shared memory at widths 128 and 256, hold one CTA an SM; two at 64).
// Removing the S and dP products or the gradient products each saves
// about a third of a step; the loads alone take a quarter of the time
// (tests/torch_flash_f32_variants.py; PERF.md).
#include "flash_bwd_f32.cuh"

#include "common.cuh"
#include "f32_narrow.cuh"
#include "hopper.cuh"

namespace etpu::f32n {

// ------------------------------------- f32 at widths 16 and 32: strips
// The design is f32_narrow.cuh's. A warp's strip is 16 key rows of one
// kv head, K and V split once into registers; it walks the live query
// rows of each query head of the group in turn (the stages of one head,
// then the next's, through one ring), and per step of 8 query rows forms
// S^T = K Q^T and dP^T = V dO^T, then on their C fragments P^T = exp(S^T
// scale - lse) (one exp2 of an FMA) and dS^T = P^T (dP^T - delta) scale,
// zero on masked pairs, as `_dkv_kernel` does (pallas_attention.py:284-
// 290), and adds dV += P^T dO and dK += dS^T Q. dK and dV of the group's
// heads stay in the warp's registers and are stored once.
template <int W>
__global__ void __launch_bounds__(kWarps * 32)
    flash_dkv_f32_narrow_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int BKV, int grp,
                                int Sq, int Sk, int hd, int q_offset,
                                int k_offset, int causal, int window,
                                float scale) {
  Strip<W> strip;  // the warp's strip (dkv)
  using Smem = DkvSmem<W>;
  constexpr int L = LD<W>;
  extern __shared__ __align__(16) float smem_n[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // a CTA's warps take one strip of kWarps kv heads; blockIdx.y counts
  // strips from a head's first, so the heaviest are scheduled first
  const int bkv = blockIdx.x * kWarps + warp;
  if (bkv >= BKV) return;
  const int c0 = blockIdx.y * ROWS;
  // GQA: kv row bkv = b*KVH + kh serves query rows b*H + kh*grp + gi,
  // that is bkv * grp + gi (H = KVH * grp)
  const size_t qrow0 = (size_t)bkv * grp;
  float* Ks = smem_n + warp * Smem::floats;
  float* Vs = Ks + Smem::strip;
  float* ring = Vs + Smem::strip;  // stage slot: Q, dO, lse, delta

  int2 run[2];  // the lane's two key rows' runs of queries
#pragma unroll
  for (int r = 0; r < 2; ++r)
    run[r] = query_run(c0 + g + 8 * r, Sq, Sk, q_offset, k_offset, causal,
                       window);
  const Walk<> walk(
      query_run(c0, Sq, Sk, q_offset, k_offset, causal, window),
      query_run(min(c0 + ROWS, Sk) - 1, Sq, Sk, q_offset, k_offset, causal,
                window));
  // the ring's order: the stages of the group's first query head, then
  // the next's; a cursor (head, stage) for the copies and one for the
  // products, advanced without a run-time division
  const int total = grp * walk.stages;
  struct Cursor {
    int head = 0, stage = 0;
    __device__ void next(int stages) {
      if (++stage == stages) stage = 0, ++head;
    }
  } in, at;

  // one round trip: K and V with the first stage, every stage the ring
  // holds issued before the first wait
  load_rows<W>(Ks, k + (size_t)bkv * Sk * hd, c0, ROWS, Sk, hd, lane);
  load_rows<W>(Vs, v + (size_t)bkv * Sk * hd, c0, ROWS, Sk, hd, lane);
  auto issue = [&](int u) {
    if (u < total) {
      const size_t bh = qrow0 + in.head;
      float* slot = ring + (u % STAGES) * Smem::stage;
      const int r = walk.row(in.stage), n = walk.steps(in.stage) * STEP;
      load_rows<W>(slot, q + bh * Sq * hd, r, n, Sq, hd, lane);
      load_rows<W>(slot + Smem::tile, dout + bh * Sq * hd, r, n, Sq, hd,
                   lane);
      load_stats(slot + 2 * Smem::tile, lse + bh * Sq, r, n, Sq, lane);
      load_stats(slot + 2 * Smem::tile + STAGE, delta + bh * Sq, r, n, Sq,
                 lane);
      in.next(walk.stages);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < STAGES; ++u) issue(u);

  Strip<W> vstrip;
  float dka[W / 8][4], dva[W / 8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int u = 0; u < total; ++u) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    if (u == 0) {
      load_strip<W>(strip, Ks, g, t);
      load_strip<W>(vstrip, Vs, g, t);
    }
    const float* Qs = ring + (u % STAGES) * Smem::stage;
    const float* dOs = Qs + Smem::tile;
    const float* ls = Qs + 2 * Smem::tile;
    const float* des = ls + STAGE;
    const int q0 = walk.row(at.stage), steps = walk.steps(at.stage);
    at.next(walk.stages);
    // the steps a rolled loop, as in the forward
#pragma unroll 1
    for (int j = 0; j < steps; ++j) {
      float st[4], dpt[4];
      dots<W>(st, strip, Qs + j * STEP * L, g, t);
      dots<W>(dpt, vstrip, dOs + j * STEP * L, g, t);
      // the statistics of the lane's two query columns, 2t and 2t + 1
      const float2 lq =
          *reinterpret_cast<const float2*>(ls + j * STEP + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(des + j * STEP + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = q0 + j * STEP + 2 * t + (e & 1);
        const int2 rr = run[e / 2];
        const float lx = (e & 1) ? lq.y : lq.x;
        const float dx = (e & 1) ? dl.y : dl.x;
        const float p = qr < rr.x || qr > rr.y
                            ? 0.f
                            : exp2f(fmaf(st[e], scale_log2, -lx * kLog2e));
        st[e] = p;
        dpt[e] = p * (dpt[e] - dx) * scale;
      }
      accum<W>(dva, st, dOs + j * STEP * L, g, t);   // dV += P^T dO
      accum<W>(dka, dpt, Qs + j * STEP * L, g, t);   // dK += dS^T Q
    }
    __syncwarp();  // the slot's last reads are done: refill it
    issue(u + STAGES);
  }
  cp_async_wait<0>();  // no copy outlives the warp (a strip of no step)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = c0 + g + 8 * r;
    if (row >= Sk) continue;
    const size_t off = ((size_t)bkv * Sk + row) * hd + 2 * t;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      if (8 * n < hd) {
        *reinterpret_cast<float2*>(dk + off + 8 * n) =
            make_float2(dka[n][2 * r], dka[n][2 * r + 1]);
        *reinterpret_cast<float2*>(dv + off + 8 * n) =
            make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
      }
  }
}

// dQ's shared memory a warp: its strip's Q and dO rows, then STAGES x
// (K, V) tiles of STAGE key rows.
template <int W>
struct DqSmem {
  static constexpr int strip = ROWS * LD<W>;
  static constexpr int tile = STAGE * LD<W>;
  static constexpr int floats = 2 * strip + STAGES * 2 * tile;
  static constexpr size_t bytes = sizeof(float) * floats * kWarps;
};

// dQ at widths 16 and 32. A warp's strip is 16 query rows of one head, Q
// and dO split once into registers, their lse (times log2 e) and delta
// in registers; it walks its live keys, and per step of 8 keys forms S =
// Q K^T and dP = dO V^T, then on their C fragments P = exp(S scale -
// lse) and dS = P (dP - delta) scale, zero on masked pairs, as
// `_dq_kernel` does (pallas_attention.py:226-232), and adds dQ += dS K,
// dS's C fragment fed as the A fragment in place (the forward's P V).
// blockIdx.y counts strips from a head's last, the heaviest first.
template <int W>
__global__ void __launch_bounds__(kWarps * 32)
    flash_dq_f32_narrow_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dq, int BH,
                               FastDiv group, int Sq, int Sk, int hd,
                               int q_offset, int k_offset, int causal,
                               int window, float scale) {
  Strip<W> qstrip, ostrip;  // the warp's strip of Q and of dO
  using Smem = DqSmem<W>;
  constexpr int L = LD<W>;
  extern __shared__ __align__(16) float smem_n[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x * kWarps + warp;
  if (bh >= BH) return;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int kv_row = group(bh);  // b*KVH + h / group (H = KVH * group)
  const float* kp = k + (size_t)kv_row * Sk * hd;
  const float* vp = v + (size_t)kv_row * Sk * hd;
  float* Qs = smem_n + warp * Smem::floats;
  float* dOs = Qs + Smem::strip;
  float* ring = dOs + Smem::strip;  // stage slot s: K, then V

  int2 run[2];        // the lane's two rows' runs of keys
  float lse2[2], dl[2];  // their lse times log2 e, and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    run[r] = key_run(row, Sq, Sk, q_offset, k_offset, causal, window);
    const bool in = row < Sq;
    lse2[r] = in ? lse[(size_t)bh * Sq + row] * kLog2e : 0.f;
    dl[r] = in ? delta[(size_t)bh * Sq + row] : 0.f;
  }
  const Walk<> walk(
      key_run(r0, Sq, Sk, q_offset, k_offset, causal, window),
      key_run(min(r0 + ROWS, Sq) - 1, Sq, Sk, q_offset, k_offset, causal,
              window));

  // one round trip: Q and dO with the first stage, every stage the ring
  // holds issued before the first wait
  load_rows<W>(Qs, q + (size_t)bh * Sq * hd, r0, ROWS, Sq, hd, lane);
  load_rows<W>(dOs, dout + (size_t)bh * Sq * hd, r0, ROWS, Sq, hd, lane);
  auto issue = [&](int s) {
    if (s < walk.stages) {
      float* slot = ring + (s % STAGES) * 2 * Smem::tile;
      const int n = walk.steps(s) * STEP;
      load_rows<W>(slot, kp, walk.row(s), n, Sk, hd, lane);
      load_rows<W>(slot + Smem::tile, vp, walk.row(s), n, Sk, hd, lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) issue(s);

  float acc[W / 8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int s = 0; s < walk.stages; ++s) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    if (s == 0) {
      load_strip<W>(qstrip, Qs, g, t);
      load_strip<W>(ostrip, dOs, g, t);
    }
    const float* Ks = ring + (s % STAGES) * 2 * Smem::tile;
    const float* Vs = Ks + Smem::tile;
    const int k0 = walk.row(s);
#pragma unroll 1
    for (int j = 0; j < walk.steps(s); ++j) {
      float sc[4], dp[4];
      dots<W>(sc, qstrip, Ks + j * STEP * L, g, t);
      dots<W>(dp, ostrip, Vs + j * STEP * L, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * STEP + 2 * t + (e & 1);
        const int2 rr = run[e / 2];
        const float p =
            key < rr.x || key > rr.y
                ? 0.f
                : exp2f(fmaf(sc[e], scale_log2, -lse2[e / 2]));
        sc[e] = p * (dp[e] - dl[e / 2]) * scale;
      }
      accum<W>(acc, sc, Ks + j * STEP * L, g, t);  // dQ += dS K
    }
    __syncwarp();  // the slot's last reads are done: refill it
    issue(s + STAGES);
  }
  cp_async_wait<0>();  // no copy outlives the warp (a strip of no step)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= Sq) continue;
    float* out = dq + ((size_t)bh * Sq + row) * hd + 2 * t;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      if (8 * n < hd)
        *reinterpret_cast<float2*>(out + 8 * n) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

}  // namespace etpu::f32n

namespace etpu::f32w {

using namespace f32n;

constexpr int CW = 64;  // columns a warp
// a plan row (ops/flash_attention.py `dkv_plan`, `_plan_table`): k tile,
// kv row, first step, step count, partial slot (-1: the tile's only
// chunk)
constexpr int PLAN_ROW = 5;

// The wide bodies' geometry at width W with NS_ strips a CTA.
template <int W, int NS_>
struct Wide {
  static constexpr int CS = W / CW;  // warps a strip
  static constexpr int NS = NS_;     // strips a CTA
  static constexpr int THREADS = NS * CS * 32;
  static constexpr int RES = NS * ROWS;  // resident rows (a q or k tile)
  static constexpr int TILE = W == 256 ? 32 : 64;  // streamed rows a stage
  static constexpr int STAGES = 2;
  static constexpr int L = LD<W>;
  // the exchange: a strip's two buffers (step parity) of CS slots of 256
  // floats (S and dP, 4 each a lane)
  static constexpr int XCH = CS > 1 ? NS * 2 * CS * 256 : 0;
  // dQ: Q and dO resident, a ring of (K, V)
  static constexpr size_t dq_bytes =
      sizeof(float) * (2 * RES * L + STAGES * 2 * TILE * L + XCH);
  // dK/dV: K and V resident, a ring of (Q, dO, lse, delta)
  static constexpr int dkv_stage = 2 * TILE * L + 2 * TILE;
  static constexpr size_t dkv_bytes =
      sizeof(float) * (2 * RES * L + STAGES * dkv_stage + XCH);
};

// dQ's and dK/dV's strips a CTA. dQ at 256 takes one (16 query rows):
// its last q tiles walk every key, and the makespan is their chain of
// steps, which a CTA of one strip runs 7% faster (its 4 warps alone on
// an SM) than one of two (tests/torch_flash_f32_variants.py
// `dq256_strips2`).
template <int W>
using DqWide = Wide<W, W == 256 ? 1 : 4>;
template <int W>
using DkvWide = Wide<W, W == 256 ? 2 : 4>;

// The strip's CS warps' partial s and dp summed: each warp stores its two
// C fragments in its slot of `x` (CS slots of 256 floats), waits at the
// strip's named barrier `bar` and adds the slots in order, so every warp
// of the strip holds the same sums. The caller alternates two buffers
// by step, so one barrier a step orders both the stores and the reads.
template <int CS>
__device__ __forceinline__ void exchange(float (&s)[4], float (&dp)[4],
                                         float* x, int part, int lane,
                                         int bar) {
  if constexpr (CS > 1) {
    float* mine = x + part * 256 + 4 * lane;
    *reinterpret_cast<float4*>(mine) = make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(mine + 128) =
        make_float4(dp[0], dp[1], dp[2], dp[3]);
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(CS * 32) : "memory");
    const float* all = x + 4 * lane;
    float4 a = *reinterpret_cast<const float4*>(all);
    float4 b = *reinterpret_cast<const float4*>(all + 128);
#pragma unroll
    for (int c = 1; c < CS; ++c) {
      const float4 ac = *reinterpret_cast<const float4*>(all + c * 256);
      const float4 bc = *reinterpret_cast<const float4*>(all + c * 256 + 128);
      a.x += ac.x;
      a.y += ac.y;
      a.z += ac.z;
      a.w += ac.w;
      b.x += bc.x;
      b.y += bc.y;
      b.z += bc.z;
      b.w += bc.w;
    }
    s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
    dp[0] = b.x, dp[1] = b.y, dp[2] = b.z, dp[3] = b.w;
  }
}

// The first and last local rows of the other operand that the strip at
// local row s0 (of `limit` rows) meets, by `run` (key_run or query_run:
// both ends grow with the row), or an empty run (1, -1) past `limit`.
template <typename Run>
__device__ __forceinline__ int2 strip_run(int s0, int limit, Run run) {
  if (s0 >= limit) return make_int2(1, -1);
  return make_int2(run(s0).x, run(min(s0 + ROWS, limit) - 1).y);
}

// dQ at widths 64-256: one CTA a (query head, RES-row q tile), its NS
// strips' Q and dO resident, K and V streamed through the ring (the
// design above).
template <int W>
__global__ void __launch_bounds__(DqWide<W>::THREADS, 1)
    flash_dq_f32_wide_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, FastDiv group, int Sq,
                             int Sk, int hd, int q_offset, int k_offset,
                             int causal, int window, float scale) {
  using G = DqWide<W>;
  constexpr int L = G::L, CS = G::CS, RES = G::RES, TILE = G::TILE;
  constexpr int STAGES_ = G::STAGES, N = CW / 8, NT = G::THREADS;
  extern __shared__ __align__(16) float smem_w[];
  float* Qs = smem_w;
  float* dOs = Qs + RES * L;
  float* ring = dOs + RES * L;  // stage slot s: K, then V
  float* xch = ring + STAGES_ * 2 * TILE * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int strip = warp / CS, part = warp % CS, c0 = part * CW;
  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * RES;
  const int kv_row = group(bh);  // b*KVH + h / group (H = KVH * group)
  const float* kp = k + (size_t)kv_row * Sk * hd;
  const float* vp = v + (size_t)kv_row * Sk * hd;
  auto keys = [&](int ql) {
    return key_run(ql, Sq, Sk, q_offset, k_offset, causal, window);
  };

  // the CTA's walk over the keys, and the strip's run of them
  const Walk<TILE> walk(keys(r0), keys(min(r0 + RES, Sq) - 1));
  const int s0 = r0 + strip * ROWS;
  const int2 mine = strip_run(s0, Sq, keys);
  int2 run[2];           // the lane's two rows' runs of keys
  float lse2[2], dl[2];  // their lse times log2 e, and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = s0 + g + 8 * r;
    run[r] = keys(row);
    const bool in = row < Sq;
    lse2[r] = in ? lse[(size_t)bh * Sq + row] * kLog2e : 0.f;
    dl[r] = in ? delta[(size_t)bh * Sq + row] : 0.f;
  }

  load_rows<W, NT>(Qs, q + (size_t)bh * Sq * hd, r0, RES, Sq, hd, tid);
  load_rows<W, NT>(dOs, dout + (size_t)bh * Sq * hd, r0, RES, Sq, hd, tid);
  auto issue = [&](int s) {
    if (s < walk.stages) {
      float* slot = ring + (s % STAGES_) * 2 * TILE * L;
      const int n = walk.steps(s) * STEP;
      load_rows<W, NT>(slot, kp, walk.row(s), n, Sk, hd, tid);
      load_rows<W, NT>(slot + TILE * L, vp, walk.row(s), n, Sk, hd, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES_; ++s) issue(s);

  Strip<CW> qs, os;  // the strip's Q and dO at the warp's columns
  float acc[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;
  float* xs = xch + strip * 2 * CS * 256;
  int taken = 0;  // steps taken: the exchange buffer's parity

  for (int s = 0; s < walk.stages; ++s) {
    cp_async_wait<STAGES_ - 1>();
    __syncthreads();
    if (s == 0) {
      load_strip<CW, L>(qs, Qs + strip * ROWS * L + c0, g, t);
      load_strip<CW, L>(os, dOs + strip * ROWS * L + c0, g, t);
    }
    const float* Ks = ring + (s % STAGES_) * 2 * TILE * L;
    const float* Vs = Ks + TILE * L;
    const int k0 = walk.row(s);
#pragma unroll 1
    for (int j = 0; j < walk.steps(s); ++j) {
      const int kj = k0 + j * STEP;
      if (kj > mine.y || kj + STEP - 1 < mine.x) continue;  // the strip's
      const float* Kj = Ks + j * STEP * L + c0;
      float sc[4], dp[4];
      dots<CW, L>(sc, qs, Kj, g, t);
      dots<CW, L>(dp, os, Vs + j * STEP * L + c0, g, t);
      exchange<CS>(sc, dp, xs + (taken++ & 1) * CS * 256, part, lane,
                   1 + strip);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kj + 2 * t + (e & 1);
        const int2 rr = run[e / 2];
        const float p =
            key < rr.x || key > rr.y
                ? 0.f
                : exp2f(fmaf(sc[e], scale_log2, -lse2[e / 2]));
        sc[e] = p * (dp[e] - dl[e / 2]) * scale;
      }
      accum_n<N, L>(acc, sc, Kj, g, t);  // dQ += dS K, the warp's columns
    }
    __syncthreads();  // every warp's reads of the slot are done
    issue(s + STAGES_);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = s0 + g + 8 * r;
    if (row >= Sq) continue;
    float* out = dq + ((size_t)bh * Sq + row) * hd + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (c0 + 8 * n < hd)
        *reinterpret_cast<float2*>(out + 8 * n) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// The live q tiles (TILE rows) of the k tile of RES rows at k0: the
// first and their count, those rows_meet admits (one run: the causal
// rule drops tiles from the start, the window's from the end), as
// ops/flash_attention.py `dkv_live_q_tiles` finds them.
template <int RES, int TILE>
__device__ __forceinline__ int2 live_q_tiles(int k0, int Sq, int Sk,
                                             int q_offset, int k_offset,
                                             int causal, int window) {
  const int k_last = min(k0 + RES, Sk) - 1;
  const int nq = (Sq + TILE - 1) / TILE;
  int lo = 0, n = 0;
  for (int qi = 0; qi < nq; ++qi) {
    const int q0 = qi * TILE;
    if (rows_meet(q0, min(q0 + TILE, Sq) - 1, k0, k_last, q_offset,
                  k_offset, causal, window)) {
      if (n == 0) lo = qi;
      ++n;
    }
  }
  return make_int2(lo, n);
}

// dK/dV at widths 64-256: one CTA a plan chunk of a RES-row k tile, its
// NS strips' K and V resident, a step's Q, dO, lse and delta streamed
// through the ring (the design above). Step t of the k tile's walk is
// query head t / n of the group and q tile lo + t % n (`live_q_tiles`).
// Without a plan (`plan` null) CTA i takes k tile i / BKV of kv row i %
// BKV whole, the first k tiles (the heaviest under causal masking) first.
template <int W>
__global__ void __launch_bounds__(DkvWide<W>::THREADS, 1)
    flash_dkv_f32_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ plan,
                              float* __restrict__ partials,
                              float* __restrict__ dk,
                              float* __restrict__ dv, int BKV, int grp,
                              int Sq, int Sk, int hd, int q_offset,
                              int k_offset, int causal, int window,
                              float scale) {
  using G = DkvWide<W>;
  constexpr int L = G::L, CS = G::CS, RES = G::RES, TILE = G::TILE;
  constexpr int STAGES_ = G::STAGES, N = CW / 8, NT = G::THREADS;
  extern __shared__ __align__(16) float smem_w[];
  float* Ks = smem_w;
  float* Vs = Ks + RES * L;
  float* ring = Vs + RES * L;  // stage slot: Q, dO, lse, delta
  float* xch = ring + STAGES_ * G::dkv_stage;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int strip = warp / CS, part = warp % CS, c0 = part * CW;
  int kt = blockIdx.x / BKV, bkv = blockIdx.x % BKV, first = 0, count = -1,
      slot = -1;
  if (plan != nullptr) {
    const int* row = plan + PLAN_ROW * blockIdx.x;
    kt = row[0], bkv = row[1], first = row[2], count = row[3], slot = row[4];
  }
  const int k0 = kt * RES;
  // GQA: kv row bkv = b*KVH + kh serves query rows bkv * grp + gi
  const size_t qrow0 = (size_t)bkv * grp;
  auto queries = [&](int kl) {
    return query_run(kl, Sq, Sk, q_offset, k_offset, causal, window);
  };
  const int2 live = live_q_tiles<RES, TILE>(k0, Sq, Sk, q_offset, k_offset,
                                            causal, window);
  if (count < 0) count = grp * live.y;  // the whole walk
  const int s0 = k0 + strip * ROWS;
  const int2 mine = strip_run(s0, Sk, queries);
  int2 run[2];  // the lane's two key rows' runs of queries
#pragma unroll
  for (int r = 0; r < 2; ++r) run[r] = queries(s0 + g + 8 * r);

  // step u of the chunk: its query row (of q and dO) and first q row
  auto step = [&](int u, size_t& bh, int& q0) {
    const int st = first + u;
    const int gi = st / live.y;
    bh = qrow0 + gi;
    q0 = (live.x + st - gi * live.y) * TILE;
  };
  load_rows<W, NT>(Ks, k + (size_t)bkv * Sk * hd, k0, RES, Sk, hd, tid);
  load_rows<W, NT>(Vs, v + (size_t)bkv * Sk * hd, k0, RES, Sk, hd, tid);
  auto issue = [&](int u) {
    if (u < count) {
      size_t bh;
      int q0;
      step(u, bh, q0);
      float* st = ring + (u % STAGES_) * G::dkv_stage;
      load_rows<W, NT>(st, q + bh * Sq * hd, q0, TILE, Sq, hd, tid);
      load_rows<W, NT>(st + TILE * L, dout + bh * Sq * hd, q0, TILE, Sq,
                       hd, tid);
      if (warp == 0) {
        load_stats(st + 2 * TILE * L, lse + bh * Sq, q0, TILE, Sq, lane);
        load_stats(st + 2 * TILE * L + TILE, delta + bh * Sq, q0, TILE, Sq,
                   lane);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < STAGES_; ++u) issue(u);

  Strip<CW> ks, vs;  // the strip's K and V at the warp's columns
  float dka[N][4], dva[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;
  float* xs = xch + strip * 2 * CS * 256;
  int taken = 0;

  for (int u = 0; u < count; ++u) {
    cp_async_wait<STAGES_ - 1>();
    __syncthreads();
    if (u == 0) {
      load_strip<CW, L>(ks, Ks + strip * ROWS * L + c0, g, t);
      load_strip<CW, L>(vs, Vs + strip * ROWS * L + c0, g, t);
    }
    size_t bh;
    int q0;
    step(u, bh, q0);
    const float* Qs = ring + (u % STAGES_) * G::dkv_stage;
    const float* dOs = Qs + TILE * L;
    const float* ls = Qs + 2 * TILE * L;
    const float* des = ls + TILE;
#pragma unroll 1
    for (int j = 0; j < TILE / STEP; ++j) {
      const int qj = q0 + j * STEP;
      if (qj > mine.y || qj + STEP - 1 < mine.x) continue;  // the strip's
      const float* Qj = Qs + j * STEP * L + c0;
      const float* dOj = dOs + j * STEP * L + c0;
      float st[4], dpt[4];
      dots<CW, L>(st, ks, Qj, g, t);
      dots<CW, L>(dpt, vs, dOj, g, t);
      exchange<CS>(st, dpt, xs + (taken++ & 1) * CS * 256, part, lane,
                   1 + strip);
      // the statistics of the lane's two query columns, 2t and 2t + 1
      const float2 lq =
          *reinterpret_cast<const float2*>(ls + j * STEP + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(des + j * STEP + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = qj + 2 * t + (e & 1);
        const int2 rr = run[e / 2];
        const float lx = (e & 1) ? lq.y : lq.x;
        const float dx = (e & 1) ? dl.y : dl.x;
        const float p = qr < rr.x || qr > rr.y
                            ? 0.f
                            : exp2f(fmaf(st[e], scale_log2, -lx * kLog2e));
        st[e] = p;
        dpt[e] = p * (dpt[e] - dx) * scale;
      }
      accum_n<N, L>(dva, st, dOj, g, t);   // dV += P^T dO
      accum_n<N, L>(dka, dpt, Qj, g, t);   // dK += dS^T Q
    }
    __syncthreads();  // every warp's reads of the slot are done
    issue(u + STAGES_);
  }
  cp_async_wait<0>();

  if (slot < 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = s0 + g + 8 * r;
      if (kr >= Sk) continue;
      const size_t off = ((size_t)bkv * Sk + kr) * hd + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < N; ++n)
        if (c0 + 8 * n < hd) {
          *reinterpret_cast<float2*>(dk + off + 8 * n) =
              make_float2(dka[n][2 * r], dka[n][2 * r + 1]);
          *reinterpret_cast<float2*>(dv + off + 8 * n) =
              make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
        }
    }
  } else {
    // a split k tile: the f32 partials, RES rows of W floats (columns
    // past hd hold zeros), dK then dV
    float* pk = partials + (size_t)slot * 2 * RES * W;
    float* pv = pk + RES * W;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = (strip * ROWS + g + 8 * r) * W + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        *reinterpret_cast<float2*>(pk + off + 8 * n) =
            make_float2(dka[n][2 * r], dka[n][2 * r + 1]);
        *reinterpret_cast<float2*>(pv + off + 8 * n) =
            make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  }
}

}  // namespace etpu::f32w

namespace etpu {

cudaError_t f32_bwd_dq(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dq, int B, int H, int KVH,
                       int Sq, int Sk, int hd, int q_offset, int k_offset,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  const f32n::FastDiv group = f32n::FastDiv::of(H / KVH);
  return with_head_dim(hd, [&](auto w) -> cudaError_t {
    constexpr int W = decltype(w)::value;
    if constexpr (W <= 32) {
      // a warp a strip of 16 query rows
      constexpr size_t smem = f32n::DqSmem<W>::bytes;
      auto kernel = f32n::flash_dq_f32_narrow_kernel<W>;
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((B * H + f32n::kWarps - 1) / f32n::kWarps,
                      (Sq + f32n::ROWS - 1) / f32n::ROWS);
      kernel<<<grid, f32n::kWarps * 32, smem, stream>>>(
          q, k, v, dout, lse, delta, dq, B * H, group, Sq, Sk, hd, q_offset,
          k_offset, causal, window, scale);
    } else {
      using G = f32w::DqWide<W>;
      auto kernel = f32w::flash_dq_f32_wide_kernel<W>;
      cudaError_t err = allow_smem(kernel, G::dq_bytes);
      if (err != cudaSuccess) return err;
      const dim3 grid(B * H, (Sq + G::RES - 1) / G::RES);
      kernel<<<grid, G::THREADS, G::dq_bytes, stream>>>(
          q, k, v, dout, lse, delta, dq, group, Sq, Sk, hd, q_offset,
          k_offset, causal, window, scale);
    }
    return cudaGetLastError();
  });
}

cudaError_t f32_bwd_dkv(const float* q, const float* k, const float* v,
                        const float* dout, const float* lse,
                        const float* delta, float* dk, float* dv,
                        const int* plan, int chunks, float* partials, int B,
                        int H, int KVH, int Sq, int Sk, int hd, int q_offset,
                        int k_offset, int causal, int window, float scale,
                        cudaStream_t stream) {
  return with_head_dim(hd, [&](auto w) -> cudaError_t {
    constexpr int W = decltype(w)::value;
    if constexpr (W <= 32) {
      // a warp a strip of 16 key rows
      constexpr size_t smem = f32n::DkvSmem<W>::bytes;
      auto kernel = f32n::flash_dkv_f32_narrow_kernel<W>;
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((B * KVH + f32n::kWarps - 1) / f32n::kWarps,
                      (Sk + f32n::ROWS - 1) / f32n::ROWS);
      kernel<<<grid, f32n::kWarps * 32, smem, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, B * KVH, H / KVH, Sq, Sk, hd,
          q_offset, k_offset, causal, window, scale);
    } else {
      // a CTA a chunk of the plan, or a k tile without one
      using G = f32w::DkvWide<W>;
      const int grid =
          plan != nullptr ? chunks : (Sk + G::RES - 1) / G::RES * B * KVH;
      if (grid <= 0) return cudaErrorInvalidValue;
      auto kernel = f32w::flash_dkv_f32_wide_kernel<W>;
      cudaError_t err = allow_smem(kernel, G::dkv_bytes);
      if (err != cudaSuccess) return err;
      kernel<<<grid, G::THREADS, G::dkv_bytes, stream>>>(
          q, k, v, dout, lse, delta, plan, partials, dk, dv, B * KVH,
          H / KVH, Sq, Sk, hd, q_offset, k_offset, causal, window, scale);
    }
    return cudaGetLastError();
  });
}

}  // namespace etpu
