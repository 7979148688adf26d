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
// - dK/dV: one CTA per (batch*kv_head, k tile of 128 rows) loops over
//   the group's query heads and, for each, over the q tiles that can see
//   this k tile (the kv-major grid of `_bwd_calls`), keeping dK and dV
//   in registers, written once. At width 256 the walk of a 64-row k tile
//   may be cut into chunks, one CTA each, whose f32 partials a second
//   kernel sums in a fixed order (below).
// (At widths 16 and 32 the tiles are 192 rows, and past one wave of the
// SMs a CTA walks pairs of them: below.)
// Every body is instantiated at widths 16, 32, 64, 128 and 256
// (hopper.cuh `with_head_dim`): 16, 32 and 64 are the head dims of the
// repo's configurations, 128 that of most published LMs, 256 that of
// Gemma-2B and -7B. A head dim d that is a multiple of 8 up to 256 runs
// the body of the smallest width W >= d (96, Phi-3-mini's, and 72-120 on
// W 128; 136-248 on W 256; 40-56 on W 64; 24 on W 32; 8 on W 16): the
// tensor maps hold d, TMA fills each tile's columns d .. W - 1
// with zeros, and the products run at W. Zero columns of Q, K, V and dO
// add nothing to S or dP and give zero columns of dQ = dS K, dK = dS^T Q
// and dV = P^T dO, which the stores drop: only each row's first d
// columns are written. The f32 bodies load zeros past d and store
// columns below it. The tensor cores then do W / d times the work of d
// (1.33x at 96); the bytes read stay those of d. Bodies:
// - dK/dV, bf16 (the working type) at width 64: CTAs of the first k
//   tiles (the most live q tiles under causal masking) scheduled first.
//   One producer warp TMA-loads K and V once and then, per live q tile,
//   Q and dO into a 6-stage ring of shared memory guarded by full/empty
//   mbarriers; its lanes stage that tile's lse (times log2 e) and delta
//   beside them (a 1-D bulk copy would need 16-byte aligned rows, which
//   a ragged Sq does not give). A tile row is the body's 2*W bytes in
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
//   At D 128 dK and dV of a warpgroup's 64 key rows are 64 x 128 each,
//   128 f32 a thread before S^T and dP^T (64) and the packed P^T and
//   dS^T (32): past the 168 a thread that a 288- or 384-thread CTA gets.
//   There the CTA is 12 warps: a producer warpgroup whose warps drop to
//   24 registers (`setmaxnreg`; warp 8 loads, warp 9 watches the CTA,
//   hopper.cuh `mbar_wait_spin`) and two consumer warpgroups that rise
//   to 240, each owning its own 64 key rows at the whole head dim, so S^T
//   and dP^T are computed once per key row: 8*D flops a (q, k) pair.
//   K and V of the CTA's 128 rows (32 KB each) stay resident beside a
//   4-stage ring of 16 KB Q and dO tiles (195 KB), each Q and dO tile
//   streamed once per 128 key rows. ptxas: 168 registers at launch, no
//   spill.
// - dK/dV at width 256 (`flash_dkv_w256_kernel`): the same 12 warps, a
//   CTA of 64 key rows whose two consumer warpgroups split the head dim
//   (dK and dV at 128 columns each: 128 f32 a thread); K and V resident,
//   Q and dO through a 2-stage ring of 32 KB tiles. S^T and dP^T are
//   computed once a step: warpgroup 0 computes S^T and warpgroup 1 dP^T,
//   warpgroup 1 hands dP^T over in f32 through shared memory, warpgroup 0
//   forms P and dS (the same arithmetic as the narrower bodies) and
//   stores P^T and dS^T as bf16 tiles in the 128-byte swizzle, and both
//   read those as the shared-memory A operand of dV += P^T dO and dK +=
//   dS^T Q; three named barriers a step order the hand-overs (226 KB of
//   shared memory). One CTA a 64-row k tile would leave a
//   multi-query group's walk (all its query heads times the live q
//   tiles) on few SMs: Gemma-2B's fit (B 2, 8 heads over 1, S 1024) is
//   32 CTAs on 132 SMs, the heaviest walking 128 (head, q tile) steps.
//   So the wrapper cuts each k tile's walk into chunks of about equal
//   length sized to fill the SMs (ops/flash_attention.py `dkv_plan`: a
//   pure function of the shapes, offsets, mask and SM count; 144 chunks
//   there) and passes them as a table of int32 rows (k tile, kv row,
//   first step, step count, partial slot), the heaviest first. A k tile
//   that is one chunk stores bf16 dK and dV as before; the chunks of a
//   split one store f32 partials (64 x 256 each, dK and dV) in the
//   wrapper's scratch, and `flash_dkv_reduce_kernel` sums each split
//   tile's partials in chunk order and casts once to bf16, as
//   `_dkv_kernel` casts its f32 accumulator once; no atomics, so two
//   runs give the same bits. Where no k tile splits (B 8, 16 heads over
//   16: 2048 k tiles already) the wrapper passes no table, and a CTA
//   takes its k tile from its block index, reading nothing before its
//   first load.
// - dQ, bf16, at width 64: the same shape turned q-major.
//   One CTA per (batch*head, 128-row q tile), the last q tiles (the
//   most live K/V tiles under causal masking) scheduled first. The
//   producer warp TMA-loads Q and dO once, then streams the live 64-row
//   K and V tiles through a 6-stage ring under full/empty mbarriers.
//   Each of two consumer warpgroups owns 64 query rows, whose lse (times
//   log2 e) and delta it holds in registers (two rows a thread), and per
//   K/V tile computes S = Q K^T and dP = dO V^T with wgmma m64n64k16
//   from shared memory (P formed from S while dP is still in flight),
//   dS = P (dP - delta) scale on the accumulators, packed to bf16
//   (`ds.astype(k.dtype)`) as the register A operand of dQ += dS K
//   (m64nDk16, K MN-major from the same ring slot, with the transpose
//   bit). A warpgroup whose rows meet no key of a tile skips its
//   products. dQ leaves through the warpgroup's Q rows in shared memory
//   in 16-byte stores, rows past Sq dropped.
// - dQ at widths 128 and 256 (`flash_dq_pingpong_kernel`): dQ's
//   accumulator is 64 f32 a thread at 128, and S and dP of a whole
//   64-key tile beside it (32 each) and the packed dS (16) pass the 168
//   a thread that a 288- or 384-thread CTA gets. So the CTA is the
//   forward's 12 warps: a producer warpgroup at 24 registers
//   (`setmaxnreg`; warp 8 loads, warp 9 watches the CTA) and two
//   consumer warpgroups at 240, each owning 64 query rows at the whole
//   head dim; 128 query rows a CTA, 64-key K/V tiles in a 5-stage ring
//   (225 KB). At 256 dQ is 128 f32 a thread, so the tiles are 32 keys
//   (S and dP 16 f32 each), 3 of them in the ring beside Q's and dO's 64
//   KB each (225 KB). A consumer issues tile j's S and dP and tile
//   j-1's dQ product in one turn, three groups: P(j) is formed while
//   dP(j) and dQ(j-1) run, dS(j) while dQ(j-1) does, and dS(j) is
//   packed into the A fragments once dQ(j-1) has read the old ones. The
//   turns alternate between the warpgroups on named barriers
//   (ping-pong, as the forward's): the tensor cores run one warpgroup's
//   products while the other forms P and dS. Both take a turn on each
//   live tile of the CTA and one more for the last dQ; every product of
//   a turn is issued unconditionally (a warpgroup whose rows meet none
//   of a tile masks all of it, and the first turn's dQ product is one
//   of zeros), since a product in flight where two paths meet makes
//   ptxas serialize every wgmma (C7515). The products and the order of
//   dQ's k16 steps over the keys are those of the narrower bodies. The
//   CTAs go heaviest first within groups of heads whose K and V fit in
//   L2 (at B 8, 16 heads their K and V take 64 MB at 128 and 128 MB at
//   256, past the 50 MB L2, and heaviest first over all heads read them
//   again from HBM for every q tile), the groups of equal size.
// - dQ at width 256 where 128-row q tiles fill at most one wave of the
//   SMs (`flash_dq_w256_kernel`, the split body): there the CTA of the
//   last q tile walks every key alone (Gemma-2B's fit, B 2, 8 heads over
//   1, S 1024: 128 CTAs of 4 to 32 32-key tiles), so the CTAs own 64
//   query rows (256 CTAs of 1 to 16 64-key tiles, heaviest first). Two
//   warpgroups of one 64-row tile split dQ's columns (128 each: 64 f32 a
//   thread), as the 256 dK/dV body splits dK and dV: per 64-key tile
//   warpgroup 0 computes S = Q K^T and warpgroup 1 dP = dO V^T,
//   warpgroup 1 hands dP over in f32 through shared memory, warpgroup 0
//   forms P and dS and stores dS as a bf16 tile in the 128-byte swizzle,
//   and both read it as the shared-memory A operand of dQ += dS K over
//   their columns. Warpgroup 0 holds Q and warpgroup 1 dO as register A
//   fragments (64 registers: S and dP are RS products, reading only K or
//   V from shared memory), read once from the first slot of the K and V
//   rings, which then stream the tiles (3 slots of 32 KB each): 217 KB.
//   Warpgroup 1 issues the next tile's dP before it waits for the dS, so
//   the tensor cores run it while warpgroup 0 forms dS; two named
//   barriers a tile order the hand-overs. It reads a 64 KB K/V tile for
//   64 query rows, twice the ping-pong body's bytes a row, and its
//   warpgroups meet twice a tile, so past one wave the ping-pong body is
//   faster.
// - dQ and dK/dV, bf16, at widths 16 and 32 (8-32; `flash_dq_narrow_kernel`
//   and `flash_dkv_narrow_kernel`, namespace nb). There the products
//   shrink with D and the per-pair elementwise step does not: the exp2,
//   the FMAs of P and dS, the mask, the packs. With the width-64 design
//   at these widths (two consumer warpgroups, each running its S and dP,
//   then that step, then its gradient products in sequence) timing-only
//   builds (tests/torch_flash_bwd_variants.py) ran 57% (dQ) and 41%
//   (dK/dV) faster with the step removed and 1-3% with only the exp2
//   replaced by an FMA: the step in sequence held them, not the exp2. So
//   these bodies are the narrow forward's shape (flash_fwd.cu): 16 warps,
//   a producer warpgroup that drops to 32 registers and three consumer
//   warpgroups of 64 rows that rise to 160 (`setmaxnreg`; 512 threads
//   launch at 128), so three consumer warps a scheduler hide each
//   other's steps, and within a warpgroup the step runs under products.
//   A CTA owns 192 rows, resident in one of two slots (the next tile's
//   rows land while this one runs): query rows and their Q and dO for
//   dQ, key rows and their K and V for dK/dV. The 64-row tiles of the
//   other side stream past it through an 8-stage ring under full/empty
//   mbarriers, each serving all three warpgroups: K and V (dQ, lane 0 of
//   a producer warp by TMA), Q and dO with the rows' lse and delta (dK/dV:
//   TMA from lane 0, lse and delta by the warp's 32 lanes as 4-byte
//   cp.async that zero-fill rows past Sq and arrive on the stage's full
//   barrier when they land, so the stats never stall the loader).
//   Each warpgroup walks its own run of the CTA's live tiles: the tiles
//   its rows do not meet (the diagonal, a window edge, rows past the
//   length) it releases once they land. Per step it issues S (S^T) and
//   dP (dP^T) as two commit groups with the previous step's gradient
//   products behind them (dQ(j-1); dV(j-1) and dK(j-1)), forms P while
//   dP and those run, dS while the gradient products run, and packs both
//   once they are done with the A fragments. Registers at W 32: S and dP
//   64 f32, the packed fragments 16 (dQ) or 32 (P^T and dS^T), dQ 16 or
//   dK and dV 32; ptxas fits them in 160 without a spill. Every product
//   is issued unconditionally, nothing left in flight where two paths
//   meet, no trap in a consumer (C7515, C7512). The mask is two compares
//   an element against its row's run of valid columns, only on tiles
//   that hold a masked pair. The exponentials, the FMAs and the order of
//   every sum are those of the width-64 body, so the gradients are its
//   bits. The schedule goes by shape: where the 192-row tiles fill at
//   most one wave of the SMs (`tpu_model_lm_d32`'s B 16 x H 8 x S 128:
//   128 q tiles, 128 k tiles), one CTA a tile, heaviest first; past it
//   (B 8 x H 16 x S 1024: 768 of each), persistent, one CTA an SM over
//   pairs of tiles, the t-th heaviest with the t-th lightest (dQ: the
//   last q tiles are heaviest under causal masking; dK/dV: the first k
//   tiles), a ragged last tile ranked by its warpgroups' rows times the
//   tiles they meet (`ragged_rank`). Every head's operands fit in L2 at
//   these widths, so heads are not grouped. The dQ and dK/dV of a tile
//   leave through the warpgroup's own rows of the slot in 16-byte
//   stores before the slot is released.
// - the reduction: one CTA of 256 threads per (split k tile, dK or dV, 16
//   rows), each thread summing 4 columns of a row over the tile's slots
//   in order (16-byte loads) and storing the 4 columns below hd, bf16 (or
//   f32 for the f32 bodies' plans).
//   Bound by bytes: the partials read once (17.5 MB of f32 at Gemma-2B's
//   fit, most of them still in L2) and the split tiles' rows written.
// - f32, every width: flash_bwd_f32.cu, whose entries the C interface
//   below calls for f32 operands. All run on the tensor cores as 3xTF32
//   `mma.sync`: strips of 16 rows a warp at widths 16 and 32, CTAs of
//   strips sharing a ring of tiles at 64-256, dK/dV there on the plan
//   of the width-256 bf16 body (below) with a reduction of its own.
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
// (q, k) pair does not: one exp2 a pair at the special-function units'
// 3.9 T/s (0.0172 ms at B 8, S 1024) is above the bytes-or-operations
// bound at both widths, and the narrow bodies (above) put the step under
// the products of three warpgroups. At 128
// and 256 both are bound by operations, and dQ there runs a tile's
// products under the next tile's (above). The 256 dK/dV body
// streams a 32 KB Q and a 32 KB dO tile for every 64 key rows (a 128-row
// k tile would need dK and dV at 256 f32 a thread), so each step moves
// 64 KB into the SM for 4 products of 64 x 64 x 256, and its warpgroups
// wait on each other's hand-overs within a step.
#include <algorithm>

#include "common.cuh"
#include "flash_bwd_f32.cuh"
#include "hopper.cuh"

namespace {

using namespace etpu;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, KVH, Sq, Sk, hd, q_offset, k_offset, causal, window;
  float scale;
  cudaStream_t stream;
  // the width-256 dK/dV body's plan (`chunks` rows) and the f32
  // partials of its split k tiles
  const int* plan;
  int chunks;
  float* partials;
};

// ------------------------------------ dK/dV bf16: wgmma over TMA tiles
namespace dkv {

constexpr int QROWS = 64;           // query rows per ring stage

template <int D>
struct Layout {
  // at D 128 and 256 a producer warpgroup and register reallocation (see
  // the note at the top); else one producer warp
  static constexpr bool WIDE = D >= 128;
  // at D 256 the two consumer warpgroups split the head dim of the same
  // 64 key rows (SPLIT): each holds dK and dV at 128 of the columns
  static constexpr bool SPLIT = D == 256;
  static constexpr int KROWS = SPLIT ? 64 : 128;  // key rows per CTA
  static constexpr int COLS = SPLIT ? 128 : D;    // a warpgroup's columns
  static constexpr int THREADS = WIDE ? kWideThreads : 2 * 128 + 32;
  // Q/dO tiles in flight
  static constexpr int STAGES = SPLIT ? 2 : WIDE ? 4 : 6;
  // K, V (32 KB each at D 128 and 256, 16 KB at 64), the Q ring, the dO
  // ring (32 KB tiles at D 256, 16 KB at 128, 8 KB at 64), the lse/delta
  // ring (64 + 64 f32 per stage), at D 256 the step's exchange between
  // the two warpgroups (P^T and dS^T, 8 KB bf16 tiles each, and dP^T in
  // f32, 16 KB), then the barriers: kvfull, full[STAGES], empty[STAGES],
  // done (used at D 128 and 256); +1024 for alignment. 226 KB at D 256,
  // 195 KB at D 128, 131 KB at D 64 (widths 16 and 32 run the narrow
  // body, nb::Layout)
  static constexpr uint32_t row = Rows<D>::bytes;
  static constexpr uint32_t atom = Rows<D>::atom;
  static constexpr uint32_t KV_TILE = KROWS * row, Q_TILE = QROWS * row;
  static constexpr uint32_t k = 0, v = KV_TILE, q = 2 * KV_TILE,
                            dout = q + STAGES * Q_TILE,
                            stats = dout + STAGES * Q_TILE,
                            xch = stats + STAGES * 2 * QROWS * 4,
                            pt = xch, dst = pt + 64 * 128,
                            dpx = dst + 64 * 128,
                            bars = xch + (SPLIT ? 4 * 64 * 128 : 0);
  static constexpr size_t bytes = bars + (2 + 2 * STAGES) * 8 + 1024;
  static_assert(bytes <= 232448, "at most 227 KB of shared memory");
};

template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int BKV, int H, int KVH, int Sq, int Sk, int hd,
                           int q_offset, int k_offset, int causal,
                           int window, float scale) {
  using L = Layout<D>;
  static_assert(D == 64 || D == 128, "widths 16 and 32 run "
                "flash_dkv_narrow_kernel, 256 flash_dkv_w256_kernel");
  constexpr uint32_t KV_TILE = L::KV_TILE, Q_TILE = L::Q_TILE;
  constexpr int STAGES = L::STAGES, KROWS = L::KROWS;
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
  uint64_t* done = empty + STAGES;
  // at D 128 the waits spin and warp 9 is the CTA's watchdog (hopper.cuh
  // mbar_wait_spin); below it each wait has its own
  auto wait = [](uint64_t* bar, uint32_t parity) {
    if constexpr (L::WIDE)
      mbar_wait_spin(bar, parity);
    else
      mbar_wait(bar, parity);
  };

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
      mbar_init(&full[s], 32);  // every lane of warp 8 (lse and delta)
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    if constexpr (L::WIDE)
      mbar_init(done, 8);  // lane 0 of each consumer warp, at its end
    fence_barrier_init();
  }
  __syncthreads();

  // (at D 128 known to be uniform over the warp, so the warpgroup's
  // descriptors take uniform registers; below it the body stays as it
  // was)
  const int warp = L::WIDE ? warp_index() : (int)threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ---- producer: at D >= 128 every warp of the producer warpgroup gives
    // its registers back first, and warp 8 works alone. K and V once;
    // then, for each query head of the group and each live q tile, Q and
    // dO by TMA and lse*log2(e) and delta by the warp's lanes (rows past
    // Sq read 0: they are masked)
    if constexpr (L::WIDE) {
      setmaxnreg_dec<kProducerRegs>();
      if (warp == 9) cta_watchdog(done);
    }
    if (warp == 8) {
      if (lane == 0) {
        mbar_expect_tx(kvfull, 2 * KV_TILE);
        tma_load_tile<D, KROWS>(Ks, &tk, kvfull, k0, bkv);
        tma_load_tile<D, KROWS>(Vs, &tv, kvfull, k0, bkv);
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
          wait(&empty[s], phase ^ 1);
          float* st = stats + s * 2 * QROWS;
          for (int i = lane; i < QROWS; i += 32) {
            const bool in = q0 + i < Sq;
            const size_t row = (size_t)bh * Sq + q0 + i;
            st[i] = in ? lse[row] * kLog2e : 0.f;
            st[QROWS + i] = in ? delta[row] : 0.f;
          }
          if (lane == 0) {
            // arrives (after this lane's lse/delta stores) and expects
            // the two tiles' bytes
            mbar_expect_tx(&full[s], 2 * Q_TILE);
            tma_load_tile<D, QROWS>(Qs + s * Q_TILE, &tq, &full[s], q0, bh);
            tma_load_tile<D, QROWS>(dOs + s * Q_TILE, &tdo, &full[s], q0,
                                    bh);
          } else {
            mbar_arrive(&full[s]);
          }
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns key rows wk0 .. wk0 + 63 at the
    // whole head dim
    if constexpr (L::WIDE) setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int wk0 = k0 + 64 * wg;
    const int krow = wk0 + 16 * (warp % 4) + lane / 4;  // and krow + 8
    uint8_t* Kw = Ks + 64 * wg * L::atom;
    uint8_t* Vw = Vs + 64 * wg * L::atom;
    const uint64_t kdesc = desc_sw<D>(Kw), vdesc = desc_sw<D>(Vw);
    constexpr int N = L::COLS;
    float dk_acc[N / 2], dv_acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    wait(kvfull, 0);
    int s = 0;
    uint32_t phase = 0;
    for (int g = 0; g < grp; ++g) {
      for (int qi = 0; qi < nq; ++qi) {
        const int q0 = qi * QROWS;
        if (!rows_meet(q0, min(q0 + QROWS, Sq) - 1, k0, k_last, q_offset,
                       k_offset, causal, window))
          continue;
        wait(&full[s], phase);
        const uint64_t qdesc = desc_sw<D>(Qs + s * Q_TILE);
        const uint64_t dodesc = desc_sw<D>(dOs + s * Q_TILE);
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, D/16
        // k16 steps over the head dim
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, desc_k<D, KROWS>(kdesc, kk),
                       desc_k<D, QROWS>(qdesc, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dpt, desc_k<D, KROWS>(vdesc, kk),
                       desc_k<D, QROWS>(dodesc, kk), kk);
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
          wgmma_rs_rows<N, QROWS>(dv_acc, pa[kk], dodesc, kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_rows<N, QROWS>(dk_acc, dsa[kk], qdesc, kk);
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
    // dK and dV through this warpgroup's K and V rows (read by nothing
    // after its last product) to 16-byte stores of each row's first hd
    // columns
    const size_t base = ((size_t)bkv * Sk + wk0) * hd;
    acc_to_tile<D, KROWS>(dk_acc, 1.f, 1.f, Kw);
    acc_to_tile<D, KROWS>(dv_acc, 1.f, 1.f, Vw);
    wg_barrier(1 + wg);
    tile_to_rows<D, KROWS>(Kw, dk + base, Sk - wk0, hd);
    tile_to_rows<D, KROWS>(Vw, dv + base, Sk - wk0, hd);
    if constexpr (L::WIDE) {
      __syncwarp();
      if (lane == 0) mbar_arrive(done);
    }
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
  constexpr int KROWS = Layout<D>::KROWS;
  cudaError_t err = encode_rows_map<D>(&tq, qp, a.hd, qrows, qslabs, QROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tdo, gp, a.hd, qrows, qslabs, QROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tk, a.k, a.hd, a.Sk, a.B * a.KVH, KROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tv, a.v, a.hd, a.Sk, a.B * a.KVH, KROWS);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Layout<D>::bytes;
  err = allow_smem(flash_dkv_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.Sk + KROWS - 1) / KROWS * (a.B * a.KVH);
  constexpr int threads = Layout<D>::THREADS;
  flash_dkv_wgmma_kernel<D><<<grid, threads, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.B * a.KVH, a.H, a.KVH, a.Sq, a.Sk, a.hd,
      a.q_offset, a.k_offset, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// The plan of the width-256 body (ops/flash_attention.py `dkv_plan`):
// row c of `plan` is chunk c, PLAN_ROW ints: its k tile, its kv row (b *
// KVH + kv head), its first step, its step count and its partial slot (-1
// for a k tile that is one chunk). A k tile's steps are its walk over
// (query head g of the group, live q tile qi), g-major: step t is head t
// / n and q tile lo + t % n, where lo .. lo + n - 1 are the q tiles
// rows_meet admits against the k tile (one run: the causal rule drops
// them from the start, the window's from the end). The reduction's rows
// follow the chunks': a split k tile, its kv row, its first slot and its
// slot count.
constexpr int PLAN_ROW = 5;

// The width-256 body's named barriers between its consumer warpgroups
// (1 and 2 are wg_barrier's, 3 the final store's): dP^T handed over,
// P^T and dS^T stored, both warpgroups' products of the step done.
constexpr int kDpReady = 4, kDsReady = 5, kStepDone = 6;

// The live q tiles of the k tile at k0 (the first, lo, and their count).
__device__ __forceinline__ int2 live_q_tiles(int k0, int Sq, int Sk,
                                             int q_offset, int k_offset,
                                             int causal, int window) {
  constexpr int KROWS = Layout<256>::KROWS;
  const int k_last = min(k0 + KROWS, Sk) - 1;
  const int nq = (Sq + QROWS - 1) / QROWS;
  int lo = 0, n = 0;
  for (int qi = 0; qi < nq; ++qi) {
    const int q0 = qi * QROWS;
    if (rows_meet(q0, min(q0 + QROWS, Sq) - 1, k0, k_last, q_offset,
                  k_offset, causal, window)) {
      if (n == 0) lo = qi;
      ++n;
    }
  }
  return make_int2(lo, n);
}

// The width-256 body: one CTA per chunk of the plan, 64 key rows of one
// kv head; the two consumer warpgroups split the head dim (dK and dV at
// 128 columns each) and both compute S^T and dP^T. A chunk that is its k
// tile's only one writes bf16 dK and dV; a chunk of a split k tile writes
// its f32 partials (64 rows x 256 columns each, dK then dV) into slot
// `slot` of `partials`, which flash_dkv_reduce_kernel sums. Where the
// plan splits no k tile the wrapper passes none (`plan` null): CTA i then
// takes k tile i / BKV of kv row i % BKV whole, the first k tiles (the
// most live q tiles under causal masking) first, and reads no table
// before its first load.
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_dkv_w256_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ plan,
                          float* __restrict__ partials,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int BKV, int H, int KVH, int Sq, int Sk, int hd,
                          int q_offset, int k_offset, int causal,
                          int window, float scale) {
  constexpr int D = 256;
  using L = Layout<D>;
  constexpr uint32_t KV_TILE = L::KV_TILE, Q_TILE = L::Q_TILE;
  constexpr int STAGES = L::STAGES, KROWS = L::KROWS;
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
  uint64_t* done = empty + STAGES;

  int k0, bkv, first = 0, count = -1, slot = -1;
  if (plan != nullptr) {
    const int* row = plan + PLAN_ROW * blockIdx.x;
    k0 = row[0] * KROWS;
    bkv = row[1];
    first = row[2];
    count = row[3];
    slot = row[4];
  } else {
    k0 = (int)blockIdx.x / BKV * KROWS;
    bkv = (int)blockIdx.x % BKV;
  }
  const int grp = H / KVH;
  // the group's query heads: rows b*H + kh*grp + g
  const int qrow0 = (bkv / KVH) * H + (bkv % KVH) * grp;
  const int2 live = live_q_tiles(k0, Sq, Sk, q_offset, k_offset, causal,
                                 window);
  const int last = first + (count < 0 ? grp * live.y : count);

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every lane of warp 8 (lse and delta)
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(done, 8);  // lane 0 of each consumer warp, at its end
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = warp_index();
  const int lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ---- producer: every warp of the producer warpgroup gives its
    // registers back first, and warp 8 works alone. K and V once; then,
    // for each step of the chunk, Q and dO by TMA and lse*log2(e) and
    // delta by the warp's lanes (rows past Sq read 0: they are masked)
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 9) cta_watchdog(done);
    if (warp == 8) {
      if (lane == 0) {
        mbar_expect_tx(kvfull, 2 * KV_TILE);
        tma_load_tile<D, KROWS>(Ks, &tk, kvfull, k0, bkv);
        tma_load_tile<D, KROWS>(Vs, &tv, kvfull, k0, bkv);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int t = first; t < last; ++t) {
        const int g = t / live.y;
        const int q0 = (live.x + t - g * live.y) * QROWS;
        const int bh = qrow0 + g;
        mbar_wait_spin(&empty[s], phase ^ 1);
        float* st = stats + s * 2 * QROWS;
        for (int i = lane; i < QROWS; i += 32) {
          const bool in = q0 + i < Sq;
          const size_t r = (size_t)bh * Sq + q0 + i;
          st[i] = in ? lse[r] * kLog2e : 0.f;
          st[QROWS + i] = in ? delta[r] : 0.f;
        }
        if (lane == 0) {
          // arrives (after this lane's lse/delta stores) and expects the
          // two tiles' bytes
          mbar_expect_tx(&full[s], 2 * Q_TILE);
          tma_load_tile<D, QROWS>(Qs + s * Q_TILE, &tq, &full[s], q0, bh);
          tma_load_tile<D, QROWS>(dOs + s * Q_TILE, &tdo, &full[s], q0, bh);
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
    // ---- consumers: the CTA's 64 key rows, dK and dV at columns 128wg
    // .. 128wg + 127. Per step warpgroup 0 computes S^T = K Q^T and
    // warpgroup 1 dP^T = V dO^T (64 keys x 64 queries each, 16 k16 steps);
    // warpgroup 1 hands dP^T over in f32 through shared memory, warpgroup
    // 0 forms P and dS and stores P^T and dS^T as bf16 tiles, and both
    // read them as the A operand of their dV and dK products.
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int t = threadIdx.x % 128;
    const int krow = k0 + 16 * (warp % 4) + lane / 4;  // and krow + 8
    // S^T from K and Q, or dP^T from V and dO
    const uint64_t adesc = desc_sw<D>(wg ? Vs : Ks);
    // the first of this warpgroup's column blocks (2wg) of a ring tile,
    // as an offset of its descriptor: blocks 2wg and 2wg + 1 are a W 128
    // tile of QROWS rows
    const uint64_t half = (2 * wg * QROWS * L::atom) >> 4;
    uint8_t* Pt = sm + L::pt;
    uint8_t* dSt = sm + L::dst;
    float* dPx = reinterpret_cast<float*>(sm + L::dpx);
    // P^T and dS^T as K-major A operands: 64 rows (keys) of 64 queries,
    // the 128-byte swizzle of a W 64 tile
    const uint64_t pdesc = desc_sw<64>(Pt), dsdesc = desc_sw<64>(dSt);
    constexpr int N = L::COLS;
    float dk_acc[N / 2], dv_acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait_spin(kvfull, 0);
    int s = 0;
    uint32_t phase = 0;
    for (int t_ = first; t_ < last; ++t_) {
      const int g = t_ / live.y;
      const int q0 = (live.x + t_ - g * live.y) * QROWS;
      mbar_wait_spin(&full[s], phase);
      const uint64_t qdesc = desc_sw<D>(Qs + s * Q_TILE);
      const uint64_t dodesc = desc_sw<D>(dOs + s * Q_TILE);
      const uint64_t bdesc = wg ? dodesc : qdesc;
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(acc, desc_k<D, KROWS>(adesc, kk),
                     desc_k<D, QROWS>(bdesc, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      if (wg == 1) {
        // dP^T to warpgroup 0: element i of thread t at 128 i + t
#pragma unroll
        for (int i = 0; i < 32; ++i) dPx[128 * i + t] = acc[i];
        consumers_arrive(kDpReady);
        consumers_barrier(kDsReady);
      } else {
        // P = exp2(S*scale*log2(e) - lse*log2(e)) in place of S^T, on the
        // accumulator layout (column c is query q0 + c; this thread's
        // columns come in pairs (c, c + 1), whose lse and delta it reads
        // as float2), then dS = P (dP - delta) scale in place of P; each
        // packed to bf16 (the TPU kernels' casts) into its tile
        const float2* lse2 =
            reinterpret_cast<const float2*>(stats + s * 2 * QROWS);
        const float2* dl = lse2 + QROWS / 2;
        const bool masked =
            q0 + QROWS > Sq || k0 + KROWS > Sk ||
            !rows_all_valid(q0, q0 + QROWS - 1, k0, k0 + KROWS - 1, q_offset,
                            k_offset, causal, window);
        const float scale_log2 = scale * kLog2e;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int c = 8 * (i / 4) + 2 * (lane % 4);  // columns c, c + 1
          const float2 ls = lse2[c / 2];
          float p0 = exp2_ftz(fmaf(acc[i], scale_log2, -ls.x));
          float p1 = exp2_ftz(fmaf(acc[i + 1], scale_log2, -ls.y));
          if (masked) {
            // a masked pair never weighs in (a fully masked query row's
            // lse is ~-1e30: its exponential is dropped here)
            const int kl = krow + 8 * ((i / 2) % 2);
            p0 = pair_valid(q0 + c, kl, Sq, Sk, q_offset, k_offset, causal,
                            window) ? p0 : 0.f;
            p1 = pair_valid(q0 + c + 1, kl, Sq, Sk, q_offset, k_offset,
                            causal, window) ? p1 : 0.f;
          }
          acc[i] = p0;
          acc[i + 1] = p1;
        }
        acc_to_tile<64, 64>(acc, 1.f, 1.f, Pt);
        consumers_barrier(kDpReady);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int c = 8 * (i / 4) + 2 * (lane % 4);
          const float2 de = dl[c / 2];
          acc[i] = acc[i] * (dPx[128 * i + t] - de.x) * scale;
          acc[i + 1] = acc[i + 1] * (dPx[128 * (i + 1) + t] - de.y) * scale;
        }
        acc_to_tile<64, 64>(acc, 1.f, 1.f, dSt);
        // the tiles' st.shared before the async proxy's wgmma reads
        fence_proxy_async();
        consumers_arrive(kDsReady);
      }

      // dV += P^T dO and dK += dS^T Q, A from the step's tiles, this
      // warpgroup's 128 columns of dO and Q MN-major from the ring
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_rows128<QROWS>(dv_acc, desc_k<64, 64>(pdesc, kk),
                                dodesc + half, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_rows128<QROWS>(dk_acc, desc_k<64, 64>(dsdesc, kk),
                                qdesc + half, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dk_acc);
      fence_operands(dv_acc);
      // both warpgroups' products are done with the step's tiles before
      // the next step writes them
      consumers_barrier(kStepDone);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    if (slot < 0) {
      // the k tile's only chunk: dK and dV through K's and V's rows (both
      // warpgroups read all of them, so neither overwrites them before
      // both are done); each warpgroup stores its column blocks (a W 128
      // tile) into its columns of each row, those below hd
      const size_t base = ((size_t)bkv * Sk + k0) * hd;
      consumers_barrier(3);
      uint8_t* Kh = Ks + 2 * wg * KROWS * L::atom;
      uint8_t* Vh = Vs + 2 * wg * KROWS * L::atom;
      acc_to_tile<N, KROWS>(dk_acc, 1.f, 1.f, Kh);
      acc_to_tile<N, KROWS>(dv_acc, 1.f, 1.f, Vh);
      wg_barrier(1 + wg);
      const int cols = min(N, hd - N * wg);  // hd > 128 at this width
      tile_to_rows<N, KROWS>(Kh, dk + base + N * wg, Sk - k0, cols, hd);
      tile_to_rows<N, KROWS>(Vh, dv + base + N * wg, Sk - k0, cols, hd);
    } else {
      // a split k tile: the f32 partials straight from the accumulators,
      // rows of D floats (columns past hd hold zeros), 8-byte pairs, a
      // quad's four one row's 32 bytes of an 8-column group
      float* pk = partials + (size_t)slot * 2 * KROWS * D;
      float* pv = pk + KROWS * D;
      const int r0 = 16 * (warp % 4) + lane / 4;
      const int c0 = N * wg + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (r0 + 8 * h) * D + c0 + 8 * j;
          *reinterpret_cast<float2*>(pk + off) =
              make_float2(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
          *reinterpret_cast<float2*>(pv + off) =
              make_float2(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(done);
  }
}

// The reduction of a plan's split k tiles: one CTA per (split k tile, dK
// or dV, 16 of its `krows` rows). Each thread sums 4 columns of a row
// over the tile's slots in chunk order (the f32 sum of `_dkv_kernel`'s
// accumulator, cut into chunks), casts once to T (bf16 as that kernel's
// one `astype` of its accumulator; f32 stays) and stores the columns
// below hd of the rows below Sk. A slot holds dK then dV, `krows` rows of
// D floats each: the width-256 bf16 body's 64 x 256, the f32 bodies'
// k tile rows x their width (flash_bwd_f32.cu). The order is fixed, so
// two runs give the same bits.
constexpr int REDUCE_ROWS = 16, REDUCE_THREADS = 256;

template <typename T, int D>
__global__ void __launch_bounds__(REDUCE_THREADS)
    flash_dkv_reduce_kernel(const float* __restrict__ partials,
                            const int* __restrict__ plan, T* __restrict__ dk,
                            T* __restrict__ dv, int Sk, int hd, int krows) {
  constexpr int PER = REDUCE_ROWS * D / 4 / REDUCE_THREADS;  // float4s
  const int* row = plan + PLAN_ROW * blockIdx.x;
  const int k0 = row[0] * krows, bkv = row[1], slot0 = row[2], n = row[3];
  const int part = blockIdx.y;  // 0: dK, 1: dV
  const int r0 = blockIdx.z * REDUCE_ROWS;
  const int rows = min(krows, Sk - k0);
  const size_t stride = (size_t)2 * krows * D;  // floats a slot
  const float* src = partials + (size_t)slot0 * stride +
                     (size_t)part * krows * D + (size_t)r0 * D;
  T* out = (part ? dv : dk) + ((size_t)bkv * Sk + k0 + r0) * hd;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + REDUCE_THREADS * i;
    const int r = idx / (D / 4), c = 4 * (idx % (D / 4));
    if (r0 + r >= rows || c >= hd) continue;
    float4 acc = *reinterpret_cast<const float4*>(src + r * D + c);
    for (int k = 1; k < n; ++k) {
      const float4 x =
          *reinterpret_cast<const float4*>(src + k * stride + r * D + c);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    if constexpr (std::is_same_v<T, float>) {
      *reinterpret_cast<float4*>(out + (size_t)r * hd + c) = acc;
    } else {
      uint2 packed;
      packed.x = pack_bf16(acc.x, acc.y);
      packed.y = pack_bf16(acc.z, acc.w);
      *reinterpret_cast<uint2*>(out + (size_t)r * hd + c) = packed;
    }
  }
}

cudaError_t launch_w256(const Args& a) {
  constexpr int D = 256, KROWS = Layout<D>::KROWS;
  // the plan's chunks, or one CTA a k tile where it splits none
  const int BKV = a.B * a.KVH;
  const int grid =
      a.plan != nullptr ? a.chunks : (a.Sk + KROWS - 1) / KROWS * BKV;
  if (grid <= 0) return cudaErrorInvalidValue;
  // with Sq == 0 no Q/dO tile is loaded; the maps still need an extent
  const void* qp = a.Sq > 0 ? a.q : a.k;
  const void* gp = a.Sq > 0 ? a.dout : a.k;
  const int qrows = a.Sq > 0 ? a.Sq : a.Sk;
  const int qslabs = a.Sq > 0 ? a.B * a.H : a.B * a.KVH;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_rows_map<D>(&tq, qp, a.hd, qrows, qslabs, QROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tdo, gp, a.hd, qrows, qslabs, QROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tk, a.k, a.hd, a.Sk, a.B * a.KVH, KROWS);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tv, a.v, a.hd, a.Sk, a.B * a.KVH, KROWS);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Layout<D>::bytes;
  err = allow_smem(flash_dkv_w256_kernel, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_w256_kernel<<<grid, kWideThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.plan, a.partials,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), BKV, a.H, a.KVH,
      a.Sq, a.Sk, a.hd, a.q_offset, a.k_offset, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

}  // namespace dkv

// ----------------------------------------- dQ bf16: wgmma over TMA tiles
namespace dq {

constexpr int QROWS = 128;          // query rows per CTA: 2 warpgroups x 64

// The body at width 64: two consumer warpgroups and one producer warp.
template <int D>
struct Layout {
  static_assert(D == 64, "widths 16 and 32 run flash_dq_narrow_kernel, 128 "
                         "and 256 flash_dq_pingpong_kernel (or "
                         "flash_dq_w256_kernel)");
  static constexpr int THREADS = 2 * 128 + 32;
  static constexpr int KROWS = 64;   // key rows per ring stage
  static constexpr int STAGES = 6;   // K/V tiles in flight
  // Q, dO (16 KB each at D 64), the K ring, the V ring (8 KB tiles at D
  // 64), then the barriers: qfull, full[STAGES], empty[STAGES]; +1024
  // for alignment: 129 KB
  static constexpr uint32_t row = Rows<D>::bytes;
  static constexpr uint32_t atom = Rows<D>::atom;
  static constexpr uint32_t Q_TILE = QROWS * row, KV_TILE = KROWS * row;
  static constexpr uint32_t q = 0, dout = Q_TILE, k = 2 * Q_TILE,
                            v = k + STAGES * KV_TILE,
                            bars = v + STAGES * KV_TILE;
  static constexpr size_t bytes = bars + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(bytes <= 232448, "at most 227 KB of shared memory");
};

template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int BH, int H, int KVH,
                          int Sq, int Sk, int hd, int q_offset,
                          int k_offset, int causal, int window,
                          float scale) {
  using L = Layout<D>;
  constexpr uint32_t Q_TILE = L::Q_TILE, KV_TILE = L::KV_TILE;
  constexpr int STAGES = L::STAGES, KROWS = L::KROWS;
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

  const int warp = (int)threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: Q and dO once, then the live K/V tiles through the
    // ring (rows past each head's length arrive as zeros)
    if (lane == 0) {
      mbar_expect_tx(qfull, 2 * Q_TILE);
      tma_load_tile<D, QROWS>(Qs, &tq, qfull, q0, bh);
      tma_load_tile<D, QROWS>(dOs, &tdo, qfull, q0, bh);
      int s = 0;
      uint32_t phase = 0;
      for (int kj = 0; kj < nk; ++kj) {
        const int k0 = kj * KROWS;
        if (!rows_meet(q0, q_last, k0, min(k0 + KROWS, Sk) - 1, q_offset,
                       k_offset, causal, window))
          continue;
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], 2 * KV_TILE);
        tma_load_tile<D, KROWS>(Ks + s * KV_TILE, &tk, &full[s], k0,
                                kv_row);
        tma_load_tile<D, KROWS>(Vs + s * KV_TILE, &tv, &full[s], k0,
                                kv_row);
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
    uint8_t* Qw = Qs + wg * 64 * L::atom;  // its rows in block 0
    const uint64_t qdesc = desc_sw<D>(Qw);
    const uint64_t dodesc = desc_sw<D>(dOs + wg * 64 * L::atom);
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
        // S = Q K^T and dP = dO V^T (64 queries x 64 keys each, D/16
        // k16 steps) as two groups, so P is formed while dP is still in
        // flight
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, desc_k<D, QROWS>(qdesc, kk),
                       desc_k<D, KROWS>(kdesc, kk), kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dpt, desc_k<D, QROWS>(dodesc, kk),
                       desc_k<D, KROWS>(vdesc, kk), kk);
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
          wgmma_rs_rows<D, KROWS>(dq_acc, dsa[kk], kdesc, kk);
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
    // product) to 16-byte stores of each row's first hd columns
    acc_to_tile<D, QROWS>(dq_acc, 1.f, 1.f, Qw);
    wg_barrier(1 + wg);
    tile_to_rows<D, QROWS>(Qw, dq + ((size_t)bh * Sq + wq0) * hd,
                           Sq - wq0, hd);
  }
}

// The CTA's q tile and head under the width-128 and -256 bodies' order:
// the heads in groups of `group` (common.cuh l2_group: their K and V fit
// in L2), each group's CTAs consecutive, and within a group the last q
// tiles (the most live K/V tiles under causal masking) first, the
// group's heads side by side at each q tile. (With `group` every head
// it is the narrower bodies' order: heaviest first over all heads.)
struct DqTile {
  int q0, bh;
};
__device__ __forceinline__ DqTile dq_tile(int block, int BH, int group,
                                          int nqt, int rows) {
  const int per = group * nqt;  // a whole group's CTAs
  const int g = block / per, r = block - g * per;
  const int gh = min(group, BH - g * group);  // heads in group g
  const int qi = r / gh;
  return {(nqt - 1 - qi) * rows, g * group + (r - qi * gh)};
}

// ------------------------------------- bf16 at width 128: ping-pong
// (see the note at the top): 12 warps, 128 query rows a CTA, 64-key K/V
// tiles through a 5-stage ring.
template <int D>
struct PingPong {
  // key rows per K/V tile: 64, or 32 at D 256 (dQ there is 128 f32 a
  // thread)
  static constexpr int KROWS = D == 256 ? 32 : 64;
  static constexpr int STAGES = D == 256 ? 3 : 5;   // K/V tiles in flight
  // the consumers' turns: named barrier TURN + w is warpgroup w's (1 and
  // 2 are wg_barrier's)
  static constexpr int TURN = 3;
  // Q, dO (32 KB each), the K ring, the V ring (16 KB tiles), then the
  // barriers: qfull, full[STAGES], empty[STAGES], done; +1024 for
  // alignment: 225 KB of the 227
  static constexpr uint32_t row = Rows<D>::bytes, atom = Rows<D>::atom;
  static constexpr uint32_t Q_TILE = QROWS * row, KV_TILE = KROWS * row;
  static constexpr uint32_t q = 0, dout = Q_TILE, k = 2 * Q_TILE,
                            v = k + STAGES * KV_TILE,
                            bars = v + STAGES * KV_TILE;
  static constexpr size_t bytes = bars + (2 + 2 * STAGES) * 8 + 1024;
  static_assert(bytes <= 232448, "at most 227 KB of shared memory");
};

template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_dq_pingpong_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int BH, int H, int KVH,
                             int Sq, int Sk, int hd, int q_offset,
                             int k_offset, int causal, int window,
                             float scale, int group) {
  using L = PingPong<D>;
  constexpr int STAGES = L::STAGES, KROWS = L::KROWS;
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
  uint64_t* done = empty + STAGES;

  const int nqt = (Sq + QROWS - 1) / QROWS;
  const DqTile x = dq_tile(blockIdx.x, BH, group, nqt, QROWS);
  const int q0 = x.q0, bh = x.bh;
  const int h = bh % H;
  const int kv_row = (bh / H) * KVH + h / (H / KVH);
  const int q_last = min(q0 + QROWS, Sq) - 1;
  const int nk = (Sk + KROWS - 1) / KROWS;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(done, 8);  // lane 0 of each consumer warp, at its end
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = warp_index(), lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ---- producer warpgroup: every warp gives its registers back
    // first; warp 9 is the CTA's watchdog; warp 8 loads Q and dO once,
    // then the live K/V tiles through the ring (rows past each head's
    // length arrive as zeros)
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 9) {
      cta_watchdog(done);
    } else if (warp == 8 && lane == 0) {
      mbar_expect_tx(qfull, 2 * Q_TILE);
      tma_load_tile<D, QROWS>(Qs, &tq, qfull, q0, bh);
      tma_load_tile<D, QROWS>(dOs, &tdo, qfull, q0, bh);
      int s = 0;
      uint32_t phase = 0;
      for (int kj = 0; kj < nk; ++kj) {
        const int k0 = kj * KROWS;
        if (!rows_meet(q0, q_last, k0, min(k0 + KROWS, Sk) - 1, q_offset,
                       k_offset, causal, window))
          continue;
        mbar_wait_spin(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], 2 * KV_TILE);
        tma_load_tile<D, KROWS>(Ks + s * KV_TILE, &tk, &full[s], k0,
                                kv_row);
        tma_load_tile<D, KROWS>(Vs + s * KV_TILE, &tv, &full[s], k0,
                                kv_row);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows wq0 .. wq0 + 63 at the
    // whole head dim
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int wq0 = q0 + 64 * wg;
    const int qrow = wq0 + 16 * (warp % 4) + lane / 4;  // and qrow + 8
    uint8_t* Qw = Qs + wg * 64 * L::atom;  // its rows in block 0
    const uint64_t qdesc = desc_sw<D>(Qw);
    const uint64_t dodesc = desc_sw<D>(dOs + wg * 64 * L::atom);
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
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // dS of the tile before, packed as the A fragments of its dQ
    // product, which the next turn issues on the K tile at stage `prev`.
    // Every product is issued unconditionally: a product left in flight
    // where two paths meet lets ptxas move its accumulator registers,
    // and it then serializes every wgmma (C7515). So the first turn
    // issues a dQ product of zeros (dS 0 on this tile's K: it adds
    // exactly 0), and a warpgroup whose rows meet no key of a tile (or
    // lie past Sq) computes its S and dP all the same, every pair masked.
    uint32_t dsa[KROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KROWS / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) dsa[kk][j] = 0u;
    int prev = -1;
    // Turns as in flash_fwd.cu's ping-pong body: a warpgroup issues its
    // products only between its consumers_barrier(TURN + wg) and its
    // consumers_arrive on the other's, so the tensor cores run one
    // warpgroup's products while the other forms P and dS. Both take a
    // turn on each live K/V tile of the CTA and one more for the last dQ
    // product; warpgroup 0 goes first, on warpgroup 1's opening arrive,
    // and takes that of warpgroup 1's last turn at the very end.
    if (wg == 1) consumers_arrive(L::TURN);
    mbar_wait_spin(qfull, 0);
    int s = 0;
    uint32_t phase = 0;
    for (int kj = 0; kj < nk; ++kj) {
      const int k0 = kj * KROWS;
      const int k_last = min(k0 + KROWS, Sk) - 1;
      if (!rows_meet(q0, q_last, k0, k_last, q_offset, k_offset, causal,
                     window))
        continue;
      mbar_wait_spin(&full[s], phase);
      const uint64_t kdesc = desc_sw<D>(Ks + s * KV_TILE);
      const uint64_t vdesc = desc_sw<D>(Vs + s * KV_TILE);
      const uint64_t pdesc = desc_sw<D>(Ks + (prev < 0 ? s : prev) * KV_TILE);
      // one turn: S = Q K^T and dP = dO V^T of this tile (64 queries x
      // 64 keys, 8 k16 steps each), then dQ += dS K of the tile before;
      // three groups, so P is formed while dP and that dQ are in flight
      // and dS while the dQ is
      float st[KROWS / 2], dpt[KROWS / 2];
      consumers_barrier(L::TURN + wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KROWS>(st, desc_k<D, QROWS>(qdesc, kk),
                        desc_k<D, KROWS>(kdesc, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KROWS>(dpt, desc_k<D, QROWS>(dodesc, kk),
                        desc_k<D, KROWS>(vdesc, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < KROWS / 16; ++kk)
        wgmma_rs_rows<D, KROWS>(dq_acc, dsa[kk], pdesc, kk);
      wgmma_commit();
      consumers_arrive(L::TURN + (wg ^ 1));

      // P = exp2(S*scale*log2(e) - lse*log2(e)) in place of S, as the
      // narrower bodies
      wgmma_wait<2>();
      fence_operands(st);
      const bool masked =
          wq0 + 64 > Sq || k0 + KROWS > Sk ||
          !rows_all_valid(wq0, wq0 + 63, k0, k0 + KROWS - 1, q_offset,
                          k_offset, causal, window);
#pragma unroll
      for (int i = 0; i < KROWS / 2; ++i) {
        const int r = (i / 2) % 2;
        float p = exp2_ftz(fmaf(st[i], scale_log2, -lse2[r]));
        if (masked) {
          const int kl = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          p = pair_valid(qrow + 8 * r, kl, Sq, Sk, q_offset, k_offset,
                         causal, window) ? p : 0.f;
        }
        st[i] = p;
      }
      // dS = P (dP - delta) scale in place of P
      wgmma_wait<1>();
      fence_operands(dpt);
#pragma unroll
      for (int i = 0; i < KROWS / 2; ++i)
        st[i] = st[i] * (dpt[i] - dl[(i / 2) % 2]) * scale;
      wgmma_wait<0>();
      fence_operands(dq_acc);
      fence_operands(dsa);
      // the tile before is done with (its K read by the dQ product just
      // waited on); dS packed to bf16 (the TPU kernel's
      // ds.astype(k.dtype)) into the A fragments of this tile's dQ
      // product, issued next turn
      if (prev >= 0) release(&empty[prev]);
#pragma unroll
      for (int kk = 0; kk < KROWS / 16; ++kk) pack_a(st, kk, dsa[kk]);
      prev = s;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    // the last dQ product, in a turn of its own (a CTA with no live tile
    // issues none: no stage holds a K tile)
    consumers_barrier(L::TURN + wg);
    if (prev >= 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KROWS / 16; ++kk)
        wgmma_rs_rows<D, KROWS>(dq_acc, dsa[kk],
                                desc_sw<D>(Ks + prev * KV_TILE), kk);
      wgmma_commit();
      consumers_arrive(L::TURN + (wg ^ 1));
      wgmma_wait<0>();
      fence_operands(dq_acc);
      release(&empty[prev]);
    } else {
      consumers_arrive(L::TURN + (wg ^ 1));
    }
    if (wg == 0) consumers_barrier(L::TURN);
    // dQ through this warpgroup's Q rows (read by nothing after its last
    // S) to 16-byte stores of each row's first hd columns
    acc_to_tile<D, QROWS>(dq_acc, 1.f, 1.f, Qw);
    wg_barrier(1 + wg);
    tile_to_rows<D, QROWS>(Qw, dq + ((size_t)bh * Sq + wq0) * hd,
                           Sq - wq0, hd);
    release(done);
  }
}

// ------------------------------------------ bf16 at width 256: split
// (see the note at the top): 12 warps, 64 query rows a CTA, dQ's columns
// split over the two consumer warpgroups, Q and dO held in registers;
// where 128-row q tiles fill at most one wave of the SMs.
struct Split256 {
  static constexpr int D = 256;
  static constexpr int QR = 64;      // query rows a CTA
  static constexpr int KROWS = 64;   // key rows per K/V tile
  static constexpr int STAGES = 3;   // slots of the K ring and the V ring
  // the K ring, the V ring (32 KB slots; slot 0 first takes Q and dO),
  // dP in f32 (16 KB), dS in bf16 (8 KB), then the barriers:
  // kfull[STAGES], vfull[STAGES], kempty[STAGES], vempty[STAGES], done;
  // +1024 for alignment: 217 KB
  static constexpr uint32_t row = Rows<D>::bytes, atom = Rows<D>::atom;
  static constexpr uint32_t KV_TILE = KROWS * row;
  static_assert(QR * row == KV_TILE, "Q and dO fill a ring slot each");
  static constexpr uint32_t k = 0, v = STAGES * KV_TILE,
                            dpx = v + STAGES * KV_TILE,
                            ds = dpx + QR * KROWS * 4,
                            bars = ds + QR * KROWS * 2;
  static constexpr size_t bytes = bars + (1 + 4 * STAGES) * 8 + 1024;
  static_assert(bytes <= 232448, "at most 227 KB of shared memory");
};

// The split body's named barriers between its consumer warpgroups (1 and
// 2 are wg_barrier's): dP handed over, dS stored.
constexpr int kDpReady = 4, kDsReady = 5;

__global__ void __launch_bounds__(kWideThreads, 1)
    flash_dq_w256_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int BH, int H, int KVH,
                         int Sq, int Sk, int hd, int q_offset, int k_offset,
                         int causal, int window, float scale, int group) {
  using L = Split256;
  constexpr int D = L::D, QR = L::QR, KROWS = L::KROWS, STAGES = L::STAGES;
  constexpr uint32_t KV_TILE = L::KV_TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Ks = sm + L::k;
  uint8_t* Vs = sm + L::v;
  float* dPx = reinterpret_cast<float*>(sm + L::dpx);
  uint8_t* dSt = sm + L::ds;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* vfull = kfull + STAGES;
  uint64_t* kempty = vfull + STAGES;
  uint64_t* vempty = kempty + STAGES;
  uint64_t* done = vempty + STAGES;

  const int nqt = (Sq + QR - 1) / QR;
  const DqTile x = dq_tile(blockIdx.x, BH, group, nqt, QR);
  const int q0 = x.q0, bh = x.bh;
  const int h = bh % H;
  const int kv_row = (bh / H) * KVH + h / (H / KVH);
  const int q_last = min(q0 + QR, Sq) - 1;
  const int nk = (Sk + KROWS - 1) / KROWS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], 8);  // lane 0 of each consumer warp
      mbar_init(&vempty[s], 4);  // lane 0 of each warp of warpgroup 1
    }
    mbar_init(done, 8);  // lane 0 of each consumer warp, at its end
    fence_barrier_init();
  }
  __syncthreads();

  // The rings' uses: use 0 of slot 0 holds Q (K ring) and dO (V ring),
  // which the consumers read into registers and release; the live K/V
  // tile j is use j + 1, in slot (j + 1) % STAGES.
  const int warp = warp_index(), lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ---- producer warpgroup: every warp gives its registers back first;
    // warp 9 is the CTA's watchdog; warp 8 loads Q and dO, then for each
    // live tile V and K into their rings (V is released after its dP, K
    // after both dQ products)
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 9) {
      cta_watchdog(done);
    } else if (warp == 8 && lane == 0) {
      mbar_expect_tx(&kfull[0], KV_TILE);
      tma_load_tile<D, QR>(Ks, &tq, &kfull[0], q0, bh);
      mbar_expect_tx(&vfull[0], KV_TILE);
      tma_load_tile<D, QR>(Vs, &tdo, &vfull[0], q0, bh);
      int s = 1;
      uint32_t phase = 0;
      for (int kj = 0; kj < nk; ++kj) {
        const int k0 = kj * KROWS;
        if (!rows_meet(q0, q_last, k0, min(k0 + KROWS, Sk) - 1, q_offset,
                       k_offset, causal, window))
          continue;
        mbar_wait_spin(&vempty[s], phase ^ 1);
        mbar_expect_tx(&vfull[s], KV_TILE);
        tma_load_tile<D, KROWS>(Vs + s * KV_TILE, &tv, &vfull[s], k0,
                                kv_row);
        mbar_wait_spin(&kempty[s], phase ^ 1);
        mbar_expect_tx(&kfull[s], KV_TILE);
        tma_load_tile<D, KROWS>(Ks + s * KV_TILE, &tk, &kfull[s], k0,
                                kv_row);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: the CTA's 64 query rows, dQ at columns 128wg ..
    // 128wg + 127. Warpgroup 0 holds Q and warpgroup 1 dO as register A
    // fragments. Per tile warpgroup 0 computes S = Q K^T and warpgroup 1
    // dP = dO V^T (64 queries x 64 keys each, 16 k16 steps, B from the
    // ring); warpgroup 1 hands dP over in f32 through shared memory,
    // warpgroup 0 forms P and dS and stores dS as a bf16 tile, and both
    // read it as the A operand of their dQ products. Warpgroup 1 issues
    // the next tile's dP before it waits for the dS, so the tensor cores
    // run that dP while warpgroup 0 forms dS. No product is left in
    // flight where two paths meet (ptxas would then serialize every
    // wgmma, C7515): each iteration waits on all its products, and after
    // the last tile warpgroup 1 issues its look-ahead dP on that tile's V
    // all the same (the producer loads nothing more, so the slot still
    // holds it) and drops the result.
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int t = threadIdx.x % 128;
    const int qrow = q0 + 16 * (warp % 4) + lane / 4;  // and qrow + 8
    // dS as the K-major A operand: 64 rows (queries) of 64 keys, the
    // 128-byte swizzle of a W 64 tile
    const uint64_t dsdesc = desc_sw<64>(dSt);
    // the first of this warpgroup's column blocks (2wg) of a K tile, as
    // an offset of its descriptor: blocks 2wg and 2wg + 1 are a W 128
    // tile of KROWS rows
    const uint64_t half = (2 * wg * KROWS * L::atom) >> 4;
    float dq_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;
    float acc[32];
    // Q (warpgroup 0) or dO (warpgroup 1), one A fragment a k16 step
    uint32_t frag[D / 16][4];
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // this warpgroup's dQ += dS K over its 128 columns of the K tile in
    // slot s, waited on with every product before it: the slot's K and
    // the dS tile are then free of this warpgroup's reads
    auto dq_step = [&](int s) {
      const uint64_t kdesc = desc_sw<D>(Ks + s * KV_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_rows128<KROWS>(dq_acc, desc_k<64, 64>(dsdesc, kk),
                                kdesc + half, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dq_acc);
      fence_operands(acc);
      release(&kempty[s]);
    };
    // S = Q K^T (warpgroup 0, the K tile in slot s) or dP = dO V^T
    // (warpgroup 1, the V tile), into acc, left in flight
    auto issue_scores = [&](const uint8_t* ring, int s) {
      const uint64_t bdesc = desc_sw<D>(ring + s * KV_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs_n64(acc, frag[kk], desc_k<D, KROWS>(bdesc, kk), kk);
      wgmma_commit();
    };
    // the live tiles from kj on: the next one's index, nk past the last
    auto next_live = [&](int kj) {
      for (; kj < nk; ++kj) {
        const int k0 = kj * KROWS;
        if (rows_meet(q0, q_last, k0, min(k0 + KROWS, Sk) - 1, q_offset,
                      k_offset, causal, window))
          break;
      }
      return kj;
    };
    // use 0: this warpgroup's operand rows into registers; slot 0 of
    // both rings is then free of its reads
    mbar_wait_spin(wg ? &vfull[0] : &kfull[0], 0);
    tile_to_frags<D, QR>(wg ? Vs : Ks, frag);
    release(&kempty[0]);
    if (wg == 1) release(&vempty[0]);
    int s = 1;
    uint32_t phase = 0;
    if (wg == 0) {
      // this thread's two rows' lse * log2(e) and delta (0 past Sq)
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qrow + 8 * r;
        const bool in = row < Sq;
        lse2[r] = in ? lse[(size_t)bh * Sq + row] * kLog2e : 0.f;
        dl[r] = in ? delta[(size_t)bh * Sq + row] : 0.f;
      }
      const float scale_log2 = scale * kLog2e;
      for (int kj = next_live(0); kj < nk; kj = next_live(kj + 1)) {
        const int k0 = kj * KROWS;
        mbar_wait_spin(&kfull[s], phase);
        issue_scores(Ks, s);
        wgmma_wait<0>();
        fence_operands(acc);
        // P = exp2(S*scale*log2(e) - lse*log2(e)) in place of S, as the
        // narrower bodies
        const bool masked =
            q0 + QR > Sq || k0 + KROWS > Sk ||
            !rows_all_valid(q0, q0 + QR - 1, k0, k0 + KROWS - 1, q_offset,
                            k_offset, causal, window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i / 2) % 2;
          float p = exp2_ftz(fmaf(acc[i], scale_log2, -lse2[r]));
          if (masked) {
            const int kl = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
            p = pair_valid(qrow + 8 * r, kl, Sq, Sk, q_offset, k_offset,
                           causal, window) ? p : 0.f;
          }
          acc[i] = p;
        }
        // dS = P (dP - delta) scale, dP from warpgroup 1 (element i of
        // thread t at 128 i + t, the same accumulator layout), packed to
        // bf16 (the TPU kernel's ds.astype(k.dtype)) into the dS tile
        consumers_barrier(kDpReady);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[i] = acc[i] * (dPx[128 * i + t] - dl[(i / 2) % 2]) * scale;
        acc_to_tile<64, 64>(acc, 1.f, 1.f, dSt);
        // the tile's st.shared before the async proxy's wgmma reads, by
        // warpgroup 1's after the barrier and by this warpgroup's own
        // after all its threads have stored their rows
        fence_proxy_async();
        consumers_arrive(kDsReady);
        wg_barrier(1);
        dq_step(s);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    } else {
      int kj = next_live(0);
      if (kj < nk) {
        mbar_wait_spin(&vfull[s], phase);
        issue_scores(Vs, s);
        wgmma_wait<0>();
        fence_operands(acc);
        release(&vempty[s]);
      }
      while (kj < nk) {
        // this tile's dP (in acc) to warpgroup 0: dPx is free, warpgroup
        // 0 having read the last one before it stored that tile's dS
#pragma unroll
        for (int i = 0; i < 32; ++i) dPx[128 * i + t] = acc[i];
        consumers_arrive(kDpReady);
        // the next live tile's dP, or after the last one this tile's
        // again, runs while warpgroup 0 forms dS; its V slot is free once
        // it is done
        const int nkj = next_live(kj + 1);
        const int ns = s + 1 == STAGES ? 0 : s + 1;
        const uint32_t nphase = s + 1 == STAGES ? phase ^ 1 : phase;
        if (nkj < nk) mbar_wait_spin(&vfull[ns], nphase);
        issue_scores(Vs, nkj < nk ? ns : s);
        // this tile's K has landed (warpgroup 0 waited on it too) and dS
        // is stored
        mbar_wait_spin(&kfull[s], phase);
        consumers_barrier(kDsReady);
        dq_step(s);
        if (nkj < nk) release(&vempty[ns]);
        s = ns;
        phase = nphase;
        kj = nkj;
      }
    }
    // dQ through the dS tile and dP's staging (read by nothing after the
    // last dQ products, which both warpgroups have waited on): warpgroup
    // 1 stores its column blocks (a W 128 tile, 16 KB) through dP's
    // staging, warpgroup 0 through slot 0 of the V ring (no load is in
    // flight: every tile has been waited on), then each into its columns
    // of each row, those below hd
    consumers_barrier(3);
    uint8_t* stage = wg ? reinterpret_cast<uint8_t*>(dPx) : Vs;
    acc_to_tile<128, QR>(dq_acc, 1.f, 1.f, stage);
    wg_barrier(1 + wg);
    const int cols = min(128, hd - 128 * wg);  // hd > 128 at this width
    tile_to_rows<128, QR>(stage, dq + ((size_t)bh * Sq + q0) * hd + 128 * wg,
                          Sq - q0, cols, hd);
    release(done);
  }
}

template <int D>
cudaError_t launch(const Args& a) {
  // with Sk == 0 no K/V tile is loaded; the maps still need an extent
  const void* kp = a.Sk > 0 ? a.k : a.q;
  const void* vp = a.Sk > 0 ? a.v : a.q;
  const int krows = a.Sk > 0 ? a.Sk : a.Sq;
  const int kslabs = a.Sk > 0 ? a.B * a.KVH : a.B * a.H;
  const int BH = a.B * a.H;
  // The body at width 256 goes by shape, as the width-256 forward's
  // schedule: where 128-row q tiles fill at most one wave of the SMs
  // (Gemma-2B's fit, B 2 x 8 heads x S 1024: 128) the split body, whose
  // 64-row q tiles halve the longest walk; else the ping-pong body, whose
  // 128-row q tiles read each K/V tile once for twice the rows.
  bool split = false;
  if constexpr (D == 256) {
    int sms = 0;
    const cudaError_t e = multiprocessors(&sms);
    if (e != cudaSuccess) return e;
    split = (a.Sq + QROWS - 1) / QROWS * BH <= sms;
  }
  // the Q/dO box: a CTA's query rows; the K/V box: a tile's key rows
  int QR = QROWS, KR = 64;
  if constexpr (D >= 128) KR = PingPong<D>::KROWS;
  if (split) {
    QR = Split256::QR;
    KR = Split256::KROWS;
  }
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_rows_map<D>(&tq, a.q, a.hd, a.Sq, a.B * a.H, QR);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tdo, a.dout, a.hd, a.Sq, a.B * a.H, QR);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tk, kp, a.hd, krows, kslabs, KR);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tv, vp, a.hd, krows, kslabs, KR);
  if (err != cudaSuccess) return err;
  const int grid = (a.Sq + QR - 1) / QR * BH;
  // the wide bodies' order: heads in groups whose K and V (Sk rows of 2
  // * hd bytes each) fit in L2, of equal size (a last group of few heads
  // would leave their heaviest q tiles to end the launch alone)
  const int fit = l2_group(4ll * a.hd * a.Sk, BH);
  const int groups = (BH + fit - 1) / fit;
  const int group = (BH + groups - 1) / groups;
  auto run = [&](auto kernel, size_t smem, int threads, auto... extra) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, threads, smem, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), BH, a.H,
        a.KVH, a.Sq, a.Sk, a.hd, a.q_offset, a.k_offset, a.causal,
        a.window, a.scale, extra...);
    return cudaGetLastError();
  };
  if (split)
    return run(flash_dq_w256_kernel, Split256::bytes, kWideThreads, group);
  if constexpr (D >= 128)
    return run(flash_dq_pingpong_kernel<D>, PingPong<D>::bytes,
               kWideThreads, group);
  else
    return run(flash_dq_wgmma_kernel<D>, Layout<D>::bytes,
               Layout<D>::THREADS);
}

}  // namespace dq

// ------------------------------------------- bf16 at widths 16 and 32
// (see the note at the top): 16 warps, a producer warpgroup at 32
// registers and three consumer warpgroups of 64 rows at 160. A CTA owns a
// tile of 192 query rows (dQ) or key rows (dK/dV), resident in a slot of
// shared memory, and the 64-row K/V (dQ) or Q/dO (dK/dV) tiles it meets
// stream past it through a ring; each warpgroup walks its own run of
// them.
namespace nb {

constexpr int WG = 3;                    // consumer warpgroups
constexpr int TILE = 64 * WG;            // a CTA's rows: 192
constexpr int STEP = 64;                 // rows of a streamed tile
constexpr int THREADS = 128 * (WG + 1);  // and a producer warpgroup
constexpr int STAGES = 8;                // streamed tiles in flight
constexpr int SLOTS = 2;                 // CTA tiles: this one and the next
// 512 threads launch at 128 registers each; the producer warpgroup drops
// to 32 and the three consumer warpgroups rise to 160
constexpr uint32_t kProducerRegs = 32, kConsumerRegs = 160;
static_assert(128 * kProducerRegs + 128 * WG * kConsumerRegs <=
                  128 * THREADS,
              "the consumers ask for no more than the producer frees");

// The slots' two tiles (dK/dV: K and V; dQ: Q and dO; 192 rows each),
// the ring's two (dK/dV: Q and dO; dQ: K and V; 64 rows each), the
// lse/delta ring beside it (dK/dV: 64 + 64 f32 a stage), then the
// barriers: sfull[SLOTS], sempty[SLOTS], full[STAGES], empty[STAGES],
// done; +1024 for alignment: 117 KB at W 32, 61 KB at 16.
template <int D>
struct Layout {
  static constexpr uint32_t row = Rows<D>::bytes, atom = Rows<D>::atom;
  static constexpr uint32_t big = TILE * row, small = STEP * row;
  static constexpr uint32_t a = 0, b = SLOTS * big, c = 2 * SLOTS * big,
                            d = c + STAGES * small, stats = d + STAGES * small,
                            bars = stats + STAGES * 2 * STEP * 4;
  static constexpr uint32_t sfull = bars, sempty = sfull + 8 * SLOTS,
                            full = sempty + 8 * SLOTS,
                            empty = full + 8 * STAGES,
                            done = empty + 8 * STAGES;
  static constexpr size_t bytes = done + 8 + 1024;
  static_assert(bytes <= 232448, "at most 227 KB of shared memory");
};

// The live 64-key tiles of query rows [q_lo, q_hi] (those rows_meet
// admits): one run kj0 .. kj0 + n - 1; returns n. The causal rule drops
// tiles from the end, the window's from the start; a ragged last tile's
// last key is Sk - 1 (flash_fwd.cu's live_tiles, at 64 keys).
__host__ __device__ __forceinline__ int live_k_tiles(int q_lo, int q_hi,
                                                     int Sk, int q_offset,
                                                     int k_offset,
                                                     int causal, int window,
                                                     int& kj0) {
  const int nk = (Sk + STEP - 1) / STEP;
  int hi = nk - 1, lo = 0;
  if (causal) {
    const int a = q_offset + q_hi - k_offset;  // the last key allowed
    const int t = a < 0 ? -1 : (int)((unsigned)a / STEP);
    hi = t < hi ? t : hi;
  }
  if (window > 0) {
    const int b = q_offset + q_lo - window - k_offset;  // keys <= b out
    lo = b + 1 <= 0 ? 0 : (int)((unsigned)(b + 1) / STEP);
    if (Sk - 1 <= b && nk - 2 < hi) hi = nk - 2;
  }
  kj0 = lo;
  return hi - lo + 1 > 0 ? hi - lo + 1 : 0;
}

// The live 64-row q tiles of key rows [k_lo, k_hi]: one run qi0 .. qi0 +
// n - 1; returns n. The causal rule drops tiles from the start (a ragged
// last tile's last row is Sq - 1), the window's from the end.
__host__ __device__ __forceinline__ int live_q_tiles(int k_lo, int k_hi,
                                                     int Sq, int q_offset,
                                                     int k_offset,
                                                     int causal, int window,
                                                     int& qi0) {
  const int nq = (Sq + STEP - 1) / STEP;
  int hi = nq - 1, lo = 0;
  if (causal) {
    const int a = k_offset + k_lo - q_offset;  // the first query allowed
    if (a > Sq - 1)
      hi = -1;
    else
      lo = a <= 0 ? 0 : (int)((unsigned)a / STEP);
  }
  if (window > 0) {
    // queries below b see key k_hi: a tile's first row must be
    const int b = k_offset + k_hi + window - q_offset;
    const int t = b <= 0 ? -1 : (int)((unsigned)(b - 1) / STEP);
    hi = t < hi ? t : hi;
  }
  qi0 = lo;
  return hi - lo + 1 > 0 ? hi - lo + 1 : 0;
}

// A CTA tile: the head (dQ) or kv row (dK/dV) and its first row, -1 for
// none.
struct Item {
  int row, t0;
};

// Half `half` of work item w over `rows` heads of nt tiles each. A
// head's tiles go by rank, heaviest first: the full tiles in order, from
// the last under LAST_FIRST (dQ: later query rows meet more keys under
// causal masking) or from the first (dK/dV: earlier keys meet more
// queries), and a ragged last tile, whose fewer rows make it lighter, at
// rank `ragged` (ragged_rank). With `halves` 2 item w pairs rank p = w /
// rows with rank nt - 1 - p, so items hold about equal work and dealt
// round-robin to the CTAs balance (an odd middle tile has no partner);
// with `halves` 1 an item is the tile of rank p, heaviest first.
template <bool LAST_FIRST>
__device__ __forceinline__ Item item(int w, int half, int rows, int nt,
                                     int ragged) {
  const unsigned p = (unsigned)w / (unsigned)rows;
  const int rank = half ? nt - 1 - (int)p : (int)p;
  int t;
  if (LAST_FIRST)
    t = rank == ragged ? nt - 1 : rank < ragged ? nt - 2 - rank
                                                : nt - 1 - rank;
  else
    t = rank == ragged ? nt - 1 : rank < ragged ? rank : rank - 1;
  return {w - (int)p * rows, half && rank == (int)p ? -1 : t * TILE};
}

// The work of the CTA tile at t0: each warpgroup's rows times the
// streamed tiles they meet.
template <bool DQ>
inline long long tile_weight(int t0, int Sq, int Sk, int q_offset,
                             int k_offset, int causal, int window) {
  const int n = DQ ? Sq : Sk;
  long long w = 0;
  for (int g = 0; g < WG && t0 + 64 * g < n; ++g) {
    const int lo = t0 + 64 * g, hi = std::min(lo + 63, n - 1);
    int first;
    w += (long long)(hi - lo + 1) *
         (DQ ? live_k_tiles(lo, hi, Sk, q_offset, k_offset, causal, window,
                            first)
             : live_q_tiles(lo, hi, Sq, q_offset, k_offset, causal, window,
                            first));
  }
  return w;
}

// The rank of a head's ragged last tile (fewer than 192 rows) among its
// tiles, heaviest first: the number of full tiles that outweigh it (with
// every tile full, the rank that leaves the last tile in its place).
template <bool DQ>
inline int ragged_rank(int Sq, int Sk, int q_offset, int k_offset,
                       int causal, int window) {
  const int n = DQ ? Sq : Sk;
  const int nt = (n + TILE - 1) / TILE, last = (nt - 1) * TILE;
  if (n - last == TILE) return DQ ? 0 : nt - 1;
  const long long w = tile_weight<DQ>(last, Sq, Sk, q_offset, k_offset,
                                      causal, window);
  int rank = 0;
  for (int t = 0; t < nt - 1; ++t)
    rank += tile_weight<DQ>(t * TILE, Sq, Sk, q_offset, k_offset, causal,
                            window) > w;
  return rank;
}

// P's mask on a tile that may hold a masked pair, as 0 in place of the
// exponential (a fully masked query row's lse is ~-1e30: its exponential
// is dropped here). Each accumulator row's valid columns are one run, so
// an element costs two compares against its row's bounds, taken relative
// to this thread's first column. dQ: rows are queries qrow and qrow + 8,
// columns keys from k0.
template <int N>
__device__ __forceinline__ void zero_keys(float (&p)[N], int qrow, int k0,
                                          int Sq, int Sk, int q_offset,
                                          int k_offset, int causal,
                                          int window) {
  constexpr int kOpen = 1 << 30;
  const int c0 = k0 + 2 * (threadIdx.x % 4);  // this thread's first key
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qk = q_offset + qrow + 8 * r - k_offset - c0;  // diagonal
    hi[r] = qrow + 8 * r < Sq ? min(Sk - 1 - c0, causal ? qk : kOpen)
                              : -kOpen;
    lo[r] = window > 0 ? qk - window + 1 : -kOpen;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 8 * (i / 4) + i % 2, r = (i / 2) % 2;
    if (c < lo[r] || c > hi[r]) p[i] = 0.f;
  }
}

// The same for dK/dV: rows are keys krow and krow + 8, columns queries
// from q0.
template <int N>
__device__ __forceinline__ void zero_queries(float (&p)[N], int krow, int q0,
                                             int Sq, int Sk, int q_offset,
                                             int k_offset, int causal,
                                             int window) {
  constexpr int kOpen = 1 << 30;
  const int c0 = q0 + 2 * (threadIdx.x % 4);  // this thread's first query
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kq = k_offset + krow + 8 * r - q_offset - c0;  // diagonal
    lo[r] = causal ? kq : -kOpen;
    hi[r] = krow + 8 * r < Sk
                ? min(Sq - 1 - c0, window > 0 ? kq + window - 1 : kOpen)
                : -kOpen;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 8 * (i / 4) + i % 2, r = (i / 2) % 2;
    if (c < lo[r] || c > hi[r]) p[i] = 0.f;
  }
}

// dK/dV at widths 16 and 32: one CTA a 192-row k tile of a kv row (`halves`
// 1) or persistent over pairs of them (`halves` 2), `items` work items as
// item<false> deals them. Warpgroup wg owns key rows 64wg .. 64wg + 63 of
// the tile at the whole head dim.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dkv_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int BKV, int grp, int Sq, int Sk, int hd,
                            int q_offset, int k_offset, int causal,
                            int window, float scale, int items, int halves,
                            int ragged) {
  static_assert(D == 16 || D == 32, "the narrow bodies are 16 or 32 wide");
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  uint8_t* Ks = sm + L::a;
  uint8_t* Vs = sm + L::b;
  uint8_t* Qs = sm + L::c;
  uint8_t* dOs = sm + L::d;
  const float* stats = reinterpret_cast<const float*>(sm + L::stats);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sm + L::sfull);
  uint64_t* kvempty = reinterpret_cast<uint64_t*>(sm + L::sempty);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(sm + L::empty);
  uint64_t* done = reinterpret_cast<uint64_t*>(sm + L::done);
  const int nt = (Sk + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    // lane 0 of each consumer warp arrives at the empty barriers
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&kvfull[s], 1);
      mbar_init(&kvempty[s], 4 * WG);
    }
    for (int s = 0; s < STAGES; ++s) {
      // the loader's lanes, each once its lse and delta have landed, and
      // lane 0's expect_tx
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], 4 * WG);
    }
    mbar_init(done, 4 * WG);  // each consumer warp, at its end
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = warp_index(), lane = threadIdx.x % 32;
  if (warp >= 4 * WG) {
    // ---- producer warpgroup: every warp gives its registers back first;
    // its second warp is the CTA's watchdog; the first loads, for each
    // step (a query head of the group and a live q tile of the k tile),
    // Q and dO by TMA (lane 0) and the rows' lse and delta by its lanes'
    // cp.async (0 past Sq: those rows are masked); lane 0 of the third
    // loads each k tile's K and V into its slot
    setmaxnreg_dec<kProducerRegs>();
    const int role = warp - 4 * WG;
    if (role == 1) {
      cta_watchdog(done);
    } else if (role == 0) {
      int r = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        for (int half = 0; half < halves; ++half) {
          const Item x = item<false>(w, half, BKV, nt, ragged);
          if (x.t0 < 0) continue;
          int qi0;
          const int n = live_q_tiles(x.t0, min(x.t0 + TILE, Sk) - 1, Sq,
                                     q_offset, k_offset, causal, window,
                                     qi0);
          for (int g = 0; g < grp; ++g) {
            const int bh = x.row * grp + g;
            for (int j = 0; j < n; ++j, ++r) {
              const int s = r % STAGES, q0 = (qi0 + j) * STEP;
              const uint32_t fb = base + L::full + 8 * s;
              mbar_wait_spin(base + L::empty + 8 * s,
                             ((r / STAGES) & 1) ^ 1);
              const uint32_t st = base + L::stats + s * 2 * STEP * 4;
#pragma unroll
              for (int h = 0; h < STEP / 32; ++h) {
                const int i = lane + 32 * h;
                const bool in = q0 + i < Sq;
                const size_t at = (size_t)bh * Sq + (in ? q0 + i : 0);
                cp_async_4(st + 4 * i, lse + at, in);
                cp_async_4(st + 4 * (STEP + i), delta + at, in);
              }
              if (lane == 0) {
                mbar_expect_tx(fb, 2 * L::small);
                tma_load_tile<D, STEP>(base + L::c + s * L::small, &tq, fb,
                                       q0, bh);
                tma_load_tile<D, STEP>(base + L::d + s * L::small, &tdo, fb,
                                       q0, bh);
              }
              cp_async_mbar_arrive(fb);
            }
          }
        }
      }
    } else if (role == 2 && lane == 0) {
      int r = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        for (int half = 0; half < halves; ++half) {
          const Item x = item<false>(w, half, BKV, nt, ragged);
          if (x.t0 < 0) continue;
          const int s = r % SLOTS;
          const uint32_t fb = base + L::sfull + 8 * s;
          mbar_wait_spin(base + L::sempty + 8 * s, ((r / SLOTS) & 1) ^ 1);
          mbar_expect_tx(fb, 2 * L::big);
          tma_load_tile<D, TILE>(base + L::a + s * L::big, &tk, fb, x.t0,
                                 x.row);
          tma_load_tile<D, TILE>(base + L::b + s * L::big, &tv, fb, x.t0,
                                 x.row);
          ++r;
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const float scale_log2 = scale * kLog2e;
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // ring step t, whose Q/dO tile this warpgroup's keys do not meet:
    // released once it has landed (an arrival before would count toward
    // the slot's last use)
    auto pass = [&](int t) {
      const int s = t % STAGES;
      mbar_wait_spin(&full[s], (t / STAGES) & 1);
      release(&empty[s]);
    };
    int r = 0, kr = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      for (int half = 0; half < halves; ++half) {
        const Item x = item<false>(w, half, BKV, nt, ragged);
        if (x.t0 < 0) continue;
        const int ks = kr % SLOTS;
        const uint32_t kph = (kr / SLOTS) & 1;
        ++kr;
        const int wk0 = x.t0 + 64 * wg;
        const int krow = wk0 + 16 * (warp % 4) + lane / 4;  // and krow + 8
        // the k tile's live q tiles, qi0 .. qi0 + N - 1, and this
        // warpgroup's run of them, tiles a .. a + n - 1 (none where its
        // keys lie past Sk)
        int qi0, wqi0 = 0;
        const int N = live_q_tiles(x.t0, min(x.t0 + TILE, Sk) - 1, Sq,
                                   q_offset, k_offset, causal, window, qi0);
        const int n = wk0 < Sk ? live_q_tiles(wk0, min(wk0 + 63, Sk - 1), Sq,
                                              q_offset, k_offset, causal,
                                              window, wqi0)
                               : 0;
        const int a = n > 0 ? wqi0 - qi0 : 0;
        uint8_t* Kw = Ks + ks * L::big + 64 * wg * L::atom;
        uint8_t* Vw = Vs + ks * L::big + 64 * wg * L::atom;
        const uint64_t kdesc = desc_sw<D>(Kw), vdesc = desc_sw<D>(Vw);
        float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
        mbar_wait_spin(&kvfull[ks], kph);
        for (int g = 0; g < grp; ++g) {
          for (int j = 0; j < a; ++j) pass(r + j);
          if (n > 0) {
            // S^T and dP^T of step t (64 keys x 64 queries each, D/16 k16
            // steps) as two groups; the packed P^T and dS^T of a step
            // wait in pa and dsa for its dV and dK products, issued with
            // the next step's S^T and dP^T
            float st[32], dpt[32];
            uint32_t pa[4][4], dsa[4][4];
            auto scores = [&](int t) {
              const int s = t % STAGES;
              const uint64_t qdesc = desc_sw<D>(Qs + s * L::small);
              const uint64_t dodesc = desc_sw<D>(dOs + s * L::small);
#pragma unroll
              for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss_n64(st, desc_k<D, TILE>(kdesc, kk),
                             desc_k<D, STEP>(qdesc, kk), kk);
              wgmma_commit();
#pragma unroll
              for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss_n64(dpt, desc_k<D, TILE>(vdesc, kk),
                             desc_k<D, STEP>(dodesc, kk), kk);
              wgmma_commit();
            };
            // dV += P^T dO and dK += dS^T Q of step t, the A operands
            // from registers, dO and Q MN-major from the ring
            auto grads = [&](int t) {
              const int s = t % STAGES;
              const uint64_t qdesc = desc_sw<D>(Qs + s * L::small);
              const uint64_t dodesc = desc_sw<D>(dOs + s * L::small);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_rs_rows<D, STEP>(dv_acc, pa[kk], dodesc, kk);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_rs_rows<D, STEP>(dk_acc, dsa[kk], qdesc, kk);
              wgmma_commit();
            };
            // P = exp2(S*scale*log2(e) - lse*log2(e)) in place of S^T on
            // the accumulator layout: column c is query q0 + c, and this
            // thread's columns come in pairs (c, c + 1), whose lse it
            // reads as float2
            auto probs = [&](int t, int q0) {
              const float2* ls2 = reinterpret_cast<const float2*>(
                  stats + (t % STAGES) * 2 * STEP);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                  const float2 ls = ls2[8 * kk + 4 * jj + lane % 4];
                  const float lx = ls.x * kLog2e, ly = ls.y * kLog2e;
#pragma unroll
                  for (int hh = 0; hh < 2; ++hh) {
                    const int i = 8 * kk + 4 * jj + 2 * hh;
                    st[i] = exp2_ftz(fmaf(st[i], scale_log2, -lx));
                    st[i + 1] = exp2_ftz(fmaf(st[i + 1], scale_log2, -ly));
                  }
                }
              if (q0 + STEP > Sq || wk0 + 64 > Sk ||
                  !rows_all_valid(q0, q0 + STEP - 1, wk0, wk0 + 63, q_offset,
                                  k_offset, causal, window))
                zero_queries(st, krow, q0, Sq, Sk, q_offset, k_offset,
                             causal, window);
            };
            // dS = P (dP - delta) scale in place of dP^T
            auto dsoft = [&](int t) {
              const float2* dl2 = reinterpret_cast<const float2*>(
                  stats + (t % STAGES) * 2 * STEP + STEP);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                  const float2 de = dl2[8 * kk + 4 * jj + lane % 4];
#pragma unroll
                  for (int hh = 0; hh < 2; ++hh) {
                    const int i = 8 * kk + 4 * jj + 2 * hh;
                    dpt[i] = st[i] * (dpt[i] - de.x) * scale;
                    dpt[i + 1] = st[i + 1] * (dpt[i + 1] - de.y) * scale;
                  }
                }
            };
            // P^T and dS^T packed to bf16 (the TPU kernels' casts) as the
            // A fragments of the step's dV and dK products
            auto pack = [&]() {
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                pack_a(st, kk, pa[kk]);
                pack_a(dpt, kk, dsa[kk]);
              }
            };
            const int t0 = r + a;
            {
              // the first step: S^T and dP^T alone
              mbar_wait_spin(&full[t0 % STAGES], (t0 / STAGES) & 1);
              wgmma_fence();
              scores(t0);
              wgmma_wait<1>();
              fence_operands(st);
              probs(t0, wqi0 * STEP);
              wgmma_wait<0>();
              fence_operands(dpt);
              dsoft(t0);
              pack();
            }
            for (int j = 1; j < n; ++j) {
              // S^T(j), dP^T(j) and the dV/dK products of j - 1 in flight
              // together: P(j) is formed while dP^T(j) and those run, dS(j)
              // while they do, and both are packed once they are done
              const int t = t0 + j;
              mbar_wait_spin(&full[t % STAGES], (t / STAGES) & 1);
              wgmma_fence();
              scores(t);
              grads(t - 1);
              wgmma_wait<2>();
              fence_operands(st);
              probs(t, (wqi0 + j) * STEP);
              wgmma_wait<1>();
              fence_operands(dpt);
              dsoft(t);
              wgmma_wait<0>();
              fence_operands(dk_acc);
              fence_operands(dv_acc);
              fence_operands(pa);
              fence_operands(dsa);
              release(&empty[(t - 1) % STAGES]);
              pack();
            }
            // the last step's dV and dK products
            const int t = t0 + n - 1;
            wgmma_fence();
            grads(t);
            wgmma_wait<0>();
            fence_operands(dk_acc);
            fence_operands(dv_acc);
            release(&empty[t % STAGES]);
          }
          for (int j = a + n; j < N; ++j) pass(r + j);
          r += N;
        }
        // dK and dV through this warpgroup's K and V rows (read by
        // nothing after its last product) to 16-byte stores of each
        // row's first hd columns; the slot is released once they are out
        // (the proxy fence orders these st.shared before the next TMA
        // into the slot)
        acc_to_tile<D, TILE>(dk_acc, 1.f, 1.f, Kw);
        acc_to_tile<D, TILE>(dv_acc, 1.f, 1.f, Vw);
        wg_barrier(1 + wg);
        if (wk0 < Sk) {
          const size_t at = ((size_t)x.row * Sk + wk0) * hd;
          tile_to_rows<D, TILE>(Kw, dk + at, Sk - wk0, hd);
          tile_to_rows<D, TILE>(Vw, dv + at, Sk - wk0, hd);
        }
        fence_proxy_async();
        release(&kvempty[ks]);
      }
    }
    release(done);
  }
}

// dQ at widths 16 and 32: one CTA a 192-row q tile of a head (`halves`
// 1) or persistent over pairs of them (`halves` 2), `items` work items as
// item<true> deals them. Warpgroup wg owns query rows 64wg .. 64wg + 63 of
// the tile at the whole head dim.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, int BH, int grp, int Sq,
                           int Sk, int hd, int q_offset, int k_offset,
                           int causal, int window, float scale, int items,
                           int halves, int ragged) {
  static_assert(D == 16 || D == 32, "the narrow bodies are 16 or 32 wide");
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  uint8_t* Qs = sm + L::a;
  uint8_t* dOs = sm + L::b;
  uint8_t* Ks = sm + L::c;
  uint8_t* Vs = sm + L::d;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::sfull);
  uint64_t* qempty = reinterpret_cast<uint64_t*>(sm + L::sempty);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(sm + L::empty);
  uint64_t* done = reinterpret_cast<uint64_t*>(sm + L::done);
  const int nt = (Sq + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    // lane 0 of each consumer warp arrives at the empty barriers
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 4 * WG);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);
    }
    mbar_init(done, 4 * WG);  // each consumer warp, at its end
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = warp_index(), lane = threadIdx.x % 32;
  if (warp >= 4 * WG) {
    // ---- producer warpgroup: every warp gives its registers back first;
    // its second warp is the CTA's watchdog; lane 0 of the first loads
    // each q tile's Q and dO into its slot, lane 0 of the third the live
    // K/V tiles into the ring (rows past each head's length arrive as
    // zeros), each walking the items on its own
    setmaxnreg_dec<kProducerRegs>();
    const int role = warp - 4 * WG;
    if (role == 1) {
      cta_watchdog(done);
    } else if (role == 0 && lane == 0) {
      int r = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        for (int half = 0; half < halves; ++half) {
          const Item x = item<true>(w, half, BH, nt, ragged);
          if (x.t0 < 0) continue;
          const int s = r % SLOTS;
          const uint32_t fb = base + L::sfull + 8 * s;
          mbar_wait_spin(base + L::sempty + 8 * s, ((r / SLOTS) & 1) ^ 1);
          mbar_expect_tx(fb, 2 * L::big);
          tma_load_tile<D, TILE>(base + L::a + s * L::big, &tq, fb, x.t0,
                                 x.row);
          tma_load_tile<D, TILE>(base + L::b + s * L::big, &tdo, fb, x.t0,
                                 x.row);
          ++r;
        }
      }
    } else if (role == 2 && lane == 0) {
      int r = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        for (int half = 0; half < halves; ++half) {
          const Item x = item<true>(w, half, BH, nt, ragged);
          if (x.t0 < 0) continue;
          int kj0;
          const int n = live_k_tiles(x.t0, min(x.t0 + TILE, Sq) - 1, Sk,
                                     q_offset, k_offset, causal, window,
                                     kj0);
          // GQA: query row b*H + h reads kv row b*KVH + h / grp
          const int kv_row = x.row / grp;
          for (int j = 0; j < n; ++j, ++r) {
            const int s = r % STAGES;
            const uint32_t fb = base + L::full + 8 * s;
            mbar_wait_spin(base + L::empty + 8 * s, ((r / STAGES) & 1) ^ 1);
            mbar_expect_tx(fb, 2 * L::small);
            tma_load_tile<D, STEP>(base + L::c + s * L::small, &tk, fb,
                                   (kj0 + j) * STEP, kv_row);
            tma_load_tile<D, STEP>(base + L::d + s * L::small, &tv, fb,
                                   (kj0 + j) * STEP, kv_row);
          }
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const float scale_log2 = scale * kLog2e;
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // ring step t, whose K/V tile this warpgroup's rows do not meet:
    // released once it has landed
    auto pass = [&](int t) {
      const int s = t % STAGES;
      mbar_wait_spin(&full[s], (t / STAGES) & 1);
      release(&empty[s]);
    };
    int r = 0, qi = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      for (int half = 0; half < halves; ++half) {
        const Item x = item<true>(w, half, BH, nt, ragged);
        if (x.t0 < 0) continue;
        const int qs = qi % SLOTS;
        const uint32_t qph = (qi / SLOTS) & 1;
        ++qi;
        const int wq0 = x.t0 + 64 * wg;
        const int qrow = wq0 + 16 * (warp % 4) + lane / 4;  // and qrow + 8
        // the q tile's live K/V tiles, kj0 .. kj0 + N - 1, and this
        // warpgroup's run of them, tiles a .. a + n - 1 (none where its
        // rows lie past Sq)
        int kj0, wkj0 = 0;
        const int N = live_k_tiles(x.t0, min(x.t0 + TILE, Sq) - 1, Sk,
                                   q_offset, k_offset, causal, window, kj0);
        const int n = wq0 < Sq ? live_k_tiles(wq0, min(wq0 + 63, Sq - 1), Sk,
                                              q_offset, k_offset, causal,
                                              window, wkj0)
                               : 0;
        const int a = n > 0 ? wkj0 - kj0 : 0;
        // this thread's two rows' lse * log2(e) and delta (0 past Sq:
        // those rows are masked)
        float lse2[2], dl[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = qrow + 8 * i;
          const bool in = row < Sq;
          lse2[i] = in ? lse[(size_t)x.row * Sq + row] * kLog2e : 0.f;
          dl[i] = in ? delta[(size_t)x.row * Sq + row] : 0.f;
        }
        uint8_t* Qw = Qs + qs * L::big + 64 * wg * L::atom;
        const uint64_t qdesc = desc_sw<D>(Qw);
        const uint64_t dodesc =
            desc_sw<D>(dOs + qs * L::big + 64 * wg * L::atom);
        float dq_acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
        mbar_wait_spin(&qfull[qs], qph);
        for (int j = 0; j < a; ++j) pass(r + j);
        if (n > 0) {
          // S and dP of step t (64 queries x 64 keys each, D/16 k16 steps)
          // as two groups; the packed dS of a step waits in dsa for its
          // dQ product, issued with the next step's S and dP
          float st[32], dpt[32];
          uint32_t dsa[4][4];
          auto scores = [&](int t) {
            const int s = t % STAGES;
            const uint64_t kdesc = desc_sw<D>(Ks + s * L::small);
            const uint64_t vdesc = desc_sw<D>(Vs + s * L::small);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              wgmma_ss_n64(st, desc_k<D, TILE>(qdesc, kk),
                           desc_k<D, STEP>(kdesc, kk), kk);
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              wgmma_ss_n64(dpt, desc_k<D, TILE>(dodesc, kk),
                           desc_k<D, STEP>(vdesc, kk), kk);
            wgmma_commit();
          };
          // dQ += dS K of step t, K MN-major from the ring
          auto grad = [&](int t) {
            const uint64_t kdesc = desc_sw<D>(Ks + (t % STAGES) * L::small);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs_rows<D, STEP>(dq_acc, dsa[kk], kdesc, kk);
            wgmma_commit();
          };
          // P = exp2(S*scale*log2(e) - lse*log2(e)) in place of S, on the
          // accumulator layout: element i is row qrow + 8*((i/2)%2), key
          // k0 + 8*(i/4) + 2*(lane%4) + i%2
          auto probs = [&](int k0) {
#pragma unroll
            for (int i = 0; i < 32; ++i)
              st[i] = exp2_ftz(fmaf(st[i], scale_log2, -lse2[(i / 2) % 2]));
            if (wq0 + 64 > Sq || k0 + STEP > Sk ||
                !rows_all_valid(wq0, wq0 + 63, k0, k0 + STEP - 1, q_offset,
                                k_offset, causal, window))
              zero_keys(st, qrow, k0, Sq, Sk, q_offset, k_offset, causal,
                        window);
          };
          // dS = P (dP - delta) scale in place of P, then packed to bf16
          // (the TPU kernel's ds.astype(k.dtype)) as the A fragments of
          // the step's dQ product
          auto dsoft = [&]() {
#pragma unroll
            for (int i = 0; i < 32; ++i)
              st[i] = st[i] * (dpt[i] - dl[(i / 2) % 2]) * scale;
          };
          auto pack = [&]() {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) pack_a(st, kk, dsa[kk]);
          };
          const int t0 = r + a;
          {
            // the first step: S and dP alone
            mbar_wait_spin(&full[t0 % STAGES], (t0 / STAGES) & 1);
            wgmma_fence();
            scores(t0);
            wgmma_wait<1>();
            fence_operands(st);
            probs(wkj0 * STEP);
            wgmma_wait<0>();
            fence_operands(dpt);
            dsoft();
            pack();
          }
          for (int j = 1; j < n; ++j) {
            // S(j), dP(j) and the dQ product of j - 1 in flight together:
            // P(j) is formed while dP(j) and that dQ run, dS(j) while the
            // dQ does, packed once it is done with the fragments
            const int t = t0 + j;
            mbar_wait_spin(&full[t % STAGES], (t / STAGES) & 1);
            wgmma_fence();
            scores(t);
            grad(t - 1);
            wgmma_wait<2>();
            fence_operands(st);
            probs((wkj0 + j) * STEP);
            wgmma_wait<1>();
            fence_operands(dpt);
            dsoft();
            wgmma_wait<0>();
            fence_operands(dq_acc);
            fence_operands(dsa);
            // step j - 1 is done with (its K read by the dQ product just
            // waited on, its V by its dP)
            release(&empty[(t - 1) % STAGES]);
            pack();
          }
          // the last step's dQ product
          const int t = t0 + n - 1;
          wgmma_fence();
          grad(t);
          wgmma_wait<0>();
          fence_operands(dq_acc);
          release(&empty[t % STAGES]);
        }
        for (int j = a + n; j < N; ++j) pass(r + j);
        r += N;
        // dQ through this warpgroup's Q rows (read by nothing after its
        // last S) to 16-byte stores of each row's first hd columns; the
        // slot is released once they are out
        acc_to_tile<D, TILE>(dq_acc, 1.f, 1.f, Qw);
        wg_barrier(1 + wg);
        if (wq0 < Sq)
          tile_to_rows<D, TILE>(Qw, dq + ((size_t)x.row * Sq + wq0) * hd,
                                Sq - wq0, hd);
        fence_proxy_async();
        release(&qempty[qs]);
      }
    }
    release(done);
  }
}

// The schedule by shape, as the narrow forward's: where the 192-row tiles
// fill at most one wave of the SMs (tpu_model_lm_d32's B 16 x H 8 x S
// 128: 128), one CTA a tile, heaviest first; where they fill more (B 8 x
// H 16 x S 1024: 768), persistent, one CTA an SM over pairs of tiles.
// Every head's operands fit in L2 at these widths: no groups of heads.
template <int D>
cudaError_t launch_dq(const Args& a) {
  // with Sk == 0 no K/V tile is loaded; the maps still need an extent
  const void* kp = a.Sk > 0 ? a.k : a.q;
  const void* vp = a.Sk > 0 ? a.v : a.q;
  const int krows = a.Sk > 0 ? a.Sk : a.Sq;
  const int kslabs = a.Sk > 0 ? a.B * a.KVH : a.B * a.H;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_rows_map<D>(&tq, a.q, a.hd, a.Sq, a.B * a.H, TILE);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tdo, a.dout, a.hd, a.Sq, a.B * a.H, TILE);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tk, kp, a.hd, krows, kslabs, STEP);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tv, vp, a.hd, krows, kslabs, STEP);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Layout<D>::bytes;
  auto kernel = flash_dq_narrow_kernel<D>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = multiprocessors(&sms);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.H, nt = (a.Sq + TILE - 1) / TILE;
  const bool paired = nt * BH > sms;
  const int items = (paired ? (nt + 1) / 2 : nt) * BH;
  kernel<<<std::min(items, sms), THREADS, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), BH,
      a.H / a.KVH, a.Sq, a.Sk, a.hd, a.q_offset, a.k_offset, a.causal,
      a.window, a.scale, items, paired ? 2 : 1,
      ragged_rank<true>(a.Sq, a.Sk, a.q_offset, a.k_offset, a.causal,
                        a.window));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  // with Sq == 0 no Q/dO tile is loaded; the maps still need an extent
  const void* qp = a.Sq > 0 ? a.q : a.k;
  const void* gp = a.Sq > 0 ? a.dout : a.k;
  const int qrows = a.Sq > 0 ? a.Sq : a.Sk;
  const int qslabs = a.Sq > 0 ? a.B * a.H : a.B * a.KVH;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_rows_map<D>(&tq, qp, a.hd, qrows, qslabs, STEP);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tdo, gp, a.hd, qrows, qslabs, STEP);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tk, a.k, a.hd, a.Sk, a.B * a.KVH, TILE);
  if (err == cudaSuccess)
    err = encode_rows_map<D>(&tv, a.v, a.hd, a.Sk, a.B * a.KVH, TILE);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Layout<D>::bytes;
  auto kernel = flash_dkv_narrow_kernel<D>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = multiprocessors(&sms);
  if (err != cudaSuccess) return err;
  const int BKV = a.B * a.KVH, nt = (a.Sk + TILE - 1) / TILE;
  const bool paired = nt * BKV > sms;
  const int items = (paired ? (nt + 1) / 2 : nt) * BKV;
  kernel<<<std::min(items, sms), THREADS, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), BKV, a.H / a.KVH, a.Sq, a.Sk, a.hd,
      a.q_offset, a.k_offset, a.causal, a.window, a.scale, items,
      paired ? 2 : 1,
      ragged_rank<false>(a.Sq, a.Sk, a.q_offset, a.k_offset, a.causal,
                         a.window));
  return cudaGetLastError();
}

}  // namespace nb

template <int D>
cudaError_t launch_dq(const Args& a) {
  if constexpr (D <= 32)
    return nb::launch_dq<D>(a);
  else
    return dq::launch<D>(a);
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  if constexpr (D == 256)
    return dkv::launch_w256(a);
  else if constexpr (D <= 32)
    return nb::launch_dkv<D>(a);
  else
    return dkv::launch<D>(a);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int B, int H, int KVH, int Sq, int Sk, int hd,
               int q_offset, int k_offset, int causal, int window,
               float scale, void* stream, const void* plan = nullptr,
               int chunks = 0, void* partials = nullptr) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dq, dk, dv, B, H, KVH, Sq,
              Sk, hd, q_offset, k_offset, causal, window, scale,
              static_cast<cudaStream_t>(stream),
              static_cast<const int*>(plan), chunks,
              static_cast<float*>(partials)};
}

}  // namespace

// q, dout (B, H, Sq, hd); k, v (B, KVH, Sk, hd); lse, delta (B, H, Sq)
// f32; dq like q; dk, dv like k. All contiguous, q/k/v/dout and the
// outputs of one type (is_bf16 ? bf16 : f32; bf16 pointers 16-byte
// aligned). window <= 0 means no sliding window. hd is a multiple of 8
// from 8 to 256; any other returns cudaErrorInvalidValue. Each returns
// cudaGetLastError() after its launch. The dK/dV entry at bf16 and hd >
// 128 (the width-256 body) also takes the plan (`chunks` rows of
// PLAN_ROW int32 on the device, ops/flash_attention.py `dkv_plan`) and
// the f32 partials of its split k tiles (2 x 64 x 256 floats a slot),
// or no plan where it splits no k tile (one CTA a k tile); in f32 at hd
// 40-256 likewise, with partials of 2 x the body's k tile rows x its
// width floats a slot (flash_bwd_f32.cu). The other bodies ignore both.
extern "C" int etpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int KVH, int Sq, int Sk, int hd,
                                 int q_offset, int k_offset, int causal,
                                 int window, float scale, int is_bf16,
                                 void* stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  if (!is_bf16)
    return etpu::f32_bwd_dq(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), B, H, KVH, Sq, Sk, hd, q_offset, k_offset,
        causal, window, scale, static_cast<cudaStream_t>(stream));
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                           B, H, KVH, Sq, Sk, hd, q_offset, k_offset, causal,
                           window, scale, stream);
  return etpu::with_head_dim(
      hd, [&](auto w) { return launch_dq<decltype(w)::value>(a); });
}

extern "C" int etpu_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, const void* plan,
                                  int chunks, void* partials, int B, int H,
                                  int KVH, int Sq, int Sk, int hd,
                                  int q_offset, int k_offset, int causal,
                                  int window, float scale, int is_bf16,
                                  void* stream) {
  if (B * KVH == 0 || Sk == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  if (!is_bf16)
    return etpu::f32_bwd_dkv(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv),
        static_cast<const int*>(plan), chunks, static_cast<float*>(partials),
        B, H, KVH, Sq, Sk, hd, q_offset, k_offset, causal, window, scale,
        static_cast<cudaStream_t>(stream));
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H,
                           KVH, Sq, Sk, hd, q_offset, k_offset, causal,
                           window, scale, stream, plan, chunks, partials);
  return etpu::with_head_dim(
      hd, [&](auto w) { return launch_dkv<decltype(w)::value>(a); });
}

// The dK/dV reduction of the plan's split k tiles: `rows` reduction rows
// of the plan (PLAN_ROW int32 each, on the device) over `partials`, into
// the split k tiles' rows of dk and dv ((B, KVH, Sk, hd)), k tiles of
// `krows` rows (a multiple of 16): bf16 at hd 136-256 (the width-256
// bf16 body's partials, 2 x 64 x 256 floats a slot), or f32 at hd 40-256
// (the f32 tensor-core bodies', 2 x krows x their width;
// flash_bwd_f32.cu). Returns cudaGetLastError() after its launch.
extern "C" int etpu_flash_dkv_reduce(const void* partials, const void* plan,
                                     int rows, void* dk, void* dv, int Sk,
                                     int hd, int krows, int is_bf16,
                                     void* stream) {
  if (rows == 0) return cudaSuccess;
  if (rows < 0 || krows <= 0 || krows % dkv::REDUCE_ROWS ||
      hd <= (is_bf16 ? 128 : 32) || !etpu::takes_head_dim(hd))
    return cudaErrorInvalidValue;
  const dim3 grid(rows, 2, krows / dkv::REDUCE_ROWS);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(partials);
  const auto* table = static_cast<const int*>(plan);
  if (is_bf16) {
    dkv::flash_dkv_reduce_kernel<bf16, 256>
        <<<grid, dkv::REDUCE_THREADS, 0, s>>>(p, table, static_cast<bf16*>(dk),
                                             static_cast<bf16*>(dv), Sk, hd,
                                             krows);
    return cudaGetLastError();
  }
  return etpu::with_head_dim(hd, [&](auto w) -> cudaError_t {
    constexpr int W = decltype(w)::value;
    if constexpr (W >= 64) {
      dkv::flash_dkv_reduce_kernel<float, W>
          <<<grid, dkv::REDUCE_THREADS, 0, s>>>(
              p, table, static_cast<float*>(dk), static_cast<float*>(dv), Sk,
              hd, krows);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  });
}
