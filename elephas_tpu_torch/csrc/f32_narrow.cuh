// The f32 flash bodies on the tensor cores: the strip bodies at widths
// 16 and 32 (head dims 8-32) of the forward (`flash_fwd_f32_narrow_kernel`,
// flash_fwd.cu), dQ and dK/dV (`flash_dq_f32_narrow_kernel`,
// `flash_dkv_f32_narrow_kernel`, flash_bwd_f32.cu), and the pieces that
// the backward's bodies of widths 64-256 (flash_bwd_f32.cu) take from
// them: the split, the product, the fragment maps, the copies.
//
// What bounds the strip bodies. The f32 paths that run these widths are
// small: the `speculative_serving.py` LM's training and distillation
// steps (B 8 x H 4 x S 32, d 16) and the `http_serving.py` LM's forward
// (B 4 x H 4 x S 96). A call moves about 0.3 MB and needs about 0.1
// MFLOP a head, so no rate bounds it but the chain of one warp, from its
// launch to its last store: the launch itself (an empty kernel takes 4.8
// us under chip_smoke's timer on an H100), the copies issued, one round
// trip, the steps, the stores. The 256-thread CUDA-core bodies they
// replaced spent most of a 64 x 64 tile on rows and keys past S at these
// lengths, made two round trips before the first product, and left 100
// of the 132 SMs idle (32 CTAs). Clock stamps a phase
// (tests/torch_flash_f32_variants.py `timeline`) put a warp of the
// speculative shape's forward at about 2,000 cycles to issue its copies,
// 200-600 waiting for them, 480 a step and 600 for the stores: PERF.md.
//
// Design.
// - A warp owns a strip of 16 rows (`ROWS`, the M of
//   `mma.sync.m16n8k8`): query rows in the forward and dQ, key rows in
//   dK/dV.
//   Nothing is shared between the warps of a CTA, so no CTA barrier is
//   needed: `kWarps` (picked by timing, PERF.md) only sets how strips
//   share an SM. The grid is (heads / kWarps, strips), a CTA's warps
//   taking one strip of kWarps heads, so nothing divides at run time
//   (the forward's and dQ's query-to-kv-head map is a `FastDiv`);
//   blockIdx.y orders strips heaviest first, the forward's and dQ's from
//   the last rows of a head (under causal masking the rows that meet the
//   most keys), dK/dV's from the first key rows.
// - A strip walks only its live range of the other operand, in steps of
//   8 rows (`STEP`): from the run of the strip's first row to that of
//   its last (`key_run`, `query_run`: the causal diagonal, the window's
//   edge and the lengths, on global positions, as `pair_valid`). No step
//   past the last live one is loaded or multiplied; inside a step the
//   mask is two compares an element against its row's run. The forward
//   runs one online-softmax update a step.
// - The operands arrive by `cp.async.cg`, 16 bytes a lane, into the
//   warp's own ring of 64-row stages (`STAGE`, `STAGES`), zero-filled
//   past the head dim and past the sequence's end by the copy's source
//   size; the strip's own rows come with the first stage. Every stage the
//   ring holds is issued before the first wait, so at S <= 128 a strip's
//   whole operand set lands in one round trip. The warp waits with
//   `cp.async.wait_group` and `__syncwarp`, and a stage's slot is
//   released by the warp's own `__syncwarp` once its last step has read
//   it (a ring per warp: no arrival count across warps is needed).
// - Products on the tensor cores as 3xTF32: each f32 operand x is split
//   into hi, its top 19 bits, and lo = x - hi (`split`), and lo*hi +
//   hi*lo + hi*hi accumulate in f32, the small terms first (in `dots`
//   into a sum of their own, added once): about 2^-20 relative a
//   product, where one TF32 pass (2^-11) would miss the f32 tolerances
//   (1e-4). The strip's rows are split once into registers (A
//   fragments); a step's 8 rows are read from the stage as B fragments.
//   `dots` gives a step's 16 x 8 scores S = A T^T; `accum` adds P T, P a
//   16 x 8 C fragment, into a 16 x W accumulator.
// - P (P^T, dS^T in dK/dV) goes from the C fragment of one product to
//   the A fragment of the next with neither a shuffle nor a shared tile:
//   the m16n8k8 C fragment holds (row g, columns 2t, 2t + 1) and (g + 8,
//   the same) of lane 4g + t, its A fragment (g, t), (g + 8, t), (g, t +
//   4), (g + 8, t + 4). The k index of the P T product may run over the
//   step's rows in any order, so `accum` numbers them 2t -> t and 2t + 1
//   -> t + 4: then a = {c0, c2, c1, c3} in place, and its B fragment reads
//   step rows 2t and 2t + 1. (Quad shuffles would put 8 on every step's
//   chain, a shared tile a store, a `__syncwarp` and 4 loads.) With a row
//   stride of W + 4 floats both fragment reads of a stage (rows g at
//   columns t, t + 4; rows 2t, 2t + 1 at column g) fall on 32 distinct
//   banks.
// - The loops over copies and over a stage's steps stay rolled: unrolled
//   by 8 they ran no faster (and spilled at W 32), since each step waits
//   on the one before (the softmax's running max, the accumulators).
// - tests/torch_flash_f32_variants.py builds timing-only copies: `ffma`
//   the same strips, stages and walk with the products on the CUDA cores
//   (3xTF32 won at width 32 and tied at 16: PERF.md), `loads_only` no
//   products, `timeline` clock stamps a phase.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace etpu {
namespace f32n {

// warps (strips) a CTA: 1, 2 and 4 timed within 3% of each other, 1 and
// 2 ahead at width 32 (PERF.md); 1 keeps the most strips on an SM at long
// lengths
constexpr int kWarps = 1;
constexpr int ROWS = 16;    // a strip's rows: the M of m16n8k8
constexpr int STEP = 8;     // rows of the other operand a step
constexpr int STAGE = 64;   // rows a stage
constexpr int STAGES = 2;   // stages in a warp's ring

// the row stride of every shared tile, in floats: 16-byte rows, and
// conflict-free fragment reads (above)
template <int W>
constexpr int LD = W + 4;

// The forward's shared memory a warp: its strip's Q rows, then STAGES x
// (K, V) tiles of STAGE rows.
template <int W>
struct FwdSmem {
  static constexpr int strip = ROWS * LD<W>;
  static constexpr int tile = STAGE * LD<W>;
  static constexpr int floats = strip + STAGES * 2 * tile;
  static constexpr size_t bytes = sizeof(float) * floats * kWarps;
};

// dK/dV's a warp: its strip's K and V rows, then STAGES x (Q, dO, lse,
// delta) of STAGE query rows.
template <int W>
struct DkvSmem {
  static constexpr int strip = ROWS * LD<W>;
  static constexpr int tile = STAGE * LD<W>;
  static constexpr int stage = 2 * tile + 2 * STAGE;
  static constexpr int floats = 2 * strip + STAGES * stage;
  static constexpr size_t bytes = sizeof(float) * floats * kWarps;
};

// A strip's 16 rows in registers, split into TF32 A fragments (hi and
// lo, W / 8 k steps).
template <int W>
struct Strip {
  uint32_t hi[W / 8][4], lo[W / 8][4];
};

// x = hi + lo as two TF32 operands: hi keeps the top 19 bits of x (sign,
// exponent, 10 mantissa bits), lo = x - hi exactly, and the tensor cores
// read the top 19 bits of each, so lo loses its own low 13 bits. The
// three products then miss x y by about 2^-20 relative. (`cvt.rna.tf32`
// rounds instead, 2^-22, but sm_90a carries it out as four dependent
// instructions with an infinity check, on every operand of every step.)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery's round-up method), the divisor's constants from the host:
// a run-time division is some 25 dependent instructions.
struct FastDiv {
  uint32_t mul = 1;
  int shift = 0;
  static FastDiv of(uint32_t d) {
    FastDiv f;
    while ((1ull << f.shift) < d) ++f.shift;
    f.mul = static_cast<uint32_t>((1ull << 32) * ((1ull << f.shift) - d) / d
                                  + 1);
    return f;
  }
  __device__ int operator()(int n) const {
    return static_cast<int>((__umulhi(static_cast<uint32_t>(n), mul) +
                             static_cast<uint32_t>(n)) >> shift);
  }
};

// c += a b: one m16n8k8 TF32 product, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte cp.async of `src` to shared address `dst`, or 16 zero bytes
// where `in` is false (a source size of 0 reads nothing; `src` must
// still be a valid address)
__device__ __forceinline__ void cp16(uint32_t dst, const float* src,
                                     bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Rows [r0, r0 + n) of a (rows, hd) f32 matrix into a shared tile of
// stride LD<W>, by NT threads (the warp's 32 lanes, or a CTA's), `lane`
// the thread's index among them: zeros past `limit` rows and past column
// hd (hd a multiple of 8: a 16-byte chunk is wholly in or out), the
// addresses from one base.
template <int W, int NT = 32>
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          int r0, int n, int limit, int hd,
                                          int lane) {
  constexpr int CH = W / 4;  // 16-byte chunks a row
  const float* base = src + (size_t)r0 * hd;
  const uint32_t dst = smem_u32(tile);
  const int rows = limit - r0;  // rows that hold data
#pragma unroll 1
  for (int i = lane; i < n * CH; i += NT) {
    const int r = i / CH, c = 4 * (i % CH);
    const bool in = r < rows && c < hd;
    cp16(dst + 4 * (r * LD<W> + c), in ? base + r * hd + c : src, in);
  }
}

// Floats [r0, r0 + n) (n <= STAGE) of a row statistic into shared
// memory, zeros past `limit` (4-byte copies: a head's statistics need not
// be 16-byte aligned).
__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           int r0, int n, int limit,
                                           int lane) {
  const uint32_t at = smem_u32(dst);
#pragma unroll
  for (int it = 0; it < STAGE / 32; ++it) {
    const int i = lane + 32 * it;
    if (i < n) {
      const bool in = r0 + i < limit;
      cp_async_4(at + 4 * i, in ? src + r0 + i : src, in);
    }
  }
}

// The strip's rows (a landed shared tile of ROWS rows, row stride L,
// its first W columns) into registers.
template <int W, int L = LD<W>>
__device__ __forceinline__ void load_strip(Strip<W>& s, const float* tile,
                                           int g, int t) {
#pragma unroll
  for (int kc = 0; kc < W / 8; ++kc) {
    const float* p = tile + kc * 8 + t;
    split(p[g * L], s.hi[kc][0], s.lo[kc][0]);
    split(p[(g + 8) * L], s.hi[kc][1], s.lo[kc][1]);
    split(p[g * L + 4], s.hi[kc][2], s.lo[kc][2]);
    split(p[(g + 8) * L + 4], s.hi[kc][3], s.lo[kc][3]);
  }
}

// A step's scores: s (the C fragment: rows g and g + 8 of the strip at
// step rows 2t and 2t + 1) = the strip's rows dotted with the 8 rows of
// `tile` (a stage's rows from the step's first, row stride L, their first
// W columns).
template <int W, int L = LD<W>>
__device__ __forceinline__ void dots(float (&s)[4], const Strip<W>& a,
                                     const float* tile, int g, int t) {
  // B fragment: (k t, n g) and (k t + 4, n g) = step row g at columns
  // 8kc + t and + 4
  float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kc = 0; kc < W / 8; ++kc) {
    const float* p = tile + g * L + kc * 8 + t;
    uint32_t h0, l0, h1, l1;
    split(p[0], h0, l0);
    split(p[4], h1, l1);
    mma(small, a.lo[kc], h0, h1);
    mma(small, a.hi[kc], l0, l1);
    mma(big, a.hi[kc], h0, h1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = big[e] + small[e];
}

// acc (N C fragments: rows g and g + 8 at columns 8n + 2t and + 1) +=
// P T: P a step's 16 x 8 C fragment (as `dots` leaves it), T the step's
// 8 rows of `tile` (row stride L floats), its first 8N columns.
template <int N, int L>
__device__ __forceinline__ void accum_n(float (&acc)[N][4],
                                        const float (&p)[4],
                                        const float* tile, int g, int t) {
  // A fragment in place: k t <-> step row 2t, k t + 4 <-> 2t + 1
  uint32_t hi[4], lo[4];
  split(p[0], hi[0], lo[0]);
  split(p[2], hi[1], lo[1]);
  split(p[1], hi[2], lo[2]);
  split(p[3], hi[3], lo[3]);
  // B fragment (k t, n g), (k t + 4, n g): step rows 2t and 2t + 1 at
  // column 8n + g
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float* q = tile + 2 * t * L + 8 * n + g;
    split(q[0], bh[n][0], bl[n][0]);
    split(q[L], bh[n][1], bl[n][1]);
  }
  // small terms first; the N accumulators are independent chains
#pragma unroll
  for (int n = 0; n < N; ++n) mma(acc[n], lo, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(acc[n], hi, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(acc[n], hi, bh[n][0], bh[n][1]);
}

// accum_n over a stage tile's whole width W
template <int W>
__device__ __forceinline__ void accum(float (&acc)[W / 8][4],
                                      const float (&p)[4],
                                      const float* tile, int g, int t) {
  accum_n<W / 8, LD<W>>(acc, p, tile, g, t);
}

// The run [lo, hi] of local key rows that local query row ql meets
// (causal, window, lengths on global positions); empty (lo > hi) past Sq.
__device__ __forceinline__ int2 key_run(int ql, int Sq, int Sk,
                                        int q_offset, int k_offset,
                                        int causal, int window) {
  if (ql >= Sq) return make_int2(1, 0);
  const int at = q_offset + ql - k_offset;  // the row among the keys
  return make_int2(window > 0 ? max(0, at - window + 1) : 0,
                   causal ? min(Sk - 1, at) : Sk - 1);
}

// The run of local query rows that local key row kl meets; empty past
// Sk.
__device__ __forceinline__ int2 query_run(int kl, int Sq, int Sk,
                                          int q_offset, int k_offset,
                                          int causal, int window) {
  if (kl >= Sk) return make_int2(1, 0);
  const int at = k_offset + kl - q_offset;  // the key among the queries
  return make_int2(causal ? max(0, at) : 0,
                   window > 0 ? min(Sq - 1, at + window - 1) : Sq - 1);
}

// A strip's walk: steps of STEP rows from the run of its first row to
// that of its last, in stages of R rows (a strip body's STAGE; a CTA's
// tile in the wide bodies).
template <int R = STAGE>
struct Walk {
  int begin = 0, end = 0;  // rows [begin, end), STEP-aligned
  int stages = 0;
  __device__ Walk(int2 first, int2 last) {
    if (last.y >= first.x && last.y >= 0) {
      begin = first.x & ~(STEP - 1);
      end = (last.y & ~(STEP - 1)) + STEP;
      stages = (end - begin + R - 1) / R;
    }
  }
  // stage s's first row and its steps
  __device__ int row(int s) const { return begin + s * R; }
  __device__ int steps(int s) const { return min(R, end - row(s)) / STEP; }
};

}  // namespace f32n
}  // namespace etpu
