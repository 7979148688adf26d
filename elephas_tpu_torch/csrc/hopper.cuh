// Hopper (sm_90a) building blocks for the port's hand-written kernels.
//
// Small inline-PTX wrappers, each named after what it wraps:
// - TMA: `tma_load_3d` is `cp.async.bulk.tensor.3d` from a tensor map
//   into shared memory, completing on an mbarrier's transaction count;
//   `tma_load_tile` loads a tile of head-dim rows block by block (see
//   below); `encode_rows_map` (host) builds the map of a (slabs, rows,
//   d) bf16 tensor with `cuTensorMapEncodeTiled`, fetched through the
//   runtime's driver entry point, so the library links against no
//   libcuda.
// - mbarrier: `mbar_init` (`mbarrier.init`), `fence_barrier_init`
//   (`fence.mbarrier_init`), `mbar_expect_tx`
//   (`mbarrier.arrive.expect_tx`: arrive and expect that many bytes),
//   `mbar_arrive` (`mbarrier.arrive`), `mbar_wait`
//   (`mbarrier.try_wait.parity` in a loop: returns once the phase of
//   the given parity has completed). The loop is a watchdog: after
//   about 4 s by `%globaltimer` it executes `trap`, so a phase that can
//   never complete (a wrong parity, a producer that skips a tile its
//   consumers still wait for) aborts the kernel instead of hanging the
//   card. The error ("unspecified launch failure") surfaces at the
//   next synchronising call on the stream and leaves the CUDA context
//   unusable: the process has to exit. The head-dim-128 bodies wait with
//   `mbar_wait_spin` instead and leave the trap to one watchdog warp a
//   CTA (`cta_watchdog`), which also covers their named barriers.
// - wgmma: `wgmma_fence` / `wgmma_commit` / `wgmma_wait<N>`
//   (`wgmma.fence`, `commit_group`, `wait_group`), `fence_operands`
//   (keeps the compiler from touching accumulator registers across an
//   asynchronous product), `wgmma_ss_n32` / `_n64` / `_n128` and
//   `wgmma_ss<N>` over them (m64nNk16 bf16 -> f32, A and B from shared
//   memory), `wgmma_rs_n64` (m64n64k16: A from registers, B K-major
//   from shared memory), `wgmma_rs_n16_tb` / `_n32_tb` / `_n64_tb`
//   (m64nNk16: A from registers, B MN-major from shared memory) and `wgmma_rs_rows<D, R>`
//   over them (N the head dim; one n64 product per column block at D
//   128 and 256); `wgmma_ss_n64_tb` and `wgmma_ss_rows128` the same with
//   A from shared memory (the 256 dK/dV body's P^T and dS^T tiles), and
//   `fence_proxy_async` (`fence.proxy.async.shared::cta`) between the
//   st.shared that write such a tile and the wgmma that reads it.
// - cp.async: `cp_async_16` (`cp.async.cg.shared.global`, 16 bytes from
//   device memory into shared memory, bypassing L1), `cp_async_commit`
//   and `cp_async_wait<N>` (`cp.async.commit_group` / `wait_group`:
//   returns once at most N of this thread's groups are in flight; the
//   finished copies are then visible to this thread); `cp_async_4`
//   (`cp.async.ca`, 4 bytes, or 4 zero bytes where the source is out of
//   range) and `cp_async_mbar_arrive` (`cp.async.mbarrier.arrive.noinc`:
//   an mbarrier arrival once this thread's copies have landed, so the
//   threads that wait on the barrier see them).
// - Tiles of body width W: the bodies are instantiated at W = 16, 32, 64,
//   128 and 256, and a head dim d (a multiple of 8, 8 <= d <= 256) runs
//   the body of the smallest W >= d: 8 and 16 on W 16, 24 and 32 on W 32,
//   40-64 on W 64, 72-128 on W 128, 136-256 on W 256. A tile row is 2*W
//   bytes in shared memory (512 at W 256, 256 at 128, 128 at 64, 64 at
//   32, 32 at 16), of which the
//   first 2*d bytes are the head's and the rest zeros: the tensor map
//   holds the real d (its row stride is 2*d bytes, so d must be a
//   multiple of 8 for TMA's 16-byte strides), and TMA fills the box's
//   columns past d with zeros without reading them. Zero columns add
//   nothing to a product over the head dim (S = Q K^T) and give zero
//   columns in a product whose N is the head dim (P V, dS K, P^T dO,
//   dS^T Q), which the stores drop: `tile_to_rows` writes only the
//   first d columns of a row. Up to W 64 a row lies in the swizzle of
//   its own width, which TMA writes (CU_TENSOR_MAP_SWIZZLE_128B / 64B /
//   32B) and wgmma reads. Neither takes a swizzle wider than 128 bytes,
//   so at W 128 a tile of R rows is stored as two column blocks, each an
//   R x 64 tile in the 128-byte swizzle, block 1 (columns 64-127) R *
//   128 bytes after block 0: exactly two W 64 tiles (`Rows<W>`); at d
//   72-120 block 1 is partly real. At W 256 a row is four such blocks
//   (block b, columns 64b .. 64b + 63, at b * R * 128 bytes), so blocks
//   2 and 3 of a W 256 tile are a W 128 tile of their own; at d 136-192
//   block 3, and at d 136 most of block 2, hold only filled zeros, which
//   TMA still writes and counts. `desc_sw<W>` is the 64-bit
//   shared-memory matrix descriptor of a block, `desc_k<W, R>` that of
//   one k16 step of a K-major operand (which stays inside one block),
//   `swz<W, R>` the byte offset of a 16-byte chunk.
// - `with_head_dim` (host): the one switch from a head dim to the body
//   width the flash kernels are instantiated for.
// - `wg_barrier` (`bar.sync id, 128`): one warpgroup's named barrier;
//   `consumers_barrier` / `consumers_arrive` (`bar.sync` / `bar.arrive
//   id, 256`): the two consumer warpgroups' named barrier, waited on or
//   only arrived at (the ping-pong turns of the head-dim-128 bodies). No
//   watchdog covers a named barrier: a turn that is never given hangs
//   the card, so both warpgroups must take the same number of turns.
// - `setmaxnreg_dec<N>` / `setmaxnreg_inc<N>`
//   (`setmaxnreg.dec/inc.sync.aligned.u32 N`): a whole warpgroup gives
//   its registers back to the CTA's pool down to N a thread, or waits
//   until the pool holds enough to raise it to N. The head-dim-128
//   bodies launch 384 threads (`__launch_bounds__(384, 1)`: 168 each,
//   64,512 in all); the producer warpgroup drops to 24 and the two
//   consumer warpgroups rise to 240, 128 * 24 + 256 * 240 = 64,512, so
//   the pool always holds what the consumers ask for. (An earlier
//   9-warp CTA tried this with a one-warp producer: that warp alone can
//   free at most (168 - 24) * 32 registers, the consumers asked for
//   more, and `inc` waited for good.) Every warp of the producer
//   warpgroup executes its `dec` first thing, before any branch or
//   exit; the roles are one if/else that never reconverges, or ptxas
//   ignores the instruction.
// - `exp2_ftz` (`ex2.approx.ftz.f32`): the softmax's exponential.
// - Accumulator helpers on the documented wgmma D layout (thread t of a
//   warpgroup holds, for each 8-column group j, rows 16*(t/32) + (t%32)/4
//   and that + 8 at columns 8j + 2*(t%4) and + 1): `pack_a` turns the
//   16 columns of one k step into the bf16 A fragment of an RS product
//   (`tile_to_frags` reads a shared tile's rows into such fragments),
//   `acc_to_tile<W, R>` stores a 64 x W accumulator as bf16 into 64 rows
//   of a swizzled shared tile of R rows, and `tile_to_rows<W, R>` copies
//   the first d columns of such rows out to device memory (rows of d
//   values) with 16-byte stores, dropping rows past a limit. At W 128 the
//   accumulator's first 32 registers are columns 0-63 (block 0), the
//   last 32 columns 64-127 (block 1); at W 256 registers 32b ..
//   32b + 31 are block b's columns, the layout of one m64n256 product.
//   `tile_to_rows` also takes a row stride of its own, so a warpgroup
//   that holds only 128 of a row's 256 columns stores them as a W 128
//   tile (blocks 2 and 3 of a W 256 tile) into the middle of each row.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace etpu {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The bf16 tiles of body width D (16, 32, 64 or 128; a head dim d <= D
// fills the first d columns, see the note at the top): one row is 2*D
// bytes, stored in the swizzle of that width up to 128 bytes (TMA and
// wgmma agree on it). The swizzle XORs address bits 7.. into the 16-byte
// chunk index (bits 4..): 3 bits at 128-byte rows (chunk c of row r at c
// ^ (r % 8)), 2 at 64-byte rows (c ^ (r / 2 % 4)), 1 at 32-byte rows (c
// ^ (r / 4 % 2)); the pattern repeats every 8 rows, 1024, 512 or 256
// bytes. A 256- or 512-byte row (D 128 or 256) is split into two or four
// 128-byte column blocks, each stored as a tile of its own (block b of
// an R-row tile at b * R * 128 bytes).
template <int D>
struct Rows {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "the bf16 bodies are 16, 32, 64, 128 or 256 columns wide");
  static constexpr int bytes = 2 * D;
  // the bytes of one row inside a column block, the block's columns,
  // and the blocks of a row
  static constexpr int atom = bytes < 128 ? bytes : 128;
  static constexpr int cols = atom / 2;
  static constexpr int blocks = D / cols;
  // k16 steps (32 bytes of a K-major row) inside one block
  static constexpr int ksteps = atom / 32;
  // the wgmma descriptor's layout type: 1 = 128B, 2 = 64B, 3 = 32B
  static constexpr uint64_t layout = atom == 128 ? 1 : atom == 64 ? 2 : 3;
  // the same swizzle as TMA names it
  static constexpr CUtensorMapSwizzle tma_swizzle =
      atom == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : atom == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                   : CU_TENSOR_MAP_SWIZZLE_32B;
};

// Whether the flash kernels take head dim d (kernel_takes_head_dim in
// ops/flash_attention.py is the same rule): a multiple of 8, so a row of
// d bf16 values is a multiple of TMA's 16-byte stride unit, from 8 to
// the widest body's 256.
inline bool takes_head_dim(int d) { return d % 8 == 0 && d >= 8 && d <= 256; }

// The one switch from a head dim to a flash body: calls
// f(std::integral_constant<int, W>{}) with W the smallest of 16, 32, 64,
// 128 and 256 that is at least d, and returns its result (the caller
// passes the real d on to the kernel at run time), or
// cudaErrorInvalidValue at a head dim the kernels do not take. The
// paged split body takes the same switch from 16 up.
template <typename F>
inline cudaError_t with_head_dim(int d, F&& f) {
  if (!takes_head_dim(d)) return cudaErrorInvalidValue;
  if (d <= 16) return f(std::integral_constant<int, 16>{});
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Dynamic shared memory rounded up to 1024 bytes: the widest swizzle
// repeats every 8 rows (1024 bytes) and both TMA and wgmma apply it on
// address bits, so every tile starts on such a boundary (every tile here
// is a multiple of 8 rows, so a tile after it does too).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// (Each mbarrier and TMA helper also takes a barrier or tile as its
// 32-bit shared address: code that runs in few registers keeps one base
// address, not a 64-bit pointer per barrier.)
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  mbar_expect_tx(smem_u32(bar), bytes);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// The low 32 bits of the global nanosecond timer.
__device__ __forceinline__ uint32_t globaltimer_lo() {
  uint32_t t;
  asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(t));
  return t;
}

// A wait longer than this traps (see mbar_wait): no phase of these
// kernels legitimately takes more than a millisecond.
constexpr uint32_t kWaitTrapNs = 4000000000u;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint32_t t0 = globaltimer_lo();
  uint32_t tries = 0;
  while (!mbar_try_wait(addr, parity)) {
    // every 1024 tries, check the clock (32-bit differences wrap
    // correctly across the timer's low word)
    if ((++tries & 1023u) == 0 && globaltimer_lo() - t0 > kWaitTrapNs)
      __trap();
  }
}

// mbar_wait without the watchdog, for the head-dim-128 and -256 bodies
// (the same reason at 256): a `trap`
// anywhere in their consumers' code makes ptxas serialize every wgmma
// ("C7512 ... insufficient register resources") and spill. Their CTA has
// a watchdog warp instead (`cta_watchdog`).
__device__ __forceinline__ void mbar_wait_spin(uint32_t addr,
                                               uint32_t parity) {
  while (!mbar_try_wait(addr, parity)) {
  }
}
__device__ __forceinline__ void mbar_wait_spin(uint64_t* bar,
                                               uint32_t parity) {
  mbar_wait_spin(smem_u32(bar), parity);
}

// The watchdog of a CTA whose warps wait with mbar_wait_spin: run by one
// otherwise idle warp, it waits (with mbar_wait's trap) on `done`, at
// which every consumer warp arrives once after its last store. A wait,
// mbarrier or named barrier, that never ends keeps `done` open, and the
// trap ends the kernel about 4 s after the CTA started.
__device__ __forceinline__ void cta_watchdog(uint64_t* done) {
  mbar_wait(done, 0);
}

// ------------------------------------------------------------------ TMA
// The box at coordinates (c0, c1, c2) = (column, row, slab) of `map`
// into shared memory at `dst`; completes the box's bytes on `bar`. Rows
// and columns past the map's extents arrive as zeros, and count in the
// box's bytes all the same.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The tile of R rows starting at row r0 of slab `slab` of `map` into
// `dst`, one box per column block (block b at dst + b * R * atom);
// completes R * 2 * D bytes on `bar`. One thread issues it.
template <int D, int R>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int r0,
                                              int slab) {
#pragma unroll
  for (int b = 0; b < Rows<D>::blocks; ++b)
    tma_load_3d(dst + b * R * Rows<D>::atom, map, bar, b * Rows<D>::cols,
                r0, slab);
}
template <int D, int R>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int r0,
                                              int slab) {
  tma_load_tile<D, R>(smem_u32(dst), map, smem_u32(bar), r0, slab);
}

// ------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 4 bytes from device memory into shared memory at `dst`, or 4 zero
// bytes where `in` is false (a source size of 0 reads nothing).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
// One arrival at the mbarrier `bar` once every cp.async this thread has
// issued so far has landed (`cp.async.mbarrier.arrive.noinc`: the
// barrier's expected count includes this arrival).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for register A fragments an asynchronous product still reads:
// placed after its wait, it keeps them live (and unwritten) until then.
template <int K>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// Descriptor of a column block of a shared tile of head_dim-D rows
// (`Rows<D>::atom` bytes a row) in the swizzle of that width: start
// address >> 4 (bits 0-13); leading and stride byte offsets (bits 16-29,
// 32-45) both 8 rows (8 * atom bytes) >> 4, the step between 8-row
// groups (the leading offset is unused by every product here: a K-major
// k16 step stays inside one block, and an MN-major operand is read one
// block, at most 64 columns, per product); layout type (bits 62-63)
// from `Rows<D>`. A K-major operand steps along K by 32 bytes (+2; see
// `desc_k`), an MN-major one by 16 rows (+atom).
template <int D>
__device__ __forceinline__ uint64_t desc_sw(const void* tile) {
  constexpr uint64_t group = 8 * Rows<D>::atom;
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFFu) >> 4) |
         ((group >> 4) << 16) | ((group >> 4) << 32) |
         (Rows<D>::layout << 62);
}

// The descriptor of k step kk (head-dim columns 16kk .. 16kk + 15) of a
// K-major operand held in an R-row tile whose block 0 `desc` describes
// (desc_sw of the operand's first row): block kk / ksteps, 32 bytes a
// step inside it.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint64_t desc, int kk) {
  constexpr int S = Rows<D>::ksteps;
  return desc + static_cast<uint64_t>(((kk / S) * R * Rows<D>::atom) >> 4) +
         static_cast<uint64_t>(2 * (kk % S));
}

// Byte offset of 16-byte chunk `chunk` (columns 8 * chunk ..) of row
// `row` in a swizzled tile of R head_dim-D rows (the tile starts on a
// 1024-byte boundary; chunk / (atom / 16) picks the column block).
template <int D, int R>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int kAtom = Rows<D>::atom, kChunks = kAtom / 16;
  const int off = row * kAtom + (chunk % kChunks) * 16;
  return (chunk / kChunks) * R * kAtom +
         (off ^ (((off >> 7) & (kChunks - 1)) << 4));
}

// D (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), bf16 in, both from
// shared memory K-major (no transpose); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32, f32) (+)= A (64 x 16) . B (16 x 32), bf16 in, both from
// shared memory K-major (no transpose); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16) . B (16 x 128), bf16 in, both from
// shared memory K-major (no transpose); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x N) (+)= A (64 x 16) . B (16 x N), both K-major from shared
// memory, for N = 32, 64, 128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  else
    wgmma_ss_n32(d, desc_a, desc_b, scale_d);
}

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64), bf16 in: A from
// registers (the fragment `pack_a` makes), B from shared memory stored
// MN-major (N contiguous), so its transpose bit is set. D is registers
// O .. O + 31 of the accumulator `d`.
template <int O = 0, int R>
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[R],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  static_assert(O >= 0 && O + 32 <= R, "32 accumulator registers");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64), bf16 in, both from
// shared memory: A K-major, B MN-major (its transpose bit set). D is
// registers O .. O + 31 of the accumulator `d`.
template <int O = 0, int R>
__device__ __forceinline__ void wgmma_ss_n64_tb(float (&d)[R],
                                               uint64_t desc_a,
                                               uint64_t desc_b) {
  static_assert(O >= 0 && O + 32 <= R, "32 accumulator registers");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), bf16 in: A from
// registers (the fragment layout of `pack_a`), B from shared memory
// K-major (no transpose); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// The same at N = 32 (head_dim 32): D 64 x 32.
__device__ __forceinline__ void wgmma_rs_n32_tb(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The same at N = 16 (head_dim 16): D 64 x 16.
__device__ __forceinline__ void wgmma_rs_n16_tb(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x D) += A (64 x 16, registers) . B (16 x D): rows 16kk ..
// 16kk + 15 of an MN-major R-row tile of head_dim-D rows whose block 0
// `desc` describes, for the products whose N is the head dim. At D 128
// and 256 one n64 product per column block, block b into accumulator
// registers 32b .. 32b + 31.
template <int D, int R>
__device__ __forceinline__ void wgmma_rs_rows(float (&d)[D / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int kk) {
  constexpr uint64_t kAtom = Rows<D>::atom;  // 16 rows, in 16-byte units
  const uint64_t step = kAtom * static_cast<uint64_t>(kk);
  if constexpr (D == 256) {
    wgmma_rs_n64_tb<0>(d, a, desc + step);
    wgmma_rs_n64_tb<32>(d, a, desc + ((R * kAtom) >> 4) + step);
    wgmma_rs_n64_tb<64>(d, a, desc + ((2 * R * kAtom) >> 4) + step);
    wgmma_rs_n64_tb<96>(d, a, desc + ((3 * R * kAtom) >> 4) + step);
  } else if constexpr (D == 128) {
    wgmma_rs_n64_tb<0>(d, a, desc + step);
    wgmma_rs_n64_tb<32>(d, a, desc + ((R * kAtom) >> 4) + step);
  } else if constexpr (D == 64) {
    wgmma_rs_n64_tb(d, a, desc + step);
  } else if constexpr (D == 32) {
    wgmma_rs_n32_tb(d, a, desc + step);
  } else {
    wgmma_rs_n16_tb(d, a, desc + step);
  }
}

// wgmma_rs_rows at width 128 with A from shared memory (`desc_a`, one
// K-major k16 step): D (64 x 128) += A (64 x 16) . B (16 x 128), rows 16kk
// .. 16kk + 15 of an MN-major R-row tile whose block 0 `desc` describes.
template <int R>
__device__ __forceinline__ void wgmma_ss_rows128(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc, int kk) {
  constexpr uint64_t kAtom = Rows<128>::atom;
  const uint64_t step = kAtom * static_cast<uint64_t>(kk);
  wgmma_ss_n64_tb<0>(d, desc_a, desc + step);
  wgmma_ss_n64_tb<32>(d, desc_a, desc + ((R * kAtom) >> 4) + step);
}

// Orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads (a wgmma operand written by st.shared).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------ consumer sync
// Barrier `id` over the 256 threads of both consumer warpgroups (warps
// 0-7; the producer does not take part).
__device__ __forceinline__ void consumers_barrier(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// Arrive at barrier `id` over the two consumer warpgroups without
// waiting: the arriving warpgroup lets the other one pass its
// `consumers_barrier(id)`.
__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// ----------------------------------------------- register reallocation
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  static_assert(N >= 24 && N <= 256 && N % 8 == 0, "24..256, step 8");
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  static_assert(N >= 24 && N <= 256 && N % 8 == 0, "24..256, step 8");
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The register split of the 384-thread head-dim-128 bodies (see the note
// at the top; the head-dim-256 bodies take the same): the launch gives
// 168 a thread.
constexpr int kWideThreads = 3 * 128;
constexpr uint32_t kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <=
                  kWideThreads * 168,
              "the consumers ask for no more than the producer frees");

// This thread's warp index, which the compiler then knows is the same
// across the warp (a broadcast from lane 0): what derives from it (the
// warpgroup, its tiles' descriptors) can live in uniform registers and
// leaves the vector registers to the accumulators.
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
}

// ---------------------------------------------------- warpgroup sync
// Barrier `id` (1..15; 0 is __syncthreads) over the 128 threads of one
// warpgroup.
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---------------------------------------------------------------- math
// 2^x as one MUFU instruction (`ex2.approx.ftz.f32`): a result below
// 2^-126 flushes to 0, which no softmax weight here can tell from its
// neighbours; exp2f would add a range fix-up around the same instruction.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------- accumulator <-> fragments
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k step `kk` (accumulator columns 16kk .. 16kk+15)
// for an RS product: for 16-bit A the wgmma A layout is the D layout of
// those columns, two values per register.
template <int R>
__device__ __forceinline__ void pack_a(const float (&d)[R], int kk,
                                       uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// The A fragments of a warpgroup's 64 rows of a swizzled R-row tile of
// head_dim-D rows (`tile` is the first of the 64 rows in block 0), one
// per k16 step over the head dim, for RS products: the layout `pack_a`
// gives (rows 16w + t%32/4 and + 8, columns 16kk + 2(t%4), + 1 and
// those + 8), read once as 32-bit words.
template <int D, int R>
__device__ __forceinline__ void tile_to_frags(const uint8_t* tile,
                                              uint32_t (&a)[D / 16][4]) {
  const int t = threadIdx.x % 128, l = t % 32;
  const int r = 16 * (t / 32) + l / 4, off = 4 * (l % 4);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = *reinterpret_cast<const uint32_t*>(
          tile + swz<D, R>(r + 8 * (i % 2), 2 * kk + i / 2) + off);
}

// A 64 x D f32 accumulator, row r scaled by `lo` (rows 16w + t%32/4)
// or `hi` (those + 8), as bf16 into 64 rows of an R-row tile of
// head_dim-D rows in their swizzle (`swz<D, R>`; `tile` is the first of
// the 64 rows in block 0): at D 64 a warp's stores hit 32 distinct
// banks.
template <int D, int R>
__device__ __forceinline__ void acc_to_tile(const float (&d)[D / 2],
                                            float lo, float hi,
                                            uint8_t* tile) {
  const int t = threadIdx.x % 128, l = t % 32;
  const int r = 16 * (t / 32) + l / 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      const float s = h ? hi : lo;
      *reinterpret_cast<uint32_t*>(tile + swz<D, R>(row, j) + (l % 4) * 4) =
          pack_bf16(d[4 * j + 2 * h] * s, d[4 * j + 2 * h + 1] * s);
    }
}

// The warpgroup's 64 swizzled rows of an R-row tile (`tile` as in
// acc_to_tile) -> rows [0, limit) of `dst` (rows `ld` bf16 apart; the
// first d <= D of each row's tile columns, d a multiple of 8), 16 bytes
// per store, D/8 threads to a row: a thread whose chunk lies at or past
// column d stores nothing (the tile's columns there are the zeros of
// the filled columns), so no byte past a row's d values is written.
template <int D, int R>
__device__ __forceinline__ void tile_to_rows(const uint8_t* tile,
                                             __nv_bfloat16* dst, int limit,
                                             int d, int ld) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per tile row
  const int t = threadIdx.x % 128, chunks = d / 8;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int idx = t + 128 * i, row = idx / kChunks, c = idx % kChunks;
    if (row < limit && c < chunks)
      *reinterpret_cast<uint4*>(dst + (size_t)row * ld + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D, R>(row, c));
  }
}
template <int D, int R>
__device__ __forceinline__ void tile_to_rows(const uint8_t* tile,
                                             __nv_bfloat16* dst, int limit,
                                             int d) {
  tile_to_rows<D, R>(tile, dst, limit, d, d);
}

// ------------------------------------------------------ host: tensor maps
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a contiguous (slabs, rows, d) bf16 tensor as dims (d, rows,
// slabs) for a body of width D >= d: boxes of one column block x
// box_rows x 1 (`Rows<D>::cols` columns: D, or 64 at D 128 and 256) in the
// swizzle of `Rows<D>`. Columns past d and rows past `rows` of a slab
// read as zeros (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE fills with zeros; the
// NaN fill would poison the products), and a box still completes its
// whole size in bytes on its mbarrier. `base` must be 16-byte aligned
// and d a multiple of 8 (the row stride, 2*d bytes, a multiple of 16).
template <int D>
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base, int d,
                                   int rows, int slabs, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (d > D || !takes_head_dim(d)) return cudaErrorInvalidValue;
  const cuuint64_t row_bytes = 2 * (cuuint64_t)d;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {row_bytes, (cuuint64_t)rows * row_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)Rows<D>::cols,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         Rows<D>::tma_swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace etpu
