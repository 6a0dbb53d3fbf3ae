// Causal GQA flash attention (backward), the Hopper route for bf16: wgmma
// on TMA-fed tiles in two deterministic passes.
//
// Replaces, as flash_attention_bwd.cu does, the reference's hand-written
// jnp backward src/repro/models/attention.py::_flash_bwd_impl (:134); the
// JAX package has no Pallas backward. Its function is that file's (and
// ref.flash_attention_bwd_ref's), q and k of head dim D, v, out and dout of
// their own DV (the head-dim pairs (D, D) and MLA's (192, 128)): with
// s = (q_i . k_j) D^-1/2 and a key
// visible when j < Sk, j <= q_offset + i (causal) and j > q_offset + i -
// window,
//
//   delta_i = sum_d dout_id out_id
//   p_ij    = exp(min(s_ij - lse_i, 30)), 0 where masked
//   dv_j    = sum_i p_ij dout_i          (summed over the G query heads
//   ds_ij   = p_ij (dout_i . v_j - delta_i) D^-1/2     of the KV head)
//   dq_i    = sum_j ds_ij k_j
//   dk_j    = sum_i ds_ij q_i
//
// in f32, with P and dS rounded to bf16 before their second products, as
// the mma.sync kernels of flash_attention_bwd.cu (the comparison route)
// round them, and the gradients written in bf16.
//
// What bounds it: at stablelm's training shape (B = 2, S = 4,096, 32 heads
// of 64) the function is 10 D operations per visible (query, key) pair
// against 8 D bf16 elements read and written per row, so operations bound
// it (0.348 ms of bf16 tensor-core time against 0.08 ms of bytes on an
// H100). The two passes below recompute Q K^T and dO V^T, 14 D operations
// per visible pair (8 D + 6 DV), so the design's own floor is 1.4 times
// that bound (1.38 at (192, 128), whose bound is 6 D + 4 DV a pair).
// The mma.sync kernels reach the tensor cores through warp-level mma.sync
// on tiles staged by plain loads, with transposed copies of Q, dO and K
// written at load time, and run 14.6 times the bound. This design:
// - three launches a call: flash_bwd_delta_kernel (the mma.sync route's
//   delta kernel, one warp a row) also writes lse x log2 e, both in a
//   (B, H, Sq rounded up to 64) layout, so that a query tile's lse and
//   delta values are one contiguous run for a bulk copy; then the
//   dK/dV pass, then the dQ pass. No atomics: each gradient element is
//   summed by one thread in a fixed order, so two calls on the same inputs
//   give the same bits;
// - every block is two consumer warpgroups (wgmma's M = 64 rows each) and
//   one producer warpgroup, whose first lane issues every load: TMA boxes
//   of 64 rows from 4-D maps (D, heads, S, B) over the model layout, rows
//   past S arriving as zeros, each tile in the swizzle of its row (32, 64
//   or 128 bytes, one column block per 64 of D) and completing on an
//   mbarrier; a ring of STAGES stages with full and empty mbarriers.
//   setmaxnreg gives the consumers 240 registers a thread and the producer
//   24;
// - dK/dV: one block per (128 keys, KV head, batch), key block 0 (the
//   heaviest under the causal mask) first. K and V stay resident in shared
//   memory; the producer streams, for each of the G query heads and each
//   live query tile of QT rows, the Q and dO tiles and the tile's lse and
//   delta. QT is what the consumer's registers allow (Pair::QT): a thread
//   holds dK (D / 2 f32) and dV (DV / 2) for the whole walk, and per tile
//   S^T, dP^T (QT / 2 each) and the bf16 P^T, dS^T (QT / 4 each). 64 rows
//   fit setmaxnreg's 240 up to D + DV = 256; at MLA's (192, 128) they
//   would take 256, so it streams tiles of 32 rows (208: S^T and dP^T are
//   m64n32, dV += P^T dO and dK += dS^T Q two k16 steps a tile) in 6
//   stages, as many bytes in flight as 3 of 64 rows; (192, 192) streams 16
//   rows (216). Each consumer warpgroup owns 64 keys: S^T = K Q^T and
//   dP^T = V dO^T are wgmmas with B (Q, dO) K-major from the streamed
//   tile, the second issued before the first is waited on, so that it
//   runs under the first's exponentials; P^T and dS^T are computed on the
//   accumulator registers and rounded to bf16 pairs in the register-A
//   layout, and dV += P^T dO and dK += dS^T Q are RS wgmmas whose B
//   operand (dO, Q) is read MN-major from the same swizzled tile: no
//   transposed copy exists;
// - dQ: one block per (128 query rows, head, batch), the last query tile
//   first; Q and dO resident, K and V streamed in 64-key tiles: S = Q K^T
//   and dP = dO V^T with B (K, V) K-major, dQ += dS K as an RS wgmma with
//   K read MN-major (dQ 96 f32 a thread at D = 192, 176 with the tile's
//   products); 3 stages where they fit, 2 at (192, 192);
// - the resident operand of S and dP (K and V in dK/dV, Q and dO in dQ)
//   is, at D <= 64, read once out of its swizzled tile into registers (16
//   a thread each) and fed to RS wgmmas: an SS m64n64k16 reads as many
//   shared-memory bytes (4 KB) as the tensor cores' 32 clocks for it can
//   take at 128 bytes a clock, and the register operand halves that; at
//   D >= 128 (64 more registers a thread) both stay SS;
// - the live tiles: a dQ block walks the key tiles that hold a key one of
//   its real rows sees, a dK/dV block the query tiles that hold a row that
//   sees one of its keys, in tiles of QT rows (flash_attention.py mirrors
//   both walks for the CPU tests). Each visible pair falls in one visited
//   tile of each pass, and no visited tile is wholly masked;
// - the mask runs on the accumulator registers only for a tile that the
//   diagonal, the window's edge, or the end of S crosses; p is
//   exp2(min(s scale log2 e - lse log2 e, 30 log2 e)), one fma and ex2.
// - each width (D for Q and K, DV for V and dO) is read through its own
//   map in its own column blocks of 64; Q and dO in boxes of QT rows, K
//   and V of 64.
// The wgmma, TMA and mbarrier helpers, the tensor-map encoder lookup and
// the 1024-byte alignment of the swizzled tiles are flash_attention.cu's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;  // rows of a streamed tile and of a warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float CLAMP_LOG2 = 30.f * LOG2E;  // the reference's min(., 30)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

constexpr int WGS = 2;                 // consumer warpgroups
constexpr int BIG = WGS * TILE;        // rows of a resident tile
constexpr int THREADS = 128 * (WGS + 1);
constexpr int MAX_SMEM = 232448;       // a block's shared memory on an H100

// Layout of one tile width W (a head dim). A tile row of DB <= 64 bf16
// columns is 32, 64 or 128 bytes, which is the TMA swizzle width and the
// wgmma layout (B32, B64, B128); W = 128 and W = 192 are two and three
// such column blocks side by side.
template <int W>
struct Geo {
  static constexpr int DB = W < 64 ? W : 64;
  static constexpr int NB = W / DB;
  static constexpr int ROW = DB * 2;
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
};

// Shared memory and tiles of the head-dim pair (D, DV): q, k of width D,
// v, out, dout of width DV.
template <int D, int DV>
struct Pair {
  // query rows of a streamed dK/dV tile. A dK/dV consumer thread holds dK
  // (D / 2 f32), dV (DV / 2) and, per tile of QT query rows, S^T and dP^T
  // (QT / 2 each) and P^T, dS^T as bf16 A fragments (QT / 4 each): 64
  // rows keep that within setmaxnreg's 240 up to D + DV = 256; MLA's
  // (192, 128) streams 32 rows (208), (192, 192) 16 (216)
  static constexpr int QT = D + DV <= 256 ? 64 : D + DV <= 320 ? 32 : 16;
  // the same bytes in flight as 3 stages of 64 rows
  static constexpr int DKDV_STAGES = QT == 64 ? 3 : 6;
  static constexpr int RES = BIG * (D + DV) * 2;  // K and V; Q and dO
  // one dK/dV stage: Q and dO tiles of QT rows, then the lse and delta
  // vectors of the tile's rows (f32); one dQ stage: K and V tiles
  static constexpr int DKDV_TILES = QT * (D + DV) * 2;
  static constexpr int VEC_BYTES = QT * 4;
  static constexpr int DQ_TILES = TILE * (D + DV) * 2;
  // 1 KB of slack to align the tiles to the 1024-byte swizzle atom, the
  // two resident tiles, the stages (dK/dV: the tiles of every stage, then
  // the vectors of every stage), then the mbarriers; the dQ pass takes 3
  // stages where they fit, else 2 ((192, 192))
  static constexpr int DKDV =
      1024 + RES + DKDV_STAGES * (DKDV_TILES + 2 * VEC_BYTES) + 128;
  static constexpr int DQ_STAGES =
      1024 + RES + 3 * DQ_TILES + 128 <= MAX_SMEM ? 3 : 2;
  static constexpr int DQ = 1024 + RES + DQ_STAGES * DQ_TILES + 128;
  // a resident operand in registers (the A of S and dP) at D <= 64
  static constexpr bool AREG = D <= 64 && DV == D;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of ``bar`` with parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D map (D, heads, S, B) into shared memory; rows past
// the tensor's end arrive as zeros. Completion goes to ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// A contiguous run of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) from global into shared memory; completion goes to ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin the accumulator registers at this point of the program: reads after
// wgmma_wait() may not move above it, writes before a wgmma not below it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// D (m64 x n) += A (m64 x k16) B (k16 x n), bf16 in, f32 accumulators in
// the thread layout of mma.m16n8: warp w of the warpgroup holds rows
// 16 w + lane / 4 (+ 8), and for each n8 chunk j the columns
// 8 j + 2 (lane % 4) (+ 1), as d[4 j + {0, 1, 2, 3}] = (r, c), (r, c + 1),
// (r + 8, c), (r + 8, c + 1). SS: A and B from shared memory, both
// K-major. RS: A from registers (the mma.m16n8k16 A fragment per warp), B
// MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_m64n64(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_m64n16(
    float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_m64n32(
    float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_m64n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// The same with B K-major: acc (m64 x n64) += A (registers) B^T, B rows
// K-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n64_kb(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_m64n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_m64n192(
    float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// acc (m64 x N) += A (m64 x k16, registers) B (k16 x N, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&acc)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_m64n16(acc, a, db);
  if constexpr (N == 32) wgmma_rs_m64n32(acc, a, db);
  if constexpr (N == 64) wgmma_rs_m64n64(acc, a, db);
  if constexpr (N == 128) wgmma_rs_m64n128(acc, a, db);
  if constexpr (N == 192) wgmma_rs_m64n192(acc, a, db);
}

__device__ __forceinline__ void wgmma_ss_m64n16(
    float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_ss_m64n32(
    float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// acc (m64 x N) = A (m64 x k16) B^T (N x k16), both K-major in shared
// memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&acc)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_ss_m64n16(acc, da, db, scale_d);
  if constexpr (N == 32) wgmma_ss_m64n32(acc, da, db, scale_d);
  if constexpr (N == 64) wgmma_ss_m64n64(acc, da, db, scale_d);
}

// acc (m64 x N) = A (m64 x W) B^T (N x W): A rows of ``a`` (rows of
// ``a_rows`` per column block), B rows of ``b`` (N per column block), both
// K-major, in k16 steps (32 bytes along a swizzled row)
template <int W, int N>
__device__ __forceinline__ void wgmma_abt(float (&acc)[N / 2], uint32_t a,
                                          int a_rows, uint32_t b) {
  using Gm = Geo<W>;
  constexpr int ROW = Gm::ROW, DB = Gm::DB;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const int cb = kk * 16 / DB, cofs = (kk * 16 % DB) * 2;
    wgmma_ss<N>(
        acc, gmma_desc(a + cb * a_rows * ROW + cofs, 16, 8 * ROW, Gm::LAYOUT),
        gmma_desc(b + cb * N * ROW + cofs, 16, 8 * ROW, Gm::LAYOUT), kk > 0);
  }
}

// acc (m64 x n64) = A (m64 x D, the bf16 fragments ``a``, one per k16
// step) B^T (n64 x D), B rows of ``b`` K-major as in wgmma_abt
template <int D>
__device__ __forceinline__ void wgmma_abt_rs(float (&acc)[32],
                                             const uint32_t (&a)[D / 16][4],
                                             uint32_t b) {
  using Gm = Geo<D>;
  constexpr int ROW = Gm::ROW, DB = Gm::DB;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int cb = kk * 16 / DB, cofs = (kk * 16 % DB) * 2;
    wgmma_rs_m64n64_kb(
        acc, a[kk],
        gmma_desc(b + cb * TILE * ROW + cofs, 16, 8 * ROW, Gm::LAYOUT),
        kk > 0);
  }
}

// The A fragments (one per k16 step over D) of the warp's 16 rows
// r0 .. r0 + 15 of a resident tile (``rows`` rows per column block) that TMA
// wrote in the swizzle of its row: byte bits 7.. of an offset within the
// 1024-aligned tile pick the 16-byte chunk, XOR-ed into bits 4..
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&a)[D / 16][4],
                                           const uint8_t* tile, int rows,
                                           int r0, int g, int t) {
  using Gm = Geo<D>;
  constexpr int ROW = Gm::ROW, DB = Gm::DB;
  constexpr uint32_t SWZ = ROW == 128 ? 7 : ROW == 64 ? 3 : 1;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kk * 16 + 8 * (e >> 1) + 2 * t, row = r0 + g + 8 * (e & 1);
      const uint32_t o = (col / DB) * rows * ROW + row * ROW + (col % DB) * 2;
      a[kk][e] = *reinterpret_cast<const uint32_t*>(
          tile + (o ^ (((o >> 7) & SWZ) << 4)));
    }
}

// acc (m64 x W) += A (m64 x K, the bf16 fragments ``a``) B (K x W), B
// read MN-major from a streamed tile of K rows at ``b`` whose column blocks
// lie K rows apart
template <int W, int K>
__device__ __forceinline__ void wgmma_ab(float (&acc)[W / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b) {
  using Gm = Geo<W>;
  constexpr int ROW = Gm::ROW;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<W>(acc, a[kk],
                gmma_desc(b + kk * 16 * ROW, K * ROW, 8 * ROW, Gm::LAYOUT));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x N accumulator (rows of the warpgroup, k = its columns) as the
// bf16 A fragments of its N / 16 k16 steps
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 16][4],
                                         const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// The key tiles (of TILE keys) [kt0, kt0 + count) that the real query
// rows [q0, min(q0 + rows, Sq)) see: the keys visible from them form one
// run, from the first row's window edge to the last row's diagonal.
__device__ __forceinline__ int live_key_tiles(int q0, int rows, int Sq,
                                              int Sk, int causal, int window,
                                              int q_offset, int& kt0) {
  const int qa = q_offset + q0, qb = q_offset + min(q0 + rows, Sq) - 1;
  const int kmin = window > 0 ? max(0, qa - window + 1) : 0;
  const int kmax = causal ? min(Sk - 1, qb) : Sk - 1;
  kt0 = kmin / TILE;
  return kmin > kmax ? 0 : kmax / TILE + 1 - kt0;
}

// The query tiles (of QT rows) [qt0, qt0 + count) that hold a row seeing
// one of the real keys [k0, min(k0 + keys, Sk)): rows from the first key's
// diagonal to the last key's window edge.
template <int QT>
__device__ __forceinline__ int live_query_tiles(int k0, int keys, int Sq,
                                                int Sk, int causal,
                                                int window, int q_offset,
                                                int& qt0) {
  const int kb = min(k0 + keys, Sk) - 1;
  const int rmin = causal ? max(0, k0 - q_offset) : 0;
  const int rmax =
      window > 0 ? min(Sq - 1, kb + window - 1 - q_offset) : Sq - 1;
  qt0 = rmin / QT;
  return rmin > rmax ? 0 : rmax / QT + 1 - qt0;
}

// delta = rowsum(dout * out) over the DV columns, one warp a row (the
// mma.sync route's delta kernel), here written with lse x log2 e into a
// (B, H, Sq_pad) layout, zeros past Sq
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ o,
                                       const bf16* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       float* __restrict__ lse_t,
                                       float* __restrict__ delta_t, int B,
                                       int Sq, int Sq_pad, int H, int DV) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * H * Sq_pad) return;  // whole warps leave together
  const int s = (int)(row % Sq_pad);
  const long long bh = row / Sq_pad;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float acc = 0.f, l = 0.f;
  if (s < Sq) {
    const long long src = ((long long)b * Sq + s) * H + h;
    const bf16* orow = o + src * DV;
    const bf16* drow = dout + src * DV;
    for (int d = lane; d < DV; d += 32)
      acc = fmaf(__bfloat162float(orow[d]), __bfloat162float(drow[d]), acc);
    l = lse[src] * LOG2E;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta_t[row] = acc;
    lse_t[row] = l;
  }
}

// dK/dV. Grid (KH, B, key blocks), key block 0 first. Warps 0-7 are two
// consumer warpgroups of 64 keys each; warpgroup 2 is the producer, whose
// first lane loads K and V once and streams (Q, dO, lse, delta) for each
// query head of the group and each live query tile of QT rows.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse_t,
                                const float* __restrict__ delta_t,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int Sq, int Sq_pad, int Sk, int H, int KH,
                                int causal, int window, int q_offset,
                                float scale) {
  using Gk = Geo<D>;
  using Gv = Geo<DV>;
  using Pr = Pair<D, DV>;
  constexpr int ROW = Gk::ROW, DB = Gk::DB, VROW = Gv::ROW, VDB = Gv::DB;
  constexpr int ST = Pr::DKDV_STAGES, QT = Pr::QT;
  constexpr int Q_BYTES = QT * D * 2;  // a streamed Q tile; dO follows
  constexpr int CONSUMER_WARPS = 4 * WGS;
  constexpr bool AREG = Pr::AREG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sk = base, sv = sk + BIG * D * 2;  // resident K, V
  const uint32_t stages = sv + BIG * DV * 2;  // stage s: Q then dO
  const uint32_t vecs = stages + ST * Pr::DKDV_TILES;  // stage s: lse, delta
  const uint32_t bars = vecs + ST * 2 * Pr::VEC_BYTES;
  const uint32_t kvbar = bars;  // K and V landed
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BIG;
  const int G = H / KH;
  int qt0;
  const int nq =
      live_query_tiles<QT>(k0, BIG, Sq, Sk, causal, window, q_offset, qt0);
  const int n_tiles = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producer ----
    regs_down<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      // the boxes that hold a key (the rest stay unwritten: their rows only
      // reach the gradients of keys past Sk, which are not stored)
      const int rows = min(BIG, (Sk - k0 + TILE - 1) / TILE * TILE);
      mbar_expect_tx(kvbar, rows * (D + DV) * 2);
      for (int r = 0; r < rows; r += TILE) {
        for (int cb = 0; cb < Gk::NB; ++cb)
          tma_load(sk + cb * BIG * ROW + r * ROW, &tk, kvbar, cb * DB, kh,
                   k0 + r, b);
        for (int cb = 0; cb < Gv::NB; ++cb)
          tma_load(sv + cb * BIG * VROW + r * VROW, &tv, kvbar, cb * VDB, kh,
                   k0 + r, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST, h = kh * G + i / nq;
        const int q0 = (qt0 + i % nq) * QT;
        mbar_wait(empty(s), ((i / ST) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full(s), Pr::DKDV_TILES + 2 * Pr::VEC_BYTES);
        const uint32_t qs = stages + s * Pr::DKDV_TILES;
        for (int cb = 0; cb < Gk::NB; ++cb)
          tma_load(qs + cb * QT * ROW, &tq, full(s), cb * DB, h, q0, b);
        for (int cb = 0; cb < Gv::NB; ++cb)
          tma_load(qs + Q_BYTES + cb * QT * VROW, &tdo, full(s), cb * VDB, h,
                   q0, b);
        const long long at = ((long long)b * H + h) * Sq_pad + q0;
        const uint32_t vs = vecs + s * 2 * Pr::VEC_BYTES;
        bulk_load(vs, lse_t + at, Pr::VEC_BYTES, full(s));
        bulk_load(vs + Pr::VEC_BYTES, delta_t + at, Pr::VEC_BYTES, full(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. k0 + 64 wg + 63 ----
  regs_up<CONSUMER_REGS>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int kr = wg * TILE + (warp & 3) * 16 + g;  // and kr + 8
  // the query rows that see key r: qlo[r] <= row <= qhi[r]
  int qlo[2], qhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + 8 * r;
    qlo[r] = causal ? key - q_offset : 0;
    qhi[r] = key >= Sk ? -1
             : window > 0 ? min(Sq - 1, key + window - 1 - q_offset)
                          : Sq - 1;
  }
  const float* vec = reinterpret_cast<const float*>(smem_raw + (vecs - raw));
  const float scale_log2 = scale * LOG2E;
  float dka[D / 2], dva[DV / 2], s[QT / 2], dp[QT / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < QT / 2; ++i) s[i] = dp[i] = 0.f;
  const uint32_t kw = sk + wg * TILE * ROW, vw = sv + wg * TILE * VROW;

  mbar_wait(kvbar, 0);
  // at D <= 64 the warpgroup's K and V rows stay in registers as the A
  // operands of S^T and dP^T (16 registers each), which halves the shared
  // memory those products read
  uint32_t kf[D / 16][4], vf[D / 16][4];
  if constexpr (AREG) {
    const int r0 = wg * TILE + (warp & 3) * 16;
    load_frags<D>(kf, smem_raw + (sk - raw), BIG, r0, g, t);
    load_frags<D>(vf, smem_raw + (sv - raw), BIG, r0, g, t);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % ST, q0 = (qt0 + i % nq) * QT;
    const uint32_t qs = stages + st * Pr::DKDV_TILES, dos = qs + Q_BYTES;
    mbar_wait(full(st), (i / ST) & 1);

    // S^T = K Q^T, then dP^T = V dO^T, the second running under the
    // first's exponentials
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if constexpr (AREG)
      wgmma_abt_rs<D>(s, kf, qs);
    else
      wgmma_abt<D, QT>(s, kw, BIG, qs);
    wgmma_commit();
    if constexpr (AREG)
      wgmma_abt_rs<D>(dp, vf, dos);
    else
      wgmma_abt<DV, QT>(dp, vw, BIG, dos);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P^T: key rows, query columns q0 + 8 j + 2 t (+ 1)
    const float* L = vec + st * 2 * QT;
    const float* E = L + QT;
    const bool inside = q0 >= qlo[0] && q0 >= qlo[1] &&
                        q0 + QT - 1 <= qhi[0] && q0 + QT - 1 <= qhi[1];
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(L + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fminf(fmaf(s[4 * j + e], scale_log2,
                                 -((e & 1) ? l2.y : l2.x)),
                            CLAMP_LOG2));
        const int row = q0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
        if (!inside && !(row >= qlo[r] && row <= qhi[r])) p = 0.f;
        s[4 * j + e] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS^T = P^T (dP^T - delta) D^-1/2
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(E + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] =
            s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * scale;
    }
    uint32_t pa[QT / 16][4], da[QT / 16][4];
    to_frags<QT>(pa, s);
    to_frags<QT>(da, dp);

    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    wgmma_ab<DV, QT>(dva, pa, dos);
    wgmma_ab<D, QT>(dka, da, qs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + 8 * r;
    if (key >= Sk) continue;
    const long long row = ((long long)b * Sk + key) * KH + kh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dk + row * D + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dv + row * DV + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
  }
}

// dQ. Grid (H, B, query blocks), the last query block first. Warps 0-7
// are two consumer warpgroups of 64 query rows each; warpgroup 2 is the
// producer, whose first lane loads Q and dO once and streams the live
// (K, V) tiles in ascending order.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse_t,
                              const float* __restrict__ delta_t,
                              bf16* __restrict__ dq, int Sq, int Sq_pad,
                              int Sk, int H, int KH, int causal, int window,
                              int q_offset, float scale) {
  using Gk = Geo<D>;
  using Gv = Geo<DV>;
  using Pr = Pair<D, DV>;
  constexpr int ROW = Gk::ROW, DB = Gk::DB, VROW = Gv::ROW, VDB = Gv::DB;
  constexpr int ST = Pr::DQ_STAGES, QT = Pr::QT;
  constexpr int K_BYTES = TILE * D * 2;  // a streamed K tile; V follows
  constexpr int CONSUMER_WARPS = 4 * WGS;
  constexpr bool AREG = Pr::AREG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base, sdo = sq + BIG * D * 2;  // resident Q, dO
  const uint32_t stages = sdo + BIG * DV * 2;  // stage s: K then V
  const uint32_t bars = stages + ST * Pr::DQ_TILES;
  const uint32_t qbar = bars;  // Q and dO landed
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / (H / KH);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BIG;
  int kt0;
  const int n_tiles =
      live_key_tiles(q0, BIG, Sq, Sk, causal, window, q_offset, kt0);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producer ----
    regs_down<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      // the 64-row slices that hold a query row (rows past Sq are not
      // stored), in the Q and dO maps' boxes of QT rows
      const int rows = min(BIG, (Sq - q0 + TILE - 1) / TILE * TILE);
      mbar_expect_tx(qbar, rows * (D + DV) * 2);
      for (int r = 0; r < rows; r += QT) {
        for (int cb = 0; cb < Gk::NB; ++cb)
          tma_load(sq + cb * BIG * ROW + r * ROW, &tq, qbar, cb * DB, h,
                   q0 + r, b);
        for (int cb = 0; cb < Gv::NB; ++cb)
          tma_load(sdo + cb * BIG * VROW + r * VROW, &tdo, qbar, cb * VDB, h,
                   q0 + r, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST, k0 = (kt0 + i) * TILE;
        mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), Pr::DQ_TILES);
        const uint32_t ks = stages + s * Pr::DQ_TILES;
        for (int cb = 0; cb < Gk::NB; ++cb)
          tma_load(ks + cb * TILE * ROW, &tk, full(s), cb * DB, kh, k0, b);
        for (int cb = 0; cb < Gv::NB; ++cb)
          tma_load(ks + K_BYTES + cb * TILE * VROW, &tv, full(s), cb * VDB,
                   kh, k0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63 ----
  regs_up<CONSUMER_REGS>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int qr = wg * TILE + (warp & 3) * 16 + g;  // and qr + 8
  // the keys row r sees: lo[r] < key <= hi[r]; its lse x log2 e and delta
  int lo[2], hi[2];
  float L[2], E[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + 8 * r, qp = q_offset + row;
    const bool real = row < Sq;
    hi[r] = !real ? -1 : causal ? min(qp, Sk - 1) : Sk - 1;
    lo[r] = window > 0 ? qp - window : -1;
    const long long at = ((long long)b * H + h) * Sq_pad + row;
    L[r] = real ? lse_t[at] : 0.f;
    E[r] = real ? delta_t[at] : 0.f;
  }
  const float scale_log2 = scale * LOG2E;
  float dqa[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const uint32_t qw = sq + wg * TILE * ROW, ow = sdo + wg * TILE * VROW;

  mbar_wait(qbar, 0);
  // at D <= 64 the warpgroup's Q and dO rows stay in registers as the A
  // operands of S and dP
  uint32_t qf[D / 16][4], of[D / 16][4];
  if constexpr (AREG) {
    const int r0 = wg * TILE + (warp & 3) * 16;
    load_frags<D>(qf, smem_raw + (sq - raw), BIG, r0, g, t);
    load_frags<D>(of, smem_raw + (sdo - raw), BIG, r0, g, t);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % ST, k0 = (kt0 + i) * TILE;
    const uint32_t ks = stages + st * Pr::DQ_TILES, vs = ks + K_BYTES;
    mbar_wait(full(st), (i / ST) & 1);

    // S = Q K^T, then dP = dO V^T
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if constexpr (AREG)
      wgmma_abt_rs<D>(s, qf, ks);
    else
      wgmma_abt<D, TILE>(s, qw, BIG, ks);
    wgmma_commit();
    if constexpr (AREG)
      wgmma_abt_rs<D>(dp, of, vs);
    else
      wgmma_abt<DV, TILE>(dp, ow, BIG, vs);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P: query rows, key columns k0 + 8 j + 2 t (+ 1)
    const bool inside = k0 > lo[0] && k0 > lo[1] && k0 + TILE - 1 <= hi[0] &&
                        k0 + TILE - 1 <= hi[1];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = k0 + 8 * j + 2 * t + (e & 1);
        float p = ex2(fminf(fmaf(s[4 * j + e], scale_log2, -L[r]),
                            CLAMP_LOG2));
        if (!inside && !(key > lo[r] && key <= hi[r])) p = 0.f;
        s[4 * j + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - delta) D^-1/2
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - E[e >> 1]) * scale;
    uint32_t da[TILE / 16][4];
    to_frags<TILE>(da, dp);

    // dQ += dS K, K read MN-major
    fence_regs(dqa);
    wgmma_fence();
    wgmma_ab<D, TILE>(dqa, da, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + 8 * r;
    if (row >= Sq) continue;
    const long long off = (((long long)b * Sq + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + 8 * j) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so that the library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A contiguous (B, S, heads, W) array as a 4-D map (W, heads, S, B) whose
// box is (DB, 1, rows, 1).
template <int W>
bool make_map(CUtensorMap* map, const void* ptr, int heads, int S, int B,
              int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  constexpr int DB = Geo<W>::DB;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  // byte strides of heads, rows and batches
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)heads * W * 2,
                                 (cuuint64_t)S * heads * W * 2};
  const cuuint32_t box[4] = {(cuuint32_t)DB, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = DB == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : DB == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The three launches of one backward at the head-dim pair (D, DV). Q and
// dO are read in boxes of the dK/dV pass's QT rows, K and V in 64.
template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* lse_t, float* delta_t,
           void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  using Pr = Pair<D, DV>;
  const int Sq_pad = (Sq + TILE - 1) / TILE * TILE;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map<D>(&tq, q, H, Sq, B, Pr::QT) ||
      !make_map<D>(&tk, k, KH, Sk, B, TILE) ||
      !make_map<DV>(&tv, v, KH, Sk, B, TILE) ||
      !make_map<DV>(&tdo, dout, H, Sq, B, Pr::QT))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Sq_pad;
  const int warps_per_block = 4;
  const dim3 dgrid((unsigned)((rows + warps_per_block - 1) / warps_per_block));
  flash_bwd_delta_kernel<<<dgrid, 32 * warps_per_block, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      lse_t, delta_t, B, Sq, Sq_pad, H, DV);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<D, DV>;
  auto dqk = flash_bwd_dq_wgmma_kernel<D, DV>;
  if ((err = allow_smem(dkdv, Pr::DKDV)) != cudaSuccess ||
      (err = allow_smem(dqk, Pr::DQ)) != cudaSuccess)
    return (int)err;
  const dim3 kgrid(KH, B, (Sk + BIG - 1) / BIG);
  dkdv<<<kgrid, THREADS, Pr::DKDV, stream>>>(
      tq, tk, tv, tdo, lse_t, delta_t, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sq_pad, Sk, H, KH, causal, window, q_offset,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 qgrid(H, B, (Sq + BIG - 1) / BIG);
  dqk<<<qgrid, THREADS, Pr::DQ, stream>>>(
      tq, tk, tv, tdo, lse_t, delta_t, static_cast<bf16*>(dq), Sq, Sq_pad, Sk,
      H, KH, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The head-dim pairs (D, DV) the kernels are built for, as
// flash_attention.cu's FLASH_HEAD_DIM_PAIRS.
#define BWD_HEAD_DIM_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(192, 192) X(192, 128)

extern "C" {

// Launch the bf16 backward on ``stream`` (delta, then dK/dV, then dQ);
// returns the first failing launch's cudaError_t (0 on success). Every
// tensor is a contiguous (B, S, heads, width) bf16 array whose base is
// 16-byte aligned: q, dq (B, Sq, H, D); k, dk (B, Sk, KH, D); v, dv (B, Sk,
// KH, Dv); out, dout (B, Sq, H, Dv); lse (B, Sq, H) f32; lse_t and delta_t
// are f32 scratch of (B, H, Sq rounded up to 64) elements. ``window`` <= 0
// means no window.
int flash_attention_bwd_wgmma_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const float* lse,
                                     float* lse_t, float* delta_t, void* dq,
                                     void* dk, void* dv, int B, int Sq,
                                     int Sk, int H, int KH, int D, int Dv,
                                     int causal, int window, int q_offset,
                                     float scale, cudaStream_t stream) {
#define BWD_LAUNCH(d, dv_)                                                   \
  if (D == d && Dv == dv_)                                                   \
    return launch<d, dv_>(q, k, v, o, dout, lse, lse_t, delta_t, dq, dk, dv, \
                          B, Sq, Sk, H, KH, causal, window, q_offset, scale, \
                          stream);
  BWD_HEAD_DIM_PAIRS(BWD_LAUNCH)
#undef BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the dK/dV (``dkdv`` = 1) or the
// dQ kernel (0) at the head-dim pair (D, Dv), in bytes (0 for a pair
// without a kernel).
int flash_attention_bwd_wgmma_smem_bytes(int D, int Dv, int dkdv) {
#define BWD_SMEM(d, dv_) \
  if (D == d && Dv == dv_) return dkdv ? Pair<d, dv_>::DKDV : Pair<d, dv_>::DQ;
  BWD_HEAD_DIM_PAIRS(BWD_SMEM)
#undef BWD_SMEM
  return 0;
}

}  // extern "C"
