// Causal GQA flash attention (forward): two hand kernels behind one C entry
// point, chosen by the input type.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (_kernel, its pallas_call at :130): for each query row i at position
// q_offset + i,
//
//   out[i] = softmax_k( (q_i * D^-1/2) . k_k  masked ) @ v
//
// with KV head h / G, a key visible when k < Sk, k <= q (causal) and
// k > q - window (sliding window), masked scores set to the finite -1e30,
// an online softmax in f32 and the output in the input type. Given a
// non-null lse pointer, each kernel also writes the row's log-sum-exp of
// the scaled, masked scores (natural log, f32, (B, Sq, H)), which the
// backward (flash_attention_bwd.cu) recomputes the probabilities from, as
// the reference's _flash_fwd_impl returns it to its backward; serving
// passes null and writes none.
//
// bf16 inputs: flash_fwd_tc_kernel, built for Hopper's tensor cores.
// What bounds it: at the serving shapes (hymba: B = 4, S = 2000, 25 query
// heads of 64) the work is 4 D operations per visible (query, key) pair
// against 2 D bf16 elements read per key, so operations bound it (~0.052 ms
// of bf16 tensor-core time against ~0.018 ms of bytes on an H100). The
// CUDA-core kernel below computes those products in f32 from operands that
// scalar loops read out of shared memory, ~47x off that bound and slower
// than a library attention. The design:
// - one block per (128-row query tile, head, batch), the last query tile
//   (the heaviest under the causal mask) scheduled first; two consumer
//   warpgroups own 64 query rows each (wgmma's M), one producer warp;
// - the producer's lane 0 loads the Q tile once and the live K/V tiles of
//   64 keys by TMA into a ring of stages: a 4-D map (D, heads, S, B) reads
//   the model layout directly, rows past S arrive as zeros (no padding
//   copy), each tile lands with the swizzle of its row (32, 64 or 128
//   bytes, one column block per 64 of D) and completes on an mbarrier;
// - S = Q K^T is an SS wgmma (m64n64k16, both operands K-major in shared
//   memory); the mask and the online softmax run on the accumulator
//   registers: a row's max and sum as trees over the thread's 16 values
//   (short dependency chains), then over the 4 threads that hold the row,
//   and exp2 with the scale folded into one fma;
// - P is rounded to bf16 in registers and is the register A operand of
//   O += P V (wgmma RS, V read MN-major from the same swizzled tile): P
//   never passes through shared memory;
// - key tiles are walked in ascending order with the same tile skipping as
//   below, which the -1e30 cancellation of a fully masked first tile needs;
// - v has a width DV of its own, read through its own map in its own
//   column blocks; the head-dim pairs (D, DV) are (D, D) and MLA's
//   (192, 128): q and k of 128 + 64, v of 128. There QK^T takes 12 k-steps
//   over three 64-wide column blocks, O += P V is one m64n128k16 per k-step
//   and the O accumulator 64 f32 registers a thread (96 at (192, 192),
//   whose P V is m64n192k16); one block an SM, four stages of K/V (214,144
//   bytes of shared memory; three, 173,184 bytes, ran within 0.1% of four
//   at MLA's prefill on an H100). At (192, 192)
//   three stages (197,760 bytes; two, 148,608 bytes, took 10% longer at
//   MLA's padded prefill on an H100);
// - at D <= 64 two blocks share an SM: the launch bounds cap the
//   registers at 96 a thread, because with the producer warp 18 warps over
//   4 schedulers put 5 on one, whose 16K registers give each at most 102
//   (96 in the allocation's steps of 8). The softmax is what the warps
//   spend their time on, and the second block hides its latency.
// Why wgmma here and warp-level mma.sync in ssd.cu: this kernel is bound by
// operations, and on Hopper only wgmma reaches the tensor cores' full rate;
// the SSD pass at hymba's shape is bound by bytes with a 16-deep C B^T
// product, and what it lost was memory traffic, not tensor-core rate.
//
// f32 inputs: flash_fwd_kernel, one thread block per (64-row query tile,
// head, batch), f32 on the CUDA cores.
//
// Design. The Pallas kernel walks the key blocks on the sequential last
// grid axis and keeps (m, l, acc) in VMEM scratch. Here one block owns a
// 64-row query tile and walks the 64-key tiles itself, in ascending order,
// skipping the tiles the reference skips (first_k <= last_q under the causal
// mask, last_k > first_q - window under the window). The query tile, the
// key tile (transposed) and the value tile sit in shared memory as f32; the
// 256 threads form a 16 x 16 grid, each owning rows ty + 16 i (i < 4): it
// computes 4 x 4 scores, takes the row max and sum with shuffles over the 16
// threads of a row, and keeps its rows' running (m, l) and a 4 x DV/16
// slice of the accumulator in registers. The probabilities pass through shared
// memory to the P.V product.
//
// The ascending walk matters: with the finite -1e30, a row whose first live
// tile is fully masked (a window row) accumulates exp(0) terms, which the
// correction exp(-1e30 - m) = 0 cancels exactly once a visible key arrives
// in a later tile. -INFINITY would give NaN; another order another result.
//
// Bound: at the serving shapes (S ~ 2000, D = 64) the work is ~4 D
// operations per visible (query, key) pair against 2 D elements read per
// key tile, so operations bound it. This kernel computes in f32 on the
// CUDA cores, not the tensor cores (f32 inputs must stay f32 to meet the
// 1e-4 tolerance); bf16 inputs take flash_fwd_tc_kernel below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Strides {
  long long b, s, h;  // in elements; the head dim is contiguous
};

template <int D, int DV>
constexpr size_t smem_floats() {
  return (size_t)BQ * D + (size_t)D * (BK + 1) + (size_t)BK * DV +
         (size_t)BQ * BK;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    Strides qs, Strides ks, Strides vs, int Sq, int Sk, int H, int G,
    int causal, int window, int q_offset, float scale) {
  constexpr int DJ = DV / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][D], pre-scaled
  float* Kt = Qs + BQ * D;         // [D][BK + 1], transposed
  float* Vs = Kt + D * (BK + 1);   // [BK][DV]
  float* Ps = Vs + BK * DV;        // [BQ][BK]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;
  const int first_q = q_offset + q0, last_q = first_q + BQ - 1;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, row = q0 + r;
    Qs[e] = row < Sq ? to_f32(qb[row * qs.s + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int first_k = kt * BK;
    if (causal && first_k > last_q) break;  // ascending: all later are dead
    if (window > 0 && first_k + BK - 1 <= first_q - window) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D, key = first_k + c;
      Kt[d * (BK + 1) + c] = key < Sk ? to_f32(kb[key * ks.s + d]) : 0.f;
    }
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int c = e / DV, d = e % DV, key = first_k + c;
      Vs[e] = key < Sk ? to_f32(vb[key * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = first_q + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = first_k + tx + 16 * j;
        bool vis = k_pos < Sk;
        if (causal) vis = vis && k_pos <= q_pos;
        if (window > 0) vis = vis && k_pos > q_pos - window;
        if (!vis) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * BK + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * BK + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * Sq + row) * H + h) * DV;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(orow + tx + 16 * j, acc[i][j] / den);
    // m is in units of the scaled score (Q was scaled on load)
    if (lse != nullptr && tx == 0)
      lse[((long long)b * Sq + row) * H + h] = m[i] + logf(den);
  }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Strides qs, Strides ks, Strides vs, int B, int Sq, int Sk, int H,
           int KH, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_floats<D, DV>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, qs, ks, vs, Sq, Sk, H,
      H / KH, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the Hopper kernel (wgmma, TMA, mbarriers, a producer warp)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;  // query rows per block: two consumer warpgroups
constexpr int BK = 64;   // keys per tile: the n of S = Q K^T
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Layout of one tile width W (a head dim). A tile row of DB <= 64 bf16
// columns is 32, 64 or 128 bytes, which is the TMA swizzle width and the
// wgmma layout (B32, B64, B128); W = 128 and W = 192 (MLA's q/k head dim)
// are two and three such column blocks side by side.
template <int W>
struct Geo {
  static constexpr int DB = W < 64 ? W : 64;
  static constexpr int NB = W / DB;
  static constexpr int ROW = DB * 2;
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
};

// Shared memory of the head-dim pair (D, DV): q and k of width D, v and
// the output of width DV.
template <int D, int DV>
struct Pair {
  static constexpr int STAGES =
      D == 128 ? 2 : (D == 192 && DV == 128) ? 4 : 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int K_BYTES = BK * D * 2;   // one K tile
  static constexpr int V_BYTES = BK * DV * 2;  // one V tile
  static constexpr int KV_BYTES = K_BYTES + V_BYTES;
  // 1 KB of slack to align the tiles to the 1024-byte swizzle atom, the
  // Q tile, STAGES (K, V) pairs, then the mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * KV_BYTES + 128;
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
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin the accumulator registers at this point of the program: reads after
// wgmma_wait() may not move above it, writes before a wgmma not below it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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
template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DV == 16) wgmma_rs_m64n16(o, a, db);
  if constexpr (DV == 32) wgmma_rs_m64n32(o, a, db);
  if constexpr (DV == 64) wgmma_rs_m64n64(o, a, db);
  if constexpr (DV == 128) wgmma_rs_m64n128(o, a, db);
  if constexpr (DV == 192) wgmma_rs_m64n192(o, a, db);
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

// Grid (H, B, query tiles), the last query tile first (the heaviest under
// the causal mask). Warps 0-7 are two consumer warpgroups of 64 query rows
// each; warp 8 is the producer, whose lane 0 loads the Q tile once and the
// live K/V tiles in ascending order into a ring of STAGES stages. K is
// read in column blocks of D, V in its own of DV.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, D >= 128 ? 1 : 2)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Sk, int H,
                        int G, int causal, int window, int q_offset,
                        float scale_log2) {
  using Gm = Geo<D>;
  using Gv = Geo<DV>;
  using Pr = Pair<D, DV>;
  constexpr int ROW = Gm::ROW, DB = Gm::DB, ST = Pr::STAGES;
  constexpr int VROW = Gv::ROW, VDB = Gv::DB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;                      // Q: NB blocks [BQ][DB]
  const uint32_t skv = base + Pr::Q_BYTES;       // stage s: K then V
  const uint32_t bars = skv + ST * Pr::KV_BYTES;
  const uint32_t qbar = bars;                    // Q landed
  auto full = [&](int s) { return bars + 8 * (1 + s); };        // K, V landed
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };  // stage free

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int first_q = q_offset + q0, last_q = first_q + BQ - 1;
  // the live key tiles [kt0, kt1), as the reference skips them: after the
  // diagonal under the causal mask, before the window's first key
  const int nk = (Sk + BK - 1) / BK;
  const int kt1 = causal ? min(nk, last_q / BK + 1) : nk;
  int kt0 = 0;
  if (window > 0 && first_q - window + 1 > 0) kt0 = (first_q - window + 1) / BK;
  const int n_tiles = max(0, kt1 - kt0);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer ----
    if (lane == 0) {
      mbar_expect_tx(qbar, Pr::Q_BYTES);
      for (int cb = 0; cb < Gm::NB; ++cb)
        tma_load(sq + cb * BQ * ROW, &tq, qbar, cb * DB, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        mbar_wait(empty(s), ((i / ST) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full(s), Pr::KV_BYTES);
        const uint32_t ks = skv + s * Pr::KV_BYTES;
        const int k0 = (kt0 + i) * BK;
        for (int cb = 0; cb < Gm::NB; ++cb)
          tma_load(ks + cb * BK * ROW, &tk, full(s), cb * DB, kh, k0, b);
        for (int cb = 0; cb < Gv::NB; ++cb)
          tma_load(ks + Pr::K_BYTES + cb * BK * VROW, &tv, full(s), cb * VDB,
                   kh, k0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 ----
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + (warp & 3) * 16 + g;  // and row0 + 8
  int lo[2], hi[2];  // the keys row r sees: lo[r] < key <= hi[r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = first_q + row0 + 8 * r;
    hi[r] = causal ? min(qp, Sk - 1) : Sk - 1;
    lo[r] = window > 0 ? qp - window : -1;
  }
  float oacc[DV / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t qw = sq + wg * 64 * ROW;

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % ST;
    const uint32_t ks = skv + st * Pr::KV_BYTES, vs = ks + Pr::K_BYTES;
    mbar_wait(full(st), (i / ST) & 1);

    // S = Q K^T over D in k16 steps (32 bytes along a swizzled row)
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk * 16 / DB, cofs = (kk * 16 % DB) * 2;
      wgmma_ss_m64n64(
          s, gmma_desc(qw + cb * BQ * ROW + cofs, 16, 8 * ROW, Gm::LAYOUT),
          gmma_desc(ks + cb * BK * ROW + cofs, 16, 8 * ROW, Gm::LAYOUT),
          kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // mask with the finite -1e30, online softmax in the log2 domain; the
    // row max and sum as trees over the thread's 16 values of a row, then
    // over the 4 threads that hold the row
    const int k0 = (kt0 + i) * BK;
    if (!(k0 > lo[0] && k0 > lo[1] && k0 + BK - 1 <= hi[0] &&
          k0 + BK - 1 <= hi[1])) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, key = k0 + 8 * j + 2 * t + (e & 1);
          if (!(key > lo[r] && key <= hi[r])) s[4 * j + e] = NEG_INF;
        }
    }
    float c[2], mc[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[BK / 8];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        x[j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
#pragma unroll
      for (int w = BK / 16; w >= 1; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) x[j] = fmaxf(x[j], x[j + w]);
      x[0] = fmaxf(x[0], __shfl_xor_sync(0xffffffffu, x[0], 1));
      x[0] = fmaxf(x[0], __shfl_xor_sync(0xffffffffu, x[0], 2));
      const float m_new = fmaxf(m[r], x[0]);
      // p = exp2((s - m) * scale log2 e) as one fma; a row that has seen
      // no visible key yet (m = -1e30) takes p = exp(-1e30 + 1e30) = 1
      // for its masked scores, as the reference's softmax does
      const bool dead = m_new == NEG_INF;
      c[r] = dead ? 0.f : scale_log2;
      mc[r] = dead ? 0.f : m_new * scale_log2;
      corr[r] = ex2((m[r] - m_new) * scale_log2);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], c[e >> 1], -mc[e >> 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[BK / 8];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        x[j] = s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
#pragma unroll
      for (int w = BK / 16; w >= 1; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) x[j] += x[j + w];
      l[r] = l[r] * corr[r] + x[0];
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[4 * j + e] *= corr[e >> 1];

    // P to bf16 in registers: the A fragment of each k16 step of P V
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V, V read MN-major (transposed) from the swizzled tile
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<DV>(oacc, pa[kk],
                   gmma_desc(vs + kk * 16 * VROW, BK * VROW, 8 * VROW,
                             Gv::LAYOUT));
    wgmma_commit();
    wgmma_wait();
    fence_regs(oacc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + row0 + 8 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    // m is the row max of the unscaled score Q K^T and l sums
    // exp2((s - m) scale log2 e) = exp((s - m) scale): the natural-log
    // log-sum-exp of the scaled scores is m scale + ln l
    if (lse != nullptr && t == 0)
      lse[((long long)b * Sq + row) * H + h] =
          m[r] * (scale_log2 * LN2) + logf(den);
    __nv_bfloat16* orow = o + (((long long)b * Sq + row) * H + h) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          oacc[4 * j + 2 * r] / den, oacc[4 * j + 2 * r + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) = v;
    }
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

// The model layout (B, S, heads, W), strides in elements, as a 4-D map
// (W, heads, S, B) whose box is (DB, 1, rows, 1).
template <int W>
bool make_map(CUtensorMap* map, const void* ptr, int heads, int S, int B,
              Strides st, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  constexpr int DB = Geo<W>::DB;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
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

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Strides qs, Strides ks, Strides vs, int B, int Sq, int Sk, int H,
           int KH,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, q, H, Sq, B, qs, BQ) ||
      !make_map<D>(&tk, k, KH, Sk, B, ks, BK) ||
      !make_map<DV>(&tv, v, KH, Sk, B, vs, BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc_kernel<D, DV>;
  constexpr int smem = Pair<D, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, H / KH,
      causal, window, q_offset, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The kernel of (type, D, DV): bf16 inputs the tensor-core kernel, f32
// inputs the CUDA-core one.
template <int D, int DV>
int launch_typed(int bf16, const void* q, const void* k, const void* v,
                 void* o, float* lse, Strides qs, Strides ks, Strides vs,
                 int B, int Sq, int Sk, int H, int KH, int causal, int window,
                 int q_offset, float scale, cudaStream_t stream) {
  if (bf16)
    return tc::launch<D, DV>(q, k, v, o, lse, qs, ks, vs, B, Sq, Sk, H, KH,
                             causal, window, q_offset, scale, stream);
  return launch<float, D, DV>(q, k, v, o, lse, qs, ks, vs, B, Sq, Sk, H, KH,
                              causal, window, q_offset, scale, stream);
}

template <int D, int DV>
int smem_bytes(int bf16) {
  return bf16 ? tc::Pair<D, DV>::SMEM : (int)(smem_floats<D, DV>() * 4);
}

}  // namespace

// The head-dim pairs (D, DV) the kernels are built for: (D, D) for each
// head dim, and MLA's q/k 192 with v 128 (flash_attention.py's
// HEAD_DIM_PAIRS).
#define FLASH_HEAD_DIM_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(192, 192) X(192, 128)

extern "C" {

// Launch on ``stream``; returns the cudaError_t of the launch (0 on
// success). q and k have head dim D, v and o head dim Dv. ``lse``, when not
// null, receives the (B, Sq, H) f32 row log-sum-exp. ``bf16`` selects
// __nv_bfloat16 inputs and output (the tensor-core kernel, whose pointers
// must be 16-byte aligned and whose strides must be multiples of 8
// elements), else float; ``window`` <= 0 means no window; strides are in
// elements.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int bf16, int B, int Sq,
                           int Sk, int H, int KH, int D, int Dv,
                           long long qsb, long long qss, long long qsh,
                           long long ksb, long long kss, long long ksh,
                           long long vsb, long long vss, long long vsh,
                           int causal, int window, int q_offset, float scale,
                           cudaStream_t stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
#define FLASH_LAUNCH(d, dv)                                                 \
  if (D == d && Dv == dv)                                                   \
    return launch_typed<d, dv>(bf16, q, k, v, o, lse, qs, ks, vs, B, Sq, Sk, \
                               H, KH, causal, window, q_offset, scale,      \
                               stream);
  FLASH_HEAD_DIM_PAIRS(FLASH_LAUNCH)
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the kernel of (type, D, Dv), in
// bytes (0 for a pair without a kernel).
int flash_attention_smem_bytes(int bf16, int D, int Dv) {
#define FLASH_SMEM(d, dv) \
  if (D == d && Dv == dv) return smem_bytes<d, dv>(bf16);
  FLASH_HEAD_DIM_PAIRS(FLASH_SMEM)
#undef FLASH_SMEM
  return 0;
}

}  // extern "C"
