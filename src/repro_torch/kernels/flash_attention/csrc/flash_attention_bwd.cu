// Causal GQA flash attention (backward): hand kernels behind one C entry
// point, chosen by the input type.
//
// Replaces the reference's hand-written jnp backward
// src/repro/models/attention.py::_flash_bwd_impl (:134), which its
// jax.custom_vjp wires under chunked_attention; the JAX package has no
// Pallas backward. For the saved q, k, v, out, the row log-sum-exp lse of
// the scaled scores (flash_attention.cu writes it) and the output's
// gradient dout (q and k of head dim D, v, out and dout of their own DV:
// the head-dim pairs (D, D) and MLA's (192, 128)), with s = (q_i . k_j)
// D^-1/2 and a key visible when j < Sk, j <= q_offset + i (causal) and
// j > q_offset + i - window:
//
//   delta_i = sum_d dout_id out_id
//   p_ij    = exp(min(s_ij - lse_i, 30)), 0 where masked
//   dv_j    = sum_i p_ij dout_i          (summed over the G query heads
//   ds_ij   = p_ij (dout_i . v_j - delta_i) D^-1/2     of the KV head)
//   dq_i    = sum_j ds_ij k_j
//   dk_j    = sum_i ds_ij q_i
//
// in f32, the gradients written in the input type.
//
// Three kernels a call, all on a contiguous (B, S, heads, width) layout:
// - flash_bwd_delta_kernel: delta, one warp a row, into an f32 (B, Sq, H)
//   scratch, so that each row's delta is computed once;
// - dK/dV: one block per (64-key tile, KV head, batch). It loops over the
//   G query heads of its group and over the live 64-row query tiles of
//   each (the forward's tile skipping seen from the key side: rows at or
//   after the tile's first key under the causal mask, rows whose window
//   reaches its last key), recomputes p from lse, and keeps dK and dV of
//   its keys in registers until the end;
// - dQ: one block per (64-row query tile, head, batch), looping over the
//   live key tiles as the forward does, dQ in registers.
// No atomics: each gradient element is summed by one thread in a fixed
// order, so two calls on the same inputs give the same bits.
//
// What bounds it: at stablelm's training shape (B = 2, S = 4,096, 32
// heads of 64) the work is 10 D operations per visible (query, key) pair
// (Q K^T and dO V^T recomputed, P^T dO, dS^T Q, dS K) against 8 D bf16
// elements read and written per row, so operations bound it: 0.348 ms of
// bf16 tensor-core time against 0.08 ms of bytes on an H100. This first
// kernel takes the simple route to the tensor cores, warp-level mma.sync
// m16n8k16 on tiles staged in shared memory by plain 16-byte loads, as
// ssd.cu's bf16 kernel does, with no pipelining; it recomputes Q K^T and
// dO V^T in both the dK/dV and the dQ pass. A wgmma/TMA pipeline and one
// fused pass are the levers of a later change.
//
// bf16 inputs: flash_bwd_dkdv_tc_kernel and flash_bwd_dq_tc_kernel, 4
// warps of 16 rows each. Products take the tiles as mma fragments read
// with 32-bit loads from shared memory, each row padded by 8 elements
// (16 bytes), which puts the 32 lanes of a fragment load on 32 banks.
// S^T = K Q^T and dP^T = V dO^T come out with keys as rows, which is the
// A-fragment layout of the next products: P^T and dS^T are rounded to
// bf16 in registers and multiply dO and Q from transposed copies of their
// tiles (written at load time); dQ multiplies dS by a transposed K tile.
// Rounding P and dS to bf16 for those products is where the kernel's
// result leaves the f32 reference (the forward rounds P the same way).
//
// At D = 192 a warp's dK and dV (96 + 64 f32 a thread at (192, 128), 96 +
// 96 at (192, 192)) with the tile's fragments pass the 255 registers a
// thread may have: the dK/dV kernel spills there (ptxas' report is
// chip_smoke.py's [build] lines), which the wgmma route does not.
//
// f32 inputs: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, 256 threads
// as a 16 x 16 grid owning 4 x 4 of each 64 x 64 product and 4 x W/16 of
// each accumulator, f32 on the CUDA cores (f32 must stay f32), tiles of
// W + 1 columns in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BN = 64;  // keys per dK/dV block, query rows per dQ block
constexpr float CLAMP = 30.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool visible(int qp, int key, int Sk, int causal,
                                        int window) {
  bool vis = key < Sk;
  if (causal) vis = vis && key <= qp;
  if (window > 0) vis = vis && key > qp - window;
  return vis;
}

// The query tiles [qt0, qt1) that see a key of the tile starting at k0:
// rows at or after its first key (causal), rows whose window reaches its
// last key.
__device__ __forceinline__ void live_q_tiles(int k0, int Sq, int causal,
                                             int window, int q_offset,
                                             int& qt0, int& qt1) {
  int r0 = 0, r1 = Sq;
  if (causal) r0 = max(r0, k0 - q_offset);
  if (window > 0) r1 = min(r1, k0 + BN - 1 + window - q_offset);
  if (r1 <= r0) {
    qt0 = qt1 = 0;
    return;
  }
  qt0 = r0 / BN;
  qt1 = (r1 + BN - 1) / BN;
}

// The key tiles [kt0, kt1) that a query tile starting at q0 sees, as the
// forward skips them.
__device__ __forceinline__ void live_k_tiles(int q0, int Sk, int causal,
                                             int window, int q_offset,
                                             int& kt0, int& kt1) {
  const int nk = (Sk + BN - 1) / BN;
  const int first_q = q_offset + q0, last_q = first_q + BN - 1;
  kt1 = causal ? min(nk, last_q / BN + 1) : nk;
  kt0 = 0;
  if (window > 0 && first_q - window + 1 > 0) kt0 = (first_q - window + 1) / BN;
  kt1 = max(kt0, kt1);
}

__device__ __forceinline__ long long at(int b, int s, int S, int head,
                                        int heads) {
  return ((long long)b * S + s) * heads + head;
}

// delta = rowsum(dout * out), one warp a row of DV
template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, int rows,
                                       int DV) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + row * DV;
  const T* drow = dout + row * DV;
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32)
    acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernels
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;

template <int D, int DV>
constexpr int f32_smem_bytes(bool dkdv) {
  // tiles (BN, W + 1): K and Q of width D, V and dO of DV; dK/dV: P and dS
  // (BN, BN + 1), lse and delta
  return dkdv ? 4 * (2 * BN * (D + 1) + 2 * BN * (DV + 1) +
                     2 * BN * (BN + 1) + 2 * BN)
              : 4 * (2 * BN * (D + 1) + 2 * BN * (DV + 1) + BN * (BN + 1));
}

// rows [r0, r0 + BN) of a (B, S, heads, W) array at (b, head) into a tile
// of row stride W + 1, zeros past S
template <int W>
__device__ __forceinline__ void load_f32(float* dst, const float* src, int b,
                                         int head, int heads, int S, int r0) {
  for (int e = threadIdx.x; e < BN * W; e += THREADS) {
    const int r = e / W, d = e % W, row = r0 + r;
    dst[r * (W + 1) + d] = row < S ? src[at(b, row, S, head, heads) * W + d]
                                   : 0.f;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int KH, int causal, int window, int q_offset, float scale) {
  constexpr int DP = D + 1, VP = DV + 1, PS = BN + 1;
  constexpr int DJ = D / 16, VJ = DV / 16;
  extern __shared__ float smem[];
  float* Ks = smem;          // [BN keys][DP]
  float* Vs = Ks + BN * DP;  // [BN keys][VP]
  float* Qs = Vs + BN * VP;  // [BN query rows][DP]
  float* Os = Qs + BN * DP;  // dout [BN query rows][VP]
  float* Ps = Os + BN * VP;  // [BN keys][PS]
  float* Ss = Ps + BN * PS;  // dS
  float* Ls = Ss + BN * PS;  // the tile's lse
  float* Es = Ls + BN;       // and delta

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BN, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  load_f32<D>(Ks, k, b, kh, KH, Sk, k0);
  load_f32<DV>(Vs, v, b, kh, KH, Sk, k0);

  float dka[4][DJ], dva[4][VJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < VJ; ++j) dva[i][j] = 0.f;
  }

  int qt0, qt1;
  live_q_tiles(k0, Sq, causal, window, q_offset, qt0, qt1);
  for (int gh = 0; gh < G; ++gh) {
    const int h = kh * G + gh;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BN;
      __syncthreads();  // the previous tile's readers are done
      load_f32<D>(Qs, q, b, h, H, Sq, q0);
      load_f32<DV>(Os, dout, b, h, H, Sq, q0);
      for (int r = tid; r < BN; r += THREADS) {
        const int row = q0 + r;
        const bool in = row < Sq;
        Ls[r] = in ? lse[at(b, row, Sq, h, H)] : 0.f;
        Es[r] = in ? delta[at(b, row, Sq, h, H)] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: keys ty + 16 i, query rows tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[4], qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * DP + d];
          qv[i] = Qs[(tx + 16 * i) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
      }
      for (int d = 0; d < DV; ++d) {
        float vv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vv[i] = Vs[(ty + 16 * i) * VP + d];
          ov[i] = Os[(tx + 16 * i) * VP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ty + 16 * i, r = tx + 16 * j, row = q0 + r;
          float p = 0.f;
          if (row < Sq && visible(q_offset + row, k0 + c, Sk, causal, window))
            p = expf(fminf(s[i][j] * scale - Ls[r], CLAMP));
          Ps[c * PS + r] = p;
          Ss[c * PS + r] = p * (dp[i][j] - Es[r]) * scale;
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: keys ty + 16 i, columns tx + 16 j
      for (int r = 0; r < BN; ++r) {
        float ov[VJ], qv[DJ];
#pragma unroll
        for (int j = 0; j < VJ; ++j) ov[j] = Os[r * VP + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < DJ; ++j) qv[j] = Qs[r * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(ty + 16 * i) * PS + r];
          const float ds = Ss[(ty + 16 * i) * PS + r];
#pragma unroll
          for (int j = 0; j < VJ; ++j) dva[i][j] = fmaf(p, ov[j], dva[i][j]);
#pragma unroll
          for (int j = 0; j < DJ; ++j) dka[i][j] = fmaf(ds, qv[j], dka[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    const long long row = at(b, key, Sk, kh, KH);
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[row * D + tx + 16 * j] = dka[i][j];
#pragma unroll
    for (int j = 0; j < VJ; ++j) dv[row * DV + tx + 16 * j] = dva[i][j];
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int Sq, int Sk, int H, int KH, int causal,
    int window, int q_offset, float scale) {
  constexpr int DP = D + 1, VP = DV + 1, PS = BN + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;          // [BN query rows][DP]
  float* Os = Qs + BN * DP;  // dout [BN query rows][VP]
  float* Ks = Os + BN * VP;  // [BN keys][DP]
  float* Vs = Ks + BN * DP;  // [BN keys][VP]
  float* Ss = Vs + BN * VP;  // dS [BN query rows][PS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  load_f32<D>(Qs, q, b, h, H, Sq, q0);
  load_f32<DV>(Os, dout, b, h, H, Sq, q0);
  float L[4], E[4], dqa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    L[i] = row < Sq ? lse[at(b, row, Sq, h, H)] : 0.f;
    E[i] = row < Sq ? delta[at(b, row, Sq, h, H)] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.f;
  }

  int kt0, kt1;
  live_k_tiles(q0, Sk, causal, window, q_offset, kt0, kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's readers are done
    load_f32<D>(Ks, k, b, kh, KH, Sk, k0);
    load_f32<DV>(Vs, v, b, kh, KH, Sk, k0);
    __syncthreads();

    // S and dP: query rows ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + d];
        kv[i] = Ks[(tx + 16 * i) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    for (int d = 0; d < DV; ++d) {
      float ov[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ov[i] = Os[(ty + 16 * i) * VP + d];
        vv[i] = Vs[(tx + 16 * i) * VP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j, row = q0 + r;
        float p = 0.f;
        if (row < Sq && visible(q_offset + row, k0 + c, Sk, causal, window))
          p = expf(fminf(s[i][j] * scale - L[i], CLAMP));
        Ss[r * PS + c] = p * (dp[i][j] - E[i]) * scale;
      }
    __syncthreads();

    // dQ += dS K: query rows ty + 16 i, columns tx + 16 j
    for (int c = 0; c < BN; ++c) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ss[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) dqa[i][j] = fmaf(ds, kv[j], dqa[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const long long off = at(b, row, Sq, h, H) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[off + tx + 16 * j] = dqa[i][j];
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (mma.sync m16n8k16, f32 accumulators)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int THREADS = 128;  // 4 warps of 16 rows
constexpr int CS = BN + 8;    // row stride of a transposed (W, BN) tile
using bf16 = __nv_bfloat16;

// Shared layout of the head-dim pair (D, DV): a natural (BN, W) tile has
// rows of W + 8 elements, a transposed (W, BN) tile rows of BN + 8; each
// row's start stays 16-byte aligned and a fragment's 32 lanes read 32
// banks.
template <int D, int DV>
struct Geo {
  static constexpr int RS = D + 8;    // K and Q rows
  static constexpr int VRS = DV + 8;  // V and dO rows
  static constexpr int ROWS = BN * RS;    // elements of a natural K, Q tile
  static constexpr int VROWS = BN * VRS;  // of a natural V, dO tile
  // dK/dV: K, V, Q, dO, Q^T, dO^T, then lse and delta (f32)
  static constexpr int DKDV =
      (2 * ROWS + 2 * VROWS + (D + DV) * CS) * 2 + 2 * BN * 4;
  // dQ: Q, dO, K, V, K^T
  static constexpr int DQ = (2 * ROWS + 2 * VROWS + D * CS) * 2;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b, m16n8k16, bf16 in, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16 x 16, row-major) of rows r0.. and columns c0.. of a
// tile with row stride RS; lane (g, t) holds rows g and g + 8, columns
// 2 t, 2 t + 1 and 2 t + 8, 2 t + 9.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int RS, int r0, int c0, int g, int t) {
  a[0] = ld32(tile + (r0 + g) * RS + c0 + 2 * t);
  a[1] = ld32(tile + (r0 + g + 8) * RS + c0 + 2 * t);
  a[2] = ld32(tile + (r0 + g) * RS + c0 + 2 * t + 8);
  a[3] = ld32(tile + (r0 + g + 8) * RS + c0 + 2 * t + 8);
}

// d += A B with B (16 x 8, k x n) read from a tile that holds B^T
// row-major (row n, k contiguous): lane (g, t) holds column n = g, rows
// k = 2 t, 2 t + 1 and 2 t + 8, 2 t + 9.
__device__ __forceinline__ void mma_bt(float (&d)[4], const uint32_t (&a)[4],
                                       const bf16* tile, int RS, int n0,
                                       int k0, int g, int t) {
  const bf16* p = tile + (n0 + g) * RS + k0 + 2 * t;
  mma(d, a, ld32(p), ld32(p + 8));
}

// rows [r0, r0 + BN) of a (B, S, heads, W) array at (b, head) into a tile
// of row stride W + 8 (and, with TRANS, its transpose into a tile of row
// stride BN + 8), zeros past S; 16-byte loads
template <int W, bool TRANS>
__device__ __forceinline__ void load_tile(bf16* dst, bf16* dstT,
                                          const bf16* src, int b, int head,
                                          int heads, int S, int r0) {
  constexpr int CH = W / 8;
  for (int e = threadIdx.x; e < BN * CH; e += THREADS) {
    const int r = e / CH, c = (e % CH) * 8, row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      val = *reinterpret_cast<const uint4*>(src + at(b, row, S, head, heads) * W
                                            + c);
    *reinterpret_cast<uint4*>(dst + r * (W + 8) + c) = val;
    if (TRANS) {
      const bf16* x = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dstT[(c + i) * CS + r] = x[i];
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
    int KH, int causal, int window, int q_offset, float scale) {
  using Gm = Geo<D, DV>;
  constexpr int RS = Gm::RS, VRS = Gm::VRS, NT = D / 8, VT = DV / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);  // [BN keys][RS]
  bf16* Vs = Ks + Gm::ROWS;                     // [BN keys][VRS]
  bf16* Qs = Vs + Gm::VROWS;  // [BN query rows][RS]
  bf16* Os = Qs + Gm::ROWS;   // dout [BN query rows][VRS]
  bf16* QT = Os + Gm::VROWS;  // [D][CS]: Q transposed
  bf16* OT = QT + D * CS;     // [DV][CS]: dout transposed
  float* Ls = reinterpret_cast<float*>(OT + DV * CS);
  float* Es = Ls + BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = 16 * warp;  // the warp's first key row of the tile
  const int k0 = blockIdx.x * BN, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  load_tile<D, false>(Ks, nullptr, k, b, kh, KH, Sk, k0);
  load_tile<DV, false>(Vs, nullptr, v, b, kh, KH, Sk, k0);

  // accumulators: key rows kr + g (+ 8), columns 8 n + 2 t (+ 1)
  float dka[NT][4], dva[VT][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < NT; ++n) dka[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < VT; ++n) dva[n][e] = 0.f;
  }

  int qt0, qt1;
  live_q_tiles(k0, Sq, causal, window, q_offset, qt0, qt1);
  for (int gh = 0; gh < G; ++gh) {
    const int h = kh * G + gh;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BN;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D, true>(Qs, QT, q, b, h, H, Sq, q0);
      load_tile<DV, true>(Os, OT, dout, b, h, H, Sq, q0);
      for (int r = threadIdx.x; r < BN; r += THREADS) {
        const int row = q0 + r;
        const bool in = row < Sq;
        Ls[r] = in ? lse[at(b, row, Sq, h, H)] : 0.f;
        Es[r] = in ? delta[at(b, row, Sq, h, H)] : 0.f;
      }
      __syncthreads();

      // per 8 query rows j: S^T = K Q^T and dP^T = V dO^T (16 keys x 8
      // rows), then P^T and dS^T, rounded to bf16 into the A fragments
      // of the k16 steps over the query rows
      uint32_t pa[BN / 16][4], da[BN / 16][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          frag_a(a, Ks, RS, kr, 16 * kk, g, t);
          mma_bt(s, a, Qs, RS, 8 * j, 16 * kk, g, t);
        }
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          uint32_t a[4];
          frag_a(a, Vs, VRS, kr, 16 * kk, g, t);
          mma_bt(dp, a, Os, VRS, 8 * j, 16 * kk, g, t);
        }
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kr + g + 8 * (e >> 1);
          const int r = 8 * j + 2 * t + (e & 1), row = q0 + r;
          p[e] = 0.f;
          if (row < Sq && visible(q_offset + row, key, Sk, causal, window))
            p[e] = expf(fminf(s[e] * scale - Ls[r], CLAMP));
          ds[e] = p[e] * (dp[e] - Es[r]) * scale;
        }
        pa[j >> 1][2 * (j & 1)] = pack(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack(p[2], p[3]);
        da[j >> 1][2 * (j & 1)] = pack(ds[0], ds[1]);
        da[j >> 1][2 * (j & 1) + 1] = pack(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q over the 64 query rows; B^T is
      // dO^T and Q^T, row d, query rows contiguous
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < VT; ++n)
          mma_bt(dva[n], pa[kk], OT, CS, 8 * n, 16 * kk, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma_bt(dka[n], da[kk], QT, CS, 8 * n, 16 * kk, g, t);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + kr + g + 8 * half;
    if (key >= Sk) continue;
    const long long row = at(b, key, Sk, kh, KH);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dk + row * D + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dka[n][2 * half], dka[n][2 * half + 1]);
#pragma unroll
    for (int n = 0; n < VT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dv + row * DV + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dva[n][2 * half], dva[n][2 * half + 1]);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int KH, int causal,
    int window, int q_offset, float scale) {
  using Gm = Geo<D, DV>;
  constexpr int RS = Gm::RS, VRS = Gm::VRS, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // [BN query rows][RS]
  bf16* Os = Qs + Gm::ROWS;                     // dout [BN rows][VRS]
  bf16* Ks = Os + Gm::VROWS;                    // [BN keys][RS]
  bf16* Vs = Ks + Gm::ROWS;                     // [BN keys][VRS]
  bf16* KT = Vs + Gm::VROWS;  // [D][CS]: K transposed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = 16 * warp;  // the warp's first query row of the tile
  const int q0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  load_tile<D, false>(Qs, nullptr, q, b, h, H, Sq, q0);
  load_tile<DV, false>(Os, nullptr, dout, b, h, H, Sq, q0);
  float L[2], E[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qr + g + 8 * half;
    L[half] = row < Sq ? lse[at(b, row, Sq, h, H)] : 0.f;
    E[half] = row < Sq ? delta[at(b, row, Sq, h, H)] : 0.f;
  }
  __syncthreads();
  // the warp's Q and dout rows as A fragments, for every key tile
  uint32_t qa[D / 16][4], oa[DV / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) frag_a(qa[kk], Qs, RS, qr, 16 * kk, g, t);
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk)
    frag_a(oa[kk], Os, VRS, qr, 16 * kk, g, t);
  // accumulator: query rows qr + g (+ 8), columns 8 n + 2 t (+ 1)
  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  int kt0, kt1;
  live_k_tiles(q0, Sk, causal, window, q_offset, kt0, kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, true>(Ks, KT, k, b, kh, KH, Sk, k0);
    load_tile<DV, false>(Vs, nullptr, v, b, kh, KH, Sk, k0);
    __syncthreads();

    // per 8 keys j: S = Q K^T and dP = dO V^T (16 rows x 8 keys), then
    // dS rounded to bf16 into the A fragments of the k16 steps over keys
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bt(s, qa[kk], Ks, RS, 8 * j, 16 * kk, g, t);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        mma_bt(dp, oa[kk], Vs, VRS, 8 * j, 16 * kk, g, t);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + qr + g + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float p = 0.f;
        if (row < Sq && visible(q_offset + row, key, Sk, causal, window))
          p = expf(fminf(s[e] * scale - L[e >> 1], CLAMP));
        ds[e] = p * (dp[e] - E[e >> 1]) * scale;
      }
      da[j >> 1][2 * (j & 1)] = pack(ds[0], ds[1]);
      da[j >> 1][2 * (j & 1) + 1] = pack(ds[2], ds[3]);
    }

    // dQ += dS K over the 64 keys; B^T is K^T, row d, keys contiguous
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_bt(dqa[n], da[kk], KT, CS, 8 * n, 16 * kk, g, t);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qr + g + 8 * half;
    if (row >= Sq) continue;
    const long long off = at(b, row, Sq, h, H) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + 8 * n) =
          __floats2bfloat162_rn(dqa[n][2 * half], dqa[n][2 * half + 1]);
  }
}

}  // namespace tc

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The three launches of one backward at the head-dim pair (D, DV).
template <int D, int DV>
int launch(int bf16, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, float* delta,
           void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const int rows = B * Sq * H;
  const int warps_per_block = 4;
  const dim3 dgrid((rows + warps_per_block - 1) / warps_per_block);
  const dim3 kgrid((Sk + BN - 1) / BN, KH, B), qgrid((Sq + BN - 1) / BN, H, B);
  cudaError_t err;
  if (bf16) {
    using T = __nv_bfloat16;
    using Gm = tc::Geo<D, DV>;
    flash_bwd_delta_kernel<T><<<dgrid, 32 * warps_per_block, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
        DV);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    auto dkdv = tc::flash_bwd_dkdv_tc_kernel<D, DV>;
    auto dqk = tc::flash_bwd_dq_tc_kernel<D, DV>;
    if ((err = allow_smem(dkdv, Gm::DKDV)) != cudaSuccess ||
        (err = allow_smem(dqk, Gm::DQ)) != cudaSuccess)
      return (int)err;
    dkdv<<<kgrid, tc::THREADS, Gm::DKDV, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KH, causal,
        window, q_offset, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dqk<<<qgrid, tc::THREADS, Gm::DQ, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), Sq, Sk, H, KH, causal, window, q_offset, scale);
    return (int)cudaGetLastError();
  }
  using T = float;
  flash_bwd_delta_kernel<T><<<dgrid, 32 * warps_per_block, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, DV);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto dkdv = flash_bwd_dkdv_kernel<D, DV>;
  auto dqk = flash_bwd_dq_kernel<D, DV>;
  constexpr int dkdv_smem = f32_smem_bytes<D, DV>(true);
  constexpr int dq_smem = f32_smem_bytes<D, DV>(false);
  if ((err = allow_smem(dkdv, dkdv_smem)) != cudaSuccess ||
      (err = allow_smem(dqk, dq_smem)) != cudaSuccess)
    return (int)err;
  dkdv<<<kgrid, THREADS, dkdv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KH, causal, window,
      q_offset, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dqk<<<qgrid, THREADS, dq_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Sq, Sk, H, KH, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int smem_bytes(int bf16, int dkdv) {
  if (bf16) return dkdv ? tc::Geo<D, DV>::DKDV : tc::Geo<D, DV>::DQ;
  return f32_smem_bytes<D, DV>(dkdv != 0);
}

}  // namespace

// The head-dim pairs (D, DV) the kernels are built for, as
// flash_attention.cu's FLASH_HEAD_DIM_PAIRS.
#define BWD_HEAD_DIM_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(192, 192) X(192, 128)

extern "C" {

// Launch the backward on ``stream`` (delta, then dK/dV, then dQ); returns
// the first failing launch's cudaError_t (0 on success). Every tensor is a
// contiguous (B, S, heads, width) array: q, dq (B, Sq, H, D); k, dk (B,
// Sk, KH, D); v, dv (B, Sk, KH, Dv); out, dout (B, Sq, H, Dv); lse and the
// scratch delta (B, Sq, H) f32. ``bf16`` selects __nv_bfloat16 tensors
// (the tensor-core kernels), else float; ``window`` <= 0 means no window.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int bf16, int B, int Sq,
                               int Sk, int H, int KH, int D, int Dv,
                               int causal, int window, int q_offset,
                               float scale, cudaStream_t stream) {
#define BWD_LAUNCH(d, dv_)                                                  \
  if (D == d && Dv == dv_)                                                  \
    return launch<d, dv_>(bf16, q, k, v, o, dout, lse, delta, dq, dk, dv, B, \
                          Sq, Sk, H, KH, causal, window, q_offset, scale,   \
                          stream);
  BWD_HEAD_DIM_PAIRS(BWD_LAUNCH)
#undef BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the dK/dV (``dkdv`` = 1) or the
// dQ kernel (0) of (type, D, Dv), in bytes (0 for a pair without a
// kernel).
int flash_attention_bwd_smem_bytes(int bf16, int D, int Dv, int dkdv) {
#define BWD_SMEM(d, dv_) \
  if (D == d && Dv == dv_) return smem_bytes<d, dv_>(bf16, dkdv);
  BWD_HEAD_DIM_PAIRS(BWD_SMEM)
#undef BWD_SMEM
  return 0;
}

}  // extern "C"
