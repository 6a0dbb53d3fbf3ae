// Mamba-2 SSD intra-chunk pass: two hand kernels behind one C entry point,
// chosen by the input type, each one thread block per (chunk, head, batch).
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/ssd/ssd.py::ssd_intra_chunk (_kernel, its pallas_call
// at :80). Over one chunk of length L, with head dim P and state N, in f32:
//
//   cum     = cumsum(dt * A)                                        (L,)
//   y_intra = (tril(exp(max(cum_i - cum_j, -30))) * C B^T * dt_j) X   (L, P)
//   sc      = sum_j exp(max(cum_L - cum_j, -30)) dt_j B_j x_j^T       (N, P)
//   dec     = exp(max(cum_L, -30))
//
// The inter-chunk recurrence stays in PyTorch (ops.py), as it stays in jnp
// in the reference.
//
// bf16 inputs: ssd_intra_tc_kernel, on tensor-core tiles.
// What bounds it: at hymba's shape (B * H = 200 heads, L = 256, N = 16,
// P = 64) the pass moves ~166 MB (x, B, C in; y, the state, cum out in f32)
// against ~9 GFLOP, so bytes bound it (~0.050 ms at 3.35 TB/s; the
// tensor-core time is ~0.009 ms). The CUDA-core kernel below loses ~38x to
// that bound on traffic inside the SM, not on arithmetic: one thread takes
// the cumulative sum while the others wait, every 64-row tile reloads the
// B and X tiles of all earlier ones, and C B^T, M X and the state are
// scalar loops over f32 tiles in shared memory. The design:
// - the chunk's C, B and X are copied once into shared memory as bf16
//   (cp.async, 16 bytes a copy, zeros past the sequence): 63 KB at N = 16
//   (three blocks per SM, registers capped at 80), 175 KB at N = 128 (one
//   block per SM there);
// - cum is a parallel scan: an inclusive shuffle scan in each warp, then
//   one over the warps' sums;
// - each warp owns two 16-row strips i (strips w and 15 - w: equal causal
//   work) and walks the 16-key blocks j <= i: C_i B_j^T on mma.sync
//   m16n8k16 in bf16 (exact products, f32 sums); the decay, the causal
//   mask and dt_j scale that accumulator in registers, and it is the A
//   operand of M X_j without a trip through shared memory;
// - the state sc = (B (.) w)^T X runs on the same kind of tiles, its 16 x 8
//   tiles shared among the warps.
// Rounding: M and B (.) w are formed in f32 inside the kernel. Rounded to
// bf16 for the tensor core they miss the bf16 tolerance (1e-1) at mamba2's
// N = 128 (|C B^T| grows with N), so M X and the state run on mma.sync
// m16n8k8 in TF32 (10-bit mantissa; X is exact in TF32).
// Why mma.sync and not wgmma (flash_attention.cu): the pass is bound by
// bytes, its C B^T is a single k16 step at N = 16, and what the earlier
// kernel lost was shared-memory traffic, the serial scan and reloaded
// tiles, not tensor-core rate; warp-level fragments let the decay and the
// mask act on the C B^T accumulator in place.
//
// f32 inputs: ssd_intra_kernel, on the CUDA cores.
//
// Design. The Pallas kernel holds a whole chunk in VMEM: the L x L decay
// matrix and L x N blocks of B and C. At L = 256 that matrix alone is 256 KB
// in f32, over the 227 KB a block may use, and at N = 128 B and C are 128 KB
// each. So the block tiles the rows i by 64 and streams 64-row tiles j <= i
// of B and X through shared memory: per (i, j) tile pair it forms
// M = decay * (C_i . B_j) * dt_j in shared memory, then adds M X_j into a
// 64 x P output tile kept in shared memory. The last row tile visits every
// j tile, and adds B_j^T (w_j x_j) into the N x P chunk state, also kept in
// shared memory. Threads stride over each tile's entries, so any N and P
// fit (N * P and 64 * P floats must fit beside the tiles). The model layout
// is read through strides: head h reads group h / (H / G) (no repeat), and
// steps past the sequence read as zeros (dt = 0: identity steps, the
// reference's padding). One thread takes the cumulative sum in step order.
//
// Bound: ~(N + P) * L^2 + 2 N P L operations per chunk against (P + 2N) L
// input and P L + N P output floats: operations bound it at L = 256. This
// kernel computes in f32 on the CUDA cores (f32 inputs must stay f32 to
// meet the 5e-4 tolerance); bf16 inputs take ssd_intra_tc_kernel below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TI = 64;  // rows i per tile
constexpr int TJ = 64;  // rows j per streamed tile
constexpr int THREADS = 256;
constexpr float MIN_LOG = -30.f;

__device__ __forceinline__ float to_f32(float x) { return x; }

struct Strides {
  long long b, s, h;  // in elements; the last dim is contiguous
};

size_t smem_floats(int L, int N, int P) {
  return 3 * (size_t)L + (size_t)TI * N + (size_t)N * (TJ + 1) +
         (size_t)TJ * P + (size_t)TI * TJ + (size_t)TI * P + (size_t)N * P;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_intra_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, float* __restrict__ y, float* __restrict__ sc,
    float* __restrict__ dec, float* __restrict__ cum_out, Strides xs,
    Strides ds, Strides bs, Strides cs, int S, int H, int G, int N, int P,
    int L) {
  extern __shared__ float smem[];
  float* cum = smem;                // [L]
  float* dts = cum + L;             // [L]
  float* w = dts + L;               // [L] exp(max(cum_L - cum_j)) * dt_j
  float* Cs = w + L;                // [TI][N]
  float* Bt = Cs + TI * N;          // [N][TJ + 1], transposed
  float* Xs = Bt + N * (TJ + 1);    // [TJ][P]
  float* Ms = Xs + TJ * P;          // [TI][TJ]
  float* Ys = Ms + TI * TJ;         // [TI][P]
  float* Sc = Ys + TI * P;          // [N][P]

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G);
  const long long t0 = (long long)c * L;  // first step of the chunk
  const T* xb = x + b * xs.b + h * xs.h;
  const float* db = dt + b * ds.b + h * ds.h;
  const T* bb = Bm + b * bs.b + g * bs.h;
  const T* cb = Cm + b * cs.b + g * cs.h;

  for (int t = tid; t < L; t += THREADS)
    dts[t] = t0 + t < S ? db[(t0 + t) * ds.s] : 0.f;
  for (int e = tid; e < N * P; e += THREADS) Sc[e] = 0.f;
  __syncthreads();
  if (tid == 0) {
    const float a = A[h];
    float run = 0.f;
    for (int t = 0; t < L; ++t) {
      run = __fadd_rn(run, __fmul_rn(dts[t], a));
      cum[t] = run;
    }
  }
  __syncthreads();
  const float cum_last = cum[L - 1];
  for (int t = tid; t < L; t += THREADS) {
    w[t] = __fmul_rn(expf(fmaxf(cum_last - cum[t], MIN_LOG)), dts[t]);
    cum_out[(((long long)b * nc + c) * L + t) * H + h] = cum[t];
  }
  if (tid == 0)
    dec[((long long)b * nc + c) * H + h] = expf(fmaxf(cum_last, MIN_LOG));

  const int n_tiles = (L + TI - 1) / TI;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * TI;
    __syncthreads();  // Cs and Ys of the previous row tile are done
    for (int e = tid; e < TI * N; e += THREADS) {
      const int i = e / N, n = e % N;
      const long long t = t0 + i0 + i;
      Cs[e] = (i0 + i < L && t < S) ? to_f32(cb[t * cs.s + n]) : 0.f;
    }
    for (int e = tid; e < TI * P; e += THREADS) Ys[e] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * TJ;
      __syncthreads();  // the previous j tile's readers are done
      for (int e = tid; e < TJ * N; e += THREADS) {
        const int j = e / N, n = e % N;
        const long long t = t0 + j0 + j;
        Bt[n * (TJ + 1) + j] =
            (j0 + j < L && t < S) ? to_f32(bb[t * bs.s + n]) : 0.f;
      }
      for (int e = tid; e < TJ * P; e += THREADS) {
        const int j = e / P, p = e % P;
        const long long t = t0 + j0 + j;
        Xs[e] = (j0 + j < L && t < S) ? to_f32(xb[t * xs.s + p]) : 0.f;
      }
      __syncthreads();
      // M[i][j] = exp(max(cum_i - cum_j, -30)) * (C_i . B_j) * dt_j, j <= i
      for (int e = tid; e < TI * TJ; e += THREADS) {
        const int i = e / TJ, j = e % TJ, ti = i0 + i, tj = j0 + j;
        float m = 0.f;
        if (tj <= ti && ti < L) {
          float dot = 0.f;
          for (int n = 0; n < N; ++n)
            dot = fmaf(Cs[i * N + n], Bt[n * (TJ + 1) + j], dot);
          const float decay = expf(fmaxf(cum[ti] - cum[tj], MIN_LOG));
          m = __fmul_rn(__fmul_rn(decay, dot), dts[tj]);
        }
        Ms[e] = m;
      }
      __syncthreads();
      for (int e = tid; e < TI * P; e += THREADS) {
        const int i = e / P, p = e % P;
        float acc = 0.f;
        for (int j = 0; j < TJ; ++j) acc = fmaf(Ms[i * TJ + j], Xs[j * P + p], acc);
        Ys[e] += acc;
      }
      if (it == n_tiles - 1) {  // the last row tile sees every j tile once
        for (int e = tid; e < N * P; e += THREADS) {
          const int n = e / P, p = e % P;
          float acc = 0.f;
          for (int j = 0; j < TJ && j0 + j < L; ++j)
            acc = fmaf(__fmul_rn(Bt[n * (TJ + 1) + j], w[j0 + j]),
                       Xs[j * P + p], acc);
          Sc[e] += acc;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < TI * P; e += THREADS) {
      const int i = e / P, p = e % P;
      if (i0 + i < L)
        y[((((long long)b * nc + c) * L + i0 + i) * H + h) * P + p] = Ys[e];
    }
  }
  __syncthreads();
  float* scb = sc + (((long long)b * nc + c) * H + h) * N * P;
  for (int e = tid; e < N * P; e += THREADS) scb[e] = Sc[e];
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles (mma.sync), the chunk resident in shared memory
// ---------------------------------------------------------------------------
namespace tc {

constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_L = 256;    // longest chunk: 16 strips of 16 rows

// Shared rows padded by 16 bytes, so that ldmatrix and the strided scalar
// reads of the fragments below hit distinct banks.
template <int N, int P>
struct Geo {
  static constexpr int NS = N + 8;  // a row of B or C, in bf16
  static constexpr int PS = P + 8;  // a row of X
  static size_t smem(int L) {
    const size_t Lp = (L + 15) & ~15;
    return Lp * (2 * NS + PS) * 2 + 3 * Lp * 4 + 8 * 4;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when ``bytes`` is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b, m16n8k16, bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, TF32 in, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// a bf16 as the bits of the f32 (and TF32) of the same value
__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return (uint32_t)(*reinterpret_cast<const unsigned short*>(p)) << 16;
}

__device__ __forceinline__ float bf16_f32(const __nv_bfloat16* p) {
  return __uint_as_float(bf16_bits(p));
}

// Grid (nc, H, B). Warp w owns the 16-row strips w and nstrips - 1 - w of
// the chunk (equal causal work), then a share of the state's tiles.
//
// The TF32 products use an order of k that the fragments make free: within
// each 8 keys, the mma's k = t (t + 4) stands for key 2 t (2 t + 1), so the
// C B^T accumulator (columns 2 t, 2 t + 1 of its thread) is the A fragment
// as it lies, and each thread reads the two X rows 2 t, 2 t + 1 itself.
template <int N, int P>
__global__ void __launch_bounds__(THREADS, N <= 16 ? 3 : 2) ssd_intra_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ sc, float* __restrict__ dec,
    float* __restrict__ cum_out, Strides xs, Strides ds, Strides bs,
    Strides cs, int S, int H, int G, int L) {
  using Gm = Geo<N, P>;
  constexpr int NS = Gm::NS, PS = Gm::PS, NV = N / 8, PV = P / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int Lp = (L + 15) & ~15;
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [Lp][NS]
  __nv_bfloat16* Bs = Cs + Lp * NS;                                 // [Lp][NS]
  __nv_bfloat16* Xs = Bs + Lp * NS;                                 // [Lp][PS]
  float* cum = reinterpret_cast<float*>(Xs + Lp * PS);              // [Lp]
  float* dts = cum + Lp;                                            // [Lp]
  float* w = dts + Lp;  // [Lp] exp(max(cum_L - cum_j, -30)) * dt_j
  float* tot = w + Lp;  // [8] warp sums of the scan

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, grp = h / (H / G);
  const long long t0 = (long long)c * L;  // first step of the chunk
  const __nv_bfloat16* xb = x + b * xs.b + h * xs.h;
  const __nv_bfloat16* bb = Bm + b * bs.b + grp * bs.h;
  const __nv_bfloat16* cb = Cm + b * cs.b + grp * cs.h;

  // 1. the chunk's C, B and X rows, once, 16 bytes a copy; steps past the
  //    sequence or the chunk read as zeros
  for (int e = tid; e < Lp * (2 * NV + PV); e += THREADS) {
    const __nv_bfloat16* src;
    __nv_bfloat16* dst;
    int r;
    if (e < 2 * Lp * NV) {
      const bool is_b = e >= Lp * NV;
      const int f = is_b ? e - Lp * NV : e;
      r = f / NV;
      const int piece = (f % NV) * 8;
      src = (is_b ? bb + (t0 + r) * bs.s : cb + (t0 + r) * cs.s) + piece;
      dst = (is_b ? Bs : Cs) + r * NS + piece;
    } else {
      const int f = e - 2 * Lp * NV;
      r = f / PV;
      const int piece = (f % PV) * 8;
      src = xb + (t0 + r) * xs.s + piece;
      dst = Xs + r * PS + piece;
    }
    const bool in = r < L && t0 + r < S;
    cp_async16(dst, in ? src : xb, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. cum = cumsum(dt * A): an inclusive scan in each warp, then over the
  //    warps' sums (while the copies fly)
  const float* db = dt + b * ds.b + h * ds.h;
  float v = 0.f;
  if (tid < Lp) {
    const float d = (tid < L && t0 + tid < S) ? db[(t0 + tid) * ds.s] : 0.f;
    dts[tid] = d;
    v = __fmul_rn(d, A[h]);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float u = lane < THREADS / 32 ? tot[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < THREADS / 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, u, off);
      if (lane >= off) u += n;
    }
    if (lane < THREADS / 32) tot[lane] = u;
  }
  __syncthreads();
  if (warp > 0) v += tot[warp - 1];
  if (tid < Lp) cum[tid] = v;
  __syncthreads();
  const float cum_last = cum[L - 1];
  if (tid < Lp)
    w[tid] = __fmul_rn(__expf(fmaxf(cum_last - cum[tid], MIN_LOG)), dts[tid]);
  if (tid < L) cum_out[(((long long)b * nc + c) * L + tid) * H + h] = cum[tid];
  if (tid == 0)
    dec[((long long)b * nc + c) * H + h] = __expf(fmaxf(cum_last, MIN_LOG));
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  // 3. y: per strip of 16 rows i, over the 16-key blocks j <= i,
  //    C_i B_j^T (bf16 mma) -> M = decay * C B^T * dt_j in the accumulator
  //    registers -> M X_j (TF32 mma, M as it lies in the registers)
  const int nst = Lp / 16;
  if (warp < (nst + 1) / 2) {
    for (int pass = 0; pass < 2; ++pass) {
      const int si = pass == 0 ? warp : nst - 1 - warp;
      if (pass == 1 && si == warp) break;
      const int i0 = 16 * si;
      uint32_t ca[N / 16][4];
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        ldmatrix_x4(ca[kk], Cs + (i0 + (lane & 15)) * NS + kk * 16 +
                                (lane >> 4) * 8);
      const float ci[2] = {cum[i0 + g], cum[i0 + g + 8]};
      float acc[P / 8][4];
#pragma unroll
      for (int q = 0; q < P / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

      for (int jb = 0; jb <= si; ++jb) {
        const int j0 = 16 * jb;
        float mm[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) mm[hh][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t bf[4];
          ldmatrix_x4(bf, Bs + (j0 + (lane & 7) + ((lane >> 4) << 3)) * NS +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(mm[0], ca[kk], bf[0], bf[1]);
          mma_bf16(mm[1], ca[kk], bf[2], bf[3]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = j0 + 8 * hh + 2 * t;  // and j + 1
          const float2 cj = *reinterpret_cast<const float2*>(cum + j);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + 8 * (e >> 1), jj = j + (e & 1);
            const float cjj = e & 1 ? cj.y : cj.x, djj = e & 1 ? dj.y : dj.x;
            mm[hh][e] =
                jj <= i ? __fmul_rn(__fmul_rn(__expf(fmaxf(ci[e >> 1] - cjj,
                                                           MIN_LOG)),
                                              mm[hh][e]),
                                    djj)
                        : 0.f;
          }
          const uint32_t a[4] = {tf32(mm[hh][0]), tf32(mm[hh][2]),
                                 tf32(mm[hh][1]), tf32(mm[hh][3])};
          const __nv_bfloat16* x0 = Xs + j * PS + g;
#pragma unroll
          for (int q = 0; q < P / 8; ++q)
            mma_tf32(acc[q], a, bf16_bits(x0 + 8 * q),
                     bf16_bits(x0 + PS + 8 * q));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        if (i >= L) continue;
        float* yrow = y + ((((long long)b * nc + c) * L + i) * H + h) * P;
#pragma unroll
        for (int q = 0; q < P / 8; ++q)
          *reinterpret_cast<float2*>(yrow + 8 * q + 2 * t) =
              make_float2(acc[q][2 * r], acc[q][2 * r + 1]);
      }
    }
  }

  // 4. the state sc = (B (.) w)^T X (TF32 mma) over every key of the chunk,
  //    its 16 x 8 tiles shared among the warps
  constexpr int MT = N / 16, NQ = P / 8;
  constexpr int WPM = MT >= 8 ? 1 : 8 / MT < NQ ? 8 / MT : NQ;  // per 16 rows
  constexpr int MPW = MT >= 8 ? MT / 8 : 1;  // 16-row tiles per warp
  constexpr int QPW = NQ / WPM;              // 8-column tiles per warp
  static_assert(NQ % WPM == 0 && MT % MPW == 0, "state tiles do not split");
  float* scb = sc + (((long long)b * nc + c) * H + h) * N * P;
  if (MT < 8 && warp >= MT * WPM) return;  // more warps than state tiles
#pragma unroll
  for (int mi = 0; mi < MPW; ++mi) {
    const int n0 = 16 * (MT >= 8 ? warp + 8 * mi : warp / WPM);
    const int p0 = MT >= 8 ? 0 : (warp % WPM) * QPW * 8;
    float sacc[QPW][4];
#pragma unroll
    for (int q = 0; q < QPW; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[q][e] = 0.f;
    for (int j0 = 0; j0 < Lp; j0 += 8) {
      const int j = j0 + 2 * t;  // and j + 1
      const float2 wj = *reinterpret_cast<const float2*>(w + j);
      const __nv_bfloat16* b0 = Bs + j * NS + n0 + g;
      const uint32_t a[4] = {tf32(bf16_f32(b0) * wj.x),
                             tf32(bf16_f32(b0 + 8) * wj.x),
                             tf32(bf16_f32(b0 + NS) * wj.y),
                             tf32(bf16_f32(b0 + NS + 8) * wj.y)};
      const __nv_bfloat16* x0 = Xs + j * PS + p0 + g;
#pragma unroll
      for (int q = 0; q < QPW; ++q)
        mma_tf32(sacc[q], a, bf16_bits(x0 + 8 * q),
                 bf16_bits(x0 + PS + 8 * q));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* srow = scb + (n0 + g + 8 * r) * P + p0;
#pragma unroll
      for (int q = 0; q < QPW; ++q)
        *reinterpret_cast<float2*>(srow + 8 * q + 2 * t) =
            make_float2(sacc[q][2 * r], sacc[q][2 * r + 1]);
    }
  }
}

template <int N, int P>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, float* y, float* sc, float* dec, float* cum,
           Strides xs, Strides ds, Strides bs, Strides cs, int B, int S,
           int H, int G, int L, int nc, cudaStream_t stream) {
  const size_t bytes = Geo<N, P>::smem(L);
  auto kernel = ssd_intra_tc_kernel<N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nc, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), y, sc, dec, cum, xs, ds, bs, cs,
      S, H, G, L);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

extern "C" {

// Shared memory one block of the kernel of (type, L, N, P) needs, in bytes
// (0 where the tensor-core kernel has no instance).
size_t ssd_intra_chunk_smem_bytes(int bf16, int L, int N, int P) {
  if (!bf16) return smem_floats(L, N, P) * sizeof(float);
  if (L > tc::MAX_L) return 0;
  if (N == 16 && P == 32) return tc::Geo<16, 32>::smem(L);
  if (N == 32 && P == 32) return tc::Geo<32, 32>::smem(L);
  if (N == 16 && P == 64) return tc::Geo<16, 64>::smem(L);
  if (N == 128 && P == 64) return tc::Geo<128, 64>::smem(L);
  return 0;
}

// Launch on ``stream``; returns the cudaError_t of the launch (0 on
// success). ``bf16`` selects __nv_bfloat16 x, Bm and Cm and the
// tensor-core kernel ((N, P) of the port's models: (16, 32), (32, 32),
// (16, 64), (128, 64); L <= 256; 16-byte aligned rows), else float and
// the CUDA-core kernel; dt and A are float. Strides are in elements; the
// grid is (nc, H, B).
int ssd_intra_chunk_launch(const void* x, const float* dt, const float* A,
                           const void* Bm, const void* Cm, float* y,
                           float* sc, float* dec, float* cum, int bf16,
                           int B, int S, int H, int G, int N, int P, int L,
                           int nc, long long xsb, long long xss,
                           long long xsh, long long dsb, long long dss,
                           long long dsh, long long bsb, long long bss,
                           long long bsg, long long csb, long long css,
                           long long csg, cudaStream_t stream) {
  const Strides xs{xsb, xss, xsh}, ds{dsb, dss, dsh}, bs{bsb, bss, bsg},
      cs{csb, css, csg};
  if (bf16) {
    auto go = [&](auto launch) {
      return launch(x, dt, A, Bm, Cm, y, sc, dec, cum, xs, ds, bs, cs, B, S,
                    H, G, L, nc, stream);
    };
    if (L > tc::MAX_L) return (int)cudaErrorInvalidValue;
    if (N == 16 && P == 32) return go(tc::launch<16, 32>);
    if (N == 32 && P == 32) return go(tc::launch<32, 32>);
    if (N == 16 && P == 64) return go(tc::launch<16, 64>);
    if (N == 128 && P == 64) return go(tc::launch<128, 64>);
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = smem_floats(L, N, P) * sizeof(float);
  auto kernel = ssd_intra_kernel<float>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(nc, H, B), THREADS, bytes, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), y, sc, dec, cum, xs, ds, bs, cs, S, H,
      G, N, P, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
