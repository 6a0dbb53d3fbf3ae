// Mamba-2 SSD intra-chunk pass, one thread block per (chunk, head, batch).
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/ssd/ssd.py::ssd_intra_chunk (_kernel). Over one chunk of
// length L, with head dim P and state N, in f32:
//
//   cum     = cumsum(dt * A)                                        (L,)
//   y_intra = (tril(exp(max(cum_i - cum_j, -30))) * C B^T * dt_j) X   (L, P)
//   sc      = sum_j exp(max(cum_L - cum_j, -30)) dt_j B_j x_j^T       (N, P)
//   dec     = exp(max(cum_L, -30))
//
// The inter-chunk recurrence stays in PyTorch (ops.py), as it stays in jnp
// in the reference.
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
// first kernel computes in f32 on the CUDA cores; tensor-core tiles are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TI = 64;  // rows i per tile
constexpr int TJ = 64;  // rows j per streamed tile
constexpr int THREADS = 256;
constexpr float MIN_LOG = -30.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
size_t ssd_intra_chunk_smem_bytes(int L, int N, int P) {
  return smem_floats(L, N, P) * sizeof(float);
}

// Launch on ``stream``; returns the cudaError_t of the launch (0 on
// success). ``bf16`` selects __nv_bfloat16 x, Bm and Cm, else float; dt and
// A are float. Strides are in elements; the grid is (nc, H, B).
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
  const size_t bytes = smem_floats(L, N, P) * sizeof(float);
  dim3 grid(nc, H, B);
  cudaError_t err;
  if (bf16) {
    auto kernel = ssd_intra_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(x), dt, A,
        static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(Cm), y, sc, dec, cum, xs, ds, bs,
        cs, S, H, G, N, P, L);
  } else {
    auto kernel = ssd_intra_kernel<float>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), y, sc, dec, cum, xs, ds, bs, cs, S, H,
        G, N, P, L);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
