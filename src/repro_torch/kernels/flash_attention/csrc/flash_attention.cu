// Causal GQA flash attention (forward), one thread block per
// (64-row query tile, head, batch).
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (_kernel): for each query row i at position q_offset + i,
//
//   out[i] = softmax_k( (q_i * D^-1/2) . k_k  masked ) @ v
//
// with KV head h / G, a key visible when k < Sk, k <= q (causal) and
// k > q - window (sliding window), masked scores set to the finite -1e30,
// an online softmax in f32 and the output in the input type.
//
// Design. The Pallas kernel walks the key blocks on the sequential last
// grid axis and keeps (m, l, acc) in VMEM scratch. Here one block owns a
// 64-row query tile and walks the 64-key tiles itself, in ascending order,
// skipping the tiles the reference skips (first_k <= last_q under the causal
// mask, last_k > first_q - window under the window). The query tile, the
// key tile (transposed) and the value tile sit in shared memory as f32; the
// 256 threads form a 16 x 16 grid, each owning rows ty + 16 i (i < 4): it
// computes 4 x 4 scores, takes the row max and sum with shuffles over the 16
// threads of a row, and keeps its rows' running (m, l) and a 4 x D/16 slice
// of the accumulator in registers. The probabilities pass through shared
// memory to the P.V product.
//
// The ascending walk matters: with the finite -1e30, a row whose first live
// tile is fully masked (a window row) accumulates exp(0) terms, which the
// correction exp(-1e30 - m) = 0 cancels exactly once a visible key arrives
// in a later tile. -INFINITY would give NaN; another order another result.
//
// Bound: at the serving shapes (S ~ 2000, D = 64) the work is ~4 D
// operations per visible (query, key) pair against 2 D elements read per
// key tile, so operations bound it. This first kernel computes in f32 on
// the CUDA cores, not the tensor cores (f32 inputs must stay f32 to meet
// the 1e-4 tolerance); wgmma tiles for bf16 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  long long b, s, h;  // in elements; the head dim is contiguous
};

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * D + (size_t)D * (BK + 1) + (size_t)BK * D +
         (size_t)BQ * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
    Strides vs, int Sq, int Sk, int H, int G, int causal, int window,
    int q_offset, float scale) {
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][D], pre-scaled
  float* Kt = Qs + BQ * D;         // [D][BK + 1], transposed
  float* Vs = Kt + D * (BK + 1);   // [BK][D]
  float* Ps = Vs + BK * D;         // [BQ][BK]

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
      const bool in = key < Sk;
      Kt[d * (BK + 1) + c] = in ? to_f32(kb[key * ks.s + d]) : 0.f;
      Vs[e] = in ? to_f32(vb[key * vs.s + d]) : 0.f;
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
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
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
    T* orow = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(orow + tx + 16 * j, acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           Strides qs, Strides ks, Strides vs, int B, int Sq, int Sk, int H,
           int KH, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, Sq, Sk, H,
      H / KH, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             Strides qs, Strides ks, Strides vs, int B, int Sq, int Sk,
             int H, int KH, int causal, int window, int q_offset,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, qs, ks, vs, B, Sq, Sk, H, KH, causal,
                           window, q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, qs, ks, vs, B, Sq, Sk, H, KH, causal,
                           window, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, qs, ks, vs, B, Sq, Sk, H, KH, causal,
                           window, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, qs, ks, vs, B, Sq, Sk, H, KH,
                            causal, window, q_offset, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on ``stream``; returns the cudaError_t of the launch (0 on
// success). ``bf16`` selects __nv_bfloat16 inputs and output, else float;
// ``window`` <= 0 means no window; strides are in elements.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int bf16, int B, int Sq, int Sk, int H,
                           int KH, int D, long long qsb, long long qss,
                           long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss,
                           long long vsh, int causal, int window,
                           int q_offset, float scale, cudaStream_t stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  if (bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, qs, ks, vs, B, Sq, Sk, H,
                                   KH, causal, window, q_offset, scale,
                                   stream);
  return launch_d<float>(D, q, k, v, o, qs, ks, vs, B, Sq, Sk, H, KH,
                         causal, window, q_offset, scale, stream);
}

}  // extern "C"
