// Segmented minimum of int32 age keys: one arbitration round of the NoC.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/noc_step/noc_step.py::segmented_min (_kernel). Given N
// candidates, each an age key and the resource (segment) it contends for,
//
//   out[r] = min(NOC_INF, min{keys[i] : segs[i] == r})     for r in [0, L)
//
// Candidates whose segment lies outside [0, L) (the stepper's padding, which
// carries NOC_INF keys by contract) are skipped, as the Pallas kernel skips
// them (no resource row matches them); no write leaves `out`.
//
// Design. The Pallas grid compares every (resource tile, candidate tile)
// pair, O(N * L) compares, which suits a TPU vector tile. Here the work is
// O(N + L):
//   1. a fill kernel sets out[0, L) to NOC_INF (2^30 is not a repeated byte,
//      so cudaMemset cannot);
//   2. a grid-stride pass gives each live candidate (key < NOC_INF, segment
//      in range) one signed 32-bit atomicMin on out[seg]. Keys at or above
//      NOC_INF never touch memory, which caps them at NOC_INF as both
//      references do.
// The minimum does not depend on the order of the atomics, so the result is
// the same bits on every run. Before its atomic a thread reads out[seg]
// through L2 and skips the atomic when its key is not below that value:
// `out` only decreases, so a value read earlier is never below the current
// one and the skip is safe. Where many candidates wait on one resource (a
// hot spot), most of them skip, so the atomics on one address do not
// serialise the pass.
// Bound: bytes. Keys and segments are read once (8 N bytes) and `out`
// written once (4 L bytes); the integer work per candidate is a handful of
// operations, far below the card's int32 issue rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NOC_INF = 1 << 30;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__global__ void segmin_fill_kernel(int* __restrict__ out, int L) {
  for (int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; r < L;
       r += (int64_t)gridDim.x * blockDim.x) {
    out[r] = NOC_INF;
  }
}

__global__ void segmin_kernel(const int* __restrict__ keys,
                              const int* __restrict__ segs,
                              int* __restrict__ out, int64_t N, int L) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < N;
       i += (int64_t)gridDim.x * blockDim.x) {
    int key = keys[i];
    int seg = segs[i];
    if (key >= NOC_INF || seg < 0 || seg >= L) continue;
    if (key < __ldcg(out + seg)) atomicMin(out + seg, key);
  }
}

int blocks_for(int64_t n) {
  int64_t b = (n + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

// out[L] <- the segmented minimum of (keys[N], segs[N]); all int32, device
// pointers, launched on `stream`. Returns the first CUDA error (0 on
// success).
extern "C" int segmented_min_launch(const int* keys, const int* segs,
                                    int* out, long long N, int L,
                                    cudaStream_t stream) {
  if (L <= 0) return 0;
  segmin_fill_kernel<<<blocks_for(L), THREADS, 0, stream>>>(out, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || N <= 0) return (int)err;
  segmin_kernel<<<blocks_for(N), THREADS, 0, stream>>>(keys, segs, out, N, L);
  return (int)cudaGetLastError();
}
