// DPM candidate cost tables (Definitions 1-2), one thread block per packet.
//
// Replaces the reference's Pallas kernels
// src/repro/kernels/dpm_cost/dpm_cost.py::dpm_cost_table (_kernel) and
// ::dpm_cost_table_weighted (_weighted_kernel). For each packet and each of
// the 24 candidates (8 basic wedges around the source, 8 consecutive pairs,
// 8 consecutive triples):
//
//   rep[c]  = the selected node of least key dist(S, d) * 2^20 + snake label
//   cost[c] = sum over selected d of dist(rep, d)            (+ S->rep leg)
//
// with cost 0 and rep -1 for an empty candidate.
//
// Design. The Pallas kernel holds a tile of packets x all NN nodes in VMEM
// and evaluates every candidate's selection as a full (TP, NN) mask. Here a
// block owns one packet and its threads stride over the NN nodes:
//   1. each node's wedge (or none: the source, or not a destination) goes to
//      shared memory, and each thread keeps the least key it saw per wedge;
//   2. one block reduction gives the least key of each wedge; since keys are
//      unique (the label part is), the least key of a candidate's union is
//      the least of its wedges' least keys, and the key names its node;
//   3. each destination lies in 6 of the 24 candidates and adds its
//      distance from each one's representative: into shared-memory integer
//      atomics for the int table (exact in any order); for the float table
//      one candidate at a time, each thread over its nodes in order, then a
//      fixed-order block reduction (so its float sums do not depend on
//      timing);
//   4. the leg is added once per candidate.
// Bound: the mask is read once (NN int32 per packet), so the kernel moves
// ~4 * NN bytes per packet; the work is integer compares and adds over the
// packet's NN nodes, a few tens of operations per node. Neither tensor cores
// nor float units help; one block per packet keeps every reduction inside
// one SM with no second pass. Registers bound how many blocks an SM holds,
// which is why no thread keeps 24 accumulators live at once.
//
// Arithmetic follows the reference exactly: torus displacements use
// floor-mod (written out, since C++ '%' truncates toward zero); keys wrap in
// uint32 like int32 in jnp; the weighted kernel truncates dist to int32,
// gathers weight rows by index (no matrix product), and rounds each float
// addition and product on its own (no fused multiply-add), in the
// reference's order: sum of weights, + max(count - 1, 0) * overhead, + leg.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NC = 24;          // candidates
constexpr int NW = 8;           // basic wedges
constexpr int BIG = 1 << 20;    // key = dist * BIG + label
constexpr int EMPTY_KEY = 1 << 30;
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;

__device__ __forceinline__ int ring_delta(int d, int size, int wrap) {
  if (!wrap || size <= 1) return d;
  int h = size / 2;
  int r = (d + h) % size;
  if (r < 0) r += size;  // floor-mod
  return r - h;
}

// P0..P7 counter-clockwise from the upper-right quadrant (Fig. 2a); -1 for
// the source itself
__device__ __forceinline__ int wedge_of(int dx, int dy) {
  if (dy > 0) return dx > 0 ? 0 : (dx == 0 ? 1 : 2);
  if (dy < 0) return dx < 0 ? 4 : (dx == 0 ? 5 : 6);
  return dx < 0 ? 3 : (dx > 0 ? 7 : -1);
}

// wedge bit set of candidate c: c % 8 and the next c / 8 wedges (mod 8)
__host__ __device__ constexpr unsigned cand_bits(int c) {
  return c < 8 ? (1u << (c % 8))
       : c < 16 ? (1u << (c % 8)) | (1u << ((c + 1) % 8))
       : (1u << (c % 8)) | (1u << ((c + 1) % 8)) | (1u << ((c + 2) % 8));
}

// the k-th (k < 6) candidate holding wedge w: the single, the pairs that
// start at w and w - 1, the triples that start at w, w - 1 and w - 2
__device__ __forceinline__ int cand_of_wedge(int w, int k) {
  switch (k) {
    case 0: return w;
    case 1: return 8 + w;
    case 2: return 8 + (w + 7) % 8;
    case 3: return 16 + w;
    case 4: return 16 + (w + 7) % 8;
    default: return 16 + (w + 6) % 8;
  }
}

__device__ __forceinline__ int snake_label(int x, int y, int n) {
  return (y % 2 == 0) ? y * n + x : y * n + (n - 1 - x);
}

__device__ __forceinline__ int node_of_label(int lab, int n) {
  int y = lab / n, r = lab % n;
  return y * n + ((y % 2 == 0) ? r : n - 1 - r);
}

struct Shared {
  int wmin[MAX_WARPS][NW];   // per-warp least keys of each wedge
  float fsum[MAX_WARPS][NC]; // per-warp partial sums (float table)
  int cnt[MAX_WARPS][NC];
  int sum[NC];               // candidate sums (int table)
  int rep[NC];
};

// Steps 1-2: per-node wedges into s_w (-1: not selected) and the
// representative of every candidate into sh.rep (-1: empty candidate).
// ``dsrc_row`` is null for coordinate distances, else the source's row of
// the route-distance tensor.
__device__ void representatives(const int* __restrict__ mask, int NN, int n,
                                int m, int wrap, int sx, int sy,
                                const float* __restrict__ dsrc_row,
                                signed char* s_w, Shared& sh) {
  int kmin[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) kmin[w] = EMPTY_KEY;
  for (int v = threadIdx.x; v < NN; v += blockDim.x) {
    int x = v % n, y = v / n;
    int dx = ring_delta(x - sx, n, wrap), dy = ring_delta(y - sy, m, wrap);
    int w = mask[v] > 0 ? wedge_of(dx, dy) : -1;
    s_w[v] = (signed char)w;
    if (w < 0) continue;
    int dsrc = dsrc_row ? __float2int_rz(dsrc_row[v]) : abs(dx) + abs(dy);
    int key = (int)((unsigned)dsrc * (unsigned)BIG + (unsigned)snake_label(x, y, n));
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j == w) kmin[j] = min(kmin[j], key);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    int k = kmin[j];
    for (int o = 16; o > 0; o >>= 1) k = min(k, __shfl_down_sync(0xffffffffu, k, o));
    if (lane == 0) sh.wmin[warp][j] = k;
  }
  __syncthreads();
  if (threadIdx.x < NC) {
    const int c = threadIdx.x;
    const int nwarps = (blockDim.x + 31) >> 5;
    int best = EMPTY_KEY;
    for (int j = 0; j < NW; ++j) {
      if (!((cand_bits(c) >> j) & 1u)) continue;
      for (int q = 0; q < nwarps; ++q) best = min(best, sh.wmin[q][j]);
    }
    sh.rep[c] = best == EMPTY_KEY ? -1 : node_of_label(best & (BIG - 1), n);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(MAX_THREADS)
cost_table_kernel(const int* __restrict__ mask, const int* __restrict__ sxy,
                  int* __restrict__ costs, int* __restrict__ reps, int n,
                  int m, int wrap, int leg) {
  extern __shared__ signed char s_w[];  // NN wedge ids
  __shared__ Shared sh;
  const int p = blockIdx.x, NN = n * m;
  const int sx = sxy[2 * p], sy = sxy[2 * p + 1];
  if (threadIdx.x < NC) sh.sum[threadIdx.x] = 0;  // ordered by the syncs below
  representatives(mask + (size_t)p * NN, NN, n, m, wrap, sx, sy, nullptr,
                  s_w, sh);
  for (int v = threadIdx.x; v < NN; v += blockDim.x) {
    int w = s_w[v];
    if (w < 0) continue;
    int x = v % n, y = v / n;
    for (int k = 0; k < 6; ++k) {
      int c = cand_of_wedge(w, k), r = sh.rep[c];
      atomicAdd(&sh.sum[c], abs(ring_delta(x - r % n, n, wrap)) +
                                abs(ring_delta(y - r / n, m, wrap)));
    }
  }
  __syncthreads();
  if (threadIdx.x < NC) {
    const int c = threadIdx.x, r = sh.rep[c];
    int ct = sh.sum[c];
    if (leg && r >= 0)
      ct += abs(ring_delta(r % n - sx, n, wrap)) +
            abs(ring_delta(r / n - sy, m, wrap));
    costs[(size_t)p * NC + c] = r >= 0 ? ct : 0;
    reps[(size_t)p * NC + c] = r;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
cost_table_weighted_kernel(const int* __restrict__ mask,
                           const int* __restrict__ sxy,
                           const float* __restrict__ dist,
                           const float* __restrict__ weight,
                           float* __restrict__ costs, int* __restrict__ reps,
                           int n, int m, int wrap, int leg, float overhead) {
  extern __shared__ signed char s_w[];  // NN wedge ids
  __shared__ Shared sh;
  const int p = blockIdx.x, NN = n * m;
  const int sx = sxy[2 * p], sy = sxy[2 * p + 1];
  const size_t src = (size_t)(sy * n + sx);
  representatives(mask + (size_t)p * NN, NN, n, m, wrap, sx, sy,
                  dist + src * NN, s_w, sh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int c = 0; c < NC; ++c) {
    const unsigned bits = cand_bits(c);
    const float* row = weight + (size_t)max(sh.rep[c], 0) * NN;
    float s = 0.f;
    int k = 0;
    for (int v = threadIdx.x; v < NN; v += blockDim.x) {
      int w = s_w[v];
      if (w < 0 || !((bits >> w) & 1u)) continue;
      s = __fadd_rn(s, row[v]);
      k += 1;
    }
    for (int o = 16; o > 0; o >>= 1) {
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
      k += __shfl_down_sync(0xffffffffu, k, o);
    }
    if (lane == 0) {
      sh.fsum[warp][c] = s;
      sh.cnt[warp][c] = k;
    }
  }
  __syncthreads();
  if (threadIdx.x < NC) {
    const int c = threadIdx.x, r = sh.rep[c];
    const int nwarps = (blockDim.x + 31) >> 5;
    float ct = 0.f;
    int k = 0;
    for (int q = 0; q < nwarps; ++q) {
      ct = __fadd_rn(ct, sh.fsum[q][c]);
      k += sh.cnt[q][c];
    }
    ct = __fadd_rn(ct, __fmul_rn(fmaxf((float)k - 1.f, 0.f), overhead));
    if (leg && r >= 0) ct = __fadd_rn(ct, weight[src * NN + r]);
    costs[(size_t)p * NC + c] = r >= 0 ? ct : 0.f;
    reps[(size_t)p * NC + c] = r;
  }
}

int threads_for(int NN) {
  int t = ((NN + 31) / 32) * 32;
  return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

}  // namespace

extern "C" {

// Launch on ``stream``; returns the cudaError_t of the launch (0 on success).
int dpm_cost_table_launch(const int* mask, const int* sxy, int* costs,
                          int* reps, int P, int n, int m, int wrap, int leg,
                          cudaStream_t stream) {
  const int NN = n * m;
  cost_table_kernel<<<P, threads_for(NN), NN, stream>>>(
      mask, sxy, costs, reps, n, m, wrap, leg);
  return (int)cudaGetLastError();
}

int dpm_cost_table_weighted_launch(const int* mask, const int* sxy,
                                   const float* dist, const float* weight,
                                   float* costs, int* reps, int P, int n,
                                   int m, int wrap, int leg, float overhead,
                                   cudaStream_t stream) {
  const int NN = n * m;
  cost_table_weighted_kernel<<<P, threads_for(NN), NN, stream>>>(
      mask, sxy, dist, weight, costs, reps, n, m, wrap, leg, overhead);
  return (int)cudaGetLastError();
}

}  // extern "C"
