// DPM candidate cost tables (Definitions 1-2): one warp per packet over its
// destinations (the default route, "warp"), and one thread block per packet
// over all its nodes (the route kept for comparison, "block").
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
// Bound: the mask is read once (NN int32 per packet), so a table moves
// ~4 * NN bytes per packet; the work is integer compares and adds, a few
// tens of operations per node and per (destination, candidate). Neither
// tensor cores nor float units help. The Pallas kernel holds a tile of
// packets x all NN nodes in VMEM and evaluates every candidate as a full
// (TP, NN) mask; a packet has a handful of destinations among NN nodes, so
// almost all of that work finds nothing.
//
// Warp route. A block holds up to 8 packets, one warp each, with no block
// barrier; a warp past the last packet exits as a whole.
//   1. The warp streams the packet's mask row once (16-byte streaming loads
//      where rows are 16-byte aligned, else 4-byte ones) and compacts it, by
//      __ballot_sync and __popc ranks, into a list of the packet's
//      destinations in ascending node order in shared memory (2 bytes a
//      node; the source is never listed).
//   2. Destinations go 32 at a time, one per lane: each lane finds its
//      node's coordinates (a multiply by a reciprocal, no division), wedge
//      and key, and takes the key into its wedge's least key by a
//      shared-memory atomicMin. Keys are unique (the label part is), so
//      lane c < 24 takes candidate c's representative as the least of its
//      wedges' minima.
//   3. Lane c sums over the destinations whose wedge lies in candidate c,
//      in ascending node order. The int table: the warp steps through the
//      destinations, each handed to every lane by __shfl_sync, and lane c
//      adds its distance from the representative (exact in any order). The
//      weighted table: each lane first gathers, for its own destination,
//      the weights from the representatives of the 6 candidates holding it
//      (independent loads from L2, where the two route tensors stay) into
//      shared memory; then lane c steps through them in order, summing in
//      double precision, rounded once to float. That sum is exact wherever
//      the reference's float sums are (the dyadic hops and weighted
//      prices); under other prices it is the true sum to float rounding,
//      where a float sum in this order can drift from the reference's by
//      more than 1e-6 relative on a packet of ~230 destinations. No sum
//      depends on timing or on other lanes.
//   4. The leg; lane c writes costs[p][c] and reps[p][c] (coalesced).
// The stream is O(NN) per packet, the rest O(destinations); a packet with
// hundreds of destinations takes its warp hundreds of serial steps.
//
// Block route (the first design). A block owns one packet and its threads
// stride over the NN nodes: per-node wedges in shared memory, a block
// reduction of per-warp least keys, then each destination adds into the 6
// candidates holding it (shared-memory integer atomics; the float table one
// candidate at a time, then a fixed-order block reduction). Most threads
// find nothing to do and every block pays its barriers.
//
// Arithmetic follows the reference exactly on both routes: torus
// displacements use floor-mod (written out, since C++ '%' truncates toward
// zero); keys wrap in uint32 like int32 in jnp; the weighted kernels
// truncate dist to int32, gather weight rows by index (no matrix product),
// and round each float addition and product on its own (no fused
// multiply-add), in the reference's order: sum of weights, + max(count - 1,
// 0) * overhead, + leg.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NC = 24;          // candidates
constexpr int NW = 8;           // basic wedges
constexpr int BIG = 1 << 20;    // key = dist * BIG + label
constexpr int EMPTY_KEY = 1 << 30;
constexpr int MAX_THREADS = 256;  // block route
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

// ---- block route ---------------------------------------------------------

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

// ---- warp route ----------------------------------------------------------

constexpr int MAX_WARPS_PER_BLOCK = 8;
constexpr int DEFAULT_SMEM = 48 * 1024;  // dynamic shared memory without opt-in

// A warp's shared memory: its packet's least key per wedge, the weights
// one chunk of destinations gathered (the weighted table), then the
// destination list, 2 bytes a node, rounded up to 16 bytes.
struct WarpSmem {
  int wmin[NW];
  float chunk_w[32][6];  // [destination][its k-th candidate]
  unsigned short list[8];  // runs on to NN entries
};

__host__ __device__ inline int warp_smem_bytes(int NN) {
  return (int)(sizeof(WarpSmem) - sizeof(WarpSmem::list)) + (2 * NN + 15) / 16 * 16;
}

// Packets (warps) per block: as many as fit in 48 KB, at most 8; one above
// ~24,000 nodes, where the launch opts in to more shared memory.
__host__ __device__ inline int warp_route_warps(int NN) {
  const int w = DEFAULT_SMEM / warp_smem_bytes(NN);
  return w < 1 ? 1 : (w > MAX_WARPS_PER_BLOCK ? MAX_WARPS_PER_BLOCK : w);
}

// ceil(2^32 / n): v / n == (v * magic) >> 32 whenever v * n < 2^32, which
// NN <= 32,768 gives every node id and snake label
__host__ __device__ inline unsigned long long div_magic(int n) {
  return ((1ull << 32) + n - 1) / n;
}

__device__ __forceinline__ int div_n(int v, unsigned long long magic) {
  return (int)(((unsigned long long)v * magic) >> 32);
}

// ring_delta for displacements in (-size, size), the only ones the warp
// route forms (both ends are coordinates): the same floor-mod as one
// conditional add and one conditional subtract
template <bool WRAP>
__device__ __forceinline__ int ring_delta_near(int d, int size) {
  if (!WRAP || size <= 1) return d;
  int r = d + size / 2;
  r += r < 0 ? size : 0;
  r -= r >= size ? size : 0;
  return r - size / 2;
}

struct Node {
  int x, y;  // coordinates
  int w;     // wedge around the source (-1: past the last destination)
  int d;     // coordinate distance from the source
};

// One packet as its warp holds it in shared memory: the destinations other
// than the source in ascending node order, and the least key of each
// wedge.
template <bool WRAP>
struct Packet {
  WarpSmem* sm;
  int D;  // destinations
  int n, m, sx, sy;
  unsigned long long magic;

  __device__ __forceinline__ int dist(int ax, int ay, int bx, int by) const {
    return abs(ring_delta_near<WRAP>(ax - bx, n)) +
           abs(ring_delta_near<WRAP>(ay - by, m));
  }

  // the lane's node of the chunk of 32 destinations starting at q
  __device__ __forceinline__ Node at(int q) const {
    const int k = q + (int)(threadIdx.x & 31);
    if (k >= D) return {0, 0, -1, 0};
    const int v = sm->list[k], y = div_n(v, magic), x = v - y * n;
    const int dx = ring_delta_near<WRAP>(x - sx, n);
    const int dy = ring_delta_near<WRAP>(y - sy, m);
    return {x, y, wedge_of(dx, dy), abs(dx) + abs(dy)};
  }
};

// Step 1: stream the mask row once into ``list``; returns the number of
// destinations. A turn covers 128 nodes, 4 per lane, with 16-byte loads
// where rows are 16-byte aligned (``vec``), else 32 nodes with 4-byte loads.
// A node's slot is its rank among the turn's destinations, counted from the
// ballots of the lanes below it.
__device__ int stream_row(const int* __restrict__ row, int NN, int src,
                          int vec, unsigned short* list) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int D = 0;
  if (vec) {
    for (int base = 0; base < NN; base += 128) {
      const int v = base + 4 * lane;
      int4 q = make_int4(0, 0, 0, 0);
      if (v < NN) q = __ldcs(reinterpret_cast<const int4*>(row + v));
      const bool s0 = q.x > 0 && v != src, s1 = q.y > 0 && v + 1 != src;
      const bool s2 = q.z > 0 && v + 2 != src, s3 = q.w > 0 && v + 3 != src;
      const unsigned b0 = __ballot_sync(FULL, s0), b1 = __ballot_sync(FULL, s1);
      const unsigned b2 = __ballot_sync(FULL, s2), b3 = __ballot_sync(FULL, s3);
      int k = D + __popc(b0 & below) + __popc(b1 & below) +
              __popc(b2 & below) + __popc(b3 & below);
      if (s0) list[k++] = (unsigned short)v;
      if (s1) list[k++] = (unsigned short)(v + 1);
      if (s2) list[k++] = (unsigned short)(v + 2);
      if (s3) list[k] = (unsigned short)(v + 3);
      D += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
    }
  } else {
    for (int base = 0; base < NN; base += 32) {
      const int v = base + lane;
      const bool s = v < NN && v != src && __ldcs(row + v) > 0;
      const unsigned b = __ballot_sync(FULL, s);
      if (s) list[D + __popc(b & below)] = (unsigned short)v;
      D += __popc(b);
    }
  }
  __syncwarp();
  return D;
}

// Step 2: the representative of candidate c in lane c < 24 (-1: empty; -1
// in the other lanes). Each lane keys its own destination of every chunk
// into the warp's least key per wedge (shared-memory atomicMin); candidate
// c's representative has the least key of its wedges c % 8 and the next
// c / 8. ``first`` is chunk 0, ``dsrc_row`` null for coordinate distances,
// else the source's row of the route-distance tensor.
template <class Pk>
__device__ int representative(const Pk& pk, const Node& first,
                              const float* __restrict__ dsrc_row) {
  const int c = threadIdx.x & 31;
  int* wmin = pk.sm->wmin;
  if (c < NW) wmin[c] = EMPTY_KEY;
  __syncwarp();
  for (int q = 0; q < pk.D; q += 32) {
    const Node a = q ? pk.at(q) : first;
    if (a.w < 0) continue;
    const int dsrc =
        dsrc_row ? __float2int_rz(dsrc_row[a.y * pk.n + a.x]) : a.d;
    atomicMin(&wmin[a.w], (int)((unsigned)dsrc * (unsigned)BIG +
                                (unsigned)snake_label(a.x, a.y, pk.n)));
  }
  __syncwarp();
  if (c >= NC) return -1;
  int best = wmin[c % 8];
  if (c >= 8) best = min(best, wmin[(c + 1) % 8]);
  if (c >= 16) best = min(best, wmin[(c + 2) % 8]);
  if (best == EMPTY_KEY) return -1;
  const int lab = best & (BIG - 1), y = div_n(lab, pk.magic), t = lab - y * pk.n;
  return y * pk.n + ((y % 2 == 0) ? t : pk.n - 1 - t);
}

// Step 3 of the int table: in lane c < 24, the sum of the distances from
// (rx, ry) of the destinations whose wedge lies in candidate c. Chunk by
// chunk, each lane holds its own destination and the warp steps through
// the chunk, every node shuffled to every lane. All 32 lanes take part.
template <class Pk>
__device__ __forceinline__ int int_sum(const Pk& pk, const Node& first,
                                       int rx, int ry) {
  const int c = threadIdx.x & 31;
  const unsigned cb = c < NC ? cand_bits(c) : 0u;
  int sum = 0;
  for (int q = 0; q < pk.D; q += 32) {
    const Node a = q ? pk.at(q) : first;
    const int wx = a.w | a.x << 3, cnt = min(32, pk.D - q);
    for (int t = 0; t < cnt; ++t) {
      const int bx = __shfl_sync(FULL, wx, t), by = __shfl_sync(FULL, a.y, t);
      if ((cb >> (bx & 7)) & 1u) sum += pk.dist(bx >> 3, by, rx, ry);
    }
  }
  return sum;
}

// Step 3 of the weighted table: in lane c < 24, the sum in double precision
// of weight[rep_c][d] over the destinations d of candidate c in ascending
// node order, and their count. Chunk by chunk, each lane first gathers its
// own destination's weights from the representatives of the 6 candidates
// holding it (6 independent loads: one round trip to L2 for the chunk) into
// shared memory; then lane c steps through the chunk, reading the weight of
// its own candidate (slot kbase + the wedge's offset in the candidate).
template <class Pk>
__device__ __forceinline__ void weighted_sum(const Pk& pk, const Node& first,
                                             int r, const float* __restrict__ weight,
                                             double& s, int& k) {
  const int c = threadIdx.x & 31, NN = pk.n * pk.m;
  const unsigned cb = c < NC ? cand_bits(c) : 0u;
  const int kbase = c < 8 ? 0 : (c < 16 ? 1 : 3);
  float(*chunk_w)[6] = pk.sm->chunk_w;
  for (int q = 0; q < pk.D; q += 32) {
    const Node a = q ? pk.at(q) : first;
    const int v = a.y * pk.n + a.x;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int rc = __shfl_sync(FULL, r, a.w < 0 ? 0 : cand_of_wedge(a.w, j));
      if (a.w >= 0) chunk_w[c][j] = weight[(size_t)rc * NN + v];
    }
    __syncwarp();
    const int cnt = min(32, pk.D - q);
    for (int t = 0; t < cnt; ++t) {
      const int w = __shfl_sync(FULL, a.w, t);
      if ((cb >> w) & 1u) {
        s = __dadd_rn(s, (double)chunk_w[t][kbase + ((w - c) & 7)]);
        ++k;
      }
    }
    __syncwarp();  // every lane is done with the chunk's weights
  }
}

template <bool WRAP>
__global__ void __launch_bounds__(MAX_WARPS_PER_BLOCK * 32)
cost_table_warp_kernel(const int* __restrict__ mask,
                       const int* __restrict__ sxy, int* __restrict__ costs,
                       int* __restrict__ reps, int P, int n, int m, int leg,
                       int vec, unsigned long long magic) {
  extern __shared__ __align__(16) unsigned char s_warps[];  // per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp, NN = n * m;
  if (p >= P) return;
  WarpSmem* sm = reinterpret_cast<WarpSmem*>(s_warps + warp * warp_smem_bytes(NN));
  const int sx = sxy[2 * p], sy = sxy[2 * p + 1];
  const int D = stream_row(mask + (size_t)p * NN, NN, sy * n + sx, vec, sm->list);
  const Packet<WRAP> pk{sm, D, n, m, sx, sy, magic};
  const Node first = pk.at(0);  // most packets have at most 32 destinations
  const int r = representative(pk, first, nullptr);
  const int ry = r >= 0 ? div_n(r, magic) : 0, rx = r - ry * n;
  int ct = int_sum(pk, first, rx, ry);
  if (lane >= NC) return;
  if (leg && r >= 0) ct += pk.dist(rx, ry, sx, sy);
  costs[(size_t)p * NC + lane] = r >= 0 ? ct : 0;
  reps[(size_t)p * NC + lane] = r;
}

template <bool WRAP>
__global__ void __launch_bounds__(MAX_WARPS_PER_BLOCK * 32)
cost_table_weighted_warp_kernel(const int* __restrict__ mask,
                                const int* __restrict__ sxy,
                                const float* __restrict__ dist,
                                const float* __restrict__ weight,
                                float* __restrict__ costs,
                                int* __restrict__ reps, int P, int n, int m,
                                int leg, float overhead, int vec,
                                unsigned long long magic) {
  extern __shared__ __align__(16) unsigned char s_warps[];  // per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp, NN = n * m;
  if (p >= P) return;
  WarpSmem* sm = reinterpret_cast<WarpSmem*>(s_warps + warp * warp_smem_bytes(NN));
  const int sx = sxy[2 * p], sy = sxy[2 * p + 1];
  const size_t src = (size_t)(sy * n + sx);
  const int D = stream_row(mask + (size_t)p * NN, NN, (int)src, vec, sm->list);
  const Packet<WRAP> pk{sm, D, n, m, sx, sy, magic};
  const Node first = pk.at(0);  // most packets have at most 32 destinations
  const int r = representative(pk, first, dist + src * NN);
  double s = 0.0;
  int k = 0;
  weighted_sum(pk, first, r, weight, s, k);
  if (lane >= NC) return;
  float ct = __fadd_rn(__double2float_rn(s),
                       __fmul_rn(fmaxf((float)k - 1.f, 0.f), overhead));
  if (leg && r >= 0) ct = __fadd_rn(ct, weight[src * NN + r]);
  costs[(size_t)p * NC + lane] = r >= 0 ? ct : 0.f;
  reps[(size_t)p * NC + lane] = r;
}

// the warp route streams rows with 16-byte loads where every row is
// 16-byte aligned
__host__ int rows_aligned(const int* mask, int NN) {
  return NN % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
}

template <class... Params, class... Args>
int launch(void (*kernel)(Params...), int blocks, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t e = cudaSuccess;
  if (smem > (size_t)DEFAULT_SMEM)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// the warp route's launch shape: blocks, threads and shared bytes
struct WarpShape {
  int blocks, threads;
  size_t smem;
};

__host__ inline WarpShape warp_shape(int P, int NN) {
  const int w = warp_route_warps(NN);
  return {(P + w - 1) / w, 32 * w, (size_t)w * warp_smem_bytes(NN)};
}

}  // namespace

extern "C" {

// Launch on ``stream`` by route (``block`` 0: the warp route, 1: the block
// route); returns the cudaError_t of the launch (0 on success).
int dpm_cost_table_launch(const int* mask, const int* sxy, int* costs,
                          int* reps, int P, int n, int m, int wrap, int leg,
                          int block, cudaStream_t stream) {
  const int NN = n * m;
  if (block)
    return launch(cost_table_kernel, P, threads_for(NN), NN, stream, mask,
                  sxy, costs, reps, n, m, wrap, leg);
  const WarpShape g = warp_shape(P, NN);
  return launch(wrap ? cost_table_warp_kernel<true>
                     : cost_table_warp_kernel<false>,
                g.blocks, g.threads, g.smem, stream, mask, sxy, costs, reps,
                P, n, m, leg, rows_aligned(mask, NN), div_magic(n));
}

int dpm_cost_table_weighted_launch(const int* mask, const int* sxy,
                                   const float* dist, const float* weight,
                                   float* costs, int* reps, int P, int n,
                                   int m, int wrap, int leg, float overhead,
                                   int block, cudaStream_t stream) {
  const int NN = n * m;
  if (block)
    return launch(cost_table_weighted_kernel, P, threads_for(NN), NN, stream,
                  mask, sxy, dist, weight, costs, reps, n, m, wrap, leg,
                  overhead);
  const WarpShape g = warp_shape(P, NN);
  return launch(wrap ? cost_table_weighted_warp_kernel<true>
                     : cost_table_weighted_warp_kernel<false>,
                g.blocks, g.threads, g.smem, stream, mask, sxy, dist, weight,
                costs, reps, P, n, m, leg, overhead, rows_aligned(mask, NN),
                div_magic(n));
}

}  // extern "C"
