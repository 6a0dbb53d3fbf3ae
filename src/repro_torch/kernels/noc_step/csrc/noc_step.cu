// Segmented minimum of int32 age keys: one arbitration round of the NoC, and
// the round's winner test.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/noc_step/noc_step.py::segmented_min (_kernel) and the
// winner test of src/repro/kernels/noc_step/ops.py::arbitrate. Given N
// candidates, each an age key and the resource (segment) it contends for,
//
//   out[r] = min(NOC_INF, min{keys[i] : segs[i] == r})     for r in [0, L)
//
// Candidates whose segment lies outside [0, L) (the stepper's padding, which
// carries NOC_INF keys by contract) are skipped, as the Pallas kernel skips
// them (no resource row matches them); no write leaves `out`. With an
// admissibility mask `adm` the keys are first masked (mkey = adm ? key :
// NOC_INF) and the winner mask follows, as arbitrate computes it:
//
//   win[i] = adm[i] && mkey[i] < NOC_INF
//            && mkey[i] == out[clip(segs[i], 0, L-1)]
//
// (an out-of-range candidate compares with the clipped resource's minimum).
// Keys are signed; keys at or above NOC_INF never take part, which caps every
// minimum at NOC_INF as both references do. A minimum does not depend on the
// order of the atomics, so every route gives the same bits on every run.
//
// Bound: bytes. Keys and segments are read once (8 N bytes; N more for adm
// and N for win) and `out` written once (4 L bytes); the integer work per
// candidate is a handful of operations, far below the card's int32 rate. What
// keeps a simple pass from that bound is not the stream but the scattered
// read-modify-writes of `out`: one 32-byte L2 sector per live candidate, and
// on a hot spot the few sectors of the hot resources, serialised in their L2
// slices. The grid route folds candidates on chip before they touch `out`.
//
// Two routes (segmin_grid_launch, segmented_min_launch):
//
// * grid (the default; one cooperative launch): as many blocks of 512
//   threads as the card holds at once fill `out` with NOC_INF (2^30 is not a
//   repeated byte, so cudaMemset cannot) and meet at a grid barrier. Each
//   then takes a contiguous chunk of candidates, one group of 4 per thread
//   at a time: 16-byte loads of keys and segments where both share their
//   16-byte phase (4-byte loads on a misaligned or ragged end), equal
//   segments within a group folded. A first pass over the chunk's
//   segments finds the span of its resources. Neighbouring candidates of
//   the NoC's id space contend for the resources of one instance, so that
//   span is short: when it holds at most G_SPAN resources their minima
//   gather in shared memory, indexed from the lowest (a key not below the
//   slot's minimum skips the atomic), and leave in one pass of
//   fire-and-forget atomicMin on consecutive resources, neighbouring lanes
//   on neighbouring addresses. Otherwise each candidate goes to `out` (an L2
//   read, __ldcg, and an atomicMin when its key is below) unless a cache in
//   shared memory of the block's last update of its resource (G_CACHE slots
//   by resource modulo G_CACHE, each the resource and a key known not below
//   out[resource]) holds a key no greater: a hot spot's few resources stay
//   in the cache, so most of their candidates stop there. `out` only
//   decreases, so a value read earlier is never below the current one and
//   both skips are safe. With `adm` the blocks meet at a second grid barrier
//   and write the winner bytes, reading `out` at the clipped segment. Every
//   shape goes this way: one launch, in place of the atomic route's two.
// * atomic (the first pair, kept as the comparison): the fill, then one thread
//   per candidate, an __ldcg skip and an atomicMin, no folding.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NOC_INF = 1 << 30;
constexpr int THREADS = 256;       // the atomic route
constexpr int MAX_BLOCKS = 132 * 16;
constexpr int G_THREADS = 512;     // grid route
constexpr int G_SPAN = 16384;      // resources a block gathers in shared memory
constexpr int G_CACHE = 8192;      // or its cache slots (a power of two)
constexpr int G_SMEM = G_SPAN * (int)sizeof(int);  // both 64 KB
static_assert(G_CACHE * sizeof(unsigned long long) == G_SMEM, "one buffer");

// ---- the atomic route ------------------------------------------------------
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

// ---- candidates in groups of 4 ---------------------------------------------
// Group g holds the candidates c = 4 g - s + j, j < 4, where s is the 4-byte
// phase of `keys` within its 16-byte line (0 when keys and segs differ in
// phase, and then every load is 4 bytes wide). Inside [0, N) a full group is
// one int4 of each array; elsewhere the lanes outside [0, N) read as dead.
struct Stream {
  const int* keys;
  const int* segs;
  const unsigned char* adm;  // nullptr: no mask (segmin)
  int64_t N;
  int L;
  int s;          // 4-byte phase of the groups
  int vec;        // keys and segs 16-byte loads
  int bvec;       // adm and win 4-byte loads and stores
};

__device__ __forceinline__ int64_t group_count(const Stream& a) {
  return (a.N + a.s + 3) / 4;
}

__device__ __forceinline__ void load_group(const Stream& a, int64_t g,
                                           int key[4], int seg[4]) {
  const int64_t c0 = 4 * g - a.s;
  if (a.vec && c0 >= 0 && c0 + 4 <= a.N) {
    const int4 k = *reinterpret_cast<const int4*>(a.keys + c0);
    const int4 q = *reinterpret_cast<const int4*>(a.segs + c0);
    key[0] = k.x; key[1] = k.y; key[2] = k.z; key[3] = k.w;
    seg[0] = q.x; seg[1] = q.y; seg[2] = q.z; seg[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t c = c0 + j;
    const bool in = c >= 0 && c < a.N;
    key[j] = in ? a.keys[c] : NOC_INF;
    seg[j] = in ? a.segs[c] : -1;
  }
}

// adm of group g as 4 flags (0 outside [0, N)).
__device__ __forceinline__ void load_adm(const Stream& a, int64_t g,
                                         bool adm[4]) {
  const int64_t c0 = 4 * g - a.s;
  if (a.bvec && c0 >= 0 && c0 + 4 <= a.N) {
    const unsigned w = *reinterpret_cast<const unsigned*>(a.adm + c0);
#pragma unroll
    for (int j = 0; j < 4; ++j) adm[j] = ((w >> (8 * j)) & 0xffu) != 0;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t c = c0 + j;
    adm[j] = c >= 0 && c < a.N && a.adm[c] != 0;
  }
}

__device__ __forceinline__ void store_win(const Stream& a, unsigned char* win,
                                          int64_t g, const bool w[4]) {
  const int64_t c0 = 4 * g - a.s;
  if (a.bvec && c0 >= 0 && c0 + 4 <= a.N) {
    *reinterpret_cast<unsigned*>(win + c0) =
        (unsigned)w[0] | (unsigned)w[1] << 8 | (unsigned)w[2] << 16 |
        (unsigned)w[3] << 24;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t c = c0 + j;
    if (c >= 0 && c < a.N) win[c] = w[j];
  }
}

// The live candidates of group g (mkey below NOC_INF, segment in range)
// with equal segments folded into the first; every other slot gets segment
// -1. With adm the keys are masked first.
template <bool ADM>
__device__ __forceinline__ void live_group(const Stream& a, int64_t g,
                                           int key[4], int seg[4]) {
  load_group(a, g, key, seg);
  bool adm[4] = {true, true, true, true};
  if (ADM) load_adm(a, g, adm);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!adm[j]) key[j] = NOC_INF;
    if (key[j] >= NOC_INF || seg[j] < 0 || seg[j] >= a.L) seg[j] = -1;
  }
#pragma unroll
  for (int j = 1; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < j; ++i) {
      if (seg[j] >= 0 && seg[j] == seg[i]) {
        key[i] = min(key[i], key[j]);
        seg[j] = -1;
      }
    }
  }
}

// ---- the grid route ---------------------------------------------------------
struct SpanScratch {
  int lo[32], hi[32];  // per warp, then the block's in [0]
};

// The block's [lo, hi] over the in-range segments of groups [g0, g1) (hi < lo
// when there is none), from the segments alone; every thread gets it.
__device__ __forceinline__ void block_span(const Stream& a, int64_t g0,
                                           int64_t g1, SpanScratch& sp,
                                           int& lo, int& hi) {
  lo = a.L;
  hi = -1;
  for (int64_t g = g0 + threadIdx.x; g < g1; g += blockDim.x) {
    const int64_t c0 = 4 * g - a.s;
    int seg[4];
    if (a.vec && c0 >= 0 && c0 + 4 <= a.N) {
      const int4 q = *reinterpret_cast<const int4*>(a.segs + c0);
      seg[0] = q.x; seg[1] = q.y; seg[2] = q.z; seg[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        seg[j] = c0 + j >= 0 && c0 + j < a.N ? a.segs[c0 + j] : -1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (seg[j] >= 0 && seg[j] < a.L) {
        lo = min(lo, seg[j]);
        hi = max(hi, seg[j]);
      }
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_down_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, d));
  }
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) {
    sp.lo[warp] = lo;
    sp.hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < warps; ++w) {
      sp.lo[0] = min(sp.lo[0], sp.lo[w]);
      sp.hi[0] = max(sp.hi[0], sp.hi[w]);
    }
  }
  __syncthreads();
  lo = sp.lo[0];
  hi = sp.hi[0];
}

// One block's chunk of candidates, groups [g0, g1), folded into `out`. When
// the chunk's resources span at most G_SPAN ids (the NoC's id space: a chunk
// lies within one or two instances) their minima gather in shared memory
// indexed from the lowest, and leave in one pass of atomics on consecutive
// resources. Otherwise (resources spread over the id space) each candidate
// goes to `out` unless a cache of the block's last global update of its
// resource already holds a key no greater: a hot spot's resources stay in
// the cache, so most of their candidates stop in shared memory. Every
// thread of the block calls this.
template <bool ADM>
__device__ __forceinline__ void gather_chunk(const Stream& a, int* out,
                                             int64_t g0, int64_t g1,
                                             int* s_tab, SpanScratch& sp) {
  int lo, hi;
  block_span(a, g0, g1, sp, lo, hi);
  if (hi < lo) return;  // no candidate in range
  if (hi - lo < G_SPAN) {
    int* s_val = s_tab;  // the minimum of resource lo + i
    for (int i = threadIdx.x; i <= hi - lo; i += blockDim.x) s_val[i] = NOC_INF;
    __syncthreads();
    for (int64_t g = g0 + threadIdx.x; g < g1; g += blockDim.x) {
      int key[4], seg[4];
      live_group<ADM>(a, g, key, seg);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (seg[j] < 0) continue;
        int* v = s_val + (seg[j] - lo);
        if (key[j] < *(volatile int*)v) atomicMin(v, key[j]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i <= hi - lo; i += blockDim.x) {
      const int v = s_val[i];
      if (v < NOC_INF) atomicMin(out + lo + i, v);
    }
    return;
  }
  // cache slot: resource << 32 | the key last known not below out[resource]
  unsigned long long* s_cache = reinterpret_cast<unsigned long long*>(s_tab);
  for (int i = threadIdx.x; i < G_CACHE; i += blockDim.x) s_cache[i] = ~0ull;
  __syncthreads();
  for (int64_t g = g0 + threadIdx.x; g < g1; g += blockDim.x) {
    int key[4], seg[4];
    live_group<ADM>(a, g, key, seg);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = seg[j];
      if (r < 0) continue;
      volatile unsigned long long* slot = s_cache + (r & (G_CACHE - 1));
      const unsigned long long w = *slot;
      if ((int)(w >> 32) == r && key[j] >= (int)(unsigned)w) continue;
      const int cur = __ldcg(out + r);
      if (key[j] < cur) atomicMin(out + r, key[j]);
      *slot = (unsigned long long)(unsigned)r << 32 |
              (unsigned)min(key[j], cur);
    }
  }
}

// One cooperative launch, every block resident: fill `out`, meet at a grid
// barrier, gather the block's chunk of `chunk` groups; with `adm` meet again
// and write the winner bytes, reading the minima through L2.
template <bool ADM>
__global__ void __launch_bounds__(G_THREADS)
segmin_grid_kernel(const Stream a, int* __restrict__ out,
                   unsigned char* __restrict__ win, int64_t chunk) {
  extern __shared__ __align__(16) int s_tab[];
  __shared__ SpanScratch sp;
  cg::grid_group grid = cg::this_grid();
  const int64_t first = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = first; r < a.L; r += stride) out[r] = NOC_INF;
  grid.sync();  // every resource holds NOC_INF
  const int64_t groups = group_count(a);
  const int64_t g0 = blockIdx.x * chunk;
  gather_chunk<ADM>(a, out, g0, min(groups, g0 + chunk), s_tab, sp);
  if (!ADM) return;
  grid.sync();  // every minimum is final
  for (int64_t g = first; g < groups; g += stride) {
    int key[4], seg[4];
    bool adm[4], w[4];
    load_group(a, g, key, seg);
    load_adm(a, g, adm);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = min(max(seg[j], 0), a.L - 1);
      w[j] = adm[j] && key[j] < NOC_INF && key[j] == __ldcg(out + r);
    }
    store_win(a, win, g, w);
  }
}

int blocks_for(int64_t n) {
  int64_t b = (n + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <class K, class... A>
cudaError_t launch(K kernel, int64_t blocks, int threads, size_t smem,
                   cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

constexpr int MAX_DEVICES = 64;  // devices whose kernel set-up is cached

int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : 0;
}

int device_attr(cudaDeviceAttr attr) {
  int v = 0;
  return cudaDeviceGetAttribute(&v, attr, current_device()) == cudaSuccess ? v
                                                                          : 0;
}

// Opt a kernel in to `bytes` of dynamic shared memory, once per device.
template <class K>
cudaError_t opt_in(K kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  const int dev = current_device();
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

// The grid route's one cooperative launch: as many blocks as the card holds
// at once, fewer when the candidates and resources need fewer (a block
// takes up to G_THREADS groups and fills up to 16 G_THREADS resources
// before it shares the work).
template <bool ADM>
cudaError_t grid_launch(const Stream& a, int* out, unsigned char* win,
                        cudaStream_t stream) {
  static bool opted[MAX_DEVICES];
  static int resident_on[MAX_DEVICES];
  cudaError_t e = opt_in(segmin_grid_kernel<ADM>, G_SMEM, opted);
  if (e != cudaSuccess) return e;
  const int dev = current_device();
  int resident = dev < MAX_DEVICES ? resident_on[dev] : 0;
  if (resident == 0) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segmin_grid_kernel<ADM>, G_THREADS, G_SMEM);
    if (e != cudaSuccess) return e;
    resident = per_sm * device_attr(cudaDevAttrMultiProcessorCount);
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) resident_on[dev] = resident;
  }
  const int64_t groups = (a.N + a.s + 3) / 4;
  const int64_t for_groups = (groups + G_THREADS - 1) / G_THREADS;
  const int64_t for_fill =
      ((int64_t)a.L + 16 * G_THREADS - 1) / (16 * G_THREADS);
  int64_t blocks = for_groups > for_fill ? for_groups : for_fill;
  if (blocks > resident) blocks = resident;
  const int64_t chunk = (groups + blocks - 1) / blocks;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(G_THREADS);
  cfg.dynamicSmemBytes = G_SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, segmin_grid_kernel<ADM>, a, out, win, chunk);
}

}  // namespace

// out[L] <- the segmented minimum of (keys[N], segs[N]) by the atomic route
// (its fill and pass); all int32, device pointers, launched on `stream`.
// Returns the first CUDA error (0 on success).
extern "C" int segmented_min_launch(const int* keys, const int* segs,
                                    int* out, long long N, int L,
                                    cudaStream_t stream) {
  if (L <= 0) return 0;
  cudaError_t err = launch(segmin_fill_kernel, blocks_for(L), THREADS, 0,
                           stream, out, L);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || N <= 0) return (int)err;
  err = launch(segmin_kernel, blocks_for(N), THREADS, 0, stream, keys, segs,
               out, (int64_t)N, L);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// One round by the grid route on `stream`; device pointers. Without `adm`
// (nullptr): out[L] <- the segmented minimum of keys[N] by segs[N]. With
// `adm` (N bytes, 0 or 1): the keys masked by adm, out[L] <- their minima
// and win[N] <- the winner bytes. `out` is required in both. Returns the
// first CUDA error (0 on success).
extern "C" int segmin_grid_launch(const int* keys, const int* segs,
                                  const unsigned char* adm, int* out,
                                  unsigned char* win, long long N, int L,
                                  cudaStream_t stream) {
  if (out == nullptr || (adm != nullptr && win == nullptr))
    return (int)cudaErrorInvalidValue;
  if (L <= 0) return 0;
  Stream a;
  a.keys = keys;
  a.segs = segs;
  a.adm = adm;
  a.N = N;
  a.L = L;
  const int sk = (int)((uintptr_t)keys / 4 % 4);
  a.vec = sk == (int)((uintptr_t)segs / 4 % 4) && (uintptr_t)keys % 4 == 0 &&
          (uintptr_t)segs % 4 == 0;
  a.s = a.vec ? sk : 0;
  a.bvec = adm != nullptr && ((uintptr_t)adm - a.s) % 4 == 0 &&
           ((uintptr_t)win - a.s) % 4 == 0;
  const cudaError_t err = adm ? grid_launch<true>(a, out, win, stream)
                              : grid_launch<false>(a, out, nullptr, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
