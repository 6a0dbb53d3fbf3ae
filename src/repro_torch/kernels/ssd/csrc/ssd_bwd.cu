// Mamba-2 SSD intra-chunk pass, backward: two hand kernels behind one C
// entry point, for x, B, C in bf16 or f32, all arithmetic in f32 on the
// CUDA cores.
//
// Replaces no Pallas kernel: the reference's Pallas intra-chunk kernel
// (src/repro/kernels/ssd/ssd.py::ssd_intra_chunk, its pallas_call at :80)
// has no backward, and the reference trains by differentiating its jnp
// ssd_scan (src/repro/models/ssm.py:25). This is the backward of the
// port's forward (ssd.cu), in the closed form of ref.py's
// ssd_intra_chunk_bwd_ref. Per chunk of L steps, with j <= i,
//
//   E_ij = exp(max(cum_i - cum_j, -30)), CB_ij = C_i . B_j,
//   M_ij = E_ij CB_ij dt_j, dM_ij = dy_i . x_j, G_ij = dM_ij E_ij dt_j,
//   e_j = exp(max(cum_L - cum_j, -30)), w_j = e_j dt_j,
//   dx_j = sum_i M_ij dy_i + w_j (B_j dsc)
//   dC_i = sum_j G_ij B_j
//   dB_j = sum_i G_ij C_i + w_j (dsc x_j)
//   ddt_j = sum_i dM_ij E_ij CB_ij + e_j u_j,     u_j = B_j . (dsc x_j)
//   dcum_i += sum_j q_ij, dcum_j -= sum_i q_ij,   q_ij = dM_ij M_ij where
//             cum_i - cum_j >= -30 (max's gradient is 0 under the clamp)
//   dcum_j -= u_j w_j, dcum_L += sum_j u_j w_j + ddec dec (unclamped)
//   ddt += A dla, dA = sum dt dla,  dla = reverse cumsum of dcum
//
// The masked triangle (j > i) is never exponentiated: the reference's
// gradient goes 0 * inf = NaN there once a chunk's decay spans ~88.7; this
// one stays finite.
//
// What bounds it: at hymba's training shape (B = 2, S = 4,096, 50 heads,
// N = 16, P = 64, L = 256) the causal pairs' work is ~18.5 GFLOP
// (~0.28 ms on the f32 CUDA cores at 67 TFLOP/s) against ~330 MB of
// traffic (~0.10 ms at 3.35 TB/s): operations bound it; mamba2 (64 heads,
// N = 128) ~69 GFLOP.
//
// Design (simple first; tensor cores, TMA and wgmma are later work):
// - ssd_bwd_tile_kernel, one block per (64-step tile, chunk, head, batch)
//   and role. Row sums (dC, dcum_i) and column sums (dx, dB, ddt, dcum_j)
//   both span the chunk, and an L x L tile of f32 does not fit beside the
//   operands, so two roles each recompute C B^T, dy x^T and the decay, as
//   the flash backward's dK/dV and dQ passes do: a column block holds one
//   64-step tile j of B and x and walks the tiles i >= j, a row block holds
//   one tile i of C and dy and walks the tiles j <= i. Operands stream
//   through shared memory in 64-row tiles, transposed (rows of 65 floats:
//   no bank conflicts), so shared memory stays ~147 KB at N = 128.
//   Each thread of 16 x 16 owns a 4 x 4 micro-tile (rows ty + 16 r,
//   columns tx + 16 q) of each product.
// - ssd_bwd_dt_kernel, one block per (chunk, head, batch): the pieces of
//   dcum the tile blocks wrote, a reverse scan (shuffles, then the warps'
//   sums), ddt and the chunk's dA partial.
// Deterministic: no atomics, every sum in a fixed order, so two runs give
// the same bits. dB and dC are written per head and dA per (batch, chunk,
// head); the wrapper sums them (ssd.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int T = 64;         // steps of a tile (rows i or columns j)
constexpr int TS = T + 1;     // row stride of a transposed operand tile
constexpr int MS = T + 16;    // row stride of the M and G tiles
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx columns
constexpr int WARPS = THREADS / 32;
constexpr int MAX_L = 256;    // the dt kernel: one thread a step
constexpr float MIN_LOG = -30.f;

struct Strides {
  long long b, s, h;  // in elements; the last dim is contiguous
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int N, int P>
struct Geo {
  static_assert(N % 16 == 0 && P % 16 == 0, "N and P in multiples of 16");
  static_assert(N * (P + 1) <= 2 * T * MS, "dsc fits the M and G tiles");
  static size_t floats(int L) {
    return 2 * (size_t)N * TS + 2 * (size_t)P * TS + 2 * (size_t)T * MS +
           2 * (size_t)L + 2 * (size_t)WARPS * T + T;
  }
};

// Rows row0 .. row0 + T - 1 of a (step, K) operand into dst[K][TS] as f32;
// rows past the chunk, and steps at or past ``limit``, read as zeros.
template <typename Ts>
__device__ __forceinline__ void load_tile(float* dst, const Ts* src,
                                          long long stride, int K, int row0,
                                          int L, long long t0,
                                          long long limit) {
  for (int e = threadIdx.x; e < T * K; e += THREADS) {
    const int r = e / K, k = e % K, row = row0 + r;
    const bool in = row < L && t0 + row < limit;
    dst[k * TS + r] = in ? to_f32(src[(t0 + row) * stride + k]) : 0.f;
  }
}

// The tile pair (i0, j0) for the thread's entries (rows i0 + ty + 16 r,
// columns j0 + tx + 16 q): C B^T and dy x^T from the transposed tiles,
// then E (0 off the causal triangle and past the chunk), M and G. G goes
// to Gs; a column block (COLS) also writes M to Ms and sums q and
// r = dM E CB over its rows (colq, colr), a row block sums q over its
// columns (rowq).
template <int N, int P, bool COLS>
__device__ __forceinline__ void tile_pair(
    const float* Ct, const float* Bt, const float* Yt, const float* Xt,
    const float* cum, const float* dts, int i0, int j0, int L, float* Ms,
    float* Gs, float (&colq)[4], float (&colr)[4], float (&rowq)[4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float cb[4][4], dm[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) cb[r][q] = dm[r][q] = 0.f;
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    float a[4], v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = Ct[n * TS + ty + 16 * r];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = Bt[n * TS + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) cb[r][q] = fmaf(a[r], v[q], cb[r][q]);
  }
#pragma unroll 8
  for (int p = 0; p < P; ++p) {
    float a[4], v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = Yt[p * TS + ty + 16 * r];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = Xt[p * TS + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) dm[r][q] = fmaf(a[r], v[q], dm[r][q]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      float E = 0.f, dtj = 0.f;
      bool unclamped = false;
      if (i < L && j <= i) {
        const float d = cum[i] - cum[j];
        E = expf(fmaxf(d, MIN_LOG));
        unclamped = d >= MIN_LOG;
        dtj = dts[j];
      }
      const float m = __fmul_rn(__fmul_rn(E, cb[r][q]), dtj);
      const float dmE = __fmul_rn(dm[r][q], E);
      Gs[(ty + 16 * r) * MS + tx + 16 * q] = __fmul_rn(dmE, dtj);
      const float qv = unclamped ? __fmul_rn(dm[r][q], m) : 0.f;
      if (COLS) {
        Ms[(ty + 16 * r) * MS + tx + 16 * q] = m;
        colq[q] += qv;
        colr[q] = fmaf(dmE, cb[r][q], colr[q]);
      } else {
        rowq[r] += qv;
      }
    }
  }
}

template <typename Tin, int N, int P>
__global__ void __launch_bounds__(THREADS) ssd_bwd_tile_kernel(
    const Tin* __restrict__ x, const float* __restrict__ dt,
    const Tin* __restrict__ Bm, const Tin* __restrict__ Cm,
    const float* __restrict__ cum_in, const float* __restrict__ dy,
    const float* __restrict__ dsc, float* __restrict__ dx,
    float* __restrict__ dBh, float* __restrict__ dCh,
    float* __restrict__ scratch, Strides xs, Strides ds, Strides bs,
    Strides cs, int B, int S, int H, int G, int L, int nc) {
  constexpr int NR = N / 16, PR = P / 16;
  extern __shared__ float smem[];
  float* Ct = smem;                  // [N][TS] C of the i tile, transposed
  float* Bt = Ct + N * TS;           // [N][TS] B of the j tile
  float* Yt = Bt + N * TS;           // [P][TS] dy of the i tile
  float* Xt = Yt + P * TS;           // [P][TS] x of the j tile
  float* Ms = Xt + P * TS;           // [T][MS] M of the tile pair
  float* Gs = Ms + T * MS;           // [T][MS] G of the tile pair
  float* cum = Gs + T * MS;          // [L]
  float* dts = cum + L;              // [L]
  float* redq = dts + L;             // [WARPS][T] warps' column sums of q
  float* redr = redq + WARPS * T;    // [WARPS][T] ... of dM E CB
  float* us = redr + WARPS * T;      // [T] u_j of the column tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int nt = (L + T - 1) / T;
  const int c = blockIdx.x / (2 * nt), role = blockIdx.x % (2 * nt);
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const long long t0 = (long long)c * L;  // first step of the chunk
  const long long padded = (long long)nc * L;
  const Tin* xb = x + b * xs.b + h * xs.h;
  const Tin* bb = Bm + b * bs.b + g * bs.h;
  const Tin* cb = Cm + b * cs.b + g * cs.h;
  const float* db = dt + b * ds.b + h * ds.h;
  const float* yb = dy + ((long long)b * padded * H + h) * P;  // + t H P
  const long long plane = (long long)B * H * nc * L;
  float* scr = scratch + (((long long)b * H + h) * nc + c) * L;

  for (int t = tid; t < L; t += THREADS) {
    cum[t] = cum_in[(((long long)b * nc + c) * L + t) * H + h];
    dts[t] = t0 + t < S ? db[(t0 + t) * ds.s] : 0.f;
  }
  float colq[4] = {0.f, 0.f, 0.f, 0.f}, colr[4] = {0.f, 0.f, 0.f, 0.f};
  float rowq[4] = {0.f, 0.f, 0.f, 0.f};

  if (role < nt) {
    // ---- a column block: tile j of B and x; the tiles i >= j ----------
    const int j0 = role * T;
    load_tile(Bt, bb, bs.s, N, j0, L, t0, S);
    load_tile(Xt, xb, xs.s, P, j0, L, t0, S);
    float* dss = Ms;  // [N][P + 1] dsc, before the first tile pair
    const float* dscb = dsc + (((long long)b * nc + c) * H + h) * N * P;
    for (int e = tid; e < N * P; e += THREADS)
      dss[(e / P) * (P + 1) + e % P] = dscb[e];
    __syncthreads();
    const float cum_last = cum[L - 1];
    // the state's terms: B_j dsc (dx), dsc x_j (dB) and u_j
    float ax[4][PR], ab[4][NR];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < PR; ++q) ax[r][q] = 0.f;
#pragma unroll
      for (int q = 0; q < NR; ++q) ab[r][q] = 0.f;
    }
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float bv = Bt[n * TS + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < PR; ++q)
          ax[r][q] = fmaf(bv, dss[n * (P + 1) + tx + 16 * q], ax[r][q]);
      }
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float xv = Xt[p * TS + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < NR; ++q)
          ab[r][q] = fmaf(xv, dss[(tx + 16 * q) * (P + 1) + p], ab[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty + 16 * r;
      float u = 0.f;
#pragma unroll
      for (int q = 0; q < NR; ++q)
        u = fmaf(Bt[(tx + 16 * q) * TS + ty + 16 * r], ab[r][q], u);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        u += __shfl_xor_sync(0xffffffffu, u, off);
      if (tx == 0) us[ty + 16 * r] = u;
      const float w =
          j < L ? __fmul_rn(expf(fmaxf(cum_last - cum[j], MIN_LOG)), dts[j])
                : 0.f;
#pragma unroll
      for (int q = 0; q < PR; ++q) ax[r][q] = __fmul_rn(w, ax[r][q]);
#pragma unroll
      for (int q = 0; q < NR; ++q) ab[r][q] = __fmul_rn(w, ab[r][q]);
    }
    __syncthreads();  // us written; dsc read (Ms and Gs free again)
    float own_q = 0.f, own_r = 0.f;  // column j0 + tid's sums (tid < T)
    if (tid < T && j0 + tid < L)
      own_r = __fmul_rn(expf(fmaxf(cum_last - cum[j0 + tid], MIN_LOG)),
                        us[tid]);

    for (int it = role; it < nt; ++it) {
      const int i0 = it * T;
      __syncthreads();  // the last pair's readers of Ct, Yt, Ms, Gs done
      load_tile(Ct, cb, cs.s, N, i0, L, t0, S);
      load_tile(Yt, yb, (long long)H * P, P, i0, L, t0, padded);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 4; ++q) colq[q] = colr[q] = 0.f;
      tile_pair<N, P, true>(Ct, Bt, Yt, Xt, cum, dts, i0, j0, L, Ms, Gs,
                            colq, colr, rowq);
      // the column sums: the thread's 4 rows, the warp's two rows of
      // threads, then the 8 warps in order
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float sq = colq[q] + __shfl_xor_sync(0xffffffffu, colq[q], 16);
        const float sr = colr[q] + __shfl_xor_sync(0xffffffffu, colr[q], 16);
        if (lane < 16) {
          redq[warp * T + tx + 16 * q] = sq;
          redr[warp * T + tx + 16 * q] = sr;
        }
      }
      __syncthreads();
      if (tid < T) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          own_q += redq[w * T + tid];
          own_r += redr[w * T + tid];
        }
      }
      // dx_j += sum_i M_ij dy_i, dB_j += sum_i G_ij C_i
#pragma unroll 4
      for (int i = 0; i < T; ++i) {
        float mv[4], gv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          mv[r] = Ms[i * MS + ty + 16 * r];
          gv[r] = Gs[i * MS + ty + 16 * r];
        }
#pragma unroll
        for (int q = 0; q < PR; ++q) {
          const float yv = Yt[(tx + 16 * q) * TS + i];
#pragma unroll
          for (int r = 0; r < 4; ++r) ax[r][q] = fmaf(mv[r], yv, ax[r][q]);
        }
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          const float cv = Ct[(tx + 16 * q) * TS + i];
#pragma unroll
          for (int r = 0; r < 4; ++r) ab[r][q] = fmaf(gv[r], cv, ab[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty + 16 * r;
      const long long t = t0 + j;
      if (j >= L || t >= S) continue;
      float* dxr = dx + (((long long)b * S + t) * H + h) * P;
      float* dbr = dBh + (((long long)b * S + t) * H + h) * N;
#pragma unroll
      for (int q = 0; q < PR; ++q) dxr[tx + 16 * q] = ax[r][q];
#pragma unroll
      for (int q = 0; q < NR; ++q) dbr[tx + 16 * q] = ab[r][q];
    }
    if (tid < T && j0 + tid < L) {
      const int j = j0 + tid;
      const float delta = cum_last - cum[j];
      const float w = __fmul_rn(expf(fmaxf(delta, MIN_LOG)), dts[j]);
      const float uw = delta >= MIN_LOG ? __fmul_rn(us[tid], w) : 0.f;
      scr[j] = own_r;                       // ddt's direct part
      scr[plane + j] = -own_q - uw;         // dcum_j's column part
      scr[2 * plane + j] = uw;              // into dcum_L
    }
  } else {
    // ---- a row block: tile i of C and dy; the tiles j <= i -------------
    const int it = role - nt, i0 = it * T;
    load_tile(Ct, cb, cs.s, N, i0, L, t0, S);
    load_tile(Yt, yb, (long long)H * P, P, i0, L, t0, padded);
    float ac[4][NR];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < NR; ++q) ac[r][q] = 0.f;
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * T;
      __syncthreads();  // the last pair's readers of Bt, Xt, Gs done
      load_tile(Bt, bb, bs.s, N, j0, L, t0, S);
      load_tile(Xt, xb, xs.s, P, j0, L, t0, S);
      __syncthreads();
      tile_pair<N, P, false>(Ct, Bt, Yt, Xt, cum, dts, i0, j0, L, Ms, Gs,
                             colq, colr, rowq);
      __syncthreads();
      // dC_i += sum_j G_ij B_j
#pragma unroll 4
      for (int j = 0; j < T; ++j) {
        float gv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = Gs[(ty + 16 * r) * MS + j];
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          const float bv = Bt[(tx + 16 * q) * TS + j];
#pragma unroll
          for (int r = 0; r < 4; ++r) ac[r][q] = fmaf(gv[r], bv, ac[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float s = rowq[r];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int i = i0 + ty + 16 * r;
      if (i >= L) continue;
      if (tx == 0) scr[3 * plane + i] = s;  // dcum_i's row part
      const long long t = t0 + i;
      if (t >= S) continue;
      float* dcr = dCh + (((long long)b * S + t) * H + h) * N;
#pragma unroll
      for (int q = 0; q < NR; ++q) dcr[tx + 16 * q] = ac[r][q];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Grid (nc, H, B): dcum_t = dcum + its row and column parts (+ the state's
// and dec's terms at the last step), dla its reverse cumulative sum,
// ddt = direct + A dla, and the chunk's dA partial sum dt dla.
__global__ void __launch_bounds__(THREADS) ssd_bwd_dt_kernel(
    const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ cum_in, const float* __restrict__ ddec,
    const float* __restrict__ dcum, const float* __restrict__ scratch,
    float* __restrict__ ddt, float* __restrict__ dA_part, Strides ds, int B,
    int S, int H, int L, int nc) {
  __shared__ float uw_sums[WARPS], scan_sums[WARPS], da_sums[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long t0 = (long long)c * L;
  const long long plane = (long long)B * H * nc * L;
  const float* scr = scratch + (((long long)b * H + h) * nc + c) * L;
  const long long chunk = ((long long)b * nc + c) * L;
  const bool in = tid < L;
  float direct = 0.f, d = 0.f, uw = 0.f, dtv = 0.f;
  if (in) {
    direct = scr[tid];
    d = dcum[(chunk + tid) * H + h] + scr[3 * plane + tid] + scr[plane + tid];
    uw = scr[2 * plane + tid];
    if (t0 + tid < S) dtv = dt[b * ds.b + (t0 + tid) * ds.s + h * ds.h];
  }
  const float ws = warp_sum(uw);
  if (lane == 0) uw_sums[warp] = ws;
  __syncthreads();
  if (tid == L - 1) {
    float total = 0.f;
    for (int w = 0; w < WARPS; ++w) total += uw_sums[w];
    const float cum_last = cum_in[(chunk + L - 1) * H + h];
    const float dec = expf(fmaxf(cum_last, MIN_LOG));
    d += total;
    if (cum_last >= MIN_LOG)
      d += __fmul_rn(ddec[((long long)b * nc + c) * H + h], dec);
  }
  // inclusive suffix scan: in each warp, then the later warps' sums
  float v = d;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += n;
  }
  if (lane == 0) scan_sums[warp] = v;
  __syncthreads();
  float later = 0.f;
  for (int w = WARPS - 1; w > warp; --w) later += scan_sums[w];
  const float dla = v + later;
  if (in && t0 + tid < S)
    ddt[((long long)b * S + t0 + tid) * H + h] = fmaf(A[h], dla, direct);
  const float pa = warp_sum(in ? __fmul_rn(dtv, dla) : 0.f);
  if (lane == 0) da_sums[warp] = pa;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += da_sums[w];
    dA_part[((long long)b * nc + c) * H + h] = s;
  }
}

template <typename Tin, int N, int P>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* cum, const float* dy,
           const float* dsc, const float* ddec, const float* dcum, float* dx,
           float* ddt, float* dA_part, float* dBh, float* dCh,
           float* scratch, Strides xs, Strides ds, Strides bs, Strides cs,
           int B, int S, int H, int G, int L, int nc, cudaStream_t stream) {
  const size_t bytes = Geo<N, P>::floats(L) * sizeof(float);
  auto kernel = ssd_bwd_tile_kernel<Tin, N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int nt = (L + T - 1) / T;
  kernel<<<dim3(nc * 2 * nt, H, B), THREADS, bytes, stream>>>(
      static_cast<const Tin*>(x), dt, static_cast<const Tin*>(Bm),
      static_cast<const Tin*>(Cm), cum, dy, dsc, dx, dBh, dCh, scratch, xs,
      ds, bs, cs, B, S, H, G, L, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_dt_kernel<<<dim3(nc, H, B), THREADS, 0, stream>>>(
      dt, A, cum, ddec, dcum, scratch, ddt, dA_part, ds, B, S, H, L, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one tile block at (N, P, L), in bytes (0 where the
// backward has no instance: (N, P) outside (16, 32), (32, 32), (16, 64),
// (128, 64), or L outside 1..256).
size_t ssd_intra_chunk_bwd_smem_bytes(int N, int P, int L) {
  if (L < 1 || L > MAX_L) return 0;
  if (N == 16 && P == 32) return Geo<16, 32>::floats(L) * sizeof(float);
  if (N == 32 && P == 32) return Geo<32, 32>::floats(L) * sizeof(float);
  if (N == 16 && P == 64) return Geo<16, 64>::floats(L) * sizeof(float);
  if (N == 128 && P == 64) return Geo<128, 64>::floats(L) * sizeof(float);
  return 0;
}

// Launch the tile kernel, then the dt kernel, on ``stream``; returns the
// first cudaError_t (0 on success). ``bf16`` selects __nv_bfloat16 x, Bm
// and Cm, else float; dt, A, cum and the cotangents are float: cum and
// dcum (B, nc, L, H), dy (B, nc L, H, P), dsc (B, nc, H, N, P), ddec
// (B, nc, H), contiguous. Outputs (f32, contiguous): dx (B, S, H, P), ddt
// (B, S, H), dA_part (B, nc, H), dBh and dCh (B, S, H, N) per head;
// scratch holds 4 B H nc L floats. x, dt, Bm, Cm are read through their
// strides (elements).
int ssd_intra_chunk_bwd_launch(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* cum, const float* dy, const float* dsc,
    const float* ddec, const float* dcum, float* dx, float* ddt,
    float* dA_part, float* dBh, float* dCh, float* scratch, int bf16, int B,
    int S, int H, int G, int N, int P, int L, int nc, long long xsb,
    long long xss, long long xsh, long long dsb, long long dss,
    long long dsh, long long bsb, long long bss, long long bsg,
    long long csb, long long css, long long csg, cudaStream_t stream) {
  const Strides xs{xsb, xss, xsh}, ds{dsb, dss, dsh}, bs{bsb, bss, bsg},
      cs{csb, css, csg};
  if (L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  auto go = [&](auto launch) {
    return launch(x, dt, A, Bm, Cm, cum, dy, dsc, ddec, dcum, dx, ddt,
                  dA_part, dBh, dCh, scratch, xs, ds, bs, cs, B, S, H, G, L,
                  nc, stream);
  };
  if (bf16) {
    if (N == 16 && P == 32) return go(launch<__nv_bfloat16, 16, 32>);
    if (N == 32 && P == 32) return go(launch<__nv_bfloat16, 32, 32>);
    if (N == 16 && P == 64) return go(launch<__nv_bfloat16, 16, 64>);
    if (N == 128 && P == 64) return go(launch<__nv_bfloat16, 128, 64>);
  } else {
    if (N == 16 && P == 32) return go(launch<float, 16, 32>);
    if (N == 32 && P == 32) return go(launch<float, 32, 32>);
    if (N == 16 && P == 64) return go(launch<float, 16, 64>);
    if (N == 128 && P == 64) return go(launch<float, 128, 64>);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
