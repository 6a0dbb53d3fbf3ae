// Fused wormhole-cycle kernel for Hopper (sm_90a): T cycles in one launch.
//
// Replaces the TPU kernel repro/kernels/noc_cycle/noc_cycle.py::
// make_chunk_runner (a Pallas program with no grid that runs
// ref.cycle_core in a fori_loop with every CycleState plane in VMEM).
// It computes what repro_torch.kernels.noc_cycle.ref.run_cycles_ref
// computes, bit for bit: integer arithmetic only, so no tolerance applies.
//
// What bounds it on this card. One simulated cycle touches every VC FIFO
// plane, every NI lane and the per-link arbitration scratch a few times, but
// the cycles are strictly sequential and each cycle is eight dependent
// phases. At 16x16 an instance's state is ~80 KB of FIFO planes plus ~150 KB
// of scratch, so the work per cycle is small and the kernel is bound by
// latency: the chain of dependent loads and the block-wide barriers between
// phases, not by HBM bytes or integer operations.
//
// What the design does about it. One thread block owns one batch instance
// (one (workload, algorithm) pair; grid = B replaces the reference's vmap)
// and runs every cycle without returning to the host, so launch overhead is
// paid once per run. The planes stay in global memory, where at 16x16 they
// sit in the 50 MB L2. The per-cycle scratch (the flattened candidate
// vector of LW + 2NN + 1 entries and the per-link winners) lives in dynamic
// shared memory whenever it fits, else in a global scratch buffer the
// wrapper allocates. Threads stride over nodes, candidates, links, FIFOs
// and children; __syncthreads() separates the phases of ref.cycle_core:
//   1. lane refill (per node)          2. candidates (per candidate)
//   3. link arbitration, delivery record, telemetry (per output link)
//   4. apply moves (per FIFO / lane)   5. ejection (per node) and child
//   release (per child)                6. counters (thread 0)
// Each phase reads only what the previous phases produced, which is the
// order the functional reference evaluates in. Ties go to the lowest port
// or VC index (jnp/torch argmin/argmax return the first extreme).
// Delivery times are written inside the kernel: the block owns its
// instance, so only the discard slot ND sees concurrent writes, and every
// write of one cycle carries the same value.
//
// Left for later work: more than one block per instance, a thread-block
// cluster or cooperative launch for 32x32 meshes, and shared-memory
// residency of the FIFO planes themselves. With B < 132 instances the
// remaining SMs idle.

#include <cuda_runtime.h>
#include <stdint.h>

#define NOC_INF (1 << 30)
#define NOC_THREADS 512

struct NocArgs {
  // state planes, leading batch axis (B, ...)
  int32_t* fowner; int16_t* fstage; int8_t* fhead; int8_t* fcount;
  int8_t* fdvc; int32_t* freq; int32_t* fkey; int8_t* fcls; uint8_t* ffin;
  int8_t* fnf; int32_t* lpid; int8_t* lsent; int32_t* lptr; int8_t* ldvc;
  int32_t* crtime; uint8_t* ctaken; int32_t* lutil; int32_t* rconf;
  int32_t* inflight; int32_t* ctr;
  // compiled traffic tables (B, ...)
  const int32_t* enqueue; const int32_t* num_stages;
  const int32_t* flits; const int32_t* link; const int32_t* vcls;
  const int32_t* lane_seq; const int32_t* chl; const int32_t* child_pid;
  const int32_t* child_parent; const int32_t* child_rs;
  const int32_t* child_enq; const int32_t* watch_link; const int32_t* dslot;
  // router geometry, shared by the batch
  const int32_t* node_ports; const int32_t* cand_port;
  // outputs and scratch
  int32_t* dtime;    // (B, ND + 1)
  int32_t* scratch;  // (B, scratch_words) when use_smem == 0
  // sizes
  int B, P, S, Q, QC, C, NN, L, V, D, F, BD, E, EPL, ND, T;
  int use_smem;
};

enum { K_GOT, K_ARB, K_MOVES, K_INJ, K_EJ, K_FIN, K_N };

__device__ __forceinline__ int clampi(int x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// int32 arithmetic that wraps like jnp/torch int32 (no signed-overflow UB)
__device__ __forceinline__ int wrap_key(int enq, int P, int pid, int F,
                                        int fid) {
  uint32_t k = ((uint32_t)enq * (uint32_t)P + (uint32_t)pid) * (uint32_t)F
               + (uint32_t)fid;
  return (int)k;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__host__ __device__ inline size_t noc_scratch_words(int L, int W, int NN) {
  size_t candp = (size_t)L * W + 2 * (size_t)NN + 1;
  return 7 * candp + 6 * (size_t)L;
}

__global__ void __launch_bounds__(NOC_THREADS, 1)
noc_cycle_kernel(const NocArgs a) {
  extern __shared__ int smem[];
  __shared__ int s_cnt[K_N];
  __shared__ int s_ctr[8];
  __shared__ int s_inflight;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int P = a.P, S = a.S, Q = a.Q, QC = a.QC, C = a.C, NN = a.NN;
  const int L = a.L, V = a.V, D = a.D, F = a.F, BD = a.BD;
  const int W = 2 * V, LW = L * W, NL = 2 * NN, CANDP = LW + NL + 1;
  const int PORTS = D * W + 2;
  const bool credit_free = BD >= F;  // a FIFO holds one whole worm

  int32_t* fowner = a.fowner + (size_t)b * LW;
  int16_t* fstage = a.fstage + (size_t)b * LW;
  int8_t* fhead = a.fhead + (size_t)b * LW;
  int8_t* fcount = a.fcount + (size_t)b * LW;
  int8_t* fdvc = a.fdvc + (size_t)b * LW;
  int32_t* freq = a.freq + (size_t)b * LW;
  int32_t* fkey = a.fkey + (size_t)b * LW;
  int8_t* fcls = a.fcls + (size_t)b * LW;
  uint8_t* ffin = a.ffin + (size_t)b * LW;
  int8_t* fnf = a.fnf + (size_t)b * LW;
  int32_t* lpid = a.lpid + (size_t)b * NL;
  int8_t* lsent = a.lsent + (size_t)b * NL;
  int32_t* lptr = a.lptr + (size_t)b * NL;
  int8_t* ldvc = a.ldvc + (size_t)b * NL;
  int32_t* crtime = a.crtime + (size_t)b * C;
  uint8_t* ctaken = a.ctaken + (size_t)b * C;
  int32_t* lutil = a.lutil + (size_t)b * a.E * L;
  int32_t* rconf = a.rconf + (size_t)b * a.E * NN;
  const int32_t* enqueue = a.enqueue + (size_t)b * P;
  const int32_t* ns_t = a.num_stages + (size_t)b * P;
  const int32_t* flits = a.flits + (size_t)b * P;
  const int32_t* link_t = a.link + (size_t)b * P * S;
  const int32_t* vcls_t = a.vcls + (size_t)b * P * S;
  const int32_t* dslot = a.dslot + (size_t)b * P * S;
  const int32_t* lane_seq = a.lane_seq + (size_t)b * NL * Q;
  const int32_t* chl = a.chl + (size_t)b * NN * QC;
  const int32_t* child_pid = a.child_pid + (size_t)b * C;
  const int32_t* child_parent = a.child_parent + (size_t)b * C;
  const int32_t* child_rs = a.child_rs + (size_t)b * C;
  const int32_t* child_enq = a.child_enq + (size_t)b * C;
  const int32_t* watch_link = a.watch_link + (size_t)b * C;
  const int32_t* node_ports = a.node_ports;
  const int32_t* cand_port = a.cand_port;
  int32_t* dtime = a.dtime + (size_t)b * (a.ND + 1);

  int* base = a.use_smem
      ? smem
      : a.scratch + (size_t)b * noc_scratch_words(L, W, NN);
  int* c_req = base;              // flattened candidates (CANDP each)
  int* c_key = c_req + CANDP;
  int* c_adm = c_key + CANDP;
  int* c_pid = c_adm + CANDP;
  int* c_to = c_pid + CANDP;
  int* c_fid = c_to + CANDP;
  int* c_tvc = c_fid + CANDP;
  int* w_aval = c_tvc + CANDP;    // per-link winners (L each)
  int* w_port = w_aval + L;
  int* w_pid = w_port + L;
  int* w_stage = w_pid + L;
  int* w_fid = w_stage + L;
  int* w_vc = w_fid + L;

  if (tid == 0) {
    s_inflight = a.inflight[b];
    for (int k = 0; k < 8; ++k) s_ctr[k] = a.ctr[(size_t)b * 8 + k];
    for (int k = 0; k < K_N; ++k) s_cnt[k] = 0;
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const int ep = min(t / a.EPL, a.E - 1);

    // ---- 1. NI lane refill (per node: its root and child lane) ----------
    for (int v = tid; v < NN; v += nt) {
      const int rl = 2 * v;
      const int ptr = lptr[rl];
      const int cand_root = lane_seq[(size_t)rl * Q + clampi(ptr, Q - 1)];
      const bool root_ok = ptr < Q && cand_root >= 0
          && enqueue[clampi(cand_root, P - 1)] <= t;
      // child lane: lowest (release cycle, row) among released children
      int best = NOC_INF, barg = 0;
      for (int k = 0; k < QC; ++k) {
        const int row = chl[(size_t)v * QC + k];
        int kv = NOC_INF;
        if (row >= 0) {
          const int rc = clampi(row, C - 1);
          const int crt = crtime[rc];
          if (crt >= 0 && crt <= t && !ctaken[rc]) kv = crt * C + rc;
        }
        if (kv < best) { best = kv; barg = k; }
      }
      const bool child_ok = best < NOC_INF;
      const int crow = chl[(size_t)v * QC + barg];
      const int cpid = child_pid[clampi(crow, C - 1)];
      for (int side = 0; side < 2; ++side) {
        const int ln = rl + side;
        const int pid = lpid[ln];
        const bool need = pid < 0 || (int)lsent[ln] >= flits[clampi(pid, P - 1)];
        const bool ok = side ? child_ok : root_ok;
        if (need && ok) {
          lpid[ln] = side ? cpid : cand_root;
          lsent[ln] = 0;
          if (side) ctaken[crow] = 1;  // crow is a row of chl[v]: v's own
          else lptr[ln] = ptr + 1;
          atomicAdd(&s_cnt[K_GOT], 1);
        } else if (need) {
          lpid[ln] = -1;
        }
      }
    }
    __syncthreads();

    // ---- 2. candidates from start-of-cycle state -------------------------
    for (int i = tid; i < CANDP; i += nt) {
      int req = -1, key = NOC_INF, adm = 0, pid = 0, to = 0, fid = 0, tvc = 0;
      if (i < LW + NL) {
        int rq, cls, dv;
        bool valid;
        if (i < LW) {
          const int own = fowner[i];
          fid = fhead[i];
          valid = own >= 0 && fcount[i] > 0;
          rq = freq[i];
          key = wrap_add(fkey[i], fid);
          cls = fcls[i];
          dv = fdvc[i];
          pid = clampi(own, P - 1);
          to = (int)fstage[i] + 1;
        } else {
          const int q = i - LW;
          const int lpv = lpid[q];
          pid = clampi(lpv, P - 1);
          fid = lsent[q];
          valid = lpv >= 0 && fid < flits[pid];
          rq = link_t[(size_t)pid * S];
          key = wrap_key(enqueue[pid], P, pid, F, fid);
          cls = vcls_t[(size_t)pid * S];
          dv = ldvc[q];
        }
        req = valid ? rq : -1;
        const int rc = clampi(req, L - 1);
        // first free VC of the requested class at the target link
        bool hdr_ok = false;
        int hvc = cls * V;
        for (int k = 0; k < V; ++k) {
          if (fowner[(size_t)rc * W + cls * V + k] < 0) {
            hdr_ok = true;
            hvc = cls * V + k;
            break;
          }
        }
        const bool hdr = fid == 0;
        const bool body_ok = credit_free || fcount[(size_t)rc * W + dv] < BD;
        adm = req >= 0 && (hdr ? hdr_ok : body_ok);
        tvc = hdr ? hvc : dv;
      }
      if (req >= 0) atomicAdd(&s_cnt[K_ARB], 1);
      c_req[i] = req; c_key[i] = key; c_adm[i] = adm; c_pid[i] = pid;
      c_to[i] = to; c_fid[i] = fid; c_tvc[i] = tvc;
    }
    __syncthreads();

    // ---- 3. link arbitration over each node's ports (per output link) ----
    for (int l = tid; l < L; l += nt) {
      const int v = l / D;
      const int32_t* np = node_ports + (size_t)v * PORTS;
      int best = NOC_INF, bp = 0, nreq = 0;
      for (int p = 0; p < PORTS; ++p) {
        const int c = np[p];
        if (c_req[c] != l) continue;
        ++nreq;
        if (c_adm[c] && c_key[c] < best) { best = c_key[c]; bp = p; }
      }
      const bool av = best < NOC_INF;
      const int wc = np[bp];
      const int apid = c_pid[wc], ast = c_to[wc], afid = c_fid[wc];
      w_aval[l] = av; w_port[l] = bp; w_pid[l] = apid; w_stage[l] = ast;
      w_fid[l] = afid; w_vc[l] = c_tvc[wc];
      if (av) {
        atomicAdd(&s_cnt[K_MOVES], 1);
        if (bp >= D * W) atomicAdd(&s_cnt[K_INJ], 1);
        lutil[(size_t)ep * L + l] += 1;
      }
      if (nreq > 1) atomicAdd(&rconf[(size_t)ep * NN + v], nreq - 1);
      // delivery record: tail arrivals at delivery stages
      const int pc = clampi(apid, P - 1);
      const bool tail = afid == flits[pc] - 1;
      const int ds = dslot[(size_t)pc * S + clampi(ast, S - 1)];
      dtime[(av && tail && ds >= 0) ? ds : a.ND] = t;
    }
    __syncthreads();

    // ---- 4. apply moves (per FIFO and lane) ------------------------------
    for (int i = tid; i < LW + NL; i += nt) {
      const int r = c_req[i];
      const int rc = clampi(r, L - 1);
      const bool won = c_adm[i] && r >= 0 && w_aval[rc]
          && w_port[rc] == cand_port[i];
      if (i < LW) {
        const int l = i / W, w = i % W;
        int fh = fhead[i], cnt = fcount[i], own = fowner[i];
        if (won && fh == 0) fdvc[i] = (int8_t)c_tvc[i];
        if (won && fh == (int)fnf[i] - 1) own = -1;  // tail departs
        fh += won;
        cnt -= won;
        const bool arr = w_aval[l] && w_vc[l] == w;
        if (arr && w_fid[l] == 0) {  // a header arrives: cache its route
          const int apid = clampi(w_pid[l], P - 1);
          const int ast = w_stage[l];
          const int a_ns = ns_t[apid];
          const int nxt = ast + 1;
          const int nxtc = clampi(nxt, S - 1);
          own = w_pid[l];
          fh = 0;
          fstage[i] = (int16_t)ast;
          freq[i] = nxt < a_ns ? link_t[(size_t)apid * S + nxtc] : -1;
          fcls[i] = (int8_t)vcls_t[(size_t)apid * S + nxtc];
          fkey[i] = wrap_key(enqueue[apid], P, apid, F, 0);
          ffin[i] = ast == a_ns - 1;
          fnf[i] = (int8_t)flits[apid];
        }
        cnt += arr;
        fowner[i] = own;
        fhead[i] = (int8_t)fh;
        fcount[i] = (int8_t)cnt;
      } else if (won) {
        const int q = i - LW;
        if (c_fid[i] == 0) ldvc[q] = (int8_t)c_tvc[i];
        lsent[q] = (int8_t)(lsent[q] + 1);
      }
    }
    __syncthreads();

    // ---- 5. ejection on post-move state (per node); child release -------
    for (int v = tid; v < NN; v += nt) {
      const int32_t* np = node_ports + (size_t)v * PORTS;
      int best = NOC_INF, bc = -1;
      for (int p = 0; p < D * W; ++p) {  // NI lanes never eject
        const int c = np[p];
        if (c >= LW) continue;  // missing link: the dummy candidate
        if (fowner[c] >= 0 && fcount[c] > 0 && ffin[c]) {
          const int k = wrap_add(fkey[c], fhead[c]);
          if (k < best) { best = k; bc = c; }
        }
      }
      if (bc >= 0) {
        const int fh = fhead[bc];
        if (fh == (int)fnf[bc] - 1) {
          fowner[bc] = -1;
          atomicAdd(&s_cnt[K_FIN], 1);
        }
        fhead[bc] = (int8_t)(fh + 1);
        fcount[bc] = (int8_t)(fcount[bc] - 1);
        atomicAdd(&s_cnt[K_EJ], 1);
      }
    }
    for (int c = tid; c < C; c += nt) {
      const int wl = clampi(watch_link[c], L - 1);
      const bool hit = w_aval[wl] && w_pid[wl] == child_parent[c]
          && w_stage[wl] == child_rs[c] && w_fid[wl] == 0;
      if (crtime[c] < 0 && hit) crtime[c] = max(t + 1, child_enq[c]);
    }
    __syncthreads();

    // ---- 6. counters ------------------------------------------------------
    if (tid == 0) {
      const int moves = s_cnt[K_MOVES], inj = s_cnt[K_INJ], ej = s_cnt[K_EJ];
      const int fin = s_cnt[K_FIN];
      s_inflight += s_cnt[K_GOT];
      s_ctr[7] = max(s_ctr[7], s_inflight);
      s_inflight -= fin;
      s_ctr[0] += moves;
      s_ctr[1] += moves;
      s_ctr[2] += moves - inj + ej;
      s_ctr[3] += moves;
      s_ctr[4] += s_cnt[K_ARB];
      s_ctr[5] += inj + ej;
      s_ctr[6] += fin;
      for (int k = 0; k < K_N; ++k) s_cnt[k] = 0;
    }
    __syncthreads();
  }

  if (tid == 0) {
    a.inflight[b] = s_inflight;
    for (int k = 0; k < 8; ++k) a.ctr[(size_t)b * 8 + k] = s_ctr[k];
  }
}

extern "C" {

size_t noc_cycle_scratch_words(int L, int W, int NN) {
  return noc_scratch_words(L, W, NN);
}

// Largest dynamic shared memory a block may opt in to (bytes), or -1.
int noc_cycle_smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) return -1;
  return optin;
}

// Launch one block per instance on ``stream``; returns the cudaError_t of
// the launch (0 = cudaSuccess).
int noc_cycle_launch(const NocArgs* args, void* stream) {
  const NocArgs a = *args;
  size_t smem = 0;
  if (a.use_smem) {
    smem = noc_scratch_words(a.L, 2 * a.V, a.NN) * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        noc_cycle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  noc_cycle_kernel<<<a.B, NOC_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
