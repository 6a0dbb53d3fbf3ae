// Fused wormhole-cycle kernels for Hopper (sm_90a): T cycles in one launch.
//
// Replaces the TPU kernel repro/kernels/noc_cycle/noc_cycle.py::
// make_chunk_runner (a Pallas program with no grid that runs
// ref.cycle_core in a fori_loop with every CycleState plane in VMEM).
// Both kernels compute what repro_torch.kernels.noc_cycle.ref.run_cycles_ref
// computes, bit for bit: integer arithmetic only, so no tolerance applies.
//
// What bounds the work. The cycles are strictly sequential and each cycle is
// a chain of dependent phases (lane refill, candidates, arbitration per
// output link, moves, ejection and child release, counters). One cycle does
// little work per router, so the time is latency: the serial work one block
// does per phase, the barriers between phases and the loads each phase waits
// for, not HBM bytes or integer operations.
//
// The first design, noc_cycle_kernel ("block"), gives one thread block to one
// batch instance. Its threads stride over every candidate, output link and
// FIFO of the instance behind block-wide barriers, and the FIFO planes stay
// in global memory, so each phase waits on chains of L2 round trips. It
// takes ~0.14 us per router per cycle whatever the instance count (9.15 us a
// cycle at 8x8, 36.8 us at 16x16 on an H100 at 700 W), and a batch of B
// instances leaves 132 - B SMs idle. It stays for shapes whose router state
// no cluster can hold in shared memory, and as the comparison.
//
// noc_cycle_cluster_kernel ("cluster_smem") gives one thread-block cluster
// of K CTAs to one instance (grid B x K; K = 8, 16 only where 8 ranks' state
// does not fit). CTA r owns a band of NR consecutive routers (row-major ids,
// so a band is whole mesh rows): their input FIFOs, their NI lanes, the
// arbitration of their output links, and the DPM children queued on their
// child lanes. That state lives in the CTA's dynamic shared memory for all T
// cycles, loaded from the fresh planes at entry and written back at exit;
// the telemetry planes (lutil, rconf) and the delivery times stay in global
// memory, each CTA writing only its own links and routers. The wrapper
// builds the per-rank layout: a router's input FIFOs sit in port order, so
// its output links' arbitration finds its candidates at fixed offsets, and
// the FIFOs of links that do not exist fill the empty ports of their
// source router, so every FIFO has one home.
//
// What the design does about the old bounds. Work per phase is spread over
// a CTA's 160-512 threads for 8-128 routers, so B = 16 instances at 16x16
// fill 128 of the 132 SMs. Serial scans are votes: a candidate adds its
// (age key, port) to a 64-bit shared atomicMin per requested link, a FIFO
// that can eject to one per router, a released child to one per child lane,
// and the owner reads one word. Route lookups that the old kernel made
// every cycle are cached: a lane keeps its packet's route record, a FIFO
// what its worm needs two hops on, and the winner record carries that
// downstream; the next table lookups are cp.async prefetches. The cluster
// needs no barrier per cycle: each cycle a CTA sends its neighbours, with
// st.async into their shared memory, the winner record of every link it
// arbitrates for their FIFOs (phase 3 -> 4) and the status of every FIFO
// their routers request (end of cycle -> phase 2). Each transfer completes
// bytes on the receiver's mbarrier, which the receiver arms with the bytes
// it expects and waits on. A cluster barrier, as cluster.sync() compiles,
// carries a GPU-scope fence and costs several times what a cycle's
// transfers do. A child watches a link into its own router, so child
// release reads its own CTA. Counters are sums per thread and per warp;
// the in-flight high-water mark is rebuilt at exit from each CTA's
// per-cycle counts. The phases and tie-breaks are ref.cycle_core's; the
// votes and integer sums do not depend on order, so the result is bit for
// bit.
//
// Dynamic shared memory per CTA (cl_smem_carve; the Python mirror is
// noc_cycle.cluster_smem_bytes), V = 2, at the children per rank of the
// chip cases: 8x8 (K = 8, 8 routers, 43 children) 14,528 B; 16x16 (K = 8,
// 32 routers, 152) 56,048 B; 32x32 mesh (K = 8, 128 routers, 236) 196,592 B.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NOC_INF (1 << 30)
#define NOC_THREADS 512
#define CL_THREADS_MAX 512
#define NOC_NO_CLUSTER (-1)  // launch code: no cluster of this shape fits

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

// ---------------------------------------------------------------------------
// Cluster kernel: one cluster of K CTAs per instance, router state in shared
// memory.

// A packet's route record: what a lane or a FIFO needs of the packet to run
// its first two hops. The kernel writes one per root-lane queue entry into a
// scratch table at entry and keeps one per DPM child in shared memory; a
// FIFO keeps the part that is handed downstream.
enum {
  R_PID, R_KEY, R_FLITS, R_NS, R_LINK0, R_VCLS0, R_DS0, R_LINK1, R_VCLS1,
  R_DS1, R_ENQ, R_PAD, R_N
};
// a winner record, pushed into the CTA that holds the link's FIFOs
enum {
  W_INFO, W_PID, W_KEY, W_FLITS, W_NS, W_LINK, W_VCLS, W_DS, W_N
};

struct ClArgs {
  // state planes, leading batch axis (B, ...), as NocArgs
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
  // per-rank layout, built by the wrapper
  const int32_t* slot_link;  // (K, NR * D) link whose FIFOs fill an in-slot
  //                            (-1 on the slots of padding routers)
  const int32_t* link_home;  // (L,) rank << 16 | in-slot holding the link
  const int32_t* crow;       // (B, K, CC) child row of each local child, -1
  const int32_t* coff;       // (B, C) each child row's slot in its rank, -1
  int32_t* lrec;             // (B, NN, Q, R_N) scratch: root lane queue
  //                            records, written at entry
  int32_t* cyc;              // (B, K, T, 2) scratch: each CTA's lane grabs
  //                            and finished worms per cycle
  int32_t* dtime;            // (B, ND + 1)
  int B, P, S, Q, QC, C, NN, L, V, D, F, BD, E, EPL, ND, T;
  int K, NR, CC;
};

// One CTA's shared memory: its band's FIFO and lane planes with the route
// lookups cached beside them, one cycle's candidates, votes and winner
// records, its children, and the counters.
struct ClSmem {
  uint64_t *mbar;   // [0] link status, [1] winner records: the transactions
  //                   other CTAs complete on this CTA each cycle
  uint32_t *ostat;  // per out link: its FIFOs' status, 8 bytes (W <= 8):
  //                   fcount | 0x80 if free, sent by the link's home
  int32_t *in_src;  // per in-slot: source rank << 16 | out link there
  uint64_t *lvote;  // per out link: min (key, port) of admissible requests
  uint64_t *evote;  // per router: min (key, port) of FIFOs that can eject
  uint64_t *cvote;  // per router: min (release key, slot) of its children
  int32_t *wrec;    // per in-slot: the winner record of the link (W_N)
  int32_t *rrec;    // per router: its root lane's next queue record (R_N)
  int32_t *lrec;    // per lane: the record of its front packet (R_N)
  int32_t *crec;    // per child: its record (R_N)
  int32_t *fowner, *freq, *fkey, *fds, *f2link, *f2cls, *f2ds;
  int32_t *c_key, *c_pid, *c_dsl;  // candidates (FIFO slots, then lanes)
  int32_t *out_home;               // home (rank << 16 | in-slot) per out link
  int32_t *lnreq, *lacc;           // per out link: requests, flits (epoch)
  int32_t *racc;                   // per router: conflicts (epoch)
  int32_t *lptr;
  int32_t *crtime, *cparent, *cenq, *crow, *cwl;  // children
  int32_t *misc;  // [0, 2) this cycle's lane grabs and finished worms;
  //                 rank 0: [4, 9) run totals, [10, 19) ctr[8] and
  //                 inflight; [20, 22) transaction bytes per cycle
  int16_t *fstage, *fns, *c_req, *c_to, *crs, *cnode;
  int8_t *fhead, *fcount, *fdvc, *fcls, *fnf, *lsent, *ldvc;
  int8_t *c_adm, *c_fid, *c_tvc, *c_won;
  uint8_t *ffin, *ctaken;
};

#define CL_MISC 32

template <class T>
__host__ __device__ inline T* cl_carve(size_t& off, unsigned char* base,
                                       size_t n) {
  T* p = base ? (T*)(base + off) : (T*)0;
  off += (n * sizeof(T) + 15) & ~(size_t)15;
  return p;
}

// Lay the arrays out from ``base`` (nullptr: only count) and return the
// bytes; noc_cycle.cluster_smem_bytes mirrors it.
__host__ __device__ inline size_t cl_smem_carve(unsigned char* base, int NR,
                                                int D, int W, int CC,
                                                ClSmem* s) {
  const size_t NO = (size_t)NR * D, NF = NO * W, NL = 2 * (size_t)NR;
  const size_t NC = NF + NL;
  size_t o = 0;
  ClSmem t;
  t.mbar = cl_carve<uint64_t>(o, base, 2);
  t.ostat = cl_carve<uint32_t>(o, base, 2 * (size_t)NO);
  t.in_src = cl_carve<int32_t>(o, base, NO);
  t.lvote = cl_carve<uint64_t>(o, base, NO);
  t.evote = cl_carve<uint64_t>(o, base, NR);
  t.cvote = cl_carve<uint64_t>(o, base, NR);
  t.wrec = cl_carve<int32_t>(o, base, NO * W_N);
  t.rrec = cl_carve<int32_t>(o, base, (size_t)NR * R_N);
  t.lrec = cl_carve<int32_t>(o, base, NL * R_N);
  t.crec = cl_carve<int32_t>(o, base, (size_t)CC * R_N);
  t.fowner = cl_carve<int32_t>(o, base, NF);
  t.freq = cl_carve<int32_t>(o, base, NF);
  t.fkey = cl_carve<int32_t>(o, base, NF);
  t.fds = cl_carve<int32_t>(o, base, NF);
  t.f2link = cl_carve<int32_t>(o, base, NF);
  t.f2cls = cl_carve<int32_t>(o, base, NF);
  t.f2ds = cl_carve<int32_t>(o, base, NF);
  t.c_key = cl_carve<int32_t>(o, base, NC);
  t.c_pid = cl_carve<int32_t>(o, base, NC);
  t.c_dsl = cl_carve<int32_t>(o, base, NC);
  t.out_home = cl_carve<int32_t>(o, base, NO);
  t.lnreq = cl_carve<int32_t>(o, base, NO);
  t.lacc = cl_carve<int32_t>(o, base, NO);
  t.racc = cl_carve<int32_t>(o, base, NR);
  t.lptr = cl_carve<int32_t>(o, base, NL);
  t.crtime = cl_carve<int32_t>(o, base, CC);
  t.cparent = cl_carve<int32_t>(o, base, CC);
  t.cenq = cl_carve<int32_t>(o, base, CC);
  t.crow = cl_carve<int32_t>(o, base, CC);
  t.cwl = cl_carve<int32_t>(o, base, CC);
  t.misc = cl_carve<int32_t>(o, base, CL_MISC);
  t.fstage = cl_carve<int16_t>(o, base, NF);
  t.fns = cl_carve<int16_t>(o, base, NF);
  t.c_req = cl_carve<int16_t>(o, base, NC);
  t.c_to = cl_carve<int16_t>(o, base, NC);
  t.crs = cl_carve<int16_t>(o, base, CC);
  t.cnode = cl_carve<int16_t>(o, base, CC);
  t.fhead = cl_carve<int8_t>(o, base, NF);
  t.fcount = cl_carve<int8_t>(o, base, NF);
  t.fdvc = cl_carve<int8_t>(o, base, NF);
  t.fcls = cl_carve<int8_t>(o, base, NF);
  t.fnf = cl_carve<int8_t>(o, base, NF);
  t.ffin = cl_carve<uint8_t>(o, base, NF);
  t.lsent = cl_carve<int8_t>(o, base, NL);
  t.ldvc = cl_carve<int8_t>(o, base, NL);
  t.c_adm = cl_carve<int8_t>(o, base, NC);
  t.c_fid = cl_carve<int8_t>(o, base, NC);
  t.c_tvc = cl_carve<int8_t>(o, base, NC);
  t.c_won = cl_carve<int8_t>(o, base, NC);
  t.ctaken = cl_carve<uint8_t>(o, base, CC);
  if (s) *s = t;
  return o;
}

#define CL_NO_VOTE (~(uint64_t)0)

// A vote: a signed 32-bit key in order-preserving unsigned form, then the
// port (or slot) that breaks ties the way argmin does, lowest first.
__device__ __forceinline__ uint64_t cl_vote(int key, int low, int bits) {
  return ((uint64_t)((uint32_t)key ^ 0x80000000u) << bits) | (uint32_t)low;
}

// Asynchronous global -> shared copies of 4 or 16 bytes (cp.async); the
// thread that issued them waits with cl_async_wait before a barrier. A host
// compiler (no __CUDA_ARCH__) copies at once.
__device__ __forceinline__ void cl_async4(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
#else
  *(int32_t*)dst = *(const int32_t*)src;
#endif
}

__device__ __forceinline__ void cl_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
#else
  for (int k = 0; k < 4; ++k) ((int32_t*)dst)[k] = ((const int32_t*)src)[k];
#endif
}

__device__ __forceinline__ void cl_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Admission of a flit at the FIFOs of its requested link, from their
// status bytes ``st`` (fcount | 0x80 if free): a header takes the first
// free VC of its class, a body flit needs credit at its pinned VC ``dv``.
__device__ __forceinline__ void cl_admit(const uint8_t* st, int cls, int dv,
                                         int fid, int V, int BD,
                                         bool credit_free, int& adm,
                                         int& tvc) {
  bool hdr_ok = false;
  int hvc = cls * V;
  for (int k = 0; k < V; ++k) {
    if (st[cls * V + k] & 0x80) {
      hdr_ok = true;
      hvc = cls * V + k;
      break;
    }
  }
  const bool hdr = fid == 0;
  const bool body_ok = credit_free || (st[dv] & 0x7f) < BD;
  adm = hdr ? hdr_ok : body_ok;
  tvc = hdr ? hvc : dv;
}

// Transactions between the CTAs of a cluster. A CTA sends a neighbour its
// data with st.async, which completes bytes on the neighbour's mbarrier;
// the neighbour arms the barrier with the bytes it expects each cycle and
// waits for the phase. No cluster-wide barrier, and so no GPU-scope fence,
// is needed per cycle. A host compiler (no __CUDACC__) runs the stand-ins of
// tests/cuda_host instead.
__device__ __forceinline__ unsigned cl_saddr(const void* p) {
#ifdef __CUDA_ARCH__
  return (unsigned)__cvta_generic_to_shared(p);
#else
  return 0;
#endif
}

__device__ __forceinline__ void cl_mbar_init(uint64_t* mb) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(cl_saddr(mb))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#elif !defined(__CUDACC__)
  noc_host_mbar_init(mb);
#endif
}

// One arrival that also expects ``bytes`` of transactions this phase.
__device__ __forceinline__ void cl_mbar_expect(uint64_t* mb, int bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(cl_saddr(mb)), "r"(bytes) : "memory");
#elif !defined(__CUDACC__)
  noc_host_mbar_expect(mb, bytes);
#endif
}

// Wait for the phase of ``parity`` to complete; a wait that outlasts any
// cycle by far traps instead of hanging the card.
__device__ __forceinline__ void cl_mbar_wait(uint64_t* mb, int parity) {
#if defined(__CUDA_ARCH__)
  unsigned done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(cl_saddr(mb)), "r"(parity) : "memory");
    if (spins > (1ll << 22)) __trap();
  }
#elif !defined(__CUDACC__)
  noc_host_mbar_wait(mb, parity);
#endif
}

// st.async of 16 / 8 bytes to the copy of ``dst`` in CTA ``rank``,
// completing them on that CTA's copy of ``mb``.
__device__ __forceinline__ void cl_send16(void* dst, int rank, int4 v,
                                          uint64_t* mb) {
#if defined(__CUDA_ARCH__)
  unsigned d, m;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d) : "r"(cl_saddr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(m) : "r"(cl_saddr(mb)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
      " [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(d), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(m) : "memory");
#elif !defined(__CUDACC__)
  noc_host_send(dst, rank, &v, 16, mb);
#endif
}

__device__ __forceinline__ void cl_send8(void* dst, int rank, uint32_t x,
                                         uint32_t y, uint64_t* mb) {
#if defined(__CUDA_ARCH__)
  unsigned d, m;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d) : "r"(cl_saddr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(m) : "r"(cl_saddr(mb)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32"
      " [%0], {%1, %2}, [%3];\n"
      ::"r"(d), "r"(x), "r"(y), "r"(m) : "memory");
#elif !defined(__CUDACC__)
  const uint32_t v[2] = {x, y};
  noc_host_send(dst, rank, v, 8, mb);
#endif
}

// The route record of packet ``pid`` read from the tables (at entry).
__device__ void cl_record(int32_t* r, int pid, const ClArgs& a,
                          const int32_t* enqueue, const int32_t* ns_t,
                          const int32_t* flits, const int32_t* link_t,
                          const int32_t* vcls_t, const int32_t* dslot) {
  const int pc = clampi(pid, a.P - 1);
  const size_t s0 = (size_t)pc * a.S, s1 = s0 + clampi(1, a.S - 1);
  r[R_PID] = pid;
  r[R_ENQ] = enqueue[pc];
  r[R_KEY] = wrap_key(enqueue[pc], a.P, pc, a.F, 0);
  r[R_FLITS] = flits[pc];
  r[R_NS] = ns_t[pc];
  r[R_LINK0] = link_t[s0]; r[R_VCLS0] = vcls_t[s0]; r[R_DS0] = dslot[s0];
  r[R_LINK1] = link_t[s1]; r[R_VCLS1] = vcls_t[s1]; r[R_DS1] = dslot[s1];
  r[R_PAD] = 0;
}

__global__ void __launch_bounds__(CL_THREADS_MAX, 1)
noc_cycle_cluster_kernel(const ClArgs a) {
  extern __shared__ __align__(16) unsigned char noc_cl_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / a.K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int P = a.P, S = a.S, Q = a.Q, QC = a.QC, C = a.C, NN = a.NN;
  const int L = a.L, V = a.V, D = a.D, F = a.F, BD = a.BD, NR = a.NR;
  const int CC = a.CC, EPL = a.EPL;
  const int W = 2 * V, DW = D * W, LW = L * W;
  const int NO = NR * D, NF = NO * W, NL = 2 * NR, NC = NF + NL;
  const int v0 = rank * NR;              // first router of the band
  const int nodes = min(NR, NN - v0);    // routers that exist
  const int l0 = v0 * D;                 // first output link of the band
  const bool credit_free = BD >= F;      // a FIFO holds one whole worm

  ClSmem s;
  cl_smem_carve(noc_cl_smem, NR, D, W, CC, &s);
  const size_t bP = (size_t)b * P;
  const int32_t* enqueue = a.enqueue + bP;
  const int32_t* ns_t = a.num_stages + bP;
  const int32_t* flits = a.flits + bP;
  const int32_t* link_t = a.link + bP * S;
  const int32_t* vcls_t = a.vcls + bP * S;
  const int32_t* dslot = a.dslot + bP * S;
  const int32_t* lrec_g = a.lrec + ((size_t)b * NN + v0) * Q * R_N;
  const int32_t* slot_link = a.slot_link + (size_t)rank * NO;
  int32_t* lutil = a.lutil + (size_t)b * a.E * L;
  int32_t* rconf = a.rconf + (size_t)b * a.E * NN;
  int32_t* dtime = a.dtime + (size_t)b * (a.ND + 1);
  int* ctr = s.misc + 10;
  int32_t* cyc = a.cyc + ((size_t)b * a.K + rank) * a.T * 2;
  int nd_last = -1;  // last cycle this thread wrote the discard slot
  // this thread's run totals of the counters that need no per-cycle sum
  unsigned r_arb = 0, r_moves = 0, r_inj = 0, r_ej = 0, r_fin = 0;
  // the warps whose threads run routers (phases 1 and 5)
  const bool router_warp = tid / 32 * 32 < min(nodes, nt);

  // ---- load the band's state --------------------------------------------
  for (int i = tid; i < NF; i += nt) {
    const int l = slot_link[i / W];
    if (l >= 0) {
      const size_t g = (size_t)b * LW + (size_t)l * W + i % W;
      s.fowner[i] = a.fowner[g]; s.fstage[i] = a.fstage[g];
      s.fhead[i] = a.fhead[g]; s.fcount[i] = a.fcount[g];
      s.fdvc[i] = a.fdvc[g]; s.freq[i] = a.freq[g]; s.fkey[i] = a.fkey[g];
      s.fcls[i] = a.fcls[g]; s.ffin[i] = a.ffin[g]; s.fnf[i] = a.fnf[g];
    } else {  // a padding router's port: a FIFO that never fills
      s.fowner[i] = -1; s.fstage[i] = 0; s.fhead[i] = 0; s.fcount[i] = 0;
      s.fdvc[i] = 0; s.freq[i] = -1; s.fkey[i] = 0; s.fcls[i] = 0;
      s.ffin[i] = 0; s.fnf[i] = 1;
    }
    // the owner's lookups at the FIFO's next stage and the one after it
    const size_t ps = (size_t)clampi(s.fowner[i], P - 1) * S;
    const int st = s.fstage[i];
    s.fds[i] = dslot[ps + clampi(st + 1, S - 1)];
    s.fns[i] = (int16_t)ns_t[ps / S];
    s.f2link[i] = link_t[ps + clampi(st + 2, S - 1)];
    s.f2cls[i] = vcls_t[ps + clampi(st + 2, S - 1)];
    s.f2ds[i] = dslot[ps + clampi(st + 2, S - 1)];
  }
  // the route records of the band's root-lane queues
  const int32_t* lane_seq = a.lane_seq + (size_t)b * 2 * NN * Q;
  for (int i = tid; i < nodes * Q; i += nt)
    cl_record(a.lrec + (((size_t)b * NN + v0) * Q + i) * R_N,
              lane_seq[(size_t)(2 * v0 + 2 * (i / Q)) * Q + i % Q], a,
              enqueue, ns_t, flits, link_t, vcls_t, dslot);
  __syncthreads();
  for (int q = tid; q < NL; q += nt) {
    const bool real = q / 2 < nodes;
    const size_t g = (size_t)b * 2 * NN + 2 * v0 + q;
    const int lp = real ? a.lpid[g] : -1;
    s.lsent[q] = real ? a.lsent[g] : 0;
    s.lptr[q] = real ? a.lptr[g] : 0;
    s.ldvc[q] = real ? a.ldvc[g] : 0;
    cl_record(s.lrec + q * R_N, lp, a, enqueue, ns_t, flits, link_t, vcls_t,
              dslot);
    if (q % 2 == 0) {
      const int32_t* r = lrec_g + ((size_t)(q / 2) * Q
                                   + clampi(s.lptr[q], Q - 1)) * R_N;
      for (int k = 0; k < R_N; ++k)
        s.rrec[(q / 2) * R_N + k] = real ? r[k] : (k == R_PID ? -1 : 0);
    }
  }
  for (int o = tid; o < NO; o += nt) {
    s.out_home[o] = o < nodes * D ? a.link_home[l0 + o] : -1;
    const int l = slot_link[o];  // in-slot o's link: source rank, out link
    const int sr = l / D / NR;
    s.in_src[o] = l < 0 ? -1 : (sr << 16) | (l - sr * NR * D);
    s.wrec[o * W_N + W_INFO] = -1;
    s.lvote[o] = CL_NO_VOTE;
    s.lnreq[o] = 0;
    s.lacc[o] = 0;
  }
  for (int vl = tid; vl < NR; vl += nt) {
    s.evote[vl] = CL_NO_VOTE;
    s.cvote[vl] = CL_NO_VOTE;
    s.racc[vl] = 0;
  }
  const int32_t* crow_g = a.crow + ((size_t)b * a.K + rank) * CC;
  for (int j = tid; j < CC; j += nt) {
    const int c = crow_g[j];
    s.crow[j] = c;
    s.crs[j] = -1;  // a child no arrival can release
    s.cnode[j] = -1;  // a child no lane queues
    s.crtime[j] = -1;
    s.ctaken[j] = 0;
    if (c >= 0) {
      const size_t g = (size_t)b * C + c;
      const int rs = a.child_rs[g];
      if (rs >= 0 && rs < 32768) s.crs[j] = (int16_t)rs;
      s.crtime[j] = a.crtime[g];
      s.ctaken[j] = a.ctaken[g];
      s.cparent[j] = a.child_parent[g];
      s.cenq[j] = a.child_enq[g];
      // the watched link's in-slot: this CTA's (cluster_plan checks it)
      s.cwl[j] = a.link_home[clampi(a.watch_link[g], L - 1)] & 0xffff;
      cl_record(s.crec + j * R_N, a.child_pid[g], a, enqueue, ns_t, flits,
                link_t, vcls_t, dslot);
    }
  }
  for (int i = tid; i < CL_MISC; i += nt) s.misc[i] = 0;
  __syncthreads();
  // a child's router, from the lane queues that hold it
  const int32_t* chl_g = a.chl + ((size_t)b * NN + v0) * QC;
  const int32_t* coff = a.coff + (size_t)b * C;
  for (int i = tid; i < nodes * QC; i += nt)
    if (chl_g[i] >= 0) s.cnode[coff[chl_g[i]]] = (int16_t)(i / QC);
  __syncthreads();
  // cycle 0's child-lane votes
  for (int j = tid; j < CC; j += nt) {
    const int crt = s.crtime[j];
    if (s.cnode[j] >= 0 && crt == 0 && !s.ctaken[j])
      atomicMin((unsigned long long*)&s.cvote[s.cnode[j]],
                (unsigned long long)cl_vote(crt * C + s.crow[j], j, 16));
  }
  // the bytes other CTAs send this CTA each cycle: the status of each out
  // link whose FIFOs are theirs, the winner record of each in-slot that
  // their routers feed
  for (int o = tid; o < NO; o += nt) {
    if (o < nodes * D && s.out_home[o] >> 16 != rank)
      atomicAdd(&s.misc[20], 8);
    if (s.in_src[o] >= 0 && s.in_src[o] >> 16 != rank)
      atomicAdd(&s.misc[21], 4 * W_N);
  }
  if (tid == 0) {
    cl_mbar_init(s.mbar);
    cl_mbar_init(s.mbar + 1);
  }
  if (rank == 0 && tid == 0) {
    for (int k = 0; k < 8; ++k) ctr[k] = a.ctr[(size_t)b * 8 + k];
    ctr[8] = a.inflight[b];
  }
  // this CTA's in-slot FIFO status, to the CTAs whose routers feed them
  auto send_status = [&]() {
    for (int o = tid; o < NO; o += nt) {
      const int src = s.in_src[o];
      if (src < 0) continue;
      uint32_t w[2] = {0, 0};
      for (int k = 0; k < W; ++k) {
        const int i = o * W + k;
        w[k / 4] |= ((uint32_t)(s.fcount[i] & 0x7f)
                     | (s.fowner[i] < 0 ? 0x80u : 0u)) << (8 * (k % 4));
      }
      uint32_t* dst = s.ostat + 2 * (src & 0xffff);
      if (src >> 16 == rank) {
        dst[0] = w[0];
        dst[1] = w[1];
      } else {
        cl_send8(dst, src >> 16, w[0], w[1], s.mbar);
      }
    }
  };
  __syncthreads();
  cluster.sync();  // every CTA's barriers are set before the first send
  send_status();

  for (int t = 0; t < a.T; ++t) {
    const int ep = min(t / EPL, a.E - 1);
    const bool new_epoch = t > 0 && ep != min((t - 1) / EPL, a.E - 1);
    int n_got = 0, n_fin = 0;

    // ---- 1. NI lane refill (per router: its root and child lane) --------
    for (int vl = tid; vl < nodes; vl += nt) {
      if (new_epoch) {  // the router's conflicts of the epoch that ended
        if (s.racc[vl])
          atomicAdd(&rconf[(size_t)(ep - 1) * NN + v0 + vl], s.racc[vl]);
        s.racc[vl] = 0;
      }
      const int rl = 2 * vl;
      const int ptr = s.lptr[rl];
      int32_t* rr = s.rrec + vl * R_N;
      const bool root_ok = ptr < Q && rr[R_PID] >= 0 && rr[R_ENQ] <= t;
      // child lane: lowest (release cycle, row) among released children
      const uint64_t cv = s.cvote[vl];
      s.cvote[vl] = CL_NO_VOTE;
      for (int side = 0; side < 2; ++side) {
        const int ln = rl + side;
        int32_t* lr = s.lrec + ln * R_N;
        const bool need = lr[R_PID] < 0 || (int)s.lsent[ln] >= lr[R_FLITS];
        const bool ok = side ? cv != CL_NO_VOTE : root_ok;
        if (need && ok) {
          const int32_t* src;
          if (side) {
            const int j = (int)(cv & 0xffff);
            s.ctaken[j] = 1;
            src = s.crec + j * R_N;
          } else {
            src = rr;
          }
          for (int k = 0; k < R_N; ++k) lr[k] = src[k];
          s.lsent[ln] = 0;
          if (!side) {  // fetch the queue's next record for a later cycle
            s.lptr[ln] = ptr + 1;
            const int32_t* nx = lrec_g + ((size_t)vl * Q
                                          + clampi(ptr + 1, Q - 1)) * R_N;
            for (int k = 0; k < R_N; k += 4) cl_async16(rr + k, nx + k);
          }
          ++n_got;
        } else if (need) {
          lr[R_PID] = -1;
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      if (t > 0) {  // the last cycle's counts, for the high-water mark
        cyc[2 * (t - 1)] = s.misc[0];
        cyc[2 * (t - 1) + 1] = s.misc[1];
        s.misc[0] = s.misc[1] = 0;
      }
      cl_mbar_expect(s.mbar, s.misc[20]);
    }
    cl_mbar_wait(s.mbar, t & 1);  // the link status the last cycle left

    // ---- 2. candidates from start-of-cycle state; votes per out link ----
    for (int i = tid; i < NC; i += nt) {
      int rq, key, pid, fid, nf, cls, dv, ds, to = 0, port;
      bool valid;
      if (i < NF) {
        const int own = s.fowner[i];
        fid = s.fhead[i];
        valid = own >= 0 && s.fcount[i] > 0;
        rq = s.freq[i];
        key = wrap_add(s.fkey[i], fid);
        cls = s.fcls[i];
        dv = s.fdvc[i];
        pid = clampi(own, P - 1);
        to = (int)s.fstage[i] + 1;
        nf = s.fnf[i];
        ds = s.fds[i];
        port = i % DW;
      } else {
        const int q = i - NF;
        const int32_t* lr = s.lrec + q * R_N;
        const int lpv = lr[R_PID];
        pid = clampi(lpv, P - 1);
        fid = s.lsent[q];
        nf = lr[R_FLITS];
        valid = lpv >= 0 && fid < nf;
        rq = lr[R_LINK0];
        key = wrap_add(lr[R_KEY], fid);
        cls = lr[R_VCLS0];
        dv = s.ldvc[q];
        ds = lr[R_DS0];
        port = DW + q % 2;
      }
      const int req = valid ? rq : -1;
      int o = -1, adm = 0, tvc = dv;
      if (req >= 0) {
        // a router only requests its own output links
        o = req - l0;
        ++r_arb;
        atomicAdd(&s.lnreq[o], 1);
        cl_admit((const uint8_t*)(s.ostat + 2 * o), cls, dv, fid, V, BD,
                 credit_free, adm, tvc);
        if (adm && key < NOC_INF)  // argmin over keys below the sentinel
          atomicMin((unsigned long long*)&s.lvote[o],
                    (unsigned long long)cl_vote(key, port, 8));
      }
      s.c_req[i] = (int16_t)o;
      s.c_adm[i] = (int8_t)adm;
      s.c_key[i] = key;
      s.c_pid[i] = pid;
      s.c_to[i] = (int16_t)to;
      s.c_fid[i] = (int8_t)fid;
      s.c_tvc[i] = (int8_t)tvc;
      s.c_dsl[i] = (fid == nf - 1 && ds >= 0) ? ds : -1;
      s.c_won[i] = 0;
    }
    cl_async_wait();  // this thread's route prefetches have landed
    __syncthreads();

    // ---- 3. link arbitration: the winner of each out link's vote --------
    for (int o = tid; o < nodes * D; o += nt) {
      const int vl = o / D;
      if (new_epoch) {  // the link's flits of the epoch that ended
        if (s.lacc[o]) atomicAdd(&lutil[(size_t)(ep - 1) * L + l0 + o],
                                 s.lacc[o]);
        s.lacc[o] = 0;
      }
      const uint64_t vote = s.lvote[o];
      const int nreq = s.lnreq[o];
      s.lvote[o] = CL_NO_VOTE;
      s.lnreq[o] = 0;
      int rec[W_N];
      rec[W_INFO] = -1;
      for (int k = 1; k < W_N; ++k) rec[k] = 0;
      int dsl = -1;
      if (vote != CL_NO_VOTE) {
        const int port = (int)(vote & 0xff);
        const int c = port < DW ? vl * DW + port : NF + 2 * vl + port - DW;
        s.c_won[c] = 1;
        ++r_moves;
        if (c >= NF) ++r_inj;
        s.lacc[o] += 1;
        rec[W_INFO] = ((int)s.c_to[c] << 16) | ((int)s.c_fid[c] << 8)
                    | (int)s.c_tvc[c];
        rec[W_PID] = s.c_pid[c];
        if (c < NF) {  // what the next FIFO needs of the worm
          rec[W_KEY] = s.fkey[c]; rec[W_FLITS] = s.fnf[c];
          rec[W_NS] = s.fns[c]; rec[W_LINK] = s.f2link[c];
          rec[W_VCLS] = s.f2cls[c]; rec[W_DS] = s.f2ds[c];
        } else {
          const int32_t* lr = s.lrec + (c - NF) * R_N;
          rec[W_KEY] = lr[R_KEY]; rec[W_FLITS] = lr[R_FLITS];
          rec[W_NS] = lr[R_NS]; rec[W_LINK] = lr[R_LINK1];
          rec[W_VCLS] = lr[R_VCLS1]; rec[W_DS] = lr[R_DS1];
        }
        dsl = s.c_dsl[c];
      }
      if (nreq > 1) atomicAdd(&s.racc[vl], nreq - 1);
      // delivery record: tail arrivals at delivery stages; the discard
      // slot gets its last cycle at exit
      if (dsl >= 0) dtime[dsl] = t;
      else nd_last = t;
      // the winner record goes to the CTA that holds the link's FIFOs
      const int home = s.out_home[o];
      int32_t* wr = s.wrec + (home & 0xffff) * W_N;
      const int4 r0 = make_int4(rec[0], rec[1], rec[2], rec[3]);
      const int4 r1 = make_int4(rec[4], rec[5], rec[6], rec[7]);
      if (home >> 16 == rank) {
        ((int4*)wr)[0] = r0;
        ((int4*)wr)[1] = r1;
      } else {
        cl_send16(wr, home >> 16, r0, s.mbar + 1);
        cl_send16(wr + 4, home >> 16, r1, s.mbar + 1);
      }
    }
    __syncthreads();
    if (tid == 0) cl_mbar_expect(s.mbar + 1, s.misc[21]);
    cl_mbar_wait(s.mbar + 1, t & 1);  // the winner records are in

    // ---- 4. apply moves (per FIFO and lane); ejection votes --------------
    for (int i = tid; i < NF; i += nt) {
      const bool won = s.c_won[i];
      int fh = s.fhead[i], cnt_f = s.fcount[i], own = s.fowner[i];
      if (won && fh == 0) s.fdvc[i] = s.c_tvc[i];
      if (won && fh == (int)s.fnf[i] - 1) own = -1;  // tail departs
      fh += won;
      cnt_f -= won;
      const int32_t* wr = s.wrec + (i / W) * W_N;
      const int info = wr[W_INFO];
      const bool arr = info >= 0 && (info & 0xff) == i % W;
      if (arr && ((info >> 8) & 0xff) == 0) {  // a header: its route
        const int apid = wr[W_PID];            // clipped by the candidate
        const int ast = info >> 16;
        const int a_ns = wr[W_NS];
        own = apid;
        fh = 0;
        s.fstage[i] = (int16_t)ast;
        s.freq[i] = ast + 1 < a_ns ? wr[W_LINK] : -1;
        s.fcls[i] = (int8_t)wr[W_VCLS];
        s.fds[i] = wr[W_DS];
        s.fkey[i] = wr[W_KEY];
        s.ffin[i] = ast == a_ns - 1;
        s.fnf[i] = (int8_t)wr[W_FLITS];
        s.fns[i] = (int16_t)a_ns;
        // the stage after, for the FIFO this worm moves on to
        const size_t ps = (size_t)apid * S + clampi(ast + 2, S - 1);
        cl_async4(&s.f2link[i], link_t + ps);
        cl_async4(&s.f2cls[i], vcls_t + ps);
        cl_async4(&s.f2ds[i], dslot + ps);
      }
      cnt_f += arr;
      s.fowner[i] = own;
      s.fhead[i] = (int8_t)fh;
      s.fcount[i] = (int8_t)cnt_f;
      if (own >= 0 && cnt_f > 0 && s.ffin[i]
          && wrap_add(s.fkey[i], fh) < NOC_INF)
        atomicMin((unsigned long long*)&s.evote[i / DW],
                  (unsigned long long)cl_vote(wrap_add(s.fkey[i], fh),
                                              i % DW, 8));
    }
    for (int q = tid; q < NL; q += nt) {
      if (!s.c_won[NF + q]) continue;
      if (s.c_fid[NF + q] == 0) s.ldvc[q] = s.c_tvc[NF + q];
      s.lsent[q] = (int8_t)(s.lsent[q] + 1);
    }
    __syncthreads();

    // ---- 5. ejection on post-move state (per router); child release -----
    for (int vl = tid; vl < nodes; vl += nt) {
      const uint64_t vote = s.evote[vl];
      s.evote[vl] = CL_NO_VOTE;
      if (vote == CL_NO_VOTE) continue;
      const int c = vl * DW + (int)(vote & 0xff);
      const int fh = s.fhead[c];
      if (fh == (int)s.fnf[c] - 1) {
        s.fowner[c] = -1;
        ++n_fin;
      }
      s.fhead[c] = (int8_t)(fh + 1);
      s.fcount[c] = (int8_t)(s.fcount[c] - 1);
      ++r_ej;
    }
    for (int j = tid; j < CC; j += nt) {
      int crt = s.crtime[j];
      if (crt < 0 && s.crs[j] >= 0) {
        const int32_t* wr = s.wrec + s.cwl[j] * W_N;
        const int info = wr[W_INFO];
        if (info >= 0 && ((info >> 8) & 0xff) == 0
            && (info >> 16) == s.crs[j] && wr[W_PID] == s.cparent[j]) {
          crt = max(t + 1, s.cenq[j]);
          s.crtime[j] = crt;
        }
      }
      // the next cycle's child-lane vote
      if (s.cnode[j] >= 0 && crt >= 0 && crt <= t + 1 && !s.ctaken[j])
        atomicMin((unsigned long long*)&s.cvote[s.cnode[j]],
                  (unsigned long long)cl_vote(crt * C + s.crow[j], j, 16));
    }

    __syncthreads();

    // ---- 6. the link status for the next cycle; this cycle's counts ----
    if (t + 1 < a.T) send_status();
    if (router_warp) {
      const unsigned got = __reduce_add_sync(0xffffffffu, (unsigned)n_got);
      const unsigned fin = __reduce_add_sync(0xffffffffu, (unsigned)n_fin);
      if (tid % 32 == 0 && got) atomicAdd(&s.misc[0], (int)got);
      if (tid % 32 == 0 && fin) atomicAdd(&s.misc[1], (int)fin);
    }
    r_fin += n_fin;
  }
  __syncthreads();
  if (tid == 0) {  // the last cycle's counts
    cyc[2 * (a.T - 1)] = s.misc[0];
    cyc[2 * (a.T - 1) + 1] = s.misc[1];
  }
  {  // the run totals of the other counters, into rank 0
    const unsigned mine[5] = {r_arb, r_moves, r_inj, r_ej, r_fin};
    int* tot = cluster.map_shared_rank(s.misc, 0) + 4;
    for (int k = 0; k < 5; ++k) {
      const unsigned sum = __reduce_add_sync(0xffffffffu, mine[k]);
      if (tid % 32 == 0 && sum) atomicAdd(&tot[k], (int)sum);
    }
  }
  cluster.sync();  // every CTA's counts and totals are in
  if (rank == 0) {
    // the cluster's counts cycle by cycle, then the in-flight high-water
    // mark over them
    int32_t* c0 = a.cyc + (size_t)b * a.K * a.T * 2;
    for (int tt = tid; tt < a.T; tt += nt) {
      int got = 0, fin = 0;
      for (int k = 0; k < a.K; ++k) {
        got += c0[((size_t)k * a.T + tt) * 2];
        fin += c0[((size_t)k * a.T + tt) * 2 + 1];
      }
      c0[2 * tt] = got;
      c0[2 * tt + 1] = fin;
    }
    __syncthreads();
  }
  if (rank == 0 && tid == 0) {
    const int32_t* c0 = a.cyc + (size_t)b * a.K * a.T * 2;
    for (int tt = 0; tt < a.T; ++tt) {
      ctr[8] += c0[2 * tt];
      ctr[7] = max(ctr[7], ctr[8]);
      ctr[8] -= c0[2 * tt + 1];
    }
    const unsigned arb = s.misc[4], moves = s.misc[5], inj = s.misc[6];
    const unsigned ej = s.misc[7], fin = s.misc[8];
    const unsigned add[7] = {moves, moves, moves - inj + ej, moves, arb,
                             inj + ej, fin};
    for (int k = 0; k < 7; ++k) ctr[k] = (int)((unsigned)ctr[k] + add[k]);
  }

  // ---- write the band's state back ----------------------------------------
  const int ep_last = min((a.T - 1) / EPL, a.E - 1);
  for (int o = tid; o < nodes * D; o += nt)
    if (s.lacc[o]) atomicAdd(&lutil[(size_t)ep_last * L + l0 + o], s.lacc[o]);
  for (int vl = tid; vl < nodes; vl += nt)
    if (s.racc[vl])
      atomicAdd(&rconf[(size_t)ep_last * NN + v0 + vl], s.racc[vl]);
  if (nd_last >= 0) atomicMax(&dtime[a.ND], nd_last);
  for (int i = tid; i < NF; i += nt) {
    const int l = slot_link[i / W];
    if (l < 0) continue;
    const size_t g = (size_t)b * LW + (size_t)l * W + i % W;
    a.fowner[g] = s.fowner[i]; a.fstage[g] = s.fstage[i];
    a.fhead[g] = s.fhead[i]; a.fcount[g] = s.fcount[i];
    a.fdvc[g] = s.fdvc[i]; a.freq[g] = s.freq[i]; a.fkey[g] = s.fkey[i];
    a.fcls[g] = s.fcls[i]; a.ffin[g] = s.ffin[i]; a.fnf[g] = s.fnf[i];
  }
  for (int q = tid; q < 2 * nodes; q += nt) {
    const size_t g = (size_t)b * 2 * NN + 2 * v0 + q;
    a.lpid[g] = s.lrec[q * R_N + R_PID]; a.lsent[g] = s.lsent[q];
    a.lptr[g] = s.lptr[q]; a.ldvc[g] = s.ldvc[q];
  }
  for (int j = tid; j < CC; j += nt) {
    const int c = s.crow[j];
    if (c < 0) continue;
    a.crtime[(size_t)b * C + c] = s.crtime[j];
    a.ctaken[(size_t)b * C + c] = s.ctaken[j];
  }
  if (rank == 0 && tid == 0) {
    for (int k = 0; k < 8; ++k) a.ctr[(size_t)b * 8 + k] = ctr[k];
    a.inflight[b] = ctr[8];
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B);
  cfg.blockDim = dim3(NOC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaError_t e = cudaLaunchKernelEx(&cfg, noc_cycle_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one cluster CTA (bytes).
size_t noc_cycle_cluster_smem_bytes(int NR, int D, int W, int CC) {
  return cl_smem_carve(nullptr, NR, D, W, CC, nullptr);
}

// Launch one cluster of ``K`` CTAs per instance on ``stream``, with the
// most threads per CTA (at most ``threads_max``, halved down to 64) at which
// every instance's cluster can be resident at once, else with those that let
// the most clusters be resident. ``threads`` receives the CTA size chosen and
// ``max_clusters`` the clusters resident at once. Returns the cudaError_t of
// the launch, or NOC_NO_CLUSTER when no cluster of this shape fits the card
// (cudaOccupancyMaxActiveClusters of 0 at every size).
int noc_cycle_cluster_launch(const ClArgs* args, int threads_max,
                             int* threads, int* max_clusters, void* stream) {
  const ClArgs a = *args;
  const size_t smem = cl_smem_carve(nullptr, a.NR, a.D, 2 * a.V, a.CC,
                                    nullptr);
  cudaError_t e = cudaFuncSetAttribute(
      noc_cycle_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (a.K > 8) {  // 16 CTAs per cluster is beyond the portable size
    e = cudaFuncSetAttribute(noc_cycle_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.K);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int best = 0, best_n = 0;
  for (int th = threads_max; th >= 64 || th == threads_max;
       th = (th / 2 + 31) / 32 * 32) {
    cfg.blockDim = dim3(th);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, noc_cycle_cluster_kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n > best_n) { best = th; best_n = n; }
    if (n >= a.B || th <= 64) break;
  }
  *threads = best;
  *max_clusters = best_n;
  if (best_n == 0) return NOC_NO_CLUSTER;
  cfg.blockDim = dim3(best);
  e = cudaLaunchKernelEx(&cfg, noc_cycle_cluster_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
