"""Plain PyTorch wormhole cycle over packed router-centric planes.

Twin of ``repro.kernels.noc_cycle.ref``: ``cycle_core`` is the reference's
jnp cycle translated line by line, with the batch axis that the reference
gets from ``vmap`` written out as the leading dimension of every state
plane and traffic table. It is the plain version of the CUDA kernel in
``csrc/noc_cycle.cu``: ``ops.run_cycles`` takes it for CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card, bit for bit.

State layout (one instance; every plane carries a leading ``B``):

* ``fowner[L, W]``  packet id owning VC FIFO ``(link, vc)`` (-1 free);
                    ``W = 2V`` VCs per directed link, vcs ``[0, V)`` are
                    class HIGH(0), ``[V, 2V)`` class LOW(1).
* ``fstage[L, W]``  int16 — the owner's route stage this FIFO serves.
* ``fhead[L, W]``   int8 — flit id of the FIFO's front (FIFOs hold the
                    contiguous flit run ``[fhead, fhead + fcount)``).
* ``fcount[L, W]``  int8 — flits resident (0 while the run is in transit).
* ``lpid/lsent/lptr[2NN]`` NI lane fronts: current injecting packet, flits
                    already injected, and the root-lane static-order cursor.
* ``crtime[C]``     cycle each DPM child becomes releasable (-1 pending);
                    ``ctaken`` marks children consumed by their lane.
* ``inflight/ctr``  counters (same event semantics as the host sim).

The phases run in the reference's order, and each reads the values the
previous phase produced: lane refill, candidates from start-of-cycle state,
per-(node, output link) masked argmin over ``node_ports``, moves, ejection
on post-move state, child release, counters, telemetry. Every gather clips
its index first, as the reference does. ``argmin``/``argmax`` return the
first extreme index in torch as in jnp, which is the tie-break both engines
rely on (lowest port, lowest VC).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# sentinel above every real age key; compile.py keeps keys below it
from ..noc_step.noc_step import NOC_INF

# counter indices (named after the SimStats fields they feed; slots_hwm is
# xsim-only: the in-flight-worm high-water mark)
CTR = (
    "flit_link_traversals", "buffer_writes", "buffer_reads",
    "xbar_traversals", "arbitrations", "ni_flits", "packets_finished",
    "slots_hwm",
)
_I = {name: i for i, name in enumerate(CTR)}

# table fields cycle_core reads
TABLE_FIELDS = (
    "enqueue", "lane", "num_stages", "flits", "link", "vcls", "lane_seq",
    "chl", "child_pid", "child_parent", "child_rs", "child_enq", "watch_link",
)
GEOM_FIELDS = ("node_ports", "cand_node", "cand_port")

_i8, _i16, _i32 = torch.int8, torch.int16, torch.int32


class CycleState(NamedTuple):
    fowner: torch.Tensor  # (B, L, W) int32
    fstage: torch.Tensor  # (B, L, W) int16
    fhead: torch.Tensor  # (B, L, W) int8
    fcount: torch.Tensor  # (B, L, W) int8
    fdvc: torch.Tensor  # (B, L, W) int8 — downstream VC the front worm's
    #                     header allocated at its next link
    freq: torch.Tensor  # (B, L, W) int32 — owner's next-hop link (-1 final)
    fkey: torch.Tensor  # (B, L, W) int32 — owner's age-key base (enq*P+pid)*F
    fcls: torch.Tensor  # (B, L, W) int8 — owner's VC class at the next hop
    ffin: torch.Tensor  # (B, L, W) bool — FIFO serves the owner's final stage
    fnf: torch.Tensor  # (B, L, W) int8 — owner's worm length
    lpid: torch.Tensor  # (B, 2NN) int32
    lsent: torch.Tensor  # (B, 2NN) int8
    lptr: torch.Tensor  # (B, 2NN) int32
    ldvc: torch.Tensor  # (B, 2NN) int8 — lane-front worm's VC at its first link
    crtime: torch.Tensor  # (B, C) int32, -1 = not yet releasable
    ctaken: torch.Tensor  # (B, C) bool
    lutil: torch.Tensor  # (B, E, L) int32 — per-epoch per-link flit traversals
    rconf: torch.Tensor  # (B, E, NN) int32 — per-epoch per-router conflicts
    inflight: torch.Tensor  # (B,) int32 — worms between lane-front and finish
    ctr: torch.Tensor  # (B, len(CTR)) int32


def init_planes(B: int, L: int, W: int, NN: int, C: int, E: int = 1, *,
                device: torch.device | str) -> CycleState:
    """Start-of-run planes for ``B`` instances on ``device``."""
    def full(shape, value, dtype):
        return torch.full((B, *shape), value, dtype=dtype, device=device)

    return CycleState(
        fowner=full((L, W), -1, _i32),
        fstage=full((L, W), 0, _i16),
        fhead=full((L, W), 0, _i8),
        fcount=full((L, W), 0, _i8),
        fdvc=full((L, W), 0, _i8),
        freq=full((L, W), -1, _i32),
        fkey=full((L, W), 0, _i32),
        fcls=full((L, W), 0, _i8),
        ffin=full((L, W), False, torch.bool),
        fnf=full((L, W), 1, _i8),
        lpid=full((2 * NN,), -1, _i32),
        lsent=full((2 * NN,), 0, _i8),
        lptr=full((2 * NN,), 0, _i32),
        ldvc=full((2 * NN,), 0, _i8),
        crtime=full((C,), -1, _i32),
        ctaken=full((C,), False, torch.bool),
        lutil=full((E, L), 0, _i32),
        rconf=full((E, NN), 0, _i32),
        inflight=full((), 0, _i32),
        ctr=full((len(CTR),), 0, _i32),
    )


def geometry_tensors(geom: dict, device: torch.device | str) -> dict:
    """The numpy router geometry of ``compile.geometry_tables`` as int32
    tensors on ``device`` (shared by every instance of a batch)."""
    return {
        f: torch.as_tensor(np.asarray(geom[f], np.int32), device=device)
        for f in GEOM_FIELDS
    }


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b, idx[b, ...]]`` for a (B, N) table and (B, ...) indices."""
    B = table.shape[0]
    flat = idx.reshape(B, -1).long()
    return torch.gather(table, 1, flat).reshape(idx.shape)


def _take2(table: torch.Tensor, i: torch.Tensor, j) -> torch.Tensor:
    """``table[b, i, j]`` for a (B, N, M) table (``j`` a tensor or int)."""
    B, _, M = table.shape
    return _take(table.reshape(B, -1), i * M + j)


def _clip(x: torch.Tensor, hi: int) -> torch.Tensor:
    return torch.clamp(x, 0, hi)


def cycle_core(state: CycleState, tb: dict, t: int, geom: dict, *,
               F: int, V: int, BD: int, L: int, NN: int,
               EPL: int = 1 << 30):
    """One wormhole cycle for every instance of the batch.

    ``tb`` holds the compiled-traffic tables (``(B, ...)`` int32 tensors),
    ``geom`` the router geometry from ``geometry_tensors``. Returns the new
    state plus the per-link arrival events ``(aval, apid, astage, afid)``,
    each ``(B, L)``, that the caller turns into delivery times.
    """
    (fowner, fstage, fhead, fcount, fdvc, freq, fkey, fcls, ffin, fnf, lpid,
     lsent, lptr, ldvc, crtime, ctaken, lutil, rconf, inflight, ctr) = state
    enqueue = tb["enqueue"]
    ns = tb["num_stages"]
    flits_t = tb["flits"]
    link_t = tb["link"]
    vcls_t = tb["vcls"]
    lane_seq = tb["lane_seq"]
    chl = tb["chl"]
    child_pid = tb["child_pid"]
    B, P, S = link_t.shape
    Q = lane_seq.shape[2]
    C = crtime.shape[1]
    W = 2 * V
    LW = L * W
    dev = fowner.device
    INF = NOC_INF
    node_ports = geom["node_ports"].long()  # (NN, 4W+2)
    cand_node = geom["cand_node"].long()  # (CAND+1,)
    cand_port = geom["cand_port"]
    crow_ids = torch.arange(C, dtype=_i32, device=dev)

    # ---- 1. NI lane refill ------------------------------------------------
    # root lanes (even): static (enqueue, pid) cursor; child lanes (odd):
    # dynamic (release-cycle, pid) priority — the host sim's queue order
    cand_root = torch.gather(
        lane_seq, 2, _clip(lptr, Q - 1).long()[..., None]
    )[..., 0]  # (B, 2NN)
    root_ok = (
        (lptr < Q) & (cand_root >= 0)
        & (_take(enqueue, _clip(cand_root, P - 1)) <= t)
    )
    released = (crtime >= 0) & (crtime <= t) & ~ctaken
    ckey = torch.where(released, crtime * C + crow_ids, INF)
    ktab = torch.where(chl >= 0, _take(ckey, _clip(chl, C - 1)), INF)
    cargm = torch.argmin(ktab, dim=2)  # (B, NN), first minimum
    child_ok = ktab.min(dim=2).values < INF
    crow = torch.gather(chl, 2, cargm[..., None])[..., 0]  # (B, NN)
    cpid = _take(child_pid, _clip(crow, C - 1))
    lane_cand = torch.stack(
        [cand_root.reshape(B, NN, 2)[..., 0], cpid], dim=2
    ).reshape(B, 2 * NN)
    lane_ok = torch.stack(
        [root_ok.reshape(B, NN, 2)[..., 0], child_ok], dim=2
    ).reshape(B, 2 * NN)
    need = (lpid < 0) | (
        lsent.to(_i32) >= _take(flits_t, _clip(lpid, P - 1))
    )
    got = need & lane_ok
    lpid = torch.where(got, lane_cand, torch.where(need, -1, lpid))
    lsent = torch.where(got, torch.zeros_like(lsent), lsent)
    is_root_lane = (torch.arange(2 * NN, device=dev) % 2) == 0
    lptr = lptr + (got & is_root_lane).to(_i32)
    got_child = got.reshape(B, NN, 2)[..., 1]  # (B, NN)
    cnode = _take(tb["lane"], _clip(child_pid, P - 1)) // 2  # (B, C)
    ctaken = ctaken | (_take(got_child, cnode) & (_take(crow, cnode) == crow_ids))
    inflight = inflight + got.sum(dim=1, dtype=_i32)
    ctr = ctr.clone()
    ctr[:, _I["slots_hwm"]] = torch.maximum(ctr[:, _I["slots_hwm"]], inflight)

    # ---- 2. link-round candidates (start-of-cycle admissibility) ----------
    fp = _clip(fowner, P - 1)
    occ = (fowner >= 0) & (fcount > 0)  # front flit present
    fs32 = fstage.to(_i32)
    fh32 = fhead.to(_i32)
    to_f = fs32 + 1
    req_f = torch.where(occ, freq, -1)  # (B, L, W); freq = -1 at final stage
    req_fc = _clip(req_f, L - 1)
    key_f = fkey + fh32
    cls_f = fcls.to(_i32)
    is_hdr_f = fh32 == 0
    freev = fowner < 0  # (B, L, W) start-of-cycle free VCs
    free_cls = torch.stack(
        [freev[..., :V].any(dim=2), freev[..., V:].any(dim=2)], dim=2
    )  # (B, L, 2)
    # first free VC per (link, class) — headers claim the lowest free one;
    # argmax of an all-false row is 0, as in jnp
    hvc_cls = torch.stack(
        [torch.argmax(freev[..., :V].to(_i32), dim=2),
         V + torch.argmax(freev[..., V:].to(_i32), dim=2)], dim=2
    ).to(_i32)  # (B, L, 2)
    hdr_ok_f = _take2(free_cls, req_fc, cls_f)
    hvc_f = _take2(hvc_cls, req_fc, cls_f)
    dv_f = fdvc.to(_i32)
    if BD >= F:  # a FIFO holds one worm: credit cannot run out
        body_ok_f = torch.ones_like(hdr_ok_f)
    else:
        body_ok_f = _take2(fcount, req_fc, dv_f).to(_i32) < BD
    adm_f = (req_f >= 0) & torch.where(is_hdr_f, hdr_ok_f, body_ok_f)
    tvc_f = torch.where(is_hdr_f, hvc_f, dv_f)

    # NI lane candidates: the front worm's next flit targets stage 0
    lp = _clip(lpid, P - 1)
    ls32 = lsent.to(_i32)
    lvalid = (lpid >= 0) & (ls32 < _take(flits_t, lp))
    req_l = torch.where(lvalid, _take2(link_t, lp, 0), -1)  # (B, 2NN)
    req_lc = _clip(req_l, L - 1)
    key_l = (_take(enqueue, lp) * P + lp) * F + ls32
    cls_l = _take2(vcls_t, lp, 0)
    is_hdr_l = ls32 == 0
    hdr_ok_l = _take2(free_cls, req_lc, cls_l)
    hvc_l = _take2(hvc_cls, req_lc, cls_l)
    dv_l = ldvc.to(_i32)
    if BD >= F:
        body_ok_l = torch.ones_like(hdr_ok_l)
    else:
        body_ok_l = _take2(fcount, req_lc, dv_l).to(_i32) < BD
    adm_l = lvalid & torch.where(is_hdr_l, hdr_ok_l, body_ok_l)
    tvc_l = torch.where(is_hdr_l, hvc_l, dv_l)

    # flatten candidates: FIFOs, lanes, one trailing dummy (pad target)
    def flat(vf, vl, fill):
        pad = torch.full((B, 1), fill, dtype=vf.dtype, device=dev)
        return torch.cat([vf.reshape(B, LW), vl, pad], dim=1)

    req = flat(req_f, req_l, -1)
    key = flat(key_f, key_l, INF)
    adm = flat(adm_f, adm_l, False)
    pid_c = flat(fp, lp, 0)
    to_c = flat(to_f, torch.zeros_like(req_l), 0)
    fid_c = flat(fh32, ls32, 0)
    tvc_c = flat(tvc_f, tvc_l, 0)

    # ---- 3. link arbitration: dense masked min over each node's ports -----
    req_np = req[:, node_ports]  # (B, NN, PORTS)
    key_np = key[:, node_ports]
    adm_np = adm[:, node_ports]
    D = L // NN  # output ports per router
    out_link = (
        torch.arange(NN, dtype=_i32, device=dev)[:, None] * D
        + torch.arange(D, dtype=_i32, device=dev)[None, :]
    )  # (NN, D) == link-id layout
    hits = req_np[:, :, None, :] == out_link[None, :, :, None]
    m = adm_np[:, :, None, :] & hits
    kk = torch.where(m, key_np[:, :, None, :], INF)  # (B, NN, D, PORTS)
    wport = torch.argmin(kk, dim=3)  # (B, NN, D), first minimum
    aval = (kk.min(dim=3).values < INF).reshape(B, L)  # winner per link
    wcand = node_ports[torch.arange(NN, device=dev)[None, :, None], wport]
    wcand = wcand.reshape(B, L)
    apid = _take(pid_c, wcand)
    astage = _take(to_c, wcand)
    afid = _take(fid_c, wcand)
    avc = _take(tvc_c, wcand)
    wport = wport.to(_i32).reshape(B, L)
    from_lane = (wport >= D * W) & aval
    # map winners back to candidates through the static inverse (gather)
    reqc = _clip(req, L - 1)
    won = (
        adm & (req >= 0) & _take(aval, reqc)
        & (_take(wport, reqc) == cand_port[None, :])
    )
    won_f = won[:, :LW].reshape(B, L, W)
    won_l = won[:, LW:LW + 2 * NN]

    # ---- 4. apply moves ---------------------------------------------------
    # a winning header pins the VC it was granted for its body flits
    fdvc = torch.where(won_f & is_hdr_f, tvc_f.to(_i8), fdvc)
    ldvc = torch.where(won_l & is_hdr_l, tvc_l.to(_i8), ldvc)
    dep_tail = won_f & (fhead == fnf - 1)
    fhead = fhead + won_f.to(_i8)
    fcount = fcount - won_f.to(_i8)
    fowner = torch.where(dep_tail, -1, fowner)
    lsent = lsent + won_l.to(_i8)
    arr1h = aval[..., None] & (
        avc[..., None] == torch.arange(W, dtype=_i32, device=dev)
    )  # (B, L, W)
    hdr1h = arr1h & (afid[..., None] == 0)
    fowner = torch.where(hdr1h, apid[..., None], fowner)
    fstage = torch.where(hdr1h, astage[..., None].to(_i16), fstage)
    fhead = torch.where(hdr1h, torch.zeros_like(fhead), fhead)
    fcount = fcount + arr1h.to(_i8)
    # cache the arriving worm's route lookups in the FIFO planes
    a_ns = _take(ns, apid)  # (B, L)
    nxt = astage + 1
    nxtc = _clip(nxt, S - 1)
    a_req = torch.where(nxt < a_ns, _take2(link_t, apid, nxtc), -1)
    a_cls = _take2(vcls_t, apid, nxtc)
    a_key = (_take(enqueue, apid) * P + apid) * F
    a_fin = astage == a_ns - 1
    a_nf = _take(flits_t, apid)  # the arriving worm's length
    freq = torch.where(hdr1h, a_req[..., None], freq)
    fkey = torch.where(hdr1h, a_key[..., None], fkey)
    fcls = torch.where(hdr1h, a_cls.to(_i8)[..., None], fcls)
    ffin = torch.where(hdr1h, a_fin[..., None], ffin)
    fnf = torch.where(hdr1h, a_nf.to(_i8)[..., None], fnf)

    # ---- 5. ejection (per node, post-move state) --------------------------
    ecand_f = (fowner >= 0) & (fcount > 0) & ffin
    ekey_f = fkey + fhead.to(_i32)
    ecand = flat(ecand_f, torch.zeros_like(req_l, dtype=torch.bool), False)
    ekey = flat(ekey_f, torch.zeros_like(req_l), INF)
    ek_np = torch.where(ecand[:, node_ports], ekey[:, node_ports], INF)
    eport = torch.argmin(ek_np, dim=2).to(_i32)  # (B, NN)
    ewin_n = ek_np.min(dim=2).values < INF
    ewon = (
        ecand & ewin_n[:, cand_node]
        & (eport[:, cand_node] == cand_port[None, :])
    )
    ewon_f = ewon[:, :LW].reshape(B, L, W)
    etail = ewon_f & (fhead == fnf - 1)
    fhead = fhead + ewon_f.to(_i8)
    fcount = fcount - ewon_f.to(_i8)
    fowner = torch.where(etail, -1, fowner)

    # ---- 6. DPM child release: watch the parent header's arrival ----------
    wlc = _clip(tb["watch_link"], L - 1)
    hit = (
        _take(aval, wlc) & (_take(apid, wlc) == tb["child_parent"])
        & (_take(astage, wlc) == tb["child_rs"]) & (_take(afid, wlc) == 0)
    )
    crtime = torch.where(
        (crtime < 0) & hit,
        torch.clamp(tb["child_enq"], min=t + 1),
        crtime,
    )

    # ---- 7. counters (same events the host sim counts) --------------------
    n_moves = aval.sum(dim=1, dtype=_i32)
    n_inj = from_lane.sum(dim=1, dtype=_i32)
    n_ej = ewon_f.sum(dim=(1, 2), dtype=_i32)
    finished = etail.sum(dim=(1, 2), dtype=_i32)
    inflight = inflight - finished
    ctr = ctr + torch.stack([
        n_moves, n_moves, n_moves - n_inj + n_ej, n_moves,
        (req >= 0).sum(dim=1, dtype=_i32), n_inj + n_ej, finished,
        torch.zeros_like(n_moves),
    ], dim=1)

    # ---- 8. telemetry planes (epoch-bucketed) -----------------------------
    # lutil decomposes flit_link_traversals per directed link; rconf counts
    # losing requests per router (admissible or not, host parity)
    E = lutil.shape[1]
    e = min(t // EPL, E - 1)
    nreq = hits.sum(dim=3, dtype=_i32)  # (B, NN, D)
    conf_n = torch.clamp(nreq - 1, min=0).sum(dim=2, dtype=_i32)  # (B, NN)
    lutil = lutil.clone()
    lutil[:, e] += aval.to(_i32)
    rconf = rconf.clone()
    rconf[:, e] += conf_n

    state = CycleState(fowner, fstage, fhead, fcount, fdvc, freq, fkey,
                       fcls, ffin, fnf, lpid, lsent, lptr, ldvc, crtime,
                       ctaken, lutil, rconf, inflight, ctr)
    return state, (aval, apid, astage, afid)


def run_cycles_ref(tb: dict, dslot: torch.Tensor, geom: dict, *, T: int,
                   F: int, V: int, BD: int, L: int, NN: int, ND: int,
                   EPL: int, E: int) -> tuple[CycleState, torch.Tensor]:
    """``T`` cycles of ``cycle_core`` from fresh planes, with the delivery
    record of the reference's ``ops.run_cycles``: a tail arrival at a
    delivery stage writes its cycle into ``dtime[dslot[pid, stage]]``; every
    other arrival slot writes into the discard slot ``ND``.

    Returns the final planes and ``dtime`` ``(B, ND + 1)``.
    """
    B, P, S = tb["link"].shape
    C = tb["child_parent"].shape[1]
    dev = dslot.device
    planes = init_planes(B, L, 2 * V, NN, C, E, device=dev)
    dtime = torch.full((B, ND + 1), -1, dtype=_i32, device=dev)
    for t in range(T):
        planes, (aval, apid, astage, afid) = cycle_core(
            planes, tb, t, geom, F=F, V=V, BD=BD, L=L, NN=NN, EPL=EPL
        )
        pc = _clip(apid, P - 1)
        tail = afid == _take(tb["flits"], pc) - 1
        ds = _take2(dslot, pc, _clip(astage, S - 1))  # -1 = not a delivery
        hit = aval & tail & (ds >= 0)
        slot = torch.where(hit, ds, ND).long()
        # every write of one cycle carries the same value t, so duplicate
        # writes into the discard slot are harmless
        dtime.scatter_(1, slot, torch.full_like(slot, t, dtype=_i32))
    return planes, dtime
