"""The port's trace replay (``repro_torch.noc.trace``) and the planning half
of its collective scheduler (``repro_torch.dist.multicast``) on the CPU
against ``repro``'s: every producer's trace byte for byte, the schedules
round for round, both replay drivers phase for phase (cycles, delivery
sets, link planes, stragglers, the timeline) and three rows of the
committed ``benchmarks/results/trace_replay.json``.

The replays run on a short drain grace: a phase's completion does not
depend on it once the phase drains, and both drivers raise when one does
not."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dist.multicast as jdist
import repro.noc as jnoc
import repro.noc.trace as jtrace
import repro_torch.core as tcore
import repro_torch.dist.multicast as tdist
import repro_torch.noc as tnoc
import repro_torch.noc.trace as ttrace
from repro.launch.specs import param_counts
from repro.models.config import RunConfig as JRunConfig

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "benchmarks" / "results" / "trace_replay.json"
GRACE = 150
FAULTS_4X4 = ((((1, 1), (1, 2)),), (((1, 1), (1, 2)), ((3, 0), (3, 1))))

# (id, producer name, args, kwargs that plan schedules)
PRODUCERS = [
    ("ep16", "ep_dispatch_trace", (16,), dict(chunk_bytes=96)),
    ("ep8_mu", "ep_dispatch_trace", (8,), dict(chunk_bytes=40, algo="MU")),
    ("zero1_16", "zero1_gather_trace", (16,), dict(param_bytes=4096)),
    ("zero1_8_mp", "zero1_gather_trace", (8,),
     dict(param_bytes=1000, algo="MP")),
    ("int8_16", "compressed_allreduce_trace", (16,), dict(grad_bytes=65536)),
    ("pipeline", "pipeline_trace", (4, 6), dict(activation_bytes=300)),
    ("coherence", "coherence_trace", (16,),
     dict(num_bursts=4, lines_per_burst=3, sharers=3, seed=1)),
    ("serving", "serving_trace", (16,),
     dict(num_requests=16, rate=0.02, seed=2)),
    ("mix_smollm", "model_collective_mix", ("smollm-135m", 16),
     dict(scale_to=256)),
]
PLANS_SCHEDULES = {"ep_dispatch_trace", "zero1_gather_trace",
                   "compressed_allreduce_trace", "model_collective_mix",
                   "from_hlo"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain cycle's many small ops run fastest on one thread, and the
    suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make(pkg, name, args, kw):
    if pkg is ttrace and name in PLANS_SCHEDULES:
        kw = dict(kw, device="cpu")
    return getattr(pkg, name)(*args, **kw)


@pytest.mark.parametrize("name,args,kw", [p[1:] for p in PRODUCERS],
                         ids=[p[0] for p in PRODUCERS])
def test_producer_trace_json_equals_reference(name, args, kw):
    ref = _make(jtrace, name, args, kw)
    got = _make(ttrace, name, args, kw)
    assert got.to_json() == ref.to_json()
    assert got.to_json(indent=1) == ref.to_json(indent=1)
    back = ttrace.Trace.from_json(got.to_json())
    assert back == got
    assert (got.num_events, got.total_bytes) == (ref.num_events,
                                                 ref.total_bytes)


def _compiled_hlo(with_collectives: bool) -> str:
    """Optimised HLO text of a 3-step scan; with collectives, each step runs
    psum, all_gather, psum_scatter and ppermute under a one-device
    shard_map (compiled HLO keeps them and the scan's trip count)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))

    def body(a):
        if not with_collectives:
            return jnp.tanh(a) * 2.0
        return (jax.lax.psum(a, "x") + jax.lax.all_gather(a, "x").sum(0)
                + jax.lax.psum_scatter(a, "x", tiled=True)
                + jax.lax.ppermute(a, "x", [(0, 0)]))

    def f(a):
        step = jax.shard_map(body, mesh=mesh, in_specs=P(), out_specs=P(),
                             check_vma=False)
        return jax.lax.scan(lambda c, _: (step(c), None), a, None,
                            length=3)[0]

    x = jnp.ones((64, 32), jnp.float32)
    return jax.jit(f).lower(x).compile().as_text()


def test_from_hlo_on_a_profile_and_its_refusal_of_text():
    """A profile equals the reference's; a profile, and HLO text, without
    collective bytes are refused as the reference refuses them."""
    prof = {"all-gather": 4.0e6, "reduce-scatter": 2.5e6,
            "all-to-all": 1.0e6, "collective-permute": 3.0e5,
            "all-reduce": 7.0e6, "send": 9.0}
    for kw in (dict(scale_to=300), dict(scale_to=None), dict(algo="MU",
                                                            scale_to=64)):
        ref = jtrace.from_hlo(prof, 8, "hlo8", **kw)
        got = ttrace.from_hlo(prof, 8, "hlo8", device="cpu", **kw)
        assert got.to_json() == ref.to_json()
    with pytest.raises(ValueError, match="no collective bytes"):
        ttrace.from_hlo({"send": 5.0}, 8, device="cpu")
    text = _compiled_hlo(with_collectives=False)
    with pytest.raises(ValueError, match="no collective bytes"):
        jtrace.from_hlo(text, 8)
    with pytest.raises(ValueError, match="no collective bytes"):
        ttrace.from_hlo(text, 8, device="cpu")


def test_from_hlo_on_hlo_text_equals_reference():
    """HLO text compiled by JAX: the port's copy of ``launch.hlo`` reads the
    reference's numbers (trip-counted collective bytes, flops, bytes), and
    ``from_hlo`` lowers the text to the reference's trace."""
    from repro.launch import hlo as jhlo
    from repro_torch.launch import hlo as thlo

    text = _compiled_hlo(with_collectives=True)
    coll = thlo.collective_bytes(text)
    assert coll == jhlo.collective_bytes(text)
    assert thlo.analyze(text) == jhlo.analyze(text)
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "collective-permute"):
        assert coll[kind] == 3 * 64 * 32 * 4  # three trips of a 8 KiB f32
    for kw in (dict(scale_to=256), dict(algo="MU", scale_to=None)):
        ref = jtrace.from_hlo(text, 8, "hlo_text", **kw)
        got = ttrace.from_hlo(text, 8, "hlo_text", device="cpu", **kw)
        assert got.to_json() == ref.to_json()


def test_model_collective_mix_counts_the_reference_parameters():
    """For each of the reference's ten configurations the parameter total
    of the port's meta-device init is the reference's and the mix equals the
    reference's; the MoE models' mixes add the expert-parallel all-to-all.
    An unknown configuration raises."""
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.models import RunConfig, count_params, model_init

    import repro.configs as jconfigs
    import torch

    assert sorted(ARCHS) == sorted(jconfigs.ARCHS)
    for arch in sorted(jconfigs.ARCHS):
        total = param_counts(jconfigs.get_arch(arch), JRunConfig())["total"]
        params, _ = model_init(0, get_arch(arch), RunConfig(),
                               device=torch.device("meta"))
        assert count_params(params) == total, arch
        got = ttrace.model_collective_mix(arch, 16, device="cpu")
        ref = jtrace.model_collective_mix(arch, 16)
        assert got.to_json() == ref.to_json(), arch
        assert got.meta["collectives"]["all-reduce"] == 2.0 * total
        assert ("all-to-all" in got.meta["collectives"]) == (
            get_arch(arch).moe is not None)
    with pytest.raises(KeyError, match="unknown arch"):
        ttrace.model_collective_mix("llama-7b", 16, device="cpu")


def _bcast_requests(n):
    return [((i, 0), [(j, 0) for j in range(n) if j != i]) for i in range(n)]


def _torus_requests(seed, k=12):
    rng = np.random.default_rng(seed)
    nodes = [(x, y) for y in range(4) for x in range(4)]
    out = []
    for _ in range(k):
        src = nodes[int(rng.integers(16))]
        others = [v for v in nodes if v != src]
        pick = rng.choice(len(others), size=int(rng.integers(1, 7)),
                          replace=False)
        out.append((src, [others[int(i)] for i in pick]))
    return out


SCHEDULES = [
    ("bcast_ring8", lambda m, d: m.schedule_multicasts(
        m.torus(8, 1), _bcast_requests(8), "DPM", **d)),
    ("bcast_ring16_mu", lambda m, d: m.schedule_multicasts(
        m.torus(16, 1), _bcast_requests(16), "MU", **d)),
    ("bcast_ring64", lambda m, d: m.schedule_multicasts(
        m.torus(64, 1), _bcast_requests(64), "DPM", **d)),
    ("alltoall8", lambda m, d: m.alltoall_schedule(8, **d)),
    ("alltoall16", lambda m, d: m.alltoall_schedule(16, **d)),
    ("alltoall64", lambda m, d: m.alltoall_schedule(64, **d)),
    ("alltoall16_nmp", lambda m, d: m.alltoall_schedule(16, "NMP", **d)),
    ("dp_broadcast16", lambda m, d: m.dp_broadcast_schedule(16, **d)),
    ("dp_broadcast8_contention", lambda m, d: m.dp_broadcast_schedule(
        8, "DPM", "contention", **d)),
    ("torus4x4", lambda m, d: m.schedule_multicasts(
        m.torus(4, 4), _torus_requests(3), "DPM", **d)),
    ("torus4x4_broken", lambda m, d: m.schedule_multicasts(
        m.torus(4, 4), _torus_requests(4), "DPM",
        broken_links=(((1, 1), (1, 2)), ((2, 3), (3, 3))), **d)),
    ("mesh4x4_broken_mp", lambda m, d: m.schedule_multicasts(
        m.make_topology("mesh", 4, 4), _torus_requests(5), "MP",
        broken_links=(((0, 1), (1, 1)),), **d)),
    ("ring_broadcast8", lambda m, d: m.ring_broadcast_schedule(8)),
    ("ring_alltoall16", lambda m, d: m.ring_alltoall_schedule(16)),
]


class _Ref:
    """The reference's scheduler with the topology factories beside it."""

    def __getattr__(self, name):
        if name in ("torus", "make_topology"):
            return getattr(jcore, name)
        return getattr(jdist, name)


class _Port:
    def __getattr__(self, name):
        if name in ("torus", "make_topology"):
            return getattr(tcore, name)
        return getattr(tdist, name)


@pytest.mark.parametrize("build", [s[1] for s in SCHEDULES],
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_equals_reference(build):
    ref = build(_Ref(), {})
    got = build(_Port(), {"device": "cpu"})
    assert got.num_ranks == ref.num_ranks
    assert got.rounds == ref.rounds
    assert got.hops == ref.hops
    assert got.round_reqs == ref.round_reqs
    assert (got.num_rounds, got.total_hops) == (ref.num_rounds,
                                                ref.total_hops)
    per_req = {r: 16 + 8 * (r % 5) for r in range(64)}
    for kw in ({}, {"req_payload_bytes": per_req}, {"alpha_us": 2.5}):
        assert got.cost(512, **kw) == ref.cost(512, **kw)


def test_alltoall_request_ids_and_torus_plans_match_reference():
    for n in (2, 5, 16):
        for rid in range(n * (n - 1)):
            src, dst = tdist._a2a_req(n, rid)
            assert (src, dst) == jdist._a2a_req(n, rid)
            assert tdist.a2a_req_id(n, src, dst) == rid
    broken = (((1, 1), (1, 2)),)
    for src, dests in _torus_requests(7, k=6):
        got = tdist.plan_torus_multicast(tcore.torus(4, 4), src, dests,
                                         broken_links=broken)
        ref = jdist.plan_torus_multicast(jcore.torus(4, 4), src, dests,
                                         broken_links=broken)
        assert [(p.hops, p.deliveries, p.parent) for p in got.paths] == [
            (p.hops, p.deliveries, p.parent) for p in ref.paths]
        assert tdist._relay_edges(got) == jdist._relay_edges(ref)
    assert tdist.alltoall_schedule(8, device="cpu") is tdist.alltoall_schedule(
        8, device="cpu")  # cached


def _assert_same_replay(got, ref):
    assert got.phase_names == ref.phase_names
    assert got.phase_cycles == ref.phase_cycles
    assert got.phase_deliveries == ref.phase_deliveries
    assert len(got.phase_link_util) == len(ref.phase_link_util)
    for a, b in zip(got.phase_link_util, ref.phase_link_util):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got.phase_stragglers == ref.phase_stragglers
    assert got.phase_faults == ref.phase_faults
    assert got.summary() == ref.summary()
    assert got.timeline() == ref.timeline()


# (id, producer, args, kwargs, algorithm, phase_broken_links)
REPLAYS = [
    ("ep8", "ep_dispatch_trace", (8,), dict(chunk_bytes=96), "DPM", None),
    ("zero1_8", "zero1_gather_trace", (8,), dict(param_bytes=1024), "DPM",
     None),
    ("int8_8_nmp", "compressed_allreduce_trace", (8,),
     dict(grad_bytes=4096), "NMP", None),
    ("pipeline_mu", "pipeline_trace", (4, 5), dict(activation_bytes=200),
     "MU", None),
    ("coherence", "coherence_trace", (16,),
     dict(num_bursts=2, lines_per_burst=3, sharers=3, seed=1), "DPM", None),
    ("serving_mp", "serving_trace", (16,),
     dict(num_requests=6, rate=0.05, max_batch=3, seed=2), "MP", None),
    ("ep8_link_dies", "ep_dispatch_trace", (8,), dict(chunk_bytes=64),
     "DPM", {"combine.r0": (((1, 1), (1, 2)),), 11: ()}),
]


@pytest.mark.parametrize("name,args,kw,algo,faults",
                         [r[1:] for r in REPLAYS], ids=[r[0] for r in REPLAYS])
def test_replay_drivers_equal_reference(name, args, kw, algo, faults):
    ref_tr = _make(jtrace, name, args, kw)
    tr = _make(ttrace, name, args, kw)
    jcfg = jnoc.NoCConfig(n=4, drain_grace=GRACE)
    cfg = tnoc.NoCConfig(n=4, drain_grace=GRACE)
    for drv in ("replay_host", "replay_xsim"):
        ref = getattr(jtrace, drv)(ref_tr, jcfg, algo,
                                   phase_broken_links=faults)
        got = getattr(ttrace, drv)(tr, cfg, algo, phase_broken_links=faults,
                                   device="cpu")
        assert (got.engine, got.algo, got.trace_name) == (
            ref.engine, ref.algo, ref.trace_name)
        _assert_same_replay(got, ref)
    if faults:
        assert got.phase_faults[6] is None  # dispatch.r6
        assert got.phase_faults[7] == (((1, 1), (1, 2)),)  # combine.r0
        assert got.phase_faults[10] == (((1, 1), (1, 2)),)
        assert got.phase_faults[11] == ()  # repaired


def test_phase_fault_keys_and_timeline_export(tmp_path):
    tr = ttrace.pipeline_trace(3, 3)
    with pytest.raises(KeyError, match="unknown phase"):
        ttrace.replay_host(tr, tnoc.NoCConfig(n=4),
                           phase_broken_links={"nope": ()}, device="cpu")
    with pytest.raises(IndexError, match="out of range"):
        ttrace.replay_xsim(tr, tnoc.NoCConfig(n=4),
                           phase_broken_links={9: ()}, device="cpu")
    with pytest.raises(ValueError, match="cannot embed"):
        ttrace.replay_host(ttrace.pipeline_trace(20, 2), tnoc.NoCConfig(n=4),
                           device="cpu")
    assert ttrace.flits_for_bytes(0) == 1
    assert ttrace.flits_for_bytes(17) == 2
    assert ttrace.flits_for_bytes(10**6) == ttrace.DEFAULT_MAX_FLITS
    with pytest.raises(ValueError, match="127"):
        ttrace.flits_for_bytes(8, max_flits=128)
    res = ttrace.replay_xsim(tr, tnoc.NoCConfig(n=4, drain_grace=100),
                             device="cpu")
    tl = ttrace.export_timeline(res, tmp_path / "tl.json")
    assert json.loads((tmp_path / "tl.json").read_text()) == tl
    assert res.xsim_results.dtime.shape[0] == len(tr.phases)


def _artifact():
    return json.loads(ARTIFACT.read_text())


@pytest.mark.parametrize("algo", ["MU", "MP", "NMP", "DPM"])
def test_trace_replay_artifact_coherence_row(algo):
    row = _artifact()["replays"]["coherence.n16.s1"]
    tr = ttrace.coherence_trace(16, num_bursts=4, lines_per_burst=3,
                                sharers=3, seed=1)
    assert (len(tr.phases), tr.num_events, len(tr.to_json())) == (
        row["phases"], row["events"], row["json_bytes"])
    h, x = ttrace.cross_validate(tr, tnoc.NoCConfig(n=4, drain_grace=200),
                                 algo, device="cpu")
    want = row["algos"][algo]
    assert (h.total_cycles, x.total_cycles, h.phase_cycles) == (
        want["total_cycles_host"], want["total_cycles_xsim"],
        want["phase_cycles"])


def test_trace_replay_artifact_schedule_comparison_row():
    want = _artifact()["schedule_comparison"]
    ep = ttrace.ep_dispatch_trace(16, chunk_bytes=96, device="cpu")
    ring = ttrace.from_schedule(
        tdist.ring_alltoall_schedule(16), "ep_alltoall.n16.ring",
        ep.meta["chunk_bytes"], phase_prefix="shift.r",
    )
    ring2 = ttrace.Trace(ring.name, ring.num_ranks, ring.phases + ring.phases,
                         {"kind": "ep_alltoall_ring"})
    h, x = ttrace.cross_validate(ring2, tnoc.NoCConfig(n=4, drain_grace=200),
                                 "DPM", device="cpu")
    assert h.total_cycles == want["ring_schedule_cycles"]
    assert x.total_cycles == want["ring_schedule_cycles_xsim"]
    assert (len(ep.phases), len(ring2.phases)) == (want["dpm_rounds"],
                                                   want["ring_rounds"])


@pytest.mark.parametrize("rung", [0, 1])
def test_trace_replay_artifact_zero1_fault_row(rung):
    want = _artifact()["fault_ladder"]["zero1_gather.n16.DPM"][rung]
    links = FAULTS_4X4[rung]
    tr = ttrace.zero1_gather_trace(16, param_bytes=4096, device="cpu")
    cfg = tnoc.NoCConfig(n=4, topology="mesh", broken_links=links,
                         drain_grace=200)
    h, x = ttrace.cross_validate(tr, cfg, "DPM", device="cpu")
    assert want["broken_links"] == len(links)
    assert (h.total_cycles, x.total_cycles) == (want["total_cycles_host"],
                                                want["total_cycles_xsim"])
