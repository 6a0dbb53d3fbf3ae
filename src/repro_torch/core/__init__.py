"""Core contribution of the paper: dynamic partition merging multicast.

Twin of ``repro.core``, with the same public names.

Public API:
    MeshGrid, grid                         — mesh geometry + Hamiltonian labels
    Torus, torus, make_topology, Topology  — wraparound torus + the protocol
    Mesh3D, Torus3D, ChipletPackage,       — 3-D fabrics and chiplet packages
    mesh3d, torus3d, chiplet
    basic_partitions, dpm_partition        — Definitions 1-3 + Algorithm 1
    plan / PLANNERS                        — cached planning facade + legacy view
    bulk_plan, BatchPlanner, planner_for   — batched planning on the card
                                             behind the canonical plan arena
    RoutingAlgorithm, register_algorithm,  — pluggable algorithm registry
    available_algorithms, get_algorithm
    CostModel, register_cost_model,        — pluggable routing objectives:
    get_cost_model, available_cost_models    hops / contention / energy

Every planner and routing function takes any registered Topology (mesh,
torus, mesh3d, torus3d, chiplet).
``faulty(topo, broken_links)`` degrades any topology and every planner
detours around the broken links automatically.
"""
from .algo import (
    CostModel,
    EnergyCost,
    HopCountCost,
    LinkContentionCost,
    RoutingAlgorithm,
    WeightedLinkCost,
    available_algorithms,
    available_cost_models,
    get_algorithm,
    get_cost_model,
    register_algorithm,
    register_cost_model,
    temporary_algorithm,
    unregister_algorithm,
    unregister_cost_model,
)
from .batch_planner import (
    ArenaCacheInfo,
    ArenaInfo,
    BatchPlanner,
    arena_clear,
    arena_info,
    batch_support,
    bulk_plan,
    label_chain_matrices,
    planner_for,
)
from .grid import Coord, MeshGrid, grid
from .partition import (
    ALL_CANDIDATE_IDS,
    DPMResult,
    PartitionCost,
    basic_partitions,
    brute_force_partition,
    candidate_cost,
    candidate_ids_for,
    dpm_partition,
    representative,
    wedge_patterns,
)
from .planner import (
    PLANNERS,
    MulticastPlan,
    PacketPath,
    canonical_dests,
    plan,
    plan_cache_clear,
    plan_cache_info,
    plan_dp,
    plan_dpm,
    plan_dpm_e,
    plan_mp,
    plan_mu,
    plan_nmp,
    segment_plan_for_faults,
)
from .routefn import (
    DisconnectedError,
    FaultAwareProvider,
    FaultyTopology,
    MinimalRouteProvider,
    RouteProvider,
    faulty,
    provider_for,
    route_cost_matrices,
    router_failure,
)
from .routing import (
    dual_path_cost,
    greedy_tour,
    label_route,
    multi_unicast_cost,
    path_multicast,
    xy_route,
)
from .topo3d import (
    ChipletPackage,
    Mesh3D,
    Torus3D,
    chiplet,
    mesh3d,
    torus3d,
)
from .topology import (
    Topology,
    Torus,
    make_topology,
    register_topology,
    registered_topology_kinds,
    ring_delta,
    torus,
)

__all__ = [
    "ALL_CANDIDATE_IDS",
    "ArenaCacheInfo",
    "ArenaInfo",
    "BatchPlanner",
    "ChipletPackage",
    "Coord",
    "CostModel",
    "DPMResult",
    "DisconnectedError",
    "EnergyCost",
    "FaultAwareProvider",
    "FaultyTopology",
    "HopCountCost",
    "LinkContentionCost",
    "Mesh3D",
    "MeshGrid",
    "MinimalRouteProvider",
    "MulticastPlan",
    "PLANNERS",
    "PacketPath",
    "PartitionCost",
    "RouteProvider",
    "RoutingAlgorithm",
    "Topology",
    "Torus",
    "Torus3D",
    "WeightedLinkCost",
    "arena_clear",
    "arena_info",
    "available_algorithms",
    "available_cost_models",
    "basic_partitions",
    "batch_support",
    "brute_force_partition",
    "bulk_plan",
    "candidate_cost",
    "candidate_ids_for",
    "canonical_dests",
    "chiplet",
    "dpm_partition",
    "dual_path_cost",
    "faulty",
    "get_algorithm",
    "get_cost_model",
    "greedy_tour",
    "grid",
    "label_chain_matrices",
    "label_route",
    "make_topology",
    "mesh3d",
    "multi_unicast_cost",
    "path_multicast",
    "plan",
    "plan_cache_clear",
    "plan_cache_info",
    "plan_dp",
    "plan_dpm",
    "plan_dpm_e",
    "plan_mp",
    "plan_mu",
    "plan_nmp",
    "planner_for",
    "provider_for",
    "register_algorithm",
    "register_cost_model",
    "register_topology",
    "registered_topology_kinds",
    "representative",
    "ring_delta",
    "route_cost_matrices",
    "router_failure",
    "segment_plan_for_faults",
    "temporary_algorithm",
    "torus",
    "torus3d",
    "unregister_algorithm",
    "unregister_cost_model",
    "wedge_patterns",
    "xy_route",
]
