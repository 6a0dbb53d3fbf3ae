"""Core contribution of the paper: dynamic partition merging multicast.

Twin of ``repro.core``, with the same public names minus the batched
planner (``batch_planner``) and the 3-D/chiplet topologies (``topo3d``),
which come with later slices of the port.

Public API:
    MeshGrid, grid                         — mesh geometry + Hamiltonian labels
    Torus, torus, make_topology, Topology  — wraparound torus + the protocol
    basic_partitions, dpm_partition        — Definitions 1-3 + Algorithm 1
    plan / PLANNERS                        — cached planning facade + legacy view
    RoutingAlgorithm, register_algorithm,  — pluggable algorithm registry
    available_algorithms, get_algorithm
    CostModel, register_cost_model,        — pluggable routing objectives:
    get_cost_model, available_cost_models    hops / contention / energy

Every planner and routing function takes any Topology (mesh or torus).
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
    "Coord",
    "CostModel",
    "DPMResult",
    "DisconnectedError",
    "EnergyCost",
    "FaultAwareProvider",
    "FaultyTopology",
    "HopCountCost",
    "LinkContentionCost",
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
    "WeightedLinkCost",
    "available_algorithms",
    "available_cost_models",
    "basic_partitions",
    "brute_force_partition",
    "candidate_cost",
    "candidate_ids_for",
    "canonical_dests",
    "dpm_partition",
    "dual_path_cost",
    "faulty",
    "get_algorithm",
    "get_cost_model",
    "greedy_tour",
    "grid",
    "label_route",
    "make_topology",
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
    "unregister_algorithm",
    "unregister_cost_model",
    "wedge_patterns",
    "xy_route",
]
