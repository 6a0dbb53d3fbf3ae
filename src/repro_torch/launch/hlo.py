"""Trip-count-aware cost analysis over compiled HLO text. Twin of
``repro.launch.hlo``, copied (pure Python): the port's ``noc.trace.from_hlo``
reads HLO text through ``collective_bytes``.

XLA's ``compiled.cost_analysis()`` counts a while-loop (lax.scan) body ONCE,
which silently undercounts scanned-layer models by the layer count (verified
in tests/test_launch.py). This module re-derives the three roofline inputs
from the optimized HLO itself:

* computations are parsed into blocks and walked from ENTRY; a while op
  multiplies its body+condition cost by ``known_trip_count`` (emitted by XLA
  in backend_config), fusions add their called computation's flops but only
  the fusion call's operand/result bytes (fused kernels touch HBM once);
* dot flops = 2 x prod(result dims) x prod(contracting dims), elementwise
  and reduce ops count one flop per output element;
* collective bytes (all-gather / all-reduce / reduce-scatter / all-to-all /
  collective-permute) are operand bytes x enclosing trip counts — the
  quantity cost_analysis does not report at all.
"""
from __future__ import annotations

import json
import re
from collections import defaultdict
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8, "c128": 16,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e5m2fnuz": 1,
    "s8": 1, "u8": 1, "pred": 1, "s4": 1, "u4": 1,
}

_TYPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
_FREE_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "opt-barrier", "partition-id", "replica-id", "iota",
}

_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^)]*\)|[\w\[\],{}]+)+)\s+"
    r"([\w\-]+)\((.*)$"
)
# computation headers sit at column 0: `%name (args) -> type {` — args/types
# may contain nested parens (tuples), so match greedily to the trailing `{`
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->\s*.+\{\s*$")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLS_RE = re.compile(r"(?:calls|to_apply|body)=%?([\w.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_LHS_C_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")


_REF_RE = re.compile(r"%([\w.\-]+)")


def _operand_names(rest: str) -> list[str]:
    """Operand references of an op line.

    ``rest`` starts immediately after the op's opening paren; operands are
    ``type %name`` entries (types may themselves contain commas and tuple
    parens), so splitting on commas corrupts the names — instead cut at the
    matching close paren and take the ``%name`` references, which excludes
    trailing attrs like ``calls=%...`` / ``body=%...``.
    """
    depth = 1
    seg = rest
    for i, ch in enumerate(rest):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                seg = rest[:i]
                break
    return _REF_RE.findall(seg)


def _shapes(type_str: str) -> list[tuple[str, list[int]]]:
    out = []
    for dt, dims in _TYPE_RE.findall(type_str):
        out.append((dt, [int(d) for d in dims.split(",") if d]))
    return out


def _bytes_of(type_str: str) -> int:
    total = 0
    for dt, dims in _shapes(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class _Op:
    name: str
    kind: str
    result_type: str
    rest: str  # operand list + attrs


@dataclass
class _Comp:
    name: str
    ops: list = field(default_factory=list)

    def param_slice_bytes(self, defs) -> dict[int, int]:
        """For fused computations: parameters consumed by interior
        dynamic-slice/dynamic-update-slice ops are NOT streamed in full —
        map param index -> effective bytes (slice size), mirroring XLA's
        HloCostAnalysis special cases. Layout-only chains
        (bitcast/reshape/transpose/copy) between the parameter and the
        slice op are traced through."""
        params: dict[str, int] = {}
        for op in self.ops:
            if op.kind == "parameter":
                m = re.match(r"\s*(\d+)", op.rest)
                if m:
                    params[op.name] = int(m.group(1))
        # origin[n] = param index if n derives from a parameter via
        # layout-only ops
        origin: dict[str, int] = dict(params)
        passthrough = {"bitcast", "reshape", "transpose", "copy", "convert"}
        for op in self.ops:
            if op.kind in passthrough:
                ops_in = _operand_names(op.rest)
                if ops_in and ops_in[0] in origin:
                    origin[op.name] = origin[ops_in[0]]
        out: dict[int, int] = {}
        for op in self.ops:
            operands = _operand_names(op.rest)
            if op.kind == "dynamic-slice" and operands and operands[0] in origin:
                out[origin[operands[0]]] = _bytes_of(op.result_type)
            if (
                op.kind == "dynamic-update-slice"
                and operands
                and operands[0] in origin
                and len(operands) > 1
            ):
                upd = defs.get(operands[1], "")
                if not upd:
                    # interior update operand: look it up locally
                    for o2 in self.ops:
                        if o2.name == operands[1]:
                            upd = o2.result_type
                            break
                out[origin[operands[0]]] = 2 * _bytes_of(upd)
        return out


def _parse(hlo_text: str) -> tuple[dict, str]:
    comps: dict[str, _Comp] = {}
    entry = None
    cur: _Comp | None = None
    for line in hlo_text.splitlines():
        mc = _COMP_RE.match(line)
        if mc and ("->" in line):
            cur = _Comp(mc.group(1))
            comps[cur.name] = cur
            if line.startswith("ENTRY"):
                entry = cur.name
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        mo = _OP_RE.match(line)
        if not mo:
            continue
        name, rtype, kind, rest = mo.groups()
        cur.ops.append(_Op(name, kind, rtype, rest))
    if entry is None and comps:
        entry = next(iter(comps))
    return comps, entry


def _dot_flops(op: _Op, defs: dict[str, str]) -> float:
    """2 x prod(result) x prod(contracting dims of lhs)."""
    res = _shapes(op.result_type)
    out_elems = 1
    for _, dims in res:
        for d in dims:
            out_elems *= d
    operands = _operand_names(op.rest)
    lhs_type = defs.get(operands[0], "") if operands else ""
    lhs_shapes = _shapes(lhs_type)
    contract = 1
    m = _LHS_C_RE.search(op.rest)
    if m and lhs_shapes:
        dims = lhs_shapes[0][1]
        for idx in m.group(1).split(","):
            if idx and int(idx) < len(dims):
                contract *= dims[int(idx)]
    return 2.0 * out_elems * contract


def analyze(hlo_text: str) -> dict:
    comps, entry = _parse(hlo_text)
    # map op name -> result type (for operand byte lookups), global
    defs: dict[str, str] = {}
    for c in comps.values():
        for op in c.ops:
            defs[op.name] = op.result_type

    memo: dict[str, dict] = {}

    def cost_of(cname: str) -> dict:
        if cname in memo:
            return memo[cname]
        acc = {"flops": 0.0, "bytes": 0.0, "coll": defaultdict(float),
               "coll_count": 0.0, "by_kind": defaultdict(float)}
        memo[cname] = acc  # guards recursion
        comp = comps.get(cname)
        if comp is None:
            return acc
        for op in comp.ops:
            kind = op.kind
            if kind in _FREE_OPS:
                continue
            out_b = _bytes_of(op.result_type)
            operand_names = _operand_names(op.rest)
            slice_map: dict[int, int] = {}
            if kind == "fusion":
                m0 = _CALLS_RE.search(op.rest)
                if m0 and m0.group(1) in comps:
                    sub = comps[m0.group(1)]
                    slice_map = sub.param_slice_bytes(defs)
                    # fusion rooted in a dynamic-update-slice writes in
                    # place: the full-buffer output is aliased, only the
                    # update region is written (already counted 2x in the
                    # slice map), so drop the output bytes
                    if any(
                        o2.kind == "dynamic-update-slice" for o2 in sub.ops
                    ) and any(
                        i in slice_map
                        and defs.get(t, "")
                        and _bytes_of(defs[t]) == out_b
                        for i, t in enumerate(operand_names)
                    ):
                        out_b = 0
            opnd_b = 0
            for i, token in enumerate(operand_names):
                if token in defs:
                    opnd_b += slice_map.get(i, _bytes_of(defs[token]))
            if kind == "dynamic-slice":
                opnd_b = out_b  # reads only the slice
            elif kind == "dynamic-update-slice" and len(operand_names) > 1:
                upd = defs.get(operand_names[1], "")
                opnd_b = 2 * _bytes_of(upd)
                out_b = 0  # in-place; write already counted
            base_kind = kind.replace("-start", "").replace("-done", "")
            if base_kind in COLLECTIVE_OPS:
                if kind.endswith("-done"):
                    continue
                acc["coll"][base_kind] += opnd_b or out_b
                acc["coll_count"] += 1
                acc["bytes"] += opnd_b + out_b
                continue
            if kind == "while":
                m = _TRIP_RE.search(op.rest)
                trips = int(m.group(1)) if m else 1
                body = _CALLS_RE.search(op.rest)
                cond = _COND_RE.search(op.rest)
                for sub, mult in ((body, trips), (cond, trips + 1)):
                    if sub:
                        c = cost_of(sub.group(1))
                        acc["flops"] += mult * c["flops"]
                        acc["bytes"] += mult * c["bytes"]
                        for k, v in c["coll"].items():
                            acc["coll"][k] += mult * v
                        acc["coll_count"] += mult * c["coll_count"]
                        for k, v in c["by_kind"].items():
                            acc["by_kind"][k] += mult * v
                continue
            if kind == "conditional":
                m = _BRANCHES_RE.search(op.rest)
                if m:
                    subs = [s.strip().lstrip("%") for s in m.group(1).split(",")]
                    costs = [cost_of(s) for s in subs]
                    if costs:
                        best = max(costs, key=lambda c: c["flops"] + c["bytes"])
                        for k in ("flops", "bytes", "coll_count"):
                            acc[k] += best[k]
                        for k, v in best["coll"].items():
                            acc["coll"][k] += v
                continue
            if kind in ("fusion", "call", "custom-call", "map", "reduce",
                        "reduce-window", "scatter", "sort", "select-and-scatter"):
                acc["bytes"] += opnd_b + out_b
                acc["by_kind"][kind] += opnd_b + out_b
                m = _CALLS_RE.search(op.rest)
                if m:
                    c = cost_of(m.group(1))
                    acc["flops"] += c["flops"]
                    # fused internals do not re-touch HBM: bytes excluded,
                    # but nested collectives/whiles inside calls must count
                    for k, v in c["coll"].items():
                        acc["coll"][k] += v
                    acc["coll_count"] += c["coll_count"]
                    if kind == "call":
                        acc["bytes"] += c["bytes"]
                continue
            if kind == "dot" or kind == "convolution":
                acc["flops"] += _dot_flops(op, defs)
                acc["bytes"] += opnd_b + out_b
                acc["by_kind"][kind] += opnd_b + out_b
                continue
            # generic elementwise / data movement: 1 flop per output element
            out_elems = 0
            for _, dims in _shapes(op.result_type):
                n = 1
                for d in dims:
                    n *= d
                out_elems += n
            acc["flops"] += out_elems
            acc["bytes"] += opnd_b + out_b
            acc["by_kind"][kind] += opnd_b + out_b
        return acc

    total = cost_of(entry)
    coll = dict(total["coll"])
    coll["total"] = sum(coll.values())
    coll["count"] = total["coll_count"]

    # per-while attribution (uses the SAME accounting): trips x body cost
    whiles = []
    for c in comps.values():
        for op in c.ops:
            if op.kind != "while":
                continue
            m = _TRIP_RE.search(op.rest)
            trips = int(m.group(1)) if m else 1
            body = _CALLS_RE.search(op.rest)
            if not body:
                continue
            bc = cost_of(body.group(1))
            whiles.append(
                {
                    "body": body.group(1)[:60],
                    "trips": trips,
                    "bytes_total": trips * bc["bytes"],
                    "flops_total": trips * bc["flops"],
                }
            )
    whiles.sort(key=lambda w: -w["bytes_total"])
    return {
        "flops": total["flops"],
        "bytes": total["bytes"],
        "collectives": coll,
        "bytes_by_kind": dict(
            sorted(total["by_kind"].items(), key=lambda kv: -kv[1])
        ),
        "whiles": whiles[:8],
    }


def collective_bytes(hlo_text: str) -> dict:
    """Back-compat helper: trip-count-aware collective bytes only."""
    return analyze(hlo_text)["collectives"]
