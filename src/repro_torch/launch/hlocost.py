"""Trip-count-aware HLO cost model (the reference's ``launch/hlocost.py``,
copied as it is: plain ``re``, ``json`` and ``dataclasses``).

The reference prices XLA's optimized HLO, in which every while op carries
``backend_config={"known_trip_count":{"n":...}}``; this module re-derives
the HloCostAnalysis quantities from the HLO text with loop bodies scaled by
their trip counts (nesting multiplies):

  flops             dot: 2·|out|·|contracted|; elementwise: |out|; reduce: |in|
  bytes accessed    Σ per instruction (operands + output), fusion computations
                    priced at their boundary only (interior tensors are fused)
  collective bytes  Σ operand payloads of all-gather / all-reduce /
                    reduce-scatter / all-to-all / collective-permute, by kind,
                    each scaled by its enclosing trip multiplier

The parser handles the post-SPMD per-device module, so totals are
per-device. The port has no HLO: ``validation/opcount.trace_cost`` fills
the same :class:`CostSummary` from one traced call of the port (its FLOPs
and bytes, and the collectives ``parallel/dist.py`` issues by kind).
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Iterable

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "s4": 1, "u4": 1, "pred": 1, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(
    r"(f64|f32|f16|bf16|f8e4m3fn|f8e5m2|s64|u64|s32|u32|s16|u16|s8|u8|s4|u4|"
    r"pred|c64|c128)\[([0-9,]*)\]")

# ops that cost ~1 flop per output element
_ELEMENTWISE = {
    "add", "subtract", "multiply", "divide", "power", "maximum", "minimum",
    "exponential", "exponential-minus-one", "log", "log-plus-one", "rsqrt",
    "sqrt", "cbrt", "tanh", "negate", "abs", "cosine", "sine", "tan",
    "floor", "ceil", "round-nearest-afz", "round-nearest-even", "sign",
    "atan2", "remainder", "logistic", "erf", "clamp", "select",
    "shift-left", "shift-right-arithmetic", "shift-right-logical",
    "and", "or", "xor", "not", "is-finite",
}

# ops that move bytes but do no arithmetic
_ZERO_BYTES = {"parameter", "constant", "tuple", "get-tuple-element",
               "bitcast", "after-all", "add-dependency", "partition-id",
               "replica-id", "opt-barrier"}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class Instruction:
    name: str
    opcode: str
    shape: str                     # raw result type text (may be a tuple)
    operands: list[str]
    attrs: str                     # raw attribute tail

    def result_bytes(self) -> float:
        return sum(_type_bytes(m) for m in _SHAPE_RE.finditer(self.shape))

    def result_elems(self) -> float:
        tot = 0
        for m in _SHAPE_RE.finditer(self.shape):
            tot += _shape_elems(m)
        return tot


@dataclasses.dataclass
class Computation:
    name: str
    instructions: list[Instruction]
    by_name: dict


@dataclasses.dataclass
class CollectiveRecord:
    kind: str
    bytes_: float                 # payload per execution (operand bytes)
    trips: float                  # total executions (loop multiplier)
    shape: str
    participants: int = 1         # group size S (from replica_groups)

    @property
    def total_bytes(self) -> float:
        return self.bytes_ * self.trips

    @property
    def link_bytes(self) -> float:
        """Per-chip link traffic of one execution (ring-algorithm terms):
        AG: s·(S-1)   RS/A2A: n·(S-1)/S   AR: 2n·(S-1)/S   permute: n."""
        s = max(self.participants, 1)
        if s == 1:
            return 0.0 if self.kind != "collective-permute" else self.bytes_
        if self.kind == "all-gather":
            return self.bytes_ * (s - 1)
        if self.kind == "all-reduce":
            return 2.0 * self.bytes_ * (s - 1) / s
        if self.kind in ("reduce-scatter", "all-to-all"):
            return self.bytes_ * (s - 1) / s
        return self.bytes_  # collective-permute

    @property
    def total_link_bytes(self) -> float:
        return self.link_bytes * self.trips


@dataclasses.dataclass
class CostSummary:
    flops: float
    bytes_accessed: float
    collective_bytes: dict               # kind -> total bytes
    collectives: list[CollectiveRecord]  # the collective schedule
    while_trip_counts: list[int]
    bytes_by_opcode: dict = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def link_traffic_bytes(self) -> float:
        """Per-chip link traffic across all collectives (ring terms)."""
        return sum(r.total_link_bytes for r in self.collectives)

    def row(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": dict(self.collective_bytes),
            "n_collectives": len(self.collectives),
            "while_trip_counts": self.while_trip_counts,
        }


def _type_bytes(m: re.Match) -> float:
    return _shape_elems(m) * _DTYPE_BYTES[m.group(1)]


def _shape_elems(m: re.Match) -> float:
    dims = m.group(2)
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n


def _shape_dims(text: str) -> list[int]:
    m = _SHAPE_RE.search(text)
    if not m or not m.group(2):
        return []
    return [int(d) for d in m.group(2).split(",")]


# ------------------------------ parsing --------------------------------------
_COMP_HEAD = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{\s*$")
_INST = re.compile(
    r"^(ROOT\s+)?%?([\w.\-]+)\s*=\s*(\(.*?\)|[\w\[\]{},\s/*]+?)\s+"
    r"([\w\-]+)\((.*)$")
_OPERAND = re.compile(r"%([\w.\-]+)")


def parse_hlo(text: str) -> tuple[dict, str]:
    """Parse optimized HLO text → ({name: Computation}, entry_name)."""
    comps: dict[str, Computation] = {}
    entry = None
    cur: Computation | None = None
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line:
            continue
        if not line[0].isspace():
            m = _COMP_HEAD.match(line)
            if m:
                cur = Computation(m.group(2), [], {})
                comps[cur.name] = cur
                if m.group(1):
                    entry = cur.name
            elif line.startswith("}"):
                cur = None
            continue
        s = line.strip()
        if s.startswith("}") or cur is None:
            if s.startswith("}"):
                cur = None
            continue
        mi = _INST.match(s)
        if not mi:
            continue
        _, name, rtype, opcode, rest = mi.groups()
        # split operand list from the attribute tail at the closing paren
        depth, end = 1, len(rest)
        for i, ch in enumerate(rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        operand_str = rest[:end]
        attrs = rest[end + 1:]
        operands = _OPERAND.findall(operand_str)
        inst = Instruction(name, opcode, rtype.strip(), operands, attrs)
        cur.instructions.append(inst)
        cur.by_name[name] = inst
    if entry is None:  # fall back: the computation named like the module
        entry = next(iter(comps))
    return comps, entry


# ------------------------------ cost model -----------------------------------
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
# fusions annotate their body as ``calls=%comp``; plain call instructions
# use ``to_apply=%comp`` on some XLA versions (e.g. the CPU backend's
# parallel-task wrapper in the jax 0.4.x line) and ``calls=`` on others —
# resolve both, or every call body prices as zero
_CALLS_RE = re.compile(r"(?:calls|to_apply)=%?([\w.\-]+)")
_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_LHS_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")


def _participants(attrs: str) -> int:
    m = _GROUPS_IOTA_RE.search(attrs)
    if m:  # [num_groups, group_size]<=[...]
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(attrs)
    if m:
        return m.group(1).count(",") + 1
    return 1


def _operand_shape(comp: Computation, comps: dict, name: str) -> str:
    inst = comp.by_name.get(name)
    return inst.shape if inst is not None else ""


def _dot_flops(inst: Instruction, comp: Computation) -> float:
    out_elems = inst.result_elems()
    mc = _LHS_CONTRACT_RE.search(inst.attrs)
    contracted = 1
    if mc and inst.operands:
        lhs_shape = _shape_dims(_operand_shape(comp, {}, inst.operands[0]))
        dims = [int(x) for x in mc.group(1).split(",") if x]
        for d in dims:
            if d < len(lhs_shape):
                contracted *= lhs_shape[d]
    return 2.0 * out_elems * contracted


def _conv_flops(inst: Instruction, comp: Computation) -> float:
    # flops ≈ 2 · |out| · (kernel elems / out_channels)
    out = inst.result_elems()
    if len(inst.operands) >= 2:
        k = _shape_dims(_operand_shape(comp, {}, inst.operands[1]))
        if k:
            import numpy as _np
            kelems = 1
            for d in k:
                kelems *= d
            return 2.0 * out * kelems / max(k[-1], 1)
    return 2.0 * out


class HloCost:
    """Walks the computation graph, scaling loop bodies by trip count."""

    def __init__(self, comps: dict, entry: str):
        self.comps = comps
        self.entry = entry
        self._memo: dict[str, tuple[float, float]] = {}
        self.collectives: list[CollectiveRecord] = []
        self.trip_counts: list[int] = []
        self.bytes_by_opcode: dict[str, float] = {}

    def run(self) -> CostSummary:
        flops, bytes_ = self._comp_cost(self.entry, 1.0, count_bytes=True)
        coll: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        for rec in self.collectives:
            coll[rec.kind] += rec.total_link_bytes  # per-chip link traffic
        top = dict(sorted(self.bytes_by_opcode.items(),
                          key=lambda kv: -kv[1])[:12])
        return CostSummary(flops, bytes_, coll, self.collectives,
                           self.trip_counts, top)

    # NOTE: collectives are recorded with their multiplier at visit time, so
    # computations reached under different multipliers must not be memoized
    # when they contain collectives / nested loops. We memoize only pure
    # fusion computations (no calls, no collectives).
    def _comp_cost(self, name: str, mult: float,
                   count_bytes: bool) -> tuple[float, float]:
        comp = self.comps.get(name)
        if comp is None:
            return 0.0, 0.0
        flops = 0.0
        bytes_ = 0.0
        for inst in comp.instructions:
            f, b = self._inst_cost(inst, comp, mult, count_bytes)
            flops += f
            bytes_ += b
        return flops, bytes_

    def _pure_key(self, name: str) -> str | None:
        comp = self.comps.get(name)
        if comp is None:
            return None
        for inst in comp.instructions:
            if inst.opcode in ("while", "fusion", "call", "conditional",
                               "custom-call") or inst.opcode.startswith(
                                   tuple(_COLLECTIVES)):
                return None
        return name

    def _inst_cost(self, inst: Instruction, comp: Computation, mult: float,
                   count_bytes: bool) -> tuple[float, float]:
        op = inst.opcode
        # ---- control flow ----------------------------------------------------
        if op == "while":
            trip = 1
            mt = _TRIP_RE.search(inst.attrs)
            if mt:
                trip = int(mt.group(1))
            self.trip_counts.append(trip)
            body = _BODY_RE.search(inst.attrs)
            cond = _COND_RE.search(inst.attrs)
            f = b = 0.0
            if body:
                fb, bb = self._comp_cost(body.group(1), mult * trip,
                                         count_bytes)
                f, b = f + fb, b + bb
            if cond:
                fc, bc = self._comp_cost(cond.group(1), mult * trip,
                                         count_bytes)
                f, b = f + fc, b + bc
            return f, b
        if op == "fusion":
            called = _CALLS_RE.search(inst.attrs)
            f = 0.0
            if called:
                key = self._pure_key(called.group(1))
                if key is not None and key in self._memo:
                    f = self._memo[key][0] * mult
                else:
                    f, _ = self._comp_cost(called.group(1), mult,
                                           count_bytes=False)
                    if key is not None and mult:
                        self._memo[key] = (f / mult, 0.0)
            b = self._io_bytes(inst, comp) * mult if count_bytes else 0.0
            if b:
                self.bytes_by_opcode["fusion"] = (
                    self.bytes_by_opcode.get("fusion", 0.0) + b)
            return f, b
        if op in ("call", "async-start"):
            called = _CALLS_RE.search(inst.attrs)
            if called:
                return self._comp_cost(called.group(1), mult, count_bytes)
            return 0.0, 0.0
        if op == "conditional":
            mb = _BRANCHES_RE.search(inst.attrs)
            if mb:
                branches = _OPERAND.findall(mb.group(1))
                costs = [self._comp_cost(br, mult, count_bytes)
                         for br in branches]
                if costs:  # charge the most expensive branch
                    return max(costs, key=lambda fb: fb[0] + fb[1])
            return 0.0, 0.0
        # ---- collectives -----------------------------------------------------
        base = op[:-6] if op.endswith("-start") else op
        if base in _COLLECTIVES:
            payload = sum(
                sum(_type_bytes(m) for m in _SHAPE_RE.finditer(
                    _operand_shape(comp, self.comps, o)))
                for o in inst.operands)
            if payload == 0.0:  # operands unresolvable → use result size
                payload = inst.result_bytes()
            self.collectives.append(
                CollectiveRecord(base, payload, mult, inst.shape,
                                 _participants(inst.attrs)))
            b = payload * mult if count_bytes else 0.0
            return 0.0, b
        if op.endswith("-done"):
            return 0.0, 0.0
        # ---- arithmetic ------------------------------------------------------
        flops = 0.0
        if op == "dot":
            flops = _dot_flops(inst, comp)
        elif op == "convolution":
            flops = _conv_flops(inst, comp)
        elif op in _ELEMENTWISE:
            flops = inst.result_elems()
        elif op in ("reduce", "reduce-window"):
            if inst.operands:
                in_b = _operand_shape(comp, self.comps, inst.operands[0])
                flops = sum(_shape_elems(m) for m in _SHAPE_RE.finditer(in_b))
            else:
                flops = inst.result_elems()
        elif op == "convert":
            flops = 0.0
        # ---- bytes -----------------------------------------------------------
        b = 0.0
        if count_bytes and op not in _ZERO_BYTES:
            b = self._io_bytes(inst, comp) * mult
            self.bytes_by_opcode[op] = self.bytes_by_opcode.get(op, 0.0) + b
        return flops * mult, b

    def _io_bytes(self, inst: Instruction, comp: Computation) -> float:
        total = inst.result_bytes()
        for o in inst.operands:
            s = _operand_shape(comp, self.comps, o)
            total += sum(_type_bytes(m) for m in _SHAPE_RE.finditer(s))
        return total


def analyze(hlo_text: str) -> CostSummary:
    comps, entry = parse_hlo(hlo_text)
    return HloCost(comps, entry).run()


def collective_schedule(summary: CostSummary, top: int = 20) -> list[dict]:
    """The dominant collectives, largest total payload first."""
    recs = sorted(summary.collectives, key=lambda r: -r.total_link_bytes)[:top]
    return [{"kind": r.kind, "payload_bytes": r.bytes_, "trips": r.trips,
             "participants": r.participants,
             "total_link_bytes": r.total_link_bytes, "shape": r.shape[:80]}
            for r in recs]
