"""Validation cases: one scenario, two halves, one contract (the
reference's ``validation/cases.py``, on the port's own pipeline).

A :class:`ValidationCase` pairs a scenario's analytical decode workload
(`TrainWorkload`, priced by the `repro_torch.core` machinery) with its
certified :class:`~repro_torch.workloads.scenarios.ExecutableTwin` (a
runtime `ModelConfig` plus batch geometry a `ServeEngine` can actually
run). Building a case re-runs the twin's correspondence certification — a
case whose two halves disagree on FLOPs/token or KV bytes cannot be
constructed.

The prediction side is numpy-only: the host (here the card) is modeled as
a one-chip :class:`~repro_torch.systems.system.SystemSpec` whose peak
FLOP/s and memory bandwidth come from runtime calibration
(`repro_torch.validation.measure.calibrate_host`) or from the committed
baseline, and the analytical iter time flows through the *real* pipeline —
`evaluate_plan` → `plan_vector_for` → `decompose_iter_time` — never a
side-channel formula.
"""
from __future__ import annotations

import dataclasses

from ..core.dse import plan_vector_for
from ..core.interchip import TrainWorkload, evaluate_plan
from ..core.pricing import decompose_iter_time
from ..systems.chips import ChipSpec, InterconnectSpec, MemorySpec
from ..systems.system import SystemSpec
from ..systems.topology import Topology, TopologyDim
from ..workloads.scenarios import ExecutableTwin, get_scenario

#: scenarios with an executable twin — the validated serving set
CASE_NAMES: tuple[str, ...] = ("serving", "mamba2", "moe")


@dataclasses.dataclass(frozen=True)
class ValidationCase:
    """One scenario's modeled↔measured pair."""

    name: str
    twin: ExecutableTwin
    work: TrainWorkload          # the analytical half (twin.workload())

    @property
    def steps_per_iter(self) -> int:
        """Decode steps one analytical 'iteration' covers (the twin pins
        global_batch == microbatch, so this is 1 by construction)."""
        return self.work.global_batch // self.work.microbatch

    # --- analytical per-step totals (the dry-run channel's predictions) ----
    def predicted_flops(self) -> float:
        """Forward FLOPs of one decode step (batch × per-token work)."""
        g = self.work
        total = g.layer_graph.total_flops() * g.n_layers
        for blk in (g.pre_graph, g.post_graph):
            if blk is not None:
                total += blk.total_flops()
        return total

    def predicted_bytes(self) -> float:
        """Idealized DRAM traffic of one decode step: every weight byte,
        KV/state byte and inter-kernel activation byte exactly once. The
        executable lowering re-materializes tensors at fusion boundaries,
        so measured bytes sit *above* this floor by a bounded factor (the
        bytes band is asymmetric for exactly that reason)."""
        g = self.work
        layer = (g.layer_graph.total_weight_bytes()
                 + sum(t.bytes_ for t in g.layer_graph.tensors))
        total = layer * g.n_layers
        for blk in (g.pre_graph, g.post_graph):
            if blk is not None:
                total += (blk.total_weight_bytes()
                          + sum(t.bytes_ for t in blk.tensors))
        return total

    def predicted_collective_bytes(self) -> float:
        """Link traffic of one decode step — identically zero on the
        one-chip host (TP = PP = DP = 1), and the dry-run channel asserts
        the measured HLO agrees (a collective appearing in a single-device
        lowering is a sharding bug, not noise)."""
        return 0.0


def build_case(name: str) -> ValidationCase:
    """Build (and certify) one scenario's validation case."""
    twin = get_scenario(name).executable_twin()
    return ValidationCase(name=name, twin=twin, work=twin.workload())


def validation_cases() -> list[ValidationCase]:
    return [build_case(n) for n in CASE_NAMES]


# --- the host as a one-chip system ------------------------------------------
def host_system(flop_rate: float, mem_bw: float,
                mem_capacity: float = 64e9) -> SystemSpec:
    """The measurement host as a DFModel system: one chip at the *measured*
    effective peak (not the vendor datasheet), one memory at the measured
    stream bandwidth, a single-node topology. Price/power are unit-valued —
    efficiency metrics are meaningless for a validation host."""
    link = InterconnectSpec("host-loop", bandwidth=1e9, latency=1e-6,
                            price_per_link=0.0, power_per_link=0.0)
    chip = ChipSpec("host", tiles=1, tile_flops=flop_rate,
                    sram_capacity=32 * 2**20, price=1.0, power=1.0,
                    dataflow=False)
    mem = MemorySpec("host-ram", bandwidth=mem_bw, capacity=mem_capacity,
                     price=1.0, power=1.0)
    topo = Topology("host", (TopologyDim(1, "ring", link),))
    return SystemSpec("host", chip, mem, topo)


def predict_case(case: ValidationCase, flop_rate: float,
                 mem_bw: float) -> dict:
    """The analytical prediction for one case on the calibrated host.

    Routes through the same machinery every DSE cell is priced with:
    ``evaluate_plan`` at (TP, PP, DP) = (1, 1, 1) on the one-chip system,
    then the intra-chip pass and the certified per-term decomposition.
    Times are per decode step (seconds); counts are per decode step too.
    """
    system = host_system(flop_rate, mem_bw)
    topo = system.topology
    plan = evaluate_plan(case.work, system, 1, 1, 1, topo, topo, topo,
                         execution="kbk")
    if plan is None:
        raise RuntimeError(f"case {case.name!r}: host plan infeasible")
    vec = plan_vector_for(case.work, system, plan, execution="kbk")
    terms = decompose_iter_time(vec)
    steps = case.steps_per_iter
    return {
        "flops": case.predicted_flops(),
        "bytes": case.predicted_bytes(),
        "collective_bytes": case.predicted_collective_bytes(),
        "t_compute": terms["t_compute"] / steps,
        "t_memory": terms["t_memory"] / steps,
        "t_collective": terms["t_collective"] / steps,
        "step_time": terms["iter_time"] / steps,
    }
