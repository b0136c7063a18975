"""The port's analytical serving model (paper §VIII.A, Fig 20) and
speculative-decoding model (§VIII.B, Fig 21), ``repro_torch.core.serving``,
against the reference's ``repro.core.serving``: every analytical assertion
of ``tests/test_serving.py`` holds on the port, and every ``ServingPoint``
field and every throughput equals the reference's at zero tolerance; the
hierarchical roofline of ``repro_torch.core.roofline`` likewise."""
from __future__ import annotations

import dataclasses

import pytest

from repro.core import roofline as ref_roofline
from repro.core import serving as ref_serving
from repro.systems.chips import HBM_V5E as REF_HBM_V5E
from repro.systems.chips import ICI as REF_ICI
from repro.systems.chips import SN40L as REF_SN40L
from repro.systems.system import SystemSpec as RefSystemSpec
from repro.systems.topology import torus2d as ref_torus2d
from repro.workloads import llm as ref_llm
from repro_torch.core import (HierPoint, RooflineTerms, expected_accepted,
                              serving_sweep, speculative_throughput)
from repro_torch.core.roofline import stack_terms
from repro_torch.systems.chips import H100, HBM, HBM_V5E, ICI, NVLINK, SN40L
from repro_torch.systems.system import SystemSpec
from repro_torch.systems.topology import ring, torus2d
from repro_torch.workloads.llm import (LLAMA3_8B, decode_layer_graph,
                                       gpt_layer_graph)


def _sn40l_system(n=16):
    return SystemSpec("sn40l", SN40L, HBM_V5E, torus2d(n, ICI))


def _ref_sn40l_system(n=16):
    return RefSystemSpec("sn40l", REF_SN40L, REF_HBM_V5E, ref_torus2d(n, REF_ICI))


def _sweeps(batch_pre: int, batch_dec: int, kv_len: int = 8192):
    """(port points, reference points) of the same Fig 20 sweep."""
    out = []
    for llm, sweep, system in ((None, serving_sweep, _sn40l_system),
                               (ref_llm, ref_serving.serving_sweep,
                                _ref_sn40l_system)):
        shape = LLAMA3_8B if llm is None else llm.LLAMA3_8B
        pre_fn = gpt_layer_graph if llm is None else llm.gpt_layer_graph
        dec_fn = decode_layer_graph if llm is None else llm.decode_layer_graph
        pre = pre_fn(dataclasses.replace(shape, batch=batch_pre))
        dec = dec_fn(dataclasses.replace(shape, batch=batch_dec), kv_len=kv_len)
        out.append(sweep(pre, dec, n_layers=32, system=system(16)))
    return out


def _assert_points_equal(ours, ref):
    assert len(ours) == len(ref) and ours
    for a, b in zip(ours, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_serving_sweep_tradeoffs():
    """Paper Fig 20: increasing TP decreases TTFT/TPOT; increasing PP
    increases system-level throughput; points equal the reference's."""
    pts, ref = _sweeps(1, 1)
    _assert_points_equal(pts, ref)
    assert len(pts) >= 3
    by_tp = {p.tp: p for p in pts}
    tps = sorted(by_tp)
    assert by_tp[tps[-1]].ttft < by_tp[tps[0]].ttft
    pp_pts = [p for p in pts if p.pp > 1]
    if pp_pts:
        p = pp_pts[0]
        assert p.decode_throughput * p.tpot > 0.99


def test_decode_is_memory_or_network_bound():
    """Paper: 'in the decode phase most time is spent on memory and
    network'."""
    pts, ref = _sweeps(1, 8)
    _assert_points_equal(pts, ref)
    tp16 = [p for p in pts if p.tp == 16]
    assert tp16
    bd = tp16[0].breakdown_decode
    assert bd["memory"] + bd["network"] > bd["compute"]


def test_one_chip_sweep_gives_one_point():
    """TP = PP = 1 on a one-chip H100 system (the card's own reading in
    chip_smoke.py): ``_subdivide_dims`` gives a candidate, and the point
    equals the reference's on the reference's copy of the system."""
    from repro.systems.chips import H100 as REF_H100
    from repro.systems.chips import HBM as REF_HBM
    from repro.systems.chips import NVLINK as REF_NVLINK
    from repro.systems.topology import ring as ref_ring

    s = dataclasses.replace(LLAMA3_8B, batch=4)
    pts = serving_sweep(gpt_layer_graph(s), decode_layer_graph(s, kv_len=2080),
                        n_layers=32,
                        system=SystemSpec("h100", H100, HBM, ring(1, NVLINK)))
    rs = dataclasses.replace(ref_llm.LLAMA3_8B, batch=4)
    ref = ref_serving.serving_sweep(
        ref_llm.gpt_layer_graph(rs), ref_llm.decode_layer_graph(rs, kv_len=2080),
        n_layers=32,
        system=RefSystemSpec("h100", REF_H100, REF_HBM, ref_ring(1, REF_NVLINK)))
    _assert_points_equal(pts, ref)
    (p,) = pts
    assert (p.tp, p.pp) == (1, 1) and p.ttft > 0 and p.tpot > 0


def test_expected_accepted_formulas():
    assert expected_accepted(3, 0.0, "sequence") == pytest.approx(1.0)
    assert expected_accepted(3, 1.0, "sequence") == pytest.approx(4.0)
    assert expected_accepted(2, 0.5, "sequence") == pytest.approx(1.75)
    assert expected_accepted(3, 0.5, "tree") > expected_accepted(
        3, 0.5, "sequence")
    for w, a, scheme in ((3, 0.0, "sequence"), (2, 0.5, "sequence"),
                         (5, 0.7, "tree"), (8, 0.9, "tree")):
        assert expected_accepted(w, a, scheme) == \
            ref_serving.expected_accepted(w, a, scheme)


@pytest.mark.parametrize("args", [
    (1e-3, 1e-2, 4, 0.5, "sequence"), (1e-3, 1e-2, 4, 0.9, "sequence"),
    (1e-3, 1e-2, 8, 0.9, "sequence"), (1e-3, 1e-2, 2, 0.7, "tree"),
    (1e-3, 1e-2, 10, 0.7, "tree"), (1e-3, 20e-3, 4, 0.8, "sequence"),
    (8e-3, 20e-3, 4, 0.9, "sequence")])
def test_speculative_throughput_equals_reference(args):
    assert speculative_throughput(*args) == \
        ref_serving.speculative_throughput(*args)


def test_specdecode_monotonic_in_acceptance_and_window():
    td, tv = 1e-3, 1e-2
    t1 = speculative_throughput(td, tv, window=4, acceptance=0.5)
    t2 = speculative_throughput(td, tv, window=4, acceptance=0.9)
    assert t2 > t1
    t3 = speculative_throughput(td, tv, window=8, acceptance=0.9)
    assert t3 > t1


def test_specdecode_tree_prefers_small_windows():
    td, tv = 1e-3, 1e-2
    small = speculative_throughput(td, tv, window=2, acceptance=0.7,
                                   scheme="tree")
    huge = speculative_throughput(td, tv, window=10, acceptance=0.7,
                                  scheme="tree")
    assert small > huge


def test_specdecode_large_draft_model_overhead():
    tv = 20e-3
    t8 = speculative_throughput(1e-3, tv, window=4, acceptance=0.8)
    t70 = speculative_throughput(8e-3, tv, window=4, acceptance=0.9)
    assert t8 > t70


def test_roofline_equals_reference():
    args = ("cell", 3.0e12, 4.0e10, 2.0e9, 1e12, 2e12, 1e11)
    ours, ref = HierPoint(*args), ref_roofline.HierPoint(*args)
    for prop in ("oi_mem", "oi_net", "achieved_flops", "bound"):
        assert getattr(ours, prop) == getattr(ref, prop)
    terms = [RooflineTerms("a", 4, 1e15, 2e12, 3e10, 8e14),
             RooflineTerms("b", 1, 5e13, 9e11, 0.0, 4e13)]
    ref_terms = [ref_roofline.RooflineTerms("a", 4, 1e15, 2e12, 3e10, 8e14),
                 ref_roofline.RooflineTerms("b", 1, 5e13, 9e11, 0.0, 4e13)]
    for t, r in zip(terms, ref_terms):
        assert t.row() == r.row()
    got, want = stack_terms(terms), ref_roofline.stack_terms(ref_terms)
    assert got.keys() == want.keys()
    assert all((got[k] == want[k]).all() for k in got)
