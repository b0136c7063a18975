"""The port's copy of the HLO cost parser (``repro_torch.launch.hlocost``)
against the reference's on the canned module ``tests/data/canned_decode.hlo``
(the identities of ``tests/test_hlocost_fixture.py``, every number equal to
``repro.launch.hlocost``'s), and the port's own counterpart,
``validation/opcount.trace_cost``, which fills the same ``CostSummary``
from one traced call: FLOPs and bytes, and the collectives by the logical
kind ``parallel/dist.py`` issues (its counts on gloo meshes are held in
``tests/test_torch_model_axis.py``)."""
from __future__ import annotations

import dataclasses
import pathlib

import pytest
import torch

from repro.launch import hlocost as ref
from repro_torch.launch import hlocost
from repro_torch.validation.opcount import trace_cost

FIXTURE = pathlib.Path(__file__).parent / "data" / "canned_decode.hlo"
DOT_FLOPS = 2 * 64 * 64 * 64
FUSION_FLOPS = 32 * 32 + 32 * 32
AR_PAYLOAD = 64 * 64 * 4
RES_PAYLOAD = 64 * 64 * 4
AG_PAYLOAD = 32 * 32 * 2


def _both(text=None):
    text = text or FIXTURE.read_text()
    return hlocost.analyze(text), ref.analyze(text)


def test_trip_counts_and_flops_equal_reference():
    s, r = _both()
    assert s.while_trip_counts == r.while_trip_counts == [5, 4, 3]
    want = (DOT_FLOPS * 5 + 1 * 5 + 1 * 4 + 1 * 12 + 16 * 12 + FUSION_FLOPS * 2)
    assert s.flops == r.flops == want


def test_bytes_equal_reference():
    s, r = _both()
    assert s.bytes_by_opcode == r.bytes_by_opcode
    assert s.bytes_by_opcode["fusion"] == (32 * 32 * 2 * 2) * 2
    assert s.bytes_by_opcode["dot"] == 3 * 64 * 64 * 4 * 5
    want = (3 * 64 * 64 * 4 * 5 + AR_PAYLOAD * 5 + 12 * 5 + 12 * 4 + 12 * 12
            + (3 * 16 * 4) * 12 + 9 * 5 + 9 * 4 + 9 * 12
            + (32 * 32 * 2 * 2) * 2 + AG_PAYLOAD + RES_PAYLOAD * 3)
    assert s.bytes_accessed == r.bytes_accessed == want


def test_collective_link_bytes_and_participants_equal_reference():
    s, r = _both()
    want = {"all-reduce": 2.0 * AR_PAYLOAD * 3 / 4 * 5,
            "all-gather": AG_PAYLOAD * 3,
            "reduce-scatter": RES_PAYLOAD / 2,
            "all-to-all": RES_PAYLOAD * 7 / 8,
            "collective-permute": RES_PAYLOAD}
    assert s.collective_bytes == r.collective_bytes == want
    assert s.link_traffic_bytes == r.link_traffic_bytes == sum(want.values())
    assert [dataclasses.astuple(x) for x in s.collectives] == \
        [dataclasses.astuple(x) for x in r.collectives]
    by_kind = {x.kind: x for x in s.collectives}
    assert [by_kind[k].participants for k in
            ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")] == [4, 4, 2, 8]
    assert by_kind["all-reduce"].trips == 5 and len(s.collectives) == 5
    assert s.row() == r.row()


def test_trip_count_rescale_equal_reference():
    text = FIXTURE.read_text().replace('{"n":"5"}', '{"n":"6"}')
    s, r = _both(text)
    base = hlocost.analyze(FIXTURE.read_text())
    assert s.flops - base.flops == DOT_FLOPS + 1
    assert s.while_trip_counts == r.while_trip_counts == [6, 4, 3]
    assert s.collective_bytes == r.collective_bytes


def test_schedule_order_equals_reference():
    s, r = _both()
    assert hlocost.collective_schedule(s) == ref.collective_schedule(r)
    assert hlocost.collective_schedule(s)[0]["kind"] == "all-reduce"
    totals = [row["total_link_bytes"] for row in hlocost.collective_schedule(s)]
    assert totals == sorted(totals, reverse=True)


@pytest.mark.parametrize("a,b", [(4, 8), (16, 16)])
def test_trace_cost_counts_a_product(a, b):
    """One (a, b) @ (b, a) f32 product: 2 a b a FLOPs, its operands and
    result read and written once; no collective and no loop."""
    x, y = torch.ones(a, b), torch.ones(b, a)
    s = trace_cost(lambda: torch.mm(x, y), "cpu")
    assert isinstance(s, hlocost.CostSummary)
    assert s.flops == 2 * a * b * a
    assert s.bytes_accessed == 4 * (a * b + b * a + a * a)
    assert s.bytes_by_opcode == {"mm": 4 * (a * b + b * a + a * a)}
    assert s.collectives == [] and s.collective_bytes == {}
    assert s.while_trip_counts == []
