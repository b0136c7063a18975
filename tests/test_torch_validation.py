"""The port's validation loop (``repro_torch.validation``) against the
reference's (``repro.validation``): the twins certify, ``predict_case``
equals the reference's at zero tolerance, the bands and the report gate
behave as the reference's with arguments in place of its environment
knobs, the dry-run op counter's plain route lands in the bands on all
three twins, and the wall-clock channel runs on the CPU. The committed
``BENCH_validation_torch.json`` (written on the card) passes the gate with
fresh predictions."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro import validation as ref
from repro_torch.validation import (CASE_NAMES, REPORT_PATH, build_case,
                                    build_case_report, bytes_factor,
                                    check_case, check_report, host_system,
                                    hybrid_step_time, load_report,
                                    measure_dryrun, measure_wallclock,
                                    predict_case, trimmed_mean,
                                    validation_band, validation_cases,
                                    validation_repeats, validation_warmup,
                                    wall_band)
from repro_torch.validation.opcount import (COLLECTIVE_KINDS, ByteCounter,
                                            count_ops)
from repro_torch.workloads.scenarios import get_scenario


# ------------------------------ twins ----------------------------------------
def test_every_case_twin_certifies():
    cases = validation_cases()
    assert [c.name for c in cases] == list(CASE_NAMES) == list(ref.CASE_NAMES)
    for case in cases:
        assert case.steps_per_iter == 1
        assert case.twin.assert_correspondence() == \
            ref.build_case(case.name).twin.assert_correspondence()


def test_twin_correspondence_catches_drift(monkeypatch):
    twin = get_scenario("serving").executable_twin()
    monkeypatch.setattr(type(twin), "flops_per_token", lambda self: 123.0)
    with pytest.raises(AssertionError):
        build_case("serving")


# ------------------------------ predictions ----------------------------------
@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("rates", [(1e11, 4e9), (7.3e14, 2.9e12)])
def test_predict_case_equals_reference(name, rates):
    """Two calibrations: the reference's default and one of an H100's
    order (the card's own is measured by chip_smoke.py)."""
    got = predict_case(build_case(name), *rates)
    want = ref.predict_case(ref.build_case(name), *rates)
    assert got == want
    case = build_case(name)
    assert (case.predicted_flops(), case.predicted_bytes()) == \
        (want["flops"], want["bytes"])
    total = got["t_compute"] + got["t_memory"] + got["t_collective"]
    assert total == pytest.approx(got["step_time"], rel=1e-9)
    assert got["t_collective"] == 0.0 and got["collective_bytes"] == 0.0


def test_host_system_equals_reference():
    ours, theirs = host_system(2e12, 3e12), ref.host_system(2e12, 3e12)
    assert ours.chip.peak_flops == theirs.chip.peak_flops
    assert ours.memory.bandwidth == theirs.memory.bandwidth
    assert ours.n_chips == theirs.n_chips == 1


# ------------------------------ protocol arguments ---------------------------
def test_protocol_arguments():
    assert validation_repeats() == 16 and validation_warmup() == 2
    assert validation_repeats(4) == 4 and validation_warmup(0) == 0
    for bad in (0, 10_001, 2.5, True):
        with pytest.raises(ValueError, match="repeats"):
            validation_repeats(bad)
    with pytest.raises(ValueError, match="warmup"):
        validation_warmup(-1)


def test_band_arguments():
    assert (validation_band(), bytes_factor(), wall_band()) == (0.25, 24.0, 2.5)
    assert validation_band(0.1) == 0.1
    with pytest.raises(ValueError, match="wband"):
        wall_band(0.5)
    with pytest.raises(ValueError, match="byte_factor"):
        bytes_factor(0.5)
    with pytest.raises(ValueError, match="band"):
        validation_band(11.0)


def test_trimmed_mean():
    assert trimmed_mean([1.0] * 10) == 1.0
    assert trimmed_mean([1.0] * 9 + [100.0]) == 1.0
    assert trimmed_mean([5.0]) == 5.0
    xs = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    assert trimmed_mean(xs) == ref.trimmed_mean(xs)
    with pytest.raises(ValueError):
        trimmed_mean([])


# ------------------------------ the gate -------------------------------------
def _row(module=None, **over):
    predicted = {"flops": 1e9, "bytes": 1e8, "collective_bytes": 0.0,
                 "t_compute": 0.01, "t_memory": 0.02, "t_collective": 0.0,
                 "step_time": 0.03}
    dry = {"flops": 1.05e9, "bytes": 1.2e9, "collective_bytes": 0.0}
    wall = {"tpot": 0.3}
    cal = {"flop_rate": 1e11, "mem_bw": 4e9}
    build = (module or __import__("repro_torch.validation",
                                  fromlist=["x"])).build_case_report
    row = build("synthetic", predicted, dry, wall, cal, wall_gate=True)
    row["ratios"].update(over.pop("ratios", {}))
    row.update(over)
    return row


def test_case_report_equals_reference():
    assert _row() == _row(ref)


@pytest.mark.parametrize("over, word", [
    ({}, None), ({"ratios": {"flops": 1.5}}, "flops"),
    ({"ratios": {"bytes": 50.0}}, "bytes"), ({"ratios": {"bytes": 0.5}}, "bytes"),
    ({"collective_delta_bytes": 64.0}, "collective"),
    ({"ratios": {"compute_term": 5.0}}, "compute"),
    ({"ratios": {"hybrid": 10.0}}, "hybrid"),
    ({"ratios": {"hybrid": 0.3}}, "hybrid")])
def test_check_case_flags_each_band(over, word):
    problems = check_case(_row(**over))
    assert len(problems) == len(ref.check_case(_row(ref, **over)))
    if word is None:
        assert problems == []
    else:
        assert len(problems) == 1 and word in problems[0]


def test_bands_are_arguments():
    row = _row(ratios={"flops": 1.2, "hybrid": 2.8})
    assert len(check_case(row)) == 1                  # hybrid outside 2.5
    assert check_case(row, wband=3.0) == []
    assert len(check_case(row, band=0.1, wband=3.0)) == 1
    assert len(check_case(_row(ratios={"bytes": 30.0}), byte_factor=40.0)) == 0
    assert len(check_report({"cases": [row, row]})) == 2


def test_wall_gate_flag_scopes_the_hybrid_band():
    row = _row(ratios={"hybrid": 10.0})
    row["wall_gate"] = False
    assert check_case(row) == []
    row = _row(ratios={"hybrid": 10.0, "compute_term": 5.0})
    row["wall_gate"] = False
    assert len(check_case(row)) == 1


def test_hybrid_step_time_is_the_roofline_max():
    dry = {"flops": 8e8, "bytes": 3e9}
    assert hybrid_step_time(dry, 1e11, 4e9) == pytest.approx(3e9 / 4e9)
    assert hybrid_step_time(dry, 1e9, 1e12) == pytest.approx(8e8 / 1e9)


def test_report_path_is_the_ports_own():
    assert REPORT_PATH.name == "BENCH_validation_torch.json"
    assert REPORT_PATH != ref.REPORT_PATH


# ------------------------------ the op counter -------------------------------
def test_byte_counter_views_in_place_and_collectives():
    x = torch.ones(4, 8)
    y = torch.ones(8, 2)
    with ByteCounter() as c:
        v = x.view(32).view(4, 8).t()           # views: nothing
        torch.empty(100)                         # an allocation: nothing
        z = x @ y                                # 128 + 64 in, 32 out
        x.add_(1.0)                              # x read and written
    assert v.shape == (8, 4)
    assert c.bytes == (128 + 64 + 32) + 2 * 128 and c.ops == 2
    assert z.shape == (4, 2)
    # collectives are counted where parallel/dist.py issues them, by the
    # reference's kinds, not at the dispatcher (tests/test_torch_model_axis.py)
    assert COLLECTIVE_KINDS == ("all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute")


def test_count_ops_counts_products():
    a, b = torch.ones(16, 32), torch.ones(32, 8)
    got = count_ops(lambda: a @ b, "cpu")
    assert got["flops"] == 2 * 16 * 32 * 8
    assert got["bytes"] == (16 * 32 + 32 * 8 + 16 * 8) * 4
    assert got["route"] == "plain" and got["collective_bytes"] == 0.0


@pytest.mark.parametrize("name", CASE_NAMES)
def test_dryrun_plain_route_within_bands(name):
    case = build_case(name)
    dry = measure_dryrun(case, device="cpu")
    assert dry["route"] == "plain" and dry["collective_bytes"] == 0.0
    assert set(dry["collective_by_kind"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert abs(dry["flops"] / case.predicted_flops() - 1.0) <= validation_band()
    assert dry["bytes"] >= 0.75 * case.predicted_bytes()
    predicted = predict_case(case, 1e11, 4e9)
    row = build_case_report(name, predicted, dry, None, None,
                            case.twin.wall_gate)
    assert check_case(row) == []


# ------------------------------ the wall clock -------------------------------
def test_wallclock_channel_cheap_twin():
    case = build_case("mamba2")
    wall = measure_wallclock(case, repeats=3, warmup=1, device="cpu")
    assert wall["repeats"] == 3 and wall["warmup"] == 1 and wall["tpot"] > 0
    assert wall["ttft"] > 0 and wall["tokens_per_s"] > 0
    assert wall["step_time_min"] <= wall["tpot"] <= wall["step_time_max"]
    assert wall["prompt_len"] == case.twin.kv_len - (1 + 3 + 1)


def test_wallclock_window_guard():
    case = build_case("mamba2")
    with pytest.raises(ValueError, match="measurement window"):
        measure_wallclock(case, repeats=10_000, warmup=0, device="cpu")
    short = dataclasses.replace(case, twin=dataclasses.replace(case.twin, kv_len=20))
    with pytest.raises(ValueError, match="measurement window"):
        measure_wallclock(short, repeats=3, warmup=1, device="cpu")


# ------------------------------ committed baseline ---------------------------
def test_committed_baseline_passes_the_gate():
    """BENCH_validation_torch.json, written on the card, gates green with
    fresh predictions at its own calibration; it names the card."""
    base = load_report()
    assert {row["case"] for row in base["cases"]} == set(CASE_NAMES)
    assert base["device"]["name"] and base["device"]["power_limit"]
    rows = []
    for brow in base["cases"]:
        case = build_case(brow["case"])
        cal = base["calibration"]
        predicted = predict_case(case, cal["flop_rate"], cal["mem_bw"])
        assert predicted == pytest.approx(brow["predicted"], rel=1e-12)
        rows.append(build_case_report(brow["case"], predicted,
                                      brow["dryrun"], None, None,
                                      case.twin.wall_gate))
    assert check_report({"cases": rows}) == []


def test_committed_baseline_wall_ratios_recorded():
    """The gated case carries the paper's comparison inside the band; a
    case without a wall clock says why."""
    base = load_report()
    wband = base["bands"]["wall_band"]
    for row in base["cases"]:
        if "wallclock" in row:
            assert row["wallclock"]["tpot"] > 0
            assert {"compute_term", "hybrid"} <= set(row["ratios"])
        else:
            assert row["wallclock_absent"]
        if row["wall_gate"]:
            assert 1.0 / wband <= row["ratios"]["hybrid"] <= wband
    assert any(r["wall_gate"] and "wallclock" in r for r in base["cases"])
