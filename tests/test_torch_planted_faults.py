"""The planted-fault tool's anchors against the flash-attention source.

``tools/flash_planted_faults.py`` edits exact lines of
``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`` to plant
its faults, and runs only on a CUDA card. These text checks run anywhere:
every anchor occurs exactly once in the current source, and every fault
plants edits that change the source, so a rewrite of the kernels cannot
leave the tool aiming at lines that no longer exist.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc" / "flash_attention.cu"


def _tool():
    spec = importlib.util.spec_from_file_location(
        "flash_planted_faults", ROOT / "tools" / "flash_planted_faults.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


def test_tool_names_the_source():
    assert ROOT / "src" / TOOL.SOURCE == SOURCE


@pytest.mark.parametrize("anchor", TOOL.ANCHORS)
def test_anchor_occurs_once(anchor):
    assert SOURCE.read_text().count(anchor) == 1


@pytest.mark.parametrize("name", sorted(TOOL.FAULTS))
def test_fault_plants_its_edits(name):
    text = SOURCE.read_text()
    outputs, edits, what = TOOL.FAULTS[name]
    assert outputs and what
    planted = TOOL.plant(text, edits)
    for old, new in edits:
        assert old in TOOL.ANCHORS and new != old
        assert planted.count(new) == 1 and planted.count(old) == 0
    assert len(planted) - len(text) == sum(len(n) - len(o) for o, n in edits)


def test_plant_refuses_a_missing_anchor():
    with pytest.raises(SystemExit, match="occurs 0 times"):
        TOOL.plant("no anchors here", [(TOOL.FWD_MASK, "x")])
