"""The flash-attention tools' anchors against the kernel source.

``tools/flash_planted_faults.py`` edits exact lines of
``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`` to plant
its faults, and runs only on a CUDA card. These text checks run anywhere:
every anchor occurs exactly once in the current source, every fault
plants edits that change the source, each of the three kernels has a
pipeline fault, and each diagnosis run removes lines that exist, so a
rewrite of the kernels cannot leave the tool aiming at lines that no
longer exist. The same holds for the variants of
``tools/flash_fwd_variants.py`` and ``tools/flash_bwd_variants.py``, and of
the SSD, decode-attention and RMSNorm tools.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc" / "flash_attention.cu"


def _tool(name: str = "flash_planted_faults"):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
FWD_VARIANTS = _tool("flash_fwd_variants")
BWD_VARIANTS = _tool("flash_bwd_variants")


def test_tool_names_the_source():
    assert ROOT / "src" / TOOL.SOURCE == SOURCE


@pytest.mark.parametrize("anchor", TOOL.ANCHORS)
def test_anchor_occurs_once(anchor):
    assert SOURCE.read_text().count(anchor) == 1


@pytest.mark.parametrize("name", sorted(TOOL.FAULTS))
def test_fault_plants_its_edits(name):
    text = SOURCE.read_text()
    kind, outputs, edits, what = TOOL.FAULTS[name]
    assert kind in ("pipeline", "tile") and outputs and what
    assert set(outputs) <= {"o", "dk", "dv", "dq"}
    planted = TOOL.plant(text, edits)
    for old, new in edits:
        assert old in TOOL.ANCHORS and new != old
        assert planted.count(new) == 1 and planted.count(old) == 0
    assert len(planted) - len(text) == sum(len(n) - len(o) for o, n in edits)


def test_every_kernel_has_a_pipeline_fault():
    hit = {out for kind, outs, _, _ in TOOL.FAULTS.values() if kind == "pipeline"
           for out in outs}
    assert hit == {"o", "dk", "dv", "dq"}


@pytest.mark.parametrize("name", sorted(TOOL.DIAGNOSIS))
def test_diagnosis_takes_out_part_of_the_repair(name):
    """Each diagnosis run plants a forward pipeline fault and removes the
    producer's stop, its drain, or both: every removed line is in the
    source once, and the planted copy no longer holds it."""
    text = SOURCE.read_text()
    fault, cut, what = TOOL.DIAGNOSIS[name]
    assert TOOL.FAULTS[fault][0] == "pipeline" and what
    planted = TOOL.plant(text, TOOL.FAULTS[fault][2] + cut)
    for old, _ in cut:
        assert text.count(old) == 1 and planted.count(old) == 0
    assert ("drain_ring(full_k, ST, kt)" in planted) == (TOOL.FWD_DRAIN[0] not in cut)


def test_plant_refuses_a_missing_anchor():
    with pytest.raises(SystemExit, match="occurs 0 times"):
        TOOL.plant("no anchors here", [(TOOL.FWD_MASK, "x")])


@pytest.mark.parametrize("name", sorted(FWD_VARIANTS.VARIANTS))
def test_forward_variant_finds_its_text(name):
    assert FWD_VARIANTS.SOURCE == SOURCE
    text = SOURCE.read_text()
    edits, what = FWD_VARIANTS.VARIANTS[name]
    assert what and all(old in text for old, _ in edits)
    assert (FWD_VARIANTS.variant_source(name) == text) == (not edits)


@pytest.mark.parametrize("name", sorted(BWD_VARIANTS.VARIANTS))
def test_backward_variant_edits_the_source_once(name):
    assert BWD_VARIANTS.SOURCE == SOURCE
    text = SOURCE.read_text()
    edits, what = BWD_VARIANTS.VARIANTS[name]
    assert what and all(text.count(old) == 1 and new != old for old, new in edits)
    varied = BWD_VARIANTS.variant_source(name)
    assert (varied == text) == (not edits)
    # ping-pong keeps the turns balanced: one sync and one arrive a product
    assert varied.count("turn_sync(my_turn)") == varied.count("turn_arrive(their_turn)")


# ------------------------------- the SSD scan ---------------------------------
SSD_SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "ssd" / "csrc" / "ssd.cu"
SSD_TOOL = _tool("ssd_planted_faults")
SSD_VARIANTS = _tool("ssd_variants")


def test_ssd_tools_name_the_source():
    assert ROOT / "src" / SSD_TOOL.SOURCE == SSD_SOURCE
    assert SSD_VARIANTS.SOURCE == SSD_SOURCE


@pytest.mark.parametrize("anchor", SSD_TOOL.ANCHORS)
def test_ssd_anchor_occurs_once(anchor):
    assert SSD_SOURCE.read_text().count(anchor) == 1


@pytest.mark.parametrize("name", sorted(SSD_TOOL.FAULTS) + sorted(SSD_TOOL.DIAGNOSIS))
def test_ssd_fault_plants_its_edits(name):
    text = SSD_SOURCE.read_text()
    edits, what = {**SSD_TOOL.FAULTS, **SSD_TOOL.DIAGNOSIS}[name]
    assert what and edits
    planted = SSD_TOOL.plant(text, edits)
    for old, new in edits:
        assert old in SSD_TOOL.ANCHORS and new != old
        assert planted.count(new) == 1 and planted.count(old) == (old in new)
    assert len(planted) - len(text) == sum(len(n) - len(o) for o, n in edits)


def test_ssd_faults_cover_the_state_the_split_and_the_tail():
    """The state rounded to bf16, a cross term too many dropped and the
    ragged tail's last row left out of h_final are among the faults."""
    assert {"state_rounded_to_bf16", "state_mid_term_dropped",
            "ragged_tail_last_row_out_of_h"} <= set(SSD_TOOL.FAULTS)


@pytest.mark.parametrize("name", sorted(SSD_VARIANTS.VARIANTS))
def test_ssd_variant_finds_its_text_once(name):
    text = SSD_SOURCE.read_text()
    edits, what = SSD_VARIANTS.VARIANTS[name]
    assert what and all(text.count(old) == 1 and new != old for old, new in edits)
    assert (SSD_VARIANTS.variant_source(name) == text) == (not edits)
    # a variant that leaves work out says so
    assert (name == "as-is") != what.endswith(SSD_VARIANTS.OUTSIDE)


# ------------------------------- decode attention -----------------------------
DECODE_TOOL = _tool("decode_planted_faults")
DECODE_VARIANTS = _tool("decode_variants")
DECODE_SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "decode_attention" / "csrc" / "decode_attention.cu"


def test_decode_tools_name_the_sources():
    assert ROOT / "src" / DECODE_TOOL.KERNEL == DECODE_SOURCE
    assert (ROOT / "src" / DECODE_TOOL.ENGINE).is_file()
    assert DECODE_VARIANTS.SOURCE == DECODE_SOURCE


@pytest.mark.parametrize("path,anchor", [(path, a) for path, anchors in
                                         DECODE_TOOL.ANCHORS.items() for a in anchors])
def test_decode_anchor_occurs_once(path, anchor):
    assert (ROOT / "src" / path).read_text().count(anchor) == 1


@pytest.mark.parametrize("name", sorted(DECODE_TOOL.FAULTS))
def test_decode_fault_plants_its_edits(name):
    path, edits, what = DECODE_TOOL.FAULTS[name]
    text = (ROOT / "src" / path).read_text()
    assert what and edits
    planted = DECODE_TOOL.plant(text, edits)
    for old, new in edits:
        assert old in DECODE_TOOL.ANCHORS[path] and new != old
        assert planted.count(new) == 1 and planted.count(old) == (old in new)
    assert len(planted) - len(text) == sum(len(n) - len(o) for o, n in edits)


def test_decode_faults_cover_the_split_the_length_p_and_the_graph():
    """A dropped split, kv_len off by one, P rounded once to bf16 and a
    kv_len frozen at its captured value are among the faults."""
    assert set(DECODE_TOOL.FAULTS) == {"dropped_split", "kv_len_off_by_one",
                                       "p_rounded_to_bf16", "kv_len_frozen_at_capture"}


@pytest.mark.parametrize("name", sorted(DECODE_VARIANTS.VARIANTS))
def test_decode_variant_finds_its_text_once(name):
    text = DECODE_SOURCE.read_text()
    edits, what = DECODE_VARIANTS.VARIANTS[name]
    assert what and all(text.count(old) == 1 and new != old for old, new in edits)
    assert (DECODE_VARIANTS.variant_source(name) == text) == (not edits)


# ------------------------------- the fused RMSNorm ----------------------------
RMSNORM_TOOL = _tool("rmsnorm_planted_faults")
RMSNORM_VARIANTS = _tool("rmsnorm_variants")
RMSNORM_SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "rmsnorm" / "csrc" / "rmsnorm.cu"


def test_rmsnorm_tools_name_the_source():
    assert ROOT / "src" / RMSNORM_TOOL.KERNEL == RMSNORM_SOURCE
    assert RMSNORM_VARIANTS.SOURCE == RMSNORM_SOURCE


@pytest.mark.parametrize("anchor", RMSNORM_TOOL.ANCHORS)
def test_rmsnorm_anchor_occurs_once(anchor):
    assert RMSNORM_SOURCE.read_text().count(anchor) == 1


@pytest.mark.parametrize("name", sorted(RMSNORM_TOOL.FAULTS) + sorted(RMSNORM_TOOL.BASELINES))
def test_rmsnorm_fault_plants_its_edits(name):
    text = RMSNORM_SOURCE.read_text()
    edits, what = {**RMSNORM_TOOL.FAULTS, **RMSNORM_TOOL.BASELINES}[name]
    assert what and (edits or name == "baseline")
    planted = RMSNORM_TOOL.plant(text, edits)
    for old, new in edits:
        assert old in RMSNORM_TOOL.ANCHORS and new != old
        # gone, unless an edit puts it back elsewhere (a moved line)
        assert planted.count(old) == sum(n.count(old) for _, n in edits)
    assert len(planted) - len(text) == sum(len(n) - len(o) for o, n in edits)


def test_rmsnorm_faults_cover_the_sum_w_the_wait_and_the_gate():
    """A dropped warp's partial sum, w read one vector off, the dependency
    wait after the first x loads and SiLU not rounded are the faults; the
    wait is moved in a copy launched as a programmatic dependent, where it
    is not a no-op."""
    assert set(RMSNORM_TOOL.FAULTS) == {"warp_partial_dropped", "w_one_vector_off",
                                        "wait_after_x_loads", "silu_not_rounded"}
    assert RMSNORM_TOOL.PDL_ON in RMSNORM_TOOL.FAULTS["wait_after_x_loads"][0]
    planted = RMSNORM_TOOL.plant(RMSNORM_SOURCE.read_text(),
                                 RMSNORM_TOOL.FAULTS["wait_after_x_loads"][0])
    assert planted.index(RMSNORM_TOOL.FIRST_LOAD) < planted.index(RMSNORM_TOOL.WAIT)


@pytest.mark.parametrize("name", sorted(RMSNORM_VARIANTS.VARIANTS))
def test_rmsnorm_variant_finds_its_text_once(name):
    text = RMSNORM_SOURCE.read_text()
    edits, what = RMSNORM_VARIANTS.VARIANTS[name]
    assert what and all(text.count(old) == 1 and new != old for old, new in edits)
    assert (RMSNORM_VARIANTS.variant_source(name) == text) == (not edits)
    # a variant that leaves work out says so
    assert (name == "loads-alone") == what.endswith(RMSNORM_VARIANTS.OUTSIDE)


@pytest.mark.parametrize("name,attribute", [("pdl", "ProgrammaticStreamSerialization"),
                                            ("cluster-4", "ClusterDimension")])
def test_rmsnorm_launch_variants_plant_their_attribute(name, attribute):
    """The committed kernel is launched plainly, with no launch attribute;
    the pdl and cluster variants replace that one launch by
    cudaLaunchKernelEx with theirs."""
    text = RMSNORM_SOURCE.read_text()
    planted = RMSNORM_VARIANTS.variant_source(name)
    assert text.count("<<<") == 1 and "cudaLaunchKernelEx" not in text
    assert "<<<" not in planted and planted.count("cudaLaunchKernelEx(") == 1
    key = f"cudaLaunchAttribute{attribute};"
    assert planted.count(key) == 1 and key not in text


# ------------------------------- the hd-16 kernels ----------------------------
HD16_COMPARE = _tool("kernel_compare")


def test_hd16_compare_names_the_sources():
    assert HD16_COMPARE.SOURCES == {"decode_attention": DECODE_SOURCE,
                                    "flash_attention": SOURCE}


@pytest.mark.parametrize("name", sorted(HD16_COMPARE.VARIANTS))
def test_hd16_variant_finds_its_text_once(name):
    lib, edits, what = HD16_COMPARE.VARIANTS[name]
    text = HD16_COMPARE.SOURCES[lib].read_text()
    assert what and edits and all(text.count(old) == 1 and new != old for old, new in edits)
    edited = HD16_COMPARE.variant_sources(name)
    assert edited[lib] != text
    assert all(edited[other] == HD16_COMPARE.SOURCES[other].read_text()
               for other in edited if other != lib)
