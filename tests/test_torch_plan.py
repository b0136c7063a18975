"""The port's planner (``repro_torch.launch.plan``) against the reference's
``repro.launch.plan`` at zero tolerance: every key and every float of
``plan_cell`` equal on the TPU v5e system, for every cell of every arch but
gpt3_175b, on one pod and two; and a finite plan for every cell on the
H100 system at tensor parallelism 8."""
from __future__ import annotations

import math

import pytest

from repro.launch import plan as ref_plan
from repro_torch.configs import ARCH_IDS, cells
from repro_torch.launch import plan

ARCHS = [a for a in ARCH_IDS if a != "gpt3_175b"]


def _same(a, b, where=""):
    """Equal trees, floats bit for bit (NaN equal to NaN)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float):
        assert a == b or (math.isnan(a) and math.isnan(b)), (where, a, b)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_cell_equals_reference_on_v5e(arch, multi_pod):
    from repro.configs import cells as ref_cells
    assert cells(arch) == ref_cells(arch)
    for shape in cells(arch):
        _same(plan.plan_cell(arch, shape, multi_pod),
              ref_plan.plan_cell(arch, shape, multi_pod), f"{arch}/{shape}")


def test_v5e_system_and_block_graph_equal_reference():
    from repro.configs import get_config as ref_get
    from repro_torch.configs import get_config
    for mp in (False, True):
        a, b = plan.v5e_system(mp), ref_plan.v5e_system(mp)
        assert a.n_chips == b.n_chips and a.name == b.name
        assert a.topology.total_chips == b.topology.total_chips
    for arch in ARCHS:
        g = plan.block_graph(get_config(arch), 128, 2)
        r = ref_plan.block_graph(ref_get(arch), 128, 2)
        assert [k.name for k in g.kernels] == [k.name for k in r.kernels]
        assert [(k.flops, k.weight_bytes) for k in g.kernels] == \
            [(k.flops, k.weight_bytes) for k in r.kernels]
        assert [(t.name, t.src, t.dst, t.bytes_) for t in g.tensors] == \
            [(t.name, t.src, t.dst, t.bytes_) for t in r.tensors]


def test_subquadratic_equals_reference():
    from repro.configs import get_config as ref_get
    from repro_torch.configs import get_config
    for arch in ARCH_IDS:
        assert get_config(arch).subquadratic == ref_get(arch).subquadratic


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_cell_on_h100_is_finite(arch, multi_pod):
    system = plan.h100_system(multi_pod)
    assert system.n_chips == (512 if multi_pod else 256)
    assert system.topology.dims[0].size == 8
    for shape in cells(arch):
        r = plan.plan_cell(arch, shape, multi_pod, system=system, tp=8)
        assert "error" not in r, (arch, shape, r)
        t = r["iter_time_s"] if "iter_time_s" in r else r["total_time_s"]
        assert math.isfinite(t) and t > 0, (arch, shape, r)
        assert r["tp"] == 8
