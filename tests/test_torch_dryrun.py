"""The port's dry run (``repro_torch.launch.dryrun``): rank 0's view of a
cell on meta tensors in a "fake" process group, counted by
``validation/opcount.trace_cost``. Every arch's SMOKE config, every shape
of its cells, on a fake (2, 4) mesh; one production cell on (16, 16);
each kernel's meta route counting ``kernels/cost.py``'s work (a meta flash
call its bytes, not the S x S scores its plain version would write), and
no launch; the CLI writing a cell's JSON. The reference's dry run lowers
on 512 placeholder devices and its multi-device tests are red on this
tree, so the cells are held to their own identities: the parameters'
bytes a rank are the local blocks', the roofline terms follow from the
counts and the H100 constants, and the planner's predictions sit beside
them."""
from __future__ import annotations

import json
import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.kernels import cost
from repro_torch.launch import dryrun
from repro_torch.validation.opcount import count_ops

CELLS = [(a, s) for a in ARCH_IDS for s in cells(a)]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_smoke_cell_on_a_fake_2x4_mesh(arch, shape):
    r = dryrun.run_cell(arch, shape, False, smoke=True, mesh_shape=(2, 4), results=None)
    assert r["n_chips"] == 8 and r["mesh"] == [2, 4]
    cost_ = r["cost_per_device"]
    assert cost_["flops"] > 0 and cost_["bytes_accessed"] > 0
    mem = r["memory"]
    assert mem["param_bytes"] > 0 and mem["fits"]
    assert mem["bytes_per_device"] == mem["param_bytes"] + mem["opt_bytes"] + mem["cache_bytes"]
    assert (mem["opt_bytes"] > 0) == (SHAPES[shape].phase == "train")
    assert (mem["cache_bytes"] > 0) == (SHAPES[shape].phase == "decode")
    rf = r["roofline"]
    assert rf["t_compute_s"] == pytest.approx(cost_["flops"] / cost.BF16_FLOP_PER_S)
    assert rf["t_memory_s"] == pytest.approx(cost_["bytes_accessed"] / cost.HBM_BYTES_PER_S)
    assert rf["dominant"] in ("compute", "memory", "collective")
    # a model axis of 4 splits something in every config: its sums show
    assert r["collective_schedule"] and rf["t_collective_s"] > 0
    cfg = get_config(arch, smoke=True)
    assert r["opts"]["kv_replicate"] == (cfg.n_kv_heads % 4 != 0 or cfg.n_heads % 4 != 0)


def test_production_cell_on_16x16_with_both_plans():
    r = dryrun.run_cell("olmo_1b", "train_4k", False, results=None)
    assert r["n_chips"] == 256 and r["memory"]["fits"]
    assert r["trace_s"] < 20
    for key in ("dfmodel_plan", "dfmodel_plan_h100"):
        assert math.isfinite(r[key]["iter_time_s"]) and r[key]["iter_time_s"] > 0
    assert r["dfmodel_plan"]["tp"] == 16 and r["dfmodel_plan_h100"]["tp"] == 8
    # olmo_1b's 16 heads on 16 ranks: no replication; each rank a 16th of
    # every matrix but the (unsplit) embedding rows' model axis
    assert not r["opts"]["kv_replicate"]
    kinds = {row["kind"] for row in r["collective_schedule"]}
    assert "all-reduce" in kinds


def test_meta_flash_call_counts_the_kernels_bytes():
    """Causal (2, 8, 4096, 128) with 2 kv heads: the kernel's reads and
    writes (``cost.flash_attention``), not the plain version's S x S
    scores; nothing launched."""
    q = torch.empty(2, 8, 4096, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 2, 4096, 128, dtype=torch.bfloat16, device="meta")
    kernels.reset_launches()
    r = count_ops(lambda: kernels.flash_attention(q, k, k), "meta")
    want = cost.flash_attention(2, 8, 2, 4096, 4096, 128, True)
    assert r["bytes"] == want.bytes and r["flops"] == want.flops
    assert r["kernel_launches"] == {"flash_attention": 1}
    assert sum(kernels.launches().values()) == 0
    scores = 2 * 8 * 4096 * 4096 * 4
    assert r["bytes"] < scores


def test_every_kernel_has_a_meta_route():
    m = dict(device="meta")
    bf = dict(dtype=torch.bfloat16, **m)
    q, k = torch.empty(1, 4, 64, 64, **bf), torch.empty(1, 2, 64, 64, **bf)
    lse = torch.empty(1, 4, 64, **m)
    y, z, w = torch.empty(8, 64, **m), torch.empty(8, 64, **bf), torch.empty(64, **m)
    x, dt = torch.empty(1, 64, 2, 32, **m), torch.empty(1, 64, 2, **m)
    calls = {
        "flash_attention_fwd_lse": lambda: kernels.flash_attention_fwd_lse(q, k, k),
        "flash_attention_bwd_dkv": lambda: kernels.flash_attention_bwd_dkv(q, k, k, q, lse, lse),
        "flash_attention_bwd_dq": lambda: kernels.flash_attention_bwd_dq(q, k, k, q, lse, lse),
        "decode_attention": lambda: kernels.decode_attention(q[:, :, 0], k, k, 64),
        "ssd_chunk": lambda: kernels.ssd_chunk(x, dt, torch.empty(1, 64, 2, 16, **m),
                                               torch.empty(1, 64, 2, 16, **m), dt),
        "fused_rmsnorm": lambda: kernels.fused_rmsnorm(z, w, z),
        "fused_rmsnorm_bwd": lambda: kernels.fused_rmsnorm_bwd(z, z, z, w, z),
        "gated_norm_stat": lambda: kernels.gated_norm_stat(y, z, w),
        "gated_norm_apply": lambda: kernels.gated_norm_apply(y, z, w, y[:, 0], 128),
        "gated_norm_bwd_stat": lambda: kernels.gated_norm_bwd_stat(z, y, z, w),
        "gated_norm_bwd_apply": lambda: kernels.gated_norm_bwd_apply(z, y, z, w, y[:, :2], 128),
    }
    kernels.reset_launches()
    for name, fn in calls.items():
        r = count_ops(fn, "meta")
        assert r["kernel_launches"] == {name: 1}, name
        assert r["bytes"] > 0, name
    assert sum(kernels.launches().values()) == 0


def test_cli_writes_a_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    rc = dryrun.main(["--arch", "mistral_nemo_12b", "--shape", "decode_32k"])
    assert rc == 0 and "1 cells, 0 failed" in capsys.readouterr().out
    files = list(tmp_path.glob("mistral_nemo_12b__decode_32k__pod1__16x16.json"))
    assert len(files) == 1
    cell = json.loads(files[0].read_text())
    assert cell["opts"]["kv_replicate"]          # 8 kv heads on 16 ranks
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recompute_in_another_thread_sees_the_mesh(remat):
    """A checkpointed layer recomputes in backward in autograd's thread (a
    CUDA tensor's backward runs there), where the rules installed around
    the forward are not: the recompute must still take this rank's blocks.
    mamba2 SMOKE on meta tensors, a fake (1, 2) mesh, the gradient taken in
    a thread of its own."""
    import dataclasses
    import threading

    from repro_torch.launch.mesh import make_axis_rules
    from repro_torch.launch.shardings import param_shardings, shard_tree
    from repro_torch.models import init_params, loss_fn
    from repro_torch.parallel.dist import Mesh
    from repro_torch.parallel.logical import use_rules
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(get_config("mamba2_130m", smoke=True), remat=remat)
    got = {}
    with dryrun.fake_world(2):
        mesh = Mesh.build((1, 2), ("data", "model"), "cpu")
        rules = make_axis_rules(mesh, cfg)
        with use_rules(rules, mesh):
            p = shard_tree(init_params(cfg, device="meta", dtype=torch.float32),
                           param_shardings(cfg, mesh), mesh)
            leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
            toks = torch.zeros(2, 16, dtype=torch.int64, device="meta")
            loss = loss_fn(cfg, p, {"tokens": toks, "labels": toks})

        def backward():
            try:
                got["grads"] = torch.autograd.grad(loss, leaves)
            except Exception as e:      # noqa: BLE001 (raised in the thread)
                got["error"] = e

        t = threading.Thread(target=backward)
        t.start()
        t.join()
    assert "error" not in got, got.get("error")
    assert [g.shape for g in got["grads"]] == [t.shape for t in leaves]
