"""Dry run of every (arch × shape × mesh) cell without running it: the
port's counterpart of the reference's ``launch/dryrun.py``.

The reference lowers and compiles each cell on 512 placeholder devices and
prices the optimized HLO. The port has no HLO, so it runs rank 0's view of
the cell once on meta tensors (shapes, no data, nothing allocated) inside
a "fake" process group of 256 or 512 ranks (``torch.distributed``'s
``FakeStore``: every collective returns at once), and counts what runs
(``validation/opcount.trace_cost``): the FLOPs and bytes of every op, each
kernel's work through its meta route (``kernels/cost.py``, as the card
runs it, not its plain version), and the collectives by logical kind.

For each cell, cached as JSON under ``results/dryrun_torch/``:
  · bytes a rank of the parameters, the optimizer state and the cache,
    against the H100's 80 GB;
  · FLOPs, bytes and collective bytes a rank, and the collective schedule;
  · the three roofline terms against the H100 constants of
    ``kernels/cost.py`` (and NVLink's link rate);
  · ``plan_cell``'s prediction for TPU v5e pods and for H100 nodes.

Heads that do not divide the model axis: the K/V projections are kept
whole on every rank (``kv_replicate``), and where the query heads do not
divide it either the attention is whole on every rank; each cell records
what it took. A Mamba2 layer whose heads do not divide the axis is whole on
every rank (``models.layers.ssm_split``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--single-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, SHAPES, ShapeSpec, cells, get_config
from ..core.roofline import RooflineTerms
from ..kernels import cost
from ..models import decode_step, forward, init_cache, init_params
from ..models.config import ModelConfig
from ..models.inputs import input_specs
from ..models.transformer import _memory_from_batch, param_dtype
from ..parallel.dist import Mesh
from ..parallel.logical import P, use_rules
from ..systems.chips import NVLINK
from ..train.optimizer import AdamWConfig, adamw_init, tree_leaves
from . import hlocost
from .mesh import make_axis_rules
from .shardings import (batch_shardings, decode_input_shardings,
                        param_shardings, shard_tree)
from ..validation.opcount import trace_cost

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
#: the card's memory a rank's weights, optimizer state and cache must fit
HBM_BYTES = 80e9


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a "fake" process group of ``n`` ranks for the block. The
    default group must be free: a process that runs real collectives runs
    the dry run in a process of its own."""
    if dist.is_initialized():
        raise RuntimeError("the dry run needs the default process group for its "
                           f"fake ranks; this process has joined {dist.get_backend()}")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def cell_rules(cfg: ModelConfig, mesh: Mesh, kv_replicate: bool | None):
    """The cell's axis rules and what they replicate: K/V projections whole
    where the kv heads do not divide the model axis (or as asked), the
    attention whole where the query heads do not either."""
    m = mesh.size("model")
    kv = cfg.n_kv_heads % m != 0 if kv_replicate is None else kv_replicate
    heads = cfg.n_heads % m != 0
    rules = make_axis_rules(mesh, cfg, kv_replicate=kv or heads)
    return rules, {"kv_replicate": bool(kv or heads), "heads_replicate": heads}


def _whole_attention(specs):
    """The spec tree with every attention leaf (``attn``, ``xattn``) whole
    on every rank."""
    if isinstance(specs, list):
        return [_whole_attention(s) for s in specs]
    if not isinstance(specs, dict):
        return specs
    return {k: ({n: P(*(None,) * len(sp)) for n, sp in v.items()}
                if k in ("attn", "xattn") else _whole_attention(v))
            for k, v in specs.items()}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _step(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, rules, fsdp: bool,
          accum: int, bf16_params: bool, heads_whole: bool):
    """(the cell's step as a function of nothing, bytes a rank of params,
    optimizer state and cache, model FLOPs, grad): rank 0's blocks on meta."""
    specs = input_specs(cfg, shape)
    pshard = param_shardings(cfg, mesh, fsdp=fsdp, rules=rules)
    if heads_whole:
        pshard = _whole_attention(pshard)
    params = shard_tree(init_params(cfg, device="meta", dtype=param_dtype(cfg)),
                        pshard, mesh)
    out = {"param_bytes": _bytes(params), "opt_bytes": 0, "cache_bytes": 0}
    if shape.phase == "train":
        from ..train.trainer import make_train_step
        opt = adamw_init(params, master=bf16_params)
        out["opt_bytes"] = _bytes({k: v for k, v in opt.items() if k != "step"})
        step = make_train_step(cfg, AdamWConfig(), accum=accum, fsdp=fsdp)
        tokens = shape.global_batch * shape.seq_len
        return (lambda: step(params, opt, specs), out,
                cfg.model_flops(tokens, training=True), True)
    if shape.phase == "prefill":
        bshard = batch_shardings(cfg, mesh, shape.global_batch)
        batch = shard_tree(specs, {k: bshard[k] for k in specs}, mesh)

        def prefill():
            memory = _memory_from_batch(cfg, params, batch)
            return forward(cfg, params, batch["tokens"], memory=memory)

        tokens = shape.global_batch * shape.seq_len
        return prefill, out, cfg.model_flops(tokens, training=False), False
    ishard = decode_input_shardings(cfg, mesh, shape.global_batch, shape.seq_len)
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    out["cache_bytes"] = _bytes(cache)
    token = shard_tree(specs["token"], ishard["token"], mesh)
    memory = specs.get("memory")
    if memory is not None:
        memory = shard_tree(memory, ishard["memory"], mesh)
    pos = torch.full((1,), shape.seq_len - 1, dtype=torch.int64, device="meta")
    return (lambda: decode_step(cfg, params, cache, token, pos, memory=memory), out,
            cfg.model_flops(shape.global_batch, training=False, decode_kv=shape.seq_len),
            False)


def run_cell(arch: str, shape_name: str, multi_pod: bool, force: bool = False,
             extra_tag: str = "", planner: bool = True, fsdp: bool = False,
             remat: str | None = None, moe_dispatch: str | None = None,
             accum: int = 1, kv_replicate: bool | None = None,
             bf16_params: bool = False, bf16_ar: bool = False,
             cp_decode: bool = False, smoke: bool = False,
             mesh_shape: tuple | None = None, results="cache") -> dict:
    """One cell, rank 0's view on meta tensors in a fake process group of
    the mesh's ranks (the production (16, 16), or (2, 16, 16) with
    ``multi_pod``; ``mesh_shape`` another, ``smoke`` the SMOKE config).
    The knobs as the reference's; the result is cached under ``results``
    (by default :data:`RESULTS`; None: not cached) unless ``force``."""
    if results == "cache":
        results = RESULTS
    opt_tag = "".join(t for t, on in (
        ("__fsdp", fsdp), (f"__remat-{remat}", remat), (f"__moe-{moe_dispatch}", moe_dispatch),
        (f"__accum{accum}", accum > 1), ("__kvrep", kv_replicate),
        ("__bf16", bf16_params), ("__bf16ar", bf16_ar), ("__cpdec", cp_decode),
        ("__smoke", smoke)) if on)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_tag = "x".join(map(str, mesh_shape))
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}__{mesh_tag}{opt_tag}{extra_tag}"
    out_path = None if results is None else results / f"{tag}.json"
    if out_path is not None and out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch, smoke=smoke)
    cfg = dataclasses.replace(
        cfg, remat=remat or cfg.remat, moe_dispatch=moe_dispatch or cfg.moe_dispatch,
        param_dtype="bfloat16" if bf16_params else cfg.param_dtype,
        matmul_out="bf16" if bf16_ar else cfg.matmul_out,
        decode_attn="context_parallel" if cp_decode else cfg.decode_attn)
    shape = SHAPES[shape_name]
    n = math.prod(mesh_shape)
    axes = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
    with fake_world(n):
        mesh = Mesh.build(mesh_shape, axes, "cpu")
        rules, replicated = cell_rules(cfg, mesh, kv_replicate)
        t0 = time.perf_counter()
        with use_rules(rules, mesh):
            fn, mem, model_flops, grad = _step(cfg, shape, mesh, rules, fsdp, accum,
                                               bf16_params, replicated["heads_replicate"])
            t_build = time.perf_counter() - t0
            summary = trace_cost(fn, "meta", grad=grad)
        t_trace = time.perf_counter() - t0 - t_build
    terms = RooflineTerms(
        name=tag, chips=n, hlo_flops=summary.flops * n,
        hlo_bytes=summary.bytes_accessed * n,
        collective_bytes=summary.link_traffic_bytes * n, model_flops=model_flops,
        peak_flops=cost.BF16_FLOP_PER_S, hbm_bw=cost.HBM_BYTES_PER_S,
        link_bw=NVLINK.bandwidth)
    total = mem["param_bytes"] + mem["opt_bytes"] + mem["cache_bytes"]
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod, "n_chips": n,
        "mesh": list(mesh_shape), "smoke": smoke,
        "opts": {"fsdp": fsdp, "remat": cfg.remat, "moe_dispatch": cfg.moe_dispatch,
                 "accum": accum, "bf16_params": bf16_params, "bf16_ar": bf16_ar,
                 "cp_decode": cp_decode, **replicated},
        "build_s": t_build, "trace_s": t_trace,
        "memory": {"bytes_per_device": total, **mem, "hbm_bytes": HBM_BYTES,
                   "fits": total <= HBM_BYTES},
        "cost_per_device": summary.row(),
        "bytes_by_opcode": summary.bytes_by_opcode,
        "collective_schedule": hlocost.collective_schedule(summary),
        "roofline": terms.row(),
    }
    if planner and not smoke:
        from .plan import h100_system, plan_cell
        for key, kw in (("dfmodel_plan", {}),
                        ("dfmodel_plan_h100", {"system": h100_system(multi_pod), "tp": 8})):
            try:
                result[key] = plan_cell(arch, shape_name, multi_pod, **kw)
            except Exception as e:  # planner issues must not fail the dry run
                result[key] = {"error": str(e)}
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=1))
    return result


def run_dryrun(targets: list[tuple[str, str]], pods: list[bool] | None = None,
               force: bool = False, **cell_opts) -> list[dict]:
    """Every (arch, shape) target across the requested pod settings; a
    failing cell records its error and the sweep continues."""
    results: list[dict] = []
    for mp in (pods if pods is not None else [False]):
        for arch, shp in targets:
            try:
                r = run_cell(arch, shp, mp, force=force, **cell_opts)
                rf, mem = r["roofline"], r["memory"]
                print(f"[OK ] {arch:22s} {shp:12s} pod{2 if mp else 1} "
                      f"trace={r['trace_s']:.1f}s "
                      f"GB/rank={mem['bytes_per_device'] / 1e9:.2f} "
                      f"dom={rf['dominant']:10s} "
                      f"tbound={max(rf['t_compute_s'], rf['t_memory_s'], rf['t_collective_s']):.4f}s",
                      flush=True)
            except Exception as e:
                print(f"[FAIL] {arch} {shp} pod{2 if mp else 1}: {e!r}", flush=True)
                r = {"arch": arch, "shape": shp, "multi_pod": mp, "error": repr(e)}
            results.append(r)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: shard params+optimizer over the data axes")
    ap.add_argument("--remat", choices=["full", "dots", "none"])
    ap.add_argument("--moe-dispatch", choices=["gspmd", "shard_map"])
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--kv-replicate", action="store_true", default=None,
                    help="K/V projections whole on every rank (taken anyway "
                         "where the kv heads do not divide the model axis)")
    ap.add_argument("--bf16-params", action="store_true",
                    help="mixed precision: bf16 live params + fp32 master")
    ap.add_argument("--bf16-ar", action="store_true",
                    help="bf16 row-parallel partial-sum all-reduces")
    ap.add_argument("--cp-decode", action="store_true",
                    help="context-parallel decode attention")
    args = ap.parse_args(argv)

    pods = []
    if args.single_pod or not args.multi_pod:
        pods.append(False)
    if args.multi_pod or args.all:
        pods.append(True)
    if args.all:
        targets = [(a, s) for a in ARCH_IDS if a != "gpt3_175b" for s in cells(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        targets = [(args.arch, args.shape)]
    res = run_dryrun(targets, pods=pods, force=args.force, fsdp=args.fsdp,
                     remat=args.remat, moe_dispatch=args.moe_dispatch, accum=args.accum,
                     kv_replicate=args.kv_replicate, bf16_params=args.bf16_params,
                     bf16_ar=args.bf16_ar, cp_decode=args.cp_decode)
    failed = [r for r in res if "error" in r]
    print(f"{len(res) - len(failed)} cells, {len(failed)} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
