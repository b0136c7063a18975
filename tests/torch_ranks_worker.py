"""One gloo rank of ``tests/test_torch_parallel_ranks.py`` (imports nothing
of JAX).

    python tests/torch_ranks_worker.py JOB_DIR RANK WORLD

The test writes ``JOB_DIR/job.json`` (which checks to run, their
arguments) and ``JOB_DIR/inputs.npz`` (weights and inputs, made by the
reference or from numpy seeds); every rank joins one gloo process group
through a ``FileStore`` under ``JOB_DIR``, runs the checks in order (each
builds the meshes it needs over the same four or two ranks) and rank 0
writes ``JOB_DIR/out.npz`` with the results the test holds against the
reference.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import init_ranks, make_axis_rules  # noqa: E402
from repro_torch.launch.shardings import (gather_tree, opt_shardings,  # noqa: E402
                                          param_shardings, shard_tree)
from repro_torch.models import (decode_step, params_from_jax_numpy,  # noqa: E402
                                prefill)
from repro_torch.models.transformer import gather_vocab  # noqa: E402
from repro_torch.parallel.dist import Mesh  # noqa: E402
from repro_torch.parallel.logical import P, use_rules  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402


def mesh_of(shape, names=None) -> Mesh:
    if names is None:
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return Mesh.build(tuple(shape), tuple(names), "cpu")


def tree_from(inputs: dict, prefix: str) -> dict:
    """The numpy leaves under ``prefix/`` back into a nested dict."""
    out: dict = {}
    for key, val in inputs.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] != "~empty~":
            node[parts[-1]] = val
    return out


def cfg_of(job: dict, arch: str | None = None):
    cfg = get_config(arch or job["arch"], smoke=True)
    return dataclasses.replace(cfg, **job.get("change", {}))


# ------------------------------------ checks ---------------------------------
def context_parallel(job, inp, out):
    """o of context_parallel_decode over each rank's block of the cache,
    for each (mesh, kv_len)."""
    from repro_torch.parallel.context import context_parallel_decode
    q, k, v = (torch.from_numpy(inp[n]) for n in ("cp_q", "cp_k", "cp_v"))
    for shape in job["meshes"]:
        mesh = mesh_of(shape)
        fn = context_parallel_decode(mesh, "model", use_kernel=True)
        spec = P(None, None, "model", None)
        ks = shard_tree(k, spec, mesh)
        vs = shard_tree(v, spec, mesh)
        for n in job["kv_lens"]:
            kv = torch.tensor([n], dtype=torch.int32)
            out[f"cp/{shape[1]}/{n}"] = fn(q, ks, vs, kv).numpy()


def moe(job, inp, out):
    """moe_shard_map (no drops) and the capacity dispatch with drops,
    over each mesh: the tokens' rows split over data, the experts over
    model; the outputs gathered back."""
    from repro_torch.models import layers as L
    from repro_torch.parallel.dist import all_gather
    cfg = cfg_of(job, job["moe_arch"])
    p = {k: torch.from_numpy(v) for k, v in tree_from(inp, "moe_p").items()}
    x = torch.from_numpy(inp["moe_x"])
    for shape in job["meshes"]:
        mesh = mesh_of(shape)
        pl = shard_tree(p, {k: P("model", None, None) if v.dim() == 3 else P()
                            for k, v in p.items()}, mesh)
        xl = shard_tree(x, P("data", None, None), mesh)
        dgroup = mesh.group("data")
        with use_rules(make_axis_rules(mesh, cfg), mesh):
            for label, c, cf in (("shard_map", dataclasses.replace(
                    cfg, moe_dispatch="shard_map"), None),
                    ("gspmd_drops", cfg, job["drop_cf"])):
                y = L.moe(pl, xl, c, capacity_factor=cf)
                out[f"moe/{label}/{shape[1]}"] = all_gather(y, 0, dgroup).numpy()


def pipeline(job, inp, out):
    from repro_torch.parallel.pipeline import pipeline_forward
    mesh = mesh_of((4,), ("stage",))
    run = pipeline_forward(mesh, lambda w, x: torch.tanh(x @ w), 4, "stage")
    out["pipeline"] = run(torch.from_numpy(inp["pp_w"]),
                          torch.from_numpy(inp["pp_x"])).numpy()


def _batch(inp, prefix="batch"):
    return {k: torch.from_numpy(v) for k, v in tree_from(inp, prefix).items()}


def train(job, inp, out):
    """One step of the given config over each (mesh, fsdp): the loss, the
    grad norm and the updated parameters gathered whole."""
    cfg = cfg_of(job)
    batch = _batch(inp)
    for shape, fsdp in job["cases"]:
        mesh = mesh_of(shape)
        params = params_from_jax_numpy(cfg, tree_from(inp, "params"), "cpu",
                                       dtype=torch.float32)
        with use_rules(make_axis_rules(mesh, cfg), mesh):
            specs = param_shardings(cfg, mesh, fsdp)
            p = shard_tree(params, specs, mesh, copy=True)
            o = adamw_init(p)
            step = make_train_step(cfg, AdamWConfig(lr=job["lr"]), fsdp=fsdp,
                                   compress_dp_grads=job.get("compress", False))
            _, _, m = step(p, o, batch)
            whole = gather_tree(p, specs, mesh)
        tag = f"train/{'x'.join(map(str, shape))}/{int(fsdp)}"
        out[f"{tag}/loss"] = m["loss"].numpy()
        out[f"{tag}/grad_norm"] = m["grad_norm"].numpy()
        _put(out, f"{tag}/params", whole)


def _put(out, prefix, tree):
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().float().numpy()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _put(out, f"{prefix}/{k}", v)
    else:
        for i, v in enumerate(tree):
            _put(out, f"{prefix}/{i}", v)


def elastic(job, inp, out, job_dir: Path):
    """Two steps on the first mesh with FSDP, a checkpoint of the whole
    arrays, a restore onto the second mesh's blocks, two more steps."""
    cfg = cfg_of(job)
    batches = [_batch(inp, f"elastic_batch{i}") for i in range(4)]
    params = params_from_jax_numpy(cfg, tree_from(inp, "params"), "cpu",
                                   dtype=torch.float32)
    mgr = CheckpointManager(job_dir / "ckpt")
    losses = []
    first, second = (tuple(s) for s in job["elastic_meshes"])
    mesh = mesh_of(first)
    with use_rules(make_axis_rules(mesh, cfg), mesh):
        specs = {"params": param_shardings(cfg, mesh, True),
                 "opt": opt_shardings(cfg, mesh, True)}
        p = shard_tree(params, specs["params"], mesh, copy=True)
        o = adamw_init(p)
        step = make_train_step(cfg, AdamWConfig(lr=job["lr"]), fsdp=True)
        for b in batches[:2]:
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
        whole = gather_tree({"params": p, "opt": o}, specs, mesh)
    if dist.get_rank() == 0:
        mgr.save(2, whole)
    dist.barrier()
    mesh = mesh_of(second)
    with use_rules(make_axis_rules(mesh, cfg), mesh):
        specs = {"params": param_shardings(cfg, mesh, True),
                 "opt": opt_shardings(cfg, mesh, True)}
        _, tree = mgr.restore(2, shardings=specs, device="cpu")
        p, o = tree["params"], tree["opt"]
        o["step"] = o["step"].to(torch.int64)
        step = make_train_step(cfg, AdamWConfig(lr=job["lr"]), fsdp=True)
        for b in batches[2:]:
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
    out["elastic/losses"] = np.array(losses)


def serve(job, inp, out):
    """prefill, then decode steps of the olmoe SMOKE model over a (1, 2)
    mesh; the logits gathered over the vocabulary."""
    cfg = cfg_of(job)
    params = params_from_jax_numpy(cfg, tree_from(inp, "params"), "cpu")
    tokens = torch.from_numpy(inp["serve_tokens"])
    mesh = mesh_of(job["serve_mesh"])
    with use_rules(make_axis_rules(mesh, cfg), mesh):
        p = shard_tree(params, param_shardings(cfg, mesh), mesh, copy=True)
        s = tokens.shape[1] - job["steps"]
        logits, cache = prefill(cfg, p, tokens[:, :s], max_len=job["max_len"])
        out["serve/prefill"] = gather_vocab(cfg, logits).float().numpy()
        for i in range(job["steps"]):
            lg, cache = decode_step(cfg, p, cache, tokens[:, s + i], s + i)
            out[f"serve/decode{i}"] = gather_vocab(cfg, lg).float().numpy()
    for shape in job["engine_meshes"]:     # the engine's greedy tokens
        mesh = mesh_of(shape)
        with use_rules(make_axis_rules(mesh, cfg), mesh):
            p = shard_tree(params, param_shardings(cfg, mesh), mesh, copy=True)
            engine = ServeEngine(cfg, p, max_batch=tokens.shape[0],
                                 max_len=job["max_len"], device="cpu")
            res = engine.generate(tokens[:, :s], n_tokens=job["steps"])
            one = engine.generate(tokens[:1, :s], n_tokens=job["steps"])
        name = f"serve/engine/{'x'.join(map(str, shape))}"
        out[name] = np.array(res.tokens)
        out[f"{name}/one"] = np.array(one.tokens)    # rows the data axes do not split


def _rows(x, mesh):
    """The global batch of a tensor whose rows are this rank's block of the
    data axes (where they split it)."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.parallel.dist import all_gather
    ax = batch_axes(mesh)
    return all_gather(x.contiguous(), 0, mesh.group(ax)) if mesh.size(ax) > 1 else x


def model_axis(job, inp, out):
    """Each arch of ``job["archs"]`` (f32 SMOKE; and each of
    ``job["variants"]``, a SMOKE config changed, on its own meshes) over
    each mesh: the whole
    parameters sharded and gathered back, prefill (the memory, where the
    arch has one, the image embeddings or the encoder's output), the cache
    after prefill gathered whole, decode steps fed the given tokens, and
    one train step (loss, the updated parameters gathered whole)."""
    from repro_torch.launch.shardings import cache_shardings
    from repro_torch.models import encode
    from repro_torch.train.optimizer import tree_leaves
    entries = [(a, cfg_of(job, a), job["meshes"], job.get("kv_replicate_meshes", []))
               for a in job["archs"]]
    entries += [(name, dataclasses.replace(cfg_of(job, v["arch"]), **v["change"]),
                 v["meshes"], []) for name, v in job.get("variants", {}).items()]
    for arch, cfg, meshes, kv_meshes in entries:
        params = params_from_jax_numpy(cfg, tree_from(inp, f"{arch}/params"), "cpu",
                                       dtype=torch.float32)
        tokens = torch.from_numpy(inp[f"{arch}/tokens"]).long()
        src = inp.get(f"{arch}/memory")
        b, n = tokens.shape
        s, steps, max_len = n - job["steps"], job["steps"], job["max_len"]
        runs = [(m, False) for m in meshes] + [(m, True) for m in kv_meshes]
        for shape, kvrep in runs:
            mesh = mesh_of(shape)
            tag = f"{arch}/{'x'.join(map(str, shape))}{'/kvrep' if kvrep else ''}"
            rules = make_axis_rules(mesh, cfg, kv_replicate=kvrep)
            with use_rules(rules, mesh):
                specs = param_shardings(cfg, mesh, rules=rules)
                p = shard_tree(params, specs, mesh, copy=True)
                whole = gather_tree(p, specs, mesh)
                out[f"{tag}/gathered_err"] = np.array(max(
                    float((a - w).abs().max()) for a, w in
                    zip(tree_leaves(whole), tree_leaves(params))))
                direct = params_from_jax_numpy(cfg, tree_from(inp, f"{arch}/params"), "cpu",
                                               dtype=torch.float32, shardings=specs,
                                               mesh=mesh)
                out[f"{tag}/converted_err"] = np.array(max(
                    float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(direct), tree_leaves(p))))
                out[f"{tag}/local_numel"] = np.array(sum(t.numel() for t in tree_leaves(p)))
                if "ckpt_dir" in job:       # a whole checkpoint restored as blocks
                    mgr = CheckpointManager(Path(job["ckpt_dir"]) / tag.replace("/", "_"))
                    if dist.get_rank() == 0:
                        mgr.save(0, params)
                    dist.barrier()
                    _, restored = mgr.restore(0, shardings=specs, device="cpu")
                    out[f"{tag}/restored_err"] = np.array(max(
                        float((a - b).abs().max()) for a, b in
                        zip(tree_leaves(restored), tree_leaves(p))))
                rows = shard_tree(tokens, P(("pod", "data") if len(shape) == 3
                                            else "data", None), mesh)
                memory = None
                if src is not None:
                    memory = shard_tree(torch.from_numpy(src), P(
                        ("pod", "data") if len(shape) == 3 else "data", None, None), mesh)
                    if cfg.is_enc_dec:
                        memory = encode(cfg, p, memory)
                logits, cache = prefill(cfg, p, rows[:, :s], max_len=max_len,
                                        memory=memory)
                out[f"{tag}/prefill"] = _rows(gather_vocab(cfg, logits), mesh).numpy()
                full = gather_tree(cache, cache_shardings(cfg, mesh, b, max_len), mesh)
                for k, v in full.items():
                    out[f"{tag}/cache/{k}"] = v.float().clone().numpy()
                for i in range(steps):
                    lg, cache = decode_step(cfg, p, cache, rows[:, s + i], s + i,
                                            memory=memory)
                    out[f"{tag}/decode{i}"] = _rows(gather_vocab(cfg, lg), mesh).numpy()
                batch = {k: torch.from_numpy(v) for k, v in
                         tree_from(inp, f"{arch}/batch").items()}
                if not kvrep:               # the gradients themselves, gathered
                    from repro_torch.models import loss_fn
                    from repro_torch.train.optimizer import tree_unflatten
                    local = shard_tree(batch, {k: P(("pod", "data") if len(shape) == 3
                                                    else "data", *(None,) * (v.dim() - 1))
                                               for k, v in batch.items()}, mesh)
                    leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
                    grads = torch.autograd.grad(loss_fn(cfg, p, local), leaves)
                    for t in leaves:
                        t.requires_grad_(False)
                    from repro_torch.launch.mesh import batch_axes
                    from repro_torch.parallel.dist import all_reduce
                    from repro_torch.train.trainer import _MeshLayout
                    ba = batch_axes(mesh)
                    if mesh.size(ba) > 1:       # the mean over the data ranks' rows
                        grads = [all_reduce(g, mesh.group(ba)) / mesh.size(ba)
                                 for g in grads]
                    # the router's gradient where the experts are split: each
                    # rank's share of a sum over 'model' (the trainer sums it)
                    partial = _MeshLayout(cfg, mesh, False)._model_partial(p)
                    grads = [all_reduce(g, mesh.group("model")) if part else g
                             for g, part in zip(grads, partial)]
                    whole_g = gather_tree(tree_unflatten(p, list(grads)), specs, mesh)
                    for i, g in enumerate(tree_leaves(whole_g)):
                        out[f"{tag}/grad{i}"] = g.numpy()
                step = make_train_step(cfg, AdamWConfig(lr=job["lr"]))
                p, _, m = step(p, adamw_init(p), batch)
                out[f"{tag}/loss"] = m["loss"].numpy()
                _put(out, f"{tag}/params", gather_tree(p, specs, mesh))


def collectives(job, inp, out):
    """One attention, MLP, MoE and SSM layer's forward over each mesh,
    traced (``validation/opcount.trace_cost``): each collective record as
    (kind, operand bytes, shape, participants, trips), JSON."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    from repro_torch.validation.opcount import trace_cost
    for shape in job.get("meshes_coll", job["meshes"]):
        mesh = mesh_of(shape)
        for kind, arch in job["layers"].items():
            cfg = cfg_of(job, arch)
            with use_rules(make_axis_rules(mesh, cfg), mesh):
                params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
                p = shard_tree(params, param_shardings(cfg, mesh), mesh, copy=True)
                lp = next(lp for lp in p["stack"][0].values()
                          if {"attention": "attn", "mlp": "mlp", "moe": "moe",
                              "ssm": "ssm"}[kind] in lp)
                x = torch.from_numpy(inp["coll_x"][:, :, :cfg.d_model].copy())
                x = shard_tree(x, P(batch_axes(mesh), None, None), mesh)
                rope = L.rope_tables(torch.arange(x.shape[1]), cfg.hd, cfg.rope_theta)
                run = {"attention": lambda: L.self_attention(lp["attn"], x, cfg, rope),
                       "mlp": lambda: L.mlp(lp["mlp"], x, cfg),
                       "moe": lambda: L.moe(lp["moe"], x, cfg),
                       "ssm": lambda: L.ssm_layer(lp["ssm"], x, cfg)}[kind]
                summary = trace_cost(run, "cpu")
            recs = [[r.kind, r.bytes_, r.shape, r.participants, r.trips]
                    for r in summary.collectives]
            out[f"coll/{'x'.join(map(str, shape))}/{kind}"] = np.array(json.dumps(
                {"records": recs, "link": summary.collective_bytes}))


CHECKS = {"context_parallel": context_parallel, "moe": moe,
          "pipeline": pipeline, "train": train, "serve": serve,
          "model_axis": model_axis, "collectives": collectives}


def main(job_dir: str, rank: int, world: int) -> None:
    job_dir = Path(job_dir)
    torch.set_num_threads(1)
    job = json.loads((job_dir / "job.json").read_text())
    with np.load(job_dir / "inputs.npz") as data:
        inp = {k: data[k] for k in data.files}
    store = dist.FileStore(str(job_dir / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    init_ranks("cpu")
    out: dict = {}
    try:
        for name in job["checks"]:
            if name == "elastic":
                elastic(job, inp, out, job_dir)
            else:
                CHECKS[name](job, inp, out)
        if rank == 0:
            np.savez(job_dir / "out.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
