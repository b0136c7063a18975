"""The port's multi-device layer over gloo ranks on the CPU, against the JAX
reference's single-device results (the reference's own multi-device tests
are red on this tree: ROADMAP.md queue 3).

Two spawns in all, each a batch of checks run by
``tests/torch_ranks_worker.py`` (which imports nothing of JAX) in four or
two processes that meet through a ``FileStore`` under ``tmp_path``, so
parallel test workers never share a port; each spawn is waited for at
most ``TIMEOUT_S`` and killed past it, so a hung collective fails the test
instead of stalling the suite. Inputs and weights are made here (numpy
seeds, the reference's initialisers) and handed over as an npz; rank 0
hands the results back the same way.

Tolerances: f32 throughout. Context-parallel decode and the pipeline
within the reference's own tests' 1e-4 and 1e-5; the MoE layers within
2e-5 (``tests/test_torch_moe.py``); the olmo_1b SMOKE step against the
reference's ``make_train_step`` at ``tests/test_parallel.py:83``'s
tolerances (loss 1e-2; parameters rtol 3e-2, atol 3e-3) and against the
port's own single rank tightly (loss 1e-5 relative; parameters 1e-4, the
size of an f32 AdamW update of a gradient whose sum order changed); the
elastic restore as ``tests/test_elastic.py`` (rtol 1e-3, atol 1e-4); the
olmoe SMOKE decode as ``tests/test_torch_moe.py`` holds it on one device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params_from_jax_numpy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init, tree_leaves  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_ranks_worker.py"
TIMEOUT_S = 300
LR = 1e-3
F32 = {"dtype": "float32"}


def _flat(tree, prefix: str) -> dict:
    out = {}
    if isinstance(tree, dict):
        if not tree:                    # a non-parametric norm's {}
            out[f"{prefix}/~empty~"] = np.zeros(0, np.uint8)
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    else:
        out[prefix] = np.asarray(tree, np.float32) if np.asarray(tree).dtype.kind == "f" \
            else np.asarray(tree)
    return out


def _spawn(job_dir: Path, world: int, job: dict, inputs: dict) -> dict:
    """Run the worker on ``world`` gloo ranks; rank 0's results."""
    job_dir.mkdir(parents=True, exist_ok=True)
    (job_dir / "job.json").write_text(json.dumps(job))
    np.savez(job_dir / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(job_dir), str(r),
                               str(world)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"gloo ranks did not finish within {TIMEOUT_S} s")
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(x[-4000:] for x in logs)
    with np.load(job_dir / "out.npz") as data:
        return {k: data[k] for k in data.files}


def _batch(cfg, seed: int, b: int = 8, s: int = 32):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1)).astype(np.int64)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ----------------------------------- spawn 1 ---------------------------------
@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Four gloo ranks: context-parallel decode at world 2 and 4, the MoE
    dispatches at model 2 and 4, a 4-stage pipeline, the olmo_1b SMOKE
    step on (2, 2) with and without FSDP, and the elastic restore."""
    rng = np.random.default_rng(0)
    jcfg = dataclasses.replace(jax_get_config("olmo_1b", smoke=True), **F32)
    jmoe = dataclasses.replace(jax_get_config("olmoe_1b_7b", smoke=True), **F32)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    moe_p = JL.init_moe(jax.random.PRNGKey(1), jmoe)
    inputs = {
        "cp_q": rng.standard_normal((2, 8, 64)).astype(np.float32),
        "cp_k": rng.standard_normal((2, 2, 64, 64)).astype(np.float32),
        "cp_v": rng.standard_normal((2, 2, 64, 64)).astype(np.float32),
        "moe_x": rng.standard_normal((4, 16, jmoe.d_model)).astype(np.float32),
        "pp_w": (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32),
        "pp_x": rng.standard_normal((8, 2, 16)).astype(np.float32),
        **_flat(jax.tree.map(np.asarray, jp), "params"),
        **_flat(jax.tree.map(np.asarray, moe_p), "moe_p"),
        **_flat(_batch(jcfg, 5), "batch"),
    }
    for i in range(4):
        inputs.update(_flat(_batch(jcfg, 20 + i), f"elastic_batch{i}"))
    job = {"checks": ["context_parallel", "moe", "pipeline", "train", "elastic"],
           "arch": "olmo_1b", "change": F32, "lr": LR,
           "meshes": [[2, 2], [1, 4]], "kv_lens": [5, 16, 32, 64],
           "cases": [[[2, 2], False], [[2, 2], True], [[2, 1, 2], True]],
           "elastic_meshes": [[2, 2], [1, 4]], "drop_cf": 1.0,
           "moe_arch": "olmoe_1b_7b"}
    out = _spawn(tmp_path_factory.mktemp("four"), 4, job, inputs)
    return {"out": out, "inputs": inputs, "jp": jp, "jcfg": jcfg,
            "moe_p": moe_p, "jmoe": jmoe}


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("kv_len", [5, 16, 32, 64])
def test_context_parallel_decode_matches_whole_cache(four_ranks, model, kv_len):
    """kv_len inside the first shard, on a shard boundary and at Smax."""
    inp = four_ranks["inputs"]
    want = np.asarray(jax_decode_ref(jnp.asarray(inp["cp_q"]), jnp.asarray(inp["cp_k"]),
                                     jnp.asarray(inp["cp_v"]), kv_len))
    np.testing.assert_allclose(four_ranks["out"][f"cp/{model}/{kv_len}"], want,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model", [2, 4])
def test_moe_shard_map_and_mesh_dispatch_match_reference(four_ranks, model):
    """moe_shard_map (experts split over model, routing over each rank's
    rows; the SMOKE capacity factor drops nothing) and the capacity
    dispatch over the mesh at a factor that drops: the reference's ``moe``
    on one device over the whole batch."""
    jcfg, p = four_ranks["jmoe"], four_ranks["moe_p"]
    x = jnp.asarray(four_ranks["inputs"]["moe_x"])
    out = four_ranks["out"]
    np.testing.assert_allclose(out[f"moe/shard_map/{model}"],
                               np.asarray(JL.moe(p, x, jcfg)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out[f"moe/gspmd_drops/{model}"],
                               np.asarray(JL.moe(p, x, jcfg, capacity_factor=1.0)),
                               rtol=2e-5, atol=2e-5)


def test_pipeline_forward_matches_sequential(four_ranks):
    inp = four_ranks["inputs"]
    ref = inp["pp_x"]
    for s in range(4):
        ref = np.tanh(ref @ inp["pp_w"][s])
    np.testing.assert_allclose(four_ranks["out"]["pipeline"], ref, rtol=1e-5, atol=1e-5)


def _port_single_step(cfg, jp, batch):
    params = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                                   dtype=torch.float32)
    step = make_train_step(cfg, AdamWConfig(lr=LR))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    params, _, m = step(params, adamw_init(params), b)
    return params, m


@pytest.mark.parametrize("mesh, fsdp", [("2x2", False), ("2x2", True), ("2x1x2", True)])
def test_sharded_train_step_matches_single_device(four_ranks, mesh, fsdp):
    """(2, 2) with and without FSDP, and (pod, data, model) = (2, 1, 2)
    with FSDP over the two data axes' group."""
    jcfg, jp = four_ranks["jcfg"], four_ranks["jp"]
    cfg = dataclasses.replace(get_config("olmo_1b", smoke=True), **F32)
    batch = _batch(jcfg, 5)
    out = four_ranks["out"]
    tag = f"train/{mesh}/{int(fsdp)}"
    got = [out[k] for k in sorted(k for k in out if k.startswith(f"{tag}/params/"))]
    # the reference's single-device step, at tests/test_parallel.py's tolerances
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(lr=LR)))
    jp2, _, jm = jstep(jp, jax_adamw_init(jp), {k: jnp.asarray(v.astype(np.int32))
                                               for k, v in batch.items()})
    assert abs(float(out[f"{tag}/loss"]) - float(jm["loss"])) < 1e-2
    want = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jp2), device="cpu",
                                 dtype=torch.float32)
    names = sorted(k for k in out if k.startswith(f"{tag}/params/"))
    by_name = dict(zip(names, got))
    for key, t in _named_leaves(want, f"{tag}/params"):
        np.testing.assert_allclose(by_name[key], t.numpy(), rtol=3e-2, atol=3e-3)
    # the port's own single rank, tightly
    single, m = _port_single_step(cfg, jp, batch)
    assert float(out[f"{tag}/loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    assert float(out[f"{tag}/grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=1e-4)
    for key, t in _named_leaves(single, f"{tag}/params"):
        np.testing.assert_allclose(by_name[key], t.numpy(), rtol=0, atol=1e-4)


def _named_leaves(tree, prefix):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}")


def test_elastic_restore_continues_as_an_unsharded_run(four_ranks):
    """Two FSDP steps on (2, 2), a checkpoint of whole arrays, restored onto
    (1, 4)'s blocks, two more steps: the losses of four unsharded steps."""
    jcfg, jp = four_ranks["jcfg"], four_ranks["jp"]
    cfg = dataclasses.replace(get_config("olmo_1b", smoke=True), **F32)
    params = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                                   dtype=torch.float32)
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=LR))
    ref = []
    for i in range(4):
        b = {k: torch.from_numpy(v) for k, v in _batch(jcfg, 20 + i).items()}
        params, opt, m = step(params, opt, b)
        ref.append(float(m["loss"]))
    np.testing.assert_allclose(four_ranks["out"]["elastic/losses"], ref,
                               rtol=1e-3, atol=1e-4)


# ----------------------------------- spawn 2 ---------------------------------
S, STEPS = 8, 4


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """olmoe SMOKE in f32 on (1, 2) with moe_dispatch="shard_map" and
    decode_attn="context_parallel": prefill, then four decode steps of
    given tokens; the reference's prefill and decode_step alike."""
    change = {**F32, "moe_dispatch": "shard_map", "decode_attn": "context_parallel"}
    jcfg = dataclasses.replace(jax_get_config("olmoe_1b_7b", smoke=True), **change)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, S + STEPS)).astype(np.int64)
    job = {"checks": ["serve"], "arch": "olmoe_1b_7b", "change": change,
           "serve_mesh": [1, 2], "steps": STEPS, "max_len": S + STEPS,
           "engine_meshes": [[1, 2], [2, 1]]}
    inputs = {**_flat(jax.tree.map(np.asarray, jp), "params"), "serve_tokens": tokens}
    out = _spawn(tmp_path_factory.mktemp("two"), 2, job, inputs)
    # the reference on one device: no mesh, so its own dispatch and decode
    logits, cache0 = jt.prefill(jcfg, jp, jnp.asarray(tokens[:, :S].astype(np.int32)))
    cache = jt.init_cache(jcfg, 2, S + STEPS)
    cache = {k: cache[k].at[:, :, :, :S].set(cache0[k]) for k in cache}
    step = jax.jit(partial(jt.decode_step, jcfg))
    want = {"serve/prefill": np.asarray(logits)}
    for i in range(STEPS):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, S + i].astype(np.int32)),
                         jnp.int32(S + i))
        want[f"serve/decode{i}"] = np.asarray(lg)
    return out, want


def test_olmoe_decode_on_two_ranks_matches_reference(two_ranks):
    """Experts and heads split over the model axis, the cache's sequence
    too; the prefill logits within 1e-4, each decode step's within 1e-3 (a
    decode chain's f32 tolerance on one device) and the same greedy
    token."""
    out, want = two_ranks
    np.testing.assert_allclose(out["serve/prefill"], want["serve/prefill"],
                               rtol=1e-4, atol=1e-4)
    for i in range(STEPS):
        got, ref = out[f"serve/decode{i}"], want[f"serve/decode{i}"]
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_engine_over_a_mesh_gives_the_single_device_tokens(two_ranks):
    """ServeEngine inside use_rules on (1, 2) (heads, experts, vocabulary
    and the cache's sequence split) and on (2, 1) (each rank serves its
    row of the batch, the tokens gathered; a batch of one, which the data
    axis does not split, served whole by each rank and returned once): the
    greedy tokens of the port's engine on one device."""
    out, _ = two_ranks
    change = {**F32, "moe_dispatch": "shard_map", "decode_attn": "context_parallel"}
    jcfg = dataclasses.replace(jax_get_config("olmoe_1b_7b", smoke=True), **change)
    cfg = dataclasses.replace(get_config("olmoe_1b_7b", smoke=True), **change)
    params = params_from_jax_numpy(cfg, jax.tree.map(
        np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0))), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, S + STEPS))
    engine = ServeEngine(cfg, params, max_batch=2, max_len=S + STEPS, device="cpu")
    res = engine.generate(torch.from_numpy(tokens[:, :S]), STEPS)
    one = engine.generate(torch.from_numpy(tokens[:1, :S]), STEPS)
    for mesh in ("1x2", "2x1"):
        np.testing.assert_array_equal(out[f"serve/engine/{mesh}"], np.array(res.tokens))
        np.testing.assert_array_equal(out[f"serve/engine/{mesh}/one"], np.array(one.tokens))
