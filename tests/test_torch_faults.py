"""Guards for faults the port once had, on the CPU.

* Every config the port runs (all of the reference's) has a head dim and a GQA group (H / Hkv) that the card's attention kernels take:
  ``minitron_4b`` (group 3) could once not decode on the card, and
  ``qwen3_moe_235b`` decodes with group 16. The wrappers' ``supports``
  tables are what their checks on the card consult, so no card is needed.
* No module of the port, and not ``chip_smoke.py`` nor the port's tools,
  imports ``jax`` or the reference package: each file's import statements
  are read from its syntax tree (``import a, b``, imports inside functions,
  ``importlib.import_module("...")`` and ``__import__`` with a literal name).
* AdamW keeps f32 moments whatever the params' dtype, as the reference's
  become at its first update: three steps on bf16 params against
  ``repro.train.optimizer.adamw_update``, moments within 1e-5 (f32, the same
  formula), params at the reference's rtol 2e-2, atol 2e-3.
* Under ``param_dtype="bfloat16"`` the LayerNorm leaves are bf16, as
  ``repro.models.init_params`` casts them, and a checkpoint round-trips the
  values of the changed dtypes.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import init_params
from repro_torch.train import AdamWConfig, CheckpointManager, adamw_init, adamw_update
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------ F1: GQA groups -------------------------------
def _attention_archs() -> list[str]:
    return [a for a in ARCH_IDS if not get_config(a).attention_free]


@pytest.mark.parametrize("arch", _attention_archs())
def test_attention_kernels_take_every_config(arch):
    cfg = get_config(arch)
    assert cfg.n_heads % cfg.n_kv_heads == 0
    n_rep = cfg.n_heads // cfg.n_kv_heads
    assert decode_ops.supports(cfg.hd, n_rep), (arch, cfg.hd, n_rep)
    assert flash_ops.supports(cfg.hd, n_rep), (arch, cfg.hd, n_rep)


def test_group_tables_name_the_groups_that_were_refused():
    # minitron_4b (24/8 heads) and qwen3_moe_235b (64/4), both at hd 128
    assert get_config("minitron_4b").hd == 128
    for n_rep in (3, 16, 5, 7, 12):
        assert decode_ops.supports(128, n_rep)
        assert flash_ops.supports(128, n_rep)
    assert decode_ops.supports(16, 3)          # the SMOKE configs' hd 16
    assert flash_ops.supports(16, 3)


def test_minitron_group3_decodes_like_the_reference():
    """minitron_4b SMOKE (6/2 heads, the group 3 of the published 24/8) in
    f32 on the CPU: prefill and four decode steps against the reference's,
    at the tolerances of the olmo test in test_torch_train.py; then
    run_serve, which once raised at the first decode step on the card."""
    from functools import partial

    from repro_torch.launch.serve import run_serve
    from repro_torch.models import decode_step, params_from_jax_numpy, prefill

    jcfg = dataclasses.replace(jax_get_config("minitron_4b", smoke=True), dtype="float32")
    cfg = dataclasses.replace(get_config("minitron_4b", smoke=True), dtype="float32")
    assert cfg.n_heads // cfg.n_kv_heads == 3
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    b, s, steps = 2, 12, 4
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (b, s + steps)).astype(np.int32)
    jlogits, jcache0 = jt.prefill(jcfg, jparams, jnp.asarray(toks[:, :s]))
    logits, cache = prefill(cfg, params, torch.from_numpy(toks[:, :s]).long(),
                            max_len=s + steps)
    want = np.asarray(jlogits, np.float32)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    jcache = jt.init_cache(jcfg, b, s + steps)
    jcache = {k: jcache[k].at[:, :, :, :s].set(jcache0[k]) for k in jcache}
    jstep = jax.jit(partial(jt.decode_step, jcfg))
    for i in range(steps):
        tok = toks[:, s + i]
        want, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(s + i))
        got, cache = decode_step(cfg, params, cache, torch.from_numpy(tok).long(), s + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
    res = run_serve(get_config("minitron_4b", smoke=True), requests=2,
                    prompt_len=8, tokens=3, device="cpu")
    assert len(res.tokens) == 3


# ------------------------------ the import rule -------------------------------
def _port_files() -> list[Path]:
    return [ROOT / "chip_smoke.py",
            *sorted(f for pat in ("flash_*.py", "ssd_*.py", "decode_*.py",
                                  "model_axis_*.py", "multi_device_*.py")
                    for f in (ROOT / "tools").glob(pat)),
            *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]


def _imported(path: Path) -> list[str]:
    """Absolute module names ``path`` imports, at any depth of its syntax
    tree (relative imports stay inside their package and are left out)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and (getattr(node.func, "attr", None) == "import_module"
                   or getattr(node.func, "id", None) == "__import__")):
            names.append(node.args[0].value)
    return names


def test_port_sources_import_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 40
    bad = [(f.relative_to(ROOT).as_posix(), name) for f in files
           for name in _imported(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_import_reader_sees_every_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os, jax.numpy\n"
                   "def f():\n    from repro.core import x\n"
                   "    import importlib\n"
                   "    importlib.import_module('repro.kernels')\n"
                   "    return __import__('jaxlib')\n"
                   "from . import sibling\n")
    assert _imported(src) == ["os", "jax.numpy", "repro.core", "importlib",
                              "repro.kernels", "jaxlib"]


# ------------------------------ F3: AdamW moments -----------------------------
def _tree(rng, shapes: dict) -> dict:
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("master", [False, True])
def test_adamw_bf16_params_match_reference(master):
    rng = np.random.default_rng(0)
    shapes = {"embed": (16, 8), "w": (8, 12), "norm": (8,)}
    p0 = _tree(rng, shapes)
    grads = [_tree(rng, shapes) for _ in range(3)]
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p0.items()}
    jo, to = jax_adamw_init(jp, master=master), adamw_init(tp, master=master)
    for tree in (to["m"], to["v"]):
        assert all(x.dtype == torch.float32 for x in tree_leaves(tree))
    kw = dict(lr=1e-2, weight_decay=0.1)
    for g in grads:
        jg = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).bfloat16() for k, v in g.items()}
        jp, jo = jax_adamw_update(jp, jg, jo, JaxAdamWConfig(**kw))
        adamw_update(tp, tg, to, AdamWConfig(**kw))
    assert int(to["step"]) == int(jo["step"]) == 3
    for k in shapes:
        for mom in ("m", "v"):
            assert jo[mom][k].dtype == jnp.float32      # promoted by the update
            assert to[mom][k].dtype == torch.float32
            np.testing.assert_allclose(to[mom][k].numpy(), np.asarray(jo[mom][k]),
                                       rtol=1e-5, atol=1e-7)
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32), rtol=2e-2, atol=2e-3)


# ------------------------------ F3: norm leaves -------------------------------
LN_ARCHS = ["minitron_4b", "command_r_35b", "gpt3_175b", "olmo_1b"]


def _dtypes_port(tree, prefix: str = "") -> dict[str, str]:
    if isinstance(tree, torch.Tensor):
        return {prefix: str(tree.dtype).replace("torch.", "")}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_dtypes_port(v, f"{prefix}/{k}" if prefix else k))
    else:                                 # the stack: one dict per block
        for v in tree:
            out.update(_dtypes_port(v, prefix))
    return out


def _dtypes_jax(tree) -> dict[str, str]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): str(x.dtype)
            for path, x in flat}


@pytest.mark.parametrize("arch", LN_ARCHS)
def test_bf16_param_dtypes_match_reference(arch):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype="bfloat16")
    want = _dtypes_jax(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    got = _dtypes_port(init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16))
    assert got == want
    assert set(got.values()) == {"bfloat16"}
    # f32 training and bf16 serving keep the norms f32
    for dtype in (torch.float32, None):
        f32 = _dtypes_port(init_params(get_config(arch, smoke=True), seed=0,
                                       device="cpu", dtype=dtype))
        assert all(v == "float32" for k, v in f32.items()
                   if "/ln" in k or k.startswith("final_norm"))


def test_checkpoint_round_trips_bf16_params_and_f32_moments(tmp_path):
    cfg = dataclasses.replace(get_config("minitron_4b", smoke=True),
                              param_dtype="bfloat16")
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    opt = adamw_init(params, master=True)
    grads = [torch.full_like(p, 0.5) for p in tree_leaves(params)]
    adamw_update(params, tree_unflatten(params, grads), opt, AdamWConfig())
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"params": params, "opt": opt})
    _, tree = mgr.restore(device="cpu")
    assert tree["params"]["final_norm"]["w"].dtype == torch.float32  # stored as f32
    for a, b in zip(tree_leaves(params), tree_leaves(tree["params"])):
        assert a.dtype == torch.bfloat16
        assert torch.equal(b.to(a.dtype), a)                # exact: bf16 in f32
    for mom in ("m", "v", "master"):
        for a, b in zip(tree_leaves(opt[mom]), tree_leaves(tree["opt"][mom])):
            assert a.dtype == b.dtype == torch.float32
            assert torch.equal(a, b)
    assert int(tree["opt"]["step"]) == 1
