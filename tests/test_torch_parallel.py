"""The port's multi-device layer against the JAX reference, on the CPU,
without processes: the sharding specs, int8 gradient compression, the
log-sum-exp combine of context-parallel decode, the input specs, and the
two faults repaired with it (``moe_dispatch="shard_map"`` and
``compress_dp_grads=True`` on one device, which the port refused and the
reference computes).

The reference's spec functions read only ``mesh.axis_names`` and
``mesh.devices.shape``, so they get a stand-in mesh and no JAX devices;
their ``NamedSharding`` wrapper is replaced by one that keeps the spec.
Gloo ranks are in ``tests/test_torch_parallel_ranks.py``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.experimental

# The reference kernel package imports ``jax.experimental.enable_x64``,
# which jax 0.9 dropped; alias it before ``repro.kernels`` is imported.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.launch.shardings as jsh  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import inputs as jinputs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.parallel import compression as jcomp  # noqa: E402
from repro.parallel import logical as jlogical  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shardings as tsh  # noqa: E402
from repro_torch.models import forward, init_params, params_from_jax_numpy  # noqa: E402
from repro_torch.models import inputs as tinputs  # noqa: E402
from repro_torch.models.layers import ssm_split  # noqa: E402
from repro_torch.parallel import compression as tcomp  # noqa: E402
from repro_torch.parallel import context as tcontext  # noqa: E402
from repro_torch.parallel.dist import Mesh  # noqa: E402
from repro_torch.parallel.logical import (AxisRules, P, current_mesh,  # noqa: E402
                                          param_spec, shard, use_rules)
from repro_torch.train.optimizer import AdamWConfig, adamw_init, tree_leaves  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

MESHES = [(2, 4), (16, 16), (2, 16, 16)]


class _StandInMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape):
        self.axis_names = (("data", "model") if len(shape) == 2
                           else ("pod", "data", "model"))
        self.devices = np.empty(shape)
        self.shape = dict(zip(self.axis_names, shape))


class _Kept:
    """The reference's NamedSharding, keeping the spec (not a pytree)."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.fixture
def ref_specs(monkeypatch):
    monkeypatch.setattr(jsh, "NamedSharding", _Kept)
    return jsh


def _norm(spec, ndim: int) -> tuple:
    """A spec's entries padded with None to the leaf's rank; a tuple of one
    axis name stands for that name (JAX and the port write either)."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, (tuple, list)):
            e = tuple(e) if len(e) > 1 else e[0]
        out.append(e)
    return tuple(out)


def _ref_leaves(tree):
    """[(path parts, leaf)] of a reference tree of _Kept or ShapeDtypeStruct."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, _Kept))
    return [([str(getattr(k, "key", getattr(k, "idx", k))) for k in path], leaf)
            for path, leaf in flat]


def _port_leaf(tree, parts, block=None):
    node = tree
    if block is not None:
        node = node[parts[0]][block]
        parts = parts[1:]
    for p in parts:
        node = node[p]
    return node


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    cfg = jax_get_config(arch)
    return cfg, jax.eval_shape(lambda k: jt.init_params(cfg, k),
                               jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch: str):
    return init_params(get_config(arch), device="meta")


def _stacked_fsdp(ref_spec, shape, mesh) -> bool:
    """Whether the reference's FSDP put the data axes on the stacking dim,
    which the port's list of blocks cannot be sharded along."""
    ba = jmesh.batch_axes(mesh)
    return _norm(ref_spec, len(shape))[0] == _norm((ba,), 1)[0]


# ---------------------------------- specs ------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(ref_specs, arch, shape):
    """param_spec (with and without kv_replicate), param_shardings (with and
    without FSDP), opt_shardings, cache_shardings, batch_shardings and
    decode_input_shardings: every leaf's entries equal the reference's, the
    stacked leaves' leading None left out."""
    jm, tm = _StandInMesh(shape), Mesh(shape, _StandInMesh(shape).axis_names)
    jcfg, jshapes = _ref_shapes(arch)
    cfg = get_config(arch)
    tshapes = _port_shapes(arch)
    sizes = dict(zip(jm.axis_names, shape))
    for kv in (False, True):
        jr, tr = jmesh.make_axis_rules(jm, kv_replicate=kv), tmesh.make_axis_rules(tm, kv_replicate=kv)
        assert jr.rules == tr.rules
        for parts, leaf in _ref_leaves(jshapes):
            stacked = parts[0] in ("stack", "enc_stack")
            want = jlogical.param_spec(["stack", *parts[1:]] if stacked else parts,
                                       leaf.shape, jr, sizes)
            local = leaf.shape[1:] if stacked else leaf.shape
            got = param_spec(parts[-1:], local, tr, sizes)
            assert _norm(got, len(local)) == _norm(want, leaf.ndim)[int(stacked):], parts
    n_diff = 0
    for fsdp in (False, True):
        want = jsh.param_shardings(jcfg, jm, fsdp=fsdp)
        got = tsh.param_shardings(cfg, tm, fsdp=fsdp)
        wshapes = dict((tuple(p), l) for p, l in _ref_leaves(jshapes))
        for parts, kept in _ref_leaves(want):
            leaf = wshapes[tuple(parts)]
            stacked = parts[0] in ("stack", "enc_stack")
            blocks = range(leaf.shape[0]) if stacked else [None]
            for b in blocks:
                g = _port_leaf(got, parts, b)
                local = leaf.shape[1:] if stacked else leaf.shape
                if stacked and fsdp and _stacked_fsdp(kept.spec, leaf.shape, jm):
                    n_diff += 1     # the port shards the leaf's own dim
                    want_local = tsh.safe_spec(local, tsh._fsdp_spec(
                        param_spec(parts[-1:], local, tmesh.make_axis_rules(tm), sizes),
                        local, tm), tm)
                    assert g == want_local, parts
                    continue
                assert _norm(g, len(local)) == _norm(kept.spec, leaf.ndim)[int(stacked):], (
                    parts, fsdp)
        opt = tsh.opt_shardings(cfg, tm, fsdp=fsdp, master=True)
        assert opt["m"] == opt["v"] == opt["master"] == got and opt["step"] == P()
    # the stacking-dim case arises only for leaves whose largest dim ties n_blocks
    assert n_diff == 0 or arch in ("mamba2_130m", "jamba_v01_52b")
    for batch in (1, 8, 256):
        wb = jsh.batch_shardings(jcfg, jm, batch)
        gb = tsh.batch_shardings(cfg, tm, batch)
        assert set(wb) == set(gb)
        for k in wb:
            assert _norm(gb[k], len(gb[k])) == _norm(wb[k].spec, len(gb[k])), k
        wc = jsh.cache_shardings(jcfg, jm, batch, 4096)
        gc = tsh.cache_shardings(cfg, tm, batch, 4096)
        assert set(wc) == set(gc)
        for k in wc:
            want_c = _norm(wc[k].spec, len(gc[k]))
            if k == "conv" and not ssm_split(cfg, sizes["model"]):
                # the conv tail's channels follow the SSM's heads (the
                # segmented split): whole where the heads do not divide
                want_c = want_c[:4] + (None,)
            assert _norm(gc[k], len(gc[k])) == want_c, k
        wd = jsh.decode_input_shardings(jcfg, jm, batch, 4096)
        gd = tsh.decode_input_shardings(cfg, tm, batch, 4096)
        assert set(wd) == set(gd)
        assert _norm(gd["token"], 1) == _norm(wd["token"].spec, 1)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_safe_and_fsdp_spec_match_reference(shape):
    jm = _StandInMesh(shape)
    tm = Mesh(shape, jm.axis_names)
    from jax.sharding import PartitionSpec as JP
    ba = jmesh.batch_axes(jm)
    rng = np.random.default_rng(0)
    for _ in range(200):
        dims = tuple(int(x) for x in rng.choice([1, 2, 3, 4, 8, 16, 24, 32, 48, 64, 512],
                                                size=rng.integers(1, 4)))
        options = [None, "model", "data", ba]
        entries = [options[rng.choice(4, p=[0.5, 0.2, 0.15, 0.15])] for _ in dims]
        want = jmesh.safe_spec(dims, JP(*entries), jm)
        got = tmesh.safe_spec(dims, P(*entries), tm)
        assert _norm(got, len(dims)) == _norm(want, len(dims))
        clean = [e if e != ba and e != "data" else None for e in entries]
        assert _norm(tsh._fsdp_spec(P(*clean), dims, tm), len(dims)) == \
            _norm(jsh._fsdp_spec(JP(*clean), dims, jm), len(dims))


def test_shard_is_a_no_op_without_rules_and_checks_the_rank_with_them():
    x = torch.zeros(2, 3)
    assert shard(x, "batch", None, "x") is x       # no rules: nothing read
    assert current_mesh() is None
    rules = tmesh.make_axis_rules(Mesh((2, 4), ("data", "model")))
    with use_rules(rules):
        assert shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank-2"):
            shard(x, "batch")
    assert AxisRules({"a": "model"}).spec("a", None, "b") == P("model", None, None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """train_batch_specs / decode_specs / input_specs: the reference's
    shapes for every cell (token ids int64 and the position (1,) in the
    port); nothing allocated."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for name, shape in SHAPES.items():
        want = jinputs.input_specs(jcfg, JSHAPES[name])
        got = tinputs.input_specs(cfg, shape)
        assert set(got) == set(want), name
        for k in want:
            if k == "cache":
                assert set(got[k]) == set(want[k])
                for c in want[k]:
                    assert tuple(got[k][c].shape) == want[k][c].shape
                    assert got[k][c].device.type == "meta"
            elif k == "pos":
                assert tuple(got[k].shape) == (1,)
            else:
                assert tuple(got[k].shape) == want[k].shape, (name, k)
                assert got[k].device.type == "meta"


# -------------------------------- compression --------------------------------
@pytest.mark.parametrize("n, block", [(1, 256), (255, 256), (256, 256), (257, 256),
                                      (1000, 64), (4096, 256)])
def test_quantize_int8_bit_identical_to_reference(n, block):
    rng = np.random.default_rng(n)
    g = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 50.0], n)).astype(np.float32)
    g[: min(block, n) // 2] = 0.0                   # part of a block zero
    if n >= 2 * block:
        g[block:2 * block] = 0.0                    # an all-zero block
    g = g.reshape(-1, 8) if n % 8 == 0 else g
    jq, js, jshape = jcomp.quantize_int8(jnp.asarray(g), block)
    tq, ts, tshape = tcomp.quantize_int8(torch.from_numpy(g), block)
    assert tuple(jshape) == tshape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcomp.dequantize_int8(tq, ts, tshape).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js, jshape)))


def test_compress_tree_bit_identical_to_reference():
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((3, 100)).astype(np.float32),
            "b": {"c": rng.standard_normal(513).astype(np.float32),
                  "z": np.zeros((4, 4), np.float32)}}
    err = {"a": rng.standard_normal((3, 100)).astype(np.float32) * 1e-3,
           "b": {"c": np.zeros(513, np.float32), "z": np.zeros((4, 4), np.float32)}}
    jc, je = jcomp.compress_tree(jax.tree.map(jnp.asarray, tree),
                                 jax.tree.map(jnp.asarray, err))
    as_t = lambda t: {k: as_t(v) if isinstance(v, dict) else torch.from_numpy(v)  # noqa: E731
                      for k, v in t.items()}
    tc, te = tcomp.compress_tree(as_t(tree), as_t(err))
    for path in (("a",), ("b", "c"), ("b", "z")):
        jn, tn, jen, ten = jc, tc, je, te
        for p in path:
            jn, tn, jen, ten = jn[p], tn[p], jen[p], ten[p]
        np.testing.assert_array_equal(tn[0].numpy(), np.asarray(jn[0]))
        np.testing.assert_array_equal(tn[1].numpy(), np.asarray(jn[1]))
        np.testing.assert_array_equal(ten.numpy(), np.asarray(jen))
    dec = tcomp.decompress_tree(tc)
    np.testing.assert_array_equal(dec["b"]["c"].numpy(),
                                  np.asarray(jcomp.decompress_tree(jc)["b"]["c"]))
    tc0, te0 = tcomp.compress_tree(as_t(tree))            # no errors yet
    jc0, _ = jcomp.compress_tree(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_equal(tc0["a"][0].numpy(), np.asarray(jc0["a"][0]))


# -------------------------------- lse_combine --------------------------------
def _stacked_all_reduce(x, group, op=torch.distributed.ReduceOp.SUM):
    """A stand-in group whose ranks are the leading dim of ``x``."""
    if op == torch.distributed.ReduceOp.MAX:
        return x.amax(0, keepdim=True).expand_as(x)
    return x.sum(0, keepdim=True).expand_as(x)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("kv_len", [1, 100, 128, 257, 512])
def test_lse_combine_over_stacked_shards_matches_whole_cache(monkeypatch, n_shards, kv_len):
    """Each shard's (o, lse) from the plain decode over its block of the
    sequence (its local kv_len on the device, masked past the prefix),
    merged by ``lse_combine``: the reference's decode over the whole cache,
    f32 within 1e-5 (o) — in one, on a boundary, and at S."""
    monkeypatch.setattr(tcontext, "all_reduce", _stacked_all_reduce)
    rng = np.random.default_rng(kv_len)
    b, h, hkv, s, hd = 2, 8, 2, 512, 64
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    want = np.asarray(jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len))
    sl = s // n_shards
    os_, lses = [], []
    for i in range(n_shards):
        local = tcontext._window(kv_len, i, sl, torch.device("cpu"))
        assert int(local) == max(0, min(kv_len - i * sl, sl))
        o, lse = tcontext._local_decode(torch.from_numpy(q),
                                        torch.from_numpy(k[:, :, i * sl:(i + 1) * sl]),
                                        torch.from_numpy(v[:, :, i * sl:(i + 1) * sl]),
                                        local, use_kernel=True)
        live = local > 0
        os_.append(torch.where(live[:, None, None], o, torch.zeros(())))
        lses.append(torch.where(live, lse, -float("inf")))
    got = tcontext.lse_combine(torch.stack(os_), torch.stack(lses), group=None)
    assert torch.isfinite(got).all()
    for i in range(n_shards):
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------ repaired faults ------------------------------
def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def test_shard_map_dispatch_without_mesh_matches_reference_model():
    """moe_dispatch="shard_map" with no mesh: the reference falls back to
    the scatter dispatch (src/repro/models/layers.py:337-343); the port
    now does too (it raised at init and in ``moe``). olmoe_smoke's forward
    in f32 at a capacity factor that drops tokens."""
    change = dict(moe_dispatch="shard_map", moe_capacity_factor=1.0)
    jcfg = dataclasses.replace(_f32(jax_get_config("olmoe_1b_7b", smoke=True)), **change)
    cfg = dataclasses.replace(_f32(get_config("olmoe_1b_7b", smoke=True)), **change)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want = np.asarray(jt.forward(jcfg, jp, jnp.asarray(tokens)))
    got = forward(cfg, params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_compress_dp_grads_step_matches_reference():
    """compress_dp_grads=True on one device: every gradient through int8
    and back, then AdamW, as src/repro/train/trainer.py:70-76 (the port
    raised). Loss as the reference's; parameters within 2.5 lr, the step a
    gradient near a rounding boundary of its int8 block can move by."""
    lr = 1e-3
    jcfg = _f32(jax_get_config("olmo_1b", smoke=True))
    cfg = _f32(get_config("olmo_1b", smoke=True))
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (4, 33)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(lr=lr), compress_dp_grads=True))
    jp2, _, jm = jstep(jp, jax_adamw_init(jp), jb)
    params = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                                   dtype=torch.float32)
    step = make_train_step(cfg, AdamWConfig(lr=lr), compress_dp_grads=True)
    params, _, m = step(params, adamw_init(params), tb)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-3)
    want = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jp2), device="cpu",
                                 dtype=torch.float32)
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2.5 * lr)
    # without compression the same step moves the parameters otherwise
    plain = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                                  dtype=torch.float32)
    make_train_step(cfg, AdamWConfig(lr=lr))(plain, adamw_init(plain), tb)
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(plain),
                                                     tree_leaves(params)))


def test_rank_worker_and_phase_tool_import_neither_jax_nor_the_reference():
    """The gloo ranks' worker and the card's multi-device tool run where no
    JAX is: held to the port's import rule (``tests/test_torch_faults.py``
    reads the imports from each file's syntax tree)."""
    from pathlib import Path

    from test_torch_faults import _imported
    root = Path(__file__).resolve().parents[1]
    files = [root / "tests" / "torch_ranks_worker.py",
             root / "tools" / "multi_device_phases.py"]
    bad = [(f.name, n) for f in files for n in _imported(f)
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
