"""SSM, hybrid, cross-attention and encoder layers under a model axis, on
gloo ranks on the CPU (``tests/torch_ranks_worker.py``), against one
device; one device against the JAX reference on the same weights; and the
collectives of one attention, MLP, MoE and SSM layer, counted by their
logical kind (``validation/opcount.trace_cost``), against sums by hand.

The four SMOKE configs (``mamba2_130m``, ``jamba_v01_52b``,
``llama32_vision_11b``, ``seamless_m4t_medium``), in f32, over meshes
(1, 2) and (2, 2): the Mamba2 layer splits by heads (``in_proj``'s z, x
and dt columns and the conv's x channels by heads, B and C whole on every
rank), its gated norm over split rows; cross-attention on local heads over
a memory every rank holds whole; the encoder as the decoder. Tolerances
(``tests/test_torch_parallel_ranks.py``'s): forward logits within
rtol/atol 1e-4 of one device, decode steps within 1e-3 (they read the bf16
cache, whose K/V a rank projects from its heads' columns: an f32 sum in
another order may round to the neighbouring bf16 value, one ulp, which
moves a logit by up to ~3e-4); a train step's loss within 1e-2 and
its parameters within rtol 3e-2, atol 3e-3; the gathered parameter tree
equal to the whole one; the cache after prefill gathered whole within one
bf16 ulp (its K/V and conv tail are bf16) and the f32 SSM state within
1e-4. One device against ``repro``: prefill logits within 1e-4, decode
steps through each package's own bf16 cache within 1e-3 (as
``tests/test_torch_cross.py``), the cache after prefill within one bf16
ulp plus 1e-6 (the state 1e-4).
"""
from __future__ import annotations

import dataclasses
import json
from functools import partial

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (decode_step, encode, loss_fn,  # noqa: E402
                                params_from_jax_numpy, prefill)
from repro_torch.train.optimizer import AdamWConfig, adamw_init, tree_leaves  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402
from test_torch_parallel_ranks import F32, LR, _flat, _named_leaves, _spawn  # noqa: E402

ARCHS = ("mamba2_130m", "jamba_v01_52b", "llama32_vision_11b", "seamless_m4t_medium")
#: mamba2 with heads of 128 (2 heads) on a model axis of 4: the heads do not
#: divide it, so the SSM is whole on every rank and out_proj's rows (and the
#: output's columns) split (``layers._ssm_local``), as mamba2_130m's 24
#: heads on the production axis of 16
VARIANTS = {"mamba2_whole": {"arch": "mamba2_130m", "change": {"ssm_head_dim": 128},
                             "meshes": [[1, 4]]}}
B, S, STEPS, MAX_LEN = 4, 8, 3, 12
FWD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2 ** -7, atol=1e-6)


def _cfgs(arch):
    change = {**F32}
    if arch in VARIANTS:
        arch, change = VARIANTS[arch]["arch"], {**F32, **VARIANTS[arch]["change"]}
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **change),
            dataclasses.replace(get_config(arch, smoke=True), **change))


def _data(arch):
    """(reference params, tokens (B, S + STEPS), memory source or None, a
    train batch), from the reference's init and numpy seeds."""
    jcfg, cfg = _cfgs(arch)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng((*ARCHS, *VARIANTS).index(arch))
    toks = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int64)
    src = None
    if cfg.family == "vlm" or cfg.is_enc_dec:
        m = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
        src = rng.standard_normal((B, m, cfg.d_model)).astype(np.float32)
    bt = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int64)
    batch = {"tokens": bt[:, :-1], "labels": bt[:, 1:]}
    if cfg.family == "vlm":
        batch["image_embeds"] = src
    if cfg.is_enc_dec:
        batch["audio_frames"] = src
    return jp, toks, src, batch


def _inputs(arch, data):
    jp, toks, src, batch = data
    out = {**_flat(jax.tree.map(np.asarray, jp), f"{arch}/params"),
           f"{arch}/tokens": toks, **_flat(batch, f"{arch}/batch")}
    if src is not None:
        out[f"{arch}/memory"] = src
    return out


def _one_device(arch, data):
    """The port on one device: prefill logits and cache, decode steps fed
    the tokens, one train step (loss, parameters)."""
    _, cfg = _cfgs(arch)
    jp, toks, src, batch = data
    params = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu",
                                   dtype=torch.float32)
    tokens = torch.from_numpy(toks)
    memory = None if src is None else torch.from_numpy(src)
    if memory is not None and cfg.is_enc_dec:
        memory = encode(cfg, params, memory)
    with torch.no_grad():
        logits, cache = prefill(cfg, params, tokens[:, :S], max_len=MAX_LEN,
                                memory=memory)
        out = {"prefill": logits.numpy(),
               **{f"cache/{k}": v.float().clone().numpy() for k, v in cache.items()}}
        for i in range(STEPS):
            lg, cache = decode_step(cfg, params, cache, tokens[:, S + i], S + i,
                                    memory=memory)
            out[f"decode{i}"] = lg.numpy()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    out["grads"] = [g.numpy() for g in torch.autograd.grad(loss_fn(cfg, params, tbatch),
                                                           leaves)]
    for t in leaves:
        t.requires_grad_(False)
    step = make_train_step(cfg, AdamWConfig(lr=LR))
    p, _, m = step(params, adamw_init(params), tbatch)
    out["loss"] = float(m["loss"])
    out["params"] = dict(_named_leaves(p, "params"))
    out["whole"] = dict(_named_leaves(params, "params"))
    return out


@pytest.fixture(scope="module")
def data():
    return {a: _data(a) for a in (*ARCHS, *VARIANTS)}


@pytest.fixture(scope="module")
def one_device(data):
    return {a: _one_device(a, data[a]) for a in (*ARCHS, *VARIANTS)}


def _job(meshes, ckpt_dir):
    return {"checks": ["model_axis"], "archs": list(ARCHS), "change": F32,
            "lr": LR, "meshes": meshes, "steps": STEPS, "max_len": MAX_LEN,
            "ckpt_dir": str(ckpt_dir)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data):
    """(1, 2) on two gloo ranks, (2, 2) on four; the collectives of one
    layer of each kind on (1, 2), (2, 2) and (2, 1, 2)."""
    inputs = {k: v for a in (*ARCHS, *VARIANTS) for k, v in _inputs(a, data[a]).items()}
    inputs["coll_x"] = np.random.default_rng(9).standard_normal((4, 8, 128)).astype(np.float32)
    layers = {"attention": "olmo_1b", "mlp": "olmo_1b", "moe": "olmoe_1b_7b",
              "ssm": "mamba2_130m"}
    ckpt = tmp_path_factory.mktemp("ckpt")
    two = _spawn(tmp_path_factory.mktemp("axis2"), 2,
                 {**_job([[1, 2]], ckpt), "checks": ["model_axis", "collectives"],
                  "kv_replicate_meshes": [[1, 2]],
                  "meshes_coll": [[1, 2]], "layers": layers}, inputs)
    four = _spawn(tmp_path_factory.mktemp("axis4"), 4,
                  {**_job([[2, 2]], ckpt), "checks": ["model_axis", "collectives"],
                   "variants": VARIANTS,
                   "meshes_coll": [[2, 2], [2, 1, 2]], "layers": layers}, inputs)
    return {**two, **four}


MESHES = ("1x2", "2x2", "1x2/kvrep")
CASES = [(a, m) for a in ARCHS for m in MESHES] + [
    (v, "x".join(map(str, m))) for v, x in VARIANTS.items() for m in x["meshes"]]


@pytest.mark.parametrize("arch,mesh", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_prefill_and_decode_on_a_model_axis_match_one_device(ranks, one_device, arch, mesh):
    got, want = ranks, one_device[arch]
    np.testing.assert_allclose(got[f"{arch}/{mesh}/prefill"], want["prefill"], **FWD)
    for i in range(STEPS):
        np.testing.assert_allclose(got[f"{arch}/{mesh}/decode{i}"], want[f"decode{i}"],
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch,mesh", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_cache_after_prefill_gathered_matches_one_device(ranks, one_device, arch, mesh):
    want = one_device[arch]
    keys = [k for k in want if k.startswith("cache/")]
    assert keys
    for k in keys:
        tol = FWD if k == "cache/ssm" else BF16
        np.testing.assert_allclose(ranks[f"{arch}/{mesh}/{k}"], want[k], **tol)


@pytest.mark.parametrize("arch,mesh", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_train_step_on_a_model_axis_matches_one_device(ranks, one_device, arch, mesh):
    want = one_device[arch]
    assert abs(float(ranks[f"{arch}/{mesh}/loss"]) - want["loss"]) < 1e-2
    tag = f"{arch}/{mesh}/params"
    for key, t in want["params"].items():
        np.testing.assert_allclose(ranks[tag + key[len("params"):]], t.numpy(),
                                   rtol=3e-2, atol=3e-3)


GRAD_CASES = [(a, m) for a, m in CASES if not m.endswith("kvrep")]


@pytest.mark.parametrize("arch,mesh", GRAD_CASES, ids=[f"{a}-{m}" for a, m in GRAD_CASES])
def test_gradients_on_a_model_axis_match_one_device(ranks, one_device, arch, mesh):
    """Every leaf's gradient of ``loss_fn`` (f32), this rank's blocks
    gathered whole, within 1e-4 of its largest one-device value: the split
    sums (the split-row norm's backward, the SSM's whole leaves summed over
    'model', the vocab-parallel cross-entropy; the router's share summed
    over 'model' as the trainer sums it) compute one device's gradient,
    not an approximation of it."""
    want = one_device[arch]["grads"]
    for i, w in enumerate(want):
        got = ranks[f"{arch}/{mesh}/grad{i}"]
        err = float(np.abs(got - w).max() / max(np.abs(w).max(), 1e-30))
        assert err <= 1e-4, (i, err)


@pytest.mark.parametrize("arch,mesh", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_gathered_tree_equals_the_whole_one(ranks, one_device, arch, mesh):
    """The segmented SSM split (and every other leaf's) sharded and gathered
    back gives the whole tree bit for bit; each rank holds less."""
    assert float(ranks[f"{arch}/{mesh}/gathered_err"]) == 0.0
    # a checkpoint of the whole tree, restored as this rank's blocks
    # (``CheckpointManager.restore(shardings=...)``), equals the blocks
    assert float(ranks[f"{arch}/{mesh}/restored_err"]) == 0.0
    # and the reference's tree carried over as blocks (models/convert.py)
    assert float(ranks[f"{arch}/{mesh}/converted_err"]) == 0.0
    whole = sum(t.numel() for t in one_device[arch]["whole"].values())
    assert int(ranks[f"{arch}/{mesh}/local_numel"]) < whole


def _ref_chain(arch, data):
    """The reference: prefill logits and cache, then decode steps fed the
    tokens through its bf16 cache."""
    jcfg, _ = _cfgs(arch)
    jp, toks, src, _ = data
    memory = None
    if src is not None:
        memory = jnp.asarray(src)
        if jcfg.is_enc_dec:
            memory = jt.encode(jcfg, jp, memory)
    prompt = jnp.asarray(toks[:, :S].astype(np.int32))
    logits, cache0 = jt.prefill(jcfg, jp, prompt, memory=memory)
    cache = jt.init_cache(jcfg, B, MAX_LEN)
    cache = {k: cache[k].at[:, :, :, :S].set(cache0[k].astype(cache[k].dtype))
             if k in ("k", "v") else cache0[k].astype(cache[k].dtype) for k in cache}
    step = jax.jit(partial(jt.decode_step, jcfg))
    outs = {"prefill": np.asarray(logits),
            **{f"cache/{k}": np.asarray(v, np.float32) for k, v in cache0.items()}}
    for i in range(STEPS):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, S + i].astype(np.int32)),
                         jnp.int32(S + i), memory)
        outs[f"decode{i}"] = np.asarray(lg)
    return outs


@pytest.mark.parametrize("arch", (*ARCHS, *VARIANTS))
def test_one_device_matches_reference(data, one_device, arch):
    want = _ref_chain(arch, data[arch])
    got = one_device[arch]
    np.testing.assert_allclose(got["prefill"], want["prefill"], **FWD)
    for i in range(STEPS):
        np.testing.assert_allclose(got[f"decode{i}"], want[f"decode{i}"],
                                   rtol=1e-3, atol=1e-3)
    for k in (k for k in want if k.startswith("cache/")):
        g = got[k]
        if k in ("cache/k", "cache/v"):
            g = g[:, :, :, :S]
        tol = FWD if k == "cache/ssm" else BF16
        np.testing.assert_allclose(g, want[k], **tol)


# ------------------------------- collectives ---------------------------------
def _records(ranks, mesh, kind):
    return json.loads(str(ranks[f"coll/{mesh}/{kind}"]))


def _by_hand(mesh, kind):
    """(kind, operand bytes, participants) of each collective one forward of
    the layer issues on a rank, in order: f32 SMOKE widths, x (4, 8, 128)
    with its rows split over the data axes; the row-parallel partial sums
    all-reduced in f32 (``matmul_out`` "f32")."""
    data = {"1x2": 1, "2x2": 2, "2x1x2": 2}[mesh]
    t = 4 // data * 8                       # this rank's tokens
    if kind == "ssm":                       # mamba2 SMOKE, d 128
        return [("all-reduce", t * 4, 2),           # the split norm's row sums
                ("all-reduce", t * 128 * 4, 2)]     # out_proj's partial sums
    if kind == "moe":                       # olmoe SMOKE, capacity dispatch
        e = get_config("olmoe_1b_7b", smoke=True).moe_experts
        d = get_config("olmoe_1b_7b", smoke=True).d_model
        gather = [("all-gather", e * 8, data)] if data > 1 else []
        return gather + [("all-reduce", t * d * 4, 2)]
    d = get_config("olmo_1b", smoke=True).d_model
    return [("all-reduce", t * d * 4, 2)]   # wo's (or the MLP's wo's) sums


@pytest.mark.parametrize("mesh", ("1x2", "2x2", "2x1x2"))
@pytest.mark.parametrize("kind", ("attention", "mlp", "moe", "ssm"))
def test_collectives_by_logical_kind_match_sums_by_hand(ranks, mesh, kind):
    """The gathers over gloo travel as all-reduces of zero-padded blocks;
    the summary counts them as the gathers they are."""
    rec = _records(ranks, mesh, kind)
    got = [(k, n, parts) for k, n, _, parts, trips in rec["records"] for _ in range(trips)]
    want = _by_hand(mesh, kind)
    assert got == want
    link = {}
    for k, n, parts in want:
        link[k] = link.get(k, 0.0) + (2.0 * n * (parts - 1) / parts if k == "all-reduce"
                                      else n * (parts - 1))
    assert rec["link"] == link


def test_engine_close_releases_its_slots_and_serves_again():
    """``ServeEngine.close`` drops every slot (cache and captured step: a
    graph holding NCCL collectives must be gone before the process group
    is destroyed); the next generate makes its slot again, same tokens."""
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine
    _, cfg = _cfgs("jamba_v01_52b")
    engine = ServeEngine(cfg, init_params(cfg, seed=0, device="cpu"), max_batch=2,
                         max_len=12, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 6)))
    first = engine.generate(prompts, 4).tokens
    assert engine._slots
    engine.close()
    assert not engine._slots
    assert engine.generate(prompts, 4).tokens == first
