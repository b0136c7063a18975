"""The port's LayerNorm/GELU configs and its training path against the JAX
reference, on the CPU (plain versions of the kernels).

Weights come from the reference's ``init_params`` through numpy, tokens
from numpy. Tolerances: f32 logits, loss and per-step losses within 1e-5
relative (both frameworks sum f32 in other orders), gradients within 1e-4
of each leaf's largest value; bf16 logits within 2e-2 of the largest logit
(the reference's bf16 kernel bound on the logits' scale); parameters after
3 AdamW steps at the reference's own rtol 2e-2, atol 2e-3
(tests/test_train.py: Adam's 1/sqrt(v) amplifies rounding on near-zero
gradients). The rest mirrors tests/test_train.py on the port alone.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro.train.data import SyntheticTokens as JaxSyntheticTokens
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_params, loss_fn,
                                param_count, params_from_jax_numpy, prefill,
                                synth_batch)
from repro_torch.models.layers import layernorm, make_norm, mlp
from repro_torch.train import (AdamWConfig, CheckpointManager, Heartbeat,
                               MemmapTokens, StragglerMonitor,
                               SyntheticTokens, adamw_init, adamw_update,
                               cosine_schedule, global_norm, make_train_step,
                               retry_step, train_loop)
from repro_torch.train.optimizer import tree_leaves

LN_ARCHS = ["olmo_1b", "minitron_4b", "command_r_35b", "gpt3_175b"]
B, S = 2, 16


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _tokens(vocab: int, b: int = B, s: int = S, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _port_params(cfg, jparams, dtype=None):
    return params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu", dtype=dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _scaled_err(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close_rel(got, want, rel: float) -> None:
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def olmo():
    """(jax cfg, port cfg, jax params) of the f32 olmo SMOKE config."""
    jcfg = _f32(jax_get_config("olmo_1b", smoke=True))
    return jcfg, _f32(get_config("olmo_1b", smoke=True)), \
        jt.init_params(jcfg, jax.random.PRNGKey(0))


# --------------------------------- configs -----------------------------------
@pytest.mark.parametrize("arch", LN_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference_field_for_field(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", LN_ARCHS)
def test_forward_matches_reference(arch):
    jcfg = jax_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    jparams = jt.init_params(_f32(jcfg), jax.random.PRNGKey(1))
    toks = _tokens(cfg.vocab, seed=1)
    ours = init_params(cfg, seed=0, device="cpu")
    assert param_count(ours) == jt.param_count(jparams)
    exact = jt.forward(_f32(jcfg), jparams, jnp.asarray(toks))
    got = forward(_f32(cfg), _port_params(_f32(cfg), jparams),
                  torch.from_numpy(toks).long())
    _close_rel(got, exact, 1e-5)
    want = jt.forward(jcfg, jparams, jnp.asarray(toks))
    got = forward(cfg, _port_params(cfg, jparams), torch.from_numpy(toks).long())
    assert got.dtype == torch.bfloat16
    assert _scaled_err(got, want) <= 2e-2


def test_olmo_prefill_and_decode_match_reference(olmo):
    jcfg, cfg, jparams = olmo
    params = _port_params(cfg, jparams)
    toks = _tokens(cfg.vocab, s=S + 4, seed=2)
    prompt, steps = toks[:, :S], 4
    jlogits, jcache0 = jt.prefill(jcfg, jparams, jnp.asarray(prompt))
    logits, cache = prefill(cfg, params, torch.from_numpy(prompt).long(),
                            max_len=S + steps)
    _close_rel(logits, jlogits, 1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache[k][:, :, :, :S]),
                                   _np(jcache0[k]), rtol=2 ** -7, atol=0)
    jcache = jt.init_cache(jcfg, B, S + steps)
    jcache = {k: jcache[k].at[:, :, :, :S].set(jcache0[k]) for k in jcache}
    jstep = jax.jit(partial(jt.decode_step, jcfg))
    for i in range(steps):
        tok = toks[:, S + i]
        want, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        got, cache = decode_step(cfg, params, cache,
                                 torch.from_numpy(tok).long(), S + i)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-3, atol=1e-3)


# --------------------------------- layers ------------------------------------
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layernorm_matches_reference(affine, dt):
    from repro.models.layers import layernorm as jax_layernorm
    rng = np.random.default_rng(6)
    x = (3.0 + rng.standard_normal((3, 5, 64))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    args = (w, b) if affine else (None, None)
    want = jax_layernorm(jnp.asarray(x).astype(dt),
                         *(None if a is None else jnp.asarray(a) for a in args))
    got = layernorm(torch.from_numpy(x).to(getattr(torch, dt)),
                    *(None if a is None else torch.from_numpy(a) for a in args))
    assert got.dtype == getattr(torch, dt)
    tol = 2e-2 if dt == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_norm_trees_and_gelu_mlp():
    olmo_cfg = get_config("olmo_1b", smoke=True)
    init, _ = make_norm(olmo_cfg)
    assert init(8, "cpu") == {}
    init, _ = make_norm(get_config("minitron_4b", smoke=True))
    tree = init(8, "cpu")
    assert bool((tree["w"] == 1).all()) and bool((tree["b"] == 0).all())
    from repro.models.layers import mlp as jax_mlp
    rng = np.random.default_rng(7)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("wi", (32, 64)), ("wo", (64, 32)))}
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    want = jax_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                   jax_get_config("olmo_1b", smoke=True))
    got = mlp({k: torch.from_numpy(v) for k, v in p.items()},
              torch.from_numpy(x), olmo_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------ loss and grads --------------------------------
def _batch(cfg, seed: int, b: int = B, s: int = S):
    toks = _tokens(cfg.vocab, b, s + 1, seed)
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()})


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_reference(olmo, masked):
    jcfg, cfg, jparams = olmo
    jbatch, batch = _batch(cfg, seed=3)
    if masked:
        mask = (np.random.default_rng(4).random((B, S)) > 0.3).astype(np.float32)
        jbatch["mask"], batch["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    jloss, jgrads = jax.value_and_grad(partial(jt.loss_fn, jcfg))(jparams, jbatch)
    params = _port_params(cfg, jparams, torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _port_params(cfg, jgrads, torch.float32)
    assert len(tree_leaves(want)) == len(grads) == 13   # embed + 2 x 6
    for g, w in zip(grads, tree_leaves(want)):
        _close_rel(g, w, 1e-4)


def test_three_train_steps_match_reference(olmo):
    jcfg, cfg, jparams = olmo
    opt_cfg = dict(lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**opt_cfg)))
    step = make_train_step(cfg, AdamWConfig(**opt_cfg))
    params = _port_params(cfg, jparams, torch.float32)
    opt = adamw_init(params)
    jp, jo = jparams, jax_adamw_init(jparams)
    for i in range(3):
        jbatch, batch = _batch(cfg, seed=10 + i)
        jp, jo, jm = jstep(jp, jo, jbatch)
        params, opt, m = step(params, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert int(opt["step"]) == int(jo["step"]) == 3
    for got, want in zip(tree_leaves(params),
                         tree_leaves(_port_params(cfg, jp, torch.float32))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-3)


def test_train_step_refuses_forward_only_kernels():
    """Nothing is refused: the RMSNorm and SSM configs train (their
    kernels have a backward), remat "dots" runs, and compressed
    data-parallel gradients on one device are the int8 round trip
    (``tests/test_torch_parallel.py`` holds the step against the
    reference's)."""
    for arch in ("mistral_nemo_12b", "mamba2_130m"):
        make_train_step(get_config(arch, smoke=True))
    make_train_step(get_config("olmo_1b", smoke=True), compress_dp_grads=True)
    cfg = dataclasses.replace(get_config("olmo_1b", smoke=True), remat="dots")
    loss = loss_fn(cfg, init_params(cfg, device="cpu", dtype=torch.float32),
                   _batch(cfg, seed=0)[1])
    assert math.isfinite(float(loss))


def test_remat_full_and_none_give_the_same_gradients():
    cfg = _f32(get_config("olmo_1b", smoke=True))
    batch = _batch(cfg, seed=5)[1]
    out = []
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        params = init_params(c, seed=0, device="cpu", dtype=torch.float32)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        out.append(torch.autograd.grad(loss_fn(c, params, batch), leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ------------------------ the reference's trainer tests -----------------------
def test_grad_accumulation_equivalence():
    """accum=2 gives the update of accum=1 on the same batch."""
    cfg = get_config("olmo_1b", smoke=True)
    batch = synth_batch(cfg, 4, 32, torch.Generator().manual_seed(0))
    out = []
    for accum in (1, 2):
        params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
        p, _, m = make_train_step(cfg, AdamWConfig(lr=1e-3), accum=accum)(
            params, adamw_init(params), batch)
        out.append((float(m["loss"]), tree_leaves(p)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-3)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-2, atol=2e-3)


def test_adamw_grad_clipping():
    params = {"w": torch.ones(4)}
    huge = {"w": torch.full((4,), 1e6)}
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    before = params["w"].clone()
    p2, state = adamw_update(params, huge, adamw_init(params), cfg)
    # post-clip global norm is 1 => the first Adam step is about lr
    assert float((p2["w"] - before).abs().max()) < 1.5
    assert int(state["step"]) == 1


def test_adamw_master_weights_and_weight_decay_on_every_leaf():
    params = {"embed": torch.ones(3, dtype=torch.bfloat16), "n": {}}
    state = adamw_init(params, master=True)
    assert state["m"]["embed"].dtype == torch.float32
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5)
    adamw_update(params, {"embed": torch.zeros(3, dtype=torch.bfloat16),
                          "n": {}}, state, cfg)
    # zero gradient: only the decay moves the weight, 1 - lr * wd
    torch.testing.assert_close(state["master"]["embed"],
                               torch.full((3,), 0.95))
    assert params["embed"].dtype == torch.bfloat16


def test_cosine_schedule_shape():
    fn = cosine_schedule(1.0, warmup=10, total=100)
    assert fn(0) == pytest.approx(0.0)
    assert fn(10) == pytest.approx(1.0, abs=1e-3)
    assert fn(100) == pytest.approx(0.0, abs=1e-6)
    assert fn(55) > fn(90)


def test_global_norm():
    tree = {"a": torch.ones(3), "b": [torch.full((4,), 2.0)]}
    assert float(global_norm(tree)) == pytest.approx(math.sqrt(3 + 16))


def test_checkpoint_roundtrip_keeps_structure(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    cfg = get_config("olmo_1b", smoke=True)
    params = init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(params)
    mgr.save(7, {"params": params, "opt": opt})
    step, tree = mgr.restore(device="cpu")
    assert step == 7
    assert tree["params"]["stack"][0]["l0"]["ln1"] == {}     # the ~empty~ marker
    assert len(tree["params"]["stack"]) == cfg.n_blocks
    for a, b in zip(tree_leaves(params), tree_leaves(tree["params"])):
        np.testing.assert_array_equal(_np(a), _np(b))
    with pytest.raises(ValueError, match="use_rules"):   # no mesh installed
        mgr.restore(shardings={})


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.arange(4)})
    assert mgr.latest_step() == 3
    assert len(sorted(tmp_path.glob("ckpt_*.npz"))) == 2


def test_checkpoint_async_and_atomicity(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    for s in range(3):
        mgr.save_async(s, {"x": torch.full((8,), float(s))})
    mgr.wait()
    assert mgr.latest_step() == 2
    assert not list(tmp_path.glob("*.tmp.npz"))
    _, tree = mgr.restore(2)
    assert float(tree["x"][0]) == 2.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_checkpoint_async_snapshots_a_tree_changed_in_place(tmp_path, dtype):
    """save_async copies the leaves when it is called: the train step
    updates params and moments in place right after."""
    mgr = CheckpointManager(tmp_path)
    tree = {"p": torch.arange(6).to(dtype), "opt": {"m": torch.ones(3, dtype=dtype)}}
    mgr.save_async(1, tree)
    tree["p"].add_(100)
    tree["opt"]["m"].mul_(7)
    mgr.wait()
    _, got = mgr.restore(1)
    np.testing.assert_array_equal(got["p"], np.arange(6))
    np.testing.assert_array_equal(got["opt"]["m"], np.ones(3))


def test_train_loop_checkpoints_and_counts_stragglers(tmp_path):
    cfg = get_config("olmo_1b", smoke=True)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    data = iter(SyntheticTokens(cfg.vocab, 2, 16, seed=0))
    mon = StragglerMonitor()
    mgr = CheckpointManager(tmp_path)
    _, opt, hist = train_loop(cfg, params, data, steps=4, checkpoint_manager=mgr,
                              checkpoint_every=2, straggler_monitor=mon,
                              log_every=0)
    assert len(hist) == 4 and mon.count == 4
    assert all(math.isfinite(h) for h in hist)
    assert mgr.latest_step() == 4 and int(opt["step"]) == 4


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0, warmup=3)
    for step in range(10):
        assert not mon.record(step, 0.1)
    assert mon.record(10, 0.5)
    assert not mon.record(11, 0.1)
    assert mon.straggler_fraction == pytest.approx(1 / 12)


def test_retry_step_restores_and_replays(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"params": {"w": torch.ones(2)}, "opt": {"s": torch.zeros(1)}})
    calls = {"n": 0}

    def flaky(params, opt_state, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("hard fault")
        return params, opt_state, {"loss": torch.tensor(0.0)}

    out = retry_step(flaky, mgr, max_retries=2, device="cpu")(
        {"w": torch.zeros(2)}, {"s": torch.zeros(1)}, None, step=5)
    assert calls["n"] == 2
    assert float(out[0]["w"][0]) == 1.0 and float(out[2]["loss"]) == 0.0


def test_heartbeat_writes(tmp_path):
    Heartbeat(tmp_path / "hb").beat(42)
    assert (tmp_path / "hb").read_text().startswith("42 ")


def test_synthetic_tokens_match_reference():
    a = next(iter(SyntheticTokens(vocab=100, batch=2, seq=8, seed=3)))
    b = next(iter(JaxSyntheticTokens(vocab=100, batch=2, seq=8, seed=3)))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    assert a["labels"].shape == (2, 8) and a["tokens"].dtype == torch.int64


def test_memmap_tokens_rank_sharding_and_resume(tmp_path):
    path = tmp_path / "corpus.bin"
    MemmapTokens.write_corpus(path, n_tokens=100_000, vocab=1000)
    r0 = MemmapTokens(path, batch=2, seq=16, rank=0, world=2)
    r1 = MemmapTokens(path, batch=2, seq=16, rank=1, world=2)
    b0, b1 = next(r0), next(r1)
    assert not torch.equal(b0["tokens"], b1["tokens"])
    b0_next = next(r0)
    fresh = MemmapTokens(path, batch=2, seq=16, rank=0, world=2, start_step=1)
    assert torch.equal(next(fresh)["tokens"], b0_next["tokens"])
    assert torch.equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])


# --------------------------------- launcher ----------------------------------
def test_run_train_needs_a_card_unless_told(monkeypatch):
    from repro_torch.launch.train import run_train
    cfg = get_config("olmo_1b", smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_train(cfg, steps=1, batch=1, seq=8)
    res = run_train(cfg, steps=3, batch=2, seq=16, device="cpu", repeat=True)
    assert len(res.losses) == 3 and res.losses[-1] < res.losses[0]
    assert res.peak_memory_bytes is None and res.device == "cpu"
