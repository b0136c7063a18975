"""Training through the fused RMSNorm and the SSD scan, and the remat
policies, against the JAX reference on the CPU (the plain versions of the
kernels, through the same autograd Functions the card runs).

Weights come from the reference's ``init_params`` through numpy
(``params_from_jax_numpy``); tokens, image embeddings and the backward's
inputs are seeded in numpy and handed to both. Tolerances are those
``tests/test_torch_train.py`` holds olmo to: f32 loss within 1e-5
relative, every gradient within 1e-4 of its leaf's largest value (both
frameworks sum f32 in other orders), parameters after three AdamW steps at
the reference's rtol 2e-2, atol 2e-3. The norm's and the scan's backward
alone are held in f32 within 1e-5 of the largest value (a handful of f32
operations and sums over one row or chunk); the gated norm's backward in
bf16 bit for bit against torch's autograd of the unfused chain, whose
roundings it follows. The remat policies recompute the same functions:
their losses and gradients agree within 1e-6 relative, 1e-7 absolute.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import transformer as jt
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, fused_rmsnorm_bwd
from repro_torch.kernels.rmsnorm.ref import (fused_rmsnorm_bwd_ref,
                                             fused_rmsnorm_ref)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ops import ssd_chunk
from repro_torch.models import init_params, loss_fn, params_from_jax_numpy
from repro_torch.train import AdamWConfig, adamw_init, make_train_step
from repro_torch.train.optimizer import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

#: every RMSNorm or SSM architecture of the reference
RMSNORM_ARCHS = ["mistral_nemo_12b", "mamba2_130m", "olmoe_1b_7b",
                 "qwen3_moe_235b", "llama32_vision_11b", "jamba_v01_52b"]
B, S = 2, 16
GRAD_REL = 1e-4
REMAT_TOL = dict(rtol=1e-6, atol=1e-7)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_rel(got, want, rel: float) -> None:
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _port_params(cfg, jparams):
    return params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu", dtype=torch.float32)


def _batch(cfg, seed: int, b: int = B, s: int = S):
    """One batch for both packages: tokens and labels, and the VLM's image
    embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    if cfg.family == "vlm":
        emb = rng.standard_normal((b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        jb["image_embeds"], tb["image_embeds"] = jnp.asarray(emb), torch.from_numpy(emb)
    return jb, tb


def _grads(cfg, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads


# ------------------------------ loss and grads --------------------------------
@pytest.mark.parametrize("arch", RMSNORM_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg = _f32(jax_get_config(arch, smoke=True))
    cfg = _f32(get_config(arch, smoke=True))
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    jbatch, batch = _batch(cfg, seed=3)
    jloss, jgrads = jax.value_and_grad(partial(jt.loss_fn, jcfg))(jparams, jbatch)
    calls = ssd_ops.ssd_chunk_bwd_plain.calls
    loss, grads = _grads(cfg, _port_params(cfg, jparams), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = tree_leaves(_port_params(cfg, jgrads))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _close_rel(g, w, GRAD_REL)
    n_ssm = sum(cfg.layer_kind(i % cfg.block_size) == "ssm" for i in range(cfg.n_layers))
    assert ssd_ops.ssd_chunk_bwd_plain.calls - calls == n_ssm


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "mamba2_130m"])
def test_three_train_steps_match_reference(arch):
    jcfg = _f32(jax_get_config(arch, smoke=True))
    cfg = _f32(get_config(arch, smoke=True))
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    opt_cfg = dict(lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**opt_cfg)))
    step = make_train_step(cfg, AdamWConfig(**opt_cfg))
    params = _port_params(cfg, jparams)
    opt = adamw_init(params)
    jp, jo = jparams, jax_adamw_init(jparams)
    for i in range(3):
        jbatch, batch = _batch(cfg, seed=10 + i)
        jp, jo, jm = jstep(jp, jo, jbatch)
        params, opt, m = step(params, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
    assert int(opt["step"]) == int(jo["step"]) == 3
    for got, want in zip(tree_leaves(params), tree_leaves(_port_params(cfg, jp))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-3)


# ------------------------------ the norm's backward ---------------------------
def _norm_inputs(kind: str, t: int = 6, d: int = 40, seed: int = 0) -> dict:
    """Seeded inputs of one norm call and its output gradients, numpy f32:
    the residual form (x, r), the first norm (x alone) or the gated one
    (y, z; z a slice of a wider array, as the model slices in_proj's
    output)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = {"x": f(t, d), "w": (0.5 + rng.random(d)).astype(np.float32),
           "r": f(t, d) if kind == "residual" else None,
           "z": 2 * f(t, 2 * d + 8) if kind == "gated" else None,
           "dh": f(t, d), "dr": None if kind == "gated" else f(t, d)}
    return out


def _jax_norm_vjp(kind: str, inp: dict):
    """jax.vjp of the reference's rmsnorm in the form the port fuses:
    (rmsnorm(x + r, w), x + r), (rmsnorm(x, w), x), or
    rmsnorm(y * silu(z), w). Returns the gradients of (x, w, r or z)."""
    x, w, dh = (jnp.asarray(inp[k]) for k in ("x", "w", "dh"))
    if kind == "gated":
        z = jnp.asarray(inp["z"][:, :x.shape[1]])
        _, vjp = jax.vjp(lambda x, w, z: JL.rmsnorm(x * jax.nn.silu(z), w), x, w, z)
        return vjp(dh)
    dr = jnp.asarray(inp["dr"])
    if kind == "plain":
        _, vjp = jax.vjp(lambda x, w: (JL.rmsnorm(x, w), x), x, w)
        return (*vjp((dh, dr)), None)
    r = jnp.asarray(inp["r"])
    _, vjp = jax.vjp(lambda x, w, r: (JL.rmsnorm(x + r, w), x + r), x, w, r)
    return vjp((dh, dr))


def _torch_args(inp: dict, dtype=torch.float32):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in inp.items()}
    d = t["x"].shape[1]
    z = None if t["z"] is None else t["z"].to(dtype)[:, :d]
    x = t["x"] if z is not None else t["x"].to(dtype)
    return dict(dh=t["dh"].to(dtype), dr=None if t["dr"] is None else t["dr"].to(dtype),
                x=x, w=t["w"], residual=None if t["r"] is None else t["r"].to(dtype),
                gate=z)


@pytest.mark.parametrize("kind", ["residual", "plain", "gated"])
def test_rmsnorm_bwd_ref_matches_jax_vjp(kind):
    inp = _norm_inputs(kind)
    want = _jax_norm_vjp(kind, inp)
    a = _torch_args(inp)
    dx, d2, dw = fused_rmsnorm_bwd_ref(a["dh"], a["dr"], a["x"], a["w"],
                                       a["residual"], 1e-6, a["gate"])
    _close_rel(dx, want[0], 1e-5)
    _close_rel(dw, want[1], 1e-5)
    if kind == "plain":
        assert d2 is None
    else:
        assert d2.shape == a["x"].shape and d2.is_contiguous()
        _close_rel(d2, want[2], 1e-5)


@pytest.mark.parametrize("kind", ["residual", "plain", "gated"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_ref_matches_autograd_of_the_plain_forward(kind, dtype):
    """The explicit backward against torch's autograd of
    ``fused_rmsnorm_ref``: f32 within 1e-5 of the largest value; bf16 bit
    for bit (the same roundings: the casts, the chain's products and SiLU's
    backward rounded to bf16, the norm's sums in f32)."""
    a = _torch_args(_norm_inputs(kind, seed=1), dtype)
    names = [n for n in ("x", "w", "residual", "gate") if a[n] is not None]
    leaves = {n: a[n].clone().requires_grad_(True) for n in names}
    h, r = fused_rmsnorm_ref(leaves["x"], leaves["w"], leaves.get("residual"), 1e-6,
                             gate=leaves.get("gate"))
    outs, cots = [h], [a["dh"]]
    if r is not None:
        outs.append(r)
        cots.append(a["dr"])
    auto = dict(zip(names, torch.autograd.grad(outs, list(leaves.values()), cots)))
    dx, d2, dw = fused_rmsnorm_bwd_ref(a["dh"], a["dr"], a["x"], a["w"],
                                       a["residual"], 1e-6, a["gate"])
    got = {"x": dx, "w": dw, "residual": d2, "gate": d2}
    for n in names:
        assert got[n].dtype == auto[n].dtype
        if dtype == torch.bfloat16:
            assert torch.equal(got[n], auto[n]), n
        else:
            _close_rel(got[n], auto[n], 1e-5)


@pytest.mark.parametrize("kind", ["residual", "plain", "gated"])
def test_fused_rmsnorm_function_wiring(kind):
    """``fused_rmsnorm`` under autograd goes through its Function on the
    CPU as on the card: its gradients are the explicit backward's, the new
    residual's gradient reaches x (and r), the gate's comes back in its
    strided slice's shape, w's once; under no_grad nothing is recorded."""
    a = _torch_args(_norm_inputs(kind, seed=2))
    wide = None
    names = ["x", "w"] + (["residual"] if kind == "residual" else [])
    leaves = {n: a[n].clone().requires_grad_(True) for n in names}
    if kind == "gated":
        wide = torch.from_numpy(_norm_inputs(kind, seed=2)["z"]).requires_grad_(True)
        gate = wide[:, :a["x"].shape[1]]
    else:
        gate = None
    h, r = fused_rmsnorm(leaves["x"], leaves["w"], leaves.get("residual"), gate=gate)
    assert h.grad_fn is not None and (r is None) == (kind == "gated")
    outs, cots = [h], [a["dh"]]
    if r is not None:
        outs.append(r)
        cots.append(a["dr"])
    torch.autograd.backward(outs, cots)
    dx, d2, dw = fused_rmsnorm_bwd(a["dh"], a["dr"], a["x"], a["w"], a["residual"],
                                   1e-6, a["gate"])
    torch.testing.assert_close(leaves["x"].grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(leaves["w"].grad, dw, rtol=0, atol=0)
    if kind == "residual":
        torch.testing.assert_close(leaves["residual"].grad, d2, rtol=0, atol=0)
    if kind == "gated":
        d = a["x"].shape[1]
        torch.testing.assert_close(wide.grad[:, :d], d2, rtol=0, atol=0)
        assert not bool(wide.grad[:, d:].any())
    with torch.no_grad():
        h, _ = fused_rmsnorm(leaves["x"], leaves["w"], leaves.get("residual"), gate=gate)
    assert h.grad_fn is None


def test_rmsnorm_bwd_scratch_rows_match_the_source():
    """The wrapper allocates as many scratch rows of dw shares as the
    kernel's grid may have (BWD_MAX_BLOCKS in rmsnorm.cu)."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "rmsnorm" / "csrc"
           / "rmsnorm.cu").read_text()
    assert f"constexpr int BWD_MAX_BLOCKS = {rmsnorm_ops.BWD_MAX_BLOCKS};" in src


# ------------------------------ the scan's backward ---------------------------
@pytest.mark.parametrize("s,with_state", [(128, True), (64, False), (16, True)])
def test_ssd_function_grads_match_jax(s, with_state):
    """The SSD Function's gradients (x, dt, B, C and, through dA, A_log)
    against jax.vjp of the reference's ``_ssd_chunk_scan``, with P != N,
    B/C shared by the heads at head stride 0 (their gradients summed by the
    expand's backward), the final state's gradient given or not."""
    b, h, p, n = 2, 3, 8, 16
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.1 + 0.5 * rng.random((b, s, h))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    a_log = (0.3 * rng.standard_normal(h)).astype(np.float32)
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gh = rng.standard_normal((b, h, p, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: JL._ssd_chunk_scan(*a, chunk=min(128, s)),
                     *(jnp.asarray(v) for v in (xs, dt, bm, cm, a_log)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh if with_state else np.zeros_like(gh))))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (xs, dt, bm, cm, a_log)]
    x, dtt, bt, ct, al = leaves
    calls = ssd_ops.ssd_chunk_bwd_plain.calls
    y, state = ssd_chunk(x, dtt, bt[:, :, None].expand(b, s, h, n),
                         ct[:, :, None].expand(b, s, h, n), dtt * -torch.exp(al))
    outs, cots = [y], [torch.from_numpy(gy)]
    if with_state:
        outs.append(state)
        cots.append(torch.from_numpy(gh))
    got = torch.autograd.grad(outs, leaves, cots)
    assert ssd_ops.ssd_chunk_bwd_plain.calls == calls + 1
    for g, w in zip(got, want):
        _close_rel(g, w, 1e-5)


# ------------------------------ remat ----------------------------------------
REMAT_ARCHS = ["mistral_nemo_12b", "mamba2_130m", "olmoe_1b_7b", "olmo_1b"]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    """full, dots and none on an RMSNorm, an SSM, a MoE and a LayerNorm
    config (the reference's tests/test_perf_knobs.py holds its three
    policies alike)."""
    cfg = _f32(get_config(arch, smoke=True))
    batch = _batch(cfg, seed=5)[1]
    out = {}
    for remat in ("full", "dots", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = _grads(c, init_params(c, seed=0, device="cpu", dtype=torch.float32),
                            batch)
    for remat in ("dots", "none"):
        torch.testing.assert_close(out[remat][0], out["full"][0], **REMAT_TOL)
        for a, b in zip(out[remat][1], out["full"][1]):
            torch.testing.assert_close(a, b, **REMAT_TOL)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "mamba2_130m", "olmo_1b"])
def test_dots_recomputes_no_projection(arch):
    """Under "dots" the backward runs as many ``aten.mm`` as under "none"
    (each projection's two gradient products): the projections' outputs
    are saved, not recomputed; "full" recomputes them and runs more."""
    cfg = _f32(get_config(arch, smoke=True))
    batch = _batch(cfg, seed=6)[1]
    mm = {}
    for remat in ("full", "dots", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        params = init_params(c, seed=0, device="cpu", dtype=torch.float32)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(c, params, batch)
        with _CountMM() as count:
            torch.autograd.grad(loss, leaves)
        mm[remat] = count.mm
    assert mm["dots"] == mm["none"] > 0
    assert mm["full"] > mm["none"]


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "mamba2_130m",
                                  "llama32_vision_11b", "jamba_v01_52b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_norm_and_scan_calls_per_step(arch, remat, monkeypatch):
    """A checkpointed layer runs the norm's and the scan's forward twice:
    the counts chip_smoke.py holds the card's launches to
    (``rmsnorm_train_launches``) are the forwards and backwards the CPU
    runs through the same Functions."""
    counts = {"rmsnorm": 0, "rmsnorm_bwd": 0, "ssd": 0}

    def counted(name, fn):
        def call(*args):
            counts[name] += 1
            return fn(*args)
        return call
    monkeypatch.setattr(rmsnorm_ops, "_forward", counted("rmsnorm", rmsnorm_ops._forward))
    monkeypatch.setattr(rmsnorm_ops, "fused_rmsnorm_bwd",
                        counted("rmsnorm_bwd", rmsnorm_ops.fused_rmsnorm_bwd))
    monkeypatch.setattr(ssd_ops, "_forward", counted("ssd", ssd_ops._forward))
    cfg = dataclasses.replace(_f32(get_config(arch, smoke=True)), remat=remat)
    _grads(cfg, init_params(cfg, seed=0, device="cpu", dtype=torch.float32),
           _batch(cfg, seed=7)[1])
    want = chip_smoke.rmsnorm_train_launches(cfg)
    assert counts == {k: want.get(k, 0) for k in counts}


def test_cpu_training_counts_no_launch():
    """The CPU route of the Functions launches nothing."""
    cfg = _f32(get_config("mamba2_130m", smoke=True))
    reset_launches()
    _grads(cfg, init_params(cfg, seed=0, device="cpu", dtype=torch.float32),
           _batch(cfg, seed=8)[1])
    assert not any(launches().values())
