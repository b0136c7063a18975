"""The port's training attention against the JAX reference, on the CPU.

The plain versions of the forward with LSE and of the FA-2 backward (which
CPU tensors take in place of the CUDA kernels) are held against the
reference's Pallas kernels in interpret mode at the shapes of
tests/test_flash_backward.py, causal and full, f32 within 2e-4 (that
file's tolerance); and ``flash_attention_train``'s gradients against
autograd of the plain forward, also at ragged and GQA shapes the Pallas
kernels do not take. The CUDA kernels are held against these plain
versions on the card by tests/test_torch_gpu.py.
"""
from __future__ import annotations

import jax
import jax.experimental

# The reference kernel package imports ``jax.experimental.enable_x64``,
# which the installed jax no longer has (ROADMAP queue 3): alias it at
# import time, as tests/test_torch_kernels.py does.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.backward import (  # noqa: E402
    flash_attention_bwd as pallas_bwd, flash_attention_fwd_lse as pallas_fwd_lse)
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd_lse, flash_attention_ref,
    flash_attention_train)

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(b, h, hkv, sq, sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, hd), dtype=np.float32),
            rng.standard_normal((b, hkv, sk, hd), dtype=np.float32),
            rng.standard_normal((b, hkv, sk, hd), dtype=np.float32),
            rng.standard_normal((b, h, sq, hd), dtype=np.float32))


@pytest.mark.parametrize("b,h,hkv,s,hd", [
    (1, 4, 4, 256, 64),      # MHA
    (2, 4, 1, 256, 64),      # MQA
    (1, 8, 2, 384, 64),      # GQA, non-power-of-two blocks
    (1, 2, 2, 256, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_fwd_lse_and_bwd_match_pallas(b, h, hkv, s, hd, causal):
    q, k, v, do = _inputs(b, h, hkv, s, s, hd)
    jo, jlse = pallas_fwd_lse(*map(jnp.asarray, (q, k, v)), causal=causal,
                              interpret=True)
    jgrads = pallas_bwd(*map(jnp.asarray, (q, k, v)), jo, jlse,
                        jnp.asarray(do), causal=causal, interpret=True)
    o, lse = flash_attention_fwd_lse(*map(torch.from_numpy, (q, k, v)), causal)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    grads = flash_attention_bwd(*map(torch.from_numpy, (q, k, v)), o, lse,
                                torch.from_numpy(do), causal)
    for got, want in zip((o, lse, *grads), (jo, jlse, *jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,h,hkv,sq,sk,hd,causal", [
    (1, 4, 4, 64, 64, 32, True),
    (2, 8, 2, 100, 100, 64, True),     # ragged, GQA
    (1, 4, 1, 70, 130, 64, False),     # Sq != Sk, full
    (2, 4, 2, 130, 70, 32, True),      # Sq > Sk, causal (top-left)
])
def test_train_grads_match_autograd_of_plain_forward(b, h, hkv, sq, sk, hd,
                                                     causal):
    arrays = _inputs(b, h, hkv, sq, sk, hd, seed=1)
    g = torch.from_numpy(arrays[3])

    def grads(fn):
        q, k, v = (torch.from_numpy(a).requires_grad_(True)
                   for a in arrays[:3])
        out = fn(q, k, v, causal=causal)
        (out * g).sum().backward()
        return out.detach(), q.grad, k.grad, v.grad

    reset_launches()
    got = grads(flash_attention_train)
    want = grads(flash_attention_ref)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), **TOL)
    assert got[2].shape == (b, hkv, sk, hd)
    assert set(launches().values()) == {0}     # CPU tensors: plain versions


def test_train_path_bf16_keeps_dtypes():
    q, k, v, _ = _inputs(1, 4, 2, 96, 96, 32, seed=2)
    q, k, v = (torch.from_numpy(a).bfloat16().requires_grad_(True)
               for a in (q, k, v))
    flash_attention_train(q, k, v).float().sum().backward()
    for t in (q, k, v):
        assert t.grad.dtype == torch.bfloat16
        assert bool(torch.isfinite(t.grad.float()).all())


def test_lse_is_the_softmax_normaliser():
    q, k, v, _ = _inputs(1, 2, 2, 50, 80, 64, seed=3)
    _, lse = flash_attention_fwd_lse(*map(torch.from_numpy, (q, k, v)),
                                     causal=False)
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(64)
    want = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------- the card check's row-by-row comparison and its faults ------
def _load(name, path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_row_check_sees_a_dropped_tile_the_whole_tensor_scale_hides():
    """chip_smoke's row-by-row ratio on a causal forward: one late row with
    a dropped key tile fails it while the whole-tensor ratio stays under
    2e-2; row 0 of dq, zero by cancellation, is held to the floor."""
    from pathlib import Path
    smoke = _load("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    q, k, v, _ = _inputs(1, 2, 2, 2048, 2048, 32, seed=4)
    q, k, v = map(torch.from_numpy, (q, k, v))
    o, _ = flash_attention_fwd_lse(q, k, v, causal=True)
    keep = torch.ones(2048, dtype=torch.bool)
    keep[1024:1088] = False        # the last row loses keys 1024-1087
    s = torch.einsum("bhd,bhkd->bhk", q[:, :, -1], k) / np.sqrt(32)
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
    bad = o.clone()
    bad[:, :, -1] = torch.einsum("bhk,bhkd->bhd", p, v)
    whole, rows = smoke.row_scaled_errs(bad, o)
    assert whole < 2e-2 < rows
    assert smoke.row_scaled_errs(o, o) == (0.0, 0.0)
    zero_row = o.clone()
    zero_row[:, :, 0] = 0.0
    noisy = zero_row.clone()
    noisy[:, :, 0] = 1e-7
    assert smoke.row_scaled_errs(noisy, zero_row)[1] < 1e-3


def test_planted_faults_apply_to_the_kernel_source():
    """Every fault of tools/flash_planted_faults.py finds its text in the
    CUDA source (so an edit of the source cannot silently disarm it) and
    changes the source."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    tool = _load("flash_planted_faults", root / "tools" / "flash_planted_faults.py")
    src = (root / "src" / tool.SOURCE).read_text()
    planted = {name: tool.plant(src, edits) for name, (_, _, edits, _) in tool.FAULTS.items()}
    assert len(set(planted.values())) == len(planted) == 13
    assert all(text != src for text in planted.values())
