"""The split-row gated RMSNorm (``kernels/rmsnorm``: the Mamba2 layer's
gated norm over rows split across the ranks of a model axis) on the CPU:
the plain versions of its four launches, each rank's block of columns with
the row sums added over the ranks in between, against the one-device gated
norm and its backward, within 1e-6 relative in f32; and the autograd
function over a group of one rank against the fused gated norm."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.rmsnorm.ops import (fused_rmsnorm, fused_rmsnorm_bwd,
                                             gated_norm_apply, gated_norm_bwd_apply,
                                             gated_norm_bwd_stat, gated_norm_stat,
                                             split_gated_rmsnorm)
from repro_torch.kernels.rmsnorm.ref import (fused_rmsnorm_bwd_ref, fused_rmsnorm_ref,
                                             gated_norm_stat_ref)

REL = 1e-6


def _inputs(t, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)).to(dtype)
    return y, z, w, dh


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("t,d", [(5, 64), (33, 768), (4, 256)])
def test_split_forward_summed_over_ranks_equals_one_device(ranks, t, d):
    y, z, w, _ = _inputs(t, d, seed=ranks * 100 + t)
    want = fused_rmsnorm_ref(y, w, gate=z)[0]
    blk = d // ranks
    cols = [slice(r * blk, (r + 1) * blk) for r in range(ranks)]
    stats = sum(gated_norm_stat(y[:, c].contiguous(), z[:, c], w[c]) for c in cols)
    got = torch.cat([gated_norm_apply(y[:, c].contiguous(), z[:, c], w[c].contiguous(),
                                      stats, d) for c in cols], 1)
    assert _rel(got, want) <= REL
    assert _rel(stats, gated_norm_stat_ref(y, z)) <= REL


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("t,d", [(5, 64), (33, 768)])
def test_split_backward_summed_over_ranks_equals_one_device(ranks, t, d):
    y, z, w, dh = _inputs(t, d, seed=ranks + t)
    wdx, wdz, wdw = fused_rmsnorm_bwd_ref(dh, None, y, w, gate=z)
    blk = d // ranks
    cols = [slice(r * blk, (r + 1) * blk) for r in range(ranks)]
    stats = sum(gated_norm_bwd_stat(dh[:, c], y[:, c].contiguous(), z[:, c], w[c])
                for c in cols)
    parts = [gated_norm_bwd_apply(dh[:, c], y[:, c].contiguous(), z[:, c],
                                  w[c].contiguous(), stats, d) for c in cols]
    for i, want in enumerate((wdx, wdz, wdw)):
        got = torch.cat([p[i] for p in parts], -1)
        assert _rel(got, want) <= REL, i


def test_split_bf16_gate_matches_the_chain_rounding():
    """With a bf16 gate the blocks' output is the gated norm's, rounded as
    the fused form rounds (one bf16 ulp at most where the f32 sums differ
    in order)."""
    y, z, w, dh = _inputs(16, 512, seed=7, dtype=torch.bfloat16)
    want = fused_rmsnorm_ref(y, w, gate=z)[0].float()
    stats = gated_norm_stat(y[:, :256].contiguous(), z[:, :256], w[:256]) + \
        gated_norm_stat(y[:, 256:].contiguous(), z[:, 256:], w[256:])
    got = torch.cat([gated_norm_apply(y[:, c].contiguous(), z[:, c], w[c].contiguous(),
                                      stats, 512) for c in (slice(0, 256), slice(256, 512))], 1)
    assert got.dtype == torch.bfloat16
    ulp = want.abs().clamp_min(2.0 ** -126) * 2.0 ** -7
    assert bool(((got.float() - want).abs() <= ulp).all())


def test_split_autograd_on_one_rank_equals_fused_gated_norm():
    y, z, w, dh = _inputs(12, 128, seed=3)
    args = [t.clone().requires_grad_(True) for t in (y, w, z)]
    out = split_gated_rmsnorm(args[0], args[1], args[2], None, 128)
    out.backward(dh)
    ref = [t.clone().requires_grad_(True) for t in (y, w, z)]
    want = fused_rmsnorm(ref[0], ref[1], gate=ref[2])[0]
    want.backward(dh)
    assert _rel(out.detach(), want.detach()) <= REL
    for a, b in zip(args, ref):
        assert _rel(a.grad, b.grad) <= REL
    dx, dz, dw = fused_rmsnorm_bwd(dh, None, y, w, gate=z)
    assert _rel(args[0].grad, dx) <= REL and _rel(args[2].grad, dz) <= REL


def test_split_launches_are_wrappers_with_counters():
    names = ("rmsnorm_split_stat", "rmsnorm_split_apply", "rmsnorm_bwd_split_stat",
             "rmsnorm_bwd_split_apply")
    for n in names:
        assert n in kernels.WRAPPERS and kernels.launches()[n] == 0
    # the CPU takes the plain versions: nothing launched, nothing counted
    y, z, w, _ = _inputs(3, 16, seed=1)
    gated_norm_apply(y, z, w, gated_norm_stat(y, z, w), 16)
    assert all(kernels.launches()[n] == 0 for n in names)
    with pytest.raises(ValueError, match="gate shape"):
        split_gated_rmsnorm(y, w, z[:, :8], None, 16)
