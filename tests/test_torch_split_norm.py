"""The split-row gated RMSNorm (``kernels/rmsnorm``: the Mamba2 layer's
gated norm over rows split across the ranks of a model axis) on the CPU:
the plain versions of its four launches, each rank's block of columns with
the row sums added over the ranks in between, against the one-device gated
norm and its backward, within 1e-6 relative in f32; the autograd
function over a group of one rank against the fused gated norm; and the
wrapper's choice of each tensor's vector width for the card's kernels
(``split_widths``), on gates sliced from in_proj rows as the model slices
them: never a width that a row's base or stride forbids, the widest the
gate's rows allow where the other tensors take 16-byte vectors."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.rmsnorm.ops import (VECTOR_BYTES, fused_rmsnorm,
                                             fused_rmsnorm_bwd, gated_norm_apply,
                                             gated_norm_bwd_apply, gated_norm_bwd_stat,
                                             gated_norm_stat, split_gated_rmsnorm,
                                             split_widths, vector_bytes)
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


# ------------------------- each tensor's vector width ------------------------
def _allowed(t: torch.Tensor, width: int) -> bool:
    """Every row of ``t`` starts on ``width`` bytes."""
    size = t.element_size()
    starts = [t.data_ptr() + r * t.stride(0) * size for r in range(t.shape[0])]
    return width >= size and all(a % width == 0 for a in starts)


def _model_gate(rows: int, d: int, width: int, dtype) -> torch.Tensor:
    """A rank's gate as the Mamba2 layer slices it: the first d columns of
    its (B, S, width) in_proj output, reshaped to (B S, d) (a view at row
    stride ``width``)."""
    zxbcdt = torch.zeros(2, rows // 2, width, dtype=dtype)
    return zxbcdt[..., :d].reshape(-1, d)


# (gate row stride, dtype, d, the gate's widest load): Mamba2's rank rows of
# 2 d + 2 N + H / 2 = 1804 (8 bytes in bf16, 16 in f32), 1802 and 1801 (4
# and 2 bytes), Jamba's 8288, a ragged 1600 and the odd width's 212 (d 100:
# the scalar path, every tensor an element a load)
WIDTH_CASES = [(1804, torch.bfloat16, 768, 8), (1802, torch.bfloat16, 768, 4),
               (1801, torch.bfloat16, 768, 2), (1804, torch.float32, 768, 16),
               (1802, torch.float32, 768, 8), (1801, torch.float32, 768, 4),
               (8288, torch.bfloat16, 4096, 16), (1600, torch.bfloat16, 768, 16),
               (212, torch.bfloat16, 100, 2)]


@pytest.mark.parametrize("stride,dtype,d,want", WIDTH_CASES)
def test_split_widths_take_the_widest_load_each_tensor_allows(stride, dtype, d, want):
    rows = 6
    z = _model_gate(rows, d, stride, dtype)
    assert z.stride() == (stride, 1)
    y, w, dh = torch.zeros(rows, d), torch.ones(d), torch.zeros(rows, d, dtype=dtype)
    widths = split_widths(y, z, w, dh)
    assert widths["gate"] == want
    vec = d % 8 == 0
    assert widths == {"y": 16 if vec else 4, "w": 16 if vec else 4,
                      "dh": 16 if vec else dtype.itemsize, "gate": want}
    for name, t in (("y", y), ("gate", z), ("dh", dh), ("w", w[None])):
        assert _allowed(t, widths[name]), name
    # the widest its rows allow: twice as wide is forbidden (or past 16 bytes)
    if vec:
        assert want == 16 or not _allowed(z, 2 * want)
    assert vector_bytes(z) in VECTOR_BYTES and _allowed(z, vector_bytes(z))


@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_split_widths_follow_each_base_address(offset):
    """A tensor whose base is off 16 bytes narrows its own load: the gate
    alone narrows the gate's; y or dh off 16 bytes puts the launch on the
    scalar path, every tensor an element a load."""
    d, stride = 768, 1808
    z = torch.zeros(4, stride + 16, dtype=torch.bfloat16).view(-1)[offset:][:4 * stride]
    z = z.view(4, stride)[:, :d]
    y, w = torch.zeros(4, d), torch.ones(d)
    widths = split_widths(y, z, w)
    assert widths["y"] == 16 and widths["gate"] == 2 * offset
    assert _allowed(z, widths["gate"])
    assert widths["gate"] == 16 or not _allowed(z, 2 * widths["gate"])
    y_off = torch.zeros(4 * d + 1)[1:].view(4, d)
    widths = split_widths(y_off, z, w)
    assert widths == {"y": 4, "w": 4, "gate": 2}
    dh_off = torch.zeros(4 * d + 4, dtype=torch.bfloat16)[4:].view(4, d)
    assert split_widths(y, z, w, dh_off)["dh"] == 2


def test_split_plain_versions_match_the_one_device_norm_on_model_slices():
    """The plain versions over two ranks' blocks, each gate a slice of its
    own in_proj rows (strides 1804, 1802 and 1801), against the one-device
    gated norm over the whole row and its backward (f32)."""
    rows, d, dn = 10, 96, 192
    rng = np.random.default_rng(11)
    for width in (1804, 1802, 1801):
        zs = [_model_gate(rows, d, width, torch.float32) for _ in range(2)]
        for z in zs:
            z.copy_(torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)))
        y = torch.from_numpy(rng.standard_normal((rows, dn)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(0.5, 1.5, dn).astype(np.float32))
        dh = torch.from_numpy(rng.standard_normal((rows, dn)).astype(np.float32))
        z_all = torch.cat(zs, 1)
        cols = [slice(0, d), slice(d, dn)]
        stats = sum(gated_norm_stat(y[:, c].contiguous(), z, w[c]) for c, z in zip(cols, zs))
        got = torch.cat([gated_norm_apply(y[:, c].contiguous(), z, w[c].contiguous(), stats, dn)
                         for c, z in zip(cols, zs)], 1)
        assert _rel(got, fused_rmsnorm_ref(y, w, gate=z_all)[0]) <= REL
        bstats = sum(gated_norm_bwd_stat(dh[:, c], y[:, c].contiguous(), z, w[c])
                     for c, z in zip(cols, zs))
        parts = [gated_norm_bwd_apply(dh[:, c], y[:, c].contiguous(), z, w[c].contiguous(),
                                      bstats, dn) for c, z in zip(cols, zs)]
        for i, want in enumerate(fused_rmsnorm_bwd_ref(dh, None, y, w, gate=z_all)):
            assert _rel(torch.cat([p[i] for p in parts], -1), want) <= REL, (width, i)
