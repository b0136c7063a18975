"""The float32 attention kernels' arithmetic, split TF32, emulated on the CPU.

``flash_attention_f32.cu`` computes the forward's, dK/dV's and dQ's float32
products on the tensor cores: each operand a = hi + lo, hi = a rounded to
TF32 to nearest with ties away from zero (``cvt.rna.tf32.f32``, done on the
bits), lo = a - hi rounded alike, and a b = hi hi + hi lo + lo hi, three
TF32 products accumulated in f32 (lo lo dropped). No CUDA kernel runs here,
so this file emulates that arithmetic in plain PyTorch: the rounding on the
bits, the three-term product, and the forward with LSE, dK/dV and dQ (tile
by tile over the kernel's key tiles, each tile's product in a fresh
accumulator) computed through it in float32. It holds the emulation against
the reference's Pallas kernels in interpret mode and against float64 at the
reference's float32 tolerances (2e-5 forward, 2e-4 backward:
tests/test_kernels.py, tests/test_flash_backward.py), and shows that plain
TF32 (hi hi alone) misses 2e-5 in the forward and 2e-4 in dQ, so the checks
can see the split. Nothing on a path calls the
emulation; the kernels themselves are held to their plain versions on the
card (``chip_smoke.py`` phase 3).
"""
from __future__ import annotations

import math

import jax
import jax.experimental

# The reference kernel package imports ``jax.experimental.enable_x64``,
# which the installed jax no longer has (ROADMAP queue 3): alias it at
# import time, as tests/test_torch_contract.py does.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.backward import (  # noqa: E402
    flash_attention_bwd as pallas_bwd, flash_attention_fwd_lse as pallas_fwd_lse)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)
LOG2E = math.log2(math.e)

#: (B, H, Hkv, Sq, Sk, causal): GQA 4, a few hundred rows, Sq != Sk both
#: ways (the Pallas kernels want lengths in whole 128-row blocks)
CASES = [(1, 8, 2, 256, 256, True), (1, 8, 2, 256, 384, True),
         (1, 8, 2, 384, 256, True), (1, 8, 2, 256, 384, False)]


# ------------------------------ the arithmetic --------------------------------
def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, on the bits: (bits + 0x1000) & ~0x1fff, what
    ``cvt.rna.tf32.f32`` gives for a finite x (the kernels' ``tf32_rna``)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): x = hi + lo to within 2^-22 |x|, both TF32 values."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b in float32 as the kernels compute it: three TF32 products
    (lo hi + hi lo, then hi hi, each product exact in f32, summed in f32);
    ``terms=1`` is plain TF32 (hi hi alone), the control."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _mask(sq: int, sk: int, causal: bool):
    """Visible (query, key) pairs, top-left causal (key <= query), or None."""
    if not causal:
        return None
    return torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]


def fwd_lse_split(q, k, v, causal: bool, terms: int = 3):
    """The forward with LSE through :func:`mm`: S = Q Kᵀ in the log2 domain,
    P = exp2(S - max), O = P V / l, lse = (max + log2 l) ln 2 (a row with no
    visible key: o = 0, lse = -inf)."""
    n_rep = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(n_rep, 1) for t in (k, v))
    s = mm(q, kr.transpose(-1, -2), terms) * (LOG2E / math.sqrt(q.shape[-1]))
    vis = _mask(q.shape[2], k.shape[2], causal)
    if vis is not None:
        s = s.masked_fill(~vis, -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - torch.where(m == -math.inf, 0.0, m))
    l = p.sum(-1, keepdim=True)
    o = mm(p, vr, terms) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l == 0, m, m + torch.log2(l)).squeeze(-1) / LOG2E
    return o, lse


def bwd_dkv_split(q, k, v, do, lse, dd, causal: bool, terms: int = 3):
    """dK/dV through :func:`mm`: P = exp2(S scale log2 e - lse log2 e)
    masked, dP = dO Vᵀ, dS = P (dP - D), dV = Pᵀ dO, dK = dSᵀ Q scale, each
    summed over the query heads of a kv head."""
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    n_rep = h // hkv
    kr, vr = (t.repeat_interleave(n_rep, 1) for t in (k, v))
    scale = 1.0 / math.sqrt(hd)
    s = mm(q, kr.transpose(-1, -2), terms)
    p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
    vis = _mask(sq, k.shape[2], causal)
    if vis is not None:
        p = torch.where(vis, p, torch.zeros_like(p))
    ds = p * (mm(do, vr.transpose(-1, -2), terms) - dd[..., None])
    dv = mm(p.transpose(-1, -2), do, terms)
    dk = mm(ds.transpose(-1, -2), q, terms) * scale
    return (dk.view(b, hkv, n_rep, -1, hd).sum(2), dv.view(b, hkv, n_rep, -1, hd).sum(2))


def dq_key_tile(hd: int) -> int:
    """Keys a tile of ``flash_bwd_dq_f32_kernel`` (``Dq<HD>::BN``): 32 at hd
    128, where two stages of 64 would not fit beside Q and dO, else 64."""
    return 32 if hd == 128 else 64


def bwd_dq_split(q, k, v, do, lse, dd, causal: bool, terms: int = 3):
    """dQ as the kernel computes it: S = Q Kᵀ and dP = dO Vᵀ through
    :func:`mm`, P = exp2(S scale log2 e - lse log2 e) masked, dS = P (dP -
    D); dQ summed over the kernel's key tiles in order, each tile's dS K
    through :func:`mm` in a fresh accumulator and added in f32; times scale
    once at the end."""
    hd = q.shape[-1]
    n_rep = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(n_rep, 1) for t in (k, v))
    scale = 1.0 / math.sqrt(hd)
    s = mm(q, kr.transpose(-1, -2), terms)
    p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
    vis = _mask(q.shape[2], k.shape[2], causal)
    if vis is not None:
        p = torch.where(vis, p, torch.zeros_like(p))
    ds = p * (mm(do, vr.transpose(-1, -2), terms) - dd[..., None])
    bn = dq_key_tile(hd)
    dq = torch.zeros_like(q)
    for n0 in range(0, k.shape[2], bn):
        dq = dq + mm(ds[..., n0:n0 + bn], kr[..., n0:n0 + bn, :], terms)
    return dq * scale


# ------------------------------ float64 ---------------------------------------
def fwd_lse_f64(q, k, v, causal: bool):
    q, k, v = (t.double() for t in (q, k, v))
    n_rep = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(n_rep, 1) for t in (k, v))
    s = q @ kr.transpose(-1, -2) / math.sqrt(q.shape[-1])
    vis = _mask(q.shape[2], k.shape[2], causal)
    if vis is not None:
        s = s.masked_fill(~vis, -math.inf)
    lse = torch.logsumexp(s, -1)
    return torch.exp(s - lse[..., None]) @ vr, lse


def bwd_f64(q, k, v, do, causal: bool):
    """(dq, dk, dv) in float64."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    o, lse = fwd_lse_f64(q, k, v, causal)
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    n_rep = h // hkv
    kr, vr = (t.repeat_interleave(n_rep, 1) for t in (k, v))
    s = q @ kr.transpose(-1, -2) / math.sqrt(hd)
    vis = _mask(sq, k.shape[2], causal)
    p = torch.exp(s - lse[..., None])
    if vis is not None:
        p = torch.where(vis, p, torch.zeros_like(p))
    ds = p * (do @ vr.transpose(-1, -2) - (do * o).sum(-1, keepdim=True))
    dv = p.transpose(-1, -2) @ do
    dk = ds.transpose(-1, -2) @ q / math.sqrt(hd)
    return (ds @ kr / math.sqrt(hd), dk.view(b, hkv, n_rep, -1, hd).sum(2),
            dv.view(b, hkv, n_rep, -1, hd).sum(2))


def _inputs(b, h, hkv, sq, sk, hd, seed=28):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, sq, hd), (b, hkv, sk, hd), (b, hkv, sk, hd), (b, h, sq, hd))]


def _scaled_err(got, want, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 where
    ``np.testing.assert_allclose`` passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


# ------------------------------ the tests --------------------------------------
def test_tf32_rna_rounds_to_nearest_ties_away_on_the_bits():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                      one + 3 * ulp / 2, 3.0, 0.0, -0.0, 1e-30, 2.0 ** -140],
                     dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0, -0.0]
    got = tf32_rna(x)
    assert got[:7].tolist() == want
    assert bool((tf32_rna(torch.tensor([math.inf, -math.inf])).isinf()).all())
    # the low 13 bits are zero, and the value is within half a TF32 ulp
    r = torch.randn(10000, generator=torch.Generator().manual_seed(0)) * 100
    hi = tf32_rna(r)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((r - hi).abs() <= r.abs() * 2.0 ** -11).all())
    assert torch.equal(tf32_rna(hi), hi)


def test_split_error_bound():
    """|a - hi - lo| <= 2^-22 |a|, and a split product is within 3 x 2^-22
    |a||b| of a b (f64), where plain TF32 is 2^-10 off."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn(100000, generator=g) * torch.exp(torch.randn(100000, generator=g) * 3)
    b = torch.randn(100000, generator=g)
    hi, lo = split(a)
    assert bool(((a.double() - hi.double() - lo.double()).abs()
                 <= a.double().abs() * 2.0 ** -22).all())
    bh, bl = split(b)
    exact = a.double() * b.double()
    three = hi.double() * bh.double() + hi.double() * bl.double() + lo.double() * bh.double()
    one = hi.double() * bh.double()
    ab = (a.double() * b.double()).abs()
    assert bool(((three - exact).abs() <= 3 * 2.0 ** -22 * ab).all())
    assert float(((one - exact).abs() / ab.clamp_min(1e-300)).max()) > 2.0 ** -12
    # each TF32 x TF32 product is exact in f32 (11 x 11 significant bits)
    for x, y in ((hi, bh), (hi, bl), (lo, bh)):
        assert torch.equal((x * y).double(), x.double() * y.double())


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", CASES)
def test_split_forward_matches_pallas_and_f64(b, h, hkv, sq, sk, causal, hd):
    q, k, v, _ = _inputs(b, h, hkv, sq, sk, hd)
    o, lse = fwd_lse_split(*map(torch.from_numpy, (q, k, v)), causal)
    jo, jlse = pallas_fwd_lse(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    o64, lse64 = fwd_lse_f64(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), o64.numpy(), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse64.numpy(), **FWD_TOL)


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", CASES)
def test_split_dkv_matches_pallas_and_f64(b, h, hkv, sq, sk, causal, hd):
    """dK/dV through the split, from the Pallas forward's o and LSE (D =
    rowsum(dO o) as the port's ``attention_delta``), against the Pallas
    backward in interpret mode and float64 at 2e-4."""
    q, k, v, do = _inputs(b, h, hkv, sq, sk, hd)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = pallas_fwd_lse(jq, jk, jv, causal=causal, interpret=True)
    _, jdk, jdv = pallas_bwd(jq, jk, jv, jo, jlse, jdo, causal=causal, interpret=True)
    o, lse = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jlse))
    dd = (torch.from_numpy(do) * o).sum(-1)
    dk, dv = bwd_dkv_split(*map(torch.from_numpy, (q, k, v, do)), lse, dd, causal)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), **BWD_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **BWD_TOL)
    _, dk64, dv64 = bwd_f64(*map(torch.from_numpy, (q, k, v, do)), causal)
    np.testing.assert_allclose(dk.numpy(), dk64.numpy(), **BWD_TOL)
    np.testing.assert_allclose(dv.numpy(), dv64.numpy(), **BWD_TOL)


@pytest.mark.parametrize("hd", [16, 128])
def test_plain_tf32_misses_the_forward_tolerance(hd):
    """The control: the same forward with hi hi alone (plain TF32) is
    outside 2e-5 of float64 by a wide margin, where the split is inside it,
    so the tests above can see the split."""
    b, h, hkv, sq, sk, causal = CASES[1]
    q, k, v, _ = map(torch.from_numpy, _inputs(b, h, hkv, sq, sk, hd))
    o64, lse64 = fwd_lse_f64(q, k, v, causal)
    o3, lse3 = fwd_lse_split(q, k, v, causal)
    o1, lse1 = fwd_lse_split(q, k, v, causal, terms=1)
    split_err = max(_scaled_err(o3, o64, **FWD_TOL), _scaled_err(lse3, lse64, **FWD_TOL))
    plain_err = max(_scaled_err(o1, o64, **FWD_TOL), _scaled_err(lse1, lse64, **FWD_TOL))
    assert split_err <= 1.0 < 4.0 <= plain_err, (split_err, plain_err)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(o1.numpy(), o64.numpy(), **FWD_TOL)


def _dq_case(b, h, hkv, sq, sk, causal, hd):
    """The inputs, the Pallas forward's o and LSE, D = rowsum(dO o), the
    Pallas backward's dQ and the float64 dQ."""
    q, k, v, do = _inputs(b, h, hkv, sq, sk, hd)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = pallas_fwd_lse(jq, jk, jv, causal=causal, interpret=True)
    jdq, _, _ = pallas_bwd(jq, jk, jv, jo, jlse, jdo, causal=causal, interpret=True)
    o, lse = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jlse))
    dd = (torch.from_numpy(do) * o).sum(-1)
    dq64, _, _ = bwd_f64(*map(torch.from_numpy, (q, k, v, do)), causal)
    return tuple(map(torch.from_numpy, (q, k, v, do))), lse, dd, np.asarray(jdq), dq64


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", CASES)
def test_split_dq_matches_pallas_and_f64(b, h, hkv, sq, sk, causal, hd):
    """dQ through the split, tile by tile over the kernel's key tiles in
    fresh accumulators, from the Pallas forward's LSE, against the Pallas
    backward in interpret mode and float64 at 2e-4."""
    (q, k, v, do), lse, dd, jdq, dq64 = _dq_case(b, h, hkv, sq, sk, causal, hd)
    dq = bwd_dq_split(q, k, v, do, lse, dd, causal)
    np.testing.assert_allclose(dq.numpy(), jdq, **BWD_TOL)
    np.testing.assert_allclose(dq.numpy(), dq64.numpy(), **BWD_TOL)


@pytest.mark.parametrize("hd", [16, 128])
def test_plain_tf32_misses_the_dq_tolerance(hd):
    """The control for dQ: with hi hi alone (plain TF32) in S, dP and dS K,
    dQ is outside 2e-4 of float64, where the split is inside it."""
    b, h, hkv, sq, sk, causal = CASES[1]
    (q, k, v, do), lse, dd, _, dq64 = _dq_case(b, h, hkv, sq, sk, causal, hd)
    split_err = _scaled_err(bwd_dq_split(q, k, v, do, lse, dd, causal), dq64, **BWD_TOL)
    plain = bwd_dq_split(q, k, v, do, lse, dd, causal, terms=1)
    plain_err = _scaled_err(plain, dq64, **BWD_TOL)
    assert split_err <= 1.0 < plain_err, (split_err, plain_err)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(plain.numpy(), dq64.numpy(), **BWD_TOL)
