"""The SSD kernel's split arithmetic, emulated on the CPU.

``src/repro_torch/kernels/ssd/csrc/ssd.cu`` runs every product of the scan
on bf16 tensor cores at f32 accuracy: an f32 operand is split into three
bf16 terms (round to nearest even, as ``__floats2bfloat162_rn``), a bf16
operand is one term, and the term pairs whose orders sum to more than
``KEEP = 2`` are dropped. Its header states that the split is exact, that a
product of a split operand and a bf16 one drops nothing, that the dropped
pairs of two split operands are below 1.01 * 2^-23 |a||b| per product, and
that a K-long product is within (that + m * 2^-23) * sum_k |a_k||b_k| of
the exact sum, m the number of term products added in f32. These tests
emulate the terms as the kernel rounds them and hold each statement
against float64 at the kernel's tile shapes (64-row chunks, N = 128), on
normal operands and on operands spread over 2^-40..2^40.
"""
from __future__ import annotations

import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
          / "ssd" / "csrc" / "ssd.cu")
KEEP = 2
U23 = 2.0 ** -23
DROP = 1.01 * U23


def split3(v: torch.Tensor) -> list[torch.Tensor]:
    """The kernel's three bf16 terms of an f32 tensor, as f32 tensors."""
    hi = v.to(torch.bfloat16).float()
    r = v - hi
    mid = r.to(torch.bfloat16).float()
    return [hi, mid, (r - mid).to(torch.bfloat16).float()]


def terms(v: torch.Tensor, split: bool) -> list[torch.Tensor]:
    return split3(v) if split else [v]


def operand(rng, shape, kind: str, bf16: bool) -> torch.Tensor:
    """f32 operand: normal, or spread over 2^-40..2^40; rounded to bf16 if
    the kernel reads it as bf16."""
    v = rng.standard_normal(shape)
    if kind == "wide":
        v = v * np.exp2(rng.uniform(-40, 40, shape))
    t = torch.from_numpy(v.astype(np.float32))
    return t.to(torch.bfloat16).float() if bf16 else t


def kept_pairs(ta: int, tb: int) -> list[tuple[int, int]]:
    return [(i, s - i) for s in range(KEEP, -1, -1) for i in range(ta)
            if 0 <= s - i < tb]


def test_header_states_keep():
    assert re.search(r"constexpr int KEEP = (\d+);", SOURCE.read_text()).group(1) == str(KEEP)


@pytest.mark.parametrize("kind", ["normal", "wide"])
def test_split_is_exact(kind):
    """v == hi + mid + lo exactly, and each term is a bf16 value."""
    rng = np.random.default_rng(0)
    v = operand(rng, (64, 128), kind, bf16=False)
    t = split3(v)
    for x in t:
        assert torch.equal(x.to(torch.bfloat16).float(), x)
    assert torch.equal(t[0].double() + t[1].double() + t[2].double(), v.double())
    # |mid| <= 2^-8 (1 + 2^-8) |v|, |lo| <= 2^-16 |v| (the header's bounds)
    a = v.double().abs()
    assert bool((t[1].double().abs() <= 2.0 ** -8 * (1 + 2.0 ** -8) * a).all())
    assert bool((t[2].double().abs() <= 2.0 ** -16 * a).all())


# (product, m, k, n, A split, B split) at the kernel's tile shapes: on the
# model path (x, B, C in bf16) one operand of each product is split; with
# f32 inputs both are.
PRODUCTS = [
    ("C B^T, bf16 inputs", 16, 128, 16, False, False),
    ("x^T M^T", 16, 64, 64, False, True),
    ("h^T C^T", 16, 128, 64, True, False),
    ("(x dt w)^T B", 16, 64, 128, True, False),
    ("C B^T, f32 inputs", 16, 128, 16, True, True),
    ("x^T M^T, f32 inputs", 16, 64, 64, True, True),
    ("h^T C^T, f32 inputs", 16, 128, 64, True, True),
]


@pytest.mark.parametrize("kind", ["normal", "wide"])
@pytest.mark.parametrize("name,m,k,n,sa,sb", PRODUCTS, ids=[p[0] for p in PRODUCTS])
def test_dropped_terms_within_stated_bound(name, m, k, n, sa, sb, kind):
    """The kept term pairs, summed exactly, against the exact product: equal
    where one operand is bf16, within 1.01 * 2^-23 sum |a||b| where both are
    split."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    a = operand(rng, (m, k), kind, bf16=not sa)
    b = operand(rng, (k, n), kind, bf16=not sb)
    ta, tb = terms(a, sa), terms(b, sb)
    kept = sum(ta[i].double() @ tb[j].double() for i, j in kept_pairs(len(ta), len(tb)))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err = (kept - exact).abs()
    if sa and sb:
        assert bool((err <= DROP * scale).all())
        assert len(kept_pairs(3, 3)) == 6
    else:
        assert bool((err <= 1e-12 * scale).all())


@pytest.mark.parametrize("kind", ["normal", "wide"])
@pytest.mark.parametrize("name,m,k,n,sa,sb", PRODUCTS, ids=[p[0] for p in PRODUCTS])
def test_split_product_in_f32_within_stated_bound(name, m, k, n, sa, sb, kind):
    """The kernel's product as it runs: each kept term pair's k16 slice (one
    mma) added into an f32 accumulator, against float64, within (dropped +
    m * 2^-23) * sum_k |a_k||b_k|, m the term products added."""
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 1)
    a = operand(rng, (m, k), kind, bf16=not sa)
    b = operand(rng, (k, n), kind, bf16=not sb)
    ta, tb = terms(a, sa), terms(b, sb)
    pairs = kept_pairs(len(ta), len(tb))
    acc = torch.zeros(m, n, dtype=torch.float32)
    for k0 in range(0, k, 16):
        for i, j in pairs:
            sl = slice(k0, k0 + 16)
            acc = (acc.double() + ta[i][:, sl].double() @ tb[j][sl].double()).float()
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    added = len(pairs) * k
    bound = ((DROP if sa and sb else 0.0) + added * U23) * scale
    assert bool(((acc.double() - exact).abs() <= bound).all())
    # and the f32 result is far better than bf16 alone would be
    assert bool(((acc.double() - exact).abs() <= 2.0 ** -16 * scale).all())


def test_two_terms_would_not_be_exact():
    """With two terms (KEEP = 1 on a split-times-bf16 product) the kernel
    would drop lo: the error reaches ~2^-17 of the product, far above the
    three-term product's, which is what the planted fault
    ``one_cross_term_too_many_dropped`` relies on."""
    rng = np.random.default_rng(5)
    a = operand(rng, (16, 128), "normal", bf16=False)
    b = operand(rng, (128, 64), "normal", bf16=True)
    t = split3(a)
    two = (t[0].double() + t[1].double()) @ b.double()
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    assert ((two - exact).abs() / scale).max().item() > 2.0 ** -21
