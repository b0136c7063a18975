"""The float32 decode kernel's split over the keys, emulated on the CPU.

``decode_attention_f32.cu`` serves every query head of a kv head in one
thread-block cluster of ``n_split`` blocks: block ``split`` takes the
TK-key tiles split, split + n_split, ... of [0, kv_len); within a block,
tile i goes to warp i % NW, which keeps its own online softmax (m, l, acc)
in the log2 domain over its tiles in order (q scaled by scale log2 e once);
the warps merge in shared memory, then the blocks of the cluster merge (an
empty part holds m = -inf, l = 0, acc = 0); o = acc / l, lse = (m + log2 l)
ln 2, and where no key is valid o = 0, lse = -1e30. No CUDA kernel runs
here, so this file emulates that arithmetic in float32 with the source's
constants and holds it against the reference's Pallas ``decode_attention``
in interpret mode and its oracle ``decode_attention_ref`` at the
reference's float32 tolerance (2e-5), over a float32 and a bf16 cache (a
float32 model's), GQA groups 1, 3, 4 and 5, kv_len 0, 1, a length whose
tiles are fewer than the blocks (empty parts) and S, and split counts from
1 to the source's largest cluster. Nothing on a path calls the emulation;
the kernel itself is held to its plain version on the card
(``chip_smoke.py`` phase 3).
"""
from __future__ import annotations

import math
import re
from pathlib import Path

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

from repro.kernels.decode_attention.ops import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/decode_attention"
          / "csrc/decode_attention_f32.cu")
TOL = dict(rtol=2e-5, atol=2e-5)
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
NW = 8             # warps a block (the source's NW)
MAX_SPLIT = 16     # blocks a head group at most (the source's MAX_SPLIT)
S = 256            # cache length: the Pallas kernel wants whole 256-key blocks


def tile_keys(hd: int, elt: int) -> int:
    """Keys a tile (the source's ``Geo::TK``): LPK lanes a key, one for each
    128 bytes of a cache row, TK = 32 / LPK."""
    row = hd * elt
    lpk = row // 128 if row > 128 else 1
    return 32 // lpk


def _merge(parts):
    """Online-softmax states (m, l, acc) merged as the kernel merges its
    warps and its blocks: M the largest m, each state scaled by 2^(m - M),
    an empty one (m = -inf) by 0."""
    m = torch.stack([p[0] for p in parts])
    big = m.amax(0)
    c = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp2(m - big))
    l = (torch.stack([p[1] for p in parts]) * c).sum(0)
    acc = (torch.stack([p[2] for p in parts]) * c[..., None]).sum(0)
    return big, l, acc


def decode_f32_emulated(q, k, v, kv_len: int, n_split: int):
    """The float32 decode kernel's arithmetic at split count ``n_split``:
    q (B, H, hd) float32, k and v (B, Hkv, S, hd) float32 or bfloat16.
    Returns (o, lse) in float32."""
    b, h, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    n_rep = h // hkv
    tk = tile_keys(hd, k.element_size())
    kf, vf = (t.float().repeat_interleave(n_rep, 1) for t in (k, v))
    qs = q * (LOG2E / math.sqrt(hd))
    kv_len = max(0, min(kv_len, s))
    tiles = (kv_len + tk - 1) // tk
    empty = (torch.full((b, h), -math.inf), torch.zeros(b, h), torch.zeros(b, h, hd))
    blocks = []
    for split in range(n_split):
        ntiles = (tiles - split + n_split - 1) // n_split if split < tiles else 0
        warps = []
        for w in range(NW):
            m, l, acc = empty
            for i in range(w, ntiles, NW):
                key0 = (split + i * n_split) * tk
                kt = kf[:, :, key0:min(key0 + tk, kv_len)]
                vt = vf[:, :, key0:min(key0 + tk, kv_len)]
                sc = torch.einsum("bhd,bhkd->bhk", qs, kt)
                mn = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp2(m - mn)
                p = torch.exp2(sc - mn[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("bhk,bhkd->bhd", p, vt)
                m = mn
            warps.append((m, l, acc))
        blocks.append(_merge(warps))
    m, l, acc = _merge(blocks)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(m == -math.inf, torch.full_like(m, -1e30), (m + torch.log2(safe)) * LN2)
    return acc / safe[..., None], lse


def _inputs(b, h, hkv, hd, cache, seed=29):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd), dtype=np.float32)
    k, v = (rng.standard_normal((b, hkv, S, hd), dtype=np.float32) for _ in range(2))
    if cache == "bf16":   # the cache's values as bf16 holds them, the same on both sides
        k, v = (torch.from_numpy(t).bfloat16().float().numpy() for t in (k, v))
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if cache == "bf16" else (torch.float32,
                                                                      jnp.float32)
    torch_in = (torch.from_numpy(q), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt))
    jax_in = (jnp.asarray(q), jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt))
    return torch_in, jax_in


def test_constants_are_the_sources():
    """The emulation's NW, MAX_SPLIT and tile rule are the kernel's."""
    src = SOURCE.read_text()
    assert int(re.search(r"constexpr int NW = (\d+);", src).group(1)) == NW
    assert int(re.search(r"constexpr int MAX_SPLIT = (\d+);", src).group(1)) == MAX_SPLIT
    assert "LPK = ROW > 128 ? ROW / 128 : 1;" in src
    assert "TK = 32 / LPK;" in src
    assert [tile_keys(hd, 2) for hd in (16, 32, 64, 128)] == [32, 32, 32, 16]
    assert [tile_keys(hd, 4) for hd in (16, 32, 64, 128)] == [32, 32, 16, 8]


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("group", [1, 3, 4, 5])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_split_decode_matches_pallas_and_oracle(cache, group, hd):
    """At kv_len 0, 1, three tiles and a few keys (fewer tiles than blocks:
    empty parts) and S, and at 1, 3, 7 and 16 blocks a group, the emulated
    kernel within 2e-5 of the Pallas kernel in interpret mode and of the
    oracle (kv_len 0: o = 0 and lse = -1e30, as the Pallas kernel gives)."""
    b, hkv = 2, 2
    (q, k, v), (jq, jk, jv) = _inputs(b, hkv * group, hkv, hd, cache)
    few = 3 * tile_keys(hd, k.element_size()) + 5
    for kv_len in (0, 1, few, S):
        jo, jlse = pallas_decode(jq, jk, jv, kv_len, interpret=True)
        jo, jlse = np.asarray(jo), np.asarray(jlse)
        if kv_len:
            ro, rlse = jax_decode_ref(jq, jk, jv, kv_len, return_lse=True)
        for n_split in (1, 3, 7, MAX_SPLIT):
            o, lse = decode_f32_emulated(q, k, v, kv_len, n_split)
            if kv_len == 0:
                assert bool((o == 0).all()) and bool((lse == -1e30).all())
                np.testing.assert_array_equal(jo, 0.0)
                np.testing.assert_array_equal(jlse, np.float32(-1e30))
                continue
            np.testing.assert_allclose(o.numpy(), jo, **TOL)
            np.testing.assert_allclose(lse.numpy(), jlse, **TOL)
            np.testing.assert_allclose(o.numpy(), np.asarray(ro), **TOL)
            np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), **TOL)


def test_empty_parts_and_warps_contribute_nothing():
    """The merge of a state with empty ones is that state, bit for bit, and
    a length of fewer tiles than blocks leaves parts empty: one tile at 16
    blocks gives the one-block result's bits."""
    g = torch.Generator().manual_seed(0)
    m, l, acc = torch.randn(2, 3, generator=g), torch.rand(2, 3, generator=g) + 1, \
        torch.randn(2, 3, 8, generator=g)
    empty = (torch.full((2, 3), -math.inf), torch.zeros(2, 3), torch.zeros(2, 3, 8))
    mm, ll, aa = _merge([empty, (m, l, acc), empty])
    assert torch.equal(mm, m) and torch.equal(ll, l) and torch.equal(aa, acc)
    (q, k, v), _ = _inputs(1, 4, 1, 128, "bf16")
    one = decode_f32_emulated(q, k, v, 9, 1)
    sixteen = decode_f32_emulated(q, k, v, 9, MAX_SPLIT)
    assert all(torch.equal(a, b) for a, b in zip(one, sixteen))
