"""Head dim 16 in bf16: the plain versions that the card's hd-16 decode and
dK/dV kernels are held against, and the partitions those kernels compute.

The hd-16 decode kernel (``decode_attention_hd16_kernel``) takes 64-key
tiles, block ``split`` of a head group's cluster taking tiles split, split +
n_split, ..., and merges (m, l, acc) partials: a lane's keys, a warp's
lanes, a block's warps, the cluster's blocks. The hd-16 dK/dV kernel
(``flash_bwd_dkv_cluster_kernel``) takes items of 64 keys, splits an item's
(query head, 64-query tile) list over the blocks of a cluster (rank r tiles
r, r + CL, ...) and sums the blocks' f32 partials in rank order. On the CPU
each wrapper runs its plain version; here those are held against the
reference's Pallas kernels in interpret mode and its oracles at the new
tiles' edges (tolerances as tests/test_torch_contract.py: bf16 2e-2, float32
2e-5 forward and 2e-4 backward, decode LSE 1e-3), and the two partitions
are emulated in float32 and held against the reference: every key and
(query, key) pair lands in exactly one part, at any kv_len, group, split and
ragged length. The CUDA kernels are held against the plain versions on the
card by tests/test_torch_gpu.py and ``chip_smoke.py`` phase 3.
"""
from __future__ import annotations

import math

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

from repro.kernels.decode_attention.ops import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention.backward import (  # noqa: E402
    flash_attention_bwd as pallas_bwd, flash_attention_fwd_lse as pallas_fwd_lse)
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd_lse)
from repro_torch.kernels.flash_attention.ref import attention_delta  # noqa: E402

TK = 64          # the hd-16 decode kernel's keys a tile (H16_TK)
BK = BQ = 64     # the hd-16 dK/dV kernel's keys an item and queries a tile
BF16 = dict(rtol=2e-2, atol=2e-2)
F32 = dict(rtol=2e-5, atol=2e-5)
F32_BWD = dict(rtol=2e-4, atol=2e-4)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _decode_inputs(seed, b, h, hkv, s):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, 16), dtype=np.float32),
            rng.standard_normal((b, hkv, s, 16), dtype=np.float32),
            rng.standard_normal((b, hkv, s, 16), dtype=np.float32))


# ------------------------------ decode ----------------------------------------
S_DECODE = 3 * TK   # a cache of three tiles: the Pallas kernel's blocks of 64 divide it


@pytest.mark.parametrize("group", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("kv_len", [1, TK - 1, TK, TK + 1, S_DECODE])
def test_decode_plain_matches_pallas_at_the_tile_edges(group, kv_len):
    """bf16 decode at hd 16 with kv_len at the 64-key tile's edges and at S,
    every GQA group the kernel serves as it is (1, 2, 3, 4, 8) or in chunks
    of 8 (16): the plain version against the Pallas kernel in interpret mode
    and against the reference's oracle."""
    q, k, v = _decode_inputs(11 + group, 2, 2 * group, 2, S_DECODE)
    o, lse = decode_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), kv_len)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    for oj, lsej in (pallas_decode(qj, kj, vj, kv_len, block_k=TK, interpret=True),
                     jax_decode_ref(qj, kj, vj, kv_len, return_lse=True)):
        np.testing.assert_allclose(_np(o), _np(oj), **BF16)
        np.testing.assert_allclose(_np(lse), _np(lsej), rtol=1e-3, atol=1e-3)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32


@pytest.mark.parametrize("group", [1, 4, 16])
def test_decode_at_kv_len_0(group):
    """No valid position: the Pallas kernel's l == 0 guard gives o = 0 and
    lse = -1e30 (what the CUDA kernel gives, held on the card); the plain
    version and the reference's oracle both divide 0 by 0 alike."""
    q, k, v = _decode_inputs(21, 2, 2 * group, 2, S_DECODE)
    o, lse = decode_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 0)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    po, plse = pallas_decode(qj, kj, vj, 0, block_k=TK, interpret=True)
    assert (np.asarray(po, np.float32) == 0).all() and (np.asarray(plse) == -1e30).all()
    ro, rlse = jax_decode_ref(qj, kj, vj, 0, return_lse=True)
    np.testing.assert_array_equal(np.isnan(_np(o)), np.isnan(_np(ro)))
    np.testing.assert_array_equal(np.isnan(_np(lse)), np.isnan(_np(rlse)))


def _merge(parts):
    """Merge (m, l, acc) partials (base-2 scores) in order, as the kernel
    does: an empty part holds (-inf, 0, 0)."""
    m, l, acc = parts[0]
    for mo, lo, ao in parts[1:]:
        mn = torch.maximum(m, mo)
        ca = torch.where(m == -math.inf, 0.0, torch.exp2(m - mn))
        cb = torch.where(mo == -math.inf, 0.0, torch.exp2(mo - mn))
        m, l, acc = mn, l * ca + lo * cb, acc * ca[..., None] + ao * cb[..., None]
    return m, l, acc


def decode_hd16_emulated(q, k, v, kv_len: int, n_split: int, warps: int = 4):
    """The hd-16 kernel's partition in float32: block ``split`` of n_split
    takes tiles split + i n_split; its warp w tiles w, w + warps, ... of the
    block's; the warp's lane j keys j + 16 x of each tile. Each lane's keys
    make one (m, l, acc); lanes merge pairwise (xor 2, 4, 8, 16: here key
    lanes 1, 2, 4, 8), then the block's warps, then the cluster's blocks.
    Returns (o, lse) with the l == 0 guard."""
    b, h, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rep = h // hkv
    kk = k.repeat_interleave(rep, 1)
    vv = v.repeat_interleave(rep, 1)
    scores = torch.einsum("bhd,bhkd->bhk", q, kk) / math.sqrt(hd) * math.log2(math.e)
    kv_len = max(0, min(kv_len, s))
    tiles = -(-kv_len // TK)

    def part(keys):
        keys = [x for x in keys if x < kv_len]
        if not keys:
            return (torch.full((b, h), -math.inf), torch.zeros(b, h), torch.zeros(b, h, hd))
        sc = scores[..., keys]
        m = sc.amax(-1)
        p = torch.exp2(sc - m[..., None])
        return m, p.sum(-1), torch.einsum("bhk,bhkd->bhd", p, vv[:, :, keys])

    blocks = []
    for split in range(n_split):
        mine = list(range(split, tiles, n_split))   # the block's tiles, in order
        warp_parts = []
        for w in range(warps):
            lanes = [part([t * TK + x * 16 + j for t in mine[w::warps] for x in range(TK // 16)])
                     for j in range(16)]
            for o in (1, 2, 4, 8):                  # the shuffle rounds
                lanes = [_merge([lanes[j], lanes[j ^ o]]) for j in range(16)]
            warp_parts.append(lanes[0])
        blocks.append(_merge(warp_parts))
    m, l, acc = _merge(blocks)
    safe = torch.where(l == 0, 1.0, l)
    o = acc / safe[..., None]
    lse = torch.where(m == -math.inf, -1e30, (m + torch.log2(safe)) * math.log(2))
    return o, lse


@pytest.mark.parametrize("n_split", [1, 5, 16])
@pytest.mark.parametrize("kv_len", [0, 1, TK - 1, TK, TK + 1, 5 * TK + 3, 600])
def test_decode_partition_covers_every_key_once(n_split, kv_len):
    """The kernel's tiles, splits, warps and lanes, emulated in float32,
    against the reference's oracle within 2e-5 (the Pallas kernel's guard
    at kv_len 0): at the tile's edges, beyond the early tiles of a block
    (600 keys over one block: 10 tiles, three a warp), with empty splits
    (n_split 16 over one tile)."""
    q, k, v = _decode_inputs(31 + kv_len, 2, 8, 2, 600)
    o, lse = decode_hd16_emulated(*map(torch.from_numpy, (q, k, v)), kv_len, n_split)
    if kv_len == 0:
        assert (o == 0).all() and (lse == -1e30).all()
        return
    oj, lsej = jax_decode_ref(*map(jnp.asarray, (q, k, v)), kv_len, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lsej), **F32)


# ------------------------------ dK/dV -----------------------------------------
def _train_inputs(seed, b, h, hkv, sq, sk):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for shape in
                 ((b, h, sq, 16), (b, hkv, sk, 16), (b, hkv, sk, 16), (b, h, sq, 16)))


def _jax_grads(q, k, v, do, causal):
    """dq, dk, dv of the reference's attention under jax.vjp."""
    out, vjp = jax.vjp(lambda a, b_, c: jax_flash_ref(a, b_, c, causal=causal),
                       *map(jnp.asarray, (q, k, v)))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("b,h,hkv,s,causal,dt", [
    (1, 4, 1, 96, True, "f32"), (2, 8, 2, 160, False, "f32"),
    (1, 6, 2, 96, True, "bf16"), (1, 8, 2, 160, True, "bf16")])
def test_dkv_plain_matches_pallas_at_sk_not_a_multiple_of_64(b, h, hkv, s, causal, dt):
    """The training attention at hd 16 where S is not a multiple of the
    kernel's 64 keys and 64 queries (96, 160; the Pallas kernels in
    interpret mode with 32-row blocks, which divide them), causal and full,
    float32 within 2e-4 and bf16 within 2e-2."""
    q, k, v, do = _train_inputs(41 + s, b, h, hkv, s, s)
    tdt, jdt = (torch.float32, jnp.float32) if dt == "f32" else (torch.bfloat16, jnp.bfloat16)
    qj, kj, vj, doj = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    jo, jlse = pallas_fwd_lse(qj, kj, vj, causal=causal, block_q=32, block_k=32, interpret=True)
    jgrads = pallas_bwd(qj, kj, vj, jo, jlse, doj, causal=causal, block_q=32, block_k=32,
                        interpret=True)
    qt, kt, vt, dot = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    o, lse = flash_attention_fwd_lse(qt, kt, vt, causal)
    grads = flash_attention_bwd(qt, kt, vt, o, lse, dot, causal)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(_np(got), _np(want), **(F32_BWD if dt == "f32" else BF16))


def dkv_hd16_emulated(q, k, v, do, causal: bool, cl: int):
    """The hd-16 dK/dV kernel's partition in float32: items of 64 keys;
    query tiles wholly above the diagonal skipped (m_begin); the item's
    (query head, query tile) list split over ``cl`` ranks, rank r taking
    tiles r, r + cl, ...; each rank's f32 partial summed over its tiles in
    order, the partials summed in rank order; dk scaled once at the end.
    P comes from the exact LSE, dS from D = rowsum(dO O), as the kernel's
    inputs."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = 1.0 / math.sqrt(hd)
    kk = k.repeat_interleave(rep, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale
    mask = (torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]) if causal else \
        torch.ones(sq, sk, dtype=torch.bool)
    lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), -1)
    o = torch.einsum("bhqk,bhkd->bhqd",
                     torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0),
                     v.repeat_interleave(rep, 1))
    dd = (do * o).sum(-1)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for n0 in range(0, sk, BK):
        m_begin = n0 // BQ * BQ if causal else 0
        nqt = -(-(sq - m_begin) // BQ) if m_begin < sq else 0
        pairs = [(hh, m_begin + t * BQ) for hh in range(rep) for t in range(nqt)]
        keys = slice(n0, min(n0 + BK, sk))
        ranks = []
        for r in range(cl):
            pk, pv = torch.zeros_like(k[:, :, keys]), torch.zeros_like(v[:, :, keys])
            for x in pairs[r::cl]:
                hh, m0 = x
                rows = slice(m0, min(m0 + BQ, sq))
                heads = slice(hh, h, rep)                   # the kv heads' query head hh
                p = torch.exp(s[:, heads, rows, keys] - lse[:, heads, rows, None])
                p = p.masked_fill(~mask[rows, keys], 0.0)
                dp = torch.einsum("bhqd,bhkd->bhqk", do[:, heads, rows], v[:, :, keys])
                ds = p * (dp - dd[:, heads, rows, None])
                pv += torch.einsum("bhqk,bhqd->bhkd", p, do[:, heads, rows])
                pk += torch.einsum("bhqk,bhqd->bhkd", ds, q[:, heads, rows])
            ranks.append((pk, pv))
        dk[:, :, keys] = sum(p[0] for p in ranks) * scale
        dv[:, :, keys] = sum(p[1] for p in ranks)
    return dk, dv


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", [
    (2, 8, 2, 100, 100, True), (1, 4, 1, 77, 65, False), (2, 6, 2, 191, 191, True),
    (1, 4, 2, 300, 129, True), (1, 4, 4, 129, 300, True), (1, 2, 2, 64, 64, True)])
@pytest.mark.parametrize("cl", [1, 2, 4])
def test_dkv_partition_covers_every_pair_once(b, h, hkv, sq, sk, causal, cl):
    """The kernel's items, skipped tiles and cluster split, emulated in
    float32, against jax.vjp of the reference's attention within 2e-4: Sk
    not a multiple of 64 (65, 100, 129, 191, 300), Sq != Sk both ways
    (keys past Sq see no query), GQA groups 1, 2, 3 and 4, causal and full,
    clusters of 1, 2 and 4."""
    q, k, v, do = _train_inputs(51 + sq + sk, b, h, hkv, sq, sk)
    dk, dv = dkv_hd16_emulated(*map(torch.from_numpy, (q, k, v, do)), causal, cl)
    _, jdk, jdv = _jax_grads(q, k, v, do, causal)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), **F32_BWD)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **F32_BWD)
    # the plain backward the card's kernel is held against agrees too
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd_lse(qt, kt, vt, causal)
    _, pdk, pdv = flash_attention_bwd(qt, kt, vt, o, lse, dot, causal)
    np.testing.assert_allclose(pdk.numpy(), dk.numpy(), **F32_BWD)
    np.testing.assert_allclose(pdv.numpy(), dv.numpy(), **F32_BWD)
    assert torch.allclose(attention_delta(o, dot), (dot * o).sum(-1), atol=1e-5)
