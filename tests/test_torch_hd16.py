"""Head dim 16 in bf16: the plain versions that the card's hd-16 kernels are
held against, and the partitions those kernels compute.

The hd-16 decode kernel (``decode_attention_hd16_kernel``) takes 64-key
tiles, block ``split`` of a head group's cluster taking tiles split, split +
n_split, ..., and merges (m, l, acc) partials: a lane's keys, a warp's
lanes, a block's warps, the cluster's blocks. The hd-16 dK/dV kernel
(``flash_bwd_dkv_cluster_kernel``) takes items of 64 keys, splits an item's
(query head, 64-query tile) list over the blocks of a cluster (rank r tiles
r, r + CL, ...) and sums the blocks' f32 partials in rank order. The hd-16
forward (``flash_fwd_group_kernel``, with and without the LSE) and dQ
(``flash_bwd_dq_group_kernel``) take items of 64 rows that pack a GQA
group's query heads (row p hpi + j is head j at position p0 + p, hpi =
min(n_rep, 64), a wider group in chunks of 64 heads), walk key tiles (128
keys in the forward, 64 in dQ) up to the item's causal end and mask only
the tiles on the diagonal or past Sk; the forward keeps an online softmax a
row; a persistent grid of P blocks deals the items out in zigzag rounds
(block b items b, 2P - 1 - b, 2P + b, ...). On the CPU each wrapper runs
its plain version; here those are held
against the reference's Pallas kernels in interpret mode and its oracles at
the new tiles' and items' edges (tolerances as
tests/test_torch_contract.py: bf16 2e-2, float32 2e-5 forward and 2e-4
backward, decode LSE 1e-3), and the four partitions are emulated in float32
and held against the reference: every key and (query, key) pair lands in
exactly one part, at any kv_len, group, split and ragged length. The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_gpu.py and ``chip_smoke.py`` phase 3.
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
from repro.kernels.flash_attention.kernel import flash_attention_fwd as pallas_fwd  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_fwd_lse)
from repro_torch.kernels.flash_attention.ref import attention_delta  # noqa: E402

TK = 64          # the hd-16 decode kernel's keys a tile (H16_TK)
BK = BQ = 64     # the hd-16 dK/dV kernel's keys an item and queries a tile
FWD_BN = 128     # the hd-16 forward's keys a tile (Fwd16::BN)
DQ_BN = 64       # the hd-16 dQ's (Dq16::BN)
GROUP_ROWS = 64  # their rows an item: packed (position, head) pairs
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


# ------------------------- the forward and dQ ---------------------------------
def _blocks(s: int) -> int:
    """A Pallas block that divides ``s``: 32 rows where it can, else all."""
    return 32 if s % 32 == 0 else s


#: (B, H, Hkv, Sq, Sk, causal, dtype): GQA groups 1, 2, 3, 4 and 8, Sq and
#: Sk off the 64-key tiles and off the items' positions (64 / hpi), causal
#: and full, Sq != Sk unmasked
FWD_DQ_CASES = [(1, 4, 1, 96, 96, True, "f32"),       # group 4: 16 positions an item
                (2, 6, 2, 100, 100, True, "bf16"),    # group 3: 21 positions and a tail row
                (1, 8, 4, 77, 77, False, "bf16"),     # group 2, full
                (1, 8, 1, 160, 160, True, "f32"),     # group 8
                (1, 2, 2, 70, 130, False, "bf16"),    # group 1, Sq < Sk unmasked
                (2, 8, 2, 130, 70, False, "f32")]     # group 4, Sq > Sk unmasked


def _dtypes(dt):
    return (torch.float32, jnp.float32) if dt == "f32" else (torch.bfloat16, jnp.bfloat16)


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal,dt", FWD_DQ_CASES)
def test_forward_plain_matches_pallas_at_the_new_edges(b, h, hkv, sq, sk, causal, dt):
    """The serving forward (``kernel.py:112``) and the forward with LSE
    (``backward.py:109``) at hd 16, the Pallas kernels in interpret mode
    with 32-row blocks where they divide S (else one block): the plain
    versions the card's grouped forward is held against, float32 within
    2e-5 and bf16 within 2e-2; the LSE within 2e-5 in float32 and 1e-3 in
    bf16."""
    q, k, v, _ = _train_inputs(61 + sq + sk, b, h, hkv, sq, sk)
    tdt, jdt = _dtypes(dt)
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    bq, bk = _blocks(sq), _blocks(sk)
    jo = pallas_fwd(qj, kj, vj, causal=causal, block_q=bq, block_k=bk, interpret=True)
    jo2, jlse = pallas_fwd_lse(qj, kj, vj, causal=causal, block_q=bq, block_k=bk, interpret=True)
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    o = flash_attention(qt, kt, vt, causal)
    o2, lse = flash_attention_fwd_lse(qt, kt, vt, causal)
    tol = F32 if dt == "f32" else BF16
    for got, want in ((o, jo), (o2, jo2)):
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(lse), _np(jlse),
                               **(F32 if dt == "f32" else dict(rtol=1e-3, atol=1e-3)))


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal,dt", FWD_DQ_CASES)
def test_dq_plain_matches_pallas_and_vjp_at_the_new_edges(b, h, hkv, sq, sk, causal, dt):
    """dQ at hd 16 (``backward.py:283``): the plain backward the card's
    cluster dQ is held against, against the Pallas backward in interpret
    mode and against jax.vjp of the reference's attention (on the same
    inputs, rounded to bf16 for the bf16 cases): float32 within 2e-4, bf16
    within 2e-2."""
    q, k, v, do = _train_inputs(71 + sq + sk, b, h, hkv, sq, sk)
    tdt, jdt = _dtypes(dt)
    qj, kj, vj, doj = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    bq, bk = _blocks(sq), _blocks(sk)
    jo, jlse = pallas_fwd_lse(qj, kj, vj, causal=causal, block_q=bq, block_k=bk, interpret=True)
    jdq = pallas_bwd(qj, kj, vj, jo, jlse, doj, causal=causal, block_q=bq, block_k=bk,
                     interpret=True)[0]
    qt, kt, vt, dot = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    o, lse = flash_attention_fwd_lse(qt, kt, vt, causal)
    dq = flash_attention_bwd(qt, kt, vt, o, lse, dot, causal)[0]
    tol = F32_BWD if dt == "f32" else BF16
    np.testing.assert_allclose(_np(dq), _np(jdq), **tol)
    vq, vk, vv, vdo = (_np(x) for x in (qt, kt, vt, dot))   # the inputs as both saw them
    np.testing.assert_allclose(_np(dq), np.asarray(_jax_grads(vq, vk, vv, vdo, causal)[0]),
                               **tol)


def block_items(p: int, n: int) -> list[list[int]]:
    """The items each block of a persistent grid of ``p`` takes from ``n``
    (next_group_item): block b takes b, then zigzag rounds of p items, in
    reverse order on odd rounds (2p - 1 - b, 2p + b, ...)."""
    out = []
    for b in range(p):
        mine, item = [], b
        while item < n:
            mine.append(item)
            k = b if (item // p) % 2 == 0 else p - 1 - b
            item = item - k + p + (p - 1 - k)
        out.append(mine)
    return out


def group_items(h: int, hkv: int, sq: int, p: int):
    """The hd-16 forward's and dQ's items over one batch, block by block of
    a persistent grid of ``p`` blocks (:func:`block_items`; items numbered
    the last positions first): (kv head, first position, positions,
    [(query head, position) of each output row]), row r of an item being
    head r % hpi of its chunk at position p0 + r // hpi (GroupRows,
    group_item, group_row)."""
    n_rep = h // hkv
    hpi = min(n_rep, GROUP_ROWS)
    pos, chunks = GROUP_ROWS // hpi, -(-n_rep // hpi)
    npb, groups = -(-sq // pos), hkv * chunks
    order = [x for mine in block_items(min(p, groups * npb), groups * npb) for x in mine]
    assert sorted(order) == list(range(groups * npb))      # every item once
    items = []
    for x in order:
        kvh, chunk = x % groups // chunks, x % groups % chunks
        p0 = (npb - 1 - x // groups) * pos
        rows = [(kvh * n_rep + chunk * hpi + r % hpi, p0 + r // hpi)
                for r in range(hpi * pos)
                if chunk * hpi + r % hpi < n_rep and p0 + r // hpi < sq]
        items.append((kvh, p0, pos, rows))
    return items


def _item_tiles(p0: int, pos: int, sk: int, causal: bool, bn: int):
    """An item's key tiles of ``bn`` keys: (first key, whether the kernel
    masks it)."""
    n_end = min(sk, p0 + pos) if causal else sk
    return [(n0, n0 + bn > sk or (causal and n0 + bn - 1 > p0))
            for n0 in range(0, n_end, bn)]


def _visible(sq: int, sk: int, causal: bool) -> torch.Tensor:
    """(Sq, Sk): the keys each query sees (top-left causal)."""
    vis = torch.ones(sq, sk, dtype=torch.bool)
    return vis.tril() if causal else vis


def fwd_hd16_emulated(q, k, v, causal: bool, p: int):
    """The grouped forward's partition in float32 over a grid of ``p``
    blocks: each item's packed rows walk its 128-key tiles in order with an
    online softmax in the log2 domain (the mask applied on the tiles the
    kernel masks, nowhere else); returns (o, lse, cover), ``cover`` (H, Sq,
    Sk) counting how often each (query, key) pair was taken."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale2 = math.log2(math.e) / math.sqrt(hd)
    vis = _visible(sq, sk, causal)
    o = torch.zeros_like(q)
    lse = torch.zeros(b, h, sq)
    cover = torch.zeros(h, sq, sk, dtype=torch.int32)
    for kvh, p0, pos, rows in group_items(h, hkv, sq, p):
        heads = torch.tensor([r[0] for r in rows])
        qpos = torch.tensor([r[1] for r in rows])
        m = torch.full((b, len(rows)), -math.inf)
        l_ = torch.zeros(b, len(rows))
        acc = torch.zeros(b, len(rows), hd)
        for n0, masked in _item_tiles(p0, pos, sk, causal, FWD_BN):
            keys = torch.arange(n0, min(n0 + FWD_BN, sk))
            s = torch.einsum("brd,bkd->brk", q[:, heads, qpos], k[:, kvh, keys]) * scale2
            seen = vis[qpos][:, keys] if masked else torch.ones(len(rows), len(keys), dtype=torch.bool)
            s = s.masked_fill(~seen, -math.inf)
            cover[heads[:, None], qpos[:, None], keys[None, :]] += seen.int()
            m_new = torch.maximum(m, s.amax(-1))
            base = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s - base[..., None])
            l_ = l_ * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("brk,bkd->brd", p, v[:, kvh, keys])
            m = m_new
        o[:, heads, qpos] = acc / torch.where(l_ == 0, 1.0, l_)[..., None]
        lse[:, heads, qpos] = torch.where(l_ == 0, m, m + torch.log2(l_)) * math.log(2)
    return o, lse, cover


#: (B, H, Hkv, Sq, Sk, causal): groups 1, 2, 3 with a tail row, 4, 8, 16, and 80
#: in a full and a part chunk; Sq and Sk off the tiles, Sq != Sk both ways
PARTITION_CASES = [(2, 8, 2, 100, 100, True), (1, 6, 2, 191, 191, True),
                   (1, 4, 1, 77, 65, False), (1, 4, 4, 129, 300, True),
                   (1, 4, 2, 300, 129, True), (1, 16, 2, 70, 130, False),
                   (1, 64, 4, 50, 50, True), (1, 80, 1, 37, 90, True), (1, 2, 2, 64, 64, True)]


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", PARTITION_CASES)
@pytest.mark.parametrize("p", [1, 3, 1000])
def test_forward_partition_covers_every_pair_once(b, h, hkv, sq, sk, causal, p):
    """The grouped forward's items (a GQA group's heads packed in 64 rows),
    dealt to a persistent grid of 1, 3 and (at most) 1000 blocks in zigzag
    rounds, their 128-key tiles and masked tiles, emulated in float32:
    every item taken by one block, every visible (query, key) pair taken
    exactly once and no other, o against the reference's attention within
    2e-5 and the LSE against the plain version's within 2e-5, at Sq and Sk
    off the tiles, Sq != Sk both ways, causal and full."""
    q, k, v, _ = _train_inputs(81 + sq + sk, b, h, hkv, sq, sk)
    o, lse, cover = fwd_hd16_emulated(*map(torch.from_numpy, (q, k, v)), causal, p)
    assert torch.equal(cover, _visible(sq, sk, causal).int().expand(h, sq, sk))
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_flash_ref(
        *map(jnp.asarray, (q, k, v)), causal=causal)), **F32)
    _, want = flash_attention_fwd_lse(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), **F32)


def dq_hd16_emulated(q, k, v, do, causal: bool, p: int):
    """The grouped dQ's partition in float32 over a grid of ``p`` blocks:
    each item's packed rows walk its 64-key tiles in order, dq summed in
    f32 and scaled once at the end; P from the exact LSE, dS from D =
    rowsum(dO O), as the kernel's inputs. Returns (dq, cover)."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    vis = _visible(sq, sk, causal)
    rep = h // hkv
    s_all = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(rep, 1)) * scale
    lse = torch.logsumexp(s_all.masked_fill(~vis, -math.inf), -1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s_all - lse[..., None]).masked_fill(~vis, 0.0),
                     v.repeat_interleave(rep, 1))
    dd = (do * o).sum(-1)
    dq = torch.zeros_like(q)
    cover = torch.zeros(h, sq, sk, dtype=torch.int32)
    for kvh, p0, pos, rows in group_items(h, hkv, sq, p):
        heads = torch.tensor([r[0] for r in rows])
        qpos = torch.tensor([r[1] for r in rows])
        acc = torch.zeros(b, len(rows), hd)
        for n0, masked in _item_tiles(p0, pos, sk, causal, DQ_BN):
            keys = torch.arange(n0, min(n0 + DQ_BN, sk))
            s = torch.einsum("brd,bkd->brk", q[:, heads, qpos], k[:, kvh, keys]) * scale
            pr = torch.exp(s - lse[:, heads, qpos, None])
            seen = vis[qpos][:, keys] if masked else torch.ones(len(rows), len(keys),
                                                                 dtype=torch.bool)
            pr = pr.masked_fill(~seen, 0.0)
            cover[heads[:, None], qpos[:, None], keys[None, :]] += seen.int()
            dp = torch.einsum("brd,bkd->brk", do[:, heads, qpos], v[:, kvh, keys])
            acc += torch.einsum("brk,bkd->brd", pr * (dp - dd[:, heads, qpos, None]),
                                k[:, kvh, keys])
        dq[:, heads, qpos] = acc * scale
    return dq, cover


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", PARTITION_CASES)
@pytest.mark.parametrize("p", [1, 3, 1000])
def test_dq_partition_covers_every_pair_once(b, h, hkv, sq, sk, causal, p):
    """The grouped dQ's items, dealt to a persistent grid of 1, 3 and (at
    most) 1000 blocks in zigzag rounds, their 64-key tiles and masked
    tiles, emulated in float32: every item taken by one block, every
    visible (query, key) pair taken exactly once, dq against jax.vjp of the
    reference's attention within 2e-4 and against the plain backward, at
    groups 1, 2, 3, 4, 8, 16 and 80, Sq and Sk off the tiles, Sq != Sk both
    ways, causal and full."""
    q, k, v, do = _train_inputs(91 + sq + sk, b, h, hkv, sq, sk)
    dq, cover = dq_hd16_emulated(*map(torch.from_numpy, (q, k, v, do)), causal, p)
    assert torch.equal(cover, _visible(sq, sk, causal).int().expand(h, sq, sk))
    np.testing.assert_allclose(dq.numpy(), np.asarray(_jax_grads(q, k, v, do, causal)[0]),
                               **F32_BWD)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd_lse(qt, kt, vt, causal)
    pdq = flash_attention_bwd(qt, kt, vt, o, lse, dot, causal)[0]
    np.testing.assert_allclose(pdq.numpy(), dq.numpy(), **F32_BWD)
