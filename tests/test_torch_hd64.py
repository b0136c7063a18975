"""Head dim 64 in bf16: the plain versions that the card's hd-64 serving
kernels are held against, and the partitions those kernels compute.

The hd-64 decode kernel (``decode_attention_lanes_kernel<64, NREP>``) takes
32-key tiles, block ``split`` of a head group's cluster taking tiles split,
split + n_split, ...; the block's warp w takes tiles w, w + 4, ... of the
block's; lane (j, u) of a warp holds columns 8u .. 8u + 7 of keys j, j + 4,
j + 8, ... of a tile and updates its online softmax every 16 keys (four
passes); (m, l, acc) partials merge over a warp's key lanes, a block's
warps and the cluster's blocks. The hd-64 serving forward
(``flash_fwd_kernel<64, false>``, the template's three-warpgroup form)
takes items of 192 query rows of one (batch, head), three warpgroups of 64
rows, walks 128-key tiles up to the item's causal end with an online softmax a row, masks only the tiles on a
warpgroup's diagonal or past Sk, and deals the items to a persistent grid of
P blocks in zigzag rounds (block b items b, 2P - 1 - b, 2P + b, ...), the
items of a group of heads whose K/V fit the L2 together in a row, each
group's last query blocks first. On the CPU each wrapper runs its plain
version; here those are held against the reference's Pallas kernels in
interpret mode and its oracles at the new tiles' and items' edges
(tolerances as tests/test_torch_contract.py: bf16 2e-2, decode LSE 1e-3),
with K/V (and Q) handed over as the model's transposed views, and both
partitions are emulated in float32 and held against the reference: every
key and every (query, key) pair lands in exactly one part, at any kv_len,
split, grid and ragged length. The CUDA kernels are held against the plain
versions on the card by tests/test_torch_gpu.py and ``chip_smoke.py``
phase 3.
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
from repro.kernels.flash_attention.kernel import flash_attention_fwd as pallas_fwd  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

HD = 64
TK = 32          # the hd-64 decode kernel's keys a tile (Lanes<64>::TK)
WARPS = 4        # its consumer warps (LANES_W)
KPP = 4          # keys a warp pass: 32 lanes, 8 a key (LaneGeo<64>::KPP)
STEP = 16        # keys a lane's online-softmax step: four passes (CH)
BM = 192         # the hd-64 forward's query rows an item: three warpgroups (Fwd<64, false>::BM)
WG_ROWS = 64     # a warpgroup's rows
BN = 128         # its keys a K/V tile (FBN)
BF16 = dict(rtol=2e-2, atol=2e-2)
F32 = dict(rtol=2e-5, atol=2e-5)
LSE_BF16 = dict(rtol=1e-3, atol=1e-3)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _model_view(a: np.ndarray) -> torch.Tensor:
    """(B, heads, S, hd) as the model hands it over: the (B, S, heads, hd)
    tensor read transposed, strides (S h hd, hd, h hd, 1)."""
    t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).transpose(1, 2)
    assert not t.is_contiguous() or a.shape[1] == 1
    return t


# ------------------------------ decode ----------------------------------------
S_DECODE = 66 * TK   # 2112: holds kv_len 2079; the Pallas kernel's blocks of 32 divide it


def _decode_inputs(seed, b, h, hkv, s):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, HD), dtype=np.float32),
            rng.standard_normal((b, hkv, s, HD), dtype=np.float32),
            rng.standard_normal((b, hkv, s, HD), dtype=np.float32))


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("kv_len", [1, TK - 1, TK, TK + 1, 63, 64, 65, 1024, 2079])
def test_decode_plain_matches_pallas_at_the_tile_edges(group, kv_len):
    """bf16 decode at hd 64, the cache read through the model's transposed
    view, kv_len at the 32-key tile's edges and two tiles' (63, 64, 65), the
    memory's 1024 frames and
    the serving cache's last step (2079), GQA groups 1 (SeamlessM4T's
    MHA), 2 and 4: the plain version against the Pallas kernel in interpret
    mode and against the reference's oracle; o within 2e-2, the LSE within
    1e-3."""
    q, k, v = _decode_inputs(11 + group + kv_len, 2, 2 * group, 2, S_DECODE)
    qt = torch.from_numpy(q).bfloat16()
    kt, vt = (_model_view(a).bfloat16() for a in (k, v))
    o, lse = decode_attention(qt, kt, vt, kv_len)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    for oj, lsej in (pallas_decode(qj, kj, vj, kv_len, block_k=TK, interpret=True),
                     jax_decode_ref(qj, kj, vj, kv_len, return_lse=True)):
        np.testing.assert_allclose(_np(o), _np(oj), **BF16)
        np.testing.assert_allclose(_np(lse), _np(lsej), **LSE_BF16)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32


@pytest.mark.parametrize("group", [1, 2, 4])
def test_decode_at_kv_len_0(group):
    """No valid position: the Pallas kernel's l == 0 guard gives o = 0 and
    lse = -1e30 (what the CUDA kernel gives, held on the card); the plain
    version and the reference's oracle both divide 0 by 0 alike."""
    q, k, v = _decode_inputs(21 + group, 2, 2 * group, 2, 3 * TK)
    o, lse = decode_attention(torch.from_numpy(q).bfloat16(),
                              *(_model_view(a).bfloat16() for a in (k, v)), 0)
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


def decode_hd64_emulated(q, k, v, kv_len: int, n_split: int):
    """The hd-64 kernel's partition in float32: block ``split`` of n_split
    takes tiles split + i n_split; its warp w tiles w, w + WARPS, ... of the
    block's; the warp's lane j keys j + KPP x of each tile, its online
    softmax updated every STEP keys (a key at or past kv_len scores -inf).
    Lanes merge pairwise (xor 8, 16: here key lanes 1, 2), then the block's
    warps, then the cluster's blocks. Returns (o, lse) with the l == 0
    guard, and how often each key was taken."""
    b, h, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rep = h // hkv
    kk = k.repeat_interleave(rep, 1)
    vv = v.repeat_interleave(rep, 1)
    scores = torch.einsum("bhd,bhkd->bhk", q, kk) / math.sqrt(hd) * math.log2(math.e)
    kv_len = max(0, min(kv_len, s))
    tiles = -(-kv_len // TK)
    taken = torch.zeros(s, dtype=torch.int32)

    def lane(tiles_of_warp, j):
        m = torch.full((b, h), -math.inf)
        l_, acc = torch.zeros(b, h), torch.zeros(b, h, hd)
        for t in tiles_of_warp:
            for x0 in range(0, TK // KPP, STEP // KPP):       # a step: STEP // KPP passes
                keys = [t * TK + x * KPP + j for x in range(x0, x0 + STEP // KPP)]
                valid = [x for x in keys if x < kv_len]
                for x in valid:
                    taken[x] += 1
                sc = torch.full((b, h, len(keys)), -math.inf)
                if valid:
                    sc[..., :len(valid)] = scores[..., valid]
                mn = torch.maximum(m, sc.amax(-1))
                base = torch.where(mn == -math.inf, 0.0, mn)
                alpha = torch.exp2(m - base)
                p = torch.exp2(sc - base[..., None])
                l_ = l_ * alpha + p.sum(-1)
                acc = acc * alpha[..., None]
                if valid:
                    acc = acc + torch.einsum("bhk,bhkd->bhd", p[..., :len(valid)],
                                             vv[:, :, valid])
                m = mn
        return m, l_, acc

    blocks = []
    for split in range(n_split):
        mine = list(range(split, tiles, n_split))   # the block's tiles, in order
        warp_parts = []
        for w in range(WARPS):
            lanes = [lane(mine[w::WARPS], j) for j in range(KPP)]
            for o in (1, 2):                        # the shuffle rounds over key lanes
                lanes = [_merge([lanes[j], lanes[j ^ o]]) for j in range(KPP)]
            warp_parts.append(lanes[0])
        blocks.append(_merge(warp_parts))
    m, l, acc = _merge(blocks)
    safe = torch.where(l == 0, 1.0, l)
    o = acc / safe[..., None]
    lse = torch.where(m == -math.inf, -1e30, (m + torch.log2(safe)) * math.log(2))
    return o, lse, taken


@pytest.mark.parametrize("n_split", [1, 3, 4, 8])
@pytest.mark.parametrize("kv_len", [0, 1, TK - 1, TK, TK + 1, 63, 64, 65, 1024, 2079])
def test_decode_partition_covers_every_key_once(n_split, kv_len):
    """The kernel's tiles, splits, warps, lanes and online-softmax steps,
    emulated in float32: every key before kv_len taken exactly once and no
    other, o and the LSE against the reference's oracle within 2e-5 (the
    Pallas kernel's guard at kv_len 0), at the tile's edges, the memory's
    1024 keys and the serving cache's 2079, with blocks past the last tile
    (n_split 8 over one tile) and blocks of more tiles than warps."""
    q, k, v = _decode_inputs(31 + kv_len + n_split, 1, 2, 2, S_DECODE)
    o, lse, taken = decode_hd64_emulated(*map(torch.from_numpy, (q, k, v)), kv_len, n_split)
    assert torch.equal(taken, (torch.arange(S_DECODE) < kv_len).int())
    if kv_len == 0:
        assert (o == 0).all() and (lse == -1e30).all()
        return
    oj, lsej = jax_decode_ref(*map(jnp.asarray, (q, k, v)), kv_len, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lsej), **F32)


# ------------------------------ the forward -----------------------------------
def _train_inputs(seed, b, h, hkv, sq, sk):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for shape in
                 ((b, h, sq, HD), (b, hkv, sk, HD), (b, hkv, sk, HD)))


def _blocks(s: int) -> int:
    """A Pallas block that divides ``s``: 128 rows where it can, 32, else all."""
    return 128 if s % 128 == 0 else 32 if s % 32 == 0 else s


#: (B, H, Hkv, Sq, Sk, causal): SeamlessM4T's cross-attention (Sq = 2048
#: against its 1024 frames, unmasked, MHA); Sq off the 192-row items (191,
#: 193, 385) and Sk off the 128-key tiles (129, 300); Sq != Sk both ways;
#: GQA groups 1, 2 and 4; causal and full
FWD_CASES = [(1, 2, 2, 2048, 1024, False),
             (1, 4, 2, 191, 191, True),
             (1, 4, 1, 193, 300, False),
             (2, 4, 4, 385, 129, True),
             (1, 8, 2, 129, 300, True),
             (1, 2, 1, 300, 129, False)]


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", FWD_CASES)
def test_forward_plain_matches_pallas_at_the_new_edges(b, h, hkv, sq, sk, causal):
    """The serving forward (``kernel.py:112``) at hd 64 in bf16, Q, K and V
    read through the model's transposed views: the plain version the card's
    three-warpgroup forward is held against, against the Pallas kernel in
    interpret mode (128-row blocks where they divide S, else 32, else one
    block) and against the reference's oracle, within 2e-2."""
    q, k, v = _train_inputs(61 + sq + sk, b, h, hkv, sq, sk)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    jo = pallas_fwd(qj, kj, vj, causal=causal, block_q=_blocks(sq), block_k=_blocks(sk),
                    interpret=True)
    o = flash_attention(*(_model_view(a).bfloat16() for a in (q, k, v)), causal)
    assert o.dtype == torch.bfloat16 and o.shape == (b, h, sq, HD)
    np.testing.assert_allclose(_np(o), _np(jo), **BF16)
    np.testing.assert_allclose(_np(o), _np(jax_flash_ref(qj, kj, vj, causal=causal)), **BF16)


def block_items(p: int, n: int) -> list[list[int]]:
    """The items each block of a persistent grid of ``p`` takes from ``n``
    (the kernel's next_item): block b takes b, then zigzag rounds of p
    items, in reverse order on odd rounds (2p - 1 - b, 2p + b, ...)."""
    out = []
    for b in range(p):
        mine, item = [], b
        while item < n:
            mine.append(item)
            k = b if (item // p) % 2 == 0 else p - 1 - b
            item = item - k + p + (p - 1 - k)
        out.append(mine)
    return out


def work_item(x: int, nm: int, bh_all: int, group: int) -> tuple[int, int]:
    """Item ``x`` -> (batch * H + head, first query row): heads in groups of
    ``group``, inside a group the last query blocks of every head first
    (the kernel's work_item at items of BM rows)."""
    span, g0 = group * nm, x // (group * nm) * group
    in_group, idx = min(group, bh_all - g0), x % span
    return g0 + idx % in_group, (nm - 1 - idx // in_group) * BM


def fwd_hd64_emulated(q, k, v, causal: bool, p: int, group: int):
    """The three-warpgroup forward's partition in float32 over a grid of
    ``p`` blocks (at most one an item) and head groups of ``group``: each
    item's three warpgroups walk the item's 128-key tiles in order with an
    online softmax in the log2 domain, the mask applied on the tiles a
    warpgroup masks and nowhere else, rows past Sq not written. Returns
    (o, cover), ``cover`` (B H, Sq, Sk) counting how often each written
    (query, key) pair was taken."""
    b, h, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    scale2 = math.log2(math.e) / math.sqrt(hd)
    vis = torch.ones(sq, sk, dtype=torch.bool)
    vis = vis.tril() if causal else vis
    nm = -(-sq // BM)
    n_items = b * h * nm
    o = torch.full_like(q, math.nan)
    cover = torch.zeros(b * h, sq, sk, dtype=torch.int32)
    order = [x for mine in block_items(min(p, n_items), n_items) for x in mine]
    assert sorted(order) == list(range(n_items))          # every item once
    for x in order:
        bh, m0 = work_item(x, nm, b * h, group)
        bb, hh = divmod(bh, h)
        n_end = min(sk, m0 + BM) if causal else sk
        for wg in range(BM // WG_ROWS):
            m0w = m0 + wg * WG_ROWS
            if m0w >= sq:
                continue                                  # all past Sq: nothing written
            rows = torch.arange(m0w, min(m0w + WG_ROWS, sq))
            m = torch.full((len(rows),), -math.inf)
            l_ = torch.zeros(len(rows))
            acc = torch.zeros(len(rows), hd)
            for n0 in range(0, n_end, BN):
                keys = torch.arange(n0, min(n0 + BN, sk))
                s = (q[bb, hh, rows] @ k[bb, hh // rep, keys].T) * scale2
                masked = n0 + BN > sk or (causal and n0 + BN - 1 > m0w)
                seen = vis[rows][:, keys] if masked else torch.ones(len(rows), len(keys),
                                                                    dtype=torch.bool)
                s = s.masked_fill(~seen, -math.inf)
                cover[bh, rows[:, None], keys[None, :]] += seen.int()
                m_new = torch.maximum(m, s.amax(-1))
                base = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp2(m - base)
                pr = torch.exp2(s - base[:, None])
                l_ = l_ * alpha + pr.sum(-1)
                acc = acc * alpha[:, None] + pr @ v[bb, hh // rep, keys]
                m = m_new
            o[bb, hh, rows] = acc / torch.where(l_ == 0, 1.0, l_)[:, None]
    return o, cover


#: (B, H, Hkv, Sq, Sk, causal): one item and several a head, Sq off the
#: 192-row items and Sk off the 128-key tiles, Sq != Sk both ways (keys
#: past Sq unseen by a causal row, queries past Sk), GQA groups 1, 2, 3, 4
PARTITION_CASES = [(1, 2, 2, 100, 100, True), (2, 4, 2, 191, 191, True),
                   (1, 3, 1, 193, 300, False), (1, 4, 4, 129, 300, True),
                   (1, 4, 2, 400, 129, True), (1, 6, 2, 385, 385, True),
                   (2, 2, 1, 200, 64, False)]


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal", PARTITION_CASES)
@pytest.mark.parametrize("p,group", [(1, 1), (3, 2), (1000, 1000)])
def test_forward_partition_covers_every_pair_once(b, h, hkv, sq, sk, causal, p, group):
    """The three-warpgroup forward's items of 192 rows, dealt to a
    persistent grid of 1, 3 and (at most) 1000 blocks in zigzag rounds over
    head groups of 1, 2 and all heads, their 128-key tiles up to the item's
    causal end and the tiles each warpgroup masks, emulated in float32:
    every item taken by one block, every visible (query, key) pair taken
    exactly once and no other, every row written, o against the
    reference's attention within 2e-5, at Sq and Sk off the items and
    tiles, Sq != Sk both ways, causal and full."""
    q, k, v = _train_inputs(81 + sq + sk, b, h, hkv, sq, sk)
    o, cover = fwd_hd64_emulated(*map(torch.from_numpy, (q, k, v)), causal, p,
                                 min(group, b * h))
    vis = torch.ones(sq, sk, dtype=torch.int32)
    assert torch.equal(cover, (vis.tril() if causal else vis).expand(b * h, sq, sk))
    assert not torch.isnan(o).any()
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_flash_ref(
        *map(jnp.asarray, (q, k, v)), causal=causal)), **F32)
