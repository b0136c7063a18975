#!/usr/bin/env python3
"""Hold and time the bf16 attention kernels of their own at a head dim (16:
decode, the forward with and without the LSE, dK/dV and dQ; 64: the serving
forward and decode) beside another source of the same kernels (a
parent's), in one call on one card.

    python3 tools/kernel_compare.py --source parent=local/parent
    python3 tools/kernel_compare.py --source parent=local/parent --quick fwd-bn-64 fwd-trace
    python3 tools/kernel_compare.py --hd 64 --source parent=local/parent dec64-tk-64

``--hd 64`` (see :func:`main64`) holds and times SeamlessM4T's hd-64 shapes
through ``chip_smoke.check_hd64`` for each source in turns, and holds the
other head dims' bits (``--hold-hd64``: the hd-64 forward's and decode's
own bits too, against the first source, for a rewrite that should keep
them); without it, hd 16 as below.

``--source NAME=DIR``: a directory holding ``decode_attention.cu`` and
``flash_attention.cu`` with the checkout's C interface, e.g. a parent's,
written with ``git show <commit>:src/repro_torch/kernels/decode_attention/
csrc/decode_attention.cu > local/parent/decode_attention.cu`` (and the same
for ``flash_attention/csrc/flash_attention.cu``). The checkout's sources run
as ``new``. Needs a CUDA card and nvcc; every source is built in parallel
into ``build/kernel_compare/`` with ``-Xptxas -v`` (the checkout is never
touched), and the registers and spills of its decode and flash kernels are
printed. Further arguments name VARIANTS: the checkout's sources with a few
lines edited, run as sources of their own (a variant that leaves work out
fails the checks, and says so). Three kinds read where the time goes rather
than time a design: ``fwd-trace`` and ``dq-trace`` write each block's SM,
start and duration over its first output row (:func:`trace_report`: the
span, each SM's tiles, the blocks' concurrency), ``fwd-phases``,
``dq-phases`` and ``fwd-outside`` the SM clocks a tile each phase takes
(:func:`phases_report`), and ``--rates`` alone runs RATES_SOURCE, the
special function unit's exponential rate beside the softmax's other work.
The whole summary goes to ``chiprun_out/kernel_compare.json``
(``chiprun_out/kernel_compare_hd64.json`` with ``--hd 64``).

Each source is held first: the hd-16 decode cases of ``chip_smoke.py``'s
phase 3 (:func:`chip_smoke.decode_check`: within DECODE_REL of the plain
version and one bf16 ulp + DECODE_ULP_FLOOR of the f64 value) with kv_len at
the 64-key tile's edges, one captured launch replayed while kv_len crosses
them; the serving forward at phase 3's hd-16 cases and EDGES (each query row
within TRAIN_ROW_REL, two calls the same bits); the hd-16 training cases,
DKV_EXTRA and EDGES (:func:`chip_smoke.training_case`: o and dq per query
row, dk and dv per key row within TRAIN_ROW_REL, the LSE within 1e-3, the
backward's and the forward-with-LSE's bits the same in two calls). EDGES
pack every GQA group (1, 2, 3, 4, 8, 16, 80) with Sq and Sk off the 64-key
tiles and the items' positions. Then every source is timed in turns, the
sources in the order given and back (old, new, new, old): decode at the
SMOKE serving shape (4, 8/2 heads, cache 2081, hd 16, kv_len 2079) as
chip_smoke times a kernel (one launch a graph replay, the L2 flushed by a
write) and as GRAPH_LAUNCHES launches on their own caches in one graph
after a read of the flush buffer, each beside SDPA and, in the graph, an
empty kernel with the decode launch's block count (the floor); the forward,
the forward with LSE, dK/dV and dQ at (4, 8/2, 2048, 16) causal, beside
SDPA's forward and the aten call that returns O and the logsumexp
(:func:`chip_smoke.sdpa_lse`). Unless ``--quick``, the hd 32, 64 and 128
instantiations (which these designs leave alone) of decode and of the four
flash kernels give each source's bits, held against the first source's, and
are timed in the same turns. Prints one line per reading, then a JSON
summary with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels"
SOURCES = {"decode_attention": CSRC / "decode_attention" / "csrc" / "decode_attention.cu",
           "flash_attention": CSRC / "flash_attention" / "csrc" / "flash_attention.cu"}
OUT = ROOT / "build" / "kernel_compare"

#: kv_len at the new tile's edges (64 keys) and at the cache's ends
DECODE_LENS = (0, 1, 63, 64, 65, 127, 128, 129, 1000, 2079, 2081)
#: dK/dV cases beyond phase 3's: Sk not a multiple of 64, causal and full
DKV_EXTRA = (("sk-100-causal", (2, 8, 2, 100, 100, True)),
             ("sk-65-full", (1, 4, 1, 77, 65, False)),
             ("sk-191-gqa3", (2, 6, 2, 191, 191, True)))
#: the shapes the other head dims are held and timed at:
#: decode (B, H, Hkv, S, hd, kv_len), dK/dV (B, H, Hkv, Sq, Sk, hd, causal)
OTHER_DECODE = ((4, 8, 2, 2081, 32, 2079), (4, 8, 2, 2081, 64, 2079),
                (4, 32, 8, 2081, 128, 2079))
OTHER_DKV = ((4, 8, 2, 2048, 2048, 32, True), (4, 8, 2, 2048, 2048, 64, True),
             (8, 16, 16, 2048, 2048, 128, True))
#: the forward's and dQ's edges at hd 16 beyond phase 3's, (B, H, Hkv, Sq, Sk,
#: causal): the GQA groups' packings (8, 16, 80 in chunks of 64, 1, 2), Sq
#: and Sk off the 64-key tiles and the items' positions, Sq != Sk both ways
EDGES = (("gqa8-100", (2, 16, 2, 100, 100, True)),
         ("gqa16-200", (1, 64, 4, 200, 200, True)),
         ("gqa80-full", (1, 80, 1, 37, 90, False)),
         ("gqa1-sq<sk", (1, 4, 4, 129, 300, True)),
         ("gqa2-sq>sk", (1, 4, 2, 300, 129, True)))
#: the flash kernels timed and held at the other head dims (OTHER_DKV's shapes)
OTHER_FLASH = ("fwd", "fwd_lse", "dkv", "dq")
#: --hd 64: the shapes whose bits each source must keep and whose times are
#: read in the same turns (the hd-16, 32 and 128 kernels, and the hd-64
#: training kernels, which the hd-64 designs leave alone): decode (B, H, Hkv,
#: S, hd, kv_len), the flash kernels (B, H, Hkv, Sq, Sk, hd, causal) with the
#: kinds held at each
OTHER_DECODE_64 = ((4, 8, 2, 2081, 16, 2079), (4, 8, 2, 2081, 32, 2079),
                   (4, 32, 8, 2081, 128, 2079))
OTHER_DKV_64 = (((4, 8, 2, 2048, 2048, 16, True), OTHER_FLASH),
                ((4, 8, 2, 2048, 2048, 32, True), OTHER_FLASH),
                ((4, 16, 16, 2048, 2048, 64, True), ("fwd_lse", "dkv", "dq")),
                ((8, 16, 16, 2048, 2048, 128, True), OTHER_FLASH))

OUTSIDE = "expected to fail the checks"
_SPLIT = "  static constexpr int MAX_SPLIT = 8;   // blocks a head group"
_TK = "  static constexpr int TK = 64;         // keys a tile"
_WARPS = "constexpr int LANES_W = 4; "
_NTILES = "    return split >= tiles ? 0 : (tiles - split + n_split - 1) / n_split;"
_EARLY = "      for (; i < G::EARLY && tile_key(i) < p.S; ++i) issue(i);\n"
_FINAL = "  if (split != 0) return;  // nothing reads the others' shared memory\n"
_CL = "constexpr int DKV16_CL = 4; "
_MINB = "constexpr int DKV16_MINB = 4; "
_DST = "  static constexpr int ST = 4;   // ring stages (Q, dO and row statistics)"
_EXP = "            float pm = ex2_ftz(fmaf(sa[x], scale_log2, -lsev[2 * j + (e & 1)] * LOG2E));"
_BQ = "  static constexpr int BQ = 64;  // queries a Q/dO tile\n  static constexpr int ST = 4; "
_MASK = "        probs(Flag<true>{});"
_MASK_IF = "      if ((m0 + BQ > Sq) || (causal && m0 < n0 + C::BK - 1))\n"
_PACK = """    pack_a<BQ>(pf, sa);
    pack_a<BQ>(df, pd);
    // dV += P^T dO, dK += dS^T Q (the k dimension is the query)
"""
_PACK_TRUNC = """#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pf[kk][x] = __byte_perm(__float_as_uint(sa[8 * kk + 2 * x]),
                                __float_as_uint(sa[8 * kk + 2 * x + 1]), 0x7632);
        df[kk][x] = __byte_perm(__float_as_uint(pd[8 * kk + 2 * x]),
                                __float_as_uint(pd[8 * kk + 2 * x + 1]), 0x7632);
      }
    // dV += P^T dO, dK += dS^T Q (the k dimension is the query)
"""
_DVDK = """#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {  // 16 queries a k-step: 16 rows of 32 bytes
      wgmma_rs<HD>(dva, pf[kk], q_mnmaj + off + do_off + kk * (16 * C::SW >> 4));
      wgmma_rs<HD>(dka, df[kk], q_mnmaj + off + kk * (16 * C::SW >> 4));
    }
"""
_DVDK_NONE = """    {
      uint32_t fold = 0;  // every packed fragment used, so none is dropped
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) fold ^= pf[kk][x] ^ df[kk][x];
      dva[0] += __uint_as_float(fold & 0x3f800000u);
    }
"""
_FEXP = "\n      s[i] = ex2_ftz(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));"
_QEXP = "        float p = ex2_ftz(fmaf(s[x], scale_log2, -lse2[rh]));"
_FPV = """#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)  // 16 keys a k-step: 16 rows of 32 bytes
        wgmma_rs<HD>(oacc, pa[kk], v_desc + off + kk * (16 * C::SW >> 4));
"""
_FSOFT = ("      if ((n0 + BN > Sk) || (causal && n0 + BN - 1 > it.p0))\n"
          "        online_softmax(n0, Flag<true>{});\n      else\n"
          "        online_softmax(n0, Flag<false>{});\n")
_QDSK = """#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)  // 16 keys a k-step: 16 rows of 32 bytes
        wgmma_rs<HD>(dqa, da[kk], k_mnmaj + off + kk * (16 * C::SW >> 4));
"""
#: what a trace variant's records carry beside them, to be told from outputs
TRACE_MARK = 0x600DF00D
_NOW = '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(trace_{0}));\n'
_TRACE_DECL = "  uint64_t trace_t0, trace_tq = 0, trace_t1;\n" + _NOW.format("t0")
_FT0 = "  uint32_t pa[BN / 16][4];  // P as bf16 A fragments\n"
_QT0 = "  uint32_t da[BN / 16][4];      // dS as bf16 A fragments\n"
_FTQ = ("    if (!bad && n_tiles > 0) mbar_wait(full_q + nth % ST, (uint32_t)(nth / ST) & 1u, "
        "stuck);\n")
_QTQ = "    if (!bad) mbar_wait(full_q + nth % ST, (uint32_t)(nth / ST) & 1u, stuck);\n"
_TQ = "    if (nth == 0) {\n  " + _NOW.format("tq") + "    }\n"
_DRAIN = ("  if (threadIdx.x == 0) {  // nothing in flight into shared memory from here on\n"
          "    drain_ring(full_q, ST, q_issued);\n    drain_ring(full, ST, issued);\n  }\n}\n")
_FTEND = "            oacc[4 * d + 2 * rh] * inv, oacc[4 * d + 2 * rh + 1] * inv);\n    }\n  }\n"
_QTEND = "            dqa[4 * d + 2 * rh] * mul, dqa[4 * d + 2 * rh + 1] * mul);\n    }\n  }\n"


def _trace_store(out: str) -> str:
    """Thread 0 writes its block's record over row 0 of its first item
    (after the block's own stores): the SM, the start (globaltimer, ns), the
    first Q load's and the whole block's nanoseconds from it, its tiles, its
    block index and TRACE_MARK."""
    return (_NOW.format("t1") + "  __syncthreads();\n  if (threadIdx.x == 0) {\n"
            "    const GroupItem first = group_item(blockIdx.x, gr, B, Hkv, n_rep, Sq);\n"
            "    uint32_t smid;\n    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
            f"    uint32_t* rec = reinterpret_cast<uint32_t*>({out});\n"
            "    rec[0] = smid;\n    rec[1] = (uint32_t)trace_t0;\n"
            "    rec[2] = (uint32_t)(trace_t0 >> 32);\n"
            "    rec[3] = (uint32_t)(trace_tq - trace_t0);\n"
            "    rec[4] = (uint32_t)(trace_t1 - trace_t0);\n"
            f"    rec[5] = (uint32_t)f;\n    rec[6] = blockIdx.x;\n    rec[7] = {TRACE_MARK}u;\n  }}\n")


TRACE_EDITS = {
    "fwd": [(_FT0, _FT0 + _TRACE_DECL), (_FTQ, _FTQ + _TQ),
            (_FTEND + _DRAIN, _FTEND + _trace_store(
                "o + first.b * o_sb + first.head0 * o_sh + (int64_t)first.p0 * o_ss") + _DRAIN)],
    "dq": [(_QT0, _QT0 + _TRACE_DECL), (_QTQ, _QTQ + _TQ),
           (_QTEND + _DRAIN, _QTEND + _trace_store(
               "dq + first.b * dqs.b + first.head0 * dqs.h + (int64_t)first.p0 * dqs.s")
            + _DRAIN)]}


_CLK = "      c1 = clock();\n      ph[{0}] += c1 - c0;\n      c0 = c1;\n"
def _ph_store(out: str) -> str:
    """The phase variants' records over rows head0 + k at position p0 of the
    block's first item (``out`` with ``k`` in it): thread 64's clocks and
    nanoseconds from the block's start (k = 2), threads 32 and 0's phase
    sums (k = 1, 0)."""
    row = lambda k: out.replace("k", k)  # noqa: E731
    return f"""  __syncthreads();
  if (threadIdx.x == 64) {{  // the block's clocks and nanoseconds from its start
    const GroupItem first = group_item(blockIdx.x, gr, B, Hkv, n_rep, Sq);
    uint64_t ns_end;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_end));
    uint32_t* rec = reinterpret_cast<uint32_t*>({row("2")});
    rec[0] = (uint32_t)(clock64() - clk_start);
    rec[1] = (uint32_t)(ns_end - ns_start);
    rec[2] = (uint32_t)f;
    rec[6] = blockIdx.x;
    rec[7] = {TRACE_MARK}u;
  }}
  if (threadIdx.x == 0 || threadIdx.x == 32) {{
    const GroupItem first = group_item(blockIdx.x, gr, B, Hkv, n_rep, Sq);
    uint32_t* rec = reinterpret_cast<uint32_t*>({row("threadIdx.x / 32")});
    for (int i = 0; i < 5; ++i) rec[i] = (uint32_t)ph[i];
    rec[5] = (uint32_t)f;
    rec[6] = blockIdx.x;
    rec[7] = {TRACE_MARK}u;
  }}
"""


_PH_DECL = ("  unsigned long long ph[5] = {0, 0, 0, 0, 0};\n  unsigned int c0 = 0, c1 = 0;\n"
            "  const long long clk_start = clock64();\n  uint64_t ns_start;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(ns_start));\n")
#: the forward's phases in SM clocks, summed over a block's tiles by thread 0
#: (the loader) and thread 32: the data wait, S (issue to its wait; thread
#: 0's loads inside), the softmax and pack, P V (issue to its wait), the
#: block barrier
PHASES = ("full_wait", "s_product", "softmax_pack", "pv_product", "barrier")
DQ_PHASES = ("full_wait", "s_dp_products", "ds_pack", "dq_product", "barrier")
PHASE_EDITS = [
    (_FT0, _FT0 + _PH_DECL),
    ("      mbar_wait(full + st, (uint32_t)(f / ST) & 1u, stuck);\n      wgmma_fence();\n"
     "      wgmma_ss<BN>(s, q_desc, k_desc + off, 0);\n",
     "      c0 = clock();\n      mbar_wait(full + st, (uint32_t)(f / ST) & 1u, stuck);\n"
     + _CLK.format(0) + "      wgmma_fence();\n      wgmma_ss<BN>(s, q_desc, k_desc + off, 0);\n"),
    ("      wgmma_wait<0>();\n      fence_regs(s);\n      const int n0 = j * BN;\n",
     "      wgmma_wait<0>();\n      fence_regs(s);\n" + _CLK.format(1)
     + "      const int n0 = j * BN;\n"),
    ("      pack_a<BN>(pa, s);\n", "      pack_a<BN>(pa, s);\n" + _CLK.format(2)),
    ("      fence_regs(oacc);\n      fence_regs(pa);\n      bad = __syncthreads_or(*stuck) != 0;\n",
     "      fence_regs(oacc);\n      fence_regs(pa);\n" + _CLK.format(3)
     + "      bad = __syncthreads_or(*stuck) != 0;\n" + _CLK.format(4)),
    (_FTEND + _DRAIN, _FTEND + _ph_store(
        "o + first.b * o_sb + (first.head0 + k) * o_sh + (int64_t)first.p0 * o_ss") + _DRAIN)]
#: the forward's time outside its tile loop, in the same five records: the
#: block's start to its first item, each item's set-up (its rows, the Q
#: wait), each item's epilogue, the block's end (the drain)
OUTSIDE_PHASES = ("block_start", "item_setup", "item_epilogue", "unused", "unused")
_ITEM_TOP = ("    const GroupItem it = group_item(item, gr, B, Hkv, n_rep, Sq);\n"
             "    const int n_tiles = Sk > 0 ? group_tiles(it, gr, Sk, causal, BN) : 0;\n"
             "    bool out_row[2];\n")
_LOOP_TOP = ("    for (int j = 0; j < n_tiles && !bad; ++j, ++f) {\n      const int st = f % ST;\n"
             "      const uint64_t off = (uint64_t)(st * C::STAGE) >> 4;\n"
             "      mbar_wait(full + st, (uint32_t)(f / ST) & 1u, stuck);\n      wgmma_fence();\n"
             "      wgmma_ss<BN>(s, q_desc, k_desc + off, 0);\n")
_EPI_TOP = "#pragma unroll\n    for (int rh = 0; rh < 2; ++rh) {\n      float l = lrow[rh];\n"
OUTSIDE_EDITS = [
    (_FT0, _FT0 + _PH_DECL + "  c0 = clock();\n"),
    (_ITEM_TOP, "    c1 = clock();\n    ph[nth == 0 ? 0 : 2] += c1 - c0;\n    c0 = c1;\n" + _ITEM_TOP),
    (_LOOP_TOP, "    c1 = clock();\n    ph[1] += c1 - c0;\n    c0 = c1;\n" + _LOOP_TOP),
    ("      fence_regs(oacc);\n      fence_regs(pa);\n      bad = __syncthreads_or(*stuck) != 0;\n    }\n\n"
     + _EPI_TOP,
     "      fence_regs(oacc);\n      fence_regs(pa);\n      bad = __syncthreads_or(*stuck) != 0;\n    }\n"
     "    c0 = clock();\n\n" + _EPI_TOP),
    (_FTEND + _DRAIN, _FTEND + "  c1 = clock();\n  ph[2] += c1 - c0;\n" + _ph_store(
        "o + first.b * o_sb + (first.head0 + k) * o_sh + (int64_t)first.p0 * o_ss") + _DRAIN)]
#: dQ's phases likewise: the data wait, S and dP (thread 0's loads inside),
#: dS and its pack, dQ += dS K, the block barrier
DQ_PHASE_EDITS = [
    (_QT0, _QT0 + _PH_DECL),
    ("      mbar_wait(full + st, (uint32_t)(f / ST) & 1u, stuck);\n"
     "      // S = Q K^T and dP = dO V^T",
     "      c0 = clock();\n      mbar_wait(full + st, (uint32_t)(f / ST) & 1u, stuck);\n"
     + _CLK.format(0) + "      // S = Q K^T and dP = dO V^T"),
    ("      fence_regs(dp);\n      const int n0 = j * BN;\n",
     "      fence_regs(dp);\n" + _CLK.format(1) + "      const int n0 = j * BN;\n"),
    ("      pack_a<BN>(da, dp);\n      // dQ += dS K (the k dimension is the key)\n",
     "      pack_a<BN>(da, dp);\n" + _CLK.format(2)
     + "      // dQ += dS K (the k dimension is the key)\n"),
    ("      fence_regs(dqa);\n      fence_regs(da);\n      bad = __syncthreads_or(*stuck) != 0;\n",
     "      fence_regs(dqa);\n      fence_regs(da);\n" + _CLK.format(3)
     + "      bad = __syncthreads_or(*stuck) != 0;\n" + _CLK.format(4)),
    (_QTEND + _DRAIN, _QTEND + _ph_store(
        "dq + first.b * dqs.b + (first.head0 + k) * dqs.h + (int64_t)first.p0 * dqs.s") + _DRAIN)]


def _fold(frags: str, acc: str) -> str:
    """A product's lines replaced by a fold of its A fragments into one
    accumulator, so that no fragment is dropped as dead code."""
    return f"""    {{
      uint32_t fold = 0;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) fold ^= {frags}[kk][x];
      {acc}[0] += __uint_as_float(fold & 0x3f800000u);
    }}
"""


_L64 = """struct Lanes<64> {
  static constexpr int TK = 32;
  static constexpr int ST = 8;
  static constexpr int EARLY = ST;
  static constexpr int MAX_SPLIT = 8;
};"""
def _lanes64(tk: int = 32, st: int = 8, split: int = 8) -> list:
    """The hd-64 decode's tile, ring and split edited."""
    return [(_L64, _L64.replace("TK = 32", f"TK = {tk}").replace("ST = 8", f"ST = {st}")
             .replace("MAX_SPLIT = 8", f"MAX_SPLIT = {split}"))]


# The hd-64 serving forward is the template's three-warpgroup form
# (Fwd<64, false>, C::WG3): its variants edit that form alone, under
# C::WG3, except where they change a constant every form shares (FBN).
_W64_FBN = "constexpr int FBN = 128;           // keys per K/V tile\n"
_W64_WG = "  static constexpr int WG = WG3 ? 3 : 2;          // consumer warpgroups\n"
_W64_REGS = ("  static constexpr int REGS = WG3 ? 160 : 232;    // a consumer thread's, by setmaxnreg\n"
             "  static constexpr int PRODUCER_REGS = WG3 ? 32 : 40;\n")
_W64_ST = "  static constexpr int STAGES = HD == 128 ? 2 : 4;  // per ring (K, V)\n"
_W64_TURNS = "    if (wg == WG - 1) turn_arrive(1);\n"
_W64_PASS_EXP = "      if constexpr (C::SOFTMAX_TURNS) turn_arrive(1 + WG + (wg + 1) % WG);\n"
_W64_PACK = "      pack_a<FBN>(pa, s);\n"
_W64_EXP = "        s[i] = ex2_ftz(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));\n"
_W64_PV = "  mn_product<HD, FBN>(o, pa, v_base, Fwd<HD, LSE>::KV_CHUNK);\n"
_W64_LAST = ("    if (wg == 0) {  // the last group's last turns\n      turn_sync(1);\n"
             "      if (C::SOFTMAX_TURNS) turn_sync(1 + WG);\n    }\n")
_W64_MID = "        n0 = it * FBN;\n        take_exp();\n        softmax();\n        pass_exp();\n"
#: each place a warpgroup takes and passes its turn to issue products: tile
#: 0's S, a middle tile's S and P V, the last tile's P V
_W64_ISSUE = [
    ("        turn_sync(my_turn);\n        wgmma_fence();\n"
     "        qk_product<HD, LSE>(s, q_base, k_base + sk * C::KV_BYTES);\n"
     "        wgmma_commit();\n        turn_arrive(their_turn);\n        wgmma_wait<0>();\n"),
    ("        turn_sync(my_turn);\n        wgmma_fence();\n"
     "        qk_product<HD, LSE>(s, q_base, k_base + sk * C::KV_BYTES);\n"
     "        wgmma_commit();\n        pv_product<HD, LSE>(oacc, pa, v_base + sv * C::KV_BYTES);\n"
     "        wgmma_commit();\n        turn_arrive(their_turn);\n"),
    ("        turn_sync(my_turn);\n        wgmma_fence();\n"
     "        pv_product<HD, LSE>(oacc, pa, v_base + sv * C::KV_BYTES);\n"
     "        wgmma_commit();\n        turn_arrive(their_turn);\n")]
_LAP = "        lap({0});\n"
#: the hd-64 forward's phases in SM clocks, summed over a warpgroup's middle
#: tiles (S and the previous P V in flight together) by its first thread:
#: the K/V waits, the wait for its turn to issue, issuing its products, the
#: wait for S, the wait for its softmax turn, the softmax, the wait for P
#: V, O's rescale and P's pack (the assembler moves instructions across
#: these marks, so each reads where the warp was, roughly)
W64_PHASES = ("full_wait", "turn_wait", "issue", "s_wait", "exp_turn_wait", "softmax",
              "pv_wait", "pack")
W64_PHASE_EDITS = [
    (_W64_TURNS, _W64_TURNS + "    unsigned long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "    unsigned int c0 = clock(), c1 = 0, tiles_done = 0;\n"
     "    const long long clk_start = clock64();\n    uint64_t ns_start, ns_end;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(ns_start));\n"
     "    auto lap = [&](int i) { c1 = clock(); ph[i] += c1 - c0; c0 = c1; };\n"),
    ("        mbar_wait(full_k + sk, (kt / ST) & 1, stuck);\n"
     "        mbar_wait(full_v + sv, (vt / ST) & 1, stuck);\n        __syncwarp();\n"
     "        turn_sync(my_turn);\n",
     "        c0 = clock();\n        mbar_wait(full_k + sk, (kt / ST) & 1, stuck);\n"
     "        mbar_wait(full_v + sv, (vt / ST) & 1, stuck);\n        __syncwarp();\n"
     + _LAP.format(0) + "        turn_sync(my_turn);\n" + _LAP.format(1)),
    ("        pv_product<HD, LSE>(oacc, pa, v_base + sv * C::KV_BYTES);\n        wgmma_commit();\n"
     "        turn_arrive(their_turn);\n        wgmma_wait<1>();  // S_it is done\n"
     "        fence_regs(s);\n",
     "        pv_product<HD, LSE>(oacc, pa, v_base + sv * C::KV_BYTES);\n        wgmma_commit();\n"
     "        turn_arrive(their_turn);\n" + _LAP.format(2)
     + "        wgmma_wait<1>();  // S_it is done\n        fence_regs(s);\n" + _LAP.format(3)),
    (_W64_MID + "        wgmma_wait<0>();  // P_{it-1} V_{it-1} is done\n"
     "        fence_regs(oacc);\n        fence_regs(pa);\n"
     "        if (lane == 0) mbar_arrive(empty_v + sv);\n",
     "        n0 = it * FBN;\n        take_exp();\n" + _LAP.format(4) + "        softmax();\n"
     + _LAP.format(5) + "        pass_exp();\n"
     + "        wgmma_wait<0>();  // P_{it-1} V_{it-1} is done\n"
     "        fence_regs(oacc);\n        fence_regs(pa);\n" + _LAP.format(6)
     + "        if (lane == 0) mbar_arrive(empty_v + sv);\n"),
    ("        ++vt;\n        rescale_and_pack();\n      }\n",
     "        ++vt;\n        rescale_and_pack();\n" + _LAP.format(7)
     + "        ++tiles_done;\n      }\n"),
    (_W64_LAST, "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(ns_end));\n"
     "    if (C::WG3 && (threadIdx.x & 127) == 0) {\n      int fbh, fm0;\n"
     "      work_item(blockIdx.x, nm, bh_all, group, fbh, fm0, FBM);\n"
     "      uint32_t* rec = reinterpret_cast<uint32_t*>(o + fbh / H * o_sb + fbh % H * o_sh + "
     "(int64_t)(fm0 + wg) * o_ss);\n"
     "      for (int i = 0; i < 8; ++i) rec[i] = (uint32_t)ph[i];\n"
     "      rec[8] = tiles_done;\n      rec[9] = blockIdx.x;\n"
     "      rec[10] = (uint32_t)(clock64() - clk_start);\n"
     "      rec[11] = (uint32_t)(ns_end - ns_start);\n"
     f"      rec[12] = {0x600DF00D}u;\n    }}\n" + _W64_LAST)]


#: four consumer warpgroups (items of 256 rows) on 64-key tiles (every
#: form's tiles), 112 registers a consumer thread and 24 a producer thread
#: (a block's registers are what it launched with: 640 threads at 96)
W64_WG4 = [(_W64_WG, _W64_WG.replace("? 3 :", "? 4 :")),
           (_W64_FBN, _W64_FBN.replace("128", "64")),
           (_W64_REGS, _W64_REGS.replace("WG3 ? 160", "WG3 ? 112").replace("WG3 ? 32", "WG3 ? 24"))]
_W64_ALU = """      if constexpr (C::WG3) {
#pragma unroll
        for (int kk = 0; kk < FBN / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const uint32_t u0 = __float_as_uint(s[8 * kk + 2 * x]);
            const uint32_t u1 = __float_as_uint(s[8 * kk + 2 * x + 1]);
            pa[kk][x] = __byte_perm(u0 + 0x7fffu + ((u0 >> 16) & 1u),
                                    u1 + 0x7fffu + ((u1 >> 16) & 1u), 0x7632);
          }
      } else {
        pack_a<FBN>(pa, s);
      }
"""
_W64_TRUNC = """      if constexpr (C::WG3) {
#pragma unroll
        for (int kk = 0; kk < FBN / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[kk][x] = __byte_perm(__float_as_uint(s[8 * kk + 2 * x]),
                                    __float_as_uint(s[8 * kk + 2 * x + 1]), 0x7632);
      } else {
        pack_a<FBN>(pa, s);
      }
"""


_NOW_NS = "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"({0}));"
#: the lanes decode's per-block timeline over its group's q row (8 words a
#: block; at most 4 blocks a group at hd 64): the SM, the start (ns), and
#: from it warp 0's first tile, warp 0's last tile done, the block's end
#: (after the cluster barrier), its tiles, TRACE_MARK
DEC_TRACE_EDITS = [
    ("  extern __shared__ __align__(16) uint8_t lanes_smem_raw[];\n",
     "  extern __shared__ __align__(16) uint8_t lanes_smem_raw[];\n"
     "  uint64_t tr_t0, tr_data = 0, tr_loop = 0, tr_end;\n  int tr_tiles = 0;\n  "
     + _NOW_NS.format("tr_t0") + "\n"),
    ("      if (__any_sync(0xffffffffu, *stuck)) break;  // warp-uniform: shuffles follow\n",
     "      if (__any_sync(0xffffffffu, *stuck)) break;  // warp-uniform: shuffles follow\n"
     "      if (tr_data == 0) " + _NOW_NS.format("tr_data") + "\n      ++tr_tiles;\n"),
    ("    // the warp's key lanes of each column piece merge by shuffles\n",
     "    " + _NOW_NS.format("tr_loop") + "\n"
     "    // the warp's key lanes of each column piece merge by shuffles\n"),
    ("  cluster.sync();  // every partial is in block 0's shared memory\n",
     "  cluster.sync();  // every partial is in block 0's shared memory\n  "
     + _NOW_NS.format("tr_end") + "\n"
     "  if (threadIdx.x == 0) {\n    uint32_t smid;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    uint32_t* rec = reinterpret_cast<uint32_t*>(const_cast<bf16*>(p.q + b * p.q_sb + "
     "(int64_t)h0 * p.q_sh)) + 8 * split;\n"
     "    rec[0] = smid;\n    rec[1] = (uint32_t)tr_t0;\n    rec[2] = (uint32_t)(tr_t0 >> 32);\n"
     "    rec[3] = tr_data ? (uint32_t)(tr_data - tr_t0) : 0u;\n"
     "    rec[4] = tr_loop ? (uint32_t)(tr_loop - tr_t0) : 0u;\n"
     "    rec[5] = (uint32_t)(tr_end - tr_t0);\n    rec[6] = tr_tiles;\n"
     f"    rec[7] = {0x600DF00D}u;\n  }}\n")]


#: name -> (library, edits as (text, replacement), what it shows)
VARIANTS = {
    "dec64-split-1-deep": ("decode_attention", _lanes64(64, 12, 1),
                           "hd-64 decode: one block a head group, a ring of 12 stages"),
    "dec64-split-2-deep": ("decode_attention", _lanes64(64, 12, 2),
                           "hd-64 decode: up to 2 blocks a head group, a ring of 12 stages"),
    "dec64-trace": ("decode_attention", DEC_TRACE_EDITS,
                    "decode: each block's SM and timeline over its group's q; expected to fail "
                    "the checks"),
    "fwd64-no-softmax": ("flash_attention", [
        (_W64_MID, _W64_MID.replace("        softmax();\n", "        if (!C::WG3) softmax();\n"))],
        "hd-64 forward: the middle tiles' S packed as P, no max, exponential or sum; expected "
        "to fail the checks"),
    "fwd64-no-pv": ("flash_attention", [
        (_W64_PV, "  if constexpr (Fwd<HD, LSE>::WG3) {\n    uint32_t fold = 0;\n#pragma unroll\n"
         "    for (int kk = 0; kk < FBN / 16; ++kk)\n#pragma unroll\n"
         "      for (int x = 0; x < 4; ++x) fold ^= pa[kk][x];\n"
         "    o[0] += __uint_as_float(fold & 0x3f800000u);\n  } else {\n  " + _W64_PV + "  }\n")],
        "hd-64 forward: P packed but no P V product; expected to fail the checks"),
    "fwd64-wg4-bn64": ("flash_attention", W64_WG4,
                       "hd-64 forward: four consumer warpgroups (256-row items), 64-key tiles "
                       "(every head dim's forward)"),
    "fwd64-bn-64": ("flash_attention", [(_W64_FBN, _W64_FBN.replace("128", "64"))],
                    "hd-64 forward: 64-key tiles (every head dim's forward)"),
    "fwd64-trunc-pack": ("flash_attention", [(_W64_PACK, _W64_TRUNC)],
                         "hd-64 forward: P cut to bf16 by a byte permute, not rounded by cvt; "
                         "expected to fail the checks"),
    "fwd64-alu-pack": ("flash_attention", [(_W64_PACK, _W64_ALU)],
                       "hd-64 forward: P rounded to bf16 by integer arithmetic on the ALU (round "
                       "to nearest even: the same bits as cvt.rn for these probabilities)"),
    "fwd64-no-exp": ("flash_attention", [(_W64_EXP, _W64_EXP.replace(
        "ex2_ftz(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));",
        "C::WG3 ? (fmaf(s[i], scale_log2, -base[(i >> 1) & 1]) > -8.f ? 1.f : 0.f)\n"
        "                       : ex2_ftz(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));"))],
                     "hd-64 forward: P a 0 or 1 by a compare, no exponential; expected to fail "
                     "the checks"),
    "fwd64-pin": ("flash_attention", [
        (_W64_MID, _W64_MID.replace("pass_exp();", "if (C::WG3) fence_regs(s);\n        pass_exp();")),
        (_W64_PASS_EXP, _W64_PASS_EXP.replace("(wg + 1) % WG);",
                                              "(wg + 1) % WG + (lrow[0] + lrow[1] < 0.f));"))],
        "hd-64 forward: a softmax turn passed only after the whole softmax (the arrive's id "
        "reads the row sums, so the assembler cannot move it, or the wait for P V, up)"),
    "fwd64-no-exp-turns": ("flash_attention", [(
        "  static constexpr bool SOFTMAX_TURNS = WG3; ",
        "  static constexpr bool SOFTMAX_TURNS = false; ")],
        "hd-64 forward: the softmaxes without turns (all three at once)"),
    "fwd64-no-turns": ("flash_attention", [
        *[(x, x.replace("        turn_sync(my_turn);\n", "        if (!C::WG3) turn_sync(my_turn);\n")
           .replace("        turn_arrive(their_turn);\n",
                    "        if (!C::WG3) turn_arrive(their_turn);\n")) for x in _W64_ISSUE],
        (_W64_TURNS, "    if (!C::WG3 && wg == WG - 1) turn_arrive(1);\n"),
        (_W64_LAST, _W64_LAST.replace("      turn_sync(1);\n", "      if (!C::WG3) turn_sync(1);\n"))],
        "hd-64 forward: the three warpgroups issue their products without turns"),
    "fwd64-phases": ("flash_attention", W64_PHASE_EDITS,
                     "hd-64 forward: SM clocks a middle tile in each phase; expected to fail the "
                     "checks"),
    "dec64-tk-64": ("decode_attention", _lanes64(64, 4),
                    "hd-64 decode: 64-key tiles, 4 stages (the same 64 KB ring, one a warp)"),
    "dec64-st-8": ("decode_attention", _lanes64(64, 8),
                   "hd-64 decode: 8 stages of 64 keys (128 KB a block)"),
    "dec64-split-4": ("decode_attention", _lanes64(split=4),
                      "hd-64 decode: up to 4 blocks a head group"),
    "dec64-split-16": ("decode_attention", _lanes64(split=16),
                       "hd-64 decode: up to 16 blocks a head group (a non-portable cluster)"),
    "fwd64-st-5": ("flash_attention", [(_W64_ST, _W64_ST.replace("HD == 128 ? 2 : 4;",
                                                                  "HD == 128 ? 2 : WG3 ? 5 : 4;"))],
                   "hd-64 forward: rings of 5 stages"),
    "split-16": ("decode_attention", [(_SPLIT, _SPLIT.replace("= 8;", "= 16;"))],
                 "decode: up to 16 blocks a head group (a non-portable cluster)"),
    "split-4": ("decode_attention", [(_SPLIT, _SPLIT.replace("= 8;", "= 4;"))],
                "decode: up to 4 blocks a head group"),
    "tk-32": ("decode_attention", [(_TK, _TK.replace("64", "32"))],
              "decode: 32-key tiles"),
    "warps-8": ("decode_attention", [(_WARPS, _WARPS.replace("4", "8")), *_lanes64(64, 8)],
                "decode: 8 consumer warps (hd 64: 8 stages, one a warp)"),
    "merge-alone": ("decode_attention", [(_NTILES, "    return 0;"), (_EARLY, "")],
                    f"decode: no tiles, no early loads: launch, prologue and the merges; "
                    f"{OUTSIDE}"),
    "no-final-merge": ("decode_attention", [(_FINAL, "  return;\n")],
                       f"decode: the partials pushed to block 0, not merged; {OUTSIDE}"),
    "cl-2": ("flash_attention", [(_CL, _CL.replace("4", "2"))],
             "dK/dV: an item's tiles split two ways"),
    "cl-8": ("flash_attention", [(_CL, _CL.replace("4", "8"))],
             "dK/dV: an item's tiles split eight ways"),
    "minb-3": ("flash_attention", [(_MINB, _MINB.replace("4", "3"))],
               "dK/dV: three blocks an SM (up to 168 registers)"),
    "minb-2": ("flash_attention", [(_MINB, _MINB.replace("4", "2"))],
               "dK/dV: two blocks an SM"),
    "bq-128": ("flash_attention", [(_MINB, _MINB.replace("4", "2")), (_BQ, _BQ.replace("64", "128"))],
               "dK/dV: 128-query tiles, two blocks an SM"),
    "trunc-pack": ("flash_attention", [(_PACK, _PACK_TRUNC)],
                   f"dK/dV: P^T and dS^T cut to bf16 by a byte permute, not rounded by "
                   f"cvt; {OUTSIDE}"),
    "no-mask": ("flash_attention", [(_MASK, _MASK.replace("true", "false"))],
                f"dK/dV: no causal or edge mask; {OUTSIDE}"),
    "mask-always": ("flash_attention", [(_MASK_IF, "      if (true)\n")],
                    "dK/dV: every tile masked"),
    "no-exp-trunc-pack": ("flash_attention", [(_EXP, _EXP.replace("ex2_ftz(", "(")),
                                              (_PACK, _PACK_TRUNC)],
                          f"dK/dV: neither the exponential nor the rounding; {OUTSIDE}"),
    "no-dvdk": ("flash_attention", [(_DVDK, _DVDK_NONE)],
                f"dK/dV: P^T and dS^T packed but no dV, dK products; {OUTSIDE}"),
    "st-8": ("flash_attention", [(_DST, _DST.replace("4", "8"))],
             "dK/dV: 8 ring stages, not 4"),
    "no-exp": ("flash_attention", [(_EXP, _EXP.replace("ex2_ftz(", "("))],
               f"dK/dV: P without its exponential (an FMA); {OUTSIDE}"),
    "fwd-no-exp": ("flash_attention", [(_FEXP, _FEXP.replace("ex2_ftz(", "("))],
                   f"forward: P without its exponential (an FMA); {OUTSIDE}"),
    "fwd-no-pv": ("flash_attention", [(_FPV, _fold("pa", "oacc"))],
                  f"forward: P packed but no P V product; {OUTSIDE}"),
    "fwd-no-softmax": ("flash_attention", [(_FSOFT, "")],
                       f"forward: S packed as P, no max, exponential or sum; {OUTSIDE}"),
    "fwd-phases": ("flash_attention", PHASE_EDITS,
                   f"forward: SM clocks a tile in each phase, over its first rows; {OUTSIDE}"),
    "fwd-outside": ("flash_attention", OUTSIDE_EDITS,
                    f"forward: SM clocks outside the tile loop, over its first rows; {OUTSIDE}"),
    "dq-phases": ("flash_attention", DQ_PHASE_EDITS,
                  f"dQ: SM clocks a tile in each phase, over its first rows; {OUTSIDE}"),
    "fwd-bn-64": ("flash_attention", [(
        "  static constexpr int BN = 128;                      // keys a K/V tile\n",
        "  static constexpr int BN = 64;                       // keys a K/V tile\n")],
        "forward: 64-key tiles"),
    "dq-no-exp": ("flash_attention", [(_QEXP, _QEXP.replace("ex2_ftz(", "("))],
                  f"dQ: P without its exponential (an FMA); {OUTSIDE}"),
    "dq-no-dsk": ("flash_attention", [(_QDSK, _fold("da", "dqa"))],
                  f"dQ: dS packed but no dS K product; {OUTSIDE}"),
    "fwd-trace": ("flash_attention", TRACE_EDITS["fwd"],
                  f"forward: each block's SM, start and durations over its first row; {OUTSIDE}"),
    "dq-trace": ("flash_attention", TRACE_EDITS["dq"],
                 f"dQ: each block's SM, start and durations over its first row; {OUTSIDE}"),
}


def variant_sources(name: str) -> dict[str, str]:
    """The checkout's two sources with variant ``name``'s edits."""
    lib, edits, _ = VARIANTS[name]
    texts = {n: path.read_text() for n, path in SOURCES.items()}
    for old, new in edits:
        if texts[lib].count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {texts[lib].count(old)} times")
        texts[lib] = texts[lib].replace(old, new)
    return texts


def build(sources: dict[str, dict[str, str]]) -> dict:
    """Build every (source, library) in parallel; returns name -> {library:
    (CDLL, ptxas report)}."""
    import chip_smoke
    from repro_torch.kernels import _build

    procs, first = {}, {}  # a text built once, under the first source that has it
    for n, files in sources.items():
        out = OUT / n
        out.mkdir(parents=True, exist_ok=True)
        for lib, text in files.items():
            if (lib, text) in first:
                continue
            first[lib, text] = n
            cu = out / f"{lib}.cu"
            cu.write_text(text)
            procs[n, lib] = subprocess.Popen(
                [_build.nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o",
                 str(out / f"lib{lib}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for (n, lib), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{n}/{lib} failed to build:\n{log}")
        entry = (chip_smoke.DECODE_ENTRY if lib == "decode_attention" else
                 r"(" + "|".join(chip_smoke.FLASH_KERNELS) + r")ILi(\d+)E(Lb(\d)E)?")
        label = (chip_smoke.decode_label if lib == "decode_attention" else
                 lambda m: f"{m.group(1)}<{m.group(2)}{', lse' if m.group(4) == '1' else ''}>")
        built[n, lib] = (ctypes.CDLL(str(OUT / n / f"lib{lib}.so")),
                         chip_smoke.ptxas_report(log, entry, label))
    return {n: {lib: built[first[lib, text], lib] for lib, text in files.items()}
            for n, files in sources.items()}


def use(libs: dict) -> None:
    """Point the wrappers at one source's libraries."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops

    for lib, (cdll, _) in libs.items():
        _build._libs[lib] = cdll
    _build._bound.clear()
    ops._plans.clear()


def hold(torch, chip_smoke, timer, failed: list) -> dict:
    """The hd-16 checks of one source; failures appended to ``failed``."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_fwd_lse
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 7 + 16)
    worst = {"o_err": 0.0, "ulp_excess": 0.0, "lse_err": 0.0}

    def note(label, r):
        for key in worst:
            worst[key] = max(worst[key], r[key])
        if not (r["o_err"] <= r.get("o_lim", 0.0) and r["lse_err"] <= 1e-3
                and r["ulp_excess"] <= 1.0):
            failed.append(label)
    for label, (b, h, hkv, s, kv_len) in chip_smoke.contract_decode_cases(16, "bf16"):
        shape = (b, h, hkv, s, 16, kv_len)
        q, k, v = chip_smoke.decode_inputs(torch, g, shape)
        note(label, chip_smoke.decode_check(torch, q, k, v, kv_len,
                                            *decode_attention(q, k, v, kv_len), label,
                                            check=False))
        if label == "serve":
            for n, r in chip_smoke.decode_replay_check(
                    torch, decode_attention, q, k, v, DECODE_LENS, f"{label} replayed",
                    check=False).items():
                note(f"{label} replayed at {n}", r)
    for s, kv_len in ((8192, 8000), (16384, 16383)):  # more tiles a block than it issues early
        shape = (1, 8, 2, s, 16, kv_len)
        q, k, v = chip_smoke.decode_inputs(torch, g, shape)
        note(f"long {s}", chip_smoke.decode_check(torch, q, k, v, kv_len,
                                                  *decode_attention(q, k, v, kv_len),
                                                  f"long {s}", check=False))
    q, k, v = chip_smoke.decode_inputs(torch, g, (4, 8, 2, 2081, 16, 2079))
    kl = torch.full((1,), 2079, dtype=torch.int32, device="cuda")
    out = []
    timer.ms(lambda: out.append(decode_attention(q, k, v, kl)), 20)  # replays, flushed
    note("serve, timed", chip_smoke.decode_check(torch, q, k, v, 2079, *out[-1], "timed",
                                                 check=False))
    for nrep in (1, 2, 3, 4, 8, 16):       # every group at the tile's edges
        for kv_len in (0, 1, 63, 64, 65, 300):
            shape = (2, 2 * nrep, 2, 300, 16, kv_len)
            q, k, v = chip_smoke.decode_inputs(torch, g, shape)
            note(f"gqa{nrep} kv_len {kv_len}", chip_smoke.decode_check(
                torch, q, k, v, kv_len, *decode_attention(q, k, v, kv_len),
                f"gqa{nrep}", check=False))
    fwd_err, fwd_bits = 0.0, True
    for label, (b, h, hkv, sq, sk, causal) in (*chip_smoke.contract_flash_cases(16, "bf16"),
                                               *EDGES, *DKV_EXTRA):
        q, k, v, _ = chip_smoke.training_inputs(torch, (b, h, hkv, sq, sk, 16, causal))
        o = flash_attention(q, k, v, causal=causal)
        err = chip_smoke.row_scaled_errs(o, flash_attention_ref(q, k, v, causal=causal))[1]
        fwd_err = max(fwd_err, err)
        if not (err <= chip_smoke.TRAIN_ROW_REL and bool(torch.isfinite(o.float()).all())):
            failed.append(f"forward {label}: a row's error {err:.3g}")
        if not torch.equal(o, flash_attention(q, k, v, causal=causal)):
            failed.append(f"forward {label}: two calls gave different bits")
            fwd_bits = False
    bits = True
    cases = [(label, (b, h, hkv, sq, sk, 16, causal)) for label, (b, h, hkv, sq, sk, causal)
             in (*chip_smoke.contract_train_cases(16, "bf16"), *DKV_EXTRA, *EDGES)]
    errs = dict.fromkeys(("o", "dq", "dk", "dv"), 0.0)
    for label, shape in cases:
        q, k, v, do = chip_smoke.training_inputs(torch, shape)
        try:
            r = chip_smoke.training_case(torch, q, k, v, do, shape[-1], label)
            for key in errs:
                errs[key] = max(errs[key], r[key]["row_scaled_err"])
            o, lse = flash_attention_fwd_lse(q, k, v, shape[-1])
            o2, lse2 = flash_attention_fwd_lse(q, k, v, shape[-1])
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                raise AssertionError(f"{label}: two forward-with-LSE calls gave different bits")
        except AssertionError as e:
            failed.append(str(e)[:160])
            bits = False
    return dict(decode=worst, fwd_row_scaled_err=fwd_err, fwd_bits_same=fwd_bits,
                train_row_scaled_err=errs, train_checks_passed=bits)


def trace_report(torch, out, shape, name: str) -> dict:
    """The records a trace variant wrote over row 0 of each block's first
    item (``out`` the forward's o or dQ, hd 16, at ``shape`` (B, H, Hkv, Sq,
    Sk, hd, causal)), summarised: the launch's span, the blocks' start
    ramp, a least-squares fit of a block's nanoseconds to its key tiles,
    the first Q load's wait, each SM's blocks, tiles and mean concurrency
    (its blocks' summed time over its busy span), and the blocks that end
    last. The records are kept in chiprun_out/trace_<name>.npy."""
    import numpy as np

    b_all, h, hkv, sq = shape[:4]
    n_rep = h // hkv
    hpi = min(n_rep, 64)
    pos, chunks = 64 // hpi, -(-n_rep // hpi)
    npb, groups = -(-sq // pos), b_all * hkv * chunks
    raw = out.view(torch.int32).cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    recs = []
    for x in range(groups * npb):
        grp = x % groups
        b, kvh, chunk = grp // (hkv * chunks), grp // chunks % hkv, grp % chunks
        r = raw[b, kvh * n_rep + chunk * hpi, (npb - 1 - x // groups) * pos]
        if r[7] == TRACE_MARK and r[6] == x:
            recs.append(r[:7])
    rec = np.array(recs)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    np.save(out_dir / f"trace_{name}.npy", rec)
    start = rec[:, 1] + (rec[:, 2] << 32)
    start = start - start.min()
    dur, tiles, sm = rec[:, 4], rec[:, 5], rec[:, 0]
    end = start + dur
    fit = np.polyfit(tiles, dur, 1) if len(set(tiles.tolist())) > 1 else [0.0, float(dur.mean())]
    per_sm = []
    for s in np.unique(sm):
        m = sm == s
        busy = end[m].max() - start[m].min()
        per_sm.append((int(m.sum()), float(dur[m].sum() / busy), int(tiles[m].sum()),
                       float(end[m].max())))
    per_sm = np.array(per_sm)
    last = np.argsort(end)[-6:]
    return {"blocks": len(rec), "span_us": float(end.max() / 1e3),
            "start_us_p50_p90_max": [float(np.percentile(start, q) / 1e3) for q in (50, 90, 100)],
            "ns_per_tile_and_fixed": [float(fit[0]), float(fit[1])],
            "q_wait_us_mean_max": [float(rec[:, 3].mean() / 1e3), float(rec[:, 3].max() / 1e3)],
            "sms": len(per_sm), "blocks_per_sm_min_max": [int(per_sm[:, 0].min()),
                                                          int(per_sm[:, 0].max())],
            "tiles_per_sm_min_max": [int(per_sm[:, 2].min()), int(per_sm[:, 2].max())],
            "sm_end_us_min_max": [float(per_sm[:, 3].min() / 1e3), float(per_sm[:, 3].max() / 1e3)],
            "us_per_tile_per_sm_median": float(np.median(per_sm[:, 3] / per_sm[:, 2]) / 1e3),
            "concurrency_mean_min_max": [float(per_sm[:, 1].mean()), float(per_sm[:, 1].min()),
                                         float(per_sm[:, 1].max())],
            "last_blocks_tiles_start_end_us": [[int(tiles[i]), float(start[i] / 1e3),
                                                float(end[i] / 1e3)] for i in last]}


#: A microbenchmark of the softmax's per-element work on the card's units,
#: 8 independent elements a thread an iteration: mode 0 one ex2.approx
#: (MUFU) an element; 1 the softmax's other work an element (a max, an FMA,
#: a sum, half a bf16 pack), no ex2; 2 both, as the forward does.
RATES_SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
template <int MODE>
__global__ void rates_kernel(float* out, int iters) {
  float x[8], m = -1.f, l = 0.f;
  uint32_t acc = 0;
  for (int i = 0; i < 8; ++i) x[i] = -1e-3f * (threadIdx.x + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (MODE == 0) {
        x[i] = ex2(-x[i]);
      } else {
        m = fmaxf(m, x[i]);
        const float y = fmaf(x[i], 0.25f, -m);
        x[i] = MODE == 2 ? ex2(y) : y * 0.5f;
        l += x[i];
      }
    }
    if (MODE != 0) {
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        __nv_bfloat162 h = __floats2bfloat162_rn(x[i], x[i + 1]);
        acc ^= *reinterpret_cast<uint32_t*>(&h);
      }
    }
  }
  float s = l + __uint_as_float(acc & 0x3f800000u);
  for (int i = 0; i < 8; ++i) s += x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int rates_run(int mode, int blocks, int threads, int iters, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) rates_kernel<0><<<blocks, threads, 0, s>>>(out, iters);
  else if (mode == 1) rates_kernel<1><<<blocks, threads, 0, s>>>(out, iters);
  else rates_kernel<2><<<blocks, threads, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def rates(torch) -> dict:
    """Run RATES_SOURCE's three modes at 4 and 8 warps a scheduler (16 and
    32 warps an SM); elements a nanosecond an SM, to hold against MUFU's 16
    a clock an SM (31.7 an ns at 1980 MHz)."""
    import ctypes

    from repro_torch.kernels import _build

    out_dir = OUT / "rates"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "rates.cu").write_text(RATES_SOURCE)
    subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(out_dir / "librates.so"),
                    str(out_dir / "rates.cu")], check=True)
    lib = ctypes.CDLL(str(out_dir / "librates.so"))
    lib.rates_run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = _build.stream_ptr(torch.device("cuda"))
    result = {}
    for warps in (16, 32):
        blocks, threads, iters = sms * warps // 4, 128, 4096
        buf = torch.empty(blocks * threads, device="cuda")
        for mode, name in enumerate(("ex2", "softmax_without_ex2", "softmax_with_ex2")):
            run = lambda: lib.rates_run(mode, blocks, threads, iters, buf.data_ptr(), stream)  # noqa: E731
            run()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            torch.cuda.synchronize()
            ns = start.elapsed_time(end) / 5 * 1e6
            result[f"{name}, {warps} warps an SM"] = round(
                blocks * threads * iters * 8 / ns / sms, 2)
    return result


def phases_report(torch, out, shape, phases) -> dict:
    """The fwd-phases variant's records (thread 32's over row 0 of each
    block's first item, thread 0's over row 1): SM clocks a tile in each of
    PHASES, the mean over the blocks."""
    import numpy as np

    b_all, h, hkv, sq = shape[:4]
    n_rep = h // hkv
    hpi = min(n_rep, 64)
    pos, chunks = 64 // hpi, -(-n_rep // hpi)
    npb, groups = -(-sq // pos), b_all * hkv * chunks
    raw = out.view(torch.int32).cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    got = {0: [], 1: []}
    clocks = []
    for x in range(groups * npb):
        grp = x % groups
        b, kvh, chunk = grp // (hkv * chunks), grp // chunks % hkv, grp % chunks
        for row in (0, 1):
            r = raw[b, kvh * n_rep + chunk * hpi + row, (npb - 1 - x // groups) * pos]
            if r[7] == TRACE_MARK and r[6] == x and r[5] > 0:
                got[row].append(r[:5] / r[5])
        r = raw[b, kvh * n_rep + chunk * hpi + 2, (npb - 1 - x // groups) * pos]
        if r[7] == TRACE_MARK and r[6] == x and r[1] > 0:
            clocks.append((r[0], r[1], r[2]))
    out = {who: dict(zip(phases, np.mean(got[row], 0).round(1).tolist()))
           for who, row in (("thread 32", 0), ("thread 0 (loads)", 1)) if got[row]}
    if clocks:
        c = np.array(clocks, dtype=np.float64)
        out["block"] = {"clocks_a_tile": round(float((c[:, 0] / c[:, 2]).mean()), 1),
                        "sm_mhz": round(float((c[:, 0] / c[:, 1]).mean() * 1e3), 1),
                        "us": round(float(c[:, 1].mean() / 1e3), 2)}
    return out


def main() -> int:
    import faulthandler

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import _build, cost
    from repro_torch.kernels.decode_attention.ops import decode_attention, plan
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd_lse)
    from repro_torch.kernels.flash_attention.ref import attention_delta, flash_attention_fwd_lse_ref

    argv, sources, quick, variants, hd, hold64 = sys.argv[1:], {}, False, [], 16, False
    if argv == ["--rates"]:
        print(f"elements a ns an SM: {json.dumps(rates(torch))}; card "
              f"{chip_smoke.nvidia_smi('name,power.limit')}", flush=True)
        return 0
    while argv:
        a = argv.pop(0)
        if a == "--source":
            n, d = argv.pop(0).split("=", 1)
            sources[n] = {lib: (Path(d) / f"{lib}.cu").read_text() for lib in SOURCES}
        elif a == "--quick":
            quick = True
        elif a == "--hd":
            hd = int(argv.pop(0))
        elif a == "--hold-hd64":
            hold64 = True
        elif a in VARIANTS:
            variants.append(a)
        else:
            raise SystemExit(f"unknown argument {a}")
    # print where a hung run sits, before an outer time limit kills it
    faulthandler.dump_traceback_later((420 if quick else 1200) + 60 * len(variants), exit=True)
    sources["new"] = {n: path.read_text() for n, path in SOURCES.items()}
    sources |= {n: variant_sources(n) for n in variants}
    libs = build(sources)
    names = list(sources)
    for n in names:
        for lib, (_, report) in libs[n].items():
            print(f"{n} {lib} ptxas: {json.dumps(report)}", flush=True)
    probe = chip_smoke.probe_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = chip_smoke.Timer(torch)
    stream = lambda: _build.stream_ptr(torch.device("cuda"))  # noqa: E731
    if hd == 64:
        return main64(torch, chip_smoke, names, libs, timer, probe, quick, hold64)
    if hd != 16:
        raise SystemExit(f"--hd {hd}: 16 or 64")

    held = {}
    for n in names:
        use(libs[n])
        failed: list = []
        held[n] = hold(torch, chip_smoke, timer, failed) | {"failed": failed}
        print(f"{n} held: {len(failed)} checks failed {failed[:2]}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    dshape = (4, 8, 2, 2081, 16, 2079)
    caches = [chip_smoke.decode_inputs(torch, g, dshape)
              for _ in range(chip_smoke.GRAPH_LAUNCHES)]
    kv_len = dshape[-1]
    kl = torch.full((1,), kv_len, dtype=torch.int32, device="cuda")
    q, k, v = caches[0]
    tshape = (4, 8, 2, 2048, 2048, 16, True)
    tq, tk, tv, tdo = chip_smoke.training_inputs(torch, tshape)
    to, tlse = flash_attention_fwd_lse_ref(tq, tk, tv, True)
    tdd = attention_delta(to, tdo)
    del to
    n_graph = chip_smoke.GRAPH_LAUNCHES

    def in_graph(call):
        return timer.ms(lambda: [call(c) for c in caches], 20, clean_l2=True) / n_graph

    others = []
    if not quick:
        for shape in OTHER_DECODE:
            others.append(("decode", shape, chip_smoke.decode_inputs(torch, g, shape)))
        for shape in OTHER_DKV:
            x = chip_smoke.training_inputs(torch, shape)
            o, lse = flash_attention_fwd_lse_ref(*x[:3], shape[-1])
            for kind in OTHER_FLASH:
                others.append((kind, shape, (*x, lse, attention_delta(o, x[3]))))
            del o

    def run_other(kind, shape, args):
        if kind == "decode":
            kln = torch.full((1,), shape[-1], dtype=torch.int32, device="cuda")
            return lambda: decode_attention(*args, kln)
        q_, k_, v_, do_, lse_, dd_ = args
        causal = shape[-1]
        return {"fwd": lambda: flash_attention(q_, k_, v_, causal=causal),
                "fwd_lse": lambda: flash_attention_fwd_lse(q_, k_, v_, causal),
                "dkv": lambda: flash_attention_bwd_dkv(q_, k_, v_, do_, lse_, dd_, causal),
                "dq": lambda: flash_attention_bwd_dq(q_, k_, v_, do_, lse_, dd_, causal)}[kind]

    first_out = {}
    turns = names + ([] if quick else names[::-1])
    times: dict = {n: {} for n in names}
    b_dec = cost.decode_attention(4, 8, 2, 16, kv_len)
    bounds = {"decode": dict(zip(("bound_ms", "bound_by"), b_dec.bound_ms()),
                             exp_bound_ms=cost.exponentials(
                                 "decode_attention", 4, 8, 2, 16, kv_len).bound_ms()[0])}
    for key, name in (("fwd", "flash_attention"), ("fwd_lse", "flash_attention_fwd_lse"),
                      ("dkv", "flash_attention_bwd_dkv"), ("dq", "flash_attention_bwd_dq")):
        bounds[key] = dict(zip(("bound_ms", "bound_by"),
                               getattr(cost, name)(*tshape[:-1], True).bound_ms()),
                           exp_bound_ms=cost.exponentials(name, *tshape).bound_ms()[0])
    kc, vc = k[:, :, :kv_len], v[:, :, :kv_len]
    lib_c = [(cq[:, :, None], ck[:, :, :kv_len], cv[:, :, :kv_len]) for cq, ck, cv in caches]
    yard = dict(sdpa_ms=timer.ms(lambda: chip_smoke.sdpa(F, q[:, :, None], kc, vc, False), 50),
                sdpa_graph_ms=timer.ms(lambda: [chip_smoke.sdpa(F, *c, False) for c in lib_c],
                                       20, clean_l2=True) / n_graph)
    lse_call, yard["lse_call"] = chip_smoke.sdpa_lse(torch, tq, tk, tv, True)
    yard["sdpa_fwd_ms"] = timer.ms(lambda: chip_smoke.sdpa(F, tq, tk, tv, True), 20)
    yard["lse_call_ms"] = timer.ms(lse_call, 20)
    yard["lse_call_lse_err"] = (lse_call()[1] - tlse).abs().max().item()
    print(f"SDPA decode {yard['sdpa_ms']:.5f} ms, in a graph {yard['sdpa_graph_ms']:.5f} ms a "
          f"launch; SDPA forward {yard['sdpa_fwd_ms']:.5f} ms, {yard['lse_call']} (O and "
          f"the LSE, K/V expanded) {yard['lse_call_ms']:.5f} ms, its LSE within "
          f"{yard['lse_call_lse_err']:.3g} of the plain one", flush=True)
    def empty(_=None):
        _build.check("decode_attention", probe.empty_launch(
            pl["n_split"] * pl["groups"], 160, stream()))
    readings = (("fwd_ms", lambda: timer.ms(lambda: flash_attention(tq, tk, tv, causal=True),
                                             20)),
                ("fwd_lse_ms", lambda: timer.ms(lambda: flash_attention_fwd_lse(
                    tq, tk, tv, True), 20)),
                ("dq_ms", lambda: timer.ms(lambda: flash_attention_bwd_dq(
                    tq, tk, tv, tdo, tlse, tdd, True), 20)),
                ("dkv_ms", lambda: timer.ms(lambda: flash_attention_bwd_dkv(
                    tq, tk, tv, tdo, tlse, tdd, True), 20)),
                ("decode_graph_ms", lambda: in_graph(lambda c: decode_attention(*c, kl))),
                ("decode_ms", lambda: timer.ms(lambda: decode_attention(q, k, v, kl), 50)),
                ("empty_ms", lambda: timer.ms(empty, 50)),
                ("empty_graph_ms", lambda: in_graph(empty)))
    for key, read in readings:   # a reading of every turn before the next reading
        for turn, n in enumerate(turns):
            if key.startswith("empty") and turn >= len(names):
                continue
            use(libs[n])
            pl = plan(4, 8, 2, 16)
            r = times[n].setdefault("turns", [{} for _ in turns])[turn]
            r["plan"] = pl
            r[key] = read()
            print(f"  {n} turn {turn} {key} {r[key]:.5f}", flush=True)
    for turn, n in enumerate(turns):
        use(libs[n])
        r = times[n]["turns"][turn]
        for kind, shape, args in others:
            fn = run_other(kind, shape, args)
            out = fn()
            torch.cuda.synchronize()
            key = f"{kind}{list(shape)}"
            if key in first_out:
                got = out if isinstance(out, tuple) else (out,)
                want = first_out[key]
                r[f"{key}_bits_as_{names[0]}"] = all(bool(torch.equal(a, b))
                                                     for a, b in zip(got, want))
            else:
                first_out[key] = out if isinstance(out, tuple) else (out,)
            r[f"{key}_ms"] = timer.ms(fn, 20)
        print(f"turn {turn} {n}: " + json.dumps({k: v for k, v in r.items() if k != "plan"}),
              flush=True)
    traces = {}
    for n in ("fwd-trace", "dq-trace"):
        if n not in names:
            continue
        use(libs[n])
        call = ((lambda: flash_attention(tq, tk, tv, causal=True)) if n == "fwd-trace" else
                (lambda: flash_attention_bwd_dq(tq, tk, tv, tdo, tlse, tdd, True)))
        call()
        timer.flush.zero_()
        out = call()
        torch.cuda.synchronize()
        traces[n] = trace_report(torch, out, tshape, n)
        print(f"{n}: {json.dumps(traces[n])}", flush=True)
    for n in ("fwd-phases", "dq-phases", "fwd-outside"):
        if n not in names:
            continue
        use(libs[n])
        call = ((lambda: flash_attention_bwd_dq(tq, tk, tv, tdo, tlse, tdd, True))
                if n == "dq-phases" else (lambda: flash_attention(tq, tk, tv, causal=True)))
        call()
        timer.flush.zero_()
        out = call()
        torch.cuda.synchronize()
        traces[n] = phases_report(torch, out, tshape, {"fwd-phases": PHASES, "dq-phases": DQ_PHASES,
                                                       "fwd-outside": OUTSIDE_PHASES}[n])
        print(f"{n} (SM clocks a tile): {json.dumps(traces[n])}", flush=True)
    summary = {"card": chip_smoke.nvidia_smi("name,power.limit"), "traces": traces,
               "bounds": bounds, **yard, "held": held, "times": times}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_compare.json").write_text(json.dumps(summary, indent=1))
    print(f"card {summary['card']}; bounds {json.dumps(bounds)}; the whole summary in "
          f"chiprun_out/kernel_compare.json")
    return 0 if all(not h["failed"] for n, h in held.items()
                    if not VARIANTS.get(n, ("", "", ""))[2].endswith(OUTSIDE)) else 1


def other_readings(torch, chip_smoke, timer, others, first_out: dict, first: str) -> dict:
    """Each of ``others`` ((kind, shape, args) at the head dims a design leaves
    alone) called, its outputs held against the first source's bits (kept
    in ``first_out`` at that source's first turn) and timed."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd_lse)

    r = {}
    for kind, shape, args in others:
        if kind == "decode":
            kln = torch.full((1,), shape[-1], dtype=torch.int32, device="cuda")
            fn = (lambda a=args, k=kln: decode_attention(*a, k))
        else:
            q_, k_, v_, do_, lse_, dd_ = args
            causal = shape[-1]
            fn = {"fwd": lambda: flash_attention(q_, k_, v_, causal=causal),
                  "fwd_lse": lambda: flash_attention_fwd_lse(q_, k_, v_, causal),
                  "dkv": lambda: flash_attention_bwd_dkv(q_, k_, v_, do_, lse_, dd_, causal),
                  "dq": lambda: flash_attention_bwd_dq(q_, k_, v_, do_, lse_, dd_, causal)}[kind]
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        key = f"{kind}{list(shape)}"
        if key in first_out:
            r[f"{key}_bits_as_{first}"] = all(bool(torch.equal(a, b))
                                              for a, b in zip(out, first_out[key]))
        else:
            first_out[key] = out
        r[f"{key}_ms"] = timer.ms(fn, 20)
    return r


def fwd64_phases(torch, o, shape) -> dict:
    """The fwd64-phases variant's records (each warpgroup's first thread
    over row m0 + wg of its block's first item; the kernel's work_item and
    head_group at items of 192 rows): SM clocks a middle tile in each of
    W64_PHASES, summed over the blocks and warpgroups and divided by their
    tiles, and the blocks' clocks and nanoseconds (the SM clock)."""
    import numpy as np

    b_all, h, hkv, sq, sk, hd = shape[:6]
    bm, n_wg = 192, 3
    nm, bh_all = -(-sq // bm), b_all * h
    per_head = 4.0 * max(sk, 1) * hd / (h // hkv)
    group = max(1, min(bh_all, int(40.0 * (1 << 20) / per_head)))
    grid = min(bh_all * nm, torch.cuda.get_device_properties(0).multi_processor_count)
    recs = []
    for x in range(grid):
        span, g0 = group * nm, x // (group * nm) * group
        in_group, idx = min(group, bh_all - g0), x % span
        bh, m0 = g0 + idx % in_group, (nm - 1 - idx // in_group) * bm
        for wg in range(n_wg):
            if m0 + wg < sq:
                raw = o[bh // h, bh % h, m0 + wg, :26].contiguous().view(torch.int32)
                r = raw.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
                if r[12] == TRACE_MARK and r[9] == x:
                    recs.append(r)
    rec = np.array(recs)
    tiles = rec[:, 8].sum()
    out = {"records": len(rec), "clocks_a_middle_tile": dict(zip(
        W64_PHASES, (rec[:, :8].sum(0) / max(tiles, 1)).round(1).tolist()))}
    out["sm_mhz"] = round(float((rec[:, 10] / rec[:, 11]).mean() * 1e3), 1)
    out["block_us_mean_max"] = [round(float(rec[:, 11].mean() / 1e3), 2),
                                round(float(rec[:, 11].max() / 1e3), 2)]
    return out


def gives_up(torch, chip_smoke, g) -> bool:
    """Whether a launch of the forward or decode at the seamless shapes
    takes over 50 ms (a pipeline fault: each wait that gives up takes ~2 s
    before the watchdog lets the block go)."""
    import time

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention

    calls = []
    for _, (b, h, hkv, sq, sk, hd, causal) in chip_smoke.SEAMLESS_FLASH_CASES[:1]:
        qkv = [torch.randn((b, s, m, hd), generator=g, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for s, m in ((sq, h), (sk, hkv), (sk, hkv))]
        calls.append(lambda qkv=qkv, c=causal: flash_attention(*qkv, causal=c))
    for _, shape in chip_smoke.SEAMLESS_DECODE_CASES[:1]:
        q, k, v = chip_smoke.decode_inputs(torch, g, shape)
        calls.append(lambda q=q, k=k, v=v, n=shape[-1]: decode_attention(q, k, v, n))
    for call in calls:
        call()                                   # builds, warms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 > 0.05:
            return True
    return False


def dec_trace_report(torch, chip_smoke, g) -> dict:
    """The dec64-trace variant at each SEAMLESS_DECODE_CASES shape, one
    launch after the L2 is flushed by a read: the launch's span, the
    blocks' starts, warp 0's wait for its first tile, its tile loop, the
    merge (the loop's end to the block's end), the blocks an SM; in us."""
    import numpy as np

    from repro_torch.kernels.decode_attention.ops import decode_attention, plan

    out = {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for label, shape in chip_smoke.SEAMLESS_DECODE_CASES:
        b, h, hkv, s, hd, kv_len = shape
        q, k, v = chip_smoke.decode_inputs(torch, g, shape)
        decode_attention(q.clone(), k, v, kv_len)
        flush.max()
        torch.cuda.synchronize()
        decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        n_split = plan(b, h, hkv, hd)["n_split"]
        raw = q.view(torch.int32).cpu().numpy().astype(np.int64) & 0xFFFFFFFF
        rec = raw.reshape(b * h, -1)[:, :8 * n_split].reshape(-1, 8)
        rec = rec[rec[:, 7] == TRACE_MARK]
        start = rec[:, 1] + (rec[:, 2] << 32)
        start = (start - start.min()) / 1e3
        end = start + rec[:, 5] / 1e3
        data = np.where(rec[:, 3] > 0, rec[:, 3] / 1e3, np.nan)
        loop = np.where(rec[:, 4] > 0, rec[:, 4] / 1e3, np.nan)
        _, per_sm = np.unique(rec[:, 0], return_counts=True)
        pct = lambda x: [round(float(np.nanpercentile(x, q_)), 2) for q_ in (50, 90, 100)]  # noqa: E731
        out[label] = {"blocks": len(rec), "n_split": n_split,
                      "span_us": round(float(end.max()), 2),
                      "start_us_p50_p90_max": pct(start),
                      "first_tile_us_p50_p90_max": pct(data),
                      "loop_end_us_p50_p90_max": pct(loop),
                      "merge_us_p50_p90_max": pct(rec[:, 5] / 1e3 - loop),
                      "end_us_p50_p90_max": pct(end),
                      "tiles_min_max": [int(rec[:, 6].min()), int(rec[:, 6].max())],
                      "sms": len(per_sm), "blocks_per_sm_min_max": [int(per_sm.min()),
                                                                   int(per_sm.max())]}
    return out


def time_unchecked(torch, chip_smoke, timer, probe, g) -> dict:
    """A source that failed a check (a variant that leaves work out) timed
    without the checks: the forward at SEAMLESS_FLASH_CASES, decode as one
    step's launches in a graph."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    import time

    out = {}
    for label, (b, h, hkv, sq, sk, hd, causal) in chip_smoke.SEAMLESS_FLASH_CASES:
        qkv = [torch.randn((b, s, m, hd), generator=g, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for s, m in ((sq, h), (sk, hkv), (sk, hkv))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flash_attention(*qkv, causal=causal)
        torch.cuda.synchronize()
        if time.perf_counter() - t0 > 0.05:     # a wait gave up (~2 s each): not timed
            out[label] = "a wait gave up"
            continue
        out[label] = round(timer.ms(lambda: flash_attention(*qkv, causal=causal), 20), 5)
    out["decode step graph"] = round(
        chip_smoke.seamless_step_graph(torch, timer, probe)["graph_ms"], 5)
    return out


def main64(torch, chip_smoke, names, libs, timer, probe, quick: bool,
           hold64: bool = False) -> int:
    """``--hd 64``: every source in turns (the order given and back, old,
    new, new, old; ``--quick`` once each), each turn
    ``chip_smoke.check_hd64`` (the hd-64 forward and decode held at
    SeamlessM4T's shapes and their edges, two calls the same bits, the
    replays across the 64-key tiles' edges; each seamless shape timed
    beside its bounds, the plain version and SDPA; a step's 24 decode
    launches in one graph) and, unless ``--quick``, the kernels the hd-64
    designs leave alone (OTHER_DECODE_64, OTHER_DKV_64) held against the
    first source's bits and timed; with ``--hold-hd64`` (a rewrite that
    should keep them) the hd-64 forward and decode at SeamlessM4T's shapes
    too. A failed check is recorded with the turn; the exit code is 1 if a
    source that is not a variant expected to fail failed one, or if a
    source that is not a variant gives the held kernels other bits."""
    from repro_torch.kernels.flash_attention.ref import attention_delta, flash_attention_fwd_lse_ref

    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    others = []
    if not quick:
        for shape in OTHER_DECODE_64:
            others.append(("decode", shape, chip_smoke.decode_inputs(torch, g, shape)))
        for shape, kinds in OTHER_DKV_64:
            x = chip_smoke.training_inputs(torch, shape)
            o, lse = flash_attention_fwd_lse_ref(*x[:3], shape[-1])
            for kind in kinds:
                others.append((kind, shape, (*x, lse, attention_delta(o, x[3]))))
            del o
    if hold64:
        for _, shape in chip_smoke.SEAMLESS_DECODE_CASES:
            others.append(("decode", shape, chip_smoke.decode_inputs(torch, g, shape)))
        for _, shape in chip_smoke.SEAMLESS_FLASH_CASES:
            others.append(("fwd", shape, (*chip_smoke.training_inputs(torch, shape), None, None)))
    turns = names + ([] if quick else names[::-1])
    first_out: dict = {}
    runs = []
    for turn, n in enumerate(turns):
        use(libs[n])
        r = {"source": n, "turn": turn}
        if gives_up(torch, chip_smoke, g):
            r["failed"] = "a wait gave up (a launch over 50 ms): not held or timed"
            r["others"] = {}
            runs.append(r)
            print(f"turn {turn} {n}: {r['failed']}", flush=True)
            continue
        try:
            r["hd64"] = chip_smoke.check_hd64(torch, timer, probe)
        except AssertionError as e:
            r["failed"] = str(e)[:300]
            r["unchecked_ms"] = time_unchecked(torch, chip_smoke, timer, probe, g)
        r["others"] = other_readings(torch, chip_smoke, timer, others, first_out, names[0])
        runs.append(r)
        brief = {}
        for key, entry in r.get("hd64", {}).items():
            for label, s in entry["shapes"].items():
                brief[f"{key} {label}"] = [round(s["ms"], 5), round(s["library_ms"], 5)]
            if "step_graph" in entry:
                brief[f"{key} step graph"] = [round(entry["step_graph"]["graph_ms"], 5),
                                              round(entry["step_graph"]["library_graph_ms"], 5)]
        print(f"turn {turn} {n}: (ms, SDPA ms) {json.dumps(brief)}; failed "
              f"{r.get('failed')}; unchecked {json.dumps(r.get('unchecked_ms'))}; others "
              f"{json.dumps(r['others'])}", flush=True)
    phases = {}
    if "fwd64-phases" in names:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        use(libs["fwd64-phases"])
        for label, shape in chip_smoke.SEAMLESS_FLASH_CASES:
            b, h, hkv, sq, sk, hd, causal = shape
            qkv = [torch.randn((b, s, m, hd), generator=g, device="cuda").to(torch.bfloat16)
                   .transpose(1, 2) for s, m in ((sq, h), (sk, hkv), (sk, hkv))]
            flash_attention(*qkv, causal=causal)
            timer.flush.zero_()
            o = flash_attention(*qkv, causal=causal)
            torch.cuda.synchronize()
            phases[f"fwd64-phases {label}"] = fwd64_phases(torch, o, shape)
            print(f"fwd64-phases {label}: {json.dumps(phases[f'fwd64-phases {label}'])}",
                  flush=True)
    if "dec64-trace" in names:
        use(libs["dec64-trace"])
        phases["dec64-trace"] = dec_trace_report(torch, chip_smoke, g)
        print(f"dec64-trace: {json.dumps(phases['dec64-trace'])}", flush=True)
    summary = {"card": chip_smoke.nvidia_smi("name,power.limit"),
               "ptxas": {n: {lib: rep for lib, (_, rep) in libs[n].items()} for n in names},
               "runs": runs, "phases": phases}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_compare_hd64.json").write_text(json.dumps(summary, indent=1))
    print(f"card {summary['card']}; the whole summary in chiprun_out/kernel_compare_hd64.json")
    expected = {n for n in names if VARIANTS.get(n, ("", "", ""))[2].endswith(OUTSIDE)}
    bad = [r["source"] for r in runs if r.get("failed") and r["source"] not in expected]
    # a variant may edit what every head dim's forward shares (FBN): its
    # others' bits are printed, not held
    bits = [k for r in runs if r["source"] not in VARIANTS
            for k, v in r["others"].items() if "_bits_as_" in k and not v]
    if bad or bits:
        print(f"FAILED: checks in {bad}; bits differ at {bits}")
    return 0 if not bad and not bits else 1


if __name__ == "__main__":
    sys.exit(main())
