"""The work of each kernel of the port: the bytes a call must move and the
operations it does, from the call's shapes.

One definition serves two readers: ``chip_smoke.py``'s bounds (the least
time the card could take for a call, :meth:`Work.bound_ms`) and the
dry-run op counter of ``repro_torch.validation.opcount``, which adds the
work of every kernel launched while a count is active (:func:`counting`):
the kernels are ``ctypes`` calls that no PyTorch dispatch mode sees.

Bytes count each input read once and each output written once, in the
dtypes the kernel reads and writes; operations count what the kernel
executes, at the peak rate of the units it runs them on (H100 SXM data
sheet, dense, at its 700 W limit). ``f32=True`` is a float32 launch: its
tensors 4 bytes a value, and the attention kernels' products at float32
accuracy on the TF32 tensor cores, three TF32 products a float32 one
(F32_SPLIT_FLOP_PER_S: the split of flash_attention_f32.cu), not the bf16
tensor cores; :func:`f32_cores` reads the same work at the CUDA cores' rate,
a second bound.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12        # tensor cores
F32_FLOP_PER_S = 67e12          # CUDA cores
TF32_FLOP_PER_S = 495e12        # tensor cores, TF32
#: float32 products at float32 accuracy on the tensor cores: each a = hi +
#: lo in TF32, a b = hi hi + hi lo + lo hi, three TF32 products
F32_SPLIT_FLOP_PER_S = TF32_FLOP_PER_S / 3
F64_FLOP_PER_S = 34e12          # CUDA cores (FP64, outside the tensor cores)
#: exponentials a second on the special function units of an H100 SXM5
#: (FlashAttention-3, Shah et al. 2024, section 3: 3.9 TFLOPS of
#: exponential against 989 of bf16 matrix products)
EXP_PER_S = 3.9e12

#: Arithmetic operations per row of each pricing formula (additions,
#: subtractions, multiplications, divisions; comparisons and selects not
#: counted).
PRICING_OPS = {"price": 35, "roofline": 11}


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's bytes, operations and the peak rate of those operations."""

    bytes: float
    flops: float
    rate: float

    def bound_ms(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the larger of bytes over the memory
        rate and operations over their peak rate."""
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = self.flops / self.rate * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes: all, or those with key <=
    query (top-left causal: query row i sees min(i + 1, sk) keys)."""
    if not causal:
        return sq * sk
    m = min(sq, sk)
    return m * (m + 1) // 2 + (sq - m) * sk


# ------------------------------ row 1 ----------------------------------------
def rmsnorm(rows: int, d: int, kind: str, f32: bool = False) -> Work:
    """The fused RMSNorm over (rows, d). kind "residual": x and r read, y and
    the new residual written in the element type (bf16, or f32); "plain": x
    read, y and the residual written; "gated": the f32 y and the z read,
    the output written; w in f32 once. Operations: ~5 an element (the add,
    the square, the scalings), ~15 gated (the exp and the divide of the
    SiLU, its product)."""
    e = 4 if f32 else 2        # bytes of an element-type value
    if kind == "gated_stat":   # split rows: y and z read, a float a row out
        return Work(rows * d * (4 + e) + rows * 4, 12.0 * rows * d, F32_FLOP_PER_S)
    if kind == "gated_apply":  # y, z and the summed floats read, the output written
        return Work(rows * d * (4 + 2 * e) + rows * 4 + d * 4, 15.0 * rows * d,
                    F32_FLOP_PER_S)
    per = {"residual": 4 * e, "plain": 3 * e}.get(kind, 4 + 2 * e)
    ops = 15.0 if kind.startswith("gated") else 5.0
    return Work(rows * d * per + d * 4, ops * rows * d, F32_FLOP_PER_S)


def rmsnorm_bwd(rows: int, d: int, kind: str, with_dr: bool = True,
                f32: bool = False) -> Work:
    """The fused RMSNorm's backward over (rows, d). kind "residual": x, r,
    dh (and dr, ``with_dr``) read and one dx written in the element type
    (bf16, or f32); "plain": x, dh (and dr) read, dx written; "gated": the
    f32 y, z and dh read, the f32 dy and dz written; w read and dw written
    once in f32. Operations: ~12 an element (the row sums, ds, the dw
    share), ~30 gated (the SiLU's exp and divides, the chain's products)."""
    e = 4 if f32 else 2        # bytes of an element-type value
    if kind == "gated_stat":   # split rows: y, z and dh read, two floats a row out
        return Work(rows * d * (4 + 2 * e) + rows * 8 + d * 4, 14.0 * rows * d,
                    F32_FLOP_PER_S)
    if kind == "gated_apply":  # the gated backward, and the summed floats read
        return Work(rows * d * (8 + 3 * e) + rows * 8 + d * 8, 30.0 * rows * d,
                    F32_FLOP_PER_S)
    per = {"residual": 4 * e, "plain": 3 * e}.get(kind, 8 + 3 * e) + (
        e if with_dr and kind != "gated" else 0)
    ops = 30.0 if kind.startswith("gated") else 12.0
    return Work(rows * d * per + d * 8, ops * rows * d, F32_FLOP_PER_S)


# ------------------------------ row 2 ----------------------------------------
def decode_attention(b: int, h: int, hkv: int, hd: int, kv_len: int,
                     f32: bool = False, cache_bytes: int | None = None) -> Work:
    """One query token per sequence over the kv_len valid cache rows: q and
    o in bf16 (or f32), the K and V rows read (``cache_bytes`` a value: q's
    size unless given; a float32 model keeps a bf16 cache), the f32 lse
    written; two products of 2 hd operations per (head, position) on the
    tensor cores (f32: at the split rate, :func:`_rate`)."""
    e = 4 if f32 else 2
    c = e if cache_bytes is None else cache_bytes
    nb = 2 * b * h * hd * e + 2 * b * hkv * kv_len * hd * c + b * h * 4
    return Work(nb, 4.0 * b * h * kv_len * hd, _rate(f32))


# ------------------------------ rows 3, 5, 6, 7 ------------------------------
def _attention_bytes(b, h, hkv, sq, sk, hd, f32=False):
    """(bytes of one bf16 (or f32) (B, H, Sq, hd) tensor, of one (B, Hkv,
    Sk, hd) one, of one f32 (B, H, Sq) row statistic)."""
    e = 4 if f32 else 2
    return b * h * sq * hd * e, b * hkv * sk * hd * e, b * h * sq * 4


def _rate(f32: bool) -> float:
    """The peak rate of the attention kernels' products: bf16 on the tensor
    cores; f32 at f32 accuracy, the split rate of the TF32 tensor cores
    (the least time the card can take at that accuracy)."""
    return F32_SPLIT_FLOP_PER_S if f32 else BF16_FLOP_PER_S


def f32_cores(w: Work) -> Work:
    """A float32 attention launch's work at the CUDA cores' rate: a second
    bound, what FMA tiles on the CUDA cores could reach at best."""
    return dataclasses.replace(w, rate=F32_FLOP_PER_S)


def flash_attention(b, h, hkv, sq, sk, hd, causal, f32=False) -> Work:
    """The serving forward: q, k, v read, o written; two products of 2 hd
    operations per (query, key) pair."""
    qb, kb, _ = _attention_bytes(b, h, hkv, sq, sk, hd, f32)
    pairs = attention_pairs(sq, sk, causal)
    return Work(2 * qb + 2 * kb, 4.0 * b * h * hd * pairs, _rate(f32))


def flash_attention_fwd_lse(b, h, hkv, sq, sk, hd, causal, f32=False) -> Work:
    """The training forward: as :func:`flash_attention`, plus the f32 LSE."""
    qb, kb, rows = _attention_bytes(b, h, hkv, sq, sk, hd, f32)
    mm = 2.0 * b * h * hd * attention_pairs(sq, sk, causal)
    return Work(2 * qb + 2 * kb + rows, 2 * mm, _rate(f32))


def flash_attention_bwd_dkv(b, h, hkv, sq, sk, hd, causal, f32=False) -> Work:
    """dK/dV: q, do, k, v, LSE and D read, dk and dv written; four products
    (S = Q Kᵀ, dP = dO Vᵀ, dV += Pᵀ dO, dK += dSᵀ Q)."""
    qb, kb, rows = _attention_bytes(b, h, hkv, sq, sk, hd, f32)
    mm = 2.0 * b * h * hd * attention_pairs(sq, sk, causal)
    return Work(2 * qb + 4 * kb + 2 * rows, 4 * mm, _rate(f32))


def flash_attention_bwd_dq(b, h, hkv, sq, sk, hd, causal, f32=False) -> Work:
    """dQ: q, do, k, v, LSE and D read, dq written; three products (S, dP,
    dQ += dS K)."""
    qb, kb, rows = _attention_bytes(b, h, hkv, sq, sk, hd, f32)
    mm = 2.0 * b * h * hd * attention_pairs(sq, sk, causal)
    return Work(3 * qb + 2 * kb + 2 * rows, 3 * mm, _rate(f32))


def exponentials(name: str, *shape, **kw) -> Work:
    """The softmax's exponentials of attention kernel ``name`` (a function
    of this module: ``decode_attention`` or a flash kernel, called with the
    same shape arguments) at the special function units' rate: a second
    bound beside the kernel's :class:`Work`, as :func:`f32_cores` is, its
    ``flops`` the exponentials. One a (head, query, key) pair in the
    forward, the forward with LSE, dK/dV and dQ (each recomputes P); one a
    (head, position) in decode."""
    w = globals()[name](*shape, **kw)
    if name == "decode_attention":
        b, h, _, _, kv_len = shape[:5]
        n = b * h * kv_len
    else:
        b, h, _, sq, sk, _, causal = shape[:7]
        n = b * h * attention_pairs(sq, sk, causal)
    return dataclasses.replace(w, flops=float(n), rate=EXP_PER_S)


# ------------------------------ row 4 ----------------------------------------
def ssd_multiply_adds(b: int, s: int, h: int, p: int, n: int,
                      split: bool = False) -> int:
    """Multiply-adds of the chunked scan at the kernel's chunk q, the causal
    half of each q x q product counted: C Bᵀ once per (sequence, chunk),
    since B and C are shared by the heads; per (sequence, head, chunk) the
    masked scores times x dt, C h and Bᵀ x dt. ``split``: the same scan on
    tensor cores at f32 accuracy from bf16 inputs, C Bᵀ one exact bf16
    product, the other three with one operand split into three bf16 terms
    (ssd.cu's header)."""
    from .ssd.ref import CHUNK as q

    nc = -(-s // q)
    tri = q * (q + 1) // 2
    return b * nc * tri * n + (3 if split else 1) * b * h * nc * (tri * p + 2 * q * n * p)


def ssd_bytes(x_numel: int, x_size: int, dt_numel: int, bc_numel: int,
              bc_size: int, state_numel: int) -> int:
    """x, dt, dA (f32), B and C as stored, read once; y (f32, x's shape) and
    the final f32 state written once. ``bc_numel`` counts one of B, C as
    stored (B/C shared by the heads are stored once)."""
    return (x_numel * x_size + 2 * dt_numel * 4 + 2 * bc_numel * bc_size
            + x_numel * 4 + state_numel * 4)


def ssd(b, s, h, p, n, nbytes: int) -> Work:
    """The SSD scan on the tensor cores: its bytes, its split products."""
    return Work(nbytes, 2.0 * ssd_multiply_adds(b, s, h, p, n, split=True),
                BF16_FLOP_PER_S)


def ssd_f32_cores(b, s, h, p, n, nbytes: int) -> Work:
    """The same scan's f32 arithmetic on the CUDA cores: a second bound."""
    return Work(nbytes, 2.0 * ssd_multiply_adds(b, s, h, p, n), F32_FLOP_PER_S)


# ------------------------------ rows 8, 9 ------------------------------------
def pricing(entry: str, n_in: int, n_out: int, n: int, f32: bool) -> Work:
    """One pricing launch over n rows: the f64 columns read, the f64 (or
    f32) outputs written; PRICING_OPS[entry] operations a row."""
    nb = n_in * n * 8 + n_out * n * (4 if f32 else 8)
    return Work(nb, PRICING_OPS[entry] * n,
                F32_FLOP_PER_S if f32 else F64_FLOP_PER_S)


# ------------------------------ the op counter's hook -------------------------
_active: list[dict] = []


@contextlib.contextmanager
def counting():
    """Collect the work of every kernel launched eagerly inside the block:
    yields a dict ``{"flops", "bytes", "launches": {name: n}}`` that
    :func:`record` fills. Launches captured into a CUDA graph are not
    recorded (they run at the graph's replays)."""
    tally = {"flops": 0.0, "bytes": 0.0, "launches": {}}
    _active.append(tally)
    try:
        yield tally
    finally:
        _active.remove(tally)


def record(name: str, work: Callable[[], Work]) -> None:
    """Add one launch of kernel ``name`` to the innermost active count;
    ``work`` is called only while a count is active."""
    if not _active:
        return
    w = work()
    tally = _active[-1]
    tally["flops"] += w.flops
    tally["bytes"] += w.bytes
    tally["launches"][name] = tally["launches"].get(name, 0) + 1
