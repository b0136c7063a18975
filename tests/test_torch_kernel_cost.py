"""One definition of each kernel's bytes and operations
(``repro_torch.kernels.cost``): the bounds ``chip_smoke.py`` prints and the
dry-run op counter adds. Evaluated at the shapes of ``PERF.md`` §6, it
finds the bounds recorded there (rounded as there); and each wrapper
reports its launch's work to an active count."""
from __future__ import annotations

import pytest

from repro_torch.kernels import _build, cost
from repro_torch.kernels.pricing.ref import FORMULAS


def _ms(work):
    return work.bound_ms()


@pytest.mark.parametrize("rows, d, kind, want_us", [
    (4, 5120, "residual", 0.055), (8, 768, "residual", 0.016),
    (8, 1536, "gated", 0.031), (8192, 5120, "residual", 100.2),
    (16384, 768, "residual", 30.0), (16384, 1536, "gated", 60.1)])
def test_row1_rmsnorm_bounds(rows, d, kind, want_us):
    ms, by = _ms(cost.rmsnorm(rows, d, kind))
    assert by == "bytes"
    assert round(ms * 1e3, 3 if want_us < 1 else 1) == want_us


@pytest.mark.parametrize("rows, d, kind, with_dr, want_us", [
    (16384, 768, "residual", True, 37.6), (16384, 1536, "gated", False, 105.2),
    (4096, 5120, "residual", True, 62.6), (4096, 5120, "plain", True, 50.1)])
def test_rmsnorm_backward_bounds(rows, d, kind, with_dr, want_us):
    """The RMSNorm backward at the training shapes of PERF.md's second
    kernel table: bytes-bound, 10 bytes an element with the residual and
    dr, 14 gated (the f32 y and dy)."""
    ms, by = _ms(cost.rmsnorm_bwd(rows, d, kind, with_dr))
    assert by == "bytes"
    assert round(ms * 1e3, 1) == want_us


def test_row2_decode_bound():
    # (4, 32/8, cache 2081, 128, kv_len 2079)
    ms, by = _ms(cost.decode_attention(4, 32, 8, 128, 2079))
    assert (round(ms, 4), by) == (0.0102, "bytes")


def test_row3_flash_bound():
    ms, by = _ms(cost.flash_attention(4, 32, 8, 2048, 2048, 128, True))
    assert (round(ms, 3), by) == (0.139, "operations")


def test_row4_ssd_bounds():
    b, s, h, p, n = 8, 2048, 24, 64, 128
    nb = cost.ssd_bytes(b * s * h * p, 2, b * s * h, b * s * n, 2, b * h * p * n)
    ms, by = _ms(cost.ssd(b, s, h, p, n, nb))
    assert (round(ms, 4), by) == (0.0504, "bytes")
    split = cost.ssd(b, s, h, p, n, nb).flops / cost.BF16_FLOP_PER_S * 1e3
    assert round(split, 3) == 0.044
    ms, by = _ms(cost.ssd_f32_cores(b, s, h, p, n, nb))
    assert (round(ms, 3), by) == (0.219, "operations")


@pytest.mark.parametrize("name, want_ms, gflop", [
    ("flash_attention_fwd_lse", 0.139, 137.5),
    ("flash_attention_bwd_dkv", 0.278, 275.0),
    ("flash_attention_bwd_dq", 0.209, 206.3)])
def test_rows5_to_7_training_bounds(name, want_ms, gflop):
    work = getattr(cost, name)(8, 16, 16, 2048, 2048, 128, True)
    ms, by = _ms(work)
    assert (round(ms, 3), by) == (want_ms, "operations")
    assert round(work.flops / 1e9, 1) == gflop


@pytest.mark.parametrize("entry, f32, want_ms", [
    ("price", False, 0.0876), ("roofline", False, 0.0351),
    ("price", True, 0.0751), ("roofline", True, 0.0275)])
def test_rows8_9_pricing_bounds(entry, f32, want_ms):
    _, names, outs, _ = FORMULAS[entry]
    ms, by = _ms(cost.pricing(entry, len(names), len(outs), 1 << 20, f32))
    assert (round(ms, 4), by) == (want_ms, "bytes")


@pytest.mark.parametrize("sq, sk", [(1, 1), (7, 7), (300, 129), (129, 300), (5, 0)])
def test_attention_pairs_closed_form(sq, sk):
    assert cost.attention_pairs(sq, sk, True) == sum(min(i + 1, sk) for i in range(sq))
    assert cost.attention_pairs(sq, sk, False) == sq * sk


def test_launched_records_work_only_while_counting(monkeypatch):
    """A wrapper's work reaches an active count (and only then is it
    computed), once per launch, by the wrapper's name. (A CPU build of
    torch has no stream to ask whether it captures: none does.)"""
    import torch
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    def fake_kernel():
        pass
    fake_kernel.launches = 0
    calls = []

    def work():
        calls.append(1)
        return cost.Work(bytes=10.0, flops=4.0, rate=1.0)

    _build.launched(fake_kernel, work)
    assert fake_kernel.launches == 1 and calls == []
    with cost.counting() as tally:
        _build.launched(fake_kernel, work)
        _build.launched(fake_kernel, work)
    assert tally == {"flops": 8.0, "bytes": 20.0, "launches": {"fake_kernel": 2}}
    assert fake_kernel.launches == 3 and len(calls) == 2 and not cost._active


# ------------------------------ float32 launches ------------------------------
def test_f32_attention_work_counts_4_bytes_at_the_cuda_core_rate():
    """Float32 attention counts 4-byte values and the same operations as
    bf16, at the split TF32 rate (three TF32 products a float32 one); the
    CUDA cores' rate is the second bound (:func:`cost.f32_cores`)."""
    args = (2, 32, 8, 2048, 2048, 128, True)
    assert cost.F32_SPLIT_FLOP_PER_S == cost.TF32_FLOP_PER_S / 3 == 165e12
    for fn in (cost.flash_attention, cost.flash_attention_fwd_lse,
               cost.flash_attention_bwd_dkv, cost.flash_attention_bwd_dq):
        bf, f32 = fn(*args), fn(*args, f32=True)
        assert f32.flops == bf.flops and f32.rate == cost.F32_SPLIT_FLOP_PER_S
        assert bf.rate == cost.BF16_FLOP_PER_S
        # the row statistics (LSE, D) stay f32: the rest doubles
        rows = {cost.flash_attention: 0, cost.flash_attention_fwd_lse: 1,
                cost.flash_attention_bwd_dkv: 2, cost.flash_attention_bwd_dq: 2}[fn]
        stat = 2 * 32 * 2048 * 4
        assert f32.bytes - rows * stat == 2 * (bf.bytes - rows * stat)
    ms, by = cost.flash_attention(*args, f32=True).bound_ms()
    assert by == "operations" and round(ms, 4) == 0.4167


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_fwd_lse",
                                "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                                "decode_attention"])
def test_f32_attention_second_bound_reads_the_cuda_cores(fn):
    """The second bound: the same bytes and operations at the CUDA cores'
    67 TFLOP/s, what FMA tiles could reach at best (1.026 ms for the
    serving forward at (2, 32/8, 2048, 128), 2.052 ms for dK/dV at
    olmo_1b's (4, 16/16, 2048, 128)); the split bound is that over 165 /
    67."""
    args = ((2, 32, 8, 128, 2079) if fn == "decode_attention"
            else (2, 32, 8, 2048, 2048, 128, True))
    w = getattr(cost, fn)(*args, f32=True)
    cores = cost.f32_cores(w)
    assert (cores.bytes, cores.flops, cores.rate) == (w.bytes, w.flops, cost.F32_FLOP_PER_S)
    assert cores.bound_ms()[0] >= w.bound_ms()[0]
    if fn != "decode_attention":    # decode is bytes-bound either way
        assert cores.bound_ms()[0] / w.bound_ms()[0] == pytest.approx(165 / 67)
    if fn == "flash_attention":
        assert round(cores.bound_ms()[0], 3) == 1.026
    dkv = cost.f32_cores(cost.flash_attention_bwd_dkv(4, 16, 16, 2048, 2048, 128, True,
                                                      f32=True))
    assert round(dkv.bound_ms()[0], 3) == 2.052


def test_f32_decode_work_reads_the_cache_in_its_own_dtype():
    bf = cost.decode_attention(2, 32, 8, 128, 2079)
    f32_bf16_cache = cost.decode_attention(2, 32, 8, 128, 2079, f32=True, cache_bytes=2)
    f32_cache = cost.decode_attention(2, 32, 8, 128, 2079, f32=True)
    q_o = 2 * 2 * 32 * 128
    assert f32_bf16_cache.bytes - bf.bytes == 2 * q_o
    assert f32_cache.bytes - f32_bf16_cache.bytes == 2 * 2 * 8 * 2079 * 128 * 2
    assert f32_cache.rate == cost.F32_SPLIT_FLOP_PER_S and bf.rate == cost.BF16_FLOP_PER_S


@pytest.mark.parametrize("kind,per_bf16,per_f32", [
    ("residual", 8, 16), ("plain", 6, 12), ("gated", 8, 12)])
def test_f32_rmsnorm_work_doubles_the_element_type_bytes(kind, per_bf16, per_f32):
    rows, d = 4096, 5120
    assert cost.rmsnorm(rows, d, kind).bytes == rows * d * per_bf16 + d * 4
    assert cost.rmsnorm(rows, d, kind, f32=True).bytes == rows * d * per_f32 + d * 4
    bwd = {"residual": (10, 20), "plain": (8, 16), "gated": (14, 20)}[kind]
    assert cost.rmsnorm_bwd(rows, d, kind).bytes == rows * d * bwd[0] + d * 8
    assert cost.rmsnorm_bwd(rows, d, kind, f32=True).bytes == rows * d * bwd[1] + d * 8


# ------------------------------ the exponentials ------------------------------
def test_hd16_dkv_exponential_bound_exceeds_its_tensor_bound():
    """At hd 16 the softmax's exponentials, one a (head, query, key) pair at
    the special function units' 3.9e12 a second, bound dK/dV above its
    tensor-core term: 67.1 M pairs at (4, 8/2, 2048, 16) causal, 0.0172 ms
    against 0.00869 ms."""
    args = (4, 8, 2, 2048, 2048, 16, True)
    tensor = cost.flash_attention_bwd_dkv(*args)
    exps = cost.exponentials("flash_attention_bwd_dkv", *args)
    assert cost.EXP_PER_S == 3.9e12
    assert exps.flops == 4 * 8 * cost.attention_pairs(2048, 2048, True) == 67_141_632
    assert exps.bytes == tensor.bytes and exps.rate == cost.EXP_PER_S
    assert (round(exps.bound_ms()[0], 4), exps.bound_ms()[1]) == (0.0172, "operations")
    assert round(tensor.bound_ms()[0], 5) == 0.00869
    assert exps.bound_ms()[0] > tensor.bound_ms()[0]


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_fwd_lse",
                                  "flash_attention_bwd_dkv", "flash_attention_bwd_dq"])
def test_exponentials_leave_the_existing_bounds_alone(name):
    """The second bound is reported beside the kernel's, never folded in:
    at hd 128 every flash kernel keeps its tensor-core figure (the serving
    forward at (4, 32/8, 2048, 128) still 0.139 ms "operations"), which its
    exponentials (one a pair, 0.0689 ms there) stay under."""
    args = (4, 32, 8, 2048, 2048, 128, True)
    w = getattr(cost, name)(*args)
    exps = cost.exponentials(name, *args)
    assert exps.flops == 4 * 32 * cost.attention_pairs(2048, 2048, True)
    assert exps.bound_ms()[0] < w.bound_ms()[0]
    if name == "flash_attention":
        assert (round(w.bound_ms()[0], 3), w.bound_ms()[1]) == (0.139, "operations")
        assert round(exps.bound_ms()[0], 4) == 0.0689


@pytest.mark.parametrize("hd, h, hkv", [(16, 8, 2), (128, 32, 8)])
def test_decode_exponentials_are_negligible(hd, h, hkv):
    """Decode takes one exponential a (head, position): 66.5 K at the hd-16
    SMOKE shape (4, 8/2, 2079 positions), 17 ns, far under the bytes it
    reads, so its second bound is its bytes bound."""
    w = cost.decode_attention(4, h, hkv, hd, 2079)
    exps = cost.exponentials("decode_attention", 4, h, hkv, hd, 2079)
    assert exps.flops == 4 * h * 2079
    assert exps.flops / cost.EXP_PER_S * 1e3 < w.bound_ms()[0] / 10
    assert exps.bound_ms() == w.bound_ms() and w.bound_ms()[1] == "bytes"
