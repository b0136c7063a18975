"""Hand-written Hopper kernels of the port, one directory each.

  rmsnorm          — fused residual add + RMSNorm (replaces the Pallas
                     ``fused_rmsnorm_fwd``), and its backward
                     (``fused_rmsnorm_bwd``, no Pallas counterpart); the
                     gated norm over rows split across ranks, a statistic
                     and an apply launch each way (``gated_norm_*``).
  decode_attention — split-KV decode attention with exported LSE, reading
                     the cache in its model layout (``decode_attention_fwd``);
                     float32 on the CUDA cores (``decode_attention_f32.cu``,
                     the same split over the keys and cluster merge).
  flash_attention  — FlashAttention-2 on bf16 tensor cores, GQA, causal
                     or full: the serving forward (``flash_attention_fwd``),
                     the training forward with LSE
                     (``flash_attention_fwd_lse``) and the dK/dV and dQ
                     backward kernels (``flash_attention_bwd``), tied
                     together by ``flash_attention_train``; float32 at
                     float32 accuracy (``flash_attention_f32.cu``: the
                     forward, dK/dV and dQ on the TF32 tensor cores, each
                     operand split in two TF32 terms).
  pricing          — the DSE price phase's elementwise column formulas, f64
                     bit-identical and f32 drift-banded (``run_columns``,
                     ``run_columns_f32``).
  ssd              — the Mamba2 SSD chunk scan, state carried across the
                     chunks in one launch (``ssd_chunk_fwd``); its
                     gradient is plain tensor code (``ssd_chunk_bwd_plain``).

Each directory holds ``csrc/<name>.cu`` (the kernel, built by
:mod:`._build` at first use; attention's float32 kernels in
``csrc/<name>_f32.cu``), ``ops.py`` (the wrapper: kernel for CUDA tensors,
plain version for CPU tensors, a ``launches`` counter and one by
instantiation, ``by_kind``) and ``ref.py`` (the plain PyTorch version).
The RMSNorm, decode and flash-attention kernels take bfloat16 and float32
(attention at head dims 16, 32, 64 and 128); float16 and other dtypes
raise on the card.
"""
from .decode_attention.ops import decode_attention
from .flash_attention.ops import (flash_attention, flash_attention_bwd_dkv,
                                  flash_attention_bwd_dq,
                                  flash_attention_fwd_lse,
                                  flash_attention_train)
from .pricing.ops import pricing_f32, pricing_f64
from .rmsnorm.ops import (fused_rmsnorm, fused_rmsnorm_bwd, gated_norm_apply,
                          gated_norm_bwd_apply, gated_norm_bwd_stat,
                          gated_norm_stat)
from .ssd.ops import ssd_chunk

#: Every wrapper whose ``launches`` counter a run can read or reset.
WRAPPERS = {"rmsnorm": fused_rmsnorm, "rmsnorm_bwd": fused_rmsnorm_bwd,
            "rmsnorm_split_stat": gated_norm_stat,
            "rmsnorm_split_apply": gated_norm_apply,
            "rmsnorm_bwd_split_stat": gated_norm_bwd_stat,
            "rmsnorm_bwd_split_apply": gated_norm_bwd_apply,
            "decode_attention": decode_attention,
            "flash_attention": flash_attention,
            "flash_attention_fwd_lse": flash_attention_fwd_lse,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "pricing": pricing_f64,
            "pricing_f32": pricing_f32, "ssd": ssd_chunk}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.by_kind = {}


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launches_by_kind() -> dict[str, int]:
    """The launches of each instantiation since the last reset, keyed
    ``"<wrapper>[<kind>]"`` (``_build.kind``: the element type and, for
    attention, the head dim), those that ran only."""
    return {f"{name}[{k}]": n for name, fn in WRAPPERS.items()
            for k, n in sorted(getattr(fn, "by_kind", {}).items()) if n}


__all__ = ["decode_attention", "flash_attention", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_fwd_lse",
           "flash_attention_train", "fused_rmsnorm", "fused_rmsnorm_bwd",
           "gated_norm_apply", "gated_norm_bwd_apply", "gated_norm_bwd_stat",
           "gated_norm_stat",
           "pricing_f32", "pricing_f64", "ssd_chunk", "WRAPPERS", "launches",
           "launches_by_kind", "reset_launches"]
