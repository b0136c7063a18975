"""Hand-written Hopper kernels of the port, one directory each.

  rmsnorm          — fused residual add + RMSNorm (replaces the Pallas
                     ``fused_rmsnorm_fwd``).
  decode_attention — split-KV decode attention with exported LSE, reading
                     the cache in its model layout (``decode_attention_fwd``).
  flash_attention  — FlashAttention-2 forward on bf16 tensor cores, GQA,
                     causal or full (``flash_attention_fwd``).
  pricing          — the DSE price phase's elementwise column formulas, f64
                     bit-identical and f32 drift-banded (``run_columns``,
                     ``run_columns_f32``).

Each directory holds ``csrc/<name>.cu`` (the kernel, built by
:mod:`._build` at first use), ``ops.py`` (the wrapper: kernel for CUDA
tensors, plain version for CPU tensors, a ``launches`` counter) and
``ref.py`` (the plain PyTorch version).
"""
from .decode_attention.ops import decode_attention
from .flash_attention.ops import flash_attention
from .pricing.ops import pricing_f32, pricing_f64
from .rmsnorm.ops import fused_rmsnorm

#: Every wrapper whose ``launches`` counter a run can read or reset.
WRAPPERS = {"rmsnorm": fused_rmsnorm, "decode_attention": decode_attention,
            "flash_attention": flash_attention, "pricing": pricing_f64,
            "pricing_f32": pricing_f32}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["decode_attention", "flash_attention", "fused_rmsnorm",
           "pricing_f32", "pricing_f64", "WRAPPERS", "launches",
           "reset_launches"]
