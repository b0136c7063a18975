"""Model stack of the port (PyTorch)."""
from .config import ModelConfig
from .convert import params_from_jax_numpy
from .inputs import synth_batch
from .transformer import (cache_spec, decode_step, encode, forward,
                          forward_part, init_cache, init_params, loss_fn, param_count,
                          param_dtype, prefill, to_device)

__all__ = ["ModelConfig", "cache_spec", "decode_step", "encode", "forward",
           "forward_part", "init_cache", "init_params", "loss_fn", "param_count",
           "param_dtype", "params_from_jax_numpy", "prefill", "synth_batch",
           "to_device"]
