"""Model stack of the port (PyTorch)."""
from .config import ModelConfig
from .convert import params_from_jax_numpy
from .transformer import (decode_step, forward, init_cache, init_params,
                          prefill, to_device)

__all__ = ["ModelConfig", "decode_step", "forward", "init_cache",
           "init_params", "params_from_jax_numpy", "prefill", "to_device"]
