"""Carry a reference parameter tree over to the port.

The tree is the reference's ``init_params`` output with every leaf turned
into a numpy array by the caller (``jax.tree.map(np.asarray, params)``);
this module itself needs only numpy. Stacked leaves under ``"stack"`` have
the leading axis n_blocks and become the port's list of blocks (a cross
layer's ``lnx`` and ``xattn`` inside them); those under ``"enc_stack"``
have the leading axis encoder_layers and become the port's list of encoder
layers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .transformer import check_supported, compute_dtype


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # 1-D leaves (norm weights; the SSM's A_log, D, dt_bias, norm_w) stay
    # float32; matrices (projections, the SSM's conv_w, the MoE router and
    # its (E, d, f) / (E, f, d) expert stacks) take the compute
    # dtype, as the reference casts them per use. bfloat16 numpy arrays
    # have no torch counterpart, so everything passes through float32
    # (exact for both source dtypes).
    arr = np.array(a, dtype=np.float32)        # a writable copy
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=torch.float32 if arr.ndim == 1 else dtype)


def _convert(tree, dtype, device, index=None):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device, index) for k, v in tree.items()}
    return _tensor(tree if index is None else tree[index], dtype, device)


def params_from_jax_numpy(cfg: ModelConfig, tree: dict, device=None,
                          dtype: torch.dtype | None = None) -> dict:
    """The port's parameters, equal to ``tree``'s, on ``device``; matrices
    in ``dtype`` (default the compute dtype; training passes float32), 1-D
    leaves (norm weights and biases) in float32. Empty subtrees (a
    non-parametric norm) stay ``{}``. ``stack`` becomes n_blocks block
    dictionaries, ``enc_stack`` (an encoder-decoder's) encoder_layers
    layer dictionaries; ``enc_final_norm`` carries over as ``final_norm``
    does."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    stacked = {"stack": cfg.n_blocks, "enc_stack": cfg.encoder_layers}
    params = {k: _convert(v, dtype, device)
              for k, v in tree.items() if k not in stacked}
    for k, n in stacked.items():
        if k in tree:
            params[k] = [_convert(tree[k], dtype, device, index=i)
                         for i in range(n)]
    return params
