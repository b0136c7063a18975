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


def _convert(tree, dtype, device, index=None, specs=None, mesh=None):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device, index,
                            None if specs is None else specs[k], mesh)
                for k, v in tree.items()}
    a = tree if index is None else tree[index]
    if specs is not None:
        from ..launch.shardings import local_shard
        a = local_shard(np.asarray(a), specs, mesh)
    return _tensor(a, dtype, device)


def params_from_jax_numpy(cfg: ModelConfig, tree: dict, device=None,
                          dtype: torch.dtype | None = None, shardings=None,
                          mesh=None) -> dict:
    """The port's parameters, equal to ``tree``'s, on ``device``; matrices
    in ``dtype`` (default the compute dtype; training passes float32), 1-D
    leaves (norm weights and biases) in float32. Empty subtrees (a
    non-parametric norm) stay ``{}``. ``stack`` becomes n_blocks block
    dictionaries, ``enc_stack`` (an encoder-decoder's) encoder_layers
    layer dictionaries; ``enc_final_norm`` carries over as ``final_norm``
    does. With ``shardings`` (``launch/shardings.param_shardings``) and its
    ``mesh``, each leaf is cut to this rank's block before it is turned
    into a tensor (the Mamba2 projection by its segments), as
    ``shard_tree`` cuts the whole tree."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    specs = shardings or {}

    def spec(k, i=None):
        if shardings is None:
            return None
        return specs[k] if i is None else specs[k][i]

    stacked = {"stack": cfg.n_blocks, "enc_stack": cfg.encoder_layers}
    params = {k: _convert(v, dtype, device, specs=spec(k), mesh=mesh)
              for k, v in tree.items() if k not in stacked}
    for k, n in stacked.items():
        if k in tree:
            params[k] = [_convert(tree[k], dtype, device, index=i, specs=spec(k, i),
                                  mesh=mesh) for i in range(n)]
    return params
