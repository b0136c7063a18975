"""Plain PyTorch version of fused residual add + RMSNorm, and of the gated
norm of the Mamba2 layer."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fused_rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                      residual: torch.Tensor | None = None,
                      eps: float = 1e-6, gate: torch.Tensor | None = None):
    """x: (T, d). Returns (normed, new_residual). fp32 accumulation.

    With ``gate`` (T, d): normalises g = x * silu(gate) with no residual and
    returns (normed, None), both g and the result in the gate's dtype. Each
    of x, silu(gate) and their product is rounded once to that dtype, as the
    unfused chain of torch ops rounds them."""
    if gate is not None:
        return fused_rmsnorm_ref(x.to(gate.dtype) * F.silu(gate), w, None, eps)[0], None
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype), xf.to(x.dtype)
