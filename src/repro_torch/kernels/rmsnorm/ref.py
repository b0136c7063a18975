"""Plain PyTorch version of fused residual add + RMSNorm."""
from __future__ import annotations

import torch


def fused_rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                      residual: torch.Tensor | None = None,
                      eps: float = 1e-6):
    """x: (T, d). Returns (normed, new_residual). fp32 accumulation."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype), xf.to(x.dtype)
