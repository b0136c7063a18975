"""Plain PyTorch version of fused residual add + RMSNorm, and of the gated
norm of the Mamba2 layer, with the backward of both forms; and the plain
versions of the split-row gated norm's four launches (a rank's block of
each row, the row sums added over the ranks in between)."""
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


def fused_rmsnorm_bwd_ref(dh: torch.Tensor, dr: torch.Tensor | None,
                          x: torch.Tensor, w: torch.Tensor,
                          residual: torch.Tensor | None = None,
                          eps: float = 1e-6, gate: torch.Tensor | None = None):
    """The backward of :func:`fused_rmsnorm_ref` at (x, w, residual, gate),
    given dh, the gradient of the normed output, and dr, that of the new
    residual (None where it is unused; a gated call has none).

    With s the f32 sum x (+ residual), rstd = rsqrt(mean(s²) + eps) and
    ŝ = s·rstd, the norm's backward is ds = rstd·(w·dh − ŝ·mean(w·dh·ŝ))
    and dw = Σ_rows dh·ŝ, in f32.
      residual form: returns (dx, dresidual, dw), dx = dresidual =
        ds + dr rounded once to x's dtype (dresidual None without a
        residual: the first norm of a pass, whose new residual is x);
      gated form: the norm of g = (x·silu(gate)) in the gate's dtype, then
        the chain's own backward: each cast passes the gradient through,
        cast back, and each product and SiLU rounds its gradient to the
        gate's dtype as torch's autograd does. Returns (dx in x's dtype,
        dgate in the gate's dtype, dw).
    dw is float32, (d,)."""
    if gate is not None:
        s = _gated_rows(x, gate)
    else:
        s = x.float() if residual is None else x.float() + residual.float()
    rstd = torch.rsqrt(torch.mean(s * s, dim=-1, keepdim=True) + eps)
    sh = s * rstd
    dhf = dh.float()
    dw = (dhf * sh).sum(0)
    g = dhf * w.float()
    ds = rstd * (g - sh * torch.mean(g * sh, dim=-1, keepdim=True))
    if gate is None:
        if dr is not None:
            ds = ds + dr.float()
        dx = ds.to(x.dtype)
        return dx, (dx if residual is not None else None), dw
    return (*_gated_chain_bwd(ds, x, gate), dw)


def _gated_chain_bwd(ds: torch.Tensor, x: torch.Tensor, gate: torch.Tensor):
    """(dx, dgate) of the gate's chain g = x·silu(gate), given ds = dL/dg in
    f32, rounded where torch's autograd of the unfused chain rounds."""
    xb = x.to(gate.dtype)
    sz = F.silu(gate)
    dg = ds.to(gate.dtype)
    dx = (dg * sz).to(x.dtype)
    zf = gate.float()
    sig = torch.sigmoid(zf)
    dz = ((dg * xb).float() * (sig * (1 + zf * (1 - sig)))).to(gate.dtype)
    return dx, dz


# ------------------------- split rows (a rank's block) -----------------------
def _gated_rows(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """g = x·silu(gate) in the gate's dtype, as f32 (T, d)."""
    return (x.to(gate.dtype) * F.silu(gate)).float()


def gated_norm_stat_ref(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The statistic launch: each row's f32 sum of g² over this block, (T,)."""
    g = _gated_rows(x, gate)
    return (g * g).sum(-1)


def gated_norm_apply_ref(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                         stats: torch.Tensor, dn: int, eps: float = 1e-6) -> torch.Tensor:
    """The apply launch: g normalised by rsqrt(stats / dn + eps), stats the
    sum of g² over the whole row (every block), times this block's w; in
    the gate's dtype."""
    g = _gated_rows(x, gate)
    rstd = torch.rsqrt(stats.float() / dn + eps)[:, None]
    return (g * rstd * w.float()).to(gate.dtype)


def gated_norm_bwd_stat_ref(dh: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """The backward's statistic launch: each row's f32 sums over this block
    of g² and of w·dh·g, (T, 2)."""
    g = _gated_rows(x, gate)
    return torch.stack([(g * g).sum(-1), (dh.float() * w.float() * g).sum(-1)], -1)


def gated_norm_bwd_apply_ref(dh: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
                             w: torch.Tensor, stats: torch.Tensor, dn: int,
                             eps: float = 1e-6):
    """The backward's apply launch, given both sums over the whole row:
    (dx, dgate, dw of this block's columns), as
    :func:`fused_rmsnorm_bwd_ref` defines them over the whole row."""
    s = _gated_rows(x, gate)
    stats = stats.float()
    rstd = torch.rsqrt(stats[:, 0] / dn + eps)[:, None]
    sh = s * rstd
    dhf = dh.float()
    dw = (dhf * sh).sum(0)
    g = dhf * w.float()
    mean = stats[:, 1:2] * rstd / dn
    ds = rstd * (g - sh * mean)
    return (*_gated_chain_bwd(ds, x, gate), dw)
