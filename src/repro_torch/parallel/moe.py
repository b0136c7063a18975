"""Expert-parallel MoE dispatch (the reference's ``parallel/moe.py``).

The experts' weights are sharded on the 'model' axis (E / m experts a
rank); the tokens are whole on every rank of it (they are, after the
attention's all-reduce). Every rank runs the same router, then builds only
its local experts' capacity buffer (a local scatter, no communication),
runs their FFN, gathers their outputs back to token order, and the partial
token outputs are summed with one all-reduce of (T, d): the only collective
of the layer, O(T d) where a partitioned scatter of the whole buffer moves
O(E cap d).

:func:`moe_shard_map` is the reference's schedule: routing and capacity
over this rank's tokens (its block of the data axes). :func:`moe_mesh` is
the capacity dispatch of ``layers.moe`` (``moe_dispatch="gspmd"``) under a
mesh, computed exactly as one device computes it over the whole batch: the
capacity from the global token count, and each (token, slot)'s rank within
its expert offset by the pairs the data ranks before this one routed there.
"""
from __future__ import annotations

import math

import torch

from .dist import all_gather, copy_to, reduce_from


def _batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _experts(p: dict, cfg, mesh):
    """(model group or None, first local expert, local experts)."""
    e_local = p["wi"].shape[0]
    if e_local == cfg.moe_experts:
        return None, 0, e_local
    return mesh.group("model"), mesh.index("model") * e_local, e_local


def _run(p: dict, x: torch.Tensor, cfg, mesh, capacity_factor,
         global_routing: bool) -> torch.Tensor:
    from ..models import layers as L
    b, s, d = x.shape
    t = b * s
    group, lo, e_local = _experts(p, cfg, mesh)
    xt = copy_to(x.reshape(t, d), group)
    gates, idx, rank, keep, cap = L.moe_dispatch(p, xt, cfg, capacity_factor)
    data = _batch_axes(mesh)
    n_data = mesh.size(data)
    if global_routing and n_data > 1:
        # the pairs each earlier data rank routed to every expert
        dgroup = mesh.group(data)
        counts = torch.zeros(cfg.moe_experts, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
        every = all_gather(counts[None], 0, dgroup)            # (n_data, E)
        before = every[:mesh.index(data)].sum(0)
        rank = rank + before[idx]
        cf = cfg.moe_capacity_factor if capacity_factor is None else capacity_factor
        cap = int(max(1, math.ceil(t * n_data * cfg.moe_top_k
                                   / cfg.moe_experts * cf)))
        keep = rank < cap
    y = L.moe_experts(p, xt, gates, idx, rank, keep, cap, lo, e_local)
    y = reduce_from(y, group, L.reduce_dtype(cfg, y))
    return y.reshape(b, s, d)


def moe_shard_map(p: dict, x: torch.Tensor, cfg, mesh,
                  capacity_factor: float | None = None) -> torch.Tensor:
    """The reference's hand-scheduled expert-parallel dispatch. x: (B, S,
    d), this rank's rows (its block of the data axes), whole over 'model';
    p: the router whole, the experts' (E / m, d, f) / (E / m, f, d) this
    rank's block of 'model'. Routing and capacity over the local tokens."""
    if cfg.moe_experts % mesh.size("model"):
        raise ValueError(f"{cfg.moe_experts} experts on a model axis of "
                         f"{mesh.size('model')}")
    return _run(p, x, cfg, mesh, capacity_factor, global_routing=False)


def moe_mesh(p: dict, x: torch.Tensor, cfg, mesh,
             capacity_factor: float | None = None) -> torch.Tensor:
    """``layers.moe``'s capacity dispatch over a mesh, equal to one device's
    over the global batch: global capacity and ranks, local experts."""
    return _run(p, x, cfg, mesh, capacity_factor, global_routing=True)


def moe_dense_mesh(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``layers.moe_dense`` (dropless, decode) with the experts on
    'model': each rank runs its experts on every token and weights them by
    their gates, then one all-reduce of (T, d)."""
    from ..models import layers as L
    b, s, d = x.shape
    group, lo, e_local = _experts(p, cfg, mesh)
    xt = copy_to(x.reshape(b * s, d), group)
    _, gates, idx = L._route(p, xt, cfg.moe_top_k)
    combine = torch.zeros((b * s, cfg.moe_experts), dtype=torch.float32,
                          device=x.device)
    combine.scatter_add_(1, idx, gates)
    combine = combine[:, lo:lo + e_local]
    h = torch.matmul(xt, p["wi"].to(x.dtype))                   # (E_l, T, f)
    g = torch.matmul(xt, p["wg"].to(x.dtype)) if "wg" in p else None
    y = torch.bmm(L._activation(h, g), p["wo"].to(x.dtype))     # (E_l, T, d)
    y = torch.einsum("etd,te->td", y, combine.to(x.dtype))
    y = reduce_from(y, group, L.reduce_dtype(cfg, y))
    return y.reshape(b, s, d)
