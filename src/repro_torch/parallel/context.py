"""Context-parallel decode attention (the reference's
``parallel/context.py``): the KV cache sharded along the sequence over the
'model' axis, the shards' partial attentions merged by a distributed
log-sum-exp.

Each rank attends over its own block of the cache, exporting (o_local,
lse); the exact global attention is

    w_i = exp(lse_i - max_j lse_j);   o = sum_i w_i o_i / sum_i w_i

an all-reduce MAX of (B, H) and one all-reduce SUM of (B, H, hd + 1)
instead of gathering the (B, H, S) scores or the cache. Each rank computes
its window's valid length on the device, ``clamp(kv_len - rank * S_local,
0, S_local)``, so nothing is read on the host; a rank whose block lies past
the prefix contributes lse -inf and o 0 (the decode kernel returns o 0 and
lse -1e30 there, its plain version NaN: both are masked).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.decode_attention.ref import decode_attention_ref
from .dist import all_reduce


def _local_decode(q, k, v, kv_len, use_kernel: bool):
    if use_kernel:
        return decode_attention(q, k, v, kv_len, return_lse=True)
    return decode_attention_ref(q, k, v, kv_len, return_lse=True)


def lse_combine(o: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """Merge per-shard partial attentions over ``group``. o: (B, H, hd)
    normalised by its own shard's sum; lse: (B, H) f32. Exact for disjoint
    KV shards; the result in o's dtype."""
    m = all_reduce(lse, group, op=dist.ReduceOp.MAX)
    w = torch.exp(lse - m)
    packed = torch.cat([o.float() * w[..., None], w[..., None]], dim=-1)
    packed = all_reduce(packed, group)
    return (packed[..., :-1] / packed[..., -1:]).to(o.dtype)


def _window(kv_len, index: int, s_local: int, device) -> torch.Tensor:
    """This shard's valid length, a (1,) int32 tensor on ``device``."""
    if not isinstance(kv_len, torch.Tensor):
        kv_len = torch.tensor([kv_len], device=device)
    return (kv_len.reshape(1).to(device, torch.int64) - index * s_local
            ).clamp(0, s_local).to(torch.int32)


def _shard_attention(q, k, v, kv_len, index: int, group, use_kernel: bool):
    """Attention of q over this rank's block ``index`` of the sequence (k,
    v: (B, Hkv, S_local, hd)), merged over the group."""
    local_len = _window(kv_len, index, k.shape[2], q.device)
    o, lse = _local_decode(q, k, v, local_len, use_kernel)
    live = local_len > 0
    lse = torch.where(live, lse, -math.inf)
    o = torch.where(live[:, None, None], o, torch.zeros((), dtype=o.dtype,
                                                        device=o.device))
    return lse_combine(o, lse, group)


def context_parallel_decode(mesh, axis: str = "model", use_kernel: bool = False):
    """Returns fn(q (B, H, hd), k/v (B, Hkv, S_local, hd), kv_len) -> o:
    k and v are this rank's block of the sequence along ``axis``, q whole;
    ``kv_len`` is the *global* valid length (an int or a one-element
    tensor). With ``use_kernel`` a CUDA q goes through the decode kernel
    (return_lse), else the plain version."""
    group = mesh.group(axis)
    index = mesh.index(axis)

    def fn(q, k_shard, v_shard, kv_len):
        return _shard_attention(q, k_shard, v_shard, kv_len, index, group,
                                use_kernel)

    return fn


def decode_attention_cache_layout(mesh, q, cache_k, cache_v, kv_len,
                                  axis: str = "model", use_kernel: bool = True):
    """Context-parallel decode over the model's cache layout. q: (B, H, hd)
    (this rank's batch rows, all heads); cache_{k,v}: (B, S_local, Hkv, hd),
    this rank's block of the sequence, read in place (transposed views);
    kv_len: the global valid length (pos + 1). Returns o (B, H, hd)."""
    return context_parallel_decode(mesh, axis, use_kernel)(
        q, cache_k.transpose(1, 2), cache_v.transpose(1, 2), kv_len)
