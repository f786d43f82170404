"""The collectives of the multi-device paths, on `torch.distributed`.

The JAX package never names a collective: XLA inserts them from the
shardings (GSPMD) or from `psum` inside `shard_map`. Here every one is an
explicit call, and only `all_reduce`, `all_gather` and `broadcast` are used,
so that the same code runs on NCCL on the card, on gloo on the CPU, and on
gloo with several ranks on one card.

The two Megatron operators of a tensor-parallel block are autograd
functions: `copy_to_tp` (identity forward, all-reduce backward) in front of
the column-parallel projections, `reduce_from_tp` (all-reduce forward,
identity backward) after the row-parallel ones.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group:
    each rank's column shard sees only its part of the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """Sum of the ranks' partial products forward; identity backward (every
    rank's row shard needs the whole output gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, out of place, no gradient."""
    x = x.detach().contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The elementwise maximum over the group (x itself for no group)."""
    if group is None:
        return x
    x = x.detach().contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def global_sum_local_grad(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over the group whose value is the all-reduced sum and whose
    gradient is the local term's alone (JAX `_global_sum_local_grad`): the
    gradients summed over the group afterwards then give the gradient of the
    global value."""
    total = all_reduce_sum(x, group)
    return total + (x - x.detach())


def gather_rows(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor's rows from every rank of the group, concatenated in rank
    order, in one `all_gather`. The tensors travel packed as fp32 (token
    ids below 2^24 travel exactly) and come back in their own dtypes; every
    rank must pass the same shapes."""
    world = dist.get_world_size(group)
    packed = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    parts = [torch.empty_like(packed) for _ in range(world)]
    dist.all_gather(parts, packed, group=group)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        pieces = [p[at : at + n].reshape(t.shape) for p in parts]
        out.append(torch.cat(pieces, 0).to(t.dtype) if t.dim() else torch.stack(pieces).to(t.dtype))
        at += n
    return out


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The tensor's shards along `dim` from every rank, concatenated in rank
    order (a tp-sharded parameter or moment made whole)."""
    world = dist.get_world_size(group)
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)
