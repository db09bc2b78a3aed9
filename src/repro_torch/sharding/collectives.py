"""The collectives of the sharded train step, as autograd functions.

The reference has no such module: XLA's SPMD partitioner inserts its
collectives from the sharding rules. Here each rank is a process running
shard-local code (``launch/mesh.py``), so the collectives are written out,
each with the one its gradient needs (Megatron-LM's pair and ZeRO-3's
gather):

* ``fsdp_gather(x, group, dim)``: the FSDP (ZeRO-3) gather of a weight
  cut over the data axis: all-gather along ``dim`` in the forward pass;
  the gradient's reduce-scatter (a sum) in the backward pass, so each rank
  gets its slice of the gradient summed over the group.
* ``copy_to_model(x, group)``: identity forward, all-reduce of the
  gradient backward. Where a tensor every rank of ``group`` holds whole
  (an activation, routing weights, replicated K/V) enters work that each
  rank does on its own part (its heads, hidden units, experts, vocab
  rows), each rank's gradient of it is partial, and the all-reduce
  completes it.
* ``reduce_from_model(x, group)``: all-reduce forward (each rank's partial
  sum completed, in place: x is a fresh partial sum), identity backward.
  The model group's after an output projection (training and the sharded
  paged serving path alike); the batch group's in the loss, where every
  rank then holds the global loss and its gradient is its own share.

A group of one rank (or None) makes each of them the identity. Every rank
of a group must issue the same collectives in the same order: callers make
the graph the same on every rank whatever the data (``models/moe.py``
touches every local expert).
"""
from __future__ import annotations

import torch


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _trivial(group) -> bool:
    return group is None or group.size == 1


def fsdp_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if _trivial(group) else _Gather.apply(x, group, dim)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if _trivial(group) else _CopyTo.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if _trivial(group) else _ReduceFrom.apply(x, group)
