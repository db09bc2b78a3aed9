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
* ``gather_from_model(x, group, dim)``: all-gather along ``dim`` forward,
  the rank's block of the gradient backward. Where each rank's part (its
  heads' states, its slice of a weight) enters work every rank of
  ``group`` does whole, the whole tensor's gradient is the same on every
  rank, and the rank's block of it is its part's (an all-gather's usual
  reduce-scatter would count it once per rank). The sLSTM's states before
  its group norm; a weight whose cut the shard-local code cannot use.
* ``reduce_scatter_to_model(x, group, dim)``: reduce-scatter along ``dim``
  forward (partial sums completed, the rank's block kept), all-gather of
  the blocks' gradients backward. Where row-cut projections give partial
  sums of every column and each rank goes on with its own columns (the
  mLSTM's q, k, v and gates of its heads).

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


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.group.size
        return g.narrow(ctx.dim, ctx.group.index * n, n), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g.contiguous(), ctx.dim), None, None


def _trivial(group) -> bool:
    return group is None or group.size == 1


def fsdp_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if _trivial(group) else _Gather.apply(x, group, dim)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if _trivial(group) else _CopyTo.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def gather_from_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if _trivial(group) else _GatherFrom.apply(x, group, dim)


def reduce_scatter_to_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if _trivial(group) else _ReduceScatter.apply(x, group, dim)


# the logical width each mixer kind cuts over a model group
MIXER_AXES = {"attn": "heads", "mla": "heads", "mamba": "ssm_inner", "mlstm": "lstm_inner",
              "slstm": "lstm_inner"}


def cut_group(cfg, axis: str, group):
    """``group`` where the layer config ``cfg`` cuts the logical width
    ``axis`` over it; None where the group holds that width whole on every
    rank (``TPLayerConfig.tp_whole``): the part then runs whole, with no
    collective."""
    if group is None or axis in getattr(cfg, "tp_whole", ()):
        return None
    return group
