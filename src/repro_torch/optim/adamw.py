"""AdamW (the twin of ``repro.optim.adamw``).

The optimizer state mirrors the parameter tree (``repro_torch/tree.py``):
first and second moments ``mu`` / ``nu`` in f32 whatever the parameter's
dtype, and the update ``count``, a 0-d int32 tensor on the parameters'
device. The update is decoupled weight decay added to the Adam step before
the learning rate, on every leaf (norms and biases included), as in the
reference. It runs per leaf in f32 under ``torch.no_grad()`` and returns
new trees; the inputs are not written.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, shard=None):
    """(grads scaled so that their global f32 norm is at most ``max_norm``,
    each in its own dtype; that norm before scaling, a 0-d f32 tensor).
    With ``shard`` (a rank's plan of the sharded train step) the grads are
    the rank's slices and the norm is the whole tree's: the squares of
    every rank's slices, each replicated copy counted once, all-reduced
    over the world (``TrainSharding.norm_sq``)."""
    if shard is not None:
        gnorm = torch.sqrt(shard.norm_sq(grads))
    else:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """One AdamW step. ``lr``: a float or a 0-d tensor. Returns (new
    params in their dtypes, new state)."""
    count = state["count"] + 1
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    def upd(p, g, mu, nu):
        g = g.float()
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        step = step + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), mu, nu

    out = [upd(*leaves) for leaves in zip(*(tree_leaves(t) for t in (
        params, grads, state["mu"], state["nu"])))]
    new_params, new_mu, new_nu = (tree_unflatten(params, [o[i] for o in out])
                                  for i in range(3))
    return new_params, {"mu": new_mu, "nu": new_nu, "count": count}
