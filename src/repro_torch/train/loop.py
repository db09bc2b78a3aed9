"""Training step: cross-entropy, the MoE aux loss and DeepSeek-V3's MTP
loss, global-norm clipping, AdamW (the twin of ``repro.train.loop``).

Gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves (``Model.forward`` under autograd); a leaf the loss does not reach
(a sigmoid router's selection bias, which steers only the top-k) gets a
zero gradient, as ``jax.grad`` gives it. The cross-entropy picks the label
logit by a gather, the form the reference runs without sharding rules, or
under the "onehot_ce" rules option (``sharding.rules.use_rules``, or a
rank's plan's rules) by the reference's masked sum. No hand-written kernel
runs in a train step.

Every function takes an optional ``shard``: one rank's plan of the sharded
train step (``train/sharding.py``). The parameters and optimizer state are
then the rank's slices and the batch its rows; the loss and metrics are
the global batch's on every rank (vocab-parallel over the model group where
the logits are cut, sums completed over the batch group), and the
gradients and AdamW's update are the rank's slices.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.sharding.collectives import reduce_from_model
from repro_torch.sharding.rules import current_rules
from repro_torch.tree import tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: int


def cross_entropy(logits, labels, mask=None, *, vocab=None, batch=None, onehot=None):
    """logits: (B, S, V), labels: (B, S). The f32 negative log-likelihood,
    averaged over ``mask`` (every position without one). Under the
    "onehot_ce" rules option (``onehot``; None reads the rules bound by
    ``use_rules``) the label logit is the reference's iota-compare masked
    sum (a gather over a vocab-sharded axis would make XLA gather the
    logits), else a gather.

    ``vocab``: the model group when the logits are its rank's (B, S, V_l)
    block, rank i's vocab rows [i * V_l, (i + 1) * V_l): the vocab-parallel
    loss, whose max and sum of exponentials are all-reduced over it, and
    whose label logit is a masked sum, all-reduced. ``batch``: the batch
    group when the rows are this rank's shard: the masked sum of the
    shard's terms is completed over it, and the mean's denominator is the
    global ``mask.sum()`` (a mean of the shards' means differs whenever
    their masks do)."""
    logits = logits.float()
    if vocab is None or vocab.size == 1:
        lse = torch.logsumexp(logits, dim=-1)
        if onehot is None:
            rules = current_rules()
            onehot = rules is not None and rules.opt("onehot_ce")
        if onehot:
            iota = torch.arange(logits.shape[-1], device=logits.device)
            ll = torch.sum(torch.where(iota == labels.long()[..., None], logits, 0.0), dim=-1)
        else:
            ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        rows = logits.shape[-1]
        top = vocab.all_reduce(logits.detach().amax(dim=-1), op="max")
        total = reduce_from_model(torch.sum(torch.exp(logits - top[..., None]), dim=-1), vocab)
        lse = top + torch.log(total)
        iota = torch.arange(rows, device=logits.device) + vocab.index * rows
        ll = reduce_from_model(
            torch.sum(torch.where(iota == labels.long()[..., None], logits, 0.0), dim=-1), vocab)
    nll = lse - ll
    mask = torch.ones_like(nll) if mask is None else mask.float()
    num = torch.sum(nll * mask)
    den = mask.sum()
    if batch is not None and batch.size > 1:
        num = reduce_from_model(num, batch)
        den = batch.all_reduce(den.detach().clone())
    return num / torch.clamp_min(den, 1.0)


def loss_fn(model, params, batch, *, mtp_coef: float = 0.3, shard=None):
    """(total loss, metrics ``ce`` [, ``moe_aux``] [, ``mtp``], ``loss``).
    A VLM's logits cover [image rows, text]; only the text has labels."""
    cfg = model.cfg
    logits, aux = model.forward(params, batch, shard)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if cfg.family == "vlm":
        logits = logits[:, cfg.num_image_tokens:]
    groups = {} if shard is None else dict(vocab=shard.vocab_tp, batch=shard.batch,
                                           onehot=shard.rules.opt("onehot_ce"))
    loss = cross_entropy(logits, labels, mask, **groups)
    metrics = {"ce": loss}
    total = loss
    if cfg.num_experts and cfg.router_aux_coef:
        total = total + cfg.router_aux_coef * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
    if "mtp_logits" in aux:
        # MTP (depth 1): logits at t predict token t + 2
        mtp = cross_entropy(aux["mtp_logits"], labels[:, 1:],
                            None if mask is None else mask[:, 1:], **groups)
        total = total + mtp_coef * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = total
    return total, metrics


def grads_of(model, params, batch, shard=None):
    """(gradient tree of ``loss_fn`` over ``params``, zeros where the loss
    does not reach a leaf; detached metrics). With ``shard``, the rank's
    gradient slices: the FSDP slices were reduce-scattered by their
    gathers' backward pass, the leaves replicated over a batch axis are
    all-reduced over it here (``TrainSharding.reduce_grads``), and the
    leaves replicated over the model axis are whole and equal there: each
    was used whole on every rank, or entered the rank's part (the mLSTM's
    ``head_norm``, the sLSTM's ``r``, MLA's latents) through
    ``copy_to_model``, whose backward summed it over the model group."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(model, tree_unflatten(params, leaves), batch, shard=shard)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)])
    if shard is not None:
        grads = shard.reduce_grads(grads)
    return grads, {k: torch.as_tensor(v).detach() for k, v in metrics.items()}


def make_train_step(model, *, base_lr=3e-4, warmup_steps=100, total_steps=10_000,
                    max_grad_norm=1.0, weight_decay=0.1, shard=None) -> Callable:
    """``train_step(state, batch) -> (new state, metrics)``: the metrics of
    ``loss_fn`` plus ``grad_norm`` (before clipping) and ``lr``, 0-d
    tensors. ``batch``: tensors on the model's device (``labels`` (B, S)
    beside ``Model.forward``'s inputs). The state is not written. With
    ``shard`` the state holds the rank's slices and the batch its rows; the
    metrics are the global step's, the same on every rank."""
    def train_step(state: TrainState, batch):
        grads, metrics = grads_of(model, state.params, batch, shard)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, shard)
        lr = cosine_schedule(state.step, base_lr=base_lr, warmup_steps=warmup_steps,
                             total_steps=total_steps)
        new_params, new_opt = adamw_update(state.params, grads, state.opt, lr=lr,
                                           weight_decay=weight_decay)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def init_train_state(model, seed: int = 0, max_seq: int = 0, shard=None) -> TrainState:
    """Seed ``seed``'s weights and zero moments; with ``shard`` the rank's
    slices of both (the moments take the parameters' slices)."""
    params = model.init(seed, max_seq=max_seq) if shard is None \
        else shard.params(model, seed, max_seq)
    return TrainState(params, adamw_init(params), 0)
