"""Training step: cross-entropy, the MoE aux loss and DeepSeek-V3's MTP
loss, global-norm clipping, AdamW (the twin of ``repro.train.loop``).

Gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves (``Model.forward`` under autograd); a leaf the loss does not reach
(a sigmoid router's selection bias, which steers only the top-k) gets a
zero gradient, as ``jax.grad`` gives it. The cross-entropy picks the label
logit by a gather, the form the reference runs without sharding rules.
No hand-written kernel runs in a train step.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.tree import tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: int


def cross_entropy(logits, labels, mask=None):
    """logits: (B, S, V), labels: (B, S). The f32 negative log-likelihood,
    averaged over ``mask`` (every position without one)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)


def loss_fn(model, params, batch, *, mtp_coef: float = 0.3):
    """(total loss, metrics ``ce`` [, ``moe_aux``] [, ``mtp``], ``loss``).
    A VLM's logits cover [image rows, text]; only the text has labels."""
    cfg = model.cfg
    logits, aux = model.forward(params, batch)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if cfg.family == "vlm":
        logits = logits[:, cfg.num_image_tokens:]
    loss = cross_entropy(logits, labels, mask)
    metrics = {"ce": loss}
    total = loss
    if cfg.num_experts and cfg.router_aux_coef:
        total = total + cfg.router_aux_coef * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
    if "mtp_logits" in aux:
        # MTP (depth 1): logits at t predict token t + 2
        mtp = cross_entropy(aux["mtp_logits"], labels[:, 1:],
                            None if mask is None else mask[:, 1:])
        total = total + mtp_coef * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = total
    return total, metrics


def grads_of(model, params, batch):
    """(gradient tree of ``loss_fn`` over ``params``, zeros where the loss
    does not reach a leaf; detached metrics)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(model, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return tree_unflatten(params, grads), {k: torch.as_tensor(v).detach()
                                           for k, v in metrics.items()}


def make_train_step(model, *, base_lr=3e-4, warmup_steps=100, total_steps=10_000,
                    max_grad_norm=1.0, weight_decay=0.1) -> Callable:
    """``train_step(state, batch) -> (new state, metrics)``: the metrics of
    ``loss_fn`` plus ``grad_norm`` (before clipping) and ``lr``, 0-d
    tensors. ``batch``: tensors on the model's device (``labels`` (B, S)
    beside ``Model.forward``'s inputs). The state is not written."""
    def train_step(state: TrainState, batch):
        grads, metrics = grads_of(model, state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = cosine_schedule(state.step, base_lr=base_lr, warmup_steps=warmup_steps,
                             total_steps=total_steps)
        new_params, new_opt = adamw_update(state.params, grads, state.opt, lr=lr,
                                           weight_decay=weight_decay)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def init_train_state(model, seed: int = 0, max_seq: int = 0) -> TrainState:
    params = model.init(seed, max_seq=max_seq)
    return TrainState(params, adamw_init(params), 0)
