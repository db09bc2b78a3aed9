"""Mixture-of-Experts feed-forward: routed experts plus shared experts.

The twin of ``repro.models.moe`` on one device (expert parallelism, the
reference's ``_routed_manual_ep``, comes with tensor parallelism). Routing
follows the source models: softmax top-k (llama4, Mixtral) or sigmoid top-k
with a selection bias and normalized weights (DeepSeek-V3); the router runs
in f32 whatever the model dtype. Dispatch is the reference's capacity-bounded
sort: a stable sort of the (token, slot) pairs by expert gives each pair its
position inside its expert, in token order, and a pair at or past the
expert's ``capacity`` is dropped. Below ``NO_DROP_THRESHOLD`` token-slots the
capacity is T * k, so nothing is dropped.

``moe_apply`` computes only the routed rows: one host read of the experts'
kept counts, then for each expert that holds tokens one ``torch.matmul``
through ``w1`` and one through ``w2`` over its kept tokens, in dispatch
order, scatter-added back to their token rows with their routing weights
(``index_add_`` in x's dtype, as the reference's ``_combine``). The
reference instead runs its einsum over every one of the E x capacity slots,
the empty ones reading zeros (E times the routed work below the threshold);
the gated activations map a zero row to a zero row, so both compute the same
function. ``moe_dense_ref`` keeps that literal dense dispatch as the oracle
the card checks ``moe_apply`` against; no serving path calls it.

Parameters mirror the reference's tree, so ``models/convert.py`` maps them
as they are: ``router.w`` (d, E) f32, ``router_bias`` (E,) f32 for sigmoid
routers, ``w1`` (E, d, 2f) for gated activations (else (E, d, f)), ``w2``
(E, f, d), and dense ``shared_w1`` / ``shared_w2`` with ``num_shared_experts``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import dense, gated, is_glu, make_dense, normal_init

NO_DROP_THRESHOLD = 8192  # token-slots; at or below it, capacity = T*k (no drops)


def make_moe_params(gen, cfg, dtype, device):
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    glu = is_glu(cfg.activation)
    p = {"router": {"w": normal_init(gen, (d, E), torch.float32, 1.0 / math.sqrt(d),
                                     device)},
         "w1": normal_init(gen, (E, d, 2 * f if glu else f), dtype, 1.0 / math.sqrt(d),
                           device),
         "w2": normal_init(gen, (E, f, d), dtype, 1.0 / math.sqrt(f), device)}
    if cfg.moe_sigmoid_router:
        p["router_bias"] = torch.zeros((E,), dtype=torch.float32, device=device)
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_w1"] = make_dense(gen, d, 2 * fs if glu else fs, dtype, device)
        p["shared_w2"] = make_dense(gen, fs, d, dtype, device)
    return p


def _top_k(scores, k):
    """(values, indices) of the k largest per row, the lower index first on
    ties (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, cfg, x_flat):
    """x_flat: (T, d) -> (weights (T, k) in x's dtype, experts (T, k) int32,
    switch-style load-balance loss, a scalar)."""
    logits = x_flat.float() @ p["router"]["w"].float()
    E, k = cfg.num_experts, cfg.top_k
    if cfg.moe_sigmoid_router:
        scores = torch.sigmoid(logits)
        # the bias steers the selection only; the weights are the scores
        _, experts = _top_k(scores + p["router_bias"][None, :], k)
        w = torch.gather(scores, -1, experts)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
        probs = scores / torch.clamp_min(scores.sum(-1, keepdim=True), 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, experts = _top_k(probs, k)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    T = x_flat.shape[0]
    flat = experts.reshape(-1)  # index_add_, not bincount: no host sync
    f_e = torch.zeros(E, device=x_flat.device).index_add_(
        0, flat, torch.ones(flat.shape, device=x_flat.device)) / (T * k)
    aux = E * torch.sum(f_e * probs.mean(dim=0))
    return w.to(x_flat.dtype), experts.to(torch.int32), aux


def dispatch_indices(experts, E: int, capacity: int):
    """experts: (T, k) -> (slot_src (E * capacity,) int32: the flat (token * k
    + slot) index each expert slot holds, T * k where empty; keep (T, k)
    bool). The pairs sorted by expert, stably, so each expert's slots hold
    its pairs in token order and the pairs past its capacity are dropped."""
    T, k = experts.shape
    dev = experts.device
    flat_e = experts.reshape(-1).long()
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    run = torch.arange(T * k, device=dev) - torch.searchsorted(sorted_e, sorted_e)
    pos_in_expert = torch.empty_like(run)
    pos_in_expert[order] = run
    keep = pos_in_expert < capacity
    dest = torch.where(keep, flat_e * capacity + pos_in_expert, E * capacity)
    slot_src = torch.full((E * capacity + 1,), T * k, dtype=torch.int32, device=dev)
    # dropped pairs all land on the extra slot, which is cut off
    slot_src[dest] = torch.arange(T * k, dtype=torch.int32, device=dev)
    return slot_src[:-1], keep.reshape(T, k)


def capacity(T: int, k: int, E: int, cf: float) -> int:
    if T * k <= NO_DROP_THRESHOLD:
        return T * k
    return max(1, int(math.ceil(T * k / E * cf)))


def _add_shared(p, cfg, x, y):
    if cfg.num_shared_experts:
        y = y + dense(p["shared_w2"], gated(cfg.activation, dense(p["shared_w1"], x)))
    return y


def moe_apply(p, cfg, x, *, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (y (B, S, d), aux loss). Capacity is per expert over
    all B * S positions (padded ones included, as in the reference). Each
    expert's kept tokens go through its FFN in one matmul per weight."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    x_flat = x.reshape(T, d)
    weights, experts, aux = route(p, cfg, x_flat)
    cap = capacity(T, k, E, capacity_factor)
    slot_src, keep = dispatch_indices(experts, E, cap)
    # the kept pairs of expert e fill its first min(count_e, cap) slots
    counts = torch.bincount(experts.reshape(-1), minlength=E).clamp_max(cap).tolist()
    w_flat = (weights * keep.to(weights.dtype)).reshape(T * k)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for e, n in enumerate(counts):
        if not n:
            continue
        src = slot_src[e * cap:e * cap + n].long()
        tok = src // k
        ye = gated(cfg.activation, x_flat[tok] @ p["w1"][e]) @ p["w2"][e]
        y.index_add_(0, tok, ye * w_flat[src][:, None])
    return _add_shared(p, cfg, x, y.reshape(B, S, d)), aux


def moe_dense_ref(p, cfg, x, *, capacity_factor: float = 1.25):
    """The reference's ``_routed_dense`` + ``_add_shared`` as they are: every
    expert slot, empty ones reading a zero row, through one einsum per
    weight over (E, capacity, d). The oracle of ``moe_apply``."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    x_flat = x.reshape(T, d)
    weights, experts, aux = route(p, cfg, x_flat)
    cap = capacity(T, k, E, capacity_factor)
    slot_src, keep = dispatch_indices(experts, E, cap)
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))], dim=0)
    src_tok = torch.clamp_max(slot_src.long() // k, T)  # empty slots read row T
    xe = x_pad[src_tok].reshape(E, cap, d)
    h = gated(cfg.activation, torch.einsum("ecd,edf->ecf", xe, p["w1"]))
    ye = torch.einsum("ecf,efd->ecd", h, p["w2"])
    # _combine: scatter-add the weighted slot rows back to their tokens
    w_flat = (weights * keep.to(weights.dtype)).reshape(T * k)
    slot_w = torch.cat([w_flat, w_flat.new_zeros((1,))])[
        torch.clamp_max(slot_src.long(), T * k)]
    y = torch.zeros((T + 1, d), dtype=ye.dtype, device=x.device)
    y.index_add_(0, src_tok, ye.reshape(-1, d) * slot_w[:, None])
    y = y[:T].reshape(B, S, d).to(x.dtype)
    return _add_shared(p, cfg, x, y), aux
