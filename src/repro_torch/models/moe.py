"""Mixture-of-Experts feed-forward: routed experts plus shared experts.

The twin of ``repro.models.moe``: on one device and on a rank of the
training mesh (``moe_apply``'s ``tp`` / ``dp``: expert parallelism over
the model group with the reference's two dispatches, ``_routed_manual_ep``
under the "sharded_moe" rules option and the global ``_routed_dense``
without it). Routing
follows the source models: softmax top-k (llama4, Mixtral) or sigmoid top-k
with a selection bias and normalized weights (DeepSeek-V3); the router runs
in f32 whatever the model dtype. Dispatch is the reference's capacity-bounded
sort: a stable sort of the (token, slot) pairs by expert gives each pair its
position inside its expert, in token order, and a pair at or past the
expert's ``capacity`` is dropped. Below ``NO_DROP_THRESHOLD`` token-slots the
capacity is T * k, so nothing is dropped.

``moe_apply`` computes only the routed rows: one host read of the experts'
kept counts, then for each expert that holds tokens (on a mesh, each
local expert) one ``torch.matmul`` through ``w1`` and one through ``w2``
over its kept tokens, in dispatch order, scatter-added back to their
token rows with their routing weights (``index_add_`` in x's dtype, as the
reference's ``_combine``). The
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

from repro_torch.models.common import (dense, dense_axes, gated, is_glu, make_dense,
                                       normal_init)
from repro_torch.sharding.collectives import copy_to_model, reduce_from_model

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


def moe_param_axes(cfg):
    """The logical axes of ``make_moe_params``' leaves (the reference's):
    experts over "experts", the router's input over "embed", the shared
    experts as a dense MLP ("ff")."""
    p = {"router": {"w": ("embed", None)}, "w1": ("experts", "embed", "moe_ff"),
         "w2": ("experts", "moe_ff", "embed")}
    if cfg.moe_sigmoid_router:
        p["router_bias"] = (None,)
    if cfg.num_shared_experts:
        p["shared_w1"] = dense_axes(("embed", "ff"))
        p["shared_w2"] = dense_axes(("ff", "embed"))
    return p


def _top_k(scores, k):
    """(values, indices) of the k largest per row, the lower index first on
    ties (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, cfg, x_flat):
    """x_flat: (T, d) -> (weights (T, k) in x's dtype, experts (T, k) int32,
    the router's probabilities (T, E) f32)."""
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
    return w.to(x_flat.dtype), experts.to(torch.int32), probs


def _expert_counts(experts, E: int):
    """Pairs routed to each expert, f32 (E,); index_add_, not bincount: no
    host sync."""
    flat = experts.reshape(-1).long()
    return torch.zeros(E, device=experts.device).index_add_(
        0, flat, torch.ones(flat.shape, device=experts.device))


def route(p, cfg, x_flat):
    """x_flat: (T, d) -> (weights (T, k) in x's dtype, experts (T, k) int32,
    switch-style load-balance loss E * sum_e f_e * P_e, a scalar)."""
    w, experts, probs = _route(p, cfg, x_flat)
    E, k = cfg.num_experts, cfg.top_k
    f_e = _expert_counts(experts, E) / (x_flat.shape[0] * k)
    return w, experts, E * torch.sum(f_e * probs.mean(dim=0))


def positions_in_expert(flat_e):
    """flat_e: (N,) expert of each (token, slot) pair in token order -> each
    pair's position among its expert's pairs, in token order (a stable sort
    by expert)."""
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    run = torch.arange(flat_e.shape[0], device=flat_e.device) \
        - torch.searchsorted(sorted_e, sorted_e)
    pos = torch.empty_like(run)
    pos[order] = run
    return pos


def dispatch_indices(experts, E: int, capacity: int):
    """experts: (T, k) -> (slot_src (E * capacity,) int32: the flat (token * k
    + slot) index each expert slot holds, T * k where empty; keep (T, k)
    bool). The pairs sorted by expert, stably, so each expert's slots hold
    its pairs in token order and the pairs past its capacity are dropped."""
    T, k = experts.shape
    dev = experts.device
    flat_e = experts.reshape(-1).long()
    pos_in_expert = positions_in_expert(flat_e)
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


_SAME = object()  # shared_tp default: the experts' group


def _local_counts(key, E_l: int, cap: int, T: int, k: int, E: int, before: int = 0):
    """Pairs each local expert runs: the kept counts (one host read), or on
    the meta device, which holds no routing, a balanced routing capped at
    the capacity: each expert takes ceil(T * k / E) of these T tokens'
    pairs, after ``before`` shards' as many, and keeps those below ``cap``
    (the dry-run's assumption, ``launch/dryrun.py``)."""
    if key.device.type == "meta":
        n = -(-T * k // E)
        return [max(0, min(n, cap - before * n))] * E_l
    return torch.bincount(key, minlength=E_l + 1)[:E_l].tolist()


def moe_apply(p, cfg, x, *, capacity_factor: float = 1.25, tp=None, dp=None,
              sharded_moe: bool = False, shared_tp=_SAME, ep_data=None):
    """x: (B, S, d) -> (y (B, S, d), aux loss). Capacity is per expert over
    all B * S positions (padded ones included, as in the reference). Each
    expert's kept tokens go through its FFN in one matmul per weight, in
    token order, scatter-added back in expert order.

    On a rank of the training mesh ``dp`` is its batch group (x holds its
    batch shard's rows) and ``tp`` its model group: ``p`` holds the rank's
    experts ``[m E_l, (m + 1) E_l)`` (expert parallelism, index m) and its
    slice of the shared expert's hidden units, and one
    ``reduce_from_model`` over ``tp`` sums the ranks' partial outputs.
    Routing runs on every rank in full. Which pairs are kept follows the
    reference's two paths. With ``sharded_moe`` (the rules option;
    ``_routed_manual_ep``) capacity and positions come from this batch
    shard's tokens alone and the aux loss is the mean of the shards'
    (``pmean``): the single-device result of each shard on its own (a
    stable sort restricted to the local experts keeps every pair's
    position in its expert). Without it (the SPMD ``_routed_dense`` over
    the global batch) every shard's expert ids are all-gathered over
    ``dp`` (small: (T_l, k) int32), capacity is the global batch's and each
    pair's position counts the pairs of the shards before it in rank
    order, which is global token order; the aux loss takes the global
    expert counts and the router probabilities summed over ``dp``. On a
    mesh every local expert runs its matmuls, with no rows where it has no
    tokens, so each rank's graph (and the collectives of its backward
    pass) is the same whatever its tokens route to; on one device an
    expert without tokens is skipped.

    ``shared_tp``: the group the shared experts' hidden units are cut over
    (``tp`` unless given; None: whole on every rank, added after the
    routed experts' all-reduce). ``ep_data``: the data group where the
    experts are cut over (data, model) in one group (the rules' "experts"
    on both axes): rank (i, m) holds experts [(i * tp.size + m) E_l, ...),
    every row of the data group is gathered first (the routing, capacity
    and positions those of the gathered rows), the partial outputs are
    summed over ``tp`` and reduce-scattered back to each rank's rows over
    ``ep_data``."""
    if shared_tp is _SAME:
        shared_tp = tp
    rows, x_own = None, x
    if ep_data is not None and ep_data.size > 1:
        rows = x.shape[0]
        x = ep_data.all_gather(x.contiguous(), 0)
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    x_flat = x.reshape(T, d)
    weights, experts, probs = _route(p, cfg, x_flat)
    flat_e = experts.reshape(-1).long()
    shards = 1 if dp is None else dp.size
    if shards == 1 or sharded_moe:
        cap = capacity(T, k, E, capacity_factor)
        pos = positions_in_expert(flat_e)
        f_e = _expert_counts(experts, E) / (T * k)
        aux = reduce_from_model(E * torch.sum(f_e * probs.mean(dim=0)), dp) / shards
    else:
        every = dp.all_gather(experts, 0).reshape(-1).long()  # global token order
        Tg = shards * T
        cap = capacity(Tg, k, E, capacity_factor)
        pos = positions_in_expert(every)[dp.index * T * k:(dp.index + 1) * T * k]
        f_e = _expert_counts(every, E) / (Tg * k)
        aux = E * torch.sum(f_e * reduce_from_model(probs.sum(dim=0), dp) / Tg)
    E_l = p["w1"].shape[0]
    lo = 0 if tp is None else tp.index * E_l
    if rows is not None:
        lo += ep_data.index * (1 if tp is None else tp.size) * E_l
    local = (pos < cap) & (flat_e >= lo) & (flat_e < lo + E_l)
    key = torch.where(local, flat_e - lo, E_l)
    order = torch.sort(key, stable=True).indices  # each local expert's pairs in token order
    global_pos = shards > 1 and not sharded_moe
    counts = _local_counts(key, E_l, cap, T, k, E, dp.index if global_pos else 0)
    mesh = tp is not None or dp is not None or rows is not None
    xm = copy_to_model(x_flat, tp)
    w_flat = copy_to_model(weights, tp).reshape(T * k)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        src = order[start:start + n]
        start += n
        if not n and not mesh:
            continue
        tok = src // k
        ye = gated(cfg.activation, xm[tok] @ p["w1"][e]) @ p["w2"][e]
        y.index_add_(0, tok, ye * w_flat[src][:, None])
    ys = None
    if cfg.num_shared_experts:
        if shared_tp is tp and rows is None:
            xs = xm
        else:  # over another group, or whole, or (ep_data) the rank's rows alone
            xs = copy_to_model(x_own.reshape(-1, d), shared_tp)
        ys = gated(cfg.activation, dense(p["shared_w1"], xs)) @ p["shared_w2"]["w"]
        if xs is xm:
            y, ys = y + ys, None
    y = reduce_from_model(y, tp)
    if rows is not None:  # each rank keeps its rows of the data group's sum
        y = ep_data.reduce_scatter(y.reshape(B, S, d), 0).reshape(-1, d)
        B = rows
    if ys is not None:
        y = y + reduce_from_model(ys, shared_tp)
    if cfg.num_shared_experts and "b" in p["shared_w2"]:
        y = y + p["shared_w2"]["b"]
    return y.reshape(B, S, d), aux


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
