"""``build_step``: (arch config, input shape, mesh) -> one rank's step.

The port of ``repro.launch.steps.build_step``. The reference returns a
``Lowerable`` (a step function, ``ShapeDtypeStruct`` arguments and the
in/out shardings that XLA lowers); here each rank is a process
(``launch/mesh.py``), so a ``Step`` is the rank's step function, the
whole batch's input shapes (meta tensors, ``launch/specs.py``) and what
the rank needs to build its own arguments: its rows of a batch, its block
of the cache, its parameters. There is no lowering.

* ``train``: ``train.loop.grads_of`` under the rank's ``TrainSharding``
  (FSDP over data, tensor and expert parallelism over model for every
  family at any model axis that divides its widths, the batch over (pod,
  data)): ``fn(params, batch) -> (loss, grads)``.
* ``prefill``: ``Model.extend`` of the rank's rows from an empty cache of
  ``seq_len`` slots, with the family's extras: ``fn(params, tokens, cache,
  cache_len, extras) -> (logits, cache)``; an internvl row's image rows
  are spliced over placeholder tokens ahead of its text (the port's
  ``splice_vision``).
* ``decode``: ``Model.decode`` of the rank's rows over a cache of
  ``seq_len + DECODE_PAD`` slots: ``fn(params, tokens, cache, cache_len)
  -> (logits, cache)``. Under the "window_ring" option a window layer's
  cache is a ring; under "cp_decode" with the rules' "kv_seq" on mesh axes
  (``mode_rules`` of one sequence: (pod, data)) each attention cache and
  each MLA layer's latents are the rank's slice of the sequence and
  ``Model.decode`` takes the group over those axes as ``cp`` (on a model
  axis above 1 as well: heads over model, the sequence over data). Without
  "cp_decode" a rank holds its cache's sequence whole (the reference's XLA
  would gather a cut one each step).

Rules come from ``mode_rules(mesh.shape, kind, global_batch)`` with
``rules_overrides`` and ``options`` on top, as in the reference. On a
model axis above 1 a prefill or decode step is tensor-parallel at any
width (``core/executor/sharded.py::StepSharding``): the reference's
divisibility rule decides each width once (``tp_layout``: a width that
does not divide the axis is whole on every rank, which runs that part
whole), the rank holds its slices of the parameters (``Step.params``) and
its block of the cache (the KV heads, Mamba's channels and the xLSTM's
states cut as the layers cut them, ``specs.tp_cache_axes``), the layers
all-reduce over the model group after each cut part, and the step returns
the rank's vocab block of the logits where the vocab is cut (the
reference's out sharding ("batch", None, "vocab")); with the rules'
"experts" on (data, model) a MoE's experts are cut over both
(``moe.moe_apply``'s ``ep_data``). Tensor-parallel paged serving runs
through the engine (``core/executor/sharded.py::ShardedPagedRunner``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core.executor.sharded import StepSharding, rank_block
from repro_torch.launch.mesh import BATCH_AXES
from repro_torch.launch.specs import (DECODE_PAD, _parts, batch_axes, cache_axes_tree,
                                      rank_cache, shard_cache, token_inputs, tp_cache_axes)
from repro_torch.models.model import Model, build_model
from repro_torch.sharding.rules import Rules, mode_rules, use_rules
from repro_torch.train.loop import grads_of
from repro_torch.train.sharding import TrainSharding


@dataclasses.dataclass
class Step:
    """One rank's step of ``kind`` ("train", "prefill", "decode").
    ``fn``: the step; ``inputs``: the whole batch's model inputs (meta
    tensors, ``token_inputs``) and their logical axes ``input_axes``;
    ``max_seq``: the cache's slots (prefill, decode); ``cache_axes``: the
    axes of each layer's cache leaves; ``cp``: the group a context-parallel
    decode merges over; ``shard``: the rank's training plan (train);
    ``init_max_seq``: the learned positions' rows ``params`` draws
    (``seq_len + DECODE_PAD`` where the config has learned positions, as
    the reference's ``build_step`` asks; 0: the config's own count);
    ``sharding``: the rank's tensor-parallel plan of a prefill or decode
    step on a model axis above 1 (``StepSharding``), else None."""
    kind: str
    model: Model
    mesh: Any
    rules: Rules
    fn: Callable
    inputs: Dict[str, torch.Tensor]
    input_axes: Dict[str, tuple]
    max_seq: int = 0
    window_ring: bool = False
    cache_axes: Optional[List[Dict[str, tuple]]] = None
    cp: Any = None
    shard: Optional[TrainSharding] = None
    init_max_seq: int = 0
    sharding: Optional[StepSharding] = None

    @property
    def global_batch(self) -> int:
        return self.inputs["tokens"].shape[0]

    def rows(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a whole batch, each input cut by
        ``rules.pspec`` of its axes (a train step's by its plan)."""
        if self.shard is not None:
            return self.shard.rows(batch)
        coords = self.mesh.coords()
        out = {}
        for k, t in batch.items():
            spec = self.rules.pspec(self.input_axes.get(k, ("batch",) + (None,) * (t.ndim - 1)),
                                    tuple(t.shape))
            out[k] = rank_block(t, 0, _parts(spec[0]), self.mesh.shape, coords)
        return out

    def params(self, seed: int = 0):
        """The rank's parameters from ``model.init(seed)``: its slices for
        a train step or a tensor-parallel step, the whole tree otherwise (a
        model axis of 1)."""
        if self.shard is not None:
            return self.shard.params(self.model, seed, self.init_max_seq)
        if self.sharding is not None:
            return self.sharding.params(self.model, seed, self.init_max_seq)
        return self.model.init(seed, self.init_max_seq)

    def shard_params(self, params):
        """The rank's slices of a whole tree (converted weights): the tree
        itself on a model axis of 1."""
        if self.shard is not None:
            return self.shard.shard(params)
        if self.sharding is not None:
            return self.sharding.shard(params)
        return params

    def init_cache(self, fill=None) -> list:
        """This rank's block of the step's empty cache, made layer by layer
        (``specs.rank_cache``; ``fill(i, layer)`` writes each whole layer
        first)."""
        return rank_cache(self.model, self.global_batch, self.max_seq, self.mesh, self.rules,
                          window_ring=self.window_ring, fill=fill, axes=self.cache_axes)

    def shard_cache(self, cache: list) -> list:
        """This rank's block of a whole cache of the step's shape."""
        return shard_cache(self.model, cache, self.mesh, self.rules, self.cache_axes)


def _cp_group(mesh, rules: Rules):
    """The group a context-parallel decode merges over: the mesh axes the
    rules' "kv_seq" names (of size above 1), as one group; None where
    there are none."""
    target = rules.mapping.get("kv_seq")
    axes = tuple(a for a in _parts(target) if mesh.shape.get(a, 1) > 1)
    if not axes:
        return None
    present = tuple(a for a in BATCH_AXES if mesh.shape.get(a, 1) > 1)
    if set(axes) == set(present):
        return mesh.batch
    if len(axes) == 1:
        return mesh.axis(axes[0])
    raise NotImplementedError(f"kv_seq over {axes}: a group over part of the batch axes")


def build_step(cfg: ModelConfig, shape: InputShape, mesh,
               rules_overrides: Optional[dict] = None,
               options: Optional[dict] = None) -> Step:
    """One rank's ``Step`` of ``cfg`` at ``shape`` on ``mesh``
    (``launch/mesh.py``: ``make_mesh``, or ``make_local_mesh`` for one
    process); the model runs on the mesh's device (``cuda`` unless the
    mesh was made for the CPU)."""
    model = build_model(cfg, device=mesh.device)
    B, S = shape.global_batch, shape.seq_len
    inputs = token_inputs(cfg, shape)
    axes = batch_axes(cfg, inputs)
    max_seq_for_init = S + DECODE_PAD if cfg.learned_positions else 0

    if shape.kind == "train":
        if rules_overrides:
            raise ValueError("a train step takes the train rules of its plan (TrainSharding)")
        shard = TrainSharding(cfg, mesh, B, options, max_seq=max_seq_for_init)

        def train_fn(params, batch):
            grads, metrics = grads_of(model, params, batch, shard)
            return metrics["loss"], grads

        return Step("train", model, mesh, shard.rules, train_fn, inputs, axes, shard=shard,
                    init_max_seq=max_seq_for_init)

    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"unknown step kind {shape.kind!r}")
    rules = mode_rules(mesh.shape, shape.kind, B, options)
    if rules_overrides:
        rules.mapping.update(rules_overrides)
    ring = bool(rules.opt("window_ring"))
    cp = None
    if shape.kind == "decode":
        cp = _cp_group(mesh, rules) if rules.opt("cp_decode") else None
        if cp is None:
            rules.mapping["kv_seq"] = None  # each rank holds the sequence whole
    sharding = None
    if mesh.shape.get("model", 1) > 1:
        sharding = StepSharding(cfg, mesh, rules, B, max_seq_for_init)
        rules = sharding.rules

    def tp_axes(cache_axes):
        return tp_cache_axes(model, cache_axes) if sharding is not None else cache_axes

    if shape.kind == "prefill":
        cache_axes = tp_axes(cache_axes_tree(model, B, S)[0])

        def prefill_fn(params, tokens, cache, cache_len, extras=None):
            extras = extras or {}
            if cfg.family == "vlm" and "vision_embeds" in extras:
                # the image rows take positions [0, N) over placeholder tokens
                N = extras["vision_embeds"].shape[1]
                tokens = torch.cat([tokens.new_zeros((tokens.shape[0], N)), tokens], dim=1)
            with use_rules(rules):
                return model.extend(params, tokens, cache, cache_len, batch=extras or None,
                                    shard=sharding)

        return Step("prefill", model, mesh, rules, prefill_fn, inputs, axes, max_seq=S,
                    cache_axes=cache_axes, init_max_seq=max_seq_for_init, sharding=sharding)

    max_seq = S + DECODE_PAD
    cache_axes = tp_axes(cache_axes_tree(model, B, max_seq, window_ring=ring)[0])

    def decode_fn(params, tokens, cache, cache_len):
        with use_rules(rules):
            return model.decode(params, tokens, cache, cache_len, cp=cp, shard=sharding)

    return Step("decode", model, mesh, rules, decode_fn, inputs, axes, max_seq=max_seq,
                window_ring=ring, cache_axes=cache_axes, cp=cp, init_max_seq=max_seq_for_init,
                sharding=sharding)
