"""One rank's plan of the sharded train step (the port of the reference's
training under ``mode_rules(mesh, "train", batch)``).

The reference jits its train step over a mesh and lets XLA's partitioner
place the collectives. Here every rank is a process (``launch/mesh.py``)
that holds its slices of the parameters and of AdamW's moments
(``core/executor/sharded.py::train_slicer``) and its rows of the batch,
and ``TrainSharding`` tells the model and the step where the collectives
go:

* FSDP (ZeRO-3) over the data axis: every leaf cut by the rules' "embed"
  over data is gathered where it is used (``gather``: a layer's inside its
  checkpoint), and its gradient is reduce-scattered by the gather's
  backward pass (``sharding/collectives.py::fsdp_gather``).
* Tensor parallelism over the model axis (Megatron's identity /
  all-reduce pair, ``tp``): attention heads, MLP hidden units, experts
  (expert parallelism) and, where it divides, the vocabulary
  (``vocab_tp``: the vocab-parallel embedding and loss). Under a model
  axis above 1 the attention stacks with an MLP or a MoE train (olmo-1b,
  gemma-2b, qwen2.5-32b, starcoder2-3b, llama4-scout); MLA, Mamba, xLSTM,
  whisper and internvl raise ``NotImplementedError``. On a model axis of 1
  every family trains: the model code sees whole leaves.
* The batch over (pod, data) (``batch``): each rank's loss is the global
  loss (its sums completed over the batch group), and each gradient leaf
  not cut over a batch axis is all-reduced over it after the backward
  pass (``reduce_grads``); leaves replicated over the model axis already
  agree there.

``norm_sq`` gives the global gradient norm from the slices, each
replicated copy counted once; ``unshard`` assembles the whole tree (the
permutations undone) for a checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.executor.sharded import (_glu_leaf, glu_order, tp_layout, train_params,
                                               train_slicer)
from repro_torch.launch.mesh import BATCH_AXES
from repro_torch.models.model import param_axes, param_shapes
from repro_torch.sharding.collectives import fsdp_gather
from repro_torch.sharding.rules import mode_rules


def _parts(part):
    """The mesh axes one pspec entry names."""
    return () if part is None else ((part,) if isinstance(part, str) else tuple(part))


def _map2(fn, tree, specs, path=()):
    """``fn(leaf, spec, path)`` over a tree and its pspec tree (``specs`` may
    hold more keys than ``tree``)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k], path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(fn, v, s, path + (str(i),))
                for i, (v, s) in enumerate(zip(tree, specs, strict=True))]
    return fn(tree, specs, path)


def _pairs(tree, specs, path=()):
    """(leaf, spec, path) over a tree and its pspec tree, in leaf order."""
    out = []
    _map2(lambda t, spec, p: out.append((t, spec, p)), tree, specs, path)
    return out


def tp_train_supported(cfg: ModelConfig) -> bool:
    """Whether tensor parallelism covers this stack in training: attention
    layers (global, sliding-window, chunked) with an MLP or a MoE, no
    encoder, image splice or multi-token head."""
    return (cfg.family not in ("audio", "vlm") and not cfg.mtp_depth
            and all(s.mixer == "attn" and s.ff in ("mlp", "moe") for s in cfg.layer_specs()))


class TrainSharding:
    """One rank's plan of the train step on ``mesh`` (``launch.mesh.Mesh``)
    for ``cfg`` at ``global_batch`` rows. ``options``: the rules' options
    ("sharded_moe", "onehot_ce"), which the model and the loss read from
    ``self.rules``. ``layer_cfg``: the config a layer runs with (under a
    model group, ``tp_ff_sharded``: an MLP's hidden units are the rank's).
    ``device``: where the rank's tensors live (the mesh's device by
    default)."""

    def __init__(self, cfg: ModelConfig, mesh, global_batch: int,
                 options: Optional[dict] = None, device=None, max_seq: int = 0):
        self.cfg, self.mesh = cfg, mesh
        self.device = mesh.device if device is None else torch.device(device)
        self.rules = mode_rules(mesh.shape, "train", global_batch, options)
        self.batch = mesh.batch
        if global_batch % self.batch.size:
            raise ValueError(f"a global batch of {global_batch} rows does not split over "
                             f"the {self.batch.size} batch shards of the mesh {mesh.shape}")
        self.local_batch = global_batch // self.batch.size
        mp = mesh.shape.get("model", 1)
        self.tp = mesh.model if mp > 1 else None
        self.layer_cfg = dataclasses.replace(cfg, tp_ff_sharded=True) if mp > 1 else cfg
        self.axes = param_axes(cfg)
        shapes = param_shapes(cfg, max_seq)
        self.specs = _map2(lambda shape, axes, _: self.rules.pspec(axes, shape), shapes,
                           self.axes)
        self.shapes = shapes
        if mp > 1:
            self._check_tp(mp)
        vocab = self.specs["embed"][0]
        self.vocab_tp = self.tp if "model" in _parts(vocab) else None
        for _, spec, path in _pairs(self.specs, self.specs):
            if any("data" in _parts(p) and len(_parts(p)) > 1 for p in spec):
                raise NotImplementedError(f"{'/'.join(path)}: a leaf cut over data and "
                                          "another axis in one dimension")

    def _check_tp(self, mp: int) -> None:
        cfg = self.cfg
        if not tp_train_supported(cfg):
            kinds = sorted({s.mixer for s in cfg.layer_specs()} | (
                {cfg.family} if cfg.family in ("audio", "vlm") else set())
                | ({"mtp"} if cfg.mtp_depth else set()))
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}: {', '.join(kinds)}): tensor-parallel training "
                "covers attention stacks with an MLP or a MoE; train it on a model axis of 1 "
                "(FSDP over data)")
        tp_layout(cfg, mp)  # raises where the heads do not split
        widths = {"d_ff": cfg.d_ff} if any(s.ff == "mlp" for s in cfg.layer_specs()) else {}
        if any(s.ff == "moe" for s in cfg.layer_specs()):
            widths["num_experts"] = cfg.num_experts
            if cfg.num_shared_experts:
                widths["shared expert width"] = cfg.moe_d_ff * cfg.num_shared_experts
        bad = {k: v for k, v in widths.items() if v % mp}
        if bad:
            raise ValueError(f"{cfg.name}: {bad} do not divide the model axis ({mp})")

    # ---- parameters -------------------------------------------------------
    def params(self, model, seed: int = 0, max_seq: int = 0):
        """``model.init(seed)``'s values as this rank's slices, each layer
        cut as soon as it is drawn (``train_params``)."""
        return train_params(model, seed, mesh=self.mesh, rules=self.rules, max_seq=max_seq,
                            device=self.device)

    def shard(self, params):
        """This rank's slices of a whole tree (a checkpoint, converted weights)."""
        return train_slicer(self.cfg, self.mesh, self.rules, self.device)(params, self.axes)

    def gather(self, tree, specs):
        """The tree with every slice cut over data gathered over the data
        group (``fsdp_gather``): what the model code runs on."""
        data = self.mesh.axis("data")

        def leaf(t, spec, _):
            for dim, part in enumerate(spec):
                if "data" in _parts(part):
                    t = fsdp_gather(t, data, dim)
            return t
        return _map2(leaf, tree, specs)

    def rows(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a global batch: the batch shards in rank
        order over (pod, data)."""
        i, n = self.batch.index, self.local_batch
        return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}

    # ---- gradients --------------------------------------------------------
    def reduce_grads(self, grads):
        """Each gradient slice summed over the batch axes it is not cut
        over (a leaf cut over data was reduce-scattered over data by its
        gather; it is replicated over pod)."""
        groups = {a: self.mesh.axis(a) for a in BATCH_AXES if a in self.mesh.shape}

        def leaf(g, spec, _):
            used = {a for p in spec for a in _parts(p)}
            over = tuple(a for a in groups if a not in used)
            if not over:
                return g
            group = self.batch if len(over) == len(groups) else groups[over[0]]
            if len(over) not in (1, len(groups)):
                raise NotImplementedError(f"a gradient replicated over {over}")
            return group.all_reduce(g)
        return _map2(leaf, grads, self.specs)

    def norm_sq(self, tree) -> torch.Tensor:
        """The squared global f32 norm of a sharded tree: each rank sums the
        squares of its slices, counting a leaf only where it is the first of
        its copies (index 0 along every axis its spec does not cut), then
        one all-reduce over the world."""
        coords = self.mesh.coords()
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for t, spec, _ in _pairs(tree, self.specs):
            used = {a for p in spec for a in _parts(p)}
            if all(coords[a] == 0 for a in self.mesh.shape if a not in used):
                total = total + torch.sum(torch.square(t.float()))
        return self.mesh.world.all_reduce(total)

    # ---- whole trees ------------------------------------------------------
    def unshard(self, tree):
        """The whole tree from every rank's slices (the GQA and GLU orders
        undone), on the host: every rank takes part and gets it."""
        mp = self.mesh.shape.get("model", 1)
        head_order = tp_layout(self.cfg, mp).head_order if mp > 1 else None

        def leaf(t, spec, path):
            axes = tree_at(self.axes, path)
            for dim, part in enumerate(spec):
                for a in reversed(_parts(part)):
                    t = self.mesh.axis(a).all_gather(t.contiguous(), dim)
                if "model" in _parts(part) and mp > 1:
                    if axes[dim] == "heads" and head_order is not None:
                        t = t.index_select(dim, _inverse(head_order, t.device))
                    if axes[dim] == "ff" and _glu_leaf(self.cfg, path):
                        t = t.index_select(dim, _inverse(glu_order(t.shape[dim], mp),
                                                         t.device))
            return t.detach().cpu()
        return _map2(leaf, tree, self.specs)

    def unshard_shapes(self, tree):
        """Meta tensors of the whole tree's shapes in the slices' dtypes."""
        return _map2(lambda t, shape, _: torch.empty(shape, dtype=t.dtype, device="meta"),
                     tree, self.shapes)


def tree_at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _inverse(order: np.ndarray, device) -> torch.Tensor:
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return torch.from_numpy(inv).to(device)
