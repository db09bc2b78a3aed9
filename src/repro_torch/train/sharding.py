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
  all-reduce pair, ``tp``), for every family the reference trains:
  attention heads (self-attention, whisper's encoder and
  cross-attention), MLA heads (the low-rank down-projections, their norms
  and the shared rope key whole on every rank), MLP hidden units, experts
  (expert parallelism), Mamba's and the mLSTM's inner channels, the
  mLSTM's and the sLSTM's heads, and, where it divides, the vocabulary
  (``vocab_tp``: the vocab-parallel embedding, head and loss, the MTP
  head's too). A width that does not divide the model axis is whole on
  every rank, which runs that part whole with no all-reduce after it (the
  reference's divisibility rule, ``tp_layout``; its ``rules`` force those
  axes off). ``layer_cfg`` is the config a layer runs with: the rank's
  ``num_heads``, ``tp_ff_sharded`` and the widths held whole
  (``TPLayerConfig.tp_whole``). A leaf whose axis
  holds pieces side by side takes an order first (``model_order``) so a
  rank holds its share of each piece; where a piece does not split over
  the ranks (the sLSTM's ``ffn_up`` at 2 x 341 columns on 2 ranks, its
  ``ffn_down`` whole) the leaf is cut contiguously and gathered over the
  model group where it is used (``gather_from_model``), and its gradient
  is the rank's block of the whole one, which every rank of the group
  computes alike (a reduce-scatter would count it once per rank). On a
  model axis of 1 the model code sees whole leaves.
* The batch over (pod, data) (``batch``): each rank's loss is the global
  loss (its sums completed over the batch group), and each gradient leaf
  not cut over a batch axis is all-reduced over it after the backward
  pass (``reduce_grads``). A leaf replicated over the model axis that a
  rank uses only in part (the mLSTM's ``head_norm`` and ``w_if`` bias on
  its heads, the sLSTM's ``r`` blocks of its heads) enters through
  ``copy_to_model``, whose backward sums its gradient over the model
  group; so every leaf's gradient is complete when the backward pass ends,
  and the model-replicated ones agree over the model axis.

``norm_sq`` gives the global gradient norm from the slices, each
replicated copy counted once; ``unshard`` assembles the whole tree (the
orders undone) for a checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.executor.sharded import model_order, tp_layout, train_params, train_slicer
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


class TrainSharding:
    """One rank's plan of the train step on ``mesh`` (``launch.mesh.Mesh``)
    for ``cfg`` at ``global_batch`` rows. ``options``: the rules' options
    ("sharded_moe", "onehot_ce"), which the model and the loss read from
    ``self.rules``. ``layer_cfg``: the config a layer runs with (under a
    model group the rank's ``num_heads``, and ``tp_ff_sharded``: an MLP's
    hidden units are the rank's).
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
        self.layout = tp_layout(cfg, mp)
        self.rules = self.layout.rules(self.rules)
        self.layer_cfg = self.layout.layer_cfg
        self.axes = param_axes(cfg)
        shapes = param_shapes(cfg, max_seq)
        self.specs = _map2(lambda shape, axes, _: self.rules.pspec(axes, shape), shapes,
                           self.axes)
        self.shapes = shapes
        vocab = self.specs["embed"][0]
        self.vocab_tp = self.tp if "model" in _parts(vocab) else None
        for _, spec, path in _pairs(self.specs, self.specs):
            if any("data" in _parts(p) and len(_parts(p)) > 1 for p in spec):
                raise NotImplementedError(f"{'/'.join(path)}: a leaf cut over data and "
                                          "another axis in one dimension")

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
        gather; it is replicated over pod). Nothing is summed over the
        model axis here: a leaf replicated there was used whole on every
        rank, or entered the rank's part through ``copy_to_model``, whose
        backward summed its gradient over the model group already."""
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
        """The whole tree from every rank's slices (the head orders and the
        orders of pieces side by side undone, ``model_order``), on the
        host: every rank takes part and gets it."""
        mp = self.mesh.shape.get("model", 1)

        def leaf(t, spec, path):
            axes = tree_at(self.axes, path)
            for dim, part in enumerate(spec):
                for a in reversed(_parts(part)):
                    t = self.mesh.axis(a).all_gather(t.contiguous(), dim)
                if "model" in _parts(part) and mp > 1:
                    order = model_order(self.cfg, path, axes[dim], t.shape[dim], mp)
                    if order is not None:
                        t = t.index_select(dim, _inverse(order, t.device))
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
