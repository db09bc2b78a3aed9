"""Logical-axis -> mesh-axis sharding rules (survey §IV.C).

The port of ``repro.sharding.rules`` and of ``repro.launch.specs.mode_rules``.
Parameters carry *logical* axis names (``models.model.param_axes``); a
``Rules`` object binds those names to mesh axes for a mesh of given axis
sizes, dropping a mapping whenever the dimension is not divisible by the
mesh-axis extent (e.g. 8 KV heads on a 16-way model axis -> replicated KV).
A partition spec is a tuple with one entry per dimension: a mesh axis name,
a tuple of them, or None (replicated). ``Rules.options`` are the
reference's execution-variant switches: "sharded_moe" (``models/moe.py``:
dispatch per batch shard) and "onehot_ce" (``train/loop.py``: the label
logit by a masked sum). A rank's training plan (``train/sharding.py``)
hands its rules' options to the model and the loss itself; without a mesh
``use_rules`` binds them for a block, per thread, and the loss reads them
through ``current_rules()``.

The reference's ``shard_map`` has no counterpart: it runs a function on
each device's shard of a global array, and here each rank is a process
that already runs shard-local code on its own tensors, with the
collectives written out (``sharding/collectives.py``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

# logical axis -> preferred mesh axes (in order; tuples mean "shard over both")
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,  # training/prefill sequence stays unsharded by default
    "kv_seq": "data",  # context-parallel decode
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "moe_ff": None,
    "experts": "model",
    "ssm_inner": "model",
    "lstm_inner": "model",
    "audio_ctx": None,
    "layers": None,  # stacked-scan leading axis
    "conv": None,
    "state": None,
    "rank": None,  # MLA lora ranks stay replicated
}

PSpec = Tuple[Optional[object], ...]

_local = threading.local()


def current_rules() -> Optional["Rules"]:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional["Rules"]):
    prev = getattr(_local, "rules", None)
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


class Rules:
    """``mesh_shape``: mesh axis name -> size (``Mesh.shape``). ``options``:
    execution-variant switches consulted by model code (``opt``)."""

    def __init__(self, mesh_shape: Mapping[str, int], mapping: Optional[dict] = None,
                 options: Optional[dict] = None):
        self.mesh_shape = dict(mesh_shape)
        self.mapping = dict(DEFAULT_RULES)
        if mapping:
            self.mapping.update(mapping)
        self.options = dict(options or {})

    def opt(self, name: str, default=False):
        return self.options.get(name, default)

    def _mesh_axes_for(self, logical: Optional[str], dim: int):
        if logical is None:
            return None
        target = self.mapping.get(logical)
        if target is None:
            return None
        axes = (target,) if isinstance(target, str) else tuple(target)
        axes = tuple(a for a in axes if a in self.mesh_shape)
        # drop trailing axes until divisible
        while axes:
            if dim % math.prod(self.mesh_shape[a] for a in axes) == 0:
                break
            axes = axes[:-1]
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    def pspec(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> PSpec:
        if len(axes) != len(shape):
            raise ValueError(f"axes {tuple(axes)} do not match shape {tuple(shape)}")
        used: set = set()
        parts = []
        for logical, dim in zip(axes, shape):
            m = self._mesh_axes_for(logical, dim)
            # a mesh axis may be used at most once per pspec
            if m is not None:
                flat = (m,) if isinstance(m, str) else m
                if any(a in used for a in flat):
                    m = None
                else:
                    used.update(flat)
            parts.append(m)
        return tuple(parts)


def serving_tp_rules(mesh_shape: Mapping[str, int], *, kv_sharded: bool,
                     ff_sharded: bool) -> Rules:
    """Rules for the sharded paged serving path.

    Unlike ``DEFAULT_RULES`` this binds ONLY the tensor-parallel axes the
    sharded runner decided to split — heads always, KV heads and the MLP
    hidden axis only when the runner found them divisible. The decisions
    are made ONCE by the runner and forced through the mapping rather than
    left to the per-leaf divisibility fallback: the fallback decides leaf
    by leaf, and a GLU ``w1`` (2*d_ff columns, divisible) paired with a
    non-divisible ``w2`` (d_ff rows, replicated) would produce local
    shapes no single local model config can describe. Everything else —
    vocab, embed, LoRA ranks — stays replicated: serving batches are small,
    and the post-projection all-reduce is the only collective the hot path
    pays."""
    mapping = {name: None for name in DEFAULT_RULES}
    mapping.update({
        "heads": "model",
        "kv_heads": "model" if kv_sharded else None,
        "ff": "model" if ff_sharded else None,
    })
    return Rules(mesh_shape, mapping)


def mode_rules(mesh_shape: Mapping[str, int], kind: str, global_batch: int,
               options: Optional[dict] = None) -> Rules:
    """Sharding rules per execution mode (a copy of
    ``repro.launch.specs.mode_rules``): under "train" the weights' "embed"
    dims shard over data (ZeRO-3-style FSDP) and the batch over (pod,
    data); a decode of one sequence shards the KV sequence over (pod, data)
    (context parallelism) instead of the batch."""
    overrides: Dict[str, Any] = {}
    if kind == "train":
        overrides["embed"] = "data"
    if kind == "decode" and global_batch == 1:
        overrides["batch"] = None
        overrides["kv_seq"] = ("pod", "data")
    else:
        overrides["kv_seq"] = None
    return Rules(mesh_shape, overrides, options)
