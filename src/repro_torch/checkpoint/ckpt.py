"""Flat-npz checkpoints of parameter and optimizer trees (the twin of
``repro.checkpoint.ckpt``).

Each leaf is stored under its ``/``-joined path in the port's tree
(``repro_torch/tree.py``: ``layers/3/mixer/wq/w``), and the step under
``__step__``. numpy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf
is stored as its 2-byte bit patterns (uint16) and its path listed in
``__bf16__``: a restore is bit-exact, and the file holds the tree's bytes,
no f32 copy. ``load_checkpoint`` restores into the structure of ``like``,
casting each leaf to ``like``'s dtype and placing it on ``device`` (on the
card by default): the reference's "load into the layout you will serve
in" (survey §V.A).

Under the sharded train step (``shard``: a rank's ``TrainSharding``) every
rank calls both: ``save_checkpoint`` gathers the rank's slices into the
whole tree (the GQA head and GLU column orders undone) and rank 0 writes
it in the same format, as the reference's save of a jit-sharded tree
writes the whole tree; ``load_checkpoint`` reads the whole tree and cuts
the rank's slices again (``train_slicer``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import resolve_device
from repro_torch.tree import tree_paths, tree_unflatten

BF16_KEY = "__bf16__"
STEP_KEY = "__step__"


def save_checkpoint(path: str, tree, step: Optional[int] = None, shard=None) -> None:
    if shard is not None:
        tree = shard.unshard(tree)
        if shard.mesh.rank != 0:
            return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat, bf16 = {}, []
    for key, leaf in tree_paths(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            bf16.append(key)
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    flat[BF16_KEY] = np.asarray(bf16, dtype=str)
    if step is not None:
        flat[STEP_KEY] = np.asarray(step)
    np.savez(path, **flat)


def load_checkpoint(path: str, like, device="cuda", shard=None):
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors included, whose shapes must match). Returns (tree, step or
    None); raises KeyError for a leaf the file does not hold. With
    ``shard``, ``like`` is the rank's slices: the whole tree is read on the
    host and cut to them on ``shard.device``."""
    if shard is not None:
        whole, step = load_checkpoint(path, shard.unshard_shapes(like), "cpu")
        got = shard.shard(whole)
        for (key, a), (_, b) in zip(tree_paths(got), tree_paths(like)):
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ValueError(f"checkpoint {key}: slice {tuple(a.shape)} {a.dtype}, want "
                                 f"{tuple(b.shape)} {b.dtype}")
        return got, step
    dev = resolve_device(device)
    with np.load(path) as data:
        bf16 = set(data[BF16_KEY].tolist()) if BF16_KEY in data.files else set()
        step = int(data[STEP_KEY]) if STEP_KEY in data.files else None
        out = []
        for key, leaf in tree_paths(like):
            if key not in data.files:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if key in bf16 \
                else torch.from_numpy(arr)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {key}: shape {tuple(t.shape)}, "
                                 f"want {tuple(leaf.shape)}")
            out.append(t.to(device=dev, dtype=leaf.dtype))
    return tree_unflatten(like, out), step
