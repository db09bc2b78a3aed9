"""Assigned input shapes (public pool): a copy of ``repro.configs.shapes``.

Decode shapes build a decode step (one new token against a cache of
``seq_len`` tokens, ``launch/steps.py``), not a train step. ``long_500k``
is meant for the configs with ``long_context_ok`` (starcoder2-3b,
llama4-scout, jamba, xlstm): one sequence of 524 288 tokens, its KV cache
cut over the batch axes (context parallelism) or held as a ring over the
sliding window.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown input shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]
