"""Serving-time mesh configuration (tensor-parallel paged serving).

A copy of ``repro.sharding.config``. The serving mesh is ``(data,
model)``; in the port each point of it is one process, a rank of
``torch.distributed`` (``launch/mesh.py``):

* ``model`` — Megatron-style tensor parallelism over attention heads (and
  the MLP hidden axis when divisible). KV page stores are partitioned by
  head along this axis, so per-rank page bytes — and therefore resident
  KV capacity at a fixed per-device memory budget — scale with its size.
* ``data`` — replication: every model group serves the same batch.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Mesh layout for the sharded paged backend.

    ``model_axis * data_axis`` is the number of ranks the engine runs on
    (the world size of the process group). ``model_axis == 1`` with
    ``data_axis == 1`` is the single-device layout —
    ``EngineConfig.sharding = None`` is equivalent and skips the sharded
    runner entirely.
    """
    model_axis: int = 1  # tensor-parallel shards (heads / KV / ff / LoRA)
    data_axis: int = 1   # replicas; batch stays replicated across it

    def __post_init__(self):
        if self.model_axis < 1 or self.data_axis < 1:
            raise ValueError(
                f"mesh axes must be >= 1, got model_axis={self.model_axis} "
                f"data_axis={self.data_axis}")

    @property
    def num_devices(self) -> int:
        return self.model_axis * self.data_axis
