"""Tensor-parallel serving: the mesh layout and the logical-axis rules
(the serving parts of ``repro.sharding``)."""
from repro_torch.sharding.config import ShardingConfig  # noqa: F401
from repro_torch.sharding.rules import (DEFAULT_RULES, Rules,  # noqa: F401
                                        serving_tp_rules)
