"""Sharding: the mesh layout of tensor-parallel serving and the
logical-axis rules (``repro.sharding`` and ``repro.launch.specs.mode_rules``)."""
from repro_torch.sharding.config import ShardingConfig  # noqa: F401
from repro_torch.sharding.rules import (DEFAULT_RULES, Rules,  # noqa: F401
                                        current_rules, mode_rules, serving_tp_rules,
                                        use_rules)
