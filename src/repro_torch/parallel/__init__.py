"""Multi-device execution of the port on ``torch.distributed``: the mesh
and its collectives (``dist``), logical-axis rules (``logical``), and the
reference's parallel schedules: compressed data-parallel gradients,
context-parallel decode, expert-parallel MoE and the GPipe pipeline."""
from .logical import (AxisRules, PartitionSpec, current_mesh, current_rules,
                      param_spec, shard, use_rules)

__all__ = ["AxisRules", "PartitionSpec", "current_mesh", "current_rules",
           "param_spec", "shard", "use_rules"]
