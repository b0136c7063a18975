"""Single-device training of the port (the reference's ``train/``)."""
from .checkpoint import CheckpointManager
from .data import MemmapTokens, SyntheticTokens
from .fault import Heartbeat, StragglerMonitor, retry_step
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        cosine_schedule, global_norm)
from .trainer import make_train_step, train_loop

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
    "global_norm", "make_train_step",
    "train_loop", "CheckpointManager", "SyntheticTokens", "MemmapTokens",
    "Heartbeat", "StragglerMonitor", "retry_step",
]
