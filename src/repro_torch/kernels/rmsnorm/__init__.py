from .ops import fused_rmsnorm
from .ref import fused_rmsnorm_ref

__all__ = ["fused_rmsnorm", "fused_rmsnorm_ref"]
