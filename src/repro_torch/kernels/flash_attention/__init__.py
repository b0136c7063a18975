from .ops import (flash_attention, flash_attention_bwd,
                  flash_attention_bwd_dkv, flash_attention_bwd_dq,
                  flash_attention_fwd_lse, flash_attention_train)
from .ref import (flash_attention_bwd_ref, flash_attention_fwd_lse_ref,
                  flash_attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_bwd_ref", "flash_attention_fwd_lse",
           "flash_attention_fwd_lse_ref", "flash_attention_ref",
           "flash_attention_train"]
