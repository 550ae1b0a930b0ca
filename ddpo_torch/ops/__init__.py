from ddpo_torch.ops.attention import (
    attention,
    attention_lse_reference,
    attention_reference,
    flash_attention_fwd,
)
from ddpo_torch.ops.conv import conv3x3
from ddpo_torch.ops.groupnorm import (
    group_norm,
    group_norm_silu,
    group_stats,
    group_stats_reference,
)

__all__ = [
    "attention",
    "attention_lse_reference",
    "attention_reference",
    "flash_attention_fwd",
    "conv3x3",
    "group_norm",
    "group_norm_silu",
    "group_stats",
    "group_stats_reference",
]
