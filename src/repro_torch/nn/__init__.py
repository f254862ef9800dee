"""Basic layers, GQA attention and the MoE FFN — twin of `repro.nn`."""

from repro_torch.nn.attention import (
    AttentionConfig,
    attention_apply,
    attention_decode,
    attention_init,
    rope,
)
from repro_torch.nn.layers import (
    Draw,
    dense_init,
    init_tree,
    gelu,
    layer_norm,
    linear,
    mlp_apply,
    mlp_plan,
    rms_norm,
    silu,
)
from repro_torch.nn.moe import MoEConfig, moe_apply, moe_init, moe_param_plan

__all__ = [
    "Draw",
    "init_tree",
    "dense_init",
    "linear",
    "rms_norm",
    "layer_norm",
    "mlp_plan",
    "mlp_apply",
    "gelu",
    "silu",
    "AttentionConfig",
    "attention_init",
    "attention_apply",
    "attention_decode",
    "rope",
    "MoEConfig",
    "moe_param_plan",
    "moe_init",
    "moe_apply",
]
