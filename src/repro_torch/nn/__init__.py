"""Basic layers, GQA attention and the MoE FFN — twin of `repro.nn`."""

from repro_torch.nn.attention import (
    AttentionConfig,
    attention_apply,
    attention_decode,
    attention_init,
    rope,
)
from repro_torch.nn.layers import (
    dense_init,
    gelu,
    layer_norm,
    linear,
    mlp_apply,
    mlp_init,
    rms_norm,
    silu,
)
from repro_torch.nn.moe import MoEConfig, moe_apply, moe_init

__all__ = [
    "dense_init",
    "linear",
    "rms_norm",
    "layer_norm",
    "mlp_init",
    "mlp_apply",
    "gelu",
    "silu",
    "AttentionConfig",
    "attention_init",
    "attention_apply",
    "attention_decode",
    "rope",
    "MoEConfig",
    "moe_init",
    "moe_apply",
]
