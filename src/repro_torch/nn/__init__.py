"""Basic layers and GQA attention — twin of `repro.nn` (its MoE layer comes
with a later slice)."""

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
]
