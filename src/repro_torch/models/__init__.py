"""Models: the paper's GCN, DeepFM and the decoder-only LM (dense and MoE)."""

from repro_torch.models.gcn import GCNConfig, gcn_forward, gcn_init, gcn_loss
from repro_torch.models.transformer_lm import (
    LMConfig,
    lm_decode_step,
    lm_forward,
    lm_init,
    lm_init_cache,
    lm_loss,
    lm_prefill,
)

__all__ = [
    "GCNConfig",
    "gcn_init",
    "gcn_forward",
    "gcn_loss",
    "LMConfig",
    "lm_init",
    "lm_forward",
    "lm_loss",
    "lm_prefill",
    "lm_decode_step",
    "lm_init_cache",
]
