"""Models: the paper's GCN, the GNN families (PNA, EGNN, GraphCast,
EquiformerV2), DeepFM and the decoder-only LM (dense and MoE)."""

from repro_torch.models.egnn import EGNNConfig, egnn_forward, egnn_init, egnn_loss
from repro_torch.models.equiformer_v2 import (
    EquiformerV2Config,
    equiformer_forward,
    equiformer_init,
    equiformer_loss,
)
from repro_torch.models.gcn import GCNConfig, gcn_forward, gcn_init, gcn_loss
from repro_torch.models.graphcast import (
    GraphCastConfig,
    graphcast_forward,
    graphcast_init,
    graphcast_loss,
    icosphere_sizes,
)
from repro_torch.models.pna import PNAConfig, pna_forward, pna_init, pna_loss
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
    "PNAConfig",
    "pna_init",
    "pna_forward",
    "pna_loss",
    "EGNNConfig",
    "egnn_init",
    "egnn_forward",
    "egnn_loss",
    "GraphCastConfig",
    "graphcast_init",
    "graphcast_forward",
    "graphcast_loss",
    "icosphere_sizes",
    "EquiformerV2Config",
    "equiformer_init",
    "equiformer_forward",
    "equiformer_loss",
    "LMConfig",
    "lm_init",
    "lm_forward",
    "lm_loss",
    "lm_prefill",
    "lm_decode_step",
    "lm_init_cache",
]
