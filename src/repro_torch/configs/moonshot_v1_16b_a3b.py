"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf]
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
Twin of `repro.configs.moonshot_v1_16b_a3b`. At 27.72 B fp32 parameters
(110.9 GB) it does not fit one card; it waits for the sharded LM.
"""
from repro_torch.configs.registry import ArchSpec, lm_shapes
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163_840,
    moe_experts=64,
    moe_top_k=6,
)

REDUCED = LMConfig(
    name="moonshot-v1-16b-a3b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=48,
    vocab=512,
    moe_experts=8,
    moe_top_k=2,
)

SPEC = ArchSpec(
    arch_id="moonshot-v1-16b-a3b",
    family="lm",
    source="hf:moonshotai/Moonlight-16B-A3B",
    make_config=lambda shape=None: FULL,
    make_reduced=lambda: REDUCED,
    shapes=lm_shapes(sub_quadratic=FULL.sub_quadratic),
)
