"""olmoe-1b-7b [arXiv:2409.02060; hf]
16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304, MoE 64e top-8.
Twin of `repro.configs.olmoe_1b_7b`.
"""
from repro_torch.configs.registry import ArchSpec, lm_shapes
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50_304,
    moe_experts=64,
    moe_top_k=8,
)

REDUCED = LMConfig(
    name="olmoe-1b-7b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab=512,
    moe_experts=8,
    moe_top_k=2,
)

SPEC = ArchSpec(
    arch_id="olmoe-1b-7b",
    family="lm",
    source="arXiv:2409.02060",
    make_config=lambda shape=None: FULL,
    make_reduced=lambda: REDUCED,
    shapes=lm_shapes(sub_quadratic=FULL.sub_quadratic),
)
