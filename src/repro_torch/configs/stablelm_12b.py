"""stablelm-12b [hf:stabilityai/stablelm-2-1_6b; hf]
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352. Twin of
`repro.configs.stablelm_12b`.
"""
from repro_torch.configs.registry import ArchSpec, lm_shapes
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13_824,
    vocab=100_352,
)

REDUCED = LMConfig(
    name="stablelm-12b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab=512,
)

SPEC = ArchSpec(
    arch_id="stablelm-12b",
    family="lm",
    source="hf:stabilityai/stablelm-2-1_6b",
    make_config=lambda shape=None: FULL,
    make_reduced=lambda: REDUCED,
    shapes=lm_shapes(sub_quadratic=FULL.sub_quadratic),
)
