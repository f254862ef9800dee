"""granite-34b [arXiv:2405.04324; hf]
88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 — llama-arch, code.
Twin of `repro.configs.granite_34b`.
"""
from repro_torch.configs.registry import ArchSpec, lm_shapes
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="granite-34b",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab=49_152,
)

REDUCED = LMConfig(
    name="granite-34b-reduced",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=1,
    d_ff=256,
    vocab=512,
)

SPEC = ArchSpec(
    arch_id="granite-34b",
    family="lm",
    source="arXiv:2405.04324",
    make_config=lambda shape=None: FULL,
    make_reduced=lambda: REDUCED,
    shapes=lm_shapes(sub_quadratic=FULL.sub_quadratic),
)
