"""gemma3-12b [hf:google/gemma-3-1b-pt; unverified]
48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 — 5:1 local:global
sliding-window attention (window 1024), 128k context. The 5:1 pattern makes
this the one assigned LM arch eligible for the long_500k cell (DESIGN.md §4).
Twin of `repro.configs.gemma3_12b`.
"""
from repro_torch.configs.registry import ArchSpec, lm_shapes
from repro_torch.models.transformer_lm import LMConfig

FULL = LMConfig(
    name="gemma3-12b",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15_360,
    vocab=262_144,
    window=1024,
    global_every=6,          # layers 6, 12, … are global → 5 local : 1 global
    rope_theta=1_000_000.0,
)

REDUCED = LMConfig(
    name="gemma3-12b-reduced",
    n_layers=6,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    window=8,
    global_every=6,
)

SPEC = ArchSpec(
    arch_id="gemma3-12b",
    family="lm",
    source="hf:google/gemma-3-1b-pt",
    make_config=lambda shape=None: FULL,
    make_reduced=lambda: REDUCED,
    shapes=lm_shapes(sub_quadratic=FULL.sub_quadratic),
)
