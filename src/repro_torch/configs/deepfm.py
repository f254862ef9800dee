"""deepfm [arXiv:1703.04247; paper] — n_sparse=39 embed_dim=10
mlp=400-400-400 interaction=fm. Twin of `repro.configs.deepfm`."""
from repro_torch.configs.registry import ArchSpec, recsys_shapes
from repro_torch.models.deepfm import DeepFMConfig

FULL = DeepFMConfig(
    n_fields=39,
    embed_dim=10,
    mlp_dims=(400, 400, 400),
    rows_per_field=1_000_000,   # 39M-row table: the hot sparse-lookup path
)

SPEC = ArchSpec(
    arch_id="deepfm",
    family="recsys",
    source="arXiv:1703.04247",
    make_config=lambda shape=None: FULL,
    make_reduced=lambda: DeepFMConfig(
        n_fields=8, embed_dim=10, mlp_dims=(32, 32, 32), rows_per_field=1000
    ),
    shapes=recsys_shapes(),
)
