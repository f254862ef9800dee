"""equiformer-v2 [arXiv:2306.12059; unverified] — 12L d_hidden=128 l_max=6
m_max=2 8 heads, SO(2)-eSCN convolutions. Twin of
`repro.configs.equiformer_v2`."""
from repro_torch.configs.registry import ArchSpec, ShapeSpec, gnn_shapes
from repro_torch.models.equiformer_v2 import EquiformerV2Config


def make_config(shape: ShapeSpec | None = None) -> EquiformerV2Config:
    d_in = shape.d_feat if shape is not None else 16
    n_out = shape.n_out if shape is not None else 1
    return EquiformerV2Config(
        n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8, d_in=d_in, d_out=n_out
    )


SPEC = ArchSpec(
    arch_id="equiformer-v2",
    family="gnn",
    source="arXiv:2306.12059",
    make_config=make_config,
    make_reduced=lambda: EquiformerV2Config(
        n_layers=2, d_hidden=16, l_max=2, m_max=1, n_heads=4, d_in=8, d_out=2
    ),
    shapes=gnn_shapes(),
)
