"""egnn [arXiv:2102.09844; paper] — n_layers=4 d_hidden=64 E(n)
equivariance. Twin of `repro.configs.egnn`."""
from repro_torch.configs.registry import ArchSpec, ShapeSpec, gnn_shapes
from repro_torch.models.egnn import EGNNConfig


def make_config(shape: ShapeSpec | None = None) -> EGNNConfig:
    d_in = shape.d_feat if shape is not None else 16
    n_out = shape.n_out if shape is not None else 1
    return EGNNConfig(n_layers=4, d_hidden=64, d_in=d_in, d_out=n_out)


SPEC = ArchSpec(
    arch_id="egnn",
    family="gnn",
    source="arXiv:2102.09844",
    make_config=make_config,
    make_reduced=lambda: EGNNConfig(n_layers=2, d_hidden=16, d_in=8, d_out=2),
    shapes=gnn_shapes(),
)
