"""pna [arXiv:2004.05718; paper] — 4L d_hidden=75, aggregators
mean-max-min-std, scalers id-amp-atten. Twin of `repro.configs.pna`."""
from repro_torch.configs.registry import ArchSpec, ShapeSpec, gnn_shapes
from repro_torch.models.pna import PNAConfig


def make_config(shape: ShapeSpec | None = None) -> PNAConfig:
    d_in = shape.d_feat if shape is not None else 16
    n_out = shape.n_out if shape is not None else 1
    return PNAConfig(n_layers=4, d_hidden=75, d_in=d_in, d_out=n_out)


SPEC = ArchSpec(
    arch_id="pna",
    family="gnn",
    source="arXiv:2004.05718",
    make_config=make_config,
    make_reduced=lambda: PNAConfig(n_layers=2, d_hidden=24, d_in=8, d_out=3),
    shapes=gnn_shapes(),
)
