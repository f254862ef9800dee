"""graphcast [arXiv:2212.12794; unverified] — 16L d_hidden=512
mesh_refinement=6 aggregator=sum n_vars=227 (encoder-processor-decoder).
Twin of `repro.configs.graphcast`."""
from repro_torch.configs.registry import ArchSpec, ShapeSpec, gnn_shapes
from repro_torch.models.graphcast import GraphCastConfig


def make_config(shape: ShapeSpec | None = None) -> GraphCastConfig:
    d_in = shape.d_feat if shape is not None else None
    return GraphCastConfig(n_layers=16, d_hidden=512, n_vars=227, mesh_refinement=6, d_in=d_in)


SPEC = ArchSpec(
    arch_id="graphcast",
    family="gnn",
    source="arXiv:2212.12794",
    make_config=make_config,
    make_reduced=lambda: GraphCastConfig(n_layers=2, d_hidden=32, n_vars=12, mesh_refinement=1, d_in=8),
    shapes=gnn_shapes(),
)
