"""coin_gcn — the paper's own model: 2-layer Kipf–Welling GCN with the COIN
feature-extraction-first dataflow and 4-bit quantization (§V-B), on the
Table I datasets. Twin of `repro.configs.coin_gcn`."""
from repro_torch.configs.registry import ArchSpec, ShapeSpec
from repro_torch.core.quant import QuantConfig
from repro_torch.graph.generators import TABLE_I
from repro_torch.models.gcn import GCNConfig


def make_config(shape: ShapeSpec | None = None, dataset: str = "cora", hidden: int = 16) -> GCNConfig:
    if shape is not None:
        dims = (shape.d_feat, hidden, shape.n_out)
    else:
        spec = TABLE_I[dataset]
        dims = (spec.n_features, spec.hidden, spec.n_labels)
    return GCNConfig(layer_dims=dims, dataflow="auto", quant=QuantConfig(4, 4, enabled=True))


_SHAPES = {
    name: ShapeSpec(
        name,
        "graph",
        n_nodes=spec.n_nodes,
        n_edges=spec.n_edges,
        d_feat=spec.n_features,
        n_out=spec.n_labels,
    )
    for name, spec in TABLE_I.items()
}

SPEC = ArchSpec(
    arch_id="coin_gcn",
    family="gnn",
    source="arXiv:1609.02907 + the reproduced paper",
    make_config=make_config,
    make_reduced=lambda: GCNConfig(layer_dims=(64, 16, 7), quant=QuantConfig(4, 4, enabled=True)),
    shapes=_SHAPES,
)
