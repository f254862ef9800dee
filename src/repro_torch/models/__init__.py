"""Models: the paper's GCN."""
