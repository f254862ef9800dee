"""Models: the paper's GCN and DeepFM."""
