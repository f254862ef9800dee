"""Analytic core: graph partitioning, the COIN dataflow chooser, fake quantization."""
