"""Command-line drivers (twins of `repro.launch`)."""
