"""Basic layers — twin of `repro.nn`."""
