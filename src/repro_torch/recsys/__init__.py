"""Embedding lookups for the recommendation models — twin of `repro.recsys`."""
