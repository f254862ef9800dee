"""Graph substrate: host-side containers and blocking, synthetic Table I datasets, segment ops, the fanout sampler."""
