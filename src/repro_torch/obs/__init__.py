"""repro_torch.obs — runtime observability: metrics registry + span tracing
(twins of `repro.obs.metrics` and `repro.obs.trace`)."""
from repro_torch.obs import metrics, trace

__all__ = ["metrics", "trace"]
