"""What a measured window hands the end-to-end metric readers. A request or
step that raises ends the run with an error, so every one the window
started is completed and none failed."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Window:
    kind: str                    # "request" or "step"
    seconds: float               # the window's length on the host clock
    latencies: list[float]       # seconds of each completed request or step

    @property
    def completed(self) -> int:
        return len(self.latencies)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile of the latencies, seconds."""
        ordered = sorted(self.latencies)
        return ordered[min(len(ordered), max(1, math.ceil(p / 100.0 * len(ordered)))) - 1]
