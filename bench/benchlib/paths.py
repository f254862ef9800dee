"""Where a run of the benchmark finds its code and keeps its caches."""
from __future__ import annotations

import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def setup_paths() -> None:
    """Put ``bench`` and ``src`` on the path, and keep the bytecode of every
    module imported from here on inside the checkout (``.bench_cache/``), so
    that only a checkout's first run compiles it, also where the environment
    turns bytecode off. The port's nvcc build lives in
    ``src/repro_torch/kernels/build/``, inside the checkout too."""
    sys.pycache_prefix = str(ROOT / ".bench_cache" / "pycache")
    sys.dont_write_bytecode = False
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
