"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The harness puts ``bench`` and ``src`` on
the path itself, keeps every build and bytecode cache inside the checkout
(``.bench_cache/``; the nvcc build in ``src/repro_torch/kernels/build/``),
and exits non-zero, printing no result, without the CUDA cards the cell asks
for or where the run loaded JAX or the JAX package.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402

from benchlib.paths import setup_paths  # noqa: E402

setup_paths()

from benchlib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
