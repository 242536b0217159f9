"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations, traffic mixes and metrics are those of
``BENCHMARK.json`` at the root of the checkout. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``), then
``compared``, each number checked against the reference beside its limit;
the same numbers end standard error. Without a CUDA device, or with fewer
than the cell asks for, it exits 2 and prints no result.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from port_bench.harness import main

    sys.exit(main(t_start=T_START))
