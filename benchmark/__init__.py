"""The port's benchmark: one cell of BENCHMARK.json per run, ``python -m benchmark.run``."""

import sys
import time

T0 = time.perf_counter()  # the process's start, as near as Python lets us: set-up counts from here


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)
