"""router.host_ms.amg: ``router.host_ms`` in the AMG cells, which report
``solve_ms.amg`` (their own bound) in place of ``solve_ms``."""

from pathlib import Path

from benchmark.core.cells import load_reader

read = load_reader(Path(__file__).resolve().parents[2], "router.host_ms")
