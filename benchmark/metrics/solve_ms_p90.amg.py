"""solve_ms_p90.amg: ``solve_ms_p90`` of the AMG cells, a metric of its
own so that it carries a bound of its own, set from the AMG cell's runs
(PERF.md section 2)."""

from pathlib import Path

from benchmark.core.cells import load_reader

read = load_reader(Path(__file__).resolve().parents[2], "solve_ms_p90")
