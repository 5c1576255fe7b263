"""solve_ms_p90.amg: ``solve_ms_p90`` of the AMG cells, a metric of its
own because its host-launched V-cycle spreads its tail 5-6% from run to
run against the CG cell's 1% (PERF.md section 2), so it carries its own
bound."""

from pathlib import Path

from benchmark.core.cells import load_reader

read = load_reader(Path(__file__).resolve().parents[2], "solve_ms_p90")
