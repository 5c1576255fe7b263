"""solve_ms.amg: ``solve_ms`` of the AMG cells, a metric of its own because
its host-launched V-cycle spreads it about twice as widely from run to run
as the CG cell's fused loop (PERF.md section 2), so it carries its own
bound."""

from pathlib import Path

from benchmark.core.cells import load_reader

read = load_reader(Path(__file__).resolve().parents[2], "solve_ms")
