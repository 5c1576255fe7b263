"""solve_ms.dist: ``solve_ms`` of the cells across chips, a metric of its
own because the ranks' host loops spread it 10-15% from run to run against
the one-card cells' 2% (PERF.md section 2), so it carries its own bound."""

from pathlib import Path

from benchmark.core.cells import load_reader

read = load_reader(Path(__file__).resolve().parents[2], "solve_ms")
