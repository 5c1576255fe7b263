"""device.idle_pct.amg: ``device.idle_pct`` in the AMG cells. Every cell that a
per-layer metric lists reports the end-to-end metric it moves, and these
report ``solve_ms.amg`` (their own bound) in place of ``solve_ms``."""

from pathlib import Path

from benchmark.core.cells import load_reader

read = load_reader(Path(__file__).resolve().parents[2], "device.idle_pct")
