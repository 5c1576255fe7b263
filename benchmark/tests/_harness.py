"""Helpers of the benchmark's CPU tests: run the harness in a subprocess
and read its last line."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RUN = ROOT / "benchmark" / "run.py"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run_cell(workload: str, *extra, seed: int = 2147483701,
             seconds: float = 1.0, trace: int = 0, nx: int = 8,
             root: Path = ROOT, timeout: float = 240.0, env=None):
    """(exit code, last stdout line as a dict or None, stderr)."""
    cmd = [sys.executable, str(Path(root) / "benchmark" / "run.py"),
           "--workload", workload, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace), "--cpu-rehearsal", str(nx),
           *extra]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=root,
                          env=dict(os.environ, **(env or {})))
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return proc.returncode, last, proc.stderr


DIST_CELL = "hpcg256x4.dist_cg_f32"
DIST_ALIASED = ("solver.iterations", "kernel.cg_iter_roofline",
                "device.idle_pct")


def dist_checkout(tmp_path) -> Path:
    """A checkout whose BENCHMARK.json also holds the 4-chip cell, its
    configuration and its ``.dist`` metrics: the entries and the reader
    files a later change adds once that cell holds a bound (PERF.md
    section 7), over the files that are already in ``benchmark/``. The
    cell reports ``solve_ms.dist``, so its per-layer readings are
    ``.dist`` readers that move it."""
    root = Path(tmp_path) / "checkout4"
    root.mkdir()
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "tpu_sparse_torch").symlink_to(ROOT / "tpu_sparse_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "hpcg_256_weak4", "source": "HPCG 3.1 weak scaling",
        "file": "benchmark/configs/hpcg_256_weak4.json", "reduced": [],
        "why": "4 ranks"})
    bench["workloads"].append({"name": DIST_CELL, "config": "hpcg_256_weak4",
                               "traffic": "dist_cg_closed", "chips": 4,
                               "why": "4 ranks"})
    bench["end_to_end"].append({"name": "solve_ms.dist", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": [DIST_CELL]})
    metrics = root / "benchmark" / "metrics"
    for base in DIST_ALIASED:
        (metrics / f"{base}.dist.py").write_text(
            "from pathlib import Path\n"
            "from benchmark.core.cells import load_reader\n"
            "read = load_reader(Path(__file__).resolve().parents[2], "
            f"{base!r})\n")
    for name in [f"{b}.dist" for b in DIST_ALIASED] + ["dist.halo_ms"]:
        bench["per_layer"].append({
            "name": name, "unit": "x", "better": "lower",
            "source": "device_trace", "layer": "l", "moves": "solve_ms.dist",
            "workloads": [DIST_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
