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


def checkout(root: Path) -> "tuple[Path, dict]":
    """A checkout at ``root`` with the benchmark's files (not its tests)
    and the program, and BENCHMARK.json as a dict to extend and write."""
    root.mkdir()
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "tpu_sparse_torch").symlink_to(ROOT / "tpu_sparse_torch")
    return root, json.loads((ROOT / "BENCHMARK.json").read_text())


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
    root, bench = checkout(Path(tmp_path) / "checkout4")
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


CONVDIFF_CONFIG = "convdiff27_256"
# cell -> (traffic mix, the mix's keyword arguments)
CONVDIFF_CELLS = {
    "convdiff256.bicgstab_f32": ("bicgstab_closed", {"method": "bicgstab"}),
    "convdiff256.gmres30_f32": ("gmres30_closed",
                                {"method": "gmres", "restart": 30}),
}
# the per-layer readings of the solver loop and the device, shared with the
# CG cells, that the two cells would report
CONVDIFF_PER_LAYER = ("solver.iterations", "solver.overshoot_pct",
                      "solver.host_syncs", "router.host_ms",
                      "device.idle_pct")


def convdiff_config() -> dict:
    """The nonsymmetric convection-diffusion deployment: HPCG's 27-point
    matrix at 256^3 with the x neighbours -(1 + beta) upwind and
    -(1 - beta) downwind, beta 0.3 (the port's
    ``convection_diffusion_3d_27pt(256, beta=0.3)``), float32 to 1e-6."""
    return {
        "name": CONVDIFF_CONFIG,
        "source": "the 27-point diffusion operator and the 256^3 local grid: "
                  "HPCG 3.1 (hpcg-benchmark.org; Heroux, Dongarra, "
                  "Luszczek, SAND2013-8752); the upwind convection along x "
                  "at beta 0.3 and the BiCGStab / GMRES(30) solves: the "
                  "reference library's own baseline (BASELINE.json "
                  "configs[1]) and its generator "
                  "tpu_sparse/sparse/generators.py::"
                  "convection_diffusion_3d_27pt",
        "problem": "27-point stencil on a 3-D grid: diagonal 26, the -x "
                   "neighbour -(1 + beta) = -1.3, the +x neighbour "
                   "-(1 - beta) = -0.7, the other 24 neighbours -1, "
                   "neighbours outside the grid dropped",
        "grid": [256, 256, 256],
        "process_grid": [1, 1, 1],
        "diagonal": 26.0,
        "neighbour": -1.0,
        "coefficients": {"-1,0,0": -1.3, "1,0,0": -0.7},
        "dtype": "float32",
        "tol": 1e-06,
        "maxiter": 1000,
        "chips": 1,
        "rhs": "b_j = A x_j, x_j standard normal on the card from the mix's "
               "fixed base_seed, each entry multiplied by a sign and a power "
               "of two in [1/4, 4] drawn from the seed: every seed sends the "
               "same work",
        "guarantee": {
            "stop": "the method's own residual test at tol * ||b|| "
                    "(relative residual 1e-6): BiCGStab's recurrence "
                    "residual, GMRES's true residual at each restart",
            "failures": "counted: a solve that reports no convergence, or "
                        "whose reference residual passes the cell's limit, "
                        "is failed",
            "checked": "the true relative residual of every solve kept for "
                       "the check, in float64 by the reference, at most the "
                       "cell's limit (benchmark/workloads); every solve "
                       "reports converged or is counted failed",
        },
        "assumed": [
            "dtype: float32 values and vectors, as the repo's north star "
            "sets the library's solves (BASELINE.json configs[4])",
            "beta 0.3, the port's convection_diffusion_3d_27pt default; the "
            "grid and the diffusion part are HPCG's",
            "rhs: b_j = A x_j with x_j drawn as the rhs line says, so that a "
            "stream of solves is not one repeated answer",
            "no preconditioner; maxiter 1000 (iterations for BiCGStab, "
            "restart cycles for GMRES, as the library counts them)",
        ],
        "reduced": [],
        "solve": "the library's own float32 solve to a relative residual of "
                 "1e-6 by BiCGStab or GMRES(30), as BASELINE.json configs[1] "
                 "names them; nothing is cut: one card holds the grid",
    }


def convdiff_checkout(tmp_path) -> Path:
    """A checkout whose BENCHMARK.json also holds the convection-diffusion
    configuration and its BiCGStab and GMRES(30) cells: the files a later
    change adds (PERF.md section 7), over the files that are already in
    ``benchmark/``, none of which it edits. The limits are the CG cell's
    until the card's readings set their own."""
    root, bench = checkout(Path(tmp_path) / "checkout_convdiff")
    b = root / "benchmark"
    (b / "configs" / f"{CONVDIFF_CONFIG}.json").write_text(
        json.dumps(convdiff_config(), indent=2))
    bench["configs"].append({
        "name": CONVDIFF_CONFIG,
        "source": "https://www.hpcg-benchmark.org (27-point diffusion, "
                  "256^3); upwind x convection at beta 0.3: BASELINE.json "
                  "configs[1], tpu_sparse/sparse/generators.py "
                  "convection_diffusion_3d_27pt",
        "file": f"benchmark/configs/{CONVDIFF_CONFIG}.json", "reduced": [],
        "why": "nonsymmetric 27-point convection-diffusion at a GPU run's "
               "local size: the BiCGStab and GMRES paths no HPCG cell runs"})
    for cell, (mix, kwargs) in CONVDIFF_CELLS.items():
        method = kwargs["method"]
        (b / "traffic" / f"{mix}.json").write_text(json.dumps({
            "entry": "solve", "kwargs": kwargs,
            "loop": "closed: one client sends the next request when x of "
                    "the last is back",
            "pool": 8, "rhs_columns": 1, "base_seed": 1, "refresh_every": 0,
            "warmup_solves": 2, "trace_solves": 8, "check_solves": 8,
            "iteration_reference": True}, indent=2))
        (b / "workloads" / f"{cell}.json").write_text(json.dumps({
            "limits": {"max_rel_residual": 2e-06, "iters_gap": 0.05},
            "why": f"256^3 convection-diffusion f32 {method} to 1e-6, "
                   "closed loop of one client over 8 fixed rhs that the "
                   "seed signs and scales"}, indent=2))
        bench["workloads"].append({
            "name": cell, "config": CONVDIFF_CONFIG, "traffic": mix,
            "chips": 1, "why": f"256^3 convection-diffusion f32 {method} "
                               "to 1e-6, one client, closed loop over 8 "
                               "rhs"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("solve_ms", "solve_ms_p90") + CONVDIFF_PER_LAYER:
            m["workloads"] += list(CONVDIFF_CELLS)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root
