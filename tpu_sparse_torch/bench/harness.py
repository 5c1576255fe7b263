"""Benchmark harness with markdown / CSV reports.

Counterpart of ``tpu_sparse/bench/harness.py`` (the reference's
tests/benchmark.py): ``BenchmarkConfig`` (:68-81), ``BenchmarkResult``
(:54-65), ``run_single_benchmark`` (:149-273) with warm-up and timed
runs, the ``run_all_benchmarks`` sweep (:275-319), the markdown report
with system information, per-matrix tables and the fastest cell of each
size (:369-546), the CSV export (:350-367) and the command line
(:549-610).

Every cell solves the JAX harness's system: the same matrices (float64)
and the same b (``x_true`` from ``default_rng(0)``). A solve is timed on
the host clock and ends in ``torch.cuda.synchronize()``, so a time is
what the caller waits for (JAX's fence is ``block_until_ready``); the
median of ``runs`` is reported. ``memory_used_mb`` is the growth of
``torch.cuda.memory_allocated`` over the cell's solves (None on the
CPU). A cell that raises reports its error and the sweep goes on. The
report's "System" section names the device and its power limit as
``nvidia-smi`` prints them, so every time stands beside the card that
produced it.

Cells run on ``config.device``: the card unless the caller asks for the
CPU (``device="cpu"``, ``--device cpu``).
"""

from __future__ import annotations

import csv
import dataclasses
import datetime
import os
import platform
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class BenchmarkConfig:
    """Mirror of reference BenchmarkConfig (benchmark.py:68-81)."""

    sizes: Sequence[int] = (100, 200, 500)
    matrix_types: Sequence[str] = ("tridiagonal", "poisson2d", "dense_spd")
    backends: Sequence[str] = ("krylov", "amg", "direct")
    methods: Sequence[str] = ("cg", "bicgstab", "gmres")
    tol: float = 1e-8
    maxiter: int = 1000
    runs: int = 3
    warmup: int = 1
    precision: str = "full"  # 'full' (f64) | 'mixed'
    verbose: bool = True
    device: str = "cuda"


@dataclasses.dataclass
class BenchmarkResult:
    """Mirror of reference BenchmarkResult (benchmark.py:54-65)."""

    backend: str
    method: str
    matrix_type: str
    size: int
    solve_time_ms: float
    residual: float
    converged: bool
    iterations: Optional[int]
    memory_used_mb: Optional[float] = None
    error_message: str = ""


def _device_memory_mb(device: torch.device) -> Optional[float]:
    """Bytes the caching allocator holds for tensors on ``device``, in MB
    (the reference's ``_get_memory_usage_mb``, benchmark.py:142-146); None
    off the card."""
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / (1024.0 * 1024.0)


def device_peak_memory_mb(device="cuda") -> Optional[float]:
    """Peak bytes held for tensors on the card since the process started
    (or the last ``torch.cuda.reset_peak_memory_stats``), in MB; None
    without a card."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated(device) / (1024.0 * 1024.0)


def _create_matrix(matrix_type: str, n: int, device="cuda"):
    """Deterministic matrices (reference ``_create_matrix``,
    benchmark.py:103-140), float64, on ``device``."""
    from tpu_sparse_torch.sparse import generators

    if matrix_type == "tridiagonal":
        return generators.tridiagonal(n, device=device)
    if matrix_type == "poisson2d":
        nx = max(2, int(round(n ** 0.5)))
        return generators.poisson2d(nx, device=device)
    if matrix_type == "poisson3d_27pt":
        nx = max(2, int(round(n ** (1.0 / 3.0))))
        return generators.poisson3d_27pt(nx, dtype=np.float64, device=device)
    if matrix_type == "dense_spd":
        return generators.random_spd_dense(n, seed=n, device=device)
    raise ValueError(f"unknown matrix type: {matrix_type}")


def run_single_benchmark(backend: str, method: str, matrix_type: str,
                         size: int, config: BenchmarkConfig
                         ) -> BenchmarkResult:
    """One (backend, method, matrix, size) cell with warm-up and median
    timing (reference benchmark.py:149-273)."""
    from tpu_sparse_torch.api.solver import SparseSolver
    from tpu_sparse_torch.kernels import spmv

    device = torch.device(config.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    try:
        A = _create_matrix(matrix_type, size, device)
        n = A.shape[0]
        rng = np.random.default_rng(0)
        x_true = torch.from_numpy(rng.standard_normal(n)).to(device)
        b = A @ x_true if isinstance(A, torch.Tensor) else spmv(A, x_true)

        solver = SparseSolver()
        kwargs = dict(method=method, backend=backend, tol=config.tol,
                      maxiter=config.maxiter)
        if backend == "krylov":
            kwargs["precision"] = config.precision

        def run():
            x, result = solver.solve(A, b, **kwargs)
            sync()
            return x, result

        sync()
        mem_before = _device_memory_mb(device)
        for _ in range(config.warmup):
            x, result = run()
        times = []
        for _ in range(config.runs):
            t0 = time.perf_counter()
            x, result = run()
            times.append(time.perf_counter() - t0)
        mem_after = _device_memory_mb(device)
        memory_used_mb = (round(mem_after - mem_before, 2)
                          if mem_before is not None else None)

        return BenchmarkResult(
            backend=backend, method=method, matrix_type=matrix_type,
            size=size, solve_time_ms=float(np.median(times)) * 1e3,
            residual=float(result.residual), converged=bool(result.converged),
            iterations=result.iterations, memory_used_mb=memory_used_mb,
        )
    except Exception as exc:  # one failing cell must not lose the others
        return BenchmarkResult(
            backend=backend, method=method, matrix_type=matrix_type,
            size=size, solve_time_ms=float("nan"), residual=float("nan"),
            converged=False, iterations=None,
            error_message=f"{type(exc).__name__}: {exc}"[:300],
        )


def run_all_benchmarks(config: BenchmarkConfig) -> List[BenchmarkResult]:
    """Sweep sizes x types x backends x methods (reference :275-319).
    Method/backend combinations are filtered for validity."""
    results = []
    for matrix_type in config.matrix_types:
        for size in config.sizes:
            for backend in config.backends:
                methods = {
                    "krylov": [m for m in config.methods
                               if m in ("cg", "fcg", "minres", "bicgstab",
                                        "gmres", "fgmres")],
                    "amg": ["amg"],
                    "direct": ["direct"],
                }[backend]
                for method in methods:
                    if config.verbose:
                        print(f"  bench {backend}/{method} "
                              f"{matrix_type} n={size} ...", flush=True)
                    r = run_single_benchmark(backend, method, matrix_type,
                                             size, config)
                    if config.verbose:
                        status = ("ERR " + r.error_message[:60]
                                  if r.error_message else
                                  f"{r.solve_time_ms:.2f} ms "
                                  f"conv={r.converged}")
                        print(f"    -> {status}", flush=True)
                    results.append(r)
    return results


def _power_limit(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    index = device.index if device.index is not None else 0
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not available ({type(exc).__name__})"
    if proc.returncode != 0:
        return f"not available (nvidia-smi exit {proc.returncode})"
    return proc.stdout.strip()


def _system_info(device: torch.device) -> Dict[str, str]:
    cuda = device.type == "cuda"
    return {
        "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "device": (torch.cuda.get_device_name(device) if cuda
                   else "cpu (host clock; no device time)"),
        "name, power limit": _power_limit(device) if cuda else "-",
        "devices": str(torch.cuda.device_count() if cuda else 1),
    }


def generate_markdown_report(results: List[BenchmarkResult],
                             config: BenchmarkConfig,
                             output_dir: str = "Logger") -> str:
    """Timestamped markdown report (reference benchmark.py:369-546):
    system information, availability, per-matrix tables, best
    performers."""
    from tpu_sparse_torch.api.availability import availability_dict

    os.makedirs(output_dir, exist_ok=True)
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(output_dir, f"benchmark_report_{ts}.md")

    lines = ["# tpu_sparse_torch benchmark report", ""]
    lines.append("## System")
    lines.append("")
    for k, v in _system_info(torch.device(config.device)).items():
        lines.append(f"- **{k}**: {v}")
    lines.append("")
    lines.append("## Capability availability")
    lines.append("")
    for k, v in availability_dict().items():
        lines.append(f"- {k}: {'yes' if v else 'no'}")
    lines.append("")
    lines.append(
        f"## Protocol: tol={config.tol}, maxiter={config.maxiter}, "
        f"{config.runs} runs + {config.warmup} warmup, "
        f"precision={config.precision}")
    lines.append("")

    for matrix_type in config.matrix_types:
        subset = [r for r in results if r.matrix_type == matrix_type]
        if not subset:
            continue
        lines.append(f"## {matrix_type}")
        lines.append("")
        lines.append("| n | backend | method | time (ms) | residual | "
                     "converged | iters | mem (MB) |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for r in sorted(subset, key=lambda r: (r.size, r.backend, r.method)):
            if r.error_message:
                lines.append(
                    f"| {r.size} | {r.backend} | {r.method} | ERROR | | | "
                    f"{r.error_message[:40]} | |")
            else:
                mem = (f"{r.memory_used_mb:.2f}"
                       if r.memory_used_mb is not None else "-")
                lines.append(
                    f"| {r.size} | {r.backend} | {r.method} | "
                    f"{r.solve_time_ms:.2f} | {r.residual:.2e} | "
                    f"{'yes' if r.converged else 'NO'} | "
                    f"{r.iterations if r.iterations is not None else '-'} | "
                    f"{mem} |")
        lines.append("")

    # best performer per (type, size): the reference's comparison table
    lines.append("## Best performers")
    lines.append("")
    lines.append("| matrix | n | fastest | time (ms) |")
    lines.append("|---|---|---|---|")
    seen = {}
    for r in results:
        if r.error_message or not r.converged:
            continue
        key = (r.matrix_type, r.size)
        if key not in seen or r.solve_time_ms < seen[key].solve_time_ms:
            seen[key] = r
    for (mt, size), r in sorted(seen.items()):
        lines.append(f"| {mt} | {size} | {r.backend}/{r.method} | "
                     f"{r.solve_time_ms:.2f} |")
    lines.append("")

    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def export_csv(results: List[BenchmarkResult], path: str) -> str:
    """CSV export (reference benchmark.py:350-367)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([fld.name for fld in
                         dataclasses.fields(BenchmarkResult)])
        for r in results:
            writer.writerow(dataclasses.astuple(r))
    return path


def main(argv: Optional[List[str]] = None) -> None:
    """CLI mirroring reference benchmark.py:549-610."""
    import argparse

    ap = argparse.ArgumentParser(description="tpu_sparse_torch benchmark "
                                             "harness")
    ap.add_argument("--sizes", type=int, nargs="+", default=[100, 200, 500])
    ap.add_argument("--types", nargs="+",
                    default=["tridiagonal", "poisson2d", "dense_spd"])
    ap.add_argument("--backends", nargs="+",
                    default=["krylov", "direct", "amg"])
    ap.add_argument("--methods", nargs="+",
                    default=["cg", "bicgstab", "gmres"])
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--precision", default="full",
                    choices=["full", "mixed"])
    ap.add_argument("--csv", default=None)
    ap.add_argument("--output", default="Logger")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    config = BenchmarkConfig(
        sizes=args.sizes, matrix_types=args.types, backends=args.backends,
        methods=args.methods, tol=args.tol, maxiter=args.maxiter,
        runs=args.runs, precision=args.precision, device=args.device)
    results = run_all_benchmarks(config)
    report = generate_markdown_report(results, config, args.output)
    print(f"report written to {report}")
    if args.csv:
        print(f"csv written to {export_csv(results, args.csv)}")


if __name__ == "__main__":
    main()
