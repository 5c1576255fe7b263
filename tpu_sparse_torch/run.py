"""Unified test + benchmark runner CLI.

Counterpart of ``tpu_sparse/run.py`` (the reference's src/run.py):
``--test`` / ``--benchmark`` / ``--all``, ``--quick``, ``--sizes``,
``--runs``, ``--precision``, ``--quiet`` (run.py:285-366), and
``--device`` (the card unless ``cpu`` is asked for) for the benchmark.

``--test`` runs pytest on the port's tests, ``tests/test_torch_*.py``,
which hold the port against the JAX package on the CPU; where JAX is not
installed (the card's machine) it runs the card tests instead
(``tests/test_torch_cuda.py -m cuda``, without the JAX conftest).

Usage:
    python -m tpu_sparse_torch.run --test
    python -m tpu_sparse_torch.run --benchmark --quick [--device cpu]
    python -m tpu_sparse_torch.run --all

Returns 2 when no action is given, 1 when the tests fail, else 0.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import os
import subprocess
import sys
from typing import List, Optional

# the representative smoke of --quick: solver / router / container
# correctness and the direct solvers (JAX's list, run.py:33-37)
QUICK_TESTS = ("test_torch_krylov.py", "test_torch_solve.py",
               "test_torch_sparse.py", "test_torch_direct.py",
               "test_torch_supernodal.py")


def run_tests(quick: bool = False, quiet: bool = False) -> bool:
    """Run the port's pytest suite; True when it passes."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tests = os.path.join(repo_root, "tests")
    args = [sys.executable, "-m", "pytest"]
    if importlib.util.find_spec("jax") is None:
        args += ["--noconftest", "-m", "cuda",
                 os.path.join(tests, "test_torch_cuda.py")]
    elif quick:
        args += [os.path.join(tests, f) for f in QUICK_TESTS]
    else:
        args += sorted(glob.glob(os.path.join(tests, "test_torch_*.py")))
    args += ["-x", "-q" if quiet else "-v"]
    proc = subprocess.run(args, cwd=repo_root)
    return proc.returncode == 0


def run_benchmarks(quick: bool = False, sizes: Optional[List[int]] = None,
                   runs: int = 3, quiet: bool = False,
                   precision: str = "full", device: str = "cuda") -> None:
    from tpu_sparse_torch.bench.harness import (BenchmarkConfig,
                                                generate_markdown_report,
                                                run_all_benchmarks)

    if quick:
        config = BenchmarkConfig(
            sizes=sizes or [100], matrix_types=("tridiagonal", "poisson2d"),
            backends=("krylov", "direct"), methods=("cg",), runs=1,
            warmup=1, precision=precision, verbose=not quiet, device=device)
    else:
        config = BenchmarkConfig(
            sizes=sizes or [100, 200, 500], runs=runs, precision=precision,
            verbose=not quiet, device=device)
    results = run_all_benchmarks(config)
    path = generate_markdown_report(results, config)
    ok = sum(1 for r in results if r.converged)
    print(f"{ok}/{len(results)} benchmark cells converged; report: {path}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="tpu_sparse_torch unified test/benchmark runner")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--benchmark", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sizes", type=int, nargs="+", default=None)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--precision", default="full",
                    choices=["full", "mixed"])
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if not (args.test or args.benchmark or args.all):
        ap.print_help()
        return 2

    ok = True
    if args.test or args.all:
        ok = run_tests(quick=args.quick, quiet=args.quiet)
    if args.benchmark or args.all:
        run_benchmarks(quick=args.quick, sizes=args.sizes, runs=args.runs,
                       quiet=args.quiet, precision=args.precision,
                       device=args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
