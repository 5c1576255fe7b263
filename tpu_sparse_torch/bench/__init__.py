"""The benchmark harness (the reference's tests/benchmark.py capability):
``python -m tpu_sparse_torch.bench.harness`` or ``run.py --benchmark``."""

from tpu_sparse_torch.bench.harness import (BenchmarkConfig, BenchmarkResult,
                                            export_csv,
                                            generate_markdown_report,
                                            run_all_benchmarks,
                                            run_single_benchmark)

__all__ = [
    "BenchmarkConfig", "BenchmarkResult", "export_csv",
    "generate_markdown_report", "run_all_benchmarks",
    "run_single_benchmark",
]
