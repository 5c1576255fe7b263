"""An autouse fixture for the port's CPU test modules: their BLAS, LAPACK
and torch work runs on one thread while the module runs.

The test suite runs in several worker processes at once; with every
worker's OpenBLAS and torch pools as wide as the machine, the threads
oversubscribe the cores and a dense factorization that takes a few
seconds alone takes over a minute. The results are the same kernels'
(summation orders may differ in the last bits, within every test's
tolerance). Import the fixture into a test module to apply it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # no control over the BLAS pools: torch only
        limits = None
    else:
        limits = threadpool_limits(1)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
        if limits is not None:
            limits.restore_original_limits()
