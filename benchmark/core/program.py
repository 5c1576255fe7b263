"""The system under test: ``tpu_sparse_torch``, and only its public entries
plus the few handles the per-layer readers time.

An entry takes the matrix and one right-hand side and returns
``(x, converged, iterations)`` once x is computed and the report read on
the host, as a caller that waits for x sees it:

* ``solve``: ``tpu_sparse_torch.solve(A, b, tol=, maxiter=, **kwargs)``;
* ``distributed_cg``: ``tpu_sparse_torch.dist.distributed_cg(A, b,
  mesh=, tol=, maxiter=, **kwargs)``, returning this rank's rows of x.

The package is imported here, not when the harness's modules are: the
harness finds no chip, prints nothing and exits before this runs in a
checkout that lacks it.
"""

from __future__ import annotations

import torch


class Program:
    def __init__(self, entry: str, kwargs: dict, tol: float, maxiter: int,
                 mesh=None):
        import tpu_sparse_torch

        self.tsp = tpu_sparse_torch
        self.entry = entry
        self.kwargs = dict(kwargs)
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self.mesh = mesh
        if entry not in ("solve", "distributed_cg"):
            raise ValueError(f"unknown entry {entry!r}")

    def matrix(self, data: torch.Tensor, offsets, n: int):
        """The port's DIA over the benchmark's diagonals (no copy)."""
        return self.tsp.DIA(data, offsets, (n, n))

    def solve(self, A, b):
        if self.entry == "solve":
            x, res = self.tsp.solve(A, b, tol=self.tol, maxiter=self.maxiter,
                                    **self.kwargs)
            return x, bool(res.converged), res.iterations
        from tpu_sparse_torch.dist import distributed_cg

        x, info, it, _ = distributed_cg(A, b, mesh=self.mesh, tol=self.tol,
                                        maxiter=self.maxiter, **self.kwargs)
        return x, int(info) == 0, int(it)

    def amg_preconditioner(self, A):
        """The preconditioner that ``solve(A, b, backend="amg")`` applies:
        the router's cached hierarchy (a hit after the window's solves)."""
        from tpu_sparse_torch.api.solver import _get_default_solver

        return _get_default_solver()._amg_M(A)

    def halo_exchange(self, A, x_local: torch.Tensor):
        """One halo exchange of this rank's rows on the partition the
        window's solves used, as ``dist.scaling_probe`` times it."""
        from tpu_sparse_torch.dist import distributed_matvec_op
        from tpu_sparse_torch.dist.spmv import (LocalExtendedOperator,
                                                _halo_fill)

        A_sh, _ = distributed_matvec_op(A, self.mesh,
                                        self.kwargs.get("mode", "gspmd"))
        loc = LocalExtendedOperator(A_sh)
        ext = loc.extend(x_local)
        w = max(A_sh.bandwidth, 1)

        def exchange():
            _halo_fill(ext, x_local, loc.Wl, w, w, self.mesh)

        return exchange
