"""What decides ``correct``: the program's answers held to the reference.

Numbers compared, each with its limit (a number passes at or below it):

* ``max_rel_residual``: the largest ||b - A x|| / ||b||, worked out in
  float64 by the reference from the benchmark's own diagonals, over the
  solves kept for the check (a sample drawn from the seed, every column of
  a block). Limit: the cell's, set from the program's readings and the
  control's (PERF.md), never from the program's own acceptance test.
* ``unconverged``: solves of the window that reported no convergence.
  Limit 0: the configuration promises convergence.
* ``iters_gap`` (where the traffic asks for it): the largest
  |iterations reported - the reference's| / the reference's, over the
  window's solves of one pool entry drawn from the seed; the reference
  runs the mix's method (CG, BiCGStab or GMRES with the mix's restart;
  ``reference_solve``) in float64 from zero to the configuration's
  tolerance and maxiter. Limit: the cell's.

``failed`` counts the solves that reported no convergence and those that
reported it while the reference's residual passed the limit.
"""

from __future__ import annotations

import torch

from benchmark.reference import hpcg as ref
from benchmark.reference import krylov


def reference_solve(method: str, config: dict, kwargs: dict,
                    data: torch.Tensor, offsets, b: torch.Tensor,
                    dtype: torch.dtype = torch.float64):
    """(x, iterations, converged) of the plain reference ``method`` on
    A x = b from zero, to the configuration's tol and maxiter, in
    ``dtype``; GMRES restarts as the mix's keyword arguments say."""
    tol, maxiter = float(config["tol"]), int(config["maxiter"])
    if method == "gmres":
        return krylov.gmres(data, offsets, b, tol, maxiter,
                            int(kwargs["restart"]), dtype)
    solver = {"cg": ref.cg, "bicgstab": krylov.bicgstab}[method]
    return solver(data, offsets, b, tol, maxiter, dtype)


def judge(config: dict, limits: dict, data: torch.Tensor, offsets,
          checked: list, solves: list, iteration_ref=None, kwargs=None):
    """(correct, failed, checks, notes).

    ``checked``: (b, x, converged, scale) of the kept solves, x whole;
    ``solves``: dicts with ``pool_index``, ``converged``, ``iterations``;
    ``iteration_ref``: (pool_index, b, scale, method) for the iteration
    check, or None; the scale multiplies the diagonals (a refreshed
    matrix), the method names the reference, which takes the mix's keyword
    arguments ``kwargs``."""
    residual_limit = float(limits["max_rel_residual"])

    def scaled(scale):
        return data if scale is None else data * scale

    worst, false_pass = 0.0, 0
    for b, x, converged, scale in checked:
        res = max(ref.rel_residuals(scaled(scale), offsets, x, b))
        res = res if res == res else float("inf")   # NaN fails
        worst = max(worst, res)
        if converged and res > residual_limit:
            false_pass += 1
    unconverged = sum(1 for s in solves if not s["converged"])
    checks = {
        "max_rel_residual": {"value": worst, "limit": residual_limit},
        "unconverged": {"value": unconverged, "limit": 0},
    }
    notes = {}
    if iteration_ref is not None:
        j, b, scale, method = iteration_ref
        _, it_ref, _ = reference_solve(method, config, kwargs or {},
                                       scaled(scale), offsets, b)
        gaps = [abs(int(s["iterations"]) - it_ref) / it_ref for s in solves
                if s["pool_index"] == j and s["iterations"] is not None]
        checks["iters_gap"] = {"value": max(gaps) if gaps else float("inf"),
                               "limit": float(limits["iters_gap"])}
        notes["ref_iterations"] = it_ref
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, unconverged + false_pass, checks, notes
