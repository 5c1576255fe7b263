"""North-star demo: CG on the 27-point 3-D Poisson system.

Counterpart of ``examples/poisson3d_demo.py``: the BASELINE.json target
workload, CG on ``poisson3d_27pt(nx)`` in float32 with ``b = A x_true``
(``x_true`` from ``default_rng(0)``), reporting time to tolerance and the
effective nonzeros a second. ``solve(A, b, method="cg")`` takes the fused
CG (kernels 2-3) on the card; the demo solves once to warm up and then
times one solve on the host clock, ended by ``torch.cuda.synchronize()``.
``--distributed`` runs the halo CG of ``tpu_sparse_torch.dist`` over the
host's cards, one process a card started by ``torch.distributed.run
--standalone`` (as ``dist/scaling_probe.py`` does); with ``--cpu`` over
two gloo ranks on the host.

    python -m tpu_sparse_torch.apps.poisson3d_demo --nx 160    # 110M nnz
    python -m tpu_sparse_torch.apps.poisson3d_demo --nx 160 --distributed
    python -m tpu_sparse_torch.apps.poisson3d_demo --nx 12 --cpu

``--cpu`` is the only way onto the CPU. ``main`` returns 0 when the
solve converged, else 1.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=160,
                    help="grid edge; n = nx^3 (160 -> 110M nnz)")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)  # one rank of --distributed
    return ap.parse_args(argv)


def _system(nx: int, device):
    """(A, x_true, b): the float32 system, A and x_true built on the host
    and moved to ``device``."""
    from tpu_sparse_torch.sparse import generators

    A = generators.poisson3d_27pt(nx, dtype=np.float32, device="cpu")
    rng = np.random.default_rng(0)
    x_true = torch.from_numpy(
        rng.standard_normal(A.shape[0]).astype(np.float32))
    A, x_true = A.to(device), x_true.to(device)
    return A, x_true, A @ x_true


def _report(label: str, A, b, x, x_true, converged: bool, iters: int,
            seconds: float) -> dict:
    rel = float(torch.linalg.vector_norm(b - A @ x)
                / torch.linalg.vector_norm(b))
    err = float((x - x_true).abs().max())
    out = dict(label=label, n=A.shape[0], nnz=A.nnz, converged=converged,
               iterations=iters, ms=seconds * 1e3, rel_residual=rel,
               max_abs_err=err,
               gnnz_per_s=A.nnz * iters / seconds / 1e9)
    print(f"{label}: {'converged' if converged else 'NOT converged'} in "
          f"{iters} iterations, {out['ms']:.1f} ms")
    print(f"  true rel residual {rel:.2e}   max|x - x_true| {err:.2e}")
    print(f"  effective {out['gnnz_per_s']:.1f} Gnnz/s through the full CG",
          flush=True)
    return out


def run(args: argparse.Namespace) -> dict:
    """The single-device demo; returns what it printed as a dict
    (iterations, ms, true relative residual, Gnnz/s, ...)."""
    import tpu_sparse_torch

    device = torch.device("cpu" if args.cpu else "cuda")
    t0 = time.perf_counter()
    A, x_true, b = _system(args.nx, device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"operator: 27-pt Poisson  n={A.shape[0]:,}  nnz={A.nnz:,}  "
          f"built in {time.perf_counter() - t0:.1f}s on {where}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def solve():
        x, res = tpu_sparse_torch.solve(A, b, method="cg", tol=args.tol,
                                        maxiter=args.maxiter)
        sync()
        return x, res

    solve()  # warm: extended operator, fused-path buffers
    t0 = time.perf_counter()
    x, res = solve()
    dt = time.perf_counter() - t0
    label = ("single-device CG (fused kernels 2-3)" if device.type == "cuda"
             else "single-device CG (CPU)")
    return _report(label, A, b, x, x_true, res.converged, res.iterations, dt)


def _worker(args: argparse.Namespace) -> dict:
    """One rank of --distributed: the halo CG over every rank's rows."""
    import torch.distributed as dist

    from tpu_sparse_torch.dist import (distributed_cg, gather_vector,
                                       initialize_multihost, make_row_mesh)

    device_type = "cpu" if args.cpu else "cuda"
    initialize_multihost(device_type)
    mesh = make_row_mesh(device_type)
    device = mesh.device
    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // (2 * mesh.world_size)))
    A, x_true, b = _system(args.nx, "cpu")
    A_dev, x_true, b = A.to(device), x_true.to(device), b.to(device)
    kw = dict(mesh=mesh, mode="halo", tol=args.tol, maxiter=args.maxiter)

    def solve():
        out = distributed_cg(A, b, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    solve()  # warm: shard, halo plan
    dist.barrier()
    t0 = time.perf_counter()
    x_rows, info, iters, _ = solve()
    dt = time.perf_counter() - t0
    x = gather_vector(x_rows, mesh, A.shape[0])
    out = None
    if mesh.rank == 0:
        out = _report(f"distributed CG over {mesh.world_size} "
                      f"{device.type} ranks", A_dev, b, x, x_true,
                      int(info) == 0, int(iters), dt)
    dist.barrier()
    dist.destroy_process_group()
    return out if out is not None else dict(converged=int(info) == 0)


def _launch(args: argparse.Namespace) -> int:
    """Start one rank a card (``--cpu``: two gloo ranks) under
    ``torch.distributed.run --standalone``; returns its exit code."""
    if args.cpu:
        nproc = 2
    elif not torch.cuda.is_available():
        print("poisson3d_demo: --distributed needs CUDA devices (or --cpu)",
              file=sys.stderr)
        return 2
    else:
        nproc = torch.cuda.device_count()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m",
           "tpu_sparse_torch.apps.poisson3d_demo", "--worker",
           "--distributed", "--nx", str(args.nx), "--tol", str(args.tol),
           "--maxiter", str(args.maxiter)] + (["--cpu"] if args.cpu else [])
    return subprocess.run(cmd).returncode


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        return 0 if _worker(args)["converged"] else 1
    if args.distributed:
        return _launch(args)
    return 0 if run(args)["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
