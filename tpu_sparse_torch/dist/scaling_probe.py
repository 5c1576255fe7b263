"""Strong and weak scaling of the distributed halo CG over one host's cards.

    python -m tpu_sparse_torch.dist.scaling_probe --launch 1,2,4 \\
        [--nx 160] [--out DIR]

runs, for each N of ``--launch`` in turn, ``torchrun --standalone
--nproc-per-node N`` (as ``python -m torch.distributed.run``) of this
module in worker mode, one process per card on an NCCL group, and prints
``nvidia-smi``'s card name and power limit and ``nvidia-smi topo -m``
(whether the cards share NVLink or PCIe) first. Each worker run:

* **strong scaling**: halo CG (tol 1e-6, float32) on ``poisson3d_27pt(nx)``
  split over the N ranks, its iterations and x held against the same solve
  on a one-rank group of rank 0 (iterations within 2, x within 1e-5
  relative);
* **weak scaling**: ``poisson3d_27pt(nx, nx, nx * N)``, a slab of nx^3 rows
  per card;

and times, by CUDA events (median of 9): one distributed SpMV (halo
exchange + kernel 1 extended mode), the kernel alone, the halo exchange
alone (one per CG iteration), one scalar all-reduce, and the CG solve
(time to tol and per iteration). Rank 0 prints one JSON line per world
size and writes it to ``--out`` (default: a new temporary directory);
the launcher then prints the weak-scaling
efficiency (SpMV nnz/s per card at N over that at 1, and the same for the
CG iteration rate) beside the 0.70 of the north star.

``--device cpu`` runs the same on gloo CPU ranks with host-clock times: a
rehearsal of the control flow, not a measurement of any device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def _smi(*args) -> str:
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _times_ms(fn, device, inner: int, reps: int = 9):
    """(median, min, max) ms per call: CUDA events on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        from tpu_sparse_torch.utils.timing import cuda_times_ms

        ts = cuda_times_ms(fn, warmup=1, reps=reps, inner=inner)
    else:
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            ts.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(ts), min(ts), max(ts)


def _local_nnz(A, i0: int, i1: int) -> int:
    """Stored in-range entries of rows [i0, i1) of a DIA matrix."""
    n, m = A.shape
    return sum(max(0, min(i1, m - o) - max(i0, -o)) for o in A.offsets)


def _host_ms(fn, device, inner: int = 20, reps: int = 9):
    """(median, min, max) host-clock ms per call of ``fn``, the card
    synchronized after each round: what a host-bound loop pays."""
    ts = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3 / inner)
    ts = ts[1:]
    return statistics.median(ts), min(ts), max(ts)


def _one_rank_check(x_full, A, b, sub, device, iters: int) -> dict:
    """The same halo CG on a one-rank group of rank 0: iterations within
    2, x within 1e-5 relative."""
    from tpu_sparse_torch.dist import distributed_cg
    from tpu_sparse_torch.dist.mesh import RowMesh

    one = RowMesh(sub, 0, 1, device)
    x1, _, it1, _ = distributed_cg(A, b, mesh=one, mode="halo", tol=1e-6,
                                   maxiter=1000)
    d = float(torch.linalg.vector_norm((x_full - x1).double())
              / torch.linalg.vector_norm(x1.double()))
    return dict(one_rank_iterations=int(it1), x_rel_diff_to_one=d,
                matches_one_rank=bool(abs(int(it1) - iters) <= 2
                                      and d <= 1e-5))


def _case(label, A, x_true, mesh, device):
    """Solve, then time the pieces; returns (row, x_full, b)."""
    import torch.distributed as dist

    from tpu_sparse_torch.dist import distributed_cg, gather_vector
    from tpu_sparse_torch.dist.solvers import _shard_and_resolve
    from tpu_sparse_torch.dist.spmv import LocalExtendedOperator, _halo_fill

    n = A.shape[0]
    b = (A @ x_true).to(device)
    A_sh, mode, op = _shard_and_resolve(A, mesh, "halo")
    s, i0 = A_sh.rows, A_sh.i0
    kw = dict(mesh=mesh, mode="halo", tol=1e-6, maxiter=1000)
    x, info, it, res = distributed_cg(A, b, **kw)
    t_cg = _times_ms(lambda: distributed_cg(A, b, **kw), device, 1)
    x_full = gather_vector(x, mesh, n)
    err = float(torch.linalg.vector_norm((x_full - x_true.to(device))
                                         .double())
                / torch.linalg.vector_norm(x_true.double()))
    out = dict(case=label, n=n, nnz=A.nnz, rows_per_rank=s, route=mode,
               info=int(info), iterations=int(it), residual=float(res),
               rel_error_to_x_true=err, cg_ms=t_cg,
               cg_ms_per_iteration=t_cg[0] / max(int(it), 1))
    xv = x_true[i0:i0 + s].to(device).contiguous()
    loc = LocalExtendedOperator(A_sh)
    ext = loc.extend(xv)
    w = max(A_sh.bandwidth, 1)
    t_spmv = _times_ms(lambda: op(xv), device, 20)
    t_kernel = _times_ms(lambda: loc(ext), device, 20)
    def exchange():
        _halo_fill(ext, xv, loc.Wl, w, w, mesh)

    t_exch = _times_ms(exchange, device, 20)
    t_exch_host = _host_ms(exchange, device)
    z = torch.zeros((), dtype=torch.float32, device=device)
    t_ar = _times_ms(lambda: mesh.all_reduce(z), device, 50)
    nnz_loc = _local_nnz(A, i0, i0 + s)
    t_max = torch.tensor([t_spmv[0], t_cg[0] / max(int(it), 1)],
                         dtype=torch.float64, device=device)
    dist.all_reduce(t_max, op=dist.ReduceOp.MAX, group=mesh.group)
    out.update(
        nnz_per_rank=nnz_loc, spmv_ms=t_spmv, kernel_ms=t_kernel,
        exchange_ms=t_exch, exchange_host_ms=t_exch_host,
        allreduce_ms=t_ar,
        halo_bytes_per_spmv=2 * w * xv.element_size() if mesh.world_size > 1
        else 0,
        spmv_nnz_per_s_per_card=nnz_loc / (float(t_max[0]) * 1e-3),
        cg_nnz_per_s_per_card=nnz_loc / (float(t_max[1]) * 1e-3))
    return out, x_full, b


def worker(args) -> int:
    import torch.distributed as dist

    from tpu_sparse_torch.dist import initialize_multihost, make_row_mesh
    from tpu_sparse_torch.sparse import generators as gen

    device = torch.device(args.device)
    initialize_multihost(device.type)
    mesh = make_row_mesh(device.type)
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // (2 * mesh.world_size)))
    N = mesh.world_size
    sub = dist.new_group([0])
    rng = np.random.default_rng(args.seed)
    nx = args.nx
    rows = []
    A = gen.poisson3d_27pt(nx, device="cpu")
    x_true = torch.from_numpy(rng.standard_normal(A.shape[0]).astype(
        np.float32))
    strong, x_full, b = _case(f"strong poisson3d_27pt({nx})", A, x_true,
                              mesh, device)
    rows.append(strong)
    Aw = gen.poisson3d_27pt(nx, nx, nx * N, device="cpu")
    xw = torch.from_numpy(rng.standard_normal(Aw.shape[0]).astype(
        np.float32))
    rows.append(_case(f"weak poisson3d_27pt({nx}, {nx}, {nx * N})", Aw, xw,
                      mesh, device)[0])
    del Aw, xw
    # the one-rank check last, after every timing
    if mesh.rank == 0:
        strong.update(_one_rank_check(x_full, A, b, sub, device,
                                      strong["iterations"]))
    dist.barrier()
    if device.type == "cuda":
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                            dtype=torch.float64, device=device)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        peak = float(peak)
    else:
        peak = None
    if mesh.rank == 0:
        kind = torch.cuda.get_device_name(0) if device.type == "cuda" \
            else "cpu (rehearsal, host clock)"
        line = dict(world_size=N, device=kind, backend=dist.get_backend(),
                    clock="cuda events" if device.type == "cuda"
                    else "host", peak_device_memory_gb=peak, cases=rows)
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"world{N}.json"), "w") as f:
                json.dump(line, f)
    dist.barrier()
    dist.destroy_process_group()
    ok = all(r["info"] == 0 for r in rows) and rows[0].get(
        "matches_one_rank", True)
    return 0 if ok else 1


def launch(args) -> int:
    worlds = [int(v) for v in args.launch.split(",")]
    out = args.out or tempfile.mkdtemp(prefix="scaling_probe_")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("scaling_probe: no CUDA device", file=sys.stderr)
            return 2
        print(_smi("--query-gpu=name,power.limit", "--format=csv,noheader"))
        print(_smi("topo", "-m"), flush=True)
        have = torch.cuda.device_count()
        print("peer access (torch.cuda.can_device_access_peer): " + ", ".join(
            f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
            for i in range(have) for j in range(have) if i != j), flush=True)
        print(_smi("nvlink", "--status"), flush=True)
        if max(worlds) > have:
            print(f"scaling_probe: {max(worlds)} ranks need as many cards, "
                  f"{have} visible", file=sys.stderr)
            return 2
    results = {}
    for N in worlds:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={N}", "-m",
               "tpu_sparse_torch.dist.scaling_probe", "--worker",
               "--device", args.device, "--nx", str(args.nx), "--seed",
               str(args.seed), "--out", out]
        t0 = time.perf_counter()
        rc = subprocess.run(cmd, timeout=args.timeout).returncode
        print(f"world {N}: exit {rc} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        if rc != 0:
            return rc
        with open(os.path.join(out, f"world{N}.json")) as f:
            results[N] = json.load(f)
    if 1 in results:
        base = {r["case"].split()[0]: r for r in results[1]["cases"]}
        for N, line in results.items():
            for r in line["cases"]:
                kind = r["case"].split()[0]
                b = base[kind]
                print(f"world {N} {r['case']}: SpMV "
                      f"{r['spmv_nnz_per_s_per_card'] / 1e9:.2f} Gnnz/s per "
                      f"card (x{r['spmv_nnz_per_s_per_card'] / b['spmv_nnz_per_s_per_card']:.3f}"
                      f" of one card), CG {r['cg_ms'][0]:.2f} ms to tol, "
                      f"{r['cg_ms_per_iteration']:.3f} ms/it "
                      f"({r['iterations']} it), exchange "
                      f"{r['exchange_ms'][0] * 1e3:.1f} us (host "
                      f"{r['exchange_host_ms'][0] * 1e3:.1f}), kernel "
                      f"{r['kernel_ms'][0] * 1e3:.1f} us, all-reduce "
                      f"{r['allreduce_ms'][0] * 1e3:.1f} us"
                      + (f"; weak-scaling efficiency SpMV "
                         f"{r['spmv_nnz_per_s_per_card'] / b['spmv_nnz_per_s_per_card']:.3f}"
                         f", CG {r['cg_nnz_per_s_per_card'] / b['cg_nnz_per_s_per_card']:.3f}"
                         f" (north star 0.70)" if kind == "weak" else ""),
                      flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--launch", default="1,2,4",
                   help="world sizes to run in turn (launcher mode)")
    p.add_argument("--worker", action="store_true",
                   help="run as one rank under torch.distributed.run")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--nx", type=int, default=160)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=900.0)
    args = p.parse_args(argv)
    return worker(args) if args.worker else launch(args)


if __name__ == "__main__":
    sys.exit(main())
