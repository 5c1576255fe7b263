#!/usr/bin/env python3
"""The benchmark of tpu_sparse_torch: closed-loop solves on HPCG's problem.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card(s) of this machine and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks``, each number compared beside its limit; the
same numbers are the last lines of standard error.

A run makes the matrix and a pool of right-hand sides on the card from the
seed, hands them to the port (``tpu_sparse_torch``), solves a few requests
to warm every shape (set-up, ``setup_s``), then sends one request after
another for ``--seconds`` seconds. With ``--trace 1`` it solves the
traffic's ``trace_solves`` requests under the profiler instead and reports
the per-layer metrics. Once the window has closed and the memory peak is
read, the plain reference (``benchmark/reference``) checks the answers.

A cell on 4 chips starts one process per card on an NCCL group of this
host (``tcp://127.0.0.1:<free port>``); only rank 0 prints the result.

``--cpu-rehearsal NX`` runs the same code on the CPU at a local grid of
NX^3 (gloo for several ranks): a rehearsal of the control flow that
reports no device metric. ``--calibrate SEEDS [--control-seeds SEEDS]``
prints the compared numbers of the program on each seed and of the
control (the plain reference of the mix's method computed in bfloat16
in the program's place), the readings the limits are set from. Neither is
a benchmark run.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
# module names (whole top-level names) that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_sparse")
LAUNCH_TIMEOUT_S = 1500.0

os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--cpu-rehearsal", type=int, default=0, metavar="NX")
    p.add_argument("--calibrate", type=_seeds, default=None)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    # set by the launcher for the ranks of a cell on several chips
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, cell, worker_cmd=None) -> int:
    """Start one process per chip, wait for all, stop all on a failure."""
    base = worker_cmd or [sys.executable, str(Path(__file__).resolve())]
    common = ["--workload", cell.name, "--seed", str(args.seed), "--seconds",
              str(args.seconds), "--trace", str(args.trace), "--world",
              str(cell.chips), "--port", str(_free_port()), "--t0",
              repr(T_START), "--cpu-rehearsal", str(args.cpu_rehearsal)]
    if args.calibrate is not None:
        common += ["--calibrate", ",".join(map(str, args.calibrate)),
                   "--control-seeds", ",".join(map(str, args.control_seeds))]
    procs = [subprocess.Popen(base + common + ["--rank", str(r)])
             for r in range(cell.chips)]
    rc = 0
    try:
        deadline = time.time() + LAUNCH_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.returncode]
            if bad or time.time() > deadline:
                rc = bad[0] if bad else 124
                break
            time.sleep(0.2)
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc


class Run:
    """What the metric readers read: the cell, the live program and its
    inputs, the window's solves, and the trace of a traced run."""

    def __init__(self, **kw):
        self.trace = None
        self.memory_peak_bytes = None
        self.__dict__.update(kw)


class Ranks:
    """Collectives of the benchmark's own (not the program's): the loop's
    go flag, reductions of numbers, gathering x for the reference."""

    def __init__(self, rank: int, world: int, device):
        self.rank, self.world, self.device = rank, world, device

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self):
        if self.world > 1:
            dist.barrier()

    def decide(self, go: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if self.world == 1:
            return go
        t = torch.tensor([1 if go else 0], device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def reduce(self, value: float, op: str) -> float:
        if self.world == 1:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
        return float(t.item()) / (self.world if op == "mean" else 1)

    def whole(self, x):
        """The whole vector from every rank's rows (rank 0 keeps it)."""
        if self.world == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts) if self.rank == 0 else None


def _grid(cell, rehearsal: int) -> list:
    grid = [int(g) for g in cell.config["grid"]]
    if rehearsal:
        grid = [rehearsal * int(p) for p in cell.config["process_grid"]]
    return grid


def _iteration_pool_index(seed: int, solved) -> int:
    """The pool entry whose iterations the reference checks: drawn from
    the seed among the entries the window solved (all of them once a
    window holds a round of the pool)."""
    solved = sorted(set(solved))
    return solved[random.Random(int(seed) * 31 + 7).randrange(len(solved))]


def _solve_loop(program, A_of, pool, requests, ranks, keep, stop):
    """Closed loop: the next request goes when x of the last is back.
    ``stop(solves)`` is rank 0's decision to end, asked before each."""
    solves = []
    while ranks.decide(not stop(solves)):
        req = next(requests)
        A = A_of(req.scale)
        t = time.perf_counter()
        x, conv, it = program.solve(A, pool[req.pool_index])
        ranks.sync()
        solves.append(dict(pool_index=req.pool_index, converged=bool(conv),
                           iterations=None if it is None else int(it),
                           wall_s=time.perf_counter() - t))
        if keep is not None:
            keep.offer((req.pool_index, x, bool(conv), A_of.scale))
        del x
    return solves


class MatrixOf:
    """The matrix a request solves: the base diagonals, or after a refresh
    the base times the request's scale (a new values tensor)."""

    def __init__(self, program, data, offsets, n):
        self.program, self.data, self.offsets, self.n = \
            program, data, offsets, n
        self.scale = None
        self.base = program.matrix(data, offsets, n)
        self.current = self.base

    def __call__(self, scale):
        if scale is not None:
            self.scale = scale
            self.current = self.program.matrix(self.data * scale,
                                               self.offsets, self.n)
        return self.current


def _check(cell, data, offsets, pool, kept, solves, ranks, seed,
           iteration_check: bool, whole: bool = False):
    """Gather the kept answers (unless rank 0 holds them ``whole``) and
    judge them on rank 0."""
    from benchmark.core import judge

    checked = []
    for j, x, conv, scale in kept:
        xw = x if whole else ranks.whole(x)
        if ranks.rank == 0:
            checked.append((pool[j], xw, conv, scale))
    out = None
    if ranks.rank == 0:
        it_ref = None
        if iteration_check:
            j = _iteration_pool_index(seed, [s["pool_index"] for s in solves])
            scales = [s for p, _, _, s in kept if p == j] or [None]
            it_ref = (j, pool[j], scales[0], cell.method)
        out = judge.judge(cell.config, cell.workload.get("limits", {}), data,
                          offsets, checked, solves, it_ref,
                          cell.traffic["kwargs"])
    ranks.barrier()
    return out


def _say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def worker(args, cell) -> int:
    from benchmark.core import cells, stencil, trace, traffic
    from benchmark.core.program import Program

    rank, world = int(args.rank), int(args.world)
    t0 = T_START if args.t0 is None else float(args.t0)
    rehearsal = int(args.cpu_rehearsal)
    device = torch.device("cpu") if rehearsal else torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // world)))
    mesh = None
    if world > 1:
        import datetime

        from tpu_sparse_torch.dist import make_row_mesh

        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{args.port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=900))
        mesh = make_row_mesh(device.type)
    ranks = Ranks(rank, world, device)
    cfg, tr = cell.config, cell.traffic

    def stage(what):
        if rank == 0:
            _say(f"[bench] {time.time() - t0:8.3f} s  {what}")

    stage("process group" if world > 1 else "torch ready")

    # set-up: the operator, the pool, the program, warm-up of every shape
    grid = _grid(cell, rehearsal)
    n = math.prod(grid)
    data, offsets = stencil.diagonals(grid, cfg["diagonal"], cfg["neighbour"],
                                      stencil.dtype_of(cfg["dtype"]), device,
                                      cell.coefficients)
    stage("diagonals")
    program = Program(tr["entry"], tr["kwargs"], cfg["tol"], cfg["maxiter"],
                      mesh)
    A_of = MatrixOf(program, data, offsets, n)
    columns = int(tr.get("rhs_columns", 1))
    pool = stencil.rhs_pool(data, offsets, int(tr["pool"]), columns,
                            args.seed, tr.get("base_seed"))
    stage("pool")
    for i in range(int(tr["warmup_solves"])):
        program.solve(A_of.base, pool[i % len(pool)])
        ranks.sync()
        stage(f"warm-up solve {i}")
    ranks.barrier()
    if args.calibrate is not None:
        return calibrate(args, cell, program, A_of, data, offsets, columns,
                         ranks)
    setup_s = time.time() - t0
    requests = traffic.requests(args.seed, tr)
    keep = traffic.Reservoir(args.seed, int(tr["check_solves"]))
    run = Run(cell=cell, config=cfg, traffic=tr, device=device, rank=rank,
              world=world, mesh=mesh, program=program, A=A_of.base,
              data=data, offsets=offsets, pool=pool, n=n,
              rows=n // world, ndiag=len(offsets),
              itemsize=data.element_size(), setup_s=setup_s)
    if args.trace:
        count = int(tr["trace_solves"])
        solves, run.trace = trace.profiled(lambda: _solve_loop(
            program, A_of, pool, requests, ranks, keep,
            lambda s: len(s) >= count))
        run.window_s = run.trace.window_s if run.trace else None
    else:
        start = time.perf_counter()
        solves = _solve_loop(program, A_of, pool, requests, ranks, keep,
                             lambda s: bool(s) and time.perf_counter()
                             - start >= args.seconds)
        run.window_s = time.perf_counter() - start
    run.solves = solves
    _say(f"[bench] {cell.name} rank {rank}: set-up {setup_s:.3f} s, "
         f"{len(solves)} solves in {run.window_s:.3f} s")

    wanted = cell.per_layer if args.trace else cell.end_to_end
    values = {}
    if args.trace:   # readers that time a layer alone run on every rank
        for m in wanted:
            values[m["name"]] = cells.load_reader(ROOT, m["name"])(run)
    if device.type == "cuda":
        run.memory_peak_bytes = int(ranks.reduce(
            torch.cuda.max_memory_allocated(device), "max"))
    if not args.trace:
        for m in wanted:
            values[m["name"]] = cells.load_reader(ROOT, m["name"])(run)
    summary = run.trace
    busy = None
    if summary is not None and device.type == "cuda":
        busy = ranks.reduce(summary.busy_s, "mean")
    memory_peak = run.memory_peak_bytes

    # the program's state goes before the reference runs
    kept = keep.items
    del keep, requests, run
    A_of.current = A_of.base = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = _check(cell, data, offsets, pool, kept, solves, ranks, args.seed,
                     bool(tr.get("iteration_reference")))
    del kept
    gc.collect()
    found = forbidden_modules()
    if world > 1:
        dist.destroy_process_group()
    if found:
        _say(f"[bench] forbidden modules loaded in rank {rank}: "
             f"{', '.join(found)}")
        return 3
    if rank != 0:
        return 0
    correct, failed, checks, notes = verdict
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu rehearsal"),
           "count": world, "memory_peak_bytes": memory_peak}
    if busy is not None:
        dev["busy_s"] = busy
        dev["window_s"] = summary.window_s
    result = {"correct": bool(correct), "attempted": len(solves),
              "failed": int(failed),
              "metrics": {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in wanted
                          if values.get(m["name"]) is not None},
              "device": dev}
    if busy is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    if rehearsal:
        result["rehearsal"] = f"cpu, local grid {rehearsal}^3"
    result["checks"] = checks
    for k, v in notes.items():
        _say(f"[bench] note {k} {v}")
    for k, c in checks.items():
        _say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def calibrate(args, cell, program, A_of, data, offsets, columns, ranks
              ) -> int:
    """The readings the limits are set from: the compared numbers of the
    program on each seed of ``--calibrate`` (its ``check_solves`` requests,
    every one kept) and of the control on each of ``--control-seeds``: the
    plain reference of the mix's method computed in bfloat16 (values,
    vectors and every sum) in the program's place, on two pool entries.
    One JSON line per seed on rank 0."""
    from benchmark.core import judge, stencil, traffic

    tr, cfg = cell.traffic, cell.config
    check = bool(tr.get("iteration_reference"))
    for side, seeds in (("program", args.calibrate),
                        ("control", args.control_seeds)):
        for seed in seeds:
            pool = stencil.rhs_pool(data, offsets, int(tr["pool"]), columns,
                                    seed, tr.get("base_seed"))
            t = time.perf_counter()
            if side == "program":
                keep = traffic.Reservoir(seed, int(tr["check_solves"]))
                count = int(tr["check_solves"])
                solves = _solve_loop(program, A_of, pool,
                                     traffic.requests(seed, tr), ranks, keep,
                                     lambda s: len(s) >= count)
                kept = keep.items
            else:
                j = _iteration_pool_index(seed, range(len(pool)))
                solves, kept = [], []
                for p in (j, (j + 1) % len(pool)):
                    x, it, conv = None, 0, False
                    if ranks.rank == 0:   # one process: the whole system
                        x, it, conv = judge.reference_solve(
                            cell.method, cfg, tr["kwargs"], data, offsets,
                            pool[p], torch.bfloat16)
                        x = x.to(data.dtype)
                    solves.append(dict(pool_index=p, converged=conv,
                                       iterations=it, wall_s=0.0))
                    kept.append((p, x, conv, None))
            solve_s = time.perf_counter() - t
            verdict = _check(cell, data, offsets, pool, kept, solves, ranks,
                             seed, check, whole=side == "control")
            if ranks.rank == 0:
                correct, failed, checks, notes = verdict
                print(json.dumps({"seed": seed, "side": side,
                                  "correct": correct, "failed": failed,
                                  "solves": len(solves),
                                  "solve_s": solve_s, "checks": checks,
                                  "notes": notes}), flush=True)
            del pool, kept, solves
            gc.collect()
    if ranks.world > 1:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.core import cells

    cell = cells.load_cell(ROOT, cells.load_benchmark(ROOT), args.workload)
    if args.rank is not None:
        return worker(args, cell)
    if not args.cpu_rehearsal and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _say(f"[bench] cell {cell.name} needs {cell.chips} CUDA device(s); "
             f"this machine shows {have}")
        return 2
    if cell.chips == 1:
        args.rank, args.world = 0, 1
        return worker(args, cell)
    return launch(args, cell)


if __name__ == "__main__":
    sys.exit(main())
