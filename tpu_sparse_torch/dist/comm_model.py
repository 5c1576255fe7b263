"""Counted communication volume of the distributed layer, and a model of
its cost on a multi-card host.

Counterpart of ``tpu_sparse/dist/comm_model.py``. JAX counts collectives
by parsing the optimized HLO of a compiled program; the port compiles no
program, so it counts what it sends: every collective helper of
``dist.mesh.RowMesh`` (the halo exchanges of ``dist.spmv``, the all-gathers
of the all_gather SpMVs and the AMG transfers, the all-reduced dot
products of ``dist.solvers``) calls ``record(kind, bytes)``. The kinds keep
the HLO names: ``collective-permute`` (one per shift of a halo exchange,
its bytes the strip each rank sends), ``all-gather`` (the gathered size)
and ``all-reduce`` (the reduced tensor). ``hlo_collective_stats`` has no
counterpart: there is no HLO, and the recorder is that capability.

Per-iteration figures are differences of totals: ``measure_per_iteration``
runs a solve for two iteration caps that the solve does not reach and
divides the difference of the counts by the difference of the caps, which
leaves exactly what one loop iteration sends (set-up and final check
cancel). The counts are plain integers bumped on the host, so they cost a
dictionary update per collective.

The hardware model takes NVIDIA's published H100 SXM numbers (H100 Tensor
Core GPU data sheet): HBM3 at 3.35 TB/s and NVLink 4 at 900 GB/s per GPU,
both directions together (450 GB/s each way), at the 700 W power limit.
The data sheet gives no collective latency; ``hop_latency_us`` defaults
to 0 (a pure bandwidth model) and takes the latency a run measured, for
example the exchange time ``dist.scaling_probe`` prints.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable, Dict, List, Optional

from tpu_sparse_torch import tracing

# (kind, bytes) -> calls, since the process started or tracing.reset()
_COUNTS: Counter = tracing.group("comm", Counter())


def record(kind: str, nbytes: int) -> None:
    """Count one collective of ``kind`` moving ``nbytes`` per rank."""
    _COUNTS[(kind, int(nbytes))] += 1


def snapshot() -> Counter:
    return Counter(_COUNTS)


@dataclasses.dataclass
class CollectiveOp:
    kind: str      # all-reduce / all-gather / collective-permute
    bytes: int     # per-rank bytes of one call (full gathered size for AG)
    calls: float   # calls (per iteration: may be fractional)


@dataclasses.dataclass
class CollectiveStats:
    ops: List[CollectiveOp]
    result: Any = None  # what the measured call returned

    @staticmethod
    def between(before: Counter, after: Counter, per: float = 1.0,
                result: Any = None) -> "CollectiveStats":
        ops = [CollectiveOp(k, b, (after[(k, b)] - before.get((k, b), 0))
                            / per)
               for (k, b) in sorted(after)
               if after[(k, b)] != before.get((k, b), 0)]
        return CollectiveStats(ops, result)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{kind: {count, bytes}} summed over the ops."""
        out: Dict[str, Dict[str, float]] = {}
        for o in self.ops:
            d = out.setdefault(o.kind, {"count": 0, "bytes": 0})
            d["count"] += o.calls
            d["bytes"] += o.calls * o.bytes
        return out


def measure_collectives(fn: Callable, *args, **kwargs) -> CollectiveStats:
    """Run ``fn(*args, **kwargs)`` and return the collectives it made (its
    return value in ``.result``)."""
    before = snapshot()
    result = fn(*args, **kwargs)
    return CollectiveStats.between(before, snapshot(), result=result)


def measure_per_iteration(run: Callable[[int], Any], lo: int = 16,
                          hi: int = 32) -> CollectiveStats:
    """The collectives of one solver iteration: ``run(maxiter)`` for
    ``lo`` and ``hi`` (both below the iterations the solve needs; the
    loops check the host every 16 iterations, so multiples of 16 run
    exactly that many bodies), the difference of the counts divided by
    ``hi - lo``."""
    s0 = snapshot()
    run(lo)
    s1 = snapshot()
    run(hi)
    s2 = snapshot()
    low = s1 - s0
    high = s2 - s1
    return CollectiveStats.between(low, high, per=float(hi - lo))


# -- hardware model ---------------------------------------------------------


@dataclasses.dataclass
class HardwareModel:
    """One H100 SXM of a host whose cards are joined all to all by NVLink
    (data sheet numbers, see the module docstring)."""

    hbm_gbs: float = 3350.0
    link_gbs: float = 450.0        # NVLink 4, one direction, per card
    hop_latency_us: float = 0.0    # not a data-sheet number: pass a measured one


def _reduction_hops(n_dev: int, mesh_dims: Optional[tuple]) -> int:
    """Ring all-reduce hop count: 2(N-1) on one ring; over several mesh
    axes the reduction runs per axis: sum 2(d-1)."""
    if not mesh_dims:
        return 2 * (n_dev - 1)
    return sum(2 * (d - 1) for d in mesh_dims)


def comm_time_per_iteration(stats: CollectiveStats, n_dev: int,
                            hw: HardwareModel = HardwareModel(),
                            mesh_dims: Optional[tuple] = None) -> float:
    """Seconds of link time per iteration for the per-iteration ``stats``
    at ``n_dev`` cards (ring algorithms)."""
    bw = hw.link_gbs * 1e9
    lat = hw.hop_latency_us * 1e-6
    t = 0.0
    for op in stats.ops:
        if op.kind == "collective-permute":
            c = op.bytes / bw + lat
        elif op.kind == "all-gather":
            c = op.bytes * (n_dev - 1) / n_dev / bw + (n_dev - 1) * lat
        elif op.kind == "all-reduce":
            c = (2.0 * op.bytes * (n_dev - 1) / n_dev / bw
                 + _reduction_hops(n_dev, mesh_dims) * lat)
        else:
            c = op.bytes * (n_dev - 1) / n_dev / bw + (n_dev - 1) * lat
        t += op.calls * c
    return t


def modeled_weak_scaling_efficiency(
        stats: CollectiveStats, n_dev: int, local_hbm_bytes: float,
        hw: HardwareModel = HardwareModel(),
        mesh_dims: Optional[tuple] = None,
        overlap: float = 0.0) -> float:
    """Weak-scaling efficiency = t_compute / (t_compute + exposed comm):
    t_compute the per-card HBM-bound time of ``local_hbm_bytes``, comm the
    per-iteration ``stats`` on the hardware model, ``overlap`` in [0, 1]
    the share of it hidden behind compute (0: fully exposed)."""
    t_comp = local_hbm_bytes / (hw.hbm_gbs * 1e9)
    t_comm = comm_time_per_iteration(stats, n_dev, hw, mesh_dims)
    exposed = max(0.0, t_comm * (1.0 - overlap))
    return t_comp / (t_comp + exposed)


def spmv_local_hbm_bytes(nnz_local: int, rows_local: int,
                         dtype_bytes: int = 4) -> float:
    """Device-memory traffic of one local stencil SpMV: matrix data, read
    x, write y (+ the halo-extended x read, ~ x)."""
    return dtype_bytes * (nnz_local + 3 * rows_local)
