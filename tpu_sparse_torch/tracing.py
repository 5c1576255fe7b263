"""Spans and counters of the port: which layer a solve's host time goes
to, on the profiler's clock, and what the solve did.

Spans. ``with span("tsp.solver.cg"): ...`` marks a layer's work. A span
is on only while torch's profiler records (``torch.profiler.profile``,
``utils.timing.trace()``); the test is the profiler's own enabled flag,
so this module has no switch of its own. Off, a span is one flag check
and a shared object whose enter and exit do nothing: no allocation, no
clock read, no ``record_function``. On, a span opens
``torch.profiler.record_function(name)``, so that it lands in the
profiler's Chrome trace as a ``user_annotation`` event on the clock of
the card's kernels, and keeps one ``Record`` here (``spans()``): its name,
start and end (``time.perf_counter_ns()``), the index of its parent
record (-1 for none), the sequence id of the outermost ``tsp.solve`` span
it ran under (one id a request; None outside a solve) and its attributes.
At most ``CAP`` records are kept until ``reset()``; spans past it are
counted in ``tracing.dropped``. A ``tsp.solve`` record closes with the
counters that changed over it (``Record.counters``, name -> delta).

Counters. Plain integer dicts, bumped where the event happens whether or
not a profiler runs (one dict add at the site). Each module's dict is a
group of one registry (``group``) and stays that module's own object
(``cuda_cg.LAUNCHES``, ``kernels.CAST_COUNTS``, ...). ``counters()`` reads
every group as one flat ``"<group>.<key>"`` -> int map; ``reset()`` clears
the records and zeroes every counter.

The names, one prefix a layer of the two benchmark cells' paths:

* ``tsp.solve``: ``SparseSolver.solve``, the router (attributes backend,
  method, precision, n, dtype);
* ``tsp.router.build.<cache>``: a build after a cache miss of the router
  (``amg``, ``M``, ``cast``, ``rcm``, ``factors``);
* ``tsp.solver.<method>``: a Krylov loop (``cg``, ``bicgstab``,
  ``gmres``, ``fused_cg``, ``fused_bicgstab``); ``tsp.solver.block``: one
  fused block of K iterations and its history read, or one GMRES restart
  cycle; ``tsp.solver.iter``: one iteration of a torch-op loop;
* ``tsp.solver.refine``: a mixed-precision refinement (``solvers.mixed``;
  attributes method, inner_dtype); ``tsp.solver.refine.sweep``: one sweep
  (attribute i), its inner solve's span under it;
  ``tsp.solver.refine.rescue``: the full-precision rescue;
* ``tsp.precond.vcycle``: ``precond.amg.v_cycle``, or the replay of a
  captured cycle (attribute ``graph=True``, no children);
  ``tsp.precond.level<i>``: level i's smoothing, residual, restriction and
  prolongation (its coarser levels are its children), recorded by eager
  cycles and by a capture; ``tsp.precond.coarse``: the coarse solve.

and the solver counters ``solver.iterations_run`` (iterations the loops
ran, masked ones included: a fused block counts all its K) and
``solver.host_syncs`` (reads of the solvers' device state by the host,
each through ``host_read``); the AMG preconditioner's applies on the card
count in ``precond.graph_replays``, ``precond.graph_captures`` and
``precond.graph_eager`` (``precond.amg``); the refinement's in
``refine.sweeps``, ``refine.rescues``, ``refine.residuals`` and
``refine.operator_casts`` (``solvers.mixed``).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import Counter

import torch
from torch.autograd import profiler as _profiler

CAP = 200_000    # records kept until reset()
ROOT = "tsp.solve"

_records: list = []
_groups: list = []   # (prefix, dict), in registration order
_local = threading.local()
_solve_ids = itertools.count(1)


def group(prefix: str, counts: dict) -> dict:
    """Register ``counts`` as the counter group ``prefix`` and return the
    same dict: the module keeps it under its own name and bumps it."""
    _groups.append((prefix, counts))
    return counts


SOLVER = group("solver", {"iterations_run": 0, "host_syncs": 0})
_TRACING = group("tracing", {"dropped": 0})


def counters() -> dict:
    """Every counter of every group: ``"<group>.<key>"`` -> int (a tuple
    key is joined by dots)."""
    out = {}
    for prefix, counts in _groups:
        for k, v in counts.items():
            key = ".".join(map(str, k)) if isinstance(k, tuple) else k
            out[f"{prefix}.{key}"] = int(v)
    return out


def reset() -> None:
    """Drop the span records and zero every counter (between solves)."""
    _records.clear()
    _local.__dict__.pop("stack", None)
    for _, counts in _groups:
        if isinstance(counts, Counter):
            counts.clear()
        else:
            for k in counts:
                counts[k] = 0


def host_read(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host (``t.cpu()``), counted in ``solver.host_syncs``:
    on the card the host waits here for every launch queued before it.
    The loops of ``solvers/``, the fused loops, the stationary AMG loop
    and ``SolverResult`` read the card through this."""
    SOLVER["host_syncs"] += 1
    return t.cpu()


class Record:
    """One span: name, start_ns / end_ns, parent (index into ``spans()``,
    -1 for none), solve_id, root (it opened its solve id), attrs, and on a
    ``tsp.solve`` record the counters that changed over it."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "solve_id", "root",
                 "attrs", "counters", "child_ns")

    def __init__(self, name, parent, solve_id, root, attrs):
        self.name, self.parent, self.solve_id = name, parent, solve_id
        self.root, self.attrs = root, attrs
        self.start_ns = self.end_ns = 0
        self.counters = None
        self.child_ns = 0

    def bump(self, name: str, n: int = 1) -> None:
        """Add to a closed ``tsp.solve`` record's counters what its request
        did after the span closed (its result read on the host)."""
        if self.counters is not None:
            self.counters[name] = self.counters.get(name, 0) + n

    def __repr__(self):
        return (f"Record({self.name!r}, {(self.end_ns - self.start_ns) / 1e6}"
                f" ms, parent={self.parent}, solve={self.solve_id})")


class _Off:
    """The span while no profiler records: does nothing."""

    __slots__ = ()
    record = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("record", "_rf", "_before")

    def __init__(self, name: str, attrs: dict):
        self.record = Record(name, -1, None, False, attrs)
        self._before = None

    def __enter__(self):
        rec = self.record
        stack = _stack()
        if stack:
            rec.parent, rec.solve_id = stack[-1][0], stack[-1][1].solve_id
        if rec.name == ROOT and rec.solve_id is None:
            rec.root, rec.solve_id = True, next(_solve_ids)
        index = len(_records)
        if index < CAP:
            _records.append(rec)
        else:
            index = -1
            _TRACING["dropped"] += 1
        if rec.name == ROOT:
            self._before = counters()
        self._rf = torch.profiler.record_function(rec.name)
        self._rf.__enter__()
        stack.append((index, rec))
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1][1] is rec:
            stack.pop()
            if stack:
                stack[-1][1].child_ns += rec.end_ns - rec.start_ns
        if self._before is not None:
            before = self._before
            rec.counters = {k: v - before.get(k, 0)
                            for k, v in counters().items()
                            if v != before.get(k, 0)}
        return False


def span(name: str, **attrs):
    """A context manager marking a layer's work (see the module's
    docstring); ``as`` gives an object whose ``record`` is the span's
    ``Record`` (None while off)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def traced(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)

        return inner

    return wrap


def annotate(**attrs) -> None:
    """Add attributes to the innermost open span of this thread."""
    stack = getattr(_local, "stack", None)
    if _profiler._is_profiler_enabled and stack:
        stack[-1][1].attrs.update(attrs)


def enabled() -> bool:
    """Whether spans record now (torch's profiler is on)."""
    return bool(_profiler._is_profiler_enabled)


def spans() -> list:
    """The records kept since the last ``reset()``, in opening order."""
    return list(_records)


def solves() -> list:
    """The outermost ``tsp.solve`` records: one a request."""
    return [r for r in _records if r.root]


def self_ns(record: Record) -> int:
    """A record's duration less the union of its children's (a span's
    children run one after another on its thread, so their union is
    their sum)."""
    return record.end_ns - record.start_ns - record.child_ns


_LEVELS = tuple(f"tsp.precond.level{i}" for i in range(64))


def level_name(i: int) -> str:
    """``tsp.precond.level<i>``, made once."""
    return _LEVELS[i] if i < len(_LEVELS) else f"tsp.precond.level{i}"


__all__ = ["CAP", "ROOT", "Record", "SOLVER", "annotate", "counters",
           "enabled", "group", "host_read", "level_name", "reset", "self_ns",
           "solves", "span", "spans", "traced"]
