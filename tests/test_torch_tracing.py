"""The port's spans and counters (``tpu_sparse_torch.tracing``): off
without a profiler, the span tree and its Chrome-trace events under one,
the counters of iterations run and host reads, the registry of the
modules' counters. The last test runs on the card only: torch's sync
debug mode against ``solver.host_syncs``."""

import json
import math
import warnings

import numpy as np
import pytest
import torch
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)
from torch.profiler import ProfilerActivity, profile

import tpu_sparse_torch
from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels import cuda_cg
from tpu_sparse_torch.solvers import krylov
from tpu_sparse_torch.sparse import generators as gen


def _system(nx=10):
    A = gen.poisson3d_27pt(nx, dtype=np.float32, device="cpu")
    b = torch.from_numpy(np.random.default_rng(nx).standard_normal(
        A.shape[0]).astype(np.float32))
    return A, b


def _run(fn):
    """fn() under torch's profiler (CPU), with the records and counters
    cleared first."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _chain(rec, recs):
    names = [rec.name]
    while rec.parent >= 0:
        rec = recs[rec.parent]
        names.append(rec.name)
    return names[::-1]


def test_off_without_a_profiler_records_nothing(monkeypatch):
    """No profiler: a solve keeps no record, every span is the one shared
    no-op, and record_function is never entered."""
    A, b = _system()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracing.reset()
    for kw in ({"method": "cg"}, {"backend": "amg"}):
        x, res = tpu_sparse_torch.solve(A, b, tol=1e-6, **kw)
        assert res.converged
    assert tracing.spans() == [] and tracing.solves() == []
    off = tracing.span("tsp.solve")
    assert off is tracing.span("tsp.solver.iter", k=1)
    assert off.record is None and not tracing.enabled()
    with off:
        pass
    assert tracing.counters()["solver.iterations_run"] > 0


def test_amg_solve_span_tree_and_chrome_trace(tmp_path):
    """An AMG solve under torch.profiler: tsp.solve -> tsp.solver.cg ->
    tsp.solver.iter -> tsp.precond.vcycle, one solve id, the same names as
    user_annotation events in the Chrome trace; off the card every cycle
    is eager (no ``graph`` attribute, no graph counter moves). The level
    chain tsp.precond.vcycle -> level0 -> level1 and the coarse solve, by
    ``v_cycle`` directly: on the card a solve's cycles replay a captured
    graph and record no level spans
    (``test_replayed_amg_solve_spans``)."""
    from tpu_sparse_torch.precond import amg as tamg

    A, b = _system()
    tpu_sparse_torch.solve(A, b, backend="amg")  # the hierarchy, untraced
    (x, res), prof = _run(lambda: tpu_sparse_torch.solve(A, b,
                                                         backend="amg"))
    recs = tracing.spans()
    roots = tracing.solves()
    assert len(roots) == 1 and roots[0] is recs[0]
    assert {r.solve_id for r in recs} == {roots[0].solve_id}
    assert all(r.end_ns >= r.start_ns > 0 for r in recs)
    cycles = [r for r in recs if r.name == "tsp.precond.vcycle"]
    assert ("tsp.solve", "tsp.solver.cg", "tsp.solver.iter",
            "tsp.precond.vcycle") in {tuple(_chain(r, recs)) for r in cycles}
    assert not any("graph" in r.attrs for r in cycles)
    assert not any(k.startswith("precond.") for k in roots[0].counters)
    names = {r.name for r in recs}
    assert roots[0].attrs["backend"] == "amg"
    assert roots[0].attrs["method"] == "cg"
    assert roots[0].attrs["n"] == A.shape[0]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert names <= annotated
    # a record's self time leaves out its children
    root = roots[0]
    inner = sum(r.end_ns - r.start_ns for r in recs if r.parent == 0)
    assert tracing.self_ns(root) == root.end_ns - root.start_ns - inner
    assert 0 <= tracing.self_ns(root) < root.end_ns - root.start_ns
    # the reported iterations, read once on the host, land on the record
    assert root.counters["solver.host_syncs"] >= 2
    assert res.iterations == root.attrs["iterations"]
    # the eager cycle's level chain
    M = tamg.amg_preconditioner(A)
    _run(lambda: tamg.v_cycle(M.hier, b, pre_sweeps=1, post_sweeps=1))
    recs = tracing.spans()
    assert recs[0].name == "tsp.precond.vcycle" and recs[0].parent == -1
    level1 = [r for r in recs if r.name == "tsp.precond.level1"]
    assert [tuple(_chain(r, recs)) for r in level1] == [
        ("tsp.precond.vcycle", "tsp.precond.level0", "tsp.precond.level1")]
    coarse, = [r for r in recs if r.name == "tsp.precond.coarse"]
    assert _chain(coarse, recs)[:2] == ["tsp.precond.vcycle",
                                        "tsp.precond.level0"]
    assert len(_chain(coarse, recs)) == M.hier.num_levels + 1


def test_cg_loop_counts_whole_checks():
    """_cg_loop runs CHECK_EVERY iterations between two reads of its
    condition, masked ones included: the counter counts them all."""
    A, b = _system(8)
    tracing.reset()
    x, info, k, _ = krylov.cg_full(A, b, tol=1e-6)
    k = int(k)
    ran = tracing.counters()["solver.iterations_run"]
    assert int(info) == 0 and 0 < k
    assert ran == krylov.CHECK_EVERY * math.ceil(k / krylov.CHECK_EVERY)
    # the condition is read once before each round and once after the last
    assert tracing.counters()["solver.host_syncs"] == \
        ran // krylov.CHECK_EVERY + 1


@pytest.mark.parametrize("K", [4, 16])
def test_fused_cg_counts_whole_blocks(K):
    """fused_cg_ext (its plain path on the CPU) runs whole blocks of K:
    K x blocks iterations, ||b|| and one history read per block."""
    A, b = _system(8)
    op = cuda_cg.make_fused_operator(A)
    tracing.reset()
    x, info, it, res = cuda_cg.fused_cg_ext(op, b, tol=1e-6, block_iters=K)
    blocks = math.ceil(int(it) / K)
    assert int(info) == 0
    assert tracing.counters()["solver.iterations_run"] == K * blocks
    assert tracing.counters()["solver.host_syncs"] == 1 + blocks


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_solve_record_carries_the_counter_deltas(method):
    """The tsp.solve record closes with what the counters gained over it,
    and the result's read on the host is added to it afterwards."""
    A, b = _system(8)
    kw = {"M": "jacobi"} if method != "cg" else {}
    tpu_sparse_torch.solve(A, b, method=method, **kw)   # M, untraced
    (x, res), _ = _run(lambda: tpu_sparse_torch.solve(
        A, b, method=method, tol=1e-6, **kw))
    root, = tracing.solves()
    before = dict(root.counters)
    assert res.converged
    assert root.counters["solver.host_syncs"] == \
        before["solver.host_syncs"] + 1
    assert root.counters["solver.iterations_run"] == \
        tracing.counters()["solver.iterations_run"]
    assert root.counters["solver.iterations_run"] >= res.iterations > 0
    assert tracing.counters()["solver.host_syncs"] == \
        root.counters["solver.host_syncs"]
    assert {r.name for r in tracing.spans()} >= {
        "tsp.solve", f"tsp.solver.{method}"}


def test_refinement_spans_and_counters():
    """A float64 solve on the default route (precision="auto"): tsp.solve ->
    tsp.solver.refine -> tsp.solver.refine.sweep -> tsp.solver.cg, one sweep
    span a ``refine.sweeps``, the ``refine.*`` deltas on the tsp.solve
    record (an outer residual before the sweeps and two a sweep, one cast
    of the values). Then a refinement whose float32 sweep stalls (it
    returns no update) runs the rescue, in its own span, under the same
    refinement; the column-batched refinement records the same tree."""
    from tpu_sparse_torch.solvers import batched, mixed

    A32, b32 = _system(8)
    A, b = A32.with_data(A32.data.double()), b32.double()
    (x, res), _ = _run(lambda: tpu_sparse_torch.solve(A, b, tol=1e-8))
    assert res.converged
    recs = tracing.spans()
    root, = tracing.solves()
    refine, = [r for r in recs if r.name == "tsp.solver.refine"]
    assert refine.attrs == {"method": "cg", "inner_dtype": "torch.float32"}
    sweeps = [i for i, r in enumerate(recs)
              if r.name == "tsp.solver.refine.sweep"]
    assert [recs[i].attrs["i"] for i in sweeps] == list(range(len(sweeps)))
    for i in sweeps:
        assert _chain(recs[i], recs) == ["tsp.solve", "tsp.solver.refine",
                                         "tsp.solver.refine.sweep"]
        inner, = [r for r in recs if r.parent == i]
        assert inner.name == "tsp.solver.cg"
    n = len(sweeps)
    assert n >= 1
    assert {k: v for k, v in root.counters.items()
            if k.startswith("refine.")} == {
        "refine.sweeps": n, "refine.residuals": 1 + 2 * n,
        "refine.operator_casts": 1}

    def stall_f32(A_, b_, x0=None, **kw):
        if b_.dtype == torch.float32:
            return torch.zeros_like(b_), 0, torch.tensor(3), None
        return krylov.cg_full(A_, b_, x0, **kw)

    (x, info, it, _), _ = _run(lambda: mixed.refined_solve(
        stall_f32, A, b, tol=1e-8))
    assert int(info) == 0
    recs = tracing.spans()
    rescue, = [r for r in recs if r.name == "tsp.solver.refine.rescue"]
    assert _chain(rescue, recs) == ["tsp.solver.refine",
                                    "tsp.solver.refine.rescue"]
    assert recs[rescue.parent].attrs["method"] == "stall_f32"
    assert [r.name for r in recs if r.parent == recs.index(rescue)] == [
        "tsp.solver.cg"]
    counts = tracing.counters()
    assert (counts["refine.sweeps"], counts["refine.rescues"],
            counts["refine.residuals"]) == (1, 1, 5)
    B = torch.stack([b, -2 * b], 1)
    _run(lambda: mixed.batch_refined_solve(batched.batch_cg, A, B, tol=1e-8))
    recs = tracing.spans()
    refine, = [r for r in recs if r.name == "tsp.solver.refine"]
    assert refine.attrs["method"] == "cg"
    sweeps = [r for r in recs if r.name == "tsp.solver.refine.sweep"]
    assert len(sweeps) == tracing.counters()["refine.sweeps"] >= 1
    assert all(recs[r.parent] is refine for r in sweeps)


def test_router_build_span_on_a_cache_miss():
    """A preconditioner built on a cache miss runs in its build span; the
    next solve hits the cache and builds nothing."""
    A, b = _system(8)
    solver = tpu_sparse_torch.SparseSolver()
    _run(lambda: solver.solve(A, b, M="jacobi"))
    built = [r for r in tracing.spans() if r.name == "tsp.router.build.M"]
    assert len(built) == 1 and built[0].parent == 0
    _run(lambda: solver.solve(A, b, M="jacobi"))
    assert not [r for r in tracing.spans()
                if r.name.startswith("tsp.router.build.")]


def test_registry_holds_every_module_counter():
    """Each module's counter dict is its registry group, the same object,
    and one tracing.reset() zeroes all of them."""
    from tpu_sparse_torch import kernels
    from tpu_sparse_torch.dist import comm_model
    from tpu_sparse_torch.kernels import (cuda_bell, cuda_bicgstab,
                                          cuda_cwell, cuda_spmv)
    from tpu_sparse_torch.sparse import cwell_compact

    groups = [d for _, d in tracing._groups]
    for counts in (cuda_spmv.LAUNCHES, cuda_cg.LAUNCHES,
                   cuda_bicgstab.LAUNCHES, cuda_cwell.LAUNCHES,
                   cuda_bell.LAUNCHES, kernels.CAST_COUNTS,
                   cwell_compact.COUNTS, comm_model._COUNTS,
                   tracing.SOLVER):
        assert any(counts is g for g in groups)
    assert cuda_cwell.PLAN_COUNTS is cwell_compact.COUNTS
    cuda_cg.LAUNCHES["dia_cg_update"] += 3
    kernels.CAST_COUNTS["values_casts"] += 1
    cwell_compact.COUNTS["plan_builds"] += 2
    comm_model.record("all-reduce", 8)
    flat = tracing.counters()
    assert flat["launches.dia_cg_update"] >= 3
    assert flat["comm.all-reduce.8"] >= 1
    assert comm_model.snapshot()[("all-reduce", 8)] >= 1
    tracing.reset()
    assert set(tracing.counters().values()) == {0}
    assert comm_model.snapshot() == {}
    assert cuda_cg.LAUNCHES["dia_cg_update"] == 0


def test_records_past_the_cap_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 2)

    def nest():
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
        with tracing.span("d"):
            pass

    _run(nest)
    assert [r.name for r in tracing.spans()] == ["a", "b"]
    assert tracing.counters()["tracing.dropped"] == 2
    a, b = tracing.spans()
    assert b.parent == 0 and b.solve_id is None and not a.root


@pytest.mark.cuda
def test_replayed_amg_solve_spans():
    """On the card, an AMG solve after the one that captured its cycle:
    every tsp.precond.vcycle span is a replay (``graph=True``) with no
    span under it, no level span is recorded, and the solve record
    carries one ``precond.graph_replays`` a cycle and no eager apply or
    capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    A = gen.poisson3d_27pt(24, dtype=np.float32, device=dev)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        A.shape[0]).astype(np.float32)).to(dev)
    # the hierarchy, the key's eager apply and its capture
    tpu_sparse_torch.solve(A, b, backend="amg")
    (x, res), _ = _run(lambda: tpu_sparse_torch.solve(A, b, backend="amg"))
    assert res.converged
    recs = tracing.spans()
    root, = tracing.solves()
    cycles = [i for i, r in enumerate(recs) if r.name == "tsp.precond.vcycle"]
    assert cycles and all(recs[i].attrs.get("graph") is True for i in cycles)
    assert not [r for r in recs if r.parent in cycles]
    assert not [r for r in recs if r.name.startswith("tsp.precond.level")
                or r.name == "tsp.precond.coarse"]
    assert root.counters["precond.graph_replays"] == len(cycles)
    assert "precond.graph_eager" not in root.counters
    assert "precond.graph_captures" not in root.counters


@pytest.mark.cuda
def test_host_syncs_equal_torch_sync_count():
    """On the card: inside one CG solve (the fused kernels) and one AMG
    solve, with the result read, solver.host_syncs equals the
    synchronizing calls torch's sync debug mode reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    A = gen.poisson3d_27pt(24, dtype=np.float32, device=dev)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.shape[0]).astype(np.float32)).to(dev)
    for kw in ({"method": "cg"}, {"backend": "amg"}):
        for _ in range(2):   # builds, plans, hierarchy: set-up
            _, res = tpu_sparse_torch.solve(A, b, tol=1e-6, **kw)
            assert res.converged
        torch.cuda.synchronize()
        # the mode's first setting in a process may warn once itself
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                before = tracing.counters()["solver.host_syncs"]
                _, res = tpu_sparse_torch.solve(A, b, tol=1e-6, **kw)
                converged = res.converged
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        counted = tracing.counters()["solver.host_syncs"] - before
        assert converged
        assert counted == len(syncs), (kw, counted, [
            f"{w.filename}:{w.lineno}" for w in syncs])
