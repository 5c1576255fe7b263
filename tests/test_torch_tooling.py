"""The port's tooling and the rest of its public API against the JAX
package on the CPU: residual helpers, the random generators and
``dense_to_coo``, the transpose and padded plain SpMVs, the solver enums,
checkpoints (each package loads the other's), timing, the availability
report, the benchmark harness and its reports, ``run.py`` and the public
``native`` module. The same numpy inputs go to both packages."""

import csv
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_sparse_torch
from tpu_sparse import utils as jutils
from tpu_sparse.api import solver as jsolver
from tpu_sparse.bench import harness as jharness
from tpu_sparse.kernels import reference as jref
from tpu_sparse.sparse import convert as jconvert
from tpu_sparse.sparse import cwell as jcwell
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.utils import checkpoint as jckpt
from tpu_sparse_torch import native, run, utils
from tpu_sparse_torch.api import availability
from tpu_sparse_torch.api import solver as tsolver
from tpu_sparse_torch.bench import harness as tharness
from tpu_sparse_torch.kernels import reference as tref
from tpu_sparse_torch.sparse import convert as tconvert
from tpu_sparse_torch.sparse import generators as tgen
from tpu_sparse_torch.utils import checkpoint as tckpt
from tpu_sparse_torch.utils import timing
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- availability ------------------------------------------------------------

@pytest.mark.parametrize("count,expect", [(4, True), (1, False)])
def test_distributed_availability_follows_the_device_count(monkeypatch,
                                                           count, expect):
    """JAX reports distributed solvers when it sees more than one device;
    the port did not, whatever the host held."""
    monkeypatch.setattr(availability, "device_count", lambda: count)
    assert availability.check_distributed_available() is expect
    assert availability.availability_dict()["distributed"] is expect


def test_device_count_without_a_card_is_one():
    assert availability.device_count() == (torch.cuda.device_count()
                                           if torch.cuda.is_available()
                                           else 1)


# -- residuals ---------------------------------------------------------------

def _operands(kind):
    rng = np.random.default_rng(3)
    if kind == "dia":
        Aj = jgen.poisson2d(6)
        At = tgen.poisson2d(6, device="cpu")
    elif kind == "csr":
        Aj = jgen.random_csr(40, 40, density=0.1, seed=5)
        At = tgen.random_csr(40, 40, density=0.1, seed=5, device="cpu")
    else:
        Aj = jgen.random_spd_dense(30, seed=2)
        At = tgen.random_spd_dense(30, seed=2, device="cpu")
    n = At.shape[0]
    x, b = rng.standard_normal(n), rng.standard_normal(n)
    return Aj, At, x, b


@pytest.mark.parametrize("kind", ["dia", "csr", "dense"])
def test_residuals_match_jax(kind):
    Aj, At, x, b = _operands(kind)
    rj = np.asarray(jutils.compute_residual(Aj, jnp.asarray(x),
                                            jnp.asarray(b)))
    rt = utils.compute_residual(At, torch.from_numpy(x),
                                torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=1e-12, atol=1e-12)
    qj = float(jutils.relative_residual(Aj, jnp.asarray(x), jnp.asarray(b)))
    qt = float(utils.relative_residual(At, torch.from_numpy(x),
                                       torch.from_numpy(b)))
    np.testing.assert_allclose(qt, qj, rtol=1e-12)


def test_relative_residual_of_a_zero_b_divides_by_one():
    A = tgen.tridiagonal(5, device="cpu")
    x = torch.ones(5, dtype=torch.float64)
    q = utils.relative_residual(A, x, torch.zeros(5, dtype=torch.float64))
    assert float(q) == pytest.approx(float(torch.linalg.vector_norm(A @ x)))


# -- generators and conversions ----------------------------------------------

@pytest.mark.parametrize("n,m,density,seed,dtype,dominant", [
    (50, 50, 0.05, 0, np.float64, True),
    (50, 50, 0.05, 1, np.float32, False),
    (30, 70, 0.1, 2, np.float64, True),
])
def test_random_csr_bit_for_bit(n, m, density, seed, dtype, dominant):
    Aj = jgen.random_csr(n, m, density=density, seed=seed, dtype=dtype,
                         dominant=dominant)
    At = tgen.random_csr(n, m, density=density, seed=seed, dtype=dtype,
                         dominant=dominant, device="cpu")
    assert At.shape == Aj.shape
    for a, b in ((At.data, Aj.data), (At.indices, Aj.indices),
                 (At.indptr, Aj.indptr)):
        assert _np(a).dtype == np.asarray(b).dtype
        assert np.array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("n,seed,dtype", [(20, 0, np.float64),
                                          (33, 7, np.float32)])
def test_random_spd_dense_bit_for_bit(n, seed, dtype):
    Aj = np.asarray(jgen.random_spd_dense(n, seed=seed, dtype=dtype))
    At = tgen.random_spd_dense(n, seed=seed, dtype=dtype, device="cpu")
    assert At.numpy().dtype == Aj.dtype
    assert np.array_equal(At.numpy(), Aj)


@pytest.mark.parametrize("tol", [0.0, 0.5])
def test_dense_to_coo_bit_for_bit(tol):
    D = np.random.default_rng(4).standard_normal((9, 7))
    D[D < 0.2] = 0.0
    Cj = jconvert.dense_to_coo(jnp.asarray(D), tol=tol)
    for src in (D, torch.from_numpy(D)):
        Ct = tconvert.dense_to_coo(src, tol=tol)
        assert Ct.shape == Cj.shape
        for a, b in ((Ct.data, Cj.data), (Ct.row, Cj.row),
                     (Ct.col, Cj.col)):
            assert a.numpy().dtype == np.asarray(b).dtype
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_sparse_package_reexports_the_converters():
    from tpu_sparse_torch import sparse

    for name in ("coo_to_csr", "csr_from_arrays", "csr_to_dia",
                 "dense_to_coo", "dense_to_csr", "dia_from_offsets",
                 "to_csr"):
        assert getattr(sparse, name) is getattr(tconvert, name)


# -- plain SpMVs -------------------------------------------------------------

def test_csr_spmv_transpose_matches_jax():
    Aj = jgen.random_csr(40, 60, density=0.08, seed=9, dominant=False)
    At = tgen.random_csr(40, 60, density=0.08, seed=9, dominant=False,
                         device="cpu")
    x = np.random.default_rng(1).standard_normal(40)
    yj = np.asarray(jref.csr_spmv_transpose(Aj, jnp.asarray(x)))
    yt = tref.csr_spmv_transpose(At, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("offsets,shape", [((-2, 0, 3), (12, 12)),
                                           ((-1, 1, 4), (10, 14)),
                                           ((0, 2), (14, 9))])
def test_dia_spmv_padded_matches_jax(offsets, shape):
    rng = np.random.default_rng(2)
    data = rng.standard_normal((len(offsets), shape[0]))
    x = rng.standard_normal(shape[1])
    Aj = jconvert.dia_from_offsets(offsets, data, shape)
    At = tconvert.dia_from_offsets(offsets, data, shape, device="cpu")
    yj = np.asarray(jref.dia_spmv_padded(Aj, jnp.asarray(x)))
    yt = tref.dia_spmv_padded(At, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-13)


# -- the solver enums ----------------------------------------------------------

@pytest.mark.parametrize("name", ["SolverMethod", "SolverBackend"])
def test_solver_enums_match_jax(name):
    je, te = getattr(jsolver, name), getattr(tsolver, name)
    assert [(m.name, m.value) for m in te] == [(m.name, m.value) for m in je]


def test_solve_takes_enum_values_and_refuses_members_like_jax():
    """solve() takes the members' string values; a member itself is
    refused with JAX's ValueError."""
    Aj = jgen.tridiagonal(8)
    At = tgen.tridiagonal(8, device="cpu")
    bj, bt = Aj @ jnp.ones(8), At @ torch.ones(8, dtype=torch.float64)
    _, res = tpu_sparse_torch.solve(At, bt,
                                    method=tsolver.SolverMethod.CG.value)
    assert res.converged
    for kw, tkw in ((dict(method=jsolver.SolverMethod.CG),
                     dict(method=tsolver.SolverMethod.CG)),
                    (dict(backend=jsolver.SolverBackend.KRYLOV),
                     dict(backend=tsolver.SolverBackend.KRYLOV))):
        with pytest.raises(ValueError) as ej:
            jsolver.solve(Aj, bj, **kw)
        with pytest.raises(ValueError) as et:
            tpu_sparse_torch.solve(At, bt, **tkw)
        assert str(et.value) == str(ej.value)


# -- checkpoints ---------------------------------------------------------------

def _trees():
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal((3, 2)), rng.standard_normal(4)
              .astype(np.float32), np.arange(5, dtype=np.int32),
              rng.standard_normal(2) + 1j * rng.standard_normal(2)]
    j = {"u": (jnp.asarray(arrays[0]), [jnp.asarray(arrays[1]), None]),
         "a": {"k": jnp.asarray(arrays[2]), "z": jnp.asarray(arrays[3])}}
    t = {"u": (torch.from_numpy(arrays[0]),
               [torch.from_numpy(arrays[1]), None]),
         "a": {"k": torch.from_numpy(arrays[2]),
               "z": torch.from_numpy(arrays[3])}}
    return j, t, arrays


def _leaves(tree):
    return [tree["u"][0], tree["u"][1][0], tree["a"]["k"], tree["a"]["z"]]


def test_checkpoint_round_trip(tmp_path):
    _, t, arrays = _trees()
    path = tckpt.save_pytree(str(tmp_path / "c.npz"), t)
    like = {"a": {"z": torch.zeros(2, dtype=torch.complex128),
                  "k": torch.zeros(5, dtype=torch.int32)},
            "u": (torch.zeros(3, 2, dtype=torch.float64),
                  [torch.zeros(4), None])}
    back = tckpt.load_pytree(path, like)
    assert back["u"][1][1] is None
    for got, want in zip(_leaves(back), arrays):
        assert isinstance(got, torch.Tensor)
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_cross_loads(tmp_path, direction):
    j, t, arrays = _trees()
    path = str(tmp_path / "c.npz")
    if direction == "jax_to_port":
        jckpt.save_pytree(path, j)
        back = tckpt.load_pytree(path, t)
    else:
        tckpt.save_pytree(path, t)
        back = jckpt.load_pytree(path, j)
    for got, want in zip(_leaves(back), arrays):
        assert np.array_equal(_np(got), want)
        assert _np(got).dtype == want.dtype
    with np.load(path) as a, np.load(tckpt.save_pytree(
            str(tmp_path / "t.npz"), t)) as b:
        assert sorted(a.files) == sorted(b.files)


@pytest.mark.parametrize("change", ["shape", "dtype", "missing"])
def test_checkpoint_errors_match_jax(tmp_path, change):
    path = str(tmp_path / "c.npz")
    tckpt.save_pytree(path, {"p": torch.zeros(4, 3)})
    if change == "shape":
        like_j, like_t = {"p": jnp.zeros((3, 3), jnp.float32)}, \
            {"p": torch.zeros(3, 3)}
        err = ValueError
    elif change == "dtype":
        like_j, like_t = {"p": jnp.zeros((4, 3), jnp.float64)}, \
            {"p": torch.zeros(4, 3, dtype=torch.float64)}
        err = ValueError
    else:
        like_j, like_t = {"q": jnp.zeros((4, 3), jnp.float32)}, \
            {"q": torch.zeros(4, 3)}
        err = KeyError
    with pytest.raises(err) as ej:
        jckpt.load_pytree(path, like_j)
    with pytest.raises(err) as et:
        tckpt.load_pytree(path, like_t)
    assert str(et.value) == str(ej.value)


# -- timing ------------------------------------------------------------------

def test_timing_on_the_cpu_is_finite_and_positive():
    A = tgen.poisson2d(16, device="cpu")
    x = torch.ones(256, dtype=torch.float64)
    assert timing.force((A @ x, None)) == pytest.approx(
        float((A @ x).abs().sum()))
    t_wall = timing.wall_time(lambda v: A @ v, x, warmup=1, iters=3)
    t_chain = timing.chain_time(lambda v: A @ v, x, 4, reps=2)
    t_iter = timing.per_iter_time(lambda v: A @ v, x, K1=2, K2=6)
    for t in (t_wall, t_chain, t_iter):
        assert np.isfinite(t) and t > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    A = tgen.poisson2d(8, device="cpu")
    with timing.trace(str(tmp_path / "tr")) as d:
        tpu_sparse_torch.solve(A, torch.ones(64, dtype=torch.float64))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(os.path.join(d, files[0])) > 0


# -- the benchmark harness -----------------------------------------------------

CELLS = [("krylov", "cg", "tridiagonal", 64),
         ("amg", "amg", "poisson2d", 100),
         ("direct", "direct", "dense_spd", 64)]


@pytest.fixture(scope="module")
def harness_cells():
    """Each cell run by both harnesses, one timed run and no warm-up."""
    out = []
    for backend, method, mtype, size in CELLS:
        jcfg = jharness.BenchmarkConfig(runs=1, warmup=0, verbose=False)
        tcfg = tharness.BenchmarkConfig(runs=1, warmup=0, verbose=False,
                                        device="cpu")
        out.append((jharness.run_single_benchmark(backend, method, mtype,
                                                  size, jcfg),
                    tharness.run_single_benchmark(backend, method, mtype,
                                                  size, tcfg)))
    return out


@pytest.mark.parametrize("k", range(len(CELLS)),
                         ids=["-".join(map(str, c)) for c in CELLS])
def test_harness_cells_match_jax(harness_cells, k):
    rj, rt = harness_cells[k]
    assert not rj.error_message and not rt.error_message, rt.error_message
    assert rt.converged == rj.converged
    slack = 1 if rt.backend == "amg" else 0
    if rj.iterations is None:
        assert rt.iterations is None
    else:
        assert abs(rt.iterations - rj.iterations) <= slack
    # within 1e-6 relative; CG on tridiagonal(64) ends at rounding level
    # (~1e-14, its 64th iteration), where only an absolute floor of 1e-4 of
    # the tolerance (1e-8) is meaningful
    assert rt.residual == pytest.approx(rj.residual, rel=1e-6, abs=1e-12)
    assert np.isfinite(rt.solve_time_ms) and rt.solve_time_ms > 0
    assert rt.memory_used_mb is None  # no card


def test_harness_cell_error_is_captured():
    r = tharness.run_single_benchmark(
        "krylov", "cg", "no_such_matrix", 10,
        tharness.BenchmarkConfig(verbose=False, device="cpu"))
    assert not r.converged and "unknown matrix type" in r.error_message
    assert np.isnan(r.solve_time_ms)


def _headings(path):
    """The report's section headings and the header row of each table."""
    with open(path) as f:
        lines = f.read().splitlines()
    return ([ln for ln in lines if ln.startswith("## ")],
            [lines[i - 1] for i, ln in enumerate(lines)
             if ln.startswith("|---")])


def test_reports_match_jax(harness_cells, tmp_path):
    cells = [c[0] for c in harness_cells], [c[1] for c in harness_cells]
    cfg = dict(sizes=(64, 100),
               matrix_types=("tridiagonal", "poisson2d", "dense_spd"),
               runs=1, warmup=0, verbose=False)
    pj = jharness.generate_markdown_report(
        cells[0], jharness.BenchmarkConfig(**cfg), str(tmp_path / "j"))
    pt = tharness.generate_markdown_report(
        cells[1], tharness.BenchmarkConfig(device="cpu", **cfg),
        str(tmp_path / "t"))
    assert _headings(pt) == _headings(pj)
    with open(pt) as f:
        text = f.read()
    assert "- **device**: cpu" in text and "- **torch**:" in text
    cj = jharness.export_csv(cells[0], str(tmp_path / "j.csv"))
    ct = tharness.export_csv(cells[1], str(tmp_path / "t.csv"))
    with open(cj) as a, open(ct) as b:
        rows_j, rows_t = list(csv.reader(a)), list(csv.reader(b))
    assert rows_t[0] == rows_j[0] and len(rows_t) == len(rows_j)


# -- run.py --------------------------------------------------------------------

def test_run_without_an_action_returns_2(capsys):
    assert run.main([]) == 2
    assert "--benchmark" in capsys.readouterr().out


def test_run_quick_benchmark_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert run.main(["--benchmark", "--quick", "--quiet",
                     "--device", "cpu"]) == 0
    assert "4/4 benchmark cells converged" in capsys.readouterr().out
    reports = os.listdir(tmp_path / "Logger")
    assert len(reports) == 1 and reports[0].endswith(".md")


@pytest.mark.parametrize("quick,rc", [(False, 0), (True, 1)])
def test_run_tests_calls_pytest_on_the_port_tests(monkeypatch, quick, rc):
    calls = []

    def fake_run(args, cwd=None):
        calls.append(args)
        return subprocess.CompletedProcess(args, rc)

    monkeypatch.setattr(run.subprocess, "run", fake_run)
    argv = ["--test", "--quiet"] + (["--quick"] if quick else [])
    assert run.main(argv) == (0 if rc == 0 else 1)
    (args,) = calls
    assert args[1:3] == ["-m", "pytest"] and "-x" in args and "-q" in args
    files = [os.path.basename(a) for a in args if a.endswith(".py")]
    assert files and all(f.startswith("test_torch_") for f in files)
    if quick:
        assert files == list(run.QUICK_TESTS)
    else:
        assert "test_torch_tooling.py" in files and len(files) > 20


# -- native ----------------------------------------------------------------------

def _scipy_matrix(n=300, seed=1):
    import scipy.sparse as sp

    S = sp.random(n, n, density=0.02, random_state=seed, format="csr")
    S = (S + S.T + sp.eye(n) * 4).tocsr()
    S.sort_indices()
    return S


def test_native_aggregate_rap_and_norms_match_scipy():
    import scipy.sparse as sp

    assert native.available()
    S = _scipy_matrix()
    np.testing.assert_allclose(native.l1_row_norms(S.indptr, S.data),
                               np.abs(S).sum(axis=1).A1, rtol=1e-14)
    agg, nc = native.aggregate(S.indptr, S.indices, S.data, 0.08, 4)
    assert 0 < nc < S.shape[0] and agg.min() == 0 and agg.max() == nc - 1
    indptr, indices, data = native.rap_pc(S.indptr, S.indices, S.data,
                                          agg, nc)
    P = sp.csr_matrix((np.ones(S.shape[0]), (np.arange(S.shape[0]), agg)),
                      shape=(S.shape[0], nc))
    want = (P.T @ S @ P).toarray()
    got = sp.csr_matrix((data, indices, indptr), shape=(nc, nc)).toarray()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_dia_to_csr_matches_scipy(dtype):
    import scipy.sparse as sp

    offsets, n, m = (-3, 0, 1, 5), 20, 23
    data = np.random.default_rng(8).standard_normal((4, n)).astype(dtype)
    data[1, 4] = 0.0  # an explicit in-band zero stays
    csr_data, indices, indptr = native.dia_to_csr(data, offsets, (n, m))
    dense = np.zeros((n, m), dtype=dtype)
    count = 0
    for d, o in enumerate(offsets):
        for i in range(n):
            if 0 <= i + o < m:
                dense[i, i + o] = data[d, i]
                count += 1
    assert csr_data.dtype == dtype and indptr.dtype == np.int32
    assert indptr[-1] == count
    S = sp.csr_matrix((csr_data, indices, indptr), shape=(n, m))
    assert S.has_sorted_indices
    assert np.array_equal(S.toarray(), dense)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_cwell_pack_matches_jax_packer(dtype):
    S = _scipy_matrix(n=500, seed=3)
    data = S.data.astype(dtype)
    vals, idx2, srow, n_planes = native.cwell_pack(S.indptr, S.indices,
                                                   data, S.shape)
    # below 16384 nonzeros the JAX packer takes its numpy path
    W = jcwell.csr_to_cwell(jconvert.csr_from_arrays(
        jnp.asarray(data), jnp.asarray(S.indices), jnp.asarray(S.indptr),
        S.shape))
    assert n_planes == W.vals.shape[1]
    for got, want in ((vals, W.vals), (idx2, W.idx2), (srow, W.srow)):
        assert got.dtype == np.asarray(want).dtype
        assert np.array_equal(got, np.asarray(want))
    assert native.cwell_pack(S.indptr, S.indices,
                             S.data.astype(np.int64), S.shape) is None
