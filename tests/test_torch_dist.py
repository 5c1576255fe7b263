"""tpu_sparse_torch.dist against tpu_sparse.dist on the CPU.

The port side runs in 2 and 4 gloo ranks spawned once per world size
(``_torch_dist_ranks.run_world``, a module without JAX), the JAX side on
``make_row_mesh(2)`` / ``make_row_mesh(4)`` of the suite's 8-device CPU
mesh, from the same numpy inputs. Each comparison is its own test.

Tolerances: SpMVs in float64 equal JAX's and the single-device product to
1e-12 (relative to max|y|); the halo plan integer for integer; solves
within JAX's test tolerances of JAX's distributed x (rtol 1e-6, atol 1e-8)
with info 0 and iterations (GMRES: restart cycles) within 2 of JAX's
distributed solve and of the port's single-device solve; AMG-PCG as JAX's
test asks (relative residual below 1e-6, under 40 iterations) and within
2 iterations of JAX's; a repeated solve bit for bit; the recorder's
per-iteration halo bytes equal to JAX's collective-permute bytes.
n = 99 is the non-divisible DIA case (the JAX tests' n = 100 divides 2
and 4).
"""

import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sparse.dist as jd
from tpu_sparse.dist import partition as jpart
from tpu_sparse.dist import solvers as jsolv
from tpu_sparse.dist import spmv as jspmv
from tpu_sparse.sparse import containers as jcont
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.sparse.convert import csr_from_arrays as jcsr
from tpu_sparse.sparse.convert import to_csr as jto_csr
from tpu_sparse.sparse.cwell import csr_to_cwell as jcsr_to_cwell

import _torch_dist_ranks as R
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)
from tpu_sparse_torch import solvers as ts
from tpu_sparse_torch.dist.spmv import plan_halo_host
from tpu_sparse_torch.precond.amg import amg_preconditioner

WORLDS = (2, 4)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def run(request, tmp_path_factory):
    world = request.param
    return world, R.run_world(world, str(tmp_path_factory.mktemp(
        f"gloo{world}")))


def _jshifted():
    A = jgen.poisson2d(16)
    d0 = A.offsets.index(0)
    return jcont.DIA(A.data.at[d0].add(-1.1), A.offsets, A.shape)


def _jsp(S):
    return jcsr(S.data, S.indices, S.indptr, S.shape)


JAX_SYSTEMS = {
    "p2d16": lambda: jgen.poisson2d(16),
    "tri99": lambda: jgen.tridiagonal(99),
    "p3d662": lambda: jgen.poisson3d_27pt(6, 6, 2, dtype=np.float64),
    "cd128": lambda: jgen.convection_diffusion(128),
    "shifted": _jshifted,
    "p2d64_csr": lambda: jto_csr(jgen.poisson2d(64)),
    "general700": lambda: _jsp(R.random_general()),
    "spd500": lambda: _jsp(R.random_spd(500, 0.01, 7)),
}


@functools.lru_cache(maxsize=None)
def jmesh(world):
    return jd.make_row_mesh(world)


def _close(a, b, bound):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.max(np.abs(b))), 1e-300)
    assert float(np.max(np.abs(a - b))) <= bound * scale


# -- SpMVs ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_dia_spmv(name, seed, world):
    A = JAX_SYSTEMS[name]()
    n = A.shape[0]
    mesh = jmesh(world)
    A_sh = jd.shard_dia(A, mesh)
    x_sh = jd.shard_vector(jnp.asarray(R.vector(seed, n)), mesh)
    make = jspmv.make_allgather_spmv \
        if A_sh.bandwidth > A_sh.shape[0] // world else jd.make_halo_spmv
    return np.asarray(jax.jit(make(A_sh, mesh))(x_sh))[:n]


@pytest.mark.parametrize("name,seed,mode", [
    ("p2d16", 0, "halo"), ("tri99", 1, "halo"), ("p3d662", 7, "allgather")])
def test_dia_spmv(run, name, seed, mode):
    world, res = run
    got = res["spmv"][name]
    assert got["mode"] == mode
    A = R._torch_systems()[name]()
    n = A.shape[0]
    y_single = (A @ torch.from_numpy(R.vector(seed, n))).numpy()
    _close(got["y"], _jax_dia_spmv(name, seed, world), 1e-12)
    _close(got["y"], y_single, 1e-12)
    X = R.vector(seed + 100, (n, 3))
    _close(got["Y"], A.todense().numpy() @ X, 1e-12)


def test_halo_plan_matches_jax(run):
    world, res = run
    A = jto_csr(jgen.poisson2d(64))
    W = jcsr_to_cwell(A, group=1)
    srow = np.asarray(W.srow)
    used = np.asarray(W.vals != 0).any(axis=2)
    mine = plan_halo_host(srow, used, W.shape, world)
    ref = jspmv.plan_halo_host(srow, used, W.shape, world)
    assert mine is not None and ref is not None
    assert mine[:2] == ref[:2]
    assert mine[2].dtype == ref[2].dtype
    assert np.array_equal(mine[2], ref[2])
    # the ranks planned their own (byte-equal) pack the same way
    got = res["cwell"]["p2d64_csr"]
    assert (got["wl"], got["wr"]) == ref[:2]
    assert got["srow_equal"]
    # a scrambled matrix plans to None in both
    rng = np.random.default_rng(9)
    S = R.random_spd(1024, 0.02, 3)
    perm = rng.permutation(1024)
    Wp = jcsr_to_cwell(_jsp(S[perm][:, perm].tocsr()), group=1)
    args = (np.asarray(Wp.srow), np.asarray(Wp.vals != 0).any(axis=2),
            Wp.shape, world)
    assert plan_halo_host(*args) is None
    assert jspmv.plan_halo_host(*args) is None


@functools.lru_cache(maxsize=None)
def _jax_cwell(world):
    mesh = jmesh(world)
    A = JAX_SYSTEMS["p2d64_csr"]()
    n = A.shape[0]
    W_sh, H = jpart.shard_general_planned(A, mesh)
    x_sh = jpart.shard_vector(jnp.asarray(R.vector(5, n)), mesh, unit=128)
    y_halo = np.asarray(jax.jit(jspmv.make_cwell_halo_spmv(H, mesh))(
        x_sh))[:n]
    y_ag = np.asarray(jax.jit(jspmv.make_cwell_allgather_spmv(W_sh, mesh))(
        x_sh))[:n]
    G = JAX_SYSTEMS["general700"]()
    Wg = jpart.shard_general(G, mesh)
    xg = jpart.shard_vector(jnp.asarray(R.vector(21, 700)), mesh, unit=128)
    y_g = np.asarray(jax.jit(jspmv.make_cwell_allgather_spmv(Wg, mesh))(
        xg))[:700]
    return y_halo, y_ag, y_g


def test_cwell_spmvs_match_jax(run):
    world, res = run
    got = res["cwell"]
    y_halo, y_ag, y_g = _jax_cwell(world)
    A = R._torch_systems()["p2d64_csr"]()
    x = R.vector(5, 4096)
    y_single = (A @ torch.from_numpy(x)).numpy()
    _close(got["p2d64_csr"]["y_halo"], y_halo, 1e-12)
    _close(got["p2d64_csr"]["y_ag"], y_ag, 1e-12)
    _close(got["p2d64_csr"]["y_halo"], y_single, 1e-12)
    X = R.vector(6, (4096, 3))
    _close(got["p2d64_csr"]["Y_halo"], A.todense().numpy() @ X, 1e-12)
    _close(got["general700"]["y_ag"], y_g, 1e-12)
    _close(got["general700"]["y_ag"], R.random_general() @ R.vector(21, 700),
           1e-12)


# -- solves --------------------------------------------------------------

# case: (JAX solver, port single-device solver, system, rhs, kwargs)
SOLVES = {
    "cg_halo": ("distributed_cg", "cg_full", "p2d16", ("Ax", 2),
                dict(mode="halo", tol=1e-10)),
    "cg_gspmd": ("distributed_cg", "cg_full", "p2d16", ("Ax", 2),
                 dict(mode="gspmd", tol=1e-10)),
    "cg_jacobi": ("distributed_cg", "cg_full", "p2d16", ("Ax", 2),
                  dict(mode="halo", tol=1e-10, M="jacobi")),
    "cg_pipeline": ("distributed_cg", "cg_sr_full", "p2d16", ("Ax", 2),
                    dict(mode="halo", tol=1e-10, pipeline=True)),
    "cg_wide": ("distributed_cg", "cg_full", "p3d662", ("Ax", 8),
                dict(mode="halo", tol=1e-8)),
    "bicgstab": ("distributed_bicgstab", "bicgstab_full", "cd128", ("Ax", 3),
                 dict(mode="halo", tol=1e-10)),
    "gmres": ("distributed_gmres", "gmres_full", "cd128", ("Ax", 5),
              dict(mode="halo", tol=1e-10, restart=30)),
    "minres": ("distributed_minres", "minres_full", "shifted", ("b", 42),
               dict(tol=1e-9)),
    "block_cg": ("distributed_block_cg", "block_cg", "p2d16", ("B", 40),
                 dict(mode="gspmd", tol=1e-8)),
    "cg_general": ("distributed_cg", "cg_full", "spd500", ("b", 22),
                   dict(tol=1e-10)),
    "cg_general_halo": ("distributed_cg", "cg_full", "p2d64_csr", ("Ax", 55),
                        dict(tol=1e-10)),
}


def _rhs(spec, n):
    kind, seed = spec
    if kind == "B":
        return R.vector(seed, (n, 3))
    v = R.vector(seed, n)
    return v if kind == "b" else None


@functools.lru_cache(maxsize=None)
def _jax_solve(case, world):
    from tpu_sparse.precond.jacobi import jacobi_preconditioner

    fn, _, system, spec, kw = SOLVES[case]
    A = JAX_SYSTEMS[system]()
    n = A.shape[0]
    b = _rhs(spec, n)
    b = A @ jnp.asarray(R.vector(spec[1], n)) if b is None else jnp.asarray(b)
    kw = dict(kw)
    if kw.get("M") == "jacobi":
        kw["M"] = jacobi_preconditioner(A)
    x, info, it, _ = getattr(jsolv, fn)(A, b, mesh=jmesh(world), **kw)
    return np.asarray(x), np.asarray(info), int(it)


@functools.lru_cache(maxsize=None)
def _port_single(case):
    from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner

    _, fn, system, spec, kw = SOLVES[case]
    A = R._torch_systems()[system]()
    n = A.shape[0]
    b = _rhs(spec, n)
    b = A @ torch.from_numpy(R.vector(spec[1], n)) if b is None \
        else torch.from_numpy(b)
    kw = {k: v for k, v in kw.items() if k not in ("mode", "pipeline")}
    if kw.get("M") == "jacobi":
        kw["M"] = jacobi_preconditioner(A)
    _, _, it, _ = getattr(ts, fn)(A, b, **kw)
    return int(it)


@pytest.mark.parametrize("case", list(SOLVES))
def test_distributed_solve_matches_jax(run, case):
    world, res = run
    got = res["solves"][case]
    x_j, info_j, it_j = _jax_solve(case, world)
    assert np.all(got["info"] == 0) and np.all(info_j == 0)
    np.testing.assert_allclose(got["x"], x_j, rtol=1e-6, atol=1e-8)
    assert abs(got["iters"] - it_j) <= 2
    assert abs(got["iters"] - _port_single(case)) <= 2
    if case == "cg_general_halo":
        assert got["mode"] == "cwell_halo"


def test_distributed_cg_is_deterministic(run):
    _, res = run
    a, b = res["solves"]["cg_halo"], res["solves"]["cg_halo_again"]
    assert np.array_equal(a["x"], b["x"])
    assert a["iters"] == b["iters"]


@functools.lru_cache(maxsize=None)
def _jax_amg(world):
    from tpu_sparse.dist.amg import distributed_amg_preconditioner

    A = JAX_SYSTEMS["p2d16"]()
    b = A @ jnp.asarray(R.vector(9, 256))
    M = distributed_amg_preconditioner(A, jmesh(world))
    x, info, it, _ = jd.distributed_cg(A, b, mesh=jmesh(world),
                                       mode="gspmd", tol=1e-8, M=M)
    return np.asarray(x), int(info), int(it)


@pytest.mark.parametrize("case", ["amg_sharded", "amg_single_M"])
def test_distributed_amg_pcg(run, case):
    world, res = run
    got = res["amg"][case]
    A = R._torch_systems()["p2d16"]()
    b = (A @ torch.from_numpy(R.vector(9, 256))).numpy()
    rel = np.linalg.norm(b - A.todense().numpy() @ got["x"]) \
        / np.linalg.norm(b)
    assert int(got["info"]) == 0 and rel < 1e-6 and got["iters"] < 40
    x_j, info_j, it_j = _jax_amg(world)
    assert info_j == 0 and abs(got["iters"] - it_j) <= 2
    np.testing.assert_allclose(got["x"], x_j, rtol=1e-6, atol=1e-8)
    # the single-device V-cycle's iterations
    _, _, it_s, _ = ts.cg_full(A, torch.from_numpy(b), tol=1e-8,
                               M=amg_preconditioner(A))
    assert abs(got["iters"] - int(it_s)) <= 2
    # every level operator is row-sharded or kept whole by the rules
    assert res["amg"]["all_sharded_ops"]
    levels = res["amg"]["levels"]
    assert levels[0]["local"] == "ShardedDIA"
    assert all(lvl["sharded"] == (lvl["n"] % world == 0) for lvl in levels)


def test_errors(run):
    world, res = run
    assert "divisible" in res["errors"]["precond"]
    assert "CUDA" in res["errors"]["cuda"]


@functools.lru_cache(maxsize=None)
def _jax_comm(world):
    from tpu_sparse.dist.comm_model import measure_collectives
    from tpu_sparse.solvers.krylov import cg_full

    A = jgen.poisson3d_27pt(8, 8, 8 * world, dtype=np.float32)
    mesh = jmesh(world)
    A_sh, _ = jd.distributed_matvec_op(A, mesh, "halo")
    b_sh = jd.shard_vector(jnp.ones(A.shape[0], jnp.float32), mesh)

    def go(aa, bb):
        return cg_full(jsolv._matvec_builder(aa, mesh, "halo"), bb, None,
                       tol=1e-6, maxiter=50)

    return measure_collectives(go, A_sh, b_sh).summary(per_iteration=True)


def test_collective_volume_matches_jax(run):
    world, res = run
    got = res["comm"]
    ref = _jax_comm(world)
    w = got["w"]
    for name in ("cg", "cg_sr"):
        perm = got[name]["collective-permute"]
        assert perm["count"] == 2
        assert perm["bytes"] == ref["collective-permute"]["bytes"] \
            == 2 * w * 4
    assert got["spmv"]["collective-permute"]["bytes"] == 2 * w * 4
    # the port's own reduction rounds per iteration; XLA may combine its
    # all-reduces, so JAX's count is printed, not compared
    assert got["cg"]["all-reduce"]["count"] == 2
    assert got["cg_sr"]["all-reduce"]["count"] == 1
    # the H100 model: in (0, 1], lower with a per-hop latency, and the
    # single-reduction CG's one round costs less latency than CG's two
    for name in ("cg", "cg_sr"):
        e0, e10 = got[name + "_modeled"]
        assert 0.0 < e10 < e0 <= 1.0
    assert got["cg_sr_modeled"][1] > got["cg_modeled"][1]
    print(f"world {world}: all-reduces per CG iteration, port "
          f"{got['cg']['all-reduce']['count']}, JAX "
          f"{ref.get('all-reduce', {}).get('count')}")


def test_dist_package_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|tpu_sparse)(\.|\s|$)",
                     re.MULTILINE)
    files = sorted((REPO / "tpu_sparse_torch" / "dist").glob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "_torch_dist_ranks.py"]
    assert len(files) > 7
    for f in files:
        assert not pat.search(f.read_text()), f
