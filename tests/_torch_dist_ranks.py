"""The port-side cases of tests/test_torch_dist.py, run in gloo ranks.

This module imports no JAX, so a spawned rank can import it by name. The
inputs are built from numpy seeds and the port's generators (byte-equal
to the JAX generators); ``vector``, ``random_spd`` and ``random_general``
are shared with the test module, which builds the JAX operands from the
same definitions.

``run_world(world, tmp_dir)`` spawns ``world`` ranks that rendezvous
through a file store, run every case of ``CASES`` and leave rank 0's
results (numpy arrays, ints, strings) in a pickle.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

CPU = "cpu"


def vector(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape)


def random_spd(n: int, density: float, state: int) -> sp.csr_matrix:
    B = sp.random(n, n, density=density, random_state=state, format="csr")
    return (B @ B.T + 10.0 * sp.identity(n)).tocsr()


def random_general(n: int = 700) -> sp.csr_matrix:
    A = sp.random(n, n, density=0.01, random_state=42, dtype=np.float64,
                  format="csr")
    A.setdiag(A.diagonal() + 1.0)
    return A.tocsr()


def _torch_systems():
    from tpu_sparse_torch.sparse import generators as gen
    from tpu_sparse_torch.sparse.containers import DIA
    from tpu_sparse_torch.sparse.convert import csr_from_arrays, to_csr

    def shifted():
        A = gen.poisson2d(16, device=CPU)
        data = A.data.clone()
        data[A.offsets.index(0)] -= 1.1
        return DIA(data, A.offsets, A.shape)

    def csr(S):
        return csr_from_arrays(S.data, S.indices, S.indptr, S.shape,
                               device=CPU)

    return {
        "p2d16": lambda: gen.poisson2d(16, device=CPU),
        "tri99": lambda: gen.tridiagonal(99, device=CPU),
        "p3d662": lambda: gen.poisson3d_27pt(6, 6, 2, dtype=np.float64,
                                             device=CPU),
        "cd128": lambda: gen.convection_diffusion(128, device=CPU),
        "shifted": shifted,
        "p2d64_csr": lambda: to_csr(gen.poisson2d(64, device=CPU)),
        "general700": lambda: csr(random_general()),
        "spd500": lambda: csr(random_spd(500, 0.01, 7)),
    }


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the cases: each takes the mesh and returns a dict of numpy results
# ---------------------------------------------------------------------------


def case_spmv(mesh, S):
    from tpu_sparse_torch.dist import gather_vector
    from tpu_sparse_torch.dist.partition import own_rows, shard_dia, \
        shard_vector
    from tpu_sparse_torch.dist.solvers import dia_matvec

    out = {}
    for name, seed in (("p2d16", 0), ("tri99", 1), ("p3d662", 7)):
        A = S[name]()
        n = A.shape[0]
        A_sh = shard_dia(A, mesh)
        op = dia_matvec(A_sh, mesh)
        keep = own_rows(n, mesh)
        y = op(shard_vector(_t(vector(seed, n)), mesh))
        Y = op(shard_vector(_t(vector(seed + 100, (n, 3))), mesh))
        out[name] = dict(mode=op.mode,
                         y=_np(gather_vector(y[:keep], mesh, n)),
                         Y=_np(gather_vector(Y[:keep], mesh, n)))
    return out


def case_cwell(mesh, S):
    from tpu_sparse_torch.dist import gather_vector
    from tpu_sparse_torch.dist.partition import (shard_general,
                                                 shard_general_planned,
                                                 shard_vector)
    from tpu_sparse_torch.dist.spmv import (make_cwell_allgather_spmv,
                                            make_cwell_halo_spmv,
                                            plan_cwell_halo)

    out = {}
    A = S["p2d64_csr"]()
    n = A.shape[0]
    W_sh, H = shard_general_planned(A, mesh)
    x = shard_vector(_t(vector(5, n)), mesh, 128)
    X = shard_vector(_t(vector(6, (n, 3))), mesh, 128)
    halo = make_cwell_halo_spmv(H, mesh)
    H2 = plan_cwell_halo(W_sh, mesh)
    out["p2d64_csr"] = dict(
        wl=H.wl, wr=H.wr, srow_equal=bool(torch.equal(H.W.srow, H2.W.srow)),
        y_halo=_np(gather_vector(halo(x), mesh, n)),
        Y_halo=_np(gather_vector(halo(X), mesh, n)),
        y_ag=_np(gather_vector(make_cwell_allgather_spmv(W_sh, mesh)(x),
                               mesh, n)))
    G = S["general700"]()
    n = G.shape[0]
    Wg = shard_general(G, mesh)
    xg = shard_vector(_t(vector(21, n)), mesh, 128)
    yg = make_cwell_allgather_spmv(Wg, mesh)(xg)
    keep = max(0, min(yg.shape[0], n - mesh.rank * yg.shape[0]))
    out["general700"] = dict(y_ag=_np(gather_vector(yg[:keep], mesh, n)))
    return out


def _solve(fn, A, b, mesh, **kw):
    from tpu_sparse_torch.dist import gather_vector

    x, info, it, res = fn(A, b, mesh=mesh, **kw)
    return dict(x=_np(gather_vector(x, mesh, b.shape[0])),
                info=_np(info), iters=int(it), res=_np(res))


def case_solves(mesh, S):
    from tpu_sparse_torch.dist import solvers as ds
    from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner

    out = {}
    A = S["p2d16"]()
    b = A @ _t(vector(2, 256))
    for mode in ("halo", "gspmd"):
        out[f"cg_{mode}"] = _solve(ds.distributed_cg, A, b, mesh, mode=mode,
                                   tol=1e-10)
    out["cg_jacobi"] = _solve(ds.distributed_cg, A, b, mesh, mode="halo",
                              tol=1e-10, M=jacobi_preconditioner(A))
    out["cg_pipeline"] = _solve(ds.distributed_cg, A, b, mesh, mode="halo",
                                tol=1e-10, pipeline=True)
    # determinism: a second run, bit for bit
    out["cg_halo_again"] = _solve(ds.distributed_cg, A, b, mesh,
                                  mode="halo", tol=1e-10)
    Aw = S["p3d662"]()
    out["cg_wide"] = _solve(ds.distributed_cg, Aw,
                            Aw @ _t(vector(8, Aw.shape[0])), mesh,
                            mode="halo", tol=1e-8)
    Ac = S["cd128"]()
    out["bicgstab"] = _solve(ds.distributed_bicgstab, Ac,
                             Ac @ _t(vector(3, 128)), mesh, mode="halo",
                             tol=1e-10)
    out["gmres"] = _solve(ds.distributed_gmres, Ac, Ac @ _t(vector(5, 128)),
                          mesh, mode="halo", tol=1e-10, restart=30)
    out["minres"] = _solve(ds.distributed_minres, S["shifted"](),
                           _t(vector(42, 256)), mesh, tol=1e-9)
    out["block_cg"] = _solve(ds.distributed_block_cg, A,
                             _t(vector(40, (256, 3))), mesh, mode="gspmd",
                             tol=1e-8)
    As = S["spd500"]()
    out["cg_general"] = _solve(ds.distributed_cg, As,
                               _t(vector(22, 500)), mesh, tol=1e-10)
    Ah = S["p2d64_csr"]()
    bh = Ah @ _t(vector(55, 4096))
    out["cg_general_halo"] = _solve(ds.distributed_cg, Ah, bh, mesh,
                                    tol=1e-10)
    out["cg_general_halo"]["mode"] = ds._shard_and_resolve(
        Ah, mesh, "gspmd")[1]
    return out


def case_amg(mesh, S):
    from tpu_sparse_torch.dist import solvers as ds
    from tpu_sparse_torch.dist.amg import (ShardedLevelOp,
                                           distributed_amg_preconditioner)
    from tpu_sparse_torch.precond.amg import amg_preconditioner

    A = S["p2d16"]()
    b = A @ _t(vector(9, 256))
    M = distributed_amg_preconditioner(A, mesh)
    levels = [dict(n=lvl.A.shape[0], sharded=lvl.A.out_sharded,
                   local=type(lvl.A.local).__name__)
              for lvl in M.hier.levels]
    ok = all(isinstance(op, ShardedLevelOp) for lvl in M.hier.levels
             for op in (lvl.A, lvl.P, lvl.R))
    out = {"levels": levels, "all_sharded_ops": ok}
    out["amg_sharded"] = _solve(ds.distributed_cg, A, b, mesh, mode="halo",
                                tol=1e-8, M=M)
    out["amg_single_M"] = _solve(ds.distributed_cg, A, b, mesh,
                                 mode="gspmd", tol=1e-8,
                                 M=amg_preconditioner(A))
    return out


def case_errors(mesh, S):
    from tpu_sparse_torch.dist import make_row_mesh
    from tpu_sparse_torch.dist import solvers as ds
    from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner

    out = {}
    A = S["tri99"]()
    try:
        ds.distributed_cg(A, torch.ones(99, dtype=torch.float64), mesh=mesh,
                          M=jacobi_preconditioner(A))
        out["precond"] = "no error"
    except ValueError as e:
        out["precond"] = str(e)
    try:
        make_row_mesh("cuda")
        out["cuda"] = "no error"
    except RuntimeError as e:
        out["cuda"] = str(e)
    return out


def case_comm(mesh, S):
    from tpu_sparse_torch.dist import comm_model
    from tpu_sparse_torch.dist import solvers as ds
    from tpu_sparse_torch.sparse import generators as gen

    A = gen.poisson3d_27pt(8, 8, 8 * mesh.world_size, dtype=np.float32,
                           device=CPU)
    b = torch.ones(A.shape[0], dtype=torch.float32)
    out = {"w": max(abs(o) for o in A.offsets)}
    for name, pipeline in (("cg", False), ("cg_sr", True)):
        st = comm_model.measure_per_iteration(
            lambda k, p=pipeline: ds.distributed_cg(
                A, b, mesh=mesh, mode="halo", tol=0.0, maxiter=k,
                pipeline=p))
        out[name] = st.summary()
        # the H100 model on the measured per-iteration volume
        local = comm_model.spmv_local_hbm_bytes(
            A.nnz // mesh.world_size, A.shape[0] // mesh.world_size)
        out[name + "_modeled"] = [
            comm_model.modeled_weak_scaling_efficiency(
                st, mesh.world_size, local,
                comm_model.HardwareModel(hop_latency_us=lat))
            for lat in (0.0, 10.0)]
    _, mv = ds.distributed_matvec_op(A, mesh, "halo")
    st = comm_model.measure_collectives(
        mv, torch.zeros(A.shape[0] // mesh.world_size, dtype=torch.float32))
    out["spmv"] = st.summary()
    return out


CASES = {"spmv": case_spmv, "cwell": case_cwell, "solves": case_solves,
         "amg": case_amg, "errors": case_errors, "comm": case_comm}


def rank_main(rank: int, world: int, init_file: str, out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + init_file, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        from tpu_sparse_torch.dist import make_row_mesh

        mesh = make_row_mesh("cpu")
        S = _torch_systems()
        results, seconds = {}, {}
        for name, fn in CASES.items():
            t0 = time.perf_counter()
            results[name] = fn(mesh, S)
            seconds[name] = time.perf_counter() - t0
        results["seconds"] = seconds
        if rank == 0:
            with open(out_path + ".tmp", "wb") as f:
                pickle.dump(results, f)
            os.replace(out_path + ".tmp", out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(world: int, tmp_dir: str, timeout_s: float = 240.0) -> dict:
    """Spawn ``world`` gloo ranks, run every case, return rank 0's
    results. A rank that fails or a run past ``timeout_s`` raises (the
    other ranks are killed)."""
    import torch.multiprocessing as mp

    init_file = os.path.join(tmp_dir, f"store{world}")
    out_path = os.path.join(tmp_dir, f"results{world}.pkl")
    ctx = mp.start_processes(rank_main, args=(world, init_file, out_path),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} gloo ranks did not finish in "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with open(out_path, "rb") as f:
        return pickle.load(f)
