"""The port's demos against the JAX examples on the CPU: the north-star
Poisson demo (its CG iterations equal ``cg_full``'s on the same system;
the distributed form on two gloo ranks), the inverse conductivity problem
(its final error within 1e-6 of the JAX example's on the same arguments)
and the lid-driven cavity's ``save_plot``."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from examples import inverse_poisson as jinv
from tpu_sparse.solvers import cg_full
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch.apps import inverse_poisson as tinv
from tpu_sparse_torch.apps import ldc as tldc
from tpu_sparse_torch.apps import poisson3d_demo as demo
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_poisson3d_demo_iterations_equal_jax_cg_full(capsys):
    nx, tol = 12, 1e-6
    out = demo.run(demo.parse_args(["--nx", str(nx), "--cpu"]))
    A = jgen.poisson3d_27pt(nx, dtype=np.float32)
    x_true = np.random.default_rng(0).standard_normal(nx ** 3).astype(
        np.float32)
    _, info, iters, _ = jax.jit(lambda b: cg_full(A, b, tol=tol,
                                                  maxiter=500))(
        A @ jnp.asarray(x_true))
    assert int(info) == 0 and out["converged"]
    assert out["iterations"] == int(iters)
    assert out["n"] == nx ** 3 and out["nnz"] == A.nnz
    assert out["rel_residual"] <= tol and out["max_abs_err"] < 1e-4
    assert "converged in" in capsys.readouterr().out
    assert demo.main(["--nx", "6", "--cpu"]) == 0


def test_poisson3d_demo_distributed_on_two_gloo_ranks(tmp_path):
    """``--distributed --cpu`` starts two ranks under
    torch.distributed.run; the halo CG converges to the same
    tolerance."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_sparse_torch.apps.poisson3d_demo",
         "--distributed", "--cpu", "--nx", "8"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "distributed CG over 2 cpu ranks: converged" in proc.stdout


def test_inverse_poisson_matches_jax():
    args = ["--n", "24", "--steps", "40"]
    err_j = jinv.main(args)
    err_t = tinv.main(args + ["--cpu"])
    assert err_t < 0.4
    assert abs(err_t - err_j) <= 1e-6


def test_inverse_poisson_assembly_matches_jax():
    sigma = np.linspace(1.0, 2.0, 9)
    Aj = jinv.assemble(jnp.asarray(sigma))
    At = tinv.assemble(torch.from_numpy(sigma))
    assert At.offsets == Aj.offsets and At.shape == Aj.shape
    assert np.array_equal(At.data.numpy(), np.asarray(Aj.data))


def test_ldc_save_plot_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    s = tldc.LDCSolver(tldc.LDCConfig(nx=8, Re=100.0, device="cpu"))
    s.run(3)
    path = s.save_plot(str(tmp_path / "ldc.png"))
    with open(path, "rb") as f:
        head = f.read(8)
    assert head == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "ldc.png").stat().st_size > 1000
