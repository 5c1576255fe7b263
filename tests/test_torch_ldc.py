"""tpu_sparse_torch.apps.ldc against examples/ldc/ldc_solver.py on the CPU.

The port's lid-driven cavity runs the same time steps as the JAX example:
the pressure matrix equal entry for entry, and after 12 steps at nx = 12
the fields u, v and p within 1e-8 (absolute) of JAX's and the pressure
iterations within 2 over the run, for CG / BiCGStab / GMRES with Jacobi,
AMG and FSAI, and CG with mixed-precision AMG pressure solves.
"""

import numpy as np
import pytest
import torch

from examples.ldc import ldc_solver as jldc
from tpu_sparse_torch.apps import ldc as tldc
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

STEPS = 12


def test_pressure_matrix_matches_jax():
    Aj = jldc.build_pressure_matrix(10, 7, 0.1, 1 / 7)
    At = tldc.build_pressure_matrix(10, 7, 0.1, 1 / 7, device="cpu")
    assert At.offsets == Aj.offsets and At.shape == Aj.shape
    assert np.array_equal(At.data.numpy(), np.asarray(Aj.data))
    Pj, Pt = jldc.pin_pressure_matrix(Aj), tldc.pin_pressure_matrix(At)
    assert np.array_equal(Pt.data.numpy(), np.asarray(Pj.data))
    assert np.array_equal(At.data.numpy(), np.asarray(Aj.data))  # no alias


CASES = [(s, p, "full") for s in ("cg", "bicgstab", "gmres")
         for p in ("jacobi", "amg", "fsai")] + [("cg", "amg", "mixed")]


# the mixed path runs for CG only: JAX compiles its refined BiCGStab and
# GMRES around an AMG M for 8-16 s each on the CPU, and the port's mixed
# loop is the same for every method
@pytest.mark.parametrize("solver,precond,precision", CASES,
                         ids=[f"{s}-{p}-{q}" for s, p, q in CASES])
def test_ldc_matches_jax(solver, precond, precision):
    kw = dict(nx=12, Re=100.0, solver=solver, precond=precond,
              precision=precision)
    js = jldc.LDCSolver(jldc.LDCConfig(**kw))
    sj = js.run(STEPS)
    ts = tldc.LDCSolver(tldc.LDCConfig(device="cpu", **kw))
    st = ts.run(STEPS)
    for name in ("u", "v", "p"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert a.shape == b.shape and a.dtype == b.dtype == np.float64
        assert float(np.abs(a - b).max()) <= 1e-8, name
    assert abs(st["pressure_iters_total"] - sj["pressure_iters_total"]) <= 2
    assert st["mass_residual"] < 1e-6


def test_ldc_direct_raises_naming_item_16():
    """solver='direct' (item 16) no longer raises: it pins row 0 of the
    pressure matrix and runs without pressure iterations (its fields are
    held against JAX's in tests/test_torch_direct.py); an unknown solver
    still raises."""
    s = tldc.LDCSolver(tldc.LDCConfig(nx=8, solver="direct", device="cpu"))
    assert torch.equal(s.A_pin.data, tldc.pin_pressure_matrix(s.A).data)
    assert s.run(2)["pressure_iters_total"] == 0
    with pytest.raises(ValueError, match="unknown solver"):
        tldc.LDCSolver(tldc.LDCConfig(nx=8, solver="lu", device="cpu"))


def test_ldc_cli_and_state_round_trip(tmp_path):
    """``python -m tpu_sparse_torch.apps.ldc`` flags, and a saved state
    that resumes where it stopped."""
    path = str(tmp_path / "state.npz")
    stats = tldc.run_solver_cli(["--nx", "8", "--steps", "3", "--method",
                                 "amg", "--device", "cpu", "--save-state",
                                 path])
    assert stats["steps"] == 3 and stats["mass_residual"] < 1e-6
    a = tldc.LDCSolver(tldc.LDCConfig(nx=8, precond="amg", device="cpu"))
    a.restore_state(path)
    b = tldc.LDCSolver(tldc.LDCConfig(nx=8, precond="amg", device="cpu"))
    b.run(3)
    assert torch.equal(a.p, b.p) and torch.equal(a.u, b.u)
    with pytest.raises(ValueError, match="does not match"):
        tldc.LDCSolver(tldc.LDCConfig(nx=6, device="cpu")).restore_state(
            path)
