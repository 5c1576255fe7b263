"""FVM lid-driven cavity on tpu_sparse_torch: the port of
``examples/ldc/ldc_solver.py``.

    python -m tpu_sparse_torch.apps.ldc --nx 64 --Re 400 --steps 200 \
        --method cg --precond amg

The reference's end-to-end application (FVM_example/LDC_by_torchsp/
ldc_solver_common.py): a staggered-grid fractional-step incompressible
Navier-Stokes solver with explicit momentum (central convection and
diffusion), a pressure-Poisson system with Neumann walls assembled once as
a 5-point DIA matrix, a pluggable pressure solve (CG, BiCGStab or GMRES,
full or mixed precision, with no preconditioner, Jacobi, AMG or FSAI; or
``solver="direct"``, a banded direct solve of the row-0-pinned matrix),
the velocity correction and a mass-residual monitor.

Every step is torch ops on the solver's device (the card unless the
caller asks for the CPU); the JAX version's ``.at[].set`` becomes writes
into clones and its ``lax.scan`` over steps a Python loop. The pressure
solves are ``cg_full`` / ``bicgstab_full`` / ``gmres_full`` (their
``*_refined`` forms under ``precision="mixed"``); on the card every SpMV of
the float64 DIA matrix is the fp64 kernel K3 in plain mode. ``solver=
"direct"`` is ``direct.banded_solve`` every step, as in the JAX example:
block PCR with block size nx on the card (the fixed pinned matrix is
eliminated again each step), the banded LU on the host for a CPU solver.
``save_plot`` draws the velocity field with matplotlib, imported when it
is called.

Staggered layout (MAC):
  p[J, I]   cell centres, shape (ny, nx)
  u[j, i]   x-velocity at vertical faces, shape (ny+2, nx+1)
            (rows 1..ny interior; rows 0 / ny+1 are ghosts)
  v[j, i]   y-velocity at horizontal faces, shape (ny+1, nx+2)
            (cols 1..nx interior; cols 0 / nx+1 are ghosts)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tpu_sparse_torch.direct import banded_solve
from tpu_sparse_torch.precond import (amg_preconditioner, fsai_preconditioner,
                                      jacobi_preconditioner)
from tpu_sparse_torch.solvers import (bicgstab_full, bicgstab_refined,
                                      cg_full, cg_refined, gmres_full,
                                      gmres_refined)
from tpu_sparse_torch.sparse.containers import DIA
from tpu_sparse_torch.sparse.convert import dia_from_offsets, numpy_dtype

_SOLVERS = {"cg": (cg_full, cg_refined),
            "bicgstab": (bicgstab_full, bicgstab_refined),
            "gmres": (gmres_full, gmres_refined)}


def build_pressure_matrix(nx: int, ny: int, dx: float, dy: float,
                          dtype=np.float64, device="cuda") -> DIA:
    """The negated pressure-Poisson operator with Neumann walls as a
    5-point DIA on ``device``: zeroed boundary couplings and a reduced
    diagonal make the wall faces Neumann, so the matrix is symmetric
    positive semi-definite (singular up to a constant), as the reference
    assembles it (ldc_solver_common.py:90-135)."""
    n = nx * ny
    c = np.arange(n)
    I = c % nx  # noqa: E741
    J = c // nx
    ax, ay = 1.0 / dx**2, 1.0 / dy**2
    west = np.where(I > 0, ax, 0.0)
    east = np.where(I < nx - 1, ax, 0.0)
    south = np.where(J > 0, ay, 0.0)
    north = np.where(J < ny - 1, ay, 0.0)
    data = np.zeros((5, n), dtype=dtype)
    data[0] = -south
    data[1] = -west
    data[2] = west + east + south + north
    data[3] = -east
    data[4] = -north
    return dia_from_offsets((-nx, -1, 0, 1, nx), data, (n, n), device)


def pin_pressure_matrix(A: DIA) -> DIA:
    """Row 0 replaced by the identity row e0, which removes the constant
    null space of the Neumann system (the fix-one-unknown form a direct
    solve needs)."""
    data = A.data.clone()
    for d, o in enumerate(A.offsets):
        data[d, 0] = 1.0 if o == 0 else 0.0
    return DIA(data, A.offsets, A.shape)


@dataclasses.dataclass
class LDCConfig:
    nx: int = 32
    ny: Optional[int] = None
    Re: float = 100.0
    lid_velocity: float = 1.0
    L: float = 1.0
    cfl: float = 0.5
    solver: str = "cg"          # 'cg' | 'bicgstab' | 'gmres' | 'direct'
    tol: float = 1e-8
    maxiter: int = 2000
    precond: str = "jacobi"     # 'none' | 'jacobi' | 'amg' | 'fsai'
    precision: str = "full"     # 'full' | 'mixed' (f32 inner pressure CG)
    dt: Optional[float] = None  # explicit time step (default: CFL rule)
    device: str = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        if self.ny is None:
            self.ny = self.nx


class LDCSolver:
    """Lid-driven cavity solver with a pluggable pressure solve (the
    reference's BaseLDCSolver and its per-backend subclasses)."""

    def __init__(self, config: LDCConfig):
        cfg = self.config = config
        if cfg.solver not in _SOLVERS and cfg.solver != "direct":
            raise ValueError(f"unknown solver {cfg.solver!r}; use "
                             f"{', '.join(_SOLVERS)} or direct")
        nx, ny = cfg.nx, cfg.ny
        self.device = torch.device(cfg.device)
        self.dx = cfg.L / nx
        self.dy = cfg.L / ny
        self.nu = cfg.lid_velocity * cfg.L / cfg.Re
        # CFL-limited dt (reference :59-61): convective and viscous limits
        self.dt = cfg.dt if cfg.dt is not None else cfg.cfl * min(
            self.dx / cfg.lid_velocity, 0.25 * self.dx**2 / self.nu)
        self.A = build_pressure_matrix(nx, ny, self.dx, self.dy,
                                       dtype=numpy_dtype(cfg.dtype),
                                       device=self.device)
        # direct pressure solves need the null space pinned, not projected
        self.A_pin = (pin_pressure_matrix(self.A)
                      if cfg.solver == "direct" else None)
        if cfg.precond == "jacobi":
            self.M = jacobi_preconditioner(self.A)
        elif cfg.precond == "amg":
            self.M = amg_preconditioner(self.A)
        elif cfg.precond == "fsai":
            self.M = fsai_preconditioner(self.A)
        elif cfg.precond == "none":
            self.M = None
        else:
            raise ValueError(f"unknown precond {cfg.precond!r}; use none, "
                             "jacobi, amg or fsai")
        kw = dict(dtype=cfg.dtype, device=self.device)
        self.u = torch.zeros((ny + 2, nx + 1), **kw)
        self.v = torch.zeros((ny + 1, nx + 2), **kw)
        self.p = torch.zeros((ny, nx), **kw)

    # -- physics ---------------------------------------------------------

    def _apply_bcs(self, u, v):
        nx, ny, Ulid = self.config.nx, self.config.ny, \
            self.config.lid_velocity
        u = u.clone()
        v = v.clone()
        # side walls: u = 0 at boundary faces
        u[:, 0] = 0.0
        u[:, nx] = 0.0
        # bottom no-slip ghost / top lid ghost (u_ghost = 2U - u_int)
        u[0, :] = -u[1, :]
        u[ny + 1, :] = 2.0 * Ulid - u[ny, :]
        # top/bottom walls: v = 0 at boundary faces
        v[0, :] = 0.0
        v[ny, :] = 0.0
        # side no-slip ghosts
        v[:, 0] = -v[:, 1]
        v[:, nx + 1] = -v[:, nx]
        return u, v

    def _momentum(self, u, v):
        nx, ny = self.config.nx, self.config.ny
        dx, dy, nu, dt = self.dx, self.dy, self.nu, self.dt
        # u* on interior faces (j = 1..ny, i = 1..nx-1)
        uc = u[1:-1, 1:-1]
        ue = 0.5 * (u[1:-1, 1:-1] + u[1:-1, 2:])
        uw = 0.5 * (u[1:-1, :-2] + u[1:-1, 1:-1])
        un = 0.5 * (u[1:-1, 1:-1] + u[2:, 1:-1])
        us = 0.5 * (u[:-2, 1:-1] + u[1:-1, 1:-1])
        vn = 0.5 * (v[1:, 1:nx] + v[1:, 2:nx + 1])
        vs = 0.5 * (v[:-1, 1:nx] + v[:-1, 2:nx + 1])
        conv = (ue**2 - uw**2) / dx + (un * vn - us * vs) / dy
        lap = ((u[1:-1, 2:] - 2 * uc + u[1:-1, :-2]) / dx**2
               + (u[2:, 1:-1] - 2 * uc + u[:-2, 1:-1]) / dy**2)
        u_star = u.clone()
        u_star[1:-1, 1:-1] = uc + dt * (-conv + nu * lap)

        # v* on interior faces (j = 1..ny-1, i = 1..nx)
        vc = v[1:-1, 1:-1]
        vn2 = 0.5 * (v[1:-1, 1:-1] + v[2:, 1:-1])
        vs2 = 0.5 * (v[:-2, 1:-1] + v[1:-1, 1:-1])
        ve = 0.5 * (v[1:-1, 1:-1] + v[1:-1, 2:])
        vw = 0.5 * (v[1:-1, :-2] + v[1:-1, 1:-1])
        ue2 = 0.5 * (u[1:ny, 1:] + u[2:ny + 1, 1:])
        uw2 = 0.5 * (u[1:ny, :-1] + u[2:ny + 1, :-1])
        conv_v = (ue2 * ve - uw2 * vw) / dx + (vn2**2 - vs2**2) / dy
        lap_v = ((v[1:-1, 2:] - 2 * vc + v[1:-1, :-2]) / dx**2
                 + (v[2:, 1:-1] - 2 * vc + v[:-2, 1:-1]) / dy**2)
        v_star = v.clone()
        v_star[1:-1, 1:-1] = vc + dt * (-conv_v + nu * lap_v)
        return u_star, v_star

    def _pressure_rhs(self, u_star, v_star):
        div = ((u_star[1:-1, 1:] - u_star[1:-1, :-1]) / self.dx
               + (v_star[1:, 1:-1] - v_star[:-1, 1:-1]) / self.dy)
        rhs = -div.reshape(-1) / self.dt  # negated: A = -laplacian is PSD
        # project out the null-space component of the singular Neumann
        # system (exact analytically; this removes round-off drift)
        return rhs - torch.mean(rhs)

    def _solve_pressure(self, rhs, p_prev):
        cfg = self.config
        if cfg.solver == "direct":
            # the reference's module-C step (a cuDSS spsolve per step): a
            # banded direct solve of the row-0-pinned system, no iterations
            rhs = rhs.clone()
            rhs[0] = 0.0
            x = banded_solve(self.A_pin, rhs)
            x = x - torch.mean(x)
            return x.reshape(cfg.ny, cfg.nx), torch.zeros(
                (), dtype=torch.int64, device=self.device)
        fn = _SOLVERS[cfg.solver][1 if cfg.precision == "mixed" else 0]
        x, _, iters, _ = fn(self.A, rhs, p_prev.reshape(-1), tol=cfg.tol,
                            maxiter=cfg.maxiter, M=self.M)
        x = x - torch.mean(x)
        return x.reshape(cfg.ny, cfg.nx), iters

    def _correct(self, u_star, v_star, p):
        dt = self.dt
        u = u_star.clone()
        v = v_star.clone()
        u[1:-1, 1:-1] += -dt * (p[:, 1:] - p[:, :-1]) / self.dx
        v[1:-1, 1:-1] += -dt * (p[1:, :] - p[:-1, :]) / self.dy
        return u, v

    def _mass_residual(self, u, v):
        div = ((u[1:-1, 1:] - u[1:-1, :-1]) / self.dx
               + (v[1:, 1:-1] - v[:-1, 1:-1]) / self.dy)
        return torch.sqrt(torch.mean(div**2))

    def _step(self, u, v, p):
        """One time step; returns (u, v, p, mass residual, pressure
        iterations), the last two as device scalars."""
        u, v = self._apply_bcs(u, v)
        u_star, v_star = self._momentum(u, v)
        u_star, v_star = self._apply_bcs(u_star, v_star)
        rhs = self._pressure_rhs(u_star, v_star)
        p_new, iters = self._solve_pressure(rhs, p)
        u, v = self._correct(u_star, v_star, p_new)
        u, v = self._apply_bcs(u, v)
        return u, v, p_new, self._mass_residual(u, v), iters

    # -- time stepping -------------------------------------------------

    def step(self):
        self.u, self.v, self.p, mres, iters = self._step(self.u, self.v,
                                                         self.p)
        return float(mres), int(iters)

    def run(self, nsteps: int, verbose: bool = False, chunk: int = 100
            ) -> dict:
        """Advance ``nsteps``, reading the mass residual and the pressure
        iterations from the device once per ``chunk`` steps."""
        t0 = time.perf_counter()
        mres, iters_total, done = 0.0, 0, 0
        while done < nsteps:
            k = min(chunk, nsteps - done)
            iters = torch.zeros((), dtype=torch.int64, device=self.device)
            for _ in range(k):
                self.u, self.v, self.p, mres_t, it = self._step(
                    self.u, self.v, self.p)
                iters = iters + it
            mres, it_chunk = float(mres_t), int(iters)
            iters_total += it_chunk
            done += k
            if verbose:
                print(f"step {done:5d}  mass-res {mres:.3e}  "
                      f"p-iters(chunk) {it_chunk}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        return {
            "steps": nsteps,
            "elapsed_s": elapsed,
            "steps_per_s": nsteps / elapsed,
            "mass_residual": mres,
            "pressure_iters_total": iters_total,
        }

    def velocity_magnitude(self) -> np.ndarray:
        """Cell-centred |u| on the host, for inspection."""
        uc = 0.5 * (self.u[1:-1, :-1] + self.u[1:-1, 1:])
        vc = 0.5 * (self.v[:-1, 1:-1] + self.v[1:, 1:-1])
        return torch.sqrt(uc**2 + vc**2).cpu().numpy()

    def save_plot(self, path: str) -> str:
        """Velocity-magnitude contour + streamlines PNG (reference
        ldc_solver_common.py:255-297)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        nx, ny = self.config.nx, self.config.ny
        xc = (np.arange(nx) + 0.5) * self.dx
        yc = (np.arange(ny) + 0.5) * self.dy
        uc = (0.5 * (self.u[1:-1, :-1] + self.u[1:-1, 1:])).cpu().numpy()
        vc = (0.5 * (self.v[:-1, 1:-1] + self.v[1:, 1:-1])).cpu().numpy()
        mag = np.sqrt(uc**2 + vc**2)
        fig, ax = plt.subplots(figsize=(6, 5))
        cs = ax.contourf(xc, yc, mag, levels=24)
        fig.colorbar(cs, ax=ax, label="|u|")
        ax.streamplot(xc, yc, uc, vc, color="w", density=1.2, linewidth=0.6)
        ax.set_title(f"Lid-driven cavity  Re={self.config.Re:g}  "
                     f"{nx}x{ny}  ({self.config.solver}/"
                     f"{self.config.precond})")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_aspect("equal")
        fig.tight_layout()
        fig.savefig(path, dpi=130)
        plt.close(fig)
        return path

    def save_state(self, path: str) -> str:
        """Checkpoint (u, v, p) to an .npz file."""
        np.savez(path, u=self.u.cpu().numpy(), v=self.v.cpu().numpy(),
                 p=self.p.cpu().numpy())
        return path

    def restore_state(self, path: str) -> None:
        data = np.load(path)
        if data["u"].shape != tuple(self.u.shape):
            raise ValueError(
                f"checkpoint grid {data['p'].shape} does not match solver "
                f"grid {(self.config.ny, self.config.nx)}; construct the "
                "solver with the checkpoint's --nx")
        for name in ("u", "v", "p"):
            setattr(self, name, torch.from_numpy(data[name]).to(
                self.device, self.config.dtype))


def run_solver_cli(argv=None):
    """CLI of the reference's run_solver_cli: --nx --Re --steps --method
    --precond --quick."""
    import argparse

    ap = argparse.ArgumentParser(
        description="FVM lid-driven cavity on tpu_sparse_torch")
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--Re", type=float, default=100.0)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--dt", type=float, default=None,
                    help="explicit time step (default: CFL rule)")
    ap.add_argument("--method", default="cg",
                    choices=["cg", "bicgstab", "gmres", "direct", "amg"])
    ap.add_argument("--precond", default="jacobi",
                    choices=["none", "jacobi", "amg", "fsai"])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-precision pressure solves (f32 inner "
                         "sweeps, f64 refinement)")
    ap.add_argument("--f32", action="store_true",
                    help="single precision (pressure tolerance relaxed to "
                         "an f32-reachable 2e-5)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save-state", default=None,
                    help="write the final (u, v, p) to this .npz")
    ap.add_argument("--restore-state", default=None,
                    help="resume from a saved .npz state")
    args = ap.parse_args(argv)
    if args.quick:
        args.nx, args.steps = 32, 100
    method, precond = args.method, args.precond
    if method == "amg":
        method, precond = "cg", "amg"
    cfg = LDCConfig(nx=args.nx, Re=args.Re, solver=method, precond=precond,
                    tol=2e-5 if args.f32 else 1e-8,
                    precision="mixed" if args.mixed else "full",
                    dt=args.dt, device=args.device,
                    dtype=torch.float32 if args.f32 else torch.float64)
    solver = LDCSolver(cfg)
    if args.restore_state:
        solver.restore_state(args.restore_state)
    stats = solver.run(args.steps, verbose=True)
    print(f"\n{stats['steps']} steps in {stats['elapsed_s']:.2f}s "
          f"({stats['steps_per_s']:.1f} steps/s), "
          f"final mass residual {stats['mass_residual']:.3e}")
    if args.save_state:
        print("state saved to", solver.save_state(args.save_state))
    return stats


if __name__ == "__main__":
    run_solver_cli()
