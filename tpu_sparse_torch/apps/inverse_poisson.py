"""Inverse problem demo: differentiating through a sparse solve.

Counterpart of ``examples/inverse_poisson.py``. Recovers a spatially
varying conductivity sigma from an observed solution of the 1-D diffusion
equation -(sigma u')' = f by gradient descent through the CG solve
(``autodiff.cg_diff``), the gradient taken in the values of the float64
DIA matrix (the capability the reference only documents for its
AMGX/cuDSS backends, torch_amgx.py:443-462). On the card every matvec of
the solve and of its adjoint is kernel 1's float64 build (K3).

    python -m tpu_sparse_torch.apps.inverse_poisson [--n 64] [--steps 200]
        [--cpu]

The grid and sigma_true are made in numpy and moved to the device, so a
run on the card and one on the CPU start from the same bits. ``main``
returns the final max |sigma - sigma_true|, as the JAX demo does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_sparse_torch.autodiff import cg_diff
from tpu_sparse_torch.sparse.containers import DIA


def assemble(sigma: torch.Tensor) -> DIA:
    """Tridiagonal FV discretization of -(sigma u')' with face-averaged
    coefficients; sigma lives on n+1 faces for n cells (h=1)."""
    n = sigma.shape[0] - 1
    lo = -sigma[:-1]
    hi = -sigma[1:]
    diag = sigma[:-1] + sigma[1:]
    zero = sigma.new_zeros(1)
    data = torch.stack([torch.cat([zero, lo[1:]]), diag,
                        torch.cat([hi[:-1], zero])])
    return DIA(data, (-1, 0, 1), (n, n))


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    device = torch.device("cpu" if args.cpu else "cuda")
    n = args.n
    x_grid = np.linspace(0, 1, n + 1)
    sigma_true = torch.from_numpy(
        1.0 + 0.8 * np.sin(2 * np.pi * x_grid) ** 2).to(device)
    f = torch.ones(n, dtype=torch.float64, device=device)

    u_obs = cg_diff(assemble(sigma_true), f, tol=1e-12)[0]

    theta = torch.zeros(n + 1, dtype=torch.float64, device=device)  # sigma=1
    for i in range(args.steps):
        log_sigma = theta.detach().requires_grad_()
        u = cg_diff(assemble(torch.exp(log_sigma)), f, tol=1e-12)[0]
        val = torch.mean((u - u_obs) ** 2)
        (g,) = torch.autograd.grad(val, log_sigma)
        theta = theta - args.lr * g / (torch.linalg.vector_norm(g) + 1e-12)
        if (i + 1) % max(1, args.steps // 10) == 0:
            err = float((torch.exp(theta) - sigma_true).abs().max())
            print(f"step {i+1:4d}  loss {float(val.detach()):.3e}  "
                  f"max|sigma-sigma_true| {err:.3f}", flush=True)

    final_err = float((torch.exp(theta) - sigma_true).abs().max())
    print(f"\nrecovered sigma, max abs error {final_err:.3f} "
          f"(true field range [1.0, 1.8])")
    return final_err


if __name__ == "__main__":
    main()
