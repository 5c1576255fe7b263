"""The 27-point operator and the right-hand-side pool, made on the device.

The diagonals are a constant-coefficient 27-point stencil on a grid, with
the x index running fastest: the configuration's ``diagonal`` on the main
diagonal and its ``neighbour`` for each neighbour inside the grid, unless
its ``coefficients`` (parsed by ``cells.coefficients``) give that neighbour
a value of its own; 0 where the neighbour falls outside. HPCG's problem
(``GenerateProblem``) is 26 and -1 with no map; the port's
``convection_diffusion_3d_27pt`` at beta is HPCG's with the -x neighbour
-(1 + beta) and the +x neighbour -(1 - beta). Offsets are sorted, as the
port's ``poisson3d_27pt`` sorts them, and the tensor is handed as it is to
the program (through its public ``DIA``) and to the reference.
"""

from __future__ import annotations

import random

import torch

from benchmark.reference import hpcg as ref

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def diagonals(grid, diagonal: float, neighbour: float, dtype: torch.dtype,
              device, coefficients=None) -> "tuple[torch.Tensor, tuple]":
    """(data (27, n), sorted offsets) of the 27-point operator on the grid
    (nx, ny, nz), built by a few large torch calls on ``device``.
    ``coefficients``: {(dx, dy, dz): the value of that neighbour inside
    the grid}, or None; neighbours it does not name take ``neighbour``."""
    values = coefficients or {}
    nx, ny, nz = (int(g) for g in grid)
    stencil = sorted((dx + nx * dy + nx * ny * dz, dx, dy, dz)
                     for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dx in (-1, 0, 1))
    data = torch.empty((len(stencil), nx * ny * nz), dtype=dtype,
                       device=device)

    def inside(size, d):
        i = torch.arange(size, device=device)
        return (i + d >= 0) & (i + d < size)

    for k, (o, dx, dy, dz) in enumerate(stencil):
        plane = data[k].view(nz, ny, nx)
        if o == 0:
            plane.fill_(diagonal)
            continue
        mask = (inside(nz, dz)[:, None, None] & inside(ny, dy)[None, :, None]
                & inside(nx, dx)[None, None, :])
        plane.zero_()
        plane.masked_fill_(mask, values.get((dx, dy, dz), neighbour))
    return data, tuple(s[0] for s in stencil)


def rhs_pool(data: torch.Tensor, offsets, pool: int, columns: int,
             seed: int, base_seed=None) -> list:
    """``pool`` right-hand sides b_j = A x_j, x_j standard normal from a
    generator on the data's device; b_j is computed in float64 by the
    reference product and rounded to the data's dtype. Shape (n,) for one
    column, else (n, columns).

    Without ``base_seed`` the generator is seeded with ``seed``. With it,
    x_j comes from ``base_seed``, the same for every seed, and ``seed``
    draws for each entry a sign and a power of two in [1/4, 4] that
    multiply b_j. Both are exact in floating point and every solver step
    is linear in b, so each entry takes the same iterations whatever the
    seed: every seed sends the same work, in its own order and with its
    own answers."""
    n = data.shape[1]
    gen = torch.Generator(device=data.device)
    gen.manual_seed(int(seed if base_seed is None else base_seed)
                    % (1 << 63))
    factors = [1.0] * pool
    if base_seed is not None:
        rng = random.Random(int(seed) * 6007 + 11)
        factors = [rng.choice((-1.0, 1.0)) * 2.0 ** rng.randint(-2, 2)
                   for _ in range(pool)]
    shape = (n,) if columns == 1 else (n, columns)
    out = []
    for f in factors:
        x = torch.randn(shape, generator=gen, device=data.device,
                        dtype=torch.float32)
        y = ref.matvec(data, offsets, x)
        if f != 1.0:
            y.mul_(f)
        out.append(y.to(data.dtype))
        del x, y
    return out
