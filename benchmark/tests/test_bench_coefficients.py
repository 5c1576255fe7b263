"""A configuration's own 27-point coefficients and the references of the
nonsymmetric solves: the HPCG cells build the same bytes as before, the
convection-diffusion configuration builds the port's generator's bytes,
a key that does not parse is refused when the cell loads, and the plain
BiCGStab and GMRES agree with scipy's."""

import json

import _harness
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

from benchmark.core import cells, judge, stencil
from benchmark.reference import hpcg, krylov

CONVDIFF = {"-1,0,0": -1.3, "1,0,0": -0.7}


def _before(grid, diagonal, neighbour, dtype, device):
    """The construction of the diagonals before a configuration could give
    coefficients, kept as it was."""
    nx, ny, nz = (int(g) for g in grid)
    stencil_ = sorted((dx + nx * dy + nx * ny * dz, dx, dy, dz)
                      for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                      for dx in (-1, 0, 1))
    data = torch.empty((len(stencil_), nx * ny * nz), dtype=dtype,
                       device=device)

    def inside(size, d):
        i = torch.arange(size, device=device)
        return (i + d >= 0) & (i + d < size)

    for k, (o, dx, dy, dz) in enumerate(stencil_):
        plane = data[k].view(nz, ny, nx)
        if o == 0:
            plane.fill_(diagonal)
            continue
        mask = (inside(nz, dz)[:, None, None] & inside(ny, dy)[None, :, None]
                & inside(nx, dx)[None, None, :])
        plane.zero_()
        plane.masked_fill_(mask, neighbour)
    return data, tuple(s[0] for s in stencil_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", [(8, 8, 8), (10, 12, 14)])
def test_without_the_key_the_bytes_are_unchanged(grid, dtype):
    """The four HPCG cells' diagonals and pool, bit for bit."""
    old, old_offsets = _before(grid, 26.0, -1.0, dtype, "cpu")
    for spec in (None, {}):
        data, offsets = stencil.diagonals(grid, 26.0, -1.0, dtype, "cpu",
                                          spec)
        assert offsets == old_offsets
        assert data.dtype == dtype and torch.equal(data, old)
    for base_seed in (None, 1):
        new_pool = stencil.rhs_pool(data, offsets, 3, 1, 2147483777,
                                    base_seed)
        old_pool = stencil.rhs_pool(old, old_offsets, 3, 1, 2147483777,
                                    base_seed)
        assert all(torch.equal(a, b) for a, b in zip(new_pool, old_pool))


@pytest.mark.parametrize("nx", [6, 9])
def test_convdiff_config_is_the_ports_generator(nx):
    from tpu_sparse_torch.sparse.generators import \
        convection_diffusion_3d_27pt

    cfg = _harness.convdiff_config()
    A = convection_diffusion_3d_27pt(nx, beta=0.3, device="cpu")
    data, offsets = stencil.diagonals(
        [nx] * 3, cfg["diagonal"], cfg["neighbour"],
        stencil.dtype_of(cfg["dtype"]), "cpu",
        cells.coefficients(cfg["coefficients"]))
    assert offsets == tuple(A.offsets)
    assert data.dtype == A.data.dtype and torch.equal(data, A.data)


def test_any_constant_stencil():
    """Every neighbour can take its own value (an anisotropic diffusion, a
    skew along each axis), and the others keep ``neighbour``."""
    grid = (5, 6, 7)
    spec = {f"{dx},{dy},{dz}": 0.5 + dx + 3 * dy + 9 * dz
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dx, dy, dz) != (0, 0, 0) and dz >= 0}
    data, offsets = stencil.diagonals(grid, 40.0, -2.0, torch.float64, "cpu",
                                      cells.coefficients(spec))
    nx, ny, nz = grid
    n = nx * ny * nz
    dense = torch.zeros((n, n), dtype=torch.float64)
    for d, o in enumerate(offsets):
        for i in range(n):
            if 0 <= i + o < n:
                dense[i, i + o] = data[d, i]
    for i in range(n):
        x, y, z = i % nx, (i // nx) % ny, i // (nx * ny)
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    j = (x + dx) + nx * (y + dy) + nx * ny * (z + dz)
                    if not (0 <= x + dx < nx and 0 <= y + dy < ny
                            and 0 <= z + dz < nz):
                        continue
                    want = 40.0 if (dx, dy, dz) == (0, 0, 0) else spec.get(
                        f"{dx},{dy},{dz}", -2.0)
                    assert float(dense[i, j]) == want
    assert int((dense != 0).sum()) == sum(
        (nx - abs(dx)) * (ny - abs(dy)) * (nz - abs(dz))
        for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


@pytest.mark.parametrize("spec", [
    {"0,0,0": 1.0}, {"2,0,0": 1.0}, {"1,0": 1.0}, {"a,b,c": 1.0},
    {"1,0,0": "x"}, {"1,0,0": float("nan")}, {"1,0,0": True},
    {"1, 0,0": 1.0}, {"1,0,-0": 1.0}, [["1,0,0", 1.0]]])
def test_a_bad_key_is_refused_when_the_cell_loads(tmp_path, spec):
    root = _harness.convdiff_checkout(tmp_path)
    path = root / "benchmark" / "configs" / "convdiff27_256.json"
    cfg = json.loads(path.read_text())
    cfg["coefficients"] = spec
    path.write_text(json.dumps(cfg))
    with pytest.raises(cells.CellError):
        cells.load_cell(root, cells.load_benchmark(root),
                        "convdiff256.bicgstab_f32")
    with pytest.raises(cells.CellError):
        cells.coefficients(spec)


@pytest.mark.parametrize("check,kwargs,method", [
    (True, {"method": "cg"}, "cg"), (True, {"mode": "halo"}, "cg"),
    (False, {"backend": "amg"}, "cg"), (None, {}, "cg"),
    (True, {"method": "bicgstab"}, "bicgstab"),
    (True, {"method": "gmres", "restart": 30}, "gmres"),
    (False, {"method": "minres"}, "minres"),
    (True, {"method": "minres"}, cells.CellError),
    (False, {"method": "gmres"}, cells.CellError),
    (True, {"method": "gmres", "restart": 0}, cells.CellError),
    ("bicgstab", {"method": "bicgstab"}, cells.CellError)])
def test_the_check_runs_the_mixs_own_method(check, kwargs, method):
    """The reference is the method the mix solves with, never a second
    name for it; a checked method with no reference, a GMRES mix with no
    restart or an ``iteration_reference`` that is not true or false is
    refused."""
    traffic = {"kwargs": kwargs}
    if check is not None:
        traffic["iteration_reference"] = check
    if method is cells.CellError:
        with pytest.raises(cells.CellError):
            cells.method_of(traffic)
    else:
        assert cells.method_of(traffic) == method


def test_the_cg_check_runs_the_cg_it_ran():
    """The CG cells' iteration reference is ``hpcg.cg`` as before."""
    data, offsets = stencil.diagonals((8, 8, 8), 26.0, -1.0, torch.float32,
                                      "cpu")
    b = stencil.rhs_pool(data, offsets, 1, 1, 2147483801)[0]
    cfg = {"tol": 1e-6, "maxiter": 1000}
    x, it, conv = judge.reference_solve("cg", cfg, {}, data, offsets, b)
    x0, it0, conv0 = hpcg.cg(data, offsets, b, 1e-6, 1000)
    assert (it, conv) == (it0, conv0) and torch.equal(x, x0)


def _system(grid, seed):
    data, offsets = stencil.diagonals(grid, 26.0, -1.0, torch.float64, "cpu",
                                      cells.coefficients(CONVDIFF))
    n = data.shape[1]
    A = sp.dia_matrix((np.stack([np.roll(data[d].numpy(), o)
                                 for d, o in enumerate(offsets)]), offsets),
                      shape=(n, n)).tocsr()
    gen = torch.Generator().manual_seed(seed)
    b = hpcg.matvec(data, offsets,
                    torch.randn(n, dtype=torch.float64, generator=gen))
    assert np.abs(A @ np.ones(n) - hpcg.matvec(
        data, offsets, torch.ones(n, dtype=torch.float64)).numpy()).max() == 0
    return data, offsets, A, b


@pytest.mark.parametrize("grid", [(16, 16, 16), (24, 20, 18)])
def test_bicgstab_agrees_with_scipy(grid):
    data, offsets, A, b = _system(grid, 5)
    x, it, conv = krylov.bicgstab(data, offsets, b, 1e-10, 1000)
    ref, info = sla.bicgstab(A, b.numpy(), rtol=1e-10, atol=0.0,
                             maxiter=1000)
    assert conv and info == 0 and 10 < it < 100
    assert max(hpcg.rel_residuals(data, offsets, x, b)) <= 1e-10
    assert np.linalg.norm(x.numpy() - ref) <= 1e-8 * np.linalg.norm(ref)


@pytest.mark.parametrize("grid,restart", [((16, 16, 16), 30),
                                          ((24, 20, 18), 30),
                                          ((12, 12, 12), 5)])
def test_gmres_agrees_with_scipy(grid, restart):
    data, offsets, A, b = _system(grid, 7)
    x, cycles, conv = krylov.gmres(data, offsets, b, 1e-10, 1000, restart)
    seen = []
    ref, info = sla.gmres(A, b.numpy(), rtol=1e-10, atol=0.0,
                          restart=restart, maxiter=1000,
                          callback=seen.append, callback_type="x")
    assert conv and info == 0 and cycles >= 2
    assert abs(cycles - len(seen)) <= 1
    assert max(hpcg.rel_residuals(data, offsets, x, b)) <= 1e-10
    assert np.linalg.norm(x.numpy() - ref) <= 1e-8 * np.linalg.norm(ref)


def test_references_report_what_they_could_not_do():
    """maxiter reached: not converged, the count at maxiter; a zero b:
    converged at once."""
    data, offsets, _, b = _system((10, 10, 10), 9)
    x, it, conv = krylov.bicgstab(data, offsets, b, 1e-12, 3)
    assert (it, conv) == (3, False)
    x, cycles, conv = krylov.gmres(data, offsets, b, 1e-14, 2, 4)
    assert (cycles, conv) == (2, False)
    zero = torch.zeros_like(b)
    assert krylov.bicgstab(data, offsets, zero, 1e-6, 10)[1:] == (0, True)
    assert krylov.gmres(data, offsets, zero, 1e-6, 10, 5)[1:] == (0, True)
