"""The right-hand-side pool: a mix with ``base_seed`` sends every seed the
same work (each entry a fixed b times a sign and a power of two drawn
from the seed), and one without it draws new vectors from the seed."""

import _harness  # noqa: F401
import torch

from benchmark.core import cells, stencil
from benchmark.core.program import Program
from benchmark.reference import hpcg as ref

GRID = (12, 12, 12)
SEEDS = (2147483711, 2147483999)


def _pools(base_seed):
    data, offsets = stencil.diagonals(GRID, 26.0, -1.0, torch.float32, "cpu")
    return data, offsets, [stencil.rhs_pool(data, offsets, 8, 1, s, base_seed)
                           for s in SEEDS]


def test_base_seed_pools_differ_by_exact_factors():
    _, _, (p, q) = _pools(base_seed=1)
    differs = False
    for a, b in zip(p, q):
        f = float(b[0] / a[0])
        # the ratio of two factors in [1/4, 4]
        assert abs(f) in [2.0 ** k for k in range(-4, 5)]
        assert torch.equal(b, a * f)
        differs |= f != 1.0
    assert differs


def test_seed_pools_without_base_seed_differ():
    _, _, (p, q) = _pools(base_seed=None)
    assert not any(torch.equal(a, b) for a, b in zip(p, q))


def test_every_seed_sends_the_same_iterations():
    """The reference CG and the AMG cell's own entry take the same
    iterations on each entry, whatever the seed."""
    data, offsets, (p, q) = _pools(base_seed=1)
    tr = cells.load_cell(_harness.ROOT, cells.load_benchmark(_harness.ROOT),
                         "hpcg256.amgpcg_f32").traffic
    assert tr["base_seed"] == 1
    program = Program(tr["entry"], tr["kwargs"], 1e-6, 1000)
    A = program.matrix(data, offsets, data.shape[1])
    for a, b in zip(p, q):
        assert ref.cg(data, offsets, a, 1e-6, 1000, torch.float32)[1] == \
            ref.cg(data, offsets, b, 1e-6, 1000, torch.float32)[1]
        assert program.solve(A, a)[2] == program.solve(A, b)[2]
