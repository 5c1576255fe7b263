"""tpu_sparse_torch.direct.supernodal and direct.ordering against
tpu_sparse.direct on the CPU.

The host structures equal JAX's integer for integer (the nested-dissection
permutation and part sizes, the aligned row map, the level ranges, the row
groups and the index maps) at poisson2d(32) with leaf = 64 and at
convection_diffusion_3d_27pt(8), and the inverses of the port's diagonal
blocks agree with JAX's pre-inverted blocks within 1e-12 of their
largest entry. The solves (solve, solve_transpose, an (n, k) b, the
b-gradient of ``supernodal_solve_diff``) agree with JAX's within 1e-5
relative in float32 and 1e-10 in float64; on the CPU the level packs run
the plain CWELL SpMV and SpMM. JAX's solves of one factor run as one
jitted program: each costs seconds to compile on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpu_sparse.direct import ordering as jord
from tpu_sparse.direct.supernodal import SupernodalLU as JLU
from tpu_sparse.direct.supernodal import supernodal_solve_diff as j_diff
from tpu_sparse.sparse import convert as jconv
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch.direct import ordering as tord
from tpu_sparse_torch.direct import supernodal as tsn
from tpu_sparse_torch.sparse import convert as tconv
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

TOL = {np.float32: 1e-5, np.float64: 1e-10}
_STRUCT = ("rangesL", "rangesU", "metaL", "metaU", "metaLT", "metaUT")
_INDEX = ("in_idx", "mid_idx", "out_idx", "in_idx_t", "mid_idx_t",
          "out_idx_t")


def _pair(Aj):
    """A JAX CSR and the port's CSR of the same arrays."""
    Aj = jconv.to_csr(Aj)
    return Aj, tconv.csr_from_arrays(
        np.asarray(Aj.data), np.asarray(Aj.indices), np.asarray(Aj.indptr),
        Aj.shape, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


SYSTEMS = {
    "poisson2d_32": (lambda dt: jgen.poisson2d(32, dtype=dt), 64),
    "convdiff3d_8": (lambda dt: jgen.convection_diffusion_3d_27pt(
        8, beta=0.4, dtype=dt), 896),
}


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_host_structures_equal_jax(name):
    make, leaf = SYSTEMS[name]
    Aj, At = _pair(make(np.float64))
    S = sp.csr_matrix((np.asarray(Aj.data), np.asarray(Aj.indices),
                       np.asarray(Aj.indptr)), shape=Aj.shape)
    pj, sj = jord.nested_dissection(S, leaf=leaf)
    pt, st = tord.nested_dissection(S, leaf=leaf)
    assert np.array_equal(pj, pt) and np.array_equal(sj, st)
    for block in (128, 64):
        mj, nj = jord.aligned_row_map(sj, block)
        mt, nt = tord.aligned_row_map(st, block)
        assert nj == nt and np.array_equal(mj, mt)
    lj = JLU.factor(Aj, leaf=leaf)
    lt = tsn.SupernodalLU.factor(At, leaf=leaf)
    assert lj.n_levels == lt.n_levels and lj.n_pad == lt.n_pad
    for k in _STRUCT:
        assert getattr(lj, k) == getattr(lt, k), k
    for k in _INDEX:
        assert np.array_equal(np.asarray(getattr(lj, k)),
                              getattr(lt, k).numpy()), k
    # JAX keeps the blocks' inverses, the port the blocks
    for k in ("diagL", "diagU"):
        inv = np.linalg.inv(getattr(lt, k).numpy())
        ref = np.asarray(getattr(lj, k))
        assert np.abs(inv - ref).max() <= 1e-12 * np.abs(ref).max(), k
    # every non-empty row group is one CWELL spanning the padded columns
    for packs, meta in ((lt.packsL, lt.metaL), (lt.packsUT, lt.metaUT)):
        for groups, shapes in zip(packs, meta):
            for N, (_, rows) in zip(groups or (), shapes or ()):
                assert N is None or (type(N).__name__ == "CWELL"
                                     and N.shape == (rows, lt.n_pad))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_solves_match_jax(dtype):
    """solve, solve_transpose, an (n, 3) b and the b-gradient against
    JAX's, on a nonsymmetric system factored by both packages."""
    Aj, At = _pair(jgen.convection_diffusion_3d_27pt(10, beta=0.4,
                                                     dtype=dtype))
    n = At.shape[0]
    lj = JLU.factor(Aj)
    lt = tsn.SupernodalLU.factor(At)
    assert lt.diagL.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    rng = np.random.default_rng(21)
    b = rng.standard_normal(n).astype(dtype)
    B = rng.standard_normal((n, 3)).astype(dtype)
    w = rng.standard_normal(n).astype(dtype)
    ref = jax.jit(lambda L, bb, BB, ww: (
        L.solve(bb), L.solve_transpose(bb), L.solve(BB),
        jax.grad(lambda q: jnp.vdot(ww, j_diff(L, q)))(bb)))(
        lj, jnp.asarray(b), jnp.asarray(B), jnp.asarray(w))
    bt = torch.from_numpy(b).requires_grad_()
    x = tsn.supernodal_solve_diff(lt, bt)
    (x * torch.from_numpy(w)).sum().backward()
    got = (x.detach(), lt.solve_transpose(torch.from_numpy(b)),
           lt.solve(torch.from_numpy(B)), bt.grad)
    for name, a, r in zip(("solve", "solve_transpose", "solve (n, 3)",
                           "b-gradient"), got, ref):
        assert a.dtype == bt.dtype and a.shape == r.shape
        assert _rel(a.numpy(), r) <= TOL[dtype], name
    # the (n, k) solve equals the single solves of its columns
    for j in range(3):
        xj = tsn.supernodal_solve(lt, torch.from_numpy(B[:, j].copy()))
        assert _rel(got[2][:, j].numpy(), xj.numpy()) <= TOL[dtype]


def test_level_solve_and_refusals(monkeypatch):
    """The level solve with the plain SpMV of the compact plan
    (``reference.cwell_compact_spmv``, what K4 / K5 compute on the card)
    equals the one through ``kernels.spmv``; ``with_transpose=False``
    refuses the transpose solve; a singular matrix raises; the factored
    solve's gradients are A^-T x_bar and -v x^T on A's pattern."""
    from tpu_sparse_torch.kernels import reference as ref
    from tpu_sparse_torch.sparse import cwell_compact

    _, At = _pair(jgen.poisson2d(24, dtype=np.float64))
    lt = tsn.SupernodalLU.factor(At, with_transpose=False)
    b = torch.from_numpy(np.random.default_rng(22).standard_normal(
        At.shape[0]))
    bp = lt._scatter(b, lt.in_idx)
    y = tsn._level_solve(lt.diagL, lt.packsL, lt.metaL, lt.rangesL, bp,
                         lower=True, transpose=False)
    calls = []

    def plain(W, v):
        calls.append(W.shape)
        return ref.cwell_compact_spmv(*cwell_compact.compact(W), v)

    monkeypatch.setattr(tsn, "spmv", plain)
    y0 = tsn._level_solve(lt.diagL, lt.packsL, lt.metaL, lt.rangesL, bp,
                          lower=True, transpose=False)
    monkeypatch.undo()
    assert calls and _rel(y.numpy(), y0.numpy()) <= 1e-14
    with pytest.raises(ValueError, match="with_transpose=False"):
        lt.solve_transpose(b)
    bad = tconv.csr_from_arrays(np.array([1.0, 0.0]), np.array([0, 1]),
                                np.array([0, 1, 2]), (2, 2), device="cpu")
    with pytest.raises(RuntimeError, match="singular"):
        tsn.SupernodalLU.factor(bad)
    lt = tsn.SupernodalLU.factor(At)
    vals = At.data.clone().requires_grad_()
    bg = b.clone().requires_grad_()
    x = tsn.factored_solve(lt, At.with_data(vals), bg, refine=True)
    x.sum().backward()
    v = torch.linalg.solve(At.todense().T, torch.ones_like(b))
    assert _rel(bg.grad.numpy(), v.numpy()) <= 1e-12
    gA = -v[At.row_ids().long()] * x.detach()[At.indices.long()]
    assert _rel(vals.grad.numpy(), gA.numpy()) <= 1e-12
