"""tpu_sparse_torch containers, conversions and generators against the JAX
package: the same numpy inputs, byte-equal or exactly equal outputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_sparse.sparse import convert as jconvert
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch.sparse import convert as tconvert
from tpu_sparse_torch.sparse import generators as tgen
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

GENERATORS = [
    ("tridiagonal", (50,), {}),
    ("tridiagonal", (20,), {"dtype": np.float32}),
    ("poisson2d", (7,), {}),
    ("poisson2d", (5, 3), {"dtype": np.float32}),
    ("poisson3d_27pt", (5,), {}),
    ("poisson3d_27pt", (4, 3, 2), {"dtype": np.float64}),
    ("convection_diffusion", (30,), {"beta": 0.3}),
    ("poisson2d_anisotropic", (6,), {"eps": 10.0}),
    ("convection_diffusion_3d_27pt", (5,), {}),
    ("convection_diffusion_3d_27pt", (4,), {"beta": 0.5,
                                            "dtype": np.float64}),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS)
def test_generators_byte_equal(name, args, kw):
    Aj = getattr(jgen, name)(*args, **kw)
    At = getattr(tgen, name)(*args, device="cpu", **kw)
    dj = np.asarray(Aj.data)
    dt = At.data.numpy()
    assert dt.dtype == dj.dtype
    assert np.array_equal(dt, dj)
    assert At.offsets == Aj.offsets
    assert At.shape == Aj.shape


def test_entry_points_default_to_the_card():
    """Generators and the DIA constructors build on the card unless asked
    for the CPU; without a card that default fails with torch's error."""
    import inspect

    fns = [getattr(tgen, name) for name, _, _ in GENERATORS]
    fns += [tconvert.dia_from_offsets, tconvert.dia_from_numpy]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tgen.poisson2d(3)
        with pytest.raises((AssertionError, RuntimeError)):
            tconvert.dia_from_numpy(np.ones((1, 3)), (0,), (3, 3))


def test_poisson3d_default_dtype_float32():
    assert tgen.poisson3d_27pt(3, device="cpu").data.dtype == torch.float32
    assert tgen.poisson2d(3, device="cpu").data.dtype == torch.float64


def test_dia_from_numpy_carries_jax_state():
    Aj = jgen.poisson2d(6)
    At = tconvert.dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                                 device="cpu")
    assert np.array_equal(At.data.numpy(), np.asarray(Aj.data))
    assert At.offsets == Aj.offsets and At.shape == Aj.shape
    # a copy: the torch container owns writable memory
    At.data[0, 0] = 123.0
    assert float(np.asarray(Aj.data)[0, 0]) != 123.0


@pytest.mark.parametrize("shape,offsets", [
    ((9, 9), (-2, 0, 3)),
    ((7, 11), (-1, 0, 4)),
    ((12, 5), (-6, -1, 0, 2)),
])
def test_dia_tocoo_todense_transpose_nnz(shape, offsets):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((len(offsets), shape[0]))
    Aj = jconvert.dia_from_offsets(offsets, jnp.asarray(data), shape)
    At = tconvert.dia_from_numpy(data, offsets, shape, device="cpu")
    np.testing.assert_array_equal(At.todense().numpy(),
                                  np.asarray(Aj.todense()))
    np.testing.assert_array_equal(At.T.todense().numpy(),
                                  np.asarray(Aj.T.todense()))
    assert At.nnz == Aj.nnz
    assert At.T.offsets == Aj.T.offsets


def test_dia_to_csr_matches_jax():
    Aj = jgen.poisson2d(5)
    At = tgen.poisson2d(5, device="cpu")
    Cj = jconvert.to_csr(Aj)
    Ct = tconvert.to_csr(At)
    np.testing.assert_array_equal(Ct.data.numpy(), np.asarray(Cj.data))
    np.testing.assert_array_equal(Ct.indices.numpy(), np.asarray(Cj.indices))
    np.testing.assert_array_equal(Ct.indptr.numpy(), np.asarray(Cj.indptr))
    # round trips through COO and back agree with the dense matrix
    dense = At.todense()
    torch.testing.assert_close(Ct.todense(), dense, rtol=0, atol=0)
    torch.testing.assert_close(Ct.tocoo().tocsr().todense(), dense,
                               rtol=0, atol=0)
    torch.testing.assert_close(Ct.T.todense(), dense.T, rtol=0, atol=0)


def test_containers_move_between_devices_keep_structure():
    A = tgen.tridiagonal(8, device="cpu")
    B = A.to("cpu")
    assert B.offsets == A.offsets and B.shape == A.shape
    C = tconvert.to_csr(A).to("cpu")
    assert C.nnz == A.nnz
