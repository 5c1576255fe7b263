"""Every public name of tpu_sparse has a counterpart in tpu_sparse_torch.

The test walks every module of both packages with ``pkgutil.walk_packages``
and takes the public names a JAX module defines itself (functions and
classes whose ``__module__`` is that module, and names its source assigns
at top level) or lists in ``__all__``. Each must exist under the same name
in the same module of the port, or stand in ``EXCEPTIONS`` with the reason
it is not ported or the name of its counterpart. The examples map onto
``tpu_sparse_torch.apps``. The test only imports: it calls nothing in
``tpu_sparse.native``, whose ``available()`` would build its library.
"""

import ast
import importlib
import inspect
import pkgutil

import pytest

import tpu_sparse

NOT_TO_PORT = "a TPU-runtime or JAX-tracing workaround (ROADMAP, Not to port)"

# (module relative to the package, name) -> reason or counterpart; a name
# of None stands for the whole module
EXCEPTIONS = {
    ("config", "enable_x64"): NOT_TO_PORT,
    ("config", "x64_enabled"): NOT_TO_PORT,
    ("kernels", "set_pallas_enabled"): NOT_TO_PORT,
    ("kernels", "set_resident_enabled"): NOT_TO_PORT,
    ("kernels", "batch_safe_matvec"): NOT_TO_PORT + "; the batched solvers "
    "call the SpMM directly",
    ("kernels", "split_complex_operator"): NOT_TO_PORT + " (the complex "
    "real-pair path; complex operands run natively)",
    ("kernels", "complex_pair_spmv"): NOT_TO_PORT + " (complex real pairs)",
    ("kernels", "complex_pair_spmm"): NOT_TO_PORT + " (complex real pairs)",
    ("api.availability", "check_pallas_available"): NOT_TO_PORT + "; "
    "counterpart check_cuda_available",
    ("api.availability", "backend_platform"): NOT_TO_PORT,
    ("utils.transfer", None): NOT_TO_PORT + " (batched_device_put)",
    ("direct", "host_splu_eager"): NOT_TO_PORT,
    ("direct", "is_device_capable"): NOT_TO_PORT + " (the remote TPU "
    "runtime's execution deadline)",
    ("direct.sparse_lu", "is_device_capable"): NOT_TO_PORT,
    ("dist.comm_model", "hlo_collective_stats"): NOT_TO_PORT + "; there is "
    "no HLO, the port records its collectives",
    ("dist", "row_sharding"): NOT_TO_PORT + " (dist/mesh.py docstring)",
    ("dist", "replicated"): NOT_TO_PORT + " (dist/mesh.py docstring)",
    ("dist.mesh", "row_sharding"): NOT_TO_PORT,
    ("dist.mesh", "replicated"): NOT_TO_PORT,
    ("dist.mesh", "ROW_AXIS"): "the name of the JAX mesh axis; a RowMesh "
    "is a process group with no named axis",
    ("sparse.cwell", "AUTO_GROUP"): "a TPU tuning heuristic "
    "(tpu_sparse_torch/sparse/cwell.py raises for group='auto')",
    ("sparse", "to_tpu_operator"): "counterpart sparse.to_gpu_operator",
    ("sparse.optimize", "to_tpu_operator"): "counterpart "
    "sparse.optimize.to_gpu_operator",
    ("kernels.pallas_spmv", None): "counterpart kernels.cuda_spmv",
    ("kernels.pallas_cg", None): "counterpart kernels.cuda_cg",
    ("kernels.pallas_bicgstab", None): "counterpart kernels.cuda_bicgstab",
    ("kernels.pallas_cwell", None): "counterpart kernels.cuda_cwell",
    ("kernels.pallas_bell", None): "counterpart kernels.cuda_bell",
    ("utils.tree", "Partial"): "jax.tree_util.Partial makes a partial a "
    "pytree for jit; nothing is traced in the port (functools.partial)",
    ("examples.ldc.validate_reference", None): "compares with fields "
    "saved by the reference library's own scipy script, which is not "
    "part of this repository",
}

# JAX example modules and the port's apps that stand for them
EXAMPLES = {
    "examples.poisson3d_demo": "tpu_sparse_torch.apps.poisson3d_demo",
    "examples.inverse_poisson": "tpu_sparse_torch.apps.inverse_poisson",
    "examples.ldc.ldc_solver": "tpu_sparse_torch.apps.ldc",
    "examples.ldc.validate_reference": None,
}


def _defined_names(mod) -> set:
    names = set(getattr(mod, "__all__", ()))
    for k, v in vars(mod).items():
        if not k.startswith("_") and getattr(v, "__module__", None) \
                == mod.__name__:
            names.add(k)
    try:
        tree = ast.parse(inspect.getsource(mod))
    except (OSError, TypeError):
        return names
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else [])
        names.update(t.id for t in targets
                     if isinstance(t, ast.Name) and not t.id.startswith("_"))
    return names


def _jax_modules():
    out = {"": tpu_sparse}
    for info in pkgutil.walk_packages(tpu_sparse.__path__, "tpu_sparse."):
        out[info.name[len("tpu_sparse."):]] = importlib.import_module(
            info.name)
    return out


def _port_module(rel: str):
    name = "tpu_sparse_torch" + ("." + rel if rel else "")
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError:
        return None


def _missing(rel, jmod, pmod):
    if (rel, None) in EXCEPTIONS:
        return []
    return [(rel, k) for k in sorted(_defined_names(jmod))
            if (rel, k) not in EXCEPTIONS
            and (pmod is None or not hasattr(pmod, k))]


def test_every_jax_name_has_a_port_counterpart():
    missing = []
    for rel, jmod in _jax_modules().items():
        missing += _missing(rel, jmod, _port_module(rel))
    assert not missing, f"JAX names with no counterpart: {missing}"


@pytest.mark.parametrize("jax_name", sorted(EXAMPLES))
def test_every_example_has_a_port_counterpart(jax_name):
    port = EXAMPLES[jax_name]
    if port is None:
        assert (jax_name, None) in EXCEPTIONS
        return
    jmod = importlib.import_module(jax_name)
    pmod = importlib.import_module(port)
    missing = [k for k in sorted(_defined_names(jmod))
               if not hasattr(pmod, k)
               and (jax_name, k) not in EXCEPTIONS]
    # and the public methods of its classes (LDCSolver.save_plot, ...)
    for k, cls in vars(jmod).items():
        if inspect.isclass(cls) and cls.__module__ == jax_name:
            missing += [f"{k}.{m}" for m, v in vars(cls).items()
                        if not m.startswith("_") and inspect.isfunction(v)
                        and not hasattr(getattr(pmod, k, None), m)]
    assert not missing, f"{jax_name} names missing from {port}: {missing}"


def test_exceptions_name_real_gaps():
    """Each exception is a JAX module or name that exists and that the
    port does not carry under the same name, so the list stays honest."""
    jax_mods = _jax_modules()
    for (rel, name), why in EXCEPTIONS.items():
        assert why
        if rel.startswith("examples."):
            assert EXAMPLES[rel] is None or name is not None
            continue
        assert rel in jax_mods, rel
        pmod = _port_module(rel)
        if name is None:
            assert pmod is None, rel
        else:
            assert name in _defined_names(jax_mods[rel]), (rel, name)
            assert pmod is None or not hasattr(pmod, name), (rel, name)
