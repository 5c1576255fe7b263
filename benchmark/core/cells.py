"""Find a cell, its configuration, its traffic mix and its metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells and the metrics.
Everything that belongs to one name sits in a file of its own, found by
that name:

* ``benchmark/configs/<config>.json``: the deployment (grid, dtype,
  tolerance, guarantee; the stencil's values, ``coefficients`` for any
  neighbour that does not take ``neighbour``);
* ``benchmark/traffic/<traffic>.json``: the mix the one generator reads
  (entry, keyword arguments, pool, refresh) and whether the plain
  reference of its method checks the iterations (``iteration_reference``);
* ``benchmark/workloads/<cell>.json``: the cell's own limits and ``why``;
* ``benchmark/metrics/<metric>.py``: a reader with ``read(run)``.

So a later change adds a deployment, a mix, a cell or a metric as new
files, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
from dataclasses import dataclass
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
NEIGHBOUR = re.compile(r"^(-1|0|1),(-1|0|1),(-1|0|1)$")
# the methods with a plain reference (``benchmark/reference``)
METHODS = ("cg", "bicgstab", "gmres")


class CellError(ValueError):
    """A name that does not resolve, or files that disagree."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list   # BENCHMARK.json metric entries this cell reports
    per_layer: list
    coefficients: dict   # the configuration's {(dx, dy, dz): value}
    method: str          # the mix's method, whose plain reference checks it


def _load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise CellError(f"no {what} file {path}")
    with open(path) as f:
        return json.load(f)


def _check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise CellError(f"not a valid name: {name!r}")
    return name


def coefficients(spec) -> dict:
    """A configuration's ``coefficients`` as {(dx, dy, dz): value}: a map
    from a neighbour "dx,dy,dz" (each -1, 0 or 1, not all 0) to the value
    its diagonal holds inside the grid; {} for None. A key that does not
    parse or names the centre, or a value that is not a finite number,
    raises CellError."""
    if spec is None:
        return {}
    if not isinstance(spec, dict):
        raise CellError(f"coefficients must be a map, not {spec!r}")
    out = {}
    for key, value in spec.items():
        d = tuple(int(v) for v in key.split(",")) \
            if isinstance(key, str) and NEIGHBOUR.match(key) else None
        if d is None or d == (0, 0, 0):
            raise CellError(f"coefficients: {key!r} is not a neighbour "
                            "'dx,dy,dz' of -1, 0, 1 (not the centre)")
        if isinstance(value, bool) or not isinstance(value, (int, float)) \
                or not math.isfinite(value):
            raise CellError(f"coefficients: {key!r} has no finite value")
        out[d] = float(value)
    return out


def method_of(traffic: dict) -> str:
    """The mix's method, ``kwargs.method`` (the library's default CG where
    it names none): its plain reference runs the iteration check, where
    ``iteration_reference`` is true, and in bfloat16 the control. An
    ``iteration_reference`` that is not true or false, a checked method
    with no plain reference (``METHODS``), or a GMRES mix whose kwargs give
    no restart (a whole number >= 1) raises CellError."""
    check = traffic.get("iteration_reference", False)
    if not isinstance(check, bool):
        raise CellError(f"iteration_reference is true or false, not {check!r}")
    kwargs = traffic.get("kwargs", {})
    method = kwargs.get("method", "cg")
    if check and method not in METHODS:
        raise CellError(f"no plain reference checks method {method!r}: "
                        f"one of {', '.join(METHODS)}")
    restart = kwargs.get("restart")
    if method == "gmres" and (isinstance(restart, bool)
                              or not isinstance(restart, int) or restart < 1):
        raise CellError("a GMRES mix gives restart, a whole number >= 1, in "
                        "its kwargs: the reference restarts where it does")
    return method


def load_benchmark(root: Path) -> dict:
    return _load_json(Path(root) / "BENCHMARK.json", "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    """A metric without a ``workloads`` key is reported in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, bench: dict, name: str) -> Cell:
    root = Path(root)
    _check_name(name)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"cell {name!r} is not in BENCHMARK.json")
    base = root / "benchmark"
    config = _load_json(base / "configs" / f"{_check_name(entry['config'])}"
                        ".json", "configuration")
    traffic = _load_json(base / "traffic" / f"{_check_name(entry['traffic'])}"
                         ".json", "traffic")
    workload = _load_json(base / "workloads" / f"{name}.json", "workload")
    if int(config["chips"]) != int(entry["chips"]):
        raise CellError(f"cell {name!r} asks for {entry['chips']} chips, its "
                        f"configuration is laid out for {config['chips']}")
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, workload=workload,
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)],
                coefficients=coefficients(config.get("coefficients")),
                method=method_of(traffic))


def load_reader(root: Path, metric: str):
    """The ``read(run)`` function of ``benchmark/metrics/<metric>.py``."""
    path = Path(root) / "benchmark" / "metrics" / f"{_check_name(metric)}.py"
    if not path.is_file():
        raise CellError(f"no reader {path} for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", metric), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
