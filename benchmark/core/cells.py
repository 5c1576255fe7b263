"""Find a cell, its configuration, its traffic mix and its metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells and the metrics.
Everything that belongs to one name sits in a file of its own, found by
that name:

* ``benchmark/configs/<config>.json``: the deployment (grid, dtype,
  tolerance, guarantee);
* ``benchmark/traffic/<traffic>.json``: the mix the one generator reads
  (entry, keyword arguments, pool, refresh);
* ``benchmark/workloads/<cell>.json``: the cell's own limits and ``why``;
* ``benchmark/metrics/<metric>.py``: a reader with ``read(run)``.

So a later change adds a deployment, a mix, a cell or a metric as new
files, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


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


def _load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise CellError(f"no {what} file {path}")
    with open(path) as f:
        return json.load(f)


def _check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise CellError(f"not a valid name: {name!r}")
    return name


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
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


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
