"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<file>`` from the ``configs`` entry),
a traffic mix (``traffic/<traffic>.json``, whose ``kind`` names the loop that
runs it, ``kinds/<kind>.py``), the limits of its correctness check
(``limits/<cell>.json``) and, through ``per_layer``, its metric readers
(``metrics/<metric>.py``, each with ``read(ctx) -> float | None``). The
configuration's presets name the reference's networks
(``reference/models/<preset>.py``). Adding a cell is adding files and
entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import re
import json
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]  # the metrics this cell reports with --trace 0
    per_layer: list[dict]  # and with --trace 1


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell_name: str, root: Path | None = None) -> Cell:
    """The cell ``cell_name`` of ``<root>/BENCHMARK.json`` (root: the
    directory above this package)."""
    root = HERE.parent if root is None else Path(root)
    bench_file = root / "BENCHMARK.json"
    if not bench_file.is_file():
        raise SystemExit(f"no BENCHMARK.json in {root}")
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = HERE / "limits" / f"{cell_name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.is_file() else {}
    return Cell(name=cell_name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, cell_name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, cell_name)])


def reader(metric_name: str) -> Callable:
    """``read`` of ``metrics/<metric_name>.py``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric_name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kind(name: str):
    """The module ``kinds/<name>.py``: the loop that runs a traffic kind."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise SystemExit(f"traffic kind {name!r} is not a module name")
    if not (HERE / "kinds" / f"{name}.py").is_file():
        raise SystemExit(f"no benchmark/kinds/{name}.py for traffic kind {name!r}")
    return importlib.import_module(f"benchmark.kinds.{name}")
