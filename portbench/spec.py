"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root, the configuration file it names, the traffic file
``portbench/traffic/<traffic>.json``, the system module and the reference
module the configuration names (``portbench/systems/<system>.py``,
``portbench/reference/<reference>.py``) and one reader a per-layer metric
(``portbench/metrics/<metric>.py``). A later cell, configuration, traffic
mix or metric is a new file and a new entry; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

__all__ = ["ROOT", "Cell", "load_cell", "load_system", "load_reference",
           "load_reader"]

ROOT = Path(__file__).resolve().parent.parent


class Cell(NamedTuple):
    root: Path  # the checkout the cell's files lie in
    name: str
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    chips: int
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError``
    for a cell the file does not have."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[work["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic"
                          / f"{work['traffic']}.json").read_text())
    return Cell(root, name, config, traffic, work["chips"],
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def load_system(name: str):
    return importlib.import_module(f"portbench.systems.{name}")


def load_reference(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def load_reader(metric: str, root: Path = ROOT):
    """The ``read(trace, cell)`` function of ``metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
