"""Find a cell, its configuration, its traffic mix and the per-layer metrics by name.

Everything that belongs to one configuration, one traffic mix or one metric is a file
of its own under the benchmark's folder, found by the name that ``BENCHMARK.json``
gives it, so that a later change adds a cell by adding files:

- ``cells/<workload>.json``: ``config``, ``traffic``, ``chips``, ``why``, the cell's
  ``end_to_end`` metrics and the ``limits`` of its correctness checks;
- ``configs/<config>.json``: the option file's ``model``, ``scale``, ``quant`` and
  ``network_G`` as run (the published file itself is kept beside it), its ``source``,
  ``precision``, ``reduced`` and ``assumed`` sizes, and the kernels to build at set-up;
- ``traffic/<traffic>.json``: the parameters that :mod:`traffic` and :mod:`clients`
  read: the entry, the image sizes, the requests in flight, the heat, the pool of
  images and the sample checked against the reference;
- ``metrics/<metric>.py``: a per-layer metric's reader, with its ``UNIT``, ``BETTER``,
  ``SOURCE``, ``LAYER``, ``MOVES`` and ``WORKLOADS`` and a ``read(reading)`` that
  returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    cell: dict
    config: dict
    traffic: dict
    metrics: list  # the reader modules of the per-layer metrics this cell reports

    @property
    def sr(self) -> bool:
        return "rescaling" not in self.config["model"].lower()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_modules(root: Path = ROOT) -> list:
    """Every reader under ``metrics/``, in name order."""
    mods = []
    for path in sorted((Path(root) / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"h100_bench_metric.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.NAME = path.stem
        mods.append(mod)
    return mods


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    path = root / "cells" / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no cell {name!r}: {path} is missing")
    cell = load_json(path)
    config = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    metrics = [m for m in metric_modules(root) if name in m.WORKLOADS]
    return Cell(name, cell, config, traffic, metrics)


def cell_names(root: Path = ROOT) -> list:
    return sorted(p.stem for p in (Path(root) / "cells").glob("*.json"))
