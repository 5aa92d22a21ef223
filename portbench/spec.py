"""Find a cell's parts by name, from data files.

A cell is ``workloads/<name>.json``; it names its configuration
(``configs/<config>.json``) and its traffic kind, whose driver is
``drivers/<kind>.py``. Each metric in ``BENCHMARK.json`` is read by
``metrics/<metric>.py``. Adding a cell, a configuration, a traffic kind or
a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py, imported by its path (a name may hold
    '.' and '-')."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {path}")
    mod_name = f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict      # workloads/<name>.json
    config: dict        # configs/<config>.json
    chips: int
    end_to_end: list    # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list     # and its per_layer entries

    @property
    def traffic(self) -> str:
        return self.workload["traffic"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT, here: str = HERE) -> Cell:
    """The cell `name` as BENCHMARK.json (in `root`) and its files (in
    `here`, the benchmark's folder) define it."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = _load_json(os.path.join(here, "workloads", f"{name}.json"))
    config = _load_json(os.path.join(here, "configs", f"{entry['config']}.json"))
    if workload["config"] != entry["config"] or workload["traffic"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json")
    return Cell(name, workload, config, int(entry["chips"]),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])
