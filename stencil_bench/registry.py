"""The finder: every part of a cell is found by its name in BENCHMARK.json.

    configuration  the `file` of its entry under `configs`
                   (stencil_bench/configs/<name>.json)
    program        the configuration's `program` key:
                   stencil_bench/programs/<program>.py, an adapter with
                   its own inputs and reference (programs/__init__.py)
    traffic mix    stencil_bench/workloads/<traffic>.json
    metric         stencil_bench/metrics/<name>.py, a module with
                   `read(ctx) -> float | None` (None: nothing to read, and
                   the metric is left out of the line)

So a later change adds a program, a configuration, a cell or a metric as new files
and new entries, and edits no file that is there. `root` is the
checkout's root, which holds BENCHMARK.json.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = "stencil_bench"


@dataclasses.dataclass
class Cell:
    """One workload entry of BENCHMARK.json, with what it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: pathlib.Path

    def metrics(self, traced: bool) -> list[dict]:
        """The metrics a line of this cell carries: its end-to-end ones
        untraced, its per-layer ones traced; a metric with a `workloads`
        key only in the cells it lists."""
        chosen = self.per_layer if traced else self.end_to_end
        return [m for m in chosen if self.name in m.get("workloads", [self.name])]

    def reader(self, metric_name: str):
        """The `read` function of stencil_bench/metrics/<metric_name>.py."""
        return _load("metrics", metric_name, self.root).read

    def program(self):
        """The adapter module of this cell's configuration."""
        return program(self.config["program"], self.root)


def _load(folder: str, name: str, root):
    """The module stencil_bench/<folder>/<name>.py under `root`, loaded by path."""
    path = pathlib.Path(root or ROOT) / PACKAGE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{folder} {name!r}: no file at {path}")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}.{folder}._{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def program(name: str, root=None):
    """The adapter stencil_bench/programs/<name>.py."""
    return _load("programs", name, root)


def load_json(path: pathlib.Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root=None) -> dict:
    return load_json(pathlib.Path(root or ROOT) / "BENCHMARK.json")


def cell(workload: str, root=None) -> Cell:
    root = pathlib.Path(root or ROOT)
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}; "
                       f"known: {', '.join(sorted(entries))}")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(root / PACKAGE / "workloads" / f"{entry['traffic']}.json")
    cfg_chips = 1
    for d in config["process_grid"]:
        cfg_chips *= int(d)
    if cfg_chips != int(entry["chips"]):
        raise ValueError(f"workload {workload!r} asks for {entry['chips']} chip(s) but its "
                         f"configuration's process grid {config['process_grid']} has "
                         f"{cfg_chips} rank(s)")
    return Cell(name=workload, chips=int(entry["chips"]), config=config, traffic=traffic,
                end_to_end=list(bench["end_to_end"]), per_layer=list(bench["per_layer"]),
                root=root)
