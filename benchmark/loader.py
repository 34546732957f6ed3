"""Finds a cell's parts by name, so that a cell, a configuration, a
traffic mix or a per-layer metric is added as files and an entry of
``BENCHMARK.json``, with no file of the benchmark edited:

* ``BENCHMARK.json`` at the root: the cells (a configuration and a traffic
  mix each), the metrics and the configurations' files;
* ``benchmark/traffic/<traffic>.json``: a traffic mix's parameters; its
  ``driver`` names the loop in ``benchmark/drivers/<driver>.py``;
* ``benchmark/limits/<cell>.json``: each number the check compares, with
  its limit;
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, a
  ``read(ctx)`` returning a number or None.

A cell reports the end-to-end metrics that list it under ``workloads``
or have no ``workloads``; a per-layer metric likewise, and without
``workloads`` wherever the cell reports the end-to-end metric it
``moves``.
"""

from __future__ import annotations

import importlib.util
import json
import os


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """``BENCHMARK.json`` under ``root`` and the benchmark's files under
    ``root/benchmark``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, "benchmark")
        self.spec = _read_json(os.path.join(self.root, "BENCHMARK.json"))

    def _entry(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return _read_json(os.path.join(self.root,
                                       self._entry("configs", name)["file"]))

    def traffic(self, name: str) -> dict:
        return _read_json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return _read_json(os.path.join(self.dir, "limits", f"{cell}.json"))

    def driver(self, name: str):
        return _load_module(os.path.join(self.dir, "drivers", f"{name}.py"),
                            f"benchmark_driver_{name}")

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        return _load_module(path, "benchmark_metric_"
                            + metric.replace(".", "_")).read

    @staticmethod
    def _listed(metric: dict, cell: str) -> bool:
        return cell in metric.get("workloads", [cell])

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"] if self._listed(m, cell)]

    def per_layer(self, cell: str) -> list:
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]
