"""A cell as the benchmark's files describe it, found by name.

``BENCHMARK.json`` names the cell's configuration and traffic mix and the
metrics it reports; ``bench/workloads/<cell>.json`` holds the cell's own
data (the limits of its comparison); ``bench/configs/<config>.json`` the
configuration as it is run, ``bench/traffic/<traffic>.json`` the mix, whose
``kind`` names its generator (``bench/traffic/<kind>.py``) and its runner
(``bench/harness/<kind>.py``); a per-layer metric is read by the module of
its name's first part (``bench/metrics/k3_roofline.py`` for
``k3_roofline.train``).  A later cell, mix or metric is a new file and a new
entry: nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    spec: dict                  # bench/workloads/<cell>.json
    end_to_end: list            # BENCHMARK.json's metric entries
    per_layer: list

    @property
    def kind(self) -> str:
        return self.mix["kind"]

    def runner(self):
        return importlib.import_module(f"bench.harness.{self.kind}")

    def traffic(self):
        return importlib.import_module(f"bench.traffic.{self.kind}")

    def reference(self):
        return importlib.import_module(
            f"bench.reference.{self.config['reference']}")


def _reports(entry: dict, cell: str) -> bool:
    return cell in entry.get("workloads", [cell])


def load(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    mix = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    spec = load_json(BENCH / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name, config, mix, spec, e2e, per_layer)


def metric_reader(name: str):
    """The module that reads per-layer metric ``name``:
    ``bench/metrics/<the name's first part>.py``."""
    return importlib.import_module(f"bench.metrics.{name.split('.', 1)[0]}")
