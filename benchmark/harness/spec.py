"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's entry
names its file, the mix is ``traffic/<name>.json`` and each metric is
``metrics/<name>.py``. Nothing here lists configurations, mixes or metrics:
a new one is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/


@dataclasses.dataclass
class Cell:
    name: str
    root: str                 # the checkout
    bench: dict               # BENCHMARK.json
    workload: dict            # the cell's entry
    config: dict              # the configuration's file
    mix: dict                 # the traffic file
    end_to_end: List[dict]    # the metrics this cell reports with --trace 0
    per_layer: List[dict]     # ... with --trace 1
    bench_dir: str = HERE     # where traffic/ and metrics/ are

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def deployment(self) -> dict:
        return self.config["deployment"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str, bench_dir: str = HERE) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")) as f:
        mix = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, root, bench, w, config, mix, e2e, per, bench_dir)


def metric_reader(name: str, bench_dir: str = HERE):
    """The `read(ctx)` of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], ctx, bench_dir: str = HERE) -> Dict[str, dict]:
    """Each metric's reading: {"value", "unit"}; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        v = metric_reader(m["name"], bench_dir)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
