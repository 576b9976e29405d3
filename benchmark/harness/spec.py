"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's entry
names its file, the mix is ``traffic/<name>.json`` and each metric is
``metrics/<name>.py``. The configuration's file names its architecture
under ``"arch"`` (``dense`` where it names none): ``arch/<name>.py``.
Nothing here lists configurations, architectures, mixes or metrics: a new
one is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
import zlib
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
DEFAULT_ARCH = "dense"


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
    bench_dir: str = HERE     # where arch/, traffic/ and metrics/ are

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def deployment(self) -> dict:
        return self.config["deployment"]

    @property
    def arch(self):
        """The configuration's architecture module."""
        return load_arch(self.config.get("arch", DEFAULT_ARCH), self.bench_dir)


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


def load_arch(name: str, bench_dir: str = HERE):
    """arch/<name>.py, loaded once a process. An architecture module gives
    everything of a configuration that depends on its block:

    - ``leaves(model)``: its drawn matrices (``harness.weights.Leaf``: [k, n],
      scale, the layers that hold it, how many a layer), each drawn alone
      by ``weights.draw`` from (seed, leaf, layer[, index]);
    - ``build_params(model, deployment, seed, device)``: (the port's
      ModelConfig, its parameter tree) from those draws, quantized by the
      port; it imports the program inside the function;
    - ``Reference(model, deployment, seed, device, precision)`` with
      ``logits(segments, wanted)``: the plain f32 reference and its fp8 and
      bf16 controls (``reference.model.Plain``), which import nothing of
      the program;
    - ``work(model, deployment)``: the work count readers read as
      ``Context.shapes``, with ``step_least_s(rows, head_rows)`` and
      ``products_bound_s(m, head_m)`` and what its own kernels' bounds need.
    """
    path = os.path.join(bench_dir, "arch", f"{name}.py")
    key = "bench_arch_%s_%08x" % (re.sub(r"\W", "_", name),
                                  zlib.crc32(os.path.abspath(path).encode()))
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod


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
