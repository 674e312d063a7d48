"""A cell of BENCHMARK.json, found by name, with the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by its name:

  configuration  the `file` of its BENCHMARK.json entry (a JSON object:
                 n, sigma, ranks, text, reference, ...);
  traffic        bench_torch/traffic/<traffic>.json (m, p, frac_present:
                 the panel, gen.py; every request edits the corpus and
                 counts it, rank.py);
  reference      bench_torch/references/<reference>.py, named by the
                 configuration (count(text, panel, sigma) and control());
  metric         bench_torch/metrics/<name>.py, one file a metric, for the
                 metrics whose `workloads` list the cell, or that have no
                 such list: read(record) -> number, or None where the run
                 holds nothing to read (the metric is then left out of
                 the line).  An end-to-end metric reads the window's
                 record (run.assemble), a per-layer metric the traced
                 run (trace.Trace).  A cell that lists a metric with no
                 such file is refused before it runs.

A later cell or metric is added as files and a BENCHMARK.json entry, with
no edit to the harness.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def n(self) -> int:
        return int(self.config["n"])

    @property
    def sigma(self) -> int:
        return int(self.config["sigma"])

    @property
    def m(self) -> int:
        return int(self.traffic["m"])

    def reference(self):
        return load_module(os.path.join(
            HERE, "references", f"{self.config['reference']}.py"))

    def reader(self, metric: str):
        return reader(metric)


def reader_path(metric: str) -> str:
    return os.path.join(HERE, "metrics", f"{metric}.py")


def reader(metric: str):
    """The read() of bench_torch/metrics/<metric>.py."""
    return load_module(reader_path(metric)).read


def load_module(path: str):
    name = "bench_torch_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(workload: str, root: str = ".", bench_path: str | None = None
         ) -> Cell:
    """The cell `workload` of root/BENCHMARK.json (or of the file
    bench_path, which may name another traffic directory under
    "traffic_dir": the harness's tests run tiny cells so)."""
    with open(bench_path or os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    traffic_dir = bench.get("traffic_dir", os.path.join(HERE, "traffic"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(traffic_dir, f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    if int(config.get("ranks", 1)) != int(w["chips"]):
        raise SystemExit(f"{workload}: configuration {w['config']} runs on "
                         f"{config.get('ranks', 1)} ranks, the cell asks "
                         f"for {w['chips']} chips")

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    cell = Cell(workload, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])
    missing = [m["name"] for m in cell.end_to_end + cell.per_layer
               if not os.path.exists(reader_path(m["name"]))]
    if missing:
        raise SystemExit(f"{workload}: no reader bench_torch/metrics/"
                         f"<name>.py for {missing}")
    return cell
