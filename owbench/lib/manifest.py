"""`BENCHMARK.json` and the files it names.

Everything of one configuration, one traffic mix or one metric sits in a
file of its own, found by its name:

- a configuration: the `file` of its entry under `configs`;
- a traffic mix: `owbench/traffic/<traffic>.json`;
- a metric, end to end or per layer: a reader `owbench/metrics/<name>.py`
  whose `read(run)` returns the metric's value, or None where the run has
  nothing for it to read;
- a kernel's work, for the roofline readers: `owbench/counts/<kernel>.py`;
- a configuration's own reference: `owbench/reference/<name>.py`, named by
  the configuration's optional key `reference` (default `sharding`).

A configuration may also carry `core`, keyword arguments that both sides'
constructors take beside the fleet's (the balancer core's options), and
`clock`: `"traffic"` hands both sides the traffic's own seconds before
every step (`lib/drive.py`).

So a later change adds a configuration, a mix, a metric or a reference as
new files and new entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
#: the configuration's keys that both sides' constructors take
SIDE_KEYS = ("cluster_size", "managed_fraction", "blackbox_fraction",
             "max_batch", "action_slots")
#: the values of a configuration's `clock`: none, or the traffic's seconds
CLOCKS = (None, "traffic")
_MODULE = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}\Z")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload: its configuration, its mix and the metrics it reports."""

    def __init__(self, manifest: "Manifest", entry: dict):
        self.name = entry["name"]
        self.chips = entry["chips"]
        self.bench = manifest.bench
        conf = manifest.config_entry(entry["config"])
        self.config = cfg = json.loads(
            (manifest.root / conf["file"]).read_text())
        self.core = dict(cfg.get("core", {}))
        if set(self.core) & (set(SIDE_KEYS) | {"placement_kernel"}):
            raise ValueError(f"{conf['file']}: `core` repeats a key the "
                             "configuration already gives")
        self.reference = cfg.get("reference", "sharding")
        if not _MODULE.match(self.reference):
            raise ValueError(f"{conf['file']}: no reference module "
                             f"{self.reference!r}")
        self.clock = cfg.get("clock")
        if self.clock not in CLOCKS:
            raise ValueError(f"{conf['file']}: `clock` is one of {CLOCKS}")
        mix = manifest.bench / "traffic" / f"{entry['traffic']}.json"
        self.mix = json.loads(mix.read_text())
        self.end_to_end = manifest.metrics_of("end_to_end", self.name)
        self.per_layer = manifest.metrics_of("per_layer", self.name)

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end

    @property
    def fleet(self) -> List[int]:
        return [self.config["invoker_memory_mb"]] * self.config["invokers"]

    def side_kwargs(self) -> dict:
        """The keyword arguments both sides' constructors take: the
        fleet's split, batch and slots, then the configuration's `core`."""
        kw = {k: self.config[k] for k in SIDE_KEYS}
        kw.update(self.core)
        return kw

    def reference_class(self):
        """`Reference` of the configuration's reference module."""
        return load_module(self.bench / "reference" / f"{self.reference}.py",
                           f"owbench_reference_{self.reference}").Reference


class Manifest:
    def __init__(self, root: Path, bench: Optional[Path] = None):
        self.root = Path(root)
        self.bench = Path(bench) if bench is not None else BENCH_DIR
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def config_entry(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> Cell:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return Cell(self, w)
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics_of(self, kind: str, cell: str) -> List[dict]:
        return [m for m in self.doc[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           f"owbench_metric_{metric}")

    def counts(self, kernel: str):
        return load_module(self.bench / "counts" / f"{kernel}.py",
                           f"owbench_counts_{kernel}")


def read_metrics(manifest: Manifest, metrics: List[dict], run
                 ) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read in `run`."""
    out = {}
    for m in metrics:
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
