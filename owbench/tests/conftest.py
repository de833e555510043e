"""Fixtures of the benchmark's own tests: a tiny benchmark in a temporary
checkout (its own BENCHMARK.json, configuration and mix, the real readers
and counts), driven on the CPU."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "owbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a fleet small enough for the port's plain CPU path, with both
#: configurations' features: permit pools, blackbox actions, flaps
TINY_CONFIG = {
    "invokers": 200, "invoker_memory_mb": 2048, "cluster_size": 1,
    "managed_fraction": 0.9, "blackbox_fraction": 0.1, "max_batch": 32,
    "action_slots": 256, "placement_kernel": "auto", "actions": 120,
    "namespaces": 12,
    "memory_mb": [128, 256, 512, 1024, 2048], "memory_weights": [1] * 5,
    "concurrent_share": 0.2, "max_conc_range": [2, 16],
    "blackbox_share": 0.05, "action_table_seed": 7, "shards": 1,
    "namespace_throttling": False, "assumed": [], "reduced": []}
TINY_MIX = {
    "zipf_s": 1.1, "burst_rows": [4, 64], "backlog_rows": 32,
    "occupancy": 0.5, "duration_log_mu": -0.38, "duration_log_sigma": 2.36,
    "timeout_s": 60, "warm_steps": 4, "flap_every_steps": 5,
    "flap_down_share": 0.02}


def make_bench(tmp: Path, config=None, mix=None) -> tuple:
    """(root, bench): a checkout root holding BENCHMARK.json with the tiny
    cell `tiny.small`, and a copy of the benchmark's folder with the tiny
    configuration and mix added."""
    root, bench = tmp / "checkout", tmp / "checkout" / "owbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    (bench / "configs" / "tiny.json").write_text(
        json.dumps(config or TINY_CONFIG))
    (bench / "traffic" / "small.json").write_text(json.dumps(mix or TINY_MIX))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"] = [{"name": "tiny", "source": "test",
                       "file": "owbench/configs/tiny.json", "reduced": [],
                       "why": "test"}]
    doc["workloads"] = [{"name": "tiny.small", "config": "tiny",
                         "traffic": "small", "chips": 1, "why": "test"}]
    for m in doc["end_to_end"] + doc["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root, bench


@pytest.fixture
def tiny_bench(tmp_path):
    return make_bench(tmp_path)


def run_tiny(root, bench, *, trace=False, hook=None, seed=2**31 + 77,
             seconds=0.3, workload="tiny.small"):
    from owbench.lib.cell import run_cell
    import time
    return run_cell(root, workload, seed, seconds, trace,
                    t_start=time.monotonic(), device="cpu", bench=bench,
                    hook=hook)
