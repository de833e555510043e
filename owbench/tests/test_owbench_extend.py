"""A later change adds a configuration, a traffic mix and a metric as new
files and new entries of BENCHMARK.json, and edits no file that is there."""
import hashlib
import json

from conftest import TINY_CONFIG, TINY_MIX, make_bench, run_tiny


def _digests(folder):
    return {p.relative_to(folder).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in folder.rglob("*")
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_configuration_mix_and_metric_as_files_only(tmp_path):
    root, bench = make_bench(tmp_path)
    before = _digests(bench)
    (bench / "configs" / "tiny2.json").write_text(json.dumps(
        dict(TINY_CONFIG, invokers=150, concurrent_share=0.0,
             max_conc_range=[1, 1], memory_mb=[128, 256, 512],
             memory_weights=[1, 2, 1])))
    (bench / "traffic" / "bursty.json").write_text(json.dumps(
        dict(TINY_MIX, burst_rows=[32, 256], occupancy=0.8)))
    (bench / "metrics" / "rows_per_step.py").write_text(
        '"""Rows decided a step."""\n\n\ndef read(run):\n'
        '    return run.decided / run.steps if run.steps else None\n')
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny2", "source": "test",
                           "file": "owbench/configs/tiny2.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "tiny2.bursty", "config": "tiny2",
                             "traffic": "bursty", "chips": 1, "why": "t"})
    doc["per_layer"].append({"name": "rows_per_step", "unit": "rows/step",
                             "better": "higher", "source": "program_counter",
                             "layer": "core host",
                             "moves": "placements_per_s",
                             "workloads": ["tiny2.bursty"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    out = run_tiny(root, bench, trace=True, workload="tiny2.bursty")
    assert out["correct"] is True
    assert out["metrics"]["rows_per_step"]["value"] == 32
    old = run_tiny(root, bench, trace=True)
    assert "rows_per_step" not in old["metrics"]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
