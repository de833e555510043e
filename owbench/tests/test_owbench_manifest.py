"""BENCHMARK.json against the contract it is checked by: names, units,
lengths and keys; every workload's files found by name; every metric's
reader present; every `moves` an end-to-end metric its cells report."""
import json
import math
import re

import pytest

from conftest import BENCH, ROOT

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
TEXT = re.compile(r"[^\t\n\r]{1,200}\Z")
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}
WIDTH = re.compile(r"(_dim|_rank)\Z|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_token")


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["owbench"]
    assert 1 <= len(DOC["command"]) <= 32
    assert all(TEXT.match(w) for w in DOC["command"])
    assert DOC["command"][1].startswith("owbench/")
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = DOC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def _all_names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in DOC[kind]:
            yield e["name"]


def test_names_units_and_texts():
    names = list(_all_names())
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert set(e2e) == {"placements_per_s", "setup_s"}
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in E2E_SOURCES
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    cells = {w["name"] for w in DOC["workloads"]}
    layers = set()
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert TEXT.match(m["layer"])
        layers.add(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    assert len(layers) >= 4


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in DOC["workloads"]:
        e2e = [m["name"] for m in DOC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m["name"] for m in DOC["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per


@pytest.mark.parametrize("w", DOC["workloads"], ids=lambda w: w["name"])
def test_workload_resolves_its_files_by_name(w):
    conf = {c["name"]: c for c in DOC["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("owbench/configs/")
    for key in conf["reduced"]:
        assert key in cfg, key
    assert set(cfg["assumed"]) <= set(cfg)
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        if w["name"] in m.get("workloads", [w["name"]]):
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_every_configuration_is_used_and_owns_its_file():
    used = {w["config"] for w in DOC["workloads"]}
    assert used == {c["name"] for c in DOC["configs"]}
    files = [c["file"] for c in DOC["configs"]]
    assert len(files) == len(set(files))


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in DOC["workloads"])
    assert four <= max(1, math.floor(len(DOC["workloads"]) / 4))


def test_bench_files_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", rel), rel
