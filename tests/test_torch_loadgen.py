"""The port's load generator (`openwhisk_tpu_torch/tools/loadgen.py`), held
against the repository's `tools/loadgen.py`.

  (a) the reference's loadgen cases on both packages (`pkg`; see
      `tests/torch_ported_cases.py` and `tests/torch_loadgen_cases.py`):
      `tests/test_waterfall.py::TestLoadgen`,
      `tests/test_hostprof.py::TestLoadgenGeneratorSelfCheck`, the
      straggler scenario of `tests/test_anomaly.py` (`apply_stragglers`
      through a live balancer), the CLI's one JSON line on error from
      `tests/test_performance_harness.py`, and the shared funnel
      deployment of `tests/test_funnel.py` (its `multiproc` marker kept),
      the port's at `device="cpu"`;
  (b) `make_schedule`'s offsets and `verdict()`'s answers equal the
      reference's;
  (c) one fixed-rate `sweep_balancer` in each package: every activation
      completed, and the block's keys the reference's plus the port's
      `device`;
  (d) `--device` means the card by default: without one the CLI prints
      one JSON error line and exits 1.

Processes the cases start run with OMP_NUM_THREADS=1.
"""
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_loadgen_cases import PORTS, SUBS
from tests.torch_ported_cases import ported

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread_a_process(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


ported(globals(), "test_waterfall", only=("TestLoadgen",),
       subs=SUBS["test_waterfall"])
ported(globals(), "test_hostprof", only=("TestLoadgenGeneratorSelfCheck",),
       subs=SUBS["test_hostprof"])
ported(globals(), "test_anomaly", only=("TestStragglerEndToEnd",),
       subs=SUBS["test_anomaly"])
ported(globals(), "test_performance_harness",
       only=("TestE2eOpenLoopRiderFallback."
             "test_loadgen_cli_emits_one_json_line_on_error",),
       ports=PORTS["test_performance_harness"],
       subs=SUBS["test_performance_harness"])
ported(globals(), "test_funnel", only=("TestFunnelSharedDeployment",),
       subs=SUBS["test_funnel"])


def _ref():
    from tools import loadgen
    return loadgen


def _port():
    from openwhisk_tpu_torch.tools import loadgen
    return loadgen


# -- (b) the schedule and the verdict ------------------------------------------
@pytest.mark.parametrize("dist", ["poisson", "constant"])
@pytest.mark.parametrize("seed", [1, 7, 1009, 4242])
@pytest.mark.parametrize("rate,n", [(64.0, 200), (1024.0, 3000), (0.5, 3)])
def test_make_schedule_equals_the_reference(dist, seed, rate, n):
    want = _ref().make_schedule(rate, n, dist=dist, seed=seed)
    got = _port().make_schedule(rate, n, dist=dist, seed=seed)
    assert got == want
    assert len(got) == n


def _rows():
    gen = {"gc_pauses": 2, "gc_pause_total_ms": 130.0,
           "gc_pause_max_ms": 110.0, "max_fire_lag_ms": 120.0}
    for completed, errors, unfinished, p99, lag, cause in itertools.product(
            (0, 97, 100), (0, 3), (0, 2), (None, 20.0, 1000.0, 5000.0),
            (1.0, 50.0, 120.0), (None, "gc_pause", "event_loop_stall")):
        yield {"completed": completed, "errors": errors,
               "unfinished": unfinished, "p99_ms": p99,
               "fire_lag_max_ms": lag,
               "generator": dict(gen, max_fire_lag_cause=cause)}


@pytest.mark.parametrize("bound", [1000.0, 10.0])
def test_verdict_equals_the_reference(bound):
    ref, port = _ref(), _port()
    rows = list(_rows())
    assert len(rows) == 432
    for row in rows:
        assert port.verdict(row, bound) == ref.verdict(row, bound), row
        assert port.sustainable(row, bound) == ref.sustainable(row, bound)
    blames = {port.verdict(r, bound)["blames"] for r in rows}
    # at a 10 ms bound every p99 of the grid fails: only the system fails
    assert blames == ({"none", "generator", "system"} if bound > 20
                      else {"system"})


# -- (c) one fixed-rate sweep in each package ----------------------------------
def _fixed_rate_sweep(name):
    if name == "jax":
        return _ref().sweep_balancer(fixed_rate=40.0, n_invokers=4,
                                     duration=0.5)
    return _port().sweep_balancer(fixed_rate=40.0, n_invokers=4,
                                  duration=0.5, device="cpu")


def _headline_windows(monkeypatch, loadgen):
    """Each window `loadgen.sweep_balancer` measures from now on, by its
    seed, judged in place (the headline's first is the sweep's seed + 1)."""
    rows, real = {}, loadgen._measure_step

    async def step(target, rate, duration, dist, seed, *a, **kw):
        rows[seed] = await real(target, rate, duration, dist, seed, *a, **kw)
        return rows[seed]

    monkeypatch.setattr(loadgen, "_measure_step", step)
    return rows


def test_fixed_rate_sweep_in_each_package_completes_every_activation(
        monkeypatch):
    """One sweep a package, alike, before the two asserted: the first in a
    process pays its one-time costs (lazy imports and inits, thread pools,
    the JAX package's first compiles) inside its own run. A failure names
    the package, the verdict's failed checks and blame, and the
    generator's stalls. The load on the core decides whether a package's
    first headline window stalls, so each package's `retried` marker is
    held to its own first window (the one-retry rule), and the headlines'
    other fields are compared."""
    for name in ("jax", "port"):
        _fixed_rate_sweep(name)
    windows = {"jax": _headline_windows(monkeypatch, _ref()),
               "port": _headline_windows(monkeypatch, _port())}
    want, got = _fixed_rate_sweep("jax"), _fixed_rate_sweep("port")
    for name, out in (("jax", want), ("port", got)):
        head = out["headline"]
        assert out["sustained"], (name, head["verdict"],
                                  head.get("generator"))
        assert head["completed"] == head["offered"] == 20
        assert head["errors"] == head["unfinished"] == 0
        assert out["sustained_offered_rate"] == 40.0
        assert out["latency_base"] == "scheduled_arrival"
        assert out["stage_budget"]["count"] == 20
        assert out["stage_budget"]["budget_vs_measured_p50"] > 0
    assert set(got["stage_budget"]) == set(want["stage_budget"])
    # the balancer's stages (publish_enqueue through device_readback) are
    # stamped in both, so the budgets split the e2e alike
    assert set(got["stage_budget"]["stage_medians_ms"]) == \
        set(want["stage_budget"]["stage_medians_ms"])
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    # `retried` marks a headline whose first window (seed 1 + 1) was
    # judged unsustainable and measured again
    for name, out in (("jax", want), ("port", got)):
        first = windows[name][2]
        retried = out["headline"].pop("retried", False)
        assert retried is (not first["sustainable"]), (name, first["verdict"])
    assert set(got["headline"]) == set(want["headline"])


# -- (d) the card by default -----------------------------------------------------
def test_device_defaults_to_the_card():
    """No `--device` means None (the card) for `sweep_balancer`, and
    `--device cpu` the CPU."""
    loadgen = _port()
    devices = []

    def sweep(**kw):
        devices.append(kw["device"])
        return {"mode": "open_loop"}

    argv, orig = sys.argv, loadgen.sweep_balancer
    loadgen.sweep_balancer = sweep
    try:
        for extra in ([], ["--device", "cuda"], ["--device", "cpu"]):
            sys.argv = ["loadgen", "--rate", "5", *extra]
            assert loadgen.main() is None
    finally:
        sys.argv = argv
        loadgen.sweep_balancer = orig
    assert devices == [None, None, "cpu"]


def test_cli_without_a_card_prints_one_json_error_line_and_exits_1():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the CLI where there is no CUDA card")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "openwhisk_tpu_torch.tools.loadgen",
         "--rate", "10", "--duration", "0.2", "--invokers", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["sustained_activations_per_sec"] is None
    assert "no CUDA device is available" in row["error"]
