"""The port's kernel profiler against the JAX package's.

The signature census (first-seen signatures, their classification, the
cache census, the watchdog counters) on one call sequence through both
profilers — numpy arrays into the JAX one, tensors of the same shapes
into the port's; the phase rollups and their exposition; tail sampling and
the capture window, whose `torch.profiler` session writes a Chrome trace
on the CPU; `memory_stats` ({} on the CPU, the allocator's statistics
under the JAX keys on a card, stubbed here); the census of kernel builds
fed by `ops/_build.py` (a stand-in compiler builds a C source here).

Comparisons are exact (counts, reasons, signatures, text); clocks and
wall times are left out.
"""
import json
import os
import stat
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from openwhisk_tpu.ops import profiler as JPR  # noqa: E402
from openwhisk_tpu.utils.logging import MetricEmitter as JMetrics  # noqa: E402
from openwhisk_tpu_torch.ops import _build  # noqa: E402
from openwhisk_tpu_torch.ops import profiler as TPR  # noqa: E402
from openwhisk_tpu_torch.utils.logging import \
    MetricEmitter as TMetrics  # noqa: E402


class _Warns:
    def __init__(self):
        self.warns = []

    def warn(self, _tid, msg, _cls=None):
        self.warns.append(msg)


def _pair(**cfg):
    out = []
    for mod, metrics in ((JPR, JMetrics), (TPR, TMetrics)):
        p = mod.KernelProfiler(mod.ProfilingConfig(**cfg))
        p.metrics, p.logger = metrics(), _Warns()
        out.append(p)
    return out


def _log(p):
    return [(e["entry"], e["signature"], e["expected"], e["reason"])
            for e in p.compile_log(256)]


def _calls(arr):
    """One call sequence over a wrapped step and a wrapped fold: first
    calls, hits, pow2 buckets, a growth window, churn, a rebuilt entry."""
    state = (arr((64,), "int32"), arr((64, 8), "int32"), arr((64,), "bool"))
    seq = []
    for r, h, b in ((8, 64, 8), (8, 64, 8), (16, 64, 16), (32, 64, 32)):
        seq.append(("step", (state, arr((5 * r + 3 * h + 9 * b,), "int32"),
                             r, h, b)))
    seq.append(("fold", (state, arr((5, 8), "int32"))))
    seq.append(("fold", (state, arr((5, 8), "int32"))))
    seq.append(("expect", "fleet_growth"))
    grown = (arr((128,), "int32"), arr((128, 8), "int32"),
             arr((128,), "bool"))
    seq.append(("step", (grown, arr((5 * 8 + 3 * 64 + 9 * 8,), "int32"),
                         8, 64, 8)))
    seq.append(("close_window", None))
    seq.append(("step", (grown, arr((5 * 24 + 3 * 64 + 9 * 24,), "int32"),
                         24, 64, 24)))            # a non-pow2 bucket: churn
    seq.append(("fold", (grown, arr((5, 12), "int32"))))  # churn too
    seq.append(("rewrap", None))
    seq.append(("step", (grown, arr((5 * 8 + 3 * 64 + 9 * 8,), "int32"),
                         8, 64, 8)))
    return seq


def _run(p, arr):
    fns = {}

    def wrap(tag):
        fns["step"] = p.wrap("fused_step", lambda *a: tag,
                             expected=JPR.pow2_statics)
        fns["fold"] = p.wrap(
            "release_packed", lambda st, rel: tag,
            expected=lambda st, rel: (rel.shape[1] & (rel.shape[1] - 1)) == 0)
    wrap(0)
    for op, arg in _calls(arr):
        if op == "expect":
            p.expect(arg)
        elif op == "close_window":
            p._expect_until = 0.0
        elif op == "rewrap":
            wrap(1)
        else:
            fns[op](*arg)


def _np_arr(shape, dtype):
    return np.zeros(shape, dtype)


def _torch_arr(shape, dtype):
    return torch.zeros(shape, dtype=getattr(torch, dtype))


def test_signature_census_and_classification_match_jax():
    jp, tp = _pair()
    _run(jp, _np_arr)
    _run(tp, _torch_arr)
    assert _log(tp) == _log(jp)
    assert [r for *_, r in _log(tp)] == [
        "first_call", "bucketed_shape", "bucketed_shape", "first_call",
        "fleet_growth", "shape_churn", "shape_churn", "kernel_swap"]
    assert tp.cache_census() == jp.cache_census()
    assert (tp.compiles_expected, tp.compiles_unexpected) == \
        (jp.compiles_expected, jp.compiles_unexpected) == (6, 2)
    for exp in ("true", "false"):
        assert tp.metrics.counter_value(
            "loadbalancer_kernel_recompiles_total",
            tags={"expected": exp}) == jp.metrics.counter_value(
            "loadbalancer_kernel_recompiles_total", tags={"expected": exp})
    assert len(tp.logger.warns) == len(jp.logger.warns) == 2
    assert "int32" in _log(tp)[0][1] and "torch." not in _log(tp)[0][1]


def test_phase_rollups_and_exposition_match_jax():
    jp, tp = _pair(phase_window=16)
    rng = np.random.RandomState(4)
    for _ in range(40):
        phase = str(rng.choice(["assembly", "dispatch", "readback",
                                "fanout", "total"]))
        ms = float(rng.choice([0.01, 0.3, 2.5, 40.0, 9000.0]))
        for p in (jp, tp):
            p.observe_phase(phase, ms)
    assert tp.phase_rollups() == jp.phase_rollups()
    assert tp.prometheus_text() == jp.prometheus_text()
    assert "openwhisk_loadbalancer_phase_duration_seconds" in \
        tp.prometheus_text()


def test_tail_sampling_and_capture_window_match_jax():
    jp, tp = _pair(capture_limit=4, tail_threshold_ms=50.0)
    for p in (jp, tp):
        assert [p.admit_batch(ms) for ms in (10.0, 60.0, 49.9)] == \
            [False, True, False]
        assert p.arm_capture(10, tail_threshold_ms=25.0)["steps"] == 4
        assert p.admit_batch(1.0) is True
        for i in range(5):
            p.capture_step({"step": i})
    jj, tj = jp.profile_json("x"), tp.profile_json("x")
    for doc in (jj, tj):
        doc["capture"].pop("started")
    assert tj.pop("kernel_builds") == TPR.kernel_builds()
    assert tj["capture"].pop("trace_files") == []
    tj.pop("memory"), jj.pop("memory")
    assert tj == jj


@pytest.mark.parametrize("device", [None, "cpu"])
def test_memory_stats_are_empty_on_the_cpu(device):
    p = TPR.KernelProfiler(device=device)
    assert p.memory_stats() == {}
    assert p.refresh_memory(TMetrics()) == {}


def test_memory_stats_map_the_allocator_onto_the_jax_keys(monkeypatch):
    """On a card the allocator's counters land under the JAX package's
    keys and the `loadbalancer_hbm_*` gauges keep their names (stubbed:
    no card here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": 1 << 20,
        "allocated_bytes.all.peak": 3 << 20,
        "reserved_bytes.all.current": 4 << 20})
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (6 << 20, 8 << 20))
    p = TPR.KernelProfiler(device="cuda")
    assert p.memory_stats() == {"bytes_in_use": 1 << 20,
                                "peak_bytes_in_use": 3 << 20,
                                "bytes_limit": 8 << 20,
                                "bytes_reserved": 4 << 20}
    m = TMetrics()
    out = p.refresh_memory(m)
    assert out == {"loadbalancer_hbm_bytes_in_use": 1 << 20,
                   "loadbalancer_hbm_peak_bytes_in_use": 3 << 20,
                   "loadbalancer_hbm_bytes_limit": 8 << 20,
                   "loadbalancer_hbm_utilization_ratio": 0.125}
    assert m.gauge_value("loadbalancer_hbm_bytes_in_use") == 1 << 20


def test_capture_window_writes_a_torch_trace_on_the_cpu(tmp_path):
    p = TPR.KernelProfiler(device="cpu")
    trace_dir = str(tmp_path / "trace")
    try:
        status = p.arm_capture(2, trace_dir=trace_dir)
        assert status["trace"] == {"requested": True, "active": True}
        torch.arange(64).sum()
        for i in range(2):
            p.capture_step({"step": i})
    finally:
        if p._trace_active:  # never leave the process-wide session open
            p._stop_trace()
    assert p._trace_active is False and p._torch_prof is None
    [path] = p.trace_files
    assert os.path.dirname(path) == trace_dir
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert p.profile_json()["capture"]["trace_files"] == [path]


def test_disabled_profiler_wraps_nothing(monkeypatch):
    monkeypatch.setenv("CONFIG_whisk_profiling_enabled", "false")
    p = TPR.KernelProfiler.from_config()

    def fn(x):
        return x
    assert p.wrap("entry", fn) is fn
    p.observe_phase("total", 1.0)
    assert p.phase_rollups() == {} and p.prometheus_text() == ""
    assert p.admit_batch(0.0) is True


def test_kernel_builds_are_censused(tmp_path, monkeypatch):
    """`_build.build` and `_build.load` report every compile and every
    library load with its seconds; a second load of a built source is a
    dictionary hit and reports nothing. A stand-in compiler (a C compiler
    behind nvcc's command line) builds a C source here."""
    cc = next((c for c in ("cc", "gcc", "g++") if _which(c)), None)
    if cc is None:
        pytest.skip("no C compiler on this host")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "probe_kernel.cu").write_text("int probe(void) { return 7; }\n")
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\nimport subprocess, sys\n"
        "a = sys.argv[1:]\nout = a[a.index('-o') + 1]\n"
        f"sys.exit(subprocess.call(['{_which(cc)}', '-shared', '-fPIC', "
        "'-x', 'c', a[-1], '-o', out]))\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "_libs", {})
    # a census of its own: the process-wide one stays as other files'
    # tests expect it (no build on the CPU path)
    monkeypatch.setattr(TPR, "_BUILD_LOG", type(TPR._BUILD_LOG)(256))
    before = len(TPR.kernel_builds())
    lib = _build.load("probe_kernel")
    assert lib.probe() == 7
    _build.load("probe_kernel")
    rows = TPR.kernel_builds()[before:]
    assert [(r["source"], r["how"]) for r in rows] == [
        ("probe_kernel", "nvcc"), ("probe_kernel", "load")]
    assert all(r["seconds"] >= 0 for r in rows)
    p = TPR.KernelProfiler()
    assert p.profile_json()["kernel_builds"][-2:] == rows


def _which(name):
    import shutil
    return shutil.which(name)
