"""The port's named differences for the reference's load generator and
performance harness cases, as `tests/torch_ported_cases.py` substitutions
of the port's run (`ported(..., subs=SUBS[ref], ports=PORTS.get(ref, ()))`).

The reference's cases import the root `tools/loadgen.py` and the
`tests/performance/` scripts by path; the port's run imports its copies,
`openwhisk_tpu_torch.tools.loadgen` and `openwhisk_tpu_torch.performance`,
and asks each for the CPU (`device="cpu"`, `--device cpu`): the port's
entry points place on the CUDA card unless told otherwise. Both test files
that run `tests/test_performance_harness.py` use these same substitutions
(a file's run is made once a process).
"""

PORT = "openwhisk_tpu_torch"
_LOADGEN = [("from tools.loadgen import", f"from {PORT}.tools.loadgen import"),
            ("from tools import loadgen", f"from {PORT}.tools import loadgen")]

SUBS = {
    "test_waterfall": {PORT: _LOADGEN[:1]},
    "test_hostprof": {PORT: _LOADGEN[:1]},
    "test_anomaly": {PORT: _LOADGEN[:1] + [
        ("anomaly=plane, prewarm=False)",
         'anomaly=plane, prewarm=False, device="cpu")')]},
    "test_funnel": {PORT: [
        ("            import loadgen\n",
         f"            from {PORT}.tools import loadgen\n"),
        ("shared=True, p99_bound_ms=60000.0)",
         'shared=True, p99_bound_ms=60000.0, device="cpu")')]},
    "test_performance_harness": {PORT: _LOADGEN[1:] + [
        ('sys.path.insert(0, PERF_DIR)\n\nimport simulations  # noqa: E402',
         f"from {PORT}.performance import simulations  # noqa: E402"),
        ("port=13441)", 'port=13441, device="cpu")'),
        ("port=13442)", 'port=13442, device="cpu")'),
        ("port=13443)", 'port=13443, device="cpu")'),
        ("ok = simulations.run_soak(duration=3.0, concurrency=4, port=13444)",
         "ok = simulations.run_soak(duration=3.0, concurrency=4, port=13444,"
         ' device="cpu")'),
        ("import placement_sweep",
         f"from {PORT}.performance import placement_sweep"),
        ("bench_single(16, batch=8, iters=2)",
         'bench_single(16, batch=8, iters=2, device="cpu")'),
        ("n_shards=8)", 'n_shards=8, device="cpu")'),
        ('[sys.executable, os.path.join(PERF_DIR, "owperf.py"),\n'
         '             "--samples", "2", "--ratio", "1", "--port", "13444"]',
         f'[sys.executable, "-m", "{PORT}.performance.owperf",\n'
         '             "--samples", "2", "--ratio", "1", "--port", "13444",'
         ' "--device", "cpu"]'),
        ("import warmhit", f"from {PORT}.performance import warmhit"),
        ("n_actions=16)", 'n_actions=16, device="cpu")'),
        ("import harness", f"from {PORT}.performance import harness"),
        ('port=13449, balancer="tpu")',
         'port=13449, balancer="tpu", device="cpu")')]},
}

#: in descending order, so that each gets a free port of its own (a number
#: one past an already mapped one would stay one past it)
PORTS = {"test_performance_harness": ("13449", "13444", "13443", "13442",
                                      "13441")}
