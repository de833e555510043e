"""The port's performance harness and its load generator's copies, held
against the JAX package's.

  (a) every case of `tests/test_performance_harness.py` but the two
      `bench.py` rider classes, on both packages (`pkg`; see
      `tests/torch_ported_cases.py` and `tests/torch_loadgen_cases.py`):
      the simulations, the soak, the placement sweep, owperf and warm-hit
      parity, the port's at `device="cpu"`;
  (b) `warmhit.simulate` returns the JAX package's dict, key for key, at
      three seeds (batches below and above the repair's 32 rows);
  (c) `placement_sweep._example_batch` builds `__graft_entry__`'s request
      columns, column for column;
  (d) the seven copied modules are their references outside their named
      cuts: `tools/loadgen.py`, the three `bench.py` functions of
      `tools/echo_fleet.py`, and `performance/{harness,simulations,owperf,
      warmhit,placement_sweep}.py`.
"""
import ast
import re
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_deploy import _apply, code_lines
from tests.torch_loadgen_cases import PORTS, SUBS
from tests.torch_ported_cases import ported

ROOT = Path(__file__).resolve().parents[1]
PORT = "openwhisk_tpu_torch"

ported(globals(), "test_performance_harness",
       only=("TestSimulations", "TestPlacementSweep", "TestOwperf",
             "TestWarmHitParity", "TestOpenLoopSoak"),
       ports=PORTS["test_performance_harness"],
       subs=SUBS["test_performance_harness"])


# -- (b) warm-hit parity -------------------------------------------------------
@pytest.mark.parametrize("seed,n_invokers,rounds,batch", [
    (11, 24, 6, 48), (3, 24, 6, 16), (29, 32, 4, 64)])
def test_warmhit_simulate_equals_the_jax_package(seed, n_invokers, rounds,
                                                 batch):
    from openwhisk_tpu_torch.performance import warmhit
    from tests.performance import warmhit as ref
    kw = dict(n_invokers=n_invokers, rounds=rounds, batch=batch,
              n_actions=16, seed=seed)
    want = ref.simulate(**kw)
    got = warmhit.simulate(**kw, device="cpu")
    assert list(got) == list(want)
    assert got == want
    assert got["decision_parity"] == 1.0


# -- (c) the example batch ----------------------------------------------------
@pytest.mark.parametrize("n_invokers,batch,seed", [
    (16, 8, 0), (1024, 256, 7), (4096, 32, 3)])
def test_example_batch_equals_the_graft_entry(n_invokers, batch, seed):
    from __graft_entry__ import _example_batch as ref
    from openwhisk_tpu_torch.performance.placement_sweep import _example_batch
    want = ref(n_invokers, batch, seed=seed)
    got = _example_batch(n_invokers, batch, seed=seed, device="cpu")
    assert got._fields == want._fields
    for name, w, g in zip(want._fields, want, got):
        assert g.device.type == "cpu", name
        assert np.array_equal(g.numpy(), np.asarray(w)), name
        assert g.numpy().dtype == np.asarray(w).dtype, name


# -- (d) the copies ------------------------------------------------------------
def _renamed(src):
    """The reference in the port's names: its `openwhisk_tpu` imports name
    `openwhisk_tpu_torch`."""
    return re.sub(r"\bopenwhisk_tpu\b", PORT, src)


def _cut(name, old, new):
    """A named cut replacing the first `old` of the renamed reference."""
    return (name, old, None, new)


_DEVICE_ARG = (
    '    ap.add_argument("--device", choices=("cuda", "cpu"), '
    'default="cuda",\n')
_NO_PREAMBLE = _cut(
    "no sys.path preamble",
    "_REPO = os.path.dirname(os.path.dirname(os.path.dirname("
    "os.path.abspath(__file__))))\nif _REPO not in sys.path:\n"
    "    sys.path.insert(0, _REPO)\n", "")
_PORT_HARNESS = (
    "try:\n    from harness import {names}\nexcept ImportError:{comment}\n"
    "    from .harness import {names}\n")

#: the port's copy -> (its reference, the named cuts of the renamed
#: reference). Every other code line is the reference's.
COPIES = {
    "tools/loadgen.py": ("tools/loadgen.py", [
        _cut("no sys.path preamble (nor os)", "import os\n", ""),
        _cut("no sys.path preamble",
             "_REPO = os.path.dirname(os.path.dirname(os.path.abspath("
             "__file__)))\nif _REPO not in sys.path:\n"
             "    sys.path.insert(0, _REPO)\n", ""),
        _cut("the target's device",
             "fleet_mesh: bool = False, stragglers=None):",
             "fleet_mesh: bool = False, stragglers=None, device=None):"),
        _cut("the target keeps its device",
             "        self.stragglers = stragglers\n",
             "        self.stragglers = stragglers\n"
             "        self.device = device\n"),
        _cut("the echo fleet for bench.py", "        import bench\n", ""),
        _cut("the echo fleet's import",
             "        from openwhisk_tpu_torch.messaging import "
             "MemoryMessagingProvider\n",
             "        from openwhisk_tpu_torch.messaging import "
             "MemoryMessagingProvider\n"
             "        from openwhisk_tpu_torch.tools import echo_fleet\n"),
        _cut("placement_kernel and the device",
             "                               kernel=self.kernel, "
             "prewarm=self.prewarm,\n"
             "                               fleet_mesh=self.fleet_mesh)\n",
             "                               placement_kernel=self.kernel,\n"
             "                               prewarm=self.prewarm,\n"
             "                               fleet_mesh=self.fleet_mesh,\n"
             "                               device=self.device)\n"),
        _cut("the echo fleet", "await bench._echo_fleet(",
             "await echo_fleet._echo_fleet("),
        _cut("the echo action", "bench._bench_action(",
             "echo_fleet._bench_action("),
        _cut("no path bootstrap",
             "        import bench  # noqa: F401 — path bootstrap already "
             "done at start()\n", ""),
        _cut("the funnel worker's echo actions", "        import bench\n", ""),
        _cut("the funnel worker's echo import",
             "        from openwhisk_tpu_torch.messaging.tcp import "
             "TcpMessagingProvider\n",
             "        from openwhisk_tpu_torch.messaging.tcp import "
             "TcpMessagingProvider\n"
             "        from openwhisk_tpu_torch.tools import echo_fleet\n"),
        _cut("the funnel worker's echo action", "bench._bench_action(",
             "echo_fleet._bench_action("),
        _cut("the funnel process's device",
             "                 port: Optional[int] = None) -> None:",
             "                 port: Optional[int] = None, device=None) "
             "-> None:"),
        _cut("the funnel process's echo fleet", "        import bench\n", ""),
        _cut("the funnel process's echo import",
             "                                                 "
             "TcpMessagingProvider)\n",
             "                                                 "
             "TcpMessagingProvider)\n"
             "        from openwhisk_tpu_torch.tools import echo_fleet\n"),
        _cut("the funnel balancer's kernel and device",
             "                          kernel=kernel, prewarm=False)",
             "                          placement_kernel=kernel, "
             "prewarm=False,\n                          device=device)"),
        _cut("the funnel process's fleet", "await bench._echo_fleet(",
             "await echo_fleet._echo_fleet("),
        _cut("the funnel process's actions", "bench._bench_action(",
             "echo_fleet._bench_action("),
        _cut("the sweep's device",
             "                   funnel: Optional[str] = None) -> dict:",
             "                   funnel: Optional[str] = None, device=None) "
             "-> dict:"),
        _cut("the sweep's target device",
             "                                     stragglers=stragglers)",
             "                                     stragglers=stragglers, "
             "device=device)"),
        _cut("the device in the block",
             '                "fleet_shards": getattr(target.bal, '
             '"n_shards", 1),\n',
             '                "fleet_shards": getattr(target.bal, '
             '"n_shards", 1),\n'
             '                "device": getattr(getattr(target.bal, '
             '"device", None),\n'
             '                                  "type", None),\n'),
        _cut("the processes' device",
             "                         shared: bool = False) -> dict:",
             "                         shared: bool = False, device=None) "
             "-> dict:"),
        _cut("the funnel process as a module",
             "        serve_cmd = [sys.executable, os.path.abspath(__file__),",
             '        serve_cmd = [sys.executable, "-m", '
             '"openwhisk_tpu_torch.tools.loadgen",'),
        _cut("the funnel process's --device",
             '                     "--kernel", kernel]',
             '                     "--kernel", kernel, "--device", '
             'device or "cuda"]'),
        _cut("the workers as a module",
             "            cmd = [sys.executable, os.path.abspath(__file__),",
             '            cmd = [sys.executable, "-m", '
             '"openwhisk_tpu_torch.tools.loadgen",'),
        _cut("the workers' --device",
             '"--p99-bound-ms", str(p99_bound_ms), "--emit-samples"]',
             '"--p99-bound-ms", str(p99_bound_ms), "--emit-samples",\n'
             '                   "--device", device or "cuda"]'),
        _cut("main's exit code", "def main() -> None:",
             "def main() -> Optional[int]:"),
        _cut("--kernel is placement_kernel; --device",
             '    ap.add_argument("--kernel", default="auto")\n',
             '    ap.add_argument("--kernel", choices=("auto", "scan", '
             '"repair"),\n'
             '                    default="auto",\n'
             '                    help="the target balancer\'s placement '
             'kernel")\n' + _DEVICE_ARG +
             '                    help="where the target balancer places: '
             'the CUDA card "\n'
             '                         "(default) or the plain torch path on '
             'the CPU")\n'),
        _cut("--device cuda is the card",
             "    args = ap.parse_args()\n",
             "    args = ap.parse_args()\n"
             '    device = None if args.device == "cuda" else args.device\n'),
        _cut("the funnel process's --device", "port=args.serve_port)",
             "port=args.serve_port, device=device)"),
        _cut("the processes' --device", "shared=args.shared)",
             "shared=args.shared, device=device)"),
        _cut("the sweep's --device", "funnel=args.funnel)",
             "funnel=args.funnel, device=device)"),
        _cut("an error exits 1",
             '"sustained_activations_per_sec": None}))\n        return\n',
             '"sustained_activations_per_sec": None}))\n        return 1\n'),
        _cut("the exit code", 'if __name__ == "__main__":\n    main()',
             'if __name__ == "__main__":\n    sys.exit(main())')]),
    "performance/harness.py": ("tests/performance/harness.py", [
        _NO_PREAMBLE,
        _cut("the port's loadgen", "    from tools.loadgen import "
             "make_schedule\n    from tools.loadgen import open_loop as "
             "_drive\n",
             "    from openwhisk_tpu_torch.tools.loadgen import "
             "make_schedule\n"
             "    from openwhisk_tpu_torch.tools.loadgen import open_loop "
             "as _drive\n")]),
    "performance/simulations.py": ("tests/performance/simulations.py", [
        _cut("the port's harness", _PORT_HARNESS.format(
            names="Client, Stats, run_with_standalone, timed_loop",
            comment="  # imported as a package module (smoke tests)"),
            "from .harness import Client, Stats, run_with_standalone, "
            "timed_loop\n"),
        _cut("run's device",
             "def run(names, requests: int, concurrency: int, "
             "port: int = 13366) -> bool:",
             "def run(names, requests: int, concurrency: int, "
             "port: int = 13366,\n        device=None) -> bool:"),
        _cut("run's standalone on the device",
             "    return run_with_standalone(go, port=port)\n",
             "    return run_with_standalone(go, port=port, device=device)\n"),
        _cut("run_soak's device", '             balancer: str = "tpu") '
             "-> bool:",
             '             balancer: str = "tpu", device=None) -> bool:'),
        _cut("run_soak's standalone on the device",
             "                               balancer=balancer)",
             "                               balancer=balancer, "
             "device=device)"),
        _cut("--device", "    args = ap.parse_args()\n",
             _DEVICE_ARG +
             '                    help="where the standalone\'s balancer '
             'places: the CUDA "\n'
             '                         "card (default) or the plain torch '
             'path on the CPU")\n'
             "    args = ap.parse_args()\n"
             '    device = None if args.device == "cuda" else args.device\n'),
        _cut("the soak's --device", "                               "
             "args.balancer) else 1)",
             "                               args.balancer, device=device) "
             "else 1)"),
        _cut("the simulations' --device",
             "    sys.exit(0 if run(names, args.requests, args.concurrency, "
             "args.port) else 1)",
             "    sys.exit(0 if run(names, args.requests, args.concurrency, "
             "args.port,\n                      device=device) else 1)")]),
    "performance/owperf.py": ("tests/performance/owperf.py", [
        _cut("the port's harness", _PORT_HARNESS.format(
            names="NOOP_CODE, Client, open_loop, run_with_standalone",
            comment=""),
            "from .harness import NOOP_CODE, Client, open_loop, "
            "run_with_standalone\n"),
        _cut("--device", "    args = ap.parse_args()\n",
             _DEVICE_ARG +
             '                    help="where the standalone\'s balancer '
             'places: the CUDA "\n'
             '                         "card (default) or the plain torch '
             'path on the CPU")\n'
             "    args = ap.parse_args()\n"),
        _cut("the standalone on the device",
             "    run_with_standalone(go, port=args.port)",
             "    run_with_standalone(go, port=args.port,\n"
             '                        device=None if args.device == "cuda" '
             "else args.device)")]),
    "performance/warmhit.py": ("tests/performance/warmhit.py", [
        ("torch, the balancer's choice of kernel, no preamble",
         "import os\nimport random\nimport sys\n",
         "    import jax.numpy as jnp\n",
         "import random\n\nimport numpy as np\n\n\n"
         "def _schedule(state, batch):\n"
         "    from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer "
         "import \\\n        REPAIR_MIN_BATCH\n"
         "    from openwhisk_tpu_torch.ops.placement_cuda import (\n"
         "        schedule_batch_cuda, schedule_batch_repair_cuda, "
         "to_transposed)\n"
         "    if batch.valid.shape[0] >= REPAIR_MIN_BATCH:\n"
         "        ts, chosen, forced, _rounds = schedule_batch_repair_cuda(\n"
         "            to_transposed(state), batch)\n"
         "    else:\n"
         "        ts, chosen, forced = schedule_batch_cuda(to_transposed("
         "state), batch)\n"
         "    return to_transposed(ts), chosen, forced\n\n\n"
         "def simulate(n_invokers: int, rounds: int, batch: int, "
         "n_actions: int = 32,\n"
         "             seed: int = 11, device=None) -> dict:\n"
         "    import torch\n"),
        _cut("the release kernel and the device",
             "                                             release_batch, "
             "schedule_batch)\n",
             "                                             resolve_device)\n"
             "    from openwhisk_tpu_torch.ops.placement_cuda import "
             "release_batch_cuda\n\n    dev = resolve_device(device)\n"),
        _cut("the books on the device",
             "                        action_slots=max(64, n_actions))",
             "                        action_slots=max(64, n_actions), "
             "device=dev)"),
        ("the round's columns on the device, the balancer's kernel",
         "        rb = RequestBatch(*(jnp.asarray(cols[k]) for k in\n",
         "        kernel_out = [int(c) for c in np.asarray(chosen)]\n",
         "        rb = RequestBatch(*(torch.from_numpy(cols[k]).to(dev) for k "
         "in\n"
         '                            ("offset", "size", "home", "step_inv", '
         '"need_mb",\n'
         '                             "conc_slot", "max_conc", "rand")),\n'
         "                          valid=torch.ones((batch,), "
         "dtype=torch.bool,\n"
         "                                           device=dev))\n"
         "        kstate, chosen, _forced = _schedule(kstate, rb)\n"
         "        kernel_out = [int(c) for c in chosen.cpu().numpy()]\n"),
        ("the releases on the device",
         "            inv = jnp.asarray(", "                                   "
         "valid)\n",
         "            inv = torch.tensor([kc for a, _, kc in rel], "
         "dtype=torch.int32,\n"
         "                               device=dev)\n"
         "            slot = torch.tensor([a for a, _, _ in rel], "
         "dtype=torch.int32,\n"
         "                                device=dev)\n"
         "            mem = torch.tensor([actions[a][2] for a, _, _ in rel],\n"
         "                               dtype=torch.int32, device=dev)\n"
         "            maxc = torch.ones((len(rel),), dtype=torch.int32, "
         "device=dev)\n"
         "            valid = torch.tensor([kc >= 0 for _, _, kc in rel],\n"
         "                                 dtype=torch.bool, device=dev)\n"
         "            kstate = release_batch_cuda(kstate, inv.clamp(min=0), "
         "slot, mem,\n"
         "                                        maxc, valid)\n"),
        ("--device", "    args = ap.parse_args()\n",
         "                              args.actions)))",
         _DEVICE_ARG +
         '                    help="where the books live: the CUDA card '
         '(default; the "\n'
         '                         "kernels) or the CPU (their plain '
         'versions)")\n'
         "    args = ap.parse_args()\n"
         "    print(json.dumps(simulate(args.invokers, args.rounds, "
         "args.batch,\n"
         "                              args.actions,\n"
         '                              device=None if args.device == "cuda"'
         "\n                              else args.device)))")]),
}


def _sweep_cuts():
    graft = (ROOT / "__graft_entry__.py").read_text()
    tree = ast.parse(graft)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_example_batch")
    example = ast.get_source_segment(graft, fn) + "\n"
    example = _renamed(example).replace(
        "def _example_batch(n_invokers: int, batch: int, seed: int = 0):",
        "def _example_batch(n_invokers: int, batch: int, seed: int = 0, "
        "device=None):").replace(
        "    import jax.numpy as jnp\n", "    import torch\n").replace(
        "    from openwhisk_tpu_torch.ops.placement import RequestBatch\n",
        "    from openwhisk_tpu_torch.ops.placement import RequestBatch, "
        "resolve_device\n\n    dev = resolve_device(device)\n").replace(
        "    return RequestBatch(*(jnp.asarray(cols[k]) for k in\n",
        "    return RequestBatch(*(torch.from_numpy(cols[k]).to(dev) for k "
        "in\n").replace(
        "                        valid=jnp.ones((batch,), bool))\n",
        "                        valid=torch.ones((batch,), dtype=torch.bool,\n"
        "                                         device=dev))\n")
    return [
        ("the example batch, no preamble, torch's wait",
         "import os\nimport sys\nimport time\n", "        jax.block_until_"
         "ready(chosen)\n",
         "import time\n\nimport numpy as np\n\n\n" + example +
         "\n\ndef _block() -> None:\n    import torch\n\n"
         "    if torch.cuda.is_initialized():\n"
         "        torch.cuda.synchronize()\n\n\n"
         "def _measure(config: str, n_invokers: int, batch: int, "
         "iters: int,\n             state, step) -> dict:\n"
         "    for _ in range(3):\n        state, chosen = step(state)\n"
         "    _block()\n\n    lat = []\n    t0 = time.perf_counter()\n"
         "    for _ in range(iters):\n        t1 = time.perf_counter()\n"
         "        state, chosen = step(state)\n        _block()\n"),
        ("the balancer's step on the device",
         "                 seed: int = 7) -> dict:\n    import jax.numpy",
         "req.max_conc, ok), chosen\n",
         "                 seed: int = 7, device=None) -> dict:\n"
         "    from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer "
         "import \\\n        device_pair\n"
         "    from openwhisk_tpu_torch.ops.placement import init_state, "
         "resolve_device\n\n    dev = resolve_device(device)\n"
         "    state = init_state(n_invokers, [slot_mb] * n_invokers, "
         "action_slots=256,\n                       device=dev)\n"
         "    req = _example_batch(n_invokers, batch, seed=seed, "
         "device=dev)\n"
         '    schedule, release, _ = device_pair(dev, "auto")\n\n'
         "    def step(state):\n"
         "        state, chosen, forced, *_rounds = schedule(state, req)\n"
         "        ok = chosen >= 0\n"
         "        return release(state, chosen.clamp(min=0), req.conc_slot,\n"
         "                       req.need_mb, req.max_conc, ok), chosen\n"),
        ("the port's mesh on the device",
         "                  slot_mb: int = 2048, seed: int = 7) -> dict:\n",
         "    req = _example_batch(n_invokers, batch, seed=seed)\n",
         "                  slot_mb: int = 2048, seed: int = 7, device=None) "
         "-> dict:\n"
         "    from openwhisk_tpu_torch.ops.placement import init_state\n"
         "    from openwhisk_tpu_torch.parallel.sharded_state import "
         "(make_mesh,\n"
         "                                                      "
         "make_sharded_release,\n"
         "                                                      "
         "make_sharded_schedule,\n"
         "                                                      "
         "shard_state)\n\n"
         "    mesh = make_mesh(n_shards, device=device)\n"
         "    state = shard_state(\n"
         "        init_state(n_invokers, [slot_mb] * n_invokers, "
         "action_slots=256,\n                   device=mesh.lead), mesh)\n"
         "    req = _example_batch(n_invokers, batch, seed=seed, "
         "device=mesh.lead)\n"),
        _cut("the sharded release's clamp",
             "        return release(state, jnp.clip(chosen, 0), "
             "req.conc_slot,\n",
             "        return release(state, chosen.clamp(min=0), "
             "req.conc_slot,\n"),
        ("--kernel: the CUDA scan against its plain version",
         "def bench_pallas(", "    prow = _measure(",
         "def bench_kernel(n_invokers: int, batch: int, iters: int, "
         "slot_mb: int = 2048,\n"
         "                 action_slots: int = 256, seed: int = 7, "
         "device=None) -> dict:\n"
         "    from openwhisk_tpu_torch.ops.placement import (init_state, "
         "resolve_device,\n"
         "                                             schedule_batch)\n"
         "    from openwhisk_tpu_torch.ops.placement_cuda import "
         "(schedule_batch_cuda,\n"
         "                                                  to_transposed)\n"
         "\n    dev = resolve_device(device)\n\n"
         "    def books():\n"
         "        return init_state(n_invokers, [slot_mb] * n_invokers,\n"
         "                          action_slots=action_slots, device=dev)\n\n"
         "    req = _example_batch(n_invokers, batch, seed=seed, "
         "device=dev)\n"
         '    row = _measure("plain-schedule", n_invokers, batch, iters, '
         "books(),\n"
         "                   lambda s: schedule_batch(s, req)[:2])\n"
         "    krow = _measure("),
        _cut("the kernel's row", '"pallas-schedule", n_invokers, batch, '
             "iters,\n                    to_transposed(state),\n"
             "                    lambda s: schedule_batch_pallas(s, "
             "req)[:2])\n",
             '"cuda-schedule", n_invokers, batch, iters,\n'
             "                    to_transposed(books()),\n"
             "                    lambda s: schedule_batch_cuda(s, "
             "req)[:2])\n"),
        _cut("the kernel's numbers", '    row["pallas_placements_per_sec"] = '
             'prow["placements_per_sec"]\n    row["pallas_p50_step_ms"] = '
             'prow["p50_step_ms"]\n    row["config"] = "pallas-vs-xla"\n',
             '    row["cuda_placements_per_sec"] = krow["placements_per_sec"]'
             '\n    row["cuda_p50_step_ms"] = krow["p50_step_ms"]\n'
             '    row["config"] = "cuda-vs-plain"\n'),
        ("--kernel and --device", '    ap.add_argument("--pallas", ',
         "args.iters)), flush=True)\n",
         '    ap.add_argument("--kernel", action="store_true",\n'
         '                    help="also compare the CUDA scan kernel vs '
         'its plain "\n'
         '                         "version")\n' + _DEVICE_ARG +
         '                    help="where the books live: the CUDA card '
         '(default) or "\n'
         '                         "the CPU")\n'
         '    ap.add_argument("--batch", type=int, default=256)\n'
         '    ap.add_argument("--iters", type=int, default=20)\n'
         '    ap.add_argument("--sizes", type=int, nargs="*",\n'
         "                    default=[16, 256, 4096, 65536])\n"
         "    args = ap.parse_args()\n"
         '    device = None if args.device == "cuda" else args.device\n\n'
         "    for n in args.sizes:\n"
         "        print(json.dumps(bench_single(n, args.batch, args.iters,\n"
         "                                      device=device)), "
         "flush=True)\n"),
        ("the sharded and kernel rows on the device",
         "            print(json.dumps(bench_sharded(n, args.batch, "
         "args.iters)),\n", "                      flush=True)\n",
         "            print(json.dumps(bench_sharded(n, args.batch, "
         "args.iters,\n"
         "                                           device=device)),\n"
         "                  flush=True)\n"
         "    if args.kernel:\n"
         "        from openwhisk_tpu_torch.ops.placement_cuda import "
         "fits_scan\n"
         "        for n in args.sizes:\n"
         "            if fits_scan(n):\n"
         "                print(json.dumps(bench_kernel(n, args.batch, "
         "args.iters,\n"
         "                                              device=device)),\n"
         "                      flush=True)\n")]


COPIES["performance/placement_sweep.py"] = (
    "tests/performance/placement_sweep.py", _sweep_cuts())


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_modules_are_copies_outside_their_named_cuts(rel):
    ref_rel, cuts = COPIES[rel]
    ref = _renamed((ROOT / ref_rel).read_text())
    port = (ROOT / PORT / rel).read_text()
    assert code_lines(port) == code_lines(_apply(ref, cuts))
    assert f"A copy of the repository's `{ref_rel}`" in \
        ast.get_docstring(ast.parse(port))


#: the echo fleet: the three functions of `bench.py` it copies
ECHO_FUNCTIONS = ("_bench_action", "_echo_invoker", "_echo_fleet")
#: their named cuts: the pinger spreads each second's pings over the
#: second, PING_CHUNK at a time (a health topic of the in-memory bus keeps
#: 4,096: bench.py's burst never registers a fleet past it)
ECHO_CUTS = {"_echo_fleet": [
    _cut("the pings in chunks",
         "    stop_ping = asyncio.Event()\n",
         "    stop_ping = asyncio.Event()\n"
         "    chunks = [instances[k:k + PING_CHUNK]\n"
         "              for k in range(0, len(instances), PING_CHUNK)]\n"),
    _cut("each chunk, then its share of the second",
         "            for inst in instances:\n"
         "                await producer.send(\"health\", PingMessage(inst))\n"
         "            try:\n"
         "                await asyncio.wait_for(stop_ping.wait(), 1.0)\n"
         "            except asyncio.TimeoutError:\n"
         "                pass\n",
         "            for chunk in chunks:\n"
         "                for inst in chunk:\n"
         "                    await producer.send(\"health\", "
         "PingMessage(inst))\n"
         "                try:\n"
         "                    await asyncio.wait_for(stop_ping.wait(),\n"
         "                                           1.0 / len(chunks))\n"
         "                    return\n"
         "                except asyncio.TimeoutError:\n"
         "                    pass\n")]}


def _functions(src, names):
    tree = ast.parse(src)
    return {n.name: ast.get_source_segment(src, n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name in names}


@pytest.mark.parametrize("name", ECHO_FUNCTIONS)
def test_echo_fleet_functions_are_copies_of_bench(name):
    """Each function's code, line for line, with the imports renamed to
    the port (the stragglers' parser is the port's loadgen's)."""
    ref = _functions(_renamed((ROOT / "bench.py").read_text()),
                     ECHO_FUNCTIONS)[name]
    ref = ref.replace("from tools.loadgen import parse_stragglers",
                      f"from {PORT}.tools.loadgen import parse_stragglers")
    ref = _apply(ref, ECHO_CUTS.get(name, []))
    src = (ROOT / PORT / "tools" / "echo_fleet.py").read_text()
    got = _functions(src, ECHO_FUNCTIONS)
    assert sorted(got) == sorted(ECHO_FUNCTIONS)
    assert code_lines(got[name]) == code_lines(ref)
    tree = ast.parse(src)
    top = [n.name for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef))]
    assert top == list(ECHO_FUNCTIONS), "nothing else of bench.py"
    assert "A copy of the three functions of the repository's `bench.py`" \
        in ast.get_docstring(tree)
