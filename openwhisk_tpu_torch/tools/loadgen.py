"""Open-loop load generator: coordinated-omission-correct e2e measurement.

A copy of the repository's `tools/loadgen.py` for the PyTorch port, run as
`python -m openwhisk_tpu_torch.tools.loadgen`. Its named cuts: no
`sys.path` preamble; the echo invokers come from `tools/echo_fleet.py`
(the copy of `bench.py`'s stand-ins); `--device cuda|cpu` places the
target balancer on the CUDA card (the default, which fails with one JSON
error line and exit code 1 where there is none) or on the CPU's plain
torch path; `--kernel` is the balancer's `placement_kernel`
(auto|scan|repair); spawned workers and the funnel process run as
`-m openwhisk_tpu_torch.tools.loadgen` with the parent's `--device`.

The reference repo benchmarks its controller with wrk
(`tests/performance/wrk_tests/post.lua`) — an open-loop generator. Our own
`bench.py:_balancer_bench` is CLOSED-loop: 64 workers behind an
`asyncio.Semaphore`, each waiting for its previous completion before
issuing the next request. Under saturation a closed loop self-throttles —
the system sets the arrival rate, queueing delay hides from the
percentiles, and the reported p99 suffers textbook coordinated omission
(Tene, "How NOT to Measure Latency"; wrk2's raison d'être; see PAPERS.md).

This module is the open-loop half of the latency observatory:

  * `make_schedule` — Poisson (or constant-rate) arrival offsets, fixed
    up front so the offered rate is independent of the system under test.
  * `open_loop` — fire each request AT its scheduled time (never waiting
    on earlier completions) and measure latency FROM the scheduled
    arrival, so time a request spends queued behind a stalled system is
    charged to the system, not silently dropped from the sample set.
  * `sweep_balancer` — double the offered rate against a live TpuBalancer
    + echo-invoker fleet until the run stops being sustainable (p99 bound
    exceeded, completions lost, or the generator itself falling behind
    schedule), then re-measure the last sustainable rate and read the
    per-stage latency budget out of the waterfall plane
    (utils/waterfall.py) — the number pair bench.py's `e2e_open_loop`
    rider reports: a sustained activations/s headline plus WHERE the
    per-activation time goes.

CLI (one JSON line on stdout, like bench.py):

    python -m openwhisk_tpu_torch.tools.loadgen --rate0 32 --duration 2.5
    python -m openwhisk_tpu_torch.tools.loadgen --rate 200   # one fixed rate
    python -m openwhisk_tpu_torch.tools.loadgen --rate 200 --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time
from typing import Awaitable, Callable, List, Optional

#: a measured step is sustainable iff ALL hold
DEFAULT_P99_BOUND_MS = 1000.0    #: e2e p99 from scheduled arrival
MIN_COMPLETION_RATIO = 0.98      #: completions / offered within the drain
MAX_FIRE_LAG_MS = 50.0           #: generator max lateness vs its schedule
DRAIN_TIMEOUT_S = 15.0


def parse_stragglers(spec) -> dict:
    """`--stragglers` SPEC -> {invoker_index: ack_delay_seconds}.

    SPEC is `IDX:DELAY_S[,IDX:DELAY_S...]` (e.g. `3:0.25` delays invoker
    3's acks by 250 ms — the straggler acceptance scenario's numbers); a bare
    `IDX` defaults to 0.25 s. Dicts pass through normalized, None/empty
    means no injection."""
    if not spec:
        return {}
    if isinstance(spec, dict):
        return {int(k): float(v) for k, v in spec.items()}
    out = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        idx, _, delay = part.partition(":")
        out[int(idx)] = float(delay) if delay else 0.25
    return out


def apply_stragglers(invokers, spec) -> dict:
    """The straggler injection, extracted to ONE helper: set `.delay`
    on the indexed invoker stand-ins. The test SimInvokers and the echo
    fleet's feeds expose the same mutable attribute, so the anomaly e2e
    tests, the `placement_quality` bench rider and manual loadgen drives
    all inject through this path. Returns the applied {index: delay_s}
    map (out-of-range indexes are dropped) — report it next to the
    numbers it skews."""
    applied = {}
    for idx, delay in sorted(parse_stragglers(spec).items()):
        if 0 <= idx < len(invokers):
            invokers[idx].delay = delay
            applied[idx] = delay
    return applied


def make_schedule(rate: float, n: int, dist: str = "poisson",
                  seed: int = 1) -> List[float]:
    """Arrival offsets (seconds from t0) for `n` requests at `rate`/s.
    Poisson: exponential inter-arrivals (the memoryless open-loop
    default); constant: a deterministic 1/rate grid."""
    if rate <= 0 or n <= 0:
        return []
    if dist == "constant":
        return [i / rate for i in range(n)]
    rng = random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(t)
    return out


async def open_loop(one: Callable[[int, int], Awaitable[bool]],
                    offsets: List[float],
                    drain_timeout: float = DRAIN_TIMEOUT_S) -> dict:
    """Drive `one(i, sched_ns)` open-loop: each request fires at its
    scheduled offset regardless of earlier completions; `sched_ns`
    (time.monotonic_ns at the scheduled arrival) is the latency base —
    `one` returns True on success. Returns samples measured FROM the
    schedule plus the generator's own health: fire lag, the generator
    process's OWN GC pauses during the window, and an attribution of the
    worst fire lag (gc_pause vs event_loop_stall) so a failed verdict can
    blame the generator or the system instead of silently blaming the
    balancer."""
    import gc

    samples_ms: List[float] = []
    errors = 0
    fire_lag_max = 0.0
    worst_lag_window = (0.0, 0.0)  # (sched, fire) monotonic seconds
    tasks: List[asyncio.Task] = []
    loop = asyncio.get_event_loop()

    # generator self-check: GC pauses in THIS process during the window.
    # A 100 ms collection between two scheduled fires reads exactly like a
    # system stall in the fire-lag number — record the pauses so the
    # verdict can tell them apart.
    gc_stat = {"pauses": 0, "total_ms": 0.0, "max_ms": 0.0}
    gc_recent: List[tuple] = []  # (start_mono, end_mono, dur_ms)
    gc_t0 = {}

    def _gc_cb(phase, info):
        if phase == "start":
            gc_t0["t"] = time.perf_counter()
            return
        t = gc_t0.pop("t", None)
        if t is None:
            return
        dur_ms = (time.perf_counter() - t) * 1e3
        gc_stat["pauses"] += 1
        gc_stat["total_ms"] += dur_ms
        gc_stat["max_ms"] = max(gc_stat["max_ms"], dur_ms)
        end = time.monotonic()
        gc_recent.append((end - dur_ms / 1e3, end, dur_ms))
        if len(gc_recent) > 256:
            del gc_recent[:128]

    gc.callbacks.append(_gc_cb)
    t0 = time.monotonic()
    t0_ns = time.monotonic_ns()

    async def timed(i: int, sched_ns: int) -> None:
        nonlocal errors
        try:
            ok = await one(i, sched_ns)
        except Exception:  # noqa: BLE001 — an error is a sample, not an abort
            ok = False
        if ok:
            samples_ms.append((time.monotonic_ns() - sched_ns) / 1e6)
        else:
            errors += 1

    try:
        i, n = 0, len(offsets)
        while i < n:
            now = time.monotonic() - t0
            while i < n and offsets[i] <= now:
                sched_ns = t0_ns + int(offsets[i] * 1e9)
                # lateness of the FIRE vs the schedule: the generator's own
                # health — a saturated event loop shows up here, and the
                # latency sample already charges the lag to the system
                lag = (time.monotonic_ns() - sched_ns) / 1e6
                if lag > fire_lag_max:
                    fire_lag_max = lag
                    worst_lag_window = (t0 + offsets[i],
                                        time.monotonic())
                tasks.append(loop.create_task(timed(i, sched_ns)))
                i += 1
            if i < n:
                await asyncio.sleep(offsets[i] - (time.monotonic() - t0))
        fired_wall = time.monotonic() - t0
    finally:
        try:
            gc.callbacks.remove(_gc_cb)
        except ValueError:
            pass
    done, pending = await asyncio.wait(tasks, timeout=drain_timeout) \
        if tasks else (set(), set())
    for p in pending:
        p.cancel()
    if pending:
        await asyncio.gather(*pending, return_exceptions=True)
    wall = time.monotonic() - t0
    samples_ms.sort()

    def pctl(q: float) -> Optional[float]:
        if not samples_ms:
            return None
        return round(samples_ms[min(len(samples_ms) - 1,
                                    int(q * len(samples_ms)))], 3)

    # attribute the WORST fire lag: a GC pause overlapping the
    # [scheduled, fired] window makes the generator the culprit; otherwise
    # something else held the loop (a system callback, the scheduler)
    lag_cause = None
    if fire_lag_max > 0.0:
        w0, w1 = worst_lag_window
        overlapped = any(s <= w1 and e >= w0 for s, e, _d in gc_recent)
        lag_cause = "gc_pause" if overlapped else "event_loop_stall"

    return {
        "offered": n,
        "completed": len(samples_ms),
        "errors": errors,
        "unfinished": len(pending),
        "generator": {
            "gc_pauses": gc_stat["pauses"],
            "gc_pause_total_ms": round(gc_stat["total_ms"], 3),
            "gc_pause_max_ms": round(gc_stat["max_ms"], 3),
            "max_fire_lag_ms": round(fire_lag_max, 3),
            "max_fire_lag_cause": lag_cause,
        },
        "wall_s": round(wall, 3),
        "fired_wall_s": round(fired_wall, 3),
        "throughput_per_sec": (round(len(samples_ms) / wall, 1)
                               if wall else 0.0),
        "p50_ms": pctl(0.50),
        "p90_ms": pctl(0.90),
        "p99_ms": pctl(0.99),
        "mean_ms": (round(sum(samples_ms) / len(samples_ms), 3)
                    if samples_ms else None),
        "fire_lag_max_ms": round(fire_lag_max, 3),
        "samples_ms": samples_ms,
    }


def verdict(row: dict, p99_bound_ms: float = DEFAULT_P99_BOUND_MS) -> dict:
    """The sweep's step verdict with ATTRIBUTION: which checks failed, and
    — when the generator fell behind its own schedule — whether the
    generator's own GC (the open_loop self-check) or a loop stall caused
    it. A rung failed by generator stalls is a harness problem; one failed
    by p99/completions is the system's."""
    failed: List[str] = []
    total = row["completed"] + row["errors"] + row["unfinished"]
    if not row["completed"]:
        failed.append("no_completions")
    else:
        ratio = row["completed"] / max(1, total)
        if ratio < MIN_COMPLETION_RATIO:
            failed.append(f"completion_ratio {round(ratio, 3)} < "
                          f"{MIN_COMPLETION_RATIO}")
        if row["errors"] != 0:
            failed.append(f"errors {row['errors']}")
        if row["p99_ms"] is None or row["p99_ms"] > p99_bound_ms:
            failed.append(f"p99 {row['p99_ms']}ms > {p99_bound_ms}ms")
    if row["fire_lag_max_ms"] > MAX_FIRE_LAG_MS:
        gen = row.get("generator") or {}
        cause = gen.get("max_fire_lag_cause")
        failed.append(
            f"generator_fire_lag {row['fire_lag_max_ms']}ms"
            + (f" (cause: {cause}, gc_pauses: {gen.get('gc_pauses')}, "
               f"gc_max: {gen.get('gc_pause_max_ms')}ms)" if cause else ""))
    out = {"sustainable": not failed, "failed": failed}
    blame = "none"
    if failed:
        gen_only = all(f.startswith("generator_fire_lag") for f in failed)
        blame = "generator" if gen_only else "system"
    out["blames"] = blame
    return out


def sustainable(row: dict, p99_bound_ms: float = DEFAULT_P99_BOUND_MS) -> bool:
    """The sweep's step verdict: latency bounded, nothing lost, and the
    generator itself kept to its schedule (a lagging generator means the
    offered rate was not actually offered). `verdict()` is the explained
    variant; this stays the boolean every older call site uses."""
    return verdict(row, p99_bound_ms)["sustainable"]


# -- the balancer target ---------------------------------------------------

class _BalancerTarget:
    """A live TpuBalancer + echo-invoker fleet (tools/echo_fleet.py) with
    a publish-and-await-completion `one()` that anchors each activation's
    waterfall context at its SCHEDULED arrival — so the first stage delta
    carries the open-loop send lag and the per-stage budget telescopes to
    the same e2e the generator measures."""

    def __init__(self, n_invokers: int = 16, kernel: str = "auto",
                 waterfall: bool = True, prewarm: bool = False,
                 fleet_mesh: bool = False, stragglers=None, device=None):
        self.n_invokers = n_invokers
        self.kernel = kernel
        self.waterfall = waterfall
        self.prewarm = prewarm
        self.fleet_mesh = fleet_mesh
        self.stragglers = stragglers
        #: None = the CUDA card (raising without one), "cpu" = plain torch
        self.device = device
        self.stragglers_applied: dict = {}
        self.bal = None
        self._fleet_stop = None
        self._feeds = None
        self._actions = None
        self._ident = None
        self._publish = None

    async def start(self) -> None:
        from openwhisk_tpu_torch.controller.loadbalancer import TpuBalancer
        from openwhisk_tpu_torch.controller.loadbalancer.base import (
            HEALTHY, maybe_batch_publish)
        from openwhisk_tpu_torch.core.entity import ControllerInstanceId, Identity
        from openwhisk_tpu_torch.messaging import MemoryMessagingProvider
        from openwhisk_tpu_torch.tools import echo_fleet
        from openwhisk_tpu_torch.utils.waterfall import GLOBAL_WATERFALL

        GLOBAL_WATERFALL.enabled = self.waterfall
        GLOBAL_WATERFALL.reset()
        provider = MemoryMessagingProvider()
        # prewarm off by default: a background kernel build is pure GIL
        # contention inside a latency-measurement window
        self.bal = TpuBalancer(provider, ControllerInstanceId("0"),
                               managed_fraction=1.0, blackbox_fraction=0.0,
                               placement_kernel=self.kernel,
                               prewarm=self.prewarm,
                               fleet_mesh=self.fleet_mesh,
                               device=self.device)
        # batch-shaped publish: the generator rides the same
        # front-door coalescer the controller's invoke path uses, so the
        # headline measures the shipped publish SPI (None when the knob
        # is off — the serial publish path, bit-exact)
        self._publish = maybe_batch_publish(self.bal)
        await self.bal.start()
        self._feeds, self._fleet_stop = await echo_fleet._echo_fleet(
            provider, self.n_invokers)
        # straggler injection (the shared idiom): delay the indexed echo
        # feeds' acks — the run's numbers then carry the skew they came
        # from in the JSON line (`stragglers`)
        self.stragglers_applied = apply_stragglers(self._feeds,
                                                   self.stragglers)
        for _ in range(120):
            health = await self.bal.invoker_health()
            if sum(h.status == HEALTHY for h in health) >= self.n_invokers:
                break
            await asyncio.sleep(0.25)
        else:
            raise RuntimeError("loadgen: fleet never became healthy")
        self._actions = [echo_fleet._bench_action(f"ol{i}", memory=128)
                         for i in range(8)]
        self._ident = Identity.generate("guest")

    async def one(self, i: int, sched_ns: int) -> bool:
        from openwhisk_tpu_torch.core.entity import (ActivationId,
                                               ControllerInstanceId)
        from openwhisk_tpu_torch.messaging import ActivationMessage
        from openwhisk_tpu_torch.utils.transaction import TransactionId
        from openwhisk_tpu_torch.utils.waterfall import GLOBAL_WATERFALL
        action = self._actions[i % len(self._actions)]
        msg = ActivationMessage(
            TransactionId(), action.fully_qualified_name, action.rev.rev,
            self._ident, ActivationId.generate(), ControllerInstanceId("0"),
            True, {})
        aid = msg.activation_id.asString
        # anchor at the SCHEDULED arrival: the publish_enqueue delta then
        # carries the open-loop send lag (coordinated-omission-correct)
        GLOBAL_WATERFALL.begin(aid, t0_ns=sched_ns)
        try:
            if self._publish is not None:
                promise = await self._publish.publish(action, msg)
            else:
                promise = await self.bal.publish(action, msg)
            await promise
            return True
        except Exception:  # noqa: BLE001 — the row counts it as an error
            GLOBAL_WATERFALL.discard(aid)
            return False

    async def stop(self) -> None:
        if self._fleet_stop is not None:
            await self._fleet_stop()
        if self.bal is not None:
            await self.bal.close()
        if self._feeds:
            for f in self._feeds:
                await f.stop()


# -- the shared funnel deployment ------------------------------------------

FUNNEL_READY_PREFIX = "FUNNELREADY:"


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _FunnelTarget:
    """Worker-side target for the SHARED deployment (`--funnel H:P`):
    a `FunnelBalancer` front end forwarding each admission wave as ONE
    fence-stamped columnar frame over the TCP bus to the device-owning
    balancer process (`--serve-funnel`). Same `one()` contract as
    `_BalancerTarget`, but the placement/completion stages live in the
    OTHER process — so no waterfall anchor here (the worker measures the
    e2e the client sees; the balancer process owns the stage budget)."""

    def __init__(self, endpoint: str, worker_ident: Optional[int] = None):
        host, _, port = str(endpoint).rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        # origins 100+ keep the front-end instance ids clear of the
        # balancer's own controller id space
        self.origin = 100 + (worker_ident or 0)
        self.bal = None
        self._publish = None
        self._actions = None
        self._ident = None
        self.stragglers_applied: dict = {}

    async def start(self) -> None:
        from openwhisk_tpu_torch.controller.loadbalancer.base import \
            maybe_batch_publish
        from openwhisk_tpu_torch.controller.loadbalancer.funnel import \
            FunnelBalancer
        from openwhisk_tpu_torch.core.entity import ControllerInstanceId, Identity
        from openwhisk_tpu_torch.messaging.tcp import TcpMessagingProvider
        from openwhisk_tpu_torch.tools import echo_fleet

        from openwhisk_tpu_torch.utils.waterfall import GLOBAL_WATERFALL
        # the placement stages live in the balancer process: this
        # worker never stamps a waterfall, so keep the plane off here
        GLOBAL_WATERFALL.enabled = False
        provider = TcpMessagingProvider(self.host, self.port)
        self.bal = FunnelBalancer(provider,
                                  ControllerInstanceId(str(self.origin)),
                                  target=0)
        # the same front-door coalescer the controller's invoke path
        # uses: one API wave -> one publish_many -> one wire frame
        self._publish = maybe_batch_publish(self.bal)
        await self.bal.start()
        self._actions = [echo_fleet._bench_action(f"ol{i}", memory=128)
                         for i in range(8)]
        self._ident = Identity.generate("guest")

    async def one(self, i: int, sched_ns: int) -> bool:
        from openwhisk_tpu_torch.core.entity import (ActivationId,
                                               ControllerInstanceId)
        from openwhisk_tpu_torch.messaging import ActivationMessage
        from openwhisk_tpu_torch.utils.transaction import TransactionId
        action = self._actions[i % len(self._actions)]
        msg = ActivationMessage(
            TransactionId(), action.fully_qualified_name, action.rev.rev,
            self._ident, ActivationId.generate(), ControllerInstanceId("0"),
            True, {})
        try:
            if self._publish is not None:
                promise = await self._publish.publish(action, msg)
            else:
                promise = await self.bal.publish(action, msg)
            await promise
            return True
        except Exception:  # noqa: BLE001 — a 429/503 is an error sample
            return False

    async def stop(self) -> None:
        if self.bal is not None:
            await self.bal.close()


def serve_funnel(n_invokers: int = 16, kernel: str = "auto",
                 port: Optional[int] = None, device=None) -> None:
    """The balancer-role process of the shared deployment: boots the TCP
    bus broker on a free port, the ONE TpuBalancer owning the (simulated)
    device fleet, the echo-invoker fleet, and a `FunnelReceiver` draining
    `ctrlfunnel0`. Prints `FUNNELREADY:{"port": P}` once the fleet is
    healthy, then serves until stdin closes (the parent's shutdown
    signal) or SIGTERM. `device`: None = the CUDA card, "cpu" = the
    plain torch path."""

    async def go() -> None:
        import signal
        import threading
        from openwhisk_tpu_torch.controller.loadbalancer import TpuBalancer
        from openwhisk_tpu_torch.controller.loadbalancer.base import HEALTHY
        from openwhisk_tpu_torch.controller.loadbalancer.funnel import \
            FunnelReceiver
        from openwhisk_tpu_torch.core.entity import ControllerInstanceId
        from openwhisk_tpu_torch.messaging.tcp import (TcpBusServer,
                                                 TcpMessagingProvider)
        from openwhisk_tpu_torch.tools import echo_fleet

        p = port or _free_port()
        server = TcpBusServer("127.0.0.1", p)
        await server.start()
        provider = TcpMessagingProvider("127.0.0.1", p)
        bal = TpuBalancer(provider, ControllerInstanceId("0"),
                          managed_fraction=1.0, blackbox_fraction=0.0,
                          placement_kernel=kernel, prewarm=False,
                          device=device)
        await bal.start()
        feeds, fleet_stop = await echo_fleet._echo_fleet(provider, n_invokers)
        for _ in range(120):
            health = await bal.invoker_health()
            if sum(h.status == HEALTHY for h in health) >= n_invokers:
                break
            await asyncio.sleep(0.25)
        else:
            raise RuntimeError("serve-funnel: fleet never became healthy")
        # no entity store in the harness: resolve the workers' fixed
        # action set from a dict (same 8 actions every worker mints)
        by_name = {}
        for i in range(8):
            a = echo_fleet._bench_action(f"ol{i}", memory=128)
            by_name[str(a.fully_qualified_name)] = a

        async def resolver(name: str, rev: str):
            return by_name[name]

        recv = FunnelReceiver(provider, ControllerInstanceId("0"), bal,
                              resolver=resolver)
        recv.start()
        print(FUNNEL_READY_PREFIX + json.dumps({"port": p}), flush=True)

        stop_ev = asyncio.Event()
        loop = asyncio.get_event_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop_ev.set)

        def watch_stdin() -> None:
            try:
                sys.stdin.read()
            except Exception:  # noqa: BLE001 — EOF either way
                pass
            loop.call_soon_threadsafe(stop_ev.set)

        threading.Thread(target=watch_stdin, daemon=True).start()
        await stop_ev.wait()
        await recv.stop()
        await fleet_stop()
        for f in feeds:
            await f.stop()
        await bal.close()
        await server.stop()

    asyncio.run(go())


async def _measure_step(target: _BalancerTarget, rate: float,
                        duration: float, dist: str, seed: int,
                        reset_waterfall: bool = True,
                        keep_samples: bool = False) -> dict:
    from openwhisk_tpu_torch.utils.waterfall import GLOBAL_WATERFALL
    if reset_waterfall and GLOBAL_WATERFALL.enabled:
        GLOBAL_WATERFALL.reset()
    n = max(1, int(rate * duration))
    offsets = make_schedule(rate, n, dist=dist, seed=seed)
    row = await open_loop(target.one, offsets)
    samples = row.pop("samples_ms")
    if keep_samples:
        # the multi-process merge needs the raw samples (rounded): merged
        # percentiles must come from the union, not from per-worker
        # quantiles (which do not compose)
        row["samples_ms"] = [round(s, 3) for s in samples]
    row["offered_rate"] = rate
    return row


def sweep_balancer(rate0: float = 32.0, duration: float = 2.5,
                   max_doublings: int = 8,
                   p99_bound_ms: float = DEFAULT_P99_BOUND_MS,
                   dist: str = "poisson", n_invokers: int = 16,
                   kernel: str = "auto", waterfall: bool = True,
                   fixed_rate: Optional[float] = None, seed: int = 1,
                   host_observatory: Optional[bool] = None,
                   gc_tune: bool = True, fleet_mesh: bool = False,
                   keep_samples: bool = False,
                   worker_ident: Optional[int] = None,
                   stragglers=None, trace_keep_all: bool = False,
                   trace_export: Optional[str] = None,
                   funnel: Optional[str] = None, device=None) -> dict:
    """The observatory: sweep offered rate (doubling from `rate0`) to the
    max sustainable throughput, then re-measure that rate for the headline
    row + the waterfall's per-stage budget. `fixed_rate` skips the sweep
    and measures one rate. Returns the `e2e_open_loop` block.

    `host_observatory`: True arms the host hot-loop observatory
    (utils/hostprof.py) on the generator/balancer loop for the run and
    attaches its snapshot as `host` — the bench riders' measured target
    list; False forces it (and its always-on serde accounting) off for the
    overhead rider's OFF half; None (default) leaves the process-global
    state alone.

    `device`: where the target balancer places — None (the CUDA card,
    raising without one) or "cpu" (the plain torch path); reported as
    `device` in the block.

    `gc_tune` (default True, reported as `gc_tuned` in the block): after
    the target boots, freeze the permanent heap out of the collector and
    raise the GC thresholds (utils/hostprof.py tune_gc) — the same knob a
    production controller gets via CONFIG_whisk_host_gc_enabled. Without
    it, CPython's default full-heap gen-2 collections stall the loop
    100-250 ms mid-window and the fire-lag verdict blames the generator;
    the open_loop GC self-check still measures and reports whatever
    pauses remain, so the tuning is a measured choice, not a blind one."""

    async def go() -> dict:
        from openwhisk_tpu_torch.utils.hostprof import GLOBAL_HOST_OBSERVATORY
        from openwhisk_tpu_torch.utils.waterfall import GLOBAL_WATERFALL
        if worker_ident is not None:
            # --procs worker: stamp the fleet-observatory identity block so
            # the parent's merged snapshot carries per-member provenance
            from openwhisk_tpu_torch.utils.eventlog import set_identity
            set_identity(instance=worker_ident, role="loadgen")
        obs_installed = False
        if host_observatory is not None:
            GLOBAL_HOST_OBSERVATORY.enabled = bool(host_observatory)
            if host_observatory:
                GLOBAL_HOST_OBSERVATORY.reset()
                obs_installed = GLOBAL_HOST_OBSERVATORY.install()
        # trace observatory riders: `--trace-keep-all` forces
        # the tail-sampling floor to 1.0 (every completion keeps) and
        # widens the kept ring to hold a whole run; `--trace-export`
        # dumps the kept traces as NDJSON after the run. Both arm the
        # plane BEFORE the balancer boots (the balancer hook attaches the
        # reporter tee at construction).
        trace_armed = bool(trace_keep_all or trace_export)
        if trace_armed:
            import dataclasses
            from openwhisk_tpu_torch.utils.tracestore import GLOBAL_TRACE_STORE
            GLOBAL_TRACE_STORE.enabled = True
            if trace_keep_all:
                GLOBAL_TRACE_STORE.config = dataclasses.replace(
                    GLOBAL_TRACE_STORE.config, keep_floor=1.0,
                    keep_ring=65536)
                GLOBAL_TRACE_STORE._floor_every = 1
            GLOBAL_TRACE_STORE.reset()
        if funnel:
            # shared deployment worker: the system under test lives in
            # the --serve-funnel process; this process is front end only
            target = _FunnelTarget(funnel, worker_ident)
        else:
            target = _BalancerTarget(n_invokers=n_invokers, kernel=kernel,
                                     waterfall=waterfall,
                                     fleet_mesh=fleet_mesh,
                                     stragglers=stragglers, device=device)
        await target.start()
        gc_tuned = None
        if gc_tune:
            from openwhisk_tpu_torch.utils.hostprof import tune_gc
            gc_tuned = tune_gc(force=True)
        try:
            # warm long enough to actually FINISH the first-sight compiles
            # a rate's batch/release buckets trigger (the coalescing
            # forms bigger micro-batches, so a rate now exercises more
            # bucket shapes than the eager path did — a short warm leaked
            # those compiles into the measured window, where a ~1 s stall
            # reads exactly like saturation)
            warm_t = max(1.0, duration / 2)

            ladder_done = False

            async def warm(rate: float, passes: int = 1) -> None:
                # per-rate warmup: a higher rate fills bigger micro-batch
                # buckets whose fused program pays a first-sight cost —
                # inside a measured window that compile stall would read as
                # a (false) saturation verdict
                nonlocal ladder_done
                if not ladder_done:
                    ladder_done = True
                    # deterministic bucket-ladder warm, ONCE: a saturating
                    # rate warm jumps straight to the biggest (R, B)
                    # bucket, so the middle power-of-two shapes (a
                    # draining tail passes through 64, 128...) would
                    # first-sight-compile INSIDE a measured window. One
                    # same-sweep burst per bucket touches each fused +
                    # release-only program here instead (~6 shapes total
                    # under the shared-bucket rule).
                    cap = getattr(target.bal, "max_batch", 256)
                    k = 8
                    while k <= cap:
                        await open_loop(target.one, [0.0] * k,
                                        drain_timeout=30.0)
                        k *= 2
                for p in range(passes):
                    await _measure_step(target, rate, warm_t, dist,
                                        seed + 97 + p)

            def judge(r: dict) -> bool:
                r["verdict"] = verdict(r, p99_bound_ms)
                r["sustainable"] = r["verdict"]["sustainable"]
                return r["sustainable"]

            steps = []
            swept_ok = False
            if fixed_rate is not None:
                sustained_rate = fixed_rate
                # no ramp precedes a fixed-rate run, so it must absorb ALL
                # its bucket compiles here — two full passes
                await warm(fixed_rate, passes=2)
            else:
                rate, sustained_rate = rate0, None
                for _ in range(max_doublings):
                    await warm(rate)
                    row = await _measure_step(target, rate, duration, dist,
                                              seed)
                    judge(row)
                    if not row["sustainable"]:
                        # one retry: a first-sight bucket-shape compile is
                        # a ONE-TIME stall that reads exactly like
                        # saturation (fire lag + a p99 spike); genuine
                        # saturation fails the retry too
                        retry = await _measure_step(target, rate, duration,
                                                    dist, seed + 31)
                        judge(retry)
                        retry["retried"] = True
                        if retry["sustainable"]:
                            row = retry
                        else:
                            steps.append(row)
                            row = retry
                    steps.append(row)
                    if not row["sustainable"]:
                        break
                    sustained_rate = rate
                    rate *= 2
                swept_ok = sustained_rate is not None
                if sustained_rate is None:
                    # even rate0 failed: measure it anyway so the block
                    # still carries numbers — but say so (sustained=false)
                    sustained_rate = rate0
            # confirmation run at the sustained rate: its percentiles and
            # per-stage budget are the headline (the sweep rows above only
            # bracketed it) — re-judged, so the top-level `sustained` flag
            # never launders an unsustainable rate into a headline
            if obs_installed:
                # scope the host observatory to the HEADLINE window:
                # warmup's first-sight costs would otherwise own
                # the lag histogram and the self-time census
                GLOBAL_HOST_OBSERVATORY.reset()
            head = await _measure_step(target, sustained_rate, duration,
                                       dist, seed + 1,
                                       keep_samples=keep_samples)
            judge(head)
            if not head["sustainable"]:
                # same one-retry rule as the sweep steps: a stray stall
                # (GC, background compile) must not flip the headline
                if obs_installed:
                    # the snapshot scopes to the REPORTED window: without
                    # this, a retry leaves the failed attempt's tasks in
                    # the counters while `completed` counts only the
                    # retry — tasks/activation read ~2x
                    GLOBAL_HOST_OBSERVATORY.reset()
                head = await _measure_step(target, sustained_rate, duration,
                                           dist, seed + 61,
                                           keep_samples=keep_samples)
                judge(head)
                head["retried"] = True
            # a borderline TOP rung that passed the sweep once but fails
            # its confirmation must not wipe the whole headline: fall back
            # one rung at a time and confirm there (recorded — the
            # reported rate is then genuinely sustained, just lower)
            fb_seed = 211
            while (not head["sustainable"] and fixed_rate is None
                   and sustained_rate / 2 >= rate0):
                sustained_rate /= 2
                if obs_installed:
                    GLOBAL_HOST_OBSERVATORY.reset()
                head = await _measure_step(target, sustained_rate, duration,
                                           dist, seed + fb_seed,
                                           keep_samples=keep_samples)
                judge(head)
                if not head["sustainable"]:
                    if obs_installed:
                        GLOBAL_HOST_OBSERVATORY.reset()
                    head = await _measure_step(target, sustained_rate,
                                               duration, dist,
                                               seed + fb_seed + 17,
                                               keep_samples=keep_samples)
                    judge(head)
                    head["retried"] = True
                head["fell_back"] = True
                fb_seed += 41
            budget = (GLOBAL_WATERFALL.budget() if GLOBAL_WATERFALL.enabled
                      else None)
            tail = (GLOBAL_WATERFALL.tail_attribution()
                    if GLOBAL_WATERFALL.enabled else None)
            if budget and head["p50_ms"] and \
                    budget.get("p50_decomposition_sum_ms") is not None:
                # the EXTERNAL accounting check: the waterfall's stage
                # budget vs the generator's own independently measured
                # e2e median (both anchored at scheduled arrival) — this
                # crosses instrumentation boundaries, so ~1 here means
                # the per-stage budget really explains the measured e2e
                budget["budget_vs_measured_p50"] = round(
                    budget["p50_decomposition_sum_ms"] / head["p50_ms"], 3)
            host = (GLOBAL_HOST_OBSERVATORY.snapshot() if obs_installed
                    else None)
            # exact-merge export for the --procs parent: raw
            # integer bucket counts merge bucket-wise bit-exactly; the
            # rendered snapshot's percentiles do not compose
            host_raw = (GLOBAL_HOST_OBSERVATORY.raw_counts()
                        if obs_installed and worker_ident is not None
                        else None)
            trace_stats = None
            traces_exported = None
            if trace_armed:
                from openwhisk_tpu_torch.utils.tracestore import (
                    GLOBAL_TRACE_STORE, assemble_trace)
                trace_stats = GLOBAL_TRACE_STORE.stats()
                if trace_export:
                    # NDJSON: one assembled trace tree per kept entry —
                    # the one-JSON-line stdout contract stays untouched
                    n_exp = 0
                    with open(trace_export, "w") as f:
                        for e in GLOBAL_TRACE_STORE.entries():
                            f.write(json.dumps(assemble_trace(
                                e.get("trace_id") or "", [e])) + "\n")
                            n_exp += 1
                    traces_exported = n_exp
            return {
                "mode": "open_loop",
                "funnel_endpoint": funnel,
                "dist": dist,
                "gc_tuned": gc_tuned,
                "stragglers": {str(k): v for k, v
                               in target.stragglers_applied.items()},
                "fleet_mesh": bool(fleet_mesh),
                "fleet_shards": getattr(target.bal, "n_shards", 1),
                "device": getattr(getattr(target.bal, "device", None),
                                  "type", None),
                "sustained": bool(head["sustainable"]
                                  and (fixed_rate is not None or swept_ok)),
                "sustained_activations_per_sec": head["throughput_per_sec"],
                "sustained_offered_rate": sustained_rate,
                "p50_ms": head["p50_ms"],
                "p99_ms": head["p99_ms"],
                "p99_bound_ms": p99_bound_ms,
                "latency_base": "scheduled_arrival",
                "headline": head,
                "sweep": steps,
                "stage_budget": budget,
                "tail_attribution": tail,
                "host": host,
                "host_raw": host_raw,
                "n_invokers": n_invokers,
                "trace_keep_all": bool(trace_keep_all),
                "trace_export": trace_export,
                "traces_exported": traces_exported,
                "trace_stats": trace_stats,
            }
        finally:
            await target.stop()
            if obs_installed:
                GLOBAL_HOST_OBSERVATORY.uninstall()

    return asyncio.run(go())


def multiproc_fixed_rate(rate: float, procs: int, duration: float = 2.5,
                         p99_bound_ms: float = DEFAULT_P99_BOUND_MS,
                         dist: str = "poisson", n_invokers: int = 16,
                         kernel: str = "auto", seed: int = 1,
                         fleet_mesh: bool = False, gc_tune: bool = True,
                         waterfall: bool = True,
                         host_observatory: bool = False,
                         timeout_s: float = 600.0,
                         shared: bool = False, device=None) -> dict:
    """`--procs N`: the multi-process generator (the "keep the verdict
    honest" note). At 4k+ offered/s ONE Python generator loop
    is itself a measurable fraction of the box: its task churn and GC
    share the core with the system under test, and fire-lag verdicts
    start blaming the harness. This mode forks N worker generators, each
    firing an INDEPENDENT Poisson schedule at rate/N (independent Poisson
    processes superpose to a Poisson process at the full rate, so the
    offered process is exactly the single-generator one), and merges the
    per-worker SAMPLES into the headline percentiles — merged from the
    union, because quantiles do not compose across workers. Each worker
    keeps its own open_loop self-check, so a failed verdict still blames
    the specific worker (gc_pause vs event_loop_stall) instead of the
    fleet.

    Honesty note, by design (`topology: "twins"`): each worker drives
    its OWN balancer + echo fleet twin (the in-process publish entry
    point cannot be shared across processes). The merged number is
    therefore N generator-honest twins at rate/N each, the right verdict
    when the question is "is the GENERATOR the bottleneck", and says so
    in `targets`.

    `shared=True` (`topology: "shared"`) removes that caveat:
    ONE `--serve-funnel` balancer process owns the device fleet, and the
    N workers are front-end processes forwarding their admission waves
    over the TCP bus funnel. The merged-schedule sustained rate is then
    the SYSTEM-under-test headline — one shared balancer really placed
    every row — which is exactly the number the twins mode must not
    claim. Every process started gets `--device` (None = the CUDA card):
    the funnel process and twin workers place there, funnel workers hold
    no device."""
    import subprocess

    procs = max(1, int(procs))
    share = rate / procs
    serve = None
    funnel_endpoint = None
    balancer_note = None
    serve_err = None
    if shared:
        import tempfile
        serve_cmd = [sys.executable, "-m", "openwhisk_tpu_torch.tools.loadgen",
                     "--serve-funnel", "--invokers", str(n_invokers),
                     "--kernel", kernel, "--device", device or "cuda"]
        # stderr to a spool file: the balancer process outlives the
        # workers and logs freely — a PIPE would fill and wedge it
        serve_err = tempfile.TemporaryFile(mode="w+")
        serve = subprocess.Popen(serve_cmd, stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE,
                                 stderr=serve_err, text=True)
        ready_by = time.monotonic() + 120.0
        while time.monotonic() < ready_by:
            line = serve.stdout.readline()
            if not line:
                break  # balancer process died before becoming ready
            if line.startswith(FUNNEL_READY_PREFIX):
                p = json.loads(line[len(FUNNEL_READY_PREFIX):])["port"]
                funnel_endpoint = f"127.0.0.1:{p}"
                break
        if funnel_endpoint is None:
            serve.kill()
            try:
                serve.wait(timeout=10.0)
            except Exception:  # noqa: BLE001 — diagnostics only
                pass
            serve_err.seek(0)
            err = serve_err.read()
            serve_err.close()
            raise RuntimeError(
                "shared deployment: balancer process never became ready"
                + (f"; stderr tail: {err[-400:]}" if err else ""))
    try:
        workers = []
        for i in range(procs):
            cmd = [sys.executable, "-m", "openwhisk_tpu_torch.tools.loadgen",
                   "--rate", str(share), "--duration", str(duration),
                   "--dist", dist, "--invokers", str(n_invokers),
                   "--kernel", kernel, "--seed",
                   str(seed + 1009 * (i + 1)),
                   "--p99-bound-ms", str(p99_bound_ms), "--emit-samples",
                   "--device", device or "cuda"]
            if shared:
                # funnel worker: front end only — the waterfall stages
                # live in the balancer process, and the worker ident
                # keys its funnel origin instance
                cmd += ["--funnel", funnel_endpoint, "--no-waterfall",
                        "--worker-ident", str(i)]
            if fleet_mesh:
                cmd.append("--fleet-mesh")
            if not gc_tune:
                cmd.append("--no-gc-tune")
            if not waterfall and not shared:
                cmd.append("--no-waterfall")
            if host_observatory:
                # each worker stamps its fleet identity and emits raw
                # integer bucket counts; the parent merges them into ONE
                # fleet snapshot instead of N per-worker blobs
                cmd.append("--host-observatory")
                if not shared:
                    cmd += ["--worker-ident", str(i)]
            workers.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
        rows: List[Optional[dict]] = []
        stderr_tails: List[Optional[str]] = []
        # one shared deadline for the whole fleet: the workers run
        # CONCURRENTLY, so the sequential reap hands each communicate() the
        # time REMAINING, not a fresh full budget (procs wedged workers must
        # cost ~timeout_s total, not procs * timeout_s)
        deadline = time.monotonic() + timeout_s
        for p in workers:
            try:
                out, err = p.communicate(
                    timeout=max(0.0, deadline - time.monotonic()))
                row = None
                for line in reversed(out.splitlines()):
                    line = line.strip()
                    if line.startswith("{"):
                        try:
                            row = json.loads(line)
                        except ValueError:
                            # a partial flush from a dying worker (or a
                            # '{'-prefixed log line) must not crash the
                            # parent and discard every OTHER worker's row
                            continue
                        break
                rows.append(row)
                # keep a diagnostic tail so a dead worker's traceback (or its
                # own error-fallback JSON) survives into the per_worker row
                stderr_tails.append(err[-500:] if err else None)
            except subprocess.TimeoutExpired:
                p.kill()
                # reap the killed child (no zombie, no Popen ResourceWarning)
                # and drain its pipes so partial diagnostics survive
                try:
                    _out, err = p.communicate(timeout=10.0)
                except Exception:  # noqa: BLE001 — diagnostics only
                    err = ""
                rows.append(None)
                tail = f"worker timed out after {timeout_s:.0f}s"
                if err:
                    tail += f"; stderr tail: {err[-400:]}"
                stderr_tails.append(tail)
    finally:
        if serve is not None:
            # shutdown signal is stdin EOF; fall back to kill on a wedge
            try:
                serve.stdin.close()
            except Exception:  # noqa: BLE001
                pass
            try:
                serve.wait(timeout=30.0)
            except Exception:  # noqa: BLE001 — includes TimeoutExpired
                serve.kill()
                try:
                    serve.wait(timeout=10.0)
                except Exception:  # noqa: BLE001
                    pass
            err = ""
            try:
                serve_err.seek(0)
                err = serve_err.read()
                serve_err.close()
            except Exception:  # noqa: BLE001 — diagnostics only
                pass
            balancer_note = err[-500:] if err else None
    ok_rows = [r for r in rows if r and (r.get("headline") or {})]
    samples = sorted(s for r in ok_rows
                     for s in (r.get("headline") or {}).get("samples_ms")
                     or [])

    def pctl(q: float) -> Optional[float]:
        if not samples:
            return None
        return round(samples[min(len(samples) - 1, int(q * len(samples)))],
                     3)

    per_worker = []
    for i, r in enumerate(rows):
        if r is None or r.get("error"):
            row = {"worker": i,
                   "error": (r or {}).get("error") or "no JSON line "
                   "(crashed or timed out)"}
            if stderr_tails[i]:
                row["stderr_tail"] = stderr_tails[i]
            per_worker.append(row)
            continue
        head = r.get("headline") or {}
        gen = head.get("generator") or {}
        row = {
            "worker": i,
            "offered_rate": share,
            "sustained": r.get("sustained"),
            "throughput_per_sec": head.get("throughput_per_sec"),
            "p99_ms": head.get("p99_ms"),
            "verdict": head.get("verdict"),
            "blames": (head.get("verdict") or {}).get("blames"),
            "max_fire_lag_ms": gen.get("max_fire_lag_ms"),
            "gc_pauses": gen.get("gc_pauses"),
        }
        per_worker.append(row)
    # ONE fleet-merged host snapshot: the workers export raw
    # integer bucket counts (host_raw), which merge bucket-wise
    # bit-exactly — the federation's merge math, reused verbatim —
    # replacing the N per-worker blobs this mode used to emit
    host_fleet = None
    if host_observatory:
        host_raws = [r.get("host_raw") for r in ok_rows
                     if r.get("host_raw")]
        if host_raws:
            from openwhisk_tpu_torch.controller.monitoring import \
                merged_host_report
            host_fleet = merged_host_report(host_raws)
    merged_p99 = pctl(0.99)
    all_sustained = (len(ok_rows) == procs
                     and all(r.get("sustained") for r in ok_rows))
    fleet_sustained_per_sec = round(
        sum(w.get("throughput_per_sec") or 0.0
            for w in per_worker if "error" not in w), 1)
    if shared:
        targets = ("one shared balancer+fleet process behind the " +
                   str(procs) + "-worker admission funnel; the merged-"
                   "schedule sustained rate IS the system-under-test "
                   "headline")
    else:
        targets = ("one balancer+fleet twin per worker (generator-"
                   "honesty mode; the single-process headline remains "
                   "the system-under-test number)")
    return {
        "mode": "open_loop_multiproc",
        "topology": "shared" if shared else "twins",
        "procs": procs,
        "dist": dist,
        "offered_rate": rate,
        "per_worker_rate": share,
        "targets": targets,
        "funnel_endpoint": funnel_endpoint,
        "balancer_stderr_tail": balancer_note,
        "sustained": bool(all_sustained
                          and merged_p99 is not None
                          and merged_p99 <= p99_bound_ms),
        "sustained_activations_per_sec": fleet_sustained_per_sec,
        "fleet_merged_sustained_per_sec": fleet_sustained_per_sec,
        "completed": len(samples),
        "p50_ms": pctl(0.50),
        "p90_ms": pctl(0.90),
        "p99_ms": merged_p99,
        "p99_bound_ms": p99_bound_ms,
        "latency_base": "scheduled_arrival",
        "host_fleet": host_fleet,
        "per_worker": per_worker,
    }


def main() -> Optional[int]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rate0", type=float, default=32.0,
                    help="sweep starting offered rate (doubles upward)")
    ap.add_argument("--rate", type=float, default=None,
                    help="skip the sweep: measure this fixed rate")
    ap.add_argument("--duration", type=float, default=2.5,
                    help="seconds per measured step")
    ap.add_argument("--dist", choices=("poisson", "constant"),
                    default="poisson")
    ap.add_argument("--p99-bound-ms", type=float,
                    default=DEFAULT_P99_BOUND_MS)
    ap.add_argument("--invokers", type=int, default=16)
    ap.add_argument("--kernel", choices=("auto", "scan", "repair"),
                    default="auto",
                    help="the target balancer's placement kernel")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the target balancer places: the CUDA card "
                         "(default) or the plain torch path on the CPU")
    ap.add_argument("--no-waterfall", action="store_true")
    ap.add_argument("--host-observatory", action="store_true",
                    help="arm the host hot-loop observatory "
                         "(utils/hostprof.py) for the run and attach its "
                         "snapshot as `host` in the JSON line")
    ap.add_argument("--no-gc-tune", action="store_true",
                    help="skip the harness GC tuning (freeze + raised "
                         "thresholds); default is tuned, reported in "
                         "`gc_tuned`")
    ap.add_argument("--serve-funnel", action="store_true",
                    help="run the SHARED deployment's balancer-role "
                         "process: TCP bus broker + the one device-"
                         "owning balancer + echo fleet + FunnelReceiver; "
                         "prints FUNNELREADY:{\"port\": P} when healthy "
                         "and serves until stdin closes")
    ap.add_argument("--serve-port", type=int, default=None,
                    help="fixed port for --serve-funnel (default: pick "
                         "a free one)")
    ap.add_argument("--funnel", default=None, metavar="HOST:PORT",
                    help="worker mode for the shared deployment: drive a "
                         "FunnelBalancer front end against the "
                         "--serve-funnel process at HOST:PORT instead of "
                         "an in-process balancer twin")
    ap.add_argument("--shared", action="store_true",
                    help="with --procs N: ONE shared balancer process "
                         "(auto-spawned --serve-funnel) fed by N funnel "
                         "front-end workers — topology 'shared' — "
                         "instead of N independent balancer twins")
    ap.add_argument("--procs", type=int, default=1,
                    help="fork N worker generators with partitioned "
                         "Poisson schedules at rate/N each and merge the "
                         "per-worker sample sets (requires --rate; keeps "
                         "generator churn off the verdict at 4k+/s)")
    ap.add_argument("--seed", type=int, default=1,
                    help="schedule seed (workers get derived seeds)")
    ap.add_argument("--emit-samples", action="store_true",
                    help="keep the headline run's raw latency samples in "
                         "the JSON line (the --procs parent merges them)")
    ap.add_argument("--worker-ident", type=int, default=None,
                    help="(set by the --procs parent) this worker's fleet "
                         "identity instance; stamps identity blocks and "
                         "emits host_raw for the parent's exact merge")
    ap.add_argument("--stragglers", default=None,
                    help="inject ack-delay stragglers into the echo fleet: "
                         "'IDX:DELAY_S[,IDX:DELAY_S...]' (bare IDX = "
                         "0.25 s); the applied map is reported in the "
                         "JSON line")
    ap.add_argument("--trace-keep-all", action="store_true",
                    help="force the trace observatory's tail-sampling "
                         "floor to 1.0 for the run: every completion "
                         "keeps its trace (widens the kept ring to hold "
                         "the whole run)")
    ap.add_argument("--trace-export", default=None, metavar="PATH",
                    help="after the run, dump the kept traces as NDJSON "
                         "(one assembled span tree per line) to PATH; "
                         "stdout keeps its one-JSON-line contract")
    ap.add_argument("--fleet-mesh", action="store_true",
                    help="run the target balancer in fleet-mesh mode "
                         "(CONFIG_whisk_loadBalancer_fleetMesh semantics; "
                         "shard count = visible devices pow2-floored)")
    args = ap.parse_args()
    # "cuda" is the default: None, which raises without a card
    device = None if args.device == "cuda" else args.device
    if args.serve_funnel:
        # the balancer-role process never prints a JSON verdict line —
        # its contract is the FUNNELREADY line + serving until EOF
        serve_funnel(n_invokers=args.invokers, kernel=args.kernel,
                     port=args.serve_port, device=device)
        return
    try:
        if args.procs > 1 or args.shared:
            if args.rate is None:
                ap.error("--procs/--shared requires --rate (fixed-rate "
                         "measurement; sweeps stay single-process)")
            if args.stragglers:
                ap.error("--stragglers is single-process only (each "
                         "--procs worker drives its own fleet twin, so "
                         "a shared straggler index is meaningless)")
            if args.trace_keep_all or args.trace_export:
                ap.error("--trace-keep-all/--trace-export are "
                         "single-process only (each worker's store is "
                         "its own; export from a single-process run)")
            out = multiproc_fixed_rate(
                rate=args.rate, procs=args.procs, duration=args.duration,
                p99_bound_ms=args.p99_bound_ms, dist=args.dist,
                n_invokers=args.invokers, kernel=args.kernel,
                seed=args.seed, fleet_mesh=args.fleet_mesh,
                gc_tune=not args.no_gc_tune,
                waterfall=not args.no_waterfall,
                host_observatory=args.host_observatory,
                shared=args.shared, device=device)
        else:
            out = sweep_balancer(rate0=args.rate0, duration=args.duration,
                                 p99_bound_ms=args.p99_bound_ms,
                                 dist=args.dist,
                                 n_invokers=args.invokers,
                                 kernel=args.kernel,
                                 waterfall=not args.no_waterfall,
                                 fixed_rate=args.rate, seed=args.seed,
                                 host_observatory=(True
                                                   if args.host_observatory
                                                   else None),
                                 gc_tune=not args.no_gc_tune,
                                 fleet_mesh=args.fleet_mesh,
                                 keep_samples=args.emit_samples,
                                 worker_ident=args.worker_ident,
                                 stragglers=args.stragglers,
                                 trace_keep_all=args.trace_keep_all,
                                 trace_export=args.trace_export,
                                 funnel=args.funnel, device=device)
    except Exception as e:  # noqa: BLE001 — one parseable line, always
        import traceback
        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"mode": "open_loop", "error": f"{type(e).__name__}: {e}",
                          "sustained_activations_per_sec": None}))
        return 1
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
