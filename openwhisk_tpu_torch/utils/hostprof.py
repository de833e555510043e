"""Host hot-loop observatory: where the CONTROLLER'S OWN wall-time goes.
A copy of `openwhisk_tpu/utils/hostprof.py`.

Every profiling plane so far watches the device (the KernelProfiler) or
the stage boundaries (the waterfall). The next order
of magnitude is blocked by per-activation *Python* — dict-shaped message
construction, JSON serde per hop, asyncio task churn, single-threaded
fan-in — none of which those planes can see. This module is the host-side
equivalent: a per-process `HostObservatory` with four always-on planes plus
a bounded capture plane, all within a <5% overhead budget (the
`host_profiling_overhead` bench rider gates it):

  1. EVENT-LOOP LAG — a self-rescheduling `loop.call_at` probe measures
     each tick against its SCHEDULED deadline (Tene's coordinated-omission
     rule, PAPERS.md: lag from schedule, never from the previous tick; a
     stall backfills one sample per missed tick) into log2-us histograms,
     plus a slow-callback interposer: a task-factory wrapper times every
     coroutine resumption and files steps over `stallThresholdMs` into a
     SeqRingBuffer of worst offenders, named by coroutine + task.
  2. GC PAUSES — `gc.callbacks` accounting: per-generation pause
     histograms, collected/uncollectable counters, and a
     pause-overlapping-a-dispatch counter (the balancer brackets its
     device dispatch with begin_dispatch/end_dispatch) so a GC pause that
     lands inside `device_dispatch` is attributed, not mysterious.
  3. TASK CHURN + SERDE COST — tasks created/finished/active gauges from
     the same task factory, and byte+wall-time counters per
     serialize/deserialize hop (messaging/connector.py's
     encode_message/decode_message helpers feed them, labeled
     {hop,direction}) so "JSON is X% of the loop at 1k/s" is a measured
     number.
  4. SAMPLING PROFILER — a background daemon thread over
     `sys._current_frames()` (no setitimer: it must coexist with the
     journal writer and prewarm drainer threads, so it samples ONLY the
     registered event-loop thread) folding stacks into a self-time census
     (ranked top-N) and a collapsed-stack (flamegraph-format) dump;
     `capture(seconds)` arms a bounded full-rate window.

Exposition (register_renderer on the installing process's MetricEmitter):
`openwhisk_host_event_loop_lag_seconds`,
`openwhisk_host_gc_pause_seconds{generation}`, `openwhisk_host_tasks_*`,
`openwhisk_host_serde_{seconds,bytes}_total{hop,direction}`. Read side:
auth-gated `GET /admin/profile/host` (snapshot) and
`POST /admin/profile/host/capture` (bounded capture window), following the
kernel profiler's capture-plane pattern.

Off switch: `CONFIG_whisk_hostProfiling_enabled=false` is a TRUE no-op —
install() refuses (no task factory swap, no gc callbacks, no sampler
thread) and the serde helpers fall straight through without touching a
clock (tracemalloc-asserted in tests/test_hostprof.py).

Design notes: one process-global instance (GLOBAL_HOST_OBSERVATORY, the
GLOBAL_WATERFALL pattern) because the planes span layers that never share
a balancer reference; hot-path folds are single GIL-atomic increments
under one uncontended lock; the probe/factory/sampler only exist after an
explicit install() (Controller.start, the invoker main, or a bench
harness), so library use of this package never grows background machinery.
"""
from __future__ import annotations

import asyncio
import gc
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .config import load_config
from .eventlog import identity
from .ring_buffer import SeqRingBuffer
from .waterfall import bucket_bounds_ms, bucket_of_us

#: full-rate sampling during an armed capture window (the always-on rate
#: is `sampleHz`); bounded by captureLimitS so a capture can never become
#: a standing tax
CAPTURE_HZ = 241.0
#: distinct leaf frames / collapsed stacks kept before folding into the
#: overflow key (bounds sampler memory on pathological stack diversity)
MAX_CENSUS_KEYS = 1024
MAX_COLLAPSED_KEYS = 4096
MAX_STACK_DEPTH = 48
_OVERFLOW_KEY = "<overflow>"


@dataclass(frozen=True)
class HostProfilingConfig:
    """`CONFIG_whisk_hostProfiling_*` env overrides."""
    enabled: bool = True
    #: always-on sampler rate (Hz); 0 disables the sampler plane only.
    #: Deliberately an off-round prime so it cannot phase-lock with 1 Hz
    #: supervision ticks or 10 ms batching windows.
    sample_hz: float = 23.0
    #: event-loop lag probe tick (ms)
    lag_probe_ms: float = 20.0
    #: a coroutine resumption at least this long is filed as a stall
    stall_threshold_ms: float = 50.0
    #: hard cap on one capture window's length (seconds)
    capture_limit_s: float = 10.0
    #: worst-offender stall ring size
    stall_ring: int = 64
    #: log2-us histogram buckets (shared bounds with the waterfall)
    buckets: int = 30


@dataclass(frozen=True)
class GcTuningConfig:
    """`CONFIG_whisk_host_gc_*` env overrides for `tune_gc()`.

    Rationale (measured by this module's GC plane): CPython's
    default thresholds (700, 10, 10) run a FULL-heap gen-2 collection
    every ~70k surviving allocations. A loaded controller allocates
    hundreds of objects per activation over a permanent heap of ~1M
    objects (jax's module graph alone), so gen-2 fires mid-burst and
    stalls the event loop for 100-250 ms — the observatory measured GC at
    ~12% of wall with 262 ms p99 gen-2 pauses at 2k activations/s.
    `tune_gc()` freezes the post-boot permanent heap out of the collector
    (gc.freeze) and raises the thresholds so cycles still collect but
    full scans amortize over far more allocations. Default OFF for the
    product (`enabled=false`): operators opt in per deployment; the
    open-loop harness (tools/loadgen.py) opts in for its own process and
    says so in the generator block."""
    enabled: bool = False
    gen0: int = 50000
    gen1: int = 50
    gen2: int = 100
    freeze: bool = True

    @classmethod
    def from_env(cls) -> "GcTuningConfig":
        return load_config(cls, env_path="host.gc")


def tune_gc(config: Optional[GcTuningConfig] = None,
            force: bool = False) -> Optional[dict]:
    """Apply the GC tuning above (see GcTuningConfig). Returns what was
    done ({frozen, thresholds}) or None when disabled. `force=True`
    applies regardless of the enabled flag (the harness's explicit
    opt-in). One full collection runs first so freeze() pins a clean
    heap."""
    cfg = config if config is not None else GcTuningConfig.from_env()
    if not (cfg.enabled or force):
        return None
    gc.collect()
    frozen = 0
    if cfg.freeze:
        gc.freeze()
        frozen = gc.get_freeze_count()
    gc.set_threshold(int(cfg.gen0), int(cfg.gen1), int(cfg.gen2))
    return {"frozen": frozen,
            "thresholds": [int(cfg.gen0), int(cfg.gen1), int(cfg.gen2)]}


class _TimedCoro:
    """Coroutine-protocol wrapper timing every resumption (one event-loop
    callback turn). The fast path is two perf_counter_ns calls around the
    inner send/throw; only a step over the stall threshold takes the slow
    path into the observatory. Registered as a Coroutine ABC subclass (see
    module bottom) so asyncio.Task accepts it."""

    __slots__ = ("_coro", "_obs", "_name", "__name__", "__qualname__")

    def __init__(self, coro, obs: "HostObservatory", name: str):
        self._coro = coro
        self._obs = obs
        self._name = name
        # asyncio's task repr reads these off the coroutine object
        self.__name__ = getattr(coro, "__name__", name)
        self.__qualname__ = name

    def send(self, value):
        t0 = time.perf_counter_ns()
        try:
            return self._coro.send(value)
        finally:
            dt = time.perf_counter_ns() - t0
            if dt >= self._obs._stall_ns:
                self._obs._note_stall(self._name, dt)

    def throw(self, *args):
        t0 = time.perf_counter_ns()
        try:
            return self._coro.throw(*args)
        finally:
            dt = time.perf_counter_ns() - t0
            if dt >= self._obs._stall_ns:
                self._obs._note_stall(self._name, dt)

    def close(self):
        return self._coro.close()

    def __await__(self):
        return self

    def __iter__(self):
        return self

    def __next__(self):
        return self.send(None)


# Task.__init__ requires collections.abc.Coroutine membership; registering
# (instead of inheriting) keeps _TimedCoro a __slots__ class with no ABC
# machinery on the per-step hot path.
import collections.abc as _abc  # noqa: E402

_abc.Coroutine.register(_TimedCoro)


class HostObservatory:
    """The per-process host hot-loop observatory (see module doc)."""

    def __init__(self, config: Optional[HostProfilingConfig] = None):
        self.config = config or HostProfilingConfig()
        self.enabled = self.config.enabled
        self.n_buckets = max(4, int(self.config.buckets))
        self._stall_ns = int(max(0.0, self.config.stall_threshold_ms) * 1e6)
        self._lock = threading.Lock()
        self._installed = False
        #: wall-time epoch behind the gc/serde share percentages —
        #: stamped at construction (serde accounting runs enabled-only,
        #: no install needed), re-stamped by install() and reset()
        self._epoch_mono = time.monotonic()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._metrics = None
        self._prev_factory = None
        self._factory_ref = None
        self._probe_handle = None
        self._probe_next = 0.0
        self._target_tid: Optional[int] = None
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop: Optional[threading.Event] = None
        self._capture: Optional[dict] = None
        self._gc_t0_ns = 0
        self._dispatch_depth = 0
        self._reset_aggregates()

    @classmethod
    def from_config(cls) -> "HostObservatory":
        return cls(load_config(HostProfilingConfig, env_path="host_profiling"))

    def _reset_aggregates(self) -> None:
        b = self.n_buckets
        # event-loop lag (log2-us, like the waterfall's stage histograms —
        # plain int lists: finish-side folds are single slot increments)
        self._lag_hist = [0] * b
        self._lag_sum_us = 0
        self._lag_max_us = 0
        self._lag_ticks = 0
        # stalls (slow coroutine resumptions)
        self._stalls: SeqRingBuffer[dict] = SeqRingBuffer(
            max(8, int(self.config.stall_ring)))
        self._stall_count = 0
        self._stall_sum_us = 0
        # gc pauses per generation
        self._gc_hist = [[0] * b for _ in range(3)]
        self._gc_sum_us = [0, 0, 0]
        self._gc_count = [0, 0, 0]
        self._gc_collected = 0
        self._gc_uncollectable = 0
        self._gc_in_dispatch = 0
        # task churn
        self._tasks_created = 0
        self._tasks_finished = 0
        # serde: (hop, direction) -> [count, bytes, wall_ns]
        self._serde: Dict[Tuple[str, str], list] = {}
        # sampler census
        self._census: Dict[str, int] = {}
        self._collapsed: Dict[str, int] = {}
        self._samples = 0

    def reset(self) -> None:
        """Drop all accumulated state (bench riders isolate windows). The
        wall-time epoch behind the gc/serde share percentages re-stamps
        too, so a post-warmup reset yields shares over the measured window
        rather than over boot-to-now."""
        with self._lock:
            # tasks created before the reset still deliver their done-
            # callbacks afterwards: carry the in-flight count forward so
            # active (= created - finished) can never go negative
            inflight = self._tasks_created - self._tasks_finished
            self._reset_aggregates()
            self._tasks_created = max(0, inflight)
        self._epoch_mono = time.monotonic()

    # -- install / uninstall ----------------------------------------------
    def install(self, loop: Optional[asyncio.AbstractEventLoop] = None,
                metrics=None) -> bool:
        """Arm all four planes on the CURRENT event-loop thread. Returns
        True when this call did the install (the caller then owns the
        matching uninstall); False when disabled or already installed.
        With `metrics`, also registers the exposition renderer there."""
        if not self.enabled or self._installed:
            return False
        loop = loop if loop is not None else asyncio.get_event_loop()
        self._loop = loop
        self._installed = True
        self._epoch_mono = time.monotonic()
        self._target_tid = threading.get_ident()
        # slow-callback interposer + task churn: one factory serves both.
        # The bound method is pinned once — uninstall's identity check
        # must see the SAME object set_task_factory stored.
        self._prev_factory = loop.get_task_factory()
        self._factory_ref = self._task_factory
        loop.set_task_factory(self._factory_ref)
        # lag probe: the first deadline is fixed NOW; every later deadline
        # derives from it (schedule, not previous tick)
        interval = max(1.0, float(self.config.lag_probe_ms)) / 1e3
        self._probe_next = loop.time() + interval
        self._probe_handle = loop.call_at(self._probe_next, self._probe_tick)
        gc.callbacks.append(self._gc_cb)
        if self.config.sample_hz > 0 and hasattr(sys, "_current_frames"):
            self._sampler_stop = threading.Event()
            self._sampler = threading.Thread(
                target=self._sample_loop, name="hostprof-sampler",
                daemon=True)
            self._sampler.start()
        if metrics is not None:
            metrics.register_renderer(self.prometheus_text)
            self._metrics = metrics
        return True

    def uninstall(self) -> None:
        """Tear every plane back down (idempotent). Restores the previous
        task factory only if ours is still the live one."""
        if not self._installed:
            return
        self._installed = False
        if self._probe_handle is not None:
            self._probe_handle.cancel()
            self._probe_handle = None
        loop = self._loop
        if loop is not None and \
                loop.get_task_factory() is getattr(self, "_factory_ref",
                                                   None):
            loop.set_task_factory(self._prev_factory)
        self._prev_factory = None
        self._factory_ref = None
        try:
            gc.callbacks.remove(self._gc_cb)
        except ValueError:
            pass
        if self._sampler_stop is not None:
            self._sampler_stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout=2.0)
        self._sampler = None
        self._sampler_stop = None
        self._capture = None
        if self._metrics is not None:
            self._metrics.unregister_renderer(self.prometheus_text)
            self._metrics = None
        self._loop = None

    @property
    def installed(self) -> bool:
        return self._installed

    @property
    def serde_active(self) -> bool:
        """Whether the serde helpers should pay for a clock read. Enabled
        is enough (no install needed): serde accounting is pure counters,
        useful even when no loop-side plane is armed."""
        return self.enabled

    @property
    def sampler_running(self) -> bool:
        return self._sampler is not None and self._sampler.is_alive()

    # -- plane 1: event-loop lag -------------------------------------------
    def _probe_tick(self) -> None:
        if not self._installed or self._loop is None:
            return
        loop = self._loop
        now = loop.time()
        interval = max(1.0, float(self.config.lag_probe_ms)) / 1e3
        sched = self._probe_next
        nb = self.n_buckets
        with self._lock:
            # coordinated omission: when a stall swallowed k ticks, each
            # missed tick records its own lag from its own deadline —
            # one probe firing late must not collapse k samples into one
            while True:
                lag_us = max(0, int((now - sched) * 1e6))
                self._lag_hist[bucket_of_us(lag_us, nb)] += 1
                self._lag_sum_us += lag_us
                self._lag_ticks += 1
                if lag_us > self._lag_max_us:
                    self._lag_max_us = lag_us
                sched += interval
                if sched > now:
                    break
        self._probe_next = sched
        self._probe_handle = loop.call_at(sched, self._probe_tick)

    def _note_stall(self, coro_name: str, dt_ns: int) -> None:
        """Slow path only: a coroutine resumption over the threshold."""
        task_name = None
        try:
            t = asyncio.current_task()
            if t is not None:
                task_name = t.get_name()
        except RuntimeError:
            pass
        with self._lock:
            self._stall_count += 1
            self._stall_sum_us += dt_ns // 1000
            self._stalls.append({
                "coro": coro_name,
                "task": task_name,
                "ms": round(dt_ns / 1e6, 3),
                "ts": time.time(),
            })

    # -- plane 2: gc pauses ------------------------------------------------
    def _gc_cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0_ns = time.perf_counter_ns()
            return
        t0 = self._gc_t0_ns
        if t0 == 0:
            return
        self._gc_t0_ns = 0
        dt_us = (time.perf_counter_ns() - t0) // 1000
        gen = info.get("generation", 2)
        gen = 2 if gen is None or gen > 2 else (0 if gen < 0 else int(gen))
        # DELIBERATELY LOCK-FREE: an automatic collection can fire on an
        # allocation made while THIS thread already holds self._lock
        # (snapshot copies, serde first-insert, the stall ring append) —
        # taking the non-reentrant lock here would self-deadlock the
        # process. Every fold below is a single GIL-held slot increment;
        # a reader may see a momentarily torn histogram copy, which is
        # acceptable telemetry slack, unlike a frozen event loop.
        self._gc_hist[gen][bucket_of_us(dt_us, self.n_buckets)] += 1
        self._gc_sum_us[gen] += dt_us
        self._gc_count[gen] += 1
        self._gc_collected += int(info.get("collected", 0) or 0)
        self._gc_uncollectable += int(info.get("uncollectable", 0) or 0)
        if self._dispatch_depth > 0:
            # the waterfall cross-link: this pause landed inside a
            # device_dispatch bracket — the batch it stalled will show
            # the time in its dispatch stage, and this counter names
            # the cause
            self._gc_in_dispatch += 1

    def begin_dispatch(self) -> None:
        """Bracket entry for the balancer's device-dispatch section (loop
        thread only; plain increments so the disabled path costs two
        attribute ops)."""
        self._dispatch_depth += 1

    def end_dispatch(self) -> None:
        self._dispatch_depth -= 1

    # -- plane 3: task churn + serde ---------------------------------------
    def _task_factory(self, loop, coro, **kwargs):
        self._tasks_created += 1
        if hasattr(coro, "send") and hasattr(coro, "throw"):
            name = getattr(coro, "__qualname__", None) or repr(coro)
            coro = _TimedCoro(coro, self, name)
        if self._prev_factory is not None:
            task = self._prev_factory(loop, coro, **kwargs)
        else:
            task = asyncio.Task(coro, loop=loop, **kwargs)
        task.add_done_callback(self._task_done)
        return task

    def _task_done(self, task) -> None:
        # deliberately does NOT call task.exception(): retrieving it here
        # would suppress asyncio's "exception was never retrieved" warning
        # for genuinely dropped failures
        self._tasks_finished += 1

    def serde_observe(self, hop: str, direction: str, nbytes: int,
                      dt_ns: int) -> None:
        """One serialize/deserialize hop (messaging/connector.py's
        encode_message/decode_message are the callers)."""
        with self._lock:
            row = self._serde.get((hop, direction))
            if row is None:
                row = self._serde[(hop, direction)] = [0, 0, 0]
            row[0] += 1
            row[1] += nbytes
            row[2] += dt_ns

    # -- plane 4: sampling profiler ----------------------------------------
    def _fold_frame(self, frame) -> Tuple[str, str]:
        """(leaf self-time key, collapsed root;..;leaf stack) for one
        sampled frame."""
        parts: List[str] = []
        g = frame
        depth = 0
        while g is not None and depth < MAX_STACK_DEPTH:
            code = g.f_code
            parts.append(f"{os.path.basename(code.co_filename)}:"
                         f"{code.co_name}")
            g = g.f_back
            depth += 1
        parts.reverse()
        code = frame.f_code
        leaf = (f"{code.co_name} ({os.path.basename(code.co_filename)}:"
                f"{code.co_firstlineno})")
        return leaf, ";".join(parts)

    @staticmethod
    def _bump(d: dict, key: str, cap: int) -> None:
        if key in d or len(d) < cap:
            d[key] = d.get(key, 0) + 1
        else:
            d[_OVERFLOW_KEY] = d.get(_OVERFLOW_KEY, 0) + 1

    def _sample_loop(self) -> None:
        stop = self._sampler_stop
        base_period = 1.0 / max(0.5, float(self.config.sample_hz))
        while True:
            cap = self._capture
            period = (1.0 / CAPTURE_HZ) if cap is not None else base_period
            if stop.wait(period):
                return
            try:
                frame = sys._current_frames().get(self._target_tid)
            except Exception:  # noqa: BLE001 — a failed sample is a skip
                continue
            if frame is None:
                continue
            leaf, collapsed = self._fold_frame(frame)
            now = time.monotonic()
            with self._lock:
                self._samples += 1
                self._bump(self._census, leaf, MAX_CENSUS_KEYS)
                self._bump(self._collapsed, collapsed, MAX_COLLAPSED_KEYS)
                cap = self._capture
                if cap is not None:
                    if now >= cap["until"]:
                        self._capture = None
                    else:
                        cap["samples"] += 1
                        self._bump(cap["census"], leaf, MAX_CENSUS_KEYS)
                        self._bump(cap["collapsed"], collapsed,
                                   MAX_COLLAPSED_KEYS)

    async def capture(self, seconds: float) -> dict:
        """Arm a bounded full-rate (CAPTURE_HZ) sampling window, wait it
        out, and return the window's collapsed stacks + census — the kernel
        profiler's capture-plane pattern. One window at a time."""
        if not self.enabled or not self.sampler_running:
            raise RuntimeError("host sampler is not running")
        seconds = min(max(0.05, float(seconds)),
                      float(self.config.capture_limit_s))
        with self._lock:
            if self._capture is not None:
                raise RuntimeError("a capture window is already armed")
            cap = {"until": time.monotonic() + seconds, "samples": 0,
                   "census": {}, "collapsed": {}}
            self._capture = cap
        await asyncio.sleep(seconds + 2.0 / CAPTURE_HZ)
        with self._lock:
            if self._capture is cap:
                self._capture = None
            census = dict(cap["census"])
            collapsed = dict(cap["collapsed"])
        ranked = sorted(census.items(), key=lambda kv: -kv[1])
        total = max(1, cap["samples"])
        lines = [f"{stack} {n}" for stack, n in
                 sorted(collapsed.items(), key=lambda kv: -kv[1])]
        return {
            "seconds": seconds,
            "hz": CAPTURE_HZ,
            "samples": cap["samples"],
            "top": [{"frame": k, "samples": n,
                     "pct": round(100.0 * n / total, 1)}
                    for k, n in ranked[:20]],
            #: flamegraph.pl / speedscope "collapsed" format, one
            #: semicolon-joined stack + count per line
            "collapsed": "\n".join(lines),
        }

    # -- read side ---------------------------------------------------------
    def _pctl_ms(self, counts: List[int], q: float) -> Optional[float]:
        """Upper bound (ms) of the bucket holding the q-quantile (shared
        log2 bounds with the waterfall); None when empty or overflowed."""
        import math
        total = sum(counts)
        if not total:
            return None
        target = max(1, math.ceil(q * total))
        cum = 0
        bounds = bucket_bounds_ms(self.n_buckets)
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                return bounds[i] if i < len(bounds) else None
        return None

    def snapshot(self) -> dict:
        """The `GET /admin/profile/host` payload: host-side reads only."""
        if not self.enabled:
            # disabled payload stays byte-identical to pre-federation
            # builds — the fleet mergers drop disabled members anyway
            return {"enabled": False}
        with self._lock:
            lag_hist = list(self._lag_hist)
            lag_sum_us, lag_max_us = self._lag_sum_us, self._lag_max_us
            lag_ticks = self._lag_ticks
            stalls = [s for s in self._stalls.last(self._stalls.size)
                      if s is not None]
            stall_count, stall_sum_us = self._stall_count, self._stall_sum_us
            gc_hist = [list(h) for h in self._gc_hist]
            gc_sum_us = list(self._gc_sum_us)
            gc_count = list(self._gc_count)
            gc_collected = self._gc_collected
            gc_uncollectable = self._gc_uncollectable
            gc_in_dispatch = self._gc_in_dispatch
            created, finished = self._tasks_created, self._tasks_finished
            serde = {k: list(v) for k, v in self._serde.items()}
            census = dict(self._census)
            samples = self._samples
        uptime_s = max(0.0, time.monotonic() - self._epoch_mono)
        wall_us = max(1.0, uptime_s * 1e6)
        gc_total_us = sum(gc_sum_us)
        ranked = sorted(census.items(), key=lambda kv: -kv[1])
        return {
            "enabled": True,
            # the federation's merge key — disambiguates
            # multi-process loadgen's per-worker host snapshots too
            "identity": identity(),
            "installed": self._installed,
            "uptime_s": round(uptime_s, 3),
            "loop_lag": {
                "ticks": lag_ticks,
                "probe_interval_ms": self.config.lag_probe_ms,
                "p50_ms": self._pctl_ms(lag_hist, 0.50),
                "p99_ms": self._pctl_ms(lag_hist, 0.99),
                "max_ms": round(lag_max_us / 1000.0, 3),
                "mean_ms": (round(lag_sum_us / lag_ticks / 1000.0, 3)
                            if lag_ticks else None),
            },
            "stalls": {
                "threshold_ms": self.config.stall_threshold_ms,
                "count": stall_count,
                "total_ms": round(stall_sum_us / 1000.0, 3),
                #: worst offenders first (the ring keeps the most recent
                #: `stall_ring`; ranking inside it answers "who stalls")
                "worst": sorted(stalls, key=lambda s: -s["ms"])[:16],
            },
            "gc": {
                "pauses": {str(g): gc_count[g] for g in range(3)},
                "pause_ms": {str(g): round(gc_sum_us[g] / 1000.0, 3)
                             for g in range(3)},
                "p99_ms": {str(g): self._pctl_ms(gc_hist[g], 0.99)
                           for g in range(3) if gc_count[g]},
                "collected": gc_collected,
                "uncollectable": gc_uncollectable,
                "overlapping_dispatch": gc_in_dispatch,
                #: share of host wall-time spent paused in GC since
                #: install — the "GC is X% of the loop" number
                "pause_share_pct": round(100.0 * gc_total_us / wall_us, 3),
            },
            "tasks": {
                "created": created,
                "finished": finished,
                "active": created - finished,
            },
            "serde": [
                {"hop": hop, "direction": direction, "count": row[0],
                 "bytes": row[1], "ms": round(row[2] / 1e6, 3),
                 #: serde wall-time over host wall-time — the "JSON is
                 #: X% of the loop" number, per hop and direction
                 "share_pct": round(100.0 * (row[2] / 1e3) / wall_us, 3)}
                for (hop, direction), row in sorted(serde.items())
            ],
            "sampler": {
                "running": self.sampler_running,
                "hz": self.config.sample_hz,
                "samples": samples,
                "distinct_frames": len(census),
                "top": [{"frame": k, "samples": n,
                         "pct": round(100.0 * n / max(1, samples), 1)}
                        for k, n in ranked[:10]],
            },
        }

    def raw_counts(self) -> dict:
        """The exact-merge export behind `?raw=1`: integer
        bucket counts / sums only — percentiles do not compose across
        processes, bucket counts merge bucket-wise bit-exactly."""
        with self._lock:
            out = {
                "identity": identity(),
                "enabled": self.enabled,
                "buckets": self.n_buckets,
                "uptime_s": round(max(0.0, time.monotonic()
                                      - self._epoch_mono), 3),
                "lag": {"hist": list(self._lag_hist),
                        "sum_us": int(self._lag_sum_us),
                        "max_us": int(self._lag_max_us),
                        "ticks": int(self._lag_ticks)},
                "stalls": {"count": int(self._stall_count),
                           "sum_us": int(self._stall_sum_us)},
                "gc": {"hist": [list(h) for h in self._gc_hist],
                       "sum_us": [int(v) for v in self._gc_sum_us],
                       "count": [int(v) for v in self._gc_count],
                       "collected": int(self._gc_collected),
                       "uncollectable": int(self._gc_uncollectable),
                       "overlapping_dispatch": int(self._gc_in_dispatch)},
                "tasks": {"created": int(self._tasks_created),
                          "finished": int(self._tasks_finished)},
                "serde": [[hop, direction, int(row[0]), int(row[1]),
                           int(row[2])]
                          for (hop, direction), row
                          in sorted(self._serde.items())],
            }
        return out

    def collapsed_text(self) -> str:
        """The always-on census as flamegraph collapsed-stack lines."""
        with self._lock:
            items = sorted(self._collapsed.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{stack} {n}" for stack, n in items)

    # -- exposition --------------------------------------------------------
    @staticmethod
    def _plain_counter(name: str, value, openmetrics: bool) -> List[str]:
        """Unlabeled counter with the OpenMetrics `_total` naming rule
        (see controller/monitoring.py counter_family_text)."""
        base = name[:-len("_total")] if name.endswith("_total") else name
        fam = base if openmetrics else name
        sample = (base + "_total") if openmetrics else name
        return [f"# TYPE {fam} counter", f"{sample} {value}"]

    def prometheus_text(self, openmetrics: bool = False) -> str:
        if not self.enabled:
            return ""
        from ..controller.monitoring import (counter_family_text,
                                             histogram_family_text)
        with self._lock:
            lag_hist = list(self._lag_hist)
            lag_sum_us = self._lag_sum_us
            gc_hist = [list(h) for h in self._gc_hist]
            gc_sum_us = list(self._gc_sum_us)
            stall_count = self._stall_count
            gc_in_dispatch = self._gc_in_dispatch
            gc_collected = self._gc_collected
            gc_uncollectable = self._gc_uncollectable
            created, finished = self._tasks_created, self._tasks_finished
            serde = {k: list(v) for k, v in self._serde.items()}
        bounds = bucket_bounds_ms(self.n_buckets)
        out: List[str] = []
        if sum(lag_hist):
            out += histogram_family_text(
                "openwhisk_host_event_loop_lag_seconds", "thread",
                [("event_loop", lag_hist, lag_sum_us / 1000.0)], bounds)
        gc_rows = [(str(g), gc_hist[g], gc_sum_us[g] / 1000.0)
                   for g in range(3) if sum(gc_hist[g])]
        out += histogram_family_text(
            "openwhisk_host_gc_pause_seconds", "generation", gc_rows, bounds)
        out += self._plain_counter("openwhisk_host_tasks_created_total",
                                   created, openmetrics)
        out += self._plain_counter("openwhisk_host_tasks_finished_total",
                                   finished, openmetrics)
        out += ["# TYPE openwhisk_host_tasks_active gauge",
                f"openwhisk_host_tasks_active {created - finished}"]
        out += self._plain_counter("openwhisk_host_loop_stalls_total",
                                   stall_count, openmetrics)
        out += self._plain_counter(
            "openwhisk_host_gc_pauses_in_dispatch_total", gc_in_dispatch,
            openmetrics)
        out += self._plain_counter("openwhisk_host_gc_collected_total",
                                   gc_collected, openmetrics)
        out += self._plain_counter("openwhisk_host_gc_uncollectable_total",
                                   gc_uncollectable, openmetrics)
        serde_rows = sorted(serde.items())
        out += counter_family_text(
            "openwhisk_host_serde_seconds_total",
            [({"hop": hop, "direction": d}, round(row[2] / 1e9, 6))
             for (hop, d), row in serde_rows], openmetrics=openmetrics)
        out += counter_family_text(
            "openwhisk_host_serde_bytes_total",
            [({"hop": hop, "direction": d}, row[1])
             for (hop, d), row in serde_rows], openmetrics=openmetrics)
        return "\n".join(out)


#: the process-wide observatory (GLOBAL_WATERFALL pattern): the messaging
#: serde helpers, the balancer's dispatch bracket and the admin endpoints
#: all reach it without a shared reference; Controller.start / the invoker
#: main own install()/uninstall()
GLOBAL_HOST_OBSERVATORY = HostObservatory.from_config()
