"""The placement path settings and the early build, on the CPU.

  (a) `CONFIG_whisk_loadBalancer_{placementKernel,adaptiveWindow,
      batchPublish,prewarm}` read the same in both packages'
      `TpuBalancer`, constructor arguments override them, and
      `placement_kernel_resolved` is equal for each kernel setting;
  (b) the early build's gate, with a fake build job of 1 s behind the
      balancer's future: flushes are deferred while it runs (no dispatch
      before the job completes), the rows are then placed in the order
      they were published, and the event loop's lag stays under 0.1 s
      (the heap earlier tests left in the process frozen out of the
      collector for the run: one full collection of it exceeds the bound
      by itself);
  (c) a job that raises fails every dispatch, the ones queued behind it
      and every later one, and never reaches the schedule (on the card
      the plain version would be a fallback);
  (d) with prewarm on, a balancer on the CPU starts no build job.

The real job on the card (nvcc from an empty build directory, then every
launcher resolved) is `tests/test_torch_placement_cuda.py`'s
`test_prewarm_builds_and_loads_every_kernel_off_the_caller`.
"""
import asyncio
import concurrent.futures
import contextlib
import gc
import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer import (  # noqa: E402
    PlacementPathConfig, TpuBalancer)
from openwhisk_tpu_torch.core import entity as E  # noqa: E402
from openwhisk_tpu_torch.messaging import MemoryMessagingProvider  # noqa: E402
from test_torch_balancer_front import (CTRL, _fleet, _ping_all,  # noqa: E402
                                       _stop, front, make_action, make_msg)

SETTINGS = {
    "placementKernel": ("placement_kernel", ["scan", "repair", "auto"]),
    "adaptiveWindow": ("adaptive_window", ["false", "true"]),
    "batchPublish": ("batch_publish", ["false", "true"]),
    "prewarm": ("prewarm", ["false", "true"]),
}
CASES = [(env, v) for env, (_, vals) in SETTINGS.items() for v in vals]


def _jax_balancer():
    from openwhisk_tpu.controller.loadbalancer.tpu_balancer import \
        TpuBalancer as JB
    from openwhisk_tpu.core.entity import ControllerInstanceId
    from openwhisk_tpu.messaging import MemoryMessagingProvider as JM
    return JB(JM(), ControllerInstanceId("0"))


@pytest.mark.parametrize("env,value", CASES)
def test_path_settings_read_the_same_in_both_packages(monkeypatch, env,
                                                      value):
    monkeypatch.setenv(f"CONFIG_whisk_loadBalancer_{env}", value)
    attr = SETTINGS[env][0]
    j = _jax_balancer()
    p = TpuBalancer(MemoryMessagingProvider(), CTRL, device="cpu")
    assert getattr(p, attr) == getattr(j, attr)
    assert p.placement_kernel_resolved == j.placement_kernel_resolved
    if env == "placementKernel":
        assert p.placement_kernel == value
    else:
        assert getattr(p, attr) is (value == "true")


def test_constructor_arguments_override_the_environment(monkeypatch):
    monkeypatch.setenv("CONFIG_whisk_loadBalancer_placementKernel", "scan")
    monkeypatch.setenv("CONFIG_whisk_loadBalancer_prewarm", "false")
    p = TpuBalancer(MemoryMessagingProvider(), CTRL, device="cpu",
                    placement_kernel="repair", prewarm=True)
    assert (p.placement_kernel, p.placement_kernel_resolved, p.prewarm) == (
        "repair", "repair", True)
    monkeypatch.setenv("CONFIG_whisk_loadBalancer_placementKernel", "bogus")
    with pytest.raises(ValueError, match="scan|repair|auto"):
        TpuBalancer(MemoryMessagingProvider(), CTRL, device="cpu")


def test_the_config_names_every_field_of_the_jax_packages():
    import dataclasses
    from openwhisk_tpu.controller.loadbalancer.tpu_balancer import \
        PlacementPathConfig as JC
    assert {f.name: f.default for f in dataclasses.fields(JC)} == {
        f.name: f.default for f in dataclasses.fields(PlacementPathConfig)}


def test_prewarm_on_the_cpu_starts_no_build():
    p = TpuBalancer(MemoryMessagingProvider(), CTRL, device="cpu",
                    prewarm=True)
    assert p.prewarm is True and p._kernels_job is None


def _fake_job(seconds, error=None):
    """A build job's future, completed by a worker thread after `seconds`
    (with `error` raised, if given); returns (future, completion time)."""
    fut = concurrent.futures.Future()
    fut.set_running_or_notify_cancel()
    done_at = {}

    def run():
        time.sleep(seconds)
        done_at["t"] = time.monotonic()
        if error is None:
            fut.set_result(None)
        else:
            fut.set_exception(error)

    threading.Thread(target=run, daemon=True).start()
    return fut, done_at


async def _lag_probe(stop, lags, period=0.01):
    while not stop.is_set():
        t = time.monotonic()
        await asyncio.sleep(period)
        lags.append(time.monotonic() - t - period)


def _record_dispatches(bal, log):
    orig = bal._dispatch_batch

    def wrapped():
        log.append((time.monotonic(),
                    [e[4] for e in bal._pending[:bal.max_batch]]))
        orig()

    bal._dispatch_batch = wrapped


@contextlib.contextmanager
def _heap_frozen():
    """The heap that earlier tests left in this process frozen out of the
    collector (`utils/hostprof.tune_gc`'s freeze) for the block: a full
    collection of it alone holds the loop 105-140 ms with both packages
    imported, and over a second in a loaded test worker, whatever the
    balancer does. Collections inside the block scan what the block makes."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def test_flushes_wait_for_the_build_off_the_loop_then_place_in_order():
    async def go():
        provider = MemoryMessagingProvider()
        bal = front(provider)
        await bal.start()
        invokers, producer = await _fleet(provider, 4)
        await _ping_all(invokers, producer, bal)
        bal._kernels_job, done_at = _fake_job(1.0)
        dispatches, lags, stop = [], [], asyncio.Event()
        _record_dispatches(bal, dispatches)
        probe = asyncio.get_event_loop().create_task(
            _lag_probe(stop, lags))
        ident, action = E.Identity.generate("guest"), make_action()
        msgs = [make_msg(action, ident, True) for _ in range(24)]
        tasks = []
        for i, m in enumerate(msgs):
            tasks.append(asyncio.get_event_loop().create_task(
                bal.publish(action, m)))
            await asyncio.sleep(0.02)  # rows arrive through the build
        promises = await asyncio.gather(*tasks)
        results = await asyncio.gather(
            *[asyncio.wait_for(p, 5) for p in promises])
        stop.set()
        await probe
        await _stop(bal, invokers)
        return msgs, results, dispatches, done_at, lags

    with _heap_frozen():
        msgs, results, dispatches, done_at, lags = asyncio.run(
            asyncio.wait_for(go(), 30))
    assert all(r.response.is_success for r in results)
    assert dispatches and dispatches[0][0] >= done_at["t"], \
        "a dispatch ran before the build completed"
    placed = [aid for _, aids in dispatches for aid in aids]
    assert placed == [str(m.activation_id) for m in msgs]
    assert max(lags) < 0.1, max(lags)


def test_a_failed_build_fails_every_dispatch_and_never_schedules():
    async def go():
        provider = MemoryMessagingProvider()
        bal = front(provider)
        await bal.start()
        invokers, producer = await _fleet(provider, 2)
        await _ping_all(invokers, producer, bal)
        bal._kernels_job, _ = _fake_job(
            0.3, RuntimeError("nvcc placement_scan.cu exited 1"))
        calls = []

        def never(*a, **k):
            calls.append(a)
            raise AssertionError("the schedule ran after a failed build")

        bal._packed_fn = never
        ident, action = E.Identity.generate("guest"), make_action()
        outcomes = []
        queued = [asyncio.get_event_loop().create_task(
            bal.publish(action, make_msg(action, ident, True)))
            for _ in range(4)]
        outcomes += await asyncio.gather(*queued, return_exceptions=True)
        for _ in range(3):  # and every dispatch after it
            try:
                await bal.publish(action, make_msg(action, ident, True))
                outcomes.append(None)
            except Exception as e:  # noqa: BLE001
                outcomes.append(e)
        await _stop(bal, invokers)
        return outcomes, calls

    outcomes, calls = asyncio.run(asyncio.wait_for(go(), 30))
    assert len(outcomes) == 7 and calls == []
    for e in outcomes:
        assert isinstance(e, Exception), e
        assert "device dispatch failed" in str(e)
        assert "nvcc placement_scan.cu exited 1" in str(e)


@pytest.mark.parametrize("rate_limit,quality", [(None, False), (600, True)])
def test_the_warm_steps_run_each_family_on_dummy_books(monkeypatch,
                                                       rate_limit, quality):
    """`_warm_planes` and `_warm_steps` (the early build's warm-ups, run
    on the CPU here): the tick's programs on dummy state, then the packed
    step at the scan's bucket and the repair's, the shadow step too with
    the quality plane on, with no row valid: the live books, the rate
    buckets and the kernels' launch counts are untouched."""
    from openwhisk_tpu_torch.ops import placement_cuda as K
    if quality:
        monkeypatch.setenv("CONFIG_whisk_placementQuality_enabled", "true")
        monkeypatch.setenv("CONFIG_whisk_placementQuality_shadowEveryN", "2")

    async def go():
        provider = MemoryMessagingProvider()
        bal = front(provider, rate_limit_per_minute=rate_limit)
        await bal.start()
        invokers, producer = await _fleet(provider, 3)
        await _ping_all(invokers, producer, bal)
        seen = []
        packed, shadow = bal._packed_fn, bal._shadow_fn

        def spy(fn, tag):
            def call(*a, **k):
                seen.append((tag, a[-1]))
                return fn(*a, **k)
            return call

        bal._packed_fn = spy(packed, "step")
        if shadow is not None:
            bal._shadow_fn = spy(shadow, "shadow")
        books = [t.clone() for t in bal.state]
        rate = (None if bal._bucket_state is None
                else [t.clone() for t in bal._bucket_state])
        counts = (K.schedule_batch_cuda.launches,
                  K.schedule_batch_repair_cuda.launches)
        bal._warm_planes()
        bal._warm_steps()
        same = all(torch.equal(a, b) for a, b in zip(books, bal.state))
        if rate is not None:
            same = same and all(torch.equal(a, b) for a, b in
                                zip(rate, bal._bucket_state))
        await _stop(bal, invokers)
        return seen, same, counts == (K.schedule_batch_cuda.launches,
                                      K.schedule_batch_repair_cuda.launches)

    seen, same, counted_none = asyncio.run(asyncio.wait_for(go(), 30))
    want = [("step", 8), ("step", 32)]
    if quality:
        want = [("shadow", 8), ("step", 8), ("shadow", 32), ("step", 32)]
    assert seen == want
    assert same and counted_none


def test_the_warm_steps_keep_one_shape_while_the_loop_grows_the_books(
        monkeypatch):
    """The early build runs `_warm_steps` on a worker thread while the
    loop registers invokers and grows the books. Growth that lands between
    the dummy books' allocation and the shadow step's penalty must not
    mismatch them (on the card the kernel wrapper refuses a penalty of
    another width, which failed the build and so every dispatch)."""
    from openwhisk_tpu_torch.controller.loadbalancer import tpu_balancer as TB
    monkeypatch.setenv("CONFIG_whisk_placementQuality_enabled", "true")
    monkeypatch.setenv("CONFIG_whisk_placementQuality_shadowEveryN", "2")

    async def go():
        provider = MemoryMessagingProvider()
        bal = front(provider)
        await bal.start()
        invokers, producer = await _fleet(provider, 3)
        await _ping_all(invokers, producer, bal)
        widths = []
        shadow, init_state = bal._shadow_fn, TB.init_state

        def grow_meanwhile(*a, **k):
            # the loop's registration growth, landing mid warm step
            st = init_state(*a, **k)
            bal._grow_padding(bal._n_pad * 2)
            return st

        def spy(st, dbuf, penalty, *a, **k):
            books = st if hasattr(st, "free_mb") else st[0]
            widths.append((books.free_mb.shape[0], penalty.shape[0]))
            return shadow(st, dbuf, penalty, *a, **k)

        monkeypatch.setattr(TB, "init_state", grow_meanwhile)
        bal._shadow_fn = spy
        n0 = bal._n_pad
        bal._warm_steps()
        monkeypatch.setattr(TB, "init_state", init_state)
        n1 = bal._n_pad
        await _stop(bal, invokers)
        return widths, n0, n1

    widths, n0, n1 = asyncio.run(asyncio.wait_for(go(), 30))
    assert n1 == 4 * n0
    assert widths == [(n0, n0), (2 * n0, 2 * n0)]
