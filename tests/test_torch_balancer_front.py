"""The port's TpuBalancer front on the CPU: publish / publish_many over the
in-memory bus, completion acks, invoker supervision, fleet and slot-axis
growth and device rate admission.

  (a) the JAX suite's TpuBalancer cases (tests/test_balancers.py) against
      the port;
  (b) the batched-publish cases that carry over without the front-door
      coalescer (tests/test_publish_batch.py), and the failure paths of a
      step that fails on the device;
  (c) cross-package placement parity: the port's `TpuBalancer(device=
      "cpu")` and the JAX package's `TpuBalancer(kernel="xla")` on one
      seeded sequence (registration pings, `publish_many` waves of exactly
      `max_batch` rows that flush inline, a serial trickle, acks from
      simulated invokers) give the same invoker and forced flag for every
      activation and the same books — with and without device rate
      admission, and with a fleet that grows past `initial_pad` mid-run.
      Tolerance: none, every compared value is an integer or a flag;
  (d) once every activation is acked, nothing is active and the books are
      back at full capacity.

Every test bounds itself with `asyncio.wait_for`.
"""
import asyncio
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from openwhisk_tpu_torch.controller.loadbalancer.base import (  # noqa: E402
    HEALTHY, OFFLINE, UNHEALTHY, ActiveAckTimeout, LoadBalancerException,
    LoadBalancerThrottleException)
from openwhisk_tpu_torch.controller.loadbalancer.supervision import \
    InvokerPool  # noqa: E402
from openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer import (  # noqa: E402
    TpuBalancer, TpuBalancerProvider)
from openwhisk_tpu_torch.core import entity as E  # noqa: E402
from openwhisk_tpu_torch.core.entity.ids import DocRevision  # noqa: E402
from openwhisk_tpu_torch.messaging import (  # noqa: E402
    ActivationMessage, CombinedCompletionAndResultMessage, CompletionMessage,
    MemoryMessagingProvider, MessageFeed, PingMessage)
from openwhisk_tpu_torch.messaging.columnar import (  # noqa: E402
    is_batch_payload, parse_batch)
from openwhisk_tpu_torch.utils.transaction import TransactionId  # noqa: E402

CTRL = E.ControllerInstanceId("0")


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def make_action(name="act", memory=256, kind="python:3", ent=E):
    a = ent.ExecutableWhiskAction(
        ent.EntityPath("guest"), ent.EntityName(name),
        ent.CodeExec(kind=kind, code="x"),
        limits=ent.ActionLimits(ent.TimeLimit(5000),
                                ent.MemoryLimit(ent.MB(memory))))
    a.rev = DocRevision("1-b")
    return a


def make_msg(action, ident, blocking=False):
    return ActivationMessage(
        TransactionId(), action.fully_qualified_name, action.rev.rev, ident,
        E.ActivationId.generate(), CTRL, blocking, {})


class SimInvoker:
    """A fake invoker: consumes its topic, acks each activation after
    `delay` seconds."""

    def __init__(self, provider, instance, delay=0.0):
        self.provider = provider
        self.instance = instance
        self.delay = delay
        self.handled = []
        self._feed = None
        self._tasks = set()

    async def start(self):
        topic = self.instance.as_string
        self.provider.ensure_topic(topic)
        consumer = self.provider.get_consumer(topic, topic)
        producer = self.provider.get_producer()
        box = {}

        async def finish(msg):
            if self.delay:
                await asyncio.sleep(self.delay)
            now = time.time()
            act = E.WhiskActivation(
                E.EntityPath(str(msg.user.namespace.name)), msg.action.name,
                msg.user.subject, msg.activation_id, now, now,
                E.ActivationResponse.success({"ok": True}), duration=1)
            await producer.send(
                f"completed{msg.root_controller_index.as_string}",
                CombinedCompletionAndResultMessage(msg.transid, act,
                                                   self.instance))
            box["feed"].processed()

        async def handle(payload: bytes):
            # the batch wire ships one columnar frame per coalesced
            # micro-batch (messaging/columnar.py); lone messages arrive in
            # the plain per-message format
            if is_batch_payload(payload):
                _kind, msgs = parse_batch(payload)
                box["feed"].consume_extra(len(msgs) - 1)
            else:
                msgs = [ActivationMessage.parse(payload)]
            for msg in msgs:
                self.handled.append(msg)
                task = asyncio.get_event_loop().create_task(finish(msg))
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)

        self._feed = box["feed"] = MessageFeed(topic, consumer, 64, handle,
                                               long_poll_timeout=0.05)
        self._feed.start()

    async def ping(self, producer):
        await producer.send("health", PingMessage(self.instance))

    async def stop(self):
        if self._feed:
            await self._feed.stop()


async def _fleet(provider, n, memory_mb=2048, delay=0.0):
    invokers = []
    producer = provider.get_producer()
    for i in range(n):
        inv = SimInvoker(provider, E.InvokerInstanceId(
            i, user_memory=E.MB(memory_mb)), delay=delay)
        await inv.start()
        invokers.append(inv)
    return invokers, producer


async def _registered(bal, n, timeout=5.0):
    """Until invokers 0..n-1 are registered and healthy."""
    t0 = time.monotonic()
    while not (len(bal._registry) >= n and all(bal._healthy[:n])):
        if time.monotonic() - t0 > timeout:
            raise RuntimeError("pings were not handled")
        await asyncio.sleep(0.005)


async def _ping_all(invokers, producer, bal):
    for inv in invokers:
        await inv.ping(producer)
    await _registered(bal, len(invokers))


def front(provider, **kw):
    kw.setdefault("managed_fraction", 1.0)
    kw.setdefault("blackbox_fraction", 0.0)
    return TpuBalancer(provider, CTRL, device="cpu", **kw)


async def _settled(bal, timeout=5.0):
    """Until every activation is acked and its release has folded."""
    t0 = time.monotonic()
    while bal.total_active_activations:
        if time.monotonic() - t0 > timeout:
            raise RuntimeError("acks did not arrive")
        await asyncio.sleep(0.005)
    await _drain(bal, timeout)


async def _stop(bal, invokers=()):
    await bal.close()
    for inv in invokers:
        await inv.stop()


# ----------------------------------------------------------------- (a)
class TestBalancerCases:
    def test_publish_roundtrip_and_release(self):
        async def go():
            provider = MemoryMessagingProvider()
            bal = front(provider)
            await bal.start()
            invokers, producer = await _fleet(provider, 4)
            await _ping_all(invokers, producer, bal)
            ident = E.Identity.generate("guest")
            action = make_action()
            promises = [await bal.publish(action,
                                          make_msg(action, ident, True))
                        for _ in range(8)]
            results = await asyncio.gather(*[asyncio.wait_for(p, 5)
                                             for p in promises])
            await _settled(bal)
            out = (results, bal.total_active_activations,
                   len(bal.activation_slots), bal.state.free_mb[:4].tolist(),
                   [len(i.handled) for i in invokers])
            await _stop(bal, invokers)
            return out

        results, total, slots, free, handled = run(go())
        assert len(results) == 8
        assert all(r.response.is_success for r in results)
        assert total == 0 and slots == 0
        assert sum(handled) == 8
        assert free == [2048] * 4

    def test_affinity_same_action_same_invoker(self):
        async def go():
            provider = MemoryMessagingProvider()
            bal = front(provider)
            await bal.start()
            invokers, producer = await _fleet(provider, 8)
            await _ping_all(invokers, producer, bal)
            ident = E.Identity.generate("guest")
            action = make_action("affine", memory=128)
            for _ in range(4):
                p = await bal.publish(action, make_msg(action, ident, True))
                await asyncio.wait_for(p, 5)
                await asyncio.sleep(0.05)  # release between invokes
            await _stop(bal, invokers)
            return [len(i.handled) for i in invokers]

        assert sorted(run(go())) == [0, 0, 0, 0, 0, 0, 0, 4]

    def test_no_invokers_raises(self):
        async def go():
            bal = front(MemoryMessagingProvider())
            await bal.start()
            action = make_action()
            try:
                with pytest.raises(LoadBalancerException):
                    await bal.publish(action, make_msg(
                        action, E.Identity.generate("guest")))
            finally:
                await bal.close()

        run(go())

    def test_unhealthy_invoker_not_scheduled(self):
        async def go():
            provider = MemoryMessagingProvider()
            bal = front(provider)
            await bal.start()
            invokers, producer = await _fleet(provider, 4)
            await _ping_all(invokers, producer, bal)
            ident = E.Identity.generate("guest")
            action = make_action("affine2", memory=128)
            p = await bal.publish(action, make_msg(action, ident, True))
            await asyncio.wait_for(p, 5)
            home = max(range(4), key=lambda i: len(invokers[i].handled))
            # flap the home invoker to unhealthy via system-error outcomes
            for _ in range(5):
                bal.supervision.on_invocation_finished(
                    invokers[home].instance, is_system_error=True,
                    forced=False)
            status = bal.supervision.invokers[home].status
            await asyncio.sleep(0.05)
            p = await bal.publish(action, make_msg(action, ident, True))
            await asyncio.wait_for(p, 5)
            await _stop(bal, invokers)
            return home, status, [len(i.handled) for i in invokers]

        home, status, handled = run(go())
        assert status == UNHEALTHY
        assert handled[home] == 1  # the second invoke avoided it
        assert sum(handled) == 2

    def test_offline_after_ping_silence(self):
        async def go():
            provider = MemoryMessagingProvider()
            statuses = {}
            pool = InvokerPool(provider,
                               on_status_change=lambda i, s: statuses.update(
                                   {i.instance: s}),
                               ping_timeout=0.3)
            pool.start()
            producer = provider.get_producer()
            await producer.send("health", PingMessage(
                E.InvokerInstanceId(0, user_memory=E.MB(2048))))
            await asyncio.sleep(0.15)
            up = statuses.get(0)
            await asyncio.sleep(1.3)
            down = statuses.get(0)
            await pool.stop()
            return up, down

        assert run(go()) == (HEALTHY, OFFLINE)

    def test_forced_timeout_self_heals_slots(self):
        async def go():
            provider = MemoryMessagingProvider()
            bal = front(provider)
            bal.TIMEOUT_FACTOR = 0
            bal.TIMEOUT_ADDON = 0.2  # completion-ack timeout ~0.2 s
            bal.STD_TIMEOUT = 0.0
            await bal.start()
            # an invoker that never acks
            provider.ensure_topic("invoker0")
            await provider.get_producer().send("health", PingMessage(
                E.InvokerInstanceId(0, user_memory=E.MB(2048))))
            await asyncio.sleep(0.1)
            action = make_action()
            promise = await bal.publish(action, make_msg(
                action, E.Identity.generate("guest"), True))
            active = bal.total_active_activations
            with pytest.raises(ActiveAckTimeout):
                await asyncio.wait_for(promise, 5)
            await _drain(bal)
            out = (active, bal.total_active_activations,
                   int(bal.state.free_mb[0]), dict(bal._slots.refcount))
            await bal.close()
            return out

        active, healed, free, refs = run(go())
        assert active == 1 and healed == 0
        assert free == 2048 and refs == {}

    def test_batched_concurrent_publishes(self):
        async def go():
            provider = MemoryMessagingProvider()
            bal = front(provider, batch_window=0.005, max_batch=64)
            await bal.start()
            invokers, producer = await _fleet(provider, 8, memory_mb=4096)
            await _ping_all(invokers, producer, bal)
            ident = E.Identity.generate("guest")
            actions = [make_action(f"a{i}", memory=128) for i in range(16)]
            promises = await asyncio.gather(*[
                bal.publish(actions[i % 16],
                            make_msg(actions[i % 16], ident, True))
                for i in range(64)])
            results = await asyncio.gather(*[asyncio.wait_for(p, 10)
                                             for p in promises])
            steps = bal.counters["steps"]
            await _stop(bal, invokers)
            return results, steps

        results, steps = run(go())
        assert len(results) == 64
        assert all(r.response.is_success for r in results)
        assert steps < 64  # actually micro-batched

    def test_cluster_resharding(self):
        async def go():
            provider = MemoryMessagingProvider()
            bal = front(provider)
            await bal.start()
            invokers, producer = await _fleet(provider, 2, memory_mb=2048)
            await _ping_all(invokers, producer, bal)
            full = bal.state.free_mb[:2].tolist()
            bal.update_cluster(2)
            half = bal.state.free_mb[:2].tolist()
            caps = bal.occupancy()["fleet"]["capacity_mb"]
            await _stop(bal, invokers)
            return full, half, caps

        assert run(go()) == ([2048, 2048], [1024, 1024], 2048)

    def test_burst_beyond_max_batch_all_complete(self):
        """Leftover pending requests past max_batch flush without further
        traffic."""
        async def go():
            provider = MemoryMessagingProvider()
            bal = front(provider, batch_window=0.005, max_batch=16)
            await bal.start()
            invokers, producer = await _fleet(provider, 4, memory_mb=8192)
            await _ping_all(invokers, producer, bal)
            ident = E.Identity.generate("guest")
            actions = [make_action(f"b{i}", memory=128) for i in range(8)]
            promises = await asyncio.gather(*[
                bal.publish(actions[i % 8],
                            make_msg(actions[i % 8], ident, True))
                for i in range(40)])
            results = await asyncio.gather(*[asyncio.wait_for(p, 10)
                                             for p in promises])
            await _stop(bal, invokers)
            return results

        results = run(go())
        assert len(results) == 40
        assert all(r.response.is_success for r in results)

    def test_fleet_growth_preserves_inflight_books(self):
        """A new invoker registering mid-flight keeps the existing holds;
        growth re-pads the books past initial_pad on the device."""
        async def go():
            provider = MemoryMessagingProvider()
            bal = front(provider, initial_pad=2)
            await bal.start()
            invokers, producer = await _fleet(provider, 2, memory_mb=1024,
                                              delay=0.5)  # slow acks
            await _ping_all(invokers, producer, bal)
            ident = E.Identity.generate("guest")
            action = make_action("grow", memory=256)
            p = await bal.publish(action, make_msg(action, ident, True))
            held = int(bal.state.free_mb[:2].sum())
            inv3 = SimInvoker(provider, E.InvokerInstanceId(
                2, user_memory=E.MB(1024)))
            await inv3.start()
            await inv3.ping(producer)
            await _registered(bal, 3)
            pad = bal.state.free_mb.shape[0]
            after_grow = int(bal.state.free_mb[:2].sum())
            new_row = int(bal.state.free_mb[2])
            await asyncio.wait_for(p, 5)
            await _settled(bal)
            healed = int(bal.state.free_mb[:3].sum())
            await _stop(bal, invokers + [inv3])
            return held, pad, after_grow, new_row, healed

        held, pad, after_grow, new_row, healed = run(go())
        assert held == 2 * 1024 - 256        # hold visible
        assert pad == 4                      # re-padded past initial_pad
        assert after_grow == held            # growth preserved the hold
        assert new_row == 1024               # new invoker at full capacity
        assert healed == 3 * 1024            # release healed the books

    def test_close_fails_pending_publishers(self):
        async def go():
            provider = MemoryMessagingProvider()
            bal = front(provider, batch_window=5.0, pipeline_depth=1)
            await bal.start()
            invokers, producer = await _fleet(provider, 1)
            await _ping_all(invokers, producer, bal)
            action = make_action()
            # a saturated pipeline keeps the publish buffered
            bal._inflight_steps = bal.pipeline_depth
            task = asyncio.get_event_loop().create_task(bal.publish(
                action, make_msg(action, E.Identity.generate("guest"), True)))
            await asyncio.sleep(0.05)
            await bal.close()
            try:
                with pytest.raises(LoadBalancerException,
                                   match="shut down"):
                    await asyncio.wait_for(task, 2)
            finally:
                for inv in invokers:
                    await inv.stop()
            return dict(bal._slots.refcount)

        assert run(go()) == {}


# ----------------------------------------------------------------- (b)
async def _healthy_balancer(provider, n_invokers=4, mem=4096, **kw):
    """A balancer with `n_invokers` registered-and-healthy rows (pings
    only: nothing acks, so placements hold until released)."""
    bal = front(provider, **kw)
    await bal.start()
    producer = provider.get_producer()
    for i in range(n_invokers):
        await producer.send("health", PingMessage(
            E.InvokerInstanceId(i, user_memory=E.MB(mem))))
    for _ in range(100):
        await asyncio.sleep(0.01)
        if sum(h.status == HEALTHY
               for h in await bal.invoker_health()) == n_invokers:
            return bal
    raise RuntimeError("fleet never became healthy")


async def _drain(bal, timeout=5.0):
    """Until no step is in flight and nothing is queued or folding."""
    t0 = time.monotonic()
    while (bal._inflight_steps or bal._pending or bal._releases
           or bal._readbacks or not (bal._flush_task is None
                                     or bal._flush_task.done())):
        if time.monotonic() - t0 > timeout:
            raise RuntimeError("balancer did not drain")
        await asyncio.sleep(0.005)


class TestPublishMany:
    def test_exception_texts_match_serial(self):
        """no-invoker refusals through publish_many carry the serial
        path's exact text, per row: an empty fleet, and a fleet whose
        every invoker is unhealthy."""
        async def go():
            ident = E.Identity.generate("guest")
            action = make_action("t")
            texts = []
            for n_up in (0, 2):
                provider = MemoryMessagingProvider()
                bal = (front(provider) if n_up == 0
                       else await _healthy_balancer(provider, n_up))
                for i in range(n_up):
                    for _ in range(4):
                        bal.supervision.on_invocation_finished(
                            E.InvokerInstanceId(i), True, False)
                try:
                    with pytest.raises(LoadBalancerException) as s:
                        await bal.publish(action, make_msg(action, ident))
                    outs = bal.publish_many(
                        [(action, make_msg(action, ident))] * 2)
                    for out in outs:
                        with pytest.raises(LoadBalancerException) as b:
                            await out
                        texts.append((str(s.value), str(b.value)))
                finally:
                    await bal.close()
            return texts

        texts = run(go())
        assert len(texts) == 4
        assert all(a == b == "No invokers available to schedule the "
                   "activation." for a, b in texts)

    def test_device_throttle_429_text(self):
        async def go():
            ident = E.Identity.generate("guest")
            action = make_action("thr", memory=128)
            bal = await _healthy_balancer(MemoryMessagingProvider(),
                                          rate_limit_per_minute=2)
            try:
                outs = bal.publish_many([(action, make_msg(action, ident))
                                         for _ in range(16)])
                results = await asyncio.gather(*outs,
                                               return_exceptions=True)
                await _drain(bal)
                return (results, bal.counters["device_throttled"],
                        bal._slots.refcount.get(
                            f"{action.fully_qualified_name}:128"),
                        int(bal.state.free_mb[:4].sum()))
            finally:
                await bal.close()

        results, count, refs, free = run(go())
        throttled = [r for r in results
                     if isinstance(r, LoadBalancerThrottleException)]
        assert len(throttled) == count == 14
        assert str(throttled[0]) == ("Too many requests in the last minute "
                                     "(device rate admission).")
        assert refs == 2  # only the two admitted rows hold a slot
        assert free == 4 * 4096 - 2 * 128

    def test_cancellation_returns_capacity_per_row(self):
        async def go():
            ident = E.Identity.generate("guest")
            action = make_action("c", memory=256)
            bal = await _healthy_balancer(MemoryMessagingProvider(),
                                          n_invokers=2)
            try:
                free0 = int(bal.state.free_mb.sum())
                outs = bal.publish_many([(action, make_msg(action, ident))
                                         for _ in range(8)])
                for out in outs[:4]:
                    out.cancel()
                results = await asyncio.gather(*outs,
                                               return_exceptions=True)
                await _drain(bal)
                return (results, free0 - int(bal.state.free_mb.sum()),
                        bal._slots.refcount.get(
                            f"{action.fully_qualified_name}:256"))
            finally:
                await bal.close()

        results, held, refs = run(go())
        assert sum(isinstance(r, asyncio.CancelledError)
                   for r in results) == 4
        assert held == 4 * 256  # only the 4 surviving placements hold
        assert refs == 4

    def test_full_batch_flushes_inline(self):
        """A publish_many of max_batch rows dispatches inside the call (no
        event-loop turn): the queue is empty and a step is in flight when
        it returns; a second full batch pipelines behind it."""
        async def go():
            ident = E.Identity.generate("guest")
            action = make_action("f", memory=128)
            bal = await _healthy_balancer(MemoryMessagingProvider(),
                                          max_batch=8)
            try:
                seen = []
                for _ in range(2):
                    outs = bal.publish_many(
                        [(action, make_msg(action, ident))
                         for _ in range(8)])
                    seen.append((len(bal._pending), bal._inflight_steps,
                                 bal._flush_task is None))
                    await asyncio.gather(*outs)
                return seen, bal.counters["steps"]
            finally:
                await bal.close()

        seen, steps = run(go())
        assert seen == [(0, 1, True), (0, 1, True)]
        assert steps == 2

    def test_flush_policy_arithmetic_matches_jax(self):
        """The arrival EWMA, its one-clock batch form and the adaptive
        window decision equal the JAX balancer's on the same history
        (`_note_arrivals(now, 1)` is `_note_arrival(now)`, n > 1 a closed
        form decay)."""
        from openwhisk_tpu.controller.loadbalancer.tpu_balancer import \
            TpuBalancer as JaxBalancer
        from openwhisk_tpu.messaging import memory as jax_memory
        ref = JaxBalancer(jax_memory.MemoryMessagingProvider(),
                          E.ControllerInstanceId("0"), kernel="xla",
                          prewarm=False, calibrate_kernel="off")
        port = front(MemoryMessagingProvider())
        rng = np.random.RandomState(2)
        t = 100.0
        for bal in (ref, port):
            bal._gap_ewma_ms, bal._last_pub_t, bal._last_gap_ms = \
                123.456, t, 9.0
        seen = []
        for _ in range(60):
            t += float(rng.choice([0.0, 0.0005, 0.002, 0.03, 1.5]))
            n = int(rng.choice([1, 1, 2, 16, 256]))
            for bal in (ref, port):
                bal._note_arrivals(t, n)
            got = [(b._gap_ewma_ms, b._last_pub_t, b._last_gap_ms,
                    b._coalesce_window_s()) for b in (ref, port)]
            assert got[0] == got[1]
            seen.append(got[1][3])
        assert 0.0 in seen and any(w > 0 for w in seen)
        for bal in (ref, port):
            bal._gap_ewma_ms, bal._last_pub_t, bal._last_gap_ms = \
                50.0, 10.0, 9.0
            bal._note_arrival(10.5)
        assert ((ref._gap_ewma_ms, ref._last_gap_ms)
                == (port._gap_ewma_ms, port._last_gap_ms))

    def test_provider_builds_the_balancer(self):
        bal = TpuBalancerProvider.instance(
            messaging_provider=MemoryMessagingProvider(),
            controller_instance=CTRL, device="cpu", max_batch=32)
        assert isinstance(bal, TpuBalancer) and bal.max_batch == 32
        assert bal.state.free_mb.shape == (64,)  # initial_pad
        assert bal.placement_kernel_resolved == "repair"

    def test_off_switch_serial_path(self):
        async def go():
            ident = E.Identity.generate("guest")
            action = make_action("o")
            bal = await _healthy_balancer(MemoryMessagingProvider(),
                                          batch_publish=False)
            try:
                outs = bal.publish_many([(action, make_msg(action, ident))
                                         for _ in range(4)])
                await asyncio.gather(*outs)
                return bal.total_active_activations, bal._publish_finishers
            finally:
                await bal.close()

        active, finishers = run(go())
        assert active == 4 and not finishers


class TestAcks:
    @staticmethod
    async def _placed(bal, n):
        ident = E.Identity.generate("guest")
        action = make_action("ack", memory=256)
        msgs = [make_msg(action, ident, True) for _ in range(n)]
        outs = bal.publish_many([(action, m) for m in msgs])
        promises = await asyncio.gather(*outs)
        return msgs, promises

    @staticmethod
    def _acks(bal, msgs, errors=()):
        out = []
        for k, m in enumerate(msgs):
            inv = bal.activation_slots[m.activation_id.asString].invoker
            now = time.time()
            act = E.WhiskActivation(
                E.EntityPath("guest"), E.EntityName("ack"), E.Subject("subject"),
                m.activation_id, now, now,
                E.ActivationResponse.whisk_error("x") if k in errors
                else E.ActivationResponse.success({"k": k}), duration=1)
            out.append(CombinedCompletionAndResultMessage(m.transid, act, inv))
        return out

    def test_batched_acks_match_the_serial_path(self):
        """process_acknowledgements over N acks leaves the same entries,
        results, counters, supervision outcomes and books as N serial
        process_acknowledgement calls."""
        async def go():
            runs = []
            for batched in (False, True):
                bal = await _healthy_balancer(MemoryMessagingProvider(),
                                              n_invokers=2, mem=1024)
                try:
                    msgs, promises = await self._placed(bal, 6)
                    acks = self._acks(bal, msgs[:5], errors=(1, 3))
                    late = CompletionMessage(TransactionId(),
                                             E.ActivationId.generate(),
                                             False, acks[0].invoker)
                    acks.append(late)  # untracked: a late ack
                    if batched:
                        bal.process_acknowledgements(acks)
                    else:
                        for a in acks:
                            bal.process_acknowledgement(a.serialize())
                    await _drain(bal)
                    runs.append((
                        [p.result().response.status_code if p.done()
                         else None for p in promises],
                        len(bal.activation_slots),
                        {k: v for k, v in bal.counters.items()
                         if k.startswith("completion")},
                        {i: st.buffer.to_list() for i, st in
                         bal.supervision.invokers.items()},
                        bal.state.free_mb[:2].tolist()))
                finally:
                    await bal.close()
            return runs

        serial, batched = run(go())
        assert serial == batched
        results, left, counts, _, free = serial
        assert results[:5] == [0, 3, 0, 3, 0] and results[5] is None
        assert left == 1
        assert counts == {"completion_ack_regular": 5,
                          "completion_ack_regularAfterForced": 1}
        assert sum(free) == 2 * 1024 - 256

    def test_four_way_disambiguation(self):
        """A regular ack, a forced timeout, the late ack after it, a
        healthcheck ack, and a second forced completion of a released
        activation each land in their own counter."""
        async def go():
            bal = await _healthy_balancer(MemoryMessagingProvider(),
                                          n_invokers=2)
            try:
                msgs, promises = await self._placed(bal, 2)
                regular, timed_out = msgs
                bal.process_acknowledgement(
                    self._acks(bal, [regular])[0].serialize())
                entry = bal.activation_slots[
                    timed_out.activation_id.asString]
                bal._timeout_fire(entry)  # the forced-timeout timer
                with pytest.raises(ActiveAckTimeout):
                    await promises[1]
                late = CompletionMessage(timed_out.transid,
                                         timed_out.activation_id, False,
                                         entry.invoker)
                bal.process_acknowledgement(late.serialize())
                probe = E.ActivationId.generate()
                bal._health_probe_ids.add(probe.asString)
                bal.process_acknowledgement(CompletionMessage(
                    TransactionId(), probe, False,
                    entry.invoker).serialize())
                bal.process_completion(regular.activation_id, forced=True,
                                       is_system_error=False, invoker=None)
                bal.process_acknowledgement(b"{not json")
                await _drain(bal)
                return (dict(bal.counters), bal.total_active_activations,
                        bal.state.free_mb[:2].tolist())
            finally:
                await bal.close()

        counts, active, free = run(go())
        assert {k: v for k, v in counts.items()
                if k.startswith("completion")} == {
            "completion_ack_regular": 1, "completion_ack_forced": 1,
            "completion_ack_regularAfterForced": 1,
            "completion_ack_healthcheck": 1,
            "completion_ack_forcedAfterRegular": 1}
        assert active == 0 and free == [4096, 4096]


class TestFailurePaths:
    def test_no_card_means_raise(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TpuBalancer(MemoryMessagingProvider(), CTRL)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TpuBalancerProvider.instance(
                messaging_provider=MemoryMessagingProvider(),
                controller_instance=CTRL)

    def test_failed_step_rebuilds_the_books(self):
        """A step that half-writes the books and then raises: its
        publishers fail with the dispatch text, their slots come back, the
        books are rebuilt at full capacity, and the next publish places."""
        async def go():
            ident = E.Identity.generate("guest")
            action = make_action("x", memory=256)
            bal = await _healthy_balancer(MemoryMessagingProvider(),
                                          n_invokers=2, mem=1024)
            try:
                outs = bal.publish_many([(action, make_msg(action, ident))
                                         for _ in range(2)])
                await asyncio.gather(*outs)
                real = bal._packed_fn

                def broken(state, *args):
                    state.free_mb.sub_(100)  # half-written, then a fault
                    raise RuntimeError("kernel launch failed")

                bal._packed_fn = broken
                outs = bal.publish_many([(action, make_msg(action, ident))
                                         for _ in range(3)])
                errs = await asyncio.gather(*outs, return_exceptions=True)
                after = (bal.state.free_mb[:2].tolist(),
                         int(bal.state.conc_free.abs().sum()),
                         bal._slots.refcount.get(
                             f"{action.fully_qualified_name}:256"),
                         bal._inflight_steps)
                bal._packed_fn = real
                await bal.publish_many([(action, make_msg(action, ident))])[0]
                return errs, after, bal.total_active_activations
            finally:
                await bal.close()

        errs, (free, conc, refs, inflight), active = run(go())
        assert all(isinstance(e, LoadBalancerException)
                   and "device dispatch failed: kernel launch failed"
                   in str(e) for e in errs)
        assert free == [1024, 1024] and conc == 0  # full capacity
        assert refs == 2 and inflight == 0  # the first two still hold
        assert active == 3

    def test_failed_readback_is_compensated_on_device(self):
        async def go():
            ident = E.Identity.generate("guest")
            action = make_action("y", memory=256)
            bal = await _healthy_balancer(MemoryMessagingProvider(),
                                          n_invokers=2, mem=1024)
            try:
                def broken(rb):
                    raise RuntimeError("transfer failed")

                bal._read_back = broken
                outs = bal.publish_many([(action, make_msg(action, ident))
                                         for _ in range(3)])
                errs = await asyncio.gather(*outs, return_exceptions=True)
                return errs, bal.state.free_mb[:2].tolist(), \
                    dict(bal._slots.refcount), bal._inflight_steps
            finally:
                await bal.close()

        errs, free, refs, inflight = run(go())
        assert all("device step failed: transfer failed" in str(e)
                   for e in errs)
        assert free == [1024, 1024] and refs == {} and inflight == 0

    def test_failed_idle_fold_rebuilds_the_books(self):
        async def go():
            ident = E.Identity.generate("guest")
            action = make_action("z", memory=256)
            bal = await _healthy_balancer(MemoryMessagingProvider(),
                                          n_invokers=2, mem=1024)
            try:
                promise = await bal.publish(action, make_msg(action, ident))
                entry = next(iter(bal.activation_slots.values()))

                def broken(state, rel):
                    state.conc_free.add_(7)
                    raise RuntimeError("fold failed")

                bal._release_packed_fn = broken
                bal.process_completion(entry.id, forced=False,
                                       is_system_error=False,
                                       invoker=entry.invoker)
                await _drain(bal)
                return (promise.done(), bal.state.free_mb[:2].tolist(),
                        int(bal.state.conc_free.abs().sum()),
                        bal.total_active_activations)
            finally:
                await bal.close()

        done, free, conc, active = run(go())
        assert free == [1024, 1024] and conc == 0 and active == 0
        assert not done  # a completion without a result leaves the promise

    def test_slot_axis_grows_then_overflows(self):
        """Distinct actions past action_slots grow the books' slot axis on
        the device (live permits kept) up to max_action_slots, then share
        hashed slots, counted."""
        async def go():
            ident = E.Identity.generate("guest")
            acts = [make_action(f"s{i}", memory=128) for i in range(6)]
            bal = await _healthy_balancer(MemoryMessagingProvider(),
                                          n_invokers=2, action_slots=2,
                                          max_action_slots=4)
            try:
                shapes = []
                for a in acts:
                    await bal.publish_many([(a, make_msg(a, ident))])[0]
                    shapes.append(tuple(bal.state.conc_free.shape))
                return (shapes, bal.counters["action_slot_growth"],
                        bal.counters["action_slot_overflow"],
                        bal.total_active_activations,
                        int(bal.state.free_mb[:2].sum()))
            finally:
                await bal.close()

        shapes, grown, overflowed, active, free = run(go())
        assert shapes == [(64, 2), (64, 2), (64, 4), (64, 4), (64, 4),
                          (64, 4)]
        assert grown == 1 and overflowed == 2
        assert active == 6 and free == 2 * 4096 - 6 * 128

    def test_occupancy_serves_the_cached_books(self):
        async def go():
            ident = E.Identity.generate("guest")
            action = make_action("occ", memory=512)
            bal = await _healthy_balancer(MemoryMessagingProvider(),
                                          n_invokers=2, mem=1024)
            try:
                await bal.publish_many([(action, make_msg(action, ident))])[0]
                await _drain(bal)
                return bal.occupancy(), bal.rtt_policy
            finally:
                await bal.close()

        occ, policy = run(go())
        assert occ["kernel"] == "repair"
        assert occ["fleet"] == {"capacity_mb": 2048, "used_mb": 512,
                                "occupancy": 0.25}
        assert [i["invoker"] for i in occ["invokers"]] == ["invoker0",
                                                           "invoker1"]
        assert policy in ("eager", "window")


# ------------------------------------------------------------ (c), (d)
#: the parity scenario's shape: a fleet of N0 invokers (1024 MB) that
#: grows to N_GROW past INITIAL_PAD; WAVES publish_many waves of MAX_BATCH
#: rows over 12 actions (one in five blackbox, some max_conc > 1) in NS
#: namespaces; a 6-row serial trickle; acks for 60% of the outstanding
#: activations after every wave
N0, N_GROW, INITIAL_PAD, MAX_BATCH, SLOTS = 6, 12, 8, 16, 8
WAVES, TRICKLE, NS = 8, 6, 16
#: device rate admission: 4 tokens a namespace, refilling one token in 15 s
#: — longer than a run, so the refill never crosses a whole token and the
#: admissions do not depend on the wall clock of either run
RATE = 4


def _jax_package():
    from openwhisk_tpu.controller.loadbalancer.tpu_balancer import \
        TpuBalancer as JaxBalancer
    from openwhisk_tpu.core import entity as JE
    from openwhisk_tpu.messaging import memory as JMem
    from openwhisk_tpu.messaging import message as JMsg
    from openwhisk_tpu.utils import transaction as JTx

    def make(provider, **kw):
        return JaxBalancer(provider, JE.ControllerInstanceId("0"),
                           kernel="xla", prewarm=False,
                           calibrate_kernel="off", **kw)
    return types.SimpleNamespace(E=JE, Mem=JMem, Msg=JMsg, Tx=JTx, make=make)


def _port_package():
    from openwhisk_tpu_torch.messaging import memory as TMem
    from openwhisk_tpu_torch.messaging import message as TMsg
    from openwhisk_tpu_torch.utils import transaction as TTx

    def make(provider, **kw):
        return TpuBalancer(provider, CTRL, device="cpu", **kw)
    return types.SimpleNamespace(E=E, Mem=TMem, Msg=TMsg, Tx=TTx, make=make)


def _identity_json(k):
    u = f"{k:08x}-71f6-4ed5-8c54-816aa4f8c502"
    return {"subject": f"subject{k}", "namespace": {"name": f"ns{k}",
                                                    "uuid": u},
            "authkey": {"api_key": u + ":" + "k" * 64},
            "rights": ["ACTIVATE"], "limits": {}}


def _host_books(x):
    """A host copy of a books array: a JAX array, or a torch tensor on
    either device."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    return np.asarray(x).copy()


async def _scenario(pkg, rate, grow, seed, ack_producer=None, setup=None,
                    inspect=None):
    """One seeded run through one package's TpuBalancer; returns the
    decision of every activation, the books, the run's counts and the
    flight recorder's records. `ack_producer(provider)`, when given, makes
    the producer the acks go out on, one `send_batch` a round (a
    coalescing producer ships each round as one frame). `setup(bal)` runs
    right after the balancer is built; `inspect(bal)` runs once every
    activation is acked, before the balancer closes, and its result is
    the run's `inspect`."""
    ent, msgs = pkg.E, pkg.Msg
    provider = pkg.Mem.MemoryMessagingProvider()
    bal = pkg.make(provider, managed_fraction=0.75, blackbox_fraction=0.25,
                   max_batch=MAX_BATCH, action_slots=SLOTS,
                   initial_pad=INITIAL_PAD, placement_kernel="auto",
                   rate_limit_per_minute=rate)
    bal.supervision.ping_timeout = 3600.0  # no offline flips mid-run
    decisions = {}
    real_map = bal._map_placement

    def record(inv_idx, forced, *rest):  # rest ends (..., msg, action)
        decisions[rest[-2].activation_id.asString] = (int(inv_idx),
                                                      bool(forced))
        return real_map(inv_idx, forced, *rest)

    bal._map_placement = record
    if setup is not None:
        setup(bal)
    await bal.start()
    producer = provider.get_producer()
    ack_topic = f"completed{ent.ControllerInstanceId('0').as_string}"

    async def register(ids):
        for i in ids:
            await producer.send("health", msgs.PingMessage(
                ent.InvokerInstanceId(i, user_memory=ent.MB(1024))))
        for _ in range(400):
            if (len(bal._registry) >= ids[-1] + 1
                    and all(bal._healthy[i] for i in ids)):
                return
            await asyncio.sleep(0.005)
        raise RuntimeError("registration did not land")

    async def drain():
        for _ in range(2000):
            ft = bal._flush_task
            if not (bal._inflight_steps or bal._pending or bal._releases
                    or bal._readbacks or (ft is not None and not ft.done())):
                return
            await asyncio.sleep(0.002)
        raise RuntimeError("balancer did not drain")

    acker = None if ack_producer is None else ack_producer(provider)

    async def ack(items):
        acks = [msgs.CompletionMessage(msg.transid, msg.activation_id, False,
                                       inv) for msg, inv in items]
        if acker is not None:
            if acks:
                await acker.send_batch(ack_topic, acks)
        else:
            for a in acks:
                await producer.send(ack_topic, a)
        for _ in range(2000):
            if not any(m.activation_id.asString in bal.activation_slots
                       for m, _ in items):
                break
            await asyncio.sleep(0.002)
        else:
            raise RuntimeError("acks were not processed")
        await drain()

    await register(list(range(N0)))
    rng = np.random.RandomState(seed)
    actions = []
    for i in range(12):
        exe = (ent.BlackBoxExec(image="img") if i % 5 == 4
               else ent.CodeExec(kind="python:3", code="x"))
        a = ent.ExecutableWhiskAction(
            ent.EntityPath(f"ns{i % 3}"), ent.EntityName(f"act{i}"), exe,
            limits=ent.ActionLimits(
                ent.TimeLimit(5000),
                ent.MemoryLimit(ent.MB(int(rng.choice([128, 256, 512])))),
                concurrency=ent.ConcurrencyLimit(int(rng.choice([1, 1, 4])))))
        a.rev = ent.DocRevision("1-b")
        actions.append(a)
    idents = [ent.Identity.from_json(_identity_json(k)) for k in range(NS)]
    outstanding, counter, throttled = [], [0], [0]

    def next_pair():
        a = actions[rng.randint(len(actions))]
        k = counter[0] = counter[0] + 1
        return a, msgs.ActivationMessage(
            pkg.Tx.TransactionId(f"t{k}", start_wallclock=1.0),
            a.fully_qualified_name, "1-b", idents[rng.randint(NS)],
            ent.ActivationId(f"{k:032x}"), ent.ControllerInstanceId("0"),
            False, {})

    def settle(pairs, results):
        for (_, msg), res in zip(pairs, results):
            if isinstance(res, Exception):
                assert "device rate admission" in str(res), res
                throttled[0] += 1
            else:
                entry = bal.activation_slots[msg.activation_id.asString]
                outstanding.append((msg, entry.invoker))

    async def ack_some(frac):
        rng.shuffle(outstanding)
        k = int(len(outstanding) * frac)
        done, outstanding[:] = outstanding[:k], outstanding[k:]
        await ack(done)

    inline = []
    for wave in range(WAVES):
        if grow and wave == WAVES // 2:
            await register(list(range(N0, N_GROW)))
        if wave == 3:  # invoker 1 goes unhealthy through the FSM
            for _ in range(4):
                bal.supervision.on_invocation_finished(
                    ent.InvokerInstanceId(1, user_memory=ent.MB(1024)),
                    True, False)
        pairs = [next_pair() for _ in range(MAX_BATCH)]
        outs = bal.publish_many(pairs)
        inline.append(not bal._pending and bal._inflight_steps == 1)
        settle(pairs, await asyncio.gather(*outs, return_exceptions=True))
        await drain()
        await ack_some(0.6)
    for _ in range(TRICKLE):
        a, msg = next_pair()
        try:
            await bal.publish(a, msg)
            res = None
        except Exception as e:  # noqa: BLE001 — a throttled trickle row
            res = e
        settle([(a, msg)], [res])
        await drain()
        await ack_some(0.5)
    await ack_some(1.0)
    out = dict(
        decisions=decisions, inline=inline, throttled=throttled[0],
        active=bal.total_active_activations,
        n=len(bal._registry), pad=int(bal.state.free_mb.shape[0]),
        slots=int(bal.state.conc_free.shape[1]),
        free=_host_books(bal.state.free_mb),
        conc=_host_books(bal.state.conc_free),
        health=_host_books(bal.state.health),
        records=bal.flight_recorder.recent(1024, with_decisions=True),
        explain={a: (bal.flight_recorder.explain(a) or {}).get("decision")
                 for a in decisions},
        inspect=None if inspect is None else inspect(bal))
    await bal.close()
    if acker is not None:
        await acker.close()
    return out


@pytest.mark.parametrize("rate", [None, RATE], ids=["no_rate", "rate"])
@pytest.mark.parametrize("grow", [False, True], ids=["fixed", "grow"])
def test_placement_parity_with_jax_balancer(rate, grow, monkeypatch):
    seed = 31 + (rate or 0) + 7 * grow
    jax_pkg, port_pkg = _jax_package(), _port_package()
    for pkg in (jax_pkg, port_pkg):  # deployments opt in to max_conc > 1
        monkeypatch.setattr(pkg.E.ConcurrencyLimit, "MAX", 16)
    port = run(_scenario(port_pkg, rate, grow, seed), 90)
    ref = run(_scenario(jax_pkg, rate, grow, seed), 90)
    assert port["decisions"] == ref["decisions"]
    for k in ("throttled", "n", "pad", "slots", "active"):
        assert port[k] == ref[k], k
    for k in ("free", "conc", "health"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    # the waves flushed inline, so the batch boundaries are pinned
    assert all(port["inline"]) and all(ref["inline"])
    # the run exercised what it claims
    placed = [d for d in port["decisions"].values() if d[0] >= 0]
    assert any(f for _, f in placed) and any(not f for _, f in placed)
    assert port["slots"] > SLOTS  # the slot axis grew
    assert (port["throttled"] > 0) == (rate is not None)
    assert port["pad"] == (16 if grow else INITIAL_PAD)
    # (d): every activation acked -> nothing active, full capacity
    assert port["active"] == 0
    n = port["n"]
    np.testing.assert_array_equal(port["free"][:n], np.full(n, 1024))
    assert not port["conc"].any()
